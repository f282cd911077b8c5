// The emulator's stand-in for pangenie_tpu_torch/csrc/grid.cuh: an
// arrival adds one to the counter (thread 0 of the block, after the
// block barrier the caller has passed); a wait yields thread 0 until the
// counter has reached the target, then the block barrier. A counter in
// shared memory aborts; a wait that no other block can end deadlocks the
// scheduler, which aborts. Loads and stores across blocks are plain.
#pragma once

#include <cuda_runtime.h>

void emu_grid_arrive(unsigned* counter);
void emu_grid_wait(const unsigned* counter, unsigned target);

inline void grid_arrive(unsigned* counter) {
    if (threadIdx.x == 0) emu_grid_arrive(counter);
}

inline void grid_wait(const unsigned* counter, unsigned target) {
    if (threadIdx.x == 0) emu_grid_wait(counter, target);
    __syncthreads();
}

inline void grid_store(float* p, float v) { *p = v; }
inline float grid_load(const float* p) { return *p; }
