// Grid-wide arrival primitives (sm_70 and later) as the grid tier of
// kernels K3/K4 in fb.cu uses them: the CTAs of one chain, all resident at
// once (a cooperative launch), hand each other the column sums through
// global memory. A CTA's writes are published by a block barrier and
// one thread's arrival on a per-chain counter with release semantics; a
// CTA waits until the counter reaches a target by one thread spinning on
// an acquire load, then a block barrier. Counters only grow during a
// launch (they are zeroed before it). Data handed across CTAs moves in
// loads and stores that bypass L1 (.cg), which is not coherent across
// SMs. tests/cuda_emulator/ has a stand-in of the same name.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// After a block barrier: thread 0 adds one to the counter with release
// semantics at gpu scope (what every thread of the block wrote before
// the barrier is seen by a CTA that acquires the counter's new value).
__device__ __forceinline__ void grid_arrive(unsigned* counter) {
    if (threadIdx.x == 0)
        asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(counter) : "memory");
}

// Every thread of the block: returns once the counter has reached
// `target` (thread 0 spins on an acquire load, then a block barrier).
__device__ __forceinline__ void grid_wait(const unsigned* counter, unsigned target) {
    if (threadIdx.x == 0) {
        unsigned seen;
        do {
            asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(counter)
                         : "memory");
        } while ((int)(seen - target) < 0);
    }
    __syncthreads();
}

// A float handed to or from another CTA, through L2.
__device__ __forceinline__ void grid_store(float* p, float v) { __stcg(p, v); }
__device__ __forceinline__ float grid_load(const float* p) { return __ldcg(p); }
