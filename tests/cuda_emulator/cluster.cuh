// The emulator's stand-in for pangenie_tpu_torch/csrc/cluster.cuh: the
// block's rank is its index in its cluster; the cluster barrier waits for
// every fiber of the cluster's blocks (arriving twice, or waiting without
// arriving, aborts); an mbarrier is a phase, a pending arrival and a
// count of bytes, kept beside the block's shared memory; a push writes
// another block's array and completes its bytes on that block's
// mbarrier, and a wait yields until the phase of its parity has
// completed. An address outside the launch's shared memory, a rank
// outside the cluster, a misaligned uint4, an mbarrier used before it is
// set up or a byte count out of the hardware's range aborts.
#pragma once

#include <cuda_runtime.h>

unsigned emu_cluster_rank();
void emu_cluster_arrive();
void emu_cluster_wait();
void emu_mbar_init(const void* bar);
void emu_mbar_expect(const void* bar, unsigned bytes);
void emu_cluster_push(void* p, unsigned rank, const void* v, unsigned bytes, const void* bar);
void emu_mbar_wait(const void* bar, unsigned parity);

inline unsigned cluster_rank() { return emu_cluster_rank(); }
inline void cluster_arrive() { emu_cluster_arrive(); }
inline void cluster_wait() { emu_cluster_wait(); }
inline void mbar_init(uint64_t* bar) { emu_mbar_init(bar); }
inline void mbar_expect(uint64_t* bar, unsigned bytes) { emu_mbar_expect(bar, bytes); }
inline void cluster_push4(uint4* p, unsigned rank, uint4 v, uint64_t* bar) {
    emu_cluster_push(p, rank, &v, sizeof(v), bar);
}
inline void mbar_wait(uint64_t* bar, unsigned parity) { emu_mbar_wait(bar, parity); }
