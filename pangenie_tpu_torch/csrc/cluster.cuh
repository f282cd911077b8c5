// Thread-block cluster primitives (sm_90) as kernel S1's cluster sweep in
// sampling_dp.cu uses them: the block's rank in its cluster, the split
// cluster barrier (arrive with release semantics, wait with acquire), and
// the push of 16 bytes into another block's shared memory (st.async),
// which completes that many bytes on an mbarrier of that block; the
// receiver arms its mbarrier with the bytes it expects and waits on it
// alone. tests/cuda_emulator/ has a stand-in of the same name.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ unsigned cluster_rank() {
    unsigned r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    return r;
}

// Every thread of every block of the cluster arrives, then waits; what a
// thread wrote before its arrive is seen by every thread after its wait.
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ unsigned shared_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

// The address of `p` (in this block's shared memory) in the block of rank
// `rank`, in the cluster's shared window: a pure function of its inputs.
__device__ __forceinline__ unsigned cluster_addr(const void* p, unsigned rank) {
    unsigned at;
    asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(at) : "r"(shared_addr(p)), "r"(rank));
    return at;
}

// One thread sets up an mbarrier of one arrival a phase; the other blocks
// of the cluster may use it after a cluster barrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(shared_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The one arrival of the mbarrier's current phase, which then completes
// once `bytes` more have come in (before or after this arrival).
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                     shared_addr(bar)),
                 "r"(bytes)
                 : "memory");
}

// v into `p` of the block of rank `rank` (p and bar name this block's
// shared memory; the same offsets are used there), completing 16 bytes on
// that block's mbarrier `bar`.
__device__ __forceinline__ void cluster_push4(uint4* p, unsigned rank, uint4 v, uint64_t* bar) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.u32 [%0], {%1, %2, %3, %4}, "
        "[%5];" ::"r"(cluster_addr(p, rank)),
        "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(cluster_addr(bar, rank))
        : "memory");
}

// Waits until the mbarrier's phase of parity `parity` has completed; what
// was pushed in that phase is then seen by the waiting thread.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    asm volatile(
        "{\n\t.reg .pred done;\n\t"
        "WAIT:\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n\t"
        "@!done bra WAIT;\n\t}" ::"r"(shared_addr(bar)),
        "r"(parity)
        : "memory");
}
