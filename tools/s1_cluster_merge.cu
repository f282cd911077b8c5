// The merge chain of kernel S1's cluster sweep alone, to split the
// sweep's time a column into its CTA part and its merge
// (tools/s1_cluster_merge.py builds and times it).
//
// One cluster of K CTAs of W warps runs N columns. In every column each
// lane draws a score that depends on the previous column's merged result
// (so the columns form one chain, as the sweep's do), every warp reduces
// its (m1, f1, g) with three redux.sync, as warp_col does, and then:
// - mode 0: nothing more (the warp's own reduction: the floor);
// - mode 1: the CTA's merge of one-CTA S1 (block_merge: partials in
//   shared memory, __syncthreads, each warp merging them in its lanes);
// - mode 2: the cluster barrier merge, cluster_col's first design and
//   its alternative (partials in the CTA's own shared memory, one
//   barrier.cluster arrive/wait, every warp reading the K x W partials
//   through distributed shared memory);
// - mode 3: the push merge of csrc/sampling_dp.cu:cluster_col, with its
//   primitives (csrc/cluster.cuh): lanes 0..K-1 of every warp store the
//   warp's partial into rank l's shared memory with st.async, which
//   completes bytes on rank l's mbarrier; every CTA waits on its own
//   mbarrier only, then reads the K x W partials from its own shared
//   memory.
// Modes 1-3 end every column with the same (m1, f1, g), so for one K
// and W they leave the same value in out[].
#include <cuda_runtime.h>
#include <stdint.h>

#include "../pangenie_tpu_torch/csrc/cluster.cuh"

#define FULL_MASK 0xFFFFFFFFu
#define NONE 0xFFFFFFFFu

struct Col {
    unsigned m1, f1, g;
};

__device__ __forceinline__ Col lane_merge(unsigned m, unsigned i1, unsigned i2) {
    const unsigned m1 = __reduce_min_sync(FULL_MASK, m);
    if (m != m1) i1 = i2 = NONE;
    const unsigned f1 = __reduce_min_sync(FULL_MASK, i1);
    const unsigned g = __reduce_min_sync(FULL_MASK, i1 == f1 ? i2 : i1);
    return {m1, f1, g};
}

__device__ __forceinline__ void merge_part(unsigned& m, unsigned& i1, unsigned& i2, uint4 v) {
    if (v.x < m) {
        m = v.x;
        i1 = v.y;
        i2 = v.z;
    } else if (v.x == m) {
        i2 = min(min(i2, v.z), max(i1, v.y));
        i1 = min(i1, v.y);
    }
}

// 16 bytes at `p` of the block of rank `rank` (distributed shared memory)
__device__ __forceinline__ uint4 cluster_load4(const uint4* p, unsigned rank) {
    uint4 v;
    asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(cluster_addr(p, rank))
                 : "memory");
    return v;
}

extern __shared__ __align__(16) uint4 parts[];

template <int MODE>
__global__ void __launch_bounds__(1024) merge_chain(int N, int K, unsigned* out) {
    __shared__ __align__(8) uint64_t bar[2];
    const unsigned rank = MODE >= 2 ? cluster_rank() : 0;
    const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5, W = blockDim.x >> 5;
    const unsigned path = (rank * W + warp) * 32 + lane, total = K * W;
    if (MODE == 3 && threadIdx.x == 0) {
        mbar_init(bar);
        mbar_init(bar + 1);
    }
    if (MODE >= 2) {
        cluster_arrive();
        cluster_wait();
    }
    unsigned prev = 0;
    for (int n = 0; n < N; ++n) {
        const unsigned x = (path * 2654435761u + (unsigned)n * 40503u + prev) >> 22;
        const unsigned m1 = __reduce_min_sync(FULL_MASK, x);
        const unsigned i1 = x == m1 ? path : NONE;
        const unsigned f1 = __reduce_min_sync(FULL_MASK, i1);
        const Col c = {m1, f1, __reduce_min_sync(FULL_MASK, i1 == f1 ? NONE : i1)};
        Col r = c;
        uint4* part = parts + (n & 1) * (MODE == 3 ? total : 32);
        if (MODE == 1) {
            if (lane == 0) part[warp] = make_uint4(c.m1, c.f1, c.g, 0);
            __syncthreads();
            const uint4 v = lane < W ? part[lane] : make_uint4(NONE, NONE, NONE, 0);
            r = lane_merge(v.x, v.y, v.z);
        } else if (MODE == 2) {
            if (lane == 0) part[warp] = make_uint4(c.m1, c.f1, c.g, 0);
            cluster_arrive();
            cluster_wait();
            unsigned m = NONE, j1 = NONE, j2 = NONE;
            for (unsigned q = lane; q < total; q += 32)
                merge_part(m, j1, j2, cluster_load4(part + q % W, q / W));
            r = lane_merge(m, j1, j2);
        } else if (MODE == 3) {
            if (threadIdx.x == 0) mbar_expect(bar + (n & 1), total * 16);
            if (lane < (unsigned)K)
                cluster_push4(part + rank * W + warp, lane, make_uint4(c.m1, c.f1, c.g, 0),
                              bar + (n & 1));
            mbar_wait(bar + (n & 1), (n >> 1) & 1);
            unsigned m = NONE, j1 = NONE, j2 = NONE;
            for (unsigned q = lane; q < total; q += 32) merge_part(m, j1, j2, part[q]);
            r = lane_merge(m, j1, j2);
        }
        prev = r.m1 ^ r.f1 ^ (r.g >> 3);
    }
    if (threadIdx.x == 0 && rank == 0) out[blockIdx.x / K] = prev;
    if (MODE >= 2) {  // no CTA leaves while another may still touch its shared memory
        cluster_arrive();
        cluster_wait();
    }
}

// Runs `C` chains (clusters) of mode `mode` with K CTAs of W warps for N
// columns on `stream`; out [C]. Returns a cudaError_t (a cluster that
// does not fit: cudaErrorLaunchOutOfResources).
extern "C" int merge_run(int mode, int K, int W, int N, int C, unsigned* out, void* stream) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = mode >= 2 ? K : 1;
    attr[0].val.clusterDim.y = attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(C * (mode >= 2 ? K : 1), 1, 1);
    config.blockDim = dim3(32 * W, 1, 1);
    config.dynamicSmemBytes = 2 * sizeof(uint4) * (mode == 3 ? K * W : 32);
    config.stream = (cudaStream_t)stream;
    config.attrs = attr;
    config.numAttrs = 1;
    const int k = mode >= 2 ? K : 1;
    int err = 0, fits = 0;
#define MERGE_RUN(m)                                                                           \
    if (mode == m) {                                                                           \
        if (k > 8)                                                                             \
            err = (int)cudaFuncSetAttribute(merge_chain<m>,                                    \
                                            cudaFuncAttributeNonPortableClusterSizeAllowed, 1); \
        if (!err) err = (int)cudaOccupancyMaxActiveClusters(&fits, merge_chain<m>, &config);    \
        if (!err && fits < 1) err = (int)cudaErrorLaunchOutOfResources;                        \
        if (!err) err = (int)cudaLaunchKernelEx(&config, merge_chain<m>, N, k, out);           \
        return err ? err : (int)cudaGetLastError();                                            \
    }
    MERGE_RUN(0) MERGE_RUN(1) MERGE_RUN(2) MERGE_RUN(3)
#undef MERGE_RUN
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* merge_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
