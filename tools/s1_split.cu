// Ablations of kernel S1 (pangenie_tpu_torch/csrc/sampling_dp.cu), built
// and timed by tools/s1_times.py --variants; not used by the package.
//
// 1. The one-CTA kernel S1 was before its redesign (one thread a path,
//    two block-wide (min, argmin) reductions a column, int32 backtraces,
//    one thread chasing the path), split into:
//    - s1_old_sweep variant 0: its forward sweep alone (backtraces, best,
//      end), as it was: a column's switch, mask and cost read after the
//      column's barriers;
//    - variant 1: the same with those loads moved to the column's start;
//    - variant 2: the same with each thread's raw cost, mask byte and
//      switch loaded S1_DEPTH columns ahead into registers;
//    - s1_old_chase: its one-thread chase alone, from the backtraces.
// 2. pg_s1_sweep here: the redesigned sweep with every __reduce_min_sync
//    (redux.sync) replaced by a five-round __shfl_xor_sync butterfly.
// Each gives the same paths and scores as S1.

#include <cuda_runtime.h>

__device__ __forceinline__ unsigned shfl_min_sync(unsigned mask, unsigned v) {
    for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(mask, v, o));
    return v;
}
#define __reduce_min_sync shfl_min_sync
#include "../pangenie_tpu_torch/csrc/sampling_dp.cu"
#undef __reduce_min_sync

// the old kernel's one thread a path
#define OLD_MAX_PATHS 1024

// ---- 1. the kernel before the redesign -------------------------------

__device__ __forceinline__ u64 key_of(unsigned v, unsigned i) {
    return ((u64)v << 32) | i;
}

__device__ __forceinline__ u64 old_block_min(u64 v, u64* s_red) {
    for (int o = 16; o > 0; o >>= 1) {
        const u64 other = __shfl_down_sync(FULL_MASK, v, o);
        v = other < v ? other : v;
    }
    if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
    __syncthreads();
    u64 m = s_red[0];
    const int nwarps = blockDim.x >> 5;
    for (int w = 1; w < nwarps; ++w) m = s_red[w] < m ? s_red[w] : m;
    __syncthreads();
    return m;
}

__device__ __forceinline__ void old_finish(unsigned prev, bool live, int c,
                                           unsigned* best, int* ends, u64* s_red) {
    const u64 fin = old_block_min(live ? key_of(prev, threadIdx.x) : ~0ull, s_red);
    if (threadIdx.x == 0) {
        best[c] = (unsigned)(fin >> 32);
        ends[c] = (int)(fin & 0xFFFFFFFFu);
    }
}

// The old kernel's sweep, line for line, without its chase.
__global__ void old_sweep_kernel(const unsigned* __restrict__ cost,
                                 const unsigned char* __restrict__ mask,
                                 const unsigned* __restrict__ sw, int* __restrict__ bt,
                                 unsigned* __restrict__ best, int* __restrict__ ends, int N,
                                 int P) {
    __shared__ u64 s_red[OLD_MAX_PATHS / 32];
    const int c = blockIdx.x, i = threadIdx.x;
    const bool live = i < P;
    const size_t base = (size_t)c * N * P;
    const u64 none = ~0ull;

    unsigned prev = 0;
    bool prev_mask = false;
    for (int n = 0; n < N; ++n) {
        const unsigned masked_prev = prev_mask ? prev : UMAX;
        const u64 first = old_block_min(live ? key_of(masked_prev, i) : none, s_red);
        const unsigned first_val = (unsigned)(first >> 32);
        const int first_id = (int)(first & 0xFFFFFFFFu);
        const unsigned rest = i == first_id ? UMAX : masked_prev;
        const u64 second = old_block_min(live ? key_of(rest, i) : none, s_red);
        if (live) {
            const bool is_min = i == first_id;
            unsigned prev_cell = sat_add(
                is_min ? (unsigned)(second >> 32) : first_val, sw[(size_t)c * N + n]);
            int back = is_min ? (int)(second & 0xFFFFFFFFu) : first_id;
            if (prev_mask && prev < prev_cell) {
                prev_cell = prev;
                back = i;
            }
            if (n == 0) {
                prev_cell = 0;
                back = 0;
            }
            const size_t at = base + (size_t)n * P + i;
            const bool m = mask[at] != 0;
            prev = m ? sat_add(prev_cell, cost[at]) : UMAX;
            prev_mask = m;
            bt[at] = back;
        }
    }
    old_finish(prev, live, c, best, ends, s_red);
}

// A column's switch cost, mask and cost for one thread.
struct ColumnIn {
    unsigned sw;
    bool m;
    unsigned cost;
};

// One column of the old kernel for thread i, given its inputs; returns
// the backtrace.
__device__ __forceinline__ int old_column(int n, int i, bool live, unsigned& prev,
                                          bool& prev_mask, u64* s_red, ColumnIn in) {
    const u64 none = ~0ull;
    const unsigned masked_prev = prev_mask ? prev : UMAX;
    const u64 first = old_block_min(live ? key_of(masked_prev, i) : none, s_red);
    const unsigned first_val = (unsigned)(first >> 32);
    const int first_id = (int)(first & 0xFFFFFFFFu);
    const unsigned rest = i == first_id ? UMAX : masked_prev;
    const u64 second = old_block_min(live ? key_of(rest, i) : none, s_red);
    const bool is_min = i == first_id;
    unsigned prev_cell = sat_add(is_min ? (unsigned)(second >> 32) : first_val, in.sw);
    int back = is_min ? (int)(second & 0xFFFFFFFFu) : first_id;
    if (prev_mask && prev < prev_cell) {
        prev_cell = prev;
        back = i;
    }
    if (n == 0) {
        prev_cell = 0;
        back = 0;
    }
    prev = in.m ? sat_add(prev_cell, in.cost) : UMAX;
    prev_mask = in.m;
    return back;
}

// The old sweep with a column's loads moved to its start.
__global__ void old_early_kernel(const unsigned* __restrict__ cost,
                                 const unsigned char* __restrict__ mask,
                                 const unsigned* __restrict__ sw, int* __restrict__ bt,
                                 unsigned* __restrict__ best, int* __restrict__ ends, int N,
                                 int P) {
    __shared__ u64 s_red[OLD_MAX_PATHS / 32];
    const int c = blockIdx.x, i = threadIdx.x;
    const bool live = i < P;
    const size_t base = (size_t)c * N * P;
    unsigned prev = 0;
    bool prev_mask = false;
    for (int n = 0; n < N; ++n) {
        const size_t at = base + (size_t)n * P + i;
        ColumnIn in = {0u, false, 0u};
        if (live) in = {sw[(size_t)c * N + n], mask[at] != 0, cost[at]};
        const int back = old_column(n, i, live, prev, prev_mask, s_red, in);
        if (live) bt[at] = back;
    }
    old_finish(prev, live, c, best, ends, s_red);
}

// The old sweep with each thread's raw cost, mask byte and switch loaded
// S1_DEPTH columns ahead into registers.
__global__ void old_prefetch_kernel(const unsigned* __restrict__ cost,
                                    const unsigned char* __restrict__ mask,
                                    const unsigned* __restrict__ sw, int* __restrict__ bt,
                                    unsigned* __restrict__ best, int* __restrict__ ends,
                                    int N, int P) {
    constexpr int D = S1_DEPTH;
    __shared__ u64 s_red[OLD_MAX_PATHS / 32];
    const int c = blockIdx.x, i = threadIdx.x;
    const bool live = i < P;
    const size_t base = (size_t)c * N * P;
    unsigned ring_cost[D], ring_mask[D], ring_sw[D];
    auto load = [&](int slot_n, unsigned& k, unsigned& m, unsigned& s) {
        m = 0;
        if (slot_n >= N || !live) return;
        const size_t at = base + (size_t)slot_n * P + i;
        k = cost[at];
        m = mask[at];
        s = sw[(size_t)c * N + slot_n];
    };
#pragma unroll
    for (int d = 0; d < D; ++d) load(d, ring_cost[d], ring_mask[d], ring_sw[d]);
    unsigned prev = 0;
    bool prev_mask = false;
    for (int n0 = 0; n0 < N; n0 += D) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
            const int n = n0 + d;
            if (n >= N) break;
            const ColumnIn in = {ring_sw[d], ring_mask[d] != 0, ring_cost[d]};
            const int back = old_column(n, i, live, prev, prev_mask, s_red, in);
            if (live) bt[base + (size_t)n * P + i] = back;
            load(n + D, ring_cost[d], ring_mask[d], ring_sw[d]);
        }
    }
    old_finish(prev, live, c, best, ends, s_red);
}

__global__ void old_chase_kernel(const int* __restrict__ bt, const int* __restrict__ ends,
                                 int* __restrict__ path, int N, int P) {
    const int c = blockIdx.x;
    const size_t base = (size_t)c * N * P;
    int s = ends[c];
    for (int n = N - 1; n >= 0; --n) {
        path[(size_t)c * N + n] = s;
        s = bt[base + (size_t)n * P + s];
    }
}

// variant 0: the old sweep as it was; 1: its loads moved to the
// column's start; 2: its loads S1_DEPTH columns ahead
extern "C" int s1_old_sweep(const unsigned* cost, const unsigned char* mask,
                            const unsigned* sw, int* bt, unsigned* best, int* ends, int C,
                            int N, int P, int variant, void* stream) {
    if (P < 1 || P > OLD_MAX_PATHS || N < 1) return (int)cudaErrorInvalidValue;
    const int threads = (P + 31) / 32 * 32;
    if (variant == 0)
        return launch(old_sweep_kernel, C, threads, 0, stream, cost, mask, sw, bt, best,
                      ends, N, P);
    if (variant == 1)
        return launch(old_early_kernel, C, threads, 0, stream, cost, mask, sw, bt, best,
                      ends, N, P);
    return launch(old_prefetch_kernel, C, threads, 0, stream, cost, mask, sw, bt, best, ends,
                  N, P);
}

extern "C" int s1_old_chase(const int* bt, const int* ends, int* path, int C, int N, int P,
                            void* stream) {
    return launch(old_chase_kernel, C, 1, 0, stream, bt, ends, path, N, P);
}
