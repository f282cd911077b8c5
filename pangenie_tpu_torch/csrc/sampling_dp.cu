// Kernel S1: one masked single-path min-plus Viterbi iteration of the
// greedy haplotype sampler, for Hopper (sm_90a).
//
// Replaces: pangenie_tpu/hmm/sampling.py:_viterbi_iteration (the column
// scan) and :_blocked_viterbi (its blocked TPU formulation, bit-identical
// to the scan by construction), both XLA, run per greedy iteration by
// :_sample_group. Plain version: pangenie_tpu_torch/hmm/sampling.py
// (viterbi_iteration_plain).
//
// What bounds it on the H100: the DP is a serial chain over N columns
// with two block-wide (min, argmin) reductions per column, so a column
// costs a handful of barriers and one coalesced [P] load/store; the
// backtrace chase is a chain of N dependent loads. Latency, not
// bandwidth or arithmetic. Chromosomes are independent: one CTA each.
//
// Design: one CTA per chromosome, one thread per path. Each reduction
// packs (uint32 score, path index) into one 64-bit key, so the block
// minimum is the FIRST minimum (lowest index on ties), exactly as
// jnp.argmin / the reference's get_column_minima. Scores are uint32 with
// saturating adds; stay wins only on strict '<'; the first column is
// overridden to score 0 / backtrace 0. Backtraces go to device memory
// as int32 [C, N, P]; one thread then chases the path back from the
// first minimum of the last column. Results are bit-identical to the
// column scan. Allocates nothing; launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

#define UMAX 0xFFFFFFFFu
#define S1_MAX_PATHS 1024

typedef unsigned long long u64;

__device__ __forceinline__ unsigned sat_add(unsigned a, unsigned b) {
    const unsigned s = a + b;
    return s < a ? UMAX : s;
}

__device__ __forceinline__ u64 key_of(unsigned val, int idx) {
    return ((u64)val << 32) | (unsigned)idx;
}

// Minimum key over the block; every thread gets it.
__device__ __forceinline__ u64 block_min(u64 v, u64* s_red) {
    for (int o = 16; o > 0; o >>= 1) {
        const u64 other = __shfl_down_sync(0xffffffffu, v, o);
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

__global__ void viterbi_iteration_kernel(const unsigned* __restrict__ cost,
                                         const unsigned char* __restrict__ mask,
                                         const unsigned* __restrict__ sw,
                                         int* __restrict__ bt, int* __restrict__ path,
                                         unsigned* __restrict__ best, int N, int P) {
    __shared__ u64 s_red[S1_MAX_PATHS / 32];
    const int c = blockIdx.x, i = threadIdx.x;
    const bool live = i < P;
    const size_t base = (size_t)c * N * P;
    const u64 none = ~0ull;  // padding threads never win

    unsigned prev = 0;
    bool prev_mask = false;
    for (int n = 0; n < N; ++n) {
        const unsigned masked_prev = prev_mask ? prev : UMAX;
        const u64 first = block_min(live ? key_of(masked_prev, i) : none, s_red);
        const unsigned first_val = (unsigned)(first >> 32);
        const int first_id = (int)(first & 0xFFFFFFFFu);
        const unsigned rest = i == first_id ? UMAX : masked_prev;
        const u64 second = block_min(live ? key_of(rest, i) : none, s_red);
        if (live) {
            const bool is_min = i == first_id;
            unsigned prev_cell = sat_add(
                is_min ? (unsigned)(second >> 32) : first_val, sw[(size_t)c * N + n]);
            int back = is_min ? (int)(second & 0xFFFFFFFFu) : first_id;
            if (prev_mask && prev < prev_cell) {  // stay costs 0
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
    // the barriers inside block_min also publish every thread's backtraces
    const u64 fin = block_min(live ? key_of(prev, i) : none, s_red);
    if (i == 0) {
        best[c] = (unsigned)(fin >> 32);
        int s = (int)(fin & 0xFFFFFFFFu);
        for (int n = N - 1; n >= 0; --n) {
            path[(size_t)c * N + n] = s;
            s = bt[base + (size_t)n * P + s];
        }
    }
}

extern "C" const char* pg_s1_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

extern "C" int pg_viterbi_iteration(const unsigned* cost, const unsigned char* mask,
                                    const unsigned* sw, int* bt, int* path,
                                    unsigned* best, int C, int N, int P, void* stream) {
    if (P < 1 || P > S1_MAX_PATHS || N < 1) return (int)cudaErrorInvalidValue;
    const int threads = (P + 31) / 32 * 32;
    viterbi_iteration_kernel<<<C, threads, 0, (cudaStream_t)stream>>>(
        cost, mask, sw, bt, path, best, N, P);
    return (int)cudaGetLastError();
}
