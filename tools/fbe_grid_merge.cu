// The cross-CTA merge of K3/K4's grid tier alone, to choose its shape and
// split a column's time into its CTA part and its merge
// (tools/fbe_grid_merge.py builds and times it).
//
// G CTAs of 1024 threads, all resident (a cooperative launch), run N
// chained columns. In every column each CTA forms a message of M = P + 1
// floats (P column partials and a band total) from the previous column's
// merged sums, writes it to global memory, and then:
// - mode 0: nothing more: the CTA keeps its own message (the floor);
// - mode 1: one bare arrival on the chain's counter and a wait for all G;
// - mode 2: one hop: one arrival and wait, then every CTA sums every
//   entry over the G messages in rank order (G x M floats read a CTA);
// - mode 3: two hops, as the grid tier merges: one arrival and wait, a
//   reduce-scatter (CTA g sums its slice of M / G entries over the G
//   messages, a warp an entry, lanes over the ranks), a second arrival
//   and wait, an all-gather (every CTA reads the M sums);
// - mode 4: two bare arrivals and waits.
// The messages hold small whole numbers, so every sum is exact and modes
// 2 and 3 leave the same bits in out[].
#include <cuda_runtime.h>
#include <stdint.h>

#include "../pangenie_tpu_torch/csrc/grid.cuh"

extern __shared__ float merge_shm[];

__device__ __forceinline__ float warp_total(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__global__ void __launch_bounds__(1024, 1)
merge_kernel(float* msgs, float* sums, unsigned* counter, float* out, int N, int M, int msg,
             int mode) {
    const int G = gridDim.x, rank = blockIdx.x, t = threadIdx.x, T = blockDim.x;
    const int W = T >> 5, w = t >> 5, lane = t & 31;
    float* col = merge_shm;
    for (int q = t; q < M; q += T) col[q] = (float)(q % 5);
    __syncthreads();
    unsigned arrivals = 0;
    for (int n = 0; n < N; ++n) {
        const int p = n & 1;
        float* mine = msgs + (size_t)(p * G + rank) * msg;
        for (int q = t; q < M; q += T) {
            const float v = fmodf(col[q] + (float)(rank + n), 7.f);
            grid_store(mine + q, v);
            if (mode == 0 || mode == 1 || mode == 4) col[q] = v;
        }
        __syncthreads();
        if (mode == 0) continue;
        grid_arrive(counter);
        grid_wait(counter, ++arrivals * G);
        if (mode == 1) continue;
        if (mode == 2) {
            for (int q = t; q < M; q += T) {
                float x = 0.f;
                for (int k = 0; k < G; ++k) x += grid_load(msgs + (size_t)(p * G + k) * msg + q);
                col[q] = x;
            }
            continue;
        }
        if (mode == 3) {
            const int lo = rank * M / G, hi = (rank + 1) * M / G;
            for (int q = lo + w; q < hi; q += W) {
                float x = 0.f;
                for (int k = lane; k < G; k += 32)
                    x += grid_load(msgs + (size_t)(p * G + k) * msg + q);
                x = warp_total(x);
                if (lane == 0) grid_store(sums + (size_t)p * msg + q, x);
            }
        }
        __syncthreads();
        grid_arrive(counter);
        grid_wait(counter, ++arrivals * G);
        if (mode == 3)
            for (int q = t; q < M; q += T) col[q] = grid_load(sums + (size_t)p * msg + q);
    }
    if (rank == 0)
        for (int q = t; q < M; q += T) out[q] = col[q];
}

// The floats of a message of P paths (P partials and a total, padded to
// float4s): the sizes of msgs ([2, G, msg]), sums ([2, msg]) and out.
extern "C" int merge_msg_floats(int P) { return (P + 1 + 3) & ~3; }

extern "C" int merge_run(int mode, int G, int P, int N, float* msgs, float* sums,
                         unsigned* counter, float* out, void* stream) {
    const int M = P + 1, msg = merge_msg_floats(P);
    const size_t smem = sizeof(float) * msg;
    cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(unsigned), (cudaStream_t)stream);
    if (err) return (int)err;
    err = cudaFuncSetAttribute(merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err) return (int)err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(G, 1, 1);
    config.blockDim = dim3(1024, 1, 1);
    config.dynamicSmemBytes = smem;
    config.stream = (cudaStream_t)stream;
    config.attrs = attr;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, merge_kernel, msgs, sums, counter, out, N, M, msg, mode);
    if (err) return (int)err;
    return (int)cudaGetLastError();
}

extern "C" const char* merge_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
