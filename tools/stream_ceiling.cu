// What one CTA can stream through one SM of an H100, column by column,
// in the shape of kernels K3/K4 (csrc/fb.cu) but without their
// arithmetic: a ring of D slots in shared memory, each filled with
// `loads` columns by 16-byte cp.async (K3 loads E; K4 E and alpha), and
// a staging column copied out with 16-byte stores when `store` is set,
// with two block barriers per column. Built and driven by
// tools/stream_ceiling.py (rings of 2 to 6 slots).
//
// With `direct`, no shared memory: each thread copies its float4s of a
// column global to global (LDG/STG), no barriers.

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}

// D slots; column n + D is fetched while column n is used, and column n
// waited for with at most D - 1 later copy groups in flight
template <int D>
__global__ void __launch_bounds__(1024, 1)
stream_kernel(const float4* __restrict__ src, float4* __restrict__ dst, int N, int V,
              int loads, int store, int direct) {
    extern __shared__ __align__(16) float4 sm[];
    const int t = threadIdx.x, T = blockDim.x;
    // loads sources of N columns each, one destination
    src += (size_t)blockIdx.x * 2 * N * V;
    dst += (size_t)blockIdx.x * N * V;
    if (direct) {
        for (int n = 0; n < N; ++n)
            for (int v = t; v < V; v += T) dst[(size_t)n * V + v] = src[(size_t)n * V + v];
        return;
    }
    const int slot_v = loads > 0 ? loads * V : V;
    float4* stage = sm + (size_t)D * slot_v;
    auto fetch = [&](int m, int slot) {
        for (int j = 0; j < loads; ++j)
            for (int v = t; v < V; v += T)
                cp_async16(sm + (size_t)slot * slot_v + (size_t)j * V + v,
                           src + ((size_t)j * N + m) * V + v);
    };
    for (int j = 0; j < D; ++j) {
        if (j < N) fetch(j, j);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    for (int n = 0; n < N; ++n) {
        const int slot = n % D;
        asm volatile("cp.async.wait_group %0;\n" :: "n"(D - 1) : "memory");
        __syncthreads();
        for (int v = t; v < V; v += T) stage[v] = sm[(size_t)slot * slot_v + v];
        __syncthreads();
        if (n + D < N) fetch(n + D, slot);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        if (store)
            for (int v = t; v < V; v += T) dst[(size_t)n * V + v] = stage[v];
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int D>
static int run(const void* src, void* dst, int B, int N, int V, int loads, int store,
               int direct, int threads, void* stream) {
    const size_t smem = ((size_t)D * (loads > 0 ? loads : 1) + 1) * V * 16;
    cudaError_t err = cudaFuncSetAttribute(
        stream_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    stream_kernel<D><<<B, threads, smem, (cudaStream_t)stream>>>(
        (const float4*)src, (float4*)dst, N, V, loads, store, direct);
    return (int)cudaGetLastError();
}

extern "C" int stream_run(const void* src, void* dst, int B, int N, int V, int D,
                          int loads, int store, int direct, int threads, void* stream) {
    switch (D) {
    case 2: return run<2>(src, dst, B, N, V, loads, store, direct, threads, stream);
    case 3: return run<3>(src, dst, B, N, V, loads, store, direct, threads, stream);
    case 4: return run<4>(src, dst, B, N, V, loads, store, direct, threads, stream);
    case 5: return run<5>(src, dst, B, N, V, loads, store, direct, threads, stream);
    case 6: return run<6>(src, dst, B, N, V, loads, store, direct, threads, stream);
    default: return (int)cudaErrorInvalidValue;
    }
}
