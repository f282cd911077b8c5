// Kernels K1 (forward sweep) and K2 (backward sweep + posterior collapse)
// of the pair-HMM forward-backward, for Hopper (sm_90a).
//
// Replaces: pangenie_tpu/hmm/pallas_fb.py:_fwd_kernel (K1) and
// :_bwd_kernel (K2), driven there by forward_backward_batch_pallas.
// Plain version: pangenie_tpu_torch/hmm/forward_backward.py
// (forward_plain, backward_plain).
//
// What bounds it on the H100: each column depends on the previous one,
// so a chain is a serial loop of N steps whose cost is latency — a few
// block barriers and shared-memory passes over the [P, P] state — not
// bandwidth (P=16: 1 KB of alpha written per column) or arithmetic.
// Parallelism comes only from the batch: one CTA per chain, so B=2 (one
// chain per chromosome, the main path) occupies 2 of 132 SMs.
//
// Design: the whole [P, P] f32 state stays in shared memory for the
// entire sweep (row pitch P+1 so the per-row reductions are free of
// bank conflicts). Per column the CTA gathers E[p, q] = EA[al[p], al[q]]
// from a shared [A, A] tile (exactly the one-hot expansion of the
// Pallas kernel, with no cap on A), takes row sums / column sums /
// total in a fixed order (no atomics: results do not change from run
// to run), and mixes and normalizes in place. K1 writes alpha
// [B, N, P, P] and c_fwd [B, N] to device memory; K2 reads alpha back
// in reverse and reduces alpha * cur * c_fwd to [A, A] in shared memory.
// Allocates nothing; launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

#define FB_THREADS 256
#define FB_WARPS (FB_THREADS / 32)
#define FB_MAX_PATHS (FB_THREADS / 2)

// Sum over the block in a fixed order; every thread gets the total.
__device__ __forceinline__ float block_sum(float v, float* s_red) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
    __syncthreads();
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < FB_WARPS; ++w) total += s_red[w];
    __syncthreads();
    return total;
}

// Row sums (threads [0, P)) and column sums (threads [P, 2P)).
__device__ __forceinline__ void row_col_sums(const float* s, float* s_row,
                                             float* s_col, int P, int pitch) {
    const int t = threadIdx.x;
    if (t < P) {
        const float* r = s + t * pitch;
        float acc = 0.f;
        for (int q = 0; q < P; ++q) acc += r[q];
        s_row[t] = acc;
    } else if (t < 2 * P) {
        const int q = t - P;
        float acc = 0.f;
        for (int p = 0; p < P; ++p) acc += s[p * pitch + q];
        s_col[q] = acc;
    }
}

// prev = t0*a + t1*(h_i + h_j - 2a) + t2*(h - h_i - h_j + a)
__device__ __forceinline__ float mix(float a, float hi, float hj, float h,
                                     float t0, float t1, float t2) {
    return t0 * a + t1 * (hi + hj - 2.f * a) + t2 * (h - hi - hj + a);
}

__global__ void __launch_bounds__(FB_THREADS)
fb_forward_kernel(const float* __restrict__ ea, const int* __restrict__ al,
                  const float* __restrict__ trans, float* __restrict__ alphas,
                  float* __restrict__ c_fwd, int N, int P, int A) {
    extern __shared__ float smem[];
    const int pitch = P + 1;
    float* s_state = smem;                    // [P, pitch]
    float* s_row = s_state + P * pitch;       // [P]
    float* s_col = s_row + P;                 // [P]
    float* s_ea = s_col + P;                  // [A, A]
    float* s_red = s_ea + A * A;              // [FB_WARPS]
    int* s_al = (int*)(s_red + FB_WARPS);     // [P]

    const int b = blockIdx.x, t = threadIdx.x, PP = P * P, AA = A * A;
    const float uniform = 1.0f / (float)PP;
    const float* ea_b = ea + (size_t)b * N * AA;
    const int* al_b = al + (size_t)b * N * P;
    const float* tr_b = trans + (size_t)b * N * 3;
    float* alpha_b = alphas + (size_t)b * N * PP;

    for (int n = 0; n < N; ++n) {
        for (int i = t; i < AA; i += FB_THREADS) s_ea[i] = ea_b[(size_t)n * AA + i];
        for (int i = t; i < P; i += FB_THREADS) s_al[i] = al_b[(size_t)n * P + i];
        if (n > 0) row_col_sums(s_state, s_row, s_col, P, pitch);
        __syncthreads();

        float t0 = 0.f, t1 = 0.f, t2 = 0.f, h = 0.f;
        if (n > 0) {
            t0 = tr_b[n * 3 + 0];
            t1 = tr_b[n * 3 + 1];
            t2 = tr_b[n * 3 + 2];
            for (int p = 0; p < P; ++p) h += s_row[p];
        }
        float local = 0.f;
        for (int i = t; i < PP; i += FB_THREADS) {
            const int p = i / P, q = i - p * P;
            float* cell = s_state + p * pitch + q;
            // the first column starts from all-ones (src/hmm.cpp:236-239)
            const float prev = n == 0
                ? 1.f : mix(*cell, s_row[p], s_col[q], h, t0, t1, t2);
            const float cur = prev * s_ea[s_al[p] * A + s_al[q]];
            *cell = cur;
            local += cur;
        }
        const float s = block_sum(local, s_red);
        const bool pos = s > 0.f;
        for (int i = t; i < PP; i += FB_THREADS) {
            const int p = i / P, q = i - p * P;
            float* cell = s_state + p * pitch + q;
            const float v = pos ? *cell / s : uniform;
            *cell = v;
            alpha_b[(size_t)n * PP + i] = v;
        }
        if (t == 0) c_fwd[(size_t)b * N + n] = pos ? s : 1.f;
        __syncthreads();
    }
}

__global__ void __launch_bounds__(FB_THREADS)
fb_backward_kernel(const float* __restrict__ alphas, const float* __restrict__ c_fwd,
                   const float* __restrict__ ea, const int* __restrict__ al,
                   const float* __restrict__ trans,
                   const unsigned char* __restrict__ is_last,
                   float* __restrict__ posts, int N, int P, int A) {
    extern __shared__ float smem[];
    const int pitch = P + 1;
    float* s_beta = smem;                     // [P, pitch]
    float* s_post = s_beta + P * pitch;       // [P, pitch]
    float* s_row = s_post + P * pitch;        // [P]
    float* s_col = s_row + P;                 // [P]
    float* s_ea = s_col + P;                  // [A, A] successor column
    float* s_tmp = s_ea + A * A;              // [P, A]
    float* s_red = s_tmp + P * A;             // [FB_WARPS]
    int* s_aln = (int*)(s_red + FB_WARPS);    // [P] successor column
    int* s_al = s_aln + P;                    // [P] this column

    const int b = blockIdx.x, t = threadIdx.x, PP = P * P, AA = A * A;
    const float uniform = 1.0f / (float)PP;
    const float* ea_b = ea + (size_t)b * N * AA;
    const int* al_b = al + (size_t)b * N * P;
    const float* tr_b = trans + (size_t)b * N * 3;
    const float* alpha_b = alphas + (size_t)b * N * PP;
    float* post_b = posts + (size_t)b * N * AA;

    for (int i = t; i < PP; i += FB_THREADS) s_beta[(i / P) * pitch + i % P] = 0.f;

    for (int n = N - 1; n >= 0; --n) {
        // successor column, wrapping at the end like jnp.roll (the
        // wrapped values are unused at is_last)
        const int nx = n + 1 == N ? 0 : n + 1;
        for (int i = t; i < AA; i += FB_THREADS) s_ea[i] = ea_b[(size_t)nx * AA + i];
        for (int i = t; i < P; i += FB_THREADS) {
            s_aln[i] = al_b[(size_t)nx * P + i];
            s_al[i] = al_b[(size_t)n * P + i];
        }
        __syncthreads();

        // helper = beta * E_{n+1}, in place
        for (int i = t; i < PP; i += FB_THREADS) {
            const int p = i / P, q = i - p * P;
            s_beta[p * pitch + q] *= s_ea[s_aln[p] * A + s_aln[q]];
        }
        __syncthreads();
        const bool last = is_last[(size_t)b * N + n] != 0;
        if (!last) row_col_sums(s_beta, s_row, s_col, P, pitch);
        __syncthreads();

        float t0 = 0.f, t1 = 0.f, t2 = 0.f, h = 0.f;
        if (!last) {
            t0 = tr_b[nx * 3 + 0];
            t1 = tr_b[nx * 3 + 1];
            t2 = tr_b[nx * 3 + 2];
            for (int p = 0; p < P; ++p) h += s_row[p];
        }
        const float cf = c_fwd[(size_t)b * N + n];
        float local = 0.f;
        for (int i = t; i < PP; i += FB_THREADS) {
            const int p = i / P, q = i - p * P;
            float* cell = s_beta + p * pitch + q;
            const float cur = last
                ? 1.f : mix(*cell, s_row[p], s_col[q], h, t0, t1, t2);
            *cell = cur;
            local += cur;
            s_post[p * pitch + q] = alpha_b[(size_t)n * PP + i] * cur * cf;
        }
        const float s = block_sum(local, s_red);
        const bool pos = s > 0.f;
        for (int i = t; i < PP; i += FB_THREADS) {
            const int p = i / P, q = i - p * P;
            float* cell = s_beta + p * pitch + q;
            *cell = pos ? *cell / s : uniform;
        }

        // collapse to allele pairs: tmp[p, c] = sum_{q: al[q]=c} post[p, q],
        // then out[a, c] = sum_{p: al[p]=a} tmp[p, c]
        for (int j = t; j < P * A; j += FB_THREADS) {
            const int p = j / A, c = j - p * A;
            const float* row = s_post + p * pitch;
            float acc = 0.f;
            for (int q = 0; q < P; ++q)
                if (s_al[q] == c) acc += row[q];
            s_tmp[j] = acc;
        }
        __syncthreads();
        for (int j = t; j < AA; j += FB_THREADS) {
            const int a = j / A, c = j - a * A;
            float acc = 0.f;
            for (int p = 0; p < P; ++p)
                if (s_al[p] == a) acc += s_tmp[p * A + c];
            post_b[(size_t)n * AA + j] = acc;
        }
        __syncthreads();
    }
}

static size_t forward_smem(int P, int A) {
    return sizeof(float) * ((size_t)P * (P + 1) + 2 * P + A * A + FB_WARPS)
        + sizeof(int) * P;
}

static size_t backward_smem(int P, int A) {
    return sizeof(float) * (2 * (size_t)P * (P + 1) + 2 * P + A * A + P * A + FB_WARPS)
        + sizeof(int) * 2 * P;
}

extern "C" const char* pg_fb_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

extern "C" int pg_fb_forward(const float* ea, const int* al, const float* trans,
                             float* alphas, float* c_fwd, int B, int N, int P,
                             int A, void* stream) {
    if (P < 1 || P > FB_MAX_PATHS || A < 1) return (int)cudaErrorInvalidValue;
    const size_t smem = forward_smem(P, A);
    cudaError_t err = cudaFuncSetAttribute(
        fb_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fb_forward_kernel<<<B, FB_THREADS, smem, (cudaStream_t)stream>>>(
        ea, al, trans, alphas, c_fwd, N, P, A);
    return (int)cudaGetLastError();
}

extern "C" int pg_fb_backward(const float* alphas, const float* c_fwd,
                              const float* ea, const int* al, const float* trans,
                              const unsigned char* is_last, float* posts, int B,
                              int N, int P, int A, void* stream) {
    if (P < 1 || P > FB_MAX_PATHS || A < 1) return (int)cudaErrorInvalidValue;
    const size_t smem = backward_smem(P, A);
    cudaError_t err = cudaFuncSetAttribute(
        fb_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fb_backward_kernel<<<B, FB_THREADS, smem, (cudaStream_t)stream>>>(
        alphas, c_fwd, ea, al, trans, is_last, posts, N, P, A);
    return (int)cudaGetLastError();
}
