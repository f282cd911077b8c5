// The pair-HMM forward-backward kernels for Hopper (sm_90a):
//
//   K1 fb_forward_kernel, K2 fb_backward_kernel: forward sweep, and
//      backward sweep + posterior collapse, on [A, A] emissions gathered
//      to path pairs inside the kernel (the fused route);
//   K3 fbe_forward_kernel, K4 fbe_backward_kernel: the same sweeps on
//      precomputed [P, P] state emissions, with entry carries so that a
//      chain runs in N-chunks (the generic route: any A, any length).
//
// Replaces: pangenie_tpu/hmm/pallas_fb.py:_fwd_kernel (K1), :_bwd_kernel
// (K2), driven there by forward_backward_batch_pallas, and
// :_fwd_kernel_e (K3), :_bwd_kernel_e (K4), driven by _fb_pallas_e_core.
// Plain versions: pangenie_tpu_torch/hmm/forward_backward.py
// (forward_plain, backward_plain) and hmm/fb_generic.py (forward_e_plain,
// backward_e_plain); chunk loop: fb_generic.forward_backward_chunked.
//
// What bounds them on the H100: each column depends on the previous one,
// so a chain is a serial loop of N steps whose cost is latency — a few
// block barriers, serial row/column sums of P terms and shared-memory
// passes over the [P, P] state — not bandwidth (K1 at P=16: 1 KB of alpha
// written per column) or arithmetic. K3/K4 also stream E, alpha and the
// raw posteriors through global memory: 63 KB (K3) and 95 KB (K4) per
// column at P=89, from one SM. Parallelism comes only from the batch:
// one CTA per chain, so B=2 (one chain per chromosome, the main path)
// occupies 2 of 132 SMs.
//
// Design: the whole [P, P] f32 state stays in shared memory for the
// entire sweep (row pitch P+1 so the per-row reductions are free of
// bank conflicts). Row sums / column sums / total are taken in a fixed
// order (no atomics: results do not change from run to run), and the
// state is mixed and normalized in place. K1/K2 gather E[p, q] =
// EA[al[p], al[q]] from a shared [A, A] tile (exactly the one-hot
// expansion of the Pallas kernel, with no cap on A); K1 writes alpha
// [B, N, P, P] and c_fwd [B, N], K2 reads alpha back in reverse and
// reduces alpha * cur * c_fwd to [A, A] in shared memory. K3/K4 read E
// from device memory with consecutive threads on consecutive addresses
// and use the reference's factored mix u0*c + u1*(h_i + h_j) + u2*h; the
// caller pins u = (1, 0, 0) at global column 0, so the carry needs no
// special case at any chunk's first column. K4 reads its successor
// column's E and u from the chunk, or at the chunk's last column from
// e_after / u_after (the following chunk's first column), writes the raw
// [P, P] posteriors straight to global memory and returns the normalized
// beta after the chunk's first column as the carry for the chunk before.
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

__global__ void __launch_bounds__(FB_THREADS)
fbe_forward_kernel(const float* __restrict__ E, const float* __restrict__ u,
                   const float* __restrict__ alpha0, float* __restrict__ alphas,
                   float* __restrict__ c_fwd, int N, int P) {
    extern __shared__ float smem[];
    const int pitch = P + 1;
    float* s_state = smem;                    // [P, pitch]
    float* s_row = s_state + P * pitch;       // [P]
    float* s_col = s_row + P;                 // [P]
    float* s_red = s_col + P;                 // [FB_WARPS]

    const int b = blockIdx.x, t = threadIdx.x, PP = P * P;
    const float uniform = 1.0f / (float)PP;
    const float* e_b = E + (size_t)b * N * PP;
    const float* u_b = u + (size_t)b * N * 3;
    float* alpha_b = alphas + (size_t)b * N * PP;

    for (int i = t; i < PP; i += FB_THREADS)
        s_state[(i / P) * pitch + i % P] = alpha0[(size_t)b * PP + i];
    __syncthreads();

    for (int n = 0; n < N; ++n) {
        row_col_sums(s_state, s_row, s_col, P, pitch);
        __syncthreads();
        const float u0 = u_b[n * 3 + 0], u1 = u_b[n * 3 + 1], u2 = u_b[n * 3 + 2];
        float h = 0.f;
        for (int p = 0; p < P; ++p) h += s_row[p];
        const float* e_n = e_b + (size_t)n * PP;
        float local = 0.f;
        for (int i = t; i < PP; i += FB_THREADS) {
            const int p = i / P, q = i - p * P;
            float* cell = s_state + p * pitch + q;
            const float prev = u0 * *cell + u1 * (s_row[p] + s_col[q]) + u2 * h;
            const float cur = prev * e_n[i];
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
fbe_backward_kernel(const float* __restrict__ alphas, const float* __restrict__ c_fwd,
                    const float* __restrict__ E, const float* __restrict__ u,
                    const float* __restrict__ e_after, const float* __restrict__ u_after,
                    const unsigned char* __restrict__ is_last,
                    const float* __restrict__ beta0, float* __restrict__ posts,
                    float* __restrict__ beta_out, int N, int P) {
    extern __shared__ float smem[];
    const int pitch = P + 1;
    float* s_beta = smem;                     // [P, pitch]
    float* s_row = s_beta + P * pitch;        // [P]
    float* s_col = s_row + P;                 // [P]
    float* s_red = s_col + P;                 // [FB_WARPS]

    const int b = blockIdx.x, t = threadIdx.x, PP = P * P;
    const float uniform = 1.0f / (float)PP;
    const float* e_b = E + (size_t)b * N * PP;
    const float* u_b = u + (size_t)b * N * 3;
    const float* alpha_b = alphas + (size_t)b * N * PP;
    float* post_b = posts + (size_t)b * N * PP;

    for (int i = t; i < PP; i += FB_THREADS)
        s_beta[(i / P) * pitch + i % P] = beta0[(size_t)b * PP + i];
    __syncthreads();

    for (int n = N - 1; n >= 0; --n) {
        // successor column: inside the chunk, or the following chunk's first
        const bool tail = n + 1 == N;
        const float* e_nx = tail ? e_after + (size_t)b * PP : e_b + (size_t)(n + 1) * PP;
        const float* u_nx = tail ? u_after + (size_t)b * 3 : u_b + (size_t)(n + 1) * 3;

        // helper = beta * E_{n+1}, in place
        for (int i = t; i < PP; i += FB_THREADS) {
            const int p = i / P, q = i - p * P;
            s_beta[p * pitch + q] *= e_nx[i];
        }
        __syncthreads();
        const bool last = is_last[(size_t)b * N + n] != 0;
        if (!last) row_col_sums(s_beta, s_row, s_col, P, pitch);
        __syncthreads();

        float u0 = 0.f, u1 = 0.f, u2 = 0.f, h = 0.f;
        if (!last) {
            u0 = u_nx[0];
            u1 = u_nx[1];
            u2 = u_nx[2];
            for (int p = 0; p < P; ++p) h += s_row[p];
        }
        const float cf = c_fwd[(size_t)b * N + n];
        const float* a_n = alpha_b + (size_t)n * PP;
        float* post_n = post_b + (size_t)n * PP;
        float local = 0.f;
        for (int i = t; i < PP; i += FB_THREADS) {
            const int p = i / P, q = i - p * P;
            float* cell = s_beta + p * pitch + q;
            // is_last re-seeds the sweep with ones (src/hmm.cpp:321-324)
            const float cur = last
                ? 1.f : u0 * *cell + u1 * (s_row[p] + s_col[q]) + u2 * h;
            *cell = cur;
            local += cur;
            // the raw posterior takes the un-normalized cur
            post_n[i] = a_n[i] * cur * cf;
        }
        const float s = block_sum(local, s_red);
        const bool pos = s > 0.f;
        for (int i = t; i < PP; i += FB_THREADS) {
            const int p = i / P, q = i - p * P;
            float* cell = s_beta + p * pitch + q;
            *cell = pos ? *cell / s : uniform;
        }
        __syncthreads();
    }
    for (int i = t; i < PP; i += FB_THREADS)
        beta_out[(size_t)b * PP + i] = s_beta[(i / P) * pitch + i % P];
}

static size_t forward_smem(int P, int A) {
    return sizeof(float) * ((size_t)P * (P + 1) + 2 * P + A * A + FB_WARPS)
        + sizeof(int) * P;
}

static size_t backward_smem(int P, int A) {
    return sizeof(float) * (2 * (size_t)P * (P + 1) + 2 * P + A * A + P * A + FB_WARPS)
        + sizeof(int) * 2 * P;
}

static size_t generic_smem(int P) {
    return sizeof(float) * ((size_t)P * (P + 1) + 2 * P + FB_WARPS);
}

// One CTA per chain; checks P, opts in to the kernel's shared memory,
// launches on the caller's stream and returns the cudaError_t.
template <typename Kernel, typename... Args>
static int launch(Kernel kernel, int B, int P, size_t smem, void* stream,
                  Args... args) {
    if (P < 1 || P > FB_MAX_PATHS) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B, FB_THREADS, smem, (cudaStream_t)stream>>>(args...);
    return (int)cudaGetLastError();
}

extern "C" const char* pg_fb_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

extern "C" int pg_fb_forward(const float* ea, const int* al, const float* trans,
                             float* alphas, float* c_fwd, int B, int N, int P,
                             int A, void* stream) {
    if (A < 1) return (int)cudaErrorInvalidValue;
    return launch(fb_forward_kernel, B, P, forward_smem(P, A), stream,
                  ea, al, trans, alphas, c_fwd, N, P, A);
}

extern "C" int pg_fb_backward(const float* alphas, const float* c_fwd,
                              const float* ea, const int* al, const float* trans,
                              const unsigned char* is_last, float* posts, int B,
                              int N, int P, int A, void* stream) {
    if (A < 1) return (int)cudaErrorInvalidValue;
    return launch(fb_backward_kernel, B, P, backward_smem(P, A), stream,
                  alphas, c_fwd, ea, al, trans, is_last, posts, N, P, A);
}

extern "C" int pg_fbe_forward(const float* E, const float* u, const float* alpha0,
                              float* alphas, float* c_fwd, int B, int N, int P,
                              void* stream) {
    return launch(fbe_forward_kernel, B, P, generic_smem(P), stream,
                  E, u, alpha0, alphas, c_fwd, N, P);
}

extern "C" int pg_fbe_backward(const float* alphas, const float* c_fwd,
                               const float* E, const float* u, const float* e_after,
                               const float* u_after, const unsigned char* is_last,
                               const float* beta0, float* posts, float* beta_out,
                               int B, int N, int P, void* stream) {
    return launch(fbe_backward_kernel, B, P, generic_smem(P), stream,
                  alphas, c_fwd, E, u, e_after, u_after, is_last, beta0, posts,
                  beta_out, N, P);
}
