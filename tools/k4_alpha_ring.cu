// An ablation of kernel K4 (pangenie_tpu_torch/csrc/fb.cu), not used by
// the port: alpha_n travels through the E ring, copied by 16-byte
// cp.async into each slot beside its column's E, where K4 itself loads
// it from global memory into registers a column ahead. Everything else
// is K4's code and arithmetic, so the two give the same bits. A slot
// holds two columns, so the ring of FBE_RING slots fits the shared
// memory of one block only up to P = 105. Built and timed against K4 by
// tools/k4_alpha_ring.py.

#include "../pangenie_tpu_torch/csrc/fb.cu"

// fbe_layout with a second column (alpha) in every slot
__device__ __forceinline__ FbeSmem alpha_ring_layout(int P) {
    FbeSmem s = fbe_layout(P);
    const int extra = FBE_RING * fbe_column_floats(P);
    s.slot_pitch += fbe_column_floats(P);
    s.stage += extra;
    s.colpart += extra;
    s.col += extra;
    s.wsum += extra;
    s.wcur += extra;
    s.tot += extra;
    return s;
}

static size_t alpha_ring_smem(int P) {
    return fbe_smem(P) + sizeof(float) * FBE_RING * fbe_column_floats(P);
}

template <int RW, int NC>
__global__ void __launch_bounds__(32 * FBE_WARPS, 1)
alpha_ring_kernel(const float* __restrict__ alphas, const float* __restrict__ c_fwd,
                  const float* __restrict__ E, const float* __restrict__ u,
                  const float* __restrict__ e_after, const float* __restrict__ u_after,
                  const int* __restrict__ is_last,
                  const float* __restrict__ beta0, float* __restrict__ posts,
                  float* __restrict__ beta_out, int N, int P) {
    constexpr int D = FBE_RING;
    const Cells<RW, NC> c(P);
    const int PP = P * P, b = blockIdx.x, t = threadIdx.x, last_t = blockDim.x - 1;
    const FbeSmem s = alpha_ring_layout(P);
    const int acol = FBE_HEADER + fbe_column_floats(P);   // alpha's place in a slot
    const float uniform = 1.0f / (float)PP;
    const float* e_b = E + (size_t)b * N * PP;
    const float* u_b = u + (size_t)b * N * 3;
    const float* alpha_b = alphas + (size_t)b * N * PP;
    const float* cf_b = c_fwd + (size_t)b * N;
    const int* last_b = is_last + (size_t)b * N;
    float* post_b = posts + (size_t)b * N * PP;

    // column m into its slot: E, alpha, and u, c_fwd, is_last in the header
    auto fetch = [&](int m, int slot) {
        float* hdr = fbe_shm + (size_t)slot * s.slot_pitch;
        fetch_column(hdr + FBE_HEADER, e_b + (size_t)m * PP, PP);
        fetch_column(hdr + acol, alpha_b + (size_t)m * PP, PP);
        if (t == last_t) {
            for (int j = 0; j < 3; ++j) cp_async4(hdr + j, u_b + 3 * m + j);
            cp_async4(hdr + 3, cf_b + m);
            cp_async4(hdr + 4, last_b + m);
        }
    };
    for (int j = 0; j < D; ++j) {
        if (j < N) fetch(N - 1 - j, j);
        cp_async_commit();
    }
    // a keeps cur for beta_out
    float g[RW][NC], a[RW][NC], R[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int k = 0; k < NC; ++k) {
            const int i = c.at(r, k);
            g[r][k] = c.ok(r, k) ? beta0[(size_t)b * PP + i] * e_after[(size_t)b * PP + i] : 0.f;
        }
    reduce_warp(g, R, c, s, 0.f, false);
    cp_async_wait<D - 1>();
    __syncthreads();
    reduce_block(s, P, false);
    __syncthreads();
    float H = fbe_shm[s.tot + 0], inv = 1.f, z = 1.f;
    float u0 = u_after[(size_t)b * 3], u1 = u_after[(size_t)b * 3 + 1],
          u2 = u_after[(size_t)b * 3 + 2];
    int slot = 0;

    for (int n = N - 1; n >= 0; --n) {
        const float* hdr = fbe_shm + (size_t)slot * s.slot_pitch;
        const float* e = hdr + FBE_HEADER + misalign(e_b + (size_t)n * PP);
        const float* al = hdr + acol + misalign(alpha_b + (size_t)n * PP);
        const float nu0 = hdr[0], nu1 = hdr[1], nu2 = hdr[2], cf = hdr[3];
        const bool last = ((const int*)hdr)[4] != 0;
        float* st = fbe_shm + s.stage + misalign(post_b + (size_t)n * PP);
        const float hh = u2 * H;
        float csum = 0.f, C[NC];
#pragma unroll
        for (int k = 0; k < NC; ++k) {
            const int q = c.lane + 32 * k;
            C[k] = q < P ? fbe_shm[s.col + q] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < RW; ++r) {
            const int row = c.at(r, 0);
#pragma unroll
            for (int k = 0; k < NC; ++k) {
                const bool ok = c.ok(r, k);
                float cur = last ? 1.f : inv * (u0 * g[r][k] + u1 * (R[r] + C[k]) + hh);
                cur = ok ? cur : 0.f;
                if (ok) st[row + 32 * k] = al[row + 32 * k] * cur * cf;
                a[r][k] = cur;
                csum += cur;
                g[r][k] = cur * (ok ? e[row + 32 * k] : 0.f);
            }
        }
        reduce_warp(g, R, c, s, csum, true);
        __syncthreads();
        if (n - D >= 0) fetch(n - D, slot);
        cp_async_commit();
        cp_async_wait<D - 1>();
        slot = slot + 1 == D ? 0 : slot + 1;
        store_column(post_b + (size_t)n * PP, fbe_shm + s.stage, PP);
        reduce_block(s, P, true);
        __syncthreads();
        H = fbe_shm[s.tot + 0];
        inv = fbe_shm[s.tot + 1];
        z = fbe_shm[s.tot + 2];
        if (!(z > 0.f) && n > 0) {
            const float* e_n = e_b + (size_t)n * PP;
#pragma unroll
            for (int r = 0; r < RW; ++r)
#pragma unroll
                for (int k = 0; k < NC; ++k)
                    g[r][k] = c.ok(r, k) ? uniform * e_n[c.at(r, k)] : 0.f;
            reduce_warp(g, R, c, s, 0.f, false);
            __syncthreads();
            reduce_block(s, P, false);
            __syncthreads();
            H = fbe_shm[s.tot + 0];
            inv = 1.f;
        }
        u0 = nu0;
        u1 = nu1;
        u2 = nu2;
    }
    float* bo = beta_out + (size_t)b * PP;
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int k = 0; k < NC; ++k)
            if (c.ok(r, k)) bo[c.at(r, k)] = z > 0.f ? a[r][k] * inv : uniform;
    cp_async_wait<0>();
}

// pg_fbe_backward's arguments and checks, with the larger ring
extern "C" int k4_alpha_ring(const float* alphas, const float* c_fwd, const float* E,
                             const float* u, const float* e_after, const float* u_after,
                             const int* is_last, const float* beta0, float* posts,
                             float* beta_out, int B, int N, int P, void* stream) {
    const size_t smem = alpha_ring_smem(P);
    if (P < 1 || P > FB_MAX_PATHS || smem > 232448) return (int)cudaErrorInvalidValue;
    const int RW = (P + FBE_WARPS - 1) / FBE_WARPS, NC = (P + 31) / 32;
#define ALPHA_RING(rw, nc)                                                       \
    if (RW == rw && NC == nc)                                                    \
        return launch(alpha_ring_kernel<rw, nc>, B, P, 32 * FBE_WARPS, smem, stream, \
                      alphas, c_fwd, E, u, e_after, u_after, is_last, beta0, posts, \
                      beta_out, N, P);
    FBE_INSTANCES(ALPHA_RING)
#undef ALPHA_RING
    return (int)cudaErrorInvalidValue;
}
