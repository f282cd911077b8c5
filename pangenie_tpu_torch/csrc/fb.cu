// The pair-HMM forward-backward kernels for Hopper (sm_90a):
//
//   K1 fb_forward_warp_kernel / fb_forward_kernel, K2
//      fb_backward_warp_kernel / fb_backward_kernel: forward sweep, and
//      backward sweep + posterior collapse, on [A, A] emissions gathered
//      to path pairs inside the kernel (the fused route);
//   K3 fbe_forward_kernel, K4 fbe_backward_kernel: the same sweeps on
//      precomputed [P, P] state emissions, with entry carries so that a
//      chain runs in N-chunks (the generic route: any A, any length, any
//      P; past 128 paths fbe_forward_cluster_kernel /
//      fbe_backward_cluster_kernel, and past what a cluster holds
//      fbe_forward_grid_kernel / fbe_backward_grid_kernel).
//
// Tiers by P: K1 and K2 run one warp a chain (fb_forward_warp_kernel,
// fb_backward_warp_kernel) up to P = 32 and A = 8 and a CTA of 256
// threads a chain (fb_forward_kernel, fb_backward_kernel) up to 128, by
// one rule for both (pg_fb_threads); K3/K4 keep
// the state in one CTA's registers up to 128, in the registers of a
// thread-block cluster of CTAs a chain up to 471 (fbe_cluster_layout),
// and beyond on a grid of CTAs a chain that merge through L2, the state
// in registers, shared or global memory (fbg_layout; their sections
// below).
//
// Replaces: pangenie_tpu/hmm/pallas_fb.py:_fwd_kernel (K1), :_bwd_kernel
// (K2), driven there by forward_backward_batch_pallas, and
// :_fwd_kernel_e (K3), :_bwd_kernel_e (K4), driven by _fb_pallas_e_core.
// Plain versions: pangenie_tpu_torch/hmm/forward_backward.py
// (forward_plain, backward_plain) and hmm/fb_generic.py (forward_e_plain,
// backward_e_plain); chunk loop: fb_generic.forward_backward_chunked.
//
// What bounds them on the H100: each column depends on the previous one,
// so a chain is a serial loop of N steps whose cost is latency — block
// barriers, reductions over the [P, P] state and the wait for each
// column's inputs — not bandwidth (K1 at P=16: 1 KB of alpha written per
// column) or arithmetic. K3/K4 also stream E, alpha and the raw
// posteriors through global memory: 63 KB (K3) and 95 KB (K4) per column
// at P=89, from one SM. Up to 128 paths parallelism comes only from the
// batch: one CTA per chain, so B=1 (a long chromosome's chunk) occupies 1
// of 132 SMs; past 128 paths a chain's rows spread over a cluster of up
// to 16 CTAs, and past 471 over up to every SM, whose merge of the
// column sums then joins the chain.
//
// K1's and K2's one-warp tiers keep the state in a warp's registers, K1
// also in shared memory for its sums (their sections below; K1's gives
// the 256-thread kernel's bits). Their 256-thread tiers: the whole
// [P, P] f32 state stays in shared memory for the entire sweep (row pitch
// P+1 so the per-row reductions are free of bank conflicts). Row sums / column sums / total are taken in a fixed
// order (no atomics: results do not change from run to run), and the
// state is mixed and normalized in place. K1/K2 gather E[p, q] =
// EA[al[p], al[q]] from a shared [A, A] tile (exactly the one-hot
// expansion of the Pallas kernel, with no cap on A); K1 writes alpha
// [B, N, P, P] and c_fwd [B, N], K2 reads alpha back in reverse and
// reduces alpha * cur * c_fwd to [A, A] in shared memory.
//
// K3/K4 use the reference's factored mix u0*c + u1*(h_i + h_j) + u2*h;
// the caller pins u = (1, 0, 0) at global column 0, so the carry needs no
// special case at any chunk's first column. K4 reads its successor
// column's E and u from the chunk, or at the chunk's last column from
// e_after / u_after (the following chunk's first column), writes the raw
// [P, P] posteriors straight to global memory and returns the normalized
// beta after the chunk's first column as the carry for the chunk before.
// The register tiers' design (P <= 128), against what made a column slow:
//
// - The state lives in registers. 16 warps (512 threads, so 128
//   registers a thread); warp w owns rows p = w + 16*r (r < RW =
//   ceil(P / 16)) and lane l owns columns q = l + 32*k (k < NC =
//   ceil(P / 32)), both template parameters. A row sum is a warp
//   shuffle; column sums are one exchange of per-warp partials through
//   shared memory, four lanes to a column; the total is summed once from
//   the warps' totals. No division by P in any loop.
// - Emissions are never waited for on the critical path. E streams
//   through a ring of FBE_RING = 2 slots in shared memory: column n+2
//   is copied by cp.async (cp_async.cuh) while column n computes, and
//   waited for only at the end of column n+1. Deeper rings (6 slots at
//   P=89, 8 at P=32) were no faster (tools/fbe_times.py; PERF.md). A
//   slot's header carries the column's scalars (u; for K4 also c_fwd
//   and is_last), so they arrive with it. The copies are 16-byte
//   cp.async, issued by all threads over the column's bytes: P^2 is odd
//   at P=89, so a column starts at any 4-byte offset; it is placed in
//   its slot at the same offset modulo 16 bytes, and only its unaligned
//   head and tail (at most 3 floats each) move in 4-byte copies. This
//   keeps E's [B, n, P, P] layout, which the plain versions share, with
//   no padding by the producer; TMA bulk copies would need the padding.
//   Each thread waits for its own copies of the next column before the
//   column's second barrier, which publishes them. K4's alpha_n is read
//   by the cell's owner only: it is loaded into registers a column ahead.
//   Staged in the ring beside E instead (tools/k4_alpha_ring.py, same
//   bits) K4 took 439.4 ms against 411.8 ms at B=1 N=131,072 P=89 on an
//   NVIDIA H100 80GB HBM3 at 700 W, and two columns a slot fit only up
//   to P = 105.
// - Outputs leave in 16-byte stores: a column of alphas (K3) or raw
//   posteriors (K4) is written to a staging column in shared memory in
//   the pass that computes it, and copied out between the two barriers:
//   a quarter of the memory instructions of one 4-byte access per cell.
// - Two block barriers per column. K3 reduces the unnormalized cur,
//   stores alpha_n = cur / s during the next column and folds 1/s into
//   that column's mix (E multiplies the mix after 1/s). K4 knows the
//   total s_n of cur before cur (fbe_total) and reduces the next
//   column's helper g = (cur_n / s_n) * E_n in the pass that computes
//   cur_n. One warp sums the totals and takes 1/s once for the block.
//   Where s <= 0 the state becomes uniform exactly as in the plain
//   versions; padding columns (E = 0) lead there.
// - Sums in a fixed order and no float atomics: a launch repeats its
//   results bit for bit.
// Allocates nothing; launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "cp_async.cuh"
#include "grid.cuh"

#ifndef PREFETCH_L2
#define PREFETCH_L2(p) asm volatile("prefetch.global.L2 [%0];" ::"l"(p))
#endif

#define FB_THREADS 256
#define FB_WARPS (FB_THREADS / 32)
#define FB_MAX_PATHS (FB_THREADS / 2)
#define FBE_RING 2
#define FBE_WARPS 16
#define FULL_MASK 0xffffffffu

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
                   const int* __restrict__ is_last,
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

// ---- K3/K4 ----

// The total s of a backward column's cur, from the total H of the helper
// it mixes: each term of the factored mix sums over the P x P cells to H
// u0, 2 P H u1 and P^2 H u2; at is_last cur is 1 in every cell. Known
// before cur, so the next helper is formed from beta = cur / s before it
// meets the emissions, as in the plain versions. (Folding 1 / s into the
// next column's mix instead multiplies E by the unnormalized cur, which
// underflows on real columns: emissions near 1e-41, totals near 1e-20.)
__device__ __forceinline__ float fbe_total(bool last, float H, float u0, float u1,
                                           float u2, int P) {
    return last ? (float)(P * P) : H * (u0 + (float)(2 * P) * u1 + (float)(P * P) * u2);
}

// A backward column's scalars, so that no cell divides or branches: with
// sc = 2^64 for a total s under 1e-30 (else 1; exact), cur * sc = u0s g +
// u1s (R + C) + hs, beta = (cur * sc) inv, and the raw posterior alpha *
// cur * cf = alpha (cur * sc) cfs. At is_last cur is 1 and sc is 1 (s =
// P^2). Where s <= 0 the helper is 0, cur is 0 and beta uniform: then hs
// is the uniform value, inv 1 and cfs 0.
struct BwdScale {
    float u0s, u1s, hs, inv, cfs;
};

__device__ __forceinline__ BwdScale fbe_bwd_scale(bool last, float H, float u0, float u1,
                                                  float u2, int P, float cf, float uniform) {
    const float s = fbe_total(last, H, u0, u1, u2, P);
    const float sc = s < 1e-30f ? 0x1p64f : 1.f;
    BwdScale k;
    if (s > 0.f) {
        k.u0s = u0 * sc;
        k.u1s = u1 * sc;
        k.hs = u2 * H * sc;
        k.inv = __frcp_rn(s * sc);
        k.cfs = sc > 1.f ? cf * 0x1p-64f : cf;
    } else {
        k.u0s = k.u1s = k.cfs = 0.f;
        k.hs = uniform;
        k.inv = 1.f;
    }
    return k;
}

// K3/K4's dynamic shared memory (FbeSmem holds the offsets into it)
extern __shared__ __align__(16) float fbe_shm[];

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
    return v;   // the same bits in every lane: each step adds the same pair
}

// A [P, P] column in shared memory sits at the same offset modulo 16
// bytes as in global memory, so the aligned middle moves in 16-byte
// pieces; misalign(p) is that offset in floats.
__device__ __forceinline__ int misalign(const float* p) {
    return (int)(((uintptr_t)p >> 2) & 3);
}

// The column's split: `head` floats before the first 16-byte boundary,
// `nv` float4s, then the tail from `tail_lo` on.
struct ColumnSplit {
    int head, nv, tail_lo;
    __device__ ColumnSplit(int mis, int PP) {
        head = min((4 - mis) & 3, PP);
        nv = (PP - head) >> 2;
        tail_lo = head + 4 * nv;
    }
};

// All threads: global column src [PP] into shared buf + misalign(src), async.
__device__ __forceinline__ void fetch_column(float* buf, const float* src, int PP) {
    const int t = threadIdx.x, mis = misalign(src);
    const ColumnSplit cs(mis, PP);
    float* d = buf + mis;
    for (int v = t; v < cs.nv; v += blockDim.x)
        cp_async16(d + cs.head + 4 * v, src + cs.head + 4 * v);
    if (t < cs.head) cp_async4(d + t, src + t);
    if (t < PP - cs.tail_lo) cp_async4(d + cs.tail_lo + t, src + cs.tail_lo + t);
}

// All threads: shared buf + misalign(dst) to global column dst [PP].
__device__ __forceinline__ void store_column(float* dst, const float* buf, int PP) {
    const int t = threadIdx.x, mis = misalign(dst);
    const ColumnSplit cs(mis, PP);
    const float* s = buf + mis;
    for (int v = t; v < cs.nv; v += blockDim.x)
        *(float4*)(dst + cs.head + 4 * v) = *(const float4*)(s + cs.head + 4 * v);
    if (t < cs.head) dst[t] = s[t];
    if (t < PP - cs.tail_lo) dst[cs.tail_lo + t] = s[cs.tail_lo + t];
}

// The cells of one thread: rows w + W*r (r < RW), columns lane + 32*k
// (k < NC), W = FBE_WARPS.
template <int RW, int NC>
struct Cells {
    static constexpr int W = FBE_WARPS;
    int P, w, lane, base, rstride;
    __device__ explicit Cells(int P_)
        : P(P_), w(threadIdx.x >> 5), lane(threadIdx.x & 31) {
        base = w * P + lane;
        rstride = W * P;
    }
    __device__ __forceinline__ bool row_ok(int r) const { return w + W * r < P; }
    __device__ __forceinline__ bool ok(int r, int k) const {
        return w + W * r < P && lane + 32 * k < P;
    }
    __device__ __forceinline__ int at(int r, int k) const {
        return base + r * rstride + 32 * k;
    }
};

// K3/K4's shared memory, in floats (fb_kernels.generic_launch mirrors
// fbe_smem): a ring of FBE_RING slots, each a header of FBE_HEADER
// floats (the column's scalars) and a column; a staging column for the
// outputs; the reduction scratch.
#define FBE_HEADER 8

__host__ __device__ __forceinline__ int fbe_column_floats(int P) {
    return (P * P + 3 + 3) & ~3;      // a column at any misalignment, in float4s
}

// pitch of the column partials: >= P and 8 mod 32, so the four lanes
// that sum one column's partials read four banks apart
__host__ __device__ __forceinline__ int fbe_part_pitch(int P) {
    return P + ((8 - P) % 32 + 32) % 32;
}

// Offsets (in floats, from the dynamic shared memory) rather than
// pointers: each costs one register instead of two.
struct FbeSmem {
    int stage;        // [column] the column being written out
    int colpart;      // [FBE_WARPS, part pitch] each warp's column sums over its rows
    int col;          // [P] column sums
    int wsum;         // [32] each warp's total of the reduced state
    int tot;          // [2] total of the reduced state, 1 / it
    int slot_pitch, part_pitch;   // the ring starts at 0
};

__device__ __forceinline__ FbeSmem fbe_layout(int P) {
    FbeSmem s;
    s.slot_pitch = FBE_HEADER + fbe_column_floats(P);
    s.part_pitch = fbe_part_pitch(P);
    s.stage = FBE_RING * s.slot_pitch;
    s.colpart = s.stage + fbe_column_floats(P);
    s.col = s.colpart + FBE_WARPS * s.part_pitch;
    s.wsum = s.col + P;
    s.tot = s.wsum + 32;
    return s;
}

static size_t fbe_smem(int P) {
    return sizeof(float) * ((size_t)FBE_RING * (FBE_HEADER + fbe_column_floats(P))
                            + fbe_column_floats(P) + (size_t)FBE_WARPS * fbe_part_pitch(P)
                            + P + 34);
}

// First half of a reduction, no barrier: the row sums of v into R (every
// lane of the warp gets them), the warp's column partials and its total
// into shared memory.
template <int RW, int NC>
__device__ __forceinline__ void reduce_warp(const float (&v)[RW][NC], float (&R)[RW],
                                            const Cells<RW, NC>& c, const FbeSmem& s) {
    float tot = 0.f;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
        float x = 0.f;
        if (c.row_ok(r)) {   // the same for the whole warp
#pragma unroll
            for (int k = 0; k < NC; ++k) x += v[r][k];
            x = warp_sum(x);
        }
        R[r] = x;
        tot += x;
    }
#pragma unroll
    for (int k = 0; k < NC; ++k) {
        const int q = c.lane + 32 * k;
        float x = 0.f;
#pragma unroll
        for (int r = 0; r < RW; ++r) x += v[r][k];
        if (q < c.P) fbe_shm[s.colpart + c.w * s.part_pitch + q] = x;
    }
    if (c.lane == 0) fbe_shm[s.wsum + c.w] = tot;
}

// Second half, after a barrier. Column sums: four lanes per column, each
// over every fourth warp, then two shuffles (threads [0, 4P)). The last
// warp sums the warps' totals: tot[0] the state's, tot[1] 1 / it (1 where
// it is not positive). Each sum in a fixed order.
__device__ __forceinline__ void reduce_block(const FbeSmem& s, int P) {
    constexpr int W = FBE_WARPS;
    const int t = threadIdx.x;
    if (t < 4 * P) {
        const int q = t >> 2, j = t & 3;
        const unsigned group = 0xfu << (t & 28);
        float x = 0.f;
        for (int w = j; w < W; w += 4) x += fbe_shm[s.colpart + w * s.part_pitch + q];
        x += __shfl_xor_sync(group, x, 1);
        x += __shfl_xor_sync(group, x, 2);
        if (j == 0) fbe_shm[s.col + q] = x;
    }
    if ((t >> 5) == W - 1) {
        const int lane = t & 31;
        const float h = warp_sum(lane < W ? fbe_shm[s.wsum + lane] : 0.f);
        if (lane == 0) {
            fbe_shm[s.tot + 0] = h;
            fbe_shm[s.tot + 1] = h > 0.f ? 1.f / h : 1.f;
        }
    }
}

template <int RW, int NC>
__global__ void __launch_bounds__(32 * FBE_WARPS, 1)
fbe_forward_kernel(const float* __restrict__ E, const float* __restrict__ u,
                   const float* __restrict__ alpha0, float* __restrict__ alphas,
                   float* __restrict__ c_fwd, int N, int P) {
    constexpr int D = FBE_RING;
    const Cells<RW, NC> c(P);
    const int PP = P * P, b = blockIdx.x, t = threadIdx.x, last_t = blockDim.x - 1;
    const FbeSmem s = fbe_layout(P);
    const float uniform = 1.0f / (float)PP;
    const float* e_b = E + (size_t)b * N * PP;
    const float* u_b = u + (size_t)b * N * 3;
    float* alpha_b = alphas + (size_t)b * N * PP;

    // column m into its slot: E, and u in the header
    auto fetch = [&](int m, int slot) {
        float* hdr = fbe_shm + (size_t)slot * s.slot_pitch;
        fetch_column(hdr + FBE_HEADER, e_b + (size_t)m * PP, PP);
        if (t == last_t)
            for (int j = 0; j < 3; ++j) cp_async4(hdr + j, u_b + 3 * m + j);
    };
    for (int j = 0; j < D; ++j) {                         // columns 0 .. D-1
        if (j < N) fetch(j, j);
        cp_async_commit();
    }
    // a: the carry, unnormalized (alpha_{n-1} = a * inv); R its row sums,
    // s.col its column sums, H its total
    float a[RW][NC], R[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int k = 0; k < NC; ++k)
            a[r][k] = c.ok(r, k) ? alpha0[(size_t)b * PP + c.at(r, k)] : 0.f;
    reduce_warp(a, R, c, s);
    cp_async_wait<D - 1>();                               // column 0
    __syncthreads();
    reduce_block(s, P);
    __syncthreads();
    float H = fbe_shm[s.tot + 0], inv = 1.f;     // the entry carry mixes as it is
    bool uni = false;                  // the carry is the uniform state
    int slot = 0;

    for (int n = 0; n < N; ++n) {
        const float* hdr = fbe_shm + (size_t)slot * s.slot_pitch;
        const float* e = hdr + FBE_HEADER + misalign(e_b + (size_t)n * PP);
        const float u0 = hdr[0], u1 = hdr[1], u2 = hdr[2];
        float* st = fbe_shm + s.stage + misalign(alpha_b + (size_t)(n > 0 ? n - 1 : 0) * PP);
        const float hh = u2 * H;
        float C[NC];
#pragma unroll
        for (int k = 0; k < NC; ++k) {
            const int q = c.lane + 32 * k;
            C[k] = uni ? (float)P * uniform : (q < P ? fbe_shm[s.col + q] : 0.f);
        }
#pragma unroll
        for (int r = 0; r < RW; ++r) {
            const int row = c.at(r, 0);                   // cells row + 32k
#pragma unroll
            for (int k = 0; k < NC; ++k) {
                const bool ok = c.ok(r, k);
                const float x = a[r][k];
                if (ok) st[row + 32 * k] = x * inv;      // alpha_{n-1}
                const float ev = ok ? e[row + 32 * k] : 0.f;
                a[r][k] = inv * (u0 * x + u1 * (R[r] + C[k]) + hh) * ev;
            }
        }
        reduce_warp(a, R, c, s);
        __syncthreads();
        // every thread is done with the slot: column n + D takes it
        if (n + D < N) fetch(n + D, slot);
        cp_async_commit();
        cp_async_wait<D - 1>();                           // column n + 1
        slot = slot + 1 == D ? 0 : slot + 1;
        if (n > 0) store_column(alpha_b + (size_t)(n - 1) * PP, fbe_shm + s.stage, PP);
        reduce_block(s, P);
        __syncthreads();
        const float tot = fbe_shm[s.tot + 0];
        if (t == 0) c_fwd[(size_t)b * N + n] = tot > 0.f ? tot : 1.f;
        uni = !(tot > 0.f);
        inv = fbe_shm[s.tot + 1];
        H = tot;
        if (uni) {
#pragma unroll
            for (int r = 0; r < RW; ++r) {
                R[r] = (float)P * uniform;
#pragma unroll
                for (int k = 0; k < NC; ++k) a[r][k] = c.ok(r, k) ? uniform : 0.f;
            }
            H = 1.f;
        }
    }
    float* last_col = alpha_b + (size_t)(N - 1) * PP;
    float* st = fbe_shm + s.stage + misalign(last_col);
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int k = 0; k < NC; ++k)
            if (c.ok(r, k)) st[c.at(r, k)] = a[r][k] * inv;
    __syncthreads();
    store_column(last_col, fbe_shm + s.stage, PP);
    cp_async_wait<0>();
}

template <int RW, int NC>
__global__ void __launch_bounds__(32 * FBE_WARPS, 1)
fbe_backward_kernel(const float* __restrict__ alphas, const float* __restrict__ c_fwd,
                    const float* __restrict__ E, const float* __restrict__ u,
                    const float* __restrict__ e_after, const float* __restrict__ u_after,
                    const int* __restrict__ is_last,
                    const float* __restrict__ beta0, float* __restrict__ posts,
                    float* __restrict__ beta_out, int N, int P) {
    constexpr int D = FBE_RING;
    const Cells<RW, NC> c(P);
    const int PP = P * P, b = blockIdx.x, t = threadIdx.x, last_t = blockDim.x - 1;
    const FbeSmem s = fbe_layout(P);
    const float uniform = 1.0f / (float)PP;
    const float* e_b = E + (size_t)b * N * PP;
    const float* u_b = u + (size_t)b * N * 3;
    const float* alpha_b = alphas + (size_t)b * N * PP;
    const float* cf_b = c_fwd + (size_t)b * N;
    const int* last_b = is_last + (size_t)b * N;
    float* post_b = posts + (size_t)b * N * PP;

    // column m into its slot: E, and u, c_fwd, is_last in the header
    auto fetch = [&](int m, int slot) {
        float* hdr = fbe_shm + (size_t)slot * s.slot_pitch;
        fetch_column(hdr + FBE_HEADER, e_b + (size_t)m * PP, PP);
        if (t == last_t) {
            for (int j = 0; j < 3; ++j) cp_async4(hdr + j, u_b + 3 * m + j);
            cp_async4(hdr + 3, cf_b + m);
            cp_async4(hdr + 4, last_b + m);
        }
    };
    for (int j = 0; j < D; ++j) {                         // columns N-1 .. N-D
        if (j < N) fetch(N - 1 - j, j);
        cp_async_commit();
    }
    // g: the helper of the column ahead (its beta times its E); R its row
    // sums, s.col its column sums, H its total. a: alpha of the column
    // being computed, loaded a column ahead.
    float g[RW][NC], a[RW][NC], R[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int k = 0; k < NC; ++k) {
            const bool ok = c.ok(r, k);
            const int i = c.at(r, k);
            g[r][k] = ok ? beta0[(size_t)b * PP + i] * e_after[(size_t)b * PP + i] : 0.f;
            a[r][k] = ok ? alpha_b[(size_t)(N - 1) * PP + i] : 0.f;
        }
    reduce_warp(g, R, c, s);
    cp_async_wait<D - 1>();                               // column N-1
    __syncthreads();
    reduce_block(s, P);
    __syncthreads();
    float H = fbe_shm[s.tot + 0];                       // beta0 is normalized
    float u0 = u_after[(size_t)b * 3], u1 = u_after[(size_t)b * 3 + 1],
          u2 = u_after[(size_t)b * 3 + 2];
    BwdScale k0;                       // column 0's, for beta_out
    int slot = 0;

    for (int n = N - 1; n >= 0; --n) {
        const float* hdr = fbe_shm + (size_t)slot * s.slot_pitch;
        const float* e = hdr + FBE_HEADER + misalign(e_b + (size_t)n * PP);
        const bool last = ((const int*)hdr)[4] != 0;
        // the total of cur, known before it (fbe_total), and beta = cur / s
        const BwdScale ks = fbe_bwd_scale(last, H, u0, u1, u2, P, hdr[3], uniform);
        k0 = ks;
        const float* a_next = alpha_b + (size_t)(n > 0 ? n - 1 : 0) * PP;
        float* st = fbe_shm + s.stage + misalign(post_b + (size_t)n * PP);
        // the column sums, read once into registers; at NC = 4, where four
        // more registers would spill, each cell reads its own from shared
        // memory instead
        auto col_sum = [&](int k) {
            const int q = c.lane + 32 * k;
            return q < P ? fbe_shm[s.col + q] : 0.f;
        };
        float C[NC];
#pragma unroll
        for (int k = 0; k < NC; ++k) C[k] = NC < 4 ? col_sum(k) : 0.f;
#pragma unroll
        for (int r = 0; r < RW; ++r) {
            const int row = c.at(r, 0);                   // cells row + 32k
            const float* a_row = a_next + row;
#pragma unroll
            for (int k = 0; k < NC; ++k) {
                const bool ok = c.ok(r, k);
                const float ck = NC < 4 ? C[k] : col_sum(k);
                // is_last re-seeds the sweep with ones (src/hmm.cpp:321-324)
                // cur * sc (BwdScale)
                float cur = last ? 1.f : ks.u0s * g[r][k] + ks.u1s * (R[r] + ck) + ks.hs;
                cur = ok ? cur : 0.f;
                // the raw posterior takes the un-normalized cur
                if (ok) st[row + 32 * k] = a[r][k] * cur * ks.cfs;
                // at column 0, a keeps cur * sc for beta_out
                a[r][k] = n > 0 ? (ok ? a_row[32 * k] : 0.f) : cur;
                g[r][k] = cur * ks.inv * (ok ? e[row + 32 * k] : 0.f);
            }
        }
        reduce_warp(g, R, c, s);
        // column n's u is its predecessor's successor mix (read after the
        // cells, so that it holds no register there, and before the
        // barrier, after which the slot is refilled)
        const float nu0 = hdr[0], nu1 = hdr[1], nu2 = hdr[2];
        __syncthreads();
        // every thread is done with the slot: column n - D takes it
        if (n - D >= 0) fetch(n - D, slot);
        cp_async_commit();
        cp_async_wait<D - 1>();                           // column n - 1
        slot = slot + 1 == D ? 0 : slot + 1;
        store_column(post_b + (size_t)n * PP, fbe_shm + s.stage, PP);
        reduce_block(s, P);
        __syncthreads();
        H = fbe_shm[s.tot + 0];
        u0 = nu0;
        u1 = nu1;
        u2 = nu2;
    }
    // the normalized beta after the chunk's first column
    float* bo = beta_out + (size_t)b * PP;
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int k = 0; k < NC; ++k)
            if (c.ok(r, k)) bo[c.at(r, k)] = a[r][k] * k0.inv;
    cp_async_wait<0>();
}

// ---- K3/K4's cluster tier: 128 < P <= the widest band a cluster holds ----
//
// Past 128 paths one CTA's registers no longer hold the [P, P] state, so a
// chain runs on a thread-block cluster of K CTAs (fbe_cluster_layout: K =
// FBE_CLUSTER_RANKS, halved while the chains' CTAs outnumber the SMs the
// card holds in clusters at once, and never below the fewest whose band
// fits, up to FBE_MAX_RANKS), each on its own SM with its share of the
// state in registers:
//
// - Rank k owns the rows [k P / K, (k + 1) P / K) of the state, a band of
//   floor(P / K) or ceil(P / K) rows. Warp w of its W owns the band's rows
//   w + W r (r < RW) and lane l the columns l + 32 c (c < NCM), as in the
//   register tiers, so a thread owns the same cells in every column. K3's
//   carry and K4's helper g never leave the registers, and no global
//   scratch is needed. At most FBE_CLUSTER_CELLS cells a thread, so 64
//   registers a thread hold them at 1024 threads (K4 also holds alpha a
//   column ahead there).
// - Row sums stay in the band: a warp shuffle. Column sums and the total
//   need every band: each warp writes its column partials and its total
//   to a stage in shared memory; after a block barrier four threads a
//   group of four columns sum the warps' partials in a fixed order and
//   push the band's message (P column partials, the band total, padding
//   to float4s) into every rank's shared memory by st.async, into slots
//   of the column's parity, completing the bytes on that rank's mbarrier
//   of the parity (csrc/cluster.cuh, as S1's cluster sweep merges). Each
//   rank then waits once on its own mbarrier, with no cluster barrier,
//   and sums the K messages in rank order, so every rank holds the same
//   bits of the column sums and the total, and a launch repeats its bits.
//   A rank pushes into a parity's slots again two columns later, after
//   the next column's wait, which needs every rank's next push, issued
//   after that rank has read this column's slots.
// - The E band of a column is contiguous (rows are stored in order): it
//   is copied FBE_CLUSTER_RING columns ahead into a shared-memory ring by
//   16-byte cp.async, each column at its global offset modulo 16 bytes as
//   in the register tiers, the column's scalars in the slot's header. K4
//   loads its alpha band into registers a column ahead (a ring slot for
//   it too would not fit beside E at P=465; in the register tiers the
//   register load was the faster, tools/k4_alpha_ring.py).
// - K3 writes alpha_{n-1} once, already normalized, from registers during
//   column n, and rank 0 writes c_fwd; K4 writes the raw posteriors once,
//   and each rank its band of beta_out.
// - The arithmetic is the register tiers': the factored mix; K3 folds
//   1 / s into the next column's mix; K4 forms its helper from beta = cur
//   / s with s known before cur (fbe_total, fbe_bwd_scale: fault F4's
//   repair); the uniform state where s <= 0; is_last re-seeds with ones.
// - Two block barriers and one mbarrier wait a column, against the
//   one-CTA tier this one replaced: two barriers a tile of 256 columns
//   on one SM and its state read back from global memory.
// - Measured (tools/fbe_times.py, an NVIDIA H100 80GB HBM3 at 700 W): at
//   genotype -a 200's chunk shape (B=11 N=4,941 P=200, clusters of 8)
//   2.83 / 3.31 us a column, 13.1x / 10.4x the one-CTA tier; at B=2
//   N=512 P=465 (clusters of 16) 7.40 / 8.08 us, 22x / 19x. The merge is
//   a third of a column at P=200 and half of one at P=465 (--ablate: 1.0
//   and 3.8 us of K3's); a merge in two hops (a reduce-scatter to each
//   float4 group's owner, then an all-gather of the sums: K times fewer
//   bytes pushed, two waits) took 3.19 / 3.64 us at P=200 and 6.31 /
//   11.39 at P=465, so the single push stays.

// clusters of 16 CTAs where the card holds them at once: at B=2 N=2048
// P=200 K3/K4 took 2.672 / 2.946 us a column against 8 CTAs' 2.827 /
// 3.339; at B=11 (176 CTAs, some SMs two) 3.534 / 4.021 against 8 CTAs'
// 2.834 / 3.306, and at B=22 4 CTAs beat 8 in two waves (3.688 / 6.246
// against 5.720 / 6.711): tools/fbe_times.py --ranks, an NVIDIA H100
// 80GB HBM3 at 700 W
#ifndef FBE_CLUSTER_RANKS
#define FBE_CLUSTER_RANKS 16
#endif
#define FBE_MAX_RANKS 16
#define FBE_CLUSTER_RING 2
#define FBE_CLUSTER_CELLS 16
#define FBE_CLUSTER_WARPS 32
// the CTAs of the clusters an H100 holds at once where a CTA takes its SM
// (17-32 warps of 64 registers): cudaOccupancyMaxActiveClusters reads 15
// clusters of 8 CTAs and 7 of 16, so 112 in clusters of 16 (at 13 warps
// two CTAs share an SM: 14 of 16; tools/fbe_times.py --wide prints it)
#ifndef FBE_SMS
#define FBE_SMS 112
#endif
static_assert((FBE_CLUSTER_RANKS & (FBE_CLUSTER_RANKS - 1)) == 0 && FBE_CLUSTER_RANKS >= 1 &&
                  FBE_CLUSTER_RANKS <= FBE_MAX_RANKS,
              "FBE_CLUSTER_RANKS is a power of two up to FBE_MAX_RANKS");
// one H100 block's dynamic shared memory
#define FBE_SMEM_BYTES 232448

// A band of `floats` floats at any misalignment, in float4s
__host__ __device__ __forceinline__ int fbe_span_floats(int floats) {
    return (floats + 3 + 3) & ~3;
}

// A rank's message: P column partials, the band total at P, padding to
// float4s.
__host__ __device__ __forceinline__ int fbc_msg(int P) { return (P + 1 + 3) & ~3; }

// The cluster tier's layout at P paths in clusters of `ranks`: the most
// rows a band has, rows a warp (rw), column slots a lane (ncm: 8 up to
// 256 paths, else 16) and warps a CTA.
struct FbcLayout {
    int ranks, rows, rw, ncm, warps;
};

// Shared memory of the layout (fb_kernels.generic_launch mirrors it): two
// mbarriers; the messages, [2 parities][ranks][msg]; their sums [msg];
// the warps' stage [warps][msg]; the E ring of FBE_CLUSTER_RING slots of
// a header and a band.
__host__ __device__ __forceinline__ size_t fbc_smem(int P, const FbcLayout& l) {
    return 16 + sizeof(float) * ((size_t)(2 * l.ranks + 1 + l.warps) * fbc_msg(P)
                                 + (size_t)FBE_CLUSTER_RING
                                       * (FBE_HEADER + fbe_span_floats(l.rows * P)));
}

// Whether a cluster of `ranks` CTAs holds P paths: a band in at most
// FBE_CLUSTER_CELLS cells a thread of at most FBE_CLUSTER_WARPS warps,
// and its shared memory in one block's.
__host__ __device__ __forceinline__ bool fbc_layout(int P, int ranks, FbcLayout& l) {
    l.ranks = ranks;
    l.rows = (P + ranks - 1) / ranks;
    l.ncm = P <= 256 ? 8 : 16;
    l.rw = (l.rows + FBE_CLUSTER_WARPS - 1) / FBE_CLUSTER_WARPS;
    l.warps = (l.rows + l.rw - 1) / l.rw;
    return ranks >= 1 && ranks <= FBE_MAX_RANKS && 32 * l.ncm >= P
        && l.rw * l.ncm <= FBE_CLUSTER_CELLS && fbc_smem(P, l) <= FBE_SMEM_BYTES;
}

// The rule, past FB_MAX_PATHS: clusters of FBE_CLUSTER_RANKS CTAs, halved
// while the B chains' CTAs outnumber the FBE_SMS the card holds in
// clusters at once, but never below the fewest (a power of two) whose
// band fits; false where not even FBE_MAX_RANKS CTAs hold P (the grid
// tier takes it), and in a build with FBE_GRID_ONLY (the grid tier past
// 128 paths, which tools/fbe_times.py --wide times beside this tier).
static bool fbe_cluster_layout(int P, int B, FbcLayout& l) {
#ifdef FBE_GRID_ONLY
    return false;
#endif
    if (P <= FB_MAX_PATHS) return false;
    int least = 1;
    while (least <= FBE_MAX_RANKS && !fbc_layout(P, least, l)) least *= 2;
    if (least > FBE_MAX_RANKS) return false;
    int k = FBE_CLUSTER_RANKS > least ? FBE_CLUSTER_RANKS : least;
    while (k > least && (long)B * k > FBE_SMS) k /= 2;
    return fbc_layout(P, k, l);
}

// Offsets (in floats, from fbe_shm) of the cluster tier's shared memory;
// the two mbarriers take floats 0-3.
struct FbcSmem {
    int parts, col, stage, ring, msg, slot_pitch;
};

__device__ __forceinline__ FbcSmem fbc_layout_smem(int P, int ranks, int rows, int warps) {
    FbcSmem s;
    s.msg = fbc_msg(P);
    s.parts = 4;
    s.col = s.parts + 2 * ranks * s.msg;
    s.stage = s.col + s.msg;
    s.ring = s.stage + warps * s.msg;
    s.slot_pitch = FBE_HEADER + fbe_span_floats(rows * P);
    return s;
}

// The cells of one thread in its rank's band: band rows w + W r (r < RW),
// columns lane + 32 c (c < NCM); `rows` is this band's.
template <int RW, int NCM>
struct BandCells {
    int P, W, w, lane, rows;
    __device__ BandCells(int P_, int rows_)
        : P(P_), W(blockDim.x >> 5), w(threadIdx.x >> 5), lane(threadIdx.x & 31),
          rows(rows_) {}
    __device__ __forceinline__ bool row_ok(int r) const { return w + W * r < rows; }
    __device__ __forceinline__ bool ok(int r, int c) const {
        return row_ok(r) && lane + 32 * c < P;
    }
    // the cell's offset in the band (and from the band's first cell in a column)
    __device__ __forceinline__ int at(int r, int c) const {
        return (w + W * r) * P + lane + 32 * c;
    }
};

// The band's sums of v, no barrier: its row sums into R (every lane of
// the warp gets them), the warp's column partials and its total (at P;
// zeros up to the message's end) into its row of the stage.
template <int RW, int NCM>
__device__ __forceinline__ void fbc_reduce_warp(const float (&v)[RW][NCM], float (&R)[RW],
                                                const BandCells<RW, NCM>& c, const FbcSmem& s) {
    float* stage = fbe_shm + s.stage + c.w * s.msg;
    float tot = 0.f;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
        float x = 0.f;
        if (c.row_ok(r)) {   // the same for the whole warp
#pragma unroll
            for (int k = 0; k < NCM; ++k) x += v[r][k];
            x = warp_sum(x);
        }
        R[r] = x;
        tot += x;
    }
#pragma unroll
    for (int k = 0; k < NCM; ++k) {
        const int q = c.lane + 32 * k;
        float x = 0.f;
#pragma unroll
        for (int r = 0; r < RW; ++r) x += v[r][k];
        if (q < c.P) stage[q] = x;
    }
    if (c.lane < s.msg - c.P) stage[c.P + c.lane] = c.lane == 0 ? tot : 0.f;
}

// After a barrier that publishes the stage: the band's message, summed
// over the warps in a fixed order (four threads a float4 group, each over
// every fourth warp, then two shuffles), pushed into slot `rank` of
// parity `parity` in every rank's shared memory (st.async, completing 16
// bytes a push on that rank's mbarrier of the parity). Thread 0 arms this
// rank's mbarrier with the bytes of the K messages it will receive.
__device__ __forceinline__ void fbc_push(const FbcSmem& s, unsigned rank, int ranks,
                                         int parity) {
    const int groups = s.msg >> 2, warps = blockDim.x >> 5;
    const float4* stage = reinterpret_cast<const float4*>(fbe_shm + s.stage);
    uint4* slot = reinterpret_cast<uint4*>(fbe_shm + s.parts)
                  + (size_t)(parity * ranks + (int)rank) * groups;
    uint64_t* bar = reinterpret_cast<uint64_t*>(fbe_shm) + parity;
    if (threadIdx.x == 0) mbar_expect(bar, 16u * ranks * groups);
    for (int t = threadIdx.x; t < 4 * groups; t += blockDim.x) {
        const int g = t >> 2, j = t & 3;
        const unsigned quad = 0xfu << (threadIdx.x & 28);
        float4 x = {0.f, 0.f, 0.f, 0.f};
        for (int w = j; w < warps; w += 4) {
            const float4 v = stage[w * groups + g];
            x.x += v.x;
            x.y += v.y;
            x.z += v.z;
            x.w += v.w;
        }
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
            x.x += __shfl_xor_sync(quad, x.x, o);
            x.y += __shfl_xor_sync(quad, x.y, o);
            x.z += __shfl_xor_sync(quad, x.z, o);
            x.w += __shfl_xor_sync(quad, x.w, o);
        }
        const uint4 bits = make_uint4(__float_as_uint(x.x), __float_as_uint(x.y),
                                      __float_as_uint(x.z), __float_as_uint(x.w));
        for (int k = j; k < ranks; k += 4) cluster_push4(slot + g, (unsigned)k, bits, bar);
    }
}

// Waits for the K messages of parity `parity` on this rank's own mbarrier
// and sums them in rank order into s.col (column sums, the total at P).
__device__ __forceinline__ void fbc_merge(const FbcSmem& s, int P, int ranks, int parity,
                                          unsigned& phases) {
    uint64_t* bar = reinterpret_cast<uint64_t*>(fbe_shm) + parity;
    mbar_wait(bar, (phases >> parity) & 1);
    phases ^= 1u << parity;
    const float* part = fbe_shm + s.parts + (size_t)parity * ranks * s.msg;
    for (int q = threadIdx.x; q <= P; q += blockDim.x) {
        float x = 0.f;
        for (int k = 0; k < ranks; ++k) x += part[k * s.msg + q];
        fbe_shm[s.col + q] = x;
    }
}

// Thread 0 sets up the two mbarriers; no rank pushes before every rank's
// are set up.
__device__ __forceinline__ void fbc_start() {
    if (threadIdx.x == 0) {
        mbar_init(reinterpret_cast<uint64_t*>(fbe_shm));
        mbar_init(reinterpret_cast<uint64_t*>(fbe_shm) + 1);
    }
    cluster_arrive();
    cluster_wait();
}

// One step of the chain after the cells: the band's sums published, the
// slot just read handed to `refill`, the cluster's message of the step's
// parity pushed and merged, the ring's next column waited for, all
// published by the second barrier.
template <int RW, int NCM, typename F>
__device__ __forceinline__ void fbc_step(const float (&v)[RW][NCM], float (&R)[RW],
                                         const BandCells<RW, NCM>& c, const FbcSmem& s,
                                         unsigned rank, int ranks, int step, unsigned& phases,
                                         F&& refill) {
    fbc_reduce_warp(v, R, c, s);
    __syncthreads();
    refill();
    cp_async_commit();
    fbc_push(s, rank, ranks, step & 1);
    fbc_merge(s, c.P, ranks, step & 1, phases);
    cp_async_wait<FBE_CLUSTER_RING - 1>();
    __syncthreads();
}

template <int RW, int NCM>
__global__ void __launch_bounds__(32 * FBE_CLUSTER_WARPS, 1)
fbe_forward_cluster_kernel(const float* __restrict__ E, const float* __restrict__ u,
                           const float* __restrict__ alpha0, float* __restrict__ alphas,
                           float* __restrict__ c_fwd, int N, int P, int ranks) {
    constexpr int D = FBE_CLUSTER_RING;
    const unsigned rank = cluster_rank();
    const int b = blockIdx.x / ranks, t = threadIdx.x, last_t = blockDim.x - 1;
    const int i0 = (int)rank * P / ranks, rows = ((int)rank + 1) * P / ranks - i0;
    const BandCells<RW, NCM> c(P, rows);
    const FbcSmem s = fbc_layout_smem(P, ranks, (P + ranks - 1) / ranks, blockDim.x >> 5);
    const size_t PP = (size_t)P * P, band = (size_t)i0 * P;
    const int L = rows * P;
    const float uniform = 1.0f / (float)PP, row_uniform = (float)P * uniform;
    const float* e_b = E + (size_t)b * N * PP + band;
    const float* u_b = u + (size_t)b * N * 3;
    float* alpha_b = alphas + (size_t)b * N * PP + band;

    // column m's band into its slot, u in the header
    auto fetch = [&](int m, int slot) {
        float* hdr = fbe_shm + s.ring + slot * s.slot_pitch;
        fetch_column(hdr + FBE_HEADER, e_b + (size_t)m * PP, L);
        if (t == last_t)
            for (int j = 0; j < 3; ++j) cp_async4(hdr + j, u_b + 3 * m + j);
    };
    for (int j = 0; j < D; ++j) {                         // columns 0 .. D-1
        if (j < N) fetch(j, j);
        cp_async_commit();
    }
    fbc_start();
    unsigned phases = 0;
    // a: the carry, unnormalized (alpha_{n-1} = a * inv); R its row sums,
    // s.col its column sums, H its total
    float a[RW][NCM], R[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int k = 0; k < NCM; ++k)
            a[r][k] = c.ok(r, k) ? alpha0[(size_t)b * PP + band + c.at(r, k)] : 0.f;
    // step 0: the entry carry's sums (it mixes as it is); column 0 arrives
    fbc_step(a, R, c, s, rank, ranks, 0, phases, [] {});
    float H = fbe_shm[s.col + P], inv = 1.f;
    bool uni = false;                  // the carry is the uniform state
    int slot = 0;

    for (int n = 0; n < N; ++n) {
        const float* hdr = fbe_shm + s.ring + slot * s.slot_pitch;
        const float* e = hdr + FBE_HEADER + misalign(e_b + (size_t)n * PP);
        const float u0 = hdr[0], u1 = hdr[1], hh = hdr[2] * H;
        float* prev = alpha_b + (size_t)(n > 0 ? n - 1 : 0) * PP;
#pragma unroll
        for (int k = 0; k < NCM; ++k) {
            const int q = c.lane + 32 * k;
            const float ck = uni ? row_uniform : (q < P ? fbe_shm[s.col + q] : 0.f);
#pragma unroll
            for (int r = 0; r < RW; ++r) {
                const bool ok = c.ok(r, k);
                const int i = c.at(r, k);
                const float x = a[r][k];
                if (n > 0 && ok) prev[i] = x * inv;      // alpha_{n-1}
                const float ev = ok ? e[i] : 0.f;
                a[r][k] = inv * (u0 * x + u1 * (R[r] + ck) + hh) * ev;
            }
        }
        // every thread is done with the slot once the stage is published:
        // column n + D takes it
        fbc_step(a, R, c, s, rank, ranks, n + 1, phases, [&] {
            if (n + D < N) fetch(n + D, slot);
        });
        slot = slot + 1 == D ? 0 : slot + 1;
        const float tot = fbe_shm[s.col + P];
        if (rank == 0 && t == 0) c_fwd[(size_t)b * N + n] = tot > 0.f ? tot : 1.f;
        uni = !(tot > 0.f);
        inv = uni ? 1.f : 1.f / tot;
        H = uni ? 1.f : tot;
        if (uni) {
#pragma unroll
            for (int r = 0; r < RW; ++r) {
                R[r] = row_uniform;
#pragma unroll
                for (int k = 0; k < NCM; ++k) a[r][k] = c.ok(r, k) ? uniform : 0.f;
            }
        }
    }
    float* last_col = alpha_b + (size_t)(N - 1) * PP;
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int k = 0; k < NCM; ++k)
            if (c.ok(r, k)) last_col[c.at(r, k)] = a[r][k] * inv;
    cp_async_wait<0>();
    // no rank leaves while another may still push into it
    cluster_arrive();
    cluster_wait();
}

template <int RW, int NCM>
__global__ void __launch_bounds__(32 * FBE_CLUSTER_WARPS, 1)
fbe_backward_cluster_kernel(const float* __restrict__ alphas, const float* __restrict__ c_fwd,
                            const float* __restrict__ E, const float* __restrict__ u,
                            const float* __restrict__ e_after,
                            const float* __restrict__ u_after, const int* __restrict__ is_last,
                            const float* __restrict__ beta0, float* __restrict__ posts,
                            float* __restrict__ beta_out, int N, int P, int ranks) {
    constexpr int D = FBE_CLUSTER_RING;
    const unsigned rank = cluster_rank();
    const int b = blockIdx.x / ranks, t = threadIdx.x, last_t = blockDim.x - 1;
    const int i0 = (int)rank * P / ranks, rows = ((int)rank + 1) * P / ranks - i0;
    const BandCells<RW, NCM> c(P, rows);
    const FbcSmem s = fbc_layout_smem(P, ranks, (P + ranks - 1) / ranks, blockDim.x >> 5);
    const size_t PP = (size_t)P * P, band = (size_t)i0 * P;
    const int L = rows * P;
    const float uniform = 1.0f / (float)PP;
    const float* e_b = E + (size_t)b * N * PP + band;
    const float* u_b = u + (size_t)b * N * 3;
    const float* alpha_b = alphas + (size_t)b * N * PP + band;
    const float* cf_b = c_fwd + (size_t)b * N;
    const int* last_b = is_last + (size_t)b * N;
    float* post_b = posts + (size_t)b * N * PP + band;

    // column m's band into its slot; u, c_fwd, is_last in the header
    auto fetch = [&](int m, int slot) {
        float* hdr = fbe_shm + s.ring + slot * s.slot_pitch;
        fetch_column(hdr + FBE_HEADER, e_b + (size_t)m * PP, L);
        if (t == last_t) {
            for (int j = 0; j < 3; ++j) cp_async4(hdr + j, u_b + 3 * m + j);
            cp_async4(hdr + 3, cf_b + m);
            cp_async4(hdr + 4, last_b + m);
        }
    };
    for (int j = 0; j < D; ++j) {                         // columns N-1 .. N-D
        if (j < N) fetch(N - 1 - j, j);
        cp_async_commit();
    }
    fbc_start();
    unsigned phases = 0;
    // g: the helper of the column ahead (its beta times its E); R its row
    // sums, s.col its column sums, H its total. a: alpha of the column
    // being computed, loaded a column ahead.
    float g[RW][NCM], a[RW][NCM], R[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int k = 0; k < NCM; ++k) {
            const bool ok = c.ok(r, k);
            const size_t i = (size_t)b * PP + band + c.at(r, k);
            g[r][k] = ok ? beta0[i] * e_after[i] : 0.f;
            a[r][k] = ok ? alpha_b[(size_t)(N - 1) * PP + c.at(r, k)] : 0.f;
        }
    // step 0: the helper of the column after the chunk; column N-1 arrives
    fbc_step(g, R, c, s, rank, ranks, 0, phases, [] {});
    float H = fbe_shm[s.col + P];                       // beta0 is normalized
    float u0 = u_after[(size_t)b * 3], u1 = u_after[(size_t)b * 3 + 1],
          u2 = u_after[(size_t)b * 3 + 2];
    BwdScale k0;                       // column 0's, for beta_out
    int slot = 0;

    for (int n = N - 1; n >= 0; --n) {
        const float* hdr = fbe_shm + s.ring + slot * s.slot_pitch;
        const float* e = hdr + FBE_HEADER + misalign(e_b + (size_t)n * PP);
        const bool last = ((const int*)hdr)[4] != 0;
        // the total of cur, known before it (fbe_total), and beta = cur / s
        const BwdScale ks = fbe_bwd_scale(last, H, u0, u1, u2, P, hdr[3], uniform);
        k0 = ks;
        const float* a_next = alpha_b + (size_t)(n > 0 ? n - 1 : 0) * PP;
        float* post = post_b + (size_t)n * PP;
#pragma unroll
        for (int k = 0; k < NCM; ++k) {
            const int q = c.lane + 32 * k;
            const float ck = q < P ? fbe_shm[s.col + q] : 0.f;
#pragma unroll
            for (int r = 0; r < RW; ++r) {
                const bool ok = c.ok(r, k);
                const int i = c.at(r, k);
                // is_last re-seeds the sweep with ones (src/hmm.cpp:321-324);
                // cur * sc (BwdScale)
                float cur = last ? 1.f : ks.u0s * g[r][k] + ks.u1s * (R[r] + ck) + ks.hs;
                cur = ok ? cur : 0.f;
                // the raw posterior takes the un-normalized cur
                if (ok) post[i] = a[r][k] * cur * ks.cfs;
                // at column 0, a keeps cur * sc for beta_out
                a[r][k] = n > 0 ? (ok ? a_next[i] : 0.f) : cur;
                g[r][k] = cur * ks.inv * (ok ? e[i] : 0.f);
            }
        }
        // column n's u is its predecessor's successor mix (read before the
        // slot is refilled)
        const float nu0 = hdr[0], nu1 = hdr[1], nu2 = hdr[2];
        fbc_step(g, R, c, s, rank, ranks, N - n, phases, [&] {
            if (n - D >= 0) fetch(n - D, slot);
        });
        slot = slot + 1 == D ? 0 : slot + 1;
        H = fbe_shm[s.col + P];
        u0 = nu0;
        u1 = nu1;
        u2 = nu2;
    }
    // this band of the normalized beta after the chunk's first column
    float* bo = beta_out + (size_t)b * PP + band;
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int k = 0; k < NCM; ++k)
            if (c.ok(r, k)) bo[c.at(r, k)] = a[r][k] * k0.inv;
    cp_async_wait<0>();
    // no rank leaves while another may still push into it
    cluster_arrive();
    cluster_wait();
}

// ---- K3/K4's grid tier: P past what a cluster holds ----
//
// Past the cluster tier (P > 471) a chain's band no longer fits 16 CTAs,
// and a cluster holds no more. So a chain runs on G CTAs of a cooperative
// launch, one an SM, that merge through global memory (L2) instead of
// distributed shared memory: G is the CTAs the card holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SMs: one CTA of up
// to 1024 threads an SM, 132 on an H100) divided by the B chains, at
// least 1 and at most P (fbg_layout; fb_kernels.grid_layout mirrors it).
//
// - Rank g owns the rows [g P / G, (g + 1) P / G) of the state, a band
//   contiguous in E, alphas and posts. Warp w is row group q = w / S and
//   segment s = w % S: it owns the band's rows q + Q r (r < RW) and, lane
//   l, the columns 32 NCM s + l + 32 c (c < NCM) of them, so a row spans
//   S warps (past 512 paths the cluster tier's one warp a row would leave
//   most warps of a band of 4-16 rows idle). A thread owns the same cells
//   in every column.
// - The band's state lives where it fits, in this order (fbg_layout
//   searches Q for the fewest cells a thread): registers, on at most
//   FBG_REG_WARPS warps of at most FBG_CELLS cells a thread (128
//   registers: NCM 4, 8 or 16, the templates' instances), with E copied a
//   ring of FBG_RING columns ahead by 16-byte cp.async as in the cluster
//   tier and K4's alpha loaded into registers a column ahead; else shared
//   memory; else global memory, K3 in its alphas output (column n-1
//   unnormalized until column n reads it back and writes it normalized),
//   K4 its helper g in a [P, P] scratch of the chain. Outside registers,
//   on up to FBG_WARPS warps, E and K4's alpha are read from global
//   memory, prefetched into L2 a column ahead, FBG_BATCH cells' loads at a
//   time (a ring beside a band in shared memory does not fit: 131 KB a
//   band at P=2049, G=132).
// - Row sums stay in the band: each warp's row partial (a shuffle) goes
//   to shared memory, summed over the S segments in order. The P column
//   sums and the total cross CTAs every column: each rank sums its row
//   groups' column partials and its warps' totals in a fixed order into
//   its message (P partials and the band total), written to global
//   memory; a block barrier and one thread's arrival with release
//   semantics on the chain's counter (csrc/grid.cuh) publish it. Where G
//   (P + 1) floats are few (FBE_GRID_ONE_HOP) every rank then waits for
//   the G arrivals and sums the G messages in rank order (one hop);
//   otherwise rank g sums its slice of the P + 1 entries over the G
//   messages (a warp an entry, its lanes over the ranks, a fixed tree),
//   writes the sums, arrives a second time, and every rank reads all the
//   sums once the second G arrivals are in (two hops: about 2 G (P + 1)
//   floats moved a chain, against G^2 (P + 1) for one hop). Messages and
//   sums alternate between two parities, so a buffer is written again
//   only after every rank has passed the next column's wait. Every rank
//   holds the same bits and a launch repeats its bits; different G sum in
//   other orders, within the tolerance.
// - At G = 1 no arrival is needed: the message is the column sums, and
//   the launch is not cooperative.
// - The arithmetic is the cluster tier's: the factored mix; K3 folds 1 /
//   s into the next column's mix; K4 forms its helper from beta = cur /
//   s with s known before cur (fbe_total, fbe_bwd_scale: fault F4's
//   repair); the uniform state where s <= 0; is_last re-seeds with ones.
//   K3 writes alpha once, normalized, and rank 0 c_fwd; K4 writes the raw
//   posteriors once and each rank its band of beta_out at column 0. The
//   column's scalars (u, c_fwd, is_last) are loaded a column ahead.
// - Measured (tools/fbe_grid_merge.py, an NVIDIA H100 80GB HBM3 at 700
//   W), over a floor of the message written alone: one bare arrival
//   costs 0.83-1.11 us a column at G = 8-132; two hops 3.3-4.4 us; one
//   hop 1.3 us at G = 8 but 3.7 / 6.2 at G = 66 and 7.8 / 13.4 at G = 132
//   (P = 600 / 1025: L2 bandwidth), so two hops past FBE_GRID_ONE_HOP.
//   K3 / K4 (tools/fbe_times.py --wide and --grid, same card): at
//   genotype -f -a 600's chunk shape (B=2 N=2048 P=600, 66 CTAs of 15
//   warps, 16 cells a thread in registers, two hops) 6.7 / 9.2 us a column
//   against 265.5 / 258.7 for the one-CTA tier this one replaced, of which
//   the two-hop merge alone is 3.3; one hop forced 8.5 / 11.7; one CTA a
//   chain (G = 1, the state in global memory) 89 / 113; and at B=2 N=512
//   P=465 (a build without the cluster tier) 6.0 / 6.5 against the
//   cluster tier's 7.4 / 8.1. On 32 warps of 64 registers the register
//   instances spilled hundreds of bytes (K4 12.3 us at -a 600); K4's
//   alpha a column ahead still spills 208 bytes at 16 cells.

#define FBG_REG 0
#define FBG_SMEM 1
#define FBG_GLOBAL 2
#define FBG_WARPS 32
#define FBG_REG_WARPS 16
#define FBG_RING 2
#define FBG_CELLS 32
#define FBG_BATCH 8
// the CTAs the card holds at once; 0: cudaOccupancyMaxActiveBlocksPerMultiprocessor
// x the SMs (a build with another value runs every chain on fewer CTAs)
#ifndef FBE_GRID_SMS
#define FBE_GRID_SMS 0
#endif
// one hop where each rank reads at most this many floats of messages,
// G (P + 1); two hops beyond (the crossover of tools/fbe_grid_merge.py:
// G ~ 60 at P = 600, ~ 33 at P = 1025)
#ifndef FBE_GRID_ONE_HOP
#define FBE_GRID_ONE_HOP 34000
#endif

// The grid tier's layout for P paths on `ctas` CTAs a chain: the most
// rows a band has, row groups Q and segments S a row (Q S warps), column
// slots a lane (NCM), rows a warp (RW), where the band's state lives,
// hops of the merge (0 at one CTA), and whether the partials live in
// global memory (only where even they do not fit one block's shared
// memory beside the column sums: one CTA of thousands of paths).
struct FbgLayout {
    int ctas, rows, groups, segs, ncm, rw, store, hops, gpart;
};

__host__ __device__ __forceinline__ int fbg_ceil(long long a, long long b) {
    return (int)((a + b - 1) / b);
}

__host__ __device__ __forceinline__ long long fbg_round4(long long x) { return (x + 3) & ~3LL; }

// Floats of the partials: the row groups' column partials [Q][msg], the
// row partials [S][rows], the row sums [rows].
__host__ __device__ __forceinline__ long long fbg_part_floats(int P, const FbgLayout& l) {
    return (long long)l.groups * fbc_msg(P) + fbg_round4((long long)l.segs * l.rows)
        + fbg_round4(l.rows);
}

// Shared memory (fb_kernels.grid_layout mirrors it): the column sums
// [msg], the warps' totals [32], the partials (unless in global memory),
// and the E ring of FBG_RING bands at any 16-byte misalignment (state in
// registers) or the band's state (shared memory).
__host__ __device__ __forceinline__ long long fbg_smem(int P, const FbgLayout& l) {
    long long f = fbc_msg(P) + 32 + (l.gpart ? 0 : fbg_part_floats(P, l));
    if (l.store == FBG_REG) f += (long long)FBG_RING * fbe_span_floats(l.rows * P);
    if (l.store == FBG_SMEM) f += fbg_round4((long long)l.rows * P);
    return (long long)sizeof(float) * f;
}

// Floats of a chain's scratch (fb_kernels.grid_scratch mirrors it): its
// counter (16 bytes), the messages [2][G][msg] and sums [2][msg], the
// ranks' partials where they live in global memory, and K4's helper [P,
// P] where the state does.
__host__ __device__ __forceinline__ long long fbg_chain_floats(int P, const FbgLayout& l,
                                                               bool backward) {
    long long f = 4 + 2LL * (l.ctas + 1) * fbc_msg(P);
    if (l.gpart) f += (long long)l.ctas * fbg_part_floats(P, l);
    if (backward && l.store == FBG_GLOBAL) f += (long long)P * P;
    return f;
}

// The rule, past the cluster tier: G = capacity / B CTAs a chain (1 to
// P), bands of at most ceil(P / G) rows; the band's state in registers
// where some Q (1 to FBG_REG_WARPS, at most the rows) gives at most
// FBG_CELLS cells a thread at NCM = 4, 8 or 16, else in shared memory,
// else in global memory (Q up to FBG_WARPS); within a place the fewest
// cells a thread, then the fewest rows a warp, then the fewest warps. Q
// sets NCM: the fewest slots a lane with which (warps / Q) segments span
// P. False where not even the column sums fit one block's shared memory
// (P past ~58,000).
static bool fbg_layout(int P, int B, int capacity, FbgLayout& out) {
    if (P <= FB_MAX_PATHS || B < 1) return false;
    int G = capacity / B;
    G = G < 1 ? 1 : G > P ? P : G;
    const int rows = fbg_ceil(P, G);
    const int hops = G == 1 ? 0 : (long long)G * (P + 1) <= FBE_GRID_ONE_HOP ? 1 : 2;
    bool found = false;
    for (int store = FBG_REG; store <= FBG_GLOBAL && !found; ++store) {
        const int warps = store == FBG_REG ? FBG_REG_WARPS : FBG_WARPS;
        for (int groups = 1; groups <= warps && groups <= rows; ++groups) {
            int ncm = fbg_ceil(P, 32 * (warps / groups));
            if (store == FBG_REG) ncm = ncm <= 4 ? 4 : ncm <= 8 ? 8 : ncm <= 16 ? 16 : 0;
            if (ncm == 0) continue;
            FbgLayout l = {G, rows, groups, fbg_ceil(P, 32 * ncm), ncm, fbg_ceil(rows, groups),
                           store, hops, 0};
            if (store == FBG_REG && l.rw * l.ncm > FBG_CELLS) continue;
            if (store == FBG_GLOBAL && fbg_smem(P, l) > FBE_SMEM_BYTES) l.gpart = 1;
            if (fbg_smem(P, l) > FBE_SMEM_BYTES) continue;
            const long long cells = (long long)l.rw * l.ncm, best = (long long)out.rw * out.ncm;
            if (!found || cells < best || (cells == best && (l.rw < out.rw || (l.rw == out.rw
                    && l.groups * l.segs < out.groups * out.segs)))) {
                out = l;
                found = true;
            }
        }
    }
    return found;
}

// The cells of one thread in its rank's band of `rows` rows.
struct GridCells {
    int P, rows, groups, w, q, s, lane, col0;
    __device__ GridCells(int P_, int rows_, const FbgLayout& l)
        : P(P_), rows(rows_), groups(l.groups), w(threadIdx.x >> 5), lane(threadIdx.x & 31) {
        q = w / l.segs;
        s = w - q * l.segs;
        col0 = 32 * l.ncm * s + lane;
    }
    __device__ __forceinline__ int row(int r) const { return q + groups * r; }
    __device__ __forceinline__ int col(int k) const { return col0 + 32 * k; }
};

// Where a rank's buffers are: the column sums and the warps' totals in
// shared memory, the partials there too (or in global memory), then the E
// ring or the band's state.
struct FbgMem {
    float *col, *wtot, *stage, *rowpart, *rsum, *ring, *state;
    int msg, slot;
};

__device__ __forceinline__ FbgMem fbg_mem(int P, const FbgLayout& l, float* gpart) {
    FbgMem m;
    m.msg = fbc_msg(P);
    m.slot = l.store == FBG_REG ? fbe_span_floats(l.rows * P) : 0;
    float* p = fbe_shm;
    m.col = p;
    m.wtot = m.col + m.msg;
    p = m.wtot + 32;
    float* part = l.gpart ? gpart : p;
    m.stage = part;
    m.rowpart = m.stage + l.groups * m.msg;
    m.rsum = m.rowpart + fbg_round4((long long)l.segs * l.rows);
    if (!l.gpart) p = m.rsum + fbg_round4(l.rows);
    m.ring = m.state = p;
    return m;
}

// A chain's scratch: the counter, the messages, the sums, this rank's
// partials (where in global memory) and K4's helper (where in global
// memory).
struct FbgChain {
    unsigned* counter;
    float *msgs, *sums, *part, *state;
};

__device__ __forceinline__ FbgChain fbg_chain(float* scratch, int b, int rank, int P,
                                              const FbgLayout& l, bool backward) {
    FbgChain c;
    float* base = scratch + (size_t)b * fbg_chain_floats(P, l, backward);
    const int msg = fbc_msg(P);
    c.counter = reinterpret_cast<unsigned*>(base);
    c.msgs = base + 4;
    c.sums = c.msgs + (size_t)2 * l.ctas * msg;
    float* p = c.sums + (size_t)2 * msg;
    c.part = p + (size_t)rank * (l.gpart ? fbg_part_floats(P, l) : 0);
    if (l.gpart) p += (size_t)l.ctas * fbg_part_floats(P, l);
    c.state = p;
    return c;
}

// The pass over a thread's cells in registers (RW x NCM, 0 outside the
// band): cell(r, k, ok, i, row, j) sets and returns the new value of cell
// (row, j), band offset i (a row's base plus 32 k, so that each access is
// a base register and an immediate; used only where ok). Writes the row
// partials, this warp's column partials into its row group's stage and
// its total; no barrier.
template <int RW, int NCM, class Cell>
__device__ __forceinline__ void fbg_pass_reg(const GridCells& c, const FbgLayout& l,
                                             const FbgMem& m, Cell&& cell) {
    float cs[NCM];
#pragma unroll
    for (int k = 0; k < NCM; ++k) cs[k] = 0.f;
    float wt = 0.f;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
        const int row = c.row(r);
        const bool rok = row < c.rows;   // the same for the whole warp
        const int base = row * c.P + c.col0;
        float rs = 0.f;
#pragma unroll
        for (int k = 0; k < NCM; ++k) {
            const int j = c.col(k);
            const bool ok = rok && j < c.P;
            const float v = cell(r, k, ok, base + 32 * k, row, j);
            rs += v;
            cs[k] += v;
        }
        if (rok) {
            rs = warp_sum(rs);
            if (c.lane == 0) m.rowpart[c.s * l.rows + row] = rs;
            wt += rs;
        }
    }
    float* stage = m.stage + c.q * m.msg;
#pragma unroll
    for (int k = 0; k < NCM; ++k)
        if (c.col(k) < c.P) stage[c.col(k)] = cs[k];
    if (c.lane == 0) m.wtot[c.w] = wt;
}

// What a cell of the memory pass loads (up to three floats).
struct FbgLoad {
    float x, y, z;
};

// The same pass where the state lives in memory, FBG_BATCH cells of a row
// at a time: load(i) starts the reads of cell i from memory, all the
// batch's loads at once; cell(v, i, row, j) does the rest and its writes
// and returns the new value. Column partials are summed in the stage
// (each entry has one owner), row by row.
template <class Load, class Cell>
__device__ __forceinline__ void fbg_pass_mem(const GridCells& c, const FbgLayout& l,
                                             const FbgMem& m, Load&& load, Cell&& cell) {
    float* stage = m.stage + c.q * m.msg;
    float wt = 0.f;
    for (int r = 0; r < l.rw; ++r) {
        const int row = c.row(r);
        if (row >= c.rows) break;        // the same for the whole warp
        const size_t at = (size_t)row * c.P;
        float rs = 0.f;
        for (int k0 = 0; k0 < l.ncm && c.col(k0) < c.P; k0 += FBG_BATCH) {
            FbgLoad v[FBG_BATCH];
#pragma unroll
            for (int u = 0; u < FBG_BATCH; ++u) {
                const int j = c.col(k0 + u);
                if (k0 + u < l.ncm && j < c.P) v[u] = load(at + j);
            }
#pragma unroll
            for (int u = 0; u < FBG_BATCH; ++u) {
                const int j = c.col(k0 + u);
                if (k0 + u < l.ncm && j < c.P) {
                    const float y = cell(v[u], at + j, row, j);
                    rs += y;
                    stage[j] = r == 0 ? y : stage[j] + y;
                }
            }
        }
        rs = warp_sum(rs);
        if (c.lane == 0) m.rowpart[c.s * l.rows + row] = rs;
        wt += rs;
    }
    if (c.q >= c.rows)                   // a row group without rows in this band
        for (int k = 0; k < l.ncm && c.col(k) < c.P; ++k) stage[c.col(k)] = 0.f;
    if (c.lane == 0) m.wtot[c.w] = wt;
}

// After the barrier that publishes the partials: the band's message (its
// row groups' column partials summed in order, the warps' totals in order
// at P) and its row sums (the segments' partials in order); then the
// chain's column sums and total into m.col, the same bits in every rank:
// at one CTA the message itself, else through global memory in one or two
// hops (see above) on parity `step` & 1 of the buffers. Ends without a
// barrier after the last writes to shared memory.
__device__ __forceinline__ void fbg_merge(const FbgMem& m, const FbgLayout& l,
                                          const FbgChain& ch, int P, int rows, int rank,
                                          unsigned step) {
    const int t = threadIdx.x, T = blockDim.x, M = P + 1, G = l.ctas;
    const int warps = T >> 5, w = t >> 5, lane = t & 31, p = (int)(step & 1);
    float* mine = ch.msgs + ((size_t)p * G + rank) * m.msg;
    for (int j = t; j < M; j += T) {
        float x = 0.f;
        if (j < P)
            for (int q = 0; q < l.groups; ++q) x += m.stage[q * m.msg + j];
        else
            for (int v = 0; v < warps; ++v) x += m.wtot[v];
        if (G == 1)
            m.col[j] = x;
        else
            grid_store(mine + j, x);
    }
    for (int i = t; i < rows; i += T) {
        float x = 0.f;
        for (int s = 0; s < l.segs; ++s) x += m.rowpart[s * l.rows + i];
        m.rsum[i] = x;
    }
    if (G == 1) return;
    __syncthreads();
    grid_arrive(ch.counter);
    grid_wait(ch.counter, (unsigned)G * ((unsigned)l.hops * step + 1));
    const float* msgs = ch.msgs + (size_t)p * G * m.msg;
    if (l.hops == 1) {
        for (int j = t; j < M; j += T) {
            float x = 0.f;
            for (int k = 0; k < G; ++k) x += grid_load(msgs + (size_t)k * m.msg + j);
            m.col[j] = x;
        }
        return;
    }
    float* sums = ch.sums + (size_t)p * m.msg;
    for (int j = rank * M / G + w; j < (rank + 1) * M / G; j += warps) {
        float x = 0.f;
        for (int k = lane; k < G; k += 32) x += grid_load(msgs + (size_t)k * m.msg + j);
        x = warp_sum(x);
        if (lane == 0) grid_store(sums + j, x);
    }
    __syncthreads();
    grid_arrive(ch.counter);
    grid_wait(ch.counter, (unsigned)G * (2 * step + 2));
    for (int j = t; j < M; j += T) m.col[j] = grid_load(sums + j);
}

// The `floats` floats from p on into L2, one 128-byte line a thread at a
// time (the grid tier's E and alpha a column ahead, where no ring holds
// them).
__device__ __forceinline__ void fbg_prefetch(const float* p, size_t floats) {
    for (size_t o = (size_t)threadIdx.x * 32; o < floats; o += (size_t)blockDim.x * 32)
        PREFETCH_L2(p + o);
}

// One step of the chain after the cells: the partials published, the
// ring slot just read handed to `refill`, the merge of step `step`, the
// ring's next column waited for, all published by the second barrier.
template <class F>
__device__ __forceinline__ void fbg_step(const FbgMem& m, const FbgLayout& l,
                                         const FbgChain& ch, int P, int rows, int rank,
                                         unsigned step, F&& refill) {
    __syncthreads();
    refill();
    cp_async_commit();
    fbg_merge(m, l, ch, P, rows, rank, step);
    cp_async_wait<FBG_RING - 1>();
    __syncthreads();
}

// 128 registers a thread in registers (FBG_REG_WARPS), 64 in memory
#define FBG_BOUNDS(STORE) __launch_bounds__(32 * ((STORE) == FBG_REG ? FBG_REG_WARPS : FBG_WARPS), 1)

template <int RW, int NCM, int STORE>
__global__ void FBG_BOUNDS(STORE)
fbe_forward_grid_kernel(const float* __restrict__ E, const float* __restrict__ u,
                        const float* __restrict__ alpha0, float* __restrict__ alphas,
                        float* __restrict__ c_fwd, float* __restrict__ scratch, int N, int P,
                        FbgLayout l) {
    constexpr int D = FBG_RING;
    const int G = l.ctas, b = blockIdx.x / G, rank = blockIdx.x - b * G, t = threadIdx.x;
    const int i0 = (int)((long long)rank * P / G);
    const int rows = (int)((long long)(rank + 1) * P / G) - i0;
    const size_t PP = (size_t)P * P, band = (size_t)i0 * P, L = (size_t)rows * P;
    const FbgChain ch = fbg_chain(scratch, b, rank, P, l, false);
    const FbgMem m = fbg_mem(P, l, ch.part);
    const GridCells c(P, rows, l);
    const float uniform = 1.0f / (float)PP, row_uniform = (float)P * uniform;
    const float* e_b = E + (size_t)b * N * PP + band;
    const float* u_b = u + (size_t)b * N * 3;
    const float* a0 = alpha0 + (size_t)b * PP + band;
    float* alpha_b = alphas + (size_t)b * N * PP + band;

    // column `col`'s band into its ring slot (registers), or into L2
    auto fetch = [&](int col, int slot) {
        if (STORE == FBG_REG)
            fetch_column(m.ring + slot * m.slot, e_b + (size_t)col * PP, (int)L);
        else
            fbg_prefetch(e_b + (size_t)col * PP, L);
    };
    if (STORE == FBG_REG)
        for (int j = 0; j < D; ++j) {                     // columns 0 .. D-1
            if (j < N) fetch(j, j);
            cp_async_commit();
        }
    else
        fetch(0, 0);
    // a: the carry in registers, unnormalized (alpha_{n-1} = a * inv); in
    // memory: shared (st) or K3's own alphas (column n-1 until column n)
    float a[RW > 0 ? RW : 1][NCM];
    float* st = m.state;
    // step 0: the entry carry's sums (it mixes as it is); column 0 arrives
    if constexpr (STORE == FBG_REG) {
        fbg_pass_reg<RW, NCM>(c, l, m, [&](int r, int k, bool ok, int i, int, int) {
            a[r][k] = ok ? a0[i] : 0.f;
            return a[r][k];
        });
    } else {
        fbg_pass_mem(c, l, m, [&](size_t i) { return FbgLoad{a0[i], 0.f, 0.f}; },
                     [&](const FbgLoad& v, size_t i, int, int) {
                         if (STORE == FBG_SMEM) st[i] = v.x;
                         return v.x;
                     });
    }
    fbg_step(m, l, ch, P, rows, rank, 0, [] {});
    float H = m.col[P], inv = 1.f;
    bool uni = false;                  // the carry is the uniform state
    float u0 = u_b[0], u1 = u_b[1], u2 = u_b[2];
    int slot = 0;

    for (int n = 0; n < N; ++n) {
        // the next column's mix, a column ahead
        const int nn = n + 1 < N ? n + 1 : n;
        const float nu0 = u_b[3 * nn], nu1 = u_b[3 * nn + 1], nu2 = u_b[3 * nn + 2];
        const float hh = u2 * H;
        float* prev = alpha_b + (size_t)(n > 0 ? n - 1 : 0) * PP;
        if constexpr (STORE == FBG_REG) {
            const float* e = m.ring + slot * m.slot + misalign(e_b + (size_t)n * PP);
            fbg_pass_reg<RW, NCM>(c, l, m, [&](int r, int k, bool ok, int i, int row,
                                               int j) {
                const float x = uni ? uniform : a[r][k];
                if (n > 0 && ok) prev[i] = x * inv;          // alpha_{n-1}
                const float rs = uni ? row_uniform : (ok ? m.rsum[row] : 0.f);
                const float ck = uni ? row_uniform : (ok ? m.col[j] : 0.f);
                const float ev = ok ? e[i] : 0.f;
                a[r][k] = inv * (u0 * x + u1 * (rs + ck) + hh) * ev;
                return a[r][k];
            });
        } else {
            const float* e = e_b + (size_t)n * PP;
            const float* src = STORE == FBG_SMEM ? st : n == 0 ? a0 : prev;
            float* dst = STORE == FBG_SMEM ? st : alpha_b + (size_t)n * PP;
            fbg_pass_mem(c, l, m, [&](size_t i) { return FbgLoad{src[i], e[i], 0.f}; },
                         [&](const FbgLoad& v, size_t i, int row, int j) {
                             const float x = uni ? uniform : v.x;
                             if (n > 0) prev[i] = x * inv;     // alpha_{n-1}
                             const float rs = uni ? row_uniform : m.rsum[row];
                             const float ck = uni ? row_uniform : m.col[j];
                             const float y = inv * (u0 * x + u1 * (rs + ck) + hh) * v.y;
                             dst[i] = y;
                             return y;
                         });
        }
        // every thread is done with the slot once the partials are
        // published: column n + D takes it (outside registers: column n +
        // 1 into L2)
        fbg_step(m, l, ch, P, rows, rank, (unsigned)n + 1, [&] {
            if (STORE == FBG_REG ? n + D < N : n + 1 < N)
                fetch(STORE == FBG_REG ? n + D : n + 1, slot);
        });
        slot = slot + 1 == D ? 0 : slot + 1;
        const float tot = m.col[P];
        if (rank == 0 && t == 0) c_fwd[(size_t)b * N + n] = tot > 0.f ? tot : 1.f;
        uni = !(tot > 0.f);
        inv = uni ? 1.f : 1.f / tot;
        H = uni ? 1.f : tot;
        u0 = nu0;
        u1 = nu1;
        u2 = nu2;
    }
    float* last_col = alpha_b + (size_t)(N - 1) * PP;
    if constexpr (STORE == FBG_REG) {
#pragma unroll
        for (int r = 0; r < RW; ++r)
#pragma unroll
            for (int k = 0; k < NCM; ++k)
                if (c.row(r) < rows && c.col(k) < P)
                    last_col[(size_t)c.row(r) * P + c.col(k)] = (uni ? uniform : a[r][k]) * inv;
    } else {
        const float* src = STORE == FBG_SMEM ? st : last_col;
        for (int r = 0; r < l.rw && c.row(r) < rows; ++r)
            for (int k = 0; k < l.ncm && c.col(k) < P; ++k) {
                const size_t i = (size_t)c.row(r) * P + c.col(k);
                last_col[i] = (uni ? uniform : src[i]) * inv;
            }
    }
    cp_async_wait<0>();
}

template <int RW, int NCM, int STORE>
__global__ void FBG_BOUNDS(STORE)
fbe_backward_grid_kernel(const float* __restrict__ alphas, const float* __restrict__ c_fwd,
                         const float* __restrict__ E, const float* __restrict__ u,
                         const float* __restrict__ e_after, const float* __restrict__ u_after,
                         const int* __restrict__ is_last, const float* __restrict__ beta0,
                         float* __restrict__ posts, float* __restrict__ beta_out,
                         float* __restrict__ scratch, int N, int P, FbgLayout l) {
    constexpr int D = FBG_RING;
    const int G = l.ctas, b = blockIdx.x / G, rank = blockIdx.x - b * G;
    const int i0 = (int)((long long)rank * P / G);
    const int rows = (int)((long long)(rank + 1) * P / G) - i0;
    const size_t PP = (size_t)P * P, band = (size_t)i0 * P, L = (size_t)rows * P;
    const FbgChain ch = fbg_chain(scratch, b, rank, P, l, true);
    const FbgMem m = fbg_mem(P, l, ch.part);
    const GridCells c(P, rows, l);
    const float uniform = 1.0f / (float)PP;
    const float* e_b = E + (size_t)b * N * PP + band;
    const float* u_b = u + (size_t)b * N * 3;
    const float* alpha_b = alphas + (size_t)b * N * PP + band;
    const float* cf_b = c_fwd + (size_t)b * N;
    const int* last_b = is_last + (size_t)b * N;
    float* post_b = posts + (size_t)b * N * PP + band;
    float* bo = beta_out + (size_t)b * PP + band;
    const float* b0 = beta0 + (size_t)b * PP + band;
    const float* ea = e_after + (size_t)b * PP + band;

    // column `col`'s E band into its ring slot (registers), or it and its
    // alpha into L2
    auto fetch = [&](int col, int slot) {
        if (STORE == FBG_REG) {
            fetch_column(m.ring + slot * m.slot, e_b + (size_t)col * PP, (int)L);
        } else {
            fbg_prefetch(e_b + (size_t)col * PP, L);
            fbg_prefetch(alpha_b + (size_t)col * PP, L);
        }
    };
    if (STORE == FBG_REG)
        for (int j = 0; j < D; ++j) {                     // columns N-1 .. N-D
            if (j < N) fetch(N - 1 - j, j);
            cp_async_commit();
        }
    else
        fetch(N - 1, 0);
    // g: the helper of the column ahead (its beta times its E), in
    // registers or in memory (shared, or the chain's [P, P] scratch); a:
    // in registers, alpha of the column being computed, loaded a column
    // ahead
    float g[RW > 0 ? RW : 1][NCM], a[RW > 0 ? RW : 1][NCM];
    float* gs = STORE == FBG_SMEM ? m.state : ch.state + band;
    // step 0: the helper of the column after the chunk; column N-1 arrives
    if constexpr (STORE == FBG_REG) {
        fbg_pass_reg<RW, NCM>(c, l, m, [&](int r, int k, bool ok, int i, int, int) {
            g[r][k] = ok ? b0[i] * ea[i] : 0.f;
            a[r][k] = ok ? alpha_b[(size_t)(N - 1) * PP + i] : 0.f;
            return g[r][k];
        });
    } else {
        fbg_pass_mem(c, l, m, [&](size_t i) { return FbgLoad{b0[i], ea[i], 0.f}; },
                     [&](const FbgLoad& v, size_t i, int, int) {
                         const float y = v.x * v.y;
                         gs[i] = y;
                         return y;
                     });
    }
    fbg_step(m, l, ch, P, rows, rank, 0, [] {});
    float H = m.col[P];                                  // beta0 is normalized
    float u0 = u_after[(size_t)b * 3], u1 = u_after[(size_t)b * 3 + 1],
          u2 = u_after[(size_t)b * 3 + 2];
    float cf = cf_b[N - 1];
    bool last = last_b[N - 1] != 0;
    int slot = 0;

    for (int n = N - 1; n >= 0; --n) {
        // the total of cur, known before it (fbe_total), and beta = cur / s
        const BwdScale ks = fbe_bwd_scale(last, H, u0, u1, u2, P, cf, uniform);
        // column n's u is its predecessor's successor mix; the
        // predecessor's c_fwd and is_last, a column ahead
        const int np = n > 0 ? n - 1 : 0;
        const float nu0 = u_b[3 * n], nu1 = u_b[3 * n + 1], nu2 = u_b[3 * n + 2];
        const float ncf = cf_b[np];
        const int nlast = last_b[np];
        float* post = post_b + (size_t)n * PP;
        if constexpr (STORE == FBG_REG) {
            const float* e = m.ring + slot * m.slot + misalign(e_b + (size_t)n * PP);
            const float* a_next = alpha_b + (size_t)np * PP;
            fbg_pass_reg<RW, NCM>(c, l, m, [&](int r, int k, bool ok, int i, int row,
                                               int j) {
                const float rs = ok ? m.rsum[row] : 0.f, ck = ok ? m.col[j] : 0.f;
                // is_last re-seeds the sweep with ones (src/hmm.cpp:321-324);
                // cur * sc (BwdScale)
                float cur = last ? 1.f : ks.u0s * g[r][k] + ks.u1s * (rs + ck) + ks.hs;
                cur = ok ? cur : 0.f;
                // the raw posterior takes the un-normalized cur
                if (ok) post[i] = a[r][k] * cur * ks.cfs;
                // the normalized beta after the chunk's first column
                if (n == 0 && ok) bo[i] = cur * ks.inv;
                a[r][k] = n > 0 && ok ? a_next[i] : 0.f;
                g[r][k] = cur * ks.inv * (ok ? e[i] : 0.f);
                return g[r][k];
            });
        } else {
            const float* e = e_b + (size_t)n * PP;
            const float* a_n = alpha_b + (size_t)n * PP;
            fbg_pass_mem(c, l, m, [&](size_t i) { return FbgLoad{gs[i], a_n[i], e[i]}; },
                         [&](const FbgLoad& v, size_t i, int row, int j) {
                             const float cur = last ? 1.f
                                 : ks.u0s * v.x + ks.u1s * (m.rsum[row] + m.col[j]) + ks.hs;
                             post[i] = v.y * cur * ks.cfs;
                             if (n == 0) bo[i] = cur * ks.inv;
                             const float y = cur * ks.inv * v.z;
                             gs[i] = y;
                             return y;
                         });
        }
        fbg_step(m, l, ch, P, rows, rank, (unsigned)(N - n), [&] {
            if (STORE == FBG_REG ? n - D >= 0 : n > 0)
                fetch(STORE == FBG_REG ? n - D : n - 1, slot);
        });
        slot = slot + 1 == D ? 0 : slot + 1;
        H = m.col[P];
        u0 = nu0;
        u1 = nu1;
        u2 = nu2;
        cf = ncf;
        last = nlast != 0;
    }
    cp_async_wait<0>();
}

// ---- K2 at P <= 32 (and A <= 8): one warp per chain ----
//
// The chain's only dependent step is the column's normalizer and the sums
// of the next helper; everything else hangs off it. Lane l holds column
// q = l mod Q (Q = P rounded up to a power of two) and, in registers, the
// rows grp + L r of it (grp = l / Q, L = 32 / Q lanes a column; so the L
// lanes of a column read their alphas from different banks): at the
// bench's P=16, two lanes a column of 8 rows each. Each column: the
// helper's row sums are a butterfly over the Q lanes of a row, its
// column sum over the L lanes of a column and its total over the warp,
// all shuffles in a fixed order (every lane gets the same bits). The
// total s of cur needs no sum of its own (fbe_total: it follows from the
// helper's total), so the next helper is formed from beta = cur / s, as
// K4 does. The transition is mixed in the factored form (u0, u1, u2). The column's
// inputs (trans, c_fwd, is_last, its [A, A] emissions, the paths' alleles
// and its alpha column) arrive by cp.async in a ring of FBW_RING slots
// in shared memory, issued FBW_RING - 1 columns ahead by predicated
// copies placed after the cells, so that they issue among the column's
// shuffles; one __syncwarp a column publishes a slot, and the lane's
// inputs are read out of it a column ahead into registers (up to 8 rows
// a lane). The posterior alpha * cur * c_fwd is summed by row allele in
// registers (8 of them: real batches pad A to 3-8), then off the chain:
// the partials are summed over a column's lanes by shuffles and across
// columns by their allele from a double buffer in shared memory, one
// column later. (A second instance for A <= 2 that collapsed in six
// shuffles took 48.3 against 99.6 ms at B=2 N=65,536 P=16 A=2, but no
// real batch has A <= 2: PERF.md.) Tier by P:
// 32 < P <= 128 (or A > 8, which the fused route never sends) keeps
// fb_backward_kernel.

#define FBW_RING 8
#define FBW_HEADER 8                 // t0, t1, t2, c_fwd, is_last
#define FBW_MAX_PATHS 32
#define FBW_MAX_ALLELES 8

__host__ __device__ __forceinline__ int fbw_ea_floats(int A) { return (A * A + 3) & ~3; }
__host__ __device__ __forceinline__ int fbw_al_floats(int P) { return (P + 3) & ~3; }
__host__ __device__ __forceinline__ int fbw_slot_floats(int P, int A) {
    return FBW_HEADER + fbw_ea_floats(A) + fbw_al_floats(P) + fbe_column_floats(P);
}
// the collapse's double buffer: per column lane, 8 partials and its allele
#define FBW_COLLAPSE_FLOATS (32 * (FBW_MAX_ALLELES + 1))

static size_t fbw_smem(int P, int A) {
    return sizeof(float) * ((size_t)FBW_RING * fbw_slot_floats(P, A)
                            + 2 * FBW_COLLAPSE_FLOATS);
}

// the sum of v over the lanes that differ from this one in bits [LO, HI)
template <int LO, int HI>
__device__ __forceinline__ float xor_sum(float v) {
#pragma unroll
    for (int o = LO; o < HI; o <<= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
    return v;
}

template <int Q, int RW>
__global__ void __launch_bounds__(32, 1)
fb_backward_warp_kernel(const float* __restrict__ alphas, const float* __restrict__ c_fwd,
                        const float* __restrict__ ea, const int* __restrict__ al,
                        const float* __restrict__ trans, const int* __restrict__ is_last,
                        float* __restrict__ posts, int N, int P, int A) {
    constexpr int L = 32 / Q, D = FBW_RING;
    const int lane = threadIdx.x, b = blockIdx.x, PP = P * P, AA = A * A;
    const int q = lane & (Q - 1), grp = lane / Q;
    const bool qok = q < P;
    const float uniform = 1.0f / (float)PP;
    const int ea_off = FBW_HEADER, al_off = ea_off + fbw_ea_floats(A);
    const int alpha_off = al_off + fbw_al_floats(P), pitch = fbw_slot_floats(P, A);
    float* coll = fbe_shm + D * pitch;          // [2][32 x 8 partials, 32 alleles]
    const float* ea_b = ea + (size_t)b * N * AA;
    const int* al_b = al + (size_t)b * N * P;
    const float* tr_b = trans + (size_t)b * N * 3;
    const float* alpha_b = alphas + (size_t)b * N * PP;
    const float* cf_b = c_fwd + (size_t)b * N;
    const int* last_b = is_last + (size_t)b * N;
    float* post_b = posts + (size_t)b * N * AA;

    // The copies of one column into its slot, planned once: the alpha
    // column in 16-byte pieces where P^2 is a multiple of 4 (a column then
    // starts 16-byte aligned), else in 4-byte ones; the scalars (the
    // [A, A] emissions, the paths' alleles, t0-t2, c_fwd, is_last) one
    // 4-byte copy each, spread over the lanes. Every source pointer steps
    // back one column per copy, so a column's copies are predicated
    // stores with no address arithmetic beyond one add each and no
    // branch: the compiler schedules them among the column's shuffles.
    // Columns are copied in order N-1, N-2, ... into slots 0, 1, ... mod D.
    constexpr int NV = (Q * Q / 4 + 31) / 32 > 0 ? (Q * Q / 4 + 31) / 32 : 1;
    constexpr int NW = (Q * Q + 31) / 32;
    constexpr int NS = (FBW_MAX_ALLELES * FBW_MAX_ALLELES + Q + 5 + 31) / 32;
    const bool vec = (PP & 3) == 0;
    const float* a_src = alpha_b + (size_t)(N - 1) * PP;
    const char* s_src[NS];
    int s_step[NS], s_dst[NS];
    bool s_ok[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
        int j = lane + 32 * i;
        const size_t m = N - 1;
        s_ok[i] = j < AA + P + 5;
        s_src[i] = (const char*)ea_b;                  // a valid address where unused
        s_step[i] = 0;
        s_dst[i] = 0;
        if (j < AA) {
            s_src[i] = (const char*)(ea_b + m * AA + j);
            s_step[i] = 4 * AA;
            s_dst[i] = 4 * (ea_off + j);
        } else if ((j -= AA) < P) {
            s_src[i] = (const char*)(al_b + m * P + j);
            s_step[i] = 4 * P;
            s_dst[i] = 4 * (al_off + j);
        } else if ((j -= P) < 3) {
            s_src[i] = (const char*)(tr_b + 3 * m + j);
            s_step[i] = 12;
            s_dst[i] = 4 * j;
        } else if (j == 3 || j == 4) {
            s_src[i] = j == 3 ? (const char*)(cf_b + m) : (const char*)(last_b + m);
            s_step[i] = 4;
            s_dst[i] = 4 * j;
        }
    }
    int f_slot = 0, f_col = N - 1;
    auto fetch_next = [&]() {
        if (f_col >= 0) {
            float* s = fbe_shm + f_slot * pitch;
            float* d = s + alpha_off;
            if (vec) {
#pragma unroll
                for (int i = 0; i < NV; ++i) {
                    const int v = 4 * (lane + 32 * i);
                    if (v < PP) cp_async16(d + v, a_src + v);
                }
            } else {
#pragma unroll
                for (int i = 0; i < NW; ++i) {
                    const int v = lane + 32 * i;
                    if (v < PP) cp_async4(d + v, a_src + v);
                }
            }
#pragma unroll
            for (int i = 0; i < NS; ++i)
                if (s_ok[i]) cp_async4((char*)s + s_dst[i], s_src[i]);
            a_src -= PP;
#pragma unroll
            for (int i = 0; i < NS; ++i) s_src[i] -= s_step[i];
        }
        f_slot = f_slot + 1 == D ? 0 : f_slot + 1;
        --f_col;
    };
    // a column's inputs, read from its slot (a column ahead of their use
    // where RW <= 8; at RW = 24 or 32 the registers are too few for two):
    // the lane's emissions, alphas and row alleles, its column's allele,
    // c_fwd, is_last and the transition (t0, t1, t2)
    struct Inputs {
        float e[RW], alpha[RW];
        int ap[RW], cq;
        float cf, t0, t1, t2;
        bool last;
    };
    auto load = [&](int slot, Inputs& x) {
        const float* s = fbe_shm + slot * pitch;
        const int* als = (const int*)(s + al_off);
        const float* eas = s + ea_off;
        const float* alp = s + alpha_off;
        x.cq = qok ? als[q] : 0;
#pragma unroll
        for (int r = 0; r < RW; ++r) {
            const int p = grp + L * r;
            const bool ok = qok && p < P;
            x.ap[r] = ok ? als[p] : 0;
            x.e[r] = ok ? eas[x.ap[r] * A + x.cq] : 0.f;
            x.alpha[r] = ok ? alp[p * P + q] : 0.f;
        }
        x.t0 = s[0];
        x.t1 = s[1];
        x.t2 = s[2];
        x.cf = s[3];
        x.last = ((const int*)s)[4] != 0;
    };
    // out[a, c] of column m from the partials of buffer `par`:
    // the sum over columns x whose allele is c of their row-allele-a
    // partials
    auto collapse = [&](int par, int m) {
        const float* part = coll + par * FBW_COLLAPSE_FLOATS;
        const int* cls = (const int*)(part + 32 * FBW_MAX_ALLELES);
        for (int j = lane; j < AA; j += 32) {
            const int a = j / A, c = j - a * A;
            float acc = 0.f;
#pragma unroll
            for (int x = 0; x < Q; ++x)
                if (x < P) acc += cls[x] == c ? part[x * FBW_MAX_ALLELES + a] : 0.f;
            post_b[(size_t)m * AA + j] = acc;
        }
    };

    for (int j = 0; j < D - 1; ++j) {                     // columns N-1 .. N-D+1
        fetch_next();
        cp_async_commit();
    }
    constexpr bool AHEAD = RW <= 8;
    cp_async_wait<D - 2>();                               // column N-1
    __syncwarp();
    Inputs x, y;
    if (AHEAD) load(0, x);
    // g: the helper beta_{n+1} * E_{n+1}; R its row sums, C its column
    // sum, H its total. Before the last column beta is 0; its successor
    // wraps to column 0 (as jnp.roll), whose transition multiplies zeros
    // there.
    float g[RW], R[RW], C = 0.f, H = 0.f;
#pragma unroll
    for (int r = 0; r < RW; ++r) g[r] = R[r] = 0.f;
    float t0 = tr_b[0], t1 = tr_b[1], t2 = tr_b[2];
    float u0 = t0 - 2.f * t1 + t2, u1 = t1 - t2, u2 = t2;

    for (int k = 0; k < N; ++k) {
        const int n = N - 1 - k;
        // column k's inputs are in x; every lane's copies of column k + 1
        // have arrived, and every lane is done with the slot of column k
        cp_async_wait<D - 3>();
        __syncwarp();
        if (k > 0) collapse((k - 1) & 1, n + 1);
        if (!AHEAD) load(k % D, x);

        // the total of cur, known before it (fbe_total), and beta = cur / s
        const BwdScale ks = fbe_bwd_scale(x.last, H, u0, u1, u2, P, x.cf, uniform);
        float rs[FBW_MAX_ALLELES], g_sum = 0.f;
#pragma unroll
        for (int a = 0; a < FBW_MAX_ALLELES; ++a) rs[a] = 0.f;
#pragma unroll
        for (int r = 0; r < RW; ++r) {
            const bool ok = qok && grp + L * r < P;
            // cur * sc (BwdScale)
            float cur = x.last ? 1.f : ks.u0s * g[r] + ks.u1s * (R[r] + C) + ks.hs;
            cur = ok ? cur : 0.f;
            const float post = x.alpha[r] * cur * ks.cfs;
#pragma unroll
            for (int a = 0; a < FBW_MAX_ALLELES; ++a) rs[a] += x.ap[r] == a ? post : 0.f;
            g[r] = cur * ks.inv * x.e[r];
            g_sum += g[r];
        }
        // off the chain: column k + D - 1 into the slot of column k - 1,
        // and column k + 1's inputs out of its slot
        fetch_next();                                     // column n - (D - 1)
        cp_async_commit();
        if (AHEAD && n > 0) load((k + 1) % D, y);

        // the new helper's sums
        H = xor_sum<1, 32>(g_sum);
        C = xor_sum<Q, 32>(g_sum);
#pragma unroll
        for (int r = 0; r < RW; ++r) R[r] = xor_sum<1, Q>(g[r]);
        // the partials summed over the column's lanes, to buffer k & 1
        // for the collapse at the next column
#pragma unroll
        for (int a = 0; a < FBW_MAX_ALLELES; ++a) rs[a] = xor_sum<Q, 32>(rs[a]);
        if (grp == 0 && qok) {
            float* part = coll + (k & 1) * FBW_COLLAPSE_FLOATS;
#pragma unroll
            for (int a = 0; a < FBW_MAX_ALLELES; ++a) part[q * FBW_MAX_ALLELES + a] = rs[a];
            ((int*)(part + 32 * FBW_MAX_ALLELES))[q] = x.cq;
        }
        // column n's transition mixes the helper of column n - 1
        u0 = x.t0 - 2.f * x.t1 + x.t2;
        u1 = x.t1 - x.t2;
        u2 = x.t2;
        x = y;
    }
    __syncwarp();
    collapse((N - 1) & 1, 0);
    cp_async_wait<0>();
}

// ---- K1 at P <= 32 (and A <= 8): one warp per chain ----
//
// Bit for bit the arithmetic of fb_forward_kernel, the 256-thread tier,
// so that the VCF a batch gives does not depend on the tier: its
// transition form (mix), the row and column sums of the normalized state
// each in order of the index and their total in order of the row, its
// per-thread partials of cur (cells i, i + 256, ...), the shuffle tree of
// each of its 8 warps and their sum in order, and the rounding of its
// division cur / s. (The reference's factored mix with 1 / s folded into
// the next column, as K3 does, took 0.285 us a column at the bench shape
// but changed one line of the bench `single` VCF body: PERF.md.) Lane l
// holds column q = l mod Q and the rows grp + L r of it in registers
// (K2's layout; its instances but for 32 rows a lane at every Q = 32,
// FBF_INSTANCES). A column:
//
// - the total s of cur: where P = Q (the bench's P = 16) the cells of
//   the 256-thread kernel's warp w are register w of the 32 lanes
//   (registers w + 8k at P = 32, its thread's cells i + 256k), so its 8
//   trees are 8 butterflies of shuffles in the tree's order (16, 8, ...,
//   1: every lane ends with the bits lane 0 of the tree gets), with no
//   shared memory; at other P the cells go through a staging column;
// - alpha = cur / s, rounded once as the IEEE division rounds it, from
//   one reciprocal of s in double precision a column and a corrected
//   product a cell (fbf_div): the float division's slow path, which
//   subnormal cells of real columns take, 8 to 32 times a lane, is gone;
// - the sums of alpha in the orders above, each a chain of Q adds in one
//   lane (rows and columns through a transposed copy in shared memory,
//   Q + 1 floats a row; at Q = 32 a column's sum in its lane's
//   registers), then their total, a chain of P adds in every lane; three
//   __syncwarp a column (two where P = Q);
// - the column's [A, A] emissions, its paths' alleles and its transition
//   arrive by cp.async in a ring of FBF_RING slots in shared memory,
//   FBF_RING - 1 columns ahead, by copies planned once, and the lane's
//   gathered emissions E[al[p], al[q]] are read out of it a column ahead
//   (at up to 8 rows a lane). A slot holds the emissions at a pitch of
//   A + 1 with a zero row and column A, and 32 alleles of which those of
//   paths P to 31 are A: a padding row or column gathers a zero emission
//   with no predicate, so its cells of cur and alpha are zeros, which
//   leave every sum's bits as they are.
//
// Tier by P: 32 < P <= 128 (or A > 8, which the fused route never sends)
// keeps fb_forward_kernel (pg_fb_threads, which K2 reads too).

#define FBF_RING 16
#define FBF_HEADER 4                 // t0, t1, t2, and a word the idle copies land in

__host__ __device__ __forceinline__ int fbf_ea_floats(int A) {
    return ((A + 1) * (A + 1) + 3) & ~3;
}
__host__ __device__ __forceinline__ int fbf_slot_floats(int A) {
    return FBF_HEADER + fbf_ea_floats(A) + 32;
}
// the most paths of instance (Q, RW), and the cells of a thread of the
// 256-thread kernel there
__host__ __device__ constexpr int fbf_paths(int Q, int RW) { return Q < 32 ? Q : RW; }
__host__ __device__ constexpr int fbf_cells(int Q, int RW) {
    return (fbf_paths(Q, RW) * fbf_paths(Q, RW) + FB_THREADS - 1) / FB_THREADS;
}

// after the ring: the transposed state [Q, Q + 1], the sums [32], the
// staging column [256 * fbf_cells]
static size_t fbf_smem(int Q, int RW, int A) {
    return sizeof(float) * ((size_t)FBF_RING * fbf_slot_floats(A) + Q * (Q + 1) + 32
                            + FB_THREADS * fbf_cells(Q, RW));
}

// cur / s rounded to float once, as the IEEE division rounds it, for 0 <
// s < 2^24, given sd = s and y = 1 / sd in double precision: the quotient
// x * y, corrected once by its exact residual, is within 2^-52.9 of
// cur / s relative to it; cur / s is further than that from every
// midpoint between floats (over 2^-51 of it where the quotient is normal,
// over 2^-177 where it is subnormal and s < 2^24), or it is one (only
// where it is subnormal), and then the correction meets it exactly. So
// rounding the double to float rounds cur / s; copysignf keeps -0.
__device__ __forceinline__ float fbf_div(float cur, double sd, double y) {
    const double x = (double)cur;
    const double q = x * y;
    return copysignf((float)fma(fma(-q, sd, x), y, q), cur);
}

template <int Q, int RW>
__global__ void __launch_bounds__(32, 1)
fb_forward_warp_kernel(const float* __restrict__ ea, const int* __restrict__ al,
                       const float* __restrict__ trans, float* __restrict__ alphas,
                       float* __restrict__ c_fwd, int N, int P, int A) {
    constexpr int L = 32 / Q, D = FBF_RING, SP = Q + 1, PM = fbf_paths(Q, RW);
    constexpr int KM = fbf_cells(Q, RW);
    // the 256-thread kernel's warps that hold cells (the others add zeros)
    constexpr int NV = PM * PM >= FB_THREADS ? FB_WARPS : (PM * PM + 31) / 32;
    const int lane = threadIdx.x, b = blockIdx.x, PP = P * P, AA = A * A, A1 = A + 1;
    const int q = lane & (Q - 1), grp = lane / Q;
    const bool aligned = P == Q;
    const float uniform = 1.0f / (float)PP;
    const int ea_off = FBF_HEADER, al_off = ea_off + fbf_ea_floats(A);
    const int pitch = fbf_slot_floats(A);
    float* st = fbe_shm + D * pitch;             // [Q, SP] alpha of the column before
    float* sums = st + Q * SP;                   // [32] its row sums, then column sums
    float* stage = sums + 32;                    // [256 KM] cur, by cell index p P + q
    const float* ea_b = ea + (size_t)b * N * AA;
    const int* al_b = al + (size_t)b * N * P;
    const float* tr_b = trans + (size_t)b * N * 3;
    float* alpha_b = alphas + (size_t)b * N * PP;
    float* cf_b = c_fwd + (size_t)b * N;

    // the lane's cells of real paths (bit r: row grp + L r, column q)
    unsigned valid = 0;
#pragma unroll
    for (int r = 0; r < RW; ++r)
        if (q < P && grp + L * r < P) valid |= 1u << r;

    // Every slot: emissions 0 (row and column A stay so), alleles A (paths
    // P to 31 stay so); the state, the sums and the staging column 0 (the
    // cells past P P and rows past RW stay so); published before the first
    // copies
    for (int i = lane; i < D * pitch; i += 32) {
        const int j = i % pitch;
        if (j >= ea_off && j < al_off) fbe_shm[i] = 0.f;
        if (j >= al_off) ((int*)fbe_shm)[i] = A;
    }
    for (int i = lane; i < Q * SP + 32 + FB_THREADS * KM; i += 32) st[i] = 0.f;
    __syncwarp();

    // The copies of one column into its slot, planned once, one 4-byte
    // copy a scalar (the [A, A] emissions, the paths' alleles, t0-t2)
    // spread over the lanes, the idle ones into the header's spare word;
    // every source pointer steps one column per copy. Columns are copied
    // in order 0, 1, ... into slots 0, 1, ... mod D.
    constexpr int NS = (FBW_MAX_ALLELES * FBW_MAX_ALLELES + Q + 3 + 31) / 32;
    const char* s_src[NS];
    int s_step[NS], s_dst[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
        int j = lane + 32 * i;
        s_src[i] = (const char*)ea_b;                  // a valid address where idle
        s_step[i] = 0;
        s_dst[i] = 4 * 3;
        if (j < AA) {
            s_src[i] = (const char*)(ea_b + j);
            s_step[i] = 4 * AA;
            s_dst[i] = 4 * (ea_off + j / A * A1 + j % A);
        } else if ((j -= AA) < P) {
            s_src[i] = (const char*)(al_b + j);
            s_step[i] = 4 * P;
            s_dst[i] = 4 * (al_off + j);
        } else if ((j -= P) < 3) {
            s_src[i] = (const char*)(tr_b + j);
            s_step[i] = 12;
            s_dst[i] = 4 * j;
        }
    }
    int f_slot = 0, f_col = 0;
    auto fetch_next = [&]() {
        const bool live = f_col < N;
        char* s = (char*)(fbe_shm + f_slot * pitch);
#pragma unroll
        for (int i = 0; i < NS; ++i)
            if (live) cp_async4(s + s_dst[i], s_src[i]);
#pragma unroll
        for (int i = 0; i < NS; ++i) s_src[i] += s_step[i];
        f_slot = f_slot + 1 == D ? 0 : f_slot + 1;
        ++f_col;
    };
    // a column's inputs, read from its slot (a column ahead of their use
    // where RW <= 8): the lane's gathered emissions and the transition
    struct Inputs {
        float e[RW];
        float t0, t1, t2;
    };
    auto load = [&](int slot, Inputs& x) {
        const float* s = fbe_shm + slot * pitch;
        const int* als = (const int*)(s + al_off) + grp;
        const float* eas = s + ea_off + ((const int*)(s + al_off))[q];
#pragma unroll
        for (int r = 0; r < RW; ++r) x.e[r] = eas[als[L * r] * A1];
        x.t0 = s[0];
        x.t1 = s[1];
        x.t2 = s[2];
    };

    for (int j = 0; j < D - 1; ++j) {                     // columns 0 .. D-2
        fetch_next();
        cp_async_commit();
    }
    constexpr bool AHEAD = RW <= 8;
    cp_async_wait<D - 2>();                               // column 0
    __syncwarp();
    Inputs x, y;
    if (AHEAD) load(0, x);
    // a: alpha of the column before; R the row sums of the lane's rows, C
    // the sum of its column, h their total (fb_forward_kernel's s_row,
    // s_col, h)
    float a[RW], R[RW], C = 0.f, h = 0.f;
#pragma unroll
    for (int r = 0; r < RW; ++r) a[r] = R[r] = 0.f;

    for (int n = 0; n < N; ++n) {
        // column n's inputs are in x or in slot n % D, published
        if (!AHEAD) load(n % D, x);
        float cur[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
            // the first column starts from all-ones (src/hmm.cpp:236-239)
            const float prev = n == 0 ? 1.f : mix(a[r], R[r], C, h, x.t0, x.t1, x.t2);
            cur[r] = prev * x.e[r];
        }
        if (!aligned) {
#pragma unroll
            for (int r = 0; r < RW; ++r)
                if (valid >> r & 1) stage[(grp + L * r) * P + q] = cur[r];
        }
        // off the chain: column n + D - 1 into the slot of column n - 1
        fetch_next();
        cp_async_commit();

        // the total of cur as fb_forward_kernel's block_sum takes it: the
        // partial of its thread t = 32 w + lane (cells t, t + 256, ...),
        // the tree of warp w, then the warps in order
        float part[NV];
        if (aligned) {
#pragma unroll
            for (int w = 0; w < NV; ++w) {
                part[w] = 0.f;
#pragma unroll
                for (int k = 0; k < KM; ++k)
                    part[w] += valid >> (w + 8 * k) & 1 ? cur[w + 8 * k] : 0.f;
            }
        } else {
            __syncwarp();
#pragma unroll
            for (int w = 0; w < NV; ++w) {
                part[w] = 0.f;
#pragma unroll
                for (int k = 0; k < KM; ++k) part[w] += stage[32 * w + lane + FB_THREADS * k];
            }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
            for (int w = 0; w < NV; ++w) part[w] += __shfl_xor_sync(FULL_MASK, part[w], o);
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < NV; ++w) s += part[w];

        // alpha, to global memory and to the transposed state
        if (s > 0.f && s < 0x1p24f) {
            const double sd = s, inv = 1.0 / sd;
#pragma unroll
            for (int r = 0; r < RW; ++r) a[r] = fbf_div(cur[r], sd, inv);
        } else if (s > 0.f) {                 // never on real columns
#pragma unroll
            for (int r = 0; r < RW; ++r) a[r] = cur[r] / s;
        } else {
#pragma unroll
            for (int r = 0; r < RW; ++r) a[r] = valid >> r & 1 ? uniform : 0.f;
        }
        float* out = alpha_b + (size_t)n * PP;
#pragma unroll
        for (int r = 0; r < RW; ++r) {
            const int p = grp + L * r;
            if (valid >> r & 1) out[p * P + q] = a[r];
            if (L * RW <= Q || p < Q) st[p * SP + q] = a[r];
        }
        if (lane == 0) cf_b[n] = s > 0.f ? s : 1.f;
        // every lane's copies of column n + 1 have arrived
        cp_async_wait<D - 2>();
        __syncwarp();
        if (AHEAD) load((n + 1) % D, y);

        // the row and column sums of alpha, each in order of the index:
        // lanes [0, Q) sum row `lane`, lanes [Q, 2Q) column lane - Q; at Q =
        // 32 every lane sums its row and its column's registers
        float acc = 0.f;
        if (Q == 32) {
            C = 0.f;
#pragma unroll
            for (int r = 0; r < RW; ++r) C += a[r];
#pragma unroll
            for (int j = 0; j < Q; ++j) acc += st[lane * SP + j];
        } else {
            const bool row = lane < Q;
            const int c = lane - Q < Q ? lane - Q : 0;
#pragma unroll
            for (int j = 0; j < Q; ++j) acc += st[row ? lane * SP + j : j * SP + c];
        }
        sums[lane] = acc;
        __syncwarp();
        // their total in order of the row, and the lane's rows and column
        h = 0.f;
#pragma unroll
        for (int p = 0; p < PM; ++p) h += sums[p];
#pragma unroll
        for (int r = 0; r < RW; ++r) R[r] = sums[grp + L * r < Q ? grp + L * r : 0];
        if (Q < 32) C = sums[Q + q];
        if (AHEAD) x = y;
    }
    cp_async_wait<0>();
}

static size_t forward_smem(int P, int A) {
    return sizeof(float) * ((size_t)P * (P + 1) + 2 * P + A * A + FB_WARPS)
        + sizeof(int) * P;
}

static size_t backward_smem(int P, int A) {
    return sizeof(float) * (2 * (size_t)P * (P + 1) + 2 * P + A * A + P * A + FB_WARPS)
        + sizeof(int) * 2 * P;
}

// One CTA per chain; opts in to the kernel's shared memory, launches on
// the caller's stream and returns the cudaError_t (the entry points have
// checked P).
template <typename Kernel, typename... Args>
static int launch(Kernel kernel, int B, int threads, size_t smem, void* stream,
                  Args... args) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B, threads, smem, (cudaStream_t)stream>>>(args...);
    return (int)cudaGetLastError();
}

// A launch by cudaLaunchKernelEx of `config`; the cudaError_t.
template <typename... Params, typename... Args>
static int launch_ex(void (*kernel)(Params...), const cudaLaunchConfig_t& config,
                     Args... args) {
    int err = (int)cudaLaunchKernelEx(&config, kernel, args...);
    if (err) return err;
    return (int)cudaGetLastError();
}

// The configuration of `blocks` CTAs of `threads` threads and `smem`
// dynamic shared bytes on `stream`, with the attribute `attr` (none
// where null).
static cudaLaunchConfig_t launch_config(int blocks, int threads, size_t smem, void* stream,
                                        cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t config = {};
    config.gridDim.x = blocks;
    config.gridDim.y = config.gridDim.z = 1;
    config.blockDim.x = threads;
    config.blockDim.y = config.blockDim.z = 1;
    config.dynamicSmemBytes = smem;
    config.stream = (cudaStream_t)stream;
    config.attrs = attr;
    config.numAttrs = attr ? 1 : 0;
    return config;
}

// A cluster launch of `blocks` CTAs in clusters of `ranks`, once it has
// opted in to `smem` bytes and cudaOccupancyMaxActiveClusters says one
// such cluster fits the card; else cudaErrorLaunchOutOfResources, and
// nothing runs. With `fits` given, only that reading is written there.
template <typename... Params, typename... Args>
static int launch_cluster(void (*kernel)(Params...), int blocks, int ranks, int threads,
                          size_t smem, void* stream, int* fits, Args... args) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ranks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    const cudaLaunchConfig_t config = launch_config(blocks, threads, smem, stream, attr);
    int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem);
    if (!err && ranks > 8)
        err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err) return err;
    int clusters = 0;
    err = (int)cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
    if (err) return err;
    if (fits) {
        *fits = clusters;
        return 0;
    }
    if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
    return launch_ex(kernel, config, args...);
}

// The grid tier's launch of B chains of `ctas` CTAs: cooperative where a
// chain has more than one CTA, so that a grid the card cannot hold at
// once is refused (cudaErrorCooperativeLaunchTooLarge) instead of
// waiting forever on CTAs that never start.
template <typename... Params, typename... Args>
static int launch_grid(void (*kernel)(Params...), int B, int ctas, int threads, size_t smem,
                       void* stream, Args... args) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem);
    if (err) return err;
    return launch_ex(kernel, launch_config(B * ctas, threads, smem, stream,
                                           ctas > 1 ? attr : nullptr), args...);
}

// The CTAs the card holds at once for the grid tier into `capacity`
// (FBE_GRID_SMS where a build sets it): the SMs x
// cudaOccupancyMaxActiveBlocksPerMultiprocessor of an instance at 1024
// threads and a block's whole shared memory (one an SM; every instance
// takes at most that), read once.
static int fbe_grid_capacity(int* capacity) {
    static int known = -1;
    if (FBE_GRID_SMS > 0) known = FBE_GRID_SMS;
    if (known < 0) {
        void (*kernel)(const float*, const float*, const float*, const float*, const float*,
                       const float*, const int*, const float*, float*, float*, float*, int,
                       int, FbgLayout) = fbe_backward_grid_kernel<0, 1, FBG_GLOBAL>;
        int dev = 0, sms = 0, per_sm = 0;
        int err = (int)cudaGetDevice(&dev);
        if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (!err)
            err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            FBE_SMEM_BYTES);
        if (!err)
            err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, 32 * FBG_WARPS, FBE_SMEM_BYTES);
        if (err) return err;
        known = sms * per_sm;
    }
    *capacity = known;
    return 0;
}

// K3/K4's launch for B chains of P paths (fb_kernels.generic_launch
// mirrors it): up to FB_MAX_PATHS one CTA of FBE_WARPS warps and
// fbe_smem bytes; then the cluster tier's layout (fbe_cluster_layout,
// fbc_smem; no scratch); beyond it the grid tier's (fbg_layout,
// fbg_smem, and its scratch). No CTAs where the grid tier takes none.
struct FbeLaunch {
    bool grid;
    int ranks, threads;
    size_t smem;
};

static FbeLaunch fbe_launch(int P, int B) {
    FbcLayout c;
    if (fbe_cluster_layout(P, B, c)) return {false, c.ranks, 32 * c.warps, fbc_smem(P, c)};
    if (P > FB_MAX_PATHS) {
        FbgLayout g;
        int capacity = 0;
        if (fbe_grid_capacity(&capacity) || !fbg_layout(P, B, capacity, g))
            return {true, 0, 0, 0};
        return {true, g.ctas, 32 * g.groups * g.segs, (size_t)fbg_smem(P, g)};
    }
    return {false, 1, 32 * FBE_WARPS, fbe_smem(P)};
}

static bool fbe_config_ok(int P, int B, int ranks, int threads, int smem,
                          const float* scratch) {
    if (P < 1 || B < 1) return false;
    const FbeLaunch want = fbe_launch(P, B);
    return want.ranks > 0 && ranks == want.ranks && threads == want.threads
        && (size_t)smem == want.smem && (!want.grid || scratch != nullptr);
}

// (RW, NCM) of every cluster-tier instance: rows a warp and column slots
// a lane, at most FBE_CLUSTER_CELLS cells a thread
#define FBC_INSTANCES(X) X(1, 8) X(2, 8) X(1, 16)

// The cluster tier's K3 and K4 for P paths in B chains: launched (fits
// null) or only their cudaOccupancyMaxActiveClusters reading written to
// `fits`.
static int fbe_forward_cluster(const FbcLayout& l, int* fits, const float* E, const float* u,
                               const float* alpha0, float* alphas, float* c_fwd, int B, int N,
                               int P, void* stream) {
#define FBC_FORWARD(RW, NCM)                                                                  \
    if (l.rw == RW && l.ncm == NCM)                                                           \
        return launch_cluster(fbe_forward_cluster_kernel<RW, NCM>, B * l.ranks, l.ranks,      \
                              32 * l.warps, fbc_smem(P, l), stream, fits, E, u, alpha0, alphas, \
                              c_fwd, N, P, l.ranks);
    FBC_INSTANCES(FBC_FORWARD)
#undef FBC_FORWARD
    return (int)cudaErrorInvalidValue;
}

static int fbe_backward_cluster(const FbcLayout& l, int* fits, const float* alphas,
                                const float* c_fwd, const float* E, const float* u,
                                const float* e_after, const float* u_after, const int* is_last,
                                const float* beta0, float* posts, float* beta_out, int B, int N,
                                int P, void* stream) {
#define FBC_BACKWARD(RW, NCM)                                                                 \
    if (l.rw == RW && l.ncm == NCM)                                                           \
        return launch_cluster(fbe_backward_cluster_kernel<RW, NCM>, B * l.ranks, l.ranks,     \
                              32 * l.warps, fbc_smem(P, l), stream, fits, alphas, c_fwd, E, u, \
                              e_after, u_after, is_last, beta0, posts, beta_out, N, P, l.ranks);
    FBC_INSTANCES(FBC_BACKWARD)
#undef FBC_BACKWARD
    return (int)cudaErrorInvalidValue;
}

// (RW, NCM) of every grid-tier instance with the state in registers: at
// most FBG_CELLS cells a thread at NCM = 4, 8 or 16
#define FBG_INSTANCES(X)                                                                \
    X(1, 4) X(2, 4) X(3, 4) X(4, 4) X(5, 4) X(6, 4) X(7, 4) X(8, 4) X(1, 8) X(2, 8) X(3, 8) \
    X(4, 8) X(1, 16) X(2, 16)

// The grid tier's K3 and K4 for B chains of P paths in the layout l.
static int fbe_forward_grid(const FbgLayout& l, const float* E, const float* u,
                            const float* alpha0, float* alphas, float* c_fwd, float* scratch,
                            int B, int N, int P, void* stream) {
    const int threads = 32 * l.groups * l.segs;
    const size_t smem = (size_t)fbg_smem(P, l);
#define FBG_FORWARD(RW, NCM, STORE)                                                   \
    return launch_grid(fbe_forward_grid_kernel<RW, NCM, STORE>, B, l.ctas, threads, smem, \
                       stream, E, u, alpha0, alphas, c_fwd, scratch, N, P, l);
#define FBG_FORWARD_REG(RW, NCM) \
    if (l.store == FBG_REG && l.rw == RW && l.ncm == NCM) FBG_FORWARD(RW, NCM, FBG_REG)
    FBG_INSTANCES(FBG_FORWARD_REG)
    if (l.store == FBG_SMEM) FBG_FORWARD(0, 1, FBG_SMEM)
    if (l.store == FBG_GLOBAL) FBG_FORWARD(0, 1, FBG_GLOBAL)
#undef FBG_FORWARD_REG
#undef FBG_FORWARD
    return (int)cudaErrorInvalidValue;
}

static int fbe_backward_grid(const FbgLayout& l, const float* alphas, const float* c_fwd,
                             const float* E, const float* u, const float* e_after,
                             const float* u_after, const int* is_last, const float* beta0,
                             float* posts, float* beta_out, float* scratch, int B, int N, int P,
                             void* stream) {
    const int threads = 32 * l.groups * l.segs;
    const size_t smem = (size_t)fbg_smem(P, l);
#define FBG_BACKWARD(RW, NCM, STORE)                                                      \
    return launch_grid(fbe_backward_grid_kernel<RW, NCM, STORE>, B, l.ctas, threads, smem,  \
                       stream, alphas, c_fwd, E, u, e_after, u_after, is_last, beta0, posts, \
                       beta_out, scratch, N, P, l);
#define FBG_BACKWARD_REG(RW, NCM) \
    if (l.store == FBG_REG && l.rw == RW && l.ncm == NCM) FBG_BACKWARD(RW, NCM, FBG_REG)
    FBG_INSTANCES(FBG_BACKWARD_REG)
    if (l.store == FBG_SMEM) FBG_BACKWARD(0, 1, FBG_SMEM)
    if (l.store == FBG_GLOBAL) FBG_BACKWARD(0, 1, FBG_GLOBAL)
#undef FBG_BACKWARD_REG
#undef FBG_BACKWARD
    return (int)cudaErrorInvalidValue;
}

// (RW, NC) of every register-tier instance: RW = ceil(P / FBE_WARPS)
// rows a warp and NC = ceil(P / 32) columns a lane, for P up to 128
#define FBE_INSTANCES(X) \
    X(1, 1) X(2, 1) X(3, 2) X(4, 2) X(5, 3) X(6, 3) X(7, 4) X(8, 4)

// (Q, RW) of every K1/K2 warp-tier instance: Q lanes a row (P rounded up
// to a power of two), RW = Q / (32 / Q) rows a lane (at least 1; at Q =
// 32, 24 up to P = 24)
#define FBW_INSTANCES(X) \
    X(1, 1) X(2, 1) X(4, 1) X(8, 2) X(16, 8) X(32, 24) X(32, 32)

// The warp tier's instance for P paths
static void fbw_shape(int P, int& Q, int& RW) {
    Q = 1;
    while (Q < P) Q <<= 1;
    RW = Q < 32 ? (Q * Q + 31) / 32 : (P <= 24 ? 24 : 32);
}

// (Q, RW) of every K1 warp-tier instance: K2's, but 32 rows a lane at P =
// 17..32 (24 rows a lane took 422.6 against 163.3 ms at B=2 N=65,536 P=24
// on an NVIDIA H100 80GB HBM3 at 700 W: tools/k2_times.py --forks, PERF.md)
#define FBF_INSTANCES(X) \
    X(1, 1) X(2, 1) X(4, 1) X(8, 2) X(16, 8) X(32, 32)

extern "C" const char* pg_fb_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// K1's and K2's tier, one rule for both so that they never split a batch:
// the threads of their CTA, 32 (one warp a chain) or FB_THREADS
extern "C" int pg_fb_threads(int P, int A) {
    return P <= FBW_MAX_PATHS && A <= FBW_MAX_ALLELES ? 32 : FB_THREADS;
}

extern "C" int pg_fb_forward(const float* ea, const int* al, const float* trans,
                             float* alphas, float* c_fwd, int B, int N, int P,
                             int A, void* stream) {
    if (A < 1 || P < 1 || P > FB_MAX_PATHS) return (int)cudaErrorInvalidValue;
    if (pg_fb_threads(P, A) == 32) {                     // K1's one-warp tier
        int Q, RW;
        fbw_shape(P, Q, RW);
        if (Q == 32) RW = 32;                            // FBF_INSTANCES
#define FBF_FORWARD(q, rw)                                                   \
        if (Q == q && RW == rw)                                              \
            return launch(fb_forward_warp_kernel<q, rw>, B, 32, fbf_smem(q, rw, A), \
                          stream, ea, al, trans, alphas, c_fwd, N, P, A);
        FBF_INSTANCES(FBF_FORWARD)
#undef FBF_FORWARD
        return (int)cudaErrorInvalidValue;
    }
    return launch(fb_forward_kernel, B, FB_THREADS, forward_smem(P, A), stream,
                  ea, al, trans, alphas, c_fwd, N, P, A);
}

// K1's 256-thread kernel at any P up to FB_MAX_PATHS, which pg_fb_forward
// launches only past the one-warp tier: the reference that the tier's
// outputs equal bit for bit (tests, chip_smoke.py, tools/k2_times.py)
extern "C" int pg_fb_forward_cta(const float* ea, const int* al, const float* trans,
                                 float* alphas, float* c_fwd, int B, int N, int P,
                                 int A, void* stream) {
    if (A < 1 || P < 1 || P > FB_MAX_PATHS) return (int)cudaErrorInvalidValue;
    return launch(fb_forward_kernel, B, FB_THREADS, forward_smem(P, A), stream,
                  ea, al, trans, alphas, c_fwd, N, P, A);
}

extern "C" int pg_fb_backward(const float* alphas, const float* c_fwd,
                              const float* ea, const int* al, const float* trans,
                              const int* is_last, float* posts, int B,
                              int N, int P, int A, void* stream) {
    if (A < 1 || P < 1 || P > FB_MAX_PATHS) return (int)cudaErrorInvalidValue;
    if (pg_fb_threads(P, A) == 32) {
        int Q, RW;
        fbw_shape(P, Q, RW);
        const size_t smem = fbw_smem(P, A);
#define FBW_BACKWARD(q, rw)                                                  \
        if (Q == q && RW == rw)                                              \
            return launch(fb_backward_warp_kernel<q, rw>, B, 32, smem, stream, \
                          alphas, c_fwd, ea, al, trans, is_last, posts, N, P, A);
        FBW_INSTANCES(FBW_BACKWARD)
#undef FBW_BACKWARD
        return (int)cudaErrorInvalidValue;
    }
    return launch(fb_backward_kernel, B, FB_THREADS, backward_smem(P, A), stream,
                  alphas, c_fwd, ea, al, trans, is_last, posts, N, P, A);
}

extern "C" int pg_fbe_forward(const float* E, const float* u, const float* alpha0,
                              float* alphas, float* c_fwd, float* scratch, int B, int N,
                              int P, int ranks, int threads, int smem, void* stream) {
    if (!fbe_config_ok(P, B, ranks, threads, smem, scratch)) return (int)cudaErrorInvalidValue;
    FbcLayout l;
    if (fbe_cluster_layout(P, B, l))
        return fbe_forward_cluster(l, nullptr, E, u, alpha0, alphas, c_fwd, B, N, P, stream);
    FbgLayout g;
    int capacity = 0;
    if (P > FB_MAX_PATHS && !fbe_grid_capacity(&capacity) && fbg_layout(P, B, capacity, g))
        return fbe_forward_grid(g, E, u, alpha0, alphas, c_fwd, scratch, B, N, P, stream);
    const int RW = (P + FBE_WARPS - 1) / FBE_WARPS, NC = (P + 31) / 32;
#define FBE_FORWARD(rw, nc)                                                \
    if (RW == rw && NC == nc)                                              \
        return launch(fbe_forward_kernel<rw, nc>, B, threads, smem, stream, \
                      E, u, alpha0, alphas, c_fwd, N, P);
    FBE_INSTANCES(FBE_FORWARD)
#undef FBE_FORWARD
    return (int)cudaErrorInvalidValue;
}

extern "C" int pg_fbe_backward(const float* alphas, const float* c_fwd,
                               const float* E, const float* u, const float* e_after,
                               const float* u_after, const int* is_last,
                               const float* beta0, float* posts, float* beta_out,
                               float* scratch, int B, int N, int P, int ranks, int threads,
                               int smem, void* stream) {
    if (!fbe_config_ok(P, B, ranks, threads, smem, scratch)) return (int)cudaErrorInvalidValue;
    FbcLayout l;
    if (fbe_cluster_layout(P, B, l))
        return fbe_backward_cluster(l, nullptr, alphas, c_fwd, E, u, e_after, u_after, is_last,
                                    beta0, posts, beta_out, B, N, P, stream);
    FbgLayout g;
    int capacity = 0;
    if (P > FB_MAX_PATHS && !fbe_grid_capacity(&capacity) && fbg_layout(P, B, capacity, g))
        return fbe_backward_grid(g, alphas, c_fwd, E, u, e_after, u_after, is_last, beta0,
                                 posts, beta_out, scratch, B, N, P, stream);
    const int RW = (P + FBE_WARPS - 1) / FBE_WARPS, NC = (P + 31) / 32;
#define FBE_BACKWARD(rw, nc)                                                    \
    if (RW == rw && NC == nc)                                                   \
        return launch(fbe_backward_kernel<rw, nc>, B, threads, smem, stream,    \
                      alphas, c_fwd, E, u, e_after, u_after, is_last, beta0, posts, \
                      beta_out, N, P);
    FBE_INSTANCES(FBE_BACKWARD)
#undef FBE_BACKWARD
    return (int)cudaErrorInvalidValue;
}

// The clusters of K3's (K4's, `backward`) cluster-tier instance for P
// paths in B chains that fit the card at once, by
// cudaOccupancyMaxActiveClusters, into `clusters`; 0 where P does not
// take the cluster tier.
extern "C" int pg_fbe_cluster_fits(int P, int B, int backward, int* clusters) {
    FbcLayout l;
    *clusters = 0;
    if (!fbe_cluster_layout(P, B, l)) return 0;
    return backward ? fbe_backward_cluster(l, clusters, nullptr, nullptr, nullptr, nullptr,
                                           nullptr, nullptr, nullptr, nullptr, nullptr,
                                           nullptr, B, 1, P, nullptr)
                    : fbe_forward_cluster(l, clusters, nullptr, nullptr, nullptr, nullptr,
                                          nullptr, B, 1, P, nullptr);
}

// K3/K4's launch for B chains of P paths into out[0..2]: CTAs a chain,
// threads, dynamic shared bytes (the numbers fbe_config_ok takes).
extern "C" void pg_fbe_launch(int P, int B, int* out) {
    const FbeLaunch l = fbe_launch(P, B);
    out[0] = l.ranks;
    out[1] = l.threads;
    out[2] = (int)l.smem;
}

// The CTAs the card holds at once for the grid tier, into `capacity`;
// the cudaError_t of the reading.
extern "C" int pg_fbe_grid_capacity(int* capacity) { return fbe_grid_capacity(capacity); }

// The grid tier's layout for B chains of P paths where the card holds
// `capacity` CTAs at once, into out[0..9]: CTAs a chain, the most rows a
// band has, row groups, segments, column slots a lane, rows a warp,
// where the state lives (0 registers, 1 shared, 2 global memory), hops
// of the merge, partials in global memory, shared bytes. 0 where P does
// not take the grid tier (at or under 128 paths, or no layout), else 1.
extern "C" int pg_fbe_grid_layout(int P, int B, int capacity, int* out) {
    FbgLayout l;
    if (!fbg_layout(P, B, capacity, l)) return 0;
    const int fields[10] = {l.ctas, l.rows, l.groups, l.segs, l.ncm, l.rw,
                            l.store, l.hops, l.gpart, (int)fbg_smem(P, l)};
    for (int i = 0; i < 10; ++i) out[i] = fields[i];
    return 1;
}
