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
// so a chain is a serial loop of N steps whose cost is latency — block
// barriers, reductions over the [P, P] state and the wait for each
// column's inputs — not bandwidth (K1 at P=16: 1 KB of alpha written per
// column) or arithmetic. K3/K4 also stream E, alpha and the raw
// posteriors through global memory: 63 KB (K3) and 95 KB (K4) per column
// at P=89, from one SM. Parallelism comes only from the batch: one CTA
// per chain, so B=1 (a long chromosome's chunk) occupies 1 of 132 SMs.
//
// K1/K2: the whole [P, P] f32 state stays in shared memory for the
// entire sweep (row pitch P+1 so the per-row reductions are free of
// bank conflicts). Row sums / column sums / total are taken in a fixed
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
// Their design, against what made a column slow:
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
//   that column's mix. K4 reduces g = cur_n * E_n (the next column's
//   helper, beta_n * E_n, times s_n) and the total s_n of cur in the
//   pass that computes cur_n, and folds 1/s_n into the next mix. One
//   warp sums the totals and takes 1/s once for the block. Where s <= 0
//   the state becomes uniform exactly as in the plain versions (K4 then
//   reduces uniform * E_n once more, a branch the whole block takes
//   together); padding columns (E = 0) take that branch.
// - Sums in a fixed order and no float atomics: a launch repeats its
//   results bit for bit.
// Allocates nothing; launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

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

// ---- K3/K4 ----

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
    int wcur;         // [32] each warp's total of cur (K4)
    int tot;          // [4] total of the reduced state, 1 / the normalizer
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
    s.wcur = s.wsum + 32;
    s.tot = s.wcur + 32;
    return s;
}

static size_t fbe_smem(int P) {
    return sizeof(float) * ((size_t)FBE_RING * (FBE_HEADER + fbe_column_floats(P))
                            + fbe_column_floats(P) + (size_t)FBE_WARPS * fbe_part_pitch(P)
                            + P + 68);
}

// First half of a reduction, no barrier: the row sums of v into R (every
// lane of the warp gets them), the warp's column partials and its total
// into shared memory; with `cur` also the warp's total of cur_sum.
template <int RW, int NC>
__device__ __forceinline__ void reduce_warp(const float (&v)[RW][NC], float (&R)[RW],
                                            const Cells<RW, NC>& c, const FbeSmem& s,
                                            float cur_sum, bool cur) {
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
    if (cur) cur_sum = warp_sum(cur_sum);
    if (c.lane == 0) {
        fbe_shm[s.wsum + c.w] = tot;
        if (cur) fbe_shm[s.wcur + c.w] = cur_sum;
    }
}

// Second half, after a barrier. Column sums: four lanes per column, each
// over every fourth warp, then two shuffles (threads [0, 4P)). The last
// warp sums the warps' totals: tot[0] the state's, tot[1] 1 / the
// normalizer (the state's total, or with `cur` the total of cur; 1 where
// that is not positive), tot[2] the normalizer. Each sum in a fixed order.
__device__ __forceinline__ void reduce_block(const FbeSmem& s, int P, bool cur) {
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
        const float z = cur ? warp_sum(lane < W ? fbe_shm[s.wcur + lane] : 0.f) : h;
        if (lane == 0) {
            fbe_shm[s.tot + 0] = h;
            fbe_shm[s.tot + 1] = z > 0.f ? 1.f / z : 1.f;
            fbe_shm[s.tot + 2] = z;
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
    reduce_warp(a, R, c, s, 0.f, false);
    cp_async_wait<D - 1>();                               // column 0
    __syncthreads();
    reduce_block(s, P, false);
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
        reduce_warp(a, R, c, s, 0.f, false);
        __syncthreads();
        // every thread is done with the slot: column n + D takes it
        if (n + D < N) fetch(n + D, slot);
        cp_async_commit();
        cp_async_wait<D - 1>();                           // column n + 1
        slot = slot + 1 == D ? 0 : slot + 1;
        if (n > 0) store_column(alpha_b + (size_t)(n - 1) * PP, fbe_shm + s.stage, PP);
        reduce_block(s, P, false);
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
    // g: the helper of the column ahead times the total of its beta
    // (helper = g * inv); R its row sums, s.col its column sums, H its
    // total. a: alpha of the column being computed, loaded a column ahead.
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
    reduce_warp(g, R, c, s, 0.f, false);
    cp_async_wait<D - 1>();                               // column N-1
    __syncthreads();
    reduce_block(s, P, false);
    __syncthreads();
    float H = fbe_shm[s.tot + 0], inv = 1.f, z = 1.f;   // beta0 is normalized
    float u0 = u_after[(size_t)b * 3], u1 = u_after[(size_t)b * 3 + 1],
          u2 = u_after[(size_t)b * 3 + 2];
    int slot = 0;

    for (int n = N - 1; n >= 0; --n) {
        const float* hdr = fbe_shm + (size_t)slot * s.slot_pitch;
        const float* e = hdr + FBE_HEADER + misalign(e_b + (size_t)n * PP);
        const float cf = hdr[3];
        const bool last = ((const int*)hdr)[4] != 0;
        const float* a_next = alpha_b + (size_t)(n > 0 ? n - 1 : 0) * PP;
        float* st = fbe_shm + s.stage + misalign(post_b + (size_t)n * PP);
        const float hh = u2 * H;
        // the column sums, read once into registers; at NC = 4, where four
        // more registers would spill, each cell reads its own from shared
        // memory instead
        auto col_sum = [&](int k) {
            const int q = c.lane + 32 * k;
            return q < P ? fbe_shm[s.col + q] : 0.f;
        };
        float csum = 0.f, C[NC];
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
                float cur = last ? 1.f : inv * (u0 * g[r][k] + u1 * (R[r] + ck) + hh);
                cur = ok ? cur : 0.f;
                // the raw posterior takes the un-normalized cur
                if (ok) st[row + 32 * k] = a[r][k] * cur * cf;
                // at column 0, a keeps cur for beta_out
                a[r][k] = n > 0 ? (ok ? a_row[32 * k] : 0.f) : cur;
                csum += cur;
                g[r][k] = cur * (ok ? e[row + 32 * k] : 0.f);
            }
        }
        reduce_warp(g, R, c, s, csum, true);
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
        reduce_block(s, P, true);
        __syncthreads();
        H = fbe_shm[s.tot + 0];
        inv = fbe_shm[s.tot + 1];
        z = fbe_shm[s.tot + 2];
        if (!(z > 0.f) && n > 0) {
            // beta_n is uniform, so the next helper is uniform * E_n; the
            // whole block sees the same total and takes this branch
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
    // the normalized beta after the chunk's first column
    float* bo = beta_out + (size_t)b * PP;
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int k = 0; k < NC; ++k)
            if (c.ok(r, k)) bo[c.at(r, k)] = z > 0.f ? a[r][k] * inv : uniform;
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

// One CTA per chain; checks P, opts in to the kernel's shared memory,
// launches on the caller's stream and returns the cudaError_t.
template <typename Kernel, typename... Args>
static int launch(Kernel kernel, int B, int P, int threads, size_t smem, void* stream,
                  Args... args) {
    if (P < 1 || P > FB_MAX_PATHS) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B, threads, smem, (cudaStream_t)stream>>>(args...);
    return (int)cudaGetLastError();
}

// K3/K4's launch as fb_kernels.generic_launch derives it: FBE_WARPS
// warps and fbe_smem bytes.
static bool fbe_config_ok(int P, int threads, int smem) {
    return P >= 1 && P <= FB_MAX_PATHS && threads == 32 * FBE_WARPS
        && (size_t)smem == fbe_smem(P);
}

// (RW, NC) of every instance: RW = ceil(P / FBE_WARPS) rows a warp and
// NC = ceil(P / 32) columns a lane, for P up to 128
#define FBE_INSTANCES(X) \
    X(1, 1) X(2, 1) X(3, 2) X(4, 2) X(5, 3) X(6, 3) X(7, 4) X(8, 4)

extern "C" const char* pg_fb_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

extern "C" int pg_fb_forward(const float* ea, const int* al, const float* trans,
                             float* alphas, float* c_fwd, int B, int N, int P,
                             int A, void* stream) {
    if (A < 1) return (int)cudaErrorInvalidValue;
    return launch(fb_forward_kernel, B, P, FB_THREADS, forward_smem(P, A), stream,
                  ea, al, trans, alphas, c_fwd, N, P, A);
}

extern "C" int pg_fb_backward(const float* alphas, const float* c_fwd,
                              const float* ea, const int* al, const float* trans,
                              const unsigned char* is_last, float* posts, int B,
                              int N, int P, int A, void* stream) {
    if (A < 1) return (int)cudaErrorInvalidValue;
    return launch(fb_backward_kernel, B, P, FB_THREADS, backward_smem(P, A), stream,
                  alphas, c_fwd, ea, al, trans, is_last, posts, N, P, A);
}

extern "C" int pg_fbe_forward(const float* E, const float* u, const float* alpha0,
                              float* alphas, float* c_fwd, int B, int N, int P,
                              int threads, int smem, void* stream) {
    if (!fbe_config_ok(P, threads, smem)) return (int)cudaErrorInvalidValue;
    const int RW = (P + FBE_WARPS - 1) / FBE_WARPS, NC = (P + 31) / 32;
#define FBE_FORWARD(rw, nc)                                                   \
    if (RW == rw && NC == nc)                                                 \
        return launch(fbe_forward_kernel<rw, nc>, B, P, threads, smem, stream, \
                      E, u, alpha0, alphas, c_fwd, N, P);
    FBE_INSTANCES(FBE_FORWARD)
#undef FBE_FORWARD
    return (int)cudaErrorInvalidValue;
}

extern "C" int pg_fbe_backward(const float* alphas, const float* c_fwd,
                               const float* E, const float* u, const float* e_after,
                               const float* u_after, const int* is_last,
                               const float* beta0, float* posts, float* beta_out,
                               int B, int N, int P, int threads, int smem,
                               void* stream) {
    if (!fbe_config_ok(P, threads, smem)) return (int)cudaErrorInvalidValue;
    const int RW = (P + FBE_WARPS - 1) / FBE_WARPS, NC = (P + 31) / 32;
#define FBE_BACKWARD(rw, nc)                                                   \
    if (RW == rw && NC == nc)                                                  \
        return launch(fbe_backward_kernel<rw, nc>, B, P, threads, smem, stream, \
                      alphas, c_fwd, E, u, e_after, u_after, is_last, beta0, posts, \
                      beta_out, N, P);
    FBE_INSTANCES(FBE_BACKWARD)
#undef FBE_BACKWARD
    return (int)cudaErrorInvalidValue;
}
