// Kernel V1, the phasing Viterbi, for Hopper (sm_90a): a CTA of W warps
// a chain, one pass over the columns with backtraces, then the chase, in
// one launch.
//
// Replaces: pangenie_tpu/hmm/viterbi.py:_viterbi_scan (:214, the max-plus
// scan, its last-max final argmax and reverse chase; also the two-pass
// _viterbi_fast, :248, whose states equal the scan's) and, through entry
// and exit carries and a launch without backtraces, the segmented forms
// _viterbi_segment_forward (:385) and _viterbi_segment_backtrace (:401).
// Plain version: pangenie_tpu_torch/hmm/viterbi.py (segment_plain:
// sweep_plain and chase_plain); wrapper: hmm/v1_kernels.py.
//
// What it computes, for B chains of N columns at P <= 32 paths (S = P^2
// states) and A <= 32 alleles, exactly as viterbi_step does: each state
// (p1, p2) takes the best previous state over three classes, stay (lv +
// lt0), switch one (the row and column top-2 statistics of the previous
// column, excluding the state itself, + lt1) and switch both (+ lt2),
// ties to the last argmax and, between classes, to the larger index;
// cur = best + logE[al[p1], al[p2]] (best = 0 at the chain's first
// column, whose backtrace is 0); cur minus its logsumexp, or -log S
// everywhere where that is not finite. The logsumexp is the plain
// version's: the max, then log of the sum of exp(cur - max) in double
// precision, rounded to float once. The max is exact in any order, and
// the double sum of at most 1,024 terms rounds to the same float in any
// order unless it lies within a few double ulps of a float rounding
// boundary, so V1's values are the plain version's bits. Backtraces are
// int16 (S <= 1,024), one per state and column, [B, N, S]; then the chase
// from the last column's last-max argmax (or a given state) follows them
// back to [B, N] states.
//
// What bounds it on the H100: each column depends on the one before, so
// a chain is a serial loop of N steps whose cost is latency — the top-2
// statistics, a double-precision exp a cell, the reductions and the
// barriers between them — not bandwidth (the backtraces, 2 S bytes a
// column, 2 KB at P = 32) or arithmetic. Parallelism across chains comes
// only from the batch (B = 1 or 2 on the main paths), so a column must
// use more of one SM than a warp: one CTA of W warps a chain, W by one
// rule on Q (P rounded up to a power of two), v1_warps below, which
// v1_kernels.warps mirrors (8 warps at 9-32 paths: 4 cells a thread at
// Q = 32).
//
// - Thread t holds column q = t mod Q of the state (padded to Q x Q) and,
//   in registers, the rows t / Q + L r of it (L = 32 W / Q threads a
//   column, RW = Q^2 / (32 W) rows a thread, at least 1): K1's and K2's
//   lane layout in fb.cu, over the CTA. At Q = 32 and W = 8 a warp holds
//   4 whole rows, a thread 4 cells.
// - The top-2 statistics are merge trees. The reference's _top2_last
//   (the max with its LAST index, then the max of the rest with its last
//   index) is the top 2 of the slice under the total order (value,
//   index), then one fix-up at the root: where the second value is -inf,
//   its index is the slice's last (V1Top2::finish). Merging two top-2
//   summaries under a total order is associative and commutative, so any
//   tree over any split of the slice gives _top2_last's bits; nothing
//   walks a runtime P: every tree runs to a compile-time size, entries at
//   indices >= P are left out (an empty leaf, (-inf, -1), loses to every
//   entry, -inf ones too).
//   - columns: each thread's rows of its column in registers, then the
//     warp's lanes of that column by shuffles, then the W warps' partials
//     through shared memory, merged by each thread for its own column;
//   - rows: the state goes to a copy in shared memory (rows of V1_PITCH
//     = 36 floats: 16-byte loads, free of bank conflicts), and G threads
//     a row fold E entries each (16-byte loads, a tree in registers),
//     then merge across their G lanes by shuffles (E = max(min(Q, 8),
//     Q^2 / (32 W)), G = Q / E);
//   - switch both, g[q1, p] = (ra1[q1] == p ? rm2[q1] : rm1[q1]), top-2
//     over q1: the same split over the published row statistics; the
//     stay and switch-one classes of each cell are formed meanwhile.
// - The logsumexp over the CTA: the max by a warp butterfly, then across
//   the warps through shared memory; each thread's double exps with no
//   branch in the loop (an invalid cell's exp(-inf) is 0); the double sum
//   by a warp butterfly, then across the W warps in one fixed order
//   (every thread, and every launch, the same bits); one double log,
//   rounded to float once.
// - Five __syncthreads a column: the state's copy and column partials
//   published (and the column's inputs arrived), the row statistics, the
//   switch-both statistics, the warps' maxima, the warps' sums.
// - A column's [A, A] log emissions, its P alleles and its three log
//   transitions arrive by cp.async in a ring of V1_RING slots in shared
//   memory, issued V1_RING - 1 columns ahead.
// - The backtraces are stored as the cells are computed, threads on
//   consecutive q, so a row of a column is one coalesced store.
// - The chase walks the backtraces from the end in chunks of about 8 KB
//   of columns, copied by the CTA into a ring of V1_CHASE_RING buffers
//   by cp.async ahead of the walk, which thread 0 does in shared memory:
//   no dependent load from device memory per column.
// Allocates nothing; launches on the caller's stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

#define V1_MAX_PATHS 32
#define V1_MAX_ALLELES 32
#define V1_MAX_WARPS 16
#define V1_RING 8
#define V1_HEADER 4                // lt0, lt1, lt2 and a spare word
#define V1_PITCH 36                // the state copy's row pitch (floats)
#define V1_CHASE_BYTES 8192        // a chase chunk's backtraces at most
#define V1_CHASE_RING 4
#define V1_FULL 0xffffffffu

// W, the warps of a chain's CTA, by Q: 8 at Q >= 16 (two a scheduler; 4
// cells a thread at Q = 32, 1 at Q = 16), 2 at Q = 8, 1 below, the fastest
// of 1, 2, 4, 8 and 16 at each Q (tools/v1_times.py --warps, PERF.md).
// -DV1_WARPS=w builds every Q with w warps.
__host__ __device__ constexpr int v1_warps(int Q) {
#ifdef V1_WARPS
    return V1_WARPS;
#else
    return Q >= 16 ? 8 : Q == 8 ? 2 : 1;
#endif
}

extern __shared__ __align__(16) float v1_shm[];

// A top-2 summary: the largest entry and the next under the order
// (value, index), an empty place (-inf, -1).
struct __align__(16) V1Top2 {
    float m1, m2;
    int a1, a2;
    // where every entry but the first is -inf, the second's index is the
    // slice's last, n - 1 (_top2_last's result there)
    __device__ __forceinline__ void finish(int n) {
        if (!(m2 > -INFINITY)) a2 = n - 1;
    }
};

struct __align__(16) V1Quad {
    int x, y, z, w;
};

// (v, i) comes after (w, j) in the order (value, index)
__device__ __forceinline__ bool v1_after(float v, int i, float w, int j) {
    return v > w || (v == w && i > j);
}

// the top 2 of two summaries' entries
__device__ __forceinline__ V1Top2 v1_merge(const V1Top2& x, const V1Top2& y) {
    const bool c = v1_after(x.m1, x.a1, y.m1, y.a1);
    // the second: the loser's first or the winner's second
    const float lm = c ? y.m1 : x.m1, wm = c ? x.m2 : y.m2;
    const int la = c ? y.a1 : x.a1, wa = c ? x.a2 : y.a2;
    const bool d = v1_after(lm, la, wm, wa);
    return {c ? x.m1 : y.m1, d ? lm : wm, c ? x.a1 : y.a1, d ? la : wa};
}

// The summary of E entries x[e] at indices j0 + js e (bit e of `in`: the
// entry counts), as a merge tree.
template <int E>
__device__ __forceinline__ V1Top2 v1_tree(const float (&x)[E], int j0, int js, unsigned in) {
    V1Top2 s[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const bool ok = in >> e & 1;
        s[e] = {ok ? x[e] : -INFINITY, -INFINITY, ok ? j0 + js * e : -1, -1};
    }
#pragma unroll
    for (int h = 1; h < E; h *= 2)
#pragma unroll
        for (int e = 0; e + h < E; e += 2 * h) s[e] = v1_merge(s[e], s[e + h]);
    return s[0];
}

// s merged with lane (lane ^ o)'s, the two indices in one word
__device__ __forceinline__ V1Top2 v1_merge_lane(const V1Top2& s, int o) {
    const int idx = (s.a1 & 0xffff) | (int)((unsigned)s.a2 << 16);
    const int oi = __shfl_xor_sync(V1_FULL, idx, o);
    const V1Top2 other = {__shfl_xor_sync(V1_FULL, s.m1, o), __shfl_xor_sync(V1_FULL, s.m2, o),
                          (int)(short)(oi & 0xffff), oi >> 16};
    return v1_merge(s, other);
}

// E floats of shared memory into registers, in 16-byte loads where E
// allows (src then 16-byte aligned)
template <int E>
__device__ __forceinline__ void v1_load(float (&x)[E], const float* src) {
    if constexpr (E % 4 == 0) {
#pragma unroll
        for (int i = 0; i < E / 4; ++i) {
            const float4 v = reinterpret_cast<const float4*>(src)[i];
            x[4 * i] = v.x;
            x[4 * i + 1] = v.y;
            x[4 * i + 2] = v.z;
            x[4 * i + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int e = 0; e < E; ++e) x[e] = src[e];
    }
}

// (v, j) := the (value, larger index)-lexicographic max of (v, j) and
// (vb, jb) (the reference package's _lex_max)
__device__ __forceinline__ void lex_max(float& v, int& j, float vb, int jb) {
    if (!v1_after(v, j, vb, jb)) {
        v = vb;
        j = jb;
    }
}

// a slot of the ring: header, emissions [A, A], alleles [32] (those of
// paths P to 31 stay 0)
__host__ __device__ __forceinline__ int v1_slot_floats(int A) {
    return V1_HEADER + A * A + 32;
}
// a chase buffer: a chunk at any 4-byte misalignment of its start
__host__ __device__ __forceinline__ int v1_chase_floats() { return (V1_CHASE_BYTES + 16) / 4; }

// Shared memory, in floats from v1_shm: the ring; the state's copy [32,
// V1_PITCH]; the warps' column partials [W, 32]; the row statistics
// [32]; the switch-both statistics [32] and the row statistics' indices
// at their two rows [32]; the warps' maxima, sums (double) and last
// argmaxes [V1_MAX_WARPS each]; the chase ring. Every part 16-byte aligned.
struct V1Smem {
    int st, cpart, rstat, gstat, gidx, wmax, wsum, wlast, chase, total;
    __host__ __device__ V1Smem(int A, int W) {
        st = (V1_RING * v1_slot_floats(A) + 3) / 4 * 4;
        cpart = st + 32 * V1_PITCH;
        rstat = cpart + 4 * 32 * W;
        gstat = rstat + 4 * 32;
        gidx = gstat + 4 * 32;
        wmax = gidx + 4 * 32;
        wsum = wmax + V1_MAX_WARPS;
        wlast = wsum + 2 * V1_MAX_WARPS;
        chase = wlast + V1_MAX_WARPS;
        total = chase + V1_CHASE_RING * v1_chase_floats();
    }
};

template <int Q, int W>
__global__ void __launch_bounds__(32 * W, 1)
v1_viterbi_kernel(const float* __restrict__ logea, const int* __restrict__ al,
                  const float* __restrict__ lt, const float* __restrict__ carry_in,
                  const int* __restrict__ first_in, float* __restrict__ carry_out,
                  int16_t* __restrict__ bt, const int* __restrict__ state_in,
                  int* __restrict__ states, int* __restrict__ state_out, int N, int P, int A,
                  float neg_log_s) {
    constexpr int T = 32 * W;                       // threads of the chain
    constexpr int L = T / Q;                        // threads a column
    constexpr int RW = Q * Q > T ? Q * Q / T : 1;   // rows a thread
    // a row fold's entries a thread and threads a row
    constexpr int E = Q * Q / T > 8 ? Q * Q / T : (Q < 8 ? Q : 8);
    constexpr int G = Q / E;
    constexpr int D = V1_RING;
    static_assert(G <= 32 && Q * G <= T,
                  "a fold's G lanes lie in one warp, its tasks in the CTA");
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5, b = blockIdx.x;
    const int S = P * P, AA = A * A;
    const int q = t & (Q - 1), grp = t / Q;
    const int pitch = v1_slot_floats(A);
    const V1Smem lay(A, W);
    float* st = v1_shm + lay.st;
    V1Top2* cpart = reinterpret_cast<V1Top2*>(v1_shm + lay.cpart);
    V1Top2* rstat = reinterpret_cast<V1Top2*>(v1_shm + lay.rstat);
    V1Top2* gstat = reinterpret_cast<V1Top2*>(v1_shm + lay.gstat);
    V1Quad* gidx = reinterpret_cast<V1Quad*>(v1_shm + lay.gidx);
    float* wmax = v1_shm + lay.wmax;
    double* wsum = reinterpret_cast<double*>(v1_shm + lay.wsum);
    int* wlast = reinterpret_cast<int*>(v1_shm + lay.wlast);
    char* chase_buf = reinterpret_cast<char*>(v1_shm + lay.chase);
    const size_t chain = (size_t)b * N;

    // the thread's rows, and its cells of real paths (bit r: row row[r],
    // column q)
    unsigned valid = 0;
    int row[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
        row[r] = grp + L * r;
        if (q < P && row[r] < P) valid |= 1u << r;
    }
    // this thread's fold task: slice f (a row, then a column), entries
    // [j0, j0 + E) of it, bit e set where entry j0 + e is a real path
    const bool folds = t < Q * G;
    const int f = folds ? t / G : 0, j0 = (t % G) * E;
    unsigned fold_in = 0;
#pragma unroll
    for (int e = 0; e < E; ++e)
        if (j0 + e < P) fold_in |= 1u << e;

    // every slot's alleles 0 (those past P stay so), published before the
    // first copies
    for (int i = t; i < D * pitch; i += T)
        if (i % pitch >= V1_HEADER + AA) ((int*)v1_shm)[i] = 0;
    __syncthreads();

    // column c's inputs into slot c mod D, one 4-byte copy a value spread
    // over the threads; a commit group a call, empty past the last column
    auto fetch = [&](int c) {
        if (c < N) {
            float* s = v1_shm + (c % D) * pitch;
            const float* ea_c = logea + (chain + c) * AA;
            const int* al_c = al + (chain + c) * P;
            const float* lt_c = lt + (chain + c) * 3;
            for (int j = t; j < AA + P + 3; j += T) {
                if (j < AA) cp_async4(s + V1_HEADER + j, ea_c + j);
                else if (j < AA + P) cp_async4(s + V1_HEADER + j, al_c + (j - AA));
                else cp_async4(s + (j - AA - P), lt_c + (j - AA - P));
            }
        }
        cp_async_commit();
    };
    for (int c = 0; c < D - 1; ++c) fetch(c);

    float lv[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r)
        lv[r] = valid >> r & 1 ? carry_in[(size_t)b * S + row[r] * P + q] : -INFINITY;
    bool first = first_in[b] != 0;

    for (int n = 0; n < N; ++n) {
        cp_async_wait<D - 2>();
        // the previous column into the copy, and its column statistics:
        // the thread's rows, then the warp's lanes of the column
#pragma unroll
        for (int r = 0; r < RW; ++r)
            if (valid >> r & 1) st[row[r] * V1_PITCH + q] = lv[r];
        {
            V1Top2 c = v1_tree<RW>(lv, grp, L, valid);
#pragma unroll
            for (int o = Q; o < 32; o *= 2) c = v1_merge_lane(c, o);
            if (lane < Q) cpart[warp * 32 + lane] = c;
        }
        // column n's inputs have arrived (every thread's copies), the copy
        // and the partials are published, and every thread is done with
        // the slot of column n - 1
        __syncthreads();
        fetch(n + D - 1);
        const float* s = v1_shm + (n % D) * pitch;
        const float* eas = s + V1_HEADER;
        const int* als = (const int*)(eas + AA);
        const float lt0 = s[0], lt1 = s[1], lt2 = s[2];
        const int aq = als[q];

        // the row statistics: G threads a row, E entries each
        if (folds) {
            float x[E];
            v1_load(x, st + f * V1_PITCH + j0);
            V1Top2 rs = v1_tree<E>(x, j0, 1, fold_in);
#pragma unroll
            for (int o = 1; o < G; o *= 2) rs = v1_merge_lane(rs, o);
            rs.finish(P);
            if (j0 == 0) rstat[f] = rs;
        }
        // the column statistics of column q: the warps' partials
        V1Top2 col;
        {
            V1Top2 w[W];
#pragma unroll
            for (int i = 0; i < W; ++i) w[i] = cpart[i * 32 + q];
#pragma unroll
            for (int h = 1; h < W; h *= 2)
#pragma unroll
                for (int i = 0; i + h < W; i += 2 * h) w[i] = v1_merge(w[i], w[i + h]);
            col = w[0];
            col.finish(P);
        }
        __syncthreads();

        // the switch-both statistics of column f: the top 2 over rows q1
        // of g[q1, f], row q1's best off column f (its second where its
        // best sits at f), with the row statistics of the two rows they
        // name
        if (folds) {
            float x[E];
#pragma unroll
            for (int e = 0; e < E; ++e) {
                const V1Top2 r = rstat[j0 + e];
                x[e] = r.a1 == f ? r.m2 : r.m1;
            }
            V1Top2 g = v1_tree<E>(x, j0, 1, fold_in);
#pragma unroll
            for (int o = 1; o < G; o *= 2) g = v1_merge_lane(g, o);
            g.finish(P);
            if (j0 == 0) {
                const V1Top2 r1 = rstat[g.a1], r2 = rstat[g.a2];
                gstat[f] = g;
                gidx[f] = {r1.a1, r1.a2, r2.a1, r2.a2};
            }
        }
        // meanwhile the stay and switch-one classes of the thread's cells
        float v[RW];
        int j[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
            const int p = row[r] < Q ? row[r] : Q - 1;
            const V1Top2 rs = rstat[p];
            // stay both
            v[r] = lv[r] + lt0;
            j[r] = p * P + q;
            // switch one: (p, q2 != q) or (q1 != p, q)
            const bool ex = rs.a1 == q;
            float v1 = ex ? rs.m2 : rs.m1;
            int j1 = p * P + (ex ? rs.a2 : rs.a1);
            const bool ey = col.a1 == p;
            lex_max(v1, j1, ey ? col.m2 : col.m1, (ey ? col.a2 : col.a1) * P + q);
            lex_max(v[r], j[r], v1 + lt1, j1);
        }
        __syncthreads();

        // switch both: q1 != p and q2 != q; the new values and the
        // backtraces
        const V1Top2 gq = gstat[q];
        const V1Quad gi = gidx[q];
        int16_t* bt_n = bt ? bt + (chain + n) * S : nullptr;
        float cur[RW];
        float mx = -INFINITY;
#pragma unroll
        for (int r = 0; r < RW; ++r) {
            const int p = row[r] < Q ? row[r] : Q - 1;
            const bool hit = gq.a1 == p;
            const int ra1_at = hit ? gi.z : gi.x, ra2_at = hit ? gi.w : gi.y;
            lex_max(v[r], j[r], (hit ? gq.m2 : gq.m1) + lt2,
                    (hit ? gq.a2 : gq.a1) * P + (ra1_at == q ? ra2_at : ra1_at));
            const float e = eas[als[p] * A + aq];
            cur[r] = valid >> r & 1 ? (first ? 0.f : v[r]) + e : -INFINITY;
            mx = fmaxf(mx, cur[r]);
            if (bt_n && (valid >> r & 1)) bt_n[p * P + q] = (int16_t)(first ? 0 : j[r]);
        }
        // the column's logsumexp: the max over the CTA, then the double
        // sum, warps merged in one fixed order (every thread the same bits)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(V1_FULL, mx, o));
        if (lane == 0) wmax[warp] = mx;
        __syncthreads();
        mx = wmax[0];
#pragma unroll
        for (int i = 1; i < W; ++i) mx = fmaxf(mx, wmax[i]);
        double sum = 0.0;
        if (mx > -INFINITY) {
            const double md = mx;
#pragma unroll
            for (int r = 0; r < RW; ++r) sum += exp((double)cur[r] - md);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(V1_FULL, sum, o);
        }
        if (lane == 0) wsum[warp] = sum;
        __syncthreads();
        float lse = -INFINITY;
        if (mx > -INFINITY) {
            double total = wsum[0];
#pragma unroll
            for (int i = 1; i < W; ++i) total += wsum[i];
            lse = (float)(log(total) + (double)mx);
        }
        const bool ok = isfinite(lse);
#pragma unroll
        for (int r = 0; r < RW; ++r)
            lv[r] = valid >> r & 1 ? (ok ? cur[r] - lse : neg_log_s) : -INFINITY;
        first = false;
    }
    cp_async_wait<0>();

#pragma unroll
    for (int r = 0; r < RW; ++r)
        if (valid >> r & 1) carry_out[(size_t)b * S + row[r] * P + q] = lv[r];
    if (!bt) return;

    // The chase: from the last column's last-max argmax (or state_in)
    // back over the backtraces, a chunk of CH columns at a time from the
    // end: chunk k holds columns [max(0, N - (k + 1) CH), N - k CH), copied
    // in 4-byte words from the word that holds its first entry.
    float best = -INFINITY;
#pragma unroll
    for (int r = 0; r < RW; ++r)
        if (valid >> r & 1) best = fmaxf(best, lv[r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) best = fmaxf(best, __shfl_xor_sync(V1_FULL, best, o));
    if (lane == 0) wmax[warp] = best;
    __syncthreads();
    best = wmax[0];
#pragma unroll
    for (int i = 1; i < W; ++i) best = fmaxf(best, wmax[i]);
    int last = -1;
#pragma unroll
    for (int r = 0; r < RW; ++r)
        if ((valid >> r & 1) && lv[r] == best) last = max(last, row[r] * P + q);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) last = max(last, __shfl_xor_sync(V1_FULL, last, o));
    if (lane == 0) wlast[warp] = last;
    // (this barrier also orders every thread's backtrace stores before
    // the copies below)
    __syncthreads();
    last = wlast[0];
#pragma unroll
    for (int i = 1; i < W; ++i) last = max(last, wlast[i]);
    int state = state_in[b] >= 0 ? state_in[b] : last;

    const int CH = max(1, V1_CHASE_BYTES / (2 * S));
    const int chunks = (N + CH - 1) / CH;
    const char* bt_b = (const char*)(bt + chain * S);
    auto fetch_chunk = [&](int k) {
        if (k < chunks) {
            const int lo = max(0, N - (k + 1) * CH), hi = N - k * CH;
            const uintptr_t start = (uintptr_t)(bt_b + (size_t)lo * S * 2);
            const uintptr_t word0 = start & ~(uintptr_t)3;
            const int words = (int)((start + (size_t)(hi - lo) * S * 2 - word0 + 3) / 4);
            float* dst = (float*)chase_buf + (k % V1_CHASE_RING) * v1_chase_floats();
            for (int w = t; w < words; w += T) cp_async4(dst + w, (const float*)word0 + w);
        }
        cp_async_commit();
    };
    for (int k = 0; k < V1_CHASE_RING - 1; ++k) fetch_chunk(k);
    int* states_b = states + chain;
    for (int k = 0; k < chunks; ++k) {
        cp_async_wait<V1_CHASE_RING - 2>();
        __syncthreads();
        fetch_chunk(k + V1_CHASE_RING - 1);
        if (t == 0) {
            const int lo = max(0, N - (k + 1) * CH), hi = N - k * CH;
            const uintptr_t start = (uintptr_t)(bt_b + (size_t)lo * S * 2);
            const int16_t* col = (const int16_t*)((const char*)chase_buf
                                                  + (k % V1_CHASE_RING) * 4 * v1_chase_floats()
                                                  + (start & 3));
            for (int n = hi - 1; n >= lo; --n) {
                states_b[n] = state;
                state = col[(size_t)(n - lo) * S + state];
            }
        }
    }
    cp_async_wait<0>();
    if (t == 0) state_out[b] = state;
}

// One CTA of `threads` a chain; opts in to the kernel's shared memory,
// launches on the caller's stream and returns the cudaError_t.
template <typename Kernel, typename... Args>
static int launch(Kernel kernel, int B, int threads, size_t smem, void* stream, Args... args) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B, threads, smem, (cudaStream_t)stream>>>(args...);
    return (int)cudaGetLastError();
}

extern "C" const char* pg_v1_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

static int v1_q(int P) {
    int Q = 1;
    while (Q < P) Q <<= 1;
    return Q;
}

// The warps of V1's CTA at P paths (v1_kernels.warps mirrors it), 0
// past V1_MAX_PATHS.
extern "C" int pg_v1_warps(int P) {
    return P >= 1 && P <= V1_MAX_PATHS ? v1_warps(v1_q(P)) : 0;
}

// V1 for B chains of N columns, P paths and A alleles: logea [B, N, A, A],
// al [B, N, P] int32, lt [B, N, 3], carry_in [B, S] and first_in [B] int32
// in; carry_out [B, S] out. With bt (B N S int16 and two spare entries)
// also the backtraces, and the chase from state_in [B] (-1: the last
// column's last-max argmax) to states [B, N] and state_out [B] (the
// backtrace at column 0 of the state there); without, neither.
extern "C" int pg_v1_viterbi(const float* logea, const int* al, const float* lt,
                             const float* carry_in, const int* first_in, float* carry_out,
                             int16_t* bt, const int* state_in, int* states, int* state_out,
                             int B, int N, int P, int A, float neg_log_s, void* stream) {
    if (B < 1 || N < 1 || P < 1 || P > V1_MAX_PATHS || A < 1 || A > V1_MAX_ALLELES)
        return (int)cudaErrorInvalidValue;
    if (bt && !(state_in && states && state_out)) return (int)cudaErrorInvalidValue;
    const int Q = v1_q(P);
#define V1_LAUNCH(q)                                                                       \
    if (Q == q)                                                                            \
        return launch(v1_viterbi_kernel<q, v1_warps(q)>, B, 32 * v1_warps(q),              \
                      sizeof(float) * V1Smem(A, v1_warps(q)).total, stream, logea, al, lt, \
                      carry_in, first_in, carry_out, bt, state_in, states, state_out, N, P, \
                      A, neg_log_s);
    V1_LAUNCH(1) V1_LAUNCH(2) V1_LAUNCH(4) V1_LAUNCH(8) V1_LAUNCH(16) V1_LAUNCH(32)
#undef V1_LAUNCH
    return (int)cudaErrorInvalidValue;
}
