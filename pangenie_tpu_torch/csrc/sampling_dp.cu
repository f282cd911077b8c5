// Kernel S1: one masked single-path min-plus Viterbi iteration of the
// greedy haplotype sampler, for Hopper (sm_90a): a forward sweep that
// keeps backtraces, then a parallel chase of the path through them. The
// same two kernels run the checkpointed scan (S1-seg) for chromosomes
// beyond one card: the sweep takes an entry score row and writes an exit
// score row, may keep no backtraces, and the chase starts from given
// states and hands back the state before its first column.
//
// Replaces: pangenie_tpu/hmm/sampling.py:_viterbi_iteration (the column
// scan, :174, and its chase, :232) and :_blocked_viterbi (its blocked TPU
// formulation, bit-identical to the scan by construction), both XLA, run
// per greedy iteration by :_sample_group; and :_viterbi_iteration_segmented
// (:652) with :_segment_forward (:574) and :_segment_backtrace (:604).
// Plain versions: pangenie_tpu_torch/hmm/sampling.py (sweep_plain,
// chase_plain, viterbi_iteration_plain).
//
// What bounds it on the H100: the sweep is a serial chain over N columns;
// a column is one reduction over the P paths and a few integer operations
// a path, and moves ~5P bytes. So latency, and for one warp the count of
// its instructions, not bandwidth or arithmetic: the design shortens the
// chain and keeps what is not on it off it.
//
// Sweep, in three tiers by P (sweep_layout):
// - P <= 128: one CTA per chromosome, one warp, each lane holding R =
//   ceil(P/32) consecutive paths in registers, so lane order is path
//   order. No barrier. Only the column minimum is on the chain (one
//   __reduce_min_sync, redux.sync): the scores' recurrence needs nothing
//   else, and the lane's next minimum follows from it in three operations
//   (see s1_sweep_kernel). The first path at the minimum, which only the
//   backtraces need, is one more reduction off the chain, and the next
//   path at it another, only before a column whose switch is free.
//   P <= 1024: W = ceil(P/128)
//   warps of 4 paths a lane merge theirs through double-buffered shared
//   partials, one barrier a column, each thread reading the W partials.
// - P <= 65,536 (S1_CLUSTER_PATHS): a thread-block cluster of K CTAs per
//   chromosome, CTA k sweeping the k-th contiguous slice of the paths
//   with the code above: W = ceil(P/(8*128)) warps of 4 paths a lane
//   (ceil(P/(16*128)) where 8 CTAs of 32 warps would not hold the paths),
//   then K = ceil(P/(128*W)) <= 8 (16) CTAs of W warps, so no CTA holds
//   only padding; past 8 warps W is a runtime value, one instance with a
//   ring of S1_WIDE_DEPTH columns, as 1024 threads leave 64 registers a
//   thread. So K SMs share the column's work (on an H100 the cluster of 6
//   CTAs of 3 warps is 1.49x faster than one CTA of 17 warps at P=2049,
//   8 of 4 2.3x than one of 32 at P=4096: tools/s1_times.py --wide against
//   a checkout from before the cluster; --ranks builds the source with
//   other S1_CLUSTER_RANKS and times those). The one new step on the chain
//   is the cluster's merge (cluster_col): every warp
//   pushes its (m1, f1, g) into the shared memory of every CTA of the
//   cluster (st.async, csrc/cluster.cuh), each CTA waits on its own
//   mbarrier alone, and every warp merges the K x W partials from its own
//   shared memory. CTA order is path order, so the first-minimum rule and
//   the padding carry over unchanged.
// - P > 65,536: one CTA of
//   1024 threads, thread t holding paths t, t + 1024, ..., their scores
//   in a global scratch row [C, P] (L2-resident). A thread keeps the
//   first two of its paths at its minimum as it walks them; warps and
//   block merge as above. Columns S1_AHEAD ahead are prefetched into L2.
// - No load on the column's chain in the register tiers: cost, mask and
//   switch of column n + depth are loaded into a register ring while
//   column n reduces.
// - Backtraces uint8 (P <= 256), uint16 (P <= 65,536) or uint32, rows of
//   K*32*W*R entries (entry p of a row is path p's, the padding at the
//   end); a lane's R entries leave as one store where they make 1, 2, 4
//   or 8 bytes.
// Chase, N columns cut into S segments of L (hmm/sampling.py picks L):
// - s1_maps_kernel: for every segment but the first and every state at
//   its last column, follow its L backtraces to the state at the column
//   before it: C x (S-1) x P independent chains across the SMs;
// - s1_rewalk_kernel: one thread per segment composes the maps of the
//   segments after it, from the given end state, then re-walks its own
//   segment writing the path. The path is the serial chase's by
//   construction.
// Rules of the column scan, kept bit for bit: uint32 scores with
// saturating adds; a masked path's score is UMAX; the first minimum is
// the lowest index among equal scores (padding paths, past P, never
// win); the second minimum is the first minimum of the column with the
// first's score replaced by UMAX; a path stays only on strict '<';
// column 0 is score 0 and backtrace 0 unless an entry row carries the
// previous column's scores; the last column's first minimum ends the
// path and its score is `best`. Allocates nothing; launches on the
// caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"

#define UMAX 0xFFFFFFFFu
#define NONE 0xFFFFFFFFu  // the index of no path: above every real one
#define FULL_MASK 0xFFFFFFFFu
// one CTA's edge: 8 warps of 4 paths a lane; and what a CTA holds in
// registers: 32 warps of 4 paths a lane
#define S1_CTA_PATHS 1024
#define S1_REGISTER_PATHS 4096
// the cluster tier: up to S1_CLUSTER_RANKS CTAs a chromosome, or up to
// S1_MAX_RANKS (the non-portable cluster size) where that many CTAs of
// 32 warps would not hold the paths; past S1_CLUSTER_PATHS, one CTA
// (tools/s1_times.py builds other S1_CLUSTER_RANKS to time them)
#ifndef S1_CLUSTER_RANKS
#define S1_CLUSTER_RANKS 8
#endif
#define S1_MAX_RANKS 16
#define S1_CLUSTER_PATHS (S1_MAX_RANKS * S1_REGISTER_PATHS)
// columns in flight in the register ring, up to 8 warps a CTA and above
#define S1_DEPTH 8
#define S1_WIDE_DEPTH 2
// threads of the CTA past S1_CLUSTER_PATHS and its partials' words:
// [2][32][4]
#define S1_THREADS 1024
#define S1_PART_WORDS (2 * 4 * 32)
// columns the one-CTA tier past S1_CLUSTER_PATHS prefetches into L2
// ahead of the one it sweeps,
// and the paths a thread loads together
#define S1_AHEAD 8
#define S1_UNROLL 8
#ifndef PREFETCH_L2
#define PREFETCH_L2(p) asm volatile("prefetch.global.L2 [%0];" ::"l"(p))
#endif

typedef unsigned long long u64;

// the multi-warp sweeps' partials: [2 buffers][warps][m1, f1, g, -]
extern __shared__ __align__(16) u64 s1_shm[];

// min(a + b, UMAX) as uint32: where a > ~b the sum overflows and
// ~b + b = UMAX. Two dependent operations after `a` when ~b is ready.
__device__ __forceinline__ unsigned sat_add(unsigned a, unsigned b) {
    return min(a, ~b) + b;
}

// A column's minimum score m1, its first path f1, and g, the next path
// at m1 (NONE if f1 is the only one).
struct Col {
    unsigned m1, f1, g;
};

// The warp's Col, where the lane holds paths first..first+R-1 and
// lane_min is the least of their scores. Only m1 is on the sweep's
// chain; f1 and g feed the backtraces, and g only where the next
// column's switch is free (`need_g`, the same in every thread).
template <int R>
__device__ __forceinline__ Col warp_col(const unsigned (&score)[R], unsigned lane_min,
                                        unsigned first, bool need_g) {
    const unsigned m1 = __reduce_min_sync(FULL_MASK, lane_min);
    unsigned i1 = NONE, i2 = NONE;  // the lane's first two paths at m1
#pragma unroll
    for (int j = R - 1; j >= 0; --j) {
        if (score[j] == m1) {
            i2 = i1;
            i1 = first + j;
        }
    }
    const unsigned f1 = __reduce_min_sync(FULL_MASK, i1);
    // lane order is path order: g is the holder's second path at m1 or
    // the lowest first path at m1 of the other lanes
    const unsigned g = need_g ? __reduce_min_sync(FULL_MASK, i1 == f1 ? i2 : i1) : NONE;
    return {m1, f1, g};
}

// The warp's Col where each lane brings its own least score m and its
// first two paths at m, i1 < i2 (in any order across lanes): the second
// path at m1 is the holder's i2 or the least i1 of the other lanes at m1.
__device__ __forceinline__ Col lane_merge(unsigned m, unsigned i1, unsigned i2, bool need_g) {
    const unsigned m1 = __reduce_min_sync(FULL_MASK, m);
    if (m != m1) i1 = i2 = NONE;
    const unsigned f1 = __reduce_min_sync(FULL_MASK, i1);
    const unsigned g = need_g ? __reduce_min_sync(FULL_MASK, i1 == f1 ? i2 : i1) : NONE;
    return {m1, f1, g};
}

// The block's Col from its warps' (at most 32), every warp merging the
// partials in its lanes; `step` alternates the partials' buffer.
__device__ __forceinline__ Col block_merge(const Col c, int step, bool need_g) {
    unsigned* part = reinterpret_cast<unsigned*>(s1_shm) + (step & 1) * 4 * 32;
    const unsigned lane = threadIdx.x & 31, warps = blockDim.x >> 5;
    if (lane == 0) {
        part[4 * (threadIdx.x >> 5)] = c.m1;
        part[4 * (threadIdx.x >> 5) + 1] = c.f1;
        part[4 * (threadIdx.x >> 5) + 2] = c.g;
    }
    __syncthreads();
    unsigned m = UMAX, i1 = NONE, i2 = NONE;
    if (lane < warps) {
        m = part[4 * lane];
        i1 = part[4 * lane + 1];
        i2 = part[4 * lane + 2];
    }
    return lane_merge(m, i1, i2, need_g);
}

// The block's Col from its W <= 8 warps; `step` alternates the
// partials' buffer; every thread reads the W partials.
template <int R, int W>
__device__ __forceinline__ Col block_col(const unsigned (&score)[R], unsigned lane_min,
                                         unsigned first, int step, bool need_g) {
    const Col c = warp_col<R>(score, lane_min, first, need_g);
    if constexpr (W == 1) {
        return c;
    } else {
        unsigned* part = reinterpret_cast<unsigned*>(s1_shm) + (step & 1) * 4 * W;
        const int warp = threadIdx.x >> 5;
        if ((threadIdx.x & 31) == 0) {
            part[4 * warp] = c.m1;
            part[4 * warp + 1] = c.f1;
            part[4 * warp + 2] = c.g;
        }
        __syncthreads();
        unsigned m1 = part[0], f1 = NONE, g = NONE;
#pragma unroll
        for (int w = 1; w < W; ++w) m1 = min(m1, part[4 * w]);
        // warps in path order: the first warp at m1 gives f1 and its g,
        // or the next warp at m1 its first path
#pragma unroll
        for (int w = 0; w < W; ++w) {
            if (part[4 * w] != m1) continue;
            if (f1 == NONE) {
                f1 = part[4 * w + 1];
                g = part[4 * w + 2];
            } else if (g == NONE) {
                g = part[4 * w + 1];
            }
        }
        return {m1, f1, g};
    }
}

// The cluster's Col from its CTAs' warps (each CTA W of them, W = 0: up
// to 32, blockDim.x / 32), given the warp's own Col c. Dynamic shared
// memory holds two mbarriers, then two buffers of ranks x W partials
// (buffer step & 1). Thread 0 arms this CTA's mbarrier of the buffer with
// the ranks x W x 16 bytes it expects; lanes 0..ranks-1 of every warp
// push the warp's partial into slot rank x W + warp of that buffer in
// CTA `lane` (st.async, which completes 16 bytes on that CTA's mbarrier);
// every thread runs `between` (work off the chain: the backtraces'
// store, the ring's next loads) and waits on its own CTA's mbarrier
// alone; then lane l of every warp reads partials l, l + 32, ... from its
// own shared memory, keeping the least score and its first two paths,
// and the lanes merge theirs (lane_merge: the partials need no order).
// `phases` holds each mbarrier's phase parity. A CTA pushes into buffer
// step & 1 again two columns later, after the next column's wait, which
// completes only once every warp of the cluster has pushed that column,
// so after it has read this one. (A cluster barrier in place of the
// mbarriers, every warp then reading the partials through distributed
// shared memory, took 1.48 us a column over the warps' own reductions on
// an H100 at 8 CTAs, the push 0.42: tools/s1_cluster_merge.py.)
template <int W, typename F>
__device__ __forceinline__ Col cluster_col(const Col c, int step, bool need_g, unsigned rank,
                                           unsigned ranks, unsigned& phases, F&& between) {
    const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned warps = W ? W : blockDim.x >> 5, total = ranks * warps;
    const unsigned b = step & 1;
    uint64_t* bar = reinterpret_cast<uint64_t*>(s1_shm) + b;
    uint4* part = reinterpret_cast<uint4*>(s1_shm) + 1 + b * total;
    if (threadIdx.x == 0) mbar_expect(bar, 16 * total);
    if (lane < ranks)
        cluster_push4(part + rank * warps + warp, lane, make_uint4(c.m1, c.f1, c.g, 0), bar);
    between();
    mbar_wait(bar, (phases >> b) & 1);
    phases ^= 1u << b;
    unsigned m = UMAX, i1 = NONE, i2 = NONE;
    for (unsigned q = lane; q < total; q += 32) {
        const uint4 v = part[q];
        if (v.x < m) {
            m = v.x;
            i1 = v.y;
            i2 = v.z;
        } else if (v.x == m) {  // the first two of {i1, i2, f, g}
            i2 = min(min(i2, v.z), max(i1, v.y));
            i1 = min(i1, v.y);
        }
    }
    return lane_merge(m, i1, i2, need_g);
}

// Column n's cost, mask byte (0 for padding paths) and switch into one
// slot of the register ring. Nothing here reads the loaded values, so
// the warp waits for them only in the column that uses them (a compare
// at load time stalled every column).
template <int R>
__device__ __forceinline__ void load_column(unsigned (&cost)[R], unsigned (&live)[R],
                                            unsigned& sw, const unsigned* __restrict__ c,
                                            const unsigned char* __restrict__ m,
                                            const unsigned* __restrict__ s, int n, int P,
                                            unsigned first) {
    const size_t at = (size_t)n * P + first;
#pragma unroll
    for (int j = 0; j < R; ++j) {
        live[j] = 0;
        if (first + j < (unsigned)P) {
            cost[j] = c[at + j];
            live[j] = m[at + j];
        }
    }
    sw = s[n];
}

// A lane's R backtrace entries, as one store where they make 1, 2, 4 or
// 8 bytes (aligned: rows and lanes start at multiples of that size).
template <int R, typename BT>
__device__ __forceinline__ void store_backs(BT* dst, const unsigned (&back)[R]) {
    constexpr int bytes = R * (int)sizeof(BT), bits = 8 * (int)sizeof(BT);
    if constexpr (bytes == 1 || bytes == 2 || bytes == 4) {
        unsigned w = 0;
#pragma unroll
        for (int j = 0; j < R; ++j) w |= back[j] << (bits * j);
        if constexpr (bytes == 1) *dst = (BT)w;
        else if constexpr (bytes == 2) *(uint16_t*)dst = (uint16_t)w;
        else *(uint32_t*)dst = w;
    } else if constexpr (bytes == 8) {
        u64 w = 0;
#pragma unroll
        for (int j = 0; j < R; ++j) w |= (u64)back[j] << (bits * j);
        *(u64*)dst = w;
    } else {
#pragma unroll
        for (int j = 0; j < R; ++j) dst[j] = (BT)back[j];
    }
}

// The column recurrence, from the previous column's scores s and their
// Col (m1, f1, g), with c1 = sat(m1 + sw):
//   s'[i] = live ? sat(min(s[i], c1) + cost[i]) : UMAX
//   back[i] = i != f1: s[i] < c1 ? i : f1      (stay only on strict '<')
//             i == f1: g if it exists, sw == 0 and m1 < UMAX, else f1
//             (so g is reduced only before a column whose switch is free).
// It is the column scan's: for i != f1 the helper is the first minimum;
// for f1 it is the second, whose score is m1 again only where g exists,
// and f1 stays unless the switch to it costs nothing (where m1 is UMAX
// every path is UMAX and every backtrace f1 = 0). Folding the mask into
// the cost (UMAX, so every sum saturates), the lane's next minimum is
//   min_i s'[i] = min(A, sat(m1 + U)),  A = min_i sat(s[i] + cost[i]),
//   U = min_i sat(sw + cost[i]),
// where A and U do not wait for m1: the chain from one column's m1 to
// the next is three operations and one redux.
// With CARRY, an entry row (the scores of the column before column 0,
// UMAX where masked, as an exit row holds them) makes column 0 such a
// column too, an exit row takes the last column's scores, and without
// backtraces (bt null) the sweep only carries the scores; without
// CARRY, none of this is in the code: the unrolled columns stay one
// block of straight-line code, with no branch a column (a branch a
// column made the one-warp sweep at P=123 46% slower on an H100).
// With CLUSTER, the CTA is rank k of a cluster of `ranks` CTAs
// (blockIdx.x / ranks is the chromosome): its paths are the k-th slice
// of a row, and the Col of a column is the cluster's (cluster_col).
template <int R, int W, int D, bool CARRY, bool CLUSTER, typename BT>
__global__ void __launch_bounds__(W ? 32 * W : S1_THREADS)
    s1_sweep_kernel(const unsigned* __restrict__ cost, const unsigned char* __restrict__ mask,
                    const unsigned* __restrict__ sw, const unsigned* __restrict__ carry_in,
                    unsigned* __restrict__ carry_out, BT* __restrict__ bt,
                    unsigned* __restrict__ best, int* __restrict__ ends, int N, int P,
                    int ranks) {
    const int c = blockIdx.x / ranks;
    const unsigned rank = CLUSTER ? cluster_rank() : 0;
    const unsigned slice = (W ? 32 * W : blockDim.x) * R;  // the CTA's paths
    const unsigned first = rank * slice + threadIdx.x * R;  // the lane's first path
    const size_t row = (size_t)ranks * slice;
    const bool keep = !CARRY || bt != nullptr;
    cost += (size_t)c * N * P;
    mask += (size_t)c * N * P;
    sw += (size_t)c * N;
    if (keep) bt += (size_t)c * N * row + first;

    // column n lives in slot n % D; loads past the last column read it again
    unsigned ring_cost[D][R], ring_live[D][R], ring_sw[D];
#pragma unroll
    for (int d = 0; d < D; ++d)
        load_column<R>(ring_cost[d], ring_live[d], ring_sw[d], cost, mask, sw, min(d, N - 1),
                       P, first);

    unsigned score[R], back[R], lane_min = UMAX, phases = 0;
    Col col = {UMAX, NONE, NONE};
    if constexpr (CLUSTER) {
        if (threadIdx.x == 0) {
            mbar_init(reinterpret_cast<uint64_t*>(s1_shm));
            mbar_init(reinterpret_cast<uint64_t*>(s1_shm) + 1);
        }
        cluster_arrive();  // no push before every CTA's mbarriers are set up
        cluster_wait();
    }
    // the Col of the scores, `between` run first (one CTA) or while the
    // cluster's partials come in
    auto merge = [&](unsigned least, int buffer, bool need_g, auto&& between) -> Col {
        if constexpr (CLUSTER) {
            return cluster_col<W>(warp_col<R>(score, least, first, need_g), buffer, need_g,
                                  rank, ranks, phases, between);
        } else {
            between();
            return block_col<R, W>(score, least, first, buffer, need_g);
        }
    };
    auto step = [&](int n, int k) {
        const unsigned s = ring_sw[k], c1 = sat_add(col.m1, s);
        const unsigned at_first =
            col.g != NONE && s == 0 && col.m1 != UMAX ? col.g : col.f1;
        unsigned a_min = UMAX, u_min = UMAX;
#pragma unroll
        for (int j = 0; j < R; ++j) {
            const unsigned p = first + j;
            const unsigned k_cost = ring_live[k][j] ? ring_cost[k][j] : UMAX;
            back[j] = p == col.f1 ? at_first : score[j] < c1 ? p : col.f1;
            const unsigned a = sat_add(score[j], k_cost), u = sat_add(s, k_cost);
            score[j] = min(a, sat_add(col.m1, u));
            a_min = min(a_min, a);
            u_min = min(u_min, u);
        }
        const bool need_g = ring_sw[(k + 1) % D] == 0;
        col = merge(min(a_min, sat_add(col.m1, u_min)), n, need_g, [&] {
            if (keep) store_backs<R>(bt + (size_t)n * row, back);
            load_column<R>(ring_cost[k], ring_live[k], ring_sw[k], cost, mask, sw,
                           min(n + D, N - 1), P, first);
        });
    };
    if (CARRY && carry_in) {
        // the carried column's Col (partials' buffer 1), then column 0
#pragma unroll
        for (int j = 0; j < R; ++j) {
            score[j] = first + j < (unsigned)P ? carry_in[(size_t)c * P + first + j] : UMAX;
            lane_min = min(lane_min, score[j]);
        }
        col = merge(lane_min, -1, ring_sw[0] == 0, [] {});
        step(0, 0);
    } else {
        // column 0: score 0 before its cost, backtrace 0
#pragma unroll
        for (int j = 0; j < R; ++j) {
            score[j] = ring_live[0][j] ? ring_cost[0][j] : UMAX;
            lane_min = min(lane_min, score[j]);
            back[j] = 0;
        }
        col = merge(lane_min, 0, ring_sw[1 % D] == 0, [&] {
            if (keep) store_backs<R>(bt, back);
            load_column<R>(ring_cost[0], ring_live[0], ring_sw[0], cost, mask, sw,
                           min(D, N - 1), P, first);
        });
    }
    int n0 = 1;
    for (; n0 + D <= N; n0 += D) {
#pragma unroll
        for (int d = 0; d < D; ++d) step(n0 + d, (d + 1) % D);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
        if (n0 + d >= N) break;
        step(n0 + d, (d + 1) % D);
    }
    if (rank == 0 && threadIdx.x == 0) {
        best[c] = col.m1;
        ends[c] = (int)col.f1;
    }
    if (CARRY && carry_out) {
#pragma unroll
        for (int j = 0; j < R; ++j)
            if (first + j < (unsigned)P) carry_out[(size_t)c * P + first + j] = score[j];
    }
    if constexpr (CLUSTER) {
        // no CTA leaves while another may still push into it
        cluster_arrive();
        cluster_wait();
    }
}

// Path p's score x into the thread's least score m and its first two
// paths at it (the thread walks its paths in increasing order).
__device__ __forceinline__ void keep_top2(unsigned& m, unsigned& i1, unsigned& i2,
                                          unsigned x, unsigned p) {
    if (i1 == NONE || x < m) {
        m = x;
        i1 = p;
        i2 = NONE;
    } else if (x == m && i2 == NONE) {
        i2 = p;
    }
}

// The block's Col from every thread's (m, i1, i2): warps by lane_merge,
// then the warps' partials.
__device__ __forceinline__ Col block_top(unsigned m, unsigned i1, unsigned i2, int step) {
    return block_merge(lane_merge(m, i1, i2, true), step, true);
}

// Column n's cost and mask lines into L2: one 128-byte line a thread.
__device__ __forceinline__ void prefetch_column(const unsigned* cost,
                                                const unsigned char* mask, int n, int P) {
    const size_t at = (size_t)n * P;
    for (unsigned p = threadIdx.x * 32; p < (unsigned)P; p += S1_THREADS * 32)
        PREFETCH_L2(cost + at + p);
    for (unsigned p = threadIdx.x * 128; p < (unsigned)P; p += S1_THREADS * 128)
        PREFETCH_L2(mask + at + p);
}

// The sweep of one CTA past S1_CTA_PATHS (the rule's past
// S1_CLUSTER_PATHS): 1024 threads, thread t holding paths t, t + 1024,
// ...; its scores in scratch [C, P]. A thread reads and writes only its
// own scores, so only the Col's merge needs a barrier. The same
// recurrence, entry and exit rows and backtrace rule as s1_sweep_kernel,
// written for one path at a time: s' = sat(min(s, c1) + cost).
template <typename BT>
__global__ void __launch_bounds__(S1_THREADS)
    s1_sweep_many_kernel(const unsigned* __restrict__ cost,
                         const unsigned char* __restrict__ mask,
                         const unsigned* __restrict__ sw, const unsigned* __restrict__ carry_in,
                         unsigned* __restrict__ carry_out, BT* __restrict__ bt,
                         unsigned* __restrict__ best, int* __restrict__ ends,
                         unsigned* __restrict__ scratch, int N, int P, int row) {
    const int c = blockIdx.x;
    const unsigned t = threadIdx.x;
    unsigned* __restrict__ score = scratch + (size_t)c * P;
    const bool keep = bt != nullptr;
    cost += (size_t)c * N * P;
    mask += (size_t)c * N * P;
    sw += (size_t)c * N;
    if (keep) bt += (size_t)c * N * row;
    for (int n = 0; n < min(N, S1_AHEAD); ++n) prefetch_column(cost, mask, n, P);

    unsigned m = UMAX, i1 = NONE, i2 = NONE;
    Col col = {UMAX, NONE, NONE};
    int n_first = 0;
    if (carry_in) {
        for (unsigned p = t; p < (unsigned)P; p += S1_THREADS) {
            const unsigned x = carry_in[(size_t)c * P + p];
            score[p] = x;
            keep_top2(m, i1, i2, x, p);
        }
        col = block_top(m, i1, i2, -1);
    } else {
        // column 0: score 0 before its cost, backtrace 0
        for (unsigned p = t; p < (unsigned)P; p += S1_THREADS) {
            const unsigned x = mask[p] ? cost[p] : UMAX;
            score[p] = x;
            if (keep) bt[p] = 0;
            keep_top2(m, i1, i2, x, p);
        }
        col = block_top(m, i1, i2, 0);
        n_first = 1;
    }
    unsigned s_next = sw[min(n_first, N - 1)];
    for (int n = n_first; n < N; ++n) {
        const unsigned s = s_next;
        s_next = sw[min(n + 1, N - 1)];
        if (n + S1_AHEAD < N) prefetch_column(cost, mask, n + S1_AHEAD, P);
        const unsigned c1 = sat_add(col.m1, s);
        const unsigned at_first =
            col.g != NONE && s == 0 && col.m1 != UMAX ? col.g : col.f1;
        const size_t at = (size_t)n * P;
        m = UMAX;
        i1 = i2 = NONE;
        // S1_UNROLL of the thread's paths at a time: their loads first
        // (the cost whatever the mask, so no load waits for another),
        // then their recurrence in path order
        for (unsigned p0 = t; p0 < (unsigned)P; p0 += S1_UNROLL * S1_THREADS) {
            unsigned k_cost[S1_UNROLL], x[S1_UNROLL];
#pragma unroll
            for (int u = 0; u < S1_UNROLL; ++u) {
                const unsigned p = p0 + u * S1_THREADS;
                k_cost[u] = x[u] = UMAX;
                if (p < (unsigned)P) {
                    const unsigned v = cost[at + p];
                    k_cost[u] = mask[at + p] ? v : UMAX;
                    x[u] = score[p];
                }
            }
#pragma unroll
            for (int u = 0; u < S1_UNROLL; ++u) {
                const unsigned p = p0 + u * S1_THREADS;
                if (p >= (unsigned)P) break;
                if (keep)
                    bt[(size_t)n * row + p] =
                        (BT)(p == col.f1 ? at_first : x[u] < c1 ? p : col.f1);
                const unsigned y = sat_add(min(x[u], c1), k_cost[u]);
                score[p] = y;
                keep_top2(m, i1, i2, y, p);
            }
        }
        col = block_top(m, i1, i2, n);
    }
    if (t == 0) {
        best[c] = col.m1;
        ends[c] = (int)col.f1;
    }
    if (carry_out)
        for (unsigned p = t; p < (unsigned)P; p += S1_THREADS)
            carry_out[(size_t)c * P + p] = score[p];
}

// maps[c][s][e]: the state at segment s's column before it (s*L - 1),
// given state e at its last column, for s = 1..S-1; `chunks` blocks of
// blockDim.x states each per (chromosome, segment).
template <typename BT>
__global__ void s1_maps_kernel(const BT* __restrict__ bt, int* __restrict__ maps, int N,
                               int P, int row, int L, int S, int chunks) {
    const int cs = blockIdx.x / chunks;
    const int c = cs / (S - 1), s = cs % (S - 1) + 1;
    const int e = (blockIdx.x % chunks) * blockDim.x + threadIdx.x;
    if (e >= P) return;
    const BT* b = bt + (size_t)c * N * row;
    const int lo = s * L, hi = min(N, lo + L);
    int x = e;
    for (int n = hi - 1; n >= lo; --n) x = b[(size_t)n * row + x];
    maps[((size_t)c * S + s) * P + e] = x;
}

// One thread per (chromosome, segment): its last column's state from the
// given end through the later segments' maps, then its columns. The
// first segment's thread also writes, where `state_out` is given, the
// backtrace at column 0 of the path's state there: the state at the
// column before it (the previous segment's last, in the checkpointed scan).
template <typename BT>
__global__ void s1_rewalk_kernel(const BT* __restrict__ bt, const int* __restrict__ maps,
                                 const int* __restrict__ ends, int* __restrict__ path,
                                 int* __restrict__ state_out, int C, int N, int P, int row,
                                 int L, int S) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= C * S) return;
    const int c = t / S, s = t % S;
    const int* m = maps + (size_t)c * S * P;
    int x = ends[c];
    for (int k = S - 1; k > s; --k) x = m[(size_t)k * P + x];
    const BT* b = bt + (size_t)c * N * row;
    int* out = path + (size_t)c * N;
    const int lo = s * L;
    for (int n = min(N, lo + L) - 1;; --n) {
        out[n] = x;
        if (n == lo) break;
        x = b[(size_t)n * row + x];
    }
    if (s == 0 && state_out) state_out[c] = b[x];
}

// The sweep's layout, as hmm/sampling.py:sweep_layout derives it: K CTAs
// a chromosome, each of W warps of R paths a lane (W = 0: one CTA of
// 1024 threads, the scores in a scratch row). One CTA up to
// S1_CTA_PATHS paths; then, up to S1_CLUSTER_PATHS, a cluster: W warps
// of 4 paths a lane as S1_CLUSTER_RANKS CTAs need them (S1_MAX_RANKS
// where S1_CLUSTER_RANKS CTAs of 32 warps would not hold the paths),
// then the fewest CTAs of W warps that hold the paths, so that none
// holds only padding; then W = 0. False where no instance takes P
// (only in a build with another S1_CLUSTER_RANKS).
static bool sweep_layout(int P, int& K, int& W, int& R) {
    if (P < 1) return false;
    K = 1;
    if (P <= 128) {
        W = 1;
        R = (P + 31) / 32;
    } else if (P <= S1_CTA_PATHS) {
        W = (P + 127) / 128;
        R = 4;
    } else if (P <= S1_CLUSTER_PATHS) {
        const int most = P <= S1_CLUSTER_RANKS * S1_REGISTER_PATHS ? S1_CLUSTER_RANKS
                                                                   : S1_MAX_RANKS;
        W = (P + 128 * most - 1) / (128 * most);
        K = (P + 128 * W - 1) / (128 * W);
        R = 4;
        return W >= 2 && W <= 32;
    } else {
        W = 0;
        R = (P + S1_THREADS - 1) / S1_THREADS;
    }
    return true;
}

// Whether the layout for P paths is the cluster tier's.
static bool clustered(int P) { return P > S1_CTA_PATHS && P <= S1_CLUSTER_PATHS; }

// The entries of a backtrace row: every CTA's paths.
static int layout_row(int K, int W, int R) { return K * (W ? 32 * W : S1_THREADS) * R; }

template <typename Kernel, typename... Args>
static int launch(Kernel kernel, int blocks, int threads, size_t smem, void* stream,
                  Args... args) {
    kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(args...);
    return (int)cudaGetLastError();
}

// A cluster launch of `blocks` CTAs in clusters of `ranks`, once
// cudaOccupancyMaxActiveClusters says one such cluster fits the card;
// else cudaErrorLaunchOutOfResources, and nothing runs. With `fits`
// given, only that reading is written there.
template <typename... Params, typename... Args>
static int launch_cluster(void (*kernel)(Params...), int blocks, int ranks, int threads,
                          size_t smem, void* stream, int* fits, Args... args) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ranks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim.x = blocks;
    config.gridDim.y = config.gridDim.z = 1;
    config.blockDim.x = threads;
    config.blockDim.y = config.blockDim.z = 1;
    config.dynamicSmemBytes = smem;
    config.stream = (cudaStream_t)stream;
    config.attrs = attr;
    config.numAttrs = 1;
    int err = 0;
    if (ranks > 8)
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
    err = (int)cudaLaunchKernelEx(&config, kernel, args...);
    if (err) return err;
    return (int)cudaGetLastError();
}

// The cluster tier's instance for W warps a CTA (W > 8: the runtime-W
// one, its ring S1_WIDE_DEPTH deep); its shared memory: two mbarriers and
// two buffers of K x W partials.
template <bool CARRY>
static int sweep_cluster(int K, int W, int* fits, const unsigned* cost,
                         const unsigned char* mask, const unsigned* sw,
                         const unsigned* carry_in, unsigned* carry_out, void* bt,
                         unsigned* best, int* ends, int C, int N, int P, void* stream) {
#define S1_CLUSTER(w, d)                                                                       \
    if (W == w || (w == 0 && W > 8))                                                           \
        return launch_cluster(s1_sweep_kernel<4, w, d, CARRY, true, uint16_t>, C * K, K,       \
                              32 * W, 16 + 32 * (size_t)K * W, stream, fits, cost, mask, sw,   \
                              carry_in, carry_out, (uint16_t*)bt, best, ends, N, P, K);
    S1_CLUSTER(2, S1_DEPTH) S1_CLUSTER(3, S1_DEPTH) S1_CLUSTER(4, S1_DEPTH)
    S1_CLUSTER(5, S1_DEPTH) S1_CLUSTER(6, S1_DEPTH) S1_CLUSTER(7, S1_DEPTH)
    S1_CLUSTER(8, S1_DEPTH) S1_CLUSTER(0, S1_WIDE_DEPTH)
#undef S1_CLUSTER
    return (int)cudaErrorInvalidValue;
}

template <typename BT>
static int sweep_many(const unsigned* cost, const unsigned char* mask, const unsigned* sw,
                      const unsigned* carry_in, unsigned* carry_out, void* bt, unsigned* best,
                      int* ends, unsigned* scratch, int C, int N, int P, int row,
                      void* stream) {
    if (!scratch) return (int)cudaErrorInvalidValue;
    return launch(s1_sweep_many_kernel<BT>, C, S1_THREADS, 4 * S1_PART_WORDS, stream, cost,
                  mask, sw, carry_in, carry_out, (BT*)bt, best, ends, scratch, N, P, row);
}

template <typename BT>
static int chase(const void* bt, const int* ends, int* maps, int* path, int* state_out, int C,
                 int N, int P, int row, int L, void* stream) {
    const int S = (N + L - 1) / L;
    const BT* b = (const BT*)bt;
    if (S > 1) {
        const int threads = min(256, (P + 31) / 32 * 32), chunks = (P + threads - 1) / threads;
        const int err = launch(s1_maps_kernel<BT>, C * (S - 1) * chunks, threads, 0, stream,
                               b, maps, N, P, row, L, S, chunks);
        if (err) return err;
    }
    return launch(s1_rewalk_kernel<BT>, (C * S + 127) / 128, 128, 0, stream, b,
                  (const int*)maps, ends, path, state_out, C, N, P, row, L, S);
}

extern "C" const char* pg_s1_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// cost, mask [C, N, P]; sw [C, N]; carry_in, carry_out [C, P] (uint32
// scores of the column before column 0 and of the last column) or null;
// bt [C, N, row] uint8 for P <= 256, uint16 for P <= 65,536, else
// uint32, or null (no backtraces); best (uint32 bits) and ends [C];
// scratch [C, P] uint32 for the one-CTA tier past S1_CLUSTER_PATHS,
// else ignored.
extern "C" int pg_s1_sweep(const unsigned* cost, const unsigned char* mask,
                           const unsigned* sw, const unsigned* carry_in, unsigned* carry_out,
                           void* bt, unsigned* best, int* ends, unsigned* scratch, int C,
                           int N, int P, int row, void* stream) {
    int K, W, R;
    if (C < 1 || N < 1 || !sweep_layout(P, K, W, R) || row != layout_row(K, W, R))
        return (int)cudaErrorInvalidValue;
    const bool carry = carry_in || carry_out || !bt;
    if (clustered(P))
        return carry ? sweep_cluster<true>(K, W, nullptr, cost, mask, sw, carry_in, carry_out,
                                           bt, best, ends, C, N, P, stream)
                     : sweep_cluster<false>(K, W, nullptr, cost, mask, sw, carry_in,
                                            carry_out, bt, best, ends, C, N, P, stream);
    if (W == 0)
        return P <= 65536 ? sweep_many<uint16_t>(cost, mask, sw, carry_in, carry_out, bt, best,
                                                 ends, scratch, C, N, P, row, stream)
                          : sweep_many<uint32_t>(cost, mask, sw, carry_in, carry_out, bt, best,
                                                 ends, scratch, C, N, P, row, stream);
    const size_t smem = W > 1 ? 8 * W * sizeof(unsigned) : 0;
#define S1_SWEEP(w, r, T)                                                                  \
    if (W == w && R == r)                                                                  \
        return carry ? launch(s1_sweep_kernel<r, w, S1_DEPTH, true, false, T>, C, 32 * w,  \
                              smem, stream, cost, mask, sw, carry_in, carry_out, (T*)bt,   \
                              best, ends, N, P, 1)                                         \
                     : launch(s1_sweep_kernel<r, w, S1_DEPTH, false, false, T>, C, 32 * w, \
                              smem, stream, cost, mask, sw, carry_in, carry_out, (T*)bt,   \
                              best, ends, N, P, 1);
    S1_SWEEP(1, 1, uint8_t) S1_SWEEP(1, 2, uint8_t) S1_SWEEP(1, 3, uint8_t)
    S1_SWEEP(1, 4, uint8_t) S1_SWEEP(2, 4, uint8_t) S1_SWEEP(3, 4, uint16_t)
    S1_SWEEP(4, 4, uint16_t) S1_SWEEP(5, 4, uint16_t) S1_SWEEP(6, 4, uint16_t)
    S1_SWEEP(7, 4, uint16_t) S1_SWEEP(8, 4, uint16_t)
#undef S1_SWEEP
    return (int)cudaErrorInvalidValue;
}

// The clusters of the sweep's instance for P paths that fit the card at
// once, by cudaOccupancyMaxActiveClusters, into `clusters`; 0 where the
// layout is not a cluster.
extern "C" int pg_s1_cluster_fits(int P, int* clusters) {
    int K, W, R;
    if (!sweep_layout(P, K, W, R)) return (int)cudaErrorInvalidValue;
    *clusters = 0;
    return clustered(P) ? sweep_cluster<false>(K, W, clusters, nullptr, nullptr, nullptr, nullptr,
                                        nullptr, nullptr, nullptr, nullptr, 1, 1, P, nullptr)
                 : 0;
}

// The path [C, N] from the sweep's bt and the states `ends` [C] at the
// last column, through segments of L columns; maps: [C, ceil(N / L), P]
// int32 scratch; state_out [C] (or null): the state at the column before
// column 0 that the path's backtrace there names. A row of `row` entries
// holds path p's at entry p, whatever the sweep's layout.
extern "C" int pg_s1_chase(const void* bt, const int* ends, int* maps, int* path,
                           int* state_out, int C, int N, int P, int row, int L,
                           void* stream) {
    if (C < 1 || N < 1 || L < 1 || P < 1 || row < P) return (int)cudaErrorInvalidValue;
    if (P <= 256)
        return chase<uint8_t>(bt, ends, maps, path, state_out, C, N, P, row, L, stream);
    if (P <= 65536)
        return chase<uint16_t>(bt, ends, maps, path, state_out, C, N, P, row, L, stream);
    return chase<uint32_t>(bt, ends, maps, path, state_out, C, N, P, row, L, stream);
}
