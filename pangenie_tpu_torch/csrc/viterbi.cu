// Kernel V1, the phasing Viterbi, for Hopper (sm_90a): one warp a chain,
// one pass over the columns with backtraces, then the chase, in one
// launch.
//
// Replaces: pangenie_tpu/hmm/viterbi.py:_viterbi_scan (the max-plus scan,
// its last-max final argmax and reverse chase; also the two-pass
// _viterbi_fast, whose states equal the scan's) and, through entry and
// exit carries and a launch without backtraces, _viterbi_segment_forward
// and _viterbi_segment_backtrace. Plain version:
// pangenie_tpu_torch/hmm/viterbi.py (segment_plain: sweep_plain and
// chase_plain); wrapper: hmm/v1_kernels.py.
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
// a chain is a serial loop of N steps whose cost is latency — the warp's
// three passes of P top-2 updates (rows, columns, the switch-both
// statistics), a double-precision exp a cell, the warp reductions — not
// bandwidth (the backtraces, 2 S bytes a column, 2 KB at P = 32) or
// arithmetic. Parallelism comes only from the batch: one warp (a CTA of
// 32 threads) a chain. The design against that, simple first:
//
// - Lane l holds column q = l mod Q of the state (Q = P rounded up to a
//   power of two) and, in registers, the rows grp + L r of it (grp = l /
//   Q, L = 32 / Q lanes a column), as K1 and K2 do in fb.cu. Cell (p,
//   q) is then entry 32 r + l of the state padded to Q x Q.
// - The row and column statistics need every lane's cells: the state
//   goes to a transposed copy in shared memory (pitch 33, free of bank
//   conflicts either way), lane p walks row p and column p serially in
//   ascending order (the reference's last-argmax top-2 as a running
//   update), then the switch-both statistics of column p over the rows'
//   statistics. Four __syncwarp a column.
// - The max and the sum are butterflies of shuffles in a fixed order
//   (every lane ends with the same bits; two launches give the same
//   bits).
// - A column's [A, A] log emissions, its P alleles and its three log
//   transitions arrive by cp.async in a ring of V1_RING slots in shared
//   memory, issued V1_RING - 1 columns ahead.
// - The backtraces are stored as the cells are computed, lanes on
//   consecutive q, so a row of a column is one coalesced store.
// - The chase walks the backtraces from the end in chunks of about 8 KB
//   of columns, copied by the warp into a ring of V1_CHASE_RING buffers
//   by cp.async ahead of the walk, which lane 0 does in shared memory:
//   no dependent load from device memory per column.
// Allocates nothing; launches on the caller's stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

#define V1_MAX_PATHS 32
#define V1_MAX_ALLELES 32
#define V1_RING 8
#define V1_HEADER 4                // lt0, lt1, lt2 and a spare word
#define V1_PITCH 33                // the transposed state's row pitch
#define V1_STATS 16                // statistics of 32 lanes each, below
#define V1_CHASE_BYTES 8192        // a chase chunk's backtraces at most
#define V1_CHASE_RING 4
#define V1_FULL 0xffffffffu

extern __shared__ __align__(16) float v1_shm[];

// a slot of the ring: header, emissions [A, A], alleles [32] (those of
// paths P to 31 stay 0)
__host__ __device__ __forceinline__ int v1_slot_floats(int A) {
    return V1_HEADER + A * A + 32;
}
// a chase buffer: a chunk at any 4-byte misalignment of its start
__host__ __device__ __forceinline__ int v1_chase_floats() { return (V1_CHASE_BYTES + 16) / 4; }

static size_t v1_smem(int A) {
    return sizeof(float) * ((size_t)V1_RING * v1_slot_floats(A) + 32 * V1_PITCH
                            + V1_STATS * 32 + V1_CHASE_RING * v1_chase_floats());
}

// The running top-2 of a slice in ascending index order: the max and its
// LAST index, and the max over the rest and its last index (the
// reference package's _top2_last); where every value but the max is
// -inf, a2 is the slice's last index, as there.
struct Top2 {
    float m1, m2;
    int a1, a2;
    __device__ __forceinline__ Top2() : m1(-INFINITY), m2(-INFINITY), a1(-1), a2(-1) {}
    __device__ __forceinline__ void add(float x, int i) {
        if (x >= m1) {
            m2 = m1;
            a2 = a1;
            m1 = x;
            a1 = i;
        } else if (x >= m2) {
            m2 = x;
            a2 = i;
        }
    }
    __device__ __forceinline__ void finish(int n) {
        if (!(m2 > -INFINITY)) a2 = n - 1;
    }
};

// (v, j) := the (value, larger index)-lexicographic max of (v, j) and
// (vb, jb) (the reference package's _lex_max)
__device__ __forceinline__ void lex_max(float& v, int& j, float vb, int jb) {
    if (!(v > vb || (v == vb && j > jb))) {
        v = vb;
        j = jb;
    }
}

template <int Q>
__global__ void __launch_bounds__(32, 1)
v1_viterbi_kernel(const float* __restrict__ logea, const int* __restrict__ al,
                  const float* __restrict__ lt, const float* __restrict__ carry_in,
                  const int* __restrict__ first_in, float* __restrict__ carry_out,
                  int16_t* __restrict__ bt, const int* __restrict__ state_in,
                  int* __restrict__ states, int* __restrict__ state_out, int N, int P, int A,
                  float neg_log_s) {
    constexpr int L = 32 / Q, RW = Q * Q >= 32 ? Q * Q / 32 : 1, D = V1_RING;
    const int lane = threadIdx.x, b = blockIdx.x, S = P * P, AA = A * A;
    const int q = lane & (Q - 1), grp = lane / Q;
    const int pitch = v1_slot_floats(A);
    float* st = v1_shm + D * pitch;                     // [32, V1_PITCH] the previous column
    // row statistics (by row), column statistics (by column), the
    // switch-both statistics (by column) and the row statistics a1, a2
    // of the latter's rows gA1 and gA2
    float* rm1 = st + 32 * V1_PITCH;
    float* rm2 = rm1 + 32;
    int* ra1 = (int*)(rm2 + 32);
    int* ra2 = ra1 + 32;
    float* cm1 = (float*)(ra2 + 32);
    float* cm2 = cm1 + 32;
    int* ca1 = (int*)(cm2 + 32);
    int* ca2 = ca1 + 32;
    float* gm1 = (float*)(ca2 + 32);
    float* gm2 = gm1 + 32;
    int* gA1 = (int*)(gm2 + 32);
    int* gA2 = gA1 + 32;
    int* r1g1 = gA2 + 32;
    int* r2g1 = r1g1 + 32;
    int* r1g2 = r2g1 + 32;
    int* r2g2 = r1g2 + 32;
    char* chase_buf = (char*)(r2g2 + 32);
    const size_t chain = (size_t)b * N;

    // the lane's cells of real paths (bit r: row grp + L r, column q)
    unsigned valid = 0;
#pragma unroll
    for (int r = 0; r < RW; ++r)
        if (q < P && grp + L * r < P) valid |= 1u << r;

    // every slot's alleles 0 (those past P stay so), published before the
    // first copies
    for (int i = lane; i < D * pitch; i += 32)
        if (i % pitch >= V1_HEADER + AA) ((int*)v1_shm)[i] = 0;
    __syncwarp();

    // column c's inputs into slot c mod D, one 4-byte copy a value spread
    // over the lanes; a commit group a call, empty past the last column
    auto fetch = [&](int c) {
        if (c < N) {
            float* s = v1_shm + (c % D) * pitch;
            const float* ea_c = logea + (chain + c) * AA;
            const int* al_c = al + (chain + c) * P;
            const float* lt_c = lt + (chain + c) * 3;
            for (int j = lane; j < AA + P + 3; j += 32) {
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
        lv[r] = valid >> r & 1 ? carry_in[(size_t)b * S + (grp + L * r) * P + q] : -INFINITY;
    bool first = first_in[b] != 0;

    for (int n = 0; n < N; ++n) {
        // column n's inputs have arrived (every lane's copies), and every
        // lane is done with the slot of column n - 1
        cp_async_wait<D - 2>();
        __syncwarp();
        fetch(n + D - 1);
        const float* s = v1_shm + (n % D) * pitch;
        const float* eas = s + V1_HEADER;
        const int* als = (const int*)(eas + AA);
        const float lt0 = s[0], lt1 = s[1], lt2 = s[2];
        const int aq = als[q];

        // the previous column into the transposed copy
#pragma unroll
        for (int r = 0; r < RW; ++r)
            if (valid >> r & 1) st[(grp + L * r) * V1_PITCH + q] = lv[r];
        __syncwarp();
        // lane p: the top-2 of row p and of column p, in ascending order
        {
            Top2 row, col;
            if (lane < P) {
                for (int j = 0; j < P; ++j) {
                    row.add(st[lane * V1_PITCH + j], j);
                    col.add(st[j * V1_PITCH + lane], j);
                }
                row.finish(P);
                col.finish(P);
            }
            rm1[lane] = row.m1;
            rm2[lane] = row.m2;
            ra1[lane] = row.a1;
            ra2[lane] = row.a2;
            cm1[lane] = col.m1;
            cm2[lane] = col.m2;
            ca1[lane] = col.a1;
            ca2[lane] = col.a2;
        }
        __syncwarp();
        // lane p: the top-2 over rows q1 of g[q1, p], the best of row q1
        // off column p (its second where its best sits at p)
        {
            Top2 g;
            if (lane < P) {
                for (int j = 0; j < P; ++j) g.add(ra1[j] == lane ? rm2[j] : rm1[j], j);
                g.finish(P);
            }
            const int a1 = lane < P ? g.a1 : 0, a2 = lane < P ? g.a2 : 0;
            gm1[lane] = g.m1;
            gm2[lane] = g.m2;
            gA1[lane] = a1;
            gA2[lane] = a2;
            r1g1[lane] = ra1[a1];
            r2g1[lane] = ra2[a1];
            r1g2[lane] = ra1[a2];
            r2g2[lane] = ra2[a2];
        }
        __syncwarp();

        // the cells: best predecessor over the three classes, the new
        // value and the backtrace
        const float cm1q = cm1[q], cm2q = cm2[q], gm1q = gm1[q], gm2q = gm2[q];
        const int ca1q = ca1[q], ca2q = ca2[q], gA1q = gA1[q], gA2q = gA2[q];
        const int r1g1q = r1g1[q], r2g1q = r2g1[q], r1g2q = r1g2[q], r2g2q = r2g2[q];
        int16_t* bt_n = bt ? bt + (chain + n) * S : nullptr;
        float cur[RW];
        float mx = -INFINITY;
#pragma unroll
        for (int r = 0; r < RW; ++r) {
            const int p = grp + L * r;
            // stay both
            float v = lv[r] + lt0;
            int j = p * P + q;
            // switch one: (p, q2 != q) or (q1 != p, q)
            const bool ex = ra1[p] == q;
            float v1 = ex ? rm2[p] : rm1[p];
            int j1 = p * P + (ex ? ra2[p] : ra1[p]);
            const bool ey = ca1q == p;
            lex_max(v1, j1, ey ? cm2q : cm1q, (ey ? ca2q : ca1q) * P + q);
            lex_max(v, j, v1 + lt1, j1);
            // switch both: q1 != p and q2 != q
            const bool hit = gA1q == p;
            const int ra1_at = hit ? r1g2q : r1g1q, ra2_at = hit ? r2g2q : r2g1q;
            lex_max(v, j, (hit ? gm2q : gm1q) + lt2,
                    (hit ? gA2q : gA1q) * P + (ra1_at == q ? ra2_at : ra1_at));
            const float e = eas[als[p] * A + aq];
            cur[r] = valid >> r & 1 ? (first ? 0.f : v) + e : -INFINITY;
            mx = fmaxf(mx, cur[r]);
            if (bt_n && (valid >> r & 1)) bt_n[p * P + q] = (int16_t)(first ? 0 : j);
        }
        // the column's logsumexp (max, then the double sum), every lane the
        // same bits
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(V1_FULL, mx, o));
        float lse = -INFINITY;
        if (mx > -INFINITY) {
            const double md = mx;
            double sum = 0.0;
#pragma unroll
            for (int r = 0; r < RW; ++r)
                if (valid >> r & 1) sum += exp((double)cur[r] - md);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(V1_FULL, sum, o);
            lse = (float)(log(sum) + md);
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
        if (valid >> r & 1) carry_out[(size_t)b * S + (grp + L * r) * P + q] = lv[r];
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
    int last = -1;
#pragma unroll
    for (int r = 0; r < RW; ++r)
        if ((valid >> r & 1) && lv[r] == best) last = max(last, (grp + L * r) * P + q);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) last = max(last, __shfl_xor_sync(V1_FULL, last, o));
    int state = state_in[b] >= 0 ? state_in[b] : last;

    // every lane's backtrace stores come before the copies below
    __syncwarp();
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
            for (int w = lane; w < words; w += 32) cp_async4(dst + w, (const float*)word0 + w);
        }
        cp_async_commit();
    };
    for (int k = 0; k < V1_CHASE_RING - 1; ++k) fetch_chunk(k);
    int* states_b = states + chain;
    for (int k = 0; k < chunks; ++k) {
        cp_async_wait<V1_CHASE_RING - 2>();
        __syncwarp();
        fetch_chunk(k + V1_CHASE_RING - 1);
        if (lane == 0) {
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
    if (lane == 0) state_out[b] = state;
}

// One warp a chain; opts in to the kernel's shared memory, launches on the
// caller's stream and returns the cudaError_t.
template <typename Kernel, typename... Args>
static int launch(Kernel kernel, int B, size_t smem, void* stream, Args... args) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B, 32, smem, (cudaStream_t)stream>>>(args...);
    return (int)cudaGetLastError();
}

extern "C" const char* pg_v1_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
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
    int Q = 1;
    while (Q < P) Q <<= 1;
    const size_t smem = v1_smem(A);
#define V1_LAUNCH(q)                                                                     \
    if (Q == q)                                                                          \
        return launch(v1_viterbi_kernel<q>, B, smem, stream, logea, al, lt, carry_in,    \
                      first_in, carry_out, bt, state_in, states, state_out, N, P, A,     \
                      neg_log_s);
    V1_LAUNCH(1) V1_LAUNCH(2) V1_LAUNCH(4) V1_LAUNCH(8) V1_LAUNCH(16) V1_LAUNCH(32)
#undef V1_LAUNCH
    return (int)cudaErrorInvalidValue;
}
