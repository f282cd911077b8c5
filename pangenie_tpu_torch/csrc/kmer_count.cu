// Kernels D1-extract and D1-count, read k-mer counting for Hopper
// (sm_90a): the canonical k-mers of packed sequence blocks, and their
// counts in a sorted table of k-mers.
//
// Replace: pangenie_tpu/kmers/device_counter.py, XLA programs without
// Pallas. D1-extract replaces extract_canonical (:142, with its
// unpack_codes_2bit, :100, fused in); D1-count replaces the PRIME+UPDATE
// step, lookup_pair_directed (:430) + primed_update_batch (:458), and the
// sorted merge join primed_update_merge (:474) with its buffered form
// (_ingest_packed, _flush_tagged), which the TPU took for want of a
// scatter; the card has atomics. D1-count-keys counts keys already
// extracted (a partition's share of the read windows, routed to the rank
// that holds it) and replaces the sharded counter's shard-local flush,
// _flush_tagged (:593). Plain versions and wrappers:
// pangenie_tpu_torch/kmers/device_counter.py (extract_plain, count_plain,
// count_keys_plain; extract, count, count_keys).
//
// A block is a flat stream of T bases: base p is 2 bits of words (16 a
// word, at bits 2 (p mod 16); A=0 C=1 G=2 T=3) and one bit of vwords (32 a
// word, at bit p mod 32; 0 where the base is not A, C, G or T). The
// sequences lie one after another with at least one invalid base after
// each (device_counter.pack_sequences), so no window spans two of them.
// Window j (0 <= j < T) covers bases j .. j + k - 1; its key is the
// canonical 2k-bit k-mer, the smaller of the forward encoding (first base
// in the highest bits, as csrc/kmercount.cpp encodes) and that of the
// reverse complement, as int64 (k <= 31: 62 bits, so int64 order is the
// unsigned order); D1_SENTINEL (INT64_MAX) where the window runs past T or
// holds an invalid base.
//
// D1-extract writes every window's key, keys [T]. D1-count looks every
// valid window's key up in the sorted, unique table [n] and adds one to
// counts[i] (int32) where table[i] is the key: the directory [2^d + 1]
// holds where each bucket of the key's top d bits starts in the table
// (d follows the table's size, device_counter.directory_bits). Counts are
// integers, so the result is exact in any order of the atomics.
//
// What bounds them on the H100. D1-extract: bytes, 0.375 a base in and 8
// a window out, if a window's key costs a few instructions. A key formed
// base by base (k steps of two loads and ten 64-bit shifts and ors, about
// 400 instructions) made it 20x its bound, so here a window's 2k bits
// come from one funnel shift of the three words they span (the packing
// puts the first base lowest: (p mod 16) + 30 < 48 bits), its k validity
// bits from one funnel shift of two vwords, the reverse complement is
// those bits xor a mask, the forward key the same bits with their 2-bit
// groups reversed (__brevll, a swap of neighbouring bits, a shift): about
// 20 integer operations a window, the loads neighbouring threads share
// (L1), neighbouring threads writing neighbouring keys. D1-count:
// random sectors. Its floor is the packed stream plus the table and the
// counts read once (hmm/bounds.py: d1_count; the directory is this
// design's own, so its bytes are not the function's), but every
// valid window reads its bucket's directory entries, the bucket's keys
// and one count at random in a table of 190-250 MB against a 50 MB L2.
// With a directory of 2^16 buckets a window took 8-9 dependent probes of
// which the last 4-5 fell on sectors no other window read. So the
// directory is sized to the table, 1-2 keys a bucket on average
// (device_counter.directory_bits: d = 24, 64 MB, at 17-33 M keys; the
// time fell with every step of d from 16 to 24, so the table's sectors a
// window reads, not whether the directory stays in L2, set it): a window
// reads its two directory entries (one sector), then at most D1_SCAN
// keys as 16-byte pairs, all loads issued before the first compare (one
// sector, or two), then one atomicAdd whose result is unused (RED). A
// bucket wider than D1_SCAN (canonical keys crowd the low buckets;
// genomes repeat) first narrows by binary steps inside the kernel, so
// any table is right. One thread a window; no shared memory, no
// barrier.
#include <cuda_runtime.h>
#include <stdint.h>

#define D1_SENTINEL 0x7FFFFFFFFFFFFFFFLL
#define D1_THREADS 256
// a bucket narrowed to at most D1_SCAN keys is read whole, in pairs
// (even; device_counter.SCAN mirrors it, pg_d1_scan answers it)
#ifndef D1_SCAN
#define D1_SCAN 4
#endif

// word i of p [n], 0 past its end
__device__ __forceinline__ uint32_t d1_load(const uint32_t* p, long long i, long long n) {
    return i < n ? __ldg(p + i) : 0u;
}

// The canonical key of window j, or D1_SENTINEL.
__device__ __forceinline__ long long d1_window(const uint32_t* words, const uint32_t* vwords,
                                               long long n_bases, long long j, int k) {
    if (j + k > n_bases) return D1_SENTINEL;
    // the k validity bits from bit j of vwords
    const long long v = j >> 5, n_v = (n_bases + 31) >> 5;
    const uint32_t ones = 0xFFFFFFFFu >> (32 - k);
    const uint32_t valid = __funnelshift_r(__ldg(vwords + v), d1_load(vwords, v + 1, n_v),
                                           (unsigned)j & 31);
    if ((valid & ones) != ones) return D1_SENTINEL;
    // the 2k bits from bit 2j of words: base j + i at bits 2i, 2i + 1
    const long long w = j >> 4, n_w = (n_bases + 15) >> 4;
    const unsigned o = 2 * ((unsigned)j & 15);
    const uint32_t w0 = __ldg(words + w), w1 = d1_load(words, w + 1, n_w),
                   w2 = d1_load(words, w + 2, n_w);
    const unsigned long long bits =
        ((unsigned long long)__funnelshift_r(w1, w2, o) << 32) | __funnelshift_r(w0, w1, o);
    // reverse complement: 3 - c = c xor 3, base j + i still at bits 2i
    const unsigned long long rc = ~bits & (~0ULL >> (64 - 2 * k));
    // forward: base j + i at bits 2 (k - 1 - i); the bits past the window
    // fall below bit 64 - 2k and are shifted out
    unsigned long long fw = __brevll(bits);
    fw = ((fw >> 1) & 0x5555555555555555ULL) | ((fw & 0x5555555555555555ULL) << 1);
    fw >>= 64 - 2 * k;
    return (long long)(fw < rc ? fw : rc);
}

__global__ void __launch_bounds__(D1_THREADS)
d1_extract_kernel(const uint32_t* words, const uint32_t* vwords, long long n_bases, int k,
                  long long* keys) {
    const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (j < n_bases) keys[j] = d1_window(words, vwords, n_bases, j, k);
}

// The index of key in the sorted, unique table [n_keys], or -1: the
// directory [2^d + 1] (bucket = key >> shift) bounds where it can lie.
// D1-count and D1-count-keys both search through this one function.
__device__ __forceinline__ int d1_find(const long long* table, int n_keys, const int* directory,
                                       int shift, long long key) {
    const long long bucket = key >> shift;
    int lo = __ldg(directory + bucket), hi = __ldg(directory + bucket + 1);
    // the key, if the table holds it, lies in [lo, hi)
    while (hi - lo > D1_SCAN) {
        const int mid = lo + ((hi - lo) >> 1);
        if (__ldg(table + mid) <= key)
            lo = mid;
        else
            hi = mid;
    }
    // [lo, hi) as 16-byte pairs from lo's even neighbour: table[lo - 1]
    // and table[hi] are not the key (sorted, unique), so only the
    // table's end bounds a pair
    const int first = lo & ~1;
    int hit = -1;
#pragma unroll
    for (int s = 0; s <= D1_SCAN / 2; ++s) {
        const int i = first + 2 * s;
        if (i < hi) {
            if (i + 1 < n_keys) {
                const longlong2 pair = __ldg(reinterpret_cast<const longlong2*>(table + i));
                if (pair.x == key) hit = i;
                if (pair.y == key) hit = i + 1;
            } else if (__ldg(table + i) == key) {
                hit = i;
            }
        }
    }
    return hit;
}

__global__ void __launch_bounds__(D1_THREADS)
d1_count_kernel(const uint32_t* words, const uint32_t* vwords, long long n_bases, int k,
                const long long* table, int n_keys, const int* directory, int shift,
                int* counts) {
    const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n_bases) return;
    const long long key = d1_window(words, vwords, n_bases, j, k);
    if (key == D1_SENTINEL) return;
    const int hit = d1_find(table, n_keys, directory, shift, key);
    if (hit >= 0) atomicAdd(counts + hit, 1);
}

// D1-count-keys: one thread a key of keys [n] (a partition's share of
// the read windows, routed to it by their owner); a key of 2k bits
// found at table[i] adds one to counts[i]. D1_SENTINEL, and any key of
// more than 2k bits, matches nothing.
__global__ void __launch_bounds__(D1_THREADS)
d1_count_keys_kernel(const long long* keys, long long n, int k, const long long* table,
                     int n_keys, const int* directory, int shift, int* counts) {
    const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n) return;
    const long long key = __ldg(keys + j);
    if ((unsigned long long)key >> (2 * k)) return;
    const int hit = d1_find(table, n_keys, directory, shift, key);
    if (hit >= 0) atomicAdd(counts + hit, 1);
}

// One thread a window of n_bases on the caller's stream; returns the
// cudaError_t.
template <typename Kernel, typename... Args>
static int launch(Kernel kernel, long long n_bases, void* stream, Args... args) {
    const long long blocks = (n_bases + D1_THREADS - 1) / D1_THREADS;
    kernel<<<(unsigned)blocks, D1_THREADS, 0, (cudaStream_t)stream>>>(args...);
    return (int)cudaGetLastError();
}

static bool d1_takes(long long n_bases, int k) {
    return n_bases >= 1 && n_bases < (1LL << 40) && k >= 1 && k <= 31;
}

extern "C" const char* pg_d1_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// D1-extract: words [ceil(T/16)], vwords [ceil(T/32)] in; keys [T] int64 out.
extern "C" int pg_d1_extract(const uint32_t* words, const uint32_t* vwords, long long n_bases,
                             int k, long long* keys, void* stream) {
    if (!d1_takes(n_bases, k)) return (int)cudaErrorInvalidValue;
    return launch(d1_extract_kernel, n_bases, stream, words, vwords, n_bases, k, keys);
}

// D1-count: words and vwords as D1-extract's, the sorted unique table [n]
// int64 (16-byte aligned), its directory [2^d + 1] int32 (bucket = key >>
// shift, shift = 2k - d) in; counts [n] int32 incremented in place.
extern "C" int pg_d1_count(const uint32_t* words, const uint32_t* vwords, long long n_bases,
                           int k, const long long* table, int n_keys, const int* directory,
                           int shift, int* counts, void* stream) {
    if (!d1_takes(n_bases, k) || shift < 0 || shift > 2 * k || n_keys < 0 ||
        (uintptr_t)table % 16)
        return (int)cudaErrorInvalidValue;
    return launch(d1_count_kernel, n_bases, stream, words, vwords, n_bases, k, table, n_keys,
                  directory, shift, counts);
}

// D1-count-keys: keys [n] int64 (k-mers of 2k bits, D1_SENTINEL skipped),
// the table, directory and shift as D1-count's; counts [n_keys] int32
// incremented in place.
extern "C" int pg_d1_count_keys(const long long* keys, long long n, int k,
                                const long long* table, int n_keys, const int* directory,
                                int shift, int* counts, void* stream) {
    if (!d1_takes(n, k) || shift < 0 || shift > 2 * k || n_keys < 0 || (uintptr_t)table % 16)
        return (int)cudaErrorInvalidValue;
    return launch(d1_count_keys_kernel, n, stream, keys, n, k, table, n_keys, directory, shift,
                  counts);
}

// D1_SCAN as this library was built with it
extern "C" int pg_d1_scan() { return D1_SCAN; }
