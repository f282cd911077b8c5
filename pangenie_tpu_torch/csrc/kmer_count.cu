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
// scatter; the card has atomics. Plain versions and wrappers:
// pangenie_tpu_torch/kmers/device_counter.py (extract_plain, count_plain;
// extract, count).
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
// (d = min(16, 2k)) holds where each bucket of the key's top d bits
// starts in the table, so a binary search runs inside one bucket. Counts
// are integers, so the result is exact in any order of the atomics.
//
// What bounds them on the H100: bytes. D1-extract reads 0.375 bytes a
// base and writes 8 a window; D1-count reads the same 0.375 and, at
// random, the table (8 bytes a key: a 32-byte sector a probe) and counts
// (4 bytes a key), so its floor is the packed stream plus the table and
// the counts read once (hmm/bounds.py: d1_extract, d1_count). Design,
// simple first: one thread a window, k loads of 2 bits and 1 bit from
// words the window's neighbours read too (L1), the search in the bucket
// with int32 indices, one atomicAdd a hit; no shared memory, no barrier.
#include <cuda_runtime.h>
#include <stdint.h>

#define D1_SENTINEL 0x7FFFFFFFFFFFFFFFLL
#define D1_THREADS 256

// The canonical key of window j, or D1_SENTINEL.
__device__ __forceinline__ long long d1_window(const uint32_t* words, const uint32_t* vwords,
                                               long long n_bases, long long j, int k) {
    if (j + k > n_bases) return D1_SENTINEL;
    unsigned long long fw = 0, rc = 0;
    for (int i = 0; i < k; ++i) {
        const long long p = j + i;
        if (!((vwords[p >> 5] >> (p & 31)) & 1u)) return D1_SENTINEL;
        const unsigned c = (words[p >> 4] >> (2 * (p & 15))) & 3u;
        fw = (fw << 2) | c;
        rc |= (unsigned long long)(3u - c) << (2 * i);
    }
    return (long long)(fw < rc ? fw : rc);
}

__global__ void __launch_bounds__(D1_THREADS)
d1_extract_kernel(const uint32_t* words, const uint32_t* vwords, long long n_bases, int k,
                  long long* keys) {
    const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (j < n_bases) keys[j] = d1_window(words, vwords, n_bases, j, k);
}

__global__ void __launch_bounds__(D1_THREADS)
d1_count_kernel(const uint32_t* words, const uint32_t* vwords, long long n_bases, int k,
                const long long* table, const int* directory, int shift, int* counts) {
    const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n_bases) return;
    const long long key = d1_window(words, vwords, n_bases, j, k);
    if (key == D1_SENTINEL) return;
    const long long bucket = key >> shift;
    const int end = directory[bucket + 1];
    int lo = directory[bucket], hi = end;
    while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        if (table[mid] < key)
            lo = mid + 1;
        else
            hi = mid;
    }
    if (lo < end && table[lo] == key) atomicAdd(counts + lo, 1);
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
// int64, its directory [2^d + 1] int32 (bucket = key >> shift, shift =
// 2k - d) in; counts [n] int32 incremented in place.
extern "C" int pg_d1_count(const uint32_t* words, const uint32_t* vwords, long long n_bases,
                           int k, const long long* table, const int* directory, int shift,
                           int* counts, void* stream) {
    if (!d1_takes(n_bases, k) || shift < 0 || shift > 2 * k) return (int)cudaErrorInvalidValue;
    return launch(d1_count_kernel, n_bases, stream, words, vwords, n_bases, k, table, directory,
                  shift, counts);
}
