// Kernels D1-extract, D1-count, D1-route and D1-count-keys, read k-mer
// counting for Hopper (sm_90a): the canonical k-mers of packed sequence
// blocks, and their counts in a sorted table of k-mers, whole or
// hash-partitioned over ranks.
//
// Replace: pangenie_tpu/kmers/device_counter.py, XLA programs without
// Pallas. D1-extract replaces extract_canonical (:142, with its
// unpack_codes_2bit, :100, fused in); D1-count replaces the PRIME+UPDATE
// step, lookup_pair_directed (:430) + primed_update_batch (:458), and the
// sorted merge join primed_update_merge (:474) with its buffered form
// (_ingest_packed, _flush_tagged), which the TPU took for want of a
// scatter; the card has atomics. D1-route bins a block's keys by
// (owner, region) for the partitioned counter, and D1-count-keys counts
// the keys a rank receives (see each below). Plain versions and wrappers:
// pangenie_tpu_torch/kmers/device_counter.py (extract_plain, count_plain,
// route_plain, count_keys_plain; extract, count, route, count_keys).
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

// The bucket [lo, hi) of key narrowed by binary steps to at most
// D1_SCAN keys: the key, if the table holds it, still lies in it.
__device__ __forceinline__ void d1_narrow(const long long* table, long long key, int& lo,
                                          int& hi) {
    while (hi - lo > D1_SCAN) {
        const int mid = lo + ((hi - lo) >> 1);
        if (__ldg(table + mid) <= key)
            lo = mid;
        else
            hi = mid;
    }
}

// The index of key in [lo, hi) (at most D1_SCAN keys of the sorted,
// unique table [n_keys]), or -1: [lo, hi) as 16-byte pairs from lo's even
// neighbour: table[lo - 1] and table[hi] are not the key (sorted, unique),
// so only the table's end bounds a pair.
__device__ __forceinline__ int d1_scan(const long long* table, int n_keys, long long key, int lo,
                                       int hi) {
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

// The index of key in the sorted, unique table [n_keys], or -1: the
// directory [2^d + 1] (bucket = key >> shift) bounds where it can lie.
// D1-count and D1-count-keys both search through d1_narrow and d1_scan.
__device__ __forceinline__ int d1_find(const long long* table, int n_keys, const int* directory,
                                       int shift, long long key) {
    const long long bucket = key >> shift;
    int lo = __ldg(directory + bucket), hi = __ldg(directory + bucket + 1);
    d1_narrow(table, key, lo, hi);
    return d1_scan(table, n_keys, key, lo, hi);
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

// Every kernel below keeps its shared memory here, sized at launch.
extern __shared__ __align__(16) int d1_shm[];

// ---------------------------------------------------------------------------
// D1-route: a block's keys binned for the partitioned counter
// (device_counter.route). The bin of a key is (owner << r) | region: the
// owner is device_counter.owner_of's hash (the reference's _owner_mix of
// the key tagged as it tags keys), the region the key's top r bits of
// its 2k, a prefix of D1's directory bucket. SENTINEL, and any key outside
// 2k bits, has none and is dropped. The output holds the binned keys bin
// after bin, each bin's keys in their input order (a stable counting
// sort: the plain version's torch.sort(stable=True), bit for bit), and
// each bin's size. A rank sends bins (t, *) to rank t, so the receiver
// gets each sender's keys in region order and knows where each region
// begins (D1-count-keys below reads them so).
//
// It replaces the reference's binning of the ingest step
// (ShardedPrimedDeviceCounter._ingest_program, a one-hot cumsum into
// [D, capacity] bins) and the port's torch route before it (owner, a
// stable torch.sort of the int64 owners, torch.bincount, a gather), which
// took 11.8 ms on 30 M keys. What bounds it: bytes, the keys read and the
// binned keys written once (16 bytes a valid key). A counting sort in two
// passes over the keys reads them twice: pass 1 (d1_route_count_kernel)
// gives each of `ctas` CTAs a contiguous range of the keys and counts its
// bins in shared memory (a warp's keys of one bin counted by one atomic:
// __match_any_sync groups them); the counts go to hist [ctas][bins];
// d1_route_scan_kernel turns them into each (CTA, bin)'s place among the
// bin's keys and each bin's size, d1_route_starts_kernel the bins' starts;
// pass 2 (d1_route_scatter_kernel) walks the same range in tiles of
// D1R_TILE keys and writes each key to its bin's next place. To keep a
// bin's keys in order, a tile's warps take their places one after
// another (a barrier between them); within a warp, the lanes of one bin
// take consecutive places from one shared counter, by their rank among
// that bin's lanes. n_ranks 2^r counters must fit one CTA's shared
// memory (D1R_MAX_BINS). Its time grows with the bins (on 40 M keys into
// 4 owners 0.57 ms at r = 0, 1.90 at r = 8: PERF.md), and neither finding
// a warp's lanes of a bin by a ballot a bit in place of
// __match_any_sync nor the number of CTAs (132-2048) changed that.
#define D1R_THREADS 256
#define D1R_WARPS (D1R_THREADS / 32)
// keys a thread loads at a time (device_counter.ROUTE_TILE mirrors the tile)
#define D1R_ITEMS 4
#define D1R_TILE (D1R_THREADS * D1R_ITEMS)
#define D1R_MAX_BINS (1 << 14)
#define D1R_STARTS_THREADS 1024

// The bin of key among n_ranks << r, or -1 for SENTINEL and any key
// outside 2k bits.
__device__ __forceinline__ int d1_bin(long long key, int k, int n_ranks, int r) {
    if ((unsigned long long)key >> (2 * k)) return -1;
    const unsigned long long tagged = (unsigned long long)key << 1;
    const uint32_t hi = (uint32_t)(tagged >> 32), lo = (uint32_t)tagged & 0xFFFFFFFEu;
    const uint32_t mix = ((hi ^ 0x9E3779B9u) * 0x85EBCA6Bu) ^ (lo * 0xC2B2AE35u);
    const int owner = (int)(mix % (uint32_t)n_ranks);
    return (owner << r) | (int)((unsigned long long)key >> (2 * k - r));
}

// The keys [start, end) of this CTA: whole tiles, ceil(tiles / ctas) each.
__device__ __forceinline__ void d1r_range(long long m, int ctas, long long& start,
                                          long long& end) {
    const long long tiles = (m + D1R_TILE - 1) / D1R_TILE;
    const long long span = (tiles + ctas - 1) / ctas * D1R_TILE;
    start = min(m, (long long)blockIdx.x * span);
    end = min(m, start + span);
}

__global__ void __launch_bounds__(D1R_THREADS)
d1_route_count_kernel(const long long* keys, long long m, int k, int n_ranks, int r, int ctas,
                      int* hist) {
    const int bins = n_ranks << r, lane = threadIdx.x & 31;
    int* count = d1_shm;
    for (int b = threadIdx.x; b < bins; b += D1R_THREADS) count[b] = 0;
    __syncthreads();
    long long start, end;
    d1r_range(m, ctas, start, end);
    for (long long tile = start; tile < end; tile += D1R_TILE) {
        int bin[D1R_ITEMS];
#pragma unroll
        for (int j = 0; j < D1R_ITEMS; ++j) {
            const long long i = tile + j * D1R_THREADS + threadIdx.x;
            bin[j] = i < end ? d1_bin(__ldg(keys + i), k, n_ranks, r) : -1;
        }
#pragma unroll
        for (int j = 0; j < D1R_ITEMS; ++j) {
            const unsigned peers = __match_any_sync(0xFFFFFFFFu, bin[j]);
            if (bin[j] >= 0 && lane == __ffs(peers) - 1) atomicAdd(count + bin[j], __popc(peers));
        }
    }
    __syncthreads();
    for (int b = threadIdx.x; b < bins; b += D1R_THREADS)
        hist[(long long)blockIdx.x * bins + b] = count[b];
}

// hist [ctas][bins] in place: entry (c, b) becomes the keys of bin b in
// the CTAs before c; sizes[b] the keys of bin b. A block takes 32 bins (a
// lane each), its warps a slice of the CTAs each.
__global__ void __launch_bounds__(D1R_THREADS)
d1_route_scan_kernel(int* hist, int ctas, int bins, long long* sizes) {
    int* part = d1_shm;  // [D1R_WARPS][32]
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int b = blockIdx.x * 32 + lane;
    const int per = (ctas + D1R_WARPS - 1) / D1R_WARPS;
    const int c0 = min(ctas, warp * per), c1 = min(ctas, c0 + per);
    int sum = 0;
    if (b < bins)
        for (int c = c0; c < c1; ++c) sum += hist[(long long)c * bins + b];
    part[warp * 32 + lane] = sum;
    __syncthreads();
    int run = 0;
    for (int w = 0; w < warp; ++w) run += part[w * 32 + lane];
    if (b < bins) {
        for (int c = c0; c < c1; ++c) {
            const long long at = (long long)c * bins + b;
            const int n = hist[at];
            hist[at] = run;
            run += n;
        }
        if (warp == D1R_WARPS - 1) sizes[b] = run;
    }
}

// starts[b]: the keys of the bins before b (one block).
__global__ void __launch_bounds__(D1R_STARTS_THREADS)
d1_route_starts_kernel(const long long* sizes, int bins, long long* starts) {
    long long* part = reinterpret_cast<long long*>(d1_shm);  // [D1R_STARTS_THREADS]
    const int t = threadIdx.x, per = (bins + D1R_STARTS_THREADS - 1) / D1R_STARTS_THREADS;
    const int b0 = min(bins, t * per), b1 = min(bins, b0 + per);
    long long sum = 0;
    for (int b = b0; b < b1; ++b) sum += sizes[b];
    part[t] = sum;
    __syncthreads();
    for (int o = 1; o < D1R_STARTS_THREADS; o <<= 1) {
        const long long add = t >= o ? part[t - o] : 0;
        __syncthreads();
        part[t] += add;
        __syncthreads();
    }
    long long run = part[t] - sum;
    for (int b = b0; b < b1; ++b) {
        starts[b] = run;
        run += sizes[b];
    }
}

__global__ void __launch_bounds__(D1R_THREADS)
d1_route_scatter_kernel(const long long* keys, long long m, int k, int n_ranks, int r, int ctas,
                        const int* hist, const long long* starts, long long* out) {
    const int bins = n_ranks << r;
    int* next = d1_shm;  // [bins]: where this CTA's next key of each bin goes
    for (int b = threadIdx.x; b < bins; b += D1R_THREADS)
        next[b] = (int)(starts[b] + hist[(long long)blockIdx.x * bins + b]);
    __syncthreads();
    long long start, end;
    d1r_range(m, ctas, start, end);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned below = (1u << lane) - 1;
    for (long long tile = start; tile < end; tile += D1R_TILE) {
        // warp w holds the tile's keys [w, w + 1) * 32 D1R_ITEMS, in order
        long long key[D1R_ITEMS];
        int bin[D1R_ITEMS];
        unsigned peers[D1R_ITEMS];
#pragma unroll
        for (int j = 0; j < D1R_ITEMS; ++j) {
            const long long i = tile + (warp * D1R_ITEMS + j) * 32 + lane;
            key[j] = i < end ? __ldg(keys + i) : D1_SENTINEL;
            bin[j] = i < end ? d1_bin(key[j], k, n_ranks, r) : -1;
            peers[j] = __match_any_sync(0xFFFFFFFFu, bin[j]);
        }
        for (int w = 0; w < D1R_WARPS; ++w) {
            if (warp == w) {
#pragma unroll
                for (int j = 0; j < D1R_ITEMS; ++j) {
                    // every lane of a bin reads its counter, then its
                    // first lane moves it past them
                    const int at = bin[j] >= 0 ? next[bin[j]] : 0;
                    __syncwarp();
                    if (bin[j] >= 0) {
                        if (lane == __ffs(peers[j]) - 1) next[bin[j]] = at + __popc(peers[j]);
                        out[at + __popc(peers[j] & below)] = key[j];
                    }
                    __syncwarp();
                }
            }
            __syncthreads();
        }
    }
}

// ---------------------------------------------------------------------------
// D1-count-keys: keys already extracted (a partition's share of the read
// windows, routed to the rank that holds it) counted into the partition's
// table: a key of 2k bits found at table[i] adds one to counts[i];
// SENTINEL, and any key of more than 2k bits, matches nothing. It
// replaces the sharded counter's shard-local flush, _flush_tagged (:593).
//
// What bounds it: the keys read once, the table and counts read and the
// counts written once (hmm/bounds.py: d1_count_keys). But each key makes
// three dependent random reads (two directory entries, the bucket's keys,
// a count) of sectors no other key reads, in a partition of 100-200 MB
// (at a human graph's 700 M keys a rank, 10 GB) against a 50 MB L2: one
// thread a key in arrival order took 16.8x its bound. So the keys come in
// region order (D1-route sends them so) and are read region-major across
// the senders: segment s (region s / senders, sender s % senders) of the
// received runs holds [seg_v[s], seg_v[s + 1]) of the order the CTAs take,
// which begins at seg_p[s] of keys. The keys that the CTAs in flight
// hold then lie in a few regions, so the slice of directory, table and
// counts they read stays in L2 while they are in flight (on the SV
// partition of 2, 1.82 ms in arrival order, 0.54 at r = 4; on a 700
// M-key partition from four senders 5.65 ms, 3.17 at r = 8, where reading
// the senders' runs one after another took 4.79: PERF.md). A thread
// carries D1_KPT keys through each step of the search together; one was
// fastest (on the 700 M-key partition at r = 8: 3.17 ms against 4.26 at
// 4, the keys in flight spanning more of the table), and staging a CTA's
// slice of the directory in shared memory lost 2-70% wherever it applied.
// Counts are integers, so the result is exact in any order, and keys in
// any order are counted right.
#ifndef D1_KPT
#define D1_KPT 1
#endif
#define D1K_TILE (D1_THREADS * D1_KPT)

// The segment of position v among [lo, hi]: the last s with seg_v[s] <= v
// (empty segments share their start with the next).
__device__ __forceinline__ int d1_segment(const long long* seg_v, int lo, int hi, long long v) {
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (__ldg(seg_v + mid) <= v)
            lo = mid;
        else
            hi = mid - 1;
    }
    return lo;
}

__global__ void __launch_bounds__(D1_THREADS)
d1_count_keys_kernel(const long long* keys, long long n, int k, const long long* table,
                     int n_keys, const int* directory, int shift, int* counts,
                     const long long* seg_v, const long long* seg_p, int n_segs) {
    const long long v0 = (long long)blockIdx.x * D1K_TILE, v1 = min(n, v0 + D1K_TILE);
    const int s_lo = d1_segment(seg_v, 0, n_segs - 1, v0);
    const int s_hi = d1_segment(seg_v, s_lo, n_segs - 1, v1 - 1);
    long long key[D1_KPT];
    int lo[D1_KPT], hi[D1_KPT], hit[D1_KPT];
#pragma unroll
    for (int j = 0; j < D1_KPT; ++j) {
        const long long v = v0 + j * D1_THREADS + threadIdx.x;
        key[j] = D1_SENTINEL;
        if (v < v1) {
            const int s = d1_segment(seg_v, s_lo, s_hi, v);
            key[j] = __ldg(keys + __ldg(seg_p + s) + (v - __ldg(seg_v + s)));
        }
    }
#pragma unroll
    for (int j = 0; j < D1_KPT; ++j) {
        lo[j] = hi[j] = 0;
        if (!((unsigned long long)key[j] >> (2 * k))) {
            const long long bucket = key[j] >> shift;
            lo[j] = __ldg(directory + bucket);
            hi[j] = __ldg(directory + bucket + 1);
        }
    }
#pragma unroll
    for (int j = 0; j < D1_KPT; ++j) d1_narrow(table, key[j], lo[j], hi[j]);
#pragma unroll
    for (int j = 0; j < D1_KPT; ++j) hit[j] = d1_scan(table, n_keys, key[j], lo[j], hi[j]);
#pragma unroll
    for (int j = 0; j < D1_KPT; ++j)
        if (hit[j] >= 0) atomicAdd(counts + hit[j], 1);
}

// `blocks` blocks of `threads` threads with `shared` bytes of dynamic
// shared memory on the caller's stream; returns the cudaError_t.
template <typename Kernel, typename... Args>
static int launch(Kernel kernel, long long blocks, int threads, size_t shared, void* stream,
                  Args... args) {
    if (shared > 48 * 1024 &&
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)shared) != cudaSuccess)
        return (int)cudaErrorInvalidValue;
    kernel<<<(unsigned)blocks, threads, shared, (cudaStream_t)stream>>>(args...);
    return (int)cudaGetLastError();
}

// one thread an item of n
static long long d1_blocks(long long n) { return (n + D1_THREADS - 1) / D1_THREADS; }

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
    return launch(d1_extract_kernel, d1_blocks(n_bases), D1_THREADS, 0, stream, words, vwords,
                  n_bases, k, keys);
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
    return launch(d1_count_kernel, d1_blocks(n_bases), D1_THREADS, 0, stream, words, vwords,
                  n_bases, k, table, n_keys, directory, shift, counts);
}

// D1-route: keys [m] int64 (m < 2^31) in; out [m] int64 (the first
// sum(sizes) entries written: the binned keys), sizes [n_ranks << r]
// int64 out; hist [ctas * (n_ranks << r)] int32 and starts [n_ranks << r]
// int64 scratch. Four launches on the caller's stream.
extern "C" int pg_d1_route(const long long* keys, long long m, int k, int n_ranks, int r,
                           int ctas, long long* out, long long* sizes, int* hist,
                           long long* starts, void* stream) {
    if (!d1_takes(m, k) || m >= (1LL << 31) || n_ranks < 1 || r < 0 || r > 14 || r > 2 * k ||
        ctas < 1 || ((long long)n_ranks << r) > D1R_MAX_BINS)
        return (int)cudaErrorInvalidValue;
    const int bins = n_ranks << r;
    const size_t bin_bytes = (size_t)bins * sizeof(int);
    int code = launch(d1_route_count_kernel, ctas, D1R_THREADS, bin_bytes, stream, keys, m, k,
                      n_ranks, r, ctas, hist);
    if (!code)
        code = launch(d1_route_scan_kernel, (bins + 31) / 32, D1R_THREADS,
                      D1R_THREADS * sizeof(int), stream, hist, ctas, bins, sizes);
    if (!code)
        code = launch(d1_route_starts_kernel, 1, D1R_STARTS_THREADS,
                      D1R_STARTS_THREADS * sizeof(long long), stream, sizes, bins, starts);
    if (!code)
        code = launch(d1_route_scatter_kernel, ctas, D1R_THREADS, bin_bytes, stream, keys, m, k,
                      n_ranks, r, ctas, hist, starts, out);
    return code;
}

// D1-count-keys: keys [n] int64 (k-mers of 2k bits, SENTINEL skipped)
// read through the segments (seg_v [n_segs + 1] with seg_v[0] = 0 and
// seg_v[n_segs] = n, seg_p [n_segs], int64), the table, directory and
// shift as D1-count's; counts [n_keys] int32 incremented in place.
extern "C" int pg_d1_count_keys(const long long* keys, long long n, int k,
                                const long long* table, int n_keys, const int* directory,
                                int shift, int* counts, const long long* seg_v,
                                const long long* seg_p, int n_segs, void* stream) {
    if (!d1_takes(n, k) || shift < 0 || shift > 2 * k || n_keys < 0 || (uintptr_t)table % 16 ||
        n_segs < 1)
        return (int)cudaErrorInvalidValue;
    return launch(d1_count_keys_kernel, (n + D1K_TILE - 1) / D1K_TILE, D1_THREADS, 0, stream,
                  keys, n, k, table, n_keys, directory, shift, counts, seg_v, seg_p, n_segs);
}

// D1_SCAN and D1_KPT as this library was built with them
extern "C" int pg_d1_scan() { return D1_SCAN; }
extern "C" int pg_d1_kpt() { return D1_KPT; }
