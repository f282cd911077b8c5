// The fiber scheduler behind cuda_runtime.h (see there).
#include "cuda_runtime.h"

#include <map>
#include <memory>
#include <set>
#include <utility>
#include <vector>

#include <ucontext.h>

dim3 threadIdx, blockIdx, blockDim;
alignas(16) float smem[232448 / sizeof(float)];
// K1-K4, S1, V1 and D1 declare their dynamic shared memory under these names
extern float fbe_shm[232448 / sizeof(float)] __attribute__((alias("smem")));
extern float s1_shm[232448 / sizeof(float)] __attribute__((alias("smem")));
extern float v1_shm[232448 / sizeof(float)] __attribute__((alias("smem")));
extern float d1_shm[232448 / sizeof(float)] __attribute__((alias("smem")));

size_t emu_shared_bytes() { return sizeof(smem); }

namespace {

constexpr size_t STACK_BYTES = 1 << 16;

struct Fiber {
    ucontext_t ctx;
    // not zero-filled: only the pages a fiber touches take memory
    std::unique_ptr<char[]> stack;
    unsigned tid = 0;        // threadIdx.x
    unsigned block = 0;      // rank in the cluster
    unsigned gid = 0;        // block * threads + tid
    long cluster_gen = -1;   // the cluster barrier's generation at arrival
    bool done = false;
};

std::vector<Fiber> fibers;
ucontext_t scheduler;
Fiber* current = nullptr;
std::function<void()> kernel_body;
int block_threads = 0, cluster_ranks = 1;
size_t shared_used = 0;
// per block of the cluster
std::vector<long> block_arrived, block_generation;
long cluster_arrived = 0, cluster_generation = 0;
// every block's shared memory but the resident one's, which lies in smem
std::vector<std::vector<char>> shared_of;
unsigned resident = 0;
// (global warp, lane mask) -> (lanes arrived, generation)
std::map<std::pair<unsigned, unsigned>, std::pair<int, long>> lane_groups;
std::vector<uint64_t> lane_values;
std::set<const void*> non_portable;
// (block, offset in shared memory) -> its mbarrier
struct MBarrier {
    int pending = 1;   // arrivals the phase waits for (one a phase)
    long tx = 0;       // bytes expected less bytes come in
    unsigned phase = 0;
};
std::map<std::pair<unsigned, size_t>, MBarrier> mbarriers;
// grows at every barrier arrival and every finished fiber: a pass of
// the scheduler that leaves it unchanged is a deadlock
long progress = 0;

void yield() { swapcontext(&current->ctx, &scheduler); }

void fail(const char* what) {
    fprintf(stderr, "emulated %s\n", what);
    abort();
}

void fiber_entry() {
    kernel_body();
    current->done = true;
    ++progress;
    swapcontext(&current->ctx, &scheduler);
}

// block b's shared memory into smem, the resident block's out of it
void make_resident(unsigned b) {
    if (b == resident) return;
    memcpy(shared_of[resident].data(), smem, shared_used);
    memcpy(smem, shared_of[b].data(), shared_used);
    resident = b;
}

void lane_barrier(unsigned mask) {
    const auto key = std::make_pair(current->gid / 32, mask);
    auto& group = lane_groups[key];
    const long generation = group.second;
    ++progress;
    if (++group.first == __builtin_popcount(mask)) {
        group.first = 0;
        ++group.second;
        return;
    }
    while (lane_groups[key].second == generation) yield();
}

}  // namespace

void emu_syncthreads() {
    const unsigned b = current->block;
    const long generation = block_generation[b];
    ++progress;
    if (++block_arrived[b] == block_threads) {
        block_arrived[b] = 0;
        ++block_generation[b];
        return;
    }
    while (block_generation[b] == generation) yield();
}

unsigned emu_cluster_rank() { return current->block; }

void emu_cluster_arrive() {
    if (current->cluster_gen >= 0) fail("cluster barrier arrival twice without a wait");
    current->cluster_gen = cluster_generation;
    ++progress;
    if (++cluster_arrived == (long)cluster_ranks * block_threads) {
        cluster_arrived = 0;
        ++cluster_generation;
    }
}

void emu_cluster_wait() {
    if (current->cluster_gen < 0) fail("cluster barrier wait without an arrival");
    while (cluster_generation == current->cluster_gen) yield();
    current->cluster_gen = -1;
    ++progress;
}

namespace {

// The offset of p in the launch's shared memory (aborts outside it or
// where p is not aligned to `bytes`).
size_t shared_offset(const void* p, size_t bytes) {
    const char* at = static_cast<const char*>(p);
    const char* base = reinterpret_cast<const char*>(smem);
    if (at < base || at + bytes > base + shared_used)
        fail("shared memory access outside the launch's shared memory");
    if ((uintptr_t)at % bytes) fail("shared memory access misaligned");
    return at - base;
}

MBarrier& mbarrier(unsigned block, const void* bar) {
    auto it = mbarriers.find({block, shared_offset(bar, 8)});
    if (it == mbarriers.end()) fail("mbarrier used before it was set up");
    return it->second;
}

// the phase completes once its arrival and all its bytes are in
void mbar_progress(MBarrier& m) {
    if (m.tx < -(1L << 20) + 1 || m.tx > (1L << 20) - 1) fail("mbarrier byte count out of range");
    if (m.pending == 0 && m.tx == 0) {
        m.pending = 1;
        ++m.phase;
    }
    ++progress;
}

}  // namespace

void emu_mbar_init(const void* bar) {
    mbarriers[{current->block, shared_offset(bar, 8)}] = MBarrier();
}

void emu_mbar_expect(const void* bar, unsigned bytes) {
    MBarrier& m = mbarrier(current->block, bar);
    if (m.pending != 1) fail("mbarrier arrival past its count");
    m.pending = 0;
    m.tx += bytes;
    mbar_progress(m);
}

void emu_cluster_push(void* p, unsigned rank, const void* v, unsigned bytes, const void* bar) {
    if (rank >= (unsigned)cluster_ranks) fail("push outside the cluster");
    const size_t at = shared_offset(p, bytes);
    // the resident block's shared memory lies in smem, the others' apart
    char* dst = rank == resident ? reinterpret_cast<char*>(smem) + at
                                 : shared_of[rank].data() + at;
    memcpy(dst, v, bytes);
    MBarrier& m = mbarrier(rank, bar);
    m.tx -= bytes;
    mbar_progress(m);
}

void emu_mbar_wait(const void* bar, unsigned parity) {
    // the phase of parity `parity` has completed once the current phase's
    // parity differs from it
    while ((mbarrier(current->block, bar).phase & 1) == (parity & 1)) yield();
    ++progress;
}

namespace {

void global_counter(const void* counter) {
    const char* at = static_cast<const char*>(counter);
    const char* base = reinterpret_cast<const char*>(smem);
    if (at >= base && at < base + sizeof(smem)) fail("grid counter in shared memory");
    if ((uintptr_t)at % sizeof(unsigned)) fail("grid counter misaligned");
}

}  // namespace

void emu_grid_arrive(unsigned* counter) {
    global_counter(counter);
    ++*counter;
    ++progress;
}

void emu_grid_wait(const unsigned* counter, unsigned target) {
    global_counter(counter);
    while ((int)(*counter - target) < 0) yield();
    ++progress;
}

void emu_allow_cluster(const void* kernel, bool allowed) {
    if (allowed) non_portable.insert(kernel);
    else non_portable.erase(kernel);
}

bool emu_cluster_allowed(const void* kernel, int ranks) {
    return ranks <= 8 || non_portable.count(kernel);
}

int emu_lane() { return (int)(current->tid % 32); }

void emu_syncwarp(unsigned mask) {
    if (!((mask >> (current->tid % 32)) & 1u)) fail("__syncwarp outside its lane mask");
    lane_barrier(mask);
}

// a cache hint: nothing to emulate, but the address must be one
void emu_prefetch(const void* p) {
    if (p == nullptr) fail("prefetch of a null address");
}

uint64_t emu_exchange(unsigned mask, uint64_t bits, int src) {
    const unsigned lane = current->tid % 32, warp = current->gid / 32;
    if (!((mask >> lane) & 1u) || (src >= 0 && !((mask >> src) & 1u)))
        fail("warp exchange outside its lane mask");
    lane_values[current->gid] = bits;
    lane_barrier(mask);
    uint64_t got = ~0ull;
    if (src >= 0) {
        got = lane_values[warp * 32 + src];
    } else {
        for (unsigned l = 0; l < 32; ++l)
            if ((mask >> l) & 1u) got = std::min(got, lane_values[warp * 32 + l]);
    }
    lane_barrier(mask);
    return got;
}

unsigned emu_match(unsigned mask, uint64_t bits) {
    const unsigned lane = current->tid % 32, warp = current->gid / 32;
    if (!((mask >> lane) & 1u)) fail("warp match outside its lane mask");
    lane_values[current->gid] = bits;
    lane_barrier(mask);
    unsigned got = 0;
    for (unsigned l = 0; l < 32; ++l)
        if ((mask >> l) & 1u && lane_values[warp * 32 + l] == bits) got |= 1u << l;
    lane_barrier(mask);
    return got;
}

int emu_run_cluster(int grid, int ranks, int threads, size_t smem_bytes,
                    std::function<void()> body) {
    if (threads % 32 || threads > 1024 || smem_bytes > sizeof(smem) || ranks < 1 ||
        grid % ranks)
        return 1;
    kernel_body = std::move(body);
    block_threads = threads;
    cluster_ranks = ranks;
    shared_used = smem_bytes;
    blockDim = {(unsigned)threads, 1, 1};
    const int n = ranks * threads;
    for (int base = 0; base < grid; base += ranks) {
        // NaN bits in every block's shared memory: a read before a write shows
        memset(smem, 0xff, sizeof(smem));
        shared_of.assign(ranks, std::vector<char>(shared_used, (char)0xff));
        resident = 0;
        fibers.clear();
        fibers.resize(n);
        block_arrived.assign(ranks, 0);
        block_generation.assign(ranks, 0);
        cluster_arrived = cluster_generation = 0;
        mbarriers.clear();
        lane_groups.clear();
        lane_values.assign(n, 0);
        for (int g = 0; g < n; ++g) {
            Fiber& f = fibers[g];
            f.gid = g;
            f.block = g / threads;
            f.tid = g % threads;
            f.stack.reset(new char[STACK_BYTES]);
            getcontext(&f.ctx);
            f.ctx.uc_stack.ss_sp = f.stack.get();
            f.ctx.uc_stack.ss_size = STACK_BYTES;
            f.ctx.uc_link = nullptr;
            makecontext(&f.ctx, fiber_entry, 0);
        }
        // a warp runs until all its threads wait at a barrier (or are
        // done) before the next warp starts, so a warp that reuses shared
        // memory before slower warps have read it shows; a block runs
        // until none of its warps can go on before the next block starts
        // (the blocks of a cluster or cooperative grid in rank order), so
        // a block that reads what another has not yet published runs
        // ahead of it and shows
        const int warps = block_threads / 32;
        for (bool left = true; left;) {
            left = false;
            const long before = progress;
            for (int b = 0; b < ranks; ++b) {
                for (long block_before = -1; block_before != progress;) {
                    block_before = progress;
                    for (int w = b * warps; w < (b + 1) * warps; ++w) {
                        for (long warp_before = -1; warp_before != progress;) {
                            warp_before = progress;
                            for (int g = 32 * w; g < 32 * w + 32; ++g) {
                                Fiber& f = fibers[g];
                                if (f.done) continue;
                                make_resident(f.block);
                                current = &f;
                                threadIdx = {f.tid, 0, 0};
                                blockIdx = {(unsigned)base + f.block, 0, 0};
                                swapcontext(&scheduler, &f.ctx);
                            }
                        }
                    }
                }
            }
            for (const Fiber& f : fibers) left |= !f.done;
            if (left && progress == before) {
                fprintf(stderr, "emulated block %d deadlocked at a barrier\n", base);
                abort();
            }
        }
        make_resident(0);
    }
    return 0;
}
