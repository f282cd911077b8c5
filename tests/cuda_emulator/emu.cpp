// The fiber scheduler behind cuda_runtime.h (see there).
#include "cuda_runtime.h"

#include <map>
#include <utility>
#include <vector>

#include <ucontext.h>

dim3 threadIdx, blockIdx, blockDim;
alignas(16) float smem[232448 / sizeof(float)];
// K3/K4 and S1 declare their dynamic shared memory under these names
extern float fbe_shm[232448 / sizeof(float)] __attribute__((alias("smem")));
extern float s1_shm[232448 / sizeof(float)] __attribute__((alias("smem")));

size_t emu_shared_bytes() { return sizeof(smem); }

namespace {

struct Fiber {
    ucontext_t ctx;
    std::vector<char> stack;
    unsigned tid = 0;
    bool done = false;
};

std::vector<Fiber> fibers;
ucontext_t scheduler;
Fiber* current = nullptr;
std::function<void()> kernel_body;
int block_threads = 0;
long block_arrived = 0, block_generation = 0;
// (warp, lane mask) -> (lanes arrived, generation)
std::map<std::pair<unsigned, unsigned>, std::pair<int, long>> lane_groups;
std::vector<uint64_t> lane_values;
// grows at every barrier arrival and every finished fiber: a pass of
// the scheduler that leaves it unchanged is a deadlock
long progress = 0;

void yield() { swapcontext(&current->ctx, &scheduler); }

void fiber_entry() {
    kernel_body();
    current->done = true;
    ++progress;
    swapcontext(&current->ctx, &scheduler);
}

void lane_barrier(unsigned mask) {
    const auto key = std::make_pair(current->tid / 32, mask);
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
    const long generation = block_generation;
    ++progress;
    if (++block_arrived == block_threads) {
        block_arrived = 0;
        ++block_generation;
        return;
    }
    while (block_generation == generation) yield();
}

int emu_lane() { return (int)(current->tid % 32); }

void emu_syncwarp(unsigned mask) {
    if (!((mask >> (current->tid % 32)) & 1u)) {
        fprintf(stderr, "emulated __syncwarp outside its lane mask\n");
        abort();
    }
    lane_barrier(mask);
}

// a cache hint: nothing to emulate, but the address must be one
void emu_prefetch(const void* p) {
    if (p == nullptr) {
        fprintf(stderr, "emulated prefetch of a null address\n");
        abort();
    }
}

uint64_t emu_exchange(unsigned mask, uint64_t bits, int src) {
    const unsigned lane = current->tid % 32, warp = current->tid / 32;
    if (!((mask >> lane) & 1u) || (src >= 0 && !((mask >> src) & 1u))) {
        fprintf(stderr, "emulated warp exchange outside its lane mask\n");
        abort();
    }
    lane_values[current->tid] = bits;
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

int emu_run(int grid, int threads, size_t smem_bytes, std::function<void()> body) {
    if (threads % 32 || threads > 1024 || smem_bytes > sizeof(smem)) return 1;
    kernel_body = std::move(body);
    block_threads = threads;
    blockDim = {(unsigned)threads, 1, 1};
    for (int b = 0; b < grid; ++b) {
        memset(smem, 0xff, sizeof(smem));   // NaN bits: a read before a write shows
        fibers.assign(threads, Fiber());
        block_arrived = block_generation = 0;
        lane_groups.clear();
        lane_values.assign(threads, 0);
        for (int t = 0; t < threads; ++t) {
            Fiber& f = fibers[t];
            f.tid = t;
            f.stack.resize(1 << 16);
            getcontext(&f.ctx);
            f.ctx.uc_stack.ss_sp = f.stack.data();
            f.ctx.uc_stack.ss_size = f.stack.size();
            f.ctx.uc_link = nullptr;
            makecontext(&f.ctx, fiber_entry, 0);
        }
        // a warp runs until all its threads wait at __syncthreads (or are
        // done) before the next warp starts, so a warp that reuses shared
        // memory before slower warps have read it shows
        for (bool left = true; left;) {
            left = false;
            const long before = progress;
            for (int w = 0; w < threads / 32; ++w) {
                for (long warp_before = -1; warp_before != progress;) {
                    warp_before = progress;
                    for (int t = 32 * w; t < 32 * w + 32; ++t) {
                        Fiber& f = fibers[t];
                        if (f.done) continue;
                        current = &f;
                        threadIdx = {f.tid, 0, 0};
                        blockIdx = {(unsigned)b, 0, 0};
                        swapcontext(&scheduler, &f.ctx);
                    }
                }
            }
            for (const Fiber& f : fibers) left |= !f.done;
            if (left && progress == before) {
                fprintf(stderr, "emulated block %d deadlocked at a barrier\n", b);
                abort();
            }
        }
    }
    return 0;
}
