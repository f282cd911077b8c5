// The fiber scheduler behind cuda_runtime.h (see there).
#include "cuda_runtime.h"

#include <map>
#include <utility>
#include <vector>

#include <ucontext.h>

dim3 threadIdx, blockIdx, blockDim;
alignas(16) float smem[232448 / sizeof(float)];
// K3/K4 declare their dynamic shared memory under this name
extern float fbe_shm[232448 / sizeof(float)] __attribute__((alias("smem")));

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
std::vector<float> lane_values;
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

float emu_shfl(unsigned mask, float v, bool down, int offset) {
    const unsigned lane = current->tid % 32, warp = current->tid / 32;
    const unsigned src = down ? (lane + offset < 32 ? lane + offset : lane) : (lane ^ offset);
    if (!((mask >> lane) & 1u) || !((mask >> src) & 1u)) {
        fprintf(stderr, "emulated shuffle outside its lane mask\n");
        abort();
    }
    lane_values[current->tid] = v;
    lane_barrier(mask);
    const float got = lane_values[warp * 32 + src];
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
        lane_values.assign(threads, 0.f);
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
        for (bool left = true; left;) {
            left = false;
            const long before = progress;
            for (Fiber& f : fibers) {
                if (f.done) continue;
                current = &f;
                threadIdx = {f.tid, 0, 0};
                blockIdx = {(unsigned)b, 0, 0};
                swapcontext(&scheduler, &f.ctx);
                left |= !f.done;
            }
            if (left && progress == before) {
                fprintf(stderr, "emulated block %d deadlocked at a barrier\n", b);
                abort();
            }
        }
    }
    return 0;
}
