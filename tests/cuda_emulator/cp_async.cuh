// The emulator's stand-in for pangenie_tpu_torch/csrc/cp_async.cuh:
// each cp.async is an immediate copy, so commits and waits have nothing
// to do. A 16-byte copy must still be 16-byte aligned at both ends.
#pragma once

#include <cuda_runtime.h>

inline void emu_copy(void* dst, const void* src, int bytes) {
    if (bytes == 16 && (((uintptr_t)dst | (uintptr_t)src) & 15)) {
        fprintf(stderr, "emulated cp.async of 16 bytes is misaligned\n");
        abort();
    }
    memcpy(dst, src, bytes);
}

inline void cp_async4(void* dst, const void* src) { emu_copy(dst, src, 4); }
inline void cp_async16(void* dst, const void* src) { emu_copy(dst, src, 16); }
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}
