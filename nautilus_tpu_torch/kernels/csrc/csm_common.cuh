// What the CSM kernels (csm_correlate.cu, csm_coarse.cu) share on Hopper
// (sm_90a): asynchronous copies from global to shared memory, as 1-D bulk
// copies (the Tensor Memory Accelerator's cp.async.bulk) that complete on an
// mbarrier; the staging of a table; the lanes' share of the offset window;
// and the card's limits that kernels/plan.py plans with.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace nautilus {

constexpr int kAlign = 16;   // a bulk copy moves 16-byte-aligned 16-byte pieces
constexpr int kSlots = 8;    // offsets a lane sums: neighbouring columns
// Bytes past a staged table that a lane's last slots may read (their sums
// are dropped).
constexpr int kOverreach = kSlots * 4;
// Largest single bulk copy: a table goes in pieces of this size, all on one
// barrier phase, whose transaction count (under 2^20 bytes) covers the
// 227 KB a block can stage.
constexpr unsigned kMaxCopyBytes = 65536;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the barriers' initialisation visible to the bulk-copy unit; a
// __syncthreads must follow before other threads use them.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Orders this thread's earlier shared-memory accesses before its later
// bulk copies into the same memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Arrives on `bar` and adds `bytes` to the bytes its phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n\t"
      ".reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t"
      "}" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) that completes on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ uintptr_t align_up(uintptr_t a) {
  return (a + kAlign - 1) & ~static_cast<uintptr_t>(kAlign - 1);
}

__device__ __forceinline__ uintptr_t align_down(uintptr_t a) {
  return a & ~static_cast<uintptr_t>(kAlign - 1);
}

// Shared memory of a staged table of `rows` rows of `stride` words (see
// stage_table), as kernels/plan.py:table_bytes computes it.
inline size_t table_bytes(int rows, int stride) {
  return static_cast<size_t>(rows) * stride * sizeof(float) + kAlign
         + kOverreach;
}

// Where a staged copy of `src` starts in `region` (16-byte aligned,
// table_bytes long): at the same address modulo 16 as `src`.
__device__ __forceinline__ float* staged_at(void* region, const float* src) {
  return reinterpret_cast<float*>(
      static_cast<char*>(region)
      + (reinterpret_cast<uintptr_t>(src) & (kAlign - 1)));
}

// Stages n floats of `src` into `dst = staged_at(region, src)`: thread 0
// issues bulk copies of the 16-byte-aligned interior, completing on `bar`
// (one phase); threads 1-6 copy the unaligned head and tail words with
// plain loads, which a __syncthreads must publish.
__device__ __forceinline__ void stage_bulk(float* dst, const float* src,
                                           long long n, uint64_t* bar,
                                           int tid) {
  const uintptr_t s0 = reinterpret_cast<uintptr_t>(src);
  const uintptr_t s1 = s0 + static_cast<uintptr_t>(n) * sizeof(float);
  const uintptr_t a0 = align_up(s0) < s1 ? align_up(s0) : s1;
  const uintptr_t a1 = align_down(s1) > a0 ? align_down(s1) : a0;
  const int head = static_cast<int>((a0 - s0) / sizeof(float));
  const int tail = static_cast<int>((s1 - a1) / sizeof(float));
  if (tid == 0) {
    const unsigned total = static_cast<unsigned>(a1 - a0);
    mbar_expect_tx(bar, total);
    for (unsigned done = 0; done < total; done += kMaxCopyBytes) {
      const unsigned bytes =
          total - done < kMaxCopyBytes ? total - done : kMaxCopyBytes;
      bulk_copy(reinterpret_cast<char*>(dst + head) + done,
                reinterpret_cast<const char*>(a0) + done, bytes, bar);
    }
  } else if (tid <= head) {
    dst[tid - 1] = src[tid - 1];
  } else if (tid <= head + tail) {
    const long long i = n - tail + (tid - 1 - head);
    dst[i] = src[i];
  }
}

// Stages a [rows, width] table into shared memory with row stride `stride`
// (in words).  Unpadded (stride == width), by stage_bulk; padded, by plain
// loads of every thread, and thread 0 completes `bar`'s phase at once.
// Either way a __syncthreads must follow before the plain stores are read,
// and mbar_wait(bar, 0) before the bulk copies' words are.
__device__ __forceinline__ float* stage_table(void* region, const float* src,
                                              int rows, int width, int stride,
                                              uint64_t* bar, int tid,
                                              int threads) {
  const long long n = static_cast<long long>(rows) * width;
  if (stride == width) {
    float* dst = staged_at(region, src);
    stage_bulk(dst, src, n, bar, tid);
    return dst;
  }
  float* dst = static_cast<float*>(region);
  if (tid == 0) mbar_expect_tx(bar, 0);
  for (long long i = tid; i < n; i += threads) {
    dst[(i / width) * stride + i % width] = src[i];
  }
  return dst;
}

// A lane's share of the offset window (kernels/plan.py:window_lanes): up
// to kSlots neighbouring columns of one row, packed as
// row | first column << 8 | columns << 16.
struct Lanes {
  int v[32];
};

struct Lane {
  int row, col, n;
};

__device__ __forceinline__ Lane lane_of(const Lanes& lanes, int lane) {
  const int v = lanes.v[lane];
  return Lane{v & 0xff, (v >> 8) & 0xff, v >> 16};
}

}  // namespace nautilus

extern "C" {

// The card's limits for kernels/plan.py: shared memory per block (opt-in)
// and per SM, and the SM count.  Returns 0, or a cudaError_t code.
int nautilus_csm_device_limits(int* smem_per_block, int* smem_per_sm,
                               int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        smem_per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return static_cast<int>(err);
}

}  // extern "C"
