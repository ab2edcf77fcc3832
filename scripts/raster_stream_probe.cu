// Streams the correlation kernel's rasters (csm_correlate.cu's input) through
// its warps two ways, without the correlation's sums, to compare how fast
// each way reads them from HBM on Hopper (sm_90a).  Built and timed by
// scripts/raster_stream_probe.py; the port does not use it.
//
// Both ways give each warp whole rasters, as csm_correlate.cu does (block
// j of a pair owns a run of rotations, warp w takes rotations r0 + w,
// r0 + w + warps, ...), walk a raster in steps of kStep bytes, take every
// 16 bytes' four cells through __ballot_sync as the kernel's compaction
// does, and write the raster's count of non-zero cells, which the script
// checks against torch.
//   - registers: each lane loads its 16-byte pieces of the next step
//     (__ldcs, streaming) before it ballots the current one, as
//     csm_correlate.cu does: one step in flight per warp.
//   - ring: kStages shared-memory stages per warp, each filled by one 1-D
//     bulk copy (cp.async.bulk, TMA) that completes on the stage's mbarrier;
//     lane 0 refills a stage as soon as the warp has read it, so kStages
//     steps are in flight per warp.
// Bulk copies need 16-byte-aligned addresses and sizes, so the rasters'
// bytes must be a multiple of 16.

#include <cuda_runtime.h>

#include <cstdint>

#include "../nautilus_tpu_torch/kernels/csrc/csm_common.cuh"

namespace {

using namespace nautilus;

constexpr int kStep = 2048;                  // csm_correlate.cu's kChunkBytes
constexpr int kLoads = kStep / (32 * 16);    // float4 per lane per step
constexpr int kMaxWarps = 16;
constexpr long long kMaxTries = 1LL << 22;   // then a wait reports a fault

// A warp's steps, in order: its rotations' rasters, each in `chunks` steps.
struct Walk {
  const char* rasters;   // the pair's rasters
  int r_first, r_step, bytes, chunks;

  __device__ int rotation(int s) const { return r_first + s / chunks * r_step; }
  __device__ const char* src(int s) const {
    return rasters + static_cast<long long>(rotation(s)) * bytes
           + static_cast<long long>(s % chunks) * kStep;
  }
  __device__ int size(int s) const {
    const int left = bytes - s % chunks * kStep;
    return left < kStep ? left : kStep;
  }
};

// (Walk, steps) of this warp, or steps = 0.
__device__ __forceinline__ int warp_walk(const float* rasters, int R,
                                         int bytes, int blocks_per_pair,
                                         Walk& w) {
  const int b = blockIdx.x / blocks_per_pair;
  const int j = blockIdx.x % blocks_per_pair;
  const int r0 = static_cast<int>(static_cast<long long>(j) * R
                                  / blocks_per_pair);
  const int r1 = static_cast<int>(static_cast<long long>(j + 1) * R
                                  / blocks_per_pair);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  w.rasters = reinterpret_cast<const char*>(rasters)
              + static_cast<long long>(b) * R * bytes;
  w.r_first = r0 + warp;
  w.r_step = warps;
  w.bytes = bytes;
  w.chunks = (bytes + kStep - 1) / kStep;
  const int n_rot = w.r_first < r1 ? (r1 - w.r_first + warps - 1) / warps : 0;
  return n_rot * w.chunks;
}

// Non-zero cells among the warp's 16-byte pieces v, by ballots.
__device__ __forceinline__ int ballot_count(const float4& v) {
  return __popc(__ballot_sync(0xffffffffu, v.x != 0.f))
         + __popc(__ballot_sync(0xffffffffu, v.y != 0.f))
         + __popc(__ballot_sync(0xffffffffu, v.z != 0.f))
         + __popc(__ballot_sync(0xffffffffu, v.w != 0.f));
}

__device__ __forceinline__ void load_step(float4 (&v)[kLoads], const Walk& w,
                                          int s, int lane) {
  const float4* p = reinterpret_cast<const float4*>(w.src(s));
  const int n = w.size(s) / 16;
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int q = k * 32 + lane;
    v[k] = q < n ? __ldcs(p + q) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32, 1)
stream_registers(const float* __restrict__ rasters, int* __restrict__ counts,
                 int R, int bytes, int blocks_per_pair) {
  const int lane = threadIdx.x & 31;
  Walk w;
  const int n = warp_walk(rasters, R, bytes, blocks_per_pair, w);
  if (n == 0) return;
  int* counts_b = counts + static_cast<long long>(blockIdx.x / blocks_per_pair) * R;
  float4 cur[kLoads];
  load_step(cur, w, 0, lane);
  int count = 0;
  for (int s = 0; s < n; ++s) {
    float4 nxt[kLoads];
    if (s + 1 < n) load_step(nxt, w, s + 1, lane);
#pragma unroll
    for (int k = 0; k < kLoads; ++k) count += ballot_count(cur[k]);
    if (s % w.chunks == w.chunks - 1) {
      if (lane == 0) counts_b[w.rotation(s)] = count;
      count = 0;
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) cur[k] = nxt[k];
  }
}

// Every lane waits for `bar`'s phase `parity`; false in every lane if a
// lane gave up after kMaxTries.
__device__ __forceinline__ bool wait_all(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  for (long long i = 0; i < kMaxTries && !done; ++i) {
    asm volatile(
        "{\n\t"
        ".reg .pred P1;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, P1;\n\t"
        "}" : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
  return __all_sync(0xffffffffu, done != 0);
}

// Shared memory: `reserve` bytes left unused (to run at another kernel's
// occupancy), then each warp's kStages stages, then their barriers.
template <int kStages>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
stream_ring(const float* __restrict__ rasters, int* __restrict__ counts,
            int* __restrict__ fault, int R, int bytes, int blocks_per_pair,
            int reserve) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  unsigned char* stages = smem + reserve + warp * kStages * kStep;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
                       smem + reserve + warps * kStages * kStep)
                   + warp * kStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < warps * kStages; ++i) {
      mbar_init(reinterpret_cast<uint64_t*>(
                    smem + reserve + warps * kStages * kStep) + i, 1);
    }
    fence_barrier_init();
  }
  __syncthreads();
  Walk w;
  const int n = warp_walk(rasters, R, bytes, blocks_per_pair, w);
  if (n == 0) return;
  int* counts_b = counts + static_cast<long long>(blockIdx.x / blocks_per_pair) * R;
  auto issue = [&](int s) {
    const int st = s % kStages;
    mbar_expect_tx(bars + st, w.size(s));
    bulk_copy(stages + st * kStep, w.src(s), w.size(s), bars + st);
  };
  if (lane == 0) {
    for (int s = 0; s < kStages && s < n; ++s) issue(s);
  }
  int count = 0;
  for (int s = 0; s < n; ++s) {
    const int st = s % kStages;
    if (!wait_all(bars + st, (s / kStages) & 1)) {
      if (lane == 0) atomicExch(fault, 1);
      return;
    }
    const float4* p = reinterpret_cast<const float4*>(stages + st * kStep);
    const int nv = w.size(s) / 16;
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int q = k * 32 + lane;
      count += ballot_count(q < nv ? p[q] : make_float4(0.f, 0.f, 0.f, 0.f));
    }
    if (s % w.chunks == w.chunks - 1) {
      if (lane == 0) counts_b[w.rotation(s)] = count;
      count = 0;
    }
    __syncwarp();   // the stage is read before it is refilled
    if (lane == 0 && s + kStages < n) {
      fence_proxy_async();
      issue(s + kStages);
    }
  }
}

}  // namespace

extern "C" {

// Streams rasters [B, R, bytes / 4] (device float32) and writes counts
// [B, R] (device int32): stages = 0 for the register way, 2 or 4 for the
// ring.  `reserve` bytes of shared memory per block are left unused.  The
// blocks per SM (the card's occupancy for this launch) and the blocks per
// pair go to *per_sm and *per_pair.  Returns a cudaError_t code.
int raster_stream(const float* rasters, int* counts, int* fault, int B, int R,
                  int bytes, int stages, int warps, int reserve, int* per_sm,
                  int* per_pair, void* stream) {
  if (B <= 0 || R <= 0 || bytes <= 0 || bytes % 16 != 0 || warps <= 0 ||
      warps > kMaxWarps || reserve < 0 || reserve % 128 != 0 ||
      (stages != 0 && stages != 2 && stages != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* kernel = stages == 0 ? reinterpret_cast<const void*>(stream_registers)
                       : stages == 2 ? reinterpret_cast<const void*>(stream_ring<2>)
                                     : reinterpret_cast<const void*>(stream_ring<4>);
  const int smem = reserve
                   + (stages ? warps * stages * (kStep + 8) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        warps * 32, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (*per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int bpp = sms * *per_sm / B;
  *per_pair = bpp < 1 ? 1 : (bpp > R ? R : bpp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * *per_pair), block(warps * 32);
  if (stages == 0) {
    stream_registers<<<grid, block, smem, s>>>(rasters, counts, R, bytes,
                                               *per_pair);
  } else if (stages == 2) {
    stream_ring<2><<<grid, block, smem, s>>>(rasters, counts, fault, R, bytes,
                                             *per_pair, reserve);
  } else {
    stream_ring<4><<<grid, block, smem, s>>>(rasters, counts, fault, R, bytes,
                                             *per_pair, reserve);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
