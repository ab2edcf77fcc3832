// Coarse 2-D correlation of correlative scan matching (CSM) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel nautilus_tpu/kernels/csm_pallas.py:_corr_kernel
// (correlate_pallas), the coarse stage of the pair-major CSM engine.  For a
// batch of pairs b, rotations r and translation offsets (oy, ox) it computes
// the VALID cross-correlation of the pair's [H, W] log table with each of its
// R rotated-scan rasters [kh, kw]:
//
//   out[b, r, oy, ox] = sum_{ky, kx} kernels[b, r, ky, kx]
//                                    * tables[b, oy + ky, ox + kx]
//
// What bounds it on the H100.  The dense form is 315 * 225 * 40,000 = 2.8e9
// multiply-adds per pair at the reference parameters (H = W = 214,
// kh = kw = 200, R = 315, 15 x 15 offsets).  But the rasters are point counts:
// at most P <= 768 of their 40,000 cells are non-zero (< 2%).  So the work
// that matters is reading the rasters, 50 MB of float32 per pair (~15 us at
// 3.35 TB/s), while the table (183 KB) is reused by every rotation.
//
// Design.
//   - One block per (pair, run of rotations).  The pair's table is staged in
//     dynamic shared memory once per block; a table that does not fit beside
//     the lists below is read from global memory (L2) instead.
//   - Per rotation the block streams the raster in tiles of 4096 cells.  Each
//     thread issues its 16 coalesced loads of a tile at once, which keeps
//     memory busy with a single 256-thread block per SM.  Each warp compacts
//     the non-zero cells it loaded, in a fixed order, into its own list in
//     shared memory (ballot and popc, no atomics: the summation order is the
//     same from run to run).
//   - One thread per offset (oh * ow <= 256) then sums value * table word over
//     the lists.  All threads read the same list entry (a broadcast), and
//     neighbouring threads read neighbouring table words.  The lists are
//     drained when one of them could overflow on the next tile, and at the end
//     of the raster.
// Skipping a zero cell is exact when the table is finite (0 * t = 0); the
// wrapper requires finite tables, which CSM's log(occupancy + 1e-6) always is.
//
// Numerics.  Compiled with --fmad=false: each product is rounded before it is
// added.  Scores differ from the plain im2col product only by summation order,
// and agree bit for bit when every partial sum is an exact float (integer
// tables and counts).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 16;                  // loads in flight per thread
constexpr int kTile = kThreads * kLoads;    // raster cells per tile
constexpr int kWarpTile = 32 * kLoads;      // cells one warp compacts per tile
constexpr int kWarpCap = 640;               // list entries per warp

constexpr size_t kListBytes =
    static_cast<size_t>(kWarps) * kWarpCap * (sizeof(int) + sizeof(float))
    + kWarps * sizeof(int);

template <bool kTableInSmem>
__global__ void __launch_bounds__(kThreads)
correlate_kernel(const float* __restrict__ tables,    // [B, H, W]
                 const float* __restrict__ kernels,   // [B, R, kh, kw]
                 float* __restrict__ out,             // [B, R, oh, ow]
                 int H, int W, int R, int kh, int kw, int rot_per_block) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int r0 = blockIdx.y * rot_per_block;
  const int r1 = min(r0 + rot_per_block, R);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long hw = static_cast<long long>(H) * W;
  const int K = kh * kw;
  const int ow = W - kw + 1;
  const int n_off = (H - kh + 1) * ow;

  const float* table_g = tables + static_cast<long long>(b) * hw;
  float* table_s = smem;                                       // [H*W] if staged
  int* list_off = reinterpret_cast<int*>(smem + (kTableInSmem ? hw : 0));
  float* list_val = reinterpret_cast<float*>(list_off + kWarps * kWarpCap);
  int* counts = reinterpret_cast<int*>(list_val + kWarps * kWarpCap);
  int* my_off = list_off + warp * kWarpCap;
  float* my_val = list_val + warp * kWarpCap;

  if (kTableInSmem) {
    // Complete before the first drain: every tile ends in __syncthreads.
    for (long long i = tid; i < hw; i += kThreads) table_s[i] = table_g[i];
  }
  const float* table = kTableInSmem ? table_s : table_g;

  const bool active = tid < n_off;
  const int o_base = active ? (tid / ow) * W + tid % ow : 0;
  const unsigned lanes_below = (1u << lane) - 1u;

  for (int r = r0; r < r1; ++r) {
    const float* kr = kernels + (static_cast<long long>(b) * R + r) * K;
    float acc = 0.f;
    int count = 0;   // this warp's list length, the same in all its lanes
    for (int base = 0; base < K; base += kTile) {
      float v[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int idx = base + k * kThreads + tid;
        v[k] = idx < K ? kr[idx] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const bool nz = v[k] != 0.f;
        const unsigned m = __ballot_sync(0xffffffffu, nz);
        if (nz) {
          const int idx = base + k * kThreads + tid;
          const int ky = idx / kw;
          const int pos = count + __popc(m & lanes_below);
          my_off[pos] = ky * W + (idx - ky * kw);
          my_val[pos] = v[k];
        }
        count += __popc(m);
      }
      if (lane == 0) counts[warp] = count;
      __syncthreads();   // lists, counts (and the staged table) are written
      int longest = 0;
      for (int w = 0; w < kWarps; ++w) longest = max(longest, counts[w]);
      // Block-uniform: every thread read the same counts.
      if (base + kTile >= K || longest > kWarpCap - kWarpTile) {
        if (active) {
          for (int w = 0; w < kWarps; ++w) {
            const int n = counts[w];
            const int* lo = list_off + w * kWarpCap;
            const float* lv = list_val + w * kWarpCap;
            for (int e = 0; e < n; ++e) acc += lv[e] * table[lo[e] + o_base];
          }
        }
        count = 0;
      }
      __syncthreads();   // counts and lists are read before they are rewritten
    }
    if (active) out[(static_cast<long long>(b) * R + r) * n_off + tid] = acc;
  }
}

int smem_limit() {
  int dev = 0;
  int bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return -1;
  }
  return bytes;
}

}  // namespace

extern "C" {

// 1 if an [H, W] table is staged in shared memory, 0 if it is read from
// global memory, -1 on a CUDA error.
int nautilus_csm_correlate_table_in_smem(int H, int W) {
  const int limit = smem_limit();
  if (limit < 0) return -1;
  const size_t table_bytes = static_cast<size_t>(H) * W * sizeof(float);
  return table_bytes + kListBytes <= static_cast<size_t>(limit) ? 1 : 0;
}

// Launches the correlation on `stream`.  All pointers are device pointers to
// contiguous float32 arrays.  Returns a cudaError_t code (0 on success).
int nautilus_csm_correlate(const float* tables, const float* kernels,
                           float* out, int B, int H, int W, int R, int kh,
                           int kw, int rot_per_block, void* stream) {
  if (B <= 0 || R <= 0 || kh <= 0 || kw <= 0 || kh > H || kw > W ||
      rot_per_block <= 0 ||
      static_cast<long long>(H - kh + 1) * (W - kw + 1) > kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rot_blocks = (R + rot_per_block - 1) / rot_per_block;
  if (rot_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int in_smem = nautilus_csm_correlate_table_in_smem(H, W);
  if (in_smem < 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(B, rot_blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_smem) {
    const int bytes = static_cast<int>(
        static_cast<size_t>(H) * W * sizeof(float) + kListBytes);
    err = cudaFuncSetAttribute(correlate_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    correlate_kernel<true><<<grid, kThreads, bytes, s>>>(
        tables, kernels, out, H, W, R, kh, kw, rot_per_block);
  } else {
    const int bytes = static_cast<int>(kListBytes);
    err = cudaFuncSetAttribute(correlate_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    correlate_kernel<false><<<grid, kThreads, bytes, s>>>(
        tables, kernels, out, H, W, R, kh, kw, rot_per_block);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
