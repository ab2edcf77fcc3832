// Fused coarse stage of correlative scan matching (CSM) for Hopper (sm_90a).
//
// Replaces the TPU kernel nautilus_tpu/kernels/csm_pallas.py:_fused_coarse_kernel
// (fused_coarse_pallas).  For every (pair c, rotation r) it rotates the
// pair's parked source points by theta[c, r], bins them into the
// [cells, cells] coarse raster and correlates that raster against the
// pair's coarse log table over noff x noff translation offsets.
//
// What it computes.  The raster is a sum of one-hots, so the correlation is
// a sum over points instead of a dense raster x im2col product:
//
//   score[c, r, oy, ox] = sum_p [0 <= ix_p < cells and 0 <= iy_p < cells]
//                               * table[c, iy_p + oy, ix_p + ox]
//
//   ix_p = floor((cos * x_p - sin * y_p + halfwidth) / res)   (likewise iy_p)
//
// Masked points are parked far outside the raster by the caller and fall out
// through the bounds check.
//
// What bounds it on the H100.  One add per (pair, rotation, in-raster point,
// offset): 3.1e9 at the main path's chunk (C = 64 pairs, R = 315, P = 768
// with ~10% masked, 15 x 15 offsets), 0.093 ms at 33.5e12 float32 adds per
// second (the data sheet's 67 TFLOP/s counts a fused multiply-add as two);
// the bytes (30 MB) take 0.01 ms.  Each add reads one table word, so the
// practical ceiling is shared memory: 128 bytes per clock per SM, 0.37 ms
// for those reads at 1.98 GHz.
//
// What held the first version of this kernel at 1.7 ms on an H100: one
// 256-thread block per SM (the 183 KB table filled shared memory), one
// thread per offset walking every point, masked ones included, with a
// branch and a dependent table read per step, and the table staged by
// synchronous loads 16 times per pair.
//
// Design: keep the shared-memory pipe busy with few instructions per read.
//   - Persistent blocks: blocks_per_pair blocks per pair, each over a run of
//     rotations, with the pair's table staged once in shared memory by bulk
//     copies (TMA) that overlap the first rotations' binning (or row by row
//     onto a padded stride, see below); a table that does not fit beside the
//     cell lists is read from global memory (L2).
//   - 16 warps per block, each taking one rotation at a time from the
//     block's run (a shared counter).  The warp bins the points, 32 at a
//     time, and compacts the in-raster cells into its own list, in point
//     order (ballot and popc): masked and out-of-raster points cost nothing
//     after that.
//   - The warp then walks its list four cells per int4 read (one word for
//     all lanes), with no branch.  Each lane sums up to kSlots
//     neighbouring offsets of one window row (kernels/plan.py:window_lanes),
//     so per point it forms one address and reads kSlots words at constant
//     offsets from it: one instruction per word, and the reads of the four
//     points are independent.  The plan pads the staged table's rows where
//     needed so that the 32 lanes' words of a slot lie in 32 banks.
//   - One warp sums a whole rotation in point order, so each score is the
//     same from run to run, with no atomics.
//
// Numerics.  cos/sin come from the caller (torch), and this file is compiled
// with --fmad=false and without fast math, so c*x - s*y, + halfwidth and
// / res round exactly as separate torch ops do: the kernel bins every point
// into the same cell as the plain PyTorch version.  Scores then differ from
// it only by float summation order.

#include <cuda_runtime.h>

#include <cstdint>

#include "csm_common.cuh"

namespace {

using namespace nautilus;

constexpr int kMaxWarps = 16;

__host__ __device__ constexpr int list_ints(int P) { return (P + 3) & ~3; }

// Shared memory, in this order: the warps' cell lists, the table barrier
// and the rotation counter, the table.
size_t smem_bytes(int T, int stride, int P, int warps, bool table_in_smem) {
  return static_cast<size_t>(warps) * list_ints(P) * sizeof(int) + kAlign
         + (table_in_smem ? table_bytes(T, stride) : 0);
}

// acc[s] += table[cell + s] over the lane's slots; `tl` is the table at the
// lane's window base.  In global memory only the lane's n slots are read.
template <bool kTableInSmem>
__device__ __forceinline__ void add_point(const float* tl, int cell, int n,
                                          float (&acc)[kSlots]) {
  const float* tp = tl + cell;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (kTableInSmem) {
      acc[s] += tp[s];
    } else if (s < n) {
      acc[s] += __ldg(tp + s);
    }
  }
}

template <bool kTableInSmem>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
fused_coarse_kernel(const float* __restrict__ pts,     // [C, P, 2]
                    const float* __restrict__ cos_t,   // [C, R]
                    const float* __restrict__ sin_t,   // [C, R]
                    const float* __restrict__ tables,  // [C, T, T]
                    float* __restrict__ out,           // [C, R, noff, noff]
                    const Lanes lanes, int P, int R, int T, int stride,
                    int cells, int noff, float halfwidth, float res,
                    int blocks_per_pair) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int c = blockIdx.x / blocks_per_pair;
  const int j = blockIdx.x % blocks_per_pair;
  const int r_end = static_cast<int>(
      static_cast<long long>(j + 1) * R / blocks_per_pair);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int list_stride = list_ints(P);
  const int n_off = noff * noff;
  const float* table_g = tables + static_cast<long long>(c) * T * T;
  const float2* pc = reinterpret_cast<const float2*>(pts)
                     + static_cast<long long>(c) * P;

  int* lists = reinterpret_cast<int*>(smem);
  uint64_t* table_bar = reinterpret_cast<uint64_t*>(
      smem + static_cast<size_t>(warps) * list_stride * sizeof(int));
  int* next_rot = reinterpret_cast<int*>(table_bar + 1);

  if (tid == 0) {
    mbar_init(table_bar, 1);
    *next_rot = static_cast<int>(static_cast<long long>(j) * R
                                 / blocks_per_pair);
    fence_barrier_init();
  }
  __syncthreads();
  const float* table = table_g;
  if (kTableInSmem) {
    table = stage_table(table_bar + 2, table_g, T, T, stride, table_bar, tid,
                        blockDim.x);
  }
  __syncthreads();   // plain-copied table words
  bool table_ready = !kTableInSmem;

  const Lane me = lane_of(lanes, lane);
  const float* tl = table + me.row * stride + me.col;
  int* list = lists + warp * list_stride;
  const float fcells = static_cast<float>(cells);
  const unsigned lanes_below = (1u << lane) - 1u;

  for (;;) {
    int r = 0;
    if (lane == 0) r = atomicAdd(next_rot, 1);
    r = __shfl_sync(0xffffffffu, r, 0);
    if (r >= r_end) break;
    const float ct = cos_t[static_cast<long long>(c) * R + r];
    const float st = sin_t[static_cast<long long>(c) * R + r];
    int count = 0;
    for (int base = 0; base < P; base += 32) {
      const int p = base + lane;
      int cell = -1;
      if (p < P) {
        const float2 xy = __ldg(pc + p);
        const float rx = ct * xy.x - st * xy.y;
        const float ry = st * xy.x + ct * xy.y;
        const float fx = floorf((rx + halfwidth) / res);
        const float fy = floorf((ry + halfwidth) / res);
        if (fx >= 0.f && fx < fcells && fy >= 0.f && fy < fcells) {
          cell = static_cast<int>(fy) * stride + static_cast<int>(fx);
        }
      }
      const unsigned m = __ballot_sync(0xffffffffu, cell >= 0);
      if (cell >= 0) list[count + __popc(m & lanes_below)] = cell;
      count += __popc(m);
    }
    __syncwarp();   // the list is written
    if (!table_ready) {
      mbar_wait(table_bar, 0);
      table_ready = true;
    }
    float acc[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) acc[s] = 0.f;
    const int4* list4 = reinterpret_cast<const int4*>(list);
    const int n4 = count >> 2;
    for (int e = 0; e < n4; ++e) {
      const int4 q = list4[e];   // one word for all lanes
      add_point<kTableInSmem>(tl, q.x, me.n, acc);
      add_point<kTableInSmem>(tl, q.y, me.n, acc);
      add_point<kTableInSmem>(tl, q.z, me.n, acc);
      add_point<kTableInSmem>(tl, q.w, me.n, acc);
    }
    for (int e = n4 * 4; e < count; ++e) {
      add_point<kTableInSmem>(tl, list[e], me.n, acc);
    }
    float* o_r = out + (static_cast<long long>(c) * R + r) * n_off
                 + me.row * noff + me.col;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (s < me.n) o_r[s] = acc[s];
    }
    __syncwarp();   // the list is read before the next rotation rewrites it
  }
}

}  // namespace

extern "C" {

// Launches the fused coarse stage on `stream` with the plan of
// kernels/plan.py:coarse_plan; the shared-memory size is this file's
// smem_bytes.  Pointers are device pointers to contiguous float32 arrays,
// except lanes: a host array of 32 packed lanes (Plan.lanes).  Returns a
// cudaError_t code (0 on success).
int nautilus_csm_fused_coarse(const float* pts, const float* cos_t,
                              const float* sin_t, const float* tables,
                              float* out, const int* lanes_host, int C, int P,
                              int R, int T, int stride, int cells, int noff,
                              float halfwidth, float res, int table_in_smem,
                              int warps, int blocks_per_pair, void* stream) {
  if (C <= 0 || R <= 0 || P <= 0 || noff <= 0 || noff > 16 ||
      T != cells + noff - 1 || stride < T || (!table_in_smem && stride != T) ||
      warps <= 0 || warps > kMaxWarps || blocks_per_pair <= 0 ||
      blocks_per_pair > R ||
      static_cast<long long>(C) * blocks_per_pair > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem =
      static_cast<int>(smem_bytes(T, stride, P, warps, table_in_smem != 0));
  Lanes lanes;
  for (int i = 0; i < 32; ++i) lanes.v[i] = lanes_host[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = table_in_smem ? fused_coarse_kernel<true>
                              : fused_coarse_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(C * blocks_per_pair), dim3(warps * 32), smem, s>>>(
      pts, cos_t, sin_t, tables, out, lanes, P, R, T, stride, cells, noff,
      halfwidth, res, blocks_per_pair);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
