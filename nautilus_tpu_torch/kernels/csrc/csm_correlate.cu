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
// What bounds it on the H100: reading the rasters.  They are point counts:
// at most P <= 768 of a raster's kh * kw cells are non-zero (< 2% at the
// reference parameters H = W = 214, kh = kw = 200, R = 315, 15 x 15
// offsets), so the multiply-adds that matter (one per non-zero cell and
// offset, ~1.5e9 flops for a batch of 16 pairs) take ~0.02 ms at 67 TFLOP/s,
// while the 806 MB of rasters take 0.24 ms at 3.35 TB/s.  The table (183 KB)
// is reused by every rotation; its reads, one word per multiply-add, take
// ~0.09 ms at shared memory's 128 bytes per clock per SM, and set the
// ceiling at the denser 12 m and 8.5 m rasters.
//
// What held the first version of this kernel at a fifth of that on an H100:
// one 256-thread block per SM (its table and per-warp lists filled shared
// memory), whose loads and sums alternated between two block barriers per
// 4096-cell tile, and a table staged by synchronous loads once per two
// rotations at small shapes.
//
// Design: keep the raster stream going in every warp, with no barrier.
//   - Persistent blocks: blocks_per_pair blocks per pair, each over a run of
//     rotations, so a block stages its pair's table once.  The table goes to
//     shared memory by bulk copies (TMA) that complete on an mbarrier while
//     the warps issue their first raster loads (or row by row, where the
//     plan pads its rows); a table too large for shared memory is read from
//     global memory (L2) instead.  Beside it shared memory holds only the
//     warps' lists, so every block runs kMaxWarps warps.
//   - Each warp takes one rotation at a time from the block's run (a shared
//     counter) and reads its raster in steps of kChunkBytes: one 16-byte
//     streaming load per lane per kLoads, neighbouring lanes on neighbouring
//     bytes.  Before it sums a step it issues the next step's loads, of this
//     raster or of its next rotation, so 2 KB per warp (32 KB per SM) stay
//     in flight while it computes.  Rasters that do not start 16-byte
//     aligned (kh * kw * 4 is not a multiple of 16, e.g. 57 x 57 at 8.5 m)
//     are read from their first aligned byte; the <16-byte head and tail go
//     through plain loads.
//   - Ballots and popcounts append the step's non-zero cells, in cell order,
//     to the warp's list in shared memory as (window origin, value), every
//     lane computing its own cells' origins.  When the list could overflow,
//     and at the end of the raster, the warp sums it: two int4 reads (one
//     word for all lanes) give four entries, and each lane multiply-adds
//     value * table word into register accumulators for up to kSlots
//     neighbouring offsets of one window row (kernels/plan.py:window_lanes),
//     one address and kSlots constant offsets per entry.  The plan pads the
//     staged table's rows where needed so that the 32 lanes' words of a slot
//     lie in 32 banks.
//   - One warp sums a whole raster in cell order, so each score is the same
//     from run to run whatever warp took it, with no atomics and no
//     cross-warp combination.
// Why registers and not a ring of shared-memory stages filled by 1-D bulk
// copies: without the sums both stream the rasters equally fast on the
// H100 (scripts/raster_stream_probe.py), but beside the table and the
// lists a ring of two 2 KB stages per warp fits only 7 warps.  Summing each
// non-zero cell as the ballot found it (a shuffle, then all lanes), as an
// earlier design did, left one dependent chain per cell.
// Skipping a zero cell is exact when the table is finite (0 * t = 0); the
// wrapper requires finite tables, which CSM's log(occupancy + 1e-6) always is.
//
// Numerics: one fused multiply-add per term.  Raster counts times the
// bf16-rounded table are exact products, so this rounds as a multiply and an
// add would; scores differ from the plain im2col product only by summation
// order, and agree bit for bit when every partial sum is an exact float
// (integer tables and counts).

#include <cuda_runtime.h>

#include <cstdint>

#include "csm_common.cuh"

namespace {

using namespace nautilus;

constexpr int kChunkBytes = 2048;   // raster bytes a warp loads per step
constexpr int kLoads = kChunkBytes / (32 * 16);   // float4 per lane per step
constexpr int kMaxWarps = 16;
// Entries of a warp's list of non-zero cells (window origin, value); it is
// summed before a step's 128-cell slice could overflow it.
constexpr int kListCap = 256;

// Shared memory: the table barrier and the rotation counter, the warps'
// lists, the table.
size_t smem_bytes(int H, int stride, bool table_in_smem) {
  return kAlign + static_cast<size_t>(kMaxWarps) * kListCap * sizeof(int2)
         + (table_in_smem ? table_bytes(H, stride) : 0);
}

// The 16-byte-aligned interior [a0, a1) of the raster at `src` (K floats),
// read in `chunks` steps of kChunkBytes, as kernels/plan.py:raster_pieces
// computes it; `head` and `tail` cells lie outside it.
struct Pieces {
  uintptr_t a0, a1;
  int head, tail, chunks;
};

__device__ __forceinline__ Pieces pieces(const float* src, int K) {
  Pieces p;
  const uintptr_t s0 = reinterpret_cast<uintptr_t>(src);
  const uintptr_t s1 = s0 + static_cast<uintptr_t>(K) * sizeof(float);
  p.a0 = align_up(s0) < s1 ? align_up(s0) : s1;
  p.a1 = align_down(s1) > p.a0 ? align_down(s1) : p.a0;
  p.head = static_cast<int>((p.a0 - s0) / sizeof(float));
  p.tail = static_cast<int>((s1 - p.a1) / sizeof(float));
  const int n = static_cast<int>((p.a1 - p.a0 + kChunkBytes - 1) / kChunkBytes);
  p.chunks = n > 0 ? n : 1;
  return p;
}

// Step `chunk` of a raster's interior: one float4 per lane per load, lanes
// on neighbouring 16 bytes; zeros past the interior.  Streaming loads: each
// raster byte is read once.
__device__ __forceinline__ void load_chunk(float4 (&v)[kLoads],
                                           const Pieces& p, int chunk,
                                           int lane) {
  const float4* base = reinterpret_cast<const float4*>(p.a0)
                       + static_cast<size_t>(chunk) * (kChunkBytes / 16);
  const long long left = static_cast<long long>(p.a1 - p.a0) / 16
                         - static_cast<long long>(chunk) * (kChunkBytes / 16);
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int q = k * 32 + lane;
    v[k] = q < left ? __ldcs(base + q) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// ky * stride + kx for raster cell ky * kw + kx (skip = stride - kw): a
// float quotient, corrected.
__device__ __forceinline__ int window_origin(int cell, int kw, int skip,
                                             float inv_kw) {
  int ky = static_cast<int>(static_cast<float>(cell) * inv_kw);
  const int kx = cell - ky * kw;
  if (kx < 0) {
    --ky;
  } else if (kx >= kw) {
    ++ky;
  }
  return cell + ky * skip;
}

// acc[s] += v * table[origin + s] for one list entry (origin, v bits);
// `tl` is the table at the lane's window base.  In global memory only the
// lane's n slots are read.
template <bool kTableInSmem>
__device__ __forceinline__ void add_entry(int origin, int vbits,
                                          const float* tl, int n,
                                          float (&acc)[kSlots]) {
  const float v = __int_as_float(vbits);
  const float* tp = tl + origin;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (kTableInSmem) {
      acc[s] = __fmaf_rn(v, tp[s], acc[s]);
    } else if (s < n) {
      acc[s] = __fmaf_rn(v, __ldg(tp + s), acc[s]);
    }
  }
}

// Sums the warp's list in order, four entries (two int4 words read by
// every lane) per step, and empties it.
template <bool kTableInSmem>
__device__ __forceinline__ void drain(const int2* list, int& count,
                                      const float* tl, int n,
                                      float (&acc)[kSlots]) {
  __syncwarp();   // the list is written
  const int4* list4 = reinterpret_cast<const int4*>(list);
  int e = 0;
  for (; e + 4 <= count; e += 4) {
    const int4 a = list4[e / 2];
    const int4 b = list4[e / 2 + 1];
    add_entry<kTableInSmem>(a.x, a.y, tl, n, acc);
    add_entry<kTableInSmem>(a.z, a.w, tl, n, acc);
    add_entry<kTableInSmem>(b.x, b.y, tl, n, acc);
    add_entry<kTableInSmem>(b.z, b.w, tl, n, acc);
  }
  for (; e < count; ++e) {
    const int2 a = list[e];
    add_entry<kTableInSmem>(a.x, a.y, tl, n, acc);
  }
  count = 0;
  __syncwarp();   // the list is read before it is rewritten
}

// Appends the non-zero cells among `n` single cells [i0, i0 + n) read with
// plain loads (a raster's unaligned head or tail), in cell order.
__device__ __forceinline__ void append_cells(const float* src, int i0, int n,
                                             int kw, int skip, float inv_kw,
                                             int2* list, int& count,
                                             int lane) {
  const float v = lane < n ? __ldg(src + i0 + lane) : 0.f;
  const unsigned m = __ballot_sync(0xffffffffu, v != 0.f);
  if (v != 0.f) {
    list[count + __popc(m & ((1u << lane) - 1u))] = make_int2(
        window_origin(i0 + lane, kw, skip, inv_kw), __float_as_int(v));
  }
  count += __popc(m);
}

template <bool kTableInSmem>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
correlate_kernel(const float* __restrict__ tables,    // [B, H, W]
                 const float* __restrict__ rasters,   // [B, R, kh, kw]
                 float* __restrict__ out,             // [B, R, oh, ow]
                 const Lanes lanes, int H, int W, int stride, int R, int kh,
                 int kw, int blocks_per_pair) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x / blocks_per_pair;
  const int j = blockIdx.x % blocks_per_pair;
  const int r_end = static_cast<int>(
      static_cast<long long>(j + 1) * R / blocks_per_pair);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int K = kh * kw;
  const int ow = W - kw + 1;
  const int n_off = (H - kh + 1) * ow;
  const float* table_g = tables + static_cast<long long>(b) * H * W;
  const float* raster_b = rasters + static_cast<long long>(b) * R * K;
  float* out_b = out + static_cast<long long>(b) * R * n_off;

  uint64_t* table_bar = reinterpret_cast<uint64_t*>(smem);
  int* next_rot = reinterpret_cast<int*>(table_bar + 1);
  int2* list = reinterpret_cast<int2*>(smem + kAlign) + warp * kListCap;

  if (tid == 0) {
    mbar_init(table_bar, 1);
    *next_rot = static_cast<int>(static_cast<long long>(j) * R
                                 / blocks_per_pair);
    fence_barrier_init();
  }
  __syncthreads();
  const float* table = table_g;
  if (kTableInSmem) {
    table = stage_table(
        smem + kAlign
            + static_cast<size_t>(kMaxWarps) * kListCap * sizeof(int2),
        table_g, H, W, stride, table_bar, tid, blockDim.x);
  }
  __syncthreads();   // plain-copied table words

  const Lane me = lane_of(lanes, lane);
  const float* tl = table + me.row * stride + me.col;
  const int skip = stride - kw;
  const float inv_kw = 1.0f / static_cast<float>(kw);
  const unsigned lanes_below = (1u << lane) - 1u;

  auto take = [&]() {
    int r = 0;
    if (lane == 0) r = atomicAdd(next_rot, 1);
    return __shfl_sync(0xffffffffu, r, 0);
  };
  // The warp's current step: chunk `chunk` of rotation r's raster.
  int r = take();
  if (r >= r_end) return;
  const float* src = raster_b + static_cast<long long>(r) * K;
  Pieces p = pieces(src, K);
  int chunk = 0;
  float4 cur[kLoads];
  load_chunk(cur, p, 0, lane);
  if (kTableInSmem) mbar_wait(table_bar, 0);

  float acc[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) acc[s] = 0.f;
  int count = 0;   // entries in the warp's list, the same in every lane
  append_cells(src, 0, p.head, kw, skip, inv_kw, list, count, lane);

  for (;;) {
    // Issue the next step's loads before this step's sums: of this raster,
    // or of the warp's next rotation.
    int r_next = r, chunk_next = chunk + 1;
    const float* src_next = src;
    Pieces p_next = p;
    if (chunk_next == p.chunks) {
      r_next = take();
      chunk_next = 0;
      if (r_next < r_end) {
        src_next = raster_b + static_cast<long long>(r_next) * K;
        p_next = pieces(src_next, K);
      }
    }
    float4 nxt[kLoads];
    if (r_next < r_end) load_chunk(nxt, p_next, chunk_next, lane);

    // This step's non-zero cells go to the list in cell order: lane l's
    // k-th float4 holds cells cell0 + 4 * (32 k + l) .. + 3.
    const int cell0 = p.head + chunk * (kChunkBytes / 4);
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const float4 v = cur[k];
      const unsigned mx = __ballot_sync(0xffffffffu, v.x != 0.f);
      const unsigned my = __ballot_sync(0xffffffffu, v.y != 0.f);
      const unsigned mz = __ballot_sync(0xffffffffu, v.z != 0.f);
      const unsigned mw = __ballot_sync(0xffffffffu, v.w != 0.f);
      const int total = __popc(mx) + __popc(my) + __popc(mz) + __popc(mw);
      if (total == 0) continue;
      int pos = count + __popc(mx & lanes_below) + __popc(my & lanes_below)
                + __popc(mz & lanes_below) + __popc(mw & lanes_below);
      const int cell = cell0 + 4 * (k * 32 + lane);
      if (v.x != 0.f) {
        list[pos++] = make_int2(window_origin(cell, kw, skip, inv_kw),
                                __float_as_int(v.x));
      }
      if (v.y != 0.f) {
        list[pos++] = make_int2(window_origin(cell + 1, kw, skip, inv_kw),
                                __float_as_int(v.y));
      }
      if (v.z != 0.f) {
        list[pos++] = make_int2(window_origin(cell + 2, kw, skip, inv_kw),
                                __float_as_int(v.z));
      }
      if (v.w != 0.f) {
        list[pos] = make_int2(window_origin(cell + 3, kw, skip, inv_kw),
                              __float_as_int(v.w));
      }
      count += total;
      if (count > kListCap - 128) {
        drain<kTableInSmem>(list, count, tl, me.n, acc);
      }
    }
    if (chunk_next == 0) {   // rotation r's interior is read
      append_cells(src, K - p.tail, p.tail, kw, skip, inv_kw, list, count,
                   lane);
      drain<kTableInSmem>(list, count, tl, me.n, acc);
      float* o_r = out_b + static_cast<long long>(r) * n_off + me.row * ow
                   + me.col;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (s < me.n) o_r[s] = acc[s];
        acc[s] = 0.f;
      }
      if (r_next >= r_end) break;
      append_cells(src_next, 0, p_next.head, kw, skip, inv_kw, list, count,
                   lane);
    }
    r = r_next;
    chunk = chunk_next;
    src = src_next;
    p = p_next;
#pragma unroll
    for (int k = 0; k < kLoads; ++k) cur[k] = nxt[k];
  }
}

}  // namespace

extern "C" {

// Launches the correlation on `stream` with the plan of kernels/plan.py:
// correlate_plan; the shared-memory size is this file's smem_bytes.
// Pointers are device pointers to contiguous float32 arrays, except lanes:
// a host array of 32 packed lanes (Plan.lanes).  Returns a cudaError_t
// code (0 on success).
int nautilus_csm_correlate(const float* tables, const float* rasters,
                           float* out, const int* lanes_host, int B, int H,
                           int W, int stride, int R, int kh, int kw,
                           int table_in_smem, int warps, int blocks_per_pair,
                           void* stream) {
  if (B <= 0 || R <= 0 || kh <= 0 || kw <= 0 || kh > H || kw > W ||
      H - kh + 1 > 16 || W - kw + 1 > 16 || stride < W ||
      (!table_in_smem && stride != W) || warps <= 0 || warps > kMaxWarps ||
      blocks_per_pair <= 0 || blocks_per_pair > R ||
      static_cast<long long>(B) * blocks_per_pair > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = static_cast<int>(smem_bytes(H, stride, table_in_smem != 0));
  Lanes lanes;
  for (int i = 0; i < 32; ++i) lanes.v[i] = lanes_host[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * blocks_per_pair);
  const dim3 block(warps * 32);
  auto kernel = table_in_smem ? correlate_kernel<true> : correlate_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, block, smem, s>>>(tables, rasters, out, lanes, H, W, stride,
                                   R, kh, kw, blocks_per_pair);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
