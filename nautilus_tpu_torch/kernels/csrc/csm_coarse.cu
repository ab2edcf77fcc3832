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
// through the explicit bounds check (an unchecked gather would read out of
// the table).  At the benchmark shapes (cells 200, noff 15, T 214, P 768,
// R 315, ~540 pairs) this is ~2.8e10 table reads against ~1.5e15
// multiply-adds for the dense form.
//
// What bounds it on the H100.  Table reads: every (pair, rotation, point,
// offset) reads one float.  The design keeps them in shared memory:
//   - one block per (pair, run of rotations); the pair's whole table
//     (T*T*4 bytes, 183 KB at T=214) is staged in dynamic shared memory once
//     and reused for every rotation of the run; tables too large for shared
//     memory are read from global memory (L2) instead;
//   - per rotation, the block computes each point's flattened cell index
//     once into shared memory (-1 outside the raster);
//   - one thread per offset (noff*noff <= 256) sums over the points in point
//     order.  All threads visit the same point at the same time, so the
//     bounds branch is uniform across a warp and neighbouring threads read
//     neighbouring table words.
//
// Numerics.  cos/sin come from the caller (torch), and this file is compiled
// with --fmad=false and without fast math, so c*x - s*y, + halfwidth and
// / res round exactly as separate torch ops do: the kernel bins every point
// into the same cell as the plain PyTorch version.  Scores then differ from
// it only by float summation order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kTableInSmem>
__global__ void __launch_bounds__(kThreads)
fused_coarse_kernel(const float* __restrict__ pts,     // [C, P, 2]
                    const float* __restrict__ cos_t,   // [C, R]
                    const float* __restrict__ sin_t,   // [C, R]
                    const float* __restrict__ tables,  // [C, T, T]
                    float* __restrict__ out,           // [C, R, noff, noff]
                    int P, int R, int T, int cells, int noff,
                    float halfwidth, float res, int rot_per_block) {
  extern __shared__ float smem[];
  const int c = blockIdx.x;
  const int r0 = blockIdx.y * rot_per_block;
  const int r1 = min(r0 + rot_per_block, R);
  const int tid = threadIdx.x;
  const long long tt = static_cast<long long>(T) * T;

  const float* table_g = tables + static_cast<long long>(c) * tt;
  float* table_s = smem;                               // [T*T] if staged
  float* px = smem + (kTableInSmem ? tt : 0);          // [P]
  float* py = px + P;                                  // [P]
  int* cell = reinterpret_cast<int*>(py + P);          // [P]

  const float* pc = pts + static_cast<long long>(c) * P * 2;
  for (int p = tid; p < P; p += blockDim.x) {
    px[p] = pc[2 * p];
    py[p] = pc[2 * p + 1];
  }
  if (kTableInSmem) {
    for (long long i = tid; i < tt; i += blockDim.x) table_s[i] = table_g[i];
  }
  const float* table = kTableInSmem ? table_s : table_g;

  const int n_off = noff * noff;
  const bool active = tid < n_off;
  const int o_base = (tid / noff) * T + (tid % noff);
  const float fcells = static_cast<float>(cells);

  for (int r = r0; r < r1; ++r) {
    // Staging (first rotation) or the previous rotation's reads of cell[]
    // are complete before cell[] is rewritten.
    __syncthreads();
    const float ct = cos_t[static_cast<long long>(c) * R + r];
    const float st = sin_t[static_cast<long long>(c) * R + r];
    for (int p = tid; p < P; p += blockDim.x) {
      const float x = px[p];
      const float y = py[p];
      const float rx = ct * x - st * y;
      const float ry = st * x + ct * y;
      const float fx = floorf((rx + halfwidth) / res);
      const float fy = floorf((ry + halfwidth) / res);
      const bool inside = fx >= 0.f && fx < fcells && fy >= 0.f && fy < fcells;
      cell[p] = inside ? static_cast<int>(fy) * T + static_cast<int>(fx) : -1;
    }
    __syncthreads();
    if (active) {
      float acc = 0.f;
      for (int p = 0; p < P; ++p) {
        const int idx = cell[p];
        if (idx >= 0) acc += table[idx + o_base];
      }
      out[(static_cast<long long>(c) * R + r) * n_off + tid] = acc;
    }
  }
}

}  // namespace

extern "C" {

// Largest T*T + 3*P floats that fit one block's shared memory on the
// current device, in bytes.
int nautilus_csm_smem_limit() {
  int dev = 0;
  int bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return -1;
  }
  return bytes;
}

// Launches the fused coarse stage on `stream`.  All pointers are device
// pointers to contiguous float32 arrays.  Returns a cudaError_t code
// (0 on success).
int nautilus_csm_fused_coarse(const float* pts, const float* cos_t,
                              const float* sin_t, const float* tables,
                              float* out, int C, int P, int R, int T,
                              int cells, int noff, float halfwidth, float res,
                              int rot_per_block, void* stream) {
  if (C <= 0 || R <= 0 || P <= 0 || noff <= 0 || noff * noff > kThreads ||
      T != cells + noff - 1 || rot_per_block <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rot_blocks = (R + rot_per_block - 1) / rot_per_block;
  if (rot_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t point_bytes = static_cast<size_t>(P) * 3 * sizeof(float);
  const size_t table_bytes = static_cast<size_t>(T) * T * sizeof(float);
  const int limit = nautilus_csm_smem_limit();
  if (limit < 0) return static_cast<int>(cudaGetLastError());
  if (point_bytes > static_cast<size_t>(limit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(C, rot_blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (table_bytes + point_bytes <= static_cast<size_t>(limit)) {
    const int bytes = static_cast<int>(table_bytes + point_bytes);
    err = cudaFuncSetAttribute(fused_coarse_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_coarse_kernel<true><<<grid, kThreads, bytes, s>>>(
        pts, cos_t, sin_t, tables, out, P, R, T, cells, noff, halfwidth, res,
        rot_per_block);
  } else {
    const int bytes = static_cast<int>(point_bytes);
    err = cudaFuncSetAttribute(fused_coarse_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_coarse_kernel<false><<<grid, kThreads, bytes, s>>>(
        pts, cos_t, sin_t, tables, out, P, R, T, cells, noff, halfwidth, res,
        rot_per_block);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
