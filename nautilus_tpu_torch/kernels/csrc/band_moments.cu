// Correspondence moments of the band assembly for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package writes this computation in plain
// jnp (nautilus_tpu/solve/factors.py: _moments_normal, _moments_point and
// _accumulate_banded's slice adds), and XLA fuses it into a few programs.
// The port ran the same code eagerly: 414 kernel launches per band
// assembly on an H100, once per LM step and once per window, 0.7 ms of
// device work behind 4-8 ms of host dispatch.  The LM step was bound by
// that dispatch, not by the card.  This file does the whole assembly of the
// correspondence factors in two launches.
//
// What it computes: solve/factors.py:_accumulate_banded_reference with
// analytic="moments".  For every pose pair q of the planar batch (normal
// residuals, two rows per point) and of the edge batch (point residuals)
// the 6x6 block J^T J and the 6-vector J^T r reduce to per-point scalar
// sums; those blocks then add into the block band by the delta-major pair
// layout (solve/correspond.py:make_pairs): pairs of delta d occupy rows
// offs(d) + (i - d), i = d..n-1, source node i and target node i - d.
//
//   pair_moments    one warp per pair, lanes over the pair's slots (any
//                   slot count), then a fixed shuffle-down tree over the
//                   lanes, in torch.sum's order below 64 slots.
//                   Writes the pair's source, target and off-diagonal 3x3
//                   blocks, its gradient and its cost term: 34 values,
//                   stored value-major ([34, Qp + Qe]) so that the second
//                   pass reads them coalesced.
//   band_assemble   one thread per (node, output entry): diag [n, 3, 3],
//                   band [w, n, 3, 3], gd [n, 3].  Each thread adds its
//                   pairs' values in the reference's order (planar then
//                   edge, d = 1..w, source block before target block), so
//                   from equal pair values it gives the reference's bits.
//                   One extra block sums the costs as torch.sum does.
//
// No atomics: two launches on equal inputs give equal bits.  Below 64 slots
// a pair the sums run in torch.sum's order too, so the outputs are the
// reference's bits and an LM run takes the reference's steps.
//
// What bounds it on the H100.  At the 1000-pose map (Q = 9,945 pairs of 20
// planar and 10 edge slots) the inputs are ~9 MB: 3 us at 3.35 TB/s; the
// arithmetic is ~40 Mflop, about 1 us at 33.5e12 float32 operations a
// second.  Either bound is far below a launch's own cost, so the design
// only has to keep to two launches and to coalesced reads.
//
// Numerics.  Compiled with --fmad=false and without fast math
// (kernels/_build.py), so each product and sum rounds as the separate
// torch operations of the reference do; cos and sin are the CUDA math
// library's, as torch's.  Only the slot sums of whole clouds (optimization
// type 'all', 64 or more slots) run in an order of their own, and so does
// the edge cost of a map past ~1,300 poses at 10 edge slots (512 * 256
// values or more: torch splits that sum across blocks; CR's 5000 poses).
//
// Torch's order is a private detail of ATen/native/cuda/Reduce.cuh, read
// here on torch 2.11.0+cu128; only the warps' direction is probed at run
// time.  After a torch upgrade, the cuda tests' bit-for-bit cases
// (tests/test_torch_cuda.py, below 64 slots) say whether it still holds;
// if not, the kernel's sums are merely another order, and the benchmark's
// float32 limits that sit near the parent's own bits need re-reading.

#include <cuda_runtime.h>

#include <cstdint>

#include "csm_common.cuh"

namespace {

constexpr int kPairValues = 34;   // 9 + 9 + 9 block entries, 6 g, 1 cost
constexpr int kSrc = 0, kTgt = 9, kOff = 18, kG = 27, kCost = 33;
constexpr int kWarps = 8;         // pairs per block of pair_moments
constexpr int kThreads = 512;     // threads per block of band_assemble
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float cos_(float v) { return cosf(v); }
__device__ __forceinline__ double cos_(double v) { return cos(v); }
__device__ __forceinline__ float sin_(float v) { return sinf(v); }
__device__ __forceinline__ double sin_(double v) { return sin(v); }

// The order of torch's CUDA sums (ATen/native/cuda/Reduce.cuh), which the
// plain version takes: the kernel adds in the same order where it can, so
// that its outputs are the plain version's bits and an LM run takes the same
// steps either way (the stop tests compare float32 costs at rounding level,
// so another order moves the sweep's end).  kTorchUnroll: accumulators a
// thread keeps; kTorchVector: elements it loads at once in a sum of 128 or
// more contiguous values.  A warp's last combining steps shuffle down by
// width/2, ..., 1 in recent torch and by 1, ..., width/2 before: the
// wrapper reads which from torch once (`down`).
constexpr int kTorchUnroll = 4;
constexpr int kTorchVector = 4;
constexpr int kTorchThreads = 512;        // the most threads a sum takes
static_assert(kThreads >= kTorchThreads, "the cost block runs torch_sum");

__device__ __forceinline__ int last_pow2(long long n) {
  int p = 0;
  while ((2LL << p) <= n) ++p;
  return n > 0 ? 1 << p : 0;
}

// Lanes 0..width-1 of the warp hold partial sums; lane 0 gets their total,
// combined as a torch reduction's warp combines them.
template <typename T, int K>
__device__ __forceinline__ void tree_sum(T (&v)[K], int width, bool down) {
  for (int i = 1; i < width; i <<= 1) {
    const int off = down ? width / (2 * i) : i;
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = v[k] + __shfl_down_sync(kFull, v[k], off);
  }
}

// A lane's share of a pair's K slot sums, terms(s, t) writing slot s's K
// terms.  For S < 64 slots it is torch.sum(t, dim=-1)'s on a contiguous
// [Q, S] tensor: width = last_pow2(S) lanes, lane L adds slot L and, where
// it exists, slot L + width into its four accumulators, then combines them
// in order.  Whole clouds (optimization type 'all', S >= 64) take 32 lanes
// that walk the slots 32 apart, in order.  Returns the width for tree_sum.
template <typename T, int K, typename Terms>
__device__ __forceinline__ int lane_sums(T (&acc)[K], int S, int lane,
                                         Terms terms) {
  const int width = S < 64 ? last_pow2(S) : 32;
  T t[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = T(0);
  if (lane >= width) return width;
  if (S < 64) {
    // Accumulators 0 and 1 of kTorchUnroll (2 and 3 stay 0): width > S / 2.
    T u[K];
    terms(lane, t);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      acc[k] = acc[k] + t[k];
      u[k] = T(0);
    }
    if (lane + width < S) {
      terms(lane + width, t);
#pragma unroll
      for (int k = 0; k < K; ++k) u[k] = u[k] + t[k];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = ((acc[k] + u[k]) + T(0)) + T(0);
  } else {
    for (int s = lane; s < S; s += 32) {
      terms(s, t);
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = acc[k] + t[k];
    }
  }
  return width;
}

// torch.sum(x) of N contiguous values on this card, for N below 512 * 256
// (one block, no split across blocks), by a block of kTorchThreads threads:
// thread t of the first `width` holds kTorchVector accumulators over the
// vectors t, t + width, ... (plain values t and t + width below 128
// values), then shared memory halves the width to 32 and a warp finishes.
// Larger N (whole clouds) keep this order, which is then not torch's.  The
// total is valid in thread 0.
template <typename T>
__device__ T torch_sum(const T* x, long long N, bool down, T* red) {
  const int t = threadIdx.x;
  const bool vec = N >= 128;
  const int width = vec ? min(last_pow2(N / kTorchVector), kTorchThreads)
                        : last_pow2(N);
  T v = T(0);
  if (t < width && vec) {
    T acc[kTorchVector];
#pragma unroll
    for (int i = 0; i < kTorchVector; ++i) acc[i] = T(0);
    for (long long idx = t; idx * kTorchVector + kTorchVector - 1 < N;
         idx += width) {
#pragma unroll
      for (int i = 0; i < kTorchVector; ++i) {
        acc[i] = acc[i] + x[idx * kTorchVector + i];
      }
    }
    const long long tail = N - N % kTorchVector + t;
    if (tail < N) acc[0] = acc[0] + x[tail];
    v = acc[0];
#pragma unroll
    for (int i = 1; i < kTorchVector; ++i) v = v + acc[i];
  } else if (t < width) {
    // width > N / 2: a thread holds at most two values.
    T acc[kTorchUnroll];
#pragma unroll
    for (int i = 0; i < kTorchUnroll; ++i) acc[i] = T(0);
    acc[0] = acc[0] + x[t];
    if (t + width < N) acc[1] = acc[1] + x[t + width];
    v = acc[0];
#pragma unroll
    for (int i = 1; i < kTorchUnroll; ++i) v = v + acc[i];
  }
  red[t] = v;
  int w = width;
  for (; w > 32; w /= 2) {
    __syncthreads();
    if (t < w / 2) {
      v = v + red[t + w / 2];
      red[t] = v;
    }
  }
  __syncthreads();
  if (t < 32) {
    T one[1] = {v};
    tree_sum(one, w, down);
    v = one[0];
  }
  __syncthreads();
  return v;
}

// Rows of the delta-major layout before delta d: sum over k < d of
// max(n - k, 0) (factors.BandLayout.offsets).
__device__ __forceinline__ long long layout_offset(int n, int d) {
  const long long m = d - 1 < n ? d - 1 : n;
  return m * n - m * (m + 1) / 2;
}

template <typename T>
struct Pose {
  T x, y, c, s;
};

// Pose i of x [M, 3]; an index outside x reads nothing and gives a NaN
// pose, so its pair's values are NaN (the reference raises there).
template <typename T>
__device__ __forceinline__ Pose<T> pose_of(const T* x, long long M,
                                           long long i) {
  if (i < 0 || i >= M) {
    const T nan = T(__int_as_float(0x7fc00000));
    return Pose<T>{nan, nan, nan, nan};
  }
  const T th = x[3 * i + 2];
  return Pose<T>{x[3 * i], x[3 * i + 1], cos_(th), sin_(th)};
}

// factors._pt_geometry for one point: p_t and a3 = R_t^T R'(th_s) p.
template <typename T>
struct Geometry {
  T ptx, pty, a3x, a3y;
};

template <typename T>
__device__ __forceinline__ Geometry<T> geometry(const Pose<T>& ps,
                                                const Pose<T>& pt, T px,
                                                T py) {
  const T wx = ps.c * px - ps.s * py + ps.x;
  const T wy = ps.s * px + ps.c * py + ps.y;
  const T dx = wx - pt.x, dy = wy - pt.y;
  const T ptx = pt.c * dx + pt.s * dy;
  const T pty = -pt.s * dx + pt.c * dy;
  const T rpx = -ps.s * px - ps.c * py;
  const T rpy = ps.c * px - ps.s * py;
  return Geometry<T>{ptx, pty, pt.c * rpx + pt.s * rpy,
                     -pt.s * rpx + pt.c * rpy};
}

struct Batch {
  const int64_t* src;
  const int64_t* tgt;
  const void* src_pts;
  const void* tgt_pts;
  const void* src_nrm;   // planar only
  const void* tgt_nrm;   // planar only
  const uint8_t* mask;
  int Q, S;
};

// The 15 terms of factors._moments_normal for one normal and one point,
// each rounded as the reference's separate operations round it.
template <typename T>
__device__ __forceinline__ void normal_terms(T* a, T nx, T ny,
                                             const Geometry<T>& g,
                                             const Pose<T>& pt, T dx, T dy,
                                             T m) {
  const T u = nx * pt.c - ny * pt.s;
  const T v = nx * pt.s + ny * pt.c;
  const T w = nx * g.a3x + ny * g.a3y;
  const T zc = nx * g.pty - ny * g.ptx;
  const T rr = (nx * dx + ny * dy) * m;
  const T mu = m * u, mv = m * v, mw = m * w, mz = m * zc;
  a[0] = mu * u;  a[1] = mu * v;  a[2] = mu * w;  a[3] = mu * zc;
  a[4] = mv * v;  a[5] = mv * w;  a[6] = mv * zc;
  a[7] = mw * w;  a[8] = mw * zc; a[9] = mz * zc;
  a[10] = u * rr; a[11] = v * rr; a[12] = w * rr; a[13] = zc * rr;
  a[14] = rr * rr;
}

template <typename T>
__device__ __forceinline__ void store(T* out, long long Qt, long long q,
                                      const T (&v)[kPairValues]) {
#pragma unroll
  for (int k = 0; k < kPairValues; ++k) out[k * Qt + q] = v[k];
}

template <typename T>
__device__ void planar_pair(const T* x, long long M, const Batch& b,
                            long long q, int lane, bool down, T* out,
                            long long Qt) {
  const Pose<T> ps = pose_of(x, M, b.src[q]), pt = pose_of(x, M, b.tgt[q]);
  const T* sp = static_cast<const T*>(b.src_pts) + 2 * q * b.S;
  const T* tp = static_cast<const T*>(b.tgt_pts) + 2 * q * b.S;
  const T* sn = static_cast<const T*>(b.src_nrm) + 2 * q * b.S;
  const T* tn = static_cast<const T*>(b.tgt_nrm) + 2 * q * b.S;
  const uint8_t* mask = b.mask + q * b.S;
  // The target normal's 15 sums, then the source normal's.
  T a[30];
  const int width = lane_sums(a, b.S, lane, [&](int s, T (&t)[30]) {
    const Geometry<T> g = geometry(ps, pt, sp[2 * s], sp[2 * s + 1]);
    const T m = mask[s] ? T(1) : T(0);
    const T dx = g.ptx - tp[2 * s], dy = g.pty - tp[2 * s + 1];
    normal_terms(t, tn[2 * s], tn[2 * s + 1], g, pt, dx, dy, m);
    normal_terms(t + 15, sn[2 * s], sn[2 * s + 1], g, pt, dx, dy, m);
  });
  tree_sum(a, width, down);
  if (lane != 0) return;
  T t[15];
#pragma unroll
  for (int k = 0; k < 15; ++k) t[k] = a[k] + a[15 + k];   // target + source
  const T uu = t[0], uv = t[1], uw = t[2], uz = t[3], vv = t[4], vw = t[5],
          vz = t[6], ww = t[7], wz = t[8], zz = t[9], ur = t[10], vr = t[11],
          wr = t[12], zr = t[13];
  const T v[kPairValues] = {
      uu, uv, uw, uv, vv, vw, uw, vw, ww,                // H[:3, :3]
      uu, uv, -uz, uv, vv, -vz, -uz, -vz, zz,            // H[3:, 3:]
      -uu, -uv, uz, -uv, -vv, vz, -uw, -vw, wz,          // H[:3, 3:]
      ur, vr, wr, -ur, -vr, zr,                          // g
      t[14]};                                            // sum of r^2
  store(out, Qt, q, v);
}

// Also writes each slot's r^2 to sq [Q, S]: the edge cost is one sum over
// all of them, as the reference takes it.
template <typename T>
__device__ void edge_pair(const T* x, long long M, const Batch& b,
                          long long q, int lane, bool down, T* out,
                          long long Qt, T* sq) {
  const Pose<T> ps = pose_of(x, M, b.src[q]), pt = pose_of(x, M, b.tgt[q]);
  const T* sp = static_cast<const T*>(b.src_pts) + 2 * q * b.S;
  const T* tp = static_cast<const T*>(b.tgt_pts) + 2 * q * b.S;
  const uint8_t* mask = b.mask + q * b.S;
  sq += q * b.S;
  // M0, S3x, S3y, S6x, S6y, s33, s36, s66, Srx, Sry, g3r, g6r
  T a[12];
  const int width = lane_sums(a, b.S, lane, [&](int s, T (&t)[12]) {
    const Geometry<T> g = geometry(ps, pt, sp[2 * s], sp[2 * s + 1]);
    const T m = mask[s] ? T(1) : T(0);
    const T a6x = g.pty, a6y = -g.ptx;
    const T rx = (tp[2 * s] - g.ptx) * m;
    const T ry = (tp[2 * s + 1] - g.pty) * m;
    t[0] = m;
    t[1] = m * g.a3x;
    t[2] = m * g.a3y;
    t[3] = m * a6x;
    t[4] = m * a6y;
    t[5] = m * (g.a3x * g.a3x + g.a3y * g.a3y);
    t[6] = m * (g.a3x * a6x + g.a3y * a6y);
    t[7] = m * (a6x * a6x + a6y * a6y);
    t[8] = rx;
    t[9] = ry;
    t[10] = g.a3x * rx + g.a3y * ry;
    t[11] = a6x * rx + a6y * ry;
    sq[s] = rx * rx + ry * ry;
  });
  tree_sum(a, width, down);
  if (lane != 0) return;
  const T M0 = a[0], S3x = a[1], S3y = a[2], S6x = a[3], S6y = a[4],
          s33 = a[5], s36 = a[6], s66 = a[7], Srx = a[8], Sry = a[9];
  const T ct = pt.c, st = pt.s, z = T(0);
  const T h13 = ct * S3x - st * S3y, h23 = st * S3x + ct * S3y;
  const T h16 = ct * S6x - st * S6y, h26 = st * S6x + ct * S6y;
  const T g1 = -(ct * Srx - st * Sry), g2 = -(st * Srx + ct * Sry);
  const T v[kPairValues] = {
      M0, z, h13, z, M0, h23, h13, h23, s33,             // H[:3, :3]
      M0, z, -h16, z, M0, -h26, -h16, -h26, s66,         // H[3:, 3:]
      -M0, z, h16, z, -M0, h26, -h13, -h23, s36,         // H[:3, 3:]
      g1, g2, -a[10], -g1, -g2, -a[11],                  // g
      z};                                                // (in sq)
  store(out, Qt, q, v);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
pair_moments(const T* __restrict__ x, int M, Batch planar, Batch edge,
             bool down, T* __restrict__ out, T* __restrict__ sq) {
  const long long q = static_cast<long long>(blockIdx.x) * kWarps
                      + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long Qt = static_cast<long long>(planar.Q) + edge.Q;
  if (q < planar.Q) {
    planar_pair(x, M, planar, q, lane, down, out, Qt);
  } else if (q < Qt) {
    edge_pair(x, M, edge, q - planar.Q, lane, down, out + planar.Q, Qt, sq);
  }
}

// Adds pair values into one output entry in the reference's order: planar
// then edge, d = 1..w, the pair whose source is node i (value index
// src_k) before the pair whose target is node i (tgt_k; < 0: none).
template <typename T>
__device__ __forceinline__ T gather(const T* pair, long long Qt, int Qp,
                                    int Qe, int n, int w, int i, int src_k,
                                    int tgt_k, int only_d) {
  T acc = T(0);
  for (int p = 0; p < 2; ++p) {
    const int Q = p ? Qe : Qp;
    if (Q == 0) continue;
    const T* base = pair + (p ? Qp : 0);
    for (int d = 1; d <= w; ++d) {
      if (only_d && d != only_d) continue;
      const long long off = layout_offset(n, d);
      if (i >= d) acc += base[src_k * Qt + off + (i - d)];
      if (tgt_k >= 0 && i + d < n) acc += base[tgt_k * Qt + off + i];
    }
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
band_assemble(const T* __restrict__ pair, const T* __restrict__ sq, int Qp,
              int Qe, int Se, int n, int w, bool down, int entry_blocks,
              T* __restrict__ diag, T* __restrict__ band,
              T* __restrict__ gd, T* __restrict__ cost) {
  const long long Qt = static_cast<long long>(Qp) + Qe;
  if (static_cast<int>(blockIdx.x) == entry_blocks) {
    // The reference's cost: 0 + 0.5 * sum of the planar pairs' r^2, then
    // + 0.5 * sum of the edge slots' r^2, each sum in torch.sum's order.
    __shared__ T red[kThreads];
    T total = T(0);
    if (Qp > 0) {
      total = total + T(0.5) * torch_sum(pair + kCost * Qt, Qp, down, red);
    }
    if (Qe > 0) {
      total = total + T(0.5) * torch_sum(sq, static_cast<long long>(Qe) * Se,
                                         down, red);
    }
    if (threadIdx.x == 0) cost[0] = total;
    return;
  }
  const long long t = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  const int per = 12 + 9 * w;
  if (t >= static_cast<long long>(n) * per) return;
  const int e = static_cast<int>(t / n);
  const int i = static_cast<int>(t % n);
  if (e < 9) {
    diag[9LL * i + e] = gather(pair, Qt, Qp, Qe, n, w, i, kSrc + e, kTgt + e,
                               0);
  } else if (e < 12) {
    const int c = e - 9;
    gd[3LL * i + c] = gather(pair, Qt, Qp, Qe, n, w, i, kG + c, kG + 3 + c,
                             0);
  } else {
    const int d = (e - 12) / 9 + 1, ab = (e - 12) % 9;
    band[(static_cast<long long>(d - 1) * n + i) * 9 + ab] =
        gather(pair, Qt, Qp, Qe, n, w, i, kOff + ab, -1, d);
  }
}

template <typename T>
int launch(const void* x, int M, const Batch& planar, const Batch& edge,
           int n, int w, bool down, void* scratch, void* diag, void* band,
           void* gd, void* cost, cudaStream_t s) {
  const long long Qt = static_cast<long long>(planar.Q) + edge.Q;
  T* pair = static_cast<T*>(scratch);
  T* sq = pair + kPairValues * Qt;
  if (Qt > 0) {
    const long long blocks = (Qt + kWarps - 1) / kWarps;
    pair_moments<T><<<static_cast<unsigned>(blocks), kWarps * 32, 0, s>>>(
        static_cast<const T*>(x), M, planar, edge, down, pair, sq);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long entries = static_cast<long long>(n) * (12 + 9 * w);
  const int entry_blocks =
      static_cast<int>((entries + kThreads - 1) / kThreads);
  band_assemble<T><<<entry_blocks + 1, kThreads, 0, s>>>(
      pair, sq, planar.Q, edge.Q, edge.S, n, w, down, entry_blocks,
      static_cast<T*>(diag), static_cast<T*>(band), static_cast<T*>(gd),
      static_cast<T*>(cost));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The correspondence part of the moment-form band assembly on `stream`:
// diag [n, 3, 3], band [w, n, 3, 3], gd [n, 3] and cost [] from x [M, 3]
// and the planar (normal residual) and edge (point residual) batches, each
// Q pairs in the delta-major layout of (n, w) (Q = 0: the batch is empty)
// with S slots: int64 src/tgt [Q], points and normals [Q, S, 2], bool mask
// [Q, S].  double_precision: every floating array is float64, else
// float32.  tree_down: torch's warps shuffle down by width/2 first.
// scratch holds 34 * (Qp + Qe) + Qe * Se values.  All device pointers to
// contiguous arrays.  Returns a cudaError_t code (0 on success).
int nautilus_band_moments(int double_precision, const void* x, int M,
                          const int64_t* p_src, const int64_t* p_tgt,
                          const void* p_src_pts, const void* p_tgt_pts,
                          const void* p_src_nrm, const void* p_tgt_nrm,
                          const uint8_t* p_mask, int Qp, int Sp,
                          const int64_t* e_src, const int64_t* e_tgt,
                          const void* e_src_pts, const void* e_tgt_pts,
                          const uint8_t* e_mask, int Qe, int Se, int n, int w,
                          int tree_down, void* scratch, void* diag,
                          void* band, void* gd, void* cost, void* stream) {
  if (M < 0 || Qp < 0 || Qe < 0 || Sp < 0 || Se < 0 || n < 0 || w < 0 ||
      static_cast<long long>(n) * (12 + 9 * w) / kThreads >= 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Batch planar{p_src, p_tgt, p_src_pts, p_tgt_pts, p_src_nrm,
                     p_tgt_nrm, p_mask, Qp, Sp};
  const Batch edge{e_src, e_tgt, e_src_pts, e_tgt_pts, nullptr, nullptr,
                   e_mask, Qe, Se};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return double_precision
             ? launch<double>(x, M, planar, edge, n, w, tree_down != 0,
                              scratch, diag, band, gd, cost, s)
             : launch<float>(x, M, planar, edge, n, w, tree_down != 0,
                             scratch, diag, band, gd, cost, s);
}

}  // extern "C"
