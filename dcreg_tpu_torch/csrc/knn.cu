// K2 and K3: brute-force k-NN over a frame-sized target cloud.
//
// K2 replaces the Pallas TPU kernel dcreg_tpu/ops/pallas_knn.py
// `_knn_kernel` (launched by `knn`): for every query point, the kk
// smallest candidates over all M targets, where a candidate is the exact
// pair (d, j) of the squared distance
//   d = min(((pen_j + (q.x - t.x)^2) + (q.y - t.y)^2) + (q.z - t.z)^2, BIG)
// and the target's index j, ordered by d and then by j.  pen_j is 0 for a
// valid target and BIG = 3.0e38 for an invalid one, as the TPU kernel's
// penalty strip.  The exact re-rank and the final top-k run outside, in
// PyTorch (ops/knn_kernels.py).
//
// K3 replaces `_gmin_kernel` (launched by `knn_grouped`): for every query
// and every group of 128 consecutive targets, min over the group of the
// same d (phase A of the two-phase exact k-NN), stored (groups, queries).
//
// Design on Hopper.  The TPU walks (query tile, target tile) grid steps in
// order and carries a (TQ, kk) best list in VMEM; it packs the tile-local
// column into the low mantissa bits of each f32 distance so one min finds
// value and column at once, at the price of a quantisation that depends on
// the tile width and a 2^-30 bias.  Here one thread owns one query point
// and keeps its kk best candidates in registers as 64-bit keys
//   (float bits of d) << 32 | j
// which order exactly like (d, j), because a non-negative float orders
// like its bits: no quantisation, no bias, the JAX merge's tie rule (lower
// index first on equal distance) by construction, int32 indices.  kk is a
// template parameter and the insertion is fully unrolled, so the list
// never leaves registers.  The targets stream through shared memory in
// tiles of 2,048 points (x, y, z and the penalty: 32 KB); every thread of
// the 128-thread CTA reads the same target at a time (a broadcast).
//
// Bit-exact with the plain PyTorch twins: the float operations are pinned
// with __fsub_rn / __fmul_rn / __fadd_rn in the JAX order, and the library
// is built with --fmad=false.
//
// What bounds them: f32 ALU work on the CUDA cores, 10 operations per
// (query, target) pair (3 sub, 3 mul, 3 add, 1 min), plus K2's compare and
// insert; the bytes moved are small (queries once, each target once per
// CTA from L2).  This first version is simple: one thread per query, so
// N = 8,192 queries give 64 CTAs for 132 SMs; splitting M across CTAs with
// a merge pass is later work.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;     // queries per CTA
constexpr int TT = 2048;         // targets per shared-memory tile
constexpr int GROUP = 128;       // K3's target group
constexpr float BIG = 3.0e38f;

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float tx, float ty, float tz,
                                         float pen) {
  const float dx = __fsub_rn(qx, tx);
  const float dy = __fsub_rn(qy, ty);
  const float dz = __fsub_rn(qz, tz);
  const float d = __fadd_rn(__fadd_rn(__fadd_rn(pen, __fmul_rn(dx, dx)),
                                      __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
  return fminf(d, BIG);
}

// Stage targets [j0, j0 + n) of the AoS (M, 3) cloud and their penalties
// into shared memory as x, y, z, pen rows.
__device__ __forceinline__ void load_tile(float (*s)[TT],
                                          const float* __restrict__ tgt,
                                          const float* __restrict__ pen,
                                          int j0, int n) {
  const float* src = tgt + 3ll * j0;
  for (int e = threadIdx.x; e < 3 * n; e += THREADS) s[e % 3][e / 3] = src[e];
  for (int e = threadIdx.x; e < n; e += THREADS) s[3][e] = pen[j0 + e];
}

template <int KK>
__global__ void __launch_bounds__(THREADS)
knn_candidates_kernel(const float* __restrict__ query, int n,
                      const float* __restrict__ tgt,
                      const float* __restrict__ pen, int m,
                      float* __restrict__ val, int* __restrict__ idx) {
  __shared__ float s[4][TT];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool live = i < n;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (live) {
    qx = query[3ll * i + 0];
    qy = query[3ll * i + 1];
    qz = query[3ll * i + 2];
  }
  // an empty slot is (BIG, -1): after every real candidate, BIG ones too
  const unsigned long long init_key =
      (static_cast<unsigned long long>(__float_as_uint(BIG)) << 32) |
      0xFFFFFFFFull;
  unsigned long long best[KK];
#pragma unroll
  for (int r = 0; r < KK; ++r) best[r] = init_key;

  for (int j0 = 0; j0 < m; j0 += TT) {
    const int nt = min(TT, m - j0);
    __syncthreads();            // the previous tile is consumed
    load_tile(s, tgt, pen, j0, nt);
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int j = 0; j < nt; ++j) {
      const float d = sq_dist(qx, qy, qz, s[0][j], s[1][j], s[2][j], s[3][j]);
      const unsigned long long key =
          (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
          static_cast<unsigned int>(j0 + j);
      if (key < best[KK - 1]) {
        // replace the largest, then one compare-exchange pass down
        best[KK - 1] = key;
#pragma unroll
        for (int r = KK - 1; r > 0; --r) {
          const unsigned long long a = best[r - 1], b = best[r];
          const bool swap = b < a;
          best[r - 1] = swap ? b : a;
          best[r] = swap ? a : b;
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < KK; ++r) {
    val[static_cast<long long>(i) * KK + r] =
        __uint_as_float(static_cast<unsigned int>(best[r] >> 32));
    idx[static_cast<long long>(i) * KK + r] =
        static_cast<int>(static_cast<unsigned int>(best[r] & 0xFFFFFFFFull));
  }
}

__global__ void __launch_bounds__(THREADS)
group_min_kernel(const float* __restrict__ query, int n,
                 const float* __restrict__ tgt,
                 const float* __restrict__ pen, int m,
                 float* __restrict__ out) {
  __shared__ float s[4][TT];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool live = i < n;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (live) {
    qx = query[3ll * i + 0];
    qy = query[3ll * i + 1];
    qz = query[3ll * i + 2];
  }
  for (int j0 = 0; j0 < m; j0 += TT) {
    const int nt = min(TT, m - j0);
    __syncthreads();
    load_tile(s, tgt, pen, j0, nt);
    __syncthreads();
    if (!live) continue;
    for (int g0 = 0; g0 < nt; g0 += GROUP) {
      const int ng = min(GROUP, nt - g0);
      float best = BIG;         // targets past m count as BIG, as padding
#pragma unroll 4
      for (int j = g0; j < g0 + ng; ++j)
        best = fminf(best, sq_dist(qx, qy, qz, s[0][j], s[1][j], s[2][j],
                                   s[3][j]));
      // (groups, queries): consecutive threads write consecutive addresses
      out[static_cast<long long>((j0 + g0) / GROUP) * n + i] = best;
    }
  }
}

template <int KK>
int launch_candidates(const float* q, int n, const float* t, const float* p,
                      int m, float* val, int* idx, cudaStream_t stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  knn_candidates_kernel<KK><<<blocks, THREADS, 0, stream>>>(q, n, t, p, m,
                                                            val, idx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K2 on `stream`; returns cudaGetLastError() (0 on success).
// query (n, 3) f32, tgt (m, 3) f32, pen (m,) f32 (0 valid, BIG invalid);
// val (n, kk) f32 ascending, idx (n, kk) int32; slots past the m-th
// candidate hold (BIG, -1).  1 <= kk <= 16.
extern "C" int dcreg_knn_candidates(const float* query, int n,
                                    const float* tgt, const float* pen,
                                    int m, int kk, float* val, int* idx,
                                    void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kk) {
#define DCREG_KK(K) \
  case K:           \
    return launch_candidates<K>(query, n, tgt, pen, m, val, idx, s);
    DCREG_KK(1) DCREG_KK(2) DCREG_KK(3) DCREG_KK(4) DCREG_KK(5) DCREG_KK(6)
    DCREG_KK(7) DCREG_KK(8) DCREG_KK(9) DCREG_KK(10) DCREG_KK(11)
    DCREG_KK(12) DCREG_KK(13) DCREG_KK(14) DCREG_KK(15) DCREG_KK(16)
#undef DCREG_KK
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches K3 on `stream`; returns cudaGetLastError() (0 on success).
// query (n, 3), tgt (m, 3), pen (m,) f32; out (ceil(m / 128), n) f32.
extern "C" int dcreg_knn_group_min(const float* query, int n,
                                   const float* tgt, const float* pen, int m,
                                   float* out, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  group_min_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      query, n, tgt, pen, m, out);
  return static_cast<int>(cudaGetLastError());
}
