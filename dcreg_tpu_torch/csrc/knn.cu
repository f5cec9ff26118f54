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
// The TPU walks (query tile, target tile) grid steps in order and carries
// a (TQ, kk) best list in VMEM; it packs the tile-local column into the
// low mantissa bits of each f32 distance, a quantisation that depends on
// the tile width.  Here a candidate is ordered by the exact pair (f32 bits
// of d, j): a non-negative float orders like its bits, so there is no
// quantisation and the JAX merge's tie rule (lower index first) holds.
//
// What bounds them on Hopper: f32 ALU work on the CUDA cores, 10
// operations per (query, target) pair (3 sub, 3 mul, 3 add, 1 min or
// compare); the bytes moved are small (queries once, targets once per CTA
// from L2).  Built with --fmad=false, so the 9 float operations of a
// distance are 9 instructions and about twice the f32 peak's time is
// their floor.  The first version ran one thread per query over all M
// targets: N = 8,192 queries gave 64 CTAs of 4 warps for 132 SMs, and each
// thread's chain had nothing to hide its latency.  This design:
//
// K2.  A warp owns QPW = 4 queries, and its 32 lanes take 32 targets at a
//    time from a shared-memory tile of 1,024 (x, y, z, pen) float4s: one
//    LDS.128 per lane serves four pairs, and four independent distance
//    chains hide each other's latency.  Each query's list lives across the
//    warp in E = 1, 2 or 4 registers per lane (E * 32 >= kk, a template
//    parameter; with E = 1, kk <= 32 is one too, since a run-time kk
//    slows the one-slot kernel, the one the frame-scale searches run),
//    lane r holding entries r, r + 32, ...: 32 E entries, of
//    which the first kk are the answer.  An insertion shifts each slot up
//    one lane, and lane 31's entry of slot e moves to lane 0 of slot
//    e + 1.  A lane's candidate is tested against entry kk - 1 as it
//    stood when the batch began, one vote per 32 x 4 pairs tells the warp
//    whether any passes, and those that do go in one at a time, lowest
//    index first, by ballot and shuffle, with no second test: a candidate
//    that an earlier one of its batch pushed out of the first kk lands
//    behind them, where it does no harm.  Every lane works on every
//    insertion, none waits for another lane's.  (With a query and a list
//    per lane, a warp walks every insertion that any of its 32 queries
//    needs, and at N = 8,192 that, not the arithmetic, sets the time.)
//    - CTAs of 8 warps share each tile among 32 / S queries.  S, the
//      split, is 1 unless N is too small to give the card 8 warps per SM
//      (the wrapper chooses it from N and the SM count): then the S warps
//      of a query group each scan [s*1024/S, (s+1)*1024/S) of every tile,
//      and at the end warp 0 of the group merges the S lists by the full
//      (d, j) order in shared memory (8 KB per list slot, up to 32 KB at
//      E = 4, over the tile's 16 KB).  (d, j) is unique per query, so the
//      merge is exact whatever the order of the slices.
//    - Within a warp's scan the indices grow, so a new candidate goes
//      after an equal distance, and an empty slot holds the float just
//      above BIG, so that a BIG candidate (an invalid target) still enters
//      it.  The test of a lane's candidate is !(d >= bound) on the
//      unclamped distance, with bound = the last entry or NaN while the
//      list has an empty slot: exact, and one instruction per pair.
// K3.  The grid is (query blocks of 128, S chunks of whole 128-target
//    groups), S chosen by the wrapper from N, M and the SM count (1,024
//    CTAs at N = M = 8,192).  CTA (b, s) writes only its own groups' rows,
//    so no merge is needed.  The same float4 tile, with the padding past M
//    at an infinite penalty, and four independent fminf chains per group:
//    fminf is exact, so the order of the minima does not change a bit.
//
// Bit-exact with the plain PyTorch twins: the float operations are pinned
// with __fsub_rn / __fmul_rn / __fadd_rn in the JAX order, and the library
// is built with --fmad=false.
#include <cuda_runtime.h>

namespace {

constexpr int QPW = 4;            // K2: queries per warp
constexpr int K2_WARPS = 8;       // K2: warps per CTA
constexpr int TT = 1024;          // K2: targets per shared-memory tile
constexpr int GQ = 128;           // K3: queries per CTA
constexpr int GT = 1024;          // K3: targets per tile (8 groups)
constexpr int GROUP = 128;        // K3's target group
constexpr float BIG = 3.0e38f;
constexpr unsigned EMPTY_BITS = 0x7F61B1E7u;   // the float just above BIG
constexpr unsigned FULL = 0xFFFFFFFFu;

// ((pen + dx^2) + dy^2) + dz^2, not yet clamped at BIG
__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float4 t) {
  const float dx = __fsub_rn(qx, t.x);
  const float dy = __fsub_rn(qy, t.y);
  const float dz = __fsub_rn(qz, t.z);
  return __fadd_rn(__fadd_rn(__fadd_rn(t.w, __fmul_rn(dx, dx)),
                             __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Targets [j0, j0 + n) of the AoS (M, 3) cloud and their penalties as
// (x, y, z, pen) float4s; targets at or past m get an infinite penalty.
__device__ __forceinline__ void load_tile(float4* s,
                                          const float* __restrict__ tgt,
                                          const float* __restrict__ pen,
                                          int j0, int n, int m) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int j = j0 + e;
    if (j < m) {
      const float* p = tgt + 3ll * j;
      s[e] = make_float4(p[0], p[1], p[2], pen[j]);
    } else {
      s[e] = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(0x7F800000));
    }
  }
}

// (d, j) order with j unsigned: an empty slot (EMPTY, -1) is last.
__device__ __forceinline__ bool key_less(float da, int ja, float db,
                                         int jb) {
  return da < db || (da == db && static_cast<unsigned>(ja) <
                                     static_cast<unsigned>(jb));
}

// (d, j) enters a warp's list of E slots, entry p = 32 e + lane held by
// lane p % 32 in slot p / 32, ascending; `before[e]` is true on the lanes
// whose entry of slot e stays ahead of it.  Entries from its position on
// move up by one, lane 31's entry of a slot to lane 0 of the next, and
// the last entry drops out.  With E > 1, slots wholly ahead of the
// position keep still (the position is the same on every lane); with one
// slot there is nothing to skip, and no test.
template <int E>
__device__ __forceinline__ void warp_insert(float (&h)[E], int (&l)[E],
                                            float d, int j,
                                            const bool (&before)[E],
                                            int lane) {
  int pos = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) pos += __popc(__ballot_sync(FULL, before[e]));
#pragma unroll
  for (int e = E - 1; e >= 0; --e) {
    if (E > 1 && 32 * e + 31 < pos) continue;
    float hu = __shfl_up_sync(FULL, h[e], 1);
    int lu = __shfl_up_sync(FULL, l[e], 1);
    if (e > 0) {                // read before slot e - 1 moves
      const float hc = __shfl_sync(FULL, h[e > 0 ? e - 1 : 0], 31);
      const int lc = __shfl_sync(FULL, l[e > 0 ? e - 1 : 0], 31);
      if (lane == 0) {
        hu = hc;
        lu = lc;
      }
    }
    const int p = 32 * e + lane;
    if (p > pos) {
      h[e] = hu;
      l[e] = lu;
    } else if (p == pos) {
      h[e] = d;
      l[e] = j;
    }
  }
}

// Entry p of a warp's list, on every lane.
template <int E, typename T>
__device__ __forceinline__ T list_entry(const T (&a)[E], int p) {
  T v = a[0];
#pragma unroll
  for (int e = 1; e < E; ++e)
    if ((p >> 5) == e) v = a[e];
  return __shfl_sync(FULL, v, p & 31);
}

// What a lane's unclamped distance is tested against: entry kk - 1, or
// NaN while that is an empty slot, so that !(d >= bound) passes every
// distance, an overflowing invalid one too.
__device__ __forceinline__ float bound_of(float last) {
  return last > BIG ? __int_as_float(0x7FC00000) : last;
}

// Grid ceil(n / (QPW * K2_WARPS / split)) CTAs of 32 * K2_WARPS threads.
// Warp w serves query group w / split (QPW queries) and scans slice
// w % split of every tile.  kk is KK where KK > 0, else kk_arg;
// 1 <= kk <= 32 E.
template <int E, int KK>
__global__ void __launch_bounds__(32 * K2_WARPS)
knn_candidates_kernel(const float* __restrict__ query, int n,
                      const float* __restrict__ tgt,
                      const float* __restrict__ pen, int m, int kk_arg,
                      int split, float* __restrict__ val,
                      int* __restrict__ idx) {
  const int kk = KK > 0 ? KK : kk_arg;
  // the tile, then the merge's K2_WARPS * QPW lists of 32 E (d, j)
  // pairs: 512 E float4s
  constexpr int SMEM4 = TT > 512 * E ? TT : 512 * E;
  __shared__ float4 tile[SMEM4];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int s = w % split;
  const int q0 = (blockIdx.x * (K2_WARPS / split) + w / split) * QPW;
  const float empty = __uint_as_float(EMPTY_BITS);
  float qx[QPW], qy[QPW], qz[QPW], h[QPW][E], last[QPW], bound[QPW];
  int l[QPW][E];
#pragma unroll
  for (int q = 0; q < QPW; ++q) {
    // a query past n scans as the last one and writes nothing
    const long long iq = min(q0 + q, n - 1);
    qx[q] = query[3 * iq + 0];
    qy[q] = query[3 * iq + 1];
    qz[q] = query[3 * iq + 2];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      h[q][e] = empty;
      l[q][e] = -1;
    }
    last[q] = empty;
    bound[q] = bound_of(empty);
  }
  const int lo = s * TT / split;
  const int hi = (s + 1) * TT / split;

  for (int j0 = 0; j0 < m; j0 += TT) {
    const int nt = min(TT, m - j0);
    __syncthreads();            // the previous tile is consumed
    load_tile(tile, tgt, pen, j0, nt, m);
    __syncthreads();
    const int end = min(hi, nt);
    const float4* tp = tile + lo + lane;
    const int lim = end - lane;
    for (int b = lo; b < end; b += 32, tp += 32) {
      const float4 t = *tp;   // past `end`: never a candidate
      float d[QPW];
      bool enter[QPW];
      bool any = false;
#pragma unroll
      for (int q = 0; q < QPW; ++q) {
        d[q] = sq_dist(qx[q], qy[q], qz[q], t);
        enter[q] = b < lim && !(d[q] >= bound[q]);
        any |= enter[q];
      }
      if (!__any_sync(FULL, any)) continue;
#pragma unroll
      for (int q = 0; q < QPW; ++q) {
        unsigned ball = __ballot_sync(FULL, enter[q]);
        if (ball == 0) continue;
        while (ball) {
          const int c = __ffs(ball) - 1;
          ball &= ball - 1;
          const float dc = fminf(__shfl_sync(FULL, d[q], c), BIG);
          bool before[E];
#pragma unroll
          for (int e = 0; e < E; ++e) before[e] = h[q][e] <= dc;
          warp_insert<E>(h[q], l[q], dc, j0 + b + c, before, lane);
        }
        last[q] = list_entry<E>(h[q], kk - 1);
        bound[q] = bound_of(last[q]);
      }
    }
  }

  if (split > 1) {
    // the group's other warps leave their lists in shared memory; its
    // warp 0 takes, list by list, the first kk entries that beat its own
    // entry kk - 1, by the full (d, j) order
    float* mh = reinterpret_cast<float*>(tile);
    int* ml = reinterpret_cast<int*>(mh + K2_WARPS * QPW * 32 * E);
    __syncthreads();            // the last tile is consumed
#pragma unroll
    for (int q = 0; q < QPW; ++q) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        mh[((w * QPW + q) * E + e) * 32 + lane] = h[q][e];
        ml[((w * QPW + q) * E + e) * 32 + lane] = l[q][e];
      }
    }
    __syncthreads();
    if (s != 0) return;
    for (int v = 1; v < split; ++v) {
#pragma unroll
      for (int q = 0; q < QPW; ++q) {
        int last_j = list_entry<E>(l[q], kk - 1);
#pragma unroll
        for (int ev = 0; ev < E; ++ev) {
          const float dv = mh[(((w + v) * QPW + q) * E + ev) * 32 + lane];
          const int jv = ml[(((w + v) * QPW + q) * E + ev) * 32 + lane];
          unsigned ball = __ballot_sync(
              FULL, 32 * ev + lane < kk &&
                        key_less(dv, jv, last[q], last_j));
          while (ball) {
            const int c = __ffs(ball) - 1;
            ball &= ball - 1;
            const float dc = __shfl_sync(FULL, dv, c);
            const int jc = __shfl_sync(FULL, jv, c);
            if (key_less(dc, jc, last[q], last_j)) {
              bool before[E];
#pragma unroll
              for (int e = 0; e < E; ++e)
                before[e] = 32 * e + lane < kk &&
                            key_less(h[q][e], l[q][e], dc, jc);
              warp_insert<E>(h[q], l[q], dc, jc, before, lane);
              last[q] = list_entry<E>(h[q], kk - 1);
              last_j = list_entry<E>(l[q], kk - 1);
            }
          }
        }
      }
    }
  }
  // entry p < kk leaves from lane p % 32, slot p / 32; an empty slot
  // leaves as (BIG, -1)
#pragma unroll
  for (int q = 0; q < QPW; ++q) {
    const long long i = q0 + q;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int p = 32 * e + lane;
      if (i < n && p < kk) {
        const bool filled = h[q][e] != empty;
        val[i * kk + p] = filled ? h[q][e] : BIG;
        idx[i * kk + p] = filled ? l[q][e] : -1;
      }
    }
  }
}

// Grid (ceil(n / 128), chunks) of 128 threads: CTA (b, s) takes queries
// [128 b, 128 b + 128) and groups [s * gpc, min((s + 1) * gpc, ng)).
__global__ void __launch_bounds__(GQ)
group_min_kernel(const float* __restrict__ query, int n,
                 const float* __restrict__ tgt,
                 const float* __restrict__ pen, int m, int gpc,
                 float* __restrict__ out) {
  __shared__ float4 s[GT];
  const int i = blockIdx.x * GQ + threadIdx.x;
  const long long iq = min(i, n - 1);
  const float qx = query[3 * iq + 0];
  const float qy = query[3 * iq + 1];
  const float qz = query[3 * iq + 2];
  const int ng = (m + GROUP - 1) / GROUP;
  const int g0 = blockIdx.y * gpc;
  const int j_end = min(g0 + gpc, ng) * GROUP;
  for (int j0 = g0 * GROUP; j0 < j_end; j0 += GT) {
    const int nt = min(GT, j_end - j0);     // whole groups
    __syncthreads();
    load_tile(s, tgt, pen, j0, nt, m);
    __syncthreads();
    for (int g = 0; g < nt; g += GROUP) {
      // four independent chains; the clamp at BIG is their start value,
      // and padding (infinite penalty) never goes below it
      float a0 = BIG, a1 = BIG, a2 = BIG, a3 = BIG;
#pragma unroll 4
      for (int j = g; j < g + GROUP; j += 4) {
        a0 = fminf(a0, sq_dist(qx, qy, qz, s[j + 0]));
        a1 = fminf(a1, sq_dist(qx, qy, qz, s[j + 1]));
        a2 = fminf(a2, sq_dist(qx, qy, qz, s[j + 2]));
        a3 = fminf(a3, sq_dist(qx, qy, qz, s[j + 3]));
      }
      // (groups, queries): consecutive threads write consecutive addresses
      if (i < n)
        out[static_cast<long long>((j0 + g) / GROUP) * n + i] =
            fminf(fminf(a0, a1), fminf(a2, a3));
    }
  }
}

template <int E, int KK>
int launch_candidates(const float* q, int n, const float* t, const float* p,
                      int m, int kk, int split, float* val, int* idx,
                      cudaStream_t stream) {
  const int per_cta = QPW * K2_WARPS / split;
  const int blocks = (n + per_cta - 1) / per_cta;
  knn_candidates_kernel<E, KK><<<blocks, 32 * K2_WARPS, 0, stream>>>(
      q, n, t, p, m, kk, split, val, idx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K2 on `stream`; returns cudaGetLastError() (0 on success).
// query (n, 3) f32, tgt (m, 3) f32, pen (m,) f32 (0 valid, BIG invalid);
// val (n, kk) f32 ascending, idx (n, kk) int32; slots past the m-th
// candidate hold (BIG, -1).  1 <= kk <= 128, kept in E = 1, 2 or 4 slots
// per lane (one instance per kk up to 32, one per E above); split in
// {1, 2, 4, 8}: slices of the targets per query.
extern "C" int dcreg_knn_candidates(const float* query, int n,
                                    const float* tgt, const float* pen,
                                    int m, int kk, int split, float* val,
                                    int* idx, void* stream) {
  if (n <= 0) return 0;
  if (split < 1 || split > K2_WARPS || K2_WARPS % split != 0 || kk < 1 ||
      kk > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kk) {
#define DCREG_KK(K)                                                        \
  case K:                                                                  \
    return launch_candidates<1, K>(query, n, tgt, pen, m, kk, split, val, \
                                   idx, s);
    DCREG_KK(1) DCREG_KK(2) DCREG_KK(3) DCREG_KK(4) DCREG_KK(5) DCREG_KK(6)
    DCREG_KK(7) DCREG_KK(8) DCREG_KK(9) DCREG_KK(10) DCREG_KK(11)
    DCREG_KK(12) DCREG_KK(13) DCREG_KK(14) DCREG_KK(15) DCREG_KK(16)
    DCREG_KK(17) DCREG_KK(18) DCREG_KK(19) DCREG_KK(20) DCREG_KK(21)
    DCREG_KK(22) DCREG_KK(23) DCREG_KK(24) DCREG_KK(25) DCREG_KK(26)
    DCREG_KK(27) DCREG_KK(28) DCREG_KK(29) DCREG_KK(30) DCREG_KK(31)
    DCREG_KK(32)
#undef DCREG_KK
    default:
      break;
  }
  if (kk <= 64)
    return launch_candidates<2, 0>(query, n, tgt, pen, m, kk, split, val,
                                   idx, s);
  return launch_candidates<4, 0>(query, n, tgt, pen, m, kk, split, val, idx,
                                 s);
}

// Launches K3 on `stream`; returns cudaGetLastError() (0 on success).
// query (n, 3), tgt (m, 3), pen (m,) f32; out (ceil(m / 128), n) f32;
// chunks of gpc >= 1 groups, ceil(ceil(m / 128) / gpc) of them.
extern "C" int dcreg_knn_group_min(const float* query, int n,
                                   const float* tgt, const float* pen, int m,
                                   int gpc, float* out, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  if (gpc < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int ng = (m + GROUP - 1) / GROUP;
  const dim3 grid((n + GQ - 1) / GQ, (ng + gpc - 1) / gpc);
  group_min_kernel<<<grid, GQ, 0, static_cast<cudaStream_t>(stream)>>>(
      query, n, tgt, pen, m, gpc, out);
  return static_cast<int>(cudaGetLastError());
}
