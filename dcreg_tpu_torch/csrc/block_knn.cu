// K1: batched ragged block-sparse 5-NN keys for one ICP iteration.
//
// Replaces the Pallas TPU kernel dcreg_tpu/ops/pallas_block_knn.py
// `_kernel` (launched by `batched_block_knn`).  For every (query block,
// target block) pair of a qid-sorted ragged list and every pose lane, it
// transforms the 128 source points of the query block by the lane's
// (R, t), takes coordinate-wise squared distances to the 128 points of
// the target block, packs each candidate into one int32 key
//   int(min(d, clamp) * scale) << index_bits | (pid * 128 + row)
// and keeps the lane's running 5 smallest keys per query point.
//
// What bounds it on Hopper: f32 ALU work on the CUDA cores, 10 float
// operations per live candidate (128 x 128 per live (pair, lane)); tensor
// cores do not apply and the bytes moved are small.  With --fmad=false no
// FMA is issued, so about twice the f32 peak's time is its floor.  What
// kept the first version far above that, and what this one does:
//
// 1. Parallelism.  The TPU carries a query block's running state
//    (B x 8 x 128 int32, 512 KB at B = 128) in VMEM across sequential grid
//    steps.  Here a CTA owns (query block q, split s, lane b): its 128
//    threads each own one query point and keep the lane's 5-key list in
//    registers (34 registers, so 16 CTAs share an SM and that occupancy
//    hides the latency of the divergent insertions), and the CTA walks
//    pairs
//      [run_start[q] + s*len/nsplit, run_start[q] + (s+1)*len/nsplit)
//    of q's run (len = run_start[q+1] - run_start[q]).  At B = 1 a frame
//    has ~40 query blocks for 132 SMs, so the wrapper splits every run
//    into nsplit pieces (a function of the static shapes and the SM count
//    only) and the grid fills the card; at B = 128 the lanes already do.
//    One lane per CTA beat 8 lanes per CTA sharing each target load at
//    every measured shape, so no lane chunk is built.
// 2. Exact merge.  With nsplit > 1 each CTA writes its sorted 5-list to
//    a scratch tensor and a second kernel merges a point's nsplit lists
//    into 5.  Within a run every candidate key is unique (ids are
//    tid*128 + row or slot*128 + row, and a block or slot appears once
//    per run), so the merge is exact and independent of order.
// 3. Lane mask.  A pair whose bit is 0 for the CTA's lane is skipped
//    before its target load, the counterpart of the TPU's sentinel-block
//    DMA skip; the test is uniform across the CTA.
// 4. Float pre-test.  Almost every candidate cannot enter the top 5.
//    With dq4 = key[K-1] >> index_bits and thr = float(dq4 + 1) rounded
//    up, a scaled distance s >= thr gives trunc(s) > dq4, so its key
//    exceeds key[K-1]: it is skipped before the float->int conversion
//    (16 results per clock per SM on sm_90, against 128 float adds), the
//    shift and the or.  thr changes only when a key enters the list.
//    Each thread computes a tile of 8 scaled distances with no branch, so
//    the float chains interleave, and branches once per tile when any of
//    them passes.
//
// What still holds it above the floor: the insertions.  A query point's
// list takes about K ln(n / K) of n candidates that come in no particular
// order, at other times in each of a warp's 32 threads, so a warp walks
// the insertion branch far more often than any one thread needs it.
//
// Bit-exact keys: the float operations are pinned with __fmul_rn /
// __fadd_rn / __fsub_rn in the JAX kernel's order (and the library is
// built with --fmad=false), and the float->int conversion truncates
// toward zero like .astype(int32).  The plain PyTorch twin in
// ops/block_knn.py therefore produces identical keys on the card.  Every
// output row is written (INIT_KEY where a run or split has no
// candidate), so the output needs no separate initialisation.
#include <cuda_runtime.h>

namespace {

constexpr int TB = 128;   // target block size
constexpr int QB = 128;   // query block size == threads per CTA
constexpr int KP = 8;     // output rows per lane (K live + padding)
constexpr int K = 5;      // neighbours kept
constexpr int INIT_KEY = 0x7FFFFFFF;
constexpr int TILE = 8;   // scaled distances per thread between branches

// Insert k (< key[K-1]) into the ascending list: replace the largest,
// then one compare-exchange pass down.
__device__ __forceinline__ void insert_key(int (&key)[K], int k) {
  key[K - 1] = k;
#pragma unroll
  for (int r = K - 1; r > 0; --r) {
    const int a = key[r - 1], b = key[r];
    key[r - 1] = min(a, b);
    key[r] = max(a, b);
  }
}

// Least float >= (key >> index_bits) + 1: a scaled distance at or above
// it truncates to more than key's distance part.
__device__ __forceinline__ float key_threshold(int key, int index_bits) {
  return __int2float_ru((key >> index_bits) + 1);
}

__global__ void __launch_bounds__(QB)
block_knn_keys_kernel(const int* __restrict__ run_start,
                      const int* __restrict__ tid,
                      const int* __restrict__ pid,
                      const int* __restrict__ mask, int n_words,
                      const float* __restrict__ src,
                      const float* __restrict__ tgt,
                      const float* __restrict__ poses,
                      int* __restrict__ dst, int B, int nsplit,
                      int index_bits, float scale, float clamp) {
  const int q = blockIdx.x;
  const int s = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x;

  __shared__ float4 s_tgt[TB];
  __shared__ float s_pose[12];
  if (t < 12) s_pose[t] = poses[b * 12 + t];
  const float sx = src[(q * 3 + 0) * QB + t];
  const float sy = src[(q * 3 + 1) * QB + t];
  const float sz = src[(q * 3 + 2) * QB + t];
  __syncthreads();

  // world-frame query point: ((r0 sx + r1 sy) + r2 sz) + t
  float qw[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    qw[c] = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(s_pose[3 * c + 0], sx),
                            __fmul_rn(s_pose[3 * c + 1], sy)),
                  __fmul_rn(s_pose[3 * c + 2], sz)),
        s_pose[9 + c]);
  int key[K];
#pragma unroll
  for (int r = 0; r < K; ++r) key[r] = INIT_KEY;
  float thr = key_threshold(INIT_KEY, index_bits);

  // this split's share of the query block's run of pairs
  const int r0 = run_start[q];
  const int len = run_start[q + 1] - r0;
  const int p_end = r0 + static_cast<int>(
      static_cast<long long>(s + 1) * len / nsplit);
  for (int p = r0 + static_cast<int>(static_cast<long long>(s) * len /
                                     nsplit);
       p < p_end; ++p) {
    // uniform across the CTA: a pair without this lane's bit skips the load
    if (mask != nullptr && !((mask[p * n_words + b / 32] >> (b % 32)) & 1))
      continue;
    const int tb = tid[p];
    const int id0 = pid[p] * TB;
    __syncthreads();            // the previous target block is consumed
    s_tgt[t] = make_float4(tgt[(tb * 3 + 0) * TB + t],
                           tgt[(tb * 3 + 1) * TB + t],
                           tgt[(tb * 3 + 2) * TB + t], 0.0f);
    __syncthreads();
    // TILE scaled distances at a time, with no branch, then one branch
    // for the rare candidate that can enter
#pragma unroll 2
    for (int j0 = 0; j0 < TB; j0 += TILE) {
      float sc[TILE];
      bool hit = false;
#pragma unroll
      for (int jj = 0; jj < TILE; ++jj) {
        const float4 g = s_tgt[j0 + jj];
        const float dx = __fsub_rn(g.x, qw[0]);
        const float dy = __fsub_rn(g.y, qw[1]);
        const float dz = __fsub_rn(g.z, qw[2]);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                            __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        sc[jj] = __fmul_rn(fminf(d, clamp), scale);
        hit |= sc[jj] < thr;
      }
      if (!hit) continue;
#pragma unroll
      for (int jj = 0; jj < TILE; ++jj) {
        if (sc[jj] < thr) {
          const int k = (__float2int_rz(sc[jj]) << index_bits)
                        | (id0 + j0 + jj);
          if (k < key[K - 1]) {
            insert_key(key, k);
            thr = key_threshold(key[K - 1], index_bits);
          }
        }
      }
    }
  }

  if (nsplit == 1) {
    int* o = dst + (static_cast<long long>(q) * B + b) * KP * QB + t;
#pragma unroll
    for (int r = 0; r < KP; ++r) o[r * QB] = (r < K) ? key[r] : INIT_KEY;
  } else {
    int* o = dst + ((static_cast<long long>(q) * nsplit + s) * B + b)
                       * K * QB + t;
#pragma unroll
    for (int r = 0; r < K; ++r) o[r * QB] = key[r];
  }
}

// One thread per (query block, lane, query point): merge the nsplit
// ascending 5-lists of partial (nq, nsplit, B, K, QB) into out
// (nq, B, KP, QB).  A list is read only while its keys can still enter.
__global__ void __launch_bounds__(QB)
block_knn_merge_kernel(const int* __restrict__ partial,
                       int* __restrict__ out, int B, int nsplit) {
  const int q = blockIdx.x;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  int key[K];
#pragma unroll
  for (int r = 0; r < K; ++r) key[r] = INIT_KEY;
  for (int s = 0; s < nsplit; ++s) {
    const int* p = partial + ((static_cast<long long>(q) * nsplit + s) * B
                              + b) * K * QB + t;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int k = p[r * QB];
      if (k >= key[K - 1]) break;
      insert_key(key, k);
    }
  }
  int* o = out + (static_cast<long long>(q) * B + b) * KP * QB + t;
#pragma unroll
  for (int r = 0; r < KP; ++r) o[r * QB] = (r < K) ? key[r] : INIT_KEY;
}

}  // namespace

// Launches K1 on `stream`; returns cudaGetLastError() (0 on success).
// run_start (nq + 1,) int32: pair run of query block q is
// [run_start[q], run_start[q + 1]); tid/pid (P,) int32; mask (P * n_words,)
// int32 lane bit words or null; src (nq, 3, 128) f32; tgt (nbt + 1, 3, 128)
// f32; poses (B, 12) f32; out (nq, B, 8, 128) int32; nsplit >= 1 pieces
// per run; partial (nq, nsplit, B, 5, 128) int32 scratch when nsplit > 1
// (then the merge kernel follows), else unused.
extern "C" int dcreg_block_knn_keys(const int* run_start, const int* tid,
                                    const int* pid, const int* mask,
                                    int n_words, const float* src,
                                    const float* tgt, const float* poses,
                                    int* out, int* partial, int nq, int B,
                                    int nsplit, int index_bits, float scale,
                                    float clamp, void* stream) {
  if (nq <= 0 || B <= 0) return 0;
  if (nsplit < 1 || (nsplit > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  block_knn_keys_kernel<<<dim3(nq, nsplit, B), QB, 0, st>>>(
      run_start, tid, pid, mask, n_words, src, tgt, poses,
      nsplit > 1 ? partial : out, B, nsplit, index_bits, scale, clamp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  block_knn_merge_kernel<<<dim3(nq, B), QB, 0, st>>>(partial, out, B,
                                                     nsplit);
  return static_cast<int>(cudaGetLastError());
}
