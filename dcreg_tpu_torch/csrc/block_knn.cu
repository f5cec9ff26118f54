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
// Design on Hopper.  The TPU carries the running state of one query block
// (B x 8 x 128 int32, 512 KB at B = 128) in VMEM across sequential grid
// steps; an SM has 227 KB of shared memory and blocks run in no order.
// So one CTA owns one (query block, chunk of LC lanes): each of its 128
// threads owns one query point and keeps the chunk's 5-key lists in
// registers, and the CTA loops over its query block's run of pairs
// (run_start, from torch.searchsorted over qid) with each 128-point
// target block staged in shared memory.  Nothing carries across CTAs, so
// the TPU's sequential `first` reset has no counterpart.  A pair with no
// live lane in the chunk (lane-mask bits all 0) skips its target load --
// the counterpart of the TPU's sentinel-block DMA skip.  Every output row
// of every query block is written (INIT_KEY where no candidate), so the
// output needs no separate initialisation.
//
// Bit-exact keys: the float operations are pinned with __fmul_rn /
// __fadd_rn / __fsub_rn in the JAX kernel's order (and the library is
// built with --fmad=false), and the float->int conversion truncates
// toward zero like .astype(int32).  The plain PyTorch twin in
// ops/block_knn.py therefore produces identical keys on the card.
//
// What bounds it: f32/int32 ALU work on the CUDA cores (about 10 float
// and 5 integer operations per candidate, 128 x 128 candidates per live
// (pair, lane)); tensor cores do not apply and the bytes moved are small.
// This first version is simple, not fast: at B = 1 in the map loop there
// are only about 40 CTAs (one per query block) for 132 SMs, and no
// software pipelining of the target loads.  Making it fast is later work.
#include <cuda_runtime.h>

namespace {

constexpr int TB = 128;   // target block size
constexpr int QB = 128;   // query block size == threads per CTA
constexpr int KP = 8;     // output rows per lane (K live + padding)
constexpr int K = 5;      // neighbours kept
constexpr int LC = 8;     // lanes per CTA
constexpr int INIT_KEY = 0x7FFFFFFF;

__global__ void __launch_bounds__(QB)
block_knn_keys_kernel(const int* __restrict__ run_start,
                      const int* __restrict__ tid,
                      const int* __restrict__ pid,
                      const int* __restrict__ mask, int n_words,
                      const float* __restrict__ src,
                      const float* __restrict__ tgt,
                      const float* __restrict__ poses,
                      int* __restrict__ out, int B, int index_bits,
                      float scale, float clamp) {
  const int q = blockIdx.x;
  const int base = blockIdx.y * LC;
  const int t = threadIdx.x;
  const int nlanes = min(LC, B - base);
  const unsigned all_lanes = (1u << nlanes) - 1u;

  __shared__ float s_tgt[3][TB];
  __shared__ float s_pose[LC][12];
  if (t < LC * 12) {
    const int l = t / 12, c = t % 12;
    s_pose[l][c] = (l < nlanes) ? poses[(base + l) * 12 + c] : 0.0f;
  }
  const float sx = src[(q * 3 + 0) * QB + t];
  const float sy = src[(q * 3 + 1) * QB + t];
  const float sz = src[(q * 3 + 2) * QB + t];
  __syncthreads();

  // world-frame query point of each lane: ((r0 sx + r1 sy) + r2 sz) + t
  float qw[LC][3];
  int key[LC][K];
#pragma unroll
  for (int l = 0; l < LC; ++l) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* P = s_pose[l];
      qw[l][c] = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(P[3 * c + 0], sx),
                              __fmul_rn(P[3 * c + 1], sy)),
                    __fmul_rn(P[3 * c + 2], sz)),
          P[9 + c]);
    }
#pragma unroll
    for (int r = 0; r < K; ++r) key[l][r] = INIT_KEY;
  }

  const int p_end = run_start[q + 1];
  for (int p = run_start[q]; p < p_end; ++p) {
    unsigned live = all_lanes;
    if (mask != nullptr) {
      const unsigned w = static_cast<unsigned>(mask[p * n_words + base / 32]);
      live = (w >> (base % 32)) & all_lanes;
    }
    if (live == 0u) continue;   // uniform across the CTA: skip the load
    const int tb = tid[p];
    const int id0 = pid[p] * TB;
    __syncthreads();            // the previous target block is consumed
    s_tgt[0][t] = tgt[(tb * 3 + 0) * TB + t];
    s_tgt[1][t] = tgt[(tb * 3 + 1) * TB + t];
    s_tgt[2][t] = tgt[(tb * 3 + 2) * TB + t];
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < TB; ++j) {
      const float tx = s_tgt[0][j], ty = s_tgt[1][j], tz = s_tgt[2][j];
      const int id = id0 + j;
#pragma unroll
      for (int l = 0; l < LC; ++l) {
        if (!(live & (1u << l))) continue;
        const float dx = __fsub_rn(tx, qw[l][0]);
        const float dy = __fsub_rn(ty, qw[l][1]);
        const float dz = __fsub_rn(tz, qw[l][2]);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                            __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        const int dq = __float2int_rz(__fmul_rn(fminf(d, clamp), scale));
        const int k = (dq << index_bits) | id;
        if (k < key[l][K - 1]) {
          // replace the largest, then one compare-exchange pass down
          key[l][K - 1] = k;
#pragma unroll
          for (int r = K - 1; r > 0; --r) {
            const int a = key[l][r - 1], b = key[l][r];
            key[l][r - 1] = min(a, b);
            key[l][r] = max(a, b);
          }
        }
      }
    }
  }

#pragma unroll
  for (int l = 0; l < LC; ++l) {
    if (l >= nlanes) break;
    int* o = out + (static_cast<long long>(q) * B + base + l) * KP * QB + t;
#pragma unroll
    for (int r = 0; r < KP; ++r) o[r * QB] = (r < K) ? key[l][r] : INIT_KEY;
  }
}

}  // namespace

// Launches K1 on `stream`; returns cudaGetLastError() (0 on success).
// run_start (nq + 1,) int32: pair run of query block q is
// [run_start[q], run_start[q + 1]); tid/pid (P,) int32; mask (P * n_words,)
// int32 lane bit words or null; src (nq, 3, 128) f32; tgt (nbt + 1, 3, 128)
// f32; poses (B, 12) f32; out (nq, B, 8, 128) int32.
extern "C" int dcreg_block_knn_keys(const int* run_start, const int* tid,
                                    const int* pid, const int* mask,
                                    int n_words, const float* src,
                                    const float* tgt, const float* poses,
                                    int* out, int nq, int B, int index_bits,
                                    float scale, float clamp, void* stream) {
  if (nq <= 0 || B <= 0) return 0;
  const dim3 grid(nq, (B + LC - 1) / LC);
  block_knn_keys_kernel<<<grid, QB, 0, static_cast<cudaStream_t>(stream)>>>(
      run_start, tid, pid, mask, n_words, src, tgt, poses, out, B,
      index_bits, scale, clamp);
  return static_cast<int>(cudaGetLastError());
}
