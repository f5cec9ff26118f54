// schur6: the fast Schur-complement degeneracy analysis of a batch of 6x6
// Gauss-Newton systems, the body of ops/degeneracy.analyze(fast=True) on
// the card.
//
// Replaces no TPU kernel: the JAX package leaves this function
// (dcreg_tpu/ops/degeneracy.py, analyze) to XLA, which fuses it.  Its
// plain PyTorch form (ops/degeneracy.analyze_fast_plain) is 298 tiny
// kernels, each a launch and a node of the map loop's step graph, for
// every ICP iteration and again in every frame's epilogue: the two
// closed-form 3x3 inverses and their scale test, the two Schur complements,
// the closed-form 3x3 eigensolve of H_RR, H_tt and both complements, the
// condition numbers and the detection mask.  Here one thread takes one
// system through all of it in registers and writes each output once.
//
// What bounds it: latency, not bytes or operations.  A system reads its
// 6x6 H (36 floats, 144 bytes) and writes 85 floats and 8 flags (348
// bytes), of which 51 are the fast path's constants (the 6x6 spectrum's
// NaN fields and cond_full's inf).  It computes about 920 float
// operations (two inverses 84, their scales 44, four 3x3 products 180,
// four symmetric parts and eigenvalue solves 4 x 64, two eigenvector
// solves 2 x 160, the rest 36), counting a square root, a division, acos
// or cos as one.  At B = 1 that is well
// under a nanosecond of the card's bandwidth or float rate, while each
// thread's work is a chain of dependent divisions, square roots and
// transcendentals.  So one thread per system with H in registers (no
// shared memory, no barrier), 32 threads per CTA, so that a batch of 128
// systems spreads over four SMs; the grid is ceil(nb / 32) for every
// caller.
//
// Numbers against the plain twin on the card (built with --fmad=false,
// every operation correctly rounded, in the twin's order):
// * an elementwise expression of the twin is a chain of ATen kernels, one
//   rounding each, so the kernel rounds after every operation the same way;
// * a division by a host scalar (3, 6) is a multiply by its float
//   reciprocal, as ATen's division of a tensor by a CPU scalar runs;
//   1 / x is the correctly rounded reciprocal (Tensor.__rtruediv__);
// * constants compare and clamp in float, as ATen casts a scalar operand
//   to the tensor's type: 1e-60 is 0 in float;
// * clamp propagates NaN as ATen's kernel does, amax propagates NaN,
//   argmin takes the first NaN or else the first least entry, and a
//   select stands wherever the twin uses torch.where, so NaN and Inf
//   patterns match;
// * where one ATen kernel computes several operations, the kernel repeats
//   the order and the fused multiply-adds that kernel was found to take on
//   the card (torch 2.11 with CUDA 12.8 on an H100, every candidate order
//   held against ATen's results bit for bit):
//   - torch.sum over a 3-vector (ATen's reduction splits the row over two
//     threads, terms 0 and 2 in one, term 1 in the other, each from +0):
//     ((e0 + e2) + e1) + 0, so a sum of zeros is +0;
//   - torch.linalg.norm over a 3-vector: sqrt((s0 + s2) + s1) of the
//     rounded squares;
//   - torch.linalg.cross: a b - c d as fma(a, b, -(c d));
//   - x ** 3: (x x) x;
//   - a 3x3 matrix product (cuBLAS): one system alone, (3, 3) or
//     (1, 3, 3), takes a kernel that sums fma(x1, y1, x0 y0) + x2 y2; a
//     batch of two or more an ascending chain of fused multiply-adds from
//     0.  The kernel takes the order by the batch it is given.  At a batch
//     of exactly 65,536 cuBLAS took yet another order for some entries
//     (no caller analyses such a batch).
// Every output element is written, so the wrapper allocates with empty.
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int THREADS = 32;

// Element strides of H viewed with one leading batch dimension: system
// b's H(i, j) is H[b * H[0] + i * H[1] + j * H[2]].
struct Strides {
  long long H[3];
};
constexpr int NUM_STRIDES = sizeof(Strides) / sizeof(long long);

// The outputs, each a contiguous (nb, size) block of one float buffer in
// DegeneracyAnalysis' order of fields; offsets in units of nb floats.
constexpr int W_FULL = 0, V_FULL = 6, SV = 42, COND_FULL = 48,
              COND_SUB_ROT = 49, COND_SUB_TRANS = 50, W_DIAG_ROT = 51,
              W_DIAG_TRANS = 54, COND_DIAG_ROT = 57, COND_DIAG_TRANS = 58,
              W_SCHUR_ROT = 59, W_SCHUR_TRANS = 62, V_SCHUR_ROT = 65,
              V_SCHUR_TRANS = 74, COND_SCHUR_ROT = 83, COND_SCHUR_TRANS = 84;
// and of the bool buffer: schur_valid, is_degenerate, degenerate_mask
constexpr int VALID = 0, DEGEN = 1, MASK = 2;

// the twin's constants in float, as ATen casts them
constexpr float INV3 = 1.0f / 3.0f;
constexpr float INV6 = 1.0f / 6.0f;
constexpr float TWO_THIRDS_PI = static_cast<float>(2.0943951023931953);
constexpr float TINY = static_cast<float>(1e-30);
// 1e-60 rounds to 0 in float, so the twin compares with 0
constexpr float TINY2 = 0.0f;
constexpr float EPS = static_cast<float>(1e-12);
constexpr float DET_REL_EPS = static_cast<float>(1e-10);

// torch.clamp(v, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// torch.clamp(v, lo, hi)
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.amax: NaN where any entry is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// torch.sum(u * v, dim=-1) of 3-vectors
__device__ __forceinline__ float vdot(const float (&u)[3],
                                      const float (&v)[3]) {
  return ((u[0] * v[0] + u[2] * v[2]) + u[1] * v[1]) + 0.0f;
}

// torch.linalg.norm(u, dim=-1) of a 3-vector
__device__ __forceinline__ float norm3(const float (&u)[3]) {
  return sqrtf((u[0] * u[0] + u[2] * u[2]) + u[1] * u[1]);
}

// torch.linalg.cross
__device__ __forceinline__ void cross(const float (&a)[3],
                                      const float (&b)[3], float (&c)[3]) {
  c[0] = __fmaf_rn(a[1], b[2], -(a[2] * b[1]));
  c[1] = __fmaf_rn(a[2], b[0], -(a[0] * b[2]));
  c[2] = __fmaf_rn(a[0], b[1], -(a[1] * b[0]));
}

// C = A B of 3x3 matrices in cuBLAS's order for a batch of one system
// (single) or of more
__device__ __forceinline__ void matmul3(const float (&A)[3][3],
                                        const float (&B)[3][3],
                                        float (&C)[3][3], bool single) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float* x = A[i];
      const float y0 = B[0][j], y1 = B[1][j], y2 = B[2][j];
      C[i][j] = single
          ? __fmaf_rn(x[1], y1, x[0] * y0) + x[2] * y2
          : __fmaf_rn(x[2], y2, __fmaf_rn(x[1], y1, __fmaf_rn(x[0], y0,
                                                              0.0f)));
    }
}

// linalg.inv_3x3: the adjugate over the determinant
__device__ __forceinline__ float inv3(const float (&A)[3][3],
                                      float (&inv)[3][3]) {
  const float a = A[0][0], b = A[0][1], c = A[0][2];
  const float d = A[1][0], e = A[1][1], f = A[1][2];
  const float g = A[2][0], h = A[2][1], i = A[2][2];
  const float adj[3][3] = {{e * i - f * h, c * h - b * i, b * f - c * e},
                           {f * g - d * i, a * i - c * g, c * d - a * f},
                           {d * h - e * g, b * g - a * h, a * e - b * d}};
  const float det = (a * adj[0][0] + b * adj[1][0]) + c * adj[2][0];
  const float r = 1.0f / det;
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int q = 0; q < 3; ++q) inv[p][q] = adj[p][q] * r;
  return det;
}

// amax(|A|) ** 3 + 1e-12, the scale of the invertibility test
__device__ __forceinline__ float scale3(const float (&A)[3][3]) {
  float m = fabsf(A[0][0]);
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int q = 0; q < 3; ++q) m = nan_max(m, fabsf(A[p][q]));
  return (m * m) * m + EPS;
}

// The symmetric part of A, 0.5 (A + A^T), as linalg.eigh3_closed takes it
struct Sym3 {
  float a00, a01, a02, a11, a12, a22;
};

__device__ __forceinline__ Sym3 sym_part(const float (&A)[3][3]) {
  Sym3 s;
  s.a00 = 0.5f * (A[0][0] + A[0][0]);
  s.a01 = 0.5f * (A[0][1] + A[1][0]);
  s.a02 = 0.5f * (A[0][2] + A[2][0]);
  s.a11 = 0.5f * (A[1][1] + A[1][1]);
  s.a12 = 0.5f * (A[1][2] + A[2][1]);
  s.a22 = 0.5f * (A[2][2] + A[2][2]);
  return s;
}

// eigh3_closed's trigonometric eigenvalues w0 <= w1 <= w2
__device__ __forceinline__ void eigvals3(const Sym3& s, float (&w)[3]) {
  const float q = ((s.a00 + s.a11) + s.a22) * INV3;
  const float b00 = s.a00 - q, b11 = s.a11 - q, b22 = s.a22 - q;
  const float p2 = (((b00 * b00 + b11 * b11) + b22 * b22)
                    + 2.0f * ((s.a01 * s.a01 + s.a02 * s.a02)
                              + s.a12 * s.a12)) * INV6;
  const float p = sqrtf(clamp_min(p2, 0.0f));
  const bool tiny = p <= TINY;
  const float p_safe = tiny ? 1.0f : p;
  const float detB = (b00 * (b11 * b22 - s.a12 * s.a12)
                      - s.a01 * (s.a01 * b22 - s.a12 * s.a02))
                     + s.a02 * (s.a01 * s.a12 - b11 * s.a02);
  const float r = clamp(detB / (((2.0f * p_safe) * p_safe) * p_safe), -1.0f,
                        1.0f);
  const float phi = acosf(r) * INV3;
  const float w2 = q + (2.0f * p) * cosf(phi);
  const float w0 = q + (2.0f * p) * cosf(phi + TWO_THIRDS_PI);
  const float w1 = ((3.0f * q) - w2) - w0;
  w[0] = tiny ? q : w0;
  w[1] = tiny ? q : w1;
  w[2] = tiny ? q : w2;
}

// eigh3_closed's best_null_vector: the unit null vector of A - lam I from
// the largest cross product of two of its rows; ok where that is not zero
__device__ __forceinline__ bool null_vector(const Sym3& s, float lam,
                                            float (&v)[3]) {
  const float r0[3] = {s.a00 - lam, s.a01, s.a02};
  const float r1[3] = {s.a01, s.a11 - lam, s.a12};
  const float r2[3] = {s.a02, s.a12, s.a22 - lam};
  float c01[3], c02[3], c12[3];
  cross(r0, r1, c01);
  cross(r0, r2, c02);
  cross(r1, r2, c12);
  const float n01 = vdot(c01, c01);
  const float n02 = vdot(c02, c02);
  const float n12 = vdot(c12, c12);
  const bool use01 = (n01 >= n02) && (n01 >= n12);
  const bool use02 = n02 >= n12;
  float c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) c[i] = use01 ? c01[i] : (use02 ? c02[i] : c12[i]);
  const float nrm2 = vdot(c, c);
  const bool ok = nrm2 > TINY2;
  const float den = sqrtf(ok ? nrm2 : 1.0f);
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = c[i] / den;
  return ok;
}

// eigh3_closed's eigenvectors: V[i][j] is entry i of eigenvector j
__device__ __forceinline__ void eigvecs3(const Sym3& s, const float (&w)[3],
                                         float (&V)[3][3]) {
  const bool hi_first = (w[2] - w[1]) >= (w[1] - w[0]);
  const float lam_a = hi_first ? w[2] : w[0];
  const float lam_b = hi_first ? w[0] : w[2];
  float va[3], vb[3];
  const bool ok_a = null_vector(s, lam_a, va);
  const bool ok_b = null_vector(s, lam_b, vb);
  if (!ok_a) {
    va[0] = 1.0f;
    va[1] = 0.0f;
    va[2] = 0.0f;
  }
  // argmin |va|: the first NaN, else the first least entry
  const float m0 = fabsf(va[0]), m1 = fabsf(va[1]), m2 = fabsf(va[2]);
  int least;
  if (isnan(m0)) {
    least = 0;
  } else if (isnan(m1)) {
    least = 1;
  } else if (isnan(m2)) {
    least = 2;
  } else {
    least = 0;
    if (m1 < m0) least = 1;
    if (m2 < (least == 0 ? m0 : m1)) least = 2;
  }
  const float alt[3] = {least == 0 ? 1.0f : 0.0f, least == 1 ? 1.0f : 0.0f,
                        least == 2 ? 1.0f : 0.0f};
  if (!ok_b) {
#pragma unroll
    for (int i = 0; i < 3; ++i) vb[i] = alt[i];
  }
  const float d = vdot(vb, va);
#pragma unroll
  for (int i = 0; i < 3; ++i) vb[i] = vb[i] - d * va[i];
  const float nb2 = vdot(vb, vb);
  const bool ok_nb = nb2 > TINY2;
  float cr[3];
  cross(va, alt, cr);
  const float den_b = sqrtf(ok_nb ? nb2 : 1.0f);
  const float den_c = clamp_min(norm3(cr), TINY);
#pragma unroll
  for (int i = 0; i < 3; ++i) vb[i] = ok_nb ? vb[i] / den_b : cr[i] / den_c;
  float vm[3];
  cross(va, vb, vm);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    V[i][0] = hi_first ? vb[i] : va[i];
    V[i][1] = vm[i];
    V[i][2] = hi_first ? va[i] : vb[i];
  }
}

// linalg.condition_number: w2 / max(w0, 1e-12)
__device__ __forceinline__ float cond3(const float (&w)[3]) {
  return w[2] / clamp_min(w[0], EPS);
}

// One Schur block's outputs: its spectrum, condition number and mask
// entries where the complement is computable, NaN, inf and false where it
// is not; returns whether the block is degenerate (cond above ct)
__device__ __forceinline__ bool schur_block(const float (&S)[3][3],
                                            bool valid, float ct,
                                            float* w_out, float* V_out,
                                            float* cond_out, bool* mask_out) {
  const float nan = __int_as_float(0x7fc00000);
  const float inf = __int_as_float(0x7f800000);
  const Sym3 s = sym_part(S);
  float w[3], V[3][3];
  eigvals3(s, w);
  eigvecs3(s, w, V);
  const float cond = valid ? cond3(w) : inf;
  const bool bad = cond > ct;
#pragma unroll
  for (int i = 0; i < 3; ++i) w[i] = valid ? w[i] : nan;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    w_out[i] = w[i];
    mask_out[i] = bad && (w[2] / clamp_min(w[i], EPS) > ct);
#pragma unroll
    for (int j = 0; j < 3; ++j) V_out[3 * i + j] = V[i][j];
  }
  *cond_out = cond;
  return bad;
}

__global__ void __launch_bounds__(THREADS)
schur6_kernel(const float* __restrict__ H_, const Strides st,
              float* __restrict__ out, bool* __restrict__ flags, int nb,
              float ct) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= nb) return;
  const float nan = __int_as_float(0x7fc00000);
  const float inf = __int_as_float(0x7f800000);
  // field f's entry e of system b
  auto at = [&](int f, int size, int e) -> float& {
    return out[static_cast<long long>(f) * nb
               + static_cast<long long>(b) * size + e];
  };

  float RR[3][3], tt[3][3], Rt[3][3], tR[3][3];
  {
    const float* h = H_ + b * st.H[0];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        RR[i][j] = h[i * st.H[1] + j * st.H[2]];
        Rt[i][j] = h[i * st.H[1] + (j + 3) * st.H[2]];
        tR[i][j] = h[(i + 3) * st.H[1] + j * st.H[2]];
        tt[i][j] = h[(i + 3) * st.H[1] + (j + 3) * st.H[2]];
      }
  }

  // the fast path's constants: no 6x6 spectrum
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    at(W_FULL, 6, i) = nan;
    at(SV, 6, i) = nan;
  }
#pragma unroll
  for (int i = 0; i < 36; ++i) at(V_FULL, 36, i) = nan;
  at(COND_FULL, 1, 0) = inf;
  at(COND_SUB_ROT, 1, 0) = nan;
  at(COND_SUB_TRANS, 1, 0) = nan;

  // the diagonal blocks' spectra
  {
    float w[3];
    eigvals3(sym_part(RR), w);
#pragma unroll
    for (int i = 0; i < 3; ++i) at(W_DIAG_ROT, 3, i) = w[i];
    at(COND_DIAG_ROT, 1, 0) = cond3(w);
    eigvals3(sym_part(tt), w);
#pragma unroll
    for (int i = 0; i < 3; ++i) at(W_DIAG_TRANS, 3, i) = w[i];
    at(COND_DIAG_TRANS, 1, 0) = cond3(w);
  }

  // the inverses, the scale test and the Schur complements
  float inv_tt[3][3], inv_rr[3][3];
  const float det_tt = inv3(tt, inv_tt);
  const float det_rr = inv3(RR, inv_rr);
  const bool valid = (fabsf(det_tt) > scale3(tt) * DET_REL_EPS)
                     && (fabsf(det_rr) > scale3(RR) * DET_REL_EPS);
  float S_R[3][3], S_t[3][3];
  {
    const bool single = nb == 1;
    float P[3][3], Q[3][3];
    matmul3(Rt, inv_tt, P, single);
    matmul3(P, tR, Q, single);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) S_R[i][j] = RR[i][j] - Q[i][j];
    matmul3(tR, inv_rr, P, single);
    matmul3(P, Rt, Q, single);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) S_t[i][j] = tt[i][j] - Q[i][j];
  }

  bool mask[6];
  const bool rot_bad = schur_block(
      S_R, valid, ct, &at(W_SCHUR_ROT, 3, 0), &at(V_SCHUR_ROT, 9, 0),
      &at(COND_SCHUR_ROT, 1, 0), mask);
  const bool trans_bad = schur_block(
      S_t, valid, ct, &at(W_SCHUR_TRANS, 3, 0), &at(V_SCHUR_TRANS, 9, 0),
      &at(COND_SCHUR_TRANS, 1, 0), mask + 3);
  flags[VALID * nb + b] = valid;
  flags[DEGEN * nb + b] = rot_bad || trans_bad;
#pragma unroll
  for (int i = 0; i < 6; ++i) flags[MASK * nb + 6 * b + i] = mask[i];
}

}  // namespace

// strides: NUM_STRIDES element strides in the order of Strides; out: a
// float buffer of 85 nb, flags a bool buffer of 8 nb, each the fields'
// contiguous (nb, size) blocks in DegeneracyAnalysis' order; ct the
// detection's condition threshold in float.  Returns a cudaError_t.
extern "C" int dcreg_schur6(const float* H, const long long* strides,
                            int num_strides, float* out, bool* flags, int nb,
                            float ct, void* stream) {
  if (num_strides != NUM_STRIDES || nb < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0) return 0;
  Strides st;
  std::memcpy(&st, strides, sizeof(Strides));
  schur6_kernel<<<(nb + THREADS - 1) / THREADS, THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(H, st, out, flags, nb,
                                                       ct);
  return static_cast<int>(cudaGetLastError());
}
