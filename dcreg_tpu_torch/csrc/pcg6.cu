// pcg6: the fast PRECONDITIONED_CG solve of a batch of 6x6 Gauss-Newton
// systems, the body of ops/solvers.solve_pcg_fast on the card.
//
// Replaces no TPU kernel: the JAX package leaves this function
// (dcreg_tpu/ops/solvers.py, solve_pcg_fast) to XLA, which fuses it.  Its
// plain PyTorch form (ops/solvers.solve_pcg_fast_plain) is 637 tiny
// kernels, each a launch and a node of the map loop's step graph, for
// every ICP iteration: the targeted preconditioner, 10 masked PCG trips,
// the unrolled Cholesky solve and the selection between them.  Here one
// thread takes one system through all of it in registers and writes each
// output once.
//
// What bounds it: the dependency chain, not bytes or operations.  A
// system reads 266 bytes (H 144, g 24, the two Schur spectra 24, their
// eigenbases 72, two flags 2) and writes 324 (x 24, P 144, W 144, the
// iteration count, residual and cond 12): 590 bytes in float32.  It
// computes 122 float operations for P, 169 for the Cholesky solve and,
// where PCG runs, 91 to start it and 204 per trip (two 6x6 mat-vecs,
// three dots, four axpys, a norm): 2,422 at the 10-trip cap.  At B = 1
// that is under a nanosecond of the card's bandwidth or float rate, while
// a trip is a chain of dependent multiplies, adds, two divisions and a
// square root, each waiting on the one before.  So one thread per system
// with its 6x6 H and P in registers (no shared memory, no barrier), and
// 32 threads per CTA, so that a batch of 128 systems spreads over four
// SMs; where a system's answer comes from Cholesky the PCG trips are
// skipped, and a system that converges leaves the trip loop.
//
// Numbers against the plain twin on the card (built with --fmad=false,
// every operation correctly rounded, in the twin's order):
// * the Cholesky branch repeats the twin's separate mul, sub, sqrt,
//   reciprocal and divisions, so its x is bit-equal;
// * P and the PCG branch sum each product in index order, where the
//   twin's matrix products and sums go through cuBLAS and reduction
//   kernels of unfixed order: they agree to float32 rounding;
// * constants compare in the working type (1e-30 as a float), kappa
//   divides as the twin's division by a host scalar does on the card
//   (a multiply by its reciprocal), maximum and clamp propagate NaN as
//   torch.maximum and torch.clamp do;
// * after a system converges the twin keeps adding 0 * p to x, which
//   changes x only where p is not finite: applied once on leaving the
//   loop early, it does the same.
// Every output element is written, so the wrapper allocates with empty.
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int N = 6;
constexpr int THREADS = 32;
constexpr float TINY = 1e-30f;

// Element strides of the operands, each viewed with one leading batch
// dimension: system b's H(i, j) is H[b * H[0] + i * H[1] + j * H[2]].
struct Strides {
  long long H[3], g[2], lam_rot[2], lam_trans[2], V_rot[3], V_trans[3];
  long long valid, degen;
};
constexpr int NUM_STRIDES = sizeof(Strides) / sizeof(long long);

// torch.maximum: NaN where either operand is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

// One 3x3 block of the targeted preconditioner,
// V diag(1 / max(lam, lam_max / kappa)) V^T, into P at (o, o).
// Returns whether every entry is finite.
__device__ __forceinline__ bool precond_block(const float* lam, long long sl,
                                              const float* V, long long sr,
                                              long long sc, float inv_kappa,
                                              float (&P)[N][N], int o) {
  const float floor_ = lam[2 * sl] * inv_kappa;
  float inv[3], A[3][3], v[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) inv[k] = 1.0f / nan_max(lam[k * sl], floor_);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v[i][k] = V[i * sr + k * sc];
      A[i][k] = v[i][k] * inv[k];
    }
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float s = A[i][0] * v[j][0];
      s = s + A[i][1] * v[j][1];
      s = s + A[i][2] * v[j][2];
      P[o + i][o + j] = s;
      ok = ok && isfinite(s);
    }
  return ok;
}

__device__ __forceinline__ void matvec(const float (&A)[N][N],
                                       const float (&u)[N], float (&out)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = A[i][0] * u[0];
#pragma unroll
    for (int j = 1; j < N; ++j) s = s + A[i][j] * u[j];
    out[i] = s;
  }
}

__device__ __forceinline__ float dot(const float (&a)[N],
                                     const float (&b)[N]) {
  float s = a[0] * b[0];
#pragma unroll
  for (int i = 1; i < N; ++i) s = s + a[i] * b[i];
  return s;
}

__device__ __forceinline__ float norm(const float (&a)[N]) {
  return sqrtf(dot(a, a));
}

__global__ void __launch_bounds__(THREADS)
pcg6_kernel(const float* __restrict__ H_, const float* __restrict__ g_,
            const float* __restrict__ lam_rot,
            const float* __restrict__ lam_trans,
            const float* __restrict__ V_rot, const float* __restrict__ V_trans,
            const unsigned char* __restrict__ valid,
            const unsigned char* __restrict__ degen, const Strides st,
            float* __restrict__ x_out, float* __restrict__ P_out,
            float* __restrict__ W_out, int* __restrict__ iters_out,
            float* __restrict__ resid_out, float* __restrict__ cond_out,
            int nb, int max_iter, float tol, float inv_kappa) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= nb) return;
  const float nan = __int_as_float(0x7fc00000);
  float H[N][N], g[N];
  {
    const float* h = H_ + b * st.H[0];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) H[i][j] = h[i * st.H[1] + j * st.H[2]];
#pragma unroll
    for (int i = 0; i < N; ++i) g[i] = g_[b * st.g[0] + i * st.g[1]];
  }

  // targeted preconditioner; the identity where the Schur complement was
  // not computable or an entry is not finite
  float P[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) P[i][j] = 0.0f;
  const bool rot_ok = precond_block(
      lam_rot + b * st.lam_rot[0], st.lam_rot[1], V_rot + b * st.V_rot[0],
      st.V_rot[1], st.V_rot[2], inv_kappa, P, 0);
  const bool trans_ok = precond_block(
      lam_trans + b * st.lam_trans[0], st.lam_trans[1],
      V_trans + b * st.V_trans[0], st.V_trans[1], st.V_trans[2], inv_kappa,
      P, 3);
  if (!(valid[b * st.valid] && rot_ok && trans_ok)) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) P[i][j] = i == j ? 1.0f : 0.0f;
  }

  // unrolled Cholesky, as linalg.cholesky_solve_6x6
  float L[N][N];
  bool chol_ok = true;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = H[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    const bool pos = s > TINY;
    chol_ok = chol_ok && pos;
    const float d = sqrtf(pos ? s : 1.0f);
    L[j][j] = d;
    const float inv_d = 1.0f / d;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      float t = H[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      L[i][j] = t * inv_d;
    }
  }

  float x[N];
  int iters = -1;
  float resid = nan;
  if (chol_ok && !degen[b * st.degen]) {
    float y[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = g[i];
#pragma unroll
      for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
      y[i] = s / L[i][i];
    }
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
      float s = y[i];
#pragma unroll
      for (int k = i + 1; k < N; ++k) s = s - L[k][i] * x[k];
      x[i] = s / L[i][i];
    }
  } else {
    // solvers.pcg_unrolled: trips until |r| <= tol * |g| or a zero
    // curvature, at most max_iter
    float r[N], z[N], p[N], Hp[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      x[i] = 0.0f;
      r[i] = g[i];
    }
    matvec(P, r, z);
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = z[i];
    float rz = dot(r, z);
    const float gn = norm(g);
    const float thresh = tol * (gn < TINY ? TINY : gn);
    iters = 0;
    bool done = false;
    while (iters < max_iter && !done) {
      matvec(H, p, Hp);
      const float pHp = dot(p, Hp);
      const bool safe = fabsf(pHp) > TINY;
      const float alpha = safe ? rz / pHp : 0.0f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        x[i] = x[i] + alpha * p[i];
        r[i] = r[i] - alpha * Hp[i];
      }
      matvec(P, r, z);
      const float rz_new = dot(r, z);
      const float beta = fabsf(rz) > TINY ? rz_new / rz : 0.0f;
#pragma unroll
      for (int i = 0; i < N; ++i) p[i] = z[i] + beta * p[i];
      rz = rz_new;
      done = norm(r) <= thresh || !safe;
      ++iters;
    }
    if (iters < max_iter) {
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = x[i] + 0.0f * p[i];
    }
    resid = norm(r);
  }

#pragma unroll
  for (int i = 0; i < N; ++i) x_out[b * N + i] = x[i];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      P_out[(b * N + i) * N + j] = P[i][j];
      W_out[(b * N + i) * N + j] = 0.0f;
    }
  iters_out[b] = iters;
  resid_out[b] = resid;
  cond_out[b] = nan;
}

}  // namespace

// strides: NUM_STRIDES element strides in the order of Strides; kappa
// divides as 1 / kappa rounded to float, as the twin's division of a
// float32 tensor by a host scalar does on the card.  Returns a
// cudaError_t.
extern "C" int dcreg_pcg6(const float* H, const float* g,
                          const float* lam_rot, const float* lam_trans,
                          const float* V_rot, const float* V_trans,
                          const unsigned char* valid,
                          const unsigned char* degen,
                          const long long* strides, int num_strides,
                          float* x, float* P, float* W, int* iters,
                          float* resid, float* cond, int nb, int max_iter,
                          float tol, float kappa, void* stream) {
  if (num_strides != NUM_STRIDES || nb < 0 || max_iter < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0) return 0;
  Strides st;
  std::memcpy(&st, strides, sizeof(Strides));
  pcg6_kernel<<<(nb + THREADS - 1) / THREADS, THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(
      H, g, lam_rot, lam_trans, V_rot, V_trans, valid, degen, st, x, P, W,
      iters, resid, cond, nb, max_iter, tol, 1.0f / kappa);
  return static_cast<int>(cudaGetLastError());
}
