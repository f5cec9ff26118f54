// plane_fit: the neighbours' plane fit of the correspondence tail, the body
// of ops/soa_tail._plane_fit on the card.
//
// Replaces no TPU kernel: the JAX package leaves this function
// (dcreg_tpu/ops/soa_tail.py, inside batched_tail_system) to XLA, which
// fuses it.  Its plain PyTorch form (ops/soa_tail._plane_fit_plain, with
// _eigh3_soa) is 444 small kernels, each a launch and a node of the map
// loop's step graph, for every ICP iteration.  Here one thread takes one
// (lane, point) through all of it in registers and writes each output
// once: it gathers the point's k neighbours from the target, forms their
// centroid and the six covariance sums, runs the closed-form 3x3
// eigensolve (trigonometric eigenvalues, cross-product null vectors, the
// same fallbacks), solves (S + k c c^T) x = -k c in the eigenbasis with the
// same rank handling, and applies the thickness gate.
//
// What bounds it: latency, not bytes or operations.  A point reads its k
// int32 neighbour ids and k gathered points (16 k bytes, 80 at k = 5) and
// writes the unit normal, the offset and two flags (18 bytes).  It
// computes about 25 k + 330 float operations (455 at k = 5), counting a
// square root, a division, acos or cos as one.  At 5,000 points that is
// about 0.15 us of the card's bandwidth, while each thread's work is a
// chain of dependent loads (the ids, then the points) and of dependent
// divisions, square roots and transcendentals.  So one thread per point,
// 64 threads per CTA, so that the map loop's 5,000 points spread over 79
// CTAs of the 132 SMs and a batch of 128 lanes over 10,000; the grid is
// ceil(B N / 64) for every caller.  The neighbours stay in registers: k is
// a run-time argument up to K_MAX and every loop over it is unrolled to
// K_MAX with a guard.
//
// Numbers against the plain twin on the card (built with --fmad=false,
// every operation correctly rounded, in the twin's order):
// * a sum over the k neighbours (torch.sum, torch.mean) adds them in the
//   order of ATen's reduction kernel for a reduced axis that is not the
//   fastest in memory: neighbour j into accumulator j mod 4, each started
//   at +0, then ((a0 + a1) + a2) + a3;
// * a mean is that sum times float(B N) / float(B k N), the factor ATen's
//   mean kernel scales by, computed by the host as float;
// * a division by a host scalar (3, 6, k) is a multiply by its float
//   reciprocal, as ATen's division of a tensor by a CPU scalar runs;
//   1 / x is the correctly rounded reciprocal (Tensor.__rtruediv__);
// * constants compare and clamp in float, as ATen casts a scalar operand
//   to the tensor's type: 1e-60 is 0 in float;
// * clamp, maximum and minimum propagate NaN as ATen's kernels do, and a
//   select stands wherever the twin uses torch.where, so NaN and Inf
//   patterns match;
// * the thickness gate, max_j pd_j^2 < t^2 with NaN propagating through
//   the max, is every pd_j^2 < t^2, which fails on a NaN as the max does.
// Every output element is written, so the wrapper allocates with empty.
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int THREADS = 64;
constexpr int K_MAX = 16;

// Element strides of the operands: point i's coordinate c is
// target[i * target[0] + c * target[1]]; the id of lane b's point n's
// j-th neighbour is idx[b * idx[0] + j * idx[1] + n * idx[2]].
struct Strides {
  long long target[2], idx[3];
};
constexpr int NUM_STRIDES = sizeof(Strides) / sizeof(long long);

// the twin's constants in float, as ATen casts them
constexpr float INV3 = 1.0f / 3.0f;
constexpr float INV6 = 1.0f / 6.0f;
constexpr float TWO_THIRDS_PI = static_cast<float>(2.0943951023931953);
constexpr float TINY = static_cast<float>(1e-30);
// 1e-60 rounds to 0 in float, so the twin compares and clamps with 0
constexpr float TINY2 = 0.0f;
constexpr float FIT_MIN = static_cast<float>(1e-12);
// 100 float32 eps, the twin's rank threshold
constexpr float EPS_RANK = static_cast<float>(100.0 * 1.1920928955078125e-07);

// torch.clamp(v, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// torch.clamp(v, lo, hi)
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.maximum / torch.minimum: NaN where either operand is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// torch.sum over the k axis, in the order of ATen's reduction kernel
template <typename F>
__device__ __forceinline__ float ksum(int k, F term) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < K_MAX; ++j)
    if (j < k) acc[j & 3] = acc[j & 3] + term(j);
  return ((acc[0] + acc[1]) + acc[2]) + acc[3];
}

struct Sym3 {
  float xx, xy, xz, yy, yz, zz;
};

// _eigh3_soa's null_vector: the unit null vector of S - lam I from the
// largest cross product of two of its rows; ok where that is not zero
__device__ __forceinline__ void null_vector(const Sym3& s, float lam,
                                            float& ox, float& oy, float& oz,
                                            bool& ok) {
  const float r0x = s.xx - lam, r0y = s.xy, r0z = s.xz;
  const float r1x = s.xy, r1y = s.yy - lam, r1z = s.yz;
  const float r2x = s.xz, r2y = s.yz, r2z = s.zz - lam;
  const float c01x = r0y * r1z - r0z * r1y;
  const float c01y = r0z * r1x - r0x * r1z;
  const float c01z = r0x * r1y - r0y * r1x;
  const float c02x = r0y * r2z - r0z * r2y;
  const float c02y = r0z * r2x - r0x * r2z;
  const float c02z = r0x * r2y - r0y * r2x;
  const float c12x = r1y * r2z - r1z * r2y;
  const float c12y = r1z * r2x - r1x * r2z;
  const float c12z = r1x * r2y - r1y * r2x;
  const float n01 = (c01x * c01x + c01y * c01y) + c01z * c01z;
  const float n02 = (c02x * c02x + c02y * c02y) + c02z * c02z;
  const float n12 = (c12x * c12x + c12y * c12y) + c12z * c12z;
  const bool use01 = (n01 >= n02) && (n01 >= n12);
  const bool use02 = !use01 && (n02 >= n12);
  const float cx = use01 ? c01x : (use02 ? c02x : c12x);
  const float cy = use01 ? c01y : (use02 ? c02y : c12y);
  const float cz = use01 ? c01z : (use02 ? c02z : c12z);
  const float n2 = (cx * cx + cy * cy) + cz * cz;
  ok = n2 > TINY2;
  const float inv = 1.0f / sqrtf(ok ? n2 : 1.0f);
  ox = cx * inv;
  oy = cy * inv;
  oz = cz * inv;
}

// _eigh3_soa: eigenvalues w0 <= w1 <= w2 and their unit vectors V[i]
__device__ __forceinline__ void eigh3(const Sym3& s, float (&w)[3],
                                      float (&V)[3][3]) {
  const float q = ((s.xx + s.yy) + s.zz) * INV3;
  const float b00 = s.xx - q, b11 = s.yy - q, b22 = s.zz - q;
  const float p2 = (((b00 * b00 + b11 * b11) + b22 * b22)
                    + 2.0f * ((s.xy * s.xy + s.xz * s.xz) + s.yz * s.yz))
                   * INV6;
  const float p = sqrtf(clamp_min(p2, 0.0f));
  const bool tiny = p <= TINY;
  const float p_safe = tiny ? 1.0f : p;
  const float detB = (b00 * (b11 * b22 - s.yz * s.yz)
                      - s.xy * (s.xy * b22 - s.yz * s.xz))
                     + s.xz * (s.xy * s.yz - b11 * s.xz);
  const float r = clamp(detB / (((2.0f * p_safe) * p_safe) * p_safe), -1.0f,
                        1.0f);
  const float phi = acosf(r) * INV3;
  float w2 = q + (2.0f * p) * cosf(phi);
  float w0 = q + (2.0f * p) * cosf(phi + TWO_THIRDS_PI);
  float w1 = ((3.0f * q) - w2) - w0;
  w0 = tiny ? q : w0;
  w1 = tiny ? q : w1;
  w2 = tiny ? q : w2;

  const bool hi_first = (w2 - w1) >= (w1 - w0);
  const float lam_a = hi_first ? w2 : w0;
  const float lam_b = hi_first ? w0 : w2;
  float ax, ay, az, bx, by, bz;
  bool ok_a, ok_b;
  null_vector(s, lam_a, ax, ay, az, ok_a);
  null_vector(s, lam_b, bx, by, bz, ok_b);
  ax = ok_a ? ax : 1.0f;
  ay = ok_a ? ay : 0.0f;
  az = ok_a ? az : 0.0f;
  const float aax = fabsf(ax), aay = fabsf(ay), aaz = fabsf(az);
  const bool x_least = (aax <= aay) && (aax <= aaz);
  const bool y_least = !x_least && (aay <= aaz);
  const float fx = x_least ? 1.0f : 0.0f;
  const float fy = y_least ? 1.0f : 0.0f;
  const float fz = (1.0f - fx) - fy;
  bx = ok_b ? bx : fx;
  by = ok_b ? by : fy;
  bz = ok_b ? bz : fz;
  const float dot = (bx * ax + by * ay) + bz * az;
  bx = bx - dot * ax;
  by = by - dot * ay;
  bz = bz - dot * az;
  const float nb2 = (bx * bx + by * by) + bz * bz;
  const bool ok_nb = nb2 > TINY2;
  const float invb = 1.0f / sqrtf(ok_nb ? nb2 : 1.0f);
  const float gx = ay * fz - az * fy;
  const float gy = az * fx - ax * fz;
  const float gz = ax * fy - ay * fx;
  const float g2 = sqrtf(clamp_min((gx * gx + gy * gy) + gz * gz, TINY2));
  bx = ok_nb ? bx * invb : gx / g2;
  by = ok_nb ? by * invb : gy / g2;
  bz = ok_nb ? bz * invb : gz / g2;
  const float cx = ay * bz - az * by;
  const float cy = az * bx - ax * bz;
  const float cz = ax * by - ay * bx;
  w[0] = w0;
  w[1] = w1;
  w[2] = w2;
  V[0][0] = hi_first ? bx : ax;
  V[0][1] = hi_first ? by : ay;
  V[0][2] = hi_first ? bz : az;
  V[1][0] = cx;
  V[1][1] = cy;
  V[1][2] = cz;
  V[2][0] = hi_first ? ax : bx;
  V[2][1] = hi_first ? ay : by;
  V[2][2] = hi_first ? az : bz;
}

__global__ void __launch_bounds__(THREADS)
plane_fit_kernel(const float* __restrict__ target,
                 const int* __restrict__ idx, const Strides st,
                 float* __restrict__ nox_out, float* __restrict__ noy_out,
                 float* __restrict__ noz_out, float* __restrict__ d_out,
                 bool* __restrict__ fit_out, bool* __restrict__ plane_out,
                 int B, int k, int N, float mean_factor, float inv_k,
                 float thr2) {
  const long long t = static_cast<long long>(blockIdx.x) * THREADS
                      + threadIdx.x;
  if (t >= static_cast<long long>(B) * N) return;
  const long long b = t / N, n = t % N;

  // the neighbours; a missing one (id -1) is point 0, as the twin's clamp
  float px[K_MAX], py[K_MAX], pz[K_MAX];
#pragma unroll
  for (int j = 0; j < K_MAX; ++j) {
    px[j] = py[j] = pz[j] = 0.0f;
    if (j < k) {
      int id = idx[b * st.idx[0] + j * st.idx[1] + n * st.idx[2]];
      id = id < 0 ? 0 : id;
      const float* p = target + id * st.target[0];
      px[j] = p[0];
      py[j] = p[st.target[1]];
      pz[j] = p[2 * st.target[1]];
    }
  }

  // centroid and covariance sums
  const float cx = ksum(k, [&](int j) { return px[j]; }) * mean_factor;
  const float cy = ksum(k, [&](int j) { return py[j]; }) * mean_factor;
  const float cz = ksum(k, [&](int j) { return pz[j]; }) * mean_factor;
  float dx[K_MAX], dy[K_MAX], dz[K_MAX];
#pragma unroll
  for (int j = 0; j < K_MAX; ++j) {
    dx[j] = px[j] - cx;
    dy[j] = py[j] - cy;
    dz[j] = pz[j] - cz;
  }
  Sym3 s;
  s.xx = ksum(k, [&](int j) { return dx[j] * dx[j]; });
  s.xy = ksum(k, [&](int j) { return dx[j] * dy[j]; });
  s.xz = ksum(k, [&](int j) { return dx[j] * dz[j]; });
  s.yy = ksum(k, [&](int j) { return dy[j] * dy[j]; });
  s.yz = ksum(k, [&](int j) { return dy[j] * dz[j]; });
  s.zz = ksum(k, [&](int j) { return dz[j] * dz[j]; });
  float w[3], V[3][3];
  eigh3(s, w, V);
  float lam[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) lam[i] = clamp_min(w[i], 0.0f);

  // rank-aware solve of (S + k c c^T) x = -k c in the eigenbasis
  const float fk = static_cast<float>(k);
  float a[3], s_dir[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    a[i] = (V[i][0] * cx + V[i][1] * cy) + V[i][2] * cz;
    s_dir[i] = lam[i] + (fk * a[i]) * a[i];
  }
  const float s_max = nan_max(nan_max(s_dir[0], s_dir[1]), s_dir[2]);
  const float inf = __int_as_float(0x7f800000);
  bool active[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) active[i] = s_dir[i] > EPS_RANK * s_max;
  float mu = nan_min(nan_min(active[0] ? lam[0] : inf,
                             active[1] ? lam[1] : inf),
                     active[2] ? lam[2] : inf);
  mu = isfinite(mu) ? mu : 0.0f;
  float r[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const bool lam_ok = lam[i] > TINY;
    const float ri = lam_ok ? mu / (lam_ok ? lam[i] : 1.0f) : 1.0f;
    r[i] = active[i] ? ri : 0.0f;
  }
  float num[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    num[c] = -(((a[0] * r[0]) * V[0][c] + (a[1] * r[1]) * V[1][c])
               + (a[2] * r[2]) * V[2][c]);
  const float den = (((mu * inv_k) + (a[0] * a[0]) * r[0])
                     + (a[1] * a[1]) * r[1]) + (a[2] * a[2]) * r[2];
  const bool ok_den = fabsf(den) > TINY;
  const float inv_den = 1.0f / (ok_den ? den : 1.0f);
  const float xx = num[0] * inv_den;
  const float xy = num[1] * inv_den;
  const float xz = num[2] * inv_den;
  const float ps_sq = (xx * xx + xy * xy) + xz * xz;
  const bool fit_ok = ok_den && (ps_sq >= FIT_MIN);
  const float inv_ps = 1.0f / sqrtf(fit_ok ? ps_sq : 1.0f);
  const float nox = xx * inv_ps;
  const float noy = xy * inv_ps;
  const float noz = xz * inv_ps;

  // thickness gate over the raw neighbours
  bool plane_ok = true;
#pragma unroll
  for (int j = 0; j < K_MAX; ++j) {
    if (j < k) {
      const float pd = ((px[j] * nox + py[j] * noy) + pz[j] * noz) + inv_ps;
      plane_ok = plane_ok && (pd * pd < thr2);
    }
  }

  nox_out[t] = nox;
  noy_out[t] = noy;
  noz_out[t] = noz;
  d_out[t] = inv_ps;
  fit_out[t] = fit_ok;
  plane_out[t] = plane_ok;
}

}  // namespace

// strides: NUM_STRIDES element strides in the order of Strides;
// mean_factor float(B N) / float(B k N) and inv_k 1 / k, each rounded to
// float as ATen's mean and its division by a host scalar round them;
// thr2 the squared plane thickness in float.  Outputs (B, N) contiguous.
// Returns a cudaError_t.
extern "C" int dcreg_plane_fit(const float* target, const int* idx,
                               const long long* strides, int num_strides,
                               float* nox, float* noy, float* noz,
                               float* d_off, bool* fit_ok, bool* plane_ok,
                               int B, int k, int N, float mean_factor,
                               float inv_k, float thr2, void* stream) {
  if (num_strides != NUM_STRIDES || B < 0 || N < 0 || k < 1 || k > K_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(B) * N;
  if (total == 0) return 0;
  Strides st;
  std::memcpy(&st, strides, sizeof(Strides));
  plane_fit_kernel<<<static_cast<unsigned>((total + THREADS - 1) / THREADS),
                     THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      target, idx, st, nox, noy, noz, d_off, fit_ok, plane_ok, B, k, N,
      mean_factor, inv_k, thr2);
  return static_cast<int>(cudaGetLastError());
}
