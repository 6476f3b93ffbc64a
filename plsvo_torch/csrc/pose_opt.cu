// Motion-only pose optimisation of B sequences: the Tukey-weighted
// Gauss-Newton on SE(3) over point and line-segment reprojection errors,
// its MAD scales, the inlier strip, the refinement pass on the inliers and
// the covariance, in one launch.
//
// Replaces no Pallas kernel: on the TPU the loop was an XLA while_loop
// (plsvo_tpu/ops/pose_opt.py::optimize_pose), and in eager PyTorch each
// iteration is ~300 small launches and one host read
// (plsvo_torch/ops/pose_opt.py::optimize_pose_plain, which this kernel
// reproduces, the exact line rows -l^T J and the sign of the line term
// included). Per sequence: the MAD scale of the point and of the segment
// residual norms at the initial pose (an exact order statistic, as
// jnp.nanmedian); n_iter GN iterations on the valid rows, each stopping on
// a chi2 increase (rolled back), a NaN step (rolled back) or max|dT| <
// 1e-10; the strip at reproj_thresh / focal (segments at that threshold
// scaled by scale_sg / scale_pt); n_iter_ref iterations on the inliers and
// the strip again; cov = (A f^2 + 1e-12 I)^-1 of the last kept system.
//
// What bounds it on an H100: neither bytes nor flops. A tracked frame's
// solve (192 point and 96 segment rows, ~5 iterations) reads ~20 KB and
// does ~0.2 MFLOP: well under a microsecond of either. The time is a
// latency chain of dependent iterations, each a rows -> reduce -> 6x6
// solve step that ends in one decision. Design, against that chain:
//  - one CTA per sequence (grid = B): the pose, the previous pose, chi2,
//    the last kept system and the row masks stay in shared memory for the
//    whole call, and each sequence leaves its loop on its own (the
//    frozen-carry result of the batched plain loop);
//  - a thread owns rows and sums their 28 terms (21 of A, 6 of J^T W e,
//    chi2) in registers; every row the plain loop reads is read, invalid
//    ones with weight 0, so that a NaN propagates as it does there;
//  - the 28 sums are reduced in a fixed order (warp butterflies, then the
//    warps' partials in index order): no atomics, so two launches on the
//    same inputs give the same bits;
//  - the MAD median is a bitonic sort of ordered 32-bit keys in shared
//    memory (invalid rows +inf, NaN after +inf, the padding last);
//  - one thread solves (the plain twin's unrolled Cholesky), exponentiates,
//    composes and decides, in the plain loop's order of selections; two
//    barriers an iteration.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int NRED = 28;  // 21 (A, upper triangle) + 6 (J^T W e) + chi2
constexpr unsigned FULL = 0xffffffffu;
constexpr float TUKEY_B = 4.6851f;
constexpr unsigned KEY_NAN = 0xfffffffeu;  // after +inf
constexpr unsigned KEY_PAD = 0xffffffffu;  // after NaN

struct Args {
  const float* pt_f;         // (B, N, 3) observed bearings
  const int* pt_level;       // (B, N)
  const float* pt_pos;       // (B, N, 3) world positions
  const uint8_t* pt_valid;   // (B, N)
  const float* seg_line;     // (B, M, 3) observed line coefficients
  const int* seg_level;      // (B, M)
  const float* seg_spos;     // (B, M, 3)
  const float* seg_epos;     // (B, M, 3)
  const uint8_t* seg_valid;  // (B, M)
  const float* R_init;       // (B, 3, 3)
  const float* t_init;       // (B, 3)
  float* R_out;              // (B, 3, 3)
  float* t_out;              // (B, 3)
  float* cov_out;            // (B, 6, 6)
  uint8_t* pt_in;            // (B, N)
  uint8_t* seg_in;           // (B, M)
  int* n_obs_pt;             // (B,)
  int* n_obs_seg;            // (B,)
  float* scale_pt;           // (B,)
  float* scale_seg;          // (B,)
  float* chi2_out;           // (B,)
  int* iters;                // (B, 2): iterations of each pass
  float* trace;              // (B, 2, T): chi2 of each iteration
  int N, M, n_iter, n_iter_ref, T;
  float focal, thresh_pt;
};

__device__ __forceinline__ float safe_z(float z) {
  return fabsf(z) < 1e-10f ? 1e-10f : z;
}

// 1 / (1 << level), with torch's shift (0 outside 0..63, so inf)
__device__ __forceinline__ float level_scale(int lv) {
  const long long v = (lv < 0 || lv >= 64) ? 0LL : (long long)(1ULL << lv);
  return 1.f / (float)v;
}

__device__ __forceinline__ void load3(const float* p, float* x) {
  x[0] = __ldg(p);
  x[1] = __ldg(p + 1);
  x[2] = __ldg(p + 2);
}

// x = R p + t
__device__ __forceinline__ void transform(const float* R, const float* t,
                                          const float* p, float* x) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    x[i] = R[3 * i] * p[0] + R[3 * i + 1] * p[1] + R[3 * i + 2] * p[2] + t[i];
}

// d(unit-plane u, v) / d(twist [v, w]) at a camera-frame point, times s
// (jacobian_xyz2uv, then the level's scale)
__device__ __forceinline__ void jac(const float* X, float s, float* J0,
                                    float* J1) {
  const float x = X[0], y = X[1];
  const float zi = 1.f / safe_z(X[2]);
  const float zi2 = zi * zi;
  J0[0] = -zi * s;
  J0[1] = 0.f * s;
  J0[2] = x * zi2 * s;
  J0[3] = x * y * zi2 * s;
  J0[4] = -(1.f + x * x * zi2) * s;
  J0[5] = y * zi * s;
  J1[0] = 0.f * s;
  J1[1] = -zi * s;
  J1[2] = y * zi2 * s;
  J1[3] = (1.f + y * y * zi2) * s;
  J1[4] = -x * y * zi2 * s;
  J1[5] = -x * zi * s;
}

__device__ __forceinline__ float tukey_weight(float x) {
  const float u = x / TUKEY_B;
  const float w = 1.f - u * u;
  return fabsf(u) < 1.f ? w * w : 0.f;
}

__device__ __forceinline__ float tukey_rho(float x) {
  const float u = x / TUKEY_B;
  const float u2 = u * u;
  const float c = (float)(4.6851 * 4.6851 / 6.0);
  const float v = 1.f - (u2 > 1.f ? 1.f : u2);  // NaN stays NaN
  return c * (1.f - v * v * v);
}

// A point row at the pose (R, t): camera-frame point, error, level scale
__device__ __forceinline__ void pt_row(const Args& a, size_t r, const float* R,
                                       const float* t, float* X, float& e0,
                                       float& e1, float& sic) {
  float p[3], f[3];
  load3(a.pt_pos + 3 * r, p);
  load3(a.pt_f + 3 * r, f);
  transform(R, t, p, X);
  const float z = safe_z(X[2]);
  const float fz = safe_z(f[2]);
  sic = level_scale(__ldg(a.pt_level + r));
  e0 = (f[0] / fz - X[0] / z) * sic;
  e1 = (f[1] / fz - X[1] / z) * sic;
}

// A segment row at the pose (R, t): both camera-frame endpoints, the line
// coefficients, the two endpoint errors, the level scale
__device__ __forceinline__ void seg_row(const Args& a, size_t r, const float* R,
                                        const float* t, float* Xs, float* Xe,
                                        float* l, float& e0, float& e1,
                                        float& sic) {
  float ps[3], pe[3];
  load3(a.seg_spos + 3 * r, ps);
  load3(a.seg_epos + 3 * r, pe);
  load3(a.seg_line + 3 * r, l);
  transform(R, t, ps, Xs);
  transform(R, t, pe, Xe);
  const float zs = safe_z(Xs[2]), ze = safe_z(Xe[2]);
  const float ds = l[0] * (Xs[0] / zs) + l[1] * (Xs[1] / zs) + l[2] * 1.f;
  const float de = l[0] * (Xe[0] / ze) + l[1] * (Xe[1] / ze) + l[2] * 1.f;
  sic = level_scale(__ldg(a.seg_level + r));
  e0 = ds * sic;
  e1 = de * sic;
}

// acc[0..20] += w (r0 r0' + r1 r1') (upper triangle, row-major),
// acc[21..26] += w (r0 e0 + r1 e1)
__device__ __forceinline__ void add_row(float* acc, const float* r0,
                                        const float* r1, float e0, float e1,
                                        float w) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) acc[k++] += (r0[i] * r0[j] + r1[i] * r1[j]) * w;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[21 + i] += (r0[i] * e0 + r1[i] * e1) * w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

// x = (A + eps I)^-1 b by the plain twin's unrolled Cholesky (NaN when A
// is not positive definite); A given as its upper triangle
__device__ void solve6(const float* Au, const float* b, float eps, float* x) {
  float A[6][6], L[6][6], y[6];
  int k = 0;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j) A[i][j] = A[j][i] = Au[k++];
  for (int i = 0; i < 6; ++i) A[i][i] = __fadd_rn(A[i][i], eps);
  for (int j = 0; j < 6; ++j) {
    float s = A[j][j];
    for (int q = 0; q < j; ++q) s = __fsub_rn(s, __fmul_rn(L[j][q], L[j][q]));
    L[j][j] = sqrtf(s);
    const float inv_d = __fdiv_rn(1.f, L[j][j]);
    for (int i = j + 1; i < 6; ++i) {
      float t = A[i][j];
      for (int q = 0; q < j; ++q) t = __fsub_rn(t, __fmul_rn(L[i][q], L[j][q]));
      L[i][j] = __fmul_rn(t, inv_d);
    }
  }
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
    for (int q = 0; q < i; ++q) s = __fsub_rn(s, __fmul_rn(L[i][q], y[q]));
    y[i] = __fdiv_rn(s, L[i][i]);
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int q = i + 1; q < 6; ++q) s = __fsub_rn(s, __fmul_rn(L[q][i], x[q]));
    x[i] = __fdiv_rn(s, L[i][i]);
  }
}

// (R, t) <- exp(xi) * (R, t) (lie.se3_exp, then lie.compose(dR, dt, R, t))
__device__ void exp_compose(const float* xi, const float* R, const float* t,
                            float* Rn, float* tn) {
  const float* v = xi;
  const float* w = xi + 3;
  const float th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float th = sqrtf(fmaxf(th2, 0.f));
  const bool small = th2 < 1e-8f;
  const float s = sinf(th), c = cosf(th);
  const float A = small ? 1.f - th2 / 6.f : s / th;
  const float Bc = small ? 0.5f - th2 / 24.f : (1.f - c) / th2;
  const float C = small ? 1.f / 6.f - th2 / 120.f : (th - s) / (th2 * th);
  const float W[9] = {0.f, -w[2], w[1], w[2], 0.f, -w[0], -w[1], w[0], 0.f};
  float W2[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      W2[3 * i + j] = W[3 * i] * W[j] + W[3 * i + 1] * W[3 + j] +
                      W[3 * i + 2] * W[6 + j];
  float dR[9], V[9];
  for (int k = 0; k < 9; ++k) {
    const float e = (k % 4 == 0) ? 1.f : 0.f;
    dR[k] = e + A * W[k] + Bc * W2[k];
    V[k] = e + Bc * W[k] + C * W2[k];
  }
  float dt[3];
  for (int i = 0; i < 3; ++i)
    dt[i] = V[3 * i] * v[0] + V[3 * i + 1] * v[1] + V[3 * i + 2] * v[2];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      Rn[3 * i + j] = dR[3 * i] * R[j] + dR[3 * i + 1] * R[3 + j] +
                      dR[3 * i + 2] * R[6 + j];
    tn[i] = dR[3 * i] * t[0] + dR[3 * i + 1] * t[1] + dR[3 * i + 2] * t[2] +
            dt[i];
  }
}

// out = (A f^2 + 1e-12 I)^-1 by Gauss-Jordan with partial pivoting; A given
// as its upper triangle
__device__ void covariance(const float* Au, float f, float* out) {
  float M[6][12];
  int k = 0;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j) M[i][j] = M[j][i] = Au[k++] * f * f;
  for (int i = 0; i < 6; ++i) {
    M[i][i] += 1e-12f;
    for (int j = 0; j < 6; ++j) M[i][6 + j] = (i == j) ? 1.f : 0.f;
  }
  for (int c = 0; c < 6; ++c) {
    int p = c;
    for (int r = c + 1; r < 6; ++r)
      if (fabsf(M[r][c]) > fabsf(M[p][c])) p = r;
    if (p != c)
      for (int j = 0; j < 12; ++j) {
        const float tmp = M[c][j];
        M[c][j] = M[p][j];
        M[p][j] = tmp;
      }
    const float inv = 1.f / M[c][c];
    for (int j = 0; j < 12; ++j) M[c][j] *= inv;
    for (int r = 0; r < 6; ++r) {
      if (r == c) continue;
      const float fct = M[r][c];
      for (int j = 0; j < 12; ++j) M[r][j] -= fct * M[c][j];
    }
  }
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) out[6 * i + j] = M[i][6 + j];
}

// a float as an unsigned key in the float's order (NaN after +inf)
__device__ __forceinline__ unsigned float_key(float x) {
  if (isnan(x)) return KEY_NAN;
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned k) {
  if (k >= KEY_NAN) return NAN;
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// ascending bitonic sort of key[0..n2), n2 a power of two
__device__ void bitonic_sort(unsigned* key, int n2) {
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n2; i += THREADS) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned x = key[i], y = key[ixj];
          if (((i & k) == 0) ? (x > y) : (x < y)) {
            key[i] = y;
            key[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// mad_scale from the sorted keys of n valid norms: 1.48 * median (the
// linear interpolation of jnp.nanmedian, 1 where it is NaN), >= 1e-6
__device__ float mad_from_sorted(const unsigned* key, int n) {
  float med = NAN;
  if (n > 0) {
    const float q = 0.5f * ((float)n - 1.f);
    const float lo = floorf(q), hi = ceilf(q);
    const float hw = q - lo, lw = 1.f - hw;
    med = key_float(key[(int)lo]) * lw + key_float(key[(int)hi]) * hw;
  }
  if (isnan(med)) med = 1.f;
  return fmaxf(1.48f * med, 1e-6f);
}

__device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__global__ void __launch_bounds__(THREADS)
    pose_opt_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ float red[NWARPS][NRED];
  __shared__ float sums[NRED];
  __shared__ float sR[9], st[3], sRo[9], sto[3], sA[21], sAl[21];
  __shared__ float s_chi2_prev, s_scale_pt, s_scale_sg;
  __shared__ int s_stop, s_cnt[2];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.N, M = a.M;
  unsigned* key = reinterpret_cast<unsigned*>(dyn);
  const int n2 = pow2_at_least(max(max(N, M), 1));
  uint8_t* mask_pt = dyn + 4 * (size_t)n2;
  uint8_t* mask_sg = mask_pt + N;
  const size_t pb = (size_t)b * N, sb = (size_t)b * M;

  if (tid < 9) sR[tid] = __ldg(a.R_init + 9 * b + tid);
  if (tid < 3) st[tid] = __ldg(a.t_init + 3 * b + tid);
  if (tid < 2) s_cnt[tid] = 0;
  __syncthreads();

  // ---- the MAD scales at the initial pose ----
  {
    int c = 0;
    const int np2 = pow2_at_least(max(N, 1));
    for (int i = tid; i < np2; i += THREADS) {
      unsigned k = KEY_PAD;
      if (i < N) {
        const bool v = __ldg(a.pt_valid + pb + i) != 0;
        mask_pt[i] = v;
        k = float_key(INFINITY);
        if (v) {
          float X[3], e0, e1, sic;
          pt_row(a, pb + i, sR, st, X, e0, e1, sic);
          k = float_key(sqrtf(e0 * e0 + e1 * e1));
          ++c;
        }
      }
      key[i] = k;
    }
    atomicAdd(&s_cnt[0], c);
    __syncthreads();
    bitonic_sort(key, np2);
    if (tid == 0) s_scale_pt = mad_from_sorted(key, s_cnt[0]);
    __syncthreads();
    c = 0;
    const int ns2 = pow2_at_least(max(M, 1));
    for (int i = tid; i < ns2; i += THREADS) {
      unsigned k = KEY_PAD;
      if (i < M) {
        const bool v = __ldg(a.seg_valid + sb + i) != 0;
        mask_sg[i] = v;
        k = float_key(INFINITY);
        if (v) {
          float Xs[3], Xe[3], l[3], e0, e1, sic;
          seg_row(a, sb + i, sR, st, Xs, Xe, l, e0, e1, sic);
          k = float_key(sqrtf(e0 * e0 + e1 * e1));
          ++c;
        }
      }
      key[i] = k;
    }
    atomicAdd(&s_cnt[1], c);
    __syncthreads();
    bitonic_sort(key, ns2);
    if (tid == 0)
      s_scale_sg = s_cnt[1] > 0 ? mad_from_sorted(key, s_cnt[1]) : 1.f;
    __syncthreads();
  }
  const float scale_pt = s_scale_pt, scale_sg = s_scale_sg;
  const float thresh_sg = a.thresh_pt * scale_sg / scale_pt;

  // the inlier strip at the current pose: masks <- valid & |e| <= thresh
  auto strip = [&]() {
    for (int v = tid; v < N + M; v += THREADS) {
      if (v < N) {
        float X[3], e0, e1, sic;
        pt_row(a, pb + v, sR, st, X, e0, e1, sic);
        mask_pt[v] = __ldg(a.pt_valid + pb + v) != 0 &&
                     sqrtf(e0 * e0 + e1 * e1) <= a.thresh_pt;
      } else {
        const int m = v - N;
        float Xs[3], Xe[3], l[3], e0, e1, sic;
        seg_row(a, sb + m, sR, st, Xs, Xe, l, e0, e1, sic);
        mask_sg[m] = __ldg(a.seg_valid + sb + m) != 0 &&
                     sqrtf(e0 * e0 + e1 * e1) <= thresh_sg;
      }
    }
    __syncthreads();
  };

  // ---- the two Gauss-Newton passes ----
  for (int pass = 0; pass < 2; ++pass) {
    const int n_it = pass == 0 ? a.n_iter : a.n_iter_ref;
    if (pass == 1 && n_it <= 0) break;
    if (tid == 0) {
      for (int i = 0; i < 9; ++i) sRo[i] = sR[i];
      for (int i = 0; i < 3; ++i) sto[i] = st[i];
      for (int i = 0; i < 21; ++i) sAl[i] = 0.f;
      for (int i = 0, k = 0; i < 6; k += 6 - i, ++i) sAl[k] = 1.f;
      s_chi2_prev = INFINITY;
    }
    __syncthreads();
    int it = 0;
    while (it < n_it) {
      float acc[NRED];
#pragma unroll
      for (int i = 0; i < NRED; ++i) acc[i] = 0.f;
      float R[9], t[3];
#pragma unroll
      for (int i = 0; i < 9; ++i) R[i] = sR[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) t[i] = st[i];
      for (int v = tid; v < N + M; v += THREADS) {
        float r0[6], r1[6], e0, e1, sic, en, w;
        bool use;
        if (v < N) {
          float X[3];
          pt_row(a, pb + v, R, t, X, e0, e1, sic);
          jac(X, sic, r0, r1);
          en = sqrtf(e0 * e0 + e1 * e1) / scale_pt;
          use = mask_pt[v];
        } else {
          const int m = v - N;
          float Xs[3], Xe[3], l[3], Js0[6], Js1[6], Je0[6], Je1[6];
          seg_row(a, sb + m, R, t, Xs, Xe, l, e0, e1, sic);
          jac(Xs, sic, Js0, Js1);
          jac(Xe, sic, Je0, Je1);
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            r0[i] = -(l[0] * Js0[i] + l[1] * Js1[i]);
            r1[i] = -(l[0] * Je0[i] + l[1] * Je1[i]);
          }
          en = sqrtf(e0 * e0 + e1 * e1) / scale_sg;
          use = mask_sg[m];
        }
        w = tukey_weight(en) * (use ? 1.f : 0.f);
        add_row(acc, r0, r1, e0, e1, w);
        if (use) acc[27] += tukey_rho(en);
      }
      // fixed-order block reduction of the 28 sums
#pragma unroll
      for (int i = 0; i < NRED; ++i) {
        const float s = warp_sum(acc[i]);
        if (lane == 0) red[warp][i] = s;
      }
      __syncthreads();
      if (warp == 0) {
        if (lane < NRED) {
          float tot = 0.f;
          for (int w = 0; w < NWARPS; ++w) tot += red[w][lane];
          sums[lane] = tot;
        }
        __syncwarp();
        if (lane == 0) {
          float bb[6], dT[6], Rn[9], tn[3];
          for (int i = 0; i < 21; ++i) sA[i] = sums[i];
          for (int i = 0; i < 6; ++i) bb[i] = -sums[21 + i];
          const float chi2 = sums[27];
          solve6(sA, bb, 1e-10f, dT);
          bool bad = false;
          float mx = 0.f;
          for (int i = 0; i < 6; ++i) {
            bad |= isnan(dT[i]);
            mx = fmaxf(mx, fabsf(dT[i]));
          }
          const bool worse = it > 0 && chi2 > s_chi2_prev;
          const bool stop = worse || bad || mx < 1e-10f;
          exp_compose(dT, sR, st, Rn, tn);
          const bool back = worse || bad;
          for (int i = 0; i < 9; ++i) {
            const float nx = back ? sRo[i] : Rn[i];
            sRo[i] = sR[i];
            sR[i] = nx;
          }
          for (int i = 0; i < 3; ++i) {
            const float nx = back ? sto[i] : tn[i];
            sto[i] = st[i];
            st[i] = nx;
          }
          if (!worse) {
            s_chi2_prev = chi2;
            for (int i = 0; i < 21; ++i) sAl[i] = sA[i];
          }
          a.trace[((size_t)b * 2 + pass) * a.T + it] = chi2;
          s_stop = stop;
        }
      }
      __syncthreads();
      ++it;
      if (s_stop) break;
    }
    if (tid == 0) a.iters[2 * b + pass] = it;
    __syncthreads();
    strip();
  }

  // ---- outputs ----
  for (int i = tid; i < N; i += THREADS) a.pt_in[pb + i] = mask_pt[i];
  for (int i = tid; i < M; i += THREADS) a.seg_in[sb + i] = mask_sg[i];
  if (tid < 9) a.R_out[9 * b + tid] = sR[tid];
  if (tid < 3) a.t_out[3 * b + tid] = st[tid];
  if (tid == 0) {
    if (a.n_iter_ref <= 0) a.iters[2 * b + 1] = 0;
    covariance(sAl, a.focal, a.cov_out + 36 * (size_t)b);
    a.n_obs_pt[b] = s_cnt[0];
    a.n_obs_seg[b] = s_cnt[1];
    a.scale_pt[b] = scale_pt;
    a.scale_seg[b] = scale_sg;
    a.chi2_out[b] = s_chi2_prev;
  }
}

}  // namespace

extern "C" int plsvo_pose_opt(
    const void* pt_f, const void* pt_level, const void* pt_pos,
    const void* pt_valid, const void* seg_line, const void* seg_level,
    const void* seg_spos, const void* seg_epos, const void* seg_valid,
    const void* R_init, const void* t_init, void* R_out, void* t_out,
    void* cov_out, void* pt_in, void* seg_in, void* n_obs_pt, void* n_obs_seg,
    void* scale_pt, void* scale_seg, void* chi2_out, void* iters, void* trace,
    int B, int N, int M, int n_iter, int n_iter_ref, float focal,
    float thresh_pt, void* stream) {
  if (B <= 0) return 0;
  if (N < 0 || M < 0 || n_iter < 0 || n_iter_ref < 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.pt_f = (const float*)pt_f;
  a.pt_level = (const int*)pt_level;
  a.pt_pos = (const float*)pt_pos;
  a.pt_valid = (const uint8_t*)pt_valid;
  a.seg_line = (const float*)seg_line;
  a.seg_level = (const int*)seg_level;
  a.seg_spos = (const float*)seg_spos;
  a.seg_epos = (const float*)seg_epos;
  a.seg_valid = (const uint8_t*)seg_valid;
  a.R_init = (const float*)R_init;
  a.t_init = (const float*)t_init;
  a.R_out = (float*)R_out;
  a.t_out = (float*)t_out;
  a.cov_out = (float*)cov_out;
  a.pt_in = (uint8_t*)pt_in;
  a.seg_in = (uint8_t*)seg_in;
  a.n_obs_pt = (int*)n_obs_pt;
  a.n_obs_seg = (int*)n_obs_seg;
  a.scale_pt = (float*)scale_pt;
  a.scale_seg = (float*)scale_seg;
  a.chi2_out = (float*)chi2_out;
  a.iters = (int*)iters;
  a.trace = (float*)trace;
  a.N = N;
  a.M = M;
  a.n_iter = n_iter;
  a.n_iter_ref = n_iter_ref;
  a.T = n_iter > n_iter_ref ? n_iter : n_iter_ref;
  if (a.T < 1) a.T = 1;
  a.focal = focal;
  a.thresh_pt = thresh_pt;
  // the sort keys and the two row masks in shared memory
  int n2 = 1;
  while (n2 < N || n2 < M) n2 <<= 1;
  const size_t dyn = 4 * (size_t)n2 + (size_t)N + (size_t)M;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, pose_opt_kernel);
  if (err != cudaSuccess) return (int)err;
  if (dyn + fa.sharedSizeBytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(pose_opt_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dyn);
  if (err != cudaSuccess) return (int)err;
  pose_opt_kernel<<<B, THREADS, dyn, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
