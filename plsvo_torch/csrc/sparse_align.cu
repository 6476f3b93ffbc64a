// Sparse image alignment of B sequences: the whole coarse-to-fine
// inverse-compositional Gauss-Newton on SE(3), every pyramid level and
// every iteration with its early exit, in one launch.
//
// Replaces no Pallas kernel: on the TPU the loop was an XLA while_loop
// (plsvo_tpu/ops/sparse_align.py::sparse_img_align), and in eager PyTorch
// each iteration is ~450 small launches and one host read
// (plsvo_torch/ops/sparse_align.py::sparse_img_align_plain, which this
// kernel reproduces). Per level it resamples 4x4 point patches and 4x4
// patches at line-segment samples (length-adaptive sample counts when the
// segments' 3-D endpoints are given), weights point taps 1/(1+|r|) and a
// segment by its mean |r| (dropped for good at >= 200), sums one 6x6
// normal system per sequence and solves it by Cholesky; the loop rolls
// back on a chi2 increase and stops on worse, NaN or max|x| < 1e-8.
//
// What bounds it on an H100: neither bytes nor flops. A frame's alignment
// (~960 rows x 16 taps, ~20 iterations) reads ~0.3 MB and does ~40 MFLOP:
// ~0.6 us of either. The time is a latency chain of dependent iterations,
// each a resample -> reduce -> 6x6 solve step that ends in one decision.
// Design, against that chain:
//  - one CTA per sequence (grid = B): the pose, the previous pose, chi2 and
//    the loop state stay in shared memory for the whole call, and each
//    sequence leaves its loop on its own (the frozen-carry result of the
//    batched plain loop);
//  - per level, a prologue computes each row's reference taps and their
//    image gradients (the central differences of the interpolated window,
//    with the window's zero border) once, into shared memory when the
//    shape fits (49 words a row), else into a global scratch that stays in
//    L2; the reference windows are never materialised: every sample is read
//    from the level image through the read-only cache, at the window
//    corner the plain loop clamps at the level's start;
//  - a row's normal-equation terms are factored: with J = dx J0 + dy J1 per
//    tap, the row adds sa J0J0' + sc (J0J1' + J1J0') + sd J1J1' to H, from 5
//    sums over its 16 taps, so a tap costs ~12 flops and not 27 FMAs;
//  - a segment's K samples are K lanes of one warp: its mean |r| and its
//    in-frame verdict are butterfly shuffles, no shared memory, no sync;
//  - the 29 sums (21 of H, 6 of b, chi2, n_meas) are reduced in a fixed
//    order (warp butterflies, then one warp over the warps' partials): no
//    atomics, so two runs give the same bits;
//  - one thread then solves, exponentiates, composes and decides, in the
//    plain loop's order of selections; two barriers an iteration.
// Samples and verdicts use the plain twin's elementwise arithmetic,
// unfused (__f*_rn), so that the same positions give the same taps and the
// same in-window and visibility verdicts.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int P = 4;               // patch size (template of the wrapper: 4)
constexpr int PP = P * P;          // taps per row
constexpr int WPR = P + 6;         // reference window (_patch_and_grad)
constexpr int SR = WPR - P;        // its in-window shifts
constexpr int WPC = P + 1 + 2 * 3 + ((P + 1) % 2);  // current-level window
constexpr int SC = WPC - P;        // its in-window shifts
static_assert(WPR % 2 == 0 && WPC % 2 == 0, "the plain windows are even");
constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int NRED = 29;           // 21 (H, upper) + 6 (b) + chi2 + n_meas
constexpr int ROW_WORDS = 3 * PP + 1;  // ref, dx, dy per tap + the corner
constexpr int MAXL = 8;            // pyramid levels per call
constexpr unsigned FULL = 0xffffffffu;

struct Levels {
  const float* ref[MAXL];
  const float* cur[MAXL];
  int hr[MAXL], wr[MAXL], hc[MAXL], wc[MAXL];
  float scale[MAXL], fscale[MAXL];
  int n;
};

struct Args {
  const float* pts_xyz;     // (B, N, 3)
  const float* pts_uv;      // (B, N, 2)
  const uint8_t* pts_valid; // (B, N)
  const float* seg_xyz;     // (B, M, K, 3)
  const float* seg_uv;      // (B, M, K, 2)
  const uint8_t* seg_valid; // (B, M)
  const float* seg_p;       // (B, M, 3) or null (fixed samples)
  const float* seg_q;       // (B, M, 3) or null
  const float* R_init;      // (B, 3, 3)
  const float* t_init;      // (B, 3)
  float* R_out;             // (B, 3, 3)
  float* t_out;             // (B, 3)
  float* chi2_out;          // (B,)
  float* trace;             // (B, L, n_iter, 2): chi2, max|x| per iteration
  int* iters;               // (B, L)
  int* n_pts;               // (B,)
  int* n_segs;              // (B,)
  uint8_t* alive_out;       // (B, M)
  float* scratch;           // (B, NA, ROW_WORDS) or null (shared memory)
  int N, M, K, G, n_iter;
  float fx, fy, cx, cy;
};

__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
  // (1 - f) * a + f * b, as the plain version's elementwise ops round it
  return __fadd_rn(__fmul_rn(__fsub_rn(1.f, f), a), __fmul_rn(f, b));
}

__device__ __forceinline__ float safe_z(float z) {
  return fabsf(z) < 1e-10f ? 1e-10f : z;
}

// level-0 pixel coordinates of a reference-frame point (_proj0)
__device__ __forceinline__ void proj0(const Args& a, float x, float y, float z,
                                      float& u, float& v) {
  z = safe_z(z);
  u = __fadd_rn(__fdiv_rn(__fmul_rn(a.fx, x), z), a.cx);
  v = __fadd_rn(__fdiv_rn(__fmul_rn(a.fy, y), z), a.cy);
}

// level pixel coordinates of a reference point seen from the pose (R, t)
// (_warp_project)
__device__ __forceinline__ void warp_project(const Args& a, const float* R,
                                             const float* t, float x, float y,
                                             float z, float scale, float& u,
                                             float& v) {
  float xc = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, R[0]), __fmul_rn(y, R[1])),
                                 __fmul_rn(z, R[2])), t[0]);
  float yc = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, R[3]), __fmul_rn(y, R[4])),
                                 __fmul_rn(z, R[5])), t[1]);
  float zc = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, R[6]), __fmul_rn(y, R[7])),
                                 __fmul_rn(z, R[8])), t[2]);
  zc = safe_z(zc);
  u = __fmul_rn(__fadd_rn(__fdiv_rn(__fmul_rn(a.fx, xc), zc), a.cx), scale);
  v = __fmul_rn(__fadd_rn(__fdiv_rn(__fmul_rn(a.fy, yc), zc), a.cy), scale);
}

// the window corner gather_patch_windows clamps into the image
__device__ __forceinline__ int corner_of(float c, float half_m1, int dim,
                                         int wp) {
  float f = floorf(__fsub_rn(c, half_m1));
  f = fminf(fmaxf(f, 0.f), (float)max(dim - wp, 0));
  return (int)f;
}

__device__ __forceinline__ float pixel(const float* img, int h, int w, int y,
                                       int x) {
  // a window past the border of an image smaller than it reads zeros
  return (y < h && x < w) ? __ldg(img + (size_t)y * w + x) : 0.f;
}

// d(unit-plane u, v) / d(twist [v, w]) of a reference-frame point
__device__ __forceinline__ void jac(float x, float y, float z, float* J0,
                                    float* J1) {
  const float zi = 1.f / safe_z(z);
  const float zi2 = zi * zi;
  J0[0] = -zi;
  J0[1] = 0.f;
  J0[2] = x * zi2;
  J0[3] = x * y * zi2;
  J0[4] = -(1.f + x * x * zi2);
  J0[5] = y * zi;
  J1[0] = 0.f;
  J1[1] = -zi;
  J1[2] = y * zi2;
  J1[3] = 1.f + y * y * zi2;
  J1[4] = -x * y * zi2;
  J1[5] = -x * zi;
}

// acc[0..20] += H terms of a row, acc[21..26] -= b terms (upper triangle,
// row-major): s = (sa, sc, sd, sxr, syr), times wgt
__device__ __forceinline__ void add_row(float* acc, const float* J0,
                                        const float* J1, const float* s,
                                        float wgt) {
  const float sa = wgt * s[0], sc = wgt * s[1], sd = wgt * s[2];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      acc[k++] += sa * J0[i] * J0[j] + sc * (J0[i] * J1[j] + J1[i] * J0[j]) +
                  sd * J1[i] * J1[j];
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[21 + i] -= wgt * (s[3] * J0[i] + s[4] * J1[i]);
}

// a segment sample's reference-frame point: adaptive (p + alpha (q - p),
// alpha = min(k / max(n_act - 1, 1), 1)) or the fixed table's
__device__ __forceinline__ void seg_point(const Args& a, int b, int m, int k,
                                          int na, float& x, float& y,
                                          float& z) {
  const size_t sm = (size_t)b * a.M + m;
  if (a.seg_p != nullptr) {
    const float denom = (float)max(na - 1, 1);
    const float al = fminf(__fdiv_rn((float)k, denom), 1.f);
    const float px = __ldg(a.seg_p + 3 * sm), py = __ldg(a.seg_p + 3 * sm + 1),
                pz = __ldg(a.seg_p + 3 * sm + 2);
    x = __fadd_rn(px, __fmul_rn(al, __fsub_rn(__ldg(a.seg_q + 3 * sm), px)));
    y = __fadd_rn(py, __fmul_rn(al, __fsub_rn(__ldg(a.seg_q + 3 * sm + 1), py)));
    z = __fadd_rn(pz, __fmul_rn(al, __fsub_rn(__ldg(a.seg_q + 3 * sm + 2), pz)));
  } else {
    const size_t r = (sm * a.K + k) * 3;
    x = __ldg(a.seg_xyz + r);
    y = __ldg(a.seg_xyz + r + 1);
    z = __ldg(a.seg_xyz + r + 2);
  }
}

// Reference taps of one row (_patch_and_grad): the patch, the central
// differences of its window (zero on the window's border) sampled at the
// same taps, and the row's visibility. Writes tap[q * NA + a].
__device__ bool ref_row(const float* img, int h, int w, float cu_, float cv_,
                        float* tap, int NA, int row) {
  const int cu = corner_of(cu_, WPR / 2.f - 1.f, w, WPR);
  const int cv = corner_of(cv_, WPR / 2.f - 1.f, h, WPR);
  const float fu0 = __fsub_rn(cu_, P / 2.f - 0.5f);
  const float fv0 = __fsub_rn(cv_, P / 2.f - 0.5f);
  const float tu = __fsub_rn(fu0, (float)cu), tv = __fsub_rn(fv0, (float)cv);
  const float iu = floorf(tu), iv = floorf(tv);
  const float fu = __fsub_rn(tu, iu), fv = __fsub_rn(tv, iv);
  const bool ok_w = iu >= 0.f && iv >= 0.f && iu <= SR - 1 && iv <= SR - 1;
  const int iuc = (int)fminf(fmaxf(iu, 0.f), SR - 1);
  const int ivc = (int)fminf(fmaxf(iv, 0.f), SR - 1);
  // window cells ivc-1 .. ivc+P+1 x iuc-1 .. iuc+P+1 (0 outside the window)
  float wv[P + 3][P + 3];
#pragma unroll
  for (int i = 0; i < P + 3; ++i) {
#pragma unroll
    for (int j = 0; j < P + 3; ++j) {
      const int r = ivc - 1 + i, c = iuc - 1 + j;
      wv[i][j] = (r >= 0 && r < WPR && c >= 0 && c < WPR)
                     ? pixel(img, h, w, cv + r, cu + c) : 0.f;
    }
  }
  // the window, its x and y central differences at window cell (ivc + i,
  // iuc + j), i, j in 0..P
  auto I = [&](int i, int j) { return wv[i + 1][j + 1]; };
  auto DX = [&](int i, int j) {
    const int c = iuc + j;
    return (c == 0 || c == WPR - 1)
               ? 0.f : __fmul_rn(0.5f, __fsub_rn(wv[i + 1][j + 2], wv[i + 1][j]));
  };
  auto DY = [&](int i, int j) {
    const int r = ivc + i;
    return (r == 0 || r == WPR - 1)
               ? 0.f : __fmul_rn(0.5f, __fsub_rn(wv[i + 2][j + 1], wv[i][j + 1]));
  };
#pragma unroll
  for (int py = 0; py < P; ++py) {
    float ri[P + 1], rx[P + 1], ry[P + 1];
#pragma unroll
    for (int j = 0; j <= P; ++j) {  // rows first ...
      ri[j] = lerp_rn(I(py, j), I(py + 1, j), fv);
      rx[j] = lerp_rn(DX(py, j), DX(py + 1, j), fv);
      ry[j] = lerp_rn(DY(py, j), DY(py + 1, j), fv);
    }
#pragma unroll
    for (int px = 0; px < P; ++px) {  // ... then columns
      const int q = py * P + px;
      tap[q * NA + row] = lerp_rn(ri[px], ri[px + 1], fu);
      tap[(PP + q) * NA + row] = lerp_rn(rx[px], rx[px + 1], fu);
      tap[(2 * PP + q) * NA + row] = lerp_rn(ry[px], ry[px + 1], fu);
    }
  }
  const float au0 = floorf(fu0), av0 = floorf(fv0);
  return ok_w && au0 >= 1.f && av0 >= 1.f && au0 + P <= (float)(w - 2) &&
         av0 + P <= (float)(h - 2);
}

// Current taps of one row at level position (u, v) from the window at
// `corner` (sample_patch_windows with the level's bounds), against the
// reference taps: the row's residual sums. Returns the in-frame verdict.
// pt: point weighting (w = 1/(1+|r|) per tap, chi2 summed), else plain sums
// and the sum of |r|.
template <bool PT>
__device__ __forceinline__ bool cur_row(const float* img, int h, int w,
                                        float u, float v, int corner,
                                        const float* tap, int NA, int row,
                                        float* s, float& extra) {
  const int cu = corner & 0xffff, cv = corner >> 16;
  const float fu0 = __fsub_rn(u, P / 2.f - 0.5f);
  const float fv0 = __fsub_rn(v, P / 2.f - 0.5f);
  const float tu = __fsub_rn(fu0, (float)cu), tv = __fsub_rn(fv0, (float)cv);
  const float iu = floorf(tu), iv = floorf(tv);
  const float fu = __fsub_rn(tu, iu), fv = __fsub_rn(tv, iv);
  const float au0 = floorf(fu0), av0 = floorf(fv0);
  const bool ok = iu >= 0.f && iv >= 0.f && iu <= SC - 1 && iv <= SC - 1 &&
                  au0 >= 0.f && av0 >= 0.f && au0 + P <= (float)(w - 1) &&
                  av0 + P <= (float)(h - 1);
  if (!ok) return false;
  const int x0 = cu + (int)iu, y0 = cv + (int)iv;
  float prev[P + 1];
#pragma unroll
  for (int j = 0; j <= P; ++j) prev[j] = pixel(img, h, w, y0, x0 + j);
#pragma unroll
  for (int py = 0; py < P; ++py) {
    float nxt[P + 1], rw[P + 1];
#pragma unroll
    for (int j = 0; j <= P; ++j) {
      nxt[j] = pixel(img, h, w, y0 + py + 1, x0 + j);
      rw[j] = lerp_rn(prev[j], nxt[j], fv);
      prev[j] = nxt[j];
    }
#pragma unroll
    for (int px = 0; px < P; ++px) {
      const int q = py * P + px;
      const float r = lerp_rn(rw[px], rw[px + 1], fu) - tap[q * NA + row];
      const float dx = tap[(PP + q) * NA + row];
      const float dy = tap[(2 * PP + q) * NA + row];
      if (PT) {
        const float wt = 1.f / (1.f + fabsf(r));
        const float wdx = wt * dx, wdy = wt * dy;
        s[0] += wdx * dx;
        s[1] += wdx * dy;
        s[2] += wdy * dy;
        s[3] += wdx * r;
        s[4] += wdy * r;
        extra += wt * r * r;
      } else {
        s[0] += dx * dx;
        s[1] += dx * dy;
        s[2] += dy * dy;
        s[3] += dx * r;
        s[4] += dy * r;
        extra += fabsf(r);
      }
    }
  }
  return true;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

// x = (A + eps I)^-1 b by the plain twin's unrolled Cholesky (NaN when A
// is not positive definite)
__device__ void solve6(const float* Hu, const float* b, float* x) {
  float A[6][6], L[6][6], y[6];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) A[i][j] = A[j][i] = Hu[k++];
#pragma unroll
  for (int i = 0; i < 6; ++i) A[i][i] = __fadd_rn(A[i][i], 1e-8f);
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = A[j][j];
#pragma unroll
    for (int q = 0; q < j; ++q) s = __fsub_rn(s, __fmul_rn(L[j][q], L[j][q]));
    L[j][j] = sqrtf(s);
    const float inv_d = __fdiv_rn(1.f, L[j][j]);
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = A[i][j];
#pragma unroll
      for (int q = 0; q < j; ++q) t = __fsub_rn(t, __fmul_rn(L[i][q], L[j][q]));
      L[i][j] = __fmul_rn(t, inv_d);
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int q = 0; q < i; ++q) s = __fsub_rn(s, __fmul_rn(L[i][q], y[q]));
    y[i] = __fdiv_rn(s, L[i][i]);
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int q = i + 1; q < 6; ++q) s = __fsub_rn(s, __fmul_rn(L[q][i], x[q]));
    x[i] = __fdiv_rn(s, L[i][i]);
  }
}

// (R, t) <- (R, t) * exp(xi) (lie.se3_exp, then lie.compose)
__device__ void compose_exp(const float* R, const float* t, const float* xi,
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
      Rn[3 * i + j] = R[3 * i] * dR[j] + R[3 * i + 1] * dR[3 + j] +
                      R[3 * i + 2] * dR[6 + j];
    tn[i] = R[3 * i] * dt[0] + R[3 * i + 1] * dt[1] + R[3 * i + 2] * dt[2] + t[i];
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    sparse_align_kernel(const Levels L, const Args a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ float red[NWARPS][NRED];
  __shared__ float sR[9], st[3], sRp[9], stp[3];
  __shared__ float s_chi2_prev;
  __shared__ int s_stop, s_cnt[2];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.N, M = a.M, K = a.K, G = a.G;
  const int NA = N + M * K;
  float* tap;
  unsigned char* small;
  if (a.scratch != nullptr) {
    tap = a.scratch + (size_t)b * ROW_WORDS * NA;
    small = dyn;
  } else {
    tap = reinterpret_cast<float*>(dyn);
    small = dyn + (size_t)ROW_WORDS * NA * 4;
  }
  int* corner = reinterpret_cast<int*>(tap + 3 * PP * NA);
  int* n_act = reinterpret_cast<int*>(small);
  uint8_t* vis_sg = small + 4 * M;
  uint8_t* alive = vis_sg + M;
  uint8_t* vis_pt = alive + M;
  // virtual lanes: whole warps of point rows, then groups of G lanes (a
  // warp holds 32 / G segments), sample k of a segment on lane k of its group
  const int NP = (N + 31) & ~31;
  const int T = NP + ((M * G + 31) & ~31);

  if (tid < 9) sR[tid] = __ldg(a.R_init + 9 * b + tid);
  if (tid < 3) st[tid] = __ldg(a.t_init + 3 * b + tid);
  for (int m = tid; m < M; m += THREADS)
    alive[m] = __ldg(a.seg_valid + (size_t)b * M + m) != 0;
  float chi2_out = 0.f;  // thread 0's
  __syncthreads();

  for (int l = 0; l < L.n; ++l) {
    const float scale = L.scale[l];
    const int hr = L.hr[l], wr = L.wr[l], hc = L.hc[l], wc = L.wc[l];
    const float* ref = L.ref[l] + (size_t)b * hr * wr;
    const float* cur = L.cur[l] + (size_t)b * hc * wc;
    // ---- prologue: the samples of each segment at this level ----
    for (int m = tid; m < M; m += THREADS) {
      int na = K;
      if (a.seg_p != nullptr) {
        const size_t sm = (size_t)b * M + m;
        float pu, pv, qu, qv;
        proj0(a, __ldg(a.seg_p + 3 * sm), __ldg(a.seg_p + 3 * sm + 1),
              __ldg(a.seg_p + 3 * sm + 2), pu, pv);
        proj0(a, __ldg(a.seg_q + 3 * sm), __ldg(a.seg_q + 3 * sm + 1),
              __ldg(a.seg_q + 3 * sm + 2), qu, qv);
        const double du = (double)__fsub_rn(__fmul_rn(qu, scale), __fmul_rn(pu, scale));
        const double dv = (double)__fsub_rn(__fmul_rn(qv, scale), __fmul_rn(pv, scale));
        const float len = (float)sqrt(du * du + dv * dv);
        na = min(max((int)__fdiv_rn(len, (float)P) + 1, 2), K);
      }
      n_act[m] = na;
    }
    __syncthreads();
    // ---- prologue: reference taps, visibility, current-window corners ----
    for (int v = tid; v < T; v += THREADS) {
      if (v < NP) {
        if (v < N) {
          const size_t r = (size_t)b * N + v;
          const float x = __ldg(a.pts_xyz + 3 * r), y = __ldg(a.pts_xyz + 3 * r + 1),
                      z = __ldg(a.pts_xyz + 3 * r + 2);
          const bool ok = ref_row(ref, hr, wr, __fmul_rn(__ldg(a.pts_uv + 2 * r), scale),
                                  __fmul_rn(__ldg(a.pts_uv + 2 * r + 1), scale),
                                  tap, NA, v);
          vis_pt[v] = ok && __ldg(a.pts_valid + r) != 0;
          float u0, v0;
          warp_project(a, sR, st, x, y, z, scale, u0, v0);
          corner[v] = corner_of(u0, WPC / 2.f - 1.f, wc, WPC) |
                      (corner_of(v0, WPC / 2.f - 1.f, hc, WPC) << 16);
        }
      } else {
        const int s = v - NP, m = s / G, k = s % G;
        bool fine = true;  // (visible or outside the active samples)
        if (m < M && alive[m] && k < K && k < n_act[m]) {
          const int row = N + m * K + k;
          float x, y, z, u, vv;
          seg_point(a, b, m, k, n_act[m], x, y, z);
          if (a.seg_p != nullptr) {
            proj0(a, x, y, z, u, vv);
          } else {
            const size_t r = (((size_t)b * M + m) * K + k) * 2;
            u = __ldg(a.seg_uv + r);
            vv = __ldg(a.seg_uv + r + 1);
          }
          fine = ref_row(ref, hr, wr, __fmul_rn(u, scale), __fmul_rn(vv, scale),
                         tap, NA, row);
          float u0, v0;
          warp_project(a, sR, st, x, y, z, scale, u0, v0);
          corner[row] = corner_of(u0, WPC / 2.f - 1.f, wc, WPC) |
                        (corner_of(v0, WPC / 2.f - 1.f, hc, WPC) << 16);
        }
        int f = fine;
        for (int o = 1; o < G; o <<= 1) f &= __shfl_xor_sync(FULL, f, o);
        if (m < M && k == 0) vis_sg[m] = f && alive[m];
      }
    }
    if (tid == 0) {
      for (int i = 0; i < 9; ++i) sRp[i] = sR[i];
      for (int i = 0; i < 3; ++i) stp[i] = st[i];
      s_chi2_prev = INFINITY;
    }
    __syncthreads();

    // ---- the Gauss-Newton loop ----
    int it = 0;
    while (it < a.n_iter) {
      float acc[NRED];
#pragma unroll
      for (int i = 0; i < NRED; ++i) acc[i] = 0.f;
      float R[9], t[3];
#pragma unroll
      for (int i = 0; i < 9; ++i) R[i] = sR[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) t[i] = st[i];
      for (int v = tid; v < T; v += THREADS) {
        if (v < NP) {
          if (v < N && vis_pt[v]) {
            const size_t r = (size_t)b * N + v;
            const float x = __ldg(a.pts_xyz + 3 * r), y = __ldg(a.pts_xyz + 3 * r + 1),
                        z = __ldg(a.pts_xyz + 3 * r + 2);
            float u, vv;
            warp_project(a, R, t, x, y, z, scale, u, vv);
            float s[5] = {0.f, 0.f, 0.f, 0.f, 0.f}, c2 = 0.f;
            if (cur_row<true>(cur, hc, wc, u, vv, corner[v], tap, NA, v, s, c2)) {
              float J0[6], J1[6];
              jac(x, y, z, J0, J1);
              add_row(acc, J0, J1, s, 1.f);
              acc[27] += c2;
              acc[28] += (float)PP;
            }
          }
        } else {
          const int sidx = v - NP, m = sidx / G, k = sidx % G;
          const bool seg = m < M;
          const int na = seg ? n_act[m] : 0;
          const bool live = seg && vis_sg[m] && alive[m];
          const bool act = live && k < K && k < na;
          float s[5] = {0.f, 0.f, 0.f, 0.f, 0.f}, sabs = 0.f;
          float x = 0.f, y = 0.f, z = 1.f;
          int in = 1;
          if (act) {
            const int row = N + m * K + k;
            float u, vv;
            seg_point(a, b, m, k, na, x, y, z);
            warp_project(a, R, t, x, y, z, scale, u, vv);
            in = cur_row<false>(cur, hc, wc, u, vv, corner[row], tap, NA, row, s,
                                sabs);
          }
          for (int o = 1; o < G; o <<= 1) {
            sabs += __shfl_xor_sync(FULL, sabs, o);
            in &= __shfl_xor_sync(FULL, in, o);
          }
          if (live) {
            const bool ok_line = in != 0;
            const float mean = sabs / fmaxf((float)na * PP, 1.f);
            const bool use = ok_line && mean < 200.f;
            const float wl = 1.f / (1.f + mean);
            if (k == 0) {
              if (ok_line && !(mean < 200.f)) alive[m] = 0;  // dropped for good
              if (use) {
                acc[27] += wl * mean * mean;
                acc[28] += (float)(na * PP);
              }
            }
            if (use && act) {
              float J0[6], J1[6];
              jac(x, y, z, J0, J1);
              add_row(acc, J0, J1, s, wl);
            }
          }
        }
      }
      // fixed-order block reduction of the 29 sums
#pragma unroll
      for (int i = 0; i < NRED; ++i) {
        const float sum = warp_sum(acc[i]);
        if (lane == 0) red[warp][i] = sum;
      }
      __syncthreads();
      if (warp == 0) {
        float tot = 0.f;
        if (lane < NRED)
          for (int w = 0; w < NWARPS; ++w) tot += red[w][lane];
        // lane i holds sum i; thread 0 gathers them
        float sums[NRED];
#pragma unroll
        for (int i = 0; i < NRED; ++i) sums[i] = __shfl_sync(FULL, tot, i);
        if (lane == 0) {
          const float fs = L.fscale[l];
          float Hu[21], bb[6], x[6];
          for (int i = 0; i < 21; ++i) Hu[i] = sums[i] * (fs * fs);
          for (int i = 0; i < 6; ++i) bb[i] = sums[21 + i] * fs;
          const float chi2 = sums[27] / fmaxf(sums[28], 1.f);
          solve6(Hu, bb, x);
          bool bad = false;
          float mx = 0.f;
          for (int i = 0; i < 6; ++i) {
            bad |= isnan(x[i]);
            mx = fmaxf(mx, fabsf(x[i]));
          }
          if (bad) mx = NAN;
          const bool worse = it > 0 && chi2 > s_chi2_prev;
          const bool stop = worse || bad || mx < 1e-8f;
          float mxi[6], Rn[9], tn[3];
          for (int i = 0; i < 6; ++i) mxi[i] = -x[i];
          compose_exp(sR, st, mxi, Rn, tn);
          float Ro[9], to[3];
          for (int i = 0; i < 9; ++i) Ro[i] = worse ? sRp[i] : (bad ? sR[i] : Rn[i]);
          for (int i = 0; i < 3; ++i) to[i] = worse ? stp[i] : (bad ? st[i] : tn[i]);
          for (int i = 0; i < 9; ++i) { sRp[i] = sR[i]; sR[i] = Ro[i]; }
          for (int i = 0; i < 3; ++i) { stp[i] = st[i]; st[i] = to[i]; }
          if (!worse) s_chi2_prev = chi2;
          float* tr = a.trace + (((size_t)b * L.n + l) * a.n_iter + it) * 2;
          tr[0] = chi2;
          tr[1] = mx;
          s_stop = stop;
        }
      }
      __syncthreads();
      ++it;
      if (s_stop) break;
    }
    if (tid == 0) {
      a.iters[b * L.n + l] = it;
      chi2_out = s_chi2_prev;
    }
    // no thread reads the loop's state again before the next barrier
  }
  if (tid < 2) s_cnt[tid] = 0;
  __syncthreads();
  if (L.n > 0) {
    int np = 0, ns = 0;
    for (int i = tid; i < N; i += THREADS) np += vis_pt[i];
    for (int m = tid; m < M; m += THREADS) ns += vis_sg[m] && alive[m];
    atomicAdd(&s_cnt[0], np);
    atomicAdd(&s_cnt[1], ns);
  }
  for (int m = tid; m < M; m += THREADS) a.alive_out[(size_t)b * M + m] = alive[m];
  __syncthreads();
  if (tid < 9) a.R_out[9 * b + tid] = sR[tid];
  if (tid < 3) a.t_out[3 * b + tid] = st[tid];
  if (tid == 0) {
    a.chi2_out[b] = chi2_out;
    a.n_pts[b] = s_cnt[0];
    a.n_segs[b] = s_cnt[1];
  }
}

}  // namespace

extern "C" int plsvo_sparse_align(
    const void* const* ref, const void* const* cur, const int* hw,
    const float* scales, int n_levels, const void* pts_xyz, const void* pts_uv,
    const void* pts_valid, const void* seg_xyz, const void* seg_uv,
    const void* seg_valid, const void* seg_p, const void* seg_q,
    const void* R_init, const void* t_init, void* R_out, void* t_out,
    void* chi2_out, void* trace, void* iters, void* n_pts, void* n_segs,
    void* alive_out, void* scratch, int B, int N, int M, int K, int n_iter,
    float fx, float fy, float cx, float cy, void* stream) {
  if (B <= 0) return 0;
  if (n_levels < 0 || n_levels > MAXL || K < 0 || K > 32 || N < 0 || M < 0)
    return (int)cudaErrorInvalidValue;
  Levels L;
  L.n = n_levels;
  for (int i = 0; i < n_levels; ++i) {
    L.ref[i] = (const float*)ref[i];
    L.cur[i] = (const float*)cur[i];
    L.hr[i] = hw[4 * i];
    L.wr[i] = hw[4 * i + 1];
    L.hc[i] = hw[4 * i + 2];
    L.wc[i] = hw[4 * i + 3];
    L.scale[i] = scales[2 * i];
    L.fscale[i] = scales[2 * i + 1];
  }
  int G = 1;
  while (G < K) G <<= 1;
  Args a;
  a.pts_xyz = (const float*)pts_xyz;
  a.pts_uv = (const float*)pts_uv;
  a.pts_valid = (const uint8_t*)pts_valid;
  a.seg_xyz = (const float*)seg_xyz;
  a.seg_uv = (const float*)seg_uv;
  a.seg_valid = (const uint8_t*)seg_valid;
  a.seg_p = (const float*)seg_p;
  a.seg_q = (const float*)seg_q;
  a.R_init = (const float*)R_init;
  a.t_init = (const float*)t_init;
  a.R_out = (float*)R_out;
  a.t_out = (float*)t_out;
  a.chi2_out = (float*)chi2_out;
  a.trace = (float*)trace;
  a.iters = (int*)iters;
  a.n_pts = (int*)n_pts;
  a.n_segs = (int*)n_segs;
  a.alive_out = (uint8_t*)alive_out;
  a.N = N;
  a.M = M;
  a.K = K;
  a.G = G;
  a.n_iter = n_iter;
  a.fx = fx;
  a.fy = fy;
  a.cx = cx;
  a.cy = cy;
  // the rows' taps in shared memory when they fit, else in the scratch
  const size_t NA = (size_t)N + (size_t)M * K;
  const size_t small = ((size_t)6 * M + N + 15) & ~(size_t)15;
  const size_t taps = (size_t)ROW_WORDS * NA * 4;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, sparse_align_kernel);
  if (err != cudaSuccess) return (int)err;
  const bool in_smem = taps + small + fa.sharedSizeBytes <= (size_t)optin;
  a.scratch = in_smem ? nullptr : (float*)scratch;
  if (!in_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t dyn = in_smem ? taps + small : small;
  if (dyn + fa.sharedSizeBytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(sparse_align_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dyn);
  if (err != cudaSuccess) return (int)err;
  sparse_align_kernel<<<B, THREADS, dyn, (cudaStream_t)stream>>>(L, a);
  return (int)cudaGetLastError();
}
