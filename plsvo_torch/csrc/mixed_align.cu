// Batched mixed 2-D / 1-D inverse-compositional feature alignment: the
// whole Gauss-Newton loop in one launch.
//
// Replaces the TPU kernel plsvo_tpu/ops/pallas_align.py::
// mixed_align_loop_pallas (body `_kernel`), the fused form of the loop in
// plsvo_tpu/ops/feature_align.py::align_mixed_atlas. Per row: each
// iteration resamples the 8x8 patch bilinearly at (u, v) from the row's
// prefetched 16x16 window, forms r = I - ref + mean_diff, and takes the
// 3-parameter step H3^-1 [sum dx r, sum dy r, sum r] (2-D rows) or the
// 2-parameter step H1^-1 [sum dgrad r, sum r] along the unit direction d
// (1-D rows). A row is active while valid, inside window and level, and
// not converged (step < conv_eps). A row that stops being active never
// becomes active again (its u, v, mean_diff are frozen), so iterations
// predicated on `active` give the results of the early-exit loop.
//
// What bounds it on an H100: neither bytes nor flops. A row moves ~2 KB
// and does ~12k flops over 10 iterations; at N <= 256 rows that is
// < 0.6 MB and < 3 MFLOP, far below a microsecond of either. The time is
// a latency chain: one trip to device memory, then up to 10 dependent
// resample -> reduce -> solve steps.
// Design, against that chain:
//  - one memory round trip: every global load (the window as float4s, the
//    lane's taps of ref/dx/dy/dgrad as float4s, H3^-1, H1^-1, d, uv0,
//    corner, wh, valid, is_1d) is issued at entry, before any use;
//    nothing is read from device memory inside the loop;
//  - 8 lanes per row (4 rows per warp, one warp per block): a lane owns
//    one patch row of 8 taps and resamples them from 2 window rows x 9
//    columns (18 shared-memory reads), rows first and then columns, as
//    the plain version does; the window's row stride in shared memory is
//    20 floats, so the 8 lanes of a row read 8 different banks and the
//    window still stores as float4s;
//  - sums are 3-level butterflies inside the 8-lane group, which leave
//    every lane with the same sums, so every lane solves the 3x3 / 2x2
//    step itself: no lane-0 branch and no broadcast;
//  - the 2-D convergence test compares the squared step with a threshold
//    that gives the same verdict as sqrtf(.) < conv_eps, so no square root
//    sits on the chain;
//  - the warp leaves the loop as soon as none of its 4 rows is active.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 8;         // patch size
constexpr int WP = 16;       // window size
constexpr int S = WP - P;    // in-window shifts
constexpr int WS = 20;       // window row stride in shared memory (floats)
constexpr int ROWS = 4;      // rows per warp (= per block)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float group_sum(float v) {
  // butterfly over the 8 lanes of a row's group: every lane ends with the
  // same sum
  v += __shfl_xor_sync(FULL, v, 4);
  v += __shfl_xor_sync(FULL, v, 2);
  v += __shfl_xor_sync(FULL, v, 1);
  return v;
}

struct Resample {
  int iu, iv;
  float fu, fv;
  bool ok;
};

__device__ __forceinline__ Resample locate(float u, float v, float cu,
                                           float cv, float wb, float hb) {
  Resample r;
  float first_u = u - (P / 2.0f - 0.5f);
  float first_v = v - (P / 2.0f - 0.5f);
  float tu = first_u - cu;
  float tv = first_v - cv;
  float iu = floorf(tu);
  float iv = floorf(tv);
  r.fu = tu - iu;
  r.fv = tv - iv;
  bool in_win = (iu >= 0.f) && (iv >= 0.f) && (iu <= S - 1) && (iv <= S - 1);
  float au0 = floorf(first_u);
  float av0 = floorf(first_v);
  bool in_img = (au0 >= 0.f) && (av0 >= 0.f) && (au0 + P <= wb - 1.f) &&
                (av0 + P <= hb - 1.f);
  r.ok = in_win && in_img;
  // the window offsets, clamped so that an inactive row reads inside its
  // window (converted straight from tu, tv, beside the floors above)
  r.iu = min(max(__float2int_rd(tu), 0), S - 1);
  r.iv = min(max(__float2int_rd(tv), 0), S - 1);
  return r;
}

__device__ __forceinline__ void load8(const float* __restrict__ p, float* d) {
  float4 a = __ldg(reinterpret_cast<const float4*>(p));
  float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
  d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
}

__global__ void __launch_bounds__(32) mixed_align_kernel(
    const float* __restrict__ win, const float* __restrict__ corner,
    const float* __restrict__ ref, const float* __restrict__ gdx,
    const float* __restrict__ gdy, const float* __restrict__ gdg,
    const float* __restrict__ h3, const float* __restrict__ h1,
    const float* __restrict__ dir, const uint8_t* __restrict__ is1d,
    const float* __restrict__ uv0, const float* __restrict__ wh,
    const uint8_t* __restrict__ valid, float* __restrict__ uv_out,
    uint8_t* __restrict__ conv_out, float* __restrict__ md_out, int N,
    int n_iter, float conv_eps, float conv_sq) {
  __shared__ __align__(16) float s_win[ROWS][WP * WS];
  const int lane = threadIdx.x;
  const int g = lane >> 3;   // row of the warp
  const int py = lane & 7;   // patch row owned by this lane
  const int n_row = blockIdx.x * ROWS + g;
  const bool in_range = n_row < N;
  const int n = in_range ? n_row : N - 1;  // rows past N load row N-1

  // ---- one round trip: every load issued before any use ----
  const float4* gw = reinterpret_cast<const float4*>(win + (size_t)n * WP * WP);
  float4 wv[8];
  #pragma unroll
  for (int j = 0; j < 8; ++j) wv[j] = __ldg(gw + j * 8 + py);
  const size_t t0 = (size_t)n * P * P + py * P;
  float rf[P], gx[P], gy[P], gg[P];
  load8(ref + t0, rf);
  load8(gdx + t0, gx);
  load8(gdy + t0, gy);
  load8(gdg + t0, gg);
  float H3[9], H1[4];
  #pragma unroll
  for (int k = 0; k < 9; ++k) H3[k] = __ldg(h3 + 9 * (size_t)n + k);
  #pragma unroll
  for (int k = 0; k < 4; ++k) H1[k] = __ldg(h1 + 4 * (size_t)n + k);
  const float du_dir = __ldg(dir + 2 * n), dv_dir = __ldg(dir + 2 * n + 1);
  const float cu = __ldg(corner + 2 * n), cv = __ldg(corner + 2 * n + 1);
  const float wb = __ldg(wh + 2 * n), hb = __ldg(wh + 2 * n + 1);
  float u = __ldg(uv0 + 2 * n), v = __ldg(uv0 + 2 * n + 1);
  const bool live = in_range && __ldg(valid + n) != 0;
  const bool one_d = __ldg(is1d + n) != 0;

  float* sw = s_win[g];
  #pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = j * 8 + py;  // float4 index: window row k / 4, column 4 (k % 4)
    *reinterpret_cast<float4*>(sw + (k >> 2) * WS + (k & 3) * 4) = wv[j];
  }
  __syncwarp();

  float md = 0.f;
  bool conv = false;
  Resample rs = locate(u, v, cu, cv, wb, hb);
  for (int it = 0; it < n_iter; ++it) {
    // the 2 window rows x 9 columns of this lane's taps, read before the
    // vote so that their latency overlaps it
    const float* w0 = sw + (rs.iv + py) * WS + rs.iu;
    float a0[P + 1], a1[P + 1];
    #pragma unroll
    for (int k = 0; k <= P; ++k) {
      a0[k] = w0[k];
      a1[k] = w0[WS + k];
    }
    const bool active = live && rs.ok && !conv;
    if (!__any_sync(FULL, active)) break;  // inactive rows stay frozen
    float z[P + 1];
    #pragma unroll
    for (int k = 0; k <= P; ++k)
      z[k] = (1.f - rs.fv) * a0[k] + rs.fv * a1[k];  // rows first ...
    float s_dxr = 0.f, s_dyr = 0.f, s_r = 0.f, s_dgr = 0.f;
    #pragma unroll
    for (int k = 0; k < P; ++k) {
      const float t = (1.f - rs.fu) * z[k] + rs.fu * z[k + 1];  // ... then columns
      const float e = t - rf[k] + md;
      s_dxr += gx[k] * e;
      s_dyr += gy[k] * e;
      s_r += e;
      s_dgr += gg[k] * e;
    }
    s_dxr = group_sum(s_dxr);
    s_dyr = group_sum(s_dyr);
    s_r = group_sum(s_r);
    s_dgr = group_sum(s_dgr);
    float du, dv, dmd;
    bool small;
    if (one_d) {
      const float a = H1[0] * s_dgr + H1[1] * s_r;
      const float c = H1[2] * s_dgr + H1[3] * s_r;
      du = a * du_dir;
      dv = a * dv_dir;
      dmd = c;
      small = fabsf(a) < conv_eps;
    } else {
      const float a = H3[0] * s_dxr + H3[1] * s_dyr + H3[2] * s_r;
      const float b = H3[3] * s_dxr + H3[4] * s_dyr + H3[5] * s_r;
      const float c = H3[6] * s_dxr + H3[7] * s_dyr + H3[8] * s_r;
      du = a;
      dv = b;
      dmd = c;
      // |(a, b)| < conv_eps without the square root: for the correctly
      // rounded sqrtf, sqrtf(x) < conv_eps exactly when x < conv_sq (the
      // wrapper's threshold)
      small = __fmaf_rn(b, b, __fmul_rn(a, a)) < conv_sq;
    }
    if (active) {
      u -= du;
      v -= dv;
      md -= dmd;
      conv = small;
    }
    rs = locate(u, v, cu, cv, wb, hb);
  }
  if (in_range && py == 0) {
    uv_out[2 * n] = u;
    uv_out[2 * n + 1] = v;
    md_out[n] = md;
    conv_out[n] = (conv && live && rs.ok) ? 1 : 0;
  }
}

}  // namespace

extern "C" int plsvo_mixed_align(
    const void* win, const void* corner, const void* ref, const void* dx,
    const void* dy, const void* dgrad, const void* h3inv, const void* h1inv,
    const void* d, const void* is_1d, const void* uv_init, const void* wh,
    const void* valid, void* uv_out, void* conv_out, void* md_out, int N,
    int n_iter, float conv_eps, float conv_sq, void* stream) {
  if (N <= 0) return 0;
  mixed_align_kernel<<<(N + ROWS - 1) / ROWS, 32, 0, (cudaStream_t)stream>>>(
      (const float*)win, (const float*)corner, (const float*)ref,
      (const float*)dx, (const float*)dy, (const float*)dgrad,
      (const float*)h3inv, (const float*)h1inv, (const float*)d,
      (const uint8_t*)is_1d, (const float*)uv_init, (const float*)wh,
      (const uint8_t*)valid, (float*)uv_out, (uint8_t*)conv_out,
      (float*)md_out, N, n_iter, conv_eps, conv_sq);
  return (int)cudaGetLastError();
}
