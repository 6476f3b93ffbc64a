// FAST-10 corner mask + Shi-Tomasi score of every image of a list (the
// levels of a pyramid, or a same-shape batch) in one launch.
//
// Replaces the TPU kernel plsvo_tpu/ops/pallas_fast.py::fast_score_pallas
// (body `_kernel`). Semantics are those of the plain version
// (plsvo_tpu/ops/detection.py::fast_corner_mask + image.py::shi_tomasi_score),
// borders included:
//   - mask: >= 10 contiguous pixels of the radius-3 ring all > c + thr or all
//     < c - thr; cleared within 3 px of the border;
//   - score: min eigenvalue of the 8x8-box (offsets -4..3) structure tensor
//     of central differences / (2 * 64); the differences wrap around the
//     image (the plain version rolls), and the score is 0 outside
//     [4, H-4] x [4, W-4] (the plain box filter zero-pads there).
//
// What bounds it on an H100: bytes. Per pixel it reads 4 bytes and writes
// 5 (mask + score); the three levels of a 752x480 pyramid (473,760 px) are
// 4.26 MB, 1.27 us at 3.35 TB/s. The function's least arithmetic (~63
// ops/px) is ~0.45 us at 67 TFLOP/s f32. At these sizes a warp's chain of
// dependent steps, not the card's throughput, sets the time, so the design
// keeps that chain short: one trip to device memory, then arithmetic.
// Design:
//  - one launch for all images: a flat grid of warp tasks; each image's
//    shape, pointers and first task are kernel arguments;
//  - a warp task is a strip of 32 columns x TH rows: lane l owns column
//    x = 25 s - 4 + l and lanes 4..28 write results, so the halo overfetch
//    is 32/25 in x and (TH + 9)/TH in y;
//  - one memory round trip: the warp copies its (TH + 9) x 38 tile into
//    shared memory with cp.async, all copies in flight together, before
//    any use; indices wrap (np.roll semantics) once per lane (its two
//    columns and one tile row), never per pixel;
//  - the lane then walks down its column: per row it reads 7 pixels
//    (columns x-3..x+3) from shared memory into a register window of the
//    last 8 rows and forms the three gradient products;
//  - the box is separable: the vertical 8-sum is a pairwise tree over the
//    lane's last 8 rows of products, kept as running pair and quad sums in
//    registers (3 adds per row), the horizontal 8-sum a sliding window of
//    three shuffles and one shift across lanes (also a pairwise tree):
//    12 shuffles per pixel;
//  - the FAST ring tests are one subtraction and one funnel shift per bit
//    (the sign of the difference is the comparison), and the run test a
//    few bit operations on the doubled 16-bit ring;
//    every lane computes every row and only the stores are predicated, so
//    the walk has no branches.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;              // output rows per warp task
constexpr int OUT_W = 25;          // output columns per warp (lanes 4..28)
constexpr int TR = TH + 9;         // tile rows: image rows y0-5 .. y0+TH+3
constexpr int TC = 38;             // tile columns: x0-3 .. x0+34 (x0 = lane 0)
static_assert(TR <= 32, "one lane wraps each tile row");
constexpr int WARPS = 4;           // warp tasks per block
constexpr int MAXL = 32;           // images per launch
constexpr unsigned FULL = 0xffffffffu;

struct Levels {
  const float* img[MAXL];
  uint8_t* mask[MAXL];
  float* score[MAXL];
  int H[MAXL], W[MAXL], strips[MAXL];
  int task0[MAXL + 1];  // first warp task of each image; task0[n] = total
  int n;
};

// X(bit, dx, dy) for each ring pixel, in the order of detection._FAST_RING
// (a macro, so that every register index below is a compile-time constant)
#define FAST_RING(X)                                                        \
  X(0, 0, -3) X(1, 1, -3) X(2, 2, -2) X(3, 3, -1) X(4, 3, 0) X(5, 3, 1)     \
  X(6, 2, 2) X(7, 1, 3) X(8, 0, 3) X(9, -1, 3) X(10, -2, 2) X(11, -3, 1)    \
  X(12, -3, 0) X(13, -3, -1) X(14, -2, -2) X(15, -1, -3)

__device__ __forceinline__ bool has_run10(uint32_t bits) {
  // a circular run of >= 10 set bits among 16: double the ring, then AND
  // shifted copies until bit i says "bits i..i+9 all set"
  uint32_t x = bits | (bits << 16);
  x &= x >> 1;  // runs of 2
  x &= x >> 2;  // 4
  x &= x >> 4;  // 8
  x &= x >> 2;  // 10
  return x != 0;
}

__device__ __forceinline__ int wrap(int i, int n) {
  // i mod n for the few rows or columns of a tile that leave the image
  while (i < 0) i += n;
  while (i >= n) i -= n;
  return i;
}

__device__ __forceinline__ uint32_t push_less(uint32_t bits, float a, float b) {
  // (bits << 1) | (a < b), from the sign of a - b: for floats that are not
  // -0 (the window holds none), a - b is negative exactly when a < b (a
  // difference of unequal floats is never 0, equal ones give +0, and a NaN
  // result is the positive canonical NaN)
  return __funnelshift_l(__float_as_uint(a - b), bits, 1);
}

// Vertical 8-sums of one gradient product as a pairwise tree, built
// incrementally: with p_q the product of row q, pair_q = p_(q-1) + p_q,
// quad_q = pair_(q-2) + pair_q and oct, the 8-sum of rows q-7..q, is
// quad_(q-4) + quad_q: three adds per row instead of seven. (q is a
// compile-time constant in the unrolled row walk, so every index below
// names a register.)
struct Tree8 {
  float last, pair[2], quad[4], oct;
  __device__ __forceinline__ void push(int q, float p) {
    if (q >= 2) {
      const float pr = last + p;
      if (q >= 4) {
        const float qd = pair[q & 1] + pr;      // pair_(q-2) + pair_q
        if (q >= 8) oct = quad[q & 3] + qd;     // quad_(q-4) + quad_q
        quad[q & 3] = qd;
      }
      pair[q & 1] = pr;
    }
    last = p;
  }
};

__device__ __forceinline__ float lane_box8(float v) {
  // sum of v over lanes l-4 .. l+3, as a pairwise tree
  v += __shfl_down_sync(FULL, v, 1);
  v += __shfl_down_sync(FULL, v, 2);
  v += __shfl_down_sync(FULL, v, 4);
  return __shfl_up_sync(FULL, v, 4);
}

__global__ void __launch_bounds__(32 * WARPS) fast_score_kernel(
    const __grid_constant__ Levels L, float thr) {
  __shared__ float s_tile[WARPS][TR][TC];
  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (task >= L.task0[L.n]) return;  // whole warp leaves together
  int l = 0;
  while (task >= L.task0[l + 1]) ++l;
  const int t = task - L.task0[l];
  const int H = L.H[l], W = L.W[l];
  const int x0 = (t % L.strips[l]) * OUT_W - 4;  // column of lane 0
  const int y0 = (t / L.strips[l]) * TH;
  const float* __restrict__ im = L.img[l];
  float(*tile)[TC] = s_tile[threadIdx.x >> 5];

  // ---- one round trip: tile (y0-5 .., x0-3 ..) into shared memory ----
  // lane l copies tile columns l and, for l < TC - 32, l + 32 of every
  // row; lane r (< TR) wraps the image row of tile row r, once, and the
  // row loop takes it by shuffle: a lane wraps three indices, no pixel
  // wraps any
  const bool second = lane < TC - 32;
  const int gx0 = wrap(x0 - 3 + lane, W), gx1 = wrap(x0 + 29 + lane, W);
  const int my_row = wrap(y0 - 5 + min(lane, TR - 1), H);
  #pragma unroll
  for (int r = 0; r < TR; ++r) {
    const float* row = im + (size_t)__shfl_sync(FULL, my_row, r) * W;
    __pipeline_memcpy_async(&tile[r][lane], row + gx0, 4);
    if (second) __pipeline_memcpy_async(&tile[r][lane + 32], row + gx1, 4);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();

  const int x = x0 + lane;
  const bool out_col = lane >= 4 && lane <= 28 && x < W;
  const bool score_col = x >= 4 && x <= W - 4;
  const bool mask_col = x >= 3 && x < W - 3;
  uint8_t* mask = L.mask[l];
  float* score = L.score[l];

  float wr[8][7];  // image rows r-7 .. r, columns x-3 .. x+3
  Tree8 txx, tyy, txy;
  #pragma unroll
  for (int s = 0; s < TR; ++s) {
    // image row r = y0 - 5 + s (tile row s) into the register window;
    // + 0 turns a -0 pixel into +0 (for push_less) and changes no value
    #pragma unroll
    for (int k = 0; k < 7; ++k) wr[s & 7][k] = __fadd_rn(tile[s][lane + k], 0.f);
    if (s < 2) continue;
    // gradient products of row r - 1 (central differences, as the plain
    // version: 0.5 * (right - left), 0.5 * (below - above))
    const int q = s - 1;
    const float dx = 0.5f * (wr[q & 7][4] - wr[q & 7][2]);
    const float dy = 0.5f * (wr[s & 7][3] - wr[(s - 2) & 7][3]);
    txx.push(q, dx * dx);
    tyy.push(q, dy * dy);
    txy.push(q, dx * dy);
    if (s < 9) continue;
    // output row y = r - 4: FAST on rows r-7 .. r-1, box on products of
    // rows r-8 .. r-1
    const int y = y0 + s - 9;
    const float sxx = lane_box8(txx.oct);
    const float syy = lane_box8(tyy.oct);
    const float sxy = lane_box8(txy.oct);
    const float c = wr[(s - 4) & 7][3];
    const float hi = c + thr, lo = c - thr;
    uint32_t bright = 0, dark = 0;
    // ring pixel k lands on bit 15 - k: a circular run is a run either way
#define RING_TEST(k, ox, oy)                              \
    {                                                     \
      const float v = wr[(s - 4 + (oy)) & 7][3 + (ox)];   \
      bright = push_less(bright, hi, v);                  \
      dark = push_less(dark, v, lo);                      \
    }
    FAST_RING(RING_TEST)
#undef RING_TEST
    const bool corner = mask_col && y >= 3 && y < H - 3 &&
                        (has_run10(bright) || has_run10(dark));
    const float tr = sxx + syy;
    const float det = sxx * syy - sxy * sxy;
    const float disc = sqrtf(fmaxf(tr * tr * 0.25f - det, 0.f));
    const bool in_box = score_col && y >= 4 && y <= H - 4;
    const float sc = in_box ? (0.5f * tr - disc) / (2.f * 64.f) : 0.f;
    if (out_col && y < H) {
      const size_t o = (size_t)y * W + x;
      mask[o] = corner ? 1 : 0;
      score[o] = sc;
    }
  }
}

}  // namespace

extern "C" int plsvo_fast_score_levels(const void* const* imgs,
                                       void* const* masks,
                                       void* const* scores, const int* hw,
                                       int n, float thr, void* stream) {
  if (n <= 0) return 0;
  if (n > MAXL) return (int)cudaErrorInvalidValue;
  Levels L;
  L.n = n;
  L.task0[0] = 0;
  for (int i = 0; i < n; ++i) {
    L.img[i] = (const float*)imgs[i];
    L.mask[i] = (uint8_t*)masks[i];
    L.score[i] = (float*)scores[i];
    L.H[i] = hw[2 * i];
    L.W[i] = hw[2 * i + 1];
    L.strips[i] = (L.W[i] + OUT_W - 1) / OUT_W;
    L.task0[i + 1] = L.task0[i] + L.strips[i] * ((L.H[i] + TH - 1) / TH);
  }
  const int blocks = (L.task0[n] + WARPS - 1) / WARPS;
  fast_score_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(L, thr);
  return (int)cudaGetLastError();
}
