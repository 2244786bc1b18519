// The per-tile blend walks shared by the port's four blend kernels: the
// instance blend (blend_instances.cu, blend_instances_bwd.cu) and the
// dense-list blend (blend_tiles.cu, blend_tiles_bwd.cu). The two layouts
// differ only in where a tile's columns lie, so each kernel finds its
// tile's column range and calls forward_tile or backward_tile.
//
// The backward recomputes the forward walk from the forward's outputs, so
// both must make bit-identical decisions: which instance is skipped
// (power > 0, alpha < 1/255), and where a pixel's transmittance crosses
// 1e-4 and stops. Every operation up to alpha and the transmittance step is
// explicitly rounded (no FMA contraction), in the order of the plain
// PyTorch version, and all four kernels run it through splat_at and
// next_transmittance.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace blend {

constexpr int TILE = 16;
constexpr int BLOCK = TILE * TILE;  // threads per block = pixels per tile
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1.0e-4f;
constexpr int NG = 9;               // channels: mean xy, conic abc, rgb, opacity

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One instance at one pixel: offset from the pixel, Gaussian exponent, its
// exp, the unclamped alpha (raw) and the clamped one.
struct Splat {
  float dx, dy, power, expp, raw, alpha;
};

// Evaluates instance (mean, conic, opacity) at integer pixel (px, py).
// Returns true when the instance blends there: power <= 0 and the alpha
// clamped to 0.99 is at least 1/255. Invalid instances are staged with
// opacity 0 and so never blend.
__device__ __forceinline__ bool splat_at(float mx, float my, float ca,
                                         float cb, float cc, float op,
                                         float px, float py, Splat& s) {
  s.dx = __fsub_rn(mx, px);
  s.dy = __fsub_rn(my, py);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, s.dx), s.dx),
                               __fmul_rn(__fmul_rn(cc, s.dy), s.dy));
  s.power = __fsub_rn(__fmul_rn(-0.5f, quad),
                      __fmul_rn(__fmul_rn(cb, s.dx), s.dy));
  if (!(s.power <= 0.0f)) return false;
  s.expp = expf(s.power);
  s.raw = __fmul_rn(op, s.expp);
  s.alpha = s.raw > ALPHA_MAX ? ALPHA_MAX : s.raw;
  return s.alpha >= ALPHA_MIN;
}

// Transmittance after blending `alpha` over `T`. When it falls below
// T_EPS the instance is dropped and the pixel stops (renderCUDA,
// forward.cu:346-351).
__device__ __forceinline__ float next_transmittance(float T, float alpha) {
  return __fmul_rn(T, __fsub_rn(1.0f, alpha));
}

// Integer pixel coordinates (no +0.5) of this thread's pixel of tile t.
__device__ __forceinline__ void pixel_of(int t, int grid_x, float& px, float& py) {
  px = static_cast<float>((t % grid_x) * TILE + threadIdx.x % TILE);
  py = static_cast<float>((t / grid_x) * TILE + threadIdx.x / TILE);
}

// Stages column j's nine channels into column `slot` of sh; an invalid
// column gets opacity 0.
template <int W>
__device__ __forceinline__ void stage(float (&sh)[NG][W], int slot,
                                      const float* __restrict__ data,
                                      const float* __restrict__ valid,
                                      int64_t m, int64_t j) {
#pragma unroll
  for (int c = 0; c < 8; ++c) sh[c][slot] = data[c * m + j];
  sh[8][slot] = valid[j] > 0.0f ? data[8 * m + j] : 0.0f;
}

// Forward: the calling block (BLOCK threads, one per pixel of tile t)
// blends the columns [s, e) of a channel-major array front to back. Row c
// of the channels is data + c * m; column j blends only where valid[j] > 0.
// Writes img[t] = sum_i c_i a_i T_i + T_final * bg ([3, 256]) and
// tfin[t] = T_final ([256]).
//
// Columns are staged in shared memory in batches of BLOCK (coalesced per
// channel row) and broadcast to the tile's pixels; a pixel stops once its T
// fell below 1e-4, and the block leaves the range as soon as every pixel
// has (__syncthreads_count).
__device__ __forceinline__ void forward_tile(
    const float* __restrict__ data, const float* __restrict__ valid, int64_t m,
    int64_t s, int64_t e, int t, int grid_x, const float* __restrict__ bg,
    float* __restrict__ img, float* __restrict__ tfin) {
  __shared__ float sh[NG][BLOCK];
  const int tid = threadIdx.x;
  float px, py;
  pixel_of(t, grid_x, px, py);

  float T = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  bool done = false;

  for (int64_t base = s; base < e; base += BLOCK) {
    // also the barrier that protects sh from the previous batch's readers
    if (__syncthreads_count(done) == BLOCK) break;
    if (base + tid < e) stage(sh, tid, data, valid, m, base + tid);
    __syncthreads();
    const int n = static_cast<int>(clamp64(e - base, 0, BLOCK));
    for (int k = 0; k < n && !done; ++k) {
      Splat sp;
      if (!splat_at(sh[0][k], sh[1][k], sh[2][k], sh[3][k], sh[4][k], sh[8][k],
                    px, py, sp))
        continue;
      const float test_t = next_transmittance(T, sp.alpha);
      if (test_t < T_EPS) {
        done = true;
        continue;
      }
      const float w = __fmul_rn(sp.alpha, T);
      acc_r = __fadd_rn(acc_r, __fmul_rn(w, sh[5][k]));
      acc_g = __fadd_rn(acc_g, __fmul_rn(w, sh[6][k]));
      acc_b = __fadd_rn(acc_b, __fmul_rn(w, sh[7][k]));
      T = test_t;
    }
  }

  float* out = img + static_cast<int64_t>(t) * 3 * BLOCK;
  out[tid] = __fadd_rn(acc_r, __fmul_rn(T, bg[0]));
  out[BLOCK + tid] = __fadd_rn(acc_g, __fmul_rn(T, bg[1]));
  out[2 * BLOCK + tid] = __fadd_rn(acc_b, __fmul_rn(T, bg[2]));
  tfin[static_cast<int64_t>(t) * BLOCK + tid] = T;
}

constexpr int BATCH = 128;           // columns staged per round of the backward
constexpr int NWARP = BLOCK / 32;
constexpr unsigned FULL = 0xffffffffu;

// Backward: given the forward's img and T_final of tile t and their
// cotangents g_img, g_tfin, the calling block recomputes its pixels' walk
// over the columns [s, e) and stores, for each column j, the gradient of
// channels 0-8 in rows 0-8 of gout (row stride m) and zeros in rows
// 9..NOUT-1:
//
//   w_j      = alpha_j T_j
//   pu_j     = sum_{k <= j} w_k (g . c_k)
//   dalpha_j = T_j (g . c_j) - (g . img - pu_j) / (1 - alpha_j)
//              - g_tfin T_final / (1 - alpha_j)      (kept instances only)
//   g_power  = dalpha raw    (raw = op exp(power), unclamped: the gradient
//                             passes straight through the 0.99 clamp)
//   g_op     = dalpha exp(power)
//
// and the partials of power in mean and conic and w g for the colour,
// each summed over the tile's 256 pixels. Every column of [s, zero_end)
// is written: those after the block left its range (every pixel had
// terminated, so they never blended) and those in [e, zero_end) as zeros.
//
// Columns are staged in batches of BATCH; each pixel thread walks them with
// the forward's exact skip and termination decisions; a warp reduces a
// column's 9 partials by shuffles only when one of its lanes kept it, into
// a per-warp slot in shared memory; after each batch the 8 warps' slots are
// summed in a fixed order and stored with plain stores (the caller owns
// these columns: no atomics, and the result does not depend on scheduling).
template <int NOUT>
__device__ __forceinline__ void backward_tile(
    const float* __restrict__ data, const float* __restrict__ valid, int64_t m,
    int64_t s, int64_t e, int64_t zero_end, int t, int grid_x,
    const float* __restrict__ img, const float* __restrict__ tfin,
    const float* __restrict__ gimg, const float* __restrict__ gtfin,
    float* __restrict__ gout) {
  __shared__ float sh[NG][BATCH];
  __shared__ float part[NWARP][NG][BATCH];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float px, py;
  pixel_of(t, grid_x, px, py);

  const int64_t p3 = static_cast<int64_t>(t) * 3 * BLOCK + tid;
  const float g0 = gimg[p3], g1 = gimg[p3 + BLOCK], g2 = gimg[p3 + 2 * BLOCK];
  const float gdotimg = __fadd_rn(__fadd_rn(__fmul_rn(g0, img[p3]),
                                            __fmul_rn(g1, img[p3 + BLOCK])),
                                  __fmul_rn(g2, img[p3 + 2 * BLOCK]));
  const int64_t p1 = static_cast<int64_t>(t) * BLOCK + tid;
  const float gt_tn = __fmul_rn(gtfin[p1], tfin[p1]);

  float T = 1.0f;
  float pu = 0.0f;
  bool done = false;
  int64_t base = s;
  for (; base < e; base += BATCH) {
    // also the barrier that protects sh and part from the previous round
    if (__syncthreads_count(done) == BLOCK) break;
    if (tid < BATCH && base + tid < e) stage(sh, tid, data, valid, m, base + tid);
    __syncthreads();
    const int n = static_cast<int>(clamp64(e - base, 0, BATCH));
    for (int k = 0; k < n; ++k) {
      float v[NG];
#pragma unroll
      for (int c = 0; c < NG; ++c) v[c] = 0.0f;
      bool kept = false;
      Splat sp;
      if (!done && splat_at(sh[0][k], sh[1][k], sh[2][k], sh[3][k], sh[4][k],
                            sh[8][k], px, py, sp)) {
        const float test_t = next_transmittance(T, sp.alpha);
        if (test_t < T_EPS) {
          done = true;
        } else {
          kept = true;
          const float cr = sh[5][k], cg = sh[6][k], cb = sh[7][k];
          const float w = __fmul_rn(sp.alpha, T);
          const float gdotc = __fadd_rn(__fadd_rn(__fmul_rn(g0, cr), __fmul_rn(g1, cg)),
                                        __fmul_rn(g2, cb));
          pu = __fadd_rn(pu, __fmul_rn(w, gdotc));
          const float inv_om = __frcp_rn(__fsub_rn(1.0f, sp.alpha));
          const float dalpha = __fsub_rn(
              __fsub_rn(__fmul_rn(T, gdotc),
                        __fmul_rn(__fsub_rn(gdotimg, pu), inv_om)),
              __fmul_rn(gt_tn, inv_om));
          const float g_power = __fmul_rn(dalpha, sp.raw);
          const float a = sh[2][k], b = sh[3][k], c = sh[4][k];
          const float dx = sp.dx, dy = sp.dy;
          v[0] = g_power * (-a * dx - b * dy);
          v[1] = g_power * (-c * dy - b * dx);
          v[2] = g_power * (-0.5f * dx * dx);
          v[3] = g_power * (-dx * dy);
          v[4] = g_power * (-0.5f * dy * dy);
          v[5] = w * g0;
          v[6] = w * g1;
          v[7] = w * g2;
          v[8] = dalpha * sp.expp;
          T = test_t;
        }
      }
      if (__any_sync(FULL, kept)) {
#pragma unroll
        for (int c = 0; c < NG; ++c) {
          float x = v[c];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
          if (lane == 0) part[warp][c][k] = x;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int c = 0; c < NG; ++c) part[warp][c][k] = 0.0f;
      }
    }
    __syncthreads();
    // combine the warps in a fixed order and store this batch's columns
    for (int idx = tid; idx < NOUT * n; idx += BLOCK) {
      const int c = idx / n;
      const int k = idx - c * n;
      float acc = 0.0f;
      if (c < NG) {
#pragma unroll
        for (int w = 0; w < NWARP; ++w) acc += part[w][c][k];
      }
      gout[c * m + base + k] = acc;
    }
  }
  // the columns the walk did not store: after an early exit, and [e, zero_end)
  for (int64_t j = (base < e ? base : e) + tid; j < zero_end; j += BLOCK) {
#pragma unroll
    for (int c = 0; c < NOUT; ++c) gout[c * m + j] = 0.0f;
  }
}

}  // namespace blend
