// Instance-range alpha blend, backward: one 16x16 tile per block.
//
// Replaces the Pallas TPU kernel fateavatar_tpu/render/blend_instances.py
// ::_bwd_kernel (driven by _call_bwd, VJP _vjp_bwd). Same function: given
// the forward's img and T_final and their cotangents g_img, g_tfin, every
// tile recomputes its pixels' front-to-back walk over its [start, end)
// range and returns, per instance column j of the [16, M] input, the
// gradients of rows 0-8 (mean xy, conic abc, colour rgb, opacity):
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
// each summed over the tile's 256 pixels. Rows 9-15 are written as zeros.
//
// Ownership: in the compact layout each column lies in exactly one tile's
// range, so the tile's block stores its columns' sums with plain stores (no
// atomics; the result does not depend on scheduling). Columns outside every
// range (before tile_starts[0] and from tile_starts[T] on, including the
// padding render() appends) are zeroed by extra blocks. Every element of the
// output is written on every call, whatever the buffer held before.
//
// What bounds it on an H100: like the forward, each (instance, pixel) pair a
// pixel reaches costs ~60 fp32 operations and one exp, against 40 B read
// per instance and 36 B per pixel, so it is bound by arithmetic. What the
// design does about it: instances are staged in shared memory in batches of
// 128; each pixel thread walks them with the forward's exact skip and
// termination decisions (blend_common.cuh); a warp reduces an instance's 9
// partials by shuffles only when one of its lanes kept the instance, and
// writes them to a per-warp slot in shared memory; after each batch the 8
// warps' slots are summed in a fixed order and stored. The block leaves its
// range once every pixel has terminated and zero-fills the rest.

#include "blend_common.cuh"

namespace {

using namespace blend;

constexpr int BATCH = 128;           // instances staged per round
constexpr int NWARP = BLOCK / 32;
constexpr int NG = 9;                // gradient rows: mean xy, conic, rgb, opacity
constexpr int ROW = 16;              // rows of the [16, M] arrays
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(BLOCK)
blend_instances_bwd_kernel(const float* __restrict__ inst, int64_t m,
                           const int* __restrict__ tile_starts,
                           const float* __restrict__ img,
                           const float* __restrict__ tfin,
                           const float* __restrict__ gimg,
                           const float* __restrict__ gtfin,
                           float* __restrict__ gout,
                           int num_tiles, int grid_x) {
  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) >= num_tiles) {
    // zero the columns no tile owns
    const int64_t lo = clamp64(tile_starts[0], 0, m);
    const int64_t hi = clamp64(tile_starts[num_tiles], lo, m);
    const int64_t stride = static_cast<int64_t>(gridDim.x - num_tiles) * BLOCK;
    for (int64_t j = static_cast<int64_t>(blockIdx.x - num_tiles) * BLOCK + tid;
         j < m; j += stride) {
      if (j < lo || j >= hi) {
#pragma unroll
        for (int c = 0; c < ROW; ++c) gout[c * m + j] = 0.0f;
      }
    }
    return;
  }

  __shared__ float sh[NG][BATCH];
  __shared__ float part[NWARP][NG][BATCH];
  const int t = blockIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float px = static_cast<float>((t % grid_x) * TILE + tid % TILE);
  const float py = static_cast<float>((t / grid_x) * TILE + tid / TILE);
  // the forward's clamped range; ranges of a compact layout are
  // consecutive, so each column belongs to one block
  const int64_t s = clamp64(tile_starts[t], 0, m);
  const int64_t e = clamp64(tile_starts[t + 1], s, m);

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
    if (tid < BATCH) {
      const int64_t j = base + tid;
      if (j < e) {
#pragma unroll
        for (int c = 0; c < 8; ++c) sh[c][tid] = inst[c * m + j];
        sh[8][tid] = inst[9 * m + j] > 0.0f ? inst[8 * m + j] : 0.0f;
      }
    }
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
    for (int idx = tid; idx < ROW * n; idx += BLOCK) {
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
  // instances after the block left its range: every pixel had terminated,
  // so they were never blended and their gradient is zero
  for (int64_t j = base + tid; j < e; j += BLOCK) {
#pragma unroll
    for (int c = 0; c < ROW; ++c) gout[c * m + j] = 0.0f;
  }
}

}  // namespace

// inst [16, m] float32, tile_starts [num_tiles + 1] int32 (non-decreasing),
// img [num_tiles, 3, 256], t_final [num_tiles, 256], g_img and g_tfin of the
// same shapes, all float32; writes every element of gout [16, m]. Launches
// on `stream`, does not synchronise, and returns cudaGetLastError() of the
// launch.
extern "C" int blend_instances_bwd(const float* inst, int64_t m,
                                   const int* tile_starts, const float* img,
                                   const float* tfin, const float* gimg,
                                   const float* gtfin, float* gout,
                                   int num_tiles, int grid_x,
                                   cudaStream_t stream) {
  const int64_t zero_blocks = m > 0 ? (m + BLOCK - 1) / BLOCK : 0;
  const int64_t extra = zero_blocks < 1024 ? zero_blocks : 1024;
  const int64_t grid = num_tiles + extra;
  if (grid == 0) return static_cast<int>(cudaSuccess);
  blend_instances_bwd_kernel<<<static_cast<unsigned>(grid), BLOCK, 0, stream>>>(
      inst, m, tile_starts, img, tfin, gimg, gtfin, gout, num_tiles, grid_x);
  return static_cast<int>(cudaGetLastError());
}
