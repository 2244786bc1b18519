// Instance-range alpha blend, backward: one 16x16 tile per block.
//
// Replaces the Pallas TPU kernel fateavatar_tpu/render/blend_instances.py
// ::_bwd_kernel (driven by _call_bwd, VJP _vjp_bwd). Same function: given
// the forward's img and T_final and their cotangents g_img, g_tfin, every
// tile recomputes its pixels' front-to-back walk over its [start, end)
// range and returns, per instance column j of the [16, M] input, the
// gradients of rows 0-8 (mean xy, conic abc, colour rgb, opacity), each
// summed over the tile's 256 pixels (the formulas are in
// blend_common.cuh::backward_tile, shared with blend_tiles_bwd.cu). Rows
// 9-15 are written as zeros.
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
// termination decisions; a warp reduces an instance's 9 partials by
// shuffles only when one of its lanes kept the instance, and writes them to
// a per-warp slot in shared memory; after each batch the 8 warps' slots are
// summed in a fixed order and stored. The block leaves its range once every
// pixel has terminated and zero-fills the rest.

#include "blend_common.cuh"

namespace {

using namespace blend;

constexpr int ROW = 16;              // rows of the [16, M] arrays

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
  const int t = blockIdx.x;
  // the forward's clamped range; ranges of a compact layout are
  // consecutive, so each column belongs to one block
  const int64_t s = clamp64(tile_starts[t], 0, m);
  const int64_t e = clamp64(tile_starts[t + 1], s, m);
  backward_tile<ROW>(inst, inst + 9 * m, m, s, e, e, t, grid_x, img, tfin, gimg,
                     gtfin, gout);
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
