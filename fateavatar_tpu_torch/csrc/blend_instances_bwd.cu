// Instance-range alpha blend, backward: the segmented walk.
//
// Replaces the Pallas TPU kernel fateavatar_tpu/render/blend_instances.py
// ::_bwd_kernel (driven by _call_bwd, VJP _vjp_bwd). Same function: given
// the forward's img and T_final and their cotangents g_img, g_tfin, every
// tile recomputes its pixels' front-to-back walk over its [start, end)
// range and returns, per instance column j of the [16, M] input, the
// gradients of rows 0-8 (mean xy, conic abc, colour rgb, opacity), each
// summed over the tile's 256 pixels (the formulas are in
// blend_common.cuh::backward_tile). Rows 9-15 are written as zeros.
//
// What bounds it on an H100: like the forward, each (instance, pixel) pair
// a pixel reaches costs ~14 fp32 operations and one exp, and each pair it
// blends ~40 more (dalpha, the 9 partials and their warp reduction),
// against 40 B read per instance, 32 B per pixel and 64 B written per
// column: arithmetic again, ~0.012 ms for a full-width training frame. The
// per-tile walk (one block per tile, the earlier design) was held to ~0.5% of
// that by its longest tile: ~8,300 instances walked by one block, with a
// warp vote and 9 x 5 shuffle-adds per instance in the same serial chain.
//
// What this design does about it: the segmented walk of blend_common.cuh,
// the same segments and entry transmittances as the forward
// (blend_instances.cu), so the backward drops exactly the instances the
// forward dropped. Three launches, queued by one host call on one stream:
//   plan      one block: each tile's first unit, each unit's tile;
//   products  pass A: per unit and pixel, the product P of (1 - alpha) and
//             U = sum alpha_j T_j (g . c_j), both from T = 1;
//   walk      pass B: each unit folds the earlier segments' P and U into
//             its entry T = q_in and prefix pu = pu_in, then runs
//             backward_tile over its 256 columns (staging in batches of
//             128, a warp reduction per column one of its lanes kept, the
//             8 warps combined in a fixed order).
// No block walks more than 256 columns, so the longest tile spreads over
// ~33 blocks.
//
// Ownership: each column lies in exactly one unit, which stores its sums
// with plain stores (no atomics; the result does not depend on
// scheduling), zeros after its pixels all stopped. Columns outside every
// range (before tile_starts[0] and from tile_starts[T] on, including the
// padding render() appends) are zeroed by extra blocks of the walk, and so,
// with the early exit of t_cutoff > 1e-4, are the columns of each range
// past the forward's cut (the Pallas kernel's zero-fill of the windows it
// skipped). Every element of the output is written on every call, whatever
// the buffer held.

#include "blend_common.cuh"

namespace {

using namespace blend;

constexpr int ROW = 16;              // rows of the [16, M] arrays

__global__ void __launch_bounds__(PLAN_THREADS)
blend_instances_bwd_plan(const int* __restrict__ tile_starts, int64_t m, int num_tiles,
                         int cap, const int* __restrict__ cut, int* __restrict__ unit_start,
                         int* __restrict__ unit_tile) {
  plan_segments(CompactRanges{tile_starts, m, cut}, num_tiles, cap, unit_start, unit_tile);
}

// row 9 of the [16, M] array is the valid flag
__global__ void __launch_bounds__(BLOCK)
blend_instances_bwd_products(const float* __restrict__ inst, int64_t m,
                             const int* __restrict__ tile_starts, int num_tiles, int grid_x,
                             const int* __restrict__ cut, const int* __restrict__ unit_start,
                             const int* __restrict__ unit_tile,
                             const float* __restrict__ gimg, float* __restrict__ prod,
                             float* __restrict__ usum) {
  Unit un;
  const int u = blockIdx.x;
  const CompactRanges tiles{tile_starts, m, cut};
  if (!unit_of(u, tiles, num_tiles, unit_start, unit_tile, un)) return;
  segment_products<true>(inst, inst + 9 * m, m, un, u, grid_x, gimg, prod, usum);
}

// Blocks [0, cap) are the units; blocks from cap on zero the columns no
// tile owns and, with `cut`, the columns [cut[t], end) of each tile's range
// that the early exit skipped.
__global__ void __launch_bounds__(BLOCK)
blend_instances_bwd_walk(const float* __restrict__ inst, int64_t m,
                         const int* __restrict__ tile_starts, int num_tiles, int grid_x,
                         int cap, const int* __restrict__ cut, const int* __restrict__ unit_start,
                         const int* __restrict__ unit_tile, const float* __restrict__ img,
                         const float* __restrict__ tfin, const float* __restrict__ gimg,
                         const float* __restrict__ gtfin, const float* __restrict__ prod,
                         const float* __restrict__ usum, float* __restrict__ gout) {
  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) >= cap) {
    const int64_t lo = clamp64(tile_starts[0], 0, m);
    const int64_t hi = clamp64(tile_starts[num_tiles], lo, m);
    const int64_t stride = static_cast<int64_t>(gridDim.x - cap) * BLOCK;
    for (int64_t j = static_cast<int64_t>(blockIdx.x - cap) * BLOCK + tid; j < m;
         j += stride) {
      if (j < lo || j >= hi) {
#pragma unroll
        for (int c = 0; c < ROW; ++c) gout[c * m + j] = 0.0f;
      }
    }
    if (cut != nullptr) {
      const CompactRanges whole{tile_starts, m};
      for (int t = blockIdx.x - cap; t < num_tiles; t += gridDim.x - cap) {
        int64_t s, e;
        whole(t, s, e);
        for (int64_t j = clamp64(cut[t], s, e) + tid; j < e; j += BLOCK) {
#pragma unroll
          for (int c = 0; c < ROW; ++c) gout[c * m + j] = 0.0f;
        }
      }
    }
    return;
  }
  Unit un;
  const CompactRanges tiles{tile_starts, m, cut};
  if (!unit_of(blockIdx.x, tiles, num_tiles, unit_start, unit_tile, un)) return;
  backward_segment<ROW>(inst, inst + 9 * m, m, un, grid_x, img, tfin, gimg, gtfin, prod,
                        usum, gout);
}

}  // namespace

// Scratch floats the backward needs for m columns and num_tiles tiles: per
// unit, pass A's P and U ([2, 256]), then unit_start [T + 1] and unit_tile
// [units] as int32. The wrapper allocates its scratch from this number.
extern "C" int64_t blend_instances_bwd_scratch_floats(int64_t m, int num_tiles) {
  const int64_t cap = unit_capacity(m, num_tiles);
  return cap * 2 * BLOCK + num_tiles + 1 + cap;
}

// inst [16, m] float32, tile_starts [num_tiles + 1] int32 (non-decreasing),
// img [num_tiles, 3, 256], t_final [num_tiles, 256], g_img and g_tfin of the
// same shapes, all float32, scratch of scratch_floats >=
// blend_instances_bwd_scratch_floats(m, num_tiles) floats; writes every
// element of gout [16, m]. `cut` [num_tiles] (the forward's, t_cutoff >
// 1e-4) or nullptr: with it each tile's range ends at cut[t], and the
// columns past it are zeros. Queues its three launches on `stream`, does not
// synchronise, and returns the first cudaGetLastError() that is not
// cudaSuccess (cudaErrorInvalidValue for a short scratch).
extern "C" int blend_instances_bwd(const float* inst, int64_t m, const int* tile_starts,
                                   const float* img, const float* tfin, const float* gimg,
                                   const float* gtfin, float* gout, int num_tiles,
                                   int grid_x, float* scratch, int64_t scratch_floats,
                                   const int* cut, cudaStream_t stream) {
  const int64_t cap = num_tiles > 0 ? unit_capacity(m, num_tiles) : 0;
  const int64_t zero_blocks = m > 0 ? (m + BLOCK - 1) / BLOCK : 0;
  const int64_t extra = zero_blocks < 1024 ? zero_blocks : 1024;
  if (cap + extra == 0) return static_cast<int>(cudaSuccess);
  int err;
  float* prod = scratch;
  float* usum = prod + cap * BLOCK;
  int* unit_start = reinterpret_cast<int*>(usum + cap * BLOCK);
  int* unit_tile = unit_start + num_tiles + 1;
  if (num_tiles > 0) {
    if (scratch_floats < blend_instances_bwd_scratch_floats(m, num_tiles))
      return static_cast<int>(cudaErrorInvalidValue);
    blend_instances_bwd_plan<<<1, PLAN_THREADS, 0, stream>>>(
        tile_starts, m, num_tiles, static_cast<int>(cap), cut, unit_start, unit_tile);
    if ((err = last_error()) != 0) return err;
    blend_instances_bwd_products<<<static_cast<unsigned>(cap), BLOCK, 0, stream>>>(
        inst, m, tile_starts, num_tiles, grid_x, cut, unit_start, unit_tile, gimg, prod, usum);
    if ((err = last_error()) != 0) return err;
  }
  blend_instances_bwd_walk<<<static_cast<unsigned>(cap + extra), BLOCK, 0, stream>>>(
      inst, m, tile_starts, num_tiles, grid_x, static_cast<int>(cap), cut, unit_start,
      unit_tile, img, tfin, gimg, gtfin, prod, usum, gout);
  return last_error();
}
