// Dense-list alpha blend, backward: the segmented walk and a zero tail.
//
// Replaces the Pallas TPU kernel fateavatar_tpu/render/blend_tiles.py
// ::_bwd_kernel (driven by _pallas_call_bwd, VJP _blend_bwd). Same
// function: given the forward's img and T_final and their cotangents
// g_img, g_tfin, tile t recomputes its pixels' front-to-back walk over the
// first min(counts[t], K) slots of its list and returns, per slot, the
// gradients of its 9 channels (mean xy, conic abc, colour rgb, opacity),
// each summed over the tile's 256 pixels, and zeros for the slots past the
// list (blend_tiles.py:273-276). The Pallas kernel takes the colour prefix
// P_j and the suffix S_j = img - P_j per channel (blend_tiles.py:308-331);
// here the same dalpha comes from the dot products g . img - pu_j with
// pu_j = sum_{k <= j} w_k (g . c_k), the walk of the instance backward
// (blend_common.cuh::backward_tile), which also recomputes the forward's
// skip and termination decisions bit for bit.
//
// What bounds it on an H100: each (slot, pixel) pair a pixel reaches costs
// ~14 fp32 operations to recompute alpha, and each pair it blends ~40 more
// (dalpha, 9 partials, the warp reduction), ~0.012 ms of arithmetic on a
// full-width training frame; but the output is the whole [9, T*K]
// gradient, 36 B for every slot, and with K sized for the longest tile
// ~98.6% of the slots lie past their list. Writing them is ~465 MB at full
// width, at least 0.14 ms at 3.35 TB/s: the zero tail is the bound, and
// most of this kernel's time. What held the per-tile walk (one block per
// tile, this kernel's design before the segmented walk) at 5.8% of that
// bound was the longest tile: ~10,200 slots walked by one block.
//
// What this design does about it: the segmented walk of blend_common.cuh,
// the same segments and entry transmittances as the forward
// (blend_tiles.cu), so the backward drops exactly the slots the forward
// dropped, and the zero tail as a role of its own. Four launches, queued by
// one host call on one stream:
//   plan      one block: each tile's first unit, each unit's tile;
//   products  pass A: per unit and pixel, the product P of (1 - alpha) and
//             U = sum alpha_j T_j (g . c_j), both from T = 1;
//   walk      pass B: each unit folds the earlier segments' P and U into
//             its entry T = q_in and prefix pu = pu_in, then runs
//             backward_tile over its 256 slots (staging in batches of 128,
//             a warp reduction per slot one of its lanes kept, the 8 warps
//             combined in a fixed order);
//   zero      one block per (tile, row): zeros from the end of the tile's
//             list to the end of its K slots, 16-byte stores from the first
//             aligned column on (t*K is a multiple of chunk = 64 floats on
//             the main path), at the card's write bandwidth.
// Passes A and B loop over the plan's unit count on the grid the card holds
// at once (see blend_tiles.cu); the scratch follows the bound of T ceil(K /
// 256) units, 2 KiB each.
//
// Ownership: each slot of a list lies in exactly one unit, which stores its
// sums with plain stores (no atomics; the result does not depend on
// scheduling), zeros after its pixels all stopped; each slot past a list
// belongs to the zero role. Every element of the output is written on
// every call, whatever the buffer held.

#include "blend_common.cuh"

namespace {

using namespace blend;

__global__ void __launch_bounds__(PLAN_THREADS)
blend_tiles_bwd_plan(const int* __restrict__ counts, int k, int num_tiles, int cap,
                     int* __restrict__ unit_start, int* __restrict__ unit_tile) {
  plan_segments(DenseRanges{counts, k}, num_tiles, cap, unit_start, unit_tile);
}

__global__ void __launch_bounds__(BLOCK)
blend_tiles_bwd_products(const float* __restrict__ data, const float* __restrict__ valid,
                         int64_t m, const int* __restrict__ counts, int k, int num_tiles,
                         int grid_x, const int* __restrict__ unit_start,
                         const int* __restrict__ unit_tile, const float* __restrict__ gimg,
                         float* __restrict__ prod, float* __restrict__ usum) {
  for_each_unit(DenseRanges{counts, k}, num_tiles, unit_start, unit_tile,
                [&](const Unit& un, int u) {
                  segment_products<true>(data, valid, m, un, u, grid_x, gimg, prod, usum);
                });
}

__global__ void __launch_bounds__(BLOCK)
blend_tiles_bwd_walk(const float* __restrict__ data, const float* __restrict__ valid,
                     int64_t m, const int* __restrict__ counts, int k, int num_tiles,
                     int grid_x, const int* __restrict__ unit_start,
                     const int* __restrict__ unit_tile, const float* __restrict__ img,
                     const float* __restrict__ tfin, const float* __restrict__ gimg,
                     const float* __restrict__ gtfin, const float* __restrict__ prod,
                     const float* __restrict__ usum, float* __restrict__ gout) {
  for_each_unit(DenseRanges{counts, k}, num_tiles, unit_start, unit_tile,
                [&](const Unit& un, int) {
                  backward_segment<NG>(data, valid, m, un, grid_x, img, tfin, gimg, gtfin,
                                       prod, usum, gout);
                });
}

// Block (t, c): row c of tile t's slots past its list, [e_t, (t + 1) K).
__global__ void __launch_bounds__(BLOCK)
blend_tiles_bwd_zero(const int* __restrict__ counts, int k, int64_t m,
                     float* __restrict__ gout) {
  int64_t s, e;
  DenseRanges{counts, k}(blockIdx.x, s, e);
  zero_range(gout + blockIdx.y * m, e, s + k);
}

}  // namespace

// Scratch floats the backward needs for m = num_tiles * k columns: per unit
// of dense_unit_capacity, pass A's P and U ([2, 256]), then unit_start
// [T + 1] and unit_tile [units] as int32. The wrapper allocates its scratch
// from this number.
extern "C" int64_t blend_tiles_bwd_scratch_floats(int64_t m, int num_tiles) {
  const int64_t cap = dense_unit_capacity(m, num_tiles);
  return cap * 2 * BLOCK + num_tiles + 1 + cap;
}

// data [9, m] float32 (m = num_tiles * k), valid [m] float32, counts
// [num_tiles] int32, img [num_tiles, 3, 256], t_final [num_tiles, 256],
// g_img and g_tfin of the same shapes, all float32, scratch of
// scratch_floats >= blend_tiles_bwd_scratch_floats(m, num_tiles) floats;
// writes every element of gout [9, m]. Queues its four launches on
// `stream`, does not synchronise, and returns the first cudaGetLastError()
// that is not cudaSuccess (cudaErrorInvalidValue for a short scratch).
extern "C" int blend_tiles_bwd(const float* data, const float* valid, int64_t m,
                               const int* counts, int k, const float* img,
                               const float* tfin, const float* gimg, const float* gtfin,
                               float* gout, int num_tiles, int grid_x, float* scratch,
                               int64_t scratch_floats, cudaStream_t stream) {
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  if (scratch_floats < blend_tiles_bwd_scratch_floats(m, num_tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t cap = dense_unit_capacity(m, num_tiles);
  float* prod = scratch;
  float* usum = prod + cap * BLOCK;
  int* unit_start = reinterpret_cast<int*>(usum + cap * BLOCK);
  int* unit_tile = unit_start + num_tiles + 1;
  int err;
  blend_tiles_bwd_plan<<<1, PLAN_THREADS, 0, stream>>>(
      counts, k, num_tiles, static_cast<int>(cap), unit_start, unit_tile);
  if ((err = last_error()) != 0) return err;
  blend_tiles_bwd_products<<<resident_grid(blend_tiles_bwd_products), BLOCK, 0, stream>>>(
      data, valid, m, counts, k, num_tiles, grid_x, unit_start, unit_tile, gimg, prod, usum);
  if ((err = last_error()) != 0) return err;
  blend_tiles_bwd_walk<<<resident_grid(blend_tiles_bwd_walk), BLOCK, 0, stream>>>(
      data, valid, m, counts, k, num_tiles, grid_x, unit_start, unit_tile, img, tfin, gimg,
      gtfin, prod, usum, gout);
  if ((err = last_error()) != 0) return err;
  blend_tiles_bwd_zero<<<dim3(num_tiles, NG), BLOCK, 0, stream>>>(counts, k, m, gout);
  return last_error();
}
