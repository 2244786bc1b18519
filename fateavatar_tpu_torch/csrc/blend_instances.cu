// Instance-range alpha blend, forward: the segmented walk.
//
// Replaces the Pallas TPU kernel fateavatar_tpu/render/blend_instances.py
// ::_fwd_kernel (driven by _call_fwd). Same function: every tile blends its
// [tile_starts[t], tile_starts[t+1]) range of the flat depth-sorted instance
// array front to back, with renderCUDA's semantics (forward.cu:289-374):
// skip on power > 0 or alpha < 1/255, alpha clamped to 0.99, and the
// instance that would take T below 1e-4 is dropped and the pixel stops.
// Output img = sum_i c_i a_i T_i + T_final * bg and T_final.
//
// What bounds it on an H100: each binned instance is read once per tile
// (10 channels used, 40 B), each pixel writes 16 B (rgb + T), and every
// (instance, pixel) pair the pixel reaches costs ~20 fp32 operations plus
// one exp. A frame has ~10^2 pairs per byte, so the work is arithmetic; at
// 67 TFLOP/s a full-width frame needs ~0.013 ms. What held the per-tile
// walk (one block per tile, this kernel's design before the segmented
// walk) far from that was load imbalance: the longest tile walked
// ~8,700 instances alone on one SM while the mean tile holds ~180, and one
// dependent chain per pixel thread with a single block on the SM costs
// ~200 cycles per instance.
//
// What this design does about it (blend_common.cuh, "the segmented walk"):
// no block walks a whole tile. Each tile's range is cut into segments of
// SEG = 256 columns, one block each, so every block does at most 256
// columns and the longest tile spreads over ~35 blocks. Four launches,
// queued by one host call on one stream:
//   plan      one block: each tile's first unit, each unit's tile;
//   products  pass A: each unit's product of (1 - alpha) per pixel;
//   walk      pass B: each unit folds the earlier segments' products into
//             its entry transmittance and walks its 256 columns exactly,
//             writing a partial colour (and T_final from the pixel's last
//             live segment);
//   combine   each tile's partials summed in segment order, + T_final * bg.
// Pass A evaluates every (instance, pixel) pair of a range, also those past
// a pixel's termination, which the per-tile walk skipped; that is the price
// of not knowing where a pixel stops before the earlier segments are done.
// With t_cutoff > 1e-4 three launches go first: the cut (blend_common.cuh,
// "the early exit": the window plan, each 128-column window's products,
// each tile's scan), after which every launch reads each tile's range as
// ending at its cut, so no unit exists past it.
// Instance channels are staged in shared memory per unit (coalesced per
// channel row of the [16, M] array) and broadcast to the 256 pixel threads;
// invalid / sentinel rows (valid = 0) are staged with opacity 0, which the
// 1/255 test skips. The outputs do not depend on the order blocks run in.
//
// The arithmetic up to alpha and the transmittance step uses explicitly
// rounded operations (no FMA contraction) in the order of the plain PyTorch
// version, so both compute the same bits for power and alpha and never
// disagree on the 1/255 and power > 0 tests; they differ only in the order
// of the transmittance product.

#include "blend_common.cuh"

namespace {

using namespace blend;

// The early exit's cut (blend_common.cuh, "the early exit"): the window
// plan, each window's products, then each tile's scan.
__global__ void __launch_bounds__(PLAN_THREADS)
blend_instances_cut_plan(const int* __restrict__ tile_starts, int64_t m, int num_tiles, int cap,
                         int* __restrict__ unit_start, int* __restrict__ unit_tile) {
  plan_segments<WindowRanges, CUT_WINDOW>(WindowRanges{CompactRanges{tile_starts, m}},
                                          num_tiles, cap, unit_start, unit_tile);
}

__global__ void __launch_bounds__(BLOCK)
blend_instances_cut_products(const float* __restrict__ inst, int64_t m,
                             const int* __restrict__ tile_starts, int num_tiles, int grid_x,
                             const int* __restrict__ unit_start,
                             const int* __restrict__ unit_tile, float* __restrict__ prod) {
  Unit un;
  const int u = blockIdx.x;
  const CompactRanges tiles{tile_starts, m};
  if (!unit_of<WindowRanges, CUT_WINDOW>(u, WindowRanges{tiles}, num_tiles, unit_start,
                                         unit_tile, un))
    return;
  window_products(inst, inst + 9 * m, m, un, u, grid_x, tiles, prod);
}

__global__ void __launch_bounds__(BLOCK)
blend_instances_cut_scan(const int* __restrict__ tile_starts, int64_t m,
                         const int* __restrict__ unit_start, const float* __restrict__ prod,
                         float cutoff, int* __restrict__ cut) {
  cut_scan(blockIdx.x, CompactRanges{tile_starts, m}, unit_start, prod, cutoff, cut);
}

__global__ void __launch_bounds__(PLAN_THREADS)
blend_instances_fwd_plan(const int* __restrict__ tile_starts, int64_t m, int num_tiles,
                         int cap, const int* __restrict__ cut, int* __restrict__ unit_start,
                         int* __restrict__ unit_tile) {
  plan_segments(CompactRanges{tile_starts, m, cut}, num_tiles, cap, unit_start, unit_tile);
}

// row 9 of the [16, M] array is the valid flag
__global__ void __launch_bounds__(BLOCK)
blend_instances_fwd_products(const float* __restrict__ inst, int64_t m,
                             const int* __restrict__ tile_starts, int num_tiles, int grid_x,
                             const int* __restrict__ cut, const int* __restrict__ unit_start,
                             const int* __restrict__ unit_tile, float* __restrict__ prod) {
  Unit un;
  const int u = blockIdx.x;
  const CompactRanges tiles{tile_starts, m, cut};
  if (!unit_of(u, tiles, num_tiles, unit_start, unit_tile, un)) return;
  segment_products<false>(inst, inst + 9 * m, m, un, u, grid_x, nullptr, prod, nullptr);
}

__global__ void __launch_bounds__(BLOCK)
blend_instances_fwd_walk(const float* __restrict__ inst, int64_t m,
                         const int* __restrict__ tile_starts, int num_tiles, int grid_x,
                         const int* __restrict__ cut, const int* __restrict__ unit_start,
                         const int* __restrict__ unit_tile, const float* __restrict__ prod,
                         float* __restrict__ part, float* __restrict__ tfin) {
  Unit un;
  const int u = blockIdx.x;
  const CompactRanges tiles{tile_starts, m, cut};
  if (!unit_of(u, tiles, num_tiles, unit_start, unit_tile, un)) return;
  forward_segment(inst, inst + 9 * m, m, un, u, grid_x, prod, part, tfin);
}

__global__ void __launch_bounds__(BLOCK)
blend_instances_fwd_combine(const int* __restrict__ unit_start, const float* __restrict__ part,
                            const float* __restrict__ bg, float* __restrict__ img,
                            float* __restrict__ tfin) {
  combine_segments(blockIdx.x, unit_start, part, bg, img, tfin);
}

}  // namespace

// Scratch floats the cut needs for m columns and num_tiles tiles: per
// window, its products ([256]), then the window plan's unit_start [T + 1]
// and unit_tile [windows] as int32.
extern "C" int64_t blend_instances_cut_scratch_floats(int64_t m, int num_tiles) {
  const int64_t cap = window_capacity(m, num_tiles);
  return cap * BLOCK + num_tiles + 1 + cap;
}

// Scratch floats the forward needs for m columns and num_tiles tiles: per
// unit, pass A's product and the partial colour ([4, 256]), then
// unit_start [T + 1] and unit_tile [units] as int32. The wrapper allocates
// its scratch from this number.
extern "C" int64_t blend_instances_fwd_scratch_floats(int64_t m, int num_tiles) {
  const int64_t cap = unit_capacity(m, num_tiles);
  return cap * 4 * BLOCK + num_tiles + 1 + cap;
}

// The early exit's cut alone: cut [num_tiles] int32, each tile's cut column
// for `cutoff`, with a scratch of scratch_floats >=
// blend_instances_cut_scratch_floats(m, num_tiles) floats. Three launches
// on `stream`; the forward below queues the same launches itself.
extern "C" int blend_instances_cut(const float* inst, int64_t m, const int* tile_starts,
                                   int num_tiles, int grid_x, float cutoff, int* cut,
                                   float* scratch, int64_t scratch_floats, cudaStream_t stream) {
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  if (scratch_floats < blend_instances_cut_scratch_floats(m, num_tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t cap = window_capacity(m, num_tiles);
  float* prod = scratch;
  int* unit_start = reinterpret_cast<int*>(prod + cap * BLOCK);
  int* unit_tile = unit_start + num_tiles + 1;
  int err;
  blend_instances_cut_plan<<<1, PLAN_THREADS, 0, stream>>>(
      tile_starts, m, num_tiles, static_cast<int>(cap), unit_start, unit_tile);
  if ((err = last_error()) != 0) return err;
  blend_instances_cut_products<<<static_cast<unsigned>(cap), BLOCK, 0, stream>>>(
      inst, m, tile_starts, num_tiles, grid_x, unit_start, unit_tile, prod);
  if ((err = last_error()) != 0) return err;
  blend_instances_cut_scan<<<num_tiles, BLOCK, 0, stream>>>(tile_starts, m, unit_start, prod,
                                                            cutoff, cut);
  return last_error();
}

// inst [16, m] float32 (row c = channel c), tile_starts [num_tiles + 1]
// int32 (non-decreasing), bg [3] float32, scratch of scratch_floats >=
// blend_instances_fwd_scratch_floats(m, num_tiles) floats; writes img
// [num_tiles, 3, 256] and t_final [num_tiles, 256]. With cut != nullptr
// (t_cutoff > 1e-4) it first writes each tile's cut column for `cutoff`
// into cut [num_tiles], with the cut's own scratch (cut_scratch_floats >=
// blend_instances_cut_scratch_floats(m, num_tiles)), and blends the ranges
// up to it; with cut == nullptr it ignores `cutoff` and the cut scratch. Queues its four launches (seven with the cut) on
// `stream`, does not synchronise, and returns the first cudaGetLastError()
// that is not cudaSuccess (cudaErrorInvalidValue for a short scratch).
extern "C" int blend_instances_fwd(const float* inst, int64_t m, const int* tile_starts,
                                   const float* bg, float* img, float* tfin, int num_tiles,
                                   int grid_x, float* scratch, int64_t scratch_floats,
                                   float cutoff, int* cut, float* cut_scratch,
                                   int64_t cut_scratch_floats, cudaStream_t stream) {
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  if (scratch_floats < blend_instances_fwd_scratch_floats(m, num_tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t cap = unit_capacity(m, num_tiles);
  float* prod = scratch;
  float* part = prod + cap * BLOCK;
  int* unit_start = reinterpret_cast<int*>(part + cap * 3 * BLOCK);
  int* unit_tile = unit_start + num_tiles + 1;
  const unsigned units = static_cast<unsigned>(cap);
  int err;
  if (cut != nullptr && (err = blend_instances_cut(inst, m, tile_starts, num_tiles, grid_x,
                                                    cutoff, cut, cut_scratch,
                                                    cut_scratch_floats, stream)) != 0)
    return err;
  blend_instances_fwd_plan<<<1, PLAN_THREADS, 0, stream>>>(
      tile_starts, m, num_tiles, static_cast<int>(cap), cut, unit_start, unit_tile);
  if ((err = last_error()) != 0) return err;
  blend_instances_fwd_products<<<units, BLOCK, 0, stream>>>(
      inst, m, tile_starts, num_tiles, grid_x, cut, unit_start, unit_tile, prod);
  if ((err = last_error()) != 0) return err;
  blend_instances_fwd_walk<<<units, BLOCK, 0, stream>>>(
      inst, m, tile_starts, num_tiles, grid_x, cut, unit_start, unit_tile, prod, part, tfin);
  if ((err = last_error()) != 0) return err;
  blend_instances_fwd_combine<<<num_tiles, BLOCK, 0, stream>>>(unit_start, part, bg, img,
                                                                tfin);
  return last_error();
}
