// Dense-list alpha blend, forward: the segmented walk.
//
// Replaces the Pallas TPU kernel fateavatar_tpu/render/blend_tiles.py
// ::_fwd_kernel (driven by _pallas_call_fwd). Same function: tile t walks
// its own list of K slots, the first min(counts[t], K) of them, front to
// back with renderCUDA's semantics (forward.cu:289-374): skip on power > 0
// or alpha < 1/255 or an empty slot, alpha clamped to 0.99, and the
// instance that would take T below 1e-4 is dropped and the pixel stops.
// Output img = sum_i c_i a_i T_i + T_final * bg and T_final.
//
// Layout: the Pallas kernel reads five [T, K, d] arrays; here render()
// gathers the lists into one channel-major [9, T*K] array (row c = channel
// c: mean xy, conic abc, rgb, opacity) and a [T*K] validity row, so tile t
// owns the columns [t*K, t*K + min(counts[t], K)) (blend_common.cuh::
// DenseRanges) and the walk is the instance forward's (blend_instances.cu),
// with the same segments counted from each tile's start: the same lists
// give the same bits through either route.
//
// What bounds it on an H100: as for blend_instances.cu, each occupied slot
// is read once (40 B) and each pixel writes 16 B, against ~20 fp32
// operations and one exp per (slot, pixel) pair a pixel reaches, so the
// kernel is bound by arithmetic (~0.013 ms on a full-width frame); the
// empty slots past counts[t] are never read. What held the per-tile walk
// (one block per tile, this kernel's design before the segmented walk) at
// ~1.2% of that was the longest tile: ~8,750 slots walked by one block
// while the mean tile holds ~180.
//
// What this design does about it (blend_common.cuh, "the segmented walk"):
// each tile's list is cut into segments of SEG = 256 slots, so no block
// walks more than 256 slots of a tile and the longest tile spreads over ~35
// units. Four launches, queued by one host call on one stream:
//   plan      one block: each tile's first unit, each unit's tile;
//   products  pass A: each unit's product of (1 - alpha) per pixel;
//   walk      pass B: each unit folds the earlier segments' products into
//             its entry transmittance and walks its slots exactly, writing
//             a partial colour (and T_final from the pixel's last live
//             segment);
//   combine   each tile's partials summed in segment order, + T_final * bg.
// K is sized for the longest tile, so the units a frame can have (T
// ceil(K / 256), ~44,000 at full width) are ~25x those it has (~1,700);
// passes A and B therefore loop over the plan's unit count, which they read
// on the card, on the grid the card holds at once, and the scratch follows
// the bound (4 KiB per unit). The outputs do not depend on the order blocks
// run in.

#include "blend_common.cuh"

namespace {

using namespace blend;

__global__ void __launch_bounds__(PLAN_THREADS)
blend_tiles_fwd_plan(const int* __restrict__ counts, int k, int num_tiles, int cap,
                     int* __restrict__ unit_start, int* __restrict__ unit_tile) {
  plan_segments(DenseRanges{counts, k}, num_tiles, cap, unit_start, unit_tile);
}

__global__ void __launch_bounds__(BLOCK)
blend_tiles_fwd_products(const float* __restrict__ data, const float* __restrict__ valid,
                         int64_t m, const int* __restrict__ counts, int k, int num_tiles,
                         int grid_x, const int* __restrict__ unit_start,
                         const int* __restrict__ unit_tile, float* __restrict__ prod) {
  for_each_unit(DenseRanges{counts, k}, num_tiles, unit_start, unit_tile,
                [&](const Unit& un, int u) {
                  segment_products<false>(data, valid, m, un, u, grid_x, nullptr, prod,
                                          nullptr);
                });
}

__global__ void __launch_bounds__(BLOCK)
blend_tiles_fwd_walk(const float* __restrict__ data, const float* __restrict__ valid,
                     int64_t m, const int* __restrict__ counts, int k, int num_tiles,
                     int grid_x, const int* __restrict__ unit_start,
                     const int* __restrict__ unit_tile, const float* __restrict__ prod,
                     float* __restrict__ part, float* __restrict__ tfin) {
  for_each_unit(DenseRanges{counts, k}, num_tiles, unit_start, unit_tile,
                [&](const Unit& un, int u) {
                  forward_segment(data, valid, m, un, u, grid_x, prod, part, tfin);
                });
}

__global__ void __launch_bounds__(BLOCK)
blend_tiles_fwd_combine(const int* __restrict__ unit_start, const float* __restrict__ part,
                        const float* __restrict__ bg, float* __restrict__ img,
                        float* __restrict__ tfin) {
  combine_segments(blockIdx.x, unit_start, part, bg, img, tfin);
}

}  // namespace

// Scratch floats the forward needs for m = num_tiles * k columns: per unit
// of dense_unit_capacity, pass A's product and the partial colour ([4,
// 256]), then unit_start [T + 1] and unit_tile [units] as int32. The
// wrapper allocates its scratch from this number.
extern "C" int64_t blend_tiles_fwd_scratch_floats(int64_t m, int num_tiles) {
  const int64_t cap = dense_unit_capacity(m, num_tiles);
  return cap * 4 * BLOCK + num_tiles + 1 + cap;
}

// data [9, m] float32 (m = num_tiles * k, row c = channel c), valid [m]
// float32, counts [num_tiles] int32 (may exceed k), bg [3] float32, scratch
// of scratch_floats >= blend_tiles_fwd_scratch_floats(m, num_tiles) floats;
// writes img [num_tiles, 3, 256] and t_final [num_tiles, 256]. Queues its
// four launches on `stream`, does not synchronise, and returns the first
// cudaGetLastError() that is not cudaSuccess (cudaErrorInvalidValue for a
// short scratch).
extern "C" int blend_tiles_fwd(const float* data, const float* valid, int64_t m,
                               const int* counts, int k, const float* bg, float* img,
                               float* tfin, int num_tiles, int grid_x, float* scratch,
                               int64_t scratch_floats, cudaStream_t stream) {
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  if (scratch_floats < blend_tiles_fwd_scratch_floats(m, num_tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t cap = dense_unit_capacity(m, num_tiles);
  float* prod = scratch;
  float* part = prod + cap * BLOCK;
  int* unit_start = reinterpret_cast<int*>(part + cap * 3 * BLOCK);
  int* unit_tile = unit_start + num_tiles + 1;
  int err;
  blend_tiles_fwd_plan<<<1, PLAN_THREADS, 0, stream>>>(
      counts, k, num_tiles, static_cast<int>(cap), unit_start, unit_tile);
  if ((err = last_error()) != 0) return err;
  blend_tiles_fwd_products<<<resident_grid(blend_tiles_fwd_products), BLOCK, 0, stream>>>(
      data, valid, m, counts, k, num_tiles, grid_x, unit_start, unit_tile, prod);
  if ((err = last_error()) != 0) return err;
  blend_tiles_fwd_walk<<<resident_grid(blend_tiles_fwd_walk), BLOCK, 0, stream>>>(
      data, valid, m, counts, k, num_tiles, grid_x, unit_start, unit_tile, prod, part,
      tfin);
  if ((err = last_error()) != 0) return err;
  blend_tiles_fwd_combine<<<num_tiles, BLOCK, 0, stream>>>(unit_start, part, bg, img, tfin);
  return last_error();
}
