// Instance-range alpha blend, forward: one 16x16 tile per block.
//
// Replaces the Pallas TPU kernel fateavatar_tpu/render/blend_instances.py
// ::_fwd_kernel (driven by _call_fwd). Same function: every tile walks its
// [tile_starts[t], tile_starts[t+1]) range of the flat depth-sorted instance
// array front to back, with renderCUDA's semantics (forward.cu:289-374):
// skip on power > 0 or alpha < 1/255, alpha clamped to 0.99, and the
// instance that would take T below 1e-4 is dropped and the pixel stops.
// Output img = sum_i c_i a_i T_i + T_final * bg and T_final.
//
// What bounds it on an H100: each binned instance is read once per tile
// (10 channels used, 40 B), each pixel writes 16 B (rgb + T), and every
// (instance, pixel) pair the pixel reaches costs ~20 fp32 operations plus
// one exp. A frame has ~10^2 pairs per byte, so the kernel is bound by
// arithmetic and the special-function unit, not by memory.
// What the design does about it (blend_common.cuh::forward_tile, shared
// with the dense-list kernel blend_tiles.cu): instance channels are staged
// in shared memory in batches of 256 (coalesced per channel row of the
// [16, M] array) so each is read from device memory once per tile and then
// broadcast to the tile's 256 pixel threads; a pixel stops evaluating once
// its T fell below 1e-4, and the whole block leaves its range as soon as
// every pixel has (__syncthreads_count), so saturated regions cost no more
// pairs than they need. Invalid / sentinel rows (valid = 0) are staged with
// opacity 0, which the 1/255 test skips.
//
// The arithmetic up to alpha and the transmittance step uses explicitly
// rounded operations (no FMA contraction) in the order of the plain PyTorch
// version, so both compute the same bits for power and alpha and never
// disagree on the 1/255 and power > 0 tests; they differ only in the order
// of the transmittance product.

#include "blend_common.cuh"

namespace {

using namespace blend;

__global__ void __launch_bounds__(BLOCK)
blend_instances_fwd_kernel(const float* __restrict__ inst, int64_t m,
                           const int* __restrict__ tile_starts,
                           const float* __restrict__ bg,
                           float* __restrict__ img, float* __restrict__ tfin,
                           int grid_x) {
  const int t = blockIdx.x;
  // clamp the range into the array so no input can make the block read
  // out of bounds
  const int64_t s = clamp64(tile_starts[t], 0, m);
  const int64_t e = clamp64(tile_starts[t + 1], s, m);
  // row 9 of the [16, M] array is the valid flag
  forward_tile(inst, inst + 9 * m, m, s, e, t, grid_x, bg, img, tfin);
}

}  // namespace

// inst [16, m] float32 (row c = channel c), tile_starts [num_tiles + 1]
// int32, bg [3] float32; writes img [num_tiles, 3, 256] and
// t_final [num_tiles, 256]. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() of the launch.
extern "C" int blend_instances_fwd(const float* inst, int64_t m,
                                   const int* tile_starts, const float* bg,
                                   float* img, float* tfin, int num_tiles,
                                   int grid_x, cudaStream_t stream) {
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  blend_instances_fwd_kernel<<<num_tiles, BLOCK, 0, stream>>>(
      inst, m, tile_starts, bg, img, tfin, grid_x);
  return static_cast<int>(cudaGetLastError());
}
