// Dense-list alpha blend, forward: one 16x16 tile per block.
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
// owns the columns [t*K, t*K + min(counts[t], K)) and the walk is the
// instance kernel's (blend_common.cuh::forward_tile), with the same skip
// and termination decisions on the same sequence.
//
// What bounds it on an H100: as for blend_instances.cu, each occupied slot
// is read once (40 B) and each pixel writes 16 B, against ~20 fp32
// operations and one exp per (slot, pixel) pair a pixel reaches, so the
// kernel is bound by arithmetic; the empty slots past counts[t] are never
// read. What the design does about it: the slots are staged in shared
// memory in batches of 256 and broadcast to the tile's pixels, a pixel
// stops at T < 1e-4 and the block leaves its list once every pixel has.

#include "blend_common.cuh"

namespace {

using namespace blend;

__global__ void __launch_bounds__(BLOCK)
blend_tiles_fwd_kernel(const float* __restrict__ data,
                       const float* __restrict__ valid, int64_t m,
                       const int* __restrict__ counts, int k,
                       const float* __restrict__ bg,
                       float* __restrict__ img, float* __restrict__ tfin,
                       int grid_x) {
  const int t = blockIdx.x;
  const int64_t s = static_cast<int64_t>(t) * k;
  const int64_t e = s + clamp64(counts[t], 0, k);
  forward_tile(data, valid, m, s, e, t, grid_x, bg, img, tfin);
}

}  // namespace

// data [9, m] float32 (m = num_tiles * k, row c = channel c), valid [m]
// float32, counts [num_tiles] int32 (may exceed k), bg [3] float32; writes
// img [num_tiles, 3, 256] and t_final [num_tiles, 256]. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() of the
// launch.
extern "C" int blend_tiles_fwd(const float* data, const float* valid, int64_t m,
                               const int* counts, int k, const float* bg,
                               float* img, float* tfin, int num_tiles,
                               int grid_x, cudaStream_t stream) {
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  blend_tiles_fwd_kernel<<<num_tiles, BLOCK, 0, stream>>>(
      data, valid, m, counts, k, bg, img, tfin, grid_x);
  return static_cast<int>(cudaGetLastError());
}
