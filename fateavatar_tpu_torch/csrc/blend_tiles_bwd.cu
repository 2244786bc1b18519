// Dense-list alpha blend, backward: one 16x16 tile per block.
//
// Replaces the Pallas TPU kernel fateavatar_tpu/render/blend_tiles.py
// ::_bwd_kernel (driven by _pallas_call_bwd, VJP _blend_bwd). Same
// function: given the forward's img and T_final and their cotangents
// g_img, g_tfin, tile t recomputes its pixels' front-to-back walk over the
// first min(counts[t], K) slots of its list and returns, per slot, the
// gradients of its 9 channels (mean xy, conic abc, colour rgb, opacity),
// each summed over the tile's 256 pixels. The Pallas kernel takes the
// colour prefix P_j and the suffix S_j = img - P_j per channel
// (blend_tiles.py:308-331); here the same dalpha comes from the dot
// products g . img - pu_j with pu_j = sum_{k <= j} w_k (g . c_k), the walk
// of the instance backward (blend_common.cuh::backward_tile), which also
// recomputes the forward's skip and termination decisions bit for bit.
//
// Ownership: tile t owns the K columns [t*K, (t+1)*K) of the [9, T*K]
// output, so its block stores them with plain stores (no atomics; the
// result does not depend on scheduling) and writes every one of them: the
// occupied slots' sums, zeros for the slots after an early exit and for the
// empty slots past min(counts[t], K) (blend_tiles.py:273-276). Only the 9
// channels that carry gradients are written.
//
// What bounds it on an H100: each (slot, pixel) pair a pixel reaches costs
// ~14 fp32 operations to recompute alpha, and each pair it blends ~40 more
// (dalpha, 9 partials, the warp reduction), against 40 B read per occupied
// slot, 48 B per pixel and 36 B written per slot of the whole [9, T*K]
// output; with K sized for the longest tile most slots are empty, so the
// output write can bound it. What the design does about it: as in the
// instance backward, slots are staged in shared memory in batches of 128,
// a warp reduces a slot's partials by shuffles only when one of its lanes
// kept it, and the block leaves its list once every pixel has terminated;
// the empty slots are zero-filled with coalesced row stores.

#include "blend_common.cuh"

namespace {

using namespace blend;

__global__ void __launch_bounds__(BLOCK)
blend_tiles_bwd_kernel(const float* __restrict__ data,
                       const float* __restrict__ valid, int64_t m,
                       const int* __restrict__ counts, int k,
                       const float* __restrict__ img,
                       const float* __restrict__ tfin,
                       const float* __restrict__ gimg,
                       const float* __restrict__ gtfin,
                       float* __restrict__ gout, int grid_x) {
  const int t = blockIdx.x;
  const int64_t s = static_cast<int64_t>(t) * k;
  const int64_t e = s + clamp64(counts[t], 0, k);
  backward_tile<NG>(data, valid, m, s, e, s + k, t, grid_x, img, tfin, gimg,
                    gtfin, gout);
}

}  // namespace

// data [9, m] float32 (m = num_tiles * k), valid [m] float32, counts
// [num_tiles] int32, img [num_tiles, 3, 256], t_final [num_tiles, 256],
// g_img and g_tfin of the same shapes, all float32; writes every element of
// gout [9, m]. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of the launch.
extern "C" int blend_tiles_bwd(const float* data, const float* valid, int64_t m,
                               const int* counts, int k, const float* img,
                               const float* tfin, const float* gimg,
                               const float* gtfin, float* gout, int num_tiles,
                               int grid_x, cudaStream_t stream) {
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  blend_tiles_bwd_kernel<<<num_tiles, BLOCK, 0, stream>>>(
      data, valid, m, counts, k, img, tfin, gimg, gtfin, gout, grid_x);
  return static_cast<int>(cudaGetLastError());
}
