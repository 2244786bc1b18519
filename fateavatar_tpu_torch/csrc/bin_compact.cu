// Candidate compaction of the instance binning (render/binning.py
// ::compact_candidates): the kept candidates of every splat written to their
// slots of the flat instance array, before its one sort by tile.
//
// Replaces no TPU kernel: the JAX package bins with XLA sorts and scatters
// and has no Pallas kernel there. Its 'onesort' mode expands every splat to
// all R = max_tiles_per_gaussian candidate slots and stable-sorts the N x R
// keys, invalid and over-budget ones carrying a sentinel tile; 'stable' and
// 'twokey' scatter the [N, R] expansion into the budget's M slots. At R
// 1,024 and N 100,000 that is 102.4 M entries a pass (a few hundred MB
// each) for at most the budget's instances. This kernel writes only what is
// kept, so the sort that follows runs over min(M, N x R) keys.
//
// Inputs are over the splats in depth-rank order: rmin_x, rmin_y, rect_w
// (the tile rect), touched (candidates under the R cap) and offsets (the
// exclusive scan of touched). Candidate r of rank i is kept where
// r < touched[i] and offsets[i] + r < slots, the budget; it goes to slot
// offsets[i] + r as the tile (rmin_y + r / w) * grid_x + rmin_x + r % w of
// the rect's row-major walk and the gaussian order[i]. Slots past the kept
// count hold the sentinel tile num_tiles and gaussian -1.
//
// What bounds it on an H100: bytes. It writes 8 B a slot (50 MB at a budget
// of 6.29 M slots: ~15 us at 3.35 TB/s) and reads 20 B a splat, which stay
// in L2.
//
// What its design does about it: one thread a slot, so the writes are
// coalesced and every thread does the same work whatever the footprints
// (1 to 1,024 tiles a splat: one warp a splat would leave most lanes idle
// on the small ones and serialize on the large). Each thread finds its
// splat by a binary search over offsets, ~17 probes at N 100,000 into a
// 400 KB array that the cache holds; the probes of neighbouring slots read
// the same words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int THREADS = 256;
}  // namespace

extern "C" __global__ void bin_compact(const int* __restrict__ rmin_x,
                                       const int* __restrict__ rmin_y,
                                       const int* __restrict__ rect_w,
                                       const int* __restrict__ touched,
                                       const int* __restrict__ offsets,
                                       const int64_t* __restrict__ order, int n,
                                       int num_tiles, int grid_x, int64_t slots,
                                       int* __restrict__ tiles, int* __restrict__ gauss) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (s >= slots) return;
  const int64_t valid = n > 0 ? static_cast<int64_t>(offsets[n - 1]) + touched[n - 1] : 0;
  if (s >= valid) {
    tiles[s] = num_tiles;
    gauss[s] = -1;
    return;
  }
  // the last rank whose offset is <= s: a rank with no candidate shares its
  // offset with the next one, so this is the rank whose candidates cover s
  int lo = 0, hi = n;  // offsets[lo] <= s < offsets[hi], offsets[n] past all
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (offsets[mid] <= s) lo = mid; else hi = mid;
  }
  const int r = static_cast<int>(s - offsets[lo]);
  const int w = rect_w[lo];
  const int q = r / w;
  tiles[s] = (rmin_y[lo] + q) * grid_x + rmin_x[lo] + (r - q * w);
  gauss[s] = static_cast<int>(order[lo]);
}

// Writes tiles [slots] and gauss [slots] (int32) from the n ranks' int32
// rmin_x, rmin_y, rect_w, touched, offsets and int64 order. One launch on
// `stream`, no synchronise; returns its cudaError_t.
extern "C" int bin_compact_launch(const int* rmin_x, const int* rmin_y, const int* rect_w,
                                  const int* touched, const int* offsets, const int64_t* order,
                                  int n, int num_tiles, int grid_x, int64_t slots,
                                  int* tiles, int* gauss, cudaStream_t stream) {
  if (slots <= 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (slots + THREADS - 1) / THREADS;
  bin_compact<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      rmin_x, rmin_y, rect_w, touched, offsets, order, n, num_tiles, grid_x, slots, tiles,
      gauss);
  return static_cast<int>(cudaGetLastError());
}
