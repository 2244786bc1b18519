// The blend walk shared by the port's four blend kernels: the instance
// blend (blend_instances.cu, blend_instances_bwd.cu) and the dense-list
// blend (blend_tiles.cu, blend_tiles_bwd.cu). All four run the segmented
// walk (below): a tile's column range is cut into segments of SEG columns,
// each a work unit of its own, joined through each segment's transmittance
// product, so that no block walks a whole tile's range alone. The two
// layouts differ only in where tile t's range lies (CompactRanges,
// DenseRanges); the plan, both passes and the combine are the same code.
// Pass B runs the walks forward_walk and backward_tile over one segment,
// entered with the segment's transmittance and prefix.
//
// A backward recomputes its forward's walk from the forward's outputs, so
// both must make bit-identical decisions: which instance is skipped
// (power > 0, alpha < 1/255), and where a pixel's transmittance crosses
// 1e-4 and stops. Every operation up to alpha and the transmittance step is
// explicitly rounded (no FMA contraction), in the order of the plain
// PyTorch version, and all four kernels run it through splat_at and
// next_transmittance; forward and backward also share the segment plan and
// the entry transmittance of each segment (segment_entry). The same lists
// in either layout give the same segments and so the same bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace blend {

constexpr int TILE = 16;
constexpr int BLOCK = TILE * TILE;  // threads per block = pixels per tile
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1.0e-4f;
constexpr int NG = 9;               // channels: mean xy, conic abc, rgb, opacity

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One instance at one pixel: offset from the pixel, Gaussian exponent, its
// exp, the unclamped alpha (raw) and the clamped one.
struct Splat {
  float dx, dy, power, expp, raw, alpha;
};

// Evaluates instance (mean, conic, opacity) at integer pixel (px, py).
// Returns true when the instance blends there: power <= 0 and the alpha
// clamped to 0.99 is at least 1/255. Invalid instances are staged with
// opacity 0 and so never blend.
__device__ __forceinline__ bool splat_at(float mx, float my, float ca,
                                         float cb, float cc, float op,
                                         float px, float py, Splat& s) {
  s.dx = __fsub_rn(mx, px);
  s.dy = __fsub_rn(my, py);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, s.dx), s.dx),
                               __fmul_rn(__fmul_rn(cc, s.dy), s.dy));
  s.power = __fsub_rn(__fmul_rn(-0.5f, quad),
                      __fmul_rn(__fmul_rn(cb, s.dx), s.dy));
  if (!(s.power <= 0.0f)) return false;
  s.expp = expf(s.power);
  s.raw = __fmul_rn(op, s.expp);
  s.alpha = s.raw > ALPHA_MAX ? ALPHA_MAX : s.raw;
  return s.alpha >= ALPHA_MIN;
}

// Transmittance after blending `alpha` over `T`. When it falls below
// T_EPS the instance is dropped and the pixel stops (renderCUDA,
// forward.cu:346-351).
__device__ __forceinline__ float next_transmittance(float T, float alpha) {
  return __fmul_rn(T, __fsub_rn(1.0f, alpha));
}

// Integer pixel coordinates (no +0.5) of this thread's pixel of tile t.
__device__ __forceinline__ void pixel_of(int t, int grid_x, float& px, float& py) {
  px = static_cast<float>((t % grid_x) * TILE + threadIdx.x % TILE);
  py = static_cast<float>((t / grid_x) * TILE + threadIdx.x / TILE);
}

// Stages column j's nine channels into column `slot` of sh; an invalid
// column gets opacity 0.
template <int W>
__device__ __forceinline__ void stage(float (&sh)[NG][W], int slot,
                                      const float* __restrict__ data,
                                      const float* __restrict__ valid,
                                      int64_t m, int64_t j) {
#pragma unroll
  for (int c = 0; c < 8; ++c) sh[c][slot] = data[c * m + j];
  sh[8][slot] = valid[j] > 0.0f ? data[8 * m + j] : 0.0f;
}

// Forward walk: the calling block (BLOCK threads, one per pixel at (px,
// py)) blends the columns [s, e) of a channel-major array front to back
// from the transmittance T, adding sum_i c_i a_i T_i to acc and leaving T
// at the pixel's last kept instance. Row c of the channels is data + c * m;
// column j blends only where valid[j] > 0. A pixel whose T is below 1e-4
// on entry blends nothing.
//
// Columns are staged in shared memory in batches of BLOCK (coalesced per
// channel row) and broadcast to the tile's pixels; a pixel stops once its T
// fell below 1e-4, and the block leaves the range as soon as every pixel
// has (__syncthreads_count).
__device__ __forceinline__ void forward_walk(
    const float* __restrict__ data, const float* __restrict__ valid, int64_t m,
    int64_t s, int64_t e, float px, float py, float& T, float& acc_r, float& acc_g,
    float& acc_b) {
  __shared__ float sh[NG][BLOCK];
  const int tid = threadIdx.x;
  bool done = !(T >= T_EPS);

  for (int64_t base = s; base < e; base += BLOCK) {
    // also the barrier that protects sh from the previous batch's readers
    if (__syncthreads_count(done) == BLOCK) break;
    if (base + tid < e) stage(sh, tid, data, valid, m, base + tid);
    __syncthreads();
    const int n = static_cast<int>(clamp64(e - base, 0, BLOCK));
    for (int k = 0; k < n && !done; ++k) {
      Splat sp;
      if (!splat_at(sh[0][k], sh[1][k], sh[2][k], sh[3][k], sh[4][k], sh[8][k],
                    px, py, sp))
        continue;
      const float test_t = next_transmittance(T, sp.alpha);
      if (test_t < T_EPS) {
        done = true;
        continue;
      }
      const float w = __fmul_rn(sp.alpha, T);
      acc_r = __fadd_rn(acc_r, __fmul_rn(w, sh[5][k]));
      acc_g = __fadd_rn(acc_g, __fmul_rn(w, sh[6][k]));
      acc_b = __fadd_rn(acc_b, __fmul_rn(w, sh[7][k]));
      T = test_t;
    }
  }
}

constexpr int BATCH = 128;           // columns staged per round of the backward
constexpr int NWARP = BLOCK / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float gdot(float g0, float g1, float g2, float cr, float cg,
                                      float cb) {
  return __fadd_rn(__fadd_rn(__fmul_rn(g0, cr), __fmul_rn(g1, cg)), __fmul_rn(g2, cb));
}

// The cotangent g_img of the calling thread's pixel of tile t.
__device__ __forceinline__ void pixel_cotangent(const float* __restrict__ gimg, int t,
                                                float& g0, float& g1, float& g2) {
  const int64_t p3 = static_cast<int64_t>(t) * 3 * BLOCK + threadIdx.x;
  g0 = gimg[p3];
  g1 = gimg[p3 + BLOCK];
  g2 = gimg[p3 + 2 * BLOCK];
}

// Backward walk: given the forward's img and T_final of tile t and their
// cotangents g_img, g_tfin, the calling block recomputes its pixels' walk
// over the columns [s, e), entered with transmittance T and prefix pu (a
// segment's q_in and pu_in), and stores, for each column j, the gradient of
// channels 0-8 in rows 0-8 of gout (row stride m) and zeros in rows
// 9..NOUT-1:
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
// each summed over the tile's 256 pixels. Every column of [s, e) is
// written, those after the block left its range (every pixel had
// terminated, so they never blended) as zeros.
//
// Columns are staged in batches of BATCH; each pixel thread walks them with
// the forward's exact skip and termination decisions; a warp reduces a
// column's 9 partials by shuffles only when one of its lanes kept it, into
// a per-warp slot in shared memory; after each batch the 8 warps' slots are
// summed in a fixed order and stored with plain stores (the caller owns
// these columns: no atomics, and the result does not depend on scheduling).
template <int NOUT>
__device__ __forceinline__ void backward_tile(
    const float* __restrict__ data, const float* __restrict__ valid, int64_t m,
    int64_t s, int64_t e, int t, int grid_x, const float* __restrict__ img,
    const float* __restrict__ tfin, const float* __restrict__ gimg,
    const float* __restrict__ gtfin, float* __restrict__ gout, float T, float pu) {
  __shared__ float sh[NG][BATCH];
  __shared__ float part[NWARP][NG][BATCH];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float px, py;
  pixel_of(t, grid_x, px, py);

  float g0, g1, g2;
  pixel_cotangent(gimg, t, g0, g1, g2);
  const int64_t p3 = static_cast<int64_t>(t) * 3 * BLOCK + tid;
  const float gdotimg = gdot(g0, g1, g2, img[p3], img[p3 + BLOCK], img[p3 + 2 * BLOCK]);
  const int64_t p1 = static_cast<int64_t>(t) * BLOCK + tid;
  const float gt_tn = __fmul_rn(gtfin[p1], tfin[p1]);

  bool done = !(T >= T_EPS);
  int64_t base = s;
  for (; base < e; base += BATCH) {
    // also the barrier that protects sh and part from the previous round
    if (__syncthreads_count(done) == BLOCK) break;
    if (tid < BATCH && base + tid < e) stage(sh, tid, data, valid, m, base + tid);
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
          const float gdotc = gdot(g0, g1, g2, cr, cg, cb);
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
    for (int idx = tid; idx < NOUT * n; idx += BLOCK) {
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
  // the columns the walk did not store, after an early exit
  for (int64_t j = base + tid; j < e; j += BLOCK) {
#pragma unroll
    for (int c = 0; c < NOUT; ++c) gout[c * m + j] = 0.0f;
  }
}

// ---------------------------------------------------------------------------
// The segmented walk.
//
// Work unit = (tile, segment): segment k of tile t holds the columns
// [s + k SEG, min(s + (k+1) SEG, e)) of the tile's range [s, e), counted
// from the tile's own start, in either layout. The units a frame can have
// are bounded by the shapes alone: ceil(m / SEG) + T in the compact layout
// (unit_capacity), T ceil(K / SEG) in the dense one (dense_unit_capacity),
// so the scratch is sized on the host without reading the device. The
// blend splits along segments because termination is a sticky mask on q,
// the running product of (1 - alpha) over every instance that passes the
// skip test (the Pallas kernel's definition,
// fateavatar_tpu/render/blend_instances.py:133-150): an instance counts
// while q after it stays >= 1e-4, and q is a product, so
//
//   q_in(k)  = prod_{i<k} P_i        P_i = segment i's product, from 1
//   pu_in(k) = sum_{i<k} q_in(i) U_i U_i = segment i's sum of
//                                          alpha_j T_j (g . c_j), T from 1
//
// hold up to the segment in which a pixel terminates. The launches, in
// stream order:
//
//   plan     one block: each tile's first unit and each unit's tile;
//   pass A   every unit: P (the backward also U) at each of its pixels,
//            over all its columns (it cannot know where a pixel stops);
//   pass B   every unit: the exact walk of its columns from q_in (and
//            pu_in), with forward_walk's / backward_tile's skip and
//            q >= 1e-4 tests;
//   combine  the forward only: each tile's partial colours in segment
//            order, plus T_final * bg.
//
// The instance kernels launch one block per unit of the capacity (surplus
// blocks leave at once); the dense capacity is ~25x the units a frame has
// (K holds the longest tile), so the tile kernels run passes A and B as a
// grid-stride loop over the plan's unit count (for_each_unit) on the grid
// the card holds at once (resident_grid).
//
// segment_entry takes q_in and pu_in in segment order, in the forward and
// the backward alike, so both drop exactly the same instances. Each column
// lies in one unit, so the backward stores with plain stores, and nothing
// depends on the order in which blocks run.
//
// Entry into segment k+1 is decided by the rounded product q_in(k) P_k,
// while pass B stops on the walk's own T, the product taken one instance at
// a time from q_in(k); the two round differently. A pixel whose crossing
// lies within a few ulps of 1e-4 can therefore stop inside segment k while
// q_in(k) P_k stays >= 1e-4, and blend again from segment k+1 on: at most
// ~1e-4 of colour (T is ~1e-4 there), inside the kernels' 2e-4 tolerance
// against the plain version, with the same decisions in both directions.
// ---------------------------------------------------------------------------

constexpr int SEG = 256;             // columns per unit
constexpr int PLAN_THREADS = 1024;
constexpr int PLAN_WARPS = PLAN_THREADS / 32;
static_assert(SEG == BLOCK, "pass A and the forward's pass B stage one column per thread");
static_assert(PLAN_WARPS == 32, "the plan's scan over warps is one warp");

__host__ __device__ constexpr int64_t unit_capacity(int64_t m, int num_tiles) {
  return (m + SEG - 1) / SEG + num_tiles;
}

// Units of the dense layout: each tile's list fills at most its K = m / T
// slots, so it has at most ceil(K / SEG) segments.
__host__ __device__ constexpr int64_t dense_unit_capacity(int64_t m, int num_tiles) {
  return num_tiles > 0 ? num_tiles * ((m / num_tiles + SEG - 1) / SEG) : 0;
}

// Tile t's column range [s, e) in the compact layout (the instance
// kernels): [tile_starts[t], tile_starts[t + 1]), clamped into [0, m) so
// that no input makes a block read out of bounds. With `cut` (the early
// exit of t_cutoff > 1e-4, "the early exit" below) the range ends at
// cut[t].
struct CompactRanges {
  const int* tile_starts;
  int64_t m;
  const int* cut = nullptr;
  __device__ __forceinline__ void operator()(int t, int64_t& s, int64_t& e) const {
    s = clamp64(tile_starts[t], 0, m);
    e = clamp64(tile_starts[t + 1], s, m);
    if (cut != nullptr) e = clamp64(cut[t], s, e);
  }
};



// Tile t's column range in the dense layout (the tile kernels): the first
// min(counts[t], K) of its K slots [t K, (t + 1) K).
struct DenseRanges {
  const int* counts;
  int k;
  __device__ __forceinline__ void operator()(int t, int64_t& s, int64_t& e) const {
    s = static_cast<int64_t>(t) * k;
    e = s + clamp64(counts[t], 0, k);
  }
};

// The plan, for one block of PLAN_THREADS threads: unit_start[t] = tile
// t's first unit (an exclusive prefix sum of the tiles' segment counts),
// unit_start[T] = the units used, unit_tile[u] = unit u's tile. Units past
// `cap` exist only in the compact layout when tile_starts decreases
// (overlapping ranges); they are dropped, so that no later launch indexes
// past the scratch. The dense layout never exceeds dense_unit_capacity.
// LEN: the columns of a unit (the early exit's windows are shorter).
template <typename Ranges, int LEN = SEG>
__device__ __forceinline__ void plan_segments(const Ranges& ranges, int num_tiles, int cap,
                                              int* __restrict__ unit_start,
                                              int* __restrict__ unit_tile) {
  __shared__ long long warp_total[PLAN_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (num_tiles + PLAN_THREADS - 1) / PLAN_THREADS;
  const int t0 = min(tid * per, num_tiles);
  const int t1 = min(t0 + per, num_tiles);
  long long mine = 0;
  for (int t = t0; t < t1; ++t) {
    int64_t s, e;
    ranges(t, s, e);
    mine += (e - s + LEN - 1) / LEN;
  }
  // exclusive scan of `mine` over the block: in each warp, then over warps
  long long incl = mine;
  for (int off = 1; off < 32; off <<= 1) {
    const long long v = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    long long w = warp_total[lane];
    for (int off = 1; off < 32; off <<= 1) {
      const long long v = __shfl_up_sync(FULL, w, off);
      if (lane >= off) w += v;
    }
    warp_total[lane] = w;
  }
  __syncthreads();
  long long u = incl - mine + (warp > 0 ? warp_total[warp - 1] : 0);
  for (int t = t0; t < t1; ++t) {
    int64_t s, e;
    ranges(t, s, e);
    const long long n = (e - s + LEN - 1) / LEN;
    unit_start[t] = static_cast<int>(u < cap ? u : cap);
    for (long long k = 0; k < n && u + k < cap; ++k) unit_tile[u + k] = t;
    u += n;
  }
  if (tid == PLAN_THREADS - 1) unit_start[num_tiles] = static_cast<int>(u < cap ? u : cap);
}

// A unit's place in the plan: its tile t, its segment k of the tile's
// nseg, the tile's first unit u0 and the segment's columns [a, b).
struct Unit {
  int t, k, nseg, u0;
  int64_t a, b;
};

// Unit u of the plan; false for a block past the units used.
template <typename Ranges, int LEN = SEG>
__device__ __forceinline__ bool unit_of(int u, const Ranges& ranges, int num_tiles,
                                        const int* __restrict__ unit_start,
                                        const int* __restrict__ unit_tile, Unit& un) {
  if (u >= unit_start[num_tiles]) return false;
  un.t = unit_tile[u];
  un.u0 = unit_start[un.t];
  un.nseg = unit_start[un.t + 1] - un.u0;
  un.k = u - un.u0;
  int64_t s, e;
  ranges(un.t, s, e);
  un.a = s + static_cast<int64_t>(un.k) * LEN;
  un.b = un.a + LEN < e ? un.a + LEN : e;
  return true;
}

// Runs body(un, u) for the units blockIdx.x, blockIdx.x + gridDim.x, ...
// of the plan: the grid-stride loop of the tile kernels' passes A and B.
// The barrier after each unit keeps the next unit from restaging shared
// memory under the previous one's readers.
template <typename Ranges, typename Body>
__device__ __forceinline__ void for_each_unit(const Ranges& ranges, int num_tiles,
                                              const int* __restrict__ unit_start,
                                              const int* __restrict__ unit_tile, Body body) {
  Unit un;
  for (int u = blockIdx.x; unit_of(u, ranges, num_tiles, unit_start, unit_tile, un);
       u += gridDim.x) {
    body(un, u);
    __syncthreads();
  }
}

// Pass A of unit u at the calling thread's pixel: P, the product of
// (1 - alpha) over the segment's instances that pass the skip test, from 1
// and without termination, into prod[u] ([BLOCK] per unit); with BWD also
// U = sum alpha_j T_j (g . c_j), T from 1, into usum[u].
template <bool BWD>
__device__ __forceinline__ void segment_products(
    const float* __restrict__ data, const float* __restrict__ valid, int64_t m,
    const Unit& un, int u, int grid_x, const float* __restrict__ gimg,
    float* __restrict__ prod, float* __restrict__ usum) {
  __shared__ float sh[NG][SEG];
  const int tid = threadIdx.x;
  const int n = static_cast<int>(un.b - un.a);
  if (tid < n) stage(sh, tid, data, valid, m, un.a + tid);
  __syncthreads();
  float px, py;
  pixel_of(un.t, grid_x, px, py);
  float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
  if (BWD) pixel_cotangent(gimg, un.t, g0, g1, g2);
  float q = 1.0f, usum_k = 0.0f;
  for (int k = 0; k < n; ++k) {
    Splat sp;
    if (!splat_at(sh[0][k], sh[1][k], sh[2][k], sh[3][k], sh[4][k], sh[8][k], px, py, sp))
      continue;
    if (BWD) {
      const float gdotc = gdot(g0, g1, g2, sh[5][k], sh[6][k], sh[7][k]);
      usum_k = __fadd_rn(usum_k, __fmul_rn(__fmul_rn(sp.alpha, q), gdotc));
    }
    q = next_transmittance(q, sp.alpha);
  }
  const int64_t at = static_cast<int64_t>(u) * BLOCK + tid;
  prod[at] = q;
  if (BWD) usum[at] = usum_k;
}

// The transmittance q_in entering segment k at the calling thread's pixel
// and, with usum, the prefix pu_in: pass A's results of the tile's
// segments 0..k-1 folded in segment order. Stops once q fell below T_EPS:
// the pixel has terminated, and every later q_in is below it too (each
// step is a rounded product with a factor <= 1).
__device__ __forceinline__ float segment_entry(const float* __restrict__ prod,
                                               const float* __restrict__ usum,
                                               const Unit& un, float& pu) {
  float q = 1.0f;
  pu = 0.0f;
  for (int i = 0; i < un.k && q >= T_EPS; ++i) {
    const int64_t at = static_cast<int64_t>(un.u0 + i) * BLOCK + threadIdx.x;
    if (usum != nullptr) pu = __fadd_rn(pu, __fmul_rn(q, usum[at]));
    q = __fmul_rn(q, prod[at]);
  }
  return q;
}

// Forward pass B of unit u: each pixel runs forward_walk over the segment's
// columns from q_in and stores its partial colour sum_j c_j alpha_j T_j into
// part[u] ([3, BLOCK] per unit). The pixel's last segment entered at or
// above T_EPS writes its T_final to tfin[t]: exactly one unit per pixel of
// a non-empty tile, as segment 0 always enters at 1. A pixel that entered
// below T_EPS adds 0; a block whose pixels all did stages nothing.
__device__ __forceinline__ void forward_segment(
    const float* __restrict__ data, const float* __restrict__ valid, int64_t m,
    const Unit& un, int u, int grid_x, const float* __restrict__ prod,
    float* __restrict__ part, float* __restrict__ tfin) {
  const int tid = threadIdx.x;
  float pu_unused;
  float T = segment_entry(prod, nullptr, un, pu_unused);
  const bool last =
      T >= T_EPS && (un.k + 1 == un.nseg ||
                     !(__fmul_rn(T, prod[static_cast<int64_t>(u) * BLOCK + tid]) >= T_EPS));
  float px, py;
  pixel_of(un.t, grid_x, px, py);
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  forward_walk(data, valid, m, un.a, un.b, px, py, T, acc_r, acc_g, acc_b);
  float* out = part + static_cast<int64_t>(u) * 3 * BLOCK;
  out[tid] = acc_r;
  out[BLOCK + tid] = acc_g;
  out[2 * BLOCK + tid] = acc_b;
  if (last) tfin[static_cast<int64_t>(un.t) * BLOCK + tid] = T;
}

// Forward combine of tile t: img[t] = its units' partial colours summed in
// segment order + T_final * bg; a tile without units keeps T_final = 1.
__device__ __forceinline__ void combine_segments(int t, const int* __restrict__ unit_start,
                                                 const float* __restrict__ part,
                                                 const float* __restrict__ bg,
                                                 float* __restrict__ img,
                                                 float* __restrict__ tfin) {
  const int tid = threadIdx.x;
  const int u0 = unit_start[t], u1 = unit_start[t + 1];
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int u = u0; u < u1; ++u) {
    const float* p = part + static_cast<int64_t>(u) * 3 * BLOCK;
    acc_r = __fadd_rn(acc_r, p[tid]);
    acc_g = __fadd_rn(acc_g, p[BLOCK + tid]);
    acc_b = __fadd_rn(acc_b, p[2 * BLOCK + tid]);
  }
  const int64_t p1 = static_cast<int64_t>(t) * BLOCK + tid;
  float T = 1.0f;
  if (u1 > u0) {
    T = tfin[p1];
  } else {
    tfin[p1] = 1.0f;
  }
  float* out = img + static_cast<int64_t>(t) * 3 * BLOCK;
  out[tid] = __fadd_rn(acc_r, __fmul_rn(T, bg[0]));
  out[BLOCK + tid] = __fadd_rn(acc_g, __fmul_rn(T, bg[1]));
  out[2 * BLOCK + tid] = __fadd_rn(acc_b, __fmul_rn(T, bg[2]));
}

// Backward pass B of a unit: backward_tile over the segment's columns [a,
// b), entered with T = q_in and the prefix pu = pu_in from segment_entry,
// so that every pixel makes the forward's decisions. Writes all NOUT rows
// of every column in [a, b).
template <int NOUT>
__device__ __forceinline__ void backward_segment(
    const float* __restrict__ data, const float* __restrict__ valid, int64_t m,
    const Unit& un, int grid_x, const float* __restrict__ img,
    const float* __restrict__ tfin, const float* __restrict__ gimg,
    const float* __restrict__ gtfin, const float* __restrict__ prod,
    const float* __restrict__ usum, float* __restrict__ gout) {
  float pu;
  const float q_in = segment_entry(prod, usum, un, pu);
  backward_tile<NOUT>(data, valid, m, un.a, un.b, un.t, grid_x, img, tfin, gimg, gtfin,
                      gout, q_in, pu);
}

// ---------------------------------------------------------------------------
// The early exit of t_cutoff > 1e-4 (the Pallas kernels' `cutoff`,
// fateavatar_tpu/render/blend_instances.py:157-170 and 320-379).
//
// The Pallas kernel walks tile t's range [s, e) in windows of CUT_WINDOW
// columns counted from absolute multiples of CUT_WINDOW (window i = [w0 +
// 128 i, w0 + 128 (i + 1)) clipped to the range, w0 = s rounded down), and
// before each window after the first it goes on only while some pixel's q
// is >= cutoff: q, the product of (1 - alpha) over every instance of the
// range so far that passes the skip test, termination ignored (pass A's
// product). The windows it runs are the exact blend of the shorter range
// [s, cut[t]); the rest get neither colour nor gradient.
//
// cut[t] comes from two launches, before the plan:
//   window products  one block per (tile, window) of the window plan
//                    (plan_segments over WindowRanges, CUT_WINDOW columns a
//                    unit): each pixel's product of its window's (1 - alpha);
//   cut scan         one block per tile: the pixels fold their windows'
//                    products in order and the block stops at the first
//                    window boundary where no pixel is >= cutoff.
// The products take every window of every range, in parallel, as pass A
// does; the scan is one multiply a window.
// ---------------------------------------------------------------------------

constexpr int CUT_WINDOW = 128;

// Tile t's windows: its compact range with the start rounded down to a
// multiple of CUT_WINDOW, so that plan_segments<WindowRanges, CUT_WINDOW>
// makes one unit per window.
struct WindowRanges {
  CompactRanges tiles;
  __device__ __forceinline__ void operator()(int t, int64_t& s, int64_t& e) const {
    tiles(t, s, e);
    s = s / CUT_WINDOW * CUT_WINDOW;
  }
};

// Windows the plan can have: one per CUT_WINDOW columns, plus one a tile
// for a range that starts mid-window.
__host__ __device__ constexpr int64_t window_capacity(int64_t m, int num_tiles) {
  return (m + CUT_WINDOW - 1) / CUT_WINDOW + num_tiles;
}

// The product of (1 - alpha) of window unit u at the calling thread's
// pixel, over the window's columns inside the tile's range, into prod[u]
// ([BLOCK] per unit).
__device__ __forceinline__ void window_products(const float* __restrict__ data,
                                                const float* __restrict__ valid, int64_t m,
                                                const Unit& un, int u, int grid_x,
                                                const CompactRanges& tiles,
                                                float* __restrict__ prod) {
  __shared__ float sh[NG][CUT_WINDOW];
  const int tid = threadIdx.x;
  int64_t s, e;
  tiles(un.t, s, e);
  const int64_t lo = un.a > s ? un.a : s;
  const int n = static_cast<int>(un.b - lo);
  if (tid < n) stage(sh, tid, data, valid, m, lo + tid);
  __syncthreads();
  float px, py;
  pixel_of(un.t, grid_x, px, py);
  float q = 1.0f;
  for (int k = 0; k < n; ++k) {
    Splat sp;
    if (splat_at(sh[0][k], sh[1][k], sh[2][k], sh[3][k], sh[4][k], sh[8][k], px, py, sp))
      q = next_transmittance(q, sp.alpha);
  }
  prod[static_cast<int64_t>(u) * BLOCK + tid] = q;
}

// cut[t] for the calling block (one thread per pixel): the tile's windows
// [unit_start[t], unit_start[t + 1]) of the window plan folded in order,
// stopping before the first window (after window 0) at whose start every
// pixel's q is below cutoff; the cut is that window's start, clipped to
// the range.
__device__ __forceinline__ void cut_scan(int t, const CompactRanges& tiles,
                                         const int* __restrict__ unit_start,
                                         const float* __restrict__ prod, float cutoff,
                                         int* __restrict__ cut) {
  int64_t s, e;
  tiles(t, s, e);
  const int64_t w0 = s / CUT_WINDOW * CUT_WINDOW;
  const int u0 = unit_start[t], nwin = unit_start[t + 1] - u0;
  float q = 1.0f;
  int i = 0;
  for (; i < nwin; ++i) {
    if (i > 0 && __syncthreads_or(q >= cutoff) == 0) break;
    q = __fmul_rn(q, prod[static_cast<int64_t>(u0 + i) * BLOCK + threadIdx.x]);
  }
  if (threadIdx.x == 0)
    cut[t] = static_cast<int>(clamp64(w0 + static_cast<int64_t>(i) * CUT_WINDOW, s, e));
}

// Zeroes row[lo, hi) with the calling block: scalar stores up to the first
// 16-byte boundary, float4 stores to the last one, scalar stores after it.
__device__ __forceinline__ void zero_range(float* __restrict__ row, int64_t lo,
                                           int64_t hi) {
  const int64_t head = (4 - ((reinterpret_cast<uintptr_t>(row + lo) >> 2) & 3)) & 3;
  const int64_t body = lo + head < hi ? lo + head : hi;
  const int64_t n4 = (hi - body) >> 2;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int64_t j = lo + threadIdx.x; j < body; j += blockDim.x) row[j] = 0.0f;
  float4* v = reinterpret_cast<float4*>(row + body);
  for (int64_t i = threadIdx.x; i < n4; i += blockDim.x) v[i] = zero;
  for (int64_t j = body + 4 * n4 + threadIdx.x; j < hi; j += blockDim.x) row[j] = 0.0f;
}

// cudaGetLastError() as the C entry points return it.
inline int last_error() { return static_cast<int>(cudaGetLastError()); }

// The blocks of `kernel` (BLOCK threads, static shared memory only) one
// card holds at once: the grid of a grid-stride launch, queried on the
// first call (neither query synchronises) and kept. The grid sets only how
// many units run at once, never the results. 0 when a query failed, which
// the launch then reports as its error.
template <typename Kernel>
int resident_grid(Kernel kernel) {
  static int grid = 0;
  if (grid == 0) {
    int dev = 0, per_sm = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    grid = per_sm * sms;
  }
  return grid;
}

}  // namespace blend
