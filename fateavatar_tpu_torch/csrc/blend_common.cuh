// Per-(instance, pixel) arithmetic shared by the instance blend's forward
// (blend_instances.cu) and backward (blend_instances_bwd.cu) kernels.
//
// The backward recomputes the forward walk from the forward's outputs, so
// both must make bit-identical decisions: which instance is skipped
// (power > 0, alpha < 1/255), and where a pixel's transmittance crosses
// 1e-4 and stops. Every operation up to alpha and the transmittance step is
// explicitly rounded (no FMA contraction), in the order of the plain
// PyTorch version, and both kernels call these functions.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace blend {

constexpr int TILE = 16;
constexpr int BLOCK = TILE * TILE;  // threads per block = pixels per tile
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1.0e-4f;

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
// clamped to 0.99 is at least 1/255. Rows of invalid instances carry
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

}  // namespace blend
