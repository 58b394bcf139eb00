// The window of one local-correlation cell: where its (2r+2)² integer patch
// of the target map starts, whether it meets the map at all, and the four
// bilinear corner weights that every tap of the cell shares.
//
// Shared by the forward (`local_corr.cu`) and the backward
// (`local_corr_bwd.cu`), so that both pick the same cells and the same
// weights when a coordinate sits on an integer: the arithmetic is float32
// without FMA contraction, the same as the TPU package's `_precompute`
// (gfnet_tpu/ops/pallas/local_corr.py).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace gfnet {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct CorrWindow {
  bool outside;  // the patch misses the map, or the flow is not finite
  int x0, y0;    // map coordinates of the patch's first column and row
  float w00, w01, w10, w11;  // corner weights, (dy, dx) = 00, 01, 10, 11
};

// `flow_xy` points at the cell's normalized (x, y) target coordinate.
__device__ __forceinline__ CorrWindow corr_window(const float* __restrict__ flow_xy,
                                                  int height, int width, int radius) {
  CorrWindow win;
  const int side = 2 * radius + 2;
  const float px = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(flow_xy[0], 1.f), (float)width), 1.f), 0.5f);
  const float py = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(flow_xy[1], 1.f), (float)height), 1.f), 0.5f);
  const float x0f = floorf(px), y0f = floorf(py);
  // Patch columns x0f - r .. x0f - r + side - 1. Tested in float: no int overflow.
  win.outside = !(isfinite(px) && isfinite(py)) || x0f - radius > width - 1 ||
                x0f - radius + side - 1 < 0 || y0f - radius > height - 1 ||
                y0f - radius + side - 1 < 0;
  if (win.outside) {
    win.x0 = win.y0 = 0;
    win.w00 = win.w01 = win.w10 = win.w11 = 0.f;
    return win;
  }
  win.x0 = (int)x0f - radius;
  win.y0 = (int)y0f - radius;
  const float fx = __fsub_rn(px, x0f), fy = __fsub_rn(py, y0f);
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
  win.w00 = __fmul_rn(gy, gx);
  win.w01 = __fmul_rn(gy, fx);
  win.w10 = __fmul_rn(fy, gx);
  win.w11 = __fmul_rn(fy, fx);
  return win;
}

}  // namespace gfnet
