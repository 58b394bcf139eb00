// Gradient of the local correlation windows with respect to the query.
//
// Replaces the backward of the TPU kernel `local_correlation_pallas`
// (gfnet_tpu/ops/pallas/local_corr.py: `_bwd`, body `_bwd_kernel`). The
// forward (`local_corr.cu`) dots each cell's (2r+2)² integer patch of the
// target with the query and combines four shifted corners into (2r+1)² taps.
// This is its adjoint in the query alone: spread the incoming gradient
// g (B, G1, G2, (2r+1)²) over the patch with the same four corner weights,
// scale by 1/√C, and contract the spread weights with the target patch:
//
//   dq[c] = 1/√C · Σ_{y,x} sw[y][x] · target[y0 + y][x0 + x][c],
//   sw[y][x] = w00·g[y][x] + w01·g[y][x-1] + w10·g[y-1][x] + w11·g[y-1][x-1].
//
// No gradient goes to the target or the flow (the reference samples the
// windows without gradient). Output dq (B, G1, G2, C) float32.
//
// What bounds it on the H100: like the forward it touches (2r+2)²·C target
// values per cell that neighbouring cells largely share; counted once per
// input and output byte it moves a few MB at about one multiply-add per
// value read. It is bound by memory, in practice by how well the
// overlapping patch reads hit L1/L2.
//
// Design (first, simple version): one warp owns one cell, eight cells per
// block, so each dq is written once, without atomics, in a fixed order. The
// warp stages g in shared memory, spreads it into the (2r+2)² weights there,
// then walks the patch with its lanes along the channel axis, which is the
// contiguous one: a warp reads 32 neighbouring channels of one target pixel
// per step. With fewer than 32 channels the lanes split into 32/C groups
// that take every (32/C)-th pixel and add up with shuffles. Target reads are
// bounds-checked (out of range reads as zero); the window's base and weights
// come from `local_corr_window.cuh`, the same code the forward runs. A
// window that misses the map, or a non-finite flow, gives dq = 0 exactly.
// The TPU version's selection matrices, padded target and 8-aligned bf16
// staging were Mosaic workarounds and have no counterpart here.

#include "local_corr_window.cuh"

namespace {

using gfnet::to_f32;

constexpr int kWarps = 8;  // cells per block

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
local_corr_bwd_kernel(const float* __restrict__ grad, const T* __restrict__ target,
                      const float* __restrict__ flow, float* __restrict__ dq, int ncells,
                      int cells_per_image, int height, int width, int channels, int radius,
                      int lanes_c, float inv_sqrt_c) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int win = 2 * radius + 2;
  const int taps = 2 * radius + 1;
  const int cell = blockIdx.x * kWarps + warp;
  if (cell >= ncells) return;  // whole warp; the block never synchronizes

  float* gs = smem + warp * (taps * taps + win * win);
  float* sw = gs + taps * taps;
  float* out = dq + (long long)cell * channels;

  const gfnet::CorrWindow cw = gfnet::corr_window(flow + 2 * (long long)cell, height, width, radius);
  if (cw.outside) {
    for (int c = lane; c < channels; c += 32) out[c] = 0.f;
    return;
  }

  const float* gp = grad + (long long)cell * taps * taps;
  for (int t = lane; t < taps * taps; t += 32) gs[t] = gp[t];
  __syncwarp();

  // Adjoint of the four-corner combine: tap (ky, kx) read patch entries
  // (ky, kx), (ky, kx+1), (ky+1, kx), (ky+1, kx+1).
  for (int t = lane; t < win * win; t += 32) {
    const int y = t / win, x = t % win;
    float s = 0.f;
    if (y < taps && x < taps) s += cw.w00 * gs[y * taps + x];
    if (y < taps && x > 0) s += cw.w01 * gs[y * taps + x - 1];
    if (y > 0 && x < taps) s += cw.w10 * gs[(y - 1) * taps + x];
    if (y > 0 && x > 0) s += cw.w11 * gs[(y - 1) * taps + x - 1];
    sw[t] = s * inv_sqrt_c;
  }
  __syncwarp();

  // lanes_c lanes along the channels (a power of two, at most 32 and at
  // most C); the 32 / lanes_c groups take the patch's pixels in turn.
  const int groups = 32 / lanes_c;
  const int group = lane / lanes_c;
  const T* tb = target + (long long)(cell / cells_per_image) * height * width * channels;
  for (int cb = 0; cb < channels; cb += lanes_c) {
    const int c = cb + lane % lanes_c;
    float acc = 0.f;
    if (c < channels) {
      for (int t = group; t < win * win; t += groups) {
        const int y = cw.y0 + t / win;
        const int x = cw.x0 + t % win;
        if (y >= 0 && y < height && x >= 0 && x < width)
          acc = fmaf(sw[t], to_f32(tb[((long long)y * width + x) * channels + c]), acc);
      }
    }
    for (int off = lanes_c; off < 32; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (group == 0 && c < channels) out[c] = acc;
  }
}

template <typename T>
cudaError_t launch(const void* grad, const void* target, const void* flow, void* dq, int ncells,
                   int cells_per_image, int height, int width, int channels, int radius,
                   float inv_sqrt_c, cudaStream_t stream) {
  const int win = 2 * radius + 2;
  const int taps = 2 * radius + 1;
  const size_t smem = sizeof(float) * kWarps * (taps * taps + win * win);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(local_corr_bwd_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  int lanes_c = 32;
  while (lanes_c > channels) lanes_c >>= 1;
  const int blocks = (ncells + kWarps - 1) / kWarps;
  local_corr_bwd_kernel<T><<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(grad), static_cast<const T*>(target),
      static_cast<const float*>(flow), static_cast<float*>(dq), ncells, cells_per_image,
      height, width, channels, radius, lanes_c, inv_sqrt_c);
  return cudaGetLastError();
}

}  // namespace

// grad (B, G1, G2, (2r+1)²) float32, target (B, H, W, C) float32 or bf16,
// flow (B, G1, G2, 2) float32 normalized xy, all contiguous; dq
// (B, G1, G2, C) float32. Returns the cudaError_t of the launch (0 on success).
extern "C" int gfnet_local_corr_bwd(const void* grad, const void* target, const void* flow,
                                    void* dq, int batch, int g1, int g2, int height, int width,
                                    int channels, int radius, float inv_sqrt_c,
                                    int target_is_bf16, void* stream) {
  if (batch <= 0 || g1 <= 0 || g2 <= 0 || height <= 0 || width <= 0 || channels <= 0 ||
      radius < 0)
    return cudaErrorInvalidValue;
  const int ncells = batch * g1 * g2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (target_is_bf16)
    return launch<__nv_bfloat16>(grad, target, flow, dq, ncells, g1 * g2, height, width,
                                 channels, radius, inv_sqrt_c, s);
  return launch<float>(grad, target, flow, dq, ncells, g1 * g2, height, width, channels, radius,
                       inv_sqrt_c, s);
}
