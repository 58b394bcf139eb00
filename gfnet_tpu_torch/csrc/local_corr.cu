// Local correlation windows around the current flow estimate.
//
// Replaces the forward of the TPU kernel `local_correlation_pallas`
// (gfnet_tpu/ops/pallas/local_corr.py: `_precompute`, `_prep`, `_fwd`, body
// `_fwd_kernel`). For each query cell, the (2r+1)² bilinear taps (zeros
// padding, align_corners=False) of the target map at `flow + integer
// offsets`, each dotted with the cell's query feature and scaled by 1/√C.
// Output (B, G1, G2, (2r+1)²) float32, ky-major.
//
// What bounds it on the H100: per cell it does (2r+2)²·C multiply-adds on
// (2r+2)²·C target values that neighbouring cells largely share, and writes
// (2r+1)² floats. Counted once per input and output byte it moves a few MB
// per call at ~1 flop per byte: memory bound, and in practice bound by how
// well the overlapping window reads hit L1/L2.
//
// Design (first, simple version): one warp per cell, eight cells per block.
// All taps of a cell share one fractional offset, so the warp dots the
// cell's (2r+2)² integer patch with the query (one tap per lane, the query
// staged in shared memory), keeps the dots in shared memory, and combines
// the four shifted corners into the (2r+1)² outputs. The target is read from
// global memory with bounds checks (out of range reads as zero) instead of a
// zero-padded copy, so no shape needs a gate; a window whose base the TPU
// version would clamp lies wholly outside the map and gives zeros either
// way. A non-finite flow gives an all-zero window. The TPU version's
// selection-matrix combine and 8-aligned bf16 staging were Mosaic
// workarounds and have no counterpart here.

#include "local_corr_window.cuh"

namespace {

using gfnet::to_f32;

constexpr int kWarps = 8;  // cells per block

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
local_corr_kernel(const T* __restrict__ query, const T* __restrict__ target,
                  const float* __restrict__ flow, float* __restrict__ out, int ncells,
                  int cells_per_image, int height, int width, int channels, int radius,
                  float inv_sqrt_c) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int win = 2 * radius + 2;
  const int taps = 2 * radius + 1;
  const int cell = blockIdx.x * kWarps + warp;
  if (cell >= ncells) return;  // whole warp; the block never synchronizes

  float* qs = smem + warp * (channels + win * win);
  float* dots = qs + channels;
  float* o = out + (long long)cell * taps * taps;

  // The patch's base and corner weights, the same numbers the backward uses.
  // A window that misses the map (or a non-finite flow) is all zeros.
  const gfnet::CorrWindow cw = gfnet::corr_window(flow + 2 * (long long)cell, height, width, radius);
  if (cw.outside) {
    for (int t = lane; t < taps * taps; t += 32) o[t] = 0.f;
    return;
  }

  const T* qp = query + (long long)cell * channels;
  for (int c = lane; c < channels; c += 32) qs[c] = to_f32(qp[c]);
  __syncwarp();

  const int x0 = cw.x0, y0 = cw.y0;
  const T* tb = target + (long long)(cell / cells_per_image) * height * width * channels;
  for (int t = lane; t < win * win; t += 32) {
    const int y = y0 + t / win;
    const int x = x0 + t % win;
    float dot = 0.f;
    if (y >= 0 && y < height && x >= 0 && x < width) {
      const T* tp = tb + ((long long)y * width + x) * channels;
      for (int c = 0; c < channels; ++c) dot = fmaf(to_f32(tp[c]), qs[c], dot);
    }
    dots[t] = dot;
  }
  __syncwarp();

  const float w00 = cw.w00, w01 = cw.w01, w10 = cw.w10, w11 = cw.w11;
  for (int t = lane; t < taps * taps; t += 32) {
    const float* s = dots + (t / taps) * win + t % taps;
    o[t] = (w00 * s[0] + w01 * s[1] + w10 * s[win] + w11 * s[win + 1]) * inv_sqrt_c;
  }
}

template <typename T>
cudaError_t launch(const void* query, const void* target, const void* flow, void* out,
                   int ncells, int cells_per_image, int height, int width, int channels,
                   int radius, float inv_sqrt_c, cudaStream_t stream) {
  const int win = 2 * radius + 2;
  const size_t smem = sizeof(float) * kWarps * (channels + win * win);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(local_corr_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (ncells + kWarps - 1) / kWarps;
  local_corr_kernel<T><<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(query), static_cast<const T*>(target),
      static_cast<const float*>(flow), static_cast<float*>(out), ncells, cells_per_image,
      height, width, channels, radius, inv_sqrt_c);
  return cudaGetLastError();
}

}  // namespace

// query (B, G1, G2, C) and target (B, H, W, C) contiguous, float32 or bf16
// alike; flow (B, G1, G2, 2) float32 normalized xy; out (B, G1, G2, (2r+1)²)
// float32. Returns the cudaError_t of the launch (0 on success).
extern "C" int gfnet_local_corr(const void* query, const void* target, const void* flow,
                                void* out, int batch, int g1, int g2, int height, int width,
                                int channels, int radius, float inv_sqrt_c, int is_bf16,
                                void* stream) {
  if (batch <= 0 || g1 <= 0 || g2 <= 0 || height <= 0 || width <= 0 || channels <= 0 ||
      radius < 0)
    return cudaErrorInvalidValue;
  const int ncells = batch * g1 * g2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(query, target, flow, out, ncells, g1 * g2, height, width,
                                 channels, radius, inv_sqrt_c, s);
  return launch<float>(query, target, flow, out, ncells, g1 * g2, height, width, channels,
                       radius, inv_sqrt_c, s);
}
