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
// What bounds it on the H100: like the forward it does (2r+2)²·C
// multiply-adds per cell on target values that neighbouring cells largely
// share; counted once per input and output byte it moves a few MB, and its
// float32 operation bound is as large as its byte bound. No tensor cores, for
// the forward's reason. What holds it back is re-reading the overlapping
// patches through L2 (411 MB at r6, 8 images of 56², for a 6.4 MB map).
//
// Design: the forward's tiles (`local_corr_window.cuh`): a block of eight
// warps owns neighbouring cells of one image, stages the union of their
// windows in shared memory by TMA where it fits the launch's box, and
// otherwise reads each cell's patch from global memory, bounds-checked. One
// warp per cell at a time. While the box is in flight it spreads g into the
// cell's (2r+2)² weights in shared memory; then it walks the patch with its
// lanes along the channels: L lanes
// (the chunk's 16-byte vectors) share one pixel, the 32/L groups of lanes
// take every (32/L)-th pixel, each lane keeps the sums of its vector's 4
// (float32) or 8 (bf16) channels, and the groups add up with shuffles. One
// warp writes each dq once, in a fixed order, without atomics: the result is
// the same bits from launch to launch and in either branch. A window that
// misses the map, or a non-finite flow, gives dq = 0 exactly. The TPU
// version's selection matrices, padded target and 8-aligned bf16 staging
// were Mosaic workarounds and have no counterpart here.

#include "local_corr_window.cuh"

namespace {

using namespace gfnet;

// dq of one chunk of a cell: the spread weights `sw` contracted with the
// patch, written by the lanes of the first pixel group.
template <typename T, int L, typename Patch>
__device__ __forceinline__ void patch_dq(const Patch& patch, const float* sw, int win2, float* dq,
                                         int lane) {
  constexpr int G = 32 / L;  // pixel groups of a warp
  constexpr int VE = Vec<T>::n;
  const int vec = lane % L, grp = lane / L;
  float acc[VE];
#pragma unroll
  for (int i = 0; i < VE; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int p = grp; p < win2; p += G) {
    const float s = sw[p];
    float v[VE];
    Vec<T>::unpack(patch.load(p, vec), v);
#pragma unroll
    for (int i = 0; i < VE; ++i) acc[i] = fmaf(s, v[i], acc[i]);
  }
#pragma unroll
  for (int m = L; m < 32; m <<= 1)
#pragma unroll
    for (int i = 0; i < VE; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], m);
  if (grp == 0) {
    float4* d = reinterpret_cast<float4*>(dq + vec * VE);
#pragma unroll
    for (int i = 0; i < VE / 4; ++i)
      d[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  }
}

template <typename T, int L>
__global__ void __launch_bounds__(kCorrThreads, 3)
local_corr_bwd_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ grad,
                      const T* __restrict__ target, const float* __restrict__ flow,
                      float* __restrict__ dq, const CorrTiling t, float inv_sqrt_c) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ TileState st;
  uint8_t* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  float* sw_all = reinterpret_cast<float*>(smem + t.smem_cells);
  const int* table = reinterpret_cast<const int*>(smem + t.smem_table);

  const int b = blockIdx.z, gy0 = blockIdx.y * t.tile_y, gx0 = blockIdx.x * t.tile_x;
  const bool staged = tile_setup(st, reinterpret_cast<int*>(smem + t.smem_table), flow, t, b, gy0, gx0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cells = t.tile_y * t.tile_x;
  const int win = 2 * t.radius + 2, win2 = win * win, taps = win - 1;
  const int pix = t.chunk * (int)sizeof(T);  // bytes of a pixel's chunk
  const uint8_t* img =
      reinterpret_cast<const uint8_t*>(target + (long long)b * t.height * t.width * t.channels);

  const int box_bytes = t.box_h * t.box_w * pix;
  if (staged) issue_chunk(st, smem_u32(smem), &map, 0, t, b, box_bytes);
  // While the box is in flight, each warp spreads g into its cells' weights
  // (a cell outside gets dq = 0). Adjoint of the four-corner combine: tap
  // (ky, kx) read patch entries (ky, kx), (ky, kx+1), (ky+1, kx), (ky+1, kx+1).
  for (int i = warp; i < cells; i += kCorrWarps) {
    const int gy = gy0 + i / t.tile_x, gx = gx0 + i % t.tile_x;
    if (gy >= t.g1 || gx >= t.g2) continue;
    const long long cell = ((long long)b * t.g1 + gy) * t.g2 + gx;
    const CorrWindow& w = st.win[i];
    if (w.outside) {
      for (int c = lane; c < t.channels; c += 32) dq[cell * t.channels + c] = 0.f;
      continue;
    }
    const float* g = grad + cell * taps * taps;
    float* sw = sw_all + i * win2;
    for (int p = lane; p < win2; p += 32) {
      const int y = table[p] >> 24, x = (table[p] >> 16) & 0xff;
      float s = 0.f;
      if (y < taps && x < taps) s += w.w00 * __ldg(g + y * taps + x);
      if (y < taps && x > 0) s += w.w01 * __ldg(g + y * taps + x - 1);
      if (y > 0 && x < taps) s += w.w10 * __ldg(g + (y - 1) * taps + x);
      if (y > 0 && x > 0) s += w.w11 * __ldg(g + (y - 1) * taps + x - 1);
      sw[p] = s * inv_sqrt_c;
    }
  }
  __syncwarp();

  for (int k = 0; k < t.channels / t.chunk; ++k) {
    if (staged) {
      if (k > 0) {
        __syncthreads();  // the block has left the previous chunk
        issue_chunk(st, smem_u32(smem), &map, k, t, b, box_bytes);
      }
      wait_chunk(st, k);
    }
    for (int i = warp; i < cells; i += kCorrWarps) {
      const int gy = gy0 + i / t.tile_x, gx = gx0 + i % t.tile_x;
      const CorrWindow& w = st.win[i];
      if (gy >= t.g1 || gx >= t.g2 || w.outside) continue;
      float* out = dq + (((long long)b * t.g1 + gy) * t.g2 + gx) * t.channels + k * t.chunk;
      const float* sw = sw_all + i * win2;
      if (staged) {
        const StagedPatch patch{
            smem_u32(smem) + ((w.y0 - st.lo_y) * t.box_w + (w.x0 - st.lo_x)) * pix, table, pix};
        patch_dq<T, L>(patch, sw, win2, out, lane);
      } else {
        const GlobalPatch patch{img + k * pix, table, w.x0, w.y0, t.height, t.width,
                                (long long)t.width * t.channels * (int)sizeof(T),
                                t.channels * (int)sizeof(T)};
        patch_dq<T, L>(patch, sw, win2, out, lane);
      }
    }
  }
}

template <typename T, int L>
cudaError_t launch(const void* grad, const void* target, const void* flow, void* dq,
                   const CorrTiling& t, float inv_sqrt_c, cudaStream_t stream) {
  static int allowed[64] = {};
  CUtensorMap map;
  if (!corr_target_map(&map, target, t, sizeof(T))) return cudaErrorInvalidValue;
  const int smem = t.smem_total;
  cudaError_t err = corr_allow_smem(local_corr_bwd_kernel<T, L>, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((t.g2 + t.tile_x - 1) / t.tile_x, (t.g1 + t.tile_y - 1) / t.tile_y, t.batch);
  local_corr_bwd_kernel<T, L><<<grid, kCorrThreads, smem, stream>>>(
      map, static_cast<const float*>(grad), static_cast<const T*>(target),
      static_cast<const float*>(flow), static_cast<float*>(dq), t, inv_sqrt_c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* grad, const void* target, const void* flow, void* dq,
                     const CorrTiling& t, float inv_sqrt_c, cudaStream_t stream) {
  switch (corr_lanes(t, sizeof(T), false)) {
    case 1:
      return launch<T, 1>(grad, target, flow, dq, t, inv_sqrt_c, stream);
    case 2:
      return launch<T, 2>(grad, target, flow, dq, t, inv_sqrt_c, stream);
    case 4:
      return launch<T, 4>(grad, target, flow, dq, t, inv_sqrt_c, stream);
    case 8:
      return launch<T, 8>(grad, target, flow, dq, t, inv_sqrt_c, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// grad (B, G1, G2, (2r+1)²) float32, target (B, H, W, C) float32 or bf16
// (16-byte aligned), flow (B, G1, G2, 2) float32 normalized xy, all
// contiguous; dq (B, G1, G2, C) float32, 16-byte aligned. The tiling comes
// from the wrapper, as for the forward, laid out without query rows; `device`
// is the tensors'. Returns the cudaError_t of the launch (0 on success).
extern "C" int gfnet_local_corr_bwd(int device, const void* grad, const void* target, const void* flow,
                                    void* dq, int batch, int g1, int g2, int height, int width,
                                    int channels, int radius, int tile_y, int tile_x, int box_h,
                                    int box_w, int chunk, int smem_cells, int smem_query,
                                    int smem_table, int smem_total, float inv_sqrt_c,
                                    int target_is_bf16, void* stream) {
  // The calling thread may have no context current (PyTorch's autograd
  // engine runs a backward, and a recomputed forward, on threads of its
  // own, where a first launch would fail): make the tensors' device, and its
  // primary context, current first.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  const CorrTiling t{batch, g1, g2, height, width, channels, radius, tile_y, tile_x, box_h,
                     box_w, chunk, smem_cells, smem_query, smem_table, smem_total};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (target_is_bf16) return dispatch<__nv_bfloat16>(grad, target, flow, dq, t, inv_sqrt_c, s);
  return dispatch<float>(grad, target, flow, dq, t, inv_sqrt_c, s);
}
