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
// (2r+2)²·C target values and writes (2r+1)² floats. Counted once per input
// and output byte it moves a few MB per call at ~1 flop per byte, and its
// float32 operation bound (1–4 µs at the main path's shapes) is as large as
// its byte bound. No tensor cores: the products are (2r+2)² dots of length C
// per cell, too small and too irregular for `wgmma`/`mma.sync` to pay, and
// the float32 FMA rate is not what holds the kernel back. What does is
// moving the target: neighbouring cells' windows overlap, and a cell reading
// its own patch re-reads (2r+2)²·C values that its neighbours read too
// (411 MB through L2 at r6, 8 images of 56², against a 6.4 MB map).
//
// Design: a block of eight warps owns a tile of neighbouring cells of one
// image (`local_corr_window.cuh`). Where the union of the tile's windows fits
// the launch's box, TMA copies the box into shared memory once per channel
// chunk and the tile's cells read their patches from there; the TPU kernel
// kept the whole map in VMEM for the same reuse. Where it does not fit
// (random or broken flow), each cell reads its patch from global memory,
// bounds-checked. The wrapper (`ops/kernels.py: corr_schedule`) picks the
// tile, the box and the chunk from r, C, the dtype and the cells' spacing in
// target pixels, so that three blocks fit an SM, a warp walks at most 256
// patch pixels and the grid has about two blocks an SM or more at every
// main-path shape: it stages 2×4 cells in a 20×23 box at r7 and t/g = 1
// (59 KB in bf16), 2×4 in 19×24 at r6 and t/g = 1.75, 4×4 in 20×20 at r4 and
// 4×8 in 16×27 at r2; float32 C=64 goes in two chunks of 32 channels.
//
// While thread 0's TMA load is in flight, the block copies its cells' query
// rows into shared memory. Then one warp per cell at a time. Its lanes go
// along the channels: L lanes (the chunk's 16-byte vectors, 1 to 8) share
// one pixel, so a warp reads 32/L pixels with one 16-byte load a lane, and
// holds the cell's query chunk in registers. (Lanes along the pixels would
// need the box padded or swizzled against 32-way bank conflicts, and would
// scatter the per-cell branch's loads over 32 pixels; along the channels a
// quarter-warp reads 128 contiguous bytes from either.) Each lane runs L
// pixel steps, one partial dot each; a reduce-scatter over the L lanes of a
// pixel (L−1 shuffles) leaves one full dot of 32 patch pixels in every lane.
// The (2r+2)² dots of a cell collect in shared memory, over the chunks, and
// the four shifted corners combine into the (2r+1)² outputs, scaled by 1/√C. Both branches sum in the same order,
// so the output does not depend on the branch. A non-finite flow, or a
// window that misses the map, gives an all-zero window. The TPU version's
// selection-matrix combine and 8-aligned bf16 staging were Mosaic
// workarounds and have no counterpart here.

#include "local_corr_window.cuh"

namespace {

using namespace gfnet;

// The dots of one chunk of a cell's (2r+2)² patch with the query chunk `q`,
// added into `dots` (written on the first chunk).
template <typename T, int L, typename Patch>
__device__ __forceinline__ void patch_dots(const Patch& patch, const float (&q)[Vec<T>::n],
                                           float* dots, int win2, bool first, int lane) {
  constexpr int G = 32 / L;  // pixels a warp reads at once
  const int vec = lane % L, grp = lane / L;
  for (int base = 0; base < win2; base += 32) {
    float part[L];
#pragma unroll
    for (int s = 0; s < L; ++s) {
      const int p = base + s * G + grp;
      float acc = 0.f;
      if (p < win2) {
        float v[Vec<T>::n];
        Vec<T>::unpack(patch.load(p, vec), v);
#pragma unroll
        for (int i = 0; i < Vec<T>::n; ++i) acc = fmaf(v[i], q[i], acc);
      }
      part[s] = acc;
    }
    // reduce-scatter over the L lanes of a pixel: lane `vec` ends with the
    // whole dot of step s = vec
#pragma unroll
    for (int m = L / 2; m >= 1; m /= 2) {
      const bool upper = vec & m;
#pragma unroll
      for (int i = 0; i < m; ++i) {
        const float send = upper ? part[i] : part[i + m];
        const float keep = upper ? part[i + m] : part[i];
        part[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
      }
    }
    const int p = base + vec * G + grp;
    if (p < win2) dots[p] = first ? part[0] : dots[p] + part[0];
  }
}

template <typename T, int L>
__global__ void __launch_bounds__(kCorrThreads, 3)
local_corr_kernel(const __grid_constant__ CUtensorMap map, const T* __restrict__ query,
                  const T* __restrict__ target, const float* __restrict__ flow,
                  float* __restrict__ out, const CorrTiling t, float inv_sqrt_c) {
  constexpr int VE = Vec<T>::n;
  extern __shared__ uint8_t smem_raw[];
  __shared__ TileState st;
  uint8_t* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  float* dots = reinterpret_cast<float*>(smem + t.smem_cells);
  uint4* qs = reinterpret_cast<uint4*>(smem + t.smem_query);
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
  // the tile's query rows into shared memory while the box is in flight
  const int row_vecs = t.channels * (int)sizeof(T) / 16;
  for (int v = threadIdx.x; v < cells * row_vecs; v += kCorrThreads) {
    const int i = v / row_vecs;
    const int gy = gy0 + i / t.tile_x, gx = gx0 + i % t.tile_x;
    if (gy < t.g1 && gx < t.g2 && !st.win[i].outside)
      qs[v] = __ldg(reinterpret_cast<const uint4*>(query) +
                    (((long long)b * t.g1 + gy) * t.g2 + gx) * row_vecs + v % row_vecs);
  }
  __syncthreads();

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
      float q[VE];
      Vec<T>::unpack(lds128(smem_u32(qs + i * row_vecs + k * L + lane % L)), q);
      float* cd = dots + i * win2;
      if (staged) {
        const StagedPatch patch{
            smem_u32(smem) + ((w.y0 - st.lo_y) * t.box_w + (w.x0 - st.lo_x)) * pix, table, pix};
        patch_dots<T, L>(patch, q, cd, win2, k == 0, lane);
      } else {
        const GlobalPatch patch{img + k * pix, table, w.x0, w.y0, t.height, t.width,
                                (long long)t.width * t.channels * (int)sizeof(T),
                                t.channels * (int)sizeof(T)};
        patch_dots<T, L>(patch, q, cd, win2, k == 0, lane);
      }
    }
  }
  __syncwarp();

  for (int i = warp; i < cells; i += kCorrWarps) {
    const int gy = gy0 + i / t.tile_x, gx = gx0 + i % t.tile_x;
    if (gy >= t.g1 || gx >= t.g2) continue;
    const CorrWindow& w = st.win[i];
    float* o = out + (((long long)b * t.g1 + gy) * t.g2 + gx) * taps * taps;
    if (w.outside) {
      for (int p = lane; p < taps * taps; p += 32) o[p] = 0.f;
      continue;
    }
    const float* cd = dots + i * win2;
    for (int p = lane; p < taps * taps; p += 32) {
      const float* s = cd + (p / taps) * win + p % taps;
      o[p] = (w.w00 * s[0] + w.w01 * s[1] + w.w10 * s[win] + w.w11 * s[win + 1]) * inv_sqrt_c;
    }
  }
}

template <typename T, int L>
cudaError_t launch(const void* query, const void* target, const void* flow, void* out,
                   const CorrTiling& t, float inv_sqrt_c, cudaStream_t stream) {
  static int allowed[64] = {};
  CUtensorMap map;
  if (!corr_target_map(&map, target, t, sizeof(T))) return cudaErrorInvalidValue;
  const int smem = t.smem_total;
  cudaError_t err = corr_allow_smem(local_corr_kernel<T, L>, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((t.g2 + t.tile_x - 1) / t.tile_x, (t.g1 + t.tile_y - 1) / t.tile_y, t.batch);
  local_corr_kernel<T, L><<<grid, kCorrThreads, smem, stream>>>(
      map, static_cast<const T*>(query), static_cast<const T*>(target),
      static_cast<const float*>(flow), static_cast<float*>(out), t, inv_sqrt_c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* query, const void* target, const void* flow, void* out,
                     const CorrTiling& t, float inv_sqrt_c, cudaStream_t stream) {
  switch (corr_lanes(t, sizeof(T), true)) {
    case 1:
      return launch<T, 1>(query, target, flow, out, t, inv_sqrt_c, stream);
    case 2:
      return launch<T, 2>(query, target, flow, out, t, inv_sqrt_c, stream);
    case 4:
      return launch<T, 4>(query, target, flow, out, t, inv_sqrt_c, stream);
    case 8:
      return launch<T, 8>(query, target, flow, out, t, inv_sqrt_c, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// query (B, G1, G2, C) and target (B, H, W, C) contiguous and 16-byte
// aligned, float32 or bf16 alike; flow (B, G1, G2, 2) float32 normalized xy;
// out (B, G1, G2, (2r+1)²) float32. The tiling (cells a block owns, the box
// it may stage, channels per stage, the shared-memory layout) comes from
// the wrapper; `device` is the tensors'. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int gfnet_local_corr(int device, const void* query, const void* target, const void* flow,
                                void* out, int batch, int g1, int g2, int height, int width,
                                int channels, int radius, int tile_y, int tile_x, int box_h,
                                int box_w, int chunk, int smem_cells, int smem_query,
                                int smem_table, int smem_total, float inv_sqrt_c, int is_bf16,
                                void* stream) {
  // The calling thread may have no context current (PyTorch's autograd
  // engine runs a backward, and a recomputed forward, on threads of its
  // own, where a first launch would fail): make the tensors' device, and its
  // primary context, current first.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  const CorrTiling t{batch, g1, g2, height, width, channels, radius, tile_y, tile_x, box_h,
                     box_w, chunk, smem_cells, smem_query, smem_table, smem_total};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch<__nv_bfloat16>(query, target, flow, out, t, inv_sqrt_c, s);
  return dispatch<float>(query, target, flow, out, t, inv_sqrt_c, s);
}
