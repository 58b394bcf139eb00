// What K2 (`local_corr.cu`) and K3 (`local_corr_bwd.cu`) share: the window
// of one cell, the tile of neighbouring cells a block owns, the box of the
// target that the tile stages in shared memory, and the loads from the box
// or straight from the map.
//
// The window of a cell: where its (2r+2)² integer patch of the target map
// starts, whether it meets the map at all, and the four bilinear corner
// weights that every tap of the cell shares. Both kernels take it from
// `corr_window`, so that both pick the same cells and the same weights when a
// coordinate sits on an integer: the arithmetic is float32 without FMA
// contraction, the same as the TPU package's `_precompute`
// (gfnet_tpu/ops/pallas/local_corr.py).
//
// The tile: a block owns `tile_y` × `tile_x` neighbouring cells of one image.
// It reduces the patch bases of its cells to the union box of their windows
// (cells whose window misses the map, or whose flow is not finite, take no
// part). If the union fits the launch's box (`box_h` × `box_w` pixels), one
// TMA load per channel chunk copies the box at the union's corner into shared
// memory, zero-filled where it lies off the map, and every cell of the tile
// reads its patch from there without bounds checks ("staged"). Otherwise each
// cell reads its patch from the map in global memory, bounds-checked ("per
// cell"). Both branches read 16-byte vectors with lanes along the channels
// and add up in the same order, so a cell's result does not depend on the
// branch its tile took. The wrapper picks tile, box and chunk for each launch
// (`gfnet_tpu_torch/ops/kernels.py: corr_schedule`, the rule is stated there);
// `ops/local_correlation.corr_tile_boxes` repeats the union and the staging
// decision in PyTorch.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; nothing of libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace gfnet {

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

// ------------------------------------------------------------------ the tile
constexpr int kCorrWarps = 8;
constexpr int kCorrThreads = kCorrWarps * 32;
constexpr int kMaxTileCells = 64;

// A launch's shapes and its tiling, as the wrapper chose it, with the layout
// of a block's dynamic shared memory (`ops/kernels.py: corr_layout` makes it;
// `corr_lanes` checks that each area holds what the kernels write there).
struct CorrTiling {
  int batch, g1, g2, height, width, channels, radius;
  int tile_y, tile_x;  // cells a block owns
  int box_h, box_w;    // target pixels a block may stage
  int chunk;           // channels per stage: 16, 32, 64 or 128 bytes of a pixel
  // byte offsets of the areas after the box at 0: (2r+2)² floats for each
  // cell (K2's patch dots, K3's spread gradient), the cells' query rows (K2
  // only), the table of patch pixels; and the size, with 128 bytes of slack
  // that align the base
  int smem_cells, smem_query, smem_table, smem_total;
};

struct TileState {
  CorrWindow win[kMaxTileCells];
  int lo_x, lo_y, hi_x, hi_y;  // least and largest patch base of the tile's cells
  int any;                     // some cell's window meets the map
  unsigned long long bar;      // the mbarrier of the box's TMA loads
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits for the phase of the given parity to complete. A wait that outlasts
// any sound run (seconds) traps, so that a lost arrival ends as a launch
// error and not as a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  int polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && ++polls > (1 << 22)) __trap();
  } while (!done);
}

// The tile's setup, by every thread of the block: the table of patch pixels,
// row-major (`table[p]` = row << 24 | column << 16 | the pixel's index in the
// box, row · box_w + column: rows and columns are below 128, the index below
// 65536), each cell's window (cells past the grid's edge count as outside),
// the union of the windows that meet the map, and the mbarrier. Returns
// whether the union fits the box, the same answer in every thread.
__device__ __forceinline__ bool tile_setup(TileState& st, int* table, const float* __restrict__ flow,
                                           const CorrTiling& t, int b, int gy0, int gx0) {
  const int win = 2 * t.radius + 2;
  const int cells = t.tile_y * t.tile_x;
  if (threadIdx.x == 0) {
    st.lo_x = st.lo_y = INT_MAX;
    st.hi_x = st.hi_y = INT_MIN;
    st.any = 0;
    mbar_init(smem_u32(&st.bar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int p = threadIdx.x; p < win * win; p += blockDim.x)
    table[p] = (p / win) << 24 | (p % win) << 16 | ((p / win) * t.box_w + p % win);
  __syncthreads();
  if (threadIdx.x < cells) {
    const int gy = gy0 + threadIdx.x / t.tile_x, gx = gx0 + threadIdx.x % t.tile_x;
    CorrWindow w;
    if (gy < t.g1 && gx < t.g2) {
      w = corr_window(flow + 2 * (((long long)b * t.g1 + gy) * t.g2 + gx), t.height, t.width,
                      t.radius);
    } else {
      w.outside = true;
      w.x0 = w.y0 = 0;
      w.w00 = w.w01 = w.w10 = w.w11 = 0.f;
    }
    st.win[threadIdx.x] = w;
    if (!w.outside) {  // an outside cell's base is a placeholder: it widens nothing
      atomicMin(&st.lo_x, w.x0);
      atomicMin(&st.lo_y, w.y0);
      atomicMax(&st.hi_x, w.x0);
      atomicMax(&st.hi_y, w.y0);
      st.any = 1;
    }
  }
  __syncthreads();
  return st.any && st.hi_x - st.lo_x + win <= t.box_w && st.hi_y - st.lo_y + win <= t.box_h;
}

// One chunk of the box (channels chunk·k.., the union's corner) by TMA from a
// (C, W, H, B) map, issued by thread 0; the part off the map lands as zeros.
// Before a second chunk the caller has the block leave the first.
__device__ __forceinline__ void issue_chunk(TileState& st, uint32_t box, const CUtensorMap* map,
                                            int k, const CorrTiling& t, int b, int bytes) {
  const uint32_t bar = smem_u32(&st.bar);
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, bytes);
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(box),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k * t.chunk), "r"(st.lo_x),
        "r"(st.lo_y), "r"(b)
        : "memory");
  }
}

// Every thread waits for chunk k to land.
__device__ __forceinline__ void wait_chunk(TileState& st, int k) {
  mbar_wait(smem_u32(&st.bar), k & 1);
}

// 16 bytes from shared memory
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// --------------------------------------------------------- 16-byte vectors
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void unpack(const uint4 v, float (&f)[4]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  // element 2i is the low half of word i
  __device__ __forceinline__ static void unpack(const uint4 v, float (&f)[8]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Vector `vec` of patch pixel p, from the cell's patch in the staged box: no
// bounds checks, the box holds zeros where it lies off the map.
struct StagedPatch {
  uint32_t base;     // shared address of vector 0 of the patch's first pixel
  const int* table;  // the patch pixels' rows, columns and indices in the box
  int pix;           // bytes of a pixel's chunk
  __device__ __forceinline__ uint4 load(int p, int vec) const {
    return lds128(base + (table[p] & 0xffff) * pix + vec * 16);
  }
};

// Vector `vec` of patch pixel p, from the map itself: pixels off the map
// read as zeros.
struct GlobalPatch {
  const uint8_t* img;  // the image's first pixel, at the chunk's first channel
  const int* table;    // the patch pixels' rows, columns and indices in the box
  int x0, y0, height, width;
  long long row;  // bytes of a map row
  int pix;        // bytes of a pixel (all channels)
  __device__ __forceinline__ uint4 load(int p, int vec) const {
    const int e = table[p];
    const int y = y0 + (e >> 24), x = x0 + ((e >> 16) & 0xff);
    if (y < 0 || y >= height || x < 0 || x >= width) return make_uint4(0u, 0u, 0u, 0u);
    return __ldg(reinterpret_cast<const uint4*>(img + y * row + (long long)x * pix + vec * 16));
  }
};

// ------------------------------------------------------------------- host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, fetched through the runtime: the library is not
// linked to libcuda.
inline EncodeTiled corr_encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res) !=
            cudaSuccess || res != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A (C, W, H, B) map over the contiguous (B, H, W, C) target; a box is
// `chunk` channels of `box_w` × `box_h` pixels of one image, unswizzled,
// zero-filled off the map. False if the encoder refuses it.
inline bool corr_target_map(CUtensorMap* map, const void* target, const CorrTiling& t, int elem) {
  EncodeTiled encode = corr_encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)t.channels, (cuuint64_t)t.width, (cuuint64_t)t.height,
                              (cuuint64_t)t.batch};
  const cuuint64_t px = (cuuint64_t)t.channels * elem;  // bytes
  const cuuint64_t strides[3] = {px, px * t.width, px * t.width * t.height};
  const cuuint32_t box[4] = {(cuuint32_t)t.chunk, (cuuint32_t)t.box_w, (cuuint32_t)t.box_h, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                4, const_cast<void*>(target), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The checks both launchers make on a tiling and its layout (`query_rows`:
// the kernel keeps the cells' query rows, as K2 does), and its vectors per
// chunk pixel (the lanes that share one pixel): 0 if the launch cannot take it.
inline int corr_lanes(const CorrTiling& t, int elem, bool query_rows) {
  const int win = 2 * t.radius + 2;
  if (t.batch <= 0 || t.g1 <= 0 || t.g2 <= 0 || t.height <= 0 || t.width <= 0 ||
      t.channels <= 0 || t.radius < 0 || t.tile_y <= 0 || t.tile_x <= 0 ||
      t.tile_y * t.tile_x > kMaxTileCells || t.box_h < win || t.box_w < win || t.box_h > 256 ||
      t.box_w > 256 || t.chunk <= 0 || t.channels % t.chunk || (t.channels * elem) % 16 ||
      win > 128)
    return 0;
  const long long cells = t.tile_y * t.tile_x, win2 = win * win;
  if ((t.smem_cells | t.smem_query | t.smem_table) & 127 ||
      t.smem_cells < (long long)t.box_h * t.box_w * t.chunk * elem ||
      t.smem_query - t.smem_cells < cells * win2 * 4 ||
      t.smem_table - t.smem_query < (query_rows ? cells * t.channels * elem : 0) ||
      t.smem_total - 128 - t.smem_table < win2 * 4)
    return 0;
  const int lanes = t.chunk * elem / 16;
  return (t.chunk * elem) % 16 == 0 && (lanes == 1 || lanes == 2 || lanes == 4 || lanes == 8)
             ? lanes
             : 0;
}

// Lets `kernel` use `bytes` of dynamic shared memory (above 48 KB it has to be
// asked for), once for each device and size: `allowed` is the caller's record
// for this kernel.
template <typename Kernel>
cudaError_t corr_allow_smem(Kernel kernel, int bytes, int (&allowed)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && allowed[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) allowed[dev] = bytes;
  return err;
}

}  // namespace gfnet
