// K6: the refiner block's depthwise 5x5 conv, BatchNorm and ReLU, one pass.
//
// Over x (B, H, W, C) bf16 or float32, contiguous NHWC, with the depthwise
// weight (C, 1, 5, 5), its bias and the BatchNorm's running mean, running
// variance, weight and bias (C,), all float32, each output element is
//   s   = T(sum of the 25 taps x * w, then + bias)   taps off the map read zero (padding 2)
//   mul = weight * rsqrt(var + eps)
//   t   = T(((float(s) - mean) * mul) + beta)        three float32 roundings, no contraction
//   out = relu(t)                                    NaN propagates
// in x's type T, which is the plain path's chain (`models/refiner.RefineBlock`:
// `Conv` with `depthwise=True`, `BatchNorm` in eval mode, `Act("relu")`) with
// its roundings: the taps accumulate in float32 in one fixed order (rows,
// then columns, by FMA), the bias is added after them, s and t round to bf16
// where the plain path casts (in float32 they stay as computed). Only the
// order of the taps' sum can differ from cuDNN's, which would put s one bf16
// ulp off where a float32 sum lay next to a rounding boundary (a few float32
// ulps of the taps' terms in float32); on an H100 with torch 2.11 (CUDA 12.8)
// bf16 agrees bit for bit at every shape tried (`chip_smoke.py` phase k6).
//
// Replaces no TPU kernel: the JAX package leaves the refine block's depthwise
// conv, BatchNorm and ReLU (gfnet_tpu/models/refiner.py) to XLA, which fuses
// them. The plain PyTorch path cannot: a cast to float32, cuDNN's float32
// depthwise conv, a cast back, the BatchNorm's float32 copy, sub, mul and add,
// three launches for its scale, a cast and the ReLU, 12 launches and about
// 60 bytes an element where reading and writing bf16 takes 4.
//
// What bounds it on the H100: bytes, and the CUDA cores nearly as much. A
// basic batch call's nine blocks a refiner call move 1.487 G elements: 5.95
// GB, 1.78 ms at 3.35 TB/s; their 25 FMAs an element take 1.1 ms of the
// card's float32 issue, and each element's loads, roundings and store as
// many instructions again. So the kernel hides the memory behind the
// arithmetic and keeps the instructions around the FMAs few.
//
// Design: a persistent grid of blocks, each walking a strided list of output
// tiles of kRows rows by `tile_pixels` pixels of one image, with every
// channel. A block stages a tile's (kRows + 4) by (tile_pixels + 4) halo in
// shared memory in x's type while it computes the tile before (two stages).
// Each staged row is one contiguous run of (tile_pixels + 4) * C elements in
// memory, whatever C (417, 361, 177, 73, 24: odd, or not a multiple of 8), so
// it goes by 16-byte cp.async copies, one warp a row, placed at its offset
// within 16 bytes in memory; the few elements off the map that the copies
// bring are zeroed after they land. A thread takes one channel and kPixels
// neighbouring output pixels, holds that channel's 25 weights and BatchNorm
// constants in registers and walks down the tile's staged rows: each row is
// read once (kPixels + 4 values), feeds the five output rows it is a tap of,
// and the output row it completes is finished, two pixels at a time (bias,
// BatchNorm, ReLU) and written, neighbouring threads writing neighbouring
// channels. The tile and the grid (`ops/kernels.refine_plan`, the grid from
// `gfnet_refine_block_occupancy`) are chosen by the caller from (B, H, W, C)
// and x's type alone. The float32 kernels are the bf16 ones with 4-element
// vectors and no bf16 roundings; they serve the float32 model, whose stage
// is twice as wide (a 1-row tile at C = 417). No atomics: a run repeats bit
// for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTaps = 5;                 // the depthwise kernel: kTaps x kTaps, zero padding kTaps / 2
constexpr int kPad = kTaps / 2;
constexpr int kHalo = kTaps - 1;
constexpr int kPixels = 8;               // output pixels a thread, along a row (even: `finish2`)
constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 112 * 1024;     // a stage; a block holds two

// An element as staged and stored: bf16 as its 16 bits, float32 as itself.
// kVec elements make a 16-byte copy.
template <typename S>
constexpr int kVec = 16 / static_cast<int>(sizeof(S));

__device__ __forceinline__ float widen(unsigned short u) { return __uint_as_float(static_cast<uint32_t>(u) << 16); }
__device__ __forceinline__ float widen(float f) { return f; }

// elements a staged row takes: its run and up to kVec - 1 more, so that the
// run sits at its memory's offset within 16 bytes; a multiple of kVec
template <typename S>
__host__ __device__ __forceinline__ int staged_pitch(int tile_pixels, int c) {
  return ((tile_pixels + kHalo) * c + 2 * (kVec<S> - 1)) / kVec<S> * kVec<S>;
}

// where in its staged row a run starting at element `start` of x begins: the
// same offset within 16 bytes as in memory (x is 16-byte aligned)
template <typename S>
__device__ __forceinline__ int run_pad(long long start) { return static_cast<int>(start & (kVec<S> - 1)); }

__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }

// Two outputs from their taps' sums a0, a1: bias, BatchNorm and ReLU, each
// rounding where the plain path rounds, into o[0] and o[1]. In bf16 each
// rounding is one packed conversion of both, and the ReLU one bf16x2 max
// (NaN passes), since the conversion unit issues at an eighth of the FMA
// rate.
__device__ __forceinline__ void finish2(unsigned short (&o)[2], float a0, float a1, float bias, float mean, float mul,
                                        float beta) {
  const uint32_t s = bits(__floats2bfloat162_rn(__fadd_rn(a0, bias), __fadd_rn(a1, bias)));
  const float t0 = __fadd_rn(__fmul_rn(__fsub_rn(__uint_as_float(s << 16), mean), mul), beta);
  const float t1 = __fadd_rn(__fmul_rn(__fsub_rn(__uint_as_float(s & 0xffff0000u), mean), mul), beta);
  const uint32_t two = bits(__hmax2_nan(__floats2bfloat162_rn(t0, t1), __floats2bfloat162_rn(0.0f, 0.0f)));
  o[0] = static_cast<unsigned short>(two & 0xffffu);
  o[1] = static_cast<unsigned short>(two >> 16);
}

__device__ __forceinline__ float relu(float t) { return t > 0.0f || t != t ? t : 0.0f; }  // NaN passes

__device__ __forceinline__ void finish2(float (&o)[2], float a0, float a1, float bias, float mean, float mul,
                                        float beta) {
  o[0] = relu(__fadd_rn(__fmul_rn(__fsub_rn(__fadd_rn(a0, bias), mean), mul), beta));
  o[1] = relu(__fadd_rn(__fmul_rn(__fsub_rn(__fadd_rn(a1, bias), mean), mul), beta));
}

// The staged run of a tile starting at pixel w0: its first element in its
// image row, and the part of it on the map, [lo, hi); the rest reads zero.
struct Run {
  long long first;
  int lo, hi;
  __device__ __forceinline__ Run(int w0, int w, int c, int row_len) {
    const long long image_row = static_cast<long long>(w) * c;
    first = static_cast<long long>(w0 - kPad) * c;
    lo = static_cast<int>((first < 0 ? 0 : first) - first);
    hi = static_cast<int>((first + row_len < image_row ? first + row_len : image_row) - first);
  }
};

// Issue the copies that stage tile (b, h0, w0) in `tile`: kRows + 4 rows of
// `pitch` elements, row r the run of (tile_pixels + 4) * c elements of image
// row h0 - 2 + r that starts 2 pixels left of w0. Whole 16-byte vectors go
// by cp.async, covering the run's part on the map and up to kVec - 1
// elements either side (in the row's pitch; `clear_edges` zeroes them once
// the copies have landed); rows off the map are zeroed here. Only a vector
// past the end of x (`total` elements) is read element by element.
template <typename S, int kRows>
__device__ __forceinline__ void stage_tile(S* tile, const S* __restrict__ x, int b, int h0, int w0, int h, int w,
                                           int c, int tile_pixels, int pitch, long long total) {
  constexpr int V = kVec<S>;
  const int row_len = (tile_pixels + kHalo) * c;
  const Run run(w0, w, c, row_len);
  const long long image_row = static_cast<long long>(w) * c;
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < kRows + kHalo; r += warps) {  // a warp a row
    const int y = h0 - kPad + r;
    S* row = tile + r * pitch;
    if (y < 0 || y >= h) {
      for (int j = V * lane; j < pitch; j += V * 32) *reinterpret_cast<uint4*>(row + j) = make_uint4(0, 0, 0, 0);
      continue;
    }
    const long long start = (static_cast<long long>(b) * h + y) * image_row + run.first;  // element of run[0]
    const int pad = run_pad<S>(start);
    S* dst = row + pad;  // dst[j] is element start + j, at the same offset in 16 bytes
    const int j0 = run.lo - ((pad + run.lo) & (V - 1)), j1 = run.hi + ((V - ((pad + run.hi) & (V - 1))) & (V - 1));
    if (start + j1 <= total) {
      for (int j = j0 + V * lane; j < j1; j += V * 32) copy16(dst + j, x + (start + j));
    } else {  // the last row of x, whose last vector runs past its end
      for (int j = j0 + V * lane; j < j1; j += V * 32) {
        if (start + j + V <= total) {
          copy16(dst + j, x + (start + j));
        } else {
          for (int e = 0; e < V; ++e)
            if (start + j + e < total) dst[j + e] = __ldg(x + (start + j + e));
        }
      }
    }
  }
}

// Once every copy of tile (b, h0, w0) has landed: zero the elements of each
// run off the map (left of pixel 0, right of pixel w - 1). Returns whether
// the tile has any (the same for the whole block); a tile whose runs lie on
// the map has none.
template <typename S, int kRows>
__device__ __forceinline__ bool clear_edges(S* tile, int b, int h0, int w0, int h, int w, int c, int tile_pixels,
                                            int pitch) {
  const int row_len = (tile_pixels + kHalo) * c;
  const Run run(w0, w, c, row_len);
  if (run.lo == 0 && run.hi == row_len) return false;
  const long long image_row = static_cast<long long>(w) * c;
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < kRows + kHalo; r += warps) {  // a warp a row
    const int y = h0 - kPad + r;
    if (y < 0 || y >= h) continue;
    S* dst = tile + r * pitch + run_pad<S>((static_cast<long long>(b) * h + y) * image_row + run.first);
    for (int j = lane; j < run.lo; j += 32) dst[j] = S(0);
    for (int j = run.hi + lane; j < row_len; j += 32) dst[j] = S(0);
  }
  return true;
}

// One thread's outputs of the staged tile (b, h0, w0): channel ch of the
// kPixels pixels from x0 = w0 + g * kPixels, every row of the tile.
template <typename S, int kRows>
__device__ __forceinline__ void compute_tile(const S* tile, S* __restrict__ out, const float (&wk)[kTaps * kTaps],
                                             float cb, float mu, float mul, float beta, int b, int h0, int w0, int g,
                                             int ch, int h, int w, int c, int pitch) {
  constexpr int V = kVec<S>;
  const long long image_row = static_cast<long long>(w) * c;
  // the element of x at staged row 0's run[0] (`stage_tile`)
  const long long start0 =
      (static_cast<long long>(b) * h + h0 - kPad) * image_row + static_cast<long long>(w0 - kPad) * c;
  const int x0 = w0 + g * kPixels, off = g * kPixels * c + ch;  // off: the thread's column in the runs
  // staged row r's run starts `pad` elements into it (`stage_tile`); rows off
  // the map are zero over their whole pitch, so any pad reads them right
  const int pad0 = static_cast<int>(start0 & (V - 1)), pad_step = static_cast<int>(image_row & (V - 1));
  S* dst = out + ((static_cast<long long>(b) * h + h0) * w + x0) * c + ch;
  const bool whole = x0 + kPixels <= w;  // all of the thread's pixels on the map
  float acc[kRows][kPixels];             // fully unrolled: five rows of them live at a time
#pragma unroll
  for (int r = 0; r < kRows + kHalo; ++r) {
    const S* col = tile + r * pitch + ((pad0 + r * pad_step) & (V - 1)) + off;
    float v[kPixels + kHalo];  // the thread's kPixels + 4 staged values of row r
#pragma unroll
    for (int k = 0; k < kPixels + kHalo; ++k) v[k] = widen(col[k * c]);
    // staged row r is tap row dy of output row r - dy: rows arrive in order, so
    // each output sums its taps row by row, and within a row column by column;
    // the pixels' sums are independent, so they take turns
#pragma unroll
    for (int dy = 0; dy < kTaps; ++dy) {
      const int o = r - dy;
      if (o < 0 || o >= kRows) continue;
#pragma unroll
      for (int dx = 0; dx < kTaps; ++dx)
#pragma unroll
        for (int q = 0; q < kPixels; ++q)
          acc[o][q] = fmaf(v[q + dx], wk[dy * kTaps + dx], dy == 0 && dx == 0 ? 0.0f : acc[o][q]);
    }
    const int o = r - kHalo;  // the output row this staged row completes
    if (o >= 0 && h0 + o < h) {
      S* p = dst;  // walks the row's pixels, c elements apart
      dst += image_row;
      S two[2];
      if (whole) {
#pragma unroll
        for (int q = 0; q < kPixels; q += 2) {
          finish2(two, acc[o][q], acc[o][q + 1], cb, mu, mul, beta);
          p[0] = two[0];
          p[c] = two[1];
          p += 2 * c;
        }
      } else {  // the map's last pixels
#pragma unroll
        for (int q = 0; q < kPixels; q += 2) {
          finish2(two, acc[o][q], acc[o][q + 1], cb, mu, mul, beta);
          if (x0 + q < w) p[0] = two[0];
          if (x0 + q + 1 < w) p[c] = two[1];
          p += 2 * c;
        }
      }
    }
  }
}

// A persistent grid: block i takes tiles i, i + gridDim.x, ... (tile t: pixel
// tile t % tiles_x, then row tile, then image), staging the next tile in the
// other half of shared memory by cp.async while it computes this one.
template <typename S, int kRows>
__global__ void __launch_bounds__(kMaxThreads) refine_block_kernel(
    const S* __restrict__ x, const float* __restrict__ weight, const float* __restrict__ bias,
    const float* __restrict__ mean, const float* __restrict__ var, const float* __restrict__ bn_weight,
    const float* __restrict__ bn_bias, S* __restrict__ out, int h, int w, int c, int tile_pixels, int tiles_x,
    int tiles_y, int tiles, long long total, float eps) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];  // two stages of kRows + 4 rows of `pitch` elements
  S* smem = reinterpret_cast<S*>(smem_bytes);
  const int pitch = staged_pitch<S>(tile_pixels, c), stage = (kRows + kHalo) * pitch;
  const int groups = tile_pixels / kPixels;
  const bool computes = static_cast<int>(threadIdx.x) < groups * c;
  const int g = threadIdx.x / c, ch = computes ? threadIdx.x - g * c : 0;
  float wk[kTaps * kTaps];
#pragma unroll
  for (int k = 0; k < kTaps * kTaps; ++k) wk[k] = __ldg(weight + ch * kTaps * kTaps + k);
  const float cb = __ldg(bias + ch), mu = __ldg(mean + ch), beta = __ldg(bn_bias + ch);
  const float mul = __fmul_rn(__ldg(bn_weight + ch), rsqrtf(__fadd_rn(__ldg(var + ch), eps)));

  int t = blockIdx.x;
  auto origin = [&](int tile_index, int& b, int& h0, int& w0) {
    const int ty = tile_index / tiles_x;
    w0 = (tile_index - ty * tiles_x) * tile_pixels;
    b = ty / tiles_y;
    h0 = (ty - b * tiles_y) * kRows;
  };
  int b, h0, w0;
  origin(t, b, h0, w0);
  stage_tile<S, kRows>(smem, x, b, h0, w0, h, w, c, tile_pixels, pitch, total);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = 0; t < tiles; ++i) {
    const int next = t + gridDim.x;
    int nb = 0, nh0 = 0, nw0 = 0;
    if (next < tiles) {
      origin(next, nb, nh0, nw0);
      stage_tile<S, kRows>(smem + ((i + 1) & 1) * stage, x, nb, nh0, nw0, h, w, c, tile_pixels, pitch, total);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this thread's copies of this tile, not the next one's
    __syncthreads();  // every thread's
    if (clear_edges<S, kRows>(smem + (i & 1) * stage, b, h0, w0, h, w, c, tile_pixels, pitch)) __syncthreads();
    if (computes)
      compute_tile<S, kRows>(smem + (i & 1) * stage, out, wk, cb, mu, mul, beta, b, h0, w0, g, ch, h, w, c, pitch);
    __syncthreads();  // read before the stage after next overwrites it
    t = next, b = nb, h0 = nh0, w0 = nw0;
  }
}

// The kernel for an element of `itemsize` bytes (2: bf16, 4: float32) and a
// tile of `rows` rows, or null for any other. Only float32 takes 1 row: its
// stage is twice as wide, and at C = 417 no taller one fits.
const void* kernel_for(int itemsize, int rows) {
  if (itemsize == 2) {
    switch (rows) {
      case 2: return reinterpret_cast<const void*>(refine_block_kernel<unsigned short, 2>);
      case 4: return reinterpret_cast<const void*>(refine_block_kernel<unsigned short, 4>);
      case 8: return reinterpret_cast<const void*>(refine_block_kernel<unsigned short, 8>);
      default: return nullptr;
    }
  }
  if (itemsize == 4) {
    switch (rows) {
      case 1: return reinterpret_cast<const void*>(refine_block_kernel<float, 1>);
      case 2: return reinterpret_cast<const void*>(refine_block_kernel<float, 2>);
      case 4: return reinterpret_cast<const void*>(refine_block_kernel<float, 4>);
      case 8: return reinterpret_cast<const void*>(refine_block_kernel<float, 8>);
      default: return nullptr;
    }
  }
  return nullptr;
}

// Checks a launch's shape against the kernel's limits and lets the kernel
// take its two stages of shared memory. Returns the kernel, or null.
const void* prepare(int itemsize, int c, int tile_rows, int tile_pixels, int* threads, int* smem) {
  const void* kernel = kernel_for(itemsize, tile_rows);
  if (kernel == nullptr || c < 1 || tile_pixels < kPixels || tile_pixels % kPixels) return nullptr;
  const long long t = (static_cast<long long>(tile_pixels / kPixels) * c + 31) / 32 * 32;
  const long long pitch = itemsize == 2 ? staged_pitch<unsigned short>(tile_pixels, c)
                                        : staged_pitch<float>(tile_pixels, c);
  const long long stage = static_cast<long long>(tile_rows + kHalo) * pitch * itemsize;
  if (t > kMaxThreads || stage > kMaxSmem) return nullptr;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 2 * kMaxSmem) != cudaSuccess)
    return nullptr;
  *threads = static_cast<int>(t);
  *smem = static_cast<int>(2 * stage);
  return kernel;
}

}  // namespace

// How many blocks of K6 with elements of `itemsize` bytes (2 or 4) and a
// tile of tile_rows (2, 4 or 8; float32 also 1) by tile_pixels (a multiple of kPixels)
// pixels at width c fit an SM of `device` at once (`per_sm`): the caller's
// grid for a persistent launch. Its threads, tile_pixels / kPixels * c
// rounded up to a warp, at most kMaxThreads; each of its two stages,
// (tile_rows + 4) * staged_pitch * itemsize bytes, at most kMaxSmem.
extern "C" int gfnet_refine_block_occupancy(int device, int itemsize, int c, int tile_rows, int tile_pixels,
                                            int* per_sm) {
  const cudaError_t set = cudaSetDevice(device);  // see gfnet_local_corr_bwd
  if (set != cudaSuccess) return set;
  int threads = 0, smem = 0;
  const void* kernel = prepare(itemsize, c, tile_rows, tile_pixels, &threads, &smem);
  if (kernel == nullptr || per_sm == nullptr) return cudaErrorInvalidValue;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
}

// x and out (b, h, w, c) contiguous, bf16 (itemsize 2) or float32 (4), not
// overlapping, x 16-byte aligned; weight (c, 1, 5, 5) and bias, mean, var,
// bn_weight, bn_bias (c) contiguous float32. The tile as for
// `gfnet_refine_block_occupancy`; `grid` blocks, each walking every grid-th
// tile.
extern "C" int gfnet_refine_block(int device, int itemsize, const void* x, const void* weight, const void* bias,
                                  const void* mean, const void* var, const void* bn_weight, const void* bn_bias,
                                  void* out, int b, int h, int w, int c, int tile_rows, int tile_pixels, int grid,
                                  float eps, void* stream) {
  const cudaError_t set = cudaSetDevice(device);  // see gfnet_local_corr_bwd
  if (set != cudaSuccess) return set;
  int threads = 0, smem = 0;
  const void* kernel = prepare(itemsize, c, tile_rows, tile_pixels, &threads, &smem);
  if (kernel == nullptr || b < 1 || h < 1 || w < 1 || grid < 1 || x == nullptr || weight == nullptr ||
      bias == nullptr || mean == nullptr || var == nullptr || bn_weight == nullptr || bn_bias == nullptr ||
      out == nullptr)
    return cudaErrorInvalidValue;
  int tiles_x = (w + tile_pixels - 1) / tile_pixels, tiles_y = (h + tile_rows - 1) / tile_rows;
  const long long tiles = static_cast<long long>(tiles_x) * tiles_y * b;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  int n = static_cast<int>(tiles);
  long long total = static_cast<long long>(b) * h * w * c;
  void* args[] = {&x, &weight, &bias, &mean, &var, &bn_weight, &bn_bias, &out, &h, &w, &c, &tile_pixels,
                  &tiles_x, &tiles_y, &n, &total, &eps};
  const cudaError_t err = cudaLaunchKernel(kernel, dim3(grid < n ? grid : n), dim3(threads), args,
                                           static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}
