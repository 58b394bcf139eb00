// K5: the ViT block's residual stream, one pass over each token row.
//
// Over rows of D channels (float32 or bf16, every tensor of one dtype):
//   s = x                                      where there is no update h,
//   s = round(x + round(h · gamma))            where there is (LayerScale, then the residual add),
//   n = round(layer_norm_f32(s) · weight + bias)  where there is a norm,
// with round() the dtype's rounding (none in float32) and the norm's
// statistics in float32. A ViT block makes three calls (`ops/residual_norm.py`,
// caller `models/vit.py`): norm1 alone; the add of the attention's output
// with norm2; the add of the FFN's output alone. The ViT's final norm is a
// fourth use of the first.
//
// Replaces no TPU kernel: the JAX package leaves the norms, LayerScale and
// adds (gfnet_tpu/models/vit.py) to XLA, which fuses them. The plain PyTorch
// path cannot: each LayerNorm is five launches (the bf16 row to float32, the
// weight and bias to float32, ATen's float32 layer_norm, the cast back), each
// LayerScale and each add one more, about 60 bytes an element a block where
// reading and writing the stream takes 18.
//
// What bounds it on the H100: bytes. Per element it reads and writes 4 (norm
// alone), 8 (add and norm: x and h in, s and n out) or 6 (add alone) bytes in
// bf16, twice that in float32, and does a dozen float32 operations: at
// 3.35 TB/s the add and norm of the 560² pass of a ViT-g batch, 25,680 rows
// of 1536, moves 315.6 MB in 0.094 ms.
//
// Design: one warp a row, eight rows a block. The row stays in registers
// from its load to its last store: lane l holds chunks l, l + 32, ... of 8
// channels (one 16-byte load in bf16, two in float32), so neighbouring lanes
// read neighbouring 16 bytes, and a D = 1536 row is six chunks a lane
// (`kChunks`, a template parameter: 1 to 6, D any multiple of 8 up to 1536).
// Every load of a row is in flight before its first use. The mean and then the
// centred sum of squares are taken from the registers by butterfly shuffles,
// with no second read of memory; rstd = rsqrt(var + eps), as ATen's
// layer_norm. Weight, bias and gamma are read in the dtype of the rows, from
// L1/L2. s is written once (not at all where there is no update), n once.
// No persistent grid: the largest call has 25,680 rows, 3,210 blocks, a few
// waves over 132 SMs, and a block's work is one load, reduce and store of 8
// rows (a few µs), so the last partial wave costs a few µs of a 0.1 ms pass.
//
// Arithmetic: s is the plain path's bit for bit (the product and the sum each
// rounded to nearest even, no FMA contraction: `__fmul_rn`, `__fadd_rn`). n is
// ATen's formula, weight · (rstd · (s − mean)) + bias as one FMA, with the
// statistics in another order of summation (ATen's Welford over vectors), so
// the float32 n differs by a few ulps of the norm's terms, and the bf16 n by
// one bf16 ulp where a float32 value lay next to a rounding boundary, more
// only where weight · (s − mean) · rstd and bias cancel to far below either.
// No atomics: a run repeats bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;       // rows a block
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 8;       // channels a lane moves at once
constexpr int kMaxChunks = 6;   // chunks a lane: D up to 6 · 32 · 8 = 1536

// 8 channels of a row as loaded: one 16-byte vector of bf16, two of float32
template <typename T>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) { raw = __ldg(reinterpret_cast<const uint4*>(p)); }
  __device__ __forceinline__ void unpack(float (&v)[kChunk]) const {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ float round(float f) { return __bfloat162float(__float2bfloat16_rn(f)); }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[kChunk]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 two = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&two);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Chunk<float> {
  float4 lo, hi;
  __device__ __forceinline__ void load(const float* p) {
    lo = __ldg(reinterpret_cast<const float4*>(p));
    hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void unpack(float (&v)[kChunk]) const {
    v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
    v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
  }
  static __device__ __forceinline__ float round(float f) { return f; }
  static __device__ __forceinline__ void store(float* p, const float (&v)[kChunk]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// kAdd: s = x + h · gamma, written to s; kNorm: n = layer_norm(s), written to n
template <typename T, int kChunks, bool kAdd, bool kNorm>
__global__ void __launch_bounds__(kThreads) residual_norm_kernel(
    const T* __restrict__ x, const T* __restrict__ h, const T* __restrict__ gamma, const T* __restrict__ weight,
    const T* __restrict__ bias, T* __restrict__ s, T* __restrict__ n, long long rows, int d, float eps) {
  using C = Chunk<T>;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int chunks = d / kChunk;
  const size_t base = static_cast<size_t>(row) * d;

  C xc[kChunks], hc[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) {
      xc[i].load(x + base + c * kChunk);
      if constexpr (kAdd) hc[i].load(h + base + c * kChunk);
    }
  }

  float v[kChunks][kChunk];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) {
      xc[i].unpack(v[i]);
      if constexpr (kAdd) {
        C gc;
        gc.load(gamma + c * kChunk);
        float hv[kChunk], g[kChunk];
        hc[i].unpack(hv);
        gc.unpack(g);
#pragma unroll
        for (int j = 0; j < kChunk; ++j) v[i][j] = C::round(__fadd_rn(v[i][j], C::round(__fmul_rn(hv[j], g[j]))));
        C::store(s + base + c * kChunk, v[i]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) v[i][j] = 0.0f;
    }
  }

  if constexpr (kNorm) {
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < kChunks; ++i)
#pragma unroll
      for (int j = 0; j < kChunk; ++j) sum += v[i][j];  // zero past the row's end
    const float mean = warp_sum(sum) / static_cast<float>(d);
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      if (lane + 32 * i < chunks) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const float t = v[i][j] - mean;
          sq = fmaf(t, t, sq);
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(d) + eps);
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = lane + 32 * i;
      if (c < chunks) {
        C wc, bc;
        wc.load(weight + c * kChunk);
        bc.load(bias + c * kChunk);
        float w[kChunk], b[kChunk], out[kChunk];
        wc.unpack(w);
        bc.unpack(b);
#pragma unroll
        for (int j = 0; j < kChunk; ++j) out[j] = fmaf(w[j], rstd * (v[i][j] - mean), b[j]);
        C::store(n + base + c * kChunk, out);
      }
    }
  }
}

struct Args {
  const void *x, *h, *gamma, *weight, *bias;
  void *s, *n;
  long long rows;
  int d;
  float eps;
  cudaStream_t stream;
};

template <typename T, int kChunks, bool kAdd, bool kNorm>
cudaError_t launch(const Args& a) {
  const long long blocks = (a.rows + kWarps - 1) / kWarps;
  residual_norm_kernel<T, kChunks, kAdd, kNorm><<<static_cast<unsigned>(blocks), kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.h), static_cast<const T*>(a.gamma),
      static_cast<const T*>(a.weight), static_cast<const T*>(a.bias), static_cast<T*>(a.s), static_cast<T*>(a.n),
      a.rows, a.d, a.eps);
  return cudaGetLastError();
}

template <typename T, bool kAdd, bool kNorm>
cudaError_t by_chunks(int chunks_a_lane, const Args& a) {
  switch (chunks_a_lane) {
    case 1: return launch<T, 1, kAdd, kNorm>(a);
    case 2: return launch<T, 2, kAdd, kNorm>(a);
    case 3: return launch<T, 3, kAdd, kNorm>(a);
    case 4: return launch<T, 4, kAdd, kNorm>(a);
    case 5: return launch<T, 5, kAdd, kNorm>(a);
    case 6: return launch<T, 6, kAdd, kNorm>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_use(bool add, bool norm, int chunks_a_lane, const Args& a) {
  if (add && norm) return by_chunks<T, true, true>(chunks_a_lane, a);
  if (add) return by_chunks<T, true, false>(chunks_a_lane, a);
  return by_chunks<T, false, true>(chunks_a_lane, a);
}

}  // namespace

// x (and h, s, n where given) (rows, d) contiguous, gamma, weight, bias (d),
// all of one dtype (bf16 where `bf16`, else float32), each 16-byte aligned,
// d a multiple of 8 up to 1536. h and gamma null: no update (s is x, not
// written); weight and bias null: no norm. s and n must not overlap x or h.
extern "C" int gfnet_residual_norm(int device, const void* x, const void* h, const void* gamma, const void* weight,
                                   const void* bias, void* s, void* n, long long rows, int d, float eps, int bf16,
                                   void* stream) {
  const cudaError_t set = cudaSetDevice(device);  // see gfnet_local_corr_bwd
  if (set != cudaSuccess) return set;
  const bool add = h != nullptr, norm = weight != nullptr;
  if (!(add || norm) || rows < 1 || d < kChunk || d % kChunk || d > kMaxChunks * 32 * kChunk ||
      (rows + kWarps - 1) / kWarps > 0x7fffffffLL || x == nullptr || (add && (gamma == nullptr || s == nullptr)) ||
      (norm && (bias == nullptr || n == nullptr)))
    return cudaErrorInvalidValue;
  const Args a{x, h, gamma, weight, bias, s, n, rows, d, eps, static_cast<cudaStream_t>(stream)};
  const int chunks_a_lane = (d / kChunk + 31) / 32;
  return bf16 ? by_use<__nv_bfloat16>(add, norm, chunks_a_lane, a) : by_use<float>(add, norm, chunks_a_lane, a);
}
