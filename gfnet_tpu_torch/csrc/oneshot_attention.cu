// Streaming softmax attention for the ViT backbone and the cross-view decoder.
//
// Replaces the TPU kernel `oneshot_attention` (gfnet_tpu/ops/pallas/
// oneshot_attention.py, fold layout, body `_kernel`): non-causal
// softmax(q·kᵀ·scale)·v over (B, N, H, D) tensors.
//
// What bounds it on the H100: at the main path's shapes (N = 1025 / 1601,
// H = 16, D = 64; cross-view N = 1024 / 1600, H = 8, D = 8) the work is
// 4·N²·D·H·B flops against N·H·D·B·8 bytes of q/k/v/out: hundreds of
// operations per byte, so the tensor-core rate bounds it. The TPU design kept
// a whole kv row in VMEM; at N = 1601, D = 64 in bf16, K+V is ~410 KB, more
// than the 227 KB of shared memory one block may use. So both paths here
// stream kv tiles through shared memory with an online softmax (running max
// and sum, the accumulator rescaled when the max grows).
//
// Two paths, chosen by type and head dim:
//  - bf16 with D = 64 (every ViT attention): tensor cores through
//    `mma.sync.m16n8k16` (bf16 in, float32 accumulate). Four warps own 16 q
//    rows each; a block walks kv in 64-row tiles staged in shared memory (K
//    row-major, V transposed, rows padded to 72 so fragment loads hit 32
//    distinct banks). S = Q·Kᵀ stays in registers, and its accumulator layout
//    is reused as the A operand of P·V, so probabilities never touch memory.
//    The caller guarantees the 16-byte alignment its vector loads need.
//  - float32 at any D, and bf16 with D = 8 or 16: one thread per q row,
//    scalar FMAs on float32 tiles in shared memory. D = 8 is below the bf16
//    MMA's k = 16 and the float32 path keeps full precision.
// Both read q/k/v in place with their batch and token strides, so the
// (B,N,H,D)→(B·H,N,D) relayout of the TPU version, and the split of a fused
// qkv projection, cost no copy. TMA, wgmma and pipelined loads are later work.
//
// Numerics follow the TPU kernel: logits and softmax in float32; the
// probabilities are rounded to the storage type before the PV product, which
// accumulates in float32; the row sum comes from the unrounded probabilities
// and divides after PV; the ragged kv tail is masked by index, with no pad.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRows = 64;   // q rows per block, one per thread
constexpr int kTile = 64;   // kv rows per shared-memory tile
constexpr int kChunk = 16;  // keys per online-softmax update

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
oneshot_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out, int nq, int nk,
                         int heads, long long q_bs, long long q_ts, long long k_bs,
                         long long k_ts, long long v_bs, long long v_ts, float scale) {
  static_assert(D % 4 == 0, "head dim must be a multiple of 4");
  __shared__ __align__(16) float ks[kTile][D];
  __shared__ __align__(16) float vs[kTile][D];

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int row = blockIdx.x * kRows + threadIdx.x;

  // Threads past the last row still stage tiles, so they load a valid row.
  const T* qp = q + b * q_bs + (long long)min(row, nq - 1) * q_ts + h * D;
  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = to_f32(qp[d]);
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const T* kb = k + b * k_bs + h * D;
  const T* vb = v + b * v_bs + h * D;
  for (int t0 = 0; t0 < nk; t0 += kTile) {
    const int cnt = min(kTile, nk - t0);
    __syncthreads();  // the previous tile is fully consumed
    for (int i = threadIdx.x; i < cnt * D; i += kRows) {
      const int j = i / D, d = i % D;
      ks[j][d] = to_f32(kb[(long long)(t0 + j) * k_ts + d]);
      vs[j][d] = to_f32(vb[(long long)(t0 + j) * v_ts + d]);
    }
    __syncthreads();

    for (int c0 = 0; c0 < cnt; c0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        s[j] = -INFINITY;  // masked: keys past the tile's end
        if (c0 + j < cnt) {
          const float4* kr = reinterpret_cast<const float4*>(ks[c0 + j]);
          float dot = 0.f;
#pragma unroll
          for (int d4 = 0; d4 < D / 4; ++d4) {
            const float4 k4 = kr[d4];
            dot = fmaf(qr[4 * d4 + 0], k4.x, dot);
            dot = fmaf(qr[4 * d4 + 1], k4.y, dot);
            dot = fmaf(qr[4 * d4 + 2], k4.z, dot);
            dot = fmaf(qr[4 * d4 + 3], k4.w, dot);
          }
          s[j] = dot * scale;
        }
        cmax = fmaxf(cmax, s[j]);
      }
      // The first chunk always holds a real key, so m_new is finite and
      // alpha = exp(-inf) = 0 on the first update.
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (c0 + j < cnt) {
          const float p = expf(s[j] - m_new);
          l += p;
          const float pr = to_f32(from_f32<T>(p));  // PV operand in storage type
          const float4* vr = reinterpret_cast<const float4*>(vs[c0 + j]);
#pragma unroll
          for (int d4 = 0; d4 < D / 4; ++d4) {
            const float4 v4 = vr[d4];
            acc[4 * d4 + 0] = fmaf(pr, v4.x, acc[4 * d4 + 0]);
            acc[4 * d4 + 1] = fmaf(pr, v4.y, acc[4 * d4 + 1]);
            acc[4 * d4 + 2] = fmaf(pr, v4.z, acc[4 * d4 + 2]);
            acc[4 * d4 + 3] = fmaf(pr, v4.w, acc[4 * d4 + 3]);
          }
        }
      }
      m = m_new;
    }
  }

  if (row < nq) {
    const float inv = 1.f / l;
    T* op = out + (((long long)b * nq + row) * heads + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = from_f32<T>(acc[d] * inv);
  }
}

// ---------------------------------------------------------------- tensor cores
constexpr int kMmaWarps = 4;  // 16 q rows each
constexpr int kMmaTile = 64;  // kv rows per shared-memory tile
constexpr int kPad = 72;      // shared row stride in bf16: conflict-free fragment loads

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a·b for one 16x8x16 tile: a 16x16 bf16 (row), b 16x8 bf16 (col), c float32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): A regs hold
// (row g | g+8, cols 2t,2t+1 | 8+2t,9+2t); B regs (k = 2t,2t+1 | 8+2t,9+2t,
// n = g); C holds (row g, cols 2t,2t+1) then (row g+8, same cols).
__global__ void __launch_bounds__(kMmaWarps * 32)
oneshot_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                             int nq, int nk, int heads, long long q_bs, long long q_ts,
                             long long k_bs, long long k_ts, long long v_bs, long long v_ts,
                             float scale) {
  constexpr int D = 64;
  __shared__ __align__(16) __nv_bfloat16 ks[kMmaTile][kPad];  // (key, d)
  __shared__ __align__(16) __nv_bfloat16 vt[D][kPad];         // (d, key)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int r_lo = blockIdx.x * kMmaWarps * 16 + warp * 16 + g;
  const int r_hi = r_lo + 8;

  // Q as A fragments over the four 16-wide k-blocks of D; rows past nq are 0
  const __nv_bfloat16* qb = q + b * q_bs + h * D;
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = 16 * kk + 2 * t;
    qa[kk][0] = r_lo < nq ? load_pair(qb + r_lo * q_ts + c) : 0u;
    qa[kk][1] = r_hi < nq ? load_pair(qb + r_hi * q_ts + c) : 0u;
    qa[kk][2] = r_lo < nq ? load_pair(qb + r_lo * q_ts + c + 8) : 0u;
    qa[kk][3] = r_hi < nq ? load_pair(qb + r_hi * q_ts + c + 8) : 0u;
  }
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  const __nv_bfloat16* kb = k + b * k_bs + h * D;
  const __nv_bfloat16* vb = v + b * v_bs + h * D;
  for (int t0 = 0; t0 < nk; t0 += kMmaTile) {
    const int cnt = min(kMmaTile, nk - t0);
    __syncthreads();  // the previous tile is fully consumed
    // 16-byte loads; rows past the end are zero so that 0·P stays 0
    for (int i = threadIdx.x; i < kMmaTile * D / 8; i += kMmaWarps * 32) {
      const int j = i / (D / 8), c8 = (i % (D / 8)) * 8;
      uint4 k8 = make_uint4(0u, 0u, 0u, 0u), v8 = k8;
      if (j < cnt) {
        k8 = *reinterpret_cast<const uint4*>(kb + (t0 + j) * k_ts + c8);
        v8 = *reinterpret_cast<const uint4*>(vb + (t0 + j) * v_ts + c8);
      }
      *reinterpret_cast<uint4*>(&ks[j][c8]) = k8;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&v8);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[c8 + e][j] = ve[e];
    }
    __syncthreads();

    // S = Q·Kᵀ: 16 rows x 64 keys per warp, as 8 n-tiles
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_bf16(s[j], qa[kk], load_pair(&ks[8 * j + g][16 * kk + 2 * t]),
                 load_pair(&ks[8 * j + g][16 * kk + 8 + 2 * t]));
    }
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = 8 * j + 2 * t + (e & 1) < cnt ? s[j][e] * scale : -INFINITY;
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
    // the first tile always holds key 0, so the running max is finite after it
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo)), mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    const float a_lo = expf(m_lo - mn_lo), a_hi = expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= a_lo;
    l_hi *= a_hi;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j][0] *= a_lo;
      o[j][1] *= a_lo;
      o[j][2] *= a_hi;
      o[j][3] *= a_hi;
    }
    // P: float32 row sums, bf16 A fragments (n-tiles 2kb, 2kb+1 form k-block kb)
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = expf(s[j][0] - mn_lo), p1 = expf(s[j][1] - mn_lo);
      const float p2 = expf(s[j][2] - mn_hi), p3 = expf(s[j][3] - mn_hi);
      l_lo += p0 + p1;
      l_hi += p2 + p3;
      pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    // O += P·V: 16 rows x 64 d, as 8 n-tiles over the 4 k-blocks of keys
#pragma unroll
    for (int jd = 0; jd < 8; ++jd) {
#pragma unroll
      for (int kb2 = 0; kb2 < 4; ++kb2)
        mma_bf16(o[jd], pa[kb2], load_pair(&vt[8 * jd + g][16 * kb2 + 2 * t]),
                 load_pair(&vt[8 * jd + g][16 * kb2 + 8 + 2 * t]));
    }
  }

  const float inv_lo = 1.f / quad_sum(l_lo), inv_hi = 1.f / quad_sum(l_hi);
  __nv_bfloat16* ob = out + (long long)b * nq * heads * D + h * D;
#pragma unroll
  for (int jd = 0; jd < 8; ++jd) {
    const int c = 8 * jd + 2 * t;
    if (r_lo < nq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r_lo * heads * D + c) =
          __floats2bfloat162_rn(o[jd][0] * inv_lo, o[jd][1] * inv_lo);
    if (r_hi < nq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r_hi * heads * D + c) =
          __floats2bfloat162_rn(o[jd][2] * inv_hi, o[jd][3] * inv_hi);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int batch, int nq,
                   int nk, int heads, long long q_bs, long long q_ts, long long k_bs,
                   long long k_ts, long long v_bs, long long v_ts, float scale,
                   cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> && D == 64) {
    const dim3 grid((nq + kMmaWarps * 16 - 1) / (kMmaWarps * 16), batch * heads);
    oneshot_attention_mma_kernel<<<grid, kMmaWarps * 32, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), nq, nk, heads,
        q_bs, q_ts, k_bs, k_ts, v_bs, v_ts, scale);
  } else {
    const dim3 grid((nq + kRows - 1) / kRows, batch * heads);
    oneshot_attention_kernel<T, D><<<grid, kRows, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), nq, nk, heads, q_bs, q_ts, k_bs, k_ts, v_bs, v_ts, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int head_dim, const void* q, const void* k, const void* v, void* out,
                     int batch, int nq, int nk, int heads, long long q_bs, long long q_ts,
                     long long k_bs, long long k_ts, long long v_bs, long long v_ts,
                     float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 8:
      return launch<T, 8>(q, k, v, out, batch, nq, nk, heads, q_bs, q_ts, k_bs, k_ts, v_bs,
                          v_ts, scale, stream);
    case 16:
      return launch<T, 16>(q, k, v, out, batch, nq, nk, heads, q_bs, q_ts, k_bs, k_ts, v_bs,
                           v_ts, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, batch, nq, nk, heads, q_bs, q_ts, k_bs, k_ts, v_bs,
                           v_ts, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: (B, N, H, D) with the head and channel dims packed (strides D, 1);
// *_bs / *_ts are the batch and token strides in elements. For bf16 with
// D = 64 the pointers must be 16-byte aligned and every stride a multiple of 8
// (the tensor-core path reads 16-byte vectors; the Python wrapper checks it).
// out: contiguous (B, Nq, H, D). Returns the cudaError_t of the launch.
extern "C" int gfnet_oneshot_attention(const void* q, const void* k, const void* v, void* out,
                                       int batch, int nq, int nk, int heads, int head_dim,
                                       long long q_bs, long long q_ts, long long k_bs,
                                       long long k_ts, long long v_bs, long long v_ts,
                                       float scale, int is_bf16, void* stream) {
  if (batch <= 0 || nq <= 0 || nk <= 0 || heads <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(head_dim, q, k, v, out, batch, nq, nk, heads, q_bs, q_ts,
                                   k_bs, k_ts, v_bs, v_ts, scale, s);
  return dispatch<float>(head_dim, q, k, v, out, batch, nq, nk, heads, q_bs, q_ts, k_bs, k_ts,
                         v_bs, v_ts, scale, s);
}
