// K4: the sampler's Gaussian kernel density estimate in one pass.
//
// density[b, i] = Σ_j exp(inv · max(sq_i + sq_j − 2·x_i·x_j, 0)) over the
// points x (B, N, 4) float32 of each member and their squared norms sq
// (B, N), inv = −1/(2 std²). The sampler scores its 4 × 5000 candidates a
// pair with it (`ops/kde.py`, caller `matcher/api.py: _sample_core`).
//
// Replaces no TPU kernel: the JAX package leaves its KDE
// (gfnet_tpu/ops/kde.py) to XLA, which fuses the distance, `exp` and row
// sum of each block of rows. The plain PyTorch path cannot: it writes every
// (B, rows, N) block of scores to device memory and reads it back in eight
// separate launches, ~179 GB a call at B = 8, N = 20,000.
//
// What bounds it on the H100: nothing but arithmetic. A call reads
// B·N·20 bytes (400 KB a member, resident in L2) and writes B·N·4, and does
// B·N² scores of ~18 instructions each (a 4-term dot, the distance, the
// clamp, the scale, `expf` with its one MUFU.EX2, the add): 3.2e9 scores at
// B = 8 take ~0.77 ms on the exponential unit and ~1.7 ms of instruction dispatch.
//
// Design: the row sum in PyTorch's own order, so that a density is the
// plain path's bit for bit and the Gumbel top-k downstream ranks candidates
// exactly as the plain path does (a last-bit change reorders near-tied
// keys, and RANSAC draws its points in that order). The plain path sums a
// row with `sum(-1)`. For float32 rows of N terms, N a multiple of 4 from
// 8,164 to 130,560, and at least 16 rows (the sampler's N is 4 × its
// matches), ATen's CUDA reduction (Reduce.cuh) gives a row one block of
// 512 threads, 32 lanes × 16 warps: thread t keeps four accumulators, adding
// term 4j + c to accumulator c for its vectors j = t, t + 512, t + 1024, ...;
// then ((a0 + a1) + a2) + a3; then a warp's lanes by shuffles down, offsets
// 16 to 1; then the 16 warps by halving in shared memory, offsets 8 to 1.
// K4 runs that schedule with the terms computed in place: a block of 512
// threads is those threads for kRows rows of one member at once (the rows
// broadcast from shared memory, 4 · kRows accumulators a thread), each
// thread reading its own vectors of columns (64 bytes of points and 16 of
// squared norms) from L2, where a member's 400 KB stay. No score leaves
// the registers. Elsewhere (another N, or a version of ATen that reduces
// otherwise) the density differs from the plain path's only in the order
// of its sum; the N mod 4 last terms go to accumulator 0 of threads 0-2.
// On the H100 at (8, 20000, 4): 2.29 ms, against 3.57 with the loads split
// into 4-byte ones and 7.1 with 4 rows a block (the columns read twice as
// often).
//
// Arithmetic: the plain path's, in float32, term by term. sq comes from the
// wrapper by the plain path's own ops; the dot is an FMA chain over the 4
// coordinates in order, as the float32 GEMM accumulates it; (sq_i + sq_j) −
// 2·dot is one rounding (2·dot is exact, so one FMA rounds as the plain
// subtraction does); the clamp keeps NaN as `clamp_min` does; `expf` is the
// full-precision one PyTorch's `exp` calls (no fast math). No atomics: a run
// repeats bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;  // the reduction's threads a row: 32 lanes × 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;       // rows a block

// exp(inv · max((sa + sb) − 2·a·b, 0)), rounded as the plain path rounds it
__device__ __forceinline__ float kde_term(float4 a, float sa, float4 b, float sb, float inv) {
  float dot = __fmul_rn(a.x, b.x);
  dot = __fmaf_rn(a.y, b.y, dot);
  dot = __fmaf_rn(a.z, b.z, dot);
  dot = __fmaf_rn(a.w, b.w, dot);
  float d2 = __fmaf_rn(-2.0f, dot, __fadd_rn(sa, sb));
  asm("max.NaN.f32 %0, %0, %1;" : "+f"(d2) : "f"(0.0f));
  return expf(__fmul_rn(d2, inv));
}

// one 16-byte load: a point's 4 coordinates, or 4 squared norms
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// blockIdx.x: member · row tiles + row tile
__global__ void __launch_bounds__(kThreads, 1) kde_kernel(const float* __restrict__ x,
                                                          const float* __restrict__ sq,
                                                          float* __restrict__ out, int n, float inv) {
  __shared__ float4 row_x[kRows];
  __shared__ float row_sq[kRows];
  __shared__ float warp_sum[kWarps][kRows];
  const int tiles = (n + kRows - 1) / kRows;
  const int member = blockIdx.x / tiles;
  const int row0 = (blockIdx.x % tiles) * kRows;
  const float* xm = x + static_cast<size_t>(member) * n * 4;
  const float* sqm = sq + static_cast<size_t>(member) * n;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t < kRows) {
    const int i = min(row0 + t, n - 1);  // a row past N computes and is not stored
    row_x[t] = load4(xm + 4 * i);
    row_sq[t] = sqm[i];
  }
  __syncthreads();

  float acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  const int vecs = n / 4;
  for (int j = t; j < vecs; j += kThreads) {
    float4 cx[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) cx[c] = load4(xm + 4 * (4 * j + c));
    // a member's squared norms are 16-byte aligned where N is a multiple of 4
    const float4 s4 = n % 4 == 0 ? load4(sqm + 4 * j)
                                 : make_float4(sqm[4 * j], sqm[4 * j + 1], sqm[4 * j + 2], sqm[4 * j + 3]);
    const float cs[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 a = row_x[r];
      const float sa = row_sq[r];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = __fadd_rn(acc[r][c], kde_term(a, sa, cx[c], cs[c], inv));
    }
  }
  if (t < n - 4 * vecs) {  // the tail: warp 0's lanes, into accumulator 0
    const int jt = 4 * vecs + t;
    const float4 b = load4(xm + 4 * jt);
    const float sb = sqm[jt];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r][0] = __fadd_rn(acc[r][0], kde_term(row_x[r], row_sq[r], b, sb, inv));
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float v = __fadd_rn(__fadd_rn(__fadd_rn(acc[r][0], acc[r][1]), acc[r][2]), acc[r][3]);
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, offset));
    if (lane == 0) warp_sum[warp][r] = v;
  }
  for (int offset = kWarps / 2; offset > 0; offset >>= 1) {
    __syncthreads();
    if (t < offset * kRows) {
      const int w = t / kRows, r = t % kRows;
      warp_sum[w][r] = __fadd_rn(warp_sum[w][r], warp_sum[w + offset][r]);
    }
  }
  __syncthreads();
  if (t < kRows && row0 + t < n) out[static_cast<size_t>(member) * n + row0 + t] = warp_sum[0][t];
}

}  // namespace

// x (batch, n, 4) and sq (batch, n) contiguous float32, each 16-byte aligned; out (batch, n)
extern "C" int gfnet_kde(int device, const void* x, const void* sq, void* out, int batch, int n, float inv,
                         void* stream) {
  const cudaError_t set = cudaSetDevice(device);  // see gfnet_local_corr_bwd
  if (set != cudaSuccess) return set;
  const long long blocks = static_cast<long long>(batch) * ((n + kRows - 1) / kRows);
  if (batch < 1 || n < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kde_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(sq), static_cast<float*>(out), n, inv);
  return cudaGetLastError();
}
