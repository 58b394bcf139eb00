// Streaming softmax attention for the ViT backbone and the cross-view decoder.
//
// Replaces the TPU kernel `oneshot_attention` (gfnet_tpu/ops/pallas/
// oneshot_attention.py, fold layout, body `_kernel`): non-causal
// softmax(q·kᵀ·scale)·v over (B, N, H, D) tensors.
//
// What bounds it on the H100: at the main path's shapes (N = 1025 / 1601,
// H = 16, D = 64; cross-view N = 1024 / 1600, H = 8, D = 8) the work is
// 4·N²·D·H·B flops and B·H·N² exponentials against N·H·D·B·8 bytes of
// q/k/v/out: hundreds of operations per byte. At D = 64 the card needs about
// as long for the exponentials on its special-function units (16 a clock an
// SM) as for the matrix products on its tensor cores; at D = 8 the
// exponentials alone set the pace. So the design keeps the tensor cores for
// the products, one `ex2` an element for the softmax, and enough warps in
// flight that one warp's exponentials overlap another's products. The TPU
// design kept a whole kv row in VMEM; at N = 1601, D = 64 in bf16, K+V is
// ~410 KB, more than the 227 KB of shared memory one block may use, so kv
// streams through shared memory with an online softmax (running max and sum,
// the accumulator rescaled only when a max moved).
//
// Three kernels, chosen by type and head dim (8, 16, 32, 64 or 128; the
// wrapper zero-pads any other head dim up to 128 to the next of these):
//  - bf16 with D = 64 (every ViT attention): `oneshot_attention_wgmma_kernel`.
//    Two warpgroups own 64 q rows each and share a ring of four 64-key K/V
//    stages in shared memory. One thread fills the ring by TMA from a
//    (D, H, N, B) tensor map over k and v as they lie (any batch and token
//    stride), 128-byte swizzled, rows past N zero-filled; an `mbarrier` a stage
//    says when its bytes have landed, a second when all eight warps have left
//    it, so the warpgroups never meet at a block-wide barrier and two tiles
//    are in flight while one is multiplied. S = Q·Kᵀ is `wgmma.m64n64k16`
//    with Q held in registers and K read K-major from shared memory; the S
//    accumulator, re-packed to bf16, is the register A operand of P·V, whose
//    B operand is the V tile as stored (MN-major, the descriptor's transpose
//    bit): nothing is transposed by hand and probabilities never touch
//    memory. Each step starts S(j+1) and O += P(j)·V(j) as one batch, so the
//    tensor cores get eight products at a time and one wait a tile. Two
//    blocks an SM: one block's softmax overlaps the other's products.
//  - bf16 with D = 8, 16, 32 or 128 (the cross-view decoder at D = 8; the
//    others where a config's widths give them): `oneshot_attention_mma_kernel`.
//    Eight warps own 16 q rows each; K and V of the (batch, head) lie in
//    shared memory in chunks of 64 KB (the whole kv at N = 1600, D = 8: 51
//    KB; 512 keys at D = 32, 128 at D = 128), brought by 16-byte `cp.async`
//    and XOR-swizzled by 16-byte piece so that the eight rows one `ldmatrix`
//    reads lie in eight bank groups. S is `mma.sync.m16n8k8` at D = 8 and
//    D/16 steps of `m16n8k16` above, with K fragments from `ldmatrix`; P·V is
//    `m16n8k16` over 16 keys into D/8 accumulator n-tiles, with V fragments
//    from `ldmatrix.trans`. At D = 128 a thread holds 64 float32 accumulators
//    and eight k-steps of Q fragments. `wgmma` is not worth its 64-row tile
//    at k = 8.
//  - float32 at any of those D: `oneshot_attention_f32_kernel`, one thread
//    per q row (two at D = 128, each with half the row, so that q and the
//    accumulator stay in registers), scalar FMAs on float32 tiles. It keeps
//    full precision for the float32 comparisons against the CPU and is off
//    the bf16 main path.
// All read q/k/v in place with their batch and token strides, so the
// (B,N,H,D)→(B·H,N,D) relayout of the TPU version, and the split of a fused
// qkv projection, cost no copy. The bf16 kernels read 16-byte vectors: the
// caller guarantees 16-byte aligned pointers and strides that are multiples
// of 8 elements, and a positive scale (the max is taken before scaling).
//
// Numerics follow the TPU kernel: logits and softmax in float32; the
// probabilities are rounded to the storage type before the PV product, which
// accumulates in float32; the row sum comes from the unrounded probabilities
// and divides after PV; the ragged kv tail is masked by index, with no pad.
// The bf16 kernels take exponentials as `ex2` of logits scaled by
// scale·log2(e), folded into one multiply-add.

#include <cuda.h>  // CUtensorMap and its enums; nothing of libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------------- float32
constexpr int kRows = 64;   // q rows per block
constexpr int kChunk = 16;  // keys per online-softmax update

// Above D = 64 a q row is split over kSplit neighbouring threads, each with
// kPart channels of q and of the accumulator (at most 64 a thread, which
// keeps them in registers), and a tile holds fewer kv rows, so that K and V
// fit the 48 KB of static shared memory.
template <int D>
struct F32Shape {
  static constexpr int kSplit = D > 64 ? D / 64 : 1;
  static constexpr int kPart = D / kSplit;
  static constexpr int kTile = D > 64 ? 32 : 64;  // kv rows per shared-memory tile
  static constexpr int kThreads = kRows * kSplit;
};

template <int D>
__global__ void __launch_bounds__(F32Shape<D>::kThreads)
oneshot_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ out, int nq, int nk,
                             int heads, long long q_bs, long long q_ts, long long k_bs,
                             long long k_ts, long long v_bs, long long v_ts, float scale) {
  using S = F32Shape<D>;
  constexpr int kPart = S::kPart, kTile = S::kTile;
  static_assert(D % 4 == 0, "head dim must be a multiple of 4");
  __shared__ __align__(16) float ks[kTile][D];
  __shared__ __align__(16) float vs[kTile][D];

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int row = blockIdx.x * kRows + threadIdx.x / S::kSplit;
  const int c_lo = (threadIdx.x % S::kSplit) * kPart;  // this thread's channels

  // Threads past the last row still stage tiles and take part in the
  // shuffles, so they load a valid row.
  const float* qp = q + b * q_bs + (long long)min(row, nq - 1) * q_ts + h * D + c_lo;
  float qr[kPart], acc[kPart];
#pragma unroll
  for (int d = 0; d < kPart; ++d) {
    qr[d] = qp[d];
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const float* kb = k + b * k_bs + h * D;
  const float* vb = v + b * v_bs + h * D;
  for (int t0 = 0; t0 < nk; t0 += kTile) {
    const int cnt = min(kTile, nk - t0);
    __syncthreads();  // the previous tile is fully consumed
    for (int i = threadIdx.x; i < cnt * D; i += S::kThreads) {
      const int j = i / D, d = i % D;
      ks[j][d] = kb[(long long)(t0 + j) * k_ts + d];
      vs[j][d] = vb[(long long)(t0 + j) * v_ts + d];
    }
    __syncthreads();

    for (int c0 = 0; c0 < cnt; c0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        s[j] = -INFINITY;  // masked: keys past the tile's end
        if (c0 + j < cnt) {  // the same for every thread of the block
          const float4* kr = reinterpret_cast<const float4*>(ks[c0 + j] + c_lo);
          float dot = 0.f;
#pragma unroll
          for (int d4 = 0; d4 < kPart / 4; ++d4) {
            const float4 k4 = kr[d4];
            dot = fmaf(qr[4 * d4 + 0], k4.x, dot);
            dot = fmaf(qr[4 * d4 + 1], k4.y, dot);
            dot = fmaf(qr[4 * d4 + 2], k4.z, dot);
            dot = fmaf(qr[4 * d4 + 3], k4.w, dot);
          }
          // the row's parts, summed alike on each of its threads
#pragma unroll
          for (int o = 1; o < S::kSplit; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
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
      for (int d = 0; d < kPart; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (c0 + j < cnt) {
          const float p = expf(s[j] - m_new);
          l += p;
          const float4* vr = reinterpret_cast<const float4*>(vs[c0 + j] + c_lo);
#pragma unroll
          for (int d4 = 0; d4 < kPart / 4; ++d4) {
            const float4 v4 = vr[d4];
            acc[4 * d4 + 0] = fmaf(p, v4.x, acc[4 * d4 + 0]);
            acc[4 * d4 + 1] = fmaf(p, v4.y, acc[4 * d4 + 1]);
            acc[4 * d4 + 2] = fmaf(p, v4.z, acc[4 * d4 + 2]);
            acc[4 * d4 + 3] = fmaf(p, v4.w, acc[4 * d4 + 3]);
          }
        }
      }
      m = m_new;
    }
  }

  if (row < nq) {
    const float inv = 1.f / l;
    float* op = out + (((long long)b * nq + row) * heads + h) * D + c_lo;
#pragma unroll
    for (int d = 0; d < kPart; ++d) op[d] = acc[d] * inv;
  }
}

// ------------------------------------------------- shared by the bf16 kernels
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStep = 64;  // keys per online-softmax update: 8 accumulator n-tiles

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared; `valid` false writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One online-softmax update over 64 keys. `s` holds raw logits q·k in the
// accumulator layout that `mma.sync.m16n8` and `wgmma.m64nN` share (g = lane
// / 4, t = lane % 4): s[4j + e] is row g (e < 2) or g + 8 (e >= 2), key
// 8j + 2t + (e & 1) of the step. `o` has the same layout over the head dim.
// Leaves the probabilities as bf16 A fragments of the four 16-key k-blocks
// in `pa` (n-tiles 2kb, 2kb+1 form k-block kb), adds their unrounded sums to
// l, and rescales o and l when a running max moved. c = scale·log2(e) > 0.
// The first step always holds key 0, so the running max is finite after it
// and exp2(-inf) = 0 wipes nothing but zeros.
template <int NO>
__device__ __forceinline__ void softmax_step(float (&s)[32], float (&o)[NO], uint32_t (&pa)[4][4],
                                             float& m_lo, float& m_hi, float& l_lo, float& l_hi,
                                             float c, int first_key, int nk, int t) {
  if (first_key + kStep > nk) {  // the ragged tail: mask by index
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (first_key + 8 * (i / 4) + 2 * t + (i & 1) >= nk) s[i] = -INFINITY;
  }
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j + 0], s[4 * j + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  const float mn_lo = fmaxf(m_lo, quad_max(mx_lo)), mn_hi = fmaxf(m_hi, quad_max(mx_hi));
  if (__any_sync(0xffffffffu, (mn_lo != m_lo) || (mn_hi != m_hi))) {
    const float a_lo = fast_exp2((m_lo - mn_lo) * c), a_hi = fast_exp2((m_hi - mn_hi) * c);
    l_lo *= a_lo;
    l_hi *= a_hi;
#pragma unroll
    for (int i = 0; i < NO; i += 4) {
      o[i + 0] *= a_lo;
      o[i + 1] *= a_lo;
      o[i + 2] *= a_hi;
      o[i + 3] *= a_hi;
    }
    m_lo = mn_lo;
    m_hi = mn_hi;
  }
  const float nb_lo = -mn_lo * c, nb_hi = -mn_hi * c;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float p0 = fast_exp2(fmaf(s[4 * j + 0], c, nb_lo));
    const float p1 = fast_exp2(fmaf(s[4 * j + 1], c, nb_lo));
    const float p2 = fast_exp2(fmaf(s[4 * j + 2], c, nb_hi));
    const float p3 = fast_exp2(fmaf(s[4 * j + 3], c, nb_hi));
    l_lo += p0 + p1;
    l_hi += p2 + p3;
    pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(p0, p1);
    pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
  }
}

// o / l to the contiguous (B, Nq, H, D) output, rows r_lo and r_lo + 8
template <int NO>
__device__ __forceinline__ void store_rows(const float (&o)[NO], float l_lo, float l_hi,
                                           bf16* __restrict__ out, int b, int h, int heads, int nq,
                                           int r_lo, int t) {
  constexpr int D = NO * 2;
  const float inv_lo = 1.f / quad_sum(l_lo), inv_hi = 1.f / quad_sum(l_hi);
  bf16* ob = out + ((long long)b * nq * heads + h) * D;
#pragma unroll
  for (int jd = 0; jd < NO / 4; ++jd) {
    const int col = 8 * jd + 2 * t;
    if (r_lo < nq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r_lo * heads * D + col) =
          __floats2bfloat162_rn(o[4 * jd + 0] * inv_lo, o[4 * jd + 1] * inv_lo);
    if (r_lo + 8 < nq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)(r_lo + 8) * heads * D + col) =
          __floats2bfloat162_rn(o[4 * jd + 2] * inv_hi, o[4 * jd + 3] * inv_hi);
  }
}

// ------------------------------------------------------------- bf16, D = 64
constexpr int kWarpgroups = 2;                   // 64 q rows each
constexpr int kWgThreads = 128 * kWarpgroups;
constexpr int kTileBytes = kStep * 128;          // one K or V tile: 64 rows of 64 bf16
constexpr int kStageBytes = 2 * kTileBytes;      // K then V

// Shared-memory matrix descriptor of a tile of 128-byte rows in the 128-byte
// swizzle: start address, leading and stride offsets of 1024 B (eight rows),
// in units of 16 bytes. K is read K-major (d contiguous per key), V MN-major
// (the same rows, with the instruction's transpose bit).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)64 << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it
__device__ __forceinline__ void fence_regs(float (&x)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

// d (64 x 64 float32, spread over the warpgroup) = a·b (+ d if scale_d):
// a 64 x 16 bf16 from registers, b 16 x 64 bf16 from shared memory
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(kTransB));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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

// one 64-key x 64-channel box of the (D, H, N, B) tensor map into shared memory
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int head, int key, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(head), "r"(key), "r"(batch)
      : "memory");
}

constexpr int kTmaStages = 4;  // ring of K/V tiles; 3 to 6 time alike on the H100
constexpr int kTmaSmemBytes = kTmaStages * kStageBytes + 1024 + 128;  // ring, alignment, barriers

__global__ void __launch_bounds__(kWgThreads, 2)
oneshot_attention_wgmma_kernel(const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v,
                               const bf16* __restrict__ q, bf16* __restrict__ out, int nq, int nk,
                               int heads, long long q_bs, long long q_ts, float c) {
  constexpr int D = 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's period
  const uint32_t full = ring + kTmaStages * kStageBytes, empty = full + 8 * kTmaStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int r_lo = blockIdx.x * kWarpgroups * 64 + warp * 16 + g;
  const int r_hi = r_lo + 8;
  const int tiles = (nk + kStep - 1) / kStep;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kTmaStages; ++st) {
      mbar_init(full + 8 * st, 1);                  // the loading thread, with the tile's bytes
      mbar_init(empty + 8 * st, kWgThreads / 32);   // one lane of every warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kTmaStages; ++st)
      if (st < tiles) {
        mbar_expect_tx(full + 8 * st, kStageBytes);
        tma_load_tile(ring + st * kStageBytes, &map_k, full + 8 * st, h, st * kStep, b);
        tma_load_tile(ring + st * kStageBytes + kTileBytes, &map_v, full + 8 * st, h, st * kStep, b);
      }
  }
  __syncwarp();

  // Q as A fragments over the four 16-wide k-blocks of D; rows past nq are 0
  const bf16* qb = q + b * q_bs + h * D;
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int col = 16 * kk + 2 * t;
    qa[kk][0] = r_lo < nq ? load_pair(qb + r_lo * q_ts + col) : 0u;
    qa[kk][1] = r_hi < nq ? load_pair(qb + r_hi * q_ts + col) : 0u;
    qa[kk][2] = r_lo < nq ? load_pair(qb + r_lo * q_ts + col + 8) : 0u;
    qa[kk][3] = r_hi < nq ? load_pair(qb + r_hi * q_ts + col + 8) : 0u;
  }
  float o[32], s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  uint32_t pa[4][4];

  // S(0) and its softmax, then per step the products of two tiles in one
  // batch: S(j+1) = Q·K(j+1)ᵀ and O += P(j)·V(j)
  mbar_wait(full, 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16<0>(s, qa[kk], smem_desc(ring + 32 * kk), kk > 0);
  wgmma_commit();
  wgmma_wait();
  fence_regs(s);
  softmax_step(s, o, pa, m_lo, m_hi, l_lo, l_hi, c, 0, nk, t);

  for (int j = 0; j < tiles; ++j) {
    const bool more = j + 1 < tiles;
    const uint32_t vs = ring + (j % kTmaStages) * kStageBytes + kTileBytes;
    const uint32_t ks = ring + ((j + 1) % kTmaStages) * kStageBytes;
    if (more) mbar_wait(full + 8 * ((j + 1) % kTmaStages), ((j + 1) / kTmaStages) & 1);
    fence_regs(o);
    wgmma_fence();
    if (more) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // 16 channels = 32 bytes along a K row
        wgmma_m64n64k16<0>(s, qa[kk], smem_desc(ks + 32 * kk), kk > 0);
    }
#pragma unroll
    for (int kb2 = 0; kb2 < 4; ++kb2)  // 16 keys = 16 rows of V
      wgmma_m64n64k16<1>(o, pa[kb2], smem_desc(vs + 16 * 128 * kb2), 1);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(o);
    // this warp is done with tile j; the stage that tile j - 1 left, which the
    // other warpgroup has left by now too, takes tile j - 1 + kTmaStages
    if (lane == 0) mbar_arrive(empty + 8 * (j % kTmaStages));
    if (threadIdx.x == 0 && j >= 1 && j - 1 + kTmaStages < tiles) {
      const int nt = j - 1 + kTmaStages, st = nt % kTmaStages;
      mbar_wait(empty + 8 * st, ((nt / kTmaStages) & 1) ^ 1);
      mbar_expect_tx(full + 8 * st, kStageBytes);
      tma_load_tile(ring + st * kStageBytes, &map_k, full + 8 * st, h, nt * kStep, b);
      tma_load_tile(ring + st * kStageBytes + kTileBytes, &map_v, full + 8 * st, h, nt * kStep, b);
    }
    __syncwarp();
    if (more) softmax_step(s, o, pa, m_lo, m_hi, l_lo, l_hi, c, (j + 1) * kStep, nk, t);
  }
  store_rows(o, l_lo, l_hi, out, b, h, heads, nq, r_lo, t);
}

// ------------------------------------------------- bf16, D = 8, 16, 32, 128
constexpr int kMmaWarps = 8;                 // 16 q rows each
constexpr int kMmaSmemBytes = 64 * 1024;     // K and V chunk together

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a·b for one 16x8x16 tile: a 16x16 bf16 (row), b 16x8 bf16 (col), c float32
__device__ __forceinline__ void mma_k16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the same for a 16x8x8 tile: a 16x8, b 8x8
__device__ __forceinline__ void mma_k8(float* c, const uint32_t* a, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// The shared-memory address of 16-byte piece `pc` of K/V row `row`, rows of
// P pieces, XOR-swizzled within each 128 bytes: the eight rows one
// `ldmatrix` 8x8 tile reads (eight consecutive keys at one piece) then lie in
// eight different 16-byte bank groups, where unswizzled rows of 32, 64 or 256
// bytes would put two, four or eight of them in one.
template <int P>
__device__ __forceinline__ uint32_t kv_piece(uint32_t base, int row, int pc) {
  int sw = pc;
  if constexpr (P >= 8) sw = pc ^ (row & 7);
  else if constexpr (P > 1) sw = pc ^ ((row / (8 / P)) & (P - 1));
  return base + static_cast<uint32_t>(row * P + sw) * 16u;
}

// Fragment layouts (g = lane / 4, t = lane % 4): A regs hold (row g | g+8,
// cols 2t,2t+1 | 8+2t,9+2t); B regs (k = 2t,2t+1 | 8+2t,9+2t, n = g); C as in
// `softmax_step`. A K or V row of D bf16 is D/8 pieces of 16 bytes, and one
// `ldmatrix` 8x8 tile is eight such pieces: plain, a lane gets (key g, d
// 2t,2t+1), the B fragment of Q·Kᵀ; transposed, (keys 2t,2t+1, d g), the B
// fragment of P·V. `chunk` keys (a multiple of 64) lie in shared memory at a
// time, K rows then V rows, each swizzled by `kv_piece`.
template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32)
oneshot_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, bf16* __restrict__ out, int nq, int nk,
                             int heads, long long q_bs, long long q_ts, long long k_bs,
                             long long k_ts, long long v_bs, long long v_ts, float c, int chunk) {
  static_assert(D == 8 || D == 16 || D == 32 || D == 128, "head dim 8, 16, 32 or 128");
  constexpr int kPieces = D / 8, kRowBytes = 2 * D;
  constexpr int kSteps = D == 8 ? 1 : D / 16;  // k-steps of Q·Kᵀ (m16n8k8 at D = 8, else k16)
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t ks = smem_u32(smem_raw), vs = ks + chunk * kRowBytes;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int r_lo = blockIdx.x * kMmaWarps * 16 + warp * 16 + g;
  const int r_hi = r_lo + 8;

  // Q as A fragments, four registers a k16 step (two at D = 8); rows past nq are 0
  const bf16* qb = q + b * q_bs + h * D;
  uint32_t qa[D == 8 ? 2 : 4 * kSteps];
  if constexpr (D == 8) {
    qa[0] = r_lo < nq ? load_pair(qb + r_lo * q_ts + 2 * t) : 0u;
    qa[1] = r_hi < nq ? load_pair(qb + r_hi * q_ts + 2 * t) : 0u;
  } else {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int col = 16 * kk + 2 * t;
      qa[4 * kk + 0] = r_lo < nq ? load_pair(qb + r_lo * q_ts + col) : 0u;
      qa[4 * kk + 1] = r_hi < nq ? load_pair(qb + r_hi * q_ts + col) : 0u;
      qa[4 * kk + 2] = r_lo < nq ? load_pair(qb + r_lo * q_ts + col + 8) : 0u;
      qa[4 * kk + 3] = r_hi < nq ? load_pair(qb + r_hi * q_ts + col + 8) : 0u;
    }
  }
  float o[4 * kPieces];
#pragma unroll
  for (int i = 0; i < 4 * kPieces; ++i) o[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  const bf16* kb = k + b * k_bs + h * D;
  const bf16* vb = v + b * v_bs + h * D;
  for (int c0 = 0; c0 < nk; c0 += chunk) {
    const int cnt = min(chunk, nk - c0);
    const int rows = (cnt + kStep - 1) / kStep * kStep;  // zero rows fill the last step
    __syncthreads();  // the previous chunk is fully consumed
    for (int i = threadIdx.x; i < rows * kPieces; i += kMmaWarps * 32) {
      const int row = i / kPieces, pc = i % kPieces;
      const bool valid = row < cnt;
      const long long tok = valid ? c0 + row : 0;
      cp_async16(kv_piece<kPieces>(ks, row, pc), kb + tok * k_ts + pc * 8, valid);
      cp_async16(kv_piece<kPieces>(vs, row, pc), vb + tok * v_ts + pc * 8, valid);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    for (int s0 = 0; s0 < cnt; s0 += kStep) {
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      uint32_t f[4];
      if constexpr (D == 8) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // 32 keys: one tile per n-tile
          ldmatrix_x4(f, kv_piece<1>(ks, s0 + 32 * half + lane, 0));
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_k8(&s[4 * (4 * half + j)], qa, f[j]);
        }
      } else {
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {  // 16 keys: tiles (keys 0-7 | 8-15) x (d 0-7 | 8-15) of a k-step
          const int key = s0 + 16 * jp + (lane / 16) * 8 + lane % 8;
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk) {
            ldmatrix_x4(f, kv_piece<kPieces>(ks, key, 2 * kk + (lane / 8) % 2));
            mma_k16(&s[4 * (2 * jp)], &qa[4 * kk], f[0], f[1]);
            mma_k16(&s[4 * (2 * jp + 1)], &qa[4 * kk], f[2], f[3]);
          }
        }
      }

      uint32_t pa[4][4];
      softmax_step(s, o, pa, m_lo, m_hi, l_lo, l_hi, c, c0 + s0, nk, t);

      if constexpr (D == 8) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // 32 keys: two k-blocks of two tiles
          ldmatrix_x4_trans(f, kv_piece<1>(vs, s0 + 32 * half + lane, 0));
          mma_k16(o, pa[2 * half], f[0], f[1]);
          mma_k16(o, pa[2 * half + 1], f[2], f[3]);
        }
      } else {
#pragma unroll
        for (int kb2 = 0; kb2 < 4; ++kb2) {  // 16 keys: tiles (d 0-7 | 8-15) x (keys 0-7 | 8-15) of 16 channels
          const int key = s0 + 16 * kb2 + ((lane / 8) % 2) * 8 + lane % 8;
#pragma unroll
          for (int dp = 0; dp < kPieces / 2; ++dp) {
            ldmatrix_x4_trans(f, kv_piece<kPieces>(vs, key, 2 * dp + lane / 16));
            mma_k16(&o[8 * dp], pa[kb2], f[0], f[1]);
            mma_k16(&o[8 * dp + 4], pa[kb2], f[2], f[3]);
          }
        }
      }
    }
  }
  store_rows(o, l_lo, l_hi, out, b, h, heads, nq, r_lo, t);
}

// ------------------------------------------------------------------ launchers
// Lets `kernel` use `bytes` of dynamic shared memory (above 48 KB it has to be
// asked for), once for each device of the process: the call costs the host
// a few µs, and the attention launches are many and short. `kHeadDim` keeps
// one record for each kernel (two of them have the same type).
template <int kHeadDim, typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kernel, int bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

struct Args {
  const void *q, *k, *v;
  void* out;
  int batch, nq, nk, heads;
  long long q_bs, q_ts, k_bs, k_ts, v_bs, v_ts;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_f32(const Args& a) {
  const dim3 grid((a.nq + kRows - 1) / kRows, a.batch * a.heads);
  oneshot_attention_f32_kernel<D><<<grid, F32Shape<D>::kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.nq, a.nk, a.heads, a.q_bs,
      a.q_ts, a.k_bs, a.k_ts, a.v_bs, a.v_ts, a.scale);
  return cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, fetched through the runtime: the library is not
// linked to libcuda.
EncodeTiled encode_tiled() {
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

// A (D, H, N, B) map over a (B, N, H, D = 64) bf16 tensor with free batch and
// token strides; one box is 64 tokens of one head, 128-byte swizzled, rows
// past N zero-filled.
bool kv_tensor_map(CUtensorMap* map, const void* base, int batch, int n, int heads,
                   long long bs, long long ts) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {64, (cuuint64_t)heads, (cuuint64_t)n, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {128, (cuuint64_t)ts * 2, (cuuint64_t)bs * 2};  // bytes
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kStep, 1}, elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

cudaError_t launch_wgmma(const Args& a) {
  CUtensorMap map_k, map_v;
  if (!kv_tensor_map(&map_k, a.k, a.batch, a.nk, a.heads, a.k_bs, a.k_ts) ||
      !kv_tensor_map(&map_v, a.v, a.batch, a.nk, a.heads, a.v_bs, a.v_ts))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_dynamic_smem<64>(oneshot_attention_wgmma_kernel, kTmaSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nq + kWarpgroups * 64 - 1) / (kWarpgroups * 64), a.batch * a.heads);
  oneshot_attention_wgmma_kernel<<<grid, kWgThreads, kTmaSmemBytes, a.stream>>>(
      map_k, map_v, static_cast<const bf16*>(a.q), static_cast<bf16*>(a.out), a.nq, a.nk, a.heads,
      a.q_bs, a.q_ts, a.scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const Args& a) {
  cudaError_t err = allow_dynamic_smem<D>(oneshot_attention_mma_kernel<D>, kMmaSmemBytes);
  if (err != cudaSuccess) return err;
  // K and V of the whole (batch, head) if they fit, else chunks that fill the
  // budget (a multiple of 64 keys at every D)
  const int cap = kMmaSmemBytes / (4 * D), whole = (a.nk + kStep - 1) / kStep * kStep;
  const int chunk = whole < cap ? whole : cap;
  const dim3 grid((a.nq + kMmaWarps * 16 - 1) / (kMmaWarps * 16), a.batch * a.heads);
  oneshot_attention_mma_kernel<D><<<grid, kMmaWarps * 32, chunk * 4 * D, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<bf16*>(a.out), a.nq, a.nk, a.heads, a.q_bs, a.q_ts, a.k_bs, a.k_ts, a.v_bs,
      a.v_ts, a.scale * kLog2e, chunk);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, N, H, D), D in {8, 16, 32, 64, 128}, with the head and channel
// dims packed (strides D, 1);
// *_bs / *_ts are the batch and token strides in elements. For bf16 the
// pointers must be 16-byte aligned, every stride a multiple of 8 and the
// scale positive (the Python wrapper checks it). out: contiguous
// (B, Nq, H, D). Returns the cudaError_t of the launch.
extern "C" int gfnet_oneshot_attention(const void* q, const void* k, const void* v, void* out,
                                       int batch, int nq, int nk, int heads, int head_dim,
                                       long long q_bs, long long q_ts, long long k_bs,
                                       long long k_ts, long long v_bs, long long v_ts,
                                       float scale, int is_bf16, void* stream) {
  if (batch <= 0 || nq <= 0 || nk <= 0 || heads <= 0) return cudaErrorInvalidValue;
  const Args a{q, k, v, out, batch, nq, nk, heads, q_bs, q_ts, k_bs, k_ts, v_bs, v_ts, scale,
               static_cast<cudaStream_t>(stream)};
  switch (head_dim) {
    case 8:
      return is_bf16 ? launch_mma<8>(a) : launch_f32<8>(a);
    case 16:
      return is_bf16 ? launch_mma<16>(a) : launch_f32<16>(a);
    case 32:
      return is_bf16 ? launch_mma<32>(a) : launch_f32<32>(a);
    case 64:
      return is_bf16 ? launch_wgmma(a) : launch_f32<64>(a);
    case 128:
      return is_bf16 ? launch_mma<128>(a) : launch_f32<128>(a);
    default:
      return cudaErrorInvalidValue;
  }
}
