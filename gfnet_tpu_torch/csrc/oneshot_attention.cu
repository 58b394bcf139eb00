// Streaming softmax attention for the ViT backbone and the cross-view decoder.
//
// Replaces the TPU kernel `oneshot_attention` (gfnet_tpu/ops/pallas/
// oneshot_attention.py, fold layout, body `_kernel`): non-causal
// softmax(q·kᵀ·scale)·v over (B, N, H, D) tensors, at any head dim.
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
// The kernels, chosen by type and head dim (8, 16, 32, 64, 128 or 256; the
// wrapper zero-pads any other head dim up to 256 to the next of these, and
// one above 256 to a multiple of 64, for v too in bf16 and to whole groups of
// 256 for v in float32):
//  - bf16 with D = 64, 128, 256: `oneshot_attention_wgmma_kernel<D>`.
//    Warpgroups own 64 q rows each (two a block, one at D = 256) and share a
//    ring of 64-key K/V stages in shared memory (four, three at D = 256,
//    where a stage is 64 KB). One thread fills the ring by TMA from a
//    (D, H, N, B) tensor map over k and v as they lie (any batch and token
//    stride), one 64-channel box at a time, 128-byte swizzled, rows past N
//    zero-filled; an `mbarrier` a stage says when its bytes have landed, a
//    second when all the warps have left it, so the warpgroups never meet at
//    a block-wide barrier and two tiles are in flight while one is
//    multiplied. S = Q·Kᵀ is `wgmma.m64n64k16`, with Q in registers at D = 64
//    and read from shared memory (one TMA load of the block's rows) above,
//    where the D·64 float32 output accumulator needs the registers (128 a
//    thread at D = 256); K is read K-major from shared memory. The S
//    accumulator, re-packed to bf16, is the register A operand of P·V, whose
//    B operand is each 64-channel box of the V tile as stored (MN-major, the
//    descriptor's transpose bit): nothing is transposed by hand and
//    probabilities never touch memory. Each step starts S(j+1) and
//    O += P(j)·V(j) as one batch, so the tensor cores get a batch of
//    products and one wait a tile. At D = 64 two blocks an SM.
//  - bf16 with D = 8, 16 or 32 (the cross-view decoder at D = 8; the others
//    where a config's widths give them): `oneshot_attention_mma_kernel<D>`.
//    Eight warps own 16 q rows each; K and V of the (batch, head) lie in
//    shared memory in chunks of 64 KB (the whole kv at N = 1600, D = 8: 51
//    KB; 512 keys at D = 32), brought by 16-byte `cp.async` and XOR-swizzled
//    by 16-byte piece so that the eight rows one `ldmatrix` reads lie in
//    eight bank groups. S is `mma.sync.m16n8k8` at D = 8 and D/16 steps of
//    `m16n8k16` above, with K fragments from `ldmatrix`; P·V is `m16n8k16`
//    over 16 keys into D/8 accumulator n-tiles, with V fragments from
//    `ldmatrix.trans`. `wgmma` is not worth its 64-row tile at k = 8.
//  - bf16 above D = 256: `oneshot_attention_wide_kernel` (a decoder with
//    `nhead: 1` over more than 256 channels). What bounds it: at
//    (2,1024,1,320) the work is 2.7 GFLOP (2.7 µs at 989 TFLOP/s), 5.2 MB of
//    q/k/v/out (1.6 µs at 3.35 TB/s) and 2.1 M exponentials (0.5 µs); at
//    D = 512 4.3 GFLOP (4.3 µs), 8.4 MB (2.5 µs), the same exponentials
//    (`utils/profiling.bound`): the tensor cores, where a 64-row block at
//    D = 320 reads 80 KB of K and V a 64-key tile and, with 32 blocks, the
//    kv range is split 4 ways. A Q box alone is 8 KB of 64 channels, a
//    whole tile of K and V at D = 512 128 KB, so the ring's unit is one
//    64 x 64 box, streamed by TMA (128-byte swizzle) in the order the
//    products use it: per tile K0 K1 ... then the slab's V boxes, with Q
//    resident (or, where Q and eight boxes would not fit beside each other,
//    D > 1280, Q's boxes interleaved with K's). The ring takes the rest of
//    the 227 KB (23 boxes at D = 320), so a tile and a half is in flight
//    whatever D is. A block owns 64 q rows and up to 512 columns of v (a
//    slab; wider v takes more slabs, each recomputing the logits), split
//    over two warpgroups of at most 256 columns (128 float32 accumulator
//    registers a thread); v is padded to a multiple of 64 only. Both
//    warpgroups multiply S = Q·Kᵀ on `wgmma` over the same staged boxes in
//    the same order (chosen over one warpgroup handing P to the other
//    through shared memory: no barrier between them, and the logits, max
//    and sum of the two are equal bit for bit), so the logits are computed
//    once a warpgroup for all of its columns; each box's products are one
//    committed group, and a box is left once the next box's group is in
//    flight. P stays in registers as the A operand of P·V over the
//    warpgroup's own V boxes. A third warpgroup loads the boxes (one lane
//    starts each copy once its slot is free) and gives its registers to the
//    two that multiply (`setmaxnreg`). Measured on the H100 at
//    (2,1024,1,320): loads started by a consumer thread between its products
//    took 1.5× the time of a producer of its own; and a branch that only some
//    lanes take while products are in flight, or a warpgroup index the
//    compiler cannot see is warp-uniform, makes `ptxas` serialise every
//    `wgmma` (C7520; 1.45× the time, with 168 registers a thread and spills
//    beside it), so the index is broadcast by `__shfl_sync` and a warp
//    leaves a box by a predicated arrive.
//  - float32 at every D: `oneshot_attention_tf32x3_kernel<DK, DV>`, on the
//    tensor cores in three TF32 passes (numerics below). Four warps own 16 q
//    rows each; K and V tiles (64 keys at D ≤ 64, 32 at 128, 16 at 256, 32
//    of V alone in a column group)
//    come by `cp.async`, double-buffered, into rows padded so that the
//    fragment loads of one instruction meet no bank twice (K read as float2
//    at a stride of 8 mod 32 words, V as floats at 4 mod 8). Q is split into
//    its TF32 halves once, in registers, at D ≤ 64; above, and for column
//    groups (DK = 0: logits over a runtime head dim, K read from device
//    memory too), its fragments are read from device memory each tile.
//    `mma.sync.m16n8k8.tf32` and not `wgmma`: TF32 `wgmma` needs both
//    operands K-major, so V would have to be transposed in shared memory.
//    The S accumulator is P·V's A operand in place: a thread holds keys 2t
//    and 2t+1 of an n-tile, which become the k-indices t and t+4 of the A
//    fragment when V's rows are read in the same order.
// Where a launch has fewer blocks than the card has SMs (small B·H·N), the
// kernels split the kv range over blocks too: each
// writes its rows' unnormalised output, running max and sum to a float32
// workspace, and `oneshot_attention_merge_kernel` combines the splits by
// their log-sum-exp. One call, two launches.
// All read q/k/v in place with their batch and token strides, so the
// (B,N,H,D)→(B·H,N,D) relayout of the TPU version, and the split of a fused
// qkv projection, cost no copy. The kernels read 16-byte vectors: the
// caller guarantees 16-byte aligned pointers and strides of whole 16-byte
// vectors, and for bf16 a positive scale (its max is taken before scaling).
//
// Numerics follow the TPU kernel: logits and softmax in float32; the
// probabilities are rounded to the storage type before the PV product, which
// accumulates in float32; the row sum comes from the unrounded probabilities
// and divides after PV; the ragged kv tail is masked by index, with no pad.
// Exponentials are `ex2` of logits scaled by scale·log2(e) (bf16: folded into
// one multiply-add with the max; float32: the logits scaled first, so any
// scale works). float32 products give float32 results, not TF32 ones: each
// operand x is split into hi = tf32(x) and lo = tf32(x − hi), and each product
// is hi·hi + hi·lo + lo·hi on the TF32 tensor cores, accumulated in float32
// (the dropped lo·lo is ~2^-22 of the product). The tensor cores round the
// sum of a product into its accumulator toward zero, so the small products
// of Q·Kᵀ are summed apart from hi·hi, hi·hi 64 channels at a time, and each
// kv tile's P·V apart from the running output, each then added in float32.

#include <cuda.h>  // CUtensorMap and its enums; nothing of libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// K1's ablations for timing (scripts/profile_oneshot_parts_torch.py builds this
// file a second time with the macro set; the package's library never does):
// 0 the full softmax; 1 `dots`: the logits themselves as P, no max, no
// exponential, no sum; 2 `max`: the running max and the rescale, P = the
// shifted logits, no exponential, no sum; 3 `exp_bf16`: the exponentials by
// `ex2.approx.ftz.bf16x2` of the shifted logits rounded to bf16, two a call.
#ifndef GFNET_K1_ABLATION
#define GFNET_K1_ABLATION 0
#endif

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStep = 64;  // keys per online-softmax update of the bf16 kernels: 8 accumulator n-tiles

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

// The accumulator layout that `mma.sync.m16n8` and `wgmma.m64nN` share (g =
// lane / 4, t = lane % 4): x[4j + e] is row g (e < 2) or g + 8 (e >= 2),
// column 8j + 2t + (e & 1).

// o / l to the (B, Nq, H, dv) output, rows r_lo and r_lo + 8, the n-tiles at
// columns col0 onwards (the first `no` of o's values a row pair)
template <typename T, int NO>
__device__ __forceinline__ void store_rows(const float (&o)[NO], float l_lo, float l_hi,
                                           T* __restrict__ out, int b, int h, int heads, int nq,
                                           int r_lo, int t, int dv = NO * 2, int col0 = 0, int no = NO) {
  const float inv_lo = 1.f / quad_sum(l_lo), inv_hi = 1.f / quad_sum(l_hi);
  T* ob = out + ((long long)b * nq * heads + h) * dv + col0;
#pragma unroll
  for (int jd = 0; jd < NO / 4; ++jd) {
    if (4 * jd >= no) break;
    const int col = 8 * jd + 2 * t;
    if (r_lo < nq) {
      T* p = ob + (long long)r_lo * heads * dv + col;
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<__nv_bfloat162*>(p) =
            __floats2bfloat162_rn(o[4 * jd + 0] * inv_lo, o[4 * jd + 1] * inv_lo);
      else
        *reinterpret_cast<float2*>(p) = make_float2(o[4 * jd + 0] * inv_lo, o[4 * jd + 1] * inv_lo);
    }
    if (r_lo + 8 < nq) {
      T* p = ob + (long long)(r_lo + 8) * heads * dv + col;
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<__nv_bfloat162*>(p) =
            __floats2bfloat162_rn(o[4 * jd + 2] * inv_hi, o[4 * jd + 3] * inv_hi);
      else
        *reinterpret_cast<float2*>(p) = make_float2(o[4 * jd + 2] * inv_hi, o[4 * jd + 3] * inv_hi);
    }
  }
}

// One kv split's rows, unnormalised, to the float32 workspace of `splits`
// splits over R = B·H·Nq rows of dv columns: o at part[(split·R + row)·dv +
// col0 + col] (row = bh·nq + r; the first `no` of o's values), then, by the
// group at col0 = 0, the running max in the log2 domain (m2) and the row sum
// at part[splits·R·dv + split·R + row] and splits·R further on.
template <int NO>
__device__ __forceinline__ void store_partial(const float (&o)[NO], float m2_lo, float m2_hi,
                                              float l_lo, float l_hi, float* __restrict__ part,
                                              int splits, int split, int bh, int nq, int r_lo,
                                              int t, int dv, int col0, int no = NO) {
  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  const long long R = (long long)gridDim.y * nq;
  float* ml = part + splits * R * dv;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + 8 * half;
    if (r >= nq) continue;
    const long long row = (long long)bh * nq + r;
    float* po = part + (split * R + row) * dv + col0;
#pragma unroll
    for (int jd = 0; jd < NO / 4; ++jd)
      if (4 * jd < no)
        *reinterpret_cast<float2*>(po + 8 * jd + 2 * t) =
            make_float2(o[4 * jd + 2 * half], o[4 * jd + 2 * half + 1]);
    if (col0 == 0 && t == 0) {
      ml[split * R + row] = half ? m2_hi : m2_lo;
      ml[(splits + split) * R + row] = half ? l_hi : l_lo;
    }
  }
}

// ------------------------------------------------------------------- float32
// One online-softmax update over 8·NT keys in float32: the logits taken into
// the log2 domain first (·c, any sign), keys at or past `kv_end` masked by
// index, the exponentials left in `s` in place, their sums added to l, o and
// l rescaled when a running max moved. The first step of a range always
// holds a real key, so the max is finite after it and exp2(-inf) = 0 wipes
// nothing but zeros.
template <int NT, int NO>
__device__ __forceinline__ void softmax_step_f32(float (&s)[4 * NT], float (&o)[NO], float& m_lo,
                                                 float& m_hi, float& l_lo, float& l_hi, float c,
                                                 int first_key, int kv_end, int t) {
#pragma unroll
  for (int i = 0; i < 4 * NT; ++i) s[i] *= c;
  if (first_key + 8 * NT > kv_end) {
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i)
      if (first_key + 8 * (i / 4) + 2 * t + (i & 1) >= kv_end) s[i] = -INFINITY;
  }
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j + 0], s[4 * j + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  const float mn_lo = fmaxf(m_lo, quad_max(mx_lo)), mn_hi = fmaxf(m_hi, quad_max(mx_hi));
  if (__any_sync(0xffffffffu, (mn_lo != m_lo) || (mn_hi != m_hi))) {
    const float a_lo = fast_exp2(m_lo - mn_lo), a_hi = fast_exp2(m_hi - mn_hi);
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
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[4 * j + 0] = fast_exp2(s[4 * j + 0] - mn_lo);
    s[4 * j + 1] = fast_exp2(s[4 * j + 1] - mn_lo);
    s[4 * j + 2] = fast_exp2(s[4 * j + 2] - mn_hi);
    s[4 * j + 3] = fast_exp2(s[4 * j + 3] - mn_hi);
    l_lo += s[4 * j + 0] + s[4 * j + 1];
    l_hi += s[4 * j + 2] + s[4 * j + 3];
  }
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~22 bits: hi = tf32(x), lo = tf32(x − hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a·b for one 16x8x8 tile: a 16x8 TF32 (row), b 8x8 TF32 (col), c float32
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a·b in float32 precision from TF32 halves: the two small products added
// to `small`, then hi·hi to `big` (the same accumulator, or one kept apart)
__device__ __forceinline__ void mma_3xtf32(float* big, float* small, const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(small, al, bh0, bh1);
  mma_tf32(small, ah, bl0, bl1);
  mma_tf32(big, ah, bh0, bh1);
}

// A fragment (a0..a3 = rows g | g+8 at k-index t, then t+4) of four float32 values, split
__device__ __forceinline__ void split_frag(float a0, float a1, float a2, float a3, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split_tf32(a0, hi[0], lo[0]);
  split_tf32(a1, hi[1], lo[1]);
  split_tf32(a2, hi[2], lo[2]);
  split_tf32(a3, hi[3], lo[3]);
}

constexpr int kF32Warps = 4;  // 16 q rows each
constexpr int kF32Rows = 16 * kF32Warps;
constexpr int kF32GroupCols = 256;  // output columns of a float32 column group

// DK == DV: D in {8, 16, 32, 64, 128, 256}. DK == 0: a column group of DV =
// 256 output columns, logits over a runtime head dim read from device memory.
template <int DK, int DV>
struct F32Shape {
  // keys a tile: K and V of one tile in a third of the shared memory; a
  // column group stages only V
  static constexpr int kKeys = DV <= 64 ? 64 : (DV == 128 || DK == 0) ? 32 : 16;
  static constexpr bool kQRegs = DK > 0 && DK <= 64;  // Q's TF32 halves held in registers
  static constexpr bool kKStaged = DK > 0;            // else K fragments from device memory
  // row strides in floats: K read as float2 (k-indices t, t+4 are channels
  // 2t, 2t+1), eight keys x four pairs per half-warp: 8 mod 32 words; V read
  // as floats at keys 2t, 2t+1 and eight channels: 4 mod 8 words
  static constexpr int kKStride = DK == 8 ? 8 : DK + 8;
  static constexpr int kVStride = DV + 4;
  static constexpr int kKFloats = kKStaged ? kKeys * kKStride : 0;
  static constexpr int kStageFloats = kKFloats + kKeys * kVStride;
  static constexpr int kSmemBytes = 2 * kStageFloats * 4;  // double-buffered
};

template <int DK, int DV>
__global__ void __launch_bounds__(kF32Warps * 32)
oneshot_attention_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, float* __restrict__ out,
                                float* __restrict__ part, int nq, int nk, int heads, int dk, int dv,
                                long long q_bs, long long q_ts, long long k_bs, long long k_ts,
                                long long v_bs, long long v_ts, float c, int groups, int kv_split) {
  using S = F32Shape<DK, DV>;
  constexpr int KT = S::kKeys, NT = KT / 8, NO = DV / 2;
  static_assert(DV % 8 == 0 && (DK == 0 || DK == DV), "float32 attention shape");
  extern __shared__ __align__(16) float smem_f[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int grp = blockIdx.z % groups, split = blockIdx.z / groups;
  const int kv0 = split * kv_split, kv1 = min(nk, kv0 + kv_split);
  const int r_lo = blockIdx.x * kF32Rows + warp * 16 + g, r_hi = r_lo + 8;
  const int width = DK > 0 ? DK : dk;  // the logits' head dim

  // rows past nq read row nq - 1: finite, and never stored
  const float* q_lo = q + b * q_bs + (long long)min(r_lo, nq - 1) * q_ts + h * width + 2 * t;
  const float* q_hi = q + b * q_bs + (long long)min(r_hi, nq - 1) * q_ts + h * width + 2 * t;
  const float* kb = k + b * k_bs + (long long)h * width;
  const float* vb = v + b * v_bs + (long long)h * dv + grp * DV;

  // Q's A fragments (k-indices t, t+4 = channels 2t, 2t+1 of each k-step)
  uint32_t qh[S::kQRegs ? DK / 8 : 1][4], ql[S::kQRegs ? DK / 8 : 1][4];
  if constexpr (S::kQRegs) {
#pragma unroll
    for (int kk = 0; kk < DK / 8; ++kk) {
      const float2 a = *reinterpret_cast<const float2*>(q_lo + 8 * kk);
      const float2 e = *reinterpret_cast<const float2*>(q_hi + 8 * kk);
      split_frag(a.x, e.x, a.y, e.y, qh[kk], ql[kk]);
    }
  }

  auto stage = [&](int buf, int t0) {
    float* ks = smem_f + buf * S::kStageFloats;
    float* vs = ks + S::kKFloats;
    constexpr int kVVec = DV / 4;
    for (int i = threadIdx.x; i < KT * kVVec; i += kF32Warps * 32) {
      const int row = i / kVVec, pc = i % kVVec;
      const bool valid = t0 + row < kv1;
      cp_async16(smem_u32(vs + row * S::kVStride + 4 * pc), vb + (valid ? t0 + row : kv0) * v_ts + 4 * pc,
                 valid);
    }
    if constexpr (S::kKStaged) {
      constexpr int kKVec = DK / 4;
      for (int i = threadIdx.x; i < KT * kKVec; i += kF32Warps * 32) {
        const int row = i / kKVec, pc = i % kKVec;
        const bool valid = t0 + row < kv1;
        cp_async16(smem_u32(ks + row * S::kKStride + 4 * pc),
                   kb + (valid ? t0 + row : kv0) * k_ts + 4 * pc, valid);
      }
    }
    cp_async_commit();
  };

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  const int tiles = (kv1 - kv0 + KT - 1) / KT;
  stage(0, kv0);
  for (int it = 0; it < tiles; ++it) {
    const int t0 = kv0 + it * KT;
    if (it + 1 < tiles) {
      stage((it + 1) & 1, t0 + KT);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = smem_f + (it & 1) * S::kStageFloats;
    const float* vs = ks + S::kKFloats;

    // S = Q·Kᵀ, one k-step of 8 channels at a time, in the same order in
    // every column group: hi·hi of 64 channels in tc, added to s in float32;
    // the small products apart in sl
    constexpr int kChunk = DK > 0 && DK < 64 ? DK : 64;  // width is a multiple of it
    constexpr bool kOneChunk = DK > 0 && DK <= 64;        // then straight into s
    float s[4 * NT], sl[4 * NT];
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) s[i] = sl[i] = 0.f;
#pragma unroll(DK > 0 ? (DK + 63) / 64 : 1)
    for (int c0 = 0; c0 < width; c0 += kChunk) {
      float tc[4 * NT];
#pragma unroll
      for (int i = 0; i < 4 * NT; ++i) tc[i] = 0.f;
#pragma unroll
      for (int k8 = 0; k8 < kChunk / 8; ++k8) {
        const int kk = c0 / 8 + k8;
        uint32_t ah[4], al[4];
        if constexpr (S::kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ah[e] = qh[k8][e];  // one chunk: kk == k8
            al[e] = ql[k8][e];
          }
        } else {
          const float2 a = __ldg(reinterpret_cast<const float2*>(q_lo + 8 * kk));
          const float2 e = __ldg(reinterpret_cast<const float2*>(q_hi + 8 * kk));
          split_frag(a.x, e.x, a.y, e.y, ah, al);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float2 kf;
          if constexpr (S::kKStaged) {
            kf = *reinterpret_cast<const float2*>(ks + (8 * j + g) * S::kKStride + 8 * kk + 2 * t);
          } else {
            const int key = min(t0 + 8 * j + g, kv1 - 1);  // past the range: masked below
            kf = __ldg(reinterpret_cast<const float2*>(kb + key * k_ts + 8 * kk + 2 * t));
          }
          mma_3xtf32(kOneChunk ? &s[4 * j] : &tc[4 * j], &sl[4 * j], ah, al, kf.x, kf.y);
        }
      }
      if constexpr (!kOneChunk) {
#pragma unroll
        for (int i = 0; i < 4 * NT; ++i) s[i] += tc[i];
      }
    }
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) s[i] += sl[i];

    softmax_step_f32<NT, NO>(s, o, m_lo, m_hi, l_lo, l_hi, c, t0, kv1, t);

    // O += P·V: keys 2t, 2t+1 of n-tile j are k-indices t, t+4. The tile's
    // products are summed apart, 64 columns at a time, and added to o in
    // float32
    constexpr int kCols = DV < 64 ? DV : 64;
#pragma unroll
    for (int c0 = 0; c0 < DV; c0 += kCols) {
      float acc[kCols / 2];
#pragma unroll
      for (int i = 0; i < kCols / 2; ++i) acc[i] = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t ph[4], pl[4];
        split_frag(s[4 * j + 0], s[4 * j + 2], s[4 * j + 1], s[4 * j + 3], ph, pl);
        const float* v0 = vs + (8 * j + 2 * t) * S::kVStride + c0 + g;
#pragma unroll
        for (int dn = 0; dn < kCols / 8; ++dn)
          mma_3xtf32(&acc[4 * dn], &acc[4 * dn], ph, pl, v0[8 * dn], v0[S::kVStride + 8 * dn]);
      }
#pragma unroll
      for (int i = 0; i < kCols / 2; ++i) o[c0 / 2 + i] += acc[i];
    }
    __syncthreads();  // the buffer is refilled next iteration
  }

  if (part == nullptr)
    store_rows<float, NO>(o, l_lo, l_hi, out, b, h, heads, nq, r_lo, t, dv, grp * DV);
  else
    store_partial<NO>(o, m_lo, m_hi, l_lo, l_hi, part, gridDim.z / groups, split, blockIdx.y, nq, r_lo,
                      t, dv, grp * DV);
}

// The splits of a kv range combined: for each row, weights 2^(m_s − max m)
// on each split's unnormalised output and sum (`store_partial`'s layout),
// one thread per row and four columns.
template <typename T>
__global__ void __launch_bounds__(256)
oneshot_attention_merge_kernel(const float* __restrict__ part, T* __restrict__ out, int splits,
                               int nq, int heads, int dv, long long rows) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int vecs = dv / 4;
  if (idx >= rows * vecs) return;
  const long long row = idx / vecs;
  const int col = 4 * (int)(idx % vecs);
  const float* m2 = part + splits * rows * dv;
  const float* l = m2 + splits * rows;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, m2[s * rows + row]);
  float den = 0.f;
  float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float w = exp2f(m2[s * rows + row] - mx);
    den += w * l[s * rows + row];
    const float4 x = *reinterpret_cast<const float4*>(part + (s * rows + row) * dv + col);
    num.x += w * x.x;
    num.y += w * x.y;
    num.z += w * x.z;
    num.w += w * x.w;
  }
  const float inv = 1.f / den;
  const long long bh = row / nq, n = row % nq;
  T* p = out + (((bh / heads) * nq + n) * heads + bh % heads) * dv + col;
  if constexpr (sizeof(T) == 2) {
    reinterpret_cast<__nv_bfloat162*>(p)[0] = __floats2bfloat162_rn(num.x * inv, num.y * inv);
    reinterpret_cast<__nv_bfloat162*>(p)[1] = __floats2bfloat162_rn(num.z * inv, num.w * inv);
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(num.x * inv, num.y * inv, num.z * inv, num.w * inv);
  }
}

// ----------------------------------------------------------------- bf16 softmax
// One online-softmax update over 64 keys. `s` holds raw logits q·k in the
// accumulator layout; `o` the same layout over the head dim. Leaves the
// probabilities as bf16 A fragments of the four 16-key k-blocks in `pa`
// (n-tiles 2kb, 2kb+1 form k-block kb), adds their unrounded sums to l, and
// rescales o and l when a running max moved. c = scale·log2(e) > 0. Keys at
// or past `kv_end` are masked by index. The first step of a range always
// holds a real key, so the running max is finite after it and exp2(-inf) = 0
// wipes nothing but zeros.
template <int NO>
__device__ __forceinline__ void softmax_step(float (&s)[32], float (&o)[NO], uint32_t (&pa)[4][4],
                                             float& m_lo, float& m_hi, float& l_lo, float& l_hi,
                                             float c, int first_key, int kv_end, int t) {
#if GFNET_K1_ABLATION == 1
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(s[4 * j + 0], s[4 * j + 1]);
    pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
  l_lo = l_hi = 1.f;
  return;
#endif
  if (first_key + kStep > kv_end) {  // the ragged tail: mask by index
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (first_key + 8 * (i / 4) + 2 * t + (i & 1) >= kv_end) s[i] = -INFINITY;
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
#if GFNET_K1_ABLATION == 2
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(fmaf(s[4 * j + 0], c, nb_lo), fmaf(s[4 * j + 1], c, nb_lo));
    pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(fmaf(s[4 * j + 2], c, nb_hi), fmaf(s[4 * j + 3], c, nb_hi));
  }
  l_lo = l_hi = 1.f;
  return;
#elif GFNET_K1_ABLATION == 3
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t p01, p23;
    asm("ex2.approx.ftz.bf16x2 %0, %1;\n"
        : "=r"(p01)
        : "r"(pack_bf16(fmaf(s[4 * j + 0], c, nb_lo), fmaf(s[4 * j + 1], c, nb_lo))));
    asm("ex2.approx.ftz.bf16x2 %0, %1;\n"
        : "=r"(p23)
        : "r"(pack_bf16(fmaf(s[4 * j + 2], c, nb_hi), fmaf(s[4 * j + 3], c, nb_hi))));
    l_lo += __uint_as_float(p01 << 16) + __uint_as_float(p01 & 0xFFFF0000u);
    l_hi += __uint_as_float(p23 << 16) + __uint_as_float(p23 & 0xFFFF0000u);
    pa[j / 2][(j % 2) * 2 + 0] = p01;
    pa[j / 2][(j % 2) * 2 + 1] = p23;
  }
  return;
#endif
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

// --------------------------------------------------------- bf16, D = 64, 128, 256
constexpr int kBoxBytes = kStep * 128;  // one TMA box: 64 rows of 64 bf16

template <int D>
struct WgShape {
  static constexpr int kGroups = D == 256 ? 1 : 2;  // warpgroups of 64 q rows
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kChunks = D / 64;            // 64-channel boxes of a row
  static constexpr int kTileBytes = kChunks * kBoxBytes;  // one K or V tile of 64 keys
  static constexpr int kStageBytes = 2 * kTileBytes;      // K then V
  // ring stages: at least three, since step j waits for tile j + 1 and a
  // stage is refilled only at the step after the one that left it; at D = 64
  // three to six time alike on the H100 (four kept)
  static constexpr int kStages = D == 256 ? 3 : 4;
  static constexpr bool kQRegs = D == 64;  // else Q in shared memory
  static constexpr int kQBytes = kQRegs ? 0 : kChunks * kGroups * kBoxBytes;
  static constexpr int kSmemBytes = kStages * kStageBytes + kQBytes + 1024 + 128;  // + alignment, barriers
  static constexpr int kMinBlocks = D == 64 ? 2 : 1;
};

// Shared-memory matrix descriptor of a tile of 128-byte rows in the 128-byte
// swizzle: start address, leading and stride offsets of 1024 B (eight rows),
// in units of 16 bytes. Q and K are read K-major (d contiguous), V MN-major
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

// waits until at most N committed groups of this warp's products are pending
template <int N = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

// d (64 x 64 float32, spread over the warpgroup) = a·b (+ d if scale_d):
// a 64 x 16 bf16 from registers, b 16 x 64 bf16 from shared memory
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16(float* d, const uint32_t (&a)[4], uint64_t desc_b,
                                                int scale_d) {
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

// the same with a from shared memory too (K-major)
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t desc_a, uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
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

// one box (64 channels from `col`, `rows` tokens from `row`) of a (D, H, N, B)
// tensor map into shared memory
__device__ __forceinline__ void tma_load_box(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                             int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// K then V of the 64 keys from `key` into a ring stage, every box on one barrier
template <int D>
__device__ __forceinline__ void load_kv_stage(uint32_t stage, const CUtensorMap* map_k,
                                              const CUtensorMap* map_v, uint32_t bar, int head,
                                              int key, int batch) {
  using W = WgShape<D>;
  mbar_expect_tx(bar, W::kStageBytes);
#pragma unroll
  for (int ch = 0; ch < W::kChunks; ++ch) {
    tma_load_box(stage + ch * kBoxBytes, map_k, bar, 64 * ch, head, key, batch);
    tma_load_box(stage + W::kTileBytes + ch * kBoxBytes, map_v, bar, 64 * ch, head, key, batch);
  }
}

// S = Q·Kᵀ of one 64-key tile at `ks` for this warpgroup's 64 rows: Q from
// registers (D = 64) or from its rows of the block's Q boxes at `qw`
template <int D>
__device__ __forceinline__ void wgmma_qk(float (&s)[32], const uint32_t (&qa)[4][4], uint32_t qw,
                                         uint32_t ks) {
  using W = WgShape<D>;
  if constexpr (W::kQRegs) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 16 channels = 32 bytes along a K row
      wgmma_m64n64k16<0>(s, qa[kk], smem_desc(ks + 32 * kk), kk > 0);
  } else {
#pragma unroll
    for (int ch = 0; ch < W::kChunks; ++ch)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_ss(s, smem_desc(qw + ch * W::kGroups * kBoxBytes + 32 * kk),
                           smem_desc(ks + ch * kBoxBytes + 32 * kk), ch > 0 || kk > 0);
  }
}

template <int D>
__global__ void __launch_bounds__(WgShape<D>::kThreads, WgShape<D>::kMinBlocks)
oneshot_attention_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v,
                               const bf16* __restrict__ q, bf16* __restrict__ out,
                               float* __restrict__ part, int nq, int nk, int heads, long long q_bs,
                               long long q_ts, float c, int kv_split) {
  using W = WgShape<D>;
  constexpr int kStages = W::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's period
  const uint32_t qs = ring + kStages * W::kStageBytes;
  const uint32_t full = qs + W::kQBytes, empty = full + 8 * kStages, qbar = empty + 8 * kStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int row0 = blockIdx.x * W::kGroups * 64;
  const int r_lo = row0 + warp * 16 + g;
  const int r_hi = r_lo + 8;
  const int kv0 = blockIdx.z * kv_split, kv1 = min(nk, kv0 + kv_split);
  const int tiles = (kv1 - kv0 + kStep - 1) / kStep;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);                   // the loading thread, with the tile's bytes
      mbar_init(empty + 8 * st, W::kThreads / 32);   // one lane of every warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if constexpr (!W::kQRegs) {
      mbar_expect_tx(qbar, W::kQBytes);
#pragma unroll
      for (int ch = 0; ch < W::kChunks; ++ch)
        tma_load_box(qs + ch * W::kGroups * kBoxBytes, &map_q, qbar, 64 * ch, h, row0, b);
    }
#pragma unroll
    for (int st = 0; st < kStages; ++st)
      if (st < tiles)
        load_kv_stage<D>(ring + st * W::kStageBytes, &map_k, &map_v, full + 8 * st, h, kv0 + st * kStep, b);
  }
  __syncwarp();

  // Q as A fragments over the four 16-wide k-blocks of D = 64; rows past nq are 0
  uint32_t qa[4][4];
  if constexpr (W::kQRegs) {
    const bf16* qb = q + b * q_bs + h * D;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int col = 16 * kk + 2 * t;
      qa[kk][0] = r_lo < nq ? load_pair(qb + r_lo * q_ts + col) : 0u;
      qa[kk][1] = r_hi < nq ? load_pair(qb + r_hi * q_ts + col) : 0u;
      qa[kk][2] = r_lo < nq ? load_pair(qb + r_lo * q_ts + col + 8) : 0u;
      qa[kk][3] = r_hi < nq ? load_pair(qb + r_hi * q_ts + col + 8) : 0u;
    }
  } else {
    mbar_wait(qbar, 0);
  }
  const uint32_t qw = qs + (warp / 4) * kBoxBytes;  // this warpgroup's rows of each Q box
  float o[D / 2], s[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  uint32_t pa[4][4];

  // S(0) and its softmax, then per step the products of two tiles in one
  // batch: S(j+1) = Q·K(j+1)ᵀ and O += P(j)·V(j)
  mbar_wait(full, 0);
  wgmma_fence();
  wgmma_qk<D>(s, qa, qw, ring);
  wgmma_commit();
  wgmma_wait();
  fence_regs(s);
  softmax_step(s, o, pa, m_lo, m_hi, l_lo, l_hi, c, kv0, kv1, t);

  for (int j = 0; j < tiles; ++j) {
    const bool more = j + 1 < tiles;
    const uint32_t vs = ring + (j % kStages) * W::kStageBytes + W::kTileBytes;
    const uint32_t ks = ring + ((j + 1) % kStages) * W::kStageBytes;
    if (more) mbar_wait(full + 8 * ((j + 1) % kStages), ((j + 1) / kStages) & 1);
    fence_regs(o);
    wgmma_fence();
    if (more) wgmma_qk<D>(s, qa, qw, ks);
#pragma unroll
    for (int vc = 0; vc < W::kChunks; ++vc)  // each 64-channel box of V
#pragma unroll
      for (int kb2 = 0; kb2 < 4; ++kb2)  // 16 keys = 16 rows of V
        wgmma_m64n64k16<1>(&o[32 * vc], pa[kb2], smem_desc(vs + vc * kBoxBytes + 16 * 128 * kb2), 1);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(o);
    // this warp is done with tile j; the stage that tile j - 1 left, which the
    // other warpgroup has left by now too, takes tile j - 1 + kStages
    if (lane == 0) mbar_arrive(empty + 8 * (j % kStages));
    if (threadIdx.x == 0 && j >= 1 && j - 1 + kStages < tiles) {
      const int nt = j - 1 + kStages, st = nt % kStages;
      mbar_wait(empty + 8 * st, ((nt / kStages) & 1) ^ 1);
      load_kv_stage<D>(ring + st * W::kStageBytes, &map_k, &map_v, full + 8 * st, h, kv0 + nt * kStep, b);
    }
    __syncwarp();
    if (more) softmax_step(s, o, pa, m_lo, m_hi, l_lo, l_hi, c, kv0 + (j + 1) * kStep, kv1, t);
  }
  if (part == nullptr)
    store_rows<bf16, D / 2>(o, l_lo, l_hi, out, b, h, heads, nq, r_lo, t);
  else
    store_partial<D / 2>(o, m_lo * c, m_hi * c, l_lo, l_hi, part, gridDim.z, blockIdx.z, blockIdx.y,
                         nq, r_lo, t, D, 0);
}

// ----------------------------------------------------------- bf16 above D = 256
// The ring's unit is one 64 x 64 box (8 KB), not a K/V tile, so its depth does
// not depend on the head dim. A block owns 64 q rows and up to eight boxes of
// v's columns (a slab), split over two warpgroups of at most four boxes (256
// columns: 128 float32 accumulator registers a thread). Each box of the stream
// is one of: a Q box (only where Q is not resident), a K box, a V box of the
// slab; per 64-key tile the stream is Q0 K0 Q1 K1 ... or K0 K1 ..., then V.
constexpr int kWideSmemBytes = 232448;  // all a block may use: one block an SM
constexpr int kWideMinRing = 8;         // boxes; see the producer's note below
constexpr int kWideGroupBoxes = 4;      // v's boxes a warpgroup owns at most
constexpr int kWideSlabBoxes = 2 * kWideGroupBoxes;
constexpr int kWideFixedBytes = 1024 + 8;  // the swizzle's alignment; the Q barrier
constexpr int kWideBoxCost = kBoxBytes + 16;  // a ring box and its two barriers

struct WideStream {
  uint32_t qs, ring_base, full, empty;  // shared addresses: resident Q, ring, barriers
  int ring;                             // boxes in the ring
  int kb, nv, per_tile;                 // K boxes (DK / 64), the slab's V boxes, boxes a tile
  bool stream_q;                        // Q's boxes pass through the ring with K's
  int vb0, h, b, row0, kv0, total;      // the slab's first V box, coordinates; boxes in all
};

// box r of kv tile `tile`'s part of the stream into ring slot `slot`, on the
// slot's full barrier
__device__ __forceinline__ void wide_load(const WideStream& w, const CUtensorMap* map_q,
                                          const CUtensorMap* map_k, const CUtensorMap* map_v, int slot,
                                          int tile, int r) {
  const uint32_t dst = w.ring_base + slot * kBoxBytes, bar = w.full + 8 * slot;
  const int key = w.kv0 + tile * kStep, kpart = w.stream_q ? 2 * w.kb : w.kb;
  mbar_expect_tx(bar, kBoxBytes);
  if (r >= kpart)
    tma_load_box(dst, map_v, bar, 64 * (w.vb0 + r - kpart), w.h, key, w.b);
  else if (w.stream_q && r % 2 == 0)
    tma_load_box(dst, map_q, bar, 64 * (r / 2), w.h, w.row0, w.b);
  else
    tma_load_box(dst, map_k, bar, 64 * (w.stream_q ? r / 2 : r), w.h, key, w.b);
}

// The producer (one lane of a warp of its own, so that no consumer runs its
// branches while products are in flight) starts the stream's box copies in order,
// each once its slot has been left by every consumer warp. It cannot
// deadlock: a warpgroup holds (has waited for and not yet left) at most two
// Q/K boxes, or V boxes of one tile of the slab (eight at most), all within
// `kWideMinRing` of the box it waits for, so the box that slot last held has
// been left.
__device__ __forceinline__ void wide_produce(const WideStream& w, const CUtensorMap* map_q,
                                             const CUtensorMap* map_k, const CUtensorMap* map_v) {
  for (int i = 0, slot = 0, round = 0, tile = 0, r = 0; i < w.total; ++i) {
    if (round > 0) mbar_wait(w.empty + 8 * slot, (round - 1) & 1);
    wide_load(w, map_q, map_k, map_v, slot, tile, r);
    if (++slot == w.ring) {
      slot = 0;
      ++round;
    }
    if (++r == w.per_tile) {
      r = 0;
      ++tile;
    }
  }
}

// A box of the stream as a consumer finds it: its ring slot and the parity
// of its round there (the phase its full barrier completes)
struct RingPos {
  int slot;
  int phase;
};

// the box n boxes on in the stream, for 0 <= n <= ring (at most one wrap; the
// consumers step by at most the eight V boxes of a slab, and the ring holds
// at least `kWideMinRing` = 8): carried forward by a select, no division
static_assert(kWideMinRing >= kWideSlabBoxes, "a consumer's step must not wrap the ring twice");

__device__ __forceinline__ RingPos ring_add(const WideStream& w, RingPos p, int n) {
  const int slot = p.slot + n;
  const bool wrap = slot >= w.ring;
  return {wrap ? slot - w.ring : slot, p.phase ^ static_cast<int>(wrap)};
}

__device__ __forceinline__ void wide_wait(const WideStream& w, RingPos p) {
  mbar_wait(w.full + 8 * p.slot, p.phase);
}

__device__ __forceinline__ uint32_t wide_box(const WideStream& w, RingPos p) {
  return w.ring_base + p.slot * kBoxBytes;
}

// this warp leaves box p: lane 0 arrives for the warp, by a predicate and
// not a branch (a branch that only some lanes take, while products are in
// flight, makes `ptxas` serialise them)
__device__ __forceinline__ void wide_leave(const WideStream& w, RingPos p, int lane) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(w.empty + 8 * p.slot),
      "r"(lane)
      : "memory");
}

// One warpgroup's loop over the kv tiles: S = Q·Kᵀ box by box (each box's four
// k16 products one committed group; a box is left once the next box's group
// is in flight and its own has completed), the online softmax, then O += P·V
// over this warpgroup's `mine` boxes of V (columns from box `off` of the slab),
// whose other boxes it waits for and leaves too. Every warpgroup runs the same
// products in the same order on the same boxes, so its logits, and so its
// running max and sum, equal the other's bit for bit. NB, the products' box
// count, is the same in both warpgroups of a block (`ptxas` serialises the
// products of a code path that only some warps take): where `mine` is one
// less, the last product repeats the warpgroup's last box and is not stored.
template <int NB>
__device__ __forceinline__ void wide_consume(const WideStream& w, int off, int mine, bf16* __restrict__ out,
                                             float* __restrict__ part, int nq, int heads, int dv,
                                             float c, int kv1, int tiles, int splits, int split) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r_lo = w.row0 + warp * 16 + g;
  float o[32 * NB], s[32];
#pragma unroll
  for (int i = 0; i < 32 * NB; ++i) o[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  uint32_t pa[4][4];
  const int step = w.stream_q ? 2 : 1;  // boxes of Q and K a channel box

  // S += Q·K of channel box ch, whose first box in the stream is `p` (Q's
  // where Q streams, then K's; else K's), as one committed group
  auto qk_box = [&](RingPos p, int ch) {
    const RingPos pk = w.stream_q ? ring_add(w, p, 1) : p;
    if (w.stream_q) wide_wait(w, p);
    wide_wait(w, pk);
    const uint32_t qa = w.stream_q ? wide_box(w, p) : w.qs + ch * kBoxBytes, ka = wide_box(w, pk);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 16 channels = 32 bytes along a row
      wgmma_m64n64k16_ss(s, smem_desc(qa + 32 * kk), smem_desc(ka + 32 * kk), ch > 0 || kk > 0);
    wgmma_commit();
  };
  // this warp leaves the K (and Q) boxes of the channel box at `p`
  auto leave_qk = [&](RingPos p) {
    wide_leave(w, w.stream_q ? ring_add(w, p, 1) : p, lane);
    if (w.stream_q) wide_leave(w, p, lane);
  };

  RingPos box = {0, 0};  // the tile's first box in the stream
  for (int j = 0; j < tiles; ++j) {
    RingPos cur = box;  // the channel box's first box
    qk_box(cur, 0);
    for (int ch = 1; ch < w.kb; ++ch) {
      const RingPos prev = cur;
      cur = ring_add(w, cur, step);
      qk_box(cur, ch);
      wgmma_wait<1>();  // box ch - 1's group has completed
      fence_regs(s);
      leave_qk(prev);
    }
    wgmma_wait();
    fence_regs(s);
    leave_qk(cur);
    softmax_step(s, o, pa, m_lo, m_hi, l_lo, l_hi, c, w.kv0 + j * kStep, kv1, t);

    const RingPos vbox = ring_add(w, cur, step);  // the tile's first V box
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int vc = 0; vc < NB; ++vc) {
      const RingPos iv = ring_add(w, vbox, off + min(vc, mine - 1));
      wide_wait(w, iv);
#pragma unroll
      for (int kb2 = 0; kb2 < 4; ++kb2)  // 16 keys = 16 rows of V
        wgmma_m64n64k16<1>(&o[32 * vc], pa[kb2], smem_desc(wide_box(w, iv) + 16 * 128 * kb2), 1);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);
    for (int vc = 0; vc < w.nv; ++vc) {
      const RingPos iv = ring_add(w, vbox, vc);
      if (vc < off || vc >= off + mine) wide_wait(w, iv);  // the other warpgroup's: landed before it is left
      wide_leave(w, iv, lane);
    }
    box = ring_add(w, vbox, w.nv);
  }
  const int col0 = (w.vb0 + off) * 64;
  if (part == nullptr)
    store_rows<bf16, 32 * NB>(o, l_lo, l_hi, out, w.b, w.h, heads, nq, r_lo, t, dv, col0, 32 * mine);
  else
    store_partial<32 * NB>(o, m_lo * c, m_hi * c, l_lo, l_hi, part, splits, split, blockIdx.y, nq, r_lo, t,
                           dv, col0, 32 * mine);
}

// grid (q rows / 64, B·H, kv splits × slabs), 384 threads: two consumer
// warpgroups (the second idle where the slab has one box) and the producer's,
// which gives its registers to them (`setmaxnreg`: 40 a thread for it, 232
// for theirs, of the 168 a thread that 384 threads start with).
constexpr int kWideThreads = 384;

__global__ void __launch_bounds__(kWideThreads, 1)
oneshot_attention_wide_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ out,
                              float* __restrict__ part, int nq, int nk, int heads, int dk, int dv,
                              float c, int kv_split, int slabs, int ring, int stream_q) {
  extern __shared__ uint8_t smem_raw[];
  WideStream w;
  w.qs = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's period
  w.kb = dk / 64;
  w.stream_q = stream_q != 0;
  w.ring = ring;
  w.ring_base = w.qs + (w.stream_q ? 0 : w.kb * kBoxBytes);
  w.full = w.ring_base + ring * kBoxBytes;
  w.empty = w.full + 8 * ring;
  const uint32_t qbar = w.empty + 8 * ring;
  w.b = blockIdx.y / heads;
  w.h = blockIdx.y % heads;
  w.row0 = blockIdx.x * 64;
  const int slab = blockIdx.z % slabs, split = blockIdx.z / slabs;
  w.kv0 = split * kv_split;
  const int kv1 = min(nk, w.kv0 + kv_split);
  const int tiles = (kv1 - w.kv0 + kStep - 1) / kStep;
  w.vb0 = slab * kWideSlabBoxes;
  w.nv = min(kWideSlabBoxes, dv / 64 - w.vb0);
  w.per_tile = (w.stream_q ? 2 * w.kb : w.kb) + w.nv;
  w.total = tiles * w.per_tile;
  const int nb0 = (w.nv + 1) / 2, nb1 = w.nv / 2;  // the two warpgroups' V boxes
  const int groups = nb1 > 0 ? 2 : 1;

  if (threadIdx.x == 0) {
    for (int st = 0; st < ring; ++st) {
      mbar_init(w.full + 8 * st, 1);           // the producer, with the box's bytes
      mbar_init(w.empty + 8 * st, 4 * groups);  // one lane of every warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  // the warpgroup, broadcast from lane 0 so that the compiler knows it is the
  // same in every lane of a warp: the branches on it do not diverge a warp
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {  // the producer's
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      if (!w.stream_q) {
        mbar_expect_tx(qbar, w.kb * kBoxBytes);
        for (int ch = 0; ch < w.kb; ++ch)
          tma_load_box(w.qs + ch * kBoxBytes, &map_q, qbar, 64 * ch, w.h, w.row0, w.b);
      }
      wide_produce(w, &map_q, &map_k, &map_v);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  if (wg >= groups) return;
  if (!w.stream_q) mbar_wait(qbar, 0);
  const int mine = wg == 0 ? nb0 : nb1, off = wg == 0 ? 0 : nb0;
  const int splits = gridDim.z / slabs;
  switch (nb0) {  // the same in every warp of the block
    case 1:
      wide_consume<1>(w, off, mine, out, part, nq, heads, dv, c, kv1, tiles, splits, split);
      break;
    case 2:
      wide_consume<2>(w, off, mine, out, part, nq, heads, dv, c, kv1, tiles, splits, split);
      break;
    case 3:
      wide_consume<3>(w, off, mine, out, part, nq, heads, dv, c, kv1, tiles, splits, split);
      break;
    default:
      wide_consume<4>(w, off, mine, out, part, nq, heads, dv, c, kv1, tiles, splits, split);
      break;
  }
}

// ------------------------------------------------------------ bf16, D = 8, 16, 32
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
// eight different 16-byte bank groups, where unswizzled rows of 32, 64 or 512
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
                             const bf16* __restrict__ v, bf16* __restrict__ out,
                             float* __restrict__ part, int nq, int nk, int heads,
                             long long q_bs, long long q_ts, long long k_bs, long long k_ts,
                             long long v_bs, long long v_ts, float c, int chunk, int kv_split) {
  static_assert(D == 8 || D == 16 || D == 32, "head dim 8, 16 or 32");
  constexpr int kPieces = D / 8, kRowBytes = 2 * D;
  constexpr int kSteps = D == 8 ? 1 : D / 16;  // k-steps of Q·Kᵀ (m16n8k8 at D = 8, else k16)
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t ks = smem_u32(smem_raw), vs = ks + chunk * kRowBytes;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int r_lo = blockIdx.x * kMmaWarps * 16 + warp * 16 + g;
  const int r_hi = r_lo + 8;
  const int kv0 = blockIdx.z * kv_split, kv1 = min(nk, kv0 + kv_split);

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
  const bf16* vb = v + b * v_bs + (long long)h * D;
  for (int c0 = kv0; c0 < kv1; c0 += chunk) {
    const int cnt = min(chunk, kv1 - c0);
    const int rows = (cnt + kStep - 1) / kStep * kStep;  // zero rows fill the last step
    __syncthreads();  // the previous chunk is fully consumed
    for (int i = threadIdx.x; i < rows * kPieces; i += kMmaWarps * 32) {
      const int row = i / kPieces, pc = i % kPieces;
      const bool valid = row < cnt;
      const long long tok = valid ? c0 + row : kv0;
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
      softmax_step(s, o, pa, m_lo, m_hi, l_lo, l_hi, c, c0 + s0, kv1, t);

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
  if (part == nullptr)
    store_rows<bf16, 4 * kPieces>(o, l_lo, l_hi, out, b, h, heads, nq, r_lo, t);
  else
    store_partial<4 * kPieces>(o, m_lo * c, m_hi * c, l_lo, l_hi, part, gridDim.z, blockIdx.z, blockIdx.y,
                               nq, r_lo, t, D, 0);
}

// ------------------------------------------------------------------ launchers
// Lets `Kernel` use `bytes` of dynamic shared memory (above 48 KB it has to be
// asked for), once for each device of the process: the call costs the host
// a few µs, and the attention launches are many and short.
template <auto Kernel>
cudaError_t allow_dynamic_smem(int bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

struct Args {
  const void *q, *k, *v;
  void* out;
  float* work;  // the kv splits' workspace, or null for one split
  int batch, nq, nk, heads, dk, dv;
  long long q_bs, q_ts, k_bs, k_ts, v_bs, v_ts;
  float scale;
  int splits, kv_split;
  cudaStream_t stream;
};

template <int DK, int DV>
cudaError_t launch_f32(const Args& a) {
  using S = F32Shape<DK, DV>;
  constexpr auto kernel = oneshot_attention_tf32x3_kernel<DK, DV>;
  cudaError_t err = allow_dynamic_smem<kernel>(S::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int groups = a.dv / DV;
  const dim3 grid((a.nq + kF32Rows - 1) / kF32Rows, a.batch * a.heads, a.splits * groups);
  kernel<<<grid, kF32Warps * 32, S::kSmemBytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<float*>(a.out), a.splits > 1 ? a.work : nullptr, a.nq, a.nk, a.heads, a.dk, a.dv,
      a.q_bs, a.q_ts, a.k_bs, a.k_ts, a.v_bs, a.v_ts, a.scale * kLog2e, groups, a.kv_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_merge(const Args& a) {
  const long long rows = (long long)a.batch * a.heads * a.nq;
  const long long threads = rows * (a.dv / 4);
  oneshot_attention_merge_kernel<T><<<(unsigned)((threads + 255) / 256), 256, 0, a.stream>>>(
      a.work, static_cast<T*>(a.out), a.splits, a.nq, a.heads, a.dv, rows);
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

// A (D, H, N, B) map over a (B, N, H, D) bf16 tensor with free batch and token
// strides; one box is 64 channels of `rows` tokens of one head, 128-byte
// swizzled, rows past N zero-filled.
bool bhnd_tensor_map(CUtensorMap* map, const void* base, int batch, int n, int heads, int d,
                     long long bs, long long ts, int rows) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)n, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)ts * 2, (cuuint64_t)bs * 2};  // bytes
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1}, elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_wgmma(const Args& a) {
  using W = WgShape<D>;
  constexpr auto kernel = oneshot_attention_wgmma_kernel<D>;
  CUtensorMap map_q = {}, map_k, map_v;  // D = 64 holds Q in registers: no map
  if (!bhnd_tensor_map(&map_k, a.k, a.batch, a.nk, a.heads, D, a.k_bs, a.k_ts, kStep) ||
      !bhnd_tensor_map(&map_v, a.v, a.batch, a.nk, a.heads, D, a.v_bs, a.v_ts, kStep) ||
      (!W::kQRegs &&
       !bhnd_tensor_map(&map_q, a.q, a.batch, a.nq, a.heads, D, a.q_bs, a.q_ts, 64 * W::kGroups)))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_dynamic_smem<kernel>(W::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nq + W::kGroups * 64 - 1) / (W::kGroups * 64), a.batch * a.heads, a.splits);
  kernel<<<grid, W::kThreads, W::kSmemBytes, a.stream>>>(
      map_q, map_k, map_v, static_cast<const bf16*>(a.q), static_cast<bf16*>(a.out),
      a.splits > 1 ? a.work : nullptr, a.nq, a.nk, a.heads, a.q_bs, a.q_ts, a.scale * kLog2e,
      a.kv_split);
  return cudaGetLastError();
}

// The ring's boxes and whether Q streams through it: Q stays resident where
// the ring keeps at least `kWideMinRing` boxes beside it (DK ≤ 1280), and the
// ring takes the rest of the block's shared memory.
void wide_layout(int dk, int* ring, int* stream_q) {
  const int kb = dk / 64;
  *stream_q = (kWideSmemBytes - kWideFixedBytes - kb * kBoxBytes) / kWideBoxCost < kWideMinRing;
  *ring = (kWideSmemBytes - kWideFixedBytes - (*stream_q ? 0 : kb * kBoxBytes)) / kWideBoxCost;
}

cudaError_t launch_wide(const Args& a) {
  constexpr auto kernel = oneshot_attention_wide_kernel;
  CUtensorMap map_q, map_k, map_v;
  if (!bhnd_tensor_map(&map_q, a.q, a.batch, a.nq, a.heads, a.dk, a.q_bs, a.q_ts, 64) ||
      !bhnd_tensor_map(&map_k, a.k, a.batch, a.nk, a.heads, a.dk, a.k_bs, a.k_ts, kStep) ||
      !bhnd_tensor_map(&map_v, a.v, a.batch, a.nk, a.heads, a.dv, a.v_bs, a.v_ts, kStep))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_dynamic_smem<kernel>(kWideSmemBytes);
  if (err != cudaSuccess) return err;
  int ring, stream_q;
  wide_layout(a.dk, &ring, &stream_q);
  const int smem = kWideFixedBytes + (stream_q ? 0 : a.dk / 64 * kBoxBytes) + ring * kWideBoxCost;
  const int slabs = (a.dv / 64 + kWideSlabBoxes - 1) / kWideSlabBoxes;
  const dim3 grid((a.nq + 63) / 64, a.batch * a.heads, a.splits * slabs);
  kernel<<<grid, kWideThreads, smem, a.stream>>>(map_q, map_k, map_v, static_cast<bf16*>(a.out),
                                        a.splits > 1 ? a.work : nullptr, a.nq, a.nk, a.heads, a.dk, a.dv,
                                        a.scale * kLog2e, a.kv_split, slabs, ring, stream_q);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const Args& a) {
  constexpr auto kernel = oneshot_attention_mma_kernel<D>;
  constexpr int kKeyBytes = 4 * D;  // shared memory a key: K and V
  cudaError_t err = allow_dynamic_smem<kernel>(kMmaSmemBytes);
  if (err != cudaSuccess) return err;
  // the whole kv range of a block if it fits, else chunks that fill the
  // budget (a multiple of 64 keys at every D)
  const int range = a.kv_split < a.nk ? a.kv_split : a.nk;
  const int cap = kMmaSmemBytes / kKeyBytes, whole = (range + kStep - 1) / kStep * kStep;
  const int chunk = whole < cap ? whole : cap;
  const dim3 grid((a.nq + kMmaWarps * 16 - 1) / (kMmaWarps * 16), a.batch * a.heads, a.splits);
  kernel<<<grid, kMmaWarps * 32, chunk * kKeyBytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<bf16*>(a.out), a.splits > 1 ? a.work : nullptr, a.nq, a.nk, a.heads, a.q_bs, a.q_ts,
      a.k_bs, a.k_ts, a.v_bs, a.v_ts, a.scale * kLog2e, chunk, a.kv_split);
  return cudaGetLastError();
}

// K1's kernels: the launcher picks one by `k1_kernel` and reports which it
// launched, by its name in `kK1KernelNames`
enum K1Kernel : int {
  kMma8, kMma16, kMma32, kWgmma64, kWgmma128, kWgmma256, kWide,
  kTf32x3_8, kTf32x3_16, kTf32x3_32, kTf32x3_64, kTf32x3_128, kTf32x3_256, kTf32x3Groups,
  kK1Kernels
};
constexpr const char* kK1KernelNames[kK1Kernels] = {
    "oneshot_attention_mma_kernel<8>",          "oneshot_attention_mma_kernel<16>",
    "oneshot_attention_mma_kernel<32>",         "oneshot_attention_wgmma_kernel<64>",
    "oneshot_attention_wgmma_kernel<128>",      "oneshot_attention_wgmma_kernel<256>",
    "oneshot_attention_wide_kernel",            "oneshot_attention_tf32x3_kernel<8, 8>",
    "oneshot_attention_tf32x3_kernel<16, 16>",  "oneshot_attention_tf32x3_kernel<32, 32>",
    "oneshot_attention_tf32x3_kernel<64, 64>",  "oneshot_attention_tf32x3_kernel<128, 128>",
    "oneshot_attention_tf32x3_kernel<256, 256>", "oneshot_attention_tf32x3_kernel<0, 256>"};

// the kernel of head dim dk: above 256 bf16's wide kernel or float32's
// column groups of 256; at an instantiated dk its own; else -1
int k1_kernel(int dk, bool is_bf16) {
  if (dk > 256) return is_bf16 ? kWide : kTf32x3Groups;
  const int dims[6] = {8, 16, 32, 64, 128, 256};
  for (int i = 0; i < 6; ++i)
    if (dk == dims[i]) return (is_bf16 ? kMma8 : kTf32x3_8) + i;
  return -1;
}

cudaError_t launch(const Args& a, int kernel) {
  switch (kernel) {
    case kMma8: return launch_mma<8>(a);
    case kMma16: return launch_mma<16>(a);
    case kMma32: return launch_mma<32>(a);
    case kWgmma64: return launch_wgmma<64>(a);
    case kWgmma128: return launch_wgmma<128>(a);
    case kWgmma256: return launch_wgmma<256>(a);
    case kWide: return launch_wide(a);
    case kTf32x3_8: return launch_f32<8, 8>(a);
    case kTf32x3_16: return launch_f32<16, 16>(a);
    case kTf32x3_32: return launch_f32<32, 32>(a);
    case kTf32x3_64: return launch_f32<64, 64>(a);
    case kTf32x3_128: return launch_f32<128, 128>(a);
    case kTf32x3_256: return launch_f32<256, 256>(a);
    case kTf32x3Groups: return launch_f32<0, kF32GroupCols>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k: (B, N, H, dk), v: (B, Nk, H, dv), with the head and channel dims
// packed (strides d, 1); dk in {8, 16, 32, 64, 128, 256} with dv = dk, or dk a
// multiple of 64 above 256 with dv a multiple of 64 in bf16 (the wide
// kernel's boxes), of 256 in float32 (column groups).
// *_bs / *_ts are the batch and token strides in elements. Pointers must be
// 16-byte aligned, every stride a whole number of 16-byte vectors, and the
// bf16 scale positive (the Python wrapper checks it). out: contiguous
// (B, Nq, H, dv). The kv range runs in `splits` ranges of `kv_split` keys (a
// multiple of 64; none empty); above one split `work` holds splits·B·H·Nq·
// (dv + 2) floats and a second kernel merges them. `device` is the tensors'.
// Returns the cudaError_t of the launches; on success `*kernel` (if not null)
// is the index of the kernel it launched, named by
// `gfnet_oneshot_attention_kernel_name`.
extern "C" int gfnet_oneshot_attention(int device, const void* q, const void* k, const void* v, void* out,
                                       void* work, int batch, int nq, int nk, int heads, int dk,
                                       int dv, long long q_bs, long long q_ts, long long k_bs,
                                       long long k_ts, long long v_bs, long long v_ts,
                                       float scale, int is_bf16, int splits, int kv_split,
                                       void* stream, int* kernel) {
  // The calling thread may have no context current (PyTorch's autograd
  // engine runs a backward, and a recomputed forward, on threads of its
  // own, where a first launch would fail): make the tensors' device, and its
  // primary context, current first.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  if (batch <= 0 || nq <= 0 || nk <= 0 || heads <= 0 || splits <= 0 || kv_split <= 0 ||
      kv_split % kStep || (long long)splits * kv_split < nk || (long long)(splits - 1) * kv_split >= nk ||
      (splits > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  if (dk > 256 ? (dk % 64 || dv % (is_bf16 ? 64 : kF32GroupCols)) : dv != dk) return cudaErrorInvalidValue;
  const Args a{q,     k,    v,    out,  static_cast<float*>(work), batch, nq, nk, heads, dk, dv,
               q_bs,  q_ts, k_bs, k_ts, v_bs, v_ts, scale, splits, kv_split,
               static_cast<cudaStream_t>(stream)};
  const int id = k1_kernel(dk, is_bf16 != 0);
  cudaError_t err = launch(a, id);
  if (err == cudaSuccess && splits > 1) err = is_bf16 ? launch_merge<bf16>(a) : launch_merge<float>(a);
  if (err == cudaSuccess && kernel != nullptr) *kernel = id;
  return err;
}

// the name of K1's kernel of index `kernel`, as `gfnet_oneshot_attention`
// reports it; null out of range
extern "C" const char* gfnet_oneshot_attention_kernel_name(int kernel) {
  return kernel >= 0 && kernel < kK1Kernels ? kK1KernelNames[kernel] : nullptr;
}
