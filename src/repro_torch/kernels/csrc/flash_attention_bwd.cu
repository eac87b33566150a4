// Flash-attention backward on Hopper's tensor cores in 3xTF32 (sm_90a), f32
// and bf16 at D = 16, 32, 64, 128; plain C interface for ctypes.
//
// Replaces: no TPU kernel. The reference trains through the jnp
// `layers.sdpa`, which XLA differentiates; this is the gradient of
// csrc/flash_attention.cu (src/repro/kernels/flash_attention.py::
// flash_attention's port in 3xTF32), for the calls that kernel serves: f32
// at D 16/32/64/128 (the f32 train parity) and bf16 at D 16/32.
//
// Semantics (those of ref.flash_attention_bwd_ref): q, k, v, out, dout
// [B, H, S, D] contiguous, f32 or bf16, each 16-byte aligned; lse [B, H, Sq]
// f32, the forward's natural-unit log-sum-exp (+inf on a row with no
// unmasked key); optional bias [B, Sk] f32 clamped at -1e30, kv_len [B]
// int32, bottom-right causal mask, as the forward. With
// s = q.k / sqrt(D) + bias:
//   P = exp(s - lse) (0 where masked), D_i = rowsum(dO * O) in f32,
//   dP = dO.V^T in f32, dS = P * (dP - D_i),
//   dV = P^T.dO, dQ = dS.K / sqrt(D), dK = dS^T.Q / sqrt(D).
// Rounding points: S and dP are f32 sums of 3xTF32 products of the inputs;
// in bf16, P and dS are rounded to bf16 (nearest even) before the products
// that give dV, dQ and dK, and the gradients are rounded once. dbias_part
// (nullable, [B, H, Sk] f32) gets each key's sum over queries of the
// unrounded f32 dS; the wrapper sums it over H. A key no query sees (past
// min(Sk, kv_len)) gets dK = dV = 0, written; so does a whole key tile past
// it. Exponentials are exp2f of log2-unit scores (scale, bias and lse times
// log2 e).
//
// Arithmetic: 3xTF32 on mma.sync.m16n8k8, as the forward (its header):
// each f32 operand split into hi = tf32(x) and lo = tf32(x - hi) (tf32()
// is cvt.rna's rounding by integer operations), a.b ~
// lo_a.hi_b + hi_a.lo_b + hi_a.hi_b, the small terms first. The tensor
// cores round each mma's sum toward zero (the forward's header), and dV and
// dK each sum over every query row, dQ over every key: those three sum each
// k-step's terms from zero and add them to the f32 accumulator with one f32
// add, to nearest (mma3_add); S and dP, over the head dim, keep their sums
// in the accumulator (mma3). That holds the f32 limit
// (1e-4 of max|g| against the plain backward and against autograd of the
// plain forward; one TF32 term alone breaks it,
// tests/test_torch_flash_tf32.py). A bf16 value is exact in
// TF32, so with bf16 inputs every product is one mma (P and dS rounded to
// bf16 first).
//
// What bounds it on the H100: five products of 2*D FLOPs a (query, key)
// pair; at f32 [4, 16, 577, 64] that is 13.6 GFLOP, 0.20 ms at the 67
// TFLOP/s f32 CUDA-core peak (the bound kernel_bench states), 0.083 ms for
// the three TF32 passes at the 495 TFLOP/s TF32 peak, over 76 MB (23 us at
// 3.35 TB/s): the operations bound it. This design does seven products (S
// and dP are recomputed in the dQ pass) on mma.sync, and around each of
// them loads and splits the operands a warp reads from shared memory (five
// integer and float operations an element, two elements a three-mma step).
//
// Design: FlashAttention-2's backward in two passes with no atomics, so the
// gradient is the same bit for bit from run to run, on the forward's
// machinery (its header: 4 warps of 16 rows, cp.async rings in dynamic
// shared memory, conflict-free row strides, fragments converted and split
// as they are loaded, the accumulator-to-A-fragment key permutation):
//   1. dQ pass: one block of 4 warps per (b*h, 64-query tile), heaviest
//      first under causal. Its prologue takes D_i = rowsum(dO * O) of its
//      rows (two threads a row) and writes it to `rowsum` for pass 2. Q and
//      dO stay in shared memory; K/V tiles of BK keys (32 at D >= 64, 64
//      below) stream through a 2-stage ring up to the block's causal
//      frontier and kv_len. Per tile: S = Q.K^T and dP = dO.V^T, P and dS in the
//      accumulator layout, dS (rounded to the input dtype) straight into A
//      fragments, dQ += dS.K with K's rows permuted as the forward's V.
//   2. dK/dV pass: one block of 4 warps per (b*h, 64-key tile); K and V stay
//      in shared memory, Q/dO tiles of BK queries (with their lse and D_i)
//      stream through the ring from the key tile's causal frontier on. Per
//      tile, transposed: S^T = K.Q^T, P^T, dV += P^T.dO, dP^T = V.dO^T,
//      dS^T and the dbias sums, dK += dS^T.Q. dK and dV stay in f32
//      registers (D floats a thread). Each warp owns 16 keys, so a key's
//      dbias sum is reduced over its quad by shuffles in a fixed order and
//      no sum crosses warps.
//   The resident tiles' fragments are loaded and split per k-step: held in
//   registers as hi/lo they would take 2D registers a thread beside the
//   accumulators. Masks apply element by element only on tiles that hold a
//   masked pair. Streamed tiles of 32 rows at D >= 64, which halve the
//   ring and the score tiles (at f32 D = 64 a block takes 70 KB of shared
//   memory); at D = 16, 64-row tiles ran faster (PERF.md), and D = 32
//   keeps them too. 135 KB at f32 D = 128 (one block an SM).
//   __launch_bounds__(THREADS, 1) on both passes lets ptxas use up to 255
//   registers a thread (two blocks of 128 threads still fit an SM): the
//   f32 D = 64 backward ran faster than under the block size alone, and
//   the D = 128 dK/dV pass stopped spilling (PERF.md).
// Out of scope here: wgmma, TMA, warp specialisation, persistent blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BR = 16 * WARPS;  // resident rows a block (queries in pass 1, keys in 2)
constexpr int STAGES = 2;       // ring depth
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

template <typename T> __host__ __device__ constexpr bool exact_tf32() {
  return sizeof(T) == 2;
}

// row stride, in elements, of a [rows][D] tile of T in shared memory: f32
// D + 4 floats (scalar fragment loads at (row g, column t) and at (rows 2t,
// 2t + 1, column g) hit 32 banks), bf16 2W elements with W = 4 mod 16 words
// (pairs at (row g, word t), and rows 2t, 2t + 1); whole 16-byte chunks
template <typename T, int D> __host__ __device__ constexpr int row_stride() {
  if (sizeof(T) == 4) return D + 4;
  int w = D / 2;
  while (w % 16 != 4) ++w;
  return 2 * w;
}

template <typename T, int D>
struct Layout {
  static constexpr int BS = D >= 64 ? 32 : 64;  // streamed rows a tile
  static constexpr int LD = row_stride<T, D>();
  static constexpr int RES = BR * LD;          // one resident tile
  static constexpr int TILE = BS * LD;         // one streamed tile
  // two resident tiles (Q, dO; K, V), a ring of two streamed tiles a stage,
  // and the per-row vectors: dQ pass the bias ring and D_i, dK/dV pass the
  // lse and D_i rings
  static constexpr size_t DQ_BYTES = (size_t)(2 * RES + 2 * STAGES * TILE) * sizeof(T) +
                                     (STAGES * BS + BR) * sizeof(float);
  static constexpr size_t DKDV_BYTES =
      (size_t)(2 * RES + 2 * STAGES * TILE) * sizeof(T) + 2 * STAGES * BS * sizeof(float);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with valid == false the destination is zero-filled
// and nothing is read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// x as the products of dV, dQ and dK take it: rounded to T
template <typename T> __device__ __forceinline__ float rounded(float x);
template <> __device__ __forceinline__ float rounded<float>(float x) { return x; }
template <> __device__ __forceinline__ float rounded<bf16>(float x) {
  return __bfloat162float(__float2bfloat16(x));  // nearest even, as torch's .to(bfloat16)
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: cvt.rna.tf32.f32's rounding of a finite x, by integer operations on
// the bits (the sign bit is apart, so adding half an ulp rounds the
// magnitude). cvt.rna itself compiles to a longer sequence that also
// handles NaN.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo in TF32; an exact x is its own hi (lo unused)
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (EXACT) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
  }
}

// c += a (16x8, row) . b (8x8, col), TF32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b in 3xTF32, the small terms first, in c itself: each mma rounds
// its sum toward zero into c. For the products over the head dim (at most
// 48 mmas an element). A term whose lo operand is exactly 0 is dropped.
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if constexpr (!A_EXACT) mma_tf32(c, al, bh[0], bh[1]);
  if constexpr (!B_EXACT) mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

// c += a.b as mma3, but the terms are summed by the tensor cores from zero
// and then added to c with one f32 add (to nearest). For the products over
// keys or queries, whose sums run over a whole row: kept in c, the mmas'
// rounding toward zero would lean every sum the same way (the header).
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma3_add(float (&c)[4], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                         const uint32_t (&bl)[2]) {
  float f[4] = {0.f, 0.f, 0.f, 0.f};
  mma3<A_EXACT, B_EXACT>(f, ah, al, bh, bl);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += f[i];
}

// the two elements of `row` that k-step kk gives fragment index t and t + 4:
// f32 columns t and t + 4 of the 8, bf16 2t and 2t + 1 (one 4-byte load)
__device__ __forceinline__ void ld_pair(const float* row, int kk, int t, float& x0, float& x1) {
  x0 = row[kk * 8 + t];
  x1 = row[kk * 8 + t + 4];
}
__device__ __forceinline__ void ld_pair(const bf16* row, int kk, int t, float& x0, float& x1) {
  const __nv_bfloat162 w = *reinterpret_cast<const __nv_bfloat162*>(row + kk * 8 + 2 * t);
  x0 = __low2float(w);
  x1 = __high2float(w);
}

// acc (16 rows x 8*NB columns a warp) = A.B^T over d: A the 16 rows at
// `rows`, B the 8*NB rows of `tile`, both [.][LD] of T with D columns
template <typename T, int D, int NB>
__device__ __forceinline__ void rows_dot_rows(float (&acc)[NB][4], const T* rows, const T* tile,
                                              int g, int t) {
  constexpr int LD = row_stride<T, D>();
  constexpr bool EX = exact_tf32<T>();
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    float x[4];
    uint32_t ah[4], al[4];
    ld_pair(rows + g * LD, kk, t, x[0], x[2]);
    ld_pair(rows + (g + 8) * LD, kk, t, x[1], x[3]);
#pragma unroll
    for (int i = 0; i < 4; ++i) split<EX>(x[i], ah[i], al[i]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      float y0, y1;
      uint32_t bh[2], bl[2];
      ld_pair(tile + (nb * 8 + g) * LD, kk, t, y0, y1);
      split<EX>(y0, bh[0], bl[0]);
      split<EX>(y1, bh[1], bl[1]);
      mma3<EX, EX>(acc[nb], ah, al, bh, bl);
    }
  }
}

// acc (16 rows x D a warp) += A.B over the tile's 8*NB rows: A the f32
// accumulators `x` (16 x 8*NB), already rounded to T, B the rows of `tile`.
// The accumulator gives a thread columns (2t, 2t + 1) of each 8, the A
// fragment wants (t, t + 4): B's rows are permuted instead, index t reading
// row 2t and index t + 4 row 2t + 1 of the 8-row step.
template <typename T, int D, int NB>
__device__ __forceinline__ void frags_dot_tile(float (&acc)[D / 8][4], const float (&x)[NB][4],
                                               const T* tile, int g, int t) {
  constexpr int LD = row_stride<T, D>();
  constexpr bool EX = exact_tf32<T>();
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    uint32_t ah[4], al[4];
    split<EX>(x[nb][0], ah[0], al[0]);  // row g, index t
    split<EX>(x[nb][2], ah[1], al[1]);  // row g + 8, index t
    split<EX>(x[nb][1], ah[2], al[2]);  // row g, index t + 4
    split<EX>(x[nb][3], ah[3], al[3]);  // row g + 8, index t + 4
    const T* r0 = tile + (nb * 8 + 2 * t) * LD + g;
#pragma unroll
    for (int db = 0; db < D / 8; ++db) {
      uint32_t bh[2], bl[2];
      split<EX>(to_f(r0[db * 8]), bh[0], bl[0]);
      split<EX>(to_f(r0[LD + db * 8]), bh[1], bl[1]);
      mma3_add<EX, EX>(acc[db], ah, al, bh, bl);
    }
  }
}

// rows [r0, r0 + R) of a [S, D] slab into dst[R][LD]; rows at or past `end`
// zero-filled (not read)
template <typename T, int D, int R>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, int r0, int end, int tid) {
  constexpr int LD = row_stride<T, D>();
  constexpr int CH = D * (int)sizeof(T) / 16, EPC = 16 / (int)sizeof(T);
#pragma unroll
  for (int i = 0; i < R * CH / THREADS; ++i) {
    const int c = tid + i * THREADS, r = c / CH, col = (c % CH) * EPC;
    const bool ok = r0 + r < end;
    cp_async16(smem_u32(dst + r * LD + col), src + (ok ? (size_t)(r0 + r) * D + col : 0), ok);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the warp's 16 rows x D of f32 accumulators, times `mul`, as rows
// [row0, row0 + 16) of `dst` ([S, D]) for the rows before S
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[D / 8][4], float mul,
                                           int row0, int S, int g, int t) {
  T* r0 = dst + (size_t)(row0 + g) * D + 2 * t;
  T* r1 = r0 + 8 * D;
#pragma unroll
  for (int db = 0; db < D / 8; ++db) {
    if (row0 + g < S) store2(r0 + db * 8, acc[db][0] * mul, acc[db][1] * mul);
    if (row0 + g + 8 < S) store2(r1 + db * 8, acc[db][2] * mul, acc[db][3] * mul);
  }
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// pass 1: dQ, and rowsum(dO * O) for pass 2
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ out, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ bias,
                    const int* __restrict__ kv_len, T* __restrict__ dq,
                    float* __restrict__ rowsum, int H, int Sq, int Sk, int causal,
                    float scale_log2, float scale) {
  using L = Layout<T, D>;
  constexpr int LD = L::LD, BK = L::BS, NB = BK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);                             // [BR][LD]
  T* dos = qs + L::RES;                                           // [BR][LD]
  T* ks = dos + L::RES;                                           // [STAGES][BK][LD]
  T* vs = ks + STAGES * L::TILE;                                  // [STAGES][BK][LD]
  float* bsm = reinterpret_cast<float*>(vs + STAGES * L::TILE);  // [STAGES][BK]
  float* dds = bsm + STAGES * BK;                                 // [BR] rowsum

  const int bh = blockIdx.x, b = bh / H;
  const int q0 = (causal ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.y) * BR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int shift = Sk - Sq;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const bool live = q0 + warp * 16 < Sq;
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Sk * D;
  const T* kg = k + koff;
  const T* vg = v + koff;
  const float* bg = bias != nullptr ? bias + (size_t)b * Sk : nullptr;

  int kend = Sk;
  if (kv_len != nullptr) kend = min(kend, max(kv_len[b], 0));
  int tile_end = kend;
  if (causal) tile_end = min(tile_end, max(min(q0 + BR, Sq) + shift, 0));
  const int n_tiles = (tile_end + BK - 1) / BK;

  auto load_tile = [&](int tile) {
    const int t0 = tile * BK, st = tile % STAGES;
    copy_tile<T, D, BK>(ks + st * L::TILE, kg, t0, kend, tid);
    copy_tile<T, D, BK>(vs + st * L::TILE, vg, t0, kend, tid);
    if (tid < BK) {
      const bool ok = bg != nullptr && t0 + tid < Sk;
      cp_async4(smem_u32(bsm + st * BK + tid), ok ? bg + t0 + tid : (const float*)kg, ok);
    }
  };

  // prologue: Q and dO with tile 0 in group 0, tile 1 in group 1
  copy_tile<T, D, BR>(qs, q + qoff, q0, Sq, tid);
  copy_tile<T, D, BR>(dos, dout + qoff, q0, Sq, tid);
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();
  if (n_tiles > 1) load_tile(1);
  cp_async_commit();

  // rowsum(dO * O) of the block's rows, two threads a row, while copies fly
  {
    const int r = tid >> 1, half = tid & 1, qr = q0 + r;
    float acc = 0.f;
    if (qr < Sq) {
      const size_t off = qoff + (size_t)qr * D + half * (D / 2);
#pragma unroll 8
      for (int c = 0; c < D / 2; ++c) acc = fmaf(to_f(dout[off + c]), to_f(out[off + c]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      dds[r] = acc;
      if (qr < Sq) rowsum[(size_t)bh * Sq + qr] = acc;
    }
  }
  const float ls0 = row0 < Sq ? lse[(size_t)bh * Sq + row0] * LOG2E : INFINITY;
  const float ls1 = row0 + 8 < Sq ? lse[(size_t)bh * Sq + row0 + 8] * LOG2E : INFINITY;
  cp_async_wait<1>();
  __syncthreads();
  const float dd0 = dds[warp * 16 + g], dd1 = dds[warp * 16 + g + 8];
  const T* qw = qs + warp * 16 * LD;
  const T* dow = dos + warp * 16 * LD;

  float acc[D / 8][4];
#pragma unroll
  for (int db = 0; db < D / 8; ++db) acc[db][0] = acc[db][1] = acc[db][2] = acc[db][3] = 0.f;

#pragma unroll 1
  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<1>();  // group `tile` has landed
    __syncthreads();
    if (live) {
      const int st = tile % STAGES, t0 = tile * BK;
      const T* kt = ks + st * L::TILE;
      const T* vt = vs + st * L::TILE;
      const float* bt = bsm + st * BK;

      float s[NB][4], dp[NB][4];
      rows_dot_rows<T, D, NB>(s, qw, kt, g, t4);    // S = Q.K^T
      rows_dot_rows<T, D, NB>(dp, dow, vt, g, t4);  // dP = dO.V^T
      const bool edge = t0 + BK > kend || (causal && t0 + BK - 1 > q0 + shift);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = nb * 8 + 2 * t4 + (e & 1);
          float p = exp2f(fmaf(s[nb][e], scale_log2, fmaxf(bt[kl], NEG) * LOG2E) -
                          (e < 2 ? ls0 : ls1));
          if (edge) {
            const int kpos = t0 + kl, qpos = row0 + (e >> 1) * 8;
            if (kpos >= kend || (causal && kpos > qpos + shift)) p = 0.f;
          }
          dp[nb][e] = rounded<T>(p * (dp[nb][e] - (e < 2 ? dd0 : dd1)));  // dS
        }
      }
      frags_dot_tile<T, D, NB>(acc, dp, kt, g, t4);  // dQ += dS.K
    }
    __syncthreads();  // every warp is done with this stage
    if (tile + STAGES < n_tiles) load_tile(tile + STAGES);
    cp_async_commit();
  }
  cp_async_wait<0>();
  if (live) store_rows<T, D>(dq + qoff, acc, scale, q0 + warp * 16, Sq, g, t4);
}

// pass 2: dK, dV and the per-head dbias sums
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ rowsum,
                      const float* __restrict__ bias, const int* __restrict__ kv_len,
                      T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dbias_part,
                      int H, int Sq, int Sk, int causal, float scale_log2, float scale) {
  using L = Layout<T, D>;
  constexpr int LD = L::LD, BQ = L::BS, NB = BQ / 8;
  constexpr int CH = D * (int)sizeof(T) / 16, EPC = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                              // [BR][LD]
  T* vs = ks + L::RES;                                             // [BR][LD]
  T* qs = vs + L::RES;                                             // [STAGES][BQ][LD]
  T* dos = qs + STAGES * L::TILE;                                  // [STAGES][BQ][LD]
  float* lsm = reinterpret_cast<float*>(dos + STAGES * L::TILE);  // [STAGES][BQ] lse
  float* rsm = lsm + STAGES * BQ;                                  // [STAGES][BQ] rowsum

  const int bh = blockIdx.x, b = bh / H;
  const int k0 = blockIdx.y * BR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int shift = Sk - Sq;
  const int kr0 = k0 + warp * 16 + g;  // this thread's key rows: kr0, kr0 + 8
  const bool live = k0 + warp * 16 < Sk;
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Sk * D;

  int kend = Sk;
  if (kv_len != nullptr) kend = min(kend, max(kv_len[b], 0));
  if (k0 >= kend) {  // no query sees a key of this tile: zeros
#pragma unroll
    for (int i = 0; i < BR * CH / THREADS; ++i) {
      const int c = tid + i * THREADS, r = c / CH, col = (c % CH) * EPC;
      if (k0 + r < Sk) {
        *reinterpret_cast<uint4*>(dk + koff + (size_t)(k0 + r) * D + col) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(dv + koff + (size_t)(k0 + r) * D + col) = make_uint4(0, 0, 0, 0);
      }
    }
    if (dbias_part != nullptr && tid < BR && k0 + tid < Sk)
      dbias_part[(size_t)bh * Sk + k0 + tid] = 0.f;
    return;
  }
  const int q_begin = causal ? max(k0 - shift, 0) : 0;  // < Sq, as k0 < kend <= Sk
  const int qt_begin = q_begin / BQ;
  const int n_tiles = (Sq + BQ - 1) / BQ - qt_begin;
  const float kb0 = (bias != nullptr && kr0 < Sk) ? fmaxf(bias[(size_t)b * Sk + kr0], NEG) * LOG2E
                                                  : 0.f;
  const float kb1 = (bias != nullptr && kr0 + 8 < Sk)
                        ? fmaxf(bias[(size_t)b * Sk + kr0 + 8], NEG) * LOG2E : 0.f;

  auto load_tile = [&](int i) {
    const int t0 = (qt_begin + i) * BQ, st = i % STAGES;
    copy_tile<T, D, BQ>(qs + st * L::TILE, q + qoff, t0, Sq, tid);
    copy_tile<T, D, BQ>(dos + st * L::TILE, dout + qoff, t0, Sq, tid);
    if (tid < BQ) {
      const bool ok = t0 + tid < Sq;
      const size_t off = ok ? (size_t)bh * Sq + t0 + tid : 0;
      cp_async4(smem_u32(lsm + st * BQ + tid), lse + off, ok);
    } else if (tid < 2 * BQ) {
      const int j = tid - BQ;
      const bool ok = t0 + j < Sq;
      const size_t off = ok ? (size_t)bh * Sq + t0 + j : 0;
      cp_async4(smem_u32(rsm + st * BQ + j), rowsum + off, ok);
    }
  };

  // prologue: K and V with query tile 0 in group 0, query tile 1 in group 1
  copy_tile<T, D, BR>(ks, k + koff, k0, kend, tid);
  copy_tile<T, D, BR>(vs, v + koff, k0, kend, tid);
  load_tile(0);
  cp_async_commit();
  if (n_tiles > 1) load_tile(1);
  cp_async_commit();

  float gk[D / 8][4], gv[D / 8][4];
#pragma unroll
  for (int db = 0; db < D / 8; ++db) {
    gk[db][0] = gk[db][1] = gk[db][2] = gk[db][3] = 0.f;
    gv[db][0] = gv[db][1] = gv[db][2] = gv[db][3] = 0.f;
  }
  float db0 = 0.f, db1 = 0.f;
  const T* kw = ks + warp * 16 * LD;
  const T* vw = vs + warp * 16 * LD;

#pragma unroll 1
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<1>();  // group `i` has landed
    __syncthreads();
    if (live) {
      const int st = i % STAGES, t0 = (qt_begin + i) * BQ;
      const T* qt = qs + st * L::TILE;
      const T* dot = dos + st * L::TILE;
      const float* lt = lsm + st * BQ;
      const float* rt = rsm + st * BQ;
      // a masked pair in the tile: a query past Sq, a key past kend, or
      // (causal) a key of the tile past the frontier of the tile's first query
      const bool edge = t0 + BQ > Sq || k0 + BR > kend || (causal && k0 + BR - 1 > t0 + shift);

      float s[NB][4];
      rows_dot_rows<T, D, NB>(s, kw, qt, g, t4);  // S^T = K.Q^T
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = nb * 8 + 2 * t4 + (e & 1);
          float p = exp2f(fmaf(s[nb][e], scale_log2, e < 2 ? kb0 : kb1) - lt[ql] * LOG2E);
          if (edge) {
            const int kpos = kr0 + (e >> 1) * 8, qpos = t0 + ql;
            if (qpos >= Sq || kpos >= kend || (causal && kpos > qpos + shift)) p = 0.f;
          }
          s[nb][e] = p;  // P^T
        }
      }
      {
        float pr[NB][4];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) pr[nb][e] = rounded<T>(s[nb][e]);
        frags_dot_tile<T, D, NB>(gv, pr, dot, g, t4);  // dV += P^T.dO
      }
      float dp[NB][4];
      rows_dot_rows<T, D, NB>(dp, vw, dot, g, t4);  // dP^T = V.dO^T
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = nb * 8 + 2 * t4 + (e & 1);
          const float ds = s[nb][e] * (dp[nb][e] - rt[ql]);  // dS^T
          if (e < 2) db0 += ds; else db1 += ds;
          dp[nb][e] = rounded<T>(ds);
        }
      }
      frags_dot_tile<T, D, NB>(gk, dp, qt, g, t4);  // dK += dS^T.Q
    }
    __syncthreads();  // every warp is done with this stage
    if (i + STAGES < n_tiles) load_tile(i + STAGES);
    cp_async_commit();
  }
  cp_async_wait<0>();
  if (!live) return;
  store_rows<T, D>(dk + koff, gk, scale, k0 + warp * 16, Sk, g, t4);
  store_rows<T, D>(dv + koff, gv, 1.f, k0 + warp * 16, Sk, g, t4);
  db0 = quad_sum(db0);
  db1 = quad_sum(db1);
  if (dbias_part != nullptr && t4 == 0) {
    if (kr0 < Sk) dbias_part[(size_t)bh * Sk + kr0] = db0;
    if (kr0 + 8 < Sk) dbias_part[(size_t)bh * Sk + kr0 + 8] = db1;
  }
}

template <typename T, int D>
cudaError_t prepare() {
  // once per instantiation: the dynamic shared memory above 48 KB
  static const cudaError_t err = [] {
    const cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)Layout<T, D>::DQ_BYTES);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)Layout<T, D>::DKDV_BYTES);
  }();
  return err;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, const float* bias, const int* kv_len, void* dq, void* dk,
           void* dv, float* dbias_part, float* rowsum, int B, int H, int Sq, int Sk,
           int causal, cudaStream_t stream) {
  using L = Layout<T, D>;
  const int n_q_tiles = (Sq + BR - 1) / BR, n_k_tiles = (Sk + BR - 1) / BR;
  if (n_q_tiles > 65535 || n_k_tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare<T, D>();
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.0f / sqrtf((float)D), scale_log2 = LOG2E * scale;
  flash_bwd_dq_kernel<T, D><<<dim3(B * H, n_q_tiles), THREADS, L::DQ_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(out), static_cast<const T*>(dout), lse, bias, kv_len,
      static_cast<T*>(dq), rowsum, H, Sq, Sk, causal, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<T, D><<<dim3(B * H, n_k_tiles), THREADS, L::DKDV_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, rowsum, bias, kv_len, static_cast<T*>(dk),
      static_cast<T*>(dv), dbias_part, H, Sq, Sk, causal, scale_log2, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int occupancy(int pass, int* smem_bytes, int* blocks_per_sm) {
  using L = Layout<T, D>;
  const cudaError_t err = prepare<T, D>();
  if (err != cudaSuccess) return (int)err;
  if (pass == 0) {
    *smem_bytes = (int)L::DQ_BYTES;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, flash_bwd_dq_kernel<T, D>, THREADS, L::DQ_BYTES);
  }
  *smem_bytes = (int)L::DKDV_BYTES;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, flash_bwd_dkdv_kernel<T, D>, THREADS, L::DKDV_BYTES);
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const float* lse, const float* bias, const int* kv_len, void* dq, void* dk,
               void* dv, float* dbias_part, float* rowsum, int B, int H, int Sq, int Sk,
               int D, int causal, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, dout, lse, bias, kv_len, dq, dk, dv,
                                  dbias_part, rowsum, B, H, Sq, Sk, causal, s);
    case 32: return launch<T, 32>(q, k, v, out, dout, lse, bias, kv_len, dq, dk, dv,
                                  dbias_part, rowsum, B, H, Sq, Sk, causal, s);
    case 64: return launch<T, 64>(q, k, v, out, dout, lse, bias, kv_len, dq, dk, dv,
                                  dbias_part, rowsum, B, H, Sq, Sk, causal, s);
    case 128: return launch<T, 128>(q, k, v, out, dout, lse, bias, kv_len, dq, dk, dv,
                                    dbias_part, rowsum, B, H, Sq, Sk, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int occupancy_d(int D, int pass, int* smem_bytes, int* blocks_per_sm) {
  switch (D) {
    case 16: return occupancy<T, 16>(pass, smem_bytes, blocks_per_sm);
    case 32: return occupancy<T, 32>(pass, smem_bytes, blocks_per_sm);
    case 64: return occupancy<T, 64>(pass, smem_bytes, blocks_per_sm);
    case 128: return occupancy<T, 128>(pass, smem_bytes, blocks_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. bias / kv_len / dbias_part may be null;
// q, k, v, out, dout 16-byte aligned; rowsum is [B, H, Sq] f32 scratch,
// written by the dQ pass and read by the dK/dV pass. Launches both passes;
// returns the first cudaGetLastError() that is not 0 (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* dout, const float* lse,
                                   const float* bias, const int* kv_len, void* dq, void* dk,
                                   void* dv, float* dbias_part, float* rowsum, int B, int H,
                                   int Sq, int Sk, int D, int dtype, int causal, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, out, dout, lse, bias, kv_len, dq, dk, dv, dbias_part,
                             rowsum, B, H, Sq, Sk, D, causal, s);
  if (dtype == 1)
    return dispatch_d<bf16>(q, k, v, out, dout, lse, bias, kv_len, dq, dk, dv, dbias_part,
                            rowsum, B, H, Sq, Sk, D, causal, s);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory of one pass (0: dQ, 1: dK/dV) of the
// instantiation for (D, dtype) and the blocks of it an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns the CUDA error
// (0 on success).
extern "C" int flash_attention_bwd_occupancy(int D, int dtype, int pass, int* smem_bytes,
                                             int* blocks_per_sm) {
  if (dtype == 0) return occupancy_d<float>(D, pass, smem_bytes, blocks_per_sm);
  if (dtype == 1) return occupancy_d<bf16>(D, pass, smem_bytes, blocks_per_sm);
  return (int)cudaErrorInvalidValue;
}
