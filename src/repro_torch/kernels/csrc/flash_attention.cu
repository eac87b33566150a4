// Flash-attention forward on Hopper's tensor cores in 3xTF32 (sm_90a), f32
// and bf16 at D = 16, 32, 64, 128; plain C interface for ctypes.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (Pallas body
// `_kernel`) for every call that kernel_for routes here: f32 at every head
// dim (the f32 whole-path parities, the train parity's forward, the execute
// bench's 50-token ViT) and bf16 at D 16/32 (the CLI's reduced ViT). bf16 at
// D 64/128 goes to csrc/flash_attention_mma.cu; this entry takes it too.
//
// Semantics (identical to the Pallas kernel for every row that has at least
// one unmasked key):
//   q, k, v [B, H, S, D] contiguous, f32 or bf16, each 16-byte aligned;
//   scale 1/sqrt(D); scores, running (m, l) and the accumulator in f32;
//   optional additive per-key bias [B, Sk] f32 clamped at max(bias, -1e30);
//   optional kv_len [B] int32 (keys at or past it masked); optional
//   bottom-right causal mask (qpos + (Sk - Sq) >= kpos); masked scores are
//   -1e30; the output is acc / max(l, 1e-30) cast to q's dtype. Key tiles
//   past min(Sk, kv_len) or past the causal frontier of the block's last
//   query are skipped: their keys are masked for every row of the block. A
//   row whose every key is masked (its running max never rises above
//   0.5 * -1e30) outputs 0; the Pallas kernel returns an average of V there
//   and its jnp oracle NaN, and such rows never occur on the main path.
//   Scores are kept in log2 units (scale and bias times log2 e), so exp2f
//   does the exponentials.
//   lse (nullable, [B, H, Sq] f32): each row's log-sum-exp of its scaled,
//   clamped-bias, masked scores in natural units, (m + log2 l) * ln 2, for
//   the backward (csrc/flash_attention_bwd.cu); +inf for a row with no
//   unmasked key, so that the backward's exp(s - lse) is 0 there. The output
//   does not depend on it.
//
// Arithmetic: 3xTF32 on mma.sync.m16n8k8 (what PyTorch's memory-efficient
// SDPA does for f32). Each f32 operand x is split into hi = tf32(x) and
// lo = tf32(x - hi), and a.b ~ lo_a.hi_b + hi_a.lo_b + hi_a.hi_b: every
// product keeps ~21 mantissa bits (one TF32 term alone breaks the f32
// limits, atol 2e-5 / rtol 1e-4 against the f32 plain version,
// tests/test_torch_flash_tf32.py). The tensor cores round each mma's sum
// (its products and its accumulator) toward zero, so a sum kept in an
// mma's accumulator across a long contraction (P.V over 577 keys is 216
// mmas) drifts toward zero, and the error of every output of a row leans
// the same way: several times the error of sequential f32 FFMAs at the
// reference's shape, enough to break the f32 train parity's gradient
// limit (PERF.md). So P.V
// sums each k-step's terms from zero and adds them to the f32 accumulator
// with one f32 add, which rounds to nearest (mma3_add); S = Q.K^T, over
// the head dim (at most 48 mmas), keeps its sum in the accumulator (mma3),
// which saves an add an element and the registers of the step's sum.
// tf32() is cvt.rna.tf32.f32's rounding (to nearest, ties away from zero)
// in two integer operations: cvt.rna itself compiles to a longer sequence
// with NaN checks, which made the f32 D = 64 instantiation 5080 SASS
// instructions against 4112 and 1.22x slower at [1, 16, 577, 64] on an
// H100 (the same outputs). A bf16 value
// is exact in TF32 (lo = 0), so with bf16 inputs Q.K^T is one mma and P.V
// two (P stays f32).
//
// What bounds it on the H100: at the reference's [1, 16, 577, 64] f32 call
// the work is 4*B*H*S^2*D = 1.36 GFLOP: 20 us at the 67 TFLOP/s f32
// CUDA-core peak (the bound kernel_bench states), 8.3 us for the three
// TF32 passes at the 495 TFLOP/s TF32 peak; q, k, v, o move 8.5 MB (2.5
// us). So the operations bound it, and on the tensor cores what limits
// mma.sync is the work around it: the hi/lo splits of every K and V
// element a warp reads (five integer and float operations an element, two
// elements a three-mma step), the shared-memory fragment loads and the
// softmax.
//
// Design (FlashAttention-2 on mma.sync, as csrc/flash_attention_mma.cu):
//   - one block of 4 warps per (b*h, 64-query tile), each warp owns 16
//     query rows; under causal the query tiles run heaviest first. 64 rows
//     on 4 warps, not 32 on 2: the reference's [1, 16, 577, 64] then has
//     160 blocks, 592 live warps over the 132 SMs' 528 schedulers (more
//     than one wave of warps), and each K/V tile in shared memory feeds 4
//     warps; a warp with no query row (the 577th row's tile) copies but
//     skips the products.
//   - K/V tiles of BK keys (64; 32 at D = 128) stream through a 2-stage ring
//     in dynamic shared memory with cp.async 16-byte copies (commit/wait
//     groups), so tile t+1 is in flight while tile t computes; key rows
//     past min(Sk, kv_len) are zero-filled, never read. The tile's bias
//     rides in the same group. Tiles stay in the input dtype; a fragment
//     is converted (bf16) and split (f32) as it is loaded. 87.6 KB at f32
//     D = 64, so two blocks share an SM; BK = 32 keeps D = 128 at 101.6 KB
//     and two blocks too.
//   - fragment loads are free of bank conflicts by the row stride: f32 rows
//     are D + 4 floats (scalar loads at (row g, column t) and (rows 2t,
//     2t + 1, column g) hit 32 banks); bf16 rows are 2W elements with
//     W = 4 mod 16 words (pairs of adjacent elements at (row g, word t)).
//     The contraction over d takes its elements in any order that A and B
//     share: f32 fragments pair columns t and t + 4 of each 8, bf16 ones
//     2t and 2t + 1.
//   - Q is copied once; at D <= 32 its fragments are split once into
//     registers, at D >= 64 they are loaded and split per k-step: held
//     there, they spilled beside the O accumulators and P.V's step sums.
//   - __launch_bounds__(THREADS, 1) lets ptxas use up to 255 registers a
//     thread, which two blocks of 128 threads still fit in an SM's 64K;
//     with the block size alone it held some instantiations at 128 and
//     spilled (PERF.md).
//   - S = Q.K^T into 16 x BK f32 accumulators a warp; the epilogue scales,
//     adds the clamped bias, masks (element by element only on tiles that
//     hold a masked key of some row of the block) and runs the online
//     softmax per row, reducing max and sum over each quad by shuffles.
//   - O += P.V straight from the S accumulators: the m16n8k8 accumulator
//     gives a thread keys (2t, 2t + 1) of each 8, the TF32 A fragment wants
//     (t, t + 4). P is not shuffled: the key index of the step is permuted
//     instead, the B fragment's rows t and t + 4 reading V rows 2t and
//     2t + 1 of the 8-key step. O stays in f32 registers (D/2 a thread).
//   - a leading tile masked for some row but not for the block leaves that
//     row's m at -1e30, so exp(s - m) = 1 fills l and O with junk: the first
//     real key scales it by exp2(-1e30 - m) = 0, and a row that never sees
//     one outputs 0.
// Out of scope here: wgmma (no TF32 split there without an f32 pass of its
// own), TMA, warp specialisation, persistent blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // query rows per block
constexpr int STAGES = 2;       // K/V ring depth
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

// a bf16 value is exact in TF32: its lo terms are dropped
template <typename T> __host__ __device__ constexpr bool exact_tf32() {
  return sizeof(T) == 2;
}

// row stride, in elements, of a [rows][D] tile of T in shared memory (see
// the header: conflict-free fragment loads, rows of whole 16-byte chunks)
template <typename T, int D> __host__ __device__ constexpr int row_stride() {
  if (sizeof(T) == 4) return D + 4;
  int w = D / 2;
  while (w % 16 != 4) ++w;
  return 2 * w;
}

template <typename T, int D>
struct Layout {
  static constexpr int BK = D > 64 ? 32 : 64;  // keys per tile
  static constexpr int LD = row_stride<T, D>();
  static constexpr int Q_ELEMS = BQ * LD;
  static constexpr int TILE = BK * LD;         // one K or V tile
  static constexpr size_t BYTES =
      (size_t)(Q_ELEMS + 2 * STAGES * TILE) * sizeof(T) + STAGES * BK * sizeof(float);
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

// the two elements of `row` that k-step kk gives fragment index t and t + 4
// (A's columns, B's rows): f32 columns t and t + 4 of the 8, bf16 2t and
// 2t + 1 (one 4-byte load)
__device__ __forceinline__ void ld_pair(const float* row, int kk, int t, float& x0, float& x1) {
  x0 = row[kk * 8 + t];
  x1 = row[kk * 8 + t + 4];
}
__device__ __forceinline__ void ld_pair(const bf16* row, int kk, int t, float& x0, float& x1) {
  const __nv_bfloat162 w = *reinterpret_cast<const __nv_bfloat162*>(row + kk * 8 + 2 * t);
  x0 = __low2float(w);
  x1 = __high2float(w);
}

// A fragment (16 rows x 8 of the d contraction, k-step kk) of the 16 rows at
// `rows` (stride LD), split
template <bool EXACT, int LD, typename T>
__device__ __forceinline__ void frag_a(const T* rows, int kk, int g, int t, uint32_t (&h)[4],
                                       uint32_t (&l)[4]) {
  float x[4];
  ld_pair(rows + g * LD, kk, t, x[0], x[2]);        // a0 (row g), a2 (row g, col + 4)
  ld_pair(rows + (g + 8) * LD, kk, t, x[1], x[3]);  // a1, a3 (row g + 8)
#pragma unroll
  for (int i = 0; i < 4; ++i) split<EXACT>(x[i], h[i], l[i]);
}

// B fragment of a d contraction: column g is row `n0 + g` of the tile
template <bool EXACT, int LD, typename T>
__device__ __forceinline__ void frag_b_rows(const T* tile, int n0, int kk, int g, int t,
                                            uint32_t (&h)[2], uint32_t (&l)[2]) {
  float y0, y1;
  ld_pair(tile + (n0 + g) * LD, kk, t, y0, y1);
  split<EXACT>(y0, h[0], l[0]);
  split<EXACT>(y1, h[1], l[1]);
}

// B fragment of a contraction over the tile's rows (8-row step j0), with the
// rows permuted to match an A fragment taken from accumulators: index t is
// row j0 + 2t, index t + 4 row j0 + 2t + 1; column g is column c0 + g
template <bool EXACT, int LD, typename T>
__device__ __forceinline__ void frag_b_cols(const T* tile, int j0, int c0, int g, int t,
                                            uint32_t (&h)[2], uint32_t (&l)[2]) {
  split<EXACT>(to_f(tile[(j0 + 2 * t) * LD + c0 + g]), h[0], l[0]);
  split<EXACT>(to_f(tile[(j0 + 2 * t + 1) * LD + c0 + g]), h[1], l[1]);
}

// the A fragment of the rows' 8-column step nb taken from accumulators c
// (row g: columns 2t, 2t + 1; row g + 8 likewise), in frag_b_cols' order
template <bool EXACT>
__device__ __forceinline__ void frag_a_acc(const float (&c)[4], uint32_t (&h)[4],
                                           uint32_t (&l)[4]) {
  split<EXACT>(c[0], h[0], l[0]);  // row g, index t
  split<EXACT>(c[2], h[1], l[1]);  // row g + 8, index t
  split<EXACT>(c[1], h[2], l[2]);  // row g, index t + 4
  split<EXACT>(c[3], h[3], l[3]);  // row g + 8, index t + 4
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, const int* __restrict__ kv_len,
                 T* __restrict__ out, float* __restrict__ lse, int H, int Sq, int Sk,
                 int causal, float scale_log2) {
  using L = Layout<T, D>;
  constexpr int LD = L::LD, BK = L::BK;
  constexpr int NB = BK / 8;                    // n-blocks of S (8 keys each)
  constexpr int KS = D / 8;                     // k-steps of Q.K^T
  constexpr int DB = D / 8;                     // n-blocks of O (8 columns each)
  constexpr int CH = D * (int)sizeof(T) / 16;   // 16-byte chunks a row
  constexpr int EPC = 16 / (int)sizeof(T);      // elements a chunk
  constexpr bool EX = exact_tf32<T>();
  constexpr bool QREG = D <= 32;                // Q's fragments held in registers
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);           // [BQ][LD]
  T* ks = qs + L::Q_ELEMS;                      // [STAGES][BK][LD]
  T* vs = ks + STAGES * L::TILE;                // [STAGES][BK][LD]
  float* bsm = reinterpret_cast<float*>(vs + STAGES * L::TILE);  // [STAGES][BK]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = (causal ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.y) * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group, thread in quad
  const int shift = Sk - Sq;               // bottom-right causal alignment
  const int row0 = q0 + warp * 16 + g;     // this thread's rows: row0, row0 + 8
  const bool live = q0 + warp * 16 < Sq;   // the warp has a query row
  const T* qw = qs + warp * 16 * LD;       // the warp's Q rows

  const T* kg = k + (size_t)bh * Sk * D;
  const T* vg = v + (size_t)bh * Sk * D;
  const float* bg = bias != nullptr ? bias + (size_t)b * Sk : nullptr;

  int kend = Sk;
  if (kv_len != nullptr) kend = min(kend, max(kv_len[b], 0));
  int tile_end = kend;
  if (causal) tile_end = min(tile_end, max(min(q0 + BQ, Sq) + shift, 0));
  const int n_tiles = (tile_end + BK - 1) / BK;

  auto load_tile = [&](int tile) {
    const int t0 = tile * BK, st = tile % STAGES;
#pragma unroll
    for (int i = 0; i < BK * CH / THREADS; ++i) {
      const int c = tid + i * THREADS, r = c / CH, col = (c % CH) * EPC;
      const bool ok = t0 + r < kend;
      const size_t off = ok ? (size_t)(t0 + r) * D + col : 0;
      cp_async16(smem_u32(ks + st * L::TILE + r * LD + col), kg + off, ok);
      cp_async16(smem_u32(vs + st * L::TILE + r * LD + col), vg + off, ok);
    }
    if (tid < BK) {
      const bool ok = bg != nullptr && t0 + tid < Sk;
      cp_async4(smem_u32(bsm + st * BK + tid), ok ? bg + t0 + tid : (const float*)kg, ok);
    }
  };

  // prologue: Q (rows past Sq zero) with tile 0 in group 0, tile 1 in group 1
#pragma unroll
  for (int i = 0; i < BQ * CH / THREADS; ++i) {
    const int c = tid + i * THREADS, r = c / CH, col = (c % CH) * EPC;
    const bool ok = q0 + r < Sq;
    const size_t off = ok ? ((size_t)bh * Sq + q0 + r) * D + col : 0;
    cp_async16(smem_u32(qs + r * LD + col), q + off, ok);
  }
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();
  if (n_tiles > 1) load_tile(1);
  cp_async_commit();

  cp_async_wait<1>();  // group 0: Q and tile 0
  __syncthreads();
  uint32_t qh[QREG ? KS : 1][4], ql[QREG ? KS : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) frag_a<EX, LD>(qw, kk, g, t4, qh[kk], ql[kk]);
  }
  float o[DB][4];
#pragma unroll
  for (int db = 0; db < DB; ++db) o[db][0] = o[db][1] = o[db][2] = o[db][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // rows row0 and row0 + 8

#pragma unroll 1
  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<1>();  // group `tile` has landed
    __syncthreads();
    if (live) {
      const int st = tile % STAGES;
      const T* kt = ks + st * L::TILE;
      const T* vt = vs + st * L::TILE;
      const float* bt = bsm + st * BK;

      // S = Q.K^T: 16 rows x BK keys a warp
      float s[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ah[4], al[4];
        if constexpr (QREG) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ah[i] = qh[kk][i];
            al[i] = ql[kk][i];
          }
        } else {
          frag_a<EX, LD>(qw, kk, g, t4, ah, al);
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          uint32_t bh2[2], bl2[2];
          frag_b_rows<EX, LD>(kt, nb * 8, kk, g, t4, bh2, bl2);
          mma3<EX, EX>(s[nb], ah, al, bh2, bl2);
        }
      }

      // scale, bias, mask; online softmax in log2 units
      const int t0 = tile * BK;
      const bool edge = t0 + BK > kend || (causal && t0 + BK - 1 > q0 + shift);
      float mx0 = NEG, mx1 = NEG;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = nb * 8 + 2 * t4 + (e & 1);
          float x = fmaf(s[nb][e], scale_log2, fmaxf(bt[kl], NEG) * LOG2E);
          if (edge) {
            const int kpos = t0 + kl;
            const int qpos = row0 + (e >> 1) * 8;
            if (kpos >= kend || (causal && kpos > qpos + shift)) x = NEG;
          }
          s[nb][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        s[nb][0] = exp2f(s[nb][0] - mn0);
        s[nb][1] = exp2f(s[nb][1] - mn0);
        s[nb][2] = exp2f(s[nb][2] - mn1);
        s[nb][3] = exp2f(s[nb][3] - mn1);
        ps0 += s[nb][0] + s[nb][1];
        ps1 += s[nb][2] + s[nb][3];
      }
      l0 = l0 * a0 + ps0;
      l1 = l1 * a1 + ps1;
#pragma unroll
      for (int db = 0; db < DB; ++db) {
        o[db][0] *= a0;
        o[db][1] *= a0;
        o[db][2] *= a1;
        o[db][3] *= a1;
      }

      // O += P.V, P (f32) straight from the accumulators
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        uint32_t ph[4], pl[4];
        frag_a_acc<false>(s[nb], ph, pl);
#pragma unroll
        for (int db = 0; db < DB; ++db) {
          uint32_t bh2[2], bl2[2];
          frag_b_cols<EX, LD>(vt, nb * 8, db * 8, g, t4, bh2, bl2);
          mma3_add<false, EX>(o[db], ph, pl, bh2, bl2);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (tile + STAGES < n_tiles) load_tile(tile + STAGES);
    cp_async_commit();
  }
  cp_async_wait<0>();
  if (!live) return;

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const bool any0 = m0 > 0.5f * NEG, any1 = m1 > 0.5f * NEG;
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  if (lse != nullptr && t4 == 0) {
    if (row0 < Sq) lse[(size_t)bh * Sq + row0] = any0 ? (m0 + log2f(d0)) * LN2 : INFINITY;
    if (row0 + 8 < Sq) lse[(size_t)bh * Sq + row0 + 8] = any1 ? (m1 + log2f(d1)) * LN2 : INFINITY;
  }
  T* o0 = out + ((size_t)bh * Sq + row0) * D + 2 * t4;
  T* o1 = o0 + 8 * D;
#pragma unroll
  for (int db = 0; db < DB; ++db) {
    if (row0 < Sq)
      store2(o0 + db * 8, any0 ? o[db][0] / d0 : 0.f, any0 ? o[db][1] / d0 : 0.f);
    if (row0 + 8 < Sq)
      store2(o1 + db * 8, any1 ? o[db][2] / d1 : 0.f, any1 ? o[db][3] / d1 : 0.f);
  }
}

template <typename T, int D>
cudaError_t prepare() {
  // once per instantiation: the dynamic shared memory above 48 KB
  static const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Layout<T, D>::BYTES);
  return err;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* bias, const int* kv_len,
           void* out, float* lse, int B, int H, int Sq, int Sk, int causal,
           cudaStream_t stream) {
  const int n_q_tiles = (Sq + BQ - 1) / BQ;
  if (n_q_tiles > 65535) return (int)cudaErrorInvalidValue;
  const cudaError_t err = prepare<T, D>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, n_q_tiles);
  const float scale_log2 = LOG2E / sqrtf((float)D);
  flash_fwd_kernel<T, D><<<grid, THREADS, Layout<T, D>::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      kv_len, static_cast<T*>(out), lse, H, Sq, Sk, causal, scale_log2);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int occupancy(int* smem_bytes, int* blocks_per_sm) {
  const cudaError_t err = prepare<T, D>();
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = (int)Layout<T, D>::BYTES;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, flash_fwd_kernel<T, D>, THREADS, Layout<T, D>::BYTES);
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const float* bias,
               const int* kv_len, void* out, float* lse, int B, int H, int Sq, int Sk,
               int D, int causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, bias, kv_len, out, lse, B, H, Sq, Sk, causal,
                                  stream);
    case 32: return launch<T, 32>(q, k, v, bias, kv_len, out, lse, B, H, Sq, Sk, causal,
                                  stream);
    case 64: return launch<T, 64>(q, k, v, bias, kv_len, out, lse, B, H, Sq, Sk, causal,
                                  stream);
    case 128: return launch<T, 128>(q, k, v, bias, kv_len, out, lse, B, H, Sq, Sk, causal,
                                    stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int occupancy_d(int D, int* smem_bytes, int* blocks_per_sm) {
  switch (D) {
    case 16: return occupancy<T, 16>(smem_bytes, blocks_per_sm);
    case 32: return occupancy<T, 32>(smem_bytes, blocks_per_sm);
    case 64: return occupancy<T, 64>(smem_bytes, blocks_per_sm);
    case 128: return occupancy<T, 128>(smem_bytes, blocks_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. bias / kv_len / lse may be null; q, k, v
// 16-byte aligned. Returns the cudaGetLastError() of the launch (0 on
// success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const float* bias, const int* kv_len, void* out,
                                   float* lse, int B, int H, int Sq, int Sk, int D,
                                   int dtype, int causal, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, bias, kv_len, out, lse, B, H, Sq, Sk, D, causal, s);
  if (dtype == 1)
    return dispatch_d<bf16>(q, k, v, bias, kv_len, out, lse, B, H, Sq, Sk, D, causal, s);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory of the instantiation for (D, dtype) and the
// blocks of it an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
// Returns the CUDA error (0 on success).
extern "C" int flash_attention_fwd_occupancy(int D, int dtype, int* smem_bytes,
                                             int* blocks_per_sm) {
  if (dtype == 0) return occupancy_d<float>(D, smem_bytes, blocks_per_sm);
  if (dtype == 1) return occupancy_d<bf16>(D, smem_bytes, blocks_per_sm);
  return (int)cudaErrorInvalidValue;
}
