// Flash-attention backward on Hopper's tensor cores (sm_90a), bf16 at D = 64
// and 128; plain C interface for ctypes.
//
// Replaces: no TPU kernel. The reference trains through the jnp
// `layers.sdpa`, which XLA differentiates; this is the gradient of
// csrc/flash_attention_mma.cu (src/repro/kernels/flash_attention.py::
// flash_attention's port on the tensor cores), for every bf16 call at those
// head dims: each training step of vit-l16 cls_384 (D=64), the LM train
// shapes (D=128, causal), dit and flux. f32 and D in {16, 32} go to
// csrc/flash_attention_bwd.cu (CUDA-core f32 math).
//
// Semantics (those of ref.flash_attention_bwd_ref): q, k, v, out, dout
// [B, H, S, D] contiguous bf16, each 16-byte aligned; lse [B, H, Sq] f32, the
// forward's natural-unit log-sum-exp (+inf on a row with no unmasked key);
// optional bias [B, Sk] f32 clamped at -1e30, kv_len [B] int32 and the
// bottom-right causal mask, as the forward. With s = q.k / sqrt(D) + bias:
//   P = exp(s - lse) (0 where masked), D_i = rowsum(dO * O) in f32,
//   dP = dO.V^T in f32, dS = P * (dP - D_i),
//   dV = P^T.dO, dQ = dS.K / sqrt(D), dK = dS^T.Q / sqrt(D).
// Rounding points are the plain version's: S and dP are f32 sums of exact
// bf16 products (mma.sync bf16 -> f32); P and dS are rounded to bf16 (nearest
// even) as the A operands of the products that give dV, dQ and dK; the
// gradients are f32 in registers and rounded once. Exponentials are exp2f of
// log2-unit scores (scale, bias and lse times log2 e). dbias_part (nullable,
// [B, H, Sk] f32) gets each key's sum over queries of the unrounded f32 dS;
// the wrapper sums it over H. A key no query sees (past min(Sk, kv_len))
// gets dK = dV = 0, written; so does a whole key tile past it.
//
// What bounds it on the H100: five products of 2*D FLOPs a (query, key)
// pair. At the vit-l16 train call [32, 16, 577, 64] that is 109 GFLOP (110
// us at the 989 TFLOP/s bf16 tensor-core peak) over 304 MB (q, k, v, out,
// dout and the f32 lse read, dq, dk, dv written; 91 us at 3.35 TB/s):
// operations bound it. This design does seven products (S and dP are
// recomputed in the dQ pass) on mma.sync, which does not reach the wgmma
// peak.
//
// Design: FlashAttention-2's backward on the forward's machinery (ldmatrix /
// ldmatrix.trans fragments, a 2-stage cp.async ring, rows padded by 16 bytes
// so that the 8 row addresses of one ldmatrix fall in 8 bank groups), in two
// passes with no atomics, so the gradient is the same bit for bit from run to
// run (FA2's atomicAdd of dQ is not used; the recompute is the price):
//   1. dQ pass: one block of 4 warps per (b*h, 64-query tile), each warp 16
//      query rows; under causal the query tiles run heaviest first. Its
//      prologue takes D_i = rowsum(dO * O) of its rows (two threads a row,
//      16-byte loads) and writes it to `rowsum` for pass 2. Q and dO stay in
//      shared memory; K/V tiles of 64 keys stream through the ring up to the
//      block's causal frontier and kv_len. Per tile: S = Q.K^T and
//      dP = dO.V^T (ldmatrix of K and V rows), P and dS in the accumulator
//      layout, dS rounded to bf16 straight into A fragments, dQ += dS.K
//      (K by ldmatrix.trans). dQ stays in f32 registers.
//   2. dK/dV pass: one block of 4 warps per (b*h, 64-key tile), each warp 16
//      key rows; K and V stay in shared memory, Q/dO tiles of 64 queries
//      (with their lse and D_i) stream through the ring from the key tile's
//      causal frontier on. Per tile, transposed: S^T = K.Q^T, P^T, then
//      dV += P^T.dO (dO by ldmatrix.trans), dP^T = V.dO^T, dS^T and the
//      dbias sums, dK += dS^T.Q (Q by ldmatrix.trans). dK and dV stay in f32
//      registers (D floats a thread) and leave through the warp's own K/V
//      rows of shared memory in 16-byte stores.
//   Masks apply element by element only on tiles that hold a masked pair.
// Out of scope here: wgmma, TMA, warp specialisation, persistent blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // query rows per tile
constexpr int BK = 16 * WARPS;  // key rows per tile
constexpr int STAGES = 2;       // ring depth
constexpr int NB = 64 / 8;      // n-blocks (8 columns) of a 64-wide score tile
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int LD = D + 8;      // padded row, in bf16 elements
  static constexpr int TILE = 64 * LD;  // one 64-row tile
  // two resident tiles (dQ pass: Q, dO; dK/dV pass: K, V), a ring of two
  // streamed tiles a stage, and STAGES x 64 floats of each per-row vector
  static constexpr size_t DQ_BYTES =
      (size_t)(2 + 2 * STAGES) * TILE * sizeof(__nv_bfloat16) + (STAGES + 1) * 64 * sizeof(float);
  static constexpr size_t DKDV_BYTES =
      (size_t)(2 + 2 * STAGES) * TILE * sizeof(__nv_bfloat16) + 2 * STAGES * 64 * sizeof(float);
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

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// c += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16 (round to nearest even), lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// acc (16 rows x 64 columns per warp) = A.B^T: A the warp's 16 rows of `a`,
// B the 64 rows of `b`, both [64][LD] row-major with D columns
template <int D>
__device__ __forceinline__ void rows_dot_rows(float (&acc)[NB][4], const __nv_bfloat16* a,
                                              const __nv_bfloat16* b, int warp, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(smem_u32(a + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8), af);
#pragma unroll
    for (int jp = 0; jp < NB / 2; ++jp) {
      uint32_t r[4];
      ldsm_x4(smem_u32(b + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                       ((lane >> 3) & 1) * 8), r);
      mma_bf16(acc[2 * jp], af, r[0], r[1]);
      mma_bf16(acc[2 * jp + 1], af, r[2], r[3]);
    }
  }
}

// acc (16 rows x D per warp) += A.B: A the warp's 16 x 64 fragments `af`
// (rounded scores), B the 64 rows of `b` ([64][LD], D columns), by
// ldmatrix.trans
template <int D>
__device__ __forceinline__ void frags_dot_tile(float (&acc)[D / 8][4],
                                               const uint32_t (&af)[NB / 2][4],
                                               const __nv_bfloat16* b, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t r[4];
      ldsm_x4_trans(smem_u32(b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                             dp * 16 + (lane >> 4) * 8), r);
      mma_bf16(acc[2 * dp], af[kk], r[0], r[1]);
      mma_bf16(acc[2 * dp + 1], af[kk], r[2], r[3]);
    }
  }
}

// the accumulator layout's 16 x 64 floats as bf16 A fragments, 16 columns each
__device__ __forceinline__ void to_frags(uint32_t (&f)[NB / 2][4], const float (&x)[NB][4]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    f[nb >> 1][(nb & 1) * 2] = pack_bf16(x[nb][0], x[nb][1]);
    f[nb >> 1][(nb & 1) * 2 + 1] = pack_bf16(x[nb][2], x[nb][3]);
  }
}

// rows [r0, r0 + 64) of a [S, D] slab into dst[64][LD]; rows at or past `end`
// zero-filled (not read)
template <int D>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int r0, int end, int tid) {
  constexpr int LD = D + 8, CH = D / 8;
#pragma unroll
  for (int i = 0; i < 64 * CH / THREADS; ++i) {
    const int c = tid + i * THREADS, r = c / CH, col = (c % CH) * 8;
    const bool ok = r0 + r < end;
    cp_async16(smem_u32(dst + r * LD + col), src + (ok ? (size_t)(r0 + r) * D + col : 0), ok);
  }
}

// the warp's 16 rows x D of f32 accumulators, times `mul`, as bf16 rows
// [row0, row0 + 16) of `dst` ([S, D]) for the rows before S; staged through
// the warp's own rows `stage` of a [64][LD] tile
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&acc)[D / 8][4],
                                           float mul, __nv_bfloat16* stage, int row0, int S,
                                           int lane) {
  constexpr int LD = D + 8, CH = D / 8;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int db = 0; db < D / 8; ++db) {
    const int col = db * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(stage + g * LD + col) =
        __floats2bfloat162_rn(acc[db][0] * mul, acc[db][1] * mul);
    *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * LD + col) =
        __floats2bfloat162_rn(acc[db][2] * mul, acc[db][3] * mul);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * CH / 32; ++i) {
    const int c = lane + i * 32, r = c / CH, col = (c % CH) * 8;
    if (row0 + r < S)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * D + col) =
          *reinterpret_cast<const uint4*>(stage + r * LD + col);
  }
}

// pass 1: dQ, and rowsum(dO * O) for pass 2
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_mma_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ out,
                        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ bias, const int* __restrict__ kv_len,
                        __nv_bfloat16* __restrict__ dq, float* __restrict__ rowsum, int H,
                        int Sq, int Sk, int causal, float scale_log2, float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [64][LD]
  __nv_bfloat16* dos = qs + L::TILE;                             // [64][LD]
  __nv_bfloat16* ks = dos + L::TILE;                             // [STAGES][64][LD]
  __nv_bfloat16* vs = ks + STAGES * L::TILE;                     // [STAGES][64][LD]
  float* bsm = reinterpret_cast<float*>(vs + STAGES * L::TILE);  // [STAGES][64]
  float* dds = bsm + STAGES * BK;                                // [64] rowsum

  const int bh = blockIdx.x, b = bh / H;
  const int q0 = (causal ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.y) * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int shift = Sk - Sq;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Sk * D;
  const __nv_bfloat16* kg = k + koff;
  const __nv_bfloat16* vg = v + koff;
  const float* bg = bias != nullptr ? bias + (size_t)b * Sk : nullptr;

  int kend = Sk;
  if (kv_len != nullptr) kend = min(kend, max(kv_len[b], 0));
  int tile_end = kend;
  if (causal) tile_end = min(tile_end, max(min(q0 + BQ, Sq) + shift, 0));
  const int n_tiles = (tile_end + BK - 1) / BK;

  auto load_tile = [&](int tile) {
    const int t0 = tile * BK, st = tile % STAGES;
    copy_tile<D>(ks + st * L::TILE, kg, t0, kend, tid);
    copy_tile<D>(vs + st * L::TILE, vg, t0, kend, tid);
    if (tid < BK) {
      const bool ok = bg != nullptr && t0 + tid < Sk;
      cp_async4(smem_u32(bsm + st * BK + tid), ok ? bg + t0 + tid : (const float*)kg, ok);
    }
  };

  // prologue: Q and dO with tile 0 in group 0, tile 1 in group 1
  copy_tile<D>(qs, q + qoff, q0, Sq, tid);
  copy_tile<D>(dos, dout + qoff, q0, Sq, tid);
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
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(out + off + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(dout + off + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 of = __bfloat1622float2(o2[i]), df = __bfloat1622float2(d2[i]);
          acc = fmaf(df.x, of.x, fmaf(df.y, of.y, acc));
        }
      }
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

  float acc[D / 8][4];
#pragma unroll
  for (int db = 0; db < D / 8; ++db) acc[db][0] = acc[db][1] = acc[db][2] = acc[db][3] = 0.f;

#pragma unroll 1
  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<1>();  // group `tile` has landed
    __syncthreads();
    const int st = tile % STAGES, t0 = tile * BK;
    const __nv_bfloat16* kt = ks + st * L::TILE;
    const __nv_bfloat16* vt = vs + st * L::TILE;
    const float* bt = bsm + st * BK;

    float s[NB][4], dp[NB][4];
    rows_dot_rows<D>(s, qs, kt, warp, lane);   // S = Q.K^T
    rows_dot_rows<D>(dp, dos, vt, warp, lane); // dP = dO.V^T
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
        dp[nb][e] = p * (dp[nb][e] - (e < 2 ? dd0 : dd1));  // dS
      }
    }
    uint32_t dsf[NB / 2][4];
    to_frags(dsf, dp);
    frags_dot_tile<D>(acc, dsf, kt, lane);  // dQ += dS.K

    __syncthreads();  // every warp is done with this stage
    if (tile + STAGES < n_tiles) load_tile(tile + STAGES);
    cp_async_commit();
  }

  cp_async_wait<0>();
  __syncthreads();  // no copy into the shared tiles is pending (n_tiles may be 0)
  store_rows<D>(dq + qoff, acc, scale, qs + warp * 16 * L::LD, q0 + warp * 16, Sq, lane);
}

// pass 2: dK, dV and the per-head dbias sums
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_mma_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ rowsum, const float* __restrict__ bias,
                          const int* __restrict__ kv_len, __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, float* __restrict__ dbias_part, int H,
                          int Sq, int Sk, int causal, float scale_log2, float scale) {
  using L = Layout<D>;
  constexpr int CH = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [64][LD]
  __nv_bfloat16* vs = ks + L::TILE;                              // [64][LD]
  __nv_bfloat16* qs = vs + L::TILE;                              // [STAGES][64][LD]
  __nv_bfloat16* dos = qs + STAGES * L::TILE;                    // [STAGES][64][LD]
  float* lsm = reinterpret_cast<float*>(dos + STAGES * L::TILE); // [STAGES][64] lse
  float* rsm = lsm + STAGES * BQ;                                // [STAGES][64] rowsum

  const int bh = blockIdx.x, b = bh / H;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int shift = Sk - Sq;
  const int kr0 = k0 + warp * 16 + g;  // this thread's key rows: kr0, kr0 + 8
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Sk * D;

  int kend = Sk;
  if (kv_len != nullptr) kend = min(kend, max(kv_len[b], 0));
  if (k0 >= kend) {  // no query sees a key of this tile: zeros
#pragma unroll
    for (int i = 0; i < 64 * CH / THREADS; ++i) {
      const int c = tid + i * THREADS, r = c / CH, col = (c % CH) * 8;
      if (k0 + r < Sk) {
        *reinterpret_cast<uint4*>(dk + koff + (size_t)(k0 + r) * D + col) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(dv + koff + (size_t)(k0 + r) * D + col) = make_uint4(0, 0, 0, 0);
      }
    }
    if (dbias_part != nullptr && tid < BK && k0 + tid < Sk)
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
    copy_tile<D>(qs + st * L::TILE, q + qoff, t0, Sq, tid);
    copy_tile<D>(dos + st * L::TILE, dout + qoff, t0, Sq, tid);
    if (tid < BQ) {
      const bool ok = t0 + tid < Sq;
      const size_t off = ok ? (size_t)bh * Sq + t0 + tid : 0;
      cp_async4(smem_u32(lsm + st * BQ + tid), lse + off, ok);
    } else {
      const int j = tid - BQ;
      const bool ok = t0 + j < Sq;
      const size_t off = ok ? (size_t)bh * Sq + t0 + j : 0;
      cp_async4(smem_u32(rsm + st * BQ + j), rowsum + off, ok);
    }
  };

  // prologue: K and V with query tile 0 in group 0, query tile 1 in group 1
  copy_tile<D>(ks, k + koff, k0, kend, tid);
  copy_tile<D>(vs, v + koff, k0, kend, tid);
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

#pragma unroll 1
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<1>();  // group `i` has landed
    __syncthreads();
    const int st = i % STAGES, t0 = (qt_begin + i) * BQ;
    const __nv_bfloat16* qt = qs + st * L::TILE;
    const __nv_bfloat16* dot = dos + st * L::TILE;
    const float* lt = lsm + st * BQ;
    const float* rt = rsm + st * BQ;
    // a masked pair in the tile: a query past Sq, a key past kend, or (causal)
    // a key of the tile past the frontier of the tile's first query
    const bool edge = t0 + BQ > Sq || k0 + BK > kend || (causal && k0 + BK - 1 > t0 + shift);

    float s[NB][4];
    rows_dot_rows<D>(s, ks, qt, warp, lane);  // S^T = K.Q^T
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
      uint32_t pf[NB / 2][4];
      to_frags(pf, s);
      frags_dot_tile<D>(gv, pf, dot, lane);  // dV += P^T.dO
    }
    float dp[NB][4];
    rows_dot_rows<D>(dp, vs, dot, warp, lane);  // dP^T = V.dO^T
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nb * 8 + 2 * t4 + (e & 1);
        const float ds = s[nb][e] * (dp[nb][e] - rt[ql]);  // dS^T
        dp[nb][e] = ds;
        if (e < 2) db0 += ds; else db1 += ds;
      }
    }
    {
      uint32_t dsf[NB / 2][4];
      to_frags(dsf, dp);
      frags_dot_tile<D>(gk, dsf, qt, lane);  // dK += dS^T.Q
    }

    __syncthreads();  // every warp is done with this stage
    if (i + STAGES < n_tiles) load_tile(i + STAGES);
    cp_async_commit();
  }

  cp_async_wait<0>();
  // each warp reads and now overwrites only its own 16 rows of ks and vs
  store_rows<D>(dk + koff, gk, scale, ks + warp * 16 * L::LD, k0 + warp * 16, Sk, lane);
  store_rows<D>(dv + koff, gv, 1.f, vs + warp * 16 * L::LD, k0 + warp * 16, Sk, lane);
  db0 = quad_sum(db0);
  db1 = quad_sum(db1);
  if (dbias_part != nullptr && t4 == 0) {
    if (kr0 < Sk) dbias_part[(size_t)bh * Sk + kr0] = db0;
    if (kr0 + 8 < Sk) dbias_part[(size_t)bh * Sk + kr0 + 8] = db1;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, const float* bias, const int* kv_len, void* dq, void* dk,
           void* dv, float* dbias_part, float* rowsum, int B, int H, int Sq, int Sk,
           int causal, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const int n_q_tiles = (Sq + BQ - 1) / BQ, n_k_tiles = (Sk + BK - 1) / BK;
  if (n_q_tiles > 65535 || n_k_tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_mma_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Layout<D>::DQ_BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_mma_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Layout<D>::DKDV_BYTES);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.0f / sqrtf((float)D), scale_log2 = LOG2E * scale;
  flash_mma_bwd_dq_kernel<D><<<dim3(B * H, n_q_tiles), THREADS, Layout<D>::DQ_BYTES, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(out), static_cast<const bf*>(dout), lse, bias, kv_len,
      static_cast<bf*>(dq), rowsum, H, Sq, Sk, causal, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_mma_bwd_dkdv_kernel<D>
      <<<dim3(B * H, n_k_tiles), THREADS, Layout<D>::DKDV_BYTES, stream>>>(
          static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
          static_cast<const bf*>(dout), lse, rowsum, bias, kv_len, static_cast<bf*>(dk),
          static_cast<bf*>(dv), dbias_part, H, Sq, Sk, causal, scale_log2, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 only; D 64 or 128. bias / kv_len / dbias_part may be null; rowsum is
// [B, H, Sq] f32 scratch, written by the dQ pass and read by the dK/dV pass.
// Launches both passes; returns the first cudaGetLastError() that is not 0
// (0 on success).
extern "C" int flash_attention_mma_bwd(const void* q, const void* k, const void* v,
                                       const void* out, const void* dout, const float* lse,
                                       const float* bias, const int* kv_len, void* dq,
                                       void* dk, void* dv, float* dbias_part, float* rowsum,
                                       int B, int H, int Sq, int Sk, int D, int causal,
                                       void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, out, dout, lse, bias, kv_len, dq, dk, dv, dbias_part,
                               rowsum, B, H, Sq, Sk, causal, s);
    case 128: return launch<128>(q, k, v, out, dout, lse, bias, kv_len, dq, dk, dv,
                                 dbias_part, rowsum, B, H, Sq, Sk, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
