// Flash-attention forward on Hopper's tensor cores (sm_90a), bf16 at D = 64
// and 128; plain C interface for ctypes.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (Pallas body
// `_kernel`) for every bf16 call at those head dims: each ViT block's
// attention on the Janus main path (D=64, proportional-attention bias, -inf
// bucket pads) and the LM prefill's causal attention (D=128). f32 calls and
// D in {16, 32} stay on csrc/flash_attention.cu (CUDA-core f32 math), which
// keeps the f32 whole-path parities at 2e-5; tensor cores in f32 would be TF32.
//
// Semantics (those of ref.flash_attention_ref and csrc/flash_attention.cu):
//   q, k, v [B, H, S, D] contiguous bf16, each 16-byte aligned; scale
//   1/sqrt(D); scores, running (m, l) and the accumulator in f32; optional
//   additive per-key bias [B, Sk] f32 clamped at max(bias, -1e30); optional
//   kv_len [B] int32 (keys at or past it masked); optional bottom-right causal
//   mask (qpos + (Sk - Sq) >= kpos); masked scores are -1e30; the output is
//   acc / max(l, 1e-30) rounded once to bf16 (nearest even). A row with no
//   unmasked key (its running max stays at or below 0.5 * -1e30) outputs 0.
//   Rounding points that differ from the plain version: the softmax weights P
//   are rounded to bf16 before P.V (the tensor cores' A operand); l sums the
//   f32 weights. Scores are kept in log2 units (scale and bias times log2 e)
//   so that exp2f does the exponentials.
//   lse (nullable, [B, H, Sq] f32): each row's log-sum-exp of its scaled,
//   clamped-bias, masked scores in natural units, (m + log2 l) * ln 2, for
//   the backward (csrc/flash_attention_mma_bwd.cu); +inf for a row with no
//   unmasked key, so that the backward's exp(s - lse) is 0 there. Serving
//   passes null; the output does not depend on it.
//
// What bounds it on the H100: the LM prefill call [8, 24, 1024, 128] causal
// is 51.6 GFLOP (52 us at the 989 TFLOP/s bf16 tensor-core peak) over 201 MB
// (60 us at 3.35 TB/s); the ViT cloud batch [8, 16, 577, 64] with bias is
// 10.9 GFLOP (11 us) over 37.8 MB (11.3 us). Both sit at the ridge, so the
// kernel has to keep the tensor cores fed and read each K/V tile once per
// query block.
//
// Design (FlashAttention-2 on mma.sync):
//   - one block of 4 warps per (b*h, 64-query tile); each warp owns 16 query
//     rows. Grid (B*H, query tiles): with a causal mask the query tiles run
//     heaviest first (reversed blockIdx.y), so the long tail is short tiles.
//   - Q is copied into shared memory once and held in registers as mma A
//     fragments (ldmatrix).
//   - K/V tiles of 64 keys stream through a 2-stage ring in dynamic shared
//     memory with cp.async.cg 16-byte copies (commit/wait groups): tile t+1
//     is in flight while tile t computes. Rows are padded by 16 bytes (row
//     stride D + 8 elements), so the 8 row addresses of one ldmatrix fall in
//     8 distinct bank groups. Key rows past min(Sk, kv_len) are zero-filled
//     (never read from device memory). The tile's bias rides in the same
//     copy group (4-byte cp.async, zero past Sk).
//   - S = Q.K^T with mma.sync.m16n8k16 bf16 -> f32, K fragments by ldmatrix;
//     the epilogue scales, adds the clamped bias, masks (element by element
//     only on tiles that hold a masked key of some row of the block), and
//     runs the online softmax per row, reducing max and sum over the 4
//     threads of a quad with __shfl_xor_sync.
//   - O += P.V reuses the S accumulators, rounded to bf16, directly as A
//     fragments; V fragments come from ldmatrix.trans. O stays in f32
//     registers (D/2 floats a thread).
//   - key tiles masked for every row of the block (past kv_len or Sk, past
//     the causal frontier of the block's last query) are skipped. A leading
//     tile masked for one row but not for the block leaves that row's m at
//     -1e30, so exp(s - m) = 1 fills l and O with junk: the first real key
//     scales it by exp(-1e30 - m) = 0, and a row that never sees one outputs 0.
//   - the output goes through the warp's own Q rows in shared memory and
//     leaves in 16-byte stores.
// Out of scope here: wgmma, TMA, warp specialisation, persistent blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int STAGES = 2;       // K/V ring depth
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Layout {
  static constexpr int LD = D + 8;          // padded row, in bf16 elements
  static constexpr int Q_ELEMS = BQ * LD;
  static constexpr int TILE = BK * LD;      // one K or V tile
  static constexpr size_t BYTES =
      (size_t)(Q_ELEMS + 2 * STAGES * TILE) * sizeof(__nv_bfloat16) + STAGES * BK * sizeof(float);
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_mma_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                     const int* __restrict__ kv_len, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int H, int Sq, int Sk, int causal,
                     float scale_log2) {
  using L = Layout<D>;
  constexpr int LD = L::LD;
  constexpr int CH = D / 8;    // 16-byte chunks per row
  constexpr int KS = D / 16;   // k-steps of Q.K^T
  constexpr int NB = BK / 8;   // n-blocks of S (8 keys each)
  constexpr int DB = D / 8;    // n-blocks of O (8 columns each)
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [BQ][LD]
  __nv_bfloat16* ks = qs + L::Q_ELEMS;                           // [STAGES][BK][LD]
  __nv_bfloat16* vs = ks + STAGES * L::TILE;                     // [STAGES][BK][LD]
  float* bsm = reinterpret_cast<float*>(vs + STAGES * L::TILE);  // [STAGES][BK]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = (causal ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.y) * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group, thread in quad
  const int shift = Sk - Sq;               // bottom-right causal alignment
  const int row0 = q0 + warp * 16 + g;     // this thread's rows: row0, row0 + 8

  const __nv_bfloat16* kg = k + (size_t)bh * Sk * D;
  const __nv_bfloat16* vg = v + (size_t)bh * Sk * D;
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
      const int c = tid + i * THREADS, r = c / CH, col = (c % CH) * 8;
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
    const int c = tid + i * THREADS, r = c / CH, col = (c % CH) * 8;
    const bool ok = q0 + r < Sq;
    const size_t off = ok ? ((size_t)bh * Sq + q0 + r) * D + col : 0;
    cp_async16(smem_u32(qs + r * LD + col), q + off, ok);
  }
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();
  if (n_tiles > 1) load_tile(1);
  cp_async_commit();

  // Q to registers as A fragments, once
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(smem_u32(qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8), qf[kk]);
  float o[DB][4];
#pragma unroll
  for (int db = 0; db < DB; ++db) o[db][0] = o[db][1] = o[db][2] = o[db][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // rows row0 and row0 + 8

#pragma unroll 1
  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<1>();  // group `tile` has landed
    __syncthreads();
    const int st = tile % STAGES;
    const __nv_bfloat16* kt = ks + st * L::TILE;
    const __nv_bfloat16* vt = vs + st * L::TILE;
    const float* bt = bsm + st * BK;

    // S = Q.K^T: 16 rows x 64 keys per warp
    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NB / 2; ++jp) {
        uint32_t r[4];
        ldsm_x4(smem_u32(kt + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                         ((lane >> 3) & 1) * 8), r);
        mma_bf16(s[2 * jp], qf[kk], r[0], r[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], r[2], r[3]);
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
    uint32_t pf[NB / 2][4];  // P as the A fragments of P.V, one per 16 keys
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const float p0 = exp2f(s[nb][0] - mn0), p1 = exp2f(s[nb][1] - mn0);
      const float p2 = exp2f(s[nb][2] - mn1), p3 = exp2f(s[nb][3] - mn1);
      ps0 += p0 + p1;
      ps1 += p2 + p3;
      pf[nb >> 1][(nb & 1) * 2] = pack_bf16(p0, p1);
      pf[nb >> 1][(nb & 1) * 2 + 1] = pack_bf16(p2, p3);
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

    // O += P.V
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk) {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t r[4];
        ldsm_x4_trans(smem_u32(vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                               dp * 16 + (lane >> 4) * 8), r);
        mma_bf16(o[2 * dp], pf[kk], r[0], r[1]);
        mma_bf16(o[2 * dp + 1], pf[kk], r[2], r[3]);
      }
    }

    __syncthreads();  // every warp is done with this stage
    if (tile + STAGES < n_tiles) load_tile(tile + STAGES);
    cp_async_commit();
  }

  // finish: the warp's O rows through its own Q rows of shared memory
  cp_async_wait<0>();
  __syncthreads();  // no copy into qs is pending (n_tiles may be 0)
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const bool any0 = m0 > 0.5f * NEG, any1 = m1 > 0.5f * NEG;
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  if (lse != nullptr && t4 == 0) {
    if (row0 < Sq) lse[(size_t)bh * Sq + row0] = any0 ? (m0 + log2f(d0)) * LN2 : INFINITY;
    if (row0 + 8 < Sq) lse[(size_t)bh * Sq + row0 + 8] = any1 ? (m1 + log2f(d1)) * LN2 : INFINITY;
  }
  __nv_bfloat16* os = qs + warp * 16 * LD;
#pragma unroll
  for (int db = 0; db < DB; ++db) {
    const int col = db * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(os + g * LD + col) = __floats2bfloat162_rn(
        any0 ? o[db][0] / d0 : 0.f, any0 ? o[db][1] / d0 : 0.f);
    *reinterpret_cast<__nv_bfloat162*>(os + (g + 8) * LD + col) = __floats2bfloat162_rn(
        any1 ? o[db][2] / d1 : 0.f, any1 ? o[db][3] / d1 : 0.f);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * CH / 32; ++i) {
    const int c = lane + i * 32, r = c / CH, col = (c % CH) * 8;
    const int qr = q0 + warp * 16 + r;
    if (qr < Sq)
      *reinterpret_cast<uint4*>(out + ((size_t)bh * Sq + qr) * D + col) =
          *reinterpret_cast<const uint4*>(os + r * LD + col);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const float* bias, const int* kv_len,
           void* out, float* lse, int B, int H, int Sq, int Sk, int causal,
           cudaStream_t stream) {
  const int n_q_tiles = (Sq + BQ - 1) / BQ;
  if (n_q_tiles > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = Layout<D>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_mma_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, n_q_tiles);
  const float scale_log2 = LOG2E / sqrtf((float)D);
  flash_mma_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias, kv_len, static_cast<__nv_bfloat16*>(out), lse,
      H, Sq, Sk, causal, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 only; D 64 or 128. bias / kv_len / lse may be null. Returns the
// cudaGetLastError() of the launch (0 on success).
extern "C" int flash_attention_mma_fwd(const void* q, const void* k, const void* v,
                                       const float* bias, const int* kv_len, void* out,
                                       float* lse, int B, int H, int Sq, int Sk, int D,
                                       int causal, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, bias, kv_len, out, lse, B, H, Sq, Sk, causal, s);
    case 128: return launch<128>(q, k, v, bias, kv_len, out, lse, B, H, Sq, Sk, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
