// Single-query GQA decode attention over a KV cache on Hopper's tensor cores
// (sm_90a), bf16 at D = 64 and 128; plain C interface for ctypes.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention (Pallas
// body `_kernel`) for every bf16 call: the attention of every layer of every
// LM decode step. f32 calls stay on csrc/decode_attention.cu (CUDA-core f32
// math), which keeps the f32 parity at 2e-5; f32 on the tensor cores would be
// TF32.
//
// Semantics (those of ref.decode_attention_ref and csrc/decode_attention.cu):
//   q [B, Hq, D]; k, v [B, S, Hkv, D] (the cache layout, fixed capacity S),
//   contiguous bf16, each 16-byte aligned; lengths [B] int32 on the device:
//   keys at or past lengths[b] are masked. q head h reads kv head
//   h / (Hq / Hkv). Scale 1/sqrt(D); scores, running (m, l) and the
//   accumulator in f32; the output is acc / max(l, 1e-30) rounded once to
//   bf16 (nearest even); length 0 outputs 0. Rounding points that differ from
//   the plain version: the softmax weights P are rounded to bf16 before P.V
//   (the tensor cores' A operand); l sums the f32 weights. Scores are kept in
//   log2 units (scale times log2 e) so that exp2f does the exponentials, and
//   the partial m is stored in those units.
//
// What bounds it on the H100: bytes. It reads the valid part of the cache
// once (B * length * Hkv * D * 2 elements) and does 4 flops per element per
// query head of the group: at the serving path's shape (B=8, Hq=24, Hkv=2,
// D=128, length 1088) 8.9 MB, 2.7 us at 3.35 TB/s, against 0.14 GFLOP (0.14
// us at the bf16 tensor-core peak). So the kernel has to keep enough bytes in
// flight on every SM and must not serialise loads behind arithmetic, which is
// what held the CUDA-core kernel at 16-51x its bound: synchronous loads, one
// tile per block at the path's shape, and scalar f32 q.k and p.V.
//
// Design (FlashDecoding on mma.sync):
//   - grid (split, kv head x head tile, b). The query heads of one kv head
//     form the mma A operand: a tile of 16 rows (12 at starcoder2-3b, 2 at
//     internlm2, zero-padded; larger groups take several head tiles).
//   - the cache axis is split across blocks, and a combine kernel merges the
//     partials. The split count comes from the shapes alone (the wrapper's
//     n_splits: at least 4 tiles of capacity per split); each block cuts its
//     share of the valid tiles, [split * nt / nsplit, (split + 1) * nt /
//     nsplit) of nt = ceil(length / 64), from the device-side length, so the
//     valid tiles spread evenly over the splits.
//   - K/V tiles of 64 positions stream through a 3-stage cp.async.cg ring in
//     dynamic shared memory (104 KB at D=128): two tiles are in flight while
//     one computes. Rows are padded by 16 bytes so that the 8 row addresses of
//     one ldmatrix fall in 8 distinct bank groups. Positions past the length
//     are zero-filled (never read from device memory).
//   - each of the 4 warps owns 16 positions of every tile: S = Q.K^T (16 heads
//     x 16 positions) by mma.sync.m16n8k16 with K fragments from ldmatrix; the
//     online softmax runs in registers with quad shuffles; O += P.V reuses the
//     S accumulators, rounded to bf16, as the A fragment, with V fragments
//     from ldmatrix.trans. Each warp carries its own (m, l, O).
//   - the warps merge their (m, l, O) in shared memory (a warp whose running
//     max never left the -1e30 sentinel holds junk and weighs 0), and the
//     block writes one partial per query head.
//   - the combine reads the splits' (m, l) in parallel and sums the partial
//     accumulators with 4 x D threads per query head, so a long cache's many
//     splits (128 at B=1, S=32768) cost no serial chain of loads.
// Out of scope here: TMA, wgmma (16 rows are below its 64), one fused pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int CH = 64;      // cache positions per tile (the wrapper mirrors it)
constexpr int PW = CH / WARPS;  // positions per warp and tile: one k-step of P.V
constexpr int GT = 16;      // query heads per block (the wrapper mirrors it)
constexpr int STAGES = 3;   // K/V ring depth
constexpr int CQ = 4;       // groups of D threads of the combine, each summing 1/CQ of the splits
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(PW == 16, "a warp's positions are one m16n8k16 k-step");

template <int D>
struct Layout {
  static constexpr int LD = D + 8;          // padded row, in bf16 elements
  static constexpr int Q_ELEMS = GT * LD;
  static constexpr int TILE = CH * LD;      // one K or V tile
  static constexpr size_t BYTES =
      (size_t)(Q_ELEMS + 2 * STAGES * TILE) * sizeof(__nv_bfloat16);
  static_assert((size_t)WARPS * GT * D * sizeof(float) <= BYTES, "merge buffer fits");
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

// Partial attention of one split of the cache for up to GT query heads of
// one kv head. Partials are indexed [(b * Hq + hq) * nsplit + split]; an
// empty split writes (m, l, acc) = (-1e30, 0, 0), which the combine skips.
template <int D>
__global__ void __launch_bounds__(THREADS)
decode_mma_partial_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
                          float* __restrict__ part_acc, float* __restrict__ part_m,
                          float* __restrict__ part_l, int Hq, int Hkv, int S, int nsplit,
                          float scale_log2) {
  using L = Layout<D>;
  constexpr int LD = L::LD;
  constexpr int CHK = D / 8;   // 16-byte chunks per row
  constexpr int KS = D / 16;   // k-steps of Q.K^T
  constexpr int DB = D / 8;    // n-blocks of O (8 columns each)
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [GT][LD]
  __nv_bfloat16* ks = qs + L::Q_ELEMS;                           // [STAGES][CH][LD]
  __nv_bfloat16* vs = ks + STAGES * L::TILE;                     // [STAGES][CH][LD]
  __shared__ float wm[WARPS][GT], wl[WARPS][GT];

  const int split = blockIdx.x;
  const int g = Hq / Hkv;
  const int htiles = (g + GT - 1) / GT;
  const int kvh = blockIdx.y / htiles;
  const int h0 = (blockIdx.y - kvh * htiles) * GT;
  const int gh = min(GT, g - h0);  // query heads of this block
  const int b = blockIdx.z;
  const size_t hq0 = (size_t)b * Hq + (size_t)kvh * g + h0;  // first (b, q head) row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;  // fragment row group, thread in quad

  const int len = max(0, min(lengths[b], S));
  const int nt = (len + CH - 1) / CH;
  const int tile_lo = (int)((long long)split * nt / nsplit);
  const int n_tiles = (int)((long long)(split + 1) * nt / nsplit) - tile_lo;

  const size_t pstride = (size_t)Hkv * D;  // elements from one position to the next
  const __nv_bfloat16* kg = k + ((size_t)b * S * Hkv + kvh) * D;
  const __nv_bfloat16* vg = v + ((size_t)b * S * Hkv + kvh) * D;

  auto load_tile = [&](int i) {
    const int p0 = (tile_lo + i) * CH, st = i % STAGES;
#pragma unroll
    for (int j = 0; j < CH * CHK / THREADS; ++j) {
      const int c = tid + j * THREADS, r = c / CHK, col = (c % CHK) * 8;
      const bool ok = p0 + r < len;
      const size_t off = ok ? (size_t)(p0 + r) * pstride + col : 0;
      cp_async16(smem_u32(ks + st * L::TILE + r * LD + col), kg + off, ok);
      cp_async16(smem_u32(vs + st * L::TILE + r * LD + col), vg + off, ok);
    }
  };

  // prologue: Q (heads past the group zero) with tile 0 in group 0, then one
  // group per further stage
  for (int c = tid; c < GT * CHK; c += THREADS) {
    const int r = c / CHK, col = (c % CHK) * 8;
    const bool ok = r < gh;
    cp_async16(smem_u32(qs + r * LD + col), q + (ok ? (hq0 + r) * D + col : 0), ok);
  }
#pragma unroll
  for (int i = 0; i < STAGES; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }

  float o[DB][4];
#pragma unroll
  for (int db = 0; db < DB; ++db) o[db][0] = o[db][1] = o[db][2] = o[db][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // heads gq and gq + 8

  if (n_tiles > 0) {
    cp_async_wait<STAGES - 1>();  // group 0: Q and tile 0
    __syncthreads();
    uint32_t qf[KS][4];  // Q as A fragments, once
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldsm_x4(smem_u32(qs + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8), qf[kk]);

#pragma unroll 1
    for (int i = 0; i < n_tiles; ++i) {
      cp_async_wait<STAGES - 1>();  // group i has landed
      __syncthreads();
      const int st = i % STAGES;
      const __nv_bfloat16* kt = ks + st * L::TILE + warp * PW * LD;
      const __nv_bfloat16* vt = vs + st * L::TILE + warp * PW * LD;

      // S = Q.K^T: 16 heads x this warp's 16 positions
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t r[4];
        ldsm_x4(smem_u32(kt + ((lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                         ((lane >> 3) & 1) * 8), r);
        mma_bf16(s[0], qf[kk], r[0], r[1]);
        mma_bf16(s[1], qf[kk], r[2], r[3]);
      }

      // scale and mask; online softmax in log2 units
      const int p0 = (tile_lo + i) * CH + warp * PW;
      const bool edge = (tile_lo + i + 1) * CH > len;
      float mx0 = NEG, mx1 = NEG;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nb][e] * scale_log2;
          if (edge && p0 + nb * 8 + 2 * t4 + (e & 1) >= len) x = NEG;
          s[nb][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      uint32_t pf[4];  // P as the A fragment of P.V
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const float p_0 = exp2f(s[nb][0] - mn0), p_1 = exp2f(s[nb][1] - mn0);
        const float p_2 = exp2f(s[nb][2] - mn1), p_3 = exp2f(s[nb][3] - mn1);
        ps0 += p_0 + p_1;
        ps1 += p_2 + p_3;
        pf[nb * 2] = pack_bf16(p_0, p_1);
        pf[nb * 2 + 1] = pack_bf16(p_2, p_3);
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
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t r[4];
        ldsm_x4_trans(smem_u32(vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 +
                               (lane >> 4) * 8), r);
        mma_bf16(o[2 * dp], pf, r[0], r[1]);
        mma_bf16(o[2 * dp + 1], pf, r[2], r[3]);
      }

      __syncthreads();  // every warp is done with this stage
      if (i + STAGES < n_tiles) load_tile(i + STAGES);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

  // merge the warps' (m, l, O): a warp whose max stayed at the sentinel saw
  // no valid position and weighs 0
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (t4 == 0) {
    wm[warp][gq] = m0;
    wm[warp][gq + 8] = m1;
    wl[warp][gq] = l0;
    wl[warp][gq + 8] = l1;
  }
  __syncthreads();  // also: no warp reads the K/V ring any more
  float mb0 = NEG, mb1 = NEG;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    if (wm[w][gq] > 0.5f * NEG) mb0 = fmaxf(mb0, wm[w][gq]);
    if (wm[w][gq + 8] > 0.5f * NEG) mb1 = fmaxf(mb1, wm[w][gq + 8]);
  }
  const float w0 = m0 > 0.5f * NEG ? exp2f(m0 - mb0) : 0.f;
  const float w1 = m1 > 0.5f * NEG ? exp2f(m1 - mb1) : 0.f;
  float* os = reinterpret_cast<float*>(smem);  // [WARPS][GT][D], over the ring
#pragma unroll
  for (int db = 0; db < DB; ++db) {
    const int col = db * 8 + 2 * t4;
    *reinterpret_cast<float2*>(os + (warp * GT + gq) * D + col) =
        make_float2(o[db][0] * w0, o[db][1] * w0);
    *reinterpret_cast<float2*>(os + (warp * GT + gq + 8) * D + col) =
        make_float2(o[db][2] * w1, o[db][3] * w1);
  }
  __syncthreads();
  for (int e = tid; e < gh * D; e += THREADS) {
    const int r = e / D, d = e - (e / D) * D;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) acc += os[(w * GT + r) * D + d];
    part_acc[((hq0 + r) * nsplit + split) * D + d] = acc;
  }
  if (tid < gh) {
    float mb = NEG, lb = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      if (wm[w][tid] > 0.5f * NEG) mb = fmaxf(mb, wm[w][tid]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      if (wm[w][tid] > 0.5f * NEG) lb = fmaf(wl[w][tid], exp2f(wm[w][tid] - mb), lb);
    part_m[(hq0 + tid) * nsplit + split] = mb;
    part_l[(hq0 + tid) * nsplit + split] = lb;
  }
}

// x reduced over the block (a max or a sum); every thread gets the result.
template <int N, bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < N / 32; ++w) x = MAX ? fmaxf(x, red[w]) : x + red[w];
  __syncthreads();  // red may be written again
  return x;
}

// out[b, hq, :] from the nsplit partials of (b, hq) (m in log2 units): one
// block of CQ x D threads. The splits' (m, l) are read in parallel, one split
// per thread, and each split's weight staged in shared memory; then CQ groups
// of D threads each sum every CQ-th split into their output column with
// independent loads, and the groups' sums are added.
template <int D>
__global__ void __launch_bounds__(CQ * D)
decode_mma_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_m,
                          const float* __restrict__ part_l, __nv_bfloat16* __restrict__ out,
                          int nsplit) {
  extern __shared__ float ws[];  // [nsplit] weights
  __shared__ float red[CQ * D / 32];
  __shared__ float acc_q[CQ][D];
  const size_t rowi = blockIdx.x;
  const int t = threadIdx.x, d = t % D, grp = t / D;
  const float* pm = part_m + rowi * nsplit;
  const float* pl = part_l + rowi * nsplit;
  const float* pa = part_acc + rowi * nsplit * D;
  float m = NEG;  // empty splits (l = 0) are skipped
  for (int i = t; i < nsplit; i += CQ * D)
    if (pl[i] > 0.f) m = fmaxf(m, pm[i]);
  m = block_reduce<CQ * D, true>(m, red);
  float l = 0.f;
  for (int i = t; i < nsplit; i += CQ * D) {
    const float w = pl[i] > 0.f ? exp2f(pm[i] - m) : 0.f;
    ws[i] = w;
    l = fmaf(pl[i], w, l);
  }
  l = block_reduce<CQ * D, false>(l, red);  // its barriers also publish ws
  float a = 0.f;
#pragma unroll 4
  for (int i = grp; i < nsplit; i += CQ) a = fmaf(pa[(size_t)i * D + d], ws[i], a);
  acc_q[grp][d] = a;
  __syncthreads();
  if (grp == 0) {
#pragma unroll
    for (int j = 1; j < CQ; ++j) a += acc_q[j][d];
    out[rowi * D + d] = __float2bfloat16(a / fmaxf(l, 1e-30f));
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* lengths, float* part_acc,
           float* part_m, float* part_l, void* out, int B, int Hq, int Hkv, int S, int nsplit,
           cudaStream_t stream) {
  const size_t smem = Layout<D>::BYTES;
  static bool smem_set = false;  // once per instantiation (one card per process)
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_mma_partial_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int htiles = (Hq / Hkv + GT - 1) / GT;
  const float scale_log2 = LOG2E / sqrtf((float)D);
  decode_mma_partial_kernel<D><<<dim3(nsplit, Hkv * htiles, B), THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lengths, part_acc, part_m, part_l, Hq, Hkv, S,
      nsplit, scale_log2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_mma_combine_kernel<D><<<B * Hq, CQ * D, nsplit * sizeof(float), stream>>>(
      part_acc, part_m, part_l, static_cast<__nv_bfloat16*>(out), nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 only; D 64 or 128. part_acc [B*Hq*nsplit*D], part_m and part_l
// [B*Hq*nsplit] f32 scratch. Returns the cudaGetLastError() of the launches
// (0 on success).
extern "C" int decode_attention_mma_fwd(const void* q, const void* k, const void* v,
                                        const int* lengths, float* part_acc, float* part_m,
                                        float* part_l, void* out, int B, int Hq, int Hkv,
                                        int S, int D, int nsplit, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || S <= 0 || nsplit <= 0 || Hq % Hkv != 0 ||
      B > 65535 || Hkv * ((Hq / Hkv + GT - 1) / GT) > 65535 || nsplit > 10 * 1024)
    return (int)cudaErrorInvalidValue;  // the combine stages nsplit weights in 40 KB
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, lengths, part_acc, part_m, part_l, out, B, Hq, Hkv, S,
                        nsplit, s);
    case 128:
      return launch<128>(q, k, v, lengths, part_acc, part_m, part_l, out, B, Hq, Hkv, S,
                         nsplit, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
