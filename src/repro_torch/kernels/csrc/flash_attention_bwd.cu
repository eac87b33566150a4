// Flash-attention backward on Hopper's CUDA cores (sm_90a), f32 and bf16;
// plain C interface for ctypes.
//
// Replaces: no TPU kernel. The reference trains through the jnp
// `layers.sdpa`, which XLA differentiates; this is the gradient of
// csrc/flash_attention.cu (src/repro/kernels/flash_attention.py::
// flash_attention's port on the CUDA cores), for the calls that kernel
// serves: f32 at D 16/32/64/128 and bf16 at D 16/32. Like the forward it
// stays off the tensor cores, where f32 would be TF32, so the f32 gradient
// parities keep their f32 limits.
//
// Semantics (those of ref.flash_attention_bwd_ref): q, k, v, out, dout
// [B, H, S, D] contiguous, f32 or bf16; lse [B, H, Sq] f32, the forward's
// natural-unit log-sum-exp (+inf on a row with no unmasked key); optional
// bias [B, Sk] f32 clamped at -1e30, kv_len [B] int32, bottom-right causal
// mask, as the forward. With s = q.k / sqrt(D) + bias:
//   P = exp(s - lse) (0 where masked), D_i = rowsum(dO * O) in f32,
//   dP = dO.V^T in f32, dS = P * (dP - D_i),
//   dV = P^T.dO, dQ = dS.K / sqrt(D), dK = dS^T.Q / sqrt(D).
// S and dP are f32 dot products of the (exact) inputs; in bf16, P and dS are
// rounded to bf16 before the products that give dV, dQ and dK, and the
// gradients are rounded once. dbias_part (nullable, [B, H, Sk] f32) gets each
// key's sum over queries of the unrounded f32 dS; the wrapper sums it over H.
// A key no query sees (past min(Sk, kv_len)) gets dK = dV = 0, written.
//
// What bounds it on the H100: five products of 2*D FLOPs a (query, key)
// pair; at f32 [4, 16, 577, 64] that is 13.6 GFLOP, 0.20 ms at the 67
// TFLOP/s f32 peak, over 76 MB (23 us at 3.35 TB/s), so operations bound
// it. This design recomputes S and dP in both passes (seven products, not
// five) and reads one operand of each product from shared memory: it does
// not reach that bound. Simple and right first; a tensor-core route serves bf16 at D 64/128
// (csrc/flash_attention_mma_bwd.cu).
//
// Design: two passes, no atomics (the gradient is the same bit for bit from
// run to run), launched in order on the caller's stream:
//   1. dQ pass: one thread per query row, ROWS rows per block. The block's
//      dO and O rows are staged transposed in shared memory (each thread
//      reads its own column, conflict-free with a row pad of one float);
//      each thread takes its row's D_i and writes it to `rowsum` for pass 2;
//      then the block's Q rows replace O. Key tiles of CH rows (K, V, bias)
//      stream through shared memory and are read by every thread at the same
//      address (broadcast, 16 bytes a load). A chunk's S and dP are CH
//      independent f32 dot-product chains; dQ stays in registers.
//   2. dK/dV pass: one thread per key row, ROWS keys per block, K and V
//      staged transposed as Q and dO are in pass 1; query tiles of CH rows
//      (Q, dO, lse, D_i) stream through shared memory from the key block's
//      causal frontier on. dK, dV and the dbias sum stay in registers.
//   ROWS is 64 (32 at D = 128) and CH 16 (8 at D = 128), to stay inside 48
//   KB of static shared memory. At D = 128 the dK/dV pass keeps 256 f32
//   accumulators a thread, which spill (ptxas prints it).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}
// x as the products of dV, dQ and dK take it: rounded to T
template <typename T> __device__ __forceinline__ float rounded(float x) {
  return to_f<T>(from_f<T>(x));
}

template <int D> struct Tile {
  static constexpr int ROWS = D > 64 ? 32 : 64;  // threads (own rows) per block
  static constexpr int CH = D > 64 ? 8 : 16;     // streamed rows per chunk
  static constexpr int LDT = ROWS + 1;           // transposed row pad
};

// rows [r0, r0 + R) of a [S, D] slab, transposed into dst[D][LDT] as f32;
// rows past S are zero
template <typename T, int D, int R, int LDT>
__device__ __forceinline__ void stage_t(float* dst, const T* src, int r0, int S, int tid) {
  for (int e = tid; e < R * D; e += R) {
    const int r = e / D, c = e - (e / D) * D;
    dst[c * LDT + r] = r0 + r < S ? to_f(src[(size_t)(r0 + r) * D + c]) : 0.f;
  }
}

// rows [r0, r0 + C) of a [S, D] slab into dst[C][D] as f32; rows past S zero
template <typename T, int D, int C, int NT>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0, int S, int tid) {
  for (int e = tid; e < C * D; e += NT) {
    const int r = e / D, c = e - (e / D) * D;
    dst[e] = r0 + r < S ? to_f(src[(size_t)(r0 + r) * D + c]) : 0.f;
  }
}

// acc[jj] += sum_d colT[d][tid] * rows[jj][d], for the CH streamed rows, two
// products at once (S from a and ra, dP from b and rb). The d loop is not
// unrolled: unrolled, ptxas hoisted the chunk's loads and spilled at D = 16
// (0.72 against 0.29 ms at f32 [8, 4, 577, 16] on the H100).
template <int D, int CH, int LDT>
__device__ __forceinline__ void dots2(float (&sa)[CH], float (&sb)[CH], const float* aT,
                                      const float* bT, const float* ra, const float* rb,
                                      int tid) {
#pragma unroll
  for (int jj = 0; jj < CH; ++jj) sa[jj] = sb[jj] = 0.f;
#pragma unroll 1
  for (int d = 0; d < D; d += 4) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = aT[(d + i) * LDT + tid];
      b[i] = bT[(d + i) * LDT + tid];
    }
#pragma unroll
    for (int jj = 0; jj < CH; ++jj) {
      const float4 x = *reinterpret_cast<const float4*>(ra + jj * D + d);
      const float4 y = *reinterpret_cast<const float4*>(rb + jj * D + d);
      sa[jj] = fmaf(a[0], x.x, fmaf(a[1], x.y, fmaf(a[2], x.z, fmaf(a[3], x.w, sa[jj]))));
      sb[jj] = fmaf(b[0], y.x, fmaf(b[1], y.y, fmaf(b[2], y.z, fmaf(b[3], y.w, sb[jj]))));
    }
  }
}

// pass 1: dQ and rowsum, one thread per query row
template <typename T, int D>
__global__ void __launch_bounds__(Tile<D>::ROWS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ out, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ bias,
                    const int* __restrict__ kv_len, T* __restrict__ dq,
                    float* __restrict__ rowsum, int H, int Sq, int Sk, int causal, float scale) {
  constexpr int ROWS = Tile<D>::ROWS, CH = Tile<D>::CH, LDT = Tile<D>::LDT;
  __shared__ __align__(16) float qT[D * LDT];   // O, then Q, transposed
  __shared__ __align__(16) float doT[D * LDT];  // dO, transposed
  __shared__ __align__(16) float ks[CH * D];
  __shared__ __align__(16) float vs[CH * D];
  __shared__ float kb[CH];   // clamped bias of each key of the chunk
  __shared__ int kok[CH];    // key before min(Sk, kv_len)

  const int bh = blockIdx.y, b = bh / H, tid = threadIdx.x;
  const int q0 = blockIdx.x * ROWS, qi = q0 + tid;
  const bool q_ok = qi < Sq;
  const int shift = Sk - Sq;  // bottom-right causal alignment
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Sk * D;

  stage_t<T, D, ROWS, LDT>(qT, out + qoff, q0, Sq, tid);
  stage_t<T, D, ROWS, LDT>(doT, dout + qoff, q0, Sq, tid);
  __syncthreads();
  float dd = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) dd = fmaf(doT[d * LDT + tid], qT[d * LDT + tid], dd);
  if (q_ok) rowsum[(size_t)bh * Sq + qi] = dd;
  __syncthreads();  // O is read
  stage_t<T, D, ROWS, LDT>(qT, q + qoff, q0, Sq, tid);
  const float lse_i = q_ok ? lse[(size_t)bh * Sq + qi] : INFINITY;

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  int kend = Sk;
  if (kv_len != nullptr) kend = min(kend, max(kv_len[b], 0));
  int tile_end = kend;
  if (causal) tile_end = min(tile_end, max(min(q0 + ROWS, Sq) + shift, 0));

  for (int t0 = 0; t0 < tile_end; t0 += CH) {
    __syncthreads();  // the previous chunk is no longer read (and Q is staged)
    stage<T, D, CH, ROWS>(ks, k + koff, t0, Sk, tid);
    stage<T, D, CH, ROWS>(vs, v + koff, t0, Sk, tid);
    for (int j = tid; j < CH; j += ROWS) {
      const int kr = t0 + j;
      kok[j] = kr < kend;
      kb[j] = (bias != nullptr && kr < Sk) ? fmaxf(bias[(size_t)b * Sk + kr], NEG) : 0.f;
    }
    __syncthreads();
    float s[CH], dp[CH];
    dots2<D, CH, LDT>(s, dp, qT, doT, ks, vs, tid);
#pragma unroll
    for (int jj = 0; jj < CH; ++jj) {
      const int kpos = t0 + jj;
      const bool ok = kok[jj] != 0 && (!causal || kpos <= qi + shift);
      const float p = ok ? expf(fmaf(s[jj], scale, kb[jj]) - lse_i) : 0.f;
      const float ds = rounded<T>(p * (dp[jj] - dd));
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(ks + jj * D + d);
        acc[d] = fmaf(ds, kk.x, acc[d]);
        acc[d + 1] = fmaf(ds, kk.y, acc[d + 1]);
        acc[d + 2] = fmaf(ds, kk.z, acc[d + 2]);
        acc[d + 3] = fmaf(ds, kk.w, acc[d + 3]);
      }
    }
  }
  if (!q_ok) return;
  T* row = dq + qoff + (size_t)qi * D;
#pragma unroll
  for (int d = 0; d < D; ++d) row[d] = from_f<T>(acc[d] * scale);
}

// pass 2: dK, dV and the dbias sums, one thread per key row
template <typename T, int D>
__global__ void __launch_bounds__(Tile<D>::ROWS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ rowsum,
                      const float* __restrict__ bias, const int* __restrict__ kv_len,
                      T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dbias_part,
                      int H, int Sq, int Sk, int causal, float scale) {
  constexpr int ROWS = Tile<D>::ROWS, CH = Tile<D>::CH, LDT = Tile<D>::LDT;
  __shared__ __align__(16) float kT[D * LDT];
  __shared__ __align__(16) float vT[D * LDT];
  __shared__ __align__(16) float qs[CH * D];
  __shared__ __align__(16) float dos[CH * D];
  __shared__ float ls[CH];  // lse of each query of the chunk (+inf past Sq)
  __shared__ float rs[CH];  // its rowsum(dO * O)

  const int bh = blockIdx.y, b = bh / H, tid = threadIdx.x;
  const int k0 = blockIdx.x * ROWS, kj = k0 + tid;
  const int shift = Sk - Sq;
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Sk * D;
  int kend = Sk;
  if (kv_len != nullptr) kend = min(kend, max(kv_len[b], 0));
  const bool k_ok = kj < kend;

  float gk[D], gv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) gk[d] = gv[d] = 0.f;
  float db = 0.f;

  if (k0 < kend) {  // else no key of the block is seen: zeros are written
    stage_t<T, D, ROWS, LDT>(kT, k + koff, k0, Sk, tid);
    stage_t<T, D, ROWS, LDT>(vT, v + koff, k0, Sk, tid);
    const float kb = (bias != nullptr && kj < Sk) ? fmaxf(bias[(size_t)b * Sk + kj], NEG) : 0.f;
    // the first query that sees key k0
    const int q_begin = causal ? min(max(k0 - shift, 0), Sq) : 0;
    for (int t0 = q_begin; t0 < Sq; t0 += CH) {
      __syncthreads();  // the previous chunk is no longer read (and K, V are staged)
      stage<T, D, CH, ROWS>(qs, q + qoff, t0, Sq, tid);
      stage<T, D, CH, ROWS>(dos, dout + qoff, t0, Sq, tid);
      for (int j = tid; j < CH; j += ROWS) {
        const bool ok = t0 + j < Sq;
        ls[j] = ok ? lse[(size_t)bh * Sq + t0 + j] : INFINITY;
        rs[j] = ok ? rowsum[(size_t)bh * Sq + t0 + j] : 0.f;
      }
      __syncthreads();
      float s[CH], dp[CH];
      dots2<D, CH, LDT>(s, dp, kT, vT, qs, dos, tid);
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const int qpos = t0 + jj;
        const bool ok = k_ok && (!causal || kj <= qpos + shift);
        const float p = ok ? expf(fmaf(s[jj], scale, kb) - ls[jj]) : 0.f;
        const float g = p * (dp[jj] - rs[jj]);
        db += g;
        const float pr = rounded<T>(p), gr = rounded<T>(g);
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 o = *reinterpret_cast<const float4*>(dos + jj * D + d);
          const float4 x = *reinterpret_cast<const float4*>(qs + jj * D + d);
          gv[d] = fmaf(pr, o.x, gv[d]);
          gv[d + 1] = fmaf(pr, o.y, gv[d + 1]);
          gv[d + 2] = fmaf(pr, o.z, gv[d + 2]);
          gv[d + 3] = fmaf(pr, o.w, gv[d + 3]);
          gk[d] = fmaf(gr, x.x, gk[d]);
          gk[d + 1] = fmaf(gr, x.y, gk[d + 1]);
          gk[d + 2] = fmaf(gr, x.z, gk[d + 2]);
          gk[d + 3] = fmaf(gr, x.w, gk[d + 3]);
        }
      }
    }
  }
  if (kj >= Sk) return;
  T* krow = dk + koff + (size_t)kj * D;
  T* vrow = dv + koff + (size_t)kj * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    krow[d] = from_f<T>(gk[d] * scale);
    vrow[d] = from_f<T>(gv[d]);
  }
  if (dbias_part != nullptr) dbias_part[(size_t)bh * Sk + kj] = db;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, const float* bias, const int* kv_len, void* dq, void* dk,
           void* dv, float* dbias_part, float* rowsum, int B, int H, int Sq, int Sk,
           int causal, cudaStream_t stream) {
  constexpr int ROWS = Tile<D>::ROWS;
  const float scale = 1.0f / sqrtf((float)D);
  flash_bwd_dq_kernel<T, D><<<dim3((Sq + ROWS - 1) / ROWS, B * H), ROWS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(out), static_cast<const T*>(dout), lse, bias, kv_len,
      static_cast<T*>(dq), rowsum, H, Sq, Sk, causal, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<T, D><<<dim3((Sk + ROWS - 1) / ROWS, B * H), ROWS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, rowsum, bias, kv_len, static_cast<T*>(dk),
      static_cast<T*>(dv), dbias_part, H, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. bias / kv_len / dbias_part may be null;
// rowsum is [B, H, Sq] f32 scratch, written by the dQ pass and read by the
// dK/dV pass. Launches both passes; returns the first cudaGetLastError()
// that is not 0 (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* dout, const float* lse,
                                   const float* bias, const int* kv_len, void* dq, void* dk,
                                   void* dv, float* dbias_part, float* rowsum, int B, int H,
                                   int Sq, int Sk, int D, int dtype, int causal, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || B * H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, out, dout, lse, bias, kv_len, dq, dk, dv, dbias_part,
                             rowsum, B, H, Sq, Sk, D, causal, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, dout, lse, bias, kv_len, dq, dk, dv,
                                     dbias_part, rowsum, B, H, Sq, Sk, D, causal, s);
  return (int)cudaErrorInvalidValue;
}
