// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (Pallas body
// `_kernel`), the online-softmax attention of every ViT block on the Janus
// main path, device and cloud partitions, padded and unpadded.
//
// Semantics (identical to the Pallas kernel for every row that has at least
// one unmasked key):
//   q, k, v [B, H, S, D] contiguous, f32 or bf16; scale 1/sqrt(D); scores,
//   running (m, l) and the accumulator in f32; optional additive per-key bias
//   [B, Sk] f32 clamped at max(bias, -1e30); optional kv_len [B] int32 (keys at
//   or past it masked); optional bottom-right causal mask
//   (qpos + (Sk - Sq) >= kpos); masked scores are -1e30; the output is
//   acc / max(l, 1e-30) cast to q's dtype. A row whose every key is masked
//   (its running max never rises above the -1e30 sentinel) outputs 0; the
//   Pallas kernel returns an average of V there and its jnp oracle NaN, and
//   such rows never occur on the main path (the cls token is always real).
//   lse (nullable, [B, H, Sq] f32): each row's log-sum-exp m + log(l) of its
//   scaled, clamped-bias, masked scores (natural units), for the backward
//   (csrc/flash_attention_bwd.cu); +inf for a row with no unmasked key, so
//   that the backward's exp(s - lse) is 0 there. The output does not depend
//   on it.
//
// What bounds it on the H100: at the main path's largest call (B=8, H=16,
// S=577, D=64, bf16) the work is 4*B*H*S^2*D = 10.9 GFLOP (11 us at the bf16
// tensor-core peak) and q, k, v, o move 37.8 MB (11.3 us at 3.35 TB/s), so a
// good kernel sits at the ridge; at B=1 both bounds are ~1.4 us and launch
// overhead dominates.
//
// Design: one block of 64 threads per (64-query tile, b*h); each thread owns
// one query row in registers (q and the f32 accumulator) and walks the keys in
// tiles of 64 rows (32 at D=128, to stay inside static shared memory) staged
// through shared memory as f32, so every K/V element is read from device
// memory once per query tile. Scores are processed in sub-chunks of 16 keys:
// 16 independent dot-product chains hide FMA latency and keep the score array
// in registers. Key tiles past min(Sk, kv_len) or past the causal frontier of
// the block's last query are skipped: their keys are masked for every row, so
// skipping them does not change any row that has an unmasked key. This is
// CUDA-core f32 arithmetic, deliberately simple: it does not reach the
// tensor-core bound; wgmma/TMA/warp specialisation are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // queries per block (one per thread)
constexpr int SUB = 16;   // keys per online-softmax sub-chunk
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

template <typename T, int D>
__global__ void __launch_bounds__(BQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 const int* __restrict__ kv_len, T* __restrict__ out,
                 float* __restrict__ lse, int H, int Sq, int Sk, int causal, float scale) {
  constexpr int BK = D > 64 ? 32 : 64;
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];
  __shared__ float kb[BK];   // clamped bias of each key of the tile
  __shared__ int kok[BK];    // key in range and before kv_len

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int qi = q0 + tid;
  const bool q_ok = qi < Sq;
  const int shift = Sk - Sq;  // bottom-right causal alignment

  const T* qrow = q + ((size_t)bh * Sq + (q_ok ? qi : 0)) * D;
  const T* kbase = k + (size_t)bh * Sk * D;
  const T* vbase = v + (size_t)bh * Sk * D;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = q_ok ? to_f(qrow[d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG, l = 0.f;

  int kend = Sk;
  if (kv_len != nullptr) kend = min(kend, max(kv_len[b], 0));
  int tile_end = kend;
  if (causal) {
    const int q_last = min(q0 + BQ, Sq) - 1;
    tile_end = min(tile_end, max(q_last + shift + 1, 0));
  }

  for (int t0 = 0; t0 < tile_end; t0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    // the tile is rows [t0, t0 + BK) of a contiguous [Sk, D] slab: consecutive
    // threads read consecutive elements
    for (int e = tid; e < BK * D; e += BQ) {
      const int r = e / D, c = e - (e / D) * D;
      const int kr = t0 + r;
      float kv = 0.f, vv = 0.f;  // rows past Sk are zero, as the Pallas OOB guard
      if (kr < Sk) {
        kv = to_f(kbase[(size_t)kr * D + c]);
        vv = to_f(vbase[(size_t)kr * D + c]);
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    for (int j = tid; j < BK; j += BQ) {
      const int kr = t0 + j;
      kok[j] = kr < kend;
      kb[j] = (bias != nullptr && kr < Sk) ? fmaxf(bias[(size_t)b * Sk + kr], NEG) : 0.f;
    }
    __syncthreads();
    if (!q_ok) continue;

#pragma unroll 1
    for (int j0 = 0; j0 < BK; j0 += SUB) {
      float s[SUB];
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) s[jj] = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
#pragma unroll
        for (int jj = 0; jj < SUB; ++jj) {
          const float4 kk = *reinterpret_cast<const float4*>(&ks[j0 + jj][d]);
          s[jj] = fmaf(qr[d], kk.x, s[jj]);
          s[jj] = fmaf(qr[d + 1], kk.y, s[jj]);
          s[jj] = fmaf(qr[d + 2], kk.z, s[jj]);
          s[jj] = fmaf(qr[d + 3], kk.w, s[jj]);
        }
      }
      float mloc = NEG;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const int j = j0 + jj;
        const int kpos = t0 + j;
        bool ok = kok[j] != 0;
        if (causal) ok = ok && (qi + shift >= kpos);
        const float sc = ok ? s[jj] * scale + kb[j] : NEG;
        s[jj] = sc;
        mloc = fmaxf(mloc, sc);
      }
      const float m_new = fmaxf(m, mloc);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        s[jj] = expf(s[jj] - m_new);
        psum += s[jj];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&vs[j0 + jj][d]);
          acc[d] = fmaf(s[jj], vv.x, acc[d]);
          acc[d + 1] = fmaf(s[jj], vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(s[jj], vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(s[jj], vv.w, acc[d + 3]);
        }
      }
      m = m_new;
    }
  }

  if (!q_ok) return;
  const bool any_key = m > 0.5f * NEG;
  const float denom = fmaxf(l, 1e-30f);
  if (lse != nullptr) lse[(size_t)bh * Sq + qi] = any_key ? m + logf(denom) : INFINITY;
  T* orow = out + ((size_t)bh * Sq + qi) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) orow[d] = from_f<T>(any_key ? acc[d] / denom : 0.f);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* bias,
           const int* kv_len, void* out, float* lse, int B, int H, int Sq, int Sk,
           int causal, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  const float scale = 1.0f / sqrtf((float)D);
  flash_fwd_kernel<T, D><<<grid, BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      bias, kv_len, static_cast<T*>(out), lse, H, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. bias / kv_len / lse may be null. Returns
// the cudaGetLastError() of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const float* bias, const int* kv_len, void* out,
                                   float* lse, int B, int H, int Sq, int Sk, int D,
                                   int dtype, int causal, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, bias, kv_len, out, lse, B, H, Sq, Sk, D, causal, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, bias, kv_len, out, lse, B, H, Sq, Sk, D, causal,
                                     s);
  return (int)cudaErrorInvalidValue;
}
