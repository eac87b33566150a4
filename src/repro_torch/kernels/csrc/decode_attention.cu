// Single-query GQA decode attention over a KV cache for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention (Pallas
// body `_kernel`), the attention of every layer of every LM decode step.
//
// Semantics (those of decode_attention_ref, src/repro/kernels/ref.py):
//   q [B, Hq, D]; k, v [B, S, Hkv, D] (the cache layout, fixed capacity S);
//   lengths [B] int32: keys at or past lengths[b] are masked. q head h reads
//   kv head h / (Hq / Hkv). Scale 1/sqrt(D); scores, running (m, l) and the
//   accumulator in f32; the output is acc / max(l, 1e-30) cast to q's dtype
//   once. A row with length 0 outputs 0, as the Pallas kernel does (its jnp
//   oracle gives NaN there); it never occurs on the serving path.
//
// What bounds it on the H100: bytes. It reads the valid part of the cache
// once (B * length * Hkv * D * 2 elements) and does 4 flops per element per
// query head of the group: at the serving path's shape (B=8, Hq=24, Hkv=2,
// D=128, bf16, length 1088) 8.9 MB, 2.7 us at 3.35 TB/s, against 0.14
// GFLOP (0.14 us at the bf16 peak).
//
// Design. The Pallas grid (B, Hkv, S/bs) carries (m, l, acc) along a
// sequential cache axis; Hopper blocks run in no order, and one block per
// (batch, kv head) would give 16 blocks on 132 SMs at the path's shape. So
// the cache axis is split across blocks ("split-K"): block (split, kv head x
// head tile, b) walks its chunk of [0, lengths[b]) in tiles of CH positions,
// carrying the online softmax inside the block, and writes the partial
// (m, l, acc) of each query head it serves to scratch that the wrapper
// allocates; a second kernel combines the partials of each (b, q head). The
// chunk is cut from the valid length on the device, so every split has work
// whatever the length, and the split count is chosen by the wrapper from the
// shapes alone (no host read-back of lengths). Each k/v row a block loads
// (256 contiguous bytes at D=128 bf16, 16 bytes per thread) serves all the
// query heads of its group (up to GT per block; larger groups take several
// head tiles). Scores: the threads of a row reduce q.k with warp shuffles;
// the V tile is staged in shared memory as f32, and each thread owns a fixed
// set of (head, d) outputs for p.V. CUDA-core f32 arithmetic, simple first:
// no cp.async/TMA pipelining and no tensor cores (later work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CH = 64;     // cache positions per tile (the wrapper mirrors it)
constexpr int GT = 16;     // query heads per block (the wrapper mirrors it)
constexpr float NEG = -1e30f;

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

// one 16-byte load, widened to f32
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

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

// Partial attention of one split of the cache for up to GT query heads of
// one kv head. Partials are indexed [(b * Hq + hq) * nsplit + split].
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ lengths,
                      float* __restrict__ part_acc, float* __restrict__ part_m,
                      float* __restrict__ part_l, int Hq, int Hkv, int S,
                      int nsplit, float scale) {
  constexpr int VEC = Vec<T>::N;
  constexpr int TPR = D / VEC;           // threads per cache row
  constexpr int RPP = THREADS / TPR;     // rows per pass of the block
  constexpr int OUTS = GT * D / THREADS; // (head, d) outputs per thread
  static_assert(TPR <= 32 && 32 % TPR == 0 && CH % RPP == 0, "tile shape");
  static_assert(CH == 64, "the softmax step gives each lane two positions");
  __shared__ __align__(16) float qs[GT][D];
  __shared__ __align__(16) float vs[CH][D];
  __shared__ float ps[GT][CH];           // scores, then softmax weights
  __shared__ float ms[GT], ls[GT], as[GT];

  const int split = blockIdx.x;
  const int g = Hq / Hkv;
  const int htiles = (g + GT - 1) / GT;
  const int kvh = blockIdx.y / htiles;
  const int h0 = (blockIdx.y - kvh * htiles) * GT;
  const int gh = min(GT, g - h0);        // query heads of this block
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t hq0 = (size_t)b * Hq + (size_t)kvh * g + h0;  // first (b, q head) row

  const int len = max(0, min(lengths[b], S));
  // cut [0, len) into nsplit chunks of whole tiles; late splits may be empty
  const int per = ((len + nsplit - 1) / nsplit + CH - 1) / CH * CH;
  const int c0 = min(split * per, len);
  const int c1 = min(c0 + per, len);

  for (int e = tid; e < gh * D; e += THREADS) qs[e / D][e % D] = to_f(q[hq0 * D + e]);
  if (tid < GT) {
    ms[tid] = NEG;
    ls[tid] = 0.f;
  }
  float acc[OUTS];
#pragma unroll
  for (int i = 0; i < OUTS; ++i) acc[i] = 0.f;

  const int row = tid / TPR, lane = tid - (tid / TPR) * TPR;
  const size_t pstride = (size_t)Hkv * D;  // elements from one position to the next
  const T* kb = k + ((size_t)b * S * Hkv + kvh) * D + lane * VEC;
  const T* vb = v + ((size_t)b * S * Hkv + kvh) * D + lane * VEC;
  const int warp = tid / 32, wl = tid % 32;

  for (int t0 = c0; t0 < c1; t0 += CH) {
    const int n = min(CH, c1 - t0);  // valid rows of this tile
    __syncthreads();  // qs/ms ready; the previous tile's vs/ps no longer read
    // scores: each group of TPR threads holds one k row and reduces q.k for
    // every head of the block; its v row goes to shared memory
    for (int r = row; r < CH; r += RPP) {
      float kr[VEC], vr[VEC];
      const bool ok = r < n;
      if (ok) {
        load16(kb + (size_t)(t0 + r) * pstride, kr);
        load16(vb + (size_t)(t0 + r) * pstride, vr);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kr[i] = vr[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) vs[r][lane * VEC + i] = vr[i];
      for (int j = 0; j < gh; ++j) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) s = fmaf(qs[j][lane * VEC + i], kr[i], s);
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) ps[j][r] = ok ? s * scale : NEG;
      }
    }
    __syncthreads();
    // online-softmax update, one warp per head
    for (int j = warp; j < gh; j += THREADS / 32) {
      const float s0 = wl < n ? ps[j][wl] : NEG;
      const float s1 = wl + 32 < n ? ps[j][wl + 32] : NEG;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ms[j];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = wl < n ? expf(s0 - m_new) : 0.f;
      const float p1 = wl + 32 < n ? expf(s1 - m_new) : 0.f;
      ps[j][wl] = p0;
      ps[j][wl + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (wl == 0) {
        const float alpha = expf(m_old - m_new);
        as[j] = alpha;
        ls[j] = ls[j] * alpha + sum;
        ms[j] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p . V for this thread's (head, d) outputs
#pragma unroll
    for (int i = 0; i < OUTS; ++i) {
      const int o = tid + i * THREADS;
      const int j = o / D, d = o - (o / D) * D;
      if (j < gh) {
        float a = acc[i] * as[j];
        for (int r = 0; r < n; ++r) a = fmaf(ps[j][r], vs[r][d], a);
        acc[i] = a;
      }
    }
  }

  // an empty split writes (m, l, acc) = (-1e30, 0, 0): the combine skips it
#pragma unroll
  for (int i = 0; i < OUTS; ++i) {
    const int o = tid + i * THREADS;
    const int j = o / D, d = o - (o / D) * D;
    if (j < gh) part_acc[((hq0 + j) * nsplit + split) * D + d] = acc[i];
  }
  if (tid < gh) {
    part_m[(hq0 + tid) * nsplit + split] = ms[tid];
    part_l[(hq0 + tid) * nsplit + split] = ls[tid];
  }
}

// out[b, hq, :] from the nsplit partials of (b, hq): one block of D threads.
template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_m,
                      const float* __restrict__ part_l, T* __restrict__ out, int nsplit) {
  const size_t rowi = blockIdx.x;
  const int d = threadIdx.x;
  const float* pm = part_m + rowi * nsplit;
  const float* pl = part_l + rowi * nsplit;
  const float* pa = part_acc + rowi * nsplit * D;
  float m = NEG;
  for (int i = 0; i < nsplit; ++i)
    if (pl[i] > 0.f) m = fmaxf(m, pm[i]);
  float l = 0.f, a = 0.f;
  for (int i = 0; i < nsplit; ++i) {
    if (pl[i] > 0.f) {
      const float w = expf(pm[i] - m);
      l = fmaf(pl[i], w, l);
      a = fmaf(pa[(size_t)i * D + d], w, a);
    }
  }
  out[rowi * D + d] = from_f<T>(a / fmaxf(l, 1e-30f));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           float* part_acc, float* part_m, float* part_l, void* out, int B, int Hq,
           int Hkv, int S, int nsplit, cudaStream_t stream) {
  const int htiles = (Hq / Hkv + GT - 1) / GT;
  const float scale = 1.0f / sqrtf((float)D);
  decode_partial_kernel<T, D><<<dim3(nsplit, Hkv * htiles, B), THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      part_acc, part_m, part_l, Hq, Hkv, S, nsplit, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T, D><<<B * Hq, D, 0, stream>>>(part_acc, part_m, part_l,
                                                        static_cast<T*>(out), nsplit);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const int* lengths,
               float* part_acc, float* part_m, float* part_l, void* out, int B, int Hq,
               int Hkv, int S, int D, int nsplit, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, lengths, part_acc, part_m, part_l, out, B, Hq, Hkv, S,
                           nsplit, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, part_acc, part_m, part_l, out, B, Hq, Hkv, S,
                            nsplit, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. part_acc [B*Hq*nsplit*D], part_m and
// part_l [B*Hq*nsplit] f32 scratch. Returns the cudaGetLastError() of the
// launches (0 on success).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const int* lengths, float* part_acc, float* part_m,
                                    float* part_l, void* out, int B, int Hq, int Hkv, int S,
                                    int D, int nsplit, int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || S <= 0 || nsplit <= 0 || Hq % Hkv != 0 ||
      B > 65535 || Hkv * ((Hq / Hkv + GT - 1) / GT) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, lengths, part_acc, part_m, part_l, out, B, Hq, Hkv, S,
                             D, nsplit, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, lengths, part_acc, part_m, part_l, out, B, Hq,
                                     Hkv, S, D, nsplit, s);
  return (int)cudaErrorInvalidValue;
}
