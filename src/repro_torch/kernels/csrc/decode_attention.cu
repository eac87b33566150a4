// Single-query GQA decode attention over a KV cache for Hopper (sm_90a), f32
// on the CUDA cores; plain C interface for ctypes.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention (Pallas
// body `_kernel`) for every f32 call (the f32 LM parities); bf16 calls run on
// csrc/decode_attention_mma.cu. f32 stays off the tensor cores, where it
// would be TF32.
//
// Semantics (those of decode_attention_ref, src/repro_torch/kernels/ref.py):
//   q [B, Hq, D]; k, v [B, S, Hkv, D] (the cache layout, fixed capacity S),
//   contiguous f32, each 16-byte aligned; lengths [B] int32 on the device:
//   keys at or past lengths[b] are masked and never read. q head h reads kv
//   head h / (Hq / Hkv). Scale 1/sqrt(D); scores, running (m, l) and the
//   accumulator in f32; the output is acc / max(l, 1e-30). A row with length
//   0 outputs 0, as the Pallas kernel does (its jnp oracle gives NaN).
//
// What bounds it on the H100: bytes. It reads the valid part of the cache
// once (B * length * Hkv * D * 2 floats) and does 4 flops per float per
// query head of the group, 6 flops a byte at group 12: at the f32 LM path's
// shape (B=8, Hq=24, Hkv=2, D=128, length 1088) 17.8 MB, 5.3 us at 3.35
// TB/s, against 0.11 GFLOP (1.6 us at the 67 TFLOP/s f32 peak). So the
// kernel has to keep enough bytes in flight on every SM, and its arithmetic
// must run at about a third of the f32 peak without waiting on shared
// memory or shuffles.
//
// Design (split-K "FlashDecoding" on the CUDA cores):
//   - grid (split, kv head x head tile, b), 4 warps a block. A block serves
//     NH = 4 * HPL query heads of one kv head (HPL = 1..4 heads a lane, from
//     the group: 12 heads at starcoder2-3b, 8 at qwen3-moe; larger groups
//     take several head tiles).
//   - the cache axis is split across blocks. The split count comes from the
//     shapes alone (the wrapper's n_splits: at least 4 tiles of capacity a
//     split, about two blocks an SM); each block takes its share of the
//     valid tiles, [split * nt / nsplit, (split + 1) * nt / nsplit) of
//     nt = ceil(length / CH), from the device-side length, so the valid
//     tiles spread evenly over the splits and no split is empty while
//     nt >= nsplit.
//   - K/V tiles of CH = 32 positions stream through a 3-stage cp.async.cg
//     ring in dynamic shared memory (96 KB at D=128): two tiles are in flight
//     while one computes. Positions past the length are zero-filled (never
//     read from device memory).
//   - each warp owns 8 positions of every tile and carries its own online
//     softmax. Lane (hg, ds) = (lane / 8, lane % 8) holds q for HPL heads of
//     head group hg over the 16-byte chunks ds, ds + 8, ... of d in
//     registers, so the 8 lanes of a group read one row's 8 consecutive
//     chunks (no bank conflict) and the 4 groups read the same addresses.
//     q.k: each lane sums its chunks for the warp's 8 positions; a halving
//     exchange over the 8 lanes (3 rounds, 7 * HPL shuffles) leaves lane ds
//     with the full scores of position ds. p.V: a lane's (head, chunk)
//     outputs take the 8 weights by shuffle and each V row with one 16-byte
//     load a chunk: 4 * HPL FMAs a load, no shared-memory weights.
//   - the warps merge their (m, l, acc) in shared memory in warp order (a
//     warp whose max never left the -1e30 sentinel weighs 0), and the block
//     writes one partial a query head.
//   - the combine kernel, one block a (b, q head), stages that row's
//     partials in shared memory with cp.async (all loads in flight at once)
//     and sums the splits in split order, so repeated runs are bit-equal. It
//     is launched with programmatic stream serialization: its blocks start
//     as the split pass drains and wait (griddepcontrol.wait) until it has
//     finished and its writes are visible.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int NB = 8;             // positions a warp takes of each tile
constexpr int CH = NB * WARPS;    // cache positions a tile (the wrapper mirrors it)
constexpr int STAGES = 3;         // K/V ring depth
constexpr int MAX_SPLITS = 384;   // the combine stages every split's partial (195 KB at D=128)
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <int D>
struct Layout {
  static constexpr int TILE = CH * D;  // one K or V tile, floats
  static constexpr size_t BYTES = (size_t)2 * STAGES * TILE * sizeof(float);
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

__device__ __forceinline__ void fma4(float4& a, float w, const float4& x) {
  a.x = fmaf(w, x.x, a.x);
  a.y = fmaf(w, x.y, a.y);
  a.z = fmaf(w, x.z, a.z);
  a.w = fmaf(w, x.w, a.w);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// One round of the halving exchange over the lanes of a head group: of the
// 2 * HALF positions a lane holds, it keeps the upper HALF if its lane bit
// BIT is set, else the lower, each summed with the partner lane's copy.
template <int HALF, int BIT, int HPL>
__device__ __forceinline__ void halve(float (&sc)[NB / 2][HPL], bool up) {
#pragma unroll
  for (int pi = 0; pi < HALF; ++pi)
#pragma unroll
    for (int h = 0; h < HPL; ++h) {
      const float send = up ? sc[pi][h] : sc[pi + HALF][h];
      const float keep = up ? sc[pi + HALF][h] : sc[pi][h];
      sc[pi][h] = keep + __shfl_xor_sync(FULL, send, BIT);
    }
}

// Partial attention of one split of the cache for up to NH = 4 * HPL query
// heads of one kv head. Partials are indexed [(b * Hq + hq) * nsplit +
// split]; a split without a valid position writes (m, l, acc) = (-1e30, 0,
// 0), which the combine skips.
template <int D, int HPL>
__global__ void __launch_bounds__(THREADS, 2)
decode_partial_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const int* __restrict__ lengths,
                      float* __restrict__ part_acc, float* __restrict__ part_m,
                      float* __restrict__ part_l, int Hq, int Hkv, int S, int nsplit,
                      float scale) {
  constexpr int NH = 4 * HPL;     // query heads a block
  constexpr int CJ = D / 32;      // 16-byte chunks a lane holds of a row
  constexpr int CHK = D / 4;      // 16-byte chunks a row
  constexpr int TILE = Layout<D>::TILE;
  static_assert(CH * CHK % THREADS == 0, "tile copy shape");
  static_assert((WARPS * NH * D + 3 * WARPS * NH) * sizeof(float) <= Layout<D>::BYTES,
                "merge buffers fit in the ring");
  extern __shared__ __align__(16) float smem[];  // ks [STAGES][CH][D], vs likewise
  float* ks = smem;
  float* vs = smem + STAGES * TILE;

  const int split = blockIdx.x;
  const int g = Hq / Hkv;
  const int htiles = (g + NH - 1) / NH;
  const int kvh = blockIdx.y / htiles;
  const int h0 = (blockIdx.y - kvh * htiles) * NH;
  const int gh = min(NH, g - h0);  // query heads of this block
  const int b = blockIdx.z;
  const size_t hq0 = (size_t)b * Hq + (size_t)kvh * g + h0;  // first (b, q head) row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hg = lane >> 3, ds = lane & 7;  // head group, chunk slot

  const int len = max(0, min(lengths[b], S));
  const int nt = (len + CH - 1) / CH;
  const int tile_lo = (int)((long long)split * nt / nsplit);
  const int n_tiles = (int)((long long)(split + 1) * nt / nsplit) - tile_lo;

  const size_t pstride = (size_t)Hkv * D;  // floats from one position to the next
  const float* kg = k + ((size_t)b * S * Hkv + kvh) * D;
  const float* vg = v + ((size_t)b * S * Hkv + kvh) * D;

  auto load_tile = [&](int i) {
    const int p0 = (tile_lo + i) * CH, st = i % STAGES;
#pragma unroll
    for (int j = 0; j < CH * CHK / THREADS; ++j) {
      const int c = tid + j * THREADS, r = c / CHK, col = (c % CHK) * 4;
      const bool ok = p0 + r < len;
      const size_t off = ok ? (size_t)(p0 + r) * pstride + col : 0;
      cp_async16(smem_u32(ks + st * TILE + r * D + col), kg + off, ok);
      cp_async16(smem_u32(vs + st * TILE + r * D + col), vg + off, ok);
    }
  };

#pragma unroll
  for (int i = 0; i < STAGES; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }

  // q of this lane's heads over its chunks (heads past the group zero)
  float4 qr[HPL][CJ];
#pragma unroll
  for (int h = 0; h < HPL; ++h) {
    const int hh = hg * HPL + h;
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      qr[h][j] = hh < gh
          ? *reinterpret_cast<const float4*>(q + (hq0 + hh) * D + 4 * (8 * j + ds))
          : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  float4 acc[HPL][CJ];
  float m[HPL], l[HPL];  // l: this lane's positions only, summed at the end
#pragma unroll
  for (int h = 0; h < HPL; ++h) {
    m[h] = NEG;
    l[h] = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[h][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

#pragma unroll 1
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<STAGES - 1>();  // group i has landed
    __syncthreads();
    const int st = i % STAGES;
    const float* kt = ks + st * TILE + warp * NB * D;
    const float* vt = vs + st * TILE + warp * NB * D;

    // q.k over this lane's chunks for the warp's NB positions: positions pi
    // and pi + 4 together, halved at once over lane bit 4, so that 4 * HPL
    // partial sums stay live; then bits 2 and 1 leave lane ds position ds
    const bool up4 = ds & 4;
    float sc[NB / 2][HPL];
#pragma unroll
    for (int pi = 0; pi < NB / 2; ++pi) {
      float lo[HPL], hi[HPL];
#pragma unroll
      for (int h = 0; h < HPL; ++h) lo[h] = hi[h] = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float4 kl = *reinterpret_cast<const float4*>(kt + pi * D + 4 * (8 * j + ds));
        const float4 kh =
            *reinterpret_cast<const float4*>(kt + (pi + NB / 2) * D + 4 * (8 * j + ds));
#pragma unroll
        for (int h = 0; h < HPL; ++h) {
          lo[h] = dot4(qr[h][j], kl, lo[h]);
          hi[h] = dot4(qr[h][j], kh, hi[h]);
        }
      }
#pragma unroll
      for (int h = 0; h < HPL; ++h)
        sc[pi][h] = (up4 ? hi[h] : lo[h]) + __shfl_xor_sync(FULL, up4 ? lo[h] : hi[h], 4);
    }
    halve<2, 2>(sc, ds & 2);
    halve<1, 1>(sc, ds & 1);

    // online softmax: the group's max over its 8 positions
    const bool valid = (tile_lo + i) * CH + warp * NB + ds < len;
    float p[HPL];
#pragma unroll
    for (int h = 0; h < HPL; ++h) {
      const float s = valid ? sc[0][h] * scale : NEG;
      float mx = s;
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      const float mn = fmaxf(m[h], mx);
      const float alpha = expf(m[h] - mn);
      p[h] = valid ? expf(s - mn) : 0.f;
      l[h] = fmaf(l[h], alpha, p[h]);
      m[h] = mn;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        acc[h][j].x *= alpha;
        acc[h][j].y *= alpha;
        acc[h][j].z *= alpha;
        acc[h][j].w *= alpha;
      }
    }

    // acc += p.V: position pi's weights come from lane (hg, pi)
#pragma unroll
    for (int pi = 0; pi < NB; ++pi) {
      float w[HPL];
#pragma unroll
      for (int h = 0; h < HPL; ++h) w[h] = __shfl_sync(FULL, p[h], (lane & ~7) | pi);
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(vt + pi * D + 4 * (8 * j + ds));
#pragma unroll
        for (int h = 0; h < HPL; ++h) fma4(acc[h][j], w[h], vv);
      }
    }

    __syncthreads();  // every warp is done with this stage
    if (i + STAGES < n_tiles) load_tile(i + STAGES);
    cp_async_commit();
  }
  cp_async_wait<0>();
  // the combine may start its blocks now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // merge the warps' (m, l, acc) over the ring: os [WARPS][NH][D], then the
  // warps' m, l and weights [WARPS][NH]
#pragma unroll
  for (int h = 0; h < HPL; ++h) {
    l[h] += __shfl_xor_sync(FULL, l[h], 4);
    l[h] += __shfl_xor_sync(FULL, l[h], 2);
    l[h] += __shfl_xor_sync(FULL, l[h], 1);
  }
  __syncthreads();  // no warp reads the ring any more
  float* os = smem;
  float* wm = os + WARPS * NH * D;
  float* wl = wm + WARPS * NH;
  float* ww = wl + WARPS * NH;
#pragma unroll
  for (int h = 0; h < HPL; ++h) {
    const int r = warp * NH + hg * HPL + h;
    if (ds == 0) {
      wm[r] = m[h];
      wl[r] = l[h];
    }
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      *reinterpret_cast<float4*>(os + r * D + 4 * (8 * j + ds)) = acc[h][j];
  }
  __syncthreads();
  if (tid < gh) {
    float mb = NEG, lb = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      if (wm[w * NH + tid] > 0.5f * NEG) mb = fmaxf(mb, wm[w * NH + tid]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float x = wm[w * NH + tid];
      const float wt = x > 0.5f * NEG ? expf(x - mb) : 0.f;
      ww[w * NH + tid] = wt;
      lb = fmaf(wl[w * NH + tid], wt, lb);
    }
    part_m[(hq0 + tid) * nsplit + split] = mb;
    part_l[(hq0 + tid) * nsplit + split] = lb;
  }
  __syncthreads();
  for (int e = tid; e < gh * D; e += THREADS) {
    const int r = e / D, d = e - (e / D) * D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a = fmaf(os[(w * NH + r) * D + d], ww[w * NH + r], a);
    part_acc[((hq0 + r) * nsplit + split) * D + d] = a;
  }
}

// Dynamic shared memory of the combine: the splits' weights and l, padded to
// 16 bytes, then every split's partial accumulator of the row.
template <int D>
size_t combine_bytes(int nsplit) {
  const int pad = (nsplit + 3) / 4 * 4;
  return ((size_t)2 * pad + (size_t)nsplit * D) * sizeof(float);
}

// out[b, hq, :] from the nsplit partials of (b, hq): one block of D
// threads. The row's partial accumulators are staged in shared memory by
// cp.async while the splits' max and weights are computed; then each thread
// sums its column over the splits in split order.
template <int D>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_m,
                      const float* __restrict__ part_l, float* __restrict__ out, int nsplit) {
  extern __shared__ __align__(16) float cs[];
  __shared__ float red[D / 32];
  const int pad = (nsplit + 3) / 4 * 4;
  float* ws = cs;            // [nsplit] weights
  float* ls = cs + pad;      // [nsplit] l
  float* stage = cs + 2 * pad;  // [nsplit][D]
  // the split pass's writes are visible after this (a no-op without PDL)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t rowi = blockIdx.x;
  const int t = threadIdx.x;
  const float* pm = part_m + rowi * nsplit;
  const float* pl = part_l + rowi * nsplit;
  const float* pa = part_acc + rowi * nsplit * D;
  for (int c = t; c < nsplit * D / 4; c += D)
    cp_async16(smem_u32(stage + 4 * c), pa + 4 * c, true);
  cp_async_commit();

  float m = NEG;  // splits without a valid position (l = 0) are skipped
  for (int i = t; i < nsplit; i += D)
    if (pl[i] > 0.f) m = fmaxf(m, pm[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
  if ((t & 31) == 0) red[t >> 5] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < D / 32; ++w) m = fmaxf(m, red[w]);
  for (int i = t; i < nsplit; i += D) {
    const float li = pl[i];
    ws[i] = li > 0.f ? expf(pm[i] - m) : 0.f;
    ls[i] = li;
  }
  cp_async_wait<0>();
  __syncthreads();
  float l = 0.f, a = 0.f;
#pragma unroll 4
  for (int i = 0; i < nsplit; ++i) {
    const float w = ws[i];
    l = fmaf(ls[i], w, l);
    a = fmaf(stage[i * D + t], w, a);
  }
  out[rowi * D + t] = a / fmaxf(l, 1e-30f);
}

// query heads a lane serves for a group of g heads: NH = 4 * hpl a block
int heads_per_lane(int g) { return g > 12 ? 4 : (g + 3) / 4; }

template <int D, int HPL>
cudaError_t prepare() {
  static bool smem_set = false;  // once per instantiation (one card per process)
  if (smem_set) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      decode_partial_kernel<D, HPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Layout<D>::BYTES);
  if (err == cudaSuccess) smem_set = true;
  return err;
}

template <int D>
int launch_combine(const float* part_acc, const float* part_m, const float* part_l, float* out,
                   int rows, int nsplit, cudaStream_t stream) {
  static size_t smem_set = 48 * 1024;  // the default limit
  const size_t smem = combine_bytes<D>(nsplit);
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_combine_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)combine_bytes<D>(MAX_SPLITS));
    if (err != cudaSuccess) return (int)err;
    smem_set = combine_bytes<D>(MAX_SPLITS);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows);
  cfg.blockDim = dim3(D);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, decode_combine_kernel<D>, part_acc, part_m, part_l, out,
                                 nsplit);
}

template <int D, int HPL>
int launch(const float* q, const float* k, const float* v, const int* lengths, float* part_acc,
           float* part_m, float* part_l, float* out, int B, int Hq, int Hkv, int S, int nsplit,
           cudaStream_t stream) {
  const cudaError_t err = prepare<D, HPL>();
  if (err != cudaSuccess) return (int)err;
  const int htiles = (Hq / Hkv + 4 * HPL - 1) / (4 * HPL);
  decode_partial_kernel<D, HPL><<<dim3(nsplit, Hkv * htiles, B), THREADS, Layout<D>::BYTES,
                                  stream>>>(q, k, v, lengths, part_acc, part_m, part_l, Hq, Hkv,
                                            S, nsplit, 1.0f / sqrtf((float)D));
  const cudaError_t lerr = cudaGetLastError();
  if (lerr != cudaSuccess) return (int)lerr;
  const int cerr = launch_combine<D>(part_acc, part_m, part_l, out, B * Hq, nsplit, stream);
  return cerr != 0 ? cerr : (int)cudaGetLastError();
}

template <int D>
int dispatch_hpl(const float* q, const float* k, const float* v, const int* lengths,
                 float* part_acc, float* part_m, float* part_l, float* out, int B, int Hq,
                 int Hkv, int S, int nsplit, cudaStream_t stream) {
  switch (heads_per_lane(Hq / Hkv)) {
    case 1: return launch<D, 1>(q, k, v, lengths, part_acc, part_m, part_l, out, B, Hq, Hkv,
                                S, nsplit, stream);
    case 2: return launch<D, 2>(q, k, v, lengths, part_acc, part_m, part_l, out, B, Hq, Hkv,
                                S, nsplit, stream);
    case 3: return launch<D, 3>(q, k, v, lengths, part_acc, part_m, part_l, out, B, Hq, Hkv,
                                S, nsplit, stream);
    default: return launch<D, 4>(q, k, v, lengths, part_acc, part_m, part_l, out, B, Hq, Hkv,
                                 S, nsplit, stream);
  }
}

template <int D, int HPL>
int occupancy(int* smem_bytes, int* blocks_per_sm) {
  const cudaError_t err = prepare<D, HPL>();
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = (int)Layout<D>::BYTES;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, decode_partial_kernel<D, HPL>, THREADS, Layout<D>::BYTES);
}

template <int D>
int occupancy_hpl(int hpl, int* smem_bytes, int* blocks_per_sm) {
  switch (hpl) {
    case 1: return occupancy<D, 1>(smem_bytes, blocks_per_sm);
    case 2: return occupancy<D, 2>(smem_bytes, blocks_per_sm);
    case 3: return occupancy<D, 3>(smem_bytes, blocks_per_sm);
    case 4: return occupancy<D, 4>(smem_bytes, blocks_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// f32 only; D 64 or 128. part_acc [B*Hq*nsplit*D], part_m and part_l
// [B*Hq*nsplit] f32 scratch. Returns the CUDA error of the launches (0 on
// success).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const int* lengths, float* part_acc, float* part_m,
                                    float* part_l, void* out, int B, int Hq, int Hkv, int S,
                                    int D, int nsplit, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || S <= 0 || nsplit <= 0 || nsplit > MAX_SPLITS ||
      Hq % Hkv != 0 || B > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  switch (D) {
    case 64: return dispatch_hpl<64>(qf, kf, vf, lengths, part_acc, part_m, part_l, of, B, Hq,
                                     Hkv, S, nsplit, s);
    case 128: return dispatch_hpl<128>(qf, kf, vf, lengths, part_acc, part_m, part_l, of, B,
                                       Hq, Hkv, S, nsplit, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The split pass's dynamic shared memory at (D, heads a lane) and the blocks
// of it an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
// Returns the CUDA error (0 on success).
extern "C" int decode_attention_occupancy(int D, int hpl, int* smem_bytes, int* blocks_per_sm) {
  switch (D) {
    case 64: return occupancy_hpl<64>(hpl, smem_bytes, blocks_per_sm);
    case 128: return occupancy_hpl<128>(hpl, smem_bytes, blocks_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}
