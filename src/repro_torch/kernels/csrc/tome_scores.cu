// ToMe bipartite scores with a streaming row (max, argmax), for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/tome_scores.py::tome_scores (Pallas body
// `_kernel`), the matching step of every ToMe merge layer on the Janus main
// path (device and cloud partitions, padded and unpadded).
//
// Semantics: a [B, Na, D], b [B, Nb, D], both f32 and L2-normalized by the
// caller; scores a . b^T are reduced to node_max [B, Na] f32 and node_idx
// [B, Na] int32 without materializing [Na, Nb]. Ties go to the first index
// (the Pallas kernel's argmax within a tile plus strict '>' across tiles is the
// first occurrence of the row max). Optional nb_len [B] int32: columns at or
// past nb_len[b] are -inf, which is how the port computes the pad-column mask
// of tome_merge_padded (pads sit at the tail, so the mask over the B set is a
// valid count). A row with no valid column returns (-inf, 0), as argmax over
// an all -inf row does.
//
// What bounds it on the H100: at the main path's largest call (Na 289,
// Nb 288, D 64) a batch member reads ~148 KB and does 10.7 MFLOP; at B=8 that
// is 85 MFLOP, 1.3 us at the 67 TFLOP/s f32 CUDA-core peak, and 1.2 MB, 0.4 us
// at 3.35 TB/s: both below a launch (~2 us queued back to back), so a call's
// time is latency: the launch, one round trip of the loads, the merge and the
// stores, and how many FMA chains each SM has to hide its own latency. It is
// not launch-bound either: one thread per row of a (2 warps on each of 5-40
// SMs, 18,432 FMAs a thread in chains that nothing hides) takes ~80 us.
//
// Design: fill the card in one wave, feed each FMA from registers, and put
// every load of a block in flight at once.
//   - one block per (8 G rows of a, batch member), G = 1..4 row groups picked
//     at launch: the smallest G whose grid fits the card's 132 SMs, so G = 1
//     (37 blocks) at B=1 and G = 3 (104 blocks) at B=8 at the path's shape;
//     fewer, taller blocks at B=8 also read b fewer times. A row group has
//     one warp per 64 columns of b, up to 8 (5 at Nb 288), and walks the
//     columns in passes of 64 per warp.
//   - each lane scores its group's 8 rows against 2 columns (lane and
//     lane + 32 of its warp's 64): 16 independent f32 FMA chains. Per 4
//     values of d it reads 8 float4 of a (the same for every lane:
//     broadcasts) and 2 float4 of b (its own rows), so each loaded b value
//     serves 8 FMAs and each a value 2, about one shared-memory wavefront per
//     FMA cycle of the SM.
//   - b streams through a 4-stage cp.async ring in chunks of 16 values of d
//     for every column of a pass (rows past nb_len zero-filled, never read;
//     rows padded by 16 bytes so that 8 lanes' float4s fall in 8 distinct
//     bank groups): at D=64 and Nb <= 512 all of b is in flight before the
//     first FMA, so one load latency is exposed, not one per chunk.
//   - each lane keeps a running (max, first index) per row; the lanes of a
//     warp, then the warps of a row group, merge by (score descending, index
//     ascending), which gives the first argmax whatever split of the columns
//     the threads take.
//
// Arithmetic: f32 FMAs on the CUDA cores, no tensor cores. TF32 keeps ~3
// decimal digits: far outside the kernel's tolerance (atol 2e-5), and it
// would flip argmaxes against the f32 scores of the plain version, so the f32
// whole path's merge indices would no longer be identical. A 3xTF32 split
// would keep the accuracy, but at 85 MFLOP there is nothing for it to win.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int RG = 8;        // rows of a per row group, all in each lane's registers
constexpr int MAXG = 4;      // row groups per block at most
constexpr int MAXW = 8;      // warps per row group at most
constexpr int CW = 64;       // columns per warp and pass
constexpr int SL = CW / 32;  // columns per lane: lane, lane + 32, ...
constexpr int DC = 16;       // values of d per staged chunk of b
constexpr int LDC = DC + 4;  // padded chunk row, in floats (16-byte multiple)
constexpr int STAGES = 4;    // b ring depth
constexpr int MAXT = 512;    // threads per block at most (128 registers a thread)
constexpr int SMS = 132;     // the H100's SMs

template <int D>
constexpr size_t smem_bytes(int groups, int warps) {
  return ((size_t)groups * RG * (D + 4) + (size_t)STAGES * warps * CW * LDC) * sizeof(float);
}

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

// (s, i) beats (best, best_i): a larger score, or an equal one at a smaller index
__device__ __forceinline__ void take_better(float s, int i, float& best, int& best_i) {
  if (s > best || (s == best && i < best_i)) {
    best = s;
    best_i = i;
  }
}

template <int D>
__global__ void __launch_bounds__(MAXT)
tome_scores_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const int* __restrict__ nb_len, float* __restrict__ out_max,
                   int* __restrict__ out_idx, int Na, int Nb, int warps) {
  constexpr int LDA = D + 4;
  constexpr int NCH = D / DC;  // chunks of d per pass
  constexpr int CHC = DC / 4;  // 16-byte copies per row of a chunk
  extern __shared__ __align__(16) float smem[];
  __shared__ float warp_max[MAXG * MAXW][RG];
  __shared__ int warp_idx[MAXG * MAXW][RG];

  const int pass_cols = warps * CW, bm = blockDim.x / (32 * warps) * RG;
  float* as = smem;              // [bm][LDA]
  float* bs = smem + bm * LDA;   // [STAGES][pass_cols][LDC]
  const int batch = blockIdx.y;
  const int r0 = blockIdx.x * bm;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wc = warp % warps, grp = warp / warps;  // column group, row group
  const float* ag = a + (size_t)batch * Na * D;
  const float* bg = b + (size_t)batch * Nb * D;

  int nb_end = Nb;
  if (nb_len != nullptr) nb_end = min(Nb, max(nb_len[batch], 0));
  const int n_steps = (nb_end + pass_cols - 1) / pass_cols * NCH;  // (pass, chunk) pairs

  auto load_step = [&](int step) {
    const int c0 = step / NCH * pass_cols, d0 = step % NCH * DC;
    float* dst = bs + (step % STAGES) * pass_cols * LDC;
    for (int c = tid; c < pass_cols * CHC; c += blockDim.x) {
      const int r = c / CHC, col = (c % CHC) * 4;
      const bool ok = c0 + r < nb_end;
      cp_async16(smem_u32(dst + r * LDC + col),
                 bg + (ok ? (size_t)(c0 + r) * D + d0 + col : 0), ok);
    }
  };

  // prologue: the a tile (rows past Na zero) with step 0 in group 0, then one
  // group per further stage
  for (int c = tid; c < bm * (D / 4); c += blockDim.x) {
    const int r = c / (D / 4), col = (c % (D / 4)) * 4;
    const bool ok = r0 + r < Na;
    cp_async16(smem_u32(as + r * LDA + col), ag + (ok ? (size_t)(r0 + r) * D + col : 0), ok);
  }
#pragma unroll
  for (int i = 0; i < STAGES; ++i) {
    if (i < n_steps) load_step(i);
    cp_async_commit();
  }

  float best[RG];
  int best_i[RG];
  float s[RG][SL];
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    best[r] = -INFINITY;
    best_i[r] = 0;
#pragma unroll
    for (int j = 0; j < SL; ++j) s[r][j] = 0.f;
  }

#pragma unroll 1
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<STAGES - 1>();  // group `step` has landed
    __syncthreads();
    const int ch = step % NCH;
    const int c0 = step / NCH * pass_cols + wc * CW;  // this warp's first column
    if (c0 < nb_end) {  // warp-uniform: the warp holds a valid column
      const float* bt = bs + (step % STAGES) * pass_cols * LDC + (wc * CW + lane) * LDC;
      const float* at = as + grp * RG * LDA + ch * DC;
#pragma unroll
      for (int d = 0; d < DC; d += 4) {
        float4 bv[SL];
#pragma unroll
        for (int j = 0; j < SL; ++j) bv[j] = *reinterpret_cast<const float4*>(bt + 32 * j * LDC + d);
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          const float4 av = *reinterpret_cast<const float4*>(at + r * LDA + d);
#pragma unroll
          for (int j = 0; j < SL; ++j) {
            s[r][j] = fmaf(av.x, bv[j].x, s[r][j]);
            s[r][j] = fmaf(av.y, bv[j].y, s[r][j]);
            s[r][j] = fmaf(av.z, bv[j].z, s[r][j]);
            s[r][j] = fmaf(av.w, bv[j].w, s[r][j]);
          }
        }
      }
      if (ch == NCH - 1) {  // the pass's scores are complete
        // columns rise with the pass and the slot, so strict '>' keeps the first
#pragma unroll
        for (int j = 0; j < SL; ++j) {
          const int col = c0 + lane + 32 * j;
#pragma unroll
          for (int r = 0; r < RG; ++r) {
            if (col < nb_end && s[r][j] > best[r]) {
              best[r] = s[r][j];
              best_i[r] = col;
            }
            s[r][j] = 0.f;
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (step + STAGES < n_steps) load_step(step + STAGES);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // merge the lanes of each warp, then the warps of a row group, by
  // (score desc, index asc)
#pragma unroll
  for (int r = 0; r < RG; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, best[r], off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i[r], off);
      take_better(os, oi, best[r], best_i[r]);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      warp_max[warp][r] = best[r];
      warp_idx[warp][r] = best_i[r];
    }
  }
  __syncthreads();
  if (tid < bm && r0 + tid < Na) {
    const int g0 = tid / RG * warps, r = tid % RG;  // first warp of the row's group
    float m = warp_max[g0][r];
    int i = warp_idx[g0][r];
    for (int w = 1; w < warps; ++w) take_better(warp_max[g0 + w][r], warp_idx[g0 + w][r], m, i);
    out_max[(size_t)batch * Na + r0 + tid] = m;
    out_idx[(size_t)batch * Na + r0 + tid] = i;
  }
}

template <int D>
int launch(const float* a, const float* b, const int* nb_len, float* out_max,
           int* out_idx, int B, int Na, int Nb, cudaStream_t stream) {
  static bool smem_set = false;  // once per instantiation (one card per process)
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        tome_scores_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<D>(MAXG, MAXW));
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int warps = min(MAXW, (Nb + CW - 1) / CW);
  int groups = 1;  // the fewest rows per block whose grid fits in one wave
  while (groups < MAXG && 32 * warps * (groups + 1) <= MAXT &&
         (long long)(Na + groups * RG - 1) / (groups * RG) * B > SMS)
    ++groups;
  const int bm = groups * RG;
  const dim3 grid((Na + bm - 1) / bm, B);
  tome_scores_kernel<D><<<grid, 32 * warps * groups, smem_bytes<D>(groups, warps), stream>>>(
      a, b, nb_len, out_max, out_idx, Na, Nb, warps);
  return (int)cudaGetLastError();
}

}  // namespace

// nb_len may be null. Returns the cudaGetLastError() of the launch.
extern "C" int tome_scores_fwd(const float* a, const float* b, const int* nb_len,
                               float* out_max, int* out_idx, int B, int Na, int Nb,
                               int D, void* stream) {
  if (B <= 0 || Na <= 0 || Nb <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(a, b, nb_len, out_max, out_idx, B, Na, Nb, s);
    case 32: return launch<32>(a, b, nb_len, out_max, out_idx, B, Na, Nb, s);
    case 64: return launch<64>(a, b, nb_len, out_max, out_idx, B, Na, Nb, s);
    case 128: return launch<128>(a, b, nb_len, out_max, out_idx, B, Na, Nb, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
