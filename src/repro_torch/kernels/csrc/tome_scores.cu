// ToMe bipartite scores with a streaming row (max, argmax), for Hopper
// (sm_90a), plain C interface for ctypes. Two routes, one semantics; the
// wrapper (kernels/tome_scores.py, route_for) picks one by the work of the
// call, B * Na * Nb.
//
// Replaces: src/repro/kernels/tome_scores.py::tome_scores (Pallas body
// `_kernel`), the matching step of every ToMe merge layer on the Janus main
// path (device and cloud partitions, padded and unpadded) and of dit-s2's
// Janus forward.
//
// Semantics: a [B, Na, D], b [B, Nb, D], both f32 and L2-normalized by the
// caller, contiguous and 16-byte aligned; scores a . b^T are reduced to
// node_max [B, Na] f32 and node_idx [B, Na] int32 without materializing
// [Na, Nb]. Ties go to the first index (the Pallas kernel's argmax within a
// tile plus strict '>' across tiles is the first occurrence of the row max).
// Optional nb_len [B] int32: columns at or past nb_len[b] are -inf, which is
// how the port computes the pad-column mask of tome_merge_padded (pads sit
// at the tail, so the mask over the B set is a valid count). A row with no
// valid column returns (-inf, 0), as argmax over an all -inf row does.
//
// Arithmetic, both routes: each score is one f32 fmaf chain over d in
// ascending order from 0, so the two routes give bit-equal (max, index).
// No tensor cores: TF32 keeps ~3 decimal digits, far outside the kernel's
// tolerance (atol 2e-5), and would flip argmaxes against the f32 scores of
// the plain version, so the f32 whole path's merge indices would no longer
// be identical; a 3xTF32 split keeps the accuracy but moves scores by ulps,
// which flips near-tie merges on a path that compares merge indices.
//
// Small-grid route (tome_scores_kernel): the ViT's calls. At the main path's
// largest call (Na 289, Nb 288, D 64) a batch member reads ~148 KB and does
// 10.7 MFLOP; at B=8 that is 85 MFLOP, 1.3 us at the 67 TFLOP/s f32
// CUDA-core peak, and 1.2 MB, 0.4 us at 3.35 TB/s: both below a launch
// (~2 us queued back to back), so a call's time is latency: the launch, one
// round trip of the loads, the merge and the stores, and how many FMA chains
// each SM has to hide its own latency. It is not launch-bound either: one
// thread per row of a (2 warps on each of 5-40 SMs, 18,432 FMAs a thread in
// chains that nothing hides) takes ~80 us.
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
// At dit-s2's merges (a [4,2048,64] x b [4,2048,64], 2.15 GFLOP, 32 us at
// the f32 peak) the same design reached 0.24-0.28 of that peak: shared-memory
// wavefronts pace its FMAs about one for one.
//
// Large-grid route (tome_scores_large_kernel<D>, D 64 and 128): calls whose
// work the FMAs bound, dit-s2's merges first. Design, an SGEMM's:
//   - one block per (32 rows of a, batch member): 4 consumer warps and a
//     producer warp, two blocks an SM at D=64 (one at D=128, whose a rows
//     take twice the shared memory). The producer's lane 0 copies the
//     block's a rows once and streams b in stages of 256 columns x 32 values
//     of d by TMA, from 3-D tensor maps over (D, Na, B) and (D, Nb, B) (so
//     no box crosses into the next batch member; rows past Na or Nb land as
//     zeros), into a 3-stage mbarrier ring (full/empty). Boxes land in the
//     128-byte swizzle: 16-byte piece c of row r at c ^ (r % 8).
//   - each consumer thread holds an 8 x 8 register tile of scores: rows
//     ty + 4i and columns tx + 32j of the pass (ty 0..3, tx 0..31; a warp
//     is 2 values of ty by 16 of tx). Per 4 values of d a thread reads 8
//     float4 of a and 8 of b and does 256 FMAs; a load of a is 2 rows for
//     the warp (one wavefront), a load of b 16 rows read by both halves of
//     the warp (two wavefronts, the swizzle spreading the 16 rows over the
//     banks): ~24 wavefronts per 256 FMA cycles of a warp, so the FMAs, not
//     the wavefronts, set the pace.
//   - after a pass's last stage each thread folds its 64 scores into a
//     running (max, first index) per row (columns ascending, strict '>',
//     columns past nb_len skipped); at the end the 16 threads of a half-warp
//     that share a row merge by shuffles, the two warps that share it
//     through shared memory, by (score descending, index ascending).
#include <math.h>

#include "hopper.cuh"

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


namespace large {

constexpr int RT = 4;                 // row threads: a thread's rows are ty + RT * i
constexpr int CT = 32;                // column threads: its columns tx + CT * j
constexpr int TM = 8, TN = 8;         // a thread's register tile of scores
constexpr int BM = RT * TM;           // rows of a a block
constexpr int BN = CT * TN;           // columns of b a pass
constexpr int KC = 32;                // values of d a staged chunk: one 128-byte row
constexpr int STAGES = 3;             // b ring depth
constexpr int CONSUMERS = RT * CT;    // consumer threads (4 warps)
constexpr int THREADS = CONSUMERS + 32;  // then the producer warp
constexpr int A_PANEL = BM * 128;     // a's rows, one chunk of d
constexpr int B_STAGE = BN * 128;     // one stage of b: a pass's columns, one chunk of d

// a's panels | STAGES b stages | full[STAGES], empty[STAGES], resident; tile
// regions start on 1024 bytes (the swizzle's period)
template <int D>
struct Cfg {
  static constexpr int NCH = D / KC;  // chunks of d
  static constexpr int RING = NCH * A_PANEL;
  static constexpr int BAR = RING + STAGES * B_STAGE;
  static constexpr int BYTES = BAR + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
};

struct Params {
  CUtensorMap a, b;  // boxes of [1, BM or BN rows, KC]
  const int* nb_len;
  float* out_max;
  int* out_idx;
  int Na, Nb;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
tome_scores_large_kernel(const __grid_constant__ Params p) {
  using C = Cfg<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bar = base + C::BAR;  // full[STAGES], empty[STAGES], resident
  const uint32_t resident = bar + 16 * STAGES;
  __shared__ float red_max[2][BM];
  __shared__ int red_idx[2][BM];

  const int batch = blockIdx.y, r0 = blockIdx.x * BM;
  int nb_end = p.Nb;
  if (p.nb_len != nullptr) nb_end = min(p.Nb, max(p.nb_len[batch], 0));
  const int n_steps = (nb_end + BN - 1) / BN * C::NCH;  // (pass, chunk) pairs

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar + 8 * s, 1);
      mbar_init(bar + 8 * (STAGES + s), CONSUMERS / 32);  // one arrival a consumer warp
    }
    mbar_init(resident, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == CONSUMERS / 32) {  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(resident, C::RING);
      for (int c = 0; c < C::NCH; ++c) tma_3d(base + c * A_PANEL, &p.a, resident, c * KC, r0, batch);
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(bar + 8 * (STAGES + s), (i / STAGES - 1) & 1);
        mbar_expect_tx(bar + 8 * s, B_STAGE);
        tma_3d(base + C::RING + s * B_STAGE, &p.b, bar + 8 * s, i % C::NCH * KC,
               i / C::NCH * BN, batch);
      }
    }
    return;
  }

  const int ty = 2 * (warp & 1) + (lane >> 4), tx = 16 * (warp >> 1) + (lane & 15);
  float best[TM], s[TM][TN];
  int best_i[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = -INFINITY;
    best_i[i] = 0;
#pragma unroll
    for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
  }

  mbar_wait(resident, 0);
  const int bx = tx & 7;  // the swizzle of each of the thread's b rows
#pragma unroll 1
  for (int i = 0; i < n_steps; ++i) {
    const int st = i % STAGES, ch = i % C::NCH;
    mbar_wait(bar + 8 * st, (i / STAGES) & 1);
    const unsigned char* at = gbase + ch * A_PANEL + ty * 128;
    const unsigned char* bt = gbase + C::RING + st * B_STAGE + tx * 128;
#pragma unroll 2
    for (int q = 0; q < KC / 4; ++q) {  // 4 values of d: every score's chain in d order
      float4 av[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r)  // row ty + RT * r; (ty + RT * r) % 8 = ty + RT * (r % 2)
        av[r] = *reinterpret_cast<const float4*>(at + RT * r * 128 +
                                                 ((q ^ (ty + RT * (r & 1))) << 4));
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 bv = *reinterpret_cast<const float4*>(bt + CT * j * 128 + ((q ^ bx) << 4));
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          s[r][j] = fmaf(av[r].x, bv.x, s[r][j]);
          s[r][j] = fmaf(av[r].y, bv.y, s[r][j]);
          s[r][j] = fmaf(av[r].z, bv.z, s[r][j]);
          s[r][j] = fmaf(av[r].w, bv.w, s[r][j]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar + 8 * (STAGES + st));  // this warp is done with the stage
    if (ch == C::NCH - 1) {  // the pass's scores are complete: columns ascend, strict '>'
      const int c0 = i / C::NCH * BN + tx;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = c0 + CT * j;
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          if (col < nb_end && s[r][j] > best[r]) {
            best[r] = s[r][j];
            best_i[r] = col;
          }
          s[r][j] = 0.f;
        }
      }
    }
  }

  // merge the 16 threads of a half-warp (one ty), then the two warps that
  // share a ty, by (score desc, index asc)
#pragma unroll
  for (int r = 0; r < TM; ++r) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, best[r], off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i[r], off);
      take_better(os, oi, best[r], best_i[r]);
    }
  }
  if ((lane & 15) == 0) {
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      red_max[warp >> 1][ty + RT * r] = best[r];
      red_idx[warp >> 1][ty + RT * r] = best_i[r];
    }
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS) : "memory");  // the consumers only
  const int t = threadIdx.x;
  if (t < BM && r0 + t < p.Na) {
    float m = red_max[0][t];
    int idx = red_idx[0][t];
    take_better(red_max[1][t], red_idx[1][t], m, idx);
    p.out_max[(size_t)batch * p.Na + r0 + t] = m;
    p.out_idx[(size_t)batch * p.Na + r0 + t] = idx;
  }
}

template <int D>
cudaError_t prepare() {  // shared memory above 48 KB, once an instantiation
  static const cudaError_t err = cudaFuncSetAttribute(
      tome_scores_large_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::BYTES);
  return err;
}

// [B, N, D] f32 in boxes of [1, rows, KC]
int map_f32(EncodeTiled enc, CUtensorMap* m, const float* ptr, int B, int N, int D, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 4, (cuuint64_t)N * D * 4};
  const cuuint32_t box[3] = {KC, (cuuint32_t)rows, 1};
  return map_tiled(enc, m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, ptr, dims, strides, box);
}

template <int D>
int launch(const float* a, const float* b, const int* nb_len, float* out_max, int* out_idx,
           int B, int Na, int Nb, cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return ENCODE_FAILED + (int)CUDA_ERROR_NOT_FOUND;
  Params p = {};
  int err = map_f32(enc, &p.a, a, B, Na, D, BM);
  err = err ? err : map_f32(enc, &p.b, b, B, Nb, D, BN);
  if (err != 0) return err;
  p.nb_len = nb_len;
  p.out_max = out_max;
  p.out_idx = out_idx;
  p.Na = Na, p.Nb = Nb;
  const cudaError_t set = prepare<D>();
  if (set != cudaSuccess) return (int)set;
  tome_scores_large_kernel<D><<<dim3((Na + BM - 1) / BM, B), THREADS, Cfg<D>::BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int occupancy(int* smem_bytes, int* blocks_per_sm) {
  const cudaError_t err = prepare<D>();
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = Cfg<D>::BYTES;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, tome_scores_large_kernel<D>, THREADS, Cfg<D>::BYTES);
}

}  // namespace large

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

// The large-grid route (D 64 or 128): the same arguments and semantics as
// tome_scores_fwd. Returns the cudaGetLastError() of the launch (0 on
// success), or ENCODE_FAILED (10000) + the CUresult of a tensor map that did
// not encode.
extern "C" int tome_scores_large_fwd(const float* a, const float* b, const int* nb_len,
                                     float* out_max, int* out_idx, int B, int Na, int Nb,
                                     int D, void* stream) {
  if (B <= 0 || Na <= 0 || Nb <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return large::launch<64>(a, b, nb_len, out_max, out_idx, B, Na, Nb, s);
    case 128: return large::launch<128>(a, b, nb_len, out_max, out_idx, B, Na, Nb, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The large-grid route's dynamic shared memory at head dim D and the blocks
// of it an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
// Returns the CUDA error (0 on success).
extern "C" int tome_scores_large_occupancy(int D, int* smem_bytes, int* blocks_per_sm) {
  switch (D) {
    case 64: return large::occupancy<64>(smem_bytes, blocks_per_sm);
    case 128: return large::occupancy<128>(smem_bytes, blocks_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}
