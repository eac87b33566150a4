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
//   keys at or past lengths[b] are masked, and never read from device
//   memory. q head h reads kv head h / (Hq / Hkv). Scale 1/sqrt(D); scores,
//   running (m, l) and the accumulator in f32; the output is acc / max(l,
//   1e-30) rounded once to bf16 (nearest even); length 0 outputs 0.
//   Rounding points that differ from the plain version: the softmax weights
//   P are rounded to bf16 before P.V (the tensor cores' A operand); l sums
//   the f32 weights. Scores are kept in log2 units (scale times log2 e) so
//   that exp2f does the exponentials, and the partial m is stored in those
//   units.
//
// What bounds it on the H100: bytes. It reads the valid part of the cache
// once (B * length * Hkv * D * 2 elements) and does 4 flops per element per
// query head of the group: at the serving path's shape (B=8, Hq=24, Hkv=2,
// D=128, length 1088) 8.9 MB, 2.7 us at 3.35 TB/s, against 0.14 GFLOP (0.14
// us at the bf16 tensor-core peak). A block serves at most 16 query heads
// (12 at starcoder2-3b), well below wgmma's 64 rows, and the tensor cores
// are nowhere near the bound, so the two products stay on mma.sync.m16n8k16;
// what the design is about is bytes in flight and one launch a call.
//
// Design (FlashDecoding in one launch, loads by TMA):
//   - grid (split, kv head x head tile, b); 4 consumer warps and a producer
//     warp. The query heads of one kv head form the mma A operand: a tile of
//     16 rows (12 at starcoder2-3b, 2 at internlm2, zero-padded; larger
//     groups take several head tiles).
//   - the cache axis is split across blocks. The split count comes from the
//     shapes alone (the wrapper's n_splits); each block cuts its share of the
//     valid tiles, [split * nt / nsplit, (split + 1) * nt / nsplit) of
//     nt = ceil(length / 64), from the device-side length, so the valid
//     tiles spread evenly over the splits.
//   - the producer's lane 0 streams K/V tiles of 64 positions by TMA from
//     4-D tensor maps over the cache as (D, Hkv, S, B) (the wrapper caches
//     the encoded maps by pointer, shape and stride: the cache buffers keep
//     their address from step to step) into an mbarrier ring (full/empty)
//     in the 128-byte swizzle, which ldmatrix reads without bank conflicts
//     (16-byte piece c of row r at c ^ (r % 8)). The ring holds 96 KB (3 K/V
//     pairs at D=128, 6 at D=64; two blocks an SM); a block's share at the
//     path shapes (4-5 tiles at D=128, 8-9 at D=64) refills it as tiles
//     free. A 192 KB ring that held the whole share before the first product
//     (one block an SM) ran no faster there and slower where the grid passes
//     one block an SM (tools/decode_mma_ablations.py, ring192). The tile
//     that holds the length is copied by the producer's lanes with cp.async
//     instead, positions past the length zero-filled and never read.
//   - each consumer warp owns 16 positions of every tile: S = Q.K^T (16 heads
//     x 16 positions) by mma.sync.m16n8k16 with K fragments from ldmatrix;
//     the online softmax runs in registers with quad shuffles; O += P.V
//     reuses the S accumulators, rounded to bf16, as the A fragment, with V
//     fragments from ldmatrix.trans. Each warp carries its own (m, l, O); the
//     warps merge in shared memory (a warp whose running max never left the
//     -1e30 sentinel holds junk and weighs 0).
//   - one split: the block writes the output. Several: the splits of one
//     (b, kv head, head tile) run as thread block clusters of up to 8 (the
//     portable size), so the split count is a power of two. Rank j of a
//     cluster owns a slice of the output's float4 columns; every rank
//     pushes its partial of each slice, with its (m, l), into the owner's
//     shared memory over distributed shared memory and arrives on the
//     owner's mbarrier (release at cluster scope), and each owner merges the
//     ranks' parts in rank (= split) order once all have arrived: with 8
//     splits or fewer that is the output, and no partial touches device
//     memory. A long cache's clusters each write their partial of each
//     slice; the last block to finish a slice (an atomic counter per (b, kv
//     head, head tile, slice) in a scratch buffer the wrapper allocates once
//     per device and stream; that block resets it to 0) combines the
//     clusters' partials of it in cluster order, each of its threads with
//     every load in flight at once. Every sum has a fixed order, so two runs
//     are bit-equal. On the H100 (tools/decode_mma_ablations.py) the split
//     pass alone, returning before any combine, takes 0.0067-0.0075 ms
//     queued at the LM decode shapes, and the cluster launch and the combine
//     add 1.6-3.6 us; ranks that pulled each other's partials (a cluster
//     barrier, remote loads, a second barrier before leaving) and a last
//     block that combined every split through device memory (a fence, an
//     atomic and round trips to L2 after the slowest block) were slower.
#include <math.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int WARPS = 4;                   // consumer warps
constexpr int THREADS = 32 * WARPS + 32;   // then the producer warp
constexpr int CH = 64;      // cache positions per tile (the wrapper mirrors it)
constexpr int PW = CH / WARPS;  // positions per warp and tile: one k-step of P.V
constexpr int GT = 16;      // query heads per block (the wrapper mirrors it)
constexpr int MAX_SPLITS = 128;  // splits a call at most
constexpr int MAX_CLUSTER = 8;   // splits a cluster at most (the portable cluster size)
constexpr int MAX_CLUSTERS = MAX_SPLITS / MAX_CLUSTER;  // clusters a (b, kv head, head tile)
static_assert(PW == 16, "a warp's positions are one m16n8k16 k-step");

// ring (STAGES x (K, V) tiles, 1024-byte aligned) | Q [GT][LDQ] | what the
// cluster's ranks push of this block's slice: their accumulators, their
// (m, l) | full[STAGES], empty[STAGES], pushed; the warps' merge buffer
// reuses the ring once every tile is consumed
template <int D>
struct Cfg {
  static constexpr int NP = D / PANEL;          // 128-byte panels a row
  static constexpr int PANEL_BYTES = CH * 128;  // one panel of a tile
  static constexpr int TILE = NP * PANEL_BYTES;  // one K or V tile
  static constexpr int STAGES = D == 64 ? 6 : 3;  // 96 KB: two blocks an SM
  static constexpr int RING = STAGES * 2 * TILE;
  static constexpr int LDQ = D + 8;  // padded Q row, bf16: 8 ldmatrix rows in 8 bank groups
  static constexpr int RECV = RING + (GT * LDQ * 2 + 15) / 16 * 16;
  static constexpr int RECV_FLOATS = GT * D + MAX_CLUSTER * 4;  // every rank's part of a slice
  static constexpr int RECV_ML = RECV + RECV_FLOATS * 4;        // [MAX_CLUSTER][GT] (m, l)
  static constexpr int BAR = RECV_ML + MAX_CLUSTER * GT * 8;
  static constexpr int BYTES = BAR + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
  static_assert(WARPS * GT * D * 4 <= RING, "the warps' merge buffer fits");
};

struct Params {
  CUtensorMap k, v;  // the cache as (D, Hkv, S, B) in boxes of [1, 64, 1, 64]
  const bf16 *q, *k_raw, *v_raw;  // k_raw, v_raw: the cache, for the tile holding the length
  const int* lengths;
  float* part_acc;   // [(b * Hq + hq) * nsplit + split][D]
  float* part_m;     // [(b * Hq + hq) * nsplit + split]
  float* part_l;
  unsigned* counters;  // [B * Hkv * htiles * MAX_CLUSTER], 0 between launches
  bf16* out;
  int Hq, Hkv, S, nsplit;
  int cluster;  // blocks a cluster along the splits: min(nsplit, MAX_CLUSTER)
  float scale_log2;
};

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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// byte offset of 16-byte piece c (8 bf16 of the head dim) of row r in a
// swizzled tile
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * Cfg<D>::PANEL_BYTES + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// ---- thread block clusters: the splits of one (b, kv head, head tile)

// the cluster barrier in two halves: every thread arrives (after this
// block's mbarriers are initialised) early, and waits before its first push
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// shared address `addr` of this block, in the block of cluster rank `rank`
__device__ __forceinline__ uint32_t at_rank(uint32_t addr, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}

__device__ __forceinline__ void st_cluster4(uint32_t remote, float4 x) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(remote), "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w) : "memory");
}

__device__ __forceinline__ void st_cluster2(uint32_t remote, float x, float y) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n"
               :: "r"(remote), "f"(x), "f"(y) : "memory");
}

// one arrival on rank `rank`'s mbarrier at `bar`, releasing this thread's
// (and, after a block barrier, this block's) earlier writes to the cluster
__device__ __forceinline__ void mbar_arrive_at(uint32_t bar, int rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
               :: "r"(at_rank(bar, rank)) : "memory");
}

// mbar_wait with acquire at cluster scope: the pushes released by the
// arrivals are visible after it
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  auto test = [&] {
    uint32_t done;
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    return done != 0;
  };
  if (test()) return;
  const uint64_t t0 = global_ns();
  while (!test())
    if (global_ns() - t0 > 4000000000ull) __trap();
}

// n partials (m in log2 units, l, acc) merged in their order: the weights in
// the largest m of those with l > 0 (a partial with l = 0 saw no position
// and weighs 0), l and acc summed; returns acc, with the max in mb and the
// sum in lb
template <int N>
__device__ __forceinline__ float4 combine(int n, const float (&m)[N], const float (&l)[N],
                                          const float4 (&x)[N], float& mb, float& lb) {
  mb = NEG;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < n && l[j] > 0.f) mb = fmaxf(mb, m[j]);
  lb = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j < n) {
      const float w = l[j] > 0.f ? exp2f(m[j] - mb) : 0.f;
      lb = fmaf(l[j], w, lb);
      a.x = fmaf(x[j].x, w, a.x);
      a.y = fmaf(x[j].y, w, a.y);
      a.z = fmaf(x[j].z, w, a.z);
      a.w = fmaf(x[j].w, w, a.w);
    }
  }
  return a;
}

// 4 outputs a / den as bf16 (nearest even), one 8-byte store
__device__ __forceinline__ void store_bf16x4(bf16* dst, float4 a, float den) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a.x / den, a.y / den);
  __nv_bfloat162 hi = __floats2bfloat162_rn(a.z / den, a.w / den);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
decode_mma_kernel(const __grid_constant__ Params p) {
  using C = Cfg<D>;
  constexpr int KS = D / 16;  // k-steps of Q.K^T
  constexpr int DB = D / 8;   // n-blocks of O (8 columns each)
  constexpr int CHK = D / 8;  // 16-byte pieces a row
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sQ = base + C::RING;
  const uint32_t bar = base + C::BAR;  // full[STAGES], empty[STAGES], pushed
  const uint32_t pushed = bar + 16 * C::STAGES;
  __shared__ float wm[WARPS][GT], wl[WARPS][GT], mrow[GT], lsum[GT];
  __shared__ int s_last;

  const int split = blockIdx.x;
  const int g = p.Hq / p.Hkv;
  const int htiles = (g + GT - 1) / GT;
  const int kvh = blockIdx.y / htiles;
  const int h0 = (blockIdx.y - kvh * htiles) * GT;
  const int gh = min(GT, g - h0);  // query heads of this block
  const int b = blockIdx.z;
  const size_t hq0 = (size_t)b * p.Hq + (size_t)kvh * g + h0;  // first (b, q head) row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t4 = lane & 3;  // fragment row group, thread in quad

  const int len = max(0, min(p.lengths[b], p.S));
  const int nt = (len + CH - 1) / CH;
  const int tile_lo = (int)((long long)split * nt / p.nsplit);
  const int n_tiles = (int)((long long)(split + 1) * nt / p.nsplit) - tile_lo;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar + 8 * s, 33);  // the TMA's expect_tx (or lane 0) and each producer lane
      mbar_init(bar + 8 * (C::STAGES + s), WARPS);  // one arrival a consumer warp
    }
    mbar_init(pushed, p.cluster);  // one arrival a rank of the cluster
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (p.nsplit > 1) cluster_arrive();  // waited for before the first push

  float o[DB][4];
#pragma unroll
  for (int db = 0; db < DB; ++db) o[db][0] = o[db][1] = o[db][2] = o[db][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // heads gq and gq + 8

  if (warp == WARPS) {  // the producer warp
    const size_t pstride = (size_t)p.Hkv * D;  // elements from one position to the next
    const size_t off0 = ((size_t)b * p.S * p.Hkv + kvh) * D;
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % C::STAGES, p0 = (tile_lo + i) * CH;
      if (i >= C::STAGES) mbar_wait(bar + 8 * (C::STAGES + st), (i / C::STAGES - 1) & 1);
      const uint32_t full = bar + 8 * st, sk = base + st * 2 * C::TILE, sv = sk + C::TILE;
      if (p0 + CH <= len) {  // a whole tile: TMA
        if (lane == 0) {
          mbar_expect_tx(full, 2 * C::TILE);
#pragma unroll
          for (int pp = 0; pp < C::NP; ++pp) {
            tma_4d(sk + pp * C::PANEL_BYTES, &p.k, full, pp * PANEL, kvh, p0, b);
            tma_4d(sv + pp * C::PANEL_BYTES, &p.v, full, pp * PANEL, kvh, p0, b);
          }
        }
      } else {  // the tile holding the length: positions past it zero-filled
        for (int c = lane; c < CH * CHK; c += 32) {
          const int r = c / CHK, pc = c % CHK;
          const bool ok = p0 + r < len;
          const size_t off = ok ? off0 + (size_t)(p0 + r) * pstride + pc * 8 : 0;
          cp_async16(sk + swz<D>(r, pc), p.k_raw + off, ok);
          cp_async16(sv + swz<D>(r, pc), p.v_raw + off, ok);
        }
        if (lane == 0) mbar_arrive(full);
      }
      cp_async_arrive(full);  // once the lane's copies (if any) land
    }
  } else if (n_tiles > 0) {  // the consumer warps
    const int tid = threadIdx.x;  // Q [GT][LDQ] bf16 after the ring, heads past the group zero
    for (int c = tid; c < GT * CHK; c += 32 * WARPS) {
      const int r = c / CHK, col = (c % CHK) * 8;
      const bool ok = r < gh;
      cp_async16(sQ + (r * C::LDQ + col) * 2, p.q + (ok ? (hq0 + r) * D + col : 0), ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    asm volatile("bar.sync 1, %0;\n" :: "n"(32 * WARPS) : "memory");  // the consumers only
    uint32_t qf[KS][4];  // Q as A fragments, once
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldsm_x4(sQ + ((lane & 15) * C::LDQ + kk * 16 + (lane >> 4) * 8) * 2, qf[kk]);

#pragma unroll 1
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % C::STAGES;
      mbar_wait(bar + 8 * st, (i / C::STAGES) & 1);
      const uint32_t kt = base + st * 2 * C::TILE, vt = kt + C::TILE;

      // S = Q.K^T: 16 heads x this warp's 16 positions
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const int kr = warp * PW + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t r[4];
        ldsm_x4(kt + swz<D>(kr, 2 * kk + ((lane >> 3) & 1)), r);
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
          float x = s[nb][e] * p.scale_log2;
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
      const int vr = warp * PW + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t r[4];
        ldsm_x4_trans(vt + swz<D>(vr, 2 * dp + (lane >> 4)), r);
        mma_bf16(o[2 * dp], pf, r[0], r[1]);
        mma_bf16(o[2 * dp + 1], pf, r[2], r[3]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar + 8 * (C::STAGES + st));  // this warp is done with it
    }
  }

  // merge the consumer warps' (m, l, O): a warp whose max stayed at the
  // sentinel saw no valid position and weighs 0
  if (warp < WARPS) {
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    if (t4 == 0) {
      wm[warp][gq] = m0;
      wm[warp][gq + 8] = m1;
      wl[warp][gq] = l0;
      wl[warp][gq + 8] = l1;
    }
  }
  __syncthreads();  // also: every tile is consumed, the ring is free
  float* os = reinterpret_cast<float*>(gbase);  // [WARPS][GT][D], over the ring
  if (warp < WARPS) {
    float mb0 = NEG, mb1 = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if (wm[w][gq] > 0.5f * NEG) mb0 = fmaxf(mb0, wm[w][gq]);
      if (wm[w][gq + 8] > 0.5f * NEG) mb1 = fmaxf(mb1, wm[w][gq + 8]);
    }
    const float w0 = m0 > 0.5f * NEG ? exp2f(m0 - mb0) : 0.f;
    const float w1 = m1 > 0.5f * NEG ? exp2f(m1 - mb1) : 0.f;
#pragma unroll
    for (int db = 0; db < DB; ++db) {
      const int col = db * 8 + 2 * t4;
      *reinterpret_cast<float2*>(os + (warp * GT + gq) * D + col) =
          make_float2(o[db][0] * w0, o[db][1] * w0);
      *reinterpret_cast<float2*>(os + (warp * GT + gq + 8) * D + col) =
          make_float2(o[db][2] * w1, o[db][3] * w1);
    }
  }
  if (threadIdx.x < gh) {  // the block's (m, l) per head
    const int r = threadIdx.x;
    float mb = NEG, lb = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      if (wm[w][r] > 0.5f * NEG) mb = fmaxf(mb, wm[w][r]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      if (wm[w][r] > 0.5f * NEG) lb = fmaf(wl[w][r], exp2f(wm[w][r] - mb), lb);
    mrow[r] = mb;
    lsum[r] = lb;
  }
  __syncthreads();
  if (p.nsplit == 1) {  // the block's (m, l, O) is the output: the warps' sums in warp order
    for (int e = threadIdx.x; e < gh * D; e += THREADS) {
      const int r = e / D, d = e - r * D;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) acc += os[(w * GT + r) * D + d];
      p.out[(hq0 + r) * D + d] = __float2bfloat16(acc / fmaxf(lsum[r], 1e-30f));
    }
    return;
  }

  // the cluster's splits combined over distributed shared memory: rank j
  // owns the float4 columns [j * e4 / cs, (j + 1) * e4 / cs) of the output;
  // every rank pushes its partial of each slice, with its (m, l), into the
  // owner's shared memory and arrives on the owner's barrier, and the owner
  // merges the ranks' parts in rank (= split) order: the output when the
  // cluster holds every split, else the cluster's partial of the slice
  const int cs = p.cluster, rank = split % cs;
  const int ncl = p.nsplit / cs, cl = split / cs;
  const int e4 = gh * (D / 4), sl = (e4 + cs - 1) / cs;  // float4 columns a slice, at most
  const int lo = rank * e4 / cs, hi = (rank + 1) * e4 / cs;
  const uint32_t recv = base + C::RECV, recv_ml = base + C::RECV_ML;
  cluster_wait();  // every rank's barrier is initialised
  for (int e = threadIdx.x; e < e4; e += THREADS) {  // the warps' sums in warp order
    const int j = ((e + 1) * cs - 1) / e4;  // the owner of column e
    const int r = e / (D / 4), c4 = e - r * (D / 4);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(os + (w * GT + r) * D + c4 * 4);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    st_cluster4(at_rank(recv + ((rank * sl + e - j * e4 / cs) * 4) * 4, j), acc);
  }
  for (int c = threadIdx.x; c < cs * gh; c += THREADS) {
    const int j = c / gh, r = c - j * gh;
    st_cluster2(at_rank(recv_ml + (rank * GT + r) * 8, j), mrow[r], lsum[r]);
  }
  __syncthreads();  // the block's pushes are issued
  if (threadIdx.x < cs) mbar_arrive_at(pushed, threadIdx.x);
  mbar_wait_cluster(pushed, 0);  // every rank's part of this block's slice
  const float* got = reinterpret_cast<const float*>(gbase + C::RECV);
  const float2* got_ml = reinterpret_cast<const float2*>(gbase + C::RECV_ML);
  for (int e = lo + threadIdx.x; e < hi; e += THREADS) {
    const int r = e / (D / 4), c4 = e - r * (D / 4);
    float mr[MAX_CLUSTER], lr[MAX_CLUSTER];
    float4 x[MAX_CLUSTER];
#pragma unroll
    for (int j = 0; j < MAX_CLUSTER; ++j) {
      if (j < cs) {
        const float2 ml = got_ml[j * GT + r];
        mr[j] = ml.x;
        lr[j] = ml.y;
        x[j] = *reinterpret_cast<const float4*>(got + (j * sl + e - lo) * 4);
      }
    }
    float mb, lb;
    const float4 a = combine<MAX_CLUSTER>(cs, mr, lr, x, mb, lb);
    if (ncl == 1) {
      store_bf16x4(p.out + (hq0 + r) * D + c4 * 4, a, fmaxf(lb, 1e-30f));
    } else {
      const size_t row = (hq0 + r) * ncl + cl;
      *reinterpret_cast<float4*>(p.part_acc + row * D + c4 * 4) = a;
      if (c4 == 0 || e == lo) {  // every row the slice touches
        p.part_m[row] = mb;
        p.part_l[row] = lb;
      }
    }
  }
  if (ncl == 1) return;

  // several clusters: the slice's last block to finish (one rank of each
  // cluster writes the slice) combines the clusters' partials of it, in
  // cluster order
  __syncthreads();  // the block's share of the slice is written
  if (threadIdx.x == 0) {  // release it (the fence is cumulative over the barrier), then count
    unsigned* count =
        p.counters + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * MAX_CLUSTER + rank;
    __threadfence();
    const int last = atomicAdd(count, 1u) == (unsigned)ncl - 1;
    if (last) {
      __threadfence();  // acquire: the other clusters' slices are visible from here
      *count = 0u;      // ready for the next launch (no other block touches it in this one)
    }
    s_last = last;
  }
  __syncthreads();
  if (!s_last) return;
  for (int e = lo + threadIdx.x; e < hi; e += THREADS) {
    const int r = e / (D / 4), c4 = e - r * (D / 4);
    const size_t row = (hq0 + r) * ncl;
    float mr[MAX_CLUSTERS], lr[MAX_CLUSTERS];
    float4 x[MAX_CLUSTERS];
#pragma unroll
    for (int j = 0; j < MAX_CLUSTERS; ++j) {  // all in flight before any is used
      if (j < ncl) {
        mr[j] = __ldcg(p.part_m + row + j);
        lr[j] = __ldcg(p.part_l + row + j);
        x[j] = __ldcg(reinterpret_cast<const float4*>(p.part_acc + (row + j) * D + c4 * 4));
      }
    }
    float mb, lb;
    const float4 a = combine<MAX_CLUSTERS>(ncl, mr, lr, x, mb, lb);
    store_bf16x4(p.out + (hq0 + r) * D + c4 * 4, a, fmaxf(lb, 1e-30f));
  }
}

template <int D>
cudaError_t prepare() {  // shared memory above 48 KB, once an instantiation
  static const cudaError_t err = cudaFuncSetAttribute(
      decode_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::BYTES);
  return err;
}

// the cache [B, S, Hkv, D] bf16 as (D, Hkv, S, B) in boxes of [1, CH, 1, 64]
int map_cache(EncodeTiled enc, CUtensorMap* m, const void* ptr, int B, int S, int Hkv, int D) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)Hkv * D * 2,
                                 (cuuint64_t)S * Hkv * D * 2};
  const cuuint32_t box[4] = {PANEL, 1, CH, 1};
  return map_tiled(enc, m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims, strides, box);
}

template <int D>
int occupancy(int* smem_bytes, int* blocks_per_sm) {
  const cudaError_t err = prepare<D>();
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = Cfg<D>::BYTES;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, decode_mma_kernel<D>, THREADS, Cfg<D>::BYTES);
}

template <int D>
int launch(const Params& p, dim3 grid, cudaStream_t stream) {
  const cudaError_t set = prepare<D>();
  if (set != cudaSuccess) return (int)set;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Cfg<D>::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, decode_mma_kernel<D>, p);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// The K and V caches' tensor maps (two CUtensorMap, 256 bytes, into `maps`,
// host memory): encoded once per cache buffer and shape by the wrapper,
// which keeps them. Returns 0, or ENCODE_FAILED (10000) + the CUresult of a
// map that did not encode.
extern "C" int decode_attention_mma_maps(const void* k, const void* v, int B, int S, int Hkv,
                                         int D, void* maps) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || (D != 64 && D != 128)) return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return ENCODE_FAILED + (int)CUDA_ERROR_NOT_FOUND;
  CUtensorMap m[2];
  int err = map_cache(enc, &m[0], k, B, S, Hkv, D);
  err = err ? err : map_cache(enc, &m[1], v, B, S, Hkv, D);
  if (err == 0) memcpy(maps, m, sizeof(m));
  return err;
}


// bf16 only; D 64 or 128. maps from decode_attention_mma_maps for this
// call's k and v (the tile holding a length is read through k and v
// themselves); nsplit a power of two up to 128 (clusters of min(nsplit, 8)
// splits); part_acc [B*Hq*nsplit*D], part_m and part_l [B*Hq*nsplit] f32
// scratch (used when nsplit > 8); counters [B*Hkv*ceil(Hq/Hkv/16)*8]
// unsigned, zero, left zero. Returns the cudaGetLastError() of the launch (0 on
// success).
extern "C" int decode_attention_mma_fwd(const void* q, const void* k, const void* v,
                                        const void* maps, const int* lengths,
                                        float* part_acc, float* part_m, float* part_l,
                                        unsigned* counters, void* out, int B, int Hq, int Hkv,
                                        int S, int D, int nsplit, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || S <= 0 || nsplit <= 0 || Hq % Hkv != 0 ||
      B > 65535 || Hkv * ((Hq / Hkv + GT - 1) / GT) > 65535 || nsplit > MAX_SPLITS ||
      (nsplit & (nsplit - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  memcpy(&p.k, maps, 2 * sizeof(CUtensorMap));
  p.q = static_cast<const bf16*>(q);
  p.k_raw = static_cast<const bf16*>(k);
  p.v_raw = static_cast<const bf16*>(v);
  p.lengths = lengths;
  p.part_acc = part_acc, p.part_m = part_m, p.part_l = part_l;
  p.counters = counters;
  p.out = static_cast<bf16*>(out);
  p.Hq = Hq, p.Hkv = Hkv, p.S = S, p.nsplit = nsplit;
  p.cluster = nsplit < MAX_CLUSTER ? nsplit : MAX_CLUSTER;
  p.scale_log2 = LOG2E / sqrtf((float)D);
  const dim3 grid(nsplit, Hkv * ((Hq / Hkv + GT - 1) / GT), B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(p, grid, s);
    case 128: return launch<128>(p, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory at head dim D and the blocks of it an SM holds
// at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns the CUDA
// error (0 on success).
extern "C" int decode_attention_mma_occupancy(int D, int* smem_bytes, int* blocks_per_sm) {
  switch (D) {
    case 64: return occupancy<64>(smem_bytes, blocks_per_sm);
    case 128: return occupancy<128>(smem_bytes, blocks_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}
