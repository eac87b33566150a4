// Flash-attention backward on Hopper's tensor cores (sm_90a), bf16 at D = 64
// and 128; plain C interface for ctypes.
//
// Replaces: no TPU kernel. The reference trains through the jnp
// `layers.sdpa`, which XLA differentiates; this is the gradient of
// csrc/flash_attention_mma.cu (src/repro/kernels/flash_attention.py::
// flash_attention's port on the tensor cores), for every bf16 call at those
// head dims: each training step of vit-l16 cls_384 (D=64), the LM train
// shapes (D=128, causal), dit and flux. f32 and D in {16, 32} go to
// csrc/flash_attention_bwd.cu (3xTF32 tensor cores).
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
// bf16 products (wgmma bf16 -> f32); P and dS are rounded to bf16 (nearest
// even) as the A operands of the products that give dV, dQ and dK; the
// gradients are f32 in registers and rounded once. Exponentials are
// ex2.approx.ftz of log2-unit scores (scale, bias and lse times log2 e).
// dbias_part (nullable, [B, H, Sk] f32) gets each key's sum over queries of
// the unrounded f32 dS; the wrapper sums it over H. A key no query sees (past
// min(Sk, kv_len)) gets dK = dV = 0, written; so does a whole key block past
// it.
//
// What bounds it on the H100: five products of 2*D FLOPs a (query, key)
// pair. At the vit-l16 train call [32, 16, 577, 64] that is 109 GFLOP (110
// us at the 989 TFLOP/s bf16 tensor-core peak) over 304 MB (q, k, v, out,
// dout and the f32 lse read, dq, dk, dv written; 91 us at 3.35 TB/s):
// operations bound it, so the design is about feeding the tensor cores.
//   - Operands: mma.sync fragments that every warp loaded with ldmatrix held
//     the tensor cores near 0.42 of peak (128 B a clock an SM). Every product
//     here is a wgmma (m64nNk16, bf16 in, f32 sums), B read by the warpgroup
//     from shared memory; P and dS enter the dV, dQ and dK products as
//     register A operands (the accumulator's layout is the A fragment's, per
//     warp). S and dP (S^T and dP^T) read both operands from shared memory.
//   - Loads: a producer warp issues TMA copies into a ring of stages guarded
//     by mbarriers (full/empty), and cp.async copies of the per-row vectors
//     (bias; lse and D_i) that arrive on the same barrier, so loads run ahead
//     of the products and no block-wide barrier stands between tiles. TMA
//     zero-fills rows past S and writes the 128-byte swizzle that the wgmma
//     descriptors read: K-major for S and dP, MN-major (the transpose bit)
//     for the tile read along its rows (K in dQ += dS.K, dO and Q in
//     dV += P^T.dO and dK += dS^T.Q). D = 128 is two 64-column panels.
//   - Registers: 384 threads (a producer warpgroup and two consumer
//     warpgroups of 64 rows, one block an SM) leave 168 registers a thread.
//     setmaxnreg moves registers from the producer (56) to the consumers
//     (224) at run time, but ptxas still compiles the consumers' code within
//     168 (no register above R166 in their SASS), and near that limit it
//     serialises the wgmmas. So the design fits 168: at D = 64 a consumer of
//     the dK/dV pass holds dK and dV (32 + 32 floats) with S^T and dP^T of a
//     64-query tile; at D = 128 it could not (dK and dV alone are 128
//     floats), so there the two consumers split the work of 64 keys (below).
//     Neither pass spills at either D.
//   - Ragged edges: a streamed tile is trimmed to the least of N = 8, 16, 32,
//     64 that covers its live rows (a 1-row tail costs an n8 product, not an
//     n64), and a warpgroup skips the tiles its rows cannot see (past its
//     causal frontier) and, with no row before S or kv_len, all of them. At
//     577 tokens a (b, h) computes 640 x 584 (query, key) pairs in each pass
//     (10 warpgroups of 64 rows against 9 tiles of 64 and one of 8), 1.12x
//     577^2, where 64-row blocks over 64-wide tiles computed 640^2 (1.23x).
//   - Seven products for five: the dQ pass recomputes S and dP (0.044 ms at
//     the train call's bound), the price of having no atomics.
//   What holds it at D = 64 (measured, clock64 phases of one block): each
//   warpgroup's tile is a chain (S and dP products, then the exponentials on
//   the MUFU unit, then dS, then the RS product) that the 168-register limit
//   leaves no room to pipeline across tiles; removing every S and dP product
//   moves the dQ pass by 10% only. One block an SM also exposes each block's
//   start (the resident copies) and end.
//
// Design, two passes with no atomics and no inter-block waits, so the
// gradient is the same bit for bit from run to run:
//   1. dQ pass: one block per (b*h, 128-query tile), heaviest first under
//      causal. Q, dO and O stay in shared memory (resident, a TMA box of 64
//      rows a warpgroup and panel); each consumer thread forms D_i =
//      rowsum(dO * O) of its two rows from the resident dO and O (a quad
//      splits a row's columns) and writes it to `rowsum` for pass 2. K, V
//      tiles of 64 keys (with the bias) stream through a ring of 4 stages at
//      D=64, 3 at D=128, up to the block's causal frontier and kv_len. Per
//      tile: S = Q.K^T and dP = dO.V^T (SS, two commit groups: P is formed
//      while dP's product runs), dS rounded to bf16 into A fragments,
//      dQ += dS.K (RS).
//   2. dK/dV pass, D = 64: one block per (b*h, 128-key tile), each consumer
//      warpgroup 64 keys; K and V resident, Q and dO tiles of 64 queries
//      (with their lse and D_i) stream from the block's causal frontier on.
//      Per tile, transposed: S^T = K.Q^T and dP^T = V.dO^T (SS), P^T,
//      dV += P^T.dO (RS) issued before dS^T is formed so the two overlap,
//      dS^T and the dbias sums, dK += dS^T.Q (RS).
//      D = 128: one block per (b*h, 64-key tile). Consumer 0 forms S^T, P^T
//      and dV += P^T.dO; it hands P^T (f32) to consumer 1 through shared
//      memory (two named barriers: ready, free), which forms dP^T, dS^T, the
//      dbias sums and dK += dS^T.Q. Each holds one 64 x 128 accumulator and
//      runs two products a tile; each role is its own instantiation, since
//      one wgmma sequence over both roles was serialised.
//   Each gradient leaves through the rows of the resident tiles it was
//   computed from (written in the swizzled layout, read back in 16-byte
//   pieces). Masks apply element by element only on tiles that hold a
//   masked pair.
// Tiles: streamed width 64 (m64n64 products, 32 accumulator floats a thread;
// narrower tiles read the resident operand from shared memory more often
// and were slower). Dynamic shared memory a block: dQ pass 114 KB at D=64,
// 194 KB at D=128; dK/dV pass 99 KB, 147 KB (with P^T's 16 KB hand-off).
// One block an SM, held there by the 384 x 168 registers.
// Each call encodes its tensor maps on the host (q, k, v, out and dout move
// from call to call) through the driver's cuTensorMapEncodeTiled, reached
// with cudaGetDriverEntryPoint so that the build links no -lcuda. The
// mbarrier, TMA, wgmma and descriptor helpers and that encoder live in
// hopper.cuh, shared with the forward (flash_attention_mma.cu).
#include <math.h>

#include <chrono>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 384;   // a producer warpgroup, then two consumer warpgroups
constexpr int ROWS = 128;      // dQ pass: resident rows a block, 64 a consumer warpgroup
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;  // 128*56 + 256*224 = 384*168

// Tiles and shared memory of one head dim. Every tile region starts on 1024
// bytes (the 128-byte swizzle's period); the per-row vectors and the
// mbarriers follow the tiles.
template <int D>
struct Cfg {
  static constexpr int NP = D / PANEL;            // panels a row
  static constexpr int BC = 64;                   // dQ pass: keys a streamed tile
  static constexpr int BQ = 64;                   // dK/dV pass: queries a streamed tile
  static constexpr int STAGES = D == 64 ? 4 : 3;  // ring depth
  // dK/dV pass at D = 128: the two consumer warpgroups share 64 keys, one
  // forming P^T and dV, the other dP^T, dS^T and dK (see the header)
  static constexpr bool SPLIT = D == 128;
  static constexpr int KEYS = SPLIT ? 64 : ROWS;  // dK/dV pass: resident keys a block
  static constexpr int RES_PANEL = ROWS * 128;    // one resident panel of 128 rows
  static constexpr int RES_TILE = NP * RES_PANEL;
  static constexpr int KRES_PANEL = KEYS * 128, KRES_TILE = NP * KRES_PANEL;
  static constexpr int KV_PANEL = BC * 128, KV_TILE = NP * KV_PANEL;
  static constexpr int QD_PANEL = BQ * 128, QD_TILE = NP * QD_PANEL;
  // dQ pass: Q, dO, O | STAGES x (K, V) | STAGES x bias[BC] | barriers
  static constexpr int DQ_RING = 3 * RES_TILE;
  static constexpr int DQ_BIAS = DQ_RING + STAGES * 2 * KV_TILE;
  static constexpr int DQ_BAR = DQ_BIAS + STAGES * BC * 4;
  static constexpr int DQ_BYTES = DQ_BAR + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
  // dK/dV pass: K, V | STAGES x (Q, dO) | STAGES x lse[BQ] | STAGES x D_i[BQ] |
  // P^T handed between the warpgroups [BQ/2][128] f32 (SPLIT) | barriers
  static constexpr int KV_RING = 2 * KRES_TILE;
  static constexpr int KV_LSE = KV_RING + STAGES * 2 * QD_TILE;
  static constexpr int KV_RS = KV_LSE + STAGES * BQ * 4;
  static constexpr int KV_P = KV_RS + STAGES * BQ * 4;
  static constexpr int KV_BAR = KV_P + (SPLIT ? BQ / 2 * 128 * 4 : 0);
  static constexpr int DKDV_BYTES = KV_BAR + (2 * STAGES + 1) * 8 + 1024;
};

// named barriers (0 is __syncthreads): 1 + w over consumer warpgroup w's 128
// threads; over both consumer warpgroups (256): P^T handed over, its buffer
// free again, the products done
constexpr int BAR_P_READY = 3, BAR_P_FREE = 4, BAR_PRODUCTS = 5;

struct DqParams {
  CUtensorMap q, dout, out, k, v;  // q, dout, out: boxes of 64 rows; k, v: of BC rows
  const float* bias;
  const float* lse;
  const int* kv_len;
  bf16* dq;
  float* rowsum;
  int H, Sq, Sk, causal;
  float scale_log2, scale;
};

struct DkdvParams {
  CUtensorMap k, v, q, dout;  // k, v: boxes of 64 rows; q, dout: of BQ rows
  const float* lse;
  const float* rowsum;
  const float* bias;
  const int* kv_len;
  bf16* dk;
  bf16* dv;
  float* dbias_part;
  int H, Sq, Sk, causal;
  float scale_log2, scale;
};


// ---- pass 1: dQ, and rowsum(dO * O) for pass 2

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_mma_bwd_dq_kernel(const __grid_constant__ DqParams p) {
  using C = Cfg<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sQ = base, sDO = base + C::RES_TILE, sO = base + 2 * C::RES_TILE;
  const uint32_t sRing = base + C::DQ_RING;
  float* bias_s = reinterpret_cast<float*>(gbase + C::DQ_BIAS);  // [STAGES][BC]
  const uint32_t bar = base + C::DQ_BAR;  // full[STAGES], empty[STAGES], resident
  const uint32_t resident = bar + 16 * C::STAGES;

  const int bh = blockIdx.x, b = bh / p.H;
  const int q0 = (p.causal ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.y) * ROWS;
  const int shift = p.Sk - p.Sq;
  int kend = p.Sk;
  if (p.kv_len != nullptr) kend = min(kend, max(p.kv_len[b], 0));
  int blk_end = kend;  // keys any row of the block sees end here
  if (p.causal) blk_end = min(blk_end, max(min(q0 + ROWS, p.Sq) + shift, 0));
  const int n_tiles = (blk_end + C::BC - 1) / C::BC;
  const int n_live = q0 + 64 < p.Sq ? 2 : 1;  // consumer warpgroups with a row before Sq

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar + 8 * s, 33);  // the copies' expect_tx and each producer lane's vectors
      mbar_init(bar + 8 * (C::STAGES + s), 4 * n_live);  // one arrival a consumer warp
    }
    mbar_init(resident, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup's role as a warp-uniform value: setmaxnreg and wgmma act
  // on whole warpgroups
  const int wgi = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  if (wgi == 0) {  // producer warpgroup: its first warp loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    const int lane = threadIdx.x;
    if (lane < 32) {
      if (lane == 0) {  // Q, dO and O (for D_i), also when no key is seen
        mbar_expect_tx(resident, 3 * C::RES_TILE);
        for (int w = 0; w < 2; ++w)
          for (int pp = 0; pp < C::NP; ++pp) {
            const uint32_t off = pp * C::RES_PANEL + w * 64 * 128;
            tma_3d(sQ + off, &p.q, resident, pp * PANEL, q0 + 64 * w, bh);
            tma_3d(sDO + off, &p.dout, resident, pp * PANEL, q0 + 64 * w, bh);
            tma_3d(sO + off, &p.out, resident, pp * PANEL, q0 + 64 * w, bh);
          }
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % C::STAGES, t0 = i * C::BC;
        if (i >= C::STAGES) mbar_wait(bar + 8 * (C::STAGES + s), ((i / C::STAGES) - 1) & 1);
        const uint32_t full = bar + 8 * s;
        if (lane == 0) {
          mbar_expect_tx(full, 2 * C::KV_TILE);
          const uint32_t sk = sRing + s * 2 * C::KV_TILE, sv = sk + C::KV_TILE;
          for (int pp = 0; pp < C::NP; ++pp) {
            tma_3d(sk + pp * C::KV_PANEL, &p.k, full, pp * PANEL, t0, bh);
            tma_3d(sv + pp * C::KV_PANEL, &p.v, full, pp * PANEL, t0, bh);
          }
        }
        if (p.bias != nullptr)  // keys past Sk are masked: zeros
          for (int c = lane; c < C::BC; c += 32) {
            const bool ok = t0 + c < p.Sk;
            cp_async4(smem_u32(bias_s + s * C::BC + c),
                      p.bias + (ok ? (size_t)b * p.Sk + t0 + c : 0), ok);
          }
        cp_async_arrive(full);  // when the lane's copies land
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int wg = wgi - 1;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = q0 + 64 * wg;  // the warpgroup's first query row
  if (r0 >= p.Sq) return;
  const size_t qoff = (size_t)bh * p.Sq * D;
  const int row0 = r0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const float ls0 = row0 < p.Sq ? p.lse[(size_t)bh * p.Sq + row0] * LOG2E : INFINITY;
  const float ls1 = row0 + 8 < p.Sq ? p.lse[(size_t)bh * p.Sq + row0 + 8] * LOG2E : INFINITY;
  mbar_wait(resident, 0);

  // D_i = rowsum(dO * O) of the thread's rows from the resident dO and O
  // tiles: a quad's four threads take every fourth 16-byte piece of a row;
  // rows past Sq were zero-filled. Written to `rowsum` for pass 2.
  float dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wg * 64 + warp * 16 + g + 8 * h;  // row of the resident tiles
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < D / 32; ++k) {
      const int c = t4 + 4 * k, at = (c >> 3) * C::RES_PANEL + r * 128 + (((c & 7) ^ g) << 4);
      const uint4 ov = *reinterpret_cast<const uint4*>(gbase + 2 * C::RES_TILE + at);
      const uint4 dv = *reinterpret_cast<const uint4*>(gbase + C::RES_TILE + at);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 of = __bfloat1622float2(o2[i]), df = __bfloat1622float2(d2[i]);
        a = fmaf(df.x, of.x, fmaf(df.y, of.y, a));
      }
    }
    dd[h] = quad_sum(a);
    if (t4 == 0 && row0 + 8 * h < p.Sq) p.rowsum[(size_t)bh * p.Sq + row0 + 8 * h] = dd[h];
  }
  const float dd0 = dd[0], dd1 = dd[1];

  int wg_end = kend;  // keys the warpgroup's rows see end here
  if (p.causal) wg_end = min(wg_end, max(min(r0 + 64, p.Sq) + shift, 0));

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint64_t dq_a = sw128_desc(sQ + wg * 64 * 128, 0);
  const uint64_t ddo_a = sw128_desc(sDO + wg * 64 * 128, 0);

#pragma unroll 1
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % C::STAGES, t0 = i * C::BC;
    mbar_wait(bar + 8 * s, (i / C::STAGES) & 1);
    if (t0 < wg_end) {
      const uint32_t sk = sRing + s * 2 * C::KV_TILE, sv = sk + C::KV_TILE;
      const uint64_t dk_b = sw128_desc(sk, 0), dv_b = sw128_desc(sv, 0);
      const uint64_t dk_mn = sw128_desc(sk, C::KV_PANEL);
      const float* bt = bias_s + s * C::BC;
      // one tile, N keys wide (the least of 8, 16, 32, 64 covering its live keys)
      auto tile = [&](auto n) {
        constexpr int N = decltype(n)::value, NK = (N + 15) / 16;
        float sc[N / 2], dp[N / 2];
        __syncwarp();
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {  // S = Q.K^T
          const uint32_t ra = ((kk >> 2) * C::RES_PANEL + (kk & 3) * 32) >> 4;
          const uint32_t rb = ((kk >> 2) * C::KV_PANEL + (kk & 3) * 32) >> 4;
          wgmma_ss<N>(sc, dq_a + ra, dk_b + rb, kk);
        }
        wg_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {  // dP = dO.V^T
          const uint32_t ra = ((kk >> 2) * C::RES_PANEL + (kk & 3) * 32) >> 4;
          const uint32_t rb = ((kk >> 2) * C::KV_PANEL + (kk & 3) * 32) >> 4;
          wgmma_ss<N>(dp, ddo_a + ra, dv_b + rb, kk);
        }
        wg_commit();
        wg_wait<1>();  // S is in; P while dP's product runs
        reg_fence(sc);
        const bool edge = t0 + N > kend || (p.causal && t0 + N - 1 > r0 + shift);
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          float2 bb = make_float2(0.f, 0.f);
          if (p.bias != nullptr) bb = *reinterpret_cast<const float2*>(bt + 8 * j + 2 * t4);
          const float b0 = fmaxf(bb.x, NEG) * LOG2E, b1 = fmaxf(bb.y, NEG) * LOG2E;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 4 * j + e;
            float pr = ex2(fmaf(sc[x], p.scale_log2, (e & 1) ? b1 : b0) - (e < 2 ? ls0 : ls1));
            if (edge) {
              const int kpos = t0 + 8 * j + 2 * t4 + (e & 1), qpos = row0 + (e >> 1) * 8;
              if (kpos >= kend || (p.causal && kpos > qpos + shift)) pr = 0.f;
            }
            sc[x] = pr;  // P
          }
        }
        wg_wait<0>();
        reg_fence(dp);
#pragma unroll
        for (int x = 0; x < N / 2; ++x) dp[x] = sc[x] * (dp[x] - ((x & 2) ? dd1 : dd0));  // dS
        uint32_t f[NK][4];
        to_frags<N>(f, dp);
        __syncwarp();
        wg_fence();
        reg_fence(acc);
#pragma unroll
        for (int ks = 0; ks < NK; ++ks)  // dQ += dS.K, 16 keys a step
          wgmma_rs<D>(acc, f[ks], dk_mn + ((ks * 2048) >> 4));
        wg_commit();
        wg_wait<0>();
        reg_fence(acc);
        reg_fence(f);
      };
      with_width(wg_end - t0, tile);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar + 8 * (C::STAGES + s));  // this warp is done with stage s
  }

  // dQ leaves through the warpgroup's own Q rows
  unsigned char* stage = gbase + wg * 64 * 128;
  wg_sync(1 + wg);
  stage_rows<D>(stage, acc, p.scale, C::RES_PANEL, warp, g, t4);
  wg_sync(1 + wg);
  copy_out<D>(p.dq + qoff, stage, C::RES_PANEL, r0, p.Sq, tid);
}

// ---- pass 2: dK, dV and the per-head dbias sums

// What a consumer warpgroup of the dK/dV pass sees of its block.
struct DkdvCtx {
  int bh, b, k0, kend, shift, qt_begin, n_tiles;
  uint32_t sK, sV, sRing, bar;
  const float* lse_s;
  const float* rs_s;
  float* px;           // P^T handed between the warpgroups (SPLIT)
  unsigned char* gbase;
};

// the clamped bias of key row kr in log2 units (0 without a bias or past Sk)
__device__ __forceinline__ float key_bias(const DkdvParams& p, int b, int kr) {
  return p.bias != nullptr && kr < p.Sk ? fmaxf(p.bias[(size_t)b * p.Sk + kr], NEG) * LOG2E : 0.f;
}

// each key row's dbias sum (rows kr0, kr0 + 8 of the thread; a quad holds a
// row's partial sums) into dbias_part
__device__ __forceinline__ void write_dbias(const DkdvParams& p, int bh, int kr0, int t4,
                                            float db0, float db1) {
  db0 = quad_sum(db0);
  db1 = quad_sum(db1);
  if (p.dbias_part != nullptr && t4 == 0) {
    if (kr0 < p.Sk) p.dbias_part[(size_t)bh * p.Sk + kr0] = db0;
    if (kr0 + 8 < p.Sk) p.dbias_part[(size_t)bh * p.Sk + kr0 + 8] = db1;
  }
}

// One streamed tile's S^T = K.Q^T or dP^T = V.dO^T (SS, `a` the resident
// operand's rows, `b` the tile), N queries wide, into d.
template <int D, int N>
__device__ __forceinline__ void rows_dot_tile(float (&d)[N / 2], uint64_t a, uint64_t b,
                                              int res_panel) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t ra = ((kk >> 2) * res_panel + (kk & 3) * 32) >> 4;
    const uint32_t rb = ((kk >> 2) * C::QD_PANEL + (kk & 3) * 32) >> 4;
    wgmma_ss<N>(d, a + ra, b + rb, kk);
  }
}

// P^T of the thread's elements from S^T in place: keys kr0 and kr0 + 8 (log2
// bias kb0, kb1), queries t0 + 8j + 2 t4 (+1) with their lse in `lt`
template <int N>
__device__ __forceinline__ void probs_t(float (&sc)[N / 2], const float* lt, float kb0, float kb1,
                                        float scale_log2, bool edge, int kr0, int t0, int t4,
                                        int Sq, int kend, int causal, int shift) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lt + 8 * j + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * j + e;
      float pr = ex2(fmaf(sc[x], scale_log2, e < 2 ? kb0 : kb1) -
                     ((e & 1) ? l2.y : l2.x) * LOG2E);
      if (edge) {
        const int kpos = kr0 + (e >> 1) * 8, qpos = t0 + 8 * j + 2 * t4 + (e & 1);
        if (qpos >= Sq || kpos >= kend || (causal && kpos > qpos + shift)) pr = 0.f;
      }
      sc[x] = pr;
    }
  }
}

// dS^T = P^T * (dP^T - D_i) in place in dp, and its sums over the thread's
// queries into db0, db1 (keys kr0, kr0 + 8); P^T element x is pt(x)
template <int N, typename Pt>
__device__ __forceinline__ void grads_t(float (&dp)[N / 2], Pt pt, const float* rt, int t4,
                                        float& db0, float& db1) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 r2 = *reinterpret_cast<const float2*>(rt + 8 * j + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * j + e;
      const float ds = pt(x) * (dp[x] - ((e & 1) ? r2.y : r2.x));
      dp[x] = ds;
      if (e < 2) db0 += ds; else db1 += ds;
    }
  }
}

// D = 64: each consumer warpgroup owns 64 of the block's 128 keys and forms
// all four products for them.
template <int D>
__device__ __forceinline__ void dkdv_rows(const DkdvParams& p, const DkdvCtx& c, int wg, int tid) {
  using C = Cfg<D>;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int kw0 = c.k0 + 64 * wg;       // the warpgroup's first key row
  const int kr0 = kw0 + warp * 16 + g;  // this thread's key rows: kr0, kr0 + 8
  const bool live = kw0 < c.kend;
  const float kb0 = key_bias(p, c.b, kr0), kb1 = key_bias(p, c.b, kr0 + 8);

  float gk[D / 2], gv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) gk[i] = gv[i] = 0.f;
  float db0 = 0.f, db1 = 0.f;
  mbar_wait(c.bar + 16 * C::STAGES, 0);  // K and V are in
  const uint64_t dk_a = sw128_desc(c.sK + wg * 64 * 128, 0);
  const uint64_t dv_a = sw128_desc(c.sV + wg * 64 * 128, 0);

#pragma unroll 1
  for (int i = 0; live && i < c.n_tiles; ++i) {
    const int s = i % C::STAGES, t0 = (c.qt_begin + i) * C::BQ;
    mbar_wait(c.bar + 8 * s, (i / C::STAGES) & 1);
    // the warpgroup's first key is seen by a query of the tile
    if (!p.causal || kw0 <= min(t0 + C::BQ, p.Sq) - 1 + c.shift) {
      const uint32_t sq = c.sRing + s * 2 * C::QD_TILE, sdo = sq + C::QD_TILE;
      const float* lt = c.lse_s + s * C::BQ;
      const float* rt = c.rs_s + s * C::BQ;
      // one tile, N queries wide (the least of 8, 16, 32, 64 covering its live queries)
      auto tile = [&](auto n) {
        constexpr int N = decltype(n)::value, NK = (N + 15) / 16;
        float sc[N / 2], dp[N / 2];
        __syncwarp();
        wg_fence();
        rows_dot_tile<D, N>(sc, dk_a, sw128_desc(sq, 0), C::RES_PANEL);  // S^T = K.Q^T
        wg_commit();
        rows_dot_tile<D, N>(dp, dv_a, sw128_desc(sdo, 0), C::RES_PANEL);  // dP^T = V.dO^T
        wg_commit();
        wg_wait<1>();  // S^T is in; P^T while dP^T's product runs
        reg_fence(sc);
        // a masked pair in the tile: a query past Sq, a key past kend, or
        // (causal) a key of the warpgroup past the frontier of the tile's
        // first query
        const bool edge =
            t0 + N > p.Sq || kw0 + 64 > c.kend || (p.causal && kw0 + 63 > t0 + c.shift);
        probs_t<N>(sc, lt, kb0, kb1, p.scale_log2, edge, kr0, t0, t4, p.Sq, c.kend, p.causal,
                   c.shift);
        uint32_t pf[NK][4];
        to_frags<N>(pf, sc);
        __syncwarp();
        wg_fence();
        reg_fence(gv);
        const uint64_t ddo_mn = sw128_desc(sdo, C::QD_PANEL);
#pragma unroll
        for (int ks = 0; ks < NK; ++ks)  // dV += P^T.dO, 16 queries a step
          wgmma_rs<D>(gv, pf[ks], ddo_mn + ((ks * 2048) >> 4));
        wg_commit();
        wg_wait<1>();  // dP^T is in; dS^T and its dbias sums while dV's product runs
        reg_fence(dp);
        grads_t<N>(dp, [&](int x) { return sc[x]; }, rt, t4, db0, db1);
        uint32_t df[NK][4];
        to_frags<N>(df, dp);
        __syncwarp();
        wg_fence();
        reg_fence(gk);
        const uint64_t dq_mn = sw128_desc(sq, C::QD_PANEL);
#pragma unroll
        for (int ks = 0; ks < NK; ++ks)  // dK += dS^T.Q
          wgmma_rs<D>(gk, df[ks], dq_mn + ((ks * 2048) >> 4));
        wg_commit();
        wg_wait<0>();
        reg_fence(gv);
        reg_fence(gk);
        reg_fence(pf);
        reg_fence(df);
      };
      with_width(p.Sq - t0, tile);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(c.bar + 8 * (C::STAGES + s));  // this warp is done with stage s
  }

  // dK and dV leave through the warpgroup's own K and V rows
  unsigned char* stage_k = c.gbase + wg * 64 * 128;
  unsigned char* stage_v = c.gbase + C::KRES_TILE + wg * 64 * 128;
  wg_sync(1 + wg);
  stage_rows<D>(stage_k, gk, p.scale, C::KRES_PANEL, warp, g, t4);
  stage_rows<D>(stage_v, gv, 1.f, C::KRES_PANEL, warp, g, t4);
  wg_sync(1 + wg);
  const size_t koff = (size_t)c.bh * p.Sk * D;
  copy_out<D>(p.dk + koff, stage_k, C::KRES_PANEL, kw0, p.Sk, tid);
  copy_out<D>(p.dv + koff, stage_v, C::KRES_PANEL, kw0, p.Sk, tid);
  write_dbias(p, c.bh, kr0, t4, db0, db1);
}

// D = 128: both consumer warpgroups take the block's 64 keys. Warpgroup 0
// forms S^T, P^T and dV += P^T.dO and hands P^T (f32, in the accumulator's
// order: element x of thread t at px[x][t]) to warpgroup 1, which forms
// dP^T, dS^T, the dbias sums and dK += dS^T.Q. Each holds one 64 x 128
// accumulator (64 floats a thread) and both run two products a tile. Each
// role is its own instantiation, so that ptxas sees one wgmma sequence.
template <int D, int WG>
__device__ __forceinline__ void dkdv_split(const DkdvParams& p, const DkdvCtx& c, int tid) {
  using C = Cfg<D>;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int kr0 = c.k0 + warp * 16 + g;  // this thread's key rows: kr0, kr0 + 8
  const float kb0 = key_bias(p, c.b, kr0), kb1 = key_bias(p, c.b, kr0 + 8);

  float acc[D / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float db0 = 0.f, db1 = 0.f;
  mbar_wait(c.bar + 16 * C::STAGES, 0);  // K and V are in
  const uint64_t res_a = sw128_desc(WG == 0 ? c.sK : c.sV, 0);
  if constexpr (WG == 1) pair_arrive(BAR_P_FREE);  // the P^T buffer starts free

#pragma unroll 1
  for (int i = 0; i < c.n_tiles; ++i) {
    const int s = i % C::STAGES, t0 = (c.qt_begin + i) * C::BQ;
    mbar_wait(c.bar + 8 * s, (i / C::STAGES) & 1);
    if (!p.causal || c.k0 <= min(t0 + C::BQ, p.Sq) - 1 + c.shift) {
      const uint32_t sq = c.sRing + s * 2 * C::QD_TILE, sdo = sq + C::QD_TILE;
      auto tile = [&](auto n) {
        constexpr int N = decltype(n)::value, NK = (N + 15) / 16;
        float sc[N / 2];
        __syncwarp();
        wg_fence();
        // S^T = K.Q^T (warpgroup 0) or dP^T = V.dO^T (warpgroup 1)
        rows_dot_tile<D, N>(sc, res_a, sw128_desc(WG == 0 ? sq : sdo, 0), C::KRES_PANEL);
        wg_commit();
        wg_wait<0>();
        reg_fence(sc);
        uint32_t f[NK][4];
        if constexpr (WG == 0) {
          const bool edge = t0 + N > p.Sq || c.k0 + 64 > c.kend ||
                            (p.causal && c.k0 + 63 > t0 + c.shift);
          probs_t<N>(sc, c.lse_s + s * C::BQ, kb0, kb1, p.scale_log2, edge, kr0, t0, t4, p.Sq,
                     c.kend, p.causal, c.shift);
          to_frags<N>(f, sc);
          __syncwarp();
          wg_fence();
          reg_fence(acc);
          const uint64_t ddo_mn = sw128_desc(sdo, C::QD_PANEL);
#pragma unroll
          for (int ks = 0; ks < NK; ++ks)  // dV += P^T.dO
            wgmma_rs<D>(acc, f[ks], ddo_mn + ((ks * 2048) >> 4));
          wg_commit();
          pair_sync(BAR_P_FREE);  // warpgroup 1 has read the last P^T
#pragma unroll
          for (int x = 0; x < N / 2; ++x) c.px[x * 128 + tid] = sc[x];
          pair_arrive(BAR_P_READY);
        } else {
          pair_sync(BAR_P_READY);
          const float* px = c.px + tid;  // sc: dP^T -> dS^T
          grads_t<N>(sc, [&](int x) { return px[x * 128]; }, c.rs_s + s * C::BQ, t4, db0, db1);
          pair_arrive(BAR_P_FREE);
          to_frags<N>(f, sc);
          __syncwarp();
          wg_fence();
          reg_fence(acc);
          const uint64_t dq_mn = sw128_desc(sq, C::QD_PANEL);
#pragma unroll
          for (int ks = 0; ks < NK; ++ks)  // dK += dS^T.Q
            wgmma_rs<D>(acc, f[ks], dq_mn + ((ks * 2048) >> 4));
          wg_commit();
        }
        wg_wait<0>();
        reg_fence(acc);
        reg_fence(f);
      };
      with_width(p.Sq - t0, tile);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(c.bar + 8 * (C::STAGES + s));
  }
  if constexpr (WG == 0) pair_sync(BAR_P_FREE);  // pairs warpgroup 1's last arrival

  // every product is done before either warpgroup overwrites K or V: dK
  // leaves through the K rows, dV through the V rows
  pair_sync(BAR_PRODUCTS);
  unsigned char* stage = c.gbase + (WG == 0 ? C::KRES_TILE : 0);
  stage_rows<D>(stage, acc, WG == 0 ? 1.f : p.scale, C::KRES_PANEL, warp, g, t4);
  wg_sync(1 + WG);
  const size_t koff = (size_t)c.bh * p.Sk * D;
  copy_out<D>((WG == 0 ? p.dv : p.dk) + koff, stage, C::KRES_PANEL, c.k0, p.Sk, tid);
  if constexpr (WG == 1) write_dbias(p, c.bh, kr0, t4, db0, db1);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_mma_bwd_dkdv_kernel(const __grid_constant__ DkdvParams p) {
  using C = Cfg<D>;
  constexpr int CH = D / 8;
  extern __shared__ __align__(1024) unsigned char smem_raw[];

  const int bh = blockIdx.x, b = bh / p.H;
  const int k0 = blockIdx.y * C::KEYS;
  const int shift = p.Sk - p.Sq;
  int kend = p.Sk;
  if (p.kv_len != nullptr) kend = min(kend, max(p.kv_len[b], 0));
  if (k0 >= kend) {  // no query sees a key of this block: zeros
    const size_t koff = (size_t)bh * p.Sk * D;
    for (int c = threadIdx.x; c < C::KEYS * CH; c += THREADS) {
      const int r = c / CH, col = (c % CH) * 8;
      if (k0 + r < p.Sk) {
        const size_t at = koff + (size_t)(k0 + r) * D + col;
        *reinterpret_cast<uint4*>(p.dk + at) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(p.dv + at) = make_uint4(0, 0, 0, 0);
      }
    }
    if (p.dbias_part != nullptr && threadIdx.x < C::KEYS && k0 + (int)threadIdx.x < p.Sk)
      p.dbias_part[(size_t)bh * p.Sk + k0 + threadIdx.x] = 0.f;
    return;
  }

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sK = base, sV = base + C::KRES_TILE, sRing = base + C::KV_RING;
  float* lse_s = reinterpret_cast<float*>(gbase + C::KV_LSE);  // [STAGES][BQ]
  float* rs_s = reinterpret_cast<float*>(gbase + C::KV_RS);    // [STAGES][BQ]
  const uint32_t bar = base + C::KV_BAR;  // full[STAGES], empty[STAGES], resident
  const uint32_t resident = bar + 16 * C::STAGES;

  const int q_begin = p.causal ? max(k0 - shift, 0) : 0;  // < Sq, as k0 < kend <= Sk
  const int qt_begin = q_begin / C::BQ;
  const int n_tiles = (p.Sq + C::BQ - 1) / C::BQ - qt_begin;
  // consumer warpgroups with a key before kend (SPLIT: both share the keys)
  const int n_live = C::SPLIT || k0 + 64 < kend ? 2 : 1;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar + 8 * s, 33);
      mbar_init(bar + 8 * (C::STAGES + s), 4 * n_live);
    }
    mbar_init(resident, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  if (wgi == 0) {  // producer warpgroup: its first warp loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    const int lane = threadIdx.x;
    if (lane < 32) {
      if (lane == 0) {
        mbar_expect_tx(resident, 2 * C::KRES_TILE);
        for (int w = 0; w < C::KEYS / 64; ++w)
          for (int pp = 0; pp < C::NP; ++pp) {
            const uint32_t off = pp * C::KRES_PANEL + w * 64 * 128;
            tma_3d(sK + off, &p.k, resident, pp * PANEL, k0 + 64 * w, bh);
            tma_3d(sV + off, &p.v, resident, pp * PANEL, k0 + 64 * w, bh);
          }
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % C::STAGES, t0 = (qt_begin + i) * C::BQ;
        if (i >= C::STAGES) mbar_wait(bar + 8 * (C::STAGES + s), ((i / C::STAGES) - 1) & 1);
        const uint32_t full = bar + 8 * s;
        if (lane == 0) {
          mbar_expect_tx(full, 2 * C::QD_TILE);
          const uint32_t sq = sRing + s * 2 * C::QD_TILE, sdo = sq + C::QD_TILE;
          for (int pp = 0; pp < C::NP; ++pp) {
            tma_3d(sq + pp * C::QD_PANEL, &p.q, full, pp * PANEL, t0, bh);
            tma_3d(sdo + pp * C::QD_PANEL, &p.dout, full, pp * PANEL, t0, bh);
          }
        }
        for (int c = lane; c < C::BQ; c += 32) {  // queries past Sq are masked: zeros
          const bool ok = t0 + c < p.Sq;
          const size_t at = ok ? (size_t)bh * p.Sq + t0 + c : 0;
          cp_async4(smem_u32(lse_s + s * C::BQ + c), p.lse + at, ok);
          cp_async4(smem_u32(rs_s + s * C::BQ + c), p.rowsum + at, ok);
        }
        cp_async_arrive(full);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const DkdvCtx c{bh, b, k0, kend, shift, qt_begin, n_tiles, sK, sV, sRing, bar, lse_s, rs_s,
                  reinterpret_cast<float*>(gbase + C::KV_P), gbase};
  if constexpr (C::SPLIT) {
    if (wgi == 1)
      dkdv_split<D, 0>(p, c, threadIdx.x & 127);
    else
      dkdv_split<D, 1>(p, c, threadIdx.x & 127);
  } else
    dkdv_rows<D>(p, c, wgi - 1, threadIdx.x & 127);
}

// ---- host: tensor maps and launches

// both passes' maps and scalars; returns 0 or ENCODE_FAILED + a CUresult
template <int D>
int encode(DqParams* a, DkdvParams* c, const void* q, const void* k, const void* v,
           const void* out, const void* dout, int BH, int Sq, int Sk) {
  using C = Cfg<D>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return ENCODE_FAILED + (int)CUDA_ERROR_NOT_FOUND;
  int err = map_rows(enc, &a->q, q, BH, Sq, D, 64);
  err = err ? err : map_rows(enc, &a->dout, dout, BH, Sq, D, 64);
  err = err ? err : map_rows(enc, &a->out, out, BH, Sq, D, 64);
  err = err ? err : map_rows(enc, &a->k, k, BH, Sk, D, C::BC);
  err = err ? err : map_rows(enc, &a->v, v, BH, Sk, D, C::BC);
  err = err ? err : map_rows(enc, &c->k, k, BH, Sk, D, 64);  // C::KEYS / 64 boxes a block
  err = err ? err : map_rows(enc, &c->v, v, BH, Sk, D, 64);
  err = err ? err : map_rows(enc, &c->q, q, BH, Sq, D, C::BQ);
  return err ? err : map_rows(enc, &c->dout, dout, BH, Sq, D, C::BQ);
}

template <int D>
cudaError_t prepare() {  // shared memory above 48 KB, once an instantiation
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(flash_mma_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg<D>::DQ_BYTES);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(flash_mma_bwd_dkdv_kernel<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::DKDV_BYTES);
  }();
  return err;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, const float* bias, const int* kv_len, void* dq, void* dk,
           void* dv, float* dbias_part, float* rowsum, int B, int H, int Sq, int Sk,
           int causal, cudaStream_t stream) {
  using C = Cfg<D>;
  const int n_q_blocks = (Sq + ROWS - 1) / ROWS, n_k_blocks = (Sk + C::KEYS - 1) / C::KEYS;
  if (n_q_blocks > 65535 || n_k_blocks > 65535 || (long long)B * H * Sq > INT32_MAX ||
      (long long)B * H > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare<D>();
  if (err != cudaSuccess) return (int)err;
  DqParams a = {};
  DkdvParams c = {};
  const int enc = encode<D>(&a, &c, q, k, v, out, dout, B * H, Sq, Sk);
  if (enc != 0) return enc;
  const float scale = 1.0f / sqrtf((float)D), scale_log2 = LOG2E * scale;
  a.bias = bias;
  a.lse = lse;
  a.kv_len = kv_len;
  a.dq = static_cast<bf16*>(dq);
  a.rowsum = rowsum;
  a.H = H, a.Sq = Sq, a.Sk = Sk, a.causal = causal;
  a.scale_log2 = scale_log2, a.scale = scale;
  c.lse = lse;
  c.rowsum = rowsum;
  c.bias = bias;
  c.kv_len = kv_len;
  c.dk = static_cast<bf16*>(dk);
  c.dv = static_cast<bf16*>(dv);
  c.dbias_part = dbias_part;
  c.H = H, c.Sq = Sq, c.Sk = Sk, c.causal = causal;
  c.scale_log2 = scale_log2, c.scale = scale;
  flash_mma_bwd_dq_kernel<D><<<dim3(B * H, n_q_blocks), THREADS, C::DQ_BYTES, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_mma_bwd_dkdv_kernel<D><<<dim3(B * H, n_k_blocks), THREADS, C::DKDV_BYTES, stream>>>(c);
  return (int)cudaGetLastError();
}

template <int D>
int occupancy(int pass, int* smem_bytes, int* blocks_per_sm) {
  const cudaError_t err = prepare<D>();
  if (err != cudaSuccess) return (int)err;
  if (pass == 0) {
    *smem_bytes = Cfg<D>::DQ_BYTES;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, flash_mma_bwd_dq_kernel<D>, THREADS, Cfg<D>::DQ_BYTES);
  }
  *smem_bytes = Cfg<D>::DKDV_BYTES;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, flash_mma_bwd_dkdv_kernel<D>, THREADS, Cfg<D>::DKDV_BYTES);
}

template <int D>
int encode_ns(int B, int H, int Sq, int Sk, int reps, double* ns) {
  // addresses are never read while encoding: any 16-byte-aligned values do
  const char* fake = reinterpret_cast<const char*>(uintptr_t{1} << 40);
  DqParams a = {};
  DkdvParams c = {};
  int err = encode<D>(&a, &c, fake, fake, fake, fake, fake, B * H, Sq, Sk);
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps && err == 0; ++i)
    err = encode<D>(&a, &c, fake, fake, fake, fake, fake, B * H, Sq, Sk);
  const auto t1 = std::chrono::steady_clock::now();
  *ns = std::chrono::duration<double, std::nano>(t1 - t0).count() / (reps > 0 ? reps : 1);
  return err;
}

}  // namespace

// bf16 only; D 64 or 128. bias / kv_len / dbias_part may be null; rowsum is
// [B, H, Sq] f32 scratch, written by the dQ pass and read by the dK/dV pass.
// Launches both passes; returns the first cudaGetLastError() that is not 0,
// or ENCODE_FAILED (10000) + the CUresult of a tensor map that did not
// encode (0 on success).
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

// The dynamic shared memory of one pass (0: dQ, 1: dK/dV) at head dim D and
// the blocks of it an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns the CUDA error (0
// on success).
extern "C" int flash_attention_mma_bwd_occupancy(int D, int pass, int* smem_bytes,
                                                 int* blocks_per_sm) {
  switch (D) {
    case 64: return occupancy<64>(pass, smem_bytes, blocks_per_sm);
    case 128: return occupancy<128>(pass, smem_bytes, blocks_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The host's time to encode one call's tensor maps (both passes) at the
// shape (B, H, Sq, Sk, D), in ns averaged over `reps` encodings, into *ns.
// Returns 0 or ENCODE_FAILED + the CUresult.
extern "C" int flash_attention_mma_bwd_encode_ns(int B, int H, int Sq, int Sk, int D, int reps,
                                                 double* ns) {
  switch (D) {
    case 64: return encode_ns<64>(B, H, Sq, Sk, reps, ns);
    case 128: return encode_ns<128>(B, H, Sq, Sk, reps, ns);
    default: return (int)cudaErrorInvalidValue;
  }
}
