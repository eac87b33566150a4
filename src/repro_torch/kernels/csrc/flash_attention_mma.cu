// Flash-attention forward on Hopper's tensor cores (sm_90a), bf16 at D = 64
// and 128; plain C interface for ctypes.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (Pallas body
// `_kernel`) for every bf16 call at those head dims: each ViT block's
// attention on the Janus main path (D=64, proportional-attention bias, -inf
// bucket pads), the LM prefill's causal attention (D=128), dit-s2 and
// flux-dev's attention, and the training forward (whose log-sum-exp feeds
// csrc/flash_attention_mma_bwd.cu). f32 calls and D in {16, 32} stay on
// csrc/flash_attention.cu (3xTF32), which keeps the f32 whole-path parities.
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
//   so that ex2.approx.ftz does the exponentials.
//   lse (nullable, [B, H, Sq] f32): each row's log-sum-exp of its scaled,
//   clamped-bias, masked scores in natural units, (m + log2 l) * ln 2, for
//   the backward; +inf for a row with no unmasked key, so that the
//   backward's exp(s - lse) is 0 there. Serving passes null; the output does
//   not depend on it.
//
// What bounds it on the H100: 4 * D FLOPs a (query, key) pair. flux-dev's
// gen_1024 call [4, 24, 4608, 128] is 1.04 TFLOP (1.055 ms at the 989
// TFLOP/s bf16 tensor-core peak) over 226 MB (0.068 ms at 3.35 TB/s); the
// LM prefill [8, 24, 1024, 128] causal is 51.6 GFLOP (52 us) over 201 MB (60
// us); the ViT cloud batch [8, 16, 577, 64] with bias 10.9 GFLOP (11 us) over
// 37.8 MB (11.3 us). The long calls are bound by operations, so the design is
// about keeping the tensor cores fed: mma.sync fragments loaded by every warp
// with ldmatrix held them near 0.42 of peak in the backward (PR 26's note in
// flash_attention_mma_bwd.cu), and this kernel's parent, on mma.sync, reached
// 0.21 of the bound at flux.
//
// Design (FlashAttention-3's shape, without its ping-pong):
//   - A block is one or two consumer warpgroups of 64 query rows and a
//     producer warp (W = 1 or 2; 128 W + 32 threads). The grid is 1-D, query
//     blocks varying fastest, so the blocks resident at once share a few
//     heads and their K/V stay in L2; under the causal mask a head's query
//     blocks run heaviest first.
//   - The producer warp issues one TMA copy of the block's Q rows, then
//     streams K/V tiles of 64 keys into a ring of stages guarded by
//     mbarriers (full/empty), from 3-D tensor maps [B*H, S, D] in boxes of
//     64 rows x 64 columns: TMA zero-fills rows past S and writes the
//     128-byte swizzle that the wgmma descriptors read. The tile's bias
//     arrives on the same full barrier through the lanes' cp.async copies.
//     The ring runs up to min(Sk, kv_len) and the block's causal frontier;
//     tiles past them are never loaded.
//   - S = Q.K^T is a wgmma with K read K-major from shared memory; at D = 64
//     Q is held in registers as A fragments (ldmatrix from the swizzled
//     tile, 16 registers a thread), at D = 128 read from shared memory too.
//     The online softmax runs on the accumulator layout (a thread holds 2
//     rows; max and sum over the quad by shuffles, four partial chains a
//     row; ex2). P, rounded to bf16, is the register A operand of O += P.V,
//     V read MN-major through the transpose bit (64 x D, D/2 floats a
//     thread). A tile with no bias and no masked pair takes the maximum of
//     the raw scores and forms each weight as ex2(s * scale - m), one FFMA;
//     the masks are code only on the tiles that hold a masked pair (one
//     path for both, predicated, held the bias rows' softmax at ~1.7x).
//   - Pipelined: step j issues S_j and O += P_{j-1}.V_{j-1} together (two
//     commit groups) and forms P_j while the second runs; once that is done
//     O takes P_j's rescale (skipped when no row of the warp has a new
//     maximum), off the path from one step's products to the next.
//   - Both warpgroups walk the block's tiles (under the causal mask
//     warpgroup 0's last one is masked for its rows). A last tile of at most
//     32 live keys (past min(Sk, kv_len) or the frontier) is trimmed to the
//     least of N = 8, 16, 32 covering them and runs after the pipeline, in
//     its own registers: a trimmed product into the pipeline's accumulators
//     made ptxas serialise every wgmma (C7511). A 1-key tail at 577 tokens
//     costs an n8 product. Masks apply element by element only on tiles that
//     hold a masked pair. A leading tile masked for one row but not for the
//     block leaves that row's m at -1e30, so exp(s - m) = 1 fills l and O
//     with junk: the first real key scales it by exp(-1e30 - m) = 0, and a
//     row that never sees one outputs 0.
//   - No atomics: each output row is one thread quad's sums in key order, so
//     the output and lse are the same bit for bit from run to run.
//   - The output leaves through the warpgroup's own Q rows of shared memory
//     (written in the swizzle, read back in 16-byte stores).
// Registers: ptxas grants a 288-thread block (W = 2) 168 registers a thread,
// as it does a 384-thread one: Q in registers at D = 128 spilled (32 B, and
// 2.49 ms against 1.87 at flux gen_1024), and a 128-key tile at D = 128
// would hold S (64) and P (32) beside O (64). The design fits 168: a
// consumer thread holds O (D/2), S (32) and P (16), 168 registers at
// D = 128 and 128 at D = 64, no spill. A block without the producer warp
// (256 threads, 255 registers, a consumer warp refilling the ring) fitted
// 128-key tiles but ran slower at every shape timed, and is not kept.
// Warpgroups a block, a rule on the call against the card: at D = 128 two
// when the grid of 128-row blocks, B*H*ceil(Sq/128), gives every SM at
// least one block; else, and at every D = 64 call, one, with three blocks
// an SM at D = 64 (128 registers) and two at D = 128. One warpgroup a block
// was faster at every D = 64 shape timed (more warps an SM), two at the long
// D = 128 calls (one: 2.59 ms against 1.87 at flux gen_1024).
// Shared memory: Q 8 KB a warpgroup and panel of 64 columns, a stage 16 KB
// (D=64) or 32 KB (D=128); 4 stages (2 at D = 128 with one warpgroup, so
// that two blocks fit an SM).
// What holds it (tools/flash_mma_ablations.py, clock64 marks in one block at
// flux gen_1024): a step of 64 keys takes ~1710 clocks for ~1024 of the two
// warpgroups' tensor-core work; ~780-990 of them are the softmax, whose 32
// exponentials a thread share the SM's MUFU with the other warpgroup's
// (without them the call takes 0.91x the time; without the S products
// 0.85x). Ping-pong scheduling (each warpgroup issuing its products on its
// turn, one's softmax under the other's products) was slower: the softmax
// outlasts the other's products.
// Each call encodes its three tensor maps on the host (hopper.cuh).
// Out of scope here: persistent blocks, clusters (TMA multicast of K/V),
// native GQA (the caller repeats K/V heads), strided q/k/v, fp8.
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int BN = 64;  // keys a streamed tile
constexpr float LN2 = 0.6931471805599453f;
// Q is held in registers as A fragments at D = 64 (16 registers a thread);
// at D = 128 it is read from shared memory (32 more registers spilled)
template <int D>
constexpr bool Q_REGS = D == 64;

// Tiles and shared memory of one head dim and W consumer warpgroups. Tile
// regions start on 1024 bytes (the 128-byte swizzle's period); the bias
// stages and the mbarriers follow them.
template <int D, int W>
struct Cfg {
  static constexpr int NP = D / PANEL;          // panels a row
  static constexpr int THREADS = 128 * W + 32;  // consumer warpgroups, then the producer warp
  static constexpr int ROWS = 64 * W;           // query rows a block
  // blocks an SM the launch bound asks for (the registers a thread follow)
  static constexpr int MIN_BLOCKS = W == 2 ? 1 : (D == 64 ? 3 : 2);
  static constexpr int STAGES = W == 2 || D == 64 ? 4 : 2;
  static constexpr int Q_PANEL = ROWS * 128, Q_TILE = NP * Q_PANEL;
  static constexpr int KV_PANEL = BN * 128, KV_TILE = NP * KV_PANEL;
  // Q | STAGES x (K, V) | STAGES x bias[BN] | full[STAGES], empty[STAGES], resident
  static constexpr int RING = Q_TILE;
  static constexpr int BIAS = RING + STAGES * 2 * KV_TILE;
  static constexpr int BAR = BIAS + STAGES * BN * 4;
  static constexpr int BYTES = BAR + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
};

struct FwdParams {
  CUtensorMap q, k, v;  // boxes of 64 rows
  const float* bias;
  const int* kv_len;
  bf16* out;
  float* lse;
  int H, Sq, Sk, causal;
  float scale_log2;
};

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// the length of an array type (through a reference)
template <typename A>
constexpr int extent = (int)std::extent_v<std::remove_reference_t<A>>;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

template <int D, int W>
__global__ void __launch_bounds__(Cfg<D, W>::THREADS, Cfg<D, W>::MIN_BLOCKS)
flash_mma_fwd_kernel(const __grid_constant__ FwdParams p) {
  using C = Cfg<D, W>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sQ = base, sRing = base + C::RING;
  float* bias_s = reinterpret_cast<float*>(gbase + C::BIAS);  // [STAGES][BN]
  const uint32_t bar = base + C::BAR;  // full[STAGES], empty[STAGES], resident
  const uint32_t resident = bar + 16 * C::STAGES;

  // query blocks vary fastest, so the blocks resident at once share a few
  // heads and their K/V tiles stay in L2 (with heads varying fastest flux
  // gen_1024's call took 2.38 ms against 1.87, the vit-l16 train call 0.283
  // against 0.156: tools/flash_mma_ablations.py)
  const int n_q_blocks = (p.Sq + C::ROWS - 1) / C::ROWS;
  const int bh = blockIdx.x / n_q_blocks, qb = blockIdx.x % n_q_blocks, b = bh / p.H;
  const int q0 = (p.causal ? n_q_blocks - 1 - qb : qb) * C::ROWS;
  const int shift = p.Sk - p.Sq;  // bottom-right causal alignment
  int kend = p.Sk;
  if (p.kv_len != nullptr) kend = min(kend, max(p.kv_len[b], 0));
  int blk_end = kend;  // keys any row of the block sees end here
  if (p.causal) blk_end = min(blk_end, max(min(q0 + C::ROWS, p.Sq) + shift, 0));
  const int n_tiles = (blk_end + BN - 1) / BN;
  const int n_live = min(W, (p.Sq - q0 + 63) / 64);  // warpgroups with a row before Sq

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar + 8 * s, 33);  // the copies' expect_tx and each producer lane's bias
      mbar_init(bar + 8 * (C::STAGES + s), 4 * n_live);  // one arrival a consumer warp
    }
    mbar_init(resident, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the role as a warp-uniform value: wgmma acts on whole warpgroups
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  if (wg == W) {  // the producer warp
    const int lane = threadIdx.x & 31;
    if (lane == 0) {  // Q, also when no key is seen
      mbar_expect_tx(resident, C::Q_TILE);
      for (int w = 0; w < W; ++w)
        for (int pp = 0; pp < C::NP; ++pp)
          tma_3d(sQ + pp * C::Q_PANEL + w * 64 * 128, &p.q, resident, pp * PANEL, q0 + 64 * w,
                 bh);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % C::STAGES, t0 = i * BN;
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
        for (int c = lane; c < BN; c += 32) {
          const bool ok = t0 + c < p.Sk;
          cp_async4(smem_u32(bias_s + s * BN + c),
                    p.bias + (ok ? (size_t)b * p.Sk + t0 + c : 0), ok);
        }
      cp_async_arrive(full);  // when the lane's copies land
    }
    return;
  }

  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // accumulator row group, thread in quad
  const int r0 = q0 + 64 * wg;            // the warpgroup's first query row
  if (r0 >= p.Sq) return;
  const int row0 = r0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  // Both warpgroups walk the block's tiles: full tiles through the pipeline,
  // then a tail of at most 32 live keys at its trimmed width.
  const int live_last = blk_end - (n_tiles - 1) * BN;
  const bool tail = n_tiles > 0 && live_last <= 32;
  const int n_full = n_tiles - tail;

  mbar_wait(resident, 0);
  // D = 64: Q in registers as A fragments, once (the warp's 16 rows, 16
  // columns a k-step; lane l reads row l % 16, the 8 columns l / 16 of the
  // step). D = 128: Q stays in shared memory (the registers hold O instead).
  uint32_t qf[Q_REGS<D> ? D / 16 : 1][4];
  if constexpr (Q_REGS<D>) {
    const int r = wg * 64 + warp * 16 + (lane & 15);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = (kk & 3) * 2 + (lane >> 4);
      ldsm_x4(sQ + (kk >> 2) * C::Q_PANEL + r * 128 + ((c ^ (r & 7)) << 4), qf[kk]);
    }
  }
  const uint64_t dq = sw128_desc(sQ + wg * 64 * 128, 0);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // rows row0 and row0 + 8, log2 units
  float a0 = 1.f, a1 = 1.f;  // the scale O takes before the next P.V
  float sc[BN / 2];          // S of the newest tile, then its P in f32
  uint32_t pf[BN / 16][4];   // P rounded to bf16: the A fragments of P.V

  // S = Q.K^T of stage st into s (64 x N, N/2 floats a thread); one commit
  // group
  auto s_product = [&](auto& s, int st) {
    constexpr int N = 2 * extent<decltype(s)>;
    const uint64_t dk = sw128_desc(sRing + st * 2 * C::KV_TILE, 0);
    __syncwarp();
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t rb = ((kk >> 2) * C::KV_PANEL + (kk & 3) * 32) >> 4;
      if constexpr (Q_REGS<D>)
        wgmma_rs_k<N>(s, qf[kk], dk + rb, kk);
      else
        wgmma_ss<N>(s, dq + (((kk >> 2) * C::Q_PANEL + (kk & 3) * 32) >> 4), dk + rb, kk);
    }
    wg_commit();
  };
  // O *= a: O's sums move to the newest running max (after P_{j-1}.V_{j-1}
  // is done and before P_j.V_j is issued); skipped when no row of the warp
  // has a new maximum (multiplying by 1 changes no bit)
  auto rescale = [&] {
    if (!__any_sync(0xffffffffu, a0 != 1.f || a1 != 1.f)) return;
#pragma unroll
    for (int x = 0; x < D / 2; x += 4) {
      o[x] *= a0;
      o[x + 1] *= a0;
      o[x + 2] *= a1;
      o[x + 3] *= a1;
    }
  };
  // O += P.V of stage st, P the A fragments f of NK k-steps of 16 keys (V
  // MN-major); one commit group
  auto pv_product = [&](auto& f, int st) {
    constexpr int NK = extent<decltype(f)>;
    const uint64_t dv = sw128_desc(sRing + st * 2 * C::KV_TILE + C::KV_TILE, C::KV_PANEL);
    __syncwarp();
    wg_fence();
    reg_fence(o);
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) wgmma_rs<D>(o, f[ks], dv + ((ks * 2048) >> 4));
    wg_commit();
  };
  // scale, bias and mask S (in s) of the tile at key t0 (stage st), then the
  // online softmax in log2 units: m, l and the scale a of O; P in f32 into s.
  // Maxima and sums run over four partial chains a row. A tile with no bias
  // and no masked pair takes the maximum of the raw scores and forms each
  // weight as ex2(s * scale - m) in one FFMA.
  auto softmax = [&](auto& s, int t0, int st) {
    constexpr int N = 2 * extent<decltype(s)>, J = N / 8, R = J < 4 ? J : 4;
    const bool edge = t0 + N > kend || (p.causal && t0 + N - 1 > r0 + shift);
    const bool plain = !edge && p.bias == nullptr;
    float mx0[R], mx1[R];
#pragma unroll
    for (int r = 0; r < R; ++r) mx0[r] = mx1[r] = NEG;
    if (plain) {
#pragma unroll
      for (int r = 0; r < R; ++r) mx0[r] = mx1[r] = -INFINITY;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        mx0[j % R] = fmaxf(mx0[j % R], fmaxf(s[4 * j], s[4 * j + 1]));
        mx1[j % R] = fmaxf(mx1[j % R], fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
    } else {  // scale, bias and, on an edge tile only, the masks (instantiated apart)
      auto scale_bias_mask = [&](auto masked) {
        const float* bt = bias_s + st * BN;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          float2 bb = make_float2(0.f, 0.f);
          if (p.bias != nullptr) bb = *reinterpret_cast<const float2*>(bt + 8 * j + 2 * t4);
          const float b0 = fmaxf(bb.x, NEG) * LOG2E, b1 = fmaxf(bb.y, NEG) * LOG2E;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 4 * j + e;
            float y = fmaf(s[x], p.scale_log2, (e & 1) ? b1 : b0);
            if constexpr (decltype(masked)::value) {
              const int kpos = t0 + 8 * j + 2 * t4 + (e & 1), qpos = row0 + (e >> 1) * 8;
              if (kpos >= kend || (p.causal && kpos > qpos + shift)) y = NEG;
            }
            s[x] = y;
          }
          mx0[j % R] = fmaxf(mx0[j % R], fmaxf(s[4 * j], s[4 * j + 1]));
          mx1[j % R] = fmaxf(mx1[j % R], fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
      };
      if (edge) scale_bias_mask(std::true_type{});
      else scale_bias_mask(std::false_type{});
    }
#pragma unroll
    for (int r = 1; r < R; ++r) {
      mx0[0] = fmaxf(mx0[0], mx0[r]);
      mx1[0] = fmaxf(mx1[0], mx1[r]);
    }
    float t0m = quad_max(mx0[0]), t1m = quad_max(mx1[0]);
    if (plain) {  // raw maxima to log2 units (the scale is positive)
      t0m *= p.scale_log2;
      t1m *= p.scale_log2;
    }
    const float mn0 = fmaxf(m0, t0m), mn1 = fmaxf(m1, t1m);
    a0 = ex2(m0 - mn0);
    a1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0[R], ps1[R];
#pragma unroll
    for (int r = 0; r < R; ++r) ps0[r] = ps1[r] = 0.f;
    if (plain) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        s[4 * j] = ex2(fmaf(s[4 * j], p.scale_log2, -mn0));
        s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], p.scale_log2, -mn0));
        s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], p.scale_log2, -mn1));
        s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], p.scale_log2, -mn1));
        ps0[j % R] += s[4 * j] + s[4 * j + 1];
        ps1[j % R] += s[4 * j + 2] + s[4 * j + 3];
      }
    } else {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        s[4 * j] = ex2(s[4 * j] - mn0);
        s[4 * j + 1] = ex2(s[4 * j + 1] - mn0);
        s[4 * j + 2] = ex2(s[4 * j + 2] - mn1);
        s[4 * j + 3] = ex2(s[4 * j + 3] - mn1);
        ps0[j % R] += s[4 * j] + s[4 * j + 1];
        ps1[j % R] += s[4 * j + 2] + s[4 * j + 3];
      }
    }
#pragma unroll
    for (int r = 1; r < R; ++r) {
      ps0[0] += ps0[r];
      ps1[0] += ps1[r];
    }
    l0 = l0 * a0 + ps0[0];
    l1 = l1 * a1 + ps1[0];
  };
  // P rounded to bf16 as A fragments (zeros past an 8-wide tile)
  auto pack = [&](auto& f, const auto& s) { to_frags<2 * extent<decltype(s)>>(f, s); };
  auto full_wait = [&](int i) { mbar_wait(bar + 8 * (i % C::STAGES), (i / C::STAGES) & 1); };
  auto release = [&](int i) {  // this warp is done with tile i's stage
    __syncwarp();
    if (lane == 0) mbar_arrive(bar + 8 * (C::STAGES + i % C::STAGES));
  };

  if (n_full > 0) {
    // step 0: S_0 and P_0
    full_wait(0);
    s_product(sc, 0);
    wg_wait<0>();
    reg_fence(sc);
    softmax(sc, 0, 0);
    pack(pf, sc);
    // step j: S_j and O += P_{j-1}.V_{j-1} issued together, P_j formed while
    // the second runs; then O takes P_j's rescale, and stage j - 1 is free
#pragma unroll 1
    for (int j = 1; j < n_full; ++j) {
      full_wait(j);
      s_product(sc, j % C::STAGES);
      pv_product(pf, (j - 1) % C::STAGES);
      wg_wait<1>();
      reg_fence(sc);
      softmax(sc, j * BN, j % C::STAGES);
      wg_wait<0>();
      reg_fence(o);
      reg_fence(pf);
      rescale();
      release(j - 1);
      pack(pf, sc);
    }
    // the last full tile's P.V
    pv_product(pf, (n_full - 1) % C::STAGES);
    wg_wait<0>();
    reg_fence(o);
    reg_fence(pf);
    release(n_full - 1);
  }
  if (tail) {  // N keys wide: the least of 8, 16, 32 covering the live ones
    const int st = n_full % C::STAGES;
    // its own accumulator and fragments, one product at a time: a trimmed
    // product into the pipeline's registers made ptxas serialise every wgmma
    auto tile = [&](auto n) {
      constexpr int N = decltype(n)::value;
      float s[N / 2];
      uint32_t f[(N + 15) / 16][4];
      s_product(s, st);
      wg_wait<0>();
      reg_fence(s);
      softmax(s, n_full * BN, st);
      pack(f, s);
      rescale();
      pv_product(f, st);
      wg_wait<0>();
      reg_fence(o);
      reg_fence(f);
    };
    full_wait(n_full);
    if (live_last > 16) tile(Int<32>{});
    else if (live_last > 8) tile(Int<16>{});
    else tile(Int<8>{});
    release(n_full);
  }

  // finish: each row's lse, then O through the warpgroup's own Q rows
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const bool any0 = m0 > 0.5f * NEG, any1 = m1 > 0.5f * NEG;
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  if (p.lse != nullptr && t4 == 0) {
    float* lse = p.lse + (size_t)bh * p.Sq;
    if (row0 < p.Sq) lse[row0] = any0 ? (m0 + log2f(d0)) * LN2 : INFINITY;
    if (row0 + 8 < p.Sq) lse[row0 + 8] = any1 ? (m1 + log2f(d1)) * LN2 : INFINITY;
  }
  unsigned char* stage = gbase + wg * 64 * 128;
  wg_sync(1 + wg);  // every warp of the warpgroup has read its Q rows
  const int ra = warp * 16 + g, rb = ra + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    unsigned char* panel = stage + (j >> 3) * C::Q_PANEL + (((j & 7) ^ g) << 4) + 4 * t4;
    *reinterpret_cast<__nv_bfloat162*>(panel + ra * 128) = __floats2bfloat162_rn(
        any0 ? o[4 * j] / d0 : 0.f, any0 ? o[4 * j + 1] / d0 : 0.f);
    *reinterpret_cast<__nv_bfloat162*>(panel + rb * 128) = __floats2bfloat162_rn(
        any1 ? o[4 * j + 2] / d1 : 0.f, any1 ? o[4 * j + 3] / d1 : 0.f);
  }
  wg_sync(1 + wg);
  copy_out<D>(p.out + (size_t)bh * p.Sq * D, stage, C::Q_PANEL, r0, p.Sq, tid);
}

// ---- host

template <int D, int W>
cudaError_t prepare() {  // shared memory above 48 KB, once an instantiation
  static const cudaError_t err = cudaFuncSetAttribute(
      flash_mma_fwd_kernel<D, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D, W>::BYTES);
  return err;
}

// the rule of the header: two consumer warpgroups a block at D = 128 when
// 128-row blocks give every SM one, else one
int warpgroups(int B, int H, int Sq, int D) {
  if (D != 128) return 1;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;  // the H100 SXM's; an error here resurfaces at the launch
  return (long long)B * H * ((Sq + 127) / 128) >= sms ? 2 : 1;
}

template <int D, int W>
int launch_w(const FwdParams& p, int BH, int Sq, cudaStream_t stream) {
  using C = Cfg<D, W>;
  const long long n_blocks = (long long)BH * ((Sq + C::ROWS - 1) / C::ROWS);
  if (n_blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  const cudaError_t err = prepare<D, W>();
  if (err != cudaSuccess) return (int)err;
  flash_mma_fwd_kernel<D, W><<<(unsigned)n_blocks, C::THREADS, C::BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, const float* bias, const int* kv_len,
           void* out, float* lse, int B, int H, int Sq, int Sk, int causal,
           cudaStream_t stream) {
  if ((long long)B * H > INT32_MAX || (long long)B * H * Sq > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return ENCODE_FAILED + (int)CUDA_ERROR_NOT_FOUND;
  FwdParams p = {};
  const int BH = B * H;
  int err = map_rows(enc, &p.q, q, BH, Sq, D, 64);
  err = err ? err : map_rows(enc, &p.k, k, BH, Sk, D, BN);
  err = err ? err : map_rows(enc, &p.v, v, BH, Sk, D, BN);
  if (err != 0) return err;
  p.bias = bias;
  p.kv_len = kv_len;
  p.out = static_cast<bf16*>(out);
  p.lse = lse;
  p.H = H, p.Sq = Sq, p.Sk = Sk, p.causal = causal;
  p.scale_log2 = LOG2E / sqrtf((float)D);
  if constexpr (D == 128)
    if (warpgroups(B, H, Sq, D) == 2) return launch_w<D, 2>(p, BH, Sq, stream);
  return launch_w<D, 1>(p, BH, Sq, stream);
}

template <int D, int W>
int occupancy(int* smem_bytes, int* blocks_per_sm) {
  const cudaError_t err = prepare<D, W>();
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = Cfg<D, W>::BYTES;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, flash_mma_fwd_kernel<D, W>, Cfg<D, W>::THREADS, Cfg<D, W>::BYTES);
}

}  // namespace

// bf16 only; D 64 or 128. bias / kv_len / lse may be null. Returns the
// cudaGetLastError() of the launch (0 on success), or ENCODE_FAILED (10000)
// + the CUresult of a tensor map that did not encode.
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

// The consumer warpgroups a block (1 or 2) that a call at (B, H, Sq, D) gets
// on the current device, by the header's rule.
extern "C" int flash_attention_mma_fwd_warpgroups(int B, int H, int Sq, int D) {
  return warpgroups(B, H, Sq, D);
}

// The dynamic shared memory of the instantiation at head dim D with W
// consumer warpgroups and the blocks of it an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns the CUDA error (0
// on success).
extern "C" int flash_attention_mma_fwd_occupancy(int D, int W, int* smem_bytes,
                                                 int* blocks_per_sm) {
  if (D == 64 && W == 1) return occupancy<64, 1>(smem_bytes, blocks_per_sm);
  if (D == 128 && W == 1) return occupancy<128, 1>(smem_bytes, blocks_per_sm);
  if (D == 128 && W == 2) return occupancy<128, 2>(smem_bytes, blocks_per_sm);
  return (int)cudaErrorInvalidValue;
}
