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
// first occurrence of the row max; so is the strict '>' scan here). Optional
// nb_len [B] int32: columns at or past nb_len[b] are -inf, which is how the
// port computes the pad-column mask of tome_merge_padded (pads sit at the
// tail, so the mask over the B set is a valid count). A row with no valid
// column returns (-inf, 0), as argmax over an all -inf row does.
//
// What bounds it on the H100: at the main path's largest call (Na 289,
// Nb 288, D 64) one batch member reads ~148 KB and does ~10.7 MFLOP: ~44 ns of
// memory time and ~0.2 us of f32 CUDA-core time, far below a launch, so the
// kernel is launch-bound and needs no tensor cores.
//
// Design: one block of 64 threads per (64-row tile of a, batch member); each
// thread keeps its a row in registers and a running (max, first argmax); b is
// staged through shared memory in tiles of 64 rows and each score is a
// sequential f32 FMA chain over D. 16 columns are scored at a time so that 16
// independent chains hide FMA latency.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // rows of a per block (one per thread)
constexpr int BN = 64;   // rows of b per shared-memory tile
constexpr int SUB = 16;  // columns scored together

template <int D>
__global__ void __launch_bounds__(BM)
tome_scores_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const int* __restrict__ nb_len, float* __restrict__ out_max,
                   int* __restrict__ out_idx, int Na, int Nb) {
  __shared__ __align__(16) float bs[BN][D];
  const int batch = blockIdx.y;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * BM + tid;
  const bool row_ok = row < Na;

  const float* arow = a + ((size_t)batch * Na + (row_ok ? row : 0)) * D;
  const float* bbase = b + (size_t)batch * Nb * D;
  float ar[D];
#pragma unroll
  for (int d = 0; d < D; ++d) ar[d] = row_ok ? arow[d] : 0.f;

  int nb_end = Nb;
  if (nb_len != nullptr) nb_end = min(Nb, max(nb_len[batch], 0));

  float best = -INFINITY;
  int best_idx = 0;
  for (int t0 = 0; t0 < nb_end; t0 += BN) {
    __syncthreads();
    for (int e = tid; e < BN * D; e += BM) {
      const int r = e / D, c = e - (e / D) * D;
      const int br = t0 + r;
      bs[r][c] = br < Nb ? bbase[(size_t)br * D + c] : 0.f;
    }
    __syncthreads();
    if (!row_ok) continue;
#pragma unroll 1
    for (int j0 = 0; j0 < BN; j0 += SUB) {
      float s[SUB];
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) s[jj] = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
#pragma unroll
        for (int jj = 0; jj < SUB; ++jj) {
          const float4 bb = *reinterpret_cast<const float4*>(&bs[j0 + jj][d]);
          s[jj] = fmaf(ar[d], bb.x, s[jj]);
          s[jj] = fmaf(ar[d + 1], bb.y, s[jj]);
          s[jj] = fmaf(ar[d + 2], bb.z, s[jj]);
          s[jj] = fmaf(ar[d + 3], bb.w, s[jj]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const int col = t0 + j0 + jj;
        if (col < nb_end && s[jj] > best) {
          best = s[jj];
          best_idx = col;
        }
      }
    }
  }
  if (!row_ok) return;
  out_max[(size_t)batch * Na + row] = best;
  out_idx[(size_t)batch * Na + row] = best_idx;
}

template <int D>
int launch(const float* a, const float* b, const int* nb_len, float* out_max,
           int* out_idx, int B, int Na, int Nb, cudaStream_t stream) {
  const dim3 grid((Na + BM - 1) / BM, B);
  tome_scores_kernel<D><<<grid, BM, 0, stream>>>(a, b, nb_len, out_max, out_idx, Na, Nb);
  return (int)cudaGetLastError();
}

}  // namespace

// nb_len may be null. Returns the cudaGetLastError() of the launch.
extern "C" int tome_scores_fwd(const float* a, const float* b, const int* nb_len,
                               float* out_max, int* out_idx, int B, int Na, int Nb,
                               int D, void* stream) {
  if (B <= 0 || Na <= 0 || Nb <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(a, b, nb_len, out_max, out_idx, B, Na, Nb, s);
    case 32: return launch<32>(a, b, nb_len, out_max, out_idx, B, Na, Nb, s);
    case 64: return launch<64>(a, b, nb_len, out_max, out_idx, B, Na, Nb, s);
    case 128: return launch<128>(a, b, nb_len, out_max, out_idx, B, Na, Nb, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
