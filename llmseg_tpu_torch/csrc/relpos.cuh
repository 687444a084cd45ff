// Shared pieces of the rel-pos attention kernels E (relpos_fwd.cu) and F
// (relpos_window.cu): the layout contract and the float32 SIMT kernel of
// both.
//
// Layout contract: q (BH, T, D) pre-scaled by scale*log2(e) in its own
// dtype; k, v (BH, T, D); rh, rw (BH, T, G) in q's dtype, already scaled by
// log2(e) and rounded to that dtype, with T = G*G.  The bias of query row i
// and key j is rh[i, j / G] + rw[i, j % G] (SAM's decomposed relative
// position bias); it is added to the exp2-domain logit in that order, and
// never materialised.
#pragma once

#include "common.cuh"

namespace llmseg {

constexpr int MAX_G = 64;

// float32: one warp per query row, keys 32 at a time (one per lane), online
// softmax; exists for exact comparisons, not for speed.  D <= 128.
constexpr int RP_F32_ROWS = 4;

__global__ void __launch_bounds__(RP_F32_ROWS * 32)
relpos_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ rh,
           const float* __restrict__ rw, float* __restrict__ o, int T, int G, int D) {
  __shared__ float sq[RP_F32_ROWS][128];
  __shared__ float sb[RP_F32_ROWS][2 * MAX_G];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, row = blockIdx.x * RP_F32_ROWS + warp;
  if (row >= T) return;
  const size_t qrow = (size_t)bh * T + row;
  for (int c = lane; c < D; c += 32) sq[warp][c] = q[qrow * D + c];
  for (int c = lane; c < G; c += 32) {
    sb[warp][c] = rh[qrow * G + c];
    sb[warp][MAX_G + c] = rw[qrow * G + c];
  }
  __syncwarp();
  const float* kb = k + (size_t)bh * T * D;
  const float* vb = v + (size_t)bh * T * D;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // output columns lane + 32 e
  float m = NEG_INF, l = 0.f;
  for (int j0 = 0; j0 < T; j0 += 32) {
    const int j = j0 + lane;
    float s = NEG_INF;
    if (j < T) {
      const float* kr = kb + (size_t)j * D;
      float x = 0.f;
      for (int c = 0; c < D; ++c) x = fmaf(sq[warp][c], kr[c], x);
      const int kh = j / G;
      s = x + sb[warp][kh] + sb[warp][MAX_G + j - kh * G];
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = exp2f(m - m_new);
    const float p = j < T ? exp2f(s - m_new) : 0.f;
    l = l * alpha + warp_sum(p);
    m = m_new;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] *= alpha;
    const int n = min(32, T - j0);
    for (int jj = 0; jj < n; ++jj) {
      const float pj = __shfl_sync(0xffffffffu, p, jj);
      const float* vr = vb + (size_t)(j0 + jj) * D;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (lane + 32 * e < D) acc[e] = fmaf(pj, vr[lane + 32 * e], acc[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (lane + 32 * e < D) o[qrow * D + lane + 32 * e] = acc[e] / l;
}

inline int launch_relpos_f32(const void* q, const void* k, const void* v, const void* rh,
                             const void* rw, void* o, int BH, int T, int G, int D,
                             cudaStream_t st) {
  if (D > 128 || G > MAX_G) return (int)cudaErrorInvalidValue;
  dim3 grid((T + RP_F32_ROWS - 1) / RP_F32_ROWS, BH);
  relpos_f32<<<grid, RP_F32_ROWS * 32, 0, st>>>((const float*)q, (const float*)k,
                                                (const float*)v, (const float*)rh,
                                                (const float*)rw, (float*)o, T, G, D);
  return (int)cudaGetLastError();
}

}  // namespace llmseg
