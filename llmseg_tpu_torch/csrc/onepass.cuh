// The one-pass attention forward of kernels B (flash_fwd_1pass.cu, o
// row-major) and J (flash_fwd_1pass_t.cu, o^T): one kernel body on the
// Hopper forward core (fwd_core.cuh) whose epilogue is its only difference.
//
// The function (the TPU kernels _fwd1_kernel and _fwd1t_kernel): each query
// row gets the Cauchy-Schwarz bound b = max(|q_row| * max_j |k_j|, 1) >= its
// largest logit, fixed before the loop, so p = exp2(s - b) never overflows
// and needs no running maximum and no rescale of O; p is rounded to bf16 and
// o = p v / l with l the sum of the rounded p over the real keys, as the TPU
// kernel's valid lane sums it.  A row whose l is <= 1e-12 (near-orthogonal
// q and k of large norm, where the bound overshoots the true maximum by far)
// is redone with its exact maximum over the real keys.  The TPU kernels
// decide per block; these decide per row, which is the same softmax up to
// rounding.
//
// What bounds it on an H100: the 4 BH T S D tensor-core operations (275
// GFLOP at DINOv2-L@896, B*H = 64, T = S = 4097, D = 64: about 280 us at
// the bf16 peak) and, as close, the exp2 of every logit: 1.07e9 of them at
// 16 a clock on each of 132 SMs, about 290 us.  A kernel that does not
// overlap the two pays their sum.
//
// What the design does: 128 queries a CTA in two consumer warpgroups,
// 128-key tiles of k and v by TMA through a three-stage ring (two at D =
// 128), both products on wgmma with P from registers (fwd_core.cuh).  With
// the bound fixed the probability step is one subtract and one exp2 a
// logit; the row sums of the rounded P come from the tensor cores (P times
// a column of ones, m64n8k16, beside each PV step), and keys past S are
// zeroed only on the last tile.  At D = 64 the exp2 of tile j runs under
// the PV product of tile j - 1, and the two warpgroups interleave, so the
// MUFU and tensor work overlap.  max_j |k_j|^2 comes from a reduction
// kernel over k (blocks of 512 keys, combined by atomicMax) that the same
// C call launches first.  The epilogue divides by l and stages the
// warpgroup's 64 x D block in shared memory: B stores it row-major, 16
// bytes a thread; J transposes it and stores o^T rows of 64 queries.  The
// rescue is a plain warp per flagged query reading k and v from device
// memory: it fires only on adversarial norms, so it is right, not fast.
//
// float32 inputs take a plain SIMT kernel (one warp per query) with the
// same math.
#pragma once

#include "fwd_core.cuh"

namespace llmseg {
namespace onepass {

constexpr float RESCUE_L = 1e-12f;
constexpr int LDO = 66;  // bf16 stride of J's o^T staging rows (64 queries + 2)
template <int D>
constexpr int LDR = D + 8;  // bf16 stride of B's row-major staging rows

constexpr int KN_ROWS = 512;  // k rows a block of the reduction

// kmax2[bh] = max_j |k_j|^2 over the S rows of each head: blocks of
// KN_ROWS rows, 16-byte loads, the lanes of a row reduced by shuffles, the
// blocks of a head combined by an integer atomicMax on the float's bits
// (the order of non-negative floats); kmax2 starts at zero
template <typename T>
__global__ void __launch_bounds__(256) key_norm_max2(const T* __restrict__ k,
                                                     float* __restrict__ kmax2, int S, int D) {
  constexpr int EL = 16 / sizeof(T);
  const int lpr = D / EL, rows = 256 / lpr;  // lanes a row, rows a pass
  const int sub = threadIdx.x % lpr, r0 = threadIdx.x / lpr;
  const T* kb = k + (size_t)blockIdx.x * S * D;
  const int end = min(S, (int)(blockIdx.y + 1) * KN_ROWS);
  float best = 0.f;
  // a uniform trip count: the shuffles below need every lane
  for (int base = blockIdx.y * KN_ROWS; base < end; base += rows) {
    const int r = base + r0;
    float ss = 0.f;
    if (r < end) {
      const uint4 u = *reinterpret_cast<const uint4*>(kb + (size_t)r * D + sub * EL);
      const T* x = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < EL; ++i) {
        const float f = (float)x[i];
        ss = fmaf(f, f, ss);
      }
    }
    for (int off = 1; off < lpr; off <<= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    best = fmaxf(best, ss);
  }
  best = warp_max(best);
  if ((threadIdx.x & 31) == 0) atomicMax(reinterpret_cast<int*>(kmax2) + blockIdx.x, __float_as_int(best));
}

// p = exp2(s - b) of one thread's two rows, zero on keys past S (only the
// last tile has any); the core's pack() rounds it to bf16, and the core sums
// the rounded p of each row on the tensor cores (ROWSUM), as the TPU
// kernel's valid lane does
struct BoundSoftmax {
  static constexpr bool ROWSUM = true;
  int S;
  float b[2], lsum[4];

  __device__ __forceinline__ void scores(float (&s)[64], int tile) {
    const int k0 = tile * 128;
    if (k0 + 128 <= S) {
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = hopper::ex2(s[i] - b[(i >> 1) & 1]);
    } else {
      const int t = threadIdx.x & 3;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = hopper::ex2(s[4 * j + e] - b[e >> 1]);
          s[4 * j + e] = k0 + 8 * j + 2 * t + (e & 1) < S ? x : 0.f;
        }
    }
  }
  template <int N>
  __device__ __forceinline__ void rescale(float (&)[N]) {}
};

// The rescue of one query (a whole warp): the exact maximum of its logits
// over the real keys, then p = bf16(exp2(s - m)) and the output row = p v /
// max(l, 1e-30), its element c written at out[c * ostride] (1 for B's row,
// T for J's column of o^T).  sq: D floats of this warp's shared memory.
template <int D>
__device__ void rescue_row(const bf16* __restrict__ qr, const bf16* __restrict__ kb,
                           const bf16* __restrict__ vb, bf16* __restrict__ out, int S,
                           int ostride, float* sq) {
  constexpr int E = D / 32;
  const int lane = threadIdx.x & 31;
  for (int c = lane; c < D; c += 32) sq[c] = __bfloat162float(qr[c]);
  __syncwarp();
  auto logit = [&](int j) {
    const uint4* kr = reinterpret_cast<const uint4*>(kb + (size_t)j * D);
    float x = 0.f;
#pragma unroll
    for (int c8 = 0; c8 < D / 8; ++c8) {
      const uint4 u = kr[c8];
      const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i) x = fmaf(sq[8 * c8 + i], __bfloat162float(h[i]), x);
    }
    return x;
  };
  float m = NEG_INF;
  for (int j = lane; j < S; j += 32) m = fmaxf(m, logit(j));
  m = warp_max(m);
  float acc[E], l = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  for (int j0 = 0; j0 < S; j0 += 32) {
    const int j = j0 + lane;
    const float p = j < S ? __bfloat162float(__float2bfloat16_rn(exp2f(logit(j) - m))) : 0.f;
    l += warp_sum(p);
    const int n = min(32, S - j0);
    for (int jj = 0; jj < n; ++jj) {
      const float pj = __shfl_sync(0xffffffffu, p, jj);
      const bf16* vr = vb + (size_t)(j0 + jj) * D;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(pj, __bfloat162float(vr[lane + 32 * e]), acc[e]);
    }
  }
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < E; ++e) out[(size_t)(lane + 32 * e) * ostride] = __float2bfloat16(acc[e] / den);
  __syncwarp();
}

// The shared memory after the core's, from ONES: the row-sum product's
// ones, the epilogue's staging for both warpgroups (J: D rows of 64
// queries; B: 64 rows of D), a q row per consumer warp for the rescue, the
// rescue flags
template <int D, bool TR>
struct Extra {
  static constexpr uint32_t ONES = 0;
  static constexpr uint32_t STAGE = hopper::ONES_BYTES;
  static constexpr uint32_t SQ = STAGE + 2 * (TR ? D * LDO : 64 * LDR<D>) * 2;
  static constexpr uint32_t FLAGS = SQ + 8 * D * 4;
  static constexpr uint32_t BYTES = FLAGS + 128 * 4;
  static constexpr int SMEM = hopper::FwdLayout<D>::BYTES + BYTES + 1024;  // + the 1024-alignment slack
};

// The bf16 kernel's body: q (BH, T, D) pre-scaled, k, v (BH, S, D), kmax2
// (BH,) from key_norm_max2; out is o (BH, T, D) or, with TR, o^T (BH, D, T)
template <int D, bool TR>
__device__ __forceinline__ void body(const CUtensorMap* tq, const CUtensorMap* tk,
                                     const CUtensorMap* tv, const bf16* __restrict__ q,
                                     const bf16* __restrict__ k, const bf16* __restrict__ v,
                                     const float* __restrict__ kmax2, bf16* __restrict__ out,
                                     int T, int S) {
  using L = hopper::FwdLayout<D>;
  using X = Extra<D, TR>;
  __shared__ hopper::FwdBars bars;
  extern __shared__ unsigned char smem[];
  const uint32_t base = hopper::align1024(smem);
  unsigned char* gbase = smem + (base - smem_u32(smem));  // the same place, generic
  const int bh = blockIdx.x, q0 = blockIdx.y * L::BQ;
  const int n_tiles = (S + L::BN - 1) / L::BN;
  const int wg = hopper::warpgroup_index();
  if (threadIdx.x == 0) hopper::init_bars(bars);
  __syncthreads();
  if (wg == 2) {
    if (threadIdx.x == hopper::PRODUCER_THREAD)
      hopper::produce<D>(tq, tk, tv, base, bars, q0, bh, n_tiles);
    return;
  }
  const int c = wg, warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r_a = 16 * warp + g;  // this thread's rows in the warpgroup: r_a, r_a + 8
  const int qw = q0 + 64 * c;     // the warpgroup's first query

  // the bound of each row, |q_row| from device memory, a quarter row a lane
  BoundSoftmax sm;
  sm.S = S;
  const float km = sqrtf(kmax2[bh]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qw + r_a + 8 * h;
    float qn = 0.f;
    if (row < T) {
      const uint4* qr = reinterpret_cast<const uint4*>(q + ((size_t)bh * T + row) * D + t * (D / 4));
#pragma unroll
      for (int c8 = 0; c8 < D / 32; ++c8) {
        const uint4 u = qr[c8];
        const bf16* x = reinterpret_cast<const bf16*>(&u);
#pragma unroll
        for (int i = 0; i < 8; ++i) qn = fmaf(__bfloat162float(x[i]), __bfloat162float(x[i]), qn);
      }
    }
    sm.b[h] = fmaxf(sqrtf(quad_sum(qn)) * km, 1.f);
  }

  hopper::write_ones(gbase + L::BYTES + X::ONES);
  hopper::bar_sync(1, 256);  // both consumers: the ones are in
  float acc[D / 2];
  hopper::consume<D>(base, bars, c, n_tiles, sm, acc, base + L::BYTES + X::ONES);

  // o / l into the staging block, the rescue flags
  bf16* so = reinterpret_cast<bf16*>(gbase + L::BYTES + X::STAGE) + c * (TR ? D * LDO : 64 * LDR<D>);
  float* sq = reinterpret_cast<float*>(gbase + L::BYTES + X::SQ) + (4 * c + warp) * D;
  int* flags = reinterpret_cast<int*>(gbase + L::BYTES + X::FLAGS) + 64 * c;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l = quad_sum(sm.lsum[2 * h] + sm.lsum[2 * h + 1]);  // column 0 of P x ones
    const float inv = 1.f / l;  // inf or nan on a row the rescue redoes
    const int r = r_a + 8 * h;
    if (t == 0) flags[r] = !(l > RESCUE_L) && qw + r < T;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float x0 = acc[4 * j + 2 * h] * inv, x1 = acc[4 * j + 2 * h + 1] * inv;
      if constexpr (TR) {
        so[(8 * j + 2 * t) * LDO + r] = __float2bfloat16(x0);
        so[(8 * j + 2 * t + 1) * LDO + r] = __float2bfloat16(x1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(so + r * LDR<D> + 8 * j + 2 * t) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
  }
  hopper::bar_sync(2 + c, 128);  // this warpgroup's staging is written
  const bf16* kb = k + (size_t)bh * S * D;
  const bf16* vb = v + (size_t)bh * S * D;
  if constexpr (TR) {
    // o^T: warp w writes the d rows w, w + 4, ..., 64 queries each
    bf16* otb = out + (size_t)bh * D * T;
    for (int d = warp; d < D; d += 4)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lane + 32 * h;
        if (qw + r < T && !flags[r]) otb[(size_t)d * T + qw + r] = so[d * LDO + r];
      }
    for (int r = warp; r < 64; r += 4)
      if (flags[r])
        rescue_row<D>(q + ((size_t)bh * T + qw + r) * D, kb, vb, otb + qw + r, S, T, sq);
  } else {
    // o: 16 bytes a thread, D / 8 threads a row
    bf16* ob = out + ((size_t)bh * T + qw) * D;
    for (int i = threadIdx.x & 127; i < 64 * (D / 8); i += 128) {
      const int r = i / (D / 8), c8 = i % (D / 8);
      if (qw + r < T && !flags[r])
        *reinterpret_cast<uint4*>(ob + (size_t)r * D + 8 * c8) =
            *reinterpret_cast<const uint4*>(so + r * LDR<D> + 8 * c8);
    }
    for (int r = warp; r < 64; r += 4)
      if (flags[r])
        rescue_row<D>(q + ((size_t)bh * T + qw + r) * D, kb, vb, ob + (size_t)r * D, S, 1, sq);
  }
}

// float32: one warp per query, the keys 32 at a time (one per lane); out
// as in body()
constexpr int F32_ROWS = 4;

template <int D, bool TR>
__global__ void __launch_bounds__(F32_ROWS * 32)
onepass_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ kmax2,
            float* __restrict__ out, int T, int S) {
  constexpr int E = D / 32;
  __shared__ float sq[F32_ROWS][D];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, row = blockIdx.x * F32_ROWS + warp;
  if (row >= T) return;
  float qn = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float x = q[((size_t)bh * T + row) * D + c];
    sq[warp][c] = x;
    qn = fmaf(x, x, qn);
  }
  __syncwarp();
  const float* kb = k + (size_t)bh * S * D;
  const float* vb = v + (size_t)bh * S * D;
  float b = fmaxf(sqrtf(warp_sum(qn)) * sqrtf(kmax2[bh]), 1.f);
  float acc[E], l = 0.f;
  // attempt 0 with the bound; attempt 1 (the rescue) with the exact maximum
  for (int attempt = 0; attempt < 2; ++attempt) {
    if (attempt == 1) {
      if (l > RESCUE_L) break;
      b = NEG_INF;
      for (int j = lane; j < S; j += 32) {
        float x = 0.f;
        for (int c = 0; c < D; ++c) x = fmaf(sq[warp][c], kb[(size_t)j * D + c], x);
        b = fmaxf(b, x);
      }
      b = warp_max(b);
    }
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    l = 0.f;
    for (int j0 = 0; j0 < S; j0 += 32) {
      const int j = j0 + lane;
      float p = 0.f;
      if (j < S) {
        float x = 0.f;
        for (int c = 0; c < D; ++c) x = fmaf(sq[warp][c], kb[(size_t)j * D + c], x);
        p = exp2f(x - b);
      }
      l += warp_sum(p);
      const int n = min(32, S - j0);
      for (int jj = 0; jj < n; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, p, jj);
        const float* vr = vb + (size_t)(j0 + jj) * D;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = fmaf(pj, vr[lane + 32 * e], acc[e]);
      }
    }
  }
  const float den = l > RESCUE_L ? l : fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int c = lane + 32 * e;
    out[TR ? ((size_t)bh * D + c) * T + row : ((size_t)bh * T + row) * D + c] = acc[e] / den;
  }
}

typedef void (*Bf16Kernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap, const bf16*,
                           const bf16*, const bf16*, const float*, bf16*, int, int);

// The C call: max|k|^2 into kmax2, then the bf16 kernel kern (a
// __global__ around body<D, TR>) or the float32 one
template <int D, bool TR>
int launch(Bf16Kernel kern, const void* q, const void* k, const void* v, void* kmax2, void* out,
           int BH, int T, int S, int is_bf16, cudaStream_t st) {
  if (T < 1 || S < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(kmax2, 0, sizeof(float) * BH, st);
  if (e != cudaSuccess) return (int)e;
  const dim3 kn_grid(BH, (S + KN_ROWS - 1) / KN_ROWS);
  if (is_bf16)
    key_norm_max2<bf16><<<kn_grid, 256, 0, st>>>((const bf16*)k, (float*)kmax2, S, D);
  else
    key_norm_max2<float><<<kn_grid, 256, 0, st>>>((const float*)k, (float*)kmax2, S, D);
  if (is_bf16) {
    using L = hopper::FwdLayout<D>;
    constexpr int SMEM = Extra<D, TR>::SMEM;
    static const cudaError_t ready =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (ready != cudaSuccess) return (int)ready;
    CUtensorMap tq, tk, tv;
    e = hopper::tensor_map_3d(&tq, q, D, T, BH, L::BQ);
    if (e == cudaSuccess) e = hopper::tensor_map_3d(&tk, k, D, S, BH, L::BN);
    if (e == cudaSuccess) e = hopper::tensor_map_3d(&tv, v, D, S, BH, L::BN);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(BH, (T + L::BQ - 1) / L::BQ);
    kern<<<grid, hopper::FWD_THREADS, SMEM, st>>>(tq, tk, tv, (const bf16*)q, (const bf16*)k,
                                                   (const bf16*)v, (const float*)kmax2,
                                                   (bf16*)out, T, S);
  } else {
    dim3 grid((T + F32_ROWS - 1) / F32_ROWS, BH);
    onepass_f32<D, TR><<<grid, F32_ROWS * 32, 0, st>>>((const float*)q, (const float*)k,
                                                       (const float*)v, (const float*)kmax2,
                                                       (float*)out, T, S);
  }
  return (int)cudaGetLastError();
}

}  // namespace onepass
}  // namespace llmseg
