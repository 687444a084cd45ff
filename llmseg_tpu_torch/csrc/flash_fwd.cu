// Kernel A: exact online-softmax flash attention forward.
//
// Replaces llmseg_tpu/ops/attention.py::_fwd_kernel (launched by _flash_fwd):
// running max / sum / accumulator in float32 over key tiles, exp2-domain
// logits of a pre-scaled q, the top-left causal mask (key <= row) and key
// padding with the finite -1e9, an optional additive log2-domain bias (B*H
// or 1, T, S) and an optional log2 log-sum-exp output, m + log2(l), for the
// backward kernels.  Rows whose sum is 0 divide by 1, as the TPU kernel does.
//
// What bounds it on an H100: at LLaMA-7B's shape (B*H = 128, T = S = 767,
// D = 128, causal) the work is 19 GFLOP against 100 MB of q/k/v/o, so the
// card's limit is its memory rate (about 30 us), with the tensor-core rate
// close behind (about 20 us).  So each head's k and v should be read as few
// times as possible, by blocks that keep the tensor cores fed.
//
// What the design does: the bf16 path runs on the Hopper forward core
// (fwd_core.cuh).  A CTA owns 128 queries (two consumer warpgroups of 64),
// so a head streams its k/v tiles once per 128 queries, not per 64; the
// tiles are 128 keys, brought by TMA (3-D maps: a ragged tile is zero-filled
// inside its own head) into a two-stage ring at D = 128 (three at D = 64)
// by a producer warp, and both products run on wgmma with P from registers.
// The online softmax of one warpgroup overlaps the other's products.  The
// alpha rescale of O happens in registers after the PV product has landed,
// and the next products are fenced after it.  Tiles wholly above the
// diagonal are never loaded; the mask compares run only on tiles that reach
// the diagonal or the ragged end (or with a bias); the causal query blocks
// start longest first.  What still holds it back at LLaMA's shape: 768
// CTAs of 1 to 6 tiles each, one CTA an SM (160 KB of shared memory), so
// every CTA pays its pipeline fill and epilogue alone; a persistent CTA
// that prefetches its next block is the next step.
//
// Head dims (D of q and k, DV of v and o): (64, 64), (128, 128), and (192,
// 128), multi-head latent attention's heads (DeepSeek-V3, Kimi-VL: a 128-wide
// part from the latent plus a 64-wide rotary part shared by the heads).  At
// (192, 128) q and k take three 64-column boxes, v two; the ring keeps two
// stages (208 KB), and S takes twelve k-steps where D = 128 takes eight,
// with the same registers as (128, 128).  At 16 heads of 767 rows that is
// bound by bytes, as LLaMA's shape is.
//
// float32 inputs take a plain SIMT kernel (one warp per query row) with the
// same math; it exists for exact comparisons, not for speed.
#include "fwd_core.cuh"

using namespace llmseg;

namespace {

// The online softmax of kernel A on one thread's two rows (ra, rb).
struct OnlineSoftmax {
  static constexpr bool ROWSUM = false;  // l sums the unrounded p, in float32
  const float* bias;  // this head's (T, S) bias, or null
  int T, S, causal;
  int row0;    // the warpgroup's first row
  int ra, rb;  // this thread's rows: g and g + 8 of its warp's 16
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};

  __device__ __forceinline__ void scores(float (&s)[64], int tile) {
    const int k0 = tile * 128, t = threadIdx.x & 3;
    if (bias || k0 + 128 > S || (causal && k0 + 127 > row0)) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1), row = e < 2 ? ra : rb;
          const bool keep = key < S && (!causal || key <= row);
          float x = s[4 * j + e];
          if (bias && keep && row < T) x += bias[(size_t)row * S + key];
          s[4 * j + e] = keep ? x : NEG_INF;
        }
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    const float mn0 = fmaxf(m[0], quad_max(mx0)), mn1 = fmaxf(m[1], quad_max(mx1));
    alpha[0] = hopper::ex2(m[0] - mn0);
    alpha[1] = hopper::ex2(m[1] - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s[4 * j] = hopper::ex2(s[4 * j] - mn0);
      s[4 * j + 1] = hopper::ex2(s[4 * j + 1] - mn0);
      s[4 * j + 2] = hopper::ex2(s[4 * j + 2] - mn1);
      s[4 * j + 3] = hopper::ex2(s[4 * j + 3] - mn1);
      ps0 += s[4 * j] + s[4 * j + 1];
      ps1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l[0] = l[0] * alpha[0] + ps0;
    l[1] = l[1] * alpha[1] + ps1;
    m[0] = mn0;
    m[1] = mn1;
  }

  template <int N>
  __device__ __forceinline__ void rescale(float (&o)[N]) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
  }
};

template <int D, int DV>
__global__ void __launch_bounds__(hopper::FWD_THREADS, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const float* __restrict__ bias,
               long long bias_bh_stride, bf16* __restrict__ o, float* __restrict__ lse, int T,
               int S, int causal) {
  using L = hopper::FwdLayout<D, DV>;
  __shared__ hopper::FwdBars bars;
  extern __shared__ unsigned char smem[];
  const uint32_t base = hopper::align1024(smem);
  const int bh = blockIdx.x;
  // causal blocks in reverse order: the longest rows start first
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qb * L::BQ;
  int n_tiles = (S + L::BN - 1) / L::BN;
  if (causal) n_tiles = min(n_tiles, qb + 1);  // BQ == BN: the diagonal tile is qb
  const int wg = hopper::warpgroup_index();
  if (threadIdx.x == 0) hopper::init_bars(bars);
  __syncthreads();
  if (wg == 2) {
    if (threadIdx.x == hopper::PRODUCER_THREAD)
      hopper::produce<D, DV>(&tq, &tk, &tv, base, bars, q0, bh, n_tiles);
    return;
  }
  const int c = wg, warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31, t = lane & 3;
  OnlineSoftmax sm;
  sm.bias = bias ? bias + (size_t)bh * bias_bh_stride : nullptr;
  sm.T = T;
  sm.S = S;
  sm.causal = causal;
  sm.row0 = q0 + 64 * c;
  sm.ra = sm.row0 + 16 * warp + (lane >> 2);
  sm.rb = sm.ra + 8;
  float acc[DV / 2];
  hopper::consume<D, DV>(base, bars, c, n_tiles, sm, acc);

  bf16* ob = o + (size_t)bh * T * DV;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? sm.rb : sm.ra;
    const float l = quad_sum(sm.l[h]);
    const float ls = l == 0.f ? 1.f : l, inv = 1.f / ls;
    if (row >= T) continue;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * DV + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
    if (lse && t == 0) lse[(size_t)bh * T + row] = sm.m[h] + log2f(ls);
  }
}

// float32: one warp per query row, the keys 32 at a time (one per lane).
constexpr int F32_ROWS = 4;

template <int D, int DV>
__global__ void __launch_bounds__(F32_ROWS * 32)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ bias,
              long long bias_bh_stride, float* __restrict__ o, float* __restrict__ lse,
              int T, int S, int causal) {
  constexpr int E = DV / 32;
  __shared__ float sq[F32_ROWS][D];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, row = blockIdx.x * F32_ROWS + warp;
  if (row >= T) return;
  for (int c = lane; c < D; c += 32) sq[warp][c] = q[((size_t)bh * T + row) * D + c];
  __syncwarp();
  const float* kb = k + (size_t)bh * S * D;
  const float* vb = v + (size_t)bh * S * DV;
  const float* biasb = bias ? bias + (size_t)bh * bias_bh_stride + (size_t)row * S : nullptr;
  const int hi = causal ? min(S, row + 1) : S;  // masked keys weigh exp2(-1e9 - m) = 0
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  float m = NEG_INF, l = 0.f;
  for (int j0 = 0; j0 < hi; j0 += 32) {
    const int j = j0 + lane;
    float s = NEG_INF;
    if (j < hi) {
      const float* kr = kb + (size_t)j * D;
      float x = 0.f;
      for (int c = 0; c < D; ++c) x = fmaf(sq[warp][c], kr[c], x);
      s = biasb ? x + biasb[j] : x;
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = exp2f(m - m_new);
    const float p = j < hi ? exp2f(s - m_new) : 0.f;
    l = l * alpha + warp_sum(p);
    m = m_new;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= alpha;
    const int n = min(32, hi - j0);
    for (int jj = 0; jj < n; ++jj) {
      const float pj = __shfl_sync(0xffffffffu, p, jj);
      const float* vr = vb + (size_t)(j0 + jj) * DV;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(pj, vr[lane + 32 * e], acc[e]);
    }
  }
  const float l_safe = (l == 0.f) ? 1.f : l;
#pragma unroll
  for (int e = 0; e < E; ++e) o[((size_t)bh * T + row) * DV + lane + 32 * e] = acc[e] / l_safe;
  if (lse && lane == 0) lse[(size_t)bh * T + row] = m + log2f(l_safe);
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, const void* bias,
           long long bias_bh_stride, void* o, void* lse, int BH, int T, int S, int is_bf16,
           int causal, cudaStream_t st) {
  if (T < 1 || S < 1) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    using L = hopper::FwdLayout<D, DV>;
    constexpr int SMEM = L::BYTES + 1024;  // + the slack of aligning the base to 1024
    static const cudaError_t ready = cudaFuncSetAttribute(
        flash_fwd_bf16<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (ready != cudaSuccess) return (int)ready;
    CUtensorMap tq, tk, tv;
    cudaError_t e = hopper::tensor_map_3d(&tq, q, D, T, BH, L::BQ);
    if (e == cudaSuccess) e = hopper::tensor_map_3d(&tk, k, D, S, BH, L::BN);
    if (e == cudaSuccess) e = hopper::tensor_map_3d(&tv, v, DV, S, BH, L::BN);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(BH, (T + L::BQ - 1) / L::BQ);
    flash_fwd_bf16<D, DV><<<grid, hopper::FWD_THREADS, SMEM, st>>>(
        tq, tk, tv, (const float*)bias, bias_bh_stride, (bf16*)o, (float*)lse, T, S, causal);
  } else {
    dim3 grid((T + F32_ROWS - 1) / F32_ROWS, BH);
    flash_fwd_f32<D, DV><<<grid, F32_ROWS * 32, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)bias, bias_bh_stride,
        (float*)o, (float*)lse, T, S, causal);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q (BH, T, D) pre-scaled, k (BH, S, D), v (BH, S, DV), o (BH, T, DV);
// bias (B*H or 1, T, S) float32 log2-domain or null (bias_bh_stride = T*S, or
// 0 to broadcast); lse (BH, T) float32 or null.  (D, DV) is (64, 64),
// (128, 128) or (192, 128).  Returns the launch's cudaError_t.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                         long long bias_bh_stride, void* o, void* lse, int BH, int T, int S,
                         int D, int DV, int is_bf16, int causal, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64 && DV == 64)
    return launch<64, 64>(q, k, v, bias, bias_bh_stride, o, lse, BH, T, S, is_bf16, causal, st);
  if (D == 128 && DV == 128)
    return launch<128, 128>(q, k, v, bias, bias_bh_stride, o, lse, BH, T, S, is_bf16, causal, st);
  if (D == 192 && DV == 128)
    return launch<192, 128>(q, k, v, bias, bias_bh_stride, o, lse, BH, T, S, is_bf16, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_fwd_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
