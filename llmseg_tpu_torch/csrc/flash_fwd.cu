// Kernel A: exact online-softmax flash attention forward.
//
// Replaces llmseg_tpu/ops/attention.py::_fwd_kernel (launched by _flash_fwd):
// running max / sum / accumulator in float32 over key tiles, exp2-domain
// logits of a pre-scaled q, causal and key-padding masks with the finite
// -1e9, an optional additive log2-domain bias (B*H or 1, T, S) and an
// optional log2 log-sum-exp output for the backward pass.  Rows whose sum is
// 0 divide by 1, as the TPU kernel does.
//
// What bounds it on an H100: at LLaMA-7B's shape (B*H = 128, T = S = 767,
// D = 128, causal) the work is 19 GFLOP against 100 MB of q/k/v/o, so the
// card's limit is its memory rate (about 30 us), with the tensor-core rate
// close behind (about 20 us).  The design keeps every logit, probability
// and the output accumulator in registers: a block owns 64 query rows (4
// warps x 16), streams 64-key tiles of k and v through a two-stage cp.async
// ring, and runs both products on mma.sync (see common.cuh).  Each lane
// holds two rows' running max and sum; the four lanes of a row agree on the
// max by two shuffles, and the partial sums are reduced once at the end.
// Tiles wholly above the diagonal are never loaded; the mask compares run
// only on tiles that reach the diagonal or the ragged end.  wgmma and TMA
// are the next step.
//
// float32 inputs take a plain SIMT kernel (one warp per query row) with the
// same math; it exists for exact comparisons, not for speed.
#include "common.cuh"

using namespace llmseg;

template <int D, int NW>
__global__ void __launch_bounds__(NW * 32)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ bias,
               long long bias_bh_stride, bf16* __restrict__ o, float* __restrict__ lse,
               int T, int S, int causal) {
  using L = Tiles<D, NW>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + L::BQ * L::LD;
  bf16* sV = sK + 2 * BK * L::LD;
  const int bh = blockIdx.y, q0 = blockIdx.x * L::BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, t = lane & 3;
  const int wrow = q0 + warp * 16;  // this warp's first row
  const int row0 = wrow + (lane >> 2), row1 = row0 + 8;
  const bf16* kb = k + (size_t)bh * S * D;
  const bf16* vb = v + (size_t)bh * S * D;
  const float* biasb = bias ? bias + (size_t)bh * bias_bh_stride : nullptr;

  load_tile_async<D, L::THREADS>(sQ, q + (size_t)bh * T * D, q0, L::BQ, T, L::LD);
  load_tile_async<D, L::THREADS>(sK, kb, 0, BK, S, L::LD);
  load_tile_async<D, L::THREADS>(sV, vb, 0, BK, S, L::LD);
  cp_async_commit();

  int n_tiles = (S + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + L::BQ + BK - 1) / BK);
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // l: this lane's partial sums
  uint32_t qa[D / 16][4];

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) {
      load_tile_async<D, L::THREADS>(sK + (st ^ 1) * BK * L::LD, kb, (it + 1) * BK, BK, S, L::LD);
      load_tile_async<D, L::THREADS>(sV + (st ^ 1) * BK * L::LD, vb, (it + 1) * BK, BK, S, L::LD);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) load_q_frags<D>(qa, sQ, L::LD, warp * 16);

    float s[BK / 8][4];
    qk_tile<D>(s, qa, sK + st * BK * L::LD, L::LD);
    const int k0 = it * BK;
    if (biasb || k0 + BK > S || (causal && k0 + BK - 1 > wrow)) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1), row = e < 2 ? row0 : row1;
          const bool keep = key < S && (!causal || key <= row);
          float x = s[j][e];
          if (biasb && keep && row < T) x += biasb[(size_t)row * S + key];
          s[j][e] = keep ? x : NEG_INF;
        }
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
    uint32_t pk[BK / 8][2];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = exp2f(s[j][0] - mn0), p1 = exp2f(s[j][1] - mn0);
      const float p2 = exp2f(s[j][2] - mn1), p3 = exp2f(s[j][3] - mn1);
      ps0 += p0 + p1;
      ps1 += p2 + p3;
      pk[j][0] = pack_bf16(p0, p1);
      pk[j][1] = pack_bf16(p2, p3);
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= al0;
      acc[j][1] *= al0;
      acc[j][2] *= al1;
      acc[j][3] *= al1;
    }
    pv_tile<D>(acc, pk, sV + st * BK * L::LD, L::LD);
    __syncthreads();  // this stage is refilled two tiles on
  }
  cp_async_wait<0>();

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float ls0 = l0 == 0.f ? 1.f : l0, ls1 = l1 == 0.f ? 1.f : l1;
  bf16* ob = o + (size_t)bh * T * D;
  if (row0 < T) {
    store_rows<D>(ob, acc, row0, 0, ls0);
    if (lse && t == 0) lse[(size_t)bh * T + row0] = m0 + log2f(ls0);
  }
  if (row1 < T) {
    store_rows<D>(ob, acc, row1, 1, ls1);
    if (lse && t == 0) lse[(size_t)bh * T + row1] = m1 + log2f(ls1);
  }
}

// float32: one warp per query row, the keys 32 at a time (one per lane).
constexpr int F32_ROWS = 4;

template <int D>
__global__ void __launch_bounds__(F32_ROWS * 32)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ bias,
              long long bias_bh_stride, float* __restrict__ o, float* __restrict__ lse,
              int T, int S, int causal) {
  constexpr int E = D / 32;
  __shared__ float sq[F32_ROWS][D];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, row = blockIdx.x * F32_ROWS + warp;
  if (row >= T) return;
  for (int c = lane; c < D; c += 32) sq[warp][c] = q[((size_t)bh * T + row) * D + c];
  __syncwarp();
  const float* kb = k + (size_t)bh * S * D;
  const float* vb = v + (size_t)bh * S * D;
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
      const float* vr = vb + (size_t)(j0 + jj) * D;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(pj, vr[lane + 32 * e], acc[e]);
    }
  }
  const float l_safe = (l == 0.f) ? 1.f : l;
#pragma unroll
  for (int e = 0; e < E; ++e) o[((size_t)bh * T + row) * D + lane + 32 * e] = acc[e] / l_safe;
  if (lse && lane == 0) lse[(size_t)bh * T + row] = m + log2f(l_safe);
}

template <int D>
static int launch(const void* q, const void* k, const void* v, const void* bias,
                  long long bias_bh_stride, void* o, void* lse, int BH, int T, int S,
                  int is_bf16, int causal, cudaStream_t st) {
  if (is_bf16) {
    constexpr int NW = 4;
    using L = Tiles<D, NW>;
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_bf16<D, NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::BYTES);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((T + L::BQ - 1) / L::BQ, BH);
    flash_fwd_bf16<D, NW><<<grid, L::THREADS, L::BYTES, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)bias, bias_bh_stride,
        (bf16*)o, (float*)lse, T, S, causal);
  } else {
    dim3 grid((T + F32_ROWS - 1) / F32_ROWS, BH);
    flash_fwd_f32<D><<<grid, F32_ROWS * 32, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)bias, bias_bh_stride,
        (float*)o, (float*)lse, T, S, causal);
  }
  return (int)cudaGetLastError();
}

// q (BH, T, D) pre-scaled, k/v (BH, S, D), o like q; bias (B*H or 1, T, S)
// float32 log2-domain or null (bias_bh_stride = T*S, or 0 to broadcast);
// lse (BH, T) float32 or null.  Returns the launch's cudaError_t.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                         long long bias_bh_stride, void* o, void* lse, int BH, int T, int S,
                         int D, int is_bf16, int causal, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64) return launch<64>(q, k, v, bias, bias_bh_stride, o, lse, BH, T, S, is_bf16, causal, st);
  if (D == 128) return launch<128>(q, k, v, bias, bias_bh_stride, o, lse, BH, T, S, is_bf16, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_fwd_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
