// Kernel B: non-causal one-pass attention forward with a fixed row bound.
//
// Replaces llmseg_tpu/ops/attention.py::_fwd1_kernel (launched by
// _flash_fwd_1pass).  Each query row gets the Cauchy-Schwarz bound
// b = max(|q_row| * max_j |k_j|, 1) >= its largest logit, so p = exp2(s - b)
// never overflows and needs no running maximum: the tiles of k and v are
// streamed once and their contributions simply add up, with no rescale of
// the accumulator.  The denominator sums the bf16-rounded p over real keys
// only, which is what the TPU kernel's ones-lane on v gives; keys past S
// contribute to neither sum.
//
// Rescue: where the bound sits far above the true maximum (near-orthogonal
// q and k of large norm) the sum l underflows.  A row with l <= 1e-12 is
// redone with its exact masked row maximum: one more sweep over the keys
// for the maximum, one for the sums.  The TPU kernel decides per block
// (any row of the block); this kernel decides per row, which is the same
// softmax up to rounding.  The extra sweeps run only in blocks that hold
// such a row.
//
// What bounds it on an H100: at DINOv2-L@896 (B*H = 64, T = S = 4097, D = 64)
// the work is 275 GFLOP against 8 MB of q/k/v/o, so the tensor cores bound it
// (about 280 us at the bf16 peak).  The TPU kernel held the whole key row in
// VMEM; 4097 x 64 bf16 keys and values (1 MB) do not fit shared memory, so a
// block streams 64-key tiles through a two-stage cp.async ring while it
// computes on the previous tile.  Both products run on mma.sync with the
// logits, probabilities and output accumulator in registers (see
// common.cuh); the fixed bound means one exp2 per logit and no per-tile
// rescale.  A block holds 128 query rows (8 warps) at D = 64, so each k/v
// tile read from L2 serves 128 rows.  wgmma and TMA are the next step.
//
// float32 inputs take a plain SIMT kernel (one warp per query row).
#include "common.cuh"

using namespace llmseg;

constexpr float RESCUE_L = 1e-12f;

// One sweep of a warp's 16 rows over all key tiles.  MAX_ONLY: fold the
// row maxima of the logits over real keys into m0 / m1 (rows g, g+8).
// Otherwise: o += p v and l0 / l1 += sum p with p = bf16(exp2(s - b)).
// Per-lane partial results; the caller reduces over the quad.
template <int D, int NW, bool MAX_ONLY>
__device__ __forceinline__ void sweep(const uint32_t (&qa)[D / 16][4], bf16* sK, bf16* sV,
                                      const bf16* __restrict__ kb, const bf16* __restrict__ vb,
                                      int S, float b0, float b1, float (&o)[D / 8][4],
                                      float& l0, float& l1, float& m0, float& m1) {
  using L = Tiles<D, NW>;
  const int t = threadIdx.x & 3;
  const int n_tiles = (S + BK - 1) / BK;
  load_tile_async<D, L::THREADS>(sK, kb, 0, BK, S, L::LD);
  if (!MAX_ONLY) load_tile_async<D, L::THREADS>(sV, vb, 0, BK, S, L::LD);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) {
      load_tile_async<D, L::THREADS>(sK + (st ^ 1) * BK * L::LD, kb, (it + 1) * BK, BK, S, L::LD);
      if (!MAX_ONLY)
        load_tile_async<D, L::THREADS>(sV + (st ^ 1) * BK * L::LD, vb, (it + 1) * BK, BK, S, L::LD);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float s[BK / 8][4];
    qk_tile<D>(s, qa, sK + st * BK * L::LD, L::LD);
    const int k0 = it * BK;
    const bool full = k0 + BK <= S;
    if (MAX_ONLY) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (full || k0 + 8 * j + 2 * t + (e & 1) < S) {
            if (e < 2) m0 = fmaxf(m0, s[j][e]);
            else m1 = fmaxf(m1, s[j][e]);
          }
    } else {
      uint32_t pk[BK / 8][2];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool real = full || k0 + 8 * j + 2 * t + (e & 1) < S;
          p[e] = real ? exp2f(s[j][e] - (e < 2 ? b0 : b1)) : 0.f;
        }
        pk[j][0] = pack_bf16(p[0], p[1], l0);
        pk[j][1] = pack_bf16(p[2], p[3], l1);
      }
      pv_tile<D>(o, pk, sV + st * BK * L::LD, L::LD);
    }
    __syncthreads();  // this stage is refilled two tiles on
  }
  cp_async_wait<0>();
}

template <int D, int NW>
__global__ void __launch_bounds__(NW * 32)
flash_fwd_1pass_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ kmax,
                     bf16* __restrict__ o, int T, int S) {
  using L = Tiles<D, NW>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + L::BQ * L::LD;
  bf16* sV = sK + 2 * BK * L::LD;
  const int bh = blockIdx.y, q0 = blockIdx.x * L::BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int row0 = q0 + warp * 16 + (lane >> 2), row1 = row0 + 8;
  const bf16* kb = k + (size_t)bh * S * D;
  const bf16* vb = v + (size_t)bh * S * D;
  bf16* ob = o + (size_t)bh * T * D;

  load_tile_async<D, L::THREADS>(sQ, q + (size_t)bh * T * D, q0, L::BQ, T, L::LD);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[D / 16][4];
  load_q_frags<D>(qa, sQ, L::LD, warp * 16);

  // Cauchy-Schwarz row bounds from the bf16 q rows, in float32
  float qn0 = 0.f, qn1 = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h;
      memcpy(&h, &qa[kk][i], sizeof(h));
      const float x = __low2float(h), y = __high2float(h);
      if (i & 1) qn1 += x * x + y * y;
      else qn0 += x * x + y * y;
    }
  const float km = kmax[bh];
  const float b0 = fmaxf(sqrtf(quad_sum(qn0)) * km, 1.f);
  const float b1 = fmaxf(sqrtf(quad_sum(qn1)) * km, 1.f);

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float l0 = 0.f, l1 = 0.f, m0 = NEG_INF, m1 = NEG_INF;
  sweep<D, NW, false>(qa, sK, sV, kb, vb, S, b0, b1, acc, l0, l1, m0, m1);
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const bool ok0 = l0 > RESCUE_L, ok1 = l1 > RESCUE_L;
  if (ok0 && row0 < T) store_rows<D>(ob, acc, row0, 0, l0);
  if (ok1 && row1 < T) store_rows<D>(ob, acc, row1, 1, l1);
  if (!__syncthreads_or((!ok0 && row0 < T) || (!ok1 && row1 < T))) return;

  // rescue: exact row maxima, then the sums again with them
  sweep<D, NW, true>(qa, sK, sV, kb, vb, S, 0.f, 0.f, acc, l0, l1, m0, m1);
  m0 = quad_max(m0);
  m1 = quad_max(m1);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  l0 = l1 = 0.f;
  sweep<D, NW, false>(qa, sK, sV, kb, vb, S, m0, m1, acc, l0, l1, m0, m1);
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (!ok0 && row0 < T) store_rows<D>(ob, acc, row0, 0, fmaxf(l0, 1e-30f));
  if (!ok1 && row1 < T) store_rows<D>(ob, acc, row1, 1, fmaxf(l1, 1e-30f));
}

// float32: one warp per query row, the keys 32 at a time (one per lane).
constexpr int F32_ROWS = 4;

template <int D>
__global__ void __launch_bounds__(F32_ROWS * 32)
flash_fwd_1pass_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ kmax,
                    float* __restrict__ o, int T, int S) {
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
  float b = fmaxf(sqrtf(warp_sum(qn)) * kmax[bh], 1.f);
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
  const float denom = l > RESCUE_L ? l : fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < E; ++e) o[((size_t)bh * T + row) * D + lane + 32 * e] = acc[e] / denom;
}

// 8 warps (128 query rows) a block at D = 64; 4 at D = 128, whose larger
// accumulator leaves registers for fewer warps
template <int D>
static int launch(const void* q, const void* k, const void* v, const void* kmax, void* o,
                  int BH, int T, int S, int is_bf16, cudaStream_t st) {
  if (is_bf16) {
    constexpr int NW = D == 64 ? 8 : 4;
    using L = Tiles<D, NW>;
    static const cudaError_t e = cudaFuncSetAttribute(  // once
        flash_fwd_1pass_bf16<D, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((T + L::BQ - 1) / L::BQ, BH);
    flash_fwd_1pass_bf16<D, NW><<<grid, L::THREADS, L::BYTES, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)kmax, (bf16*)o, T, S);
  } else {
    dim3 grid((T + F32_ROWS - 1) / F32_ROWS, BH);
    flash_fwd_1pass_f32<D><<<grid, F32_ROWS * 32, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)kmax, (float*)o, T, S);
  }
  return (int)cudaGetLastError();
}

// q (BH, T, D) pre-scaled, k/v (BH, S, D), kmax (BH,) float32 = max_j |k_j|,
// o like q.  Returns the launch's cudaError_t.
extern "C" int flash_fwd_1pass(const void* q, const void* k, const void* v, const void* kmax,
                               void* o, int BH, int T, int S, int D, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64) return launch<64>(q, k, v, kmax, o, BH, T, S, is_bf16, st);
  if (D == 128) return launch<128>(q, k, v, kmax, o, BH, T, S, is_bf16, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_fwd_1pass_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
