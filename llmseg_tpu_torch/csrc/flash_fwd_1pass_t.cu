// Kernel J: the one-pass attention forward with every tile transposed.
//
// Replaces llmseg_tpu/ops/attention.py::_fwd1t_kernel (launched by
// _flash_fwd_1pass_t when LLMSEG_ATTN_ONEPASS_T=1).  It computes kernel B's
// function (flash_fwd_1pass.cu) in the transposed form: s^T = k q^T (keys x
// queries), p^T = bf16(exp2(s^T - b)) with the Cauchy-Schwarz bound b =
// max(|q| * max_j |k_j|, 1) of each query column, o^T = v^T p^T (D x
// queries) and l = the column sums of the rounded p over real keys; it
// writes o^T (BH, D, T), which the wrapper transposes back.  A column whose
// l is <= 1e-12 is redone with its exact maximum over the real keys (the
// TPU kernel decides per block).  On the TPU the transposed form put the
// query block on the 128 output lanes of both products; on the card the
// query block is the N dimension of both mma.sync products: a warp holds
// its QW queries' q rows as B fragments, the k tile gives the A fragments
// of s^T, and the C fragments of p^T become the B fragments of the second
// product through movmatrix.trans, so p never leaves registers; v^T's A
// fragments come from the v tile by ldmatrix.trans.
//
// What bounds it on an H100: as kernel B, the 4 BH T S D tensor-core
// operations (275 GFLOP at DINOv2-L@896, B*H = 64, T = S = 4097, D = 64,
// about 280 us at the bf16 peak).  k and v stream through a two-stage
// cp.async ring of 64-key tiles, each serving the block's 128 queries.
//
// float32 inputs take a plain SIMT kernel (one warp per query column).
#include "common.cuh"

using namespace llmseg;

namespace {

constexpr float RESCUE_L = 1e-12f;
constexpr int NW = 4;  // warps a block

template <int D>
struct TTiles {
  static constexpr int QW = 2048 / D;  // queries a warp: 32 at D = 64, 16 at D = 128
  static constexpr int BQ = NW * QW;
  static constexpr int LD = D + 8;
  static constexpr int THREADS = NW * 32;
  static constexpr size_t BYTES = sizeof(bf16) * (size_t)(BQ + 4 * BK) * LD;
};

// the transpose of an 8 x 8 bf16 matrix held one row pair a lane (lane 4g + t
// holds row g, columns 2t and 2t + 1), in the same layout
__device__ __forceinline__ uint32_t transpose8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// One sweep of a warp's QW query columns over all key tiles.  MAX_ONLY:
// fold the column maxima of the logits over real keys into mq.  Otherwise:
// o^T += v^T p^T and l += the column sums of p^T = bf16(exp2(s^T - b)).
// Per-lane partial results (this lane's keys g and g + 8 of each 16); the
// caller reduces over the eight lanes of a column.
template <int D, bool MAX_ONLY>
__device__ __forceinline__ void sweep(const uint32_t (&qb)[D / 16][TTiles<D>::QW / 16][4],
                                      bf16* sK, bf16* sV, const bf16* __restrict__ kb,
                                      const bf16* __restrict__ vb, int S,
                                      const float (&b)[TTiles<D>::QW / 8][2],
                                      float (&o)[D / 16][TTiles<D>::QW / 8][4],
                                      float (&l)[TTiles<D>::QW / 8][2],
                                      float (&mq)[TTiles<D>::QW / 8][2]) {
  using L = TTiles<D>;
  constexpr int NJ = L::QW / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, r8 = lane & 7, mi = lane >> 3;
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
    const bf16* k_s = sK + st * BK * L::LD;
    const bf16* v_s = sV + st * BK * L::LD;
#pragma unroll
    for (int mt = 0; mt < BK / 16; ++mt) {
      // s^T for keys mt*16 .. +15 (rows g, g + 8) x this warp's queries
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, k_s + (mt * 16 + r8 + (mi & 1) * 8) * L::LD + kk * 16 + (mi >> 1) * 8);
#pragma unroll
        for (int np = 0; np < L::QW / 16; ++np) {
          mma16816(s[2 * np], a, qb[kk][np][0], qb[kk][np][1]);
          mma16816(s[2 * np + 1], a, qb[kk][np][2], qb[kk][np][3]);
        }
      }
      const int key0 = it * BK + mt * 16 + g;
      const bool real0 = key0 < S, real1 = key0 + 8 < S;
      if (MAX_ONLY) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (real0) mq[j][0] = fmaxf(mq[j][0], s[j][0]), mq[j][1] = fmaxf(mq[j][1], s[j][1]);
          if (real1) mq[j][0] = fmaxf(mq[j][0], s[j][2]), mq[j][1] = fmaxf(mq[j][1], s[j][3]);
        }
        continue;
      }
      uint32_t pb[NJ][2];  // p^T as the B fragments of keys mt*16.. x queries 8j..
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const __nv_bfloat162 h0 = __floats2bfloat162_rn(real0 ? exp2f(s[j][0] - b[j][0]) : 0.f,
                                                        real0 ? exp2f(s[j][1] - b[j][1]) : 0.f);
        const __nv_bfloat162 h1 = __floats2bfloat162_rn(real1 ? exp2f(s[j][2] - b[j][0]) : 0.f,
                                                        real1 ? exp2f(s[j][3] - b[j][1]) : 0.f);
        l[j][0] += __low2float(h0) + __low2float(h1);
        l[j][1] += __high2float(h0) + __high2float(h1);
        uint32_t u0, u1;
        memcpy(&u0, &h0, sizeof(u0));
        memcpy(&u1, &h1, sizeof(u1));
        pb[j][0] = transpose8(u0);
        pb[j][1] = transpose8(u1);
      }
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) {
        uint32_t a[4];  // v^T rows dt*16 .. +15 x keys mt*16 .. +15, transposed on load
        ldsm_x4_t(a, v_s + (mt * 16 + r8 + (mi >> 1) * 8) * L::LD + dt * 16 + (mi & 1) * 8);
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma16816(o[dt][j], a, pb[j][0], pb[j][1]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }
  cp_async_wait<0>();
}

// over the eight lanes (g = 0..7) that hold one query column
__device__ __forceinline__ float col_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  return x + __shfl_xor_sync(0xffffffffu, x, 16);
}
__device__ __forceinline__ float col_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
}

template <int D>
__global__ void __launch_bounds__(NW * 32)
flash_fwd_1pass_t_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ kmax,
                       bf16* __restrict__ ot, int T, int S) {
  using L = TTiles<D>;
  constexpr int QW = L::QW, NJ = QW / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + L::BQ * L::LD;
  bf16* sV = sK + 2 * BK * L::LD;
  const int bh = blockIdx.y, q0 = blockIdx.x * L::BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r8 = lane & 7, mi = lane >> 3;
  const bf16* kb = k + (size_t)bh * S * D;
  const bf16* vb = v + (size_t)bh * S * D;

  load_tile_async<D, L::THREADS>(sQ, q + (size_t)bh * T * D, q0, L::BQ, T, L::LD);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qb[D / 16][QW / 16][4];  // this warp's q rows as B fragments (queries as N)
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int np = 0; np < QW / 16; ++np)
      ldsm_x4(qb[kk][np],
              sQ + (warp * QW + np * 16 + r8 + (mi >> 1) * 8) * L::LD + kk * 16 + (mi & 1) * 8);

  // the bound of each query column this lane holds: 8j + 2t + e of the warp's
  const float km = kmax[bh];
  float b[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bf16* row = sQ + (warp * QW + 8 * j + 2 * t + e) * L::LD;
      float qn = 0.f;
      for (int d = 0; d < D; ++d) qn = fmaf(__bfloat162float(row[d]), __bfloat162float(row[d]), qn);
      b[j][e] = fmaxf(sqrtf(qn) * km, 1.f);
    }

  float o[D / 16][NJ][4], l[NJ][2], mq[NJ][2];
  auto reset = [&]() {
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt)
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[dt][j][0] = o[dt][j][1] = o[dt][j][2] = o[dt][j][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) l[j][0] = l[j][1] = 0.f, mq[j][0] = mq[j][1] = NEG_INF;
  };
  // o^T / l for the columns whose ok flag equals want
  auto store = [&](const bool (&ok)[NJ][2], bool want) {
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = q0 + warp * QW + 8 * j + 2 * t + (e & 1);
          if (col >= T || ok[j][e & 1] != want) continue;
          const int d = dt * 16 + g + (e >> 1) * 8;
          const float den = want ? l[j][e & 1] : fmaxf(l[j][e & 1], 1e-30f);
          ot[((size_t)bh * D + d) * T + col] = __float2bfloat16(o[dt][j][e] / den);
        }
  };

  reset();
  sweep<D, false>(qb, sK, sV, kb, vb, S, b, o, l, mq);
  bool ok[NJ][2], rescue = false;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l[j][e] = col_sum(l[j][e]);
      ok[j][e] = l[j][e] > RESCUE_L;
      rescue |= !ok[j][e] && q0 + warp * QW + 8 * j + 2 * t + e < T;
    }
  store(ok, true);
  if (!__syncthreads_or(rescue)) return;

  // rescue: the exact column maxima, then the sums again with them
  reset();
  sweep<D, true>(qb, sK, sV, kb, vb, S, b, o, l, mq);
  float m[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) m[j][e] = col_max(mq[j][e]);
  reset();
  sweep<D, false>(qb, sK, sV, kb, vb, S, m, o, l, mq);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) l[j][e] = col_sum(l[j][e]);
  store(ok, false);
}

// float32: one warp per query column, the keys 32 at a time (one per lane)
constexpr int F32_ROWS = 4;

template <int D>
__global__ void __launch_bounds__(F32_ROWS * 32)
flash_fwd_1pass_t_f32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ kmax,
                      float* __restrict__ ot, int T, int S) {
  constexpr int E = D / 32;
  __shared__ float sq[F32_ROWS][D];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, col = blockIdx.x * F32_ROWS + warp;
  if (col >= T) return;
  float qn = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float x = q[((size_t)bh * T + col) * D + c];
    sq[warp][c] = x;
    qn = fmaf(x, x, qn);
  }
  __syncwarp();
  const float* kb = k + (size_t)bh * S * D;
  const float* vb = v + (size_t)bh * S * D;
  float b = fmaxf(sqrtf(warp_sum(qn)) * kmax[bh], 1.f);
  float acc[E], l = 0.f;
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
  for (int e = 0; e < E; ++e) ot[((size_t)bh * D + lane + 32 * e) * T + col] = acc[e] / den;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* kmax, void* ot, int BH,
           int T, int S, int is_bf16, cudaStream_t st) {
  if (is_bf16) {
    using L = TTiles<D>;
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_1pass_t_bf16<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::BYTES);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((T + L::BQ - 1) / L::BQ, BH);
    flash_fwd_1pass_t_bf16<D><<<grid, L::THREADS, L::BYTES, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)kmax, (bf16*)ot, T, S);
  } else {
    dim3 grid((T + F32_ROWS - 1) / F32_ROWS, BH);
    flash_fwd_1pass_t_f32<D><<<grid, F32_ROWS * 32, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)kmax, (float*)ot, T, S);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q (BH, T, D) pre-scaled, k/v (BH, S, D), kmax (BH,) float32 = max_j |k_j|;
// ot (BH, D, T) in q's type.  Returns the launch's cudaError_t.
extern "C" int flash_fwd_1pass_t(const void* q, const void* k, const void* v, const void* kmax,
                                 void* ot, int BH, int T, int S, int D, int is_bf16,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64) return launch<64>(q, k, v, kmax, ot, BH, T, S, is_bf16, st);
  if (D == 128) return launch<128>(q, k, v, kmax, ot, BH, T, S, is_bf16, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_fwd_1pass_t_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
