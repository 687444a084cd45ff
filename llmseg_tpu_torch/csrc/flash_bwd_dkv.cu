// Kernel D: flash attention backward, the key and value gradients.
//
// Replaces llmseg_tpu/ops/attention.py::_bwd_dkv_kernel (launched by
// _flash_bwd).  For each key tile, over the query tiles that see it:
// recompute s = q k^T (finite -1e9 causal / ragged-key mask) and
// p = exp2(s - lse), dv += p(bf16)^T do, dp = do v^T,
// ds = (p * (dp - delta))(bf16), dk += ds^T q.  Writes dk / log2(e) and dv.
//
// delta: read as the float32 (B*H, T) rowsum(do * o) that kernel C writes,
// so kernel C runs first.  The TPU kernel recomputes delta per query tile
// from o and do (:555-556); on the card that would read all of o once per
// 64-key tile (12 times at T = 767), where the float32 delta is 1/64 of
// o's bytes at D = 128.
//
// What bounds it on an H100: at the LLaMA-7B training shape (B*H = 32,
// T = S = 767, D = 128, causal) it does 4 products over 294,528 causal pairs,
// 9.7 GFLOP (10 us of tensor-core time), against 38 MB of q, k, v, do, dk
// and dv with the float32 lse and delta (11 us of memory time; o is never
// read): byte-bound.  The design works in the
// transposed orientation, so no operand needs transposing in registers: a
// block owns 64 keys (4 warps x 16), keeps its k and v tiles in shared
// memory, and streams 32-row tiles of q and do (with their lse and delta)
// through a two-stage cp.async ring.  Each warp computes s^T = k q^T and
// dp^T = v do^T directly in the mma.sync C layout, whose bf16 packing is
// the A operand of p^T do and ds^T q; q and do arrive row-major and are
// read as B operands by ldmatrix.trans.  The register budget is what shapes
// it: the float32 dk and dv accumulators of 16 keys x 128 take 128
// registers a thread, so the query tile is 32 rows (s^T and dp^T 16 each)
// and the k/v A fragments are reloaded from shared memory per product
// instead of held.  Every dk/dv tile belongs to one block: no atomics, a
// deterministic result.  Causal query tiles start at the first tile that
// reaches the key tile; the mask runs only where a tile crosses the
// diagonal or the key tile is ragged.  wgmma and TMA are the next step.
//
// float32 inputs take a plain SIMT kernel (one warp per key row) with the
// same math; it exists for exact comparisons, not for speed.
#include "common.cuh"

using namespace llmseg;

template <int D>
struct DkvTiles {
  static constexpr int NW = 4, BKV = NW * 16, BQ = 32, LD = D + 8, THREADS = NW * 32;
  // k and v tiles, two stages of q and do tiles, two stages of lse and delta
  static constexpr size_t BF16_ELEMS = (size_t)(2 * BKV + 4 * BQ) * LD;
  static constexpr size_t BYTES = sizeof(bf16) * BF16_ELEMS + sizeof(float) * 4 * BQ;
};

template <int D>
__device__ __forceinline__ void load_stats(float* sL, float* sDl, const float* lse,
                                           const float* delta, int r0, int T) {
  constexpr int BQ = DkvTiles<D>::BQ;
  for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
    const bool ok = r0 + i < T;  // rows past T: lse = delta = 0, and their q, do are zero
    sL[i] = ok ? lse[r0 + i] : 0.f;
    sDl[i] = ok ? delta[r0 + i] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(DkvTiles<D>::THREADS)
flash_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dO,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int S, int causal) {
  using L = DkvTiles<D>;
  constexpr int BQ = L::BQ;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + L::BKV * L::LD;
  bf16* sQ = sV + L::BKV * L::LD;      // two stages
  bf16* sDo = sQ + 2 * BQ * L::LD;     // two stages
  float* sL = reinterpret_cast<float*>(smem + sizeof(bf16) * L::BF16_ELEMS);  // two stages
  float* sDl = sL + 2 * BQ;                                                  // two stages
  const int bh = blockIdx.y, k0 = blockIdx.x * L::BKV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kw = k0 + warp * 16;  // this warp's first key
  const int key0 = kw + g, key1 = key0 + 8;
  const bf16* qb = q + (size_t)bh * T * D;
  const bf16* dob = dO + (size_t)bh * T * D;
  const float* lseb = lse + (size_t)bh * T;
  const float* deltab = delta + (size_t)bh * T;

  const int lo = causal ? k0 / BQ : 0;  // first query tile with a row >= k0
  const int hi = (T + BQ - 1) / BQ;
  load_tile_async<D, L::THREADS>(sK, k + (size_t)bh * S * D, k0, L::BKV, S, L::LD);
  load_tile_async<D, L::THREADS>(sV, v + (size_t)bh * S * D, k0, L::BKV, S, L::LD);
  if (lo < hi) {
    load_tile_async<D, L::THREADS>(sQ, qb, lo * BQ, BQ, T, L::LD);
    load_tile_async<D, L::THREADS>(sDo, dob, lo * BQ, BQ, T, L::LD);
    load_stats<D>(sL, sDl, lseb, deltab, lo * BQ, T);
  }
  cp_async_commit();

  float dkacc[D / 8][4], dvacc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkacc[j][e] = dvacc[j][e] = 0.f;

  for (int it = lo; it < hi; ++it) {
    const int st = (it - lo) & 1;
    if (it + 1 < hi) {
      const int nx = st ^ 1;
      load_tile_async<D, L::THREADS>(sQ + nx * BQ * L::LD, qb, (it + 1) * BQ, BQ, T, L::LD);
      load_tile_async<D, L::THREADS>(sDo + nx * BQ * L::LD, dob, (it + 1) * BQ, BQ, T, L::LD);
      load_stats<D>(sL + nx * BQ, sDl + nx * BQ, lseb, deltab, (it + 1) * BQ, T);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* sQs = sQ + st * BQ * L::LD;
    const bf16* sDos = sDo + st * BQ * L::LD;
    const float* sLs = sL + st * BQ;
    const float* sDls = sDl + st * BQ;
    const int r0 = it * BQ;

    // s^T: rows are this warp's keys (g, g + 8), columns the tile's queries
    float s[BQ / 8][4];
    ab_tile<D, BQ>(s, sK, warp * 16, sQs, L::LD);
    if (kw + 16 > S || (causal && r0 < kw + 15)) {
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + 8 * j + 2 * t + (e & 1), key = e < 2 ? key0 : key1;
          if (!(key < S && (!causal || key <= row))) s[j][e] = NEG_INF;
        }
    }
    uint32_t pk[BQ / 8][2];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float l0 = sLs[8 * j + 2 * t], l1 = sLs[8 * j + 2 * t + 1];
      s[j][0] = exp2f(s[j][0] - l0);
      s[j][1] = exp2f(s[j][1] - l1);
      s[j][2] = exp2f(s[j][2] - l0);
      s[j][3] = exp2f(s[j][3] - l1);
      pk[j][0] = pack_bf16(s[j][0], s[j][1]);
      pk[j][1] = pack_bf16(s[j][2], s[j][3]);
    }
    pv_tile<D, BQ>(dvacc, pk, sDos, L::LD);  // dv += p^T do

    float dp[BQ / 8][4];
    ab_tile<D, BQ>(dp, sV, warp * 16, sDos, L::LD);  // dp^T = v do^T
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float d0 = sDls[8 * j + 2 * t], d1 = sDls[8 * j + 2 * t + 1];
      pk[j][0] = pack_bf16(s[j][0] * (dp[j][0] - d0), s[j][1] * (dp[j][1] - d1));
      pk[j][1] = pack_bf16(s[j][2] * (dp[j][2] - d0), s[j][3] * (dp[j][3] - d1));
    }
    pv_tile<D, BQ>(dkacc, pk, sQs, L::LD);  // dk += ds^T q
    __syncthreads();  // this stage is refilled two tiles on
  }
  cp_async_wait<0>();

  // store_rows divides: dk / log2(e) is dk * INV_LOG2E up to one float32 ulp
  bf16* dkb = dk + (size_t)bh * S * D;
  bf16* dvb = dv + (size_t)bh * S * D;
  if (key0 < S) {
    store_rows<D>(dkb, dkacc, key0, 0, 1.f / INV_LOG2E);
    store_rows<D>(dvb, dvacc, key0, 0, 1.f);
  }
  if (key1 < S) {
    store_rows<D>(dkb, dkacc, key1, 1, 1.f / INV_LOG2E);
    store_rows<D>(dvb, dvacc, key1, 1, 1.f);
  }
}

// float32: one warp per key row, the query rows 32 at a time (one per lane).
constexpr int F32_ROWS = 4;

template <int D>
__global__ void __launch_bounds__(F32_ROWS * 32)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dO,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int T, int S, int causal) {
  constexpr int E = D / 32;
  __shared__ float sk[F32_ROWS][D], sv[F32_ROWS][D];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, key = blockIdx.x * F32_ROWS + warp;
  if (key >= S) return;
  const size_t kr = ((size_t)bh * S + key) * D;
  for (int c = lane; c < D; c += 32) {
    sk[warp][c] = k[kr + c];
    sv[warp][c] = v[kr + c];
  }
  __syncwarp();
  const float* qb = q + (size_t)bh * T * D;
  const float* dob = dO + (size_t)bh * T * D;
  const int lo = causal ? key : 0;  // rows before the key have p = 0
  float dka[E], dva[E];
#pragma unroll
  for (int e = 0; e < E; ++e) dka[e] = dva[e] = 0.f;
  for (int i0 = lo; i0 < T; i0 += 32) {
    const int i = i0 + lane;
    float p = 0.f, ds = 0.f;
    if (i < T) {
      const float* qr = qb + (size_t)i * D;
      const float* dr = dob + (size_t)i * D;
      float sv_ = 0.f, dp = 0.f;
      for (int c = 0; c < D; ++c) {
        sv_ = fmaf(qr[c], sk[warp][c], sv_);
        dp = fmaf(dr[c], sv[warp][c], dp);
      }
      p = exp2f(sv_ - lse[(size_t)bh * T + i]);
      ds = p * (dp - delta[(size_t)bh * T + i]);
    }
    const int n = min(32, T - i0);
    for (int ii = 0; ii < n; ++ii) {
      const float pi = __shfl_sync(0xffffffffu, p, ii);
      const float dsi = __shfl_sync(0xffffffffu, ds, ii);
      const float* qr = qb + (size_t)(i0 + ii) * D;
      const float* dr = dob + (size_t)(i0 + ii) * D;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        dva[e] = fmaf(pi, dr[lane + 32 * e], dva[e]);
        dka[e] = fmaf(dsi, qr[lane + 32 * e], dka[e]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    dk[kr + lane + 32 * e] = dka[e] * INV_LOG2E;
    dv[kr + lane + 32 * e] = dva[e];
  }
}

template <int D>
static int launch(const void* q, const void* k, const void* v, const void* dO, const void* lse,
                  const void* delta, void* dk, void* dv, int BH, int T, int S, int is_bf16,
                  int causal, cudaStream_t st) {
  if (is_bf16) {
    using L = DkvTiles<D>;
    static const cudaError_t e = cudaFuncSetAttribute(  // once
        flash_bwd_dkv_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((S + L::BKV - 1) / L::BKV, BH);
    flash_bwd_dkv_bf16<D><<<grid, L::THREADS, L::BYTES, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dO, (const float*)lse,
        (const float*)delta, (bf16*)dk, (bf16*)dv, T, S, causal);
  } else {
    dim3 grid((S + F32_ROWS - 1) / F32_ROWS, BH);
    flash_bwd_dkv_f32<D><<<grid, F32_ROWS * 32, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dO, (const float*)lse,
        (const float*)delta, (float*)dk, (float*)dv, T, S, causal);
  }
  return (int)cudaGetLastError();
}

// q, do (BH, T, D) with q pre-scaled; k, v, dk, dv (BH, S, D); lse and
// delta (BH, T) float32 (lse in log2 from kernel A, delta from kernel C).
// Returns the launch's cudaError_t.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dO,
                             const void* lse, const void* delta, void* dk, void* dv, int BH,
                             int T, int S, int D, int is_bf16, int causal, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64) return launch<64>(q, k, v, dO, lse, delta, dk, dv, BH, T, S, is_bf16, causal, st);
  if (D == 128) return launch<128>(q, k, v, dO, lse, delta, dk, dv, BH, T, S, is_bf16, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_bwd_dkv_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
