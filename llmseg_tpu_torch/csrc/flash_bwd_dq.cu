// Kernel C: flash attention backward, the query gradient.
//
// Replaces llmseg_tpu/ops/attention.py::_bwd_dq_kernel (launched by
// _flash_bwd).  For each query row: delta = rowsum(do * o) in float32; over
// the key tiles up to the causal diagonal, s = q k^T with the finite -1e9
// causal / ragged-key mask, p = exp2(s - lse), dp = do v^T,
// ds = p * (dp - delta), dq += ds(bf16) k.  Writes dq / log2(e) (q arrives
// pre-scaled by scale*log2(e) and lse is in log2) and, for kernel D, the
// float32 delta of every row.
//
// What bounds it on an H100: at the LLaMA-7B training shape (B*H = 32,
// T = S = 767, D = 128, causal) it does 3 products over 294,528 causal pairs,
// 7.2 GFLOP (7 us of tensor-core time), against 38 MB of q, k, v, o, do and
// dq with the float32 lse and delta (11 us of memory time): byte-bound.  The design reads each q, do and o
// row once: a block owns 64 query rows (4 warps x 16), keeps q and do in
// shared memory, and streams 64-key tiles of k and v through a two-stage
// cp.async ring, each k/v tile read once per query tile.  s, p, dp and ds
// stay in registers (mma.sync, see common.cuh); ds, packed to bf16 in the C
// layout, is already the A operand of ds k.  Every dq tile belongs to one
// block: no atomics, and the result is deterministic.  Tiles wholly above
// the diagonal are never loaded; the mask runs only on tiles that reach the
// diagonal or the ragged key end.  wgmma and TMA are the next step.
//
// float32 inputs take a plain SIMT kernel (one warp per query row) with the
// same math; it exists for exact comparisons, not for speed.
#include "common.cuh"

using namespace llmseg;

template <int D>
struct DqTiles {
  static constexpr int NW = 4, BQ = NW * 16, LD = D + 8, THREADS = NW * 32;
  // q and do tiles, two stages of k and v tiles
  static constexpr size_t BYTES = sizeof(bf16) * (size_t)(2 * BQ + 4 * BK) * LD;
};

template <int D>
__global__ void __launch_bounds__(DqTiles<D>::THREADS)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ o,
                  const bf16* __restrict__ dO, const float* __restrict__ lse,
                  bf16* __restrict__ dq, float* __restrict__ delta, int T, int S, int causal) {
  using L = DqTiles<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDo = sQ + L::BQ * L::LD;
  bf16* sK = sDo + L::BQ * L::LD;
  bf16* sV = sK + 2 * BK * L::LD;
  const int bh = blockIdx.y, q0 = blockIdx.x * L::BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wrow = q0 + warp * 16;
  const int row0 = wrow + g, row1 = row0 + 8;
  const bf16* kb = k + (size_t)bh * S * D;
  const bf16* vb = v + (size_t)bh * S * D;

  load_tile_async<D, L::THREADS>(sQ, q + (size_t)bh * T * D, q0, L::BQ, T, L::LD);
  load_tile_async<D, L::THREADS>(sDo, dO + (size_t)bh * T * D, q0, L::BQ, T, L::LD);
  load_tile_async<D, L::THREADS>(sK, kb, 0, BK, S, L::LD);
  load_tile_async<D, L::THREADS>(sV, vb, 0, BK, S, L::LD);
  cp_async_commit();

  // delta of this warp's 16 rows, while the first tiles arrive; rows past T
  // get 0, as do their lse, so they add nothing
  float dl0 = 0.f, dl1 = 0.f;
  for (int r = 0; r < 16; ++r) {
    const int row = wrow + r;
    if (row >= T) break;
    const size_t base = ((size_t)bh * T + row) * D;
    float x = 0.f;
    for (int c = lane; c < D; c += 32)
      x = fmaf(__bfloat162float(dO[base + c]), __bfloat162float(o[base + c]), x);
    x = warp_sum(x);
    if (r == g) dl0 = x;
    if (r == g + 8) dl1 = x;
    if (lane == 0) delta[(size_t)bh * T + row] = x;
  }
  const float ls0 = row0 < T ? lse[(size_t)bh * T + row0] : 0.f;
  const float ls1 = row1 < T ? lse[(size_t)bh * T + row1] : 0.f;

  int n_tiles = (S + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + L::BQ + BK - 1) / BK);
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) {
      load_tile_async<D, L::THREADS>(sK + (st ^ 1) * BK * L::LD, kb, (it + 1) * BK, BK, S, L::LD);
      load_tile_async<D, L::THREADS>(sV + (st ^ 1) * BK * L::LD, vb, (it + 1) * BK, BK, S, L::LD);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* sKs = sK + st * BK * L::LD;
    const bf16* sVs = sV + st * BK * L::LD;

    float s[BK / 8][4];
    ab_tile<D, BK>(s, sQ, warp * 16, sKs, L::LD);
    const int k0 = it * BK;
    if (k0 + BK > S || (causal && k0 + BK - 1 > wrow)) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1), row = e < 2 ? row0 : row1;
          if (!(key < S && (!causal || key <= row))) s[j][e] = NEG_INF;
        }
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - ls0);
      s[j][1] = exp2f(s[j][1] - ls0);
      s[j][2] = exp2f(s[j][2] - ls1);
      s[j][3] = exp2f(s[j][3] - ls1);
    }
    float dp[BK / 8][4];
    ab_tile<D, BK>(dp, sDo, warp * 16, sVs, L::LD);
    uint32_t dsk[BK / 8][2];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      dsk[j][0] = pack_bf16(s[j][0] * (dp[j][0] - dl0), s[j][1] * (dp[j][1] - dl0));
      dsk[j][1] = pack_bf16(s[j][2] * (dp[j][2] - dl1), s[j][3] * (dp[j][3] - dl1));
    }
    pv_tile<D>(acc, dsk, sKs, L::LD);  // dq += ds k
    __syncthreads();  // this stage is refilled two tiles on
  }
  cp_async_wait<0>();

  // store_rows divides: acc / log2(e) is dq * INV_LOG2E up to one float32 ulp
  bf16* dqb = dq + (size_t)bh * T * D;
  if (row0 < T) store_rows<D>(dqb, acc, row0, 0, 1.f / INV_LOG2E);
  if (row1 < T) store_rows<D>(dqb, acc, row1, 1, 1.f / INV_LOG2E);
}

// float32: one warp per query row, the keys 32 at a time (one per lane).
constexpr int F32_ROWS = 4;

template <int D>
__global__ void __launch_bounds__(F32_ROWS * 32)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ o,
                 const float* __restrict__ dO, const float* __restrict__ lse,
                 float* __restrict__ dq, float* __restrict__ delta, int T, int S, int causal) {
  constexpr int E = D / 32;
  __shared__ float sq[F32_ROWS][D], sdo[F32_ROWS][D];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, row = blockIdx.x * F32_ROWS + warp;
  if (row >= T) return;
  const size_t rb = ((size_t)bh * T + row) * D;
  float x = 0.f;
  for (int c = lane; c < D; c += 32) {
    sq[warp][c] = q[rb + c];
    sdo[warp][c] = dO[rb + c];
    x = fmaf(dO[rb + c], o[rb + c], x);
  }
  const float dl = warp_sum(x);
  __syncwarp();
  const float ls = lse[(size_t)bh * T + row];
  const float* kb = k + (size_t)bh * S * D;
  const float* vb = v + (size_t)bh * S * D;
  const int hi = causal ? min(S, row + 1) : S;  // masked keys have p = exp2(-1e9 - lse) = 0
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  for (int j0 = 0; j0 < hi; j0 += 32) {
    const int j = j0 + lane;
    float ds = 0.f;
    if (j < hi) {
      const float* kr = kb + (size_t)j * D;
      const float* vr = vb + (size_t)j * D;
      float sv = 0.f, dp = 0.f;
      for (int c = 0; c < D; ++c) {
        sv = fmaf(sq[warp][c], kr[c], sv);
        dp = fmaf(sdo[warp][c], vr[c], dp);
      }
      ds = exp2f(sv - ls) * (dp - dl);
    }
    const int n = min(32, hi - j0);
    for (int jj = 0; jj < n; ++jj) {
      const float dsj = __shfl_sync(0xffffffffu, ds, jj);
      const float* kr = kb + (size_t)(j0 + jj) * D;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(dsj, kr[lane + 32 * e], acc[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) dq[rb + lane + 32 * e] = acc[e] * INV_LOG2E;
  if (lane == 0) delta[(size_t)bh * T + row] = dl;
}

template <int D>
static int launch(const void* q, const void* k, const void* v, const void* o, const void* dO,
                  const void* lse, void* dq, void* delta, int BH, int T, int S, int is_bf16,
                  int causal, cudaStream_t st) {
  if (is_bf16) {
    using L = DqTiles<D>;
    static const cudaError_t e = cudaFuncSetAttribute(  // once
        flash_bwd_dq_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((T + L::BQ - 1) / L::BQ, BH);
    flash_bwd_dq_bf16<D><<<grid, L::THREADS, L::BYTES, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o, (const bf16*)dO,
        (const float*)lse, (bf16*)dq, (float*)delta, T, S, causal);
  } else {
    dim3 grid((T + F32_ROWS - 1) / F32_ROWS, BH);
    flash_bwd_dq_f32<D><<<grid, F32_ROWS * 32, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)o, (const float*)dO,
        (const float*)lse, (float*)dq, (float*)delta, T, S, causal);
  }
  return (int)cudaGetLastError();
}

// q, o, do, dq (BH, T, D) with q pre-scaled; k, v (BH, S, D); lse (BH, T)
// float32 log2 from kernel A; delta (BH, T) float32 out.  Returns the
// launch's cudaError_t.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                            const void* dO, const void* lse, void* dq, void* delta, int BH,
                            int T, int S, int D, int is_bf16, int causal, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64) return launch<64>(q, k, v, o, dO, lse, dq, delta, BH, T, S, is_bf16, causal, st);
  if (D == 128) return launch<128>(q, k, v, o, dO, lse, dq, delta, BH, T, S, is_bf16, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_bwd_dq_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
