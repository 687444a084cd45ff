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
// dq with the float32 lse and delta (11 us of memory time): byte-bound, with
// the tensor cores close behind, so the products have to run back to back
// while each k/v tile is read once per query block.
//
// What the design does: a CTA owns 128 query rows of one head and runs two
// consumer warpgroups (64 rows each) and a producer warp.  The producer's
// first thread loads the q and do blocks once by TMA and streams 64-key
// tiles of k and v through a four-stage mbarrier ring.  Each consumer runs,
// per tile, S = q k^T and dP = do v^T as two wgmma groups from shared
// memory, the mask and exp2 of S while dP still runs, ds = p * (dp - delta)
// packed to bf16 in registers (the A fragment of the next product), and
// dq += ds k with k read as an MN-major B from the same stage.  The dq
// product of tile j runs under the wait for tile j + 1 and its S and dP;
// the two warpgroups interleave.  (128 rows run faster than 64 with one
// consumer warpgroup a CTA, scripts/bwd_variants.py; a producer warpgroup
// that hands its registers to the consumers by setmaxnreg gained
// nothing.)  ptxas still serialises some of the products at 168 registers
// a thread (C7512).  delta comes from 16-byte loads of o and do, four lanes
// a row, before the first tile is waited on.  Every dq row belongs to one
// CTA: no atomics, a deterministic result.  Tiles wholly above the
// diagonal are never loaded, a warpgroup skips the tiles past its own
// rows, the mask runs only on tiles that cross the diagonal or the ragged
// key end, and the causal query blocks start longest first.
//
// float32 inputs take a plain SIMT kernel (one warp per query row) with the
// same math; it exists for exact comparisons, not for speed.
#include <type_traits>

#include "hopper.cuh"

using namespace llmseg;

namespace {

// Shared memory from a 1024-aligned base: the q block, the do block (NB
// boxes of BQ lines each), then STAGES k tiles and STAGES v tiles (NB
// boxes of BN lines each).
template <int D>
struct DqLayout {
  static constexpr int BQ = 128, BN = 64, NB = D / 64, STAGES = 4;
  static constexpr int THREADS = 2 * 128 + 32;  // two consumer warpgroups, a producer warp
  static constexpr uint32_t QBOX = BQ * 128, KBOX = BN * 128;
  static constexpr uint32_t QBYTES = NB * QBOX, TILE = NB * KBOX;
  static constexpr uint32_t OFF_DO = QBYTES, OFF_K = 2 * QBYTES;
  static constexpr uint32_t OFF_V = OFF_K + STAGES * TILE;
  static constexpr uint32_t BYTES = OFF_V + STAGES * TILE;
};

struct DqBars {
  uint64_t q, full[4], empty[4];
};

// rowsum(do * o) of one row, by the four lanes t = 0..3 that share it
// (16-byte chunks t, t + 4, ...); every lane takes part in the sum
template <int D>
__device__ __forceinline__ float row_delta(const bf16* __restrict__ o, const bf16* __restrict__ dO,
                                           size_t off, bool ok, int t) {
  float x = 0.f;
  if (ok) {
    const uint4* po = reinterpret_cast<const uint4*>(o + off);
    const uint4* pd = reinterpret_cast<const uint4*>(dO + off);
#pragma unroll
    for (int c = t; c < D / 8; c += 4) {
      const uint4 a = po[c], b = pd[c];
      const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* hb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 fa = __bfloat1622float2(ha[i]), fb = __bfloat1622float2(hb[i]);
        x = fmaf(fa.x, fb.x, fmaf(fa.y, fb.y, x));
      }
    }
  }
  return quad_sum(x);
}

template <int D>
__global__ void __launch_bounds__(DqLayout<D>::THREADS, 1)
flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                  const bf16* __restrict__ o, const bf16* __restrict__ dO,
                  const float* __restrict__ lse, bf16* __restrict__ dq,
                  float* __restrict__ delta, int T, int S, int causal) {
  using namespace hopper;
  using L = DqLayout<D>;
  constexpr int NS = L::STAGES;
  __shared__ DqBars bars;
  extern __shared__ unsigned char smem[];
  const uint32_t base = align1024(smem);
  const int bh = blockIdx.x;
  // causal blocks in reverse order: the longest rows start first
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qb * L::BQ;
  int n_tiles = (S + L::BN - 1) / L::BN;
  if (causal) n_tiles = min(n_tiles, (q0 + L::BQ - 1) / L::BN + 1);
  const int wg = warpgroup_index();
  if (threadIdx.x == 0) {
    mbar_init(&bars.q, 1);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      mbar_init(&bars.full[i], 1);
      mbar_init(&bars.empty[i], 8);  // one arrival from each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    if (threadIdx.x == 256) {
      mbar_expect_tx(&bars.q, 2 * L::QBYTES);
#pragma unroll
      for (int nb = 0; nb < L::NB; ++nb) {
        tma_load_3d(base + nb * L::QBOX, &tq, nb * 64, q0, bh, &bars.q);
        tma_load_3d(base + L::OFF_DO + nb * L::QBOX, &tdo, nb * 64, q0, bh, &bars.q);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % NS;
        mbar_wait(&bars.empty[st], ((j / NS) & 1) ^ 1);  // a fresh barrier passes
        mbar_expect_tx(&bars.full[st], 2 * L::TILE);
#pragma unroll
        for (int nb = 0; nb < L::NB; ++nb) {
          tma_load_3d(base + L::OFF_K + st * L::TILE + nb * L::KBOX, &tk, nb * 64, j * L::BN, bh,
                      &bars.full[st]);
          tma_load_3d(base + L::OFF_V + st * L::TILE + nb * L::KBOX, &tv, nb * 64, j * L::BN, bh,
                      &bars.full[st]);
        }
      }
    }
    return;
  }

  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool lead = lane == 0;
  const int row0 = q0 + 64 * wg;
  const int ra = row0 + 16 * warp + g, rb = ra + 8;
  // the tiles that reach this warpgroup's rows; the rest it only releases
  int n_own = row0 < T ? n_tiles : 0;
  if (causal) n_own = min(n_own, (row0 + 63) / L::BN + 1);

  // delta and lse of rows ra and rb while the first tiles arrive; rows past
  // T get 0 for both, so they stay finite (their dq is not written)
  float dl[2], ls[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? rb : ra;
    const bool ok = row < T;
    dl[h] = row_delta<D>(o, dO, ((size_t)bh * T + row) * D, ok, t);
    ls[h] = ok ? lse[(size_t)bh * T + row] : 0.f;
    if (ok && t == 0) delta[(size_t)bh * T + row] = dl[h];
  }

  float acc[D / 2], s[32], dp[32];
  uint32_t ds[16];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) ds[i] = 0u;
  const uint32_t qbase = base + wg * 64 * 128, dobase = base + L::OFF_DO + wg * 64 * 128;

  // S = q k^T and dP = do v^T of the tile in stage st: two wgmma groups
  auto issue_sdp = [&](int st) {
    const uint32_t ks = opaque(base + L::OFF_K + st * L::TILE);
    const uint32_t vs = opaque(base + L::OFF_V + st * L::TILE);
    const uint32_t qs = opaque(qbase), dos = opaque(dobase);
    reg_fence(s);
    reg_fence(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64>(s, desc_kmajor(qs + (kk / 4) * L::QBOX + (kk % 4) * 32),
                   desc_kmajor(ks + (kk / 4) * L::KBOX + (kk % 4) * 32), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64>(dp, desc_kmajor(dos + (kk / 4) * L::QBOX + (kk % 4) * 32),
                   desc_kmajor(vs + (kk / 4) * L::KBOX + (kk % 4) * 32), kk > 0);
    wgmma_commit();
  };

  // Tile j starts with S_j and dP_j in flight, behind the dq product of tile
  // j - 1.  The last tile is a second copy of the body without the next
  // tile's products, so that every wgmma group is issued on every path
  // through the loop: ptxas then knows which group a wait retires, and
  // keeps the products asynchronous.
  auto tile = [&](int j, auto next) {
    const int st = j % NS;
    wgmma_wait<1>();  // S_j and the dq product of tile j - 1 are in; dP_j runs
    reg_fence(s);
    reg_fence(acc);
    reg_fence(ds);
    if (j > 0 && lead) mbar_arrive(&bars.empty[(j - 1) % NS]);
    const int k0 = j * L::BN;
    if (k0 + L::BN > S || (causal && k0 + L::BN - 1 > row0)) {
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * c + 2 * t + (e & 1), row = e < 2 ? ra : rb;
          if (!(key < S && (!causal || key <= row))) s[4 * c + e] = NEG_INF;
        }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = ex2(s[i] - ls[(i >> 1) & 1]);
    reg_fence(s);  // keeps the exp2 pass above the wait: it overlaps dP
    wgmma_wait<0>();
    reg_fence(dp);
    // ds as mma.sync A fragments: ds[4kk..4kk+3] for keys 16kk.., rows g, g + 8
#pragma unroll
    for (int i = 0; i < 16; ++i)
      ds[i] = pack_bf16(s[2 * i] * (dp[2 * i] - dl[i & 1]),
                        s[2 * i + 1] * (dp[2 * i + 1] - dl[i & 1]));
    reg_fence(ds);
    reg_fence(acc);
    wgmma_fence();
    const uint32_t ks = opaque(base + L::OFF_K + st * L::TILE);
#pragma unroll
    for (int kk = 0; kk < L::BN / 16; ++kk)
      wgmma_rs<D>(acc, ds[4 * kk], ds[4 * kk + 1], ds[4 * kk + 2], ds[4 * kk + 3],
                  desc_mnmajor(ks + kk * 16 * 128, L::KBOX), 1);
    wgmma_commit();
    if constexpr (decltype(next)::value) {
      mbar_wait(&bars.full[(j + 1) % NS], ((j + 1) / NS) & 1);
      issue_sdp((j + 1) % NS);
    }
  };
  if (n_own > 0) {
    mbar_wait(&bars.q, 0);
    mbar_wait(&bars.full[0], 0);
    issue_sdp(0);
#pragma unroll 1
    for (int j = 0; j + 1 < n_own; ++j) tile(j, std::true_type());
    tile(n_own - 1, std::false_type());
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(ds);
    if (lead) mbar_arrive(&bars.empty[(n_own - 1) % NS]);
  }
  // tiles past this warpgroup's rows: wait for them (so that the phases stay
  // in order) and release them
  for (int j = n_own; j < n_tiles; ++j) {
    mbar_wait(&bars.full[j % NS], (j / NS) & 1);
    if (lead) mbar_arrive(&bars.empty[j % NS]);
  }

  // dividing by log2(e): acc / log2(e) is dq * INV_LOG2E up to one float32 ulp
  constexpr float LOG2E_F = 1.f / INV_LOG2E;
  bf16* dqb = dq + (size_t)bh * T * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? rb : ra;
    if (row >= T) continue;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)row * D + 8 * c + 2 * t) =
          __floats2bfloat162_rn(acc[4 * c + 2 * h] / LOG2E_F, acc[4 * c + 2 * h + 1] / LOG2E_F);
  }
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
int launch(const void* q, const void* k, const void* v, const void* o, const void* dO,
           const void* lse, void* dq, void* delta, int BH, int T, int S, int is_bf16,
           int causal, cudaStream_t st) {
  if (T < 1 || S < 1) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    using L = DqLayout<D>;
    constexpr int SMEM = L::BYTES + 1024;  // + the slack of aligning the base to 1024
    static const cudaError_t ready = cudaFuncSetAttribute(  // once
        flash_bwd_dq_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (ready != cudaSuccess) return (int)ready;
    CUtensorMap tq, tk, tv, tdo;
    cudaError_t e = hopper::tensor_map_3d(&tq, q, D, T, BH, L::BQ);
    if (e == cudaSuccess) e = hopper::tensor_map_3d(&tdo, dO, D, T, BH, L::BQ);
    if (e == cudaSuccess) e = hopper::tensor_map_3d(&tk, k, D, S, BH, L::BN);
    if (e == cudaSuccess) e = hopper::tensor_map_3d(&tv, v, D, S, BH, L::BN);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(BH, (T + L::BQ - 1) / L::BQ);
    flash_bwd_dq_bf16<D><<<grid, L::THREADS, SMEM, st>>>(
        tq, tk, tv, tdo, (const bf16*)o, (const bf16*)dO, (const float*)lse, (bf16*)dq,
        (float*)delta, T, S, causal);
  } else {
    dim3 grid((T + F32_ROWS - 1) / F32_ROWS, BH);
    flash_bwd_dq_f32<D><<<grid, F32_ROWS * 32, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)o, (const float*)dO,
        (const float*)lse, (float*)dq, (float*)delta, T, S, causal);
  }
  return (int)cudaGetLastError();
}

}  // namespace

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
