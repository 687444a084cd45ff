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
// 64-key block (12 times at T = 767), where the float32 delta is 1/64 of o's
// bytes at D = 128.
//
// What bounds it on an H100: at the LLaMA-7B training shape (B*H = 32,
// T = S = 767, D = 128, causal) it does 4 products over 294,528 causal pairs,
// 9.7 GFLOP (10 us of tensor-core time), against 38 MB of q, k, v, do, dk
// and dv with the float32 lse and delta (11 us of memory time; o is never
// read): byte-bound, with the tensor cores as close as for kernel C.  The
// register file is what shapes the design: the float32 dk and dv of 64 keys
// x 128 take 128 registers a consumer thread, and s^T and dp^T of a 64-row
// query tile 64 more.
//
// What the design does: it works in the transposed orientation, so no
// operand is transposed in registers.  A CTA owns 64 keys of one head and
// holds their k and v in shared memory; it is one consumer warpgroup and
// one producer warp (160 threads), so that ptxas may give the consumer up
// to 255 registers: dk, dv, s^T, dp^T and a bf16 pack take about 210, and
// the kernel has no spill and keeps every wgmma asynchronous.  (Two
// consumer warpgroups of 64 keys beside a producer warpgroup that hands
// them its registers by setmaxnreg, 24 / 240, spilled at 64- and 32-row
// query tiles and ran slower; 32-row tiles in this design run slower too,
// scripts/bwd_variants.py.)  The producer warp streams 64-row
// tiles of q and do by TMA through a four-stage mbarrier ring, with the
// tile's lse and delta beside them: plain coalesced loads by the warp's
// lanes, since the (B*H, T) float32 rows have a stride of 4 T bytes (3068
// at T = 767) that no tensor map takes; rows past T read as 0.  Per tile
// the consumer runs s^T = k q^T and dp^T = v do^T as two wgmma groups from
// shared memory, the mask and exp2 of s^T while dp^T still runs,
// dv += p^T do with p^T packed to bf16 in registers (the A fragment) and do
// read as an MN-major B from the same stage, ds^T = p^T (dp^T - delta)
// while that product runs, then dk += ds^T q (q MN-major) under the wait
// for the next tile.  Every dk/dv row belongs to one CTA: no atomics, a
// deterministic result.  Causal query tiles start at the first tile that
// reaches the block's keys, the mask runs only where a tile crosses the
// diagonal or the keys are ragged, and the longest key blocks start first.
//
// float32 inputs take a plain SIMT kernel (one warp per key row) with the
// same math; it exists for exact comparisons, not for speed.
#include <type_traits>

#include "hopper.cuh"

using namespace llmseg;

namespace {

// Shared memory from a 1024-aligned base: the k block and the v block (NB
// boxes of BKV lines each), then STAGES stages of a q tile, a do tile (NB
// boxes of BQ lines each) and the tile's lse and delta (BQ floats each,
// padded to 1024 bytes so that every box stays 1024-aligned).
template <int D>
struct DkvLayout {
  static constexpr int BKV = 64, BQ = 64, NB = D / 64, STAGES = 4;
  static constexpr int THREADS = 128 + 32;  // a consumer warpgroup and a producer warp
  static constexpr uint32_t KBOX = BKV * 128, QBOX = BQ * 128;
  static constexpr uint32_t KBYTES = NB * KBOX, TILE = NB * QBOX;
  static constexpr uint32_t OFF_V = KBYTES, OFF_RING = 2 * KBYTES;
  static constexpr uint32_t OFF_DO = TILE, OFF_STAT = 2 * TILE, STAGE = 2 * TILE + 1024;
  static constexpr uint32_t BYTES = OFF_RING + STAGES * STAGE;
};

struct DkvBars {
  uint64_t kv, full[4], empty[4];
};

template <int D>
__global__ void __launch_bounds__(DkvLayout<D>::THREADS, 1)
flash_bwd_dkv_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int S, int causal) {
  using namespace hopper;
  using L = DkvLayout<D>;
  constexpr int NS = L::STAGES, BQ = L::BQ;
  __shared__ DkvBars bars;
  extern __shared__ unsigned char smem[];
  const uint32_t base = align1024(smem);
  unsigned char* const gbase = smem + (base - smem_u32(smem));  // the same bytes, generic
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * L::BKV;  // key blocks in order: the longest start first
  const int lo = causal ? k0 / BQ : 0;  // the first query tile with a row >= k0
  const int hi = (T + BQ - 1) / BQ;
  if (threadIdx.x == 0) {
    mbar_init(&bars.kv, 1);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      mbar_init(&bars.full[i], 2);   // the TMA bytes' arrival and the stats' arrival
      mbar_init(&bars.empty[i], 4);  // one arrival from each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp
    if (lo >= hi) return;
    const int lane = threadIdx.x & 31;
    const float* lseb = lse + (size_t)bh * T;
    const float* deltab = delta + (size_t)bh * T;
    if (lane == 0) {
      mbar_expect_tx(&bars.kv, 2 * L::KBYTES);
#pragma unroll
      for (int nb = 0; nb < L::NB; ++nb) {
        tma_load_3d(base + nb * L::KBOX, &tk, nb * 64, k0, bh, &bars.kv);
        tma_load_3d(base + L::OFF_V + nb * L::KBOX, &tv, nb * 64, k0, bh, &bars.kv);
      }
    }
    for (int j = lo; j < hi; ++j) {
      const int i = j - lo, st = i % NS;
      mbar_wait(&bars.empty[st], ((i / NS) & 1) ^ 1);  // a fresh barrier passes
      const uint32_t ring = base + L::OFF_RING + st * L::STAGE;
      if (lane == 0) {
        mbar_expect_tx(&bars.full[st], 2 * L::TILE);
#pragma unroll
        for (int nb = 0; nb < L::NB; ++nb) {
          tma_load_3d(ring + nb * L::QBOX, &tq, nb * 64, j * BQ, bh, &bars.full[st]);
          tma_load_3d(ring + L::OFF_DO + nb * L::QBOX, &tdo, nb * 64, j * BQ, bh,
                      &bars.full[st]);
        }
      }
      float* stat = reinterpret_cast<float*>(gbase + L::OFF_RING + st * L::STAGE + L::OFF_STAT);
#pragma unroll
      for (int r = lane; r < BQ; r += 32) {
        const int row = j * BQ + r;
        const bool ok = row < T;  // rows past T: lse = delta = 0, and their q, do are zero
        stat[r] = ok ? lseb[row] : 0.f;
        stat[BQ + r] = ok ? deltab[row] : 0.f;
      }
      __threadfence_block();
      __syncwarp();
      if (lane == 0) mbar_arrive(&bars.full[st]);
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool lead = lane == 0;
  const int ka = k0 + 16 * warp + g, kb = ka + 8;

  float dka[D / 2], dva[D / 2], s[BQ / 2], dp[BQ / 2];
  uint32_t pk[BQ / 4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 4; ++i) pk[i] = 0u;

  // s^T = k q^T and dp^T = v do^T of the tile in stage st: two wgmma groups
  auto issue_sdp = [&](int st) {
    const uint32_t qs = opaque(base + L::OFF_RING + st * L::STAGE), dos = qs + L::OFF_DO;
    const uint32_t ks = opaque(base), vs = opaque(base + L::OFF_V);
    reg_fence(s);
    reg_fence(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BQ>(s, desc_kmajor(ks + (kk / 4) * L::KBOX + (kk % 4) * 32),
                   desc_kmajor(qs + (kk / 4) * L::QBOX + (kk % 4) * 32), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BQ>(dp, desc_kmajor(vs + (kk / 4) * L::KBOX + (kk % 4) * 32),
                   desc_kmajor(dos + (kk / 4) * L::QBOX + (kk % 4) * 32), kk > 0);
    wgmma_commit();
  };

  // Tile j starts with s^T_j and dp^T_j in flight, behind the dk product of
  // tile j - 1.  The last tile is a second copy of the body without the
  // next tile's products, so that every wgmma group is issued on every path
  // through the loop: ptxas then knows which group a wait retires, and
  // keeps the products asynchronous.
  auto tile = [&](int j, auto next) {
    const int i = j - lo, st = i % NS;
    const uint32_t qs = opaque(base + L::OFF_RING + st * L::STAGE), dos = qs + L::OFF_DO;
    const float* stat = reinterpret_cast<const float*>(gbase + L::OFF_RING + st * L::STAGE +
                                                       L::OFF_STAT);
    wgmma_wait<1>();  // s^T and the dk product of the previous tile are in; dp^T runs
    reg_fence(s);
    reg_fence(dka);
    reg_fence(pk);
    if (j > lo && lead) mbar_arrive(&bars.empty[(i - 1) % NS]);
    const int r0 = j * BQ;
    // s^T: rows are this thread's keys (ka, kb), columns the tile's queries
    if (k0 + 64 > S || (causal && r0 < k0 + 63)) {
#pragma unroll
      for (int c = 0; c < BQ / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + 8 * c + 2 * t + (e & 1), key = e < 2 ? ka : kb;
          if (!(key < S && (!causal || key <= row))) s[4 * c + e] = NEG_INF;
        }
    }
#pragma unroll
    for (int c = 0; c < BQ / 8; ++c) {
      const float2 l = *reinterpret_cast<const float2*>(stat + 8 * c + 2 * t);
      s[4 * c] = ex2(s[4 * c] - l.x);
      s[4 * c + 1] = ex2(s[4 * c + 1] - l.y);
      s[4 * c + 2] = ex2(s[4 * c + 2] - l.x);
      s[4 * c + 3] = ex2(s[4 * c + 3] - l.y);
    }
    // p^T as mma.sync A fragments: pk[4kk..4kk+3] for queries 16kk..
#pragma unroll
    for (int x = 0; x < BQ / 4; ++x) pk[x] = pack_bf16(s[2 * x], s[2 * x + 1]);
    reg_fence(s);
    reg_fence(pk);
    reg_fence(dva);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<D>(dva, pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2], pk[4 * kk + 3],
                  desc_mnmajor(dos + kk * 16 * 128, L::QBOX), 1);  // dv += p^T do
    wgmma_commit();
    wgmma_wait<1>();  // dp^T is in; the dv product runs
    reg_fence(dp);
#pragma unroll
    for (int c = 0; c < BQ / 8; ++c) {
      const float2 d = *reinterpret_cast<const float2*>(stat + BQ + 8 * c + 2 * t);
      dp[4 * c] = s[4 * c] * (dp[4 * c] - d.x);
      dp[4 * c + 1] = s[4 * c + 1] * (dp[4 * c + 1] - d.y);
      dp[4 * c + 2] = s[4 * c + 2] * (dp[4 * c + 2] - d.x);
      dp[4 * c + 3] = s[4 * c + 3] * (dp[4 * c + 3] - d.y);
    }
    reg_fence(dp);  // keeps ds^T above the wait: it overlaps the dv product
    wgmma_wait<0>();
    reg_fence(dva);
    reg_fence(pk);  // p^T's registers stay untouched until here
#pragma unroll
    for (int x = 0; x < BQ / 4; ++x) pk[x] = pack_bf16(dp[2 * x], dp[2 * x + 1]);
    reg_fence(pk);
    reg_fence(dka);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<D>(dka, pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2], pk[4 * kk + 3],
                  desc_mnmajor(qs + kk * 16 * 128, L::QBOX), 1);  // dk += ds^T q
    wgmma_commit();
    if constexpr (decltype(next)::value) {
      mbar_wait(&bars.full[(i + 1) % NS], ((i + 1) / NS) & 1);
      issue_sdp((i + 1) % NS);
    }
  };
  if (lo < hi) {
    mbar_wait(&bars.kv, 0);
    mbar_wait(&bars.full[0], 0);
    issue_sdp(0);
#pragma unroll 1
    for (int j = lo; j + 1 < hi; ++j) tile(j, std::true_type());
    tile(hi - 1, std::false_type());
    wgmma_wait<0>();
    reg_fence(dka);
    reg_fence(pk);
    if (lead) mbar_arrive(&bars.empty[(hi - 1 - lo) % NS]);
  }

  // dividing by log2(e): dk / log2(e) is dk * INV_LOG2E up to one float32 ulp
  constexpr float LOG2E_F = 1.f / INV_LOG2E;
  bf16* dkb = dk + (size_t)bh * S * D;
  bf16* dvb = dv + (size_t)bh * S * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = h ? kb : ka;
    if (key >= S) continue;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const size_t off = (size_t)key * D + 8 * c + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dkb + off) =
          __floats2bfloat162_rn(dka[4 * c + 2 * h] / LOG2E_F, dka[4 * c + 2 * h + 1] / LOG2E_F);
      *reinterpret_cast<__nv_bfloat162*>(dvb + off) =
          __floats2bfloat162_rn(dva[4 * c + 2 * h], dva[4 * c + 2 * h + 1]);
    }
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
int launch(const void* q, const void* k, const void* v, const void* dO, const void* lse,
           const void* delta, void* dk, void* dv, int BH, int T, int S, int is_bf16,
           int causal, cudaStream_t st) {
  if (T < 1 || S < 1) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    using L = DkvLayout<D>;
    constexpr int SMEM = L::BYTES + 1024;  // + the slack of aligning the base to 1024
    static const cudaError_t ready = cudaFuncSetAttribute(  // once
        flash_bwd_dkv_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (ready != cudaSuccess) return (int)ready;
    CUtensorMap tq, tk, tv, tdo;
    cudaError_t e = hopper::tensor_map_3d(&tq, q, D, T, BH, L::BQ);
    if (e == cudaSuccess) e = hopper::tensor_map_3d(&tdo, dO, D, T, BH, L::BQ);
    if (e == cudaSuccess) e = hopper::tensor_map_3d(&tk, k, D, S, BH, L::BKV);
    if (e == cudaSuccess) e = hopper::tensor_map_3d(&tv, v, D, S, BH, L::BKV);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(BH, (S + L::BKV - 1) / L::BKV);
    flash_bwd_dkv_bf16<D><<<grid, L::THREADS, SMEM, st>>>(
        tq, tk, tv, tdo, (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, T, S,
        causal);
  } else {
    dim3 grid((S + F32_ROWS - 1) / F32_ROWS, BH);
    flash_bwd_dkv_f32<D><<<grid, F32_ROWS * 32, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dO, (const float*)lse,
        (const float*)delta, (float*)dk, (float*)dv, T, S, causal);
  }
  return (int)cudaGetLastError();
}

}  // namespace

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
