// Kernels H's and I's fused kernels (bf16): the three parts of the
// materialised two-way decode that sweep over the L image tokens, each on
// hopper.cuh's wgmma, TMA and mbarriers.  twoway_fused.cu runs them as the
// record kinds OP_TW_T2I, OP_TW_I2T_NORM4 and OP_TW_UPSCALE
// (twoway_kernel.Program.tw_t2i, .tw_i2t_norm4, .tw_upscale), which the bf16
// route of tw_program records in place of the projections over P L rows on
// the strided GEMM and the scalar tw_attn_image, tw_attn_rows and tw_masks
// (the float32 route keeps those: no float32 wgmma exists).
//
// They serve llmseg_tpu/ops/twoway_kernel.py::_kernel (kernel I) and
// ::_decode_kernel (kernel H), which project the keys state to k, v (t2i)
// and q (i2t) over every image token.  Here every keys-side projection is
// folded into the token side by associativity, as kernel G's G = (base
// sigma) W is (factored_fused.cuh): the sweeps over L multiply the keys
// state K (and kpe = round(K + pe), made a tile at a time in shared memory)
// by small per-prompt matrices that the token side makes, M = 8 N <= 128
// rows of C = 256, so a row of L costs about 2 x 256 x M operations an
// attention and no (P, L, 128) intermediate reaches device memory.  What
// bounds them is the passes over K: at 64 prompts one (P, L, 256) state is
// 134 MB, well past the 50 MB L2 (0.04 ms a pass at 3.35 TB/s); at 8 it is
// 17 MB and stays in L2, and the launches and the token side are the floor.
//
//   * tw_scores<STATS | ATTEND>: token-to-image attention.  Per prompt and
//     64-row block of its M rows, s = qk kpe^T + rsb a 64-token tile at a
//     time (qk = round(qbd W_k), rsb = qbd b_k: the k projection folded
//     in), p = softmax(s) over L, pk = round(p) K and rs = rowsum(p) (the v
//     projection, pk W_v^T + rs (x) b_v, follows on the token side).  Two
//     sweeps, as kernel G's fd_scores: the row statistics (STATS, the two
//     warpgroups taking turns over the tiles), then p normalised before it
//     is rounded, where the TPU kernel rounds it (ATTEND: both warpgroups
//     make the scores, each accumulates half of pk's 256 columns).  L is
//     split across CTAs (one wave of one CTA an SM); the splits' statistics
//     are merged in a fixed order at the start of ATTEND and their partials
//     added by tw_t2i_combine in a fixed order (no atomics: a replay repeats
//     to the bit).  The one-sweep form (a running maximum and sum, p
//     rounded before its normalisation: one read of K, not two, but a
//     larger error) is timed as a variant, scripts/twoway_fused_online.edits.
//   * tw_i2t_norm4<MP>: image-to-token attention and norm4, row local per
//     64-row tile of K: s = kpe kq^T + kbq (64 x MP; kq = round(kbd W_q),
//     the q projection folded in, its rows h Np + t padded to Np = 8 or 16 a
//     head so that each head's columns are whole 8-column chunks of the
//     accumulator), a softmax over each head's N columns in registers
//     (quad shuffles), then p vw + b_out (vw = round(bd(v) W_out^T), the out
//     projection folded in) in two halves of 128 columns, the residual with
//     K and the LayerNorm over the 256 columns through the K tile in shared
//     memory, and the new K tile written back (over K itself after layer 0).
//   * tw_upscale: the upscale from K per 64-row tile: y1 = K w1 + b1 a
//     sub-pixel group (64 columns) at a time, then fd_upscale's tail
//     (upscale_group, shared with kernel G): only the mask columns leave.
// Each rounds where its record's emulation rounds.  Every tile is 64 image
// tokens (FUSED_TILE): L must be a multiple of 64; the widths are SAM's
// decoder's (C = 256, 8 heads, the upscale 256 -> 64 -> 32, 4 mask tokens).
//
// Shared memory written by threads (kpe, the residual's x) is read by wgmma
// or overwritten by TMA only after fence.proxy.async (hopper.cuh).
#pragma once

#include "factored_fused.cuh"

namespace llmseg {
namespace fused {
// internal linkage, as factored_fused.cuh (a variant build of the same
// source keeps its own statics)
namespace {

constexpr int TW_THREADS = 288;   // two consumer warpgroups and a producer warp

// kpe = round(K + pe) over chunks first, first + step, ... of a stage's
// 64 x 256 tile (4 swizzled boxes of K, then 4 of pe, the same layout):
// written over pe, 16 bytes a chunk
__device__ __forceinline__ void make_kpe(unsigned char* stage, int first, int step) {
  for (int c = first; c < 2048; c += step) {
    const uint4 k = *reinterpret_cast<const uint4*>(stage + c * 16);
    uint4* pp = reinterpret_cast<uint4*>(stage + 32768 + c * 16);
    uint4 p = *pp;
    const __nv_bfloat162* kh = reinterpret_cast<const __nv_bfloat162*>(&k);
    __nv_bfloat162* ph = reinterpret_cast<__nv_bfloat162*>(&p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(kh[i]), b = __bfloat1622float2(ph[i]);
      ph[i] = __floats2bfloat162_rn(a.x + b.x, a.y + b.y);
    }
    *pp = p;
  }
}

// ---------------------------------------------------------------------------
// tw_scores: token-to-image attention (STATS, then ATTEND)
// ---------------------------------------------------------------------------

struct TwScoresArgs {
  const float* rsb;   // (Z, M)
  int Z, M, L, ns, tps, nmb, kz;   // kz: 0 when one base serves every prompt
  float *stats, *opart, *rspart;   // scratch, 64 rows a slot
};

// Shared memory from the 1024-aligned base: qk (4 boxes of 64 columns x 64
// rows), then two stages (K's tile, 4 boxes of 64 tokens, then pe's, which
// becomes kpe): in STATS each warpgroup's own (hopper.cuh: the stages of a
// ring taken in turns are a multiple of the takers).
constexpr uint32_t TS_OFF_ST = 32768, TS_STAGE = 65536;
constexpr int TS_STAGES = 2, TS_SMEM = TS_OFF_ST + TS_STAGES * TS_STAGE + SLACK;

template <int MODE>
__global__ void __launch_bounds__(TW_THREADS, 1)
tw_scores(const __grid_constant__ CUtensorMap tQ, const __grid_constant__ CUtensorMap tK,
          const __grid_constant__ CUtensorMap tPE, const TwScoresArgs a) {
  constexpr int NS = TS_STAGES;
  __shared__ ScBars bars;
  extern __shared__ unsigned char smem[];
  const uint32_t base = align1024(smem);
  unsigned char* gbase = smem + (base - smem_u32(smem));
  const int sp = blockIdx.x, mb = blockIdx.y, z = blockIdx.z;
  const int ntiles = a.L / TILE;
  const int t0 = sp * a.tps, n = max(0, min(ntiles, t0 + a.tps) - t0);
  if (threadIdx.x == 0) {
    mbar_init(&bars.q, 1);
    for (int i = 0; i < NS; ++i) {
      mbar_init(&bars.full[i], 1);
      mbar_init(&bars.empty[i], MODE == STATS ? 4 : 8);  // the warps that read the tile
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer: one thread issues every copy
    if (threadIdx.x != 256) return;
    mbar_expect_tx(&bars.q, 32768);
    for (int b = 0; b < 4; ++b) tma_load_3d(base + b * 8192, &tQ, 64 * b, 64 * mb, z, &bars.q);
    const int zk = a.kz ? z : 0;
    for (int i = 0; i < n; ++i) {
      const int st = i % NS, l0 = (t0 + i) * TILE;
      const uint32_t sb = base + TS_OFF_ST + st * TS_STAGE;
      mbar_wait(&bars.empty[st], ((i / NS) & 1) ^ 1);  // a fresh barrier passes
      mbar_expect_tx(&bars.full[st], TS_STAGE);
      for (int b = 0; b < 4; ++b) {
        tma_load_3d(sb + b * 8192, &tK, 64 * b, l0, zk, &bars.full[st]);
        tma_load_3d(sb + 32768 + b * 8192, &tPE, 64 * b, l0, 0, &bars.full[st]);
      }
    }
    return;
  }

  const int wg = warpgroup_index(), lane = threadIdx.x & 31, t4 = lane & 3;
  const int r0 = 16 * ((threadIdx.x / 32) & 3) + (lane >> 2);  // this thread's rows r0, r0 + 8
  const int zb = z * a.nmb + mb;                                // this CTA's (prompt, rows)
  float rsb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = 64 * mb + r0 + 8 * h;
    rsb[h] = m < a.M ? a.rsb[(size_t)z * a.M + m] : 0.f;
  }
  const uint32_t qs = base;
  mbar_wait(&bars.q, 0);

  // s (64 x 64) = qk kpe^T + rsb for the tile in stage sb
  auto scores = [&](float (&s)[32], uint32_t sb) {
    reg_fence(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
      wgmma_ss<64>(s, desc_kmajor(qs + (kk >> 2) * 8192 + (kk & 3) * 32),
                   desc_kmajor(sb + 32768 + (kk >> 2) * 8192 + (kk & 3) * 32), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] += rsb[(e >> 1) & 1];
  };

  if constexpr (MODE == STATS) {
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // l: this lane's partial sums
    for (int i = wg; i < n; i += 2) {
      const int st = i % NS;
      const uint32_t sb = base + TS_OFF_ST + st * TS_STAGE;
      mbar_wait(&bars.full[st], (i / NS) & 1);
      make_kpe(gbase + TS_OFF_ST + st * TS_STAGE, threadIdx.x & 127, 128);
      fence_proxy_async();
      bar_sync(1 + wg, 128);
      float s[32];
      scores(s, sb);
      fence_proxy_async();  // kpe's writes before the next TMA into the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(&bars.empty[st]);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mn = fmaxf(m[h], quad_max(mx[h]));
        float ps = 0.f;
#pragma unroll
        for (int e = 0; e < 32; ++e)
          if (((e >> 1) & 1) == h) ps += ex2((s[e] - mn) * LOG2E_F);
        l[h] = l[h] * ex2((m[h] - mn) * LOG2E_F) + ps;
        m[h] = mn;
      }
    }
    const size_t slot = (((size_t)zb * a.ns + sp) * 2 + wg) * 64;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lt = quad_sum(l[h]);
      if (t4 == 0) {
        a.stats[(slot + r0 + 8 * h) * 2] = m[h];
        a.stats[(slot + r0 + 8 * h) * 2 + 1] = lt;
      }
    }
  } else {  // ATTEND
    // the splits' statistics (two slots a split), merged in a fixed order
    float m[2], li[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* st = a.stats + ((size_t)zb * a.ns * 2 * 64 + r0 + 8 * h) * 2;
      float mx = NEG_INF, sum = 0.f;
      for (int q = 0; q < 2 * a.ns; ++q) mx = fmaxf(mx, st[q * 128]);
      for (int q = 0; q < 2 * a.ns; ++q) sum += st[q * 128 + 1] * ex2((st[q * 128] - mx) * LOG2E_F);
      m[h] = mx;
      li[h] = sum > 0.f ? 1.f / sum : 0.f;
    }
    // pk's columns 128 wg .. 128 wg + 127: K's boxes 2 wg, 2 wg + 1
    float o[64], rs[2] = {0.f, 0.f};
    zero(o);
    for (int i = 0; i < n; ++i) {
      const int st = i % NS;
      const uint32_t sb = base + TS_OFF_ST + st * TS_STAGE;
      mbar_wait(&bars.full[st], (i / NS) & 1);
      make_kpe(gbase + TS_OFF_ST + st * TS_STAGE, threadIdx.x, 256);
      fence_proxy_async();
      bar_sync(1, 256);
      float s[32];
      scores(s, sb);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int h = (e >> 1) & 1;
        s[e] = ex2((s[e] - m[h]) * LOG2E_F) * li[h];
        rs[h] += s[e];
      }
      uint32_t p[16];
      pack_a<64>(p, s);
      reg_fence(p);
      reg_fence(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<128>(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                      desc_mnmajor(sb + 2 * wg * 8192 + kk * 2048, 8192), 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(o);
      reg_fence(p);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&bars.empty[st]);
    }
    const size_t slot = ((size_t)zb * a.ns + sp) * 64;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      const float rt = quad_sum(rs[h]);
      if (64 * mb + row >= a.M) continue;
      float* orow = a.opart + (slot + row) * 256 + 128 * wg;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j + 2 * t4) = make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
      if (wg == 0 && t4 == 0) a.rspart[slot + row] = rt;
    }
  }
}

// pk = the splits' partial sums (Z, M, C) rounded to bf16, rs (Z, M); each
// a sum over the splits in order
__global__ void tw_t2i_combine(const float* opart, const float* rspart, bf16* pk, float* rs,
                               int Z, int M, int C, int nmb, int ns) {
  const long long W = C + 1, n = (long long)Z * M * W;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int k = (int)(i % W), m = (int)((i / W) % M), z = (int)(i / W / M);
    float sum = 0.f;
    for (int s = 0; s < ns; ++s) {
      const size_t r = (((size_t)z * nmb + m / 64) * ns + s) * 64 + m % 64;
      sum += k < C ? opart[r * C + k] : rspart[r];
    }
    if (k < C)
      pk[((size_t)z * M + m) * C + k] = __float2bfloat16(sum);
    else
      rs[(size_t)z * M + m] = sum;
  }
}

// the tensor maps of K (Z, L, 256) with z stride kz (0: one base) and pe
// (L, 256), boxes of 64 columns x 64 tokens
inline cudaError_t keys_maps(CUtensorMap* tK, CUtensorMap* tPE, const void* K, const void* pe,
                             long long Z, long long L, long long kz) {
  cudaError_t e = tmap3(tK, K, 256, L, kz ? Z : 1, 256, kz ? kz : L * 256, 64);
  if (e == cudaSuccess) e = tmap3(tPE, pe, 256, L, 1, 256, L * 256, 64);
  return e;
}

template <int MODE>
int tw_scores_launch(const CUtensorMap& tQ, const CUtensorMap& tK, const CUtensorMap& tPE,
                     const TwScoresArgs& a, cudaStream_t st) {
  constexpr int smem = TS_SMEM;
  auto kern = tw_scores<MODE>;
  static const cudaError_t attr = allow_smem(kern, smem);  // the same smem at every launch
  if (attr != cudaSuccess) return (int)attr;
  kern<<<dim3(a.ns, a.nmb, a.Z), TW_THREADS, smem, st>>>(tQ, tK, tPE, a);
  return (int)cudaGetLastError();
}

// OP_TW_T2I: ints Z, M, L, C, kz, ns and the scratch offsets (stats, pk,
// rs); pointers qk, rsb, K, pe, pk, rs, scratch
inline int tw_t2i_run(const long long* I, void* const* P, cudaStream_t st) {
  const long long Z = I[0], M = I[1], L = I[2], C = I[3], kz = I[4], ns = I[5];
  if (Z < 1 || Z > 65535 || M < 1 || M > 128 || C != 256 || L < TILE || L % TILE ||
      (kz != 0 && kz < L * C) || ns < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tQ, tK, tPE;
  cudaError_t e = tmap3(&tQ, P[0], 256, M, Z, 256, M * 256, 64);
  if (e == cudaSuccess) e = keys_maps(&tK, &tPE, P[2], P[3], Z, L, kz);
  if (e != cudaSuccess) return (int)e;
  float* scratch = static_cast<float*>(P[6]);
  TwScoresArgs a;
  a.rsb = static_cast<const float*>(P[1]);
  a.Z = (int)Z; a.M = (int)M; a.L = (int)L; a.kz = kz != 0;
  a.nmb = (int)((M + 63) / 64);
  const long long ntiles = L / TILE;
  a.ns = std::min<int>((int)ns, splits(ntiles, Z * a.nmb));   // the scratch holds ns splits
  a.tps = (int)((ntiles + a.ns - 1) / a.ns);
  a.stats = scratch + I[6]; a.opart = scratch + I[7]; a.rspart = scratch + I[8];
  const long long n = Z * M * (C + 1);
  const unsigned grid = (unsigned)std::min<long long>((n + 255) / 256, 4096);
  int r = tw_scores_launch<STATS>(tQ, tK, tPE, a, st);
  if (r == 0) r = tw_scores_launch<ATTEND>(tQ, tK, tPE, a, st);
  if (r != 0) return r;
  tw_t2i_combine<<<grid, 256, 0, st>>>(a.opart, a.rspart, static_cast<bf16*>(P[4]),
                                       static_cast<float*>(P[5]), (int)Z, (int)M, (int)C, a.nmb,
                                       a.ns);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tw_i2t_norm4: image-to-token attention, its out projection and norm4
// ---------------------------------------------------------------------------

struct TwRowsArgs {
  const float *kbq, *bout, *w, *b;   // (Z, MP); C = 256 each
  bf16* out;                         // (Z, L, 256)
  int Z, L, N, ns, tps, kz;
  float eps;
};

// A CTA: consumer warpgroups taking turns over the 64-token tiles of one
// split of a prompt's L, a stage each, and a producer warp.  Shared memory:
// kq and vw (4 boxes of 64 columns x MP rows each), then the stages (K's
// tile, 4 boxes, then pe's, which becomes kpe): two warpgroups at MP = 64,
// one at 128 (kq and vw leave room for one stage).
template <int MP>
struct TrLayout {
  static constexpr uint32_t BOX = MP * 128, OFF_VW = 4 * BOX, OFF_ST = 8 * BOX;
  static constexpr int WGS = MP == 64 ? 2 : 1, THREADS = 128 * WGS + 32;
  static constexpr int SMEM = OFF_ST + WGS * 65536 + SLACK;
};

template <int MP>
__global__ void __launch_bounds__(TrLayout<MP>::THREADS, 1)
tw_i2t_norm4(const __grid_constant__ CUtensorMap tKq, const __grid_constant__ CUtensorMap tVw,
             const __grid_constant__ CUtensorMap tK, const __grid_constant__ CUtensorMap tPE,
             const TwRowsArgs a) {
  using LY = TrLayout<MP>;
  // a head's NP columns are EPH accumulator entries of a thread (both rows)
  constexpr int NS = LY::WGS, NP = MP / 8, EPH = MP / 16;
  __shared__ ScBars bars;
  __shared__ float vec[MP + 3 * 256];   // kbq, then b_out, norm4's weight and bias
  extern __shared__ unsigned char smem[];
  const uint32_t base = align1024(smem);
  unsigned char* gbase = smem + (base - smem_u32(smem));
  const int sp = blockIdx.x, z = blockIdx.y;
  const int ntiles = a.L / TILE;
  const int t0 = sp * a.tps, n = max(0, min(ntiles, t0 + a.tps) - t0);
  if (threadIdx.x == 0) {
    mbar_init(&bars.q, 1);
    for (int i = 0; i < NS; ++i) {
      mbar_init(&bars.full[i], 1);
      mbar_init(&bars.empty[i], 4);   // the four warps of the warpgroup that takes the tile
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= 128 * NS) {
    if (threadIdx.x != 128 * NS) return;
    mbar_expect_tx(&bars.q, 8 * LY::BOX);
    for (int b = 0; b < 4; ++b) {
      tma_load_3d(base + b * LY::BOX, &tKq, 64 * b, 0, z, &bars.q);
      tma_load_3d(base + LY::OFF_VW + b * LY::BOX, &tVw, 64 * b, 0, z, &bars.q);
    }
    const int zk = a.kz ? z : 0;
    for (int i = 0; i < n; ++i) {
      const int st = i % NS, l0 = (t0 + i) * TILE;
      const uint32_t sb = base + LY::OFF_ST + st * 65536;
      mbar_wait(&bars.empty[st], ((i / NS) & 1) ^ 1);
      mbar_expect_tx(&bars.full[st], 65536);
      for (int b = 0; b < 4; ++b) {
        tma_load_3d(sb + b * 8192, &tK, 64 * b, l0, zk, &bars.full[st]);
        tma_load_3d(sb + 32768 + b * 8192, &tPE, 64 * b, l0, 0, &bars.full[st]);
      }
    }
    return;
  }

  for (int i = threadIdx.x; i < MP + 768; i += 128 * NS) {
    const int j = i - MP;
    vec[i] = i < MP ? a.kbq[(size_t)z * MP + i] : j < 256 ? a.bout[j] : j < 512 ? a.w[j - 256]
                                                                            : a.b[j - 512];
  }
  bar_sync(3, 128 * NS);
  const float *kbq = vec, *bout = vec + MP, *nw = vec + MP + 256, *nb = vec + MP + 512;
  const int wg = warpgroup_index(), lane = threadIdx.x & 31, t4 = lane & 3;
  const int lr = 16 * ((threadIdx.x / 32) & 3) + (lane >> 2);  // rows lr, lr + 8 of a tile
  mbar_wait(&bars.q, 0);
  for (int i = wg; i < n; i += NS) {
    const int st = i % NS, l0 = (t0 + i) * TILE;
    const uint32_t sb = base + LY::OFF_ST + st * 65536;
    unsigned char* kt = gbase + LY::OFF_ST + st * 65536;   // K's tile, then x, then the output
    mbar_wait(&bars.full[st], (i / NS) & 1);
    make_kpe(kt, threadIdx.x & 127, 128);
    fence_proxy_async();
    bar_sync(1 + wg, 128);

    // s (64 tokens x MP) = kpe kq^T + kbq
    float s[MP / 2];
    reg_fence(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
      wgmma_ss<MP>(s, desc_kmajor(sb + 32768 + (kk >> 2) * 8192 + (kk & 3) * 32),
                   desc_kmajor(base + (kk >> 2) * LY::BOX + (kk & 3) * 32), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    // a softmax over each head's N columns (the head's NP columns are NP / 8
    // whole chunks, four lanes a row), rounded to bf16 in the packing
#pragma unroll
    for (int h = 0; h < 8; ++h) {
      float mx[2] = {NEG_INF, NEG_INF}, sum[2] = {0.f, 0.f};
#pragma unroll
      for (int q = 0; q < EPH; ++q) {
        const int e = h * EPH + q;
        s[e] += kbq[acc_col(e)];
        if (acc_col(e) - h * NP < a.N) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
      }
      mx[0] = quad_max(mx[0]);
      mx[1] = quad_max(mx[1]);
#pragma unroll
      for (int q = 0; q < EPH; ++q) {
        const int e = h * EPH + q, r = (e >> 1) & 1;
        s[e] = acc_col(e) - h * NP < a.N ? ex2((s[e] - mx[r]) * LOG2E_F) : 0.f;
        sum[r] += s[e];
      }
      const float inv0 = 1.f / quad_sum(sum[0]), inv1 = 1.f / quad_sum(sum[1]);
#pragma unroll
      for (int q = 0; q < EPH; ++q) {
        const int e = h * EPH + q;
        s[e] *= (e >> 1) & 1 ? inv1 : inv0;
      }
    }
    uint32_t p[MP / 4];
    pack_a<MP>(p, s);

    // x = round(K + round(p vw + b_out)) in two halves of 128 columns,
    // written over K's tile, with this thread's rows' sums
    float rsum[2] = {0.f, 0.f};
#pragma unroll 1
    for (int hf = 0; hf < 2; ++hf) {
      float acc[64];
      reg_fence(acc);
      reg_fence(p);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < MP / 16; ++kk)
        wgmma_rs<128>(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                      desc_mnmajor(base + LY::OFF_VW + 2 * hf * LY::BOX + kk * 2048, LY::BOX),
                      kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(p);
#pragma unroll
      for (int e = 0; e < 64; e += 2) {
        const int r = lr + 8 * ((e >> 1) & 1), c = 128 * hf + acc_col(e);
        __nv_bfloat162* kx = reinterpret_cast<__nv_bfloat162*>(kt + (c >> 6) * 8192 + swz_off(r, c & 63));
        float o0 = acc[e] + bout[c], o1 = acc[e + 1] + bout[c + 1];
        rbf2(o0, o1);
        const float2 k = __bfloat1622float2(*kx);
        float x0 = k.x + o0, x1 = k.y + o1;
        rbf2(x0, x1);
        *kx = __floats2bfloat162_rn(x0, x1);
        rsum[(e >> 1) & 1] += x0 + x1;
      }
    }
    // the LayerNorm over the 256 columns (float32 statistics, two passes)
    float mu[2], q2[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) mu[h] = quad_sum(rsum[h]) / 256.f;
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 8 * j + 2 * t4;
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            kt + (c >> 6) * 8192 + swz_off(lr + 8 * h, c & 63)));
        q2[h] += (x.x - mu[h]) * (x.x - mu[h]) + (x.y - mu[h]) * (x.y - mu[h]);
      }
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) inv[h] = rsqrtf(quad_sum(q2[h]) / 256.f + a.eps);
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 8 * j + 2 * t4;
        __nv_bfloat162* kx = reinterpret_cast<__nv_bfloat162*>(
            kt + (c >> 6) * 8192 + swz_off(lr + 8 * h, c & 63));
        const float2 x = __bfloat1622float2(*kx);
        *kx = __floats2bfloat162_rn((x.x - mu[h]) * inv[h] * nw[c] + nb[c],
                                    (x.y - mu[h]) * inv[h] * nw[c + 1] + nb[c + 1]);
      }
    bar_sync(1 + wg, 128);
    // the tile out, 16 bytes a thread a step, each row's 512 bytes together
    bf16* out = a.out + ((size_t)z * a.L + l0) * 256;
    for (int c = threadIdx.x & 127; c < 2048; c += 128) {
      const int r = c >> 5, cc = c & 31;
      *reinterpret_cast<uint4*>(out + (size_t)r * 256 + cc * 8) = *reinterpret_cast<const uint4*>(
          kt + (cc >> 3) * 8192 + r * 128 + (((cc & 7) ^ (r & 7)) << 4));
    }
    fence_proxy_async();  // this warp's accesses of the stage before the next TMA writes
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars.empty[st]);
  }
}

// OP_TW_I2T_NORM4: ints Z, Mp, L, C, kz, nh, N; pointers K, pe, kq, kbq, vw,
// b_out, norm4's weight and bias, out; floats eps
inline int tw_i2t_norm4_run(const long long* I, void* const* P, const float* Fv,
                            cudaStream_t st) {
  const long long Z = I[0], Mp = I[1], L = I[2], C = I[3], kz = I[4], nh = I[5], N = I[6];
  if (Z < 1 || Z > 65535 || (Mp != 64 && Mp != 128) || C != 256 || nh != 8 || N < 1 ||
      N > Mp / 8 || L < TILE || L % TILE || (kz != 0 && kz < L * C))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tKq, tVw, tK, tPE;
  cudaError_t e = tmap3(&tKq, P[2], 256, Mp, Z, 256, Mp * 256, (uint32_t)Mp);
  if (e == cudaSuccess) e = tmap3(&tVw, P[4], 256, Mp, Z, 256, Mp * 256, (uint32_t)Mp);
  if (e == cudaSuccess) e = keys_maps(&tK, &tPE, P[0], P[1], Z, L, kz);
  if (e != cudaSuccess) return (int)e;
  TwRowsArgs a;
  a.kbq = static_cast<const float*>(P[3]);
  a.bout = static_cast<const float*>(P[5]);
  a.w = static_cast<const float*>(P[6]);
  a.b = static_cast<const float*>(P[7]);
  a.out = static_cast<bf16*>(P[8]);
  a.Z = (int)Z; a.L = (int)L; a.N = (int)N; a.kz = kz != 0; a.eps = Fv[0];
  const long long ntiles = L / TILE;
  a.ns = splits(ntiles, Z);
  a.tps = (int)((ntiles + a.ns - 1) / a.ns);
  static const cudaError_t attr64 = allow_smem(tw_i2t_norm4<64>, TrLayout<64>::SMEM);
  static const cudaError_t attr128 = allow_smem(tw_i2t_norm4<128>, TrLayout<128>::SMEM);
  if (attr64 != cudaSuccess) return (int)attr64;
  if (attr128 != cudaSuccess) return (int)attr128;
  if (Mp == 64)
    tw_i2t_norm4<64><<<dim3(a.ns, a.Z), TrLayout<64>::THREADS, TrLayout<64>::SMEM, st>>>(
        tKq, tVw, tK, tPE, a);
  else
    tw_i2t_norm4<128><<<dim3(a.ns, a.Z), TrLayout<128>::THREADS, TrLayout<128>::SMEM, st>>>(
        tKq, tVw, tK, tPE, a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tw_upscale: the upscale from the keys state
// ---------------------------------------------------------------------------

// A CTA: two consumer warpgroups taking turns over the 64-row tiles of one
// split of a prompt's L, and a producer warp.  Shared memory: w1 (4 boxes
// of 64 of its 256 columns x 256 rows), w2 (2 boxes of 64 columns x 64
// rows), hbd (2 boxes of 64 columns x 16 rows), two stages of K's tile (4
// boxes), then b1, the LayerNorm's weight and bias, and b2.
constexpr uint32_t TU_OFF_W2 = 131072, TU_OFF_HBD = 147456, TU_OFF_ST = 151552;
constexpr uint32_t TU_OFF_VEC = TU_OFF_ST + 2 * 32768;
constexpr int TU_SMEM = TU_OFF_VEC + 512 * 4 + SLACK;

struct TwUpArgs {
  const float *b1, *lnw, *lnb, *b2;
  bf16* cols;
  int Z, L, ns, tps;
  float eps;
};

__global__ void __launch_bounds__(TW_THREADS, 1)
tw_upscale(const __grid_constant__ CUtensorMap tK, const __grid_constant__ CUtensorMap tW1,
           const __grid_constant__ CUtensorMap tW2, const __grid_constant__ CUtensorMap tHbd,
           const TwUpArgs a) {
  __shared__ ScBars bars;
  extern __shared__ unsigned char smem[];
  const uint32_t base = align1024(smem);
  float* vec = reinterpret_cast<float*>(smem + (base - smem_u32(smem)) + TU_OFF_VEC);
  const float *b1 = vec, *lnw = vec + 256, *lnb = vec + 320, *b2 = vec + 384;
  const int sp = blockIdx.x, z = blockIdx.y;
  const int ntiles = a.L / TILE;
  const int t0 = sp * a.tps, n = max(0, min(ntiles, t0 + a.tps) - t0);
  if (threadIdx.x == 0) {
    mbar_init(&bars.q, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(&bars.full[i], 1);
      mbar_init(&bars.empty[i], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    if (threadIdx.x != 256) return;
    mbar_expect_tx(&bars.q, 131072 + 16384 + 4096);
    for (int b = 0; b < 4; ++b) tma_load_3d(base + b * 32768, &tW1, 64 * b, 0, 0, &bars.q);
    for (int b = 0; b < 2; ++b) {
      tma_load_3d(base + TU_OFF_W2 + b * 8192, &tW2, 64 * b, 0, 0, &bars.q);
      tma_load_3d(base + TU_OFF_HBD + b * 2048, &tHbd, 64 * b, 0, z, &bars.q);
    }
    for (int i = 0; i < n; ++i) {
      const int st = i & 1;
      mbar_wait(&bars.empty[st], ((i >> 1) & 1) ^ 1);
      mbar_expect_tx(&bars.full[st], 32768);
      for (int b = 0; b < 4; ++b)
        tma_load_3d(base + TU_OFF_ST + st * 32768 + b * 8192, &tK, 64 * b, (t0 + i) * TILE, z,
                    &bars.full[st]);
    }
    return;
  }

  for (int i = threadIdx.x; i < 512; i += 256)
    vec[i] = i < 256 ? a.b1[i] : i < 320 ? a.lnw[i - 256] : i < 384 ? a.lnb[i - 320] : a.b2[i - 384];
  bar_sync(1, 256);
  const int wg = warpgroup_index(), lane = threadIdx.x & 31, t4 = lane & 3;
  const int lr = 16 * ((threadIdx.x / 32) & 3) + (lane >> 2);  // rows lr, lr + 8 of a tile
  mbar_wait(&bars.q, 0);
  for (int i = wg; i < n; i += 2) {
    const int st = i & 1, l0 = (t0 + i) * TILE;
    const uint32_t sa = base + TU_OFF_ST + st * 32768;
    mbar_wait(&bars.full[st], (i >> 1) & 1);
    const int row[2] = {l0 + lr, l0 + lr + 8};  // of L
#pragma unroll 1
    for (int g1 = 0; g1 < 4; ++g1) {
      // y1's 64 columns of this group: K w1 + b1, rounded
      float y[32];
      reg_fence(y);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 16; ++kk)
        wgmma64_ss<0, 1>(y, desc_kmajor(sa + (kk >> 2) * 8192 + (kk & 3) * 32),
                         desc_mnmajor(base + g1 * 32768 + kk * 2048, 32768), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(y);
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int n0 = 64 * g1 + acc_col(e);
        float v0 = y[e] + b1[n0], v1 = y[e + 1] + b1[n0 + 1];
        rbf2(v0, v1);
        y[e] = v0;
        y[e + 1] = v1;
        sum[(e >> 1) & 1] += v0 + v1;
      }
      float c8[8];
      upscale_group(y, sum, lnw, lnb, b2, base + TU_OFF_W2, base + TU_OFF_HBD, a.eps, c8);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<__nv_bfloat162*>(a.cols + ((size_t)z * a.L + row[h]) * 64 + 16 * g1 +
                                             8 * j + 2 * t4) =
              __floats2bfloat162_rn(c8[4 * j + 2 * h], c8[4 * j + 2 * h + 1]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars.empty[st]);
  }
}

// OP_TW_UPSCALE: ints Z, L, C, c4, w4, 4 nt; pointers K, w1, b1, LN weight,
// LN bias, w2, b2, hbd, cols; floats eps
inline int tw_upscale_run(const long long* I, void* const* P, const float* Fv, cudaStream_t st) {
  const long long Z = I[0], L = I[1];
  if (Z < 1 || Z > 65535 || L < TILE || L % TILE || I[2] != 256 || I[3] != 256 ||
      I[4] != 128 || I[5] != 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tK, tW1, tW2, tHbd;
  cudaError_t e = tmap3(&tK, P[0], 256, L, Z, 256, L * 256, 64);
  if (e == cudaSuccess) e = tmap3(&tW1, P[1], 256, 256, 1, 256, 256 * 256, 256);
  if (e == cudaSuccess) e = tmap3(&tW2, P[5], 128, 64, 1, 128, 64 * 128, 64);
  if (e == cudaSuccess) e = tmap3(&tHbd, P[7], 128, 16, Z, 128, 16 * 128, 16);
  if (e != cudaSuccess) return (int)e;
  TwUpArgs a;
  a.b1 = static_cast<const float*>(P[2]);
  a.lnw = static_cast<const float*>(P[3]);
  a.lnb = static_cast<const float*>(P[4]);
  a.b2 = static_cast<const float*>(P[6]);
  a.cols = static_cast<bf16*>(P[8]);
  a.Z = (int)Z; a.L = (int)L; a.eps = Fv[0];
  const long long ntiles = L / TILE;
  a.ns = splits(ntiles, Z);
  a.tps = (int)((ntiles + a.ns - 1) / a.ns);
  static const cudaError_t attr = allow_smem(tw_upscale, TU_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  tw_upscale<<<dim3(a.ns, a.Z), TW_THREADS, TU_SMEM, st>>>(tK, tW1, tW2, tHbd, a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fused
}  // namespace llmseg
