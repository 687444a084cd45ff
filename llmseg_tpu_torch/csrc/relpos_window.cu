// Kernel F: whole-window attention with SAM's decomposed rel-pos bias.
//
// Replaces llmseg_tpu/ops/relpos_attention.py::_window_kernel (launched by
// relpos_flash_attention for token grids of T = G*G <= 512: SAM ViT-H's 28
// windowed layers, 14 x 14 windows, T = 196).  Same function: exp2-domain
// logits of a pre-scaled q plus the bias rh[i, j / G] + rw[i, j % G], the
// exact row maximum over the whole window, p = exp2(s - max) divided by its
// row sum BEFORE the PV product and rounded to v's dtype, then p v.  The
// zero-padded tokens of a window are real keys here, as in the TPU kernel;
// only the keys past T in the last 64-key tile are masked.
//
// What bounds it on an H100: at ViT-H's windowed layer (25 windows x 16
// heads, T = 196, D = 80) the products are 4.9 GFLOP (5 us) against about
// 55 MB of q, k, v, o, rh and rw (16 us): bytes.  So each block reads a
// window's k and v once into shared memory with cp.async and keeps them
// there; a block owns 64 query rows of one (window, head) and makes two
// passes over the resident keys on mma.sync (common.cuh): the first finds
// each row's maximum and sum online, the second recomputes the logits,
// normalises p, rounds it to bf16 and multiplies it into v.  Recomputing
// q k^T costs flops the card has to spare and no bytes.
//
// float32 inputs take the plain SIMT kernel of relpos.cuh (online softmax;
// it normalises at the end, which in float32 differs only by rounding).
#include "relpos.cuh"

using namespace llmseg;

template <int D, int NW, int GT>
__global__ void __launch_bounds__(NW * 32)
relpos_window_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ rh,
                   const bf16* __restrict__ rw, bf16* __restrict__ o, int T, int G) {
  using L = Tiles<D, NW>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_tiles = (T + BK - 1) / BK;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + L::BQ * L::LD;
  bf16* sV = sK + n_tiles * BK * L::LD;
  float* sRh = reinterpret_cast<float*>(sV + n_tiles * BK * L::LD);
  float* sRw = sRh + L::BQ * (G + 1);
  const int bh = blockIdx.y, q0 = blockIdx.x * L::BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int row0 = q0 + warp * 16 + (lane >> 2), row1 = row0 + 8;
  const int rl0 = warp * 16 + (lane >> 2);

  load_tile_async<D, L::THREADS>(sQ, q + (size_t)bh * T * D, q0, L::BQ, T, L::LD);
  load_tile_async<D, L::THREADS>(sK, k + (size_t)bh * T * D, 0, n_tiles * BK, T, L::LD);
  load_tile_async<D, L::THREADS>(sV, v + (size_t)bh * T * D, 0, n_tiles * BK, T, L::LD);
  cp_async_commit();
  load_table(sRh, rh + (size_t)bh * T * G, q0, L::BQ, T, G);
  load_table(sRw, rw + (size_t)bh * T * G, q0, L::BQ, T, G);
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[D / 16][4];
  load_q_frags<D>(qa, sQ, L::LD, warp * 16);

  // pass 1: row maximum and sum (this lane's partial sums, rescaled online)
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    float s[BK / 8][4];
    qk_tile<D>(s, qa, sK + it * BK * L::LD, L::LD);
    add_bias<GT>(s, sRh, sRw, rl0, it * BK, T, G);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      ps0 += exp2f(s[j][0] - mn0) + exp2f(s[j][1] - mn0);
      ps1 += exp2f(s[j][2] - mn1) + exp2f(s[j][3] - mn1);
    }
    l0 = l0 * exp2f(m0 - mn0) + ps0;
    l1 = l1 * exp2f(m1 - mn1) + ps1;
    m0 = mn0;
    m1 = mn1;
  }
  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);

  // pass 2: normalised p, rounded to bf16, times v
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    float s[BK / 8][4];
    qk_tile<D>(s, qa, sK + it * BK * L::LD, L::LD);
    add_bias<GT>(s, sRh, sRw, rl0, it * BK, T, G);
    uint32_t pk[BK / 8][2];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      pk[j][0] = pack_bf16(exp2f(s[j][0] - m0) * inv0, exp2f(s[j][1] - m0) * inv0);
      pk[j][1] = pack_bf16(exp2f(s[j][2] - m1) * inv1, exp2f(s[j][3] - m1) * inv1);
    }
    pv_tile<D>(acc, pk, sV + it * BK * L::LD, L::LD);
  }
  bf16* ob = o + (size_t)bh * T * D;
  if (row0 < T) store_rows<D>(ob, acc, row0, 0, 1.f);
  if (row1 < T) store_rows<D>(ob, acc, row1, 1, 1.f);
}

template <int D, int GT>
static int launch_g(const void* q, const void* k, const void* v, const void* rh, const void* rw,
                  void* o, int BH, int T, int G, cudaStream_t st) {
  constexpr int NW = 4;
  using L = Tiles<D, NW>;
  const int n_tiles = (T + BK - 1) / BK;
  const size_t bytes = sizeof(bf16) * (size_t)(L::BQ + 2 * n_tiles * BK) * L::LD +
                       2 * sizeof(float) * L::BQ * (G + 1);
  cudaError_t e = cudaFuncSetAttribute(relpos_window_bf16<D, NW, GT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + L::BQ - 1) / L::BQ, BH);
  relpos_window_bf16<D, NW, GT><<<grid, L::THREADS, bytes, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)rh, (const bf16*)rw,
      (bf16*)o, T, G);
  return (int)cudaGetLastError();
}

// the grid side of SAM's windows at compile time, any other at run time
template <int D>
static int launch(const void* q, const void* k, const void* v, const void* rh, const void* rw,
                  void* o, int BH, int T, int G, cudaStream_t st) {
  if (G == 14) return launch_g<D, 14>(q, k, v, rh, rw, o, BH, T, G, st);
  return launch_g<D, 0>(q, k, v, rh, rw, o, BH, T, G, st);
}

// q (BH, T, D) pre-scaled, k/v (BH, T, D), rh/rw (BH, T, G), o like q;
// T == G*G <= 512.  bf16 takes D in {16, 32, 64, 80, 128}, float32 any
// D <= 128.  Returns the launch's cudaError_t.
extern "C" int relpos_window(const void* q, const void* k, const void* v, const void* rh,
                             const void* rw, void* o, int BH, int T, int G, int D, int is_bf16,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (T > 512 || T != G * G) return (int)cudaErrorInvalidValue;
  if (!is_bf16) return launch_relpos_f32(q, k, v, rh, rw, o, BH, T, G, D, st);
  switch (D) {
    case 16: return launch<16>(q, k, v, rh, rw, o, BH, T, G, st);
    case 32: return launch<32>(q, k, v, rh, rw, o, BH, T, G, st);
    case 64: return launch<64>(q, k, v, rh, rw, o, BH, T, G, st);
    case 80: return launch<80>(q, k, v, rh, rw, o, BH, T, G, st);
    case 128: return launch<128>(q, k, v, rh, rw, o, BH, T, G, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* relpos_window_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
