// Kernel E: flash attention forward with SAM's decomposed rel-pos bias.
//
// Replaces llmseg_tpu/ops/relpos_attention.py::_kernel (launched by
// relpos_flash_attention for token grids of T = G*G > 512: SAM ViT-H's four
// global layers, G = 64).  Same function: exp2-domain logits of a
// pre-scaled q, bias rh[i, j / G] + rw[i, j % G] from the (T, G) tables,
// online max / sum / accumulator in float32, p rounded to v's dtype before
// the PV product, rows divided by their sum at the end.
//
// What bounds it on an H100: at ViT-H's global layer (B*H = 16, T = 4096,
// D = 80) the two products are 85.9 GFLOP against about 59 MB of q, k, v,
// o, rh and rw, so the tensor-core rate is the limit (about 0.087 ms).  The
// design is kernel A's (common.cuh): a block owns 64 query rows (4 warps x
// 16) and streams 64-key tiles of k and v through a two-stage cp.async
// ring; both products run on mma.sync m16n8k16 with logits, probabilities
// and the output accumulator in registers.  D = 80 runs unpadded, as 5
// k-steps of 16 for q k^T and 10 n-tiles of 8 for p v.  The TPU kernel
// rebuilt the bias with two selection matmuls (Mosaic cannot index lanes);
// here the block stages its 64 rows of rh and rw in shared memory as
// float32 and adds the bias by index.  wgmma and TMA are the next step.
//
// float32 inputs take the plain SIMT kernel of relpos.cuh.
#include "relpos.cuh"

using namespace llmseg;

template <int D, int NW, int GT>
__global__ void __launch_bounds__(NW * 32)
relpos_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ rh,
                const bf16* __restrict__ rw, bf16* __restrict__ o, int T, int G) {
  using L = Tiles<D, NW>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + L::BQ * L::LD;
  bf16* sV = sK + 2 * BK * L::LD;
  float* sRh = reinterpret_cast<float*>(sV + 2 * BK * L::LD);
  float* sRw = sRh + L::BQ * (G + 1);
  const int bh = blockIdx.y, q0 = blockIdx.x * L::BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int row0 = q0 + warp * 16 + (lane >> 2), row1 = row0 + 8;
  const bf16* kb = k + (size_t)bh * T * D;
  const bf16* vb = v + (size_t)bh * T * D;

  load_tile_async<D, L::THREADS>(sQ, q + (size_t)bh * T * D, q0, L::BQ, T, L::LD);
  load_tile_async<D, L::THREADS>(sK, kb, 0, BK, T, L::LD);
  load_tile_async<D, L::THREADS>(sV, vb, 0, BK, T, L::LD);
  cp_async_commit();
  load_table(sRh, rh + (size_t)bh * T * G, q0, L::BQ, T, G);
  load_table(sRw, rw + (size_t)bh * T * G, q0, L::BQ, T, G);

  const int n_tiles = (T + BK - 1) / BK;
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // l: this lane's partial sums
  uint32_t qa[D / 16][4];
  const int rl0 = warp * 16 + (lane >> 2);  // row0's index in the tables

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) {
      load_tile_async<D, L::THREADS>(sK + (st ^ 1) * BK * L::LD, kb, (it + 1) * BK, BK, T, L::LD);
      load_tile_async<D, L::THREADS>(sV + (st ^ 1) * BK * L::LD, vb, (it + 1) * BK, BK, T, L::LD);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) load_q_frags<D>(qa, sQ, L::LD, warp * 16);

    float s[BK / 8][4];
    qk_tile<D>(s, qa, sK + st * BK * L::LD, L::LD);
    add_bias<GT>(s, sRh, sRw, rl0, it * BK, T, G);
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
  bf16* ob = o + (size_t)bh * T * D;
  if (row0 < T) store_rows<D>(ob, acc, row0, 0, l0 == 0.f ? 1.f : l0);
  if (row1 < T) store_rows<D>(ob, acc, row1, 1, l1 == 0.f ? 1.f : l1);
}

template <int D, int GT>
static int launch_g(const void* q, const void* k, const void* v, const void* rh, const void* rw,
                  void* o, int BH, int T, int G, cudaStream_t st) {
  constexpr int NW = 4;
  using L = Tiles<D, NW>;
  const size_t bytes = L::BYTES + 2 * sizeof(float) * L::BQ * (G + 1);
  cudaError_t e = cudaFuncSetAttribute(relpos_fwd_bf16<D, NW, GT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + L::BQ - 1) / L::BQ, BH);
  relpos_fwd_bf16<D, NW, GT><<<grid, L::THREADS, bytes, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)rh, (const bf16*)rw,
      (bf16*)o, T, G);
  return (int)cudaGetLastError();
}

// the grid side of SAM's global layers at compile time, any other at run time
template <int D>
static int launch(const void* q, const void* k, const void* v, const void* rh, const void* rw,
                  void* o, int BH, int T, int G, cudaStream_t st) {
  if (G == 64) return launch_g<D, 64>(q, k, v, rh, rw, o, BH, T, G, st);
  return launch_g<D, 0>(q, k, v, rh, rw, o, BH, T, G, st);
}

// q (BH, T, D) pre-scaled, k/v (BH, T, D), rh/rw (BH, T, G), o like q;
// T == G*G, G <= 64.  bf16 takes D in {16, 32, 64, 80, 128}, float32 any
// D <= 128.  Returns the launch's cudaError_t.
extern "C" int relpos_fwd(const void* q, const void* k, const void* v, const void* rh,
                          const void* rw, void* o, int BH, int T, int G, int D, int is_bf16,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (G > MAX_G || T != G * G) return (int)cudaErrorInvalidValue;
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

extern "C" const char* relpos_fwd_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
