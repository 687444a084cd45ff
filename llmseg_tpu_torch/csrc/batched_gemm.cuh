// Device code shared by kernel G (factored_decode.cu) and kernels H and I
// (twoway_fused.cu): value helpers, block reductions, a strided batched
// GEMM with fused epilogues, c[z] (M x N) = epilogue(alpha * a[z] (M x K)
// b[z] (K x N)), on mma.sync m16n8k16 for bf16 operands and a SIMT tile for
// float32 ones, a rounded add and a residual LayerNorm.
#pragma once

#include "common.cuh"

namespace {

using namespace llmseg;

enum { ACT_NONE, ACT_RELU, ACT_GELU };
enum { F_BETA = 1, F_ROWADD = 2, F_BIAS = 4, F_OUTER = 8, F_COLSCALE = 16, F_ROWMAT = 32 };
constexpr int THREADS = 256;

__device__ __forceinline__ float ldv(const void* p, long long i, int bf) {
  return bf ? __bfloat162float(static_cast<const bf16*>(p)[i]) : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void stv(void* p, long long i, float v, int bf) {
  if (bf)
    static_cast<bf16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}
// the value as stored in the given type
__device__ __forceinline__ float rnd(float v, int bf) {
  return bf ? __bfloat162float(__float2bfloat16(v)) : v;
}
__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}
__device__ __forceinline__ float act_fn(float v, int act, int bf) {
  if (act == ACT_NONE) return v;
  v = rnd(v, bf);
  return act == ACT_RELU ? fmaxf(v, 0.f) : gelu_tanh(v);
}

__device__ __forceinline__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  const int w = threadIdx.x / 32, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[w] = x;
  __syncthreads();
  float t = lane < blockDim.x / 32 ? red[lane] : 0.f;
  return warp_sum(t);
}
__device__ __forceinline__ float block_max(float x, float* red) {
  x = warp_max(x);
  const int w = threadIdx.x / 32, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[w] = x;
  __syncthreads();
  float t = lane < blockDim.x / 32 ? red[lane] : -3.0e38f;
  return warp_max(t);
}

// ---------------------------------------------------------------------------
// Strided batched GEMM: c[z] (M x N) = epilogue(alpha * a[z] (M x K) b[z] (K x N))
// ---------------------------------------------------------------------------

constexpr int GM = 64, GN = 64, GK = 16;

struct GemmArgs {
  const void *a, *b;
  void* c;
  const float *cin, *colscale, *rowadd, *bias;
  long long Z, M, N, K, sAz, sAm, sAk, sBz, sBk, sBn, sCz, sCm, sCn;
  int abf, bbf, cbf, flags, act;
  long long csz, raz;
  float alpha;
  const void* emat;     // F_ROWMAT: rowadd[m] * emat[m][n] (row stride sEm, shared by z)
  long long sEm;
  int ebf;
};

__device__ __forceinline__ void gemm_store(const GemmArgs& g, long long z, long long m,
                                           long long n, float acc) {
  if (m >= g.M || n >= g.N) return;
  const long long ci = z * g.sCz + m * g.sCm + n * g.sCn;
  float v = acc * g.alpha;
  if (g.flags & F_COLSCALE) v *= g.colscale[z * g.csz + n];
  if (g.flags & F_BETA) v = g.cin[ci] + v;
  if (g.flags & F_ROWMAT) v = ldv(g.emat, m * g.sEm + n, g.ebf) * g.rowadd[z * g.raz + m] + v;
  if (g.flags & F_OUTER) v += g.rowadd[z * g.raz + m] * g.bias[n];
  if (g.flags & F_ROWADD) v += g.rowadd[z * g.raz + m];
  if (g.flags & F_BIAS) v += g.bias[n];
  stv(g.c, ci, act_fn(v, g.act, g.cbf), g.cbf);
}

// float32 (or mixed) operands: SIMT, each thread 4 x 4 outputs
__global__ void __launch_bounds__(THREADS) fd_gemm(GemmArgs g) {
  __shared__ float As[GK][GM + 4];
  __shared__ float Bs[GK][GN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long z = blockIdx.z, m0 = (long long)blockIdx.y * GM, n0 = (long long)blockIdx.x * GN;
  const long long aoff = z * g.sAz, boff = z * g.sBz;
  float acc[4][4] = {};
  const bool a_kfast = g.sAk == 1, b_nfast = g.sBn == 1;
  for (long long k0 = 0; k0 < g.K; k0 += GK) {
#pragma unroll
    for (int j = 0; j < GM * GK / THREADS; ++j) {
      const int e = tid + THREADS * j;
      const int kk = a_kfast ? e % GK : e / GM, mm = a_kfast ? e / GK : e % GM;
      const long long m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < g.M && k < g.K) ? ldv(g.a, aoff + m * g.sAm + k * g.sAk, g.abf) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < GN * GK / THREADS; ++j) {
      const int e = tid + THREADS * j;
      const int kk = b_nfast ? e / GN : e % GK, nn = b_nfast ? e % GN : e / GK;
      const long long n = n0 + nn, k = k0 + kk;
      Bs[kk][nn] = (n < g.N && k < g.K) ? ldv(g.b, boff + k * g.sBk + n * g.sBn, g.bbf) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) gemm_store(g, z, m0 + ty + 16 * i, n0 + tx + 16 * j, acc[i][j]);
}

// bf16 operands: a 64 x 64 tile on mma.sync m16n8k16 (common.cuh), 8 warps
// of 16 rows x 32 columns, k-tiles of 32 in a ring of GSTAGES in shared
// memory (the small products of the decodes' token sides are a few CTAs
// each, whose k loops wait on their loads: the ring keeps GSTAGES - 1 tiles
// of loads in flight).
// How an operand is staged depends on its strides (STAGE_*): with the k
// index contiguous it is copied by 16-byte cp.async into [row][k] rows,
// read by ldmatrix as the attention kernels read q and k; with the row
// index (m of A, n of B) contiguous it is copied the same way into [k][row]
// rows and read by ldmatrix.trans, as they read v; any other strides (or a
// misaligned base) take element-wise loads into [row][k].  The vector
// copies zero-fill a chunk past the edge of the matrix, so neither M, N nor
// K need be a multiple of 8.
constexpr int MK = 32, MLD = MK + 8, TLD = GM + 8, GSTAGES = 4;
constexpr int STAGE_ELEMS = GM * MLD;  // >= MK * TLD
enum { STAGE_SCALAR, STAGE_KFAST, STAGE_ROWFAST };

// 16-byte asynchronous copy of which the first `bytes` come from src and
// the rest are zero-filled
__device__ __forceinline__ void cp_async_n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ int chunk_bytes(long long left) {
  return left <= 0 ? 0 : left >= 8 ? 16 : (int)left * 2;
}

// one k-tile (rows r0.., k0..) of a (rows, K) operand with strides (s_row,
// s_k) into the stage buffer
template <int MODE>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, long long r0,
                                           long long rows, long long k0, long long K,
                                           long long s_row, long long s_k) {
  const int tid = threadIdx.x;
  if (MODE == STAGE_KFAST) {          // 64 rows x 4 chunks of k
    const int r = tid >> 2, kc = (tid & 3) * 8;
    const bool ok = r0 + r < rows;
    const int bytes = ok ? chunk_bytes(K - (k0 + kc)) : 0;
    cp_async_n(dst + r * MLD + kc, bytes ? src + (r0 + r) * s_row + k0 + kc : src, bytes);
  } else if (MODE == STAGE_ROWFAST) {  // 32 k x 8 chunks of rows
    const int k = tid >> 3, rc = (tid & 7) * 8;
    const int bytes = k0 + k < K ? chunk_bytes(rows - (r0 + rc)) : 0;
    cp_async_n(dst + k * TLD + rc, bytes ? src + (k0 + k) * s_k + r0 + rc : src, bytes);
  } else {
    const bf16 zero = __float2bfloat16(0.f);
#pragma unroll
    for (int j = 0; j < GM * MK / THREADS; ++j) {
      const int e = tid + THREADS * j, r = e / MK, k = e % MK;
      dst[r * MLD + k] = (r0 + r < rows && k0 + k < K) ? src[(r0 + r) * s_row + (k0 + k) * s_k]
                                                       : zero;
    }
  }
}

template <int AMODE, int BMODE>
__global__ void __launch_bounds__(THREADS) fd_gemm_mma(GemmArgs g) {
  __shared__ __align__(16) bf16 sA[GSTAGES][STAGE_ELEMS];
  __shared__ __align__(16) bf16 sB[GSTAGES][STAGE_ELEMS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int wm = warp % 4, wn = warp / 4, r8 = lane & 7, mi = lane >> 3;
  const long long z = blockIdx.z, m0 = (long long)blockIdx.y * GM, n0 = (long long)blockIdx.x * GN;
  const bf16* A = static_cast<const bf16*>(g.a) + z * g.sAz;
  const bf16* B = static_cast<const bf16*>(g.b) + z * g.sBz;
  float acc[4][4] = {};
  auto stage = [&](int buf, long long k0) {
    stage_tile<AMODE>(sA[buf], A, m0, g.M, k0, g.K, g.sAm, g.sAk);
    stage_tile<BMODE>(sB[buf], B, n0, g.N, k0, g.K, g.sBn, g.sBk);
    cp_async_commit();
  };
  for (int s = 0; s < GSTAGES - 1; ++s) {
    if (s * MK < g.K)
      stage(s, s * MK);
    else
      cp_async_commit();
  }
  for (long long k0 = 0, it = 0; k0 < g.K; k0 += MK, ++it) {
    const int buf = (int)(it % GSTAGES);
    cp_async_wait<GSTAGES - 2>();
    __syncthreads();   // tile it landed; tile it - 1's slot is free
    const long long kn = k0 + (GSTAGES - 1) * MK;
    if (kn < g.K)
      stage((int)((it + GSTAGES - 1) % GSTAGES), kn);
    else
      cp_async_commit();
    const bf16 *a_s = sA[buf], *b_s = sB[buf];
#pragma unroll
    for (int kk = 0; kk < MK / 16; ++kk) {
      uint32_t a[4];
      if (AMODE == STAGE_ROWFAST)
        ldsm_x4_t(a, a_s + (kk * 16 + r8 + (mi >> 1) * 8) * TLD + wm * 16 + (mi & 1) * 8);
      else
        ldsm_x4(a, a_s + (wm * 16 + r8 + (mi & 1) * 8) * MLD + kk * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        if (BMODE == STAGE_ROWFAST)
          ldsm_x4_t(b, b_s + (kk * 16 + r8 + (mi & 1) * 8) * TLD + wn * 32 + np * 16 +
                           (mi >> 1) * 8);
        else
          ldsm_x4(b, b_s + (wn * 32 + np * 16 + r8 + (mi >> 1) * 8) * MLD + kk * 16 +
                         (mi & 1) * 8);
        mma16816(acc[2 * np], a, b[0], b[1]);
        mma16816(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
  const int gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      gemm_store(g, z, m0 + wm * 16 + gr + (e >> 1) * 8, n0 + wn * 32 + j * 8 + 2 * t + (e & 1),
                 acc[j][e]);
}

// how a bf16 operand with batch, row and k strides (elements) is staged
int stage_mode(const void* p, long long s_z, long long s_row, long long s_k) {
  const bool aligned = reinterpret_cast<uintptr_t>(p) % 16 == 0 && s_z % 8 == 0;
  if (aligned && s_k == 1 && s_row % 8 == 0) return STAGE_KFAST;
  if (aligned && s_row == 1 && s_k % 8 == 0) return STAGE_ROWFAST;
  return STAGE_SCALAR;
}

// launch the GEMM on stream st; bf16 a and b take the mma.sync kernel,
// staged as their strides allow.  Returns 0 or cudaErrorInvalidValue.
inline int gemm_launch(const GemmArgs& g, cudaStream_t st) {
  if (g.Z > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((g.N + GN - 1) / GN), (unsigned)((g.M + GM - 1) / GM), (unsigned)g.Z);
  if (!(g.abf && g.bbf)) {
    fd_gemm<<<grid, THREADS, 0, st>>>(g);
    return 0;
  }
  const int am = stage_mode(g.a, g.sAz, g.sAm, g.sAk), bm = stage_mode(g.b, g.sBz, g.sBn, g.sBk);
#define FD_GEMM_CASE(A_, B_) \
  if (am == A_ && bm == B_) fd_gemm_mma<A_, B_><<<grid, THREADS, 0, st>>>(g);
  FD_GEMM_CASE(STAGE_SCALAR, STAGE_SCALAR)
  FD_GEMM_CASE(STAGE_SCALAR, STAGE_KFAST)
  FD_GEMM_CASE(STAGE_SCALAR, STAGE_ROWFAST)
  FD_GEMM_CASE(STAGE_KFAST, STAGE_SCALAR)
  FD_GEMM_CASE(STAGE_KFAST, STAGE_KFAST)
  FD_GEMM_CASE(STAGE_KFAST, STAGE_ROWFAST)
  FD_GEMM_CASE(STAGE_ROWFAST, STAGE_SCALAR)
  FD_GEMM_CASE(STAGE_ROWFAST, STAGE_KFAST)
  FD_GEMM_CASE(STAGE_ROWFAST, STAGE_ROWFAST)
#undef FD_GEMM_CASE
  return 0;
}

inline unsigned blocks_for(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }
// a null pointer (an absent operand) counts as aligned
inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

#define GRID_LOOP(i, n) \
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < (n); \
       i += (long long)gridDim.x * blockDim.x)

// out[e] = round(x[e % nx] + y[e % ny]): n elements of one dtype, x or y
// repeated when shorter (a shared base, a positional encoding)
__global__ void fd_add(const void* x, long long nx, const void* y, long long ny, void* out,
                       long long n, int bf) {
  GRID_LOOP(i, n) stv(out, i, ldv(x, i % nx, bf) + ldv(y, i % ny, bf), bf);
}

// one warp per row of C <= 1024: LN(round(x + res)), float32 statistics;
// x's row is row % xrows (a shared base read by every prompt's rows)
__global__ void fd_layernorm(const void* x, const void* res, void* out, const float* w,
                             const float* b, long long rows, int C, long long xs, long long os,
                             int bf, int gelu, float eps, long long xrows) {
  const long long row = blockIdx.x * (long long)(THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long xo = (row % xrows) * xs;
  float v[32];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int c = lane + 32 * j;
    v[j] = 0.f;
    if (c < C) {
      float t = ldv(x, xo + c, bf);
      if (res) t = rnd(t + ldv(res, row * xs + c, bf), bf);
      v[j] = t;
      s += t;
    }
  }
  const float mu = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j)
    if (lane + 32 * j < C) q += (v[j] - mu) * (v[j] - mu);
  const float inv = rsqrtf(warp_sum(q) / C + eps);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int c = lane + 32 * j;
    if (c < C) {
      float y = (v[j] - mu) * inv * w[c] + b[c];
      if (gelu) y = gelu_tanh(rnd(y, bf));
      stv(out, row * os + c, y, bf);
    }
  }
}

}  // namespace
