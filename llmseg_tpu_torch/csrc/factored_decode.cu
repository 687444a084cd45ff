// Kernel G: the factored shared-base SAM decode.
//
// Replaces llmseg_tpu/ops/twoway_kernel.py::_decode_kernel_factored
// (launched by factored_decode_fused, the AMG default): per prompt, the
// depth-2 two-way transformer with the keys state kept as
// rho (x) (base sigma) + A^T B, the closed-form norm4, the final attention,
// the IoU head, the hypernetwork MLPs and the upscale in the permuted
// column layout, giving mask columns (P, L, 16*nt) and IoU (P, 1, nt).
//
// What bounds it on an H100: at sam_vit_h's decoder (64 prompts a chunk,
// 7 tokens, L = 4096, C = 256) the work is about 2 GFLOP a prompt of
// rank-width and shared-matrix products (norm4's sigma_bbar base^T and
// gram A, the scores and attends against the shared G / PE matrices, the
// upscale's A^T (B W1) and conv2), against some 34 MB of bf16 mask output:
// operations.  A prompt's rank state A (up to 128 x 4096) does not fit a
// block's shared memory, and one block per prompt would fill half the
// SMs, so the TPU kernel's one-program-per-prompt design does not carry
// over.  Instead every step runs over all prompts of the chunk at once, as
// a sequence of launches of the kernels below (a strided batched GEMM with
// fused epilogues, softmaxes, LayerNorms, norm4's closed form and small
// layout ops), with the scratch between steps allocated by the wrapper.
// The host side receives the whole sequence (twoway_kernel.Program) in one
// call and launches it on the caller's stream; the wrapper records the
// sequence once per image and replays it for every chunk.  The GEMM reads
// any strides; bf16 operands run on mma.sync m16n8k16 (64 x 64 tiles,
// float32 accumulation) with 16-byte cp.async staging where the strides
// allow it, float32 ones on a SIMT tile.  wgmma tiles, split-K for the
// products over L, and fusing the steps so that the float32 scores and the
// rank state are read fewer times, are the next steps.
#include "common.cuh"

using namespace llmseg;

namespace {

constexpr int N_INTS = 24, N_PTRS = 12, N_FLOATS = 4;
enum Op {
  OP_GEMM, OP_ADD, OP_LAYERNORM, OP_SOFTMAX_ROWS, OP_SOFTMAX_COLS, OP_BD, OP_HEAD_EXTRACT,
  OP_COLSCALE_ROUND, OP_CAST, OP_SETROWS, OP_BPREP, OP_NORM4, OP_HBD
};
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
// of 16 rows x 32 columns, k-tiles of 32 double-buffered in shared memory.
// How an operand is staged depends on its strides (STAGE_*): with the k
// index contiguous it is copied by 16-byte cp.async into [row][k] rows,
// read by ldmatrix as the attention kernels read q and k; with the row
// index (m of A, n of B) contiguous it is copied the same way into [k][row]
// rows and read by ldmatrix.trans, as they read v; any other strides (or a
// misaligned base) take element-wise loads into [row][k].  The vector
// copies zero-fill a chunk past the edge of the matrix, so neither M, N nor
// K need be a multiple of 8.
constexpr int MK = 32, MLD = MK + 8, TLD = GM + 8;
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
  __shared__ __align__(16) bf16 sA[2][STAGE_ELEMS];
  __shared__ __align__(16) bf16 sB[2][STAGE_ELEMS];
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
  stage(0, 0);
  for (long long k0 = 0, it = 0; k0 < g.K; k0 += MK, ++it) {
    const int buf = (int)(it & 1);
    if (k0 + MK < g.K) {
      stage(buf ^ 1, k0 + MK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
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
    __syncthreads();
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

int launch_gemm(const long long* I, void* const* P, const float* Fv, cudaStream_t st) {
  GemmArgs g;
  g.Z = I[0]; g.M = I[1]; g.N = I[2]; g.K = I[3];
  g.sAz = I[4]; g.sAm = I[5]; g.sAk = I[6];
  g.sBz = I[7]; g.sBk = I[8]; g.sBn = I[9];
  g.sCz = I[10]; g.sCm = I[11]; g.sCn = I[12];
  g.abf = (int)I[13]; g.bbf = (int)I[14]; g.cbf = (int)I[15]; g.flags = (int)I[16];
  g.csz = I[17]; g.raz = I[18]; g.act = (int)I[19];
  g.a = P[0]; g.b = P[1]; g.c = P[2];
  g.cin = (const float*)P[3]; g.colscale = (const float*)P[4];
  g.rowadd = (const float*)P[5]; g.bias = (const float*)P[6];
  g.alpha = Fv[0];
  g.emat = P[7]; g.sEm = I[20]; g.ebf = (int)I[21];
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

// ---------------------------------------------------------------------------
// Elementwise, row and column kernels
// ---------------------------------------------------------------------------

inline unsigned blocks_for(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }
// a null pointer (an absent operand) counts as aligned
inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

#define GRID_LOOP(i, n) \
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < (n); \
       i += (long long)gridDim.x * blockDim.x)

__global__ void fd_add(const void* x, const void* y, void* out, long long n, int bf) {
  GRID_LOOP(i, n) stv(out, i, ldv(x, i, bf) + ldv(y, i, bf), bf);
}

// one warp per row of C <= 1024: LN(round(x + res)), float32 statistics
__global__ void fd_layernorm(const void* x, const void* res, void* out, const float* w,
                                 const float* b, long long rows, int C, long long xs,
                                 long long os, int bf, int gelu, float eps) {
  const long long row = blockIdx.x * (long long)(THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float v[32];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int c = lane + 32 * j;
    v[j] = 0.f;
    if (c < C) {
      float t = ldv(x, row * xs + c, bf);
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

// the same for rows of C = 8 * LPR (<= 256) elements with 16-byte aligned
// rows: LPR lanes per row, 8 elements a lane in one (bf16) or two
// (float32) vector loads, 32 / LPR rows a warp
template <int LPR>
__global__ void fd_layernorm_vec(const void* x, const void* res, void* out, const float* w,
                                 const float* b, long long rows, long long xs, long long os,
                                 int bf, int gelu, float eps) {
  constexpr int C = 8 * LPR, RPW = 32 / LPR;
  const int lane = threadIdx.x & 31, sub = lane % LPR, c0 = 8 * sub;
  const long long row = (blockIdx.x * (long long)(THREADS / 32) + threadIdx.x / 32) * RPW +
                        lane / LPR;
  const bool ok = row < rows;
  float v[8];
  auto load8 = [&](const void* p, long long off, float (&d)[8]) {
    if (bf) {
      const uint4 u = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(p) + off);
      const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i) d[i] = __bfloat162float(h[i]);
    } else {
      const float4* f = reinterpret_cast<const float4*>(static_cast<const float*>(p) + off);
      const float4 lo = f[0], hi = f[1];
      d[0] = lo.x; d[1] = lo.y; d[2] = lo.z; d[3] = lo.w;
      d[4] = hi.x; d[5] = hi.y; d[6] = hi.z; d[7] = hi.w;
    }
  };
  float s = 0.f;
  if (ok) {
    load8(x, row * xs + c0, v);
    if (res) {
      float r[8];
      load8(res, row * xs + c0, r);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = rnd(v[i] + r[i], bf);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) s += v[i];
  }
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mu = s / C;
  float q = 0.f;
  if (ok) {
#pragma unroll
    for (int i = 0; i < 8; ++i) q += (v[i] - mu) * (v[i] - mu);
  }
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
  if (!ok) return;
  const float inv = rsqrtf(q / C + eps);
  float y[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    y[i] = (v[i] - mu) * inv * w[c0 + i] + b[c0 + i];
    if (gelu) y[i] = gelu_tanh(rnd(y[i], bf));
  }
  if (bf) {
    uint4 u;
    bf16* h = reinterpret_cast<bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16(y[i]);
    *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + row * os + c0) = u;
  } else {
    float4* f = reinterpret_cast<float4*>(static_cast<float*>(out) + row * os + c0);
    f[0] = make_float4(y[0], y[1], y[2], y[3]);
    f[1] = make_float4(y[4], y[5], y[6], y[7]);
  }
}

// one block per row: out = softmax(x), rowsum = sum of the float32 probabilities
__global__ void fd_softmax_rows(const float* x, void* out, float* rowsum, int n, int bf) {
  __shared__ float red[THREADS / 32];
  const long long r = blockIdx.x;
  const float* xr = x + r * n;
  float mx = -3.0e38f;
  for (int i = threadIdx.x; i < n; i += THREADS) mx = fmaxf(mx, xr[i]);
  mx = block_max(mx, red);
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += THREADS) s += expf(xr[i] - mx);
  s = block_sum(s, red);
  float ps = 0.f;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const float p = expf(xr[i] - mx) / s;
    ps += p;
    stv(out, r * n + i, p, bf);
  }
  if (rowsum) {
    ps = block_sum(ps, red);
    if (threadIdx.x == 0) rowsum[r] = ps;
  }
}

// x (Z, H, N, L): softmax over the N tokens of each head, per column l
__global__ void fd_softmax_cols(const float* x, void* out, long long Z, int H, int N,
                                    long long L, long long oz, int bf) {
  GRID_LOOP(i, Z * H * L) {
    const long long l = i % L, zh = i / L, z = zh / H, h = zh % H;
    const float* xc = x + zh * N * L + l;
    float mx = -3.0e38f, s = 0.f;
    for (int t = 0; t < N; ++t) mx = fmaxf(mx, xc[t * L]);
    for (int t = 0; t < N; ++t) s += expf(xc[t * L] - mx);
    for (int t = 0; t < N; ++t)
      stv(out, z * oz + (h * N + t) * L + l, expf(xc[t * L] - mx) / s, bf);
  }
}

__global__ void fd_bd(const void* x, void* out, long long Z, int T, int I, int nh, int bf,
                          float scale) {
  const int hd = I / nh;
  GRID_LOOP(e, Z * nh * T * I) {
    const int i = (int)(e % I);
    const long long zr = e / I;
    const int r = (int)(zr % (nh * T));
    const long long z = zr / (nh * T);
    float v = 0.f;
    if (i / hd == r / T) {
      v = ldv(x, (z * T + r % T) * I + i, bf);
      if (scale != 0.f) v *= scale;
    }
    stv(out, e, v, bf);
  }
}

__global__ void fd_head_extract(const float* o, void* out, long long Z, int T, int I,
                                    int nh, int bf) {
  const int hd = I / nh;
  GRID_LOOP(e, Z * T * I) {
    const int i = (int)(e % I), t = (int)((e / I) % T);
    const long long z = e / ((long long)T * I);
    stv(out, e, o[(z * nh * T + (i / hd) * T + t) * I + i], bf);
  }
}

__global__ void fd_colscale_round(const float* x, const float* v, void* out, long long Z,
                                      long long M, long long L, int bf) {
  GRID_LOOP(e, Z * M * L) stv(out, e, x[e] * v[(e / (M * L)) * L + e % L], bf);
}

__global__ void fd_cast(const float* x, void* out, long long n, int bf) {
  GRID_LOOP(e, n) stv(out, e, x[e], bf);
}

__global__ void fd_setrows(void* buf, const float* vec, long long Z, long long zs,
                               long long n, long long nrows, int bf, float value) {
  GRID_LOOP(e, Z * nrows * n) {
    const long long j = e % n, r = (e / n) % nrows, z = e / (n * nrows);
    stv(buf, z * zs + r * n + j, vec ? vec[j] : value, bf);
  }
}

// block (r, z): Bbar row r -> sig row, bmean, Bnew row; rows R, R+1 <- scale, bias
__global__ void fd_bprep(void* bbar, void* sig, float* bmean, const float* sigma,
                             const float* scale, const float* bias, long long zs, int R, int C,
                             int bf) {
  __shared__ float red[THREADS / 32];
  const int r = blockIdx.x;
  const long long z = blockIdx.y;
  const long long row = z * zs + (long long)r * C;
  if (r >= R) {
    const float* src = r == R ? scale : bias;
    for (int c = threadIdx.x; c < C; c += THREADS) stv(bbar, row + c, src[c], bf);
    return;
  }
  float s = 0.f;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const float v = ldv(bbar, row + c, bf);
    s += v;
    stv(sig, (z * R + r) * C + c, v * sigma[c], bf);
    stv(bbar, row + c, v * scale[c], bf);
  }
  s = block_sum(s, red);
  if (threadIdx.x == 0) bmean[z * R + r] = s / C;
}

// one thread per column (z, l) of the rank state: norm4 in closed form
__global__ void fd_norm4(const float* x1, const float* x2, void* abuf, const float* bmean,
                             float* rho, const float* m, const float* q, long long Z,
                             long long zs, int R, long long L, int C, int bf, float eps) {
  GRID_LOOP(e, Z * L) {
    const long long z = e / L, l = e % L;
    const long long a0 = z * zs + l;
    float mp = 0.f, cr = 0.f, qd = 0.f;
    for (int r = 0; r < R; ++r) {
      const float a = ldv(abuf, a0 + r * L, bf);
      const long long xi = (z * R + r) * L + l;
      mp += bmean[z * R + r] * a;
      cr += x1[xi] * a;
      qd += x2[xi] * a;
    }
    const float rh = rho[e];
    const float mu = rh * m[l] + mp;
    const float e2 = rh * rh * q[l] + (2.f * (rh * cr) + qd) / C;
    const float inv = rsqrtf(e2 - mu * mu + eps);
    const float inv_r = rnd(inv, bf);
    for (int r = 0; r < R; ++r) stv(abuf, a0 + r * L, ldv(abuf, a0 + r * L, bf) * inv_r, bf);
    stv(abuf, a0 + (long long)R * L, -inv * mu, bf);
    stv(abuf, a0 + (long long)(R + 1) * L, 1.f, bf);
    rho[e] = rh * inv;
  }
}

__global__ void fd_hbd(const void* hyper, void* out, long long Z, int nt, int co2, int bf) {
  const int W = 4 * co2;
  GRID_LOOP(e, Z * 4 * nt * W) {
    const int c = (int)(e % W), r = (int)((e / W) % (4 * nt));
    const long long z = e / ((long long)4 * nt * W);
    const float v = r / nt == c / co2 ? ldv(hyper, (z * nt + r % nt) * co2 + c % co2, bf) : 0.f;
    stv(out, e, v, bf);
  }
}

int run_op(int op, const long long* I, void* const* P, const float* Fv, cudaStream_t st) {
  switch (op) {
    case OP_GEMM:
      return launch_gemm(I, P, Fv, st);
    case OP_ADD:
      fd_add<<<blocks_for(I[0]), THREADS, 0, st>>>(P[0], P[1], P[2], I[0], (int)I[1]);
      return 0;
    case OP_LAYERNORM: {
      const long long rows = I[0], C = I[1];
      if (C > 1024) return (int)cudaErrorInvalidValue;
      const bool vec = (C == 64 || C == 128 || C == 256) && I[2] % 8 == 0 && I[3] % 8 == 0 &&
                       aligned16(P[0]) && aligned16(P[1]) && aligned16(P[4]);
      if (vec) {
        const long long per_block = (THREADS / 32) * (32 / (C / 8));
        const unsigned grid = (unsigned)((rows + per_block - 1) / per_block);
#define FD_LN_VEC(LPR)                                                                       \
  fd_layernorm_vec<LPR><<<grid, THREADS, 0, st>>>(P[0], P[4], P[1], (const float*)P[2],      \
                                                  (const float*)P[3], rows, I[2], I[3],      \
                                                  (int)I[4], (int)I[5], Fv[0]);
        if (C == 64) FD_LN_VEC(8)
        if (C == 128) FD_LN_VEC(16)
        if (C == 256) FD_LN_VEC(32)
#undef FD_LN_VEC
        return 0;
      }
      fd_layernorm<<<(unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32)), THREADS, 0, st>>>(
          P[0], P[4], P[1], (const float*)P[2], (const float*)P[3], rows, (int)C, I[2], I[3],
          (int)I[4], (int)I[5], Fv[0]);
      return 0;
    }
    case OP_SOFTMAX_ROWS:
      fd_softmax_rows<<<(unsigned)I[0], THREADS, 0, st>>>((const float*)P[0], P[1],
                                                             (float*)P[2], (int)I[1], (int)I[2]);
      return 0;
    case OP_SOFTMAX_COLS:
      fd_softmax_cols<<<blocks_for(I[0] * I[1] * I[3]), THREADS, 0, st>>>(
          (const float*)P[0], P[1], I[0], (int)I[1], (int)I[2], I[3], I[4], (int)I[5]);
      return 0;
    case OP_BD:
      fd_bd<<<blocks_for(I[0] * I[3] * I[1] * I[2]), THREADS, 0, st>>>(
          P[0], P[1], I[0], (int)I[1], (int)I[2], (int)I[3], (int)I[4], Fv[0]);
      return 0;
    case OP_HEAD_EXTRACT:
      fd_head_extract<<<blocks_for(I[0] * I[1] * I[2]), THREADS, 0, st>>>(
          (const float*)P[0], P[1], I[0], (int)I[1], (int)I[2], (int)I[3], (int)I[4]);
      return 0;
    case OP_COLSCALE_ROUND:
      fd_colscale_round<<<blocks_for(I[0] * I[1] * I[2]), THREADS, 0, st>>>(
          (const float*)P[0], (const float*)P[1], P[2], I[0], I[1], I[2], (int)I[3]);
      return 0;
    case OP_CAST:
      fd_cast<<<blocks_for(I[0]), THREADS, 0, st>>>((const float*)P[0], P[1], I[0],
                                                        (int)I[1]);
      return 0;
    case OP_SETROWS:
      fd_setrows<<<blocks_for(I[0] * I[4] * I[2]), THREADS, 0, st>>>(
          P[0], (const float*)P[1], I[0], I[1], I[2], I[4], (int)I[5], Fv[0]);
      return 0;
    case OP_BPREP: {
      dim3 grid((unsigned)(I[2] + 2), (unsigned)I[0]);
      fd_bprep<<<grid, THREADS, 0, st>>>(P[0], P[1], (float*)P[2], (const float*)P[3],
                                             (const float*)P[4], (const float*)P[5], I[1],
                                             (int)I[2], (int)I[3], (int)I[4]);
      return 0;
    }
    case OP_NORM4:
      fd_norm4<<<blocks_for(I[0] * I[3]), THREADS, 0, st>>>(
          (const float*)P[0], (const float*)P[1], P[2], (const float*)P[3], (float*)P[4],
          (const float*)P[5], (const float*)P[6], I[0], I[1], (int)I[2], I[3], (int)I[4],
          (int)I[5], Fv[0]);
      return 0;
    case OP_HBD:
      fd_hbd<<<blocks_for(I[0] * 16 * I[1] * I[2]), THREADS, 0, st>>>(
          P[0], P[1], I[0], (int)I[1], (int)I[2], (int)I[3]);
      return 0;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Run n recorded operations in order on the caller's stream: ops (n),
// ints (n, 24), ptrs (n, 12), floats (n, 4), as twoway_kernel.Program.pack
// lays them out.  Returns the first launch error (cudaError_t), or 0.
extern "C" int factored_decode(int n, const void* ops_, const void* ints_, const void* ptrs_,
                               const void* floats_, void* stream) {
  const int* ops = static_cast<const int*>(ops_);
  const long long* ints = static_cast<const long long*>(ints_);
  void* const* ptrs = static_cast<void* const*>(ptrs_);
  const float* floats = static_cast<const float*>(floats_);
  cudaStream_t st = (cudaStream_t)stream;
  for (int i = 0; i < n; ++i) {
    int e = run_op(ops[i], ints + (size_t)i * N_INTS, ptrs + (size_t)i * N_PTRS,
                   floats + (size_t)i * N_FLOATS, st);
    if (e == 0) e = (int)cudaGetLastError();
    if (e != 0) return e;
  }
  return 0;
}

extern "C" const char* factored_decode_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
