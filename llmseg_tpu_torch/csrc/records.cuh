// The record interpreter of the recorded decodes, kernels G
// (factored_decode.cu) and H and I (twoway_fused.cu): each source's C call
// runs a sequence of records (twoway_kernel.Program.pack: an op code, 24
// ints, 12 pointers and 4 floats a record) in order on the caller's stream.
// This header holds the op codes of both and the record kinds they share:
// the strided batched GEMM of batched_gemm.cuh, rounded adds, LayerNorms,
// softmaxes and the small layout ops; each source adds its own kinds
// (run_records' run_op) and launches nothing else.
#pragma once

#include "batched_gemm.cuh"

namespace {

constexpr int N_INTS = 24, N_PTRS = 12, N_FLOATS = 4;
// twoway_kernel.py's OP_* in the same order
enum Op {
  // shared
  OP_GEMM, OP_ADD, OP_LAYERNORM, OP_SOFTMAX_ROWS, OP_SOFTMAX_COLS, OP_BD, OP_HEAD_EXTRACT,
  OP_COLSCALE_ROUND, OP_CAST, OP_SETROWS, OP_BPREP, OP_NORM4, OP_HBD,
  // kernel G's fused kernels (factored_fused.cuh)
  OP_T2I, OP_I2T, OP_NORM4_FUSED, OP_UPSCALE,
  // kernels H and I: the float32 route's kernels (twoway_fused.cu), the
  // bf16 route's fused sweeps over L (twoway_sweeps.cuh)
  OP_TW_ATTN_TOKENS, OP_TW_ATTN_IMAGE, OP_TW_ATTN_ROWS, OP_TW_MASKS,
  OP_TW_T2I, OP_TW_I2T_NORM4, OP_TW_UPSCALE
};

// an OP_GEMM record -> GemmArgs (batched_gemm.cuh)
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
  return gemm_launch(g, st);
}

// ---------------------------------------------------------------------------
// Elementwise, row and column kernels
// ---------------------------------------------------------------------------

// fd_layernorm (batched_gemm.cuh) for rows of C = 8 * LPR (<= 256)
// elements with 16-byte aligned rows: LPR lanes per row, 8 elements a lane in one (bf16) or two
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

// a record of a shared kind; cudaErrorInvalidValue for any other op
int run_common_op(int op, const long long* I, void* const* P, const float* Fv, cudaStream_t st) {
  switch (op) {
    case OP_GEMM:
      return launch_gemm(I, P, Fv, st);
    case OP_ADD:
      fd_add<<<blocks_for(I[0]), THREADS, 0, st>>>(P[0], I[0], P[1], I[2] ? I[2] : I[0], P[2],
                                                   I[0], (int)I[1]);
      return 0;
    case OP_LAYERNORM: {
      const long long rows = I[0], C = I[1];
      if (C > 1024) return (int)cudaErrorInvalidValue;
      const long long xrows = I[6] ? I[6] : rows;   // x's rows, read modulo xrows
      const bool vec = xrows == rows && (C == 64 || C == 128 || C == 256) && I[2] % 8 == 0 &&
                       I[3] % 8 == 0 &&
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
          (int)I[4], (int)I[5], Fv[0], xrows);
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

// Run n records in order on stream st: ops (n), ints (n, 24), ptrs (n, 12),
// floats (n, 4), as twoway_kernel.Program.pack lays them out; run_op(op,
// ints, ptrs, floats, st) launches one.  Returns the first launch error
// (cudaError_t), or 0, with *failed the index of the record that failed.
template <typename RunOp>
int run_records(int n, const void* ops_, const void* ints_, const void* ptrs_,
                const void* floats_, cudaStream_t st, RunOp run_op, int* failed) {
  const int* ops = static_cast<const int*>(ops_);
  const long long* ints = static_cast<const long long*>(ints_);
  void* const* ptrs = static_cast<void* const*>(ptrs_);
  const float* floats = static_cast<const float*>(floats_);
  for (int i = 0; i < n; ++i) {
    int e = run_op(ops[i], ints + (size_t)i * N_INTS, ptrs + (size_t)i * N_PTRS,
                   floats + (size_t)i * N_FLOATS, st);
    if (e == 0) e = (int)cudaGetLastError();
    if (e != 0) {
      *failed = i;
      return e;
    }
  }
  return 0;
}

}  // namespace
