// Kernels H and I: the materialised SAM two-way decode.
//
// Kernel I replaces llmseg_tpu/ops/twoway_kernel.py::_kernel (launched by
// fused_twoway_apply): per prompt, the depth-2 two-way transformer and its
// final token-to-image attention, giving queries (P, N, C) and keys
// (P, L, C).  Kernel H replaces ::_decode_kernel (launched by
// fused_decode_apply): the same transformer, then the IoU head, the
// hypernetwork MLPs and the upscale (conv-transpose 1 as a matmul, a
// LayerNorm over each 64-wide group, tanh-GELU, conv-transpose 2, tanh-GELU,
// the product with the hypernetwork outputs), giving low-res mask logits
// (P, nt, 4S, 4S) and IoU (P, nt).  Shared mode (one base (1, S, S, C) for
// P > 1 prompts): layer 0 reads the base for every prompt; it is never
// broadcast.
//
// What bounds it on an H100: at sam_vit_h's decoder (L = 4096 image tokens,
// C = 256, cross-attention width 128, 8 heads, MLP 2048) a prompt's keys
// state is 2 MB of bf16 and the TPU kernel keeps it and the weights in
// VMEM; a Hopper block has 227 KB of shared memory, so here the keys state
// lives in device memory and each step runs over all prompts of the call.
// The TPU kernel projects the keys to k, v and q over every image token
// (about 3.5 GFLOP a prompt); folded into the token side (below) the sweeps
// over L cost about 2 x 256 x 8 N operations a token and attention, so
// what bounds a call is the passes over the keys state (134 MB at 64
// prompts: 0.04 ms a pass) and, at few prompts, where the state sits in L2,
// the launches and the token side.
//
// One C call (twoway_fused below, one launch of H or I) runs a recorded
// sequence (twoway_kernel.tw_program, replayed from a plan cached for the
// weights and shapes) through the record interpreter of records.cuh, which
// kernel G shares.  Two routes, by dtype:
//   * bf16: the three parts that sweep over L are fused kernels on wgmma and
//     TMA (twoway_sweeps.cuh): token-to-image attention with the k and v
//     projections folded into the token side (OP_TW_T2I), image-to-token
//     attention with the q and out projections folded in and norm4, row
//     local (OP_TW_I2T_NORM4), and the upscale from the keys (OP_TW_UPSCALE);
//     the token side, (P, N <= 16, 256), runs on the shared records.
//   * float32: the projections over P L rows on the strided GEMM of
//     batched_gemm.cuh (its SIMT tile: no float32 wgmma exists), and the
//     scalar kernels below, each computing per head what the TPU kernel
//     computes with block-diagonal tricks:
//       tw_attn_tokens the token self attention (8 heads of 32; the bf16
//                      route runs it too);
//       tw_attn_image  tokens attending to the L image keys, one block per
//                      (prompt, head): a sweep for the softmax maxima and
//                      sums, a second for the probabilities (rounded to the
//                      input type, as the TPU kernel casts them) times v;
//       tw_attn_rows   image rows attending to the N tokens, one thread per
//                      (prompt, row, head);
//       tw_masks       the hypernetwork product, written straight into the
//                      unpermuted (P, nt, 4S, 4S) layout.
#include "records.cuh"
#include "twoway_sweeps.cuh"

namespace {

constexpr int HD = 16;        // head dim of the cross attentions
constexpr int QROWS = 8;      // prompt tokens per block of tw_attn_image
constexpr int NMAX = 16;      // most prompt tokens a call takes
constexpr int MAX_CO2 = 32;   // widest hypernetwork output
constexpr float NEG = -3.0e38f;

__device__ __forceinline__ void load16(const void* p, long long off, int bf, float (&d)[HD]) {
  if (bf) {
    const uint4* u = reinterpret_cast<const uint4*>(static_cast<const bf16*>(p) + off);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const uint4 x = u[c];
      const bf16* h = reinterpret_cast<const bf16*>(&x);
#pragma unroll
      for (int i = 0; i < 8; ++i) d[8 * c + i] = __bfloat162float(h[i]);
    }
  } else {
    const float4* f = reinterpret_cast<const float4*>(static_cast<const float*>(p) + off);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 x = f[c];
      d[4 * c] = x.x; d[4 * c + 1] = x.y; d[4 * c + 2] = x.z; d[4 * c + 3] = x.w;
    }
  }
}

__device__ __forceinline__ void store16(void* p, long long off, int bf, const float (&d)[HD]) {
  if (bf) {
    uint4* u = reinterpret_cast<uint4*>(static_cast<bf16*>(p) + off);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      uint4 x;
      bf16* h = reinterpret_cast<bf16*>(&x);
#pragma unroll
      for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16(d[8 * c + i]);
      u[c] = x;
    }
  } else {
    float4* f = reinterpret_cast<float4*>(static_cast<float*>(p) + off);
#pragma unroll
    for (int c = 0; c < 4; ++c) f[c] = make_float4(d[4 * c], d[4 * c + 1], d[4 * c + 2], d[4 * c + 3]);
  }
}

// (m, s) <- the running maximum and sum of exp(x - m) over both parts
__device__ __forceinline__ void merge_ms(float& m, float& s, float m2, float s2) {
  const float M = fmaxf(m, m2);
  s = s * expf(m - M) + s2 * expf(m2 - M);
  m = M;
}

// Attention among the prompt tokens (Tk <= NMAX, any head dim), one thread
// per output (prompt, token, channel), which computes its row's scores:
// s_j = sum_d round(q_d * scale) k_jd in float32, p = softmax(s) rounded to
// the input type, out = round(sum_j p_j v_j).  q (P, Tq, I), k and v
// (P, Tk, I), out like q.
__global__ void tw_attn_tokens(const void* qh, const void* kh, const void* vh, void* out,
                               long long P, int Tq, int Tk, int I, int nh, float scale, int bf) {
  const int hd = I / nh;
  GRID_LOOP(e, P * Tq * I) {
    const int i = (int)(e % I), t = (int)((e / I) % Tq);
    const long long p = e / ((long long)I * Tq);
    const int c0 = (i / hd) * hd;
    const long long qo = (p * Tq + t) * I + c0;
    float s[NMAX];
    float m = NEG;
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
      s[j] = NEG;
      if (j < Tk) {
        const long long ko = (p * Tk + j) * I + c0;
        float x = 0.f;
        for (int d = 0; d < hd; ++d) x = fmaf(rnd(ldv(qh, qo + d, bf) * scale, bf), ldv(kh, ko + d, bf), x);
        s[j] = x;
        m = fmaxf(m, x);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NMAX; ++j)
      if (j < Tk) sum += expf(s[j] - m);
    float o = 0.f;
#pragma unroll
    for (int j = 0; j < NMAX; ++j)
      if (j < Tk) o = fmaf(rnd(expf(s[j] - m) / sum, bf), ldv(vh, (p * Tk + j) * I + i, bf), o);
    stv(out, e, o, bf);
  }
}

// Up to QROWS prompt tokens (rows t0.. of blockIdx.z) attending to Tk image
// keys, head dim HD, one block per (head, prompt): q (P, Tq, I); k and v
// (Z, Tk, I) with z stride kz (0 when every prompt reads the same keys);
// out (P, Tq, I).  Scores as tw_attn_tokens; the softmax over the keys takes
// two sweeps: the maxima and sums (online, merged over the block), then the
// probabilities (rounded to the input type) times v, summed over the block.
__global__ void __launch_bounds__(THREADS)
tw_attn_image(const void* qh, const void* kh, const void* vh, void* out, int Tq, long long Tk,
              int I, long long kz, float scale, int bf) {
  constexpr int NW = THREADS / 32;
  __shared__ float sq[QROWS][HD];
  __shared__ float wm[NW][QROWS], ws[NW][QROWS];
  __shared__ float wo[NW][QROWS * HD];
  const int h = blockIdx.x, t0 = blockIdx.z * QROWS;
  const long long p = blockIdx.y;
  const int nq = min(QROWS, Tq - t0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  if (tid < QROWS * HD) {
    const int t = tid / HD, d = tid % HD;
    sq[t][d] = t < nq ? rnd(ldv(qh, (p * Tq + t0 + t) * I + h * HD + d, bf) * scale, bf) : 0.f;
  }
  __syncthreads();
  const long long kb = p * kz + h * HD;

  float m[QROWS], s[QROWS];
#pragma unroll
  for (int t = 0; t < QROWS; ++t) m[t] = NEG, s[t] = 0.f;
  for (long long l = tid; l < Tk; l += THREADS) {
    float k[HD];
    load16(kh, kb + l * I, bf, k);
#pragma unroll
    for (int t = 0; t < QROWS; ++t) {
      float x = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) x = fmaf(sq[t][d], k[d], x);
      if (x > m[t]) {
        s[t] = s[t] * expf(m[t] - x) + 1.f;
        m[t] = x;
      } else {
        s[t] += expf(x - m[t]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < QROWS; ++t) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[t], o);
      const float s2 = __shfl_xor_sync(0xffffffffu, s[t], o);
      merge_ms(m[t], s[t], m2, s2);
    }
    if (lane == 0) wm[warp][t] = m[t], ws[warp][t] = s[t];
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < QROWS; ++t) {
    float M = NEG, S = 0.f;
    for (int w = 0; w < NW; ++w) merge_ms(M, S, wm[w][t], ws[w][t]);
    m[t] = M, s[t] = S;
  }

  float acc[QROWS][HD];
#pragma unroll
  for (int t = 0; t < QROWS; ++t)
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[t][d] = 0.f;
  for (long long l = tid; l < Tk; l += THREADS) {
    float k[HD], v[HD];
    load16(kh, kb + l * I, bf, k);
    load16(vh, kb + l * I, bf, v);
#pragma unroll
    for (int t = 0; t < QROWS; ++t) {
      float x = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) x = fmaf(sq[t][d], k[d], x);
      const float pr = rnd(expf(x - m[t]) / s[t], bf);
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[t][d] = fmaf(pr, v[d], acc[t][d]);
    }
  }
#pragma unroll
  for (int t = 0; t < QROWS; ++t)
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      const float x = warp_sum(acc[t][d]);
      if (lane == 0) wo[warp][t * HD + d] = x;
    }
  __syncthreads();
  if (tid < nq * HD) {
    float x = 0.f;
    for (int w = 0; w < NW; ++w) x += wo[w][tid];
    const int t = tid / HD, d = tid % HD;
    stv(out, (p * Tq + t0 + t) * I + h * HD + d, x, bf);
  }
}

// Image rows attending to Tk <= NMAX prompt tokens, one thread per (prompt,
// row, head), head dim HD: q (Z, L, I) with z stride qz (0: shared by every
// prompt); k, v (P, Tk, I); out (P, L, I).  s_j = q . round(k_j * scale) in
// float32, p = softmax over the tokens rounded to the input type, out =
// round(sum_j p_j v_j).
__global__ void tw_attn_rows(const void* q, long long qz, const void* k, const void* v,
                             void* out, long long P, long long L, int Tk, int I, int nh,
                             float scale, int bf) {
  GRID_LOOP(e, P * L * nh) {
    const int h = (int)(e % nh);
    const long long pl = e / nh, p = pl / L, l = pl % L;
    float qv[HD];
    load16(q, p * qz + l * I + h * HD, bf, qv);
    float s[NMAX];
    float m = NEG;
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
      s[j] = NEG;
      if (j < Tk) {
        const long long ko = (p * Tk + j) * I + h * HD;
        float x = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) x = fmaf(qv[d], rnd(ldv(k, ko + d, bf) * scale, bf), x);
        s[j] = x;
        m = fmaxf(m, x);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NMAX; ++j)
      if (j < Tk) sum += expf(s[j] - m);
    float o[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] = 0.f;
#pragma unroll
    for (int j = 0; j < NMAX; ++j)
      if (j < Tk) {
        const float pr = rnd(expf(s[j] - m) / sum, bf);
        const long long vo = (p * Tk + j) * I + h * HD;
#pragma unroll
        for (int d = 0; d < HD; ++d) o[d] = fmaf(pr, ldv(v, vo + d, bf), o[d]);
      }
    store16(out, pl * I + h * HD, bf, o);
  }
}

// The hypernetwork product in the final mask layout.  z2 (P, L, 4, 4*co2):
// the upscale after conv2, per low-res pixel l = i * Ws + j and group g1 =
// (di1, dj1) of conv1, columns (g2 = (di2, dj2), c); hyper (P, nt, co2).
// masks[p][t][4i + 2 di1 + di2][4j + 2 dj1 + dj2] = round(sum_c
// z2[p][l][g1][g2 * co2 + c] hyper[p][t][c]), one thread per (p, l, g1).
__global__ void tw_masks(const void* z2, const void* hyper, void* masks, long long P, int Hs,
                         int Ws, int nt, int co2, int bf) {
  const long long L = (long long)Hs * Ws;
  GRID_LOOP(e, P * L * 4) {
    const int g1 = (int)(e % 4);
    const long long pl = e / 4, p = pl / L;
    const int l = (int)(pl % L), i = l / Ws, j = l % Ws;
    const long long zo = e * 4 * co2;
    for (int g2 = 0; g2 < 4; ++g2) {
      float zr[MAX_CO2];
#pragma unroll
      for (int c = 0; c < MAX_CO2; ++c) zr[c] = c < co2 ? ldv(z2, zo + g2 * co2 + c, bf) : 0.f;
      const long long row = 4 * i + 2 * (g1 >> 1) + (g2 >> 1);
      const long long col = 4 * j + 2 * (g1 & 1) + (g2 & 1);
      for (int t = 0; t < nt; ++t) {
        const long long ho = (p * nt + t) * co2;
        float x = 0.f;
#pragma unroll
        for (int c = 0; c < MAX_CO2; ++c)
          if (c < co2) x = fmaf(zr[c], ldv(hyper, ho + c, bf), x);
        stv(masks, ((p * nt + t) * 4 * Hs + row) * 4 * Ws + col, x, bf);
      }
    }
  }
}

// a record of kernel H or I: its own kinds, or a shared one
int run_op(int op, const long long* I, void* const* P, const float* Fv, cudaStream_t st) {
  switch (op) {
    case OP_TW_ATTN_TOKENS:   // ints P, Tq, Tk, I, nh, bf; pointers q, k, v, out; floats scale
      if (I[2] > NMAX) return (int)cudaErrorInvalidValue;
      tw_attn_tokens<<<blocks_for(I[0] * I[1] * I[3]), THREADS, 0, st>>>(
          P[0], P[1], P[2], P[3], I[0], (int)I[1], (int)I[2], (int)I[3], (int)I[4], Fv[0],
          (int)I[5]);
      return 0;
    case OP_TW_ATTN_IMAGE: {  // ints P, Tq, Tk, I, nh, kz, bf; pointers q, k, v, out; floats scale
      if (I[3] != HD * I[4] || I[1] > NMAX) return (int)cudaErrorInvalidValue;
      const dim3 grid((unsigned)I[4], (unsigned)I[0], (unsigned)((I[1] + QROWS - 1) / QROWS));
      tw_attn_image<<<grid, THREADS, 0, st>>>(P[0], P[1], P[2], P[3], (int)I[1], I[2], (int)I[3],
                                              I[5], Fv[0], (int)I[6]);
      return 0;
    }
    case OP_TW_ATTN_ROWS:     // ints P, L, Tk, I, nh, qz, bf; pointers q, k, v, out; floats scale
      if (I[3] != HD * I[4] || I[2] > NMAX) return (int)cudaErrorInvalidValue;
      tw_attn_rows<<<blocks_for(I[0] * I[1] * I[4]), THREADS, 0, st>>>(
          P[0], I[5], P[1], P[2], P[3], I[0], I[1], (int)I[2], (int)I[3], (int)I[4], Fv[0],
          (int)I[6]);
      return 0;
    case OP_TW_MASKS:         // ints P, Hs, Ws, nt, co2, bf; pointers z2, hyper, masks
      if (I[4] > MAX_CO2) return (int)cudaErrorInvalidValue;
      tw_masks<<<blocks_for(I[0] * I[1] * I[2] * 4), THREADS, 0, st>>>(
          P[0], P[1], P[2], I[0], (int)I[1], (int)I[2], (int)I[3], (int)I[4], (int)I[5]);
      return 0;
    case OP_TW_T2I:
      return llmseg::fused::tw_t2i_run(I, P, st);
    case OP_TW_I2T_NORM4:
      return llmseg::fused::tw_i2t_norm4_run(I, P, Fv, st);
    case OP_TW_UPSCALE:
      return llmseg::fused::tw_upscale_run(I, P, Fv, st);
    default:
      return run_common_op(op, I, P, Fv, st);
  }
}

}  // namespace

static int failed_record = -1;

// Kernel H or I (one source, two counters): n records in order on the
// caller's stream, laid out as twoway_kernel.Program.pack lays them out.
// Returns the first launch error (cudaError_t), or 0;
// twoway_fused_failed_record then gives that record's index.
extern "C" int twoway_fused(int n, const void* ops, const void* ints, const void* ptrs,
                            const void* floats, void* stream) {
  return run_records(n, ops, ints, ptrs, floats, (cudaStream_t)stream, run_op, &failed_record);
}

extern "C" int twoway_fused_failed_record() { return failed_record; }

extern "C" const char* twoway_fused_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
