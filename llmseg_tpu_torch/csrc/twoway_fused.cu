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
// P > 1 prompts): layer 0's keys-side projections are computed once, from
// the base, and read by every prompt; the base is never broadcast.
//
// What bounds it on an H100: at sam_vit_h's decoder (L = 4096 image tokens,
// C = 256, cross-attention width 128, 8 heads, MLP 2048) a prompt costs
// about 3.5 GFLOP of keys-side products (the k/v/q projections of three
// cross attentions, the out projections, conv1 and conv2) against about
// 2.6 MB of bf16 keys and masks: operations.  The TPU kernel keeps one
// prompt's keys state (2 MB) and the weights in VMEM; a Hopper block has
// 227 KB of shared memory, so here the keys state lives in device memory
// and each step runs over all prompts of the call: a fixed host-side
// sequence (run below, one C call, one launch of H or I) of the strided
// GEMM of batched_gemm.cuh (mma.sync bf16 tiles, float32 accumulation,
// bias / ReLU / GELU epilogues, rounding where the TPU kernel rounds), its
// rounded add (keys + pe, queries + pe) and residual LayerNorm (a shared
// base read by row modulo L, not broadcast), and four kernels of this
// file, each computing per head what the TPU kernel computes with
// block-diagonal tricks:
//   tw_attn_tokens the token self attention (8 heads of 32);
//   tw_attn_image  tokens attending to the L image keys, one block per
//                  (prompt, head): a sweep for the softmax maxima and sums,
//                  a second for the probabilities (rounded to the input
//                  type, as the TPU kernel casts them) times v;
//   tw_attn_rows   image rows attending to the N tokens, one thread per
//                  (prompt, row, head);
//   tw_masks       the hypernetwork product, written straight into the
//                  unpermuted (P, nt, 4S, 4S) layout.
// wgmma tiles, fusing the projections into the attention sweeps and the
// out projection with norm4 are the next steps.
#include "batched_gemm.cuh"

#include <vector>

namespace {

constexpr int HD = 16;        // head dim of the cross attentions
constexpr int QROWS = 8;      // prompt tokens per block of tw_attn_image
constexpr int NMAX = 16;      // most prompt tokens a call takes
constexpr int MAX_STACK = 8;  // most layers of an IoU / hypernetwork MLP
constexpr int MAX_NT = 8;     // most mask tokens
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

// ---------------------------------------------------------------------------
// The host-side sequence
// ---------------------------------------------------------------------------

struct Lin {  // y = x w^T + b: w (out, in) in the input type, b float32
  const void* w;
  const float* b;
  int in, out;
};
struct Norm {
  const float *w, *b;
};
struct AttnW {
  Lin q, k, v, out;
};
struct LayerW {
  AttnW sa;
  Norm n1;
  AttnW t2i;
  Norm n2;
  Lin fc1, fc2;
  Norm n3;
  AttnW i2t;
  Norm n4;
};
struct Stack {
  int n;
  Lin l[MAX_STACK];
};

// reads the dims and pointers in the order twoway_kernel._TwOperands
// appends them
struct Reader {
  const long long* d;
  void* const* p;
  int nd, np, id = 0, ip = 0;
  bool bad = false;
  long long dim() {
    if (id >= nd) return bad = true, 0;
    return d[id++];
  }
  void* ptr() {
    if (ip >= np) return bad = true, nullptr;
    return p[ip++];
  }
  Lin lin() {
    Lin l;
    l.w = ptr();
    l.b = static_cast<const float*>(ptr());
    l.in = (int)dim();
    l.out = (int)dim();
    return l;
  }
  Norm norm() {
    Norm n;
    n.w = static_cast<const float*>(ptr());
    n.b = static_cast<const float*>(ptr());
    return n;
  }
  AttnW attn() {
    AttnW a;
    a.q = lin();
    a.k = lin();
    a.v = lin();
    a.out = lin();
    return a;
  }
  Stack stack() {
    Stack s;
    s.n = (int)dim();
    if (s.n < 1 || s.n > MAX_STACK) return bad = true, s;
    for (int i = 0; i < s.n; ++i) s.l[i] = lin();
    return s;
  }
};

struct Seq {
  cudaStream_t st;
  int bf, err = 0;
  float eps;

  char* at(const void* p, long long elems) const {
    return (char*)p + elems * (bf ? 2 : 4);
  }
  void done() {
    if (!err) err = (int)cudaGetLastError();
  }
  // c (M rows, row stride cs) = act(round(x (M rows, row stride xs) w^T + b))
  void dense(const Lin& l, const void* x, long long M, long long xs, void* c, long long cs,
             int act = ACT_NONE) {
    if (err) return;
    GemmArgs g{};
    g.a = x; g.b = l.w; g.c = c; g.bias = l.b;
    g.Z = 1; g.M = M; g.N = l.out; g.K = l.in;
    g.sAm = xs; g.sAk = 1;
    g.sBk = 1; g.sBn = l.in;
    g.sCm = cs; g.sCn = 1;
    g.abf = g.bbf = g.cbf = bf;
    g.flags = F_BIAS;
    g.act = act;
    g.alpha = 1.f;
    err = gemm_launch(g, st);
    done();
  }
  void dense(const Lin& l, const void* x, long long M, void* c, int act = ACT_NONE) {
    dense(l, x, M, l.in, c, l.out, act);
  }
  void add(const void* x, long long nx, const void* y, long long ny, void* out, long long n) {
    if (err) return;
    fd_add<<<blocks_for(n), THREADS, 0, st>>>(x, nx, y, ny, out, n, bf);
    done();
  }
  void layernorm(const Norm& w, const void* x, long long xrows, const void* res, void* out,
                 long long rows, int C, int gelu = 0) {
    if (err) return;
    fd_layernorm<<<(unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32)), THREADS, 0, st>>>(
        x, res, out, w.w, w.b, rows, C, C, C, bf, gelu, eps, xrows);
    done();
  }
  float scale(int hd) const {  // 1/sqrt(hd) in the input type, as q is scaled in it
    const float s = 1.f / sqrtf((float)hd);
    return bf ? __bfloat162float(__float2bfloat16(s)) : s;
  }
};

enum { MODE_TRANSFORMER = 0, MODE_DECODE = 1 };

int run(int mode, Reader& r, cudaStream_t stream) {
  const long long P = r.dim(), N = r.dim(), Hs = r.dim(), Ws = r.dim(), C = r.dim(),
                  nh = r.dim(), depth = r.dim(), Bi = r.dim(), bf = r.dim(), nt = r.dim();
  const void* keys_in = r.ptr();
  const void* pe = r.ptr();
  const void* tokens = r.ptr();
  void* out_a = r.ptr();  // queries (P, N, C) | masks (P, nt, 4Hs, 4Ws)
  void* out_b = r.ptr();  // keys (P, L, C)    | iou (P, nt)
  void* ws_keys = r.ptr();
  void* kpe = r.ptr();
  void* kh = r.ptr();
  void* vh = r.ptr();
  void* qi = r.ptr();
  void* oimg = r.ptr();
  void* tmp = r.ptr();
  void* Q = r.ptr();
  void* qin = r.ptr();
  void* tq = r.ptr();
  void* tk = r.ptr();
  void* tv = r.ptr();
  void* to = r.ptr();
  void* tatt = r.ptr();
  void* th = r.ptr();
  void *y1 = nullptr, *z = nullptr, *z2 = nullptr, *hyper = nullptr, *m0 = nullptr, *m1 = nullptr;
  if (mode == MODE_DECODE) {
    y1 = r.ptr(); z = r.ptr(); z2 = r.ptr(); hyper = r.ptr(); m0 = r.ptr(); m1 = r.ptr();
  }
  if (r.bad || depth < 1 || depth > 8 || N < 1 || N > NMAX || (Bi != 1 && Bi != P))
    return (int)cudaErrorInvalidValue;
  std::vector<LayerW> layers((size_t)depth);
  for (auto& w : layers) {
    w.sa = r.attn(); w.n1 = r.norm(); w.t2i = r.attn(); w.n2 = r.norm();
    w.fc1 = r.lin(); w.fc2 = r.lin(); w.n3 = r.norm(); w.i2t = r.attn(); w.n4 = r.norm();
  }
  const AttnW fa = r.attn();
  const Norm nf = r.norm();
  Lin conv1{}, conv2{};
  Norm ln{};
  Stack iou{};
  std::vector<Stack> hyp;
  if (mode == MODE_DECODE) {
    conv1 = r.lin(); ln = r.norm(); conv2 = r.lin(); iou = r.stack();
    if (nt < 1 || nt > MAX_NT) return (int)cudaErrorInvalidValue;
    for (int t = 0; t < nt; ++t) hyp.push_back(r.stack());
  }
  if (r.bad || r.id != r.nd || r.ip != r.np) return (int)cudaErrorInvalidValue;
  const int Ci = layers[0].t2i.q.out, Csa = layers[0].sa.q.out;
  if (Ci != HD * nh || fa.q.out != Ci || Csa % nh || C > 1024 || C % 8) return (int)cudaErrorInvalidValue;

  Seq s{stream, (int)bf, 0, 1e-6f};
  const long long L = Hs * Ws, PN = P * N;
  void* K = mode == MODE_TRANSFORMER ? out_b : ws_keys;
  void* q_final = mode == MODE_TRANSFORMER ? out_a : Q;
  const void* Kcur = keys_in;
  long long krows = Bi * L;  // rows of Kcur: L while a shared base is read
  const void* Qcur = tokens;
  const float sc = s.scale(HD), ssa = s.scale(Csa / (int)nh);
  const dim3 img_grid((unsigned)nh, (unsigned)P, (unsigned)((N + QROWS - 1) / QROWS));

  // tokens attending to image keys kh / vh (krows rows; a z stride of 0 when shared)
  auto attend_image = [&](const AttnW& a, long long rows) {
    s.dense(a.q, qin, PN, tq);
    if (s.err) return;
    tw_attn_image<<<img_grid, THREADS, 0, s.st>>>(tq, kh, vh, to, (int)N, L, Ci,
                                                  rows == L ? 0 : L * Ci, sc, s.bf);
    s.done();
    s.dense(a.out, to, PN, tatt);
  };

  for (long long i = 0; i < depth; ++i) {
    const LayerW& w = layers[(size_t)i];
    // token self attention; layer 0 without the positional add and residual
    const void* qsrc = Qcur;
    if (i > 0) {
      s.add(Qcur, PN * C, tokens, PN * C, qin, PN * C);
      qsrc = qin;
    }
    s.dense(w.sa.q, qsrc, PN, tq);
    s.dense(w.sa.k, qsrc, PN, tk);
    s.dense(w.sa.v, Qcur, PN, tv);
    if (s.err) return s.err;
    tw_attn_tokens<<<blocks_for(PN * Csa), THREADS, 0, s.st>>>(tq, tk, tv, to, P, (int)N, (int)N,
                                                              Csa, (int)nh, ssa, s.bf);
    s.done();
    s.dense(w.sa.out, to, PN, tatt);
    s.layernorm(w.n1, i == 0 ? tatt : Qcur, PN, i == 0 ? nullptr : tatt, Q, PN, (int)C);
    Qcur = Q;

    // token-to-image
    s.add(Qcur, PN * C, tokens, PN * C, qin, PN * C);
    s.add(Kcur, krows * C, pe, L * C, kpe, krows * C);
    s.dense(w.t2i.k, kpe, krows, kh);
    s.dense(w.t2i.v, Kcur, krows, vh);
    attend_image(w.t2i, krows);
    s.layernorm(w.n2, Qcur, PN, tatt, Q, PN, (int)C);

    // MLP
    s.dense(w.fc1, Qcur, PN, th, ACT_RELU);
    s.dense(w.fc2, th, PN, tatt);
    s.layernorm(w.n3, Qcur, PN, tatt, Q, PN, (int)C);

    // image-to-token, then norm4 on the keys
    s.add(Qcur, PN * C, tokens, PN * C, qin, PN * C);
    s.dense(w.i2t.k, qin, PN, tk);
    s.dense(w.i2t.v, Qcur, PN, tv);
    s.dense(w.i2t.q, kpe, krows, qi);
    if (s.err) return s.err;
    tw_attn_rows<<<blocks_for(P * L * nh), THREADS, 0, s.st>>>(
        qi, krows == L ? 0 : L * Ci, tk, tv, oimg, P, L, (int)N, Ci, (int)nh, sc, s.bf);
    s.done();
    s.dense(w.i2t.out, oimg, P * L, tmp);
    s.layernorm(w.n4, Kcur, krows, tmp, K, P * L, (int)C);
    Kcur = K;
    krows = P * L;
  }

  // the final token-to-image attention
  s.add(Qcur, PN * C, tokens, PN * C, qin, PN * C);
  s.add(Kcur, P * L * C, pe, L * C, kpe, P * L * C);
  s.dense(fa.k, kpe, P * L, kh);
  s.dense(fa.v, Kcur, P * L, vh);
  attend_image(fa, P * L);
  s.layernorm(nf, Qcur, PN, tatt, q_final, PN, (int)C);
  if (mode == MODE_TRANSFORMER || s.err) return s.err;

  // IoU head and hypernetwork MLPs, on rows 0 and 1 + t of every prompt's queries
  auto mlp_row = [&](const Stack& sk, long long row, void* out, long long os) {
    const void* x = s.at(Q, row * C);
    long long xs = N * C;
    for (int j = 0; j < sk.n; ++j) {
      const bool last = j == sk.n - 1;
      void* y = last ? out : (j & 1 ? m1 : m0);
      s.dense(sk.l[j], x, P, xs, y, last ? os : sk.l[j].out, last ? ACT_NONE : ACT_RELU);
      x = y;
      xs = sk.l[j].out;
    }
  };
  mlp_row(iou, 0, out_b, nt);
  const int co2 = hyp[0].l[hyp[0].n - 1].out;
  if (co2 > MAX_CO2 || conv2.out != 4 * co2 || conv1.out != 4 * conv2.in) return (int)cudaErrorInvalidValue;
  for (int t = 0; t < nt; ++t) mlp_row(hyp[(size_t)t], 1 + t, s.at(hyper, t * co2), nt * co2);

  // the upscale in the permuted layout, then the masks
  s.dense(conv1, Kcur, P * L, y1);
  s.layernorm(ln, y1, P * L * 4, nullptr, z, P * L * 4, conv2.in, 1);
  s.dense(conv2, z, P * L * 4, z2, ACT_GELU);
  if (s.err) return s.err;
  tw_masks<<<blocks_for(P * L * 4), THREADS, 0, s.st>>>(z2, hyper, out_a, P, (int)Hs, (int)Ws,
                                                        (int)nt, co2, s.bf);
  s.done();
  return s.err;
}

}  // namespace

// mode 0: kernel I (the transformer), mode 1: kernel H (the decode).  dims
// (n_dims int64) and ptrs (n_ptrs pointers) as twoway_kernel._TwOperands
// lays them out; every launch goes to the caller's stream.  Returns the
// first error (cudaError_t), or 0.
extern "C" int twoway_fused(int mode, int n_dims, const void* dims, int n_ptrs, const void* ptrs,
                            void* stream) {
  if (mode != MODE_TRANSFORMER && mode != MODE_DECODE) return (int)cudaErrorInvalidValue;
  Reader r{static_cast<const long long*>(dims), static_cast<void* const*>(ptrs), n_dims, n_ptrs};
  return run(mode, r, (cudaStream_t)stream);
}

extern "C" const char* twoway_fused_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
