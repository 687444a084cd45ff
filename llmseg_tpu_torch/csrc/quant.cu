// Kernels Q1 and Q2: the W8A8 prologue and epilogue around LLaMA's int8
// products (the port's own kernels, not ports of a Pallas kernel).
//
// Replace XLA code of llmseg_tpu/ops/quant.py:
//   Q1 quantize_rows   quantize_activation with k = 0 (quant.py:138-165) and
//                      rms_quantize_activation (quant.py:168-191): per-row
//                      int8 values and a float32 scale of a (R, C) bf16 or
//                      float32 row block;
//   Q2 w8a8_epilogue   the rescale of qdense_act (quant.py:194-213): the
//                      int32 product (R, N) times the row scale, then the
//                      column scale, plus an optional float32 side term,
//                      rounded once to the output type, then the bias added
//                      in the output type.
// The s8 x s8 -> s32 product between them is torch._int_mm.
//
// What bounds them on an H100: bytes.  Both do a handful of operations an
// element; at LLaMA-7B's batch 4 (3068 rows) Q1 reads 2 bytes and writes 1
// an element, Q2 reads 4 and writes 2, about 2.0 and 7.5 ms of HBM traffic
// a step over 32 layers.  In plain PyTorch each is several passes (casts,
// two multiplies, a division, a cast), each a full read and write.
//
// What the design does: one pass each.  Q1 gives a row to a CTA of 256
// threads, which reads it once in 16-byte vectors into shared memory (a
// 4096 or 11008-wide bf16 row is 8 or 22 KB) while it reduces max|x*gamma|
// (and the sum of x^2 in the RMS form), then quantizes the staged row and
// writes it in vectors.  Q2 gives each thread four columns of one row:
// one 16-byte load of the accumulators, one 8-byte (bf16) store.
//
// Rounding follows the JAX functions exactly, since the int8 values are
// compared for equality: built without --use_fast_math; the divisions and
// products are the IEEE-rounded intrinsics (__fdiv_rn, __fmul_rn, so that
// nvcc cannot contract them into an FMA); rintf rounds half to even, as
// jnp.round and torch.round do; the plain form divides by the scale and the
// RMS form multiplies by 127 / max, as their JAX functions do.
#include "common.cuh"

using namespace llmseg;

namespace {

constexpr int Q1_THREADS = 256;
constexpr int Q2_THREADS = 256;
constexpr int F32 = 0, BF16 = 1;  // dtype codes of the wrapper

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ int8_t q8(float v) {
  return (int8_t)fminf(fmaxf(rintf(v), -127.f), 127.f);
}

// max and sum over the CTA; every thread gets both
__device__ __forceinline__ void block_max_sum(float& mx, float& sm) {
  __shared__ float red[2][Q1_THREADS / 32];
  mx = warp_max(mx);
  sm = warp_sum(sm);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[0][warp] = mx;
    red[1][warp] = sm;
  }
  __syncthreads();
  mx = lane < Q1_THREADS / 32 ? red[0][lane] : 0.f;
  sm = lane < Q1_THREADS / 32 ? red[1][lane] : 0.f;
  mx = warp_max(mx);
  sm = warp_sum(sm);
}

// Q1: one CTA a row.  G is gamma's type (RMS form only).  VEC elements a
// 16-byte vector when the row allows it, else 1.
template <typename T, typename G, bool RMS, int VEC>
__global__ void __launch_bounds__(Q1_THREADS)
    quantize_rows_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
                         int8_t* __restrict__ xq, float* __restrict__ sc, int R, int C,
                         float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* row = reinterpret_cast<T*>(smem);
  for (int r = blockIdx.x; r < R; r += gridDim.x) {
    const T* xr = x + (size_t)r * C;
    const int nv = C / VEC;
    float amax = 0.f, ss = 0.f;
    for (int v = threadIdx.x; v < nv; v += Q1_THREADS) {
      T e[VEC];
      if constexpr (VEC > 1) {
        const uint4 u = reinterpret_cast<const uint4*>(xr)[v];
        reinterpret_cast<uint4*>(row)[v] = u;
        memcpy(e, &u, sizeof(u));
      } else {
        e[0] = xr[v];
        row[v] = e[0];
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xf = to_f(e[j]);
        if constexpr (RMS) {
          amax = fmaxf(amax, fabsf(__fmul_rn(xf, to_f(gamma[v * VEC + j]))));
          ss = __fmaf_rn(xf, xf, ss);
        } else {
          amax = fmaxf(amax, fabsf(xf));
        }
      }
    }
    block_max_sum(amax, ss);
    const float m = fmaxf(amax, 1e-6f);
    // plain: sc = m / 127, xq = round(x / sc); RMS: xq = round(t * (127 / m))
    const float s_plain = __fdiv_rn(m, 127.f);
    const float inv = __fdiv_rn(127.f, m);
    if (threadIdx.x == 0) {
      if constexpr (RMS) {
        const float ms = __fdiv_rn(ss, (float)C);
        const float rs = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(ms, eps)));
        sc[r] = __fmul_rn(__fmul_rn(m, rs), 1.f / 127.f);
      } else {
        sc[r] = s_plain;
      }
    }
    int8_t* qr = xq + (size_t)r * C;
    for (int v = threadIdx.x; v < nv; v += Q1_THREADS) {
      int8_t q[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xf = to_f(row[v * VEC + j]);
        if constexpr (RMS)
          q[j] = q8(__fmul_rn(__fmul_rn(xf, to_f(gamma[v * VEC + j])), inv));
        else
          q[j] = q8(__fdiv_rn(xf, s_plain));
      }
      if constexpr (VEC == 8) {
        uint2 u;
        memcpy(&u, q, sizeof(u));
        *reinterpret_cast<uint2*>(qr + v * VEC) = u;
      } else if constexpr (VEC == 4) {
        uint32_t u;
        memcpy(&u, q, sizeof(u));
        *reinterpret_cast<uint32_t*>(qr + v * VEC) = u;
      } else {
        qr[v] = q[0];
      }
    }
    __syncthreads();  // the staged row is rewritten by the next one
  }
}

// Q2: thread i of a row's CTAs takes columns 4i..4i+3 (VEC = 4), or one
// column when N is not a multiple of 4.
template <typename O, int VEC>
__global__ void __launch_bounds__(Q2_THREADS)
    w8a8_epilogue_kernel(const int32_t* __restrict__ acc, const float* __restrict__ sc,
                         const float* __restrict__ ws, const O* __restrict__ bias,
                         const float* __restrict__ side, O* __restrict__ out, int R, int N) {
  const int v = blockIdx.x * Q2_THREADS + threadIdx.x;
  if (v * VEC >= N) return;
  const int c0 = v * VEC;
  for (int r = blockIdx.y; r < R; r += gridDim.y) {
    const size_t base = (size_t)r * N + c0;
    int32_t a[VEC];
    if constexpr (VEC == 4) {
      const int4 u = *reinterpret_cast<const int4*>(acc + base);
      a[0] = u.x, a[1] = u.y, a[2] = u.z, a[3] = u.w;
    } else {
      a[0] = acc[base];
    }
    const float s = sc[r];
    O o[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float y = __fmul_rn(__fmul_rn(__int2float_rn(a[j]), s), ws[c0 + j]);
      if (side) y = __fadd_rn(y, side[base + j]);
      o[j] = from_f<O>(y);
      if (bias) o[j] = from_f<O>(__fadd_rn(to_f(o[j]), to_f(bias[c0 + j])));
    }
    if constexpr (VEC == 4 && sizeof(O) == 2) {
      uint2 u;
      memcpy(&u, o, sizeof(u));
      *reinterpret_cast<uint2*>(out + base) = u;
    } else if constexpr (VEC == 4) {
      float4 u;
      memcpy(&u, o, sizeof(u));
      *reinterpret_cast<float4*>(out + base) = u;
    } else {
      out[base] = o[0];
    }
  }
}

template <typename T, typename G, bool RMS>
int launch_q1(const void* x, const void* gamma, void* xq, void* sc, int R, int C, float eps,
              cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = C % VEC == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(xq) & 15) == 0;
  const size_t smem = ((size_t)C * sizeof(T) + 15) / 16 * 16;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int grid = R < 65535 * 8 ? R : 65535 * 8;
  auto kern = vec ? quantize_rows_kernel<T, G, RMS, VEC> : quantize_rows_kernel<T, G, RMS, 1>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, Q1_THREADS, smem, st>>>((const T*)x, (const G*)gamma, (int8_t*)xq, (float*)sc, R,
                                       C, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_q1_gamma(const void* x, const void* gamma, int gamma_dtype, void* xq, void* sc, int R,
                  int C, float eps, cudaStream_t st) {
  if (!gamma) return launch_q1<T, float, false>(x, nullptr, xq, sc, R, C, eps, st);
  if (gamma_dtype == BF16) return launch_q1<T, bf16, true>(x, gamma, xq, sc, R, C, eps, st);
  return launch_q1<T, float, true>(x, gamma, xq, sc, R, C, eps, st);
}

template <typename O>
int launch_q2(const void* acc, const void* sc, const void* ws, const void* bias,
              const void* side, void* out, int R, int N, cudaStream_t st) {
  const bool vec = N % 4 == 0 && (reinterpret_cast<uintptr_t>(acc) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0 &&
                   (!side || (reinterpret_cast<uintptr_t>(side) & 15) == 0);
  const int per_cta = Q2_THREADS * (vec ? 4 : 1);
  const dim3 grid((N + per_cta - 1) / per_cta, R < 65535 ? R : 65535);
  auto kern = vec ? w8a8_epilogue_kernel<O, 4> : w8a8_epilogue_kernel<O, 1>;
  kern<<<grid, Q2_THREADS, 0, st>>>((const int32_t*)acc, (const float*)sc, (const float*)ws,
                                    (const O*)bias, (const float*)side, (O*)out, R, N);
  return (int)cudaGetLastError();
}

}  // namespace

// op 0, Q1: p0 x (R, C) of dtype `in_dtype`, p1 gamma (C,) of `aux_dtype`
//   or null (the plain form), o0 xq (R, C) int8, o1 sc (R,) float32.
// op 1, Q2: p0 acc (R, C) int32, p1 sc (R,), p2 w_scale (C,) float32, p3
//   bias (C,) of `in_dtype` or null, p4 side (R, C) float32 or null, o0 the
//   output (R, C) of `in_dtype`.
extern "C" int quant(int op, const void* p0, const void* p1, const void* p2, const void* p3,
                     const void* p4, void* o0, void* o1, int R, int C, int in_dtype,
                     int aux_dtype, float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (R <= 0 || C <= 0) return (int)cudaErrorInvalidValue;  // the wrapper launches none
  if (op == 0 && in_dtype == BF16)
    return launch_q1_gamma<bf16>(p0, p1, aux_dtype, o0, o1, R, C, eps, st);
  if (op == 0 && in_dtype == F32)
    return launch_q1_gamma<float>(p0, p1, aux_dtype, o0, o1, R, C, eps, st);
  if (op == 1 && in_dtype == BF16) return launch_q2<bf16>(p0, p1, p2, p3, p4, o0, R, C, st);
  if (op == 1 && in_dtype == F32) return launch_q2<float>(p0, p1, p2, p3, p4, o0, R, C, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* quant_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }
