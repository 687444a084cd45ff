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
// On one process the product and Q2's rescale are one kernel,
// w8a8_gemm.cu (w8a8_linear): the s8 x s8 -> s32 product on wgmma with the
// rescale applied to its accumulators in registers.  On a mesh with tp
// above 1 the row-split products (o, down) see a K block of their input,
// and the row scale and the int32 sums must cover the whole K, so Q1 runs
// in two forms with a MAX over tp between them:
//   Q1 (a) row_absmax      the rows' max |x| (op 2), written unquantized;
//   Q1 (b) quantize_scaled the int8 values for the caller's row scale
//                          (op 3): xq = clip(round(x / sc)), the plain
//                          form's division;
// then w8a8_gemm.cu's int32 output, an int32 sum over tp, and the
// standalone Q2 rescale here (op 1).  After torch._int_mm the standalone
// rescale is also the yardstick that chip_smoke.py times beside Q2.
//
// What bounds them on an H100: bytes.  Both do a handful of operations an
// element; at LLaMA-7B's batch 4 (3068 rows) Q1 reads 2 bytes and writes 1
// an element, about 2.0 ms of HBM traffic a step over 32 layers.
//
// What the design does.  Q1's RMS form (LLaMA-7B's q/k/v and gate/up
// inputs, 4096 wide) is a persistent pass for rows of up to 1024 vectors of
// 16 bytes (8192 bf16 values): a grid of as many 256-thread CTAs as the
// card holds at once walks the rows, W warps a row (W = 4 at 4096-wide
// bf16 rows), 8 / W rows in flight a CTA.  Each lane holds its 4 vectors
// of the row in registers: every byte of x is read from HBM once, nothing
// is staged in shared memory, and a row's max and sum of squares are
// reduced by shuffles, then across the row's warps by one shared-memory
// exchange under a named barrier.  Each lane loads its gamma vectors once
// and keeps them in registers for all of its rows.  The plain form (the o
// and down inputs, 4096 and 11008 wide), wider rows and rows that are not
// a whole number of 16-byte vectors take one 256-thread CTA a row, staged
// in shared memory: the plain form divides every element by the scale
// (an IEEE division), and with the more warps in flight that one CTA a
// row gives it ran faster than on the persistent pass at both widths
// (scripts/kernel_variants.py).  Q2's standalone rescale gives each thread
// four columns of one row: one 16-byte load of the accumulators, one
// 8-byte (bf16) store.
//
// Rounding follows the JAX functions exactly, since the int8 values are
// compared for equality: built without --use_fast_math; the divisions and
// products are the IEEE-rounded intrinsics (__fdiv_rn, __fmul_rn, so that
// nvcc cannot contract them into an FMA); rintf rounds half to even, as
// jnp.round and torch.round do; the plain form divides by the scale and the
// RMS form multiplies by 127 / max, as their JAX functions do.  The RMS
// form's int8 values depend only on the row's max and on gamma; its sum of
// squares is taken in another order than the plain version's, which moves
// the scale by ulps at most.
#include "common.cuh"

using namespace llmseg;

namespace {

constexpr int Q1_THREADS = 256;
constexpr int Q1P_WARPS = 8;        // warps a CTA of the persistent pass
constexpr int Q1P_NV = 4;           // 16-byte vectors of a row a lane holds
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

// A row's scale and the factor of its int8 values, from its max |x| (|x *
// gamma| in the RMS form) and, in the RMS form, its sum of x^2.  Plain:
// sc = m / 127 and xq = round(x / sc) (`div`); RMS: sc = m rsqrt(mean x^2 +
// eps) / 127 and xq = round(t * (127 / m)) (`mul`).
template <bool RMS>
__device__ __forceinline__ float row_scale(float amax, float ss, int C, float eps, float& div,
                                           float& mul) {
  const float m = fmaxf(amax, 1e-6f);
  div = __fdiv_rn(m, 127.f);
  mul = __fdiv_rn(127.f, m);
  if constexpr (!RMS) return div;
  const float ms = __fdiv_rn(ss, (float)C);
  const float rs = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(ms, eps)));
  return __fmul_rn(__fmul_rn(m, rs), 1.f / 127.f);
}

template <typename T, typename G, bool RMS>
__device__ __forceinline__ int8_t quantize(T x, G gamma, float div, float mul) {
  if constexpr (RMS) return q8(__fmul_rn(__fmul_rn(to_f(x), to_f(gamma)), mul));
  return q8(__fdiv_rn(to_f(x), div));
}

// Q1's plain form, and rows that the RMS form's persistent pass does not
// take: one CTA a row, staged in shared memory.  G is gamma's type (RMS
// form only).  VEC elements a 16-byte vector when the row allows it, else
// 1.
template <typename T, typename G, bool RMS, int VEC>
__global__ void __launch_bounds__(Q1_THREADS)
    quantize_rows_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
                         int8_t* __restrict__ xq, float* __restrict__ sc, int R, int C,
                         float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* row = reinterpret_cast<T*>(smem);
  const int nv = C / VEC;
  for (int r = blockIdx.x; r < R; r += gridDim.x) {
    const T* xr = x + (size_t)r * C;
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
    float div, mul;
    const float s = row_scale<RMS>(amax, ss, C, eps, div, mul);
    if (threadIdx.x == 0) sc[r] = s;
    int8_t* qr = xq + (size_t)r * C;
    for (int v = threadIdx.x; v < nv; v += Q1_THREADS) {
      int8_t q[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        q[j] = quantize<T, G, RMS>(row[v * VEC + j], RMS ? gamma[v * VEC + j] : G(), div, mul);
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

// `bytes` bytes (8, 16 or 32, 16-byte aligned above 8) from global memory
template <int BYTES>
__device__ __forceinline__ void load_bytes(void* dst, const void* src) {
  if constexpr (BYTES == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
    memcpy(dst, &u, 8);
  } else {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(src) + i);
      memcpy(reinterpret_cast<char*>(dst) + 16 * i, &u, 16);
    }
  }
}

// Q1's RMS form as a persistent pass: W warps a row, 8 / W rows a CTA at
// once, the grid walking the rows.  Lane l of the row's warp w holds the
// row's vectors v = 32 W i + 32 w + l, i < Q1P_NV (those below C / VEC),
// and gamma's at the same places.
template <typename T, typename G>
__global__ void __launch_bounds__(32 * Q1P_WARPS, 1)
    quantize_rows_rms(const T* __restrict__ x, const G* __restrict__ gamma,
                      int8_t* __restrict__ xq, float* __restrict__ sc, int R, int C, int W,
                      float eps) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float red[2][Q1P_WARPS][2];  // a row's partial max and sum, by parity
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = Q1P_WARPS / W, grp = warp / W, wr = warp - grp * W;
  const int nv = C / VEC, v0 = 32 * wr + lane, vstep = 32 * W;
  G gv[Q1P_NV][VEC];  // this lane's gamma, for all of its rows
#pragma unroll
  for (int i = 0; i < Q1P_NV; ++i)
    if (v0 + i * vstep < nv)
      load_bytes<(int)(VEC * sizeof(G))>(gv[i], gamma + (size_t)(v0 + i * vstep) * VEC);
  int it = 0;
  for (int r = blockIdx.x * groups + grp; r < R; r += gridDim.x * groups, ++it) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)r * C);
    uint4 xv[Q1P_NV];
#pragma unroll
    for (int i = 0; i < Q1P_NV; ++i)
      if (v0 + i * vstep < nv) xv[i] = __ldcs(xr + v0 + i * vstep);  // read once
    float amax = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < Q1P_NV; ++i) {
      if (v0 + i * vstep >= nv) continue;
      T e[VEC];
      memcpy(e, &xv[i], sizeof(e));
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xf = to_f(e[j]);
        amax = fmaxf(amax, fabsf(__fmul_rn(xf, to_f(gv[i][j]))));
        ss = __fmaf_rn(xf, xf, ss);
      }
    }
    // the butterfly leaves the same bits in every lane
    amax = warp_max(amax);
    ss = warp_sum(ss);
    if (W > 1) {
      float(*part)[2] = red[it & 1] + grp * W;
      if (lane == 0) {
        part[wr][0] = amax;
        part[wr][1] = ss;
      }
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(32 * W) : "memory");
      amax = part[0][0];
      ss = part[0][1];
      for (int w = 1; w < W; ++w) {  // in a fixed order
        amax = fmaxf(amax, part[w][0]);
        ss += part[w][1];
      }
    }
    float div, mul;
    const float s = row_scale<true>(amax, ss, C, eps, div, mul);
    if (wr == 0 && lane == 0) sc[r] = s;
    int8_t* qr = xq + (size_t)r * C;
#pragma unroll
    for (int i = 0; i < Q1P_NV; ++i) {
      const int v = v0 + i * vstep;
      if (v >= nv) continue;
      T e[VEC];
      memcpy(e, &xv[i], sizeof(e));
      int8_t q[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) q[j] = quantize<T, G, true>(e[j], gv[i][j], div, mul);
      if constexpr (VEC == 8) {
        uint2 u;
        memcpy(&u, q, sizeof(u));
        *reinterpret_cast<uint2*>(qr + v * VEC) = u;
      } else {
        uint32_t u;
        memcpy(&u, q, sizeof(u));
        *reinterpret_cast<uint32_t*>(qr + v * VEC) = u;
      }
    }
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

// Q1 (a): one CTA a row, the row's max |x| reduced as in the plain form.
template <typename T, int VEC>
__global__ void __launch_bounds__(Q1_THREADS)
    row_absmax_kernel(const T* __restrict__ x, float* __restrict__ amax, int R, int C) {
  const int nv = C / VEC;
  for (int r = blockIdx.x; r < R; r += gridDim.x) {
    const T* xr = x + (size_t)r * C;
    float m = 0.f, unused = 0.f;
    for (int v = threadIdx.x; v < nv; v += Q1_THREADS) {
      T e[VEC];
      if constexpr (VEC > 1) {
        const uint4 u = __ldcs(reinterpret_cast<const uint4*>(xr) + v);  // read once
        memcpy(e, &u, sizeof(u));
      } else {
        e[0] = xr[v];
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) m = fmaxf(m, fabsf(to_f(e[j])));
    }
    block_max_sum(m, unused);
    if (threadIdx.x == 0) amax[r] = m;
    __syncthreads();  // the reduction's shared memory is reused by the next row
  }
}

// Q1 (b): thread i of a row's CTAs takes its VEC elements i VEC.. (a 16-byte
// vector, or one element when the row is not a whole number of them)
template <typename T, int VEC>
__global__ void __launch_bounds__(Q1_THREADS)
    quantize_scaled_kernel(const T* __restrict__ x, const float* __restrict__ sc,
                           int8_t* __restrict__ xq, int R, int C) {
  const int v = blockIdx.x * Q1_THREADS + threadIdx.x;
  if (v * VEC >= C) return;
  for (int r = blockIdx.y; r < R; r += gridDim.y) {
    const size_t base = (size_t)r * C + (size_t)v * VEC;
    const float s = __ldg(sc + r);
    T e[VEC];
    if constexpr (VEC > 1) {
      const uint4 u = __ldcs(reinterpret_cast<const uint4*>(x + base));
      memcpy(e, &u, sizeof(u));
    } else {
      e[0] = x[base];
    }
    int8_t q[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) q[j] = q8(__fdiv_rn(to_f(e[j]), s));
    if constexpr (VEC == 8) {
      uint2 u;
      memcpy(&u, q, sizeof(u));
      *reinterpret_cast<uint2*>(xq + base) = u;
    } else if constexpr (VEC == 4) {
      uint32_t u;
      memcpy(&u, q, sizeof(u));
      *reinterpret_cast<uint32_t*>(xq + base) = u;
    } else {
      xq[base] = q[0];
    }
  }
}

template <typename T>
int launch_absmax(const void* x, void* amax, int R, int C, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = C % VEC == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int grid = R < 65535 * 8 ? R : 65535 * 8;
  auto kern = vec ? row_absmax_kernel<T, VEC> : row_absmax_kernel<T, 1>;
  kern<<<grid, Q1_THREADS, 0, st>>>((const T*)x, (float*)amax, R, C);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scaled(const void* x, const void* sc, void* xq, int R, int C, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = C % VEC == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(xq) & 15) == 0;
  const int per_cta = Q1_THREADS * (vec ? VEC : 1);
  const dim3 grid((C + per_cta - 1) / per_cta, R < 65535 ? R : 65535);
  auto kern = vec ? quantize_scaled_kernel<T, VEC> : quantize_scaled_kernel<T, 1>;
  kern<<<grid, Q1_THREADS, 0, st>>>((const T*)x, (const float*)sc, (int8_t*)xq, R, C);
  return (int)cudaGetLastError();
}

// The CTAs of kern the card holds at once; or -cudaError_t
template <typename K>
int resident_ctas(K kern, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, 0);
  if (e != cudaSuccess) return -(int)e;
  return per_sm < 1 ? -(int)cudaErrorInvalidConfiguration : sms * per_sm;
}

template <typename T, typename G, bool RMS>
int launch_q1(const void* x, const void* gamma, void* xq, void* sc, int R, int C, float eps,
              cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const int nv = C / VEC;
  int W = 1;  // the fewest warps a row whose registers hold it
  while (W < Q1P_WARPS && nv > 32 * W * Q1P_NV) W *= 2;
  const bool vec = C % VEC == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(xq) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(gamma) & 15) == 0;
  if (RMS && vec && nv <= 32 * W * Q1P_NV) {
    auto kern = quantize_rows_rms<T, G>;
    static const int ctas = resident_ctas(kern, 32 * Q1P_WARPS);  // the same at every launch
    if (ctas < 0) return -ctas;
    const int groups = Q1P_WARPS / W, need = (R + groups - 1) / groups;
    kern<<<need < ctas ? need : ctas, 32 * Q1P_WARPS, 0, st>>>(
        (const T*)x, (const G*)gamma, (int8_t*)xq, (float*)sc, R, C, W, eps);
    return (int)cudaGetLastError();
  }
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
// op 2, Q1 (a): p0 x (R, C) of `in_dtype`, o1 the rows' max |x| (R,) float32.
// op 3, Q1 (b): p0 x (R, C) of `in_dtype`, p1 sc (R,) float32, o0 xq (R, C)
//   int8.
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
  if (op == 2 && in_dtype == BF16) return launch_absmax<bf16>(p0, o1, R, C, st);
  if (op == 2 && in_dtype == F32) return launch_absmax<float>(p0, o1, R, C, st);
  if (op == 3 && in_dtype == BF16) return launch_scaled<bf16>(p0, p1, o0, R, C, st);
  if (op == 3 && in_dtype == F32) return launch_scaled<float>(p0, p1, o0, R, C, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* quant_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }
