// The MoE block's combine (the port's own kernel: the JAX package has no
// routed experts, so it replaces no TPU kernel).  It takes the place of the
// steps PyTorch ran between the routed experts' down product and the MoE
// block's output in models/deepseek_v3.py: index_copy_ back to pair order,
// a cast to float32, a broadcast multiply by the weights, a reduction over
// the k experts, the shared experts' cast and add, and the cast back.
//
// For each token t of N, with k chosen experts and width d:
//   out[t] = T( sum_{i = 0..k-1} float(y[inv[t k + i]]) * w[t, i] + float(shared[t]) )
// y (N k, d): the down products' rows in expert order; inv (N k,) int64:
// the row of y of pair (t, i), the inverse of the sort's order; w (N, k)
// float32; shared (N, d) or none; T is bf16 or float32, the type of y,
// shared and out.
//
// Rounding is ops/moe.py's combine_plain, bit for bit: each product and sum
// an IEEE-rounded intrinsic (__fmul_rn, __fadd_rn) so that nvcc cannot
// contract them into an FMA (built without --use_fast_math), summed in
// order i = 0..k-1 starting from the first product, the shared row added
// last, one rounding to T (round to nearest even, as torch's cast).
//
// What bounds it on an H100: bytes.  At Kimi-VL-A3B's MoE layer (9,204
// tokens, k = 6, d = 2,048, bf16) it reads y once (226 MB), the shared rows
// and writes the output (38 MB each): 0.30 GB, 0.090 ms at 3.35 TB/s.
//
// What the design does.  One thread owns 16 bytes of one output row (8
// bf16 or 4 float32 columns); the threads of a token are neighbours, so
// each of the k row reads and the shared read is a coalesced 16-byte load a
// thread.  A thread starts all k row loads and the shared one before it
// accumulates: k x 16 bytes in flight a thread, no shared-memory staging,
// no atomics.  k is a template argument (1..8), so the loads unroll into
// registers.  The k indices and weights of a token are the same address
// for all of its threads: one broadcast load each.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_K = 8;
constexpr int VEC_BYTES = 16;

template <typename T>
struct Vec;   // 16 bytes of T to and from floats

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float (&f)[N]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const float2 p = __bfloat1622float2(h[j]);
      f[2 * j] = p.x;
      f[2 * j + 1] = p.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[N]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < N / 2; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    return u;
  }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float (&f)[N]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[N]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
    moe_combine_rows(const T* __restrict__ y, const long long* __restrict__ inv,
                     const float* __restrict__ w, const T* __restrict__ shared,
                     T* __restrict__ out, int n, int d) {
  constexpr int V = Vec<T>::N;
  const int lanes = d / V;   // threads a token
  const int item = blockIdx.x * THREADS + threadIdx.x;
  if (item >= n * lanes) return;
  const int t = item / lanes;
  const size_t col = (size_t)(item - t * lanes) * V;
  long long row[K];
  float wt[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    row[i] = __ldg(inv + (size_t)t * K + i);
    wt[i] = __ldg(w + (size_t)t * K + i);
  }
  uint4 raw[K];
#pragma unroll
  for (int i = 0; i < K; ++i)   // every row in flight before the first sum
    raw[i] = __ldcs(reinterpret_cast<const uint4*>(y + (size_t)row[i] * d + col));
  uint4 sh = make_uint4(0u, 0u, 0u, 0u);
  if (shared != nullptr) sh = __ldcs(reinterpret_cast<const uint4*>(shared + (size_t)t * d + col));
  float acc[V], f[V];
  Vec<T>::unpack(raw[0], f);
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = __fmul_rn(f[j], wt[0]);
#pragma unroll
  for (int i = 1; i < K; ++i) {
    Vec<T>::unpack(raw[i], f);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(f[j], wt[i]));
  }
  if (shared != nullptr) {
    Vec<T>::unpack(sh, f);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = __fadd_rn(acc[j], f[j]);
  }
  *reinterpret_cast<uint4*>(out + (size_t)t * d + col) = Vec<T>::pack(acc);
}

template <typename T, int K>
cudaError_t launch_k(const void* y, const void* inv, const void* w, const void* shared,
                     void* out, int n, int d, cudaStream_t st) {
  const long long items = (long long)n * (d / Vec<T>::N);
  moe_combine_rows<T, K><<<(unsigned)((items + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      (const T*)y, (const long long*)inv, (const float*)w, (const T*)shared, (T*)out, n, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* y, const void* inv, const void* w, const void* shared, void* out,
                   int n, int k, int d, cudaStream_t st) {
  switch (k) {
    case 1: return launch_k<T, 1>(y, inv, w, shared, out, n, d, st);
    case 2: return launch_k<T, 2>(y, inv, w, shared, out, n, d, st);
    case 3: return launch_k<T, 3>(y, inv, w, shared, out, n, d, st);
    case 4: return launch_k<T, 4>(y, inv, w, shared, out, n, d, st);
    case 5: return launch_k<T, 5>(y, inv, w, shared, out, n, d, st);
    case 6: return launch_k<T, 6>(y, inv, w, shared, out, n, d, st);
    case 7: return launch_k<T, 7>(y, inv, w, shared, out, n, d, st);
    case 8: return launch_k<T, 8>(y, inv, w, shared, out, n, d, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// y (n k, d), shared (n, d) or null and out (n, d) of one type, contiguous,
// rows 16-byte aligned: bf16 (fp32 = 0) or float32 (fp32 = 1); inv (n k,)
// int64, a permutation of the rows of y; w (n, k) float32.  n >= 1, 1 <= k
// <= 8, d a multiple of 8, n d below 2^31.  One C call, counted as one
// launch.
extern "C" int moe_combine(const void* y, const void* inv, const void* w, const void* shared,
                           void* out, int n, int k, int d, int fp32, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0 || k < 1 || k > MAX_K || d <= 0 || d % 8 != 0 ||
      (long long)n * d >= (1ll << 31))
    return (int)cudaErrorInvalidValue;   // the wrapper launches none
  if ((uintptr_t)y % VEC_BYTES != 0 || (uintptr_t)out % VEC_BYTES != 0 ||
      (uintptr_t)shared % VEC_BYTES != 0)
    return (int)cudaErrorMisalignedAddress;
  return (int)(fp32 ? launch<float>(y, inv, w, shared, out, n, k, d, st)
                    : launch<__nv_bfloat16>(y, inv, w, shared, out, n, k, d, st));
}

extern "C" const char* moe_combine_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
