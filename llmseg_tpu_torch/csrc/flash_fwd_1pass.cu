// Kernel B: the non-causal one-pass attention forward, o row-major.
//
// Replaces llmseg_tpu/ops/attention.py::_fwd1_kernel (launched by
// _flash_fwd_1pass).  The function, what bounds it on an H100 and the
// design are onepass.cuh's: this file only launches its kernel body with the
// row-major epilogue (kernel J, flash_fwd_1pass_t.cu, is the same body with
// the o^T epilogue).
#include "onepass.cuh"

using namespace llmseg;

namespace {

template <int D>
__global__ void __launch_bounds__(hopper::FWD_THREADS, 1)
flash_fwd_1pass_bf16(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const bf16* __restrict__ q,
                     const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const float* __restrict__ kmax2, bf16* __restrict__ o, int T, int S) {
  onepass::body<D, false>(&tq, &tk, &tv, q, k, v, kmax2, o, T, S);
}

}  // namespace

// q (BH, T, D) pre-scaled, k/v (BH, S, D); kmax (BH,) float32 scratch, where
// the call first writes max_j |k_j|^2 of each head; o (BH, T, D) in q's type.
// Returns the launches' cudaError_t.
extern "C" int flash_fwd_1pass(const void* q, const void* k, const void* v, void* kmax, void* o,
                               int BH, int T, int S, int D, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return onepass::launch<64, false>(flash_fwd_1pass_bf16<64>, q, k, v, kmax, o, BH, T, S,
                                      is_bf16, st);
  if (D == 128)
    return onepass::launch<128, false>(flash_fwd_1pass_bf16<128>, q, k, v, kmax, o, BH, T, S,
                                       is_bf16, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_fwd_1pass_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
