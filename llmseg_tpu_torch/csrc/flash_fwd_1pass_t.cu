// Kernel J: the one-pass attention forward that returns o^T.
//
// Replaces llmseg_tpu/ops/attention.py::_fwd1t_kernel (launched by
// _flash_fwd_1pass_t when LLMSEG_ATTN_ONEPASS_T=1).  It computes kernel B's
// function and runs kernel B's body (onepass.cuh, which holds the function,
// what bounds it on an H100 and the design) with an epilogue that writes
// o^T (BH, D, T), as the TPU kernel does.  On the TPU the transposed form
// filled the MXU's 128 output lanes with the query block; on the card it
// would cost a transpose of every probability fragment, so the products
// run in the straight form and only the epilogue transposes, through
// shared memory, into o^T rows of 64 queries with coalesced stores.
#include "onepass.cuh"

using namespace llmseg;

namespace {

template <int D>
__global__ void __launch_bounds__(hopper::FWD_THREADS, 1)
flash_fwd_1pass_t_bf16(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const bf16* __restrict__ q,
                       const bf16* __restrict__ k, const bf16* __restrict__ v,
                       const float* __restrict__ kmax2, bf16* __restrict__ ot, int T, int S) {
  onepass::body<D, true>(&tq, &tk, &tv, q, k, v, kmax2, ot, T, S);
}

}  // namespace

// q (BH, T, D) pre-scaled, k/v (BH, S, D); kmax (BH,) float32 scratch, where
// the call first writes max_j |k_j|^2 of each head; ot (BH, D, T) in q's type.
// Returns the launches' cudaError_t.
extern "C" int flash_fwd_1pass_t(const void* q, const void* k, const void* v, void* kmax,
                                 void* ot, int BH, int T, int S, int D, int is_bf16,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return onepass::launch<64, true>(flash_fwd_1pass_t_bf16<64>, q, k, v, kmax, ot, BH, T, S,
                                     is_bf16, st);
  if (D == 128)
    return onepass::launch<128, true>(flash_fwd_1pass_t_bf16<128>, q, k, v, kmax, ot, BH, T, S,
                                      is_bf16, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_fwd_1pass_t_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
