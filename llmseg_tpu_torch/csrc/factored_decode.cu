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
// 7 tokens, L = 4096, C = 256) the work is about 96 GFLOP of useful
// products a chunk (norm4's sigma_bbar base^T and gram A, the scores and
// attends against the shared G / PE matrices, the upscale's A^T (B W1) and
// conv2; 0.097 ms at the tensor rate), against some 34 MB of bf16 mask
// output: operations.  A prompt's rank state A (up to 128 x 4096) does not
// fit a block's shared memory, and one block per prompt would fill half the
// SMs, so the TPU kernel's one-program-per-prompt design does not carry
// over.  Instead every step runs over all prompts of the chunk at once, as
// a sequence of launches, with the scratch between steps allocated by the
// wrapper.  The host side receives the whole sequence
// (twoway_kernel.Program) in one call and launches it on the caller's
// stream; the wrapper records the sequence once per image and replays it
// for every chunk.
//
// Two routes, by dtype (g_program):
//   * bf16: the four parts that sweep over L are fused kernels on wgmma and
//     TMA (factored_fused.cuh: OP_T2I, OP_I2T, OP_NORM4_FUSED, OP_UPSCALE),
//     which keep the float32 scores, norm4's products and the upscale's
//     intermediates out of device memory; the token-side steps, on (P, 7,
//     256) and the rank matrices, stay on the records below.
//   * float32: every step on the records below: a strided batched GEMM with
//     fused epilogues (batched_gemm.cuh, shared with kernels H and I: bf16
//     operands on mma.sync 64 x 64 tiles, float32 ones on a SIMT tile),
//     softmaxes, LayerNorms, norm4's closed form and small layout ops.
#include "records.cuh"
#include "factored_fused.cuh"

namespace {

// a record of kernel G: its fused kinds, or a shared one
int run_op(int op, const long long* I, void* const* P, const float* Fv, cudaStream_t st) {
  switch (op) {
    case OP_T2I:
      return llmseg::fused::t2i_run(I, P, st);
    case OP_I2T:
      return llmseg::fused::i2t_run(I, P, st);
    case OP_NORM4_FUSED:
      return llmseg::fused::norm4_run(I, P, Fv, st);
    case OP_UPSCALE:
      return llmseg::fused::upscale_run(I, P, Fv, st);
    default:
      return run_common_op(op, I, P, Fv, st);
  }
}

}  // namespace

static int failed_record = -1;

// Run n recorded operations in order on the caller's stream: ops (n),
// ints (n, 24), ptrs (n, 12), floats (n, 4), as twoway_kernel.Program.pack
// lays them out.  Returns the first launch error (cudaError_t), or 0;
// factored_decode_failed_record then gives that record's index.
extern "C" int factored_decode(int n, const void* ops, const void* ints, const void* ptrs,
                               const void* floats, void* stream) {
  return run_records(n, ops, ints, ptrs, floats, (cudaStream_t)stream, run_op, &failed_record);
}

extern "C" int factored_decode_failed_record() { return failed_record; }

extern "C" const char* factored_decode_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
