// Shared pieces of the mma.sync attention kernel E (relpos_fwd.cu) and the
// GEMM of G, H and I (batched_gemm.cuh).  Kernels A, B and J
// (flash_fwd.cu, flash_fwd_1pass.cu, flash_fwd_1pass_t.cu) run their bf16
// paths on hopper.cuh and fwd_core.cuh instead (wgmma, TMA), and the
// backward kernels C (flash_bwd_dq.cu), D (flash_bwd_dkv.cu) and the
// windowed rel-pos kernel F (relpos_window.cu) on hopper.cuh; they take
// only the reductions, the bf16 packing and the float32 paths' helpers
// from here.
//
// Layout contract of both kernels: q (BH, T, D), k and v (BH, S, D), all
// contiguous, q already multiplied by scale*log2(e) in its own dtype, so
// every logit is in the exp2 domain.  T and S are the real lengths: the
// kernels mask the ragged last tile themselves, so the host pads nothing
// but D.
//
// The bf16 kernels run on the tensor cores through mma.sync m16n8k16 (bf16
// in, float32 out).  Each warp owns 16 query rows.  Fragment layout of one
// m16n8k16 product, for lane = 4*g + t (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                           a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16 x 8):             b0 = B[2t..2t+1][g],   b1 = B[2t+8..2t+9][g]
//   C (16 x 8, float32):    c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
// so the logits tile S = Q K^T comes out in C layout and, packed in pairs
// to bf16, is already the A operand of P V: probabilities never leave
// registers.  Q and K fragments come from shared memory by ldmatrix, V's
// by ldmatrix.trans (V is stored row-major, as it arrives).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace llmseg {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e9f;  // finite, as in the JAX package
constexpr int BK = 64;            // keys per shared-memory tile
// dq and dk are taken w.r.t. the pre-scaled q and exp2-domain logits; this
// factor turns them back into the gradient of the natural-log softmax
constexpr float INV_LOG2E = 0.6931471805599453f;

// Shared memory of one block: the q tile and two stages of k and v tiles,
// each row padded by 8 bf16 (16 bytes) so ldmatrix's eight row addresses
// fall in distinct banks.
template <int D, int NW>
struct Tiles {
  static constexpr int BQ = NW * 16;
  static constexpr int LD = D + 8;
  static constexpr int THREADS = NW * 32;
  static constexpr size_t BYTES = sizeof(bf16) * (size_t)(BQ + 4 * BK) * LD;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + n) of a (rows_total, D) bf16 matrix into shared memory
// (leading dimension ld), asynchronously; rows past rows_total read as zero
template <int D, int THREADS>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* __restrict__ src,
                                                int r0, int n, int rows_total, int ld) {
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < n * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    const bool ok = r0 + r < rows_total;
    cp_async16(dst + r * ld + c, src + (size_t)(ok ? r0 + r : 0) * D + c, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b, one m16n8k16 bf16 product with float32 accumulation
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

// A fragments of this warp's 16 q rows (row0 in the tile), all D/16 k-steps
template <int D>
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[D / 16][4], const bf16* sQ, int ld,
                                             int row0) {
  const int lane = threadIdx.x & 31, r8 = lane & 7, mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(qa[kk], sQ + (row0 + r8 + (mi & 1) * 8) * ld + kk * 16 + (mi >> 1) * 8);
}

// s (16 x BK logits, C layout, BK/8 n-tiles) = this warp's q rows x k tile
template <int D>
__device__ __forceinline__ void qk_tile(float (&s)[BK / 8][4], const uint32_t (&qa)[D / 16][4],
                                        const bf16* sK, int ld) {
  const int lane = threadIdx.x & 31, r8 = lane & 7, mi = lane >> 3;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      uint32_t b[4];  // keys np*16 .. +15, d kk*16 .. +15
      ldsm_x4(b, sK + (np * 16 + r8 + (mi >> 1) * 8) * ld + kk * 16 + (mi & 1) * 8);
      mma16816(s[2 * np], qa[kk], b[0], b[1]);
      mma16816(s[2 * np + 1], qa[kk], b[2], b[3]);
    }
  }
}

// o (16 x D, C layout, D/8 n-tiles) += p x v tile; p packed bf16 pairs,
// pk[j][0] for row g and pk[j][1] for row g+8 of key n-tile j; BK keys
template <int D>
__device__ __forceinline__ void pv_tile(float (&o)[D / 8][4], const uint32_t (&pk)[BK / 8][2],
                                        const bf16* sV, int ld) {
  const int lane = threadIdx.x & 31, r8 = lane & 7, mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t a[4] = {pk[2 * kk][0], pk[2 * kk][1], pk[2 * kk + 1][0], pk[2 * kk + 1][1]};
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];  // keys kk*16 .. +15, d np*16 .. +15, transposed on load
      ldsm_x4_t(b, sV + (kk * 16 + r8 + (mi & 1) * 8) * ld + np * 16 + (mi >> 1) * 8);
      mma16816(o[2 * np], a, b[0], b[1]);
      mma16816(o[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// o[row] = acc / denom for one of this lane's two rows, as bf16 pairs
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ o, const float (&acc)[D / 8][4],
                                           int row, int half, float denom) {
  // half 0: row g (acc[.][0..1]); half 1: row g + 8 (acc[.][2..3])
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    *reinterpret_cast<__nv_bfloat162*>(o + (size_t)row * D + 8 * j + 2 * t) =
        __floats2bfloat162_rn(acc[j][2 * half] / denom, acc[j][2 * half + 1] / denom);
}

// reductions over the four lanes (t = 0..3) that share a row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// whole-warp reductions, for the float32 kernels
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace llmseg
