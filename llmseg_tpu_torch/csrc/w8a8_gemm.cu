// Kernel Q2 (redesigned): the W8A8 product with its rescale as the epilogue,
// an s8 x s8 -> s32 GEMM on wgmma whose accumulators are rescaled in
// registers and written once, in the output's type.
//
// Replaces XLA code of llmseg_tpu/ops/quant.py: qdense_act (quant.py:194-213),
// the int8 dot with preferred_element_type=int32 and its rescale, which XLA
// fuses into the dot's output on the TPU:
//   y = ((float(xq wq^T) * sc[row]) * w_scale[col] (+ side[row, col]))
// rounded once to the output type (bf16 or float32), then + bias in that
// type.  The int32 sums are exact, and the rescale runs the IEEE-rounded
// intrinsics in that order (__int2float_rn, __fmul_rn, __fadd_rn,
// __float2bfloat16_rn; no FMA contraction, no --use_fast_math), so the
// output equals the plain version (torch._int_mm, then quant.cu's Q2
// epilogue) to the bit.
//
// With an int32 output (the row split of a mesh with tp above 1, whose
// int32 partial sums are summed over tp before quant.cu's rescale) the
// epilogue stores the accumulators as they are: no scale or bias is read.
//
// What bounds it on an H100: operations.  At LLaMA-7B's W8A8 products
// (3068 rows at batch 4; K, N in {4096, 11008}) a product is 103 to 277 G
// int8 operations, 0.052 to 0.140 ms at the card's 1,979 TOPS, against 30
// to 70 MB of operands and output (0.009 to 0.021 ms).  The plain route
// (torch._int_mm, CUTLASS's sm80 kernel on this card, then Q2's pass)
// also writes and reads back a 4-byte int32 product an element.
//
// What the design does, on hopper.cuh:
//   * A persistent CTA an SM walks 128 x 256 output tiles, M fastest, so
//     that the CTAs in flight share each weight tile in L2 (the 11008 x
//     4096 weight is 45 MB of the 50 MB L2) and the activations stay there.
//   * One producer thread streams 128-byte slices of K of both operands by
//     TMA (128-byte swizzle, zero-filled past the last row, column and K)
//     through a four-stage mbarrier ring, 48 KB a stage for 8.4 M
//     operations.  Both operands are K-major: xq (R, K) row-major and the
//     weight (N, K) as nn.Linear keeps it.  Two CTAs of a cluster sharing
//     their weight tile by multicast (scripts/w8a8_gemm_cluster.edits, a
//     variant that scripts/kernel_variants.py times) ran no faster.
//   * Two consumer warpgroups of 64 rows each take every stage: four
//     m64n256k32 s8 products a stage, one wgmma group kept in flight while
//     the next stage is waited for.  Each holds 128 int32 accumulators a
//     thread; setmaxnreg moves the producer's registers to them.
//   * The epilogue rescales the accumulators in registers, rounds them to
//     the output type and writes each warp's 16 rows 128 bytes at a time
//     through 2 KB of shared memory, so that the stores are whole 128-byte
//     row segments, 16 bytes a lane; no int32 tensor is written.  It runs
//     while the producer already loads the next tile's first stages.  The
//     tile's column scales and bias are staged in shared memory (and its
//     row scales in registers) when the tile starts.  Read from L2 inside
//     the epilogue (one dependent load a column chunk) and stored as pairs
//     (a warp's store touching 8 rows), they made a tile at K = 4096 take
//     some 8 us beyond its main loop.
#include <type_traits>

#include "hopper.cuh"

using namespace llmseg;

namespace {

constexpr int BN = 256;             // output columns a tile (an N of wgmma's s8 list)
constexpr int CWG = 2;              // consumer warpgroups, 64 rows each
constexpr int BM = 64 * CWG;        // output rows a tile
constexpr int BK = 128;             // K a stage: one 128-byte swizzled line a row
constexpr int STAGES = 4;
constexpr int THREADS = 128 * (CWG + 1);  // and a producer warpgroup (one thread issues)
constexpr uint32_t A_BYTES = BM * BK, B_BYTES = BN * BK, STAGE = A_BYTES + B_BYTES;
constexpr int OUT_LINES = 16;       // a consumer warp's rows, staged 128 bytes of each at once
constexpr uint32_t OUT_BYTES = 4 * CWG * OUT_LINES * 128;  // after the stages
constexpr int SLACK = 1024;         // the dynamic base's alignment to 1024 bytes
constexpr int SMEM = STAGES * STAGE + OUT_BYTES + SLACK;
constexpr int F32 = 0, BF16 = 1, I32 = 2;  // dtype codes of the wrapper
static_assert(BN <= 128 * CWG, "a consumer thread loads one column of a tile's scales");

struct Bars {
  uint64_t full[STAGES], empty[STAGES];
};

// a tile's column scales and bias, by the tile's parity: loaded when the
// tile starts, read by its epilogue
template <typename O>
struct Cols {
  float ws[2][BN];
  O bias[2][BN];
};

// one pair of output columns in the output type: float32 as is, bf16
// rounded; then the bias (a pair in shared memory) added in that type.
// Returned as the pair's bytes.
__device__ __forceinline__ uint2 pack_pair(float y0, float y1, const float* bias) {
  if (bias) {
    const float2 b = *reinterpret_cast<const float2*>(bias);
    y0 = __fadd_rn(y0, b.x);
    y1 = __fadd_rn(y1, b.y);
  }
  return make_uint2(__float_as_uint(y0), __float_as_uint(y1));
}
__device__ __forceinline__ uint32_t pack_pair(float y0, float y1, const bf16* bias) {
  bf16 o0 = __float2bfloat16_rn(y0), o1 = __float2bfloat16_rn(y1);
  if (bias) {
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(bias);
    o0 = __float2bfloat16_rn(__fadd_rn(__bfloat162float(o0), __bfloat162float(b.x)));
    o1 = __float2bfloat16_rn(__fadd_rn(__bfloat162float(o1), __bfloat162float(b.y)));
  }
  __nv_bfloat162 o;
  o.x = o0;
  o.y = o1;
  uint32_t u;
  memcpy(&u, &o, sizeof(u));
  return u;
}

template <typename O>
constexpr bool kInt32 = std::is_same<O, int32_t>::value;  // the accumulators as they are

template <typename O>
__global__ void __launch_bounds__(THREADS, 1)
    w8a8_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                     const float* __restrict__ sc, const float* __restrict__ ws,
                     const O* __restrict__ bias, const float* __restrict__ side,
                     O* __restrict__ out, int R, int N, int K) {
  __shared__ Bars bars;
  __shared__ __align__(16) Cols<O> cols;
  extern __shared__ unsigned char smem[];
  const uint32_t base = hopper::align1024(smem);
  const int mt = (R + BM - 1) / BM, tiles = mt * ((N + BN - 1) / BN);
  const int kbs = (K + BK - 1) / BK;
  const int wg = hopper::warpgroup_index();
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hopper::mbar_init(&bars.full[i], 1);
      hopper::mbar_init(&bars.empty[i], 4 * CWG);  // one arrival from each consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == CWG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == CWG * 128) {
      for (int tile = blockIdx.x, t = 0; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % mt) * BM, n0 = (tile / mt) * BN;
        for (int kb = 0; kb < kbs; ++kb, ++t) {
          const int st = t % STAGES;
          hopper::mbar_wait(&bars.empty[st], ((t / STAGES) & 1) ^ 1);  // a fresh barrier passes
          const uint32_t a = base + st * STAGE;
          hopper::mbar_expect_tx(&bars.full[st], STAGE);
          hopper::tma_load_2d(a, &ta, kb * BK, m0, &bars.full[st]);
          hopper::tma_load_2d(a + A_BYTES, &tb, kb * BK, n0, &bars.full[st]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const bool lead = lane == 0;
    const int r_lo = wg * 64 + warp * 16 + g;  // this thread's rows r_lo, r_lo + 8 of a tile
    unsigned char* lines =  // this warp's staging lines for the output
        smem + (base - smem_u32(smem)) + STAGES * STAGE + (4 * wg + warp) * OUT_LINES * 128;
    for (int tile = blockIdx.x, t = 0, par = 0; tile < tiles; tile += gridDim.x, par ^= 1) {
      const int m0 = (tile % mt) * BM, n0 = (tile / mt) * BN;
      // what the epilogue reads, loaded now so that the main loop hides the
      // latency: the column scales and bias into shared memory (a consumer
      // thread a column), the row scales into registers
      float s[2] = {0.f, 0.f};
      if constexpr (!kInt32<O>) {
        if (threadIdx.x < BN) {
          const int c = n0 + threadIdx.x;
          cols.ws[par][threadIdx.x] = c < N ? __ldg(ws + c) : 0.f;
          if (bias) cols.bias[par][threadIdx.x] = c < N ? bias[c] : O(0.f);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
          s[h] = m0 + r_lo + 8 * h < R ? __ldg(sc + m0 + r_lo + 8 * h) : 0.f;
      }
      uint32_t acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      // the first stage, then one wgmma group in flight while the next
      // stage is waited for: every group is issued on every path
      {
        const int st = t % STAGES;
        hopper::mbar_wait(&bars.full[st], (t / STAGES) & 1);
        const uint32_t a = base + st * STAGE + wg * 64 * BK, b = base + st * STAGE + A_BYTES;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          hopper::wgmma_s8<BN>(acc, hopper::desc_kmajor(a + 32 * kk),
                               hopper::desc_kmajor(b + 32 * kk), 1);
        hopper::wgmma_commit();
        ++t;
      }
      for (int kb = 1; kb < kbs; ++kb, ++t) {
        const int st = t % STAGES;
        hopper::mbar_wait(&bars.full[st], (t / STAGES) & 1);
        const uint32_t a = base + st * STAGE + wg * 64 * BK, b = base + st * STAGE + A_BYTES;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          hopper::wgmma_s8<BN>(acc, hopper::desc_kmajor(a + 32 * kk),
                               hopper::desc_kmajor(b + 32 * kk), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // the previous stage's products are done with it
        if (lead) hopper::mbar_arrive(&bars.empty[(t - 1) % STAGES]);
      }
      hopper::wgmma_wait<0>();
      hopper::reg_fence(acc);
      if (lead) hopper::mbar_arrive(&bars.empty[(t - 1) % STAGES]);

      // the rescale, in registers: rows r_lo and r_lo + 8, columns 8j + 2 t4
      // and the next one of each 8-column chunk j.  The columns' values
      // are in shared memory once both consumer warpgroups passed here (the
      // other parity's may be read until then).
      hopper::bar_sync(1, 128 * CWG);
      // 128 bytes of each of the warp's 16 rows at a time (CB columns) go
      // through its staging lines (16-byte chunk c of line l at c ^ (l % 8):
      // the pairs' writes and the rows' reads meet no bank conflict), then
      // out as whole 128-byte row segments, 16 bytes a lane
      constexpr int CB = 128 / sizeof(O);
      const int row0 = m0 + wg * 64 + warp * 16;  // the warp's first row
#pragma unroll
      for (int q = 0; q < BN / CB; ++q) {
#pragma unroll
        for (int jj = 0; jj < CB / 8; ++jj) {
          const int j = q * (CB / 8) + jj, col = 8 * j + 2 * t4;
          float2 w = make_float2(0.f, 0.f);
          if constexpr (!kInt32<O>) w = *reinterpret_cast<const float2*>(&cols.ws[par][col]);
          const uint32_t byte = (8 * jj + 2 * t4) * sizeof(O);  // in the 128-byte line
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int line = g + 8 * h;
            unsigned char* dst =
                lines + line * 128 + ((((byte >> 4) ^ line) & 7) << 4) + (byte & 15);
            if constexpr (kInt32<O>) {
              *reinterpret_cast<uint2*>(dst) =
                  make_uint2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            } else {
              float y0 = __fmul_rn(__fmul_rn(__int2float_rn((int)acc[4 * j + 2 * h]), s[h]), w.x);
              float y1 =
                  __fmul_rn(__fmul_rn(__int2float_rn((int)acc[4 * j + 2 * h + 1]), s[h]), w.y);
              if (side && row0 + line < R && n0 + col < N) {
                const float2 sd = __ldg(reinterpret_cast<const float2*>(
                    side + (size_t)(row0 + line) * N + n0 + col));
                y0 = __fadd_rn(y0, sd.x);
                y1 = __fadd_rn(y1, sd.y);
              }
              auto v = pack_pair(y0, y1, bias ? &cols.bias[par][col] : nullptr);
              *reinterpret_cast<decltype(v)*>(dst) = v;
            }
          }
        }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < OUT_LINES * 8 / 32; ++i) {
          const int line = 4 * i + (lane >> 3), c = lane & 7;
          const int r = row0 + line, col = n0 + q * CB + c * (16 / sizeof(O));
          const uint4 v = *reinterpret_cast<const uint4*>(lines + line * 128 + ((c ^ (line & 7)) << 4));
          if (r < R && col < N)  // N % 8 == 0: a 16-byte chunk is wholly in or out
            *reinterpret_cast<uint4*>(out + (size_t)r * N + col) = v;
        }
        __syncwarp();  // the lines are rewritten by the next block
      }
    }
  }
}

// The CTAs of kern the card holds at once, after raising the kernel's
// shared-memory attribute; or -cudaError_t
template <typename K>
int resident_ctas(K kern) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, SMEM);
  if (e != cudaSuccess) return -(int)e;
  return per_sm < 1 ? -(int)cudaErrorInvalidConfiguration : sms * per_sm;
}

template <typename O>
int launch(const void* xq, const void* w, const void* sc, const void* ws, const void* bias,
           const void* side, void* out, int R, int N, int K, cudaStream_t st) {
  auto kern = w8a8_gemm_kernel<O>;
  static const int ctas = resident_ctas(kern);  // the same at every launch
  if (ctas < 0) return -ctas;
  CUtensorMap ta, tb;
  cudaError_t e = hopper::tensor_map_2d_s8(&ta, xq, K, R, BM);
  if (e == cudaSuccess) e = hopper::tensor_map_2d_s8(&tb, w, K, N, BN);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((R + BM - 1) / BM) * ((N + BN - 1) / BN);
  kern<<<tiles < ctas ? tiles : ctas, THREADS, SMEM, st>>>(
      ta, tb, (const float*)sc, (const float*)ws, (const O*)bias, (const float*)side, (O*)out, R,
      N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// xq (R, K) int8, w (N, K) int8, both contiguous and 16-byte aligned; sc
// (R,) and w_scale (N,) float32; bias (N,) of the output's type or null;
// side (R, N) float32 or null; out (R, N) of `out_dtype` (bf16 or float32;
// or int32: the accumulators, with sc, w_scale, bias and side unread).
// K a multiple of 16 up to 133,144 (|acc| <= K * 127^2 stays in int32), N a
// multiple of 8, R >= 1.  Returns the launch's cudaError_t.
extern "C" int w8a8_gemm(const void* xq, const void* w, const void* sc, const void* ws,
                         const void* bias, const void* side, void* out, int R, int N, int K,
                         int out_dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (R <= 0 || N <= 0 || N % 8 || K <= 0 || K % 16 || K > 133144)
    return (int)cudaErrorInvalidValue;
  if (out_dtype == BF16) return launch<bf16>(xq, w, sc, ws, bias, side, out, R, N, K, st);
  if (out_dtype == F32) return launch<float>(xq, w, sc, ws, bias, side, out, R, N, K, st);
  if (out_dtype == I32)
    return launch<int32_t>(xq, w, nullptr, nullptr, nullptr, nullptr, out, R, N, K, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* w8a8_gemm_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
