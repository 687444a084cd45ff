// Kernel E: flash attention forward with SAM's decomposed rel-pos bias.
//
// Replaces llmseg_tpu/ops/relpos_attention.py::_kernel (launched by
// relpos_flash_attention for token grids of T = G*G > 512: SAM ViT-H's four
// global layers, G = 64).  Same function (the contract of relpos.cuh):
// exp2-domain logits of a pre-scaled q, plus rh[i, j / G], plus rw[i, j % G]
// in that order, online max / sum / accumulator in float32, p rounded to
// v's dtype before the PV product, rows divided by their sum at the end.
//
// What bounds it on an H100: at ViT-H's global layer (B*H = 16, T = 4096,
// D = 80) the two products are 85.9 GFLOP (0.087 ms of tensor work) against
// about 59 MB of q, k, v, o, rh and rw (0.018 ms), and every logit takes an
// exp2 (268 M of them, about 0.064 ms on the special function units): the
// tensor cores and the exp2 pass, which the design overlaps across
// warpgroups.
//
// What the design does (bf16), on hopper.cuh:
//   * A work item is 128 query rows of one head: 16 x 32 = 512 items at
//     ViT-H.  A persistent CTA per SM walks them (PERSISTENT; a plain grid
//     of one CTA an item is the alternative that scripts/kernel_variants.py
//     times).  A CTA is a producer warp and two consumer warpgroups of 64
//     rows; every product is on wgmma.
//   * The producer brings an item's q and its 128 rows of rh and rw once,
//     and streams 64-key tiles of k and v by TMA through a four-stage
//     mbarrier ring; it loads the next item's first tiles while the
//     consumers finish this one, and its q once they are done with it.  D = 80 is five boxes of 16 columns with 32-byte
//     swizzle (desc_sw32, as kernel F): every k16 step of q k^T is one box,
//     and the PV product is one m64n80k16 a k16 step of keys.
//   * The bias at G = 64: a 64-key tile is exactly one grid row h', so rh
//     gives one value a row a tile, and rw the same 64 values in every
//     tile.  A thread keeps its rows' rw entries for its 32 logit columns in
//     registers for the whole sweep and reads one rh entry a row a tile from
//     shared memory: two adds a logit, no shared-memory traffic per element.
//     The tables' rows are 128 bytes, so they come by tensor map with
//     128-byte swizzle (the rows of a warp's rh reads fall in distinct
//     banks).  Any other G (none in a SAM config) reads both entries of
//     every logit from tables that the producer's lanes stage, and masks
//     the keys past T of the ragged last tile.
//   * Each consumer runs S = q k^T, the bias and the online softmax, then
//     O += P v with P from registers, in turn; the two warpgroups run
//     unsynchronised, so one's exp2 pass overlaps the other's products.
//
// float32 inputs take the plain SIMT kernel of relpos.cuh.
#include "hopper.cuh"
#include "relpos.cuh"

using namespace llmseg;

namespace {

constexpr bool PERSISTENT = true;   // one CTA an SM walking the items; else one CTA an item
constexpr int CWG = 2;              // consumer warpgroups, 64 query rows each
constexpr int THREADS = 128 * CWG + 32;  // and a producer warp
constexpr int BQ = 64 * CWG, BN = 64;    // query rows an item, keys a tile
constexpr int STAGES = 4;
constexpr int SLACK = 1024;         // the dynamic base's alignment to 1024 bytes
constexpr uint32_t TABLE = BQ * 128;  // one table's room: BQ rows of up to 64 bf16

// Shared memory from the 1024-aligned base: rh, rw (1024-aligned for the
// 128-byte swizzle), q (ND boxes of 16 columns x 128 rows), then the stages
// (k as ND boxes of 64 rows, then v the same).
template <int D>
struct Layout {
  static constexpr int ND = D / 16;
  static constexpr uint32_t QSLOT = BQ * 32, KSLOT = BN * 32;
  static constexpr uint32_t OFF_RH = 0, OFF_RW = TABLE, OFF_Q = 2 * TABLE;
  static constexpr uint32_t OFF_ST = OFF_Q + ND * QSLOT;
  static constexpr uint32_t STAGE = 2 * ND * KSLOT;
  static constexpr uint32_t BYTES = OFF_ST + STAGES * STAGE;
};

struct Bars {
  uint64_t full[STAGES], empty[STAGES], q_full, q_empty;
};

// an entry of a 128-byte-swizzled (128 x 64) bf16 table as TMA wrote it
__device__ __forceinline__ const bf16* swz(const unsigned char* tab, int r, int c) {
  return reinterpret_cast<const bf16*>(tab + r * 128 + (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2);
}

template <int D, int GT>
__global__ void __launch_bounds__(THREADS, 1)
relpos_fwd_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap trh,
                const __grid_constant__ CUtensorMap trw, const bf16* __restrict__ rh,
                const bf16* __restrict__ rw, bf16* __restrict__ o, int T, int G_rt, int items,
                int nq) {
  using L = Layout<D>;
  constexpr int ND = L::ND;
  __shared__ Bars bars;
  extern __shared__ unsigned char smem[];
  const uint32_t base = hopper::align1024(smem);
  unsigned char* gbase = smem + (base - smem_u32(smem));  // the same place, generic
  const int G = GT ? GT : G_rt;
  const int n_tiles = (T + BN - 1) / BN;
  const int wg = hopper::warpgroup_index();
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hopper::mbar_init(&bars.full[i], 1);
      hopper::mbar_init(&bars.empty[i], 4 * CWG);  // one arrival from each consumer warp
    }
    hopper::mbar_init(&bars.q_full, 33);     // lane 0's expect_tx and the 32 lanes
    hopper::mbar_init(&bars.q_empty, 4 * CWG);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == CWG) {
    // the producer warp: per item the first STAGES key tiles (into stages
    // that the previous item's last tiles free), then q and the tables once
    // the consumers are done with the previous item's, then the other tiles
    for (int i = 0, t = 0, item = blockIdx.x; item < items; ++i, item += gridDim.x) {
      const int bh = item / nq, q0 = (item % nq) * BQ;
      auto load_tile = [&](int j) {
        const int st = t % STAGES, round = t / STAGES;
        ++t;
        hopper::mbar_wait(&bars.empty[st], (round & 1) ^ 1);  // a fresh barrier passes
        if (lane == 0) {
          const uint32_t ks = base + L::OFF_ST + st * L::STAGE, vs = ks + ND * L::KSLOT;
          hopper::mbar_expect_tx(&bars.full[st], L::STAGE);
          for (int b = 0; b < ND; ++b) {
            hopper::tma_load_3d(ks + b * L::KSLOT, &tk, 16 * b, j * BN, bh, &bars.full[st]);
            hopper::tma_load_3d(vs + b * L::KSLOT, &tv, 16 * b, j * BN, bh, &bars.full[st]);
          }
        }
      };
      const int pre = min(STAGES, n_tiles);
      for (int j = 0; j < pre; ++j) load_tile(j);
      hopper::mbar_wait(&bars.q_empty, (i & 1) ^ 1);
      if (lane == 0) {
        hopper::mbar_expect_tx(&bars.q_full, ND * L::QSLOT + (GT == 64 ? 2 * TABLE : 0));
        for (int b = 0; b < ND; ++b)
          hopper::tma_load_3d(base + L::OFF_Q + b * L::QSLOT, &tq, 16 * b, q0, bh, &bars.q_full);
        if constexpr (GT == 64) {
          hopper::tma_load_3d(base + L::OFF_RH, &trh, 0, q0, bh, &bars.q_full);
          hopper::tma_load_3d(base + L::OFF_RW, &trw, 0, q0, bh, &bars.q_full);
        }
      }
      if constexpr (GT != 64) {
        const int n = min(BQ, T - q0) * G;
        const size_t off = ((size_t)bh * T + q0) * G;
        bf16* th = reinterpret_cast<bf16*>(gbase + L::OFF_RH);
        bf16* tw = reinterpret_cast<bf16*>(gbase + L::OFF_RW);
        for (int e = lane; e < n; e += 32) {
          th[e] = rh[off + e];
          tw[e] = rw[off + e];
        }
      }
      hopper::mbar_arrive(&bars.q_full);  // after this lane's stores
      for (int j = pre; j < n_tiles; ++j) load_tile(j);
    }
    return;
  }

  const int warp = (threadIdx.x / 32) & 3, g = lane >> 2, t4 = lane & 3;
  const bool lead = lane == 0;
  const int rl = 64 * wg + 16 * warp + g;  // this thread's rows rl, rl + 8 in the item
  const uint32_t qs = base + L::OFF_Q + wg * 64 * 32;
  const unsigned char* tabh = gbase + L::OFF_RH;
  const unsigned char* tabw = gbase + L::OFF_RW;

  for (int i = 0, t = 0, item = blockIdx.x; item < items; ++i, item += gridDim.x) {
    const int bh = item / nq, q0 = (item % nq) * BQ;
    hopper::mbar_wait(&bars.q_full, i & 1);
    // the tables' rows of this thread's rows; a row past T (its output is
    // never stored) reads the last row's
    const int last = min(BQ, T - q0) - 1;
    const int r[2] = {min(rl, last), min(rl + 8, last)};
    float rwv[32];  // G = 64: rw of this thread's logits, the same in every tile
    if constexpr (GT == 64) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 w = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(swz(tabw, r[h], 8 * j + 2 * t4)));
          rwv[4 * j + 2 * h] = w.x;
          rwv[4 * j + 2 * h + 1] = w.y;
        }
    }
    float o_acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o_acc[j] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // l: this lane's partial sums

    for (int j = 0; j < n_tiles; ++j, ++t) {
      const int st = t % STAGES;
      hopper::mbar_wait(&bars.full[st], (t / STAGES) & 1);
      const uint32_t ks = base + L::OFF_ST + st * L::STAGE, vs = ks + ND * L::KSLOT;
      float s[32];
      hopper::reg_fence(s);
      hopper::wgmma_fence();
#pragma unroll
      for (int b = 0; b < ND; ++b)
        hopper::wgmma_ss<64>(s, hopper::desc_sw32(qs + b * L::QSLOT, 16),
                             hopper::desc_sw32(ks + b * L::KSLOT, 16), b > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(s);

      if constexpr (GT == 64) {
        const float bh0 = __bfloat162float(*swz(tabh, r[0], j));
        const float bh1 = __bfloat162float(*swz(tabh, r[1], j));
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] = (s[e] + ((e >> 1) & 1 ? bh1 : bh0)) + rwv[e];
      } else {
        const bf16* th = reinterpret_cast<const bf16*>(tabh);
        const bf16* tw = reinterpret_cast<const bf16*>(tabw);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int key = j * BN + 8 * (e >> 2) + 2 * t4 + (e & 1), row = r[(e >> 1) & 1];
          if (key < T) {
            const int kh = key / G, kw = key - kh * G;
            s[e] = (s[e] + __bfloat162float(th[row * G + kh])) + __bfloat162float(tw[row * G + kw]);
          } else {
            s[e] = NEG_INF;
          }
        }
      }

      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
      float al[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mn = fmaxf(m[h], quad_max(mx[h]));
        al[h] = hopper::ex2(m[h] - mn);
        m[h] = mn;
      }
      float ps[2] = {0.f, 0.f};
      uint32_t pr[16];  // P as wgmma register A operands: pr[4kk..4kk+3] for keys 16kk..
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float p0 = hopper::ex2(s[4 * q] - m[0]), p1 = hopper::ex2(s[4 * q + 1] - m[0]);
        const float p2 = hopper::ex2(s[4 * q + 2] - m[1]), p3 = hopper::ex2(s[4 * q + 3] - m[1]);
        ps[0] += p0 + p1;
        ps[1] += p2 + p3;
        pr[2 * q] = pack_bf16(p0, p1);
        pr[2 * q + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * al[h] + ps[h];
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o_acc[e] *= al[(e >> 1) & 1];

      hopper::reg_fence(pr);
      hopper::reg_fence(o_acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        hopper::wgmma_rs<D>(o_acc, pr[4 * kk], pr[4 * kk + 1], pr[4 * kk + 2], pr[4 * kk + 3],
                            hopper::desc_sw32(vs + 16 * kk * 32, L::KSLOT), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(o_acc);
      hopper::reg_fence(pr);
      if (lead) hopper::mbar_arrive(&bars.empty[st]);
    }
    // q and the tables are free for the next item: this warp's table reads
    // come before the next TMA writes
    hopper::fence_proxy_async();
    __syncwarp();
    if (lead) hopper::mbar_arrive(&bars.q_empty);

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + rl + 8 * h;
      const float lt = quad_sum(l[h]);
      const float denom = lt == 0.f ? 1.f : lt;
      if (row >= T) continue;
      bf16* orow = o + ((size_t)bh * T + row) * D;
#pragma unroll
      for (int q = 0; q < D / 8; ++q)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * q + 2 * t4) = __floats2bfloat162_rn(
            o_acc[4 * q + 2 * h] / denom, o_acc[4 * q + 2 * h + 1] / denom);
    }
  }
}

// The CTAs of kern the card holds at once with smem bytes of shared memory,
// after raising the kernel's shared-memory attribute; or -cudaError_t
template <typename K>
int resident_ctas(K kern, int smem) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
  if (e != cudaSuccess) return -(int)e;
  return per_sm < 1 ? -(int)cudaErrorInvalidConfiguration : sms * per_sm;
}

template <int D, int GT>
int launch_g(const void* q, const void* k, const void* v, const void* rh, const void* rw,
             void* o, int BH, int T, int G, cudaStream_t st) {
  constexpr int smem = Layout<D>::BYTES + SLACK;
  auto kern = relpos_fwd_bf16<D, GT>;
  static const int ctas = resident_ctas(kern, smem);  // the same at every launch
  if (ctas < 0) return -ctas;
  const int nq = (T + BQ - 1) / BQ, items = BH * nq;
  CUtensorMap tq, tk, tv, trh, trw;
  memset(&trh, 0, sizeof(trh));
  memset(&trw, 0, sizeof(trw));
  cudaError_t e = hopper::tensor_map_3d(&tq, q, D, T, BH, BQ, 16);
  if (e == cudaSuccess) e = hopper::tensor_map_3d(&tk, k, D, T, BH, BN, 16);
  if (e == cudaSuccess) e = hopper::tensor_map_3d(&tv, v, D, T, BH, BN, 16);
  if (GT == 64 && e == cudaSuccess) e = hopper::tensor_map_3d(&trh, rh, 64, T, BH, BQ);
  if (GT == 64 && e == cudaSuccess) e = hopper::tensor_map_3d(&trw, rw, 64, T, BH, BQ);
  if (e != cudaSuccess) return (int)e;
  kern<<<PERSISTENT ? min(items, ctas) : items, THREADS, smem, st>>>(
      tq, tk, tv, trh, trw, (const bf16*)rh, (const bf16*)rw, (bf16*)o, T, G, items, nq);
  return (int)cudaGetLastError();
}

// the grid side of SAM's global layers at compile time, any other at run time
template <int D>
int launch(const void* q, const void* k, const void* v, const void* rh, const void* rw, void* o,
           int BH, int T, int G, cudaStream_t st) {
  if (G == 64) return launch_g<D, 64>(q, k, v, rh, rw, o, BH, T, G, st);
  return launch_g<D, 0>(q, k, v, rh, rw, o, BH, T, G, st);
}

}  // namespace

// q (BH, T, D) pre-scaled, k/v (BH, T, D), rh/rw (BH, T, G), o like q;
// T == G*G, G <= 64.  bf16 takes D in {16, 32, 64, 80, 128}, float32 any
// D <= 128.  Returns the launch's cudaError_t.
extern "C" int relpos_fwd(const void* q, const void* k, const void* v, const void* rh,
                          const void* rw, void* o, int BH, int T, int G, int D, int is_bf16,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (G > MAX_G || T != G * G) return (int)cudaErrorInvalidValue;
  if (!is_bf16) return launch_relpos_f32(q, k, v, rh, rw, o, BH, T, G, D, st);
  switch (D) {
    case 16: return launch<16>(q, k, v, rh, rw, o, BH, T, G, st);
    case 32: return launch<32>(q, k, v, rh, rw, o, BH, T, G, st);
    case 64: return launch<64>(q, k, v, rh, rw, o, BH, T, G, st);
    case 80: return launch<80>(q, k, v, rh, rw, o, BH, T, G, st);
    case 128: return launch<128>(q, k, v, rh, rw, o, BH, T, G, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* relpos_fwd_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
