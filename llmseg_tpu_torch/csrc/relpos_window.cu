// Kernel F: whole-window attention with SAM's decomposed rel-pos bias.
//
// Replaces llmseg_tpu/ops/relpos_attention.py::_window_kernel (launched by
// relpos_flash_attention for token grids of T = G*G <= 512: SAM ViT-H's 28
// windowed layers, 14 x 14 windows, T = 196).  Same function: exp2-domain
// logits of a pre-scaled q plus the bias rh[i, j / G] + rw[i, j % G], added
// in float32, the exact row maximum over the whole window, p = exp2(s - max)
// divided by its row sum BEFORE it is rounded to v's dtype, then p v.  The
// zero-padded tokens of a window are real keys here, as in the TPU kernel;
// only keys past T are masked.
//
// What bounds it on an H100: at ViT-H's windowed layer (25 windows x 16
// heads, T = 196, D = 80) the products are 4.9 GFLOP (5 us) against about
// 55 MB of q, k, v, o, rh and rw (16 us): bytes.  So every byte is read
// once and the copies run under the compute.
//
// What the design does (bf16):
//   * A work item is a whole (window, head) pair: its q, k and v (196 x 80
//     each) and its two (T, G) tables come into shared memory once, so k
//     and v are read once per pair.  Each CTA is persistent: one a SM, it
//     walks the items, and a producer warp loads the next item's stage by
//     TMA (tensor maps for q, k and v; one cp.async.bulk copy for each whole
//     table, 5,488 contiguous bytes, since a table row of 28 bytes takes no
//     tensor map) through a two-stage mbarrier ring while the two consumer
//     warpgroups compute this one.
//   * D = 80 is five boxes of 16 columns with 32-byte swizzle (hopper.cuh
//     desc_sw32), not 64 + 16 and not zero-filled to 128: every k16 step of
//     q k^T is one box, the PV product is one m64n80k16 over the five
//     boxes (N blocks LBO apart), every D in {16, 32, 64, 80, 128} takes the
//     same code, and a stage is 107 KB, so two fit (zero-filling to 128
//     would need 160 KB a stage).  32-byte rows read as 8 x 16-byte core
//     matrices fall in distinct banks.
//   * One pass over the window: the four 64-row query tiles are split over
//     the two consumer warpgroups (tiles w and w + 2).  A tile's 64 x 196
//     logits stay in registers (three m64n64 chunks and an m64n8 tail, 100
//     floats a thread, under the 168-register cap of a 288-thread CTA); the
//     bias is added from shared memory in float32, the row maximum and sum
//     are exact, p is normalised, rounded and multiplied into v with P from
//     registers.  There is no second q k^T sweep.  The output goes through
//     the tile's own q rows in shared memory to 16-byte stores.
//   * Other grid sides G (no SAM config has one) take a general path: a
//     work item is 128 query rows of a pair with all its keys resident, the
//     tables loaded by the producer warp's lanes, and two sweeps of
//     64-key chunks: the row maximum and sum online, then p and p v.  It
//     covers every T <= 512 whose stage fits shared memory.
//
// float32 inputs take the plain SIMT kernel of relpos.cuh (online softmax;
// it normalises at the end, which in float32 differs only by rounding).
#include "hopper.cuh"
#include "relpos.cuh"

using namespace llmseg;

namespace {

constexpr int THREADS = 288;   // two consumer warpgroups and a producer warp
constexpr int SMEM_LIMIT = 232448 - 256;  // a CTA's shared memory, less the static barriers
constexpr int WINDOW = 14;     // SAM's window side: the one-pass path
constexpr uint32_t SLACK = 1024;  // the dynamic base's alignment to 1024 bytes

// The shared-memory plan of a launch, the same for every item.  A stage
// holds q (ND slots of 16 columns, qrows rows each), k and v (ND slots of
// krows rows each, loaded as boxes of kbox rows) and the two tables.
struct Plan {
  int T, G, ND;
  int qrows;        // q rows a work item: the whole pair (one pass) or 128
  int krows, kbox;  // rows of a k or v slot, rows a k/v box
  int items;        // work items: pairs x query blocks
  int blocks;       // query blocks a pair
  int stages;
  uint32_t qslot, kslot;       // bytes of a q slot, of a k or v slot
  uint32_t off_k, off_v, off_tab, tab;  // stage offsets; bytes of one table's room
  uint32_t stage, tx;          // bytes of a stage; bytes TMA brings a stage
};

struct Bars {
  uint64_t full[2], empty[2];
};

// The producer warp: every item of this CTA into its stage.  Lane 0 issues
// the TMA loads; on the one-pass path it also copies each table whole, on
// the general path the lanes load the item's table rows themselves.  The
// full barrier counts lane 0's expect_tx and each lane's arrival after its
// own stores.
template <bool ONEPASS>
__device__ __forceinline__ void produce(const CUtensorMap* tq, const CUtensorMap* tk,
                                        const CUtensorMap* tv, const bf16* __restrict__ rh,
                                        const bf16* __restrict__ rw, const Plan& p,
                                        uint32_t base, unsigned char* gbase, Bars& bars) {
  const int lane = threadIdx.x & 31;
  for (int i = 0, item = blockIdx.x; item < p.items; ++i, item += gridDim.x) {
    const int st = i % p.stages, round = i / p.stages;
    const int pair = item / p.blocks, q0 = (item % p.blocks) * p.qrows;
    const uint32_t sb = base + st * p.stage;
    hopper::mbar_wait(&bars.empty[st], (round & 1) ^ 1);  // a fresh barrier passes
    if (lane == 0) {
      hopper::mbar_expect_tx(&bars.full[st], p.tx);
      for (int b = 0; b < p.ND; ++b) {
        hopper::tma_load_3d(sb + b * p.qslot, tq, 16 * b, q0, pair, &bars.full[st]);
        for (int r = 0; r < p.krows; r += p.kbox) {
          hopper::tma_load_3d(sb + p.off_k + b * p.kslot + r * 32, tk, 16 * b, r, pair,
                              &bars.full[st]);
          hopper::tma_load_3d(sb + p.off_v + b * p.kslot + r * 32, tv, 16 * b, r, pair,
                              &bars.full[st]);
        }
      }
      if constexpr (ONEPASS) {
        const size_t off = (size_t)pair * p.T * p.G;
        hopper::bulk_load(sb + p.off_tab, rh + off, p.T * p.G * 2, &bars.full[st]);
        hopper::bulk_load(sb + p.off_tab + p.tab, rw + off, p.T * p.G * 2, &bars.full[st]);
      }
    }
    if constexpr (!ONEPASS) {
      const int n = min(p.qrows, p.T - q0) * p.G;
      const size_t off = ((size_t)pair * p.T + q0) * p.G;
      bf16* th = reinterpret_cast<bf16*>(gbase + st * p.stage + p.off_tab);
      bf16* tw = reinterpret_cast<bf16*>(gbase + st * p.stage + p.off_tab + p.tab);
      for (int e = lane; e < n; e += 32) {
        th[e] = rh[off + e];
        tw[e] = rw[off + e];
      }
    }
    hopper::mbar_arrive(&bars.full[st]);  // after this lane's stores
  }
}

// the bias of one thread's logits: N8 column groups of 8 keys from key k0
// (accumulator layout, hopper.cuh), th[h] and tw[h] the tables' rows of its
// two rows (bf16), keys past T masked
template <int N8, int GT>
__device__ __forceinline__ void window_bias(float* s, const bf16* const (&th)[2],
                                            const bf16* const (&tw)[2], int k0, int T, int G_rt) {
  const int G = GT ? GT : G_rt;
  const int t = threadIdx.x & 3;
  if constexpr (GT > 0 && GT % 2 == 0) {
    // a thread's two neighbouring keys (even, odd) share their grid row
    // and read two neighbouring rw entries: one division, one rh load and
    // one 4-byte rw load for both
#pragma unroll
    for (int j = 0; j < N8; ++j) {
      const int key = k0 + 8 * j + 2 * t;
      if (key < T) {
        const int kh = key / GT, kw = key - kh * GT;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float bh = __bfloat162float(th[h][kh]);
          const float2 bw = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(tw[h] + kw));
          s[4 * j + 2 * h] = s[4 * j + 2 * h] + bh + bw.x;
          s[4 * j + 2 * h + 1] = s[4 * j + 2 * h + 1] + bh + bw.y;
        }
      } else {
        s[4 * j] = s[4 * j + 1] = s[4 * j + 2] = s[4 * j + 3] = NEG_INF;
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4 * N8; ++i) {
    const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1), h = (i >> 1) & 1;
    if (key < T) {
      const int kh = key / G, kw = key - kh * G;
      s[i] = s[i] + __bfloat162float(th[h][kh]) + __bfloat162float(tw[h][kw]);
    } else {
      s[i] = NEG_INF;
    }
  }
}

// S (64 x 8 N8 keys from key row k0, accumulator layout) = the tile's q x k,
// one k16 step a 16-column box
template <int ND, int N8>
__device__ __forceinline__ void qk(float* s, uint32_t qs, uint32_t ks, const Plan& p, int k0) {
#pragma unroll
  for (int b = 0; b < ND; ++b) {
    const uint64_t dq = hopper::desc_sw32(qs + b * p.qslot, 16);
    const uint64_t dk = hopper::desc_sw32(ks + b * p.kslot + k0 * 32, 16);
    hopper::wgmma_ss<8 * N8>(*reinterpret_cast<float(*)[4 * N8]>(s), dq, dk, b > 0);
  }
}

// o (+)= P v over NK k16 steps of keys from key row k0; P as mma.sync A
// fragments, pr[4kk..4kk + 3] for keys k0 + 16kk..
template <int D, int NK>
__device__ __forceinline__ void pv(float (&o)[D / 2], const uint32_t* pr, uint32_t vs,
                                   const Plan& p, int k0, bool acc) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
    hopper::wgmma_rs<D>(o, pr[4 * kk], pr[4 * kk + 1], pr[4 * kk + 2], pr[4 * kk + 3],
                        hopper::desc_sw32(vs + (k0 + 16 * kk) * 32, p.kslot), acc || kk > 0);
}

template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
  hopper::reg_fence(*reinterpret_cast<float(*)[N]>(r));
}

template <int D, int GT>
__global__ void __launch_bounds__(THREADS, 1)
relpos_window_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const bf16* __restrict__ rh,
                   const bf16* __restrict__ rw, bf16* __restrict__ o, const Plan p) {
  constexpr bool ONEPASS = GT == WINDOW;
  __shared__ Bars bars;
  extern __shared__ unsigned char smem[];
  const uint32_t base = hopper::align1024(smem);
  unsigned char* gbase = smem + (base - smem_u32(smem));  // the same place, generic
  const int wg = hopper::warpgroup_index();
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&bars.full[i], 33);  // lane 0's expect_tx and the 32 lanes
      hopper::mbar_init(&bars.empty[i], 8);  // one arrival from each consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (wg == 2) {
    produce<ONEPASS>(&tq, &tk, &tv, rh, rw, p, base, gbase, bars);
    return;
  }
  const int T = ONEPASS ? WINDOW * WINDOW : p.T, G = ONEPASS ? WINDOW : p.G;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool lead = lane == 0;

  for (int i = 0, item = blockIdx.x; item < p.items; ++i, item += gridDim.x) {
    const int st = i % p.stages, round = i / p.stages;
    const int pair = item / p.blocks, q0 = (item % p.blocks) * p.qrows;
    const uint32_t sb = base + st * p.stage;
    unsigned char* gs = gbase + st * p.stage;
    hopper::mbar_wait(&bars.full[st], round & 1);
    const bf16* tabh = reinterpret_cast<const bf16*>(gs + p.off_tab);
    const bf16* tabw = reinterpret_cast<const bf16*>(gs + p.off_tab + p.tab);

    // On the one-pass path the last tile (m = 3, rows 192..255) reads only
    // rows 192..199 from its q slot of 200 rows: a wgmma A operand is 64
    // rows, and 256-row slots would not leave room for two stages.  Its rows
    // 200..255 come from the next slot's first 56 rows (of the k region for
    // the last slot), which warpgroup 0 may be overwriting with tile 0's
    // staged o meanwhile.  Harmless: the rows of a product do not mix, and
    // rows past T = 196 are never stored.
    for (int m = wg; 64 * m < p.qrows && q0 + 64 * m < T; m += 2) {
      const int rl = 64 * m + 16 * warp + g;  // this thread's rows rl, rl + 8 in the item
      const uint32_t qs = sb + 64 * m * 32, ks = sb + p.off_k, vs = sb + p.off_v;
      // the tables' rows of this thread's rows; a row past T (only the last
      // tile has any, and its output is never stored) reads the last row's
      const int last = min(p.qrows, T - q0) - 1;
      const bf16* const th[2] = {tabh + min(rl, last) * G, tabh + min(rl + 8, last) * G};
      const bf16* const tw[2] = {tabw + min(rl, last) * G, tabw + min(rl + 8, last) * G};
      float o_acc[D / 2];
      if constexpr (ONEPASS) {
        // logits of all 196 keys: three 64-key chunks and an 8-key tail
        float s[100];
        fence_regs<100>(s);
        hopper::wgmma_fence();
#pragma unroll
        for (int c = 0; c < 3; ++c) qk<D / 16, 8>(s + 32 * c, qs, ks, p, 64 * c);
        qk<D / 16, 1>(s + 96, qs, ks, p, 192);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        fence_regs<100>(s);
        window_bias<25, WINDOW>(s, th, tw, 0, T, G);
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int j = 0; j < 100; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
        mx[0] = quad_max(mx[0]);
        mx[1] = quad_max(mx[1]);
        float l[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 100; ++j) {
          s[j] = hopper::ex2(s[j] - mx[(j >> 1) & 1]);
          l[(j >> 1) & 1] += s[j];
        }
        const float inv[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
        // P, normalised then rounded: 13 k16 steps, keys 196..207 zero
        uint32_t pr[52];
#pragma unroll
        for (int j = 0; j < 25; ++j) {
          pr[2 * j] = pack_bf16(s[4 * j] * inv[0], s[4 * j + 1] * inv[0]);
          pr[2 * j + 1] = pack_bf16(s[4 * j + 2] * inv[1], s[4 * j + 3] * inv[1]);
        }
        pr[50] = pr[51] = 0u;
        hopper::reg_fence(pr);
        hopper::wgmma_fence();
        pv<D, 13>(o_acc, pr, vs, p, 0, false);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::reg_fence(o_acc);
        hopper::reg_fence(pr);
      } else {
        // sweep 1: the row maximum and sum, online over 64-key chunks
        const int n_ch = p.krows / 64;
        float mr[2] = {NEG_INF, NEG_INF}, lr[2] = {0.f, 0.f};
        for (int c = 0; c < n_ch; ++c) {
          float s[32];
          fence_regs<32>(s);
          hopper::wgmma_fence();
          qk<D / 16, 8>(s, qs, ks, p, 64 * c);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          fence_regs<32>(s);
          window_bias<8, 0>(s, th, tw, 64 * c, T, G);
          float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
          for (int j = 0; j < 32; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float mn = fmaxf(mr[h], quad_max(mx[h]));
            float ps = 0.f;
#pragma unroll
            for (int j = 0; j < 16; ++j)
              ps += hopper::ex2(s[4 * (j >> 1) + 2 * h + (j & 1)] - mn);
            lr[h] = lr[h] * hopper::ex2(mr[h] - mn) + ps;
            mr[h] = mn;
          }
        }
        const float inv[2] = {1.f / quad_sum(lr[0]), 1.f / quad_sum(lr[1])};
        // sweep 2: p normalised, rounded, times v
#pragma unroll
        for (int j = 0; j < D / 2; ++j) o_acc[j] = 0.f;
        for (int c = 0; c < n_ch; ++c) {
          float s[32];
          fence_regs<32>(s);
          hopper::wgmma_fence();
          qk<D / 16, 8>(s, qs, ks, p, 64 * c);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          fence_regs<32>(s);
          window_bias<8, 0>(s, th, tw, 64 * c, T, G);
          uint32_t pr[16];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            pr[2 * j] = pack_bf16(hopper::ex2(s[4 * j] - mr[0]) * inv[0],
                                  hopper::ex2(s[4 * j + 1] - mr[0]) * inv[0]);
            pr[2 * j + 1] = pack_bf16(hopper::ex2(s[4 * j + 2] - mr[1]) * inv[1],
                                      hopper::ex2(s[4 * j + 3] - mr[1]) * inv[1]);
          }
          hopper::reg_fence(pr);
          hopper::reg_fence(o_acc);
          hopper::wgmma_fence();
          pv<D, 4>(o_acc, pr, vs, p, 64 * c, true);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::reg_fence(o_acc);
          hopper::reg_fence(pr);
        }
      }

      // o through this tile's q rows (its wgmma reads are complete), then
      // 16 bytes a thread, D / 8 threads a row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rl + 8 * h;
        if (q0 + r >= T) continue;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(gs + (j >> 1) * p.qslot + r * 32 + (j & 1) * 16 +
                                            4 * t) =
              __floats2bfloat162_rn(o_acc[4 * j + 2 * h], o_acc[4 * j + 2 * h + 1]);
      }
      hopper::bar_sync(2 + wg, 128);  // this tile's rows are staged
      bf16* ob = o + ((size_t)pair * T + q0 + 64 * m) * D;
      for (int e = threadIdx.x & 127; e < 64 * (D / 8); e += 128) {
        const int r = e / (D / 8), c8 = e % (D / 8);
        if (q0 + 64 * m + r < T)
          *reinterpret_cast<uint4*>(ob + (size_t)r * D + 8 * c8) = *reinterpret_cast<const uint4*>(
              gs + (c8 >> 1) * p.qslot + (64 * m + r) * 32 + (c8 & 1) * 16);
      }
    }
    // this warp is done with the stage: its reads before the next TMA writes
    hopper::fence_proxy_async();
    __syncwarp();
    if (lead) hopper::mbar_arrive(&bars.empty[st]);
  }
}

uint32_t round_up(uint32_t x, uint32_t m) { return (x + m - 1) / m * m; }

// The stage layout of a launch; false if no stage fits shared memory
bool make_plan(Plan& p, int BH, int T, int G, int D) {
  const bool onepass = G == WINDOW;
  p.T = T;
  p.G = G;
  p.ND = D / 16;
  p.qrows = onepass ? 200 : 128;  // the one pass: 196 rows and the 8-row tail
  p.krows = onepass ? 200 : (int)round_up(T, 64);
  p.kbox = p.krows <= 256 ? p.krows : p.krows / 2;
  p.blocks = onepass ? 1 : (T + 127) / 128;
  p.items = BH * p.blocks;
  p.qslot = p.qrows * 32;
  p.kslot = p.krows * 32;
  p.off_k = p.ND * p.qslot;
  p.off_v = p.off_k + p.ND * p.kslot;
  p.off_tab = p.off_v + p.ND * p.kslot;
  p.tab = round_up((onepass ? T : p.qrows) * G * 2, 128);
  p.stage = round_up(p.off_tab + 2 * p.tab, 256);
  p.tx = p.ND * (p.qslot + 2 * p.kslot) + (onepass ? 2 * T * G * 2 : 0);
  p.stages = 2 * p.stage + SLACK <= (uint32_t)SMEM_LIMIT ? 2 : 1;
  return p.stage + SLACK <= (uint32_t)SMEM_LIMIT;
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
  Plan p;
  if (!make_plan(p, BH, T, G, D)) return (int)cudaErrorInvalidValue;
  const int smem = p.stages * p.stage + SLACK;
  auto kern = relpos_window_bf16<D, GT>;
  // the one-pass path's shared memory is the same at every launch, so it
  // asks the runtime once; the general path's varies with T
  static const int onepass_ctas = GT == WINDOW ? resident_ctas(kern, smem) : 0;
  const int ctas = GT == WINDOW ? onepass_ctas : resident_ctas(kern, smem);
  if (ctas < 0) return -ctas;
  CUtensorMap tq, tk, tv;
  cudaError_t e = hopper::tensor_map_3d(&tq, q, D, T, BH, p.qrows, 16);
  if (e == cudaSuccess) e = hopper::tensor_map_3d(&tk, k, D, T, BH, p.kbox, 16);
  if (e == cudaSuccess) e = hopper::tensor_map_3d(&tv, v, D, T, BH, p.kbox, 16);
  if (e != cudaSuccess) return (int)e;
  kern<<<min(p.items, ctas), THREADS, smem, st>>>(tq, tk, tv, (const bf16*)rh, (const bf16*)rw,
                                                  (bf16*)o, p);
  return (int)cudaGetLastError();
}

// SAM's window side on the one-pass path, any other on the general one
template <int D>
int launch(const void* q, const void* k, const void* v, const void* rh, const void* rw, void* o,
           int BH, int T, int G, cudaStream_t st) {
  if (G == WINDOW) return launch_g<D, WINDOW>(q, k, v, rh, rw, o, BH, T, G, st);
  return launch_g<D, 0>(q, k, v, rh, rw, o, BH, T, G, st);
}

}  // namespace

// q (BH, T, D) pre-scaled, k/v (BH, T, D), rh/rw (BH, T, G), o like q;
// T == G*G <= 512.  bf16 takes D in {16, 32, 64, 80, 128} where a stage
// fits shared memory (all but D = 128 at T > 256), float32 any D <= 128.
// Returns the launch's cudaError_t.
extern "C" int relpos_window(const void* q, const void* k, const void* v, const void* rh,
                             const void* rw, void* o, int BH, int T, int G, int D, int is_bf16,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (T > 512 || T != G * G) return (int)cudaErrorInvalidValue;
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

extern "C" const char* relpos_window_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
