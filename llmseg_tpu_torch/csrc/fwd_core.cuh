// The forward-attention core for Hopper, on hopper.cuh's primitives.
// Kernels A (flash_fwd.cu) and J (flash_fwd_1pass_t.cu) run on it; each
// brings its own probability step (a Softmax policy) and epilogue.
//
// A CTA owns BQ = 128 queries of one head and runs nine warps:
//   * a producer warp: its first thread loads the q block once and then
//     streams 128-key tiles of k and v by TMA through a ring of STAGES
//     stages.  Each stage has a full barrier for k, one for v (so S = q k^T
//     may start before v has landed) and an empty barrier that the eight
//     consumer warps release.
//   * warpgroups 0 and 1, the consumers, 64 query rows each: S = q k^T as
//     wgmma m64n128k16 from shared memory (D / 16 k-steps), the policy's
//     probability step on S in registers, then O += P v with P from
//     registers (8 k-steps of m64nDk16, v MN-major).
// Schedule of a consumer over tiles j at D = 64 (FlashAttention-3's
// intra-warpgroup overlap): start S_j and the previous tile's P_{j-1}
// v_{j-1} together, wait for S_j only, compute P_j's floats while the PV
// product runs, then wait for it, release the stage, let the policy rescale
// O and pack P_j to bf16.  At D = 128 (see OVERLAPS) one tile's S, softmax
// and PV run in turn.  Either way the two consumers run unsynchronised, so
// one warpgroup's exp2 pass overlaps the other's tensor-core work as the
// warp schedulers interleave them.  (Strict turns, FA3's ping-pong on two
// named barriers, measured slower for both kernels on the H100.)
//
// Softmax policy: scores(float (&s)[64], int tile) turns this thread's
// logits of a tile (accumulator layout, hopper.cuh) into probabilities in
// place; rescale(float (&o)[D / 2]) then scales the output rows (kernel A's
// alpha; nothing for J).  A policy with ROWSUM set also gets the row sums of
// the bf16-rounded P from the tensor cores: each PV step adds P x ones
// (m64n8k16) into its lsum[4], from a 2 KB block of ones the kernel writes
// once (write_ones), as the TPU kernel's valid lane sums P in its product.
#pragma once

#include "hopper.cuh"

namespace llmseg {
namespace hopper {

// Two consumer warpgroups (threads 0..255) and one producer warp (256..287).
// ptxas grants a CTA of more than 8 warps at most 168 registers a thread
// (measured: with 384 threads and setmaxnreg.inc to 240 for the consumers
// too, and with -maxrregcount=224 at 288), so the consumers plan for 168.
constexpr int FWD_THREADS = 288;
constexpr int PRODUCER_THREAD = 256;

// Shared memory of a CTA from a 1024-aligned base: the q block (NB boxes of
// BQ lines), then STAGES k tiles, then STAGES v tiles (NB boxes of BN lines
// each); the kernel's own space starts at BYTES.
template <int D>
struct FwdLayout {
  static constexpr int BQ = 128, BN = 128;
  static constexpr int NB = D / 64;
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr uint32_t QBOX = BQ * 128, KBOX = BN * 128;
  static constexpr uint32_t QBYTES = NB * QBOX, TILE = NB * KBOX;
  static constexpr uint32_t OFF_K = QBYTES;
  static constexpr uint32_t OFF_V = OFF_K + STAGES * TILE;
  static constexpr uint32_t BYTES = OFF_V + STAGES * TILE;
};

struct FwdBars {
  uint64_t q, full_k[3], full_v[3], empty[3];
};

// The block of ones of a ROWSUM policy: 16 lines of 128 bytes, every 16-byte
// chunk (1, 0, ..., 0) in bf16, so that any line and any swizzle phase
// reads column 0 as 1 and columns 1..7 as 0: one k16 step of an MN-major
// B with N = 8, reused for every step.  By the consumer threads, before
// the barrier that precedes their first PV product.
constexpr uint32_t ONES_BYTES = 2048;
__device__ __forceinline__ void write_ones(unsigned char* ones) {
  if (threadIdx.x < ONES_BYTES / 16)
    reinterpret_cast<uint4*>(ones)[threadIdx.x] = make_uint4(0x3F80u, 0u, 0u, 0u);
  fence_proxy_async();
}

// by one thread, before the __syncthreads that precedes the split
__device__ __forceinline__ void init_bars(FwdBars& b) {
  mbar_init(&b.q, 1);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    mbar_init(&b.full_k[i], 1);
    mbar_init(&b.full_v[i], 1);
    mbar_init(&b.empty[i], 8);  // one arrival from each consumer warp
  }
  mbar_init_fence();
}

// The producer thread: q rows q0.. of head bh, then n_tiles tiles of k and v.
template <int D>
__device__ __forceinline__ void produce(const CUtensorMap* tq, const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint32_t base, FwdBars& b, int q0,
                                        int bh, int n_tiles) {
  using L = FwdLayout<D>;
  mbar_expect_tx(&b.q, L::QBYTES);
#pragma unroll
  for (int nb = 0; nb < L::NB; ++nb) tma_load_3d(base + nb * L::QBOX, tq, nb * 64, q0, bh, &b.q);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % L::STAGES, round = j / L::STAGES;
    mbar_wait(&b.empty[st], (round & 1) ^ 1);  // a fresh barrier passes
    mbar_expect_tx(&b.full_k[st], L::TILE);
#pragma unroll
    for (int nb = 0; nb < L::NB; ++nb)
      tma_load_3d(base + L::OFF_K + st * L::TILE + nb * L::KBOX, tk, nb * 64, j * L::BN, bh,
                  &b.full_k[st]);
    mbar_expect_tx(&b.full_v[st], L::TILE);
#pragma unroll
    for (int nb = 0; nb < L::NB; ++nb)
      tma_load_3d(base + L::OFF_V + st * L::TILE + nb * L::KBOX, tv, nb * 64, j * L::BN, bh,
                  &b.full_v[st]);
  }
}

// Whether a consumer keeps S_j and the PV product of tile j - 1 in flight
// together: the registers of S, P and O at once (160 at D = 128) do not fit
// in 168 (ptxas spills and serialises the wgmma, C7512), so D = 128 runs S,
// softmax, PV one after another and overlaps across the two warpgroups only.
template <int D>
constexpr bool OVERLAPS = D == 64;

// One consumer warpgroup (wg = 0 or 1, rows 64 wg .. of the q block) over
// all n_tiles >= 1 tiles; o (accumulator layout) = sum over tiles of P v,
// rescaled by the policy as it goes.
template <int D, class Softmax>
__device__ __forceinline__ void consume(uint32_t base, FwdBars& b, int wg, int n_tiles,
                                        Softmax& sm, float (&o)[D / 2], uint32_t ones = 0) {
  using L = FwdLayout<D>;
  constexpr int NS = L::STAGES;
  const bool lead = (threadIdx.x & 31) == 0;
  const uint32_t qs = base + wg * 64 * 128;
  float s[64];
  uint32_t p[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = 0u;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  if constexpr (Softmax::ROWSUM) sm.lsum[0] = sm.lsum[1] = sm.lsum[2] = sm.lsum[3] = 0.f;
  auto fence_acc = [&]() {
    reg_fence(o);
    if constexpr (Softmax::ROWSUM) reg_fence(sm.lsum);
  };

  auto qk = [&](int st) {
    const uint32_t ks = base + L::OFF_K + st * L::TILE;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<128>(s, desc_kmajor(qs + (kk / 4) * L::QBOX + (kk % 4) * 32),
                    desc_kmajor(ks + (kk / 4) * L::KBOX + (kk % 4) * 32), kk > 0);
  };
  auto pv = [&](int st) {
    const uint32_t vs = base + L::OFF_V + st * L::TILE;
#pragma unroll
    for (int kk = 0; kk < L::BN / 16; ++kk)
      wgmma_rs<D>(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                  desc_mnmajor(vs + kk * 16 * 128, L::KBOX), 1);
    if constexpr (Softmax::ROWSUM) {
#pragma unroll
      for (int kk = 0; kk < L::BN / 16; ++kk)
        wgmma_rs<8>(sm.lsum, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                    desc_mnmajor(ones, L::KBOX), 1);
    }
  };
  // P as mma.sync A fragments: p[4kk..4kk+3] for keys 16kk.., rows g, g + 8
  auto pack = [&]() {
#pragma unroll
    for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
  };

  mbar_wait(&b.q, 0);
  if constexpr (!OVERLAPS<D>) {
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % NS, ph = (j / NS) & 1;
      mbar_wait(&b.full_k[st], ph);
      reg_fence(s);
      wgmma_fence();
      qk(st);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);
      sm.scores(s, j);
      sm.rescale(o);
      pack();
      mbar_wait(&b.full_v[st], ph);
      fence_acc();
      reg_fence(p);
      wgmma_fence();
      pv(st);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc();
      reg_fence(p);
      if (lead) mbar_arrive(&b.empty[st]);
    }
  } else {
    mbar_wait(&b.full_k[0], 0);
    reg_fence(s);
    wgmma_fence();
    qk(0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    sm.scores(s, 0);
    pack();

    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % NS, pst = (j - 1) % NS;
      mbar_wait(&b.full_k[st], (j / NS) & 1);
      mbar_wait(&b.full_v[pst], ((j - 1) / NS) & 1);
      reg_fence(s);
      fence_acc();
      reg_fence(p);
      wgmma_fence();
      qk(st);
      wgmma_commit();
      pv(pst);
      wgmma_commit();
      wgmma_wait<1>();  // S_j is in; P_{j-1} v still runs
      reg_fence(s);
      sm.scores(s, j);
      reg_fence(s);  // keeps the exp2 pass above the wait: it is what overlaps the product
      wgmma_wait<0>();
      fence_acc();
      reg_fence(p);  // P_{j-1}'s registers stay untouched until here
      if (lead) mbar_arrive(&b.empty[pst]);
      sm.rescale(o);
      pack();
    }

    const int last = n_tiles - 1, lst = last % NS;
    mbar_wait(&b.full_v[lst], (last / NS) & 1);
    fence_acc();
    reg_fence(p);
    wgmma_fence();
    pv(lst);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc();
    reg_fence(p);
    if (lead) mbar_arrive(&b.empty[lst]);
  }
}

}  // namespace hopper
}  // namespace llmseg
