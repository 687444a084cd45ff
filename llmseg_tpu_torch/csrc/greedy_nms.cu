// Greedy box NMS on the card (the port's own kernel; replaces the fixpoint
// iteration of llmseg_tpu_torch/ops/nms.py, itself the form of
// llmseg_tpu/ops/nms.py).
//
// The result is the greedy one: in the order of the scores (sorted stably
// by the caller, so ties keep index order), a valid box is kept unless a
// kept box before it overlaps it by an IoU above the threshold; invalid
// boxes (score -inf) are never kept and never suppress.  The fixpoint
// iteration computes the same set, but tests for its end on the host after
// every step, which makes the caller wait for the card.  Two launches here,
// neither of which waits for the host:
//   greedy_nms_mask   one 64-thread CTA for each 64 x 64 block of (row,
//                     column) pairs on or above the diagonal: thread t of
//                     row block r writes word c of row 64 r + t, bit j set
//                     where the later box 64 c + j overlaps it above the
//                     threshold (an N x ceil(N / 64) bitmask, words below
//                     the diagonal left unwritten and never read);
//   greedy_nms_sweep  one CTA over the sorted boxes, 64 at a time: one
//                     thread deciding the block's 64 boxes in order against
//                     the removed bits (a kept box ORs its diagonal word,
//                     staged in shared memory, in at once), then every
//                     thread ORing the kept boxes' later words into the
//                     removed bits while the next block's diagonal words
//                     are staged, and the decisions written to the output
//                     in the boxes' original order.
//
// Every comparison decides as ops/nms.py's box_iou and `iou > threshold`
// do: the IoU is float32 in the same order of operations (each area the
// product of the clamped sides, the intersection the product of the
// clamped overlaps, the union (area_a + area_b) - intersection, the
// quotient where the union is positive and 0 elsewhere), every product,
// sum and quotient an IEEE-rounded intrinsic so that nvcc cannot contract
// them into an FMA, built without --use_fast_math; max and min propagate a
// NaN as torch.maximum and torch.minimum do; the threshold arrives as the
// float32 that torch compares a float32 tensor with.
//
// What bounds it: latency.  At AMG's 3072 candidates the mask is 4.7 M
// IoUs (1.2 MB) and the sweep 48 blocks of a few dependent steps each.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WORD = 64;
constexpr int SWEEP_THREADS = 1024;
constexpr size_t MAX_SWEEP_SMEM = 48 * 1024;   // removed bits: N up to 393,216

__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }  // NaN stays
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(clamp0(__fsub_rn(b.z, b.x)), clamp0(__fsub_rn(b.w, b.y)));
}

// box_iou(a, b)'s element, a the later box (the row of the fixpoint's
// suppression matrix), b the earlier one
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b, float area_b,
                                         float thr) {
  const float w = clamp0(__fsub_rn(tmin(a.z, b.z), tmax(a.x, b.x)));
  const float h = clamp0(__fsub_rn(tmin(a.w, b.w), tmax(a.y, b.y)));
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  const float iou = uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
  return iou > thr;
}

__device__ __forceinline__ float4 load_box(const float* boxes, long long i) {
  const float* p = boxes + 4 * i;
  return make_float4(p[0], p[1], p[2], p[3]);
}

__global__ void greedy_nms_mask(const float* __restrict__ boxes,
                                const long long* __restrict__ order,
                                unsigned long long* __restrict__ mask, int n, int words,
                                float thr) {
  const int cb = blockIdx.x, rb = blockIdx.y;
  if (cb < rb) return;
  __shared__ float4 cols[WORD];
  __shared__ float col_area[WORD];
  const int t = threadIdx.x;
  const int j0 = cb * WORD, i = rb * WORD + t;
  if (j0 + t < n) {
    cols[t] = load_box(boxes, order[j0 + t]);
    col_area[t] = area(cols[t]);
  }
  __syncthreads();
  if (i >= n) return;
  const float4 a = load_box(boxes, order[i]);
  const float area_a = area(a);
  const int cnt = min(WORD, n - j0);
  unsigned long long bits = 0ull;
  for (int c = 0; c < cnt; ++c)
    if (j0 + c > i && overlaps(cols[c], col_area[c], a, area_a, thr)) bits |= 1ull << c;
  mask[(size_t)i * words + cb] = bits;
}

__global__ void greedy_nms_sweep(const unsigned long long* __restrict__ mask,
                                 const float* __restrict__ scores,
                                 const long long* __restrict__ order, bool* __restrict__ keep,
                                 int n, int words) {
  extern __shared__ unsigned long long removed[];
  __shared__ unsigned long long diag[2][WORD];   // this block's diagonal words, the next's
  __shared__ unsigned long long kept_word;
  const int t = threadIdx.x;
  for (int w = t; w < words; w += blockDim.x) removed[w] = 0ull;
  if (t < min(WORD, n)) diag[0][t] = mask[(size_t)t * words];
  __syncthreads();
  for (int i = t; i < n; i += blockDim.x)   // invalid: removed from the start
    if (!(scores[order[i]] > -INFINITY)) atomicOr(&removed[i / WORD], 1ull << (i % WORD));
  __syncthreads();
  for (int b = 0; b < words; ++b) {
    const int base = b * WORD, cnt = min(WORD, n - base);
    if (t == 0) {
      const unsigned long long* d = diag[b & 1];
      unsigned long long rem = removed[b], kept = 0ull;
#pragma unroll 8
      for (int r = 0; r < cnt; ++r)
        if (!((rem >> r) & 1ull)) {
          kept |= 1ull << r;
          rem |= d[r];
        }
      kept_word = kept;
    }
    __syncthreads();
    const unsigned long long kept = kept_word;
    if (t < cnt) keep[order[base + t]] = (kept >> t) & 1ull;
    const int later = words - b - 1;
    if (later > 0 && t < min(WORD, n - base - WORD))   // the next block's diagonal, early
      diag[(b + 1) & 1][t] = mask[(size_t)(base + WORD + t) * words + b + 1];
    if (kept && later > 0)
      for (int p = t; p < cnt * later; p += blockDim.x) {
        const int r = p / later, w = b + 1 + p % later;
        if ((kept >> r) & 1ull) atomicOr(&removed[w], mask[(size_t)(base + r) * words + w]);
      }
    __syncthreads();
  }
}

}  // namespace

// boxes (N, 4) float32 xyxy and scores (N,) float32 (-inf where invalid) in
// the caller's order; order (N,) int64, the stable descending sort of the
// scores; mask (N, ceil(N / 64)) uint64 scratch; keep (N,) bool, written
// whole in the caller's order.  One C call, counted as one launch.
extern "C" int greedy_nms(const void* boxes, const void* scores, const void* order, void* mask,
                          void* keep, int n, float thr, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaErrorInvalidValue;   // the wrapper launches none
  const int words = (n + WORD - 1) / WORD;
  const size_t smem = (size_t)words * sizeof(unsigned long long);
  if (smem > MAX_SWEEP_SMEM) return (int)cudaErrorInvalidValue;
  greedy_nms_mask<<<dim3(words, words), WORD, 0, st>>>(
      (const float*)boxes, (const long long*)order, (unsigned long long*)mask, n, words, thr);
  greedy_nms_sweep<<<1, SWEEP_THREADS, smem, st>>>(
      (const unsigned long long*)mask, (const float*)scores, (const long long*)order,
      (bool*)keep, n, words);
  return (int)cudaGetLastError();
}

extern "C" const char* greedy_nms_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
