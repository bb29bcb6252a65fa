// Greedy NMS kernels for NVIDIA Hopper (sm_90a), with a plain C interface
// bound from Python through ctypes (multigriddet_tpu_torch/ops/cuda_nms.py).
//
//   popmax_nms_kernel   replaces  _popmax_kernel / pallas_popmax_nms
//                       (multigriddet_tpu/ops/pallas_nms.py:115-247)
//   greedy_mask_kernel  replace   _nms_sweep_kernel / pallas_greedy_nms
//   greedy_scan_kernel            (multigriddet_tpu/ops/pallas_nms.py:34-112)
//
// Greedy NMS is serial by definition: box j survives exactly when no earlier
// survivor overlaps it at or above the threshold.  On this card the work is
// tiny (a few million overlap tests, a few megabytes: the bound is a few
// microseconds of float32 arithmetic) and the time goes to dependent steps,
// each ending in a barrier.  Both designs cut the number of such steps:
// they resolve 64 candidates per step with 64-bit suppression words, whose
// bits are filled in parallel beforehand, and the pop-max kernel sorts
// only the head of its pool, so its steps stop near max_boxes keeps.
//
// The overlap arithmetic follows the Pallas kernels' float32 expressions
// operation by operation; the library is built with -fmad=false so that
// nvcc does not contract a*b+c into an FMA, whose single rounding could
// flip a keep decision at the threshold edge.  Suppression is inclusive
// (overlap >= threshold), both denominators carry +1e-8, and the earlier
// (kept) box is always the first argument of suppresses().

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

typedef unsigned long long u64;

constexpr float kNeg = -1e9f;      // dead score (NEG in the Pallas kernels)
constexpr int kThreads = 1024;     // pop-max block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;         // candidates resolved per serial step
constexpr int kMaskThreads = 256;  // greedy mask block: 64 rows x 4
constexpr int kScanThreads = 512;  // greedy scan block
constexpr u64 kPadKey = ~0ull;     // sorts after every candidate's key

// Whether box i = (x, y, w, h) suppresses box j: its overlap with j, IoU
// or IoL (intersection over the larger area), optionally minus the DIoU
// centre-distance penalty, reaches the threshold.  The penalty is never
// negative (a square sum over a positive denominator, or NaN), so a ratio
// below the threshold decides alone and the penalty is skipped: the
// decision is the same as with the full expression.
__device__ __forceinline__ bool suppresses(const float4& i, const float4& j,
                                           float threshold, bool use_iol,
                                           bool diou) {
  const float area_i = i.z * i.w;
  const float iw = fmaxf(0.0f, fminf(i.x + i.z, j.x + j.z) - fmaxf(i.x, j.x));
  const float ih = fmaxf(0.0f, fminf(i.y + i.w, j.y + j.w) - fmaxf(i.y, j.y));
  const float inter = iw * ih;
  const float area_j = j.z * j.w;
  const float ov = use_iol ? inter / (fmaxf(area_i, area_j) + 1e-8f)
                           : inter / (area_i + area_j - inter + 1e-8f);
  if (!diou || !(ov >= threshold)) return ov >= threshold;
  const float dx = i.x + i.z / 2.0f - j.x - j.z / 2.0f;
  const float dy = i.y + i.w / 2.0f - j.y - j.w / 2.0f;
  const float cdist = dx * dx + dy * dy;
  const float ex = fmaxf(i.x + i.z, j.x + j.z) - fminf(i.x, j.x);
  const float ey = fmaxf(i.y + i.w, j.y + j.w) - fminf(i.y, j.y);
  return ov - cdist / (ex * ex + ey * ey + 1e-8f) >= threshold;
}

__device__ __forceinline__ float4 load_box(const float* boxes, int j) {
  return make_float4(boxes[4 * j + 0], boxes[4 * j + 1], boxes[4 * j + 2],
                     boxes[4 * j + 3]);
}

// ---------------------------------------------------------------------------
// shared pieces: the sort key, the bitonic sort, the resolution of 64 rows
// ---------------------------------------------------------------------------

// Ascending 64-bit key of a live candidate: the score, descending, in the
// high word and the flat index, ascending, in the low word, so the sorted
// order is the pop order (larger score first, lower index on equal scores).
// -0.0 is taken as +0.0 first: the pop treats the two as equal.
__device__ __forceinline__ u64 sort_key(float s, int j) {
  unsigned int u = __float_as_uint(s);
  if ((u << 1) == 0u) u = 0u;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // order-preserving map
  return (static_cast<u64>(~u) << 32) | static_cast<unsigned int>(j);
}

// Key slot of sorted position i: one pad slot every 32 keys spreads the
// strided accesses of the sort over the shared-memory banks.
__device__ __forceinline__ int slot(int i) { return i + (i >> 5); }

template <int Q>
__device__ __forceinline__ void bitonic_stage(u64 (&v)[8], int base, int s,
                                              int k) {
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    if (t & (1 << Q)) continue;
    const int u = t | (1 << Q);
    const bool ascending = ((base + t * s) & k) == 0;
    if ((v[t] > v[u]) == ascending) {
      const u64 x = v[t];
      v[t] = v[u];
      v[u] = x;
    }
  }
}

// The stages of strides 2^top .. 2^max(top-2, 0) of the bitonic merge of
// blocks of k keys: each thread takes a group of 8 keys that differ only in
// the stride bits, so three stages cost one trip through shared memory.
__device__ void bitonic_round(u64* keys, int p, int k, int top) {
  const int low = top >= 2 ? top - 2 : 0;
  const int s = 1 << low;
  const int stages = top - low + 1;
  for (int g = threadIdx.x; g < (p >> 3); g += kThreads) {
    const int base = (g & (s - 1)) | ((g >> low) << (low + 3));
    u64 v[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = keys[slot(base + t * s)];
    if (stages == 3) bitonic_stage<2>(v, base, s, k);
    if (stages >= 2) bitonic_stage<1>(v, base, s, k);
    bitonic_stage<0>(v, base, s, k);
#pragma unroll
    for (int t = 0; t < 8; ++t) keys[slot(base + t * s)] = v[t];
  }
}

// Ascending bitonic sort of p keys (p a power of two >= 8), whole block.
__device__ void block_sort(u64* keys, int p) {
  for (int k = 2; k <= p; k <<= 1) {
    for (int top = 31 - __clz(k) - 1; top >= 0; top -= 3) {
      bitonic_round(keys, p, k, top);
      __syncthreads();
    }
  }
}

// Greedy resolution of 64 rows in order, run alike by every lane of a
// warp.  removed: the rows' bits removed on entry; row_lo / row_hi: this
// lane's words of rows lane and lane + 32 (bit t of row i set when box i
// suppresses box t > i).  Row i is applied only if bit i is still clear
// when its turn comes; the serial chain is 64 steps of two 32-bit
// operations, the row words arriving by shuffle off the chain.  Returns the
// kept bits.
__device__ __forceinline__ u64 resolve_rows(u64 removed, u64 row_lo,
                                            u64 row_hi) {
  unsigned int lo = static_cast<unsigned int>(removed);
  unsigned int hi = static_cast<unsigned int>(removed >> 32);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const u64 w = __shfl_sync(0xffffffffu, row_lo, i);
    if (!((lo >> i) & 1u)) {
      lo |= static_cast<unsigned int>(w);
      hi |= static_cast<unsigned int>(w >> 32);
    }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const unsigned int w =
        static_cast<unsigned int>(__shfl_sync(0xffffffffu, row_hi, i) >> 32);
    if (!((hi >> i) & 1u)) hi |= w;
  }
  return ~((static_cast<u64>(hi) << 32) | lo);
}

// ---------------------------------------------------------------------------
// pop-max NMS: sort the head of the pool, then sweep it in chunks of 64
// ---------------------------------------------------------------------------

constexpr int kHistBins = 4096;     // 12 bits of the score word a pass
constexpr int kHeadTarget = 512;    // keys the select aims for
constexpr int kHeadCap = 2048;      // keys the head array holds

// (score, index) order of the pop: the larger score wins, and on equal
// scores the lower index wins (a stable descending sort's order).
__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& s, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, s, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(os, oi, s, i)) {
      s = os;
      i = oi;
    }
  }
}

// Block-wide argmax; the winner lands in *top_s / *top_i for every thread
// after the second barrier.
__device__ __forceinline__ void block_argmax(float s, int i, float* red_s,
                                             int* red_i, float* top_s,
                                             int* top_i) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_argmax(s, i);
  if (lane == 0) {
    red_s[warp] = s;
    red_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < kWarps ? red_s[lane] : -INFINITY;
    i = lane < kWarps ? red_i[lane] : INT_MAX;
    warp_argmax(s, i);
    if (lane == 0) {
      *top_s = s;
      *top_i = i;
    }
  }
  __syncthreads();
}

// Exclusive prefix sum of one int a thread over the block.
__device__ int block_exclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_sums[lane];
    int z = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, z, off);
      if (lane >= off) z += y;
    }
    warp_sums[lane] = z - w;
  }
  __syncthreads();
  return warp_sums[warp] + x - v;
}

// The first bin of hist[kHistBins] at which the running count reaches need
// (the total holds at least need) into *bin, the count of the earlier bins
// into *before.
__device__ void find_bin(const unsigned int* hist, int need, int* warp_sums,
                         int* bin, int* before) {
  const int t = threadIdx.x;  // kHistBins / kThreads = 4 bins a thread
  int h[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) h[u] = hist[4 * t + u];
  const int sum = h[0] + h[1] + h[2] + h[3];
  int c = block_exclusive_scan(sum, warp_sums);
  if (c < need && c + sum >= need) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c + h[u] >= need) {
        *bin = 4 * t + u;
        *before = c;
        break;
      }
      c += h[u];
    }
  }
  __syncthreads();
}

// Warp-aggregated append of key to out[slot(*count + ...)] where take.
__device__ __forceinline__ void append_key(u64* out, int* count, bool take,
                                           u64 key) {
  const int lane = threadIdx.x & 31;
  const unsigned int ballot = __ballot_sync(0xffffffffu, take);
  int at = 0;
  if (lane == 0 && ballot) at = atomicAdd(count, __popc(ballot));
  at = __shfl_sync(0xffffffffu, at, 0);
  if (take) out[slot(at + __popc(ballot & ((1u << lane) - 1u)))] = key;
}

// Threads 32..95 gather sorted positions start.. start+63 (below avail) of
// list: each candidate's box and flat index.
__device__ __forceinline__ void gather_chunk(const u64* list, int start,
                                             int avail, const float* boxes,
                                             float4* chunk_box,
                                             int* chunk_idx) {
  const int t = static_cast<int>(threadIdx.x) - 32;
  if (t >= 0 && t < kChunk && start + t < avail) {
    const int j = static_cast<int>(list[slot(start + t)] & 0xffffffffu);
    chunk_box[t] = load_box(boxes, j);
    chunk_idx[t] = j;
  }
}

// Confidence filter plus greedy NMS over the whole candidate pool of one
// image, one block per image.  Greedy NMS over the pop order emits what the
// pop-max loop emits, so:
//  (a) the live candidates (score >= confidence, filtered score > NEG/2)
//      are compacted into shared memory as 64-bit keys, padded to a power
//      of two p >= 64 with a key that sorts last;
//  (b) the head of the order is sorted: above kHeadTarget live keys, a
//      two-pass radix select on the score word (12 bits a pass) finds the
//      C >= kHeadTarget smallest keys, which are copied out and sorted
//      alone; the whole list is sorted only if the sweep runs past them
//      (their order is the same in it), or directly if C > kHeadCap;
//  (c) the sorted keys are swept in chunks of 64: each candidate is tested
//      against the boxes kept so far (at most max_boxes, in shared memory)
//      and, unless that removes it, its row of the chunk's 64-bit
//      suppression words is filled; one warp then resolves the 64 rows in
//      order and appends the survivors, while two warps gather the next
//      chunk.  The sweep stops at max_boxes or at the end of the list;
//  (d) slots that no survivor fills repeat the pop-max loop's last pop:
//      the (score, index) argmax of the final filtered scores, which with
//      ordinary scores is flat index 0 at score NEG, invalid.
// Dynamic shared memory: slot(p) keys of 8 bytes, then max_boxes kept
// boxes of 16 bytes.
__global__ void __launch_bounds__(kThreads)
popmax_nms_kernel(const float* __restrict__ boxes,
                  const float* __restrict__ scores,
                  const int* __restrict__ classes, int n, int key_slots,
                  float confidence, float threshold, int max_boxes, int diou,
                  int use_iol, float* __restrict__ out_boxes,
                  int* __restrict__ out_classes,
                  float* __restrict__ out_scores,
                  unsigned char* __restrict__ out_valid) {
  extern __shared__ u64 keys[];
  float4* kept_box = reinterpret_cast<float4*>(keys + key_slots);
  __shared__ u64 head[kHeadCap + kHeadCap / 32];
  __shared__ unsigned int hist[kHistBins];
  __shared__ float4 chunk_box[2][kChunk];
  __shared__ int chunk_idx[2][kChunk];
  __shared__ u64 rows[kChunk];
  __shared__ unsigned char pre_removed[kChunk];
  __shared__ int s_live, s_deep, s_head, s_kept, s_bin, s_before;
  __shared__ int warp_sums[kWarps];
  __shared__ float red_s[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ float top_s;
  __shared__ int top_i;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t img = blockIdx.x;
  boxes += img * n * 4;
  scores += img * n;
  classes += img * n;
  out_boxes += img * max_boxes * 4;
  out_classes += img * max_boxes;
  out_scores += img * max_boxes;
  out_valid += img * max_boxes;

  // (a) compact the live candidates' keys, four loads in flight a thread
  if (tid == 0) {
    s_live = 0;
    s_deep = 0;
    s_head = 0;
    s_kept = 0;
  }
  __syncthreads();
  for (int j0 = 0; j0 < n; j0 += 4 * kThreads) {
    float s[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * kThreads + tid;
      const float s0 = j < n ? scores[j] : kNeg;
      s[u] = s0 >= confidence ? s0 : kNeg;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * kThreads + tid;
      append_key(keys, &s_live, s[u] > kNeg / 2.0f, sort_key(s[u], j));
    }
    // filtered scores at or below NEG/2 other than NEG itself (see (d))
    unsigned int deep = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      deep += __popc(__ballot_sync(0xffffffffu,
                                   s[u] <= kNeg / 2.0f && s[u] != kNeg));
    if (lane == 0 && deep) atomicAdd(&s_deep, static_cast<int>(deep));
  }
  __syncthreads();
  const int live_count = s_live;
  int p = kChunk;
  while (p < live_count) p <<= 1;
  for (int i = live_count + tid; i < p; i += kThreads) keys[slot(i)] = kPadKey;

  // (b) the sorted list the sweep starts on: the selected head, or all
  const u64* list = keys;
  int avail = live_count;
  bool whole = true;  // list holds every live key
  if (live_count > kHeadTarget) {
    for (int b = tid; b < kHistBins; b += kThreads) hist[b] = 0u;
    __syncthreads();
    for (int i = tid; i < live_count; i += kThreads)
      atomicAdd(&hist[keys[slot(i)] >> 52], 1u);
    __syncthreads();
    find_bin(hist, kHeadTarget, warp_sums, &s_bin, &s_before);
    const unsigned int b1 = s_bin;
    const int before1 = s_before;
    for (int b = tid; b < kHistBins; b += kThreads) hist[b] = 0u;
    __syncthreads();
    for (int i = tid; i < live_count; i += kThreads) {
      const u64 key = keys[slot(i)];
      if ((key >> 52) == b1) atomicAdd(&hist[(key >> 40) & 0xfffu], 1u);
    }
    __syncthreads();
    find_bin(hist, kHeadTarget - before1, warp_sums, &s_bin, &s_before);
    const unsigned int cut = (b1 << 20) | (static_cast<unsigned int>(s_bin)
                                           << 8) | 0xffu;
    const int count = before1 + s_before + static_cast<int>(hist[s_bin]);
    if (count <= kHeadCap) {
      for (int i0 = 0; i0 < live_count; i0 += kThreads) {
        const int i = i0 + tid;
        const u64 key = i < live_count ? keys[slot(i)] : kPadKey;
        append_key(head, &s_head, i < live_count && (key >> 32) <= cut, key);
      }
      int ph = kChunk;
      while (ph < count) ph <<= 1;
      for (int i = count + tid; i < ph; i += kThreads) head[slot(i)] = kPadKey;
      __syncthreads();
      block_sort(head, ph);
      list = head;
      avail = count;
      whole = false;
    }
  }
  if (whole) {
    __syncthreads();
    if (live_count > 1) block_sort(keys, p);
  }

  // (c) chunked sweep
  gather_chunk(list, 0, avail, boxes, chunk_box[0], chunk_idx[0]);
  __syncthreads();
  int start = 0;
  for (int chunk = 0;; ++chunk) {
    const int buf = chunk & 1;
    if (start >= avail) {
      if (whole) break;
      // the head ran out before max_boxes keeps: sort every live key (the
      // head's keys come first, in the same order) and go on from start
      block_sort(keys, p);
      list = keys;
      avail = live_count;
      whole = true;
      gather_chunk(list, start, avail, boxes, chunk_box[buf], chunk_idx[buf]);
      __syncthreads();
      if (start >= avail) break;
    }
    const int len = min(kChunk, avail - start);
    const int kept = s_kept;
    const float4* cb = chunk_box[buf];

    // candidate t against the kept boxes, 16 threads a candidate; a warp
    // holds candidates 2*warp and 2*warp+1 and, for those not removed,
    // fills their rows of the chunk's suppression words
    {
      const int t = tid >> 4;
      bool hit = false;
      if (t < len) {
        const float4 bt = cb[t];
        for (int q = tid & 15; q < kept; q += 16) {
          if (suppresses(kept_box[q], bt, threshold, use_iol, diou)) {
            hit = true;
            break;
          }
        }
      }
      const unsigned int ballot = __ballot_sync(0xffffffffu, hit);
      const bool gone[2] = {(ballot & 0xffffu) != 0u, (ballot >> 16) != 0u};
      if (lane == 0) {
        pre_removed[2 * warp] = gone[0];
        pre_removed[2 * warp + 1] = gone[1];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 2 * warp + h;
        if (r >= len || gone[h]) continue;  // uniform across the warp
        const float4 br = cb[r];
        const int j_lo = lane, j_hi = lane + 32;
        const bool lo = j_lo > r && j_lo < len &&
                        suppresses(br, cb[j_lo], threshold, use_iol, diou);
        const bool hi = j_hi > r && j_hi < len &&
                        suppresses(br, cb[j_hi], threshold, use_iol, diou);
        const unsigned int wlo = __ballot_sync(0xffffffffu, lo);
        const unsigned int whi = __ballot_sync(0xffffffffu, hi);
        if (lane == 0) rows[r] = wlo | (static_cast<u64>(whi) << 32);
      }
    }
    __syncthreads();

    if (warp == 0) {
      const bool gone_lo = lane >= len || pre_removed[lane];
      const bool gone_hi = lane + 32 >= len || pre_removed[lane + 32];
      const u64 removed =
          __ballot_sync(0xffffffffu, gone_lo) |
          (static_cast<u64>(__ballot_sync(0xffffffffu, gone_hi)) << 32);
      u64 keep = ~removed ? resolve_rows(removed, rows[lane], rows[lane + 32])
                          : 0ull;
      // past max_boxes keeps the pop stops: drop the last kept bits
      while (__popcll(keep) > max_boxes - kept)
        keep &= ~(1ull << (63 - __clzll(static_cast<long long>(keep))));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = lane + 32 * h;
        if ((keep >> t) & 1ull) {
          const int at = kept + __popcll(keep & ((1ull << t) - 1ull));
          const int j = chunk_idx[buf][t];
          const float4 b = cb[t];
          kept_box[at] = b;
          out_boxes[4 * at + 0] = b.x;
          out_boxes[4 * at + 1] = b.y;
          out_boxes[4 * at + 2] = b.z;
          out_boxes[4 * at + 3] = b.w;
          out_scores[at] = scores[j];
          out_classes[at] = classes[j];
          out_valid[at] = 1;
        }
      }
      if (lane == 0) s_kept = kept + __popcll(keep);
    } else {
      gather_chunk(list, start + len, avail, boxes, chunk_box[buf ^ 1],
                   chunk_idx[buf ^ 1]);
    }
    __syncthreads();
    start += len;
    if (s_kept >= max_boxes) break;
  }

  // (d) the tail, once the pool is exhausted.  Every live candidate is now
  // NEG, and so is every one below confidence; only the rare filtered
  // scores in [confidence, NEG/2] other than NEG need the pass.
  const int kept = s_kept;
  if (kept >= max_boxes) return;
  float bs = -INFINITY;
  int bi = INT_MAX;
  for (int j = s_deep ? tid : n; j < n; j += kThreads) {
    const float s0 = scores[j];
    float f = s0 >= confidence ? s0 : kNeg;
    if (f > kNeg / 2.0f) {
      f = kNeg;  // live: kept or suppressed
    } else if (f != kNeg) {
      // a filtered score at or below NEG/2: the pop-max loop lifts or
      // lowers it to NEG where a kept box suppresses it
      const float4 bj = load_box(boxes, j);
      for (int q = 0; q < kept; ++q) {
        if (suppresses(kept_box[q], bj, threshold, use_iol, diou)) {
          f = kNeg;
          break;
        }
      }
    }
    if (better(f, j, bs, bi)) {
      bs = f;
      bi = j;
    }
  }
  if (s_deep) {
    block_argmax(bs, bi, red_s, red_i, &top_s, &top_i);
  } else if (tid == 0) {
    top_s = kNeg;
    top_i = 0;
  }
  __syncthreads();
  const float4 b = load_box(boxes, top_i);
  const int c = classes[top_i];
  for (int at = kept + tid; at < max_boxes; at += kThreads) {
    out_boxes[4 * at + 0] = b.x;
    out_boxes[4 * at + 1] = b.y;
    out_boxes[4 * at + 2] = b.z;
    out_boxes[4 * at + 3] = b.w;
    out_scores[at] = top_s;
    out_classes[at] = c;
    out_valid[at] = 0;
  }
}

// ---------------------------------------------------------------------------
// greedy NMS over score-sorted boxes: suppression bitmask, then a scan
// ---------------------------------------------------------------------------

// Word (i, cb) of the suppression mask, for the upper-triangular blocks
// cb >= rb: bit t is set when j = 64*cb + t is later than i and box i's
// overlap with box j reaches the threshold.  Row 64*rb + r belongs to
// threads 4r..4r+3 of block (cb, rb, image), 16 columns each; thread 4r
// writes the word.  mask is [B, k, words] 64-bit words.
__global__ void __launch_bounds__(kMaskThreads)
greedy_mask_kernel(const float* __restrict__ boxes, int k, float threshold,
                   int diou, int use_iol, u64* __restrict__ mask) {
  const int cb = blockIdx.x;
  const int rb = blockIdx.y;
  if (cb < rb) return;
  const size_t img = blockIdx.z;
  const int words = (k + kChunk - 1) / kChunk;
  __shared__ float4 col_box[kChunk];
  __shared__ float4 row_box[kChunk];
  boxes += img * k * 4;
  const int t = threadIdx.x;
  if (t < kChunk && cb * kChunk + t < k)
    col_box[t] = load_box(boxes, cb * kChunk + t);
  if (t >= kChunk && t < 2 * kChunk && rb * kChunk + t - kChunk < k)
    row_box[t - kChunk] = load_box(boxes, rb * kChunk + t - kChunk);
  __syncthreads();
  const int r = t >> 2;
  const int q = t & 3;
  const int i = rb * kChunk + r;
  u64 bits = 0;
  if (i < k) {
    const float4 bi = row_box[r];
    const int end = min(16 * q + 16, k - cb * kChunk);
#pragma unroll 4
    for (int c = cb == rb ? max(16 * q, r + 1) : 16 * q; c < end; ++c)
      bits |= static_cast<u64>(suppresses(bi, col_box[c], threshold, use_iol,
                                          diou)) << c;
  }
  bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
  bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
  if (q == 0 && i < k) mask[(img * k + i) * words + cb] = bits;
}

// Keep mask from the suppression words, one block per image, one barrier
// per chunk of 64 rows.  Shared memory holds the removed bits (started from
// ~valid) and, for every row, its word of its own chunk (the diagonal) and
// of the next chunk.  In step c, warp 0 resolves chunk c in order from the
// diagonal words and ORs its kept rows' next-chunk words into chunk c+1,
// which is then final for step c+1; meanwhile the other warps OR chunk
// c-1's kept rows into the chunks after c+1, reading the mask from L2.
// keep = ~removed.
__global__ void __launch_bounds__(kScanThreads)
greedy_scan_kernel(const u64* __restrict__ mask,
                   const unsigned char* __restrict__ valid, int k,
                   unsigned char* __restrict__ keep_out) {
  extern __shared__ u64 scan_smem[];
  __shared__ int kept_rows[2][kChunk];
  __shared__ int s_count[2];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t img = blockIdx.x;
  const int words = (k + kChunk - 1) / kChunk;
  u64* removed = scan_smem;               // [words]
  u64* diag = removed + words;            // [words * 64]
  u64* next = diag + words * kChunk;      // [words * 64]
  mask += img * k * words;
  valid += img * k;
  keep_out += img * k;

  unsigned int* removed32 = reinterpret_cast<unsigned int*>(removed);
  for (int j0 = 0; j0 < words * kChunk; j0 += kScanThreads) {
    const int j = j0 + tid;
    const unsigned int ballot =
        __ballot_sync(0xffffffffu, j >= k || !valid[j]);
    if (lane == 0 && j < words * kChunk) removed32[j >> 5] = ballot;
  }
  for (int i = tid; i < words * kChunk; i += kScanThreads) {
    const int c = i / kChunk;
    const u64* row = mask + static_cast<size_t>(i) * words;
    diag[i] = i < k ? row[c] : 0ull;
    next[i] = i < k && c + 1 < words ? row[c + 1] : 0ull;
  }
  __syncthreads();

  for (int c = 0; c < words; ++c) {
    if (tid < 32) {
      const int r0 = c * kChunk + lane;
      const u64 keep = resolve_rows(removed[c], diag[r0], diag[r0 + 32]);
      u64 acc = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = lane + 32 * h;
        if ((keep >> t) & 1ull) {
          kept_rows[c & 1][__popcll(keep & ((1ull << t) - 1ull))] = t;
          acc |= next[r0 + 32 * h];
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc |= __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        removed[c] = ~keep;
        s_count[c & 1] = __popcll(keep);
        if (acc) atomicOr(&removed[c + 1], acc);  // acc == 0 past the end
      }
    } else if (c >= 1) {
      const int count = s_count[(c - 1) & 1];
      const int* rows = kept_rows[(c - 1) & 1];
      const u64* block = mask + static_cast<size_t>(c - 1) * kChunk * words;
      const int later = words - c - 1;  // chunks c+1 .. words-1
      if (later > 0 && count > 0) {
        const int parts = max(1, min(count, (kScanThreads - 32) / later));
        for (int q = tid - 32; q < later * parts; q += kScanThreads - 32) {
          const int w = c + 1 + q % later;
          u64 bits = 0;
#pragma unroll 4
          for (int r = q / later; r < count; r += parts)
            bits |= block[static_cast<size_t>(rows[r]) * words + w];
          if (bits) atomicOr(&removed[w], bits);
        }
      }
    }
    __syncthreads();
  }
  for (int j = tid; j < k; j += kScanThreads)
    keep_out[j] = ((removed[j >> 6] >> (j & 63)) & 1ull) ? 0 : 1;
}

// Largest dynamic shared memory a block of `kernel` may opt in to.
template <typename K>
int dynamic_smem_limit(K kernel) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return 0;
  return optin - static_cast<int>(attr.sharedSizeBytes);
}

// Key array of the pop-max kernel: p >= n keys, p a power of two >= 64.
int popmax_keys(int n) {
  int p = kChunk;
  while (p < n) p <<= 1;
  return p;
}

int popmax_smem(int p, int max_boxes) {
  return (p + p / 32) * 8 + max_boxes * 16;
}

int greedy_smem(int words) { return words * 8 * (1 + 2 * kChunk); }

}  // namespace

extern "C" {

// Largest pool (n) whose keys the pop-max kernel holds in shared memory
// beside max_boxes kept boxes.
int mgd_popmax_capacity(int max_boxes) {
  const int limit = dynamic_smem_limit(popmax_nms_kernel);
  int p = kChunk;
  while (popmax_smem(2 * p, max_boxes) <= limit) p <<= 1;
  return popmax_smem(p, max_boxes) <= limit ? p : 0;
}

// Largest k the greedy scan holds: per 64 boxes, one removed word and the
// boxes' 2 x 64 diagonal and next-chunk words in shared memory.
int mgd_greedy_capacity() {
  return dynamic_smem_limit(greedy_scan_kernel) / greedy_smem(1) * kChunk;
}

int mgd_popmax_nms(const float* boxes, const float* scores,
                   const int* classes, int batch, int n, float confidence,
                   float threshold, int max_boxes, int diou, int use_iol,
                   float* out_boxes, int* out_classes, float* out_scores,
                   unsigned char* out_valid, void* stream) {
  const int p = popmax_keys(n);
  const int smem = popmax_smem(p, max_boxes);
  cudaError_t err = cudaFuncSetAttribute(
      popmax_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  popmax_nms_kernel<<<batch, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      boxes, scores, classes, n, p + p / 32, confidence, threshold, max_boxes,
      diou, use_iol, out_boxes, out_classes, out_scores, out_valid);
  return static_cast<int>(cudaGetLastError());
}

// mask: scratch of batch * k * ceil(k / 64) 64-bit words.
int mgd_greedy_nms(const float* boxes, const unsigned char* valid, int batch,
                   int k, float threshold, int diou, int use_iol, void* mask,
                   unsigned char* keep, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int words = (k + kChunk - 1) / kChunk;
  greedy_mask_kernel<<<dim3(words, words, batch), kMaskThreads, 0, st>>>(
      boxes, k, threshold, diou, use_iol, static_cast<u64*>(mask));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = greedy_smem(words);
  err = cudaFuncSetAttribute(greedy_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  greedy_scan_kernel<<<batch, kScanThreads, smem, st>>>(
      static_cast<const u64*>(mask), valid, k, keep);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
