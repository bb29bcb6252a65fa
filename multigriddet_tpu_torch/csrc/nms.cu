// Greedy NMS kernels for NVIDIA Hopper (sm_90a), with a plain C interface
// bound from Python through ctypes (multigriddet_tpu_torch/ops/cuda_nms.py).
//
//   popmax_nms_kernel  replaces  _popmax_kernel / pallas_popmax_nms
//                      (multigriddet_tpu/ops/pallas_nms.py:115-247)
//   greedy_nms_kernel  replaces  _nms_sweep_kernel / pallas_greedy_nms
//                      (multigriddet_tpu/ops/pallas_nms.py:34-112)
//
// Both keep one image's candidates in shared memory, one block (CTA) per
// image, and walk the inherently serial greedy loop inside the block.  The
// overlap arithmetic follows the Pallas kernels' float32 expressions
// operation by operation; the library is built with -fmad=false so that
// nvcc does not contract a*b+c into an FMA, whose single rounding could
// flip a keep decision at the threshold edge.  Suppression is inclusive
// (overlap >= threshold), and both denominators carry +1e-8.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr float kNeg = -1e9f;      // dead score (NEG in the Pallas kernels)
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// Overlap of box i with box j: IoU, or IoL (intersection over the larger
// area), optionally minus the DIoU centre-distance penalty.
__device__ __forceinline__ float overlap(float xi, float yi, float wi,
                                         float hi, float area_i, float xj,
                                         float yj, float wj, float hj,
                                         bool use_iol, bool diou) {
  const float iw = fmaxf(0.0f, fminf(xi + wi, xj + wj) - fmaxf(xi, xj));
  const float ih = fmaxf(0.0f, fminf(yi + hi, yj + hj) - fmaxf(yi, yj));
  const float inter = iw * ih;
  const float area_j = wj * hj;
  float ov = use_iol ? inter / (fmaxf(area_i, area_j) + 1e-8f)
                     : inter / (area_i + area_j - inter + 1e-8f);
  if (diou) {
    const float dx = xi + wi / 2.0f - xj - wj / 2.0f;
    const float dy = yi + hi / 2.0f - yj - hj / 2.0f;
    const float cdist = dx * dx + dy * dy;
    const float ex = fmaxf(xi + wi, xj + wj) - fminf(xi, xj);
    const float ey = fmaxf(yi + hi, yj + hj) - fminf(yi, yj);
    ov = ov - cdist / (ex * ex + ey * ey + 1e-8f);
  }
  return ov;
}

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

// Pop-max greedy NMS over the whole candidate pool of one image.
//
// Shared memory holds six planes of n entries (x, y, w, h, live score,
// class): 24 bytes a candidate.  Each of the max_boxes steps is one pass
// over the pool that suppresses the previous winner's overlaps and, in the
// same pass, finds each thread's best survivor; one block-wide argmax then
// names the next winner.  Once the pool is empty the remaining output
// columns repeat the last (invalid) pop, as the Pallas kernel's do.
__global__ void __launch_bounds__(kThreads)
popmax_nms_kernel(const float* __restrict__ boxes,
                  const float* __restrict__ scores,
                  const int* __restrict__ classes, int n, float confidence,
                  float threshold, int max_boxes, int diou, int use_iol,
                  float* __restrict__ out_boxes, int* __restrict__ out_classes,
                  float* __restrict__ out_scores,
                  unsigned char* __restrict__ out_valid) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = xs + n;
  float* ws = ys + n;
  float* hs = ws + n;
  float* ss = hs + n;
  int* cs = reinterpret_cast<int*>(ss + n);
  __shared__ float red_s[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ float top_s;
  __shared__ int top_i;

  const int tid = threadIdx.x;
  const size_t img = blockIdx.x;
  boxes += img * n * 4;
  scores += img * n;
  classes += img * n;
  out_boxes += img * max_boxes * 4;
  out_classes += img * max_boxes;
  out_scores += img * max_boxes;
  out_valid += img * max_boxes;

  float bs = -INFINITY;
  int bi = INT_MAX;
  for (int j = tid; j < n; j += kThreads) {
    xs[j] = boxes[4 * j + 0];
    ys[j] = boxes[4 * j + 1];
    ws[j] = boxes[4 * j + 2];
    hs[j] = boxes[4 * j + 3];
    const float s0 = scores[j];
    const float s = s0 >= confidence ? s0 : kNeg;
    ss[j] = s;
    cs[j] = classes[j];
    if (better(s, j, bs, bi)) {
      bs = s;
      bi = j;
    }
  }
  block_argmax(bs, bi, red_s, red_i, &top_s, &top_i);

  for (int it = 0; it < max_boxes; ++it) {
    const float cur = top_s;
    const int idx = top_i;
    const float xi = xs[idx], yi = ys[idx], wi = ws[idx], hi = hs[idx];
    const int ci = cs[idx];
    if (!(cur > kNeg / 2.0f)) {
      // pool exhausted: nothing changes any more, so every remaining
      // column is this same invalid pop
      for (int k = it + tid; k < max_boxes; k += kThreads) {
        out_boxes[4 * k + 0] = xi;
        out_boxes[4 * k + 1] = yi;
        out_boxes[4 * k + 2] = wi;
        out_boxes[4 * k + 3] = hi;
        out_scores[k] = cur;
        out_classes[k] = ci;
        out_valid[k] = 0;
      }
      return;
    }
    if (tid == 0) {
      out_boxes[4 * it + 0] = xi;
      out_boxes[4 * it + 1] = yi;
      out_boxes[4 * it + 2] = wi;
      out_boxes[4 * it + 3] = hi;
      out_scores[it] = cur;
      out_classes[it] = ci;
      out_valid[it] = 1;
    }
    const float area_i = wi * hi;
    bs = -INFINITY;
    bi = INT_MAX;
    for (int j = tid; j < n; j += kThreads) {
      float s = ss[j];
      // a dead entry stays dead: skipping its overlap changes nothing
      if (s != kNeg &&
          (j == idx || overlap(xi, yi, wi, hi, area_i, xs[j], ys[j], ws[j],
                               hs[j], use_iol, diou) >= threshold)) {
        s = kNeg;
        ss[j] = s;
      }
      if (better(s, j, bs, bi)) {
        bs = s;
        bi = j;
      }
    }
    block_argmax(bs, bi, red_s, red_i, &top_s, &top_i);
  }
}

// Greedy keep mask over k boxes sorted by descending score.
//
// Shared memory holds the four box planes and the keep flags: 17 bytes a
// candidate.  Box i, when still kept, clears every later box whose overlap
// with it reaches the threshold; boxes already dropped cost one shared
// load and no barrier.
__global__ void __launch_bounds__(kThreads)
greedy_nms_kernel(const float* __restrict__ boxes,
                  const unsigned char* __restrict__ valid, int k,
                  float threshold, int diou, int use_iol,
                  unsigned char* __restrict__ keep_out) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = xs + k;
  float* ws = ys + k;
  float* hs = ws + k;
  unsigned char* keep = reinterpret_cast<unsigned char*>(hs + k);

  const int tid = threadIdx.x;
  const size_t img = blockIdx.x;
  boxes += img * k * 4;
  valid += img * k;
  keep_out += img * k;

  for (int j = tid; j < k; j += kThreads) {
    xs[j] = boxes[4 * j + 0];
    ys[j] = boxes[4 * j + 1];
    ws[j] = boxes[4 * j + 2];
    hs[j] = boxes[4 * j + 3];
    keep[j] = valid[j] ? 1 : 0;
  }
  __syncthreads();

  for (int i = 0; i < k; ++i) {
    if (!keep[i]) continue;  // uniform: keep[i] is final since a barrier
    const float xi = xs[i], yi = ys[i], wi = ws[i], hi = hs[i];
    const float area_i = wi * hi;
    for (int j = i + 1 + tid; j < k; j += kThreads) {
      if (keep[j] && overlap(xi, yi, wi, hi, area_i, xs[j], ys[j], ws[j],
                             hs[j], use_iol, diou) >= threshold) {
        keep[j] = 0;
      }
    }
    __syncthreads();
  }
  for (int j = tid; j < k; j += kThreads) keep_out[j] = keep[j];
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

}  // namespace

extern "C" {

// Largest pool (n) the pop-max kernel holds in shared memory.
int mgd_popmax_capacity() { return dynamic_smem_limit(popmax_nms_kernel) / 24; }

// Largest k the greedy kernel holds in shared memory.
int mgd_greedy_capacity() { return dynamic_smem_limit(greedy_nms_kernel) / 17; }

int mgd_popmax_nms(const float* boxes, const float* scores,
                   const int* classes, int batch, int n, float confidence,
                   float threshold, int max_boxes, int diou, int use_iol,
                   float* out_boxes, int* out_classes, float* out_scores,
                   unsigned char* out_valid, void* stream) {
  const int smem = n * 24;
  cudaError_t err = cudaFuncSetAttribute(
      popmax_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  popmax_nms_kernel<<<batch, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      boxes, scores, classes, n, confidence, threshold, max_boxes, diou,
      use_iol, out_boxes, out_classes, out_scores, out_valid);
  return static_cast<int>(cudaGetLastError());
}

int mgd_greedy_nms(const float* boxes, const unsigned char* valid, int batch,
                   int k, float threshold, int diou, int use_iol,
                   unsigned char* keep, void* stream) {
  const int smem = k * 17;
  cudaError_t err = cudaFuncSetAttribute(
      greedy_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  greedy_nms_kernel<<<batch, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      boxes, valid, k, threshold, diou, use_iol, keep);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
