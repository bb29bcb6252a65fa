// JPEG decode and letterbox on the card, with a plain C interface bound from
// Python through ctypes (multigriddet_tpu_torch/ops/cuda_jpeg.py).
//
// The JAX package reads image files on its host: native/fastloader.cpp
// decodes with libjpeg (DCT-domain down-scaling by 1/2, 1/4 or 1/8), then
// letterboxes bilinearly onto a gray canvas and, for the yuv420 link,
// converts to planar 4:2:0.  That was host C++ on the TPU's host, never a
// Pallas kernel; here the entropy decode and the IDCT go to nvJPEG and the
// rest to three kernels of this file:
//
//   ycc_to_rgb_kernel        replaces  libjpeg's fancy chroma upsampling and
//                                      YCbCr -> RGB (inside decode_jpeg,
//                                      native/fastloader.cpp:44-105), for
//                                      a whole batch in one launch
//   letterbox_kernel<false>  replaces  load_one + bilinear_into
//     (letterbox_rgb)                  (native/fastloader.cpp:107-146,
//                                      165-190)
//   letterbox_kernel<true>   replaces  the same, then rgb_to_yuv420
//     (letterbox_yuv420)               (native/fastloader.cpp:209-238)
//
// nvJPEG's own interleaved RGB output does not upsample the chroma as
// libjpeg does (libjpeg interpolates it: a 3/4-1/4 triangle in each
// subsampled direction, then integer conversion tables); on a photo with
// coloured detail that alone put the canvases ~8 levels from fastloader's.
// So a 4:4:4, 4:2:2, 4:2:0 or 4:4:0 file (other layouts are rejected) is
// decoded to its YCbCr planes at their own resolution, and
// ycc_to_rgb_kernel repeats libjpeg-turbo's h2v2/h2v1/h1v2 fancy
// upsampling (jdsample.c) and ycc_rgb_convert (jdcolor.c) in integer
// arithmetic, bit for bit; what is left at full size is nvJPEG's IDCT
// against libjpeg's islow one.
//
// nvJPEG scales in the DCT domain only on its hardware backend, which the
// H100 refuses (nvjpegCreateEx returns ARCH_MISMATCH there), so images
// decode at full size and a block mean takes the place of libjpeg's
// reduced IDCT (d = the divisor libjpeg would have used; edge blocks are
// cut at the image, as libjpeg's ceil(w / d) output is): ycc_to_rgb
// reduces each colour plane by the scale libjpeg's IDCT gives it
// (jdmaster.c enlarges the chroma's IDCT so as to upsample less) and
// upsamples the chroma only where libjpeg then does (a gray image: its
// luma alone).  At d = 1 (a canvas more than half the image's size on
// either side, as at 416 and 608 on COCO's images) nothing is reduced.
//
// Bound on the card: bytes.  ycc_to_rgb reads the planes (1.5 to 3 bytes a
// pixel) and writes 3; each letterbox output pixel reads its four taps of
// the reduced source and writes three or one and a half bytes.  The
// arithmetic repeats fastloader's float operations one by one with
// round-to-nearest intrinsics (__fmul_rn and __fadd_rn are never
// contracted into an FMA), so the canvases equal the plain PyTorch
// versions bit for bit.
//
// The design.  One launch an image, one byte a thread at a 3-byte stride
// and every tap re-read from device memory left these kernels at a tenth
// of the memory's rate, so each kernel stages what a block reads and
// writes in shared memory:
//   * loads and stores move whole aligned 16-byte chunks (stage_span,
//     store_span): a span of bytes is copied with the chunk holding its
//     first byte as chunk 0, so the shared copy keeps the span's offset
//     within its chunk and every full chunk is one vector access on both
//     sides; a store writes the partial chunks at a span's two ends byte
//     by byte, and a load reads only chunks that hold a byte of the span
//     (never outside the memory pages that hold it);
//   * ycc_to_rgb converts a whole batch in one launch over a per-image
//     table (pointers, sizes, chroma factors, divisor), a block per tile of
//     kYccRows x kYccCols output pixels: the tile's luma rows and its
//     chroma rows with the one-row and one-column halo of libjpeg's
//     triangle filter are staged (the r x r block means where the chroma is
//     reduced), each thread reads its taps from shared memory, and the
//     tile's interleaved rows leave as contiguous spans;
//   * the letterbox kernels take a band of canvas rows a block: the
//     image's geometry read once, the column taps (x0, x1, wx) of every
//     canvas column computed once into a table, the source rows the band
//     touches staged as one contiguous span, and the band's rows (and for
//     4:2:0 its Y, Cb and Cr rows, each one contiguous span) stored as
//     vectors.  The sources come reduced by their divisor (ycc_to_rgb
//     reduces them); one too wide for the staging budget reads its taps
//     from device memory.
// What is left is arithmetic: on the H100 a b8 batch at 608 spends ~7 us
// staging and storing and the rest on the per-pixel float operations
// (chip_smoke.py phase 13 prints each kernel's time).  So the integer <->
// float conversions, which the SM's conversion unit does at an eighth of
// the float rate, are exact bit operations (exact_float, exact_floor),
// ycc_to_rgb upsamples a pair of pixels at a time with no branch on their
// parity, and each kernel caps its registers for more resident blocks.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstdint>

namespace {

constexpr int kParams = 9;    // int64 per image, see struct Geometry
constexpr int kThreads = 256;
// blocks of kThreads each kernel asks to keep resident on an SM (its
// register budget): measured best of 1-5 on the H100
constexpr int kLetterboxBlocks = 3;
constexpr int kYccBlocks = 4;

// ---------------------------------------------------------------------------
// 16-byte staging

// Copy `rows` spans of `n` bytes, the k-th at base + k * pitch, into
// shared rows `stride` bytes apart (a multiple of 16), each placed at its
// own offset within its first chunk: byte i of span k lands at
// dst[k * stride + shift[k] + i], shift[k] = (base + k * pitch) & 15.
// Needs stride >= n + 30.  Every thread of the block takes part.
__device__ __forceinline__ void stage_span(const uint8_t* base, int64_t pitch,
                                           int rows, int n, uint8_t* dst,
                                           int stride, int* shift) {
  const int chunks = (n + 30) >> 4;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int k = i / chunks, q = i - k * chunks;
    const uintptr_t s = reinterpret_cast<uintptr_t>(base + k * pitch);
    const uintptr_t a = (s & ~static_cast<uintptr_t>(15)) + 16 * q;
    if (a < s + n) {
      reinterpret_cast<uint4*>(dst + k * stride)[q] =
          __ldg(reinterpret_cast<const uint4*>(a));
    }
  }
  for (int k = threadIdx.x; k < rows; k += blockDim.x) {
    shift[k] = static_cast<int>(reinterpret_cast<uintptr_t>(base + k * pitch)
                                & 15);
  }
}

// Store a span of n bytes to dst from shared src, where byte i of the span
// sits at src[(dst & 15) + i] (src 16-byte aligned): whole chunks as
// vectors, the partial chunks at the ends byte by byte.  Every thread of
// the block takes part.
__device__ __forceinline__ void store_span(uint8_t* dst, int n,
                                           const uint8_t* src) {
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  const uintptr_t a0 = d & ~static_cast<uintptr_t>(15);
  const int chunks = static_cast<int>((d + n + 15 - a0) >> 4);
  for (int q = threadIdx.x; q < chunks; q += blockDim.x) {
    const uintptr_t a = a0 + 16 * q;
    if (a >= d && a + 16 <= d + n) {
      *reinterpret_cast<uint4*>(a) =
          reinterpret_cast<const uint4*>(src)[q];
    } else {
      for (int b = 0; b < 16; ++b) {
        if (a + b >= d && a + b < d + n) {
          *reinterpret_cast<uint8_t*>(a + b) = src[16 * q + b];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// letterbox

// One row of the per-image table (int64 each): the decoded source's device
// pointer (already reduced by its divisor), its width, height and channels
// (1 gray or 3 RGB), the content size and offset on the canvas, and
// whether the slot decoded.
struct Geometry {
  const uint8_t* src;
  int w, h, c, nw, nh, px, py, ok;
};

__device__ __forceinline__ Geometry load_geometry(const int64_t* table,
                                                  int n) {
  const int64_t* t = table + static_cast<int64_t>(n) * kParams;
  Geometry g;
  g.src = reinterpret_cast<const uint8_t*>(t[0]);
  g.w = static_cast<int>(t[1]);
  g.h = static_cast<int>(t[2]);
  g.c = static_cast<int>(t[3]);
  g.nw = static_cast<int>(t[4]);
  g.nh = static_cast<int>(t[5]);
  g.px = static_cast<int>(t[6]);
  g.py = static_cast<int>(t[7]);
  g.ok = static_cast<int>(t[8]);
  return g;
}

// The rounded mean of the bw x bh block at (x0, y0) of a plane pw x ph
// whose samples lie `stride` bytes apart, cut at the plane's edge.
__device__ __forceinline__ int block_mean(const uint8_t* p, int pw, int ph,
                                          int stride, int x0, int y0, int bw,
                                          int bh) {
  const int x1 = min(x0 + bw, pw), y1 = min(y0 + bh, ph);
  int sum = 0;
  for (int yy = y0; yy < y1; ++yy) {
    const uint8_t* row = p + static_cast<int64_t>(yy) * pw * stride;
    for (int xx = x0; xx < x1; ++xx) sum += row[xx * stride];
  }
  const int cnt = (x1 - x0) * (y1 - y0);
  return (sum + cnt / 2) / cnt;
}

// Channel ch of source pixel (x, y); a gray source's one channel.
__device__ __forceinline__ int pixel(const Geometry& g, int x, int y,
                                     int ch) {
  return g.src[(static_cast<int64_t>(y) * g.w + x) * g.c +
               (g.c == 1 ? 0 : ch)];
}

// Exact conversions without the conversion unit (16 results a clock on an
// SM, against 128 for a float add): float(v) of an integer 0 <= v < 2^23
// as (2^23 + v) - 2^23, and floor(v) of a float 0 <= v < 2^23 (what
// static_cast<int> gives there) as the low bits of v + 2^23 rounded down.
__device__ __forceinline__ float exact_float(int v) {
  return __fadd_rn(__int_as_float(0x4B000000 | v), -8388608.0f);
}

__device__ __forceinline__ int exact_floor(float v) {
  return __float_as_int(__fadd_rd(v, 8388608.0f)) & 0x7FFFFF;
}

// Source coordinate of output index i (of n) over a source of s samples:
// half-pixel centres, clamped (fastloader's bilinear_into).
struct Tap {
  int i0, i1;
  float frac;
};

// scale = s / n (tap_scale), the same for every index of an axis.
__device__ __forceinline__ float tap_scale(int n, int s) {
  return __fdiv_rn(static_cast<float>(s), static_cast<float>(n));
}

__device__ __forceinline__ Tap tap(int i, float scale, int s) {
  float f = __fadd_rn(__fmul_rn(__fadd_rn(static_cast<float>(i), 0.5f), scale),
                      -0.5f);
  f = fmaxf(0.0f, fminf(f, static_cast<float>(s - 1)));
  Tap t;
  t.i0 = static_cast<int>(f);
  t.i1 = min(t.i0 + 1, s - 1);
  t.frac = __fadd_rn(f, -static_cast<float>(t.i0));
  return t;
}

__device__ __forceinline__ uint8_t clamp_u8(float v) {
  return static_cast<uint8_t>(exact_floor(fminf(255.0f, fmaxf(0.0f, v))));
}

// Y of one u8 RGB pixel, in fastloader's order of operations.
__device__ __forceinline__ uint8_t luma(const int p[3]) {
  const float y = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(0.299f, exact_float(p[0])),
                          __fmul_rn(0.587f, exact_float(p[1]))),
                __fmul_rn(0.114f, exact_float(p[2]))),
      0.5f);
  return clamp_u8(y);
}

// fastloader's bilinear of the taps a (x0, y0), b (x1, y0), c (x0, y1),
// e (x1, y1): u8(top + (bot - top) * wy + 0.5), top = a + (b - a) * wx and
// bot = c + (e - c) * wx, the differences taken exactly in float.
__device__ __forceinline__ int bilinear(int a, int b, int c, int e, float wx,
                                        float wy) {
  const float fa = exact_float(a), fc = exact_float(c);
  const float top = __fadd_rn(fa, __fmul_rn(__fadd_rn(exact_float(b), -fa),
                                            wx));
  const float bot = __fadd_rn(fc, __fmul_rn(__fadd_rn(exact_float(e), -fc),
                                            wx));
  return exact_floor(__fadd_rn(
      __fadd_rn(top, __fmul_rn(__fadd_rn(bot, -top), wy)), 0.5f));
}

// What a band's block knows of its image: the geometry, the column and
// row taps, and the staged source rows (`stage` points at the first
// staged row's first byte; null where the taps are read from device
// memory).
struct Band {
  Geometry g;
  const Tap* cols;     // per canvas column
  const Tap* rows;     // per canvas row of the band
  const uint8_t* stage;
  int sy0, y0;         // first staged source row, first canvas row
};

// Canvas pixel (x, y) of the band's image, its three channels into rgb[3],
// the taps read from device memory.
__device__ __forceinline__ void canvas_pixel(const Band& b, int x, int y,
                                             int rgb[3]) {
  const Geometry& g = b.g;
  const int cx = x - g.px, cy = y - g.py;
  if (!g.ok || cx < 0 || cy < 0 || cx >= g.nw || cy >= g.nh) {
    rgb[0] = rgb[1] = rgb[2] = 128;
    return;
  }
  const Tap tx = b.cols[x], ty = b.rows[y - b.y0];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    rgb[ch] = bilinear(pixel(g, tx.i0, ty.i0, ch), pixel(g, tx.i1, ty.i0, ch),
                       pixel(g, tx.i0, ty.i1, ch), pixel(g, tx.i1, ty.i1, ch),
                       tx.frac, ty.frac);
  }
}

// A canvas row of a staged band: its two source rows and weight, or
// null rows outside the content.
struct Row {
  const uint8_t *r0, *r1;
  float wy;
};

__device__ __forceinline__ Row staged_row(const Band& b, int y) {
  const int cy = y - b.g.py;
  if (cy < 0 || cy >= b.g.nh) return Row{nullptr, nullptr, 0.0f};
  const Tap t = b.rows[y - b.y0];
  const int pitch = b.g.w * b.g.c;
  return Row{b.stage + (t.i0 - b.sy0) * pitch,
             b.stage + (t.i1 - b.sy0) * pitch, t.frac};
}

// Canvas pixel (x, row) from the staged rows, as canvas_pixel computes it.
__device__ __forceinline__ void staged_pixel(const Band& b, const Row& row,
                                             int x, int rgb[3]) {
  const int cx = x - b.g.px;
  if (row.r0 == nullptr || cx < 0 || cx >= b.g.nw) {
    rgb[0] = rgb[1] = rgb[2] = 128;
    return;
  }
  const Tap tx = b.cols[x];
  if (b.g.c == 1) {
    rgb[0] = rgb[1] = rgb[2] =
        bilinear(row.r0[tx.i0], row.r0[tx.i1], row.r1[tx.i0], row.r1[tx.i1],
                 tx.frac, row.wy);
    return;
  }
  const int o0 = 3 * tx.i0, o1 = 3 * tx.i1;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    rgb[ch] = bilinear(row.r0[o0 + ch], row.r0[o1 + ch], row.r1[o0 + ch],
                       row.r1[o1 + ch], tx.frac, row.wy);
  }
}

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

// Shared memory of a letterbox block: the column taps (tw), the row taps
// (band), the output spans (each with 32 bytes for its alignment), then
// `stage` bytes of staged source rows.
__host__ __device__ inline int letterbox_out_bytes(bool yuv, int band,
                                                   int tw) {
  return yuv ? align16(band * tw + 32) + 2 * align16(band / 2 * (tw / 2) + 32)
             : align16(band * tw * 3 + 32);
}

__host__ __device__ inline int letterbox_smem(bool yuv, int band, int tw,
                                              int stage) {
  return align16(tw * static_cast<int>(sizeof(Tap))) +
         align16(band * static_cast<int>(sizeof(Tap))) +
         letterbox_out_bytes(yuv, band, tw) + stage;
}

// A block per band of `band` canvas rows (even) of one image (blockIdx.y):
// RGB [th, tw, 3] into o0, or with kYuv Y [th, tw] into o0 and Cb, Cr
// [th / 2, tw / 2] into o1, o2 (fastloader's rgb_to_yuv420: the four Y
// values of a 2 x 2 block and its Cb and Cr from the mean of its u8 RGB).
template <bool kYuv>
__global__ void __launch_bounds__(kThreads, kLetterboxBlocks)
letterbox_kernel(const int64_t* table, int th, int tw, int band, int stage,
                 uint8_t* o0, uint8_t* o1, uint8_t* o2) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Geometry sg;
  __shared__ int s_shift[3], s_sy[2];
  const int n = blockIdx.y;
  const int y0 = blockIdx.x * band, y1 = min(y0 + band, th), rows = y1 - y0;
  Tap* cols = reinterpret_cast<Tap*>(smem);
  Tap* rtaps = reinterpret_cast<Tap*>(
      smem + align16(tw * static_cast<int>(sizeof(Tap))));
  uint8_t* out = smem + align16(tw * static_cast<int>(sizeof(Tap))) +
                 align16(band * static_cast<int>(sizeof(Tap)));
  uint8_t* staged = out + letterbox_out_bytes(kYuv, band, tw);
  if (threadIdx.x == 0) sg = load_geometry(table, n);
  __syncthreads();
  const Geometry g = sg;
  // the content rows of the band, and their taps
  const int cy0 = max(y0, g.py), cy1 = min(y1, g.py + g.nh);
  const bool content = g.ok && cy0 < cy1;
  if (content) {
    const float xs = tap_scale(g.nw, g.w), ys = tap_scale(g.nh, g.h);
    for (int x = g.px + threadIdx.x; x < g.px + g.nw; x += blockDim.x) {
      cols[x] = tap(x - g.px, xs, g.w);
    }
    for (int y = cy0 + threadIdx.x; y < cy1; y += blockDim.x) {
      rtaps[y - y0] = tap(y - g.py, ys, g.h);
    }
  }
  __syncthreads();
  // the source rows the band touches, staged where they fit
  Band b{g, cols, rtaps, nullptr, 0, y0};
  if (content) {
    const int sy0 = rtaps[cy0 - y0].i0, sy1 = rtaps[cy1 - 1 - y0].i1;
    const int64_t bytes = static_cast<int64_t>(sy1 - sy0 + 1) * g.w * g.c;
    if (bytes + 30 <= stage) {
      stage_span(g.src + static_cast<int64_t>(sy0) * g.w * g.c, 0, 1,
                 static_cast<int>(bytes), staged, stage, s_shift);
      if (threadIdx.x == 0) s_sy[0] = sy0;
      __syncthreads();
      b.stage = staged + s_shift[0];
      b.sy0 = s_sy[0];
    }
  }
  // the band's output, into shared memory at each span's alignment
  if (kYuv) {
    const int cw = tw / 2;
    uint8_t* yo = o0 + (static_cast<int64_t>(n) * th + y0) * tw;
    uint8_t* cbo = o1 + (static_cast<int64_t>(n) * (th / 2) + y0 / 2) * cw;
    uint8_t* cro = o2 + (static_cast<int64_t>(n) * (th / 2) + y0 / 2) * cw;
    uint8_t* ys = out;
    uint8_t* cbs = ys + align16(band * tw + 32);
    uint8_t* crs = cbs + align16(band / 2 * cw + 32);
    const int ysh = static_cast<int>(reinterpret_cast<uintptr_t>(yo) & 15);
    const int cbsh = static_cast<int>(reinterpret_cast<uintptr_t>(cbo) & 15);
    const int crsh = static_cast<int>(reinterpret_cast<uintptr_t>(cro) & 15);
    for (int i = threadIdx.x; i < rows / 2 * cw; i += blockDim.x) {
      const int by = i / cw, bx = i - by * cw;
      int sum[3] = {0, 0, 0};
      Row pair[2];
      if (b.stage != nullptr) {
        pair[0] = staged_row(b, y0 + 2 * by);
        pair[1] = staged_row(b, y0 + 2 * by + 1);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int x = 2 * bx + (k & 1), yy = 2 * by + (k >> 1);
        int rgb[3];
        if (b.stage != nullptr) {
          staged_pixel(b, pair[k >> 1], x, rgb);
        } else {
          canvas_pixel(b, x, y0 + yy, rgb);
        }
        ys[ysh + yy * tw + x] = luma(rgb);
        sum[0] += rgb[0];
        sum[1] += rgb[1];
        sum[2] += rgb[2];
      }
      const float r = __fmul_rn(0.25f, exact_float(sum[0]));
      const float gg = __fmul_rn(0.25f, exact_float(sum[1]));
      const float bb = __fmul_rn(0.25f, exact_float(sum[2]));
      const float cb = __fadd_rn(
          __fadd_rn(__fadd_rn(__fadd_rn(128.0f, -__fmul_rn(0.168736f, r)),
                              -__fmul_rn(0.331264f, gg)),
                    __fmul_rn(0.5f, bb)),
          0.5f);
      const float cr = __fadd_rn(
          __fadd_rn(__fadd_rn(__fadd_rn(128.0f, __fmul_rn(0.5f, r)),
                              -__fmul_rn(0.418688f, gg)),
                    -__fmul_rn(0.081312f, bb)),
          0.5f);
      cbs[cbsh + i] = clamp_u8(cb);
      crs[crsh + i] = clamp_u8(cr);
    }
    __syncthreads();
    store_span(yo, rows * tw, ys);
    store_span(cbo, rows / 2 * cw, cbs);
    store_span(cro, rows / 2 * cw, crs);
  } else {
    uint8_t* ro = o0 + (static_cast<int64_t>(n) * th + y0) * tw * 3;
    const int rsh = static_cast<int>(reinterpret_cast<uintptr_t>(ro) & 15);
    for (int i = threadIdx.x; i < rows * tw; i += blockDim.x) {
      const int yy = i / tw, x = i - yy * tw;
      int rgb[3];
      if (b.stage != nullptr) {
        staged_pixel(b, staged_row(b, y0 + yy), x, rgb);
      } else {
        canvas_pixel(b, x, y0 + yy, rgb);
      }
      uint8_t* o = out + rsh + 3 * i;
      o[0] = static_cast<uint8_t>(rgb[0]);
      o[1] = static_cast<uint8_t>(rgb[1]);
      o[2] = static_cast<uint8_t>(rgb[2]);
    }
    __syncthreads();
    store_span(ro, rows * tw * 3, out);
  }
}

// ---------------------------------------------------------------------------
// ycc_to_rgb

constexpr int kYccParams = 14;   // int64 per image, see ycc_to_rgb_kernel
constexpr int kYccRows = 8;      // output rows of a tile
constexpr int kYccCols = 256;    // output columns of a tile
constexpr int kYccStride = kYccCols + 32;       // a staged row, bytes
// chroma rows staged: the tile's own (uv = 1), or half of them and the
// halo (uv = 2)
constexpr int kYccChromaRows =
    kYccRows > kYccRows / 2 + 2 ? kYccRows : kYccRows / 2 + 2;
constexpr int kYccOutStride = 3 * kYccCols + 32;

// A chroma plane as staged: reduced samples (i, j) of a plane w x h
// (after libjpeg's IDCT at the output scale), rows r0.. of the tile's
// region, columns c0.., each staged row at its own offset.
struct Staged {
  const uint8_t* s;
  const int* shift;
  int r0, c0, w, h;
  __device__ __forceinline__ int at(int i, int j) const {
    return s[(j - r0) * kYccStride + shift[j - r0] + i - c0];
  }
};

// 3 x the sample in row `near` + the one in row `far`, column k.
__device__ __forceinline__ int colsum(const Staged& c, int k, int near,
                                      int far) {
  return 3 * c.at(k, near) + c.at(k, far);
}

// Plane c upsampled by (uh, uv) in {1, 2}, at output pixel (x, y), as
// libjpeg-turbo does (jdsample.c): with `fancy`, the h2v2, h2v1 and h1v2
// triangles, the row outside the plane being its nearest row, and a plane
// two samples wide or less replicated (h2v1, h2v2); without, replication.
__device__ __forceinline__ int upsampled(const Staged& c, int uh, int uv,
                                         bool fancy, int x, int y) {
  if (uv == 2) {
    const int r = y >> 1;
    const int fr = min(max((y & 1) ? r + 1 : r - 1, 0), c.h - 1);
    if (uh == 1) {
      if (!fancy) return c.at(x, r);
      return (colsum(c, x, r, fr) + ((y & 1) ? 2 : 1)) >> 2;
    }
    const int j = x >> 1;
    if (!fancy || c.w <= 2) return c.at(j, r);
    const int t = colsum(c, j, r, fr);
    if ((x & 1) == 0) {
      return j == 0 ? (t * 4 + 8) >> 4
                    : (t * 3 + colsum(c, j - 1, r, fr) + 8) >> 4;
    }
    return j == c.w - 1 ? (t * 4 + 7) >> 4
                        : (t * 3 + colsum(c, j + 1, r, fr) + 7) >> 4;
  }
  if (uh == 1) return c.at(x, y);
  const int j = x >> 1;
  if (!fancy || c.w <= 2) return c.at(j, y);
  if ((x & 1) == 0) {
    return j == 0 ? c.at(0, y) : (3 * c.at(j, y) + c.at(j - 1, y) + 1) >> 2;
  }
  return j == c.w - 1 ? c.at(j, y)
                      : (3 * c.at(j, y) + c.at(j + 1, y) + 2) >> 2;
}

// The pair of output pixels (x, y), (x + 1, y), x even, of plane c
// upsampled by (uh, uv): upsampled() of each, with the work of a pair
// shared and no branch on the pixel's parity.  The triangle filters'
// edge cases are their general case with the neighbour's index clamped:
// (4t + 8) >> 4 at the left edge and (4t + 7) >> 4 at the right (h2v2),
// (4a + 1) >> 2 = (4a + 2) >> 2 = a (h2v1).
__device__ __forceinline__ void upsampled_pair(const Staged& c, int uh,
                                               int uv, bool fancy, int x,
                                               int y, int* even, int* odd) {
  if (uh == 1) {
    *even = upsampled(c, 1, uv, fancy, x, y);
    *odd = upsampled(c, 1, uv, fancy, x + 1, y);
    return;
  }
  const int j = x >> 1, jp = max(j - 1, 0), jn = min(j + 1, c.w - 1);
  if (!fancy || c.w <= 2) {
    *even = *odd = c.at(j, uv == 2 ? y >> 1 : y);
    return;
  }
  if (uv == 2) {
    const int r = y >> 1;
    const int fr = min(max((y & 1) ? r + 1 : r - 1, 0), c.h - 1);
    const int t = colsum(c, j, r, fr);
    *even = (t * 3 + colsum(c, jp, r, fr) + 8) >> 4;
    *odd = (t * 3 + colsum(c, jn, r, fr) + 7) >> 4;
    return;
  }
  const int a = c.at(j, y);
  *even = (3 * a + c.at(jp, y) + 1) >> 2;
  *odd = (3 * a + c.at(jn, y) + 2) >> 2;
}

__device__ __forceinline__ uint8_t clamp255(int v) {
  return static_cast<uint8_t>(min(max(v, 0), 255));
}

// Stage a chroma plane's region: rows rr0..rr1 and columns cc0..cc1 of
// the plane reduced by r (r = 1: the plane itself, as 16-byte chunks).
__device__ __forceinline__ void stage_chroma(const uint8_t* p, int cw,
                                             int ch, int r, int rr0, int rr1,
                                             int cc0, int cc1, uint8_t* dst,
                                             int* shift) {
  const int rows = rr1 - rr0 + 1, n = cc1 - cc0 + 1;
  if (r == 1) {
    stage_span(p + static_cast<int64_t>(rr0) * cw + cc0, cw, rows, n, dst,
               kYccStride, shift);
    return;
  }
  for (int i = threadIdx.x; i < rows * n; i += blockDim.x) {
    const int k = i / n, c = i - k * n;
    dst[k * kYccStride + c] = static_cast<uint8_t>(
        block_mean(p, cw, ch, 1, (cc0 + c) * r, (rr0 + k) * r, r, r));
  }
  for (int k = threadIdx.x; k < rows; k += blockDim.x) shift[k] = 0;
}

// Planar YCbCr -> interleaved RGB for a batch: a block per tile of
// kYccRows x kYccCols output pixels (blockIdx.x, row-major over the
// image's tiles) of image blockIdx.y.  Table row (int64): y, cb, cr, out
// pointers; w, h (luma), cw, ch (chroma planes); d; r, uh, uv, fancy
// (cuda_jpeg.scaled_chroma); channels (3, or 1: a gray image, its luma
// alone).  Blocks past the image's own tiles return at once.  out is
// [ceil(h / d), ceil(w / d),
// channels], converted with libjpeg's 16-bit fixed-point tables
// (FIX(1.402) = 91881, FIX(1.772) = 116130, FIX(0.71414) = 46802,
// FIX(0.34414) = 22554, ONE_HALF = 32768).  Luma is reduced by the d x d
// block mean that stands in for libjpeg's DCT-domain scaling, the chroma
// by r x r and then upsampled by (uh, uv) as libjpeg does at that scale.
__global__ void __launch_bounds__(kThreads, kYccBlocks) ycc_to_rgb_kernel(
    const int64_t* table) {
  __shared__ int64_t t[kYccParams];
  __shared__ __align__(16) uint8_t sy[kYccRows * kYccStride];
  __shared__ __align__(16) uint8_t sb[kYccChromaRows * kYccStride];
  __shared__ __align__(16) uint8_t sr[kYccChromaRows * kYccStride];
  __shared__ __align__(16) uint8_t so[kYccRows * kYccOutStride];
  __shared__ int shy[kYccRows], shb[kYccChromaRows], shr[kYccChromaRows];
  if (threadIdx.x < kYccParams) {
    t[threadIdx.x] = table[static_cast<int64_t>(blockIdx.y) * kYccParams +
                           threadIdx.x];
  }
  __syncthreads();
  const uint8_t* y = reinterpret_cast<const uint8_t*>(t[0]);
  const uint8_t* cb = reinterpret_cast<const uint8_t*>(t[1]);
  const uint8_t* cr = reinterpret_cast<const uint8_t*>(t[2]);
  uint8_t* out = reinterpret_cast<uint8_t*>(t[3]);
  const int w = static_cast<int>(t[4]), h = static_cast<int>(t[5]);
  const int cw = static_cast<int>(t[6]), ch = static_cast<int>(t[7]);
  const int d = static_cast<int>(t[8]), r = static_cast<int>(t[9]);
  const int uh = static_cast<int>(t[10]), uv = static_cast<int>(t[11]);
  const bool fancy = t[12] != 0;
  const int channels = static_cast<int>(t[13]);
  const int ow = (w + d - 1) / d, oh = (h + d - 1) / d;
  const int tiles_x = (ow + kYccCols - 1) / kYccCols;
  if (static_cast<int>(blockIdx.x) >=
      tiles_x * ((oh + kYccRows - 1) / kYccRows)) {
    return;
  }
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
  const int oy0 = ty * kYccRows, ox0 = tx * kYccCols;
  const int oy1 = min(oy0 + kYccRows, oh), ox1 = min(ox0 + kYccCols, ow);
  const int cols = ox1 - ox0;
  // stage: luma rows at d = 1, the chroma region with its halo
  if (d == 1) {
    stage_span(y + static_cast<int64_t>(oy0) * w + ox0, w, oy1 - oy0, cols,
               sy, kYccStride, shy);
  }
  const int rw = (cw + r - 1) / r, rh = (ch + r - 1) / r;
  int rr0 = oy0, rr1 = oy1 - 1, cc0 = ox0, cc1 = ox1 - 1;
  if (uv == 2) {
    rr0 = max((oy0 >> 1) - 1, 0);
    rr1 = min(((oy1 - 1) >> 1) + 1, rh - 1);
  }
  if (uh == 2) {
    cc0 = max((ox0 >> 1) - 1, 0);
    cc1 = min(((ox1 - 1) >> 1) + 1, rw - 1);
  }
  if (channels == 3) {
    stage_chroma(cb, cw, ch, r, rr0, rr1, cc0, cc1, sb, shb);
    stage_chroma(cr, cw, ch, r, rr0, rr1, cc0, cc1, sr, shr);
  }
  __syncthreads();
  const Staged pb{sb, shb, rr0, cc0, rw, rh}, pr{sr, shr, rr0, cc0, rw, rh};
  // convert, a pair of pixels a thread at a time, into the output rows at
  // their spans' alignment
  const uintptr_t base = reinterpret_cast<uintptr_t>(out);
  constexpr int kPairs = kYccCols / 2;
  for (int i = threadIdx.x; i < kYccRows * kPairs; i += blockDim.x) {
    const int k = i / kPairs, c = 2 * (i - k * kPairs);
    const int py = oy0 + k, px = ox0 + c;
    if (py >= oy1 || px >= ox1) continue;
    const bool two = px + 1 < ox1;
    int l[2];
    if (d == 1) {
      l[0] = sy[k * kYccStride + shy[k] + c];
      l[1] = two ? sy[k * kYccStride + shy[k] + c + 1] : 0;
    } else {
      l[0] = block_mean(y, w, h, 1, px * d, py * d, d, d);
      l[1] = two ? block_mean(y, w, h, 1, (px + 1) * d, py * d, d, d) : 0;
    }
    const int shift = static_cast<int>(
        (base + (static_cast<uintptr_t>(py) * ow + ox0) * channels) & 15);
    uint8_t* o = so + k * kYccOutStride + shift + c * channels;
    if (channels == 1) {
      o[0] = static_cast<uint8_t>(l[0]);
      if (two) o[1] = static_cast<uint8_t>(l[1]);
      continue;
    }
    int b[2], r[2];
    upsampled_pair(pb, uh, uv, fancy, px, py, &b[0], &b[1]);
    upsampled_pair(pr, uh, uv, fancy, px, py, &r[0], &r[1]);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q == 1 && !two) break;
      const int xb = b[q] - 128, xr = r[q] - 128;
      o[3 * q] = clamp255(l[q] + ((91881 * xr + 32768) >> 16));
      o[3 * q + 1] =
          clamp255(l[q] + (((-22554 * xb + 32768) + (-46802 * xr)) >> 16));
      o[3 * q + 2] = clamp255(l[q] + ((116130 * xb + 32768) >> 16));
    }
  }
  __syncthreads();
  for (int k = 0; k < oy1 - oy0; ++k) {
    store_span(out + (static_cast<int64_t>(oy0 + k) * ow + ox0) * channels,
               cols * channels, so + k * kYccOutStride);
  }
}

// nvJPEG's handle and decode state, one per device and calling thread.
struct Decoder {
  int device;
  nvjpegHandle_t handle;
  nvjpegJpegState_t state;
};

}  // namespace

extern "C" {

// nvJPEG's version as major * 1000 + minor * 10 + patch.
int mgd_jpeg_version() {
  int major = 0, minor = 0, patch = 0;
  nvjpegGetProperty(MAJOR_VERSION, &major);
  nvjpegGetProperty(MINOR_VERSION, &minor);
  nvjpegGetProperty(PATCH_LEVEL, &patch);
  return major * 1000 + minor * 10 + patch;
}

// Whether nvJPEG's backend (an nvjpegBackend_t) can be created here: 0, or
// the nvjpegStatus_t it returned.
int mgd_jpeg_backend_status(int device, int backend) {
  cudaSetDevice(device);
  nvjpegHandle_t h;
  const nvjpegStatus_t s = nvjpegCreateEx(
      static_cast<nvjpegBackend_t>(backend), nullptr, nullptr, 0, &h);
  if (s == NVJPEG_STATUS_SUCCESS) nvjpegDestroy(h);
  return static_cast<int>(s);
}

// A decoder on `device` with nvJPEG's default backend (Huffman decode on the
// host, IDCT and colour conversion on the card).  Returns an
// nvjpegStatus_t; *out is the context on success.
int mgd_jpeg_create(int device, void** out) {
  cudaSetDevice(device);
  Decoder* d = new Decoder{device, nullptr, nullptr};
  nvjpegStatus_t s = nvjpegCreateSimple(&d->handle);
  if (s == NVJPEG_STATUS_SUCCESS) s = nvjpegJpegStateCreate(d->handle,
                                                            &d->state);
  if (s != NVJPEG_STATUS_SUCCESS) {
    if (d->handle) nvjpegDestroy(d->handle);
    delete d;
    return static_cast<int>(s);
  }
  *out = d;
  return 0;
}

int mgd_jpeg_destroy(void* ctx) {
  Decoder* d = static_cast<Decoder*>(ctx);
  cudaSetDevice(d->device);
  nvjpegJpegStateDestroy(d->state);
  const nvjpegStatus_t s = nvjpegDestroy(d->handle);
  delete d;
  return static_cast<int>(s);
}

// The header of a JPEG in host memory: width, height, components, the
// chroma subsampling (an nvjpegChromaSubsampling_t) and the size of the
// second component's plane.  Returns an nvjpegStatus_t.
int mgd_jpeg_info(void* ctx, const unsigned char* data, size_t size, int* w,
                  int* h, int* components, int* subsampling, int* cw,
                  int* ch) {
  Decoder* d = static_cast<Decoder*>(ctx);
  int ws[NVJPEG_MAX_COMPONENT] = {}, hs[NVJPEG_MAX_COMPONENT] = {};
  nvjpegChromaSubsampling_t css;
  const nvjpegStatus_t s =
      nvjpegGetImageInfo(d->handle, data, size, components, &css, ws, hs);
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  *w = ws[0];
  *h = hs[0];
  *cw = ws[1];
  *ch = hs[1];
  *subsampling = static_cast<int>(css);
  return 0;
}

// Decode a JPEG in host memory at full size on `stream` into up to three
// planes on the card: `format` 0 is luma alone (NVJPEG_OUTPUT_Y), 1 the
// YCbCr planes at their own resolution (NVJPEG_OUTPUT_YUV).
// Returns an nvjpegStatus_t, or 100 + a cudaError_t.
int mgd_jpeg_decode(void* ctx, const unsigned char* data, size_t size,
                    int format, unsigned char* p0, int pitch0,
                    unsigned char* p1, int pitch1, unsigned char* p2,
                    int pitch2, void* stream) {
  Decoder* d = static_cast<Decoder*>(ctx);
  cudaSetDevice(d->device);
  nvjpegImage_t img = {};
  img.channel[0] = p0;
  img.pitch[0] = static_cast<unsigned int>(pitch0);
  img.channel[1] = p1;
  img.pitch[1] = static_cast<unsigned int>(pitch1);
  img.channel[2] = p2;
  img.pitch[2] = static_cast<unsigned int>(pitch2);
  const nvjpegOutputFormat_t formats[2] = {NVJPEG_OUTPUT_Y,
                                           NVJPEG_OUTPUT_YUV};
  if (format < 0 || format > 1) return NVJPEG_STATUS_INVALID_PARAMETER;
  const nvjpegStatus_t s =
      nvjpegDecode(d->handle, d->state, data, size, formats[format], &img,
                   static_cast<cudaStream_t>(stream));
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : 100 + static_cast<int>(e);
}

// table: [n, 14] int64 on the card (see ycc_to_rgb_kernel); max_ow and
// max_oh the largest output width and height of the batch, which size the
// grid: the tiles of the largest image by n.
int mgd_ycc_to_rgb(int device, const int64_t* table, int n, int max_ow,
                   int max_oh, void* stream) {
  cudaSetDevice(device);
  const int tiles = ((max_ow + kYccCols - 1) / kYccCols) *
                    ((max_oh + kYccRows - 1) / kYccRows);
  if (n == 0 || tiles == 0) return 0;
  ycc_to_rgb_kernel<<<dim3(tiles, n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(table);
  return static_cast<int>(cudaGetLastError());
}

// The most shared memory a letterbox block may ask for (the card's 227 KB
// less room for the kernel's static variables).
int mgd_letterbox_smem_limit() { return 232448 - 1024; }

// Shared memory of a letterbox block for the canvas width, band and
// staging bytes (the wrapper sizes `stage` from the batch's sources).
int mgd_letterbox_smem(int yuv, int band, int tw, int stage) {
  return letterbox_smem(yuv != 0, band, tw, stage);
}

}  // extern "C"

namespace {

template <bool kYuv>
int launch_letterbox(int device, const int64_t* table, int n, int th, int tw,
                     int band, int stage, uint8_t* o0, uint8_t* o1,
                     uint8_t* o2, void* stream) {
  cudaSetDevice(device);
  const int smem = letterbox_smem(kYuv, band, tw, stage);
  if (band <= 0 || band % 2 || smem > mgd_letterbox_smem_limit()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        letterbox_kernel<kYuv>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((th + band - 1) / band, n);
  letterbox_kernel<kYuv><<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      table, th, tw, band, stage, o0, o1, o2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// table: [n, 9] int64 on the card (see Geometry); out [n, th, tw, 3] u8;
// a block per `band` canvas rows (even), `stage` bytes to stage its
// source rows.
int mgd_letterbox_rgb(int device, const int64_t* table, int n, int th, int tw,
                      int band, int stage, uint8_t* out, void* stream) {
  return launch_letterbox<false>(device, table, n, th, tw, band, stage, out,
                                 nullptr, nullptr, stream);
}

// y [n, th, tw], cb and cr [n, th / 2, tw / 2] u8; th and tw even.
int mgd_letterbox_yuv420(int device, const int64_t* table, int n, int th,
                         int tw, int band, int stage, uint8_t* y,
                         uint8_t* cb, uint8_t* cr, void* stream) {
  return launch_letterbox<true>(device, table, n, th, tw, band, stage, y, cb,
                                cr, stream);
}

}  // extern "C"
