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
//                                      native/fastloader.cpp:44-105)
//   letterbox_rgb_kernel     replaces  load_one + bilinear_into
//                                      (native/fastloader.cpp:107-146,
//                                      165-190)
//   letterbox_yuv420_kernel  replaces  the same, then rgb_to_yuv420
//                                      (native/fastloader.cpp:209-238)
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
// upsamples the chroma only where libjpeg then does, and the letterbox
// kernels reduce a gray image.  At d = 1 (a canvas more than half the image's size on
// either side, as at 416 and 608 on COCO's images) nothing is reduced.
//
// Bound on the card: bytes.  ycc_to_rgb reads the planes (1.5 to 3 bytes a
// pixel) and writes 3; each letterbox output pixel reads its four taps (d x
// d source pixels each) and writes three or one and a half bytes.  One
// thread per pixel (RGB) or per 2 x 2 block (4:2:0), the image's geometry
// read from a small per-image table.  The arithmetic repeats fastloader's
// float operations one by one with round-to-nearest intrinsics (__fmul_rn
// and __fadd_rn are never contracted into an FMA), so the canvases equal
// the plain PyTorch versions bit for bit.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kParams = 10;   // int64 per image, see struct Geometry

// One row of the per-image table (int64 each): the decoded source's device
// pointer, its width, height and channels (1 gray or 3 RGB), the divisor,
// the content size and offset on the canvas, and whether the slot decoded.
struct Geometry {
  const uint8_t* src;
  int w, h, c, d, nw, nh, px, py, ok;
};

__device__ __forceinline__ Geometry load_geometry(const int64_t* table,
                                                  int n) {
  const int64_t* t = table + static_cast<int64_t>(n) * kParams;
  Geometry g;
  g.src = reinterpret_cast<const uint8_t*>(t[0]);
  g.w = static_cast<int>(t[1]);
  g.h = static_cast<int>(t[2]);
  g.c = static_cast<int>(t[3]);
  g.d = static_cast<int>(t[4]);
  g.nw = static_cast<int>(t[5]);
  g.nh = static_cast<int>(t[6]);
  g.px = static_cast<int>(t[7]);
  g.py = static_cast<int>(t[8]);
  g.ok = static_cast<int>(t[9]);
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

// Pixel (x, y) of the source reduced by d: the rounded mean of its d x d
// block, cut at the image's edge.  Channel ch of a gray source is its one
// channel.
__device__ __forceinline__ int reduced(const Geometry& g, int x, int y,
                                       int ch) {
  const int cc = g.c == 1 ? 0 : ch;
  if (g.d == 1) return g.src[(static_cast<int64_t>(y) * g.w + x) * g.c + cc];
  return block_mean(g.src + cc, g.w, g.h, g.c, x * g.d, y * g.d, g.d, g.d);
}

// Source coordinate of output index i (of n) over a source of s samples:
// half-pixel centres, clamped (fastloader's bilinear_into).
__device__ __forceinline__ void tap(int i, int n, int s, int* i0, int* i1,
                                    float* frac) {
  const float scale = __fdiv_rn(static_cast<float>(s), static_cast<float>(n));
  float f = __fadd_rn(__fmul_rn(__fadd_rn(static_cast<float>(i), 0.5f), scale),
                      -0.5f);
  f = fmaxf(0.0f, fminf(f, static_cast<float>(s - 1)));
  *i0 = static_cast<int>(f);
  *i1 = min(*i0 + 1, s - 1);
  *frac = __fadd_rn(f, -static_cast<float>(*i0));
}

// Canvas pixel (x, y) of image g, its three channels into rgb[3].
__device__ __forceinline__ void canvas_pixel(const Geometry& g, int x, int y,
                                             int rgb[3]) {
  const int cx = x - g.px, cy = y - g.py;
  if (!g.ok || cx < 0 || cy < 0 || cx >= g.nw || cy >= g.nh) {
    rgb[0] = rgb[1] = rgb[2] = 128;
    return;
  }
  const int sw = (g.w + g.d - 1) / g.d, sh = (g.h + g.d - 1) / g.d;
  int x0, x1, y0, y1;
  float wx, wy;
  tap(cx, g.nw, sw, &x0, &x1, &wx);
  tap(cy, g.nh, sh, &y0, &y1, &wy);
  for (int ch = 0; ch < 3; ++ch) {
    const int a = reduced(g, x0, y0, ch), b = reduced(g, x1, y0, ch);
    const int c = reduced(g, x0, y1, ch), e = reduced(g, x1, y1, ch);
    const float top = __fadd_rn(static_cast<float>(a),
                                __fmul_rn(static_cast<float>(b - a), wx));
    const float bot = __fadd_rn(static_cast<float>(c),
                                __fmul_rn(static_cast<float>(e - c), wx));
    const float v = __fadd_rn(
        __fadd_rn(top, __fmul_rn(__fadd_rn(bot, -top), wy)), 0.5f);
    rgb[ch] = static_cast<int>(v);
  }
}

__device__ __forceinline__ uint8_t clamp_u8(float v) {
  return static_cast<uint8_t>(static_cast<int>(fminf(255.0f, fmaxf(0.0f, v))));
}

// Y of one u8 RGB pixel, in fastloader's order of operations.
__device__ __forceinline__ uint8_t luma(const int p[3]) {
  const float y = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(0.299f, static_cast<float>(p[0])),
                          __fmul_rn(0.587f, static_cast<float>(p[1]))),
                __fmul_rn(0.114f, static_cast<float>(p[2]))),
      0.5f);
  return clamp_u8(y);
}

__global__ void letterbox_rgb_kernel(const int64_t* table, int th, int tw,
                                     uint8_t* out) {
  const int n = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= th * tw) return;
  const Geometry g = load_geometry(table, n);
  int rgb[3];
  canvas_pixel(g, i % tw, i / tw, rgb);
  uint8_t* o = out + (static_cast<int64_t>(n) * th * tw + i) * 3;
  o[0] = static_cast<uint8_t>(rgb[0]);
  o[1] = static_cast<uint8_t>(rgb[1]);
  o[2] = static_cast<uint8_t>(rgb[2]);
}

// One thread per 2 x 2 block: four Y values, one Cb and one Cr from the
// mean of the block's u8 RGB (fastloader's rgb_to_yuv420).
__global__ void letterbox_yuv420_kernel(const int64_t* table, int th, int tw,
                                        uint8_t* y_out, uint8_t* cb_out,
                                        uint8_t* cr_out) {
  const int n = blockIdx.y;
  const int ch = th / 2, cw = tw / 2;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ch * cw) return;
  const Geometry g = load_geometry(table, n);
  const int bx = i % cw, by = i / cw;
  int sum[3] = {0, 0, 0};
  uint8_t* yp = y_out + static_cast<int64_t>(n) * th * tw;
  for (int k = 0; k < 4; ++k) {
    const int x = 2 * bx + (k & 1), y = 2 * by + (k >> 1);
    int rgb[3];
    canvas_pixel(g, x, y, rgb);
    yp[static_cast<int64_t>(y) * tw + x] = luma(rgb);
    sum[0] += rgb[0];
    sum[1] += rgb[1];
    sum[2] += rgb[2];
  }
  const float r = __fmul_rn(0.25f, static_cast<float>(sum[0]));
  const float gg = __fmul_rn(0.25f, static_cast<float>(sum[1]));
  const float b = __fmul_rn(0.25f, static_cast<float>(sum[2]));
  const float cb = __fadd_rn(
      __fadd_rn(__fadd_rn(__fadd_rn(128.0f, -__fmul_rn(0.168736f, r)),
                          -__fmul_rn(0.331264f, gg)),
                __fmul_rn(0.5f, b)),
      0.5f);
  const float cr = __fadd_rn(
      __fadd_rn(__fadd_rn(__fadd_rn(128.0f, __fmul_rn(0.5f, r)),
                          -__fmul_rn(0.418688f, gg)),
                -__fmul_rn(0.081312f, b)),
      0.5f);
  const int64_t c = static_cast<int64_t>(n) * ch * cw + i;
  cb_out[c] = clamp_u8(cb);
  cr_out[c] = clamp_u8(cr);
}

// A chroma plane (cw x ch) as libjpeg's IDCT gives it at the output
// scale: each sample the rounded mean of an r x r block of the full plane
// (r = 1: the plane itself), w x h = ceil(cw / r) x ceil(ch / r) samples.
struct Plane {
  const uint8_t* p;
  int cw, ch, r, w, h;
  __device__ __forceinline__ int at(int i, int j) const {
    return r == 1 ? p[static_cast<int64_t>(j) * cw + i]
                  : block_mean(p, cw, ch, 1, i * r, j * r, r, r);
  }
};

// 3 x the sample in row `near` + the one in row `far`, column k.
__device__ __forceinline__ int colsum(const Plane& c, int k, int near,
                                      int far) {
  return 3 * c.at(k, near) + c.at(k, far);
}

// Plane c upsampled by (uh, uv) in {1, 2}, at output pixel (x, y), as
// libjpeg-turbo does (jdsample.c): with `fancy`, the h2v2, h2v1 and h1v2
// triangles, the row outside the plane being its nearest row, and a plane
// two samples wide or less replicated (h2v1, h2v2); without, replication.
__device__ __forceinline__ int upsampled(const Plane& c, int uh, int uv,
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

__device__ __forceinline__ uint8_t clamp255(int v) {
  return static_cast<uint8_t>(min(max(v, 0), 255));
}

// Planar YCbCr (y: w x h; cb, cr: cw x ch) -> interleaved RGB
// [ceil(h / d), ceil(w / d), 3], converted with libjpeg's 16-bit
// fixed-point tables (FIX(1.402) = 91881, FIX(1.772) = 116130,
// FIX(0.71414) = 46802, FIX(0.34414) = 22554, ONE_HALF = 32768).  Luma is
// reduced by the d x d block mean that stands in for libjpeg's DCT-domain
// scaling, the chroma by r x r and then upsampled by (uh, uv) as libjpeg
// does at that scale (cuda_jpeg.scaled_chroma gives r, uh, uv and fancy;
// at d = 1: r = 1, the plane's own subsampling, fancy).  One thread per
// output pixel.
__global__ void ycc_to_rgb_kernel(const uint8_t* y, const uint8_t* cb,
                                  const uint8_t* cr, int w, int h, int cw,
                                  int ch, int d, int r, int uh, int uv,
                                  int fancy, uint8_t* out) {
  const int ow = (w + d - 1) / d, oh = (h + d - 1) / d;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= static_cast<int64_t>(ow) * oh) return;
  const int px = static_cast<int>(i % ow), py = static_cast<int>(i / ow);
  const int l = d == 1 ? y[i] : block_mean(y, w, h, 1, px * d, py * d, d, d);
  const int rw = (cw + r - 1) / r, rh = (ch + r - 1) / r;
  const Plane pb{cb, cw, ch, r, rw, rh}, pr{cr, cw, ch, r, rw, rh};
  const int xb = upsampled(pb, uh, uv, fancy != 0, px, py) - 128;
  const int xr = upsampled(pr, uh, uv, fancy != 0, px, py) - 128;
  uint8_t* o = out + i * 3;
  o[0] = clamp255(l + ((91881 * xr + 32768) >> 16));
  o[1] = clamp255(l + (((-22554 * xb + 32768) + (-46802 * xr)) >> 16));
  o[2] = clamp255(l + ((116130 * xb + 32768) >> 16));
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

// y [h, w], cb and cr [ch, cw] u8 -> out [ceil(h / d), ceil(w / d), 3] u8;
// d in {1, 2, 4, 8}, r the chroma's reduction, uh and uv its upsampling.
int mgd_ycc_to_rgb(int device, const uint8_t* y, const uint8_t* cb,
                   const uint8_t* cr, int w, int h, int cw, int ch, int d,
                   int r, int uh, int uv, int fancy, uint8_t* out,
                   void* stream) {
  cudaSetDevice(device);
  const int64_t n = static_cast<int64_t>((w + d - 1) / d) * ((h + d - 1) / d);
  ycc_to_rgb_kernel<<<static_cast<unsigned int>((n + kThreads - 1) /
                                                kThreads),
                      kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      y, cb, cr, w, h, cw, ch, d, r, uh, uv, fancy, out);
  return static_cast<int>(cudaGetLastError());
}

// table: [n, 10] int64 on the card (see Geometry); out [n, th, tw, 3] u8.
int mgd_letterbox_rgb(int device, const int64_t* table, int n, int th, int tw,
                      uint8_t* out, void* stream) {
  cudaSetDevice(device);
  const dim3 grid((th * tw + kThreads - 1) / kThreads, n);
  letterbox_rgb_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(table, th, tw,
                                                              out);
  return static_cast<int>(cudaGetLastError());
}

// y [n, th, tw], cb and cr [n, th / 2, tw / 2] u8; th and tw even.
int mgd_letterbox_yuv420(int device, const int64_t* table, int n, int th,
                         int tw, uint8_t* y, uint8_t* cb, uint8_t* cr,
                         void* stream) {
  cudaSetDevice(device);
  const dim3 grid(((th / 2) * (tw / 2) + kThreads - 1) / kThreads, n);
  letterbox_yuv420_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      table, th, tw, y, cb, cr);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
