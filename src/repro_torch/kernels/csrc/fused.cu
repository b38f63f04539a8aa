// The two kernels of src/repro/kernels/fused.py:
//
// fuseconv_fused — a whole FuSeConv block in one launch: the Kx1 row bank
//   and the 1xK column bank (XLA-SAME padding, stride 1 or 2), the concat,
//   the folded inference-BatchNorm affine, the activation, and the 1x1 mix
//   with w_pw.  Replaces fused.py::fuseconv_fused (body
//   _fuseconv_fused_kernel at fused.py:119, pl.pallas_call at fused.py:212).
//
//   What bounds it on the H100: at MobileNetV3-Large's shapes the mix
//   dominates the arithmetic (2 * c_sp * Cout flops per output pixel against
//   K * c_sp for the banks) and the input and output tensors dominate the
//   bytes; with c_sp <= 240 and Cout <= 80 on the non-SE blocks it does
//   roughly 10..60 flops per byte, near the fp32 ridge (20 flops per byte),
//   so both device memory and the CUDA cores' 67 TFLOP/s bound it.  What it
//   must avoid is the decomposed path's extra round trip of the c_sp-channel
//   spatial tensor through device memory.
//
//   Design: a 256-thread block owns 64 output pixels (flattened over batch,
//   rows and columns) and 64 output channels.  It walks the spatial channels
//   in chunks of 16: each thread computes 4 spatial values (K taps each,
//   padding handled by bounds checks, channel fastest so the reads
//   coalesce), applies affine and activation, and stores them in shared
//   memory next to the matching 16x64 slice of w_pw; then every thread
//   accumulates a 4x4 tile of the mix in registers.  The activation is per
//   channel, so chunking is exact, and the spatial intermediate never
//   reaches device memory.  The bank values are recomputed once per
//   64-channel output block (Cout <= 80 on the path: at most twice).
//
// depthwise_kxk — KxK depthwise convolution, XLA-SAME, stride 1 or 2.
//   Replaces fused.py::depthwise_kxk (body _depthwise_kxk_kernel at
//   fused.py:241, pl.pallas_call at fused.py:285).
//
//   What bounds it on the H100: device memory; K*K FMAs per output against
//   one read of the input and one write of the output (2..11 flops per
//   byte at stride 1..2, K = 3..5).
//
//   Design: one thread per output element, channel fastest so a warp reads
//   32 neighbouring channels of one pixel; the K*K taps are unrolled for
//   K = 3, 5 and 7, their re-reads of neighbouring pixels hit L1/L2, and
//   the SAME padding is a bounds check instead of a padded copy.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// Activation codes shared with kernels/fused.py::_ACT_CODES.
__device__ __forceinline__ float apply_act(float v, int act) {
  switch (act) {
    case 1: return fmaxf(v, 0.0f);                                  // relu
    case 2: return fminf(fmaxf(v, 0.0f), 6.0f);                     // relu6
    case 3: return v * fminf(fmaxf(v + 3.0f, 0.0f), 6.0f) / 6.0f;   // hswish
    default: return v;                                              // linear
  }
}

// ---------------------------------------------------------------------------
// fuseconv_fused
// ---------------------------------------------------------------------------

constexpr int FP = 64;   // output pixels per block
constexpr int FN = 64;   // output channels per block
constexpr int FK = 16;   // spatial channels per chunk
constexpr int PIX_PER_THREAD = FP * FK / THREADS;   // 4

struct FusedArgs {
  const float* x;      // (b, h, w, c)
  const float* wr;     // (k, c_r)   row-bank taps
  const float* wc;     // (k, c_c)   column-bank taps
  const float* scale;  // (c_sp,)
  const float* bias;   // (c_sp,)
  const float* wp;     // (c_sp, cout)
  float* y;            // (b, oh, ow, cout)
  int b, h, w, c, k, stride, lo_h, lo_w, oh, ow;
  int c_r, c_c, col_src0, c_sp, cout, act;
};

__global__ void __launch_bounds__(THREADS) fuseconv_kernel(FusedArgs p) {
  __shared__ float s_sp[FK][FP + 1];
  __shared__ float s_w[FK][FN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  // int indices: the wrapper keeps every tensor below 2^30 elements
  const int npix = p.b * p.oh * p.ow;
  const int pix0 = blockIdx.x * FP;
  const int n0 = blockIdx.y * FN;

  // This thread's spatial work: chunk channel tid % FK for the pixels
  // (tid + i * THREADS) / FK, i < PIX_PER_THREAD.
  const int jl = tid % FK;
  int xoff[PIX_PER_THREAD];   // offset of (batch, 0, 0, 0) in x
  int iy[PIX_PER_THREAD], ix[PIX_PER_THREAD];
  bool pv[PIX_PER_THREAD];
#pragma unroll
  for (int i = 0; i < PIX_PER_THREAD; ++i) {
    const int q = pix0 + (tid + i * THREADS) / FK;
    pv[i] = q < npix;
    const int qq = pv[i] ? q : 0;
    const int ox = qq % p.ow;
    const int oy = (qq / p.ow) % p.oh;
    const int bb = qq / (p.ow * p.oh);
    iy[i] = oy * p.stride;
    ix[i] = ox * p.stride;
    xoff[i] = bb * p.h * p.w * p.c;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int j0 = 0; j0 < p.c_sp; j0 += FK) {
    // 1. spatial values of this chunk, after affine and activation.
    const int j = j0 + jl;
    const bool vj = j < p.c_sp;
    const bool row = j < p.c_r;
    const int wcol = row ? j : j - p.c_r;
    const int src = row ? j : wcol + p.col_src0;
    const float* wb = row ? p.wr : p.wc;
    const int wstride = row ? p.c_r : p.c_c;
    const float g = vj ? p.scale[j] : 0.0f;
    const float bi = vj ? p.bias[j] : 0.0f;
#pragma unroll
    for (int i = 0; i < PIX_PER_THREAD; ++i) {
      float v = 0.0f;
      if (vj && pv[i]) {
        float a = 0.0f;
        if (row) {   // Kx1 along H, at column ox*s
          const int y0 = iy[i] - p.lo_h;
          for (int tap = 0; tap < p.k; ++tap) {
            const int yy = y0 + tap;
            if (yy >= 0 && yy < p.h)
              a = fmaf(p.x[xoff[i] + (yy * p.w + ix[i]) * p.c + src],
                       wb[tap * wstride + wcol], a);
          }
        } else {     // 1xK along W, at row oy*s
          const int x0 = ix[i] - p.lo_w;
          for (int tap = 0; tap < p.k; ++tap) {
            const int xx = x0 + tap;
            if (xx >= 0 && xx < p.w)
              a = fmaf(p.x[xoff[i] + (iy[i] * p.w + xx) * p.c + src],
                       wb[tap * wstride + wcol], a);
          }
        }
        v = apply_act(a * g + bi, p.act);
      }
      s_sp[jl][(tid + i * THREADS) / FK] = v;
    }
    // 2. the matching slice of the pointwise weights.
#pragma unroll
    for (int i = 0; i < FK * FN / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int jj = j0 + idx / FN;
      const int nn = n0 + idx % FN;
      s_w[idx / FN][idx % FN] =
          (jj < p.c_sp && nn < p.cout) ? p.wp[jj * p.cout + nn] : 0.0f;
    }
    __syncthreads();
    // 3. accumulate chunk @ w_pw[chunk, block] in registers.
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = s_sp[kk][ty + 16 * i];
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) bv[jn] = s_w[kk][tx + 16 * jn];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) acc[i][jn] = fmaf(av[i], bv[jn], acc[i][jn]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = pix0 + ty + 16 * i;
    if (q >= npix) continue;
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int nn = n0 + tx + 16 * jn;
      if (nn < p.cout) p.y[q * p.cout + nn] = acc[i][jn];
    }
  }
}

// ---------------------------------------------------------------------------
// depthwise_kxk
// ---------------------------------------------------------------------------

template <int KS>
__global__ void __launch_bounds__(THREADS)
depthwise_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ y, int b, int h, int wd, int c,
                 int k_rt, int stride, int pad_h, int pad_w, int oh, int ow) {
  const int k = KS > 0 ? KS : k_rt;
  // int indices: the wrapper keeps every tensor below 2^30 elements
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= b * oh * ow * c) return;
  const int ch = i % c;
  int r = i / c;
  const int ox = r % ow;
  r /= ow;
  const int oy = r % oh;
  const int bb = r / oh;
  const int y0 = oy * stride - pad_h;
  const int x0 = ox * stride - pad_w;
  const float* xb = x + bb * h * wd * c + ch;
  float acc = 0.0f;
#pragma unroll
  for (int ty = 0; ty < k; ++ty) {
    const int yy = y0 + ty;
    if (yy < 0 || yy >= h) continue;
#pragma unroll
    for (int tx = 0; tx < k; ++tx) {
      const int xx = x0 + tx;
      if (xx < 0 || xx >= wd) continue;
      acc = fmaf(xb[(yy * wd + xx) * c],
                 w[(ty * k + tx) * c + ch], acc);
    }
  }
  y[i] = acc;
}

}  // namespace

extern "C" int repro_fuseconv_fused_f32(
    const float* x, const float* wr, const float* wc, const float* scale,
    const float* bias, const float* wp, float* y,
    int b, int h, int w, int c, int k, int stride, int lo_h, int lo_w,
    int oh, int ow, int c_r, int c_c, int col_src0, int c_sp, int cout,
    int act, void* stream) {
  const FusedArgs args{x, wr, wc, scale, bias, wp, y, b, h, w, c, k, stride,
                       lo_h, lo_w, oh, ow, c_r, c_c, col_src0, c_sp, cout,
                       act};
  const long long npix = static_cast<long long>(b) * oh * ow;
  const dim3 grid(static_cast<unsigned>((npix + FP - 1) / FP),
                  static_cast<unsigned>((cout + FN - 1) / FN));
  fuseconv_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_depthwise_kxk_f32(
    const float* x, const float* w, float* y, int b, int h, int wd, int c,
    int k, int stride, int pad_h, int pad_w, int oh, int ow, void* stream) {
  const long long total = static_cast<long long>(b) * oh * ow * c;
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 3: depthwise_kernel<3><<<blocks, THREADS, 0, s>>>(x, w, y, b, h, wd, c, k, stride, pad_h, pad_w, oh, ow); break;
    case 5: depthwise_kernel<5><<<blocks, THREADS, 0, s>>>(x, w, y, b, h, wd, c, k, stride, pad_h, pad_w, oh, ow); break;
    case 7: depthwise_kernel<7><<<blocks, THREADS, 0, s>>>(x, w, y, b, h, wd, c, k, stride, pad_h, pad_w, oh, ow); break;
    default: depthwise_kernel<0><<<blocks, THREADS, 0, s>>>(x, w, y, b, h, wd, c, k, stride, pad_h, pad_w, oh, ow); break;
  }
  return static_cast<int>(cudaGetLastError());
}
