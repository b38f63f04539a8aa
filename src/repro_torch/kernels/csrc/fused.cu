// The two kernels of src/repro/kernels/fused.py, redesigned for the H100.
//
// fuseconv_fused — a whole FuSeConv block in one launch: the Kx1 row bank
//   and the 1xK column bank (XLA-SAME padding, stride 1 or 2), the concat,
//   the folded inference-BatchNorm affine, the activation, and the 1x1 mix
//   with w_pw.  Replaces fused.py::fuseconv_fused (body
//   _fuseconv_fused_kernel at fused.py:119, pl.pallas_call at fused.py:212).
//
//   What bounds it on the H100: each output pixel needs K * c_sp bank FMAs
//   and c_sp * Cout mix FMAs against the input elements the banks touch (at
//   stride 2 only half of x) and Cout outputs.  At MobileNetV3-Large's
//   bucket-8 shapes the wide early stages (c_sp 16..72, 56..112 px) are
//   bound by device memory, the 14x14 stages (c_sp 184..240 into Cout 80)
//   by fp32 operations, and there both bounds are under 1 us, so latency
//   and parallelism decide the time.  What it must avoid is the
//   decomposed path's round trip of the c_sp-channel spatial tensor through
//   device memory; what held the first version back was latency, not
//   arithmetic: scalar gathers, nothing in flight during the mix, and 64
//   output lanes per block whatever Cout was.
//
//   Design.  A block owns a TH x TW output tile of one image (TW a power of
//   two) and NT output channels (NT fitted to Cout by the wrapper: 16, 24
//   and 80 on the path, so no mix lane idles; Cout above 128 is split over
//   blockIdx.y, each block recomputing the cheap banks for its slice rather
//   than reducing across blocks).  It walks the c_sp spatial channels in
//   chunks of FK = 16 or 32 (a template parameter; 32 where c_sp >= 128, so
//   a copy moves 128 bytes of a pixel).  Per chunk, the input it needs is
//   staged in shared memory by cp.async: for a row-bank channel the
//   column-subsampled halo box (rows (TH-1)*s+K, columns ox*s), for a
//   column-bank channel the row-subsampled box (rows oy*s, columns
//   (TW-1)*s+K); only the elements that chip_smoke.py::fuse_input_elems
//   counts, with the SAME halo zero-filled by a source size of 0.  The
//   chunk's taps, scale/bias and the FK x NT slice of w_pw ride in the same
//   stage.  The block's threads form KSPLIT groups (1..3): group g walks
//   chunks g, g + KSPLIT, ... through its own ring of 2..3 stages, with
//   named barriers, and at the end the groups' sums are added in a fixed
//   order through shared memory -- a reduction inside one block, so the
//   result is still deterministic.  The split is what fills the card at the
//   14x14 stages: there a grid of 112 blocks of 5 warps, each walking 184-
//   240 channels alone, left most of an SM's issue slots empty.  Each
//   thread computes the banks for 4 channels of one pixel at a time
//   (16-byte shared loads), writes them to a pixel-major tile S, and after
//   one barrier accumulates a 4-pixel x 4-channel tile of the mix in
//   registers; outputs leave as 16-byte stores where Cout % 4 == 0.
//
//   cp.async, not TMA: the boxes are small (a few KB per chunk), a row-bank
//   and a column-bank channel of one chunk need boxes of different shapes
//   and strides, and the ragged instantiation needs 4-byte copies; cp.async
//   covers all of them with one code path and needs no tensor map per shape
//   (nor the driver API at build time).
//
//   No tensor cores in this version: the mix is fp32 FMAs.  TF32 would move
//   the served logits far outside their 1e-5 limit, and the shapes are bound
//   by bytes, not operations.  K is a template parameter (3, 5, 7; 0 is a
//   runtime-K instantiation for any other K), so the taps unroll; no
//   per-thread array is indexed dynamically.  C, c_r, c_c and Cout that are
//   not multiples of 4 (or pointers that are not 16-byte aligned) take the
//   VEC = 1 instantiation of the same kernel: 4-byte copies and stores.
//
// depthwise_kxk — KxK depthwise convolution, XLA-SAME, stride 1 or 2.
//   Replaces fused.py::depthwise_kxk (body _depthwise_kxk_kernel at
//   fused.py:241, pl.pallas_call at fused.py:285).
//
//   What bounds it on the H100: device memory; K*K FMAs per output against
//   one read of the input and one write of the output (2..11 flops per
//   byte at stride 1..2, K = 3..5).
//
//   Design.  A work item is a TH x TW output tile of one image and a slice
//   of CC channels.  Its input halo box ((TH-1)*s+K) x ((TW-1)*s+K) x CC and
//   its K*K*CC weights are staged in shared memory by cp.async (16-byte
//   copies of 4 channels; the SAME halo is zero-filled by a source size of
//   0), so each input element crosses from device memory once per tile.
//   The grid is persistent: gridDim.x is what fits on the card at once, and
//   each block walks items blockIdx.x, +gridDim.x, ... through a ring of
//   2..4 stages (fitted by the wrapper), the next items' copies in flight
//   while the current one is computed.  A thread owns one 4-channel vector
//   and a strip of DW_SW = 4 outputs along W: per kernel row it loads the
//   (DW_SW-1)*s+K input columns and K weight vectors into registers once
//   and reuses them across the taps and the strip.  K and the stride are
//   template parameters (K 3, 5, 7 and stride 1, 2; 0/0 is a runtime
//   instantiation for any other K and stride), so every register array has
//   a static size.  Index arithmetic is a few divisions per item and per
//   thread; per element it is shifts, masks and adds.  C % 4 != 0 (or an
//   unaligned pointer) takes the VEC = 1 instantiation: 4-byte copies, one
//   channel per thread.
//
// Both kernels: fp32 throughout, no atomics, no reduction across blocks —
// the same input gives bitwise the same output on every run.  Indices are
// 32-bit: the wrappers keep every tensor below 2^30 elements.  The
// wrappers' tile pickers (kernels/fused.py) hold each launch's dynamic
// shared memory under the device's opt-in limit, stepping down the ring,
// then the split or channel slice, then the tile; a K so large that no
// tiling fits (above 58 for depthwise_kxk and 86 for fuseconv_fused at
// the H100's 227 KB, against the K <= 7 of the networks) is refused there.
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

// Activation codes shared with kernels/fused.py::_ACT_CODES.
__device__ __forceinline__ float apply_act(float v, int act) {
  switch (act) {
    case 1: return fmaxf(v, 0.0f);                                  // relu
    case 2: return fminf(fmaxf(v, 0.0f), 6.0f);                     // relu6
    case 3: return v * fminf(fmaxf(v + 3.0f, 0.0f), 6.0f) / 6.0f;   // hswish
    default: return v;                                              // linear
  }
}

// cp.async of VEC floats; a source size of 0 writes zeros (the SAME halo,
// ragged channels) and reads nothing.
template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 * VEC : 0;
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Wait until at most n (0..6) groups are pending; n is uniform.
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

template <int VEC>
__device__ __forceinline__ void lds(float (&r)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
  } else {
    r[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void stg(float* p, const float (&r)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    *p = r[0];
  }
}

__device__ __forceinline__ bool inside(int i, int n) {
  return static_cast<unsigned>(i) < static_cast<unsigned>(n);
}

// Blocks of ``kernel`` that fit on one SM of the current device at this
// block size and dynamic shared memory (0 if none does), and the device's
// SM count.  The first call for a (kernel, device, threads, smem) opts the
// kernel into the device's full shared memory (above the default 48 KB)
// and asks the occupancy calculator; the answer is kept, so later launches
// of the same shape make no runtime query but cudaGetDevice.  ctypes
// releases the GIL, so the table is guarded.
struct Fit {
  int per_sm, sms;
};

template <typename Kernel>
Fit fit_on_device(Kernel kernel, int threads, size_t smem) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, size_t>, Fit> seen;
  int dev = 0;
  cudaGetDevice(&dev);
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel),
                                   dev, threads, smem);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = seen.find(key);
  if (it != seen.end()) return it->second;
  Fit f{0, 0};
  int optin = 0;
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&f.sms, cudaDevAttrMultiProcessorCount, dev);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f.per_sm, kernel,
                                                    threads, smem) !=
          cudaSuccess)
    f.per_sm = 0;
  cudaGetLastError();   // a refused shape reports through per_sm, not here
  seen.emplace(key, f);
  return f;
}

// ---------------------------------------------------------------------------
// fuseconv_fused
// ---------------------------------------------------------------------------

constexpr int FTP = 4;           // output pixels per thread in the mix
constexpr int F_MAX_STAGES = 8;  // chunks in the ring, at most
constexpr int F_THREADS = 512;

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
  int th, tw, lg_tw;   // output tile; tw == 1 << lg_tw
  int nt, nx, px;      // output channels per block; nx = nt / 4 threads
                       // across them and px along the pixels, per split
  int rh, cw;          // row box (th-1)*s+k x tw, column box th x (tw-1)*s+k
  int region;          // floats per channel group in a stage
  int sp_stride;       // floats per channel row of S
  int tiles_x, tiles_y;
  int stages;          // chunks in a ring (2..F_MAX_STAGES)
  int stage_floats;    // groups, taps, scale, bias, w_pw slice
  int ksplit;          // groups of threads splitting the chunks
  int ring_floats;     // one group's ring (the stages it uses)
  int split_floats;    // one group's ring and S
};

// Stage one chunk (spatial channels [j0, j0 + FK)) for the block's tile.
template <int FK, int VEC>
__device__ __forceinline__ void fu_issue(const FusedArgs& p, int j0,
                                         float* st, int bb, int ty0, int tx0,
                                         int n0, int s, int k, int tid,
                                         int nthr) {
  constexpr int NG = FK / VEC;   // channel groups of a chunk
  const int g = tid % NG;        // nthr % NG == 0: fixed per thread
  const int j = j0 + g * VEC;
  if (j < p.c_sp) {
    const bool row = j < p.c_r;
    const int src = row ? j : j - p.c_r + p.col_src0;
    const float* xb = p.x + bb * p.h * p.w * p.c + src;
    const int bw = row ? p.tw : p.cw;
    const int npix = row ? p.rh * p.tw : p.th * p.cw;
    const int y0 = row ? ty0 * s - p.lo_h : ty0 * s;
    const int x0 = row ? tx0 * s : tx0 * s - p.lo_w;
    const int sy = row ? 1 : s, sx = row ? s : 1;
    const int step = nthr / NG;
    const int step_r = step / bw, step_c = step - step_r * bw;
    int pix = tid / NG;
    int r = pix / bw, q = pix - r * bw;
    float* reg = st + g * p.region;
    for (; pix < npix; pix += step) {
      const int iy = y0 + r * sy, ix = x0 + q * sx;
      const bool ok = inside(iy, p.h) && inside(ix, p.w);
      cp_async<VEC>(reg + pix * VEC, ok ? xb + (iy * p.w + ix) * p.c : p.x,
                    ok);
      r += step_r;
      q += step_c;
      if (q >= bw) { q -= bw; ++r; }
    }
  }
  // taps (k rows), scale and bias: (k + 2) rows of FK floats
  float* taps = st + NG * p.region;
  for (int e = tid; e < (k + 2) * NG; e += nthr) {
    const int t = e / NG, gg = e - t * NG;
    const int jj = j0 + gg * VEC;
    const bool ok = jj < p.c_sp;
    const float* from;
    if (t < k) {
      from = jj < p.c_r ? p.wr + t * p.c_r + jj
                        : p.wc + t * p.c_c + (jj - p.c_r);
    } else {
      from = (t == k ? p.scale : p.bias) + jj;
    }
    cp_async<VEC>(taps + t * FK + gg * VEC, ok ? from : p.x, ok);
  }
  // w_pw rows [j0, j0 + FK), columns [n0, n0 + nt)
  float* wps = taps + (k + 2) * FK;
  const int nv = p.nt / VEC;
  for (int e = tid; e < FK * nv; e += nthr) {
    const int rr = e / nv, cc = e - rr * nv;
    const int jj = j0 + rr, nn = n0 + cc * VEC;
    const bool ok = jj < p.c_sp && nn < p.cout;
    cp_async<VEC>(wps + rr * p.nt + cc * VEC,
                  ok ? p.wp + jj * p.cout + nn : p.x, ok);
  }
}

// Banks, affine and activation of one staged chunk into S[FK][sp_stride].
template <int FK, int KS, int VEC>
__device__ __forceinline__ void fu_banks(const FusedArgs& p, int j0,
                                         const float* st, float* S, int s,
                                         int k, int tid, int nthr) {
  constexpr int NG = FK / VEC;
  const int kk = KS ? KS : k;
  const int npix = p.th * p.tw;
  const float* taps = st + NG * p.region;
  const float* sc = taps + k * FK;
  const float* bi = sc + FK;
  for (int q = tid; q < NG * npix; q += nthr) {
    const int g = q % NG, pp = q / NG;
    const int py = pp >> p.lg_tw, px = pp & (p.tw - 1);
    const int j = j0 + g * VEC;
    float v[VEC];
    if (j < p.c_sp) {
      const bool row = j < p.c_r;
      const float* reg = st + g * p.region;
      const int base = row ? py * s * p.tw + px : py * p.cw + px * s;
      const int tstep = row ? p.tw : 1;
      float a[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) a[e] = 0.0f;
#pragma unroll
      for (int t = 0; t < kk; ++t) {
        float xv[VEC], wv[VEC];
        lds<VEC>(xv, reg + (base + t * tstep) * VEC);
        lds<VEC>(wv, taps + t * FK + g * VEC);
#pragma unroll
        for (int e = 0; e < VEC; ++e) a[e] = fmaf(xv[e], wv[e], a[e]);
      }
      float gv[VEC], bv[VEC];
      lds<VEC>(gv, sc + g * VEC);
      lds<VEC>(bv, bi + g * VEC);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        v[e] = apply_act(a[e] * gv[e] + bv[e], p.act);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) S[(g * VEC + e) * p.sp_stride + pp] = v[e];
  }
}

// Barrier over the threads of one k-split (ids 1..; 0 is __syncthreads).
__device__ __forceinline__ void split_sync(int split, int nthr) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(split + 1), "r"(nthr) : "memory");
}

template <int FK, int KS, int VEC>
__global__ void __launch_bounds__(F_THREADS, 1)
fuseconv_kernel(FusedArgs p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NG = FK / VEC;
  const int k = KS ? KS : p.k;
  const int s = p.stride;
  // The block is p.ksplit groups of nthr threads; group `split` walks the
  // chunks split, split + ksplit, ... through its own ring and S.
  const int nthr = p.nx * p.px;
  const int split = threadIdx.x / nthr, tid = threadIdx.x - split * nthr;
  float* ring = smem + split * p.split_floats;
  float* S = ring + p.ring_floats;
  int t = blockIdx.x;
  const int tx = t % p.tiles_x;
  t /= p.tiles_x;
  const int ty = t % p.tiles_y;
  const int bb = t / p.tiles_y;
  const int ty0 = ty * p.th, tx0 = tx * p.tw, n0 = blockIdx.y * p.nt;
  const int nx = tid % p.nx, px = tid / p.nx;
  const int nchunks = (p.c_sp + FK - 1) / FK;
  const int mine = split < nchunks ? (nchunks - split + p.ksplit - 1) /
                                         p.ksplit : 0;
  const int wps_off = NG * p.region + (k + 2) * FK;

  float acc[FTP][4];
#pragma unroll
  for (int i = 0; i < FTP; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[i][n] = 0.0f;

  for (int c = 0; c < p.stages - 1; ++c) {
    if (c < mine)
      fu_issue<FK, VEC>(p, (split + c * p.ksplit) * FK,
                        ring + c * p.stage_floats, bb, ty0, tx0, n0, s, k,
                        tid, nthr);
    cp_async_commit();
  }
  for (int c = 0; c < mine; ++c) {
    cp_async_wait_n(p.stages - 2);
    split_sync(split, nthr);   // chunk c landed; chunk c-1's stage, S free
    const int nc = c + p.stages - 1;
    if (nc < mine)
      fu_issue<FK, VEC>(p, (split + nc * p.ksplit) * FK,
                    ring + (nc % p.stages) * p.stage_floats, bb, ty0, tx0,
                    n0, s, k, tid, nthr);
    cp_async_commit();
    const float* st = ring + (c % p.stages) * p.stage_floats;
    fu_banks<FK, KS, VEC>(p, (split + c * p.ksplit) * FK, st, S, s, k, tid,
                      nthr);
    split_sync(split, nthr);
    const float* wps = st + wps_off;
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float av[FTP], wv[4];
      lds<4>(av, S + kk * p.sp_stride + px * FTP);
      lds<4>(wv, wps + kk * p.nt + nx * 4);
#pragma unroll
      for (int i = 0; i < FTP; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[i][n] = fmaf(av[i], wv[n], acc[i][n]);
    }
  }

  if (p.ksplit > 1) {
    // Splits 1.. hand their sums to split 0, which adds them in order.
    cp_async_wait<0>();
    __syncthreads();   // every ring is free
    float* part = smem + ((split - 1) * nthr + tid) * FTP * 4;
    if (split > 0) {
#pragma unroll
      for (int i = 0; i < FTP; ++i) stg<4>(part + i * 4, acc[i]);
    }
    __syncthreads();
    if (split > 0) return;
    for (int g = 1; g < p.ksplit; ++g) {
      const float* q = smem + ((g - 1) * nthr + tid) * FTP * 4;
#pragma unroll
      for (int i = 0; i < FTP; ++i) {
        float v[4];
        lds<4>(v, q + i * 4);
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[i][n] += v[n];
      }
    }
  }

  const int npix = p.th * p.tw;
  const int n = n0 + nx * 4;
#pragma unroll
  for (int i = 0; i < FTP; ++i) {
    const int pp = px * FTP + i;
    if (pp >= npix) continue;
    const int oy = ty0 + (pp >> p.lg_tw), ox = tx0 + (pp & (p.tw - 1));
    if (oy >= p.oh || ox >= p.ow) continue;
    float* yp = p.y + ((bb * p.oh + oy) * p.ow + ox) * p.cout + n;
    if constexpr (VEC == 4) {
      if (n < p.cout) stg<4>(yp, acc[i]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n + e < p.cout) yp[e] = acc[i][e];
    }
  }
}

template <int FK, int KS, int VEC>
int launch_fused(const FusedArgs& a, int threads, size_t smem,
                 cudaStream_t stream) {
  auto kernel = fuseconv_kernel<FK, KS, VEC>;
  if (fit_on_device(kernel, threads, smem).per_sm < 1)
    return cudaErrorInvalidValue;
  const dim3 grid(a.tiles_x * a.tiles_y * a.b, (a.cout + a.nt - 1) / a.nt);
  kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// depthwise_kxk
// ---------------------------------------------------------------------------

constexpr int DW_SW = 4;          // outputs per thread along W
constexpr int DW_MAX_STAGES = 4;  // items in the ring, at most
constexpr int DW_THREADS = 256;

struct DwArgs {
  const float* x;      // (b, h, wd, c)
  const float* w;      // (k, k, c)
  float* y;            // (b, oh, ow, c)
  int b, h, wd, c, k, stride, pad_h, pad_w, oh, ow;
  int th, tw, cc;      // output tile (tw a multiple of DW_SW), channel slice
  int lg_cv, lg_nsx;   // log2(cc / VEC), log2(tw / DW_SW)
  int ih, iw;          // halo box (th-1)*s+k x (tw-1)*s+k
  int tiles_x, tiles_y, slices, items;
  int stages;          // items in the ring (2..DW_MAX_STAGES)
  int box_floats, stage_floats;
};

struct DwItem {
  int bb, ty0, tx0, c0;   // image, output tile origin, first channel
};

__device__ __forceinline__ DwItem dw_item(const DwArgs& p, int item) {
  DwItem it;
  const int slice = item % p.slices;
  item /= p.slices;
  const int tx = item % p.tiles_x;
  item /= p.tiles_x;
  const int ty = item % p.tiles_y;
  it.bb = item / p.tiles_y;
  it.ty0 = ty * p.th;
  it.tx0 = tx * p.tw;
  it.c0 = slice * p.cc;
  return it;
}

// Stage one item's halo box and weights.
template <int VEC>
__device__ __forceinline__ void dw_issue(const DwArgs& p, int item, float* st,
                                         int s, int k) {
  const DwItem it = dw_item(p, item);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int cv = 1 << p.lg_cv;
  const int v = tid & (cv - 1);   // blockDim.x % cv == 0: fixed per thread
  const int ch = it.c0 + v * VEC;
  const bool cok = ch < p.c;
  const float* xb = p.x + it.bb * p.h * p.wd * p.c + ch;
  const int y0 = it.ty0 * s - p.pad_h, x0 = it.tx0 * s - p.pad_w;
  const int step = nthr >> p.lg_cv;
  const int step_r = step / p.iw, step_c = step - step_r * p.iw;
  const int npix = p.ih * p.iw;
  int pix = tid >> p.lg_cv;
  int r = pix / p.iw, q = pix - r * p.iw;
  for (; pix < npix; pix += step) {
    const int iy = y0 + r, ix = x0 + q;
    const bool ok = cok && inside(iy, p.h) && inside(ix, p.wd);
    cp_async<VEC>(st + pix * p.cc + v * VEC,
                  ok ? xb + (iy * p.wd + ix) * p.c : p.x, ok);
    r += step_r;
    q += step_c;
    if (q >= p.iw) { q -= p.iw; ++r; }
  }
  float* ws = st + p.box_floats;
  for (int e = tid; e < k * k * cv; e += nthr) {
    const int tap = e >> p.lg_cv, vv = e & (cv - 1);
    const int c2 = it.c0 + vv * VEC;
    const bool ok = c2 < p.c;
    cp_async<VEC>(ws + tap * p.cc + vv * VEC,
                  ok ? p.w + tap * p.c + c2 : p.w, ok);
  }
}

template <int KS, int SS, int VEC>
__device__ __forceinline__ void dw_compute(const DwArgs& p, int item,
                                           const float* st, int s, int k) {
  const DwItem it = dw_item(p, item);
  const int cv = 1 << p.lg_cv;
  const int work = (p.th << p.lg_nsx) << p.lg_cv;
  for (int q = threadIdx.x; q < work; q += blockDim.x) {
    const int v = q & (cv - 1);
    const int strip = q >> p.lg_cv;
    const int sy = strip >> p.lg_nsx;
    const int sx = (strip & ((1 << p.lg_nsx) - 1)) * DW_SW;
    const int oy = it.ty0 + sy, ox = it.tx0 + sx;
    const int ch = it.c0 + v * VEC;
    if (oy >= p.oh || ox >= p.ow || ch >= p.c) continue;
    float acc[DW_SW][VEC];
#pragma unroll
    for (int j = 0; j < DW_SW; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[j][e] = 0.0f;
    const float* bx = st + (sy * s * p.iw + sx * s) * p.cc + v * VEC;
    const float* wt = st + p.box_floats + v * VEC;
    if constexpr (KS > 0 && SS > 0) {
      constexpr int NIN = (DW_SW - 1) * SS + KS;
#pragma unroll
      for (int ky = 0; ky < KS; ++ky) {
        float in[NIN][VEC], wv[KS][VEC];
#pragma unroll
        for (int t = 0; t < NIN; ++t)
          lds<VEC>(in[t], bx + (ky * p.iw + t) * p.cc);
#pragma unroll
        for (int kx = 0; kx < KS; ++kx)
          lds<VEC>(wv[kx], wt + (ky * KS + kx) * p.cc);
#pragma unroll
        for (int j = 0; j < DW_SW; ++j)
#pragma unroll
          for (int kx = 0; kx < KS; ++kx)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[j][e] = fmaf(in[j * SS + kx][e], wv[kx][e], acc[j][e]);
      }
    } else {
      for (int ky = 0; ky < k; ++ky)
        for (int kx = 0; kx < k; ++kx) {
          float wv[VEC];
          lds<VEC>(wv, wt + (ky * k + kx) * p.cc);
#pragma unroll
          for (int j = 0; j < DW_SW; ++j) {
            float in[VEC];
            lds<VEC>(in, bx + (ky * p.iw + j * s + kx) * p.cc);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[j][e] = fmaf(in[e], wv[e], acc[j][e]);
          }
        }
    }
    float* yp = p.y + ((it.bb * p.oh + oy) * p.ow + ox) * p.c + ch;
#pragma unroll
    for (int j = 0; j < DW_SW; ++j)
      if (ox + j < p.ow) stg<VEC>(yp + j * p.c, acc[j]);
  }
}

template <int KS, int SS, int VEC>
__global__ void __launch_bounds__(DW_THREADS) depthwise_kernel(DwArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int k = KS ? KS : p.k;
  const int s = SS ? SS : p.stride;
  for (int i = 0; i < p.stages - 1; ++i) {
    const int item = blockIdx.x + i * gridDim.x;
    if (item < p.items)
      dw_issue<VEC>(p, item, smem + i * p.stage_floats, s, k);
    cp_async_commit();
  }
  int i = 0;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++i) {
    cp_async_wait_n(p.stages - 2);
    __syncthreads();   // item i has landed; item i-1's stage is free
    const int ahead = i + p.stages - 1;
    const int next = item + (p.stages - 1) * gridDim.x;
    if (next < p.items)
      dw_issue<VEC>(p, next, smem + (ahead % p.stages) * p.stage_floats, s, k);
    cp_async_commit();
    dw_compute<KS, SS, VEC>(p, item, smem + (i % p.stages) * p.stage_floats,
                            s, k);
  }
}

template <int KS, int SS, int VEC>
int launch_depthwise(const DwArgs& a, int threads, size_t smem,
                     cudaStream_t stream) {
  auto kernel = depthwise_kernel<KS, SS, VEC>;
  const Fit f = fit_on_device(kernel, threads, smem);
  if (f.per_sm < 1) return cudaErrorInvalidValue;
  const long long fit = static_cast<long long>(f.per_sm) * f.sms;
  const int grid = static_cast<int>(a.items < fit ? a.items : fit);
  kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC>
int depthwise_dispatch(const DwArgs& a, int threads, size_t smem,
                       cudaStream_t st) {
  const int key = a.k * 10 + a.stride;
  switch (key) {
    case 31: return launch_depthwise<3, 1, VEC>(a, threads, smem, st);
    case 32: return launch_depthwise<3, 2, VEC>(a, threads, smem, st);
    case 51: return launch_depthwise<5, 1, VEC>(a, threads, smem, st);
    case 52: return launch_depthwise<5, 2, VEC>(a, threads, smem, st);
    case 71: return launch_depthwise<7, 1, VEC>(a, threads, smem, st);
    case 72: return launch_depthwise<7, 2, VEC>(a, threads, smem, st);
    default: return launch_depthwise<0, 0, VEC>(a, threads, smem, st);
  }
}

template <int FK, int VEC>
int fused_dispatch(const FusedArgs& a, int threads, size_t smem,
                   cudaStream_t st) {
  switch (a.k) {
    case 3: return launch_fused<FK, 3, VEC>(a, threads, smem, st);
    case 5: return launch_fused<FK, 5, VEC>(a, threads, smem, st);
    case 7: return launch_fused<FK, 7, VEC>(a, threads, smem, st);
    default: return launch_fused<FK, 0, VEC>(a, threads, smem, st);
  }
}

int ilog2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

}  // namespace

// Tiling (th, tw, nt, px, stages, ksplit, fk) comes from kernels/fused.py::
// fused_tiling: a th x tw output tile (tw a power of two), nt output
// channels (a multiple of 4), px threads along the pixels (nt / 4 * px
// threads per split, a multiple of 32, each with FTP pixels), the depth of
// each chunk ring, the number of splits of the chunk walk and the chunk
// width (16 or 32 channels).  vec is 4 or 1 (the wrapper checks
// divisibility and alignment).
extern "C" int repro_fuseconv_fused_f32(
    const float* x, const float* wr, const float* wc, const float* scale,
    const float* bias, const float* wp, float* y,
    int b, int h, int w, int c, int k, int stride, int lo_h, int lo_w,
    int oh, int ow, int c_r, int c_c, int col_src0, int c_sp, int cout,
    int act, int th, int tw, int nt, int px, int stages, int ksplit, int fk,
    int vec, void* stream) {
  const int lg_tw = ilog2(tw);
  const int nx = nt / 4;
  const int split_threads = nx * px;
  const int threads = split_threads * ksplit;
  const int ng = fk / vec;
  if ((fk != 16 && fk != 32) || lg_tw < 0 || nt % 4 != 0 || ksplit < 1 ||
      ksplit > 15 ||
      threads > F_THREADS || split_threads % 32 != 0 ||
      px * FTP < th * tw || stages < 2 || stages > F_MAX_STAGES ||
      (vec != 1 && vec != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  FusedArgs a{x, wr, wc, scale, bias, wp, y, b, h, w, c, k, stride, lo_h,
              lo_w, oh, ow, c_r, c_c, col_src0, c_sp, cout, act};
  a.th = th; a.tw = tw; a.lg_tw = lg_tw; a.nt = nt; a.nx = nx; a.px = px;
  a.rh = (th - 1) * stride + k;
  a.cw = (tw - 1) * stride + k;
  const int maxpix = a.rh * tw > th * a.cw ? a.rh * tw : th * a.cw;
  // +8 / +2 floats: consecutive channel groups start on other banks
  a.region = round_up(vec * maxpix, 32) + (vec == 4 ? 8 : 2);
  a.sp_stride = round_up(px * FTP, 4) + 4;
  a.tiles_x = (ow + tw - 1) / tw;
  a.tiles_y = (oh + th - 1) / th;
  a.stages = stages;
  a.stage_floats = ng * a.region + (k + 2) * fk + fk * nt;
  a.ksplit = ksplit;
  // a split that walks fewer chunks than the ring holds uses fewer stages
  const int walk = (c_sp + fk * ksplit - 1) / (fk * ksplit);
  a.ring_floats = (walk < stages ? walk : stages) * a.stage_floats;
  a.split_floats = a.ring_floats + fk * a.sp_stride;
  const int parts = (ksplit - 1) * split_threads * FTP * 4;
  const int total = ksplit * a.split_floats;
  const size_t smem = sizeof(float) * (total > parts ? total : parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fk == 32)
    return vec == 4 ? fused_dispatch<32, 4>(a, threads, smem, s)
                    : fused_dispatch<32, 1>(a, threads, smem, s);
  return vec == 4 ? fused_dispatch<16, 4>(a, threads, smem, s)
                  : fused_dispatch<16, 1>(a, threads, smem, s);
}

// Tiling (th, tw, cc, threads, stages) comes from kernels/fused.py::
// depthwise_tiling: a th x tw output tile (tw = DW_SW << n), cc channels
// per item (cc / vec a power of two that divides threads) and the depth of
// the item ring.
extern "C" int repro_depthwise_kxk_f32(
    const float* x, const float* w, float* y, int b, int h, int wd, int c,
    int k, int stride, int pad_h, int pad_w, int oh, int ow,
    int th, int tw, int cc, int threads, int stages, int vec,
    void* stream) {
  const int lg_cv = ilog2(cc / vec);
  const int lg_nsx = ilog2(tw / DW_SW);
  if (lg_cv < 0 || lg_nsx < 0 || tw % DW_SW != 0 || cc % vec != 0 ||
      cc % 4 != 0 || threads > DW_THREADS || threads % (cc / vec) != 0 ||
      stages < 2 || stages > DW_MAX_STAGES || (vec != 1 && vec != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  DwArgs a{x, w, y, b, h, wd, c, k, stride, pad_h, pad_w, oh, ow};
  a.th = th; a.tw = tw; a.cc = cc; a.lg_cv = lg_cv; a.lg_nsx = lg_nsx;
  a.ih = (th - 1) * stride + k;
  a.iw = (tw - 1) * stride + k;
  a.tiles_x = (ow + tw - 1) / tw;
  a.tiles_y = (oh + th - 1) / th;
  a.slices = (c + cc - 1) / cc;
  const long long items =
      static_cast<long long>(b) * a.tiles_y * a.tiles_x * a.slices;
  if (items >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  a.items = static_cast<int>(items);
  a.stages = stages;
  a.box_floats = a.ih * a.iw * cc;
  a.stage_floats = a.box_floats + k * k * cc;
  const size_t smem =
      sizeof(float) * static_cast<size_t>(stages) * a.stage_floats;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec == 4 ? depthwise_dispatch<4>(a, threads, smem, s)
                  : depthwise_dispatch<1>(a, threads, smem, s);
}
