// A FuSe spatial stage in one launch: the Kx1 row bank and the 1xK column
// bank over an NHWC tensor, XLA-SAME padding, stride 1 or 2,
//   y[b, oy, ox, j]      = sum_t x[b, oy*s - lo_h + t, ox*s, j]          * w_row[t, j]
//   y[b, oy, ox, c_r+j'] = sum_t x[b, oy*s, ox*s - lo_w + t, col_src0+j'] * w_col[t, j']
// with out-of-range taps reading zero.  fuse_half puts the row bank on
// channels [0, c_r) and the column bank on [c_r, C) (col_src0 = c_r);
// fuse_full runs both banks on every channel (c_r = c_c = C, col_src0 = 0)
// into 2C output channels, rows first.  One bank alone is c_c = 0 or
// c_r = 0, and the 1-D primitive y[n, t, c] = sum_k x_pad[n, t+k, c] w[k, c]
// is the row bank over (n, T+K-1, 1, C) with no halo and stride 1.
//
// Replaces: src/repro/kernels/fuse1d.py::fuse1d (body _fuse1d_kernel, the
// pl.pallas_call at fuse1d.py:65) together with the layout plumbing that
// src/repro/kernels/ops.py:65-122 wraps around it on the TPU: a transpose
// that folds W into the problem axis for the row bank, F.pad of the SAME
// halo, two 1-D launches at full resolution, a strided subsample and a
// concat.  Those copies and the thrown-away outputs (3.9x the kept ones at
// stride 2) were VMEM schedule, not semantics.  Here the kernel reads x in
// place, computes only the kept (Ho, Wo) outputs and writes y once.
//
// What bounds it on the H100: device memory.  Each output costs K FMAs
// against its share of the input it needs and one 4-byte write, about 1
// flop per byte against the card's 20 at fp32.  The least time is the
// bytes of the input the kept outputs touch (chip_smoke.py::
// fuse_input_elems: at stride 2 the row bank reads every other column, the
// column bank every other row) plus weights and outputs, over 3.35 TB/s.
//
// The design: one thread per VEC-channel vector of one output pixel (16-byte
// loads and stores: VEC = 4 in fp32, 8 in bf16), channels fastest, so a warp reads neighbouring
// 16-byte vectors of one or two pixels.  Each thread issues its K tap loads
// back to back (K is a template parameter, so they unroll and are all in
// flight at once) through the read-only path; the K-fold reuse of an input
// vector along the bank's axis is left to L1 (column bank: neighbouring
// pixels of one block) and L2 (row bank: the rows above and below belong to
// other blocks).  A second design that staged each output tile's input
// boxes in shared memory with cp.async, as csrc/fused.cu::fuseconv_kernel
// does, was 10-17% slower at every main-path stage on the H100 (PERF.md)
// and was dropped.
//
// Every output accumulates its taps in order 0..K-1 with fmaf from
// zero, an out-of-range tap contributing fmaf(0, w, acc), exactly as the
// first port's 1-D kernel did over a zero-padded input; no atomics, no
// reduction across threads, so a repeat call is bitwise equal.  C, c_r,
// c_c or col_src0 not a multiple of VEC (or a pointer not 16-byte aligned)
// takes the VEC = 1 instantiation.  K = 3, 4, 5, 7 have their own
// instantiations (4 is the RG-LRU front-end's width), any other K a
// runtime-K one.  Indices are 32-bit: the wrapper keeps every tensor below
// 2^30 elements.
//
// The temporal form of the LM stack, a causal (or centred) 1-D bank over
// x (B, T, C), is the row bank over (B, T, 1, C) with lo_h = K-1 (or
// (K-1)/2), oh = T and ow = 1: the zero halo is the kernel's, so there is
// no pad copy.  It replaces the path src/repro/kernels/ops.py:39 takes to
// the same Pallas kernel (whose MAX_T_CHUNK chunking bounded VMEM tiles).
//
// Element types: float32 (repro_fuse_stage_f32, VEC 4 or 1) and bfloat16
// (repro_fuse_stage_bf16, VEC 8 or 1: eight values per 16-byte load), as
// the Pallas kernel is dtype-generic.  Both accumulate in fp32 and store
// once in the input's type (bf16: round to nearest even, as torch's
// .to(torch.bfloat16)).  A bf16 x bf16 product is exact in fp32, so the
// bf16 kernel's fmaf chain gives the plain version's mul-then-add result.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;

template <typename T>
struct StageArgs {
  const T* x;        // (b, h, w, c)
  const T* wr;       // (k, c_r)  row-bank taps
  const T* wc;       // (k, c_c)  column-bank taps
  T* y;              // (b, oh, ow, c_sp)
  int b, h, w, c, k, stride, lo_h, lo_w, oh, ow;
  int c_r, c_c, col_src0, c_sp;
};

__device__ __forceinline__ bool inside(int i, int n) {
  return static_cast<unsigned>(i) < static_cast<unsigned>(n);
}

// VEC consecutive elements of type T from p, widened to fp32
template <int VEC, typename T>
__device__ __forceinline__ void ldg(float (&r)[VEC], const T* p) {
  if constexpr (std::is_same_v<T, float>) {
    if constexpr (VEC == 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p));
      r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
    } else {
      r[0] = __ldg(p);
    }
  } else if constexpr (VEC == 8) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // a bf16 is the high half of the fp32 with the same bits
      r[2 * e] = __uint_as_float(u[e] << 16);
      r[2 * e + 1] = __uint_as_float(u[e] & 0xffff0000u);
    }
  } else {
    r[0] = __uint_as_float(
        static_cast<unsigned>(
            __ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
  }
}

// VEC fp32 values to p as type T (bf16: round to nearest even)
template <int VEC, typename T>
__device__ __forceinline__ void stg(T* p, const float (&r)[VEC]) {
  if constexpr (std::is_same_v<T, float>) {
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
    } else {
      *p = r[0];
    }
  } else if constexpr (VEC == 8) {
    uint4 t;
    unsigned* u = reinterpret_cast<unsigned*>(&t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(r[2 * e], r[2 * e + 1]);
      u[e] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = t;
  } else {
    *p = __float2bfloat16_rn(r[0]);
  }
}

template <int KS, int VEC, typename T>
__global__ void __launch_bounds__(THREADS)
stage_direct_kernel(StageArgs<T> p) {
  const int k = KS > 0 ? KS : p.k;
  const int ng = p.c_sp / VEC;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= p.b * p.oh * p.ow * ng) return;
  int r = i / ng;
  const int j = (i - r * ng) * VEC;
  const int ox = r % p.ow;
  r /= p.ow;
  const int oy = r % p.oh;
  const int bb = r / p.oh;
  const int s = p.stride;
  const bool row = j < p.c_r;
  // the first tap's coordinate along the bank's axis, that axis's extent,
  // and the elements from one tap to the next
  const int q0 = row ? oy * s - p.lo_h : ox * s - p.lo_w;
  const int n = row ? p.h : p.w;
  const int step = row ? p.w * p.c : p.c;
  const int iy = row ? q0 : oy * s, ix = row ? ox * s : q0;
  const int off = ((bb * p.h + iy) * p.w + ix) * p.c +
                  (row ? j : j - p.c_r + p.col_src0);
  const T* wp = row ? p.wr + j : p.wc + (j - p.c_r);
  const int wstep = row ? p.c_r : p.c_c;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
#pragma unroll
  for (int t = 0; t < k; ++t) {
    float xv[VEC], wv[VEC];
    ldg<VEC, T>(wv, wp + t * wstep);
    if (inside(q0 + t, n)) {
      ldg<VEC, T>(xv, p.x + off + t * step);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) xv[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = fmaf(xv[e], wv[e], acc[e]);
  }
  stg<VEC, T>(p.y + i * VEC, acc);
}

template <int KS, int VEC, typename T>
void launch(const StageArgs<T>& p, cudaStream_t s) {
  const long long total =
      static_cast<long long>(p.b) * p.oh * p.ow * (p.c_sp / VEC);
  const unsigned blocks =
      static_cast<unsigned>((total + THREADS - 1) / THREADS);
  stage_direct_kernel<KS, VEC, T><<<blocks, THREADS, 0, s>>>(p);
}

template <int VEC, typename T>
void launch_k(const StageArgs<T>& p, cudaStream_t s) {
  switch (p.k) {
    case 3: launch<3, VEC, T>(p, s); break;
    case 4: launch<4, VEC, T>(p, s); break;
    case 5: launch<5, VEC, T>(p, s); break;
    case 7: launch<7, VEC, T>(p, s); break;
    default: launch<0, VEC, T>(p, s); break;
  }
}

// VEC is 16 bytes of T (4 fp32, 8 bf16) or 1
template <typename T>
int stage(const T* x, const T* w_row, const T* w_col, T* y, int b, int h,
          int w, int c, int k, int stride, int lo_h, int lo_w, int oh,
          int ow, int c_r, int c_c, int col_src0, int vec, void* stream) {
  constexpr int WIDE = 16 / sizeof(T);
  const int c_sp = c_r + c_c;
  if ((vec != 1 && vec != WIDE) || c_sp % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  StageArgs<T> p{x, w_row, w_col, y, b, h, w, c, k, stride, lo_h, lo_w,
                 oh, ow, c_r, c_c, col_src0, c_sp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == WIDE) launch_k<WIDE, T>(p, s);
  else launch_k<1, T>(p, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (b, h, w, c), w_row: (k, c_r), w_col: (k, c_c), y: (b, oh, ow, c_sp)
// with c_sp = c_r + c_c; row-major fp32.  vec is 4 or 1.
extern "C" int repro_fuse_stage_f32(
    const float* x, const float* w_row, const float* w_col, float* y, int b,
    int h, int w, int c, int k, int stride, int lo_h, int lo_w, int oh,
    int ow, int c_r, int c_c, int col_src0, int vec, void* stream) {
  return stage<float>(x, w_row, w_col, y, b, h, w, c, k, stride, lo_h, lo_w,
                      oh, ow, c_r, c_c, col_src0, vec, stream);
}

// The same in bfloat16 (fp32 accumulation); vec is 8 or 1.
extern "C" int repro_fuse_stage_bf16(
    const __nv_bfloat16* x, const __nv_bfloat16* w_row,
    const __nv_bfloat16* w_col, __nv_bfloat16* y, int b, int h, int w,
    int c, int k, int stride, int lo_h, int lo_w, int oh, int ow, int c_r,
    int c_c, int col_src0, int vec, void* stream) {
  return stage<__nv_bfloat16>(x, w_row, w_col, y, b, h, w, c, k, stride,
                              lo_h, lo_w, oh, ow, c_r, c_c, col_src0, vec,
                              stream);
}
