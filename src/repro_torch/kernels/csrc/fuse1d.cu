// FuSeConv's primitive: a bank of independent 1-D convolutions,
//   y[n, t, c] = sum_k x_pad[n, t + k, c] * w[k, c].
//
// Replaces: src/repro/kernels/fuse1d.py::fuse1d (body _fuse1d_kernel, the
// pl.pallas_call at fuse1d.py:65), which DMAs a (T+K-1, 128-channel) slab
// into VMEM and applies the K taps as shifted broadcast-FMAs.
//
// What bounds it on the H100: device memory.  Each output costs K FMAs
// (K = 3 or 5 on MobileNetV3-Large) against one input read and one output
// write of 4 bytes each, about 1 flop per byte, far below the card's
// 20 flops per byte at fp32.  The least time is (inputs + outputs) bytes
// over 3.35 TB/s.
//
// Design: one thread per output element, channel fastest, so a warp reads
// 32 neighbouring channels of one time step (coalesced in the NHWC-derived
// (N, T, C) layout) and the K-1 re-reads of a time step hit L1/L2, not
// device memory.  The taps are unrolled for K = 3, 5 and 7 (a compile-time
// K) and looped otherwise.  The caller pads T (the reference's contract); there is no
// channel padding or blocking to undo.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <int KS>
__global__ void __launch_bounds__(THREADS)
fuse1d_kernel(const float* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ y, int n, int t, int c, int k_rt) {
  const int k = KS > 0 ? KS : k_rt;
  // int indices: the wrapper keeps every tensor below 2^30 elements
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n * t * c) return;
  const int ch = i % c;
  const int r = i / c;
  const int tt = r % t;
  const int nn = r / t;
  const float* xp = x + (nn * (t + k - 1) + tt) * c + ch;
  float acc = 0.0f;
#pragma unroll
  for (int tap = 0; tap < k; ++tap)
    acc = fmaf(xp[tap * c], w[tap * c + ch], acc);
  y[i] = acc;
}

}  // namespace

// x: (n, t + k - 1, c), w: (k, c), y: (n, t, c); row-major fp32.
extern "C" int repro_fuse1d_f32(const float* x, const float* w, float* y,
                                int n, int t, int c, int k, void* stream) {
  const long long total = static_cast<long long>(n) * t * c;
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 3: fuse1d_kernel<3><<<blocks, THREADS, 0, s>>>(x, w, y, n, t, c, k); break;
    case 5: fuse1d_kernel<5><<<blocks, THREADS, 0, s>>>(x, w, y, n, t, c, k); break;
    case 7: fuse1d_kernel<7><<<blocks, THREADS, 0, s>>>(x, w, y, n, t, c, k); break;
    default: fuse1d_kernel<0><<<blocks, THREADS, 0, s>>>(x, w, y, n, t, c, k); break;
  }
  return static_cast<int>(cudaGetLastError());
}
