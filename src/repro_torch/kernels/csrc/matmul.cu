// Pointwise (1x1) convolution as an fp32 GEMM: c[m, n] = sum_k a[m, k] * b[k, n].
//
// Replaces: src/repro/kernels/matmul.py::matmul (body _matmul_kernel, the
// pl.pallas_call at matmul.py:52), which tiles 128x128x128 blocks onto the
// TPU's matrix unit with an fp32 accumulator held in VMEM scratch.
//
// What bounds it on the H100: on the serving path (MobileNetV3-Large,
// bucket 8) M = b*H*W reaches 100352 while K and N stay between 16 and 960,
// so most calls do 8..480 flops per byte moved: the narrow-K expands are
// bound by device memory (3.35 TB/s), the wide 14x14 and 7x7 layers by
// arithmetic.  This first kernel computes in fp32 with FMAs on the CUDA
// cores (67 TFLOP/s), not TF32 tensor cores, so that it matches the fp32
// reference to 1e-4.
//
// Design: one 256-thread block owns a 64x64 output tile and walks K in
// steps of 16.  Each step stages a 64x16 slice of a (stored transposed,
// padded by one column against bank conflicts) and a 16x64 slice of b in
// shared memory; every thread then accumulates a 4x4 sub-tile in registers
// (rows ty + 16i, columns tx + 16j, so neighbouring threads read
// neighbouring addresses).  Ragged M, N and K edges are masked with zero
// fill on load and bounds checks on store.  wgmma, TMA and a multi-stage
// pipeline are left for the PR that makes it fast.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
sgemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ c, int m, int n, int k) {
  __shared__ float as[BK][BM + 1];
  __shared__ float bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  // int indices: the wrapper keeps every tensor below 2^30 elements
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BK;
      const int kk = idx % BK;
      const int gr = row0 + r;
      const int gk = k0 + kk;
      as[kk][r] = (gr < m && gk < k) ? a[gr * k + gk] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int kk = idx / BN;
      const int cc = idx % BN;
      const int gk = k0 + kk;
      const int gc = col0 + cc;
      bs[kk][cc] = (gk < k && gc < n)
                       ? b[gk * n + gc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = col0 + tx + 16 * j;
      if (cc < n) c[r * n + cc] = acc[i][j];
    }
  }
}

}  // namespace

// a: (m, k), b: (k, n), c: (m, n); all row-major fp32 on the current device.
extern "C" int repro_matmul_f32(const float* a, const float* b, float* c,
                                int m, int n, int k, void* stream) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  sgemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, c, m, n, k);
  return static_cast<int>(cudaGetLastError());
}
