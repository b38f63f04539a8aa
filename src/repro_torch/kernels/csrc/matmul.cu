// Pointwise (1x1) convolution as an fp32 GEMM: c[m, n] = sum_k a[m, k] * b[k, n].
//
// Replaces: src/repro/kernels/matmul.py::matmul (body _matmul_kernel at
// matmul.py:18, the pl.pallas_call at matmul.py:52), which tiles
// 128x128x128 blocks onto the TPU's matrix unit and carries an fp32
// accumulator in VMEM scratch along the sequential K axis of its grid.
//
// What bounds it on the H100.  On the serving path (MobileNetV3-Large,
// buckets 1..8) M = b*H*W runs from 49 to 100352 while K and N stay between
// 16 and 960, in two classes:
//   - narrow K, large M (K <= 120, M >= 6272 at bucket 8): 6..17 flops per
//     byte against the fp32 ridge of 20, so device memory (3.35 TB/s) bounds
//     them; the output (M x N) is most of the bytes.  What lost time in the
//     first kernel (one 64x64 tile for every shape) was lanes idle on a
//     narrow N (16, 24, 40, 72) and nothing in flight while a tile computed.
//   - wide K, small M (the 14x14 and 7x7 stages: M 49..1568, K 160..960):
//     bound by fp32 operations (67 TFLOP/s), but their bounds are
//     0.7..3.5 us, so what loses time is parallelism: a 64x64 tile gives
//     21..50 blocks on 132 SMs, each walking all of K alone.
// The product stays fp32 FMAs on the CUDA cores: TF32 tensor cores would
// move the served logits far outside their 1e-5 limit.
//
// Design.  One kernel, sgemm_kernel<BK, TM, VEC>, with the tiling chosen
// per shape by the wrapper (kernels/matmul.py::matmul_tiling), which was
// tuned by timing the alternatives at every main-path shape on the card:
//   - A block owns a BM x BN output tile, BN fitted to N (16, 24, 40, 64, 72,
//     80, 112, 120, ...: at most an eighth of the columns idle where N is a
//     multiple of 8) and BM to M.  Each of its (BM/TM) x (BN/4) threads keeps
//     a TM x 4 register tile: rows ty + i*BM/TM (so that neighbouring rows of
//     a sit in other banks) and the 4 columns 4*tx.. (one float4), fed by
//     16-byte shared-memory reads.  TM is 4, or 8 where the grid still has
//     two blocks per SM.  Tiles 8 columns wide (4x8, 8x8) were slower at
//     all main-path shapes but one: these products are too small for the
//     larger tiles' fewer warps.  A persistent grid (1..8 blocks per SM
//     walking the tiles) was no faster than one block per tile.
//   - K is walked in steps of BK (16, or 32 where K >= 120) through a ring
//     of up to 8 stages filled by cp.async: 16-byte copies (VEC = 4) of a's
//     rows (row-major, padded to BK + 4 floats) and of b's rows.  The ring
//     holds all of a block's K steps where they fit, so a narrow K is in
//     flight at once and a wide one waits on device memory once per ring,
//     not once per step; several blocks per SM overlap one another's copies
//     and stores.  Ragged M, N and K edges are zero-filled by a source size
//     of 0, so the inner loop has no bounds checks.
//   - Deterministic K split: where the tiles alone leave SMs idle, KS = 2..8
//     blocks form a thread-block cluster, each walking its own contiguous
//     range of K steps.  Each block leaves its partial tile in its shared
//     memory; after a cluster barrier, block r adds the r-th slice of the
//     tile over the cluster's blocks in rank order 0..KS-1 through
//     distributed shared memory and stores it.  The order is fixed, there
//     are no atomics, and one launch does it all, so a repeat on the same
//     input is bitwise equal.
//   - Stores are float4 where N % 4 == 0.  K % 4 != 0, N % 4 != 0 or a
//     pointer that is not 16-byte aligned takes the VEC = 1 instantiation:
//     the same kernel with 4-byte copies and stores.
// Indices are 32-bit: the wrapper keeps every tensor below 2^30 elements.
// The dynamic shared-memory opt-in is set once per (instantiation, device)
// and kept.  Every launch returns cudaGetLastError().
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_STAGES = 8;
constexpr int MAX_SPLIT = 8;     // the portable cluster size

struct MmArgs {
  const float* a;   // (m, k)
  const float* b;   // (k, n)
  float* c;         // (m, n)
  int m, n, k;
  int bm, bn;       // block tile
  int txn, tyn;     // threads across the tile's columns and rows
  int tiles_n;      // column tiles
  int steps;        // K steps
  int ks;           // K split: blocks per cluster
  int stages;       // ring depth
  int a_floats;     // bm * (bk + 4): a's part of a stage
  int stage_floats; // a_floats + bk * bn
};

// cp.async of VEC floats; a source size of 0 writes zeros and reads nothing
// (the callers then pass the output, which is never empty and is aligned as
// the copy needs, as a stand-in source: a or b may be empty when K = 0).
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

// Wait until at most n (0..MAX_STAGES-2) groups are pending; n is uniform.
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

__device__ __forceinline__ float lane(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// Stage K step [k0, k0 + BK) of the block's tile: a rows [row0, row0 + bm)
// into st[bm][BK + 4], b columns [col0, col0 + bn) into
// st[a_floats..][BK][bn].  Thread (tx, ty) copies b's 4 columns
// col0 + 4 tx.. of rows ty, ty + tyn, ...
template <int BK, int VEC>
__device__ __forceinline__ void mm_stage(const MmArgs& p, float* st,
                                         int row0, int col0, int k0,
                                         int tid, int nthr, int tx, int ty) {
  constexpr int LDA = BK + 4;
  float* as = st;
  float* bs = st + p.a_floats + tx * 4;
  const int gc = col0 + tx * 4;
  if constexpr (VEC == 4) {
    for (int i = tid; i < p.bm * (BK / 4); i += nthr) {
      const int r = i / (BK / 4), kk = i % (BK / 4) * 4;
      const int gr = row0 + r, gk = k0 + kk;
      const bool ok = gr < p.m && gk < p.k;
      cp_async<4>(as + r * LDA + kk, ok ? p.a + gr * p.k + gk : p.c, ok);
    }
    for (int r = ty; r < BK; r += p.tyn) {
      const int gk = k0 + r;
      const bool ok = gk < p.k && gc < p.n;
      cp_async<4>(bs + r * p.bn, ok ? p.b + gk * p.n + gc : p.c, ok);
    }
  } else {
    for (int i = tid; i < p.bm * BK; i += nthr) {
      const int r = i / BK, kk = i % BK;
      const int gr = row0 + r, gk = k0 + kk;
      const bool ok = gr < p.m && gk < p.k;
      cp_async<1>(as + r * LDA + kk, ok ? p.a + gr * p.k + gk : p.c, ok);
    }
    for (int r = ty; r < BK; r += p.tyn) {
      const int gk = k0 + r;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = gk < p.k && gc + e < p.n;
        cp_async<1>(bs + r * p.bn + e, ok ? p.b + gk * p.n + gc + e : p.c,
                    ok);
      }
    }
  }
}

// Store 4 consecutive outputs of row r from column gc on (masked by n).
template <int VEC>
__device__ __forceinline__ void st4(const MmArgs& p, int r, int gc,
                                    const float4& v) {
  if constexpr (VEC == 4) {
    if (gc < p.n) *reinterpret_cast<float4*>(p.c + r * p.n + gc) = v;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (gc + e < p.n) p.c[r * p.n + gc + e] = lane(v, e);
  }
}

template <int BK, int TM, int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
sgemm_kernel(const MmArgs p) {
  constexpr int LDA = BK + 4;          // floats per row of a staged a tile
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  // blockIdx.x = tile * ks + split: the ks blocks of a cluster share a tile
  // and split is the block's rank in its cluster
  const int split = blockIdx.x % p.ks;
  const int tile = blockIdx.x / p.ks;
  const int tr = tile / p.tiles_n;
  const int row0 = tr * p.bm, col0 = (tile - tr * p.tiles_n) * p.bn;
  const int s0 = split * p.steps / p.ks;
  const int nsteps = (split + 1) * p.steps / p.ks - s0;
  const int ty = tid / p.txn, tx = tid - ty * p.txn;

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < nsteps)
      mm_stage<BK, VEC>(p, smem + s * p.stage_floats, row0, col0,
                        (s0 + s) * BK, tid, nthr, tx, ty);
    cp_async_commit();
  }
  // ring slots of this step and of the step staged during it
  int slot = 0, fill = p.stages - 1;
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait_n(p.stages - 2);     // this step's group has landed
    __syncthreads();                   // ... for every thread, and the slot
                                       // refilled below is no longer read
    if (step + p.stages - 1 < nsteps)
      mm_stage<BK, VEC>(p, smem + fill * p.stage_floats, row0, col0,
                        (s0 + step + p.stages - 1) * BK, tid, nthr, tx, ty);
    cp_async_commit();
    const float* as = smem + slot * p.stage_floats + ty * LDA;
    const float* bs = smem + slot * p.stage_floats + p.a_floats + tx * 4;
    fill = slot;
    slot = slot + 1 == p.stages ? 0 : slot + 1;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const float4*>(as + i * p.tyn * LDA + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 bv =
            *reinterpret_cast<const float4*>(bs + (kk + q) * p.bn);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float ai = lane(av[i], q);
          acc[i][0] = fmaf(ai, bv.x, acc[i][0]);
          acc[i][1] = fmaf(ai, bv.y, acc[i][1]);
          acc[i][2] = fmaf(ai, bv.z, acc[i][2]);
          acc[i][3] = fmaf(ai, bv.w, acc[i][3]);
        }
      }
    }
  }

  if (p.ks == 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = row0 + ty + i * p.tyn;
      if (r < p.m)
        st4<VEC>(p, r, col0 + tx * 4,
                 make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    }
    return;
  }
  // K split: the partial tile goes to this block's shared memory (the ring
  // is idle: only empty groups can still be pending), then block `split`
  // sums slice `split` of the tile over the cluster in rank order.
  cp_async_wait<0>();
  __syncthreads();
  float* part = smem;                  // bm x bn
#pragma unroll
  for (int i = 0; i < TM; ++i)
    *reinterpret_cast<float4*>(part + (ty + i * p.tyn) * p.bn + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int nv = p.bm * p.txn;         // float4s of the tile
  const int v1 = (split + 1) * nv / p.ks;
  for (int v = split * nv / p.ks + tid; v < v1; v += nthr) {
    const int r = v / p.txn, e = v * 4;
    float4 sum = *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(part, 0) + e);
    for (int q = 1; q < p.ks; ++q) {
      const float4 t = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, q) + e);
      sum.x += t.x; sum.y += t.y; sum.z += t.z; sum.w += t.w;
    }
    if (row0 + r < p.m) st4<VEC>(p, row0 + r, col0 + e - r * p.bn, sum);
  }
  cluster.sync();                      // no block leaves while its partial
                                       // tile may still be read
}

// Opt ``kernel`` into the device's full dynamic shared memory, once per
// (kernel, device); later calls only look the answer up.  ctypes releases
// the GIL, so the table is guarded.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, cudaError_t> seen;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_pair(reinterpret_cast<const void*>(kernel), dev);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = seen.find(key);
  if (it != seen.end()) return it->second;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  seen.emplace(key, err);
  return err;
}

template <int BK, int TM, int VEC>
cudaError_t mm_launch(const MmArgs& p, int grid, int threads, size_t smem,
                      cudaStream_t stream) {
  auto kernel = sgemm_kernel<BK, TM, VEC>;
  cudaError_t err = opt_in(kernel);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.ks > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

// a: (m, k), b: (k, n), c: (m, n); all row-major fp32 on the current device.
// The tiling (bm x bn block tile, K step bk, ring stages, K split ks, vec 4
// or 1) comes from kernels/matmul.py::matmul_tiling.
extern "C" int repro_matmul_f32(const float* a, const float* b, float* c,
                                int m, int n, int k, int bm, int bn, int bk,
                                int tm, int stages, int ks, int vec,
                                void* stream) {
  MmArgs p{a, b, c, m, n, k, bm, bn};
  p.steps = (k + bk - 1) / bk;
  if ((bk != 16 && bk != 32) || (tm != 4 && tm != 8) || bm <= 0 ||
      bn <= 0 || bm % tm != 0 || bn % 4 != 0 || stages < 2 ||
      stages > MAX_STAGES || ks < 1 || ks > MAX_SPLIT ||
      ks > (p.steps > 1 ? p.steps : 1) || (vec != 1 && vec != 4) ||
      (vec == 4 && (k % 4 != 0 || n % 4 != 0)) || m <= 0 || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p.txn = bn / 4;
  p.tyn = bm / tm;
  const int threads = p.txn * p.tyn;
  const long long tiles = static_cast<long long>((m + bm - 1) / bm) *
                          ((n + bn - 1) / bn);
  if (threads > MAX_THREADS || tiles * ks >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  p.tiles_n = (n + bn - 1) / bn;
  p.ks = ks;
  p.stages = stages;
  p.a_floats = bm * (bk + 4);
  p.stage_floats = p.a_floats + bk * bn;
  const int ring = stages * p.stage_floats;
  const int part = ks > 1 ? bm * bn : 0;
  const size_t smem = sizeof(float) * (ring > part ? ring : part);
  const int grid = static_cast<int>(tiles * ks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch =
      bk == 16
          ? (tm == 4 ? (vec == 4 ? mm_launch<16, 4, 4> : mm_launch<16, 4, 1>)
                     : (vec == 4 ? mm_launch<16, 8, 4> : mm_launch<16, 8, 1>))
          : (tm == 4 ? (vec == 4 ? mm_launch<32, 4, 4> : mm_launch<32, 4, 1>)
                     : (vec == 4 ? mm_launch<32, 8, 4>
                                 : mm_launch<32, 8, 1>));
  return static_cast<int>(launch(p, grid, threads, smem, s));
}
