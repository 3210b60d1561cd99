// Fused MAT norm for Hopper (sm_90a): instance-norm statistics plus the
// MAT modulation, out = (x - mean) * rsqrt(var + eps) * (1 + gamma) + beta,
// and its backward.
//
// Replaces s2p_tpu/gan/pallas_kernels.py::fused_mat_norm (the TPU kernel,
// pl.pallas_call at l.78). It computes that module's _plain (l.41-45):
// mean and population variance over H*W per (image, channel), in f32,
// with the result cast back to x's type.
//
// Layout. x and out are NHWC and contiguous, so channels are the unit-stride
// axis. gamma and beta share x's shape and keep a unit channel stride, but
// take their own batch and pixel strides: on the fast path they are the two
// channel halves of one gamma||beta conv output (pixel stride 2C), read in
// place with no copy; in StyleGAN's AdaIN they are one value per (image,
// channel), broadcast over the pixels at pixel stride 0.
//
// Bias. The forward may also take the fast path's gamma||beta conv bias
// (gb_bias, [2C]: gamma's C values, then beta's), which it adds in f32 as
// (1 + b_gamma) + gamma and beta + b_beta, so that the conv runs without its
// bias and no separate pass adds it to the 2C-channel map. Each thread loads
// its V channels' biases once (two 16-byte loads on the vector path), before
// pass 2, whose loop hides the loads' latency. Pass 3 has a loop with the
// bias and one without, chosen by the pointer outside the loop: with a null
// pointer (every caller but the fast path) it does no bias arithmetic, so its
// output is bit for bit the formula's without the bias.
//
// Bound. Both kernels do ~10 flops per byte, far below the card's ~295
// flops per byte, so they are bound by bytes. The forward must read x,
// gamma and beta once and write out once: 4 elements per entry of B*H*W*C.
// The backward must read dy, x and gamma once and write dx and dgamma once:
// 5 elements per entry. At 3.35 TB/s the 13 norms of one 64px/ngf=64
// serving step at batch 256 in bf16 need >= 0.68 ms, the 13 of a
// 100px/ngf=64 train step at batch 16 >= 0.105 ms forward and >= 0.131 ms
// backward.
//
// Design. The launch plan (tile, cluster size, pixels per CTA, shared
// memory, path, vector width) is computed by the Python wrapper
// (gan/cuda_kernels.py::mat_norm_plan) from the shapes, strides and
// alignment, before the launch; this file only checks that it is
// consistent. What each part does:
//
// - Occupancy: H*W split over a thread block cluster. One cluster of k CTAs
//   (k in 1, 2, 4, 8; the cluster dimension is a launch attribute, and the
//   grid is B * channel tiles * k) takes one (image, channel tile); each CTA
//   takes a contiguous range of pixels_per_cta pixels (the last ones may be
//   short or empty). On images of >= 1024 pixels the plan raises k until
//   the grid reaches about two CTAs per SM while each CTA keeps >= 256
//   pixels, so the 50^2 and 100^2 training shapes launch >= 256 CTAs from
//   16 images. Smaller images (25^2 and below) are split only where their
//   slice would not fit in shared memory otherwise, and reach about one CTA
//   per SM with a narrower channel tile (the smallest cluster first): timed
//   on the H100 (chip_smoke.py --sweep), a cluster launch and its barriers
//   cost a small image more than the extra CTAs give (at 25^2 a split in
//   two ran up to 1.35x slower than the whole image). Partial sums meet in
//   distributed shared
//   memory: each CTA writes its per-channel sum, cluster.sync(), and every
//   CTA adds all k partials in rank order (the same order everywhere, so
//   every CTA holds the same statistics). Two stages use two buffers, and a
//   last cluster.sync() keeps each CTA's shared memory alive until its
//   partners have read it. At k = 1 the launch has no cluster attribute and
//   skips the cluster barriers, which a single CTA does not need.
// - Re-reads: on the `resident` path each CTA copies its slice of x (the
//   backward: of x and dy) into shared memory once, with 16-byte cp.async,
//   and every pass reads it there: one HBM read of x instead of three
//   (forward) and of x and dy instead of two (backward). gamma and beta are
//   read from HBM once in the forward; the backward reads gamma twice (the
//   second read meets L2). The plan keeps a slice at <= 100 KB, so two CTAs
//   fit on an SM. The `streaming` path is the same kernel reading x from
//   global memory in every pass. It takes slices that do not fit even at
//   k = 8 (256^2 images and up), and launches whose x (and dy) total
//   <= 4 MiB (in bf16 the 7^2 and 13^2 x 256 training shapes, the forward
//   at 13^2 x 512 and 25^2 x 128, the 4^2 serving shape): their re-reads
//   meet L2, and the sweep found the copy into shared memory and its
//   barrier a loss there (7^2 backward 0.0046 ms resident against 0.0040
//   streaming). Resident is what saves HBM reads at the serving shapes,
//   where x is larger than L2.
// - Load width: on the vector path each thread moves 16 bytes (8 bf16 or 4
//   f32 channels) per load and store; the `lanes` threads that cover one
//   pixel's channel tile read it as one contiguous run. The plan takes it
//   when C is a multiple of 16 forward, 32 backward (every tile whole and of
//   >= 2 or >= 4 lanes, so the vector path needs no channel mask; every
//   main-path C is) and every base
//   pointer and batch/pixel stride is 16-byte aligned; otherwise the scalar
//   variant of the same kernel runs (32 threads on 32 channels, ragged
//   tiles masked), e.g. for beta = gb[..., 12:] with C = 12.
// - Reductions: warp shuffles across the threads of a channel, then the
//   CTA's eight warps in shared memory, then the cluster.
//
// Statistics. Two passes in f32: the mean first, from sums of
// x - x[pixel 0] (a shift near the mean, so a large mean keeps its low
// bits), then the centred sum of squares against that mean, so the
// variance stays exact when |mean| >> std, where E[x^2] - mean^2 (the
// Pallas body, l.68) cancels. When the caller records a gradient, rank 0
// of each cluster also writes the f32 per-(image, channel) mean and rstd,
// [B, C], for the backward; on the inference path those pointers are null.
//
// Backward. The JAX package has no backward kernel (XLA differentiates the
// plain norm there); the port's MAT norm on the card is this kernel, so its
// gradient is one too. With xhat = (x - mean) * rstd and g = dy * (1 + gamma):
//   dbeta  = dy                     (no kernel: the wrapper returns dy)
//   dgamma = dy * xhat
//   dx     = rstd * (g - mean_HW(g) - xhat * mean_HW(g * xhat))
// Same plan and grid as the forward. Pass 1 sums g and g*xhat over H*W in
// f32 (cluster-wide as above); pass 2 writes dx and dgamma.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "vec_io.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSums = 2;  // sums reduced at once (the backward's two)
// f32 scratch after the slab, per channel of the tile: warp partials
// [kWarps][kMaxSums], cluster partials [2 stages][kMaxSums], totals [kMaxSums]
constexpr int kScratchFloats = kWarps * kMaxSums + 2 * kMaxSums + kMaxSums;

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Starts the copy of n pixels of one channel tile into dst ([n][tile_c]);
// src is the tile's first channel at the CTA's first pixel. The vector path
// issues 16-byte cp.async copies (the caller waits); the scalar path copies
// the channels below c_left.
template <typename T, int V>
__device__ __forceinline__ void load_slab(T* dst, const T* src, int n, int C, int tile_c,
                                          int c_left) {
  const int per_px = tile_c / V;
  for (int i = threadIdx.x; i < n * per_px; i += kThreads) {
    const int p = i / per_px, j = (i - p * per_px) * V;
    if constexpr (V > 1) {
      cp_async_16(dst + p * tile_c + j, src + (long long)p * C + j);
    } else if (j < c_left) {
      dst[p * tile_c + j] = src[(long long)p * C + j];
    }
  }
}

// Where a thread sits: `lanes` consecutive threads cover one pixel's channel
// tile, V channels each; the block's rows of threads stride over the pixels.
struct Place {
  int b, tile, rank, lanes, cgi, row, rows, c, p0, n;
};

__device__ __forceinline__ Place place(int hw, int tile_c, int c_tiles, int ppc, int V,
                                       cg::cluster_group& cluster) {
  Place q;
  const int k = static_cast<int>(cluster.num_blocks());
  q.rank = static_cast<int>(cluster.block_rank());
  const int group = blockIdx.x / k;  // one (image, channel tile) per cluster
  q.b = group / c_tiles;
  q.tile = group - q.b * c_tiles;
  q.lanes = tile_c / V;
  q.cgi = threadIdx.x % q.lanes;
  q.row = threadIdx.x / q.lanes;
  q.rows = kThreads / q.lanes;
  q.c = q.tile * tile_c + q.cgi * V;
  q.p0 = q.rank * ppc;
  q.n = max(0, min(hw, q.p0 + ppc) - q.p0);
  return q;
}

// Sums acc over the threads of each channel (warp shuffles, then the CTA's
// warps in shared memory), then over the CTAs of the cluster through
// distributed shared memory; the cluster-wide totals land in tot[s][0..tile_c)
// of every CTA. `part` is this stage's buffer of cluster partials: a stage
// never reuses an earlier stage's buffer, which a slower partner may still
// be reading.
template <int NS, int V>
__device__ __forceinline__ void cluster_sum(float (&acc)[NS][V], const Place& q, int tile_c,
                                            float* red, float* part, float* tot,
                                            cg::cluster_group& cluster) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int off = q.lanes; off < 32; off <<= 1) {
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[s][v] += __shfl_xor_sync(0xffffffffu, acc[s][v], off);
  }
  if (lane < q.lanes) {
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int v = 0; v < V; ++v) red[(warp * NS + s) * tile_c + lane * V + v] = acc[s][v];
  }
  __syncthreads();
  const int k = static_cast<int>(cluster.num_blocks());
  if (tid < tile_c) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w) t += red[(w * NS + s) * tile_c + tid];
      (k > 1 ? part : tot)[s * tile_c + tid] = t;
    }
  }
  if (k > 1) {  // a launch without a cluster (k = 1) is its own cluster of one
    cluster.sync();
    if (tid < tile_c) {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        float t = 0.f;
        for (int r = 0; r < k; ++r) t += cluster.map_shared_rank(part, r)[s * tile_c + tid];
        tot[s * tile_c + tid] = t;
      }
    }
  }
  __syncthreads();
}

template <typename T>
struct FwdArgs {
  const T* x;
  const T* gamma;
  const T* beta;
  const T* gb_bias;  // the gamma||beta conv's bias [2C] (gamma's C, then beta's), or null
  T* out;
  float* mean;  // f32 [B, C] statistics for the backward, or null
  float* rstd;
  int hw, C, tile_c, c_tiles, ppc;
  long long g_bstride, g_pstride, b_bstride, b_pstride;
  float eps;
};

// CTAs an SM each forward instance is compiled for. A kernel gets the
// registers of its hungriest loop, here the bias loop of pass 3, so the bound
// keeps the vector paths at the occupancy they had without it: bf16 at 80
// registers and three CTAs (the serving shapes' small slices let three share
// an SM), where the bias loop would take 95 and two; f32 at 64 and four,
// where it would take 72 and three. The scalar paths keep the two that a
// 100 KB slice allows.
template <typename T, int V>
constexpr int kFwdMinCtas = V == 1 ? 2 : std::is_same<T, __nv_bfloat16>::value ? 3 : 4;

template <typename T, int V, bool kResident>
__global__ void __launch_bounds__(kThreads, kFwdMinCtas<T, V>)
    fused_mat_norm_kernel(const FwdArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Place q = place(a.hw, a.tile_c, a.c_tiles, a.ppc, V, cluster);
  const bool active = q.c < a.C;
  const long long img = (long long)q.b * a.hw;  // the image's first pixel
  const T* xg = a.x + (img + q.p0) * a.C + q.c;  // this thread's channels, the CTA's first pixel

  T* slab = reinterpret_cast<T*>(smem);
  const size_t slab_bytes = kResident ? (size_t)a.ppc * a.tile_c * sizeof(T) : 0;
  float* red = reinterpret_cast<float*>(smem + slab_bytes);
  float* part = red + kWarps * kMaxSums * a.tile_c;
  float* tot = part + 2 * kMaxSums * a.tile_c;

  if constexpr (kResident) {
    load_slab<T, V>(slab, a.x + (img + q.p0) * a.C + q.tile * a.tile_c, q.n, a.C, a.tile_c,
                    a.C - q.tile * a.tile_c);
    if constexpr (V > 1) cp_async_wait_all();
    __syncthreads();
  }
  auto load_x = [&](int p, float (&f)[V]) {
    if constexpr (kResident) load_vec<T, V>(slab + p * a.tile_c + q.cgi * V, f);
    else load_vec<T, V>(xg + (long long)p * a.C, f);
  };

  // pass 1: mean, from sums shifted by the channel's first pixel
  float shift[V], acc[1][V], mu[V], rs[V];
#pragma unroll
  for (int v = 0; v < V; ++v) shift[v] = acc[0][v] = 0.f;
  if (active) {
    load_vec<T, V>(a.x + img * a.C + q.c, shift);
#pragma unroll 4
    for (int p = q.row; p < q.n; p += q.rows) {
      float f[V];
      load_x(p, f);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[0][v] += f[v] - shift[v];
    }
  }
  cluster_sum<1, V>(acc, q, a.tile_c, red, part, tot, cluster);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    mu[v] = shift[v] + tot[q.cgi * V + v] / (float)a.hw;
    acc[0][v] = 0.f;
  }
  // the folded bias (b_gamma, b_beta), loaded here, so that pass 2 hides the
  // loads' latency
  float g1[V], bb[V];
  if (a.gb_bias != nullptr && active) load_bias<T, V>(a.gb_bias, a.C, q.c, g1, bb);

  // pass 2: population variance from the centred sum of squares
  if (active) {
#pragma unroll 4
    for (int p = q.row; p < q.n; p += q.rows) {
      float f[V];
      load_x(p, f);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float d = f[v] - mu[v];
        acc[0][v] += d * d;
      }
    }
  }
  cluster_sum<1, V>(acc, q, a.tile_c, red, part + kMaxSums * a.tile_c, tot, cluster);
#pragma unroll
  for (int v = 0; v < V; ++v) rs[v] = rsqrtf(tot[q.cgi * V + v] / (float)a.hw + a.eps);

  if (active) {
    if (a.mean != nullptr && q.rank == 0 && q.row == 0) {  // saved for the backward
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (q.c + v < a.C) {
          a.mean[(long long)q.b * a.C + q.c + v] = mu[v];
          a.rstd[(long long)q.b * a.C + q.c + v] = rs[v];
        }
      }
    }
    // pass 3: normalise, modulate (with the bias folded in), store; one loop
    // each way, so that a launch without a bias does no bias arithmetic
    const T* g = a.gamma + q.b * a.g_bstride + q.p0 * a.g_pstride + q.c;
    const T* be = a.beta + q.b * a.b_bstride + q.p0 * a.b_pstride + q.c;
    T* o = a.out + (img + q.p0) * a.C + q.c;
    auto modulate = [&](auto bias) {
      constexpr bool kBias = decltype(bias)::value;
      if constexpr (kBias) {
#pragma unroll
        for (int v = 0; v < V; ++v) g1[v] = 1.f + g1[v];
      }
#pragma unroll 4
      for (int p = q.row; p < q.n; p += q.rows) {
        float xv[V], gv[V], bv[V], r[V];
        load_x(p, xv);
        load_vec<T, V>(g + p * a.g_pstride, gv);
        load_vec<T, V>(be + p * a.b_pstride, bv);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if constexpr (kBias)
            r[v] = (xv[v] - mu[v]) * rs[v] * (g1[v] + gv[v]) + (bv[v] + bb[v]);
          else
            r[v] = (xv[v] - mu[v]) * rs[v] * (1.f + gv[v]) + bv[v];
        }
        store_vec<T, V>(o + (long long)p * a.C, r);
      }
    };
    if (a.gb_bias != nullptr) modulate(std::true_type{});
    else modulate(std::false_type{});
  }
  if (cluster.num_blocks() > 1) cluster.sync();  // no CTA leaves while a partner may still read
}

template <typename T>
struct BwdArgs {
  const T* dy;
  const T* x;
  const T* gamma;
  const float* mean;  // the forward's f32 [B, C] statistics
  const float* rstd;
  T* dx;
  T* dgamma;
  int hw, C, tile_c, c_tiles, ppc;
  long long g_bstride, g_pstride;
};

template <typename T, int V, bool kResident>
__global__ void __launch_bounds__(kThreads, 2) fused_mat_norm_bwd_kernel(const BwdArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Place q = place(a.hw, a.tile_c, a.c_tiles, a.ppc, V, cluster);
  const bool active = q.c < a.C;
  const long long img = (long long)q.b * a.hw;
  const long long first = (img + q.p0) * a.C;  // the CTA's first pixel
  const size_t slab_elems = kResident ? (size_t)a.ppc * a.tile_c : 0;

  T* slab_x = reinterpret_cast<T*>(smem);
  T* slab_dy = slab_x + slab_elems;
  float* red = reinterpret_cast<float*>(smem + 2 * slab_elems * sizeof(T));
  float* part = red + kWarps * kMaxSums * a.tile_c;
  float* tot = part + 2 * kMaxSums * a.tile_c;

  if constexpr (kResident) {
    const int c_left = a.C - q.tile * a.tile_c;
    load_slab<T, V>(slab_x, a.x + first + q.tile * a.tile_c, q.n, a.C, a.tile_c, c_left);
    load_slab<T, V>(slab_dy, a.dy + first + q.tile * a.tile_c, q.n, a.C, a.tile_c, c_left);
    if constexpr (V > 1) cp_async_wait_all();
    __syncthreads();
  }
  auto load_xdy = [&](int p, float (&xv)[V], float (&dyv)[V]) {
    if constexpr (kResident) {
      load_vec<T, V>(slab_x + p * a.tile_c + q.cgi * V, xv);
      load_vec<T, V>(slab_dy + p * a.tile_c + q.cgi * V, dyv);
    } else {
      load_vec<T, V>(a.x + first + q.c + (long long)p * a.C, xv);
      load_vec<T, V>(a.dy + first + q.c + (long long)p * a.C, dyv);
    }
  };

  float mu[V], rs[V], acc[2][V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const bool ok = active && q.c + v < a.C;
    mu[v] = ok ? a.mean[(long long)q.b * a.C + q.c + v] : 0.f;
    rs[v] = ok ? a.rstd[(long long)q.b * a.C + q.c + v] : 0.f;
    acc[0][v] = acc[1][v] = 0.f;
  }
  const T* g = a.gamma + q.b * a.g_bstride + q.p0 * a.g_pstride + q.c;

  // pass 1: sums of g and g * xhat over H*W
  if (active) {
#pragma unroll 4
    for (int p = q.row; p < q.n; p += q.rows) {
      float xv[V], dyv[V], gm[V];
      load_xdy(p, xv, dyv);
      load_vec<T, V>(g + p * a.g_pstride, gm);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float gv = dyv[v] * (1.f + gm[v]);
        acc[0][v] += gv;
        acc[1][v] += gv * ((xv[v] - mu[v]) * rs[v]);
      }
    }
  }
  cluster_sum<2, V>(acc, q, a.tile_c, red, part, tot, cluster);

  // pass 2: dx and dgamma
  if (active) {
    float mg[V], mgx[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      mg[v] = tot[q.cgi * V + v] / (float)a.hw;
      mgx[v] = tot[a.tile_c + q.cgi * V + v] / (float)a.hw;
    }
    T* dx = a.dx + first + q.c;
    T* dg = a.dgamma + first + q.c;
#pragma unroll 4
    for (int p = q.row; p < q.n; p += q.rows) {
      float xv[V], dyv[V], gm[V], rx[V], rg[V];
      load_xdy(p, xv, dyv);
      load_vec<T, V>(g + p * a.g_pstride, gm);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float gv = dyv[v] * (1.f + gm[v]);
        const float xh = (xv[v] - mu[v]) * rs[v];
        rx[v] = rs[v] * (gv - mg[v] - xh * mgx[v]);
        rg[v] = dyv[v] * xh;
      }
      store_vec<T, V>(dx + (long long)p * a.C, rx);
      store_vec<T, V>(dg + (long long)p * a.C, rg);
    }
  }
  if (cluster.num_blocks() > 1) cluster.sync();  // no CTA leaves while a partner may still read
}

constexpr int kDefaultSmem = 48 * 1024;  // dynamic shared memory allowed without the attribute
constexpr int kMaxDevices = 64;

// smem_set[device]: the kernel's dynamic shared memory limit on that device
// as set so far (0: the default); cudaFuncSetAttribute holds for the current
// device only, and is called only when a launch needs more than is set, so
// that the common launch makes no extra runtime call and a CUDA graph can
// capture it.
template <typename Args>
cudaError_t launch_cluster(void (*kernel)(Args), const Args& args, int grid, int cluster,
                           int smem, int* smem_set, cudaStream_t stream) {
  if (smem > kDefaultSmem) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (smem > smem_set[dev]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      smem_set[dev] = smem;
    }
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // k = 1: a plain launch, scheduled without clusters
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The plan's consistency with this file's layout: the cluster size, the
// tile (lanes * width, lanes a power of two that divides a warp), pixels per
// CTA that cover H*W, whole tiles on the vector path, and the shared memory
// the kernel will carve.
bool plan_ok(int batch, int hw, int C, int elt, int arrays, int tile_c, int cluster, int ppc,
             int resident, int vec, int smem) {
  const int width = vec ? 16 / elt : 1;
  const int lanes = tile_c / width;
  if (batch <= 0 || hw <= 0 || C <= 0 || tile_c <= 0 || tile_c % width != 0) return false;
  if (lanes > 32 || (lanes & (lanes - 1)) != 0 || (!vec && lanes != 32)) return false;
  if (vec && (lanes < 2 || C % tile_c != 0)) return false;
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) return false;
  if (ppc <= 0 || (long long)ppc * cluster < hw) return false;
  const long long need = (resident ? (long long)arrays * ppc * tile_c * elt : 0) +
                         (long long)kScratchFloats * tile_c * 4;
  return smem == need && smem <= 232448;
}

template <typename T, int V, bool kResident>
cudaError_t run_fwd(const FwdArgs<T>& a, int grid, int cluster, int smem, cudaStream_t stream) {
  static int smem_set[kMaxDevices] = {};
  return launch_cluster(fused_mat_norm_kernel<T, V, kResident>, a, grid, cluster, smem,
                        smem_set, stream);
}

template <typename T, int V, bool kResident>
cudaError_t run_bwd(const BwdArgs<T>& a, int grid, int cluster, int smem, cudaStream_t stream) {
  static int smem_set[kMaxDevices] = {};
  return launch_cluster(fused_mat_norm_bwd_kernel<T, V, kResident>, a, grid, cluster, smem,
                        smem_set, stream);
}

template <typename T>
cudaError_t launch_fwd(const FwdArgs<T>& a, int batch, int cluster, int resident, int vec,
                       int smem, cudaStream_t stream) {
  constexpr int W = 16 / sizeof(T);
  const int grid = batch * a.c_tiles * cluster;
  if (vec)
    return resident ? run_fwd<T, W, true>(a, grid, cluster, smem, stream)
                    : run_fwd<T, W, false>(a, grid, cluster, smem, stream);
  return resident ? run_fwd<T, 1, true>(a, grid, cluster, smem, stream)
                  : run_fwd<T, 1, false>(a, grid, cluster, smem, stream);
}

template <typename T>
cudaError_t launch_bwd(const BwdArgs<T>& a, int batch, int cluster, int resident, int vec,
                       int smem, cudaStream_t stream) {
  constexpr int W = 16 / sizeof(T);
  const int grid = batch * a.c_tiles * cluster;
  if (vec)
    return resident ? run_bwd<T, W, true>(a, grid, cluster, smem, stream)
                    : run_bwd<T, W, false>(a, grid, cluster, smem, stream);
  return resident ? run_bwd<T, 1, true>(a, grid, cluster, smem, stream)
                  : run_bwd<T, 1, false>(a, grid, cluster, smem, stream);
}

template <typename T>
cudaError_t forward(const void* x, const void* gamma, const void* beta, const void* gb_bias,
                    void* out, void* mean, void* rstd, int batch, int hw, int C,
                    long long g_bstride, long long g_pstride, long long b_bstride,
                    long long b_pstride, float eps, int tile_c, int cluster, int ppc,
                    int resident, int vec, int smem, cudaStream_t stream) {
  if (!plan_ok(batch, hw, C, sizeof(T), 1, tile_c, cluster, ppc, resident, vec, smem))
    return cudaErrorInvalidValue;
  const FwdArgs<T> a{static_cast<const T*>(x), static_cast<const T*>(gamma),
                     static_cast<const T*>(beta), static_cast<const T*>(gb_bias),
                     static_cast<T*>(out), static_cast<float*>(mean), static_cast<float*>(rstd),
                     hw, C, tile_c, (C + tile_c - 1) / tile_c, ppc,
                     g_bstride, g_pstride, b_bstride, b_pstride, eps};
  return launch_fwd<T>(a, batch, cluster, resident, vec, smem, stream);
}

template <typename T>
cudaError_t backward(const void* dy, const void* x, const void* gamma, const void* mean,
                     const void* rstd, void* dx, void* dgamma, int batch, int hw, int C,
                     long long g_bstride, long long g_pstride, int tile_c, int cluster, int ppc,
                     int resident, int vec, int smem, cudaStream_t stream) {
  if (!plan_ok(batch, hw, C, sizeof(T), 2, tile_c, cluster, ppc, resident, vec, smem))
    return cudaErrorInvalidValue;
  const BwdArgs<T> a{static_cast<const T*>(dy), static_cast<const T*>(x),
                     static_cast<const T*>(gamma), static_cast<const float*>(mean),
                     static_cast<const float*>(rstd), static_cast<T*>(dx),
                     static_cast<T*>(dgamma), hw, C, tile_c, (C + tile_c - 1) / tile_c, ppc,
                     g_bstride, g_pstride};
  return launch_bwd<T>(a, batch, cluster, resident, vec, smem, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. gb_bias (contiguous [2C] of x's dtype)
// may be null, and mean and rstd (f32 [B, C]) may both be null. tile_c ...
// smem are the launch plan (cuda_kernels.py::mat_norm_plan). Returns the
// launch's cudaError_t; cudaErrorInvalidValue for a plan this file cannot run.
extern "C" int s2p_fused_mat_norm(const void* x, const void* gamma, const void* beta,
                                  const void* gb_bias, void* out, void* mean, void* rstd,
                                  int batch, int hw, int C, long long g_bstride,
                                  long long g_pstride, long long b_bstride, long long b_pstride,
                                  int dtype, float eps, int tile_c, int cluster, int ppc,
                                  int resident, int vec, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return forward<float>(x, gamma, beta, gb_bias, out, mean, rstd, batch, hw, C, g_bstride,
                          g_pstride, b_bstride, b_pstride, eps, tile_c, cluster, ppc, resident,
                          vec, smem, s);
  if (dtype == 1)
    return forward<__nv_bfloat16>(x, gamma, beta, gb_bias, out, mean, rstd, batch, hw, C,
                                  g_bstride, g_pstride, b_bstride, b_pstride, eps, tile_c,
                                  cluster, ppc, resident, vec, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dy, x, dx and dgamma are contiguous NHWC of one dtype (0 = float32,
// 1 = bfloat16); gamma has unit channel stride and the given batch and pixel
// strides; mean and rstd are the forward's f32 [B, C]. tile_c ... smem are
// the launch plan. Returns the launch's cudaError_t.
extern "C" int s2p_fused_mat_norm_bwd(const void* dy, const void* x, const void* gamma,
                                      const void* mean, const void* rstd, void* dx,
                                      void* dgamma, int batch, int hw, int C,
                                      long long g_bstride, long long g_pstride, int dtype,
                                      int tile_c, int cluster, int ppc, int resident, int vec,
                                      int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return backward<float>(dy, x, gamma, mean, rstd, dx, dgamma, batch, hw, C, g_bstride,
                           g_pstride, tile_c, cluster, ppc, resident, vec, smem, s);
  if (dtype == 1)
    return backward<__nv_bfloat16>(dy, x, gamma, mean, rstd, dx, dgamma, batch, hw, C,
                                   g_bstride, g_pstride, tile_c, cluster, ppc, resident, vec,
                                   smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
