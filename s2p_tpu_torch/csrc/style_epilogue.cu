// StyleGAN's layer epilogue before the instance norm, for Hopper (sm_90a),
// in one pass, in place:
//   x = lrelu(x + noise * strength[c] + bias[c], slope)
// computed in f32 as fmaf(noise, strength, x) + bias, then the leaky ReLU,
// rounded once to x's type.
//
// StyleGAN2's variant (style_epilogue_demod_kernel) ends a modulated conv run
// as x·s, a shared-weight conv, then this pass (networks_stylegan2.py's
// modulated_conv2d_layer with fused_modconv=False, then the layer's noise and
// apply_bias_act):
//   t = lrelu(x * demod[b,c] + noise * strength[c] + bias[c], slope) * gain
// with the demodulation coefficient read at pixel stride 0 (one f32 value an
// image and channel, rows ld_demod apart) and gain the activation's sqrt(2).
// It writes t * mod[b,c] (the next conv's input modulation, f32, rows ld_mod
// apart), so that the next conv's input scaling costs no pass. Every launch
// is one of two passes, which replace two more passes each:
// - kFir (an up layer): x is the stride-2 transposed conv's output
//   [B, 2H+1, 2W+1, C]; the pass computes the [1,3,3,1] FIR of
//   upsample_conv_2d (4 separable taps, pads 1/1) in registers and writes
//   into out [B, 2H, 2W, C]. A thread owns one channel vector of kFirRows
//   output pixels down a column: it filters each of the kFirRows + 3 input
//   rows across (4 loads a row, clamped addresses with zero weights at the
//   border, so no load branches), then down, 7 loads an output where a
//   thread a pixel would make 16.
// - toRGB (a layer that feeds the skip generator's toRGB): the modulated 1x1
//   toRGB, sum_c t[c] * rgb_w[b,j,c] for j < 3 (rgb_w f32 [B, 3, C], the
//   style folded in; 16-byte loads), is reduced over a pixel's threads with
//   warp shuffles and stored (or, where a pixel spans warps, added
//   atomically) into rgb [B, H, W, 3] (f32, zeroed by the caller); the
//   pixel's first group adds the bias and upsample_2d of the previous RGB
//   sum y_prev [B, H/2, W/2, 3] (the same taps after zero insertion, pads
//   2/1; its 12 products a pixel spread over the group's lanes), so that
//   neither toRGB nor the skip's upsample costs a pass of its own. The last
//   layer, which no conv follows, writes no t (kMod false).
// Bound: bytes, as below; with the FIR the larger input read once; with
// toRGB 12 bytes of rgb a pixel. It replaces no TPU kernel either (the JAX
// package has no StyleGAN2); it replaces PyTorch's depthwise conv for the FIR
// (a layout transform and cuDNN's grouped direct kernel, ~1.8% of the bytes
// bound at 1024²), toRGB as a batched GEMM, the RGB upsample and their adds.
//
// Replaces no TPU kernel (the JAX package has no StyleGAN); it replaces the
// eager epilogue of networks_stylegan.py's layer_epilogue (apply_noise,
// apply_bias, the leaky ReLU): three passes over the activation, two of
// them PyTorch's broadcasting elementwise kernel, which does not vectorize
// a [1, C, 1, 1] or [B, 1, H, W] operand against a channels_last map.
//
// Layout. x is NHWC and contiguous ([B, H, W, C], channels the unit-stride
// axis); noise is one float32 value a pixel ([B, H, W], contiguous: the
// [B, 1, H, W] map StyleGAN draws); strength and bias are [C] of x's type.
//
// Bound. 4 flops per element against 2 elements moved (read x, write x) and
// 4 bytes of noise a pixel: bytes bound it, B*H*W*(2*C*itemsize + 4) at
// 3.35 TB/s.
//
// Design. A thread owns one 16-byte vector of channels (8 bf16 or 4 f32; one
// channel on the scalar path) of one pixel and walks the tensor in a
// grid-stride loop, kUnroll vectors a step: it issues the loads of all of
// them (x and the pixel's noise; the threads of one pixel read the same
// noise word, which L1 serves) before the first store, then reads the
// channels' strength and bias (L1 hits after the first pass). The vector
// path needs C a multiple of the vector and 16-byte aligned x, strength and
// bias; else the scalar variant runs. The plan (vector path, grid) is
// computed by the Python wrapper (gan/cuda_kernels.py::style_epilogue_plan);
// this file only checks that it is consistent.
//
// Statistics (style_epilogue_kernel_stats, StyleGAN's fast path). The instance
// norm that reads x next needs each (image, channel)'s mean and variance over
// the H*W values stored here, and a plane of up to 2^20 pixels does not fit on
// chip: taken there, they cost the norm two more reads of x. So this variant
// also reduces what it stores, and the norm (fused_mat_norm.cu's statistics
// variant) only normalises. Each CTA takes a contiguous range of ppc pixels of
// one image (grid: parts x B; the last range may be short, none is empty), and
// a thread keeps its channel vector throughout (C / V divides the block, so a
// row of C / V threads covers a pixel). Accumulated are the values as stored
// (rounded to x's type), shifted by K, the mean of kShiftSamples of them
// spread over the range, which the first row of threads reads before any
// thread writes (one barrier hands K to the rest). A thread sums d = y - K and
// d * d; the threads' sums (one shift, so they add) meet in warp shuffles and
// shared memory in a fixed order, and the CTA writes its three f32 slots for
// each channel: K, the mean offset S1 / n and M2 = S2 - S1^2 / n. No atomics,
// no memset: every slot is written once. The shift keeps
// the variance exact when |mean| >> std: M2 cancels only as far as K lies from
// the mean, about std / sqrt(kShiftSamples); and the mean stays split as K +
// offset for the norm's merge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "vec_io.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vectors a thread loads before it stores

template <typename T>
struct EpilogueArgs {
  T* x;  // [B, H, W, C] contiguous, read and written
  const float* noise;  // [B, H, W] contiguous
  const T* strength;  // [C]
  const T* bias;  // [C]
  long long vectors;  // B*H*W*C / V
  int vpp;  // vectors a pixel: C / V
  float slope;
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) style_epilogue_kernel(const EpilogueArgs<T> a) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i0 = (long long)blockIdx.x * kThreads + threadIdx.x; i0 < a.vectors;
       i0 += stride * kUnroll) {
    float xv[kUnroll][V], nz[kUnroll];
    int c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * stride;
      if (i < a.vectors) {
        const long long p = i / a.vpp;
        c[u] = static_cast<int>(i - p * a.vpp) * V;
        load_vec<T, V>(a.x + i * V, xv[u]);
        nz[u] = a.noise[p];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * stride;
      if (i < a.vectors) {
        float s[V], b[V], r[V];
        load_vec<T, V>(a.strength + c[u], s);
        load_vec<T, V>(a.bias + c[u], b);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float t = fmaf(nz[u], s[v], xv[u][v]) + b[v];
          r[v] = t > 0.f ? t : t * a.slope;
        }
        store_vec<T, V>(a.x + i * V, r);
      }
    }
  }
}

constexpr int kShiftSamples = 8;  // stored values a statistics CTA averages for its shift

template <typename T>
struct StatsArgs {
  T* x;  // [B, hw, C] contiguous, read and written
  const float* noise;  // [B, hw] contiguous
  const T* strength;  // [C]
  const T* bias;  // [C]
  float* part;  // [B, parts, 3, C]: each CTA's shift, mean offset and M2 a channel
  int hw, ppc, vpp;  // pixels an image, pixels a CTA, vectors a pixel (C / V, divides kThreads)
  float slope;
};

// v as x's type stores it, back in f32.
template <typename T, int V>
__device__ __forceinline__ void round_vec(float (&v)[V]) {
  if constexpr (!std::is_same_v<T, float>) {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __bfloat162float(__float2bfloat16_rn(v[i]));
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) style_epilogue_kernel_stats(const StatsArgs<T> a) {
  __shared__ float red[kThreads * 2 * V];  // the threads' sums: [group][lane][S1, S2][V]
  __shared__ float shift[kThreads * V];  // K: [lane][V]
  const int vpp = a.vpp, C = vpp * V, lane = threadIdx.x % vpp, row = threadIdx.x / vpp;
  const int rows = kThreads / vpp, c = lane * V, b = blockIdx.y;
  const int p0 = blockIdx.x * a.ppc, n = min(a.hw - p0, a.ppc);  // n >= 1 (the plan's)
  T* xb = a.x + ((long long)b * a.hw + p0) * C + c;
  const float* nb = a.noise + (long long)b * a.hw + p0;
  float s[V], bs[V], k[V], s1[V], s2[V];
  load_vec<T, V>(a.strength + c, s);
  load_vec<T, V>(a.bias + c, bs);
  auto activate = [&](float (&r)[V], float nz) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float t = fmaf(nz, s[v], r[v]) + bs[v];
      r[v] = t > 0.f ? t : t * a.slope;
    }
  };
  if (row == 0) {  // the shift: the mean of a few stored values, spread over the range
#pragma unroll
    for (int v = 0; v < V; ++v) k[v] = 0.f;
    for (int j = 0; j < kShiftSamples; ++j) {
      const int q = static_cast<int>((2LL * j + 1) * n / (2 * kShiftSamples));
      float r[V];
      load_vec<T, V>(xb + (long long)q * C, r);
      activate(r, nb[q]);
      round_vec<T, V>(r);
#pragma unroll
      for (int v = 0; v < V; ++v) k[v] += r[v];
    }
#pragma unroll
    for (int v = 0; v < V; ++v) shift[lane * V + v] = k[v] * (1.f / kShiftSamples);
  }
  __syncthreads();  // the samples are read before any thread writes them
#pragma unroll
  for (int v = 0; v < V; ++v) {
    k[v] = shift[lane * V + v];
    s1[v] = s2[v] = 0.f;
  }
  for (int p = row; p < n; p += rows * kUnroll) {
    float xv[kUnroll][V], nz[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = p + u * rows;
      if (q < n) {
        load_vec<T, V>(xb + (long long)q * C, xv[u]);
        nz[u] = nb[q];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = p + u * rows;
      if (q < n) {
        activate(xv[u], nz[u]);
        store_vec<T, V>(xb + (long long)q * C, xv[u]);
        round_vec<T, V>(xv[u]);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float d = xv[u][v] - k[v];
          s1[v] += d;
          s2[v] = fmaf(d, d, s2[v]);
        }
      }
    }
  }
  // the sums of each channel vector: across the rows of a warp (vpp < 32), then
  // the groups left (the warps, or the rows when a row spans warps) in shared memory
  for (int off = vpp; off < 32; off <<= 1) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      s1[v] += __shfl_xor_sync(0xffffffffu, s1[v], off);
      s2[v] += __shfl_xor_sync(0xffffffffu, s2[v], off);
    }
  }
  const bool by_warp = vpp < 32;
  const int groups = by_warp ? kThreads / 32 : rows, g = by_warp ? threadIdx.x / 32 : row;
  if (!by_warp || threadIdx.x % 32 < vpp) {
    float* dst = red + (g * vpp + lane) * 2 * V;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      dst[v] = s1[v];
      dst[V + v] = s2[v];
    }
  }
  __syncthreads();
  if (threadIdx.x < vpp) {  // row 0: the CTA's slots for its channels
#pragma unroll
    for (int v = 0; v < V; ++v) s1[v] = s2[v] = 0.f;
    for (int gi = 0; gi < groups; ++gi) {
      const float* src = red + (gi * vpp + lane) * 2 * V;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        s1[v] += src[v];
        s2[v] += src[V + v];
      }
    }
    float* dst = a.part + ((long long)b * gridDim.x + blockIdx.x) * 3 * C + c;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float off = s1[v] / (float)n;
      dst[v] = k[v];
      dst[C + v] = off;
      dst[2 * C + v] = fmaxf(0.f, s2[v] - s1[v] * off);
    }
  }
}

// V float32 values from p: whole 16-byte loads on the vector path (the
// wrapper checks that p is 16-byte aligned there), one load on the scalar.
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = *p;
  } else {
    static_assert(V % 4 == 0, "whole 16-byte vectors");
#pragma unroll
    for (int j = 0; j < V / 4; ++j) {
      const float4 r = *reinterpret_cast<const float4*>(p + 4 * j);
      f[4 * j] = r.x; f[4 * j + 1] = r.y; f[4 * j + 2] = r.z; f[4 * j + 3] = r.w;
    }
  }
}

template <typename T>
struct DemodArgs {
  T* x;  // [B, H, W, C] contiguous, read and written; kFir: the input [B, H+1, W+1, C], read
  T* out;  // kFir: the output [B, H, W, C]; else nullptr (toRGB)
  const float* noise;  // [B, H, W] contiguous
  const T* strength;  // [C]
  const T* bias;  // [C]
  const float* demod;  // [B, C], rows ld_demod apart
  const float* mod;  // [B, C], rows ld_mod apart; nullptr for the last layer (kMod false)
  const float* rgb_w;  // toRGB: [B, 3, C]
  float* rgb;  // toRGB: [B, H, W, 3], accumulated
  const float* y_prev;  // toRGB: [B, H/2, W/2, 3], or nullptr (the first resolution)
  unsigned vectors;  // B*H*W*C / V, below 2^31: the index math is 32-bit
  unsigned hw;  // pixels an image
  int vpp;  // vectors a pixel: C / V
  int ld_demod, ld_mod;
  float slope, gain;
  int wo;  // the output's width
  float taps[4];  // the FIR's 1-D taps (separable, gain included)
  float rgb_bias[3];
};

constexpr int kFirRows = 4;  // output rows a kFir thread computes down a column

// The epilogue of one vector of channels c .. c + V - 1 of image b: r holds
// the conv's output and becomes t = lrelu(r * d + noise * strength + bias) * gain.
template <typename T, int V>
__device__ __forceinline__ void activate(const DemodArgs<T>& a, int b, int c, float nz,
                                         float (&r)[V]) {
  float s[V], bs[V], d[V];
  load_vec<T, V>(a.strength + c, s);
  load_vec<T, V>(a.bias + c, bs);
  load_f32<V>(a.demod + b * a.ld_demod + c, d);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float t = fmaf(nz, s[v], r[v] * d[v]) + bs[v];
    r[v] = (t > 0.f ? t : t * a.slope) * a.gain;
  }
}

// r *= the next conv's style for image b, channels c .. c + V - 1.
template <typename T, int V>
__device__ __forceinline__ void modulate(const DemodArgs<T>& a, int b, int c, float (&r)[V]) {
  float m[V];
  load_f32<V>(a.mod + b * a.ld_mod + c, m);
#pragma unroll
  for (int v = 0; v < V; ++v) r[v] *= m[v];
}

// The up layer's pass (kFir): item = ((b * ho / kFirRows + row block) * wo +
// ox) * vpp + channel vector; out = t * mod of the FIR of x (pads 1/1).
template <typename T, int V>
__device__ __forceinline__ void fir_pass(const DemodArgs<T>& a) {
  const unsigned stride = gridDim.x * kThreads, items = a.vectors / kFirRows;
  const int C = a.vpp * V, wo = a.wo, wi = wo + 1, ho = static_cast<int>(a.hw) / wo;
  const int hi = ho + 1, blocks = ho / kFirRows;
  for (unsigned it = blockIdx.x * kThreads + threadIdx.x; it < items; it += stride) {
    unsigned q = it / a.vpp;
    const int c = static_cast<int>(it - q * a.vpp) * V;
    const int ox = static_cast<int>(q % wo);
    q /= wo;
    const int oy0 = static_cast<int>(q % blocks) * kFirRows, b = static_cast<int>(q / blocks);
    const T* img = a.x + (long long)b * hi * wi * C + c;
    int col[4];
    float kx[4];
#pragma unroll
    for (int tx = 0; tx < 4; ++tx) {  // input columns ox - 1 .. ox + 2, zero outside
      const int ix = ox + tx - 1;
      col[tx] = min(max(ix, 0), wi - 1) * C;
      kx[tx] = (ix >= 0 && ix < wi) ? a.taps[3 - tx] : 0.f;
    }
    float h[kFirRows + 3][V];  // input rows oy0 - 1 .. oy0 + kFirRows + 1, filtered across
#pragma unroll
    for (int row = 0; row < kFirRows + 3; ++row) {
      const int iy = oy0 + row - 1;
      const T* src = img + (long long)min(max(iy, 0), hi - 1) * wi * C;
      const float ky = (iy >= 0 && iy < hi) ? 1.f : 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) h[row][v] = 0.f;
#pragma unroll
      for (int tx = 0; tx < 4; ++tx) {
        float in[V];
        load_vec<T, V>(src + col[tx], in);
#pragma unroll
        for (int v = 0; v < V; ++v) h[row][v] = fmaf(kx[tx] * ky, in[v], h[row][v]);
      }
    }
#pragma unroll
    for (int k = 0; k < kFirRows; ++k) {
      float r[V];
#pragma unroll
      for (int v = 0; v < V; ++v) r[v] = 0.f;
#pragma unroll
      for (int ty = 0; ty < 4; ++ty)
#pragma unroll
        for (int v = 0; v < V; ++v) r[v] = fmaf(a.taps[3 - ty], h[k + ty][v], r[v]);
      const unsigned p = (static_cast<unsigned>(b) * ho + oy0 + k) * wo + ox;
      activate<T, V>(a, b, c, a.noise[p], r);
      modulate<T, V>(a, b, c, r);
      store_vec<T, V>(a.out + (long long)p * C + c, r);
    }
  }
}

// The first group of a pixel's lanes adds the toRGB bias (lane 0) and
// upsample_2d of the previous RGB sum at output pixel (oy, ox) of image b:
// after zero insertion the 4 flipped taps meet two input rows (oy even: taps 3
// and 1 on rows oy/2 - 1 and oy/2; odd: taps 2 and 0 on (oy-1)/2 and (oy+1)/2)
// and two columns alike, zero outside. The 12 (tap, channel) products are
// spread over the group's lanes (lane k takes k, k + group, ...), so that no
// lane reads them one after another; the shuffles then sum them with toRGB.
template <typename T>
__device__ __forceinline__ void rgb_base(const DemodArgs<T>& a, int b, int oy, int ox, int k,
                                         int group, float (&part)[3]) {
  if (k == 0)
    for (int j = 0; j < 3; ++j) part[j] += a.rgb_bias[j];
  if (a.y_prev == nullptr) return;
  const int h = static_cast<int>(a.hw) / a.wo / 2, w = a.wo / 2;
  const int ry = oy / 2 - 1 + (oy & 1), rx = ox / 2 - 1 + (ox & 1);  // the first row and column
  const int ty = (oy & 1) ? 2 : 3, tx = (ox & 1) ? 2 : 3;  // their taps; the second's is 2 less
  for (int q = k; q < 12; q += group) {
    const int tap = q / 3, j = q - 3 * tap, dy = tap >> 1, dx = tap & 1;
    const int iy = ry + dy, ix = rx + dx;
    if (iy < 0 || iy >= h || ix < 0 || ix >= w) continue;
    const float add = a.taps[ty - 2 * dy] * a.taps[tx - 2 * dx]
                      * a.y_prev[((static_cast<long long>(b) * h + iy) * w + ix) * 3 + j];
    part[0] += j == 0 ? add : 0.f;
    part[1] += j == 1 ? add : 0.f;
    part[2] += j == 2 ? add : 0.f;
  }
}

// kFir: fir_pass. Else the toRGB pass: toRGB added into rgb, and with kMod
// t * mod written in place. It walks the vectors one a thread a step, a warp
// at a time, so that the lanes that hold one pixel's vectors meet in the
// shuffles (one step in flight measured faster than style_epilogue_kernel's
// kUnroll here: the shuffles and the toRGB loads hold registers).
template <typename T, int V, bool kFir, bool kMod>
__global__ void __launch_bounds__(kThreads) style_epilogue_demod_kernel(const DemodArgs<T> a) {
  if constexpr (kFir) {
    fir_pass<T, V>(a);
    return;
  }
  const long long stride = (long long)gridDim.x * kThreads;
  const int lane = threadIdx.x % 32, C = a.vpp * V;
  // lanes that share a pixel within a warp (a pixel's vectors are consecutive and
  // start at a multiple of vpp: aligned to a warp when vpp divides 32); when they
  // hold the whole pixel its sum is stored, else added atomically
  const int group = (32 % a.vpp == 0) ? a.vpp : (a.vpp % 32 == 0 ? 32 : 1);
  for (long long base = (long long)blockIdx.x * kThreads + threadIdx.x - lane; base < a.vectors;
       base += stride) {
    const long long i = base + lane;
    float part[3] = {0.f, 0.f, 0.f};
    unsigned px = 0;
    int c = 0;
    if (i < a.vectors) {
      px = static_cast<unsigned>(i) / a.vpp;
      c = static_cast<int>(static_cast<unsigned>(i) - px * a.vpp) * V;
      const int b = static_cast<int>(px / a.hw);
      float r[V];
      load_vec<T, V>(a.x + i * V, r);
      activate<T, V>(a, b, c, a.noise[px], r);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float w[V];
        load_f32<V>(a.rgb_w + (b * 3 + j) * C + c, w);
#pragma unroll
        for (int v = 0; v < V; ++v) part[j] = fmaf(r[v], w[v], part[j]);
      }
      if (c < group * V) {  // the pixel's first group
        const int rem = static_cast<int>(px - static_cast<unsigned>(b) * a.hw);
        rgb_base(a, b, rem / a.wo, rem % a.wo, c / V, group, part);
      }
      if constexpr (kMod) {
        modulate<T, V>(a, b, c, r);
        store_vec<T, V>(a.x + i * V, r);
      }
    }
    for (int off = group / 2; off > 0; off /= 2)
#pragma unroll
      for (int j = 0; j < 3; ++j) part[j] += __shfl_xor_sync(0xffffffffu, part[j], off);
    if (i < a.vectors && lane % group == 0) {
      float* dst = a.rgb + static_cast<long long>(px) * 3;
      if (group == a.vpp) {
        for (int j = 0; j < 3; ++j) dst[j] = part[j];
      } else {
        for (int j = 0; j < 3; ++j) atomicAdd(dst + j, part[j]);
      }
    }
  }
}

bool plan_ok(long long elems, int C, int width, int grid) {
  return elems > 0 && C > 0 && elems % C == 0 && C % width == 0 && grid > 0;
}

template <typename T>
cudaError_t epilogue(void* x, const void* noise, const void* strength, const void* bias,
                     long long elems, int C, float slope, int vec, int grid,
                     cudaStream_t stream) {
  constexpr int W = 16 / sizeof(T);
  const int width = vec ? W : 1;
  if (!plan_ok(elems, C, width, grid)) return cudaErrorInvalidValue;
  const EpilogueArgs<T> a{static_cast<T*>(x), static_cast<const float*>(noise),
                          static_cast<const T*>(strength), static_cast<const T*>(bias),
                          elems / width, C / width, slope};
  if (vec) style_epilogue_kernel<T, W><<<grid, kThreads, 0, stream>>>(a);
  else style_epilogue_kernel<T, 1><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for x, strength and bias; noise is
// float32. elems = B*H*W*C. vec and grid are the launch plan
// (cuda_kernels.py::style_epilogue_plan). Returns the launch's cudaError_t;
// cudaErrorInvalidValue for a plan this file cannot run.
extern "C" int s2p_style_epilogue(void* x, const void* noise, const void* strength,
                                  const void* bias, long long elems, int C, float slope,
                                  int dtype, int vec, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return epilogue<float>(x, noise, strength, bias, elems, C, slope, vec, grid, s);
  if (dtype == 1)
    return epilogue<__nv_bfloat16>(x, noise, strength, bias, elems, C, slope, vec, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

namespace {

template <typename T>
cudaError_t epilogue_stats(void* x, const void* noise, const void* strength, const void* bias,
                           void* part, int batch, int hw, int C, int parts, float slope, int vec,
                           cudaStream_t stream) {
  constexpr int W = 16 / sizeof(T);
  const int width = vec ? W : 1;
  if (batch <= 0 || batch > 65535 || hw <= 0 || C <= 0 || C % width != 0 || parts <= 0)
    return cudaErrorInvalidValue;
  const int vpp = C / width, ppc = (hw + parts - 1) / parts;
  if (vpp > kThreads || kThreads % vpp != 0 || (long long)(parts - 1) * ppc >= hw)
    return cudaErrorInvalidValue;  // a thread's channels change, or a part is empty
  const StatsArgs<T> a{static_cast<T*>(x), static_cast<const float*>(noise),
                       static_cast<const T*>(strength), static_cast<const T*>(bias),
                       static_cast<float*>(part), hw, ppc, vpp, slope};
  const dim3 grid(parts, batch);
  if (vec) style_epilogue_kernel_stats<T, W><<<grid, kThreads, 0, stream>>>(a);
  else style_epilogue_kernel_stats<T, 1><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The statistics variant: x [batch, hw, C] as above, and part (f32 [batch,
// parts, 3, C], written whole) the slots of each CTA's range of ceil(hw /
// parts) pixels: the shift, the mean offset and M2 of the values stored. vec
// and parts are the plan (cuda_kernels.py::style_stats_plan): C / V must divide
// the block and no range may be empty. Returns the launch's cudaError_t.
extern "C" int s2p_style_epilogue_stats(void* x, const void* noise, const void* strength,
                                        const void* bias, void* part, int batch, int hw, int C,
                                        int parts, float slope, int dtype, int vec,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return epilogue_stats<float>(x, noise, strength, bias, part, batch, hw, C, parts, slope,
                                 vec, s);
  if (dtype == 1)
    return epilogue_stats<__nv_bfloat16>(x, noise, strength, bias, part, batch, hw, C, parts,
                                         slope, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

namespace {

template <typename T, int V>
void launch_demod(const DemodArgs<T>& a, bool fir, int grid, cudaStream_t stream) {
  if (fir)
    style_epilogue_demod_kernel<T, V, true, true><<<grid, kThreads, 0, stream>>>(a);
  else if (a.mod != nullptr)
    style_epilogue_demod_kernel<T, V, false, true><<<grid, kThreads, 0, stream>>>(a);
  else
    style_epilogue_demod_kernel<T, V, false, false><<<grid, kThreads, 0, stream>>>(a);
}

template <typename T>
cudaError_t epilogue_demod(void* x, void* out, const void* noise, const void* strength,
                           const void* bias, const void* demod, const void* mod,
                           const void* rgb_w, void* rgb, const void* y_prev,
                           const float* rgb_bias, long long elems, int C, long long hw, int wo,
                           int ld_demod, int ld_mod, float slope, float gain, const float* taps,
                           int vec, int grid, cudaStream_t stream) {
  constexpr int W = 16 / sizeof(T);
  const int width = vec ? W : 1;
  const bool fir = out != nullptr;
  if (!plan_ok(elems, C, width, grid) || elems / width >= (1LL << 31) || hw <= 0
      || (elems / C) % hw != 0 || ld_demod < C
      || (mod != nullptr && ld_mod < C) || wo <= 0 || hw % wo != 0
      || taps == nullptr || fir == (rgb != nullptr)
      || (fir && (mod == nullptr || (hw / wo) % kFirRows))
      || (!fir && (rgb_w == nullptr || rgb_bias == nullptr))
      || (y_prev != nullptr && (fir || (hw / wo) % 2 || wo % 2))
      || (vec && (ld_demod % 4 != 0 || (mod != nullptr && ld_mod % 4 != 0))))
    return cudaErrorInvalidValue;
  DemodArgs<T> a{static_cast<T*>(x), static_cast<T*>(out), static_cast<const float*>(noise),
                 static_cast<const T*>(strength), static_cast<const T*>(bias),
                 static_cast<const float*>(demod), static_cast<const float*>(mod),
                 static_cast<const float*>(rgb_w), static_cast<float*>(rgb),
                 static_cast<const float*>(y_prev), static_cast<unsigned>(elems / width),
                 static_cast<unsigned>(hw), C / width, ld_demod, ld_mod, slope, gain, wo,
                 {0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  for (int k = 0; taps != nullptr && k < 4; ++k) a.taps[k] = taps[k];
  for (int j = 0; rgb_bias != nullptr && j < 3; ++j) a.rgb_bias[j] = rgb_bias[j];
  if (vec) launch_demod<T, W>(a, fir, grid, stream);
  else launch_demod<T, 1>(a, fir, grid, stream);
  return cudaGetLastError();
}

}  // namespace

// StyleGAN2's variant. dtype as above for x, out, strength and bias; noise,
// demod, mod, rgb_w, rgb and y_prev are float32; taps and rgb_bias are host
// arrays of 4 and 3 floats. elems and hw count the output's values and pixels
// an image, wo is its width; ld_demod and ld_mod are the row strides of demod
// and mod in values. Exactly one of out and rgb is given. With out (the FIR
// pass): x is the transposed conv's output [B, hw/wo + 1, wo + 1, C] (hw/wo a
// multiple of kFirRows) and mod is required. With rgb (the toRGB pass): rgb_w
// and rgb_bias are required, y_prev is the previous RGB sum or null, and mod
// null for the last layer (x is then not written). vec and grid are the plan
// (cuda_kernels.py::style_epilogue_plan; the vector path also needs demod,
// mod and rgb_w 16-byte aligned and the row strides multiples of 4).
extern "C" int s2p_style_epilogue_demod(void* x, void* out, const void* noise,
                                        const void* strength, const void* bias,
                                        const void* demod, const void* mod, const void* rgb_w,
                                        void* rgb, const void* y_prev, const float* rgb_bias,
                                        long long elems, int C, long long hw, int wo,
                                        int ld_demod, int ld_mod, float slope, float gain,
                                        const float* taps, int dtype, int vec, int grid,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return epilogue_demod<float>(x, out, noise, strength, bias, demod, mod, rgb_w, rgb, y_prev,
                                 rgb_bias, elems, C, hw, wo, ld_demod, ld_mod, slope, gain, taps,
                                 vec, grid, s);
  if (dtype == 1)
    return epilogue_demod<__nv_bfloat16>(x, out, noise, strength, bias, demod, mod, rgb_w, rgb,
                                         y_prev, rgb_bias, elems, C, hw, wo, ld_demod, ld_mod,
                                         slope, gain, taps, vec, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
