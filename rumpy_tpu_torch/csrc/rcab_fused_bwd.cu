// Fused RCAB backward for Hopper (sm_90a), bound to Python over ctypes.
//
// The gradient of rcab_fused.cu's forward. The Pallas TPU kernel it
// replaces (rumpy_tpu/ops/pallas/rcab_fused.py::rcab_fused) is forward
// only; the yardstick is the gradient of its plain twin, rcab_reference.
// With the forward
//
//   h1  = round_T(relu(conv3x3(x, w1) + b1))
//   h2  = conv3x3(h1, w2) + b2
//   u   = sigmoid(relu(GAP(h2) . wd + bd) . wu + bu)
//   out = round_T(h2 * u * res_scale + x)
//
// and g = dout * res_scale, the backward computes, all sums in f32,
//
//   du[n,c] = sum_hw g * h2          -> through the gate to dgap, dwd, dbd,
//                                       dwu, dbu (tiny, per image)
//   dh2 = g * u + dgap / (H*W)
//   dh1 = round_T(conv3x3^T(dh2, w2) * [h1 > 0])   the rounding of h1 is
//                                                  treated as the identity
//   dx  = round_T(conv3x3^T(dh1, w1) + dout)
//   dw2[t] = h1(shifted by tap t)^T . dh2,  db2 = sum dh2
//   dw1[t] = x(shifted by tap t)^T . dh1,   db1 = sum dh1
//
// h2 and u come from the forward's workspace; h1 is recomputed from x.
//
// dh2 = g * u + c with c[n] = dgap / (H*W) a constant over the image. The
// tensor-core plan feeds only round_bf16(g * u) to its two products with dh2
// (conv2's transposed conv, dw2) and adds c's share exactly in f32: c is
// below half a bf16 ulp of g * u wherever H*W is large, so rounding the sum
// would drop it, and with it most of db1 and dw2 on a whole image. Its share
// of dh1 at pixel q is the sum over the taps t whose source pixel q - t lies
// in the image of W2[t] . c[n]; that depends only on whether q lies on the
// first, last or an inner row and column, so the gate kernel tabulates it as
// 9 classes x C an image (ctab). Its share of dw2[t] is (the sum of h1 over
// the pixels q with q - t in the image) x c[n]; the weight-gradient pass sums
// h1 by the same 9 classes from the tiles it holds and adds the product to
// its split's partial. db2 sums dh2 before any rounding. The CUDA-core plan
// holds dh2 in f32 in its tiles (bf16 ones too, at the widths off the tensor
// cores), so c stays in it exactly and that plan needs no split.
//
// Per-example gate inputs (a QRCAB: bd[n], bu[n] and a channel scale
// s[n, c] in place of res_scale; rcab_fused.cu): the gate kernel reads
// bd[n * bd_stride + j], takes du = s[n,c] * sum_hw dout * h2, writes
// dscale[n,c] = u * sum_hw dout * h2 and an effective gate u * s[n,c] that
// the passes after it read with res_scale 1 (dh2 = dout * (u * s) + dgap /
// HW); dbd and dbu stay per image (the ReLU's and the sigmoid's input
// gradients, dz and ds) where bd and bu were.
//
// Bound on an H100 SXM: five convolutions' worth of products (conv1 again,
// two data gradients, two weight gradients: 13.6 GFLOP at 16x48x48x64;
// four, 10.9 GFLOP, for a backward that kept h1 instead) against x, dout,
// dx and the saved h2 (24 MB): bound by operations, 0.0137 ms in bf16 at
// 989 TFLOP/s and 0.203 ms in f32 at 67. The tensor-core plan takes 0.13 ms
// there, a tenth of that rate (PERF.md has the passes' times).
//
// Two plans, chosen by type and width in make_plan (as the forward's):
// bf16 with C in {16, 32, 64, 128} runs every heavy product on the tensor
// cores (mma.sync m16n8k16, bf16 operands, f32 accumulation); f32, and
// other C, run them on the CUDA cores in f32. Both launch on one stream
// and take every reduction in a fixed order (no float atomics, so a step
// is reproducible run to run).
//
// Tensor-core plan, six launches:
//   1. rcab_bwd_du_kernel: per-chunk sums of dout * h2; rcab_bwd_gate_kernel,
//      one block an image: du, the gate's backward, dgap, and ctab.
//   2. rcab_bwd_dh1_mma_kernel, one block per (tile, image): conv1 again on
//      the x tile -> h1, rounded to bf16, staged in shared memory and written
//      out 16 bytes a thread for pass 4, its sign kept as 64 bits a thread
//      in the C-fragment layout; then g * u built as bf16 in shared memory
//      from dout and u (dh2_part: rounded once, and pass 4 rebuilds the same
//      bits, so conv2^T and dw2 see one operand), the transposed conv2, the
//      pixel's ctab row added in f32, and the ReLU mask -> dh1. Both convs are
//      conv3x3_mma: a tap
//      of weights comes through cp.async under the mma of the tap before,
//      and a transposed conv reads tap 8 - t as it lies with ldmatrix without
//      .trans, so there is no flipped copy. Tiles are 16x16 (two m-tiles a
//      warp share each B fragment) where that leaves a block for every SM,
//      else 8x16.
//   3. rcab_bwd_dx_mma_kernel: transposed conv1 of the dh1 tile, plus the
//      dout tile that a cp.async brought in meanwhile.
//   4. rcab_bwd_wgrad_mma_kernel, both convs in one launch, one block per
//      (split of the tiles, conv, 64x64 block of the weight) and one block
//      an SM: dw[t][ci][co] = sum_p a[p + t][ci] * g[p][co] is per tap a
//      (C x pixels) . (pixels x C) product with the pixel axis as K. The a
//      tile (1-pixel halo, zero outside the image, so borders need no mask)
//      and the g tile sit in shared memory as [pixel][C + 8]; both operands
//      are K-major there and come through ldmatrix.trans, every lane with
//      its own pixel's row address. A block owns all 9 taps (144
//      accumulators a thread at C = 64), loads each tile once, walks its
//      tiles in order with the next two tiles' cp.async loads in flight,
//      sums the bias gradient from the same g tile (db2 from dh2 before its
//      rounding: the rounding errors of dout * u + c do not average out over
//      an image, because dout takes few distinct bf16 values), for conv2
//      sums h1 by pixel class and adds c's share to its accumulators each
//      time its walk leaves an image, and writes one partial.
//   5. rcab_bwd_finish_kernel adds the splits in order into dw1, dw2, db1,
//      db2 and the images' terms into dwd, dbd, dwu, dbu.
// The weight gradients are not folded into passes 2 and 3, though those hold
// the tiles: a block's dw would have to leave as a 9CC partial per tile (42
// MB a call at 16x48x48x64, written and read again), more than pass 4 moves.
//
// CUDA-core plan: rcab_bwd_flip_kernel (w^T with flipped taps, so a
// transposed conv is conv3x3_smem on other weights), the same du and gate
// kernels, rcab_bwd_dh1_kernel and rcab_bwd_dx_kernel on conv3x3_smem,
// rcab_bwd_wgrad_kernel once per conv (one block per split of the pixels,
// tap and 64x64 block of the weight, 8x8 outputs a thread), then the same
// finish kernel.

#include <initializer_list>
#include <type_traits>

#include "rcab_common.cuh"

namespace {

constexpr int kDuPixels = 128;  // pixels per block of the dout * h2 sums
constexpr int kWK = 32;         // pixels of the weight gradient staged at once
constexpr int kWB = 64;         // weight-gradient block: kWB x kWB outputs
constexpr int kMaxSplits = 64;

template <typename T>
__device__ __forceinline__ void store8(T* dst, const float (&v)[kCM]);
template <>
__device__ __forceinline__ void store8<float>(float* dst, const float (&v)[kCM]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
template <>
__device__ __forceinline__ void store8<__nv_bfloat16>(__nv_bfloat16* dst,
                                                      const float (&v)[kCM]) {
  unsigned bits[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    bits[i] = *reinterpret_cast<const unsigned*>(&p);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(bits[0], bits[1], bits[2], bits[3]);
}

// wt[t][a][b] = w[8 - t][b][a] for both convs.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rcab_bwd_flip_kernel(const T* __restrict__ w1, const T* __restrict__ w2,
                     T* __restrict__ w1t, T* __restrict__ w2t, int C) {
  const int total = 9 * C * C;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < total; i += gridDim.x * kThreads) {
    const int t = i / (C * C);
    const int r = i - t * C * C;
    const int a = r / C, b = r - a * C;
    const size_t src = ((size_t)(8 - t) * C + b) * C + a;
    w1t[i] = w1[src];
    w2t[i] = w2[src];
  }
}

// Eight channels as f32.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x, v[2 * k + 1] = f.y;
  }
}

// part[n][j][c] = sum over the j-th chunk of kDuPixels pixels of image n of
// dout * h2: a thread takes 8 channels of every L-th pixel, 16 and 32 bytes
// a load, and the L lanes are added in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rcab_bwd_du_kernel(const T* __restrict__ dout, const float* __restrict__ h2,
                   float* __restrict__ part, int HW, int C, int J) {
  extern __shared__ float dsm[];  // L * C
  const int n = blockIdx.y, j = blockIdx.x;
  const int CH = C / 8;
  const int L = CH < kThreads ? kThreads / CH : 1;
  const int p0 = j * kDuPixels;
  const int p1 = p0 + kDuPixels < HW ? p0 + kDuPixels : HW;
  const size_t img = (size_t)n * HW * C;
  for (int i = threadIdx.x; i < L * CH; i += kThreads) {
    const int lane = i / CH, c8 = (i - lane * CH) * 8;
    float s[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = 0.f;
#pragma unroll 4
    for (int p = p0 + lane; p < p1; p += L) {
      const size_t o = img + (size_t)p * C + c8;
      float dv[8], hv[8];
      load8(dout + o, dv);
      load8(h2 + o, hv);
#pragma unroll
      for (int k = 0; k < 8; ++k) s[k] = fmaf(dv[k], hv[k], s[k]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) dsm[lane * C + c8 + k] = s[k];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f;
    for (int l = 0; l < L; ++l) s += dsm[l * C + c];
    part[((size_t)n * J + j) * C + c] = s;
  }
}

// p[q * C] + p[(q + Q) * C] + ... below p[count * C], added in that order,
// 8 loads in flight.
__device__ __forceinline__ float strided_sum(const float* __restrict__ p, int q, int count,
                                             int Q, int C) {
  float s = 0.f;
  int t = q;
  for (; t + 7 * Q < count; t += 8 * Q) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = p[(size_t)(t + k * Q) * C];
#pragma unroll
    for (int k = 0; k < 8; ++k) s += v[k];
  }
  for (; t < count; t += Q) s += p[(size_t)t * C];
  return s;
}

// A pixel's class along one axis: 0 on the first row (column), 2 on the last,
// 1 between (an axis of extent 1 has class 0 only).
__device__ __forceinline__ int edge_class(int i, int extent) {
  return i == 0 ? 0 : (i == extent - 1 ? 2 : 1);
}

// Whether tap row (column) k of a 3x3 conv, offset k - 1, reaches from a
// pixel of class `cls` along an axis of `extent` to a source pixel inside
// it: offset -1 needs a pixel below (not the last row), +1 one above.
__device__ __forceinline__ bool tap_valid(int cls, int k, int extent) {
  if (k == 1) return true;
  if (k == 0) return cls == 1 || (cls == 0 && extent > 1);
  return cls != 0;
}

// One block per image: du from the chunk sums, GAP from the forward's tile
// sums, the C -> R -> C gate backwards. Each channel's tiles and chunks are
// split over Q threads (q, q+Q, ...) and the Q sums added in order. Leaves
// dgap / HW, ds (gradient at the sigmoid's input), gap, dz (gradient at the
// ReLU's input) and d (the ReLU's output) per image for the passes that
// follow. With a per-example scale it also writes dscale and the effective
// gate u * scale (see the top of the file). With w2 (the tensor-core plan)
// it also writes ctab[n][3 * row class + column class][ci], the sum over
// the taps t valid for that class of sum_co w2[t][ci][co] * dgap[n][co] / HW.
__global__ void __launch_bounds__(kThreads)
rcab_bwd_gate_kernel(const float* __restrict__ part_du, const float* __restrict__ fwd_partial,
                     const float* __restrict__ gate, const float* __restrict__ wd,
                     const float* __restrict__ bd, int bd_stride, const float* __restrict__ wu,
                     float res_scale, const float* __restrict__ scale,
                     float* __restrict__ dscale, float* __restrict__ gate_eff,
                     float* __restrict__ dgap_hw, float* __restrict__ ds_out,
                     float* __restrict__ gap_out, float* __restrict__ dz_out,
                     float* __restrict__ d_out, const __nv_bfloat16* __restrict__ w2,
                     float* __restrict__ ctab, int J, int n_tiles, int H, int W, int C, int R) {
  const int HW = H * W;
  extern __shared__ float gsm[];
  float* gap = gsm;     // C
  float* ds = gap + C;  // C
  float* d = ds + C;    // R
  float* dz = d + R;    // R
  const int Q = C < kThreads ? kThreads / C : 1;
  float* tile_sums = dz + R;            // Q * C
  float* du_sums = tile_sums + Q * C;   // Q * C
  float* wd_s = du_sums + Q * C;        // C * R
  float* wu_s = wd_s + C * R;           // R * C
  const int n = blockIdx.x;
  for (int i = threadIdx.x; i < C * R; i += kThreads) {
    wd_s[i] = wd[i];
    wu_s[i] = wu[i];
  }
  for (int i = threadIdx.x; i < Q * C; i += kThreads) {
    const int c = i % C, q = i / C;
    tile_sums[i] = strided_sum(fwd_partial + (size_t)n * n_tiles * C + c, q, n_tiles, Q, C);
    du_sums[i] = strided_sum(part_du + (size_t)n * J * C + c, q, J, Q, C);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f, du = 0.f;
    for (int q = 0; q < Q; ++q) {
      s += tile_sums[q * C + c];
      du += du_sums[q * C + c];
    }
    gap[c] = s / (float)HW;
    const float u = gate[(size_t)n * C + c];
    if (scale) {
      const float sc = scale[(size_t)n * C + c];
      dscale[(size_t)n * C + c] = du * u;
      gate_eff[(size_t)n * C + c] = u * sc;
      du *= sc;
    } else {
      du *= res_scale;
    }
    ds[c] = du * u * (1.f - u);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < R; j += kThreads) {
    float z = 0.f, dd = 0.f;
    for (int c = 0; c < C; ++c) {
      z = fmaf(gap[c], wd_s[c * R + j], z);
      dd = fmaf(ds[c], wu_s[j * C + c], dd);
    }
    z += bd[(size_t)n * bd_stride + j];
    d[j] = fmaxf(z, 0.f);
    dz[j] = z > 0.f ? dd : 0.f;
  }
  __syncthreads();
  float* cvec = wu_s + R * C;  // C: dgap / HW, with w2 only
  float* taps = cvec + C;      // 9 * C: sum_co w2[t][ci][co] * cvec[co]
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f;
    for (int j = 0; j < R; ++j) s = fmaf(dz[j], wd_s[c * R + j], s);
    dgap_hw[(size_t)n * C + c] = s / (float)HW;
    if (w2) cvec[c] = s / (float)HW;
    ds_out[(size_t)n * C + c] = ds[c];
    gap_out[(size_t)n * C + c] = gap[c];
  }
  for (int j = threadIdx.x; j < R; j += kThreads) {
    dz_out[(size_t)n * R + j] = dz[j];
    d_out[(size_t)n * R + j] = d[j];
  }
  if (!w2) return;  // block-uniform
  __syncthreads();
  for (int i = threadIdx.x; i < 9 * C; i += kThreads) {  // i = t * C + ci
    const __nv_bfloat16* row = w2 + (size_t)i * C;
    float v = 0.f;
    for (int co = 0; co < C; co += 8) {
      float w8[8];
      load8(row + co, w8);
#pragma unroll
      for (int k = 0; k < 8; ++k) v = fmaf(w8[k], cvec[co + k], v);
    }
    taps[i] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 9 * C; i += kThreads) {  // i = class * C + ci
    const int cls = i / C, ci = i - cls * C;
    float v = 0.f;
#pragma unroll
    for (int t = 0; t < 9; ++t)
      if (tap_valid(cls / 3, t / 3, H) && tap_valid(cls % 3, t % 3, W)) v += taps[t * C + ci];
    ctab[(size_t)n * 9 * C + i] = v;
  }
}

// CUDA-core plan, dh1 pass: h1 again, then dh1 = conv^T(dh2, w2) * [h1 > 0] on a TH x TW tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rcab_bwd_dh1_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                    const float* __restrict__ b1, const T* __restrict__ w2t,
                    const T* __restrict__ dout, const float* __restrict__ gate,
                    const float* __restrict__ dgap_hw, float res_scale, T* __restrict__ h1,
                    T* __restrict__ dh1, int H, int W, int C, int TH, int TW) {
  extern __shared__ __align__(16) float smem[];
  const int SP = C + 1;  // odd pixel stride: neighbouring pixels on distinct banks
  float* w_s = smem;                // 9 * kKC * C
  float* t_s = smem + 9 * kKC * C;  // (TH+2) * (TW+2) * SP: x, then dh2
  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  const int XH = TH + 2, XW = TW + 2;
  const size_t img = (size_t)n * H * W * C;

  // x tile with a 1-pixel halo, zero outside the image
  for (int i = threadIdx.x; i < XH * XW * C; i += kThreads) {
    const int p = i / C, c = i - p * C;
    const int gy = ty0 - 1 + p / XW, gx = tx0 - 1 + p % XW;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = to_f(x[img + ((size_t)gy * W + gx) * C + c]);
    t_s[p * SP + c] = v;
  }

  float acc[kMaxIt][kPM][kCM];
  conv3x3_smem<T>(t_s, XW, TH, TW, C, SP, w1, w_s, acc);
  const int P = TH * TW;
  const int G = (P + kPM - 1) / kPM;
  const int n_items = G * (C / kCM);
  unsigned positive[kMaxIt];  // bit k * kCM + j: h1 > 0
#pragma unroll
  for (int it = 0; it < kMaxIt; ++it) {
    positive[it] = 0u;
    const int item = it * kThreads + threadIdx.x;
    if (item >= n_items) continue;
    const int g = item % G;
    const int c0 = (item / G) * kCM;
#pragma unroll
    for (int k = 0; k < kPM; ++k) {
      const int p = g + G * k;
      if (p >= P) continue;
      const int gy = ty0 + p / TW, gx = tx0 + p % TW;
      if (gy >= H || gx >= W) continue;
      float v[kCM];
#pragma unroll
      for (int j = 0; j < kCM; ++j) {
        // rounded to T, as the forward does before conv2
        v[j] = to_f(from_f<T>(fmaxf(acc[it][k][j] + b1[c0 + j], 0.f)));
        if (v[j] > 0.f) positive[it] |= 1u << (k * kCM + j);
      }
      store8<T>(h1 + img + ((size_t)gy * W + gx) * C + c0, v);
    }
  }
  __syncthreads();  // every thread has finished reading the x tile

  // dh2 tile with a 1-pixel halo, zero outside the image
  for (int i = threadIdx.x; i < XH * XW * C; i += kThreads) {
    const int p = i / C, c = i - p * C;
    const int gy = ty0 - 1 + p / XW, gx = tx0 - 1 + p % XW;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = to_f(dout[img + ((size_t)gy * W + gx) * C + c]) * res_scale * gate[(size_t)n * C + c] +
          dgap_hw[(size_t)n * C + c];
    t_s[p * SP + c] = v;
  }
  conv3x3_smem<T>(t_s, XW, TH, TW, C, SP, w2t, w_s, acc);  // its first barrier publishes dh2
#pragma unroll
  for (int it = 0; it < kMaxIt; ++it) {
    const int item = it * kThreads + threadIdx.x;
    if (item >= n_items) continue;
    const int g = item % G;
    const int c0 = (item / G) * kCM;
#pragma unroll
    for (int k = 0; k < kPM; ++k) {
      const int p = g + G * k;
      if (p >= P) continue;
      const int gy = ty0 + p / TW, gx = tx0 + p % TW;
      if (gy >= H || gx >= W) continue;
      float v[kCM];
#pragma unroll
      for (int j = 0; j < kCM; ++j)
        v[j] = (positive[it] >> (k * kCM + j)) & 1u ? acc[it][k][j] : 0.f;
      store8<T>(dh1 + img + ((size_t)gy * W + gx) * C + c0, v);
    }
  }
}

// CUDA-core plan, dx pass: dx = conv^T(dh1, w1) + dout on a TH x TW tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rcab_bwd_dx_kernel(const T* __restrict__ dh1, const T* __restrict__ w1t,
                   const T* __restrict__ dout, T* __restrict__ dx, int H, int W, int C,
                   int TH, int TW) {
  extern __shared__ __align__(16) float smem[];
  const int SP = C + 1;
  float* w_s = smem;
  float* t_s = smem + 9 * kKC * C;
  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  const int XH = TH + 2, XW = TW + 2;
  const size_t img = (size_t)n * H * W * C;
  for (int i = threadIdx.x; i < XH * XW * C; i += kThreads) {
    const int p = i / C, c = i - p * C;
    const int gy = ty0 - 1 + p / XW, gx = tx0 - 1 + p % XW;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = to_f(dh1[img + ((size_t)gy * W + gx) * C + c]);
    t_s[p * SP + c] = v;
  }
  float acc[kMaxIt][kPM][kCM];
  conv3x3_smem<T>(t_s, XW, TH, TW, C, SP, w1t, w_s, acc);
  const int P = TH * TW;
  const int G = (P + kPM - 1) / kPM;
  const int n_items = G * (C / kCM);
#pragma unroll
  for (int it = 0; it < kMaxIt; ++it) {
    const int item = it * kThreads + threadIdx.x;
    if (item >= n_items) continue;
    const int g = item % G;
    const int c0 = (item / G) * kCM;
#pragma unroll
    for (int k = 0; k < kPM; ++k) {
      const int p = g + G * k;
      if (p >= P) continue;
      const int gy = ty0 + p / TW, gx = tx0 + p % TW;
      if (gy >= H || gx >= W) continue;
      const size_t o = img + ((size_t)gy * W + gx) * C + c0;
      float v[kCM];
#pragma unroll
      for (int j = 0; j < kCM; ++j) v[j] = acc[it][k][j] + to_f(dout[o + j]);
      store8<T>(dx + o, v);
    }
  }
}

// CUDA-core plan, weight gradient of one conv. Block (s, t, b): pixels
// [s * chunk, (s+1) * chunk) of the N*H*W, tap t, the kWB x kWB block
// (b / nb, b % nb) of the C x C matrix:
//   part_w[s][t][ci][co] = sum_p a[p shifted by tap t][ci] * g[p][co]
// where g is dh1 as stored, or (DH2) dh2 built from dout, the gate and
// dgap. Threads form four slices of 64; slice q takes pixels q, q+4, ...
// of each staged group, thread (ty, tx) of a slice the rows {4ty..4ty+3,
// 32+4ty..} and columns {4tx..4tx+3, 32+4tx..}. The slices are added in
// order at the end. The block of tap 4 and row block 0 also sums g over
// its pixels into part_b[s][co].
template <typename T, bool DH2>
__global__ void __launch_bounds__(kThreads)
rcab_bwd_wgrad_kernel(const T* __restrict__ a, const T* __restrict__ g,
                      const float* __restrict__ gate, const float* __restrict__ dgap_hw,
                      float res_scale, float* __restrict__ part_w, float* __restrict__ part_b,
                      int N, int H, int W, int C, int chunk) {
  __shared__ __align__(16) float stage[2 * kWK * kWB];
  __shared__ float b_s[kWB];
  float* a_s = stage;
  float* g_s = stage + kWK * kWB;
  const int s = blockIdx.x, t = blockIdx.y;
  const int nb = (C + kWB - 1) / kWB;
  const int cib = blockIdx.z / nb, cob = blockIdx.z % nb;
  const int dy = t / 3 - 1, dxx = t % 3 - 1;
  const int HW = H * W;
  const long long total = (long long)N * HW;
  const long long k_begin = (long long)s * chunk;
  const long long k_end = k_begin + chunk < total ? k_begin + chunk : total;
  const int tid = threadIdx.x;
  const int slice = tid / 64, l = tid % 64;
  const int ty = l / 8, tx = l % 8;
  const bool bias = t == 4 && cib == 0 && ty == 0;
  const int lc = tid % kWB;  // the channel this thread stages
  const int ci_l = cib * kWB + lc, co_l = cob * kWB + lc;

  float acc[8][8];
  float bs[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    bs[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  for (long long k0 = k_begin; k0 < k_end; k0 += kWK) {
    __syncthreads();
    for (int kk = tid / kWB; kk < kWK; kk += kThreads / kWB) {
      const long long k = k0 + kk;
      float av = 0.f, gv = 0.f;
      if (k < k_end) {
        const int n = (int)(k / HW);
        const int r = (int)(k - (long long)n * HW);
        const int y = r / W, xx = r - y * W;
        const int ya = y + dy, xa = xx + dxx;
        if (ci_l < C && ya >= 0 && ya < H && xa >= 0 && xa < W)
          av = to_f(a[(((size_t)n * H + ya) * W + xa) * C + ci_l]);
        if (co_l < C) {
          gv = to_f(g[(size_t)k * C + co_l]);
          if (DH2) gv = gv * res_scale * gate[(size_t)n * C + co_l] + dgap_hw[(size_t)n * C + co_l];
        }
      }
      a_s[kk * kWB + lc] = av;
      g_s[kk * kWB + lc] = gv;
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = slice; kk < kWK; kk += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(a_s + kk * kWB + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(a_s + kk * kWB + 32 + ty * 4);
      const float4 g0 = *reinterpret_cast<const float4*>(g_s + kk * kWB + tx * 4);
      const float4 g1 = *reinterpret_cast<const float4*>(g_s + kk * kWB + 32 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], gv[j], acc[i][j]);
      }
      if (bias) {
#pragma unroll
        for (int j = 0; j < 8; ++j) bs[j] += gv[j];
      }
    }
  }

  // add slices 1..3 to slice 0, in order, through shared memory
  for (int q = 1; q < 4; ++q) {
    __syncthreads();
    if (slice == q) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) stage[(i * 8 + j) * 64 + l] = acc[i][j];
      }
      if (bias) {
#pragma unroll
        for (int j = 0; j < 8; ++j) b_s[j * 8 + tx] = bs[j];
      }
    }
    __syncthreads();
    if (slice == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += stage[(i * 8 + j) * 64 + l];
      }
      if (bias) {
#pragma unroll
        for (int j = 0; j < 8; ++j) bs[j] += b_s[j * 8 + tx];
      }
    }
  }
  if (slice != 0) return;
  float* pw = part_w + ((size_t)s * 9 + t) * C * C;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ci = cib * kWB + (i < 4 ? ty * 4 + i : 32 + ty * 4 + i - 4);
    if (ci >= C) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = cob * kWB + (j < 4 ? tx * 4 + j : 32 + tx * 4 + j - 4);
      if (co < C) pw[(size_t)ci * C + co] = acc[i][j];
    }
  }
  if (bias) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = cob * kWB + (j < 4 ? tx * 4 + j : 32 + tx * 4 + j - 4);
      if (co < C) part_b[(size_t)s * C + co] = bs[j];
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core plan (bf16, C in {16, 32, 64, 128}).
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// The rounded part of dh2, g * u, as every pass that needs it computes it:
// the same f32 operations in the same order, then one rounding to bf16.
__device__ __forceinline__ float dh2_part(float dout, float res_scale, float gate) {
  return __fmul_rn(__fmul_rn(dout, res_scale), gate);
}

// Eight channels of dout -> eight of round_bf16(g * u); `sum`, where given,
// gains the eight values of the whole dh2, g * u + dgap_hw, in f32.
__device__ __forceinline__ uint4 dh2_chunk(uint4 d, float res_scale, const float (&gate)[8],
                                           float* sum = nullptr, const float* dgap_hw = nullptr) {
  const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&d);
  uint4 r;
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(in[i]);
    const float v0 = dh2_part(f.x, res_scale, gate[2 * i]);
    const float v1 = dh2_part(f.y, res_scale, gate[2 * i + 1]);
    if (sum) {
      sum[2 * i] += __fadd_rn(v0, dgap_hw[2 * i]);
      sum[2 * i + 1] += __fadd_rn(v1, dgap_hw[2 * i + 1]);
    }
    out[i] = __floats2bfloat162_rn(v0, v1);
  }
  return r;
}

// The TH x TW tile at (ty0, tx0) of image `img` with a 1-pixel halo into
// `t_s` as [pixel][C + 8], zero outside the image, 8 channels a load.
template <int C>
__device__ __forceinline__ void load_halo_tile(const bf16* __restrict__ img, bf16* t_s, int ty0,
                                               int tx0, int H, int W, int TH, int TW) {
  constexpr int SP = C + 8;
  const int XW = TW + 2;
  for (int i = threadIdx.x; i < (TH + 2) * XW * (C / 8); i += kThreads) {
    const int p = i / (C / 8), c8 = (i % (C / 8)) * 8;
    const int gy = ty0 - 1 + p / XW, gx = tx0 - 1 + p % XW;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = *reinterpret_cast<const uint4*>(img + ((size_t)gy * W + gx) * C + c8);
    *reinterpret_cast<uint4*>(t_s + p * SP + c8) = v;
  }
}

// The tile `o_s` ([pixel][C + 8]) to the in-image pixels of `img`, 16 bytes
// a thread.
template <int C>
__device__ __forceinline__ void store_tile(const bf16* o_s, bf16* __restrict__ img, int ty0,
                                           int tx0, int H, int W, int TH, int TW) {
  constexpr int SP = C + 8;
  for (int i = threadIdx.x; i < TH * TW * (C / 8); i += kThreads) {
    const int p = i / (C / 8), c8 = (i % (C / 8)) * 8;
    const int gy = ty0 + p / TW, gx = tx0 + p % TW;
    if (gy < H && gx < W)
      *reinterpret_cast<uint4*>(img + ((size_t)gy * W + gx) * C + c8) =
          *reinterpret_cast<const uint4*>(o_s + p * SP + c8);
  }
}

// Pass 2: h1 again, then dh1 = conv^T(dh2, w2) * [h1 > 0] on a TH x TW tile.
// Shared memory: t_s, the x tile with its halo and later the dh2 tile; o_s,
// the h1 and later the dh1 tile on their way out; w_s, two buffers of a tap:
// conv2's first tap arrives while conv1 ends and dh2 is built.
template <int NT>
__global__ void __launch_bounds__(kThreads)
rcab_bwd_dh1_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                        const float* __restrict__ b1, const bf16* __restrict__ w2,
                        const bf16* __restrict__ dout, const float* __restrict__ gate,
                        const float* __restrict__ ctab, float res_scale,
                        bf16* __restrict__ h1, bf16* __restrict__ dh1, int H, int W, int TH,
                        int TW) {
  constexpr int C = NT * 8;
  constexpr int MU = kMmaAcc / (4 * NT);
  constexpr int SP = C + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int XH = TH + 2, XW = TW + 2, P = TH * TW;
  bf16* t_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* o_s = t_s + XH * XW * SP;
  bf16* w_s = o_s + P * SP;
  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = lane >> 2, cq = (lane & 3) * 2;
  const size_t img = (size_t)n * H * W * C;

  conv_stage_tap<NT, false>(w1, 0, w_s);  // arrives while the x tile is loaded
  load_halo_tile<C>(x + img, t_s, ty0, tx0, H, W, TH, TW);
  float acc[MU][NT][4];
  conv3x3_mma<NT, false, true>(t_s, XW, TH, TW, SP, w1, w_s, 0, w2, acc);
  // h1, rounded as the forward rounds it before conv2; bit (u * NT + j) * 4
  // + q of `positive` says whether accumulator [u][j][q]'s h1 is > 0
  unsigned long long positive = 0ull;
#pragma unroll
  for (int u = 0; u < MU; ++u) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = (warp + 8 * u) * 16 + r0 + 8 * half;
      if (m >= P) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int co = j * 8 + cq;
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            fmaxf(acc[u][j][2 * half] + b1[co], 0.f),
            fmaxf(acc[u][j][2 * half + 1] + b1[co + 1], 0.f));
        const int bit = (u * NT + j) * 4 + 2 * half;
        if (__low2float(v) > 0.f) positive |= 1ull << bit;
        if (__high2float(v) > 0.f) positive |= 1ull << (bit + 1);
        *reinterpret_cast<__nv_bfloat162*>(o_s + m * SP + co) = v;
      }
    }
  }
  __syncthreads();  // conv1 has read the x tile everywhere; the h1 tile is whole
  store_tile<C>(o_s, h1 + img, ty0, tx0, H, W, TH, TW);

  // round_bf16(g * u) tile with a 1-pixel halo, zero outside the image; a
  // thread meets the same 8 channels at every step of the loop
  {
    const int c8 = (threadIdx.x % (C / 8)) * 8;
    float u8[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) u8[k] = gate[(size_t)n * C + c8 + k];
    for (int i = threadIdx.x; i < XH * XW * (C / 8); i += kThreads) {
      const int p = i / (C / 8);
      const int gy = ty0 - 1 + p / XW, gx = tx0 - 1 + p % XW;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = dh2_chunk(*reinterpret_cast<const uint4*>(dout + img + ((size_t)gy * W + gx) * C + c8),
                      res_scale, u8);
      *reinterpret_cast<uint4*>(t_s + p * SP + c8) = v;
    }
  }
  // its first barrier publishes the tile and ends the reads of the h1 tile
  conv3x3_mma<NT, true>(t_s, XW, TH, TW, SP, w2, w_s, 1, nullptr, acc);
#pragma unroll
  for (int u = 0; u < MU; ++u) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = (warp + 8 * u) * 16 + r0 + 8 * half;
      if (m >= P) continue;
      // dgap / HW's share, exact in f32, by the pixel's class
      const float* k = ctab + ((size_t)n * 9 + 3 * edge_class(ty0 + m / TW, H)
                               + edge_class(tx0 + m % TW, W)) * C + cq;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int bit = (u * NT + j) * 4 + 2 * half;
        const float2 kc = *reinterpret_cast<const float2*>(k + j * 8);
        *reinterpret_cast<__nv_bfloat162*>(o_s + m * SP + j * 8 + cq) = __floats2bfloat162_rn(
            (positive >> bit) & 1ull ? acc[u][j][2 * half] + kc.x : 0.f,
            (positive >> (bit + 1)) & 1ull ? acc[u][j][2 * half + 1] + kc.y : 0.f);
      }
    }
  }
  __syncthreads();
  store_tile<C>(o_s, dh1 + img, ty0, tx0, H, W, TH, TW);
}

// Pass 3: dx = conv^T(dh1, w1) + dout on a TH x TW tile. Shared memory as
// in pass 2; o_s holds the dout tile, then dx.
template <int NT>
__global__ void __launch_bounds__(kThreads)
rcab_bwd_dx_mma_kernel(const bf16* __restrict__ dh1, const bf16* __restrict__ w1,
                       const bf16* __restrict__ dout, bf16* __restrict__ dx, int H, int W,
                       int TH, int TW) {
  constexpr int C = NT * 8;
  constexpr int MU = kMmaAcc / (4 * NT);
  constexpr int SP = C + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int XH = TH + 2, XW = TW + 2, P = TH * TW;
  bf16* t_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* o_s = t_s + XH * XW * SP;
  bf16* w_s = o_s + P * SP;
  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = lane >> 2, cq = (lane & 3) * 2;
  const size_t img = (size_t)n * H * W * C;

  // the dout tile arrives while the conv runs
  for (int i = threadIdx.x; i < P * (C / 8); i += kThreads) {
    const int p = i / (C / 8), c8 = (i % (C / 8)) * 8;
    const int gy = ty0 + p / TW, gx = tx0 + p % TW;
    const bool in = gy < H && gx < W;
    cp_async16(o_s + p * SP + c8, in ? dout + img + ((size_t)gy * W + gx) * C + c8 : dout, in);
  }
  cp_async_commit();
  conv_stage_tap<NT, true>(w1, 0, w_s);
  load_halo_tile<C>(dh1 + img, t_s, ty0, tx0, H, W, TH, TW);
  float acc[MU][NT][4];
  // its first barrier publishes the dout tile too
  conv3x3_mma<NT, true>(t_s, XW, TH, TW, SP, w1, w_s, 0, nullptr, acc);
#pragma unroll
  for (int u = 0; u < MU; ++u) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = (warp + 8 * u) * 16 + r0 + 8 * half;
      if (m >= P) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        __nv_bfloat162* at = reinterpret_cast<__nv_bfloat162*>(o_s + m * SP + j * 8 + cq);
        const float2 d = __bfloat1622float2(*at);
        *at = __floats2bfloat162_rn(acc[u][j][2 * half] + d.x, acc[u][j][2 * half + 1] + d.y);
      }
    }
  }
  __syncthreads();
  store_tile<C>(o_s, dx + img, ty0, tx0, H, W, TH, TW);
}

// Pass 4: the weight and bias gradients of both convs, on kWTH x kWTW
// tiles. Block (s, z): tiles [s * tps, (s+1) * tps) of the N * tiles-an-image
// and z = (conv, cib, cob): conv 0 is conv1 (a = x, g = dh1), conv 1 is conv2
// (a = h1, g = dh2, built in place from dout); (cib, cob) the CB x CB block
// of the C x C matrix, CB = 8 * NTB = min(C, 64). It writes, for all 9 taps,
//   part_w[conv][s][3 ty + tx][ci][co] = sum_p a[p + (ty, tx)][ci] * g[p][co]
// and the blocks with cib = 0 also part_b[conv][s][co] = sum_p g[p][co].
// For conv2, g is round_bf16(g * u) and dgap / HW's share is added exactly:
// thread (grp, ci) sums h1 over its rows of each tile by pixel class (cls_sum),
// and when the walk leaves an image (flush) the block adds, for each tap,
// the classes valid for it into hs[t][ci] and warps kw = 0 add
// hs[t][ci] * dgap[n][co] / HW to their accumulators, in a fixed order.
// A tile row is 16 pixels, one K step of the mma. The A fragment of halo
// row r shifted by tx serves the taps (0, tx), (1, tx), (2, tx) against the g
// rows r, r - 1, r - 2, whose B fragments wait in registers: per halo row a
// warp loads 3 A and at most 2 B fragments for up to 36 mma. Warp
// (kw, mt, ng) owns the 16 rows mt and the WN n-tiles ng of the block for
// the g rows [kw, kw + 1) * kWTH / KW of each tile; the KW partial sums are
// added in order at the end. Three tiles are in flight: the one multiplied
// and the next two on their way through cp.async.
constexpr int kWTH = 8, kWTW = 16, kWStages = 3;

template <int NTB>
__global__ void __launch_bounds__(kThreads, 1)
rcab_bwd_wgrad_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dh1,
                          const bf16* __restrict__ h1, const bf16* __restrict__ dout,
                          const float* __restrict__ gate, const float* __restrict__ dgap_hw,
                          float res_scale, float* __restrict__ part_w,
                          float* __restrict__ part_b, int N, int H, int W, int C, int tps) {
  constexpr int CB = NTB * 8;
  constexpr int SP = CB + 8;
  constexpr int CH = CB / 8;  // 16-byte chunks a pixel
  constexpr int MT = CB / 16;
  constexpr int WN = NTB == 2 ? 2 : 4;
  constexpr int NG = NTB / WN;
  constexpr int KW = (kThreads / 32) / (MT * NG);
  constexpr int TH = kWTH, TW = kWTW, XH = TH + 2, XW = TW + 2, P = TH * TW;
  constexpr int a_elems = XH * XW * SP;
  constexpr int stage_elems = a_elems + P * SP;
  constexpr int G = kThreads / CB;  // row groups of the class sums
  static_assert(TH % KW == 0 && TW == 16, "a K step is one tile row");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stages = reinterpret_cast<bf16*>(smem_raw);
  float* red_s = reinterpret_cast<float*>(stages + kWStages * stage_elems);  // G x 9 x CB
  float* hs_s = red_s + 9 * kThreads;                                        // 9 x CB
  const int s = blockIdx.x, S = gridDim.x;
  const int nb = C / CB;
  const int conv = blockIdx.z / (nb * nb);
  const int cib = (blockIdx.z / nb) % nb, cob = blockIdx.z % nb;
  const bf16* a = (conv ? h1 : x) + cib * CB;
  const bf16* g = (conv ? dout : dh1) + cob * CB;
  const int tiles_x = (W + TW - 1) / TW;
  const int per_image = tiles_x * ((H + TH - 1) / TH);
  const int total = N * per_image;
  const int begin = s * tps;
  const int end = begin + tps < total ? begin + tps : total;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kw = warp / (MT * NG), wr = warp % (MT * NG);
  const int mt = wr / NG, ng = wr % NG;
  const int g0 = kw * (TH / KW), g1 = g0 + TH / KW;  // this warp's rows of g
  const bool bias = cib == 0;
  const int c8 = (tid % CH) * 8;  // kThreads % CH == 0: the same at every step
  const int grp = tid / CB, ci_s = tid % CB;  // the class sums' row group and channel

  float acc[9][WN][4];
  float bsum[8], u8[8], g8[8];  // bias sums; the gate and dgap / HW of image gate_of
  int gate_of = -1;
  float cls_sum[9];  // h1 of channel ci_s by pixel class, this thread's rows, image hs_of
  int hs_of = -1;
#pragma unroll
  for (int k = 0; k < 9; ++k) cls_sum[k] = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) bsum[k] = u8[k] = g8[k] = 0.f;
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[t][j][q] = 0.f;

  // start the copies of one tile (a with its halo, g without) as one group;
  // past the split's end, an empty group, so that the count stays in step
  auto start_tile = [&](int tile) {
    if (tile < end) {
      const int n = tile / per_image, r = tile % per_image;
      const int ty0 = (r / tiles_x) * TH, tx0 = (r % tiles_x) * TW;
      bf16* a_s = stages + ((tile - begin) % kWStages) * stage_elems;
      bf16* g_s = a_s + a_elems;
      const size_t img = (size_t)n * H * W * C;
      for (int i = tid; i < XH * XW * CH; i += kThreads) {
        const int p = i / CH;
        const int gy = ty0 - 1 + p / XW, gx = tx0 - 1 + p % XW;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
        cp_async16(a_s + p * SP + c8, in ? a + img + ((size_t)gy * W + gx) * C + c8 : a, in);
      }
      for (int i = tid; i < P * CH; i += kThreads) {
        const int p = i / CH;
        const int gy = ty0 + p / TW, gx = tx0 + p % TW;
        const bool in = gy < H && gx < W;
        cp_async16(g_s + p * SP + c8, in ? g + img + ((size_t)gy * W + gx) * C + c8 : g, in);
      }
    }
    cp_async_commit();
  };

  // dgap[nf] / HW's share of dw2 from the class sums of image nf (conv2 only)
  auto flush = [&](int nf) {
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      red_s[(grp * 9 + k) * CB + ci_s] = cls_sum[k];
      cls_sum[k] = 0.f;
    }
    __syncthreads();
    for (int i = tid; i < 9 * CB; i += kThreads) {  // i = t * CB + ci
      const int t = i / CB, ci = i - t * CB;
      float v = 0.f;
      for (int cls = 0; cls < 9; ++cls) {
        if (!tap_valid(cls / 3, t / 3, H) || !tap_valid(cls % 3, t % 3, W)) continue;
        float sg = 0.f;
        for (int q = 0; q < G; ++q) sg += red_s[(q * 9 + cls) * CB + ci];
        v += sg;
      }
      hs_s[i] = v;
    }
    __syncthreads();
    if (kw == 0) {
#pragma unroll
      for (int t = 0; t < 9; ++t)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float h = hs_s[t * CB + mt * 16 + (lane >> 2) + 8 * half];
#pragma unroll
          for (int j = 0; j < WN; ++j) {
            const int co = cob * CB + (ng * WN + j) * 8 + (lane & 3) * 2;
            acc[t][j][2 * half] = fmaf(h, dgap_hw[(size_t)nf * C + co], acc[t][j][2 * half]);
            acc[t][j][2 * half + 1] =
                fmaf(h, dgap_hw[(size_t)nf * C + co + 1], acc[t][j][2 * half + 1]);
          }
        }
    }
    __syncthreads();  // red_s and hs_s are free again
  };

  // lane's pixel and column in a B (g) and an A (a) ldmatrix.trans
  const int lb = ((lane & 7) + ((lane >> 3) & 1) * 8) * SP + ng * WN * 8 + (lane >> 4) * 8;
  const int la = ((lane & 7) + ((lane >> 4) & 1) * 8) * SP + mt * 16 + ((lane >> 3) & 1) * 8;

  start_tile(begin);
  start_tile(begin + 1);
  for (int tile = begin; tile < end; ++tile) {
    start_tile(tile + 2);  // into the stage that the tile before this one has left
    cp_async_wait<2>();
    const bf16* a_s = stages + ((tile - begin) % kWStages) * stage_elems;
    bf16* g_s = stages + ((tile - begin) % kWStages) * stage_elems + a_elems;
    if (conv && tile / per_image != hs_of) {  // block-uniform
      if (hs_of >= 0) flush(hs_of);
      hs_of = tile / per_image;
    }
    // a thread's own chunks of g have landed: dh2 in place, the bias sums
    if (conv || bias) {
      const int n = tile / per_image, r = tile % per_image;
      const int ty0 = (r / tiles_x) * TH, tx0 = (r % tiles_x) * TW;
      if (conv && n != gate_of) {  // a split's tiles lie in few images
        gate_of = n;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          u8[k] = gate[(size_t)n * C + cob * CB + c8 + k];
          g8[k] = dgap_hw[(size_t)n * C + cob * CB + c8 + k];
        }
      }
      for (int i = tid; i < P * CH; i += kThreads) {
        const int p = i / CH;
        if (ty0 + p / TW >= H || tx0 + p % TW >= W) continue;  // stays 0
        uint4* at = reinterpret_cast<uint4*>(g_s + p * SP + c8);
        uint4 v = *at;
        if (conv) {  // db2 sums the whole dh2 before any rounding
          v = dh2_chunk(v, res_scale, u8, bias ? bsum : nullptr, g8);
          *at = v;
        } else if (bias) {
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 f = __bfloat1622float2(h[k]);
            bsum[2 * k] += f.x;
            bsum[2 * k + 1] += f.y;
          }
        }
      }
    }
    __syncthreads();
    if (conv) {  // h1 of this tile's in-image pixels by class, rows grp, grp + G, ...
      const int r = tile % per_image;
      const int ty0 = (r / tiles_x) * TH, tx0 = (r % tiles_x) * TW;
      for (int y = grp; y < TH && ty0 + y < H; y += G) {
        const bf16* row = a_s + ((y + 1) * XW + 1) * SP + ci_s;
        float first = 0.f, inner = 0.f, last = 0.f;
        for (int x = 0; x < TW && tx0 + x < W; ++x) {
          const float v = __bfloat162float(row[x * SP]);
          const int cx = edge_class(tx0 + x, W);
          if (cx == 0) first += v;
          else if (cx == 2) last += v;
          else inner += v;
        }
        const int cy = edge_class(ty0 + y, H);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          if (cy != k) continue;
          cls_sum[3 * k] += first;
          cls_sum[3 * k + 1] += inner;
          cls_sum[3 * k + 2] += last;
        }
      }
    }
    uint32_t bw[3][WN / 2][4] = {};  // B fragments of the g rows r, r - 1, r - 2
#pragma unroll 1
    for (int r = g0; r < g1 + 2; ++r) {  // halo rows of a
#pragma unroll
      for (int jj = 0; jj < WN / 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bw[2][jj][e] = bw[1][jj][e];
          bw[1][jj][e] = bw[0][jj][e];
        }
      if (r < g1) {
#pragma unroll
        for (int jj = 0; jj < WN / 2; ++jj) ldmatrix_x4_trans(bw[0][jj], g_s + r * TW * SP + lb + jj * 16);
      }
#pragma unroll
      for (int tx = 0; tx < 3; ++tx) {
        uint32_t af[4];
        ldmatrix_x4_trans(af, a_s + (r * XW + tx) * SP + la);
#pragma unroll
        for (int ty = 0; ty < 3; ++ty) {
          const int ks = r - ty;  // the g row that tap row ty pairs with halo row r
          if (ks < g0 || ks >= g1) continue;  // warp-uniform
#pragma unroll
          for (int jj = 0; jj < WN / 2; ++jj) {
            mma_bf16(acc[ty * 3 + tx][2 * jj], af, bw[ty][jj][0], bw[ty][jj][1]);
            mma_bf16(acc[ty * 3 + tx][2 * jj + 1], af, bw[ty][jj][2], bw[ty][jj][3]);
          }
        }
      }
    }
    __syncthreads();  // the stage is free for the tile three on
  }
  cp_async_wait<0>();
  if (conv && hs_of >= 0) flush(hs_of);

  float* red = reinterpret_cast<float*>(smem_raw);  // the stages are free now
  if (KW > 1) {
    constexpr int lanes = MT * NG * 32;
    for (int q = 1; q < KW; ++q) {
      if (kw == q) {
#pragma unroll
        for (int t = 0; t < 9; ++t)
#pragma unroll
          for (int j = 0; j < WN; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              red[((t * WN + j) * 4 + e) * lanes + wr * 32 + lane] = acc[t][j][e];
      }
      __syncthreads();
      if (kw == 0) {
#pragma unroll
        for (int t = 0; t < 9; ++t)
#pragma unroll
          for (int j = 0; j < WN; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[t][j][e] += red[((t * WN + j) * 4 + e) * lanes + wr * 32 + lane];
      }
      __syncthreads();
    }
  }
  if (kw == 0) {
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      float* pw = part_w + (((size_t)conv * S + s) * 9 + t) * C * C;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ci = cib * CB + mt * 16 + (lane >> 2) + 8 * half;
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          const int co = cob * CB + (ng * WN + j) * 8 + (lane & 3) * 2;
          *reinterpret_cast<float2*>(pw + (size_t)ci * C + co) =
              make_float2(acc[t][j][2 * half], acc[t][j][2 * half + 1]);
        }
      }
    }
  }
  if (bias) {  // block-uniform; thread k * CH + c / 8 holds channel c's k-th term
#pragma unroll
    for (int k = 0; k < 8; ++k) red[tid * 8 + k] = bsum[k];
    __syncthreads();
    if (tid < CB) {
      float sum = 0.f;
      for (int k = 0; k < kThreads / CH; ++k) sum += red[(k * CH + tid / 8) * 8 + tid % 8];
      part_b[((size_t)conv * S + s) * C + cob * CB + tid] = sum;
    }
  }
}

// The last pass of either plan. The splits' partial sums added in order:
// part_w (2, S, 9CC) -> dw1, dw2; part_b (2, S, C) -> db1, db2; and the
// images' terms added in order -> dwd (C,R), dwu (R,C), dbu (C), dbd (R);
// dbu (N,C) and dbd (N,R) are the images' own terms where bu and bd were
// per image (bu_pe, bd_pe).
__global__ void __launch_bounds__(kThreads)
rcab_bwd_finish_kernel(const float* __restrict__ part_w, const float* __restrict__ part_b,
                       int S, float* __restrict__ dw1, float* __restrict__ dw2,
                       float* __restrict__ db1, float* __restrict__ db2,
                       const float* __restrict__ ds, const float* __restrict__ gap,
                       const float* __restrict__ dz, const float* __restrict__ d,
                       float* __restrict__ dwd, float* __restrict__ dbd,
                       float* __restrict__ dwu, float* __restrict__ dbu, int N, int C, int R,
                       int bu_pe, int bd_pe) {
  const int cc = 9 * C * C;
  const int CU = bu_pe ? N * C : C;
  const int total = 2 * cc + 2 * C + 2 * C * R + CU + (bd_pe ? N * R : R);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < total; i += gridDim.x * kThreads) {
    float s = 0.f;
    if (i < 2 * cc) {
      const int conv = i / cc, r = i - conv * cc;
      const float* p = part_w + (size_t)conv * S * cc + r;
#pragma unroll 8
      for (int q = 0; q < S; ++q) s += p[(size_t)q * cc];
      (conv ? dw2 : dw1)[r] = s;
      continue;
    }
    int k = i - 2 * cc;
    if (k < 2 * C) {
      const int conv = k / C, c = k - conv * C;
      for (int q = 0; q < S; ++q) s += part_b[((size_t)conv * S + q) * C + c];
      (conv ? db2 : db1)[c] = s;
      continue;
    }
    k -= 2 * C;
    if (k < C * R) {  // dwd[c][j]
      const int c = k / R, j = k - c * R;
      for (int n = 0; n < N; ++n) s = fmaf(gap[(size_t)n * C + c], dz[(size_t)n * R + j], s);
      dwd[k] = s;
    } else if (k < 2 * C * R) {  // dwu[j][c]
      k -= C * R;
      const int j = k / C, c = k - j * C;
      for (int n = 0; n < N; ++n) s = fmaf(d[(size_t)n * R + j], ds[(size_t)n * C + c], s);
      dwu[k] = s;
    } else if (k < 2 * C * R + CU) {
      const int c = k - 2 * C * R;
      if (bu_pe) s = ds[c];
      else for (int n = 0; n < N; ++n) s += ds[(size_t)n * C + c];
      dbu[c] = s;
    } else {
      const int j = k - 2 * C * R - CU;
      if (bd_pe) s = dz[j];
      else for (int n = 0; n < N; ++n) s += dz[(size_t)n * R + j];
      dbd[j] = s;
    }
  }
}

// The launch plan of the backward, decided here and nowhere else: tensor
// cores or not; the tile of the dh1 and dx passes (the first whose conv
// work has a thread for every item and whose shared memory lets two blocks
// share an SM, else the first that fits an SM at all; on the tensor cores
// 16x16 only for a grid with a block for every SM); the weight gradient's
// tile and its splits, one block an SM; the chunks of the du pass.
struct Plan {
  bool mma;
  int th, tw, smem;        // dh1 and dx passes
  int wsmem, cb, tps;      // weight gradient on the tensor cores: its stages' shared
                           // memory, its block of the C x C matrix, tiles a split
  int splits, chunk;       // weight gradient: splits, and pixels a split (CUDA cores)
  int J;                   // du pass
};

constexpr int kTiles[][2] = {{16, 16}, {8, 16}, {8, 8}, {4, 8}, {4, 4}};

// For the current device.
cudaError_t make_plan(int dtype, int N, int H, int W, int C, Plan* p) {
  if ((dtype != 0 && dtype != 1) || C <= 0 || C % 8 || N <= 0 || H <= 0 || W <= 0)
    return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  p->mma = dtype == 1 && (C == 16 || C == 32 || C == 64 || C == 128);
  bool found = false;
  for (int limit : {kSmemTwoPerSm, kSmemMax}) {
    for (const auto& t : kTiles) {
      const int P = t[0] * t[1], halo = (t[0] + 2) * (t[1] + 2);
      int smem;
      if (p->mma) {
        if ((P + 15) / 16 > (kThreads / 32) * (kMmaAcc / (4 * (C / 8)))) continue;
        // a 16x16 tile gives a warp two m-tiles for each B fragment it
        // loads, but only pays while its grid still has a block for every SM
        const long long blocks = (long long)N * ((H + t[0] - 1) / t[0]) * ((W + t[1] - 1) / t[1]);
        if (P > 128 && blocks < sms) continue;
        smem = (halo + P + 2 * C) * (C + 8) * 2;  // the tiles and two taps
      } else {
        if ((P + kPM - 1) / kPM * (C / kCM) > kMaxIt * kThreads) continue;
        smem = (9 * kKC * C + halo * (C + 1)) * (int)sizeof(float);
      }
      if (smem > limit) continue;
      p->th = t[0];
      p->tw = t[1];
      p->smem = smem;
      found = true;
      break;
    }
    if (found) break;
  }
  if (!found) return cudaErrorInvalidConfiguration;  // C too large for one block
  p->J = (H * W + kDuPixels - 1) / kDuPixels;
  const long long pixels = (long long)N * H * W;
  if (p->mma) {
    p->cb = C < 64 ? C : 64;
    p->wsmem = kWStages * ((kWTH + 2) * (kWTW + 2) + kWTH * kWTW) * (p->cb + 8) * 2
               + (9 * kThreads + 9 * p->cb) * (int)sizeof(float);  // the class sums' flush
    const long long tiles =
        (long long)N * ((H + kWTH - 1) / kWTH) * ((W + kWTW - 1) / kWTW);
    const int nb = C / p->cb;
    const int max_splits = sms / (2 * nb * nb) > 0 ? sms / (2 * nb * nb) : 1;
    p->tps = (int)((tiles + max_splits - 1) / max_splits);
    p->splits = (int)((tiles + p->tps - 1) / p->tps);
    p->chunk = 0;
    return cudaSuccess;
  }
  long long splits = pixels / 256;
  splits = splits < 1 ? 1 : (splits > kMaxSplits ? kMaxSplits : splits);
  long long chunk = (pixels + splits - 1) / splits;
  chunk = (chunk + kWK - 1) / kWK * kWK;
  p->chunk = (int)chunk;
  p->splits = (int)((pixels + chunk - 1) / chunk);
  return cudaSuccess;
}

// Float32 scratch of one backward, in this order: the flipped weights of
// the CUDA-core plan (2 x 9CC elements of T, in float-sized slots; nothing
// on the tensor-core plan), the dout * h2 chunk sums (N, J, C), dgap/HW, ds,
// gap and the effective gate (N, C each), ctab (N, 9, C; the tensor-core
// plan only), the weight-gradient splits (2, splits, 9CC) and bias splits (2,
// splits, C), then dz and d (N, R each). C % 8 == 0 keeps every part but the
// last two 32-byte aligned.
struct Layout {
  long long wt, part_du, per_image, ctab, part_w, part_b, dz, total;
};

Layout make_layout(const Plan& p, int N, int C, int R) {
  Layout l;
  const long long cc = 9LL * C * C;
  l.wt = 0;
  l.part_du = l.wt + (p.mma ? 0 : 2 * cc);
  l.per_image = l.part_du + (long long)N * p.J * C;
  l.ctab = l.per_image + 4LL * N * C;
  l.part_w = l.ctab + (p.mma ? 9LL * N * C : 0);
  l.part_b = l.part_w + 2LL * p.splits * cc;
  l.dz = l.part_b + 2LL * p.splits * C;
  l.total = l.dz + 2LL * N * R;
  return l;
}

// Passes 2-4 of the tensor-core plan for C = 8 * NT.
template <int NT>
cudaError_t run_mma(const Plan& p, const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                    float res_scale, const bf16* dout, const float* gate, const float* dgap_hw,
                    const float* ctab, bf16* dx, bf16* h1, bf16* dh1, float* part_w,
                    float* part_b, int N, int H, int W, cudaStream_t s) {
  constexpr int C = NT * 8;
  constexpr int NTB = NT < 8 ? NT : 8;
  static int done_dh1[kMaxDevices] = {};
  static int done_dx[kMaxDevices] = {};
  static int done_wgrad[kMaxDevices] = {};
  cudaError_t err = allow_smem(rcab_bwd_dh1_mma_kernel<NT>, p.smem, done_dh1);
  if (err != cudaSuccess) return err;
  err = allow_smem(rcab_bwd_dx_mma_kernel<NT>, p.smem, done_dx);
  if (err != cudaSuccess) return err;
  err = allow_smem(rcab_bwd_wgrad_mma_kernel<NTB>, p.wsmem, done_wgrad);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + p.tw - 1) / p.tw, (H + p.th - 1) / p.th, N);
  rcab_bwd_dh1_mma_kernel<NT><<<grid, kThreads, p.smem, s>>>(
      x, w1, b1, w2, dout, gate, ctab, res_scale, h1, dh1, H, W, p.th, p.tw);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rcab_bwd_dx_mma_kernel<NT><<<grid, kThreads, p.smem, s>>>(dh1, w1, dout, dx, H, W, p.th, p.tw);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int nb = C / p.cb;
  rcab_bwd_wgrad_mma_kernel<NTB><<<dim3(p.splits, 1, 2 * nb * nb), kThreads, p.wsmem, s>>>(
      x, dh1, h1, dout, gate, dgap_hw, res_scale, part_w, part_b, N, H, W, C, p.tps);
  return cudaGetLastError();
}

// Passes 2-4 of the CUDA-core plan.
template <typename T>
cudaError_t run_fma(const Plan& p, const T* x, const T* w1, const float* b1, const T* w2,
                    float res_scale, const T* dout, const float* gate, const float* dgap_hw,
                    T* dx, T* h1, T* dh1, T* w1t, T* w2t, float* part_w, float* part_b, int N,
                    int H, int W, int C, cudaStream_t s) {
  static int done_dh1[kMaxDevices] = {};
  static int done_dx[kMaxDevices] = {};
  cudaError_t err = allow_smem(rcab_bwd_dh1_kernel<T>, p.smem, done_dh1);
  if (err != cudaSuccess) return err;
  err = allow_smem(rcab_bwd_dx_kernel<T>, p.smem, done_dx);
  if (err != cudaSuccess) return err;
  const int cc = 9 * C * C;
  rcab_bwd_flip_kernel<T><<<(cc + kThreads - 1) / kThreads, kThreads, 0, s>>>(w1, w2, w1t, w2t, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid((W + p.tw - 1) / p.tw, (H + p.th - 1) / p.th, N);
  rcab_bwd_dh1_kernel<T><<<grid, kThreads, p.smem, s>>>(
      x, w1, b1, w2t, dout, gate, dgap_hw, res_scale, h1, dh1, H, W, C, p.th, p.tw);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rcab_bwd_dx_kernel<T><<<grid, kThreads, p.smem, s>>>(dh1, w1t, dout, dx, H, W, C, p.th, p.tw);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int nb = (C + kWB - 1) / kWB;
  const dim3 wgrid(p.splits, 9, nb * nb);
  rcab_bwd_wgrad_kernel<T, false><<<wgrid, kThreads, 0, s>>>(
      x, dh1, gate, dgap_hw, res_scale, part_w, part_b, N, H, W, C, p.chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rcab_bwd_wgrad_kernel<T, true><<<wgrid, kThreads, 0, s>>>(
      h1, dout, gate, dgap_hw, res_scale, part_w + (size_t)p.splits * cc,
      part_b + (size_t)p.splits * C, N, H, W, C, p.chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const Plan& p, const Layout& l, const T* x, const T* w1, const float* b1,
                const T* w2, const float* wd, const float* bd, int bd_stride, const float* wu,
                float res_scale, const float* scale, int bu_pe, const T* dout, const float* h2,
                const float* fwd_partial, const float* gate_u, int n_tiles, T* dx, float* dw1,
                float* db1, float* dw2, float* db2, float* dwd, float* dbd, float* dwu,
                float* dbu, float* dscale, T* h1, T* dh1, float* ws, int N, int H, int W, int C,
                int R, cudaStream_t s) {
  const int cc = 9 * C * C;
  float* part_du = ws + l.part_du;
  float* dgap_hw = ws + l.per_image;
  float* ds = dgap_hw + (size_t)N * C;
  float* gap = ds + (size_t)N * C;
  float* gate_eff = gap + (size_t)N * C;
  // the passes after the gate kernel read u * scale with scale 1, or u with res_scale
  const float* gate = scale ? gate_eff : gate_u;
  const float pass_scale = scale ? 1.f : res_scale;
  float* ctab = ws + l.ctab;
  float* part_w = ws + l.part_w;
  float* part_b = ws + l.part_b;
  float* dz = ws + l.dz;
  float* d = dz + (size_t)N * R;

  const int L = C / 8 < kThreads ? kThreads / (C / 8) : 1;
  rcab_bwd_du_kernel<T><<<dim3(p.J, N), kThreads, L * C * sizeof(float), s>>>(
      dout, h2, part_du, H * W, C, p.J);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int Q = C < kThreads ? kThreads / C : 1;
  const __nv_bfloat16* w2_mma = nullptr;  // the tensor-core plan's ctab comes from w2
  if constexpr (std::is_same<T, bf16>::value) {
    if (p.mma) w2_mma = w2;
  }
  const int gate_floats = 2 * C + 2 * R + 2 * Q * C + 2 * C * R + (w2_mma ? 10 * C : 0);
  rcab_bwd_gate_kernel<<<N, kThreads, gate_floats * sizeof(float), s>>>(
      part_du, fwd_partial, gate_u, wd, bd, bd_stride, wu, res_scale, scale, dscale, gate_eff,
      dgap_hw, ds, gap, dz, d, w2_mma, w2_mma ? ctab : nullptr, p.J, n_tiles, H, W, C, R);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if constexpr (std::is_same<T, bf16>::value) {
    if (p.mma) {
      switch (C) {
        case 16: err = run_mma<2>(p, x, w1, b1, w2, pass_scale, dout, gate, dgap_hw, ctab, dx, h1, dh1, part_w, part_b, N, H, W, s); break;
        case 32: err = run_mma<4>(p, x, w1, b1, w2, pass_scale, dout, gate, dgap_hw, ctab, dx, h1, dh1, part_w, part_b, N, H, W, s); break;
        case 64: err = run_mma<8>(p, x, w1, b1, w2, pass_scale, dout, gate, dgap_hw, ctab, dx, h1, dh1, part_w, part_b, N, H, W, s); break;
        case 128: err = run_mma<16>(p, x, w1, b1, w2, pass_scale, dout, gate, dgap_hw, ctab, dx, h1, dh1, part_w, part_b, N, H, W, s); break;
        default: err = cudaErrorInvalidValue;
      }
    }
  }
  if (!p.mma) {
    T* w1t = reinterpret_cast<T*>(ws + l.wt);
    err = run_fma<T>(p, x, w1, b1, w2, pass_scale, dout, gate, dgap_hw, dx, h1, dh1, w1t, w1t + cc,
                     part_w, part_b, N, H, W, C, s);
  }
  if (err != cudaSuccess) return err;

  const int bd_pe = bd_stride != 0;
  const int outputs = 2 * cc + 2 * C + 2 * C * R + (bu_pe ? N * C : C) + (bd_pe ? N * R : R);
  rcab_bwd_finish_kernel<<<(outputs + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      part_w, part_b, p.splits, dw1, dw2, db1, db2, ds, gap, dz, d, dwd, dbd, dwu, dbu, N, C, R,
      bu_pe, bd_pe);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Sets *floats to the float32 workspace
// that rcab_fused_backward needs. Returns a cudaError_t (0 on success;
// cudaErrorInvalidConfiguration if C channels do not fit one block).
int rcab_fused_backward_workspace(int dtype, int N, int H, int W, int C, int R,
                                  long long* floats) {
  Plan p;
  const cudaError_t err = make_plan(dtype, N, H, W, C, &p);
  if (err == cudaSuccess) *floats = make_layout(p, N, C, R).total;
  return (int)err;
}

// dtype as above; T is that type. x, dout, dx, h1, dh1: (N,H,W,C)
// contiguous T (h1 and dh1 are scratch); w1, w2: (9,C,C) tap-major T;
// b1, wd (C,R), wu (R,C): float32; bd (R) with bd_stride 0 or (N,R) with
// bd_stride R; scale null (res_scale for every image) or (N,C) float32;
// bu_pe 1 where the forward's bu was (N,C). h2 (N,H,W,C), fwd_partial
// (N, n_tiles, C) and gate (N,C): float32, as rcab_fused_forward left them
// in its workspace (rcab_fused_layout says where). Outputs dw1, dw2
// (9,C,C), db1, db2 (C), dwd (C,R), dwu (R,C): float32; dbd (R, or N*R
// with bd_stride R) and dbu (C, or N*C with bu_pe); dscale (N,C) where
// scale is given, else unused.
// workspace: at least what rcab_fused_backward_workspace gives, 16-byte
// aligned; the tensor-core plan (bf16, C in {16, 32, 64, 128}) needs x, dout,
// dx, h1, dh1, w1 and w2 on 16-byte boundaries too. Returns a cudaError_t
// (0 on success).
int rcab_fused_backward(int dtype, const void* x, const void* w1, const void* b1,
                        const void* w2, const void* wd, const void* bd, int bd_stride,
                        const void* wu, float res_scale, const void* scale, int bu_pe,
                        const void* dout, const void* h2, const void* fwd_partial,
                        const void* gate, int n_tiles, void* dx, void* dw1, void* db1,
                        void* dw2, void* db2, void* dwd, void* dbd, void* dwu, void* dbu,
                        void* dscale, void* h1, void* dh1, void* workspace,
                        long long workspace_floats_given, int N, int H, int W, int C, int R,
                        void* stream) {
  Plan p;
  const cudaError_t err = make_plan(dtype, N, H, W, C, &p);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || n_tiles <= 0 || (bd_stride != 0 && bd_stride != R) || (scale && !dscale))
    return (int)cudaErrorInvalidValue;
  const Layout l = make_layout(p, N, C, R);
  if (workspace_floats_given < l.total) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(workspace) % 16) return (int)cudaErrorMisalignedAddress;
  if (p.mma) {  // 16-byte copies
    for (const void* q : {x, w1, w2, dout, (const void*)dx, (const void*)h1, (const void*)dh1})
      if (reinterpret_cast<uintptr_t>(q) % 16) return (int)cudaErrorMisalignedAddress;
  }
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  auto o = [](void* q) { return static_cast<float*>(q); };
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using T = float;
    return (int)run<T>(p, l, static_cast<const T*>(x), static_cast<const T*>(w1), f(b1),
                       static_cast<const T*>(w2), f(wd), f(bd), bd_stride, f(wu), res_scale,
                       f(scale), bu_pe, static_cast<const T*>(dout), f(h2), f(fwd_partial),
                       f(gate), n_tiles, static_cast<T*>(dx), o(dw1), o(db1), o(dw2), o(db2),
                       o(dwd), o(dbd), o(dwu), o(dbu), o(dscale), static_cast<T*>(h1),
                       static_cast<T*>(dh1), o(workspace), N, H, W, C, R, s);
  }
  using T = __nv_bfloat16;
  return (int)run<T>(p, l, static_cast<const T*>(x), static_cast<const T*>(w1), f(b1),
                     static_cast<const T*>(w2), f(wd), f(bd), bd_stride, f(wu), res_scale,
                     f(scale), bu_pe, static_cast<const T*>(dout), f(h2), f(fwd_partial),
                     f(gate), n_tiles, static_cast<T*>(dx), o(dw1), o(db1), o(dw2), o(db2),
                     o(dwd), o(dbd), o(dwu), o(dbu), o(dscale), static_cast<T*>(h1),
                     static_cast<T*>(dh1), o(workspace), N, H, W, C, R, s);
}

}  // extern "C"
