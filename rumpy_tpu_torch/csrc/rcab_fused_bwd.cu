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
// Bound on an H100 SXM: six convolutions' worth of products (conv1 again,
// two data gradients, two weight gradients of two convs: 16.3 GFLOP at
// 16x48x48x64) against x, dout, dx and the saved h2 (24 MB): bound by
// operations, 0.016 ms in bf16 at 989 TFLOP/s and 0.24 ms in f32 at 67.
// This first version runs every product on the CUDA cores in f32, for bf16
// activations too (their products are exact in f32), and takes 1.3-1.4 ms
// there; tensor cores are later work.
//
// Design: launches on one stream, every reduction in a fixed order (no
// float atomics, so a step is reproducible run to run):
//   1. rcab_bwd_flip_kernel: w^T with flipped taps, so a transposed conv is
//      the forward's conv routine on other weights.
//   2. rcab_bwd_du_kernel: per-chunk sums of dout * h2; rcab_bwd_gate_kernel,
//      one block an image: du, the gate's backward, dgap; then
//      rcab_bwd_gate_params_kernel sums the images' terms into dwd, dbd,
//      dwu, dbu.
//   3. rcab_bwd_dh1_kernel, one block per (tile, image): conv1 again on the
//      x tile -> h1 (written out for step 5, its sign kept in registers),
//      then dh2 built in shared memory from dout, u and dgap, transposed
//      conv2, the ReLU mask -> dh1.
//   4. rcab_bwd_dx_kernel: transposed conv1 of dh1, plus dout.
//   5. rcab_bwd_wgrad_kernel, one block per (split of the pixels, tap,
//      64x64 block of the weight): a (C x pixels) . (pixels x C) product
//      with 8x8 outputs a thread and four slices of the pixels a block,
//      which also sums the bias gradient at the centre tap; then
//      rcab_bwd_sum_kernel adds the splits in order.

#include <initializer_list>

#include "rcab_common.cuh"

namespace {

constexpr int kDuPixels = 256;  // pixels per block of the dout * h2 sums
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

// part[n][j][c] = sum over the j-th chunk of kDuPixels pixels of image n of
// dout * h2, lanes added in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rcab_bwd_du_kernel(const T* __restrict__ dout, const float* __restrict__ h2,
                   float* __restrict__ part, int HW, int C, int J) {
  extern __shared__ float dsm[];  // L * C
  const int n = blockIdx.y, j = blockIdx.x;
  const int L = C < kThreads ? kThreads / C : 1;
  const int p0 = j * kDuPixels;
  const int p1 = p0 + kDuPixels < HW ? p0 + kDuPixels : HW;
  const size_t img = (size_t)n * HW * C;
  for (int i = threadIdx.x; i < L * C; i += kThreads) {
    const int lane = i / C, c = i - lane * C;
    float s = 0.f;
    for (int p = p0 + lane; p < p1; p += L) {
      const size_t o = img + (size_t)p * C + c;
      s = fmaf(to_f(dout[o]), h2[o], s);
    }
    dsm[i] = s;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f;
    for (int l = 0; l < L; ++l) s += dsm[l * C + c];
    part[((size_t)n * J + j) * C + c] = s;
  }
}

// One block per image: du from the chunk sums, GAP from the forward's tile
// sums, the C -> R -> C gate backwards. Leaves dgap / HW, ds (gradient at
// the sigmoid's input), gap, dz (gradient at the ReLU's input) and d (the
// ReLU's output) per image for the passes that follow.
__global__ void __launch_bounds__(kThreads)
rcab_bwd_gate_kernel(const float* __restrict__ part_du, const float* __restrict__ fwd_partial,
                     const float* __restrict__ gate, const float* __restrict__ wd,
                     const float* __restrict__ bd, const float* __restrict__ wu,
                     float res_scale, float* __restrict__ dgap_hw, float* __restrict__ ds_out,
                     float* __restrict__ gap_out, float* __restrict__ dz_out,
                     float* __restrict__ d_out, int J, int n_tiles, int HW, int C, int R) {
  extern __shared__ float gsm[];
  float* gap = gsm;     // C
  float* ds = gap + C;  // C
  float* d = ds + C;    // R
  float* dz = d + R;    // R
  const int n = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f;
    for (int t = 0; t < n_tiles; ++t) s += fwd_partial[((size_t)n * n_tiles + t) * C + c];
    gap[c] = s / (float)HW;
    float du = 0.f;
    for (int j = 0; j < J; ++j) du += part_du[((size_t)n * J + j) * C + c];
    du *= res_scale;
    const float u = gate[(size_t)n * C + c];
    ds[c] = du * u * (1.f - u);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < R; j += kThreads) {
    float z = 0.f, dd = 0.f;
    for (int c = 0; c < C; ++c) {
      z = fmaf(gap[c], wd[c * R + j], z);
      dd = fmaf(ds[c], wu[j * C + c], dd);
    }
    z += bd[j];
    d[j] = fmaxf(z, 0.f);
    dz[j] = z > 0.f ? dd : 0.f;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f;
    for (int j = 0; j < R; ++j) s = fmaf(dz[j], wd[c * R + j], s);
    dgap_hw[(size_t)n * C + c] = s / (float)HW;
    ds_out[(size_t)n * C + c] = ds[c];
    gap_out[(size_t)n * C + c] = gap[c];
  }
  for (int j = threadIdx.x; j < R; j += kThreads) {
    dz_out[(size_t)n * R + j] = dz[j];
    d_out[(size_t)n * R + j] = d[j];
  }
}

// dwd (C,R), dbd (R), dwu (R,C), dbu (C): the images' terms added in order.
__global__ void __launch_bounds__(kThreads)
rcab_bwd_gate_params_kernel(const float* __restrict__ ds, const float* __restrict__ gap,
                            const float* __restrict__ dz, const float* __restrict__ d,
                            float* __restrict__ dwd, float* __restrict__ dbd,
                            float* __restrict__ dwu, float* __restrict__ dbu, int N, int C,
                            int R) {
  const int total = 2 * C * R + C + R;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < total; i += gridDim.x * kThreads) {
    float s = 0.f;
    if (i < C * R) {  // dwd[c][j]
      const int c = i / R, j = i - c * R;
      for (int n = 0; n < N; ++n) s = fmaf(gap[(size_t)n * C + c], dz[(size_t)n * R + j], s);
      dwd[i] = s;
    } else if (i < 2 * C * R) {  // dwu[j][c]
      const int k = i - C * R;
      const int j = k / C, c = k - j * C;
      for (int n = 0; n < N; ++n) s = fmaf(d[(size_t)n * R + j], ds[(size_t)n * C + c], s);
      dwu[k] = s;
    } else if (i < 2 * C * R + C) {
      const int c = i - 2 * C * R;
      for (int n = 0; n < N; ++n) s += ds[(size_t)n * C + c];
      dbu[c] = s;
    } else {
      const int j = i - 2 * C * R - C;
      for (int n = 0; n < N; ++n) s += dz[(size_t)n * R + j];
      dbd[j] = s;
    }
  }
}

// Pass 3: h1 again, then dh1 = conv^T(dh2, w2) * [h1 > 0] on a TH x TW tile.
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

// Pass 4: dx = conv^T(dh1, w1) + dout on a TH x TW tile.
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

// Pass 5: weight gradient of one conv. Block (s, t, b): pixels
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

// out[i] = sum over s of part[s][i], in order.
__global__ void __launch_bounds__(kThreads)
rcab_bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int S, int M) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < M; i += gridDim.x * kThreads) {
    float s = 0.f;
    for (int q = 0; q < S; ++q) s += part[(size_t)q * M + i];
    out[i] = s;
  }
}

// The launch plan of the backward, decided here and nowhere else: the tile
// of passes 3 and 4 (the first whose conv work has a thread for every item
// and whose shared memory lets two blocks share an SM, else the first that
// fits an SM at all), the pixel splits of pass 5 and the chunks of pass 2.
struct Plan {
  int th, tw, smem;
  int splits, chunk;  // pass 5
  int J;              // pass 2
};

constexpr int kTiles[][2] = {{16, 16}, {8, 16}, {8, 8}, {4, 8}, {4, 4}};

cudaError_t make_plan(int dtype, int N, int H, int W, int C, Plan* p) {
  if ((dtype != 0 && dtype != 1) || C <= 0 || C % 8 || N <= 0 || H <= 0 || W <= 0)
    return cudaErrorInvalidValue;
  bool found = false;
  for (int limit : {kSmemTwoPerSm, kSmemMax}) {
    for (const auto& t : kTiles) {
      if ((t[0] * t[1] + kPM - 1) / kPM * (C / kCM) > kMaxIt * kThreads) continue;
      const int smem = (9 * kKC * C + (t[0] + 2) * (t[1] + 2) * (C + 1)) * (int)sizeof(float);
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
  const long long total = (long long)N * H * W;
  long long splits = total / 256;
  splits = splits < 1 ? 1 : (splits > kMaxSplits ? kMaxSplits : splits);
  long long chunk = (total + splits - 1) / splits;
  chunk = (chunk + kWK - 1) / kWK * kWK;
  p->chunk = (int)chunk;
  p->splits = (int)((total + chunk - 1) / chunk);
  p->J = (H * W + kDuPixels - 1) / kDuPixels;
  return cudaSuccess;
}

// Float32 scratch of one backward, in this order: the flipped weights
// (2 x 9CC elements of T, in float-sized slots), the dout * h2 chunk sums
// (N, J, C), dgap/HW, ds and gap (N, C each), the weight-gradient splits
// (2 x splits x 9CC) and bias splits (2 x splits x C), then dz and d (N, R
// each). C % 8 == 0 keeps every part but the last two 32-byte aligned.
struct Layout {
  long long wt, part_du, per_image, part_w, part_b, dz, total;
};

Layout make_layout(const Plan& p, int N, int C, int R) {
  Layout l;
  const long long cc = 9LL * C * C;
  l.wt = 0;
  l.part_du = l.wt + 2 * cc;
  l.per_image = l.part_du + (long long)N * p.J * C;
  l.part_w = l.per_image + 3LL * N * C;
  l.part_b = l.part_w + 2LL * p.splits * cc;
  l.dz = l.part_b + 2LL * p.splits * C;
  l.total = l.dz + 2LL * N * R;
  return l;
}

template <typename T>
cudaError_t run(const Plan& p, const Layout& l, const T* x, const T* w1, const float* b1,
                const T* w2, const float* wd, const float* bd, const float* wu,
                float res_scale, const T* dout, const float* h2, const float* fwd_partial,
                const float* gate, int n_tiles, T* dx, float* dw1, float* db1, float* dw2,
                float* db2, float* dwd, float* dbd, float* dwu, float* dbu, T* h1, T* dh1,
                float* ws, int N, int H, int W, int C, int R, cudaStream_t s) {
  static int done_dh1[kMaxDevices] = {};
  static int done_dx[kMaxDevices] = {};
  cudaError_t err = allow_smem(rcab_bwd_dh1_kernel<T>, p.smem, done_dh1);
  if (err != cudaSuccess) return err;
  err = allow_smem(rcab_bwd_dx_kernel<T>, p.smem, done_dx);
  if (err != cudaSuccess) return err;

  const int cc = 9 * C * C;
  T* w1t = reinterpret_cast<T*>(ws + l.wt);
  T* w2t = reinterpret_cast<T*>(ws + l.wt + cc);
  float* part_du = ws + l.part_du;
  float* dgap_hw = ws + l.per_image;
  float* ds = dgap_hw + (size_t)N * C;
  float* gap = ds + (size_t)N * C;
  float* part_w1 = ws + l.part_w;
  float* part_w2 = part_w1 + (size_t)p.splits * cc;
  float* part_b1 = ws + l.part_b;
  float* part_b2 = part_b1 + (size_t)p.splits * C;
  float* dz = ws + l.dz;
  float* d = dz + (size_t)N * R;
  const int HW = H * W;

  rcab_bwd_flip_kernel<T><<<(cc + kThreads - 1) / kThreads, kThreads, 0, s>>>(w1, w2, w1t, w2t, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int L = C < kThreads ? kThreads / C : 1;
  rcab_bwd_du_kernel<T><<<dim3(p.J, N), kThreads, L * C * sizeof(float), s>>>(
      dout, h2, part_du, HW, C, p.J);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rcab_bwd_gate_kernel<<<N, kThreads, (2 * C + 2 * R) * sizeof(float), s>>>(
      part_du, fwd_partial, gate, wd, bd, wu, res_scale, dgap_hw, ds, gap, dz, d, p.J, n_tiles,
      HW, C, R);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n_params = 2 * C * R + C + R;
  rcab_bwd_gate_params_kernel<<<(n_params + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      ds, gap, dz, d, dwd, dbd, dwu, dbu, N, C, R);
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
      x, dh1, gate, dgap_hw, res_scale, part_w1, part_b1, N, H, W, C, p.chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rcab_bwd_wgrad_kernel<T, true><<<wgrid, kThreads, 0, s>>>(
      h1, dout, gate, dgap_hw, res_scale, part_w2, part_b2, N, H, W, C, p.chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int wblocks = (cc + kThreads - 1) / kThreads;
  const int bblocks = (C + kThreads - 1) / kThreads;
  rcab_bwd_sum_kernel<<<wblocks, kThreads, 0, s>>>(part_w1, dw1, p.splits, cc);
  rcab_bwd_sum_kernel<<<wblocks, kThreads, 0, s>>>(part_w2, dw2, p.splits, cc);
  rcab_bwd_sum_kernel<<<bblocks, kThreads, 0, s>>>(part_b1, db1, p.splits, C);
  rcab_bwd_sum_kernel<<<bblocks, kThreads, 0, s>>>(part_b2, db2, p.splits, C);
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
// b1, wd (C,R), bd (R), wu (R,C): float32. h2 (N,H,W,C), fwd_partial
// (N, n_tiles, C) and gate (N,C): float32, as rcab_fused_forward left them
// in its workspace (rcab_fused_layout says where). Outputs dw1, dw2
// (9,C,C), db1, db2 (C), dwd (C,R), dbd (R), dwu (R,C), dbu (C): float32.
// workspace: at least what rcab_fused_backward_workspace gives, 16-byte
// aligned. Returns a cudaError_t (0 on success).
int rcab_fused_backward(int dtype, const void* x, const void* w1, const void* b1,
                        const void* w2, const void* wd, const void* bd, const void* wu,
                        float res_scale, const void* dout, const void* h2,
                        const void* fwd_partial, const void* gate, int n_tiles, void* dx,
                        void* dw1, void* db1, void* dw2, void* db2, void* dwd, void* dbd,
                        void* dwu, void* dbu, void* h1, void* dh1, void* workspace,
                        long long workspace_floats_given, int N, int H, int W, int C, int R,
                        void* stream) {
  Plan p;
  const cudaError_t err = make_plan(dtype, N, H, W, C, &p);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || n_tiles <= 0) return (int)cudaErrorInvalidValue;
  const Layout l = make_layout(p, N, C, R);
  if (workspace_floats_given < l.total) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(workspace) % 16) return (int)cudaErrorMisalignedAddress;
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  auto o = [](void* q) { return static_cast<float*>(q); };
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using T = float;
    return (int)run<T>(p, l, static_cast<const T*>(x), static_cast<const T*>(w1), f(b1),
                       static_cast<const T*>(w2), f(wd), f(bd), f(wu), res_scale,
                       static_cast<const T*>(dout), f(h2), f(fwd_partial), f(gate), n_tiles,
                       static_cast<T*>(dx), o(dw1), o(db1), o(dw2), o(db2), o(dwd), o(dbd),
                       o(dwu), o(dbu), static_cast<T*>(h1), static_cast<T*>(dh1),
                       o(workspace), N, H, W, C, R, s);
  }
  using T = __nv_bfloat16;
  return (int)run<T>(p, l, static_cast<const T*>(x), static_cast<const T*>(w1), f(b1),
                     static_cast<const T*>(w2), f(wd), f(bd), f(wu), res_scale,
                     static_cast<const T*>(dout), f(h2), f(fwd_partial), f(gate), n_tiles,
                     static_cast<T*>(dx), o(dw1), o(db1), o(dw2), o(db2), o(dwd), o(dbd),
                     o(dwu), o(dbu), static_cast<T*>(h1), static_cast<T*>(dh1), o(workspace),
                     N, H, W, C, R, s);
}

}  // extern "C"
