// Fused RCAB forward for Hopper (sm_90a), bound to Python over ctypes.
//
// Replaces rumpy_tpu/ops/pallas/rcab_fused.py::rcab_fused (the Pallas TPU
// kernel, body _rcab_kernel). One residual channel-attention block:
//
//   h1  = round_T(relu(conv3x3(x, w1) + b1))        zero outside the image
//   h2  = conv3x3(h1, w2) + b2                       f32
//   u   = sigmoid(relu(GAP(h2) . wd + bd) . wu + bu) per image, per channel
//   out = round_T(h2 * u * res_scale + x)
//
// with every accumulation in f32, T = float or bf16 (the activation type).
//
// Bound on an H100 SXM: at the eval shape (1,128,128,64) the block does
// 2 * 2*H*W*C*C*9 = 2.42 GFLOP and must move x in and out (4.2 MB in bf16),
// so it is bound by operations (2.4 us at 989 TFLOP/s bf16, 36 us at
// 67 TFLOP/s for exact f32). In bf16 with C in {16, 32, 64, 128} the convs
// run on the tensor cores (mma.sync, f32 accumulate); f32, and other C, run
// on the CUDA cores in f32 (exact products for bf16 inputs). The tensor-core
// convs take their weights a tap at a time through cp.async, under the mma
// of the tap before; wgmma and TMA are later work.
//
// Design. The TPU kernel holds one whole image in VMEM, so its global
// average pool is local. A block here has at most 227 KB of shared memory,
// so the image is tiled in space and the pool becomes a reduction across
// blocks, done in three launches on one stream:
//   1. rcab_conv_kernel or rcab_conv_mma_kernel, one block per (tile, image): loads the x tile with a
//      2-pixel halo, computes h1 on a 1-pixel halo (set to 0 outside the
//      image, as SAME padding of conv2 requires), then h2 on the tile; writes
//      h2 (f32) and the tile's per-channel sum of h2 over in-image pixels.
//   2. rcab_gate_kernel, one block per image: sums the tile partials in a
//      fixed order (no float atomics, so the result does not depend on the
//      schedule or on which images share a batch) and computes the gate u.
//   3. rcab_apply_kernel: out = h2 * u * res_scale + x, rounded to T.
// The CUDA-core conv pass is a direct convolution from shared memory: a
// thread owns kPM pixels x kCM output channels, weights are staged kKC
// input channels at a time for all 9 taps, and h1 reuses the x tile's
// shared memory once conv1 has read it (its accumulators wait in registers
// across the barrier). The tensor-core pass is described above its kernel.
// Ragged images are masked at every edge.

#include <initializer_list>

#include "rcab_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
rcab_conv_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                 const float* __restrict__ b1, const T* __restrict__ w2,
                 const float* __restrict__ b2, float* __restrict__ h2,
                 float* __restrict__ partial, int H, int W, int C, int TH, int TW) {
  extern __shared__ __align__(16) float smem[];
  const int SP = C + 1;  // odd pixel stride: neighbouring pixels on distinct banks
  float* w_s = smem;                 // 9 * kKC * C
  float* x_s = smem + 9 * kKC * C;   // (TH+4) * (TW+4) * SP; later h1, then sums
  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * TH;
  const int tx0 = blockIdx.x * TW;
  const int XH = TH + 4, XW = TW + 4;
  const int H1H = TH + 2, H1W = TW + 2;

  // x tile with a 2-pixel halo, zero outside the image
  const T* xn = x + (size_t)n * H * W * C;
  for (int i = threadIdx.x; i < XH * XW * C; i += kThreads) {
    const int p = i / C;
    const int c = i - p * C;
    const int gy = ty0 - 2 + p / XW;
    const int gx = tx0 - 2 + p % XW;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = to_f(xn[((size_t)gy * W + gx) * C + c]);
    x_s[p * SP + c] = v;
  }

  float acc[kMaxIt][kPM][kCM];

  // conv1 on the (TH+2) x (TW+2) halo region
  conv3x3_smem<T>(x_s, XW, H1H, H1W, C, SP, w1, w_s, acc);
  __syncthreads();  // every thread has finished reading x_s: h1 overwrites it
  {
    const int P = H1H * H1W;
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
        const int oy = p / H1W, ox = p % H1W;
        const int gy = ty0 - 1 + oy, gx = tx0 - 1 + ox;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        float* dst = x_s + (oy * H1W + ox) * SP + c0;
#pragma unroll
        for (int j = 0; j < kCM; ++j) {
          const float v = fmaxf(acc[it][k][j] + b1[c0 + j], 0.f);
          dst[j] = inside ? to_f(from_f<T>(v)) : 0.f;  // rounded to T, as in the TPU kernel
        }
      }
    }
  }

  // conv2 on the TH x TW tile (its first barrier publishes h1)
  conv3x3_smem<T>(x_s, H1W, TH, TW, C, SP, w2, w_s, acc);
  __syncthreads();  // h1 is read: the sums table reuses x_s
  float* sums = x_s;  // G2 x C, one row per pixel group
  const int P2 = TH * TW;
  const int G2 = (P2 + kPM - 1) / kPM;
  {
    const int n_items = G2 * (C / kCM);
    float* h2n = h2 + (size_t)n * H * W * C;
#pragma unroll
    for (int it = 0; it < kMaxIt; ++it) {
      const int item = it * kThreads + threadIdx.x;
      if (item >= n_items) continue;
      const int g = item % G2;
      const int c0 = (item / G2) * kCM;
      float s[kCM];
#pragma unroll
      for (int j = 0; j < kCM; ++j) s[j] = 0.f;
#pragma unroll
      for (int k = 0; k < kPM; ++k) {
        const int p = g + G2 * k;
        if (p >= P2) continue;
        const int gy = ty0 + p / TW, gx = tx0 + p % TW;
        if (gy >= H || gx >= W) continue;
        float v[kCM];
#pragma unroll
        for (int j = 0; j < kCM; ++j) {
          v[j] = acc[it][k][j] + b2[c0 + j];
          s[j] += v[j];
        }
        float4* dst = reinterpret_cast<float4*>(h2n + ((size_t)gy * W + gx) * C + c0);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
#pragma unroll
      for (int j = 0; j < kCM; ++j) sums[g * C + c0 + j] = s[j];
    }
  }
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  float* pn = partial + ((size_t)n * gridDim.x * gridDim.y + tile) * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f;
    for (int g = 0; g < G2; ++g) s += sums[g * C + c];  // fixed order
    pn[c] = s;
  }
}

// ---------------------------------------------------------------------------
// bf16 conv pass on the tensor cores (mma.sync m16n8k16, f32 accumulate),
// for C = 8 * NT in {16, 32, 64, 128}. Same contract as rcab_conv_kernel.
// Each conv is an implicit GEMM per 3x3 tap: M = output pixels of the
// region (16 a warp tile, any 16 pixels: ldmatrix takes one row address a
// lane), N = C output channels, K = C input channels. Activations live in
// shared memory as bf16 [pixel][C + 8] (the pad keeps ldmatrix rows on
// distinct banks), weights one tap at a time as bf16 [cin][cout + 8] in two
// buffers, copied by cp.async under the tap before and read with
// ldmatrix.trans.
// A warp owns up to kMmaAcc / (4 * NT) m-tiles with all NT n-tiles. The
// conv routine itself (conv3x3_mma) is in rcab_common.cuh.
// ---------------------------------------------------------------------------

template <int NT>
__global__ void __launch_bounds__(kThreads)
rcab_conv_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
                     const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ h2,
                     float* __restrict__ partial, int H, int W, int TH, int TW) {
  constexpr int C = NT * 8;
  constexpr int MU = kMmaAcc / (4 * NT);
  constexpr int SP = C + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int XH = TH + 4, XW = TW + 4;
  const int H1H = TH + 2, H1W = TW + 2;
  const int x_bytes = XH * XW * SP * 2;
  const int h2_bytes = TH * TW * C * 4;
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* h2_s = reinterpret_cast<float*>(smem_raw);  // after conv1, over x_s
  __nv_bfloat16* h1_s = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + (x_bytes > h2_bytes ? x_bytes : h2_bytes));
  __nv_bfloat16* w_s = h1_s + H1H * H1W * SP;
  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  conv_stage_tap<NT, false>(w1, 0, w_s);  // arrives while the x tile is loaded
  // x tile with a 2-pixel halo, zero outside the image, 8 channels a load
  const __nv_bfloat16* xn = x + (size_t)n * H * W * C;
  for (int i = threadIdx.x; i < XH * XW * (C / 8); i += kThreads) {
    const int p = i / (C / 8), c8 = (i % (C / 8)) * 8;
    const int gy = ty0 - 2 + p / XW, gx = tx0 - 2 + p % XW;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = *reinterpret_cast<const uint4*>(xn + ((size_t)gy * W + gx) * C + c8);
    *reinterpret_cast<uint4*>(x_s + p * SP + c8) = v;
  }

  float acc[MU][NT][4];
  const int r0 = lane >> 2, cq = (lane & 3) * 2;

  // conv1 on the halo region -> h1 (bf16, zero outside the image)
  conv3x3_mma<NT, false>(x_s, XW, H1H, H1W, SP, w1, w_s, 0, w2, acc);
  {
    const int M = H1H * H1W;
#pragma unroll
    for (int u = 0; u < MU; ++u) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = (warp + 8 * u) * 16 + r0 + 8 * half;
        if (m >= M) continue;
        const int gy = ty0 - 1 + m / H1W, gx = tx0 - 1 + m % H1W;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int co = j * 8 + cq;
          const float v0 = fmaxf(acc[u][j][2 * half] + b1[co], 0.f);
          const float v1 = fmaxf(acc[u][j][2 * half + 1] + b1[co + 1], 0.f);
          *reinterpret_cast<__nv_bfloat162*>(h1_s + m * SP + co) =
              inside ? __floats2bfloat162_rn(v0, v1) : __floats2bfloat162_rn(0.f, 0.f);
        }
      }
    }
  }

  // conv2 on the tile (its first barrier publishes h1 and ends conv1's
  // reads of x_s, so h2_s may then overwrite it)
  conv3x3_mma<NT, false>(h1_s, H1W, TH, TW, SP, w2, w_s, 1, nullptr, acc);
  {
    const int M = TH * TW;
#pragma unroll
    for (int u = 0; u < MU; ++u) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = (warp + 8 * u) * 16 + r0 + 8 * half;
        if (m >= M) continue;
        const bool inside = ty0 + m / TW < H && tx0 + m % TW < W;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int co = j * 8 + cq;
          float2 v = make_float2(0.f, 0.f);
          if (inside) v = make_float2(acc[u][j][2 * half] + b2[co], acc[u][j][2 * half + 1] + b2[co + 1]);
          *reinterpret_cast<float2*>(h2_s + m * C + co) = v;
        }
      }
    }
  }
  __syncthreads();
  float* h2n = h2 + (size_t)n * H * W * C;
  for (int i = threadIdx.x; i < TH * TW * (C / 4); i += kThreads) {
    const int p = i / (C / 4), c4 = (i % (C / 4)) * 4;
    const int gy = ty0 + p / TW, gx = tx0 + p % TW;
    if (gy < H && gx < W)
      *reinterpret_cast<float4*>(h2n + ((size_t)gy * W + gx) * C + c4) =
          *reinterpret_cast<const float4*>(h2_s + p * C + c4);
  }
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  float* pn = partial + ((size_t)n * gridDim.x * gridDim.y + tile) * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f;
    for (int p = 0; p < TH * TW; ++p) s += h2_s[p * C + c];  // fixed order; 0 outside
    pn[c] = s;
  }
}

// One block per image: GAP from the tile partials, then the C -> R -> C
// squeeze-excitation gate. Each channel's tiles are split over S threads
// (tiles s, s+S, ...) and the S sums added in order: a fixed order, so the
// gate of an image does not depend on the schedule or its batch.
__global__ void __launch_bounds__(kThreads)
rcab_gate_kernel(const float* __restrict__ partial, const float* __restrict__ wd,
                 const float* __restrict__ bd, const float* __restrict__ wu,
                 const float* __restrict__ bu, float* __restrict__ gate,
                 int n_tiles, int HW, int C, int R) {
  extern __shared__ float gsm[];
  const int S = C < kThreads ? kThreads / C : 1;
  float* part = gsm;      // S * C
  float* gap = gsm + S * C;  // C
  float* d = gap + C;     // R
  const int n = blockIdx.x;
  const float* pn = partial + (size_t)n * n_tiles * C;
  for (int i = threadIdx.x; i < S * C; i += kThreads) {
    const int c = i % C, s0 = i / C;
    float s = 0.f;
    int t = s0;
    for (; t + 7 * S < n_tiles; t += 8 * S) {  // 8 loads in flight, added in order
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = pn[(size_t)(t + k * S) * C + c];
#pragma unroll
      for (int k = 0; k < 8; ++k) s += v[k];
    }
    for (; t < n_tiles; t += S) s += pn[(size_t)t * C + c];
    part[i] = s;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f;
    for (int k = 0; k < S; ++k) s += part[k * C + c];
    gap[c] = s / (float)HW;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < R; j += kThreads) {
    float s = 0.f;
    for (int c = 0; c < C; ++c) s = fmaf(gap[c], wd[c * R + j], s);
    d[j] = fmaxf(s + bd[j], 0.f);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f;
    for (int j = 0; j < R; ++j) s = fmaf(d[j], wu[j * C + c], s);
    gate[(size_t)n * C + c] = 1.f / (1.f + expf(-(s + bu[c])));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rcab_apply_kernel(const T* __restrict__ x, const float* __restrict__ h2,
                  const float* __restrict__ gate, float res_scale, T* __restrict__ out,
                  long long total, int HWC, int C) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total; i += stride) {
    const int n = (int)(i / HWC);
    const int c = (int)(i % C);
    const float v = h2[i] * gate[(size_t)n * C + c] * res_scale + to_f(x[i]);
    out[i] = from_f<T>(v);
  }
}

// The conv pass's launch plan, decided here and nowhere else: tensor cores
// or not, the output tile TH x TW and its dynamic shared memory. Tiles are
// tried in order; the first whose conv work has a thread for every item
// (the kernels drop items past their budget) and whose shared memory lets
// two blocks share an SM wins, else the first that fits an SM at all.
struct Plan {
  bool mma;
  int th, tw, smem;
};

constexpr int kTiles[][2] = {{16, 16}, {8, 16}, {8, 8}, {4, 8}, {4, 4}};

int conv_smem(bool mma, int C, int TH, int TW) {
  if (mma) {
    const int SP = C + 8;
    const int x_bytes = (TH + 4) * (TW + 4) * SP * 2;
    const int h2_bytes = TH * TW * C * 4;
    return (x_bytes > h2_bytes ? x_bytes : h2_bytes) + (TH + 2) * (TW + 2) * SP * 2 +
           2 * C * SP * 2;
  }
  return (9 * kKC * C + (TH + 4) * (TW + 4) * (C + 1)) * (int)sizeof(float);
}

// conv1's halo region is the larger of the two convs' output regions
bool conv_has_threads(bool mma, int C, int TH, int TW) {
  const int halo = (TH + 2) * (TW + 2);
  if (mma) return (halo + 15) / 16 <= (kThreads / 32) * (kMmaAcc / (4 * (C / 8)));
  return (halo + kPM - 1) / kPM * (C / kCM) <= kMaxIt * kThreads;
}

cudaError_t make_plan(int dtype, int C, Plan* p) {
  if ((dtype != 0 && dtype != 1) || C <= 0 || C % 8) return cudaErrorInvalidValue;
  p->mma = dtype == 1 && (C == 16 || C == 32 || C == 64 || C == 128);
  for (int limit : {kSmemTwoPerSm, kSmemMax}) {
    for (const auto& t : kTiles) {
      if (!conv_has_threads(p->mma, C, t[0], t[1])) continue;
      const int smem = conv_smem(p->mma, C, t[0], t[1]);
      if (smem > limit) continue;
      p->th = t[0];
      p->tw = t[1];
      p->smem = smem;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidConfiguration;  // C too large for one block
}

// Float32 scratch of one forward: h2 (N,H,W,C), then the per-tile sums
// (N, tiles, C), then the gate (N,C); C % 8 == 0 keeps each 32-byte aligned.
long long workspace_floats(const Plan& p, int N, int H, int W, int C) {
  const long long tiles = (long long)((H + p.th - 1) / p.th) * ((W + p.tw - 1) / p.tw);
  return (long long)N * C * ((long long)H * W + tiles + 1);
}

template <typename T>
cudaError_t conv_fma(const void* x, const void* w1, const float* b1, const void* w2,
                     const float* b2, float* h2, float* partial, int H, int W, int C,
                     int TH, int TW, int smem, dim3 grid, cudaStream_t stream) {
  static int done[kMaxDevices] = {};
  cudaError_t err = allow_smem(rcab_conv_kernel<T>, smem, done);
  if (err != cudaSuccess) return err;
  rcab_conv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2,
      h2, partial, H, W, C, TH, TW);
  return cudaGetLastError();
}

template <int NT>
cudaError_t conv_mma(const void* x, const void* w1, const float* b1, const void* w2,
                     const float* b2, float* h2, float* partial, int H, int W, int TH,
                     int TW, int smem, dim3 grid, cudaStream_t stream) {
  static int done[kMaxDevices] = {};
  cudaError_t err = allow_smem(rcab_conv_mma_kernel<NT>, smem, done);
  if (err != cudaSuccess) return err;
  using B = const __nv_bfloat16*;
  rcab_conv_mma_kernel<NT><<<grid, kThreads, smem, stream>>>(
      static_cast<B>(x), static_cast<B>(w1), b1, static_cast<B>(w2), b2, h2, partial, H, W,
      TH, TW);
  return cudaGetLastError();
}

cudaError_t conv(int dtype, const Plan& p, const void* x, const void* w1, const float* b1,
                 const void* w2, const float* b2, float* h2, float* partial, int H, int W,
                 int C, dim3 grid, cudaStream_t s) {
  const int TH = p.th, TW = p.tw, sm = p.smem;
  if (p.mma) {
    switch (C) {
      case 16: return conv_mma<2>(x, w1, b1, w2, b2, h2, partial, H, W, TH, TW, sm, grid, s);
      case 32: return conv_mma<4>(x, w1, b1, w2, b2, h2, partial, H, W, TH, TW, sm, grid, s);
      case 64: return conv_mma<8>(x, w1, b1, w2, b2, h2, partial, H, W, TH, TW, sm, grid, s);
      case 128: return conv_mma<16>(x, w1, b1, w2, b2, h2, partial, H, W, TH, TW, sm, grid, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 0)
    return conv_fma<float>(x, w1, b1, w2, b2, h2, partial, H, W, C, TH, TW, sm, grid, s);
  return conv_fma<__nv_bfloat16>(x, w1, b1, w2, b2, h2, partial, H, W, C, TH, TW, sm, grid, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Sets *floats to the float32 workspace
// that rcab_fused_forward needs for an (N,H,W,C) input. Returns a
// cudaError_t (0 on success; cudaErrorInvalidConfiguration if C channels
// do not fit one block).
int rcab_fused_workspace(int dtype, int N, int H, int W, int C, long long* floats) {
  Plan p;
  const cudaError_t err = make_plan(dtype, C, &p);
  if (err == cudaSuccess) *floats = workspace_floats(p, N, H, W, C);
  return (int)err;
}

// Where rcab_fused_forward leaves its intermediates in the workspace, for
// the backward pass: layout[0] is the float offset of the per-tile channel
// sums of h2 (N, tiles, C), layout[1] that of the gate (N, C), layout[2]
// the number of tiles an image; h2 (N,H,W,C) is at offset 0.
int rcab_fused_layout(int dtype, int N, int H, int W, int C, long long* layout) {
  Plan p;
  const cudaError_t err = make_plan(dtype, C, &p);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((H + p.th - 1) / p.th) * ((W + p.tw - 1) / p.tw);
  layout[0] = (long long)N * H * W * C;
  layout[1] = layout[0] + (long long)N * tiles * C;
  layout[2] = tiles;
  return 0;
}

// dtype as above. x, out: (N,H,W,C) contiguous in that type; w1, w2:
// (9,C,C) tap-major in that type; b1, b2, wd (C,R), bd (R), wu (R,C), bu
// (C) in float32; workspace: `workspace_floats` float32, at least what
// rcab_fused_workspace gives. The tensor-core pass (bf16, C in {16, 32,
// 64, 128}) needs x, w1 and w2 on 16-byte boundaries. Returns a
// cudaError_t (0 on success).
int rcab_fused_forward(int dtype, const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, const void* wd, const void* bd,
                       const void* wu, const void* bu, float res_scale, void* out,
                       void* workspace, long long workspace_floats_given, int N, int H,
                       int W, int C, int R, void* stream) {
  Plan p;
  cudaError_t err = make_plan(dtype, C, &p);
  if (err != cudaSuccess) return (int)err;
  if (workspace_floats_given < workspace_floats(p, N, H, W, C)) return cudaErrorInvalidValue;
  if (p.mma && (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1) |
                reinterpret_cast<uintptr_t>(w2)) % 16)
    return cudaErrorMisalignedAddress;
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + p.tw - 1) / p.tw, (H + p.th - 1) / p.th, N);
  float* h2f = static_cast<float*>(workspace);
  float* pf = h2f + (size_t)N * H * W * C;
  float* gf = pf + (size_t)N * grid.x * grid.y * C;
  err = conv(dtype, p, x, w1, f(b1), w2, f(b2), h2f, pf, H, W, C, grid, s);
  if (err != cudaSuccess) return (int)err;
  const int gate_smem = ((C < kThreads ? kThreads / C : 1) * C + C + R) * sizeof(float);
  rcab_gate_kernel<<<N, kThreads, gate_smem, s>>>(
      pf, f(wd), f(bd), f(wu), f(bu), gf, grid.x * grid.y, H * W, C, R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)N * H * W * C;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (dtype == 0)
    rcab_apply_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), h2f, gf, res_scale, static_cast<float*>(out), total,
        H * W * C, C);
  else
    rcab_apply_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), h2f, gf, res_scale,
        static_cast<__nv_bfloat16*>(out), total, H * W * C, C);
  return (int)cudaGetLastError();
}

// The name of a cudaError_t returned above, for error messages.
const char* rcab_fused_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
