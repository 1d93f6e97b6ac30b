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
// A QRCAB (rumpy_tpu/models/attention_manipulators.py) is the same block
// with per-image gate inputs: its metadata enters as bd[n] (R) or bu[n] (C),
// and its q-layer gate as a channel scale s[n, c] in place of res_scale,
// out = round_T((h2 * u) * s[n, c] + x).
//
// Bound on an H100 SXM: the block does 2 * 2*N*H*W*C*C*9 operations and
// must move x in and out, so it is bound by operations: 5.44 GFLOP at the
// train shape (16,48,48,64), 5.5 us at 989 TFLOP/s bf16; 2.42 GFLOP, 2.4 us,
// at the eval shape (1,128,128,64). In float32 the products must keep f32's
// accuracy: the better of the CUDA cores (67 TFLOP/s) and 3xTF32 on the
// tensor cores (495 / 3 TFLOP/s), 0.033 ms at the train shape. With C in
// {16, 32, 64, 128} the convs run on the tensor cores: bf16 on mma.sync
// m16n8k16, float32 in 3xTF32 on m16n8k8 (each operand split into two tf32
// halves, three products summed in f32: rcab_common.cuh), both with f32
// accumulation; other C run on the CUDA cores in f32 (exact products for
// bf16 inputs). wgmma (through TMA's im2col mode) is later work.
//
// Design. The TPU kernel holds one whole image in VMEM, so its global
// average pool is local. A block here has at most 227 KB of shared memory,
// so the image is tiled in space and the pool becomes a reduction across
// blocks: the pass that computes h2 writes one row of per-channel sums for
// each output tile (or unit) it computes, and the apply pass adds an image's
// rows in one fixed order (no float atomics: the result does not depend on
// the schedule or on which images share a batch; two runs give the same
// bits).
//
// Tensor-core plan (bf16 and float32), three launches on one stream:
//   1. rcab_conv1_mma_kernel: h1 = round(relu(conv(x, w1) + b1)) into the
//      `out` buffer (the apply pass overwrites it last), in-image pixels only;
//      in float32 h1 stays f32.
//   2. rcab_conv2_mma_kernel: h2 = conv(h1, w2) + b2 (f32) and the tile sums;
//      h1 is read with masked loads, zero outside the image (SAME padding).
//   3. rcab_apply_kernel: the gate, then out = h2 * u * res_scale + x.
// Each conv pass is an implicit GEMM whose M (pixels) splits freely, so
// no halo is computed twice. Its work unit is one warp's: a 2*MU x 8 pixel
// tile of one image for CB output channels (CB = C, or 32 at C = 128), read
// from device memory (mostly L2) with its 1-pixel halo by cp.async into the
// warp's own shared buffer; MU m-tiles share each B fragment. Blocks are
// persistent, at most one an SM: a block stages its slice's weights for all
// 9 taps once and its warps walk units in a fixed stride, warp-major so
// that the units spread over the SMs first. Float32 doubles every byte in
// shared memory: a slice of 32 output channels at C >= 64 (9 x 64 x 36
// floats of weights, 83 KB), MU = 2 at most (eight 6 x 10-pixel tiles of 72
// floats a pixel, 138 KB), and the warps a block capped by what fits; its
// B fragments are split once a k-step and shared by the MU m-tiles, its A
// fragments by the slice's n-tiles. conv1 starts its first unit
// when the first third of its taps has landed (three barriers, in the first
// unit only); after that a warp syncs only with itself. The plan
// (make_plan) picks MU and the number of blocks and warps from the SM
// count, so that the grid covers the SMs. Passes 2 and 3 are programmatic
// dependents of the pass before: their blocks start as that one's retire,
// conv2 staging its weights and apply its x before they wait for it.
// CUDA-core plan (C outside {16, 32, 64, 128}, bf16 and f32), two launches:
//   1. rcab_conv_kernel, one block per (tile, image): loads the x tile with
//      a 2-pixel halo, computes h1 on a 1-pixel halo (set to 0 outside the
//      image, as SAME padding of conv2 requires), then h2 on the tile;
//      writes h2 (f32) and the tile's sums. A direct convolution from
//      shared memory: a thread owns kPM pixels x kCM output channels,
//      weights are staged kKC input channels at a time for all 9 taps, and
//      h1 reuses the x tile's shared memory once conv1 has read it.
//   2. rcab_apply_kernel, as above.
// The apply pass is one grid of blocks per image, at most two blocks an SM
// in all: every block computes its image's gate from the tile sums with the
// same code in the same order (so all get the same bits) and the first
// writes it to the workspace for the backward; then it reads h2 and x 16
// bytes a thread. Ragged images are masked at every edge.

#include <initializer_list>

#include "rcab_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Programmatic dependent launch (Hopper): a kernel launched with
// launch_after() may start while the kernel before it on the stream still
// runs, once every block of that one has called allow_next() or exited;
// wait_prior() then waits until it has completed and its writes are
// visible. A kernel launched without the attribute starts as usual and its
// wait_prior() returns at once.
__device__ __forceinline__ void allow_next() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_prior() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

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
// Tensor-core conv passes (C in {16, 32, 64, 128}): bf16 on mma.sync
// m16n8k16, float32 in 3xTF32 on m16n8k8 (rcab_common.cuh).
// A unit is 2*MU x 8 output pixels of one image (MU m-tiles of 16 pixels:
// two rows of 8) by the CB output channels of the block's slice
// (blockIdx.y). Shared memory: the slice's weights [9][C][CB + pad], then one
// input tile [(2*MU + 2) * 10][C + 8] a warp (the pads keep a warp's
// fragment loads on distinct banks: bf16 rows through ldmatrix, float32
// weights as two floats a lane at rows 2t, 2t + 1, f32 activations as one
// float2 a lane).
// ---------------------------------------------------------------------------

constexpr int kUnitW = 8;

// Row pad of the staged weights, in elements.
template <typename T>
__host__ __device__ constexpr int weight_pad() {
  return sizeof(T) == 2 ? 8 : 4;
}

template <typename T>
constexpr int mma_smem(int C, int CB, int TH, int warps) {
  return (9 * C * (CB + weight_pad<T>()) + warps * (TH + 2) * (kUnitW + 2) * (C + 8)) *
         (int)sizeof(T);
}

// Tap t of one unit into acc: per k-step of 16 input channels, the B
// fragments of the slice's n-tiles once, then each m-tile's A.
template <int C, int CB, int MU>
__device__ __forceinline__ void mma_tap(int t, float (&acc)[MU][CB / 8][4], const bf16* t_s,
                                        const int (&rowoff)[MU], const bf16* wl) {
  constexpr int NB = CB / 8, IW = kUnitW + 2, SP = C + 8, SPW = CB + 8;
  const int toff = ((t / 3) * IW + t % 3) * SP;
  const bf16* wt = wl + t * C * SPW;
#pragma unroll
  for (int k0 = 0; k0 < C; k0 += 16) {
    uint32_t bf[NB / 2][4];
#pragma unroll
    for (int j = 0; j < NB; j += 2) ldmatrix_x4_trans(bf[j / 2], wt + k0 * SPW + j * 8);
#pragma unroll
    for (int mu = 0; mu < MU; ++mu) {
      uint32_t a[4];
      ldmatrix_x4(a, t_s + rowoff[mu] + toff + k0);
#pragma unroll
      for (int j = 0; j < NB; j += 2) {
        mma_bf16(acc[mu][j], a, bf[j / 2][0], bf[j / 2][1]);
        mma_bf16(acc[mu][j + 1], a, bf[j / 2][2], bf[j / 2][3]);
      }
    }
  }
}

// The same in float32, 3xTF32: per k-step of 8 input channels (k t, t + 4 at
// channels 2t, 2t + 1), the split B fragments of the slice's n-tiles once,
// then each m-tile's A (row g of m-tile mu is pixel (2mu, g), row g + 8
// pixel (2mu + 1, g): one tile row further).
template <int C, int CB, int MU>
__device__ __forceinline__ void mma_tap(int t, float (&acc)[MU][CB / 8][4], const float* t_s,
                                        const int (&rowoff)[MU], const float* wl) {
  constexpr int NB = CB / 8, IW = kUnitW + 2, SP = C + 8, SPW = CB + 4;
  const int toff = ((t / 3) * IW + t % 3) * SP;
  const float* wt = wl + t * C * SPW;
#pragma unroll 2
  for (int k0 = 0; k0 < C; k0 += 8) {
    Tf32B b[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) split_b(b[j], wt[k0 * SPW + j * 8], wt[(k0 + 1) * SPW + j * 8]);
#pragma unroll
    for (int mu = 0; mu < MU; ++mu) {
      const float* p = t_s + rowoff[mu] + toff + k0;
      Tf32A a;
      split_a(a, *reinterpret_cast<const float2*>(p),
              *reinterpret_cast<const float2*>(p + IW * SP));
#pragma unroll
      for (int j = 0; j < NB; ++j) mma_3xtf32(acc[mu][j], a, b[j]);
    }
  }
}

// Taps [T0, T1). Unrolled for MU <= 2; at MU = 4 (128 accumulators) the
// unrolled taps need more than 255 registers and spill, and the loop is
// faster (measured on an H100: PERF.md, section 6). Float32 loops always:
// its taps are three times the mma.
template <int C, int CB, int MU, int T0, int T1, typename T>
__device__ __forceinline__ void mma_taps(float (&acc)[MU][CB / 8][4], const T* t_s,
                                         const int (&rowoff)[MU], const T* wl) {
  if constexpr (MU >= 4 || sizeof(T) == 4) {
#pragma unroll 1
    for (int t = T0; t < T1; ++t) mma_tap<C, CB, MU>(t, acc, t_s, rowoff, wl);
  } else {
#pragma unroll
    for (int t = T0; t < T1; ++t) mma_tap<C, CB, MU>(t, acc, t_s, rowoff, wl);
  }
}

// conv1 stages its weights in kConv1TapGroups cp.async groups of taps and
// starts its first unit on the first group while the rest land; conv2's
// weights land in one group under the end of conv1.
constexpr int kConv1TapGroups = 3;

template <typename T, int C, int CB, int MU, bool CONV2>
__device__ __forceinline__ void conv_mma_pass(
    const T* in, const T* __restrict__ w, const float* __restrict__ bias,
    T* __restrict__ h1, float* __restrict__ h2, float* __restrict__ partial, int N, int H,
    int W, int tiles_x, int tiles) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int E = 16 / sizeof(T);  // elements a 16-byte copy
  constexpr int NB = CB / 8;         // n-tiles of the slice
  constexpr int TH = 2 * MU;
  constexpr int IH = TH + 2, IW = kUnitW + 2;
  constexpr int SP = C + 8;          // input tile: pixel stride
  constexpr int SPW = CB + weight_pad<T>();  // weights: row stride
  constexpr int G = CONV2 ? 1 : kConv1TapGroups;
  static_assert(9 % G == 0, "tap groups split the 9 taps evenly");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w_s = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  T* t_s = w_s + 9 * C * SPW + warp * IH * IW * SP;
  const int cs0 = blockIdx.y * CB;
  const int units = N * tiles;
  const int first = warp * gridDim.x + blockIdx.x;  // warp-major: SMs first
  const int stride = gridDim.x * nwarps;

  // a unit's input tile with its 1-pixel halo, zero outside the image
  auto load_tile = [&](int u) {
    const int n = u / tiles, t = u - n * tiles;
    const int ty0 = (t / tiles_x) * TH - 1, tx0 = (t % tiles_x) * kUnitW - 1;
    const T* inn = in + (size_t)n * H * W * C;
    for (int i = lane; i < IH * IW * (C / E); i += 32) {
      const int p = i / (C / E), ce = (i % (C / E)) * E;
      const int gy = ty0 + p / IW, gx = tx0 + p % IW;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async16(t_s + p * SP + ce, ok ? inn + ((size_t)gy * W + gx) * C + ce : in, ok);
    }
    cp_async_commit();
  };
  // taps [g * 9/G, (g+1) * 9/G) of the slice's weights ([t][ci] rows)
  auto stage_taps = [&](int g) {
    const int rows = 9 / G * C;
    for (int i = threadIdx.x; i < rows * (CB / E); i += blockDim.x) {
      const int row = g * rows + i / (CB / E), ce = (i % (CB / E)) * E;
      cp_async16(w_s + row * SPW + ce, w + (size_t)row * C + cs0 + ce, true);
    }
    cp_async_commit();
  };

  allow_next();  // the next pass may stage its weights as blocks of this one retire
  // Weights once a block. conv1: the first tile, then the tap groups, so
  // that waiting for all but the last k groups has the tile and the first
  // G - k groups. conv2: its weights (written before conv1 began) under
  // the end of conv1, then the wait for h1, then the tile.
  if constexpr (CONV2) {
    stage_taps(0);
    wait_prior();  // h1 is complete; out and the workspace free
  }
  if (first < units) load_tile(first);
  if constexpr (!CONV2)
    for (int g = 0; g < G; ++g) stage_taps(g);

  const int r0 = lane >> 2, cq = (lane & 3) * 2;
  float b[NB][2];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    b[j][0] = bias[cs0 + j * 8 + cq];
    b[j][1] = bias[cs0 + j * 8 + cq + 1];
  }
  // bf16: lane's A row (pixel (2mu + (lane&15)/8, lane&7), k half lane/16)
  // and B row (k row of the .trans ldmatrix of n-tile pair (j, j+1)).
  // float32: lane's A pair (pixel (2mu, r0), channels cq, cq + 1) and B
  // rows cq, cq + 1 at column r0.
  int rowoff[MU];
#pragma unroll
  for (int mu = 0; mu < MU; ++mu)
    rowoff[mu] = F32 ? ((2 * mu) * IW + r0) * SP + cq
                     : ((2 * mu + ((lane & 15) >> 3)) * IW + (lane & 7)) * SP + (lane >> 4) * 8;
  const T* wl = F32 ? w_s + cq * SPW + r0
                    : w_s + ((lane & 7) + ((lane >> 3) & 1) * 8) * SPW + (lane >> 4) * 8;

  float acc[MU][NB][4];
  auto zero = [&]() {
#pragma unroll
    for (int mu = 0; mu < MU; ++mu)
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mu][j][q] = 0.f;
  };
  zero();
  // the first unit, a tap group a barrier (every warp takes the barriers)
  const bool has = first < units;
  if constexpr (G == 3) {
    cp_async_wait<2>();
    __syncthreads();
    if (has) mma_taps<C, CB, MU, 0, 3>(acc, t_s, rowoff, wl);
    cp_async_wait<1>();
    __syncthreads();
    if (has) mma_taps<C, CB, MU, 3, 6>(acc, t_s, rowoff, wl);
    cp_async_wait<0>();
    __syncthreads();
    if (has) mma_taps<C, CB, MU, 6, 9>(acc, t_s, rowoff, wl);
  } else {
    static_assert(G == 1, "1 or 3 tap groups");
    cp_async_wait<0>();
    __syncthreads();
    if (has) mma_taps<C, CB, MU, 0, 9>(acc, t_s, rowoff, wl);
  }

  for (int u = first; u < units; u += stride) {
    if (u != first) {
      __syncwarp();  // every lane has finished reading the last tile
      load_tile(u);
      cp_async_wait<0>();
      __syncwarp();
      zero();
      mma_taps<C, CB, MU, 0, 9>(acc, t_s, rowoff, wl);
    }

    // epilogue: C-fragment row r0 + 8*half of m-tile mu is pixel
    // (2mu + half, r0) of the unit
    const int n = u / tiles, t = u - n * tiles;
    const int ty0 = (t / tiles_x) * TH, gx = (t % tiles_x) * kUnitW + r0;
    float s[NB][2];
#pragma unroll
    for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = 0.f;
#pragma unroll
    for (int mu = 0; mu < MU; ++mu) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gy = ty0 + 2 * mu + half;
        if (gy >= H || gx >= W) continue;
        const size_t at = (((size_t)n * H + gy) * W + gx) * C + cs0 + cq;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const float v0 = acc[mu][j][2 * half] + b[j][0];
          const float v1 = acc[mu][j][2 * half + 1] + b[j][1];
          if constexpr (CONV2) {
            *reinterpret_cast<float2*>(h2 + at + j * 8) = make_float2(v0, v1);
            s[j][0] += v0;
            s[j][1] += v1;
          } else {
            store_pair(h1 + at + j * 8, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
          }
        }
      }
    }
    if constexpr (CONV2) {
      // the unit's channel sums: lanes of one cq hold its 8 pixel columns;
      // a butterfly in fixed order, lane cq/2 (r0 = 0) writes
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int m = 4; m < 32; m <<= 1) s[j][q] += __shfl_xor_sync(0xffffffffu, s[j][q], m);
      if (r0 == 0) {
        float* pr = partial + ((size_t)n * tiles + t) * C + cs0 + cq;
#pragma unroll
        for (int j = 0; j < NB; ++j)
          *reinterpret_cast<float2*>(pr + j * 8) = make_float2(s[j][0], s[j][1]);
      }
    }
  }
}

template <typename T, int C, int CB, int MU>
__global__ void __launch_bounds__(kThreads, 1)
rcab_conv1_mma_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                      const float* __restrict__ b1, T* __restrict__ h1, int N, int H, int W,
                      int tiles_x, int tiles) {
  conv_mma_pass<T, C, CB, MU, false>(x, w1, b1, h1, nullptr, nullptr, N, H, W, tiles_x, tiles);
}

template <typename T, int C, int CB, int MU>
__global__ void __launch_bounds__(kThreads, 1)
rcab_conv2_mma_kernel(const T* h1, const T* __restrict__ w2,
                      const float* __restrict__ b2, float* __restrict__ h2,
                      float* __restrict__ partial, int N, int H, int W, int tiles_x, int tiles) {
  conv_mma_pass<T, C, CB, MU, true>(h1, w2, b2, nullptr, h2, partial, N, H, W, tiles_x, tiles);
}

// Eight consecutive activations (one pixel, channels c..c+7) as floats.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 a;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = a;
}

// h2 or tile sums written by the kernel before: read from L2 (ld.global.cg),
// after wait_prior(), never through the SM's non-coherent caches.
__device__ __forceinline__ void load8_cg(const float* p, float (&v)[8]) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Gate and apply, grid (blocks an image, N), launched after the conv pass
// with launch_after(), at most two blocks an SM in all (one wave). A
// thread takes kApplyItems groups of 8 channels of one pixel, kThreads
// apart, at a time, the grid's blocks striding over the image. Before
// waiting for the conv pass the block stages wd and wu and loads its first
// x (all ready before the conv pass began); after it, it loads its first
// h2, so those loads are in flight while the block computes the gate. The
// gate of image n comes from its tile sums: each group of 4 channels' tiles
// split over Q threads (tiles q, q+Q, ...), 8 loads in flight, the Q sums
// added in order; the squeeze by one warp an output (lanes over channels,
// then a butterfly). The same code and order in every block, so every block
// gets the same bits, and block 0 writes the gate for the backward. Then
// out = h2 * u * res_scale + x. With per-example gate inputs (PE: a QRCAB's
// metadata folded into the block) the squeeze reads bd[n * bd_stride + j]
// and bu[n * bu_stride + c] (stride 0: one vector for the batch) and the
// branch is multiplied by scale[n, c] (res_scale where scale is null)
// instead of res_scale, in the same order: out = (h2 * u) * scale[n, c] + x;
// `gate` still holds the pure u.
constexpr int kApplyItems = 4;

// A thread's kApplyItems groups of 8 from `groups` starting at block group
// gb (CG: through L2 only, for what the kernel before wrote).
template <bool CG = false, typename S>
__device__ __forceinline__ void load_items(const S* p, long long gb, long long groups,
                                           float (&v)[kApplyItems][8]) {
#pragma unroll
  for (int k = 0; k < kApplyItems; ++k) {
    const long long g = gb + threadIdx.x + k * kThreads;
    if (g >= groups) continue;
    if constexpr (CG) load8_cg(p + (size_t)g * 8, v[k]);
    else load8(p + (size_t)g * 8, v[k]);
  }
}

template <typename T, bool PE>
__global__ void __launch_bounds__(kThreads, 2)
rcab_apply_kernel(const T* __restrict__ x, const float* h2, const float* partial,
                  const float* __restrict__ wd, const float* __restrict__ bd, int bd_stride,
                  const float* __restrict__ wu, const float* __restrict__ bu, int bu_stride,
                  float* __restrict__ gate, float res_scale, const float* __restrict__ scale,
                  T* __restrict__ out, int n_tiles, int HW, int C, int R) {
  extern __shared__ __align__(16) float gsm[];
  const int C4 = C / 4;
  const int Q = C4 < kThreads ? kThreads / C4 : 1;
  float4* part = reinterpret_cast<float4*>(gsm);  // Q * C4
  float* u_s = gsm + 4 * Q * C4;                  // C
  float* gap = u_s + C;                           // C
  float* wd_s = gap + C;                          // C * R
  float* wu_s = wd_s + C * R;                     // R * C
  float* d = wu_s + R * C;                        // R
  float* s_s = d + R;                             // C (PE only)
  const int n = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < C * R; i += kThreads) {
    wd_s[i] = wd[i];
    wu_s[i] = wu[i];
  }
  if constexpr (PE) {
    for (int c = threadIdx.x; c < C; c += kThreads)
      s_s[c] = scale ? scale[(size_t)n * C + c] : res_scale;
  }
  const size_t base = (size_t)n * HW * C;
  const long long groups = (long long)HW * C / 8;
  const long long per_pass = (long long)gridDim.x * kThreads * kApplyItems;
  long long gb = (long long)blockIdx.x * kThreads * kApplyItems;  // the block's first group
  float hv[kApplyItems][8], xv[kApplyItems][8];
  load_items(x + base, gb, groups, xv);
  wait_prior();  // h2 and the tile sums are complete; conv2 no longer reads h1 from out
  load_items<true>(h2 + base, gb, groups, hv);

  const float4* pn = reinterpret_cast<const float4*>(partial + (size_t)n * n_tiles * C);
  for (int i = threadIdx.x; i < Q * C4; i += kThreads) {
    const int c4 = i % C4, q = i / C4;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    int t = q;
    for (; t + 7 * Q < n_tiles; t += 8 * Q) {
      float4 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = __ldcg(pn + (size_t)(t + k * Q) * C4 + c4);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        s.x += v[k].x; s.y += v[k].y; s.z += v[k].z; s.w += v[k].w;
      }
    }
    for (; t < n_tiles; t += Q) {
      const float4 v = __ldcg(pn + (size_t)t * C4 + c4);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    part[i] = s;
  }
  __syncthreads();
  const float* pf = reinterpret_cast<const float*>(part);
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f;
    for (int k = 0; k < Q; ++k) s += pf[k * C + c];
    gap[c] = s / (float)HW;
  }
  __syncthreads();
  for (int j = warp; j < R; j += kThreads / 32) {
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s = fmaf(gap[c], wd_s[c * R + j], s);
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
    if (lane == 0) d[j] = fmaxf(s + bd[(size_t)n * bd_stride + j], 0.f);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f;
    for (int j = 0; j < R; ++j) s = fmaf(d[j], wu_s[j * C + c], s);
    const float u = 1.f / (1.f + expf(-(s + bu[(size_t)n * bu_stride + c])));
    u_s[c] = u;
    if (blockIdx.x == 0) gate[(size_t)n * C + c] = u;
  }
  __syncthreads();
  while (true) {
#pragma unroll
    for (int k = 0; k < kApplyItems; ++k) {
      const long long g = gb + threadIdx.x + k * kThreads;
      if (g >= groups) continue;
      const int c0 = (int)((g * 8) % C);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if constexpr (PE) hv[k][e] = hv[k][e] * u_s[c0 + e] * s_s[c0 + e] + xv[k][e];
        else hv[k][e] = hv[k][e] * u_s[c0 + e] * res_scale + xv[k][e];
      }
      store8(out + base + (size_t)g * 8, hv[k]);
    }
    gb += per_pass;
    if (gb >= groups) break;
    load_items(x + base, gb, groups, xv);
    load_items<true>(h2 + base, gb, groups, hv);
  }
}

// Launches `kernel` so that it may start before the kernel ahead of it on
// the stream has finished (programmatic dependent launch); the kernel must
// call wait_prior() before it touches what that one writes or reads.
template <typename... P, typename... A>
cudaError_t launch_after(void (*kernel)(P...), dim3 grid, int threads, int smem,
                         cudaStream_t s, A... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<P>(args)...);
}

// The launch plan, decided here and nowhere else.
// CUDA-core plan: the output tile TH x TW of a block and its dynamic shared
// memory. Tiles are tried in order; the first whose conv work has a thread
// for every item (the kernel drops items past its budget) and whose shared
// memory lets two blocks share an SM wins, else the first that fits an SM.
// Tensor-core plan: a warp's unit 2*MU x 8 pixels by CB channels (CB = C,
// or 32 at bf16 C = 128 and float32 C >= 64: f32 weights take twice the
// shared memory). MU is the largest of 4, 2 whose block of 8 warps fits
// and that gives every SM at least kMinUnitsPerSm units (so that three or
// more of its four schedulers hold a warp; a larger unit shares each B
// fragment among more m-tiles), else 1. Measured on an H100 (PERF.md,
// section 6): bf16 MU = 4 is fastest at 16x48x48x64 (576 units), MU = 2 at
// 1x128x128x64 and 2x96x96x64, MU = 1 at 1x64x64x64. Then blocks a slice =
// the SMs over the slices, at most the units, and warps a block = the units
// over those blocks, at most 8 and at most what the shared memory holds.
struct Plan {
  bool mma;
  int th, tw, smem;           // tile (a block's, or a warp's unit), shared memory a block
  int cb, slices;             // tensor cores: output channels a unit, slices of C
  int blocks, warps;          // conv grid: blocks (a slice), warps a block
  int tiles_x, tiles;         // tiles an image: across, in all
  int sms, per_sm;            // the device's SMs, and blocks an SM that fit
  int apply_blocks;           // apply grid: blocks an image, two an SM in all at most
};

constexpr int kTiles[][2] = {{16, 16}, {8, 16}, {8, 8}, {4, 8}, {4, 4}};
constexpr int kMinUnitsPerSm = 3;

int fma_smem(int C, int TH, int TW) {
  return (9 * kKC * C + (TH + 4) * (TW + 4) * (C + 1)) * (int)sizeof(float);
}

// conv1's halo region is the larger of the two convs' output regions
bool fma_has_threads(int C, int TH, int TW) {
  return ((TH + 2) * (TW + 2) + kPM - 1) / kPM * (C / kCM) <= kMaxIt * kThreads;
}

int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

cudaError_t make_plan(int dtype, int N, int H, int W, int C, Plan* p) {
  if ((dtype != 0 && dtype != 1) || C <= 0 || C % 8 || N <= 0 || H <= 0 || W <= 0)
    return cudaErrorInvalidValue;
  cudaError_t err = sm_count(&p->sms);
  if (err != cudaSuccess) return err;
  p->mma = C == 16 || C == 32 || C == 64 || C == 128;
  // apply: one wave of two blocks an SM (its register budget), split over the images
  const int apply_cap = 2 * p->sms / N > 1 ? 2 * p->sms / N : 1;
  p->apply_blocks = cdiv((long long)H * W * C / 8, kThreads * kApplyItems);
  if (p->apply_blocks > apply_cap) p->apply_blocks = apply_cap;
  if (p->mma) {
    auto smem = [&](int th, int warps) {
      return dtype == 1 ? mma_smem<bf16>(C, p->cb, th, warps)
                        : mma_smem<float>(C, p->cb, th, warps);
    };
    p->cb = dtype == 1 ? (C == 128 ? 32 : C) : (C >= 64 ? 32 : C);
    p->slices = C / p->cb;
    p->th = 2;
    for (int mu : {4, 2}) {
      const long long units = (long long)N * cdiv(H, 2 * mu) * cdiv(W, kUnitW) * p->slices;
      if (smem(2 * mu, kThreads / 32) <= kSmemMax &&
          units >= (long long)kMinUnitsPerSm * p->sms) {
        p->th = 2 * mu;
        break;
      }
    }
    p->tw = kUnitW;
    p->tiles_x = cdiv(W, kUnitW);
    p->tiles = cdiv(H, p->th) * p->tiles_x;
    const long long units = (long long)N * p->tiles;
    p->blocks = cdiv(p->sms, p->slices);
    if (p->blocks > units) p->blocks = (int)units;
    p->warps = cdiv(units, p->blocks);
    if (p->warps > kThreads / 32) p->warps = kThreads / 32;
    const int fits = (kSmemMax - smem(p->th, 0)) / (smem(p->th, 1) - smem(p->th, 0));
    if (fits < 1) return cudaErrorInvalidConfiguration;
    if (p->warps > fits) p->warps = fits;
    p->smem = smem(p->th, p->warps);
    p->per_sm = kSmemMax / p->smem;
    return cudaSuccess;
  }
  p->cb = C;
  p->slices = 1;
  p->warps = kThreads / 32;
  for (int limit : {kSmemTwoPerSm, kSmemMax}) {
    for (const auto& t : kTiles) {
      if (!fma_has_threads(C, t[0], t[1])) continue;
      const int smem = fma_smem(C, t[0], t[1]);
      if (smem > limit) continue;
      p->th = t[0];
      p->tw = t[1];
      p->smem = smem;
      p->tiles_x = cdiv(W, t[1]);
      p->tiles = cdiv(H, t[0]) * p->tiles_x;
      p->blocks = N * p->tiles;
      p->per_sm = kSmemMax / smem;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidConfiguration;  // C too large for one block
}

// Float32 scratch of one forward: h2 (N,H,W,C), then the per-tile sums
// (N, tiles, C), then the gate (N,C); C % 8 == 0 keeps each 32-byte aligned.
long long workspace_floats(const Plan& p, int N, int H, int W, int C) {
  return (long long)N * C * ((long long)H * W + p.tiles + 1);
}

template <typename T>
cudaError_t conv_fma(const Plan& p, const void* x, const void* w1, const float* b1,
                     const void* w2, const float* b2, float* h2, float* partial, int N, int H,
                     int W, int C, cudaStream_t stream) {
  static int done[kMaxDevices] = {};
  cudaError_t err = allow_smem(rcab_conv_kernel<T>, p.smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.tiles_x, p.tiles / p.tiles_x, N);
  rcab_conv_kernel<T><<<grid, kThreads, p.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2,
      h2, partial, H, W, C, p.th, p.tw);
  return cudaGetLastError();
}

// Both tensor-core passes; h1 goes through `h1` (N,H,W,C) of type T.
template <typename T, int C, int CB, int MU>
cudaError_t conv_mma(const Plan& p, const T* x, const T* w1, const float* b1, const T* w2,
                     const float* b2, T* h1, float* h2, float* partial, int N, int H, int W,
                     cudaStream_t s) {
  static int done1[kMaxDevices] = {}, done2[kMaxDevices] = {};
  cudaError_t err = allow_smem(rcab_conv1_mma_kernel<T, C, CB, MU>, p.smem, done1);
  if (err == cudaSuccess) err = allow_smem(rcab_conv2_mma_kernel<T, C, CB, MU>, p.smem, done2);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.blocks, p.slices);
  rcab_conv1_mma_kernel<T, C, CB, MU><<<grid, p.warps * 32, p.smem, s>>>(
      x, w1, b1, h1, N, H, W, p.tiles_x, p.tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_after(rcab_conv2_mma_kernel<T, C, CB, MU>, grid, p.warps * 32, p.smem, s, h1,
                      w2, b2, h2, partial, N, H, W, p.tiles_x, p.tiles);
}

template <typename T, int C, int CB>
cudaError_t conv_mma_mu(const Plan& p, const void* x, const void* w1, const float* b1,
                        const void* w2, const float* b2, void* h1, float* h2, float* partial,
                        int N, int H, int W, cudaStream_t s) {
  auto tx = static_cast<const T*>(x), tw1 = static_cast<const T*>(w1),
       tw2 = static_cast<const T*>(w2);
  auto th1 = static_cast<T*>(h1);
  switch (p.th / 2) {
    case 1: return conv_mma<T, C, CB, 1>(p, tx, tw1, b1, tw2, b2, th1, h2, partial, N, H, W, s);
    case 2:
      if constexpr (mma_smem<T>(C, CB, 4, kThreads / 32) <= kSmemMax)
        return conv_mma<T, C, CB, 2>(p, tx, tw1, b1, tw2, b2, th1, h2, partial, N, H, W, s);
      return cudaErrorInvalidConfiguration;
    case 4:
      if constexpr (mma_smem<T>(C, CB, 8, kThreads / 32) <= kSmemMax)
        return conv_mma<T, C, CB, 4>(p, tx, tw1, b1, tw2, b2, th1, h2, partial, N, H, W, s);
      [[fallthrough]];
    default: return cudaErrorInvalidConfiguration;
  }
}

cudaError_t conv(int dtype, const Plan& p, const void* x, const void* w1, const float* b1,
                 const void* w2, const float* b2, void* h1, float* h2, float* partial, int N,
                 int H, int W, int C, cudaStream_t s) {
  if (p.mma && dtype == 1) {
    switch (C) {
      case 16: return conv_mma_mu<bf16, 16, 16>(p, x, w1, b1, w2, b2, h1, h2, partial, N, H, W, s);
      case 32: return conv_mma_mu<bf16, 32, 32>(p, x, w1, b1, w2, b2, h1, h2, partial, N, H, W, s);
      case 64: return conv_mma_mu<bf16, 64, 64>(p, x, w1, b1, w2, b2, h1, h2, partial, N, H, W, s);
      case 128: return conv_mma_mu<bf16, 128, 32>(p, x, w1, b1, w2, b2, h1, h2, partial, N, H, W, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (p.mma) {
    switch (C) {
      case 16: return conv_mma_mu<float, 16, 16>(p, x, w1, b1, w2, b2, h1, h2, partial, N, H, W, s);
      case 32: return conv_mma_mu<float, 32, 32>(p, x, w1, b1, w2, b2, h1, h2, partial, N, H, W, s);
      case 64: return conv_mma_mu<float, 64, 32>(p, x, w1, b1, w2, b2, h1, h2, partial, N, H, W, s);
      case 128: return conv_mma_mu<float, 128, 32>(p, x, w1, b1, w2, b2, h1, h2, partial, N, H, W, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 0) return conv_fma<float>(p, x, w1, b1, w2, b2, h2, partial, N, H, W, C, s);
  return conv_fma<bf16>(p, x, w1, b1, w2, b2, h2, partial, N, H, W, C, s);
}

template <typename T, bool PE>
cudaError_t apply(const Plan& p, const void* x, const float* h2, const float* partial,
                  const float* wd, const float* bd, int bd_stride, const float* wu,
                  const float* bu, int bu_stride, float* gate, float res_scale,
                  const float* scale, void* out, int N, int H, int W, int C, int R,
                  cudaStream_t s) {
  const int C4 = C / 4;
  const int Q = C4 < kThreads ? kThreads / C4 : 1;
  const int smem = (4 * Q * C4 + 2 * C + 2 * C * R + R + (PE ? C : 0)) * (int)sizeof(float);
  static int done[kMaxDevices] = {};
  cudaError_t err = allow_smem(rcab_apply_kernel<T, PE>, smem, done);
  if (err != cudaSuccess) return err;
  return launch_after(rcab_apply_kernel<T, PE>, dim3(p.apply_blocks, N), kThreads, smem, s,
                      static_cast<const T*>(x), h2, partial, wd, bd, bd_stride, wu, bu,
                      bu_stride, gate, res_scale, scale, static_cast<T*>(out), p.tiles, H * W,
                      C, R);
}

template <typename T>
cudaError_t apply_any(const Plan& p, const void* x, const float* h2, const float* partial,
                      const float* wd, const float* bd, int bd_stride, const float* wu,
                      const float* bu, int bu_stride, float* gate, float res_scale,
                      const float* scale, void* out, int N, int H, int W, int C, int R,
                      cudaStream_t s) {
  if (scale || bd_stride || bu_stride)
    return apply<T, true>(p, x, h2, partial, wd, bd, bd_stride, wu, bu, bu_stride, gate,
                          res_scale, scale, out, N, H, W, C, R, s);
  return apply<T, false>(p, x, h2, partial, wd, bd, 0, wu, bu, 0, gate, res_scale, nullptr,
                         out, N, H, W, C, R, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Sets *floats to the float32 workspace
// that rcab_fused_forward needs for an (N,H,W,C) input on the current
// device. Returns a cudaError_t (0 on success; cudaErrorInvalidConfiguration
// if C channels do not fit one block).
int rcab_fused_workspace(int dtype, int N, int H, int W, int C, long long* floats) {
  Plan p;
  const cudaError_t err = make_plan(dtype, N, H, W, C, &p);
  if (err == cudaSuccess) *floats = workspace_floats(p, N, H, W, C);
  return (int)err;
}

// Where rcab_fused_forward leaves its intermediates in the workspace, for
// the backward pass: layout[0] is the float offset of the per-tile channel
// sums of h2 (N, tiles, C), layout[1] that of the gate (N, C), layout[2]
// the number of tiles an image; h2 (N,H,W,C) is at offset 0.
int rcab_fused_layout(int dtype, int N, int H, int W, int C, long long* layout) {
  Plan p;
  const cudaError_t err = make_plan(dtype, N, H, W, C, &p);
  if (err != cudaSuccess) return (int)err;
  layout[0] = (long long)N * H * W * C;
  layout[1] = layout[0] + (long long)N * p.tiles * C;
  layout[2] = p.tiles;
  return 0;
}

// The plan of a forward on the current device, for reports: plan[0] 1 if
// the convs run on the tensor cores; [1..3] the work unit's rows, columns
// and output channels (a block's tile on the CUDA cores, a warp's on the
// tensor cores); [4] conv blocks in all, [5] warps a block, [6] the SMs,
// [7] blocks an SM that fit, [8] units in all, [9] units the busiest warp
// walks (waves), [10] the apply pass's blocks in all.
int rcab_fused_plan(int dtype, int N, int H, int W, int C, long long* plan) {
  Plan p;
  const cudaError_t err = make_plan(dtype, N, H, W, C, &p);
  if (err != cudaSuccess) return (int)err;
  const long long units = (long long)N * p.tiles * p.slices;
  const long long blocks = (long long)p.blocks * p.slices;
  const long long waves = p.mma ? cdiv((long long)N * p.tiles, (long long)p.blocks * p.warps)
                                : cdiv(blocks, (long long)p.sms * p.per_sm);
  const long long v[] = {p.mma, p.th, p.tw, p.cb, blocks, p.warps, p.sms, p.per_sm, units,
                         waves, (long long)p.apply_blocks * N};
  for (int i = 0; i < 11; ++i) plan[i] = v[i];
  return 0;
}

// dtype as above. x, out: (N,H,W,C) contiguous in that type, on 16-byte
// boundaries, not overlapping (the tensor-core plan keeps h1 in `out` until
// the last pass overwrites it); w1, w2: (9,C,C) tap-major in that type; b1,
// b2, wd (C,R), wu (R,C) in float32; bd (R) with bd_stride 0 or (N,R) with
// bd_stride R, bu (C) with bu_stride 0 or (N,C) with bu_stride C, float32;
// scale: null (the branch times res_scale) or (N,C) float32; workspace:
// `workspace_floats` float32, at least what rcab_fused_workspace gives. The
// tensor-core plan (C in {16, 32, 64, 128}) needs w1 and w2 on
// 16-byte boundaries too. Returns a cudaError_t (0 on success).
int rcab_fused_forward(int dtype, const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, const void* wd, const void* bd,
                       const void* wu, const void* bu, float res_scale, const void* scale,
                       int bd_stride, int bu_stride, void* out, void* workspace,
                       long long workspace_floats_given, int N, int H, int W, int C, int R,
                       void* stream) {
  Plan p;
  cudaError_t err = make_plan(dtype, N, H, W, C, &p);
  if (err != cudaSuccess) return (int)err;
  if (workspace_floats_given < workspace_floats(p, N, H, W, C)) return cudaErrorInvalidValue;
  if ((bd_stride != 0 && bd_stride != R) || (bu_stride != 0 && bu_stride != C))
    return cudaErrorInvalidValue;
  uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  if (p.mma) align |= reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2);
  if (align % 16) return cudaErrorMisalignedAddress;
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  auto s = static_cast<cudaStream_t>(stream);
  float* h2f = static_cast<float*>(workspace);
  float* pf = h2f + (size_t)N * H * W * C;
  float* gf = pf + (size_t)N * p.tiles * C;
  err = conv(dtype, p, x, w1, f(b1), w2, f(b2), out, h2f, pf, N, H, W, C, s);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0)
    err = apply_any<float>(p, x, h2f, pf, f(wd), f(bd), bd_stride, f(wu), f(bu), bu_stride, gf,
                           res_scale, f(scale), out, N, H, W, C, R, s);
  else
    err = apply_any<bf16>(p, x, h2f, pf, f(wd), f(bd), bd_stride, f(wu), f(bu), bu_stride, gf,
                          res_scale, f(scale), out, N, H, W, C, R, s);
  return (int)err;
}

// The name of a cudaError_t returned above, for error messages.
const char* rcab_fused_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
