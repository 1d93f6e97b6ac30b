// Device code shared by the RCAB forward (rcab_fused.cu) and backward
// (rcab_fused_bwd.cu) kernels: type conversion, the 3x3 convolution from
// shared memory on the CUDA cores (conv3x3_smem) and on the tensor cores
// (conv3x3_mma, which is also the transposed convolution of a backward
// pass), cp.async helpers, and the shared-memory limit helper.
// Each source that includes this file is built into its own library.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPM = 4;     // pixels per thread item
constexpr int kCM = 8;     // output channels per thread item
constexpr int kKC = 8;     // input channels of weights staged at once
constexpr int kMaxIt = 2;  // thread items per conv (accumulators in registers)
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// One 3x3 conv over a shared-memory region `src` of IH x IW pixels (pixel
// stride SP floats) into OH x OW = (IH-2) x (IW-2) outputs, accumulated into
// acc[it][k][j] for the thread's items. Every thread of the block must call
// it (it holds barriers). Item i covers pixel group g = i % G (pixels
// g, g+G, g+2G, g+3G of the output region) and channels (i / G) * kCM + j.
template <typename T>
__device__ __forceinline__ void conv3x3_smem(
    const float* src, int IW, int OH, int OW, int C, int SP,
    const T* __restrict__ w, float* w_s, float (&acc)[kMaxIt][kPM][kCM]) {
  const int P = OH * OW;
  const int G = (P + kPM - 1) / kPM;
  const int n_items = G * (C / kCM);
  int base[kMaxIt][kPM];
  int cbase[kMaxIt];
  bool valid[kMaxIt];
#pragma unroll
  for (int it = 0; it < kMaxIt; ++it) {
    const int item = it * kThreads + threadIdx.x;
    valid[it] = item < n_items;
    const int g = valid[it] ? item % G : 0;
    cbase[it] = valid[it] ? (item / G) * kCM : 0;
#pragma unroll
    for (int k = 0; k < kPM; ++k) {
      int p = g + G * k;
      p = p < P ? p : 0;  // padded pixels read a valid address; never stored
      base[it][k] = ((p / OW) * IW + (p % OW)) * SP;
#pragma unroll
      for (int j = 0; j < kCM; ++j) acc[it][k][j] = 0.f;
    }
  }
  for (int ci0 = 0; ci0 < C; ci0 += kKC) {
    __syncthreads();
    for (int i = threadIdx.x; i < 9 * kKC * C; i += kThreads) {
      const int t = i / (kKC * C);
      const int r = i - t * (kKC * C);
      const int kc = r / C;
      const int co = r - kc * C;
      w_s[i] = to_f(w[((size_t)t * C + ci0 + kc) * C + co]);
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < kMaxIt; ++it) {
      if (!valid[it]) continue;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int off = ((t / 3) * IW + (t % 3)) * SP + ci0;
        const float* wt = w_s + t * kKC * C + cbase[it];
#pragma unroll
        for (int kc = 0; kc < kKC; ++kc) {
          const float4 wa = *reinterpret_cast<const float4*>(wt + kc * C);
          const float4 wb = *reinterpret_cast<const float4*>(wt + kc * C + 4);
          const float wv[kCM] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int k = 0; k < kPM; ++k) {
            const float xv = src[base[it][k] + off + kc];
#pragma unroll
            for (int j = 0; j < kCM; ++j) acc[it][k][j] = fmaf(xv, wv[j], acc[it][k][j]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor cores: mma.sync m16n8k16, bf16 operands, f32 accumulation.
// ---------------------------------------------------------------------------

constexpr int kMmaAcc = 64;   // f32 accumulators a thread

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from device to shared memory without passing registers; with
// `valid` false nothing is read and the 16 bytes are zero-filled (`src`
// must still be an address of the allocation).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Starts the copy of tap t of a conv's weights (tap 8 - t as it lies, for a
// transposed conv) into `buf` as [C][C + 8], as one cp.async group.
template <int NT, bool TR>
__device__ __forceinline__ void conv_stage_tap(const __nv_bfloat16* __restrict__ w, int t,
                                               __nv_bfloat16* buf) {
  constexpr int C = NT * 8;
  constexpr int SPW = C + 8;
  const __nv_bfloat16* from = w + (size_t)(TR ? 8 - t : t) * C * C;
  for (int i = threadIdx.x; i < C * (C / 8); i += kThreads) {
    const int row = i / (C / 8), c8 = (i % (C / 8)) * 8;
    cp_async16(buf + row * SPW + c8, from + row * C + c8, true);
  }
  cp_async_commit();
}

// One 3x3 conv from shared memory `src` (region width IW, pixel stride SP)
// to OH x OW outputs; acc[u][j] is the 16x8 tile (m-tile warp + 8u,
// n-tile j) in mma's C-fragment layout. Weights are staged through
// cp.async, one tap at a time into two buffers in turn, so that a tap's
// copy runs under the mma of the tap before; each B fragment is loaded once
// for all of a warp's m-tiles.
// TR = true is the transposed conv of a backward pass:
//   out[p][ci] = sum_t,co src[p + t][co] * w[8 - t][ci][co];
// tap 8 - t is staged as it lies, [ci][co] = [N][K], and read with ldmatrix
// without .trans, so no flipped copy of the weights is needed.
// Protocol: `w_s` holds both buffers ([C][C + 8] each), and tap 0 is in
// flight into buffer `first` (0 or 1) when this is called: the caller started
// conv_stage_tap<NT, TR>(w, 0, ...), or the conv before did for its
// `w_next`. With `w_next`, tap 0 of the next conv (transposed or not by
// NEXT_TR) is left in flight in buffer first ^ 1 (9 taps: an odd number).
// Every thread must call it; it waits for all of the thread's cp.async
// copies, and its first barrier publishes them and what the caller wrote to
// `src`.
template <int NT, bool TR, bool NEXT_TR = false>
__device__ __forceinline__ void conv3x3_mma(
    const __nv_bfloat16* src, int IW, int OH, int OW, int SP,
    const __nv_bfloat16* __restrict__ w, __nv_bfloat16* w_s, int first,
    const __nv_bfloat16* __restrict__ w_next, float (&acc)[kMmaAcc / (4 * NT)][NT][4]) {
  constexpr int C = NT * 8;
  constexpr int MU = kMmaAcc / (4 * NT);
  constexpr int SPW = C + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int M = OH * OW;
  const int MT = (M + 15) / 16;
  int rowoff[MU];
#pragma unroll
  for (int u = 0; u < MU; ++u) {
    int m = (warp + 8 * u) * 16 + (lane & 15);
    m = m < M ? m : 0;  // padded rows read pixel 0; never stored
    rowoff[u] = ((m / OW) * IW + m % OW) * SP + (lane >> 4) * 8;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[u][j][q] = 0.f;
  }
  // lane's row of the B ldmatrix, n-tile pair (j, j+1): a k row (.trans) or
  // an n row (TR)
  const int brow = TR ? ((lane & 7) + (lane >> 4) * 8) * SPW + ((lane >> 3) & 1) * 8
                      : ((lane & 7) + ((lane >> 3) & 1) * 8) * SPW + (lane >> 4) * 8;
  for (int t = 0; t < 9; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tap t is there for all; all have left the other buffer
    __nv_bfloat16* other = w_s + ((first + t + 1) & 1) * C * SPW;
    if (t + 1 < 9)
      conv_stage_tap<NT, TR>(w, t + 1, other);
    else if (w_next)
      conv_stage_tap<NT, NEXT_TR>(w_next, 0, other);
    const __nv_bfloat16* wt = w_s + ((first + t) & 1) * C * SPW + brow;
    const int toff = ((t / 3) * IW + (t % 3)) * SP;
#pragma unroll
    for (int k0 = 0; k0 < C; k0 += 16) {
      uint32_t b[NT / 2][4];
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        if constexpr (TR)
          ldmatrix_x4(b[j / 2], wt + j * 8 * SPW + k0);
        else
          ldmatrix_x4_trans(b[j / 2], wt + k0 * SPW + j * 8);
      }
#pragma unroll
      for (int u = 0; u < MU; ++u) {
        if (warp + 8 * u >= MT) continue;  // warp-uniform
        uint32_t a[4];
        ldmatrix_x4(a, src + rowoff[u] + toff + k0);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          mma_bf16(acc[u][j], a, b[j / 2][0], b[j / 2][1]);
          mma_bf16(acc[u][j + 1], a, b[j / 2][2], b[j / 2][3]);
        }
      }
    }
  }
}

// Raise a kernel's dynamic shared memory limit to `bytes` on the current
// device, once: `done` remembers the largest limit set on each device.
template <typename K>
cudaError_t allow_smem(K* kernel, int bytes, int (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && bytes <= done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = bytes;
  return err;
}

constexpr int kSmemTwoPerSm = 113 * 1024;
constexpr int kSmemMax = 227 * 1024;

}  // namespace
