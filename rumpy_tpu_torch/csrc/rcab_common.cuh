// Device code shared by the RCAB forward (rcab_fused.cu) and backward
// (rcab_fused_bwd.cu) kernels: type conversion, the CUDA-core 3x3
// convolution from shared memory, and the shared-memory limit helper.
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
