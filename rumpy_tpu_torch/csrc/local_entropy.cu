// Local-histogram entropy for Hopper (sm_90a), bound to Python over ctypes.
//
// Replaces rumpy_tpu/ops/pallas/entropy_kernel.py::local_entropy_pallas (the
// Pallas TPU kernel, body _entropy_block_kernel). For every pixel of an
// (H, W) uint8 image: the Shannon entropy, in bits, of the histogram of its
// region x region window, with values quantised to `levels` bins
// (q = v * levels / 256). The window of output (y, x) is rows
// y - half .. y + region - half - 1 and columns x - half .. x + region -
// half - 1, half = region / 2. Rows outside the image are edge-replicated
// (a replicated row counts again); columns outside the image are left out,
// so the window's total shrinks at the left and right edge. That mixed rule
// is the TPU kernel's.
//
// Bound on an H100 SXM, for a 339x510 image at region 10 and 64 levels:
// the function must read H*W bytes and write 4*H*W, 0.26 us at 3.35 TB/s.
// That is the bound: a sliding column histogram needs about 2*region
// updates a pixel, far under the memory time. This first version does a
// whole window of updates for every pixel instead (one per window sample
// plus a divide, a log2 and a multiply-add per non-empty bin: 28 M
// operations for a textured image) and takes 30 us.
//
// Design. The TPU kernel builds column histograms for 8 rows at a time in
// VMEM as (levels, W) float planes and shifts them with rolls. Here a block
// of 128 threads owns an 8 x 16 output tile: the quantised tile with its
// halo sits in shared memory as bytes, and every thread keeps its own
// histogram of byte counts there (region <= 15, so a count fits a byte),
// laid out word-interleaved across the threads so that no two threads of a
// warp share a bank. The entropy is summed over the bins in ascending
// order, p = count / total in float32, as the plain version does.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTX = 16;
constexpr int kTY = 8;
constexpr int kEntropyThreads = kTX * kTY;

__global__ void __launch_bounds__(kEntropyThreads)
local_entropy_kernel(const unsigned char* __restrict__ img, float* __restrict__ out,
                     int H, int W, int region, int levels) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int half = region / 2;
  const int IH = kTY + region - 1, IW = kTX + region - 1;
  const int words = (levels + 3) / 4;
  unsigned* hist = reinterpret_cast<unsigned*>(sm);       // [word][thread]
  unsigned char* tile = sm + words * kEntropyThreads * 4;  // IH x IW bins
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;

  for (int i = tid; i < IH * IW; i += kEntropyThreads) {
    const int r = i / IW, c = i - r * IW;
    int gy = y0 - half + r;
    gy = gy < 0 ? 0 : (gy >= H ? H - 1 : gy);  // rows: edge-replicated
    const int gx = x0 - half + c;
    unsigned char q = 0;  // columns outside the image are never counted
    if (gx >= 0 && gx < W) q = (unsigned char)(((int)img[(size_t)gy * W + gx] * levels) >> 8);
    tile[i] = q;
  }
  for (int w = 0; w < words; ++w) hist[w * kEntropyThreads + tid] = 0u;
  __syncthreads();

  const int tx = tid % kTX, ty = tid / kTX;
  const int x = x0 + tx, y = y0 + ty;
  if (x >= W || y >= H) return;  // no barrier below

  unsigned char* mine = sm + tid * 4;
  int total = 0;
  for (int r = 0; r < region; ++r) {
    const unsigned char* row = tile + (ty + r) * IW + tx;
    for (int j = 0; j < region; ++j) {
      const int gx = x - half + j;
      if (gx < 0 || gx >= W) continue;
      const int q = row[j];
      mine[(q >> 2) * (kEntropyThreads * 4) + (q & 3)] += 1;
      ++total;
    }
  }
  const float denom = (float)(total > 1 ? total : 1);
  float ent = 0.f;
  for (int w = 0; w < words; ++w) {
    const unsigned v = hist[w * kEntropyThreads + tid];
    if (v == 0u) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const unsigned c = (v >> (8 * b)) & 255u;
      if (c) {
        const float p = (float)c / denom;
        ent -= p * log2f(p);
      }
    }
  }
  out[(size_t)y * W + x] = ent;
}

}  // namespace

extern "C" {

// img: (H, W) uint8, contiguous; out: (H, W) float32. region in [1, 15]
// (a window count must fit a byte), levels in [1, 256]. Returns a
// cudaError_t (0 on success).
int local_entropy_forward(const void* img, void* out, int H, int W, int region, int levels,
                          void* stream) {
  if (H <= 0 || W <= 0 || region < 1 || region > 15 || levels < 1 || levels > 256)
    return (int)cudaErrorInvalidValue;
  const int words = (levels + 3) / 4;
  const int smem = words * kEntropyThreads * 4 + (kTY + region - 1) * (kTX + region - 1);
  const dim3 grid((W + kTX - 1) / kTX, (H + kTY - 1) / kTY);
  local_entropy_kernel<<<grid, kEntropyThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(img), static_cast<float*>(out), H, W, region, levels);
  return (int)cudaGetLastError();
}

// The name of a cudaError_t returned above, for error messages.
const char* local_entropy_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
