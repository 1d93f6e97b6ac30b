// Local-histogram entropy for Hopper (sm_90a), bound to Python over ctypes.
//
// Replaces rumpy_tpu/ops/pallas/entropy_kernel.py::local_entropy_pallas (the
// Pallas TPU kernel, body _entropy_block_kernel). For every pixel of an
// (H, W) image of grey levels: the Shannon entropy, in bits, of the
// histogram of its region x region window, with values quantised to
// `levels` bins (q = v * levels / 256). The window of output (y, x) is rows
// y - half .. y + region - half - 1 and columns x - half .. x + region -
// half - 1, half = region / 2. Rows outside the image are edge-replicated
// (a replicated row counts again); columns outside the image are left out,
// so the window's total N = region * (columns inside) shrinks at the left
// and right edge. That mixed rule is the TPU kernel's.
//
// The grey levels come from a uint8 (H, W) image, or the kernel computes
// them in its load from a uint8 (H, W, 3) RGB image (x = v / 255.0f, the
// float32 bits numpy's conversion gives): the luma of
// ops/entropy.py::luma_u8 step for step (each product in float64, where it
// is exact, each sum rounded to float32, round(255 * Y) half to even, then
// clamped), with explicitly rounded intrinsics so that no contraction moves
// a bit. The per-value steps come from tables of 256 entries that a block
// fills first (the same operations on the same values).
//
// Bound on an H100 SXM, for a 339x510 image at region 10 and 64 levels:
// the function must read 3*H*W bytes of RGB (H*W of grey levels) and write
// 4*H*W, 0.36 us (0.26 us) at 3.35 TB/s.
// One launch's ramp on the card (block scheduling, the first loads) is a
// few microseconds, several times that bound at this size, so the bound is
// out of reach by a wide margin. What a thread waits on is chains of
// dependent shared-memory updates (about 100 cycles each on the card, when
// a thread kept its window's histogram and slid it down a strip: 20 us a
// call), so the design keeps those chains to two updates a row.
//
// Design: sliding column histograms. A block owns a band of kBand columns
// over a strip of kStrip rows. The band's levels, with the window's halo,
// are staged once in shared memory as bytes, every global load of a thread
// issued before any is used. Each column of the band keeps the histogram of
// its window rows in shared memory, 4 bins of byte counts to a word (a
// count never passes 225, so no byte carries into the next), counted for
// the first row by two threads and then moved down a row by one removal and
// one addition, one thread each. A pixel's window histogram is the sum of
// its region columns' histograms, added as packed words by four threads,
// each a quarter of the bins: loads and adds that do not wait on each other.
//
// Entropy without a count per bin: with counts c_b and S = sum_b c_b log2
// c_b, the entropy is log2(N) - S / N, S summed as integers from the table
// T[c] = round(c log2 c * 2^kFracBits) for c <= 225 that the host builds
// (ops/cuda/local_entropy.py::plogp_table) and the block stages in shared
// memory. The rounding of the table moves a value by at most
// 2^-(kFracBits+1) bits, and S <= 225 log2(225) * 2^20 fits an int.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBand = 64;       // output columns of a block
constexpr int kParts = 4;       // threads a pixel: each sums a quarter of the bins
constexpr int kThreads = kBand * kParts;
constexpr int kStrip = 8;       // output rows of a block
constexpr int kMaxRegion = 15;  // a count fits a byte; S fits an int
constexpr int kMaxCount = kMaxRegion * kMaxRegion;
constexpr int kTable = kMaxCount + 1;
constexpr int kMaxRows = kStrip + kMaxRegion - 1;  // the band's rows with the halo
static_assert(kBand + kMaxRegion - 1 <= 2 * kBand && kThreads == 4 * kBand,
              "two threads a column of the band, with its halo, stage and count it");
constexpr double kFixedOne = 1048576.0;  // 2^kFracBits, kFracBits = 20

// BT.601 full-range luma weights, the float32 values, as luma_u8 uses them.
constexpr double kWr = (double)0.299f, kWg = (double)0.587f, kWb = (double)0.114f;

enum Source { kGrey = 0, kRgbU8 = 1 };
__host__ __device__ constexpr int channels(int src) { return src == kGrey ? 1 : 3; }

// round(255 * y) clamped to [0, 255], half to even, as luma_u8 rounds.
__device__ __forceinline__ int level_of(float y) {
  return (int)fminf(fmaxf(rintf(__fmul_rn(y, 255.0f)), 0.0f), 255.0f);
}

// luma_u8's chain on uint8 RGB, x = v / 255.0f: each product in float64
// (exact there), each sum rounded to float32. Per-value tables hold the
// first step and the exact products: three lookups a pixel instead of three
// divisions and three products.
struct LumaTables {
  double pg[256], pb[256];  // x * wg, x * wb in float64 (exact)
  float r[256];             // float32(x * wr)
};

__device__ void fill_luma_tables(LumaTables* t, int tid, int threads) {
  for (int v = tid; v < 256; v += threads) {
    const double x = (double)__fdiv_rn((float)v, 255.0f);
    t->r[v] = __double2float_rn(__dmul_rn(x, kWr));
    t->pg[v] = __dmul_rn(x, kWg);
    t->pb[v] = __dmul_rn(x, kWb);
  }
}

__device__ __forceinline__ int luma_level_u8(const LumaTables* t, unsigned r, unsigned g,
                                             unsigned b) {
  float y = t->r[r];
  y = __double2float_rn(__dadd_rn(t->pg[g], (double)y));
  y = __double2float_rn(__dadd_rn(t->pb[b], (double)y));
  return level_of(y);
}

// A pixel's channels, one byte each.
template <int SRC>
__device__ __forceinline__ void load_pixel(const void* src, size_t i, unsigned* px) {
#pragma unroll
  for (int ch = 0; ch < channels(SRC); ++ch)
    px[ch] = static_cast<const unsigned char*>(src)[channels(SRC) * i + ch];
}

template <int SRC>
__device__ __forceinline__ int grey_of(const LumaTables* t, const unsigned* px) {
  if constexpr (SRC == kGrey)
    return (int)px[0];
  else
    return luma_level_u8(t, px[0], px[1], px[2]);
}

template <int SRC, int WORDS>
__global__ void __launch_bounds__(kThreads)
local_entropy_kernel(const void* __restrict__ src, const int* __restrict__ plogp,
                     float* __restrict__ out, unsigned long long* __restrict__ clear,
                     int H, int W, int region, int levels) {
  extern __shared__ __align__(16) unsigned char sm[];
  constexpr int kPartWords = WORDS / kParts;  // a thread's share of a histogram
  const int half = region / 2;
  const int TH = kStrip + region - 1, TW = kBand + region - 1;
  LumaTables* luma = reinterpret_cast<LumaTables*>(sm);
  unsigned* col = reinterpret_cast<unsigned*>(sm + (SRC == kRgbU8 ? sizeof(LumaTables) : 0));
  int* T = reinterpret_cast<int*>(col + TW * WORDS);  // col: [column][word], 4 bins a word
  unsigned char* tile = reinterpret_cast<unsigned char*>(T + kTable);  // TH x TW levels
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kBand, y0 = blockIdx.y * kStrip;
  // Staging, counting and moving the columns: a thread takes column tc of
  // the band (with its halo) and every other row from tr.
  const int tc = tid % (2 * kBand), tr = tid / (2 * kBand);

  // The band's pixels, every load of a thread issued before any is used.
  unsigned px[kMaxRows / 2][channels(SRC)];
  const int gx = x0 - half + tc;
  const bool counted = tc < TW && gx >= 0 && gx < W;  // columns outside the image are not
#pragma unroll
  for (int m = 0; m < kMaxRows / 2; ++m) {
    const int r = tr + 2 * m;
    int gy = y0 - half + r;
    gy = gy < 0 ? 0 : (gy >= H ? H - 1 : gy);  // rows: edge-replicated
#pragma unroll
    for (int ch = 0; ch < channels(SRC); ++ch) px[m][ch] = 0u;
    if (r < TH && counted) load_pixel<SRC>(src, (size_t)gy * W + gx, px[m]);
  }
  if (clear != nullptr && blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) *clear = 0ull;
  for (int c = tid; c < kTable; c += kThreads) T[c] = plogp[c];
  if (SRC == kRgbU8) fill_luma_tables(luma, tid, kThreads);
  for (int i = tid; i < TW * WORDS; i += kThreads) col[i] = 0u;
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kMaxRows / 2; ++m) {
    const int r = tr + 2 * m;
    if (r < TH && tc < TW)
      tile[r * TW + tc] = (unsigned char)((grey_of<SRC>(luma, px[m]) * levels) >> 8);
  }
  __syncthreads();

  // Each column's histogram over the first row's window rows, two threads a
  // column. Packed bytes: a count never passes 225, so no byte carries.
  if (counted) {
    for (int r = tr; r < region; r += 2) {
      const int q = tile[r * TW + tc];
      atomicAdd(&col[tc * WORDS + (q >> 2)], 1u << (8 * (q & 3)));
    }
  }

  // A pixel's entropy, four threads a pixel, each summing a quarter of the
  // bins over the window's columns.
  const int p = tid / kParts, part = tid % kParts;
  const int x = x0 + p;
  const int jlo = half - x > 0 ? half - x : 0;
  const int jhi = W - x + half < region ? W - x + half : region;
  const int n = region * (jhi > jlo ? jhi - jlo : 1);
  const double log2n = log2((double)n);
  const double inv = 1.0 / ((double)n * kFixedOne);
  const int y_end = min(y0 + kStrip, H);
  for (int y = y0; y < y_end; ++y) {
    __syncthreads();  // the column histograms hold row y's window
    unsigned win[kPartWords];
#pragma unroll
    for (int k = 0; k < kPartWords; ++k) win[k] = 0u;
#pragma unroll
    for (int j = 0; j < kMaxRegion; ++j) {
      if (j < region) {
        const uint4* c4 = reinterpret_cast<const uint4*>(col + (p + j) * WORDS + part * kPartWords);
#pragma unroll
        for (int k = 0; k < kPartWords / 4; ++k) {
          const uint4 v = c4[k];
          win[4 * k] += v.x;
          win[4 * k + 1] += v.y;
          win[4 * k + 2] += v.z;
          win[4 * k + 3] += v.w;
        }
      }
    }
    int S = 0;
#pragma unroll
    for (int k = 0; k < kPartWords; ++k)
      S += T[win[k] & 255u] + T[(win[k] >> 8) & 255u] + T[(win[k] >> 16) & 255u] +
           T[win[k] >> 24];
    S += __shfl_xor_sync(0xffffffffu, S, 1);
    S += __shfl_xor_sync(0xffffffffu, S, 2);
    if (part == 0 && x < W) out[(size_t)y * W + x] = (float)(log2n - (double)S * inv);
    if (y + 1 == y_end) break;
    __syncthreads();  // every window read: move the columns one row down
    if (counted) {  // one thread takes the row that leaves, the other the row that comes
      const int q = tile[(y - y0 + (tr == 0 ? 0 : region)) * TW + tc];
      const unsigned one = 1u << (8 * (q & 3));
      if (tr == 0)
        atomicSub(&col[tc * WORDS + (q >> 2)], one);
      else
        atomicAdd(&col[tc * WORDS + (q >> 2)], one);
    }
  }
}

// The fused front alone, for checking it: the grey level of every pixel.
__global__ void grey_levels_kernel(const void* __restrict__ src, unsigned char* __restrict__ out,
                                   int n) {
  __shared__ LumaTables luma;
  fill_luma_tables(&luma, threadIdx.x, blockDim.x);
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    unsigned px[3];
    load_pixel<kRgbU8>(src, (size_t)i, px);
    out[i] = (unsigned char)grey_of<kRgbU8>(&luma, px);
  }
}

template <int WORDS>
size_t entropy_smem(int region, int source) {
  const size_t tw = kBand + region - 1, th = kStrip + region - 1;
  return (source == kRgbU8 ? sizeof(LumaTables) : 0) + tw * WORDS * 4 + kTable * 4 + th * tw;
}

template <int SRC, int WORDS>
cudaError_t launch_words(const void* src, const int* table, float* out,
                           unsigned long long* clear, int H, int W, int region, int levels,
                           cudaStream_t stream) {
  const dim3 grid((W + kBand - 1) / kBand, (H + kStrip - 1) / kStrip);
  local_entropy_kernel<SRC, WORDS><<<grid, kThreads, entropy_smem<WORDS>(region, SRC), stream>>>(
      src, table, out, clear, H, W, region, levels);
  return cudaGetLastError();
}

// 16 words hold 64 bins, 64 words 256.
template <int SRC>
cudaError_t launch_entropy(const void* src, const int* table, float* out,
                           unsigned long long* clear, int H, int W, int region, int levels,
                           cudaStream_t stream) {
  if (levels <= 64)
    return launch_words<SRC, 16>(src, table, out, clear, H, W, region, levels, stream);
  return launch_words<SRC, 64>(src, table, out, clear, H, W, region, levels, stream);
}

}  // namespace

extern "C" {

// src: (H, W) uint8 grey levels (source 0), or an (H, W, 3) uint8 RGB
// image (source 1), contiguous. plogp: the
// int32 table of c log2 c in fixed point for c = 0..225
// (local_entropy_table_size() entries). out: (H, W) float32. clear: null,
// or an 8-byte slot this launch sets to 0 (the window-sum launch after it
// takes its pick there). region in [1, 15], levels in [1, 256]. Returns a
// cudaError_t (0 on success).
int local_entropy_forward(const void* src, const void* plogp, void* out, void* clear, int H,
                          int W, int region, int levels, int source, void* stream) {
  if (H <= 0 || W <= 0 || region < 1 || region > kMaxRegion || levels < 1 || levels > 256 ||
      source < kGrey || source > kRgbU8)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* table = static_cast<const int*>(plogp);
  float* o = static_cast<float*>(out);
  unsigned long long* c = static_cast<unsigned long long*>(clear);
  if (source == kGrey) return (int)launch_entropy<kGrey>(src, table, o, c, H, W, region, levels, s);
  return (int)launch_entropy<kRgbU8>(src, table, o, c, H, W, region, levels, s);
}

// The grey levels that local_entropy_forward computes in its load from a
// uint8 (H, W, 3) image (source 1), into out: (H, W) uint8.
int local_entropy_grey_levels(const void* src, void* out, int H, int W, void* stream) {
  if (H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const int n = H * W, threads = 256, blocks = (n + threads - 1) / threads;
  grey_levels_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, static_cast<unsigned char*>(out), n);
  return (int)cudaGetLastError();
}

int local_entropy_table_size() { return kTable; }

// The name of a cudaError_t returned above, for error messages.
const char* local_entropy_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
