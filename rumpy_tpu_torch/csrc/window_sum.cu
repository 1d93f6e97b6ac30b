// Window sums of an entropy map for Hopper (sm_90a), bound to Python over
// ctypes: the pooled map of entropy patch selection, and optionally its pick.
//
// Replaces the XLA code of rumpy_tpu/ops/entropy.py::entropy_patch_positions
// (:88, `_box_filter_same(ent, crop_size)` and the trim; no Pallas kernel):
// for an (H, W) float32 map and a window of K x K, the (H - K + 1, W - K + 1)
// map whose entry (y, x) is the sum of the window with top-left corner
// (y, x). The sums are the plain version's to the bit: first down the rows,
// R[y][c] = ((e[y][c] + e[y+1][c]) + ...) + e[y+K-1][c], rounded to float32
// at every add, then across the columns of R in the same ascending order.
// Only adds, so no contraction can change a bit.
//
// With a pick slot, the launch also leaves there the first maximum of the
// map in row-major order (or the first minimum), as np.nanargmax and
// torch.argmax choose it: a 64-bit key, the value's bits in an order that
// sorts as the floats do (the value negated for the minimum) above
// 0xffffffff - index, so the largest key is the best value at its first
// index. Each block reduces its keys and takes one atomicMax on the slot,
// which must hold 0 before the launch (the entropy launch before it clears
// it). A max is the same in any order, so the pick is deterministic.
//
// Bound on an H100 SXM, for the 339x510 map and K = 48 of the train path:
// read 4*H*W bytes and write 4*(H-K+1)*(W-K+1), 0.37 us at 3.35 TB/s; the
// 2K adds an output (13 M adds in all) take 0.2 us at the float32 rate.
//
// Design: a block owns kRows x kCols outputs. It stages its part of the
// map, (kRows + K - 1) x (kCols + K - 1), in shared memory, kBatch loads of
// a thread in flight together. A thread then sums one column of that tile
// down the rows for all kRows outputs at once (kRows independent chains,
// each in ascending order), and a thread sums a row segment of kSeg outputs
// across the columns of R the same way, so the adds of one chain wait on
// each other but never on another chain's. Above 48 KB of shared memory
// (K > 61) the launch asks for more, up to the 227 KB a block may hold.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;   // output rows of a block: the chains of a column sum
constexpr int kSeg = 8;     // outputs of a row segment: the chains of a row sum
constexpr int kCols = 64;   // output columns of a block
constexpr int kThreads = 128;
constexpr int kBatch = 8;  // loads of a thread in flight together while staging
constexpr int kMaxShared = 227 * 1024 - 256;  // dynamic, beside the static `best`

__host__ __device__ constexpr int shared_floats(int K) {
  return (kRows + K - 1) * (kCols + K - 1) + kRows * (kCols + K - 1);
}

__device__ __forceinline__ unsigned long long pick_key(float v, unsigned index, bool lowest) {
  const float s = (lowest ? -v : v) + 0.0f;  // -0 sorts as +0
  const unsigned u = __float_as_uint(s);
  const unsigned ordered = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)ordered << 32) | (0xffffffffu - index);
}

// acc[m] = ((v[m] + v[m+1]) + ...) + v[m+K-1] for m < N, v[a] = v0[a * step],
// rounded at every add: N chains that each add in ascending order, fed one
// value at a time.
template <int N>
__device__ __forceinline__ void window_chains(const float* v0, int step, int K, float* acc) {
#pragma unroll
  for (int a = 0; a < N; ++a) {  // chains start; those begun take v[a] if it is theirs
    const float v = v0[a * step];
#pragma unroll
    for (int m = 0; m < N; ++m) {
      if (m == a) acc[m] = v;
      else if (m < a && a - m < K) acc[m] = __fadd_rn(acc[m], v);
    }
  }
  int a = N;
  for (; a < K; ++a) {  // every chain takes v[a]
    const float v = v0[a * step];
#pragma unroll
    for (int m = 0; m < N; ++m) acc[m] = __fadd_rn(acc[m], v);
  }
  for (; a < K + N - 1; ++a) {  // chains end: m takes v[a] while a - m < K
    const float v = v0[a * step];
#pragma unroll
    for (int m = 0; m < N; ++m)
      if (a - m < K) acc[m] = __fadd_rn(acc[m], v);
  }
}

__global__ void __launch_bounds__(kThreads)
window_sum_kernel(const float* __restrict__ e, float* __restrict__ out,
                  unsigned long long* pick, int H, int W, int K, int lowest) {
  extern __shared__ __align__(16) float sm[];
  __shared__ unsigned long long best[kThreads / 32];
  const int Ho = H - K + 1, Wo = W - K + 1;
  const int TH = kRows + K - 1, RW = kCols + K - 1;
  float* tile = sm;         // TH x RW of the map
  float* R = sm + TH * RW;  // kRows x RW row sums
  const int x0 = blockIdx.x * kCols, y0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;

  for (int i0 = 0; i0 < TH * RW; i0 += kThreads * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {  // every load of a batch in flight together
      const int i = i0 + u * kThreads + tid;
      const int r = i / RW, c = i - r * RW;
      const int y = y0 + r, x = x0 + c;
      // outside the map: zeros, never part of an output's sum
      v[u] = (i < TH * RW && y < H && x < W) ? e[(size_t)y * W + x] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads + tid;
      if (i < TH * RW) tile[i] = v[u];
    }
  }
  __syncthreads();
  for (int c = tid; c < RW; c += kThreads) {
    float acc[kRows];
    window_chains<kRows>(tile + c, RW, K, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) R[r * RW + c] = acc[r];
  }
  __syncthreads();

  unsigned long long key = 0ull;
  constexpr int kSegs = kCols / kSeg;
  for (int t = tid; t < kRows * kSegs; t += kThreads) {
    const int r = t / kSegs, xs = (t - r * kSegs) * kSeg;
    const int y = y0 + r;
    if (y >= Ho || x0 + xs >= Wo) continue;
    float acc[kSeg];
    window_chains<kSeg>(R + r * RW + xs, 1, K, acc);
#pragma unroll
    for (int m = 0; m < kSeg; ++m) {
      const int x = x0 + xs + m;
      if (x < Wo) {
        out[(size_t)y * Wo + x] = acc[m];
        if (pick != nullptr) {
          const unsigned long long k = pick_key(acc[m], (unsigned)(y * Wo + x), lowest != 0);
          key = k > key ? k : key;
        }
      }
    }
  }
  if (pick == nullptr) return;  // the same for every thread: no barrier skipped
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, key, off);
    key = o > key ? o : key;
  }
  if ((tid & 31) == 0) best[tid >> 5] = key;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kThreads / 32; ++w) key = best[w] > key ? best[w] : key;
    atomicMax(pick, key);
  }
}

}  // namespace

extern "C" {

// e: (H, W) float32, contiguous; out: (H - K + 1, W - K + 1) float32. pick:
// null, or an 8-byte slot holding 0 that receives the key of the first
// maximum (lowest = 0) or minimum (lowest = 1) of out. 1 <= K <= min(H, W),
// and K at most window_sum_max_size(). Returns a cudaError_t (0 on success).
int window_sum_forward(const void* e, void* out, void* pick, int H, int W, int K, int lowest,
                       void* stream) {
  if (K < 1 || K > H || K > W) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)shared_floats(K) * 4;
  if (smem > (size_t)kMaxShared) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((W - K + 1 + kCols - 1) / kCols, (H - K + 1 + kRows - 1) / kRows);
  window_sum_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(e), static_cast<float*>(out),
      static_cast<unsigned long long*>(pick), H, W, K, lowest);
  return (int)cudaGetLastError();
}

// The largest window the kernel takes: its part of the map and its row sums
// fill the shared memory a block may hold.
int window_sum_max_size() {
  int K = 1;
  while ((size_t)shared_floats(K + 1) * 4 <= (size_t)kMaxShared) ++K;
  return K;
}

const char* window_sum_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
