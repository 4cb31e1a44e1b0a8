// Fused Lanczos downsampling + FIR delay stacking for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel litcoder_core_tpu/ops/pallas_kernels.py:
// _lanczos_fir_kernel (launched by lanczos_fir_fused, dispatched by
// lanczos_fir). It computes
//
//     out[:, j*D:(j+1)*D] = shift_{delays[j]}(K @ data),
//     K[t, w] = lanczosfun(cutoff, tr_times[t] - data_times[w], window),
//
// where shift_d moves rows down by d and the rows shifted in from outside
// are zero (the first d when d > 0, the last |d| when d < 0).
//
// Bound on the H100 SXM at the trainer's main shape (T_w ~ 1600 words,
// T_tr = 320 TRs, D = 768, 4 delays): the data is read once (4.9 MB) and
// the output written once (3.9 MB), about 8.8 MB, so about 2.6 us at the
// published 3.35 TB/s (700 W). The work K needs is small next to that:
// inside the Lanczos window a TR sees about 30 words, so about 15 MFLOP.
// This first design is simple and right, and far from that bound: it
// evaluates K densely for every (TR, word) pair, once per feature tile.
//
// Design:
//  - The grid runs over (feature tile of 64 columns, TR tile of 32 rows).
//    Each block loops over all words in tiles of 32. It computes its K
//    tile in shared memory from the two time vectors with the same fp32
//    expression as lanczosfun (K never lives in device memory), loads the
//    data tile, and accumulates in fp32 FMA. Every shape is taken: ragged
//    edges are masked, and word times need not be sorted.
//  - Each base row t is stored once per delay, at row t + d of that delay's
//    column block. The block owning base row t also writes the zero row t of
//    every block whose source row t - d lies outside [0, T_tr). So every
//    output element is written exactly once, and the caller may allocate
//    the output uninitialised.
//  - Skipping word tiles outside the window, tensor cores and TMA are left
//    for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kTileT = 32;    // TR rows per block
constexpr int kTileD = 64;    // feature columns per block
constexpr int kTileW = 32;    // words per step of the inner loop
constexpr int kThreads = 256;
constexpr int kColGroups = 16;                       // threads across columns
constexpr int kCols = kTileD / kColGroups;           // 4 columns per thread
constexpr int kRows = kTileT / (kThreads / kColGroups);  // 2 rows per thread

// lanczosfun in fp32, operation for operation as the JAX package evaluates
// it: t = (tr - w) * cutoff; 1 at t == 0; 0 where |t| > window; else
// ((window * sin(pi t)) * sin(pi t / window)) / (pi^2 * t^2). The _rn
// intrinsics keep nvcc from contracting products and sums into FMAs.
__device__ __forceinline__ float lanczos_weight(float tr_time, float word_time,
                                                float cutoff, float window) {
  const float pi = 3.14159265358979323846f;
  const float pi_sq = 9.869604401089358f;  // float(pi ** 2)
  const float t = __fmul_rn(__fsub_rn(tr_time, word_time), cutoff);
  if (t == 0.0f) return 1.0f;
  if (fabsf(t) > window) return 0.0f;
  const float pit = __fmul_rn(pi, t);
  const float num =
      __fmul_rn(__fmul_rn(window, sinf(pit)), sinf(__fdiv_rn(pit, window)));
  return __fdiv_rn(num, __fmul_rn(pi_sq, __fmul_rn(t, t)));
}

__global__ void __launch_bounds__(kThreads)
lanczos_fir_kernel(const float* __restrict__ data,
                   const float* __restrict__ data_times,
                   const float* __restrict__ tr_times,
                   const float* __restrict__ cutoff_ptr,
                   const int* __restrict__ delays,
                   float* __restrict__ out,
                   int t_w, int t_tr, int dim, int n_delays, float window) {
  __shared__ float k_tile[kTileT][kTileW + 1];
  __shared__ float d_tile[kTileW][kTileD];
  __shared__ float tr_tile[kTileT];

  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * kTileD;
  const int t0 = blockIdx.y * kTileT;
  const int tx = tid % kColGroups;  // columns d0 + tx + 16 c
  const int ty = tid / kColGroups;  // rows t0 + 2 ty + r
  const float cutoff = *cutoff_ptr;

  if (tid < kTileT) {
    tr_tile[tid] = (t0 + tid < t_tr) ? tr_times[t0 + tid] : 0.0f;
  }

  float acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
  }

  for (int w0 = 0; w0 < t_w; w0 += kTileW) {
    __syncthreads();  // the previous tiles are consumed; tr_tile is visible
    for (int i = tid; i < kTileT * kTileW; i += kThreads) {
      const int r = i / kTileW, c = i % kTileW;
      const int w = w0 + c;
      k_tile[r][c] = (t0 + r < t_tr && w < t_w)
                         ? lanczos_weight(tr_tile[r], data_times[w], cutoff,
                                          window)
                         : 0.0f;
    }
    for (int i = tid; i < kTileW * kTileD; i += kThreads) {
      const int r = i / kTileD, c = i % kTileD;
      const int w = w0 + r, d = d0 + c;
      d_tile[r][c] =
          (w < t_w && d < dim) ? data[static_cast<size_t>(w) * dim + d] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kTileW; ++k) {
      float b[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) b[c] = d_tile[k][tx + kColGroups * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float a = k_tile[ty * kRows + r][k];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(a, b[c], acc[r][c]);
      }
    }
  }

  const size_t row_stride = static_cast<size_t>(n_delays) * dim;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = t0 + ty * kRows + r;
    if (t >= t_tr) continue;
    for (int j = 0; j < n_delays; ++j) {
      const int shift = delays[j];
      float* block = out + static_cast<size_t>(j) * dim;
      const int dst = t + shift;  // where base row t lands in block j
      if (dst >= 0 && dst < t_tr) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = d0 + tx + kColGroups * c;
          if (d < dim) block[dst * row_stride + d] = acc[r][c];
        }
      }
      const int src = t - shift;  // the base row that would land on row t
      if (src < 0 || src >= t_tr) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = d0 + tx + kColGroups * c;
          if (d < dim) block[t * row_stride + d] = 0.0f;
        }
      }
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. All pointers are device pointers of
// contiguous buffers: data (t_w, dim), data_times (t_w,), tr_times (t_tr,),
// cutoff (1,), delays (n_delays,) int32, out (t_tr, n_delays * dim). The
// launch goes on `stream` and does not synchronise; the return value is
// cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int lanczos_fir_launch(const float* data, const float* data_times,
                                  const float* tr_times, const float* cutoff,
                                  const int* delays, float* out, int t_w,
                                  int t_tr, int dim, int n_delays, float window,
                                  void* stream) {
  if (t_tr <= 0 || dim <= 0 || n_delays <= 0) return 0;
  const dim3 grid((dim + kTileD - 1) / kTileD, (t_tr + kTileT - 1) / kTileT);
  lanczos_fir_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      data, data_times, tr_times, cutoff, delays, out, t_w, t_tr, dim,
      n_delays, window);
  return static_cast<int>(cudaGetLastError());
}
