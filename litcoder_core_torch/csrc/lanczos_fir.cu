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
// the output written once (3.9 MB), about 8.9 MB, so about 2.6 us at the
// published 3.35 TB/s (700 W). K is zero outside the window of +-window /
// cutoff seconds (+-6 s at a 2 s TR), where a TR sees about 30 words: once
// only that band is visited the products are 15-60 MFLOP, under 1 us of
// fp32 FMA. So the kernel is bound by bytes and by latency, not by
// operations, and tensor cores would buy nothing (TF32 would also break the
// 1e-4 bar against the plain version).
//
// Design, against that bound:
//  - Band skip. A block owns 8 TR rows and one slab of 32 lanes x 4 columns.
//    Its warps read all word times (one round trip at the main shape) and
//    take one __ballot_sync per 32-word tile: a word is live when the
//    weight's own predicate |(tr - w) * cutoff| > window (the same rounded
//    fp32 operations) is false at the tile's smallest or largest TR time, or
//    when w lies between them. tr -> (tr - w) * cutoff is monotone, so the
//    two extremes decide for every row, exactly and in any order of words or
//    TRs. Only tiles with a live word are visited, and inside them only the
//    live words (the ballot's mask) are copied, weighted and multiplied.
//    Unsorted word times are exact too; they just leave more tiles live. A
//    NaN cutoff (one TR) makes every word live, as NaN compares false; a
//    negative one (descending TR times) flips the monotone map and changes
//    nothing else.
//  - Latency, not FLOPs, sets the time: a launch is one wave of 240 blocks
//    (8 TR rows x 128 columns at the main shape, ~2 per SM) whose steps
//    depend on each other. So each step keeps many requests in flight: the
//    scan loads all word times at once; right after, one bulk prefetch per
//    block asks L2 for its share of the data matrix (the trainer's data is
//    all in some TR's window); each thread stages the data rows it will
//    multiply into shared memory with cp.async, one commit group per live
//    tile (up to 4 at a time), and multiplies a tile as soon as it has
//    arrived. While the rows travel, the 256 threads evaluate the tile's
//    weights, one (word, row) pair each, branch-free so that a thread's
//    evaluations overlap; each of the 6 slabs of a TR tile recomputes its
//    band's weights (about 1e5 in all): two slabs per block sharing them
//    left SMs idle and ran no faster.
//    The 8 warps split the words; each lane holds 8 rows x 4 columns in
//    registers, and the warps' sums are reduced through shared memory in a
//    fixed order.
//  - Vector width. With D % 4 == 0 and 16-byte aligned data and output, a
//    lane copies each data row and writes each output row as 16 bytes, and
//    a warp moves 512 contiguous bytes. Other shapes take the scalar
//    instantiation (one column per lane, 4-byte copies, no prefetch).
//  - Each base row t is stored once per delay, at row t + d of that delay's
//    column block. The block owning base row t also writes the zero row t of
//    every block whose source row t - d lies outside [0, T_tr). So every
//    output element is written exactly once, and the caller may allocate
//    the output uninitialised.
//  - Weights are lanczosfun's fp32 operations one for one (no fast math, so
//    sinf stays accurate); the sums run in fp32 FMA, in another order over
//    words than the plain product.
//
// Caveat: a word outside the window of a block's rows is never read by that
// block. The dense product turned a non-finite feature of such a word into
// NaN (0 * inf); this kernel does not.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;             // TR rows per block
constexpr int kWarps = 8;            // warps per block; warp r reduces row r
constexpr int kThreads = 32 * kWarps;
constexpr int kTileW = 32;           // words per tile: one warp ballot
constexpr int kBatchTiles = 4;       // live tiles staged at once
constexpr int kBatchWords = kBatchTiles * kTileW;
constexpr int kScanTiles = 128;      // word tiles (4096 words) per pass
constexpr int kScanUnroll = 8;       // word tiles in flight per warp
static_assert(kRows == kWarps, "each warp reduces and writes one TR row");
static_assert(kRows == 8, "weights are read as two float4 per word");
static_assert(kThreads == kTileW * kRows, "one (word, row) pair per thread");

// Dynamic shared memory: the batch's data rows [kBatchWords][32 * V], whose
// space then holds the warps' sums [kWarps][kRows][32 * V].
template <int V>
constexpr int rows_smem_bytes() {
  return (kBatchWords > kWarps * kRows ? kBatchWords : kWarps * kRows) *
         kTileW * V * static_cast<int>(sizeof(float));
}

// lanczosfun in fp32, operation for operation as the JAX package evaluates
// it: t = (tr - w) * cutoff; 1 at t == 0; 0 where |t| > window; else
// ((window * sin(pi t)) * sin(pi t / window)) / (pi^2 * t^2). The _rn
// intrinsics keep nvcc from contracting products and sums into FMAs. The
// value is computed for every t and selected at the end, without branches,
// so that a thread's evaluations can overlap.
__device__ __forceinline__ float lanczos_weight(float tr_time, float word_time,
                                                float cutoff, float window) {
  const float pi = 3.14159265358979323846f;
  const float pi_sq = 9.869604401089358f;  // float(pi ** 2)
  const float t = __fmul_rn(__fsub_rn(tr_time, word_time), cutoff);
  const float pit = __fmul_rn(pi, t);
  const float num =
      __fmul_rn(__fmul_rn(window, sinf(pit)), sinf(__fdiv_rn(pit, window)));
  const float val = __fdiv_rn(num, __fmul_rn(pi_sq, __fmul_rn(t, t)));
  return t == 0.0f ? 1.0f : (fabsf(t) > window ? 0.0f : val);
}

// Whether lanczos_weight can be nonzero (or NaN) for word time w at some TR
// time in [lo, hi]: the weight's own window test at both ends, or w inside.
__device__ __forceinline__ bool word_is_live(float w, float lo, float hi,
                                             float cutoff, float window) {
  return !(fabsf(__fmul_rn(__fsub_rn(lo, w), cutoff)) > window) ||
         !(fabsf(__fmul_rn(__fsub_rn(hi, w), cutoff)) > window) ||
         (lo <= w && w <= hi);
}

// Asks L2 for this block's share of the data matrix (its bytes 16-aligned,
// as the float4 path guarantees), so that device memory streams the data
// while the blocks scan and list their live tiles.
__device__ __forceinline__ void prefetch_data_share(const float* data,
                                                    size_t bytes) {
  const size_t n_blocks = static_cast<size_t>(gridDim.x) * gridDim.y;
  const size_t share = (bytes / n_blocks + 15) / 16 * 16;
  const size_t begin =
      static_cast<size_t>(blockIdx.y * gridDim.x + blockIdx.x) * share;
  if (share == 0 || begin >= bytes) return;
  const unsigned size =
      static_cast<unsigned>(share < bytes - begin ? share : bytes - begin);
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(
                   reinterpret_cast<const char*>(data) + begin),
               "r"(size)
               : "memory");
}

// Copies V floats (16 bytes when V == 4) from device to shared memory
// without holding registers; when !valid it reads nothing and writes zeros.
template <int V>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool valid) {
  const unsigned dst_s =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 4 * V : 0;
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     dst_s),
                 "l"(src), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     dst_s),
                 "l"(src), "r"(bytes));
  }
}

__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until this thread's copies of commit group i of a batch (one group
// per tile, kBatchTiles groups) have arrived: at most kBatchTiles - 1 - i
// newer groups may still be in flight. wait_group takes an immediate.
__device__ __forceinline__ void copy_async_wait_group(int i) {
  static_assert(kBatchTiles == 4, "one case per group of a batch");
  switch (kBatchTiles - 1 - i) {
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
  }
}

template <int V>
__device__ __forceinline__ void load_shared(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    x[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_cols(float* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *p = x[0];
  }
}

// Grid (D slabs of 32 * V columns, T_tr tiles of 8 rows), kThreads threads,
// rows_smem_bytes<V>() of dynamic shared memory. V = 4 needs D % 4 == 0 and
// 16-byte aligned data and out.
template <int V>
__global__ void __launch_bounds__(kThreads)
lanczos_fir_kernel(const float* __restrict__ data,
                   const float* __restrict__ data_times,
                   const float* __restrict__ tr_times,
                   const float* __restrict__ cutoff_ptr,
                   const int* __restrict__ delays,
                   float* __restrict__ out,
                   int t_w, int t_tr, int dim, int n_delays, float window) {
  __shared__ float4 k_s[kBatchWords][kRows / 4];  // [slot][row] weights
  __shared__ float times_s[kScanTiles * kTileW];  // word times of the pass
  __shared__ unsigned masks[kScanTiles];  // live words of each tile
  __shared__ int list[kScanTiles];        // live tiles of the pass
  __shared__ unsigned list_masks[kScanTiles];
  __shared__ int n_live_shared;
  extern __shared__ float4 rows_raw[];
  float* rows = reinterpret_cast<float*>(rows_raw);
  constexpr int kRowFloats = kTileW * V;  // one staged row of the slab

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int t0 = blockIdx.y * kRows;
  const int col = (blockIdx.x * kTileW + lane) * V;  // this lane's columns
  const bool col_ok = col < dim;
  const float cutoff = __ldg(cutoff_ptr);

  // The block's TR times; rows past T_tr are NaN, which fminf/fmaxf skip
  // (any NaN TR time makes the cutoff NaN, and then every tile is live).
  // Thread tid evaluates weights for row tid % 8.
  const float nan = __int_as_float(0x7fffffff);
  float tr[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    tr[r] = t0 + r < t_tr ? __ldg(tr_times + t0 + r) : nan;
  }
  const int k_row = tid % kRows;
  const bool k_row_ok = t0 + k_row < t_tr;
  float k_tr = tr[0];
#pragma unroll
  for (int r = 1; r < kRows; ++r) k_tr = k_row == r ? tr[r] : k_tr;

  float acc[kRows][V];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = 0.0f;
  }

  const int n_tiles = (t_w + kTileW - 1) / kTileW;
  for (int base = 0; base < n_tiles; base += kScanTiles) {
    const int n_scan = min(kScanTiles, n_tiles - base);
    // 1. One ballot per word tile. The word times are loaded before the TR
    // extremes are formed, so both loads share one round trip.
    for (int i0 = warp; i0 < n_scan; i0 += kWarps * kScanUnroll) {
      float word_time[kScanUnroll];
#pragma unroll
      for (int u = 0; u < kScanUnroll; ++u) {
        const int w = (base + i0 + u * kWarps) * kTileW + lane;
        word_time[u] = w < t_w ? __ldg(data_times + w) : 0.0f;
      }
      // Once its first word times are requested, thread 0 asks L2 for the
      // block's share of the data.
      if (V == 4 && tid == 0 && base == 0 && i0 == 0) {
        prefetch_data_share(data, static_cast<size_t>(t_w) * dim * 4);
      }
      float lo = tr[0], hi = tr[0];
#pragma unroll
      for (int r = 1; r < kRows; ++r) {
        lo = fminf(lo, tr[r]);
        hi = fmaxf(hi, tr[r]);
      }
#pragma unroll
      for (int u = 0; u < kScanUnroll; ++u) {
        const int i = i0 + u * kWarps;
        if (i < n_scan) {
          const int w = (base + i) * kTileW + lane;
          times_s[i * kTileW + lane] = word_time[u];
          const bool live =
              w < t_w && word_is_live(word_time[u], lo, hi, cutoff, window);
          const unsigned mask = __ballot_sync(0xffffffffu, live);
          if (lane == 0) masks[i] = mask;
        }
      }
    }
    __syncthreads();
    // 2. Warp 0 lists the live tiles in ascending order.
    if (warp == 0) {
      int count = 0;
      for (int i0 = 0; i0 < n_scan; i0 += 32) {
        const unsigned m = i0 + lane < n_scan ? masks[i0 + lane] : 0u;
        const unsigned b = __ballot_sync(0xffffffffu, m != 0u);
        if (m != 0u) {
          const int at = count + __popc(b & ((1u << lane) - 1u));
          list[at] = base + i0 + lane;
          list_masks[at] = m;
        }
        count += __popc(b);
      }
      if (lane == 0) n_live_shared = count;
    }
    __syncthreads();
    const int n_live = n_live_shared;

    // 3. Batches of up to 4 live tiles. Slot s of a batch is word s % 32 of
    // its tile s / 32; warp `warp` takes slots warp, warp + 8, ... and skips
    // the words outside the window of all 8 rows (a clear bit of the
    // tile's mask).
    for (int b0 = 0; b0 < n_live; b0 += kBatchTiles) {
      const int n_batch = min(kBatchTiles, n_live - b0);
      // Each thread stages the data it will multiply (its lane's columns of
      // its warp's live slots), one commit group per tile, so that the
      // products of a tile start as soon as it has arrived.
#pragma unroll
      for (int i = 0; i < kBatchTiles; ++i) {
        if (i < n_batch) {
          const unsigned m = list_masks[b0 + i];
          for (int s = warp; s < kTileW; s += kWarps) {
            if (m >> s & 1u) {
              const int w = list[b0 + i] * kTileW + s;
              copy_async<V>(rows + (i * kTileW + s) * kRowFloats + lane * V,
                            col_ok ? data + static_cast<size_t>(w) * dim + col
                                   : data,
                            col_ok);
            }
          }
        }
        copy_async_commit();
      }
      // Meanwhile thread tid evaluates row tid % 8 of word tid / 8 of each
      // tile, for live words only: k_s as floats [slot][row] is index
      // i * 256 + tid.
      float* k_flat = reinterpret_cast<float*>(k_s);
#pragma unroll
      for (int i = 0; i < kBatchTiles; ++i) {
        if (i < n_batch) {
          const int tile = list[b0 + i];
          if (list_masks[b0 + i] >> (tid / kRows) & 1u) {
            const int w = tile * kTileW + tid / kRows;
            const float k = lanczos_weight(
                k_tr, times_s[(tile - base) * kTileW + tid / kRows], cutoff,
                window);
            k_flat[i * kThreads + tid] = w < t_w && k_row_ok ? k : 0.0f;
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kBatchTiles; ++i) {
        if (i < n_batch) {
          copy_async_wait_group(i);
          const unsigned m = list_masks[b0 + i];
          for (int s = i * kTileW + warp; s < (i + 1) * kTileW; s += kWarps) {
            if (!(m >> (s % kTileW) & 1u)) continue;
            float x[V];
            load_shared<V>(rows + s * kRowFloats + lane * V, x);
            const float4 ka = k_s[s][0];
            const float4 kb = k_s[s][1];
            const float k[kRows] = {ka.x, ka.y, ka.z, ka.w,
                                    kb.x, kb.y, kb.z, kb.w};
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
#pragma unroll
              for (int v = 0; v < V; ++v) {
                acc[r][v] = fmaf(k[r], x[v], acc[r][v]);
              }
            }
          }
        }
      }
      __syncthreads();  // the batch's rows, weights and list are consumed
    }
  }

  // 4. Reduce the warps' sums (in the staged rows' space); warp r then owns
  // TR row t0 + r.
  float* partial = rows;  // [kWarps][kRows][kRowFloats]
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    store_cols<V>(partial + (warp * kRows + r) * kRowFloats + lane * V,
                  acc[r]);
  }
  __syncthreads();
  const int t = t0 + warp;
  if (t >= t_tr || !col_ok) return;
  float sum[V];
#pragma unroll
  for (int v = 0; v < V; ++v) sum[v] = 0.0f;
#pragma unroll
  for (int p = 0; p < kWarps; ++p) {
    float y[V];
    load_shared<V>(partial + (p * kRows + warp) * kRowFloats + lane * V, y);
#pragma unroll
    for (int v = 0; v < V; ++v) sum[v] += y[v];
  }
  float zero[V];
#pragma unroll
  for (int v = 0; v < V; ++v) zero[v] = 0.0f;

  // 5. Row t goes to row t + d of each delay block; row t of a block whose
  // source row t - d lies outside is zero.
  const size_t row_stride = static_cast<size_t>(n_delays) * dim;
  for (int j = 0; j < n_delays; ++j) {
    const int shift = __ldg(delays + j);
    float* block = out + static_cast<size_t>(j) * dim + col;
    const int dst = t + shift;
    if (dst >= 0 && dst < t_tr) store_cols<V>(block + dst * row_stride, sum);
    const int src = t - shift;
    if (src < 0 || src >= t_tr) store_cols<V>(block + t * row_stride, zero);
  }
}

template <int V>
cudaError_t launch_kernel(const float* data, const float* data_times,
                          const float* tr_times, const float* cutoff,
                          const int* delays, float* out, int t_w, int t_tr,
                          int dim, int n_delays, float window,
                          cudaStream_t stream) {
  constexpr int smem = rows_smem_bytes<V>();
  const cudaError_t err = cudaFuncSetAttribute(
      lanczos_fir_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((dim + kTileW * V - 1) / (kTileW * V),
                  (t_tr + kRows - 1) / kRows);
  lanczos_fir_kernel<V><<<grid, kThreads, smem, stream>>>(
      data, data_times, tr_times, cutoff, delays, out, t_w, t_tr, dim,
      n_delays, window);
  return cudaGetLastError();
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = dim % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaError_t err =
      vec4 ? launch_kernel<4>(data, data_times, tr_times, cutoff, delays, out,
                              t_w, t_tr, dim, n_delays, window, s)
           : launch_kernel<1>(data, data_times, tr_times, cutoff, delays, out,
                              t_w, t_tr, dim, n_delays, window, s);
  return static_cast<int>(err);
}
