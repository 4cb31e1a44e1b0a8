// One step of the Lanczos recurrence with full reorthogonalisation, for
// Hopper (sm_90a): everything of a step of _lanczos_lmax
// (litcoder_core_torch/models/ridge.py) after the operator's matvec.
//
// Replaces no TPU kernel. The JAX package runs the same recurrence
// (litcoder_core_tpu/models/ridge.py: _lanczos_lmax) as one compiled
// fori_loop; written as torch ops, a step was about 22 launches of a few
// microseconds of device work each, and the host could not issue them as
// fast as the card finished them. This kernel makes a step the operator's
// matvec plus one launch. Given w = A v, step i (fp32, in this order):
//
//     a = w . v
//     w <- w - a v - b_prev v_prev
//     c = basis[:i] w;  w <- w - basis[:i]^T c      (classical Gram-Schmidt)
//     b = ||w||;  scale = max(scale, |a|);  alive = b > 1e-6 max(scale, 1)
//     v_next = alive ? w / max(b, 1e-30) : 0;  b = alive ? b : 0
//     basis[i] = v;  diag[i] = a;  off[i] = b;  v_prev <- v_next
//     state = (b, scale)
//
// Rows i.. of basis are zero in the plain version's full products, so only
// rows < i are read. max and the clamp propagate NaN as torch.maximum and
// torch.clamp do, so a step that overflows reads as in the plain version
// (the caller's fallback tests the tridiagonal for finiteness).
//
// Bound: a step reads w, v, v_prev and rows 0..i-1 of basis, and writes
// v_next and basis[i]: (3 + i) n + 2 n floats, 0.21 MB at n 1,424 and
// i 31.5 (the mean of a 64-step call), about 0.06 us at 3.35 TB/s. The
// steps depend on each other through the matvec, so what sets the time is
// latency: the launch, the reductions, and the round trips to L2 for the
// basis rows, each of which a dependent multiply-add waits for.
//
// Design, against that bound:
//  - A cluster of 8 blocks of 256 threads (Hopper's thread block cluster)
//    serves any n and any alignment. Block r owns the r-th eighth of the
//    elements and thread t of it the elements t, t + 256, ... of that
//    slice, so a warp's load is 128 contiguous bytes and up to n 2,048 a
//    thread owns one element. Only its owner reads and writes an element
//    of w, v, v_prev and basis[i], so the intermediate w is kept in
//    v_prev's slots (v_prev is read first, by the same thread) and w itself
//    is only read. One block alone (measured) waited on a round trip for
//    most basis rows and took 16-21 us a step at n 1,424.
//  - The basis is read 32 rows at a time: a thread loads its element of
//    all 32 rows into registers (rows past i - 1 read row i - 1 and are
//    dropped), so the loads go out together and a group costs one round
//    trip to L2, then multiplies.
//  - Sums are fixed-order, so a rerun gives the same bits: a thread sums
//    its elements in order, a warp by a xor butterfly, the 8 warps'
//    partials in warp order, the 8 blocks' in rank order, each block
//    reading the others' partials from their shared memory after a cluster
//    barrier. For the coefficients c each thread keeps 32 partial dot
//    products, a warp sums them with 31 shuffles so that lane r holds row
//    r's sum, and the warps' and the blocks' rows are added likewise; the
//    correction sums each element's rows in row order. c (i floats) is
//    kept in every block's dynamic shared memory, which caps the steps of
//    one recurrence at kMaxSteps.
//  - Nothing reads back to the host: b_prev and scale live in `state`.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlocks = 8;                 // the cluster (portable maximum)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowGroup = 32;              // basis rows read together
constexpr int kMaxSteps = 8192;            // c in 32 KB of shared memory
constexpr unsigned kFull = 0xffffffffu;

// The block's sum of x, the same bits in every thread. `red` holds kWarps
// floats; the first barrier lets the previous call's readers finish.
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) total += red[k];
  return total;
}

// Sums 32 values across a warp; lane r returns the warp's sum of p[r]. Each
// stage halves the values a lane keeps and adds its partner's half.
__device__ __forceinline__ float warp_transpose_sum(float (&p)[kRowGroup],
                                                   int lane) {
#pragma unroll
  for (int o = kRowGroup / 2; o >= 1; o >>= 1) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int q = 0; q < o; ++q) {
      const float send = upper ? p[q] : p[q + o];
      const float keep = upper ? p[q + o] : p[q];
      p[q] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
  return p[0];
}

// The cluster's sum of the blocks' `slot[k]`, added in rank order after a
// cluster barrier. Slots are used in alternation (exchange e writes slot
// e % 2), so one barrier an exchange suffices: a block writes a slot again
// only after the next barrier, which every reader of its last use passed.
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster,
                                             float* slot, int k) {
  float total = 0.0f;
#pragma unroll
  for (int r = 0; r < kBlocks; ++r) total += cluster.map_shared_rank(slot, r)[k];
  return total;
}

// torch.maximum and torch.clamp(min=) keep NaN; fmaxf drops it.
__device__ __forceinline__ float max_keep_nan(float x, float y) {
  return isnan(x) ? x : (isnan(y) ? y : fmaxf(x, y));
}

// One cluster of kBlocks blocks of kThreads threads, m floats of dynamic
// shared memory.
__global__ void __cluster_dims__(kBlocks, 1, 1) __launch_bounds__(kThreads, 1)
lanczos_step_kernel(const float* __restrict__ w, const float* __restrict__ v,
                    float* __restrict__ v_prev, float* __restrict__ basis,
                    float* __restrict__ diag, float* __restrict__ off,
                    float* __restrict__ state, int n, int i) {
  extern __shared__ float coef[];                 // c_j, j < i
  __shared__ float red[kWarps];
  __shared__ float rows[kWarps][kRowGroup];
  __shared__ float slots[2][kRowGroup];           // partials for the cluster
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int share = (n + kBlocks - 1) / kBlocks;
  const int begin = static_cast<int>(cluster.block_rank()) * share;
  const int end = min(n, begin + share);
  const float b_prev = state[0];
  const float scale_prev = state[1];
  int exchange = 0;

  // 1. a = w . v
  float part = 0.0f;
  for (int e = begin + tid; e < end; e += kThreads) {
    part = fmaf(w[e], v[e], part);
  }
  part = block_sum(part, red);
  float* slot = slots[exchange++ & 1];
  if (tid == 0) slot[0] = part;
  cluster.sync();
  const float a = cluster_sum(cluster, slot, 0);

  // 2. w - a v - b_prev v_prev, into v_prev's slots
  for (int e = begin + tid; e < end; e += kThreads) {
    v_prev[e] = (w[e] - a * v[e]) - b_prev * v_prev[e];
  }

  // 3. c = basis[:i] w, kRowGroup rows at a time
  for (int g = 0; g < i; g += kRowGroup) {
    float p[kRowGroup];
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r) p[r] = 0.0f;
    for (int e = begin + tid; e < end; e += kThreads) {
      const float x = v_prev[e];
      float b[kRowGroup];
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) {
        const int row = g + r < i ? g + r : i - 1;
        b[r] = basis[static_cast<size_t>(row) * n + e];
      }
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) p[r] = fmaf(b[r], x, p[r]);
    }
    const float mine = warp_transpose_sum(p, lane);
    __syncthreads();                  // the previous group's rows are read
    rows[warp][lane] = mine;
    __syncthreads();
    slot = slots[exchange++ & 1];
    if (tid < kRowGroup) {
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) sum += rows[k][tid];
      slot[tid] = sum;
    }
    cluster.sync();
    if (tid < kRowGroup && g + tid < i) {
      coef[g + tid] = cluster_sum(cluster, slot, tid);
    }
  }
  __syncthreads();

  // 4. w - basis[:i]^T c (each element's correction summed in row order),
  // ||w||^2
  float sq = 0.0f;
  for (int e = begin + tid; e < end; e += kThreads) {
    float s = 0.0f;
    for (int g = 0; g < i; g += kRowGroup) {
      float b[kRowGroup];
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) {
        const int row = g + r < i ? g + r : i - 1;
        b[r] = basis[static_cast<size_t>(row) * n + e];
      }
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) {
        const int row = g + r < i ? g + r : i - 1;
        s = g + r < i ? fmaf(coef[row], b[r], s) : s;
      }
    }
    const float x = v_prev[e] - s;
    sq = fmaf(x, x, sq);
    v_prev[e] = x;
  }
  sq = block_sum(sq, red);
  slot = slots[exchange++ & 1];
  if (tid == 0) slot[0] = sq;
  cluster.sync();
  const float b = sqrtf(cluster_sum(cluster, slot, 0));

  // 5. breakdown test, v_next into v_prev's slots, basis[i] = v
  const float scale = max_keep_nan(scale_prev, fabsf(a));
  const bool alive = b > 1e-6f * max_keep_nan(scale, 1.0f);
  const float denom = fmaxf(b, 1e-30f);
  float* row_i = basis + static_cast<size_t>(i) * n;
  for (int e = begin + tid; e < end; e += kThreads) {
    v_prev[e] = alive ? v_prev[e] / denom : 0.0f;
    row_i[e] = v[e];
  }
  if (cluster.block_rank() == 0 && tid == 0) {
    const float b_kept = alive ? b : 0.0f;
    diag[i] = a;
    off[i] = b_kept;
    state[0] = b_kept;
    state[1] = scale;
  }
  cluster.sync();   // the other blocks may still read this block's slots
}

}  // namespace

// Plain C entry point for ctypes. All pointers are device pointers of
// contiguous float32 buffers: w (n,) = A v, read only; v (n,); v_prev (n,),
// which receives v_next; basis (m, n); diag (m,); off (m,); state (2,) =
// (b_prev, scale). Step i of m (0 <= i < m <= min(n, kMaxSteps)). The launch
// goes on `stream` and does not synchronise; the return value is
// cudaGetLastError() after the launch (0 when it was accepted), or
// cudaErrorInvalidValue for sizes the kernel does not take.
extern "C" int lanczos_step_launch(const float* w, const float* v,
                                   float* v_prev, float* basis, float* diag,
                                   float* off, float* state, int n, int m,
                                   int i, void* stream) {
  if (n <= 0 || m <= 0 || m > n || m > kMaxSteps || i < 0 || i >= m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = m * static_cast<int>(sizeof(float));
  lanczos_step_kernel<<<kBlocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      w, v, v_prev, basis, diag, off, state, n, i);
  return static_cast<int>(cudaGetLastError());
}
