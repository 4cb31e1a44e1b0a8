// The weighted combine of a mixture of experts' routed rows, for Hopper
// (sm_90a): the last step of DeepseekV2MoE.routed
// (litcoder_core_torch/features/deepseek_v2.py).
//
// Replaces no TPU kernel: the JAX package has no mixture of experts. It was
// added for this combine, which the torch ops did as a chain over the
// whole of the experts' output: ys cast to float32, times each row's
// weight, a float32 zeros, an index_add of the rows into it (random
// atomic read-modify-writes) and a cast back, about 4.7 GB moved a call at
// DeepSeek-V2-Lite's shape to sum k rows a token. Given the experts' rows
// in expert-sorted order and, for each (token t, slot j), where its row
// landed, the kernel computes (bf16 in, float32 sum, bf16 out)
//
//     out[t] = bf16( sum_{j < k} weights[t, j] * float(ys[pos[t k + j]]) )
//
// with the sum taken in slot order j = 0, 1, ..., each product rounded and
// then added (__fmul_rn, __fadd_rn: no contraction into an FMA), exactly
// as moe_combine_reference (ops/moe_combine.py) does it in torch ops, so
// the two agree bit for bit and a rerun gives the same bits.
//
// Bound: one pass, each token's k rows read once (N k H 2 bytes), its k
// weights and positions (N k 8) and one bf16 row written (N H 2). At
// DeepSeek-V2-Lite's training-cell shape (N 18,432 tokens, k 6, H 2,048)
// that is 529,367,040 bytes, 0.158 ms at 3.35 TB/s. Nothing of it touches
// the tensor cores.
//
// Design, against that bound:
//  - One block a token. Its threads cover the row in 16-byte chunks of 8
//    bf16 lanes (H / 8 chunks; 256 threads and one chunk each at H 2,048),
//    so neighbouring threads read neighbouring addresses of a 4 KB
//    contiguous row, and each row is one vector load a thread.
//  - A token's rows are loaded together, up to kGroup of them into
//    registers before any is added, so the loads of a thread are in flight
//    at once; many resident blocks cover the latency of the positions'
//    load that they wait on.
//  - The sum lives in 8 float32 registers a thread. No atomics, no shared
//    memory, no scratch; each output chunk is written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kGroup = 8;          // rows a thread loads before it adds

__device__ __forceinline__ void add_row(float (&acc)[8], const uint4& v,
                                        float w) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    acc[2 * q] = __fadd_rn(acc[2 * q], __fmul_rn(w, f.x));
    acc[2 * q + 1] = __fadd_rn(acc[2 * q + 1], __fmul_rn(w, f.y));
  }
}

// Block t sums token t's k rows; chunks = H / 8.
__global__ void __launch_bounds__(kMaxThreads)
moe_combine_kernel(const uint4* __restrict__ ys, const int* __restrict__ pos,
                   const float* __restrict__ weights, uint4* __restrict__ out,
                   int k, int chunks) {
  const int t = blockIdx.x;
  const int* slot_pos = pos + static_cast<size_t>(t) * k;
  const float* slot_w = weights + static_cast<size_t>(t) * k;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
    for (int j0 = 0; j0 < k; j0 += kGroup) {
      uint4 rows[kGroup];
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        if (j0 + r < k) {
          const size_t row = static_cast<size_t>(slot_pos[j0 + r]);
          rows[r] = __ldcs(ys + row * chunks + c);
        }
      }
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        if (j0 + r < k) add_row(acc, rows[r], slot_w[j0 + r]);
      }
    }
    uint4 packed;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      h[q] = __floats2bfloat162_rn(acc[2 * q], acc[2 * q + 1]);
    }
    out[static_cast<size_t>(t) * chunks + c] = packed;
  }
}

}  // namespace

// Plain C entry point for ctypes. All pointers are device pointers of
// contiguous buffers: ys (n k, h) bf16, 16-byte aligned; pos (n k,) int32,
// a permutation of 0..n k - 1 (pos[t k + j] is the row of ys that holds
// token t's slot j); weights (n, k) float32; out (n, h) bf16, 16-byte
// aligned, every entry written. The launch goes on `stream` and does not
// synchronise; the return value is cudaGetLastError() after the launch (0
// when it was accepted), or cudaErrorInvalidValue for sizes the kernel does
// not take (h not a positive multiple of 8, n or k not positive).
extern "C" int moe_combine_launch(const void* ys, const int* pos,
                                  const float* weights, void* out, int n,
                                  int k, int h, void* stream) {
  if (n <= 0 || k <= 0 || h <= 0 || h % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunks = h / 8;
  const int threads = chunks < kMaxThreads ? ((chunks + 31) / 32) * 32
                                           : kMaxThreads;
  moe_combine_kernel<<<n, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(ys), pos, weights, static_cast<uint4*>(out),
      k, chunks);
  return static_cast<int>(cudaGetLastError());
}
