// param_stats_batched: per-client (mean, var) of a client-stacked tensor.
//
// Replaces the Pallas kernel repro/kernels/param_stats.py
// (param_stats_batched, body _stats_kernel): the paper's §III.B
// distribution summary, fp32 (mean, var) over the trailing axes of an
// (N, n) tensor read at its source width (fp32 or bf16).
//
// Bound: bytes. Each element is read once and costs a handful of fp32
// operations, far below the H100's 295 operations per byte, so the
// floor is N*n*itemsize over 3.35 TB/s. On the BSO-SL round the
// tensors are small (5 to 9,216 elements a client), and one launch is
// made per parameter leaf, so launch latency dominates there.
//
// Design. The TPU kernel walks a client's blocks in order on an
// (N, n_blocks) grid and carries its sums from one grid step to the
// next. Hopper blocks run in no order, so nothing is carried:
//   pass 1, grid (S, N): CTA (s, c) walks a grid-stride slice of client
//     c's row. Each thread keeps an fp32 Welford triple (count, mean,
//     M2); the triples merge with Chan's formula across warp shuffles
//     and then across the CTA's warps, and the CTA writes its partial.
//   pass 2, grid (N): one CTA merges client c's S partials the same way
//     and writes mean and var = max(M2 / n, 0); n == 0 gives NaN.
// Welford/Chan is this kernel's guard against cancellation when
// mean^2 >> var (the TPU kernel shifts by its first block's mean
// instead). Indices are 64-bit, so rows of 2^31 elements and more work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMergeThreads = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Chan et al.'s pairwise merge of two (count, mean, M2) triples into a.
__device__ __forceinline__ void chan_merge(long long& na, float& ma, float& m2a,
                                           long long nb, float mb, float m2b) {
  if (nb == 0) return;
  if (na == 0) {
    na = nb;
    ma = mb;
    m2a = m2b;
    return;
  }
  const long long n = na + nb;
  const float delta = mb - ma;
  const float fb = (float)nb / (float)n;
  ma = ma + delta * fb;
  m2a = m2a + m2b + delta * delta * (float)na * fb;
  na = n;
}

__device__ __forceinline__ void warp_merge(long long& n, float& mean, float& m2) {
  for (int off = 16; off > 0; off >>= 1) {
    const long long nb = __shfl_down_sync(0xffffffffu, n, off);
    const float mb = __shfl_down_sync(0xffffffffu, mean, off);
    const float m2b = __shfl_down_sync(0xffffffffu, m2, off);
    chan_merge(n, mean, m2, nb, mb, m2b);
  }
}

// Merge every thread's triple; thread 0 ends with the CTA's result.
__device__ __forceinline__ void block_merge(long long& n, float& mean, float& m2) {
  __shared__ long long s_n[32];
  __shared__ float s_mean[32];
  __shared__ float s_m2[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_merge(n, mean, m2);
  if (lane == 0) {
    s_n[warp] = n;
    s_mean[warp] = mean;
    s_m2[warp] = m2;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    n = lane < n_warps ? s_n[lane] : 0;
    mean = lane < n_warps ? s_mean[lane] : 0.f;
    m2 = lane < n_warps ? s_m2[lane] : 0.f;
    warp_merge(n, mean, m2);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stats_partial_kernel(const T* __restrict__ x, long long n, int S,
                     long long* __restrict__ part_n, float* __restrict__ part_mean,
                     float* __restrict__ part_m2) {
  const long long client = blockIdx.y;
  const int s = blockIdx.x;
  const T* row = x + client * n;
  long long cnt = 0;
  float mean = 0.f, m2 = 0.f;
  const long long stride = (long long)S * blockDim.x;
  for (long long i = (long long)s * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float v = to_f32(row[i]);
    cnt += 1;
    const float delta = v - mean;
    mean += delta / (float)cnt;
    m2 += delta * (v - mean);
  }
  block_merge(cnt, mean, m2);
  if (threadIdx.x == 0) {
    const long long idx = client * S + s;
    part_n[idx] = cnt;
    part_mean[idx] = mean;
    part_m2[idx] = m2;
  }
}

__global__ void __launch_bounds__(kMergeThreads)
stats_merge_kernel(int S, const long long* __restrict__ part_n,
                   const float* __restrict__ part_mean, const float* __restrict__ part_m2,
                   float* __restrict__ out_mean, float* __restrict__ out_var) {
  const long long client = blockIdx.x;
  long long cnt = 0;
  float mean = 0.f, m2 = 0.f;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const long long idx = client * S + s;
    chan_merge(cnt, mean, m2, part_n[idx], part_mean[idx], part_m2[idx]);
  }
  block_merge(cnt, mean, m2);
  if (threadIdx.x == 0) {
    if (cnt == 0) {
      out_mean[client] = nanf("");
      out_var[client] = nanf("");
    } else {
      out_mean[client] = mean;
      out_var[client] = fmaxf(m2 / (float)cnt, 0.f);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x is (N, n) contiguous; the part_*
// scratch holds N*S entries each. Returns cudaGetLastError() after the
// two launches on `stream`.
extern "C" int param_stats_batched_launch(const void* x, int dtype, long long N, long long n,
                                          int S, void* part_n, void* part_mean, void* part_m2,
                                          void* out_mean, void* out_var, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid1((unsigned)S, (unsigned)N);
  if (dtype == 0) {
    stats_partial_kernel<float><<<grid1, kThreads, 0, st>>>(
        static_cast<const float*>(x), n, S, static_cast<long long*>(part_n),
        static_cast<float*>(part_mean), static_cast<float*>(part_m2));
  } else if (dtype == 1) {
    stats_partial_kernel<__nv_bfloat16><<<grid1, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), n, S, static_cast<long long*>(part_n),
        static_cast<float*>(part_mean), static_cast<float*>(part_m2));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_merge_kernel<<<(unsigned)N, kMergeThreads, 0, st>>>(
      S, static_cast<const long long*>(part_n), static_cast<const float*>(part_mean),
      static_cast<const float*>(part_m2), static_cast<float*>(out_mean),
      static_cast<float*>(out_var));
  return (int)cudaGetLastError();
}
