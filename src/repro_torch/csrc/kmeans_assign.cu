// kmeans_assign: nearest-centroid ids for the coordinator's k-means.
//
// Replaces the Pallas kernel repro/kernels/kmeans_assign.py
// (kmeans_assign, body _assign_kernel): int32 argmin over k of
// d = |x|^2 + |c|^2 - 2 x.c in fp32, unclamped, ties to the first index.
//
// Bound: bytes, and on the BSO-SL round launch latency. X (N, F) and
// C (K, F) are read once and (N,) ids written; the N*K*2F operations
// are few (14 x 3 x 112 on the round), so the floor is the bytes over
// 3.35 TB/s, a few nanoseconds on the round's (14, 56) x (3, 56).
//
// Design. One CTA per block of 128 rows. The CTA stages C and |c|^2 in
// shared memory (K*F*4 + K*4 bytes, 684 B on the round; the wrapper
// refuses more than 48 KB), and each thread takes one row: it computes
// |x|^2, then for every centroid the distance in the plain version's
// formula and keeps the minimum with a strict `<`, so ties go to the
// first index. The TPU wrapper's padding of F to 128 lanes and K to 8
// centroids was the TPU's tiling and is dropped.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 128;

__global__ void __launch_bounds__(kRows)
kmeans_assign_kernel(const float* __restrict__ X, const float* __restrict__ C,
                     int* __restrict__ out, long long N, int F, int K) {
  extern __shared__ float smem[];
  float* s_c = smem;           // (K, F)
  float* s_c2 = smem + K * F;  // (K,)
  for (int i = threadIdx.x; i < K * F; i += blockDim.x) s_c[i] = C[i];
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float c2 = 0.f;
    for (int f = 0; f < F; ++f) c2 += s_c[k * F + f] * s_c[k * F + f];
    s_c2[k] = c2;
  }
  __syncthreads();

  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const float* x = X + row * F;
  float x2 = 0.f;
  for (int f = 0; f < F; ++f) x2 += x[f] * x[f];
  float best = INFINITY;
  int best_k = 0;
  for (int k = 0; k < K; ++k) {
    const float* c = s_c + k * F;
    float dot = 0.f;
    for (int f = 0; f < F; ++f) dot += x[f] * c[f];
    const float d = x2 + s_c2[k] - 2.0f * dot;
    if (d < best) {
      best = d;
      best_k = k;
    }
  }
  out[row] = best_k;
}

}  // namespace

// X (N, F) and C (K, F) fp32 contiguous, out (N,) int32. Returns
// cudaGetLastError() after the launch on `stream`.
extern "C" int kmeans_assign_launch(const void* X, const void* C, void* out, long long N,
                                    int F, int K, void* stream) {
  const unsigned blocks = (unsigned)((N + kRows - 1) / kRows);
  const size_t smem = ((size_t)K * F + K) * sizeof(float);
  kmeans_assign_kernel<<<blocks, kRows, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<const float*>(C), static_cast<int*>(out), N, F,
      K);
  return (int)cudaGetLastError();
}
