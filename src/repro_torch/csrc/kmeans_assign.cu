// kmeans_assign: nearest-centroid ids for the coordinator's k-means.
//
// Replaces the Pallas kernel repro/kernels/kmeans_assign.py
// (kmeans_assign, body _assign_kernel): int32 argmin over k of
// d = |x|^2 + |c|^2 - 2 x.c in fp32, unclamped, ties to the first index.
//
// Bound: bytes, and on the BSO-SL round the launch. X (N, F) and C (K, F)
// are read once and (N,) ids written; the N*K*2F operations are few
// (14 x 3 x 112 on the round), so the floor is the bytes over 3.35 TB/s,
// about a nanosecond on the round's (14, 56) x (3, 56). The design before
// this one was bound by serial latency: a thread a row ran (K+1)*F = 224
// dependent load-and-FMA steps through L1 on a row read with a 224-byte
// stride, after K threads had each run an F-step chain for |c|^2. Here no
// chain is longer than ceil(F/32) steps and a 5-step shuffle reduction,
// so what is left is the launch and one trip to device memory.
//
// Design. A CTA of kWarps warps; a warp takes a row at a time. At
// F <= 32 * kRowRegs (56 on the round) its lanes first load the warp's
// row into registers across F, coalesced, so that the row's trip to
// device memory overlaps C's; a wider row streams through the lanes in
// the loop below. The CTA stages C in shared memory (K*F*4 + K*4 bytes,
// 684 B on the round; the wrapper refuses more than 48 KB) and computes
// |c|^2 a warp a centroid: lanes across F, then a butterfly of
// __shfl_xor_sync. Each lane keeps partials of |x|^2 and of the dot
// products with a block of kBlockK centroids; one butterfly a sum gives
// every lane the totals, and the distances, in the plain version's
// formula, are compared for k = 0..K-1 in order with a strict `<`, so
// ties go to the first index. K above kBlockK loops over centroid
// blocks. The TPU wrapper's padding of F to 128 lanes and K to 8
// centroids was the TPU's tiling and is dropped.
//
// k_active. The grid axis runs k-means at a static pad K with only the
// first k_active centroids live (the reference masks the others' distances
// to +inf before its argmin). k_active is a pointer to one int32 on the
// device, so a captured graph replays with whatever the buffer holds and
// the caller never reads it on the host; null means all K. Each CTA reads
// it once and clamps it to [0, K], then stages, sums and compares only the
// live centroids, in the same order with the same strict `<`: a live
// centroid's distance is computed exactly as without the operand, and with
// no live centroid the id is 0, as an argmin over all-inf gives.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kBlockK = 8;     // centroids whose dot products a lane holds at once
constexpr int kRowRegs = 4;    // row values a lane holds: rows of F <= 128 in registers
constexpr int kMaxCtas = 1024;  // rows beyond kMaxCtas * kWarps loop in the CTAs

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Row `row` of X into xr across the lanes (f = lane + 32 i), 0 past F or N.
__device__ __forceinline__ void load_row(float (&xr)[kRowRegs], const float* __restrict__ X,
                                         long long row, long long N, int F, int lane) {
#pragma unroll
  for (int i = 0; i < kRowRegs; ++i) {
    const int f = lane + 32 * i;
    xr[i] = row < N && f < F ? __ldg(X + row * F + f) : 0.f;
  }
}

// kInRegs: F <= 32 * kRowRegs, the row held in registers.
template <bool kInRegs>
__global__ void __launch_bounds__(kWarps * 32)
kmeans_assign_kernel(const float* __restrict__ X, const float* __restrict__ C,
                     const int* __restrict__ k_active, int* __restrict__ out, long long N,
                     int F, int K) {
  extern __shared__ float smem[];
  float* s_c = smem;           // (K, F)
  float* s_c2 = smem + K * F;  // (K,)
  // from here on K counts the live centroids (s_c2 above keeps the pad's layout)
  if (k_active != nullptr) K = min(max(__ldg(k_active), 0), K);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long stride = (long long)gridDim.x * kWarps;
  long long row = (long long)blockIdx.x * kWarps + warp;
  float xr[kRowRegs];
  if (kInRegs) load_row(xr, X, row, N, F, lane);
  for (int i = threadIdx.x; i < K * F; i += blockDim.x) s_c[i] = __ldg(C + i);
  __syncthreads();
  for (int k = warp; k < K; k += kWarps) {
    float p = 0.f;
    for (int f = lane; f < F; f += 32) p = fmaf(s_c[k * F + f], s_c[k * F + f], p);
    p = warp_sum(p);
    if (lane == 0) s_c2[k] = p;
  }
  __syncthreads();

  for (; row < N; row += stride) {
    float x2 = 0.f, best = INFINITY;
    int best_k = 0;
    for (int k0 = 0; k0 < K; k0 += kBlockK) {
      float dot[kBlockK];
#pragma unroll
      for (int j = 0; j < kBlockK; ++j) dot[j] = 0.f;
      float p2 = 0.f;
      if (kInRegs) {
#pragma unroll
        for (int i = 0; i < kRowRegs; ++i) {
          const int f = lane + 32 * i;
          if (f < F) {
            p2 = fmaf(xr[i], xr[i], p2);
#pragma unroll
            for (int j = 0; j < kBlockK; ++j)
              if (k0 + j < K) dot[j] = fmaf(xr[i], s_c[(k0 + j) * F + f], dot[j]);
          }
        }
      } else {
        for (int f = lane; f < F; f += 32) {
          const float xv = __ldg(X + row * F + f);
          p2 = fmaf(xv, xv, p2);
#pragma unroll
          for (int j = 0; j < kBlockK; ++j)
            if (k0 + j < K) dot[j] = fmaf(xv, s_c[(k0 + j) * F + f], dot[j]);
        }
      }
      if (k0 == 0) x2 = warp_sum(p2);
      // k0 + j < K is the same on every lane, so each butterfly runs whole
#pragma unroll
      for (int j = 0; j < kBlockK; ++j) {
        if (k0 + j < K) {
          const float d = x2 + s_c2[k0 + j] - 2.0f * warp_sum(dot[j]);
          if (d < best) {
            best = d;
            best_k = k0 + j;
          }
        }
      }
    }
    if (lane == 0) out[row] = best_k;
    if (kInRegs) load_row(xr, X, row + stride, N, F, lane);
  }
}

}  // namespace

// X (N, F) and C (K, F) fp32 contiguous, out (N,) int32, k_active one
// int32 on the device or null (all K centroids live). Returns
// cudaGetLastError() after the launch on `stream`.
extern "C" int kmeans_assign_launch(const void* X, const void* C, const void* k_active,
                                    void* out, long long N, int F, int K, void* stream) {
  const long long want = (N + kWarps - 1) / kWarps;
  const unsigned blocks = (unsigned)(want < kMaxCtas ? want : kMaxCtas);
  const size_t smem = ((size_t)K * F + K) * sizeof(float);
  const float* x = static_cast<const float*>(X);
  const float* c = static_cast<const float*>(C);
  const int* ka = static_cast<const int*>(k_active);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F <= 32 * kRowRegs)
    kmeans_assign_kernel<true><<<blocks, kWarps * 32, smem, st>>>(x, c, ka, o, N, F, K);
  else
    kmeans_assign_kernel<false><<<blocks, kWarps * 32, smem, st>>>(x, c, ka, o, N, F, K);
  return (int)cudaGetLastError();
}
