// kmeans_assign: nearest-centroid ids for the coordinator's k-means.
//
// Replaces the Pallas kernel repro/kernels/kmeans_assign.py
// (kmeans_assign, body _assign_kernel): int32 argmin over k of
// d = |x|^2 + |c|^2 - 2 x.c in fp32, unclamped, ties to the first index.
// X and C may each be fp32, bf16, fp16, fp8 e4m3 or fp8 e5m2, converted to
// fp32 as they are loaded (the Pallas kernel's astype(float32)); any K >= 1
// and F >= 1.
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
// Design. A CTA of kWarps warps takes a group of kWarps rows at a time, a
// warp a row. At F <= 32 * kRowRegs (56 on the round) its lanes first load
// the warp's row into registers across F, coalesced, so that the row's
// trip to device memory overlaps C's; a wider row streams through the
// lanes. C reaches the lanes through shared memory, as fp32, in tiles of
// kBlockK centroids by kChunkF features (32 KB), and every row of the
// group walks the tiles in order: each lane keeps partials of |x|^2 and of
// the dot products with the tile's centroids, carried across the feature
// chunks of a centroid block; one butterfly a sum gives every lane the
// totals, and the distances, in the plain version's formula, are compared
// for k = 0..K-1 in order with a strict `<`, so ties go to the first
// index. Warp j sums |c|^2 of the block's centroid j as the tiles pass
// (lanes across features, then a butterfly of __shfl_xor_sync). Where C
// is one tile (K <= kBlockK and F <= kChunkF: every coordinator shape of
// the paths) it is staged and summed once a CTA, before its first group;
// a larger C is staged again for each group (from L2: C is small beside X
// wherever this matters). The TPU wrapper's padding of F to 128 lanes and K to 8
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
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kBlockK = 8;      // centroids whose dot products a lane holds at once
constexpr int kRowRegs = 4;     // row values a lane holds: rows of F <= 128 in registers
constexpr int kMaxCtas = 1024;  // rows beyond kMaxCtas * kWarps loop in the CTAs
constexpr int kChunkF = 1024;   // features a tile: 32 KB of fp32 at kBlockK centroids
static_assert(kChunkF % 32 == 0 && kChunkF >= 32 * kRowRegs,
              "a chunk keeps each lane's features and holds a register row whole");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f(__nv_fp8_e5m2 x) { return static_cast<float>(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Row `row` of X into xr across the lanes (f = lane + 32 i), 0 past F or N.
template <typename TX>
__device__ __forceinline__ void load_row(float (&xr)[kRowRegs], const TX* __restrict__ X,
                                         long long row, long long N, int F, int lane) {
#pragma unroll
  for (int i = 0; i < kRowRegs; ++i) {
    const int f = lane + 32 * i;
    xr[i] = row < N && f < F ? to_f(X[row * F + f]) : 0.f;
  }
}

// C's centroids [k0, k0 + kn), features [f0, f0 + fn) into s_c as fp32,
// centroid j at s_c + j * ld.
template <typename TC>
__device__ __forceinline__ void stage_c(float* s_c, const TC* __restrict__ C, int F, int k0,
                                        int kn, int f0, int fn, int ld) {
  for (int i = threadIdx.x; i < kn * fn; i += blockDim.x) {
    const int j = i / fn, f = i - j * fn;
    s_c[j * ld + f] = to_f(C[(long long)(k0 + j) * F + f0 + f]);
  }
}

// The live centroids of K: the first k_active (clamped to [0, K]), or all
// K where k_active is null. Only they are staged, summed and compared (the
// launcher sized the shared memory for a tile of all K).
__device__ __forceinline__ int live_k(const int* __restrict__ k_active, int K) {
  return k_active != nullptr ? min(max(__ldg(k_active), 0), K) : K;
}

// Tile (k0, f0) of C into s_c, and warp j's part of |c|^2 of the tile's
// centroid j added to c2 (lanes across features, as in the sum of x).
template <typename TC>
__device__ __forceinline__ void stage_tile(float* s_c, float& c2, const TC* __restrict__ C,
                                           int F, int k0, int kn, int f0, int fn, int ld,
                                           int warp, int lane) {
  __syncthreads();  // every warp is done with the tile before
  stage_c(s_c, C, F, k0, kn, f0, fn, ld);
  __syncthreads();
  if (warp < kn)
    for (int f = lane; f < fn; f += 32) c2 = fmaf(s_c[warp * ld + f], s_c[warp * ld + f], c2);
}

// The tile's |c|^2 summed over the lanes into s_c2, for every warp.
__device__ __forceinline__ void finish_c2(float* s_c2, float c2, int kn, int warp, int lane) {
  if (warp < kn) {
    c2 = warp_sum(c2);
    if (lane == 0) s_c2[warp] = c2;
  }
  __syncthreads();
}

// The kernel. The group loop is the same on every warp (a warp past N
// computes nothing but keeps to the barriers). `once` (C is one tile,
// staged before the first group) is the same on every thread of the CTA.
template <typename TX, typename TC, bool kInRegs>
__global__ void __launch_bounds__(kWarps * 32, 1)
kmeans_assign_kernel(const TX* __restrict__ X, const TC* __restrict__ C,
                     const int* __restrict__ k_active, int* __restrict__ out, long long N, int F,
                     int K, int ld) {
  extern __shared__ float s_c[];  // (min(K, kBlockK), ld), ld = min(F, kChunkF)
  __shared__ float s_c2[kBlockK];
  static_assert(kBlockK == kWarps, "a warp sums one centroid's |c|^2");
  K = live_k(k_active, K);
  const bool once = K <= kBlockK && F <= kChunkF;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long stride = (long long)gridDim.x * kWarps;
  long long row = (long long)blockIdx.x * kWarps + warp;
  float xr[kInRegs ? kRowRegs : 1];
  if constexpr (kInRegs) load_row(xr, X, row, N, F, lane);  // in flight while C is staged
  if (once && K > 0) {
    float c2 = 0.f;
    stage_tile(s_c, c2, C, F, 0, K, 0, F, ld, warp, lane);
    finish_c2(s_c2, c2, K, warp, lane);
  }
  for (; row - warp < N; row += stride) {
    const bool live = row < N;  // the same on every lane of the warp
    float x2 = 0.f, best = INFINITY;
    int best_k = 0;
    for (int k0 = 0; k0 < K; k0 += kBlockK) {
      const int kn = min(kBlockK, K - k0);
      float dot[kBlockK];
#pragma unroll
      for (int j = 0; j < kBlockK; ++j) dot[j] = 0.f;
      float p2 = 0.f, c2 = 0.f;  // c2: centroid k0 + warp, this lane's features
      for (int f0 = 0; f0 < F; f0 += kChunkF) {
        const int fn = min(kChunkF, F - f0);
        if (!once) stage_tile(s_c, c2, C, F, k0, kn, f0, fn, ld, warp, lane);
        if (!live) continue;
        if constexpr (kInRegs) {  // F <= kChunkF: one chunk
#pragma unroll
          for (int i = 0; i < kRowRegs; ++i) {
            const int f = lane + 32 * i;
            if (f < F) {
              p2 = fmaf(xr[i], xr[i], p2);
#pragma unroll
              for (int j = 0; j < kBlockK; ++j)
                if (j < kn) dot[j] = fmaf(xr[i], s_c[j * ld + f], dot[j]);
            }
          }
        } else {
          for (int f = lane; f < fn; f += 32) {
            const float xv = to_f(X[row * F + f0 + f]);
            p2 = fmaf(xv, xv, p2);
#pragma unroll
            for (int j = 0; j < kBlockK; ++j)
              if (j < kn) dot[j] = fmaf(xv, s_c[j * ld + f], dot[j]);
          }
        }
      }
      if (!once) finish_c2(s_c2, c2, kn, warp, lane);
      if (!live) continue;
      if (k0 == 0) x2 = warp_sum(p2);
      // j < kn is the same on every lane, so each butterfly runs whole
#pragma unroll
      for (int j = 0; j < kBlockK; ++j) {
        if (j < kn) {
          const float d = x2 + s_c2[j] - 2.0f * warp_sum(dot[j]);
          if (d < best) {
            best = d;
            best_k = k0 + j;
          }
        }
      }
    }
    if (live && lane == 0) out[row] = best_k;
    if constexpr (kInRegs) load_row(xr, X, row + stride, N, F, lane);
  }
}

template <typename TX, typename TC>
int launch(const void* X, const void* C, const int* ka, int* o, long long N, int F, int K,
           cudaStream_t st) {
  const long long want = (N + kWarps - 1) / kWarps;
  const unsigned blocks = (unsigned)(want < kMaxCtas ? want : kMaxCtas);
  const int ld = F < kChunkF ? F : kChunkF;
  const size_t smem = (size_t)(K < kBlockK ? K : kBlockK) * ld * sizeof(float);
  const TX* x = static_cast<const TX*>(X);
  const TC* c = static_cast<const TC*>(C);
  if (F <= 32 * kRowRegs)
    kmeans_assign_kernel<TX, TC, true><<<blocks, kWarps * 32, smem, st>>>(x, c, ka, o, N, F, K,
                                                                          ld);
  else
    kmeans_assign_kernel<TX, TC, false><<<blocks, kWarps * 32, smem, st>>>(x, c, ka, o, N, F, K,
                                                                           ld);
  return (int)cudaGetLastError();
}

template <typename TX>
int launch_c(int c_dtype, const void* X, const void* C, const int* ka, int* o, long long N,
             int F, int K, cudaStream_t st) {
  switch (c_dtype) {
    case 0: return launch<TX, float>(X, C, ka, o, N, F, K, st);
    case 1: return launch<TX, __nv_bfloat16>(X, C, ka, o, N, F, K, st);
    case 2: return launch<TX, __half>(X, C, ka, o, N, F, K, st);
    case 3: return launch<TX, __nv_fp8_e4m3>(X, C, ka, o, N, F, K, st);
    case 4: return launch<TX, __nv_fp8_e5m2>(X, C, ka, o, N, F, K, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// X (N, F) and C (K, F) contiguous, each of a storage type by its code
// (0 fp32, 1 bf16, 2 fp16, 3 fp8 e4m3, 4 fp8 e5m2), out (N,) int32,
// k_active one int32 on the device or null (all K centroids live); K, F
// >= 1. Returns cudaGetLastError() after the launch on `stream`.
extern "C" int kmeans_assign_launch(const void* X, const void* C, const void* k_active,
                                    void* out, long long N, int F, int K, int x_dtype,
                                    int c_dtype, void* stream) {
  if (K < 1 || F < 1) return (int)cudaErrorInvalidValue;
  const int* ka = static_cast<const int*>(k_active);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0: return launch_c<float>(c_dtype, X, C, ka, o, N, F, K, st);
    case 1: return launch_c<__nv_bfloat16>(c_dtype, X, C, ka, o, N, F, K, st);
    case 2: return launch_c<__half>(c_dtype, X, C, ka, o, N, F, K, st);
    case 3: return launch_c<__nv_fp8_e4m3>(c_dtype, X, C, ka, o, N, F, K, st);
    case 4: return launch_c<__nv_fp8_e5m2>(c_dtype, X, C, ka, o, N, F, K, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
