// flash_decode: one-query GQA attention against a KV cache, the serve
// path's decode hot spot.
//
// Replaces the Pallas kernel repro/kernels/flash_decode.py (flash_decode,
// body _decode_kernel). q (B,H,1,D) attends to k, v (B,KV,S,D); query head
// h reads kv head h / G (G = H / KV). Keys 0..pos[b] are valid in row b,
// and window > 0 keeps only cols > pos - window. The softmax is online in
// fp32, scaled by 1/sqrt(D); the output is acc / max(l, 1e-30) in q's type.
//
// Bound: bytes. Each valid K/V column is D elements read once per kv head;
// the work on it is 2*G*D multiply-adds for the scores and as many for the
// output, a few operations a byte, far below the card's ~295 operations a
// byte for bf16. The floor is the valid columns' bytes (plus q and the
// output) over 3.35 TB/s.
//
// Design.
// - Split pass: one CTA per (split of S, kv head, batch row), with G warps,
//   one per query row of that kv head. K/V tiles go through shared memory
//   once and serve all G rows, where the Pallas grid (B, H, n_k) reads each
//   tile G times. A tile is 4096/D keys converted to fp32; the K tile's
//   rows are padded to D+1 floats so that the 32 lanes, each on its own
//   key, read distinct banks.
// - S is split because B*KV CTAs are too few: 4*8 on the serve path fill a
//   quarter of the 132 SMs. The wrapper picks the split count from the
//   cache length (pos stays on the device; nothing is read back). A split
//   walks only the columns of its range inside [pos-window+1, pos]:
//   columns outside contribute exact zeros in the reference, so skipping
//   them is the same function. It writes its partial (m, l, acc[D]).
// - Merge pass: one CTA per (b, h) combines the partials with a
//   log-sum-exp. A split with no valid column has l = 0 and gets no weight
//   (it is skipped, not multiplied by zero, so no NaN can leak in).
// - The cache is read in its stored layout through strides: the serve
//   path's cache is (B,S,KV,D), seen here as a (B,KV,S,D) strided view, so
//   no copy of it is made. D must be the unit-stride axis. Loads are 16
//   bytes wide when every base and stride is a multiple of 16 bytes.
// wgmma, TMA, cp.async pipelining and fp8 caches are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileElems = 4096;  // keys x D in one tile
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f<__half>(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

struct Strides {
  long long q_b, q_h, k_b, k_h, k_s, v_b, v_h, v_s;
};

template <typename T, int D>
__global__ void flash_decode_split(const T* __restrict__ q, const T* __restrict__ k,
                                   const T* __restrict__ v, const int* __restrict__ pos,
                                   float* __restrict__ part_m, float* __restrict__ part_l,
                                   float* __restrict__ part_acc, int H, int S, int window,
                                   int chunk, int n_split, float scale, Strides st, int vec) {
  constexpr int TILE = kTileElems / D;
  constexpr int KPL = (TILE + 31) / 32;  // keys per lane
  constexpr int DPL = D / 32;            // output dims per lane
  __shared__ float k_s[TILE * (D + 1)];
  __shared__ float v_s[TILE * D];
  extern __shared__ float q_s[];  // (G, D)

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p = pos[b];
  const int lo = window > 0 ? max(p - window + 1, 0) : 0;
  const int c0 = max(split * chunk, lo);
  const int c1 = min(min(split * chunk + chunk, S), p + 1);  // exclusive

  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    q_s[i] = to_f(q[b * st.q_b + (long long)(kvh * G + g) * st.q_h + d]);
  }
  const T* kb = k + b * st.k_b + kvh * st.k_h;
  const T* vb = v + b * st.v_b + kvh * st.v_h;
  const float* qr = q_s + warp * D;

  float m = -INFINITY, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int t0 = c0; t0 < c1; t0 += TILE) {
    const int n = min(TILE, c1 - t0);
    __syncthreads();  // q_s written; the previous tile is consumed
    if (vec) {
      constexpr int VEC = 16 / sizeof(T);
      constexpr int CPR = D / VEC;  // 16-byte chunks a row
      for (int c = threadIdx.x; c < n * CPR; c += blockDim.x) {
        const int r = c / CPR, col = (c % CPR) * VEC;
        const uint4 kw = *reinterpret_cast<const uint4*>(kb + (t0 + r) * st.k_s + col);
        const uint4 vw = *reinterpret_cast<const uint4*>(vb + (t0 + r) * st.v_s + col);
        const T* ke = reinterpret_cast<const T*>(&kw);
        const T* ve = reinterpret_cast<const T*>(&vw);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          k_s[r * (D + 1) + col + i] = to_f(ke[i]);
          v_s[r * D + col + i] = to_f(ve[i]);
        }
      }
    } else {
      for (int e = threadIdx.x; e < n * D; e += blockDim.x) {
        const int r = e / D, d = e % D;
        k_s[r * (D + 1) + d] = to_f(kb[(t0 + r) * st.k_s + d]);
        v_s[r * D + d] = to_f(vb[(t0 + r) * st.v_s + d]);
      }
    }
    __syncthreads();

    float s[KPL];
    float tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int j = lane + 32 * i;
      s[i] = -INFINITY;
      if (j < n) {
        const float* kr = k_s + j * (D + 1);
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s[i] = dot * scale;
        tmax = fmaxf(tmax, s[i]);
      }
    }
    const float m_new = fmaxf(m, warp_max(tmax));  // finite: n >= 1
    const float alpha = expf(m - m_new);           // 0 on the first tile
    float pj[KPL];
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      pj[i] = (lane + 32 * i < n) ? expf(s[i] - m_new) : 0.f;
      psum += pj[i];
    }
    l = l * alpha + warp_sum(psum);
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      for (int src = 0; src < 32; ++src) {
        const int j = 32 * i + src;
        if (j >= n) break;  // uniform across the warp
        const float w = __shfl_sync(kFull, pj[i], src);
        const float* vr = v_s + j * D;
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) acc[dd] = fmaf(w, vr[lane + 32 * dd], acc[dd]);
      }
    }
    m = m_new;
  }

  const long long row = ((long long)b * H + kvh * G + warp) * n_split + split;
  if (lane == 0) {
    part_m[row] = m;
    part_l[row] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) part_acc[row * D + lane + 32 * i] = acc[i];
}

template <typename T>
__global__ void flash_decode_merge(const float* __restrict__ part_m,
                                   const float* __restrict__ part_l,
                                   const float* __restrict__ part_acc, T* __restrict__ out,
                                   int n_split, int D) {
  const long long row = blockIdx.x;  // b * H + h
  const int d = threadIdx.x;
  const float* m = part_m + row * n_split;
  const float* l = part_l + row * n_split;
  float M = -INFINITY;
  for (int s = 0; s < n_split; ++s)
    if (l[s] > 0.f) M = fmaxf(M, m[s]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < n_split; ++s) {
    if (l[s] > 0.f) {
      const float w = expf(m[s] - M);
      L = fmaf(l[s], w, L);
      A = fmaf(part_acc[(row * n_split + s) * D + d], w, A);
    }
  }
  out[row * D + d] = from_f<T>(A / fmaxf(L, 1e-30f));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* pos, void* out,
           float* part, int B, int H, int KV, int S, int window, int chunk, int n_split,
           const Strides& st, int vec, cudaStream_t stream) {
  const int G = H / KV;
  const long long rows = (long long)B * H * n_split;
  float* part_m = part;
  float* part_l = part + rows;
  float* part_acc = part + 2 * rows;
  const dim3 grid(n_split, KV, B);
  const size_t smem = (size_t)G * D * sizeof(float);
  flash_decode_split<T, D><<<grid, G * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos,
      part_m, part_l, part_acc, H, S, window, chunk, n_split, 1.0f / sqrtf((float)D), st, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_decode_merge<T><<<B * H, D, 0, stream>>>(part_m, part_l, part_acc, static_cast<T*>(out),
                                                 n_split, D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, const int* pos, void* out,
             float* part, int B, int H, int KV, int S, int window, int chunk, int n_split,
             const Strides& st, int vec, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, pos, out, part, B, H, KV, S, window, chunk, n_split, st, vec,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, pos, out, part, B, H, KV, S, window, chunk, n_split, st, vec,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, pos, out, part, B, H, KV, S, window, chunk, n_split, st,
                            vec, stream);
    case 256:
      return launch<T, 256>(q, k, v, pos, out, part, B, H, KV, S, window, chunk, n_split, st,
                            vec, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,1,D), k and v (B,KV,S,D) given by element strides (D unit-stride),
// pos (B,) int32, out (B,H,1,D) contiguous, part B*H*n_split*(D+2) fp32
// scratch. dtype 0 = fp32, 1 = bf16, 2 = fp16, the same for q, k, v, out.
// The wrapper checks the shapes: H % KV == 0, G = H/KV <= 32 warps,
// G*D <= 2048 (q in shared memory), D in {32, 64, 128, 256}, and
// chunk a multiple of the tile (4096/D keys). Returns cudaGetLastError()
// after the two launches on `stream`.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v, const void* pos,
                                   void* out, void* part, int dtype, int B, int H, int KV, int S,
                                   int D, int window, int chunk, int n_split, long long q_sb,
                                   long long q_sh, long long k_sb, long long k_sh,
                                   long long k_ss, long long v_sb, long long v_sh,
                                   long long v_ss, int vec, void* stream) {
  const Strides st{q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  const int* p = static_cast<const int*>(pos);
  float* pt = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_d<float>(D, q, k, v, p, out, pt, B, H, KV, S, window, chunk, n_split, st, vec,
                             s);
    case 1:
      return launch_d<__nv_bfloat16>(D, q, k, v, p, out, pt, B, H, KV, S, window, chunk, n_split,
                                     st, vec, s);
    case 2:
      return launch_d<__half>(D, q, k, v, p, out, pt, B, H, KV, S, window, chunk, n_split, st,
                              vec, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
