// flash_attention: forward causal / sliding-window GQA attention over a
// whole sequence (prefill and training shapes).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel). q (B,H,Sq,D) attends to k, v
// (B,KV,Sk,D); query head h reads kv head h / G (G = H / KV), as in the
// reference's index map, so K/V are never repeated H times. Query row i
// sits at global position q_offset + i; causal keeps cols <= that
// position, window > 0 keeps cols > position - window. The softmax is
// online in fp32, scaled by 1/sqrt(D); the output is acc / max(l, 1e-30)
// in q's type, so a row with no valid key gives 0.
//
// Bound: operations. Every valid (row, col) pair costs 2*D multiply-adds
// per query head (D for the score, D for the output). At granite-3-2b's
// prefill shape (B 4, H 32, KV 8, S 2048, D 64, bf16, causal) that is
// ~68.7 GFLOP against ~84 MB of q, k, v and output, ~800 operations a
// byte, above the card's ~295 for bf16 tensor cores: the floor is the
// FLOPs over the tensor-core peak.
//
// Design (a right and simple first kernel; it runs the products on the
// fp32 FMA units, not the tensor cores, so it sits far above that floor).
// - The Pallas grid (B, H, n_q, n_k) walks the k-blocks in sequence into
//   VMEM scratch. Here one CTA holds one (q tile of 64 rows, head, batch
//   row) and loops over 64-key K/V tiles itself; the running (m, l, acc)
//   stay in registers for the whole loop.
// - 128 threads. Thread (r, c) = (tid / 8, tid % 8) owns query rows
//   4r..4r+3 and, in a tile, score columns c + 8j (j < 8) and output
//   columns c + 8j (j < D/8). The 8 threads of a row group are 8
//   neighbouring lanes of one warp, so a row's max and sum are three
//   xor-shuffles.
// - Q, K (transposed) and V tiles go through shared memory as fp32. Rows
//   are padded by one float so that the lanes of a warp hit distinct
//   banks: 4 row groups x 8 columns read 32 banks, the rest broadcast.
//   The probabilities of a tile go through shared memory for P.V.
// - Tiles wholly outside the causal / window band of the CTA's rows are
//   skipped: they would leave (m, l, acc) unchanged, so this is exact.
// - q, k, v and the output are read and written through strides with D
//   the unit-stride axis, so a (B,S,H,D) activation is used as a
//   (B,H,S,D) view without a transposing copy. Loads are 16 bytes wide
//   when every base and stride allows.
// mma.sync / wgmma on the tensor cores, TMA or cp.async double-buffered
// tiles and warp specialisation are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;     // query rows a CTA
constexpr int BK = 64;     // keys a tile
constexpr int NT = 128;    // threads a CTA
constexpr int RPT = 4;     // query rows a thread
constexpr int CPT = 8;     // score columns a thread
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// reductions over the 8 lanes of a row group (lane bits 0..2)
__device__ __forceinline__ float group_max(float x) {
  for (int o = 1; o < 8; o <<= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
  for (int o = 1; o < 8; o <<= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

struct Strides {
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
};

// Stage rows [row0, row0 + nrows) of one (S, D) head into shared memory
// as fp32: element (i, d) goes to dst[i * rs + d * ds]. Rows at or past
// `limit` are zeros.
template <typename T, int D>
__device__ __forceinline__ void stage(const T* __restrict__ src, long long s_stride, int row0,
                                      int nrows, int limit, float* dst, int rs, int ds,
                                      int vec) {
  if (vec) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int CPR = D / VEC;  // 16-byte chunks a row
    for (int e = threadIdx.x; e < nrows * CPR; e += NT) {
      const int i = e / CPR, d0 = (e % CPR) * VEC;
      float* out = dst + i * rs + d0 * ds;
      if (row0 + i < limit) {
        const uint4 w = *reinterpret_cast<const uint4*>(src + (row0 + i) * s_stride + d0);
        const T* x = reinterpret_cast<const T*>(&w);
#pragma unroll
        for (int u = 0; u < VEC; ++u) out[u * ds] = to_f(x[u]);
      } else {
#pragma unroll
        for (int u = 0; u < VEC; ++u) out[u * ds] = 0.f;
      }
    }
  } else {
    for (int e = threadIdx.x; e < nrows * D; e += NT) {
      const int i = e / D, d = e % D;
      dst[i * rs + d * ds] = (row0 + i < limit) ? to_f(src[(row0 + i) * s_stride + d]) : 0.f;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_attention_fwd(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, int H, int KV, int Sq,
                        int Sk, int causal, int window, int q_offset, float scale, Strides st,
                        int vec) {
  constexpr int DJ = D / CPT;  // output columns a thread
  extern __shared__ float smem[];
  float* Qs = smem;                  // BQ x (D + 1)
  float* Kt = Qs + BQ * (D + 1);     // D x (BK + 1), K transposed
  float* Vs = Kt + D * (BK + 1);     // BK x D
  float* Ps = Vs + BK * D;           // BQ x (BK + 1)

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int r = threadIdx.x / CPT, c = threadIdx.x % CPT;

  const T* qb = q + b * st.q_b + h * st.q_h;
  const T* kb = k + b * st.k_b + kvh * st.k_h;
  const T* vb = v + b * st.v_b + kvh * st.v_h;
  stage<T, D>(qb, st.q_s, q0, BQ, Sq, Qs, D + 1, 1, vec);

  // the band of columns any row of this tile may see
  const int pos_lo = q_offset + q0;
  const int pos_hi = q_offset + min(q0 + BQ, Sq) - 1;
  const int col_hi = causal ? min(Sk - 1, pos_hi) : Sk - 1;
  const int col_lo = window > 0 ? max(0, pos_lo - window + 1) : 0;

  float m[RPT], l[RPT], acc[RPT][DJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int t0 = col_lo / BK * BK; t0 <= col_hi; t0 += BK) {
    __syncthreads();  // Qs written; the previous tile's Kt, Vs, Ps consumed
    stage<T, D>(kb, st.k_s, t0, BK, Sk, Kt, 1, BK + 1, vec);
    stage<T, D>(vb, st.v_s, t0, BK, Sk, Vs, D, 1, vec);
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(r * RPT + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Kt[d * (BK + 1) + c + CPT * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int pos = pos_lo + r * RPT + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = t0 + c + CPT * j;
        const bool ok = col < Sk && (!causal || col <= pos) && (window <= 0 || col > pos - window);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      // no valid column yet: keep exp() away from (-inf) - (-inf)
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_use);  // 0 for a masked column
        psum += p;
        Ps[(r * RPT + i) * (BK + 1) + c + CPT * j] = p;
      }
      l[i] = l[i] * alpha + group_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RPT], vv[DJ];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(r * RPT + i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * D + c + CPT * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* ob = o + b * st.o_b + h * st.o_h;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + r * RPT + i;
    if (row < Sq) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < DJ; ++j) ob[row * st.o_s + c + CPT * j] = from_f<T>(acc[i][j] * inv);
    }
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(BQ * (D + 1) + D * (BK + 1) + BK * D + BQ * (BK + 1)) * sizeof(float);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV, int Sq,
           int Sk, int causal, int window, int q_offset, const Strides& st, int vec,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // the opt-in above 48 KB of shared memory; it is per device, so it is
  // set at every launch (a host-side call of about a microsecond)
  cudaError_t err = cudaFuncSetAttribute(flash_attention_fwd<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_fwd<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, KV, Sq, Sk, causal, window, q_offset, 1.0f / sqrtf((float)D), st,
      vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
             int Sq, int Sk, int causal, int window, int q_offset, const Strides& st, int vec,
             cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, q_offset, st, vec,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, q_offset, st, vec,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, q_offset, st, vec,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,Sq,D), k and v (B,KV,Sk,D), o (B,H,Sq,D), each given by element
// strides of its first three axes (D unit-stride). dtype 0 = fp32,
// 1 = bf16, the same for all four. The wrapper checks the shapes:
// H % KV == 0, D in {32, 64, 128}, Sq and Sk >= 1, window >= 0, and
// vec = 1 only when every base and stride is a multiple of 16 bytes.
// Returns cudaGetLastError() after the launch on `stream`.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int dtype, int B, int H, int KV, int Sq, int Sk, int D,
                                      int causal, int window, int q_offset, long long q_sb,
                                      long long q_sh, long long q_ss, long long k_sb,
                                      long long k_sh, long long k_ss, long long v_sb,
                                      long long v_sh, long long v_ss, long long o_sb,
                                      long long o_sh, long long o_ss, int vec, void* stream) {
  const Strides st{q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_d<float>(D, q, k, v, o, B, H, KV, Sq, Sk, causal, window, q_offset, st, vec,
                             s);
    case 1:
      return launch_d<__nv_bfloat16>(D, q, k, v, o, B, H, KV, Sq, Sk, causal, window, q_offset,
                                     st, vec, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
