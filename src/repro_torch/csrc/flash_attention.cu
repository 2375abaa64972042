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
// FLOPs over the tensor-core peak. So the bf16 kernel has to run both
// products on the tensor cores and keep them fed.
//
// Two kernels, chosen by the wrapper from the types and D (kernel_for);
// one call is one launch of one of them. Any D from 1 to 256 runs the
// layout of the next DP in (32, 64, 128, 256), its pad dims zero in
// shared memory; the output's pad dims are never written.
//
// flash_attention_mma (q, k, v all bf16 or all fp16, D <= 128), in the
// shape of FlashAttention-2:
// - One CTA holds a q tile of one (head, batch row): 4 warps of 32 rows
//   each at DP <= 64 (128 rows), of 16 rows at DP 128 (64 rows; 32 would
//   not fit the registers). A warp's two m16 row tiles share every K/V
//   fragment it reads from shared memory, which halves the ldmatrix
//   traffic a product. The CTA loops over 64-key K/V tiles; the running
//   (m, l, acc) stay in registers for the whole loop.
// - Both products run on the tensor cores as mma.sync m16n8k16 (bf16 or
//   fp16 in, fp32 accumulators). Q is staged once and kept in registers as
//   A fragments (ldmatrix). K fragments come from ldmatrix, V fragments
//   from ldmatrix.trans. S = Q.K^T stays in registers, and its m16n8
//   accumulator fragments, rounded to pairs of the input type, are the A
//   fragments of P.V: P never goes through shared memory.
// - K/V tiles stay in the input type in shared memory, rows padded by 8
//   elements (16 bytes) so that the 8 rows an ldmatrix phase reads fall in
//   distinct banks. Tiles are double-buffered with cp.async (16-byte
//   copies, commit_group / wait_group): tile t+1 is in flight while tile
//   t is multiplied. Where a base or a stride is not a multiple of 16
//   bytes, or D is not a multiple of 8, the same kernel stages with
//   ordinary loads.
// - The online softmax runs on the accumulator fragments: a thread holds
//   two rows, whose max and sum take two xor-shuffles over the lane quad
//   (the sum only once, at the end). exp2 on the SFU (ex2.approx) with
//   scale*log2(e) folded in.
// - The causal / window / ragged-Sk mask is applied only to tiles that
//   cross the band's edge or Sk; tiles wholly inside run unmasked, and
//   tiles wholly outside are never visited.
// - blockIdx.z walks the q tiles heaviest first (q tile n_q - 1 - z): the
//   long causal rows start in the first wave and the short ones fill the
//   tail.
//
// flash_attention_fwd (every other case: fp32, mixed types, an fp8 k or
// v, D above 128): the products on the fp32 FMA units from shared memory
// (TF32 tensor cores cannot meet fp32's 2e-5). 128 threads; thread (r, c)
// = (tid / 8, tid % 8) owns query rows 4r..4r+3 and, in a tile, score and
// output columns c + 8j. Q, K (transposed) and V tiles go through shared
// memory as fp32 with padded rows, each input converted from its own type
// as it is staged (a runtime switch a tile); the probabilities of a tile
// go through shared memory for P.V. At DP 256 its 214.5 KB of dynamic
// shared memory take one CTA an SM.
//
// Both read q, k, v and write the output through strides with D the
// unit-stride axis, so a (B,S,H,D) activation is used as a (B,H,S,D)
// view without a transposing copy. wgmma with TMA and a warp-specialised
// producer (FlashAttention-3's shape) are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;     // query rows a CTA (fma; mma: MmaTile<DP>::BQ)
constexpr int BK = 64;     // keys a tile
constexpr int NT = 128;    // threads a CTA
constexpr int RPT = 4;     // query rows a thread
constexpr int CPT = 8;     // score columns a thread
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f(__nv_fp8_e5m2 x) { return static_cast<float>(x); }

// the output in q's type by its code: 0 fp32, 1 bf16, 2 fp16
__device__ __forceinline__ void store_out(void* o, int dtype, long long i, float x) {
  switch (dtype) {
    case 0: static_cast<float*>(o)[i] = x; break;
    case 1: static_cast<__nv_bfloat16*>(o)[i] = __float2bfloat16_rn(x); break;
    default: static_cast<__half*>(o)[i] = __float2half_rn(x); break;
  }
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

// Visit the cells (r, e) of an n x w grid, cell r * w + e, from cell
// threadIdx.x in steps of NT, with no division a step: w is known only at
// run time.
template <typename F>
__device__ __forceinline__ void for_cells(int n, int w, F&& f) {
  const int dr = NT / w, de = NT % w;
  for (int r = threadIdx.x / w, e = threadIdx.x % w; r < n;) {
    f(r, e);
    r += dr;
    e += de;
    if (e >= w) {
      e -= w;
      ++r;
    }
  }
}

// Stage rows [row0, row0 + nrows) of one (S, D) head into shared memory
// as fp32: element (i, d) goes to dst[i * rs + d * ds] for d < DP, the
// stored D dims converted and the pad dims [D, DP) zero. Rows at or past
// `limit` are zeros. vec: the D dims are whole 16-byte chunks. DC is D
// where it is known when compiling (D == DP), so the index arithmetic is
// shifts; 0 takes the runtime D, stepped without divisions.
template <typename T, int DP, int DC>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, long long s_stride,
                                           int row0, int nrows, int limit, float* dst, int rs,
                                           int ds, int D, int vec) {
  constexpr int VEC = 16 / sizeof(T);
  auto chunk = [&](int i, int d0) {
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
  };
  auto elem = [&](int i, int d) {
    dst[i * rs + d * ds] = (row0 + i < limit && d < D) ? to_f(src[(row0 + i) * s_stride + d]) : 0.f;
  };
  if constexpr (DC != 0) {
    if (vec) {
      constexpr int CPR = DC / VEC;  // 16-byte chunks a row
      for (int e = threadIdx.x; e < nrows * CPR; e += NT) chunk(e / CPR, (e % CPR) * VEC);
    } else {
      for (int e = threadIdx.x; e < nrows * DP; e += NT) elem(e / DP, e % DP);
    }
  } else if (vec) {
    for_cells(nrows, D / VEC, [&](int i, int c) { chunk(i, c * VEC); });
    for_cells(nrows, DP - D, [&](int i, int d) { dst[i * rs + (D + d) * ds] = 0.f; });
  } else {
    for_cells(nrows, DP, elem);
  }
}

template <typename T, int DP>
__device__ __forceinline__ void stage(const T* __restrict__ src, long long s_stride, int row0,
                                      int nrows, int limit, float* dst, int rs, int ds, int D,
                                      int vec) {
  if (D == DP)
    stage_rows<T, DP, DP>(src, s_stride, row0, nrows, limit, dst, rs, ds, D, vec);
  else
    stage_rows<T, DP, 0>(src, s_stride, row0, nrows, limit, dst, rs, ds, D, vec);
}

// stage() of an input given by its storage type's code (0 fp32, 1 bf16,
// 2 fp16, 3 fp8 e4m3, 4 fp8 e5m2), from element `off` of `src`
template <int DP>
__device__ __forceinline__ void stage_any(const void* src, int dtype, long long off,
                                          long long s_stride, int row0, int nrows, int limit,
                                          float* dst, int rs, int ds, int D, int vec) {
  switch (dtype) {
    case 0:
      stage<float, DP>(static_cast<const float*>(src) + off, s_stride, row0, nrows, limit, dst,
                       rs, ds, D, vec);
      break;
    case 1:
      stage<__nv_bfloat16, DP>(static_cast<const __nv_bfloat16*>(src) + off, s_stride, row0,
                               nrows, limit, dst, rs, ds, D, vec);
      break;
    case 2:
      stage<__half, DP>(static_cast<const __half*>(src) + off, s_stride, row0, nrows, limit, dst,
                        rs, ds, D, vec);
      break;
    case 3:
      stage<__nv_fp8_e4m3, DP>(static_cast<const __nv_fp8_e4m3*>(src) + off, s_stride, row0,
                               nrows, limit, dst, rs, ds, D, vec);
      break;
    default:
      stage<__nv_fp8_e5m2, DP>(static_cast<const __nv_fp8_e5m2*>(src) + off, s_stride, row0,
                               nrows, limit, dst, rs, ds, D, vec);
      break;
  }
}

struct Types {
  int q, k, v;  // storage type codes; the output is q's
};

template <int DP>
__global__ void __launch_bounds__(NT)
    flash_attention_fwd(const void* __restrict__ q, const void* __restrict__ k,
                        const void* __restrict__ v, void* __restrict__ o, Types ty, int H, int KV,
                        int Sq, int Sk, int D, int causal, int window, int q_offset, float scale,
                        Strides st, int vec) {
  constexpr int DJ = DP / CPT;  // output columns a thread
  extern __shared__ float smem[];
  float* Qs = smem;                  // BQ x (DP + 1)
  float* Kt = Qs + BQ * (DP + 1);    // DP x (BK + 1), K transposed
  float* Vs = Kt + DP * (BK + 1);    // BK x DP
  float* Ps = Vs + BK * DP;          // BQ x (BK + 1)

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int r = threadIdx.x / CPT, c = threadIdx.x % CPT;

  const long long qb = b * st.q_b + h * st.q_h;
  const long long kb = b * st.k_b + kvh * st.k_h;
  const long long vb = b * st.v_b + kvh * st.v_h;
  stage_any<DP>(q, ty.q, qb, st.q_s, q0, BQ, Sq, Qs, DP + 1, 1, D, vec);

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
    stage_any<DP>(k, ty.k, kb, st.k_s, t0, BK, Sk, Kt, 1, BK + 1, D, vec);
    stage_any<DP>(v, ty.v, vb, st.v_s, t0, BK, Sk, Vs, DP, 1, D, vec);
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(r * RPT + i) * (DP + 1) + d];
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
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * DP + c + CPT * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  const long long ob = b * st.o_b + h * st.o_h;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + r * RPT + i;
    if (row < Sq) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        if (c + CPT * j < D) store_out(o, ty.q, ob + row * st.o_s + c + CPT * j, acc[i][j] * inv);
    }
  }
}

template <int DP>
constexpr size_t fma_smem_bytes() {
  return (size_t)(BQ * (DP + 1) + DP * (BK + 1) + BK * DP + BQ * (BK + 1)) * sizeof(float);
}

// ------------------------------------------------- bf16 and fp16: mma.sync

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), T (bf16 or fp16) in, fp32 accumulators
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4],
                                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU (MUFU.EX2, ~2 ulp; -inf gives 0): the probabilities are
// rounded to bf16 or fp16 for P.V, far coarser than its error
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> one pair of T, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack2(float lo, float hi, __nv_bfloat16) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi, __half) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store_t(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store_t(__half* p, float x) { *p = __float2half_rn(x); }

// m16 row tiles a warp holds: two (32 rows) where the registers allow,
// so that every K/V fragment read from shared memory feeds two products
template <int DP>
struct MmaTile {
  static constexpr int MT = DP <= 64 ? 2 : 1;
  static constexpr int BQ = 4 * 16 * MT;             // query rows a CTA (4 warps)
  static constexpr int LD = DP + 8;                  // elements a shared row: 16 bytes of pad
  static constexpr int KV_ELEMS = BK * LD;           // one K or V tile
  static constexpr size_t BYTES = (size_t)(BQ * LD + 4 * KV_ELEMS) * 2;  // Q, K x 2, V x 2
};

// Rows [row0, row0 + ROWS) of one (S, D) head into dst (rows of LD
// elements), the D stored dims (the pad dims [D, DP) stay as they are).
// Rows at or past `limit` are zeros. vec: 16-byte cp.async (the caller
// commits the group; D is a multiple of 8); else ordinary loads and
// stores. kExact (D == DP) takes the loops with compile-time widths;
// another D steps without divisions.
template <typename T, int DP, int ROWS, bool kExact>
__device__ __forceinline__ void stage16(const T* __restrict__ src, long long s_stride, int row0,
                                        int limit, T* dst, int D, int vec) {
  constexpr int LD = MmaTile<DP>::LD;
  auto chunk = [&](int i, int c) {
    const bool ok = row0 + i < limit;
    const T* g = ok ? src + (long long)(row0 + i) * s_stride + c : src;
    cp_async16(smem_u32(dst + i * LD + c), g, ok ? 16 : 0);
  };
  auto elem = [&](int i, int d) {
    dst[i * LD + d] = row0 + i < limit ? src[(long long)(row0 + i) * s_stride + d] : T(0.f);
  };
  if constexpr (kExact) {
    if (vec) {
      constexpr int CPR = DP / 8;  // 16-byte chunks a row
      for (int e = threadIdx.x; e < ROWS * CPR; e += NT) chunk(e / CPR, (e % CPR) * 8);
    } else {
      for (int e = threadIdx.x; e < ROWS * DP; e += NT) elem(e / DP, e % DP);
    }
  } else if (vec) {
    for_cells(ROWS, D / 8, [&](int i, int c) { chunk(i, c * 8); });
  } else {
    for_cells(ROWS, D, elem);
  }
}

// Zero the pad dims [D, DP) of `rows` rows of LD elements; no copy writes them.
template <typename T, int DP>
__device__ __forceinline__ void zero_pad16(T* dst, int rows, int D) {
  constexpr int LD = MmaTile<DP>::LD;
  uint16_t* p = reinterpret_cast<uint16_t*>(dst);
  for_cells(rows, DP - D, [&](int i, int d) { p[i * LD + D + d] = 0; });
}

// kExact: D == DP, the row width known when compiling
template <typename T, int DP, bool kExact>
__global__ void __launch_bounds__(NT)
    flash_attention_mma(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, int H, int KV, int Sq, int Sk,
                        int D, int causal, int window, int q_offset, float scale_log2,
                        Strides st, int vec) {
  constexpr int MT = MmaTile<DP>::MT;
  constexpr int BQM = MmaTile<DP>::BQ;
  constexpr int LD = MmaTile<DP>::LD;
  constexpr int TILE = MmaTile<DP>::KV_ELEMS;
  constexpr int KS = DP / 16;  // k-steps of Q.K^T
  constexpr int NB = BK / 8;   // n-blocks of S (8 keys each)
  constexpr int ND = DP / 8;   // n-blocks of O (8 columns each)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BQM * LD;      // 2 stages
  T* Vs = Ks + 2 * TILE;      // 2 stages

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQM;  // heaviest q tile first
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // accumulator row and column pair of this lane

  const T* qb = q + b * st.q_b + h * st.q_h;
  const T* kb = k + b * st.k_b + kvh * st.k_h;
  const T* vb = v + b * st.v_b + kvh * st.v_h;

  // the band of columns any row of this tile may see
  const int pos_lo = q_offset + q0;
  const int pos_hi = q_offset + min(q0 + BQM, Sq) - 1;
  const int col_hi = causal ? min(Sk - 1, pos_hi) : Sk - 1;
  const int col_lo = window > 0 ? max(0, pos_lo - window + 1) : 0;
  const int t_first = col_lo / BK * BK;
  const int n_tiles = col_hi >= t_first ? (col_hi - t_first) / BK + 1 : 0;

  if constexpr (!kExact) zero_pad16<T, DP>(Qs, BQM + 4 * BK, D);  // Q, then the K and V stages
  stage16<T, DP, BQM, kExact>(qb, st.q_s, q0, Sq, Qs, D, vec);
  if (n_tiles > 0) {
    stage16<T, DP, BK, kExact>(kb, st.k_s, t_first, Sk, Ks, D, vec);
    stage16<T, DP, BK, kExact>(vb, st.v_s, t_first, Sk, Vs, D, vec);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  // A fragments of this warp's MT x 16 rows (rows warp*16*MT + 16*mt ..)
  uint32_t qf[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ldsm_x4(smem_u32(Qs + ((warp * MT + mt) * 16 + (lane & 15)) * LD + ks * 16 +
                       (lane >> 4) * 8),
              qf[mt][ks][0], qf[mt][ks][1], qf[mt][ks][2], qf[mt][ks][3]);

  // rows g and g + 8 of each m-tile: running max (in scaled log2 units),
  // this lane's share of the running sum, and the output accumulators
  float m_r[MT][2], l_r[MT][2];
  float acc[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_r[mt][r] = -INFINITY;
      l_r[mt][r] = 0.f;
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nd][e] = 0.f;
  }
  // position of row g of m-tile 0; m-tile mt adds 16 mt, row g + 8 adds 8
  const int pos_g = pos_lo + warp * 16 * MT + g;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_first + it * BK;
    const int buf = it & 1;
    __syncthreads();  // every warp is done with the other stage (tile it - 1)
    if (it + 1 < n_tiles) {
      stage16<T, DP, BK, kExact>(kb, st.k_s, t0 + BK, Sk, Ks + (buf ^ 1) * TILE, D, vec);
      stage16<T, DP, BK, kExact>(vb, st.v_s, t0 + BK, Sk, Vs + (buf ^ 1) * TILE, D, vec);
    }
    cp_commit();
    cp_wait<1>();  // tile it has landed; tile it + 1 stays in flight
    __syncthreads();
    const T* Kt = Ks + buf * TILE;
    const T* Vt = Vs + buf * TILE;

    // S = Q.K^T for the warp's rows x 64 keys; each K fragment feeds MT products
    float s[MT][NB][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nb][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(Kt + (nb * 8 + (lane >> 4) * 8 + (lane & 7)) * LD + ks * 16 +
                         ((lane >> 3) & 1) * 8),
                b0, b1, b2, b3);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816<T>(s[mt][nb], qf[mt][ks], b0, b1);
          mma16816<T>(s[mt][nb + 1], qf[mt][ks], b2, b3);
        }
      }
    }

    // the mask, only where the tile crosses the band's edge or Sk
    const bool edge = t0 + BK > Sk || (causal && t0 + BK - 1 > pos_lo) ||
                      (window > 0 && t0 <= pos_hi - window);
    if (edge) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = t0 + nb * 8 + 2 * t + (e & 1);
            const int pos = pos_g + 16 * mt + (e >> 1) * 8;
            const bool ok =
                col < Sk && (!causal || col <= pos) && (window <= 0 || col > pos - window);
            if (!ok) s[mt][nb][e] = -INFINITY;
          }
    }

    // online softmax on the fragments: e = 0, 1 are row g, e = 2, 3 row g + 8
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          mx = fmaxf(mx, fmaxf(s[mt][nb][2 * r], s[mt][nb][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m_r[mt][r], mx * scale_log2);
        // no valid column yet: keep exp2() away from (-inf) - (-inf)
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = fast_exp2(m_r[mt][r] - m_use);
        float psum = 0.f;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            s[mt][nb][e] = fast_exp2(fmaf(s[mt][nb][e], scale_log2, -m_use));  // 0 if masked
            psum += s[mt][nb][e];
          }
        l_r[mt][r] = l_r[mt][r] * alpha + psum;
        m_r[mt][r] = m_new;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          acc[mt][nd][2 * r] *= alpha;
          acc[mt][nd][2 * r + 1] *= alpha;
        }
      }

    // O += P.V: the S fragments of keys 16kk..16kk+15 are P's A fragment;
    // each V fragment feeds MT products
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack2(s[mt][2 * kk][0], s[mt][2 * kk][1], T());
        a[mt][1] = pack2(s[mt][2 * kk][2], s[mt][2 * kk][3], T());
        a[mt][2] = pack2(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1], T());
        a[mt][3] = pack2(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3], T());
      }
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(smem_u32(Vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + nd * 8 +
                           (lane >> 4) * 8),
                  b0, b1, b2, b3);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816<T>(acc[mt][nd], a[mt], b0, b1);
          mma16816<T>(acc[mt][nd + 1], a[mt], b2, b3);
        }
      }
    }
  }

  T* ob = o + b * st.o_b + h * st.o_h;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_r[mt][r];
      l += __shfl_xor_sync(kFull, l, 1);
      l += __shfl_xor_sync(kFull, l, 2);
      const int row = q0 + (warp * MT + mt) * 16 + g + 8 * r;
      if (row < Sq) {
        const float inv = 1.f / fmaxf(l, 1e-30f);
        T* orow = ob + row * st.o_s;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          const int col = nd * 8 + 2 * t;
          if (col < D) store_t(orow + col, acc[mt][nd][2 * r] * inv);
          if (col + 1 < D) store_t(orow + col + 1, acc[mt][nd][2 * r + 1] * inv);
        }
      }
    }
}

// ------------------------------------------------------------ launchers

struct Shape {
  int B, H, KV, Sq, Sk, D, causal, window, q_offset, vec;
};

template <int DP>
int launch_fma(const void* q, const void* k, const void* v, void* o, Types ty, const Shape& sh,
               const Strides& st, dim3 grid, cudaStream_t stream) {
  constexpr size_t smem = fma_smem_bytes<DP>();
  // the opt-in above 48 KB of shared memory; it is per device, so it is
  // set at every launch (a host-side call of about a microsecond)
  cudaError_t err = cudaFuncSetAttribute(flash_attention_fwd<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_attention_fwd<DP><<<grid, NT, smem, stream>>>(
      q, k, v, o, ty, sh.H, sh.KV, sh.Sq, sh.Sk, sh.D, sh.causal, sh.window, sh.q_offset,
      1.0f / sqrtf((float)sh.D), st, sh.vec);
  return (int)cudaGetLastError();
}

template <typename T, int DP, bool kExact>
int launch_mma(const void* q, const void* k, const void* v, void* o, const Shape& sh,
               const Strides& st, dim3 grid, cudaStream_t stream) {
  constexpr size_t smem = MmaTile<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_mma<T, DP, kExact>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float log2e = 1.4426950408889634f;
  flash_attention_mma<T, DP, kExact><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sh.H, sh.KV, sh.Sq, sh.Sk, sh.D, sh.causal, sh.window, sh.q_offset,
      log2e / sqrtf((float)sh.D), st, sh.vec);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_mma_exact(const void* q, const void* k, const void* v, void* o, const Shape& sh,
                     const Strides& st, dim3 grid, cudaStream_t s) {
  return sh.D == DP ? launch_mma<T, DP, true>(q, k, v, o, sh, st, grid, s)
                    : launch_mma<T, DP, false>(q, k, v, o, sh, st, grid, s);
}

template <typename T>
int launch_mma_dp(const void* q, const void* k, const void* v, void* o, const Shape& sh,
                  const Strides& st, dim3 grid, cudaStream_t s) {
  if (sh.D <= 32) return launch_mma_exact<T, 32>(q, k, v, o, sh, st, grid, s);
  if (sh.D <= 64) return launch_mma_exact<T, 64>(q, k, v, o, sh, st, grid, s);
  return launch_mma_exact<T, 128>(q, k, v, o, sh, st, grid, s);
}

int launch_fma_dp(const void* q, const void* k, const void* v, void* o, Types ty,
                  const Shape& sh, const Strides& st, dim3 grid, cudaStream_t s) {
  if (sh.D <= 32) return launch_fma<32>(q, k, v, o, ty, sh, st, grid, s);
  if (sh.D <= 64) return launch_fma<64>(q, k, v, o, ty, sh, st, grid, s);
  if (sh.D <= 128) return launch_fma<128>(q, k, v, o, ty, sh, st, grid, s);
  return launch_fma<256>(q, k, v, o, ty, sh, st, grid, s);
}

}  // namespace

// q (B,H,Sq,D), k and v (B,KV,Sk,D), o (B,H,Sq,D), each given by element
// strides of its first three axes (D unit-stride). q_dtype (q and o): 0
// fp32, 1 bf16, 2 fp16; k_dtype, v_dtype: those or 3 fp8 e4m3, 4 fp8
// e5m2. kernel 0 = the FMA kernel (any types, D <= 256; grid (n_q, H, B)),
// 1 = the tensor-core kernel (q, k, v all bf16 or all fp16, D <= 128; grid
// (H, B, n_q), q tiles heaviest first), n_q = ceil(Sq / rows a CTA): 64
// for fma, 128 for mma at D <= 64 and 64 above; the wrapper chooses the
// kernel and the grid (kernels/flash_attention.py launch_plan) and the
// launcher refuses a grid that does not cover the shape or a kernel that
// does not take the types and D. The wrapper checks the rest: H % KV ==
// 0, Sq and Sk >= 1, window >= 0, and vec = 1 only when every base and
// stride and each row's D elements are whole 16-byte chunks. Returns
// cudaGetLastError() after the launch on `stream`.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int kernel, int q_dtype, int k_dtype, int v_dtype, int B,
                                      int H, int KV, int Sq, int Sk, int D, int causal,
                                      int window, int q_offset, long long q_sb, long long q_sh,
                                      long long q_ss, long long k_sb, long long k_sh,
                                      long long k_ss, long long v_sb, long long v_sh,
                                      long long v_ss, long long o_sb, long long o_sh,
                                      long long o_ss, int vec, int gx, int gy, int gz,
                                      void* stream) {
  const Strides st{q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  const Shape sh{B, H, KV, Sq, Sk, D, causal, window, q_offset, vec};
  if (D < 1 || D > 256 || q_dtype < 0 || q_dtype > 2 || k_dtype < 0 || k_dtype > 4 ||
      v_dtype < 0 || v_dtype > 4)
    return (int)cudaErrorInvalidValue;
  // rows a CTA: 64 for fma, MmaTile<DP>::BQ for mma
  const int bq = kernel == 1 && D <= 64 ? 128 : 64;
  const int n_q = (Sq + bq - 1) / bq;
  const dim3 grid(gx, gy, gz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kernel) {
    case 0:
      if (gx != n_q || gy != H || gz != B) return (int)cudaErrorInvalidValue;
      return launch_fma_dp(q, k, v, o, Types{q_dtype, k_dtype, v_dtype}, sh, st, grid, s);
    case 1:
      if (gx != H || gy != B || gz != n_q || D > 128 || k_dtype != q_dtype ||
          v_dtype != q_dtype || (q_dtype != 1 && q_dtype != 2))
        return (int)cudaErrorInvalidValue;
      return q_dtype == 1 ? launch_mma_dp<__nv_bfloat16>(q, k, v, o, sh, st, grid, s)
                          : launch_mma_dp<__half>(q, k, v, o, sh, st, grid, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
