// flash_decode: one-query GQA attention against a KV cache, the serve
// path's decode hot spot.
//
// Replaces the Pallas kernel repro/kernels/flash_decode.py (flash_decode,
// body _decode_kernel). q (B,H,1,D) attends to k, v (B,KV,S,D); query head
// h reads kv head h / G (G = H / KV). Keys 0..pos[b] are valid in row b,
// and window > 0 keeps only cols > pos - window. The softmax is online in
// fp32, scaled by 1/sqrt(D); the output is acc / max(l, 1e-30) in q's type.
// q, k and v are each, independently, fp32, bf16, fp16, fp8 e4m3 or fp8
// e5m2, which the Pallas kernel upcasts as it does any dtype
// (.astype(f32)): here each cache's bytes come through the same cp.async
// ring in their storage type and are converted to fp32 in registers when
// read (cuda_fp8.h for the fp8 types). The output is in q's type, an fp8
// one rounded as the reference's astype (store_out). Any D and any G.
//
// Bound: bytes. Each valid K/V column is D elements read once per kv head;
// the work on it is 2*G*D multiply-adds for the scores and as many for the
// output, a few operations a byte, far below the card's ~295 operations a
// byte for bf16. The floor is the valid columns' bytes (plus q and the
// output) over 3.35 TB/s. At the serve shape that is ~10 MB, ~3 us: a
// read that short is bound by latency, so what counts is how many bytes
// are in flight on every SM (Little's law: 3.35 TB/s x ~1 us is ~25 KB an
// SM) and how few launches and round trips surround them.
//
// Design: one launch.
// - One CTA per (split of S, query chunk of a kv head, batch row), with
//   one warp per query row of the chunk, so a tile serves all of the
//   chunk's rows (the Pallas grid (B, H, n_k) reads each tile G times). A
//   kv head's G rows go in ceil(G / kMaxGroup) chunks of equal size (the
//   wrapper's query_chunks; every registered config has G <= 8, one
//   chunk); a row past G in the last chunk computes on q = 0 and writes
//   nothing. kMaxGroup warps keep a CTA's registers (up to ~170 a thread)
//   within the SM's 64K.
// - Tiles of 2048/DP keys stay in their storage types (k's and v's) in
//   shared memory and are converted when read. They arrive through a
//   ring of 4 stages of 16-byte cp.async copies (commit_group /
//   wait_group), so a CTA always has its next three tiles' bytes in
//   flight; with the wrapper's split plan a CTA's whole range is issued
//   before its first tile is used. Where a base or a stride is not a
//   multiple of 16 bytes, or a row's D elements are not whole 16-byte
//   chunks, the same kernel stages with ordinary loads.
// - Keys go across the lanes (LPK lanes a key where DP > 64, each on every
//   LPK-th 16-byte chunk): a lane dots its key with q, held in registers,
//   and adds p * V of its key to its own accumulators, so the inner loops
//   carry no shuffle; the lanes' sums are reduced once, at the end of the
//   range, by recursive halving (at most 62 shuffles a lane). K and V rows
//   are each padded by 16*LPK bytes, so the lanes of a 16-byte
//   shared-memory phase hit distinct bank groups.
// - The running max moves only when a tile's max passes it by more than
//   2^8, so the rescale of the accumulators is skipped on most tiles.
// - S is split because B*KV CTAs are too few (4*8 on the serve path for
//   132 SMs). The wrapper's split plan aims at several CTAs an SM; pos
//   stays on the device. A split walks only the columns of its range
//   inside [pos-window+1, pos] (columns outside contribute exact zeros in
//   the reference) and writes its partial (m, l, acc[DP]), m in log2 units.
// - The log-sum-exp merge is fused: after its partial is written and
//   fenced, a CTA adds one to its (row, query chunk) counter; the CTA that
//   sees n_split - 1 is the last, merges the partials of its chunk's rows,
//   writes the output and sets the counter back to 0. The counters belong
//   to the wrapper (zeroed once, one buffer per device and stream), so a
//   replay of a CUDA graph or the next call finds them at 0. A split with
//   no valid column has l = 0 and gets no weight: it is skipped, not
//   multiplied by zero, so no NaN can leak in.
// - The cache is read in its stored layout through strides: the serve
//   path's cache is (B,S,KV,D), seen here as a (B,KV,S,D) strided view, so
//   no copy of it is made. D must be the unit-stride axis.
// - Any D runs the layout of the next DP in (32, 64, 128, 256) (kimi-k2's
//   112 on 128): the copies fetch the D stored dims, K's pad dims in
//   every stage are zeroed once at the start (no copy writes them), q is
//   0 there, and the merge writes only the D dims. q's type is read once a
//   CTA and the output's written once a row, so it is a runtime switch;
//   k's type, v's type and DP are template arguments, and D too for
//   kimi-k2's 112.
// - A D above 256 runs flash_decode_wide (below): a CTA owns one 256-dim
//   slice of the output, computes the scores over all of D in 256-dim
//   pieces, and merges its slice as above.
// What is left (PERF.md): every one of the chunk's warps converts and
// multiplies the whole tile, ~300 instructions a lane a tile; a G above
// kMaxGroup reads each tile once a chunk; the G rows of a kv head as one
// tensor-core product and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileElems = 2048;  // keys x DP in one tile
constexpr int kStages = 4;        // tiles a CTA keeps in flight
constexpr int kMaxSplits = 64;    // ranges of S a (row, query chunk) is cut into, at most
constexpr int kMaxGroup = 8;      // query rows (warps) a CTA
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f(__nv_fp8_e5m2 x) { return static_cast<float>(x); }

// element i of a tensor of a storage type given by its code (0 fp32,
// 1 bf16, 2 fp16, 3 fp8 e4m3, 4 fp8 e5m2), as fp32: q's, and the wide
// kernel's k and v
__device__ __forceinline__ float load_any(const void* p, int dtype, long long i) {
  switch (dtype) {
    case 0: return static_cast<const float*>(p)[i];
    case 1: return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case 2: return __half2float(static_cast<const __half*>(p)[i]);
    case 3: return to_f(static_cast<const __nv_fp8_e4m3*>(p)[i]);
    default: return to_f(static_cast<const __nv_fp8_e5m2*>(p)[i]);
  }
}

// fp32 -> fp8 as the reference's astype (ml_dtypes): round to nearest
// even; e4m3 has no inf, so a value past its max 448 (|x| > 464, the
// midpoint to the next step) is NaN; e5m2 is inf from 61,440 on and
// writes NaN as 0x7e. Signs are kept. The hardware's conversion
// saturates to the largest finite value instead, so those cases are
// decided first.
__device__ __forceinline__ unsigned char fp8_e4m3_ref(float x) {
  const unsigned char sign = signbit(x) ? 0x80 : 0x00;
  if (isnan(x) || fabsf(x) > 464.f) return sign | 0x7f;
  return __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
}

__device__ __forceinline__ unsigned char fp8_e5m2_ref(float x) {
  const unsigned char sign = signbit(x) ? 0x80 : 0x00;
  if (isnan(x)) return sign | 0x7e;
  if (fabsf(x) >= 61440.f) return sign | 0x7c;
  return __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E5M2);
}

// the output in q's type by its code
__device__ __forceinline__ void store_out(void* o, int dtype, long long i, float x) {
  switch (dtype) {
    case 0: static_cast<float*>(o)[i] = x; break;
    case 1: static_cast<__nv_bfloat16*>(o)[i] = __float2bfloat16_rn(x); break;
    case 2: static_cast<__half*>(o)[i] = __float2half_rn(x); break;
    case 3: static_cast<unsigned char*>(o)[i] = fp8_e4m3_ref(x); break;
    default: static_cast<unsigned char*>(o)[i] = fp8_e5m2_ref(x); break;
  }
}

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A stage holds TILE keys' K rows, then their V rows, each in its storage
// type, DP dims to a row. A key is read by LPK lanes, each taking every
// LPK-th 16-byte chunk of the row (at most 64 dims a lane, so a lane's
// accumulators fit its registers). Rows are padded by 16*LPK bytes, so
// that the 8 lanes of a 16-byte shared-memory phase (8/LPK keys x LPK
// parts) hit 8 distinct 16-byte bank groups.
template <typename TK, typename TV, int DP>
struct Ring {
  static constexpr int TILE = kTileElems / DP;                   // keys a tile
  static constexpr int LPK = DP > 64 ? DP / 64 : 1;              // lanes a key
  static constexpr int ROW_K = DP * (int)sizeof(TK) + 16 * LPK;  // bytes of a padded K row
  static constexpr int ROW_V = DP * (int)sizeof(TV) + 16 * LPK;  // bytes of a padded V row
  static constexpr int STAGE = TILE * (ROW_K + ROW_V);           // bytes of one stage
  static constexpr size_t BYTES = (size_t)kStages * STAGE;
  static_assert(TILE * LPK % 32 == 0, "a tile fills whole warp passes");
};

// Visit the cells (r, e) of an n x w grid, cell r * w + e, from cell
// threadIdx.x in steps of blockDim.x, with no division a step: w is known
// only at run time.
template <typename F>
__device__ __forceinline__ void for_cells(int n, int w, F&& f) {
  const int dr = blockDim.x / w, de = blockDim.x % w;
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

// Rows [t0, t0 + n) of K and of V (row r of each ROW bytes apart, at
// `ks` and `vs`) in their storage types, which are of one size: the D
// stored dims of each row (the pad dims stay as they are), K's and V's
// chunk c in one loop pass. vec: 16-byte cp.async (D * sizeof(T) is whole
// chunks). DC is D where it is known when compiling (D == DP, and
// kimi-k2's 112 on the 128 layout: every registered head dim), so the
// chunk arithmetic is shifts and constant divisions; 0 takes the runtime
// D, stepped without divisions.
template <typename TK, typename TV, int ROW, int DC>
__device__ __forceinline__ void issue_pair(const TK* __restrict__ kb, const TV* __restrict__ vb,
                                           long long k_s, long long v_s, int t0, int n, int D,
                                           unsigned char* ks, unsigned char* vs, int vec) {
  static_assert(sizeof(TK) == sizeof(TV), "one chunk layout for K and V");
  constexpr int ES = sizeof(TK), VEC = 16 / ES;
  auto chunk = [&](int r, int e) {
    cp_async16(smem_u32(ks + r * ROW + e * ES), kb + (t0 + r) * k_s + e);
    cp_async16(smem_u32(vs + r * ROW + e * ES), vb + (t0 + r) * v_s + e);
  };
  auto elem = [&](int r, int d) {
    reinterpret_cast<TK*>(ks + r * ROW)[d] = kb[(t0 + r) * k_s + d];
    reinterpret_cast<TV*>(vs + r * ROW)[d] = vb[(t0 + r) * v_s + d];
  };
  if constexpr (DC != 0) {
    constexpr int CPR = DC / VEC;  // 16-byte chunks a row
    if (vec)
      for (int c = threadIdx.x; c < n * CPR; c += blockDim.x) chunk(c / CPR, (c % CPR) * VEC);
    else
      for (int c = threadIdx.x; c < n * DC; c += blockDim.x) elem(c / DC, c % DC);
  } else if (vec) {
    for_cells(n, D / VEC, [&](int r, int c) { chunk(r, c * VEC); });
  } else {
    for_cells(n, D, elem);
  }
}

// The same for one of K or V alone, where their types differ in size.
template <typename T, int ROW>
__device__ __forceinline__ void issue_rows(const T* __restrict__ src, long long s_stride, int t0,
                                           int n, int D, unsigned char* rows, int vec) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec)
    for_cells(n, D / VEC, [&](int r, int c) {
      cp_async16(smem_u32(rows + r * ROW + c * 16), src + (t0 + r) * s_stride + c * VEC);
    });
  else
    for_cells(n, D, [&](int r, int d) {
      reinterpret_cast<T*>(rows + r * ROW)[d] = src[(t0 + r) * s_stride + d];
    });
}

// Keys [t0, t0 + n) of one (S, D) head pair into a stage: K rows, then V
// rows. DC: D where the instance is built for one D below DP (0: any).
template <typename TK, typename TV, int DP, int DC>
__device__ __forceinline__ void issue_tile(const TK* __restrict__ kb, const TV* __restrict__ vb,
                                           long long k_s, long long v_s, int t0, int n, int D,
                                           unsigned char* stage, int vec) {
  using R = Ring<TK, TV, DP>;
  unsigned char* vs = stage + R::TILE * R::ROW_K;
  if constexpr (sizeof(TK) == sizeof(TV)) {
    if constexpr (DC != 0)
      issue_pair<TK, TV, R::ROW_K, DC>(kb, vb, k_s, v_s, t0, n, D, stage, vs, vec);
    else if (D == DP)
      issue_pair<TK, TV, R::ROW_K, DP>(kb, vb, k_s, v_s, t0, n, D, stage, vs, vec);
    else
      issue_pair<TK, TV, R::ROW_K, 0>(kb, vb, k_s, v_s, t0, n, D, stage, vs, vec);
  } else {
    issue_rows<TK, R::ROW_K>(kb, k_s, t0, n, D, stage, vec);
    issue_rows<TV, R::ROW_V>(vb, v_s, t0, n, D, vs, vec);
  }
}

// Zero the pad dims [D, DP) of `nrows` K rows ROW bytes apart, 16 bytes
// a store where D's bytes are whole 16-byte chunks; no copy writes them.
// q is 0 there, but a stale NaN pattern would still reach the score. V's
// pad dims reach only the pad dims of acc, which the merge never writes.
template <typename T, int ROW, int DP>
__device__ __forceinline__ void zero_pad(unsigned char* rows, int nrows, int D) {
  const int b0 = D * (int)sizeof(T), nb = DP * (int)sizeof(T) - b0;
  if (b0 % 16 == 0)
    for_cells(nrows, nb / 16, [&](int r, int c) {
      *reinterpret_cast<uint4*>(rows + r * ROW + b0 + c * 16) = make_uint4(0, 0, 0, 0);
    });
  else
    for_cells(nrows, nb, [&](int r, int i) { rows[r * ROW + b0 + i] = 0; });
}

// q . k for 16 bytes of k (16 / sizeof(T) elements) against fp32 q
template <typename T>
__device__ __forceinline__ float dot16(const unsigned char* kr, const float* qv, float acc) {
  const uint4 w = *reinterpret_cast<const uint4*>(kr);
  const T* x = reinterpret_cast<const T*>(&w);
#pragma unroll
  for (int u = 0; u < (int)(16 / sizeof(T)); ++u) acc = fmaf(qv[u], to_f(x[u]), acc);
  return acc;
}

// TK, TV: the caches' types; DP: the dims a row holds in shared memory and
// a partial (the stored D padded); DC: the one D an instance takes, where
// it has its own (kimi-k2's 112; 0: any D up to DP). q and out are of
// q_dtype (0-4, as load_any). blockDim.x / 32 warps take query rows
// chunk * GC + warp of kv head kvh, where blockIdx.y = kvh * n_chunk +
// chunk.
template <typename TK, typename TV, int DP, int DC>
__global__ void __launch_bounds__(kMaxGroup * 32)
    flash_decode_kernel(const void* __restrict__ q, int q_dtype, const TK* __restrict__ k,
                        const TV* __restrict__ v, const int* __restrict__ pos,
                        void* __restrict__ out, float* __restrict__ part_m,
                        float* __restrict__ part_l, float* __restrict__ part_acc,
                        int* __restrict__ counter, int H, int G, int n_chunk, int D, int S,
                        int window, int chunk, int n_split, float scale_log2, Strides st,
                        int vec) {
  using R = Ring<TK, TV, DP>;
  constexpr int TILE = R::TILE;
  constexpr int LPK = R::LPK;             // lanes a key
  constexpr int DL = DP / LPK;            // dims a lane accumulates
  constexpr int SLOTS = 32 / LPK;         // keys a warp takes at once
  constexpr int KPL = TILE / SLOTS;       // keys a lane, a tile
  constexpr int VK = 16 / sizeof(TK);     // elements of a 16-byte K chunk
  constexpr int VV = 16 / sizeof(TV);     // elements of a 16-byte V chunk
  constexpr int CPK = DL / VK;            // chunks of a K row a lane reads
  constexpr int CPV = DL / VV;            // chunks of a V row a lane reads
  constexpr int DPL = DP / 32;            // output dims a lane in the merge
  constexpr int NSTEP = LPK == 1 ? 5 : LPK == 2 ? 4 : 3;  // log2(SLOTS)
  static_assert(DL >> NSTEP == DPL, "the halving leaves DPL values a lane");
  static_assert(CPK % 2 == 0 && CPV >= 1, "a lane's K chunks go in pairs");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  const int GC = blockDim.x / 32;                 // query rows a CTA
  float* q_s = reinterpret_cast<float*>(smem);   // (GC, DP)
  unsigned char* ring = smem + GC * DP * sizeof(float);

  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / n_chunk, qc = blockIdx.y % n_chunk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = qc * GC + warp;                  // this warp's query row of the kv head
  const bool live = g < G;                       // a row past G computes on q = 0, writes nothing
  const int p = pos[b];
  const int lo = window > 0 ? max(p - window + 1, 0) : 0;
  const int c0 = max(split * chunk, lo);
  const int c1 = min(min(split * chunk + chunk, S), p + 1);  // exclusive
  const int n_t = c1 > c0 ? (c1 - c0 + TILE - 1) / TILE : 0;

  const TK* kb = k + b * st.k_b + kvh * st.k_h;
  const TV* vb = v + b * st.v_b + kvh * st.v_h;
  if (D < DP)
    for (int s = 0; s < kStages; ++s) zero_pad<TK, R::ROW_K, DP>(ring + s * R::STAGE, TILE, D);
  // the ring's first stages go out before anything else
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_t)
      issue_tile<TK, TV, DP, DC>(kb, vb, st.k_s, st.v_s, c0 + i * TILE,
                                 min(TILE, c1 - c0 - i * TILE), D, ring + i * R::STAGE, vec);
    cp_commit();
  }
  for (int i = threadIdx.x; i < GC * DP; i += blockDim.x) {
    const int gi = qc * GC + i / DP, d = i % DP;
    q_s[i] = d < D && gi < G
                 ? load_any(q, q_dtype, b * st.q_b + (long long)(kvh * G + gi) * st.q_h + d)
                 : 0.f;
  }
  const int part = lane % LPK, slot = lane / LPK;
  __syncthreads();  // q_s is written (the ring's copies stay in flight)
  float qv[DL];     // this warp's query row over this lane's K dims, in registers
#pragma unroll
  for (int c = 0; c < CPK; ++c)
#pragma unroll
    for (int u = 0; u < VK; ++u) qv[c * VK + u] = q_s[warp * DP + (c * LPK + part) * VK + u];

  float m = -INFINITY, l = 0.f;
  float acc[DL];  // this lane's keys' p * V over its DL V dims
#pragma unroll
  for (int i = 0; i < DL; ++i) acc[i] = 0.f;

  for (int i = 0; i < n_t; ++i) {
    const int j_next = i + kStages - 1;
    if (j_next < n_t)
      issue_tile<TK, TV, DP, DC>(kb, vb, st.k_s, st.v_s, c0 + j_next * TILE,
                                 min(TILE, c1 - c0 - j_next * TILE), D,
                                 ring + (j_next % kStages) * R::STAGE, vec);
    cp_commit();
    cp_wait<kStages - 1>();  // tile i has landed
    __syncthreads();         // ... for every thread's copies

    const int n = min(TILE, c1 - c0 - i * TILE);
    const unsigned char* ks = ring + (i % kStages) * R::STAGE;
    const unsigned char* vs = ks + TILE * R::ROW_K;
    // scores: key j = slot + SLOTS * kk, its LPK lanes each dot DL dims
    float s[KPL];
    float tmax = -INFINITY;
#pragma unroll
    for (int kk = 0; kk < KPL; ++kk) {
      const int j = slot + SLOTS * kk;
      float dot0 = 0.f, dot1 = 0.f;  // two chains of FMAs
      if (j < n) {
        const unsigned char* kr = ks + j * R::ROW_K;
#pragma unroll
        for (int c = 0; c < CPK; c += 2) {
          // this lane's chunks of the row are every LPK-th, from `part`
          dot0 = dot16<TK>(kr + (c * LPK + part) * 16, qv + c * VK, dot0);
          dot1 = dot16<TK>(kr + ((c + 1) * LPK + part) * 16, qv + (c + 1) * VK, dot1);
        }
      }
      float dot = dot0 + dot1;
#pragma unroll
      for (int o = 1; o < LPK; o <<= 1) dot += __shfl_xor_sync(kFull, dot, o);
      s[kk] = j < n ? dot * scale_log2 : -INFINITY;
      tmax = fmaxf(tmax, s[kk]);
    }
    // the running max moves only when a tile's max passes it by more than
    // 8 (log2 units): p <= 2^8 stays exact in fp32 and l, acc and m stay
    // consistent, so the rescale of acc is skipped on most tiles
    const float t_max = warp_max(tmax);  // finite: n >= 1
    if (t_max > m + 8.f) {               // uniform across the warp; true on the first tile
      const float alpha = exp2f(m - t_max);  // 0 on the first tile
      l *= alpha;
#pragma unroll
      for (int d = 0; d < DL; ++d) acc[d] *= alpha;
      m = t_max;
    }
    float pj[KPL];
    float psum = 0.f;
#pragma unroll
    for (int kk = 0; kk < KPL; ++kk) {
      pj[kk] = s[kk] == -INFINITY ? 0.f : exp2f(s[kk] - m);
      if (part == 0) psum += pj[kk];  // each key once
    }
    l += warp_sum(psum);
    // P.V: each lane adds its keys' rows over its dims; no shuffles
#pragma unroll
    for (int kk = 0; kk < KPL; ++kk) {
      const int j = slot + SLOTS * kk;
      if (j < n) {
        const unsigned char* vr = vs + j * R::ROW_V;
#pragma unroll
        for (int c = 0; c < CPV; ++c) {
          const uint4 w = *reinterpret_cast<const uint4*>(vr + (c * LPK + part) * 16);
          const TV* x = reinterpret_cast<const TV*>(&w);
#pragma unroll
          for (int u = 0; u < VV; ++u) acc[c * VV + u] = fmaf(pj[kk], to_f(x[u]), acc[c * VV + u]);
        }
      }
    }
    __syncthreads();  // the stage is consumed before the ring refills it
  }

  // sum acc over the SLOTS lanes of each part by recursive halving: after
  // the step over lane bit o a lane keeps half of its values, so each
  // lane ends with DPL of them, list indices idx0.. of its part's dims
  int idx0 = 0;
#pragma unroll
  for (int step = 0; step < NSTEP; ++step) {
    const int o = 16 >> step;              // lane bit of this step
    const int half = DL >> (step + 1);     // values kept after it
    const bool upper = lane & o;
    // a fixed trip count, so that every index is known when it unrolls
    // (a variable one leaves acc in local memory)
#pragma unroll
    for (int i = 0; i < DL / 2; ++i) {
      if (i < half) {
        const float send = upper ? acc[i] : acc[i + half];
        const float keep = upper ? acc[i + half] : acc[i];
        acc[i] = keep + __shfl_xor_sync(kFull, send, o);
      }
    }
    if (upper) idx0 += half;
  }

  // this split's partial; rows (b, kvh * G + g)
  const long long row = (long long)b * H + kvh * G + g;
  const long long prow = row * n_split + split;
  if (live && lane == 0) {
    part_m[prow] = m;
    part_l[prow] = l;
  }
  if (live && n_t > 0) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int x = idx0 + i;  // list index -> dim: chunk x / VV of this part
      part_acc[prow * DP + ((x / VV) * LPK + part) * VV + x % VV] = acc[i];
    }
  }

  // the last split of this (row, query chunk) to finish merges
  int* ctr = counter + (long long)b * gridDim.y + blockIdx.y;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int done = atomicAdd(ctr, 1);
    is_last = done == n_split - 1;
  }
  __syncthreads();
  if (!is_last) return;
  if (threadIdx.x == 0) *ctr = 0;
  if (!live) return;
  __threadfence();
  // lane s holds split s's (m, l) for s = lane, lane + 32: the weights
  // come from two shuffle reductions, and every split's acc load is
  // issued without waiting on another's
  constexpr int SPL = kMaxSplits / 32;
  const long long base = row * n_split;
  float ms[SPL], ws[SPL];
  float M = -INFINITY, L = 0.f;
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const int s2 = lane + 32 * i;
    ws[i] = s2 < n_split ? __ldcg(part_l + base + s2) : 0.f;
    ms[i] = ws[i] > 0.f ? __ldcg(part_m + base + s2) : -INFINITY;
    M = fmaxf(M, ms[i]);
  }
  M = warp_max(M);  // finite: the split holding pos has l > 0
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const float w = ws[i] > 0.f ? exp2f(ms[i] - M) : 0.f;  // l = 0: no weight
    L = fmaf(ws[i], w, L);
    ws[i] = w;
  }
  L = warp_sum(L);
  // the weights through shared memory (the ring is consumed), so that
  // the acc loads of several splits go out together
  float* w_s = reinterpret_cast<float*>(ring) + warp * kMaxSplits;
#pragma unroll
  for (int i = 0; i < SPL; ++i) w_s[lane + 32 * i] = ws[i];
  __syncwarp();
  float A[DPL];
#pragma unroll
  for (int dd = 0; dd < DPL; ++dd) A[dd] = 0.f;
#pragma unroll 8
  for (int s2 = 0; s2 < n_split; ++s2) {
    const float w = w_s[s2];
    const float* pa = part_acc + (base + s2) * DP + lane * DPL;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) {
      // a split with l = 0 wrote no acc: it is skipped, not read
      const float x = w > 0.f ? __ldcg(pa + dd) : 0.f;
      A[dd] = fmaf(w, x, A[dd]);
    }
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
#pragma unroll
  for (int dd = 0; dd < DPL; ++dd)
    if (lane * DPL + dd < D) store_out(out, q_dtype, row * D + lane * DPL + dd, A[dd] * inv);
}

// ------------------------------------------- D above 256: flash_decode_wide
//
// One CTA of 256 threads per (split of S, output slice, query chunk of a kv
// head, batch row). Keys go in tiles of 32, one a lane: for each 256-dim
// piece of D, q's piece (the chunk's rows) and the tile's K piece are
// staged in fp32 in shared memory, and warp g adds row g's dot with the
// lane's key over the piece. Warp g then runs row g's online softmax
// (exact running max) and leaves the tile's probabilities in shared
// memory; the tile's V rows over the CTA's slice are staged in the K
// piece's place, and thread t adds p * V to dim t of the slice for every
// row of the chunk. K is read once a slice, V once. The partial (m, l,
// acc over the slice) is merged as flash_decode_kernel merges, per (row,
// slice): the last split of a (row, kv head, query chunk, slice) merges.
// Plain loads, converted as they are staged; no cp.async ring (its
// speed is later work).

constexpr int kWideSlice = 256;   // output dims a CTA, and k dims a score pass stages
constexpr int kWideTile = 32;     // keys a tile, one a lane
constexpr int kWideThreads = kWideSlice;  // one thread an output dim of the slice

// rows [t0, t0 + n) of one (S, D) head, dims [d0, d0 + w), as fp32 into
// dst (kWideTile rows of ld floats, kWideSlice dims each); rows past n
// and dims past w are 0
template <typename T>
__device__ __forceinline__ void wide_rows(const T* __restrict__ src, long long s_stride, int t0,
                                          int n, int d0, int w, float* dst, int ld) {
  const int d = threadIdx.x;
#pragma unroll 8
  for (int r = 0; r < kWideTile; ++r)
    dst[r * ld + d] = r < n && d < w ? to_f(src[(t0 + r) * s_stride + d0 + d]) : 0.f;
}

__device__ __forceinline__ void wide_stage(const void* src, int dtype, long long off,
                                           long long s_stride, int t0, int n, int d0, int w,
                                           float* dst, int ld) {
  switch (dtype) {
    case 0:
      wide_rows(static_cast<const float*>(src) + off, s_stride, t0, n, d0, w, dst, ld);
      break;
    case 1:
      wide_rows(static_cast<const __nv_bfloat16*>(src) + off, s_stride, t0, n, d0, w, dst, ld);
      break;
    case 2:
      wide_rows(static_cast<const __half*>(src) + off, s_stride, t0, n, d0, w, dst, ld);
      break;
    case 3:
      wide_rows(static_cast<const __nv_fp8_e4m3*>(src) + off, s_stride, t0, n, d0, w, dst, ld);
      break;
    default:
      wide_rows(static_cast<const __nv_fp8_e5m2*>(src) + off, s_stride, t0, n, d0, w, dst, ld);
      break;
  }
}

// blockIdx.y = (kvh * n_chunk + chunk) * n_slice + slice; q, k, v and the
// output of types by code (load_any); part_acc holds kWideSlice floats a
// (row, slice, split)
// 2 CTAs an SM at least: ptxas otherwise sizes the registers for the 5
// CTAs that the 44 KB of static shared memory allow (48 a thread) and
// spills
__global__ void __launch_bounds__(kWideThreads, 2)
    flash_decode_wide(const void* __restrict__ q, const void* __restrict__ k,
                      const void* __restrict__ v, int q_dtype, int k_dtype, int v_dtype,
                      const int* __restrict__ pos, void* __restrict__ out,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, int* __restrict__ counter, int H, int G,
                      int GC, int n_chunk, int n_slice, int D, int S, int window, int chunk,
                      int n_split, float scale_log2, Strides st) {
  constexpr int LD = kWideSlice + 1;  // padded rows: lane j reads row j without conflicts
  __shared__ float q_s[kMaxGroup][kWideSlice];
  __shared__ float kv_s[kWideTile * LD];  // a K piece, then the V slice
  __shared__ float p_s[kMaxGroup][kWideTile];
  __shared__ float alpha_s[kMaxGroup];
  __shared__ float w_s[kMaxGroup][kMaxSplits];
  __shared__ float l_s[kMaxGroup];
  __shared__ int is_last;

  const int split = blockIdx.x, b = blockIdx.z;
  const int slice = blockIdx.y % n_slice, qc = blockIdx.y / n_slice % n_chunk;
  const int kvh = blockIdx.y / (n_slice * n_chunk);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool scorer = warp < GC && qc * GC + warp < G;  // warp g scores row qc * GC + g
  const int p = pos[b];
  const int lo = window > 0 ? max(p - window + 1, 0) : 0;
  const int c0 = max(split * chunk, lo);
  const int c1 = min(min(split * chunk + chunk, S), p + 1);  // exclusive
  const int s0 = slice * kWideSlice;       // the slice's first dim
  const int sw = min(kWideSlice, D - s0);  // its dims
  const long long kb = b * st.k_b + kvh * st.k_h, vb = b * st.v_b + kvh * st.v_h;
  const long long qb = b * st.q_b + (long long)(kvh * G + qc * GC) * st.q_h;

  float m = -INFINITY, l = 0.f;  // a scorer warp's row: running max (log2 units), sum
  float acc[kMaxGroup];          // dim s0 + tid of each row of the chunk
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;

  for (int t0 = c0; t0 < c1; t0 += kWideTile) {
    const int n = min(kWideTile, c1 - t0);
    float sc0 = 0.f, sc1 = 0.f;  // q . k of the warp's row and key t0 + lane
    for (int d0 = 0; d0 < D; d0 += kWideSlice) {
      const int w = min(kWideSlice, D - d0);
      __syncthreads();  // the last pass's q_s and kv_s (and the last tile's V) are consumed
      for (int g = 0; g < GC; ++g)
        q_s[g][tid] = tid < w && qc * GC + g < G
                          ? load_any(q, q_dtype, qb + g * st.q_h + d0 + tid) : 0.f;
      wide_stage(k, k_dtype, kb, st.k_s, t0, n, d0, w, kv_s, LD);
      __syncthreads();
      if (scorer) {
        const float* qr = q_s[warp];
        const float* kr = kv_s + lane * LD;
#pragma unroll 8
        for (int d = 0; d < kWideSlice; d += 2) {
          sc0 = fmaf(qr[d], kr[d], sc0);
          sc1 = fmaf(qr[d + 1], kr[d + 1], sc1);
        }
      }
    }
    if (scorer) {
      const float s = lane < n ? (sc0 + sc1) * scale_log2 : -INFINITY;
      const float m_new = fmaxf(m, warp_max(s));  // finite: n >= 1
      const float alpha = exp2f(m - m_new);       // 0 on the first tile
      const float pj = lane < n ? exp2f(s - m_new) : 0.f;
      l = l * alpha + warp_sum(pj);
      m = m_new;
      p_s[warp][lane] = pj;
      if (lane == 0) alpha_s[warp] = alpha;
    }
    __syncthreads();  // the K piece is consumed; p_s, alpha_s written
    wide_stage(v, v_dtype, vb, st.v_s, t0, n, s0, sw, kv_s, LD);
    __syncthreads();
    // a row past G has no p_s: its acc is never written out
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < GC) acc[g] *= alpha_s[g];
#pragma unroll 4
    for (int j = 0; j < kWideTile; ++j) {
      const float vj = kv_s[j * LD + tid];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < GC) acc[g] = fmaf(p_s[g][j], vj, acc[g]);
    }
  }

  // this split's partials: (m, l) from each scorer warp, acc from every thread
  const long long row0 = (long long)b * H + kvh * G + qc * GC;  // the chunk's first row
  if (scorer && lane == 0) {
    const long long prow = ((row0 + warp) * n_slice + slice) * n_split + split;
    part_m[prow] = m;
    part_l[prow] = l;
  }
  if (c1 > c0) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < GC && qc * GC + g < G)
        part_acc[(((row0 + g) * n_slice + slice) * n_split + split) * kWideSlice + tid] = acc[g];
  }

  // the last split of this (row, kv head, query chunk, slice) merges
  int* ctr = counter + (long long)b * gridDim.y + blockIdx.y;
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(ctr, 1) == n_split - 1;
  __syncthreads();
  if (!is_last) return;
  if (tid == 0) *ctr = 0;
  __threadfence();
  constexpr int SPL = kMaxSplits / 32;
  if (scorer) {
    const long long base = ((row0 + warp) * n_slice + slice) * n_split;
    float ms[SPL], ws[SPL];
    float M = -INFINITY, L = 0.f;
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      const int s2 = lane + 32 * i;
      ws[i] = s2 < n_split ? __ldcg(part_l + base + s2) : 0.f;
      ms[i] = ws[i] > 0.f ? __ldcg(part_m + base + s2) : -INFINITY;
      M = fmaxf(M, ms[i]);
    }
    M = warp_max(M);
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      const float w = ws[i] > 0.f ? exp2f(ms[i] - M) : 0.f;  // l = 0: no weight
      L = fmaf(ws[i], w, L);
      w_s[warp][lane + 32 * i] = w;
    }
    L = warp_sum(L);
    if (lane == 0) l_s[warp] = L;
  }
  __syncthreads();
  if (tid >= sw) return;
  for (int g = 0; g < GC && qc * GC + g < G; ++g) {
    const long long base = ((row0 + g) * n_slice + slice) * n_split;
    float A = 0.f;
    for (int s2 = 0; s2 < n_split; ++s2) {
      const float w = w_s[g][s2];
      // a split with l = 0 wrote no acc: it is skipped, not read
      A = fmaf(w, w > 0.f ? __ldcg(part_acc + (base + s2) * kWideSlice + tid) : 0.f, A);
    }
    // the SFU's reciprocal (2 ulp): the IEEE one's slow path is a call,
    // whose frame the stores' switch on q's type would copy five times
    store_out(out, q_dtype, (row0 + g) * D + s0 + tid, A * __fdividef(1.f, fmaxf(l_s[g], 1e-30f)));
  }
}

struct Args {
  const void *q, *k, *v;
  const int* pos;
  void* out;
  float* part;
  int* counter;
  int q_dtype, B, H, KV, G, GC, n_chunk, S, D, window, chunk, n_split, vec;
  Strides st;
  cudaStream_t stream;
};

template <typename TK, typename TV, int DP, int DC = 0>
int launch(const Args& a) {
  if (a.n_split > kMaxSplits || a.GC < 1 || a.GC > kMaxGroup || a.GC * a.n_chunk < a.G ||
      a.D < 1 || a.D > DP || (DC != 0 && a.D != DC))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)a.B * a.H * a.n_split;
  const size_t smem = (size_t)a.GC * DP * sizeof(float) + Ring<TK, TV, DP>::BYTES;
  // the opt-in above 48 KB of shared memory; it is per device, so it is
  // set at every launch (a host-side call of about a microsecond)
  cudaError_t err = cudaFuncSetAttribute(flash_decode_kernel<TK, TV, DP, DC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.n_split, a.KV * a.n_chunk, a.B);
  flash_decode_kernel<TK, TV, DP, DC><<<grid, a.GC * 32, smem, a.stream>>>(
      a.q, a.q_dtype, static_cast<const TK*>(a.k), static_cast<const TV*>(a.v), a.pos, a.out,
      a.part, a.part + rows, a.part + 2 * rows, a.counter, a.H, a.G, a.n_chunk, a.D, a.S,
      a.window, a.chunk, a.n_split, 1.4426950408889634f / sqrtf((float)a.D), a.st, a.vec);
  return (int)cudaGetLastError();
}

template <typename TK, typename TV>
int launch_dp(const Args& a) {
  if (a.D <= 32) return launch<TK, TV, 32>(a);
  if (a.D <= 64) return launch<TK, TV, 64>(a);
  // kimi-k2's 112 has an instance of its own where K and V share one copy
  // loop: its widths are then known when compiling, and the D = DP
  // instances keep their registers (168 on the 128 layout; one more
  // halves the CTAs an SM holds at G 6)
  if constexpr (sizeof(TK) == sizeof(TV))
    if (a.D == 112) return launch<TK, TV, 128, 112>(a);
  if (a.D <= 128) return launch<TK, TV, 128>(a);
  return launch<TK, TV, 256>(a);
}

int launch_wide(int k_dtype, int v_dtype, const Args& a) {
  const int n_slice = (a.D + kWideSlice - 1) / kWideSlice;
  if (a.n_split > kMaxSplits || a.GC < 1 || a.GC > kMaxGroup || a.GC * a.n_chunk < a.G ||
      a.chunk % kWideTile != 0)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)a.B * a.H * n_slice * a.n_split;
  const dim3 grid(a.n_split, a.KV * a.n_chunk * n_slice, a.B);
  flash_decode_wide<<<grid, kWideThreads, 0, a.stream>>>(
      a.q, a.k, a.v, a.q_dtype, k_dtype, v_dtype, a.pos, a.out, a.part, a.part + rows,
      a.part + 2 * rows, a.counter, a.H, a.G, a.GC, a.n_chunk, n_slice, a.D, a.S, a.window,
      a.chunk, a.n_split, 1.4426950408889634f / sqrtf((float)a.D), a.st);
  return (int)cudaGetLastError();
}

template <typename TK>
int launch_v(int v_dtype, const Args& a) {
  switch (v_dtype) {
    case 0: return launch_dp<TK, float>(a);
    case 1: return launch_dp<TK, __nv_bfloat16>(a);
    case 2: return launch_dp<TK, __half>(a);
    case 3: return launch_dp<TK, __nv_fp8_e4m3>(a);
    case 4: return launch_dp<TK, __nv_fp8_e5m2>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,1,D), k and v (B,KV,S,D) given by element strides (D unit-stride),
// pos (B,) int32, out (B,H,1,D) contiguous, part B*H*n_slice*n_split*(DS+2)
// fp32 scratch (up to D 256 n_slice 1 and DS = D rounded up to 32, 64, 128
// or 256; above it n_slice = ceil(D / 256) and DS 256), counter
// B*KV*n_chunk*n_slice int32 that is 0 at the launch (and is 0 again when
// the kernel ends). q_dtype, k_dtype and v_dtype: 0 fp32, 1 bf16, 2 fp16,
// 3 fp8 e4m3, 4 fp8 e5m2; the output is of q's. The wrapper checks the
// shapes and plans the launch: H = KV * G, D >= 1, the query rows of a kv
// head in n_chunk chunks of GC <= 8 (GC * n_chunk >= G), chunk a multiple
// of the tile (2048/DS keys, 32 above D 256), n_split <= 64, and vec = 1
// only where every base and stride of k and v and each row's D elements
// are whole 16-byte chunks. Returns cudaGetLastError() after the launch on
// `stream`.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v, const void* pos,
                                   void* out, void* part, void* counter, int q_dtype,
                                   int k_dtype, int v_dtype, int B, int H, int KV, int GC,
                                   int n_chunk, int S, int D, int window, int chunk, int n_split,
                                   long long q_sb, long long q_sh, long long k_sb,
                                   long long k_sh, long long k_ss, long long v_sb,
                                   long long v_sh, long long v_ss, int vec, void* stream) {
  if (q_dtype < 0 || q_dtype > 4 || k_dtype < 0 || k_dtype > 4 || v_dtype < 0 || v_dtype > 4 ||
      KV < 1 || H % KV || D < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const int*>(pos), out, static_cast<float*>(part),
               static_cast<int*>(counter), q_dtype, B, H, KV, H / KV, GC, n_chunk, S, D, window,
               chunk, n_split, vec, Strides{q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss},
               static_cast<cudaStream_t>(stream)};
  if (D > 256) return launch_wide(k_dtype, v_dtype, a);
  switch (k_dtype) {
    case 0: return launch_v<float>(v_dtype, a);
    case 1: return launch_v<__nv_bfloat16>(v_dtype, a);
    case 2: return launch_v<__half>(v_dtype, a);
    case 3: return launch_v<__nv_fp8_e4m3>(v_dtype, a);
    case 4: return launch_v<__nv_fp8_e5m2>(v_dtype, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
