// flash_decode: one-query GQA attention against a KV cache, the serve
// path's decode hot spot.
//
// Replaces the Pallas kernel repro/kernels/flash_decode.py (flash_decode,
// body _decode_kernel). q (B,H,1,D) attends to k, v (B,KV,S,D); query head
// h reads kv head h / G (G = H / KV). Keys 0..pos[b] are valid in row b,
// and window > 0 keeps only cols > pos - window. The softmax is online in
// fp32, scaled by 1/sqrt(D); the output is acc / max(l, 1e-30) in q's type.
// k and v are q's type (fp32, bf16, fp16) or an fp8 (e4m3) cache, which
// the Pallas kernel upcasts as it does any dtype (.astype(f32)): here the
// fp8 bytes come through the same cp.async ring, half a bf16 tile's, and
// are converted to fp32 in registers when read (cuda_fp8.h).
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
// - One CTA per (split of S, kv head, batch row), with G warps, one per
//   query row of that kv head, so a tile serves all G rows (the Pallas
//   grid (B, H, n_k) reads each tile G times).
// - Tiles of 2048/D keys stay in their storage type (fp32, bf16 or fp16)
//   in shared memory and are converted when read. They arrive through a
//   ring of 4 stages of 16-byte cp.async copies (commit_group /
//   wait_group), so a CTA always has its next three tiles' bytes in
//   flight; with the wrapper's split plan a CTA's whole range is issued
//   before its first tile is used. Where a base or a stride is not a
//   multiple of 16 bytes the same kernel stages with ordinary loads.
// - Keys go across the lanes (LPK lanes a key where D > 64, each on every
//   LPK-th 16-byte chunk): a lane dots its key with q, held in registers,
//   and adds p * V of its key to its own accumulators, so the inner loops
//   carry no shuffle; the lanes' sums are reduced once, at the end of the
//   range, by recursive halving (at most 62 shuffles a lane). Rows are
//   padded by 16*LPK bytes, so the lanes of a 16-byte shared-memory phase
//   hit distinct bank groups.
// - The running max moves only when a tile's max passes it by more than
//   2^8, so the rescale of the accumulators is skipped on most tiles.
// - S is split because B*KV CTAs are too few (4*8 on the serve path for
//   132 SMs). The wrapper's split plan aims at several CTAs an SM; pos
//   stays on the device. A split walks only the columns of its range
//   inside [pos-window+1, pos] (columns outside contribute exact zeros in
//   the reference) and writes its partial (m, l, acc[D]), m in log2 units.
// - The log-sum-exp merge is fused: after its partial is written and
//   fenced, a CTA adds one to its (row, kv head) counter; the CTA that
//   sees n_split - 1 is the last, merges the partials of its G rows,
//   writes the output and sets the counter back to 0. The counters belong
//   to the wrapper (zeroed once, one buffer per device and stream), so a
//   replay of a CUDA graph or the next call finds them at 0. A split with
//   no valid column has l = 0 and gets no weight: it is skipped, not
//   multiplied by zero, so no NaN can leak in.
// - The cache is read in its stored layout through strides: the serve
//   path's cache is (B,S,KV,D), seen here as a (B,KV,S,D) strided view, so
//   no copy of it is made. D must be the unit-stride axis.
// - D = 112 (kimi-k2's head_dim) runs the D = 128 kernel on rows padded
//   to 128 dims (DP): the copies fetch the 112 stored dims, the pad
//   columns of every stage are zeroed once at the start (no copy writes
//   them), q is 0 there, and the merge writes only the 112 dims.
// What is left (PERF.md): every one of the G warps converts and multiplies
// the whole tile, ~300 instructions a lane a tile; the G rows of a kv
// head as one tensor-core product and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileElems = 2048;  // keys x D in one tile
constexpr int kStages = 4;        // tiles a CTA keeps in flight
constexpr int kMaxSplits = 64;    // ranges of S a (row, kv head) is cut into, at most
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
template <>
__device__ __forceinline__ float to_f<__nv_fp8_e4m3>(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

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

// The dims a row holds in shared memory: D, or D = 112 padded to 128.
template <int D>
__host__ __device__ constexpr int padded_dims() { return D == 112 ? 128 : D; }

// A stage holds TILE keys' K rows, then their V rows, in the storage
// type, D (the padded dims) to a row. A key is read by LPK lanes, each
// taking every LPK-th 16-byte chunk of the row (at most 64 dims a lane,
// so a lane's accumulators fit its registers). Rows are padded by 16*LPK
// bytes, so that the 8 lanes of a 16-byte shared-memory phase (8/LPK
// keys x LPK parts) hit 8 distinct 16-byte bank groups.
template <typename T, int D>
struct Ring {
  static constexpr int TILE = kTileElems / D;                  // keys a tile
  static constexpr int LPK = D > 64 ? D / 64 : 1;              // lanes a key
  static constexpr int ROW = D * (int)sizeof(T) + 16 * LPK;    // bytes of a padded row
  static constexpr int STAGE = 2 * TILE * ROW;                 // bytes of one stage
  static constexpr size_t BYTES = (size_t)kStages * STAGE;
  static_assert(TILE * LPK % 32 == 0, "a tile fills whole warp passes");
};

// Keys [t0, t0 + n) of one (S, D) head pair into a stage: K rows, then V
// rows, each ROW bytes apart, in the storage type; the stored D dims of
// each row (DP - D pad dims stay as they are).
template <typename T, int D>
__device__ __forceinline__ void issue_tile(const T* __restrict__ kb, const T* __restrict__ vb,
                                           long long k_s, long long v_s, int t0, int n,
                                           unsigned char* stage, int vec) {
  using R = Ring<T, padded_dims<D>()>;
  unsigned char* ks = stage;
  unsigned char* vs = stage + R::TILE * R::ROW;
  if (vec) {
    constexpr int VEC = 16 / sizeof(T);
    static_assert(D % VEC == 0, "a row is whole 16-byte chunks");
    constexpr int CPR = D / VEC;  // 16-byte chunks a row
    for (int c = threadIdx.x; c < n * CPR; c += blockDim.x) {
      const int r = c / CPR, e = (c % CPR) * VEC;
      cp_async16(smem_u32(ks + r * R::ROW + e * sizeof(T)), kb + (t0 + r) * k_s + e);
      cp_async16(smem_u32(vs + r * R::ROW + e * sizeof(T)), vb + (t0 + r) * v_s + e);
    }
  } else {
    for (int c = threadIdx.x; c < n * D; c += blockDim.x) {
      const int r = c / D, d = c % D;
      reinterpret_cast<T*>(ks + r * R::ROW)[d] = kb[(t0 + r) * k_s + d];
      reinterpret_cast<T*>(vs + r * R::ROW)[d] = vb[(t0 + r) * v_s + d];
    }
  }
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

// TQ: q's and the output's type; T: the cache's; D: the stored head dim,
// DP the dims a row holds in shared memory and a partial (D padded).
template <typename TQ, typename T, int D>
__global__ void flash_decode_kernel(const TQ* __restrict__ q, const T* __restrict__ k,
                                    const T* __restrict__ v, const int* __restrict__ pos,
                                    TQ* __restrict__ out, float* __restrict__ part_m,
                                    float* __restrict__ part_l, float* __restrict__ part_acc,
                                    int* __restrict__ counter, int H, int S, int window,
                                    int chunk, int n_split, float scale_log2, Strides st,
                                    int vec) {
  constexpr int DP = padded_dims<D>();
  using R = Ring<T, DP>;
  constexpr int TILE = R::TILE;
  constexpr int LPK = R::LPK;             // lanes a key
  constexpr int DL = DP / LPK;            // dims a lane accumulates
  constexpr int SLOTS = 32 / LPK;         // keys a warp takes at once
  constexpr int KPL = TILE / SLOTS;       // keys a lane, a tile
  constexpr int VEC = 16 / sizeof(T);     // elements a 16-byte chunk
  constexpr int CPL = DL / VEC;           // chunks of a row a lane reads
  constexpr int DPL = DP / 32;            // output dims a lane in the merge
  constexpr int NSTEP = LPK == 1 ? 5 : LPK == 2 ? 4 : 3;  // log2(SLOTS)
  static_assert(DL >> NSTEP == DPL, "the halving leaves DPL values a lane");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  const int G = blockDim.x / 32;
  float* q_s = reinterpret_cast<float*>(smem);  // (G, DP)
  unsigned char* ring = smem + G * DP * sizeof(float);

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, KV = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p = pos[b];
  const int lo = window > 0 ? max(p - window + 1, 0) : 0;
  const int c0 = max(split * chunk, lo);
  const int c1 = min(min(split * chunk + chunk, S), p + 1);  // exclusive
  const int n_t = c1 > c0 ? (c1 - c0 + TILE - 1) / TILE : 0;

  const T* kb = k + b * st.k_b + kvh * st.k_h;
  const T* vb = v + b * st.v_b + kvh * st.v_h;
  if constexpr (DP != D) {
    // the pad dims of every stage's rows: zero, and no copy writes them
    constexpr int PAD = (DP - D) * (int)sizeof(T);
    for (int i = threadIdx.x; i < kStages * 2 * TILE * PAD; i += blockDim.x) {
      const int r = i / PAD;
      ring[r * R::ROW + D * (int)sizeof(T) + i % PAD] = 0;
    }
  }
  // the ring's first stages go out before anything else
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_t)
      issue_tile<T, D>(kb, vb, st.k_s, st.v_s, c0 + i * TILE, min(TILE, c1 - c0 - i * TILE),
                       ring + i * R::STAGE, vec);
    cp_commit();
  }
  for (int i = threadIdx.x; i < G * DP; i += blockDim.x) {
    const int g = i / DP, d = i % DP;
    q_s[i] = d < D ? to_f(q[b * st.q_b + (long long)(kvh * G + g) * st.q_h + d]) : 0.f;
  }
  const int part = lane % LPK, slot = lane / LPK;
  __syncthreads();  // q_s is written (the ring's copies stay in flight)
  float qv[DL];     // this warp's query row over this lane's dims, in registers
#pragma unroll
  for (int c = 0; c < CPL; ++c)
#pragma unroll
    for (int u = 0; u < VEC; ++u) qv[c * VEC + u] = q_s[warp * DP + (c * LPK + part) * VEC + u];

  float m = -INFINITY, l = 0.f;
  float acc[DL];  // this lane's keys' p * V over its DL dims
#pragma unroll
  for (int i = 0; i < DL; ++i) acc[i] = 0.f;

  for (int i = 0; i < n_t; ++i) {
    const int j_next = i + kStages - 1;
    if (j_next < n_t)
      issue_tile<T, D>(kb, vb, st.k_s, st.v_s, c0 + j_next * TILE,
                       min(TILE, c1 - c0 - j_next * TILE), ring + (j_next % kStages) * R::STAGE,
                       vec);
    cp_commit();
    cp_wait<kStages - 1>();  // tile i has landed
    __syncthreads();         // ... for every thread's copies

    const int n = min(TILE, c1 - c0 - i * TILE);
    const unsigned char* ks = ring + (i % kStages) * R::STAGE;
    const unsigned char* vs = ks + TILE * R::ROW;
    // scores: key j = slot + SLOTS * kk, its LPK lanes each dot DL dims
    float s[KPL];
    float tmax = -INFINITY;
#pragma unroll
    for (int kk = 0; kk < KPL; ++kk) {
      const int j = slot + SLOTS * kk;
      float dot0 = 0.f, dot1 = 0.f;  // two chains of FMAs
      if (j < n) {
        const unsigned char* kr = ks + j * R::ROW;
#pragma unroll
        for (int c = 0; c < CPL; c += 2) {
          // this lane's chunks of the row are every LPK-th, from `part`
          dot0 = dot16<T>(kr + (c * LPK + part) * 16, qv + c * VEC, dot0);
          dot1 = dot16<T>(kr + ((c + 1) * LPK + part) * 16, qv + (c + 1) * VEC, dot1);
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
        const unsigned char* vr = vs + j * R::ROW;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const uint4 w = *reinterpret_cast<const uint4*>(vr + (c * LPK + part) * 16);
          const T* x = reinterpret_cast<const T*>(&w);
#pragma unroll
          for (int u = 0; u < VEC; ++u) acc[c * VEC + u] = fmaf(pj[kk], to_f(x[u]), acc[c * VEC + u]);
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

  // this split's partial; rows (b, kvh * G + warp)
  const long long row = (long long)b * H + kvh * G + warp;
  const long long prow = row * n_split + split;
  if (lane == 0) {
    part_m[prow] = m;
    part_l[prow] = l;
  }
  if (n_t > 0) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int x = idx0 + i;  // list index -> dim: chunk x / VEC of this part
      part_acc[prow * DP + ((x / VEC) * LPK + part) * VEC + x % VEC] = acc[i];
    }
  }

  // the last split of this (row, kv head) to finish merges
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int done = atomicAdd(counter + b * KV + kvh, 1);
    is_last = done == n_split - 1;
  }
  __syncthreads();
  if (!is_last) return;
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
    if (DP == D || lane * DPL + dd < D) out[row * D + lane * DPL + dd] = from_f<TQ>(A[dd] * inv);
  if (threadIdx.x == 0) counter[b * KV + kvh] = 0;
}

struct Args {
  const void *q, *k, *v;
  const int* pos;
  void* out;
  float* part;
  int* counter;
  int B, H, KV, S, window, chunk, n_split, vec;
  Strides st;
  cudaStream_t stream;
};

template <typename TQ, typename T, int D>
int launch(const Args& a) {
  constexpr int DP = padded_dims<D>();
  const int G = a.H / a.KV;
  if (a.n_split > kMaxSplits) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)a.B * a.H * a.n_split;
  const size_t smem = (size_t)G * DP * sizeof(float) + Ring<T, DP>::BYTES;
  // the opt-in above 48 KB of shared memory; it is per device, so it is
  // set at every launch (a host-side call of about a microsecond)
  cudaError_t err = cudaFuncSetAttribute(flash_decode_kernel<TQ, T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.n_split, a.KV, a.B);
  flash_decode_kernel<TQ, T, D><<<grid, G * 32, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.pos,
      static_cast<TQ*>(a.out), a.part, a.part + rows, a.part + 2 * rows, a.counter, a.H, a.S,
      a.window, a.chunk, a.n_split, 1.4426950408889634f / sqrtf((float)D), a.st, a.vec);
  return (int)cudaGetLastError();
}

template <typename TQ, typename T>
int launch_d(int D, const Args& a) {
  switch (D) {
    case 32:
      return launch<TQ, T, 32>(a);
    case 64:
      return launch<TQ, T, 64>(a);
    case 112:
      return launch<TQ, T, 112>(a);
    case 128:
      return launch<TQ, T, 128>(a);
    case 256:
      return launch<TQ, T, 256>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the cache in q's type (kv_dtype == dtype) or in fp8 e4m3 (kv_dtype 3)
template <typename TQ>
int launch_kv(int kv_same, int D, const Args& a) {
  return kv_same ? launch_d<TQ, TQ>(D, a) : launch_d<TQ, __nv_fp8_e4m3>(D, a);
}

}  // namespace

// q (B,H,1,D), k and v (B,KV,S,D) given by element strides (D unit-stride),
// pos (B,) int32, out (B,H,1,D) contiguous, part B*H*n_split*(DP+2) fp32
// scratch (DP = 128 for D = 112, else D), counter B*KV int32 that is 0 at
// the launch (and is 0 again when the kernel ends). dtype (q and out):
// 0 = fp32, 1 = bf16, 2 = fp16; kv_dtype (k and v): dtype, or 3 = fp8
// e4m3. The wrapper checks the shapes: H % KV == 0, G = H/KV <= 32 warps,
// G*DP <= 2048 (q in shared memory), D in {32, 64, 112, 128, 256}, and
// chunk a multiple of the tile (2048/DP keys), n_split <= 64. Returns
// cudaGetLastError() after the launch on `stream`.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v, const void* pos,
                                   void* out, void* part, void* counter, int dtype, int kv_dtype,
                                   int B, int H, int KV, int S, int D, int window, int chunk,
                                   int n_split, long long q_sb, long long q_sh, long long k_sb,
                                   long long k_sh, long long k_ss, long long v_sb,
                                   long long v_sh, long long v_ss, int vec, void* stream) {
  const Args a{q, k, v, static_cast<const int*>(pos), out, static_cast<float*>(part),
               static_cast<int*>(counter), B, H, KV, S, window, chunk, n_split, vec,
               Strides{q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss},
               static_cast<cudaStream_t>(stream)};
  if (kv_dtype != dtype && kv_dtype != 3) return (int)cudaErrorInvalidValue;
  const int same = kv_dtype == dtype;
  switch (dtype) {
    case 0:
      return launch_kv<float>(same, D, a);
    case 1:
      return launch_kv<__nv_bfloat16>(same, D, a);
    case 2:
      return launch_kv<__half>(same, D, a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
