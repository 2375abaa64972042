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
// What is left (PERF.md): every one of the G warps converts and multiplies
// the whole tile, ~300 instructions a lane a tile; the G rows of a kv
// head as one tensor-core product, TMA and fp8 caches are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

// A stage holds TILE keys' K rows, then their V rows, in the storage
// type. A key is read by LPK lanes, each taking every LPK-th 16-byte
// chunk of the row (at most 64 dims a lane, so a lane's accumulators fit
// its registers). Rows are padded by 16*LPK bytes, so that the 8 lanes
// of a 16-byte shared-memory phase (8/LPK keys x LPK parts) hit 8
// distinct 16-byte bank groups.
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
// rows, each ROW bytes apart, in the storage type.
template <typename T, int D>
__device__ __forceinline__ void issue_tile(const T* __restrict__ kb, const T* __restrict__ vb,
                                           long long k_s, long long v_s, int t0, int n,
                                           unsigned char* stage, int vec) {
  using R = Ring<T, D>;
  unsigned char* ks = stage;
  unsigned char* vs = stage + R::TILE * R::ROW;
  if (vec) {
    constexpr int VEC = 16 / sizeof(T);
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

template <typename T, int D>
__global__ void flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                    const T* __restrict__ v, const int* __restrict__ pos,
                                    T* __restrict__ out, float* __restrict__ part_m,
                                    float* __restrict__ part_l, float* __restrict__ part_acc,
                                    int* __restrict__ counter, int H, int S, int window,
                                    int chunk, int n_split, float scale_log2, Strides st,
                                    int vec) {
  using R = Ring<T, D>;
  constexpr int TILE = R::TILE;
  constexpr int LPK = R::LPK;             // lanes a key
  constexpr int DL = D / LPK;             // dims a lane accumulates
  constexpr int SLOTS = 32 / LPK;         // keys a warp takes at once
  constexpr int KPL = TILE / SLOTS;       // keys a lane, a tile
  constexpr int VEC = 16 / sizeof(T);     // elements a 16-byte chunk
  constexpr int CPL = DL / VEC;           // chunks of a row a lane reads
  constexpr int DPL = D / 32;             // output dims a lane in the merge
  constexpr int NSTEP = LPK == 1 ? 5 : LPK == 2 ? 4 : 3;  // log2(SLOTS)
  static_assert(DL >> NSTEP == DPL, "the halving leaves DPL values a lane");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  const int G = blockDim.x / 32;
  float* q_s = reinterpret_cast<float*>(smem);  // (G, D)
  unsigned char* ring = smem + G * D * sizeof(float);

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, KV = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p = pos[b];
  const int lo = window > 0 ? max(p - window + 1, 0) : 0;
  const int c0 = max(split * chunk, lo);
  const int c1 = min(min(split * chunk + chunk, S), p + 1);  // exclusive
  const int n_t = c1 > c0 ? (c1 - c0 + TILE - 1) / TILE : 0;

  const T* kb = k + b * st.k_b + kvh * st.k_h;
  const T* vb = v + b * st.v_b + kvh * st.v_h;
  // the ring's first stages go out before anything else
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_t)
      issue_tile<T, D>(kb, vb, st.k_s, st.v_s, c0 + i * TILE, min(TILE, c1 - c0 - i * TILE),
                       ring + i * R::STAGE, vec);
    cp_commit();
  }
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    q_s[i] = to_f(q[b * st.q_b + (long long)(kvh * G + g) * st.q_h + d]);
  }
  const int part = lane % LPK, slot = lane / LPK;
  __syncthreads();  // q_s is written (the ring's copies stay in flight)
  float qv[DL];     // this warp's query row over this lane's dims, in registers
#pragma unroll
  for (int c = 0; c < CPL; ++c)
#pragma unroll
    for (int u = 0; u < VEC; ++u) qv[c * VEC + u] = q_s[warp * D + (c * LPK + part) * VEC + u];

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
      part_acc[prow * D + ((x / VEC) * LPK + part) * VEC + x % VEC] = acc[i];
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
    const float* pa = part_acc + (base + s2) * D + lane * DPL;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) {
      // a split with l = 0 wrote no acc: it is skipped, not read
      const float x = w > 0.f ? __ldcg(pa + dd) : 0.f;
      A[dd] = fmaf(w, x, A[dd]);
    }
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
#pragma unroll
  for (int dd = 0; dd < DPL; ++dd) out[row * D + lane * DPL + dd] = from_f<T>(A[dd] * inv);
  if (threadIdx.x == 0) counter[b * KV + kvh] = 0;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* pos, void* out,
           float* part, int* counter, int B, int H, int KV, int S, int window, int chunk,
           int n_split, const Strides& st, int vec, cudaStream_t stream) {
  const int G = H / KV;
  if (n_split > kMaxSplits) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * H * n_split;
  const size_t smem = (size_t)G * D * sizeof(float) + Ring<T, D>::BYTES;
  // the opt-in above 48 KB of shared memory; it is per device, so it is
  // set at every launch (a host-side call of about a microsecond)
  cudaError_t err = cudaFuncSetAttribute(flash_decode_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_split, KV, B);
  flash_decode_kernel<T, D><<<grid, G * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos,
      static_cast<T*>(out), part, part + rows, part + 2 * rows, counter, H, S, window, chunk,
      n_split, 1.4426950408889634f / sqrtf((float)D), st, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, const int* pos, void* out,
             float* part, int* counter, int B, int H, int KV, int S, int window, int chunk,
             int n_split, const Strides& st, int vec, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, pos, out, part, counter, B, H, KV, S, window, chunk, n_split,
                           st, vec, stream);
    case 64:
      return launch<T, 64>(q, k, v, pos, out, part, counter, B, H, KV, S, window, chunk, n_split,
                           st, vec, stream);
    case 128:
      return launch<T, 128>(q, k, v, pos, out, part, counter, B, H, KV, S, window, chunk,
                            n_split, st, vec, stream);
    case 256:
      return launch<T, 256>(q, k, v, pos, out, part, counter, B, H, KV, S, window, chunk,
                            n_split, st, vec, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,1,D), k and v (B,KV,S,D) given by element strides (D unit-stride),
// pos (B,) int32, out (B,H,1,D) contiguous, part B*H*n_split*(D+2) fp32
// scratch, counter B*KV int32 that is 0 at the launch (and is 0 again when
// the kernel ends). dtype 0 = fp32, 1 = bf16, 2 = fp16, the same for q, k,
// v, out. The wrapper checks the shapes: H % KV == 0, G = H/KV <= 32
// warps, G*D <= 2048 (q in shared memory), D in {32, 64, 128, 256}, and
// chunk a multiple of the tile (2048/D keys), n_split <= 64. Returns cudaGetLastError()
// after the launch on `stream`.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v, const void* pos,
                                   void* out, void* part, void* counter, int dtype, int B, int H,
                                   int KV, int S, int D, int window, int chunk, int n_split,
                                   long long q_sb, long long q_sh, long long k_sb,
                                   long long k_sh, long long k_ss, long long v_sb,
                                   long long v_sh, long long v_ss, int vec, void* stream) {
  const Strides st{q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  const int* p = static_cast<const int*>(pos);
  float* pt = static_cast<float*>(part);
  int* ct = static_cast<int*>(counter);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_d<float>(D, q, k, v, p, out, pt, ct, B, H, KV, S, window, chunk, n_split, st,
                             vec, s);
    case 1:
      return launch_d<__nv_bfloat16>(D, q, k, v, p, out, pt, ct, B, H, KV, S, window, chunk,
                                     n_split, st, vec, s);
    case 2:
      return launch_d<__half>(D, q, k, v, p, out, pt, ct, B, H, KV, S, window, chunk, n_split,
                              st, vec, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
