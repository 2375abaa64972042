// param_stats: per-client (mean, var) of every parameter leaf of a round,
// in one launch.
//
// Replaces the Pallas kernel repro/kernels/param_stats.py
// (param_stats_batched, body _stats_kernel): the paper's §III.B
// distribution summary, fp32 (mean, var) over the trailing axes of a
// client-stacked (N, n) leaf read at its source width: fp32, bf16, fp16,
// fp8 e4m3 or fp8 e5m2, each converted to fp32 as it is loaded (the Pallas
// kernel's astype(float32) a block).
//
// Bound: bytes, far from it. Each element is read once and costs a
// handful of fp32 operations, so the floor is the leaves' bytes over
// 3.35 TB/s: 1.76 MB and 0.53 us for squeezenet-dr's 28 leaves of 14
// clients. Those rows are short (5 to 9,216 elements a client), so what
// bounds a round's call is the launch and one wave of short CTAs. The
// design before this one made two launches a leaf, 56 a round, and spent
// its time in them.
//
// Design. One launch takes up to kMaxLeaves leaves. Their table (data
// pointer, elements a client, dtype, first CTA, slices a client, first
// partial, first counter) travels by value as a __grid_constant__ kernel
// parameter, so nothing is copied to the device before the launch, and a
// captured CUDA graph replays with the pointers it captured. A CTA finds
// its (leaf, client, slice) by a binary search over the table's first
// CTAs; the CTAs run along grid x, so a launch takes any number of clients
// up to 2^31 - 1 CTAs in all. The leaf's type code selects the load; each
// thread reads 16-byte vectors of 4, 8 or 16 values.
//   - A row of at most `chunk` elements (every row of the round) is one
//     CTA. Its 256 threads read the row in 16-byte vectors, four in flight
//     a thread, with scalars at an unaligned head and at the tail. Each
//     thread folds each vector's values into an fp32 (count, mean, M2)
//     triple with Chan's formula; the triples merge across warp shuffles
//     and then across the CTA's warps, and thread 0 writes mean and
//     var = max(M2 / n, 0); n == 0 gives NaN.
//   - A longer row is cut into slices of `chunk` elements, a CTA each.
//     A CTA writes its partial triple, fences, and adds one to the row's
//     counter; the CTA that brings it to the slice count merges the row's
//     partials in slice order, writes the row and sets the counter back to
//     0. The counters belong to the wrapper (one buffer per device and
//     stream, zeroed once), so every launch, graph replays included,
//     finds them at 0.
// Welford/Chan is this kernel's guard against cancellation when
// mean^2 >> var (the TPU kernel shifts by its first block's mean
// instead). Element indices are 64-bit, so rows of 2^31 elements and more
// work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLeaves = 64;
constexpr int kUnroll = 4;  // 16-byte vectors in flight a thread

// One leaf of a launch; the wrapper writes the same 40-byte record
// (kernels/param_stats.py LEAF_RECORD).
struct Leaf {
  const void* x;  // (N, n) row-major
  long long n;    // elements a client
  int cta0;       // first CTA of the leaf
  int slices;     // CTAs a client
  int part0;      // first partial (slices > 1)
  int ctr0;       // first merge counter (slices > 1)
  int dtype;      // 0 float32, 1 bfloat16, 2 float16, 3 fp8 e4m3, 4 fp8 e5m2
  int pad;
};
static_assert(sizeof(Leaf) == 40, "the wrapper's LEAF_RECORD is 40 bytes");

struct Table {
  Leaf leaf[kMaxLeaves];
  int n_leaves;
};
static_assert(sizeof(Table) <= 4000, "the table must fit the 4 KB of kernel parameters");

// Chan et al.'s pairwise merge of two (count, mean, M2) triples into a.
template <typename C>
__device__ __forceinline__ void chan_merge(C& na, float& ma, float& m2a, C nb, float mb,
                                           float m2b) {
  if (nb == 0) return;
  if (na == 0) {
    na = nb;
    ma = mb;
    m2a = m2b;
    return;
  }
  const C n = na + nb;
  const float delta = mb - ma;
  const float fb = __fdividef((float)nb, (float)n);  // n < 2^126: within 2 ulp
  ma = fmaf(delta, fb, ma);
  m2a = m2a + m2b + delta * delta * (float)na * fb;
  na = n;
}

// The V values of one vector as a triple (two passes in registers),
// merged into the thread's.
template <int V>
__device__ __forceinline__ void fold(int& n, float& mean, float& m2, const float (&v)[V]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) s += v[i];
  const float gm = s * (1.f / V);
  float g2 = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) g2 = fmaf(v[i] - gm, v[i] - gm, g2);
  chan_merge(n, mean, m2, V, gm, g2);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e5m2 v) { return static_cast<float>(v); }

// A 16-byte vector as floats: 4 fp32, 8 bf16 or fp16, or 16 fp8 values.
// Every widening to fp32 is exact.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[16 / sizeof(T)]) {
  const T* x = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i) v[i] = to_f32(x[i]);
}

// Fold row[a, e) into this thread's triple: scalars up to the first
// 16-byte boundary, the vectors kUnroll at a time, then the scalars of
// the tail.
template <typename T>
__device__ __forceinline__ void range_stats(const T* __restrict__ row, long long a, long long e,
                                            int& n, float& mean, float& m2) {
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const int mis = (int)((reinterpret_cast<uintptr_t>(row + a) & 15) / sizeof(T));
  const long long head = min((long long)(mis ? V - mis : 0), e - a);
  if (tid < head) chan_merge(n, mean, m2, 1, to_f32(row[a + tid]), 0.f);
  const long long v0 = a + head;
  const long long nv = (e - v0) / V;
  const uint4* vp = reinterpret_cast<const uint4*>(row + v0);
  long long j = tid;
  for (; j + (kUnroll - 1) * kThreads < nv; j += kUnroll * kThreads) {
    uint4 u[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) u[k] = __ldg(vp + j + k * kThreads);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      float v[V];
      unpack<T>(u[k], v);
      fold<V>(n, mean, m2, v);
    }
  }
  for (; j < nv; j += kThreads) {
    float v[V];
    unpack<T>(__ldg(vp + j), v);
    fold<V>(n, mean, m2, v);
  }
  const long long t0 = v0 + nv * V;
  if (tid < e - t0) chan_merge(n, mean, m2, 1, to_f32(row[t0 + tid]), 0.f);
}

template <typename C>
__device__ __forceinline__ void warp_merge(C& n, float& mean, float& m2) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const C nb = __shfl_down_sync(0xffffffffu, n, off);
    const float mb = __shfl_down_sync(0xffffffffu, mean, off);
    const float m2b = __shfl_down_sync(0xffffffffu, m2, off);
    chan_merge(n, mean, m2, nb, mb, m2b);
  }
}

// Merge every thread's triple; thread 0 ends with the CTA's.
template <typename C>
__device__ __forceinline__ void block_merge(C& n, float& mean, float& m2) {
  __shared__ C s_n[kWarps];
  __shared__ float s_mean[kWarps];
  __shared__ float s_m2[kWarps];
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
    n = lane < kWarps ? s_n[lane] : 0;
    mean = lane < kWarps ? s_mean[lane] : 0.f;
    m2 = lane < kWarps ? s_m2[lane] : 0.f;
    warp_merge(n, mean, m2);
  }
}

template <typename C>
__device__ __forceinline__ void write_row(float* o, C n, float mean, float m2) {
  o[0] = n == 0 ? nanf("") : mean;
  o[1] = n == 0 ? nanf("") : fmaxf(m2 / (float)n, 0.f);
}

__global__ void __launch_bounds__(kThreads)
param_stats_kernel(const __grid_constant__ Table table, long long chunk, float* __restrict__ out,
                   long long out_stride, int* __restrict__ part_n, float* __restrict__ part_mean,
                   float* __restrict__ part_m2, int* __restrict__ counter) {
  __shared__ int s_last;
  const int b = blockIdx.x;
  // the leaf: the last whose first CTA is <= b (every leaf has a CTA)
  int lo = 0, hi = table.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table.leaf[mid].cta0 <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  const Leaf& leaf = table.leaf[lo];
  const int local = b - leaf.cta0;
  const int client = local / leaf.slices;
  const int slice = local - client * leaf.slices;
  const long long n = leaf.n;
  const long long a = (long long)slice * chunk;
  const long long e = min(n, a + chunk);

  int cnt = 0;
  float mean = 0.f, m2 = 0.f;
  switch (leaf.dtype) {  // the same on every thread of the CTA
    case 0:
      range_stats(static_cast<const float*>(leaf.x) + client * n, a, e, cnt, mean, m2);
      break;
    case 1:
      range_stats(static_cast<const __nv_bfloat16*>(leaf.x) + client * n, a, e, cnt, mean, m2);
      break;
    case 2:
      range_stats(static_cast<const __half*>(leaf.x) + client * n, a, e, cnt, mean, m2);
      break;
    case 3:
      range_stats(static_cast<const __nv_fp8_e4m3*>(leaf.x) + client * n, a, e, cnt, mean, m2);
      break;
    default:
      range_stats(static_cast<const __nv_fp8_e5m2*>(leaf.x) + client * n, a, e, cnt, mean, m2);
      break;
  }
  block_merge(cnt, mean, m2);
  float* o = out + client * out_stride + 2 * lo;
  if (leaf.slices == 1) {
    if (threadIdx.x == 0) write_row(o, cnt, mean, m2);
    return;
  }

  // a split row: the last of its CTAs to finish merges the partials
  const int p0 = leaf.part0 + client * leaf.slices;
  if (threadIdx.x == 0) {
    part_n[p0 + slice] = cnt;
    part_mean[p0 + slice] = mean;
    part_m2[p0 + slice] = m2;
    __threadfence();
    s_last = atomicAdd(counter + leaf.ctr0 + client, 1) == leaf.slices - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  long long tn = 0;
  float tm = 0.f, tm2 = 0.f;
  for (int s = threadIdx.x; s < leaf.slices; s += kThreads)
    chan_merge(tn, tm, tm2, (long long)__ldcg(part_n + p0 + s), __ldcg(part_mean + p0 + s),
               __ldcg(part_m2 + p0 + s));
  block_merge(tn, tm, tm2);
  if (threadIdx.x == 0) {
    write_row(o, tn, tm, tm2);
    counter[leaf.ctr0 + client] = 0;
  }
}

}  // namespace

// leaves: n_leaves (1..64) Leaf records in host memory, each leaf's CTAs
// following the one before's from CTA 0, n_ctas in all. out: (N, T, 2)
// fp32 seen from this launch's first leaf, `out_stride` floats a client.
// part: n_parts int32 counts, then n_parts fp32 means, then n_parts fp32
// M2 (null when no row splits); counter: int32 per split row, 0 at the
// launch and 0 again when the kernel ends. Returns cudaGetLastError()
// after the launch on `stream`.
extern "C" int param_stats_launch(const void* leaves, int n_leaves, int n_ctas, long long chunk,
                                  void* out, long long out_stride, void* part, long long n_parts,
                                  void* counter, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || n_ctas < 1 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  Table table{};
  const Leaf* src = static_cast<const Leaf*>(leaves);
  for (int i = 0; i < n_leaves; ++i) table.leaf[i] = src[i];
  table.n_leaves = n_leaves;
  int* pn = static_cast<int*>(part);
  float* pm = pn ? reinterpret_cast<float*>(pn + n_parts) : nullptr;
  float* pm2 = pm ? pm + n_parts : nullptr;
  param_stats_kernel<<<(unsigned)n_ctas, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, chunk, static_cast<float*>(out), out_stride, pn, pm, pm2,
      static_cast<int*>(counter));
  return (int)cudaGetLastError();
}
