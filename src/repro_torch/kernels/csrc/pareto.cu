// Pareto dominance for Hopper (sm_90a): which target rows some dominator
// row dominates.
//
// Replaces no TPU kernel: the reference's `pareto_mask`
// (src/repro/core/dse.py) is plain jnp, a masked broadcast of every
// dominator block against the whole batch.  The port's copy of that
// broadcast (`repro_torch.kernels.ref.pareto_dominated_ref`) held 98.8% of
// the benchmark's `select` iteration on the card (7.0 s for 299,008 rows:
// 8.9e10 tests through (4096, 299008, K) boolean temporaries), so the
// dominance test has a kernel of its own.  It computes what the plain
// version computes, bit for bit, on rows the wrapper (`kernels/pareto.py`)
// has compacted and packed:
//   * only candidate rows whose objectives are all non-NaN, on each side
//     (any other row neither dominates nor is dominated);
//   * each row K4 float4s (K <= 4 * K4), the minimized columns negated (an
//     exact sign flip) and the spare columns 0 on both sides (0 >= 0 holds
//     and 0 > 0 does not, so they decide nothing);
//   * dominator a dominates target b  <=>  all(a >= b) && any(a > b).
// flags[t] is set to 1 where some dominator dominates target t.  The
// kernel only ever stores the constant 1, never a value that depends on
// which block got there first, so the flags are exact and the same on
// every run.
//
// What bounds it on this card.  Its bytes are a few per row (19 B a row of
// the batch, ~1.7 us at 299,008 rows and 3.35 TB/s); its work is the
// dominance tests, ~10 instructions a pair, and all pairs would be
// N_t * N_d (7.3e9 among the grid's candidates, ~2.4 ms of issue on 132
// SMs).  The design cuts the pairs rather than their cost:
//
//  * Early exit.  One thread owns one target, its K objectives in
//    registers, and stops testing once it is dominated; a warp leaves the
//    loop once `__all_sync` says all 32 of its targets are.  Most rows of a
//    sweep meet a dominator within the first few hundred.
//  * A filter pass, then the survivors (the wrapper): every target against
//    the first `chunk` dominators, then only the compacted survivors
//    against the rest.  A warp of survivors is a warp of 32 rows that each
//    still need the long scan, rather than one such row among 31 finished
//    ones.
//  * The rest split over blocks.  Block (x, y) tests targets
//    [128x, 128x + 128) against dominators [y * chunk, (y + 1) * chunk), so
//    a front row's full scan runs on many SMs at once; a block first reads
//    the flags, and a target another block has already found dominated
//    starts done.
//  * Dominators staged a tile at a time, per warp: each lane loads one
//    dominator of the next 32 (coalesced float4 loads, into registers while
//    the current tile is tested), the warp stores the tile into its own
//    double-buffered slice of shared memory, and every lane then reads each
//    dominator with one broadcast 16-byte load.  No block barrier, so a
//    warp that is done leaves without waiting for the others.
//
// Numerics: comparisons only; no rounding anywhere.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;          // targets a block: four warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;              // dominators a warp stages: one a lane
constexpr unsigned kFull = 0xffffffffu;

template <int K4>
__device__ __forceinline__ bool dominates(const float4* b, const float4* a) {
  bool ge = true, gt = false;
#pragma unroll
  for (int k = 0; k < K4; ++k) {
    ge = ge & (b[k].x >= a[k].x) & (b[k].y >= a[k].y) & (b[k].z >= a[k].z) &
         (b[k].w >= a[k].w);
    gt = gt | (b[k].x > a[k].x) | (b[k].y > a[k].y) | (b[k].z > a[k].z) |
         (b[k].w > a[k].w);
  }
  return ge & gt;
}

// Dominator row `row` of [0, end), or NaN (which dominates nothing) past it.
template <int K4>
__device__ __forceinline__ void load_row(float4* r, const float4* dom, int row,
                                         int end) {
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int k = 0; k < K4; ++k)
    r[k] = row < end ? __ldg(dom + static_cast<size_t>(row) * K4 + k)
                     : make_float4(nan, nan, nan, nan);
}

template <int K4>
__global__ void __launch_bounds__(kThreads)
pareto_kernel(const float4* __restrict__ tgt, int n_t,
              const float4* __restrict__ dom, int n_d, int chunk,
              unsigned char* flags) {
  __shared__ float4 tile[2][kWarps][kTile][K4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int d0 = blockIdx.y * chunk;
  const int d1 = min(d0 + chunk, n_d);
  const bool live = t < n_t;
  // set by a block of another dominator chunk that has already run
  const bool known =
      live && *reinterpret_cast<volatile const unsigned char*>(flags + t);
  bool done = !live || known;
  float4 a[K4];
#pragma unroll
  for (int k = 0; k < K4; ++k)
    a[k] = live ? tgt[static_cast<size_t>(t) * K4 + k]
                : make_float4(0.f, 0.f, 0.f, 0.f);

  float4 r[K4];
  load_row<K4>(r, dom, d0 + lane, d1);
#pragma unroll
  for (int k = 0; k < K4; ++k) tile[0][warp][lane][k] = r[k];
  __syncwarp();
  int buf = 0;
  for (int j = d0; j < d1; j += kTile) {
    if (__all_sync(kFull, done)) break;
    const bool more = j + kTile < d1;                 // uniform in the warp
    if (more) load_row<K4>(r, dom, j + kTile + lane, d1);
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
      float4 b[K4];
#pragma unroll
      for (int k = 0; k < K4; ++k) b[k] = tile[buf][warp][u][k];
      done = done | dominates<K4>(b, a);
    }
    if (more) {
#pragma unroll
      for (int k = 0; k < K4; ++k) tile[buf ^ 1][warp][lane][k] = r[k];
    }
    __syncwarp();
    buf ^= 1;
  }
  if (live && done && !known) flags[t] = 1;
}

}  // namespace

// Plain C entry point (bound with ctypes).  tgt (n_t, 4 * k4) and dom
// (n_d, 4 * k4) float32, 16-byte aligned; flags (n_t,) uint8, set to 1
// where a dominator dominates (never cleared).  Dominators run in blocks of
// `chunk` rows.  Launches on `stream` and returns cudaGetLastError() (0 =
// launched); cudaErrorInvalidValue for a k4 other than 1 or 2 or a grid
// the card cannot launch.
extern "C" int pareto_dominated_launch(const float* tgt, int n_t,
                                       const float* dom, int n_d, int k4,
                                       int chunk, unsigned char* flags,
                                       void* stream) {
  if (n_t <= 0 || n_d <= 0) return 0;
  if (chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = (static_cast<long long>(n_d) + chunk - 1) / chunk;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_t + kThreads - 1) / kThreads,
                  static_cast<unsigned>(chunks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* t4 = reinterpret_cast<const float4*>(tgt);
  const float4* d4 = reinterpret_cast<const float4*>(dom);
  switch (k4) {
    case 1:
      pareto_kernel<1><<<grid, kThreads, 0, s>>>(t4, n_t, d4, n_d, chunk,
                                                 flags);
      break;
    case 2:
      pareto_kernel<2><<<grid, kThreads, 0, s>>>(t4, n_t, d4, n_d, chunk,
                                                 flags);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
