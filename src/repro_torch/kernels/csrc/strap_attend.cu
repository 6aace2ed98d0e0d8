// Selector+strap gated decode attention over a paged KV cache, for Hopper
// (sm_90a): the attention of the strap-cache LM server's decode step.
//
// Replaces the TPU kernel `strap_attend_pallas` (body `_strap_kernel`) in
// src/repro/kernels/strap_gather.py:101, and computes what the plain version
// `repro_torch.kernels.ref.strap_attend_ref` computes: for each sequence b
// and kv head h, one query token per query head of h's group attends the
// tokens of the selected straps (strap s = tokens [s*G*page, (s+1)*G*page)
// of the paged cache) that lie below lengths[b]:
//   out (B, Hq, D) = softmax(q . K^T * scale) . V   over those tokens,
// in q's dtype, accumulated in float32.  A masked strap (id < 0, or an id
// past the last strap) is skipped and its pages are never read; a row with
// nothing selected gives zeros; a strap listed twice is attended twice (all
// three as the TPU kernel does).
//
// What bounds it on this card: bytes.  Each valid token brings 4D bytes of
// bf16 K and V for grp * 4D operations (grp = Hq/Hkv query heads, each a
// multiply-add against K and one against V): grp = 6 operations per byte on
// the Qwen2-1.5B path, under the card's ~20 (float32) or ~295 (bf16 tensor
// cores) per byte.  So the floor is the selected straps' valid K and V over
// the HBM rate: ~17 MB, ~5 us, per exact-mode call of that decode path
// (B = 8, Hkv = 2, ~2.1 k tokens, D = 128).
//
// Design.  The Pallas kernel's grid was (B, Hkv, S) with the strap axis S
// sequential, carrying the online-softmax state (m, l, acc) in VMEM; its
// scalar prefetch fed strap ids to the BlockSpec index map, so the gather was
// the DMA's address.  Here one block of 256 threads owns one (b, kv head) and
// loops over the S selected straps itself, reading strap_ids[b, :] and
// lengths[b] directly; the grp query heads sit in shared memory as float.
// Each strap's valid tokens (a prefix of the strap: positions are contiguous)
// go through in tiles of 128 tokens:
//   1. logits: a warp per token, lanes over D (coalesced row reads of K),
//      grp dot products reduced by warp shuffles, into shared memory;
//   2. online softmax: a warp per query head updates m and l and turns the
//      tile's logits into probabilities (expf, not __expf);
//   3. p.V: the block splits into 256 / D groups of D threads, a thread per
//      output column; each group takes every (256/D)-th token of the tile
//      (coalesced row reads of V) and keeps grp accumulators in registers,
//      rescaled by exp(m_old - m_new) once per tile.
// The groups' accumulators are summed through shared memory at the end and
// divided by l (zeros where l = 0).
//
// Left for later: on the decode path there are only B * Hkv = 16 blocks for
// 132 SMs, so most of the card idles; splitting the strap axis over blocks
// (a flash-decoding combine), cp.async/TMA double buffering of the K/V tiles
// and tensor-core (mma) dot products are what a faster version would add.
//
// Build: see kernels/build.py (nvcc -arch sm_90a, -fmad=false).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;      // tokens per online-softmax step
constexpr int kMaxGrp = 8;      // query heads per kv head
constexpr int kMaxD = 256;      // head dim
constexpr int kLaneCols = kMaxD / 32;
constexpr float kNegInf = -1e30f;   // the TPU kernel's initial running max

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
strap_attend_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ strap_ids,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int n_tok, int hkv, int d, int grp, int n_sel, int blk,
                    int n_straps, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                    // grp x d     queries
  float* p_s = q_s + grp * d;           // grp x kTile logits, then p
  float* m_s = p_s + grp * kTile;       // grp         running max
  float* l_s = m_s + grp;               // grp         running sum of p
  float* a_s = l_s + grp;               // grp         this tile's rescale
  float* red_s = a_s + grp;             // kThreads x grp group accumulators

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int hq = hkv * grp;
  const size_t q_off = (static_cast<size_t>(b) * hq + h * grp) * d;

  for (int i = tid; i < grp * d; i += kThreads) q_s[i] = to_f32(q[q_off + i]);
  if (tid < grp) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.0f;
  }

  // p.V layout: n_groups groups of d threads, a thread per output column
  const int n_groups = kThreads / d;
  const int group = tid / d;
  const int col = tid % d;
  const bool pv_thread = group < n_groups;
  float acc[kMaxGrp];
#pragma unroll
  for (int g = 0; g < kMaxGrp; ++g) acc[g] = 0.0f;

  const int len = lengths ? lengths[b] : n_tok;
  const size_t tok_stride = static_cast<size_t>(hkv) * d;
  const T* k_bh = k + static_cast<size_t>(b) * n_tok * tok_stride + h * d;
  const T* v_bh = v + static_cast<size_t>(b) * n_tok * tok_stride + h * d;
  __syncthreads();

  for (int s = 0; s < n_sel; ++s) {
    const int sid = strap_ids[b * n_sel + s];
    if (sid < 0 || sid >= n_straps) continue;       // masked: never read
    const int start = sid * blk;
    const int n_valid = min(blk, len - start);       // valid tokens: a prefix
    for (int t0 = 0; t0 < n_valid; t0 += kTile) {
      const int nt = min(kTile, n_valid - t0);
      const size_t tile_off = static_cast<size_t>(start + t0) * tok_stride;

      // 1. logits of the tile: a warp per token, lanes over D
      for (int t = warp; t < nt; t += kWarps) {
        const T* krow = k_bh + tile_off + t * tok_stride;
        float dot[kMaxGrp];
#pragma unroll
        for (int g = 0; g < kMaxGrp; ++g) dot[g] = 0.0f;
#pragma unroll
        for (int j = 0; j < kLaneCols; ++j) {
          const int c = lane + 32 * j;
          if (c < d) {
            const float kc = to_f32(krow[c]);
#pragma unroll
            for (int g = 0; g < kMaxGrp; ++g)
              if (g < grp) dot[g] += q_s[g * d + c] * kc;
          }
        }
#pragma unroll
        for (int g = 0; g < kMaxGrp; ++g) {
          if (g < grp) {
            const float total = warp_sum(dot[g]);
            if (lane == 0) p_s[g * kTile + t] = total * scale;
          }
        }
      }
      __syncthreads();

      // 2. online softmax: a warp per query head
      for (int g = warp; g < grp; g += kWarps) {
        float* row = p_s + g * kTile;
        float mx = kNegInf;
        for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, row[t]);
        mx = warp_max(mx);
        const float m_prev = m_s[g];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.0f;
        for (int t = lane; t < nt; t += 32) {
          const float e = expf(row[t] - m_new);
          row[t] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          a_s[g] = alpha;
          l_s[g] = alpha * l_s[g] + sum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();

      // 3. p.V: a group of d threads per token stride, a thread per column
      if (pv_thread) {
#pragma unroll
        for (int g = 0; g < kMaxGrp; ++g)
          if (g < grp) acc[g] *= a_s[g];
        const T* vcol = v_bh + tile_off + col;
        for (int t = group; t < nt; t += n_groups) {
          const float vv = to_f32(vcol[t * tok_stride]);
#pragma unroll
          for (int g = 0; g < kMaxGrp; ++g)
            if (g < grp) acc[g] += p_s[g * kTile + t] * vv;
        }
      }
      __syncthreads();
    }
  }

  // combine the groups' accumulators (group order), normalise, store
  if (pv_thread) {
#pragma unroll
    for (int g = 0; g < kMaxGrp; ++g)
      if (g < grp) red_s[(group * grp + g) * d + col] = acc[g];
  }
  __syncthreads();
  for (int i = tid; i < grp * d; i += kThreads) {
    const int g = i / d;
    float o = 0.0f;
    for (int r = 0; r < n_groups; ++r) o += red_s[r * grp * d + i];
    const float l = l_s[g];
    out[q_off + i] = from_f32<T>(o / (l > 0.0f ? l : 1.0f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* ids,
           const int* lengths, void* out, int b, int n_tok, int hkv, int d,
           int grp, int n_sel, int blk, int n_straps, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) *
                      (static_cast<size_t>(grp) * (d + kTile + 3 + kThreads));
  const dim3 grid(hkv, b);
  strap_attend_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ids, lengths, static_cast<T*>(out), n_tok,
      hkv, d, grp, n_sel, blk, n_straps, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  q/out (B, Hq, D), k/v
// (B, P, page, Hkv, D), strap_ids (B, S) int32, lengths (B,) int32 or null
// (every token valid); dtype 0 = float32, 1 = bfloat16.  Launches on
// `stream` and returns cudaGetLastError() (0 = launched);
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int strap_attend_launch(const void* q, const void* k_pages,
                                   const void* v_pages, const int* strap_ids,
                                   const int* lengths, void* out, int b,
                                   int n_pages, int page, int hkv, int d,
                                   int hq, int n_sel, int pages_per_strap,
                                   float scale, int dtype, void* stream) {
  if (b <= 0 || hkv <= 0) return 0;
  if (d <= 0 || d > kMaxD || hq % hkv != 0 || hq / hkv > kMaxGrp ||
      pages_per_strap <= 0 || n_pages % pages_per_strap != 0 || n_sel < 0 ||
      b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grp = hq / hkv;
  const int blk = pages_per_strap * page;
  const int n_straps = n_pages / pages_per_strap;
  const int n_tok = n_pages * page;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, strap_ids, lengths, out, b,
                         n_tok, hkv, d, grp, n_sel, blk, n_straps, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, strap_ids, lengths, out,
                                 b, n_tok, hkv, d, grp, n_sel, blk, n_straps,
                                 scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
