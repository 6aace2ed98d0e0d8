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
// in q's dtype, with float32 softmax state.  A masked strap (id < 0, or an
// id past the last strap) is never read; a row with nothing selected gives
// zeros; a strap listed twice is attended twice (all three as the TPU
// kernel does).
//
// What bounds it on this card: bytes.  Each valid token brings 4D bytes of
// bf16 K and V for grp * 4D operations (grp = Hq/Hkv query heads): grp = 6
// operations per byte on the Qwen2-1.5B path, far under the ~295 a byte at
// which the bf16 tensor cores become the limit.  So the floor is the
// selected straps' valid K and V over the HBM rate: ~17 MB, ~5 us, per
// exact-mode call of that decode path (B = 8, Hkv = 2, ~2.1 k tokens,
// D = 128).
//
// Design: flash-decoding, two kernels per call (both launched by
// `strap_attend_launch`; the wrapper counts the call once).
//  1. `strap_split_bf16` / `strap_split_f32`: one block of 4 warps per
//     (sequence, kv head, selected-strap slot, chunk of `chunk` tokens of
//     the strap), the wrapper's split plan (kernels/strap_gather.py
//     `split_plan`): 288 blocks in exact mode on the path above, where one
//     block per (sequence, kv head) gave 16.  The block reads its strap id
//     and lengths[b] itself (the TPU kernel's scalar prefetch); a masked
//     slot, or a chunk past the valid tokens, writes an empty partial
//     (m = -inf, l = 0) and reads no page.  The warps take the chunk's
//     tiles in turn (16 tokens in bf16, 8 in float32); each warp keeps a
//     ring of kStages tiles of K and V in shared memory, filled by 16-byte
//     cp.async copies (zero-filled past the valid tokens), so the next
//     tile's bytes are in flight while the current one is computed, and
//     keeps its own online softmax (m, l, acc).  No block barrier runs in
//     the token loop.  The 4 warps' states merge in shared memory at the
//     end (log-sum-exp rule) into one float32 partial (m, l, acc[grp, D])
//     per block, in scratch the wrapper allocates.
//     bf16: tensor cores, mma.sync m16n8k16 (bf16 in, float32 accumulate).
//     Logits: S (16 query-head rows, grp <= 8 of them real, the rest zero)
//     = Q (16 x 16 of D, from registers) . K^T (16 of D x 8 tokens, from
//     ldmatrix).  Query heads sit in the rows (M), not the columns, so that
//     the accumulator layout of that product is the operand layout of the
//     next and p never leaves registers.  p.V: O^T (16 of D x 8 query
//     heads) = V^T (16 of D x 16 tokens, ldmatrix.trans) . p^T (16 tokens
//     x 8 heads).  p is rounded to bf16 for that product (the plain
//     version keeps it in float32): a relative 2^-9 on each weight.
//     float32: the same split, ring and merge, with float32 multiplies and
//     adds on the CUDA cores (TF32 would miss the 3e-5 float32 bar): a
//     quad of lanes per token for the logits, a lane per 4 output columns
//     for p.V.  expf, not __expf, in both.
//  2. `strap_combine_kernel`: one block per (sequence, kv head, query
//     head) merges the split blocks' partials with the log-sum-exp rule and
//     divides by l, giving zeros where l = 0 (the TPU kernel's `safe_l`).
//
// What bounds it now: latency more than bytes.  On the decode path every
// block's K and V are requested at once (two tiles a warp, ~2 blocks an
// SM), so the bytes arrive at about the HBM rate; but each block then runs
// a serial chain around them -- the strap id's load before any page can be
// addressed, two tiles' products and softmax per warp, the merge of the
// warps, the partial's store -- and the combine is a second launch with a
// chain of its own.  On one row (36 blocks) the call takes most of what it
// takes on eight.  A persistent grid that overlaps one block's chain with
// the next one's loads, TMA loads with an mbarrier, and a merge folded
// into the split kernel (with more threads than the one last block per
// (sequence, kv head) of a last-block-done scheme) are what a faster
// version would try.
//
// Build: see kernels/build.py (nvcc -arch sm_90a, -fmad=false).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;          // tiles in flight per warp
constexpr int kMaxGrp = 8;          // query heads per kv head
constexpr int kMaxD = 256;          // head dim
constexpr int kCombineThreads = kMaxD;  // a thread per output column
constexpr unsigned kFull = 0xffffffffu;

using bf16 = __nv_bfloat16;

// tokens per tile, and the shared-memory row: D rounded up to kAlign
// (the mma depth in bf16, a float4 in float32) plus kPad elements, so the
// rows of a tile fall in different banks
template <typename T>
struct TileCfg;
template <>
struct TileCfg<bf16> {
  static constexpr int kTokens = 16, kAlign = 16, kPad = 8;
};
template <>
struct TileCfg<float> {
  static constexpr int kTokens = 8, kAlign = 4, kPad = 4;
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// weight of a state with running max m in a merge whose max is mm; an
// empty state (m = -inf) weighs 0, and so does everything if all are empty
__device__ __forceinline__ float merge_weight(float m, float mm) {
  return mm == -INFINITY ? 0.0f : expf(m - mm);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes = 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b, m16n8k16, bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<const uint32_t*>(&v);
}

struct Split {
  int b, h, slot, n_split;
  int start;    // first flat token of the split
  int n;        // valid tokens in it (0: empty)
};

// the token range of block (split, h, b): the same arithmetic as
// ref.strap_split_ranges
__device__ __forceinline__ Split split_of(const int* ids, const int* lengths,
                                          int n_tok, int n_sel, int blk,
                                          int n_straps, int chunk,
                                          int n_chunks) {
  Split s;
  s.slot = blockIdx.x;
  s.h = blockIdx.y;
  s.b = blockIdx.z;
  s.n_split = n_sel * n_chunks;
  const int sid = ids[s.b * n_sel + s.slot / n_chunks];
  const int c = s.slot % n_chunks;
  const int len = lengths ? lengths[s.b] : n_tok;
  s.start = 0;
  s.n = 0;
  if (sid >= 0 && sid < n_straps) {
    s.start = sid * blk + c * chunk;
    const int stop = min(sid * blk + min((c + 1) * chunk, blk), len);
    s.n = max(0, stop - s.start);
  }
  return s;
}

// K and V rows of tile `tile` into ring stage `st` of this warp: 16-byte
// cp.async copies when `vec`, else element copies; rows past the split's
// valid tokens are zeros
template <typename T>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* kg,
                                          const T* vg, size_t tok_stride,
                                          int tile, int n, int d, int ld,
                                          bool vec, int lane) {
  constexpr int TT = TileCfg<T>::kTokens;
  const int t0 = tile * TT;
  if (vec) {
    const int cpr = d * static_cast<int>(sizeof(T)) / 16;   // chunks a row
    for (int i = lane; i < TT * cpr; i += 32) {
      const int r = i / cpr, cc = i % cpr;
      const bool ok = t0 + r < n;
      const size_t off = static_cast<size_t>(ok ? t0 + r : 0) * tok_stride;
      const int col = cc * (16 / static_cast<int>(sizeof(T)));
      cp_async16(ks + r * ld + col, kg + off + col, ok ? 16 : 0);
      cp_async16(vs + r * ld + col, vg + off + col, ok ? 16 : 0);
    }
  } else {
    for (int i = lane; i < TT * d; i += 32) {
      const int r = i / d, col = i % d;
      const bool ok = t0 + r < n;
      const size_t off = static_cast<size_t>(t0 + r) * tok_stride + col;
      ks[r * ld + col] = ok ? kg[off] : from_f32<T>(0.0f);
      vs[r * ld + col] = ok ? vg[off] : from_f32<T>(0.0f);
    }
  }
}

// merge the warps' states (m_s, l_s, acc_s) into the block's partial: the
// warps' weights exp(m_w - max) once per query head, then a weighted sum
// per output column
__device__ __forceinline__ void write_partial(
    const float (*m_s)[kMaxGrp], const float (*l_s)[kMaxGrp],
    const float* acc_s, float* part_ml, float* part_acc, size_t part,
    int grp, int d) {
  __shared__ float wt_s[kWarps][kMaxGrp];
  if (threadIdx.x < grp) {
    const int hh = threadIdx.x;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, m_s[w][hh]);
    float l = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = merge_weight(m_s[w][hh], mm);
      wt_s[w][hh] = wt;
      l += wt == 0.0f ? 0.0f : wt * l_s[w][hh];
    }
    part_ml[(part * grp + hh) * 2] = mm;
    part_ml[(part * grp + hh) * 2 + 1] = l;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < grp * d; i += kThreads) {
    const int hh = i / d;
    float acc = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = wt_s[w][hh];
      acc += wt == 0.0f ? 0.0f : wt * acc_s[(w * grp + hh) * d + i % d];
    }
    part_acc[part * grp * d + i] = acc;
  }
}

// ---------------------------------------------------------------- bf16 ----
// KD: 16-column steps of D the instantiation holds in registers (D <= 16 KD)
template <int KD>
__global__ void __launch_bounds__(kThreads)
strap_split_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ ids,
                 const int* __restrict__ lengths, float* __restrict__ part_ml,
                 float* __restrict__ part_acc, int n_tok, int hkv, int d,
                 int grp, int n_sel, int blk, int n_straps, int chunk,
                 int n_chunks, float scale, int vec) {
  constexpr int TT = TileCfg<bf16>::kTokens;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float m_s[kWarps][kMaxGrp];
  __shared__ float l_s[kWarps][kMaxGrp];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // Q as the A operand of S = Q . K^T: row g = lane / 4 is query head g
  // (zero past grp), rows 8..15 zero; loaded first, so that its loads
  // overlap those of the strap id and the length
  const int g = lane >> 2, t4 = lane & 3;
  uint32_t qa[KD][2];
  {
    const bf16* qrow = q + (static_cast<size_t>(blockIdx.z) * hkv * grp +
                            static_cast<size_t>(blockIdx.y) * grp + g) * d;
    const bf16 zero = __float2bfloat16_rn(0.0f);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = kk * 16 + half * 8 + 2 * t4;
        const bool ok = g < grp;
        qa[kk][half] = pack_bf16(ok && c < d ? qrow[c] : zero,
                                 ok && c + 1 < d ? qrow[c + 1] : zero);
      }
    }
  }

  const Split sp = split_of(ids, lengths, n_tok, n_sel, blk, n_straps, chunk,
                            n_chunks);
  const size_t part =
      (static_cast<size_t>(sp.b) * hkv + sp.h) * sp.n_split + sp.slot;
  if (sp.n == 0) {                       // masked slot: read no page
    if (tid < grp) {
      part_ml[(part * grp + tid) * 2] = -INFINITY;
      part_ml[(part * grp + tid) * 2 + 1] = 0.0f;
    }
    return;
  }
  const int d16 = (d + 15) / 16 * 16;
  const int nk = d16 / 16;
  const int ld = d16 + TileCfg<bf16>::kPad;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw) +
               static_cast<size_t>(warp) * kStages * 2 * TT * ld;
  const size_t tok_stride = static_cast<size_t>(hkv) * d;
  const size_t base =
      (static_cast<size_t>(sp.b) * n_tok + sp.start) * tok_stride +
      static_cast<size_t>(sp.h) * d;
  const bf16* kg = k + base;
  const bf16* vg = v + base;

  // columns d..d16 of every ring row stay zero (loads never write them)
  if (d16 > d)
    for (int i = lane; i < kStages * 2 * TT * (d16 - d); i += 32) {
      const int row = i / (d16 - d), col = d + i % (d16 - d);
      ring[row * ld + col] = __float2bfloat16_rn(0.0f);
    }

  float acc[KD][4];
#pragma unroll
  for (int mt = 0; mt < KD; ++mt)
    acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.0f;
  float m_run = -INFINITY, l_run = 0.0f;

  const int n_tiles = (sp.n + TT - 1) / TT;
  const int my_tiles =
      n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps : 0;
  __syncwarp();
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (st < my_tiles)
      load_tile(ring + st * 2 * TT * ld, ring + (st * 2 + 1) * TT * ld, kg,
                vg, tok_stride, warp + st * kWarps, sp.n, d, ld, vec, lane);
    cp_async_commit();
  }
  // ldmatrix row addresses of this lane
  const int k_tok = ((lane >> 4) << 3) + (lane & 7);   // K: 2 token octets
  const int k_col = ((lane >> 3) & 1) * 8;
  const int v_tok = (lane & 7) + ((lane >> 4) << 3);   // V^T: 16 tokens
  const int v_col = ((lane >> 3) & 1) * 8;
  for (int j = 0; j < my_tiles; ++j) {
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const int st = j % kStages;
    const bf16* ks = ring + st * 2 * TT * ld;
    const bf16* vs = ks + TT * ld;
    const int t0 = (warp + j * kWarps) * TT;

    // logits: two n-tiles of 8 tokens; c[nt][0..1] = head g, tokens
    // nt*8 + 2*t4 + {0, 1}; even and odd steps of D in two accumulators
    // (two shorter dependent chains of mma), added at the end
    float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float c_odd[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      if (kk < nk) {
        uint32_t b[4];
        ldmatrix_x4(b, ks + k_tok * ld + kk * 16 + k_col);
        float (&cc)[2][4] = kk % 2 ? c_odd : c;
        mma_bf16(cc[0], qa[kk][0], 0u, qa[kk][1], 0u, b[0], b[1]);
        mma_bf16(cc[1], qa[kk][0], 0u, qa[kk][1], 0u, b[2], b[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      c[nt][0] += c_odd[nt][0];
      c[nt][1] += c_odd[nt][1];
    }
    float s[2][2];
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = t0 + nt * 8 + 2 * t4 + e < sp.n;
        s[nt][e] = ok ? c[nt][e] * scale : -INFINITY;
        mx = fmaxf(mx, s[nt][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float m_use = m_new == -INFINITY ? 0.0f : m_new;
    const float alpha = expf(m_run - m_use);
    float p[2][2];
    float psum = 0.0f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[nt][e] = expf(s[nt][e] - m_use);   // exp(-inf) = 0: masked
        psum += p[nt][e];
      }
    l_run = l_run * alpha + psum;
    m_run = m_new;

    // p.V: O^T[d][head] += V^T[d][tok] p^T[tok][head]; this lane's
    // accumulators hold heads 2*t4 and 2*t4 + 1
    const float a_lo = __shfl_sync(kFull, alpha, (2 * t4) * 4);
    const float a_hi = __shfl_sync(kFull, alpha, (2 * t4 + 1) * 4);
    const uint32_t pb0 = pack_bf16(p[0][0], p[0][1]);
    const uint32_t pb1 = pack_bf16(p[1][0], p[1][1]);
#pragma unroll
    for (int mt = 0; mt < KD; ++mt) {
      if (mt < nk) {
        acc[mt][0] *= a_lo;
        acc[mt][1] *= a_hi;
        acc[mt][2] *= a_lo;
        acc[mt][3] *= a_hi;
        uint32_t a[4];
        ldmatrix_x4_trans(a, vs + v_tok * ld + mt * 16 + v_col);
        mma_bf16(acc[mt], a[0], a[1], a[2], a[3], pb0, pb1);
      }
    }
    __syncwarp();
    if (j + kStages < my_tiles)
      load_tile(ring + st * 2 * TT * ld, ring + (st * 2 + 1) * TT * ld, kg,
                vg, tok_stride, warp + (j + kStages) * kWarps, sp.n, d, ld,
                vec, lane);
    cp_async_commit();
  }
  cp_async_wait<0>();
  l_run += __shfl_xor_sync(kFull, l_run, 1);
  l_run += __shfl_xor_sync(kFull, l_run, 2);
  __syncthreads();                       // the ring becomes acc_s

  float* acc_s = reinterpret_cast<float*>(smem_raw);
  if (t4 == 0 && g < grp) {
    m_s[warp][g] = m_run;
    l_s[warp][g] = l_run;
  }
  const int h0 = 2 * t4, h1 = 2 * t4 + 1;
#pragma unroll
  for (int mt = 0; mt < KD; ++mt) {
    if (mt < nk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int dd = mt * 16 + g + half * 8;
        if (dd < d) {
          if (h0 < grp) acc_s[(warp * grp + h0) * d + dd] = acc[mt][2 * half];
          if (h1 < grp)
            acc_s[(warp * grp + h1) * d + dd] = acc[mt][2 * half + 1];
        }
      }
    }
  }
  __syncthreads();
  write_partial(m_s, l_s, acc_s, part_ml, part_acc, part, grp, d);
}

// ------------------------------------------------------------- float32 ----
// KD as above: a lane owns output columns 4*lane + 128*jj, jj < (KD+7)/8
template <int KD>
__global__ void __launch_bounds__(kThreads)
strap_split_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ ids,
                const int* __restrict__ lengths, float* __restrict__ part_ml,
                float* __restrict__ part_acc, int n_tok, int hkv, int d,
                int grp, int n_sel, int blk, int n_straps, int chunk,
                int n_chunks, float scale, int vec) {
  constexpr int TT = TileCfg<float>::kTokens;
  constexpr int J = (KD + 7) / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float m_s[kWarps][kMaxGrp];
  __shared__ float l_s[kWarps][kMaxGrp];
  __shared__ float p_s[kWarps][kMaxGrp][TT];
  const Split sp = split_of(ids, lengths, n_tok, n_sel, blk, n_straps, chunk,
                            n_chunks);
  const size_t part =
      (static_cast<size_t>(sp.b) * hkv + sp.h) * sp.n_split + sp.slot;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (sp.n == 0) {                       // masked slot: read no page
    if (tid < grp) {
      part_ml[(part * grp + tid) * 2] = -INFINITY;
      part_ml[(part * grp + tid) * 2 + 1] = 0.0f;
    }
    return;
  }
  const int d4 = (d + 3) / 4 * 4;
  const int ld = d4 + TileCfg<float>::kPad;
  float* ring_all = reinterpret_cast<float*>(smem_raw);
  float* q_s = ring_all + static_cast<size_t>(kWarps) * kStages * 2 * TT * ld;
  float* ring = ring_all + static_cast<size_t>(warp) * kStages * 2 * TT * ld;
  const size_t tok_stride = static_cast<size_t>(hkv) * d;
  const size_t base =
      (static_cast<size_t>(sp.b) * n_tok + sp.start) * tok_stride +
      static_cast<size_t>(sp.h) * d;
  const float* kg = k + base;
  const float* vg = v + base;

  const float* qg = q + (static_cast<size_t>(sp.b) * hkv * grp +
                         static_cast<size_t>(sp.h) * grp) * d;
  for (int i = tid; i < grp * d4; i += kThreads) {
    const int hh = i / d4, c = i % d4;
    q_s[i] = c < d ? qg[hh * d + c] : 0.0f;
  }
  if (d4 > d)
    for (int i = lane; i < kStages * 2 * TT * (d4 - d); i += 32) {
      const int row = i / (d4 - d), col = d + i % (d4 - d);
      ring[row * ld + col] = 0.0f;
    }
  __syncthreads();

  float m_run[kMaxGrp], l_run[kMaxGrp];
  float4 acc[kMaxGrp][J];
#pragma unroll
  for (int hh = 0; hh < kMaxGrp; ++hh) {
    m_run[hh] = -INFINITY;
    l_run[hh] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) acc[hh][jj] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int n_tiles = (sp.n + TT - 1) / TT;
  const int my_tiles =
      n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps : 0;
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (st < my_tiles)
      load_tile(ring + st * 2 * TT * ld, ring + (st * 2 + 1) * TT * ld, kg,
                vg, tok_stride, warp + st * kWarps, sp.n, d, ld, vec, lane);
    cp_async_commit();
  }
  const int g = lane >> 2, r = lane & 3;   // logits: token g, quarter r
  for (int j = 0; j < my_tiles; ++j) {
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const int st = j % kStages;
    const float* ks = ring + st * 2 * TT * ld;
    const float* vs = ks + TT * ld;
    const int t0 = (warp + j * kWarps) * TT;

    float dot[kMaxGrp];
#pragma unroll
    for (int hh = 0; hh < kMaxGrp; ++hh) dot[hh] = 0.0f;
    for (int c = 4 * r; c < d4; c += 16) {
      const float4 kv = *reinterpret_cast<const float4*>(ks + g * ld + c);
#pragma unroll
      for (int hh = 0; hh < kMaxGrp; ++hh) {
        if (hh < grp) {
          const float4 qv = *reinterpret_cast<const float4*>(q_s + hh * d4 + c);
          dot[hh] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
        }
      }
    }
    const bool ok = t0 + g < sp.n;
    float alpha[kMaxGrp];
#pragma unroll
    for (int hh = 0; hh < kMaxGrp; ++hh) {
      alpha[hh] = 1.0f;
      if (hh < grp) {
        float x = dot[hh];
        x += __shfl_xor_sync(kFull, x, 1);
        x += __shfl_xor_sync(kFull, x, 2);
        const float s = ok ? x * scale : -INFINITY;
        float mx = s;
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 16));
        const float m_new = fmaxf(m_run[hh], mx);
        const float m_use = m_new == -INFINITY ? 0.0f : m_new;
        alpha[hh] = expf(m_run[hh] - m_use);
        m_run[hh] = m_new;
        if (r == 0) p_s[warp][hh][g] = expf(s - m_use);
      }
    }
    __syncwarp();
#pragma unroll
    for (int hh = 0; hh < kMaxGrp; ++hh) {
      if (hh < grp) {
        float psum = 0.0f;
#pragma unroll
        for (int t = 0; t < TT; ++t) psum += p_s[warp][hh][t];
        l_run[hh] = l_run[hh] * alpha[hh] + psum;
      }
    }
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      const int c = 4 * lane + 128 * jj;
      if (c < d4) {
#pragma unroll
        for (int hh = 0; hh < kMaxGrp; ++hh) {
          if (hh < grp) {
            float4& a = acc[hh][jj];
            a.x *= alpha[hh];
            a.y *= alpha[hh];
            a.z *= alpha[hh];
            a.w *= alpha[hh];
          }
        }
#pragma unroll
        for (int t = 0; t < TT; ++t) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + t * ld + c);
#pragma unroll
          for (int hh = 0; hh < kMaxGrp; ++hh) {
            if (hh < grp) {
              const float pp = p_s[warp][hh][t];
              float4& a = acc[hh][jj];
              a.x += pp * vv.x;
              a.y += pp * vv.y;
              a.z += pp * vv.z;
              a.w += pp * vv.w;
            }
          }
        }
      }
    }
    __syncwarp();
    if (j + kStages < my_tiles)
      load_tile(ring + st * 2 * TT * ld, ring + (st * 2 + 1) * TT * ld, kg,
                vg, tok_stride, warp + (j + kStages) * kWarps, sp.n, d, ld,
                vec, lane);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();                       // the ring becomes acc_s

  float* acc_s = ring_all;
  if (lane == 0)
#pragma unroll
    for (int hh = 0; hh < kMaxGrp; ++hh)
      if (hh < grp) {
        m_s[warp][hh] = m_run[hh];
        l_s[warp][hh] = l_run[hh];
      }
#pragma unroll
  for (int jj = 0; jj < J; ++jj) {
    const int c = 4 * lane + 128 * jj;
#pragma unroll
    for (int hh = 0; hh < kMaxGrp; ++hh) {
      if (hh < grp) {
        const float vals[4] = {acc[hh][jj].x, acc[hh][jj].y, acc[hh][jj].z,
                               acc[hh][jj].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < d) acc_s[(warp * grp + hh) * d + c + e] = vals[e];
      }
    }
  }
  __syncthreads();
  write_partial(m_s, l_s, acc_s, part_ml, part_acc, part, grp, d);
}

// ------------------------------------------------------------- combine ----
// One block per (sequence, kv head, query head), a thread per output
// column.  The first warp takes the splits' running maxima, each split's
// weight exp(m_s - max) (into w_s) and the weighted sum of l, lanes over
// splits; then every column sums its splits' weighted accumulators, their
// loads issued without waiting on one another.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
strap_combine_kernel(const float* __restrict__ part_ml,
                     const float* __restrict__ part_acc, T* __restrict__ out,
                     int hkv, int d, int grp, int n_split) {
  extern __shared__ float w_s[];         // n_split weights
  __shared__ float l_s;
  const int hh = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t base = (static_cast<size_t>(b) * hkv + h) * n_split;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float mm = -INFINITY;
    for (int s = lane; s < n_split; s += 32)
      mm = fmaxf(mm, part_ml[((base + s) * grp + hh) * 2]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mm = fmaxf(mm, __shfl_xor_sync(kFull, mm, off));
    float l = 0.0f;
    for (int s = lane; s < n_split; s += 32) {
      const size_t ps = (base + s) * grp + hh;
      const float wt = merge_weight(part_ml[ps * 2], mm);
      w_s[s] = wt;
      l += wt == 0.0f ? 0.0f : wt * part_ml[ps * 2 + 1];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(kFull, l, off);
    if (lane == 0) l_s = l;
  }
  __syncthreads();
  const int dd = threadIdx.x;
  if (dd >= d) return;
  float acc = 0.0f;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) {
    // an empty partial's acc is never written: select, do not multiply
    const float a = part_acc[((base + s) * grp + hh) * d + dd];
    const float wt = w_s[s];
    acc += wt == 0.0f ? 0.0f : wt * a;
  }
  const float l = l_s;
  out[(static_cast<size_t>(b) * hkv * grp + static_cast<size_t>(h) * grp +
       hh) * d + dd] = from_f32<T>(acc / (l > 0.0f ? l : 1.0f));
}

template <typename T>
size_t split_smem_bytes(int d, int grp) {
  constexpr int TT = TileCfg<T>::kTokens;
  const int dp = (d + TileCfg<T>::kAlign - 1) / TileCfg<T>::kAlign *
                 TileCfg<T>::kAlign;
  const size_t ring = sizeof(T) * static_cast<size_t>(kWarps) * kStages * 2 *
                      TT * (dp + TileCfg<T>::kPad);
  const size_t merge = sizeof(float) * static_cast<size_t>(kWarps) * grp * d;
  const size_t q = sizeof(T) == 4 ? sizeof(float) * grp * dp : 0;
  return (ring > merge ? ring : merge) + q;
}

// Dynamic shared memory above 48 KB must be allowed per kernel and device;
// `allowed` remembers, per device, the most this kernel was allowed.
constexpr int kMaxDevices = 64;

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes, size_t (&allowed)[kMaxDevices]) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && allowed[dev] >= bytes) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = bytes;
  return static_cast<int>(err);
}

template <typename T, int KD>
int launch_split(const void* q, const void* k, const void* v, const int* ids,
                 const int* lengths, float* part_ml, float* part_acc, int b,
                 int n_tok, int hkv, int d, int grp, int n_sel, int blk,
                 int n_straps, int chunk, int n_chunks, float scale, int vec,
                 cudaStream_t stream) {
  static size_t allowed[kMaxDevices] = {};
  const size_t smem = split_smem_bytes<T>(d, grp);
  const dim3 grid(n_sel * n_chunks, hkv, b);
  if constexpr (sizeof(T) == 2) {
    const int err = set_smem(strap_split_bf16<KD>, smem, allowed);
    if (err) return err;
    strap_split_bf16<KD><<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), ids, lengths, part_ml, part_acc, n_tok,
        hkv, d, grp, n_sel, blk, n_straps, chunk, n_chunks, scale, vec);
  } else {
    const int err = set_smem(strap_split_f32<KD>, smem, allowed);
    if (err) return err;
    strap_split_f32<KD><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), ids, lengths, part_ml, part_acc, n_tok,
        hkv, d, grp, n_sel, blk, n_straps, chunk, n_chunks, scale, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* ids,
           const int* lengths, void* out, float* part_ml, float* part_acc,
           int b, int n_tok, int hkv, int d, int grp, int n_sel, int blk,
           int n_straps, int chunk, float scale, int vec,
           cudaStream_t stream) {
  const int n_chunks = (blk + chunk - 1) / chunk;
  if (n_sel > 0) {
    const int steps = (d + 15) / 16;
    int err;
    if (steps <= 4)
      err = launch_split<T, 4>(q, k, v, ids, lengths, part_ml, part_acc, b,
                               n_tok, hkv, d, grp, n_sel, blk, n_straps,
                               chunk, n_chunks, scale, vec, stream);
    else if (steps <= 8)
      err = launch_split<T, 8>(q, k, v, ids, lengths, part_ml, part_acc, b,
                               n_tok, hkv, d, grp, n_sel, blk, n_straps,
                               chunk, n_chunks, scale, vec, stream);
    else
      err = launch_split<T, 16>(q, k, v, ids, lengths, part_ml, part_acc, b,
                                n_tok, hkv, d, grp, n_sel, blk, n_straps,
                                chunk, n_chunks, scale, vec, stream);
    if (err) return err;
  }
  const int n_split = n_sel * n_chunks;
  static size_t allowed[kMaxDevices] = {};
  const size_t smem = sizeof(float) * static_cast<size_t>(n_split);
  const int err = set_smem(strap_combine_kernel<T>, smem, allowed);
  if (err) return err;
  const int threads = (d + 31) / 32 * 32;
  strap_combine_kernel<T><<<dim3(grp, hkv, b), threads, smem, stream>>>(
      part_ml, part_acc, static_cast<T*>(out), hkv, d, grp, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  q/out (B, Hq, D), k/v
// (B, P, page, Hkv, D), strap_ids (B, S) int32, lengths (B,) int32 or null
// (every token valid); part_ml (B, Hkv, S * n_chunks, grp, 2) and part_acc
// (B, Hkv, S * n_chunks, grp, D) float32 scratch, n_chunks =
// ceil(pages_per_strap * page / chunk); dtype 0 = float32, 1 = bfloat16;
// vec = 1 when K and V rows may be copied 16 bytes at a time (D * itemsize
// a multiple of 16, both base pointers 16-byte aligned).  Launches the
// split kernel and the combine kernel on `stream` and returns
// cudaGetLastError() (0 = launched); cudaErrorInvalidValue for a shape the
// kernels do not take.
extern "C" int strap_attend_launch(const void* q, const void* k_pages,
                                   const void* v_pages, const int* strap_ids,
                                   const int* lengths, void* out,
                                   float* part_ml, float* part_acc, int b,
                                   int n_pages, int page, int hkv, int d,
                                   int hq, int n_sel, int pages_per_strap,
                                   int chunk, float scale, int dtype, int vec,
                                   void* stream) {
  if (b <= 0 || hkv <= 0) return 0;
  if (d <= 0 || d > kMaxD || hq % hkv != 0 || hq / hkv > kMaxGrp ||
      pages_per_strap <= 0 || n_pages % pages_per_strap != 0 || n_sel < 0 ||
      chunk <= 0 || b > 65535 || hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grp = hq / hkv;
  const int blk = pages_per_strap * page;
  const int n_straps = n_pages / pages_per_strap;
  const int n_tok = n_pages * page;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, strap_ids, lengths, out,
                         part_ml, part_acc, b, n_tok, hkv, d, grp, n_sel, blk,
                         n_straps, chunk, scale, vec, s);
  if (dtype == 1)
    return launch<bf16>(q, k_pages, v_pages, strap_ids, lengths, out,
                        part_ml, part_acc, b, n_tok, hkv, d, grp, n_sel, blk,
                        n_straps, chunk, scale, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
