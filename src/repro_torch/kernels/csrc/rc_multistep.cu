// Multi-step implicit-Euler transient of a batched RC ladder for Hopper
// (sm_90a): the inner loop of the phased row-cycle engine (Fig. 8 waveforms).
//
// Replaces the TPU kernel `rc_multistep_pallas` (body `_rc_kernel`) in
// src/repro/kernels/rc_transient.py:75, and computes what the plain version
// `repro_torch.kernels.ref.rc_multistep_ref` computes, bit for bit: per
// design row, T implicit-Euler steps of an N-node ladder whose last (access)
// branch is scaled by ramp[t] and whose nodes are pulled toward v_clamp
// through g_clamp, writing every step's node voltages:
//   trace (T, B, N),  trace[t, b, :] = state after step t.
//
// What bounds it on this card.  Its bytes (the operands once, T*N floats of
// trace a row) take ~6 us at B = 1024, N = 6, T = 800; but each step of a row
// is one serial chain (the Thomas solve's forward sweep, then the
// back-substitution, whose last value feeds the next step), so a call takes
// T times that chain's latency however many rows run beside it.  The design
// shortens the chain and keeps everything else off it:
//
//  * Step invariants once a launch.  Inside a launch only ramp[t] changes, so
//    the diagonal, the denominators and cp of rows 0..N-3 are fixed; they are
//    computed once, with the operations in the order `ref.tridiag_solve_ref`
//    uses every step, so each is the plain version's value bit for bit.
//  * Quotients from a reciprocal, exactly.  Each step divides the forward
//    sweep's numerator a by a denominator b.  With y = RN(1/b), the chain
//    computes
//        q0 = RN(a*y);  r = fma(-q0, b, a);  q = fma(r, y, q0)
//    (a multiply and two fused multiply-adds in place of a division).
//    Markstein's theorem (Markstein 1990; Muller et al., Handbook of
//    Floating-Point Arithmetic, "Newton-Raphson-based division with an FMA"):
//    in binary floating point with round-to-nearest, if y is within half an
//    ulp of 1/b and q0 within one ulp of a/b, then r = a - q0*b is exactly
//    representable (so the fma returns it exactly) and RN(q0 + r*y) = RN(a/b).
//    q0 = RN(a*y) is within one ulp of a/b when a/b's significand is at least
//    b's; otherwise it is within 1.5 ulp, the value q0 + r*y that the last fma
//    rounds is then within 3*2^-24 ulp of a/b, and only a quotient that close
//    to a rounding midpoint could round the other way: there are 1.19e8 such
//    binary32 significand pairs (|a*2^25 - m*b| <= 16 for a midpoint m), and
//    `kernels/quotient_check.py` finds that the sequence rounds every one of
//    them as IEEE division does.  The theorem needs no underflow or overflow
//    in y, q0, r or q, and a finite nonzero a; the guard enforces it:
//        |a| in [2^-100, 2^100]   (a finite and nonzero; r, which is a
//                                  multiple of ~|a|*2^-48, cannot fall
//                                  below the subnormal grid; IEEE division
//                                  keeps the sign of a zero a, the sequence
//                                  would not)
//        |b| in [2^-24, 2^24]     (y and q normal, no overflow)
//    The reciprocals of rows 0..N-3 are IEEE divisions, once a launch.
//  * The ramp's terms on a helper warp.  The denominators of rows N-2 and N-1
//    and cp[N-2] depend on ramp[t]: a helper warp computes them, with their
//    reciprocals from `reciprocal` (branch-free, and equal to IEEE division
//    on every float32 of the guard's range: `rc_reciprocal_mismatches`),
//    kChunk steps at a time, into a two-chunk ring in shared memory that the
//    chain warp reads with two 16-byte loads a step.  An IEEE division
//    compiles to a slow-path check and branch, and in the chain warp's own
//    instruction stream the compiler would not overlap it with the chain.
//  * The guard once a chunk.  The chain warp runs a chunk's steps without a
//    branch, folding each quotient's guard into one flag; where any lane's
//    flag failed, the warp steps the chunk again from its saved start with
//    true divisions, as the plain version does, and rewrites its trace (a
//    lane that passed computes the same bits again).  The vote keeps that
//    branch uniform, and on the path's ladders no lane takes it.
//  * Each lane stores its row's N voltages of a step with 8- or 16-byte
//    stores straight from registers, off the chain.
//
// The chain that remains, N = 6: the first right-hand side (a multiply and
// an add), six quotients each behind a multiply and a subtract, five
// back-substitutions of a multiply and a subtract: 40 dependent float
// operations a step (`chain_ops` in kernels/rc_transient.py).  One thread
// owns one row; N is a template parameter, so every loop unrolls and the
// ladder lives in registers.  A block is one chain warp (32 rows) and its
// helper, so B = 1024 takes 32 SMs.
//
// Numerics: a build with FMA contraction off (-fmad=false, kernels/build.py);
// the __fmaf_rn calls are the only fused operations.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;              // rows a block: one chain warp
constexpr int kThreads = 2 * kRows;    // the chain warp and its helper warp
constexpr int kChunk = 16;             // steps a chunk of the two warps' ring
constexpr float kNumLo = 0x1p-100f;    // guard on a quotient's numerator
constexpr float kNumHi = 0x1p100f;
constexpr float kDenLo = 0x1p-24f;     // guard on a quotient's denominator
constexpr float kDenHi = 0x1p24f;

__device__ __forceinline__ bool in_range(float x, float lo, float hi) {
  const float m = fabsf(x);
  return m >= lo && m <= hi;          // false for NaN
}

// a / b as RN(a/b), from y = RN(1/b); exact under the guard above.
__device__ __forceinline__ float quotient(float a, float b, float y) {
  const float q0 = __fmul_rn(a, y);
  const float r = __fmaf_rn(-q0, b, a);
  return __fmaf_rn(r, y, q0);
}

// RN(1/b) without a branch: the hardware's approximate reciprocal and one
// Newton correction.  For every float32 with |b| in [2^-24, 2^25) it equals
// 1.0f / b bit for bit on sm_90 (`rc_reciprocal_mismatches` below counts
// the exceptions over all of them: none), where an IEEE division compiles
// to a slow-path check and branch that keeps the compiler from overlapping
// it with the chain.
__device__ __forceinline__ float reciprocal(float b) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(b));
  return __fmaf_rn(__fmaf_rn(-b, y, 1.0f), y, y);
}

// A row's ladder and its step invariants, in registers.
template <int N>
struct Row {
  float cdt[N], gc[N], gcv[N], gbr[N - 1];
  float den[N - 2], y[N - 2], cp[N - 2], dl[N - 1];
  bool ok;   // the invariant denominators inside the guard
};

// One step exactly as the plain version computes it (true divisions): the
// path a chunk takes again when the guard fails.
template <int N>
__device__ __forceinline__ void exact_step(const Row<N>& w, float s,
                                           float (&v)[N]) {
  float g[N - 1];
#pragma unroll
  for (int i = 0; i < N - 2; ++i) g[i] = w.gbr[i];
  g[N - 2] = w.gbr[N - 2] * s;
  float d[N], rhs[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float g_lo = i > 0 ? g[i - 1] : 0.0f;
    const float g_hi = i < N - 1 ? g[i] : 0.0f;
    d[i] = w.cdt[i] + g_lo + g_hi + w.gc[i];
    rhs[i] = w.cdt[i] * v[i] + w.gcv[i];
  }
  float cp[N], dp[N];
  cp[0] = -g[0] / d[0];
  dp[0] = rhs[0] / d[0];
#pragma unroll
  for (int i = 1; i < N; ++i) {
    const float dl = -g[i - 1];
    const float du = i < N - 1 ? -g[i] : 0.0f;
    const float denom = d[i] - dl * cp[i - 1];
    cp[i] = du / denom;
    dp[i] = (rhs[i] - dl * dp[i - 1]) / denom;
  }
  v[N - 1] = dp[N - 1];
#pragma unroll
  for (int i = N - 2; i >= 0; --i) v[i] = dp[i] - cp[i] * v[i + 1];
}

// The ramp-dependent terms of one step, rows N-2 and N-1, as two float4:
// ka = (den_a, y_a, cp_a, den_b), kb = (y_b, dl_b, ok, 0), where den_a and
// den_b are the rows' denominators, y their reciprocals, cp_a = cp[N-2],
// dl_b = -g[N-2] and ok says both denominators (and cp_a's numerator) are
// inside the guard.
template <int N>
__device__ __forceinline__ void ramp_terms(const Row<N>& w, float s,
                                           float4& ka, float4& kb) {
  const float g_last = w.gbr[N - 2] * s;
  const float g_prev = w.gbr[N - 3];
  // d[N-2], d[N-1] and the two denominators in the plain version's order
  const float d_a = w.cdt[N - 2] + g_prev + g_last + w.gc[N - 2];
  const float d_b = w.cdt[N - 1] + g_last + 0.0f + w.gc[N - 1];
  const float den_a = d_a - (-g_prev) * w.cp[N - 3];
  const float y_a = reciprocal(den_a);
  // cp[N-2] = -g_last / den_a; a zero ramp gives a zero numerator, whose
  // quotient is q0 itself (the correction would drop the sign of -0)
  const float q0 = __fmul_rn(-g_last, y_a);
  const float cp_a = g_last == 0.0f ? q0 : quotient(-g_last, den_a, y_a);
  const float dl_b = -g_last;
  const float den_b = d_b - dl_b * cp_a;
  const bool ok = in_range(den_a, kDenLo, kDenHi) &&
                  in_range(den_b, kDenLo, kDenHi) &&
                  (g_last == 0.0f || in_range(g_last, kNumLo, kNumHi));
  ka = make_float4(den_a, y_a, cp_a, den_b);
  kb = make_float4(reciprocal(den_b), dl_b, ok ? 1.0f : 0.0f, 0.0f);
}

template <int N>
__device__ __forceinline__ void load_row(Row<N>& w, float (&v)[N],
                                         const float* c, const float* g_branch,
                                         const float* g_clamp,
                                         const float* v_clamp, const float* v0,
                                         size_t r, float dt) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    w.cdt[i] = c[r * N + i] / dt * 1e-3f;   // fF/ns = uS -> mS
    w.gc[i] = g_clamp[r * N + i];
    w.gcv[i] = w.gc[i] * v_clamp[r * N + i];
    v[i] = v0[r * N + i];
  }
#pragma unroll
  for (int i = 0; i < N - 1; ++i) w.gbr[i] = g_branch[r * (N - 1) + i];
  // rows 0..N-3: diagonal, denominator, cp and the reciprocal, once
  w.ok = true;
#pragma unroll
  for (int i = 0; i < N - 2; ++i) {
    const float g_lo = i > 0 ? w.gbr[i - 1] : 0.0f;
    const float d = w.cdt[i] + g_lo + w.gbr[i] + w.gc[i];
    if (i == 0) {
      w.den[0] = d;
    } else {
      w.dl[i] = -w.gbr[i - 1];
      w.den[i] = d - w.dl[i] * w.cp[i - 1];
    }
    w.cp[i] = -w.gbr[i] / w.den[i];
    w.y[i] = 1.0f / w.den[i];
    w.ok = w.ok && in_range(w.den[i], kDenLo, kDenHi);
  }
  w.dl[N - 2] = -w.gbr[N - 3];
}

// One step on the fast path; false where the guard fails.
template <int N>
__device__ __forceinline__ bool fast_step(const Row<N>& w, const float4& ka,
                                          const float4& kb, float (&v)[N]) {
  // forward sweep: dp[i] = (rhs[i] - dl[i] * dp[i-1]) / denom_i
  float dp[N];
  float a = w.cdt[0] * v[0] + w.gcv[0];
  bool ok = in_range(a, kNumLo, kNumHi);
  dp[0] = quotient(a, w.den[0], w.y[0]);
#pragma unroll
  for (int i = 1; i < N - 2; ++i) {
    a = (w.cdt[i] * v[i] + w.gcv[i]) - w.dl[i] * dp[i - 1];
    ok = ok && in_range(a, kNumLo, kNumHi);
    dp[i] = quotient(a, w.den[i], w.y[i]);
  }
  a = (w.cdt[N - 2] * v[N - 2] + w.gcv[N - 2]) - w.dl[N - 2] * dp[N - 3];
  ok = ok && in_range(a, kNumLo, kNumHi);
  dp[N - 2] = quotient(a, ka.x, ka.y);
  a = (w.cdt[N - 1] * v[N - 1] + w.gcv[N - 1]) - kb.y * dp[N - 2];
  ok = ok && in_range(a, kNumLo, kNumHi);
  dp[N - 1] = quotient(a, ka.w, kb.x);
  // back-substitution
  v[N - 1] = dp[N - 1];
  v[N - 2] = dp[N - 2] - ka.z * v[N - 1];
#pragma unroll
  for (int i = N - 3; i >= 0; --i) v[i] = dp[i] - w.cp[i] * v[i + 1];
  return ok && kb.z != 0.0f;
}

// A row's N voltages of one step, in the widest aligned stores (the trace
// base is 256-byte aligned, a row starts at 4N bytes times its index).
template <int N>
__device__ __forceinline__ void store_row(float* dst, const float (&v)[N]) {
  if (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 2)
      *reinterpret_cast<float2*>(dst + i) = make_float2(v[i], v[i + 1]);
  }
}

// Named barriers of the two-warp ring (0 is __syncthreads').
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}
constexpr int kTermsReady = 1;   // + chunk parity: the helper filled the terms
constexpr int kChunkDone = 3;    // + chunk parity: the chain warp finished it

// A chain warp steps 32 rows while a helper warp computes the ramp terms of
// the chunk after next into a two-chunk ring.  Each barrier phase gets
// exactly one arrival from each warp: the helper arrives at kTermsReady + p
// after filling chunk ch (parity p) and, from ch = 2 on, first waits at
// kChunkDone + p for the chain warp to finish chunk ch - 2; the chain warp
// waits at kTermsReady + p before chunk ch and arrives at kChunkDone + p
// after it when a chunk ch + 2 follows.
template <int N>
__global__ void __launch_bounds__(kThreads)
rc_multistep_kernel(const float* __restrict__ c,
                    const float* __restrict__ g_branch,
                    const float* __restrict__ g_clamp,
                    const float* __restrict__ v_clamp,
                    const float* __restrict__ v0,
                    const float* __restrict__ ramp, float* __restrict__ trace,
                    int b, int n_steps, float dt) {
  __shared__ float4 terms[2][kChunk][2][kRows];
  const int lane = threadIdx.x & 31;
  const bool helper = threadIdx.x >= kRows;
  const int row = blockIdx.x * kRows + lane;
  // every lane stays to the end (barriers, votes); a lane past the batch
  // edge steps a copy of the last row and stores nothing
  const bool live = row < b;
  const size_t r = static_cast<size_t>(live ? row : b - 1);
  Row<N> w;
  float v[N];
  load_row<N>(w, v, c, g_branch, g_clamp, v_clamp, v0, r, dt);
  const int n_chunks = (n_steps + kChunk - 1) / kChunk;

  if (helper) {
    float s[kChunk];
    auto fetch = [&](int ch) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        s[j] = __ldg(ramp + min(ch * kChunk + j, n_steps - 1));
    };
    auto fill = [&](int ch) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        ramp_terms<N>(w, s[j], terms[ch & 1][j][0][lane],
                      terms[ch & 1][j][1][lane]);
    };
    fetch(0);
    fill(0);
    bar_arrive(kTermsReady);
    if (n_chunks > 1) {
      fetch(1);
      fill(1);
      bar_arrive(kTermsReady + 1);
    }
    for (int ch = 2; ch < n_chunks; ++ch) {
      fetch(ch);                         // in flight while the helper waits
      bar_sync(kChunkDone + (ch & 1));   // the chain warp is done with ch - 2
      fill(ch);
      bar_arrive(kTermsReady + (ch & 1));
    }
    return;
  }

  const size_t step_stride = static_cast<size_t>(b) * N;
  float* out = trace + r * N;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int p = ch & 1;
    const int t0 = ch * kChunk;
    bar_sync(kTermsReady + p);
    float v_start[N];
#pragma unroll
    for (int i = 0; i < N; ++i) v_start[i] = v[i];
    float* out_start = out;
    bool ok = w.ok;
    if (t0 + kChunk <= n_steps) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        ok = fast_step<N>(w, terms[p][j][0][lane], terms[p][j][1][lane], v) &&
             ok;
        if (live) store_row<N>(out, v);
        out += step_stride;
      }
    } else {
#pragma unroll 1
      for (int j = 0; j < n_steps - t0; ++j) {
        ok = fast_step<N>(w, terms[p][j][0][lane], terms[p][j][1][lane], v) &&
             ok;
        if (live) store_row<N>(out, v);
        out += step_stride;
      }
    }
    // where any lane's guard failed in the chunk, the warp steps it again
    // from its start with true divisions, as the plain version does (a lane
    // that passed computes the same bits again); the vote keeps the branch
    // uniform
    if (__any_sync(0xffffffffu, !ok)) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = v_start[i];
      out = out_start;
#pragma unroll 1
      for (int t = t0; t < min(t0 + kChunk, n_steps); ++t) {
        exact_step<N>(w, __ldg(ramp + t), v);
        if (live) store_row<N>(out, v);
        out += step_stride;
      }
    }
    // the helper waits for chunk ch only to refill its buffer with ch + 2
    if (ch + 2 < n_chunks) bar_arrive(kChunkDone + p);
  }
}

template <int N>
void launch(const float* c, const float* g, const float* gc, const float* vc,
            const float* v0, const float* ramp, float* trace, int b,
            int n_steps, float dt, cudaStream_t stream) {
  const int blocks = (b + kRows - 1) / kRows;
  rc_multistep_kernel<N><<<blocks, kThreads, 0, stream>>>(
      c, g, gc, vc, v0, ramp, trace, b, n_steps, dt);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream` and returns
// cudaGetLastError() (0 = launched); cudaErrorInvalidValue for an N the
// kernel is not instantiated for.
extern "C" int rc_multistep_launch(const float* c, const float* g_branch,
                                   const float* g_clamp, const float* v_clamp,
                                   const float* v0, const float* ramp,
                                   float* trace, int b, int n, int n_steps,
                                   float dt, void* stream) {
  if (b <= 0 || n_steps <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 4:
      launch<4>(c, g_branch, g_clamp, v_clamp, v0, ramp, trace, b, n_steps,
                dt, s);
      break;
    case 6:
      launch<6>(c, g_branch, g_clamp, v_clamp, v0, ramp, trace, b, n_steps,
                dt, s);
      break;
    case 8:
      launch<8>(c, g_branch, g_clamp, v_clamp, v0, ramp, trace, b, n_steps,
                dt, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch geometry: rows a block (the chain warp's lanes) and threads a
// block (the chain warp and its helper).
extern "C" int rc_multistep_geometry(int* rows, int* threads) {
  *rows = kRows;
  *threads = kThreads;
  return 0;
}

// The check behind `reciprocal`: every float32 b with |b| in [2^e_lo, 2^e_hi),
// both signs; adds to *mismatches the count whose reciprocal differs from
// the IEEE quotient 1.0f / b in any bit.  Returns cudaGetLastError().
namespace {
__global__ void reciprocal_check_kernel(unsigned first, unsigned long long count,
                                        unsigned long long* mismatches) {
  const unsigned long long i =
      blockIdx.x * static_cast<unsigned long long>(blockDim.x) + threadIdx.x;
  if (i >= count) return;
  const unsigned bits = first + static_cast<unsigned>(i >> 1);
  const float x = __uint_as_float(bits | (static_cast<unsigned>(i & 1) << 31));
  if (__float_as_uint(reciprocal(x)) != __float_as_uint(1.0f / x))
    atomicAdd(mismatches, 1ull);
}
}  // namespace

extern "C" int rc_reciprocal_mismatches(int e_lo, int e_hi,
                                        unsigned long long* mismatches,
                                        void* stream) {
  if (e_lo < -126 || e_hi > 128 || e_lo >= e_hi)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned first = static_cast<unsigned>(e_lo + 127) << 23;
  const unsigned long long count =
      (static_cast<unsigned long long>(e_hi - e_lo) << 23) * 2;
  const unsigned blocks = static_cast<unsigned>((count + 255) / 256);
  reciprocal_check_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      first, count, mismatches);
  return static_cast<int>(cudaGetLastError());
}
