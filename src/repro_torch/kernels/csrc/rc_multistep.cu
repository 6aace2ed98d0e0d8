// Multi-step implicit-Euler transient of a batched RC ladder for Hopper
// (sm_90a): the inner loop of the phased row-cycle engine (Fig. 8 waveforms).
//
// Replaces the TPU kernel `rc_multistep_pallas` (body `_rc_kernel`) in
// src/repro/kernels/rc_transient.py:75, and computes what the plain version
// `repro_torch.kernels.ref.rc_multistep_ref` computes: per design row, T
// implicit-Euler steps of an N-node ladder whose last (access) branch is
// scaled by ramp[t] and whose nodes are pulled toward v_clamp through
// g_clamp, writing every step's node voltages:
//   trace (T, B, N),  trace[t, b, :] = state after step t.
//
// What bounds it on this card: bytes.  A row reads 4N + (N-1) floats once but
// writes T*N floats of trace (T = 800 / 1000 / 500 for ACT / RESTORE / PRE),
// about 20 MB per ACT call at B = 1024, N = 6, against ~13N float operations
// a step.  In practice it sits on dependent-step latency: each step is a
// serial chain of ~2N IEEE divisions (the Thomas solve), and 1024 rows are 8
// blocks of 128 threads on 132 SMs.  The Pallas kernel kept a (B_blk, N)
// block in VMEM for all T steps and stepped it with vector ops; here each
// thread owns one row and keeps its ladder and the unrolled Thomas scratch in
// registers (N is a template parameter, so every loop unrolls).  `ramp[t]`
// is read through the read-only path; each step stores the row's N voltages
// straight to trace[t, row, :].  The ragged batch edge is a bounds check (no
// padding rows).  Staged, coalesced trace stores and more rows in flight are
// left for later.
//
// Numerics follow the reference operation for operation: true division and a
// build with FMA contraction off (-fmad=false), so the kernel rounds like the
// plain version.  Build: see kernels/build.py.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <int N>
__global__ void __launch_bounds__(kThreads)
rc_multistep_kernel(const float* __restrict__ c,
                    const float* __restrict__ g_branch,
                    const float* __restrict__ g_clamp,
                    const float* __restrict__ v_clamp,
                    const float* __restrict__ v0,
                    const float* __restrict__ ramp, float* __restrict__ trace,
                    int b, int n_steps, float dt) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= b) return;   // no warp-collective operations below
  const size_t r = static_cast<size_t>(row);

  float cdt[N], gc[N], gcv[N], v[N], gbr[N - 1];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    cdt[i] = c[r * N + i] / dt * 1e-3f;   // fF/ns = uS -> mS
    gc[i] = g_clamp[r * N + i];
    gcv[i] = gc[i] * v_clamp[r * N + i];
    v[i] = v0[r * N + i];
  }
#pragma unroll
  for (int i = 0; i < N - 1; ++i) gbr[i] = g_branch[r * (N - 1) + i];

  const size_t row_stride = static_cast<size_t>(b) * N;
  float* out = trace + r * N;
  for (int t = 0; t < n_steps; ++t) {
    const float s = __ldg(ramp + t);

    // tridiagonal assembly A = C/dt + G(s) + clamp, rhs = C/dt v + clamp v
    float g[N - 1];
#pragma unroll
    for (int i = 0; i < N - 2; ++i) g[i] = gbr[i];
    g[N - 2] = gbr[N - 2] * s;
    float d[N], rhs[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float g_lo = i > 0 ? g[i - 1] : 0.0f;
      const float g_hi = i < N - 1 ? g[i] : 0.0f;
      d[i] = cdt[i] + g_lo + g_hi + gc[i];
      rhs[i] = cdt[i] * v[i] + gcv[i];
    }

    // Thomas solve (order of ref.tridiag_solve_ref): dl[i] = -g[i-1],
    // du[i] = -g[i]
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

#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = v[i];
    out += row_stride;
  }
}

template <int N>
void launch(const float* c, const float* g, const float* gc, const float* vc,
            const float* v0, const float* ramp, float* trace, int b,
            int n_steps, float dt, cudaStream_t stream) {
  const int blocks = (b + kThreads - 1) / kThreads;
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
