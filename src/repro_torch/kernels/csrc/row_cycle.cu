// Fused ACT/RESTORE/PRE row-cycle transient engine for Hopper (sm_90a).
//
// Replaces the TPU kernel `row_cycle_fused_pallas` (body `_row_cycle_kernel`)
// in src/repro/kernels/row_cycle.py, and computes what the plain version
// `repro_torch.kernels.ref.row_cycle_fused_ref` computes: per design row, an
// implicit-Euler RC ladder of N nodes stepped through ACT -> RESTORE -> PRE
// with in-kernel threshold-crossing detection, giving O(B) outputs
//   events (B, 4) = [t_dev, dv_sense, t_res_dur, t_pre]   and   v_end (B, N).
//
// What bounds it on this card: arithmetic latency, not bytes.  A row reads
// 140 B and writes 40 B once (N = 6), but runs up to n_act + n_res + n_pre
// steps, each a serial chain of ~2N IEEE divisions (the Thomas solve) and
// one expf.  The Pallas kernel kept a (B_blk, N) block in VMEM and stepped
// it with vector ops; here each thread owns one row, keeps its ladder, its
// phase state machine and its Thomas scratch in registers (N is a template
// parameter, so every loop unrolls), and touches device memory only to load
// the netlist and to store the events.  Latency is hidden by the number of
// resident warps, not by shared memory.  A warp leaves its time loop as soon
// as `__all_sync` says all 32 of its rows are DONE, so the step count is the
// slowest row of the warp, not the worst-case phase windows.
//
// Replica coupling: a role-2 (main) row's ACT crossing is the role-1
// (replica) crossing of row-1 at the same step.  Pairs are even-aligned, so a
// pair never straddles a warp and `__shfl_up_sync` delivers it; the wrapper
// rejects a role-2 row at an even index (where the shuffle and the
// reference's wrap-around shift would differ).
//
// A step is lean: the parts of the tridiagonal system that do not follow
// the WL ramp (every diagonal entry but the two around the access branch,
// and the Thomas sweep's cp[i] and denominators above them, and the clamp
// terms) are computed once when a row enters a phase, so a step does N + 2
// divisions (one for the ramp) where it did 2N.
//
// Numerics follow the reference operation for operation: true division,
// accurate expf, and the build turns FMA contraction off (-fmad=false), so
// the kernel rounds like the plain version, bit for bit.
//
// Launch: one launch per call over the whole padded batch
// (core/transient.py `fused_launch_plan`); the 2048-row chunks of the
// reference (a TPU VMEM bound) are kept only as the padding unit.
//
// What bounds it now: the serial chain of a step (IEEE divisions, each a
// sequence of dependent instructions, and expf), times the steps of the
// slowest row of each warp.  Replacing each division by a multiply with a reciprocal
// computed once per phase would shorten the chain but changes rounding
// (PERF.md, open questions).  Build: see kernels/build.py.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kEvents = 4;

// params columns
constexpr int kTauWl = 0, kThrRel = 1, kVdd = 2, kVpre = 3, kActive = 4,
              kRole = 5;
constexpr float kRestoreFrac = 0.95f;   // restored when v_cell >= 0.95 VDD
constexpr float kEqualizeTol = 5e-3f;   // equalized when max|v - vpre| <= 5 mV

template <int N>
__global__ void __launch_bounds__(kThreads)
row_cycle_kernel(const float* __restrict__ c, const float* __restrict__ g_branch,
                 const float* __restrict__ gc_res,
                 const float* __restrict__ gc_pre, const float* __restrict__ v0,
                 const float* __restrict__ params, int n_params,
                 float* __restrict__ events, float* __restrict__ v_end, int b,
                 float dt, int n_act, int n_res, int n_pre) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = row < b;

  float cdt[N], gcr[N], gcp[N], v[N], gbr[N - 1];
  float tau = 1.0f, thr = 0.0f, vdd = 0.0f, vpre = 0.0f, role = 0.0f;
  bool active = false;
  if (live) {
    const size_t r = static_cast<size_t>(row);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      cdt[i] = c[r * N + i] / dt * 1e-3f;   // fF/ns = uS -> mS
      gcr[i] = gc_res[r * N + i];
      gcp[i] = gc_pre[r * N + i];
      v[i] = v0[r * N + i];
    }
#pragma unroll
    for (int i = 0; i < N - 1; ++i) gbr[i] = g_branch[r * (N - 1) + i];
    const float* p = params + r * n_params;
    tau = fmaxf(p[kTauWl], 1e-3f);
    thr = p[kThrRel];
    vdd = p[kVdd];
    vpre = p[kVpre];
    active = p[kActive] > 0.5f;
    role = n_params > kRole ? p[kRole] : 0.0f;
  } else {
    // lanes past the batch idle as DONE rows but still vote and shuffle
#pragma unroll
    for (int i = 0; i < N; ++i) {
      cdt[i] = 1.0f; gcr[i] = 0.0f; gcp[i] = 0.0f; v[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < N - 1; ++i) gbr[i] = 0.0f;
  }
  const bool is_rep = fabsf(role - 1.0f) < 0.5f;
  const bool is_main = role > 1.5f;

  int phase = active ? 0 : 3;   // 0=ACT 1=RESTORE 2=PRE 3=DONE
  int tin = 0;                  // step within the phase
  float ev[kEvents] = {0.0f, 0.0f, 0.0f, 0.0f};
  const float kNaN = __int_as_float(0x7fc00000);
  const int t_total = n_act + n_res + n_pre;

  // Phase-invariant part of the step.  Only the access branch g[N-2]
  // follows the ramp, so d[i] for i <= N-3, the Thomas forward sweep's
  // cp[i] and denominators for i <= N-3, and the clamp terms are fixed
  // while a row stays in a phase: they are computed when it enters one,
  // with the operations of the full step in the same order (so the
  // results are bit-identical to recomputing them every step).
  int set_phase = -1;
  float cpf[N - 2], den[N - 2], gcv[N], gc_tail[2];   // den[0] = d[0]
  float d_lo = 0.0f;

  for (int t = 0; t < t_total; ++t) {
    if (__all_sync(kFullMask, phase >= 3)) break;
    const bool in_act = phase == 0, in_res = phase == 1, in_pre = phase == 2;
    const bool done = phase >= 3;

    if (phase != set_phase) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        gcv[i] = in_res ? gcr[i] * vdd : (in_pre ? gcp[i] * vpre : 0.0f);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = N - 2 + i;
        gc_tail[i] = in_res ? gcr[j] : (in_pre ? gcp[j] : 0.0f);
      }
      float dfix[N - 2];
#pragma unroll
      for (int i = 0; i < N - 2; ++i) {
        const float g_lo = i > 0 ? gbr[i - 1] : 0.0f;
        const float gc = in_res ? gcr[i] : (in_pre ? gcp[i] : 0.0f);
        dfix[i] = cdt[i] + g_lo + gbr[i] + gc;
      }
      cpf[0] = -gbr[0] / dfix[0];
      den[0] = dfix[0];
#pragma unroll
      for (int i = 1; i < N - 2; ++i) {
        const float dl = -gbr[i - 1];
        den[i] = dfix[i] - dl * cpf[i - 1];
        cpf[i] = -gbr[i] / den[i];
      }
      d_lo = cdt[N - 2] + gbr[N - 3];
      set_phase = phase;
    }

    // WL ramp, analytic: rising 1 - e^{-t/tau} in ACT, falling in PRE
    const float t_ns = (static_cast<float>(tin) + 1.0f) * dt;
    const float e = expf(-t_ns / tau);
    const float s = in_act ? 1.0f - e : (in_res ? 1.0f : (in_pre ? e : 0.0f));
    const float ga = gbr[N - 2] * s;   // the access branch g[N-2]

    // the two rows of A = C/dt + G(s) + clamp that hold g[N-2]; every
    // rhs = C/dt v + clamp v
    const float d_n2 = d_lo + ga + gc_tail[0];
    const float d_n1 = cdt[N - 1] + ga + 0.0f + gc_tail[1];
    float rhs[N];
#pragma unroll
    for (int i = 0; i < N; ++i) rhs[i] = cdt[i] * v[i] + gcv[i];

    // Thomas solve (order of ref._thomas_small): dl[i] = -g[i-1],
    // du[i] = -g[i]; rows i <= N-3 use the phase's cp and denominators
    float dp[N], x[N];
    dp[0] = rhs[0] / den[0];
#pragma unroll
    for (int i = 1; i < N - 2; ++i) {
      const float dl = -gbr[i - 1];
      dp[i] = (rhs[i] - dl * dp[i - 1]) / den[i];
    }
    const float dl_n2 = -gbr[N - 3];
    const float denom_n2 = d_n2 - dl_n2 * cpf[N - 3];
    const float cp_n2 = -ga / denom_n2;
    dp[N - 2] = (rhs[N - 2] - dl_n2 * dp[N - 3]) / denom_n2;
    const float dl_n1 = -ga;
    const float denom_n1 = d_n1 - dl_n1 * cp_n2;
    dp[N - 1] = (rhs[N - 1] - dl_n1 * dp[N - 2]) / denom_n1;
    x[N - 1] = dp[N - 1];
    x[N - 2] = dp[N - 2] - cp_n2 * x[N - 1];
#pragma unroll
    for (int i = N - 3; i >= 0; --i) x[i] = dp[i] - cpf[i] * x[i + 1];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = done ? v[i] : x[i];

    // threshold crossings on the fresh state
    const bool cross_own = x[0] - vpre >= thr;
    const bool cross_prev = __shfl_up_sync(kFullMask, static_cast<int>(cross_own), 1) != 0;
    const bool c_act = is_main ? cross_prev : cross_own;
    const bool c_res = x[N - 1] >= kRestoreFrac * vdd;
    float dev_max = 0.0f;   // max |v - vpre| over the BL nodes, NaN-propagating
#pragma unroll
    for (int i = 0; i < N - 1; ++i) {
      const float a = fabsf(x[i] - vpre);
      dev_max = (a > dev_max || a != a) ? a : dev_max;
    }
    const bool c_pre = dev_max <= kEqualizeTol;

    const int tin1 = tin + 1;
    const int pc = phase < 2 ? phase : 2;
    const bool crossed = pc == 0 ? c_act : (pc == 1 ? c_res : c_pre);
    const int cap = pc == 0 ? n_act : (pc == 1 ? n_res : n_pre);
    const bool advance = !done && (crossed || tin1 >= cap);
    // first-crossing time (idx+1)*dt, or NaN if the phase timed out
    const float t_evt = crossed ? static_cast<float>(tin1) * dt : kNaN;
    if (advance) {
      if (phase == 0) {
        ev[0] = t_evt;
        ev[1] = x[0] - vpre;
      } else if (phase == 1) {
        ev[2] = t_evt;
      } else {
        ev[3] = t_evt;
      }
      phase += is_rep ? 3 : 1;   // replica rows are ACT-only
      tin = 0;
    } else if (!done) {
      tin = tin1;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = x[i];
  }

  if (live) {
    const size_t r = static_cast<size_t>(row);
#pragma unroll
    for (int k = 0; k < kEvents; ++k) events[r * kEvents + k] = ev[k];
#pragma unroll
    for (int i = 0; i < N; ++i) v_end[r * N + i] = v[i];
  }
}

template <int N>
void launch(const float* c, const float* g, const float* gcr, const float* gcp,
            const float* v0, const float* params, int n_params, float* events,
            float* v_end, int b, float dt, int n_act, int n_res, int n_pre,
            cudaStream_t stream) {
  const int blocks = (b + kThreads - 1) / kThreads;
  row_cycle_kernel<N><<<blocks, kThreads, 0, stream>>>(
      c, g, gcr, gcp, v0, params, n_params, events, v_end, b, dt, n_act,
      n_res, n_pre);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream` and returns
// cudaGetLastError() (0 = launched); cudaErrorInvalidValue for an N the
// kernel is not instantiated for.
extern "C" int row_cycle_fused_launch(const float* c, const float* g,
                                      const float* gc_res, const float* gc_pre,
                                      const float* v0, const float* params,
                                      int n_params, float* events, float* v_end,
                                      int b, int n, float dt, int n_act,
                                      int n_res, int n_pre, void* stream) {
  if (b <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 4:
      launch<4>(c, g, gc_res, gc_pre, v0, params, n_params, events, v_end, b,
                dt, n_act, n_res, n_pre, s);
      break;
    case 6:
      launch<6>(c, g, gc_res, gc_pre, v0, params, n_params, events, v_end, b,
                dt, n_act, n_res, n_pre, s);
      break;
    case 8:
      launch<8>(c, g, gc_res, gc_pre, v0, params, n_params, events, v_end, b,
                dt, n_act, n_res, n_pre, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
