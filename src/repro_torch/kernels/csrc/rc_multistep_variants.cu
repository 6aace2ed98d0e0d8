// Variants of the rc_multistep kernel, for an A/B against it on the card
// (`python src/repro_torch/kernels/bench.py --only rc_variants`).  No path
// of the port launches them.  Each computes what `rc_multistep_kernel`
// computes, bit for bit, with the helpers of csrc/rc_multistep.cu:
//
//   simple_<rows>            one thread a row, `rows` rows a block, no
//                            helper warp: the step invariants once a launch,
//                            the exact quotients, the ramp's terms computed
//                            in the step itself and the guard checked each
//                            step (a lane that fails steps again with true
//                            divisions);
//   simple_32_staged         stores a step's 32 rows through shared memory
//                            as 16-byte stores of the contiguous block;
//   simple_32_ramp_smem      reads the ramp from shared memory, staged once
//                            a block;
//   simple_32_ieee_rcp       the ramp terms' reciprocals as 1.0f / b.
//
// Only N = 6 (the phased path's ladder) is instantiated.

#include "rc_multistep.cu"

namespace {

constexpr int kVariantN = 6;

// `ramp_terms` with the reciprocals as IEEE divisions.
template <int N>
__device__ __forceinline__ void ramp_terms_ieee(const Row<N>& w, float s,
                                                float4& ka, float4& kb) {
  const float g_last = w.gbr[N - 2] * s;
  const float g_prev = w.gbr[N - 3];
  const float d_a = w.cdt[N - 2] + g_prev + g_last + w.gc[N - 2];
  const float d_b = w.cdt[N - 1] + g_last + 0.0f + w.gc[N - 1];
  const float den_a = d_a - (-g_prev) * w.cp[N - 3];
  const float y_a = 1.0f / den_a;
  const float q0 = __fmul_rn(-g_last, y_a);
  const float cp_a = g_last == 0.0f ? q0 : quotient(-g_last, den_a, y_a);
  const float dl_b = -g_last;
  const float den_b = d_b - dl_b * cp_a;
  const bool ok = in_range(den_a, kDenLo, kDenHi) &&
                  in_range(den_b, kDenLo, kDenHi) &&
                  (g_last == 0.0f || in_range(g_last, kNumLo, kNumHi));
  ka = make_float4(den_a, y_a, cp_a, den_b);
  kb = make_float4(1.0f / den_b, dl_b, ok ? 1.0f : 0.0f, 0.0f);
}

template <int N, int ROWS, bool STAGE, bool RAMP_SMEM, bool IEEE_RCP>
__global__ void __launch_bounds__(ROWS)
simple_kernel(const float* __restrict__ c, const float* __restrict__ g_branch,
              const float* __restrict__ g_clamp,
              const float* __restrict__ v_clamp, const float* __restrict__ v0,
              const float* __restrict__ ramp, float* __restrict__ trace, int b,
              int n_steps, float dt) {
  extern __shared__ float s_ramp[];
  __shared__ float4 staged[2][STAGE ? ROWS * N / 4 : 1];
  const int row0 = blockIdx.x * ROWS;
  const int row = row0 + threadIdx.x;
  const bool live = row < b;
  const size_t r = static_cast<size_t>(live ? row : b - 1);
  Row<N> w;
  float v[N];
  load_row<N>(w, v, c, g_branch, g_clamp, v_clamp, v0, r, dt);
  if (RAMP_SMEM) {
    for (int t = threadIdx.x; t < n_steps; t += ROWS) s_ramp[t] = ramp[t];
    __syncthreads();
  }
  const size_t step_stride = static_cast<size_t>(b) * N;
  const bool full = row0 + ROWS <= b;
#pragma unroll 4
  for (int t = 0; t < n_steps; ++t) {
    const float s = RAMP_SMEM ? s_ramp[t] : __ldg(ramp + t);
    float4 ka, kb;
    if (IEEE_RCP)
      ramp_terms_ieee<N>(w, s, ka, kb);
    else
      ramp_terms<N>(w, s, ka, kb);
    float v_prev[N];
#pragma unroll
    for (int i = 0; i < N; ++i) v_prev[i] = v[i];
    if (!(fast_step<N>(w, ka, kb, v) && w.ok)) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = v_prev[i];
      exact_step<N>(w, s, v);
    }
    float* out = trace + t * step_stride;
    if (!STAGE) {
      if (live) store_row<N>(out + r * N, v);
      continue;
    }
    // the block's rows of this step are ROWS * N contiguous floats
    float* buf = reinterpret_cast<float*>(staged[t & 1]);
#pragma unroll
    for (int i = 0; i < N; ++i) buf[threadIdx.x * N + i] = v[i];
    __syncthreads();
    float* dst = out + static_cast<size_t>(row0) * N;
    if (full && (reinterpret_cast<size_t>(dst) & 15) == 0) {
      for (int k = threadIdx.x; k < ROWS * N / 4; k += ROWS)
        reinterpret_cast<float4*>(dst)[k] = staged[t & 1][k];
    } else {
      const int n_live = min(ROWS, b - row0) * N;
      for (int k = threadIdx.x; k < n_live; k += ROWS) dst[k] = buf[k];
    }
  }
}

template <int ROWS, bool STAGE, bool RAMP_SMEM, bool IEEE_RCP>
void launch_simple(const float* c, const float* g, const float* gc,
                   const float* vc, const float* v0, const float* ramp,
                   float* trace, int b, int n_steps, float dt,
                   cudaStream_t stream) {
  const int blocks = (b + ROWS - 1) / ROWS;
  const size_t smem = RAMP_SMEM ? sizeof(float) * n_steps : 0;
  simple_kernel<kVariantN, ROWS, STAGE, RAMP_SMEM, IEEE_RCP>
      <<<blocks, ROWS, smem, stream>>>(c, g, gc, vc, v0, ramp, trace, b,
                                       n_steps, dt);
}

const char* const kVariantNames[] = {
    "simple_32",           "simple_64",          "simple_128",
    "simple_32_staged",    "simple_32_ramp_smem", "simple_32_ieee_rcp"};
constexpr int kVariants = sizeof(kVariantNames) / sizeof(kVariantNames[0]);

}  // namespace

// The name of variant `v`, or null past the last.
extern "C" const char* rc_variant_name(int v) {
  return v >= 0 && v < kVariants ? kVariantNames[v] : nullptr;
}

// Launch variant `v` on `stream` (same arguments as rc_multistep_launch);
// cudaErrorInvalidValue for an unknown variant or N other than 6.
extern "C" int rc_variant_launch(int v, const float* c, const float* g_branch,
                                 const float* g_clamp, const float* v_clamp,
                                 const float* v0, const float* ramp,
                                 float* trace, int b, int n, int n_steps,
                                 float dt, void* stream) {
  if (n != kVariantN) return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0 || n_steps <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 0: launch_simple<32, false, false, false>(c, g_branch, g_clamp,
                v_clamp, v0, ramp, trace, b, n_steps, dt, s); break;
    case 1: launch_simple<64, false, false, false>(c, g_branch, g_clamp,
                v_clamp, v0, ramp, trace, b, n_steps, dt, s); break;
    case 2: launch_simple<128, false, false, false>(c, g_branch, g_clamp,
                v_clamp, v0, ramp, trace, b, n_steps, dt, s); break;
    case 3: launch_simple<32, true, false, false>(c, g_branch, g_clamp,
                v_clamp, v0, ramp, trace, b, n_steps, dt, s); break;
    case 4: launch_simple<32, false, true, false>(c, g_branch, g_clamp,
                v_clamp, v0, ramp, trace, b, n_steps, dt, s); break;
    case 5: launch_simple<32, false, false, true>(c, g_branch, g_clamp,
                v_clamp, v0, ramp, trace, b, n_steps, dt, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
