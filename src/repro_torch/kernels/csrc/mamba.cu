// Mamba selective scan, forward, for Hopper (sm_90a), CUDA C++ on the CUDA
// cores.
//
// Replaces the TPU kernel src/repro/kernels/mamba.py::_mamba_kernel (wrapped
// there by mamba_scan_bsd and repro.kernels.ops.mamba_scan). Per batch row b
// and channel d, from the fp32 state h0[b, d, :] (zero when none is given),
// for t = 0 .. S-1 and n < St:
//   h[n] = exp(dt_t[d] * A[d][n]) * h[n] + dt_t[d] * u_t[d] * B_t[n]
//   y_t[d] = sum_n h[n] * C_t[n]
// y in u's dtype and the final h in fp32. All arithmetic is fp32: no TF32, no
// tensor cores.
//
// Design. Mamba never mixes channels (mamba.py:3-5), so the TPU kernel's
// sequential chunk axis with the [bd, St] state in VMEM becomes a time loop
// inside one thread per channel, its St states in registers.
//   * One block per (128 channels, batch row); a thread per channel holds its
//     St states and its row of A in registers. No thread reads another's
//     state.
//   * The state update rounds as the plain version (kernels/ref.py mamba_ref)
//     does, op by op: expf of the rounded product dt A, then a h and dt u B
//     each rounded, then their sum; no fused multiply-add. So h matches the
//     plain version bit for bit where both use the CUDA math library's expf.
//     A 512-step fp32 recurrence whose decay is near 1 otherwise gathers
//     rounding differences: a fused, exp2-based update differed from the
//     plain version by 2e-4 in y on an H100 at the serving shape, ten times
//     the fp32 tolerance.
//   * B_t and C_t, which all channels of a row share, are staged in shared
//     memory STEPS steps at a time, one element per thread; every thread
//     then reads the same address (a broadcast) as float4. y_t sums h C in
//     four partial sums, to shorten the chain of dependent adds.
//   * u and dt are read per step in the model layout [B, S, Di] from the
//     strides the wrapper passes: neighbouring threads read neighbouring
//     channels, so a warp's loads and its stores of y are coalesced. The
//     next stage's u, dt, B and C are loaded into registers before the
//     current stage is computed, so the loads are in flight meanwhile.
//   * Any S (the loop stops at S) and any Di (channels past Di compute on
//     zeros and store nothing). St is a template parameter: 4, 8 or 16.
//     h0 may be null (a zero state), so prefill allocates no zero state.
//
// What bounds it on an H100. At the serving shape (B=8, S=512, Di=16384,
// St=16, bf16) the function moves 412 MB (u, dt and y in bf16, B, C, A, and
// the final h in fp32): 0.123 ms at 3.35 TB/s, which sets the bound; its
// ~6.4 GFLOP take 0.096 ms at 67 TFLOP/s. Outside that formula, each of the
// 1.07 G state updates takes one exp on the SFU, 16 a clock per SM: about
// 0.29 ms at ~1.75 GHz. Around it this loop issues about a dozen fp32 and
// integer instructions per update (expf's range reduction and scaling, the
// unfused update, the y sum), so instruction issue, not memory, limits it.
// Cheaper exponentials (exp2 on pre-scaled A, part of them as an FMA
// polynomial) at a looser match to the plain version, or the chunked form on
// tensor cores, are left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;    // threads per block: one channel each
constexpr int STEPS = 8;   // time steps staged per stage

struct Params {
  const void* u;     // [B, S, Di]
  const void* dt;    // [B, S, Di]
  const float* A;    // [Di, St] contiguous
  const void* b;     // [B, S, St]
  const void* c;     // [B, S, St]
  const float* h0;   // [B, Di, St] contiguous, or null for a zero state
  void* y;           // [B, S, Di]
  float* h_out;      // [B, Di, St] contiguous
  int64_t u_sb, u_ss;
  int64_t dt_sb, dt_ss;
  int64_t b_sb, b_ss;
  int64_t c_sb, c_ss;
  int64_t y_sb, y_ss;
  int S, Di;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16(x); }

// h' = exp(dt A) h + (dt u) B, rounded op by op as the plain version rounds it.
__device__ __forceinline__ float update(float h, float a, float dt, float dtu, float b) {
  return __fadd_rn(__fmul_rn(expf(__fmul_rn(dt, a)), h), __fmul_rn(dtu, b));
}

template <typename T, int ST>
__global__ void __launch_bounds__(NT) mamba_scan_fwd_kernel(Params p) {
  static_assert(STEPS * ST <= NT && ST % 4 == 0, "unsupported state size");
  __shared__ __align__(16) float b_s[STEPS][ST];
  __shared__ __align__(16) float c_s[STEPS][ST];

  const int tid = threadIdx.x;
  const int d = blockIdx.x * NT + tid;  // the thread's channel
  const int64_t bi = blockIdx.y;        // the block's batch row
  const bool live = d < p.Di;
  const T* u = static_cast<const T*>(p.u) + bi * p.u_sb + d;
  const T* dt = static_cast<const T*>(p.dt) + bi * p.dt_sb + d;
  const T* bm = static_cast<const T*>(p.b) + bi * p.b_sb;
  const T* cm = static_cast<const T*>(p.c) + bi * p.c_sb;
  T* y = static_cast<T*>(p.y) + bi * p.y_sb + d;
  const int64_t h_off = (bi * p.Di + d) * ST;

  float a[ST], h[ST];
#pragma unroll
  for (int n = 0; n < ST; ++n) {
    a[n] = live ? p.A[int64_t(d) * ST + n] : 0.f;
    h[n] = live && p.h0 ? p.h0[h_off + n] : 0.f;
  }

  // The B and C element a thread stages: step tid / ST, state tid % ST.
  const bool stager = tid < STEPS * ST;
  const int st_t = tid / ST;
  const int st_n = tid % ST;
  float pu[STEPS], pdt[STEPS], pb = 0.f, pc = 0.f;
  auto prefetch = [&](int t0) {
#pragma unroll
    for (int k = 0; k < STEPS; ++k) {
      const bool in = live && t0 + k < p.S;
      pu[k] = in ? to_float(u[(t0 + k) * p.u_ss]) : 0.f;
      pdt[k] = in ? to_float(dt[(t0 + k) * p.dt_ss]) : 0.f;
    }
    const bool in = stager && t0 + st_t < p.S;
    pb = in ? to_float(bm[(t0 + st_t) * p.b_ss + st_n]) : 0.f;
    pc = in ? to_float(cm[(t0 + st_t) * p.c_ss + st_n]) : 0.f;
  };

  prefetch(0);
  for (int t0 = 0; t0 < p.S; t0 += STEPS) {
    float cu[STEPS], cdt[STEPS];
#pragma unroll
    for (int k = 0; k < STEPS; ++k) {
      cu[k] = pu[k];
      cdt[k] = pdt[k];
    }
    __syncthreads();  // the previous stage's B and C are consumed
    if (stager) {
      b_s[st_t][st_n] = pb;
      c_s[st_t][st_n] = pc;
    }
    __syncthreads();
    if (t0 + STEPS < p.S) prefetch(t0 + STEPS);

#pragma unroll
    for (int k = 0; k < STEPS; ++k) {
      if (t0 + k >= p.S) break;  // the same for every thread of the block
      const float dtk = cdt[k];
      const float dtu = __fmul_rn(dtk, cu[k]);
      float4 y4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int n = 0; n < ST; n += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(&b_s[k][n]);
        const float4 c4 = *reinterpret_cast<const float4*>(&c_s[k][n]);
        h[n + 0] = update(h[n + 0], a[n + 0], dtk, dtu, b4.x);
        h[n + 1] = update(h[n + 1], a[n + 1], dtk, dtu, b4.y);
        h[n + 2] = update(h[n + 2], a[n + 2], dtk, dtu, b4.z);
        h[n + 3] = update(h[n + 3], a[n + 3], dtk, dtu, b4.w);
        y4.x = fmaf(h[n + 0], c4.x, y4.x);
        y4.y = fmaf(h[n + 1], c4.y, y4.y);
        y4.z = fmaf(h[n + 2], c4.z, y4.z);
        y4.w = fmaf(h[n + 3], c4.w, y4.w);
      }
      if (live) store(&y[(t0 + k) * p.y_ss], (y4.x + y4.y) + (y4.z + y4.w));
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < ST; ++n) p.h_out[h_off + n] = h[n];
  }
}

template <typename T, int ST>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const dim3 grid((p.Di + NT - 1) / NT, B);
  mamba_scan_fwd_kernel<T, ST><<<grid, NT, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int st, const Params& p, int B, cudaStream_t stream) {
  switch (st) {
    case 4: return launch<T, 4>(p, B, stream);
    case 8: return launch<T, 8>(p, B, stream);
    case 16: return launch<T, 16>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of u, dt, B, C and y): 0 = float32, 1 = bfloat16. A, h0 and h_out
// are float32 and contiguous; h0 may be null (zero initial state). Strides are
// in elements; the last axis of u, dt, B, C and y is contiguous. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int mamba_scan_fwd(
    const void* u, const void* dt, const float* A, const void* b, const void* c, int dtype,
    const float* h0, void* y, float* h_out,
    int B, int S, int Di, int St,
    int64_t u_sb, int64_t u_ss,
    int64_t dt_sb, int64_t dt_ss,
    int64_t b_sb, int64_t b_ss,
    int64_t c_sb, int64_t c_ss,
    int64_t y_sb, int64_t y_ss,
    void* stream) {
  if (B < 1 || B > 65535 || S < 1 || Di < 1) return cudaErrorInvalidValue;
  Params p;
  p.u = u; p.dt = dt; p.A = A; p.b = b; p.c = c; p.h0 = h0; p.y = y; p.h_out = h_out;
  p.u_sb = u_sb; p.u_ss = u_ss;
  p.dt_sb = dt_sb; p.dt_ss = dt_ss;
  p.b_sb = b_sb; p.b_ss = b_ss;
  p.c_sb = c_sb; p.c_ss = c_ss;
  p.y_sb = y_sb; p.y_ss = y_ss;
  p.S = S; p.Di = Di;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(St, p, B, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(St, p, B, s);
  return cudaErrorInvalidValue;
}
