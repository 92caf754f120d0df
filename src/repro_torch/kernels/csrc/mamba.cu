// Mamba selective scan, forward, for Hopper (sm_90a), CUDA C++ on the CUDA
// cores and the SFU.
//
// Replaces the TPU kernel src/repro/kernels/mamba.py::_mamba_kernel (wrapped
// there by mamba_scan_bsd and repro.kernels.ops.mamba_scan). Per batch row b
// and channel d, from the fp32 state h0[b, d, :] (zero when none is given),
// for t = 0 .. S-1 and n < St:
//   h[n] = exp(dt_t[d] * A[d][n]) * h[n] + dt_t[d] * u_t[d] * B_t[n]
//   y_t[d] = sum_n h[n] * C_t[n]
// y in u's dtype and the final h in fp32. All arithmetic is fp32: no tensor
// cores, and none would help. Mamba-1's decay exp(dt A) depends on both the
// channel and the state index, so the chunked matrix form of Mamba-2 (one
// scalar decay per head, which turns a chunk into products on the tensor
// cores) does not exist for it: the 1.07 G exponentials of the serving shape
// are the work itself.
//
// Common to both kernels below. Mamba never mixes channels (mamba.py:3-5),
// so the TPU kernel's sequential chunk axis with the [bd, St] state in VMEM
// becomes a time loop in one thread per channel, its St states and its row
// of A in registers; a block holds 128 channels of one batch row. B_t and
// C_t, which all channels of a row share, are staged in shared memory STEPS
// steps at a time, one element per thread, and read by every thread at the
// same address (a broadcast) as float4. u, dt and y are read and written in
// the model layout [B, S, Di] from the strides the wrapper passes, so B and C
// can be views of the x_proj output. Any S (the loop stops at S), any Di
// (channels past Di compute on zeros and store nothing), St in {4, 8, 16};
// h0 may be null (a zero state), so prefill allocates no zero state.
//
// fp32 (mamba_scan_fwd_kernel<float>), unchanged since its port. The update
// rounds as the plain version (kernels/ref.py mamba_ref) does, op by op:
// expf of the rounded product dt A, then a h and dt u B each rounded, then
// their sum; no fused multiply-add. So h matches the plain version bit for
// bit. A 512-step fp32 recurrence whose decay is near 1 gathers rounding
// differences: a fused, exp2-based update differed from the plain version by
// 2e-4 in y on an H100 at the serving shape, ten times the fp32 tolerance.
// The next stage's u, dt, B and C are prefetched into registers.
//
// bf16 (mamba_scan_bf16_kernel), what serving runs, held to the bf16
// tolerances (y 2e-2, h 1e-3):
//   * A is pre-scaled by log2 e once, into registers. Each decay is one
//     ex2.approx.ftz.f32 of dt A2 (one MUFU instruction) and the update two
//     fused multiply-adds, h = fma(e, h, dtu B[n]) and y = fma(h, C[n], y):
//     4 instructions on the FMA pipe and one on the SFU per update, against
//     about a dozen in the fp32 kernel.
//   * Every decay goes to the SFU. Computing a fixed share of them on the
//     FMA pipe instead, as FlashAttention-3 does (a degree-5 polynomial for
//     2^f after a 1.5 * 2^23 rounding add), was timed at 1/8, 1/4 and 3/8 of
//     the states (scripts/scan_sweep.py, which carries that polynomial):
//     every share was slower than none, because the FMA pipe's issue, not
//     the SFU, is what the loop runs into.
//   * The next stage's u and dt [STEPS, 128] go by cp.async into a two-stage
//     ring in shared memory (element by element when the rows are not 16-byte
//     aligned), and its B and C are held as raw bf16 bits in registers until
//     the stage is consumed. Loads converted as they arrive (a shift) made
//     every thread wait for them once a stage: that stall, more than the
//     exponentials, set the pace of the fp32 kernel's bf16 instance. A
//     stage's y is gathered in shared memory and stored a stage later, 16
//     bytes a thread.
//   * The decays of step k + 1 go to the SFU while step k updates, so their
//     results are a step old when the fused multiply-adds use them.
//   * Registers are capped for kMinBlocks blocks per SM (chosen by the same
//     sweep; more blocks spill).
//   * The kernel does not look at A's values: the repo's mamba_a init gives
//     A[d][n] = -(n + 1), which would allow one exponential per (t, d) and
//     powers by multiplication, but trained weights have no such structure.
//
// What bounds it on an H100. At the serving shape (B=8, S=512, Di=16384,
// St=16, bf16) the function moves 412 MB (u, dt and y in bf16, B, C, A, and
// the final h in fp32): 0.123 ms at 3.35 TB/s, which sets the bound; its
// ~6.4 GFLOP take 0.096 ms at 67 TFLOP/s, and its 1.07 G exponentials 0.26 ms
// on the SFU at the 1.98 GHz the card runs it at. The bf16 kernel issues
// ~5.5 instructions per update at about half an instruction a clock per
// scheduler, so the FMA pipe's issue sets its pace, above both.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int NT = 128;    // threads per block
constexpr int STEPS = 8;   // time steps staged per stage
constexpr int kMinBlocks = 5;  // bf16 kernel: blocks per SM the register budget is capped for (scripts/scan_sweep.py)
constexpr float kLog2e = 1.4426950408889634f;

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
  int aligned;  // bf16 kernel: u, dt and y start on 16 bytes and their strides are multiples of 8 elements
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }

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

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) { return __uint_as_float(bits16 << 16); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
}

template <int ST>
__global__ void __launch_bounds__(NT, kMinBlocks) mamba_scan_bf16_kernel(Params p) {
  static_assert(STEPS * ST <= NT && ST % 4 == 0, "unsupported state size");
  __shared__ __align__(16) uint16_t ud_s[2][2][STEPS][NT];  // [stage][u, dt][step][channel], bf16 bits
  __shared__ __align__(16) float b_s[STEPS][ST];
  __shared__ __align__(16) float c_s[STEPS][ST];
  __shared__ __align__(16) uint16_t y_s[2][STEPS][NT];  // a stage's y, bf16 bits, stored a stage later

  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * NT;  // the block's first channel
  const int d = d0 + tid;          // the thread's channel
  const int64_t bi = blockIdx.y;   // the block's batch row
  const bool live = d < p.Di;
  const uint16_t* u = static_cast<const uint16_t*>(p.u) + bi * p.u_sb + d0;
  const uint16_t* dt = static_cast<const uint16_t*>(p.dt) + bi * p.dt_sb + d0;
  const uint16_t* bm = static_cast<const uint16_t*>(p.b) + bi * p.b_sb;
  const uint16_t* cm = static_cast<const uint16_t*>(p.c) + bi * p.c_sb;
  uint16_t* y = static_cast<uint16_t*>(p.y) + bi * p.y_sb + d0;
  const int64_t h_off = (bi * p.Di + d) * ST;

  float a2[ST], h[ST];
#pragma unroll
  for (int n = 0; n < ST; ++n) {
    a2[n] = live ? __fmul_rn(p.A[int64_t(d) * ST + n], kLog2e) : 0.f;
    h[n] = live && p.h0 ? p.h0[h_off + n] : 0.f;
  }

  // A stage's u and dt [STEPS, NT] into ud_s[stage]: by cp.async, 8 channels
  // a copy, zero past S and Di, when the rows are 16-byte aligned; else
  // element by element.
  auto load_ud = [&](int t0, int stage) {
    if (p.aligned) {
      for (int e = tid; e < 2 * STEPS * (NT / 8); e += NT) {
        const int a = e / (STEPS * (NT / 8)), k = e / (NT / 8) % STEPS, c8 = e % (NT / 8) * 8;
        const int n_in = t0 + k < p.S ? max(0, min(8, p.Di - d0 - c8)) : 0;
        const uint16_t* src = a ? dt + (t0 + k) * p.dt_ss + c8 : u + (t0 + k) * p.u_ss + c8;
        cp_async16(&ud_s[stage][a][k][c8], n_in ? src : p.u, 2 * n_in);
      }
      asm volatile("cp.async.commit_group;\n" ::);
    } else {
#pragma unroll
      for (int k = 0; k < STEPS; ++k) {
        const bool in = live && t0 + k < p.S;
        ud_s[stage][0][k][tid] = in ? u[(t0 + k) * p.u_ss + tid] : uint16_t(0);
        ud_s[stage][1][k][tid] = in ? dt[(t0 + k) * p.dt_ss + tid] : uint16_t(0);
      }
    }
  };

  // The B and C element a thread stages: step tid / ST, state tid % ST, held
  // as raw bits until the stage is consumed, so no thread waits on the load early.
  const bool stager = tid < STEPS * ST;
  const int st_t = tid / ST;
  const int st_n = tid % ST;
  uint16_t pb = 0, pc = 0;
  auto prefetch_bc = [&](int t0) {
    const bool in = stager && t0 + st_t < p.S;
    pb = in ? bm[(t0 + st_t) * p.b_ss + st_n] : uint16_t(0);
    pc = in ? cm[(t0 + st_t) * p.c_ss + st_n] : uint16_t(0);
  };

  // A stage's y [STEPS, NT] from y_s to the output: 16 bytes a thread when
  // the rows are aligned, else element by element; nothing past S or Di.
  auto store_y = [&](int t0, int stage) {
    if (p.aligned) {
      for (int e = tid; e < STEPS * (NT / 8); e += NT) {
        const int k = e / (NT / 8), c8 = e % (NT / 8) * 8;
        if (t0 + k >= p.S || d0 + c8 >= p.Di) continue;
        if (d0 + c8 + 8 <= p.Di) {
          *reinterpret_cast<uint4*>(y + (t0 + k) * p.y_ss + c8) = *reinterpret_cast<const uint4*>(&y_s[stage][k][c8]);
        } else {
          for (int c = c8; c < p.Di - d0; ++c) y[(t0 + k) * p.y_ss + c] = y_s[stage][k][c];
        }
      }
    } else {
      for (int k = 0; k < STEPS && t0 + k < p.S; ++k) {
        if (live) y[(t0 + k) * p.y_ss + tid] = y_s[stage][k][tid];
      }
    }
  };

  load_ud(0, 0);
  prefetch_bc(0);
  for (int t0 = 0, cur = 0; t0 < p.S; t0 += STEPS, cur ^= 1) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // this stage's u and dt have landed; the previous stage is consumed
    if (t0 > 0) store_y(t0 - STEPS, cur ^ 1);
    if (stager) {
      b_s[st_t][st_n] = bf16_bits_to_float(pb);
      c_s[st_t][st_n] = bf16_bits_to_float(pc);
    }
    if (t0 + STEPS < p.S) {
      load_ud(t0 + STEPS, cur ^ 1);
      prefetch_bc(t0 + STEPS);
    }
    __syncthreads();

    // The decays of step k + 1 are computed while step k updates, so the
    // SFU's results are a step old when they are used.
    float e[ST];
#pragma unroll
    for (int n = 0; n < ST; ++n) e[n] = ex2_approx(__fmul_rn(bf16_bits_to_float(ud_s[cur][1][0][tid]), a2[n]));
#pragma unroll
    for (int k = 0; k < STEPS; ++k) {
      if (t0 + k >= p.S) break;  // the same for every thread of the block
      const float dtu = __fmul_rn(bf16_bits_to_float(ud_s[cur][1][k][tid]), bf16_bits_to_float(ud_s[cur][0][k][tid]));
      const float dtn = k + 1 < STEPS ? bf16_bits_to_float(ud_s[cur][1][k + 1][tid]) : 0.f;
      float yp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < ST; n += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(&b_s[k][n]);
        const float4 c4 = *reinterpret_cast<const float4*>(&c_s[k][n]);
        const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
        const float cc[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          h[n + m] = fmaf(e[n + m], h[n + m], __fmul_rn(dtu, bb[m]));
          yp[m] = fmaf(h[n + m], cc[m], yp[m]);
          if (k + 1 < STEPS) e[n + m] = ex2_approx(__fmul_rn(dtn, a2[n + m]));
        }
      }
      const float yt = __fadd_rn(__fadd_rn(yp[0], yp[1]), __fadd_rn(yp[2], yp[3]));
      const __nv_bfloat16 yb = __float2bfloat16(yt);
      y_s[cur][k][tid] = *reinterpret_cast<const uint16_t*>(&yb);
    }
  }
  __syncthreads();
  store_y((p.S - 1) / STEPS * STEPS, ((p.S - 1) / STEPS) & 1);
  if (live) {
#pragma unroll
    for (int n = 0; n < ST; ++n) p.h_out[h_off + n] = h[n];
  }
}

template <typename T, int ST>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const dim3 grid((p.Di + NT - 1) / NT, B);
    mamba_scan_bf16_kernel<ST><<<grid, NT, 0, stream>>>(p);
  } else {
    const dim3 grid((p.Di + NT - 1) / NT, B);
    mamba_scan_fwd_kernel<T, ST><<<grid, NT, 0, stream>>>(p);
  }
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
  p.aligned = 1;
  for (const void* ptr : {u, dt, static_cast<const void*>(y)}) p.aligned &= reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  for (int64_t st : {u_sb, u_ss, dt_sb, dt_ss, y_sb, y_ss}) p.aligned &= st % 8 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(St, p, B, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(St, p, B, s);
  return cudaErrorInvalidValue;
}
