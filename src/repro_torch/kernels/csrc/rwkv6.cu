// RWKV6 (Finch) WKV recurrence, forward, for Hopper (sm_90a), CUDA C++ on the
// CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6.py::_rwkv6_kernel (wrapped
// there by rwkv6_bhsd and repro.kernels.ops.rwkv6). Per (b, h), from the fp32
// state S0 [Dh, Dh] (zero when none is given), for t = 0 .. S-1:
//   out_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j]  = exp(logw_t[i]) * S[i][j] + k_t[i] * v_t[j]
// out in r's dtype and the final S in fp32. All arithmetic is fp32 with expf:
// no TF32, no tensor cores.
//
// Design. The TPU kernel's chunked closed form (L = 16 steps as small MXU
// products with exp(+-cumsum log w) factors) is the TPU's reshaping of a
// per-timestep loop; this kernel is that loop.
//   * One block per (b, h), or per (b, h, half of the value columns) when
//     Dh > 64, so that a block has at most 256 threads. Value columns of S
//     evolve independently: SPLIT threads share column j, each holding
//     Dh / SPLIT rows of S[:, j] in registers. The SPLIT partial sums of
//     out_t[j] sit in adjacent lanes and are reduced with two shuffles.
//   * Registers are capped so that two blocks fit on an SM: the loop is
//     latency-bound and runs faster with the second block's warps beside the
//     first's. Dh > 64 stages 8 steps at a time instead of 16, so that its
//     larger state slice fits under that cap.
//   * The bonus term factors as v_t[j] * sum_i r_t[i] u[i] k_t[i], one scalar
//     per step, reduced once per step while the step is staged.
//   * STEPS time steps of r, k, exp(logw) and v are staged in shared memory
//     per pair of __syncthreads. The next stage's global loads go into
//     registers before the current stage is computed, so they overlap it.
//     A stage's outputs are gathered in shared memory and written row by row.
//   * Each thread reads its rows of r, k and exp(logw) as float4; the staged
//     rows give each thread's slice 4 floats of padding, so the four slices a
//     warp reads lie in distinct banks.
//   * r, k, v, logw and out are read and written in the model layout
//     [B, S, H, Dh] from the strides the wrapper passes (the head dim
//     contiguous), so the wrapper makes no transposed copies.
//   * Any S: the time loop stops at S, so a ragged tail needs no padding and
//     no mask. No exp(+-cumsum) appears, so fp32 range needs neither the
//     MAX_DECAY clamp nor short chunks.
//
// What bounds it on an H100. At the serving shape (B=8, S=512, H=32, Dh=64,
// bf16) the function moves 92.3 MB (r, k, v, logw and out in bf16, S0 and S in
// fp32), 27.5 us at 3.35 TB/s; the TPU kernel's chunked products come to
// 2.68 GFLOP, 40 us at the CUDA cores' 67 TFLOP/s, which sets the bound. This
// loop issues 3 fp32 instructions per (i, j) per step (an FMA into out, a
// multiply and an FMA into S), 1.6 G at the serving shape, so instruction
// issue on the CUDA cores bounds it, above the 40 us. The chunked form on the
// tensor cores (mma.sync, then wgmma) and value columns split across more
// blocks are left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {


struct Params {
  const void* r;
  const void* k;
  const void* v;
  const void* w;    // logw
  const void* u;    // [H, Dh], float32 or bfloat16 (u_bf16)
  const float* s0;  // [B, H, Dh, Dh] contiguous, or null for a zero state
  void* o;
  float* s_out;     // [B, H, Dh, Dh] contiguous
  int64_t r_sb, r_ss, r_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t w_sb, w_ss, w_sh;
  int64_t o_sb, o_ss, o_sh;
  int B, S, H;
  int u_bf16;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16(x); }

template <int DH>
struct Tile {
  static constexpr int SPLIT = 4;                      // threads per value column
  static constexpr int COLS = DH > 64 ? DH / 2 : DH;  // value columns per block
  static constexpr int NT = SPLIT * COLS;             // threads per block
  static constexpr int STEPS = DH > 64 ? 8 : 16;      // time steps staged per stage
};

template <typename T, int DH>
__global__ void __launch_bounds__(Tile<DH>::NT, 2) rwkv6_fwd_kernel(Params p) {
  constexpr int COLS = Tile<DH>::COLS;
  constexpr int NT = Tile<DH>::NT;
  constexpr int STEPS = Tile<DH>::STEPS;
  constexpr int NCB = DH / COLS;         // column blocks per (b, h)
  constexpr int SPLIT = Tile<DH>::SPLIT;
  constexpr int RP = DH / SPLIT;         // rows of S[:, j] per thread
  constexpr int RS = DH + 4 * SPLIT;     // staged row: each thread's slice padded by 4 floats
  constexpr int PER = STEPS * DH / NT;  // staged elements per thread per array
  constexpr int W = DH < 32 ? DH : 32;   // lanes that stage one row's piece
  constexpr int NW = DH / W;             // partial sums of the bonus scalar per step
  static_assert(RP % 4 == 0 && (SPLIT & (SPLIT - 1)) == 0 && 32 % SPLIT == 0 && DH % W == 0 && (STEPS * DH) % NT == 0 && NT % 32 == 0,
                "unsupported head dim");

  __shared__ __align__(16) float r_s[STEPS][RS];
  __shared__ __align__(16) float k_s[STEPS][RS];
  __shared__ __align__(16) float w_s[STEPS][RS];
  __shared__ float v_s[STEPS][DH];
  __shared__ float o_s[STEPS][COLS];
  __shared__ float a_s[STEPS][NW];
  __shared__ float u_s[DH];

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x % NCB * COLS;  // the block's first value column
  const int j = c0 + tid / SPLIT;          // the thread's value column
  const int q = tid % SPLIT;               // which RP rows of it
  const int bh = blockIdx.x / NCB;
  const int h = bh % p.H;
  const int b = bh / p.H;
  const T* r = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* w = static_cast<const T*>(p.w) + b * p.w_sb + h * p.w_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int64_t s_off = int64_t(bh) * DH * DH;

  float st[RP];
#pragma unroll
  for (int m = 0; m < RP; ++m) st[m] = p.s0 ? p.s0[s_off + (q * RP + m) * DH + j] : 0.f;
  if (tid < DH) {  // NT >= DH
    u_s[tid] = p.u_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.u)[h * DH + tid])
                        : static_cast<const float*>(p.u)[h * DH + tid];
  }

  // Element n of a thread's share of a stage: step e / DH, head-dim index e % DH.
  float pr[PER], pk[PER], pv[PER], pw[PER];
  auto prefetch = [&](int t0) {
#pragma unroll
    for (int n = 0; n < PER; ++n) {
      const int e = tid + n * NT;
      const int t = t0 + e / DH;
      const int i = e % DH;
      const bool in = t < p.S;
      pr[n] = in ? to_float(r[t * p.r_ss + i]) : 0.f;
      pk[n] = in ? to_float(k[t * p.k_ss + i]) : 0.f;
      pv[n] = in ? to_float(v[t * p.v_ss + i]) : 0.f;
      pw[n] = in ? to_float(w[t * p.w_ss + i]) : 0.f;
    }
  };
  // The 32 elements a warp stages lie in one row (DH >= 32) or in two rows of
  // 16 (DH = 16); the bonus scalar's partial sums reduce within W lanes.
  auto stage = [&]() {
#pragma unroll
    for (int n = 0; n < PER; ++n) {
      const int e = tid + n * NT;
      const int t = e / DH;
      const int i = e % DH;
      const int pi = (i / RP) * (RP + 4) + i % RP;
      r_s[t][pi] = pr[n];
      k_s[t][pi] = pk[n];
      w_s[t][pi] = expf(pw[n]);
      v_s[t][i] = pv[n];
      float a = pr[n] * u_s[i] * pk[n];
#pragma unroll
      for (int off = W / 2; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
      if (i % W == 0) a_s[t][i / W] = a;
    }
  };
  auto flush = [&](int t0, int n_steps) {
    for (int e = tid; e < n_steps * COLS; e += NT) {
      const int t = e / COLS;
      const int c = e % COLS;
      store(&o[(t0 + t) * p.o_ss + c0 + c], o_s[t][c]);
    }
  };

  prefetch(0);
  for (int t0 = 0; t0 < p.S; t0 += STEPS) {
    const int n_steps = min(STEPS, p.S - t0);
    __syncthreads();  // the previous stage is consumed (and u_s is written)
    if (t0 > 0) flush(t0 - STEPS, STEPS);
    stage();
    __syncthreads();
    if (t0 + STEPS < p.S) prefetch(t0 + STEPS);

    for (int tt = 0; tt < n_steps; ++tt) {
      const float vj = v_s[tt][j];
      const float* rr = &r_s[tt][q * (RP + 4)];
      const float* kk = &k_s[tt][q * (RP + 4)];
      const float* ww = &w_s[tt][q * (RP + 4)];
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int m = 0; m < RP; m += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(rr + m);
        const float4 k4 = *reinterpret_cast<const float4*>(kk + m);
        const float4 w4 = *reinterpret_cast<const float4*>(ww + m);
        acc.x = fmaf(r4.x, st[m + 0], acc.x);
        acc.y = fmaf(r4.y, st[m + 1], acc.y);
        acc.z = fmaf(r4.z, st[m + 2], acc.z);
        acc.w = fmaf(r4.w, st[m + 3], acc.w);
        st[m + 0] = fmaf(w4.x, st[m + 0], k4.x * vj);
        st[m + 1] = fmaf(w4.y, st[m + 1], k4.y * vj);
        st[m + 2] = fmaf(w4.z, st[m + 2], k4.z * vj);
        st[m + 3] = fmaf(w4.w, st[m + 3], k4.w * vj);
      }
      float part = (acc.x + acc.y) + (acc.z + acc.w);
#pragma unroll
      for (int off = 1; off < SPLIT; off <<= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      float a = 0.f;
#pragma unroll
      for (int c = 0; c < NW; ++c) a += a_s[tt][c];
      if (q == 0) o_s[tt][j - c0] = fmaf(vj, a, part);
    }
  }
  __syncthreads();
  const int last = (p.S - 1) / STEPS * STEPS;
  flush(last, p.S - last);
#pragma unroll
  for (int m = 0; m < RP; ++m) p.s_out[s_off + (q * RP + m) * DH + j] = st[m];
}

template <typename T, int DH>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  rwkv6_fwd_kernel<T, DH><<<p.B * p.H * (DH / Tile<DH>::COLS), Tile<DH>::NT, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dh, const Params& p, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 96: return launch<T, 96>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of r, k, v, logw and out) and u_dtype: 0 = float32, 1 = bfloat16.
// state0 may be null (zero initial state). Strides are in elements; the head
// dim is contiguous. Returns the cudaError_t of the launch (0 on success).
extern "C" int rwkv6_fwd(
    const void* r, const void* k, const void* v, const void* logw, int dtype,
    const void* u, int u_dtype, const float* state0, void* out, float* state_out,
    int B, int S, int H, int Dh,
    int64_t r_sb, int64_t r_ss, int64_t r_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t w_sb, int64_t w_ss, int64_t w_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh,
    void* stream) {
  if (u_dtype != 0 && u_dtype != 1) return cudaErrorInvalidValue;
  Params p;
  p.r = r; p.k = k; p.v = v; p.w = logw; p.u = u; p.s0 = state0;
  p.o = out; p.s_out = state_out;
  p.r_sb = r_sb; p.r_ss = r_ss; p.r_sh = r_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.w_sb = w_sb; p.w_ss = w_ss; p.w_sh = w_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.B = B; p.S = S; p.H = H; p.u_bf16 = u_dtype;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(Dh, p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(Dh, p, s);
  return cudaErrorInvalidValue;
}
