// Flash attention forward for Hopper (sm_90a), CUDA C++ on the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_fwd_kernel
// (wrapped there by flash_attention_bhsd and repro.kernels.ops.flash_attention):
// causal / sliding-window GQA attention forward, softmax(q k^T Dh^-0.5 + mask) v,
// online softmax with fp32 running max m, sum l and accumulator, output in q's dtype.
//
// Design. The TPU grid's sequential KV axis becomes a loop inside one block.
//   * One block per (tile of kBlockQ query rows, b, h); query head h reads KV
//     head h / (H / KV), so repeated KV heads are never materialised.
//   * q, k, v and o are read and written in the model layout [B, S, heads, Dh]
//     from the strides the wrapper passes (the head dim must be contiguous), so
//     the wrapper makes no transposed copies.
//   * Each K/V tile of kBlockK keys is staged in shared memory as fp32.
//   * A warp owns kRowsPerWarp query rows. For the scores a lane owns keys
//     (lane, lane + 32); for the PV product a lane owns head-dim columns
//     (lane, lane + 32, ...). Row statistics are reduced with warp shuffles.
//   * Masked scores give p = 0 (never exp(NEG - NEG)); a row whose sum stays 0
//     divides by 1, as the TPU kernel does. Tiles wholly above the causal
//     diagonal or left of the sliding window are skipped, not masked.
//
// What bounds it on an H100. At the serving shape (B=8, S=512, H=16, KV=8,
// Dh=128, bf16, causal) the work is 2 S^2 Dh flops per (b, h), ~8.6 GFLOP,
// against ~50 MB of q, k, v and o: the bound is the memory, ~15 us at 3.35 TB/s.
// This kernel is far from that bound: it does its products with fp32 FMAs on
// the CUDA cores (67 TFLOP/s, not the tensor cores' 989), stages tiles with
// plain loads and no double buffering, and reads each K/V tile once per query
// tile. Tensor cores (wgmma), TMA loads into a ring of tiles and warp
// specialisation are left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerWarp = 4;  // one float4 of q (or p) feeds all of a warp's rows
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = kRowsPerWarp * kWarps;
constexpr int kBlockK = 64;
constexpr int kKeysPerLane = kBlockK / 32;
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF

static_assert(kRowsPerWarp == 4, "q_s and p_s are read as float4");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int B, Sq, Sk, H, KV;
  int causal;
  int window;  // <= 0: no sliding window
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

constexpr size_t smem_floats(int dh) {
  return size_t(kBlockK) * (dh + 1)            // k_s, rows padded by one
         + size_t(kBlockK) * dh                // v_s
         + size_t(kWarps) * dh * kRowsPerWarp  // q_s
         + size_t(kWarps) * kBlockK * kRowsPerWarp;  // p_s
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  constexpr int R = kRowsPerWarp;
  constexpr int KS = DH + 1;             // padded K row: the 32 lanes of a warp read 32 banks
  constexpr int DPL = (DH + 31) / 32;    // head-dim columns per lane in the PV product
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [kBlockK][KS]
  float* v_s = k_s + kBlockK * KS;                // [kBlockK][DH]
  float* q_s = v_s + kBlockK * DH;                // [kWarps][DH][R]
  float* p_s = q_s + kWarps * DH * R;             // [kWarps][kBlockK][R]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // Heaviest causal tiles (largest q0) first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KV);
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < kBlockQ * DH; i += kThreads) {
    const int row_local = i / DH;
    const int d = i % DH;
    const int row = q0 + row_local;
    const int w = row_local / R;
    const int r = row_local % R;
    q_s[(w * DH + d) * R + r] = row < p.Sq ? to_float(q[row * p.q_ss + d]) : 0.f;
  }

  // KV tiles this block needs: none right of its last row's diagonal, none
  // left of its first row's window.
  const int q_last = min(q0 + kBlockQ, p.Sq) - 1;
  int k_begin = 0;
  int k_end = p.Sk;
  if (p.causal) {
    k_end = min(p.Sk, q_last + 1);
    if (p.window > 0) k_begin = max(0, q0 - p.window + 1);
  }
  const int t_begin = k_begin / kBlockK;
  const int t_end = (k_end + kBlockK - 1) / kBlockK;

  float m[R], l[R], acc[R][DPL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int kt0 = t * kBlockK;
    __syncthreads();  // the previous tile is consumed (and q_s is staged)
    for (int i = tid; i < kBlockK * DH; i += kThreads) {
      const int j = i / DH;
      const int d = i % DH;
      const int key = kt0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < p.Sk) {
        kx = to_float(k[key * p.k_ss + d]);
        vx = to_float(v[key * p.v_ss + d]);
      }
      k_s[j * KS + d] = kx;
      v_s[j * DH + d] = vx;
    }
    __syncthreads();

    // Scores for this warp's R rows against the lane's keys.
    float s[R][kKeysPerLane];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 qd = *reinterpret_cast<const float4*>(&q_s[(warp * DH + d) * R]);
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        const float kd = k_s[(lane + 32 * c) * KS + d];
        s[0][c] = fmaf(qd.x, kd, s[0][c]);
        s[1][c] = fmaf(qd.y, kd, s[1][c]);
        s[2][c] = fmaf(qd.z, kd, s[2][c]);
        s[3][c] = fmaf(qd.w, kd, s[3][c]);
      }
    }

    // Online softmax, one row at a time.
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = q0 + warp * R + r;
      float sc[kKeysPerLane];
      bool ok[kKeysPerLane];
      float tile_max = kNegInf;
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        const int col = kt0 + lane + 32 * c;
        bool valid = col < p.Sk;
        if (p.causal) {
          valid = valid && col <= row;
          if (p.window > 0) valid = valid && col > row - p.window;
        }
        ok[c] = valid;
        sc[c] = valid ? s[r][c] * p.scale : kNegInf;
        tile_max = fmaxf(tile_max, sc[c]);
      }
      const float m_new = fmaxf(m[r], warp_max(tile_max));
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        const float pc = ok[c] ? expf(sc[c] - m_new) : 0.f;
        psum += pc;
        p_s[(warp * kBlockK + lane + 32 * c) * R + r] = pc;
      }
      psum = warp_sum(psum);
      const float alpha = m[r] > 0.5f * kNegInf ? expf(m[r] - m_new) : 1.f;
      l[r] = alpha * l[r] + psum;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
    }
    __syncwarp();

    // acc += p v over the tile's keys; the lane owns columns lane + 32 i.
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      const float4 pj = *reinterpret_cast<const float4*>(&p_s[(warp * kBlockK + j) * R]);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (DH % 32 == 0 || d < DH) {
          const float vd = v_s[j * DH + d];
          acc[0][i] = fmaf(pj.x, vd, acc[0][i]);
          acc[1][i] = fmaf(pj.y, vd, acc[1][i]);
          acc[2][i] = fmaf(pj.z, vd, acc[2][i]);
          acc[3][i] = fmaf(pj.w, vd, acc[3][i]);
        }
      }
    }
    __syncwarp();  // p_s is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = q0 + warp * R + r;
    if (row >= p.Sq) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (DH % 32 == 0 || d < DH) store(&o[row * p.o_ss + d], acc[r][i] / denom);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_floats(DH) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, p.B * p.H);
  flash_fwd_kernel<T, DH><<<grid, kThreads, smem, stream>>>(p);
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

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head dim is
// contiguous. Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int Sq, int Sk, int H, int KV, int Dh,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int causal, int window, float scale, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.H = H; p.KV = KV;
  p.causal = causal; p.window = window; p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(Dh, p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(Dh, p, s);
  return cudaErrorInvalidValue;
}
