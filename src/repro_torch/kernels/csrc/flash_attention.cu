// Flash attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_fwd_kernel
// (wrapped there by flash_attention_bhsd and repro.kernels.ops.flash_attention):
// causal / sliding-window GQA attention forward, softmax(q k^T Dh^-0.5 + mask) v,
// online softmax with fp32 running max m, sum l and accumulator, output in q's
// dtype. q, k, v and o are read and written in the model layout [B, S, heads, Dh]
// from the strides the wrapper passes (the head dim contiguous); query head h
// reads KV head h / (H / KV), so repeated KV heads are never materialised.
// Masking follows the TPU kernel: masked scores give p = 0 (never
// exp(NEG - NEG)), the rescale factor is 1 while a row's max is still NEG, a
// row whose sum stays 0 divides by 1, and causal masking is top-left (col <=
// row, and col > row - window with a window). KV tiles wholly above the causal
// diagonal or left of the sliding window are skipped, not masked.
//
// Two kernels, one per dtype.
//
// bfloat16: tensor cores (wgmma) fed by TMA. What bounds it on an H100: at the
// qwen3 serving shape (B=8, S=512, H=16, KV=8, Dh=128, causal) the work is
// 8.6 GFLOP against 50 MB of q, k, v and o, so the bound is the memory, ~15 us
// at 3.35 TB/s; the products alone take ~9 us at the tensor cores' 989 TFLOP/s.
// What the design does about it:
//   * One block per (64 query rows, b, h): two warpgroups, two blocks per SM.
//     Warpgroup 0 is the producer: one thread issues TMA loads
//     (cp.async.bulk.tensor, mbarrier completion) of the block's q tile once
//     and of 64-key K and V tiles into a ring of two stages. Warpgroup 1 is
//     the consumer; its warps release a stage through a second mbarrier once
//     their wgmma have read it. setmaxnreg moves registers from the producer
//     (24) to the consumer (232). kTileM = 128 gives two consumer warpgroups
//     in one block per SM and kTileN = 128 wider tiles; at S = 512 both were
//     no faster, and 128 x 128 was 14% slower at jamba's H = 64
//     (scripts/flash_tile_sweep.py, PERF.md).
//   * S = q k^T is one wgmma.mma_async per 16 of Dh, q and k both read from
//     shared memory (K-major), the 64 x 64 fp32 scores in registers. Scores
//     are scaled by Dh^-0.5 log2(e) and exponentiated with exp2f; m, l and the
//     64 x Dh fp32 accumulator stay in registers across the KV loop.
//   * P is rounded to bf16 in registers, where the score fragment already has
//     the layout of wgmma's A operand, and O += P V is wgmma in its register-A
//     form with V read from shared memory as stored, key-major with Dh
//     contiguous (the transposed, MN-major B operand). l sums the fp32 p before
//     rounding, as the TPU kernel's l does; only the P V product sees the bf16
//     P, up to 2^-9 relative error per term.
//   * Tiles are stored as TMA writes them: each box is 128, 64 or 32 bytes of
//     the head dim (64, 32 or 16 columns) by the tile's rows with the matching
//     swizzle, so Dh = 128 is two boxes per tile and Dh = 96 three; the wgmma
//     descriptors carry the same swizzle mode and step across the boxes.
//   * TMA fills rows past S with zeros; key columns >= Sk are masked like the
//     causal ones, and query rows >= Sq are not stored.
//   * Blocks run heaviest causal query tile first; within one query tile the
//     H / KV query heads that share a KV head are neighbours in the grid, so
//     their K/V tiles are served from L2.
// Left for later work: softmax of one tile overlapped with the next tile's
// wgmma (in one warpgroup, or ping-pong between two), GQA packing of a KV
// head's query heads into one block, a TMA store of O.
//
// float32: CUDA-core FMAs (no TF32: the fp32 tolerance is 2e-5). One block per
// (tile of kBlockQ query rows, b, h); each K/V tile of kBlockK keys is staged
// in shared memory as fp32; a warp owns kRowsPerWarp query rows, a lane owns
// keys (lane, lane + 32) for the scores and head-dim columns for the PV
// product; row statistics are reduced with warp shuffles.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------ float32 kernel

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
__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }

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


// ---------------------------------------------------- bfloat16 kernel (wgmma)

constexpr int kTileM = 64;   // query rows per block, 64 per consumer warpgroup (64 or 128)
constexpr int kTileN = 64;   // keys per K/V tile (64 or 128)
constexpr int kStages = 2;   // depth of the K/V ring
constexpr int kWarpgroup = 128;
constexpr int kConsumers = kTileM / 64;
constexpr int kTmaThreads = (1 + kConsumers) * kWarpgroup;  // the producer warpgroup first
constexpr int kConsumerWarps = 4 * kConsumers;
// Registers per thread after setmaxnreg: with two consumers one block fills
// the SM's 64 K registers (128 x 40 + 256 x 232); with one, two blocks do.
constexpr int kBlocksPerSM = kConsumers == 2 ? 1 : 2;
constexpr int kProducerRegs = kConsumers == 2 ? 40 : 24;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kTileM == 64 || kTileM == 128, "one or two consumer warpgroups");
static_assert(kTileN == 64 || kTileN == 128, "wgmma_ss is built for n64 and n128");

template <int DH>
struct Tile {
  // Head-dim columns per TMA box: the widest of 64, 32 and 16 that divides DH,
  // so that a box row is exactly one swizzle span of 128, 64 or 32 bytes.
  static constexpr int kCols = DH % 64 == 0 ? 64 : (DH % 32 == 0 ? 32 : 16);
  static constexpr int kBoxes = DH / kCols;
  static constexpr int kRowBytes = kCols * 2;
  static constexpr int kAtomBytes = 8 * kRowBytes;  // 8 rows: one swizzle atom
  // wgmma descriptor swizzle code: 1 = 128 B, 2 = 64 B, 3 = 32 B
  static constexpr int kSwizzle = kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
  static constexpr int kQBytes = kTileM * DH * 2;
  static constexpr int kKVBytes = kTileN * DH * 2;
  static constexpr int kBarrierBytes = 8 * (1 + 3 * kStages);  // q_full, k_full, v_full, empty
  // q, the K and V rings, the barriers, and room to align the start to 1024 B
  static constexpr int kSmemBytes = kQBytes + 2 * kStages * kKVBytes + kBarrierBytes + 1024;
  static_assert(DH % 16 == 0, "wgmma consumes 16 of Dh per instruction");
};

struct TmaParams {
  void* o;
  int64_t o_sb, o_ss, o_sh;
  int Sq, Sk, H, KV;
  int causal;
  int window;  // <= 0: no sliding window
  int n_m_tiles;
  float scale_log2;  // Dh^-0.5 log2(e)
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of this parity has completed. A wait that
// never ends is a fault of the kernel: after ~2^32 cycles (over 2 s) it traps
// rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  long long start = 0;
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == 0) start = clock64();
    else if (spins % 1024 == 0 && clock64() - start > (1ll << 32)) __trap();
  }
}

// One TMA box of a 4-D map over [B, S, heads, Dh] (coordinates innermost first).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c_d, int c_s, int c_h, int c_b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c_d), "r"(c_s), "r"(c_h), "r"(c_b), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle mode.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, int swizzle) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo & 0x3FFFF) >> 4) << 16) |
         (uint64_t((sbo & 0x3FFFF) >> 4) << 32) | (uint64_t(swizzle) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma's registers across
// the asynchronous instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// m64nNk16, bf16 in, fp32 accumulate, overloaded on N by the accumulator's
// N / 2 registers (PTX lists every one).
// wgmma_ss: A and B from shared memory, both K-major; scale_d = 0 overwrites d.
// wgmma_rs: A from registers, B from shared memory, MN-major (transposed); d += A B.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[48], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int DH>
__global__ void __launch_bounds__(kTmaThreads, kBlocksPerSM) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const TmaParams p) {
  using T = Tile<DH>;
  extern __shared__ uint8_t smem_raw[];
  // Swizzled TMA boxes and wgmma operands need 1024-byte alignment.
  const uint32_t s_q = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t s_k = s_q + T::kQBytes;                 // [kStages] K tiles
  const uint32_t s_v = s_k + kStages * T::kKVBytes;      // [kStages] V tiles
  const uint32_t bars = s_v + kStages * T::kKVBytes;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * kStages + s); };

  // Heaviest causal query tiles first; the query heads of one KV head side by side.
  const int n_bh = gridDim.x / p.n_m_tiles;
  const int bh = blockIdx.x % n_bh;
  const int m_tile = p.n_m_tiles - 1 - blockIdx.x / n_bh;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = m_tile * kTileM;

  // KV tiles this block needs: none right of its last row's diagonal, none
  // left of its first row's window. They are walked from the last down.
  const int q_last = min(q0 + kTileM, p.Sq) - 1;
  int k_begin = 0;
  int k_end = p.Sk;
  if (p.causal) {
    k_end = min(p.Sk, q_last + 1);
    if (p.window > 0) k_begin = max(0, q0 - p.window + 1);
  }
  const int n_first = k_begin / kTileN;
  const int n_last = (k_end + kTileN - 1) / kTileN - 1;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < kWarpgroup) {
    // ------------------------------------------------ producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (tid == 0) {
      mbar_expect_tx(q_full, T::kQBytes);
      for (int c = 0; c < T::kBoxes; ++c)
        tma_load(s_q + c * kTileM * T::kRowBytes, &tm_q, q_full, c * T::kCols, q0, h, b);
      for (int n = n_last, i = 0; n >= n_first; --n, ++i) {
        const int s = i % kStages;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);  // the stage's last use is released
        mbar_expect_tx(k_full(s), T::kKVBytes);
        for (int c = 0; c < T::kBoxes; ++c)
          tma_load(s_k + s * T::kKVBytes + c * kTileN * T::kRowBytes, &tm_k, k_full(s),
                   c * T::kCols, n * kTileN, kvh, b);
        mbar_expect_tx(v_full(s), T::kKVBytes);
        for (int c = 0; c < T::kBoxes; ++c)
          tma_load(s_v + s * T::kKVBytes + c * kTileN * T::kRowBytes, &tm_v, v_full(s),
                   c * T::kCols, n * kTileN, kvh, b);
      }
    }
  } else {
    // ------------------------------------------------ consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
    const int cw = tid / kWarpgroup - 1;
    const int t = tid % kWarpgroup;
    const int lane = t % 32;
    const int row_lo = q0 + cw * 64;                   // this warpgroup's first row
    const int r0 = row_lo + (t / 32) * 16 + lane / 4;  // the thread's rows: r0 and r0 + 8
    const int cq = 2 * (lane % 4);                     // its first column in each 8
    const uint32_t s_qw = s_q + cw * 64 * T::kRowBytes;

    // Accumulator fragment j holds row r0 + 8 ((j / 2) % 2), column
    // 8 (j / 4) + cq + j % 2; the scores use the same layout over kTileN keys.
    float o[DH / 2];
#pragma unroll
    for (int j = 0; j < DH / 2; ++j) o[j] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums

    mbar_wait(q_full, 0);  // also when there is no tile: q's copy must land before exit
    for (int n = n_last, i = 0; n >= n_first; --n, ++i) {
      const int s = i % kStages;
      const int parity = (i / kStages) & 1;

      // S = q k^T
      float sc[kTileN / 2];
      mbar_wait(k_full(s), parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int box = kk * 16 / T::kCols;
        const int col_bytes = (kk * 16 % T::kCols) * 2;
        const uint64_t da = smem_desc(s_qw + box * kTileM * T::kRowBytes + col_bytes, 16,
                                      T::kAtomBytes, T::kSwizzle);
        const uint64_t db = smem_desc(s_k + s * T::kKVBytes + box * kTileN * T::kRowBytes + col_bytes,
                                      16, T::kAtomBytes, T::kSwizzle);
        wgmma_ss(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // Scale into the log2 domain; mask only tiles that cross an edge.
      const int col0 = n * kTileN;
      const bool edge = col0 + kTileN > p.Sk ||
                        (p.causal && (col0 + kTileN - 1 > row_lo ||
                                      (p.window > 0 && col0 <= row_lo + 63 - p.window)));
      if (edge) {
#pragma unroll
        for (int j = 0; j < kTileN / 2; ++j) {
          const int col = col0 + 8 * (j / 4) + cq + (j % 2);
          const int row = r0 + 8 * ((j / 2) % 2);
          bool ok = col < p.Sk;
          if (p.causal) ok = ok && col <= row && (p.window <= 0 || col > row - p.window);
          sc[j] = ok ? sc[j] * p.scale_log2 : kNegInf;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kTileN / 2; ++j) sc[j] *= p.scale_log2;
      }

      // Online softmax. A row's kTileN scores lie on the 4 threads of a quad.
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int nb = 0; nb < kTileN / 8; ++nb)
          mx = fmaxf(mx, fmaxf(sc[4 * nb + 2 * r], sc[4 * nb + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        alpha[r] = m[r] > 0.5f * kNegInf ? exp2f(m[r] - m_new) : 1.f;
        m[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int nb = 0; nb < kTileN / 8; ++nb) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 4 * nb + 2 * r + e;
            sc[j] = sc[j] > 0.5f * kNegInf ? exp2f(sc[j] - m_new) : 0.f;
            sum += sc[j];
          }
        }
        l[r] = alpha[r] * l[r] + sum;
      }
#pragma unroll
      for (int j = 0; j < DH / 2; ++j) o[j] *= alpha[(j / 2) % 2];

      // P in bf16 as wgmma's A fragments, 16 keys each.
      uint32_t pa[kTileN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTileN / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      // O += P V
      mbar_wait(v_full(s), parity);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTileN / 16; ++kk) {
        const uint64_t db = smem_desc(s_v + s * T::kKVBytes + kk * 16 * T::kRowBytes,
                                      kTileN * T::kRowBytes, T::kAtomBytes, T::kSwizzle);
        wgmma_rs(o, pa[kk], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));  // this warp has read the stage
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lt = l[r];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      inv[r] = 1.f / (lt == 0.f ? 1.f : lt);
    }
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= p.Sq) continue;
#pragma unroll
      for (int nb = 0; nb < DH / 8; ++nb)
        *reinterpret_cast<__nv_bfloat162*>(out + row * p.o_ss + 8 * nb + cq) =
            __floats2bfloat162_rn(o[4 * nb + 2 * r] * inv[r], o[4 * nb + 2 * r + 1] * inv[r]);
    }
  }
}

typedef CUresult (*TensorMapEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                         const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                         const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                         CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not the runtime: look its address up
// through the runtime so that the library needs no link against libcuda.
TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<TensorMapEncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D map over x [B, S, heads, DH] (bf16, strides in elements), dims
// innermost first (DH, S, heads, B), boxes of kCols x rows with the swizzle
// that matches the box width.
template <int DH>
bool encode_map(TensorMapEncodeTiled encode, CUtensorMap* map, const void* x, int B, int S, int heads,
                int64_t sb, int64_t ss, int64_t sh, int rows) {
  using T = Tile<DH>;
  const cuuint64_t dims[4] = {cuuint64_t(DH), cuuint64_t(S), cuuint64_t(heads), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(ss) * 2, cuuint64_t(sh) * 2, cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {cuuint32_t(T::kCols), cuuint32_t(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = T::kSwizzle == 1   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : T::kSwizzle == 2 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                        : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  if (!encode_map<DH>(encode, &tq, p.q, p.B, p.Sq, p.H, p.q_sb, p.q_ss, p.q_sh, kTileM) ||
      !encode_map<DH>(encode, &tk, p.k, p.B, p.Sk, p.KV, p.k_sb, p.k_ss, p.k_sh, kTileN) ||
      !encode_map<DH>(encode, &tv, p.v, p.B, p.Sk, p.KV, p.v_sb, p.v_ss, p.v_sh, kTileN))
    return cudaErrorInvalidValue;
  TmaParams tp;
  tp.o = p.o;
  tp.o_sb = p.o_sb; tp.o_ss = p.o_ss; tp.o_sh = p.o_sh;
  tp.Sq = p.Sq; tp.Sk = p.Sk; tp.H = p.H; tp.KV = p.KV;
  tp.causal = p.causal; tp.window = p.window;
  tp.n_m_tiles = (p.Sq + kTileM - 1) / kTileM;
  tp.scale_log2 = p.scale * kLog2e;
  const int64_t blocks = int64_t(tp.n_m_tiles) * p.B * p.H;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const int smem = Tile<DH>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_wgmma_kernel<DH><<<unsigned(blocks), kTmaThreads, smem, stream>>>(tq, tk, tv, tp);
  return cudaGetLastError();
}

cudaError_t dispatch_fp32(int dh, const Params& p, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<float, 16>(p, stream);
    case 32: return launch<float, 32>(p, stream);
    case 64: return launch<float, 64>(p, stream);
    case 96: return launch<float, 96>(p, stream);
    case 128: return launch<float, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_bf16(int dh, const Params& p, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch_wgmma<16>(p, stream);
    case 32: return launch_wgmma<32>(p, stream);
    case 64: return launch_wgmma<64>(p, stream);
    case 96: return launch_wgmma<96>(p, stream);
    case 128: return launch_wgmma<128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head dim is
// contiguous. For bfloat16, q, k and v must start on 16 bytes and their other
// strides be multiples of 8 elements (TMA). Returns the cudaError_t of the
// launch (0 on success).
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
  if (dtype == 0) return dispatch_fp32(Dh, p, s);
  if (dtype == 1) return dispatch_bf16(Dh, p, s);
  return cudaErrorInvalidValue;
}
