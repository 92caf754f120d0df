// RWKV6 (Finch) WKV recurrence, forward, for Hopper (sm_90a), CUDA C++:
// bf16 on the tensor cores (mma.sync), fp32 on the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6.py::_rwkv6_kernel (wrapped
// there by rwkv6_bhsd and repro.kernels.ops.rwkv6). Per (b, h), from the fp32
// state S0 [Dh, Dh] (zero when none is given), for t = 0 .. S-1:
//   out_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j]  = exp(logw_t[i]) * S[i][j] + k_t[i] * v_t[j]
// out in r's dtype and the final S in fp32.
//
// bf16 (rwkv6_chunk_kernel), what serving runs: the TPU kernel's closed form
// over chunks of L = 16 steps (rwkv6.py:41-71). Per chunk, with la the
// inclusive cumsum of logw over the chunk (taken in log2 units, so every
// factor is one exp2):
//   q_ = r e^(la - lw),  k_ = k e^(-la),  kd = k e^(la_last - la)
//   out = (strict_lower(q_ k_^T) + diag(sum_i r u k)) v + q_ S
//   S  <- diag(e^la_last) S + kd^T v
//   * The four products run as warp-level mma.sync.m16n8k16 (bf16 in, fp32
//     accumulate). wgmma's smallest M is 64, and a chunk has 16 rows: it
//     would waste three quarters of every instruction.
//   * Everything is computed transposed, with M the value columns: an mma
//     warp owns 16 value columns j and holds S^T [16 j x Dh i] in fp32
//     accumulator registers across all chunks. The accumulator fragment of
//     S^T is, pair for pair, the A fragment of the read-out S^T q_^T, and the
//     fragment of the 16 x 16 scores that of the B operand A^T of v^T A^T, so
//     neither goes through shared memory. The decay is a per-column scale of
//     the S^T registers.
//   * Warp-specialised: kPrepWarps warps load chunks c + 1 and c + 2 by
//     cp.async (16 bytes a thread) into a kStages ring in shared memory and
//     prepare chunk c: the cumsum (a pair of key rows over a few steps a
//     thread, the partial sums scanned with shuffles), the exponentials, the
//     hi/lo splits and the bonus scalars' partial sums, in fp32 on the CUDA
//     cores and the SFU. Meanwhile the mma warps run chunk c - 1's products,
//     the 16 x 16 scores included. One __syncthreads a chunk hands a prepared
//     chunk over (double-buffered).
//   * Value columns evolve independently, so a (b, h) may be split over
//     blocks of kColsPerBlock columns, each recomputing the factors and the
//     scores for its slice; the sweep (scripts/scan_sweep.py) kept all 64
//     columns of a head in one block: the factors are the longer half.
//   * Precision. r, k and v are bf16, but q_, k_, kd, the scores and S are
//     fp32 values that an operand would round to bf16, 2^-9 relative a term.
//     At S=512 that breaks the out bar (2e-2) by 3-6x and the state bar
//     (3e-3) by 1.6x (tests/test_torch_scan_emulation.py), so every fp32
//     operand is split into a bf16 hi + lo pair: fp32 x fp32 products
//     (q_ k_^T, q_ S) take three mma (hi hi, hi lo, lo hi), products with v
//     (exact in bf16) two; ~2^-16 relative a term, 68 mma a warp a chunk at
//     Dh = 64.
//   * Loads come from the model layout [B, S, H, Dh] through the strides
//     the wrapper passes; tensors that are not 16-byte aligned are loaded
//     element by element. The tail chunk is zero-filled (logw = 0,
//     r = k = v = 0), so la_last is that of the last real step and S is
//     untouched by the padding; rows >= S are not stored. A warp's [16, 16]
//     tile of out is gathered in shared memory and stored 16 bytes a lane.
//   * Range: with the model's clamp (MAX_DECAY = 4) e^(-la) reaches at most
//     e^64 within a chunk, inside bf16's and fp32's exponent range; no clamp
//     is added that the reference does not have.
//
// fp32 (rwkv6_fwd_kernel<float>), unchanged since its port: the per-timestep
// loop on the CUDA cores with expf, no TF32. One block per (b, h), or per
// (b, h, half of the value columns) when Dh > 64; SPLIT threads share value
// column j, each holding Dh / SPLIT rows of S[:, j] in registers; registers
// capped so that two blocks fit on an SM; the bonus term factors as v_t[j]
// times the scalar sum_i r u k, reduced once per step while the step is
// staged; STEPS steps of r, k, exp(logw) and v staged in shared memory per
// pair of __syncthreads with the next stage prefetched into registers; any
// S with no padding. It issues 3 fp32 instructions per (i, j) per step,
// 1.6 G at the serving shape, so instruction issue bounds it.
//
// What bounds it on an H100. At the serving shape (B=8, S=512, H=32, Dh=64,
// bf16) the function moves 92.3 MB (r, k, v, logw and out in bf16, S0 and S
// in fp32), 27.5 us at 3.35 TB/s, which sets the bound: the four products
// (2.68 GFLOP) take 2.7 us at the tensor cores' 989 TFLOP/s, six times that
// with the hi/lo passes. What the bf16 kernel runs into is each block's
// serial chain of 32 chunks: per chunk the prep warps' factors and the mma
// warps' dependent products, joined by a barrier.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

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
  int aligned;  // r, k, v, logw start on 16 bytes and their strides are multiples of 8 elements
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }

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


// ---------------------------------------------------------------- bf16: chunked form on the tensor cores

constexpr int kChunk = 16;         // steps per chunk, the TPU kernel's L
constexpr int kColsPerBlock = 64;  // value columns a block owns, one mma warp each 16 (scripts/scan_sweep.py)
constexpr int kPrepWarps = 4;      // warps that load and prepare the next chunk (scripts/scan_sweep.py)
constexpr int kStages = 4;         // raw chunks in the ring: read by the mma warps, prepared, two in flight
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct ChunkTile {
  static constexpr int cols() {
    int c = DH < kColsPerBlock ? DH : kColsPerBlock;
    while (DH % c) c -= 16;
    return c;
  }
  static constexpr int COLS = cols();       // value columns per block
  static constexpr int MW = COLS / 16;      // mma warps
  static constexpr int NTP = 32 * kPrepWarps;
  static constexpr int NT = 32 * MW + NTP;
  static constexpr int NCB = DH / COLS;     // blocks per (b, h)
  static constexpr int group() {
    int g = 1;
    while (g < 8 && 2 * g * (DH / 2) <= NTP) g *= 2;
    return g;
  }
  static constexpr int G = group();         // prep threads per pair of key rows in the factors' pass
  static constexpr int RS = DH + 8;         // row stride of a bf16 [16, Dh] tile
  static constexpr int KS = 24;             // row stride of a bf16 [Dh, 16] tile (kd transposed)
  static constexpr int TILE = kChunk * RS;
  // one prepared chunk: q_ and k_ hi, lo [16][RS]; kd^T hi, lo [Dh][KS] (bf16); e^la_last [Dh];
  // the bonus scalars' partial sums, one row of 16 a prep warp
  static constexpr int BUF = (4 * TILE + 2 * DH * KS) * 2 + (DH + kPrepWarps * kChunk) * 4;
  // raw r, k, v, logw per stage; two prepared chunks; u; a [16][16] bf16 tile of out per mma warp
  static constexpr int SMEM = kStages * 4 * TILE * 2 + 2 * BUF + DH * 4 + MW * kChunk * 16 * 2;
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values as bf16 pairs: hi = their rounding, lo = the rounding of the rest; x in the low half.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float2 ld_bf16x2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void st_u32(__nv_bfloat16* p, uint32_t x) { *reinterpret_cast<uint32_t*>(p) = x; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }
template <int N>
__device__ __forceinline__ void prep_barrier() { asm volatile("bar.sync 1, %0;\n" ::"n"(N)); }

// One prepared chunk in shared memory.
template <int DH>
struct Prepared {
  __nv_bfloat16 *qh, *ql, *kh, *kl, *kdh, *kdl;
  float *dec, *diag;
  __device__ explicit Prepared(unsigned char* base) {
    using Tile = ChunkTile<DH>;
    qh = reinterpret_cast<__nv_bfloat16*>(base);
    ql = qh + Tile::TILE;
    kh = ql + Tile::TILE;
    kl = kh + Tile::TILE;
    kdh = kl + Tile::TILE;
    kdl = kdh + DH * Tile::KS;
    dec = reinterpret_cast<float*>(kdl + DH * Tile::KS);
    diag = dec + DH;
  }
};

// Warp-specialised: kPrepWarps warps load chunks c + 1 and c + 2 (cp.async)
// and prepare chunk c (its factors and bonus scalars, in fp32 on the CUDA
// cores and the SFU) while the mma warps run chunk c - 1's products on the
// tensor cores; one __syncthreads a chunk hands the prepared chunk over.
template <int DH>
__global__ void __launch_bounds__(ChunkTile<DH>::NT) rwkv6_chunk_kernel(Params p) {
  using Tile = ChunkTile<DH>;
  constexpr int NTP = Tile::NTP, RS = Tile::RS, KS = Tile::KS, TILE = Tile::TILE;
  constexpr int MW = Tile::MW, G = Tile::G, TPT = kChunk / G;  // the factors' pass: steps per thread
  constexpr int NTI = DH / 8;                                   // n-tiles of S^T (8 key rows each)
  static_assert(DH % 16 == 0 && Tile::COLS % 16 == 0 && TPT % 2 == 0, "unsupported head dim");

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* raw = reinterpret_cast<__nv_bfloat16*>(smem);  // [kStages][r, k, v, logw][16][RS]
  unsigned char* bufs = smem + kStages * 4 * TILE * 2;            // two prepared chunks
  float* u_s = reinterpret_cast<float*>(bufs + 2 * Tile::BUF);    // [Dh]
  uint16_t* o_s = reinterpret_cast<uint16_t*>(u_s + DH);          // [MW][16 t][16 j], bf16 bits

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int cb = blockIdx.x % Tile::NCB;
  const int bh = blockIdx.x / Tile::NCB;
  const int h = bh % p.H;
  const int b = bh / p.H;
  const int64_t s_off = int64_t(bh) * DH * DH;
  const int n_chunks = (p.S + kChunk - 1) / kChunk;

  for (int i = tid; i < DH; i += Tile::NT) {
    u_s[i] = p.u_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.u)[h * DH + i])
                      : static_cast<const float*>(p.u)[h * DH + i];
  }

  if (warp >= MW) {
    // ------------------------------------------------------------ prep warps
    const int ptid = tid - 32 * MW, pw = ptid / 32;
    // Chunk c's four [16, Dh] tiles (r, k, v, logw) into ring stage c % kStages, zero past S.
    auto load_tile = [&](__nv_bfloat16* dst, const void* base, int64_t sb, int64_t sh, int64_t ss, int t0) {
      const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(base) + b * sb + h * sh;
      if (p.aligned) {
        for (int e = ptid; e < kChunk * (DH / 8); e += NTP) {
          const int t = e / (DH / 8), c8 = e % (DH / 8) * 8;
          const bool in = t0 + t < p.S;
          cp_async16(dst + t * RS + c8, in ? src + (t0 + t) * ss + c8 : src, in ? 16 : 0);
        }
      } else {
        for (int e = ptid; e < kChunk * DH; e += NTP) {
          const int t = e / DH, i = e % DH;
          dst[t * RS + i] = t0 + t < p.S ? src[(t0 + t) * ss + i] : __float2bfloat16_rn(0.f);
        }
      }
    };
    auto load = [&](int c) {
      if (c < n_chunks) {
        __nv_bfloat16* dst = raw + (c % kStages) * 4 * TILE;
        const int t0 = c * kChunk;
        load_tile(dst, p.r, p.r_sb, p.r_sh, p.r_ss, t0);
        load_tile(dst + TILE, p.k, p.k_sb, p.k_sh, p.k_ss, t0);
        load_tile(dst + 2 * TILE, p.v, p.v_sb, p.v_sh, p.v_ss, t0);
        load_tile(dst + 3 * TILE, p.w, p.w_sb, p.w_sh, p.w_ss, t0);
      }
      cp_async_commit();  // a group per chunk, empty past the end
    };

    for (int c = 0; c < kStages - 2; ++c) load(c);
    for (int c = 0; c <= n_chunks; ++c) {
      __syncthreads();  // the mma warps are done with chunk c - 2 (its buffer, its ring stage)
      if (c == n_chunks) break;
      load(c + kStages - 2);
      cp_async_wait<kStages - 2>();
      prep_barrier<NTP>();  // chunk c has landed for every prep thread
      const __nv_bfloat16* rt = raw + (c % kStages) * 4 * TILE;
      const __nv_bfloat16* kt = rt + TILE;
      const __nv_bfloat16* wt = rt + 3 * TILE;
      Prepared<DH> out(bufs + (c % 2) * Tile::BUF);

      // The factors, in log2 units. A thread takes a pair of key rows (i, i + 1)
      // over TPT consecutive steps; the G threads of a pair are adjacent lanes
      // and scan their partial sums of logw with shuffles. Each thread also
      // sums r u k over its rows for the bonus scalars of its steps.
      float bonus[TPT] = {};
      for (int pp0 = 0; pp0 < DH / 2; pp0 += NTP / G) {  // one pass whenever G > 1
        const int pp = pp0 + ptid / G, q = ptid % G;
        const bool valid = pp < DH / 2;
        const int i = valid ? 2 * pp : 0, tb = q * TPT;
        float la0[TPT], la1[TPT], a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int t = 0; t < TPT; ++t) {
          const float2 w = ld_bf16x2(wt + (tb + t) * RS + i);
          a0 = __fadd_rn(a0, __fmul_rn(w.x, kLog2e));
          a1 = __fadd_rn(a1, __fmul_rn(w.y, kLog2e));
          la0[t] = a0;
          la1[t] = a1;
        }
        float s0 = a0, s1 = a1;  // inclusive scan over the pair's G threads
#pragma unroll
        for (int off = 1; off < G; off <<= 1) {
          const float n0 = __shfl_up_sync(0xffffffffu, s0, off, G);
          const float n1 = __shfl_up_sync(0xffffffffu, s1, off, G);
          if (q >= off) {
            s0 = __fadd_rn(n0, s0);
            s1 = __fadd_rn(n1, s1);
          }
        }
        float base0 = __shfl_up_sync(0xffffffffu, s0, 1, G), base1 = __shfl_up_sync(0xffffffffu, s1, 1, G);
        if (q == 0) base0 = base1 = 0.f;
        const float last0 = __shfl_sync(0xffffffffu, s0, G - 1, G);
        const float last1 = __shfl_sync(0xffffffffu, s1, G - 1, G);
        float kd0[TPT], kd1[TPT];
#pragma unroll
        for (int t = 0; t < TPT; ++t) {
          const float p0 = t ? __fadd_rn(base0, la0[t - 1]) : base0;  // la - lw: the exclusive cumsum
          const float p1 = t ? __fadd_rn(base1, la1[t - 1]) : base1;
          const float l0 = __fadd_rn(base0, la0[t]), l1 = __fadd_rn(base1, la1[t]);
          const int at = (tb + t) * RS + i;
          const float2 r = ld_bf16x2(rt + at), k = ld_bf16x2(kt + at);
          if (valid) bonus[t] += r.x * u_s[i] * k.x + r.y * u_s[i + 1] * k.y;
          uint32_t hi, lo;
          split2(__fmul_rn(r.x, ex2_approx(p0)), __fmul_rn(r.y, ex2_approx(p1)), hi, lo);
          if (valid) st_u32(out.qh + at, hi), st_u32(out.ql + at, lo);
          split2(__fmul_rn(k.x, ex2_approx(-l0)), __fmul_rn(k.y, ex2_approx(-l1)), hi, lo);
          if (valid) st_u32(out.kh + at, hi), st_u32(out.kl + at, lo);
          kd0[t] = __fmul_rn(k.x, ex2_approx(__fsub_rn(last0, l0)));
          kd1[t] = __fmul_rn(k.y, ex2_approx(__fsub_rn(last1, l1)));
        }
#pragma unroll
        for (int t = 0; t < TPT; t += 2) {
          uint32_t hi, lo;
          split2(kd0[t], kd0[t + 1], hi, lo);
          if (valid) st_u32(out.kdh + i * KS + tb + t, hi), st_u32(out.kdl + i * KS + tb + t, lo);
          split2(kd1[t], kd1[t + 1], hi, lo);
          if (valid) st_u32(out.kdh + (i + 1) * KS + tb + t, hi), st_u32(out.kdl + (i + 1) * KS + tb + t, lo);
        }
        if (valid && q == G - 1) {
          out.dec[i] = ex2_approx(last0);
          out.dec[i + 1] = ex2_approx(last1);
        }
      }
      // The bonus sums over the warp's row pairs: lanes with the same q hold the same steps.
#pragma unroll
      for (int off = G; off < 32; off <<= 1) {
#pragma unroll
        for (int t = 0; t < TPT; ++t) bonus[t] += __shfl_xor_sync(0xffffffffu, bonus[t], off);
      }
      if (lane < G) {
#pragma unroll
        for (int t = 0; t < TPT; ++t) out.diag[pw * kChunk + lane * TPT + t] = bonus[t];
      }
    }
    cp_async_wait<0>();
    return;
  }

  // -------------------------------------------------------------- mma warps
  const int g = lane / 4, tq = lane % 4;  // the mma fragment's row group and thread in group
  const int j0 = cb * Tile::COLS + warp * 16;  // the warp's first value column
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;

  // S^T [16 j x Dh i] of the warp's columns, as accumulator fragments: n-tile
  // nt, element e holds j = j0 + g + 8 (e / 2), i = 8 nt + 2 tq + e % 2.
  float st[NTI][4];
#pragma unroll
  for (int nt = 0; nt < NTI; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + g + 8 * (e / 2), i = 8 * nt + 2 * tq + e % 2;
      st[nt][e] = p.s0 ? p.s0[s_off + int64_t(i) * DH + j] : 0.f;
    }
  }

  auto ld32 = [](const __nv_bfloat16* base, int row, int stride, int col) {
    return *reinterpret_cast<const uint32_t*>(base + row * stride + col);
  };
  for (int c = 0; c <= n_chunks; ++c) {
    __syncthreads();  // chunk c - 1 is prepared
    if (c == 0) continue;
    const int cc = c - 1;
    const __nv_bfloat16* vt = raw + (cc % kStages) * 4 * TILE + 2 * TILE;
    const Prepared<DH> in(bufs + (cc % 2) * Tile::BUF);
    auto vbits = [&](int t, int j) { return uint32_t(*reinterpret_cast<const uint16_t*>(vt + t * RS + j)); };
    // v^T as the A operand (rows j, k = steps t), exact in bf16.
    uint32_t va[4];
    va[0] = vbits(2 * tq, j0 + g) | vbits(2 * tq + 1, j0 + g) << 16;
    va[1] = vbits(2 * tq, j0 + g + 8) | vbits(2 * tq + 1, j0 + g + 8) << 16;
    va[2] = vbits(2 * tq + 8, j0 + g) | vbits(2 * tq + 9, j0 + g) << 16;
    va[3] = vbits(2 * tq + 8, j0 + g + 8) | vbits(2 * tq + 9, j0 + g + 8) << 16;

    // scores [16 t x 16 s] = q_ k_^T and out^T [16 j x 16 t] += S^T q_^T over Dh in steps of 16;
    // the hi hi terms and the corrections in separate accumulators, for shorter dependent chains.
    float sc[2][4] = {}, sx[2][4] = {}, oc[2][4] = {}, ox[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int c0 = 16 * kk + 2 * tq;
      // q_ as A (rows t); its registers are also q_^T's B fragments of n-tiles t < 8 ([0], [2]) and t >= 8 ([1], [3]).
      const uint32_t qh4[4] = {ld32(in.qh, g, RS, c0), ld32(in.qh, g + 8, RS, c0), ld32(in.qh, g, RS, c0 + 8),
                               ld32(in.qh, g + 8, RS, c0 + 8)};
      const uint32_t ql4[4] = {ld32(in.ql, g, RS, c0), ld32(in.ql, g + 8, RS, c0), ld32(in.ql, g, RS, c0 + 8),
                               ld32(in.ql, g + 8, RS, c0 + 8)};
#pragma unroll
      for (int ns = 0; ns < 2; ++ns) {
        const uint32_t kh0 = ld32(in.kh, 8 * ns + g, RS, c0), kh1 = ld32(in.kh, 8 * ns + g, RS, c0 + 8);
        const uint32_t kl0 = ld32(in.kl, 8 * ns + g, RS, c0), kl1 = ld32(in.kl, 8 * ns + g, RS, c0 + 8);
        mma_bf16(sc[ns], qh4, kh0, kh1);
        mma_bf16(sx[ns], qh4, kl0, kl1);
        mma_bf16(sx[ns], ql4, kh0, kh1);
      }
      uint32_t sa_h[4], sa_l[4];  // S^T's fragments as the A operand, k = key rows 16 kk ..
      split2(st[2 * kk][0], st[2 * kk][1], sa_h[0], sa_l[0]);
      split2(st[2 * kk][2], st[2 * kk][3], sa_h[1], sa_l[1]);
      split2(st[2 * kk + 1][0], st[2 * kk + 1][1], sa_h[2], sa_l[2]);
      split2(st[2 * kk + 1][2], st[2 * kk + 1][3], sa_h[3], sa_l[3]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        mma_bf16(oc[nt], sa_h, qh4[nt], qh4[nt + 2]);
        mma_bf16(ox[nt], sa_h, ql4[nt], ql4[nt + 2]);
        mma_bf16(ox[nt], sa_l, qh4[nt], qh4[nt + 2]);
      }
    }
    // Strictly lower triangle plus the bonus on the diagonal; element e of
    // n-tile ns is t = g + 8 (e / 2), s = 8 ns + 2 tq + e % 2.
#pragma unroll
    for (int ns = 0; ns < 2; ++ns) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = g + 8 * (e / 2), s_ = 8 * ns + 2 * tq + e % 2;
        float bonus = 0.f;
        if (s_ == t) {
#pragma unroll
          for (int w = 0; w < kPrepWarps; ++w) bonus += in.diag[w * kChunk + t];
        }
        sc[ns][e] = s_ < t ? sc[ns][e] + sx[ns][e] : bonus;
      }
    }
    // out^T += v^T A^T: A^T's B fragment of n-tile nt (t = 8 nt + g) is the
    // scores' elements 2 nt, 2 nt + 1 of both s-tiles.
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      uint32_t b0h, b0l, b1h, b1l;
      split2(sc[0][2 * nt], sc[0][2 * nt + 1], b0h, b0l);
      split2(sc[1][2 * nt], sc[1][2 * nt + 1], b1h, b1l);
      mma_bf16(oc[nt], va, b0h, b1h);
      mma_bf16(ox[nt], va, b0l, b1l);
    }
    // out [t][j]: element e of n-tile nt is j = g + 8 (e / 2), t = 8 nt + 2 tq + e % 2; gathered
    // in the warp's [16 t][16 j] tile, then stored 16 bytes a lane (out is the wrapper's, aligned).
    uint16_t* ow = o_s + warp * kChunk * 16;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat16 x = __float2bfloat16_rn(oc[nt][e] + ox[nt][e]);
        ow[(8 * nt + 2 * tq + e % 2) * 16 + g + 8 * (e / 2)] = *reinterpret_cast<const uint16_t*>(&x);
      }
    }
    __syncwarp();
    const int t = cc * kChunk + lane / 2;
    if (t < p.S) {
      *reinterpret_cast<uint4*>(o + t * p.o_ss + j0 + 8 * (lane % 2)) =
          *reinterpret_cast<const uint4*>(ow + (lane / 2) * 16 + 8 * (lane % 2));
    }
    __syncwarp();
    // S^T <- S^T diag(e^la_last) + v^T kd, kd's B fragment from kd^T [i][t].
#pragma unroll
    for (int nt = 0; nt < NTI; ++nt) {
      const int i0 = 8 * nt + 2 * tq;
      const float d0 = in.dec[i0], d1 = in.dec[i0 + 1];
      st[nt][0] *= d0;
      st[nt][1] *= d1;
      st[nt][2] *= d0;
      st[nt][3] *= d1;
      mma_bf16(st[nt], va, ld32(in.kdh, 8 * nt + g, KS, 2 * tq), ld32(in.kdh, 8 * nt + g, KS, 2 * tq + 8));
      mma_bf16(st[nt], va, ld32(in.kdl, 8 * nt + g, KS, 2 * tq), ld32(in.kdl, 8 * nt + g, KS, 2 * tq + 8));
    }
  }

#pragma unroll
  for (int nt = 0; nt < NTI; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + g + 8 * (e / 2), i = 8 * nt + 2 * tq + e % 2;
      p.s_out[s_off + int64_t(i) * DH + j] = st[nt][e];
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using CT = ChunkTile<DH>;
    if (CT::SMEM > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          rwkv6_chunk_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, CT::SMEM);
      if (err != cudaSuccess) return err;
    }
    rwkv6_chunk_kernel<DH><<<p.B * p.H * CT::NCB, CT::NT, CT::SMEM, stream>>>(p);
  } else {
    rwkv6_fwd_kernel<T, DH><<<p.B * p.H * (DH / Tile<DH>::COLS), Tile<DH>::NT, 0, stream>>>(p);
  }
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
  p.aligned = 1;
  for (const void* ptr : {r, k, v, logw}) p.aligned &= reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  for (int64_t st : {r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, w_sb, w_ss, w_sh}) {
    p.aligned &= st % 8 == 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(Dh, p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(Dh, p, s);
  return cudaErrorInvalidValue;
}
