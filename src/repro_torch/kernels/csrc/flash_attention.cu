// Forward flash attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention_bhsd`, body `_kernel`): online-softmax attention with
// f32 scores, running max, running denominator and accumulator; GQA query
// head h reads kv head h / group; causal and sliding-window masks from
// absolute positions with q_offset = Skv - Sq and the mask value -1e30;
// kv tiles that are wholly masked are never visited.
//
// What bounds it on this card. At serving shapes (yi-9b prefill: B=8,
// H=32, K=4, S=512, D=128, bf16) one call moves about 75 MB (23 us at
// 3.35 TB/s) and its visible (query, key) pairs need 1.7e10 FLOPs (17 us at
// the dense bf16 tensor-core peak): bytes, with operations close behind,
// so both products have to run on the tensor cores and the loads have to
// overlap them.
//
// Two kernels; the wrapper (kernels/flash_attention.py, `variant`) picks
// one by type, head dim and layout before the launch.
//  * fa_fwd_wgmma_kernel<D>, bf16 with D in {64, 128} and operands TMA can
//    describe. One block of three warpgroups per (batch*head, 128-query
//    tile). A producer warp loads the query tile once and then the key and
//    value tiles (64 keys) into a ring of 2 shared-memory stages by TMA,
//    each through a 4-D tensor map over the caller's (B, S, heads, D)
//    strides, so BSHD is read in place with no transpose and no GQA copy;
//    D = 128 comes as two 64-column panels (the 128-byte swizzle's limit).
//    Two consumer warpgroups own 64 query rows each: S = Q K^T by wgmma
//    m64n64k16 from shared memory (K K-major), the mask and the online
//    softmax on the S accumulator in registers (a row's max and sum over the
//    4 lanes that hold it, exp2 with the scale folded in), P rounded to bf16
//    and fed back as wgmma's register A operand of O += P V (m64nDk16, V
//    MN-major through the transpose-B bit), O in f32 registers. A row's
//    denominator is summed from the unrounded weights, as the plain version
//    does before its own rounding. Each consumer skips the tiles wholly
//    masked for its rows but releases every stage. setmaxnreg moves
//    registers from the producer (24) to the consumers (240).
//  * fa_fwd_kernel<T, D>, f32 and head dims 16 and 32 (and layouts TMA
//    cannot take): f32 arithmetic on the CUDA cores. One block of 256
//    threads per (batch*head, 64-query tile) loops over 32-key tiles held
//    in shared memory as f32; each thread owns four query rows, so their
//    softmax state stays in registers.
// Both cut the kv tile range to the causal and window bounds before the
// loop and mask keys past Skv and queries past Sq inside it, so no length
// has to divide a tile size; causal query tiles are launched heaviest
// first to even out the tail of the grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 32;   // keys per inner tile
constexpr int NT = 256;  // threads per block: a 16 x 16 grid
constexpr float NEG_INF = -1e30f;  // the JAX package's mask value

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int b, h, kvh, sq, skv;
  // element strides of (batch, seq, head); the last dim is contiguous
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal, window;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) + size_t(BK) * D +
                          size_t(BQ) * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) fa_fwd_kernel(const Params p) {
  constexpr int DP = D + 1;
  constexpr int BKP = BK + 1;
  constexpr int DJ = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;           // BQ x DP
  float* Ks = Qs + BQ * DP;   // BK x DP
  float* Vs = Ks + BK * DP;   // BK x D
  float* Ps = Vs + BK * D;    // BQ x BKP

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bi = blockIdx.x / p.h;
  const int hi = blockIdx.x % p.h;
  const int kvi = hi / (p.h / p.kvh);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int q_offset = p.skv - p.sq;

  const T* qg = static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + bi * p.k_sb + kvi * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + bi * p.v_sb + kvi * p.v_sh;
  T* og = static_cast<T*>(p.o) + bi * p.o_sb + hi * p.o_sh;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e % D;
    const int qi = q0 + r;
    Qs[r * DP + d] = qi < p.sq ? to_f32(qg[qi * p.q_ss + d]) : 0.f;
  }

  // keys any real query of this tile can see
  const int q_first = q0 + q_offset;
  const int q_last = min(q0 + BQ, p.sq) - 1 + q_offset;
  int k_begin = 0, k_end = p.skv;
  if (p.causal) k_end = min(k_end, q_last + 1);
  if (p.window) k_begin = max(k_begin, q_first - p.window + 1);
  const int t_begin = k_begin / BK;
  const int t_end = k_end > k_begin ? (k_end + BK - 1) / BK : t_begin;

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's Ks, Vs and Ps are no longer read
    for (int e = tid; e < BK * D; e += NT) {
      const int c = e / D, d = e % D;
      const int ki = k0 + c;
      const bool in = ki < p.skv;
      Ks[c * DP + d] = in ? to_f32(kg[ki * p.k_ss + d]) : 0.f;
      Vs[c * D + d] = in ? to_f32(vg[ki * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r + q_offset;
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (kpos >= p.skv) {
          x = -INFINITY;  // past the ragged edge: weight exactly 0
        } else {
          const int delta = qpos - kpos;
          const bool ok = (!p.causal || delta >= 0) && (!p.window || delta < p.window);
          if (!ok) x = NEG_INF;
        }
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
      rmax = row_max16(rmax);
      const float m_new = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float pj = expf(s[i][j] - m_new);
        Ps[r * BKP + tx + 16 * j] = pj;
        rsum += pj;
      }
      rsum = row_sum16(rsum);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * BKP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) og[qi * p.o_ss + tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(fa_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.b * p.h, (p.sq + BQ - 1) / BQ);
  fa_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int head_dim, const Params& p, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------ bf16, wgmma

namespace wg {

constexpr int BQ = 128, BKV = 64, STAGES = 2, THREADS = 384;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int PANELS = D / 64;             // 64-column panels of a row
  static constexpr int Q_PANEL = BQ * 128;          // bytes of one query panel
  static constexpr int KV_PANEL = BKV * 128;        // bytes of one key or value panel
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;  // one K (or V) tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int SMEM = Q_BYTES + STAGES * STAGE_BYTES + 1024;  // + alignment slack
};

}  // namespace wg

template <int D>
__global__ void __launch_bounds__(wg::THREADS, 1)
    fa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                        const __grid_constant__ CUtensorMap tmk,
                        const __grid_constant__ CUtensorMap tmv, const Params p) {
  // local names hide the f32 kernel's tile constants of the same names
  constexpr int BQ = wg::BQ, BKV = wg::BKV, STAGES = wg::STAGES;
  using L = wg::Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[STAGES], empty[STAGES];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = smem;
  uint8_t* KVs = smem + L::Q_BYTES;  // stage s: K at s * STAGE_BYTES, V after it

  const int bi = blockIdx.x / p.h;
  const int hi = blockIdx.x % p.h;
  const int kvi = hi / (p.h / p.kvh);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int q_offset = p.skv - p.sq;

  // the kv tiles any real query of this block can see
  const int q_first = q0 + q_offset;
  const int q_last = min(q0 + BQ, p.sq) - 1 + q_offset;
  int k_begin = 0, k_end = p.skv;
  if (p.causal) k_end = min(k_end, q_last + 1);
  if (p.window) k_begin = max(k_begin, q_first - p.window + 1);
  const int t_begin = k_begin / BKV;
  const int t_end = k_end > k_begin ? (k_end + BKV - 1) / BKV : t_begin;
  const int role = threadIdx.x / 128;  // 0: producer, 1 and 2: consumers

  if (threadIdx.x == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (role == 0) {
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(&q_full, L::Q_BYTES);
#pragma unroll
      for (int j = 0; j < L::PANELS; ++j)
        hopper::tma_load_4d(Qs + j * L::Q_PANEL, &tmq, &q_full, j * 64, q0, hi, bi);
      for (int t = t_begin; t < t_end; ++t) {
        const int n = t - t_begin, stage = n % STAGES;
        const uint32_t phase = (n / STAGES) & 1;
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* ks = KVs + stage * L::STAGE_BYTES;
        uint8_t* vs = ks + L::KV_BYTES;
        hopper::mbar_arrive_expect_tx(&full[stage], L::STAGE_BYTES);
#pragma unroll
        for (int j = 0; j < L::PANELS; ++j) {
          hopper::tma_load_4d(ks + j * L::KV_PANEL, &tmk, &full[stage], j * 64, t * BKV, kvi, bi);
          hopper::tma_load_4d(vs + j * L::KV_PANEL, &tmv, &full[stage], j * 64, t * BKV, kvi, bi);
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<240>();
    const int c = role - 1;  // query rows 64c .. 64c + 63 of the block
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int my_q0 = q0 + 64 * c;
    const int my_first = my_q0 + q_offset;
    const int my_last = min(my_q0 + 64, p.sq) - 1 + q_offset;
    // this warpgroup's own kv range (empty if all its rows lie past Sq)
    int my_begin = 0, my_end = 0;
    if (my_q0 < p.sq) {
      my_end = p.skv;
      if (p.causal) my_end = min(my_end, my_last + 1);
      if (p.window) my_begin = max(my_begin, my_first - p.window + 1);
    }
    const int r0 = warp * 16 + (lane >> 2);  // this thread's rows: r0 and r0 + 8
    const int qpos0 = my_q0 + r0 + q_offset;
    const float scale = p.scale * wg::LOG2E;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    hopper::mbar_wait(&q_full, 0);
    const uint8_t* qs = Qs + c * 64 * 128;
    for (int t = t_begin; t < t_end; ++t) {
      const int n = t - t_begin, stage = n % STAGES;
      const uint32_t phase = (n / STAGES) & 1;
      const int k0 = t * BKV;
      hopper::mbar_wait(&full[stage], phase);
      if (k0 < my_end && k0 + BKV > my_begin) {
        const uint8_t* ks = KVs + stage * L::STAGE_BYTES;
        const uint8_t* vs = ks + L::KV_BYTES;
        float s[BKV / 2];
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) s[i] = 0.f;
        hopper::fence_operands(s);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_m64n64k16_ss<0>(
              s, hopper::desc_kmajor(qs + (kk / 4) * L::Q_PANEL + (kk % 4) * 32),
              hopper::desc_kmajor(ks + (kk / 4) * L::KV_PANEL + (kk % 4) * 32), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operands(s);

        // scale, mask, online softmax; d[i] sits at row r0 + 8 ((i / 2) % 2),
        // column 8 (i / 4) + 2 (lane % 4) + i % 2
        const bool whole = k0 + BKV <= p.skv && (!p.causal || k0 + BKV - 1 <= my_first) &&
                           (!p.window || k0 >= my_last - p.window + 1);
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
          float x = s[i] * scale;
          if (!whole) {
            const int kpos = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
            const int delta = qpos0 + 8 * ((i >> 1) & 1) - kpos;
            if (kpos >= p.skv) {
              x = -INFINITY;  // past the ragged edge: weight exactly 0
            } else if ((p.causal && delta < 0) || (p.window && delta >= p.window)) {
              x = NEG_INF;
            }
          }
          s[i] = x;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
        }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          corr[r] = exp2f(m[r] - m_new);
          m[r] = m_new;
          l[r] *= corr[r];
        }
        uint32_t pa[BKV / 16][4];
#pragma unroll
        for (int i = 0; i < BKV / 2; i += 2) {
          const int r = (i >> 1) & 1;
          const float p0 = exp2f(s[i] - m[r]);
          const float p1 = exp2f(s[i + 1] - m[r]);
          l[r] += p0 + p1;
          __nv_bfloat162 pk = __floats2bfloat162_rn(p0, p1);
          pa[i / 8][(i % 8) / 2] = *reinterpret_cast<uint32_t*>(&pk);
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

        hopper::fence_operands(o);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          if constexpr (D == 128)
            hopper::wgmma_m64n128k16_rs<1>(o, pa[kk],
                                           hopper::desc_mnmajor(vs + kk * 2048, L::KV_PANEL), 1);
          else
            hopper::wgmma_m64n64k16_rs<1>(o, pa[kk],
                                          hopper::desc_mnmajor(vs + kk * 2048, L::KV_PANEL), 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operands(o);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[stage]);
    }

    // a row's denominator: the sum over the 4 lanes that hold it
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + bi * p.o_sb + hi * p.o_sh;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int r = (i >> 1) & 1;
      const int qi = my_q0 + r0 + 8 * r;
      const int col = 8 * (i >> 2) + 2 * (lane & 3);
      if (qi < p.sq)
        *reinterpret_cast<__nv_bfloat162*>(og + qi * p.o_ss + col) =
            __floats2bfloat162_rn(o[i] * inv[r], o[i + 1] * inv[r]);
    }
  }
}

template <int D>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  using L = wg::Layout<D>;
  CUtensorMap tmq, tmk, tmv;
  const uint64_t q_dims[4] = {uint64_t(D), uint64_t(p.sq), uint64_t(p.h), uint64_t(p.b)};
  const uint64_t q_strides[3] = {uint64_t(p.q_ss) * 2, uint64_t(p.q_sh) * 2, uint64_t(p.q_sb) * 2};
  const uint32_t q_box[4] = {64, wg::BQ, 1, 1};
  const uint64_t kv_dims[4] = {uint64_t(D), uint64_t(p.skv), uint64_t(p.kvh), uint64_t(p.b)};
  const uint64_t k_strides[3] = {uint64_t(p.k_ss) * 2, uint64_t(p.k_sh) * 2, uint64_t(p.k_sb) * 2};
  const uint64_t v_strides[3] = {uint64_t(p.v_ss) * 2, uint64_t(p.v_sh) * 2, uint64_t(p.v_sb) * 2};
  const uint32_t kv_box[4] = {64, wg::BKV, 1, 1};
  int err = hopper::encode_bf16_map(&tmq, p.q, 4, q_dims, q_strides, q_box);
  if (!err) err = hopper::encode_bf16_map(&tmk, p.k, 4, kv_dims, k_strides, kv_box);
  if (!err) err = hopper::encode_bf16_map(&tmv, p.v, 4, kv_dims, v_strides, kv_box);
  if (err) return err;
  cudaError_t cerr = cudaFuncSetAttribute(fa_fwd_wgmma_kernel<D>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (cerr != cudaSuccess) return int(cerr);
  const dim3 grid(p.b * p.h, (p.sq + wg::BQ - 1) / wg::BQ);
  fa_fwd_wgmma_kernel<D><<<grid, wg::THREADS, L::SMEM, stream>>>(tmq, tmk, tmv, p);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// kernel: 0 = fa_fwd_kernel in f32, 1 = fa_fwd_kernel in bf16,
// 2 = fa_fwd_wgmma_kernel (bf16, head_dim 64 or 128, q, k, v
// TMA-describable: 16-byte-aligned bases and (batch, seq, head) strides
// that are multiples of 8 elements; the wrapper checks this before it picks
// the kernel). strides: q, k, v, o, each as (batch, seq, head) element
// strides. Returns cudaGetLastError() after the launch (0 on success), or a
// negative hopper:: code if a tensor map was refused.
int repro_flash_attention_fwd(int kernel, int head_dim, const void* q, const void* k,
                              const void* v, void* o, int b, int h, int kvh, int sq, int skv,
                              const long long* strides, float scale, int causal, int window,
                              void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.b = b; p.h = h; p.kvh = kvh; p.sq = sq; p.skv = skv;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.scale = scale; p.causal = causal; p.window = window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kernel == 0) return int(dispatch_d<float>(head_dim, p, st));
  if (kernel == 1) return int(dispatch_d<__nv_bfloat16>(head_dim, p, st));
  if (kernel == 2 && b > 0 && h > 0 && kvh > 0 && sq > 0 && skv > 0) {
    if (head_dim == 64) return launch_wgmma<64>(p, st);
    if (head_dim == 128) return launch_wgmma<128>(p, st);
  }
  return int(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int err) { return hopper::error_string(err); }

}  // extern "C"
