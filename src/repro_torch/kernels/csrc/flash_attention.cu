// Forward flash attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention_bhsd`, body `_kernel`): online-softmax attention with
// f32 scores, running max, running denominator and accumulator; GQA query
// head h reads kv head h / group; causal and sliding-window masks from
// absolute positions with q_offset = Skv - Sq; kv tiles that are wholly
// masked are never visited.
//
// What bounds it on this card. At serving shapes (yi-9b prefill: B=8,
// H=32, K=4, S=512, D=128, bf16) one call moves about 75 MB and does about
// 1.7e10 causal FLOPs, so on tensor cores it would be bound by memory
// (about 23 us at 3.35 TB/s). This first version does its arithmetic in
// f32 on the CUDA cores (67 TFLOP/s peak), where the same FLOPs take at
// least 0.26 ms: it is bound by operations, and tensor cores (wgmma), TMA
// and a load pipeline are left for a later version.
//
// What the design does about it. One block of 256 threads per
// (batch*head, 64-query tile); a loop inside the block over 32-key tiles
// takes the place of the TPU grid's sequential kv axis. The query tile and
// one kv tile sit in shared memory as f32 (rows padded by one word so the
// column reads of the 16x16 thread grid hit distinct banks). Each thread
// owns four query rows (ty + 16 i) for both products, so its running max,
// denominator and accumulator (4 x D/16 values) stay in registers, and a
// row's max and sum are reduced over the 16 lanes that share it with warp
// shuffles. K and V are addressed through strides, so the caller's BSHD
// tensors are read in place with no transpose and no GQA expansion copy.
// The tile range is cut to the causal and window bounds before the loop,
// and keys past Skv and queries past Sq are masked inside, so no length
// has to divide a tile size. Causal query tiles are launched heaviest
// first to even out the tail of the grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: q, k, v, o, each as
// (batch, seq, head) element strides. Returns cudaGetLastError() after the
// launch (0 on success).
int repro_flash_attention_fwd(int dtype, int head_dim, const void* q, const void* k,
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
  if (dtype == 0) return int(dispatch_d<float>(head_dim, p, st));
  if (dtype == 1) return int(dispatch_d<__nv_bfloat16>(head_dim, p, st));
  return int(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
