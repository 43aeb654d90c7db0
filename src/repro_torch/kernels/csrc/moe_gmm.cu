// Grouped (per-expert) matmul for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gmm.py
// (`grouped_matmul`, body `_kernel`): out[e] = x[e] @ w[e] for every expert
// e, x (E, T, D), w (E, D, F), out (E, T, F), with an f32 accumulator over
// the whole of D and the result cast once to the inputs' type. The TPU
// kernel walks D as the innermost grid axis, carrying the sum in a VMEM
// scratch tile from one grid step to the next; here one block owns one
// (expert, T tile, F tile) output tile and walks D in a loop of its own,
// with the sum in registers, so nothing carries over between blocks.
//
// What bounds it on this card: operations. At mixtral-8x22b's prefill
// shape (E 8, T 1312, D 6144, F 16384) one call is 2*E*T*D*F = 2.11e12
// FLOPs, 2.14 ms at the dense bf16 tensor-core peak, while its bytes
// (x, w and out once each, 2.1 GB) take 0.62 ms at 3.35 TB/s.
//
// What the design does about it.
//  * bf16: tensor cores through PTX `mma.sync` m16n8k16 (bf16 operands,
//    f32 accumulation). A block of 8 warps owns a 128 x 128 output tile;
//    each warp a 64 x 32 part of it, 4 x 4 mma tiles held in registers.
//    D is walked in steps of 32: the x and w tiles of the next step are
//    loaded from device memory into registers while the tensor cores work
//    on the current step's tiles in shared memory (read with `ldmatrix`,
//    w through its transposing form, so w is used in its stored row-major
//    layout). Rows of shared memory are padded so that `ldmatrix` reads
//    no bank twice.
//  * f32: FMA on the CUDA cores in full f32 (no TF32: the tests hold f32
//    to 1e-4 * D), a 64 x 64 tile per block, 4 x 4 outputs per thread.
//  * Blocks are ordered with the T tiles fastest, so the blocks that share
//    one w tile run together and read it from L2: w, the largest operand,
//    comes from device memory about once.
//  * Ragged T, D and F are masked in the loads (zeros) and the stores, so
//    every shape runs; 16-byte loads are used where the wrapper says rows
//    are 16-byte aligned, element loads elsewhere.
// wgmma, TMA, a multi-stage shared-memory pipeline and a persistent grid
// are left for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
  const void* x;     // (e, t, d), last dim contiguous
  const void* w;     // (e, d, f), last dim contiguous
  void* out;         // (e, t, f), last dim contiguous
  int e, t, d, f;
  long long sxe, sxt;  // strides in elements
  long long swe, swd;
  long long soe, sot;
  int vec_x, vec_w;  // rows of x / w may be read 16 bytes at a time
};

// ------------------------------------------------------------------ f32

constexpr int F_BM = 64, F_BN = 64, F_BK = 16, F_NT = 256;

__global__ void __launch_bounds__(F_NT) gmm_f32_kernel(Params p) {
  __shared__ float As[F_BK][F_BM + 4];  // As[k][m]
  __shared__ float Bs[F_BK][F_BN + 4];  // Bs[k][n]
  const int e = blockIdx.z;
  const int m0 = blockIdx.x * F_BM, n0 = blockIdx.y * F_BN;
  const float* x = static_cast<const float*>(p.x) + e * p.sxe;
  const float* w = static_cast<const float*>(p.w) + e * p.swe;
  float* o = static_cast<float*>(p.out) + e * p.soe;
  const int tid = threadIdx.x;
  const int tm = (tid / 16) * 4, tn = (tid % 16) * 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.d; k0 += F_BK) {
    for (int i = tid; i < F_BM * F_BK; i += F_NT) {
      const int r = i / F_BK, c = i % F_BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < p.t && gk < p.d) ? x[gm * p.sxt + gk] : 0.f;
    }
    for (int i = tid; i < F_BK * F_BN; i += F_NT) {
      const int r = i / F_BN, c = i % F_BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < p.d && gn < p.f) ? w[gk * p.swd + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[kk][tm + i];
        b[i] = Bs[kk][tn + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + tm + i;
    if (gm >= p.t) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tn + j;
      if (gn < p.f) o[gm * p.sot + gn] = acc[i][j];
    }
  }
}

// ----------------------------------------------------------------- bf16

constexpr int BM = 128, BN = 128, BK = 32, NT = 256;
constexpr int AS = BK + 8;  // row stride of the x tile in shared memory (80 bytes)
constexpr int BS = BN + 8;  // row stride of the w tile (272 bytes)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Eight bf16 values from row `row` of a (rows, cols) operand, starting at
// column c0; zeros outside it. One 16-byte load when the row is aligned
// for it and all eight lie inside.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* base, long long stride, int row,
                                       int rows, int c0, int cols, int vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows) return v;
  const __nv_bfloat16* src = base + row * stride + c0;
  if (vec && c0 + 8 <= cols) return *reinterpret_cast<const uint4*>(src);
  __nv_bfloat16 tmp[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) tmp[i] = (c0 + i < cols) ? src[i] : __float2bfloat16_rn(0.f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = __bfloat16_as_ushort(tmp[2 * i]);
    const uint32_t hi = __bfloat16_as_ushort(tmp[2 * i + 1]);
    (&v.x)[i] = lo | (hi << 16);
  }
  return v;
}

__global__ void __launch_bounds__(NT) gmm_bf16_kernel(Params p) {
  __shared__ __align__(16) __nv_bfloat16 As[BM * AS];  // x tile, As[m][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[BK * BS];  // w tile, Bs[k][n]
  const int e = blockIdx.z;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x) + e * p.sxe;
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w) + e * p.swe;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.out) + e * p.soe;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64;  // the warp's rows in the tile
  const int wn = (warp & 3) * 32;   // and its columns

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  // Each tile is 512 chunks of 8 values, two a thread. x chunk c: row c/4,
  // columns (c%4)*8; w chunk c: row c/16, columns (c%16)*8.
  uint4 ra[2], rb[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * NT;
      ra[i] = load8(x, p.sxt, m0 + c / 4, p.t, k0 + (c % 4) * 8, p.d, p.vec_x);
      const int kr = k0 + c / 16;
      rb[i] = load8(w + n0, p.swd, kr, p.d, (c % 16) * 8, p.f - n0, p.vec_w);
    }
  };

  load(0);
  for (int k0 = 0; k0 < p.d; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * NT;
      *reinterpret_cast<uint4*>(&As[(c / 4) * AS + (c % 4) * 8]) = ra[i];
      *reinterpret_cast<uint4*>(&Bs[(c / 16) * BS + (c % 16) * 8]) = rb[i];
    }
    __syncthreads();
    if (k0 + BK < p.d) load(k0 + BK);  // in flight while the tensor cores work
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const int r = lane & 7, j = lane >> 3;
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(a[mt], &As[(wm + mt * 16 + r + 8 * (j & 1)) * AS + kk + 8 * (j >> 1)]);
      uint32_t b[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4_trans(b[np], &Bs[(kk + r + 8 * (j & 1)) * BS + wn + np * 16 + 8 * (j >> 1)]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2], b[nt >> 1][(nt & 1) * 2 + 1]);
    }
    __syncthreads();
  }

  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gm = m0 + wm + mt * 16 + g + 8 * half;
      if (gm >= p.t) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int gn = n0 + wn + nt * 8 + t2;
        if (gn < p.f) o[gm * p.sot + gn] = __float2bfloat16_rn(acc[mt][nt][2 * half]);
        if (gn + 1 < p.f) o[gm * p.sot + gn + 1] = __float2bfloat16_rn(acc[mt][nt][2 * half + 1]);
      }
    }
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores); both
// accumulate in f32. Strides are in elements; each operand's last dim is
// contiguous. vec_x / vec_w: 1 when every row of x / w starts 16-byte
// aligned. Returns cudaGetLastError() after the launch (0 on success).
int repro_grouped_matmul(int dtype, const void* x, const void* w, void* out, int e, int t,
                         int d, int f, long long sxe, long long sxt, long long swe,
                         long long swd, long long soe, long long sot, int vec_x, int vec_w,
                         void* stream) {
  Params p;
  p.x = x; p.w = w; p.out = out;
  p.e = e; p.t = t; p.d = d; p.f = f;
  p.sxe = sxe; p.sxt = sxt; p.swe = swe; p.swd = swd; p.soe = soe; p.sot = sot;
  p.vec_x = vec_x; p.vec_w = vec_w;
  if (e < 1 || t < 1 || f < 1 || d < 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid((t + F_BM - 1) / F_BM, (f + F_BN - 1) / F_BN, e);
    gmm_f32_kernel<<<grid, F_NT, 0, st>>>(p);
  } else if (dtype == 1) {
    const dim3 grid((t + BM - 1) / BM, (f + BN - 1) / BN, e);
    gmm_bf16_kernel<<<grid, NT, 0, st>>>(p);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
