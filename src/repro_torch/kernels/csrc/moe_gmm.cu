// Grouped (per-expert) matmul for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gmm.py
// (`grouped_matmul`, body `_kernel`): out[e] = x[e] @ w[e] for every expert
// e, x (E, T, D), w (E, D, F), out (E, T, F), with an f32 accumulator over
// the whole of D and the result cast once to the inputs' type. The TPU
// kernel walks D as the innermost grid axis, carrying the sum in a VMEM
// scratch tile from one grid step to the next; here one block owns an
// output tile and walks D in a loop of its own, with the sum in registers,
// so nothing carries over between blocks (and no split of D across blocks:
// two launches give the same bits).
//
// What bounds it on this card: operations. At mixtral-8x22b's prefill
// shape (E 8, T 1312, D 6144, F 16384) one call is 2*E*T*D*F = 2.11e12
// FLOPs, 2.14 ms at the dense bf16 tensor-core peak, while its bytes
// (x, w and out once each, 2.1 GB) take 0.62 ms at 3.35 TB/s.
//
// Three kernels; the wrapper (kernels/moe_gmm.py, `variant`) picks one by
// type and layout before the launch.
//  * gmm_wgmma_kernel, bf16 whose operands TMA can describe (16-byte
//    aligned base, every stride but the last a multiple of 8 elements):
//    only wgmma reaches the tensor cores' full rate, and the old single
//    shared-memory stage stalled them at every K step. So: a persistent
//    grid of one block per SM walks the output tiles (128 x 256) with the
//    T tiles fastest, so the blocks that share one w tile run together and
//    w, the largest operand, comes from device memory about once. In each
//    block one producer warp keeps TMA loads in flight into a ring of 4
//    shared-memory stages (x tile 128 x 64, K-major; w tile 64 x 256 as four
//    64-column panels, MN-major: read through wgmma's transpose-B bit, never
//    transposed in memory), each stage guarded by a "full" and an "empty"
//    mbarrier; two consumer warpgroups each own 64 x 256 of the tile and run
//    m64n256k16 wgmma on it with f32 accumulators in registers (128 a
//    thread), keeping one wgmma group in flight while they release the
//    previous stage. setmaxnreg moves registers from the producer (40) to the
//    consumers (232). The ring runs on across tiles, so the next tile's loads
//    overlap this tile's epilogue, which writes bf16 pairs from registers,
//    masking the ragged T and F edges; TMA fills loads past T, D and F with
//    zeros.
//  * gmm_bf16_kernel, the other bf16 layouts (ragged shapes whose strides
//    TMA cannot take): `mma.sync` m16n8k16 on 128 x 128 tiles, one shared
//    stage with the next K step's loads in registers, `ldmatrix` reading x
//    and (transposed) w; loads and stores masked, so every shape runs.
//  * gmm_f32_kernel, f32: FMA on the CUDA cores in full f32 (no TF32: the
//    tests hold f32 to 1e-4 * D), a 64 x 64 tile per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

// ------------------------------------------------------------ bf16, wgmma

namespace wg {

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4, THREADS = 384;
constexpr int A_BYTES = BM * BK * 2;          // x tile: 128 rows of 128 bytes
constexpr int B_PANEL = BK * 64 * 2;          // one 64-column panel of the w tile
constexpr int B_BYTES = BK * BN * 2;          // w tile: four panels
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;  // 48 KB
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment slack

}  // namespace wg

__global__ void __launch_bounds__(wg::THREADS, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                     const __grid_constant__ CUtensorMap tmw, const Params p) {
  // local names hide the mma.sync kernel's tile constants of the same names
  constexpr int BM = wg::BM, BN = wg::BN, BK = wg::BK, STAGES = wg::STAGES;
  constexpr int A_BYTES = wg::A_BYTES, B_PANEL = wg::B_PANEL, STAGE_BYTES = wg::STAGE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tiles_t = (p.t + BM - 1) / BM;
  const int tiles_f = (p.f + BN - 1) / BN;
  const int n_tiles = p.e * tiles_f * tiles_t;
  const int k_iters = (p.d + BK - 1) / BK;
  const int role = threadIdx.x / 128;  // 0: producer, 1 and 2: consumers

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (role == 0) {
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      hopper::prefetch_tensor_map(&tmx);
      hopper::prefetch_tensor_map(&tmw);
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int tt = tile % tiles_t, rest = tile / tiles_t;
        const int tf = rest % tiles_f, e = rest / tiles_f;
        for (int k = 0; k < k_iters; ++k) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* a = smem + stage * STAGE_BYTES;
          uint8_t* b = a + A_BYTES;
          hopper::mbar_arrive_expect_tx(&full[stage], STAGE_BYTES);
          hopper::tma_load_3d(a, &tmx, &full[stage], k * BK, tt * BM, e);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            hopper::tma_load_3d(b + j * B_PANEL, &tmw, &full[stage], tf * BN + j * 64, k * BK, e);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<232>();
    const int c = role - 1;  // rows 64c .. 64c + 63 of the tile
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    int stage = 0;
    uint32_t phase = 0;
    float acc[128];
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int tt = tile % tiles_t, rest = tile / tiles_t;
      const int tf = rest % tiles_f, e = rest / tiles_f;
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int k = 0; k < k_iters; ++k) {
        hopper::mbar_wait(&full[stage], phase);
        const uint8_t* a = smem + stage * STAGE_BYTES + c * 64 * 128;
        const uint8_t* b = smem + stage * STAGE_BYTES + A_BYTES;
        hopper::fence_operands(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          hopper::wgmma_m64n256k16_ss<1>(acc, hopper::desc_kmajor(a + kk * 32),
                                         hopper::desc_mnmajor(b + kk * 2048, B_PANEL), 1);
        hopper::wgmma_commit();
        hopper::fence_operands(acc);
        hopper::wgmma_wait<1>();  // the previous stage's products are done
        if (prev >= 0 && lane == 0) hopper::mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_operands(acc);
      if (prev >= 0 && lane == 0) hopper::mbar_arrive(&empty[prev]);

      // epilogue: bf16 pairs straight from the accumulator fragment
      __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.out) + e * p.soe;
      const int row0 = tt * BM + c * 64 + warp * 16 + (lane >> 2);
      const int col0 = tf * BN + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < 128; i += 2) {
        const int row = row0 + 8 * ((i >> 1) & 1);
        const int col = col0 + 8 * (i >> 2);
        if (row < p.t && col < p.f)
          *reinterpret_cast<__nv_bfloat162*>(o + row * p.sot + col) =
              __floats2bfloat162_rn(acc[i], acc[i + 1]);
      }
    }
  }
}

// Encodes the two tensor maps and launches one block per SM (or per tile,
// if fewer). Returns cudaGetLastError() after the launch, or a negative
// hopper:: code if a tensor map was refused.
int launch_wgmma(const Params& p, cudaStream_t stream) {
  CUtensorMap tmx, tmw;
  const uint64_t x_dims[3] = {uint64_t(p.d), uint64_t(p.t), uint64_t(p.e)};
  const uint64_t x_strides[2] = {uint64_t(p.sxt) * 2, uint64_t(p.sxe) * 2};
  const uint32_t x_box[3] = {64, wg::BM, 1};
  const uint64_t w_dims[3] = {uint64_t(p.f), uint64_t(p.d), uint64_t(p.e)};
  const uint64_t w_strides[2] = {uint64_t(p.swd) * 2, uint64_t(p.swe) * 2};
  const uint32_t w_box[3] = {64, wg::BK, 1};
  int err = hopper::encode_bf16_map(&tmx, p.x, 3, x_dims, x_strides, x_box);
  if (err) return err;
  err = hopper::encode_bf16_map(&tmw, p.w, 3, w_dims, w_strides, w_box);
  if (err) return err;
  cudaError_t cerr = cudaFuncSetAttribute(gmm_wgmma_kernel,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          wg::SMEM_BYTES);
  if (cerr != cudaSuccess) return int(cerr);
  int dev = 0, sms = 0;
  cerr = cudaGetDevice(&dev);
  if (cerr == cudaSuccess) cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cerr != cudaSuccess) return int(cerr);
  const long long tiles =
      (long long)p.e * ((p.f + wg::BN - 1) / wg::BN) * ((p.t + wg::BM - 1) / wg::BM);
  const int grid = int(tiles < sms ? tiles : sms);
  gmm_wgmma_kernel<<<grid, wg::THREADS, wg::SMEM_BYTES, stream>>>(tmx, tmw, p);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// kernel: 0 = gmm_f32_kernel (float32, CUDA cores), 1 = gmm_bf16_kernel
// (bfloat16, mma.sync), 2 = gmm_wgmma_kernel (bfloat16; x, w and out
// TMA-describable: 16-byte-aligned bases, strides that are multiples of 8
// elements, f a multiple of 8; the wrapper checks this before it picks the
// kernel). All accumulate in f32. Strides are in elements; each operand's
// last dim is contiguous. vec_x / vec_w (kernel 1 only): 1 when every row
// of x / w starts 16-byte aligned. Returns cudaGetLastError() after the
// launch (0 on success), or a negative hopper:: code if a tensor map was
// refused.
int repro_grouped_matmul(int kernel, const void* x, const void* w, void* out, int e, int t,
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
  if (kernel == 0) {
    const dim3 grid((t + F_BM - 1) / F_BM, (f + F_BN - 1) / F_BN, e);
    gmm_f32_kernel<<<grid, F_NT, 0, st>>>(p);
  } else if (kernel == 1) {
    const dim3 grid((t + BM - 1) / BM, (f + BN - 1) / BN, e);
    gmm_bf16_kernel<<<grid, NT, 0, st>>>(p);
  } else if (kernel == 2 && d > 0) {
    return launch_wgmma(p, st);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

const char* repro_cuda_error_string(int err) { return hopper::error_string(err); }

}  // extern "C"
