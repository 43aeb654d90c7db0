// Per-bucket sums for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bucket_reduce.py
// (`bucket_reduce`, body `_kernel`): out[p, :] = sum of values[i, :] over
// the rows i with ids[i] == p, accumulated in f32 and written in the
// values' type; ids of -1 (padding) and ids outside [0, P) add nothing.
// The TPU kernel builds a one-hot (block, P) matrix and lets the matrix
// unit take onehot.T @ values, which does P times the work the function
// needs; here the same function is a segmented sum. An int64
// instantiation (int64 values, int64 accumulator) serves the engine's
// exact integer envelope.
//
// What bounds it on this card: bytes. One call must read N*D values and N
// int32 ids and write P*D results, N*D*s + 4N + P*D*s bytes at 3.35 TB/s,
// and it does about N*D additions, far below any compute peak. At the
// engine's shapes (N <= 8192 rows, D = 1, P = the groups of a batch) that
// is a few tens of kilobytes, about 0.01 us of bandwidth, so the launch
// and the host<->device copies around it set its time, not the bytes.
//
// What the design does about it. It is deterministic without float
// atomics (the engine re-emits byte-identical partials across retries), in
// two launches on the caller's stream:
//  1. A grid of (bucket tile x column tile, row chunk). Block (t, c)
//     walks chunk c's rows in order. Its 256 threads are split into
//     `lanes` row lanes of `dt` columns (lanes * dt = 256); lane l takes
//     rows l, l + lanes, ... of the chunk, and thread (l, col) adds the
//     value of every such row whose id falls in the block's bucket tile
//     into its own cell of lane l's private partial in shared memory, so
//     no two threads ever write one word. The lanes' partials are then
//     merged in lane order and the chunk's (P tile, D tile) partial is
//     written to a (chunks, P, D) scratch buffer.
//  2. One thread per (p, d) sums the chunks' partials in chunk order and
//     casts to the output type.
// Neighbouring threads read neighbouring rows (D = 1) or neighbouring
// columns of one row (D > 1), so the loads are coalesced. The number of
// row chunks comes from the SM count, not from N, so the scratch stays
// bounded; the bucket tile is sized to the shared-memory budget, so any P
// works. Tiling the reads with TMA and keeping ids in registers are left
// for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // threads per block

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ long long to_acc(long long x) { return x; }

__device__ __forceinline__ void store(float* o, float x) { *o = x; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float x) { *o = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store(long long* o, long long x) { *o = x; }

struct Params {
  const void* values;  // (n, d), row-major
  const int* ids;      // (n,)
  void* scratch;       // (chunks, p, d) accumulators
  void* out;           // (p, d) in the values' type
  long long n;
  int d, p;
  int chunks, rows_per_chunk;
  int pt, dt;          // bucket tile and column tile
  int p_tiles;
};

template <typename T, typename Acc>
__global__ void __launch_bounds__(NT) partial_kernel(Params prm) {
  extern __shared__ unsigned char smem_raw[];
  Acc* part = reinterpret_cast<Acc*>(smem_raw);  // [lanes][pt][dt]
  const T* values = static_cast<const T*>(prm.values);
  Acc* scratch = static_cast<Acc*>(prm.scratch);

  const int dt = prm.dt, pt = prm.pt;
  const int lanes = NT / dt;
  const int cells = pt * dt;
  const int p0 = (blockIdx.x % prm.p_tiles) * pt;
  const int d0 = (blockIdx.x / prm.p_tiles) * dt;
  const int chunk = blockIdx.y;
  const int tid = threadIdx.x;

  for (int i = tid; i < lanes * cells; i += NT) part[i] = Acc(0);
  __syncthreads();

  const int col = tid % dt;
  const int lane = tid / dt;
  const int pend = min(prm.p, p0 + pt);
  const long long dcol = d0 + col;
  const long long r0 = static_cast<long long>(chunk) * prm.rows_per_chunk;
  const long long r1 = min(prm.n, r0 + prm.rows_per_chunk);
  if (dcol < prm.d) {
    Acc* mine = part + lane * cells + col;
    for (long long r = r0 + lane; r < r1; r += lanes) {
      const int id = __ldg(prm.ids + r);
      if (id >= p0 && id < pend) mine[(id - p0) * dt] += to_acc(values[r * prm.d + dcol]);
    }
  }
  __syncthreads();

  for (int c = tid; c < cells; c += NT) {
    const int pp = p0 + c / dt;
    const long long dd = d0 + c % dt;
    if (pp >= pend || dd >= prm.d) continue;
    Acc s = part[c];
    for (int l = 1; l < lanes; ++l) s += part[l * cells + c];
    scratch[(static_cast<long long>(chunk) * prm.p + pp) * prm.d + dd] = s;
  }
}

template <typename T, typename Acc>
__global__ void __launch_bounds__(NT) finish_kernel(Params prm) {
  const long long pd = static_cast<long long>(prm.p) * prm.d;
  const long long c = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (c >= pd) return;
  const Acc* scratch = static_cast<const Acc*>(prm.scratch);
  Acc s = scratch[c];
  for (int k = 1; k < prm.chunks; ++k) s += scratch[k * pd + c];
  store(static_cast<T*>(prm.out) + c, s);
}

template <typename T, typename Acc>
cudaError_t launch(const Params& prm, cudaStream_t stream) {
  const int lanes = NT / prm.dt;
  const size_t smem = sizeof(Acc) * size_t(lanes) * prm.pt * prm.dt;
  cudaError_t err = cudaFuncSetAttribute(partial_kernel<T, Acc>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int d_tiles = (prm.d + prm.dt - 1) / prm.dt;
  const dim3 grid1(prm.p_tiles * d_tiles, prm.chunks);
  partial_kernel<T, Acc><<<grid1, NT, smem, stream>>>(prm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long pd = static_cast<long long>(prm.p) * prm.d;
  finish_kernel<T, Acc><<<unsigned((pd + NT - 1) / NT), NT, 0, stream>>>(prm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (both accumulate in f32), 2 = int64
// (accumulates in int64). The tiling (chunks, rows_per_chunk, pt, dt,
// p_tiles) is chosen by the Python wrapper; scratch holds chunks * p * d
// accumulators. Returns cudaGetLastError() after the launches (0 on
// success).
int repro_bucket_reduce(int dtype, const void* values, const int* ids, void* scratch, void* out,
                        long long n, int d, int p, int chunks, int rows_per_chunk, int pt,
                        int dt, int p_tiles, void* stream) {
  Params prm;
  prm.values = values; prm.ids = ids; prm.scratch = scratch; prm.out = out;
  prm.n = n; prm.d = d; prm.p = p;
  prm.chunks = chunks; prm.rows_per_chunk = rows_per_chunk;
  prm.pt = pt; prm.dt = dt; prm.p_tiles = p_tiles;
  if (dt < 1 || NT % dt != 0 || pt < 1 || chunks < 1) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return int(launch<float, float>(prm, st));
  if (dtype == 1) return int(launch<__nv_bfloat16, float>(prm, st));
  if (dtype == 2) return int(launch<long long, long long>(prm, st));
  return int(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
