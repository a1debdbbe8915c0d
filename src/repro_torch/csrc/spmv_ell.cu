// Blocked-ELL SpMV / SpMM for Hopper (sm_90a), batched over stacked ranks.
//
// Replaces the Pallas kernels of src/repro/kernels/spmv_ell.py:
//   spmv_ell (bodies _spmv_ell_kernel / _spmv_ell_masked_kernel) and
//   spmm_ell (bodies _spmm_ell_kernel / _spmm_ell_masked_kernel).
//
//   spmv: w[g, i]    = sum_k data[g, i, k] * x[g, cols[g, i, k]]
//   spmm: W[g, i, c] = sum_k data[g, i, k] * X[g, cols[g, i, k], c]
//
// What bounds it on an H100: bytes.  Each nonzero slot costs one multiply-add
// against 8 bytes of data + cols (f32), so the arithmetic intensity is far
// below the card's ridge point; the least time is
// (data + cols + x + out bytes) / 3.35 TB/s.
//
// Design (simple and right first):
//  * No K padding: the TPU kernel padded K to 128 lanes, which on the main
//    path's K = 5 / K = 1 blocks would read ~25x the bytes.  Rows keep their
//    own K, read contiguously.
//  * spmv: one thread per row, a block of kTileR rows is one mask tile.
//    spmm: the threads of a block walk the (row, column) outputs of a
//    kTileRMM-row tile with the column fastest, so neighbouring threads read
//    neighbouring X[col, c] values and write neighbouring outputs.
//  * Every output runs the same fp32 FMA chain over k = 0..K-1 in order
//    (ell_row below), so spmm at C = 1 equals spmv bitwise and a masked
//    launch's active tile equals the unmasked launch bitwise.  bf16 inputs
//    widen to fp32 and the sum is rounded to bf16 once at the store.
//  * No atomics: one thread owns each output, so results are deterministic.
//  * A tile whose mask entry is 0 writes zeros and reads nothing else.
//  * Nothing synchronises or allocates here; each launch goes on the
//    caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileR = 256;     // rows per spmv tile = threads per block
constexpr int kTileRMM = 64;    // rows per spmm tile
constexpr int kThreadsMM = 256; // threads per spmm block

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One output: the row's K slots in order, one rounding per slot.
template <typename T>
__device__ __forceinline__ float ell_row(const T* __restrict__ d, const int* __restrict__ c,
                                         const T* __restrict__ x, int K, int C, int col) {
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    acc = __fmaf_rn(widen(d[k]), widen(x[(int64_t)c[k] * C + col]), acc);
  }
  return acc;
}

// grid (ntiles, g), block kTileR
template <typename T>
__global__ void __launch_bounds__(kTileR)
spmv_ell_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                const T* __restrict__ x, const int* __restrict__ mask,
                T* __restrict__ out, int R, int K, int N, int ntiles) {
  const int tile = blockIdx.x;
  const int g = blockIdx.y;
  const int row = tile * kTileR + threadIdx.x;
  if (row >= R) return;
  const int64_t r = (int64_t)g * R + row;
  float acc = 0.0f;
  if (mask == nullptr || mask[(int64_t)g * ntiles + tile] != 0) {
    acc = ell_row(data + r * K, cols + r * K, x + (int64_t)g * N, K, 1, 0);
  }
  out[r] = narrow<T>(acc);
}

// grid (ntiles, g), block kThreadsMM
template <typename T>
__global__ void __launch_bounds__(kThreadsMM)
spmm_ell_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                const T* __restrict__ X, const int* __restrict__ mask,
                T* __restrict__ out, int R, int K, int N, int C, int ntiles) {
  const int tile = blockIdx.x;
  const int g = blockIdx.y;
  const int row0 = tile * kTileRMM;
  const int rows = min(kTileRMM, R - row0);
  const bool active = mask == nullptr || mask[(int64_t)g * ntiles + tile] != 0;
  const T* xg = X + (int64_t)g * N * C;
  for (int e = threadIdx.x; e < rows * C; e += kThreadsMM) {
    const int i = e / C;
    const int col = e - i * C;
    const int64_t r = (int64_t)g * R + row0 + i;
    float acc = 0.0f;
    if (active) {
      acc = ell_row(data + r * K, cols + r * K, xg, K, C, col);
    }
    out[r * C + col] = narrow<T>(acc);
  }
}

int ntiles_for(int R, int tile) { return (R + tile - 1) / tile; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  mask may be null.  Returns a cudaError_t.
extern "C" int repro_spmv_ell(int dtype, const void* data, const void* cols, const void* x,
                              const void* mask, void* out, int g, int R, int K, int N,
                              void* stream) {
  if (g <= 0 || R <= 0) return 0;
  const int ntiles = ntiles_for(R, kTileR);
  const dim3 grid(ntiles, g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(cols);
  const int* m = static_cast<const int*>(mask);
  if (dtype == 0) {
    spmv_ell_kernel<float><<<grid, kTileR, 0, s>>>(
        static_cast<const float*>(data), c, static_cast<const float*>(x), m,
        static_cast<float*>(out), R, K, N, ntiles);
  } else if (dtype == 1) {
    spmv_ell_kernel<__nv_bfloat16><<<grid, kTileR, 0, s>>>(
        static_cast<const __nv_bfloat16*>(data), c, static_cast<const __nv_bfloat16*>(x), m,
        static_cast<__nv_bfloat16*>(out), R, K, N, ntiles);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_spmm_ell(int dtype, const void* data, const void* cols, const void* X,
                              const void* mask, void* out, int g, int R, int K, int N, int C,
                              void* stream) {
  if (g <= 0 || R <= 0 || C <= 0) return 0;
  const int ntiles = ntiles_for(R, kTileRMM);
  const dim3 grid(ntiles, g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(cols);
  const int* m = static_cast<const int*>(mask);
  if (dtype == 0) {
    spmm_ell_kernel<float><<<grid, kThreadsMM, 0, s>>>(
        static_cast<const float*>(data), c, static_cast<const float*>(X), m,
        static_cast<float*>(out), R, K, N, C, ntiles);
  } else if (dtype == 1) {
    spmm_ell_kernel<__nv_bfloat16><<<grid, kThreadsMM, 0, s>>>(
        static_cast<const __nv_bfloat16*>(data), c, static_cast<const __nv_bfloat16*>(X), m,
        static_cast<__nv_bfloat16*>(out), R, K, N, C, ntiles);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Row-tile sizes, so the Python side can check its mask granularity.
extern "C" int repro_spmv_ell_tile_rows() { return kTileR; }
extern "C" int repro_spmm_ell_tile_rows() { return kTileRMM; }
