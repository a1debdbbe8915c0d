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
// per column against 8 bytes of data + cols (f32), so the arithmetic
// intensity is far below the card's ridge point; the least time is
// (data + cols + x + out bytes) / 3.35 TB/s.
//
// Shared by both:
//  * No K padding: the TPU kernel padded K to 128 lanes, which on the main
//    path's K = 5 / K = 1 blocks would read ~25x the bytes.  Rows keep their
//    own K, read contiguously.
//  * Every output runs the same fp32 FMA chain
//        acc = 0.0f; for k in 0..K-1: acc = __fmaf_rn(d[k], x[k], acc)
//    and is rounded to the output type once, so spmm at C = 1 equals spmv
//    bitwise, column c of spmm(X) equals spmv(X[..., c]) bitwise, and a
//    masked launch's active tile equals the unmasked launch bitwise.  bf16
//    inputs widen to fp32.
//  * No atomics: one thread owns each output, so results are deterministic.
//  * A tile whose mask entry is 0 writes zeros and reads nothing else.
//  * Nothing synchronises or allocates here; each launch goes on the
//    caller's stream and returns cudaGetLastError().
//
// B1 (spmv): one thread per row, a block of kTileR rows is one mask tile.
//
// B2 (spmm), designed for Hopper.  The first version walked a tile's
// (row, column) outputs with the column fastest: each of a row's C threads
// loaded that row's K data values and K column ids again (8x the load
// instructions at C = 8), and every output ran a chain of two dependent
// loads with little independent work to hide them.  Now:
//  * One block per kTileRMM-row mask tile.  The tile's [rows, K] data and
//    cols are contiguous in memory, so the block copies each once into
//    shared memory with 16-byte cp.async (element copies for the tail, or
//    for all of an unaligned source), coalesced, and waits on them once.
//  * One thread owns one row and a vector of columns: CPT = min(C,
//    kVecBytes / sizeof(T)) columns (8 in f32, 16 in bf16), TPR = C / CPT
//    threads per row (2 at C = 16 in f32), neighbouring
//    threads on neighbouring outputs.  It reads its row's data and column
//    ids from shared memory and gathers each X row slice with the widest
//    aligned vector loads (two float4 for 8 f32 columns, one 16-byte load
//    for 8 bf16), for kKBatch slots at a time: all of a batch's index and X
//    loads are issued before its FMA chain, so several 16-byte loads are in
//    flight per thread instead of one.
//  * Specialised by template on C in {1, 2, 4, 8, 16}, with X and the
//    output 16-byte aligned.  Any other C (or an unaligned X) goes to the
//    generic instantiation of the same kernel: one thread per row, columns
//    in chunks of 8, element loads.
//  * A tile whose data + cols would not fit kStageBytes of shared memory
//    (K > 96 in f32, K > 128 in bf16) reads them straight from global
//    memory through the same generic pointers: the arithmetic is the same.
//  * Measured on the H100 at the main path's shape (C = 8), 16- or 32-byte
//    column slices, batches of 2 or 4 slots, staging or not, and L2 cache
//    hints came out about equal; this design stays.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileR = 256;     // rows per spmv tile = threads per block
constexpr int kTileRMM = 64;    // rows per spmm tile = one block
constexpr int kVecBytes = 32;   // bytes of X row slice per spmm thread
constexpr int kKBatch = 2;      // slots whose loads are issued before their FMAs
constexpr int kStageBytes = 48 * 1024;  // static-launch shared-memory limit

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

// ---------------------------------------------------------------------------
// B2 helpers
// ---------------------------------------------------------------------------

template <int BYTES> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// N elements of T at p (p aligned to the chunk) as floats, in chunks of at
// most 16 bytes.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&v)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  constexpr int kChunk = kBytes < 16 ? kBytes : 16;
  constexpr int kPer = kChunk / (int)sizeof(T);
  using R = typename Raw<kChunk>::type;
#pragma unroll
  for (int i = 0; i < kBytes / kChunk; ++i) {
    const R raw = __ldg(reinterpret_cast<const R*>(p) + i);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[i * kPer + j] = widen(e[j]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&v)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  constexpr int kChunk = kBytes < 16 ? kBytes : 16;
  constexpr int kPer = kChunk / (int)sizeof(T);
  using R = typename Raw<kChunk>::type;
#pragma unroll
  for (int i = 0; i < kBytes / kChunk; ++i) {
    R raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < kPer; ++j) e[j] = narrow<T>(v[i * kPer + j]);
    reinterpret_cast<R*>(p)[i] = raw;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Copy n contiguous elements into 16-byte aligned shared memory with the
// whole block: 16-byte cp.async when the source is aligned too, element
// copies for the tail (or for all of an unaligned source).  The caller
// waits with cp.async.wait_all and __syncthreads.
template <typename E>
__device__ __forceinline__ void stage_copy(E* dst, const E* __restrict__ src, int n) {
  constexpr int kPer = 16 / (int)sizeof(E);
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const int body = aligned ? n / kPer : 0;
  for (int v = threadIdx.x; v < body; v += blockDim.x) {
    cp_async16(dst + v * kPer, src + v * kPer);
  }
  for (int e = body * kPer + threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
}

// Columns per thread (CPT) and threads per row (TPR) of the instantiation
// for compile-time column count CT (0: generic, runtime C).
template <typename T, int CT> struct MMShape {
  static constexpr int kVec = kVecBytes / (int)sizeof(T);
  static constexpr int CPT = (CT == 0 || CT > kVec) ? (CT == 0 ? 8 : kVec) : CT;
  static constexpr int TPR = CT == 0 ? 1 : CT / CPT;
};

// grid (ntiles, g), block kTileRMM * TPR.  CT is the compile-time column
// count, 0 for the generic instantiation (runtime C, element loads).
template <typename T, int CT>
__global__ void __launch_bounds__(kTileRMM * MMShape<T, CT>::TPR)
spmm_ell_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                const T* __restrict__ X, const int* __restrict__ mask,
                T* __restrict__ out, int R, int K, int N, int C, int ntiles, int stage) {
  constexpr int CPT = MMShape<T, CT>::CPT;
  constexpr int TPR = MMShape<T, CT>::TPR;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x;
  const int g = blockIdx.y;
  const int row0 = tile * kTileRMM;
  const int rows = min(kTileRMM, R - row0);
  const int i = threadIdx.x / TPR;
  const int part = threadIdx.x - i * TPR;
  const int64_t r0 = (int64_t)g * R + row0;
  const bool active = mask == nullptr || mask[(int64_t)g * ntiles + tile] != 0;
  if (!active) {
    if (i >= rows) return;
    T* o = out + (r0 + i) * C;
    if constexpr (CT != 0) {
      float z[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) z[j] = 0.0f;
      store_vec<T, CPT>(o + part * CPT, z);
    } else {
      for (int c = 0; c < C; ++c) o[c] = narrow<T>(0.0f);
    }
    return;
  }
  const T* d;
  const int* cl;
  if (stage) {
    T* sd = reinterpret_cast<T*>(smem);
    const int dbytes = ((kTileRMM * K * (int)sizeof(T)) + 15) & ~15;
    int* sc = reinterpret_cast<int*>(smem + dbytes);
    stage_copy<T>(sd, data + r0 * K, rows * K);
    stage_copy<int>(sc, cols + r0 * K, rows * K);
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    d = sd + i * K;
    cl = sc + i * K;
  } else {
    d = data + (r0 + i) * K;
    cl = cols + (r0 + i) * K;
  }
  if (i >= rows) return;
  const T* xg = X + (int64_t)g * N * C;
  T* o = out + (r0 + i) * C;
  for (int c0 = part * CPT; c0 < C; c0 += TPR * CPT) {
    float acc[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[j] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += kKBatch) {
      float dv[kKBatch];
      float xv[kKBatch][CPT];
#pragma unroll
      for (int b = 0; b < kKBatch; ++b) {
        if (k0 + b < K) {
          dv[b] = widen(d[k0 + b]);
          const T* xr = xg + (int64_t)cl[k0 + b] * C + c0;
          if constexpr (CT != 0) {
            load_vec<T, CPT>(xr, xv[b]);
          } else {
#pragma unroll
            for (int j = 0; j < CPT; ++j) xv[b][j] = c0 + j < C ? widen(xr[j]) : 0.0f;
          }
        }
      }
#pragma unroll
      for (int b = 0; b < kKBatch; ++b) {
        if (k0 + b < K) {
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[j] = __fmaf_rn(dv[b], xv[b][j], acc[j]);
        }
      }
    }
    if constexpr (CT != 0) {
      store_vec<T, CPT>(o + c0, acc);
    } else {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        if (c0 + j < C) o[c0 + j] = narrow<T>(acc[j]);
      }
    }
  }
}

int ntiles_for(int R, int tile) { return (R + tile - 1) / tile; }

template <typename T, int CT>
void launch_spmm(const void* data, const int* c, const void* X, const int* m, void* out, int g,
                 int R, int K, int N, int C, cudaStream_t s) {
  const int ntiles = ntiles_for(R, kTileRMM);
  const dim3 grid(ntiles, g);
  constexpr int TPR = MMShape<T, CT>::TPR;
  const int64_t need = ((int64_t)kTileRMM * K * sizeof(T) + 15) / 16 * 16 +
                       (int64_t)kTileRMM * K * sizeof(int);
  const int stage = need <= kStageBytes ? 1 : 0;
  spmm_ell_kernel<T, CT><<<grid, kTileRMM * TPR, stage ? (size_t)need : 0, s>>>(
      static_cast<const T*>(data), c, static_cast<const T*>(X), m, static_cast<T*>(out), R, K,
      N, C, ntiles, stage);
}

template <typename T>
void dispatch_spmm(const void* data, const int* c, const void* X, const int* m, void* out,
                   int g, int R, int K, int N, int C, cudaStream_t s) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(X) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (aligned) {
    switch (C) {
      case 1: return launch_spmm<T, 1>(data, c, X, m, out, g, R, K, N, C, s);
      case 2: return launch_spmm<T, 2>(data, c, X, m, out, g, R, K, N, C, s);
      case 4: return launch_spmm<T, 4>(data, c, X, m, out, g, R, K, N, C, s);
      case 8: return launch_spmm<T, 8>(data, c, X, m, out, g, R, K, N, C, s);
      case 16: return launch_spmm<T, 16>(data, c, X, m, out, g, R, K, N, C, s);
      default: break;
    }
  }
  launch_spmm<T, 0>(data, c, X, m, out, g, R, K, N, C, s);
}

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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(cols);
  const int* m = static_cast<const int*>(mask);
  if (dtype == 0) {
    dispatch_spmm<float>(data, c, X, m, out, g, R, K, N, C, s);
  } else if (dtype == 1) {
    dispatch_spmm<__nv_bfloat16>(data, c, X, m, out, g, R, K, N, C, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Row-tile sizes, so the Python side can check its mask granularity.
extern "C" int repro_spmv_ell_tile_rows() { return kTileR; }
extern "C" int repro_spmm_ell_tile_rows() { return kTileRMM; }
