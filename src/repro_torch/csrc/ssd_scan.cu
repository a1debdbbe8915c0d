// Mamba-2 chunked SSD (state-space duality) scan for Hopper (sm_90a).
//
// Replaces the Pallas kernel ssd_scan_kernel of src/repro/kernels/ssd_scan.py
// (body _kernel).  Per (batch b, head h), with la the inclusive cumsum of
// loga inside a chunk of Q steps and the fp32 state hs [N, P] carried from
// chunk to chunk:
//
//   y[i]  = sum_{j <= i} (c_i . b_j) exp(la_i - la_j) x[j]  +  exp(la_i) (c_i . hs)
//   hs   <- hs exp(la_end) + sum_j (b_j exp(la_end - la_j)) (x) x[j]
//
// x = xdt [B, S, H, P], loga [B, S, H], b / c [B, S, N] (shared by every
// head), all float32; y [B, S, H, P] float32.  A ragged last chunk is padded
// with zeros: loga = 0 means no decay and x = 0 means no input.
//
// What bounds it on an H100: about equally bytes (x read once, y written
// once) and fp32 operations (the causal Q x Q intra-chunk product); the
// script chip_smoke.py computes both and reports the larger.
//
// Design: the chunk-parallel decomposition of the Mamba-2 paper
// (arXiv:2405.21060 section 6), four launches on the caller's stream, no
// synchronisation between them:
//  (0) ssd_scores_kernel, one CTA per (chunk, batch): G^T[j][i] = c_i . b_j
//      for j <= i, into scratch [B, nc, Q, Q].  b and c are shared by every
//      head, so the scores are built once, not once per head.
//  (1) ssd_states_kernel, one CTA per (chunk, head, batch): the chunk's own
//      end state S_c = (b o exp(la_end - la))^T x into scratch
//      [B, nc, H, N, P], and its decay exp(la_end) into [B, nc, H].
//  (2) ssd_pass_kernel, one thread per (batch, head, state entry): the only
//      sequential step, over chunks on [N, P] states:
//      h_c = h_{c-1} exp(la_end_c) + S_c.  It overwrites slot c with the
//      state entering chunk c.
//  (3) ssd_output_kernel, one CTA per (chunk, head, batch):
//      y = (G o decay) x + (exp(la) o c) h_{c-1}, as one product of a
//      [Q, Q + N] operand (the decay-weighted scores beside the scaled c)
//      with [Q + N, P] (x under the entering state).  Each thread owns two
//      4 x 4 register tiles of y, rows from the top and the bottom of the
//      chunk, and walks only the keys j <= each tile's last row: the causal
//      triangle is halved and every thread does about the same work.
// Every product is an exact fp32 FMA on the CUDA cores (no TF32).  The
// in-chunk cumsum of loga is taken in float64 (a warp scan of doubles):
// |la| reaches Q |loga|, where a float32 ulp would cost the decay factors
// exp(la_i - la_j) their last digits; and the exponent is masked, never the
// product (exp of a positive sum would overflow).  Nothing synchronises the
// device or allocates: the wrapper hands in the scratch from torch.empty.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // rows of y per thread in ssd_output_kernel (two quads)
// head widths P the states and output kernels take: each thread owns four
// columns, so a CTA covers at most 4 * kThreads of them
constexpr int kMaxP = 4 * kThreads;

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// dynamic shared memory of each kernel, bytes; the doubles come first, padded
// to 16 bytes so the float tiles behind them stay float4-aligned
__host__ __device__ inline int64_t scores_smem(int Q, int N) { return 8LL * Q * (N + 1); }
__host__ __device__ inline int64_t states_smem(int Q, int P, int N) {
  return 8LL * round_up(Q, 2) + 4LL * round_up(Q * N, 4) + 4LL * Q * round_up(P, 4);
}
__host__ __device__ inline int64_t output_smem(int Q, int P, int N) {
  return 8LL * round_up(Q, 2) + 4LL * (Q + N + 1) * round_up(Q, kRows) +
         4LL * (Q + N) * round_up(P, 4);
}

// 4 bytes global -> shared, zero-filled when !valid (src is then not read).
// Every tile of these kernels is copied this way, all copies in flight at
// once: a plain load loop would wait out one memory latency per row.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// dst[0, n) <- src[0, n) (zeros when !valid), dst[n, npad) <- 0, by the
// lanes of one warp; 16-byte copies where both rows allow them
__device__ __forceinline__ void copy_row(float* dst, const float* src, int n, int npad,
                                         bool valid, int lane) {
  const uintptr_t ends = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src);
  if (valid && n % 4 == 0 && (ends & 15) == 0) {
    for (int e = 4 * lane; e < n; e += 128) cp_async16(dst + e, src + e);
  } else {
    for (int e = lane; e < n; e += 32) cp_async4(dst + e, src + (valid ? e : 0), valid);
  }
  for (int e = n + lane; e < npad; e += 32) dst[e] = 0.f;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// la[i] = sum_{i' <= i} loga[s0 + i'] of head h in float64 (0 past S)
__device__ void chunk_cumsum(double* la, const float* __restrict__ loga, int b, int S, int H,
                             int h, int s0, int Q) {
  for (int i = threadIdx.x; i < Q; i += blockDim.x) {
    const int s = s0 + i;
    la[i] = s < S ? (double)loga[((int64_t)b * S + s) * H + h] : 0.0;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    double carry = 0.0;
    for (int base = 0; base < Q; base += 32) {
      const int i = base + lane;
      double val = i < Q ? la[i] : 0.0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, val, o);
        if (lane >= o) val += u;
      }
      val += carry;
      if (i < Q) la[i] = val;
      carry = __shfl_sync(0xffffffffu, val, 31);
    }
  }
  __syncthreads();
}

// acc[r][e] += sum_{k in [k0, k1)} At[k][row0 + r] * Bm[k][col0 + e]; At rows
// hold kR consecutive floats at row0 (16-byte aligned when kR % 4 == 0)
template <int kR>
__device__ __forceinline__ void tile_mac(float (&acc)[kR][4], const float* At, int lda, int row0,
                                         const float* Bm, int ldb, int col0, int k0, int k1) {
  for (int k = k0; k < k1; ++k) {
    const float4 bv = *reinterpret_cast<const float4*>(Bm + k * ldb + col0);
    float a[kR];
    if constexpr (kR % 4 == 0) {
#pragma unroll
      for (int r = 0; r < kR; r += 4) {
        const float4 av = *reinterpret_cast<const float4*>(At + k * lda + row0 + r);
        a[r] = av.x;
        a[r + 1] = av.y;
        a[r + 2] = av.z;
        a[r + 3] = av.w;
      }
    } else {
#pragma unroll
      for (int r = 0; r < kR; ++r) a[r] = At[k * lda + row0 + r];
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      acc[r][0] = fmaf(a[r], bv.x, acc[r][0]);
      acc[r][1] = fmaf(a[r], bv.y, acc[r][1]);
      acc[r][2] = fmaf(a[r], bv.z, acc[r][2]);
      acc[r][3] = fmaf(a[r], bv.w, acc[r][3]);
    }
  }
}

// (0) grid (nc, B), dynamic smem scores_smem(Q, N)
__global__ void __launch_bounds__(kThreads)
ssd_scores_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                  float* __restrict__ gt, int S, int N, int Q) {
  extern __shared__ float sm[];
  const int NS = N + 1;  // odd row stride: thread i reads row i without conflicts
  float* Bs = sm;        // [Q][NS]
  float* Cs = Bs + Q * NS;
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int s0 = c * Q;
  for (int i = threadIdx.x / 32; i < Q; i += kThreads / 32) {
    const int s = s0 + i;
    const int64_t row = s < S ? ((int64_t)b * S + s) * N : 0;
    copy_row(Bs + i * NS, bm + row, N, N, s < S, threadIdx.x % 32);
    copy_row(Cs + i * NS, cm + row, N, N, s < S, threadIdx.x % 32);
  }
  cp_async_wait_all();
  __syncthreads();
  float* g = gt + ((int64_t)b * gridDim.x + c) * Q * Q;
  for (int j = threadIdx.x / 32; j < Q; j += kThreads / 32) {
    for (int i = threadIdx.x % 32; i < Q; i += 32) {
      float sc = 0.f;
      if (j <= i) {
        for (int n = 0; n < N; ++n) sc = fmaf(Cs[i * NS + n], Bs[j * NS + n], sc);
      }
      g[j * Q + i] = sc;
    }
  }
}

// rows [0, Q) of a [*, ld] shared tile <- x[b, s0 + j, h, :P] (zeros past S
// and past P), by cp.async; a warp per row, its lanes along P
__device__ __forceinline__ void load_x(float* Xs, int ld, const float* __restrict__ x, int b,
                                       int S, int H, int h, int P, int s0, int Q) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int j = warp; j < Q; j += kThreads / 32) {
    const int s = s0 + j;
    copy_row(Xs + j * ld, x + (s < S ? (((int64_t)b * S + s) * H + h) * P : 0), P, ld, s < S, lane);
  }
}

// (1) grid (nc, H, B), dynamic smem states_smem(Q, P, N)
__global__ void __launch_bounds__(kThreads)
ssd_states_kernel(const float* __restrict__ x, const float* __restrict__ loga,
                  const float* __restrict__ bm, float* __restrict__ states,
                  float* __restrict__ decay, int S, int H, int P, int N, int Q) {
  extern __shared__ double smd[];
  const int P4 = round_up(P, 4);
  double* la = smd;                                           // [Q]
  float* Bw = reinterpret_cast<float*>(la + round_up(Q, 2));  // [Q][N] b_j exp(la_end - la_j)
  float* Xs = Bw + round_up(Q * N, 4);                        // [Q][P4]
  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.x;
  const int s0 = c * Q;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  load_x(Xs, P4, x, b, S, H, h, P, s0, Q);
  for (int j = warp; j < Q; j += kThreads / 32) {
    const int s = s0 + j;
    const int64_t row = s < S ? ((int64_t)b * S + s) * N : 0;
    copy_row(Bw + j * N, bm + row, N, N, s < S, lane);
  }
  chunk_cumsum(la, loga, b, S, H, h, s0, Q);
  const double la_end = la[Q - 1];
  if (threadIdx.x == 0) decay[((int64_t)b * nc + c) * H + h] = expf((float)la_end);
  cp_async_wait_all();
  __syncthreads();
  for (int j = warp; j < Q; j += kThreads / 32) {
    const float w = expf((float)(la_end - la[j]));
    for (int n = lane; n < N; n += 32) Bw[j * N + n] *= w;
  }
  __syncthreads();

  // S_c[n][p] = sum_j Bw[j][n] Xs[j][p]: one row n and 4 columns per thread
  const int G = P4 / 4;
  const int RT = kThreads / G;
  float* out = states + (((int64_t)b * nc + c) * H + h) * N * P;
  if (threadIdx.x < RT * G) {
    const int rt = threadIdx.x / G;
    const int cg = threadIdx.x - rt * G;
    for (int n = rt; n < N; n += RT) {
      float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
      tile_mac<1>(acc, Bw, N, n, Xs, P4, 4 * cg, 0, Q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (4 * cg + e < P) out[n * P + 4 * cg + e] = acc[0][e];
      }
    }
  }
}

// (2) one thread per (batch, head, state entry); blocks of kThreads
__global__ void __launch_bounds__(kThreads)
ssd_pass_kernel(float* __restrict__ states, const float* __restrict__ decay, int nc, int H,
                int NP, int64_t total) {
  constexpr int kAhead = 8;  // chunks whose loads are in flight together
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const int np = (int)(e % NP);
  const int64_t bh = e / NP;
  const int h = (int)(bh % H);
  const int64_t b = bh / H;
  float hs = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float own[kAhead], dec[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int64_t bch = (b * nc + c0 + u) * H + h;
      own[u] = c0 + u < nc ? states[bch * NP + np] : 0.f;
      dec[u] = c0 + u < nc ? decay[bch] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (c0 + u < nc) {
        states[((b * nc + c0 + u) * H + h) * NP + np] = hs;  // the state entering the chunk
        hs = hs * dec[u] + own[u];
      }
    }
  }
}

// (3) grid (nc, H, B), dynamic smem output_smem(Q, P, N)
__global__ void __launch_bounds__(kThreads)
ssd_output_kernel(const float* __restrict__ x, const float* __restrict__ loga,
                  const float* __restrict__ cm, const float* __restrict__ gt,
                  const float* __restrict__ states, float* __restrict__ y, int S, int H, int P,
                  int N, int Q) {
  extern __shared__ double smd[];
  const int P4 = round_up(P, 4);
  const int Q8 = round_up(Q, kRows);
  double* la = smd;                                            // [Q]
  float* ela = reinterpret_cast<float*>(la + round_up(Q, 2));  // [Q8] exp(la_i)
  float* At = ela + Q8;                                        // [Q + N][Q8]
  float* Xs = At + (Q + N) * Q8;                               // [Q + N][P4]
  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.x;
  const int s0 = c * Q;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // Xs rows j < Q: x; rows Q + n: the state entering this chunk.  At rows
  // j < Q: the scores G^T, rows Q + n: c^T.  All copies in flight at once.
  load_x(Xs, P4, x, b, S, H, h, P, s0, Q);
  const float* hin = states + (((int64_t)b * nc + c) * H + h) * N * P;
  for (int n = warp; n < N; n += kThreads / 32) {
    copy_row(Xs + (Q + n) * P4, hin + n * P, P, P4, true, lane);
  }
  const float* g = gt + ((int64_t)b * nc + c) * Q * Q;
  for (int j = warp; j < Q; j += kThreads / 32) copy_row(At + j * Q8, g + j * Q, Q, Q, true, lane);
  for (int n = warp; n < N; n += kThreads / 32) {
    for (int i = lane; i < Q; i += 32) {
      const int s = s0 + i;
      cp_async4(At + (Q + n) * Q8 + i, cm + (s < S ? ((int64_t)b * S + s) * N + n : 0), s < S);
    }
  }
  chunk_cumsum(la, loga, b, S, H, h, s0, Q);
  for (int i = threadIdx.x; i < Q; i += kThreads) ela[i] = expf((float)la[i]);
  cp_async_wait_all();
  __syncthreads();

  // the scores times the decay, the exponent masked (j > i), never the
  // product; c scaled by exp(la_i)
  for (int j = warp; j < Q; j += kThreads / 32) {
    const double laj = la[j];
    for (int i = lane; i < Q; i += 32) {
      float* a = At + j * Q8 + i;
      *a = j <= i ? *a * expf((float)(la[i] - laj)) : 0.f;
    }
  }
  for (int n = warp; n < N; n += kThreads / 32) {
    for (int i = lane; i < Q; i += 32) At[(Q + n) * Q8 + i] *= ela[i];
  }
  __syncthreads();

  // each thread owns two quads of rows, a from the top of the pass and its
  // mirror from the bottom, so that every thread walks about the same
  // number of keys of the causal triangle
  const int G = P4 / 4;
  const int RT = kThreads / G;
  if (threadIdx.x >= RT * G) return;
  const int rt = threadIdx.x / G;
  const int cg = threadIdx.x - rt * G;
  for (int base = 0; base < Q; base += RT * kRows) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i0 = half == 0 ? base + 4 * rt : base + RT * kRows - 4 - 4 * rt;
      if (i0 >= Q) continue;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
      tile_mac<4>(acc, At, Q8, i0, Xs, P4, 4 * cg, 0, min(Q, i0 + 4));
      tile_mac<4>(acc, At, Q8, i0, Xs, P4, 4 * cg, Q, Q + N);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int s = s0 + i0 + r;
        if (i0 + r >= Q || s >= S) continue;
        float* yr = y + (((int64_t)b * S + s) * H + h) * P;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (4 * cg + e < P) yr[4 * cg + e] = acc[r][e];
        }
      }
    }
  }
}

int64_t max_smem(int Q, int P, int N) {
  int64_t m = scores_smem(Q, N);
  if (states_smem(Q, P, N) > m) m = states_smem(Q, P, N);
  if (output_smem(Q, P, N) > m) m = output_smem(Q, P, N);
  return m;
}

}  // namespace

// The chunk the kernels run for a requested one on `device`: min(chunk, S),
// halved until each kernel's tiles fit the device's opt-in shared memory (the
// output does not depend on the chunk).  0 when even one step does not fit;
// a negative cudaError_t when the device cannot be asked.
extern "C" int repro_ssd_kernel_chunk(int device, int chunk, int S, int P, int N) {
  int limit = 0;
  const cudaError_t e =
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int Q = chunk < S ? chunk : S;
  if (Q < 1) Q = 1;
  while (Q > 1 && max_smem(Q, P, N) > limit) Q = (Q + 1) / 2;
  return max_smem(Q, P, N) <= limit ? Q : 0;
}

// xdt / y [B, S, H, P], loga [B, S, H], b / c [B, S, N], all float32 and
// contiguous; 1 <= Q, as repro_ssd_kernel_chunk chose it; nc = ceil(S / Q);
// P <= kMaxP (else cudaErrorInvalidValue, nothing launched).
// Scratch, float32: gt [B, nc, Q, Q], states [B, nc, H, N, P], decay
// [B, nc, H].  Four launches; returns the first cudaError_t that is not 0.
extern "C" int repro_ssd_chunked(const void* xdt, const void* loga, const void* b, const void* c,
                                 void* y, void* gt, void* states, void* decay, int B, int S,
                                 int H, int P, int N, int Q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0) return 0;
  if (Q <= 0 || N <= 0 || P > kMaxP) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = (S + Q - 1) / Q;
  const float* xf = static_cast<const float*>(xdt);
  const float* lf = static_cast<const float*>(loga);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  float* gf = static_cast<float*>(gt);
  float* sf = static_cast<float*>(states);
  float* df = static_cast<float*>(decay);
  cudaError_t e;

  const size_t sm0 = (size_t)scores_smem(Q, N);
  if ((e = cudaFuncSetAttribute(ssd_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)sm0)) != cudaSuccess)
    return static_cast<int>(e);
  ssd_scores_kernel<<<dim3(nc, B), kThreads, sm0, s>>>(bf, cf, gf, S, N, Q);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);

  const size_t sm1 = (size_t)states_smem(Q, P, N);
  if ((e = cudaFuncSetAttribute(ssd_states_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)sm1)) != cudaSuccess)
    return static_cast<int>(e);
  ssd_states_kernel<<<dim3(nc, H, B), kThreads, sm1, s>>>(xf, lf, bf, sf, df, S, H, P, N, Q);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);

  const int64_t total = (int64_t)B * H * N * P;
  ssd_pass_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      sf, df, nc, H, N * P, total);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);

  const size_t sm3 = (size_t)output_smem(Q, P, N);
  if ((e = cudaFuncSetAttribute(ssd_output_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)sm3)) != cudaSuccess)
    return static_cast<int>(e);
  ssd_output_kernel<<<dim3(nc, H, B), kThreads, sm3, s>>>(xf, lf, cf, gf, sf,
                                                          static_cast<float*>(y), S, H, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}
