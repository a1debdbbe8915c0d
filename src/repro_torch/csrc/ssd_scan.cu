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
// Design (simple and right first):
//  * One CTA per (head, batch) walks the chunks in order; the state lives
//    in shared memory for the whole sequence, so nothing is carried between
//    CTAs and there is no second pass.
//  * Per chunk the CTA stages X [Q][P], b / c [Q][N + 1] (padded rows) and
//    la (its cumsum taken in float64) in shared memory, builds the
//    decay-weighted score matrix W [Q][Q] = (c b^T) o exp(la_i - la_j) for j <= i and 0 above the
//    diagonal (the exponent is masked, never the product: exp of a positive
//    sum would overflow), then one thread per output computes y = W X +
//    exp(la) (c hs) and one thread per state entry the new state.
//  * The kernel reads [B, S, H, P] in place with the head's stride: no
//    head-major transposes as in the TPU wrapper.
//  * W at Q = 128 is 64 KB, so shared memory is dynamic (opted in with
//    cudaFuncSetAttribute); repro_ssd_kernel_chunk picks a smaller chunk
//    when a shape would not fit (the output does not depend on the chunk).
//  * No atomics: one thread owns each output and each state entry.  Nothing
//    synchronises the device or allocates; the launch goes on the caller's
//    stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// floats of dynamic shared memory for one CTA
__host__ __device__ inline int64_t smem_floats(int Q, int P, int N) {
  return (int64_t)Q * Q + (int64_t)Q * P + 2LL * Q * (N + 1) + (int64_t)N * P + 4LL * Q;
}

// grid (H, B), block kThreads, dynamic smem smem_floats(Q, P, N) * 4 bytes
__global__ void __launch_bounds__(kThreads)
ssd_chunked_kernel(const float* __restrict__ x, const float* __restrict__ loga,
                   const float* __restrict__ bm, const float* __restrict__ cm,
                   float* __restrict__ y, int S, int H, int P, int N, int Q) {
  extern __shared__ double smd[];
  double* la = smd;           // [Q] inclusive cumsum of loga, in float64
  float* sm = reinterpret_cast<float*>(la + Q);
  const int NS = N + 1;
  float* Ws = sm;             // [Q][Q]
  float* Xs = Ws + Q * Q;     // [Q][P]
  float* Bs = Xs + Q * P;     // [Q][NS]
  float* Cs = Bs + Q * NS;    // [Q][NS]
  float* hs = Cs + Q * NS;    // [N][P]
  float* wend = hs + N * P;   // [Q] exp(la_end - la_j)
  float* ela = wend + Q;      // [Q] exp(la_i)

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int64_t xrow = (int64_t)H * P;  // x / y stride of one step

  for (int e = tid; e < N * P; e += kThreads) hs[e] = 0.f;

  for (int s0 = 0; s0 < S; s0 += Q) {
    __syncthreads();  // the previous chunk is done with Xs, Bs, Cs, la, hs
    for (int e = tid; e < Q * P; e += kThreads) {
      const int i = e / P;
      const int p = e - i * P;
      const int s = s0 + i;
      Xs[e] = s < S ? x[((int64_t)b * S + s) * xrow + (int64_t)h * P + p] : 0.f;
    }
    for (int e = tid; e < Q * N; e += kThreads) {
      const int i = e / N;
      const int n = e - i * N;
      const int s = s0 + i;
      const int64_t src = ((int64_t)b * S + s) * N + n;
      Bs[i * NS + n] = s < S ? bm[src] : 0.f;
      Cs[i * NS + n] = s < S ? cm[src] : 0.f;
    }
    for (int i = tid; i < Q; i += kThreads) {
      const int s = s0 + i;
      la[i] = s < S ? loga[((int64_t)b * S + s) * H + h] : 0.f;
    }
    __syncthreads();

    // inclusive cumsum of la by the first warp, 32 steps at a time, in
    // float64: |la| reaches Q |loga|, where a float32 ulp would cost the
    // decay factors exp(la_i - la_j) their last digits
    if (tid < 32) {
      double carry = 0.0;
      for (int base = 0; base < Q; base += 32) {
        const int i = base + tid;
        double val = i < Q ? la[i] : 0.0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const double u = __shfl_up_sync(0xffffffffu, val, o);
          if (tid >= o) val += u;
        }
        val += carry;
        if (i < Q) la[i] = val;
        carry = __shfl_sync(0xffffffffu, val, 31);
      }
    }
    __syncthreads();

    const double la_end = la[Q - 1];
    for (int i = tid; i < Q; i += kThreads) {
      wend[i] = expf((float)(la_end - la[i]));
      ela[i] = expf((float)la[i]);
    }
    for (int e = tid; e < Q * Q; e += kThreads) {
      const int i = e / Q;
      const int j = e - i * Q;
      float w = 0.f;
      if (j <= i) {
        float sc = 0.f;
        for (int n = 0; n < N; ++n) sc = fmaf(Cs[i * NS + n], Bs[j * NS + n], sc);
        w = sc * expf((float)(la[i] - la[j]));
      }
      Ws[e] = w;
    }
    __syncthreads();

    for (int e = tid; e < Q * P; e += kThreads) {
      const int i = e / P;
      const int p = e - i * P;
      float acc = 0.f;
      for (int j = 0; j <= i; ++j) acc = fmaf(Ws[i * Q + j], Xs[j * P + p], acc);
      float ch = 0.f;
      for (int n = 0; n < N; ++n) ch = fmaf(Cs[i * NS + n], hs[n * P + p], ch);
      const int s = s0 + i;
      if (s < S) y[((int64_t)b * S + s) * xrow + (int64_t)h * P + p] = acc + ela[i] * ch;
    }
    __syncthreads();  // every read of the incoming state is done

    const float dend = expf((float)la_end);
    for (int e = tid; e < N * P; e += kThreads) {
      const int n = e / P;
      const int p = e - n * P;
      float acc = 0.f;
      for (int j = 0; j < Q; ++j) acc = fmaf(Bs[j * NS + n] * wend[j], Xs[j * P + p], acc);
      hs[e] = hs[e] * dend + acc;
    }
  }
}

}  // namespace

// The chunk the kernel runs for a requested one on `device`: min(chunk, S),
// halved until one CTA's tiles fit the device's opt-in shared memory (the
// output does not depend on the chunk).  0 when even one step does not fit;
// a negative cudaError_t when the device cannot be asked.
extern "C" int repro_ssd_kernel_chunk(int device, int chunk, int S, int P, int N) {
  int limit = 0;
  const cudaError_t e =
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int Q = chunk < S ? chunk : S;
  if (Q < 1) Q = 1;
  while (Q > 1 && smem_floats(Q, P, N) * (int64_t)sizeof(float) > limit) Q = (Q + 1) / 2;
  return smem_floats(Q, P, N) * (int64_t)sizeof(float) <= limit ? Q : 0;
}

// xdt / y [B, S, H, P], loga [B, S, H], b / c [B, S, N], all float32 and
// contiguous; 1 <= Q, as repro_ssd_kernel_chunk chose it.  Returns a
// cudaError_t.
extern "C" int repro_ssd_chunked(const void* xdt, const void* loga, const void* b, const void* c,
                                 void* y, int B, int S, int H, int P, int N, int Q,
                                 void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0) return 0;
  if (Q <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)smem_floats(Q, P, N) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(ssd_chunked_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(H, B);
  ssd_chunked_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xdt), static_cast<const float*>(loga),
      static_cast<const float*>(b), static_cast<const float*>(c), static_cast<float*>(y), S, H,
      P, N, Q);
  return static_cast<int>(cudaGetLastError());
}
