// Flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas kernel flash_attention_kernel of
// src/repro/kernels/flash_attention.py (body _kernel).
//
//   out[b, i, h, :] = softmax_j(scale * q[b, i, h, :] . k[b, j, h / rep, :]) v[b, j, h / rep, :]
//
// over the keys j visible from query i: j < Sk, j <= i + Sk - Sq when
// causal, j > i + Sk - Sq - window when a window is set.  rep = H / KV (GQA:
// the KV head is found from the query head, K/V are never repeated).
//
// What bounds it on an H100: operations.  Each visible (query, key) pair
// costs 4 * D flops (QK^T and PV) against a few bytes of q/k/v/out, so the
// least time is the visible band's flops over the peak rate of the input
// type.  This first kernel does them as fp32 FMAs on the CUDA cores (no
// wgmma, no TMA), so it sits well above that bound; making it fast is later
// work (ROADMAP).
//
// Design (simple and right first):
//  * One CTA per (query tile of kBQ rows, query head, batch).  Four threads
//    own one query row; each holds a quarter of the row of q and of the fp32
//    accumulator in registers (D / 4 values each, interleaved in float4
//    chunks so the four threads read four neighbouring float4 of a shared
//    K/V row and the eight rows of a warp read the same ones: broadcast).
//  * Key tiles of kBK rows are staged in shared memory as fp32 (bf16 is
//    widened on the load).  Scores go to a padded [kBQ][kBK + 4] shared
//    tile, the row's running max and denominator stay in registers, and each
//    tile rescales the accumulator once (online softmax, as the TPU kernel).
//  * Tiles wholly outside the causal / window band are never visited: the
//    TPU grid had to visit every tile of the score square, here the CTA
//    walks only [first visible key of its first row, last visible key of its
//    last row].  Within a visited tile the mask is built from absolute
//    positions, so ragged Sq / Sk need no padding copies.
//  * A row that has seen no visible key yet keeps m = -inf and adds nothing;
//    one that never sees any (outside the contract) writes zeros.
//  * Nothing synchronises the device or allocates; the launch goes on the
//    caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;             // query rows per CTA
constexpr int kBK = 64;             // keys per shared tile
constexpr int kT = 4;               // threads per query row
constexpr int kThreads = kBQ * kT;  // 256
constexpr int kSStride = kBK + 4;   // padded score row: conflict-free for 8 rows x 4 threads

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float group_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

template <int D>
constexpr size_t smem_bytes() {
  return (2 * kBK * D + kBQ * kSStride) * sizeof(float);
}

// grid (ceil(Sq / kBQ), H, B), block kThreads, dynamic smem smem_bytes<D>()
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int Sq, int Sk, int H, int KV, int causal, int window,
                 float scale) {
  constexpr int kC = D / 4 / kT;  // float4 chunks per thread
  static_assert(kC >= 1 && D % (4 * kT) == 0, "head_dim must be a multiple of 16");
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [kBK][D]
  float* Vs = Ks + kBK * D;                     // [kBK][D]
  float* Ss = Vs + kBK * D;                     // [kBQ][kSStride]

  const int tid = threadIdx.x;
  const int r = tid / kT;
  const int t = tid % kT;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int off = Sk - Sq;
  const int qi = q0 + r;
  const bool row_ok = qi < Sq;
  const int qpos = qi + off;

  const int64_t qrow = ((int64_t)b * Sq + qi) * H * D + (int64_t)h * D;
  float4 qr[kC];
  float4 acc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int d0 = 4 * (t + kT * c);
    qr[c] = row_ok ? make_float4(widen(q[qrow + d0]), widen(q[qrow + d0 + 1]),
                                 widen(q[qrow + d0 + 2]), widen(q[qrow + d0 + 3]))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY;
  float l = 0.f;

  // keys any row of this tile can see
  const int rows = min(kBQ, Sq - q0);
  const int qlo = q0 + off;
  const int qhi = q0 + rows - 1 + off;
  const int kend = causal ? min(Sk, qhi + 1) : Sk;
  const int kbeg = window > 0 ? max(0, qlo - window + 1) / kBK * kBK : 0;

  const int64_t kvbase = (int64_t)b * Sk * KV * D + (int64_t)kvh * D;
  const int64_t kvstride = (int64_t)KV * D;
  float* srow = Ss + r * kSStride;

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int j = e / D;
      const int d = e - j * D;
      const int kp = k0 + j;
      float kk = 0.f, vv = 0.f;
      if (kp < Sk) {
        const int64_t idx = kvbase + kp * kvstride + d;
        kk = widen(k[idx]);
        vv = widen(v[idx]);
      }
      Ks[e] = kk;
      Vs[e] = vv;
    }
    __syncthreads();

    // scores of this row against the tile; thread (j % kT) stores column j
    for (int j = 0; j < kBK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(Ks + j * D);
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c) s = dot4(qr[c], kr[t + kT * c], s);
      s = group_sum(s);
      const int kp = k0 + j;
      const bool vis = kp < Sk && (!causal || kp <= qpos) && (window <= 0 || kp > qpos - window);
      if ((j % kT) == t) srow[j] = vis ? s * scale : -INFINITY;
    }
    __syncwarp();

    float mt = -INFINITY;
#pragma unroll
    for (int i = 0; i < kBK / kT; ++i) mt = fmaxf(mt, srow[t + kT * i]);
    const float mnew = fmaxf(m, group_max(mt));
    const bool any = mnew > -INFINITY;
    const float alpha = any ? expf(m - mnew) : 1.f;
    float ls = 0.f;
#pragma unroll
    for (int i = 0; i < kBK / kT; ++i) {
      const int j = t + kT * i;
      const float p = any ? expf(srow[j] - mnew) : 0.f;
      srow[j] = p;
      ls += p;
    }
    l = l * alpha + group_sum(ls);
    m = any ? mnew : m;
    __syncwarp();

#pragma unroll
    for (int c = 0; c < kC; ++c) {
      acc[c].x *= alpha;
      acc[c].y *= alpha;
      acc[c].z *= alpha;
      acc[c].w *= alpha;
    }
    for (int j = 0; j < kBK; ++j) {
      const float p = srow[j];
      const float4* vr = reinterpret_cast<const float4*>(Vs + j * D);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float4 x = vr[t + kT * c];
        acc[c].x = fmaf(p, x.x, acc[c].x);
        acc[c].y = fmaf(p, x.y, acc[c].y);
        acc[c].z = fmaf(p, x.z, acc[c].z);
        acc[c].w = fmaf(p, x.w, acc[c].w);
      }
    }
  }

  if (row_ok) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d0 = 4 * (t + kT * c);
      out[qrow + d0] = narrow<T>(acc[c].x / den);
      out[qrow + d0 + 1] = narrow<T>(acc[c].y / den);
      out[qrow + d0 + 2] = narrow<T>(acc[c].z / den);
      out[qrow + d0 + 3] = narrow<T>(acc[c].w / den);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk, int H,
           int KV, int causal, int window, float scale, cudaStream_t s) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, H, KV, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* out, int B, int Sq,
               int Sk, int H, int KV, int causal, int window, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/out [B, Sq, H, D], k/v [B, Sk, KV, D],
// all contiguous.  window <= 0 means none.  Returns a cudaError_t.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                     void* out, int B, int Sq, int Sk, int H, int KV, int D,
                                     int causal, int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_d<float>(D, q, k, v, out, B, Sq, Sk, H, KV, causal, window, scale, s);
  }
  if (dtype == 1) {
    return dispatch_d<__nv_bfloat16>(D, q, k, v, out, B, Sq, Sk, H, KV, causal, window, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
