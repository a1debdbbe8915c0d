// Flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas kernel flash_attention_kernel of
// src/repro/kernels/flash_attention.py (body _kernel).
//
//   out[b, i, h, :] = softmax_j(scale * q[b, i, h, :] . k[b, j, h / rep, :]) v[b, j, h / rep, :]
//
// over the keys j visible from query i: j < Sk, j <= i + Sk - Sq when
// causal, j > i + Sk - Sq - window when a window is set.  rep = H / KV (GQA:
// the KV head is found from the query head, K/V are never repeated).  q and
// k are DQK wide, v and out DV wide.  Compiled: every DQK = DV that is a
// multiple of 16 up to 128 (REPRO_HEAD_DIMS), and the unequal pairs of the
// served MLA configs (REPRO_HEAD_PAIRS: deepseek-v2-lite's 192 / 128 and its
// tiny preset's 48 / 32).  An unequal pair gets its own tiles: K rows DQK
// wide, V rows and the output accumulator DV wide, so no product is spent
// on padding.
//
// What bounds it on an H100: operations.  Each visible (query, key) pair
// costs 2 * (DQK + DV) flops (QK^T and PV) against a few bytes of q/k/v/out, so the
// least time is the visible band's flops over the peak rate of the input
// type (989 TFLOP/s dense bf16 on the tensor cores, 67 TFLOP/s fp32).  The
// bf16 kernels issue 2 * DQK + 4 * DV per pair (P V twice, below): at
// (80, 80) and (128, 128) 1.5x the bound's work, at (192, 128) 1.4x.
//
// Three routes, by width pair and dtype (REPRO_WGMMA_PAIRS; the wrapper's
// kernel_route says the same):
//   bf16 at (64, 64), (80, 80), (128, 128), (192, 128)  flash_fwd_bf16_wgmma
//   bf16 at every other compiled pair                    flash_fwd_bf16 (mma.sync)
//   f32 at every compiled pair                           flash_fwd_f32
// so every bf16 width a served config uses at full size runs wgmma; only the
// tiny presets' widths run mma.sync.
// All three keep the band rules:
//  * only the key tiles inside the causal / window band are visited (the
//    CTA walks from its first row's first visible key to its last row's
//    last one; a warp or warpgroup skips the tiles its own rows cannot
//    see).  The mask is built from absolute positions, only on tiles that
//    straddle a band edge or Sk; interior tiles need none, and ragged Sq /
//    Sk need no padding copy (keys past Sk load as zeros and are masked);
//  * a row that has seen no visible key yet keeps m = -inf and adds
//    nothing; one that never sees any (outside the contract) writes zeros.
// The two bfloat16 kernels share the softmax and the product:
//  * the online softmax stays in registers (row max and sum by quad
//    shuffles over the accumulator layout, in the log2 domain), and P is
//    fed to O += P V from the S accumulators as a bf16 high part plus its
//    bf16 residual, both multiplied: one bf16 rounding of P would cost up
//    to 2^-9 of each term, more than the output check against float32
//    allows; hi + lo leaves only the output's own bf16 rounding.
//
// bfloat16 at REPRO_WGMMA_PAIRS -- flash_fwd_bf16_wgmma<DQK, DV>, Hopper's
// shape: one CTA per (128 query rows, query head, batch) of two consumer
// warpgroups (64 rows each) and a producer warpgroup.  One producer thread
// loads q once and keeps a ring of two K/V tiles of 128 keys in flight by
// TMA (tensor maps from cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint: no -lcuda), gated by full / empty mbarriers;
// TMA's 128-byte swizzle is the layout wgmma reads and its zero fill covers
// rows past Sq / Sk.  A swizzle row holds 64 bf16, so q, k and v load as
// boxes of 64 columns, one per sub-tile (q / k at 192: three, at 128: two;
// v at 128: two), each its own 16 KB tile.  S = Q K^T is wgmma m64n128k16
// with both operands in shared memory, four k-steps per sub-tile, each
// sub-tile from its own descriptor.  O += P V takes P from registers and V
// MN-major: at DV 64 one m64n64k16 per k-step; at DV 128 one m64n128k16
// whose descriptor's leading byte offset is the 16 KB sub-tile stride
// (chosen over two m64n64k16 on two halves of O: half the instructions per
// k-step, and the same accumulator layout, flat).
// stablelm-3b's 80 is no whole number of swizzle rows (a row is 160 bytes).
// It loads as two boxes, as 128 does: the tensor map is 80 columns wide, so
// the second box reads columns 64..79 and TMA fills 80..127 with zeros (and
// counts the whole box in the barrier's bytes, as for rows past Sk).  Q K^T
// takes the five k-steps 80 needs (four on the first sub-tile, one on the
// second), and P V one m64n80k16 whose descriptor spans the first sub-tile
// and 16 columns of the second, LBO apart: every product exact.  Timed on
// the H100 against two candidates (chip_b3_layouts.py): the same with P V
// as m64n128 (48 columns of zeros) 13-15% slower, and 16-column boxes in
// the 32-byte swizzle (five sub-tiles of 4 KB, every operand exact, 100 KB
// of shared memory) 1-3% slower.  Budget: shared memory 80 KB at (64, 64), 160 KB at (80, 80) and
// (128, 128), 208 KB at (192, 128) (q 48 + K 2 x 48 + V 2 x 32), under the
// 227 KB a block may use.  Registers: a consumer thread holds O (DV / 2),
// S (64) and P hi + lo (64, written as S dies) -- about 200 at DV 128 with
// addresses.  A block of 288 threads (one producer warp) is allocated as
// three warpgroups, 168 registers a thread, and spills at these widths; so
// the producer is a whole warpgroup that setmaxnreg's down to 24 and the
// consumers up to 240 (ptxas -v at (64, 64), (80, 80), (128, 128) and
// (192, 128) alike: 168 registers at entry, 0 bytes of spill stores and
// loads).  Each warpgroup waits on its Q K^T
// before its softmax and on its P V before the next tile; the two
// warpgroups overlap each other.  Issuing the next tile's Q K^T before this
// tile's softmax would hold a second S (64 registers) beside O and P hi +
// lo, at the edge of 240; it is not done.
//
// bfloat16, other widths -- flash_fwd_bf16: mma.sync.m16n8k16 (the
// FlashAttention-2 shape).  One CTA per (128 query rows, query head,
// batch), eight warps of 16 rows; q loaded once into mma A fragments; K/V
// tiles of 64 keys by cp.async into two shared stages, rows padded by 16
// bytes so the ldmatrix reads (x4 for K, x4.trans for V) are free of bank
// conflicts at every width.  It serves the tiny presets' widths; it takes
// every width and every pair, and is reachable at the wgmma pairs through
// repro_flash_attention_bf16_mma, for timing the two.  At DQK 192 / DV 128
// a thread holds 48 registers of q fragments, 64 of O and 32 of S (244
// registers, no spills); the two stages of K and V tiles take 86,016 bytes
// of shared memory (opt-in above 48 KB).
//
// float32 -- flash_fwd_f32: exact fp32 on the CUDA cores (the tensor
// cores' TF32 would cost the float32 checks their digits).  One CTA per
// (64 query rows, query head, batch); four threads own one query row, each
// holding a quarter of q and of the accumulator in registers (interleaved
// float4 chunks, so a warp's eight rows read the same K/V float4 from
// shared memory as a broadcast); K/V tiles of 64 keys in shared memory;
// scores through a padded shared tile.
//
// Nothing synchronises the device or allocates; the launch goes on the
// caller's stream and returns cudaGetLastError().

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define REPRO_HEAD_DIMS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)
// (DQK, DV) with DQK != DV: deepseek-v2-lite-16b (full, 100m) and its tiny preset
#define REPRO_HEAD_PAIRS(X) X(192, 128) X(48, 32)
// the pairs whose bfloat16 runs flash_fwd_bf16_wgmma (the rest: flash_fwd_bf16)
#define REPRO_WGMMA_PAIRS(X) X(64, 64) X(80, 80) X(128, 128) X(192, 128)

namespace {

constexpr int kBK = 64;  // keys per shared tile (both kernels)

__device__ __forceinline__ bool visible(int kp, int qpos, int Sk, int causal, int window) {
  return kp < Sk && (!causal || kp <= qpos) && (window <= 0 || kp > qpos - window);
}

// first key tile (aligned to kBK) and end key of the band seen by query
// rows [r0, r0 + rows) at key offset off
__device__ __forceinline__ void band(int r0, int rows, int off, int Sk, int causal, int window,
                                     int& kbeg, int& kend) {
  kend = causal ? min(Sk, r0 + rows - 1 + off + 1) : Sk;
  kbeg = window > 0 ? max(0, r0 + off - window + 1) / kBK * kBK : 0;
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarpsTC = 8;                // each owns 16 query rows (one mma tile)
constexpr int kBQTC = 16 * kWarpsTC;       // 128 query rows per CTA
constexpr int kThreadsTC = 32 * kWarpsTC;
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

template <int DQK, int DV>
constexpr size_t smem_bytes_tc() {
  return (size_t)kStages * kBK * ((DQK + 8) + (DV + 8)) * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) -> bf16x2 high part (x0 in the low half) and the residual's bf16x2
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h)));
}

// grid (ceil(Sq / kBQTC), H, B), block kThreadsTC, dynamic smem smem_bytes_tc<DQK, DV>()
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int Sq,
               int Sk, int H, int KV, int causal, int window, float scale_log2) {
  static_assert(DQK % 16 == 0 && DQK <= 192, "q/k width must be a multiple of 16 up to 192");
  static_assert(DV % 16 == 0 && DV <= 128, "v width must be a multiple of 16 up to 128");
  constexpr int kSK = DQK + 8;      // shared row strides (elements): 16-byte rows, no conflicts
  constexpr int kSV = DV + 8;
  constexpr int kKT = DQK / 16;     // k-steps of Q K^T
  constexpr int kNT = kBK / 8;      // n-tiles of S
  constexpr int kDT = DV / 8;       // n-tiles of O
  constexpr int kChunksK = DQK / 8; // 16-byte chunks per K row
  constexpr int kChunksV = DV / 8;  // and per V row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kStages][kBK][kSK]
  __nv_bfloat16* Vs = Ks + kStages * kBK * kSK;                      // [kStages][kBK][kSV]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // accumulator row (and row + 8)
  const int t = lane % 4;  // accumulator column pair
  const int q0 = blockIdx.x * kBQTC;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int off = Sk - Sq;

  int kbeg, kend;
  band(q0, min(kBQTC, Sq - q0), off, Sk, causal, window, kbeg, kend);
  const int ntiles = kend > kbeg ? (kend - kbeg + kBK - 1) / kBK : 0;

  // this warp's rows and the keys any of them sees
  const int w0 = q0 + warp * 16;
  const int wrows = min(16, Sq - w0);
  const int wlo = window > 0 ? max(0, w0 + off - window + 1) : 0;
  const int whi = causal ? min(Sk - 1, w0 + wrows - 1 + off) : Sk - 1;
  const int rows[2] = {w0 + g, w0 + g + 8};

  // q rows as mma A fragments, loaded once
  const int64_t qstride = (int64_t)H * DQK;
  const __nv_bfloat16* qb = q + (int64_t)b * Sq * qstride + (int64_t)h * DQK;
  uint32_t qf[kKT][4];
#pragma unroll
  for (int kk = 0; kk < kKT; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = rows[e & 1];
      const int d = kk * 16 + 2 * t + (e >> 1) * 8;
      qf[kk][e] = r < Sq ? *reinterpret_cast<const uint32_t*>(qb + r * qstride + d) : 0u;
    }
  }

  float o[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
  float l[2] = {0.f, 0.f};              // this thread's share of the row sums

  const int64_t kstride = (int64_t)KV * DQK;
  const int64_t vstride = (int64_t)KV * DV;
  const __nv_bfloat16* kb = k + (int64_t)b * Sk * kstride + (int64_t)kvh * DQK;
  const __nv_bfloat16* vb = v + (int64_t)b * Sk * vstride + (int64_t)kvh * DV;

  auto load_tile = [&](int tile, int stage) {
    const int k0 = kbeg + tile * kBK;
    __nv_bfloat16* ks = Ks + stage * kBK * kSK;
    __nv_bfloat16* vs = Vs + stage * kBK * kSV;
    for (int e = tid; e < kBK * kChunksK; e += kThreadsTC) {
      const int j = e / kChunksK;
      const int c = e - j * kChunksK;
      const bool ok = k0 + j < Sk;
      cp_async16(smem_addr(ks + j * kSK + c * 8), kb + (ok ? (int64_t)(k0 + j) * kstride : 0) + c * 8, ok);
    }
    for (int e = tid; e < kBK * kChunksV; e += kThreadsTC) {
      const int j = e / kChunksV;
      const int c = e - j * kChunksV;
      const bool ok = k0 + j < Sk;
      cp_async16(smem_addr(vs + j * kSV + c * 8), vb + (ok ? (int64_t)(k0 + j) * vstride : 0) + c * 8, ok);
    }
  };

  // ldmatrix row / column of this lane inside an x4 load (matrix lane / 8)
  const int lm = lane >> 3;
  const int lr = lane & 7;

  if (ntiles > 0) load_tile(0, 0);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_tile(it + 1, (it + 1) % kStages);
    cp_async_commit();
    cp_async_wait1();  // tile it has landed
    __syncthreads();

    const int k0 = kbeg + it * kBK;
    if (wrows > 0 && k0 <= whi && k0 + kBK - 1 >= wlo) {
      const __nv_bfloat16* ks = Ks + (it % kStages) * kBK * kSK;
      const __nv_bfloat16* vs = Vs + (it % kStages) * kBK * kSV;

      // S = Q K^T: B[d][j] = K[j][d]; matrices (keys +0/+8) x (d +0/+8)
      float s[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t b0, b1, b2, b3;
          const int row = np * 16 + (lm >> 1) * 8 + lr;
          const int col = kk * 16 + (lm & 1) * 8;
          ldmatrix_x4(smem_addr(ks + row * kSK + col), b0, b1, b2, b3);
          mma_bf16(s[2 * np], qf[kk], b0, b1);
          mma_bf16(s[2 * np + 1], qf[kk], b2, b3);
        }
      }

      // mask only a tile on a band edge or past Sk
      const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > w0 + off) ||
                        (window > 0 && k0 <= w0 + 15 + off - window);
      if (edge) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = k0 + nt * 8 + 2 * t + (e & 1);
            if (!visible(kp, rows[e >> 1] + off, Sk, causal, window)) s[nt][e] = -INFINITY;
          }
        }
      }
      // online softmax in the log2 domain, rows g and g + 8; quads share a row
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]) * scale_log2);
        mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]) * scale_log2);
      }
      float msafe[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        msafe[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // nothing visible yet: p = 0
        const float alpha = exp2f(m[r] - msafe[r]);
        m[r] = mx[r];
        l[r] *= alpha;
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt) {
          o[dt][2 * r] *= alpha;
          o[dt][2 * r + 1] *= alpha;
        }
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(s[nt][e], scale_log2, -msafe[e >> 1]));
          s[nt][e] = p;
          l[e >> 1] += p;
        }
      }

      // O += P V: the S accumulators of keys 16 kk2 .. + 15 are the A
      // fragment (a bf16 high part and the residual's bf16); B[j][d] = V[j][d]
      // by ldmatrix.trans, matrices (keys +0/+8) x (d +0/+8)
#pragma unroll
      for (int kk2 = 0; kk2 < kNT / 2; ++kk2) {
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // a0..a3: rows g, g + 8 of keys +0, then of keys +8
          const int nt = 2 * kk2 + (e >> 1);
          const int c = 2 * (e & 1);
          split_bf16(s[nt][c], s[nt][c + 1], ahi[e], alo[e]);
        }
#pragma unroll
        for (int dp = 0; dp < DV / 16; ++dp) {
          uint32_t v0, v1, v2, v3;
          const int row = kk2 * 16 + (lm & 1) * 8 + lr;
          const int col = dp * 16 + (lm >> 1) * 8;
          ldmatrix_x4_trans(smem_addr(vs + row * kSV + col), v0, v1, v2, v3);
          mma_bf16(o[2 * dp], ahi, v0, v1);
          mma_bf16(o[2 * dp], alo, v0, v1);
          mma_bf16(o[2 * dp + 1], ahi, v2, v3);
          mma_bf16(o[2 * dp + 1], alo, v2, v3);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  const int64_t ostride = (int64_t)H * DV;
  __nv_bfloat16* ob = out + (int64_t)b * Sq * ostride + (int64_t)h * DV;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float den = l[r];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    const float inv = 1.f / fmaxf(den, 1e-30f);
    if (rows[r] >= Sq) continue;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(ob + rows[r] * ostride + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 at REPRO_WGMMA_PAIRS: wgmma, TMA and a producer warpgroup
// ---------------------------------------------------------------------------

namespace wg {
constexpr int kSw = 64;                      // bf16 of one 128-byte swizzle row: a sub-tile's width
constexpr int kBM = 128;                     // query rows per CTA: two consumer warpgroups
constexpr int kBN = 128;                     // keys per tile
constexpr int kRing = 2;                     // K/V tiles in flight
constexpr int kConsumers = 256;              // threads of the two consumer warpgroups
constexpr int kThreads = kConsumers + 128;   // + one producer warpgroup
// setmaxnreg: the producer gives back what the consumers take (the block
// starts at 65,536 / 384 = 168 a thread), 128 x 24 + 256 x 240 <= 65,536
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr uint32_t kSub = kBN * kSw * 2;     // bytes of a sub-tile: 128 rows of one swizzle row
constexpr uint32_t kSubDesc = kSub >> 4;     // the same step in a wgmma descriptor's address
// shared layout from a 1024-byte aligned base (the 128-byte swizzle's period):
// q, then the ring of K tiles, then that of V tiles, each row DQK (DV) wide
// as ceil(DQK / 64) (ceil(DV / 64)) sub-tiles of 64 columns, then the
// barriers.  A width of no whole number of swizzle rows (80) leaves the
// columns of its last sub-tile past the width to TMA's zero fill
template <int DQK, int DV>
struct Layout {
  static_assert(DQK % 16 == 0 && DV % 16 == 0 && DV <= 128, "wgmma widths: k-steps of 16, O up to n128");
  static constexpr int kCQK = (DQK + kSw - 1) / kSw;  // sub-tiles of a q / k row
  static constexpr int kCV = (DV + kSw - 1) / kSw;    // and of a v row
  static constexpr uint32_t kQBytes = kCQK * kSub;
  static constexpr uint32_t kKBytes = kCQK * kSub;
  static constexpr uint32_t kVBytes = kCV * kSub;
  static constexpr uint32_t kOffK = kQBytes;
  static constexpr uint32_t kOffV = kOffK + kRing * kKBytes;
  static constexpr uint32_t kOffBar = kOffV + kRing * kVBytes;
  static constexpr size_t kSmemBytes = kOffBar + 8 * (2 * kRing + 1) + 1024;
};
}  // namespace wg

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// returns once the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// box of `map` at coordinates (c0, c1, c2, c3) -> shared dst, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a tile of 128-byte rows in the 128-byte
// swizzle TMA writes: 8-row groups 1024 bytes apart (SBO), layout type 1.
// lbo (in 16-byte units) is read only for an MN-major operand wider than
// one swizzle row: the step from one 64-column sub-tile to the next
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo = 1) {
  return ((uint64_t)(smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) | (64ull << 32) |
         (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// d (m64 x n128, fp32) = A (desc, K-major) * B (desc, K-major) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_m64n128_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64 x n64, fp32) += A (registers, bf16 fragment) * B (desc, MN-major)
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n80, fp32) += A (registers, bf16 fragment) * B (desc, MN-major,
// a 64-column sub-tile and the first 16 columns of the next, LBO apart)
__device__ __forceinline__ void wgmma_m64n80_rs(float (&d)[40], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n128, fp32) += A (registers, bf16 fragment) * B (desc, MN-major,
// two 64-column sub-tiles LBO apart)
__device__ __forceinline__ void wgmma_m64n128_rs(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V for one k-step of 16 keys: an m64n64 product at DV 64, one
// m64n80 or m64n128 product over V's two sub-tiles at DV 80 or 128
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_m64n64_rs(d, a, db);
}
__device__ __forceinline__ void wgmma_pv(float (&d)[40], const uint32_t (&a)[4], uint64_t db) {
  wgmma_m64n80_rs(d, a, db);
}
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  wgmma_m64n128_rs(d, a, db);
}

// grid (ceil(Sq / 128), H, B), block wg::kThreads, dynamic smem
// Layout<DQK, DV>::kSmemBytes.  Warpgroups 0 and 1 each own 64 query rows;
// warpgroup 2 gives up its registers and one of its threads issues the TMA
// loads of q (once) and of the K/V ring, one box per 64-column sub-tile,
// gated by full / empty mbarriers.
template <int DQK, int DV>
__global__ void __launch_bounds__(wg::kThreads, 1)
flash_fwd_bf16_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                     int Sq, int Sk, int H, int KV, int causal, int window, float scale_log2) {
  using namespace wg;
  using L = Layout<DQK, DV>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kOffBar);
  uint64_t* empty = full + kRing;
  uint64_t* qbar = empty + kRing;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = Sk - Sq;
  int kbeg, kend;
  band(q0, min(kBM, Sq - q0), off, Sk, causal, window, kbeg, kend);
  const int ntiles = kend > kbeg ? (kend - kbeg + kBN - 1) / kBN : 0;

  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup: one thread issues every copy
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      const int kvh = h / (H / KV);
      mbar_expect_tx(qbar, L::kQBytes);
#pragma unroll
      for (int c = 0; c < L::kCQK; ++c) tma_load(base + c * kSub, &tq, qbar, c * kSw, h, q0, b);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % kRing;
        const int k0 = kbeg + it * kBN;
        mbar_wait(&empty[s], ((it / kRing) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(&full[s], L::kKBytes + L::kVBytes);
#pragma unroll
        for (int c = 0; c < L::kCQK; ++c) {
          tma_load(base + L::kOffK + s * L::kKBytes + c * kSub, &tk, &full[s], c * kSw, kvh, k0, b);
        }
#pragma unroll
        for (int c = 0; c < L::kCV; ++c) {
          tma_load(base + L::kOffV + s * L::kVBytes + c * kSub, &tv, &full[s], c * kSw, kvh, k0, b);
        }
      }
    }
  } else {  // the two consumer warpgroups
    setmaxnreg_inc<kConsumerRegs>();
    const int wgi = tid / 128;
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int g0 = q0 + wgi * 64;  // this warpgroup's rows and the keys any of them sees
    const int grows = min(64, Sq - g0);
    const int glo = window > 0 ? max(0, g0 + off - window + 1) : 0;
    const int ghi = causal ? min(Sk - 1, g0 + grows - 1 + off) : Sk - 1;
    const int rows[2] = {g0 + warp * 16 + g, g0 + warp * 16 + g + 8};

    float o[DV / 2];  // the m64n64 (m64n80, m64n128) accumulator of P V
#pragma unroll
    for (int e = 0; e < DV / 2; ++e) o[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    const uint64_t dq = desc_sw128(base + wgi * 64 * kSw * 2);

    mbar_wait(qbar, 0);
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % kRing;
      mbar_wait(&full[s], (it / kRing) & 1);
      const int k0 = kbeg + it * kBN;
      if (grows > 0 && k0 <= ghi && k0 + kBN - 1 >= glo) {
        const uint64_t dk = desc_sw128(base + L::kOffK + s * L::kKBytes);
        const uint64_t dv = desc_sw128(base + L::kOffV + s * L::kVBytes, L::kCV == 2 ? kSubDesc : 1);
        // S = Q K^T: DQK / 16 k-steps of 16 columns (32 bytes of the
        // swizzled row), four per 64-column sub-tile of q and k (at DQK 80
        // one on the second: its zero-filled columns are never read); the
        // next sub-tile is its own 16 KB tile, so its descriptor starts
        // there, not 2 steps on
        float sc[64];
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < DQK / 16; ++i) {
          const int c = i / (kSw / 16);
          const int kk = i % (kSw / 16);
          wgmma_m64n128_ss(sc, dq + c * kSubDesc + 2 * kk, dk + c * kSubDesc + 2 * kk, c + kk);
        }
        wgmma_commit();
        wgmma_wait0();

        const bool edge = k0 + kBN > Sk || (causal && k0 + kBN - 1 > g0 + off) ||
                          (window > 0 && k0 <= g0 + 63 + off - window);
        if (edge) {
#pragma unroll
          for (int e = 0; e < 64; ++e) {
            const int kp = k0 + (e / 4) * 8 + 2 * t + (e & 1);
            if (!visible(kp, rows[(e >> 1) & 1] + off, Sk, causal, window)) sc[e] = -INFINITY;
          }
        }
        // online softmax in the log2 domain, as in flash_fwd_bf16
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          mx[0] = fmaxf(mx[0], fmaxf(sc[4 * nt], sc[4 * nt + 1]) * scale_log2);
          mx[1] = fmaxf(mx[1], fmaxf(sc[4 * nt + 2], sc[4 * nt + 3]) * scale_log2);
        }
        float msafe[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          msafe[r] = mx[r] == -INFINITY ? 0.f : mx[r];
          const float alpha = exp2f(m[r] - msafe[r]);
          m[r] = mx[r];
          l[r] *= alpha;
#pragma unroll
          for (int dt = 0; dt < DV / 8; ++dt) {
            o[4 * dt + 2 * r] *= alpha;
            o[4 * dt + 2 * r + 1] *= alpha;
          }
        }
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          const float p = exp2f(fmaf(sc[e], scale_log2, -msafe[(e >> 1) & 1]));
          sc[e] = p;
          l[(e >> 1) & 1] += p;
        }
        // P as wgmma A fragments (bf16 hi + lo), all written before the fence
        uint32_t phi[kBN / 16][4], plo[kBN / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * (2 * kk + (e >> 1)) + 2 * (e & 1);
            split_bf16(sc[i], sc[i + 1], phi[kk][e], plo[kk][e]);
          }
        }
        // O += P V, eight k-steps of 16 keys (16 rows, 2048 bytes, of each V
        // sub-tile), one product over all of v's columns
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
          wgmma_pv(o, phi[kk], dv + 128 * kk);
          wgmma_pv(o, plo[kk], dv + 128 * kk);
        }
        wgmma_commit();
        wgmma_wait0();
      }
      mbar_arrive(&empty[s]);
    }

    __nv_bfloat16* ob = out + (int64_t)b * Sq * H * DV + (int64_t)h * DV;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float den = l[r];
      den += __shfl_xor_sync(0xffffffffu, den, 1);
      den += __shfl_xor_sync(0xffffffffu, den, 2);
      const float inv = 1.f / fmaxf(den, 1e-30f);
      if (rows[r] >= Sq) continue;
#pragma unroll
      for (int dt = 0; dt < DV / 8; ++dt) {
        *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)rows[r] * H * DV + dt * 8 + 2 * t) =
            __floats2bfloat162_rn(o[4 * dt + 2 * r] * inv, o[4 * dt + 2 * r + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;             // query rows per CTA
constexpr int kT = 4;               // threads per query row
constexpr int kThreads = kBQ * kT;  // 256
constexpr int kSStride = kBK + 4;   // padded score row: conflict-free for 8 rows x 4 threads

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

template <int DQK, int DV>
constexpr size_t smem_bytes_f32() {
  return (kBK * (DQK + DV) + kBQ * kSStride) * sizeof(float);
}

// grid (ceil(Sq / kBQ), H, B), block kThreads, dynamic smem smem_bytes_f32<DQK, DV>()
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              float* __restrict__ out, int Sq, int Sk, int H, int KV, int causal, int window,
              float scale) {
  constexpr int kCQ = DQK / 4 / kT;  // float4 chunks of q per thread
  constexpr int kCV = DV / 4 / kT;   // and of the accumulator
  static_assert(kCQ >= 1 && DQK % (4 * kT) == 0, "q/k width must be a multiple of 16");
  static_assert(kCV >= 1 && DV % (4 * kT) == 0, "v width must be a multiple of 16");
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [kBK][DQK]
  float* Vs = Ks + kBK * DQK;                   // [kBK][DV]
  float* Ss = Vs + kBK * DV;                    // [kBQ][kSStride]

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

  const int64_t qrow = ((int64_t)b * Sq + qi) * H * DQK + (int64_t)h * DQK;
  const int64_t orow = ((int64_t)b * Sq + qi) * H * DV + (int64_t)h * DV;
  float4 qr[kCQ];
  float4 acc[kCV];
#pragma unroll
  for (int c = 0; c < kCQ; ++c) {
    const int d0 = 4 * (t + kT * c);
    qr[c] = row_ok ? make_float4(q[qrow + d0], q[qrow + d0 + 1], q[qrow + d0 + 2], q[qrow + d0 + 3])
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int c = 0; c < kCV; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = -INFINITY;
  float l = 0.f;

  int kbeg, kend;
  band(q0, min(kBQ, Sq - q0), off, Sk, causal, window, kbeg, kend);

  const int64_t kbase = (int64_t)b * Sk * KV * DQK + (int64_t)kvh * DQK;
  const int64_t vbase = (int64_t)b * Sk * KV * DV + (int64_t)kvh * DV;
  float* srow = Ss + r * kSStride;

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * DQK; e += kThreads) {
      const int j = e / DQK;
      const int kp = k0 + j;
      Ks[e] = kp < Sk ? k[kbase + kp * (int64_t)KV * DQK + (e - j * DQK)] : 0.f;
    }
    for (int e = tid; e < kBK * DV; e += kThreads) {
      const int j = e / DV;
      const int kp = k0 + j;
      Vs[e] = kp < Sk ? v[vbase + kp * (int64_t)KV * DV + (e - j * DV)] : 0.f;
    }
    __syncthreads();

    // scores of this row against the tile; thread (j % kT) stores column j
    for (int j = 0; j < kBK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(Ks + j * DQK);
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < kCQ; ++c) s = dot4(qr[c], kr[t + kT * c], s);
      s = group_sum(s);
      const bool vis = visible(k0 + j, qpos, Sk, causal, window);
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
    for (int c = 0; c < kCV; ++c) {
      acc[c].x *= alpha;
      acc[c].y *= alpha;
      acc[c].z *= alpha;
      acc[c].w *= alpha;
    }
    for (int j = 0; j < kBK; ++j) {
      const float p = srow[j];
      const float4* vr = reinterpret_cast<const float4*>(Vs + j * DV);
#pragma unroll
      for (int c = 0; c < kCV; ++c) {
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
    for (int c = 0; c < kCV; ++c) {
      const int d0 = 4 * (t + kT * c);
      out[orow + d0] = acc[c].x / den;
      out[orow + d0 + 1] = acc[c].y / den;
      out[orow + d0 + 2] = acc[c].z / den;
      out[orow + d0 + 3] = acc[c].w / den;
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int DQK, int DV>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
                int H, int KV, int causal, int window, float scale, cudaStream_t s) {
  const size_t smem = smem_bytes_tc<DQK, DV>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_bf16<DQK, DV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + kBQTC - 1) / kBQTC, H, B);
  flash_fwd_bf16<DQK, DV><<<grid, kThreadsTC, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Sq, Sk, H, KV,
      causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled of the CUDA driver API, reached through the runtime's
// cudaGetDriverEntryPoint (no -lcuda at link time)
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    }
  }
  return fn;
}

// [B, rows, heads, width] bf16 as a 4-d tensor map, boxes of 64 columns
// (one 128-byte swizzle row) by 128 rows of one head; rows past the end,
// and columns past the width (80), read as zeros
bool head_rows_map(CUtensorMap* map, const void* ptr, int B, int rows, int heads, int width) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)heads, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)width * 2, (cuuint64_t)heads * width * 2,
                                 (cuuint64_t)rows * heads * width * 2};
  const cuuint32_t box[4] = {(cuuint32_t)wg::kSw, 1, (cuuint32_t)wg::kBN, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DQK, int DV>
int launch_bf16_wgmma(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                      int Sk, int H, int KV, int causal, int window, float scale, cudaStream_t s) {
  static_assert(wg::kBM == wg::kBN, "q and K/V share the box of 128 rows");
  constexpr size_t smem = wg::Layout<DQK, DV>::kSmemBytes;
  static_assert(smem <= 232448, "over the 227 KB a block may use");
  CUtensorMap tq, tk, tv;
  if (!head_rows_map(&tq, q, B, Sq, H, DQK) || !head_rows_map(&tk, k, B, Sk, KV, DQK) ||
      !head_rows_map(&tv, v, B, Sk, KV, DV)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_bf16_wgmma<DQK, DV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + wg::kBM - 1) / wg::kBM, H, B);
  flash_fwd_bf16_wgmma<DQK, DV><<<grid, wg::kThreads, smem, s>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Sk, H, KV, causal, window,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int DQK, int DV>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
               int H, int KV, int causal, int window, float scale, cudaStream_t s) {
  const size_t smem = smem_bytes_f32<DQK, DV>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_f32<DQK, DV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_f32<DQK, DV><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), Sq, Sk, H, KV, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// whether bf16 at (DQK, DV) runs the wgmma kernel (REPRO_WGMMA_PAIRS)
template <int DQK, int DV>
constexpr bool wgmma_pair() {
#define REPRO_IS(dqk, dv) (DQK == dqk && DV == dv) ||
  return REPRO_WGMMA_PAIRS(REPRO_IS) false;
#undef REPRO_IS
}

template <int DQK, int DV>
int launch(int dtype, const void* q, const void* k, const void* v, void* out, int B, int Sq,
           int Sk, int H, int KV, int causal, int window, float scale, cudaStream_t s) {
  if (dtype == 0) return launch_f32<DQK, DV>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, scale, s);
  if constexpr (wgmma_pair<DQK, DV>()) {
    return launch_bf16_wgmma<DQK, DV>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, scale, s);
  } else {
    return launch_bf16<DQK, DV>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, scale, s);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q [B, Sq, H, Dqk], k [B, Sk, KV, Dqk],
// v [B, Sk, KV, Dv], out [B, Sq, H, Dv], all contiguous and 16-byte aligned;
// (Dqk, Dv) one of the compiled widths (REPRO_HEAD_DIMS with Dqk = Dv, or
// REPRO_HEAD_PAIRS).  window <= 0 means none.  Returns a cudaError_t.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                     void* out, int B, int Sq, int Sk, int H, int KV, int Dqk,
                                     int Dv, int causal, int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_EQUAL(d) \
  if (Dqk == d && Dv == d) \
    return launch<d, d>(dtype, q, k, v, out, B, Sq, Sk, H, KV, causal, window, scale, s);
#define REPRO_PAIR(dqk, dv) \
  if (Dqk == dqk && Dv == dv) \
    return launch<dqk, dv>(dtype, q, k, v, out, B, Sq, Sk, H, KV, causal, window, scale, s);
  REPRO_HEAD_DIMS(REPRO_EQUAL)
  REPRO_HEAD_PAIRS(REPRO_PAIR)
#undef REPRO_EQUAL
#undef REPRO_PAIR
  return static_cast<int>(cudaErrorInvalidValue);
}

// The mma.sync bf16 kernel at any compiled pair, also where
// repro_flash_attention runs the wgmma kernel: for timing the two side by
// side (no wrapper calls it).  Arguments as above, bfloat16 only.
extern "C" int repro_flash_attention_bf16_mma(const void* q, const void* k, const void* v,
                                              void* out, int B, int Sq, int Sk, int H, int KV,
                                              int Dqk, int Dv, int causal, int window, float scale,
                                              void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_EQUAL(d) \
  if (Dqk == d && Dv == d) \
    return launch_bf16<d, d>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, scale, s);
#define REPRO_PAIR(dqk, dv) \
  if (Dqk == dqk && Dv == dv) \
    return launch_bf16<dqk, dv>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, scale, s);
  REPRO_HEAD_DIMS(REPRO_EQUAL)
  REPRO_HEAD_PAIRS(REPRO_PAIR)
#undef REPRO_EQUAL
#undef REPRO_PAIR
  return static_cast<int>(cudaErrorInvalidValue);
}
