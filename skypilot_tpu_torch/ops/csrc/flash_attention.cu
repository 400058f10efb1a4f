// Full-sequence (training) attention for Hopper (sm_90a), float and bf16:
// the forward, the dQ backward and the dK/dV backward.
//
// Replaces the three TPU kernels of skypilot_tpu/ops/flash_attention.py,
// reached from the `jax.custom_vjp` `_flash` on the training path (every
// layer's attention when cfg.decode is False):
//   flash_fwd_kernel, flash_fwd_wgmma_kernel (bf16)
//                     <- `_fwd_kernel`     (:74,  pl.pallas_call at :151)
//   flash_dq_kernel   <- `_bwd_dq_kernel`  (:171, pl.pallas_call at :289)
//   flash_dkv_kernel  <- `_bwd_dkv_kernel` (:220, pl.pallas_call at :305)
//
// What they compute (the TPU kernels' contract). Scores s = q.k^T are
// accumulated in fp32 from operands in the input dtype, scaled by
// sm_scale, and masked to -1e30 (not -inf) unless k <= q (causal) and
// q - k < window. Forward: an online softmax (m, l, acc in fp32) across
// key tiles; p is rounded to the input dtype before the P.V product while
// l sums it unrounded; out = acc / max(l, 1e-30); lse = m + log(max(l,
// 1e-30)) per row. A fully masked leading tile (m = -1e30) washes out as
// soon as a visible tile follows: alpha = exp(-1e30 - m_real) is exactly
// 0 in fp32. Backward: p = exp(s - lse), dp = dO.V^T, ds = p (dp - delta)
// with delta = rowsum(dO * O) formed by the caller; dq = ds.K * sm_scale,
// dv = p^T.dO, dk = ds^T.Q * sm_scale, with p and ds rounded to the input
// dtype before each product.
//
// Translation to Hopper.
// - Layout. The TPU path folds (B, S, H, D) to (B*H, S, D) and repeats K/V
//   n_rep times before its kernels. Here every kernel reads the (B, S, H,
//   D) tensors in place through their strides (the fused qkv projection's
//   column slices need no copy) and indexes KV head h / n_rep itself, so
//   no folded or repeated copy ever exists in device memory. The dK/dV
//   kernel for KV head j walks the n_rep query heads of its group and
//   keeps the sum in registers (the reference's GQA sum after the kernel),
//   so no atomics are used and two runs give identical bits.
// - Grid. A TPU grid runs in order; CUDA blocks run in no order, so the
//   sequential axis becomes a loop inside the block. Forward and dQ: one
//   CUDA block per (b, h, q tile), looping over k tiles from the first the
//   window lets in to the last the causal mask lets in; tiles outside are
//   skipped, not masked. The q-tile axis is walked from the last (longest
//   causal walk) down, so the heavy tiles start first. dK/dV: one CUDA
//   block per (b, kv head, k tile), looping over q tiles from the first
//   that can see it. At B 8, H 16, S 1024 a 64-row tile gives 2048
//   dQ blocks and 1024 dK/dV blocks for 132 SMs. (The bf16 forward
//   groups heads into its tiles and runs persistent blocks: its own note
//   is further down.)
// - Ragged S. The TPU path needs S to tile by its blocks; here the last
//   tile is masked: absent keys get p = 0 exactly and absent query rows
//   are neither written nor summed into dK/dV, so any S works.
// - Two routes. bf16 at head_dim 64 and 128 (the training path) runs the
//   tensor-core kernels further down: the forward on wgmma fed by TMA
//   (flash_fwd_wgmma_kernel, with n_rep query heads grouped per tile),
//   dQ and dK/dV on mma.sync (4 warps, 16 rows each). fp32, and bf16 at
//   head_dim 256, run the CUDA-core kernels right below: BQ = BK = 64
//   rows (32 at head_dim 256), 256 threads in a 16 x 16 layout; a thread
//   owns rows ty + 16 i and key columns tx + 16 j of each score tile (the
//   16 lanes that share a row reduce it with shuffles) and column pairs
//   2 tx + 32 j of each D-wide accumulator. Tiles sit in shared memory in
//   the input dtype with rows padded by two elements, which makes the
//   pair loads of the score loop free of bank conflicts; global loads
//   are 16 bytes wide.
//
// What bounds them on the H100. At the training shape (causal S 1024,
// D 128, bf16, two query heads per KV head) the forward does 4 D FLOPs per
// visible (query, key) pair, ~350 FLOPs per byte of Q, K, V and O: above
// the card's ~295 FLOP/byte bf16 ridge, so the bound is operations over
// the tensor cores' 989 TFLOP/s; the backward needs five products (10 D
// per pair: s, dp and dq counted to dQ, dk and dv to dK/dV) and is further
// above it (the two kernels do 14 D, since dK/dV rebuilds s and dp). Only
// wgmma reaches that rate, which is why the forward runs on it; the
// softmax between its two products (an exponential per pair, on the
// SFU's 16 a clock per SM) is what the forward's pipeline hides behind
// them. The backward's mma.sync kernels reach the tensor cores but not
// their full rate; the CUDA-core route (67 TFLOP/s fp32 peak, four FMAs
// per pair of words loaded from shared memory) is the fp32 path.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kMaskValue = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;     // (B, H, S)
  const float* delta;   // (B, H, S)
  void* out;            // forward O or dQ: (B, S, H, D) contiguous
  float* lse_out;       // forward lse: (B, H, S)
  void* dk;             // (B, S, KV, D) contiguous
  void* dv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;   // o: dO in the backward
  int batch, seq, heads, kv_heads, n_rep, causal, window;
  float scale;
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

template <typename T>
struct Elt;

template <>
struct Elt<float> {
  __device__ static __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ static __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  __device__ static __forceinline__ float round(float x) { return x; }
};

template <>
struct Elt<__nv_bfloat16> {
  __device__ static __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static __forceinline__ void store2(__nv_bfloat16* p, float a,
                                                float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
  __device__ static __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

// Rows [r0, r0 + ROWS) of one (b, head) slab into a [ROWS][D + 2] tile,
// 16 bytes per global load, zeros past S.
template <typename T, int ROWS, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long row_stride, int r0,
                                          int seq) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  constexpr int kLd = D + 2;
  for (int idx = threadIdx.x; idx < ROWS * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < seq) {
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * row_stride + c);
    }
    uint32_t* w = reinterpret_cast<uint32_t*>(dst + r * kLd + c);
    w[0] = val.x;
    w[1] = val.y;
    w[2] = val.z;
    w[3] = val.w;
  }
}

// Per-row (lse, delta) of rows [r0, r0 + ROWS) into shared memory.
template <int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int seq) {
  for (int r = threadIdx.x; r < ROWS; r += kThreads) {
    dst[r] = r0 + r < seq ? src[r0 + r] : 0.f;
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// The reference's mask on one scaled score: absent keys (c >= S) -inf,
// causal / window misses -1e30.
__device__ __forceinline__ float masked(float s, int r, int c, const Args& a) {
  if (c >= a.seq) return neg_inf();
  if (a.causal && c > r) return kMaskValue;
  if (a.window > 0 && r - c >= a.window) return kMaskValue;
  return s;
}

// acc[MI][NJ] += A[ty + 16 i][:] . B[tx + 16 j][:] over D, both tiles in
// shared memory with rows of D + 2 elements.
template <typename T, int MI, int NJ, int D>
__device__ __forceinline__ void tile_dots(float (&acc)[MI][NJ], const T* A,
                                          const T* B, int ty, int tx) {
  constexpr int kLd = D + 2;
#pragma unroll 4
  for (int d = 0; d < D; d += 2) {
    float2 a[MI], b[NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i) a[i] = Elt<T>::load2(A + (ty + 16 * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = Elt<T>::load2(B + (tx + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
      }
    }
  }
}

template <typename T, int D, int BQ, int BK>
constexpr size_t fwd_smem() {
  return (BQ + 2 * BK) * (D + 2) * sizeof(T) + BQ * (BK + 1) * sizeof(float);
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Args a) {
  constexpr int kLd = D + 2, kPs = BK + 1;
  constexpr int MI = BQ / 16, NJ = BK / 16, DJ = D / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + BQ * kLd;
  T* vs = ks + BK * kLd;
  float* ps = reinterpret_cast<float*>(vs + BK * kLd);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int kvh = h / a.n_rep;
  const int qt = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  load_tile<T, BQ, D>(qs, q, a.q_ss, q0, a.seq);
  const int k_hi = a.causal ? min(a.seq, q0 + BQ) : a.seq;
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;

  float m[MI], l[MI], acc[MI][DJ][2];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    m[i] = neg_inf();
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j][0] = acc[i][j][1] = 0.f;
  }

  for (int kt = k_lo / BK; kt * BK < k_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                        // last tile's ps / vs reads done
    load_tile<T, BK, D>(ks, k, a.k_ss, k0, a.seq);
    load_tile<T, BK, D>(vs, v, a.v_ss, k0, a.seq);
    __syncthreads();
    float s[MI][NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
    tile_dots<T, MI, NJ, D>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = neg_inf();
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[i][j] = masked(s[i][j] * a.scale, r, k0 + tx + 16 * j, a);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty + 16 * i) * kPs + tx + 16 * j] = Elt<T>::round(p);
      }
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        acc[i][j][0] *= alpha;
        acc[i][j][1] *= alpha;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float2 vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Elt<T>::load2(vs + c * kLd + 2 * tx + 32 * j);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const float p = ps[(ty + 16 * i) * kPs + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          acc[i][j][0] = fmaf(p, vv[j].x, acc[i][j][0]);
          acc[i][j][1] = fmaf(p, vv[j].y, acc[i][j][1]);
        }
      }
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.seq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* row = out + ((static_cast<long long>(b) * a.seq + r) * a.heads + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      Elt<T>::store2(row + 2 * tx + 32 * j, acc[i][j][0] / l_safe,
                     acc[i][j][1] / l_safe);
    }
    if (tx == 0) {
      a.lse_out[(static_cast<long long>(b) * a.heads + h) * a.seq + r] =
          m[i] + logf(l_safe);
    }
  }
}

// p and ds of one score tile for rows ty + 16 i, columns tx + 16 j; rows
// or columns past S give exactly 0.
template <int MI, int NJ>
__device__ __forceinline__ void probs_and_dscores(
    float (&s)[MI][NJ], float (&dp)[MI][NJ], const float* lse_s,
    const float* delta_s, int q0, int k0, int ty, int tx, const Args& a) {
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int rl = ty + 16 * i;
    const int r = q0 + rl;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = k0 + tx + 16 * j;
      float p = 0.f;
      if (r < a.seq && c < a.seq) {
        p = expf(masked(s[i][j] * a.scale, r, c, a) - lse_s[rl]);
      }
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - delta_s[rl]);
    }
  }
}

template <typename T, int D, int BQ, int BK>
constexpr size_t dq_smem() {
  return (2 * BQ + 2 * BK) * (D + 2) * sizeof(T) +
         (BQ * (BK + 1) + 2 * BQ) * sizeof(float);
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const Args a) {
  constexpr int kLd = D + 2, kPs = BK + 1;
  constexpr int MI = BQ / 16, NJ = BK / 16, DJ = D / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + BQ * kLd;
  T* ks = dos + BQ * kLd;
  T* vs = ks + BK * kLd;
  float* dss = reinterpret_cast<float*>(vs + BK * kLd);
  float* lse_s = dss + BQ * kPs;
  float* delta_s = lse_s + BQ;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int kvh = h / a.n_rep;
  const int qt = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const long long row_base = (static_cast<long long>(b) * a.heads + h) * a.seq;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* dout = static_cast<const T*>(a.dout) + b * a.o_sb + h * a.o_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  load_tile<T, BQ, D>(qs, q, a.q_ss, q0, a.seq);
  load_tile<T, BQ, D>(dos, dout, a.o_ss, q0, a.seq);
  load_rows<BQ>(lse_s, a.lse + row_base, q0, a.seq);
  load_rows<BQ>(delta_s, a.delta + row_base, q0, a.seq);
  const int k_hi = a.causal ? min(a.seq, q0 + BQ) : a.seq;
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;

  float dq[MI][DJ][2];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[i][j][0] = dq[i][j][1] = 0.f;

  for (int kt = k_lo / BK; kt * BK < k_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, BK, D>(ks, k, a.k_ss, k0, a.seq);
    load_tile<T, BK, D>(vs, v, a.v_ss, k0, a.seq);
    __syncthreads();
    float s[MI][NJ], dp[MI][NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_dots<T, MI, NJ, D>(s, qs, ks, ty, tx);
    tile_dots<T, MI, NJ, D>(dp, dos, vs, ty, tx);
    probs_and_dscores<MI, NJ>(s, dp, lse_s, delta_s, q0, k0, ty, tx, a);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        dss[(ty + 16 * i) * kPs + tx + 16 * j] = Elt<T>::round(dp[i][j]);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float2 kk[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kk[j] = Elt<T>::load2(ks + c * kLd + 2 * tx + 32 * j);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const float ds = dss[(ty + 16 * i) * kPs + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dq[i][j][0] = fmaf(ds, kk[j].x, dq[i][j][0]);
          dq[i][j][1] = fmaf(ds, kk[j].y, dq[i][j][1]);
        }
      }
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.seq) continue;
    T* row = out + ((static_cast<long long>(b) * a.seq + r) * a.heads + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      Elt<T>::store2(row + 2 * tx + 32 * j, dq[i][j][0] * a.scale,
                     dq[i][j][1] * a.scale);
    }
  }
}

template <typename T, int D, int BQ, int BK>
constexpr size_t dkv_smem() {
  return (2 * BQ + 2 * BK) * (D + 2) * sizeof(T) +
         (2 * BQ * (BK + 1) + 2 * BQ) * sizeof(float);
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const Args a) {
  constexpr int kLd = D + 2, kPs = BK + 1;
  constexpr int MI = BQ / 16, NJ = BK / 16, MK = BK / 16, DJ = D / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + BK * kLd;
  T* qs = vs + BK * kLd;
  T* dos = qs + BQ * kLd;
  float* ps = reinterpret_cast<float*>(dos + BQ * kLd);
  float* dss = ps + BQ * kPs;
  float* lse_s = dss + BQ * kPs;
  float* delta_s = lse_s + BQ;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b = blockIdx.x / a.kv_heads, kvh = blockIdx.x % a.kv_heads;
  const int k0 = blockIdx.y * BK;             // causal: heaviest tiles first
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  load_tile<T, BK, D>(ks, k, a.k_ss, k0, a.seq);
  load_tile<T, BK, D>(vs, v, a.v_ss, k0, a.seq);

  // Queries that can see a key of this tile: r >= k0 (causal) and
  // r < k0 + BK - 1 + window (window).
  const int r_lo = a.causal ? k0 : 0;
  const int r_hi = a.window > 0 ? min(a.seq, k0 + BK - 1 + a.window) : a.seq;

  float dk[MK][DJ][2], dv[MK][DJ][2];
#pragma unroll
  for (int i = 0; i < MK; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dk[i][j][0] = dk[i][j][1] = dv[i][j][0] = dv[i][j][1] = 0.f;

  for (int rep = 0; rep < a.n_rep; ++rep) {
    const int h = kvh * a.n_rep + rep;
    const long long row_base = (static_cast<long long>(b) * a.heads + h) * a.seq;
    const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* dout = static_cast<const T*>(a.dout) + b * a.o_sb + h * a.o_sh;
    for (int qt = r_lo / BQ; qt * BQ < r_hi; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();                      // last tile's reads done
      load_tile<T, BQ, D>(qs, q, a.q_ss, q0, a.seq);
      load_tile<T, BQ, D>(dos, dout, a.o_ss, q0, a.seq);
      load_rows<BQ>(lse_s, a.lse + row_base, q0, a.seq);
      load_rows<BQ>(delta_s, a.delta + row_base, q0, a.seq);
      __syncthreads();
      float s[MI][NJ], dp[MI][NJ];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.f;
      tile_dots<T, MI, NJ, D>(s, qs, ks, ty, tx);
      tile_dots<T, MI, NJ, D>(dp, dos, vs, ty, tx);
      probs_and_dscores<MI, NJ>(s, dp, lse_s, delta_s, q0, k0, ty, tx, a);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          ps[(ty + 16 * i) * kPs + tx + 16 * j] = Elt<T>::round(s[i][j]);
          dss[(ty + 16 * i) * kPs + tx + 16 * j] = Elt<T>::round(dp[i][j]);
        }
      }
      __syncthreads();
      // dv[c] += sum_r p[r][c] dO[r];  dk[c] += sum_r ds[r][c] Q[r]
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float2 dov[DJ], qv[DJ];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dov[j] = Elt<T>::load2(dos + r * kLd + 2 * tx + 32 * j);
          qv[j] = Elt<T>::load2(qs + r * kLd + 2 * tx + 32 * j);
        }
#pragma unroll
        for (int i = 0; i < MK; ++i) {
          const float p = ps[r * kPs + ty + 16 * i];
          const float ds = dss[r * kPs + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            dv[i][j][0] = fmaf(p, dov[j].x, dv[i][j][0]);
            dv[i][j][1] = fmaf(p, dov[j].y, dv[i][j][1]);
            dk[i][j][0] = fmaf(ds, qv[j].x, dk[i][j][0]);
            dk[i][j][1] = fmaf(ds, qv[j].y, dk[i][j][1]);
          }
        }
      }
    }
  }

  T* dk_out = static_cast<T*>(a.dk);
  T* dv_out = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < MK; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= a.seq) continue;
    const long long off =
        ((static_cast<long long>(b) * a.seq + c) * a.kv_heads + kvh) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      Elt<T>::store2(dk_out + off + 2 * tx + 32 * j, dk[i][j][0] * a.scale,
                     dk[i][j][1] * a.scale);
      Elt<T>::store2(dv_out + off + 2 * tx + 32 * j, dv[i][j][0],
                     dv[i][j][1]);
    }
  }
}

// ------------------------------------------------ bf16 tensor-core kernels
//
// For bf16 at head_dim 64 and 128 (the training path) the products run on
// the tensor cores through mma.sync m16n8k16 (bf16 operands, fp32
// accumulation): the same contract, masks and rounding points as the
// kernels above, with 4 warps per CUDA block and each warp owning 16 rows
// of the tile. Tiles sit row-major in shared memory (rows padded by 8
// elements, so the 8 rows an ldmatrix phase reads fall in distinct
// banks); fragments come in through ldmatrix, and an operand whose
// fragment runs along the key or query axis (V for P.V, K for dS.K, Q and
// dO for the dK/dV products) through ldmatrix.trans. The score
// accumulators turn into the next product's A fragments in registers,
// without a trip through shared memory.

constexpr int kMmaThreads = 128;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

using sm90::pack_bf16;
using sm90::quad_max;
using sm90::quad_sum;

// Rows [r0, r0 + ROWS) of a (b, head) slab into [ROWS][D + 8], zeros past S.
template <int ROWS, int D>
__device__ __forceinline__ void load_rows_mma(bf16* dst, const bf16* src,
                                              long long row_stride, int r0,
                                              int seq) {
  constexpr int kPerRow = D / 8, kLd = D + 8;
  for (int idx = threadIdx.x; idx < ROWS * kPerRow; idx += kMmaThreads) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < seq) {
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
  }
}

__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int r0, int rows, int seq) {
  for (int r = threadIdx.x; r < rows; r += kMmaThreads) {
    dst[r] = r0 + r < seq ? src[r0 + r] : 0.f;
  }
}

// Fragments through ldmatrix: lane l gives the address of row l % 8 of
// 8 x 8 matrix l / 8. Tiles are row-major with leading dimension ld.
// A fragment of rows [row, row + 16), columns [col, col + 16).
__device__ __forceinline__ void load_a(uint32_t (&f)[4], const bf16* tile,
                                       int ld, int row, int col, int lane) {
  const int m = lane / 8, r = lane % 8;
  ldsm_x4(f, tile + (row + r + (m % 2) * 8) * ld + col + (m / 2) * 8);
}

// B fragments (k 16 x n 8) of two n-tiles, n rows [n0, n0 + 16), k
// columns [k0, k0 + 16), from a tile stored [n][k]: f[0], f[1] for the
// first n-tile, f[2], f[3] for the second.
__device__ __forceinline__ void load_b_nk(uint32_t (&f)[4], const bf16* tile,
                                          int ld, int n0, int k0, int lane) {
  const int m = lane / 8, r = lane % 8;
  ldsm_x4(f, tile + (n0 + (m / 2) * 8 + r) * ld + k0 + (m % 2) * 8);
}

// The same from a tile stored [k][n] (k rows [k0, k0 + 16), n columns
// [n0, n0 + 16)), transposed on the way by ldmatrix.trans.
__device__ __forceinline__ void load_b_kn(uint32_t (&f)[4], const bf16* tile,
                                          int ld, int k0, int n0, int lane) {
  const int m = lane / 8, r = lane % 8;
  ldsm_x4_t(f, tile + (k0 + (m % 2) * 8 + r) * ld + n0 + (m / 2) * 8);
}

template <int D>
constexpr size_t dq_mma_smem() {
  return 4 * 64 * (D + 8) * sizeof(bf16) + 2 * 64 * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dq_mma_kernel(const Args a) {
  constexpr int BQ = 64, BK = 64, kLd = D + 8;
  constexpr int KS = D / 16, NT = BK / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + BQ * kLd;
  bf16* ks = dos + BQ * kLd;
  bf16* vs = ks + BK * kLd;
  float* lse_s = reinterpret_cast<float*>(vs + BK * kLd);
  float* delta_s = lse_s + BQ;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int kvh = h / a.n_rep;
  const int qt = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const long long row_base = (static_cast<long long>(b) * a.heads + h) * a.seq;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* dout = static_cast<const bf16*>(a.dout) + b * a.o_sb + h * a.o_sh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  load_rows_mma<BQ, D>(qs, q, a.q_ss, q0, a.seq);
  load_rows_mma<BQ, D>(dos, dout, a.o_ss, q0, a.seq);
  load_rows_f32(lse_s, a.lse + row_base, q0, BQ, a.seq);
  load_rows_f32(delta_s, a.delta + row_base, q0, BQ, a.seq);
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;      // rows in the tile
  const int r0 = q0 + lr0, r1 = q0 + lr1;
  const int k_hi = a.causal ? min(a.seq, q0 + BQ) : a.seq;
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;

  float dq[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int kt = k_lo / BK; kt * BK < k_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_rows_mma<BK, D>(ks, k, a.k_ss, k0, a.seq);
    load_rows_mma<BK, D>(vs, v, a.v_ss, k0, a.seq);
    __syncthreads();
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], da[4];
      load_a(qa, qs, kLd, warp * 16, kk * 16, lane);
      load_a(da, dos, kLd, warp * 16, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t kb[4], vb[4];
        load_b_nk(kb, ks, kLd, j * 8, kk * 16, lane);
        load_b_nk(vb, vs, kLd, j * 8, kk * 16, lane);
        mma_bf16(s[j], qa, kb[0], kb[1]);
        mma_bf16(s[j + 1], qa, kb[2], kb[3]);
        mma_bf16(dp[j], da, vb[0], vb[1]);
        mma_bf16(dp[j + 1], da, vb[2], vb[3]);
      }
    }
    uint32_t dsf[BK / 16][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = k0 + j * 8 + 2 * t;
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? r0 : r1, lr = e < 2 ? lr0 : lr1;
        const int cc = c + (e & 1);
        float p = 0.f;
        if (r < a.seq && cc < a.seq) {
          p = expf(masked(s[j][e] * a.scale, r, cc, a) - lse_s[lr]);
        }
        ds[e] = p * (dp[j][e] - delta_s[lr]);
      }
      dsf[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
      dsf[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t kb[4];
        load_b_kn(kb, ks, kLd, kk * 16, j * 8, lane);
        mma_bf16(dq[j], dsf[kk], kb[0], kb[1]);
        mma_bf16(dq[j + 1], dsf[kk], kb[2], kb[3]);
      }
    }
  }

  bf16* out = static_cast<bf16*>(a.out);
  const long long head_row = static_cast<long long>(a.heads) * D;
  bf16* row0 = out + (static_cast<long long>(b) * a.seq + r0) * head_row + h * D;
  bf16* row1 = row0 + 8 * head_row;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    if (r0 < a.seq) {
      *reinterpret_cast<uint32_t*>(row0 + j * 8 + 2 * t) =
          pack_bf16(dq[j][0] * a.scale, dq[j][1] * a.scale);
    }
    if (r1 < a.seq) {
      *reinterpret_cast<uint32_t*>(row1 + j * 8 + 2 * t) =
          pack_bf16(dq[j][2] * a.scale, dq[j][3] * a.scale);
    }
  }
}

template <int D>
constexpr size_t dkv_mma_smem() {
  return (2 * 64 + 2 * 32) * (D + 8) * sizeof(bf16) + 2 * 32 * sizeof(float);
}

// dK/dV with keys as the rows: the block computes S^T = K Q^T and
// dP^T = V dO^T, so p^T and ds^T come out as A fragments for
// dV += P^T dO and dK += dS^T Q. Query tiles of 32 rows keep the
// accumulators in registers.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dkv_mma_kernel(const Args a) {
  constexpr int BK = 64, BQ = 32, kLd = D + 8;
  constexpr int KS = D / 16, NT = BQ / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + BK * kLd;
  bf16* qs = vs + BK * kLd;
  bf16* dos = qs + BQ * kLd;
  float* lse_s = reinterpret_cast<float*>(dos + BQ * kLd);
  float* delta_s = lse_s + BQ;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / a.kv_heads, kvh = blockIdx.x % a.kv_heads;
  const int k0 = blockIdx.y * BK;             // causal: heaviest tiles first
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  load_rows_mma<BK, D>(ks, k, a.k_ss, k0, a.seq);
  load_rows_mma<BK, D>(vs, v, a.v_ss, k0, a.seq);
  const int c0 = k0 + warp * 16 + g, c1 = c0 + 8;   // this thread's keys
  const int r_lo = a.causal ? k0 : 0;
  const int r_hi = a.window > 0 ? min(a.seq, k0 + BK - 1 + a.window) : a.seq;

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int rep = 0; rep < a.n_rep; ++rep) {
    const int h = kvh * a.n_rep + rep;
    const long long row_base = (static_cast<long long>(b) * a.heads + h) * a.seq;
    const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
    const bf16* dout = static_cast<const bf16*>(a.dout) + b * a.o_sb + h * a.o_sh;
    for (int qt = r_lo / BQ; qt * BQ < r_hi; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      load_rows_mma<BQ, D>(qs, q, a.q_ss, q0, a.seq);
      load_rows_mma<BQ, D>(dos, dout, a.o_ss, q0, a.seq);
      load_rows_f32(lse_s, a.lse + row_base, q0, BQ, a.seq);
      load_rows_f32(delta_s, a.delta + row_base, q0, BQ, a.seq);
      __syncthreads();
      float st[NT][4], dpt[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        load_a(ka, ks, kLd, warp * 16, kk * 16, lane);
        load_a(va, vs, kLd, warp * 16, kk * 16, lane);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t qb[4], db[4];
          load_b_nk(qb, qs, kLd, j * 8, kk * 16, lane);
          load_b_nk(db, dos, kLd, j * 8, kk * 16, lane);
          mma_bf16(st[j], ka, qb[0], qb[1]);
          mma_bf16(st[j + 1], ka, qb[2], qb[3]);
          mma_bf16(dpt[j], va, db[0], db[1]);
          mma_bf16(dpt[j + 1], va, db[2], db[3]);
        }
      }
      uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int lq = j * 8 + 2 * t;             // query column in the tile
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = e < 2 ? c0 : c1;
          const int lr = lq + (e & 1), r = q0 + lr;
          float pe = 0.f;
          if (r < a.seq && key < a.seq) {
            pe = expf(masked(st[j][e] * a.scale, r, key, a) - lse_s[lr]);
          }
          p[e] = pe;
          ds[e] = pe * (dpt[j][e] - delta_s[lr]);
        }
        pf[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
        pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
        dsf[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
        dsf[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < DT; j += 2) {
          uint32_t db[4], qb[4];
          load_b_kn(db, dos, kLd, kk * 16, j * 8, lane);
          load_b_kn(qb, qs, kLd, kk * 16, j * 8, lane);
          mma_bf16(dv[j], pf[kk], db[0], db[1]);
          mma_bf16(dv[j + 1], pf[kk], db[2], db[3]);
          mma_bf16(dk[j], dsf[kk], qb[0], qb[1]);
          mma_bf16(dk[j + 1], dsf[kk], qb[2], qb[3]);
        }
      }
    }
  }

  const long long key_row = static_cast<long long>(a.kv_heads) * D;
  const long long off0 = (static_cast<long long>(b) * a.seq + c0) * key_row +
                         kvh * D;
  const long long off1 = off0 + 8 * key_row;
  bf16* dk_out = static_cast<bf16*>(a.dk);
  bf16* dv_out = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int d = j * 8 + 2 * t;
    if (c0 < a.seq) {
      *reinterpret_cast<uint32_t*>(dk_out + off0 + d) =
          pack_bf16(dk[j][0] * a.scale, dk[j][1] * a.scale);
      *reinterpret_cast<uint32_t*>(dv_out + off0 + d) =
          pack_bf16(dv[j][0], dv[j][1]);
    }
    if (c1 < a.seq) {
      *reinterpret_cast<uint32_t*>(dk_out + off1 + d) =
          pack_bf16(dk[j][2] * a.scale, dk[j][3] * a.scale);
      *reinterpret_cast<uint32_t*>(dv_out + off1 + d) =
          pack_bf16(dv[j][2], dv[j][3]);
    }
  }
}

// ------------------------------------- bf16 forward: wgmma, TMA, mbarrier
//
// The training path's forward (bf16, head_dim 64 and 128), redesigned for
// Hopper: the same contract, masks and rounding points as the kernels
// above, with
// - grouped query heads: a work tile is (b, KV head, q tile), and takes
//   the n_rep query heads of the group as extra rows, so each K/V tile is
//   fetched once for all of them. Its 128 rows are P = 128 / n_rep
//   positions x n_rep heads, row = position * n_rep + head (64 positions
//   at n_rep 2); causal and window bounds are taken per row;
// - products on wgmma: two consumer warpgroups of 64 rows; S = Q.K^T as
//   m64n64k16 with Q and K both from shared memory (K-major), then P.V as
//   m64nDk16 with P from registers (the S accumulator rounded to bf16
//   pairs in place) and V from shared memory through the transpose bit.
//   The scores of key tile i + 1 are issued with tile i's P.V, and their
//   softmax runs while P.V is on the tensor cores;
// - copies on TMA: one producer warp loads each work tile's Q and keeps a
//   ring of kStages K/V tiles in flight, with full (K, V) and empty
//   mbarriers per stage and a full/empty pair for Q. The tensor maps
//   (encoded by the launcher) span the strided (B, S, heads, D) views
//   with S as its own dimension, so a ragged last tile reads zeros, never
//   the next batch's rows; absent keys are still masked to p = 0 by
//   column < S. Tiles land in 128-byte-swizzled shared memory, the layout
//   the wgmma descriptors name (sm90.cuh). O leaves through its own
//   staging tile and one TMA store;
// - work order: the q tiles of one (b, KV head) group run one after
//   another (the longest causal walks first), so the CUDA blocks in
//   flight read few groups' K/V and find them in L2.

namespace fwd90 {

constexpr int kRows = 128;          // grouped query rows per work tile
constexpr int kKeys = 64, kStages = 4;    // keys per K/V tile, tiles in flight
constexpr int kConsumerWarps = 8;   // two warpgroups of 64 rows
constexpr int kThreads = 32 * kConsumerWarps + 32;   // + the producer warp
constexpr float kLog2e = 1.4426950408889634f;
// One CUDA block per SM walking the work tiles, or one per work tile.
constexpr bool kPersistent = true;

struct Params {
  float* lse;         // (B, H, S)
  int batch, seq, heads, kv_heads, n_rep, positions, q_tiles, causal, window;
  float scale;
};

template <int D>
struct Smem {
  static constexpr int kChunks = D / 64;
  alignas(1024) bf16 q[kChunks][kRows * 64];
  alignas(1024) bf16 o[kChunks][kRows * 64];
  alignas(1024) bf16 k[kStages][kChunks][kKeys * 64];
  alignas(1024) bf16 v[kStages][kChunks][kKeys * 64];
  uint64_t q_full, q_empty, k_full[kStages], v_full[kStages], empty[kStages];
};

__device__ __forceinline__ float mask(float s, int pos, int c,
                                      const Params& p) {
  if (c >= p.seq) return neg_inf();
  if (p.causal && c > pos) return kMaskValue;
  if (p.window > 0 && pos - c >= p.window) return kMaskValue;
  return s;
}

// Work tile w: heaviest q tiles first (the longest causal walks), then
// (b, KV head).
struct Work {
  int b, kvh, q0, q_last, t_lo, t_hi;
  __device__ Work(int w, const Params& p) {
    const int groups = p.batch * p.kv_heads;
    const int qt = p.causal ? p.q_tiles - 1 - w / groups : w / groups;
    b = (w % groups) / p.kv_heads;
    kvh = w % p.kv_heads;
    q0 = qt * p.positions;
    q_last = min(p.seq, q0 + p.positions) - 1;
    const int k_hi = p.causal ? q_last + 1 : p.seq;
    const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
    t_lo = k_lo / kKeys;
    t_hi = (k_hi + kKeys - 1) / kKeys;
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to,
                       const Params p) {
  constexpr int kChunks = D / 64;
  extern __shared__ unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_work = p.batch * p.kv_heads * p.q_tiles;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&sm.q_full, 1);
    sm90::mbar_init(&sm.q_empty, kConsumerWarps);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&sm.k_full[s], 1);
      sm90::mbar_init(&sm.v_full[s], 1);
      sm90::mbar_init(&sm.empty[s], kConsumerWarps);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {                 // the producer warp
    if (lane == 0) {
      constexpr uint32_t kTileBytes = kChunks * kKeys * 128;
      int it = 0;                               // K/V tiles issued
      for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
        const Work wk(w, p);
        if (n > 0) sm90::mbar_wait(&sm.q_empty, (n - 1) & 1);
        sm90::mbar_expect_tx(&sm.q_full,
                             kChunks * p.positions * p.n_rep * 128);
        for (int c = 0; c < kChunks; ++c) {
          sm90::tma_load_4d(sm.q[c], &tq, &sm.q_full, 64 * c,
                            wk.kvh * p.n_rep, wk.q0, wk.b);
        }
        for (int t = wk.t_lo; t < wk.t_hi; ++t, ++it) {
          const int s = it % kStages;
          if (it >= kStages) {
            sm90::mbar_wait(&sm.empty[s], (it / kStages - 1) & 1);
          }
          sm90::mbar_expect_tx(&sm.k_full[s], kTileBytes);
          for (int c = 0; c < kChunks; ++c) {
            sm90::tma_load_4d(sm.k[s][c], &tk, &sm.k_full[s], 64 * c,
                              wk.kvh, t * kKeys, wk.b);
          }
          sm90::mbar_expect_tx(&sm.v_full[s], kTileBytes);
          for (int c = 0; c < kChunks; ++c) {
            sm90::tma_load_4d(sm.v[s][c], &tv, &sm.v_full[s], 64 * c,
                              wk.kvh, t * kKeys, wk.b);
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile;
  // this thread owns rows lr0 and lr0 + 8 of them.
  const int wg = warp / 4, g = lane / 4, t4 = lane % 4;
  const int lr0 = wg * 64 + (warp % 4) * 16 + g, lr1 = lr0 + 8;
  const unsigned char* q_rows =
      reinterpret_cast<const unsigned char*>(sm.q[0]) + wg * 64 * 128;
  float o[D / 2], sacc[kKeys / 2];
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) sacc[i] = 0.f;
  uint32_t pf[kKeys / 16][4];
  int it = 0;                                   // K/V tiles consumed

  for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
    const Work wk(w, p);
    const int pos0 = wk.q0 + lr0 / p.n_rep, pos1 = wk.q0 + lr1 / p.n_rep;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = neg_inf(), m1 = neg_inf(), l0 = 0.f, l1 = 0.f;

    // S = Q.K^T of the tile in stage s, into sacc (not waited for).
    auto issue_scores = [&](int s) {
      const unsigned char* k_rows =
          reinterpret_cast<const unsigned char*>(sm.k[s][0]);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int qoff = (kk / 4) * (int)sizeof(sm.q[0]) + (kk % 4) * 32;
        const int koff = (kk / 4) * (int)sizeof(sm.k[0][0]) + (kk % 4) * 32;
        const uint64_t da = sm90::desc_sw128(q_rows + qoff, 16, 1024);
        const uint64_t db = sm90::desc_sw128(k_rows + koff, 16, 1024);
        sm90::wgmma_m64n64_ss(sacc, da, db, kk > 0);
      }
      sm90::wgmma_commit();
    };
    // P.V of the tile in stage s, from pf, into o (not waited for).
    auto issue_pv = [&](int s) {
      const unsigned char* v_rows =
          reinterpret_cast<const unsigned char*>(sm.v[s][0]);
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        const uint64_t dv = sm90::desc_sw128(v_rows + kk * 2048,
                                             sizeof(sm.v[0][0]), 1024);
        if constexpr (D == 64) {
          sm90::wgmma_m64n64_rs(o, pf[kk], dv);
        } else {
          sm90::wgmma_m64n128_rs(o, pf[kk], dv);
        }
      }
      sm90::wgmma_commit();
    };
    // The online softmax of key tile t on sacc: scale, mask, new maxima,
    // p = exp(s - m) left in sacc (fp32), l updated; returns the alphas.
    // A tile that no mask touches takes the short form (for a positive
    // scale): the maxima of the raw scores times the scale (the same
    // numbers: rounding is monotonic) and exp2(s * scale * log2 e -
    // m * log2 e) as one FFMA.
    auto softmax = [&](int t, float& alpha0, float& alpha1) {
      const int k0 = t * kKeys;
      const bool edge = k0 + kKeys > p.seq ||
                        (p.causal && k0 + kKeys - 1 > wk.q0) ||
                        (p.window > 0 && wk.q_last - k0 >= p.window);
      float mx0 = neg_inf(), mx1 = neg_inf(), n0, n1;
      if (edge || !(p.scale > 0.f)) {
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sacc[4 * j + e] = mask(sacc[4 * j + e] * p.scale, e < 2 ? pos0 : pos1,
                                   k0 + 8 * j + 2 * t4 + (e & 1), p);
          }
          mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
        }
        n0 = fmaxf(m0, quad_max(mx0));
        n1 = fmaxf(m1, quad_max(mx1));
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) {
          sacc[4 * j] = sm90::exp2_approx((sacc[4 * j] - n0) * kLog2e);
          sacc[4 * j + 1] = sm90::exp2_approx((sacc[4 * j + 1] - n0) * kLog2e);
          sacc[4 * j + 2] = sm90::exp2_approx((sacc[4 * j + 2] - n1) * kLog2e);
          sacc[4 * j + 3] = sm90::exp2_approx((sacc[4 * j + 3] - n1) * kLog2e);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
        }
        n0 = fmaxf(m0, quad_max(mx0) * p.scale);
        n1 = fmaxf(m1, quad_max(mx1) * p.scale);
        const float c = p.scale * kLog2e, b0 = n0 * kLog2e, b1 = n1 * kLog2e;
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) {
          sacc[4 * j] = sm90::exp2_approx(fmaf(sacc[4 * j], c, -b0));
          sacc[4 * j + 1] = sm90::exp2_approx(fmaf(sacc[4 * j + 1], c, -b0));
          sacc[4 * j + 2] = sm90::exp2_approx(fmaf(sacc[4 * j + 2], c, -b1));
          sacc[4 * j + 3] = sm90::exp2_approx(fmaf(sacc[4 * j + 3], c, -b1));
        }
      }
      alpha0 = sm90::exp2_approx((m0 - n0) * kLog2e);
      alpha1 = sm90::exp2_approx((m1 - n1) * kLog2e);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        sum0 += sacc[4 * j] + sacc[4 * j + 1];
        sum1 += sacc[4 * j + 2] + sacc[4 * j + 3];
      }
      l0 = l0 * alpha0 + quad_sum(sum0);
      l1 = l1 * alpha1 + quad_sum(sum1);
      m0 = n0;
      m1 = n1;
    };
    // o *= alpha, and p rounded to bf16 pairs: P.V's register-A fragments.
    auto rescale_and_pack = [&](float alpha0, float alpha1) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= alpha0;
        o[4 * j + 1] *= alpha0;
        o[4 * j + 2] *= alpha1;
        o[4 * j + 3] *= alpha1;
      }
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        pf[j / 2][(j % 2) * 2] = sm90::pack_bf16(sacc[4 * j], sacc[4 * j + 1]);
        pf[j / 2][(j % 2) * 2 + 1] =
            sm90::pack_bf16(sacc[4 * j + 2], sacc[4 * j + 3]);
      }
    };
    // Q's last reader is the work tile's last score product.
    auto release_q = [&]() {
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&sm.q_empty);
    };
    auto release_stage = [&](int s) {
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&sm.empty[s]);
    };

    // Software pipeline over the key tiles; the last tile's P.V is
    // peeled off, so every wgmma wait retires a known group.
    const int n_tiles = wk.t_hi - wk.t_lo;
    float alpha0, alpha1;
    sm90::mbar_wait(&sm.q_full, n & 1);
    sm90::mbar_wait(&sm.k_full[it % kStages], (it / kStages) & 1);
    sm90::wgmma_fence();
    issue_scores(it % kStages);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sacc);
    if (n_tiles == 1) release_q();
    softmax(wk.t_lo, alpha0, alpha1);
    rescale_and_pack(alpha0, alpha1);
    for (int i = 0; i + 1 < n_tiles; ++i, ++it) {
      const int s = it % kStages, s1 = (it + 1) % kStages;
      sm90::mbar_wait(&sm.k_full[s1], ((it + 1) / kStages) & 1);
      sm90::mbar_wait(&sm.v_full[s], (it / kStages) & 1);
      sm90::wgmma_fence();
      issue_scores(s1);
      issue_pv(s);
      sm90::wgmma_wait<1>();                    // scores of tile i + 1
      sm90::fence_regs(sacc);
      if (i + 2 == n_tiles) release_q();
      softmax(wk.t_lo + i + 1, alpha0, alpha1);
      sm90::wgmma_wait<0>();                    // P.V of tile i
      sm90::fence_regs(o);
      release_stage(s);
      rescale_and_pack(alpha0, alpha1);
    }
    {
      const int s = it % kStages;
      sm90::mbar_wait(&sm.v_full[s], (it / kStages) & 1);
      sm90::wgmma_fence();
      issue_pv(s);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      release_stage(s);
      ++it;
    }

    // Epilogue: O / l in bf16 into the staging tile (once the last
    // tile's store has read it), then one TMA store of the whole tile
    // through the output's map; positions past S are clipped by it.
    const float ls0 = fmaxf(l0, 1e-30f), ls1 = fmaxf(l1, 1e-30f);
    sm90::named_barrier_sync(1, 32 * kConsumerWarps);
    unsigned char* o_tile = reinterpret_cast<unsigned char*>(sm.o[0]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      unsigned char* chunk = o_tile + (j / 8) * sizeof(sm.o[0]) + 4 * t4;
      *reinterpret_cast<uint32_t*>(chunk + sm90::swizzled(lr0, j % 8)) =
          sm90::pack_bf16(o[4 * j] / ls0, o[4 * j + 1] / ls0);
      *reinterpret_cast<uint32_t*>(chunk + sm90::swizzled(lr1, j % 8)) =
          sm90::pack_bf16(o[4 * j + 2] / ls1, o[4 * j + 3] / ls1);
    }
    const int live_rows = p.positions * p.n_rep;
    const int rows[2] = {lr0, lr1}, pos[2] = {pos0, pos1};
    const float lse[2] = {m0 + logf(ls0), m1 + logf(ls1)};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (t4 == 0 && rows[h] < live_rows && pos[h] < p.seq) {
        const int head = wk.kvh * p.n_rep + rows[h] % p.n_rep;
        p.lse[(static_cast<long long>(wk.b) * p.heads + head) * p.seq +
              pos[h]] = lse[h];
      }
    }
    sm90::fence_async_shared();
    sm90::named_barrier_sync(2, 32 * kConsumerWarps);
    if (threadIdx.x == 0) {
      for (int c = 0; c < kChunks; ++c) {
        sm90::tma_store_4d(&to, sm.o[c], 64 * c, wk.kvh * p.n_rep, wk.q0,
                           wk.b);
      }
      sm90::tma_store_commit_and_wait();
    }
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda.
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
    }
  }
  return fn;
}

// A bf16 (B, S, heads, D) view with element strides sb, ss, sh as a 4-D
// map {D, heads, S, B}; boxes of 64 x box_h x box_s x 1, 128-byte
// swizzle, zeros out of bounds. A dimension of extent 1 takes a
// stride that cannot fail the encoder's checks.
bool encode_bshd(CUtensorMap* map, const void* base, int d, int heads,
                 int seq, int batch, long long sh, long long ss,
                 long long sb, int box_h, int box_s) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  if (heads == 1) sh = d;
  if (batch == 1) sb = ss * seq;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                        static_cast<cuuint64_t>(heads),
                        static_cast<cuuint64_t>(seq),
                        static_cast<cuuint64_t>(batch)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                           static_cast<cuuint64_t>(ss) * 2,
                           static_cast<cuuint64_t>(sb) * 2};
  cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_h),
                       static_cast<cuuint32_t>(box_s), 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.n_rep > kRows) return cudaErrorInvalidValue;
  Params p;
  p.lse = a.lse_out;
  p.batch = a.batch;
  p.seq = a.seq;
  p.heads = a.heads;
  p.kv_heads = a.kv_heads;
  p.n_rep = a.n_rep;
  p.positions = kRows / a.n_rep;
  p.q_tiles = (a.seq + p.positions - 1) / p.positions;
  p.causal = a.causal;
  p.window = a.window;
  p.scale = a.scale;
  CUtensorMap tq, tk, tv, to;
  const long long o_ss = static_cast<long long>(a.heads) * D;
  if (!encode_bshd(&tq, a.q, D, a.heads, a.seq, a.batch, a.q_sh, a.q_ss,
                   a.q_sb, a.n_rep, p.positions) ||
      !encode_bshd(&to, a.out, D, a.heads, a.seq, a.batch, D, o_ss,
                   o_ss * a.seq, a.n_rep, p.positions) ||
      !encode_bshd(&tk, a.k, D, a.kv_heads, a.seq, a.batch, a.k_sh, a.k_ss,
                   a.k_sb, 1, kKeys) ||
      !encode_bshd(&tv, a.v, D, a.kv_heads, a.seq, a.batch, a.v_sh, a.v_ss,
                   a.v_sb, 1, kKeys)) {
    return cudaErrorInvalidValue;
  }
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(Smem<D>) + 1024;   // + alignment slack
  auto kernel = flash_fwd_wgmma_kernel<D>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_work = a.batch * a.kv_heads * p.q_tiles;
  const int grid = kPersistent && sms < n_work ? sms : n_work;
  kernel<<<grid, kThreads, smem, stream>>>(tq, tk, tv, to, p);
  return cudaGetLastError();
}

}  // namespace fwd90

enum Which { kForward, kDq, kDkv };

// bf16 at head_dim 64 and 128 takes the tensor-core kernels.
template <typename T, int D>
constexpr bool kUseMma = std::is_same<T, __nv_bfloat16>::value && D <= 128;

template <typename T, int D>
cudaError_t launch_typed(Which which, const Args& a, cudaStream_t stream) {
  constexpr int kTile = D > 128 ? 32 : 64;
  const int q_tiles = (a.seq + kTile - 1) / kTile;
  void (*kernel)(Args);
  size_t smem;
  dim3 grid;
  int threads = kThreads;
  if constexpr (kUseMma<T, D>) {
    threads = kMmaThreads;
    const int tiles64 = (a.seq + 63) / 64;
    if (which == kForward) {
      return fwd90::launch<D>(a, stream);
    } else if (which == kDq) {
      kernel = flash_dq_mma_kernel<D>;
      smem = dq_mma_smem<D>();
      grid = dim3(a.batch * a.heads, tiles64);
    } else {
      kernel = flash_dkv_mma_kernel<D>;
      smem = dkv_mma_smem<D>();
      grid = dim3(a.batch * a.kv_heads, tiles64);
    }
  } else if (which == kForward) {
    kernel = flash_fwd_kernel<T, D, kTile, kTile>;
    smem = fwd_smem<T, D, kTile, kTile>();
    grid = dim3(a.batch * a.heads, q_tiles);
  } else if (which == kDq) {
    kernel = flash_dq_kernel<T, D, kTile, kTile>;
    smem = dq_smem<T, D, kTile, kTile>();
    grid = dim3(a.batch * a.heads, q_tiles);
  } else {
    kernel = flash_dkv_kernel<T, D, kTile, kTile>;
    smem = dkv_smem<T, D, kTile, kTile>();
    grid = dim3(a.batch * a.kv_heads, q_tiles);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(Which which, int head_dim, const Args& a,
                       cudaStream_t stream) {
  switch (head_dim) {
    case 64: return launch_typed<T, 64>(which, a, stream);
    case 128: return launch_typed<T, 128>(which, a, stream);
    case 256: return launch_typed<T, 256>(which, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

int launch(Which which, Args& a, const long long* strides, int batch,
           int seq, int heads, int kv_heads, int head_dim, float scale,
           int causal, int window, int dtype, void* stream) {
  if (batch <= 0 || seq <= 0 || kv_heads <= 0 || heads % kv_heads) {
    return cudaErrorInvalidValue;
  }
  a.q_sb = strides[0]; a.q_ss = strides[1]; a.q_sh = strides[2];
  a.k_sb = strides[3]; a.k_ss = strides[4]; a.k_sh = strides[5];
  a.v_sb = strides[6]; a.v_ss = strides[7]; a.v_sh = strides[8];
  if (which != kForward) {
    a.o_sb = strides[9]; a.o_ss = strides[10]; a.o_sh = strides[11];
  }
  a.batch = batch;
  a.seq = seq;
  a.heads = heads;
  a.kv_heads = kv_heads;
  a.n_rep = heads / kv_heads;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dim<float>(which, head_dim, a, s);
  if (dtype == 1) return launch_dim<__nv_bfloat16>(which, head_dim, a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// O (B, S, H, D) and lse (B, H, S) from q (B, S, H, D), k/v (B, S, KV, D).
// strides: q, k, v (batch, seq, head), in elements. dtype 0 fp32, 1 bf16.
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* out, float* lse, const long long* strides,
                            int batch, int seq, int heads, int kv_heads,
                            int head_dim, float scale, int causal, int window,
                            int dtype, void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.out = out; a.lse_out = lse;
  return launch(kForward, a, strides, batch, seq, heads, kv_heads, head_dim,
                scale, causal, window, dtype, stream);
}

// dQ (B, S, H, D). strides: q, k, v, dO.
int flash_attention_dq(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dq, const long long* strides, int batch, int seq,
                       int heads, int kv_heads, int head_dim, float scale,
                       int causal, int window, int dtype, void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.out = dq;
  return launch(kDq, a, strides, batch, seq, heads, kv_heads, head_dim,
                scale, causal, window, dtype, stream);
}

// dK, dV (B, S, KV, D), each summed over its KV head's n_rep query heads.
int flash_attention_dkv(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta,
                        void* dk, void* dv, const long long* strides,
                        int batch, int seq, int heads, int kv_heads,
                        int head_dim, float scale, int causal, int window,
                        int dtype, void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.dk = dk; a.dv = dv;
  return launch(kDkv, a, strides, batch, seq, heads, kv_heads, head_dim,
                scale, causal, window, dtype, stream);
}

}  // extern "C"
