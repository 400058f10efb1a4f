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
//   dQ blocks and 1024 dK/dV blocks for 132 SMs. (The bf16 kernels
//   group heads or keys into larger work tiles: their own note is
//   further down.)
// - Ragged S. The TPU path needs S to tile by its blocks; here the last
//   tile is masked: absent keys get p = 0 exactly and absent query rows
//   are neither written nor summed into dK/dV, so any S works.
// - Two routes. bf16 at head_dim 64 and 128 (the training path) runs the
//   wgmma / TMA kernels further down (flash_fwd_wgmma_kernel,
//   flash_dq_wgmma_kernel, flash_dkv_wgmma_kernel; their own note is
//   there). fp32, and bf16 at head_dim 256, run the CUDA-core kernels
//   right below: BQ = BK = 64 rows (32 at head_dim 256), 256 threads in a
//   16 x 16 layout; a thread owns rows ty + 16 i and key columns tx + 16 j
//   of each score tile (the 16 lanes that share a row reduce it with
//   shuffles) and column pairs 2 tx + 32 j of each D-wide accumulator.
//   Tiles sit in shared memory in the input dtype with rows padded by two
//   elements, which makes the pair loads of the score loop free of bank
//   conflicts; global loads are 16 bytes wide.
//
// What bounds them on the H100. At the training shape (causal S 1024,
// D 128, bf16, two query heads per KV head) the forward does 4 D FLOPs per
// visible (query, key) pair, ~350 FLOPs per byte of Q, K, V and O: above
// the card's ~295 FLOP/byte bf16 ridge, so the bound is operations over
// the tensor cores' 989 TFLOP/s; the backward needs five products (10 D
// per pair: s, dp and dq counted to dQ, dk and dv to dK/dV) and is further
// above it (the two kernels issue 14 D, since dK/dV rebuilds s and dp).
// Only wgmma reaches that rate, which is why the bf16 kernels run on it;
// the exponentials between their products (one per pair, on the SFU's 16
// a clock per SM) are what their pipelines hide behind the products. The
// CUDA-core route (67 TFLOP/s fp32 peak, four FMAs per pair of words
// loaded from shared memory) is the fp32 path.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"
#include "wgmma_attention.cuh"

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

using bf16 = __nv_bfloat16;

enum Which { kForward, kDq, kDkv };

// ---------------------------- bf16 kernels: wgmma, TMA, mbarrier (Hopper)
//
// The training path (bf16, head_dim 64 and 128) runs three kernels built
// from one set of parts: the same contract, masks and rounding points as
// the CUDA-core kernels above.
// - Copies on TMA. One producer warp issues every copy; tiles land in
//   128-byte-swizzled shared memory, the layout the wgmma descriptors
//   name (sm90.cuh), through tensor maps (encoded by the launcher) over
//   the strided (B, S, heads, D) views with S as its own dimension, so
//   a ragged last tile reads zeros, never the next batch's rows. Rings of
//   stages with full/empty mbarriers keep copies in flight during the
//   products. Outputs leave through a staging tile and TMA stores.
// - Products on wgmma. Consumer warpgroups of 64 rows; a product whose
//   reduction runs along the head dim reads both operands from shared
//   memory (K-major); one whose reduction runs along keys or queries takes
//   its A from registers (an fp32 accumulator rounded to bf16 pairs in
//   place) and its B from shared memory through the transpose bit.
// - Work order. Work tiles go heaviest (longest causal walk) first; the
//   forward and dQ run one persistent CUDA block per SM over them, dK/dV
//   one block per work tile (kPersistent, kDkvPersistent).
//
// flash_fwd_wgmma_kernel (TPU `_fwd_kernel`) and flash_dq_wgmma_kernel
// (TPU `_bwd_dq_kernel`) share the work tile and the producer: a work tile
// is (b, KV head, q tile) and takes the n_rep query heads of the group as
// extra rows, so each K/V tile is fetched once for all of them. Its 128
// rows are P = 128 / n_rep positions x n_rep heads, row = position *
// n_rep + head (64 positions at n_rep 2); causal and window bounds are
// taken per row. The producer loads the tile's Q (and dO) once and streams
// 64-key K/V tiles through the ring.
// - Forward: S = Q.K^T (m64n64k16), online softmax, O += P.V (m64nDk16).
//   Bound by operations (4 D FLOPs per visible pair). The scores of key
//   tile i + 1 are issued with tile i's P.V, so the softmax runs while P.V
//   is on the tensor cores.
// - dQ: S = Q.K^T and dP = dO.V^T (m64n64k16, both from shared memory),
//   p = exp(s scale - lse) and ds = p (dp - delta) in registers, dQ +=
//   dS.K (m64nDk16, K through the transpose bit). It issues 6 D FLOPs per
//   visible pair, ~2 KB of K/V per 128 rows and key tile: bound by
//   operations. S and dP of tile i + 1 are issued with tile i's dQ
//   product, and their ds runs while it is on the tensor cores. That
//   pipeline holds dQ, S, dP and the packed dS at once: with one producer
//   warp ptxas capped the consumers at 168 registers and spilled, so the
//   producer is a warpgroup that hands its registers to them (setmaxnreg).
//
// flash_dkv_wgmma_kernel (TPU `_bwd_dkv_kernel`) takes keys as rows: a
// work tile is (b, KV head, 128-key tile), two consumer warpgroups of 64
// keys, with the tile's K and V resident in shared memory. The producer
// streams (Q, dO, lse, delta) tiles of 64 positions through a ring: the
// n_rep query heads of the group one after another, and within each the q
// tiles from the first that can see the key tile (causal) to the last the
// window lets in. Each warpgroup computes S^T = K.Q^T and dP^T = V.dO^T
// (m64n64k16 from shared memory), p^T and ds^T in registers, then dV +=
// P^T.dO and dK += dS^T.Q (m64nDk16, register A, dO and Q through the
// transpose bit), skipping a q tile none of its keys can see. dK and dV
// are summed over the n_rep heads in fp32 registers and rounded once: no
// atomics, so two runs give identical bits. It issues 8 D FLOPs per
// visible pair (it rebuilds s and dp) against the table's 4 D: at the
// train shape its bound by the table's count is bytes, by its own issue
// operations; the design keeps the tensor cores fed (K/V read once per
// work tile, Q/dO once per key tile and head). Its two D-wide fp32
// accumulators take 128 registers a thread, so the producer warpgroup
// hands its registers to the consumers (setmaxnreg). K and V's shared
// memory is the dK/dV staging tile once the tile's last product is done.
//
// Rounding and masks: p and ds are rounded to bf16 before each product;
// masked pairs (-1e30 in the plain versions, exp of it is 0) and absent
// keys get p = 0 exactly, by a select on the tiles a mask touches;
// absent query positions carry lse = +inf, so their p is exactly 0, and
// are neither written nor summed. exp runs as one FFMA and one MUFU ex2
// on log2-scaled lse (lse is finite for every present row: each row sees
// its own key).

namespace hopper {

using sm90::quad_max;
using sm90::quad_sum;
// The grouped-head mainloop parts (wgmma_attention.cuh), shared with the
// ring chunk update.
using sm90::encode_bshd;
using sm90::init_q_barriers;
using sm90::issue_rs;
using sm90::issue_ss;
using sm90::kConsumerWarps;
using sm90::kKeys;
using sm90::kLog2e;
using sm90::kRows;
using sm90::pack_a;
using sm90::prepare;
using sm90::produce_q_work;
using sm90::QSmem;
using sm90::smem_at_1024;
using sm90::warp_arrive;

constexpr int kFwdStages = 4;       // K/V tiles in flight: forward
constexpr int kDqStages = 3;        // K/V tiles in flight: dQ
constexpr int kDkvKeys = 128;       // keys per dK/dV work tile
constexpr int kDkvStages = 4;       // (Q, dO) tiles in flight: dK/dV
constexpr int kQTile = 64;          // positions per streamed (Q, dO) tile
constexpr int kThreads = 32 * kConsumerWarps + 32;   // + the producer warp
constexpr int kDqThreads = 32 * kConsumerWarps + 128;   // + producer group
constexpr int kDkvGroups = kDkvKeys / 64;            // consumer warpgroups
constexpr int kDkvThreads = 128 * (kDkvGroups + 1);  // + producer group
// One CUDA block per SM walking the work tiles, or one per work tile:
// the forward and dQ walk (kernel_ab flash-persistent, flash-dq-
// persistent); dK/dV's work tiles differ more in weight, and the block
// scheduler balances them better than a fixed stride (flash-dkv-
// persistent).
constexpr bool kPersistent = true;
constexpr bool kDkvPersistent = false;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

struct Params {
  float* lse;             // forward: out; backward: in. (B, H, S)
  const float* delta;     // backward: (B, H, S)
  int batch, seq, heads, kv_heads, n_rep, positions, tiles, causal, window;
  float scale;
};

// dK/dV: the work tile's K and V (then the dK and dV staging), and
// kDkvStages (Q, dO, lse, delta) tiles.
template <int D>
struct KvSmem {
  static constexpr int kChunks = D / 64;
  alignas(1024) bf16 k[kChunks][kDkvKeys * 64];
  alignas(1024) bf16 v[kChunks][kDkvKeys * 64];
  alignas(1024) bf16 q[kDkvStages][kChunks][kQTile * 64];
  alignas(1024) bf16 dout[kDkvStages][kChunks][kQTile * 64];
  float lse[kDkvStages][kQTile];      // times log2 e; +inf past S
  float delta[kDkvStages][kQTile];
  uint64_t kv_full, kv_empty, full[kDkvStages], empty[kDkvStages];
};

__device__ __forceinline__ float mask(float s, int pos, int c,
                                      const Params& p) {
  if (c >= p.seq) return neg_inf();
  if (p.causal && c > pos) return kMaskValue;
  if (p.window > 0 && pos - c >= p.window) return kMaskValue;
  return s;
}

// Whether a (position, key) pair is masked out or absent.
__device__ __forceinline__ bool hidden(int pos, int c, const Params& p) {
  return c >= p.seq || (p.causal && c > pos) ||
         (p.window > 0 && pos - c >= p.window);
}

// Forward / dQ work tile w: heaviest q tiles first (the longest causal
// walks), then (b, KV head); key tiles [t_lo, t_hi) of kKeys.
struct QWork {
  int b, kvh, q0, q_last, t_lo, t_hi;
  __device__ QWork(int w, const Params& p) {
    const int groups = p.batch * p.kv_heads;
    const int qt = p.causal ? p.tiles - 1 - w / groups : w / groups;
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

// dK/dV work tile w: (b, KV head, key tile), the lowest key tiles (which
// the most queries see under a causal mask) first; q tiles [qt_lo, qt_hi)
// of kQTile positions for each of the group's heads.
struct KvWork {
  int b, kvh, k0, qt_lo, qt_hi;
  __device__ KvWork(int w, const Params& p) {
    const int groups = p.batch * p.kv_heads;
    b = (w % groups) / p.kv_heads;
    kvh = w % p.kv_heads;
    k0 = (w / groups) * kDkvKeys;
    const int q_lo = p.causal ? k0 : 0;
    const int q_hi = p.window > 0 ? min(p.seq, k0 + kDkvKeys - 1 + p.window)
                                  : p.seq;
    qt_lo = q_lo / kQTile;
    qt_hi = (q_hi + kQTile - 1) / kQTile;
  }
};

// A 64 x D accumulator (rows lr0, lr0 + 8 of this thread) times `scale`,
// rounded to bf16, into a swizzled staging tile of chunk stride `chunk`.
template <int D>
__device__ __forceinline__ void stage_rows(unsigned char* tile, int chunk,
                                           const float (&acc)[D / 2], int lr0,
                                           float scale0, float scale1) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    unsigned char* at = tile + (j / 8) * chunk + 4 * t4;
    *reinterpret_cast<uint32_t*>(at + sm90::swizzled(lr0, j % 8)) =
        sm90::pack_bf16(acc[4 * j] * scale0, acc[4 * j + 1] * scale0);
    *reinterpret_cast<uint32_t*>(at + sm90::swizzled(lr0 + 8, j % 8)) =
        sm90::pack_bf16(acc[4 * j + 2] * scale1, acc[4 * j + 3] * scale1);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to,
                       const Params p) {
  constexpr int kChunks = D / 64, kStages = kFwdStages;
  using Smem = QSmem<D, kStages, 1>;
  Smem& sm = smem_at_1024<Smem>();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_work = p.batch * p.kv_heads * p.tiles;
  init_q_barriers(sm);

  if (warp == kConsumerWarps) {                 // the producer warp
    if (lane == 0) produce_q_work<QWork>(sm, &tq, &tq, &tk, &tv, p, n_work);
    return;
  }

  // Consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile;
  // this thread owns rows lr0 and lr0 + 8 of them.
  const int wg = warp / 4, g = lane / 4, t4 = lane % 4;
  const int lr0 = wg * 64 + (warp % 4) * 16 + g, lr1 = lr0 + 8;
  const unsigned char* q_rows =
      reinterpret_cast<const unsigned char*>(sm.q[0][0]) + wg * 64 * 128;
  float o[D / 2], sacc[kKeys / 2];
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) sacc[i] = 0.f;
  uint32_t pf[kKeys / 16][4];
  int it = 0;                                   // K/V tiles consumed

  for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
    const QWork wk(w, p);
    const int pos0 = wk.q0 + lr0 / p.n_rep, pos1 = wk.q0 + lr1 / p.n_rep;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = neg_inf(), m1 = neg_inf(), l0 = 0.f, l1 = 0.f;

    // S = Q.K^T of the tile in stage s, into sacc (not waited for).
    auto issue_scores = [&](int s) {
      issue_ss<D>(sacc, q_rows, sizeof(sm.q[0][0]),
                  reinterpret_cast<const unsigned char*>(sm.k[s][0]),
                  sizeof(sm.k[0][0]));
      sm90::wgmma_commit();
    };
    // P.V of the tile in stage s, from pf, into o (not waited for).
    auto issue_pv = [&](int s) {
      issue_rs<D>(o, pf, reinterpret_cast<const unsigned char*>(sm.v[s][0]),
                  sizeof(sm.v[0][0]));
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
      pack_a(pf, sacc);
    };

    // Software pipeline over the key tiles; the last tile's P.V is
    // peeled off, so every wgmma wait retires a known group. Q's last
    // reader is the work tile's last score product.
    const int n_tiles = wk.t_hi - wk.t_lo;
    float alpha0, alpha1;
    sm90::mbar_wait(&sm.q_full, n & 1);
    sm90::mbar_wait(&sm.k_full[it % kStages], (it / kStages) & 1);
    sm90::wgmma_fence();
    issue_scores(it % kStages);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sacc);
    if (n_tiles == 1) warp_arrive(&sm.q_empty);
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
      if (i + 2 == n_tiles) warp_arrive(&sm.q_empty);
      softmax(wk.t_lo + i + 1, alpha0, alpha1);
      sm90::wgmma_wait<0>();                    // P.V of tile i
      sm90::fence_regs(o);
      warp_arrive(&sm.empty[s]);
      rescale_and_pack(alpha0, alpha1);
    }
    {
      const int s = it % kStages;
      sm90::mbar_wait(&sm.v_full[s], (it / kStages) & 1);
      sm90::wgmma_fence();
      issue_pv(s);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      warp_arrive(&sm.empty[s]);
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

template <int D>
__global__ void __launch_bounds__(kDqThreads, 1)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdq,
                      const Params p) {
  constexpr int kChunks = D / 64, kStages = kDqStages;
  using Smem = QSmem<D, kStages, 2>;
  Smem& sm = smem_at_1024<Smem>();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_work = p.batch * p.kv_heads * p.tiles;
  init_q_barriers(sm);

  if (warp >= kConsumerWarps) {                 // the producer warpgroup
    sm90::setmaxnreg_dec<40>();
    if (warp == kConsumerWarps && lane == 0) {
      produce_q_work<QWork>(sm, &tq, &tdo, &tk, &tv, p, n_work);
    }
    return;
  }
  sm90::setmaxnreg_inc<232>();

  const int wg = warp / 4, g = lane / 4, t4 = lane % 4;
  const int lr0 = wg * 64 + (warp % 4) * 16 + g, lr1 = lr0 + 8;
  const unsigned char* q_rows =
      reinterpret_cast<const unsigned char*>(sm.q[0][0]) + wg * 64 * 128;
  const unsigned char* do_rows =
      reinterpret_cast<const unsigned char*>(sm.q[1][0]) + wg * 64 * 128;
  const int live_rows = p.positions * p.n_rep;
  const float c = p.scale * kLog2e;
  float dq[D / 2], sacc[32], dpacc[32];
  uint32_t dsf[4][4];
  int it = 0;                                   // K/V tiles consumed

  for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
    const QWork wk(w, p);
    // This thread's two rows: position, lse (log2 units) and delta, read
    // once a work tile; a row past S or past the tile's live rows takes
    // lse = +inf, so its p is 0.
    int pos[2];
    float lse2[2], dlt[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = h ? lr1 : lr0;
      pos[h] = wk.q0 + row / p.n_rep;
      lse2[h] = pos_inf();
      dlt[h] = 0.f;
      if (row < live_rows && pos[h] < p.seq) {
        const long long at =
            (static_cast<long long>(wk.b) * p.heads + wk.kvh * p.n_rep +
             row % p.n_rep) * p.seq + pos[h];
        lse2[h] = p.lse[at] * kLog2e;
        dlt[h] = p.delta[at];
      }
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    // S = Q.K^T and dP = dO.V^T of the tile in stage s (not waited for).
    auto issue_sdp = [&](int s) {
      issue_ss<D>(sacc, q_rows, sizeof(sm.q[0][0]),
                  reinterpret_cast<const unsigned char*>(sm.k[s][0]),
                  sizeof(sm.k[0][0]));
      issue_ss<D>(dpacc, do_rows, sizeof(sm.q[0][0]),
                  reinterpret_cast<const unsigned char*>(sm.v[s][0]),
                  sizeof(sm.v[0][0]));
      sm90::wgmma_commit();
    };
    // dQ += dS.K of the tile in stage s, from dsf (not waited for).
    auto issue_dq = [&](int s) {
      issue_rs<D>(dq, dsf, reinterpret_cast<const unsigned char*>(sm.k[s][0]),
                  sizeof(sm.k[0][0]));
      sm90::wgmma_commit();
    };
    // ds = p (dp - delta) of key tile t, in place in sacc, p = exp2(s c -
    // lse2) and 0 where a mask hides the pair (only tiles a mask touches
    // check).
    auto dscores = [&](int t) {
      const int k0 = t * kKeys;
      const bool edge = k0 + kKeys > p.seq ||
                        (p.causal && k0 + kKeys - 1 > wk.q0) ||
                        (p.window > 0 && wk.q_last - k0 >= p.window);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2, i = 4 * j + e;
          float pe = sm90::exp2_approx(fmaf(sacc[i], c, -lse2[h]));
          if (edge && hidden(pos[h], k0 + 8 * j + 2 * t4 + (e & 1), p)) {
            pe = 0.f;
          }
          sacc[i] = pe * (dpacc[i] - dlt[h]);
        }
      }
    };

    // The forward's pipeline: S and dP of tile i + 1 issued with tile
    // i's dQ product, the last dQ product peeled off.
    const int n_tiles = wk.t_hi - wk.t_lo;
    auto wait_kv = [&](int at) {
      sm90::mbar_wait(&sm.k_full[at % kStages], (at / kStages) & 1);
      sm90::mbar_wait(&sm.v_full[at % kStages], (at / kStages) & 1);
    };
    sm90::mbar_wait(&sm.q_full, n & 1);
    wait_kv(it);
    sm90::wgmma_fence();
    issue_sdp(it % kStages);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sacc);
    sm90::fence_regs(dpacc);
    if (n_tiles == 1) warp_arrive(&sm.q_empty);
    dscores(wk.t_lo);
    pack_a(dsf, sacc);
    for (int i = 0; i + 1 < n_tiles; ++i, ++it) {
      const int s = it % kStages;
      wait_kv(it + 1);
      sm90::wgmma_fence();
      issue_sdp((it + 1) % kStages);
      issue_dq(s);
      sm90::wgmma_wait<1>();                    // S and dP of tile i + 1
      sm90::fence_regs(sacc);
      sm90::fence_regs(dpacc);
      if (i + 2 == n_tiles) warp_arrive(&sm.q_empty);
      dscores(wk.t_lo + i + 1);
      sm90::wgmma_wait<0>();                    // dQ product of tile i
      sm90::fence_regs(dq);
      warp_arrive(&sm.empty[s]);
      pack_a(dsf, sacc);
    }
    {
      const int s = it % kStages;
      sm90::wgmma_fence();
      issue_dq(s);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq);
      warp_arrive(&sm.empty[s]);
      ++it;
    }

    // Epilogue: dQ * scale through the staging tile and one TMA store of
    // the live rows; positions past S are clipped by the map.
    sm90::named_barrier_sync(1, 32 * kConsumerWarps);
    stage_rows<D>(reinterpret_cast<unsigned char*>(sm.o[0]), sizeof(sm.o[0]),
                  dq, lr0, p.scale, p.scale);
    sm90::fence_async_shared();
    sm90::named_barrier_sync(2, 32 * kConsumerWarps);
    if (threadIdx.x == 0) {
      for (int cc = 0; cc < kChunks; ++cc) {
        sm90::tma_store_4d(&tdq, sm.o[cc], 64 * cc, wk.kvh * p.n_rep, wk.q0,
                           wk.b);
      }
      sm90::tma_store_commit_and_wait();
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdk,
                       const __grid_constant__ CUtensorMap tdv,
                       const Params p) {
  constexpr int kChunks = D / 64, kStages = kDkvStages;
  constexpr int kWarps = 4 * kDkvGroups;        // consumer warps
  using Smem = KvSmem<D>;
  Smem& sm = smem_at_1024<Smem>();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_work = p.batch * p.kv_heads * p.tiles;
  if (threadIdx.x == 0) {
    sm90::mbar_init(&sm.kv_full, 1);
    sm90::mbar_init(&sm.kv_empty, kDkvGroups);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&sm.full[s], 1 + 32);     // the copies + lse/delta
      sm90::mbar_init(&sm.empty[s], kWarps);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kWarps) {                         // the producer warpgroup
    sm90::setmaxnreg_dec<40>();
    if (warp != kWarps) return;
    int it = 0;                                 // (Q, dO) tiles issued
    for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
      const KvWork wk(w, p);
      if (lane == 0) {
        if (n > 0) sm90::mbar_wait(&sm.kv_empty, (n - 1) & 1);
        sm90::mbar_expect_tx(&sm.kv_full, 2 * kChunks * kDkvKeys * 128);
        for (int c = 0; c < kChunks; ++c) {
          sm90::tma_load_4d(sm.k[c], &tk, &sm.kv_full, 64 * c, wk.kvh, wk.k0,
                            wk.b);
          sm90::tma_load_4d(sm.v[c], &tv, &sm.kv_full, 64 * c, wk.kvh, wk.k0,
                            wk.b);
        }
      }
      for (int rep = 0; rep < p.n_rep; ++rep) {
        const int h = wk.kvh * p.n_rep + rep;
        const long long row0 =
            (static_cast<long long>(wk.b) * p.heads + h) * p.seq;
        for (int qt = wk.qt_lo; qt < wk.qt_hi; ++qt, ++it) {
          const int s = it % kStages;
          if (it >= kStages) {
            sm90::mbar_wait(&sm.empty[s], (it / kStages - 1) & 1);
          }
          if (lane == 0) {
            sm90::mbar_expect_tx(&sm.full[s], 2 * kChunks * kQTile * 128);
            for (int c = 0; c < kChunks; ++c) {
              sm90::tma_load_4d(sm.q[s][c], &tq, &sm.full[s], 64 * c, h,
                                qt * kQTile, wk.b);
              sm90::tma_load_4d(sm.dout[s][c], &tdo, &sm.full[s], 64 * c, h,
                                qt * kQTile, wk.b);
            }
          }
          for (int i = lane; i < kQTile; i += 32) {
            const int pos = qt * kQTile + i;
            const bool in = pos < p.seq;
            sm.lse[s][i] = in ? p.lse[row0 + pos] * kLog2e : pos_inf();
            sm.delta[s][i] = in ? p.delta[row0 + pos] : 0.f;
          }
          sm90::mbar_arrive(&sm.full[s]);
        }
      }
    }
    return;
  }
  sm90::setmaxnreg_inc<232>();

  // Consumers: warpgroup wg owns keys [64 wg, 64 wg + 64) of the tile;
  // this thread owns keys (rows) kr0 and kr0 + 8 of them.
  const int wg = warp / 4, g = lane / 4, t4 = lane % 4;
  const int kr0 = wg * 64 + (warp % 4) * 16 + g;
  unsigned char* k_rows = reinterpret_cast<unsigned char*>(sm.k[0]) + wg * 64 * 128;
  unsigned char* v_rows = reinterpret_cast<unsigned char*>(sm.v[0]) + wg * 64 * 128;
  const float c = p.scale * kLog2e;
  float dk[D / 2], dv[D / 2], sacc[32], dpacc[32];
  uint32_t pf[4][4], dsf[4][4];
  int it = 0;                                   // (Q, dO) tiles consumed

  for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
    const KvWork wk(w, p);
    const int kw0 = wk.k0 + 64 * wg;            // this warpgroup's keys
    const int key[2] = {wk.k0 + kr0, wk.k0 + kr0 + 8};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    sm90::mbar_wait(&sm.kv_full, n & 1);

    // S^T = K.Q^T and dP^T = V.dO^T of the (Q, dO) tile in stage s.
    auto issue_sdp = [&](int s) {
      issue_ss<D>(sacc, k_rows, sizeof(sm.k[0]),
                  reinterpret_cast<const unsigned char*>(sm.q[s][0]),
                  sizeof(sm.q[0][0]));
      issue_ss<D>(dpacc, v_rows, sizeof(sm.v[0]),
                  reinterpret_cast<const unsigned char*>(sm.dout[s][0]),
                  sizeof(sm.dout[0][0]));
      sm90::wgmma_commit();
    };
    // dV += P^T.dO and dK += dS^T.Q of the tile in stage s, from pf, dsf.
    auto issue_dkv = [&](int s) {
      issue_rs<D>(dv, pf, reinterpret_cast<const unsigned char*>(sm.dout[s][0]),
                  sizeof(sm.dout[0][0]));
      issue_rs<D>(dk, dsf, reinterpret_cast<const unsigned char*>(sm.q[s][0]),
                  sizeof(sm.q[0][0]));
      sm90::wgmma_commit();
    };
    // p^T into sacc and ds^T into dpacc, in place: rows are keys, columns
    // positions q0 + col.
    auto probs = [&](int s, int q0) {
      const bool edge = (p.causal && kw0 + 63 > q0) ||
                        (p.window > 0 && q0 + kQTile - 1 - kw0 >= p.window);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e, col = 8 * j + 2 * t4 + (e & 1);
          float pe = sm90::exp2_approx(fmaf(sacc[i], c, -sm.lse[s][col]));
          if (edge && hidden(q0 + col, key[e / 2], p)) pe = 0.f;
          dpacc[i] = pe * (dpacc[i] - sm.delta[s][col]);
          sacc[i] = pe;
        }
      }
    };
    // Tile t of the walk: the group's heads one after another, each over
    // q tiles [qt_lo, qt_hi). A q tile none of this warpgroup's keys can
    // see adds nothing and is only released.
    const int per_head = wk.qt_hi - wk.qt_lo, n_tiles = p.n_rep * per_head;
    auto q0_of = [&](int t) { return (wk.qt_lo + t % per_head) * kQTile; };
    auto seen = [&](int q0) {
      return (!p.causal || q0 + kQTile - 1 >= kw0) &&
             (p.window == 0 || q0 - (kw0 + 63) < p.window);
    };
    for (int t = 0; t < n_tiles; ++t, ++it) {
      const int s = it % kStages, q0 = q0_of(t);
      sm90::mbar_wait(&sm.full[s], (it / kStages) & 1);
      if (seen(q0)) {
        sm90::wgmma_fence();
        issue_sdp(s);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sacc);
        sm90::fence_regs(dpacc);
        probs(s, q0);
        pack_a(pf, sacc);
        pack_a(dsf, dpacc);
        sm90::wgmma_fence();
        issue_dkv(s);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dk);
        sm90::fence_regs(dv);
      }
      warp_arrive(&sm.empty[s]);
    }

    // Epilogue: this warpgroup's keys of dK * scale and dV, rounded once,
    // into its rows of K's and V's tiles (its last product has read
    // them), then TMA stores clipped at S; the producer reloads K and V
    // once every warpgroup's stores have read them.
    const int lr0 = (warp % 4) * 16 + g;
    stage_rows<D>(k_rows, sizeof(sm.k[0]), dk, lr0, p.scale, p.scale);
    stage_rows<D>(v_rows, sizeof(sm.v[0]), dv, lr0, 1.f, 1.f);
    sm90::fence_async_shared();
    sm90::named_barrier_sync(1 + wg, 128);
    if (threadIdx.x % 128 == 0) {
      for (int cc = 0; cc < kChunks; ++cc) {
        sm90::tma_store_4d(&tdk, k_rows + cc * sizeof(sm.k[0]), 64 * cc,
                           wk.kvh, kw0, wk.b);
        sm90::tma_store_4d(&tdv, v_rows + cc * sizeof(sm.v[0]), 64 * cc,
                           wk.kvh, kw0, wk.b);
      }
      sm90::tma_store_commit_and_wait();
      sm90::mbar_arrive(&sm.kv_empty);
    }
  }
}

// The maps of one launch. Rows of q, dO and their outputs come grouped
// (box n_rep heads x 128 / n_rep positions) or one head at a time (box 1
// x rows); K and V one KV head x `kv_rows` keys.
struct Maps {
  CUtensorMap q, k, v, dout, out, dk, dv;
};

bool encode_maps(Which which, const Args& a, int d, int q_box_h,
                 int q_box_s, int kv_rows, Maps* m) {
  const long long o_ss = static_cast<long long>(a.heads) * d;
  const long long kv_ss = static_cast<long long>(a.kv_heads) * d;
  bool ok = encode_bshd(&m->q, a.q, d, a.heads, a.seq, a.batch, a.q_sh,
                        a.q_ss, a.q_sb, q_box_h, q_box_s) &&
            encode_bshd(&m->k, a.k, d, a.kv_heads, a.seq, a.batch, a.k_sh,
                        a.k_ss, a.k_sb, 1, kv_rows) &&
            encode_bshd(&m->v, a.v, d, a.kv_heads, a.seq, a.batch, a.v_sh,
                        a.v_ss, a.v_sb, 1, kv_rows);
  if (which == kForward || which == kDq) {
    ok = ok && encode_bshd(&m->out, a.out, d, a.heads, a.seq, a.batch, d,
                           o_ss, o_ss * a.seq, q_box_h, q_box_s);
  } else {
    ok = ok && encode_bshd(&m->dk, a.dk, d, a.kv_heads, a.seq, a.batch, d,
                           kv_ss, kv_ss * a.seq, 1, 64) &&
         encode_bshd(&m->dv, a.dv, d, a.kv_heads, a.seq, a.batch, d, kv_ss,
                     kv_ss * a.seq, 1, 64);
  }
  if (which != kForward) {
    ok = ok && encode_bshd(&m->dout, a.dout, d, a.heads, a.seq, a.batch,
                           a.o_sh, a.o_ss, a.o_sb, q_box_h, q_box_s);
  }
  return ok;
}

template <int D>
cudaError_t launch(Which which, const Args& a, cudaStream_t stream) {
  if (a.n_rep > kRows) return cudaErrorInvalidValue;
  Params p;
  p.lse = which == kForward ? a.lse_out : const_cast<float*>(a.lse);
  p.delta = a.delta;
  p.batch = a.batch;
  p.seq = a.seq;
  p.heads = a.heads;
  p.kv_heads = a.kv_heads;
  p.n_rep = a.n_rep;
  p.causal = a.causal;
  p.window = a.window;
  p.scale = a.scale;
  Maps m;
  cudaError_t err;
  int grid;
  if (which == kDkv) {
    p.positions = kQTile;
    p.tiles = (a.seq + kDkvKeys - 1) / kDkvKeys;
    if (!encode_maps(which, a, D, 1, kQTile, kDkvKeys, &m)) {
      return cudaErrorInvalidValue;
    }
    const size_t smem = sizeof(KvSmem<D>) + 1024;   // + alignment slack
    auto kernel = flash_dkv_wgmma_kernel<D>;
    err = prepare(kernel, smem, a.batch * a.kv_heads * p.tiles,
                  kDkvPersistent, &grid);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kDkvThreads, smem, stream>>>(m.q, m.dout, m.k, m.v, m.dk,
                                                m.dv, p);
    return cudaGetLastError();
  }
  p.positions = kRows / a.n_rep;
  p.tiles = (a.seq + p.positions - 1) / p.positions;
  if (!encode_maps(which, a, D, a.n_rep, p.positions, kKeys, &m)) {
    return cudaErrorInvalidValue;
  }
  const int n_work = a.batch * a.kv_heads * p.tiles;
  if (which == kForward) {
    const size_t smem = sizeof(QSmem<D, kFwdStages, 1>) + 1024;
    auto kernel = flash_fwd_wgmma_kernel<D>;
    err = prepare(kernel, smem, n_work, kPersistent, &grid);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(m.q, m.k, m.v, m.out, p);
  } else {
    const size_t smem = sizeof(QSmem<D, kDqStages, 2>) + 1024;
    auto kernel = flash_dq_wgmma_kernel<D>;
    err = prepare(kernel, smem, n_work, kPersistent, &grid);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kDqThreads, smem, stream>>>(m.q, m.dout, m.k, m.v, m.out,
                                               p);
  }
  return cudaGetLastError();
}

}  // namespace hopper

// bf16 at head_dim 64 and 128 takes the wgmma / TMA kernels.
template <typename T, int D>
constexpr bool kUseWgmma = std::is_same<T, __nv_bfloat16>::value && D <= 128;

template <typename T, int D>
cudaError_t launch_cuda_cores(Which which, const Args& a,
                              cudaStream_t stream) {
  constexpr int kTile = D > 128 ? 32 : 64;
  const int q_tiles = (a.seq + kTile - 1) / kTile;
  void (*kernel)(Args);
  size_t smem;
  dim3 grid;
  if (which == kForward) {
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
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_typed(Which which, const Args& a, cudaStream_t stream) {
  if constexpr (kUseWgmma<T, D>) {
    return hopper::launch<D>(which, a, stream);
  } else {
    return launch_cuda_cores<T, D>(which, a, stream);
  }
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
