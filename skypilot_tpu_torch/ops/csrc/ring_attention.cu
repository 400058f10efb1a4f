// One ring-attention hop for Hopper (sm_90a), float and bf16: the online-
// softmax update of a query chunk's running state (o, m, l) against one
// K/V chunk.
//
// Replaces the TPU kernel of skypilot_tpu/ops/ring_attention.py,
// reached from every hop of `ring_attention` (:150) when the hop runs as a
// kernel:
//   ring_chunk_kernel / ring_chunk_mma_kernel <- `_chunk_update_kernel`
//   (:71, via `_chunk_update_pallas` :111, pl.pallas_call at :135)
//
// What it computes (the TPU kernel's contract, `_chunk_update` :47 op for
// op). s = q.k^T accumulated in fp32 from operands in the input dtype,
// times sm_scale; mask mode 1 sets s = -1e30 (not -inf) where
// k_offset + c > q_offset + r, mode 0 masks nothing; m_new = max(m,
// rowmax s); p = exp(s - m_new); alpha = exp(m - m_new); l_new = l alpha +
// sum p; o_new = o alpha + P.V, with p rounded to the input dtype before
// the P.V product and the product itself rounded to the input dtype, then
// widened to fp32. o is (B, Sq, H, D) fp32, m and l (B, H, Sq) fp32; they
// are read once and written once.
//
// Translation to Hopper.
// - Grid. The TPU kernel holds a whole (Sq, D) x (Sk, D) chunk pair in
//   VMEM per (batch, head) grid cell. Here one CUDA block owns one (b, h,
//   64-row q tile) and loops over 64-key k tiles of the chunk, carrying a
//   running max that STARTS at the incoming m: p is taken against the
//   running max and rescaled by exp(m_old - m_new) as the max grows, which
//   is the chunk-wide max the reference uses once the last tile is in. The
//   P.V sum is kept apart from the incoming o, rounded to the input dtype
//   once at the end and then added to o exp(m_in - m_new) in fp32: the
//   reference's o alpha + P.V. At B 4, H 16, Sq 512 that is 512 blocks.
// - -1e30. A row whose keys are all masked so far, with m = -1e30 coming
//   in, gets p = exp(-1e30 + 1e30) = 1 for every masked key, as the
//   reference does; as soon as a visible key raises the max, those p are
//   multiplied by exp(-1e30 - m) = 0 exactly. So a tiled walk gets the
//   reference's answer both when a later tile has a visible key and when
//   none has (alpha stays 1).
// - Causal tiles. In mask mode 1 with q_offset >= k_offset every row sees
//   key 0 of the chunk, which the walk visits first; key tiles wholly
//   past the tile's last visible key are then masked for every row and
//   would add exactly 0, so they are skipped (and q tiles start from the
//   heaviest). With q_offset < k_offset nothing is skipped: a fully masked
//   row still takes p = 1 there.
// - Layout. q, k and v are read in place through their (batch, seq, head)
//   strides (a chunk of the fused qkv projection needs no copy), and query
//   head h reads KV head h / n_rep: K/V are never repeated in memory.
// - Two routes, as in flash_attention.cu: bf16 at head_dim 64 and 128 runs
//   the tensor-core kernel (mma.sync m16n8k16, ldmatrix, 4 warps of 16
//   rows); fp32, and bf16 at head_dim 256, the CUDA-core kernel (256
//   threads in a 16 x 16 layout, 64-row tiles, 32 at head_dim 256).
//
// What bounds it on the H100. At the training shape (B 4, Sq = Sk = 512,
// H 16, KV 8, D 128, bf16) one full hop reads q (8.4 MB), k and v (4.2 MB
// each at KV heads), o (16.8 MB fp32), m and l, and writes o, m and l:
// ~50.9 MB, 15.2 us at 3.35 TB/s, against 8.6 GFLOP of products (4 D per
// pair), 8.7 us at 989 TFLOP/s: bytes bound it, the fp32 state above all.
// The simple design reads each of them once per block and keeps K/V tiles
// in shared memory; pipelined tile loads and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMmaThreads = 128;
constexpr float kMaskValue = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* o_in;    // (B, Sq, H, D) contiguous
  const float* m_in;    // (B, H, Sq)
  const float* l_in;
  float* o_out;
  float* m_out;
  float* l_out;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int batch, s_q, s_k, heads, kv_heads, n_rep, mask_mode, q_offset, k_offset;
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
  __device__ static __forceinline__ float round(float x) { return x; }
};

template <>
struct Elt<__nv_bfloat16> {
  __device__ static __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

// Mask mode 1 with q_offset >= k_offset: whole key tiles past the last
// visible key of the q tile are skipped (see the header).
__device__ __forceinline__ bool skips_tiles(const Args& a) {
  return a.mask_mode == 1 && a.q_offset >= a.k_offset;
}

// One past the last key the q tile [q0, q0 + rows) walks.
__device__ __forceinline__ int key_end(const Args& a, int q0, int rows) {
  if (!skips_tiles(a)) return a.s_k;
  const long long hi = static_cast<long long>(a.q_offset) - a.k_offset + q0 + rows;
  return static_cast<int>(min(hi, static_cast<long long>(a.s_k)));
}

// The reference's mask on one scaled score: keys past the chunk -inf (p = 0
// exactly), mode-1 misses -1e30.
__device__ __forceinline__ float masked(float s, int r, int c, const Args& a) {
  if (c >= a.s_k) return neg_inf();
  if (a.mask_mode == 1 && a.k_offset + c > a.q_offset + r) return kMaskValue;
  return s;
}

__device__ __forceinline__ long long state_row(const Args& a, int b, int h, int r) {
  return (static_cast<long long>(b) * a.heads + h) * a.s_q + r;
}

__device__ __forceinline__ long long o_offset(const Args& a, int b, int h, int r, int d) {
  return ((static_cast<long long>(b) * a.s_q + r) * a.heads + h) * d;
}

// The epilogue of one row: o_out = o_in alpha + round(pv), l_out = l_in
// alpha + l_chunk, alpha = exp(m_in - m_new). Multiplies and adds are
// rounded separately, as the reference's two operations are.
__device__ __forceinline__ float update_o(float o_in, float alpha, float pv) {
  return __fadd_rn(__fmul_rn(o_in, alpha), pv);
}

// ------------------------------------------------------- CUDA-core kernel

// Rows [r0, r0 + ROWS) of one (b, head) slab into a [ROWS][D + 2] tile, 16
// bytes per global load, zeros past `rows`.
template <typename T, int ROWS, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long row_stride, int r0,
                                          int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  constexpr int kLd = D + 2;
  for (int idx = threadIdx.x; idx < ROWS * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows) {
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * row_stride + c);
    }
    uint32_t* w = reinterpret_cast<uint32_t*>(dst + r * kLd + c);
    w[0] = val.x;
    w[1] = val.y;
    w[2] = val.z;
    w[3] = val.w;
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

template <typename T, int D, int BQ, int BK>
constexpr size_t chunk_smem() {
  return (BQ + 2 * BK) * (D + 2) * sizeof(T) + BQ * (BK + 1) * sizeof(float);
}

// A thread owns rows ty + 16 i and key columns tx + 16 j of each score
// tile, and column pairs 2 tx + 32 j of the D-wide P.V sum.
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
ring_chunk_kernel(const Args a) {
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
  const int qt = skips_tiles(a) ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  load_tile<T, BQ, D>(qs, q, a.q_ss, q0, a.s_q);
  const int k_hi = key_end(a, q0, BQ);

  float m_in[MI], m[MI], l[MI], acc[MI][DJ][2];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = q0 + ty + 16 * i;
    m_in[i] = r < a.s_q ? a.m_in[state_row(a, b, h, r)] : kMaskValue;
    m[i] = m_in[i];
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j][0] = acc[i][j][1] = 0.f;
  }

  for (int k0 = 0; k0 < k_hi; k0 += BK) {
    __syncthreads();                        // last tile's ps / vs reads done
    load_tile<T, BK, D>(ks, k, a.k_ss, k0, a.s_k);
    load_tile<T, BK, D>(vs, v, a.v_ss, k0, a.s_k);
    __syncthreads();
    float s[MI][NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 2) {
      float2 qa[MI], kb[NJ];
#pragma unroll
      for (int i = 0; i < MI; ++i) qa[i] = Elt<T>::load2(qs + (ty + 16 * i) * kLd + d);
#pragma unroll
      for (int j = 0; j < NJ; ++j) kb[j] = Elt<T>::load2(ks + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
        }
      }
    }
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

#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.s_q) continue;
    const float alpha = expf(m_in[i] - m[i]);
    const long long row = o_offset(a, b, h, r, D);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = 2 * tx + 32 * j;
      const float2 o = *reinterpret_cast<const float2*>(a.o_in + row + d);
      *reinterpret_cast<float2*>(a.o_out + row + d) = make_float2(
          update_o(o.x, alpha, Elt<T>::round(acc[i][j][0])),
          update_o(o.y, alpha, Elt<T>::round(acc[i][j][1])));
    }
    if (tx == 0) {
      const long long sr = state_row(a, b, h, r);
      a.l_out[sr] = __fadd_rn(__fmul_rn(a.l_in[sr], alpha), l[i]);
      a.m_out[sr] = m[i];
    }
  }
}

// ------------------------------------------------- bf16 tensor-core kernel
//
// The products run on the tensor cores through mma.sync m16n8k16 (bf16
// operands, fp32 accumulation), with the fragment plumbing of
// flash_fwd_mma_kernel (flash_attention.cu): 4 warps per block, each owning
// 16 rows of the 64-row q tile; tiles row-major in shared memory with rows
// padded by 8 elements; Q and K fragments through ldmatrix, V through
// ldmatrix.trans; the score accumulators turn into P's A fragments in
// registers.

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [r0, r0 + ROWS) of a (b, head) slab into [ROWS][D + 8], zeros past
// `rows`.
template <int ROWS, int D>
__device__ __forceinline__ void load_rows_mma(bf16* dst, const bf16* src,
                                              long long row_stride, int r0,
                                              int rows) {
  constexpr int kPerRow = D / 8, kLd = D + 8;
  for (int idx = threadIdx.x; idx < ROWS * kPerRow; idx += kMmaThreads) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows) {
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
  }
}

// ldmatrix addressing: lane l gives row l % 8 of 8 x 8 matrix l / 8.
// A fragment of rows [row, row + 16), columns [col, col + 16).
__device__ __forceinline__ void load_a(uint32_t (&f)[4], const bf16* tile,
                                       int ld, int row, int col, int lane) {
  const int m = lane / 8, r = lane % 8;
  ldsm_x4(f, tile + (row + r + (m % 2) * 8) * ld + col + (m / 2) * 8);
}

// B fragments of two n-tiles (n rows [n0, n0 + 16), k columns [k0, k0 +
// 16)) from a tile stored [n][k].
__device__ __forceinline__ void load_b_nk(uint32_t (&f)[4], const bf16* tile,
                                          int ld, int n0, int k0, int lane) {
  const int m = lane / 8, r = lane % 8;
  ldsm_x4(f, tile + (n0 + (m / 2) * 8 + r) * ld + k0 + (m % 2) * 8);
}

// The same from a tile stored [k][n], transposed by ldmatrix.trans.
__device__ __forceinline__ void load_b_kn(uint32_t (&f)[4], const bf16* tile,
                                          int ld, int k0, int n0, int lane) {
  const int m = lane / 8, r = lane % 8;
  ldsm_x4_t(f, tile + (k0 + (m % 2) * 8 + r) * ld + n0 + (m / 2) * 8);
}

template <int D>
constexpr size_t chunk_mma_smem() {
  return 3 * 64 * (D + 8) * sizeof(bf16);
}

// Thread (warp, g = lane / 4, t = lane % 4) owns rows r0 = q0 + 16 warp + g
// and r1 = r0 + 8, columns 8 j + 2 t (+1) of each score n-tile and of the
// D-wide P.V sum.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
ring_chunk_mma_kernel(const Args a) {
  constexpr int BQ = 64, BK = 64, kLd = D + 8;
  constexpr int KS = D / 16, NT = BK / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + BQ * kLd;
  bf16* vs = ks + BK * kLd;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int kvh = h / a.n_rep;
  const int qt = skips_tiles(a) ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  load_rows_mma<BQ, D>(qs, q, a.q_ss, q0, a.s_q);
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) load_a(qf[kk], qs, kLd, warp * 16, kk * 16, lane);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const int k_hi = key_end(a, q0, BQ);

  const float m_in0 = r0 < a.s_q ? a.m_in[state_row(a, b, h, r0)] : kMaskValue;
  const float m_in1 = r1 < a.s_q ? a.m_in[state_row(a, b, h, r1)] : kMaskValue;
  float m0 = m_in0, m1 = m_in1, l0 = 0.f, l1 = 0.f;
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int k0 = 0; k0 < k_hi; k0 += BK) {
    __syncthreads();
    load_rows_mma<BK, D>(ks, k, a.k_ss, k0, a.s_k);
    load_rows_mma<BK, D>(vs, v, a.v_ss, k0, a.s_k);
    __syncthreads();
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t kb[4];
        load_b_nk(kb, ks, kLd, j * 8, kk * 16, lane);
        mma_bf16(s[j], qf[kk], kb[0], kb[1]);
        mma_bf16(s[j + 1], qf[kk], kb[2], kb[3]);
      }
    }
    float mx0 = neg_inf(), mx1 = neg_inf();
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = k0 + j * 8 + 2 * t;
      s[j][0] = masked(s[j][0] * a.scale, r0, c, a);
      s[j][1] = masked(s[j][1] * a.scale, r0, c + 1, a);
      s[j][2] = masked(s[j][2] * a.scale, r1, c, a);
      s[j][3] = masked(s[j][3] * a.scale, r1, c + 1, a);
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    const float n0 = fmaxf(m0, quad_max(mx0)), n1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = expf(m0 - n0), alpha1 = expf(m1 - n1);
    float sum0 = 0.f, sum1 = 0.f;
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = expf(s[j][0] - n0), p1 = expf(s[j][1] - n0);
      const float p2 = expf(s[j][2] - n1), p3 = expf(s[j][3] - n1);
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      pf[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * alpha0 + quad_sum(sum0);
    l1 = l1 * alpha1 + quad_sum(sum1);
    m0 = n0;
    m1 = n1;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= alpha0;
      o[j][1] *= alpha0;
      o[j][2] *= alpha1;
      o[j][3] *= alpha1;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t vb[4];
        load_b_kn(vb, vs, kLd, kk * 16, j * 8, lane);
        mma_bf16(o[j], pf[kk], vb[0], vb[1]);
        mma_bf16(o[j + 1], pf[kk], vb[2], vb[3]);
      }
    }
  }

  const float alpha0 = expf(m_in0 - m0), alpha1 = expf(m_in1 - m1);
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int d = j * 8 + 2 * t;
    if (r0 < a.s_q) {
      const long long row = o_offset(a, b, h, r0, D) + d;
      const float2 x = *reinterpret_cast<const float2*>(a.o_in + row);
      *reinterpret_cast<float2*>(a.o_out + row) = make_float2(
          update_o(x.x, alpha0, Elt<bf16>::round(o[j][0])),
          update_o(x.y, alpha0, Elt<bf16>::round(o[j][1])));
    }
    if (r1 < a.s_q) {
      const long long row = o_offset(a, b, h, r1, D) + d;
      const float2 x = *reinterpret_cast<const float2*>(a.o_in + row);
      *reinterpret_cast<float2*>(a.o_out + row) = make_float2(
          update_o(x.x, alpha1, Elt<bf16>::round(o[j][2])),
          update_o(x.y, alpha1, Elt<bf16>::round(o[j][3])));
    }
  }
  if (t == 0) {
    if (r0 < a.s_q) {
      const long long sr = state_row(a, b, h, r0);
      a.l_out[sr] = __fadd_rn(__fmul_rn(a.l_in[sr], alpha0), l0);
      a.m_out[sr] = m0;
    }
    if (r1 < a.s_q) {
      const long long sr = state_row(a, b, h, r1);
      a.l_out[sr] = __fadd_rn(__fmul_rn(a.l_in[sr], alpha1), l1);
      a.m_out[sr] = m1;
    }
  }
}

// bf16 at head_dim 64 and 128 takes the tensor-core kernel.
template <typename T, int D>
constexpr bool kUseMma = std::is_same<T, __nv_bfloat16>::value && D <= 128;

template <typename T, int D>
cudaError_t launch_typed(const Args& a, cudaStream_t stream) {
  void (*kernel)(Args);
  size_t smem;
  dim3 grid;
  int threads;
  if constexpr (kUseMma<T, D>) {
    kernel = ring_chunk_mma_kernel<D>;
    smem = chunk_mma_smem<D>();
    grid = dim3(a.batch * a.heads, (a.s_q + 63) / 64);
    threads = kMmaThreads;
  } else {
    constexpr int kTile = D > 128 ? 32 : 64;
    kernel = ring_chunk_kernel<T, D, kTile, kTile>;
    smem = chunk_smem<T, D, kTile, kTile>();
    grid = dim3(a.batch * a.heads, (a.s_q + kTile - 1) / kTile);
    threads = kThreads;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int head_dim, const Args& a, cudaStream_t stream) {
  switch (head_dim) {
    case 64: return launch_typed<T, 64>(a, stream);
    case 128: return launch_typed<T, 128>(a, stream);
    case 256: return launch_typed<T, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// New (o, m, l) from q (B, Sq, H, D), k/v (B, Sk, KV, D) and the incoming
// o (B, Sq, H, D) fp32, m, l (B, H, Sq) fp32. strides: q, k, v (batch,
// seq, head), in elements. dtype 0 fp32, 1 bf16. mask_mode 0 full, 1
// causal across the offsets.
int ring_chunk_update(const void* q, const void* k, const void* v,
                      const float* o_in, const float* m_in, const float* l_in,
                      float* o_out, float* m_out, float* l_out,
                      const long long* strides, int batch, int s_q, int s_k,
                      int heads, int kv_heads, int head_dim, float scale,
                      int mask_mode, int q_offset, int k_offset, int dtype,
                      void* stream) {
  if (batch <= 0 || s_q <= 0 || s_k <= 0 || kv_heads <= 0 ||
      heads % kv_heads || (mask_mode != 0 && mask_mode != 1)) {
    return cudaErrorInvalidValue;
  }
  Args a = {};
  a.q = q; a.k = k; a.v = v;
  a.o_in = o_in; a.m_in = m_in; a.l_in = l_in;
  a.o_out = o_out; a.m_out = m_out; a.l_out = l_out;
  a.q_sb = strides[0]; a.q_ss = strides[1]; a.q_sh = strides[2];
  a.k_sb = strides[3]; a.k_ss = strides[4]; a.k_sh = strides[5];
  a.v_sb = strides[6]; a.v_ss = strides[7]; a.v_sh = strides[8];
  a.batch = batch;
  a.s_q = s_q;
  a.s_k = s_k;
  a.heads = heads;
  a.kv_heads = kv_heads;
  a.n_rep = heads / kv_heads;
  a.mask_mode = mask_mode;
  a.q_offset = q_offset;
  a.k_offset = k_offset;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dim<float>(head_dim, a, s);
  if (dtype == 1) return launch_dim<__nv_bfloat16>(head_dim, a, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
