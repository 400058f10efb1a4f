// One ring-attention hop for Hopper (sm_90a), float and bf16: the online-
// softmax update of a query chunk's running state (o, m, l) against one
// K/V chunk.
//
// Replaces the TPU kernel of skypilot_tpu/ops/ring_attention.py,
// reached from every hop of `ring_attention` (:150) when the hop runs as a
// kernel:
//   ring_chunk_kernel / ring_chunk_wgmma_kernel <- `_chunk_update_kernel`
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
/// Translation to Hopper.
// - Grid. The TPU kernel holds a whole (Sq, D) x (Sk, D) chunk pair in
//   VMEM per (batch, head) grid cell. Here a CUDA block owns a tile of
//   query rows and loops over 64-key k tiles of the chunk, carrying a
//   running max that STARTS at the incoming m: p is taken against the
//   running max and rescaled by exp(m_old - m_new) as the max grows, which
//   is the chunk-wide max the reference uses once the last tile is in. The
//   P.V sum is kept apart from the incoming o, rounded to the input dtype
//   once at the end and then added to o exp(m_in - m_new) in fp32: the
//   reference's o alpha + P.V.
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
//   the wgmma / TMA kernel (ring_chunk_wgmma_kernel, grouped heads; its
//   own note is further down); fp32, and bf16 at head_dim 256, the
//   CUDA-core kernel (256 threads in a 16 x 16 layout, one (b, head) and
//   64-row tile per block, 32 rows at head_dim 256).
//
// What bounds it on the H100. At the training shape (B 4, Sq = Sk = 512,
// H 16, KV 8, D 128, bf16) one full hop reads q (8.4 MB), k and v (4.2 MB
// each at KV heads), o (16.8 MB fp32), m and l, and writes o, m and l:
// ~50.9 MB, 15.2 us at 3.35 TB/s, against 8.6 GFLOP of products (4 D per
// pair), 8.7 us at 989 TFLOP/s: bytes bound it, the fp32 state above all.
// The bf16 kernel reads K/V once per work tile for all n_rep heads of the
// group, overlaps their loads with the products, and reads and writes the
// fp32 state once, in whole 32-byte sectors.



#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma_attention.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMmaThreads = 128;
constexpr float kMaskValue = -1e30f;

using bf16 = __nv_bfloat16;

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

// ------------------------------------------- bf16 kernel: wgmma and TMA
//
// The flash forward's grouped-head mainloop (wgmma_attention.cuh, shared
// with flash_attention.cu): a work tile is (b, KV head, 128 / n_rep
// positions) and takes the n_rep query heads of the group as its 128
// rows (row = position * n_rep + head), so each K/V tile is fetched once
// for all of them; a producer warp loads the tile's Q once by TMA over
// the strided (B, Sq, H, D) view and streams 64-key K/V tiles over the
// strided (B, Sk, KV, D) views through a ring of kStages; two consumer
// warpgroups of 64 rows run S = Q.K^T (m64n64k16) and P.V (m64nDk16, P
// from registers), S of tile i + 1 issued with tile i's P.V; one block
// per work tile, heaviest first when tiles are skipped.
// Where it differs from the flash forward:
// - The state. m starts at the incoming m; the P.V sum is kept apart
//   from the incoming o, rounded to bf16 once, then added in fp32 to
//   o exp(m_in - m_new); l = l_in alpha + sum p. m, l and o go out once.
// - The incoming o, 2/3 of the hop's bytes, is read in the accumulator
//   layout (a quad's four 8-byte loads fill one 32-byte sector). Its
//   prefetch to L2 is issued when the work tile starts, so its latency
//   hides behind the tile's products; held in registers across the last
//   P.V instead, it spilled (ptxas caps a 288-thread block at 168).
// - The mask is the reference's: keys masked to -1e30 by k_offset + c >
//   q_offset + r, never to -inf, and never a select to 0: a row with m =
//   -1e30 so far takes p = exp2(0) = 1 exactly for every masked key, as
//   the reference does. Keys past Sk are -inf (p = 0). Key tiles wholly
//   past a tile's last visible key are skipped only in mode 1 with
//   q_offset >= k_offset, where key tile 0, walked first, is visible to
//   every row.

namespace hopper {

using sm90::kConsumerWarps;
using sm90::kKeys;
using sm90::kLog2e;
using sm90::kRows;
using sm90::QSmem;
using sm90::quad_max;
using sm90::quad_sum;

constexpr int kStages = 4;          // K/V tiles in flight
constexpr int kThreads = 32 * kConsumerWarps + 32;   // + the producer warp
// One CUDA block per work tile, or one per SM walking them (kernel_ab
// ring-persistent): the diagonal hop's tiles differ in weight, and the
// block scheduler balances them better than a fixed stride.
constexpr bool kPersistent = false;

struct Params {
  const float* o_in;
  const float* m_in;
  const float* l_in;
  float* o_out;
  float* m_out;
  float* l_out;
  int batch, s_q, s_k, heads, kv_heads, n_rep, positions, tiles;
  int mask_mode, q_offset, k_offset;
  float scale;
};

__device__ __forceinline__ bool skips(const Params& p) {
  return p.mask_mode == 1 && p.q_offset >= p.k_offset;
}

// Work tile w: the heaviest q tiles first where tiles are skipped, then
// (b, KV head); key tiles [t_lo, t_hi) of kKeys.
struct RingWork {
  int b, kvh, q0, t_lo, t_hi;
  __device__ RingWork(int w, const Params& p) {
    const int groups = p.batch * p.kv_heads;
    const int qt = skips(p) ? p.tiles - 1 - w / groups : w / groups;
    b = (w % groups) / p.kv_heads;
    kvh = w % p.kv_heads;
    q0 = qt * p.positions;
    const int q_last = min(p.s_q, q0 + p.positions) - 1;
    const int k_hi =
        skips(p) ? min(p.s_k, p.q_offset - p.k_offset + q_last + 1) : p.s_k;
    t_lo = 0;
    t_hi = (k_hi + kKeys - 1) / kKeys;
  }
};

// The reference's mask on one scaled score (position `pos` of the q
// chunk, key `c` of the k chunk).
__device__ __forceinline__ float ring_mask(float s, int pos, int c,
                                           const Params& p) {
  if (c >= p.s_k) return neg_inf();
  if (p.mask_mode == 1 && p.k_offset + c > p.q_offset + pos) return kMaskValue;
  return s;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
ring_chunk_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const Params p) {
  // The shared layout's staging tile (o) is left unused: the state goes
  // out from registers in fp32.
  using Smem = QSmem<D, kStages, 1>;
  Smem& sm = sm90::smem_at_1024<Smem>();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_work = p.batch * p.kv_heads * p.tiles;
  sm90::init_q_barriers(sm);

  if (warp == kConsumerWarps) {                 // the producer warp
    if (lane == 0) {
      sm90::produce_q_work<RingWork>(sm, &tq, &tq, &tk, &tv, p, n_work);
    }
    return;
  }

  // Consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile;
  // this thread owns rows lr0 and lr0 + 8 of them, columns 8 j + 2 t4
  // (+1) of the scores and of the D-wide P.V sum.
  const int wg = warp / 4, g = lane / 4, t4 = lane % 4;
  const int lr0 = wg * 64 + (warp % 4) * 16 + g, lr1 = lr0 + 8;
  const unsigned char* q_rows =
      reinterpret_cast<const unsigned char*>(sm.q[0][0]) + wg * 64 * 128;
  const int live_rows = p.positions * p.n_rep;
  float o[D / 2], sacc[kKeys / 2];
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) sacc[i] = 0.f;
  uint32_t pf[kKeys / 16][4];
  int it = 0;                                   // K/V tiles consumed

  for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
    const RingWork wk(w, p);
    // Row lr0 / lr1: position pos[h] of the chunk, query head
    // head_of(h); its state row and o row. Only pos and the incoming m
    // stay live across the key walk.
    const int rows[2] = {lr0, lr1};
    const int pos[2] = {wk.q0 + lr0 / p.n_rep, wk.q0 + lr1 / p.n_rep};
    auto live = [&](int h) { return rows[h] < live_rows && pos[h] < p.s_q; };
    auto state_row = [&](int h) {
      const int head = wk.kvh * p.n_rep + rows[h] % p.n_rep;
      return (static_cast<long long>(wk.b) * p.heads + head) * p.s_q + pos[h];
    };
    auto o_row = [&](int h) {
      const int head = wk.kvh * p.n_rep + rows[h] % p.n_rep;
      return ((static_cast<long long>(wk.b) * p.s_q + pos[h]) * p.heads +
              head) * D;
    };
    float m_in[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_in[h] = live(h) ? p.m_in[state_row(h)] : kMaskValue;
      if (live(h)) {                            // the incoming o, to L2
#pragma unroll
        for (int j = t4; j < D / 8; j += 4) {
          asm volatile("prefetch.global.L2 [%0];\n"
                       :: "l"(p.o_in + o_row(h) + 8 * j));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = m_in[0], m1 = m_in[1], l0 = 0.f, l1 = 0.f;

    auto issue_scores = [&](int s) {
      sm90::issue_ss<D>(sacc, q_rows, sizeof(sm.q[0][0]),
                        reinterpret_cast<const unsigned char*>(sm.k[s][0]),
                        sizeof(sm.k[0][0]));
      sm90::wgmma_commit();
    };
    auto issue_pv = [&](int s) {
      sm90::issue_rs<D>(o, pf,
                        reinterpret_cast<const unsigned char*>(sm.v[s][0]),
                        sizeof(sm.v[0][0]));
      sm90::wgmma_commit();
    };
    // The online softmax of key tile t on sacc: scale, mask, new maxima,
    // p = exp(s - m) left in sacc (fp32), l updated; returns the alphas.
    // A tile no mask touches takes the short form (for a positive scale):
    // the maxima of the raw scores times the scale and exp2 of one FFMA.
    // On a masked tile exp2((s - m) log2 e) is exactly 1 where s = m =
    // -1e30 and exactly 0 where s = -1e30 < m.
    auto softmax = [&](int t, float& alpha0, float& alpha1) {
      const int k0 = t * kKeys;
      const bool edge =
          k0 + kKeys > p.s_k ||
          (p.mask_mode == 1 &&
           p.k_offset + k0 + kKeys - 1 > p.q_offset + wk.q0) ||
          !(p.scale > 0.f);
      float mx0 = neg_inf(), mx1 = neg_inf(), n0, n1;
      if (edge) {
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sacc[4 * j + e] = ring_mask(sacc[4 * j + e] * p.scale,
                                        pos[e / 2],
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
    auto rescale_and_pack = [&](float alpha0, float alpha1) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= alpha0;
        o[4 * j + 1] *= alpha0;
        o[4 * j + 2] *= alpha1;
        o[4 * j + 3] *= alpha1;
      }
      sm90::pack_a(pf, sacc);
    };

    // The flash forward's pipeline; the last tile's P.V is peeled off.
    const int n_tiles = wk.t_hi - wk.t_lo;
    float alpha0, alpha1;
    sm90::mbar_wait(&sm.q_full, n & 1);
    sm90::mbar_wait(&sm.k_full[it % kStages], (it / kStages) & 1);
    sm90::wgmma_fence();
    issue_scores(it % kStages);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sacc);
    if (n_tiles == 1) sm90::warp_arrive(&sm.q_empty);
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
      if (i + 2 == n_tiles) sm90::warp_arrive(&sm.q_empty);
      softmax(wk.t_lo + i + 1, alpha0, alpha1);
      sm90::wgmma_wait<0>();                    // P.V of tile i
      sm90::fence_regs(o);
      sm90::warp_arrive(&sm.empty[s]);
      rescale_and_pack(alpha0, alpha1);
    }
    {
      const int s = it % kStages;
      sm90::mbar_wait(&sm.v_full[s], (it / kStages) & 1);
      sm90::wgmma_fence();
      issue_pv(s);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      sm90::warp_arrive(&sm.empty[s]);
      ++it;
    }

    // The state out: o_in alpha + round(P.V), l_in alpha + l, m. The
    // incoming o was sent to L2 when the tile started; its loads do not
    // alias the stores (restrict), so they issue together.
    const float m_new[2] = {m0, m1}, l_new[2] = {l0, l1};
    const float* __restrict__ o_in = p.o_in;
    float* __restrict__ o_out = p.o_out;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!live(h)) continue;
      const float alpha = expf(m_in[h] - m_new[h]);
      const long long at = o_row(h) + 2 * t4;
      float2 x[D / 8];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        x[j] = *reinterpret_cast<const float2*>(o_in + at + 8 * j);
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(o_out + at + 8 * j) =
            make_float2(
                update_o(x[j].x, alpha, Elt<bf16>::round(o[4 * j + 2 * h])),
                update_o(x[j].y, alpha,
                         Elt<bf16>::round(o[4 * j + 2 * h + 1])));
      }
      if (t4 == 0) {
        const long long sr = state_row(h);
        p.l_out[sr] = __fadd_rn(__fmul_rn(p.l_in[sr], alpha), l_new[h]);
        p.m_out[sr] = m_new[h];
      }
    }
  }
}

template <int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.n_rep > kRows) return cudaErrorInvalidValue;
  Params p;
  p.o_in = a.o_in;
  p.m_in = a.m_in;
  p.l_in = a.l_in;
  p.o_out = a.o_out;
  p.m_out = a.m_out;
  p.l_out = a.l_out;
  p.batch = a.batch;
  p.s_q = a.s_q;
  p.s_k = a.s_k;
  p.heads = a.heads;
  p.kv_heads = a.kv_heads;
  p.n_rep = a.n_rep;
  p.positions = kRows / a.n_rep;
  p.tiles = (a.s_q + p.positions - 1) / p.positions;
  p.mask_mode = a.mask_mode;
  p.q_offset = a.q_offset;
  p.k_offset = a.k_offset;
  p.scale = a.scale;
  // Q in grouped boxes (n_rep heads x positions), K and V one KV head x
  // kKeys keys, each over its strided view.
  CUtensorMap tq, tk, tv;
  if (!sm90::encode_bshd(&tq, a.q, D, a.heads, a.s_q, a.batch, a.q_sh,
                         a.q_ss, a.q_sb, a.n_rep, p.positions) ||
      !sm90::encode_bshd(&tk, a.k, D, a.kv_heads, a.s_k, a.batch, a.k_sh,
                         a.k_ss, a.k_sb, 1, kKeys) ||
      !sm90::encode_bshd(&tv, a.v, D, a.kv_heads, a.s_k, a.batch, a.v_sh,
                         a.v_ss, a.v_sb, 1, kKeys)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(QSmem<D, kStages, 1>) + 1024;   // + alignment
  auto kernel = ring_chunk_wgmma_kernel<D>;
  int grid;
  cudaError_t err = sm90::prepare(kernel, smem,
                                  a.batch * a.kv_heads * p.tiles,
                                  kPersistent, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace hopper

// bf16 at head_dim 64 and 128 takes the wgmma / TMA kernel.
template <typename T, int D>
constexpr bool kUseWgmma = std::is_same<T, __nv_bfloat16>::value && D <= 128;

template <typename T, int D>
cudaError_t launch_typed(const Args& a, cudaStream_t stream) {
  if constexpr (kUseWgmma<T, D>) {
    return hopper::launch<D>(a, stream);
  } else {
    constexpr int kTile = D > 128 ? 32 : 64;
    auto kernel = ring_chunk_kernel<T, D, kTile, kTile>;
    const size_t smem = chunk_smem<T, D, kTile, kTile>();
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<dim3(a.batch * a.heads, (a.s_q + kTile - 1) / kTile), kThreads,
             smem, stream>>>(a);
    return cudaGetLastError();
  }
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
