// Paged-KV attention for Hopper (sm_90a), float and bf16, over float or
// int8 pools.
//
// Replaces the TPU kernels skypilot_tpu/ops/paged_attention.py
// `_decode_kernel` (float pools) and `_decode_kernel_int8` (int8 pools
// with fp32 per-token scale rows), entry `paged_decode_attention`,
// pl.pallas_call at :268: every prefill chunk and decode step of the
// serving path attends through one of them, one launch per layer. The
// fp32 and int8 routes share one template (payload type P = T or
// int8_t); bf16 pools take the two redesigned kernels further down.
//
// What it computes (the TPU kernel's contract): for each batch row b and
// kv head h, the row's T * n_rep grouped query rows (row j = t * n_rep + r
// is query token t of head h * n_rep + r) attend to the row's logical KV
// blocks, each fetched THROUGH the block table (tables[b, i] names the
// physical block of logical block i in the shared (NB, bs, KV, D) pool).
// Scores accumulate in fp32, are scaled by sm_scale, and are masked to
// -1e30 (not -inf) unless k_pos <= q_pos and, with a window,
// q_pos - k_pos < window. An online softmax (m, l, acc in fp32) runs
// across blocks; blocks wholly past the largest query position are
// skipped; the output is acc / max(l, 1e-30) in q's dtype. As on the
// TPU, the probabilities are rounded to the value dtype before the
// P.V product while l sums them unrounded; a fully masked leading block
// (m = -1e30) washes out of the recurrence as soon as a visible block
// follows, because alpha = exp(-1e30 - m_real) is exactly 0 in fp32.
//
// int8 route (the TPU int8 kernel's op order): payloads convert int8 ->
// fp32 exactly on staging (as int8 -> compute dtype is exact); the key's
// scale multiplies its fp32 score BEFORE sm_scale; l sums the unscaled
// p; the value's scale then multiplies p, which rounds to q's dtype for
// the P.V product. Each step also stages its 64 keys' K and V scale rows
// (fp32, one per token and kv head). Masked keys get p = 0 exactly, so
// the scale rows of a stale block (scratch rows start at 1) add 0. An
// int8 row of D 128 is 128 bytes: the same 16-byte vector loads carry 16
// int8 values each instead of 8 bf16.
//
// Translation to Hopper. The TPU walks blocks on a sequential grid axis
// and carries (m, l, acc) in VMEM scratch between grid steps; CUDA blocks
// run in no order, so the block walk is a loop inside one CUDA block over
// 64-key tiles (64 / bs logical blocks, looked up through the table).
// The grid is (B, KV, row tiles x splits). Each row tile skips blocks by
// ITS OWN largest position, so it never skips a block one of its queries
// can see. There is no scalar prefetch: each CUDA block reads its own
// table entries and positions. Three routes, chosen by dtype, head_dim
// and the grouped-row count T * n_rep alone:
// - bf16 prefill (>= 64 grouped rows, head_dim 64 or 128): 64-row tiles
//   on wgmma tensor-core products, K/V gathered in bf16 by cp.async into
//   a 3-stage ring of 128-byte-swizzled tiles (paged_prefill_kernel);
// - bf16 decode (fewer rows, or head_dim 256): CUDA-core products over
//   the same 3-stage bf16 ring, the key axis split by a fixed span of
//   256 keys (paged_decode_bf16_kernel, span_combine_kernel);
// - fp32 and int8 pools: the first design (paged_attention_kernel): K/V
//   staged synchronously as fp32, 4- or 16-row tiles, the key axis split
//   by grid size when the grid is small, fp32 CUDA-core math.
//
// What bounds it on the H100. At decode (T = 1) the work is ~2 FLOPs per
// byte of K/V, far under the card's ~295 FLOP/byte ridge: the bound is
// the bytes of the live K/V blocks over 3.35 TB/s (58 MB at the smoke's
// eight rows). Each live block is read once per (row tile, kv head) and
// no gathered window ever exists in device memory (the plain version
// writes and reads one). A decode step has only B x KV row tiles, so the
// key axis splits: by span, the longest row gets the most CUDA blocks,
// and three stages of 64 keys keep ~64 KB in flight per block; a span of
// 256 keys gives a decode tick of 8 rows at 700 tokens 3 splits a row. At
// prefill (T = 256, n_rep 4: 1024 grouped rows per kv head) the 2.7
// GFLOP of a chunk at 512 bound it by operations, and each gathered tile
// feeds 64 rows of tensor-core products. Under int8 the bytes per live
// token fall from 4 D to 2 D + 8 (payload plus two scale rows).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStepKeys = 64;    // keys staged per loop step
constexpr int kTargetCtas = 528; // ~4 CUDA blocks per SM before splitting
constexpr int kMaxSplits = 16;
constexpr float kMaskValue = -1e30f;

struct Params {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;  // (NB, bs, KV) fp32, int8 route only
  const float* v_scale;
  const int* tables;
  const int* positions;
  void* out;
  float* ws_m;    // (B, KV, splits, total_rows) partial maxima
  float* ws_l;    // (B, KV, splits, total_rows) partial normalisers
  float* ws_acc;  // (B, KV, splits, total_rows, D) partial sums
  int cur_len, num_heads, kv_heads, n_rep, total_rows;
  int block_size, blocks_per_seq, table_stride, splits, split_keys, window;
  float sm_scale;
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}
// `p.astype(v.dtype)` of the TPU kernel: round to the value dtype.
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffff, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffff, v, o);
  return v;
}

int rows_per_tile(int total_rows) { return total_rows <= 4 ? 4 : 16; }

int num_splits(int batch, int kv_heads, int total_rows) {
  const int rows = rows_per_tile(total_rows);
  const int ctas = batch * kv_heads * ((total_rows + rows - 1) / rows);
  int splits = (kTargetCtas + ctas - 1) / ctas;
  return splits < 1 ? 1 : (splits > kMaxSplits ? kMaxSplits : splits);
}

size_t smem_bytes(int head_dim, int rows) {
  const size_t floats = (size_t)rows * (head_dim + 1)        // q tile
                        + (size_t)kStepKeys * (head_dim + 1)  // K (padded)
                        + (size_t)kStepKeys * head_dim        // V
                        + (size_t)rows * kStepKeys            // scores / p
                        + 2 * (size_t)kStepKeys               // K, V scales
                        + 3 * (size_t)rows;                   // m, l, alpha
  return floats * sizeof(float) + (size_t)(rows + kStepKeys) * sizeof(int);
}

// Stage `kStepKeys` keys of one pool (K or V) for kv head h into shared
// memory as fp32 with row stride `ld`; absent tokens (phys < 0) read 0.
template <typename T, int D>
__device__ __forceinline__ void stage(const T* __restrict__ pool,
                                      const int* phys_s, int block_size,
                                      int kv_heads, int h, float* dst,
                                      int ld) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kRowChunks = D / kVec;
  constexpr int kPerThread = kStepKeys * kRowChunks / kThreads;
  uint4 raw[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int t = c / kRowChunks, d0 = (c % kRowChunks) * kVec;
    const int blk = phys_s[t / block_size];
    raw[i] = make_uint4(0, 0, 0, 0);
    if (blk >= 0) {
      const size_t off =
          (((size_t)blk * block_size + t % block_size) * kv_heads + h) * D + d0;
      raw[i] = *reinterpret_cast<const uint4*>(pool + off);
    }
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int t = c / kRowChunks, d0 = (c % kRowChunks) * kVec;
    const T* vals = reinterpret_cast<const T*>(&raw[i]);
#pragma unroll
    for (int u = 0; u < kVec; ++u) dst[t * ld + d0 + u] = to_float(vals[u]);
  }
}

// T: q / out (compute) dtype; P: pool payload, T or int8_t (scaled).
template <typename T, typename P, int D, int ROWS>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(Params p) {
  constexpr int kPer = ROWS * D / kThreads;  // acc elements per thread
  constexpr int kHalfRows = ROWS / 2;        // rows per thread in QK^T
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  static_assert(ROWS * D % kThreads == 0, "tile must divide the threads");
  static_assert(2 * kStepKeys == kThreads, "QK^T maps 2 threads per key");

  const T* q = static_cast<const T*>(p.q);
  const P* k_pool = static_cast<const P*>(p.k_pool);
  const P* v_pool = static_cast<const P*>(p.v_pool);
  const int b = blockIdx.x, h = blockIdx.y;
  const int tile = blockIdx.z / p.splits, split = blockIdx.z % p.splits;
  const int row0 = tile * ROWS;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  extern __shared__ float smem[];
  float* qs = smem;                              // ROWS x (D + 1)
  float* ks = qs + ROWS * (D + 1);               // kStepKeys x (D + 1)
  float* vs = ks + kStepKeys * (D + 1);          // kStepKeys x D
  float* ss = vs + kStepKeys * D;                // ROWS x kStepKeys
  float* ksc = ss + ROWS * kStepKeys;            // kStepKeys K scales
  float* vsc = ksc + kStepKeys;                  // kStepKeys V scales
  float* m_s = vsc + kStepKeys;                  // ROWS
  float* l_s = m_s + ROWS;                       // ROWS
  float* alpha_s = l_s + ROWS;                   // ROWS
  int* qpos_s = reinterpret_cast<int*>(alpha_s + ROWS);  // ROWS
  int* phys_s = qpos_s + ROWS;                   // kStepKeys

  if (tid < ROWS) {
    const int j = row0 + tid;
    qpos_s[tid] = j < p.total_rows ? p.positions[b * p.cur_len + j / p.n_rep]
                                   : -1;
    m_s[tid] = neg_inf();
    l_s[tid] = 0.f;
  }
  // Query tile, regrouped kv-head-major on the fly: row j is token
  // j / n_rep of head h * n_rep + j % n_rep.
  for (int e = tid; e < ROWS * D; e += kThreads) {
    const int r = e / D, c = e % D, j = row0 + r;
    float val = 0.f;
    if (j < p.total_rows) {
      const int t = j / p.n_rep, head = h * p.n_rep + j % p.n_rep;
      val = to_float(q[(((size_t)b * p.cur_len + t) * p.num_heads + head) * D + c]);
    }
    qs[r * (D + 1) + c] = val;
  }
  __syncthreads();

  // Blocks past this tile's largest query position are skipped; the live
  // keys split evenly (in whole steps) across the `splits` CUDA blocks.
  int max_pos = 0;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) max_pos = max(max_pos, qpos_s[r]);
  const int num_blocks = min(p.blocks_per_seq, max_pos / p.block_size + 1);
  const int live_keys = num_blocks * p.block_size;
  const int steps = (live_keys + kStepKeys - 1) / kStepKeys;
  const int steps_per_split = (steps + p.splits - 1) / p.splits;
  const int key_lo = split * steps_per_split * kStepKeys;
  const int key_hi = min(live_keys, key_lo + steps_per_split * kStepKeys);
  const int blocks_per_step = kStepKeys / p.block_size;

  float acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) acc[k] = 0.f;

  for (int k0 = key_lo; k0 < key_hi; k0 += kStepKeys) {
    __syncthreads();  // previous step's tiles fully consumed
    if (tid < blocks_per_step) {
      const int lb = k0 / p.block_size + tid;
      phys_s[tid] = lb < num_blocks
                        ? p.tables[(size_t)b * p.table_stride + lb] : -1;
    }
    __syncthreads();
    stage<P, D>(k_pool, phys_s, p.block_size, p.kv_heads, h, ks, D + 1);
    stage<P, D>(v_pool, phys_s, p.block_size, p.kv_heads, h, vs, D);
    if constexpr (kQuant) {
      if (tid < kStepKeys) {
        const int blk = phys_s[tid / p.block_size];
        const size_t row =
            ((size_t)blk * p.block_size + tid % p.block_size) * p.kv_heads + h;
        ksc[tid] = blk >= 0 ? p.k_scale[row] : 1.f;
        vsc[tid] = blk >= 0 ? p.v_scale[row] : 1.f;
      }
    }
    __syncthreads();

    // Scores: thread (key, half) dots one key against half the rows.
    {
      const int key = tid % kStepKeys, r0 = (tid / kStepKeys) * kHalfRows;
      const float* kr = ks + key * (D + 1);
      float dots[kHalfRows];
#pragma unroll
      for (int r = 0; r < kHalfRows; ++r) dots[r] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float kd = kr[d];
#pragma unroll
        for (int r = 0; r < kHalfRows; ++r)
          dots[r] += qs[(r0 + r) * (D + 1) + d] * kd;
      }
      const int k_pos = k0 + key;
      const bool present = k_pos < live_keys;
      if constexpr (kQuant) {
        // The K scale factors out of the head_dim sum: scores * scale,
        // then * sm_scale below, as the TPU int8 kernel orders them.
#pragma unroll
        for (int r = 0; r < kHalfRows; ++r) dots[r] *= ksc[key];
      }
#pragma unroll
      for (int r = 0; r < kHalfRows; ++r) {
        const int q_pos = qpos_s[r0 + r];
        bool keep = k_pos <= q_pos;
        if (p.window) keep = keep && (q_pos - k_pos < p.window);
        // Absent keys (past the live blocks) do not exist: -inf gives
        // them exactly zero weight; masked keys get the TPU's -1e30.
        ss[(r0 + r) * kStepKeys + key] =
            present ? (keep ? dots[r] * p.sm_scale : kMaskValue) : neg_inf();
      }
    }
    __syncthreads();

    // Online softmax update: one warp per query row, two keys per lane.
    for (int r = warp; r < ROWS; r += kWarps) {
      float* sr = ss + r * kStepKeys;
      const float s0 = sr[lane], s1 = sr[lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float sum = warp_sum(p0 + p1);
      if constexpr (kQuant) {
        // l sums p unscaled; p * V scale rounds to the compute dtype.
        sr[lane] = round_to(p0 * vsc[lane], q);
        sr[lane + 32] = round_to(p1 * vsc[lane + 32], q);
      } else {
        sr[lane] = round_to(p0, v_pool);
        sr[lane + 32] = round_to(p1, v_pool);
      }
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ V for this thread's (row, column) slice.
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = tid + k * kThreads;
      const int r = e / D, c = e % D;
      const float* pr = ss + r * kStepKeys;
      float pv = 0.f;
#pragma unroll 8
      for (int key = 0; key < kStepKeys; ++key) pv += pr[key] * vs[key * D + c];
      acc[k] = acc[k] * alpha_s[r] + pv;
    }
  }
  __syncthreads();

  T* out = static_cast<T*>(p.out);
  const size_t part = ((size_t)(b * p.kv_heads + h) * p.splits + split) *
                      p.total_rows;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = tid + k * kThreads;
    const int r = e / D, c = e % D, j = row0 + r;
    if (j >= p.total_rows) continue;
    if (p.splits == 1) {
      const int t = j / p.n_rep, head = h * p.n_rep + j % p.n_rep;
      store(acc[k] / fmaxf(l_s[r], 1e-30f),
            out + (((size_t)b * p.cur_len + t) * p.num_heads + head) * D + c);
    } else {
      p.ws_acc[(part + j) * D + c] = acc[k];
    }
  }
  if (p.splits > 1 && tid < ROWS && row0 + tid < p.total_rows) {
    p.ws_m[part + row0 + tid] = m_s[tid];
    p.ws_l[part + row0 + tid] = l_s[tid];
  }
}

// Merge the splits of one (b, kv head, query row): the same online-softmax
// rescaling, across splits instead of blocks. A split that saw no live key
// has m = -inf and weighs exactly 0.
template <typename T, int D>
__global__ void __launch_bounds__(D) combine_kernel(Params p) {
  const int bh = blockIdx.x, j = blockIdx.y, c = threadIdx.x;
  const int b = bh / p.kv_heads, h = bh % p.kv_heads;
  const size_t base = (size_t)bh * p.splits;
  float m_star = neg_inf();
  for (int s = 0; s < p.splits; ++s)
    m_star = fmaxf(m_star, p.ws_m[(base + s) * p.total_rows + j]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < p.splits; ++s) {
    const size_t idx = (base + s) * p.total_rows + j;
    const float w = expf(p.ws_m[idx] - m_star);
    l += p.ws_l[idx] * w;
    acc += p.ws_acc[idx * D + c] * w;
  }
  const int t = j / p.n_rep, head = h * p.n_rep + j % p.n_rep;
  store(acc / fmaxf(l, 1e-30f),
        static_cast<T*>(p.out) +
            (((size_t)b * p.cur_len + t) * p.num_heads + head) * D + c);
}

// ------------------------------------------- bf16 routes, redesigned
//
// Grouped rows, T * n_rep of them per (b, kv head), pick the route:
// at or above kPrefillRows (64: one full wgmma tile; the serve path's
// prefill chunk sends 1024) and head_dim <= 128, the tensor-core prefill
// kernel; below it (a decode step is T 1: n_rep rows), and at head_dim
// 256, the CUDA-core decode kernel. Both gather K/V in bf16 through the
// table with cp.async 16-byte copies (each token's row for one kv head is
// D * 2 contiguous bytes) into a ring of stages (3 at decode, 4 at
// prefill), so the next tiles' pages are in flight while this tile
// computes; table entries below 0 and blocks past the tile's live keys
// read zeros (never a byte).

constexpr int kPrefillRows = 64;   // grouped rows that take the prefill route
constexpr int kSplitKeys = 256;    // key span of one decode split
constexpr int kRing = 3;           // cp.async stages
constexpr int kNoSplit = 1 << 30;  // split_keys when the key axis is whole
constexpr float kLog2e = 1.4426950408889634f;
using bf16 = __nv_bfloat16;

// Live keys of the row tile [row0, row0 + rows): whole blocks up to its
// largest position.
__device__ __forceinline__ int tile_live_keys(const Params& p, int b,
                                              int row0, int rows) {
  int max_pos = 0;
  for (int r = 0; r < rows; ++r) {
    const int j = row0 + r;
    if (j < p.total_rows) {
      max_pos = max(max_pos, p.positions[b * p.cur_len + j / p.n_rep]);
    }
  }
  return min(p.blocks_per_seq, max_pos / p.block_size + 1) * p.block_size;
}

using sm90::quad_max;
using sm90::quad_sum;

// Pool offset of 16-byte chunk `ch` of key k_pos's row (kv head h), or
// -1 past the live keys or for a table entry below 0 (read as zeros).
// `blocks` holds the row's table entries from logical block lb0 on.
__device__ __forceinline__ long long kv_chunk(const Params& p,
                                              const int* blocks, int lb0,
                                              int h, int k_pos,
                                              int live_keys, int ch,
                                              int head_dim) {
  const int blk = k_pos < live_keys ? blocks[k_pos / p.block_size - lb0] : -1;
  if (blk < 0) return -1;
  return (((long long)blk * p.block_size + k_pos % p.block_size) *
              p.kv_heads + h) * head_dim + ch * 8;
}

// ---- prefill route: one warpgroup, 64 grouped rows, wgmma products.
//
// S = Q.K^T as wgmma m64n64k16 (Q and the gathered K both K-major in
// 128-byte-swizzled shared memory), P.V as m64nDk16 with P in registers
// and V read through the transpose bit; the softmax runs in registers in
// the first design's op order. The walk starts at the first 64-key tile
// the tile's smallest position can see (window) and stops at its live
// keys: a skipped tile adds exactly 0 once a visible key has been seen.
// The row's table entries for the walk are staged in shared memory once,
// so a copy's address never waits on a global load; the ring runs
// kPrefillRing - 1 tiles ahead, and the scores of tile i + 1 are issued
// with tile i's P.V, so their softmax overlaps P.V on the tensor cores.

constexpr int kPrefillRing = 4;

template <int D>
struct PrefillSmem {
  static constexpr int kChunks = D / 64;
  alignas(1024) bf16 q[kChunks][kPrefillRows * 64];
  alignas(1024) bf16 k[kPrefillRing][kChunks][kStepKeys * 64];
  alignas(1024) bf16 v[kPrefillRing][kChunks][kStepKeys * 64];
  int qpos[kPrefillRows];
};

// Shared memory of one prefill block: the tiles, then one table entry
// per logical block of the row.
template <int D>
size_t prefill_smem(int blocks_per_seq) {
  return sizeof(PrefillSmem<D>) + 1024 + (size_t)blocks_per_seq * sizeof(int);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(Params p) {
  constexpr int kRowChunks = D / 8;
  constexpr int kCopies = kStepKeys * kRowChunks / kThreads;
  extern __shared__ unsigned char smem_raw[];
  PrefillSmem<D>& sm = *reinterpret_cast<PrefillSmem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int* blocks = reinterpret_cast<int*>(&sm + 1);
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k_pool = static_cast<const bf16*>(p.k_pool);
  const bf16* v_pool = static_cast<const bf16*>(p.v_pool);
  const int b = blockIdx.x, h = blockIdx.y, row0 = blockIdx.z * kPrefillRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid < kPrefillRows) {
    const int j = row0 + tid;
    sm.qpos[tid] = j < p.total_rows
                       ? p.positions[b * p.cur_len + j / p.n_rep] : -1;
  }
  __syncthreads();
  int max_pos = 0, min_pos = 1 << 30;
  for (int r = 0; r < kPrefillRows; ++r) {
    const int pos = sm.qpos[r];
    if (pos >= 0) {
      max_pos = max(max_pos, pos);
      min_pos = min(min_pos, pos);
    }
  }
  const int live_keys =
      min(p.blocks_per_seq, max_pos / p.block_size + 1) * p.block_size;
  const int first =
      p.window > 0 ? max(0, min_pos - p.window + 1) / kStepKeys * kStepKeys : 0;
  const int n_tiles = (live_keys - first + kStepKeys - 1) / kStepKeys;
  const int lb0 = first / p.block_size;
  for (int i = tid; i < live_keys / p.block_size - lb0; i += kThreads) {
    blocks[i] = p.tables[(size_t)b * p.table_stride + lb0 + i];
  }
  __syncthreads();

  // The query tile, regrouped kv-head-major on the way: row j is token
  // j / n_rep of head h * n_rep + j % n_rep.
  for (int c = tid; c < kPrefillRows * kRowChunks; c += kThreads) {
    const int r = c / kRowChunks, ch = c % kRowChunks, j = row0 + r;
    const bool ok = j < p.total_rows;
    const size_t off =
        ok ? (((size_t)b * p.cur_len + j / p.n_rep) * p.num_heads +
              h * p.n_rep + j % p.n_rep) * D + ch * 8
           : 0;
    sm90::cp_async16(reinterpret_cast<unsigned char*>(sm.q[ch / 8]) +
                         sm90::swizzled(r, ch % 8),
                     q + off, ok);
  }
  auto issue = [&](int i) {
    if (i < n_tiles) {
      const int k0 = first + i * kStepKeys, st = i % kPrefillRing;
#pragma unroll
      for (int u = 0; u < kCopies; ++u) {
        const int c = tid + u * kThreads;
        const int key = c / kRowChunks, ch = c % kRowChunks;
        const long long off =
            kv_chunk(p, blocks, lb0, h, k0 + key, live_keys, ch, D);
        const uint32_t at = sm90::swizzled(key, ch % 8);
        sm90::cp_async16(
            reinterpret_cast<unsigned char*>(sm.k[st][ch / 8]) + at,
            k_pool + (off < 0 ? 0 : off), off >= 0);
        sm90::cp_async16(
            reinterpret_cast<unsigned char*>(sm.v[st][ch / 8]) + at,
            v_pool + (off < 0 ? 0 : off), off >= 0);
      }
    }
    sm90::cp_async_commit();
  };
  for (int i = 0; i < kPrefillRing - 1; ++i) issue(i);   // Q rides with 0

  const int g = lane / 4, t4 = lane % 4;
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;
  const int pos0 = sm.qpos[lr0], pos1 = sm.qpos[lr1];
  float o[D / 2], sacc[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
  float m0 = neg_inf(), m1 = neg_inf(), l0 = 0.f, l1 = 0.f;
  uint32_t pf[4][4];
  const unsigned char* q_rows = reinterpret_cast<const unsigned char*>(sm.q[0]);

  auto issue_scores = [&](int st) {
    const unsigned char* k_rows =
        reinterpret_cast<const unsigned char*>(sm.k[st][0]);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int qoff = (kk / 4) * (int)sizeof(sm.q[0]) + (kk % 4) * 32;
      const int koff = (kk / 4) * (int)sizeof(sm.k[0][0]) + (kk % 4) * 32;
      sm90::wgmma_m64n64_ss(sacc, sm90::desc_sw128(q_rows + qoff, 16, 1024),
                            sm90::desc_sw128(k_rows + koff, 16, 1024),
                            kk > 0);
    }
    sm90::wgmma_commit();
  };
  auto issue_pv = [&](int st) {
    const unsigned char* v_rows =
        reinterpret_cast<const unsigned char*>(sm.v[st][0]);
#pragma unroll
    for (int kk = 0; kk < kStepKeys / 16; ++kk) {
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
  // Scale, mask (absent keys -inf, masked -1e30), online softmax; p left
  // in sacc. A tile no mask touches takes the short form: maxima of the
  // raw scores times the (positive) scale, exp2 of one FFMA.
  auto softmax = [&](int i, float& alpha0, float& alpha1) {
    const int k0 = first + i * kStepKeys;
    const bool edge = k0 + kStepKeys > live_keys ||
                      k0 + kStepKeys - 1 > min_pos ||
                      (p.window > 0 && max_pos - k0 >= p.window) ||
                      !(p.sm_scale > 0.f);
    float mx0 = neg_inf(), mx1 = neg_inf(), n0, n1;
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k_pos = k0 + 8 * j + 2 * t4 + (e & 1);
          const int q_pos = e < 2 ? pos0 : pos1;
          bool keep = k_pos <= q_pos;
          if (p.window) keep = keep && (q_pos - k_pos < p.window);
          sacc[4 * j + e] =
              k_pos < live_keys
                  ? (keep ? sacc[4 * j + e] * p.sm_scale : kMaskValue)
                  : neg_inf();
        }
        mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
      }
      n0 = fmaxf(m0, quad_max(mx0));
      n1 = fmaxf(m1, quad_max(mx1));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sacc[4 * j] = sm90::exp2_approx((sacc[4 * j] - n0) * kLog2e);
        sacc[4 * j + 1] = sm90::exp2_approx((sacc[4 * j + 1] - n0) * kLog2e);
        sacc[4 * j + 2] = sm90::exp2_approx((sacc[4 * j + 2] - n1) * kLog2e);
        sacc[4 * j + 3] = sm90::exp2_approx((sacc[4 * j + 3] - n1) * kLog2e);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
      }
      n0 = fmaxf(m0, quad_max(mx0) * p.sm_scale);
      n1 = fmaxf(m1, quad_max(mx1) * p.sm_scale);
      const float c = p.sm_scale * kLog2e, b0 = n0 * kLog2e, b1 = n1 * kLog2e;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
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
    for (int j = 0; j < 8; ++j) {
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
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pf[j / 2][(j % 2) * 2] = sm90::pack_bf16(sacc[4 * j], sacc[4 * j + 1]);
      pf[j / 2][(j % 2) * 2 + 1] =
          sm90::pack_bf16(sacc[4 * j + 2], sacc[4 * j + 3]);
    }
  };
  // Tiles up to `i` landed and visible to every thread's wgmma.
  auto landed = [&]() {
    sm90::fence_async_shared();
    __syncthreads();
  };

  float alpha0, alpha1;
  sm90::cp_async_wait<kPrefillRing - 2>();      // Q and tile 0
  landed();
  sm90::wgmma_fence();
  issue_scores(0);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(sacc);
  softmax(0, alpha0, alpha1);
  rescale_and_pack(alpha0, alpha1);
  for (int i = 0; i + 1 < n_tiles; ++i) {
    sm90::cp_async_wait<kPrefillRing - 3>();    // tile i + 1
    landed();                                   // ... and tile i - 1 read
    issue(i + kPrefillRing - 1);
    sm90::wgmma_fence();
    issue_scores((i + 1) % kPrefillRing);
    issue_pv(i % kPrefillRing);
    sm90::wgmma_wait<1>();
    sm90::fence_regs(sacc);
    softmax(i + 1, alpha0, alpha1);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    rescale_and_pack(alpha0, alpha1);
  }
  sm90::wgmma_fence();
  issue_pv((n_tiles - 1) % kPrefillRing);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(o);
  sm90::cp_async_wait<0>();             // no copy outlives the block

  bf16* out = static_cast<bf16*>(p.out);
  const int rows[2] = {lr0, lr1};
  const float ls[2] = {fmaxf(l0, 1e-30f), fmaxf(l1, 1e-30f)};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int j = row0 + rows[hh];
    if (j >= p.total_rows) continue;
    bf16* row = out + (((size_t)b * p.cur_len + j / p.n_rep) * p.num_heads +
                       h * p.n_rep + j % p.n_rep) * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      *reinterpret_cast<uint32_t*>(row + 8 * jj + 2 * t4) = sm90::pack_bf16(
          o[4 * jj + 2 * hh] / ls[hh], o[4 * jj + 2 * hh + 1] / ls[hh]);
    }
  }
}

// ---- decode route: CUDA cores, key-span splits, a cp.async ring.
//
// The key axis splits by a fixed span of kSplitKeys keys (the grid's
// split extent is blocks_per_seq * block_size / kSplitKeys, known on the
// host), so the longest row gets the most CUDA blocks and a block past
// its tile's live keys exits at once. A tile whose live keys fit one
// span writes its output directly; otherwise each split writes (m, l,
// acc) and span_combine_kernel merges the live splits in order (no
// atomics: reruns are bit-identical). Staged rows are bf16 padded by 16
// bytes, so the score loop's 16-byte reads of 8 neighbouring keys fall
// in distinct banks.

template <int D, int ROWS>
size_t decode_smem(int blocks_per_seq) {
  return (size_t)ROWS * D * sizeof(float)                    // q
         + 2 * (size_t)kRing * kStepKeys * (D + 8) * 2       // K, V ring
         + (size_t)ROWS * kStepKeys * sizeof(float)          // scores / p
         + 4 * (size_t)ROWS * sizeof(float)                  // m, l, alpha, pos
         + (size_t)blocks_per_seq * sizeof(int);             // table entries
}

template <int D, int ROWS>
__global__ void __launch_bounds__(kThreads)
paged_decode_bf16_kernel(Params p) {
  constexpr int kLd = D + 8, kRowChunks = D / 8;
  constexpr int kCopies = kStepKeys * kRowChunks / kThreads;
  constexpr int kHalf = ROWS / 2;              // rows per thread in QK^T
  constexpr int kGroups = 2 * kThreads / D;    // row groups in P.V
  constexpr int kRowsPer = ROWS / kGroups;     // rows per thread in P.V
  static_assert(ROWS % kGroups == 0, "P.V rows must divide the groups");
  extern __shared__ __align__(16) unsigned char stage_smem[];
  float* qs = reinterpret_cast<float*>(stage_smem);          // ROWS x D
  bf16* ks = reinterpret_cast<bf16*>(qs + ROWS * D);         // ring x 64 x kLd
  bf16* vs = ks + kRing * kStepKeys * kLd;
  float* ss = reinterpret_cast<float*>(vs + kRing * kStepKeys * kLd);
  float* m_s = ss + ROWS * kStepKeys;
  float* l_s = m_s + ROWS;
  float* alpha_s = l_s + ROWS;
  int* qpos_s = reinterpret_cast<int*>(alpha_s + ROWS);

  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k_pool = static_cast<const bf16*>(p.k_pool);
  const bf16* v_pool = static_cast<const bf16*>(p.v_pool);
  const int b = blockIdx.x, h = blockIdx.y;
  const int tile = blockIdx.z / p.splits, split = blockIdx.z % p.splits;
  const int row0 = tile * ROWS;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  const int live_keys = tile_live_keys(p, b, row0, ROWS);
  const int live_splits = (live_keys + p.split_keys - 1) / p.split_keys;
  if (split >= live_splits) return;             // past the live keys
  const int key_lo = split * p.split_keys;
  const int key_hi = min(live_keys, key_lo + p.split_keys);
  const int n_tiles = (key_hi - key_lo + kStepKeys - 1) / kStepKeys;
  // The split's table entries, staged once: no copy waits on a load.
  int* blocks = qpos_s + ROWS;
  const int lb0 = key_lo / p.block_size;
  for (int i = tid; i < key_hi / p.block_size - lb0; i += kThreads) {
    blocks[i] = p.tables[(size_t)b * p.table_stride + lb0 + i];
  }
  __syncthreads();

  // 16-byte chunks of the tile's K and V rows (kv_chunk).
  auto issue = [&](int i) {
    if (i < n_tiles) {
      const int k0 = key_lo + i * kStepKeys, st = i % kRing;
#pragma unroll
      for (int u = 0; u < kCopies; ++u) {
        const int c = tid + u * kThreads;
        const int key = c / kRowChunks, ch = c % kRowChunks;
        const long long off =
            kv_chunk(p, blocks, lb0, h, k0 + key, live_keys, ch, D);
        const int at = (st * kStepKeys + key) * kLd + ch * 8;
        sm90::cp_async16(ks + at, k_pool + (off < 0 ? 0 : off), off >= 0);
        sm90::cp_async16(vs + at, v_pool + (off < 0 ? 0 : off), off >= 0);
      }
    }
    sm90::cp_async_commit();
  };
  for (int i = 0; i < kRing - 1; ++i) issue(i);

  if (tid < ROWS) {
    const int j = row0 + tid;
    qpos_s[tid] = j < p.total_rows ? p.positions[b * p.cur_len + j / p.n_rep]
                                   : -1;
    m_s[tid] = neg_inf();
    l_s[tid] = 0.f;
  }
  for (int e = tid; e < ROWS * D; e += kThreads) {
    const int r = e / D, c = e % D, j = row0 + r;
    float val = 0.f;
    if (j < p.total_rows) {
      val = __bfloat162float(q[(((size_t)b * p.cur_len + j / p.n_rep) *
                                    p.num_heads + h * p.n_rep + j % p.n_rep) *
                                   D + c]);
    }
    qs[e] = val;
  }

  const int cp = tid % (D / 2), rg = tid / (D / 2);   // P.V: column pair
  float acc[kRowsPer][2];
#pragma unroll
  for (int r = 0; r < kRowsPer; ++r) acc[r][0] = acc[r][1] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    sm90::cp_async_wait<kRing - 2>();
    __syncthreads();                 // tile i landed; tile i - 1 consumed
    issue(i + kRing - 1);
    const int k0 = key_lo + i * kStepKeys;
    const bf16* kt = ks + (i % kRing) * kStepKeys * kLd;
    const bf16* vt = vs + (i % kRing) * kStepKeys * kLd;

    // Scores: thread (key, half) dots one key against half the rows.
    {
      const int key = tid % kStepKeys, r0 = (tid / kStepKeys) * kHalf;
      const bf16* kr = kt + key * kLd;
      float dots[kHalf];
#pragma unroll
      for (int r = 0; r < kHalf; ++r) dots[r] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + d);
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
        float kf[8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 f = __bfloat1622float2(k2[u]);
          kf[2 * u] = f.x;
          kf[2 * u + 1] = f.y;
        }
#pragma unroll
        for (int r = 0; r < kHalf; ++r) {
          const float4 qa = *reinterpret_cast<const float4*>(qs + (r0 + r) * D + d);
          const float4 qb = *reinterpret_cast<const float4*>(qs + (r0 + r) * D + d + 4);
          float s = dots[r];
          s = fmaf(qa.x, kf[0], s);
          s = fmaf(qa.y, kf[1], s);
          s = fmaf(qa.z, kf[2], s);
          s = fmaf(qa.w, kf[3], s);
          s = fmaf(qb.x, kf[4], s);
          s = fmaf(qb.y, kf[5], s);
          s = fmaf(qb.z, kf[6], s);
          s = fmaf(qb.w, kf[7], s);
          dots[r] = s;
        }
      }
      const int k_pos = k0 + key;
      const bool present = k_pos < live_keys;
#pragma unroll
      for (int r = 0; r < kHalf; ++r) {
        const int q_pos = qpos_s[r0 + r];
        bool keep = k_pos <= q_pos;
        if (p.window) keep = keep && (q_pos - k_pos < p.window);
        ss[(r0 + r) * kStepKeys + key] =
            present ? (keep ? dots[r] * p.sm_scale : kMaskValue) : neg_inf();
      }
    }
    __syncthreads();

    // Online softmax update: one warp per query row, two keys per lane.
    for (int r = warp; r < ROWS; r += kWarps) {
      float* sr = ss + r * kStepKeys;
      const float s0 = sr[lane], s1 = sr[lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = exp2f((s0 - m_new) * kLog2e);
      const float p1 = exp2f((s1 - m_new) * kLog2e);
      const float sum = warp_sum(p0 + p1);
      sr[lane] = round_to(p0, v_pool);
      sr[lane + 32] = round_to(p1, v_pool);
      if (lane == 0) {
        const float alpha = exp2f((m_prev - m_new) * kLog2e);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ V for this thread's rows and column pair.
#pragma unroll
    for (int rr = 0; rr < kRowsPer; ++rr) {
      const int r = rg + rr * kGroups;
      const float* pr = ss + r * kStepKeys;
      float pv0 = 0.f, pv1 = 0.f;
#pragma unroll 8
      for (int key = 0; key < kStepKeys; ++key) {
        const float2 v2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(vt + key * kLd + 2 * cp));
        pv0 = fmaf(pr[key], v2.x, pv0);
        pv1 = fmaf(pr[key], v2.y, pv1);
      }
      const float alpha = alpha_s[r];
      acc[rr][0] = acc[rr][0] * alpha + pv0;
      acc[rr][1] = acc[rr][1] * alpha + pv1;
    }
  }
  sm90::cp_async_wait<0>();

  const size_t part = ((size_t)(b * p.kv_heads + h) * p.splits + split) *
                      p.total_rows;
#pragma unroll
  for (int rr = 0; rr < kRowsPer; ++rr) {
    const int r = rg + rr * kGroups, j = row0 + r;
    if (j >= p.total_rows) continue;
    if (live_splits == 1) {
      const float l = fmaxf(l_s[r], 1e-30f);
      bf16* dst = static_cast<bf16*>(p.out) +
                  (((size_t)b * p.cur_len + j / p.n_rep) * p.num_heads +
                   h * p.n_rep + j % p.n_rep) * D + 2 * cp;
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(acc[rr][0] / l, acc[rr][1] / l);
    } else {
      *reinterpret_cast<float2*>(p.ws_acc + (part + j) * D + 2 * cp) =
          make_float2(acc[rr][0], acc[rr][1]);
    }
  }
  if (live_splits > 1 && tid < ROWS && row0 + tid < p.total_rows) {
    p.ws_m[part + row0 + tid] = m_s[tid];
    p.ws_l[part + row0 + tid] = l_s[tid];
  }
}

// Merge one (b, kv head, row)'s live splits in order; a row whose tile
// fits one span was written by its split already.
template <int D, int ROWS>
__global__ void __launch_bounds__(D) span_combine_kernel(Params p) {
  const int bh = blockIdx.x, j = blockIdx.y, c = threadIdx.x;
  const int b = bh / p.kv_heads, h = bh % p.kv_heads;
  const int live_keys = tile_live_keys(p, b, j / ROWS * ROWS, ROWS);
  const int live_splits = (live_keys + p.split_keys - 1) / p.split_keys;
  if (live_splits == 1) return;
  const size_t base = (size_t)bh * p.splits;
  float m_star = neg_inf();
  for (int s = 0; s < live_splits; ++s)
    m_star = fmaxf(m_star, p.ws_m[(base + s) * p.total_rows + j]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < live_splits; ++s) {
    const size_t idx = (base + s) * p.total_rows + j;
    const float w = exp2f((p.ws_m[idx] - m_star) * kLog2e);
    l += p.ws_l[idx] * w;
    acc += p.ws_acc[idx * D + c] * w;
  }
  store(acc / fmaxf(l, 1e-30f),
        static_cast<bf16*>(p.out) +
            (((size_t)b * p.cur_len + j / p.n_rep) * p.num_heads +
             h * p.n_rep + j % p.n_rep) * D + c);
}

enum Route { kFirst, kPrefill, kDecode };

// The route depends only on dtype, head_dim and the grouped-row count.
Route route_of(int dtype, bool quant, int head_dim, int total_rows) {
  if (dtype != 1 || quant) return kFirst;   // fp32 and int8: first design
  return head_dim <= 128 && total_rows >= kPrefillRows ? kPrefill : kDecode;
}

int splits_of(Route route, int batch, int kv_heads, int total_rows,
              int blocks_per_seq, int block_size) {
  if (route == kFirst) return num_splits(batch, kv_heads, total_rows);
  if (route == kPrefill || total_rows >= kPrefillRows) return 1;
  return (blocks_per_seq * block_size + kSplitKeys - 1) / kSplitKeys;
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, typename P, int D, int ROWS>
int launch_first(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, ROWS);
  auto kernel = paged_attention_kernel<T, P, D, ROWS>;
  cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (p.total_rows + ROWS - 1) / ROWS;
  kernel<<<dim3(batch, p.kv_heads, tiles * p.splits), kThreads, smem,
           stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  combine_kernel<T, D><<<dim3(batch * p.kv_heads, p.total_rows), D, 0,
                         stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_prefill(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = prefill_smem<D>(p.blocks_per_seq);
  auto kernel = paged_prefill_kernel<D>;
  cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (p.total_rows + kPrefillRows - 1) / kPrefillRows;
  kernel<<<dim3(batch, p.kv_heads, tiles), kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D, int ROWS>
int launch_decode(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = decode_smem<D, ROWS>(p.blocks_per_seq);
  auto kernel = paged_decode_bf16_kernel<D, ROWS>;
  cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (p.total_rows + ROWS - 1) / ROWS;
  kernel<<<dim3(batch, p.kv_heads, tiles * p.splits), kThreads, smem,
           stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  span_combine_kernel<D, ROWS><<<dim3(batch * p.kv_heads, p.total_rows), D,
                                 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, typename P, int D>
int dispatch_rows(Route route, const Params& p, int batch,
                  cudaStream_t stream) {
  const bool small = rows_per_tile(p.total_rows) == 4;
  if constexpr (std::is_same<T, bf16>::value && std::is_same<P, bf16>::value) {
    if (route == kPrefill) {
      if constexpr (D <= 128) return launch_prefill<D>(p, batch, stream);
      return (int)cudaErrorInvalidValue;
    }
    return small ? launch_decode<D, 4>(p, batch, stream)
                 : launch_decode<D, 16>(p, batch, stream);
  } else {
    return small ? launch_first<T, P, D, 4>(p, batch, stream)
                 : launch_first<T, P, D, 16>(p, batch, stream);
  }
}

template <typename T, typename P>
int dispatch_dim(Route route, int head_dim, const Params& p, int batch,
                 cudaStream_t stream) {
  switch (head_dim) {
    case 64: return dispatch_rows<T, P, 64>(route, p, batch, stream);
    case 128: return dispatch_rows<T, P, 128>(route, p, batch, stream);
    case 256: return dispatch_rows<T, P, 256>(route, p, batch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of workspace one call needs (0 when the key axis is not split);
// the caller allocates them and passes the pointer to the forward call.
// ops/paged_attention.py `workspace_floats` is the same rule in Python.
extern "C" long long paged_attention_workspace_floats(
    int batch, int cur_len, int num_heads, int kv_heads, int head_dim,
    int blocks_per_seq, int block_size, int dtype, int quant) {
  if (kv_heads <= 0 || num_heads % kv_heads) return 0;
  const int total_rows = cur_len * (num_heads / kv_heads);
  const Route route = route_of(dtype, quant != 0, head_dim, total_rows);
  const int splits = splits_of(route, batch, kv_heads, total_rows,
                               blocks_per_seq, block_size);
  if (splits == 1) return 0;
  return (long long)batch * kv_heads * splits * total_rows * (head_dim + 2);
}

namespace {

// Shared validation and setup of the two C entries; returns a
// cudaError_t (0 = launched).
int forward(const void* q, const void* k_pool, const void* v_pool,
            const void* k_scale, const void* v_scale, bool quant,
            const void* tables, const void* positions, void* out,
            void* workspace, int batch, int cur_len, int num_heads,
            int kv_heads, int head_dim, int block_size, int blocks_per_seq,
            int table_stride, float sm_scale, int window, int dtype,
            void* stream) {
  if (batch <= 0 || cur_len <= 0 || kv_heads <= 0 ||
      num_heads % kv_heads != 0 || block_size <= 0 ||
      kStepKeys % block_size != 0 || blocks_per_seq <= 0 ||
      table_stride < blocks_per_seq ||
      (quant && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.tables = static_cast<const int*>(tables);
  p.positions = static_cast<const int*>(positions);
  p.out = out;
  p.cur_len = cur_len;
  p.num_heads = num_heads;
  p.kv_heads = kv_heads;
  p.n_rep = num_heads / kv_heads;
  p.total_rows = cur_len * p.n_rep;
  p.block_size = block_size;
  p.blocks_per_seq = blocks_per_seq;
  p.table_stride = table_stride;
  const Route route = route_of(dtype, quant, head_dim, p.total_rows);
  p.splits = splits_of(route, batch, kv_heads, p.total_rows, blocks_per_seq,
                       block_size);
  p.split_keys = p.splits > 1 ? kSplitKeys : kNoSplit;
  p.window = window;
  p.sm_scale = sm_scale;
  float* ws = static_cast<float*>(workspace);
  if (p.splits > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const size_t parts = (size_t)batch * kv_heads * p.splits * p.total_rows;
  p.ws_m = ws;
  p.ws_l = ws ? ws + parts : nullptr;
  p.ws_acc = ws ? ws + 2 * parts : nullptr;
  // Clear a stale error so the return value speaks of this launch only.
  cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return quant ? dispatch_dim<float, int8_t>(route, head_dim, p, batch, s)
                 : dispatch_dim<float, float>(route, head_dim, p, batch, s);
  if (dtype == 1)
    return quant ? dispatch_dim<bf16, int8_t>(route, head_dim, p, batch, s)
                 : dispatch_dim<bf16, bf16>(route, head_dim, p, batch, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entries. Pointers are device pointers of contiguous tensors:
// q/out (B, T, H, D); k_pool/v_pool (NB, bs, KV, D) in q's dtype, or
// int8 for the _int8 entry with k_scale/v_scale (NB, bs, KV, 1) fp32;
// tables (B, >= bps) int32 with row stride `table_stride`; positions
// (B, T) int32; workspace: paged_attention_workspace_floats(...) fp32
// (may be null when that is 0). block_size must divide 64. dtype (of q):
// 0 = float32, 1 = bfloat16. Return a cudaError_t (0 = launched).
extern "C" int paged_attention_forward(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* positions, void* out, void* workspace, int batch, int cur_len,
    int num_heads, int kv_heads, int head_dim, int block_size,
    int blocks_per_seq, int table_stride, float sm_scale, int window,
    int dtype, void* stream) {
  return forward(q, k_pool, v_pool, nullptr, nullptr, false, tables,
                 positions, out, workspace, batch, cur_len, num_heads,
                 kv_heads, head_dim, block_size, blocks_per_seq,
                 table_stride, sm_scale, window, dtype, stream);
}

extern "C" int paged_attention_forward_int8(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* positions, void* out, void* workspace, int batch, int cur_len,
    int num_heads, int kv_heads, int head_dim, int block_size,
    int blocks_per_seq, int table_stride, float sm_scale, int window,
    int dtype, void* stream) {
  return forward(q, k_pool, v_pool, k_scale, v_scale, true, tables,
                 positions, out, workspace, batch, cur_len, num_heads,
                 kv_heads, head_dim, block_size, blocks_per_seq,
                 table_stride, sm_scale, window, dtype, stream);
}
