// Paged-KV attention for Hopper (sm_90a), float and bf16, over float or
// int8 pools.
//
// Replaces the TPU kernels skypilot_tpu/ops/paged_attention.py
// `_decode_kernel` (float pools) and `_decode_kernel_int8` (int8 pools
// with fp32 per-token scale rows), entry `paged_decode_attention`,
// pl.pallas_call at :268: every prefill chunk and decode step of the
// serving path attends through one of them, one launch per layer. The
// two are routes of one template here (payload type P = T or int8_t):
// same grid, table walk, staging and split-key combine.
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
// run in no order, so the block walk is a loop inside one CUDA block.
// The grid is (B, KV, row tiles x splits). Query rows tile over the third
// axis (a 256-token prefill chunk at n_rep 4 is 1024 rows), and each tile
// skips blocks by ITS OWN largest position, so it never skips a block one
// of its queries can see. There is no scalar prefetch: each CUDA block
// reads its own table entries and positions. Each loop step stages 64
// keys (64 / bs logical blocks, looked up through the table) of K and V
// in shared memory as fp32, with 16-byte vector loads (K rows padded to
// D + 1 so the score loop is free of bank conflicts); m, l and each
// thread's slice of acc stay in fp32 for the whole walk.
//
// What bounds it on the H100. At decode (T = 1) the work is ~2 FLOPs per
// byte of K/V, far under the card's ~295 FLOP/byte ridge: the bound is
// the bytes of the live K/V blocks over 3.35 TB/s. Each live block is
// read once per (row, kv head) and no gathered window ever exists in
// device memory (the plain version writes and reads one). A decode step
// has only B x KV row tiles (64 at B 8, KV 8, against 132 SMs), so when
// the grid is small the key axis splits across CUDA blocks as well
// (flash-decoding): each split walks 1/splits of the tile's live keys and
// writes a partial (m, l, acc); a second kernel merges the splits. At
// prefill (T = 256) each staged tile is reused by up to 16 query rows and
// the grid is large; the bound is FLOPs, and this kernel's fp32 CUDA-core
// arithmetic (no wgmma/TMA yet) stays far from it. Under int8 the bytes
// per live token fall from 4 D to 2 D + 8 (payload plus two scale rows).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
  int block_size, blocks_per_seq, table_stride, splits, window;
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

template <typename T, typename P, int D, int ROWS>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, ROWS);
  auto kernel = paged_attention_kernel<T, P, D, ROWS>;
  static bool smem_configured = false;  // once per instantiation
  if (smem > 48 * 1024 && !smem_configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_configured = true;
  }
  const int tiles = (p.total_rows + ROWS - 1) / ROWS;
  kernel<<<dim3(batch, p.kv_heads, tiles * p.splits), kThreads, smem,
           stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  combine_kernel<T, D><<<dim3(batch * p.kv_heads, p.total_rows), D, 0,
                         stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, typename P, int D>
int dispatch_rows(const Params& p, int batch, cudaStream_t stream) {
  return rows_per_tile(p.total_rows) == 4
             ? launch<T, P, D, 4>(p, batch, stream)
             : launch<T, P, D, 16>(p, batch, stream);
}

template <typename T, typename P>
int dispatch_dim(int head_dim, const Params& p, int batch,
                 cudaStream_t stream) {
  switch (head_dim) {
    case 64: return dispatch_rows<T, P, 64>(p, batch, stream);
    case 128: return dispatch_rows<T, P, 128>(p, batch, stream);
    case 256: return dispatch_rows<T, P, 256>(p, batch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of workspace one call needs (0 when the key axis is not split);
// the caller allocates them and passes the pointer to the forward call.
extern "C" long long paged_attention_workspace_floats(int batch, int cur_len,
                                                      int num_heads,
                                                      int kv_heads,
                                                      int head_dim) {
  if (kv_heads <= 0 || num_heads % kv_heads) return 0;
  const int total_rows = cur_len * (num_heads / kv_heads);
  const int splits = num_splits(batch, kv_heads, total_rows);
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
  p.splits = num_splits(batch, kv_heads, p.total_rows);
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
    return quant ? dispatch_dim<float, int8_t>(head_dim, p, batch, s)
                 : dispatch_dim<float, float>(head_dim, p, batch, s);
  if (dtype == 1)
    return quant
               ? dispatch_dim<__nv_bfloat16, int8_t>(head_dim, p, batch, s)
               : dispatch_dim<__nv_bfloat16, __nv_bfloat16>(head_dim, p,
                                                            batch, s);
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
