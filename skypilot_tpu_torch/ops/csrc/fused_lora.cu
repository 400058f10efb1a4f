// Fused multi-LoRA delta for Hopper (sm_90a), float and bf16.
//
// Replaces the TPU kernel skypilot_tpu/ops/fused_lora.py `_lora_kernel`
// (entry `fused_multi_lora`, pl.pallas_call at :70): every targeted
// projection of every prefill chunk and decode step of a multi-LoRA
// engine computes its low-rank delta through it, one call per target and
// layer.
//
// What it computes (the TPU kernel's contract): for each batch row b,
// z[b] = (x[b] . A[ids[b]]) . B[ids[b]], UNSCALED (the caller adds
// z * alpha / r to the base projection). x is (B, T, IN), the stacks are
// (slots, IN, r) and (slots, r, OUT), ids (B,) int32 in [0, slots); slot
// 0 is the all-zero identity, so a base-model row gets z = 0 exactly.
// Both products run in the input dtype as on the TPU: each sums in fp32
// and rounds to the input dtype, so z is rounded ONCE between them.
// Each row reads its adapter's A and B through ids[b]; no gathered
// (B, IN, r) / (B, r, OUT) copy ever exists (the plain version's
// index_select makes one).
//
// Translation to Hopper, and what bounds it. The work is tiny: 2 r MACs
// per element of x and of the output at r = 16, far under the card's
// ridge. At decode (B 8, T 1) the bytes are the adapters' A and B rows
// (one stack slice per distinct id) and the call is launch-bound; at a
// 256-token prefill chunk they are x and the output. Two launches per
// call (the TPU's single grid cell per row holds the whole (T, IN) x
// tile in VMEM; a CUDA block cannot, and a decode step would run on 8
// SMs):
//  1. shrink: grid (B, row tiles of ROWS tokens, IN splits). Each block
//     walks its slice of IN with 128 threads on neighbouring k (x and the
//     A rows read coalesced), keeps ROWS x r fp32 partial sums in
//     registers, reduces them across the block (warp shuffles, then the
//     4 warps in order) and writes one fp32 partial per (row, split, j).
//     The IN axis splits so that a decode step fills the card.
//  2. expand: grid (B, row tiles, OUT tiles). Each block first sums its
//     rows' partials over the splits IN ORDER (deterministic), rounds
//     them to the input dtype (the TPU's z), then each thread produces 4
//     neighbouring output columns per row from the r rows of B[ids[b]].
// No atomics: two runs are bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;          // output columns per thread (expand)
constexpr int kTargetCtas = 264;  // ~2 shrink blocks per SM
constexpr int kMinSplitLen = 512; // IN elements per shrink block, at least

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}
// Round an fp32 sum to the input dtype T and back.
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffff, v, o);
  return v;
}

int rows_per_tile(int seq, int rank) { return seq > 1 && rank <= 16 ? 4 : 1; }

int num_splits(int batch, int seq, int d_in, int rank) {
  const int rows = rows_per_tile(seq, rank);
  const int ctas = batch * ((seq + rows - 1) / rows);
  int splits = (kTargetCtas + ctas - 1) / ctas;
  const int most = (d_in + kMinSplitLen - 1) / kMinSplitLen;
  if (splits > most) splits = most;
  return splits < 1 ? 1 : splits;
}

struct Params {
  const void* x;        // (B, T, IN)
  const void* a_stack;  // (slots, IN, R)
  const void* b_stack;  // (slots, R, OUT)
  const int* ids;       // (B,)
  void* out;            // (B, T, OUT)
  float* ws;            // (B, T, splits, R) fp32 partials
  int seq, d_in, d_out, splits, split_len;
};

template <typename T, int R, int ROWS>
__global__ void __launch_bounds__(kThreads) lora_shrink_kernel(Params p) {
  const int b = blockIdx.x, t0 = blockIdx.y * ROWS, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const T* x = static_cast<const T*>(p.x);
  const T* a = static_cast<const T*>(p.a_stack) +
               (size_t)p.ids[b] * p.d_in * R;
  const int lo = split * p.split_len;
  const int hi = min(p.d_in, lo + p.split_len);

  float acc[ROWS][R];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[r][j] = 0.f;

  for (int k = lo + tid; k < hi; k += kThreads) {
    float a_row[R];
#pragma unroll
    for (int j = 0; j < R; ++j) a_row[j] = to_float(a[(size_t)k * R + j]);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int t = t0 + r;
      const float xv =
          t < p.seq ? to_float(x[((size_t)b * p.seq + t) * p.d_in + k]) : 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) acc[r][j] += xv * a_row[j];
    }
  }

  __shared__ float red[kWarps][ROWS * R];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float v = warp_sum(acc[r][j]);
      if (lane == 0) red[warp][r * R + j] = v;
    }
  __syncthreads();
  for (int e = tid; e < ROWS * R; e += kThreads) {
    const int r = e / R, j = e % R, t = t0 + r;
    if (t >= p.seq) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w][e];
    p.ws[(((size_t)b * p.seq + t) * p.splits + split) * R + j] = v;
  }
}

template <typename T, int R, int ROWS>
__global__ void __launch_bounds__(kThreads) lora_expand_kernel(Params p) {
  const int b = blockIdx.x, t0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x;
  const T* bm = static_cast<const T*>(p.b_stack) +
                (size_t)p.ids[b] * R * p.d_out;
  T* out = static_cast<T*>(p.out);

  // z for this tile's rows: the splits summed in order, rounded once to
  // the input dtype (the first product's output dtype on the TPU).
  __shared__ float z[ROWS][R];
  for (int e = tid; e < ROWS * R; e += kThreads) {
    const int r = e / R, j = e % R, t = t0 + r;
    float v = 0.f;
    if (t < p.seq) {
      const float* part = p.ws + ((size_t)b * p.seq + t) * p.splits * R + j;
      for (int s = 0; s < p.splits; ++s) v += part[(size_t)s * R];
    }
    z[r][j] = round_to(v, static_cast<const T*>(p.x));
  }
  __syncthreads();

  const int col0 = (blockIdx.z * kThreads + tid) * kCols;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int o = col0 + c;
    if (o >= p.d_out) break;
    float bcol[R];
#pragma unroll
    for (int j = 0; j < R; ++j) bcol[j] = to_float(bm[(size_t)j * p.d_out + o]);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int t = t0 + r;
      if (t >= p.seq) break;
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) v += z[r][j] * bcol[j];
      store(v, out + ((size_t)b * p.seq + t) * p.d_out + o);
    }
  }
}

template <typename T, int R, int ROWS>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const int tiles = (p.seq + ROWS - 1) / ROWS;
  lora_shrink_kernel<T, R, ROWS>
      <<<dim3(batch, tiles, p.splits), kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int col_tiles = (p.d_out + kThreads * kCols - 1) / (kThreads * kCols);
  lora_expand_kernel<T, R, ROWS>
      <<<dim3(batch, tiles, col_tiles), kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int R>
int dispatch_rows(const Params& p, int batch, cudaStream_t stream) {
  if constexpr (R <= 16) {
    if (rows_per_tile(p.seq, R) == 4) return launch<T, R, 4>(p, batch, stream);
  }
  return launch<T, R, 1>(p, batch, stream);
}

template <typename T>
int dispatch_rank(int rank, const Params& p, int batch, cudaStream_t stream) {
  switch (rank) {
    case 8: return dispatch_rows<T, 8>(p, batch, stream);
    case 16: return dispatch_rows<T, 16>(p, batch, stream);
    case 32: return dispatch_rows<T, 32>(p, batch, stream);
    case 64: return dispatch_rows<T, 64>(p, batch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of workspace one call needs: the shrink's fp32 partials.
extern "C" long long fused_lora_workspace_floats(int batch, int seq, int d_in,
                                                 int rank) {
  if (batch <= 0 || seq <= 0 || d_in <= 0 || rank <= 0) return 0;
  return (long long)batch * seq * num_splits(batch, seq, d_in, rank) * rank;
}

// C entry. Pointers are device pointers of contiguous tensors: x (B, T,
// IN) and out (B, T, OUT) in one dtype with the stacks a (slots, IN, rank)
// and b (slots, rank, OUT); ids (B,) int32, each in [0, slots); workspace:
// fused_lora_workspace_floats(...) fp32. rank in {8, 16, 32, 64}. dtype:
// 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int fused_lora_forward(const void* x, const void* a_stack,
                                  const void* b_stack, const void* ids,
                                  void* out, void* workspace, int batch,
                                  int seq, int d_in, int d_out, int rank,
                                  int dtype, void* stream) {
  if (batch <= 0 || seq <= 0 || d_in <= 0 || d_out <= 0 || rank <= 0 ||
      workspace == nullptr)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.a_stack = a_stack;
  p.b_stack = b_stack;
  p.ids = static_cast<const int*>(ids);
  p.out = out;
  p.ws = static_cast<float*>(workspace);
  p.seq = seq;
  p.d_in = d_in;
  p.d_out = d_out;
  p.splits = num_splits(batch, seq, d_in, rank);
  p.split_len = (d_in + p.splits - 1) / p.splits;
  // Clear a stale error so the return value speaks of this launch only.
  cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_rank<float>(rank, p, batch, s);
  if (dtype == 1) return dispatch_rank<__nv_bfloat16>(rank, p, batch, s);
  return (int)cudaErrorInvalidValue;
}
