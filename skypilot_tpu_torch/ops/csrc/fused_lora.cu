// Fused multi-LoRA for Hopper (sm_90a), float and bf16: one call adds the
// scaled low-rank deltas of a GROUP of projections that read one input.
//
// Replaces the TPU kernel skypilot_tpu/ops/fused_lora.py `_lora_kernel`
// (entry `fused_multi_lora`, pl.pallas_call at :70) and the reference's
// scaled add after it (skypilot_tpu/models/transformer.py:274,
// y = y + z * (alpha / r)).
//
// What it computes. A group is up to three targets that read one x (B, T,
// IN) and own disjoint column slices of one output y (B, T, width): q, k
// and v of the fused qkv projection, gate and up of gate_up, o, down. For
// target t with stacks A_t (slots, IN, r), B_t (slots, r, OUT_t) and
// first column off_t, and each batch row b with slot s = ids[b]:
//   z = round(x[b] . A_t[s])                  (r values a token)
//   w = round(z . B_t[s])                     (the TPU kernel's output)
//   y[b, :, off_t + o] = round(y + round(w[o] * scale))
// Every product sums in fp32 and `round` is to the compute dtype, so the
// epilogue rounds exactly as the eager `y[..., s] += fused(...) * scale`
// does. Slot 0 is the all-zero identity: its rows add +-0 and are
// skipped, leaving y unchanged. No gathered A/B copy ever exists.
//
// What bounds it (H100 SXM): 2 r MACs per element of x and of each
// output, far under the card's ridge, so bytes bound both routes. A
// prefill chunk (T 256) moves x once and y's slices twice (the add reads
// and writes them): ~60 MB a layer, 0.018 ms. A decode tick (B 8, T 1)
// moves the named slots' A and B, ~12 MB a layer, 0.0035 ms, and is in
// fact bound by latency: two dependent grids a group, each a few
// microseconds however little it moves.
//
// Design. Two launches a group, the second a programmatic dependent
// launch (griddepcontrol) of the first: its blocks start while the first
// drains and stage what does not depend on it (y's tile and B's tile; at
// decode B's rows in registers).
//  1. shrink: x against every target's A at once (x read once), IN split
//     across blocks, one fp32 partial per (row, split, target, j).
//  2. expand: each block sums the partials of its rows IN SPLIT ORDER
//     (L2 reads, many in flight), rounds z once, then z . B_t and the
//     scaled add, in place into y's slice.
// No atomic touches a value: two runs are bit-identical. The split rule
// reads (IN, T) only, never B or the ids, so a row gives the same bits
// alone and in any batch; nothing is read back to the host, and the
// workspace comes from the caller (the calls can be captured in a CUDA
// graph).
// Routes (both pure functions of dtype, r, T and the static widths):
//  - tensor cores (bf16, T >= 16, r >= 16, widths multiples of 8):
//    mma.sync m16n8k16 over 64-row tiles. The shrink streams x's and the
//    targets' A tiles (N = r x targets columns side by side: 16, 32 or 48
//    at r 16) through a 6-stage cp.async ring and splits IN so that a
//    256-token chunk fills the card (64 blocks at IN 4096); the expand is
//    one k-step per 16 of r on a 64 x 128 tile with B's tile in shared
//    memory, y's tile staged by 16-byte cp.async before the dependency
//    wait and stored back by 16-byte vectors after the epilogue.
//  - CUDA cores (decode, fp32, r 8, unaligned widths): a shrink block per
//    (256 of IN, 16-row tile, batch row), one IN row a thread, A's rows
//    as 16-byte vectors, all of a thread's ROWS x r products summed over
//    the warp by one recursive halving (warp_sum_scatter), then the warps
//    in order; an expand block per (column tile, 16-row tile, batch row)
//    stages the partials in shared memory (8 loads a thread in flight)
//    and gives each thread 16 bytes of neighbouring columns (B's rows and
//    y as 16-byte vectors where the widths allow). The row tiles keep a
//    prefill chunk's blocks many; at decode (T 1) there is one. The
//    shuffles, not bytes, bound this route's prefill shrink.
// Kept by ops/kernel_ab.py A/Bs (lora-*): B held in registers across the
// wait, split depth and ring depth. Also measured and dropped: one launch
// a group at decode (the expand in the shrink's last split block, 4x
// slower: one block cannot stream a group's B) and a plain launch of the
// expand instead of the dependent one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

constexpr int kMaxTargets = 3;

// The C entries' descriptor: outside the anonymous namespace, so the
// entries keep external linkage.
struct Target {
  const void* a;  // (slots, IN, rank)
  const void* b;  // (slots, rank, d_out)
  int d_out;
  int offset;     // first column of this target's slice of y
};

// The static half of a call, built once per group by the wrapper (its
// ctypes twin is ops/fused_lora.py `_GroupDesc`).
struct GroupDesc {
  Target t[kMaxTargets];
  int targets, rank, d_in, width, dtype;  // dtype 0 float32, 1 bfloat16
  float scale;
};

namespace {

using bf16 = __nv_bfloat16;

// Tensor-core route.
constexpr int kTcThreads = 128;  // 4 warps x 16 rows
constexpr int kTcRows = 64;      // rows of a tile
constexpr int kTcK = 64;         // IN elements of a staged k-tile
constexpr int kTcStages = 6;     // cp.async ring depth
constexpr int kTcCols = 128;     // output columns of an expand block
constexpr int kTcBlocks = 128;   // shrink blocks a call aims for
constexpr int kTcMinSplit = 256; // IN elements per shrink block, at least
constexpr int kTcMinRows = 16;   // T from which bf16 takes this route

// CUDA-core route.
constexpr int kCcThreads = 256;        // shrink: one IN row a thread
constexpr int kCcSplit = kCcThreads;   // IN elements per shrink block
constexpr int kCcExpandThreads = 128;
constexpr int kCcExpandRows = 4;       // rows an expand thread carries
constexpr int kCcTileRows = 16;        // rows of a block's tile (T > 1)
constexpr int kZStage = 4096;          // partials the expand stages at once
constexpr int kInFlight = 8;           // partial loads a thread has in flight

struct Params {
  GroupDesc g;
  const void* x;   // (B, T, IN)
  const int* ids;  // (B,)
  void* y;         // (B, T, width), updated in place
  float* part;     // (B T, splits, n) fp32 partials
  int seq, splits, split_len, tiles, n;  // n = targets x rank
};

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16(v);
}
// An fp32 value rounded to T and back.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}
// The epilogue: y + round(round(w) * scale), rounded to T.
template <typename T>
__device__ __forceinline__ float add_scaled(float y, float w, float scale) {
  return round_to<T>(y + round_to<T>(round_to<T>(w) * scale));
}

// v[0, N) (N a power of two) summed over the warp by recursive halving:
// at lane offset O each lane keeps half of its COUNT values, sends the
// other half to lane ^ O and adds what it gets; once one value is left,
// plain butterflies. Every sum pairs the lanes as the butterfly v +=
// shfl_xor(v, 16, 8, ..., 1) does, so it gives that sum's bits, in N - 1
// shuffles (N <= 32) where the butterfly per value takes 5 N. After it
// the lane holds elements [owned, owned + max(N / 32, 1)) in v[0, ...).
template <int N, int COUNT = N, int O = 16>
__device__ __forceinline__ void warp_sum_scatter(float (&v)[N], int lane,
                                                 int& owned) {
  if constexpr (O > 0) {
    if constexpr (COUNT > 1) {
      constexpr int H = COUNT / 2;
      const bool up = lane & O;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      if (up) owned += H;
      warp_sum_scatter<N, H, O / 2>(v, lane, owned);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      warp_sum_scatter<N, 1, O / 2>(v, lane, owned);
    }
  }
}

__device__ __forceinline__ Target target(const Params& p, int t) {
  return t == 0 ? p.g.t[0] : t == 1 ? p.g.t[1] : p.g.t[2];
}

// VEC consecutive T values <-> floats, as one 16-byte access (VEC =
// 16 / sizeof(T)) or VEC scalar ones.
template <typename T, int VEC>
__device__ __forceinline__ void unpack(float (&v)[VEC], const uint4& raw) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = to_float(e[i]);
}
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(float (&v)[VEC], const T* p) {
  if constexpr (VEC * sizeof(T) == 16) {
    unpack<T, VEC>(v, *reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_float(p[i]);
  }
}
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_float<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = from_float<T>(v[i]);
  }
}

// ------------------------------------------------------- CUDA-core route

// B's rows of a thread's columns stay in registers across the dependency
// wait where they fit (16-byte vectors, r <= 16).
template <typename T, int R, int VEC>
constexpr int kHeld = VEC * sizeof(T) == 16 && R <= 16 ? R : 1;

// Which target a flat column-tile index falls in, and the tile within it.
__device__ __forceinline__ int tile_target(const Params& p, int span,
                                           int* tile) {
  int t = 0;
  for (; t < p.g.targets - 1; ++t) {
    const int tiles = (target(p, t).d_out + span - 1) / span;
    if (*tile < tiles) break;
    *tile -= tiles;
  }
  return t;
}

// grid (splits, row tiles, B). Each thread owns one IN row k of the
// block's split: x[row, k] A_t[slot][k, j], summed over the block by
// warp_sum_scatter and then the warps in order, one fp32 partial per
// (row, split, target, j), ROWS rows at a time. The expand sums the
// splits.
template <typename T, int R, int ROWS, int VEC>
__global__ void __launch_bounds__(kCcThreads) cc_shrink_kernel(Params p) {
  constexpr int kWarps = kCcThreads / 32;
  const int split = blockIdx.x, b = blockIdx.z;
  const int m0 = blockIdx.y * kCcTileRows;
  const int m1 = min(p.seq, m0 + kCcTileRows);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  griddep_launch_dependents();
  const int slot = p.ids[b];
  if (slot == 0) return;
  const int d_in = p.g.d_in;
  const int k0 = split * p.split_len;
  const int kn = min(d_in - k0, p.split_len);
  const bool live = tid < kn;
  const T* x = static_cast<const T*>(p.x) + (size_t)b * p.seq * d_in + k0;
  const size_t a_row = ((size_t)slot * d_in + k0 + (live ? tid : 0)) * R;
  // Every target's A row on its way to L2 before the first is read.
  for (int t = 1; t < p.g.targets; ++t)
    for (int j = 0; j < R * (int)sizeof(T); j += 128)
      prefetch_l2(reinterpret_cast<const char*>(
                      static_cast<const T*>(target(p, t).a) + a_row) + j);
  __shared__ __align__(16) T xs[ROWS][kCcSplit];
  __shared__ float red[kWarps][ROWS * R];
  float a[R];  // this thread's A row of the current target
  auto load_a = [&](int t) {
    const T* src = static_cast<const T*>(target(p, t).a) + a_row;
#pragma unroll
    for (int j = 0; j < R; j += 16 / sizeof(T)) {
      float v[16 / sizeof(T)];
      load_vec<T, 16 / sizeof(T)>(v, src + j);
#pragma unroll
      for (int i = 0; i < (int)(16 / sizeof(T)); ++i)
        a[j + i] = live ? v[i] : 0.f;
    }
  };
  load_a(0);  // in flight with x's loads

  for (int r0 = m0; r0 < m1; r0 += ROWS) {
    const int rows = min(ROWS, m1 - r0);
    // Stage x[rows, k0 : k0 + kn) (16-byte loads where IN allows).
    for (int e = tid * VEC; e < ROWS * kCcSplit; e += kCcThreads * VEC) {
      const int r = e / kCcSplit, k = e % kCcSplit;
      float v[VEC];
      if (r < rows && k < kn) {
        load_vec<T, VEC>(v, x + (size_t)(r0 + r) * d_in + k);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[i] = 0.f;
      }
      store_vec<T, VEC>(&xs[r][k], v);
    }
    __syncthreads();
    for (int t = 0; t < p.g.targets; ++t) {
      if (p.g.targets > 1 && (t > 0 || r0 > m0)) load_a(t);
      float v[ROWS * R];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float xv = to_float(xs[r][tid]);
#pragma unroll
        for (int j = 0; j < R; ++j) v[r * R + j] = xv * a[j];
      }
      int owned = 0;
      warp_sum_scatter(v, lane, owned);
      // Lanes that share their elements hold the same bits: the first
      // of each such group writes them.
      constexpr int kLeft = ROWS * R >= 32 ? ROWS * R / 32 : 1;
      constexpr int kShare = ROWS * R >= 32 ? 1 : 32 / (ROWS * R);
      if (lane % kShare == 0) {
#pragma unroll
        for (int i = 0; i < kLeft; ++i) red[warp][owned + i] = v[i];
      }
      __syncthreads();
      for (int e = tid; e < rows * R; e += kCcThreads) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[w][e];
        const int row = r0 + e / R;
        p.part[(((size_t)b * p.seq + row) * p.splits + split) * p.n + t * R +
               e % R] = s;
      }
      __syncthreads();
    }
  }
}

// grid (column tiles of every target, row tiles, B): columns [col, col +
// VEC) of target t a thread, the tile's rows kCcExpandRows at a time: z of
// those rows from the partials, summed in split order and rounded to T
// (every thread helps, `active` or not), then w = z . B_t[slot] and the
// scaled add into y.
template <typename T, int R, int VEC>
__global__ void __launch_bounds__(kCcExpandThreads) cc_expand_kernel(Params p) {
  constexpr int kSpan = kCcExpandThreads * VEC;
  constexpr bool kHold = kHeld<T, R, VEC> == R;
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * kCcTileRows;
  const int m1 = min(p.seq, m0 + kCcTileRows);
  int tile = blockIdx.x;
  const int t = tile_target(p, kSpan, &tile);
  const int col = tile * kSpan + threadIdx.x * VEC;
  const Target tg = target(p, t);
  const int slot = p.ids[b];
  if (slot == 0) return;
  const bool active = col < tg.d_out;
  const T* bm = static_cast<const T*>(tg.b) + (size_t)slot * R * tg.d_out + col;
  T* y = static_cast<T*>(p.y) + (size_t)b * p.seq * p.g.width + tg.offset + col;
  // B's rows and the tile's y rows do not depend on the shrink: in
  // registers (or L2) and in L2 before the dependency wait.
  uint4 held[kHeld<T, R, VEC>];
  if (active) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if constexpr (kHold) {
        held[j] = *reinterpret_cast<const uint4*>(bm + (size_t)j * tg.d_out);
      } else {
        prefetch_l2(bm + (size_t)j * tg.d_out);
      }
    }
    for (int r = m0; r < m1; ++r) prefetch_l2(y + (size_t)r * p.g.width);
  }
  griddep_wait();

  __shared__ float zs[kCcExpandRows][R];
  __shared__ float stage[kZStage];
  float* zf = &zs[0][0];
  for (int r0 = m0; r0 < m1; r0 += kCcExpandRows) {
    const int rows = min(kCcExpandRows, m1 - r0), nv = rows * R;
    __syncthreads();  // the previous rows' z is read
    for (int v = threadIdx.x; v < nv; v += kCcExpandThreads) zf[v] = 0.f;
    // The partials of as many splits as kZStage holds, every thread
    // loading kInFlight at once, then each z value summed in split order.
    const int most = kZStage / nv;
    for (int s0 = 0; s0 < p.splits; s0 += most) {
      const int ns = min(most, p.splits - s0);
      __syncthreads();
      for (int e0 = threadIdx.x; e0 < ns * nv;
           e0 += kInFlight * kCcExpandThreads) {
        float got[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int e = e0 + u * kCcExpandThreads, v = e % nv;
          if (e < ns * nv)
            got[u] = __ldcg(p.part + (((size_t)b * p.seq + r0 + v / R) *
                                          p.splits + s0 + e / nv) * p.n +
                            t * R + v % R);
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u)
          if (e0 + u * kCcExpandThreads < ns * nv)
            stage[e0 + u * kCcExpandThreads] = got[u];
      }
      __syncthreads();
      for (int v = threadIdx.x; v < nv; v += blockDim.x) {
        float s = zf[v];
        for (int k = 0; k < ns; ++k) s += stage[k * nv + v];
        zf[v] = s;
      }
    }
    __syncthreads();
    for (int v = threadIdx.x; v < nv; v += blockDim.x)
      zf[v] = round_to<T>(zf[v]);
    __syncthreads();
    if (!active) continue;
    float acc[kCcExpandRows][VEC];
#pragma unroll
    for (int r = 0; r < kCcExpandRows; ++r)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float bv[VEC];
      if constexpr (kHold) {
        unpack<T, VEC>(bv, held[j]);
      } else {
        load_vec<T, VEC>(bv, bm + (size_t)j * tg.d_out);
      }
#pragma unroll
      for (int r = 0; r < kCcExpandRows; ++r) {
        if (r >= rows) break;
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[r][v] += zs[r][j] * bv[v];
      }
    }
#pragma unroll
    for (int r = 0; r < kCcExpandRows; ++r) {
      if (r >= rows) break;
      T* dst = y + (size_t)(r0 + r) * p.g.width;
      float yv[VEC];
      load_vec<T, VEC>(yv, dst);
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        yv[v] = add_scaled<T>(yv[v], acc[r][v], p.g.scale);
      store_vec<T, VEC>(dst, yv);
    }
  }
}

// ----------------------------------------------------- tensor-core route

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sm90::smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sm90::smem_addr(p)));
}
// d += a . b, m16n8k16, bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k16 step of a warp's 16 rows against N columns: A fragment from a
// row-major tile (pitch ap bytes) at column k, B fragments from a k-major
// tile (pitch bp bytes) at row k, through ldmatrix.trans.
template <int N>
__device__ __forceinline__ void mma_rows16(float (&acc)[N / 8][4],
                                           const unsigned char* a, int ap,
                                           const unsigned char* bt, int bp,
                                           int k, int lane) {
  uint32_t af[4];
  ldmatrix_x4(af, a + (lane % 16) * ap + (k + (lane / 16) * 8) * 2);
  const unsigned char* brow = bt + (k + lane % 8 + ((lane / 8) % 2) * 8) * bp;
#pragma unroll
  for (int n = 0; n < N / 16; ++n) {
    uint32_t bfr[4];
    ldmatrix_x4_trans(bfr, brow + (16 * n + (lane / 16) * 8) * 2);
    mma_bf16(acc[2 * n], af, bfr[0], bfr[1]);
    mma_bf16(acc[2 * n + 1], af, bfr[2], bfr[3]);
  }
}

template <int N>
struct TcShrinkSmem {
  static constexpr int kXPitch = kTcK * 2 + 16;  // bytes; odd multiples of
  static constexpr int kAPitch = N * 2 + 16;     // 16: ldmatrix conflict-free
  static constexpr int kStage = kTcRows * kXPitch + kTcK * kAPitch;
  static constexpr int kBytes = kTcStages * kStage;
};

// grid (splits, row tiles, B), 4 warps x 16 rows. x's 64 x 64 tile and
// the targets' A rows (64 x N, side by side) per ring stage.
template <int R, int NT>
__global__ void __launch_bounds__(kTcThreads) tc_shrink_kernel(Params p) {
  constexpr int N = R * NT;
  using S = TcShrinkSmem<N>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int split = blockIdx.x, tile = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  griddep_launch_dependents();
  const int slot = p.ids[b];
  if (slot == 0) return;
  const int d_in = p.g.d_in, m0 = tile * kTcRows;
  const int k0 = split * p.split_len;
  const int kend = min(d_in, k0 + p.split_len);
  const int ktiles = (kend - k0 + kTcK - 1) / kTcK;
  const bf16* x = static_cast<const bf16*>(p.x) + (size_t)b * p.seq * d_in;
  const bf16* a_t[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t)
    a_t[t] = static_cast<const bf16*>(target(p, t).a) + (size_t)slot * d_in * R;

  auto load_stage = [&](int kt) {
    unsigned char* sx = smem + (kt % kTcStages) * S::kStage;
    unsigned char* sa = sx + kTcRows * S::kXPitch;
    const int kb = k0 + kt * kTcK;
    for (int c = tid; c < kTcRows * (kTcK / 8); c += kTcThreads) {
      const int r = c / (kTcK / 8), ch = c % (kTcK / 8);
      const int row = m0 + r, k = kb + ch * 8;
      const bool ok = row < p.seq && k < kend;
      sm90::cp_async16(sx + r * S::kXPitch + ch * 16,
                       ok ? x + (size_t)row * d_in + k : x, ok);
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
      for (int c = tid; c < kTcK * (R / 8); c += kTcThreads) {
        const int r = c / (R / 8), ch = c % (R / 8), k = kb + r;
        const bool ok = k < kend;
        sm90::cp_async16(sa + r * S::kAPitch + (t * (R / 8) + ch) * 16,
                         a_t[t] + (size_t)(ok ? k : 0) * R + ch * 8, ok);
      }
  };

  float acc[N / 8][4];
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < ktiles) load_stage(s);
    sm90::cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    sm90::cp_async_wait<kTcStages - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free again
    if (kt + kTcStages - 1 < ktiles) load_stage(kt + kTcStages - 1);
    sm90::cp_async_commit();
    const unsigned char* sx = smem + (kt % kTcStages) * S::kStage;
    const unsigned char* sa = sx + kTcRows * S::kXPitch;
#pragma unroll
    for (int k = 0; k < kTcK; k += 16)
      mma_rows16<N>(acc, sx + warp * 16 * S::kXPitch, S::kXPitch, sa,
                    S::kAPitch, k, lane);
  }
  sm90::cp_async_wait<0>();

  // Accumulator fragment: acc[n][2h + e] is row g + 8h, column 8n + 2q + e.
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + warp * 16 + g + 8 * h;
    if (row >= p.seq) continue;
    float* dst = p.part + (((size_t)b * p.seq + row) * p.splits + split) * N;
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n + 2 * q) =
          make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

template <int R>
struct TcExpandSmem {
  static constexpr int kYPitch = kTcCols * 2 + 16;  // y and B tiles, bytes
  static constexpr int kZPitch = R * 2 + 16;
  alignas(16) unsigned char y[kTcRows * kYPitch];
  alignas(16) unsigned char b[R * kYPitch];
  alignas(16) unsigned char z[kTcRows * kZPitch];
};

// grid (column tiles of every target, row tiles, B), 4 warps x 16 rows of
// a 64 x 128 output tile: w = z . B_t[slot] in one k-step per 16 of r,
// then the scaled add in place in the staged y tile, stored back by
// 16-byte vectors.
template <int R>
__global__ void __launch_bounds__(kTcThreads) tc_expand_kernel(Params p) {
  using S = TcExpandSmem<R>;
  __shared__ S s;
  const int tile = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int ct = blockIdx.x;
  const int t = tile_target(p, kTcCols, &ct);
  const Target tg = target(p, t);
  const int slot = p.ids[b];
  if (slot == 0) return;
  const int m0 = tile * kTcRows, col0 = ct * kTcCols;
  bf16* y = static_cast<bf16*>(p.y) + (size_t)b * p.seq * p.g.width + tg.offset;
  const bf16* bm = static_cast<const bf16*>(tg.b) + (size_t)slot * R * tg.d_out;

  // Before the dependency wait: y's tile and B's tile (neither is written
  // by the shrink). Rows and columns past the ends read as zeros.
  for (int c = tid; c < kTcRows * (kTcCols / 8); c += kTcThreads) {
    const int r = c / (kTcCols / 8), ch = c % (kTcCols / 8);
    const int row = m0 + r, col = col0 + ch * 8;
    const bool ok = row < p.seq && col < tg.d_out;
    sm90::cp_async16(s.y + r * S::kYPitch + ch * 16,
                     ok ? y + (size_t)row * p.g.width + col : y, ok);
  }
  for (int c = tid; c < R * (kTcCols / 8); c += kTcThreads) {
    const int j = c / (kTcCols / 8), ch = c % (kTcCols / 8);
    const int col = col0 + ch * 8;
    const bool ok = col < tg.d_out;
    sm90::cp_async16(s.b + j * S::kYPitch + ch * 16,
                     ok ? bm + (size_t)j * tg.d_out + col : bm, ok);
  }
  sm90::cp_async_commit();
  griddep_wait();
  // z of the tile's rows (this target's r columns): the shrink's partials
  // summed in split order, 8 splits' loads in flight, rounded to bf16.
  const size_t stride = p.n / 4;  // float4 per split
  for (int e = tid; e < kTcRows * (R / 4); e += kTcThreads) {
    const int r = e / (R / 4), c = (e % (R / 4)) * 4;
    float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + r < p.seq) {
      const float4* src = reinterpret_cast<const float4*>(
          p.part + ((size_t)b * p.seq + m0 + r) * p.splits * p.n + t * R + c);
      for (int k0 = 0; k0 < p.splits; k0 += 8) {
        float4 v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (k0 + i < p.splits) v[i] = __ldcg(src + (k0 + i) * stride);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (k0 + i < p.splits) {
            z.x += v[i].x; z.y += v[i].y; z.z += v[i].z; z.w += v[i].w;
          }
      }
    }
    uint2 packed;
    packed.x = sm90::pack_bf16(z.x, z.y);
    packed.y = sm90::pack_bf16(z.z, z.w);
    *reinterpret_cast<uint2*>(s.z + r * S::kZPitch + c * 2) = packed;
  }
  sm90::cp_async_wait<0>();
  __syncthreads();

  float acc[kTcCols / 8][4];
#pragma unroll
  for (int n = 0; n < kTcCols / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int k = 0; k < R; k += 16)
    mma_rows16<kTcCols>(acc, s.z + warp * 16 * S::kZPitch, S::kZPitch, s.b,
                        S::kYPitch, k, lane);

  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    unsigned char* row = s.y + (warp * 16 + g + 8 * h) * S::kYPitch;
#pragma unroll
    for (int n = 0; n < kTcCols / 8; ++n) {
      __nv_bfloat162* cell =
          reinterpret_cast<__nv_bfloat162*>(row + (8 * n + 2 * q) * 2);
      const float2 yv = __bfloat1622float2(*cell);
      *cell = __floats2bfloat162_rn(
          yv.x + round_to<bf16>(round_to<bf16>(acc[n][2 * h]) * p.g.scale),
          yv.y + round_to<bf16>(round_to<bf16>(acc[n][2 * h + 1]) * p.g.scale));
    }
  }
  __syncthreads();
  for (int c = tid; c < kTcRows * (kTcCols / 8); c += kTcThreads) {
    const int r = c / (kTcCols / 8), ch = c % (kTcCols / 8);
    const int row = m0 + r, col = col0 + ch * 8;
    if (row < p.seq && col < tg.d_out)
      *reinterpret_cast<uint4*>(y + (size_t)row * p.g.width + col) =
          *reinterpret_cast<const uint4*>(s.y + r * S::kYPitch + ch * 16);
  }
}

// ------------------------------------------------------------- host side

// Every width and offset a multiple of v elements: rows start on 16
// bytes when v elements are 16 bytes.
bool aligned_to(const GroupDesc& g, int v) {
  if (g.d_in % v || g.width % v) return false;
  for (int t = 0; t < g.targets; ++t)
    if (g.t[t].d_out % v || g.t[t].offset % v) return false;
  return true;
}

bool tensor_core_route(const GroupDesc& g, int seq) {
  return g.dtype == 1 && seq >= kTcMinRows && g.rank >= 16 &&
         aligned_to(g, 8);
}

// The IN split of a call: a function of (dtype, r, T) and the static
// widths, never of B or the ids.
struct Plan {
  bool tc;
  int splits, split_len, tiles;
};

Plan plan_of(const GroupDesc& g, int seq) {
  Plan pl;
  pl.tc = tensor_core_route(g, seq);
  if (pl.tc) {
    pl.tiles = (seq + kTcRows - 1) / kTcRows;
    int s = (kTcBlocks + pl.tiles - 1) / pl.tiles;
    const int most = g.d_in / kTcMinSplit > 1 ? g.d_in / kTcMinSplit : 1;
    s = s < 1 ? 1 : (s > most ? most : s);
    const int len = (g.d_in + s - 1) / s;
    pl.split_len = (len + kTcK - 1) / kTcK * kTcK;
  } else {
    pl.tiles = (seq + kCcTileRows - 1) / kCcTileRows;
    pl.split_len = kCcSplit;
  }
  pl.splits = (g.d_in + pl.split_len - 1) / pl.split_len;
  return pl;
}

size_t align256(size_t n) { return (n + 255) / 256 * 256; }

size_t part_bytes(const GroupDesc& g, const Plan& pl, int batch, int seq) {
  return align256((size_t)batch * seq * pl.splits * g.targets * g.rank * 4);
}

cudaError_t launch(void (*kernel)(Params), dim3 grid, int threads, int smem,
                   cudaStream_t stream, bool dependent, const Params& p) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

int column_tiles(const GroupDesc& g, int span) {
  int n = 0;
  for (int t = 0; t < g.targets; ++t) n += (g.t[t].d_out + span - 1) / span;
  return n;
}

// The shrink's ring is past the default 48 KB of shared memory: its
// attribute is set before every launch (the current device's).
template <int R, int NT>
cudaError_t tc_shrink(const Params& p, int batch, cudaStream_t s) {
  constexpr int kSmem = TcShrinkSmem<R * NT>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      tc_shrink_kernel<R, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return err;
  return launch(tc_shrink_kernel<R, NT>, dim3(p.splits, p.tiles, batch),
                kTcThreads, kSmem, s, false, p);
}

template <int R>
cudaError_t run_tc(const Params& p, int batch, cudaStream_t s) {
  cudaError_t err;
  switch (p.g.targets) {
    case 1: err = tc_shrink<R, 1>(p, batch, s); break;
    case 2: err = tc_shrink<R, 2>(p, batch, s); break;
    default: err = tc_shrink<R, 3>(p, batch, s); break;
  }
  if (err != cudaSuccess) return err;
  return launch(tc_expand_kernel<R>,
                dim3(column_tiles(p.g, kTcCols), p.tiles, batch), kTcThreads,
                0, s, true, p);
}

template <typename T, int R, int VEC>
cudaError_t run_cc(const Params& p, int batch, cudaStream_t s) {
  const dim3 grid(p.splits, p.tiles, batch);
  cudaError_t err;
  if (R <= 16 && p.seq > 1)
    err = launch(cc_shrink_kernel<T, R, (R <= 16 ? 4 : 1), VEC>, grid,
                 kCcThreads, 0, s, false, p);
  else
    err = launch(cc_shrink_kernel<T, R, 1, VEC>, grid, kCcThreads, 0, s,
                 false, p);
  if (err != cudaSuccess) return err;
  return launch(cc_expand_kernel<T, R, VEC>,
                dim3(column_tiles(p.g, kCcExpandThreads * VEC), p.tiles,
                     batch),
                kCcExpandThreads, 0, s, true, p);
}

template <typename T, int R>
cudaError_t run_cc_aligned(const Params& p, int batch, cudaStream_t s,
                           bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  return vec ? run_cc<T, R, kVec>(p, batch, s) : run_cc<T, R, 1>(p, batch, s);
}

template <typename T>
cudaError_t run_cc_rank(const Params& p, int batch, cudaStream_t s, bool vec) {
  switch (p.g.rank) {
    case 8: return run_cc_aligned<T, 8>(p, batch, s, vec);
    case 16: return run_cc_aligned<T, 16>(p, batch, s, vec);
    case 32: return run_cc_aligned<T, 32>(p, batch, s, vec);
    case 64: return run_cc_aligned<T, 64>(p, batch, s, vec);
    default: return cudaErrorInvalidValue;
  }
}

bool valid(const GroupDesc* g) {
  if (g == nullptr || g->targets < 1 || g->targets > kMaxTargets ||
      g->d_in <= 0 || g->width <= 0 || (g->dtype != 0 && g->dtype != 1))
    return false;
  if (g->rank != 8 && g->rank != 16 && g->rank != 32 && g->rank != 64)
    return false;
  for (int t = 0; t < g->targets; ++t)
    if (g->t[t].d_out <= 0 || g->t[t].offset < 0 ||
        g->t[t].offset + g->t[t].d_out > g->width)
      return false;
  return true;
}

}  // namespace

// Workspace of a call: `scratch` bytes (the fp32 partials). Returns 0, or
// a cudaError_t for a bad descriptor.
extern "C" int fused_lora_workspace(const GroupDesc* g, int batch, int seq,
                                    long long* scratch) {
  if (!valid(g) || batch <= 0 || seq <= 0) return (int)cudaErrorInvalidValue;
  *scratch = (long long)part_bytes(*g, plan_of(*g, seq), batch, seq);
  return 0;
}

// The route a call takes: 1 tensor cores, 0 CUDA cores; and its IN split.
extern "C" int fused_lora_plan(const GroupDesc* g, int seq, int* splits) {
  if (!valid(g) || seq <= 0) return -1;
  const Plan pl = plan_of(*g, seq);
  *splits = pl.splits;
  return pl.tc ? 1 : 0;
}

// C entry. y[b, :, off_t : off_t + d_out_t] += scale * (x[b] . A_t[ids[b]])
// . B_t[ids[b]] for every target t of the group, rounded as the eager
// composition rounds. x (B, T, d_in) and y (B, T, width) contiguous in the
// group's dtype, 16-byte aligned; ids (B,) int32 in [0, slots); scratch
// as fused_lora_workspace says. Two launches on `stream`. Returns a
// cudaError_t (0 = launched).
extern "C" int fused_lora_group(const GroupDesc* g, const void* x,
                                const void* ids, void* y, void* scratch,
                                int batch, int seq, void* stream) {
  if (!valid(g) || batch <= 0 || seq <= 0 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const Plan pl = plan_of(*g, seq);
  Params p;
  p.g = *g;
  p.x = x;
  p.ids = static_cast<const int*>(ids);
  p.y = y;
  p.part = static_cast<float*>(scratch);
  p.seq = seq;
  p.splits = pl.splits;
  p.split_len = pl.split_len;
  p.tiles = pl.tiles;
  p.n = g->targets * g->rank;
  const bool vec = aligned_to(*g, g->dtype == 1 ? 8 : 4);
  if (vec && ((uintptr_t)x % 16 || (uintptr_t)y % 16))
    return (int)cudaErrorMisalignedAddress;
  cudaGetLastError();  // clear a stale error: the result speaks of this call
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (pl.tc) {
    switch (g->rank) {
      case 16: err = run_tc<16>(p, batch, s); break;
      case 32: err = run_tc<32>(p, batch, s); break;
      default: err = run_tc<64>(p, batch, s); break;
    }
  } else if (g->dtype == 1) {
    err = run_cc_rank<bf16>(p, batch, s, vec);
  } else {
    err = run_cc_rank<float>(p, batch, s, vec);
  }
  return (int)err;
}
