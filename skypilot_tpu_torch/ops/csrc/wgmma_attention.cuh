// The grouped-head wgmma / TMA mainloop parts shared by the flash-attention
// forward and dQ kernels (flash_attention.cu) and the ring chunk update
// (ring_attention.cu): a work tile of 128 grouped query rows (positions x
// the n_rep heads of one KV head), its shared memory, the producer warp
// that loads the tile's Q once and streams 64-key K/V tiles through a ring
// of stages by TMA, the wgmma issue helpers, and the host side that
// encodes the tensor maps and sizes the grid. See flash_attention.cu's
// note on the bf16 kernels for the design.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace sm90 {

constexpr int kRows = 128;          // grouped query rows per work tile
constexpr int kKeys = 64;           // keys per streamed K/V tile
constexpr int kConsumerWarps = 8;   // two warpgroups of 64 rows
constexpr float kLog2e = 1.4426950408889634f;

// kQBufs grouped 128-row tiles (Q; Q and dO), one staging tile (O or dQ),
// kStages K/V tiles.
template <int D, int kStages, int kQBufs>
struct QSmem {
  static constexpr int kChunks = D / 64;
  alignas(1024) __nv_bfloat16 q[kQBufs][kChunks][kRows * 64];
  alignas(1024) __nv_bfloat16 o[kChunks][kRows * 64];
  alignas(1024) __nv_bfloat16 k[kStages][kChunks][kKeys * 64];
  alignas(1024) __nv_bfloat16 v[kStages][kChunks][kKeys * 64];
  uint64_t q_full, q_empty, k_full[kStages], v_full[kStages], empty[kStages];
};

// The producer (one thread): per work tile its grouped Q (and dO) once,
// then its K/V tiles [t_lo, t_hi) through the ring. Work(w, p) names the
// tile (b, kvh, q0, t_lo, t_hi); p gives positions and n_rep.
template <typename Work, int D, int kStages, int kQBufs, typename Params>
__device__ void produce_q_work(QSmem<D, kStages, kQBufs>& sm,
                               const CUtensorMap* tq, const CUtensorMap* tdo,
                               const CUtensorMap* tk, const CUtensorMap* tv,
                               const Params& p, int n_work) {
  constexpr int kChunks = D / 64;
  constexpr uint32_t kTileBytes = kChunks * kKeys * 128;
  int it = 0;                               // K/V tiles issued
  for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
    const Work wk(w, p);
    if (n > 0) mbar_wait(&sm.q_empty, (n - 1) & 1);
    mbar_expect_tx(&sm.q_full, kQBufs * kChunks * p.positions * p.n_rep * 128);
    for (int i = 0; i < kQBufs; ++i) {
      for (int c = 0; c < kChunks; ++c) {
        tma_load_4d(sm.q[i][c], i == 0 ? tq : tdo, &sm.q_full, 64 * c,
                    wk.kvh * p.n_rep, wk.q0, wk.b);
      }
    }
    for (int t = wk.t_lo; t < wk.t_hi; ++t, ++it) {
      const int s = it % kStages;
      if (it >= kStages) mbar_wait(&sm.empty[s], (it / kStages - 1) & 1);
      mbar_expect_tx(&sm.k_full[s], kTileBytes);
      for (int c = 0; c < kChunks; ++c) {
        tma_load_4d(sm.k[s][c], tk, &sm.k_full[s], 64 * c, wk.kvh, t * kKeys,
                    wk.b);
      }
      mbar_expect_tx(&sm.v_full[s], kTileBytes);
      for (int c = 0; c < kChunks; ++c) {
        tma_load_4d(sm.v[s][c], tv, &sm.v_full[s], 64 * c, wk.kvh, t * kKeys,
                    wk.b);
      }
    }
  }
}

template <int D, int kStages, int kQBufs>
__device__ __forceinline__ void init_q_barriers(QSmem<D, kStages, kQBufs>& sm) {
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    mbar_init(&sm.q_empty, kConsumerWarps);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

template <typename S>
__device__ __forceinline__ S& smem_at_1024() {
  extern __shared__ unsigned char smem_raw[];
  return *reinterpret_cast<S*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
}

// acc[64 x 64] = A.B^T over D, A's 64 rows at `a_rows` and B's at `b_rows`
// (chunk strides a_chunk, b_chunk bytes), both K-major in shared memory.
template <int D>
__device__ __forceinline__ void issue_ss(float (&acc)[32],
                                         const unsigned char* a_rows,
                                         int a_chunk,
                                         const unsigned char* b_rows,
                                         int b_chunk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = desc_sw128(
        a_rows + (kk / 4) * a_chunk + (kk % 4) * 32, 16, 1024);
    const uint64_t db = desc_sw128(
        b_rows + (kk / 4) * b_chunk + (kk % 4) * 32, 16, 1024);
    wgmma_m64n64_ss(acc, da, db, kk > 0);
  }
}

// acc[64 x D] += A.B, A a 64 x 64 register fragment (bf16 pairs), B 64
// rows x D in shared memory, MN-major (chunk stride b_chunk bytes).
template <int D>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2],
                                         const uint32_t (&a)[4][4],
                                         const unsigned char* b_rows,
                                         int b_chunk) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = desc_sw128(b_rows + kk * 2048, b_chunk, 1024);
    if constexpr (D == 64) {
      wgmma_m64n64_rs(acc, a[kk], db);
    } else {
      wgmma_m64n128_rs(acc, a[kk], db);
    }
  }
}

// A 64 x 64 fp32 accumulator rounded to bf16 pairs: the register-A
// fragments of the next product.
__device__ __forceinline__ void pack_a(uint32_t (&f)[4][4],
                                       const float (&acc)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    f[j / 2][(j % 2) * 2] = pack_bf16(acc[4 * j], acc[4 * j + 1]);
    f[j / 2][(j % 2) * 2 + 1] = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

__device__ __forceinline__ void warp_arrive(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
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
inline bool encode_bshd(CUtensorMap* map, const void* base, int d, int heads,
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

// Grid of a kernel that walks work tiles: one block per SM (persistent),
// or one per work tile.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem, int n_work, bool persistent,
                    int* grid) {
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  *grid = persistent && sms < n_work ? sms : n_work;
  return err;
}

}  // namespace sm90
