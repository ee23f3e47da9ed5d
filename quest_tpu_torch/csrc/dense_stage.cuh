// The dense stage shared by the layer kernel and the fused Kraus kernel.
//
// A tile of tile_rows x 128 amplitudes of one state sits in shared memory
// as two planes (sre, sim). stage_dense<T, J> replaces, in place, every
// group of 2^J rows (J row bits packed with the 128 lanes into a
// dim = 128 << J axis) by the complex product M v, where the operator M is
// read from global memory stored TRANSPOSED (op[e * dim + o] = M[o][e]),
// real part and imaginary part in two arrays. Outputs are multiplied by
// `scale` (1 in the layer kernel; the Kraus kernel's 1/sqrt(p_j)) and
// written only to groups whose global row passes the row condition.
//
// Work split: a warp owns up to four groups at once (each operator element
// it loads serves all of them), thread `lane` accumulates output columns
// lane, lane + 32, ...; each warp reads all inputs of its groups before it
// writes any output, and the groups of different warps are disjoint, so no
// second shared-memory buffer is needed. FMA loops on the CUDA cores, the
// operator L2-resident (a 128 x 128 complex float32 operator is 128 KiB).
//
// stage_dense_fast<J> is the FAST tier's form of the same stage (float32
// tiles only), the TPU kernel's bf16-split products
// (quest_tpu/ops/pallas_kernels.py:237-260, 339-355) on the bf16 tensor
// cores: each input splits into hi = bf16(v) and lo = bf16(v - hi), the
// operator is bf16 (rounded on the host), and the four real products of
// each part accumulate in float32 (nvcuda::wmma 16x16x16 bf16 fragments).
// bf16 products are exact in float32, so the stage differs from the plain
// version's (rr_h - ii_h) + (rr_l - ii_l) only in the order of the sums.
// A fragment covers 16 groups and 16 output columns, and the 8 warps of
// the block split a group's dim outputs, so no warp can own its groups'
// inputs as the CUDA-core stage does. Instead the stage walks the tile in
// chunks of 16 groups: all threads gather a chunk's inputs (groups of
// rows strided by the packed row bits, as combo_offset addresses them)
// into bf16 hi/lo planes in shared memory, synchronise, and every warp
// then computes its output fragments from those copies and scatters them
// into the float32 tile, which no longer holds an input anyone reads.
// Shared memory beside the tile: 4 x 16 x (dim + 8) bf16 (65 KiB at
// dim = 512) plus one 16 x 16 float32 output pair per warp (16 KiB).
// What bounds this simple form: every chunk streams the whole bf16
// operator from L2 (4 * dim^2 bytes per 16 groups, 64 bytes per amplitude
// at dim = 512, four times the state's own HBM traffic), with one block of
// 8 warps per SM to hide it; the packed stages run far above their
// tensor-core bound (PERF.md). Larger chunks and wgmma with the operator
// in shared memory are the next steps.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace quest {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int bit_at(long long packed, int i) {
  return static_cast<int>((packed >> (8 * i)) & 0xff);
}

// Spread the bits of g over the positions that are not in the (ascending)
// packed bit list, leaving zeros at the listed positions.
__device__ __forceinline__ int insert_zeros(int g, long long packed, int k) {
  for (int i = 0; i < k; ++i) {
    const int low = (1 << bit_at(packed, i)) - 1;
    g = ((g & ~low) << 1) | (g & low);
  }
  return g;
}

// Row offset of combination m of the listed row bits (bit t of m sets
// row bit bits[t]).
__device__ __forceinline__ int combo_offset(int m, long long packed, int k) {
  int r = 0;
  for (int t = 0; t < k; ++t) {
    if ((m >> t) & 1) r |= 1 << bit_at(packed, t);
  }
  return r;
}

template <typename T, int J>
__device__ void stage_dense(T* sre, T* sim, int tile_rows, long long base_row,
                            long long packed, const T* __restrict__ op_re,
                            const T* __restrict__ op_im, long long row_mask,
                            long long row_want, T scale) {
  constexpr int kDim = kLanes << J;
  constexpr int kOut = kDim / 32;  // outputs per thread per group
  constexpr int kGroups = 4 >> J;  // groups per warp pass
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int groups = tile_rows >> J;

  for (int g0 = warp * kGroups; g0 < groups; g0 += kWarps * kGroups) {
    int row0[kGroups];
    bool active[kGroups];
#pragma unroll
    for (int n = 0; n < kGroups; ++n) {
      active[n] = g0 + n < groups;
      row0[n] = active[n] ? insert_zeros(g0 + n, packed, J) : 0;
    }
    T acc_re[kGroups][kOut];
    T acc_im[kGroups][kOut];
#pragma unroll
    for (int n = 0; n < kGroups; ++n) {
#pragma unroll
      for (int i = 0; i < kOut; ++i) {
        acc_re[n][i] = T(0);
        acc_im[n][i] = T(0);
      }
    }
#pragma unroll 2
    for (int e = 0; e < kDim; ++e) {
      const int roff = combo_offset(e >> 7, packed, J);
      const int l = e & (kLanes - 1);
      T xr[kGroups], xi[kGroups];
#pragma unroll
      for (int n = 0; n < kGroups; ++n) {
        const int idx = ((row0[n] | roff) << 7) | l;
        xr[n] = active[n] ? sre[idx] : T(0);
        xi[n] = active[n] ? sim[idx] : T(0);
      }
      const T* wr = op_re + static_cast<size_t>(e) * kDim + lane;
      const T* wi = op_im + static_cast<size_t>(e) * kDim + lane;
#pragma unroll
      for (int i = 0; i < kOut; ++i) {
        const T a = __ldg(wr + 32 * i);
        const T b = __ldg(wi + 32 * i);
#pragma unroll
        for (int n = 0; n < kGroups; ++n) {
          acc_re[n][i] = fma(xr[n], a, fma(-xi[n], b, acc_re[n][i]));
          acc_im[n][i] = fma(xr[n], b, fma(xi[n], a, acc_im[n][i]));
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int n = 0; n < kGroups; ++n) {
      if (!active[n]) continue;
      if (row_mask && ((base_row + row0[n]) & row_mask) != row_want) continue;
#pragma unroll
      for (int i = 0; i < kOut; ++i) {
        // output column o = lane + 32 i lies in row combination i / 4
        const int o = lane + 32 * i;
        const int idx = ((row0[n] | combo_offset(i >> 2, packed, J)) << 7)
                        | (o & (kLanes - 1));
        sre[idx] = acc_re[n][i] * scale;
        sim[idx] = acc_im[n][i] * scale;
      }
    }
    __syncwarp();
  }
}

// Groups per FAST chunk (a fragment's rows), the float32 scratch each
// warp stages its output fragment pair in, and the padding of each staged
// bf16 row: a row of 128 << J values is a multiple of 256 bytes, so
// without it the 16 rows a fragment load reads would all fall in one
// shared-memory bank.
constexpr int kFastChunk = 16;
constexpr int kFastOutFloats = 2 * 16 * 16;
constexpr int kFastPad = 8;

// Shared memory of a FAST stage's scratch: the output pairs of every warp,
// then the bf16 hi/lo copies of one chunk of a dense stage on up to
// max_j row bits.
__host__ __device__ constexpr size_t fast_scratch_bytes(int max_j) {
  return static_cast<size_t>(kWarps) * kFastOutFloats * sizeof(float)
         + 4 * static_cast<size_t>(kFastChunk)
               * ((kLanes << max_j) + kFastPad) * sizeof(__nv_bfloat16);
}

template <int J>
__device__ void stage_dense_fast(float* sre, float* sim, float* scratch,
                                 int tile_rows, long long base_row,
                                 long long packed,
                                 const __nv_bfloat16* __restrict__ op_re,
                                 const __nv_bfloat16* __restrict__ op_im,
                                 long long row_mask, long long row_want) {
  using namespace nvcuda;
  constexpr int kDim = kLanes << J;
  constexpr int kLd = kDim + kFastPad;        // staged row stride
  constexpr int kPlane = kFastChunk * kLd;    // bf16 values per copy
  constexpr int kFrags = kDim / 16 / kWarps;  // output fragments per warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int groups = tile_rows >> J;
  float* out_re = scratch + warp * kFastOutFloats;
  float* out_im = out_re + 16 * 16;
  __nv_bfloat16* hre =
      reinterpret_cast<__nv_bfloat16*>(scratch + kWarps * kFastOutFloats);
  __nv_bfloat16* him = hre + kPlane;
  __nv_bfloat16* lre = hre + 2 * kPlane;
  __nv_bfloat16* lim = hre + 3 * kPlane;

  for (int c0 = 0; c0 < groups; c0 += kFastChunk) {
    // the chunk's inputs, split: row r of a copy is group c0 + r
    for (int i = threadIdx.x; i < kFastChunk * kDim; i += kThreads) {
      const int r = i / kDim;
      const int e = i & (kDim - 1);
      const int g = c0 + r;
      const int at = r * kLd + e;
      float vr = 0.0f, vi = 0.0f;
      if (g < groups) {
        const int idx = ((insert_zeros(g, packed, J)
                          | combo_offset(e >> 7, packed, J)) << 7)
                        | (e & (kLanes - 1));
        vr = sre[idx];
        vi = sim[idx];
      }
      const __nv_bfloat16 hr = __float2bfloat16_rn(vr);
      const __nv_bfloat16 hi = __float2bfloat16_rn(vi);
      hre[at] = hr;
      him[at] = hi;
      lre[at] = __float2bfloat16_rn(vr - __bfloat162float(hr));
      lim[at] = __float2bfloat16_rn(vi - __bfloat162float(hi));
    }
    __syncthreads();
    for (int f = 0; f < kFrags; ++f) {
      const int o0 = (warp * kFrags + f) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_re, acc_im;
      wmma::fill_fragment(acc_re, 0.0f);
      wmma::fill_fragment(acc_im, 0.0f);
      for (int e0 = 0; e0 < kDim; e0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a_hr, a_hi, a_lr, a_li;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b_re, b_im, b_nim;
        wmma::load_matrix_sync(a_hr, hre + e0, kLd);
        wmma::load_matrix_sync(a_hi, him + e0, kLd);
        wmma::load_matrix_sync(a_lr, lre + e0, kLd);
        wmma::load_matrix_sync(a_li, lim + e0, kLd);
        // the operator is stored transposed: rows e, columns o
        const size_t off = static_cast<size_t>(e0) * kDim + o0;
        wmma::load_matrix_sync(b_re, op_re + off, kDim);
        wmma::load_matrix_sync(b_im, op_im + off, kDim);
        for (int t = 0; t < b_im.num_elements; ++t) {
          b_nim.x[t] = __hneg(b_im.x[t]);
        }
        // re += hr Mr - hi Mi + lr Mr - li Mi; im += hr Mi + hi Mr + ...
        wmma::mma_sync(acc_re, a_hr, b_re, acc_re);
        wmma::mma_sync(acc_re, a_hi, b_nim, acc_re);
        wmma::mma_sync(acc_re, a_lr, b_re, acc_re);
        wmma::mma_sync(acc_re, a_li, b_nim, acc_re);
        wmma::mma_sync(acc_im, a_hr, b_im, acc_im);
        wmma::mma_sync(acc_im, a_hi, b_re, acc_im);
        wmma::mma_sync(acc_im, a_lr, b_im, acc_im);
        wmma::mma_sync(acc_im, a_li, b_re, acc_im);
      }
      wmma::store_matrix_sync(out_re, acc_re, 16, wmma::mem_row_major);
      wmma::store_matrix_sync(out_im, acc_im, 16, wmma::mem_row_major);
      __syncwarp();
      for (int t = lane; t < 16 * 16; t += 32) {
        const int g = c0 + (t >> 4);
        if (g >= groups) continue;
        const int r0 = insert_zeros(g, packed, J);
        if (row_mask && ((base_row + r0) & row_mask) != row_want) continue;
        const int o = o0 + (t & 15);
        const int idx = ((r0 | combo_offset(o >> 7, packed, J)) << 7)
                        | (o & (kLanes - 1));
        sre[idx] = out_re[t];
        sim[idx] = out_im[t];
      }
      __syncwarp();
    }
    // the next chunk's gather overwrites the copies
    __syncthreads();
  }
}

// One coalesced copy of a tile of both planes between global and shared
// memory: 16-byte vectors, neighbouring threads on neighbouring addresses.
template <typename T>
__device__ __forceinline__ void copy_tile(T* dst_re, T* dst_im,
                                          const T* src_re, const T* src_im,
                                          int tile_rows) {
  const int nvec = tile_rows * kLanes * static_cast<int>(sizeof(T)) / 16;
  const uint4* sr = reinterpret_cast<const uint4*>(src_re);
  const uint4* si = reinterpret_cast<const uint4*>(src_im);
  uint4* dr = reinterpret_cast<uint4*>(dst_re);
  uint4* di = reinterpret_cast<uint4*>(dst_im);
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    dr[i] = sr[i];
    di[i] = si[i];
  }
}

}  // namespace quest
