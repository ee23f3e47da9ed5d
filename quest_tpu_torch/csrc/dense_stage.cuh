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

#pragma once

#include <cuda_runtime.h>
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
