// Fused gate-layer kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// quest_tpu/ops/pallas_kernels.py `_layer_kernel`, reached through
// `apply_layer` and, with its batch grid, `apply_layer_batched`: one launch
// applies a whole fused layer (an ordered list of stages, see
// quest_tpu_torch/ops/layer_kernel.py) to a batch of B states, each held as
// split re/im planes viewed as (rows, 128). State b's re plane starts
// b * state_stride elements after state 0's, its im plane likewise; the
// unbatched entry is the B = 1 case.
//
// What bounds it on the card. A layer moves 2 planes x (read + write) x
// itemsize x 2^n bytes of HBM, however many gates it holds: 16 B per
// amplitude at float32, 5.1 ms for 2^30 amplitudes at 3.35 TB/s. The dense
// stages (lane/clane: a 128x128 complex operator; rowmxu: (2^j*128)^2) also
// cost 8 * dim real flops per amplitude, so a lane stage alone is
// 8 * 128 * 2^30 = 1.1e12 flops, 16 ms at the 67 TFLOP/s float32 CUDA-core
// rate: dense stages make a layer bound by operations, the others by bytes.
//
// How the design answers that. Each block owns a disjoint tile of
// tile_rows x 128 amplitudes (128 rows at float32, 64 at float64: 128 KiB
// of dynamic shared memory for both planes). It reads the tile from HBM
// once, runs every stage on it in shared memory, and writes it back once,
// so a layer of L gates costs one state pass, not L. Tiles are disjoint
// and each block touches only its own, so updating the planes in place is
// safe. Inside a stage every amplitude is owned by one thread (row, rowk,
// rowdiag, and the lane stages' outputs) or one warp (full-precision rowmxu
// stages); an owner reads all its inputs into registers before it writes
// (the lane stages: every thread reads, one barrier, every thread writes),
// so no second shared-memory buffer is needed.
// The dense products are exact FMA loops on the CUDA cores. The lane and
// clane stages (stage_dense_lane, dense_stage.cuh) keep the whole tile's
// outputs in registers and stream their operator once per tile through a
// two-stage cp.async ring of 32 KiB K slabs beside the tile (64 KiB,
// lane_scratch_bytes, reserved by every full-precision launch: 192 KiB in
// all). The rowmxu stages (stage_dense<T, J>, J = 1, 2) read their
// operator from L2 through __ldg, each warp on up to 4 >> J rows at once.
// No tensor cores, no TMA.
//
// The FAST tier (quest_layer_apply_fast_f32; the TPU kernel's fast=True,
// pallas_kernels.py:237-260, 339-355) runs the dense stages on the bf16
// tensor cores instead (stage_dense_fast, dense_stage.cuh): the
// bf16-split form doubles the products, 16 * dim flops per amplitude, but
// at 989 TFLOP/s a 128-wide lane stage over 2^30 amplitudes is ~2.2 ms of
// operations, under the 5.1 ms HBM pass, so FAST is the tier at which a
// fused layer can be bound by bytes on this card. Its dense operators come
// from a second pool, in bf16; row, rowk and rowdiag stages stay float32.
// The tile stays 128 rows: a dense stage keeps its outputs in registers
// (the whole tile is one chunk) and streams its operator and its bf16
// inputs through a two-stage cp.async ring beside the tile, at most 72 KiB
// (fast_scratch_bytes of the layer's widest dense stage), 200 KiB in all.
//
// Stage descriptors: one row of 8 int64 per stage,
//   [tag, k_or_j, packed_bits, pool_offset, lane_mask, lane_want,
//    row_mask, row_want]
// with bit i of the stage in byte i of packed_bits and row masks in
// row-bit coordinates (bit p = qubit p + 7). Operands live in one pool of
// the plane dtype: each is its real part followed by its imaginary part.
//   DENSE   (lane, clane, rowmxu): j row bits packed with the lanes into a
//           dim = 128 << j axis; pool holds M^T (dim x dim); clane's row
//           condition is on the row index within the state.
//   ROWK    (row, rowk): dense 2^k x 2^k gate on k <= 3 row bits inside
//           the tile, under lane and row controls; pool holds U.
//   ROWDIAG (rowdiag): factor table (2^k, 128) picked by k <= 3 bits of
//           the row index within the state.
//
// Batch: block x = b * tiles_per_state + tile, so the grid never meets the
// 65535 cap of gridDim.y. Row coordinates stay per state: base_row is the
// tile's first row inside its own state, and every row mask, row want and
// rowdiag table addresses rows of that state, as in the TPU kernel's
// batched form (pallas_kernels.py:302-307). One descriptor and operand
// pool serve the whole batch.
//
// FAST descriptors are the same, but a dense stage's pool_offset indexes
// the bf16 pool (16-byte aligned), which holds M rounded to bf16 in the
// FAST stage's slab and fragment order (dense_stage.cuh stage_dense_fast).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o layer_kernel.so layer_kernel.cu
// The C entry points return cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_stage.cuh"

namespace {

using quest::bit_at;
using quest::combo_offset;
using quest::insert_zeros;
using quest::kLanes;
using quest::kThreads;

constexpr int kDescWidth = 8;

enum StageTag { kDense = 0, kRowK = 1, kRowDiag = 2 };

// Dense 2^K x 2^K gate on K row bits inside the tile; one thread owns one
// (group, lane) item and its 2^K amplitudes.
template <typename T, int K>
__device__ void stage_rowk(T* sre, T* sim, int tile_rows, long long base_row,
                           long long packed, const T* __restrict__ u_re,
                           const T* __restrict__ u_im, int lane_mask,
                           int lane_want, long long row_mask,
                           long long row_want) {
  constexpr int kDim = 1 << K;
  int offs[kDim];
#pragma unroll
  for (int m = 0; m < kDim; ++m) offs[m] = combo_offset(m, packed, K) << 7;
  const int items = (tile_rows >> K) * kLanes;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int l = it & (kLanes - 1);
    const int r0 = insert_zeros(it >> 7, packed, K);
    // controls never include the targets, so the condition read at the
    // group's first row holds for all of its rows
    if (lane_mask && (l & lane_mask) != lane_want) continue;
    if (row_mask && ((base_row + r0) & row_mask) != row_want) continue;
    const int base = (r0 << 7) | l;
    T vr[kDim], vi[kDim];
#pragma unroll
    for (int m = 0; m < kDim; ++m) {
      vr[m] = sre[base + offs[m]];
      vi[m] = sim[base + offs[m]];
    }
#pragma unroll
    for (int mp = 0; mp < kDim; ++mp) {
      T ar = T(0), ai = T(0);
#pragma unroll
      for (int m = 0; m < kDim; ++m) {
        const T cr = __ldg(u_re + mp * kDim + m);
        const T ci = __ldg(u_im + mp * kDim + m);
        ar = fma(cr, vr[m], fma(-ci, vi[m], ar));
        ai = fma(cr, vi[m], fma(ci, vr[m], ai));
      }
      sre[base + offs[mp]] = ar;
      sim[base + offs[mp]] = ai;
    }
  }
}

// Per-amplitude factor from a (2^k, 128) table row picked by k bits of the
// state's row index (any row bit, inside the tile or not).
template <typename T>
__device__ void stage_rowdiag(T* sre, T* sim, int tile_rows, long long base_row,
                              int k, long long packed,
                              const T* __restrict__ t_re,
                              const T* __restrict__ t_im) {
  const int n = tile_rows * kLanes;
  for (int it = threadIdx.x; it < n; it += kThreads) {
    const long long g = base_row + (it >> 7);
    int cfg = 0;
    for (int j = 0; j < k; ++j) {
      cfg |= static_cast<int>((g >> bit_at(packed, j)) & 1) << j;
    }
    const int t = cfg * kLanes + (it & (kLanes - 1));
    const T fr = __ldg(t_re + t);
    const T fi = __ldg(t_im + t);
    const T a = sre[it];
    const T b = sim[it];
    sre[it] = fma(a, fr, -b * fi);
    sim[it] = fma(a, fi, b * fr);
  }
}

template <typename T, bool Fast>
__global__ void __launch_bounds__(kThreads)
    layer_kernel(T* re, T* im, const long long* __restrict__ desc,
                 int n_stages, const T* __restrict__ pool,
                 const __nv_bfloat16* __restrict__ fast_pool, int tile_rows,
                 long long tiles_per_state, long long state_stride) {
  // 128-byte alignment: the FAST ring's cp.async and fragment loads need 16
  extern __shared__ __align__(128) unsigned char smem[];
  T* sre = reinterpret_cast<T*>(smem);
  T* sim = sre + tile_rows * kLanes;
  const long long state = blockIdx.x / tiles_per_state;
  const long long base_row = (blockIdx.x % tiles_per_state) * tile_rows;
  const size_t first = static_cast<size_t>(state * state_stride
                                           + base_row * kLanes);

  // one read of the tile
  quest::copy_tile(sre, sim, re + first, im + first, tile_rows);
  __syncthreads();

  for (int s = 0; s < n_stages; ++s) {
    const long long* d = desc + s * kDescWidth;
    const int tag = static_cast<int>(d[0]);
    const int kj = static_cast<int>(d[1]);
    const long long packed = d[2];
    const T* op = pool + d[3];
    const int lane_mask = static_cast<int>(d[4]);
    const int lane_want = static_cast<int>(d[5]);
    const long long row_mask = d[6];
    const long long row_want = d[7];
    if (tag == kDense) {
      if constexpr (Fast) {
        const __nv_bfloat16* f_ops = fast_pool + d[3];
        unsigned char* scratch =
            reinterpret_cast<unsigned char*>(sim + tile_rows * kLanes);
        if (kj == 0) {
          quest::stage_dense_fast<0>(sre, sim, scratch, tile_rows, base_row,
                                     packed, f_ops, row_mask, row_want);
        } else if (kj == 1) {
          quest::stage_dense_fast<1>(sre, sim, scratch, tile_rows, base_row,
                                     packed, f_ops, row_mask, row_want);
        } else {
          quest::stage_dense_fast<2>(sre, sim, scratch, tile_rows, base_row,
                                     packed, f_ops, row_mask, row_want);
        }
      } else {
        const size_t dim = static_cast<size_t>(kLanes) << kj;
        const T* op_im = op + dim * dim;
        if (kj == 0) {
          T* lane_ring = sim + tile_rows * kLanes;
          quest::stage_dense_lane<T>(sre, sim, lane_ring, tile_rows,
                                     base_row, op, op_im, row_mask, row_want,
                                     T(1));
        } else if (kj == 1) {
          quest::stage_dense<T, 1>(sre, sim, tile_rows, base_row, packed, op,
                                   op_im, row_mask, row_want, T(1));
        } else {
          quest::stage_dense<T, 2>(sre, sim, tile_rows, base_row, packed, op,
                                   op_im, row_mask, row_want, T(1));
        }
      }
    } else if (tag == kRowK) {
      const T* u_im = op + (1 << (2 * kj));
      if (kj == 1) {
        stage_rowk<T, 1>(sre, sim, tile_rows, base_row, packed, op, u_im,
                         lane_mask, lane_want, row_mask, row_want);
      } else if (kj == 2) {
        stage_rowk<T, 2>(sre, sim, tile_rows, base_row, packed, op, u_im,
                         lane_mask, lane_want, row_mask, row_want);
      } else {
        stage_rowk<T, 3>(sre, sim, tile_rows, base_row, packed, op, u_im,
                         lane_mask, lane_want, row_mask, row_want);
      }
    } else {
      stage_rowdiag<T>(sre, sim, tile_rows, base_row, kj, packed, op,
                       op + (kLanes << kj));
    }
    __syncthreads();
  }

  // one write of the tile
  quest::copy_tile(re + first, im + first, sre, sim, tile_rows);
}

template <typename T, bool Fast>
int launch(void* re, void* im, const void* desc, int n_stages,
           const void* pool, const void* fast_pool, int max_j,
           long long total_rows, int tile_rows, long long batch,
           long long state_stride, void* stream) {
  size_t smem = 2 * static_cast<size_t>(tile_rows) * kLanes * sizeof(T);
  if (Fast) {
    if (max_j < 0 || max_j > 2) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    smem += quest::fast_scratch_bytes(max_j);
  } else {
    smem += quest::lane_scratch_bytes(sizeof(T));
  }
  cudaGetLastError();  // an error left by earlier work is not this launch's
  cudaError_t err = cudaFuncSetAttribute(
      layer_kernel<T, Fast>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = total_rows / tile_rows;
  if (batch < 1 || batch * tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const unsigned blocks = static_cast<unsigned>(batch * tiles);
  layer_kernel<T, Fast><<<blocks, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(re), static_cast<T*>(im),
      static_cast<const long long*>(desc), n_stages,
      static_cast<const T*>(pool),
      static_cast<const __nv_bfloat16*>(fast_pool), tile_rows, tiles,
      state_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int quest_layer_apply_f32(void* re, void* im, const void* desc, int n_stages,
                          const void* pool, long long total_rows,
                          int tile_rows, long long batch,
                          long long state_stride, void* stream) {
  return launch<float, false>(re, im, desc, n_stages, pool, nullptr, 0,
                              total_rows, tile_rows, batch, state_stride,
                              stream);
}

int quest_layer_apply_f64(void* re, void* im, const void* desc, int n_stages,
                          const void* pool, long long total_rows,
                          int tile_rows, long long batch,
                          long long state_stride, void* stream) {
  return launch<double, false>(re, im, desc, n_stages, pool, nullptr, 0,
                               total_rows, tile_rows, batch, state_stride,
                               stream);
}

// The FAST tier: dense stages on the bf16 tensor cores, their operators
// from fast_pool; max_j (0..2) is the widest dense stage's row-bit count.
int quest_layer_apply_fast_f32(void* re, void* im, const void* desc,
                               int n_stages, const void* pool,
                               const void* fast_pool, int max_j,
                               long long total_rows, int tile_rows,
                               long long batch, long long state_stride,
                               void* stream) {
  return launch<float, true>(re, im, desc, n_stages, pool, fast_pool, max_j,
                             total_rows, tile_rows, batch, state_stride,
                             stream);
}

// Shared memory of the FAST ring beside the tile for a layer whose widest
// dense stage has max_j row bits (the Python side mirrors it).
long long quest_layer_fast_scratch_bytes(int max_j) {
  return static_cast<long long>(quest::fast_scratch_bytes(max_j));
}

// Shared memory of the full-precision lane stage's ring beside the tile,
// for planes of itemsize bytes (the Python side mirrors it).
long long quest_layer_lane_scratch_bytes(int itemsize) {
  return static_cast<long long>(quest::lane_scratch_bytes(itemsize));
}

const char* quest_layer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
