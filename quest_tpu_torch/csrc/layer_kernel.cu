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
// rowdiag, and the dense stages' outputs); an owner reads all its inputs
// into registers before it writes (the dense stages: every thread reads,
// one barrier, every thread writes), so no second shared-memory buffer is
// needed.
// The dense products are exact FMA loops on the CUDA cores. The lane and
// clane stages (stage_dense_lane, dense_stage.cuh) and the rowmxu stages
// (stage_dense_row<T, J>, J = 1, 2: dim = 128 << J) keep the whole tile's
// outputs in registers and stream their operator once per tile through a
// two-stage cp.async ring of 32 KiB K slabs beside the tile (64 KiB,
// lane_scratch_bytes, reserved by every full-precision launch: 192 KiB in
// all). No tensor cores, no TMA.
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
//           the row index within the state; lane_mask (d[4]) holds the
//           stages left in its run of consecutive rowdiag stages, itself
//           included, and the kernel applies the whole run in one pass
//           over the tile (stage_rowdiag_run).
//
// A layer of rowdiag stages only takes the streaming entry instead
// (quest_layer_diag_f32/_f64, layer_diag_kernel below): no tile, one read
// and one write of each amplitude straight from HBM.
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

#include <type_traits>

#include "dense_stage.cuh"

namespace {

using quest::bit_at;
using quest::combo_offset;
using quest::insert_zeros;
using quest::kLanes;
using quest::kThreads;
using quest::kWarps;

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

// ---- diagonal (rowdiag) stages --------------------------------------------
//
// A rowdiag stage multiplies each amplitude by a factor that depends only on
// its lane and on k <= 3 bits of its row index, so a run of them needs no
// other amplitude: one warp owns whole 128-lane rows, each lane 4 of a row's
// amplitudes in registers (float32: columns 4l..4l+3, one 16-byte vector per
// plane; float64: columns 2l, 2l+1 and 64+2l, 64+2l+1, two 16-byte vectors
// whose warp-wide reads are each 512 contiguous bytes). The row's config for
// each stage is warp-uniform, so lane j computes stage j's table row once per
// row (k shifts of the 64-bit row index) and every lane reads it by shuffle
// (diag_row).
// The stages multiply in stage order, each with the same complex product
// (cmul), in the tile kernel's runs and in the streaming entry alike, so the
// two give the same bits.

constexpr int kVecBytes = 16;

template <typename T>
struct Row4 {  // one lane's 4 amplitudes of a row, or 4 factors
  static constexpr int kVec = kVecBytes / static_cast<int>(sizeof(T));
  static constexpr int kVecs = 4 / kVec;
};

template <typename T>
__device__ __forceinline__ int row4_col(int q, int lane) {
  return (q * 32 + lane) * Row4<T>::kVec;
}

// v[0..3] = the lane's 4 values of the 128-wide row at p; Ldg reads through
// the read-only cache (tables in global memory).
template <typename T, bool Ldg>
__device__ __forceinline__ void load_row4(const T* p, int lane, T* v) {
#pragma unroll
  for (int q = 0; q < Row4<T>::kVecs; ++q) {
    const T* a = p + row4_col<T>(q, lane);
    if constexpr (sizeof(T) == 4) {
      const float4 x = Ldg ? __ldg(reinterpret_cast<const float4*>(a))
                           : *reinterpret_cast<const float4*>(a);
      v[0] = x.x;
      v[1] = x.y;
      v[2] = x.z;
      v[3] = x.w;
    } else {
      const double2 x = Ldg ? __ldg(reinterpret_cast<const double2*>(a))
                            : *reinterpret_cast<const double2*>(a);
      v[2 * q] = x.x;
      v[2 * q + 1] = x.y;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_row4(T* p, int lane, const T* v) {
#pragma unroll
  for (int q = 0; q < Row4<T>::kVecs; ++q) {
    T* a = p + row4_col<T>(q, lane);
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(a) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      *reinterpret_cast<double2*>(a) = make_double2(v[2 * q], v[2 * q + 1]);
    }
  }
}

// (a + ib) *= (fr + i fi), the one rounding order of every rowdiag product
template <typename T>
__device__ __forceinline__ void cmul(T& a, T& b, T fr, T fi) {
  const T re = fma(a, fr, -b * fi);
  b = fma(a, fi, b * fr);
  a = re;
}

// One rowdiag stage as a lane of the warp holds it: its row bits, the pool
// offset of its (2^k, 128) table's real part, and that table's size (the
// imaginary part follows).
struct DiagStage {
  int k;
  long long packed;
  long long table;
};

__device__ __forceinline__ DiagStage diag_stage(
    const long long* __restrict__ desc, int s, int n_stages) {
  DiagStage st{0, 0, 0};
  if (s < n_stages) {
    const long long* d = desc + s * kDescWidth;
    st.k = static_cast<int>(__ldg(d + 1));
    st.packed = __ldg(d + 2);
    st.table = __ldg(d + 3);
  }
  return st;
}

// Applies stages 0..n_stages-1 of `desc` (all rowdiag) to one lane's 4
// amplitudes of the row whose index within its state is g. A stage's table
// sits at tables + its pool offset. `first` is the lane's stage of
// the first chunk of 32 (stage `lane`), loaded once by the caller; later
// chunks, if any, load theirs per row.
template <typename T, bool Ldg>
__device__ __forceinline__ void diag_row(T* vr, T* vi, long long g,
                                         const long long* __restrict__ desc,
                                         int n_stages, const T* tables,
                                         int lane, const DiagStage& first) {
  for (int c0 = 0; c0 < n_stages; c0 += 32) {
    const DiagStage st = c0 == 0 ? first
                                 : diag_stage(desc, c0 + lane, n_stages);
    int cfg = 0;
    for (int j = 0; j < st.k; ++j) {
      cfg |= static_cast<int>((g >> bit_at(st.packed, j)) & 1) << j;
    }
    const long long row = st.table + static_cast<long long>(cfg) * kLanes;
    const int half = kLanes << st.k;
    const int count = min(32, n_stages - c0);
    for (int j = 0; j < count; ++j) {
      const T* f = tables + __shfl_sync(0xffffffffu, row, j);
      const int h = __shfl_sync(0xffffffffu, half, j);
      T fr[4], fi[4];
      load_row4<T, Ldg>(f, lane, fr);
      load_row4<T, Ldg>(f + h, lane, fi);
#pragma unroll
      for (int i = 0; i < 4; ++i) cmul(vr[i], vi[i], fr[i], fi[i]);
    }
  }
}

// A run of `run` consecutive rowdiag stages (descriptors from `desc`) as
// one pass over the tile in shared memory: each warp takes whole rows, one
// read and one write per amplitude, the run's tables read through __ldg.
// Not inlined: its values would otherwise be hoisted out of the kernel's
// stage loop and held across the lane stage, which has no register to spare.
template <typename T>
__device__ __noinline__ void stage_rowdiag_run(T* sre, T* sim, int tile_rows,
                                  long long base_row,
                                  const long long* __restrict__ desc, int run,
                                  const T* __restrict__ pool) {
  const int lane = threadIdx.x & 31;
  const DiagStage first = diag_stage(desc, lane, run);
  for (int r = threadIdx.x >> 5; r < tile_rows; r += kWarps) {
    T vr[4], vi[4];
    load_row4<T, false>(sre + r * kLanes, lane, vr);
    load_row4<T, false>(sim + r * kLanes, lane, vi);
    diag_row<T, true>(vr, vi, base_row + r, desc, run, pool, lane, first);
    store_row4<T>(sre + r * kLanes, lane, vr);
    store_row4<T>(sim + r * kLanes, lane, vi);
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
        T* lane_ring = sim + tile_rows * kLanes;
        if (kj == 0) {
          quest::stage_dense_lane<T>(sre, sim, lane_ring, tile_rows,
                                     base_row, op, op_im, row_mask, row_want,
                                     T(1));
        } else if (kj == 1) {
          quest::stage_dense_row<T, 1>(sre, sim, lane_ring, tile_rows,
                                       base_row, packed, op, op_im, row_mask,
                                       row_want, T(1));
        } else {
          quest::stage_dense_row<T, 2>(sre, sim, lane_ring, tile_rows,
                                       base_row, packed, op, op_im, row_mask,
                                       row_want, T(1));
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
      // d[4] of a rowdiag stage: the stages left in its run of consecutive
      // rowdiag stages, itself included; the run is one pass
      const int run = lane_mask > 1 ? lane_mask : 1;
      stage_rowdiag_run<T>(sre, sim, tile_rows, base_row, d, run, pool);
      s += run - 1;
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
  static quest::LaunchAttrs attrs;
  cudaError_t err = quest::ensure_dynamic_smem(layer_kernel<T, Fast>, attrs,
                                               smem);
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

// ---- the streaming entry for layers of rowdiag stages only ---------------
//
// Such a layer needs no tile: every amplitude's factors depend on its own
// row and lane. So it is one streaming pass over the planes, 16 B per
// amplitude at float32 (5.1 ms for 2^30 amplitudes at 3.35 TB/s), with no
// shared-memory tile and no lane ring, which would hold the SM to one
// block. Blocks of kThreads, as many as fit on each SM, walk the (state,
// row) pairs grid-stride, each warp kDiagRows rows at a time (both rows'
// loads in flight before either's products). The layer's tables (the whole
// pool of such a layer) are copied into shared memory once per block when
// they fit kDiagTableCap, else read through __ldg.

constexpr int kDiagRows = 2;
// 7 stages x 8 x 128 complex float64: the widest density-QFT layer
constexpr size_t kDiagTableCap = 112 * 1024;

// at most 64 registers a thread at float32 (4 blocks of 8 warps per SM),
// 128 at float64, whose tables take up to half the SM's shared memory.
// Four rows a warp at a time spill at float32 under 64 and 85 registers
template <typename T, bool SmemTables>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 4 : 2)
    layer_diag_kernel(T* re, T* im, const long long* __restrict__ desc,
                      int n_stages, const T* __restrict__ pool,
                      long long table_values, int rows_log2, long long rows,
                      long long state_stride) {
  // one declaration of the dynamic shared memory per translation unit
  extern __shared__ __align__(128) unsigned char smem[];
  const T* tables = pool;
  if constexpr (SmemTables) {
    uint4* dst = reinterpret_cast<uint4*>(smem);
    const uint4* src = reinterpret_cast<const uint4*>(pool);
    const int nvec = static_cast<int>(table_values * sizeof(T) / kVecBytes);
    for (int i = threadIdx.x; i < nvec; i += kThreads) dst[i] = __ldg(src + i);
    __syncthreads();
    tables = reinterpret_cast<const T*>(smem);
  }
  const int lane = threadIdx.x & 31;
  const DiagStage first = diag_stage(desc, lane, n_stages);
  const long long row_mask = (1LL << rows_log2) - 1;
  const long long step = static_cast<long long>(gridDim.x) * kWarps
                         * kDiagRows;
  for (long long r0 = (static_cast<long long>(blockIdx.x) * kWarps
                       + (threadIdx.x >> 5)) * kDiagRows;
       r0 < rows; r0 += step) {
    T vr[kDiagRows][4], vi[kDiagRows][4];
    size_t at[kDiagRows];
#pragma unroll
    for (int u = 0; u < kDiagRows; ++u) {
      const long long r = r0 + u;
      at[u] = static_cast<size_t>((r >> rows_log2) * state_stride
                                  + (r & row_mask) * kLanes);
      if (r < rows) {
        load_row4<T, false>(re + at[u], lane, vr[u]);
        load_row4<T, false>(im + at[u], lane, vi[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kDiagRows; ++u) {
      const long long r = r0 + u;
      if (r < rows) {
        diag_row<T, !SmemTables>(vr[u], vi[u], r & row_mask, desc, n_stages,
                                 tables, lane, first);
        store_row4<T>(re + at[u], lane, vr[u]);
        store_row4<T>(im + at[u], lane, vi[u]);
      }
    }
  }
}

template <typename T, bool SmemTables>
int launch_diag_instance(T* re, T* im, const long long* desc, int n_stages,
                         const T* pool, long long table_values, int rows_log2,
                         long long rows, long long state_stride,
                         cudaStream_t stream) {
  static quest::LaunchAttrs attrs;
  const size_t smem = SmemTables ? table_values * sizeof(T) : 0;
  auto* kernel = layer_diag_kernel<T, SmemTables>;
  cudaError_t err = quest::ensure_dynamic_smem(kernel, attrs, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long rows_per_block = static_cast<long long>(kWarps) * kDiagRows;
  const long long need = (rows + rows_per_block - 1) / rows_per_block;
  const long long full = static_cast<long long>(sms) * per_sm;
  const unsigned blocks = static_cast<unsigned>(need < full ? need : full);
  kernel<<<blocks, kThreads, smem, stream>>>(re, im, desc, n_stages, pool,
                                             table_values, rows_log2, rows,
                                             state_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_diag(void* re, void* im, const void* desc, int n_stages,
                const void* pool, long long pool_values, long long total_rows,
                long long batch, long long state_stride, void* stream) {
  cudaGetLastError();  // an error left by earlier work is not this launch's
  if (n_stages < 1 || batch < 1 || total_rows < 1
      || (total_rows & (total_rows - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int rows_log2 = 0;
  while ((1LL << rows_log2) < total_rows) ++rows_log2;
  auto* r = static_cast<T*>(re);
  auto* i = static_cast<T*>(im);
  auto* d = static_cast<const long long*>(desc);
  auto* p = static_cast<const T*>(pool);
  auto s = static_cast<cudaStream_t>(stream);
  if (static_cast<size_t>(pool_values) * sizeof(T) <= kDiagTableCap) {
    return launch_diag_instance<T, true>(r, i, d, n_stages, p, pool_values,
                                         rows_log2, batch * total_rows,
                                         state_stride, s);
  }
  return launch_diag_instance<T, false>(r, i, d, n_stages, p, pool_values,
                                        rows_log2, batch * total_rows,
                                        state_stride, s);
}

// ---- the MXU tile: one call packs the gate and launches ------------------
//
// apply_mxu_tile (pallas_kernels.py:813) is one rowmxu stage of a single
// dense gate. The host packs its geometry once (descriptor, and the map
// `index` from each operator-pool value to its source in [0, Re u, Im u]);
// a call uploads the gate's values to `source` on the device, then this one
// C call gathers them into the pool and launches the layer kernel, both on
// the caller's stream.

// pool[i] = source[index[i]] (rounded to bf16 for FAST: the values come as
// float32, so bf16 rounds through float32)
template <typename S, typename D>
__global__ void mxu_pool_gather(D* __restrict__ pool,
                                const int* __restrict__ index, long long n,
                                const S* __restrict__ source) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x; i < n; i += step) {
    const S x = __ldg(source + __ldg(index + i));
    if constexpr (std::is_same<D, __nv_bfloat16>::value) {
      pool[i] = __float2bfloat16_rn(x);
    } else {
      pool[i] = x;
    }
  }
}

template <typename T, bool Fast>
int launch_mxu_tile(void* re, void* im, const void* desc, void* pool,
                    void* fast_pool, int max_j, const void* index,
                    long long n_index, const void* source,
                    long long total_rows, int tile_rows,
                    long long state_stride, void* stream) {
  using D = typename std::conditional<Fast, __nv_bfloat16, T>::type;
  cudaGetLastError();  // an error left by earlier work is not this launch's
  const long long need = (n_index + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(need < 1024 ? need : 1024);
  mxu_pool_gather<T, D><<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<D*>(Fast ? fast_pool : pool),
      static_cast<const int*>(index), n_index, static_cast<const T*>(source));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch<T, Fast>(re, im, desc, 1, pool, fast_pool, max_j, total_rows,
                         tile_rows, 1, state_stride, stream);
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

// A layer of rowdiag stages only, streamed (no tile): the same descriptors
// and pool as the tile entries (pool_values values, its tables), and the
// same state_stride for a batch. A FAST layer of rowdiag stages takes the
// float32 entry: FAST's rowdiag stages are float32.
int quest_layer_diag_f32(void* re, void* im, const void* desc, int n_stages,
                         const void* pool, long long pool_values,
                         long long total_rows, long long batch,
                         long long state_stride, void* stream) {
  return launch_diag<float>(re, im, desc, n_stages, pool, pool_values,
                            total_rows, batch, state_stride, stream);
}

int quest_layer_diag_f64(void* re, void* im, const void* desc, int n_stages,
                         const void* pool, long long pool_values,
                         long long total_rows, long long batch,
                         long long state_stride, void* stream) {
  return launch_diag<double>(re, im, desc, n_stages, pool, pool_values,
                             total_rows, batch, state_stride, stream);
}

// The MXU tile (apply_mxu_tile): gather the gate's values `source` (on the
// device) into the operator pool (fast_pool, in bf16, for FAST) through the
// packed index map, then launch the one-stage layer kernel on the single
// state.
int quest_mxu_tile_f32(void* re, void* im, const void* desc, void* pool,
                       const void* index, long long n_index,
                       const void* source, long long total_rows,
                       int tile_rows, long long state_stride, void* stream) {
  return launch_mxu_tile<float, false>(re, im, desc, pool, nullptr, 0, index,
                                       n_index, source, total_rows, tile_rows,
                                       state_stride, stream);
}

int quest_mxu_tile_f64(void* re, void* im, const void* desc, void* pool,
                       const void* index, long long n_index,
                       const void* source, long long total_rows,
                       int tile_rows, long long state_stride, void* stream) {
  return launch_mxu_tile<double, false>(re, im, desc, pool, nullptr, 0,
                                        index, n_index, source, total_rows,
                                        tile_rows, state_stride, stream);
}

int quest_mxu_tile_fast_f32(void* re, void* im, const void* desc, void* pool,
                            void* fast_pool, int max_j, const void* index,
                            long long n_index, const void* source,
                            long long total_rows, int tile_rows,
                            long long state_stride, void* stream) {
  return launch_mxu_tile<float, true>(re, im, desc, pool, fast_pool, max_j,
                                      index, n_index, source, total_rows,
                                      tile_rows, state_stride, stream);
}

// Bytes of tables above which the streaming entry reads them through __ldg
// instead of shared memory (the Python side mirrors it).
long long quest_layer_diag_table_cap() {
  return static_cast<long long>(kDiagTableCap);
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
