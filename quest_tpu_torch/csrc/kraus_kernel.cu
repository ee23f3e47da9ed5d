// Fused per-trajectory Kraus draw + apply + renormalise for NVIDIA Hopper
// (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// quest_tpu/ops/pallas_kernels.py `_kraus_kernel`, reached through
// `fused_kraus_apply_batched`: for every trajectory t of a batch of T
// states, draw one of K Kraus operators by inverse CDF over the channel
// probabilities p[t, :] against the trajectory's uniform u[t], and apply the
// drawn operator, lane-embedded as a 128 x 128 matrix (every target of the
// channel is a lane qubit, < 7), scaled by 1/sqrt(p_j), to the state.
//
// What bounds it on the card. The lane product costs 8 * 128 real flops per
// amplitude, 1.1e12 for 2^30 amplitudes: 16 ms at the 67 TFLOP/s float32
// CUDA-core rate, against 16 B per amplitude of HBM traffic (5.1 ms for
// 2^30 amplitudes at 3.35 TB/s). So it is bound by operations, like the
// layer kernel's lane stage, which it reuses (dense_stage.cuh).
//
// How the design answers that. Grid: one block per (row tile, trajectory),
// block x = t * tiles_per_state + tile. Each block first recomputes its
// trajectory's draw in the plane dtype with the TPU kernel's arithmetic and
// order (pallas_kernels.py:898-923), which is a handful of scalar
// operations: total = left-to-right sum of p[t, :]; uu = min(u * total,
// total - total * eps); j = min(#{k : cumsum_k <= uu}, K - 1);
// scale = 1 / sqrt(max(p_j, tiny)). Every product and sum there is rounded
// on its own (the _rn intrinsics), never contracted into an FMA, so the
// draw is the one the plain version makes. Selecting K_j is the TPU's
// one-hot blend: the block reads operator j of the stack. The tile is read
// into shared memory, replaced in place by scale * (K_j v) per row by the
// layer kernel's lane stage (stage_dense_lane: the outputs in registers,
// K_j streamed once per tile through a 64 KiB cp.async ring beside the
// tile), and written back; tiles are disjoint, so the states are updated
// in place.
//
// Layouts: states (T, 2, 2^n) contiguous, trajectory t's re plane at
// t * state_stride, its im plane 2^n later; the operator stack holds, per
// operator, K_k^T's real part then its imaginary part (128 x 128 each);
// probabilities (T, K) and uniforms (T,) in the plane dtype. The draw reads
// p[t, :] from global memory and the block reads operator j of the stack, so
// nothing is sized by K: any K >= 1 works (64 for a full three-qubit set).
// An optional (T,) int32 output receives each trajectory's drawn index j,
// written by the block of the trajectory's first tile (null: nothing is
// written). The gradient walk records its branches from it, so it never
// draws a second time.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o kraus_kernel.so kraus_kernel.cu
// The C entry points return cudaGetLastError() after the launch; their
// index_out argument may be null.

#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_stage.cuh"

namespace {

using quest::kLanes;
using quest::kThreads;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

template <typename T> struct Limits;
template <> struct Limits<float> {
  static __device__ __forceinline__ float eps() { return FLT_EPSILON; }
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
};
template <> struct Limits<double> {
  static __device__ __forceinline__ double eps() { return DBL_EPSILON; }
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
};

// The inverse-CDF draw of pallas_kernels.py:898-923; returns j, sets scale.
template <typename T>
__device__ int draw(const T* __restrict__ p, int num_ops, T u, T* scale) {
  T total = p[0];
  for (int k = 1; k < num_ops; ++k) total = add_rn(total, p[k]);
  const T cap = sub_rn(total, mul_rn(total, Limits<T>::eps()));
  const T uu = fmin(mul_rn(u, total), cap);
  T cum = T(0);
  int cnt = 0;
  for (int k = 0; k < num_ops; ++k) {
    cum = add_rn(cum, p[k]);
    cnt += cum <= uu ? 1 : 0;
  }
  const int j = min(cnt, num_ops - 1);
  *scale = T(1) / sqrt(fmax(p[j], Limits<T>::tiny()));
  return j;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    kraus_kernel(T* re, T* im, const T* __restrict__ kstack,
                 const T* __restrict__ probs, const T* __restrict__ u01,
                 int* __restrict__ index_out, int num_ops, int tile_rows,
                 long long tiles_per_state, long long state_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sre = reinterpret_cast<T*>(smem);
  T* sim = sre + tile_rows * kLanes;
  const long long traj = blockIdx.x / tiles_per_state;
  const long long base_row = (blockIdx.x % tiles_per_state) * tile_rows;
  const size_t first = static_cast<size_t>(traj * state_stride
                                           + base_row * kLanes);

  T scale;
  const int j = draw<T>(probs + traj * num_ops, num_ops, u01[traj], &scale);
  if (index_out != nullptr && base_row == 0 && threadIdx.x == 0) {
    index_out[traj] = j;
  }
  const T* op_re = kstack + static_cast<size_t>(j) * 2 * kLanes * kLanes;
  const T* op_im = op_re + kLanes * kLanes;

  quest::copy_tile(sre, sim, re + first, im + first, tile_rows);
  __syncthreads();
  quest::stage_dense_lane<T>(sre, sim, sim + tile_rows * kLanes, tile_rows,
                             base_row, op_re, op_im, 0, 0, scale);
  __syncthreads();
  quest::copy_tile(re + first, im + first, sre, sim, tile_rows);
}

template <typename T>
int launch(void* re, void* im, const void* kstack, const void* probs,
           const void* u01, void* index_out, int num_ops, long long num_traj,
           long long total_rows, int tile_rows, long long state_stride,
           void* stream) {
  if (num_ops < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * static_cast<size_t>(tile_rows) * kLanes * sizeof(T)
                      + quest::lane_scratch_bytes(sizeof(T));
  cudaGetLastError();  // an error left by earlier work is not this launch's
  static quest::LaunchAttrs attrs;
  cudaError_t err = quest::ensure_dynamic_smem(kraus_kernel<T>, attrs, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = total_rows / tile_rows;
  if (num_traj < 1 || num_traj * tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  kraus_kernel<T><<<static_cast<unsigned>(num_traj * tiles), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(re), static_cast<T*>(im),
      static_cast<const T*>(kstack), static_cast<const T*>(probs),
      static_cast<const T*>(u01), static_cast<int*>(index_out), num_ops,
      tile_rows, tiles, state_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int quest_kraus_apply_f32(void* re, void* im, const void* kstack,
                          const void* probs, const void* u01, void* index_out,
                          int num_ops, long long num_traj,
                          long long total_rows, int tile_rows,
                          long long state_stride, void* stream) {
  return launch<float>(re, im, kstack, probs, u01, index_out, num_ops,
                       num_traj, total_rows, tile_rows, state_stride, stream);
}

int quest_kraus_apply_f64(void* re, void* im, const void* kstack,
                          const void* probs, const void* u01, void* index_out,
                          int num_ops, long long num_traj,
                          long long total_rows, int tile_rows,
                          long long state_stride, void* stream) {
  return launch<double>(re, im, kstack, probs, u01, index_out, num_ops,
                        num_traj, total_rows, tile_rows, state_stride, stream);
}

// Shared memory of the lane stage's ring beside the tile, for planes of
// itemsize bytes (the Python side mirrors it).
long long quest_kraus_lane_scratch_bytes(int itemsize) {
  return static_cast<long long>(quest::lane_scratch_bytes(itemsize));
}

const char* quest_kraus_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
