// The dense stage shared by the layer kernel and the fused Kraus kernel.
//
// A tile of tile_rows x 128 amplitudes of one state sits in shared memory
// as two planes (sre, sim). A dense stage at J replaces, in place, every
// group of 2^J rows (J row bits packed with the 128 lanes into a
// dim = 128 << J axis) by the complex product M v, where the operator M is
// read from global memory stored TRANSPOSED (op[e * dim + o] = M[o][e]),
// real part and imaginary part in two arrays. Outputs are multiplied by
// `scale` (1 in the layer kernel; the Kraus kernel's 1/sqrt(p_j)) and
// written only to groups whose global row passes the row condition.
//
// stage_dense_exact<T, J> is the full-precision stage at every J: J = 0
// through stage_dense_lane<T> (the lane and clane stages, the Kraus
// kernel's drawn operator, the MXU tile on lane targets), J = 1, 2 through
// stage_dense_row<T, J> (full-precision rowmxu stages, the MXU tile on row
// targets). One body: exact FMA on the CUDA cores from an operator ring of
// K slabs beside the tile, the whole tile's outputs in registers, so the
// operator is read once per tile per stage. Its header below has the
// details.
//
// stage_dense_fast<J> is the FAST tier's form of the same stage (float32
// tiles only), the TPU kernel's bf16-split products
// (quest_tpu/ops/pallas_kernels.py:237-260, 339-355) on the bf16 tensor
// cores: each input splits into hi = bf16(v) and lo = bf16(v - hi), the
// operator is bf16 (rounded on the host through float32), and the four real
// products of each part accumulate in float32. bf16 products are exact in
// float32, so the stage differs from the plain version's
// (rr_h - ii_h) + (rr_l - ii_l) only in the order of the sums.
// What bounds it: 16 * dim flops per amplitude on the tensor cores (8.8
// TFLOP for a 30-qubit stage at dim = 512), and the operator, 4 * dim^2
// bytes, read from L2 by every tile. The design:
// - The whole tile is one chunk and the outputs live in registers: each
//   warp owns 32 groups x 64 outputs (2 M-tiles x 8 n-tiles of raw
//   mma.sync.m16n8k16 bf16 -> f32), 64 complex accumulators per thread for
//   every J, so the operator is read from L2 once per tile per stage
//   (64 bytes per amplitude at dim = 512, 4 at dim = 128).
// - The K loop walks slabs of 16 inputs through a two-stage ring in shared
//   memory. The operator slab is one contiguous block (the host packs it in
//   B-fragment order), copied by cp.async.cg while the previous slab's
//   products run; each lane then reads its B fragments as one 16-byte load.
//   The A slab (every group's 16 inputs, split into bf16 hi/lo, re/im) is
//   written by all threads from the float32 tile in A-fragment order, so its
//   fragment loads are 512 contiguous bytes. One barrier per slab.
// - The -Mi terms flip the sign bits of the Mi fragment (exact), so the
//   pool holds Mr and Mi only.
// - The tile holds inputs until the last slab is gathered, which every
//   thread does before the last barrier; after the last products every
//   thread writes its accumulators straight into the tile, an (output,
//   group) pair at ((insert_zeros(g) | combo_offset(o >> 7)) << 7) | (o & 127),
//   only for groups that pass the row condition.
// Shared memory beside the 128 KiB tile: 2 x (64 * dim + (128 >> J) * 128)
// bytes, 72 KiB for a layer with a dim = 512 stage (fast_scratch_bytes).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace quest {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The dynamic shared memory one kernel instance has set on each device so
// far: the attribute is a ceiling, so the largest size serves every smaller
// launch, and a launch calls cudaFuncSetAttribute only to raise it.
// ctypes releases the GIL around a launch, so two host threads may launch
// at once: the mutex keeps a set from racing another thread's launch.
struct LaunchAttrs {
  static constexpr int kMaxDevices = 64;
  std::mutex mu;
  size_t smem_set[kMaxDevices] = {};
};

// Sets cudaFuncAttributeMaxDynamicSharedMemorySize of `kernel` to at least
// `bytes` on the current device, once per (instance, device, larger size).
template <typename Kernel>
cudaError_t ensure_dynamic_smem(Kernel* kernel, LaunchAttrs& attrs,
                                size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(attrs.mu);
  if (dev < LaunchAttrs::kMaxDevices && attrs.smem_set[dev] >= bytes) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < LaunchAttrs::kMaxDevices) {
    attrs.smem_set[dev] = bytes;
  }
  return err;
}

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

// ---------------------------------------------------------------------------
// The FAST stage: bf16 mma.sync fed by a cp.async K-slab ring
// ---------------------------------------------------------------------------

// The FAST tile is float32, 128 rows: groups of one stage = 128 >> J.
constexpr int kFastTileRows = 128;
// Inputs per K slab: one k-step of mma.m16n8k16.
constexpr int kFastK = 16;
// Every warp computes 2 M-tiles (32 groups) x 8 n-tiles (64 outputs):
// 64 complex float32 accumulators per thread for every J.
constexpr int kFastWarpMTiles = 2;
constexpr int kFastWarpNTiles = 8;
constexpr uint32_t kBf16x2Sign = 0x80008000u;

// One ring stage at J: the operator slab (16 inputs x dim outputs x (re,
// im), bf16, in B-fragment order) then the A slab (128 >> J groups x 16
// inputs x (hi re, hi im, lo re, lo im), bf16, in A-fragment order).
__host__ __device__ constexpr size_t fast_op_slab_bytes(int j) {
  return static_cast<size_t>(kFastK) * 2 * (kLanes << j) * 2;
}
__host__ __device__ constexpr size_t fast_a_slab_bytes(int j) {
  return static_cast<size_t>(kFastTileRows >> j) * kFastK * 4 * 2;
}
__host__ __device__ constexpr size_t fast_stage_bytes(int j) {
  return fast_op_slab_bytes(j) + fast_a_slab_bytes(j);
}

// Shared memory of the FAST ring beside the tile: two stages of the
// largest stage any dense stage on up to max_j row bits needs (48 KiB at
// max_j 0 and 1, 72 KiB at 2).
__host__ __device__ constexpr size_t fast_scratch_bytes(int max_j) {
  size_t widest = 0;
  for (int j = 0; j <= max_j; ++j) {
    widest = fast_stage_bytes(j) > widest ? fast_stage_bytes(j) : widest;
  }
  return 2 * widest;
}

// d += a b on the bf16 tensor cores, one m16n8k16 fragment triple. The
// fragment layouts are the PTX ISA's: with gid = lane / 4 and tig = lane % 4,
// a holds rows (gid, gid + 8) x columns (2 tig, 2 tig + 8) (+0, +1 in each
// register), b columns gid x rows (2 tig, 2 tig + 8) (+0, +1), d rows
// (gid, gid + 8) x columns (2 tig, 2 tig + 1).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Start the copy of operator slab k into the ring: one contiguous block
// of fast_op_slab_bytes(J), 16 bytes per cp.async, all threads.
template <int J>
__device__ __forceinline__ void fast_fetch_op(unsigned char* dst,
                                              const __nv_bfloat16* ops,
                                              int k) {
  constexpr int kChunks = static_cast<int>(fast_op_slab_bytes(J) / 16);
  const uint4* src = reinterpret_cast<const uint4*>(ops) +
                     static_cast<size_t>(k) * kChunks;
  uint4* out = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int s = 0; s < kChunks / kThreads; ++s) {
    const int c = threadIdx.x + s * kThreads;
    cp_async_16(out + c, src + c);
  }
  cp_async_commit();
}

// Write A slab k: the tile's inputs [16k, 16k + 16) of every group, split
// into bf16 hi and lo. Item s of this thread is one register (a bf16 pair
// of neighbouring inputs) of one lane's A fragment of one M-tile, for all
// four parts; row0[s] is its group's first row (-1 past the last group).
template <int J>
__device__ __forceinline__ void fast_gather(uint32_t* a_slab,
                                            const float* sre, const float* sim,
                                            const int (&row0)[4 >> J],
                                            long long packed, int k) {
  constexpr int kItems = 4 >> J;
  const int roff = combo_offset((k * kFastK) >> 7, packed, J);
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const int it = threadIdx.x + s * kThreads;
    const int i = it & 3;               // register of the fragment
    const int l = (it >> 2) & 31;       // lane that holds it
    const int mt = it >> 7;             // M-tile
    const int col =
        ((k * kFastK) & (kLanes - 1)) + 2 * (l & 3) + 8 * (i >> 1);
    float2 vr = make_float2(0.0f, 0.0f), vi = vr;
    if (row0[s] >= 0) {
      const int idx = ((row0[s] | roff) << 7) | col;
      vr = *reinterpret_cast<const float2*>(sre + idx);
      vi = *reinterpret_cast<const float2*>(sim + idx);
    }
    const __nv_bfloat162 hr = __floats2bfloat162_rn(vr.x, vr.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(vi.x, vi.y);
    const __nv_bfloat162 lr = __floats2bfloat162_rn(
        vr.x - __low2float(hr), vr.y - __high2float(hr));
    const __nv_bfloat162 li = __floats2bfloat162_rn(
        vi.x - __low2float(hi), vi.y - __high2float(hi));
    // [M-tile][part][lane][register]: a warp's stores and each part's
    // fragment loads are 128 / 512 contiguous bytes
    uint32_t* at = a_slab + ((mt * 4) * 32 + l) * 4 + i;
    at[0] = bf16x2_bits(hr);
    at[32 * 4] = bf16x2_bits(hi);
    at[2 * 32 * 4] = bf16x2_bits(lr);
    at[3 * 32 * 4] = bf16x2_bits(li);
  }
}

// ops: the stage's operator M (not M^T) in bf16, packed by the host
// (ops/layer_kernel.py fast_operator_slabs) slab after slab (inputs
// [16k, 16k + 16)), within a slab n-tile after n-tile (outputs [8t, 8t + 8)),
// within an n-tile lane after lane, each lane's 16 bytes its B fragments
// {re b0, re b1, im b0, im b1}. scratch: fast_scratch_bytes(max_j) bytes,
// 16-aligned.
template <int J>
__device__ void stage_dense_fast(float* sre, float* sim,
                                 unsigned char* scratch, int tile_rows,
                                 long long base_row, long long packed,
                                 const __nv_bfloat16* __restrict__ ops,
                                 long long row_mask, long long row_want) {
  constexpr int kDim = kLanes << J;
  constexpr int kSteps = kDim / kFastK;
  constexpr int kItems = 4 >> J;
  constexpr int kWarpsN = 2 << J;  // warps along the outputs
  constexpr size_t kStage = fast_stage_bytes(J);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wn = warp % kWarpsN;
  const int wm = warp / kWarpsN;
  const int groups = tile_rows >> J;

  int row0[kItems];
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const int it = threadIdx.x + s * kThreads;
    const int g = 16 * (it >> 7) + ((it >> 4) & 7) + 8 * (it & 1);
    row0[s] = g < groups ? insert_zeros(g, packed, J) : -1;
  }

  float acc_re[kFastWarpMTiles][kFastWarpNTiles][4];
  float acc_im[kFastWarpMTiles][kFastWarpNTiles][4];
#pragma unroll
  for (int m = 0; m < kFastWarpMTiles; ++m) {
#pragma unroll
    for (int n = 0; n < kFastWarpNTiles; ++n) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc_re[m][n][r] = 0.0f;
        acc_im[m][n][r] = 0.0f;
      }
    }
  }

  fast_fetch_op<J>(scratch, ops, 0);
  fast_gather<J>(reinterpret_cast<uint32_t*>(scratch + fast_op_slab_bytes(J)),
                 sre, sim, row0, packed, 0);
  for (int k = 0; k < kSteps; ++k) {
    // slab k has landed (this thread's copies, then everyone's); the
    // other ring stage was last read by the mma of slab k - 1
    cp_async_wait_all();
    __syncthreads();
    unsigned char* cur = scratch + (k & 1) * kStage;
    unsigned char* nxt = scratch + ((k + 1) & 1) * kStage;
    if (k + 1 < kSteps) fast_fetch_op<J>(nxt, ops, k + 1);

    const uint4* a_s =
        reinterpret_cast<const uint4*>(cur + fast_op_slab_bytes(J));
    const uint4* b_s = reinterpret_cast<const uint4*>(cur);
    uint4 a[kFastWarpMTiles][4];  // hi re, hi im, lo re, lo im
#pragma unroll
    for (int m = 0; m < kFastWarpMTiles; ++m) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        a[m][p] = a_s[((kFastWarpMTiles * wm + m) * 4 + p) * 32 + lane];
      }
    }
#pragma unroll
    for (int n = 0; n < kFastWarpNTiles; ++n) {
      const uint4 b = b_s[(kFastWarpNTiles * wn + n) * 32 + lane];
      // -Mi: the sign bits flipped (exact)
      const uint32_t ni0 = b.z ^ kBf16x2Sign, ni1 = b.w ^ kBf16x2Sign;
      // re += hr Mr - hi Mi + lr Mr - li Mi; im += hr Mi + hi Mr + lr Mi +
      // li Mr, in this order for every accumulator; the independent
      // accumulators interleave
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const bool imag = p & 1;
#pragma unroll
        for (int m = 0; m < kFastWarpMTiles; ++m) {
          mma_bf16(acc_re[m][n], a[m][p], imag ? ni0 : b.x, imag ? ni1 : b.y);
          mma_bf16(acc_im[m][n], a[m][p], imag ? b.x : b.z, imag ? b.y : b.w);
        }
      }
    }
    if (k + 1 < kSteps) {
      fast_gather<J>(reinterpret_cast<uint32_t*>(nxt + fast_op_slab_bytes(J)),
                     sre, sim, row0, packed, k + 1);
    }
  }

  // Every thread passed the last barrier after its last read of the tile
  // (the gather of the last slab), so the outputs go straight in: rows
  // gid and gid + 8 of each M-tile, outputs 2 tig, 2 tig + 1 of each
  // n-tile. A warp's 64 outputs lie in one row combination.
  const int roff = combo_offset(wn >> 1, packed, J);
  const int col0 =
      ((kFastWarpNTiles * 8 * wn) & (kLanes - 1)) + 2 * (lane & 3);
#pragma unroll
  for (int m = 0; m < kFastWarpMTiles; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = 16 * (kFastWarpMTiles * wm + m) + (lane >> 2) + 8 * h;
      if (g >= groups) continue;
      const int r0 = insert_zeros(g, packed, J);
      if (row_mask && ((base_row + r0) & row_mask) != row_want) continue;
      float* out_re = sre + ((r0 | roff) << 7) + col0;
      float* out_im = sim + ((r0 | roff) << 7) + col0;
#pragma unroll
      for (int n = 0; n < kFastWarpNTiles; ++n) {
        *reinterpret_cast<float2*>(out_re + 8 * n) =
            make_float2(acc_re[m][n][2 * h], acc_re[m][n][2 * h + 1]);
        *reinterpret_cast<float2*>(out_im + 8 * n) =
            make_float2(acc_im[m][n][2 * h], acc_im[m][n][2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The full-precision dense stages: exact FMA fed by a cp.async K-slab ring
// ---------------------------------------------------------------------------
//
// stage_dense_exact<T, J> replaces every group of 2^J rows of the tile by
// scale * M v over its dim = 128 << J inputs, in place, written only to
// groups that pass the row condition. J = 0 is the lane stage
// (stage_dense_lane: the lane and clane stages, the Kraus kernel's drawn
// operator, the MXU tile on lane targets); J = 1, 2 are the rowmxu stages
// (stage_dense_row: full-precision rowmxu stages, the MXU tile on row
// targets). A group's rows are insert_zeros(g) | combo_offset(m), m < 2^J:
// adjacent only when the row bits start at row bit 0. What bounds it:
// 8 * dim real flops per amplitude on the CUDA cores (a 30-qubit float32
// lane stage is 1.1e12 flops, 16.4 ms at 67 TFLOP/s; float64 runs at half
// that rate on the CUDA cores: the card's fp64 peak, 67 TFLOP/s, is on the
// FP64 tensor cores, which an exact stage does not use), against a
// 128 KiB - 4 MiB operator that every tile needs whole. The first designs
// (a warp on 4 >> J groups at a time) streamed that operator from L2 once
// per warp pass: 4-64 MiB of L2 reads per tile, one load per two to eight
// FMAs. The design:
// - The whole tile is one chunk and the outputs live in registers. Thread
//   (gb, ob) = (tid / (16 << J), tid % (16 << J)) owns groups
//   gb + (16 >> J) n (n < kGroups: 8 at float32, 4 at float64, so the
//   tile's 128 / 64 rows) and the 8 outputs q * (dim / kRuns) + kVec * ob
//   + i, i < kVec, in kRuns runs of one 128-bit vector (kVec = 4 floats or
//   2 doubles): 64 / 32 complex accumulators, 128 registers at either
//   dtype. The operator is read from L2 once per tile per stage.
// - The operator streams in K slabs through a two-stage ring beside the
//   tile. The pool stores M^T, so a slab is two contiguous 16 KiB blocks
//   (op_re and op_im rows [K k, K k + K), K = lane_k >> J: 32 / 16 / 8
//   inputs at float32, 16 / 8 / 4 at float64), copied by cp.async.cg
//   (lane_fetch_op); the next slab's copy is issued right after the
//   barrier that opens the current slab's products, one barrier per slab.
//   Ring: 2 x 32 KiB = 64 KiB at every J (lane_scratch_bytes), 192 KiB
//   with the tile.
// - Shared loads are 128 bits. A warp's operator reads are 256 (J = 0) or
//   512 contiguous bytes per run (conflict-free; at J = 0 the other half
//   warp reads the same bytes, a broadcast). For the inputs the threads
//   along the outputs share their groups: at J >= 1 a whole warp does, so
//   each 128-bit input read has one address (a broadcast); at J = 0 a warp
//   holds two row blocks, gb = 2w and 2w + 1, two addresses in one bank
//   quad (rows are 512 B / 1 KiB apart), two wavefronts per load against
//   8 / 4 FMA instructions per loaded value. A thread's group offsets are
//   computed once per stage; the offset of an input block's row
//   combination once per block, the same for the whole block. Inputs are
//   read one block ahead: a group's next kVec inputs right after its last
//   product with the current ones, so the reads overlap the other groups'
//   products. Each input's operator values are read one run (one 128-bit
//   vector of each plane) at a time, and each run's products over all of
//   the thread's groups come before the next run's read, so only one run's
//   operator registers are live (the float64 lane stage reads its four
//   runs at once: kLiveRuns).
// - In place: after the last slab's products one barrier separates every
//   thread's last read of the tile from the writes; then each thread
//   writes its accumulators, times scale, for the groups that pass the row
//   condition. Groups past a small tile (fewer than 16 * kGroups rows) read
//   the tile's last group and are never written.
// - Exact: every accumulator takes the first designs' complex
//   multiply-add, re = fma(xr, a, fma(-xi, b, re)), im = fma(xr, b,
//   fma(xi, a, im)), over e = 0, 1, ..., dim - 1 in order, in fp32 or fp64:
//   the same sums in the same order, so the same bits. No tensor cores.
// - The lane stage is inlined into its callers; the row stages are not:
//   inlined beside the lane stage, the layer kernel's float32 instance
//   needed more than 255 registers (on an H100 it spilled and its lane
//   stage ran slower); as functions of their own they leave the lane
//   stage's allocation as it was, and a call costs nothing next to a
//   stage's 32-128 K FMAs a thread.

// Inputs per K slab of the lane stage: 16 KiB of each operator plane.
__host__ __device__ constexpr int lane_k(int itemsize) {
  return kLanes / itemsize;
}
// Shared memory of the dense stages' ring beside the tile: two stages, each
// a K slab of op_re then the same rows of op_im, 64 KiB at either dtype and
// every J. Every full-precision launch reserves it (the Python side mirrors
// it: ops/layer_kernel.py lane_scratch_bytes).
__host__ __device__ constexpr size_t lane_scratch_bytes(int itemsize) {
  return 2 * static_cast<size_t>(lane_k(itemsize)) * kLanes * 2 * itemsize;
}

__device__ __forceinline__ void load_128(float* d, const float* s) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}
__device__ __forceinline__ void load_128(double* d, const double* s) {
  const double2 v = *reinterpret_cast<const double2*>(s);
  d[0] = v.x;
  d[1] = v.y;
}
__device__ __forceinline__ void store_128(float* d, const float* s) {
  *reinterpret_cast<float4*>(d) = make_float4(s[0], s[1], s[2], s[3]);
}
__device__ __forceinline__ void store_128(double* d, const double* s) {
  *reinterpret_cast<double2*>(d) = make_double2(s[0], s[1]);
}

// Start the copy of slab k into a ring stage: the k-th 16 KiB of op_re,
// then of op_im (rows [K k, K k + K) of M^T at any J), 16 bytes per
// cp.async, all threads.
template <typename T>
__device__ __forceinline__ void lane_fetch_op(T* dst, const T* op_re,
                                              const T* op_im, int k) {
  constexpr int kK = lane_k(sizeof(T));
  constexpr int kChunks = kK * kLanes * static_cast<int>(sizeof(T)) / 16;
  const size_t first = static_cast<size_t>(k) * kK * kLanes;
  const uint4* src_re = reinterpret_cast<const uint4*>(op_re + first);
  const uint4* src_im = reinterpret_cast<const uint4*>(op_im + first);
  uint4* out = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int s = 0; s < kChunks / kThreads; ++s) {
    const int c = threadIdx.x + s * kThreads;
    cp_async_16(out + c, src_re + c);
    cp_async_16(out + kChunks + c, src_im + c);
  }
  cp_async_commit();
}

// op_re / op_im: the operator's M^T planes (op[e * dim + o] = M[o][e]),
// 16-byte aligned. ring: lane_scratch_bytes(sizeof(T)) bytes, 16-aligned.
// packed: the J row bits, ascending, one per byte.
template <typename T, int J>
__device__ __forceinline__ void stage_dense_exact(
    T* sre, T* sim, T* ring, int tile_rows, long long base_row,
    long long packed, const T* __restrict__ op_re,
    const T* __restrict__ op_im, long long row_mask, long long row_want,
    T scale) {
  constexpr int kDim = kLanes << J;
  constexpr int kK = lane_k(sizeof(T)) >> J;
  constexpr int kSlabs = kDim / kK;
  constexpr int kStage = 2 * kK * kDim;             // ring stage, elements
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kGroups = 32 / static_cast<int>(sizeof(T));
  constexpr int kOuts = 8;                          // outputs per thread
  constexpr int kRuns = kOuts / kVec;
  constexpr int kRunStride = kDim / kRuns;
  constexpr int kOutThreads = kDim / kOuts;         // 16 << J
  constexpr int kGroupStride = kThreads / kOutThreads;
  // operator runs whose values are live at once: one, except in the
  // float64 lane stage, which reads all four first (one at a time, the
  // layer kernel's float64 instance reached 255 registers and spilled;
  // at float32 one at a time is the faster lane stage)
  constexpr int kLiveRuns = (J == 0 && sizeof(T) == 8) ? kRuns : 1;
  const int ob = threadIdx.x % kOutThreads;
  const int gb = threadIdx.x / kOutThreads;
  const int col = kVec * ob;
  const int groups = tile_rows >> J;

  // each group's first row, as an offset into the planes
  int xoff[kGroups];
#pragma unroll
  for (int n = 0; n < kGroups; ++n) {
    xoff[n] = insert_zeros(min(gb + kGroupStride * n, groups - 1), packed, J)
              * kLanes;
  }
  T acc_re[kGroups][kOuts];
  T acc_im[kGroups][kOuts];
#pragma unroll
  for (int n = 0; n < kGroups; ++n) {
#pragma unroll
    for (int p = 0; p < kOuts; ++p) {
      acc_re[n][p] = T(0);
      acc_im[n][p] = T(0);
    }
  }

  // inputs [e, e + kVec) of every group of this thread, one block ahead
  // (input e of a group sits at its first row + the offset of row
  // combination e >> 7 + lane e & 127; input 0 at the first row)
  T xr[kGroups][kVec], xi[kGroups][kVec];
#pragma unroll
  for (int n = 0; n < kGroups; ++n) {
    load_128(xr[n], sre + xoff[n]);
    load_128(xi[n], sim + xoff[n]);
  }

  lane_fetch_op<T>(ring, op_re, op_im, 0);
#pragma unroll 1
  for (int k = 0; k < kSlabs; ++k) {
    // slab k has landed (this thread's copies, then everyone's); the
    // other ring stage was last read by the products of slab k - 1
    cp_async_wait_all();
    __syncthreads();
    const T* w_re = ring + (k & 1) * kStage;
    const T* w_im = w_re + kK * kDim;
    if (k + 1 < kSlabs) {
      lane_fetch_op<T>(ring + ((k + 1) & 1) * kStage, op_re, op_im, k + 1);
    }
#pragma unroll 1
    for (int e0 = 0; e0 < kK; e0 += kVec) {
      // the block after [K k + e0, K k + e0 + kVec), as an offset from a
      // group's first row; past the last one the last again (read, never
      // used)
      const int after = min(k * kK + e0 + kVec, kDim - kVec);
      const int next = combo_offset(after >> 7, packed, J) * kLanes
                       + (after & (kLanes - 1));
#pragma unroll
      for (int t = 0; t < kVec; ++t) {
        // operator row e of this thread's outputs
        const T* wr = w_re + (e0 + t) * kDim + col;
        const T* wi = w_im + (e0 + t) * kDim + col;
        T a[kOuts], b[kOuts];
#pragma unroll
        for (int q0 = 0; q0 < kRuns; q0 += kLiveRuns) {
#pragma unroll
          for (int q = q0; q < q0 + kLiveRuns; ++q) {
            load_128(a + q * kVec, wr + q * kRunStride);
            load_128(b + q * kVec, wi + q * kRunStride);
          }
#pragma unroll
          for (int n = 0; n < kGroups; ++n) {
#pragma unroll
            for (int p = q0 * kVec; p < (q0 + kLiveRuns) * kVec; ++p) {
              acc_re[n][p] = fma(xr[n][t], a[p],
                                 fma(-xi[n][t], b[p], acc_re[n][p]));
              acc_im[n][p] = fma(xr[n][t], b[p],
                                 fma(xi[n][t], a[p], acc_im[n][p]));
            }
            if (t == kVec - 1 && q0 + kLiveRuns == kRuns) {
              load_128(xr[n], sre + xoff[n] + next);
              load_128(xi[n], sim + xoff[n] + next);
            }
          }
        }
      }
    }
  }

  // every thread has read all of its inputs from the tile
  __syncthreads();
#pragma unroll
  for (int n = 0; n < kGroups; ++n) {
    // the group's first row, from g again (taken from xoff, the layer
    // kernel's float64 instance spilled)
    const int g = gb + kGroupStride * n;
    if (g >= groups) continue;
    const int row0 = insert_zeros(g, packed, J);
    if (row_mask && ((base_row + row0) & row_mask) != row_want) continue;
#pragma unroll
    for (int q = 0; q < kRuns; ++q) {
      const int o = q * kRunStride + col;
      const int at = (row0 | combo_offset(o >> 7, packed, J)) * kLanes
                     + (o & (kLanes - 1));
      T out_re[kVec], out_im[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        out_re[i] = acc_re[n][q * kVec + i] * scale;
        out_im[i] = acc_im[n][q * kVec + i] * scale;
      }
      store_128(sre + at, out_re);
      store_128(sim + at, out_im);
    }
  }
}

// The lane stage (J = 0: every row is a group), inlined into its callers.
template <typename T>
__device__ __forceinline__ void stage_dense_lane(
    T* sre, T* sim, T* ring, int tile_rows, long long base_row,
    const T* __restrict__ op_re, const T* __restrict__ op_im,
    long long row_mask, long long row_want, T scale) {
  stage_dense_exact<T, 0>(sre, sim, ring, tile_rows, base_row, 0, op_re,
                          op_im, row_mask, row_want, scale);
}

// The row stages (J = 1, 2), each a function of its own.
template <typename T, int J>
__device__ __noinline__ void stage_dense_row(
    T* sre, T* sim, T* ring, int tile_rows, long long base_row,
    long long packed, const T* __restrict__ op_re,
    const T* __restrict__ op_im, long long row_mask, long long row_want,
    T scale) {
  stage_dense_exact<T, J>(sre, sim, ring, tile_rows, base_row, packed, op_re,
                          op_im, row_mask, row_want, scale);
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
