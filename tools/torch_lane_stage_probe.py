#!/usr/bin/env python3
"""Where the full-precision dense stages' time goes, on one CUDA card.

Builds the layer kernel (``quest_tpu_torch/csrc``) in variants that each
leave one part of the dense stages' K loop out (``stage_dense_exact``,
the one body of ``stage_dense_lane`` and ``stage_dense_row``), and times
ONE dense stage of each
variant: a lane stage (a 128 x 128 complex operator on every row) on a
30-qubit float32 state and a 29-qubit float64 state, and a ``rowmxu``
stage at J = 1 (targets (8,): row bit 1, dim 256) and J = 2 (targets
(7, 8): row bits 0 and 1, dim 512) on 26-qubit float32 and float64
states. A stage's time is the difference of a layer holding it three times
and a layer holding it once, halved (the tile's HBM pass cancels). For
each row cell it first runs ``base`` and ``old_loop`` on one state and
prints their largest difference, which must be 0 (the same sums in the
same order; the probe exits non-zero otherwise). Each time is set beside
the bound at the card's peak for the dtype (67 TFLOP/s at float32 on the
CUDA cores and at float64 on the FP64 tensor cores) and, at float64,
beside the CUDA-core figure (34 TFLOP/s), the rate the exact stage's
DFMA can reach. Beside each time it reads the
SM clock and the power draw (``nvidia-smi``) half a second into a further
1.5 s of the same launches: the CUDA-core rate scales with the clock,
which a card at its power limit lowers by an amount that depends on the
data. The ablated variants compute wrong amplitudes: they are timings
only.

- ``base``: the kernel as built by ``ops/cuda_build.py``;
- ``old_loop``: the ``rowmxu`` stages run by the loop they replaced,
  ``stage_dense<T, J>`` (a warp on 4 >> J groups at a time, the operator
  read from L2 through ``__ldg`` by every pass; its source is kept here),
  the kernel otherwise as built: the layer kernel as it was before the row
  stages took the operator ring, for the same-card comparison (the lane
  cells skip it: there it is the same kernel as ``base``);
- ``no_fetch``: the operator slab is not copied after the first slab;
- ``no_x``: the inputs are read from the tile once, before the K loop,
  and never again (every product takes each group's first four / two);
- ``fma_only``: no copy, inputs as in ``no_x``, and every product takes
  the operator row of the slab's first input (loop-invariant reads the
  compiler makes once per slab), barriers kept: the FMA instructions
  alone at this kernel's 8 warps per SM.

It also prints the registers and spills of each variant's full-precision
instances, and what the compiler made of the dense stages' inner loops in
the ``base`` build: the instruction counts, by opcode, of every loop that
holds no other loop and at least 256 FFMA / DFMA instructions
(``cuobjdump -sass``), in address order, in each full-precision instance
of the kernel (with the functions it calls).

Run from the root of a checkout (the variants build under
``build/lane_stage_probe/``)::

    python3 tools/torch_lane_stage_probe.py
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

REPS = 3
# (dtype name, the card's peak rate for the dtype in flop/s, the CUDA-core
# rate, mangled instance piece): float32 peaks on the CUDA cores, float64
# on the FP64 tensor cores, twice its CUDA-core rate
DTYPES = (("float32", 67.0e12, 67.0e12, "layer_kernelIfLb0E"),
          ("float64", 67.0e12, 34.0e12, "layer_kernelIdLb0E"))
RATE = {name: rate for name, rate, _, _ in DTYPES}
CORE_RATE = {name: rate for name, _, rate, _ in DTYPES}
# (dtype name, qubits, row bits of the stage: () is the lane stage)
CELLS = (("float32", 30, ()), ("float64", 29, ()),
         ("float32", 26, (1,)), ("float32", 26, (0, 1)),
         ("float64", 26, (1,)), ("float64", 26, (0, 1)))

def row_call(j: int) -> str:
    return (f"          quest::stage_dense_row<T, {j}>(sre, sim, lane_ring, "
            "tile_rows,\n"
            "                                       base_row, packed, op, "
            "op_im, row_mask,\n"
            "                                       row_want, T(1));")


def old_row_call(j: int) -> str:
    return (f"          quest::stage_dense<T, {j}>(sre, sim, tile_rows, "
            "base_row, packed, op,\n"
            "                                   op_im, row_mask, row_want, "
            "T(1));")


# the first design's loop, as the layer kernel ran its rowmxu stages
# before they took the operator ring; the old_loop variant puts it back
# into dense_stage.cuh before this line
OLD_ANCHOR = "// One coalesced copy of a tile of both planes"
OLD_LOOP = """template <typename T, int J>
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

"""
FETCH = ("      lane_fetch_op<T>(ring + ((k + 1) & 1) * kStage, op_re, op_im, "
         "k + 1);")
X_NEXT = ("              load_128(xr[n], sre + xoff[n] + next);\n"
          "              load_128(xi[n], sim + xoff[n] + next);\n")
A_LOAD = "            load_128(a + q * kVec, wr + q * kRunStride);"
B_LOAD = "            load_128(b + q * kVec, wi + q * kRunStride);"
# the operator row of input 0 for every input: loop-invariant addresses,
# so the compiler reads them once per slab
A_ROW0 = "            load_128(a + q * kVec, w_re + col + q * kRunStride);"
B_ROW0 = "            load_128(b + q * kVec, w_im + col + q * kRunStride);"

# edits per variant: (file, old text, new text); the lane and the row
# stages share one body (stage_dense_exact), so an ablation reaches both
VARIANTS = {
    "base": [],
    "old_loop": [("layer_kernel.cu", row_call(1), old_row_call(1)),
                 ("layer_kernel.cu", row_call(2), old_row_call(2)),
                 ("dense_stage.cuh", OLD_ANCHOR, OLD_LOOP + OLD_ANCHOR)],
    "no_fetch": [("dense_stage.cuh", FETCH, "")],
    "no_x": [("dense_stage.cuh", X_NEXT, "")],
    "fma_only": [("dense_stage.cuh", FETCH, ""),
                 ("dense_stage.cuh", X_NEXT, ""),
                 ("dense_stage.cuh", A_LOAD, A_ROW0),
                 ("dense_stage.cuh", B_LOAD, B_ROW0)],
}


def clocks() -> str:
    """The SM clock (MHz) and the power draw (W) now, as nvidia-smi gives
    them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip()


def registers(log: str, piece: str) -> str:
    """The registers and spills ptxas printed for the instance named by
    piece."""
    lines = log.splitlines()
    start = next(i for i, line in enumerate(lines)
                 if "Compiling entry function" in line and piece in line)
    used = next(line.split(":", 1)[1].strip()
                for line in lines[start:] if "registers" in line)
    props = next((i for i, line in enumerate(lines)
                  if "Function properties for" in line and piece in line),
                 None)
    spills = "spills not reported" if props is None else \
        lines[props + 1].strip()
    return f"{used}; {spills}"


# the functions whose dense inner loops the probe reports: the kernel's
# full-precision instances (the row stages they call have no section of
# their own in the SASS)
FUNCTIONS = {"layer_kernelIfLb0E": "layer_kernel<float>",
             "layer_kernelIdLb0E": "layer_kernel<double>"}


def inner_loops(sass_path: Path) -> dict:
    """{function: [opcode counts of each innermost loop (one holding no
    other) with at least 256 FFMA / DFMA instructions, in address order]}
    for the FUNCTIONS found in the SASS of one library."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(sass_path)],
                          capture_output=True, text=True,
                          timeout=300).stdout
    bodies, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = next((label for piece, label in FUNCTIONS.items()
                         if piece in line), None)
            if name is not None:
                bodies[name] = []
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if name is not None and m:
            bodies[name].append((int(m.group(1), 16), m.group(2).strip()))
    out = {}
    for name, body in bodies.items():
        # backward branches: (branch address, loop head)
        back = sorted((addr, int(t.group(1), 16)) for addr, ins in body
                      for t in [re.search(r"BRA .*0x([0-9a-f]+)", ins)]
                      if t and int(t.group(1), 16) < addr)
        loops = []
        for addr, head in back:
            if any(head <= a < addr for a, _ in back):
                continue                         # holds an inner loop
            ops = Counter(re.match(r"(@!?U?P\w+\s+)?([A-Z0-9_]+)", i).group(2)
                          for a, i in body if head <= a <= addr)
            if ops["FFMA"] + ops["DFMA"] >= 256:
                loops.append(ops)
        out[name] = loops
    return out


def build(cuda_build) -> dict:
    """One ``nvcc`` per variant, all started together; returns {variant:
    (library, {dtype name: registers line})}."""
    out_dir = ROOT / "build" / "lane_stage_probe"
    procs = {}
    for name, edits in VARIANTS.items():
        src = out_dir / name
        shutil.rmtree(src, ignore_errors=True)
        src.mkdir(parents=True)
        for path in cuda_build.CSRC.iterdir():
            shutil.copy(path, src / path.name)
        for fname, old, new in edits:
            text = (src / fname).read_text()
            if old not in text:
                raise SystemExit(f"variant {name}: {fname} no longer has "
                                 f"{old!r}")
            (src / fname).write_text(text.replace(old, new))
        procs[name] = subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
             str(src / "layer_kernel.so"), str(src / "layer_kernel.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / name / "layer_kernel.so"))
        for entry in ("quest_layer_apply_f32", "quest_layer_apply_f64"):
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        built[name] = (lib, {d[0]: registers(log, d[3]) for d in DTYPES})
    return built


def main() -> int:
    import torch
    from quest_tpu_torch.ops import cuda_build
    from quest_tpu_torch.ops import layer_kernel as lk
    if not torch.cuda.is_available():
        print("FAIL: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"gpu: {smi.stdout.strip()}")
    built = build(cuda_build)
    for name, (_, regs) in built.items():
        print(f"  {name:9s} " + "; ".join(f"{d}: {r}" for d, r in
                                          regs.items()))
    loops = inner_loops(ROOT / "build" / "lane_stage_probe" / "base"
                        / "layer_kernel.so")
    for name in FUNCTIONS.values():
        for i, ops in enumerate(loops.get(name, [])):
            print(f"  base {name} dense inner loop {i}: "
                  f"{sum(ops.values())} instructions, "
                  + ", ".join(f"{op} {c}" for op, c in ops.most_common(8)))
        if not loops.get(name):
            print(f"  base {name}: no dense inner loop found")

    rng = np.random.default_rng(1)
    summary, exact = {}, True
    for dtype_name, n, bits in CELLS:
        dtype = getattr(torch, dtype_name)
        dim = lk.LANES << len(bits)
        z = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
        m = np.linalg.qr(z)[0]
        stage = ("rowmxu", bits, m) if bits else ("lane", m)
        kind = f"rowmxu J={len(bits)} bits {bits}" if bits else "lane"
        cell = f"{dtype_name}_{n}q_" + (f"j{len(bits)}" if bits else "lane")
        planes = torch.empty(2, 1 << n, dtype=dtype, device="cuda")
        item = planes.element_size()

        def launch(lib, layer, target=planes):
            desc, pool, tile_rows, total_rows = lk._device_operands(
                layer, n, dtype, planes.device)
            fn = lib.quest_layer_apply_f32 if item == 4 \
                else lib.quest_layer_apply_f64
            err = fn(target.data_ptr(), target.data_ptr() + item * (1 << n),
                     desc.data_ptr(), desc.shape[0], pool.data_ptr(),
                     total_rows, tile_rows, 1, 2 * (1 << n),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"launch failed: {err}")

        def ms(lib, layer):
            launch(lib, layer)
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(REPS):
                launch(lib, layer)
            t1.record()
            torch.cuda.synchronize()
            return t0.elapsed_time(t1) / REPS

        once = lk.LayerOp(n, 1, [stage])
        thrice = lk.LayerOp(n, 3, [stage] * 3)
        bound = 1e3 * 8.0 * dim * (1 << n) / RATE[dtype_name]
        core = 1e3 * 8.0 * dim * (1 << n) / CORE_RATE[dtype_name]
        print(f"one {kind} stage, {dtype_name}, {n} qubits; bound at the "
              f"card's {dtype_name} peak {bound:.3f} ms"
              + ("" if core == bound else
                 f" (at the CUDA-core rate {core:.3f} ms)"), flush=True)
        variants = dict(built)
        if bits:
            # the new stage and the old loop on one state: the same sums
            # in the same order, so the same bits
            planes.normal_().mul_(2.0 ** (-n / 2))
            outs = [planes.clone() for _ in range(2)]
            for name, out in zip(("base", "old_loop"), outs):
                launch(built[name][0], once, out)
            torch.cuda.synchronize()
            diff = float((outs[0] - outs[1]).abs().max())
            exact = exact and diff == 0.0
            del outs
            summary[f"{cell}_base_vs_old_loop_max_abs_diff"] = diff
            print(f"  base vs old_loop on one state: max|diff| {diff:.3e}",
                  flush=True)
        else:
            del variants["old_loop"]
            print("  old_loop: n/a (the same kernel as base for a lane "
                  "stage)", flush=True)
        for name, (lib, _) in variants.items():
            # a fresh state: an ablated variant may have left non-numbers
            planes.normal_().mul_(2.0 ** (-n / 2))
            t1, t3 = ms(lib, once), ms(lib, thrice)
            stage_ms = (t3 - t1) / 2
            for _ in range(max(1, int(1500.0 / t3))):
                launch(lib, thrice)
            time.sleep(0.5)
            under_load = clocks()
            torch.cuda.synchronize()
            summary[f"{cell}_{name}_ms"] = stage_ms
            summary[f"{cell}_{name}_clock_power"] = under_load
            print(f"  {name:9s} {stage_ms:8.3f} ms (layers of 1 and 3: "
                  f"{t1:.3f}, {t3:.3f} ms; {bound / stage_ms:.1%} of the "
                  "bound"
                  + ("" if core == bound else
                     f", {core / stage_ms:.1%} of the CUDA-core figure")
                  + f"); SM clock, power under load: {under_load}",
                  flush=True)
        summary[f"{cell}_bound_ms"] = bound
        summary[f"{cell}_cuda_core_ms"] = core
        del planes
        torch.cuda.empty_cache()
    print(json.dumps({"lane_stage_probe": summary}))
    if not exact:
        print("FAIL: base and old_loop differ", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
