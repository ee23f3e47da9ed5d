#!/usr/bin/env python3
"""Where the full-precision lane stage's time goes, on one CUDA card.

Builds the layer kernel (``quest_tpu_torch/csrc``) in variants that each
leave one part of ``stage_dense_lane``'s K loop out, and times ONE lane
stage (a 128 x 128 complex operator on every row) of each variant on a
30-qubit float32 state and a 29-qubit float64 state. A stage's time is the
difference of a layer holding it three times and a layer holding it once,
halved (the tile's HBM pass cancels). It first runs ``base`` and
``old_loop`` on one state and prints their largest difference. Beside each
time it reads the SM clock and the power draw (``nvidia-smi``) half a
second into a further 1.5 s of the same launches: the CUDA-core rate
scales with the clock, which a card at its power limit lowers by an amount
that depends on the data. The ablated variants compute wrong amplitudes:
they are timings only.

- ``base``: the kernel as built by ``ops/cuda_build.py``;
- ``old_loop``: the lane stage run by the loop it replaced,
  ``stage_dense<T, 0>`` (a warp on four rows at a time, the operator read
  from L2 by every pass), for the same-card comparison;
- ``no_fetch``: the operator slab is not copied after the first slab;
- ``no_x``: the inputs are read from the tile once, before the K loop,
  and never again (every product takes each row's first four / two);
- ``fma_only``: no copy, inputs as in ``no_x``, and every product takes
  the operator row of the slab's first input (loop-invariant reads the
  compiler makes once per slab), barriers kept: the FMA instructions
  alone at this kernel's 8 warps per SM.

It also prints what the compiler made of the stage's inner loop in the
``base`` build: the instruction counts, by opcode, of the loop of each
instance that holds no other loop and has the most FFMA / DFMA
instructions (``cuobjdump -sass``).

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
# (dtype name, qubits, CUDA-core rate in flop/s, mangled instance piece)
CELLS = (("float32", 30, 67.0e12, "layer_kernelIfLb0E"),
         ("float64", 29, 34.0e12, "layer_kernelIdLb0E"))

STAGE_CALL = ("          quest::stage_dense_lane<T>(sre, sim, lane_ring, "
              "tile_rows,\n"
              "                                     base_row, op, op_im, "
              "row_mask, row_want,\n"
              "                                     T(1));")
OLD_CALL = ("          (void)lane_ring;\n"
            "          quest::stage_dense<T, 0>(sre, sim, tile_rows, "
            "base_row, packed, op,\n"
            "                                   op_im, row_mask, row_want, "
            "T(1));")
FETCH = ("      lane_fetch_op<T>(ring + ((k + 1) & 1) * kStage, op_re, op_im, "
         "k + 1);")
X_NEXT = ("            load_128(xr[n], sre + xoff[n] + next);\n"
          "            load_128(xi[n], sim + xoff[n] + next);\n")
A_LOAD = "          load_128(a + q * kVec, wr + q * kRunStride);"
B_LOAD = "          load_128(b + q * kVec, wi + q * kRunStride);"
# the operator row of input 0 for every input: loop-invariant addresses,
# so the compiler reads them once per slab
A_ROW0 = "          load_128(a + q * kVec, w_re + col + q * kRunStride);"
B_ROW0 = "          load_128(b + q * kVec, w_im + col + q * kRunStride);"

# edits per variant: (file, old text, new text)
VARIANTS = {
    "base": [],
    "old_loop": [("layer_kernel.cu", STAGE_CALL, OLD_CALL)],
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
    """The registers line ptxas printed for the instance named by piece."""
    lines = log.splitlines()
    start = next(i for i, line in enumerate(lines)
                 if "Compiling entry function" in line and piece in line)
    return next(line.split(":", 1)[1].strip()
                for line in lines[start:] if "registers" in line)


def inner_loops(sass_path: Path) -> dict:
    """{instance piece: opcode counts of the innermost loop (one holding
    no other) with the most FFMA / DFMA instructions} in the SASS of one
    library."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(sass_path)],
                          capture_output=True, text=True,
                          timeout=300).stdout
    out = {}
    for piece in (cell[3] for cell in CELLS):
        body, inside = [], False
        for line in sass.splitlines():
            if "Function : " in line:
                inside = piece in line
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if inside and m:
                body.append((int(m.group(1), 16), m.group(2).strip()))
        # backward branches: (branch address, loop head)
        back = [(addr, int(t.group(1), 16)) for addr, ins in body
                for t in [re.search(r"BRA .*0x([0-9a-f]+)", ins)]
                if t and int(t.group(1), 16) < addr]
        loops = []
        for addr, head in back:
            if any(head <= a < addr for a, _ in back):
                continue                         # holds an inner loop
            ops = Counter(re.match(r"(@!?U?P\w+\s+)?([A-Z0-9_]+)", i).group(2)
                          for a, i in body if head <= a <= addr)
            loops.append((ops["FFMA"] + ops["DFMA"], ops))
        out[piece] = max(loops, key=lambda lp: lp[0])[1] if loops else None
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
        built[name] = (lib, {cell[0]: registers(log, cell[3])
                             for cell in CELLS})
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
    for dtype_name, _, _, piece in CELLS:
        ops = loops[piece]
        print(f"  base {dtype_name} inner loop: " + (
            "not found" if ops is None else
            f"{sum(ops.values())} instructions, "
            + ", ".join(f"{op} {c}" for op, c in ops.most_common(8))))

    rng = np.random.default_rng(1)
    z = rng.normal(size=(128, 128)) + 1j * rng.normal(size=(128, 128))
    m = np.linalg.qr(z)[0]
    summary = {}
    for dtype_name, n, rate, _ in CELLS:
        dtype = getattr(torch, dtype_name)
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

        once = lk.LayerOp(n, 1, [("lane", m)])
        thrice = lk.LayerOp(n, 3, [("lane", m)] * 3)
        bound = 1e3 * 8.0 * 128 * (1 << n) / rate
        print(f"one lane stage, {dtype_name}, {n} qubits; CUDA-core bound "
              f"{bound:.3f} ms", flush=True)
        # the new stage and the old loop on one state: the same sums in
        # the same order, so the same bits
        planes.normal_().mul_(2.0 ** (-n / 2))
        outs = [planes.clone() for _ in range(2)]
        for name, out in zip(("base", "old_loop"), outs):
            launch(built[name][0], once, out)
        torch.cuda.synchronize()
        diff = float((outs[0] - outs[1]).abs().max())
        del outs
        summary[f"{dtype_name}_base_vs_old_loop_max_abs_diff"] = diff
        print(f"  base vs old_loop on one state: max|diff| {diff:.3e}",
              flush=True)
        for name, (lib, _) in built.items():
            # a fresh state: an ablated variant may have left non-numbers
            planes.normal_().mul_(2.0 ** (-n / 2))
            t1, t3 = ms(lib, once), ms(lib, thrice)
            stage = (t3 - t1) / 2
            for _ in range(max(1, int(1500.0 / t3))):
                launch(lib, thrice)
            time.sleep(0.5)
            under_load = clocks()
            torch.cuda.synchronize()
            summary[f"{dtype_name}_{name}_ms"] = stage
            summary[f"{dtype_name}_{name}_clock_power"] = under_load
            print(f"  {name:9s} {stage:8.3f} ms (layers of 1 and 3: "
                  f"{t1:.3f}, {t3:.3f} ms); SM clock, power under load: "
                  f"{under_load}", flush=True)
        summary[f"{dtype_name}_bound_ms"] = bound
        del planes
        torch.cuda.empty_cache()
    print(json.dumps({"lane_stage_probe": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
