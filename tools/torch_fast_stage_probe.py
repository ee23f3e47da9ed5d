#!/usr/bin/env python3
"""Where the FAST dense stage's time goes, on one CUDA card.

Builds the layer kernel (``quest_tpu_torch/csrc``) in variants that each
leave one part of ``stage_dense_fast``'s K loop out, and times ONE dense
stage of each variant on a 30-qubit float32 state, for j = 0 (a lane
stage, dim 128), j = 1 and j = 2 (``rowmxu`` stages on the tile's top one
and two row bits, dim 256 and 512). A stage's time is the difference of a layer holding it
three times and a layer holding it once, halved (the tile's HBM pass
cancels). The variants compute wrong amplitudes: they are timings only.

- ``base``: the kernel as built by ``ops/cuda_build.py``;
- ``no_gather``: the A slab is not rewritten after the first slab;
- ``no_fetch``: the operator slab is not copied after the first slab;
- ``no_sync``: no ``cp.async`` wait and no barrier per slab (racy);
- ``mma_only``: no copy, no gather, no shared-memory fragment loads (the
  fragments are registers made from the loop indices), barriers kept:
  the ``mma.sync`` instructions alone at this kernel's 8 warps per SM.

Run from the root of a checkout (the variants build under
``build/fast_stage_probe/``)::

    python3 tools/torch_fast_stage_probe.py
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

QUBITS = 30
REPS = 3

GATHER = "    if (k + 1 < kSteps) {\n      fast_gather<J>("
NO_GATHER = "    if (false) {\n      fast_gather<J>("
FETCH = "    if (k + 1 < kSteps) fast_fetch_op<J>(nxt, ops, k + 1);"
SYNC = ("    cp_async_wait_all();\n    __syncthreads();\n"
        "    unsigned char* cur")
NO_SYNC = "    unsigned char* cur"
A_LOAD = ("        a[m][p] = "
          "a_s[((kFastWarpMTiles * wm + m) * 4 + p) * 32 + lane];")
A_REGS = "        a[m][p] = make_uint4(lane, p, m, k);"
B_LOAD = ("      const uint4 b = "
          "b_s[(kFastWarpNTiles * wn + n) * 32 + lane];")
B_REGS = "      const uint4 b = make_uint4(lane, n, k, 7);"

VARIANTS = {
    "base": [],
    "no_gather": [(GATHER, NO_GATHER)],
    "no_fetch": [(FETCH, "")],
    "no_sync": [(SYNC, NO_SYNC)],
    "mma_only": [(GATHER, NO_GATHER), (FETCH, ""), (A_LOAD, A_REGS),
                 (B_LOAD, B_REGS)],
}


def build(cuda_build) -> dict:
    """One ``nvcc`` per variant, all started together; returns {variant:
    (FAST entry point, registers line)}."""
    header = (cuda_build.CSRC / "dense_stage.cuh").read_text()
    out_dir = ROOT / "build" / "fast_stage_probe"
    procs = {}
    for name, edits in VARIANTS.items():
        src = out_dir / name
        shutil.rmtree(src, ignore_errors=True)
        src.mkdir(parents=True)
        for path in cuda_build.CSRC.iterdir():
            shutil.copy(path, src / path.name)
        text = header
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: the stage no longer has "
                                 f"{old!r}")
            text = text.replace(old, new)
        (src / "dense_stage.cuh").write_text(text)
        procs[name] = subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
             str(src / "layer_kernel.so"), str(src / "layer_kernel.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    entries = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name}:\n{log}")
        # the registers line that follows the FAST instance's entry
        lines = log.splitlines()
        start = next(i for i, line in enumerate(lines)
                     if "Compiling entry function" in line
                     and "layer_kernelIfLb1E" in line)
        regs = next(line.split(":", 1)[1].strip()
                    for line in lines[start:] if "registers" in line)
        fn = ctypes.CDLL(str(out_dir / name / "layer_kernel.so")
                         ).quest_layer_apply_fast_f32
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        entries[name] = (fn, regs)
    return entries


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
    entries = build(cuda_build)
    for name, (_, regs) in entries.items():
        print(f"  {name:10s} FAST instance: {regs}")

    n = QUBITS
    planes = torch.empty(2, 1 << n, device="cuda")
    rng = np.random.default_rng(1)

    def launch(fn, layer):
        desc, pool, fast_pool, max_j, tile_rows, total_rows = \
            lk._fast_operands(layer, n, planes.device)
        err = fn(planes.data_ptr(), planes.data_ptr() + 4 * (1 << n),
                 desc.data_ptr(), desc.shape[0], pool.data_ptr(),
                 fast_pool.data_ptr(), max_j, total_rows, tile_rows, 1,
                 2 * (1 << n), torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch failed: {err}")

    def ms(fn, layer):
        launch(fn, layer)
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(REPS):
            launch(fn, layer)
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / REPS

    top = lk.max_mid_qubit(lk.tile_rows_for(torch.float32)) - 7
    for j, bits in ((0, ()), (1, (top,)), (2, (top - 1, top))):
        dim = 128 << j
        z = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
        m = np.linalg.qr(z)[0]
        st = ("lane", m) if j == 0 else ("rowmxu", bits, m)
        once = lk.LayerOp(n, 1, [st])
        thrice = lk.LayerOp(n, 3, [st] * 3)
        bound = 1e3 * 16.0 * dim * (1 << n) / 989.0e12
        print(f"one FAST dense stage, j = {j} (dim {dim}), {n} qubits; "
              f"bf16 tensor-core bound {bound:.3f} ms")
        for name, (fn, _) in entries.items():
            # a fresh state: a racy variant may have left non-numbers
            planes.normal_().mul_(2.0 ** (-n / 2))
            t1, t3 = ms(fn, once), ms(fn, thrice)
            print(f"  {name:10s} {(t3 - t1) / 2:8.3f} ms (layers of 1 and "
                  f"3: {t1:.3f}, {t3:.3f} ms)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
