#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / H100 port (``quest_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (any unmet check exits non-zero and prints no result line):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` compiles ``quest_tpu_torch/csrc/layer_kernel.cu``;
3. the layer kernel against its plain PyTorch version, per stage kind, at
   20 qubits in float32 and float64 (max |diff| <= 1e-5 / 1e-12);
4. the main path at 30 qubits, complex64: the random-rotation + CNOT
   brickwork compiled and run through the layer kernel, against the same
   gates through the imperative per-gate API;
5. the 3-qubit tutorial flow on the card, against the same flow on the
   CPU in double precision;
6. times with CUDA events: the layer kernel on the main path's layers
   beside its bound, its plain version, a lane-only layer beside one
   ``torch.matmul`` of the same product, and the compiled path's gates/s;
7. a ``torch.profiler`` breakdown of one compiled run: device time per
   kernel and the device-busy share.

The line before the last is a JSON object describing each kernel of the
path; the last line is ``{"ok": true, "device": {...}}``. Nothing here
imports JAX or the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

MAIN_QUBITS = 30
MAIN_LAYERS = 2
CHECK_QUBITS = 20
PLAIN_QUBITS = 26
HBM_BYTES_PER_S = 3.35e12              # H100 SXM data sheet
CUDA_CORE_FLOPS = {4: 67.0e12, 8: 34.0e12}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)
    print(f"  ok: {what}")


def brickwork(num_qubits: int, layers: int):
    """The headline circuit: a random rotation on every qubit, then a CNOT
    brickwork, per layer (seeded; the JAX package's benchmark circuit).
    Returns a list of ("rot", q, angle, axis) / ("cnot", c, t) specs."""
    rng = np.random.default_rng(2026)
    gates = []
    for layer in range(layers):
        for q in range(num_qubits):
            gates.append(("rot", q, float(rng.uniform(0, 2 * np.pi)),
                          tuple(float(a) for a in rng.normal(size=3))))
        for q in range(layer % 2, num_qubits - 1, 2):
            gates.append(("cnot", q, q + 1))
    return gates


def as_circuit(qt, num_qubits: int, gates):
    c = qt.Circuit(num_qubits)
    for g in gates:
        if g[0] == "rot":
            c.rotate(g[1], g[2], g[3])
        else:
            c.cnot(g[1], g[2])
    return c


def run_per_gate(qt, qureg, gates) -> None:
    for g in gates:
        if g[0] == "rot":
            qt.rotateAroundAxis(qureg, g[1], g[2], g[3])
        else:
            qt.controlledNot(qureg, g[1], g[2])


def random_unitary(rng, dim: int) -> np.ndarray:
    z = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def random_planes(torch, rng, n: int, dtype, device):
    z = rng.normal(size=(2, 1 << n))
    z /= np.linalg.norm(z)
    return torch.as_tensor(z, dtype=dtype, device=device)


def stage_cases(rng, n: int, hi: int):
    """One random single-stage layer per stage kind, then a mixed one.
    Row bits are in row-bit coordinates (qubit = bit + 7)."""
    top = hi - 7                       # highest row bit a target may use
    far = n - 8                        # a row bit beyond any tile
    phase = lambda k: np.exp(1j * rng.uniform(0, 2 * np.pi, (1 << k, 128)))
    cases = {
        "lane": [("lane", random_unitary(rng, 128))],
        "clane": [("clane", random_unitary(rng, 128), 0b101 | (1 << far),
                   0b001 | (1 << far))],
        "row_lane_ctrl": [("row", 7 + top, random_unitary(rng, 2),
                           0b1000010, 0b0000010, 0, 0)],
        "row_row_ctrl": [("row", 8, random_unitary(rng, 2), 0, 0,
                          0b100 | (1 << far), 0b100)],
        "rowk2": [("rowk", (0, top), random_unitary(rng, 4), 0b11, 0b01,
                   1 << far, 1 << far)],
        "rowk3": [("rowk", (0, 2, top), random_unitary(rng, 8), 0, 0, 0,
                   0)],
        "rowdiag1": [("rowdiag", phase(1), (far,))],
        "rowdiag2": [("rowdiag", phase(2), (1, far))],
        "rowdiag3": [("rowdiag", phase(3), (0, 3, far))],
        "rowmxu1": [("rowmxu", (top,), random_unitary(rng, 256))],
        "rowmxu2": [("rowmxu", (1, top), random_unitary(rng, 512))],
    }
    cases["mixed"] = [st for stages in cases.values() for st in stages]
    return cases


def stage_flops(stage, n: int) -> float:
    """Real flops one kernel stage does on 2^n amplitudes, counting only
    the amplitudes its control masks select."""
    tag = stage[0]
    amps = float(1 << n)
    if tag == "lane":
        return 8.0 * 128 * amps / (1 << bin(stage[2]).count("1"))
    if tag == "rowmxu":
        return 8.0 * stage[3] * amps
    if tag in ("row", "rowk"):
        k = 1 if tag == "row" else len(stage[1])
        sel = bin(stage[3]).count("1") + bin(stage[5]).count("1")
        return 8.0 * (1 << k) * amps / (1 << sel)
    return 6.0 * amps                          # rowdiag: complex multiply


def layer_bound_ms(lk, layer, n: int, dtype):
    """Least time for one layer on the card: the larger of its HBM bytes
    (both planes read and written once, plus its operands) over 3.35 TB/s
    and its flops over the CUDA-core rate. Returns (ms, bound_by,
    bytes_ms, flops_ms)."""
    itemsize = dtype.itemsize
    kstages, mats, tables, xmats, _, _ = lk.layer_kernel_plan(
        layer, n, lk.tile_rows_for(dtype))
    operands = 2 * itemsize * (sum(m.size for m in mats)
                               + sum(t.size for t in tables)
                               + sum(x.size for x in xmats))
    bytes_ms = 1e3 * (4.0 * itemsize * (1 << n) + operands) / HBM_BYTES_PER_S
    flops_ms = 1e3 * sum(stage_flops(st, n) for st in kstages) \
        / CUDA_CORE_FLOPS[itemsize]
    return max(bytes_ms, flops_ms), \
        ("bytes" if bytes_ms >= flops_ms else "operations"), \
        bytes_ms, flops_ms


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps warm calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_device(torch):
    print("phase 1: device")
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise SmokeFailure(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"gpu: {card}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    return card


def phase_build(lk):
    print("phase 2: build")
    t0 = time.perf_counter()
    _, path, log = lk.build_library()
    print(f"  built {path} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def phase_stages(torch, lk, rng):
    print(f"phase 3: kernel vs plain version per stage kind, "
          f"{CHECK_QUBITS} qubits")
    n = CHECK_QUBITS
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        hi = lk.max_mid_qubit(lk.tile_rows_for(dtype))
        for name, stages in stage_cases(rng, n, hi).items():
            layer = lk.LayerOp(n, len(stages), stages)
            base = random_planes(torch, rng, n, dtype, "cuda")
            want = lk.apply_layer_plain(base.clone(), n, layer)
            before = lk.apply_layer.launches
            got = lk.apply_layer(base.clone(), n, layer)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            check(lk.apply_layer.launches == before + 1 and err <= tol
                  and bool(torch.isfinite(got).all()),
                  f"{name:14s} {str(dtype):14s} max|diff| {err:.3e} "
                  f"<= {tol:g}")


def phase_main(torch, qt, lk):
    n = MAIN_QUBITS
    print(f"phase 4: main path, {n} qubits, complex64, "
          f"{MAIN_LAYERS}-layer brickwork")
    env = qt.createQuESTEnv()
    check(env.device.type == "cuda" and env.precision.quest_prec == 1,
          f"default env on {env.device}, {env.precision.name}")
    gates = brickwork(n, MAIN_LAYERS)
    t0 = time.perf_counter()
    compiled = as_circuit(qt, n, gates).compile(env)
    compile_s = time.perf_counter() - t0
    layers = compiled.num_layers
    print(f"  compiled {len(gates)} gates into {len(compiled.plan.items)} "
          f"ops ({layers} layers) in {compile_s:.2f} s")
    q1 = qt.createQureg(n, env)
    qt.initZeroState(q1)
    lk.apply_layer.launches = 0
    compiled.run(q1)
    torch.cuda.synchronize()
    launches = lk.apply_layer.launches
    check(layers > 0 and launches == layers,
          f"layer kernel launched {launches} times for {layers} layer ops")

    q2 = qt.createQureg(n, env)
    qt.initZeroState(q2)
    run_per_gate(qt, q2, gates)
    torch.cuda.synchronize()
    dist = float(torch.linalg.vector_norm(q1.state - q2.state))
    check(dist <= 1e-4, f"||psi_compiled - psi_pergate||_2 = {dist:.3e}")
    for name, q in (("compiled", q1), ("per-gate", q2)):
        tp = qt.calcTotalProb(q)
        check(abs(tp - 1.0) <= 1e-4, f"{name} calcTotalProb = {tp!r}")
    for qubit in (0, n - 1):
        p1 = qt.calcProbOfOutcome(q1, qubit, 1)
        p2 = qt.calcProbOfOutcome(q2, qubit, 1)
        check(abs(p1 - p2) <= 1e-5 and 0.0 <= p1 <= 1.0,
              f"calcProbOfOutcome(q{qubit}=1): {p1!r} vs {p2!r}")
    outcome = qt.measure(q1, 0)
    tp = qt.calcTotalProb(q1)
    check(abs(tp - 1.0) <= 1e-4,
          f"measure(q0) -> {outcome}; post-state total prob {tp!r}")
    qt.destroyQureg(q2, env)
    return env, compiled, q1, gates, launches


def tutorial(qt, env):
    """The tutorial flow of the reference (3 qubits); returns the
    amplitudes before measurement, the probabilities it reads, the
    post-measurement total probability and the QASM text."""
    q = qt.createQureg(3, env)
    qt.startRecordingQASM(q)
    qt.initZeroState(q)
    qt.hadamard(q, 0)
    qt.controlledNot(q, 0, 1)
    qt.rotateY(q, 2, 0.1)
    qt.multiControlledPhaseFlip(q, [0, 1, 2])
    u = np.array([[0.5 + 0.5j, 0.5 - 0.5j], [0.5 - 0.5j, 0.5 + 0.5j]])
    qt.unitary(q, 0, u)
    a, b = 0.5 + 0.5j, 0.5 - 0.5j
    qt.compactUnitary(q, 1, a, b)
    qt.rotateAroundAxis(q, 2, 3.14 / 2, (1.0, 0.0, 0.0))
    qt.controlledCompactUnitary(q, 0, 1, a, b)
    qt.multiControlledUnitary(q, [0, 1], 2, u)
    toff = qt.createComplexMatrixN(3)
    for i in range(6):
        toff[i, i] = 1.0
    toff[6, 7] = toff[7, 6] = 1.0
    qt.multiQubitUnitary(q, [0, 1, 2], toff)
    amps = q.to_numpy()
    probs = (qt.getProbAmp(q, 7), qt.calcProbOfOutcome(q, 2, 1))
    qt.measure(q, 0)
    qt.measureWithStats(q, 2)
    return amps, probs, qt.calcTotalProb(q), q.qasm_log.text()


def phase_tutorial(torch, qt):
    print("phase 5: tutorial flow, 3 qubits")
    amps, probs, total, qasm = tutorial(qt, qt.createQuESTEnv(seed=[7]))
    ref_amps, ref_probs, _, _ = tutorial(
        qt, qt.createQuESTEnv(device="cpu", precision=qt.DOUBLE, seed=[7]))
    err = float(np.abs(amps - ref_amps).max())
    check(err <= 1e-5 and np.allclose(probs, ref_probs, atol=1e-5),
          f"card vs CPU double: max|amp diff| {err:.3e}, "
          f"P|111> {probs[0]:.6f}, P(q2=1) {probs[1]:.6f}")
    check(abs(total - 1.0) <= 1e-4 and qasm.startswith("OPENQASM 2.0;"),
          f"post-measure total prob {total!r}; QASM header present")


def phase_times(torch, qt, lk, env, compiled, q1, gates, launches, card):
    n = MAIN_QUBITS
    print(f"phase 6: times on {card}")
    planes = q1.state
    layer_ops = [op for op in compiled._ops if op.kind == "layer"]
    kernel_ms, plain_ms, bound_ms, errs, bound_by = [], [], [], [], []
    for i, layer in enumerate(layer_ops):
        a = planes.clone()
        lk.apply_layer(a, n, layer)
        b = lk.apply_layer_plain(planes.clone(), n, layer)
        torch.cuda.synchronize()
        errs.append(float((a - b).abs().max()))
        del a, b
        kernel_ms.append(cuda_ms(torch, lambda: lk.apply_layer(
            planes, n, layer), reps=3))
        plain_ms.append(cuda_ms(torch, lambda: lk.apply_layer_plain(
            planes, n, layer), reps=1))
        ms, by, hbm_ms, op_ms = layer_bound_ms(lk, layer, n, planes.dtype)
        bound_ms.append(ms)
        bound_by.append(by)
        print(f"  layer {i}: {[st[0] for st in layer.stages]}")
        print(f"    kernel {kernel_ms[-1]:.3f} ms, bound {ms:.3f} ms ({by}; "
              f"HBM {hbm_ms:.3f} ms, CUDA-core flops {op_ms:.3f} ms), "
              f"plain {plain_ms[-1]:.3f} ms, max|kernel-plain| "
              f"{errs[-1]:.3e}")
    check(max(errs) <= 1e-5, f"main-path layers: kernel vs plain max|diff| "
          f"{max(errs):.3e} <= 1e-5 at {n} qubits")
    torch.cuda.empty_cache()

    # the plain version at 26 qubits, on that width's own brickwork plan
    small = as_circuit(qt, PLAIN_QUBITS, brickwork(PLAIN_QUBITS,
                                                   MAIN_LAYERS))
    sc = small.compile(env)
    qs = qt.createQureg(PLAIN_QUBITS, env)
    small_layers = [op for op in sc._ops if op.kind == "layer"]
    for i, layer in enumerate(small_layers):
        k = cuda_ms(torch, lambda: lk.apply_layer(qs.state, PLAIN_QUBITS,
                                                  layer), reps=5)
        p = cuda_ms(torch, lambda: lk.apply_layer_plain(
            qs.state, PLAIN_QUBITS, layer), reps=3)
        print(f"  {PLAIN_QUBITS}q layer {i}: kernel {k:.3f} ms, "
              f"plain {p:.3f} ms")
    del qs
    torch.cuda.empty_cache()

    # a lane-only layer beside one torch.matmul of the same product
    rng = np.random.default_rng(11)
    m = random_unitary(rng, 128)
    lane = lk.LayerOp(n, 1, [("lane", m)])
    lane_ms = cuda_ms(torch, lambda: lk.apply_layer(planes, n, lane), reps=3)
    lane_bound, lane_by, _, _ = layer_bound_ms(lk, lane, n, planes.dtype)
    z = torch.complex(planes[0], planes[1]).view(-1, 128)
    mt = torch.as_tensor(m.T, dtype=torch.complex64, device=planes.device)
    lib_ms = cuda_ms(torch, lambda: torch.matmul(z, mt), reps=3)
    del z
    print(f"  lane-only layer: kernel {lane_ms:.3f} ms, bound "
          f"{lane_bound:.3f} ms ({lane_by}), torch.matmul complex64 "
          f"{lib_ms:.3f} ms")

    # the compiled path end to end, host clock around synchronised runs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 2
    for _ in range(reps):
        compiled.run(q1)
    torch.cuda.synchronize()
    run_s = (time.perf_counter() - t0) / reps
    print(f"  compiled run: {run_s * 1e3:.1f} ms per circuit, "
          f"{len(gates) / run_s:.1f} gates/s ({len(gates)} gates)")

    by = "operations" if bound_by.count("operations") * 2 > len(bound_by) \
        else "bytes"
    return {
        "name": "layer_kernel",
        "route": "cuda",
        "source": "quest_tpu_torch/csrc/layer_kernel.cu",
        "replaces": "quest_tpu/ops/pallas_kernels.py:297",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": float(np.mean(kernel_ms)),
        "plain_ms": float(np.mean(plain_ms)),
        "bound_ms": float(np.mean(bound_ms)),
        "bound_by": by,
        "library_ms": lib_ms,
        "lane_only_ms": lane_ms,
        "lane_only_bound_ms": lane_bound,
        "qubits": n,
        "gates_per_s": len(gates) / run_s,
    }


def phase_profile(torch, compiled, q1, card):
    """Where one compiled 30-qubit run spends the card's time: device time
    per kernel name from torch.profiler, and the device-busy share of the
    host wall time of the profiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    print(f"phase 7: profile of one compiled run on {card}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        compiled.run(q1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_name: dict = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            per_name.setdefault(ev.name, [0, 0.0])
            per_name[ev.name][0] += 1
            per_name[ev.name][1] += ev.time_range.elapsed_us()
    busy_us = sum(t for _, t in per_name.values())
    if not per_name:
        print("  device time: not measured (the profiler saw no device "
              "events)")
        return
    print(f"  wall {wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} "
          f"ms ({100.0 * busy_us / wall_us:.1f}%)")
    for name, (count, us) in sorted(per_name.items(),
                                    key=lambda kv: -kv[1][1])[:8]:
        print(f"  {us / 1e3:9.1f} ms {100.0 * us / busy_us:5.1f}% "
              f"x{count:<3d} {name[:90]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not importable", file=sys.stderr)
        return 2
    try:
        card = phase_device(torch)
        import quest_tpu_torch as qt
        from quest_tpu_torch.ops import layer_kernel as lk
        phase_build(lk)
        rng = np.random.default_rng(20261016)
        phase_stages(torch, lk, rng)
        env, compiled, q1, gates, launches = phase_main(torch, qt, lk)
        phase_tutorial(torch, qt)
        row = phase_times(torch, qt, lk, env, compiled, q1, gates, launches,
                          card)
        phase_profile(torch, compiled, q1, card)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    except ImportError as e:
        print(f"FAIL: {e} (run from the root of a checkout)",
              file=sys.stderr)
        return 2
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
