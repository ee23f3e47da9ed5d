"""Fused per-trajectory Kraus draw + apply + renormalise.

Counterpart of the JAX package's ``fused_kraus_apply_batched``
(``ops/pallas_kernels.py``, body ``_kraus_kernel``). For a batch of ``T``
trajectory states ``(T, 2, 2^n)`` and one Kraus channel whose targets are
all lane qubits (< 7), each trajectory draws one of the channel's ``K``
operators by inverse CDF over its probabilities ``p[t, :]`` against its
uniform ``u[t]``, and the drawn operator, lane-embedded as a 128 x 128
matrix and scaled by ``1/sqrt(p_j)``, multiplies every row of the state.

The draw is the TPU kernel's arithmetic, in the plane dtype and in its
order (:func:`draw_plain`): ``total`` is the left-to-right sum of
``p[t, :]``; ``uu = min(u * total, total - total * eps)`` stays strictly
below the total, so a trailing zero-probability branch is never drawn at
``u -> 1``; ``j = min(#{k : cumsum_k <= uu}, K - 1)``, so a leading
zero-probability branch is skipped at ``u = 0``; ``scale =
1/sqrt(max(p_j, tiny))``.

Both take an optional ``(T,)`` int32 ``index_out`` tensor that receives each
trajectory's drawn index ``j`` (the gradient walk records its branches from
it; the kernel writes it from the draw it made, so nothing draws twice).

On a CUDA tensor :func:`fused_kraus_apply_batched` launches the
hand-written kernel ``csrc/kraus_kernel.cu`` (built at first use,
``ops/cuda_build.py``); on a CPU tensor it runs
:func:`fused_kraus_apply_batched_plain`. A CUDA tensor never reaches the
plain version.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import cuda_build
from .layer_kernel import LANES, shared_memory_bytes, tile_rows_for

__all__ = ["draw_plain", "fused_kraus_apply_batched",
           "fused_kraus_apply_batched_plain", "shared_memory_for",
           "build_library"]


def draw_plain(probs: torch.Tensor, u01: torch.Tensor):
    """The inverse-CDF draw of every trajectory: ``(T, K)`` probabilities
    and ``(T,)`` uniforms in the plane dtype -> ``(j int64 (T,), scale
    (T,))``, with the TPU kernel's arithmetic and order."""
    num_ops = probs.shape[1]
    info = torch.finfo(probs.dtype)
    total = probs[:, 0].clone()
    for k in range(1, num_ops):
        total = total + probs[:, k]
    uu = torch.minimum(u01 * total, total - total * info.eps)
    cum = torch.zeros_like(total)
    cnt = torch.zeros(probs.shape[0], dtype=torch.int64, device=probs.device)
    for k in range(num_ops):
        cum = cum + probs[:, k]
        cnt += (cum <= uu).to(torch.int64)
    j = torch.clamp(cnt, max=num_ops - 1)
    psel = probs.gather(1, j[:, None])[:, 0]
    return j, 1.0 / torch.sqrt(torch.clamp(psel, min=info.tiny))


def _check(states: torch.Tensor, num_qubits: int, kstack: np.ndarray,
           probs: torch.Tensor, u01: torch.Tensor, index_out=None) -> None:
    if num_qubits < 7:
        raise ValueError("the fused Kraus kernel needs at least 7 qubits")
    if states.dim() != 3 or tuple(states.shape[1:]) != (2, 1 << num_qubits):
        raise ValueError(f"states have shape {tuple(states.shape)}, "
                         f"expected (T, 2, {1 << num_qubits})")
    if states.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"states must be float32 or float64, got "
                         f"{states.dtype}")
    if not states.is_contiguous():
        raise ValueError("states must be contiguous")
    num_traj = states.shape[0]
    if kstack.ndim != 3 or kstack.shape[1:] != (LANES, LANES):
        raise ValueError(f"the operator stack must be (K, 128, 128), got "
                         f"{kstack.shape}")
    if kstack.shape[0] < 1:
        raise ValueError("the fused Kraus kernel needs at least one "
                         "operator")
    if tuple(probs.shape) != (num_traj, kstack.shape[0]):
        raise ValueError(f"probabilities have shape {tuple(probs.shape)}, "
                         f"expected ({num_traj}, {kstack.shape[0]})")
    if tuple(u01.shape) != (num_traj,):
        raise ValueError(f"uniforms have shape {tuple(u01.shape)}, "
                         f"expected ({num_traj},)")
    for name, t in (("probabilities", probs), ("uniforms", u01)):
        if t.dtype != states.dtype or t.device != states.device:
            raise ValueError(f"{name} must be {states.dtype} on "
                             f"{states.device}")
    if index_out is not None and (
            index_out.dtype != torch.int32
            or tuple(index_out.shape) != (num_traj,)
            or index_out.device != states.device
            or not index_out.is_contiguous()):
        raise ValueError(f"index_out must be a contiguous ({num_traj},) "
                         f"int32 tensor on {states.device}")


def fused_kraus_apply_batched_plain(states: torch.Tensor, num_qubits: int,
                                    kstack: np.ndarray, probs: torch.Tensor,
                                    u01: torch.Tensor,
                                    index_out=None) -> torch.Tensor:
    """The fused Kraus step as plain PyTorch tensor ops, IN PLACE on the
    ``(T, 2, 2^n)`` states (returned): the draw of :func:`draw_plain`, the
    drawn lane operators scaled by ``1/sqrt(p_j)`` (the TPU kernel folds
    the scale into the operator too), one batched lane product; the drawn
    indices into ``index_out`` when it is given."""
    _check(states, num_qubits, kstack, probs, u01, index_out)
    j, scale = draw_plain(probs, u01)
    if index_out is not None:
        index_out.copy_(j)
    kstack = np.asarray(kstack, dtype=np.complex128)
    kr, ki = (torch.as_tensor(np.ascontiguousarray(p), dtype=states.dtype,
                              device=states.device)
              for p in (kstack.real, kstack.imag))
    s = scale[:, None, None]
    mr_t = (kr[j] * s).transpose(1, 2)
    mi_t = (ki[j] * s).transpose(1, 2)
    x = states.view(states.shape[0], 2, -1, LANES)
    re, im = x[:, 0], x[:, 1]
    new_re = torch.matmul(re, mr_t)
    new_re.sub_(torch.matmul(im, mi_t))
    new_im = torch.matmul(re, mi_t)
    new_im.add_(torch.matmul(im, mr_t))
    re.copy_(new_re)
    im.copy_(new_im)
    return states


@functools.lru_cache(maxsize=None)
def build_library() -> tuple:
    """Build (all of the port's kernels, ``ops/cuda_build.py``) and load
    ``csrc/kraus_kernel.cu``. Returns ``(ctypes.CDLL, path,
    compiler_output)``."""
    lib, path, log = cuda_build.library("kraus_kernel")
    p = ctypes.c_void_p
    for name in ("quest_kraus_apply_f32", "quest_kraus_apply_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
    lib.quest_kraus_lane_scratch_bytes.argtypes = [ctypes.c_int]
    lib.quest_kraus_lane_scratch_bytes.restype = ctypes.c_longlong
    lib.quest_kraus_error_string.argtypes = [ctypes.c_int]
    lib.quest_kraus_error_string.restype = ctypes.c_char_p
    return lib, path, log


def _raise_on(lib, err: int) -> None:
    if err != 0:
        raise cuda_build.KernelLaunchError(
            "Kraus kernel launch failed: "
            + lib.quest_kraus_error_string(err).decode())


def shared_memory_for(num_qubits: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of the kernel on ``2^n``-amplitude
    states: its row tile of both planes and the lane stage's operator ring,
    sized as the layer kernel's full-precision launches are
    (``layer_kernel.shared_memory_bytes``)."""
    tile_rows = min(tile_rows_for(dtype), (1 << num_qubits) // LANES)
    return shared_memory_bytes(tile_rows, dtype.itemsize)


def _device_stack(kstack: np.ndarray, dtype, device) -> torch.Tensor:
    """``(K, 2, 128, 128)``: per operator, K_k^T's real then imaginary
    part — the transposed layout the shared dense stage reads."""
    kt = np.asarray(kstack, dtype=np.complex128).transpose(0, 2, 1)
    return torch.as_tensor(np.ascontiguousarray(
        np.stack([kt.real, kt.imag], axis=1)), dtype=dtype, device=device)


def fused_kraus_apply_batched(states: torch.Tensor, num_qubits: int,
                              kstack: np.ndarray, probs: torch.Tensor,
                              u01: torch.Tensor,
                              index_out=None) -> torch.Tensor:
    """Draw and apply one Kraus channel for a whole trajectory batch, IN
    PLACE on the ``(T, 2, 2^n)`` states (returned): ``kstack`` is the
    ``(K, 128, 128)`` LANE-EMBEDDED operator stack, ``probs`` the ``(T,
    K)`` channel probabilities and ``u01`` the ``(T,)`` uniforms, both in
    the plane dtype on the states' device; ``index_out``, when given, a
    ``(T,)`` int32 tensor there that receives the drawn indices.

    A CUDA tensor launches the kernel (one block per row tile and
    trajectory) and counts it in ``fused_kraus_apply_batched.launches``;
    a CPU tensor runs :func:`fused_kraus_apply_batched_plain`."""
    kstack = np.asarray(kstack)
    _check(states, num_qubits, kstack, probs, u01, index_out)
    if states.device.type == "cpu":
        return fused_kraus_apply_batched_plain(states, num_qubits, kstack,
                                               probs, u01, index_out)
    if states.device.type != "cuda":
        raise ValueError(f"fused_kraus_apply_batched: unsupported device "
                         f"{states.device}")
    total_rows = (1 << num_qubits) // LANES
    tile_rows = min(tile_rows_for(states.dtype), total_rows)
    shared_memory_for(num_qubits, states.dtype)
    if states.data_ptr() % 16:
        raise ValueError("fused_kraus_apply_batched: states must be 16-byte "
                         "aligned")
    lib = build_library()[0]
    stack = _device_stack(kstack, states.dtype, states.device)
    probs = probs.contiguous()
    u01 = u01.contiguous()
    fn = lib.quest_kraus_apply_f32 if states.dtype == torch.float32 \
        else lib.quest_kraus_apply_f64
    num_amps = 1 << num_qubits
    with torch.cuda.device(states.device):
        stream = torch.cuda.current_stream(states.device).cuda_stream
        err = fn(states.data_ptr(),
                 states.data_ptr() + num_amps * states.element_size(),
                 stack.data_ptr(), probs.data_ptr(), u01.data_ptr(),
                 None if index_out is None else index_out.data_ptr(),
                 kstack.shape[0], states.shape[0], total_rows, tile_rows,
                 2 * num_amps, stream)
    _raise_on(lib, err)
    fused_kraus_apply_batched.launches += 1
    return states


fused_kraus_apply_batched.launches = 0

