"""What every example shares: the device choice and the env it makes."""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

import quest_tpu_torch as qt


def resolve_device(device=None) -> torch.device:
    """The device an example runs on: ``cuda`` unless named. A CUDA device
    that does not exist raises; nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "this example runs on a CUDA device and none is available; "
            "pass device='cpu' (--device cpu) to run it on the host")
    return dev


def make_env(device=None, seed: Optional[Sequence[int]] = None,
             precision=None, num_devices: Optional[int] = None):
    """The example's env: one device (or ``num_devices`` shards of it),
    at ``precision``, or at the device's default (SINGLE on the card;
    DOUBLE on the host, where the JAX package's examples run with x64)."""
    dev = resolve_device(device)
    if precision is None:
        precision = qt.DOUBLE if dev.type == "cpu" else qt.SINGLE
    if num_devices is not None and num_devices > 1:
        if dev.type == "cpu":
            return qt.createQuESTEnv(num_devices=num_devices, device="cpu",
                                     precision=precision, seed=seed)
        return qt.createQuESTEnv(devices=[dev] * num_devices,
                                 precision=precision, seed=seed)
    return qt.createQuESTEnv(num_devices=1, device=dev, precision=precision,
                             seed=seed)


def synchronize(device) -> None:
    """Wait for the card's queued work (a timing point); nothing on the
    host."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def parse_device(doc: str) -> str:
    """The ``--device`` argument of an example's command line."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args().device
