"""Inverse-CDF shot sampling, of one register and over batches of states.

Counterpart of the single-register sampler of the JAX package's
``sampleOutcomes`` (``api.py`` ``_jit_sample``) and of the batch samplers of
its ``parallel/sampling.py`` (``sample_batched``, ``sample_mixture``,
``shot_bucket``). Uniforms come from a :class:`torch.Generator` on the CPU
(the env's, unless the caller passes another), are drawn in float64, and
move to the states' device in the plane dtype; a CUDA batch and a CPU batch
therefore sample with the same numbers. The JAX package draws from its
threefry keys instead, so the two packages agree in distribution, not in
draws.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["shot_bucket", "sample_outcomes", "sample_batched",
           "sample_mixture"]


def sample_outcomes(probs: torch.Tensor, uniforms: torch.Tensor):
    """Inverse-CDF draws from one unnormalised distribution: ``probs`` is
    ``(N,)`` (any float dtype, on any device), ``uniforms`` the draws in
    [0, 1) (float64, on the host or the device). Returns ``(indices,
    total)`` on ``probs``' device: int64 indices, and the float64 sum of
    ``probs``.

    One cumulative sum in float64 and one search per draw against ``u *
    total`` (so norm drift cannot bias the tail bin), clamped so a draw
    that rounds up to the total cannot index past the register. The sum
    accumulates in float64 whatever the planes' dtype: over 2^30 float32
    probabilities a float32 running sum carries its rounding into the
    tail bins."""
    cum = torch.cumsum(probs, 0, dtype=torch.float64)
    total = cum[-1]
    draws = uniforms.to(device=cum.device, dtype=torch.float64) * total
    idx = torch.searchsorted(cum, draws, right=True)
    return idx.clamp_(max=probs.shape[0] - 1), total


def shot_bucket(num_samples: int) -> int:
    """Shot-count bucket: the next power of two at or above ``num_samples``
    (floor 16). The sampler draws a whole bucket and keeps the first
    ``num_samples`` draws, which are iid, so the kept prefix is an exact
    ``num_samples``-shot draw."""
    b = 16
    while b < num_samples:
        b <<= 1
    return b


def sample_batched(planes: torch.Tensor, generator: torch.Generator,
                   num_samples: int):
    """Draw ``num_samples`` basis outcomes from EACH state of a ``(B, 2, N)``
    batch: one cumulative sum per state and one batched search for all
    draws. Returns ``(indices, totals)``: int64 ``(B, num_samples)``
    indices and the ``(B,)`` pre-sampling norms (float64), as numpy arrays.
    The cumulative sums accumulate in float64 whatever the planes' dtype,
    as in :func:`sample_outcomes`: a float32 running sum over 2^24
    probabilities on the card drifts by ~3e-4, in the totals and in the
    tail bins."""
    if int(num_samples) < 1:
        raise ValueError("num_samples must be >= 1")
    if planes.dim() != 3 or planes.shape[1] != 2:
        raise ValueError(f"expected (B, 2, N) planes, got "
                         f"{tuple(planes.shape)}")
    bucket = shot_bucket(int(num_samples))
    u = torch.rand((planes.shape[0], bucket), generator=generator,
                   dtype=torch.float64)
    probs = planes[:, 0] * planes[:, 0] + planes[:, 1] * planes[:, 1]
    cum = torch.cumsum(probs, dim=1, dtype=torch.float64)
    del probs
    totals = cum[:, -1]
    draws = u.to(device=planes.device) * totals[:, None]
    idx = torch.searchsorted(cum, draws, right=True)
    idx = torch.clamp(idx, max=planes.shape[2] - 1)
    return (idx[:, :num_samples].cpu().numpy().astype(np.int64),
            totals.cpu().numpy())


def sample_mixture(planes: torch.Tensor, generator: torch.Generator,
                   num_samples: int):
    """Draw ``num_samples`` basis outcomes from the uniform MIXTURE of a
    ``(T, 2, N)`` trajectory ensemble (every trajectory carries weight 1/T),
    with the shot budget STRATIFIED evenly over the trajectories:
    ceil(S/T) iid draws each, interleaved trajectory-major and trimmed to
    S — an unbiased, variance-reduced sampling of the mixture. Returns
    ``(indices int64 (num_samples,), totals (T,))``."""
    if int(num_samples) < 1:
        raise ValueError("num_samples must be >= 1")
    num_traj = planes.shape[0]
    per = -(-int(num_samples) // num_traj)
    idx, totals = sample_batched(planes, generator, per)
    # trajectory-major round robin, so a trimmed prefix still spreads over
    # every trajectory
    return idx.T.reshape(-1)[:num_samples], totals
