"""Inverse-CDF shot sampling, of one register and over batches of states.

Counterpart of the single-register sampler of the JAX package's
``sampleOutcomes`` (``api.py`` ``_jit_sample``) and of the samplers of its
``parallel/sampling.py`` (``sample_sharded``, ``sample_batched``,
``sample_mixture``, ``shot_bucket``). Uniforms come from a :class:`torch.Generator` on the CPU
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
           "sample_mixture", "sample_sharded"]


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


def sample_sharded(chunks: list, uniforms: torch.Tensor, density: bool,
                   num_qubits: int, local_top: int):
    """Inverse-CDF draws from an amplitude-sharded register, shard-local in
    two stages (the JAX package's ``sample_sharded``): each shard sums its
    outcome probabilities in float64; a draw ``u * total`` picks its shard
    from the running shard totals on the host, then its outcome from that
    shard's own cumulative sum, so no shard sees another's amplitudes.
    ``chunks`` are the canonical chunks (a density register's: the
    diagonal it holds); ``num_qubits`` is the register's qubit count.
    Returns ``(indices int64 ndarray, total)``."""
    from .chunks import density_diagonal
    cums, firsts = [], []
    for d, c in enumerate(chunks):
        if density:
            diag, r0 = density_diagonal(c, d, num_qubits, local_top)
            if diag is None:
                cums.append(None)
                firsts.append(0)
                continue
            probs = diag.clamp(min=0.0)
        else:
            probs = c[0] * c[0] + c[1] * c[1]
            r0 = d << local_top
        cums.append(torch.cumsum(probs, 0, dtype=torch.float64))
        firsts.append(r0)
    totals = np.array([float(cm[-1]) if cm is not None else 0.0
                       for cm in cums])
    edges = np.cumsum(totals)
    total = float(edges[-1])
    draws = uniforms.double().cpu().numpy() * total
    shard = np.minimum(np.searchsorted(edges, draws, side="right"),
                       len(chunks) - 1)
    # an empty shard never takes a draw: move any onto the last non-empty
    nonempty = np.nonzero(totals > 0.0)[0]
    if nonempty.size:
        shard = np.where(totals[shard] > 0.0, shard, nonempty[-1])
    idx = np.empty(draws.shape[0], dtype=np.int64)
    for d in np.unique(shard):
        sel = np.nonzero(shard == d)[0]
        cm = cums[d]
        resid = torch.as_tensor(draws[sel] - (edges[d] - totals[d]),
                                dtype=torch.float64, device=cm.device)
        loc = torch.searchsorted(cm, resid, right=True).clamp_(
            max=cm.shape[0] - 1)
        idx[sel] = loc.cpu().numpy().astype(np.int64) + firsts[d]
    return idx, total
