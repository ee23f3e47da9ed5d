"""Hamiltonian dynamics on the device: Trotterised real-time evolution and
imaginary-time / Lanczos ground-state search.

Counterpart of the JAX package's ``ops/dynamics.py``, over the Pauli-sum
bit masks of :mod:`quest_tpu_torch.ops.reductions`:

- a Pauli string is three integer masks; ``exp(-i theta P)`` is the exact
  two-term rotation ``cos(theta) z - i sin(theta) (P z)`` (``P^2 = I``),
  one xor-gather pass per term;
- a first-order Trotter step is one ascending sweep over the terms; a
  second-order (Strang) step is a half-angle forward sweep followed by a
  half-angle REVERSE sweep, the mirror symmetry that buys the O(dt^2) ->
  O(dt^3) local error;
- imaginary time replaces the rotation with the exact hyperbolic form
  ``cosh(tau c) z - sinh(tau c) (P z)`` and renormalises every row:
  power iteration toward the ground state;
- :func:`lanczos_ground` is the Krylov option: a fixed-m Lanczos
  recursion (``H v`` through :func:`~quest_tpu_torch.ops.reductions.
  pauli_sum_apply_sv`), an ``(m, m)`` tridiagonal eigensolve and the Ritz
  vector, with the residual bound ``beta_m |y_m|``.

Every step works on all rows of a ``(B, 2, 2^n)`` batch of planes at once
(the JAX package ``vmap``s one row), and the masks, coefficients and
angles are host data: the term loops are host loops that read nothing back
from the device. The trig of each term's angle is taken on the host, from
the angle rounded to the planes' real dtype as the JAX package rounds it.
Zero-coefficient padding terms (:func:`~quest_tpu_torch.ops.reductions.
pauli_term_bucket`) are exact identities (``cos 0 = cosh 0 = 1``, ``sin 0 =
sinh 0 = 0``) and are skipped. The batched dispatches are
:meth:`quest_tpu_torch.circuits.CompiledCircuit.evolve_sweep` and
``ground_sweep``, which return a segment as ONE packed real block per row;
the pack/unpack layout is defined here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import reductions as red

__all__ = ["EvolveSpec", "GroundSpec", "trotter_sweep", "trotter_step",
           "imag_time_step", "lanczos_ground", "evolve_block_width",
           "ground_block_width", "pack_evolve_block",
           "unpack_evolve_block", "pack_ground_block",
           "unpack_ground_block"]


# ---------------------------------------------------------------------------
# request contracts
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EvolveSpec:
    """One real-time evolution contract: evolve by ``exp(-i H t)`` in
    ``steps`` Trotter steps of order ``order`` (1 or 2), recording the
    Pauli-sum energy after every step. ``dt = t / steps``."""

    t: float
    steps: int
    order: int = 2

    def __post_init__(self):
        if self.steps < 1:
            raise ValueError("steps must be >= 1")
        if self.order not in (1, 2):
            raise ValueError("Trotter order must be 1 or 2")
        if not np.isfinite(self.t):
            raise ValueError("evolution time must be finite")

    @property
    def dt(self) -> float:
        return float(self.t) / float(self.steps)

    def contract(self) -> tuple:
        """The hashable convergence-contract tail of a coalesce key:
        requests sharing a compiled program AND this contract batch into
        one step loop."""
        return (float(self.t), int(self.steps), int(self.order))


@dataclasses.dataclass(frozen=True)
class GroundSpec:
    """One ground-state search contract. ``method`` is ``"power"``
    (imaginary-time Trotter power iteration, ``steps`` iterations per
    segment at time-step ``tau``) or ``"lanczos"`` (a fixed-``steps``
    Krylov recursion; ``tau`` unused). ``tol`` is the convergence residual
    a caller stops at: per-segment energy drift for power iteration, the
    ``beta_m |y_m|`` Ritz bound for Lanczos."""

    steps: int = 16
    tau: float = 0.1
    method: str = "power"
    tol: float = 1e-9

    def __post_init__(self):
        if self.steps < 1:
            raise ValueError("steps must be >= 1")
        if self.method not in ("power", "lanczos"):
            raise ValueError("method must be 'power' or 'lanczos'")
        if not (self.tau > 0.0 and np.isfinite(self.tau)):
            raise ValueError("tau must be finite and > 0")
        if not (self.tol >= 0.0):
            raise ValueError("tol must be >= 0")

    def contract(self) -> tuple:
        tau, tol = float(self.tau), float(self.tol)
        return (int(self.steps), tau, str(self.method), tol)


# ---------------------------------------------------------------------------
# step functions: (B, 2, N) planes, host masks, coefficients and angles
# ---------------------------------------------------------------------------


def _chunks(z) -> tuple:
    """``(chunks, single)``: a ``(B, 2, N)`` batch as the one-chunk list, or
    an amplitude-sharded batch's list of ``(B, 2, 2^(n-s))`` chunks as
    given."""
    if isinstance(z, (list, tuple)):
        return list(z), False
    return [z], True


def _local(chunks, local) -> int:
    return chunks[0].shape[-1].bit_length() - 1 if local is None \
        else int(local)


def _real_np(states) -> type:
    first = states[0] if isinstance(states, (list, tuple)) else states
    return np.float32 if first.dtype == torch.float32 else np.float64


def _angles(states, coeffs, theta) -> np.ndarray:
    """``theta * c_t`` for every term, rounded as the JAX package rounds
    it: both factors cast to the planes' real dtype, then multiplied."""
    rdt = _real_np(states)
    return np.asarray(theta).astype(rdt) * np.asarray(coeffs).astype(rdt)


def _popcount(v: int) -> int:
    return bin(int(v)).count("1")


def _term_sweep(states, xmask, ymask, zmask, keep, mix, ph_shift: int,
                reverse: bool = False, local=None):
    """``z <- keep_t z + mix_t i^ph_shift (P_t z)`` for every term in order
    (``reverse`` descending), IN PLACE; terms with ``mix_t == 0`` and
    ``keep_t == 1`` are identities and skipped. ``states`` is a batch or
    an amplitude-sharded batch's chunks of ``local`` qubits each: a term's
    X/Y bits on shard positions pair chunk ``d`` with chunk ``d ^ dx``, both
    gathered before either is updated, and the partner's shard bits give
    its sign (``parallel/chunks.py`` :func:`pauli_sum_apply`)."""
    chunks, _ = _chunks(states)
    lt = _local(chunks, local)
    mask = (1 << lt) - 1
    order = range(len(keep) - 1, -1, -1) if reverse else range(len(keep))
    for t in order:
        k, m = float(keep[t]), float(mix[t])
        if m == 0.0 and k == 1.0:
            continue
        xm, ym, zm = int(xmask[t]), int(ymask[t]), int(zmask[t])
        dx, yzd = (xm | ym) >> lt, (ym | zm) >> lt
        ph = _popcount(ym) % 4
        for d in range(len(chunks)):
            if d ^ dx < d:
                continue
            group = (d,) if dx == 0 else (d, d ^ dx)
            gathered = []
            for e in group:
                partner = e ^ dx
                g, _ = red.pauli_term_gather(
                    chunks[partner].to(chunks[e].device), xm & mask,
                    ym & mask, zm & mask)
                if _popcount(partner & yzd) % 2:
                    g.neg_()
                gathered.append(g)
            for e, g in zip(group, gathered):
                chunks[e].mul_(k)
                red.add_phased(chunks[e], g, ph + ph_shift, m)
            del gathered
    return states


def trotter_sweep(z, xmask, ymask, zmask, coeffs, theta, reverse=False,
                  local=None):
    """One ordered product sweep ``prod_t exp(-i theta c_t P_t) |z>`` on
    every row of a ``(B, 2, N)`` batch (or of an amplitude-sharded batch's
    chunks of ``local`` qubits), IN PLACE (returns ``z``): ascending term
    order, ``reverse=True`` descending (the mirror half of a Strang step).
    Each term is the exact rotation ``cos(a) z - i sin(a) (P z)`` with ``a
    = theta * c_t``: one xor-gather pass. ``theta`` is a host scalar."""
    a = _angles(z, coeffs, theta)
    # -i * i^ph = i^(ph + 3)
    return _term_sweep(z, xmask, ymask, zmask, np.cos(a), np.sin(a), 3,
                       reverse=bool(reverse), local=local)


def trotter_step(z, xmask, ymask, zmask, coeffs, dt, order: int = 2,
                 local=None):
    """One Trotter step of ``exp(-i H dt)`` on every row, IN PLACE.
    ``order=1`` is the plain ascending sweep at full ``dt`` (local error
    O(dt^2)); ``order=2`` the Strang splitting, a half-``dt`` forward sweep
    mirrored by a half-``dt`` reverse sweep (local error O(dt^3)).
    ``local`` as in :func:`trotter_sweep`."""
    if order == 1:
        return trotter_sweep(z, xmask, ymask, zmask, coeffs, dt, local=local)
    if order != 2:
        raise ValueError("Trotter order must be 1 or 2")
    half = np.asarray(dt) * 0.5
    z = trotter_sweep(z, xmask, ymask, zmask, coeffs, half, local=local)
    return trotter_sweep(z, xmask, ymask, zmask, coeffs, half, reverse=True,
                         local=local)


def _rows_total(parts: list) -> torch.Tensor:
    """Per-row sums, each part a chunk's ``(B,)`` partial in the plane
    dtype: combined in float64 in shard order on the first part's device,
    returned in the plane dtype (for one part, the part itself)."""
    home = parts[0].device
    total = parts[0].double()
    for p in parts[1:]:
        total = total + p.double().to(home)
    return total.to(parts[0].dtype)


def _row_norms(z) -> torch.Tensor:
    chunks, _ = _chunks(z)
    return _rows_total([c.square().sum(dim=(-2, -1)) for c in chunks]).sqrt()


def _row_dots(a, b) -> torch.Tensor:
    return _rows_total([(x * y).sum(dim=(-2, -1)) for x, y in zip(a, b)])


def _normalised(z, norms: torch.Tensor):
    """``z / max(norm, 1e-300)`` per row; the clamp is taken in the planes'
    dtype, as the JAX package takes it (at float32 it rounds to 0)."""
    scale = torch.clamp(norms, min=1e-300)[..., None, None]
    for c in _chunks(z)[0]:
        c.div_(scale.to(c.device))
    return z


def imag_time_step(z, xmask, ymask, zmask, coeffs, tau, local=None):
    """One imaginary-time Trotter step ``~ exp(-tau H) |z>`` on every row,
    then renormalisation of each row, IN PLACE: per term the exact
    hyperbolic form ``cosh(a) z - sinh(a) (P z)`` with ``a = tau * c_t``.
    Repeated, it is power iteration toward the ground state of ``H``. On
    chunks (``local`` as in :func:`trotter_sweep`) each row's norm sums
    its chunks' partial sums in float64."""
    a = _angles(z, coeffs, tau)
    # -i^ph = i^(ph + 2)
    _term_sweep(z, xmask, ymask, zmask, np.cosh(a), np.sinh(a), 2,
                local=local)
    return _normalised(z, _row_norms(z))


def _apply_h(vectors: list, xmask, ymask, zmask, coeffs, lt: int) -> list:
    """``H v`` of chunks (fresh chunks): :func:`~quest_tpu_torch.ops.
    reductions.pauli_sum_apply_sv` for one chunk, else term by term with
    the chunk pairs of :func:`quest_tpu_torch.parallel.chunks.
    pauli_sum_apply`."""
    if len(vectors) == 1:
        return [red.pauli_sum_apply_sv(vectors[0], xmask, ymask, zmask,
                                       coeffs)]
    from ..parallel import chunks as chk
    return chk.pauli_sum_apply(vectors, lt, xmask, ymask, zmask, coeffs,
                               [torch.empty_like(v) for v in vectors])


def lanczos_ground(z, xmask, ymask, zmask, coeffs, num_vectors: int = 24,
                   local=None):
    """Fixed-``num_vectors`` Lanczos recursion toward the ground state of
    every row of a ``(B, 2, N)`` batch (``z`` is left as it was): the
    Krylov basis by the three-term recurrence, an ``(m, m)`` tridiagonal
    eigensolve per row, and the Ritz vector of the lowest Ritz value.
    Returns ``(ritz_vectors (B, 2, N), energies (B,), residuals (B,))``
    with ``residual = |beta_m y_m|``, the classical bound on ``||H x - E
    x||``. On an amplitude-sharded batch's chunks (``local`` as in
    :func:`trotter_sweep`) the Ritz vectors are chunks too, and every inner
    product sums its chunks' partials in float64.

    A row whose Krylov space is exhausted (breakdown, ``beta <= 1e-12``:
    e.g. the start vector is an eigenvector) gets zero basis vectors from
    there on, and their diagonal entries are pinned far ABOVE the spectrum,
    so the decoupled block can never pose as the minimum Ritz value."""
    if num_vectors < 2:
        raise ValueError("lanczos needs num_vectors >= 2")
    m = int(num_vectors)
    chunks, single = _chunks(z)
    lt = _local(chunks, local)
    rdt = _real_np(chunks)
    cutoff = float(rdt(1e-12))
    home = chunks[0].device
    dtype = chunks[0].dtype
    v0 = [c.clone() for c in chunks]
    _normalised(v0, _row_norms(chunks))
    basis = [torch.empty((m,) + tuple(c.shape), dtype=dtype,
                         device=c.device) for c in chunks]
    batch = chunks[0].shape[0]
    beta_prev = chunks[0].new_zeros(batch)
    alive = torch.ones(batch, dtype=torch.bool, device=home)
    alphas, betas, alives = [], [], []
    v_cur = v0
    for k in range(m):
        for b, v in zip(basis, v_cur):
            b[k] = v
        w = _apply_h([b[k] for b in basis], xmask, ymask, zmask, coeffs, lt)
        if k:
            for wi, b in zip(w, basis):
                wi.sub_(beta_prev.to(wi.device)[:, None, None] * b[k - 1])
        alpha = _row_dots([b[k] for b in basis], w)
        for wi, b in zip(w, basis):
            wi.sub_(alpha.to(wi.device)[:, None, None] * b[k])
        beta = _row_norms(w)
        ok = alive & (beta > cutoff)
        scale = torch.clamp(beta, min=cutoff)[:, None, None]
        v_cur = [torch.where(
            ok.to(wi.device)[:, None, None], wi.div_(scale.to(wi.device)),
            torch.zeros((), dtype=dtype, device=wi.device)) for wi in w]
        beta_out = torch.where(ok, beta, torch.zeros_like(beta))
        alphas.append(alpha)
        betas.append(beta_out)
        # the flag the step started with: a step that breaks down still
        # contributes its own alpha
        alives.append(alive)
        beta_prev, alive = beta_out, ok
        del w
    alphas = torch.stack(alphas, dim=1)
    betas = torch.stack(betas, dim=1)
    shift = (rdt(np.sum(np.abs(np.asarray(coeffs)))) + 1.0) * 1e6
    diag = torch.where(torch.stack(alives, dim=1), alphas,
                       torch.full_like(alphas, float(shift)))
    off = betas[:, :-1]
    tri = torch.diag_embed(diag) + torch.diag_embed(off, 1) \
        + torch.diag_embed(off, -1)
    # a tiny batched dense eigensolve; on the card it waits once for the
    # solver's status (torch checks it), the one host synchronisation of
    # the recursion
    evals, evecs = torch.linalg.eigh(tri)
    y = evecs[:, :, 0]
    ritz = [torch.zeros_like(c) for c in chunks]
    for r, b in zip(ritz, basis):
        yd = y.to(r.device)
        for k in range(m):
            r.addcmul_(yd[:, k, None, None], b[k])
    del basis
    _normalised(ritz, _row_norms(ritz))
    return (ritz[0] if single else ritz), evals[:, 0], \
        (betas[:, -1] * y[:, -1]).abs()


# ---------------------------------------------------------------------------
# packed segment blocks
# ---------------------------------------------------------------------------
#
# An evolve/ground dispatch returns its whole segment as one flat real row
# per request: the per-step energies, the Welford (count, mean, M2) carry
# over them, [ground only: the convergence residual,] and the final
# planes. One layout definition keeps the pack and the unpack in step.


def evolve_block_width(num_qubits: int, steps: int) -> int:
    """Flat row width of one packed evolve segment: ``steps`` energies + 3
    Welford components + ``2 * 2^n`` plane entries."""
    return int(steps) + 3 + (1 << (int(num_qubits) + 1))


def ground_block_width(num_qubits: int, steps: int) -> int:
    """Evolve width + 1 (the convergence residual column)."""
    return evolve_block_width(num_qubits, steps) + 1


def pack_evolve_block(energies, welford, planes):
    """``(B, S)`` energies + ``(B, 3)`` Welford + ``(B, 2, 2^n)`` planes
    -> one ``(B, W)`` real block in the planes' dtype, on their device."""
    rdt = planes.dtype
    return torch.cat([energies.to(rdt), welford.to(rdt),
                      planes.reshape(planes.shape[0], -1)], dim=1)


def _host_block(block, width: int, kind: str) -> np.ndarray:
    """A packed block as host numpy (a tensor costs one transfer),
    shape-checked."""
    if isinstance(block, torch.Tensor):
        block = block.cpu().numpy()
    block = np.asarray(block)
    if block.ndim != 2 or block.shape[1] != width:
        raise ValueError(f"packed {kind} block must be (B, {width}); got "
                         f"{block.shape}")
    return block


def unpack_evolve_block(block, num_qubits: int, steps: int):
    """Inverse of :func:`pack_evolve_block`: ``(B, W)`` (numpy or a
    tensor) -> dict of ``energies (B, S)``, ``welford (B, 3)``, ``planes
    (B, 2, 2^n)``, as host numpy."""
    S = int(steps)
    block = _host_block(block, evolve_block_width(num_qubits, S), "evolve")
    return {"energies": block[:, :S],
            "welford": block[:, S:S + 3],
            "planes": block[:, S + 3:].reshape(
                block.shape[0], 2, 1 << int(num_qubits))}


def pack_ground_block(energies, residual, welford, planes):
    """Ground variant: the ``(B,)`` residual column sits between the
    energies and the Welford carry."""
    rdt = planes.dtype
    return torch.cat([energies.to(rdt), residual.reshape(-1, 1).to(rdt),
                      welford.to(rdt), planes.reshape(planes.shape[0], -1)],
                     dim=1)


def unpack_ground_block(block, num_qubits: int, steps: int):
    """``(B, W)`` -> dict of ``energies (B, S)``, ``residual (B,)``,
    ``welford (B, 3)``, ``planes (B, 2, 2^n)``, as host numpy."""
    S = int(steps)
    block = _host_block(block, ground_block_width(num_qubits, S), "ground")
    return {"energies": block[:, :S],
            "residual": block[:, S],
            "welford": block[:, S + 1:S + 4],
            "planes": block[:, S + 4:].reshape(
                block.shape[0], 2, 1 << int(num_qubits))}
