"""The quantum register: one ``(2, 2^N)`` float tensor of amplitudes.

A QUAD or QUAD64 register holds ``(4, 2^N)`` double-double planes
``[re_hi, re_lo, im_hi, im_lo]`` instead (``ops/doubledouble.py``); its
host copies combine them to complex128.

Counterpart of the JAX package's ``qureg.py`` on one device. The split
re/im planes keep the reference's layout (bit ``q`` of the amplitude index
is qubit ``q``; ``QuEST.h:161-192``). A density matrix of n qubits is the
flat 2n-qubit vector ``flat[r + c*2^n] = rho[r, c]`` (``QuEST.c:8-10``). Unlike the JAX
register, whose arrays are immutable and swapped on every update, the
planes here are updated IN PLACE by the gate engine and the layer kernel
wherever that saves a register-sized buffer (``core/apply.py``,
``ops/statevec.py``, ``ops/layer_kernel.py`` say where).

On a mesh env (``createQuESTEnv(num_devices=n)``) a register at least as
large as the mesh is AMPLITUDE-SHARDED: it holds ``2^s`` chunks of shape
``(2, 2^(N-s))``, chunk ``d`` on shard ``d``'s device holding amplitudes
``[d * 2^(N-s), (d+1) * 2^(N-s))`` (``QuEST.h:169-177``), and a lazy
logical->physical qubit permutation (``layout``) kept by the sharded
per-gate path (``parallel/pergate.py``). Its readers and writers go
through :attr:`Qureg.chunks`; :attr:`Qureg.state` raises
``NotImplementedError`` on it, so a function the mesh slice does not
route fails loudly instead of computing on a gathered copy. A register
smaller than the mesh stays whole on the first shard.

Every reader and writer goes through the :attr:`Qureg.state` property, so
the opt-in imperative gate fusion (``api.startGateFusion``) keeps program
order: a read applies the buffered gates first, a full overwrite drops
them, and the in-place writers (``swap_amps``, collapse, channels) read
before they write.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.packing import pack_host, unpack_host
from .env import QuESTEnv
from .ops.doubledouble import _dd_split_host, dd_unpack
from .qasm import QASMLogger

__all__ = ["Qureg"]


class Qureg:
    """A state-vector or density-matrix register bound to an
    environment."""

    def __init__(self, num_qubits: int, env: QuESTEnv,
                 is_density: bool = False):
        if env.mesh is not None and env.precision.quest_prec == 4:
            raise NotImplementedError(
                "QUAD registers on a mesh env wait for ROADMAP Queue 1 "
                "item 8's remainder; create the QUAD env on one device")
        self.env = env
        self.is_density_matrix = is_density
        self.num_qubits_represented = num_qubits
        self.num_qubits_in_state_vec = (2 * num_qubits) if is_density \
            else num_qubits
        self.num_amps_total = 1 << self.num_qubits_in_state_vec
        self.qasm_log = QASMLogger(num_qubits)
        self._state: torch.Tensor = None  # type: ignore[assignment]
        # a sharded register's chunks, one per shard
        self._chunks: list = None  # type: ignore[assignment]
        # lazy logical->physical qubit permutation over the state-vector
        # positions (None = identity), kept by the sharded per-gate path:
        # swaps are metadata and swap-to-local relayouts defer their
        # swap-back until a reader needs canonical order
        self.layout = None
        # opt-in imperative gate fusion (api.startGateFusion): while
        # active, gate calls buffer here and flush, contracted through
        # core/fusion.py, at the first state read
        self._fusion_buffer = None

    # -- reference struct-field aliases (QuEST.h:161-192 spellings) -------

    @property
    def isDensityMatrix(self) -> bool:
        return self.is_density_matrix

    @property
    def numQubitsRepresented(self) -> int:
        return self.num_qubits_represented

    @property
    def numQubitsInStateVec(self) -> int:
        return self.num_qubits_in_state_vec

    @property
    def numAmpsTotal(self) -> int:
        return self.num_amps_total

    # -- state plumbing ----------------------------------------------------

    @property
    def is_sharded(self) -> bool:
        """True for an amplitude-sharded register: a mesh env, and at
        least as many amplitudes as the mesh has shards."""
        return self.sharding() is not None

    def sharding(self):
        """This register's chunk layout on the env's mesh, or None off a
        mesh and when the register has fewer amplitudes than the mesh has
        shards (it then stays whole on the first shard, the JAX package's
        replicated fallback for ``numRanks > 2^n``, ``QuEST_cpu.c:1287``)."""
        if self.num_amps_total < self.env.num_devices:
            return None
        return self.env.sharding()

    def sharding_flat(self):
        return self.sharding()

    def _unrouted(self, what: str):
        return NotImplementedError(
            f"{what} on an amplitude-sharded register: this function is "
            "not routed over the mesh's chunks yet (ROADMAP Queue 1 item "
            "8); read amplitudes with getAmp or the calc* functions, or "
            "gather with to_numpy()")

    def _drain(self) -> None:
        buf = self._fusion_buffer
        if buf is not None and buf.pending and not buf.flushing:
            buf.flush()     # every reader sees buffered gates applied

    def _overwrite(self) -> None:
        buf = self._fusion_buffer
        if buf is not None and buf.pending and not buf.flushing:
            # a full overwrite supersedes pending gates (read-modify-write
            # callers flushed at the read; the flush's own writes are
            # fenced by buf.flushing)
            buf.discard()

    @property
    def state(self) -> torch.Tensor:
        if self._chunks is not None:
            raise self._unrouted("a whole-register read")
        self._drain()
        return self._state

    @state.setter
    def state(self, new_state: torch.Tensor) -> None:
        if self._chunks is not None or (
                new_state is not None and self.is_sharded):
            if new_state is not None:
                raise self._unrouted("a whole-register write")
            self._chunks = None
            return
        self._overwrite()
        self._state = new_state

    @property
    def chunks(self) -> list:
        """A sharded register's chunks (the buffered gates applied
        first), one ``(2, 2^(N-s))`` tensor per shard."""
        self._drain()
        return self._chunks

    @chunks.setter
    def chunks(self, new_chunks: list) -> None:
        self._overwrite()
        self.layout = None
        self._chunks = list(new_chunks)

    def flush_gates(self) -> None:
        """Apply any gates buffered by the opt-in imperative fusion path
        (``api.startGateFusion``). No-op otherwise."""
        buf = self._fusion_buffer
        if buf is not None:
            buf.flush()

    def ensure_canonical(self) -> None:
        """Drain the imperative fusion buffer and restore the identity
        qubit layout (one exchange) so the chunks read positionally. No
        layout is kept off the sharded per-gate path."""
        self.flush_gates()
        if self.layout is not None:
            from .parallel.pergate import canonicalise
            canonicalise(self)

    @property
    def is_quad(self) -> bool:
        """True for QUAD/QUAD64 registers: (4, 2^N) double-double planes
        (``ops/doubledouble.py``), the QuEST_PREC=4 analogue."""
        return self.env.precision.quest_prec == 4

    @property
    def num_amps_per_chunk(self) -> int:
        return self.num_amps_total // self.env.num_devices

    @property
    def num_chunks(self) -> int:
        return self.env.num_devices

    @property
    def device(self) -> torch.device:
        return self.env.device

    @property
    def dtype(self) -> torch.dtype:
        """Logical (complex) dtype of the amplitudes."""
        return self.env.precision.complex_dtype

    @property
    def real_dtype(self) -> torch.dtype:
        """Storage dtype of the split re/im planes."""
        return self.env.precision.real_dtype

    def device_put(self, host_array: np.ndarray) -> None:
        """Place a host complex array as the register state (packed to
        float planes on the env's device)."""
        host_array = np.asarray(host_array)
        if host_array.shape != (self.num_amps_total,):
            raise ValueError(
                f"state array has shape {host_array.shape}; this register "
                f"holds {self.num_amps_total} amplitudes")
        np_dtype = np.float32 if self.real_dtype == torch.float32 \
            else np.float64
        arr = _dd_split_host(host_array, np_dtype) if self.is_quad \
            else pack_host(host_array, np_dtype)
        if self.is_sharded:
            # each shard takes its own slice of the host array (the
            # reference's per-rank chunk fill, QuEST_cpu.c:1284-1320)
            per = self.num_amps_total // self.env.num_devices
            self.chunks = [torch.from_numpy(np.ascontiguousarray(
                arr[:, d * per:(d + 1) * per])).to(dev)
                for d, dev in enumerate(self.env.mesh.devices)]
            return
        self.state = torch.from_numpy(arr).to(  # discards pending gates
            self.device)

    def to_numpy(self) -> np.ndarray:
        """Copy the FULL state to the host as a complex vector — a test
        and debug seam: O(2^n) host memory. Use ``getAmp`` or the
        ``calc*`` reductions in real programs. A sharded register is put
        in canonical order first and its chunks gathered on the host."""
        if self.is_sharded:
            self.ensure_canonical()
            host = np.concatenate([c.cpu().numpy() for c in self.chunks],
                                  axis=1)
            return unpack_host(host)
        host = self.state.cpu().numpy()
        return dd_unpack(host) if self.is_quad else unpack_host(host)

    def density_matrix_numpy(self) -> np.ndarray:
        """``rho[r, c]`` of a density register (host-side): the transpose
        of the flat vector viewed as a square."""
        dim = 1 << self.num_qubits_represented
        return self.to_numpy().reshape(dim, dim).T

    def __repr__(self) -> str:
        kind = "density-matrix" if self.is_density_matrix \
            else "state-vector"
        return (f"Qureg({kind}, qubits={self.num_qubits_represented}, "
                f"amps={self.num_amps_total}, dtype={self.dtype}, "
                f"device={self.device}, devices={self.env.num_devices})")
