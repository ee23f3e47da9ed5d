#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / H100 port (``quest_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py                 # every phase: the whole check
    python3 chip_smoke.py --only 3d,3e,10 # the build, then just these
    python3 chip_smoke.py --only 12       # the density phase
    python3 chip_smoke.py --only 13,12d   # gradients, density sweeps
    python3 chip_smoke.py --only 14       # the main-path remainder
    python3 chip_smoke.py --only 9g       # trajectory gradients
    python3 chip_smoke.py --only 15,16    # dynamics, algorithms, QASM
    python3 chip_smoke.py --only 17       # the QUAD tier
    python3 chip_smoke.py --only 18       # the serving runtime
    python3 chip_smoke.py --only 19       # router, warm cache, handles
    python3 chip_smoke.py --only 20       # the network front door
    python3 chip_smoke.py --only 21       # amplitude-sharded registers
    python3 chip_smoke.py --only 22       # mesh ensembles, the examples

``--only`` takes a comma-separated list of the phase names below (phases 1
and 2 always run; 6 and 7 bring 4 with them) for iterating on one kernel:
it exits non-zero on any failed check like the whole run, prints the JSON
rows of the kernels it timed, and never prints the ``{"ok": ...}`` result
line, which only the whole run gives.

Phases (any unmet check exits non-zero and prints no result line):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: one ``nvcc`` per ``quest_tpu_torch/csrc/*.cu``, all started
   together, with each kernel's registers and spills (the FAST instance,
   the four full-precision instances, layer and Kraus kernel at float32
   and float64, the four row stages ``stage_dense_row<T, J>`` the layer
   kernel calls, and the four instances of the layer kernel's streaming
   entry for ``rowdiag``-only layers must spill nothing), the lane
   stage's ring bytes from both libraries' C entry points against the
   Python sizing, and the streaming entry's shared-memory table cap
   against its Python mirror;
3. the layer kernel against its plain PyTorch version, per stage kind, at
   20 qubits in float32 and float64, then ``rowdiag``-only layers (the
   streaming entry: k = 1-3, bits inside and above the tile, 1-7, 15 and
   40 stages, each also run through the tile kernel's one-pass ``rowdiag``
   run and held equal bit for bit) and a mixed layer of ``rowdiag`` runs,
   with ``diag_launches`` counted; 3b. the batched layer kernel the same
   way on B = 4 distinct states; 3c. the fused Kraus kernel at 20 qubits,
   T = 8, K = 2, 4, 16, 64, with edge uniforms and zero-probability
   branches: the operator each trajectory's output came from equals the
   plain version's draw; 3d. the FAST layer kernel (bf16 tensor cores in
   the dense stages) against its plain version, single and B = 4, on lane,
   clane and rowmxu stages alone and mixed with row and rowdiag stages,
   with FAST against full precision inside the tier's per-gate drift (and
   equal for ``rowdiag``-only layers, float32 at both tiers), and the
   kernel's FAST ring size against its Python mirror;
   3e. the MXU-tile kernel (``apply_mxu_tile``) against its plain version
   on five target sets at float32, float64 and FAST and a 4-qubit gate at
   float32, the operator pool each call gathered on the card against the
   per-layer pack bit for bit, and its times: the
   call, and device-only (the card held busy while the host enqueues) the
   launch alone and the whole call; then each target set with a row bit
   (the row stages ``stage_dense_row<T,1>``/``<T,2>``) at float32 and
   float64, at 20 and 26 qubits, against the port's ``apply_unitary``:
   ms per call, the launch alone device-only, its bound, ``apply_unitary``
   and, for (2, 5, 7) and (7, 8), one complex ``torch.matmul`` of the
   packed operator (held against the kernel); then a 26-qubit circuit with
   dense 8- and 9-qubit gates on qubits 0-7 and 0-8 compiled with the
   crossover model deciding, at float32 and float64: its one layer holds
   ``rowmxu`` stages at J = 1 and 2, one launch per run, the state against
   ``layers=False`` (||dpsi||_2 <= 1e-4 / 1e-10), both runs timed;
4. the single-state path at 30 qubits, complex64: the random-rotation +
   CNOT brickwork compiled and run through the layer kernel, against the
   same gates through the imperative per-gate API;
5. the 3-qubit tutorial flow on the card, against the same flow on the
   CPU in double precision;
6. times with CUDA events: the layer kernel on that path's layers beside
   its bound, its plain version, a lane-only layer beside one
   ``torch.matmul`` of the same product (at float32 on the 30-qubit state,
   and at float64 on 29 qubits, its first 2^24 amplitudes held against
   the plain version), a lane stage with 7 ``rowdiag`` stages beside the
   lane-only layer (the run's cost inside the tile), and the compiled
   path's gates/s;
7. a ``torch.profiler`` breakdown of one compiled run: device time per
   kernel and the device-busy share;
8. the batched ensemble engine: a 24-qubit, 2-layer hardware-efficient
   ansatz (bench.py ``build_hea_circuit``), complex64, batch 64, a 24-term
   Pauli sum, through ``expectation_sweep``; the batched layer kernel
   launches once per layer, the states and energies match a per-point
   loop of ``CompiledCircuit.run`` + ``calcExpecPauliSum`` on 4 points,
   the kernel matches its plain version on every layer over the whole
   batch, points/s, and the kernel's ms per layer beside its bound, its
   plain version and one complex64 ``torch.matmul`` of the same lane
   product;
9. noisy trajectories: bench.py's trajectory-wave circuit at 22 qubits,
   complex64, ``expectation`` over 1024 trajectories in waves of 128; both
   kernels launch once per item per wave, norms stay 1 (<= 1e-4), a
   12-qubit copy agrees card against CPU (<= 1e-4), both kernels match
   their plain versions on a whole wave's batch, trajectories/s, the Kraus
   kernel's ms beside its bound, plain version and one complex64
   ``torch.matmul``, and a ``torch.profiler`` breakdown of one wave;
   9g. trajectory gradients: phase 9's circuit with its two ry columns as
   44 Params, ``expectation_grad`` over 256 trajectories in waves of 128
   (the adjoint walk over each wave): the batched layer kernel launches
   once per layer and wave forward and once adjoint over the 2T stack, the
   Kraus kernel once per channel and wave forward (with its index output)
   and once adjoint (one-hot probabilities); first the walk over the
   first wave's first two trajectories with every launch against its
   plain version on its own input (the index output too); the value
   column equal to ``expectation``'s mean at the same seed and wave size
   bit for bit; those two trajectories' gradients in four Params against
   a float64 central difference of their fixed-branch objective replayed
   on the card (<= 1e-3 of max|g|); a 12-qubit copy card against CPU on
   the same uniforms (<= 1e-4 of max|g|); on a wave of the path the index
   output against ``draw_plain`` and the adjoint Kraus step against its
   plain version, then the index output at the edge draws;
   seconds, trajectories/s beside ``expectation``'s, the cost in value
   waves, peak memory, a ``torch.profiler`` breakdown of one 8-trajectory
   gradient wave (device activity only), and the adjoint layers' ms over
   2T;
10. the FAST tier on the main path: the 30-qubit brickwork compiled with
    ``tier="fast"`` (and by an error budget that selects FAST), its
    ``rowmxu`` stages, one FAST launch per layer, every layer against
    its FAST plain version, the final state against the SINGLE compiled
    state within the modeled tier error, gates/s at both tiers, and per
    layer the FAST kernel's ms beside its bound (HBM or bf16
    tensor-core operations), its plain version, one bf16
    ``torch.matmul`` of the stacked real lane product and one of the
    layer's widest dense stage in stacked real hi/lo form;
11. tiers in the batched engine: phase 8's HEA sweep (at batch 16, the
    cell's 64 cut for time) through
    ``expectation_sweep(tier="fast")`` and ``tier="single"``: launches
    per tier, FAST energies against SINGLE's within the modeled bound,
    SINGLE's compensated energies against a float64 host reduction of the
    same states (<= 1e-6 of max|E|), points/s per tier, and the batched
    FAST kernel against its plain version over the whole batch;
12. density registers at 15 qubits (2^30 flat amplitudes, 8 GiB of
    complex64 planes), run with ``compile(density=True)``:
    12a. the noisy QFT (the QFT ladder of ``algorithms._append_qft``, then
    dephasing 0.01 and damping 0.005 on every qubit) from a basis state:
    the layer kernel
    launches once per layer of the lifted plan (> 0), through the
    streaming entry for each ``rowdiag``-only layer, each layer's kernel
    output on its own input within 1e-5 of max|plain| of its plain
    version, the result within 1e-4 of max|amp| of the same program
    through the imperative density API, trace within 1e-4 of 1, purity in
    (0, 1], ops/s (counted as bench.py:3514 counts them), each layer's ms
    beside its bound, its plain version and one complex64 broadcast
    multiply by the layer's merged diagonal (the library yardstick, held
    against the plain version first), and a ``torch.profiler``
    breakdown; 12b. ``BASELINE.json`` config 4 (bench.py:3514
    ``bench_density_noise``) from |+><+| the same way, with no kernel
    count asserted
    (its plan has no layer); 12c. every density function of the API on 8
    qubits (a complex pure state) on the card against the CPU in float64
    (within 1e-5 of the largest value, and of the largest amplitude);
    12e. the noisy QFT of 12a compiled at ``tier="fast"``: one FAST
    launch per layer, each FAST layer's kernel output on its own input
    within 1e-5 of max|plain| of its FAST plain version, the result
    against the SINGLE program within ``modeled_tier_error(FAST, ops)``
    of max|amp|, FAST ops/s beside SINGLE's;
    12d. density sweeps and gradients: config 4's circuit with its
    rotations as Params through ``expectation_sweep`` at 15 qubits, batch
    2, against a per-point ``run`` + ``calcExpecPauliSum`` (<= 1e-4 of
    max|E|); ``value_and_grad_sweep`` at 14 qubits (2^28 flat amplitudes),
    batch 2, on an ry/rz column, a CNOT ring and a Param dephasing rate:
    values against ``expectation_sweep`` (<= 1e-6), rotation columns
    against parameter shift and the rate column against a central
    difference (<= 1e-3 of max|g|), peak memory, points/s;
13. gradients: phase 8's HEA through ``value_and_grad_sweep`` at batch
    4 (the cell's 64, cut for time): the batched layer kernel launches
    once per forward layer and once per adjoint layer, values against
    ``expectation_sweep`` (<= 1e-6 of max|E|), 2 rows x 6 parameters
    (lane qubits, tile rows, above the tile) against parameter shift (<=
    1e-3 of max|g|), every forward and adjoint layer's kernel output on
    its own input against its plain version (<= 1e-5), points/s beside
    ``expectation_sweep``'s, peak memory, ``tier="fast"`` gradients
    within 4 e sum|c_t| of SINGLE's (e the tier model's error), and the
    adjoint layers' ms over the 2B stack beside bound, plain version and
    one ``torch.matmul``;
14. the main-path remainder at 30 qubits, complex64, through the public
    surface with ``createQuESTEnv(num_devices=1)``: the brickwork compiled
    and ``precompile()``-d (every layer packed before any run; the first
    run launches the layer kernel 4 times and builds and packs nothing;
    first and second run timed); ``sampleOutcomes`` of 10^6 shots on
    qubits 0-3 (every bin within 5 stderr of the planes' float64
    marginals, the planes bit-equal after, and the mass a float32 running
    sum would misplace); the brickwork's gates inside ``fusedGates(q, 3)``
    against the compiled state (||dpsi||_2 <= 1e-4), its gates in and
    kernels out, beside the same gates eagerly; ``setWeightedQureg`` into
    a third register against torch ops (<= 1e-6 of max|amp|);
    ``circ.inverse()`` back to |0..0> (<= 1e-4), each of its layers
    against its plain version on its own input (<= 1e-5); the brickwork
    extended by its inverse as one program (178 gates in, its
    ``dispatch_stats``, a ``program_digest`` stable across compiles) back
    to |0..0>. At most three 8 GiB registers at once;
15. Hamiltonian dynamics at 24 qubits, complex64, batch 4, the open TFIM
    at h = 0.7 (47 terms) after tests/test_dynamics.py's prep program (an
    ry column of Params, a CNOT chain), every batched layer launch held
    against its plain version on its own input: ``evolve_sweep`` with
    ``EvolveSpec(t=0.8, steps=8, order=2)`` (one launch per prep layer;
    ``dispatch_stats`` ``evolve_steps_fused`` 32; every row within
    ||dpsi||_2 <= 5e-4 of the gate-form twin, the prep and
    ``algorithms.trotter_evolution`` through ``sweep``; norms within 1e-4;
    the last energy within 1e-5 sum|c| of a float64 reduction of the
    returned planes; the Welford carry against the host moments), again
    at ``tier="single"`` (the last energy within 1e-6 of |E|);
    ``ground_sweep`` by power iteration, two 16-step segments chained
    through ``state_f`` (no energy rises by more than 1e-5 sum|c|), and by
    Lanczos (16 vectors: the energy within 1e-4 sum|c| of <x|H|x> of the
    returned planes and below the start's, ||Hx - Ex||_2 beside the
    reported residual); a 12-qubit copy on the card against the CPU in
    float64 (1e-4 of max|amp|, Lanczos up to sign, and of sum|c|); the
    seconds of each call, term rotations/s, one rotation's ms beside its
    HBM bound, peak memory;
16. the algorithm library and the QASM importer at 30 qubits, complex64,
    every layer launch held against its plain version on its own input:
    ``qft(30)`` from a basis state against the analytic amplitudes
    (||dpsi||_2 <= 5e-4) and ``inverse_qft(30)`` back to it (<= 1e-4);
    ``bernstein_vazirani(30)`` (P(secret) >= 1 - 1e-5); phase 4's
    brickwork through ``to_qasm`` and ``parse_qasm`` against its own run
    (|<psi|phi>| >= 1 - 1e-5); ``grover(20)`` at its own 804 iterations
    against sin^2((2k+1) theta) (1e-3) and the analytic state; seconds
    per run and gates/s;
17. the QUAD tier (double-double planes, ``ops/doubledouble.py``: plain
    torch ops, no kernel; every kernel count stays 0 on each dd path):
    17a. phase 4's brickwork at one layer and 20 qubits gate by gate
    through the API on a QUAD, a QUAD64 and a DOUBLE register, then
    ``calcTotalProb``, ``calcProbOfOutcome``, ``calcExpecPauliSum`` (phase
    8's 24-term shape), ``collapseToOutcome``, ``calcInnerProduct`` and
    ``sampleOutcomes`` (10^5 shots, the marginal of qubits 0-2 within 5
    stderr): QUAD and QUAD64 against DOUBLE, and QUAD64 against QUAD,
    within 1e-12 of max|amp| and of max|E|; 17b. phase 4's brickwork
    through ``compile_dd`` at 28 qubits (QUAD) and 27 (QUAD64), 4 GiB of
    planes each: seconds, gates/s, one dense dd gate's ms beside its HBM
    bound (its four planes read and written once), peak memory,
    ``total_prob`` within 1e-12 of 1; at 12 qubits the card's dd planes
    against the CPU's from one input, equal bit for bit; 17c. phase 8's
    HEA at batch 4 through ``expectation_sweep(tier="quad")`` on a DOUBLE
    env: points/s, peak memory, against ``tier="double"`` (1e-10 of
    max|E|), the DOUBLE, SINGLE and FAST energies' deviation from QUAD's;
    ``sweep(tier="quad")`` at 12 qubits card against CPU (1e-13 of
    max|amp|); 17d. ``BASELINE.json`` config 4 and ``mixDensityMatrix``
    on a 12-qubit QUAD density register against a DOUBLE one (1e-12),
    trace within 1e-12 of 1, purity in (0, 1]. The phase stays under 120
    s and 60 GB;
18. the serving runtime (``createSimulationService``: coalesce -> WFQ ->
    one batched dispatch), layers on, ``max_batch`` 64, ``max_wait_s``
    5e-3, complex64: 18a. the JAX package's own serving trace
    (``bench.py:2236``: the 16-qubit 2-layer HEA, the 24-term Pauli sum of
    seed 2026, 1024 requests, every 4th 64 shots, the rest the energy),
    first the sequential client over the trace's first 256 requests
    (``initZeroState``, ``run``, ``calcExpecPauliSum`` /
    ``sampleOutcomes`` per request; cut from 1024 for time), then the
    whole trace through one warmed service, submitted while paused:
    requests/s of both, the speedup, batch occupancy, coalesce ratio,
    padded fraction, p50/p99 latency, retries, rejects and timeouts; the
    energies against the sequential client (1e-5 of max|E|) and against
    direct ``expectation_sweep`` calls over the same 64-row batches
    (1e-6), each shot request of the right shape with its total norm
    within 1e-5 of 1; 18b. the same service at phase 8's HEA cell (24
    qubits): 64 energy and 16 shot requests from 8 client threads, the
    dispatch profiler at rate 1 (achieved bytes/s and ``roofline_frac``
    against 3.35e12 B/s, at most 1.05), the energies against one direct
    ``expectation_sweep`` (1e-6), then one more batch with every batched
    layer launch held against ``apply_layer_batched_plain`` (1e-5 of
    max|plain|); 18c. 4 trajectory requests of 128 trajectories on phase
    9's circuit against a direct ``expectation_batch`` from the same
    generator state (1e-5 of max|E|); 18d. one gradient batch (8
    requests, 16 qubits) against a direct ``value_and_grad_sweep`` (1e-5
    of max|g|); 18e. fault drills at 12 qubits on further services: one
    injected transient fault (retried; results equal a clean run's), one
    NaN-poisoned row (that request fails with ``NumericalFault``, its
    batchmates complete), a circuit-breaker trip (a typed fast-fail),
    and a refused batched-layer launch (the request fails with the
    launch error, classified fatal: no retry, no plain version). In
    18a-18d no request is retried, rejected, timed out or fast-failed and
    no program degrades; the batched layer kernel launches on 18a, 18b
    and 18d and the Kraus kernel on 18c, each counted around its path.
    The phase stays under 120 s;
19. the rest of serving, complex64, under the port's lock-order check
    (``quest_tpu_torch/testing/lockcheck.py``, no violation): 19a. the
    JAX package's replicated-serving cell (``bench.py:2812`` at its
    defaults: the 16-qubit 2-layer HEA, the 24-term Pauli sum of seed
    2028, 512 requests, ``max_batch`` 32, two replicas sharing the card,
    buckets 1-32 warmed through a ``WarmCache``) played twice through a
    ``ServiceRouter``, clean and with replica 0's dispatcher crashed at
    request 256: requests/s, p99, failovers, quarantines, restarts and
    readmissions; no request dropped or failed, every energy within 1e-5
    of max|E| of one direct ``expectation_sweep``; one more routed batch
    with its batched layer launches held against
    ``apply_layer_batched_plain`` (1e-5 of max|plain|); then
    restart-to-ready of one service against an empty cache directory and
    the populated one (misses and packs, then hits and no pack); 19b.
    ``service.optimize`` (Adam, 10 iterates) on serving-grad-16q's HEA:
    each iterate's value and gradient against a direct
    ``value_and_grad_sweep`` at its point (1e-5 of max|g|); the same run
    checkpointed, killed by a transient fault at iterate 5 and resumed,
    equal to the clean run bit for bit; the HEA with a ``damp`` column at
    ``trajectories=128`` for 2 iterates, every fused Kraus launch held
    against ``fused_kraus_apply_batched_plain``; 19c.
    dynamics-tfim-24q-b4's program at batch 1: ``service.evolve(t=0.8,
    steps=8, segment_steps=4)`` in two segments against one direct
    ``evolve_sweep`` (1e-6 of max|E|), and ``service.ground_state`` (4
    segments) checkpointed, killed after segment 2 and resumed, equal to
    the uninterrupted run bit for bit; 19d. a 24-qubit register and a
    12-qubit QUAD register through ``checkpoint.save``/``load`` bit for
    bit, ``checkpointed_run`` of phase 8's HEA in 4 segments equal to the
    same segments run plainly bit for bit (and to the whole circuit's run
    within 1e-5 of max|amp|), ``checkpointed_sweep`` of 32 rows in
    segments of 16 within 1e-6 of max|E| of one ``expectation_sweep``.
    The batched layer kernel launches on 19a-19d and the Kraus kernel on
    19b's noisy objective, each counted around its sub-phase. The phase
    stays under 120 s;
20. the network front door (``quest_tpu_torch.netserve``: ``NetServer``
    and ``NetClient`` over loopback, the ``quest_tpu.wire/1`` form),
    complex64, under the port's lock-order check (the locks of the timed
    passes of 20a and 20b created outside it, as ``bench.py:3210`` does):
    20a. the JAX package's
    wire cell (``bench.py:3219``: the 1-layer HEA at 16 qubits, an 8-term
    Pauli sum of seed 2026, 256 requests, every 4th the full planes, the
    rest the energy, ``max_batch`` 32, 32 client workers, the program
    registered outside the timed window) in-process and through the
    socket: requests/s, p50/p99, the server's parse + serialize spans as
    a share of request handling, bytes on the wire; whether a row's f32
    result depends on its batchmates (one row alone and in two batches of
    32); every wire result equal, bit for bit after the float64 cast, to
    the value its backend future resolved with (a recording backend); the
    wire against in-process bit for bit where rows are batch-independent,
    else within 1e-6 of max|E| of direct sweeps of the same rows; 20b.
    the wire-chaos cell (``bench.py:3374``, seed 2028, 64 requests: its
    own count when its time is short, cut from 256) fault-free and under
    2% seeded wire faults over ``faults.WIRE_KINDS`` plus a reset at call
    2 (``retries=6``): requests/s of both, retries, resends, dedup replays
    and joins; every completed request equal to its fault-free value (the
    bar of 20a), every other failed typed, zero double dispatches; 20c.
    phase 19b's optimizer problem as a resumable stream (4 Adam iterates)
    cut after 3 events and reattached through ``/v1/resume``, equal event
    for event to an in-process handle bit for bit; one trajectory request
    (128 trajectories, 16 qubits) equal to its future's value, every
    Kraus launch held against its plain version; one wire batch of 8
    with every batched layer launch held against its plain version; one
    ``evolve`` stream of 19c's problem at 16 qubits (its terminal event
    carries the final planes as JSON) equal to the in-process handle bit
    for bit; 20d. drain to a state file and restart on the same port: the
    same client's ``circuit_ref`` submissions hit the restored registry
    with its session readmitted (no resend, no reopen, nothing dropped);
    a refused batched-layer launch under a wire request reaches the
    client as the non-retryable 500 (``WireError``, no retry, no plain
    version). The batched layer kernel launches on 20a-20d and the Kraus
    kernel on 20c, each counted around its sub-phase. The phase stays
    under 60 s;
21. amplitude-sharded registers (``parallel/``) on a mesh of four shards
    on the one card (``createQuESTEnv(devices=["cuda:0"] * 4)``, s = 2),
    complex64: 21a. phase 4's brickwork at 30 qubits compiled on the mesh
    from |+...+>: the planned relayouts and cross-shard items, every
    layer-kernel launch on each shard's 28-qubit chunk held against its
    plain version on its own chunk, the exchanges run (counted, and each
    one's kind, bits, bytes and ms from CUDA events), the run's seconds
    beside the single-device run's, each relayout's peak memory (at most
    one chunk and one block beside the register) and the run's, the
    planes against the single-device run (1e-5 of max|amp|), the same
    program with ``overlap=True`` (bit for bit, else 1e-6, and which), and
    at ``tier="fast"`` (every FAST launch held against its FAST plain
    version, the planes within the tier's modeled error); 21b.
    ``tests/test_distributed.py``'s gates on a 28-qubit mesh register
    against one device (1e-5): a SWAP across the boundary left as layout
    metadata, ``getAmp`` under the permuted layout, ``calcTotalProb``,
    ``calcProbOfOutcome``, ``collapseToOutcome`` and ``measure`` on the
    same uniforms, the canonicalising exchange's scratch within one chunk,
    ``sample_sharded``'s total; 21c. phase 8's HEA ``expectation_sweep`` at
    batch 64 on the mesh in the mode ``choose_batch_sharding`` chooses
    (``amp``), then ``batch`` forced on 8 rows and a 6-row pad-and-mask
    (cut from 64 and 62 for time), each against the single-device sweep
    (phase 8's when it ran; 1e-5 of max|E|) with every batched layer
    launch held against its plain version on its own input;
    21d. phase 12's 15-qubit noisy QFT as a density program on the mesh
    against one device (1e-5), every launch (the streaming entry's) held
    against its plain version on its own chunk, and ``sample_sharded``'s
    total on its diagonal; 21e. the comm model measured on the mesh;
22. the ensembles on the same four shards, complex64: 22a. phase 9's
    22-qubit trajectory program: ``batch`` mode (``shard_trajectories=
    True``) on 256 trajectories, its planes equal to one device's on the
    same uniforms bit for bit (when not, it prints whether one device's
    run repeats itself and the first item after which a shard's rows part
    from the same rows of one device's run, walked item by item); ``amp``
    mode (the policy's memory limit at 1 byte) on one wave of 128 spanning
    the chunks, every draw (read from a wave of the walk on the same
    uniforms, whose planes equal the sweep's) equal to one device's and
    the planes within 1e-6 of max|amp|; every batched layer and Kraus
    launch of both held against its plain version on its own input; trajectories/s in each mode beside phase 9's; phase 9g's
    program's ``expectation_grad`` over one wave of 16 in each mode
    against one device's (1e-5 of max|g|), its launches held too; 22b.
    phase 15's TFIM ``evolve_sweep`` and power and Lanczos
    ``ground_sweep`` in ``amp`` mode against phase 15's energies (1e-5 of
    max|E|), the prep's launches held; 22c. 12d's config 4 energies and
    its 14-qubit gradients in ``amp`` mode against 12d's (1e-5), every
    launch held; 22d. each of the 11 ``quest_tpu_torch/examples`` scripts'
    ``main(device="cuda")`` (the Adam loops at the CPU test's step counts)
    with its own asserts, every launch of the layer kernel, the batched
    layer kernel and the Kraus kernel held against its plain version on
    its own input, its deterministic numbers against the same script on
    the CPU at DOUBLE (1e-5), the Adam loops' final energies re-evaluated
    on the CPU at the card's parameters (1e-5), the facts a draw decides,
    its wall time. Alone (``--only 22``) the phase computes the one-device
    yardsticks itself.

Every comparison of a kernel with its plain version holds max |kernel -
plain| / max |plain| to 1e-5 in float32 and 1e-12 in float64: relative to
the largest amplitude, so the bar shrinks with the state's amplitudes and a
wrong stage, row, state or draw moves the error to order 1.

A bound is the larger of a call's bytes over 3.35 TB/s and its operations
over the card's peak for their type (PEAK_FLOPS): float32 on the CUDA
cores, float64 on the FP64 tensor cores, both 67 TFLOP/s, bf16 on its
tensor cores. The exact float64 stages run on the CUDA cores, at 34
TFLOP/s; the float64 rows print that figure beside the bound.

Every kernel count is set to 0 just before a path runs and read just after
it. The line before the last is a JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``. Nothing here imports JAX or
the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

MAIN_QUBITS = 30
MAIN_LAYERS = 2
CHECK_QUBITS = 20
PLAIN_QUBITS = 26
ROW_STAGE_QUBITS = 26                  # phase 3e: the row stages past L2
SWEEP_QUBITS, SWEEP_LAYERS, SWEEP_BATCH, SWEEP_TERMS = 24, 2, 64, 24
TRAJ_QUBITS, TRAJ_WAVE, TRAJ_MAX = 22, 128, 1024
TRAJ_GRAD_MAX, TRAJ_GRAD_SEED = 256, 29     # phase 9g: two waves
TRAJ_GRAD_PROFILE = 8                        # its profiled wave, cut
# phase 9g's central-difference columns: lane and row qubits, both columns
TRAJ_GRAD_COLUMNS = ("a1", "a15", "b3", "b20")
HBM_BYTES_PER_S = 3.35e12              # H100 SXM data sheet
# the card's peak rate for each plane dtype (by itemsize), which a bound
# takes: float32 on the CUDA cores, float64 on the FP64 tensor cores; the
# exact stages run float64 on the CUDA cores, at half that rate
PEAK_FLOPS = {4: 67.0e12, 8: 67.0e12}
CUDA_CORE_FLOPS = {4: 67.0e12, 8: 34.0e12}
BF16_TENSOR_FLOPS = 989.0e12           # dense bf16 tensor cores
MXU_TILE_TARGETS = ((3,), (8,), (3, 8), (7, 8), (2, 5, 7))
FAST_BUDGET = 0.1                      # an error budget only FAST needs
GRAD_BATCH = 4                         # phase 13: the HEA cell's 64, cut
FAST_SWEEP_BATCH = 16                  # phase 11: the HEA cell's 64, cut
# phase 13's parameter-shift columns: two parameters each on lane qubits,
# on tile rows (qubits 7-13) and above the tile (qubits >= 14)
GRAD_COLUMNS = ("y0_1", "z1_5", "y0_9", "z1_12", "y0_17", "z1_22")
DENSITY_GRAD_QUBITS, DENSITY_GRAD_BATCH = 14, 2   # phase 12d's gradients
# phase 12d's shift columns: lane qubits, tile rows, and the top qubit
DENSITY_GRAD_COLUMNS = ("y0_0", "z0_5", "y0_10", "z0_13")


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


def diag_cases(rng, n: int, hi: int):
    """Layers for the rowdiag paths: rowdiag stages only (the streaming
    entry) on k = 1-3 row bits inside and above the tile, 1-7 stages as
    the density QFT has them, 15 (float32 tables past the shared-memory
    cap) and 40 (more than one warp of stages); then rowdiag runs inside
    mixed layers (the tile kernel's one pass per run)."""
    top, far = hi - 7, n - 8            # highest tile row bit; one above
    phase = lambda k: np.exp(1j * rng.uniform(0, 2 * np.pi, (1 << k, 128)))
    pick = lambda k: tuple(sorted(rng.choice(n - 7, size=k, replace=False)
                                  .tolist()))
    diag = lambda k, bits: ("rowdiag", phase(k), bits)
    cases = {
        "diag1_in": [diag(1, (top,))],
        "diag1_far": [diag(1, (far,))],
        "diag3": [diag(1, (0,)), diag(2, (2, far)), diag(3, (1, top, far))],
        "diag7": [diag(3, (0, top, far))] + [diag(k, pick(k)) for k in
                                             (1, 2, 3, 2, 3, 3)],
        "diag15": [diag(3, pick(3)) for _ in range(15)],
        "diag40": [diag(1 + i % 3, pick(1 + i % 3)) for i in range(40)],
    }
    cases["runs"] = [("lane", random_unitary(rng, 128))] \
        + cases["diag3"] + [("row", 8, random_unitary(rng, 2), 0b10, 0b10,
                             0, 0)] \
        + [diag(2, (1, far))] + [("rowk", (0, top), random_unitary(rng, 4),
                                  0, 0, 0, 0)] + cases["diag7"]
    return cases


def identity_row(hi: int):
    """A row stage that changes no bit (identity 2x2): a diagonal layer
    with it appended runs through the tile kernel's rowdiag runs."""
    return ("row", hi, np.eye(2), 0, 0, 0, 0)


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


def layer_bound_ms(lk, layer, n: int, dtype, batch: int = 1,
                   fast: bool = False):
    """Least time for one layer on the card over ``batch`` states: the
    larger of its HBM bytes (both planes of every state read and written
    once, plus its operands once) over 3.35 TB/s and its flops over the
    card's peak for the dtype (PEAK_FLOPS). With ``fast`` (the FAST tier)
    the dense stages do the bf16-split form's twice the products at the
    bf16 tensor-core rate and their operators are bf16. Returns (ms,
    bound_by, bytes_ms, flops_ms)."""
    itemsize = dtype.itemsize
    kstages, mats, tables, xmats, _, _ = lk.layer_kernel_plan(
        layer, n, lk.tile_rows_for(dtype))
    dense_item = 2 if fast else itemsize
    operands = 2 * dense_item * (sum(m.size for m in mats)
                                 + sum(x.size for x in xmats)) \
        + 2 * itemsize * sum(t.size for t in tables)
    bytes_ms = 1e3 * (4.0 * itemsize * batch * (1 << n) + operands) \
        / HBM_BYTES_PER_S
    dense = sum(stage_flops(st, n) for st in kstages
                if st[0] in ("lane", "rowmxu"))
    other = sum(stage_flops(st, n) for st in kstages
                if st[0] not in ("lane", "rowmxu"))
    if fast:
        flops_s = 2.0 * dense / BF16_TENSOR_FLOPS \
            + other / PEAK_FLOPS[itemsize]
    else:
        flops_s = (dense + other) / PEAK_FLOPS[itemsize]
    flops_ms = 1e3 * batch * flops_s
    return max(bytes_ms, flops_ms), \
        ("bytes" if bytes_ms >= flops_ms else "operations"), \
        bytes_ms, flops_ms


def raw_bits(torch, t):
    """A tensor's raw bits, so -0.0 and 0.0 differ."""
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def rel_err(got, want):
    """(max |got - want|, that over max |want|). A ``want`` of zeros (a
    chunk no amplitude has reached yet) must be matched exactly: its
    relative error is 0 or inf."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if scale == 0.0:
        return err, 0.0 if err == 0.0 else float("inf")
    return err, err / scale


def device_ms(torch, fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls, by CUDA events,
    with the card held busy (``torch.cuda._sleep``) while the host enqueues
    them, so the events time the launches back to back and none of the
    host's work between them."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)     # ~25 ms of spin at ~2 GHz
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


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


# the kernel instances that must spill nothing, by a piece of their
# mangled names
NO_SPILL_INSTANCES = {
    "layer_kernelIfLb1E": "layer_kernel<float, FAST>",
    "layer_kernelIfLb0E": "layer_kernel<float>",
    "layer_kernelIdLb0E": "layer_kernel<double>",
    "layer_diag_kernelIfLb1E": "layer_diag_kernel<float, smem tables>",
    "layer_diag_kernelIfLb0E": "layer_diag_kernel<float, __ldg tables>",
    "layer_diag_kernelIdLb1E": "layer_diag_kernel<double, smem tables>",
    "layer_diag_kernelIdLb0E": "layer_diag_kernel<double, __ldg tables>",
    "kraus_kernelIfE": "kraus_kernel<float>",
    "kraus_kernelIdE": "kraus_kernel<double>",
    # the row stages, functions of their own that the single and batched
    # launches of layer_kernel<T> call (their registers are the kernel's)
    "stage_dense_rowIfLi1E": "stage_dense_row<float, 1>",
    "stage_dense_rowIfLi2E": "stage_dense_row<float, 2>",
    "stage_dense_rowIdLi1E": "stage_dense_row<double, 1>",
    "stage_dense_rowIdLi2E": "stage_dense_row<double, 2>",
}
# the kernel whose registers a device function's line reports
HOST_KERNEL = {"stage_dense_row<float, 1>": "layer_kernel<float>",
               "stage_dense_row<float, 2>": "layer_kernel<float>",
               "stage_dense_row<double, 1>": "layer_kernel<double>",
               "stage_dense_row<double, 2>": "layer_kernel<double>"}


def instance_of(mangled: str):
    return next((name for key, name in NO_SPILL_INSTANCES.items()
                 if key in mangled), None)


def phase_build(torch):
    from quest_tpu_torch.ops import cuda_build
    from quest_tpu_torch.ops import kraus_kernel as kk
    from quest_tpu_torch.ops import layer_kernel as lk
    print("phase 2: build (one nvcc per source, all started together)")
    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    print(f"  built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
    spills = {name: [] for name in NO_SPILL_INSTANCES.values()}
    registers = {}
    for stem, (_, path, log) in sorted(libs.items()):
        print(f"  {stem}: {path}")
        function = entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            if "Function properties for" in line:
                function = line.rsplit(" ", 1)[-1]
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas: {line.strip()}")
            if "spill" in line and instance_of(function):
                spills[instance_of(function)].append(line.strip())
            if "Used" in line and "registers" in line and instance_of(entry):
                registers[instance_of(entry)] = int(
                    line.split("Used", 1)[1].split()[0])
    if all(log for _, _, log in libs.values()):
        for name, found in spills.items():
            host = HOST_KERNEL.get(name, name)
            check(found and all("0 bytes spill stores, 0 bytes spill "
                                "loads" in line for line in found),
                  f"{name} spills nothing ({registers.get(host)} "
                  f"registers" + (f", {host}'s" if host != name else "")
                  + f"): {found}")
    else:
        print("  spills not read: the libraries were already built")
    # the lane stage's ring: the kernels' sizing against the Python mirror
    layer_lib, kraus_lib = lk.build_library()[0], kk.build_library()[0]
    for dtype in (torch.float32, torch.float64):
        itemsize, rows = dtype.itemsize, lk.TILE_ROWS[dtype]
        tile = 2 * rows * lk.LANES * itemsize
        got = (layer_lib.quest_layer_lane_scratch_bytes(itemsize),
               kraus_lib.quest_kraus_lane_scratch_bytes(itemsize))
        want = (lk.shared_memory_bytes(rows, itemsize) - tile,
                kk.shared_memory_for(MAIN_QUBITS, dtype) - tile)
        check(got == want and want[0] == lk.lane_scratch_bytes(itemsize),
              f"lane ring bytes at {dtype}, layer and Kraus kernels "
              f"{got} vs Python {want}")
    cap = layer_lib.quest_layer_diag_table_cap()
    check(cap == lk.DIAG_TABLE_CAP, f"streaming entry's shared-memory table "
          f"cap {cap} B vs Python {lk.DIAG_TABLE_CAP} B")


def phase_stages(torch, lk, rng):
    print(f"phase 3: kernel vs plain version per stage kind, "
          f"{CHECK_QUBITS} qubits")
    n = CHECK_QUBITS
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        hi = lk.max_mid_qubit(lk.tile_rows_for(dtype))
        cases = dict(stage_cases(rng, n, hi), **diag_cases(rng, n, hi))
        for name, stages in cases.items():
            layer = lk.LayerOp(n, len(stages), stages)
            base = random_planes(torch, rng, n, dtype, "cuda")
            want = lk.apply_layer_plain(base.clone(), n, layer)
            before = (lk.apply_layer.launches, lk.apply_layer.diag_launches)
            got = lk.apply_layer(base.clone(), n, layer)
            torch.cuda.synchronize()
            err, rel = rel_err(got, want)
            diag = int(lk.is_diagonal_layer(layer))
            check(lk.apply_layer.launches == before[0] + 1
                  and lk.apply_layer.diag_launches == before[1] + diag
                  and rel <= tol and bool(torch.isfinite(got).all()),
                  f"{name:14s} {str(dtype):14s} "
                  f"{'diag entry' if diag else 'tile      '} max|diff| "
                  f"{err:.3e}, / max|plain| {rel:.3e} <= {tol:g}")
            if diag:
                # the same stages as one run of the tile kernel (an
                # identity row stage keeps the layer off the streaming
                # entry): the same products in the same order, same bits
                tiled = lk.LayerOp(n, len(stages) + 1,
                                   stages + [identity_row(hi)])
                again = lk.apply_layer(base.clone(), n, tiled)
                torch.cuda.synchronize()
                check(torch.equal(again, got),
                      f"{name:14s} {str(dtype):14s} tile-kernel run equals "
                      f"the streaming entry bit for bit")


def random_batch(torch, rng, batch: int, n: int, dtype, device):
    """``batch`` distinct normalised states, ``(batch, 2, 2^n)``."""
    z = rng.normal(size=(batch, 2, 1 << n))
    z /= np.linalg.norm(z.reshape(batch, -1), axis=1)[:, None, None]
    return torch.as_tensor(z, dtype=dtype, device=device)


def phase_batched_stages(torch, lk, rng):
    n, batch = CHECK_QUBITS, 4
    print(f"phase 3b: batched layer kernel vs plain version per stage "
          f"kind, {n} qubits, B = {batch}")
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        hi = lk.max_mid_qubit(lk.tile_rows_for(dtype))
        cases = dict(stage_cases(rng, n, hi), **diag_cases(rng, n, hi))
        for name, stages in cases.items():
            layer = lk.LayerOp(n, len(stages), stages)
            base = random_batch(torch, rng, batch, n, dtype, "cuda")
            want = lk.apply_layer_batched_plain(base.clone(), n, layer)
            fn = lk.apply_layer_batched
            before = (fn.launches, fn.diag_launches)
            got = fn(base.clone(), n, layer)
            torch.cuda.synchronize()
            err, rel = rel_err(got, want)
            diag = int(lk.is_diagonal_layer(layer))
            # every state moved: a batch stride or per-state row base gone
            # wrong leaves some states as they were or mixes them
            moved = float((got - base).abs().amax(dim=(1, 2)).min())
            check(fn.launches == before[0] + 1
                  and fn.diag_launches == before[1] + diag
                  and rel <= tol and moved > 1e-3
                  and bool(torch.isfinite(got).all()),
                  f"{name:14s} {str(dtype):14s} "
                  f"{'diag entry' if diag else 'tile      '} max|diff| "
                  f"{err:.3e}, / max|plain| {rel:.3e} <= {tol:g}")


def fast_cases(rng, n: int, hi: int):
    """The FAST tier's dense stages (lane, clane on a row bit beyond the
    tile, rowmxu on one and two row bits) alone, then all of them mixed
    with row and rowdiag stages."""
    cases = stage_cases(rng, n, hi)
    dense = ("lane", "clane", "rowmxu1", "rowmxu2")
    out = {name: cases[name] for name in dense}
    out["mixed"] = [st for name in ("lane", "row_lane_ctrl", "rowmxu1",
                                    "rowdiag2", "rowmxu2", "clane",
                                    "row_row_ctrl", "rowdiag1")
                    for st in cases[name]]
    # FAST's rowdiag stages are float32: the streaming entry, and runs
    # between FAST dense stages
    diag = diag_cases(rng, n, hi)
    out["diag3"], out["diag7"] = diag["diag3"], diag["diag7"]
    out["mixed_runs"] = [st for name in ("rowmxu1", "rowdiag1", "rowdiag2",
                                         "lane", "rowdiag3")
                         for st in cases[name]] + diag["diag7"]
    return out


def phase_fast_stages(torch, qt, lk, rng):
    n, batch = CHECK_QUBITS, 4
    drift = qt.FAST_TIER.drift_per_gate
    print(f"phase 3d: FAST layer kernel vs its plain version, {n} qubits, "
          f"single and B = {batch}")
    lib = lk.build_library()[0]
    ring = [(lib.quest_layer_fast_scratch_bytes(j), lk.fast_scratch_bytes(j))
            for j in range(lk.MAX_DENSE_ROW_BITS + 1)]
    check(all(a == b for a, b in ring),
          f"FAST ring bytes per max_j, kernel vs Python mirror: {ring}")
    hi = lk.max_mid_qubit(lk.tile_rows_for(torch.float32))
    for name, stages in fast_cases(rng, n, hi).items():
        layer = lk.LayerOp(n, len(stages), stages)
        for batched in (False, True):
            base = random_batch(torch, rng, batch if batched else 1, n,
                                torch.float32, "cuda")
            if batched:
                fn, plain = lk.apply_layer_batched, \
                    lk.apply_layer_batched_plain
            else:
                base = base[0]
                fn, plain = lk.apply_layer, lk.apply_layer_plain
            want = plain(base.clone(), n, layer, fast=True)
            before = (fn.fast_launches, fn.diag_launches)
            got = fn(base.clone(), n, layer, fast=True)
            highest = fn(base.clone(), n, layer)
            torch.cuda.synchronize()
            _, rel = rel_err(got, want)
            # FAST against full precision: the bf16 rounding of the operator
            # alone moves each amplitude by ~2e-3 of its size, so it is held
            # in the tier model's own unit (max amplitude error of a
            # normalised state per gate pass) and printed relative too. A
            # layer of rowdiag stages only is float32 at both tiers: equal
            dev, dev_rel = rel_err(got, highest)
            diag = int(lk.is_diagonal_layer(layer))
            drift_ok = dev == 0.0 if diag \
                else 0.0 < dev <= drift * len(stages)
            # every state of the batch moved (a stride gone wrong would
            # leave some as they were)
            moved = float((got - base).abs().reshape(
                batch, -1).amax(dim=1).min()) if batched else 1.0
            check(fn.fast_launches == before[0] + 1
                  and fn.diag_launches == before[1] + 2 * diag
                  and rel <= 1e-5 and drift_ok and moved > 1e-3
                  and bool(torch.isfinite(got).all()),
                  f"{name:10s} {'B=4' if batched else 'B=1'} "
                  f"{'diag entry' if diag else 'tile      '} max|diff| / "
                  f"max|plain| {rel:.3e} <= 1e-5; FAST vs HIGHEST "
                  f"max|diff| {dev:.3e} ("
                  + ("= 0: float32 at both tiers" if diag else
                     f"0 < it <= {drift:g} x {len(stages)} stages")
                  + f"), / max|amp| {dev_rel:.3e}")


def phase_mxu_tile(torch, qt, lk, kk, rng, card):
    """The standalone MXU-tile kernel: its path is the five target sets at
    HIGHEST float32 and float64 and at FAST, and a gate on 4 qubits at
    float32, counted from 0; then each gathered pool is held against the
    per-layer pack, each output against the plain version, and one target
    set timed."""
    n = CHECK_QUBITS
    print(f"phase 3e: apply_mxu_tile vs its plain version, {n} qubits, "
          f"targets {list(MXU_TILE_TARGETS)}")
    modes = ((torch.float32, False, 1e-5), (torch.float64, False, 1e-12),
             (torch.float32, True, 1e-5))
    runs = []
    reset_counts(lk, kk)
    for dtype, fast, tol in modes:
        for targets in MXU_TILE_TARGETS:
            u = random_unitary(rng, 1 << len(targets))
            base = random_planes(torch, rng, n, dtype, "cuda")
            got = lk.apply_mxu_tile(base.clone(), n, u, targets, fast=fast)
            runs.append((dtype, fast, tol, targets, u, base, got))
    wide = (0, 2, 5, 8)          # 513 gate values
    u = random_unitary(rng, 1 << len(wide))
    base = random_planes(torch, rng, n, torch.float32, "cuda")
    runs.append((torch.float32, False, 1e-5, wide, u, base,
                 lk.apply_mxu_tile(base.clone(), n, u, wide)))
    torch.cuda.synchronize()
    launches = lk.apply_mxu_tile.launches
    check(launches == len(runs) and counts(lk, kk) == (0, 0, 0),
          f"MXU-tile kernel launched {launches} times for {len(runs)} calls")
    stream = torch.cuda.current_stream().cuda_stream
    for dtype, fast, _, targets, u, base, _ in runs:
        # the pool each call gathered on the card, against the per-layer
        # pack of the same gate (every geometry here is its own cache entry)
        tile = lk._mxu_tile(n, targets, dtype, fast, base.device, stream)
        want = lk._operands(lk._mxu_tile_layer(n, u, targets, dtype), n,
                            dtype, base.device, fast)
        got = tile.operands[2 if fast else 1]
        check(torch.equal(raw_bits(torch, got),
                          raw_bits(torch, want[2 if fast else 1])),
              f"{str(targets):10s} {str(dtype):14s} "
              f"{'FAST   ' if fast else 'HIGHEST'} the pool gathered on the "
              "card equals the per-layer pack bit for bit")
    errs = []
    for dtype, fast, tol, targets, u, base, got in runs:
        want = lk.apply_mxu_tile_plain(base.clone(), n, u, targets, fast)
        err, rel = rel_err(got, want)
        errs.append(err)
        check(rel <= tol and bool(torch.isfinite(got).all()),
              f"{str(targets):10s} {str(dtype):14s} "
              f"{'FAST   ' if fast else 'HIGHEST'} max|diff| {err:.3e}, "
              f"/ max|plain| {rel:.3e} <= {tol:g}")
    top = lk.max_mid_qubit(lk.tile_rows_for(torch.float32)) + 1
    try:
        lk.apply_mxu_tile(random_planes(torch, rng, n, torch.float32,
                                        "cuda"), n, np.eye(2), (top,))
        raised = False
    except ValueError:
        raised = True
    check(raised, f"a row target beyond the tile (qubit {top}) raises "
          "ValueError")

    # times on one lane-only tile, the one target set that a single
    # library call computes too (a row bit needs a permute first)
    targets, u = MXU_TILE_TARGETS[0], random_unitary(rng, 2)
    planes = random_planes(torch, rng, n, torch.float32, "cuda")
    ms = cuda_ms(torch, lambda: lk.apply_mxu_tile(planes, n, u, targets),
                 reps=20)
    fast_ms = cuda_ms(torch, lambda: lk.apply_mxu_tile(
        planes, n, u, targets, fast=True), reps=20)
    # the launch alone (the same one-stage layer, its operator packed once
    # on the layer), the card held busy while the host enqueues: the
    # kernel's own time
    layer = lk._mxu_tile_layer(n, u, targets, torch.float32)
    kernel_ms, fast_kernel_ms = (device_ms(torch, lambda: lk.apply_layer(
        planes, n, layer, fast=fast), reps=20) for fast in (False, True))
    call_ms, fast_call_ms = (device_ms(torch, lambda: lk.apply_mxu_tile(
        planes, n, u, targets, fast=fast), reps=20) for fast in (False,
                                                                 True))
    plain = cuda_ms(torch, lambda: lk.apply_mxu_tile_plain(
        planes, n, u, targets), reps=5)
    bound, by, hbm, ops = layer_bound_ms(lk, layer, n, torch.float32)
    m = layer.stages[0][2]
    z = torch.complex(planes[0], planes[1]).view(-1, 128)
    mt = torch.as_tensor(np.ascontiguousarray(m.T), dtype=torch.complex64,
                         device="cuda")
    lib = cuda_ms(torch, lambda: torch.matmul(z, mt), reps=20)
    print(f"  targets {targets} on {card}: call {ms:.4f} ms (FAST "
          f"{fast_ms:.4f} ms), device-only: the launch alone "
          f"{kernel_ms:.4f} ms (FAST {fast_kernel_ms:.4f} ms), the call "
          f"(upload, gather, launch) {call_ms:.4f} ms (FAST "
          f"{fast_call_ms:.4f} ms); the call is set by "
          + ("the host" if ms > 1.5 * call_ms else "the device")
          + " (FAST: "
          + ("the host" if fast_ms > 1.5 * fast_call_ms else "the device")
          + ")"
          + f"; bound {bound:.4f} ms ({by}; HBM {hbm:.4f} "
          f"ms, flops at peak {ops:.4f} ms), plain {plain:.4f} ms, "
          f"torch.matmul complex64 {lib:.4f} ms")
    # the row stages' part of the phase, with its wall time: the phase's
    # share of the script's time limit
    t0 = time.perf_counter()
    row_targets = mxu_row_target_times(torch, lk, rng, card)
    t1 = time.perf_counter()
    wide = compiled_wide_gates(torch, qt, lk, kk, rng, card)
    t2 = time.perf_counter()
    print(f"  phase 3e wall time: row-target times {t1 - t0:.1f} s, "
          f"wide-gate path {t2 - t1:.1f} s")
    return {
        "name": "mxu_tile",
        "route": "cuda",
        "source": "quest_tpu_torch/csrc/layer_kernel.cu",
        "replaces": "quest_tpu/ops/pallas_kernels.py:813",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": lib,
        "fast_ms": fast_ms,
        "device_ms": kernel_ms,
        "fast_device_ms": fast_kernel_ms,
        "call_device_ms": call_ms,
        "fast_call_device_ms": fast_call_ms,
        "qubits": n,
        "row_targets": row_targets,
        "compiled_wide_gates": wide,
    }


def device_planes(torch, n: int, dtype, seed: int):
    """A normalised random state of n qubits made on the card from a
    seeded generator (a 26-qubit state from numpy takes seconds)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    planes = torch.randn(2, 1 << n, generator=gen, dtype=dtype,
                         device="cuda")
    return planes.div_(torch.linalg.vector_norm(planes))


def mxu_row_target_times(torch, lk, rng, card):
    """The MXU tile on the target sets with a row bit (the row stages
    ``stage_dense_row<T,1>``/``<T,2>``) at float32 and float64, at 20
    qubits and at 26 (4096 / 8192 tiles, the state far past L2): each
    output held against the port's ``apply_unitary`` (a strided view of the
    planes and one ``torch.matmul``) first, then ms per call, the launch
    alone device-only (the prebuilt one-stage layer through
    ``apply_layer``, the card held busy while the host enqueues), the
    one-stage layer's bound, ``apply_unitary``'s ms, and for the target
    sets whose groups are contiguous runs of dim amplitudes ((2, 5, 7):
    256, (7, 8): 512) one complex ``torch.matmul`` of the packed operator
    on the planes viewed as (2^n / dim, dim), which computes exactly the
    stage's function (held against the kernel's output too)."""
    from quest_tpu_torch.core.apply import apply_unitary
    rows = []
    for n, reps in ((CHECK_QUBITS, 20), (ROW_STAGE_QUBITS, 5)):
        for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            cdtype = torch.complex64 if dtype == torch.float32 \
                else torch.complex128
            planes = device_planes(torch, n, dtype, seed=n)
            for targets in MXU_TILE_TARGETS:
                if all(t < lk.LANE_QUBITS for t in targets):
                    continue
                u = random_unitary(rng, 1 << len(targets))
                got = lk.apply_mxu_tile(planes.clone(), n, u, targets)
                want = apply_unitary(planes.clone(), n, u, targets)
                err, rel = rel_err(got, want)
                del want
                check(rel <= tol, f"{n} q MXU tile {targets} {dtype} vs "
                      f"apply_unitary max|diff| / max|amp| {rel:.3e} <= "
                      f"{tol:g}")
                layer = lk._mxu_tile_layer(n, u, targets, dtype)
                m = layer.stages[0][2]
                dim = m.shape[0]
                matmul = None
                if targets in ((2, 5, 7), (7, 8)):
                    z = torch.complex(planes[0], planes[1]).view(-1, dim)
                    mt = torch.as_tensor(np.ascontiguousarray(m.T),
                                         dtype=cdtype, device="cuda")
                    prod = torch.matmul(z, mt).view(-1)
                    _, mrel = rel_err(torch.stack([prod.real, prod.imag]),
                                      got)
                    del prod
                    check(mrel <= tol, f"{n} q one torch.matmul of the "
                          f"packed operator {targets} {dtype} vs the kernel "
                          f"{mrel:.3e} <= {tol:g}")
                    matmul = cuda_ms(torch, lambda: torch.matmul(z, mt),
                                     reps=reps)
                    del z
                del got
                ms = cuda_ms(torch, lambda: lk.apply_mxu_tile(
                    planes, n, u, targets), reps=reps)
                dev = device_ms(torch, lambda: lk.apply_layer(
                    planes, n, layer), reps=reps)
                lib = cuda_ms(torch, lambda: apply_unitary(
                    planes, n, u, targets), reps=reps)
                bound, by, _, ops = layer_bound_ms(lk, layer, n, dtype)
                core = ops * PEAK_FLOPS[dtype.itemsize] \
                    / CUDA_CORE_FLOPS[dtype.itemsize]
                j = sum(t >= lk.LANE_QUBITS for t in targets)
                print(f"  {n} q row targets {str(targets):10s} "
                      f"{str(dtype):14s} (stage_dense_row<T,{j}>): call "
                      f"{ms:.4f} ms, the launch alone device-only "
                      f"{dev:.4f} ms, bound {bound:.4f} ms ({by}; the "
                      f"launch at {bound / dev:.1%} of it"
                      + ("" if core == ops else
                         f"; at the CUDA-core rate {core:.4f} ms, "
                         f"{core / dev:.1%}") + "), apply_unitary "
                      f"{lib:.4f} ms (call / it {ms / lib:.2f}x)"
                      + ("" if matmul is None else
                         f", one torch.matmul {matmul:.4f} ms (launch / "
                         f"it {dev / matmul:.2f}x)") + f" on {card}")
                rows.append({"qubits": n, "targets": list(targets),
                             "dtype": str(dtype), "row_bits": j, "ms": ms,
                             "device_ms": dev, "bound_ms": bound,
                             "bound_by": by, "cuda_core_ms": core,
                             "library_ms": lib, "matmul_ms": matmul,
                             "max_abs_err": err})
            del planes
            torch.cuda.empty_cache()
    return rows


def wide_gate_circuit(qt, n: int, rng):
    """Lane and row gates around a dense 8-qubit gate on qubits 0-7 and a
    dense 9-qubit gate on qubits 0-8: the gates the crossover model puts
    into rowmxu stages at J = 1 and J = 2."""
    c = qt.Circuit(n)
    c.h(0)
    c.gate(random_unitary(rng, 1 << 8), range(8))
    c.ry(9, 0.3)
    c.rx(2, 0.4)
    c.gate(random_unitary(rng, 1 << 9), range(9))
    c.rz(10, 0.2)
    c.h(3)
    return c


def compiled_wide_gates(torch, qt, lk, kk, rng, card):
    """The row stages on a compiled path: wide_gate_circuit at 26 qubits
    compiled with mxu=None (the model decides) at float32 and float64,
    its plan holding rowmxu stages at J = 1 and 2, the layer kernel
    counted from 0 over one run, the state against the same circuit
    compiled with layers=False, and both runs timed."""
    n = ROW_STAGE_QUBITS
    out = []
    for prec, tol in ((qt.SINGLE, 1e-4), (qt.DOUBLE, 1e-10)):
        env = qt.createQuESTEnv(precision=prec)
        circ = wide_gate_circuit(qt, n, rng)
        cc = circ.compile(env)
        plain = circ.compile(env, layers=False)
        row_js = sorted(len(st[1]) for op in cc._ops
                        if isinstance(op, lk.LayerOp)
                        for st in op.stages if st[0] == "rowmxu")
        check(row_js == [1, 2] and cc.num_layers == 1
              and plain.num_layers == 0,
              f"{n} q wide gates {prec.real_dtype}: the model put them in "
              f"rowmxu stages J = {row_js} of {cc.num_layers} layer(s)")
        qa, qb = qt.createQureg(n, env), qt.createQureg(n, env)
        base = device_planes(torch, n, prec.real_dtype, seed=7)
        qa.state, qb.state = base.clone(), base
        reset_counts(lk, kk)
        cc.run(qa)
        torch.cuda.synchronize()
        launches = counts(lk, kk)
        plain.run(qb)
        torch.cuda.synchronize()
        dist = float(torch.linalg.vector_norm(qa.state - qb.state))
        check(launches == (1, 0, 0) and dist <= tol,
              f"{n} q wide gates {prec.real_dtype}: {launches[0]} layer "
              f"launch(es); ||psi_layers - psi_plain||_2 {dist:.3e} <= "
              f"{tol:g}")
        run_s = timed_runs(torch, lambda: cc.run(qa), reps=3)
        plain_s = timed_runs(torch, lambda: plain.run(qb), reps=3)
        print(f"  {n} q wide gates {prec.real_dtype}: compiled run "
              f"{1e3 * run_s:.2f} ms (1 layer), layers=False "
              f"{1e3 * plain_s:.2f} ms ({plain_s / run_s:.2f}x) on {card}")
        out.append({"dtype": str(prec.real_dtype), "launches": launches[0],
                    "run_ms": 1e3 * run_s, "layers_off_ms": 1e3 * plain_s,
                    "dist": dist})
        qt.destroyQureg(qa, env)
        qt.destroyQureg(qb, env)
        del base
        torch.cuda.empty_cache()
    return out


def kraus_case(rng, num_traj: int, num_ops: int):
    """Lane-embedded random operators, probabilities with zero-probability
    branches, and the edge uniforms: u = 0 where branch 0 has probability
    0 (it must be skipped), u -> 1 where the last branch has probability 0
    (it must not be drawn), and interior draws."""
    kemb = rng.normal(size=(num_ops, 128, 128)) \
        + 1j * rng.normal(size=(num_ops, 128, 128))
    probs = rng.uniform(0.05, 1.0, size=(num_traj, num_ops))
    probs /= probs.sum(axis=1, keepdims=True)
    u = rng.uniform(0.0, 1.0, size=num_traj)
    if num_ops > 1:
        probs[0, 0] = 0.0
        probs[1, -1] = 0.0
        probs[2, num_ops // 2] = 0.0
    u[0] = 0.0
    u[1] = np.nextafter(1.0, 0.0)
    u[3] = 1.0 - 1e-12
    return kemb, probs, u


def drawn_operators(torch, base, got, kemb, probs):
    """The operator each trajectory's kernel output came from: per k, the
    plain product K_k v / sqrt(max(p_k, tiny)) of every trajectory, and the
    k whose product lies nearest the output. A zero-probability branch
    scales by 1/sqrt(tiny) and so lies nearest only if it was drawn."""
    cdt = torch.complex64 if base.dtype == torch.float32 \
        else torch.complex128
    num = base.shape[0]
    v = torch.complex(base[:, 0], base[:, 1]).view(num, -1, 128)
    out = torch.complex(got[:, 0], got[:, 1]).view(num, -1, 128)
    tiny = torch.finfo(probs.dtype).tiny
    dists = []
    for k in range(len(kemb)):
        mt = torch.as_tensor(np.ascontiguousarray(kemb[k].T), dtype=cdt,
                             device=base.device)
        s = (1.0 / torch.sqrt(torch.clamp(probs[:, k], min=tiny))).to(cdt)
        cand = torch.matmul(v, mt) * s[:, None, None]
        dists.append((cand - out).abs().amax(dim=(1, 2)))
    return torch.stack(dists, dim=1).argmin(dim=1)


def phase_kraus(torch, kk, rng):
    n, num_traj = CHECK_QUBITS, 8
    print(f"phase 3c: fused Kraus kernel vs plain version, {n} qubits, "
          f"T = {num_traj}")
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        for num_ops in (2, 4, 16, 64):
            kemb, probs_np, u_np = kraus_case(rng, num_traj, num_ops)
            probs = torch.as_tensor(probs_np, dtype=dtype, device="cuda")
            u01 = torch.as_tensor(u_np, dtype=dtype, device="cuda")
            base = random_batch(torch, rng, num_traj, n, dtype, "cuda")
            j_plain, _ = kk.draw_plain(probs, u01)
            want = kk.fused_kraus_apply_batched_plain(base.clone(), n, kemb,
                                                      probs, u01)
            before = kk.fused_kraus_apply_batched.launches
            got = kk.fused_kraus_apply_batched(base.clone(), n, kemb, probs,
                                               u01)
            torch.cuda.synchronize()
            j_kernel = drawn_operators(torch, base, got, kemb, probs)
            zero = probs.gather(1, j_kernel[:, None])[:, 0] == 0
            _, rel = rel_err(got, want)
            check(kk.fused_kraus_apply_batched.launches == before + 1
                  and torch.equal(j_plain, j_kernel)
                  and not bool(zero.any()) and rel <= tol,
                  f"K = {num_ops:2d} {str(dtype):14s} draws "
                  f"{j_kernel.tolist()} identical, none of probability 0; "
                  f"max|diff| / max|plain| {rel:.3e} <= {tol:g}")


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
    from quest_tpu_torch.ops import kraus_kernel as kk
    reset_counts(lk, kk)
    compiled.run(q1)
    torch.cuda.synchronize()
    launches, batched, kraus = counts(lk, kk)
    check(layers > 0 and launches == layers and batched == kraus == 0,
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
    rels = []
    for i, layer in enumerate(layer_ops):
        a = planes.clone()
        lk.apply_layer(a, n, layer)
        b = lk.apply_layer_plain(planes.clone(), n, layer)
        torch.cuda.synchronize()
        err, rel = rel_err(a, b)
        errs.append(err)
        rels.append(rel)
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
              f"HBM {hbm_ms:.3f} ms, flops at peak {op_ms:.3f} ms), "
              f"plain {plain_ms[-1]:.3f} ms, max|kernel-plain| "
              f"{errs[-1]:.3e}, / max|plain| {rels[-1]:.3e}")
    check(max(rels) <= 1e-5, f"main-path layers: kernel vs plain max|diff| "
          f"/ max|plain| {max(rels):.3e} <= 1e-5 at {n} qubits")
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

    # the same lane stage and a run of 7 rowdiag stages (k = 3, bits inside
    # and above the tile) in one layer: the run's cost inside the tile
    hi = lk.max_mid_qubit(lk.tile_rows_for(planes.dtype))
    run = diag_cases(rng, n, hi)["diag7"]
    lane_diag = lk.LayerOp(n, 8, [("lane", m)] + run)
    a = lk.apply_layer(planes.clone(), n, lane_diag)
    b = lk.apply_layer_plain(planes.clone(), n, lane_diag)
    torch.cuda.synchronize()
    ld_err, ld_rel = rel_err(a, b)
    del a, b
    torch.cuda.empty_cache()
    check(ld_rel <= 1e-5, f"lane + 7 rowdiag layer at {n} qubits: kernel "
          f"vs plain max|diff| {ld_err:.3e}, / max|plain| {ld_rel:.3e} "
          "<= 1e-5")
    ld_ms = cuda_ms(torch, lambda: lk.apply_layer(planes, n, lane_diag),
                    reps=3)
    ld_bound, ld_by, _, _ = layer_bound_ms(lk, lane_diag, n, planes.dtype)
    print(f"  lane + 7 rowdiag layer: kernel {ld_ms:.3f} ms, bound "
          f"{ld_bound:.3f} ms ({ld_by}); the lane-only layer {lane_ms:.3f} "
          f"ms, so {(ld_ms - lane_ms) / len(run):.3f} ms per rowdiag stage "
          f"inside the tile on {card}")
    # the run's fixed cost (one stage) and its table bytes (7 stages of
    # k = 1: a quarter of the tables above)
    for label, stages in (("1 rowdiag stage (k = 3)", run[:1]),
                          ("7 rowdiag stages of k = 1",
                           [("rowdiag", st[1][:2], st[2][-1:])
                            for st in run])):
        layer = lk.LayerOp(n, 1 + len(stages), [("lane", m)] + stages)
        t = cuda_ms(torch, lambda: lk.apply_layer(planes, n, layer), reps=3)
        print(f"  lane + {label}: kernel {t:.3f} ms, "
              f"{t - lane_ms:.3f} ms above the lane-only layer")

    # the same at float64 on 29 qubits: its planes and a complex128
    # torch.matmul fit beside the live float32 state. The stage is
    # row-local, so its first 2^24 amplitudes are a 24-qubit state that
    # the plain version checks
    n64, n_check = n - 1, 24
    p64 = torch.randn(2, 1 << n64, dtype=torch.float64, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(29))
    p64.mul_(2.0 ** (-(n64 + 1) / 2))
    lane64 = lk.LayerOp(n64, 1, [("lane", m)])
    head = p64[:, :1 << n_check].contiguous()
    lk.apply_layer(p64, n64, lane64)
    want = lk.apply_layer_plain(head, n_check,
                                lk.LayerOp(n_check, 1, [("lane", m)]))
    torch.cuda.synchronize()
    err64, rel64 = rel_err(p64[:, :1 << n_check], want)
    del head, want
    check(rel64 <= 1e-12, f"float64 lane-only layer at {n64} qubits, first "
          f"2^{n_check} amplitudes: kernel vs plain max|diff| {err64:.3e}, "
          f"/ max|plain| {rel64:.3e} <= 1e-12")
    lane64_ms = cuda_ms(torch, lambda: lk.apply_layer(p64, n64, lane64),
                        reps=3)
    lane64_bound, lane64_by, _, lane64_ops = layer_bound_ms(
        lk, lane64, n64, torch.float64)
    lane64_core = lane64_ops * PEAK_FLOPS[8] / CUDA_CORE_FLOPS[8]
    z = torch.complex(p64[0], p64[1]).view(-1, 128)
    del p64
    mt = torch.as_tensor(m.T, dtype=torch.complex128, device=planes.device)
    lib64_ms = cuda_ms(torch, lambda: torch.matmul(z, mt), reps=3)
    del z
    torch.cuda.empty_cache()
    print(f"  float64 lane-only layer, {n64} qubits: kernel "
          f"{lane64_ms:.3f} ms, bound {lane64_bound:.3f} ms ({lane64_by}; "
          f"at the CUDA-core rate {lane64_core:.3f} ms), torch.matmul "
          f"complex128 {lib64_ms:.3f} ms")

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
        "lane_rowdiag7_ms": ld_ms,
        "lane_rowdiag7_bound_ms": ld_bound,
        "lane_only_f64_ms": lane64_ms,
        "lane_only_f64_bound_ms": lane64_bound,
        "lane_only_f64_cuda_core_ms": lane64_core,
        "lane_only_f64_library_ms": lib64_ms,
        "lane_only_f64_max_abs_err": err64,
        "qubits": n,
        "gates_per_s": len(gates) / run_s,
    }


def hea_circuit(qt, num_qubits: int, layers: int):
    """bench.py build_hea_circuit: per layer one ry+rz column of named
    parameters and a CNOT ring — the VQE ensemble workload's circuit."""
    c = qt.Circuit(num_qubits)
    for layer in range(layers):
        for q in range(num_qubits):
            c.ry(q, c.parameter(f"y{layer}_{q}"))
            c.rz(q, c.parameter(f"z{layer}_{q}"))
        for q in range(num_qubits):
            c.cnot(q, (q + 1) % num_qubits)
    return c


def trajectory_circuit(qt, num_qubits: int, rng):
    """bench.py's "Pallas trajectory waves" circuit: a ry column,
    damp(2, 0.2), a CNOT chain, dephase(4, 0.15), a ry column."""
    c = qt.Circuit(num_qubits)
    for q in range(num_qubits):
        c.ry(q, float(rng.uniform(0.2, 2.8)))
    c.damp(2, 0.2)
    for q in range(num_qubits - 1):
        c.cnot(q, q + 1)
    c.dephase(4, 0.15)
    for q in range(num_qubits):
        c.ry(q, float(rng.uniform(0.2, 2.8)))
    return c


def param_trajectory_circuit(qt, num_qubits: int, rng):
    """trajectory_circuit with its two ry columns recorded as Params a<q>
    and b<q> (2n parameters), at the angles it draws from ``rng``: returns
    (circuit, their values in the circuit's parameter order)."""
    c = qt.Circuit(num_qubits)
    values = {}
    for q in range(num_qubits):
        values[f"a{q}"] = float(rng.uniform(0.2, 2.8))
        c.ry(q, c.parameter(f"a{q}"))
    c.damp(2, 0.2)
    for q in range(num_qubits - 1):
        c.cnot(q, q + 1)
    c.dephase(4, 0.15)
    for q in range(num_qubits):
        values[f"b{q}"] = float(rng.uniform(0.2, 2.8))
        c.ry(q, c.parameter(f"b{q}"))
    return c, np.array([values[nm] for nm in c.param_names])


def reset_counts(lk, kk):
    for fn in (lk.apply_layer, lk.apply_layer_batched):
        fn.launches = fn.fast_launches = fn.diag_launches = 0
    lk.apply_mxu_tile.launches = 0
    kk.fused_kraus_apply_batched.launches = 0


def counts(lk, kk):
    """Full-precision launches: (layer kernel, batched, Kraus)."""
    return (lk.apply_layer.launches, lk.apply_layer_batched.launches,
            kk.fused_kraus_apply_batched.launches)


def fast_counts(lk):
    """FAST and MXU-tile launches: (layer kernel, batched, MXU tile)."""
    return (lk.apply_layer.fast_launches, lk.apply_layer_batched.fast_launches,
            lk.apply_mxu_tile.launches)


def lane_matmul_ms(torch, states, ops):
    """One complex64 ``torch.matmul`` of the lane product over a ``(B, 2,
    N)`` batch: ``ops`` is one ``(128, 128)`` operator for every row or a
    ``(B, 128, 128)`` stack, one per state."""
    z = torch.complex(states[:, 0], states[:, 1]).view(
        states.shape[0], -1, 128)
    mt = torch.as_tensor(np.ascontiguousarray(
        np.swapaxes(np.asarray(ops), -1, -2)), dtype=torch.complex64,
        device=states.device)
    ms = cuda_ms(torch, lambda: torch.matmul(z, mt), reps=3)
    del z
    return ms


def bf16_stage_ms(torch, num_amps: int, dim: int):
    """One bf16 ``torch.matmul`` of a FAST dense stage of width ``dim``
    over ``num_amps`` amplitudes in stacked real hi/lo form, ``(2 *
    num_amps / dim, 2 * dim) @ (2 * dim, 2 * dim)``: the FAST stage's
    products in one library call, a time yardstick only (random bf16
    data). Where the card lacks room for its input and output, a quarter
    of the rows, timed and scaled by 4. Returns (ms, scaled)."""
    rows = 2 * num_amps // dim
    need = 2 * rows * 2 * dim * 2            # input and output, bf16
    scaled = need > torch.cuda.mem_get_info()[0] // 2
    if scaled:
        rows //= 4
    x = torch.randn(rows, 2 * dim, device="cuda").to(torch.bfloat16)
    w = torch.randn(2 * dim, 2 * dim, device="cuda").to(torch.bfloat16)
    ms = cuda_ms(torch, lambda: torch.matmul(x, w), reps=3)
    del x
    torch.cuda.empty_cache()
    return (4 * ms if scaled else ms), scaled


def bf16_lane_ms(torch, states):
    """One bf16 ``torch.matmul`` of the stacked real lane product over a
    ``(B, 2, N)`` batch: ``[re | im]`` rows times a ``(256, 256)`` block
    operator. Its bf16 output makes it a time yardstick only."""
    x = torch.cat([states[:, 0].reshape(-1, 128),
                   states[:, 1].reshape(-1, 128)], dim=1).to(torch.bfloat16)
    w = torch.randn(256, 256, device=states.device).to(torch.bfloat16)
    ms = cuda_ms(torch, lambda: torch.matmul(x, w), reps=3)
    del x
    return ms


def batched_layer_times(torch, lk, states, n, layer_ops, label,
                        fast=False):
    """The batched layer kernel on a path's layers: held against its plain
    version over the whole batch (max |diff| / max |plain| <= 1e-5), ms
    (CUDA events), its bound, its plain version's ms, and one complex64
    torch.matmul of each layer's lane product (where the layer has one)
    over the whole batch — for the FAST kernel (``fast``) one bf16
    torch.matmul of the stacked real lane product."""
    rows = []
    lib_fast = bf16_lane_ms(torch, states) if fast else None
    for i, layer in enumerate(layer_ops):
        a = states.clone()
        lk.apply_layer_batched(a, n, layer, fast=fast)
        b = lk.apply_layer_batched_plain(states.clone(), n, layer, fast)
        torch.cuda.synchronize()
        err, rel = rel_err(a, b)
        del a, b
        torch.cuda.empty_cache()
        check(rel <= 1e-5, f"{label} layer {i}: batched kernel vs plain "
              f"over all {states.shape[0]} states: max|diff| {err:.3e}, "
              f"/ max|plain| {rel:.3e} <= 1e-5")
        ms = cuda_ms(torch, lambda: lk.apply_layer_batched(
            states, n, layer, fast=fast), reps=3)
        plain = cuda_ms(torch, lambda: lk.apply_layer_batched_plain(
            states, n, layer, fast), reps=1)
        bound, by, hbm, ops = layer_bound_ms(lk, layer, n, states.dtype,
                                             states.shape[0], fast)
        lanes = [st[1] for st in layer.stages if st[0] == "lane"]
        if fast:
            lib, lib_name = lib_fast, "bf16 stacked real"
        else:
            lib = lane_matmul_ms(torch, states, lanes[0]) if lanes else None
            lib_name = "complex64"
        torch.cuda.empty_cache()
        print(f"  {label} layer {i}: {[st[0] for st in layer.stages]}")
        print(f"    kernel {ms:.3f} ms, bound {bound:.3f} ms ({by}; HBM "
              f"{hbm:.3f} ms, {'bf16 tensor-core + ' if fast else ''}"
              f"flops at peak {ops:.3f} ms), plain {plain:.3f} ms, "
              f"torch.matmul {lib_name} lane product "
              f"{'not measured' if lib is None else f'{lib:.3f} ms'}, "
              f"max|kernel-plain| {err:.3e}")
        rows.append((ms, bound, by, plain, lib, err))
    return rows


def host_binding_ms(compiled, pm) -> float:
    """Host milliseconds one sweep spends binding parameter gates: every
    mat_fn/diag_fn bound for every row at once."""
    from quest_tpu_torch.ops.adjoint import bind_rows
    t0 = time.perf_counter()
    for op in compiled._ops:
        fn = getattr(op, "mat_fn", None) or getattr(op, "diag_fn", None)
        if fn is not None:
            bind_rows(fn, compiled.param_names, pm)
    return (time.perf_counter() - t0) * 1e3


def hea_problem(qt):
    """The ensemble cell: the HEA circuit, a seeded Pauli sum (terms,
    coefficients and the flat codes calcExpecPauliSum takes) and the
    parameter matrix."""
    n = SWEEP_QUBITS
    rng = np.random.default_rng(2026)
    circ = hea_circuit(qt, n, SWEEP_LAYERS)
    codes = rng.integers(0, 4, size=(SWEEP_TERMS, n))
    coeffs = rng.normal(size=SWEEP_TERMS)
    terms = [[(q, int(codes[t, q])) for q in range(n)]
             for t in range(SWEEP_TERMS)]
    codes_flat = [int(c) for c in codes.reshape(-1)]
    pm = rng.uniform(0.0, 2.0 * np.pi,
                     size=(SWEEP_BATCH, len(circ.param_names)))
    return circ, terms, coeffs, codes_flat, pm


def phase_sweep(torch, qt, lk, kk, card):
    n, batch = SWEEP_QUBITS, SWEEP_BATCH
    print(f"phase 8: batched ensemble engine, {n}-qubit {SWEEP_LAYERS}-layer "
          f"HEA, complex64, batch {batch}, {SWEEP_TERMS}-term Pauli sum, "
          f"on {card}")
    circ, terms, coeffs, codes_flat, pm = hea_problem(qt)
    names = circ.param_names
    env = qt.createQuESTEnv(seed=[2026])
    t0 = time.perf_counter()
    compiled = circ.compile(env)
    layers = compiled.num_layers
    print(f"  compiled {len(circ.ops)} gates into "
          f"{len(compiled.plan.items)} ops ({layers} layers) in "
          f"{time.perf_counter() - t0:.2f} s")

    torch.cuda.synchronize()
    reset_counts(lk, kk)
    t0 = time.perf_counter()
    energies = compiled.expectation_sweep(pm, (terms, coeffs))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    single, batched, kraus = counts(lk, kk)
    check(layers > 0 and batched == layers and single == 0 and kraus == 0,
          f"batched layer kernel launched {batched} times for {layers} "
          f"layer ops (single-state {single}, Kraus {kraus})")
    check(energies.shape == (batch,) and bool(np.isfinite(energies).all()),
          f"{batch} finite energies, first {energies[:3]}")

    # the engine's states and energies against one run per point; the
    # energies of a random ansatz state are small (|E| ~ 1e-4), so they
    # are held relative to the largest of them
    states = compiled.sweep(pm)
    q = qt.createQureg(n, env)
    amp_err, e_err = 0.0, 0.0
    for b in range(4):
        qt.initZeroState(q)
        compiled.run(q, dict(zip(names, pm[b])))
        amp_err = max(amp_err, float((q.state - states[b]).abs().max()))
        e = qt.calcExpecPauliSum(q, codes_flat, coeffs)
        e_err = max(e_err, abs(e - float(energies[b])))
    amp_rel = amp_err / float(states[:4].abs().max())
    e_rel = e_err / float(np.abs(energies[:4]).max())
    check(amp_rel <= 1e-5, f"sweep vs per-point run, 4 points: max|state "
          f"diff| {amp_err:.3e}, / max|amp| {amp_rel:.3e} <= 1e-5")
    check(e_rel <= 1e-3, f"expectation_sweep vs per-point run + "
          f"calcExpecPauliSum, 4 points: max|diff| {e_err:.3e}, / max|E| "
          f"{e_rel:.3e} <= 1e-3")
    del q

    reps = 1                     # one timed sweep: the script's time limit
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        compiled.expectation_sweep(pm, (terms, coeffs))
    torch.cuda.synchronize()
    sweep_s = (time.perf_counter() - t0) / reps
    bind_ms = host_binding_ms(compiled, pm)
    print(f"  expectation_sweep: {sweep_s * 1e3:.1f} ms per {batch}-point "
          f"sweep, {batch / sweep_s:.2f} points/s (first call "
          f"{first_s * 1e3:.1f} ms); host parameter binding "
          f"{bind_ms:.1f} ms of it")
    torch.cuda.empty_cache()

    layer_ops = [op for op in compiled._ops if op.kind == "layer"]
    rows = batched_layer_times(torch, lk, states, n, layer_ops, "sweep")
    del states
    torch.cuda.empty_cache()
    return {"launches": batched, "rows": rows, "points_per_s":
            batch / sweep_s, "sweep_ms": sweep_s * 1e3, "bind_ms": bind_ms,
            "energies": energies}


def kraus_bound_ms(n: int, num_traj: int, num_ops: int, itemsize: int):
    """Least time for one fused Kraus step: every state's planes read and
    written once, the operator stack and probabilities read once, against
    8 * 128 real flops per amplitude (the drawn operator's lane product)."""
    amps = float(num_traj) * (1 << n)
    nbytes = 4.0 * itemsize * amps + itemsize * (
        num_ops * 2 * 128 * 128 + num_traj * (num_ops + 1))
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    flops_ms = 1e3 * 8.0 * 128 * amps / PEAK_FLOPS[itemsize]
    return max(bytes_ms, flops_ms), \
        ("bytes" if bytes_ms >= flops_ms else "operations"), \
        bytes_ms, flops_ms


def phase_trajectories(torch, qt, lk, kk, card):
    n = TRAJ_QUBITS
    print(f"phase 9: noisy trajectories, {n} qubits, complex64, "
          f"expectation over {TRAJ_MAX} trajectories in waves of "
          f"{TRAJ_WAVE}, on {card}")
    rng = np.random.default_rng(2110)
    circ = trajectory_circuit(qt, n, rng)
    terms = [[(q, 3)] for q in range(n)]
    coeffs = list(rng.normal(size=n))
    env = qt.createQuESTEnv(seed=[7])
    tp = circ.compile_trajectories(env)
    kinds = [item[0] for item in tp._items]
    n_layers, n_fused = kinds.count("layer"), kinds.count("kraus_fused")
    print(f"  items: {kinds}")
    check(n_layers >= 1 and n_fused == 2,
          f"{n_layers} layers and {n_fused} fused channels on the path")

    torch.cuda.synchronize()
    reset_counts(lk, kk)
    t0 = time.perf_counter()
    mean, err = tp.expectation(terms, coeffs, num_trajectories=TRAJ_MAX,
                               wave_size=TRAJ_WAVE, seed=1)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    single, batched, kraus = counts(lk, kk)
    waves = tp.last_traj_stats["waves"]
    check(waves == TRAJ_MAX // TRAJ_WAVE
          and tp.last_traj_stats["trajectories_run"] == TRAJ_MAX
          and batched == n_layers * waves and kraus == n_fused * waves
          and single == 0,
          f"{waves} waves: batched layer kernel launched {batched} times "
          f"({n_layers} layers x {waves}), Kraus kernel {kraus} times "
          f"({n_fused} channels x {waves})")
    check(np.isfinite(mean) and 0.0 < err < 1.0,
          f"<H> = {mean:.6f} +- {err:.6f}")
    print(f"  {run_s * 1e3:.1f} ms for {TRAJ_MAX} trajectories: "
          f"{TRAJ_MAX / run_s:.2f} trajectories/s")

    planes = tp.trajectory_sweep(8)
    norms = (planes.double() ** 2).sum(dim=(1, 2))
    dev = float((norms - 1.0).abs().max())
    check(dev <= 1e-4, f"8-trajectory sweep: max|norm - 1| {dev:.3e} "
          f"<= 1e-4")
    del planes

    small = trajectory_circuit(qt, 12, np.random.default_rng(12))
    tp_card = small.compile_trajectories(env)
    tp_cpu = small.compile_trajectories(qt.createQuESTEnv(
        device="cpu", precision=qt.SINGLE, seed=[7]))
    u = np.random.default_rng(3).uniform(size=(64, tp_card.num_channels))
    a = tp_card.trajectory_sweep(64, uniforms=u).cpu()
    b = tp_cpu.trajectory_sweep(64, uniforms=u)
    diff = float((a - b).abs().max())
    sterms = [[(q, 3)] for q in range(12)]
    m_card, _ = tp_card.expectation(sterms, [1.0] * 12,
                                    num_trajectories=64, seed=5)
    m_cpu, _ = tp_cpu.expectation(sterms, [1.0] * 12, num_trajectories=64,
                                  seed=5)
    check(diff <= 1e-4 and abs(m_card - m_cpu) <= 1e-4,
          f"12-qubit copy, same uniforms, card vs CPU: max|diff| "
          f"{diff:.3e}, <H> {m_card:.6f} vs {m_cpu:.6f}")

    # kernel times on one wave's batch at the first fused channel
    states = tp.trajectory_sweep(TRAJ_WAVE)
    item = next(it for it in tp._items if it[0] == "kraus_fused")
    _, targets, (_, estack, kemb), _ = item
    es = torch.as_tensor(estack, dtype=torch.complex64, device="cuda")
    probs = tp._channel_probs(states, targets, es)
    u01 = torch.rand(TRAJ_WAVE, dtype=torch.float32, device="cuda")
    a = kk.fused_kraus_apply_batched(states.clone(), n, kemb, probs, u01)
    b = kk.fused_kraus_apply_batched_plain(states.clone(), n, kemb, probs,
                                           u01)
    torch.cuda.synchronize()
    kerr, krel = rel_err(a, b)
    del a, b
    torch.cuda.empty_cache()
    k_ms = cuda_ms(torch, lambda: kk.fused_kraus_apply_batched(
        states, n, kemb, probs, u01), reps=3)
    k_plain = cuda_ms(torch, lambda: kk.fused_kraus_apply_batched_plain(
        states, n, kemb, probs, u01), reps=1)
    k_bound, k_by, k_hbm, k_ops = kraus_bound_ms(n, TRAJ_WAVE, len(kemb), 4)
    j, _ = kk.draw_plain(probs, u01)
    k_lib = lane_matmul_ms(torch, states, kemb[j.cpu().numpy()])
    print(f"  Kraus kernel ({len(kemb)} operators, {TRAJ_WAVE} "
          f"trajectories): {k_ms:.3f} ms, bound {k_bound:.3f} ms ({k_by}; "
          f"HBM {k_hbm:.3f} ms, flops at peak {k_ops:.3f} ms), plain "
          f"{k_plain:.3f} ms, torch.matmul complex64 {k_lib:.3f} ms, "
          f"max|kernel-plain| {kerr:.3e}")
    check(krel <= 1e-5, f"main-path channel: Kraus kernel vs plain over "
          f"all {TRAJ_WAVE} trajectories: max|diff| {kerr:.3e}, / max|plain| "
          f"{krel:.3e} <= 1e-5")
    layer_ops = [it[1] for it in tp._items if it[0] == "layer"]
    rows = batched_layer_times(torch, lk, states, n, layer_ops,
                               "trajectory")
    del states
    torch.cuda.empty_cache()
    profile_device(torch, lambda: tp.expectation(
        terms, coeffs, num_trajectories=TRAJ_WAVE, wave_size=TRAJ_WAVE,
        seed=2), f"one {TRAJ_WAVE}-trajectory wave", top=10)
    return {"launches_layer": batched, "launches_kraus": kraus,
            "rows": rows, "traj_per_s": TRAJ_MAX / run_s,
            "kraus": (k_ms, k_bound, k_by, k_plain, k_lib, kerr)}


def held_kraus(torch, kk, errs):
    """A stand-in for ``kk.fused_kraus_apply_batched`` that launches the
    kernel and holds its output, and its index output where one is asked
    for, against the plain version on the same input, appending
    ``(max|diff|, relative, indices equal)`` to ``errs``. Returns ``(the
    wrapper, the stand-in)``."""
    launch = kk.fused_kraus_apply_batched

    def held(states, num_qubits, kstack, probs, u01, index_out=None):
        index = torch.empty(states.shape[0], dtype=torch.int32,
                            device=states.device)
        plain = kk.fused_kraus_apply_batched_plain(
            states.clone(), num_qubits, kstack, probs, u01, index)
        launch(states, num_qubits, kstack, probs, u01, index_out)
        torch.cuda.synchronize()
        same = index_out is None or torch.equal(index_out, index)
        errs.append(rel_err(states, plain) + (same,))
        del plain
        return states

    held.launches = 0
    return launch, held


class HeldKraus:
    """While open, every launch of the fused Kraus kernel goes through the
    wrapper and is held against its plain version on the same input (its
    index output too); ``launches`` and ``errs`` stay readable after."""

    def __init__(self, torch, kk):
        self.torch, self.kk, self.errs = torch, kk, []
        self.launch, self.held = held_kraus(torch, kk, self.errs)

    def __enter__(self):
        self.kk.fused_kraus_apply_batched = self.held
        return self

    def __exit__(self, *exc):
        self.kk.fused_kraus_apply_batched = self.launch

    @property
    def launches(self) -> int:
        return self.held.launches

    def ok(self) -> bool:
        return all(e[2] for e in self.errs) and \
            max((e[1] for e in self.errs), default=0.0) <= 1e-5

    def max_err(self) -> float:
        return max((e[0] for e in self.errs), default=0.0)


def traj_objective(torch, red, tp, pm, draws, operands, baseline):
    """The fixed-branch objective of 2 trajectories, ``<psi~|(H - b)|psi~>
    / N0``: the chain replayed with each channel's RECORDED operator ``K_j
    / sqrt(p_j)`` (``draws``) at the parameter rows ``pm``, no draw made,
    then ``<psi|H|psi> - b |psi|^2`` of the unnormalised result."""
    states = tp._start(None).expand(len(pm), 2, -1).clone(
        memory_format=torch.contiguous_format)
    tp._replay(states, pm, draws)
    h = red.pauli_sum_total_sv(states, *operands)
    return (h - baseline * (states * states).sum(dim=(1, 2))).cpu().numpy()


def phase_traj_gradients(torch, qt, lk, kk, card):
    """Phase 9g: expectation_grad on phase 9's circuit with its ry columns
    as Params."""
    from quest_tpu_torch.ops import reductions as red
    n, wave = TRAJ_QUBITS, TRAJ_WAVE
    waves = TRAJ_GRAD_MAX // wave
    print(f"phase 9g: trajectory gradients (adjoint walk over the wave), "
          f"{n} qubits, complex64, expectation_grad over {TRAJ_GRAD_MAX} "
          f"trajectories in waves of {wave}, on {card}")
    rng = np.random.default_rng(2110)
    circ, pv = param_trajectory_circuit(qt, n, rng)
    names = circ.param_names
    terms = [[(q, 3)] for q in range(n)]
    coeffs = list(rng.normal(size=n))
    env = qt.createQuESTEnv(seed=[7])
    tp = circ.compile_trajectories(env)
    kinds = [item[0] for item in tp._items]
    n_layers, n_fused = kinds.count("layer"), kinds.count("kraus_fused")
    print(f"  items: {kinds}")
    check(n_layers >= 1 and n_fused == 2 and kinds.count("u_fn") == 2 * n
          and len(names) == 2 * n,
          f"{n_layers} layers, {n_fused} fused channels and "
          f"{kinds.count('u_fn')} Param rotations on the path")
    hterms, hcoeffs = red.validated_pauli_terms(terms, coeffs, n)
    operands = red.pauli_terms_operands(hterms, hcoeffs, n)
    steps, mark = [], time.perf_counter()

    def step(name):
        nonlocal mark
        now = time.perf_counter()
        steps.append(f"{name} {now - mark:.1f}")
        mark = now

    # 1. the first two trajectories of the first wave (its uniforms, the
    # first wave's baseline 0) through the walk, every launch held against
    # its plain version on its own input (the Kraus kernel's index output
    # too); this also packs the adjoint layers before the timed run
    uniforms = tp._draw_uniforms(tp._generator(TRAJ_GRAD_SEED),
                                 (1, TRAJ_GRAD_MAX, tp.num_channels))[0]
    adjoint_ids = {id(op) for op in tp._adjoints().values()
                   if getattr(op, "kind", None) == "layer"}
    with HeldLayers(torch, lk, batched=True) as held_l, \
            HeldKraus(torch, kk) as held_k:
        _, rows, tape = tp._grad_rows(
            tp._start(None), uniforms[:2], np.repeat(pv[None], 2, 0),
            torch.zeros(2, device="cuda"), operands)
    layer_errs, kraus_errs = held_l.errs, held_k.errs
    rows = rows.cpu().numpy()
    draws = tape.draws
    del tape
    step("held walk")
    fwd = [e[1:] for e in layer_errs if e[0] not in adjoint_ids]
    back = [e[1:] for e in layer_errs if e[0] in adjoint_ids]
    held_err = max(e for e, _ in fwd + back)
    check(len(fwd) == len(back) == n_layers
          and max(r for _, r in fwd + back) <= 1e-5,
          f"each of {len(fwd)} forward and {len(back)} adjoint layers' "
          f"kernel output on its own input vs its plain version: max|diff| "
          f"/ max|plain| {max(r for _, r in fwd + back):.3e} <= 1e-5")
    kraus_err = max(e[0] for e in kraus_errs)
    check(len(kraus_errs) == 2 * n_fused and all(e[2] for e in kraus_errs)
          and max(e[1] for e in kraus_errs) <= 1e-5,
          f"{len(kraus_errs)} Kraus launches ({n_fused} forward with index "
          f"output, {n_fused} adjoint with one-hot probabilities) vs plain "
          f"on their own inputs: indices equal, max|diff| / max|plain| "
          f"{max(e[1] for e in kraus_errs):.3e} <= 1e-5")

    # 2. the gradient loop, counted and timed
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(lk, kk)
    t0 = time.perf_counter()
    val, grad, err = tp.expectation_grad(
        terms, coeffs, num_trajectories=TRAJ_GRAD_MAX, params=pv,
        wave_size=wave, seed=TRAJ_GRAD_SEED)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    step("gradient")
    peak = torch.cuda.max_memory_allocated()
    single, batched, kraus = counts(lk, kk)
    stats = tp.last_traj_stats
    check(stats["waves"] == waves and stats["kind"] == "gradient"
          and batched == 2 * n_layers * waves and kraus == 2 * n_fused * waves
          and single == 0 and fast_counts(lk) == (0, 0, 0),
          f"{waves} gradient waves: batched layer kernel launched {batched} "
          f"times ({n_layers} layers x {waves} forward + the same adjoint), "
          f"Kraus kernel {kraus} times ({n_fused} channels x {waves} forward "
          f"+ the same adjoint)")
    check(grad.shape == (len(names),) and err.shape == (len(names) + 1,)
          and bool(np.isfinite(grad).all()) and bool(np.isfinite(err).all()),
          f"<H> = {val:.6f}, {len(names)} finite gradient components, max|g| "
          f"{float(np.abs(grad).max()):.4e}, max stderr "
          f"{float(err[1:].max()):.4e}")

    reset_counts(lk, kk)
    t0 = time.perf_counter()
    mean, stderr = tp.expectation(terms, coeffs,
                                  num_trajectories=TRAJ_GRAD_MAX, params=pv,
                                  wave_size=wave, seed=TRAJ_GRAD_SEED)
    torch.cuda.synchronize()
    value_s = time.perf_counter() - t0
    step("value")
    _, v_batched, v_kraus = counts(lk, kk)
    check(val == mean and err[0] == stderr and v_batched == n_layers * waves
          and v_kraus == n_fused * waves,
          f"value column vs expectation at the same seed and wave size: "
          f"{val!r} == {mean!r}, stderr {err[0]!r} == {stderr!r} (bit for "
          f"bit); expectation launched {v_batched} layers, {v_kraus} Kraus")
    print(f"  expectation_grad {grad_s:.3f} s ({grad_s / waves:.3f} s a "
          f"wave), {TRAJ_GRAD_MAX / grad_s:.2f} trajectories/s; expectation "
          f"{value_s:.3f} s, {TRAJ_GRAD_MAX / value_s:.2f} trajectories/s; a "
          f"gradient wave costs {grad_s / value_s:.2f} value waves; peak "
          f"device memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated); on {card}")

    profile_device(torch, lambda: tp.expectation_grad(
        terms, coeffs, num_trajectories=TRAJ_GRAD_PROFILE,
        wave_size=TRAJ_GRAD_PROFILE, params=pv, seed=2),
        f"one {TRAJ_GRAD_PROFILE}-trajectory gradient wave", top=12,
        cpu=False)
    step("profile")

    # 3. two trajectories of the first wave against a central difference
    # of their fixed-branch objective, replayed at float64 on the card
    env64 = qt.createQuESTEnv(precision=qt.DOUBLE, seed=[7])
    tp64 = circ.compile_trajectories(env64)
    draws64 = {c: (j, p.double(), s.double()) for c, (j, p, s)
               in draws.items()}
    h = 1e-4
    cols = [names.index(c) for c in TRAJ_GRAD_COLUMNS]
    fd = np.zeros((2, len(cols)))
    for i, col in enumerate(cols):
        pm = np.repeat(pv[None], 4, 0)
        pm[:2, col] += h
        pm[2:, col] -= h
        f = traj_objective(torch, red, tp64, pm, {
            c: tuple(torch.cat([t, t]) for t in d)
            for c, d in draws64.items()}, operands, 0.0)
        fd[:, i] = (f[:2] - f[2:]) / (2 * h)
    gmax = float(np.abs(rows).max())
    fd_err = float(np.abs(rows[:, cols] - fd).max())
    check(fd_err <= 1e-3 * gmax,
          f"2 trajectories of the first wave, columns {TRAJ_GRAD_COLUMNS}, "
          f"vs a float64 central difference (h = {h:g}) of the "
          f"fixed-branch objective: max|diff| {fd_err:.3e} <= 1e-3 of "
          f"max|g| {gmax:.3e} ({fd_err / gmax:.3e})")
    del tp64
    torch.cuda.empty_cache()
    step("central difference")

    # 4. the card against the CPU on the same uniforms, at 12 qubits
    small, spv = param_trajectory_circuit(qt, 12, np.random.default_rng(12))
    tp_card = small.compile_trajectories(env)
    tp_cpu = small.compile_trajectories(qt.createQuESTEnv(
        device="cpu", precision=qt.SINGLE, seed=[7]))
    u = np.random.default_rng(3).uniform(size=(8, tp_card.num_channels))
    sterms = [[(q, 3)] for q in range(12)] + [[(0, 1), (5, 1)]]
    scoeffs = list(np.random.default_rng(4).normal(size=len(sterms)))
    got = tp_card.expectation_grad(sterms, scoeffs, num_trajectories=8,
                                   params=spv, wave_size=8, uniforms=u)
    want = tp_cpu.expectation_grad(sterms, scoeffs, num_trajectories=8,
                                   params=spv, wave_size=8, uniforms=u)
    smax = float(np.abs(want[1]).max())
    cpu_err = float(np.abs(got[1] - want[1]).max())
    check(cpu_err <= 1e-4 * smax and abs(got[0] - want[0]) <= 1e-4,
          f"12-qubit copy, 8 trajectories, same uniforms, card vs CPU: "
          f"gradients max|diff| {cpu_err:.3e} <= 1e-4 of max|g| {smax:.3e}; "
          f"<H> {got[0]:.6f} vs {want[0]:.6f}")
    step("card vs CPU")

    # 5. the Kraus kernel's two new uses at a wave's shapes: the index
    # output on the path's probabilities, and the adjoint step (the stack
    # of K^dag, one-hot probabilities) against its plain version; then the
    # index output at the edge draws, float32 and float64
    states = tp.trajectory_sweep(wave, params=pv)
    k_fused = next(k for k, item in enumerate(tp._items)
                   if item[0] == "kraus_fused")
    _, targets, (_, estack, kemb), _ = tp._items[k_fused]
    probs = tp._channel_probs(states, targets, torch.as_tensor(
        estack, dtype=torch.complex64, device="cuda"))
    u01 = torch.rand(wave, dtype=torch.float32, device="cuda")
    index = torch.empty(wave, dtype=torch.int32, device="cuda")
    j_plain, _ = kk.draw_plain(probs, u01)
    kk.fused_kraus_apply_batched(states.clone(), n, kemb, probs, u01, index)
    onehot = torch.zeros_like(probs).scatter_(
        1, j_plain[:, None], probs.gather(1, j_plain[:, None]))
    zeros = torch.zeros_like(u01)
    kdag = tp._adjoints()[k_fused]
    a = kk.fused_kraus_apply_batched(states.clone(), n, kdag, onehot, zeros)
    b = kk.fused_kraus_apply_batched_plain(states.clone(), n, kdag, onehot,
                                           zeros)
    torch.cuda.synchronize()
    adj_err, adj_rel = rel_err(a, b)
    del a, b
    torch.cuda.empty_cache()
    kraus_err = max(kraus_err, adj_err)
    check(torch.equal(index.long(), j_plain) and adj_rel <= 1e-5,
          f"Kraus kernel over {wave} trajectories of the path: index output "
          f"equals draw_plain's; the adjoint step (K^dag, one-hot) vs plain "
          f"max|diff| {adj_err:.3e}, / max|plain| {adj_rel:.3e} <= 1e-5")
    for dtype in (torch.float32, torch.float64):
        for num_ops in (2, 4, 16, 64):
            kemb, probs_np, u_np = kraus_case(rng, 8, num_ops)
            probs = torch.as_tensor(probs_np, dtype=dtype, device="cuda")
            u01 = torch.as_tensor(u_np, dtype=dtype, device="cuda")
            base = random_batch(torch, rng, 8, CHECK_QUBITS, dtype, "cuda")
            index = torch.full((8,), -1, dtype=torch.int32, device="cuda")
            kk.fused_kraus_apply_batched(base, CHECK_QUBITS, kemb, probs,
                                         u01, index)
            j_plain, _ = kk.draw_plain(probs, u01)
            check(torch.equal(index.long(), j_plain),
                  f"Kraus index output, K = {num_ops:2d} {str(dtype):14s}: "
                  f"{index.tolist()} equals draw_plain's")

    step("Kraus index and adjoint")

    # 6. the adjoint layers' times over the stacked 2T states
    stacked = torch.cat([states, states])
    del states
    adjoints = [tp._adjoints()[k] for k, item in enumerate(tp._items)
                if item[0] == "layer"]
    rows_t = batched_layer_times(torch, lk, stacked, n, adjoints,
                                 f"trajectory adjoint (2T = {2 * wave})")
    del stacked
    torch.cuda.empty_cache()
    step("adjoint layer times")
    print(f"  phase 9g seconds by step: {', '.join(steps)}")
    return {"launches_layer": batched, "launches_kraus": kraus,
            "rows": rows_t, "max_abs_err": held_err,
            "kraus_max_abs_err": kraus_err, "seconds": grad_s,
            "traj_per_s": TRAJ_GRAD_MAX / grad_s,
            "value_traj_per_s": TRAJ_GRAD_MAX / value_s,
            "cost_in_value_waves": grad_s / value_s, "peak_bytes": peak,
            "fd_rel": fd_err / gmax, "cpu_rel": cpu_err / smax}


def timed_runs(torch, fn, reps: int = 2) -> float:
    """Host seconds per synchronised call of fn, over reps warm calls."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def phase_fast_main(torch, qt, lk, kk, card):
    n = MAIN_QUBITS
    print(f"phase 10: the FAST tier on the main path, {n} qubits, "
          f"{MAIN_LAYERS}-layer brickwork, on {card}")
    env = qt.createQuESTEnv()
    gates = brickwork(n, MAIN_LAYERS)
    circ = as_circuit(qt, n, gates)
    t0 = time.perf_counter()
    cc = circ.compile(env, tier="fast")
    compile_s = time.perf_counter() - t0
    by_budget = circ.compile(env, error_budget=FAST_BUDGET)
    check(cc.tier.name == "fast" and by_budget.tier.name == "fast",
          f"tier='fast' and error_budget={FAST_BUDGET} both compile at "
          f"{by_budget.tier.name}")
    del by_budget
    layer_ops = [op for op in cc._ops if op.kind == "layer"]
    n_mxu = sum(st[0] == "rowmxu" for op in layer_ops for st in op.stages)
    print(f"  compiled {len(gates)} gates into {len(cc.plan.items)} ops "
          f"({len(layer_ops)} layers, {n_mxu} rowmxu stages) in "
          f"{compile_s:.2f} s")
    check(layer_ops and n_mxu > 0, f"{n_mxu} rowmxu stages on the FAST "
          "path")

    q = qt.createQureg(n, env)
    qt.initZeroState(q)
    reset_counts(lk, kk)
    cc.run(q)
    torch.cuda.synchronize()
    fast = fast_counts(lk)
    check(fast == (len(layer_ops), 0, 0) and counts(lk, kk) == (0, 0, 0),
          f"FAST layer kernel launched {fast[0]} times for "
          f"{len(layer_ops)} layer ops, no full-precision launch")

    single = circ.compile(env)
    q2 = qt.createQureg(n, env)
    qt.initZeroState(q2)
    single.run(q2)
    torch.cuda.synchronize()
    dev, dev_rel = rel_err(q.state, q2.state)
    bound = qt.modeled_tier_error(qt.FAST_TIER, len(gates))
    check(0.0 < dev_rel <= bound,
          f"FAST vs SINGLE final state: max|diff| {dev:.3e}, / max|amp| "
          f"{dev_rel:.3e} (0 < it <= modeled {bound:.3e})")
    fast_s = timed_runs(torch, lambda: cc.run(q))
    single_s = timed_runs(torch, lambda: single.run(q2))
    print(f"  compiled run: FAST {fast_s * 1e3:.1f} ms "
          f"({len(gates) / fast_s:.1f} gates/s), SINGLE "
          f"{single_s * 1e3:.1f} ms ({len(gates) / single_s:.1f} gates/s)")
    del q2, single
    torch.cuda.empty_cache()

    planes = q.state
    lib = bf16_lane_ms(torch, planes.unsqueeze(0))
    torch.cuda.empty_cache()
    stage_lib = {}
    rows = []
    for i, layer in enumerate(layer_ops):
        a = planes.clone()
        lk.apply_layer(a, n, layer, fast=True)
        b = lk.apply_layer_plain(planes.clone(), n, layer, fast=True)
        torch.cuda.synchronize()
        err, rel = rel_err(a, b)
        del a, b
        torch.cuda.empty_cache()
        check(rel <= 1e-5, f"FAST layer {i}: kernel vs plain max|diff| "
              f"{err:.3e}, / max|plain| {rel:.3e} <= 1e-5")
        ms = cuda_ms(torch, lambda: lk.apply_layer(planes, n, layer,
                                                   fast=True), reps=3)
        plain = cuda_ms(torch, lambda: lk.apply_layer_plain(
            planes, n, layer, fast=True), reps=1)
        torch.cuda.empty_cache()
        b_ms, by, hbm, ops = layer_bound_ms(lk, layer, n, torch.float32,
                                            fast=True)
        dim = max(128 << (len(st[1]) if st[0] == "rowmxu" else 0)
                  for st in layer.stages
                  if st[0] in ("lane", "clane", "rowmxu"))
        if dim not in stage_lib:
            stage_lib[dim] = bf16_stage_ms(torch, 1 << n, dim)
        wide, scaled = stage_lib[dim]
        print(f"  FAST layer {i}: {[st[0] for st in layer.stages]}")
        print(f"    kernel {ms:.3f} ms, bound {b_ms:.3f} ms ({by}; HBM "
              f"{hbm:.3f} ms, bf16 tensor-core + peak flops "
              f"{ops:.3f} ms), plain {plain:.3f} ms, torch.matmul bf16 "
              f"stacked real lane product {lib:.3f} ms, widest dense stage "
              f"(dim {dim}) stacked real hi/lo {wide:.3f} ms"
              f"{' (a quarter of the rows, x4)' if scaled else ''}")
        rows.append((ms, b_ms, by, plain, wide, err))
    by = [r[2] for r in rows]
    return {
        "name": "layer_kernel_fast",
        "route": "cuda",
        "source": "quest_tpu_torch/csrc/layer_kernel.cu",
        "replaces": "quest_tpu/ops/pallas_kernels.py:339",
        "launches": fast[0],
        "max_abs_err": max(r[5] for r in rows),
        "ms": float(np.mean([r[0] for r in rows])),
        "plain_ms": float(np.mean([r[3] for r in rows])),
        "bound_ms": float(np.mean([r[1] for r in rows])),
        "bound_by": max(set(by), key=by.count),
        "library_ms": float(np.mean([r[4] for r in rows])),
        "layer_ms": [r[0] for r in rows],
        "layer_bound_ms": [r[1] for r in rows],
        "layer_library_ms": [r[4] for r in rows],
        "lane_library_ms": lib,
        "qubits": n,
        "rowmxu_stages": n_mxu,
        "gates_per_s": len(gates) / fast_s,
        "single_gates_per_s": len(gates) / single_s,
    }


def phase_fast_sweep(torch, qt, lk, kk, card):
    from quest_tpu_torch.ops import reductions as red
    n, batch = SWEEP_QUBITS, FAST_SWEEP_BATCH
    print(f"phase 11: tiers in the batched engine, {n}-qubit "
          f"{SWEEP_LAYERS}-layer HEA, batch {batch}, {SWEEP_TERMS}-term "
          f"Pauli sum, on {card}")
    circ, terms, coeffs, _, pm = hea_problem(qt)
    pm = pm[:batch]
    env = qt.createQuESTEnv(seed=[2026])
    cc = circ.compile(env)
    n_fast = sum(op.kind == "layer" for op in cc._plan_for(qt.FAST_TIER)[1])
    ham = (terms, coeffs)
    energies, secs = {}, {}
    for tier in ("fast", "single"):
        reset_counts(lk, kk)
        t0 = time.perf_counter()
        energies[tier] = cc.expectation_sweep(pm, ham, tier=tier)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launched = (fast_counts(lk), counts(lk, kk))
        if tier == "fast":
            fast_launches = launched[0][1]
            want = ((0, n_fast, 0), (0, 0, 0))
        else:
            want = ((0, 0, 0), (0, cc.num_layers, 0))
        check(launched == want and energies[tier].shape == (batch,)
              and bool(np.isfinite(energies[tier]).all()),
              f"tier {tier}: (FAST, MXU tile) and full-precision launches "
              f"{launched} for its layers; first call {first_s * 1e3:.1f} "
              f"ms")
        secs[tier] = timed_runs(
            torch, lambda: cc.expectation_sweep(pm, ham, tier=tier), reps=1)
        print(f"  tier {tier}: {secs[tier] * 1e3:.1f} ms per sweep, "
              f"{batch / secs[tier]:.2f} points/s")
    ef, es = energies["fast"], energies["single"]
    d_rel = float(np.abs(ef - es).max() / np.abs(es).max())
    bound = qt.modeled_tier_error(qt.FAST_TIER, len(circ.ops))
    check(d_rel <= bound, f"FAST vs SINGLE energies: max|dE| / max|E| "
          f"{d_rel:.3e} <= modeled {bound:.3e}")

    # SINGLE's compensated energies against a float64 host reduction of
    # the same states
    states4 = cc.sweep(pm[:4], tier="single")
    e4 = cc.expectation_sweep(pm[:4], ham, tier="single")
    xm, ym, zm, cf = cc._pauli_operands(ham)
    host = red.pauli_sum_total_sv(states4.double().cpu(), xm, ym, zm,
                                  cf).numpy()
    naive = red.pauli_sum_total_sv(states4, xm, ym, zm, cf).cpu().numpy()
    c_rel = float(np.abs(e4 - host).max() / np.abs(host).max())
    n_rel = float(np.abs(naive - host).max() / np.abs(host).max())
    check(c_rel <= 1e-6, f"SINGLE compensated energies vs float64 host "
          f"reduction, 4 points: max|dE| / max|E| {c_rel:.3e} <= 1e-6 "
          f"(naive float32 reduce: {n_rel:.3e})")
    del states4

    states = cc.sweep(pm, tier="fast")
    fast_layers = [op for op in cc._plan_for(qt.FAST_TIER)[1]
                   if op.kind == "layer"]
    rows = batched_layer_times(torch, lk, states, n, fast_layers,
                               "FAST sweep", fast=True)
    del states
    torch.cuda.empty_cache()
    by = [r[2] for r in rows]
    return {
        "name": "layer_kernel_batched_fast",
        "route": "cuda",
        "source": "quest_tpu_torch/csrc/layer_kernel.cu",
        "replaces": "quest_tpu/ops/pallas_kernels.py:768",
        "launches": fast_launches,
        "max_abs_err": max(r[5] for r in rows),
        "ms": float(np.mean([r[0] for r in rows])),
        "plain_ms": float(np.mean([r[3] for r in rows])),
        "bound_ms": float(np.mean([r[1] for r in rows])),
        "bound_by": max(set(by), key=by.count),
        "library_ms": rows[0][4],
        "points_per_s_fast": batch / secs["fast"],
        "points_per_s_single": batch / secs["single"],
    }


DENSITY_QUBITS = 15            # BASELINE.json config 4: 2^30 flat amps
DENSITY_CHECK_QUBITS = 8


class _Recorder:
    """Stands in for a Circuit under ``algorithms._append_qft``: each gate
    goes to the circuit and, as the same imperative density-API call, to
    ``calls``."""

    def __init__(self, qt, circuit):
        self.qt, self.circuit, self.calls = qt, circuit, []

    def h(self, a):
        self.circuit.h(a)
        self.calls.append((self.qt.hadamard, (a,)))

    def swap(self, a, b):
        self.circuit.swap(a, b)
        self.calls.append((self.qt.swapGate, (a, b)))

    def cphase(self, a, b, angle):
        self.circuit.cphase(a, b, angle)
        self.calls.append((self.qt.controlledPhaseShift, (a, b, angle)))


def noisy_qft(qt, n: int):
    """The noisy QFT: the QFT ladder (``algorithms._append_qft``), then
    dephasing (0.01) and amplitude damping (0.005) on every qubit. Returns
    the circuit and the same program as imperative density-API calls."""
    from quest_tpu_torch.algorithms import _append_qft
    c = qt.Circuit(n)
    rec = _Recorder(qt, c)
    _append_qft(rec, range(n))
    calls = rec.calls
    for q in range(n):
        c.dephase(q, 0.01).damp(q, 0.005)
        calls += [(qt.mixDephasing, (q, 0.01)), (qt.mixDamping, (q, 0.005))]
    return c, calls


def density_noise(qt, n: int, params: bool = False):
    """bench.py:3514 ``bench_density_noise`` (BASELINE.json config 4): a
    random rotation on every qubit (rng 2026), CNOTs on (0,1), (2,3), ...,
    then dephasing (0.05) and damping (0.02) on every qubit. Returns the
    circuit, the imperative calls and the angles; with ``params`` each
    rotation's angle is a Param ``r<q>`` (the angles its binding)."""
    rng = np.random.default_rng(2026)
    c = qt.Circuit(n)
    calls, angles = [], []
    for q in range(n):
        angle, axis = float(rng.uniform(0, 2 * np.pi)), rng.normal(size=3)
        c.rotate(q, c.parameter(f"r{q}") if params else angle, axis)
        calls.append((qt.rotateAroundAxis, (q, angle, tuple(axis))))
        angles.append(angle)
    for q in range(0, n - 1, 2):
        c.cnot(q, q + 1)
        calls.append((qt.controlledNot, (q, q + 1)))
    for q in range(n):
        c.dephase(q, 0.05).damp(q, 0.02)
        calls += [(qt.mixDephasing, (q, 0.05)), (qt.mixDamping, (q, 0.02))]
    return c, calls, np.asarray(angles)


def diagonal_layer_factor(torch, lk, layer, n: int, dtype):
    """A layer of ``rowdiag`` stages as one diagonal: (its row bits
    ascending, the complex64 factor ``(2^u, 128)`` over their
    configurations and the lanes, on the card), or None when a stage is
    not diagonal."""
    kstages, _, tables, _, _, _ = lk.layer_kernel_plan(
        layer, n, lk.tile_rows_for(dtype))
    if any(st[0] != "rowdiag" for st in kstages):
        return None
    bits = sorted({b for st in kstages for b in st[2]})
    cfg = np.arange(1 << len(bits))
    fac = np.ones((1 << len(bits), lk.LANES), dtype=np.complex128)
    for _, toff, sbits in kstages:
        sub = np.zeros_like(cfg)
        for j, b in enumerate(sbits):
            sub |= ((cfg >> bits.index(b)) & 1) << j
        fac *= np.stack(tables[toff:toff + (1 << len(sbits))])[sub]
    return bits, torch.as_tensor(fac, dtype=torch.complex64, device="cuda")


def diagonal_views(z, fac, bits, lanes: int):
    """``z`` (complex, ``rows * lanes``) and ``fac`` (``(2^u, lanes)``)
    viewed so that ``z * fac`` broadcasts the diagonal over the rows."""
    zs, fs, prev = [], [], (z.numel() // lanes).bit_length() - 1
    for b in reversed(bits):
        zs += [1 << (prev - b - 1), 2]
        fs += [1, 2]
        prev = b
    return z.view(zs + [1 << prev, lanes]), fac.view(fs + [1, lanes])


def density_cell(torch, qt, lk, kk, card, label, circuit, calls, init,
                 expect_layers: bool):
    """One density cell at DENSITY_QUBITS: compile with density=True, run
    from ``init(qureg)`` with the kernel counts from 0, and hold the result
    against
    the same program through the imperative density API; with
    ``expect_layers`` also each layer's kernel output against its plain
    version on that layer's own input. Returns the cell's numbers."""
    n = DENSITY_QUBITS
    env = qt.createQuESTEnv()
    t0 = time.perf_counter()
    cc = circuit.compile(env, density=True)
    compile_s = time.perf_counter() - t0
    layer_ops = [op for op in cc._ops if op.kind == "layer"]
    plain_ops = len(cc.plan.items) - len(layer_ops)
    print(f"  {label}: {len(circuit.ops)} ops, lifted to "
          f"{2 * n} qubits, planned as {len(layer_ops)} layers and "
          f"{plain_ops} plain ops in {compile_s:.2f} s; stages "
          f"{sorted({st[0] for op in layer_ops for st in op.stages})}")
    q = qt.createDensityQureg(n, env)
    init(q)
    reset_counts(lk, kk)
    cc.run(q)
    torch.cuda.synchronize()
    launches, batched, kraus = counts(lk, kk)
    diag_launches = lk.apply_layer.diag_launches
    diagonal = sum(lk.is_diagonal_layer(op) for op in layer_ops)
    if expect_layers:
        check(len(layer_ops) > 0 and launches == len(layer_ops)
              and diag_launches == diagonal and batched == kraus == 0,
              f"{label}: layer kernel launched {launches} times for "
              f"{len(layer_ops)} layer ops, {diag_launches} of them through "
              f"the streaming entry for {diagonal} rowdiag-only layers")
    else:
        print(f"  {label}: layer kernel launched {launches} times for "
              f"{len(layer_ops)} layer ops (no count asserted)")
    errs, rels = [], []
    if layer_ops:
        # a second run with each layer held against its plain version on
        # that layer's own input, by a hook on the executor's kernel call
        launch = lk.apply_layer

        def held(planes, num_qubits, layer, fast=False):
            plain = planes.clone()
            launch(planes, num_qubits, layer, fast=fast)
            lk.apply_layer_plain(plain, num_qubits, layer, fast=fast)
            torch.cuda.synchronize()
            err, rel = rel_err(planes, plain)
            errs.append(err)
            rels.append(rel)

        walked = qt.createDensityQureg(n, env)
        init(walked)
        # the wrapper counts through its module-level name, so while the
        # hook stands in, the hook holds these launches' counts
        held.launches = held.fast_launches = held.diag_launches = 0
        lk.apply_layer = held
        try:
            cc.run(walked)
        finally:
            lk.apply_layer = launch
        del walked
        torch.cuda.empty_cache()
        check(len(rels) == len(layer_ops) and max(rels) <= 1e-5,
              f"{label}: each of {len(rels)} layers' kernel vs plain version "
              f"on its own input max|diff| / max|plain| {max(rels):.3e} "
              "<= 1e-5")

    ref = qt.createDensityQureg(n, env)
    init(ref)
    t0 = time.perf_counter()
    for fn, args in calls:
        fn(ref, *args)
    torch.cuda.synchronize()
    api_s = time.perf_counter() - t0
    err, rel = rel_err(q.state, ref.state)
    del ref
    torch.cuda.empty_cache()
    check(rel <= 1e-4, f"{label}: compiled vs imperative density API "
          f"max|diff| / max|amp| {rel:.3e} <= 1e-4")
    trace, purity = qt.calcTotalProb(q), qt.calcPurity(q)
    check(abs(trace - 1.0) <= 1e-4 and 0.0 < purity <= 1.0,
          f"{label}: trace {trace!r}, purity {purity!r}")

    run_s = timed_runs(torch, lambda: cc.run(q), reps=2)
    ops = len(circuit.ops)
    print(f"  {label} on {card}: compiled run {run_s * 1e3:.1f} ms, "
          f"{ops / run_s:.1f} ops/s ({ops} ops as bench.py:3514 counts "
          f"them); the imperative API {api_s * 1e3:.1f} ms, "
          f"{ops / api_s:.1f} ops/s")
    kernel_ms, plain_ms, bound_ms, bound_by, lib_ms = [], [], [], [], []
    for i, layer in enumerate(layer_ops):
        # the library yardstick of a diagonal layer: one complex64
        # broadcast multiply of the register by the layer's merged factor,
        # first held against the plain version on the same input
        lib = diagonal_layer_factor(torch, lk, layer, 2 * n, q.state.dtype)
        if lib is not None:
            z = torch.complex(q.state[0], q.state[1])
            zv, fv = diagonal_views(z, lib[1], lib[0], lk.LANES)
            want = q.state.clone()
            lk.apply_layer_plain(want, 2 * n, layer)
            got = torch.view_as_real(zv * fv).view(-1, 2)
            err = max(float((got[:, k] - want[k]).abs().max())
                      for k in (0, 1))
            rel = err / float(want.abs().max())
            del got, want
            check(rel <= 1e-5, f"{label}: layer {i} as one broadcast "
                  f"multiply vs its plain version max|diff| / max|plain| "
                  f"{rel:.3e} <= 1e-5")
            lib_ms.append(cuda_ms(torch, lambda: zv.mul_(fv), reps=3))
            del z, zv
            torch.cuda.empty_cache()
        kernel_ms.append(cuda_ms(torch, lambda: lk.apply_layer(
            q.state, 2 * n, layer), reps=3))
        plain_ms.append(cuda_ms(torch, lambda: lk.apply_layer_plain(
            q.state, 2 * n, layer), reps=1))
        ms, by, hbm_ms, op_ms = layer_bound_ms(lk, layer, 2 * n,
                                               q.state.dtype)
        bound_ms.append(ms)
        bound_by.append(by)
        print(f"  layer {i} {[st[0] for st in layer.stages]}: kernel "
              f"{kernel_ms[-1]:.3f} ms, bound {ms:.3f} ms ({by}; HBM "
              f"{hbm_ms:.3f}, flops at peak {op_ms:.3f}), plain "
              f"{plain_ms[-1]:.3f} ms, complex64 broadcast mul "
              + (f"{lib_ms[-1]:.3f} ms (kernel / mul "
                 f"{kernel_ms[-1] / lib_ms[-1]:.2f}x)" if lib is not None
                 else "none")
              + f", max|kernel-plain| {errs[i]:.3e} on {card}")
    torch.cuda.empty_cache()
    profile_device(torch, lambda: cc.run(q), f"one {label} run on {card}")
    del q, cc
    torch.cuda.empty_cache()
    return {"launches": launches, "diag_launches": diag_launches,
            "ops_per_s": ops / run_s,
            "max_abs_err": max(errs or [0.0]), "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms if len(lib_ms) == len(layer_ops) else None}


def density_fast(torch, qt, lk, kk, card, label, circuit, init,
                 single_cell):
    """12e: the noisy QFT of 12a compiled with ``density=True`` at
    ``tier="fast"``: one FAST launch per layer of its lifted plan, each
    FAST layer's kernel output on its own input within 1e-5 of max|plain|
    of its FAST plain version, the result against the SINGLE program's
    within ``modeled_tier_error(FAST, ops)`` of max|amp|, and FAST ops/s
    beside SINGLE's (12a's)."""
    n = DENSITY_QUBITS
    env = qt.createQuESTEnv()
    cc = circuit.compile(env, density=True, tier="fast")
    layer_ops = [op for op in cc._ops if op.kind == "layer"]
    q = qt.createDensityQureg(n, env)
    init(q)
    reset_counts(lk, kk)
    cc.run(q)
    torch.cuda.synchronize()
    fast_launches, full = lk.apply_layer.fast_launches, lk.apply_layer.launches
    check(len(layer_ops) > 0 and fast_launches == len(layer_ops)
          and full == 0,
          f"{label}: FAST kernel launched {fast_launches} times for "
          f"{len(layer_ops)} layer ops ({full} full-precision launches)")
    errs, rels = [], []
    launch = lk.apply_layer

    def held(planes, num_qubits, layer, fast=False):
        plain = planes.clone()
        launch(planes, num_qubits, layer, fast=fast)
        lk.apply_layer_plain(plain, num_qubits, layer, fast=fast)
        torch.cuda.synchronize()
        err, rel = rel_err(planes, plain)
        errs.append(err)
        rels.append(rel)

    walked = qt.createDensityQureg(n, env)
    init(walked)
    held.launches = held.fast_launches = held.diag_launches = 0
    lk.apply_layer = held
    try:
        cc.run(walked)
    finally:
        lk.apply_layer = launch
    del walked
    torch.cuda.empty_cache()
    check(len(rels) == len(layer_ops) and max(rels) <= 1e-5,
          f"{label}: each of {len(rels)} FAST layers' kernel vs its FAST "
          f"plain version on its own input max|diff| / max|plain| "
          f"{max(rels):.3e} <= 1e-5")
    ref = qt.createDensityQureg(n, env)
    init(ref)
    circuit.compile(env, density=True, tier="single").run(ref)
    ops = len(circuit.ops)
    bound = qt.modeled_tier_error(qt.FAST_TIER, len(cc.circuit.ops))
    _, rel = rel_err(q.state, ref.state)
    del ref
    torch.cuda.empty_cache()
    check(rel <= bound, f"{label}: FAST vs SINGLE max|diff| / max|amp| "
          f"{rel:.3e} <= modeled_tier_error(FAST, "
          f"{len(cc.circuit.ops)}) = {bound:.3e}")
    trace = qt.calcTotalProb(q)
    check(abs(trace - 1.0) <= 1e-3, f"{label}: FAST trace {trace!r}")
    run_s = timed_runs(torch, lambda: cc.run(q), reps=2)
    print(f"  {label} on {card}: FAST compiled run {run_s * 1e3:.1f} ms, "
          f"{ops / run_s:.1f} ops/s beside SINGLE's "
          f"{single_cell['ops_per_s']:.1f} ops/s (12a)")
    del q, cc
    torch.cuda.empty_cache()
    return {"fast_launches": fast_launches, "ops_per_s": ops / run_s,
            "max_abs_err": max(errs), "fast_vs_single": rel,
            "bound": bound}


def kraus_set(rng, k: int, count: int):
    """A random CPTP set of ``count`` operators on k qubits."""
    d = 1 << k
    v = random_unitary(rng, d * count)[:, :d]
    return [v[i * d:(i + 1) * d] for i in range(count)]


def density_flow(qt, env, outcome=None):
    """Every density function of the API on 8 qubits: initialisers, gates,
    every channel, every calc, the density amplitudes, and a measurement
    (``measureWithStats`` when ``outcome`` is None, else
    ``collapseToOutcome`` to it). Returns (values, flat state, outcome)."""
    n = DENSITY_CHECK_QUBITS
    rng = np.random.default_rng(88)
    vals = []
    pure = qt.createQureg(n, env)
    for q in range(n):
        qt.rotateY(pure, q, 0.3 * q + 0.1)
        qt.rotateX(pure, q, 0.17 * q + 0.05)  # complex amplitudes
    qt.controlledNot(pure, 0, 1)
    rho = qt.createDensityQureg(n, env)
    qt.initPureState(rho, pure)
    qt.hadamard(rho, 0)
    qt.controlledNot(rho, 0, 7)
    qt.controlledPhaseShift(rho, 1, 6, 0.4)
    qt.swapGate(rho, 2, 5)
    qt.rotateX(rho, 3, 0.7)
    qt.multiRotatePauli(rho, (0, 3, 7), (1, 2, 3), 0.37)
    qt.multiRotateZ(rho, (1, 4), 0.8)
    qt.multiQubitUnitary(rho, (6, 2), random_unitary(rng, 4))
    qt.mixDephasing(rho, 0, 0.1)
    qt.mixTwoQubitDephasing(rho, 1, 2, 0.2)
    qt.mixDepolarising(rho, 3, 0.15)
    qt.mixDamping(rho, 4, 0.3)
    qt.mixTwoQubitDepolarising(rho, 5, 6, 0.25)
    qt.mixPauli(rho, 7, 0.05, 0.1, 0.02)
    qt.mixKrausMap(rho, 1, kraus_set(rng, 1, 3))
    qt.mixTwoQubitKrausMap(rho, 0, 7, kraus_set(rng, 2, 4))
    qt.mixMultiQubitKrausMap(rho, (2, 4, 6), kraus_set(rng, 3, 2))
    other = qt.createDensityQureg(n, env)
    qt.initClassicalState(other, 37)
    qt.hadamard(other, 2)
    qt.mixDensityMatrix(rho, 0.25, other)
    codes = rng.integers(0, 4, size=3 * n)
    vals += [qt.calcTotalProb(rho), qt.calcPurity(rho),
             qt.calcFidelity(rho, pure),
             qt.calcHilbertSchmidtDistance(rho, other),
             qt.calcDensityInnerProduct(rho, other),
             qt.calcExpecPauliProd(rho, (0, 3, 7), (1, 2, 3)),
             qt.calcExpecPauliSum(rho, codes, (0.5, -0.3, 0.8)),
             qt.calcExpecPauliProd(pure, (1, 2), (2, 3))]
    vals += [qt.calcProbOfOutcome(rho, q, 0) for q in range(n)]
    for r, c in ((0, 0), (3, 5), (200, 17), (255, 255)):
        z = qt.getDensityAmp(rho, r, c)
        vals += [z.real, z.imag]
    third = qt.createDensityQureg(n, env)
    host = rng.normal(size=(2, 1 << (2 * n))) / (1 << n)
    qt.setDensityAmps(third, host[0], host[1])
    vals += [qt.calcPurity(third), qt.getDensityAmp(third, 3, 5).imag]
    if outcome is None:
        outcome, prob = qt.measureWithStats(rho, 2)
    else:
        prob = qt.collapseToOutcome(rho, 2, outcome)
    vals += [prob, qt.calcTotalProb(rho)]
    return np.array(vals), rho.to_numpy(), outcome


def phase_density(torch, qt, lk, kk, card):
    n = DENSITY_QUBITS
    print(f"phase 12: density registers, {n} qubits (2^{2 * n} flat "
          f"amplitudes, complex64), on {card}")
    # the QFT of a basis state: every qubit ends in a superposition the
    # noise then degrades (from |+><+| it would end in |0><0|, which the
    # channels leave alone)
    qft, qft_calls = noisy_qft(qt, n)
    basis = 0b101100111000101 & ((1 << n) - 1)
    cell = density_cell(torch, qt, lk, kk, card, "12a noisy QFT", qft,
                        qft_calls, lambda q: qt.initClassicalState(q, basis),
                        expect_layers=True)
    fast = density_fast(torch, qt, lk, kk, card, "12e noisy QFT at FAST",
                        qft, lambda q: qt.initClassicalState(q, basis), cell)
    config4, config4_calls, _ = density_noise(qt, n)
    cell_b = density_cell(torch, qt, lk, kk, card,
                          "12b BASELINE.json config 4", config4,
                          config4_calls, qt.initPlusState,
                          expect_layers=False)
    print(f"  12c: every density function, {DENSITY_CHECK_QUBITS} qubits, "
          "the card (complex64) against the CPU (complex128)")
    got, got_state, outcome = density_flow(qt, qt.createQuESTEnv(seed=[5]))
    want, want_state, _ = density_flow(
        qt, qt.createQuESTEnv(device="cpu", precision=qt.DOUBLE), outcome)
    err = float(np.abs(got - want).max() / np.abs(want).max())
    state_err = float(np.abs(got_state - want_state).max()
                      / np.abs(want_state).max())
    check(err <= 1e-5 and state_err <= 1e-5,
          f"12c: {len(got)} values max|card - CPU| / max|CPU| {err:.3e}, "
          f"final state {state_err:.3e} <= 1e-5 (measured q2 -> {outcome})")
    return {"qft": cell, "config4": cell_b, "qft_fast": fast}


def held_layers(torch, lk, errs, batched: bool = True):
    """A stand-in for ``lk.apply_layer_batched`` (``batched``) or
    ``lk.apply_layer`` that launches the kernel and holds its output
    against the plain version on the same input, appending ``(id(layer),
    max|diff|, max|diff| / max|plain|)`` to ``errs``. Returns ``(the
    wrapper, the stand-in)``; the wrapper counts through its module-level
    name, so while the stand-in stands in, it holds these launches'
    counts."""
    launch = lk.apply_layer_batched if batched else lk.apply_layer
    plain_fn = lk.apply_layer_batched_plain if batched \
        else lk.apply_layer_plain

    def held(states, num_qubits, layer, fast=False):
        plain = plain_fn(states.clone(), num_qubits, layer, fast)
        launch(states, num_qubits, layer, fast=fast)
        torch.cuda.synchronize()
        errs.append((id(layer),) + rel_err(states, plain))
        del plain
        return states

    held.launches = held.fast_launches = held.diag_launches = 0
    return launch, held


def walk_held(torch, lk, cc, run):
    """Run ``run()`` (a gradient sweep of ``cc``) with every batched
    layer launch held against its plain version on its own input.
    Returns the (max|diff|, relative) pairs of the forward layers and of
    the adjoint layers of the walk."""
    adjoint_ids = {id(a) for a in cc._adjoint_walk(None).adjoints.values()}
    with HeldLayers(torch, lk, batched=True) as held:
        run()
    return ([e[1:] for e in held.errs if e[0] not in adjoint_ids],
            [e[1:] for e in held.errs if e[0] in adjoint_ids])


def shift_oracle(cc, pm, ham, rows, cols, chunk):
    """Parameter-shift gradients of ``cc``'s rows ``rows`` in columns
    ``cols`` (exact for rotation parameters), from shifted
    ``expectation_sweep`` batches of at most ``chunk`` rows."""
    shifted = []
    for r in rows:
        for c in cols:
            for s in (np.pi / 2, -np.pi / 2):
                row = pm[r].copy()
                row[c] += s
                shifted.append(row)
    shifted = np.stack(shifted)
    e = np.concatenate([cc.expectation_sweep(shifted[i:i + chunk], ham)
                        for i in range(0, len(shifted), chunk)])
    return 0.5 * (e[0::2] - e[1::2]).reshape(len(rows), len(cols))


def phase_grad(torch, qt, lk, kk, card):
    """Phase 13: value_and_grad_sweep on the HEA cell's circuit."""
    n, batch = SWEEP_QUBITS, GRAD_BATCH
    print(f"phase 13: gradient sweep (adjoint walk), {n}-qubit "
          f"{SWEEP_LAYERS}-layer HEA, complex64, batch {batch}, "
          f"{SWEEP_TERMS}-term Pauli sum, on {card}")
    circ, terms, coeffs, _, pm = hea_problem(qt)
    pm = pm[:batch]
    ham = (terms, coeffs)
    names = circ.param_names
    env = qt.createQuESTEnv(seed=[2026])
    cc = circ.compile(env)
    layers = cc.num_layers

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(lk, kk)
    t0 = time.perf_counter()
    vals, grads = cc.value_and_grad_sweep(pm, ham)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    single, batched, kraus = counts(lk, kk)
    check(layers > 0 and batched == 2 * layers and single == 0
          and kraus == 0 and fast_counts(lk) == (0, 0, 0),
          f"batched layer kernel launched {batched} times for {layers} "
          f"forward and {layers} adjoint layers (single-state {single}, "
          f"Kraus {kraus}); first call {first_s * 1e3:.1f} ms")
    check(vals.shape == (batch,) and grads.shape == (batch, len(names))
          and bool(np.isfinite(grads).all()),
          f"{batch} values and {batch} x {len(names)} finite gradients")
    print(f"  peak device memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated) at batch {batch}")

    energies = cc.expectation_sweep(pm, ham)
    e_rel = float(np.abs(vals - energies).max() / np.abs(energies).max())
    check(e_rel <= 1e-6, f"values vs expectation_sweep on the same rows: "
          f"max|diff| / max|E| {e_rel:.3e} <= 1e-6")
    rows, cols = (0, 1), [names.index(c) for c in GRAD_COLUMNS]
    oracle = shift_oracle(cc, pm, ham, rows, cols, chunk=24)
    gmax = float(np.abs(grads[list(rows)]).max())
    g_err = float(np.abs(grads[list(rows)][:, cols] - oracle).max())
    check(g_err <= 1e-3 * gmax, f"gradients vs parameter shift, rows "
          f"{rows} x columns {GRAD_COLUMNS}: max|diff| {g_err:.3e} <= 1e-3 "
          f"of max|g| {gmax:.3e} ({g_err / gmax:.3e})")

    fwd, back = walk_held(torch, lk, cc,
                          lambda: cc.value_and_grad_sweep(pm, ham))
    check(len(fwd) == len(back) == layers
          and max(r for _, r in fwd + back) <= 1e-5,
          f"each of {len(fwd)} forward and {len(back)} adjoint layers' "
          f"kernel output on its own input vs its plain version: max|diff| "
          f"/ max|plain| {max(r for _, r in fwd + back):.3e} <= 1e-5")

    grad_s = timed_runs(torch, lambda: cc.value_and_grad_sweep(pm, ham),
                        reps=1)
    energy_s = timed_runs(torch, lambda: cc.expectation_sweep(pm, ham),
                          reps=1)
    shift_cost = 2 * len(names) + 1
    print(f"  value_and_grad_sweep {grad_s * 1e3:.1f} ms, "
          f"{batch / grad_s:.2f} points/s; expectation_sweep "
          f"{energy_s * 1e3:.1f} ms, {batch / energy_s:.2f} points/s; a "
          f"gradient costs {grad_s / energy_s:.2f} energy sweeps (parameter "
          f"shift: 2P + 1 = {shift_cost}) on {card}")

    # FAST against SINGLE (the env's precision): the walk's gradients are
    # 2 Re <lam, mu> with |lam| <= sum|c_t| and |mu| <= 1/2; the tier model
    # bounds each state's error by e, and the forward and reverse passes
    # each add e to psi and lam, so |g_FAST - g_SINGLE| <= 4 e sum|c_t|
    e_fast = qt.modeled_tier_error(qt.FAST_TIER, len(circ.ops))
    bound = 4.0 * e_fast * float(np.abs(coeffs).sum())
    n_fast = sum(op.kind == "layer" for op in cc._plan_for(qt.FAST_TIER)[1])
    reset_counts(lk, kk)
    _, g_fast = cc.value_and_grad_sweep(pm, ham, tier="fast")
    torch.cuda.synchronize()
    fast_launches = fast_counts(lk)[1]
    diff = float(np.abs(g_fast - grads).max())
    check(fast_launches == 2 * n_fast and diff <= bound,
          f"tier fast: {fast_launches} FAST launches for {n_fast} forward "
          f"and {n_fast} adjoint layers; gradients vs SINGLE max|diff| "
          f"{diff:.3e} <= 4 e sum|c| = {bound:.3e} (e = modeled "
          f"{e_fast:.3e}; max|g| {float(np.abs(grads).max()):.3e})")

    # the adjoint layers' times over the stacked 2B states
    states = cc.sweep(pm)
    stacked = torch.cat([states, states])
    del states
    adjoints = list(cc._adjoint_walk(None).adjoints.values())
    rows_t = batched_layer_times(torch, lk, stacked, n, adjoints,
                                 f"adjoint (2B = {2 * batch})")
    del stacked
    torch.cuda.empty_cache()
    return {"launches": batched, "rows": rows_t,
            "max_abs_err": max(e for e, _ in fwd + back),
            "points_per_s": batch / grad_s,
            "energy_points_per_s": batch / energy_s,
            "grad_per_energy": grad_s / energy_s,
            "peak_bytes": peak, "fast_launches": fast_launches,
            "fast_max_diff": diff, "fast_bound": bound}


def random_hamiltonian(n: int, num_terms: int, seed: int):
    """``num_terms`` random Pauli strings on ``n`` qubits with normal
    coefficients: (terms, coeffs, flat codes)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(num_terms, n))
    coeffs = rng.normal(size=num_terms)
    terms = [[(q, int(codes[t, q])) for q in range(n)]
             for t in range(num_terms)]
    return terms, coeffs, [int(c) for c in codes.reshape(-1)]


def rate_circuit(qt, n: int):
    """tests/test_gradients.py's density program: an ry/rz column of
    Params, a CNOT ring, then dephasing at a Param rate on qubit 0."""
    c = hea_circuit(qt, n, 1)
    c.dephase(0, c.parameter("rate"))
    return c


def phase_density_grad(torch, qt, lk, kk, card):
    """Phase 12d: density sweeps and density gradients."""
    n = DENSITY_QUBITS
    print(f"phase 12d: density sweeps and gradients, on {card}")
    env = qt.createQuESTEnv()
    circ, _, angles = density_noise(qt, n, params=True)
    terms, coeffs, codes = random_hamiltonian(n, SWEEP_TERMS, 2027)
    ham = (terms, coeffs)
    pm = np.stack([angles, np.random.default_rng(2028).uniform(
        0, 2 * np.pi, n)])
    cc = circ.compile(env, density=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    energies = cc.expectation_sweep(pm, ham)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    q = qt.createDensityQureg(n, env)
    want = []
    for row in pm:
        qt.initZeroState(q)
        cc.run(q, dict(zip(circ.param_names, row)))
        want.append(qt.calcExpecPauliSum(q, codes, coeffs))
    del q
    torch.cuda.empty_cache()
    want = np.asarray(want)
    config4 = {"energies": energies, "pm": pm, "seconds": sweep_s}
    rel = float(np.abs(energies - want).max() / np.abs(want).max())
    check(rel <= 1e-4 and bool(np.isfinite(energies).all()),
          f"12d config 4 with Param rotations, {n} qubits, batch "
          f"{len(pm)}: expectation_sweep vs per-point run + "
          f"calcExpecPauliSum max|diff| / max|E| {rel:.3e} <= 1e-4 "
          f"(sweep {sweep_s * 1e3:.1f} ms, first call)")

    ng, batch = DENSITY_GRAD_QUBITS, DENSITY_GRAD_BATCH
    circ = rate_circuit(qt, ng)
    names = circ.param_names
    terms, coeffs, _ = random_hamiltonian(ng, 8, 2029)
    ham = (terms, coeffs)
    rng = np.random.default_rng(2030)
    pm = np.concatenate([rng.uniform(0, 2 * np.pi, (batch, len(names) - 1)),
                         rng.uniform(0.05, 0.3, (batch, 1))], axis=1)
    cc = circ.compile(env, density=True)
    walk = cc._adjoint_walk(None)
    stored = sum(not u for u in walk.unitary)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(lk, kk)
    t0 = time.perf_counter()
    vals, grads = cc.value_and_grad_sweep(pm, ham)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    batched = counts(lk, kk)[1]
    check(batched == 2 * cc.num_layers and bool(np.isfinite(grads).all()),
          f"12d gradients at {ng} qubits (2^{2 * ng} flat amplitudes), "
          f"batch {batch}: {batched} batched layer launches for "
          f"{cc.num_layers} layers and their adjoints, {stored} "
          f"non-unitary items; peak {peak / 2**30:.2f} GiB")
    energies = cc.expectation_sweep(pm, ham)
    e_rel = float(np.abs(vals - energies).max() / np.abs(energies).max())
    cols = [names.index(c) for c in DENSITY_GRAD_COLUMNS]
    rows = tuple(range(batch))
    oracle = shift_oracle(cc, pm, ham, rows, cols, chunk=4)
    eps = 1e-2
    up, dn = pm.copy(), pm.copy()
    up[:, -1] += eps
    dn[:, -1] -= eps
    fd = (cc.expectation_sweep(np.concatenate([up, dn]), ham)
          .reshape(2, batch))
    fd = (fd[0] - fd[1]) / (2 * eps)
    gmax = float(np.abs(grads).max())
    g_err = float(np.abs(grads[:, cols] - oracle).max())
    r_err = float(np.abs(grads[:, -1] - fd).max())
    check(e_rel <= 1e-6 and g_err <= 1e-3 * gmax and r_err <= 1e-3 * gmax,
          f"12d values vs expectation_sweep {e_rel:.3e} <= 1e-6 of max|E|; "
          f"rotation columns {DENSITY_GRAD_COLUMNS} vs parameter shift "
          f"{g_err:.3e}, the rate column vs a central difference (eps "
          f"{eps}) {r_err:.3e}, both <= 1e-3 of max|g| {gmax:.3e}")
    if cc.num_layers:
        fwd, back = walk_held(torch, lk, cc,
                              lambda: cc.value_and_grad_sweep(pm, ham))
        worst = max(r for _, r in fwd + back)
        check(len(back) == cc.num_layers and worst <= 1e-5,
              f"12d: {len(fwd)} forward and {len(back)} adjoint layers vs "
              f"their plain versions {worst:.3e} <= 1e-5")
    else:
        print(f"  12d: the lifted plan has no layer (gates pair qubit t "
              f"with t + {ng}, above the tile); no adjoint layer to hold")
    # the gradient's time is its first call's (the script's time limit);
    # the engine's host binding is warm by then in a whole run
    energy_s = timed_runs(torch, lambda: cc.expectation_sweep(pm, ham),
                          reps=1)
    print(f"  12d on {card}: value_and_grad_sweep {grad_s * 1e3:.1f} ms "
          f"(first call, {batch / grad_s:.3f} points/s), expectation_sweep "
          f"{energy_s * 1e3:.1f} ms ({grad_s / energy_s:.2f} energy sweeps); "
          f"{len(names)} parameters")
    del cc
    torch.cuda.empty_cache()
    # phase 22c's one-device yardsticks: the config 4 energies and the
    # gradient cell's values and gradients, with their parameter rows
    return {"config4_rel": rel, "grad_points_per_s": batch / grad_s,
            "energy_points_per_s": batch / energy_s, "peak_bytes": peak,
            "config4": config4,
            "gradients": {"values": vals, "grads": grads, "pm": pm,
                          "seconds": grad_s}}


REMAINDER_SHOTS = 1_000_000
REMAINDER_QUBITS = (0, 1, 2, 3)


def distance_to_zero_state(torch, planes) -> float:
    """||psi - |0..0>||_2, reduced in float64 on the card."""
    sq = float(torch.linalg.vector_norm(planes, dtype=torch.float64)) ** 2
    return max(0.0, sq - 2.0 * float(planes[0, 0]) + 1.0) ** 0.5


def low_qubit_marginals(torch, planes, k: int):
    """P(low k qubits = b) from the planes, reduced in float64 on the card
    in chunks."""
    acc = torch.zeros(1 << k, dtype=torch.float64, device=planes.device)
    chunk = 1 << 26
    for lo in range(0, planes.shape[1], chunk):
        re = planes[0, lo:lo + chunk].double()
        im = planes[1, lo:lo + chunk].double()
        acc += (re * re + im * im).view(-1, 1 << k).sum(0)
    return acc.cpu().numpy()


def float32_cdf_drift(torch, planes) -> float:
    """The largest gap between a float32 and a float64 running sum of the
    state's probabilities, over the total: the mass a float32 sampler's
    CDF would misplace (the port's sampler sums in float64)."""
    probs = planes[0] * planes[0] + planes[1] * planes[1]
    c32 = torch.cumsum(probs, 0)
    c64 = torch.cumsum(probs, 0, dtype=torch.float64)
    del probs
    gap = 0.0
    chunk = 1 << 26
    for lo in range(0, c32.shape[0], chunk):
        gap = max(gap, float((c32[lo:lo + chunk].double()
                              - c64[lo:lo + chunk]).abs().max()))
    total = float(c64[-1])
    del c32, c64
    torch.cuda.empty_cache()
    return gap / total


def phase_remainder(torch, qt, lk, kk, card):
    """Phase 14: the main-path remainder at 30 qubits, complex64, through
    the public surface: precompile, sampleOutcomes, imperative gate
    fusion, setWeightedQureg, inverse, extend, dispatch_stats,
    program_digest. At most three 8 GiB registers at once."""
    from quest_tpu_torch.ops import cuda_build
    n = MAIN_QUBITS
    print(f"phase 14: the main-path remainder, {n} qubits, complex64, on "
          f"{card}")
    env = qt.createQuESTEnv(num_devices=1)
    check(env.device.type == "cuda" and env.num_devices == 1,
          f"createQuESTEnv(num_devices=1) on {env.device}")
    print(f"  {qt.getEnvironmentString(env)}")
    gates = brickwork(n, MAIN_LAYERS)
    circ = as_circuit(qt, n, gates)
    out = {}

    # 14a: build and setup ahead of the run, then the first two runs
    t0 = time.perf_counter()
    cc = circ.compile(env)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cc.precompile()
    torch.cuda.synchronize()
    precompile_s = time.perf_counter() - t0
    layer_ops = [op for op in cc._ops if op.kind == "layer"]
    check(len(layer_ops) == 4 and all(
        lk.is_packed(op, n, torch.float32, env.device) for op in layer_ops),
          f"precompile ({precompile_s:.2f} s after a {compile_s:.2f} s "
          f"compile) packed all {len(layer_ops)} layers before any run")
    q1 = qt.createQureg(n, env)
    builds = cuda_build.build_all.cache_info().misses
    packs = lk._operands.packs
    reset_counts(lk, kk)
    run_s = []
    for _ in range(2):
        qt.initZeroState(q1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cc.run(q1)
        torch.cuda.synchronize()
        run_s.append(time.perf_counter() - t0)
        if len(run_s) == 1:
            launches, batched, kraus = counts(lk, kk)
            built = cuda_build.build_all.cache_info().misses - builds
            packed = lk._operands.packs - packs
    check(launches == 4 and batched == kraus == 0 and built == packed == 0,
          f"first run: layer kernel launched {launches} times, built "
          f"{built} libraries, packed {packed} layers")
    # the first run of a second program, precompiled and not, in the now
    # warm process: what is left of a first run after precompile() is
    # the process's own first-use cost (module loading, cuBLAS, the
    # caching allocator's first blocks), not the program's setup
    for label, program in (("precompiled", circ.compile(env).precompile()),
                           ("not precompiled", circ.compile(env))):
        qt.initZeroState(q1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        program.run(q1)
        torch.cuda.synchronize()
        run_s.append(time.perf_counter() - t0)
        del program
    print(f"  first run {run_s[0] * 1e3:.1f} ms, second run "
          f"{run_s[1] * 1e3:.1f} ms ({len(gates)} gates); a second "
          f"program's first run {run_s[2] * 1e3:.1f} ms precompiled, "
          f"{run_s[3] * 1e3:.1f} ms not")
    out.update(launches_remainder_first_run=launches,
               first_run_ms=run_s[0] * 1e3, second_run_ms=run_s[1] * 1e3,
               warm_first_run_ms=run_s[2] * 1e3,
               warm_first_run_unprecompiled_ms=run_s[3] * 1e3,
               precompile_s=precompile_s)

    # 14b: sampleOutcomes on the brickwork state
    drift = float32_cdf_drift(torch, q1.state)
    marg = low_qubit_marginals(torch, q1.state, len(REMAINDER_QUBITS))
    probs = marg / marg.sum()
    before = q1.state.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shots = qt.sampleOutcomes(q1, REMAINDER_SHOTS,
                              qubits=list(REMAINDER_QUBITS))
    sample_s = time.perf_counter() - t0
    same = bool(torch.equal(before.view(torch.int32),
                            q1.state.view(torch.int32)))
    del before
    torch.cuda.empty_cache()
    freq = np.bincount(shots, minlength=probs.size) / REMAINDER_SHOTS
    stderr = np.sqrt(probs * (1.0 - probs) / REMAINDER_SHOTS)
    z = np.abs(freq - probs) / stderr
    check(same and z.max() <= 5.0,
          f"sampleOutcomes: {REMAINDER_SHOTS} shots of qubits "
          f"{list(REMAINDER_QUBITS)} in {sample_s * 1e3:.1f} ms, every "
          f"bin within {z.max():.2f} <= 5 stderr, planes bit-equal after")
    print(f"  a float32 running sum of the 2^{n} probabilities would "
          f"misplace up to {drift:.3e} of the mass (a bin's 5-stderr bar: "
          f"{5 * stderr.min():.3e}); the sampler sums in float64")
    out.update(sample_ms=sample_s * 1e3, sample_max_stderrs=float(z.max()),
               float32_cdf_drift=drift)

    # 14c: the brickwork's gates through imperative gate fusion
    q2 = qt.createQureg(n, env)
    reset_counts(lk, kk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with qt.fusedGates(q2, 3):
        buf = q2._fusion_buffer
        run_per_gate(qt, q2, gates)
        q2.flush_gates()
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    dist = float(torch.linalg.vector_norm(q1.state - q2.state))
    check(dist <= 1e-4 and sum(counts(lk, kk)) == 0,
          f"fusedGates(q, 3) vs the compiled run: ||dpsi||_2 = {dist:.3e}")
    q2e = qt.createQureg(n, env)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_per_gate(qt, q2e, gates)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    qt.destroyQureg(q2e, env)
    del q2e
    torch.cuda.empty_cache()
    print(f"  fused: {buf.gates_in} gates in, {buf.kernels_out} kernels "
          f"out, {fused_s * 1e3:.1f} ms; the same gates eagerly "
          f"{eager_s * 1e3:.1f} ms")
    out.update(fused_gates_in=buf.gates_in,
               fused_kernels_out=buf.kernels_out, fused_ms=fused_s * 1e3,
               eager_ms=eager_s * 1e3)

    # 14d: setWeightedQureg into a third register (|+..+>, known exactly)
    q3 = qt.createQureg(n, env)
    qt.initPlusState(q3)
    f1, f2, fo = 0.6 - 0.2j, -0.3j, 0.25 + 0.5j
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qt.setWeightedQureg(f1, q1, f2, q2, fo, q3)
    torch.cuda.synchronize()
    weighted_s = time.perf_counter() - t0
    plus = 2.0 ** (-n / 2)
    err, top = 0.0, 0.0
    chunk = 1 << 26
    for lo in range(0, 1 << n, chunk):
        sl = slice(lo, lo + chunk)
        z1 = torch.complex(q1.state[0, sl], q1.state[1, sl])
        z2 = torch.complex(q2.state[0, sl], q2.state[1, sl])
        want = f1 * z1 + f2 * z2 + fo * plus
        got = torch.complex(q3.state[0, sl], q3.state[1, sl])
        err = max(err, float((got - want).abs().max()))
        top = max(top, float(want.abs().max()))
    check(err <= 1e-6 * top,
          f"setWeightedQureg at {n} qubits in {weighted_s * 1e3:.1f} ms vs "
          f"torch ops: max|diff| {err:.3e} <= 1e-6 of max|amp| {top:.3e}")
    out.update(set_weighted_ms=weighted_s * 1e3)
    for q in (q2, q3):
        qt.destroyQureg(q, env)
    del q2, q3, buf
    torch.cuda.empty_cache()

    # 14e: the inverse, each layer held against its plain version on its
    # own input (the hook stands in for the wrapper and holds its counts)
    inv = circ.inverse().compile(env)
    with HeldLayers(torch, lk, batched=False) as held:
        inv.run(q1)
    rel = held.max_err()[1]
    dist = distance_to_zero_state(torch, q1.state)
    check(held.launches == inv.num_layers == len(held.errs) > 0
          and rel <= 1e-5 and dist <= 1e-4,
          f"circ.inverse() after the brickwork: ||psi - |0..0>||_2 = "
          f"{dist:.3e}; its {len(held.errs)} layers vs plain on their own "
          f"input max|diff| / max|plain| {rel:.3e} <= 1e-5")
    out.update(launches_remainder_inverse=held.launches)

    # 14f: extend: the brickwork and its inverse as one program
    both = qt.Circuit(n).extend(circ).extend(circ.inverse())
    ext = both.compile(env)
    stats = ext.dispatch_stats().as_dict()
    print(f"  extended program dispatch_stats: {json.dumps(stats)}")
    digest = ext.program_digest
    again = qt.Circuit(n).extend(circ).extend(circ.inverse()).compile(env)
    check(stats["gates_in"] == 2 * len(gates) == 178
          and again.program_digest == digest,
          f"extend: gates_in {stats['gates_in']}, program_digest "
          f"{digest} stable across two compiles")
    qt.initZeroState(q1)
    reset_counts(lk, kk)
    ext.run(q1)
    torch.cuda.synchronize()
    ext_launches = counts(lk, kk)[0]
    dist = distance_to_zero_state(torch, q1.state)
    check(ext_launches == ext.num_layers and dist <= 1e-4,
          f"the extended program ({ext_launches} layer launches) returns "
          f"|0..0>: ||dpsi||_2 = {dist:.3e}")
    out.update(launches_remainder_extend=ext_launches,
               extend_kernels_out=stats["kernels_out"])
    qt.destroyQureg(q1, env)
    del q1
    torch.cuda.empty_cache()
    return out


# -- phases 15 and 16: dynamics, the algorithm library, the QASM importer ---

DYN_QUBITS, DYN_BATCH, DYN_CHECK_QUBITS = 24, 4, 12
DYN_T, DYN_STEPS = 0.8, 8                   # EvolveSpec(0.8, 8, order=2)
GROUND_STEPS, GROUND_TAU = 16, 0.1
ALG_QUBITS = 30
QFT_BASIS = 0x2B5A1C3D                      # the QFT's start |x>
BV_SECRET = 0x15A3C6E9
GROVER_QUBITS, GROVER_MARKED = 20, 0xBEEF5


class HeldLayers:
    """While open, every launch of the layer kernel (``batched``: the
    batched entry) goes through the wrapper and is held against its plain
    version on the same input; the stand-in holds the launches' counts
    from 0. ``launches``/``diag_launches``/``errs`` stay readable after
    the block."""

    def __init__(self, torch, lk, batched: bool):
        self.torch, self.lk, self.errs = torch, lk, []
        self.name = "apply_layer_batched" if batched else "apply_layer"
        self.launch, self.held = held_layers(torch, lk, self.errs, batched)

    def __enter__(self):
        setattr(self.lk, self.name, self.held)
        return self

    def __exit__(self, *exc):
        setattr(self.lk, self.name, self.launch)
        self.torch.cuda.empty_cache()

    @property
    def launches(self) -> int:
        return self.held.launches

    @property
    def diag_launches(self) -> int:
        return self.held.diag_launches

    def max_err(self):
        """(max |kernel - plain|, max of that / max |plain|) so far."""
        return (max((e[1] for e in self.errs), default=0.0),
                max((e[2] for e in self.errs), default=0.0))


def dyn_prep(qt, n: int):
    """tests/test_dynamics.py ``prep_circuit``: an ry column of Params,
    then a CNOT chain."""
    c = qt.Circuit(n)
    for q in range(n):
        c.ry(q, c.parameter(f"y{q}"))
    for q in range(n - 1):
        c.cnot(q, q + 1)
    return c


def tfim(n: int, h: float = 0.7):
    """The open transverse-field Ising model: sum ZZ + h sum X."""
    terms = [[(q, 3), (q + 1, 3)] for q in range(n - 1)]
    terms += [[(q, 1)] for q in range(n)]
    return terms, [1.0] * (n - 1) + [h] * n


def f64_energies(torch, red, planes, operands):
    """``<z_b|H|z_b>`` of a ``(B, 2, N)`` batch, reduced in float64 on the
    card: an independent float64 reduction of the planes."""
    xm, ym, zm, cf = operands
    return red.pauli_sum_total_sv(planes.double(), xm, ym, zm,
                                  cf).cpu().numpy()


def block_head(block, width: int) -> np.ndarray:
    """The energy/residual/Welford columns of a packed block, as float64
    host numpy (the planes stay on the card)."""
    return block[:, :width].double().cpu().numpy()


def block_planes(block, n: int, offset: int):
    return block[:, offset:].view(block.shape[0], 2, 1 << n)


def phase_dynamics(torch, qt, lk, kk, card):
    """Phase 15: evolve_sweep / ground_sweep at 24 qubits, batch 4."""
    from quest_tpu_torch import algorithms as alg
    from quest_tpu_torch.ops import dynamics as dyn
    from quest_tpu_torch.ops import reductions as red
    n, B, S = DYN_QUBITS, DYN_BATCH, DYN_STEPS
    ham = tfim(n)
    T, csum = len(ham[0]), float(np.abs(ham[1]).sum())
    print(f"phase 15: Hamiltonian dynamics, {n} qubits, complex64, batch "
          f"{B}, open TFIM h = 0.7 ({T} terms, sum|c| {csum:.1f}), on "
          f"{card}")
    env = qt.createQuESTEnv(seed=[2026])
    cc = dyn_prep(qt, n).compile(env)
    layers = cc.num_layers
    operands = cc._pauli_operands(ham)
    pm = np.random.default_rng(2026).normal(size=(B, n)) * 0.3
    spec = dyn.EvolveSpec(t=DYN_T, steps=S, order=2)
    secs = {}
    out = {}

    reset_counts(lk, kk)
    with HeldLayers(torch, lk, batched=True) as held:
        # 15a: evolve, order 2
        t0 = time.perf_counter()
        block = cc.evolve_sweep(pm, ham, spec)
        torch.cuda.synchronize()
        secs["evolve_held"] = time.perf_counter() - t0
        evolve_launches = held.launches
        stats = cc.dispatch_stats()
        check(layers > 0 and evolve_launches == layers
              and counts(lk, kk)[0] == counts(lk, kk)[2] == 0,
              f"evolve_sweep: the batched layer kernel launched "
              f"{evolve_launches} times for the prep program's {layers} "
              f"layer(s)")
        check(stats.evolve_steps_fused == B * S
              and stats.host_syncs_avoided == B * S - 1
              and stats.batch_size == B,
              f"dispatch_stats: evolve_steps_fused "
              f"{stats.evolve_steps_fused}, host_syncs_avoided "
              f"{stats.host_syncs_avoided}, batch_size {stats.batch_size}")
        head = block_head(block, S + 3)
        planes = block_planes(block, n, S + 3)
        es, (cnt, mean, m2) = head[:, :S], head[:, S:].T
        # phase 22b's one-device yardsticks
        out["evolve_energies"] = es.copy()
        norms = (planes.double() ** 2).sum(dim=(1, 2)).cpu().numpy()
        check(bool(np.isfinite(head).all())
              and np.abs(norms - 1.0).max() <= 1e-4,
              f"evolve: finite energies, norms within "
              f"{np.abs(norms - 1.0).max():.3e} <= 1e-4 of 1")
        e64 = f64_energies(torch, red, planes, operands)
        d = float(np.abs(es[:, -1] - e64).max())
        check(d <= 1e-5 * csum, f"evolve: the last step's energies vs a "
              f"float64 reduction of the returned planes: max|dE| "
              f"{d:.3e} <= 1e-5 sum|c| ({1e-5 * csum:.3e})")
        mean_h = es.mean(axis=1)
        m2_h = ((es - mean_h[:, None]) ** 2).sum(axis=1)
        scale = (es ** 2).sum(axis=1)
        dm = float(np.abs(mean - mean_h).max() / np.abs(mean_h).max())
        d2 = float((np.abs(m2 - m2_h) / scale).max())
        check(bool((cnt == S).all()) and dm <= 1e-6 and d2 <= 1e-6,
              f"Welford (count, mean, M2) vs the host moments of the "
              f"energies: counts {cnt.tolist()}, mean rel {dm:.3e}, M2 "
              f"rel to sum e^2 {d2:.3e} <= 1e-6")

        # the gate-form twin: the prep, then trotter_evolution
        t0 = time.perf_counter()
        twin = qt.Circuit(n).extend(dyn_prep(qt, n)).extend(
            alg.trotter_evolution(n, *ham, DYN_T, S, order=2)).compile(env)
        twin_compile_s = time.perf_counter() - t0
        before = held.launches
        t0 = time.perf_counter()
        twin_planes = twin.sweep(pm)
        torch.cuda.synchronize()
        secs["twin_held"] = time.perf_counter() - t0
        twin_launches = held.launches - before
        dist = torch.linalg.vector_norm((planes - twin_planes).double(),
                                        dim=(1, 2)).cpu().numpy()
        check(twin_launches == twin.num_layers and dist.max() <= 5e-4,
              f"evolve vs the gate-form twin (prep + "
              f"trotter_evolution, {len(twin.circuit.ops)} gates, "
              f"{twin.num_layers} layers, compiled in "
              f"{twin_compile_s:.1f} s) through sweep: ||dpsi||_2 per row "
              f"{np.array2string(dist, precision=3)} <= 5e-4")
        del twin_planes, planes, block
        torch.cuda.empty_cache()

        # 15b: the same at tier="single" (compensated energies)
        block = cc.evolve_sweep(pm, ham, spec, tier="single")
        head = block_head(block, S)
        e64 = f64_energies(torch, red, block_planes(block, n, S + 3),
                           operands)
        d = float((np.abs(head[:, -1] - e64) / np.abs(e64)).max())
        check(d <= 1e-6, f"evolve at tier='single': the last energies vs "
              f"the float64 reduction: max|dE| / |E| {d:.3e} <= 1e-6")
        del block

        # 15c: ground state by power iteration, two segments chained
        # through state_f (the second from the identity continuation, as
        # the serving layer chains them)
        gspec = dyn.GroundSpec(steps=GROUND_STEPS, tau=GROUND_TAU)
        e_start = cc.expectation_sweep(pm, ham)
        t0 = time.perf_counter()
        block = cc.ground_sweep(pm, ham, gspec)
        torch.cuda.synchronize()
        secs["ground_held"] = time.perf_counter() - t0
        head = block_head(block, GROUND_STEPS + 4)
        out["ground_energies"] = head[:, :GROUND_STEPS].copy()
        cont = qt.Circuit(n).compile(env)
        block2 = cont.ground_sweep(
            np.zeros((1, 0)), ham, gspec,
            state_f=block_planes(block, n, GROUND_STEPS + 4)[0])
        head2 = block_head(block2, GROUND_STEPS + 4)
        chain = np.concatenate([e_start[:1], head[0, :GROUND_STEPS],
                                head2[0, :GROUND_STEPS]])
        rises = max(float(np.diff(np.concatenate(
            [e_start[:, None], head[:, :GROUND_STEPS]], axis=1)).max()),
            float(np.diff(chain).max()))
        check(rises <= 1e-5 * csum,
              f"power iteration: energies {e_start[0]:.6f} -> "
              f"{head[0, GROUND_STEPS - 1]:.6f} -> "
              f"{head2[0, GROUND_STEPS - 1]:.6f} (row 0, two chained "
              f"segments), largest rise {rises:.3e} <= 1e-5 sum|c|; "
              f"residuals {head[0, GROUND_STEPS]:.3e}, "
              f"{head2[0, GROUND_STEPS]:.3e}")
        del block, block2

        # 15d: Lanczos
        lspec = dyn.GroundSpec(steps=GROUND_STEPS, method="lanczos")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        block = cc.ground_sweep(pm, ham, lspec)
        torch.cuda.synchronize()
        secs["lanczos_held"] = time.perf_counter() - t0
        peak_lanczos = torch.cuda.max_memory_allocated()
        head = block_head(block, GROUND_STEPS + 4)
        ritz = block_planes(block, n, GROUND_STEPS + 4)
        e64 = f64_energies(torch, red, ritz, operands)
        energy, residual = head[:, 0], head[:, GROUND_STEPS]
        out["lanczos_energies"] = energy.copy()
        z64 = ritz.double()
        hx = red.pauli_sum_apply_sv(z64, *operands)
        true_res = torch.linalg.vector_norm(
            hx - torch.as_tensor(e64, device=hx.device)[:, None, None]
            * z64, dim=(1, 2)).cpu().numpy()
        del hx, z64
        d = float(np.abs(energy - e64).max())
        check(d <= 1e-4 * csum and bool((energy < e_start).all()),
              f"Lanczos: energies {np.array2string(energy, precision=5)} "
              f"(start {np.array2string(e_start, precision=5)}) vs "
              f"<x|H|x> of the returned planes in float64: max|dE| "
              f"{d:.3e} <= 1e-4 sum|c|; reported residual "
              f"{np.array2string(residual, precision=3)}, ||Hx - Ex||_2 "
              f"{np.array2string(true_res, precision=3)}")
        del block, ritz
        torch.cuda.empty_cache()

        # 15e: a 12-qubit copy on the card and on the CPU in float64
        n12 = DYN_CHECK_QUBITS
        ham12 = tfim(n12)
        csum12 = float(np.abs(ham12[1]).sum())
        pm12 = np.random.default_rng(12).normal(size=(B, n12)) * 0.3
        cpu_env = qt.createQuESTEnv(device="cpu", precision=qt.DOUBLE)
        cards = dyn_prep(qt, n12).compile(env)
        cpus = dyn_prep(qt, n12).compile(cpu_env)
        for kind, sp, unpack in (
                ("evolve", spec, dyn.unpack_evolve_block),
                ("ground", gspec, dyn.unpack_ground_block),
                ("ground", lspec, dyn.unpack_ground_block)):
            a = unpack(getattr(cards, f"{kind}_sweep")(pm12, ham12, sp),
                       n12, sp.steps)
            b = unpack(getattr(cpus, f"{kind}_sweep")(pm12, ham12, sp),
                       n12, sp.steps)
            pa, pb = a["planes"], b["planes"]
            amp = float(np.minimum(
                np.abs(pa - pb).max(axis=(1, 2)),
                np.abs(pa + pb).max(axis=(1, 2)) if sp is lspec
                else np.inf).max())
            de = float(np.abs(a["energies"] - b["energies"]).max())
            top = float(np.abs(pb).max())
            check(amp <= 1e-4 * top and de <= 1e-4 * csum12,
                  f"{n12} q card vs CPU float64, {kind} "
                  f"{getattr(sp, 'method', 'order 2')}: max|d amp| "
                  f"{amp:.3e} <= 1e-4 of {top:.3e}"
                  f"{' (up to sign)' if sp is lspec else ''}, max|dE| "
                  f"{de:.3e} <= 1e-4 sum|c|")
        launches = held.launches
        max_abs, max_rel = held.max_err()
    check(launches > 0 and max_rel <= 1e-5,
          f"every batched layer launch of the phase ({launches}) vs its "
          f"plain version on its own input: max|diff| {max_abs:.3e}, "
          f"/ max|plain| {max_rel:.3e} <= 1e-5")

    # 15f: times, with no layer held (the ground calls' are their held
    # calls': one held prep launch, ~30 ms, in seconds of steps)
    torch.cuda.reset_peak_memory_stats()
    secs["evolve"] = timed_runs(
        torch, lambda: cc.evolve_sweep(pm, ham, spec), reps=1)
    peak_evolve = torch.cuda.max_memory_allocated()
    secs["twin"] = timed_runs(torch, lambda: twin.sweep(pm), reps=1)
    rotations = B * S * 2 * T
    rot_per_s = rotations / secs["evolve"]
    # one term's rotation over the batch, timed alone: an X term (the
    # xor-gather) and a ZZ term (the sign alone)
    xm, ym, zm, cf = operands
    z = cc.sweep(pm)
    rot = {}
    for name, t in (("X", n - 1), ("ZZ", 0)):
        rot[name] = cuda_ms(torch, lambda t=t: dyn.trotter_sweep(
            z, xm[t:t + 1], ym[t:t + 1], zm[t:t + 1], cf[t:t + 1], 1e-3),
            reps=5)
    # the X term's xor-gather by index_select in place of the flip
    flip_runs, red._FLIP_RUNS = red._FLIP_RUNS, 0
    try:
        rot["X_index_select"] = cuda_ms(torch, lambda t=n - 1:
            dyn.trotter_sweep(z, xm[t:t + 1], ym[t:t + 1], zm[t:t + 1],
                              cf[t:t + 1], 1e-3), reps=5)
    finally:
        red._FLIP_RUNS = flip_runs
    state_bytes = z.numel() * z.element_size()
    del z
    torch.cuda.empty_cache()
    # the least a rotation can move: the batch read once and written once
    rot_bound = 1e3 * 2.0 * state_bytes / HBM_BYTES_PER_S
    print(f"  seconds per call: evolve {secs['evolve']:.3f} (held "
          f"{secs['evolve_held']:.3f}), gate-form twin sweep "
          f"{secs['twin']:.3f}, power ground {secs['ground_held']:.3f} "
          f"(held), Lanczos {secs['lanczos_held']:.3f} (held)")
    print(f"  evolve: {rotations} term rotations (B S 2T) in "
          f"{secs['evolve']:.3f} s: {rot_per_s:.1f} rotations/s; one "
          f"rotation over the batch X {rot['X']:.3f} ms (index_select "
          f"gather {rot['X_index_select']:.3f}), ZZ "
          f"{rot['ZZ']:.3f} ms, HBM bound {rot_bound:.3f} ms (the "
          f"{state_bytes / 2**20:.0f} MiB batch read and written once)")
    print(f"  peak max_memory_allocated: evolve "
          f"{peak_evolve / 2**30:.2f} GiB, Lanczos "
          f"{peak_lanczos / 2**30:.2f} GiB")
    out.update(launches=launches, max_abs_err=max_abs,
               evolve_launches=evolve_launches,
               twin_launches=twin_launches,
               seconds={k: round(v, 4) for k, v in secs.items()},
               rotations_per_s=rot_per_s, rotation_ms=rot,
               rotation_bound_ms=rot_bound, peak_bytes_evolve=peak_evolve,
               peak_bytes_lanczos=peak_lanczos)
    return out


def inner_f64(torch, a, b):
    """|<a|b>| of two (2, N) planes, in float64 on the card, in chunks."""
    re = im = 0.0
    chunk = 1 << 26
    for lo in range(0, a.shape[1], chunk):
        ar, ai = a[0, lo:lo + chunk].double(), a[1, lo:lo + chunk].double()
        br, bi = b[0, lo:lo + chunk].double(), b[1, lo:lo + chunk].double()
        re += float((ar * br + ai * bi).sum())
        im += float((ar * bi - ai * br).sum())
    return (re * re + im * im) ** 0.5


def qft_distance(torch, planes, x: int) -> float:
    """||psi - QFT|x>||_2 against the analytic amplitudes e^{2 pi i x k /
    N} / sqrt(N), in float64 on the card, in chunks."""
    num = planes.shape[1]
    acc = 0.0
    chunk = 1 << 26
    for lo in range(0, num, chunk):
        k = torch.arange(lo, min(num, lo + chunk), dtype=torch.int64,
                         device=planes.device)
        ph = ((x * k) % num).double() * (2.0 * np.pi / num)
        re = planes[0, lo:lo + chunk].double() - torch.cos(ph) / num ** 0.5
        im = planes[1, lo:lo + chunk].double() - torch.sin(ph) / num ** 0.5
        acc += float((re * re + im * im).sum())
    return acc ** 0.5


def basis_distance(torch, planes, x: int) -> float:
    """||psi - |x>||_2, in float64 on the card."""
    sq = float(torch.linalg.vector_norm(planes, dtype=torch.float64)) ** 2
    return max(0.0, sq - 2.0 * float(planes[0, x]) + 1.0) ** 0.5


def grover_distance(torch, planes, marked: int, k: int):
    """(P(marked), ||psi - psi_k||_2) after k Grover iterations from the
    uniform state, against the analytic state (-1)^k (sin((2k+1) theta)
    at ``marked``, cos((2k+1) theta) / sqrt(N - 1) elsewhere)."""
    num = planes.shape[1]
    theta = np.arcsin(num ** -0.5)
    sign = -1.0 if k % 2 else 1.0
    want = torch.full((num,), sign * np.cos((2 * k + 1) * theta)
                      / (num - 1) ** 0.5, dtype=torch.float64,
                      device=planes.device)
    want[marked] = sign * np.sin((2 * k + 1) * theta)
    p = float(planes[0, marked].double() ** 2 + planes[1, marked].double()
              ** 2)
    dist = float(torch.sqrt(((planes[0].double() - want) ** 2).sum()
                            + (planes[1].double() ** 2).sum()))
    return p, dist, float(np.sin((2 * k + 1) * theta) ** 2)


def phase_algorithms(torch, qt, lk, kk, card):
    """Phase 16: the algorithm library and the QASM importer at 30
    qubits, complex64, every layer launch held against its plain
    version."""
    from quest_tpu_torch import algorithms as alg
    n = ALG_QUBITS
    print(f"phase 16: algorithm library and QASM importer, {n} qubits, "
          f"complex64, on {card}")
    env = qt.createQuESTEnv(seed=[2026])
    out, secs, gates_per_s = {}, {}, {}
    reset_counts(lk, kk)
    with HeldLayers(torch, lk, batched=False) as held:
        q = qt.createQureg(n, env)

        def run(name, circ, start, reg=q):
            """Compile ``circ`` and run it held on ``reg`` from ``start`` (a
            basis index, or None for |0..0>); check its launches. Returns
            the compiled program."""
            t0 = time.perf_counter()
            cc = circ.compile(env)
            compile_s = time.perf_counter() - t0
            before = (held.launches, held.diag_launches)
            qt.initClassicalState(reg, start or 0)
            cc.run(reg)
            torch.cuda.synchronize()
            launched = (held.launches - before[0],
                        held.diag_launches - before[1])
            check(launched[0] == cc.num_layers,
                  f"{name}: {len(circ.ops)} gates -> "
                  f"{len(cc.plan.items)} ops, {launched[0]} layer launches "
                  f"({launched[1]} streaming) for {cc.num_layers} layers; "
                  f"compiled in {compile_s:.2f} s")
            return cc, launched

        # 16a: QFT from a basis state, then its inverse back
        qft, _ = run(f"qft({n})", alg.qft(n), QFT_BASIS)
        dist = qft_distance(torch, q.state, QFT_BASIS)
        check(dist <= 5e-4, f"qft({n})|x = {QFT_BASIS:#x}> vs the analytic "
              f"amplitudes in float64: ||dpsi||_2 = {dist:.3e} <= 5e-4")
        iqft = alg.inverse_qft(n).compile(env)
        before = held.launches
        iqft.run(q)
        torch.cuda.synchronize()
        dist = basis_distance(torch, q.state, QFT_BASIS)
        check(held.launches - before == iqft.num_layers and dist <= 1e-4,
              f"inverse_qft({n}) back to |x>: ||psi - |x>||_2 = "
              f"{dist:.3e} <= 1e-4")

        # 16b: Bernstein-Vazirani
        bv, _ = run(f"bernstein_vazirani({n})",
                    alg.bernstein_vazirani(n, BV_SECRET), None)
        p = float(q.state[0, BV_SECRET].double() ** 2
                  + q.state[1, BV_SECRET].double() ** 2)
        check(p >= 1 - 1e-5, f"bernstein_vazirani({n}, {BV_SECRET:#x}): "
              f"P(secret) = {p:.8f} >= 1 - 1e-5")

        # 16c: the QASM round trip of phase 4's brickwork
        gates = brickwork(n, MAIN_LAYERS)
        circ = as_circuit(qt, n, gates)
        t0 = time.perf_counter()
        text = circ.to_qasm()
        parsed = qt.parse_qasm(text)
        parse_s = time.perf_counter() - t0
        brick, _ = run("brickwork", circ, None)
        q2 = qt.createQureg(n, env)
        qt.initZeroState(q2)
        back = parsed.circuit.compile(env)
        before = held.launches
        back.run(q2)
        torch.cuda.synchronize()
        fid = inner_f64(torch, q.state, q2.state)
        check(held.launches - before == back.num_layers > 0
              and len(parsed.circuit.ops) == len(gates)
              and fid >= 1 - 1e-5,
              f"QASM round trip of the brickwork ({len(text)} chars, "
              f"written and parsed in {parse_s:.2f} s, {back.num_layers} "
              f"layers): |<psi|phi>| = {fid:.8f} >= 1 - 1e-5")
        qt.destroyQureg(q2, env)
        del q2
        torch.cuda.empty_cache()

        # 16d: Grover at 20 qubits
        # the builder's own count, round(pi/4 sqrt(2^n)): 804 at 20 qubits
        ng = GROVER_QUBITS
        k = int(round(np.pi / 4.0 * np.sqrt(1 << ng)))
        q20 = qt.createQureg(ng, env)
        groc = alg.grover(ng, GROVER_MARKED)
        grover, _ = run(f"grover({ng}, {k} iterations)", groc, None, q20)
        p, dist, want = grover_distance(torch, q20.state, GROVER_MARKED, k)
        check(abs(p - want) <= 1e-3 and dist <= 1e-3,
              f"grover({ng}): P(marked) = {p:.6f} vs sin^2((2k+1) theta) "
              f"= {want:.6f} (<= 1e-3); ||psi - psi_k||_2 = {dist:.3e} "
              f"<= 1e-3")
        launches, diag = held.launches, held.diag_launches
        max_abs, max_rel = held.max_err()

    # 16e: times, with no layer held
    for name, cc, reg in (("qft", qft, q), ("bv", bv, q),
                          ("brickwork_qasm", back, q), ("grover", grover,
                                                         q20)):
        secs[name] = timed_runs(torch, lambda cc=cc, reg=reg: cc.run(reg),
                                reps=1)
        gates_per_s[name] = len(cc.circuit.ops) / secs[name]
    for reg in (q, q20):
        qt.destroyQureg(reg, env)
    del q, q20
    torch.cuda.empty_cache()
    check(launches > 0 and max_rel <= 1e-5 and counts(lk, kk)[1] == 0,
          f"every layer launch of the phase ({launches}, {diag} through "
          f"the streaming entry) vs its plain version on its own input: "
          f"max|diff| {max_abs:.3e}, / max|plain| {max_rel:.3e} <= 1e-5")
    print(f"  seconds per run: " + ", ".join(
        f"{k} {v:.4f}" for k, v in secs.items()))
    print(f"  gates/s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in gates_per_s.items()))
    out.update(launches=launches, diag_launches=diag, max_abs_err=max_abs,
               seconds={k: round(v, 5) for k, v in secs.items()},
               gates_per_s=gates_per_s)
    return out


# phase 17: the QUAD tier (double-double planes, ops/doubledouble.py)
QUAD_IMPERATIVE_QUBITS = 20      # bench.py:498, the JAX package's dd row
QUAD_BRICKWORK_QUBITS = (("QUAD", 28), ("QUAD64", 27))   # 4 GiB of planes
QUAD_SWEEP_QUBITS, QUAD_SWEEP_BATCH = 24, 4
QUAD_CHECK_QUBITS = 12           # card against CPU
QUAD_DENSITY_QUBITS = 12
QUAD_SAMPLES = 100000


def no_launches(lk, kk, what: str) -> None:
    """Every kernel count is still 0: the dd paths launch no kernel."""
    got = counts(lk, kk) + fast_counts(lk) + (
        lk.apply_layer.diag_launches, lk.apply_layer_batched.diag_launches)
    check(not any(got), f"{what}: kernel launches {got}, expected none "
          "(the layer, batched layer, MXU-tile and Kraus kernels have no "
          "dd form)")


def quad_dd_gate_bound_ms(n: int, itemsize: int) -> float:
    """A dense dd gate's HBM bound: its four planes read once and written
    once."""
    return 2 * 4 * itemsize * (1 << n) / HBM_BYTES_PER_S * 1e3


def quad_imperative(torch, qt, lk, kk, card):
    """17a: phase 4's brickwork at one layer, gate by gate through the API
    on a QUAD, a QUAD64 and a DOUBLE register, then the reductions, a
    collapse, an inner product and sampleOutcomes on each."""
    n = QUAD_IMPERATIVE_QUBITS
    gates = brickwork(n, 1)
    rng = np.random.default_rng(2026)
    codes = rng.integers(0, 4, size=(SWEEP_TERMS, n))
    coeffs = rng.normal(size=SWEEP_TERMS)
    codes_flat = [int(c) for c in codes.reshape(-1)]
    print(f"  17a: imperative registers, {n} qubits, {len(gates)} gates "
          f"gate by gate, the {SWEEP_TERMS}-term Pauli sum")
    out = {}
    for name in ("DOUBLE", "QUAD", "QUAD64"):
        env = qt.createQuESTEnv(precision=getattr(qt, name), seed=[17])
        q = qt.createQureg(n, env)
        plus = qt.createQureg(n, env)
        qt.initPlusState(plus)
        qt.rotateY(plus, 3, 0.4)
        reset_counts(lk, kk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_per_gate(qt, q, gates)
        torch.cuda.synchronize()
        gate_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        energy = qt.calcExpecPauliSum(q, codes_flat, coeffs)
        energy_s = time.perf_counter() - t0
        vals = {"total": qt.calcTotalProb(q),
                "prob": qt.calcProbOfOutcome(q, 3, 1),
                "energy": energy,
                "inner": qt.calcInnerProduct(plus, q)}
        amps = q.to_numpy()
        samples = qt.sampleOutcomes(q, QUAD_SAMPLES, qubits=[0, 1, 2])
        clone = qt.createCloneQureg(q, env)
        vals["collapse"] = qt.collapseToOutcome(clone, 5, 0)
        collapsed = clone.to_numpy()
        if name != "DOUBLE":
            no_launches(lk, kk, f"17a {name}")
        print(f"  17a {name} on {card}: {len(gates)} gates in "
              f"{gate_s * 1e3:.1f} ms ({gate_s / len(gates) * 1e3:.2f} ms "
              f"per gate), calcExpecPauliSum {energy_s * 1e3:.1f} ms")
        out[name] = (vals, amps, collapsed, samples)
        del q, plus, clone
        torch.cuda.empty_cache()
    ref_vals, ref_amps, ref_col, _ = out["DOUBLE"]
    scale = float(np.abs(ref_amps).max())
    e_scale = max(abs(ref_vals["energy"]), 1.0)
    marg = np.bincount(np.arange(1 << n) & 7, weights=np.abs(ref_amps) ** 2,
                       minlength=8)
    for name, other in (("QUAD", "DOUBLE"), ("QUAD64", "DOUBLE"),
                        ("QUAD64", "QUAD")):
        vals, amps, col, samples = out[name]
        ovals, oamps, ocol, _ = out[other]
        amp_err = float(np.abs(amps - oamps).max()) / scale
        col_err = float(np.abs(col - ocol).max()) / scale
        val_err = max(abs(complex(vals[k]) - complex(ovals[k]))
                      for k in vals) / e_scale
        check(amp_err <= 1e-12 and col_err <= 1e-12 and val_err <= 1e-12,
              f"17a {name} vs {other}: amplitudes {amp_err:.3e}, collapsed "
              f"{col_err:.3e} of max|amp|, values (total, prob, energy, "
              f"inner, collapse) {val_err:.3e} of max|E| <= 1e-12")
        hist = np.bincount(samples, minlength=8) / QUAD_SAMPLES
        stderr = np.sqrt(marg * (1 - marg) / QUAD_SAMPLES)
        z = float(np.max(np.abs(hist - marg) / np.maximum(stderr, 1e-12)))
        check(z <= 5.0, f"17a {name}: sampleOutcomes marginal of qubits "
              f"0-2 within {z:.2f} stderr of the float64 marginal (<= 5)")
    print(f"  17a: energy {ref_vals['energy']!r} (DOUBLE), QUAD "
          f"{out['QUAD'][0]['energy']!r}, QUAD64 "
          f"{out['QUAD64'][0]['energy']!r}")
    return {"gates": len(gates),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def quad_brickwork(torch, qt, lk, kk, card):
    """17b: phase 4's brickwork through ``compile_dd`` at the widest
    widths, timed, then at 12 qubits on the card and the CPU from one
    input: equal bit for bit."""
    rows = {}
    for name, n in QUAD_BRICKWORK_QUBITS:
        env = qt.createQuESTEnv(precision=getattr(qt, name))
        gates = brickwork(n, MAIN_LAYERS)
        prog = as_circuit(qt, n, gates).compile_dd(env)
        itemsize = prog.dtype.itemsize
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(lk, kk)
        planes = prog.init_zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        planes = prog.run(planes)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        no_launches(lk, kk, f"17b {name}")
        tp = prog.total_prob(planes)
        check(abs(tp - 1.0) <= 1e-12,
              f"17b {name} {n} q: total_prob {tp!r} within 1e-12 of 1")
        # the planes' digest: phase 23c's mesh run is held against it
        digest = planes_digest(torch, planes)
        # one dense dd gate (the first rotation) timed alone
        step = prog._plan[0]
        gate_ms = cuda_ms(torch, lambda: step(planes), reps=3)
        bound = quad_dd_gate_bound_ms(n, itemsize)
        rows[name] = {"qubits": n, "gates_per_s": len(gates) / run_s,
                      "dd_gate_ms": gate_ms, "dd_gate_bound_ms": bound,
                      "peak_gib": peak / 2**30, "run_s": run_s,
                      "digest": digest}
        print(f"  17b {name} compile_dd brickwork, {n} qubits, "
              f"{len(gates)} gates ({prog.num_steps} dd steps) on {card}: "
              f"{run_s:.2f} s, {len(gates) / run_s:.1f} gates/s")
        print(f"  17b {name}: one dense dd gate {gate_ms:.2f} ms, HBM bound "
              f"{bound:.3f} ms ({gate_ms / bound:.0f}x the bound)")
        print(f"  17b {name}: peak memory {peak / 2**30:.2f} GiB, "
              f"total_prob - 1 = {tp - 1.0:.3e}")
        if name == "QUAD":
            profile_device(torch, lambda: step(planes),
                           f"one dense dd gate at {n} q on {card}",
                           cpu=False)
        del planes, prog
        torch.cuda.empty_cache()
    n = QUAD_CHECK_QUBITS
    rng = np.random.default_rng(1717)
    psi = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    psi /= np.linalg.norm(psi)
    circ = as_circuit(qt, n, brickwork(n, MAIN_LAYERS))
    for name in ("QUAD", "QUAD64"):
        prec = getattr(qt, name)
        outs = []
        for dev in (None, "cpu"):
            env = qt.createQuESTEnv(precision=prec, device=dev)
            prog = circ.compile_dd(env)
            outs.append(prog.run(prog.pack(psi)).cpu())
        same = torch.equal(raw_bits(torch, outs[0]), raw_bits(torch, outs[1]))
        check(same, f"17b {name} {n} q: the dd planes (hi and lo) of the "
              "card and the CPU equal bit for bit")
        print(f"  17b {name} {n} q: card and CPU dd planes equal bit for "
              "bit")
    return rows


def quad_sweep(torch, qt, lk, kk, card):
    """17c: phase 8's HEA at batch 4 through ``expectation_sweep`` at the
    QUAD rung on a DOUBLE env, against the DOUBLE rung; FAST and SINGLE
    energies against QUAD's; ``sweep(tier="quad")`` at 12 qubits on the
    card against the CPU."""
    n, batch = QUAD_SWEEP_QUBITS, QUAD_SWEEP_BATCH
    env = qt.createQuESTEnv(precision=qt.DOUBLE)
    circ = hea_circuit(qt, n, SWEEP_LAYERS)
    rng = np.random.default_rng(2026)
    codes = rng.integers(0, 4, size=(SWEEP_TERMS, n))
    coeffs = rng.normal(size=SWEEP_TERMS)
    terms = [[(q, int(codes[t, q])) for q in range(n)]
             for t in range(SWEEP_TERMS)]
    pm = rng.uniform(0.0, 2.0 * np.pi, size=(batch, len(circ.param_names)))
    cc = circ.compile(env)
    # the dd walk alone (sweep), then with the compensated energies
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(lk, kk)
    t0 = time.perf_counter()
    planes = cc.sweep(pm, tier="quad")
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - t0
    walk_peak = torch.cuda.max_memory_allocated()
    no_launches(lk, kk, "17c sweep(tier='quad')")
    n_items = len(cc._plan_for(qt.QUAD_TIER)[0].items)
    del planes
    torch.cuda.empty_cache()
    print(f"  17c sweep(tier='quad') alone: {walk_s:.2f} s for {n_items} "
          f"plan items ({walk_s / n_items * 1e3:.1f} ms an item), peak "
          f"{walk_peak / 2**30:.2f} GiB")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(lk, kk)
    t0 = time.perf_counter()
    e_quad = cc.expectation_sweep(pm, (terms, coeffs), tier="quad")
    torch.cuda.synchronize()
    quad_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    no_launches(lk, kk, "17c expectation_sweep(tier='quad')")
    stats = cc.dispatch_stats()
    check(stats.batch_size == batch,
          f"17c dispatch_stats batch_size {stats.batch_size}")
    e = {t: cc.expectation_sweep(pm, (terms, coeffs), tier=t)
         for t in ("double", "single", "fast")}
    scale = float(np.abs(e_quad).max())
    dev = {t: float(np.abs(v - e_quad).max()) / scale for t, v in e.items()}
    check(dev["double"] <= 1e-10, f"17c QUAD vs DOUBLE energies "
          f"{dev['double']:.3e} of max|E| <= 1e-10")
    print(f"  17c expectation_sweep(tier='quad'), {n} qubits, batch "
          f"{batch}, {SWEEP_TERMS} terms on {card}: {quad_s:.2f} s, "
          f"{batch / quad_s:.2f} points/s")
    print(f"  17c: peak memory {peak / 2**30:.2f} GiB")
    print(f"  17c: max|E - E_quad| / max|E_quad|: DOUBLE {dev['double']:.3e}, "
          f"SINGLE {dev['single']:.3e}, FAST {dev['fast']:.3e}")
    n12 = QUAD_CHECK_QUBITS
    c12 = hea_circuit(qt, n12, SWEEP_LAYERS)
    pm12 = rng.uniform(0.0, 2.0 * np.pi, size=(batch, len(c12.param_names)))
    card_planes = c12.compile(env).sweep(pm12, tier="quad").cpu()
    cpu_env = qt.createQuESTEnv(device="cpu", precision=qt.DOUBLE)
    cpu_planes = c12.compile(cpu_env).sweep(pm12, tier="quad")
    _, rel = rel_err(card_planes, cpu_planes)
    check(rel <= 1e-13, f"17c sweep(tier='quad') {n12} q card vs CPU "
          f"{rel:.3e} of max|amp| <= 1e-13")
    return {"points_per_s": batch / quad_s, "peak_gib": peak / 2**30,
            "walk_s": walk_s, "walk_peak_gib": walk_peak / 2**30,
            "deviation": dev, "energies": e_quad, "quad_s": quad_s}


def quad_density(torch, qt, lk, kk, card):
    """17d: BASELINE.json config 4 (rotations, CNOTs, dephasing and
    damping, then mixDensityMatrix) through the imperative API on a QUAD
    and a DOUBLE density register."""
    n = QUAD_DENSITY_QUBITS
    _, calls, _ = density_noise(qt, n)
    out = {}
    for name in ("DOUBLE", "QUAD"):
        env = qt.createQuESTEnv(precision=getattr(qt, name))
        rho = qt.createDensityQureg(n, env)
        other = qt.createDensityQureg(n, env)
        qt.initClassicalState(other, 5)
        qt.initPlusState(rho)
        reset_counts(lk, kk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for fn, args in calls:
            fn(rho, *args)
        qt.mixDensityMatrix(rho, 0.2, other)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        if name == "QUAD":
            no_launches(lk, kk, "17d QUAD density")
        out[name] = (rho.to_numpy(), qt.calcTotalProb(rho),
                     qt.calcPurity(rho))
        print(f"  17d {name} density register, {n} qubits, "
              f"{len(calls) + 1} calls on {card}: {run_s:.2f} s")
        del rho, other
        torch.cuda.empty_cache()
    amps, trace, purity = out["QUAD"]
    ref = out["DOUBLE"][0]
    err = float(np.abs(amps - ref).max()) / float(np.abs(ref).max())
    check(err <= 1e-12 and abs(trace - 1.0) <= 1e-12 and 0.0 < purity <= 1.0,
          f"17d QUAD vs DOUBLE {err:.3e} of max|amp| <= 1e-12, trace "
          f"{trace!r}, purity {purity!r}")
    return {"vs_double": err, "trace": trace, "purity": purity}


def phase_quad(torch, qt, lk, kk, card):
    print(f"phase 17: the QUAD tier (double-double planes) on {card}")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"imperative": quad_imperative(torch, qt, lk, kk, card),
           "brickwork": quad_brickwork(torch, qt, lk, kk, card),
           "sweep": quad_sweep(torch, qt, lk, kk, card),
           "density": quad_density(torch, qt, lk, kk, card)}
    wall = time.perf_counter() - t0
    # the brickwork and the sweep reset the peak for their own figures;
    # the phase's peak is the largest of them and of what came after
    peak = max(torch.cuda.max_memory_allocated() / 2**30,
               out["imperative"]["peak_gib"], out["sweep"]["peak_gib"],
               *(r["peak_gib"] for r in out["brickwork"].values()))
    check(wall <= 120.0 and peak <= 60e9 / 2**30,
          f"phase 17: {wall:.1f} s <= 120 s, peak {peak:.2f} GiB <= 60 GB")
    print(f"  phase 17: {wall:.1f} s, peak memory {peak:.2f} GiB")
    out["wall_s"] = wall
    return out


SERVE_QUBITS, SERVE_LAYERS, SERVE_TERMS = 16, 2, 24  # bench.py:2236's
SERVE_REQUESTS, SERVE_SHOTS = 1024, 64               # defaults
SERVE_SEQ_REQUESTS = 256       # 18a's sequential client: the trace's first,
#                                cut from 1024 for the script's time
SERVE_BATCH, SERVE_WAIT = 64, 5e-3
SERVE_CLIENTS, SERVE_SHOT_REQUESTS, SERVE_HELD = 8, 16, 8   # 18b
SERVE_TRAJ_REQUESTS, SERVE_TRAJ_T = 4, 128                   # 18c
SERVE_GRAD_REQUESTS = 8                                      # 18d
SERVE_DRILL_QUBITS = 12                                      # 18e


def serving_trace(qt, n: int, num_requests: int):
    """bench.py:2236's trace: the HEA, the 24-term Pauli sum of seed 2026
    and one parameter row per request, drawn in the JAX package's order."""
    rng = np.random.default_rng(2026)
    circ = hea_circuit(qt, n, SERVE_LAYERS)
    codes = rng.integers(0, 4, size=(SERVE_TERMS, n))
    coeffs = rng.normal(size=SERVE_TERMS)
    terms = [[(q, int(codes[t, q])) for q in range(n)]
             for t in range(SERVE_TERMS)]
    codes_flat = [int(c) for c in codes.reshape(-1)]
    pm = rng.uniform(0.0, 2.0 * np.pi,
                     size=(num_requests, len(circ.param_names)))
    return circ, terms, coeffs, codes_flat, pm


def serving_service(qt, env, **kwargs):
    return qt.createSimulationService(
        env, max_batch=SERVE_BATCH, max_wait_s=SERVE_WAIT,
        request_timeout_s=600.0, **kwargs)


def check_clean(stats, what: str) -> None:
    """No request of the path was retried, rejected, timed out, failed or
    fast-failed, and no program degraded: a failing kernel cannot hide
    behind the recovery path."""
    s = stats["service"]
    bad = {k: s[k] for k in ("retries", "rejected_queue_full",
                             "rejected_deadline", "rejected_quota",
                             "timeouts", "failed", "breaker_trips",
                             "breaker_fastfails", "executor_faults",
                             "degraded_dispatches") if s[k]}
    degraded = stats["resilience"]["degraded_programs"]
    check(not bad and not degraded,
          f"{what}: no retry, reject, timeout, failure or breaker trip "
          f"({bad or 'all 0'}), no degraded program ({degraded})")


def print_service(snap, what: str) -> None:
    print(f"  {what}: {snap['completed']} completed in {snap['batches']} "
          f"batches, occupancy {snap['batch_occupancy']:.2f}, coalesce "
          f"ratio {snap['coalesce_ratio']:.3f}, padded fraction "
          f"{snap['padded_fraction']:.3f}, p50/p99 latency "
          f"{snap['p50_latency_s'] * 1e3:.2f}/"
          f"{snap['p99_latency_s'] * 1e3:.2f} ms, retries "
          f"{snap['retries']}, rejects "
          f"{snap['rejected_queue_full'] + snap['rejected_deadline']}, "
          f"timeouts {snap['timeouts']}")


def serving_trace_phase(torch, qt, lk, kk, card):
    """18a and 18d: the JAX package's serving trace, sequential client and
    service; then one gradient batch through the same service."""
    from quest_tpu_torch.serve.metrics import ServiceMetrics
    n, N, shots = SERVE_QUBITS, SERVE_REQUESTS, SERVE_SHOTS
    circ, terms, coeffs, codes_flat, pm = serving_trace(qt, n, N)
    names, ham = circ.param_names, (terms, coeffs)
    is_sample = (np.arange(N) % 4) == 3
    env = qt.createQuESTEnv(seed=[2026])
    cc = circ.compile(env).precompile()
    print(f"18a: {N} requests ({int(is_sample.sum())} of {shots} shots, "
          f"{int((~is_sample).sum())} energies), {n}-qubit "
          f"{SERVE_LAYERS}-layer HEA ({cc.num_layers} layers, "
          f"{len(cc.plan.items)} ops), {SERVE_TERMS}-term Pauli sum")

    q = qt.createQureg(n, env)
    qt.initZeroState(q)
    cc.run(q, dict(zip(names, pm[0])))
    qt.calcExpecPauliSum(q, codes_flat, coeffs)
    qt.sampleOutcomes(q, shots)
    torch.cuda.synchronize()
    off_vals, off_lat = {}, []
    t0 = time.perf_counter()
    for i in range(SERVE_SEQ_REQUESTS):
        r0 = time.perf_counter()
        qt.initZeroState(q)
        cc.run(q, dict(zip(names, pm[i])))
        if is_sample[i]:
            qt.sampleOutcomes(q, shots)
        else:
            off_vals[i] = qt.calcExpecPauliSum(q, codes_flat, coeffs)
        off_lat.append(time.perf_counter() - r0)
    off_s = time.perf_counter() - t0
    off_lat.sort()
    # where a sequential request's time goes: 16 requests, part by part
    parts = np.zeros(3)
    for i in range(16):
        r0 = time.perf_counter()
        qt.initZeroState(q)
        cc.run(q, dict(zip(names, pm[i])))
        torch.cuda.synchronize()
        r1 = time.perf_counter()
        qt.calcExpecPauliSum(q, codes_flat, coeffs)
        r2 = time.perf_counter()
        qt.sampleOutcomes(q, shots)
        parts += (r1 - r0, r2 - r1, time.perf_counter() - r2)
    del q
    parts *= 1e3 / 16
    off_rate = SERVE_SEQ_REQUESTS / off_s
    print(f"  service off (sequential client): {off_rate:.1f} requests/s "
          f"({off_s:.2f} s), p50/p99 latency "
          f"{ServiceMetrics._pct(off_lat, 50.0) * 1e3:.2f}/"
          f"{ServiceMetrics._pct(off_lat, 99.0) * 1e3:.2f} ms; a request's "
          f"parts: initZeroState + run {parts[0]:.2f} ms, calcExpecPauliSum "
          f"{parts[1]:.2f} ms, sampleOutcomes {parts[2]:.2f} ms")

    svc = serving_service(qt, env, max_queue=N + SERVE_BATCH)
    n_exp, n_smp = int((~is_sample).sum()), int(is_sample.sum())
    for count, kw in ((n_exp, {"observables": ham}),
                      (n_smp, {"shots": shots})):
        sizes = {min(SERVE_BATCH, count)} | (
            {count % SERVE_BATCH} if count % SERVE_BATCH else set())
        svc.warm(cc, batch_sizes=sorted(sizes - {0}), **kw)
    torch.cuda.synchronize()
    reset_counts(lk, kk)
    svc.pause()
    t0 = time.perf_counter()
    futs = [svc.submit(cc, pm[i], shots=shots) if is_sample[i]
            else svc.submit(cc, pm[i], observables=ham) for i in range(N)]
    svc.resume()
    results = [f.result(timeout=600) for f in futs]
    on_s = time.perf_counter() - t0
    single, batched, kraus = counts(lk, kk)
    stats = svc.dispatch_stats()
    snap = stats["service"]
    on_rate = N / on_s
    print(f"  service on: {on_rate:.1f} requests/s ({on_s:.2f} s), "
          f"speedup {on_rate / off_rate:.2f}x over the sequential client")
    print_service(snap, "service on")
    check_clean(stats, "18a")
    check(batched > 0 and single == 0 and kraus == 0,
          f"18a launched the batched layer kernel {batched} times "
          f"(single-state {single}, Kraus {kraus})")
    exp_idx = np.flatnonzero(~is_sample)
    got = np.array([results[i] for i in exp_idx], dtype=np.float64)
    seq_idx = sorted(off_vals)
    seq = np.array([off_vals[i] for i in seq_idx])
    scale = float(np.abs(got).max())
    dev_seq = float(np.abs(np.array([results[i] for i in seq_idx])
                           - seq).max()) / scale
    check(dev_seq <= 1e-5, f"service energies vs the sequential client "
          f"({len(seq_idx)} requests): {dev_seq:.3e} of max|E| "
          f"{scale:.3e} <= 1e-5")
    # the service dispatched each kind FIFO in batches of 64: the same
    # rows through the engine directly, batch for batch
    direct = np.concatenate([
        cc.expectation_sweep(pm[exp_idx[s:s + SERVE_BATCH]], ham)
        for s in range(0, len(exp_idx), SERVE_BATCH)])
    dev_direct = float(np.abs(got - direct).max()) / scale
    check(dev_direct <= 1e-6, f"service energies vs direct "
          f"expectation_sweep of the same batches: {dev_direct:.3e} of "
          f"max|E| <= 1e-6")
    norm_dev = max(abs(results[i][1] - 1.0)
                   for i in np.flatnonzero(is_sample))
    shapes = all(results[i][0].shape == (shots,)
                 for i in np.flatnonzero(is_sample))
    check(shapes and norm_dev <= 1e-5,
          f"{n_smp} shot requests of ({shots},) outcomes, total norm "
          f"within {norm_dev:.2e} of 1 (<= 1e-5)")

    # the same trace at pipeline_depth 2, then at 1 again (one card, in
    # turns): the completion thread copies results off the device while
    # the dispatcher launches the next batch
    rates = {}
    for depth in (2, 1):
        other = serving_service(qt, env, max_queue=N + SERVE_BATCH,
                                pipeline_depth=depth)
        other.pause()
        t0 = time.perf_counter()
        ofuts = [other.submit(cc, pm[i], shots=shots) if is_sample[i]
                 else other.submit(cc, pm[i], observables=ham)
                 for i in range(N)]
        other.resume()
        ores = [f.result(timeout=600) for f in ofuts]
        rates[depth] = N / (time.perf_counter() - t0)
        ostats = other.dispatch_stats()
        other.close()
        check_clean(ostats, f"18a at pipeline_depth {depth}")
        odev = max(abs(ores[i] - results[i]) for i in exp_idx) / scale
        check(odev <= 1e-6, f"pipeline_depth {depth} energies vs depth 1: "
              f"{odev:.3e} of max|E| <= 1e-6")
    print(f"  pipeline_depth 2: {rates[2]:.1f} requests/s, depth 1 again "
          f"{rates[1]:.1f} (first {on_rate:.1f}); depth 2 / mean depth 1 "
          f"{2 * rates[2] / (rates[1] + on_rate):.3f}")

    # 18d: one gradient batch through the same service
    G = SERVE_GRAD_REQUESTS
    svc.warm(cc, batch_sizes=[G], observables=ham, gradient=True)
    torch.cuda.synchronize()
    reset_counts(lk, kk)
    svc.pause()
    t0 = time.perf_counter()
    gfuts = [svc.submit(cc, pm[i], observables=ham, gradient=True)
             for i in range(G)]
    svc.resume()
    gres = [f.result(timeout=600) for f in gfuts]
    grad_s = time.perf_counter() - t0
    g_single, g_batched, g_kraus = counts(lk, kk)
    gstats = svc.dispatch_stats()
    svc.close()
    vals, grads = cc.value_and_grad_sweep(pm[:G], ham)
    got_g = np.stack([g for _, g in gres])
    got_v = np.array([v for v, _ in gres])
    g_dev = float(np.abs(got_g - grads).max()) / float(np.abs(grads).max())
    v_dev = float(np.abs(got_v - vals).max()) / float(np.abs(vals).max())
    print(f"18d: {G} gradient requests ({len(names)} parameters) in "
          f"{grad_s:.2f} s, one batch: batched layer launches {g_batched}")
    check_clean(gstats, "18d")
    check(gstats["service"]["gradient_dispatches"] == 1
          and gstats["service"]["gradients_returned"] == G,
          f"18d coalesced {G} gradient requests into one dispatch")
    check(g_batched > 0 and g_single == 0 and g_kraus == 0,
          f"18d launched the batched layer kernel {g_batched} times")
    check(g_dev <= 1e-5 and v_dev <= 1e-5,
          f"gradients vs direct value_and_grad_sweep: {g_dev:.3e} of "
          f"max|g| (values {v_dev:.3e} of max|E|) <= 1e-5")
    return {"off_rate": off_rate, "on_rate": on_rate,
            "speedup": on_rate / off_rate, "depth2_rate": rates[2],
            "off_p50_s": ServiceMetrics._pct(off_lat, 50.0),
            "off_p99_s": ServiceMetrics._pct(off_lat, 99.0),
            "snap": {k: snap[k] for k in (
                "batches", "batch_occupancy", "coalesce_ratio",
                "padded_fraction", "p50_latency_s", "p99_latency_s")},
            "launches": batched, "grad_launches": g_batched,
            "dev_seq": dev_seq, "dev_direct": dev_direct,
            "grad_dev": g_dev, "grad_s": grad_s}


def serving_wide_phase(torch, qt, lk, kk, card):
    """18b: the service at the 24-qubit HEA cell, 8 client threads, the
    profiler at rate 1; then one batch held against the plain version."""
    import threading
    from quest_tpu_torch.telemetry import profile as tprof
    circ, terms, coeffs, _, pm = hea_problem(qt)
    n, ham = SWEEP_QUBITS, (terms, coeffs)
    env = qt.createQuESTEnv(seed=[2027])
    cc = circ.compile(env)
    svc = serving_service(qt, env)
    # a batch shape packs nothing of its own: one row warms the bucket 64
    svc.warm(cc, batch_sizes=[1], observables=ham)
    svc.warm(cc, batch_sizes=[1], shots=SERVE_SHOTS)
    tprof.configure(sample_rate=1.0, reset=True)
    torch.cuda.synchronize()
    reset_counts(lk, kk)
    energies = [None] * SWEEP_BATCH
    shots = [None] * SERVE_SHOT_REQUESTS
    errors = []

    def client(tid):
        try:
            mine = [(i, svc.submit(cc, pm[i], observables=ham))
                    for i in range(tid, SWEEP_BATCH, SERVE_CLIENTS)]
            mine_s = [(i, svc.submit(cc, pm[i], shots=SERVE_SHOTS))
                      for i in range(tid, SERVE_SHOT_REQUESTS,
                                     SERVE_CLIENTS)]
            for i, f in mine:
                energies[i] = f.result(timeout=600)
            for i, f in mine_s:
                shots[i] = f.result(timeout=600)
        except Exception as e:       # reported on the main thread
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(SERVE_CLIENTS)]
    # submitted while paused, so the batches are one of 64 energies and
    # one of 16 shots, the shapes the direct sweep below repeats
    svc.pause()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    while svc.dispatch_stats()["service"]["submitted"] < \
            SWEEP_BATCH + SERVE_SHOT_REQUESTS and not errors:
        time.sleep(1e-3)
    svc.resume()
    for t in threads:
        t.join(timeout=900)
    wide_s = time.perf_counter() - t0
    check(not errors and not any(t.is_alive() for t in threads),
          f"18b clients finished ({errors})")
    single, batched, kraus = counts(lk, kk)
    stats = svc.dispatch_stats()
    prof = stats["profile"]
    tprof.configure(sample_rate=0.0)
    N = SWEEP_BATCH + SERVE_SHOT_REQUESTS
    print(f"18b: {SWEEP_BATCH} energy and {SERVE_SHOT_REQUESTS} shot "
          f"requests from {SERVE_CLIENTS} client threads, {n}-qubit HEA: "
          f"{wide_s:.2f} s, {N / wide_s:.2f} requests/s")
    print_service(stats["service"], "service")
    check_clean(stats, "18b")
    check(batched > 0 and single == 0 and kraus == 0,
          f"18b launched the batched layer kernel {batched} times")
    keys = [k for k in prof["keys"].values() if k["site"] == "serve.execute"]
    check(len(keys) >= 2, f"profiler keys for both request kinds "
          f"({len(keys)})")
    frac = 0.0
    for k in keys:
        print(f"  profile {k['kind']} b{k['bucket']}: {k['count']} "
              f"dispatches, mean {k['mean_s'] * 1e3:.1f} ms, "
              f"{k['bytes_per_pass'] / 1e9:.1f} GB planned, achieved "
              f"{k['achieved_bytes_per_s'] / 1e9:.1f} GB/s, roofline_frac "
              f"{k['roofline_frac']:.4f} of {prof['peak_bytes_per_s']:.3g} "
              f"B/s ({prof['roofline_model']})")
        frac = max(frac, k["roofline_frac"])
    check(prof["peak_bytes_per_s"] == HBM_BYTES_PER_S and 0.0 < frac <= 1.05,
          f"roofline_frac {frac:.4f} in (0, 1.05] against "
          f"{prof['peak_bytes_per_s']:.3g} B/s")
    direct = cc.expectation_sweep(pm, ham)
    got = np.array(energies, dtype=np.float64)
    scale = float(np.abs(direct).max())
    dev = float(np.abs(got - direct).max()) / scale
    check(dev <= 1e-6, f"18b energies vs one direct expectation_sweep: "
          f"{dev:.3e} of max|E| {scale:.3e} <= 1e-6")
    norm_dev = max(abs(t - 1.0) for _, t in shots)
    check(all(idx.shape == (SERVE_SHOTS,) for idx, _ in shots)
          and norm_dev <= 1e-5, f"{SERVE_SHOT_REQUESTS} shot requests, "
          f"total norm within {norm_dev:.2e} of 1 (<= 1e-5)")
    # one more batch through the service with every batched layer launch
    # held against its plain version on the same input
    with HeldLayers(torch, lk, batched=True) as held:
        svc.pause()
        hf = [svc.submit(cc, pm[i], observables=ham)
              for i in range(SERVE_HELD)]
        svc.resume()
        held_e = np.array([f.result(timeout=600) for f in hf])
    svc.close()
    abs_err, rel = held.max_err()
    check(held.launches > 0 and rel <= 1e-5,
          f"18b held batch of {SERVE_HELD}: {held.launches} batched "
          f"layer launches vs apply_layer_batched_plain, max|diff| "
          f"{abs_err:.3e}, / max|plain| {rel:.3e} <= 1e-5")
    check(bool(np.isfinite(held_e).all()), "held batch energies finite")
    return {"rate": N / wide_s, "launches": batched + held.launches,
            "roofline_frac": frac, "dev": dev, "held_err": abs_err,
            "held_rel": rel}


def serving_trajectory_phase(torch, qt, lk, kk, card):
    """18c: trajectory requests on phase 9's circuit, against a direct
    expectation_batch from the same generator state."""
    n = TRAJ_QUBITS
    rng = np.random.default_rng(2110)
    circ = trajectory_circuit(qt, n, rng)
    ham = ([[(q, 3)] for q in range(n)], list(rng.normal(size=n)))
    env = qt.createQuESTEnv(seed=[7])
    svc = serving_service(qt, env)
    tp = svc.warm(circ, observables=ham, trajectories=SERVE_TRAJ_T)
    R = SERVE_TRAJ_REQUESTS
    qt.seedQuEST(env, [7])
    torch.cuda.synchronize()
    reset_counts(lk, kk)
    svc.pause()
    t0 = time.perf_counter()
    futs = [svc.submit(circ, None, observables=ham,
                       trajectories=SERVE_TRAJ_T) for _ in range(R)]
    svc.resume()
    res = [f.result(timeout=600) for f in futs]
    traj_s = time.perf_counter() - t0
    single, batched, kraus = counts(lk, kk)
    stats = svc.dispatch_stats()
    svc.close()
    qt.seedQuEST(env, [7])
    means, errs, _ = tp.expectation_batch(
        np.zeros((R, 0)), ham, SERVE_TRAJ_T, live_rows=R)
    got = np.array([m for m, _ in res])
    scale = float(np.abs(means).max())
    dev = float(np.abs(got - means).max()) / scale
    print(f"18c: {R} trajectory requests of {SERVE_TRAJ_T} trajectories "
          f"({n} qubits) in {traj_s:.2f} s, "
          f"{R * SERVE_TRAJ_T / traj_s:.1f} trajectories/s; launches: "
          f"batched layer {batched}, Kraus {kraus}")
    check_clean(stats, "18c")
    check(stats["service"]["trajectory_dispatches"] == 1,
          "18c coalesced the trajectory requests into one wave loop")
    check(kraus > 0 and single == 0,
          f"18c launched the Kraus kernel {kraus} times")
    check(dev <= 1e-5, f"trajectory energies vs direct expectation_batch "
          f"on the same generator state: {dev:.3e} of max|E| {scale:.3e} "
          f"<= 1e-5")
    return {"kraus": kraus, "layer": batched, "dev": dev,
            "traj_per_s": R * SERVE_TRAJ_T / traj_s}


def serving_drills(torch, qt, lk, kk, card):
    """18e: fault drills at 12 qubits on services of their own."""
    from quest_tpu_torch.ops import cuda_build
    from quest_tpu_torch.resilience import (FaultInjector, FaultSpec,
                                            NumericalFault,
                                            ResiliencePolicy, inject)
    from quest_tpu_torch.serve import CircuitBreakerOpen
    n, B = SERVE_DRILL_QUBITS, 8
    circ, terms, coeffs, _, pm = serving_trace(qt, n, B)
    ham = (terms, coeffs)
    env = qt.createQuESTEnv(seed=[12])
    cc = circ.compile(env)
    clean = cc.expectation_sweep(pm, ham)
    scale = float(np.abs(clean).max())

    def batch(svc):
        svc.pause()
        futs = [svc.submit(cc, pm[i], observables=ham) for i in range(B)]
        svc.resume()
        out = []
        for f in futs:
            try:
                out.append(f.result(timeout=120))
            except Exception as e:       # the drill reads the failure
                out.append(e)
        return out

    # no jitter: the retried requests re-form the clean run's batch
    svc = serving_service(qt, env, resilience=ResiliencePolicy(
        quarantine=False, backoff_jitter=0.0, seed=1))
    with inject(FaultInjector([FaultSpec("transient", site="serve.execute",
                                         at_calls=(0,))], seed=1)):
        res = batch(svc)
    snap = svc.dispatch_stats()["service"]
    ok = all(not isinstance(r, Exception) for r in res)
    dev = float(np.abs(np.array(res if ok else [np.nan]) - clean).max()) \
        / scale
    check(ok and snap["retries"] == B and snap["executor_faults"] == 1
          and dev <= 1e-6, f"18e transient: {snap['retries']} retries "
          f"after 1 executor fault, results vs a clean run {dev:.3e} of "
          f"max|E| <= 1e-6")
    with inject(FaultInjector([FaultSpec("nan", site="serve.execute",
                                         at_calls=(0,))], seed=2)):
        res = batch(svc)
    bad = [i for i, r in enumerate(res) if isinstance(r, NumericalFault)]
    good = [i for i, r in enumerate(res) if not isinstance(r, Exception)]
    dev = max((abs(res[i] - clean[i]) for i in good), default=np.nan) \
        / scale
    check(len(bad) == 1 and len(good) == B - 1 and dev <= 1e-6,
          f"18e NaN row: request {bad} failed with NumericalFault, "
          f"{len(good)} batchmates completed ({dev:.3e} of max|E|)")
    svc.close()

    svc = serving_service(qt, env, max_retries=0, resilience=ResiliencePolicy(
        quarantine=False, breaker_threshold=1, breaker_cooldown_s=600.0))
    with inject(FaultInjector([FaultSpec("transient", site="serve.execute",
                                         at_calls=(0,))], seed=3)):
        first = svc.submit(cc, pm[0], observables=ham)
        try:
            first.result(timeout=120)
        except Exception:            # the injected fault, counted below
            pass
        second = svc.submit(cc, pm[1], observables=ham)
        try:
            second.result(timeout=120)
            fast_failed = False
        except CircuitBreakerOpen:
            fast_failed = True
    snap = svc.dispatch_stats()["service"]
    svc.close()
    check(fast_failed and snap["breaker_trips"] == 1
          and snap["breaker_fastfails"] == 1,
          f"18e breaker: tripped {snap['breaker_trips']} time(s), the next "
          f"request fast-failed typed ({fast_failed})")

    launch = lk.apply_layer_batched
    refused = {"calls": 0}

    def refuse(*args, **kwargs):
        refused["calls"] += 1
        raise cuda_build.KernelLaunchError(
            "layer kernel launch failed: refused (drill)")

    def forbidden(*args, **kwargs):
        raise SmokeFailure("a plain version ran on the card")

    plain = lk.apply_layer_batched_plain
    svc = serving_service(qt, env)
    lk.apply_layer_batched, lk.apply_layer_batched_plain = refuse, forbidden
    try:
        res = batch(svc)
    finally:
        lk.apply_layer_batched, lk.apply_layer_batched_plain = launch, plain
    snap = svc.dispatch_stats()["service"]
    svc.close()
    check(cc.num_layers > 0 and refused["calls"] >= 1
          and all(isinstance(r, cuda_build.KernelLaunchError) for r in res)
          and snap["failed_fatal"] == B and snap["retries"] == 0,
          f"18e refused launch: {B} requests failed with the launch error "
          f"(fatal {snap['failed_fatal']}, retries {snap['retries']})")
    print(f"18e: drills at {n} qubits passed (transient retried, NaN row "
          "quarantined, breaker fast-fail, refused launch fatal)")


def phase_serving(torch, qt, lk, kk, card):
    print(f"phase 18: the serving runtime on {card}, max_batch "
          f"{SERVE_BATCH}, max_wait_s {SERVE_WAIT}, complex64")
    t0 = time.perf_counter()
    trace = serving_trace_phase(torch, qt, lk, kk, card)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    wide = serving_wide_phase(torch, qt, lk, kk, card)
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    traj = serving_trajectory_phase(torch, qt, lk, kk, card)
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    serving_drills(torch, qt, lk, kk, card)
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    print(f"phase 18 wall time {wall:.1f} s: 18a+18d {t1 - t0:.1f}, 18b "
          f"{t2 - t1:.1f}, 18c {t3 - t2:.1f}, 18e "
          f"{time.perf_counter() - t3:.1f}")
    check(wall <= 120.0, f"phase 18 wall time {wall:.1f} s <= 120 s")
    by_path = {"18a": trace["launches"], "18b": wide["launches"],
               "18c": traj["layer"], "18d": trace["grad_launches"]}
    print(f"  serving launches: batched layer {by_path}, Kraus (18c) "
          f"{traj['kraus']}")
    return {"layer_launches": sum(by_path.values()),
            "launches_by_path": by_path, "kraus_launches": traj["kraus"],
            "on_rate": trace["on_rate"], "off_rate": trace["off_rate"],
            "depth2_rate": trace["depth2_rate"],
            "roofline_frac": wide["roofline_frac"],
            "held_err": wide["held_err"], "wall_s": wall}


ROUTER_REQUESTS, ROUTER_BATCH = 512, 32        # bench.py:2812's defaults
ROUTER_REPLICAS, ROUTER_SEED, ROUTER_HELD = 2, 2028, 4
OPT_ITERS, OPT_FAULT_AT, OPT_LR = 10, 5, 0.05               # 19b
OPT_TRAJECTORIES, OPT_TRAJ_ITERS, OPT_DAMP = 128, 2, 0.02
CKPT_QUAD_QUBITS, CKPT_SEGMENTS = 12, 4                     # 19d
CKPT_SWEEP_ROWS, CKPT_SWEEP_SEGMENT = 32, 16


def router_trace(qt, n: int):
    """bench.py:2812's trace: the HEA, the 24-term Pauli sum of seed 2028
    and one parameter row per request, drawn in the JAX package's
    order."""
    rng = np.random.default_rng(ROUTER_SEED)
    circ = hea_circuit(qt, n, SERVE_LAYERS)
    codes = rng.integers(0, 4, size=(SERVE_TERMS, n))
    coeffs = rng.normal(size=SERVE_TERMS)
    terms = [[(q, int(codes[t, q])) for q in range(n)]
             for t in range(SERVE_TERMS)]
    pm = rng.uniform(0.0, 2.0 * np.pi,
                     size=(ROUTER_REQUESTS, len(circ.param_names)))
    return circ, (terms, coeffs), pm


def wait_until(pred, timeout: float = 60.0) -> bool:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.01)
    return False


def router_phase(torch, qt, lk, kk, card, tmp):
    """19a: the replicated-serving cell, clean and with a replica killed,
    then restart-to-ready against an empty and a populated warm cache."""
    from quest_tpu_torch.resilience import SupervisorPolicy
    from quest_tpu_torch.serve import (ServiceRouter, WarmCache,
                                       replica_envs)
    n, N = SERVE_QUBITS, ROUTER_REQUESTS
    circ, ham, pm = router_trace(qt, n)
    names = circ.param_names
    buckets = [1 << k for k in range(ROUTER_BATCH.bit_length())]
    oracle_env = qt.createQuESTEnv(seed=[ROUTER_SEED])
    want = circ.compile(oracle_env).expectation_sweep(pm, ham)
    scale = float(np.abs(want).max())
    cache = WarmCache(f"{tmp}/warm")
    sup = SupervisorPolicy(poll_s=0.01, stall_timeout_s=10.0,
                           restart_backoff_s=0.02)
    print(f"19a: {N} requests, {n}-qubit {SERVE_LAYERS}-layer HEA, "
          f"{SERVE_TERMS}-term Pauli sum, {ROUTER_REPLICAS} replicas on "
          f"{card}, max_batch {ROUTER_BATCH}, buckets {buckets}")
    runs = {}
    for label, kill_at in (("clean", None), ("kill", N // 2)):
        router = ServiceRouter(
            replica_envs(ROUTER_REPLICAS, seed=[ROUTER_SEED]),
            supervisor=sup, warm_cache=cache, max_batch=ROUTER_BATCH,
            max_wait_s=SERVE_WAIT, max_queue=N + ROUTER_BATCH,
            request_timeout_s=600.0, max_retries=4)
        router.warm(circ, batch_sizes=buckets, observables=ham)
        torch.cuda.synchronize()
        reset_counts(lk, kk)
        t0 = time.perf_counter()
        futs = []
        for i in range(N):
            if kill_at is not None and i == kill_at:
                router._replicas[0].service._debug_crash()
            futs.append(router.submit(circ, dict(zip(names, pm[i])),
                                      observables=ham))
        outcomes = []
        for f in futs:
            try:
                outcomes.append(("ok", float(f.result(timeout=600))))
            except Exception as e:        # a typed failure, counted below
                outcomes.append((type(e).__name__, None))
        wall = time.perf_counter() - t0
        single, batched, kraus = counts(lk, kk)
        if kill_at is not None:
            check(wait_until(lambda: router.metrics.snapshot()[
                "readmissions"] >= 1), "19a: the killed replica was "
                "restarted, probed and readmitted")
        held = None
        if kill_at is not None:
            with HeldLayers(torch, lk, batched=True) as held:
                hf = [router.submit(circ, dict(zip(names, pm[i])),
                                    observables=ham)
                      for i in range(ROUTER_HELD)]
                held_e = np.array([f.result(timeout=600) for f in hf])
        stats = router.dispatch_stats()
        router.close()
        r = stats["router"]
        dropped = sum(k == "TimeoutError" for k, _ in outcomes)
        typed = sum(k not in ("ok", "TimeoutError") for k, _ in outcomes)
        got = np.array([v if v is not None else np.nan
                        for _, v in outcomes])
        dev = float(np.nanmax(np.abs(got - want))) / scale
        runs[label] = {"rate": N / wall, "p99_s": r["p99_latency_s"],
                       "launches": batched, "dev": dev}
        print(f"  {label}: {N / wall:.1f} requests/s ({wall:.2f} s) on "
              f"{card}, p99 {r['p99_latency_s'] * 1e3:.1f} ms, failovers "
              f"{r['failovers']}, quarantines {r['replica_quarantines']}, "
              f"restarts {r['replica_restarts']}, readmissions "
              f"{r['readmissions']}, dropped {dropped}, typed failures "
              f"{typed}, batched layer launches {batched}")
        check(dropped == 0 and typed == 0, f"19a {label}: no dropped "
              f"({dropped}) and no failed ({typed}) request")
        check(dev <= 1e-5, f"19a {label}: energies vs one direct "
              f"expectation_sweep {dev:.3e} of max|E| {scale:.3e} <= 1e-5")
        check(batched > 0 and single == 0 and kraus == 0,
              f"19a {label} launched the batched layer kernel {batched} "
              f"times (single {single}, Kraus {kraus})")
        if kill_at is not None:
            check(r["failovers"] >= 1 and r["replica_quarantines"] >= 1
                  and r["replica_restarts"] >= 1
                  and r["readmissions"] >= 1,
                  "19a kill: failover, quarantine, restart, readmission")
            abs_err, rel = held.max_err()
            check(held.launches > 0 and rel <= 1e-5
                  and bool(np.isfinite(held_e).all()),
                  f"19a held batch of {ROUTER_HELD}: {held.launches} "
                  f"batched layer launches vs apply_layer_batched_plain, "
                  f"max|diff| {abs_err:.3e}, / max|plain| {rel:.3e} <= "
                  "1e-5")
            runs[label].update(held_launches=held.launches,
                               held_err=abs_err, restarts=r[
                                   "replica_restarts"],
                               failovers=r["failovers"])
    restart = {}
    for label, root in (("cold", f"{tmp}/cold"), ("warm", f"{tmp}/warm")):
        packs = lk._operands.packs
        cache_s = [0.0]
        wc = WarmCache(root)
        warm_form = wc.warm_form

        def timed_warm_form(*args, **kwargs):
            t = time.perf_counter()
            try:
                return warm_form(*args, **kwargs)
            finally:
                cache_s[0] += time.perf_counter() - t

        wc.warm_form = timed_warm_form
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc = qt.createSimulationService(
            qt.createQuESTEnv(seed=[ROUTER_SEED]), max_batch=ROUTER_BATCH,
            max_wait_s=SERVE_WAIT, warm_cache=wc)
        svc.warm(circ, batch_sizes=buckets, observables=ham)
        torch.cuda.synchronize()
        ready = time.perf_counter() - t0
        snap = svc.metrics.snapshot()
        svc.close()
        restart[label] = {"ready_s": ready, "cache_s": cache_s[0],
                          "hits": snap["warm_cache_hits"],
                          "misses": snap["warm_cache_misses"],
                          "packs": lk._operands.packs - packs}
        print(f"  restart-to-ready, {label} cache: {ready:.3f} s on {card}"
              f" ({cache_s[0]:.3f} s of it in the cache's warm_form), "
              f"{restart[label]['hits']} hits, "
              f"{restart[label]['misses']} misses, "
              f"{restart[label]['packs']} layers packed")
    cold, warm = restart["cold"], restart["warm"]
    check(cold["misses"] == len(buckets) and cold["hits"] == 0
          and cold["packs"] > 0, "19a cold restart: every bucket a miss")
    check(warm["hits"] == len(buckets) and warm["misses"] == 0
          and warm["packs"] == 0, "19a warm restart: every bucket a hit, "
          "nothing packed")
    print(f"  warm restart speedup {cold['ready_s'] / warm['ready_s']:.2f}x")
    return {"runs": runs, "restart": restart,
            "launches": runs["clean"]["launches"]
            + runs["kill"]["launches"],
            "held_launches": runs["kill"]["held_launches"],
            "held_err": runs["kill"]["held_err"]}


def optimizer_phase(torch, qt, lk, kk, card, tmp):
    """19b: service.optimize on serving-grad-16q's HEA, a resumed run,
    and a noisy objective through the trajectory gradient."""
    from quest_tpu_torch.resilience import FaultInjector, FaultSpec, inject
    n = SERVE_QUBITS
    circ, terms, coeffs, _, pm = serving_trace(qt, n, 1)
    ham = (terms, coeffs)
    env = qt.createQuESTEnv(seed=[2029])
    svc = serving_service(qt, env)
    cc = svc.warm(circ, batch_sizes=[1], observables=ham, gradient=True)
    seen = []
    submit = svc.submit

    def recording(circuit, params=None, **kwargs):
        fut = submit(circuit, params, **kwargs)
        seen.append(fut)
        return fut

    svc.submit = recording
    problem = qt.createVariationalProblem(circ, ham, pm[0])
    kw = dict(max_iters=OPT_ITERS, tol=0.0, learning_rate=OPT_LR)
    torch.cuda.synchronize()
    reset_counts(lk, kk)
    t0 = time.perf_counter()
    handle = svc.optimize(problem, "adam", **kw)
    clean = list(handle.iterates())
    res = handle.result(timeout=600)
    wall = time.perf_counter() - t0
    single, batched, kraus = counts(lk, kk)
    svc.submit = submit
    got = [f.result(timeout=600) for f in seen]
    xs = np.stack([it["x"] for it in clean])
    vals, grads = cc.value_and_grad_sweep(xs, ham)
    g_dev = max(float(np.abs(g - grads[i]).max())
                for i, (_, g) in enumerate(got)) / float(
                    np.abs(grads).max())
    v_dev = max(abs(v - vals[i]) for i, (v, _) in enumerate(got)) \
        / float(np.abs(vals).max())
    print(f"19b: Adam, {len(clean)} iterates of {len(circ.param_names)} "
          f"parameters in {wall:.2f} s on {card} ({wall / OPT_ITERS * 1e3:.1f}"
          f" ms an iterate), value {clean[0]['value']:.6f} -> "
          f"{clean[-1]['value']:.6f}; batched layer launches {batched}")
    check(len(clean) == OPT_ITERS and res["iterations"] == OPT_ITERS,
          f"19b ran {len(clean)} iterates")
    check(batched > 0 and single == 0 and kraus == 0,
          f"19b launched the batched layer kernel {batched} times")
    check(g_dev <= 1e-5 and v_dev <= 1e-5, f"19b iterates vs direct "
          f"value_and_grad_sweep: {g_dev:.3e} of max|g| (values "
          f"{v_dev:.3e} of max|E|) <= 1e-5")

    path = f"{tmp}/opt.npz"
    reset_counts(lk, kk)
    fault = FaultInjector([FaultSpec("transient", site="serve.optimize",
                                     at_calls=(OPT_FAULT_AT,))], seed=1)
    with inject(fault):
        h = svc.optimize(problem, "adam", checkpoint_path=path,
                         max_restarts=0, **kw)
        first = list(h.iterates())
    failed = h.exception
    h = svc.optimize(problem, "adam", checkpoint_path=path, **kw)
    second = list(h.iterates())
    resumed = h.result(timeout=600)
    r_batched = counts(lk, kk)[1]
    both = first + second
    same = len(both) == OPT_ITERS and all(
        a["value"] == b["value"] and np.array_equal(a["x"], b["x"])
        for a, b in zip(both, clean))
    print(f"  checkpointed run: killed at iterate {len(first)} "
          f"({type(failed).__name__}), resumed from iterate "
          f"{resumed['resumed_from']}: {len(both)} iterates, equal to the "
          f"clean run bit for bit: {same}")
    check(failed is not None and len(first) == OPT_FAULT_AT
          and resumed["resumed_from"] == OPT_FAULT_AT - 1 and same,
          "19b resume after the fault equals the clean run bit for bit")

    noisy = hea_circuit(qt, n, SERVE_LAYERS)
    for q in range(n):
        noisy.damp(q, OPT_DAMP)
    reset_counts(lk, kk)
    with HeldKraus(torch, kk) as held:
        t0 = time.perf_counter()
        h = svc.optimize(qt.createVariationalProblem(
            noisy, ham, pm[0], trajectories=OPT_TRAJECTORIES), "adam",
            max_iters=OPT_TRAJ_ITERS, tol=0.0, learning_rate=OPT_LR)
        traj = list(h.iterates())
        h.result(timeout=600)
        traj_s = time.perf_counter() - t0
    errs = held.errs
    t_batched = lk.apply_layer_batched.launches
    stats = svc.dispatch_stats()
    svc.close()
    k_err = max((e[0] for e in errs), default=0.0)
    k_rel = max((e[1] for e in errs), default=0.0)
    print(f"  noisy objective ({OPT_TRAJECTORIES} trajectories, damp "
          f"{OPT_DAMP} on every qubit): {len(traj)} iterates in "
          f"{traj_s:.2f} s on {card}; Kraus launches {held.launches}, "
          f"batched layer {t_batched}; each Kraus launch vs "
          f"fused_kraus_apply_batched_plain max|diff| {k_err:.3e}, / "
          f"max|plain| {k_rel:.3e}")
    check_clean(stats, "19b")
    check(len(traj) == OPT_TRAJ_ITERS and held.launches > 0
          and t_batched > 0 and k_rel <= 1e-5
          and all(e[2] for e in errs)
          and all(np.isfinite(it["value"]) for it in traj),
          f"19b noisy objective: the Kraus kernel launched "
          f"{held.launches} times, each held against its plain version "
          f"(<= 1e-5, draws equal)")
    return {"launches": batched + r_batched + t_batched,
            "kraus_launches": held.launches, "kraus_err": k_err,
            "iterate_ms": wall / OPT_ITERS * 1e3, "grad_dev": g_dev,
            "traj_s": traj_s}


def dynamics_serving_phase(torch, qt, lk, kk, card, tmp):
    """19c: streamed evolve and a resumed ground-state search at 24
    qubits, batch 1."""
    from quest_tpu_torch.ops import dynamics as dyn
    from quest_tpu_torch.resilience import FaultInjector, FaultSpec, inject
    n = DYN_QUBITS
    circ, ham = dyn_prep(qt, n), tfim(n)
    params = np.random.default_rng(2030).uniform(0.0, np.pi, size=n)
    env = qt.createQuESTEnv(seed=[2030])
    svc = serving_service(qt, env)
    torch.cuda.synchronize()
    reset_counts(lk, kk)
    t0 = time.perf_counter()
    h = svc.evolve(circ, params, hamiltonian=ham, t=0.8, steps=8,
                   segment_steps=4)
    segs = list(h.iterates())
    res = h.result(timeout=600)
    evolve_s = time.perf_counter() - t0
    batched = counts(lk, kk)[1]
    cc = circ.compile(env)
    block = cc.evolve_sweep(params[None], ham,
                            dyn.EvolveSpec(t=0.8, steps=8, order=2))
    direct = dyn.unpack_evolve_block(block, n, 8)["energies"][0]
    direct = np.asarray(direct.cpu() if hasattr(direct, "cpu") else direct,
                        dtype=np.float64)
    scale = float(np.abs(direct).max())
    dev = float(np.abs(res["energies"] - direct).max()) / scale
    print(f"19c: evolve t=0.8 in 8 steps as {len(segs)} segments at {n} "
          f"qubits in {evolve_s:.2f} s on {card}; energies vs one direct "
          f"evolve_sweep {dev:.3e} of max|E|; batched layer launches "
          f"{batched}")
    check(len(segs) == 2 and res["steps"] == 8 and dev <= 1e-6,
          f"19c evolve: 2 segments, energies vs direct {dev:.3e} <= 1e-6")
    check(batched > 0, f"19c launched the batched layer kernel {batched} "
          "times")
    kw = dict(hamiltonian=ham, max_segments=4, tol=1e-12)
    t0 = time.perf_counter()
    h = svc.ground_state(circ, params, **kw)
    list(h.iterates())
    clean = h.result(timeout=600)
    ground_s = time.perf_counter() - t0
    path = f"{tmp}/ground.npz"
    with inject(FaultInjector([FaultSpec("transient", site="serve.evolve",
                                         at_calls=(2,))], seed=1)):
        h = svc.ground_state(circ, params, checkpoint_path=path,
                             max_restarts=0, **kw)
        first = list(h.iterates())
    failed = h.exception
    h = svc.ground_state(circ, params, checkpoint_path=path, **kw)
    second = list(h.iterates())
    res = h.result(timeout=600)
    stats = svc.dispatch_stats()
    svc.close()
    same = all(np.array_equal(res[k], clean[k])
               for k in ("planes", "energies", "welford")) \
        and res["residual"] == clean["residual"]
    print(f"  ground_state: {clean['segments']} segments in {ground_s:.2f}"
          f" s on {card}, energy {clean['energy']:.6f}, residual "
          f"{clean['residual']:.3e}; killed after segment {len(first)} "
          f"({type(failed).__name__}), resumed from "
          f"{res['resumed_from']}, equal bit for bit: {same}")
    check_clean(stats, "19c")
    check(failed is not None and len(first) == 2 and len(second) == 2
          and res["resumed_from"] == 1 and same,
          "19c ground_state resumed after segment 2 equals the "
          "uninterrupted run bit for bit")
    return {"launches": batched, "evolve_s": evolve_s,
            "ground_s": ground_s, "dev": dev}


def checkpoint_phase(torch, qt, lk, kk, card, tmp):
    """19d: register checkpoints, checkpointed_run and
    checkpointed_sweep."""
    from quest_tpu_torch import checkpoint as ckpt
    from quest_tpu_torch.ops import reductions as red
    from quest_tpu_torch.resilience import segments as seg
    n = SWEEP_QUBITS
    circ, terms, coeffs, _, pm = hea_problem(qt)
    env = qt.createQuESTEnv(seed=[2031])
    params = dict(zip(circ.param_names, pm[0]))
    q = qt.createQureg(n, env)
    qt.initZeroState(q)
    circ.compile(env).run(q, params)
    whole = q.state.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save(q, f"{tmp}/reg24")
    back = qt.createQureg(n, env)
    ckpt.load(back, f"{tmp}/reg24")
    torch.cuda.synchronize()
    io_s = time.perf_counter() - t0
    same = torch.equal(back.state.view(torch.int32),
                       whole.view(torch.int32))
    quad_env = qt.createQuESTEnv(precision=qt.QUAD, seed=[2031])
    qq = qt.createQureg(CKPT_QUAD_QUBITS, quad_env)
    qt.initDebugState(qq)
    qt.hadamard(qq, 3)
    ckpt.save(qq, f"{tmp}/quad12")
    qb = qt.createQureg(CKPT_QUAD_QUBITS, quad_env)
    ckpt.load(qb, f"{tmp}/quad12")
    quad_same = qb.state.shape[0] == 4 and torch.equal(
        qb.state.view(torch.int32), qq.state.view(torch.int32))
    print(f"19d: a {n}-qubit register saved and loaded in {io_s:.2f} s on "
          f"{card} ({whole.numel() * whole.element_size() / 2**20:.0f} "
          f"MiB), bit for bit: {same}; a {CKPT_QUAD_QUBITS}-qubit QUAD "
          f"register: {quad_same}")
    check(same and quad_same, "19d checkpoints round-trip bit for bit")

    reset_counts(lk, kk)
    seg_q = qt.createQureg(n, env)
    qt.initZeroState(seg_q)
    t0 = time.perf_counter()
    stats = seg.checkpointed_run(circ, seg_q, params,
                                 num_segments=CKPT_SEGMENTS,
                                 ckpt_dir=f"{tmp}/segs")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    single = lk.apply_layer.launches
    plain_q = qt.createQureg(n, env)
    qt.initZeroState(plain_q)
    for part in seg.split_circuit(circ, CKPT_SEGMENTS):
        part.compile(env).run(plain_q, params)
    seg_same = torch.equal(seg_q.state.view(torch.int32),
                           plain_q.state.view(torch.int32))
    amp_dev = float((seg_q.state - whole).abs().max()
                    / whole.abs().max())
    print(f"  checkpointed_run in {stats['segments']} segments, "
          f"{stats['checkpoints']} snapshots, {run_s:.2f} s on {card}: "
          f"equal to the segments run plainly bit for bit: {seg_same}; "
          f"vs the whole circuit's run {amp_dev:.3e} of max|amp|; layer "
          f"kernel launches {single}")
    check(seg_same and amp_dev <= 1e-5 and stats["restarts"] == 0,
          "19d checkpointed_run equals the plain run of its segments")

    circ16, terms16, coeffs16, _, pm16 = serving_trace(
        qt, SERVE_QUBITS, CKPT_SWEEP_ROWS)
    cc16 = circ16.compile(env)
    reset_counts(lk, kk)
    t0 = time.perf_counter()
    planes, sweep_stats = seg.checkpointed_sweep(
        cc16, pm16, segment_rows=CKPT_SWEEP_SEGMENT,
        ckpt_path=f"{tmp}/sweep.npz")
    sweep_s = time.perf_counter() - t0
    batched = counts(lk, kk)[1]
    operands = cc16._pauli_operands((terms16, coeffs16))
    got = red.pauli_sum_total_sv(
        torch.from_numpy(planes).to(env.device), *operands).cpu().numpy()
    want = cc16.expectation_sweep(pm16, (terms16, coeffs16))
    dev = float(np.abs(got - want).max()) / float(np.abs(want).max())
    print(f"  checkpointed_sweep of {CKPT_SWEEP_ROWS} rows in "
          f"{sweep_stats['segments']} segments ({SERVE_QUBITS} q) in "
          f"{sweep_s:.2f} s on {card}: energies vs one expectation_sweep "
          f"{dev:.3e} of max|E|; batched layer launches {batched}")
    check(sweep_stats["segments"] == CKPT_SWEEP_ROWS // CKPT_SWEEP_SEGMENT
          and dev <= 1e-6 and batched > 0,
          "19d checkpointed_sweep within 1e-6 of max|E|, batched launches")
    return {"launches": batched, "single_launches": single,
            "run_s": run_s, "io_s": io_s, "sweep_dev": dev}


def phase_serving_rest(torch, qt, lk, kk, card):
    import shutil
    import tempfile
    from quest_tpu_torch.testing import lockcheck
    print(f"phase 19: the rest of serving on {card}, complex64, under the "
          "port's lock-order check")
    tmp = tempfile.mkdtemp(prefix="quest_tpu_torch_smoke19_")
    was = lockcheck.installed()
    lockcheck.install()
    before = len(lockcheck.violations())
    t0 = time.perf_counter()
    try:
        router = router_phase(torch, qt, lk, kk, card, tmp)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        opt = optimizer_phase(torch, qt, lk, kk, card, tmp)
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        dyn = dynamics_serving_phase(torch, qt, lk, kk, card, tmp)
        torch.cuda.empty_cache()
        t3 = time.perf_counter()
        ck = checkpoint_phase(torch, qt, lk, kk, card, tmp)
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        new = lockcheck.violations()[before:]
        if not was:
            lockcheck.uninstall()
    wall = time.perf_counter() - t0
    print(f"phase 19 wall time {wall:.1f} s on {card}: 19a {t1 - t0:.1f}, "
          f"19b {t2 - t1:.1f}, 19c {t3 - t2:.1f}, 19d "
          f"{time.perf_counter() - t3:.1f}")
    check(not new and lockcheck.find_cycle() is None,
          f"phase 19 lock order: {len(new)} violations "
          f"({[str(v) for v in new[:2]]})")
    check(wall <= 120.0, f"phase 19 wall time {wall:.1f} s <= 120 s")
    by_path = {"19a": router["launches"] + router["held_launches"],
               "19b": opt["launches"], "19c": dyn["launches"],
               "19d": ck["launches"]}
    print(f"  launches: batched layer {by_path}, Kraus (19b) "
          f"{opt['kraus_launches']}, layer kernel (19d checkpointed_run) "
          f"{ck['single_launches']}")
    return {"layer_launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "kraus_launches": opt["kraus_launches"],
            "kraus_err": opt["kraus_err"],
            "single_launches": ck["single_launches"],
            "held_err": router["held_err"],
            "router_rates": {k: v["rate"]
                             for k, v in router["runs"].items()},
            "router_p99": {k: v["p99_s"]
                           for k, v in router["runs"].items()},
            "restart": router["restart"], "wall_s": wall}


NET_QUBITS, NET_LAYERS, NET_TERMS = SERVE_QUBITS, 1, 8   # bench.py:3219's
NET_REQUESTS, NET_BATCH, NET_WAIT, NET_WORKERS = 256, 32, 5e-3, 32
NET_SEED, NETCHAOS_SEED, NETCHAOS_RATE = 2026, 2028, 0.02    # :3374's
NETCHAOS_REQUESTS = 64         # :3374's own count when its time is short
NET_HELD, NET_OPT_ITERS, NET_OPT_CUT = 8, 4, 3                # 20c
NET_TRAJ_T = 128


def net_trace(qt, n: int, seed: int, num_requests: int = NET_REQUESTS):
    """bench.py:3219's trace: the 1-layer HEA, an 8-term Pauli sum and one
    parameter row per request, drawn in the JAX package's order."""
    rng = np.random.default_rng(seed)
    circ = hea_circuit(qt, n, NET_LAYERS)
    codes = rng.integers(0, 4, size=(NET_TERMS, n))
    coeffs = rng.normal(size=NET_TERMS)
    ham = ([[(q, int(codes[t, q])) for q in range(n)]
            for t in range(NET_TERMS)], coeffs)
    pm = rng.uniform(0.0, 2.0 * np.pi,
                     size=(num_requests, len(circ.param_names)))
    return circ, ham, pm


class RecordingBackend:
    """The backend a phase-20 server stands on: it passes every call to
    the service and keeps each submitted request's future under its
    parameter row and kind, so the phase holds each wire result against
    the value the backend's future resolved with."""

    def __init__(self, svc):
        self._svc = svc
        self.futures = {}

    @staticmethod
    def key(params, kw) -> tuple:
        kind = ("trajectory" if kw.get("trajectories") is not None
                else "expectation" if kw.get("observables") is not None
                else "sweep")
        return kind, tuple(sorted((params or {}).items()))

    def submit(self, circuit, params=None, **kw):
        fut = self._svc.submit(circuit, params, **kw)
        self.futures.setdefault(self.key(params, kw), []).append(fut)
        return fut

    def __getattr__(self, name):
        return getattr(self._svc, name)


def host_f64(x) -> np.ndarray:
    """A result as float64 host numpy (a card tensor copied off first)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def bits_equal(a, b) -> bool:
    a, b = host_f64(a), host_f64(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def timed_futures(submit, count: int):
    """Submit ``count`` requests through ``submit(i)`` and wait for them:
    (results, wall seconds, per-request latencies from submit to done)."""
    import threading
    lat = [0.0] * count
    lock = threading.Lock()
    t0 = time.perf_counter()
    futs = []
    for i in range(count):
        s = time.perf_counter()
        f = submit(i)

        def done(_, i=i, s=s):
            with lock:
                lat[i] = time.perf_counter() - s
        f.add_done_callback(done)
        futs.append(f)
    out = []
    for f in futs:
        try:
            out.append(("ok", f.result(timeout=600)))
        except Exception as e:        # the phase reads the failure
            out.append((e, None))
    return out, time.perf_counter() - t0, sorted(lat)


def batch_dependence(cc, pm, ham):
    """Whether a row's f32 result depends on its batchmates: one row run
    alone, with 31 mates, and with 31 others, as an energy and as
    planes. Returns (independent, description)."""
    mates = np.vstack([pm[:1], pm[128:159]])
    e = [host_f64(cc.expectation_sweep(m, ham))[0]
         for m in (pm[:1], pm[:32], mates)]
    p = [host_f64(cc.sweep(m)[0]) for m in (pm[:1], pm[:32], mates)]
    e_same = [bits_equal(e[0], x) for x in e[1:]]
    p_same = [bits_equal(p[0], x) for x in p[1:]]
    dev = max(abs(e[0] - x) for x in e[1:])
    return all(e_same + p_same), (
        f"energy alone vs 2 batches of 32 bit-equal {e_same} (max|diff| "
        f"{dev:.3e}), planes {p_same}")


def net_service(qt, env, **kwargs):
    return qt.createSimulationService(
        env, max_batch=NET_BATCH, max_wait_s=NET_WAIT,
        request_timeout_s=600.0, **kwargs)


def wire_cell(torch, qt, lk, kk, card):
    """20a: bench.py:3219's wire cell at 16 qubits, in-process then through
    the loopback socket, every wire result held against its future. The
    timed passes create their locks outside the lock-order check, as
    bench.py:3210 does: their number is the production path's cost."""
    from quest_tpu_torch.netserve import NetClient, NetServer
    from quest_tpu_torch.serve.metrics import ServiceMetrics
    from quest_tpu_torch.testing import lockcheck
    n, N = NET_QUBITS, NET_REQUESTS
    circ, ham, pm = net_trace(qt, n, NET_SEED)
    names = circ.param_names
    is_sweep = (np.arange(N) % 4) == 3
    env = qt.createQuESTEnv(seed=[NET_SEED])
    cc = circ.compile(env)
    independent, dep = batch_dependence(cc, pm, ham)
    print(f"20a: {N} requests ({int(is_sweep.sum())} sweep, "
          f"{int((~is_sweep).sum())} expectation), {n}-qubit "
          f"{NET_LAYERS}-layer HEA, {NET_TERMS}-term Pauli sum, max_batch "
          f"{NET_BATCH}, {NET_WORKERS} client workers; batch composition: "
          f"{dep}")
    svc = net_service(qt, env, max_queue=N + NET_BATCH)
    for count, kw in ((int((~is_sweep).sum()), {"observables": ham}),
                      (int(is_sweep.sum()), {})):
        sizes = {min(NET_BATCH, count)} | (
            {count % NET_BATCH} if count % NET_BATCH else set())
        svc.warm(circ, batch_sizes=sorted(sizes - {0}), **kw)

    def kwargs(i):
        return {} if is_sweep[i] else {"observables": ham}

    def params(i):
        return dict(zip(names, (float(x) for x in pm[i])))

    torch.cuda.synchronize()
    reset_counts(lk, kk)
    with lockcheck.suspended():
        res_in, in_s, in_lat = timed_futures(
            lambda i: svc.submit(circ, params(i), **kwargs(i)), N)
    in_launches = counts(lk, kk)
    proxy = RecordingBackend(svc)
    with lockcheck.suspended(), NetServer(proxy,
                                          trace_sample_rate=1.0) as srv:
        with NetClient(srv.host, srv.port, max_workers=NET_WORKERS) as cl:
            cl.submit(circ, params(0), observables=ham).result(timeout=600)
            proxy.futures.clear()
            torch.cuda.synchronize()
            reset_counts(lk, kk)
            res_net, net_s, net_lat = timed_futures(
                lambda i: cl.submit(circ, params(i), **kwargs(i)), N)
            single, batched, kraus = counts(lk, kk)
        wm = srv.metrics.snapshot()
        spans = {"parse": 0.0, "queue": 0.0, "dispatch": 0.0,
                 "serialize": 0.0}
        for ctx in srv.tracer.finished():
            for sp in ctx.to_dict()["spans"]:
                if sp["name"] in spans and sp["duration_s"]:
                    spans[sp["name"]] += sp["duration_s"]
    stats = svc.dispatch_stats()
    failed = [repr(k) for k, _ in res_in + res_net if k != "ok"]
    check(not failed, f"20a every request answered ({failed[:3]})")
    check_clean(stats, "20a")
    check(batched > 0 and single == 0 and kraus == 0 and in_launches[1] > 0,
          f"20a launched the batched layer kernel {batched} times through "
          f"the wire ({in_launches[1]} in-process; single {single}, Kraus "
          f"{kraus})")
    # the wire adds no error: each result is its future's value, bit for
    # bit after the float64 cast
    unmatched, differ = 0, 0
    for i, (_, got) in enumerate(res_net):
        futs = proxy.futures.get(RecordingBackend.key(params(i), kwargs(i)))
        if not futs:
            unmatched += 1
            continue
        if not bits_equal(got, futs[0].result(timeout=600)):
            differ += 1
    check(unmatched == 0 and differ == 0,
          f"20a the wire adds no error: {N - unmatched - differ} of {N} "
          f"results equal their backend future's value bit for bit after "
          f"the float64 cast ({unmatched} unmatched, {differ} differ)")
    same = sum(bits_equal(a, b) for (_, a), (_, b) in zip(res_in, res_net))
    exp_idx = np.flatnonzero(~is_sweep)
    e_in = np.array([res_in[i][1] for i in exp_idx], dtype=np.float64)
    e_net = np.array([res_net[i][1] for i in exp_idx], dtype=np.float64)
    scale = float(np.abs(e_in).max())
    if independent:
        check(same == N, f"20a wire vs in-process: {same} of {N} rows "
              "bit-equal (a row's result does not depend on its "
              "batchmates, so the bar is bit-equality)")
        dev = 0.0
    else:
        sw_idx = np.flatnonzero(is_sweep)
        direct_e = np.concatenate([
            host_f64(cc.expectation_sweep(pm[exp_idx[s:s + NET_BATCH]], ham))
            for s in range(0, len(exp_idx), NET_BATCH)])
        dev = float(np.abs(e_net - direct_e).max()) / scale
        p_dev = 0.0
        for s in range(0, len(sw_idx), NET_BATCH):
            rows = sw_idx[s:s + NET_BATCH]
            direct_p = host_f64(cc.sweep(pm[rows]))
            got = np.stack([host_f64(res_net[i][1]) for i in rows])
            p_dev = max(p_dev, float(np.abs(got - direct_p).max())
                        / float(np.abs(direct_p).max()))
        check(dev <= 1e-6 and p_dev <= 1e-6,
              f"20a wire vs direct sweeps of the same rows: energies "
              f"{dev:.3e} of max|E|, planes {p_dev:.3e} of max|amp| <= "
              f"1e-6 ({same} of {N} rows bit-equal to in-process)")
    in_rate, net_rate = N / in_s, N / net_s
    ser = spans["parse"] + spans["serialize"]
    frac = ser / max(sum(spans.values()), 1e-12)
    pct = ServiceMetrics._pct
    print(f"  in-process: {in_rate:.1f} requests/s ({in_s:.2f} s), p50/p99 "
          f"{pct(in_lat, 50.0) * 1e3:.2f}/{pct(in_lat, 99.0) * 1e3:.2f} ms")
    print(f"  wire: {net_rate:.1f} requests/s ({net_s:.2f} s, "
          f"{net_rate / in_rate:.3f} of in-process), client p50/p99 "
          f"{pct(net_lat, 50.0) * 1e3:.2f}/{pct(net_lat, 99.0) * 1e3:.2f} "
          f"ms, server p50/p99 {wm['p50_request_s'] * 1e3:.2f}/"
          f"{wm['p99_request_s'] * 1e3:.2f} ms")
    print(f"  server spans over {N} requests: parse {spans['parse']:.3f} s, "
          f"queue {spans['queue']:.3f} s, dispatch {spans['dispatch']:.3f} "
          f"s, serialize {spans['serialize']:.3f} s: parse + serialize "
          f"{100.0 * frac:.2f}% of request handling; bytes in "
          f"{wm['bytes_in']}, out {wm['bytes_out']} (a {n}-q planes "
          f"result {wm['bytes_out'] / max(1, wm['requests_sweep']) / 1e6:.2f}"
          f" MB); {same} of {N} rows bit-equal to in-process; launches "
          f"{batched} (in-process {in_launches[1]})")
    return {"svc": svc, "env": env, "circ": circ, "ham": ham, "pm": pm,
            "independent": independent, "dep": dep,
            "launches": batched, "in_rate": in_rate, "net_rate": net_rate,
            "serialize_frac": frac, "bit_equal": same, "dev": dev}


def wire_chaos_cell(torch, qt, lk, kk, card, independent):
    """20b: bench.py:3374's wire-chaos cell at 16 qubits: the expectation
    trace fault-free, then under seeded wire faults (the timed passes
    outside the lock-order check, as in 20a)."""
    from quest_tpu_torch.netserve import NetClient, NetServer, WireError
    from quest_tpu_torch.resilience import FaultInjector, FaultSpec, faults
    from quest_tpu_torch.serve import ServeError
    from quest_tpu_torch.testing import lockcheck
    n, N = NET_QUBITS, NETCHAOS_REQUESTS
    circ, ham, pm = net_trace(qt, n, NETCHAOS_SEED, N)
    names = circ.param_names
    env = qt.createQuESTEnv(seed=[NETCHAOS_SEED])
    svc = net_service(qt, env, max_queue=N + NET_BATCH)
    svc.warm(circ, batch_sizes=[min(N, NET_BATCH)], observables=ham)

    def run(injector):
        with lockcheck.suspended(), NetServer(svc) as srv:
            with NetClient(srv.host, srv.port, max_workers=NET_WORKERS,
                           retries=6, backoff_s=0.02,
                           retry_seed=NETCHAOS_SEED) as cl:
                cl.submit(circ, dict(zip(names, pm[0])),
                          observables=ham).result(timeout=600)
                with faults.inject(injector) if injector is not None \
                        else contextlib.nullcontext():
                    out, dt, _ = timed_futures(
                        lambda i: cl.submit(
                            circ, dict(zip(names, (float(x) for x in pm[i]))),
                            observables=ham, timeout_s=600.0), N)
                stats = cl.stats
            return out, N / dt, stats, srv.metrics.snapshot(), \
                srv.dedup.snapshot()

    torch.cuda.synchronize()
    reset_counts(lk, kk)
    clean, clean_rate, _, _, clean_dd = run(None)
    per_kind = NETCHAOS_RATE / len(faults.WIRE_KINDS)
    inj = FaultInjector([FaultSpec(kind, site="netserve.request",
                                   probability=per_kind,
                                   at_calls=(2,) if kind == "conn_reset"
                                   else ())
                         for kind in faults.WIRE_KINDS],
                        seed=NETCHAOS_SEED, stall_s=0.01)
    chaos, chaos_rate, cstats, wm, dd = run(inj)
    single, batched, kraus = counts(lk, kk)
    stats = svc.dispatch_stats()
    svc.close()
    check(all(k == "ok" for k, _ in clean),
          "20b every fault-free request answered")
    failed = [(i, k) for i, (k, _) in enumerate(chaos) if k != "ok"]
    untyped = [repr(k) for _, k in failed
               if not isinstance(k, (WireError, ServeError))]
    completed = [i for i, (k, _) in enumerate(chaos) if k == "ok"]
    vals_c = np.array([clean[i][1] for i in completed])
    vals_x = np.array([chaos[i][1] for i in completed])
    scale = float(np.abs(np.array([v for _, v in clean])).max())
    same = int(sum(bits_equal(a, b) for a, b in zip(vals_c, vals_x)))
    dev = float(np.abs(vals_x - vals_c).max()) / scale if completed else 0.0
    fired = inj.snapshot()
    print(f"20b: {N} expectation requests over the wire, fault-free "
          f"{clean_rate:.1f} requests/s, under {100 * NETCHAOS_RATE:.0f}% "
          f"seeded wire faults {chaos_rate:.1f} requests/s (degradation "
          f"{100.0 * (1.0 - chaos_rate / clean_rate):.1f}%); "
          f"{fired['total_injected']} faults "
          f"{fired['injected_by_kind']}; client retries "
          f"{cstats['retries']}, resends {cstats['resends']}; dedup "
          f"replays {dd['replays']}, joins {dd['joins']}, double "
          f"dispatches {dd['double_dispatches']}; {len(completed)} "
          f"completed ({same} bit-equal to fault-free, max dev {dev:.3e} "
          f"of max|E|), {len(failed)} failed typed; launches {batched}")
    check(not untyped,
          f"20b every failed request failed typed ({untyped[:3]})")
    check(dd["double_dispatches"] == 0 and clean_dd["double_dispatches"] == 0,
          f"20b zero double dispatches ({dd['double_dispatches']})")
    check(fired["total_injected"] >= 1 and cstats["retries"] >= 1,
          "20b the faults fired and the client retried")
    if independent:
        check(same == len(completed), f"20b every completed chaos request "
              f"equals its fault-free value bit for bit ({same} of "
              f"{len(completed)})")
    else:
        check(dev <= 1e-6, f"20b completed chaos requests vs fault-free: "
              f"{dev:.3e} of max|E| <= 1e-6")
    check_clean(stats, "20b")
    check(batched > 0 and single == 0 and kraus == 0,
          f"20b launched the batched layer kernel {batched} times")
    return {"launches": batched, "clean_rate": clean_rate,
            "chaos_rate": chaos_rate, "retries": cstats["retries"],
            "resends": cstats["resends"], "replays": dd["replays"],
            "joins": dd["joins"], "failed": len(failed)}


def wire_streams(torch, qt, lk, kk, card, cell):
    """20c: a resumable optimizer stream, a trajectory request and an
    evolve stream over the wire, and one wire-dispatched batch of each
    kernel held against its plain version."""
    from quest_tpu_torch.netserve import NetClient, NetServer, wire
    from quest_tpu_torch.serve.optimize import VariationalProblem
    n = NET_QUBITS
    env = qt.createQuESTEnv(seed=[2029])
    svc = net_service(qt, env)
    proxy = RecordingBackend(svc)
    # phase 19b's problem: the 16-q 2-layer HEA and its 24-term sum
    circ, terms, coeffs, _, pm = serving_trace(qt, n, 1)
    ham = (terms, [float(c) for c in coeffs])
    x0 = dict(zip(circ.param_names, (float(x) for x in pm[0])))
    opt = {"name": "adam", "max_iters": NET_OPT_ITERS, "tol": 0.0,
           "learning_rate": OPT_LR}
    h = svc.optimize(VariationalProblem(circ, ham, x0), "adam",
                     max_iters=NET_OPT_ITERS, tol=0.0, learning_rate=OPT_LR)
    want = list(h.iterates())
    want_res = h.result(timeout=600)
    with NetServer(proxy) as srv:
        with NetClient(srv.host, srv.port) as cl:
            torch.cuda.synchronize()
            reset_counts(lk, kk)
            gen = cl.stream(circ, x0, observables=ham, optimizer=opt,
                            resumable=True)
            head = [next(gen) for _ in range(NET_OPT_CUT)]
            gen.close()                     # the client goes away
            rs = srv._streams[head[0]["stream"]]
            check(wait_until(lambda: not rs.attached()),
                  "20c the server saw the client go")
            tail = list(cl.resume_stream(head[0]["stream"],
                                         head[-1]["cursor"]))
            opt_launches = counts(lk, kk)[1]
            events = head + tail
            its = [e for e in events if e["event"] == "iterate"]
            (res,) = [e for e in events if e["event"] == "result"]
            exact = len(its) == len(want) and all(
                e["value"] == w["value"] and e["grad_norm"] == w["grad_norm"]
                and np.array_equal(np.array(e["x"]), w["x"])
                and e["iteration"] == w["iteration"]
                for e, w in zip(its, want)) \
                and np.array_equal(np.array(res["result"]["x"]),
                                   want_res["x"]) \
                and res["result"]["value"] == want_res["value"]
            cursors = [e["cursor"] for e in events]
            print(f"20c: optimizer stream ({NET_OPT_ITERS} Adam iterates of "
                  f"{len(x0)} parameters, 16-q HEA), cut after "
                  f"{NET_OPT_CUT} events and resumed from cursor "
                  f"{head[-1]['cursor']}: {len(events)} events, equal to the "
                  f"in-process handle by cursor bit for bit: {exact}; "
                  f"batched layer launches {opt_launches}")
            check(exact and cursors == list(range(len(events))),
                  "20c the resumed optimizer stream equals an uninterrupted "
                  "in-process run, event for event")
            check(srv.metrics.get("streams_resumed") == 1
                  and srv.metrics.get("stream_cancels") == 0,
                  "20c the stream resumed once and was never cancelled")

            # one trajectory request: its (mean, stderr) is its future's
            rng = np.random.default_rng(2110)
            tcirc = trajectory_circuit(qt, n, rng)
            tham = ([[(q, 3)] for q in range(n)],
                    [float(c) for c in rng.normal(size=n)])
            reset_counts(lk, kk)
            with HeldKraus(torch, kk) as held:
                got = cl.submit(tcirc, None, observables=tham,
                                trajectories=NET_TRAJ_T).result(timeout=600)
            kerrs = held.errs
            t_layer = lk.apply_layer_batched.launches
            (tfut,) = proxy.futures[("trajectory", ())]
            t_same = bits_equal(got, tfut.result(timeout=600))
            k_err = max((e[0] for e in kerrs), default=0.0)
            k_rel = max((e[1] for e in kerrs), default=0.0)
            print(f"  trajectory request ({NET_TRAJ_T} trajectories, {n} "
                  f"q): (mean, stderr) = ({got[0]:.6f}, {got[1]:.3e}), "
                  f"equal to the backend future's bit for bit: {t_same}; "
                  f"Kraus launches {held.launches}, each held against "
                  f"plain: max|diff| {k_err:.3e}, / max|plain| "
                  f"{k_rel:.3e}; batched layer {t_layer}")
            check(t_same and held.launches > 0 and k_rel <= 1e-5
                  and all(e[2] for e in kerrs),
                  "20c the wire trajectory request launched the Kraus "
                  "kernel, each launch held against plain, and returned "
                  "its future's value")

            # one wire-dispatched batch of the batched layer kernel held
            circ20, ham20, pm20 = cell["circ"], cell["ham"], cell["pm"]

            def row20(i):
                return dict(zip(circ20.param_names,
                                (float(x) for x in pm20[i])))

            # registered (and warmed) first, so the held batch is one
            # dispatch of the wire's requests
            cl.submit(circ20, row20(0), observables=ham20).result(
                timeout=600)
            s0 = svc.dispatch_stats()["service"]["submitted"]
            with HeldLayers(torch, lk, batched=True) as hl:
                svc.pause()
                hf = [cl.submit(circ20, row20(i), observables=ham20)
                      for i in range(NET_HELD)]
                queued = wait_until(lambda: svc.dispatch_stats()["service"][
                    "submitted"] >= s0 + NET_HELD)
                svc.resume()
                held_e = [f.result(timeout=600) for f in hf]
            check(queued, "20c the held batch's requests reached the queue")
            h_err, h_rel = hl.max_err()
            print(f"  held wire batch of {NET_HELD}: {hl.launches} batched "
                  f"layer launches vs apply_layer_batched_plain, max|diff| "
                  f"{h_err:.3e}, / max|plain| {h_rel:.3e}")
            check(hl.launches > 0 and h_rel <= 1e-5
                  and bool(np.isfinite(held_e).all()),
                  "20c the held wire batch agrees with the plain version")

            # one evolve stream against the in-process handle
            dcirc, dham = dyn_prep(qt, n), tfim(n)
            dpar = np.random.default_rng(2030).uniform(0.0, np.pi, size=n)
            dx = dict(zip(dcirc.param_names, (float(x) for x in dpar)))
            hd = svc.evolve(dcirc, dx, hamiltonian=dham, t=DYN_T,
                            steps=DYN_STEPS)
            dwant = list(hd.iterates())
            dres = hd.result(timeout=600)
            reset_counts(lk, kk)
            devents = list(cl.stream(dcirc, dx, observables=dham,
                                     evolve={"t": DYN_T, "steps": DYN_STEPS,
                                             "order": 2}))
            d_launches = counts(lk, kk)[1]
            segs = [e for e in devents if e["event"] == "segment"]
            (dfinal,) = [e for e in devents if e["event"] == "result"]
            d_same = len(segs) == len(dwant) and all(
                np.array_equal(np.array(e["energies"]), w["energies"])
                and np.array_equal(np.array(e["welford"]), w["welford"])
                and e["energy"] == w["energy"] for e, w in zip(segs, dwant)) \
                and np.array_equal(np.array(dfinal["result"]["planes"],
                                            dtype=np.float64),
                                   host_f64(dres["planes"]))
            print(f"  evolve stream (t={DYN_T}, {DYN_STEPS} steps, {n} q): "
                  f"{len(segs)} segment(s), segment blocks and final planes "
                  f"equal to the in-process handle's bit for bit: {d_same}; "
                  f"batched layer launches {d_launches}")
            check(d_same and d_launches > 0, "20c the evolve stream equals "
                  "the in-process run bit for bit")
    stats = svc.dispatch_stats()
    svc.close()
    check_clean(stats, "20c")
    return {"launches": opt_launches + t_layer + hl.launches + d_launches,
            "opt_launches": opt_launches, "kraus_launches": held.launches,
            "kraus_err": k_err, "held_err": h_err, "held_launches":
            hl.launches}


def wire_drain(torch, qt, lk, kk, card, cell, tmp):
    """20d: drain a server to its state file, restart on the same state
    and port, and serve circuit_ref submissions from the same client; then
    a refused launch under a wire request reaches the client fatal."""
    from quest_tpu_torch.netserve import NetClient, NetServer, WireError
    from quest_tpu_torch.ops import cuda_build
    svc, circ, ham, pm = cell["svc"], cell["circ"], cell["ham"], cell["pm"]
    names = circ.param_names
    state = f"{tmp}/netstate.json"

    def params(i):
        return dict(zip(names, (float(x) for x in pm[i])))

    reset_counts(lk, kk)
    srv1 = NetServer(svc, state_path=state)
    port = srv1.port
    cl = NetClient(srv1.host, port, retries=4, backoff_s=0.02)
    try:
        want = [cl.submit(circ, params(i), observables=ham).result(
            timeout=600) for i in range(4)]
        sid = cl.session
        summary = srv1.drain()
        srv1.close()
        srv2 = NetServer(svc, port=port, state_path=state)
        try:
            got = [cl.submit(circ, params(i), observables=ham).result(
                timeout=600) for i in range(4)]
            (row,) = [s for s in srv2.sessions.snapshot()
                      if s["session"] == sid]
            restored = srv2.restored
            m2 = srv2.metrics.snapshot()
        finally:
            srv2.close()
    finally:
        cl.close()
    single, batched, kraus = counts(lk, kk)
    stats = cl.stats
    same = all(bits_equal(a, b) for a, b in zip(want, got)) \
        if cell["independent"] else max(abs(a - b) for a, b in
                                         zip(want, got)) <= 1e-6
    print(f"20d: drained {summary['sessions']} session(s) and "
          f"{summary['programs']} program(s) to the state file; the "
          f"restarted server readmitted {restored}; the same client's 4 "
          f"circuit_ref submissions: {m2['program_hits']} registry hits, "
          f"{m2['program_misses']} misses, resends {stats['resends']}, "
          f"session reopens {stats['session_reopens']}, answers equal: "
          f"{same}; launches {batched}")
    check(summary["persisted"] and restored["sessions"] >= 1
          and restored["programs"] >= 1 and row["program_hits"] >= 4
          and m2["program_misses"] == 0 and stats["resends"] == 0
          and stats["session_reopens"] == 0 and len(got) == 4 and same,
          "20d drain and restart: sessions readmitted, zero UnknownProgram "
          "resends, zero dropped requests")

    launch, plain = lk.apply_layer_batched, lk.apply_layer_batched_plain
    refused = {"calls": 0}

    def refuse(*args, **kwargs):
        refused["calls"] += 1
        raise cuda_build.KernelLaunchError(
            "layer kernel launch failed: refused (drill)")

    def forbidden(*args, **kwargs):
        raise SmokeFailure("a plain version ran on the card")

    fsvc = net_service(qt, cell["env"])
    fatal = None
    with NetServer(fsvc) as srv, NetClient(srv.host, srv.port, retries=6,
                                           backoff_s=0.02) as fcl:
        lk.apply_layer_batched, lk.apply_layer_batched_plain = \
            refuse, forbidden
        try:
            fcl.submit(circ, params(5), observables=ham).result(timeout=600)
        except WireError as e:
            fatal = e
        finally:
            lk.apply_layer_batched, lk.apply_layer_batched_plain = \
                launch, plain
        fstats = fcl.stats
    snap = fsvc.dispatch_stats()["service"]
    fsvc.close()
    print(f"  refused launch under a wire request: client raised "
          f"{type(fatal).__name__} (HTTP {getattr(fatal, 'status', None)}): "
          f"{str(fatal)[:90]}; client retries {fstats['retries']}, fatal "
          f"failures {snap['failed_fatal']}")
    check(fatal is not None and fatal.status == 500
          and "KernelLaunchError" in str(fatal) and fstats["retries"] == 0
          and refused["calls"] >= 1 and snap["failed_fatal"] >= 1
          and snap["retries"] == 0,
          "20d a refused launch reached the client as the non-retryable "
          "server failure, with no retry")
    return {"launches": batched}


def phase_netserve(torch, qt, lk, kk, card):
    import shutil
    import tempfile
    from quest_tpu_torch.testing import lockcheck
    print(f"phase 20: the network front door on {card}, loopback, "
          "complex64, under the port's lock-order check")
    tmp = tempfile.mkdtemp(prefix="quest_tpu_torch_smoke20_")
    was = lockcheck.installed()
    lockcheck.install()
    before = len(lockcheck.violations())
    t0 = time.perf_counter()
    cell = None
    try:
        cell = wire_cell(torch, qt, lk, kk, card)
        t1 = time.perf_counter()
        chaos = wire_chaos_cell(torch, qt, lk, kk, card, cell["independent"])
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        streams = wire_streams(torch, qt, lk, kk, card, cell)
        torch.cuda.empty_cache()
        t3 = time.perf_counter()
        drain = wire_drain(torch, qt, lk, kk, card, cell, tmp)
    finally:
        if cell is not None:
            cell["svc"].close()
        shutil.rmtree(tmp, ignore_errors=True)
        new = lockcheck.violations()[before:]
        if not was:
            lockcheck.uninstall()
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    print(f"phase 20 wall time {wall:.1f} s on {card}: 20a {t1 - t0:.1f}, "
          f"20b {t2 - t1:.1f}, 20c {t3 - t2:.1f}, 20d "
          f"{time.perf_counter() - t3:.1f}")
    check(not new and lockcheck.find_cycle() is None,
          f"phase 20 lock order: {len(new)} violations "
          f"({[str(v) for v in new[:2]]})")
    check(wall <= 60.0, f"phase 20 wall time {wall:.1f} s <= 60 s")
    by_path = {"20a": cell["launches"], "20b": chaos["launches"],
               "20c": streams["launches"], "20d": drain["launches"]}
    print(f"  launches: batched layer {by_path}, Kraus (20c) "
          f"{streams['kraus_launches']}")
    return {"layer_launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "kraus_launches": streams["kraus_launches"],
            "kraus_by_path": {"20c": streams["kraus_launches"]},
            "kraus_err": streams["kraus_err"],
            "held_err": streams["held_err"],
            "rates": {"wire": cell["net_rate"],
                      "in_process": cell["in_rate"],
                      "chaos": chaos["chaos_rate"],
                      "chaos_fault_free": chaos["clean_rate"]},
            "serialize_frac": cell["serialize_frac"],
            "bit_equal": cell["bit_equal"],
            "independent": cell["independent"], "wall_s": wall}


def netserve_keys(net, kraus: bool = False):
    """Phase 20's keys: of the batched layer kernel's row (its launches on
    20a-20d, requests/s through the wire and in-process, the server's
    parse + serialize share) or of the Kraus kernel's (20c)."""
    if net is None:
        return {}
    if kraus:
        return {"launches_netserve": net["kraus_launches"],
                "netserve_launches_by_path": net["kraus_by_path"]}
    return {"launches_netserve": net["layer_launches"],
            "netserve_launches_by_path": net["launches_by_path"],
            "netserve_requests_per_s": net["rates"],
            "netserve_serialize_frac": net["serialize_frac"]}


def quad_keys(quad):
    """Phase 17's figures, as keys of the ``layer_kernel`` row (no kernel
    runs on the dd paths)."""
    # the digests are phase 23c's yardsticks, not figures
    b = {name: {k: v for k, v in row.items() if k != "digest"}
         for name, row in quad["brickwork"].items()}
    return {"quad": {
        "launches": 0,
        "brickwork": b,
        "sweep_points_per_s": quad["sweep"]["points_per_s"],
        "sweep_deviation": quad["sweep"]["deviation"],
        "density_vs_double": quad["density"]["vs_double"],
        "wall_s": quad["wall_s"]}}


def density_keys(density):
    """The density QFT's layer-kernel numbers, as keys of the
    ``layer_kernel`` row."""
    cell = density["qft"]
    by = cell["bound_by"]
    return {
        "launches_density": cell["launches"],
        "density_max_abs_err": cell["max_abs_err"],
        "density_ms": float(np.mean(cell["kernel_ms"])),
        "density_plain_ms": float(np.mean(cell["plain_ms"])),
        "density_bound_ms": float(np.mean(cell["bound_ms"])),
        "density_bound_by": max(set(by), key=by.count),
        # one complex64 broadcast multiply by each layer's merged diagonal
        "density_library_ms": float(np.mean(cell["library_ms"]))
        if cell["library_ms"] else None,
        "density_layer_ms": cell["kernel_ms"],
        "density_layer_library_ms": cell["library_ms"],
        "density_qft_ops_per_s": cell["ops_per_s"],
        "density_config4_ops_per_s": density["config4"]["ops_per_s"],
        "density_fast_launches": density["qft_fast"]["fast_launches"],
        "density_fast_max_abs_err": density["qft_fast"]["max_abs_err"],
        "density_qft_fast_ops_per_s": density["qft_fast"]["ops_per_s"],
        "density_fast_vs_single": density["qft_fast"]["fast_vs_single"],
    }


def diag_row(density):
    """The JSON row of the layer kernel's streaming entry for rowdiag-only
    layers, on its path: the density QFT's layers (phase 12a)."""
    cell = density["qft"]
    by = cell["bound_by"]
    return {
        "name": "layer_kernel_diag",
        "route": "cuda",
        "source": "quest_tpu_torch/csrc/layer_kernel.cu",
        # _layer_kernel, its rowdiag branch at :517-531
        "replaces": "quest_tpu/ops/pallas_kernels.py:297",
        "launches": cell["diag_launches"],
        "max_abs_err": cell["max_abs_err"],
        "ms": float(np.mean(cell["kernel_ms"])),
        "plain_ms": float(np.mean(cell["plain_ms"])),
        "bound_ms": float(np.mean(cell["bound_ms"])),
        "bound_by": max(set(by), key=by.count),
        # one complex64 broadcast multiply by each layer's merged diagonal
        "library_ms": float(np.mean(cell["library_ms"]))
        if cell["library_ms"] else None,
        "layer_ms": cell["kernel_ms"],
        "layer_library_ms": cell["library_ms"],
    }


def gradient_keys(grad, density_grad):
    """Phase 13's and 12d's numbers, as keys of the batched layer kernel's
    row: the gradient sweep's launches (forward and adjoint layers), its
    layers against their plain versions, points/s beside the energy
    sweep's, peak memory, and the adjoint layers' times over 2B states."""
    keys = {}
    if grad is not None:
        rows = grad["rows"]
        keys.update({
            "launches_gradient": grad["launches"],
            "gradient_max_abs_err": grad["max_abs_err"],
            "gradient_points_per_s": grad["points_per_s"],
            "gradient_energy_points_per_s": grad["energy_points_per_s"],
            "gradient_cost_in_energy_sweeps": grad["grad_per_energy"],
            "gradient_peak_bytes": grad["peak_bytes"],
            "gradient_fast_launches": grad["fast_launches"],
            "gradient_fast_max_diff": grad["fast_max_diff"],
            "gradient_fast_bound": grad["fast_bound"],
            "adjoint_layer_ms": [r[0] for r in rows],
            "adjoint_layer_bound_ms": [r[1] for r in rows],
            "adjoint_layer_plain_ms": [r[3] for r in rows],
            "adjoint_layer_library_ms": [r[4] for r in rows],
        })
    if density_grad is not None:
        keys.update({
            "density_gradient_points_per_s":
                density_grad["grad_points_per_s"],
            "density_energy_points_per_s":
                density_grad["energy_points_per_s"],
            "density_gradient_peak_bytes": density_grad["peak_bytes"],
        })
    return keys


def traj_gradient_keys(traj_grad, kraus: bool = False):
    """Phase 9g's numbers, as keys of the batched layer kernel's row (its
    launches forward and adjoint, the gradient and value loops' rates,
    the cost in value waves, peak memory, the adjoint layers over 2T) or,
    with ``kraus``, of the Kraus kernel's (its launches, forward with the
    index output and adjoint)."""
    if traj_grad is None:
        return {}
    if kraus:
        return {"launches_traj_gradient": traj_grad["launches_kraus"],
                "traj_gradient_max_abs_err": traj_grad["kraus_max_abs_err"]}
    rows = traj_grad["rows"]
    return {
        "launches_traj_gradient": traj_grad["launches_layer"],
        "traj_gradient_max_abs_err": traj_grad["max_abs_err"],
        "traj_gradient_s": traj_grad["seconds"],
        "traj_gradient_trajectories_per_s": traj_grad["traj_per_s"],
        "traj_value_trajectories_per_s": traj_grad["value_traj_per_s"],
        "traj_gradient_cost_in_value_waves":
            traj_grad["cost_in_value_waves"],
        "traj_gradient_peak_bytes": traj_grad["peak_bytes"],
        "traj_gradient_fd_rel_err": traj_grad["fd_rel"],
        "traj_gradient_card_vs_cpu_rel_err": traj_grad["cpu_rel"],
        "traj_adjoint_layer_ms": [r[0] for r in rows],
        "traj_adjoint_layer_bound_ms": [r[1] for r in rows],
        "traj_adjoint_layer_plain_ms": [r[3] for r in rows],
        "traj_adjoint_layer_library_ms": [r[4] for r in rows],
    }


def dynamics_keys(dynamics):
    """Phase 15's numbers, as keys of the batched layer kernel's row: its
    launches on the dynamics path (the prep programs, the gate-form twin,
    the 12-qubit copy), those held against plain, the step loop's rates
    and times, and peak memory."""
    if dynamics is None:
        return {}
    return {"launches_dynamics": dynamics["launches"],
            "dynamics_max_abs_err": dynamics["max_abs_err"],
            "dynamics_seconds": dynamics["seconds"],
            "dynamics_rotations_per_s": dynamics["rotations_per_s"],
            "dynamics_rotation_ms": dynamics["rotation_ms"],
            "dynamics_rotation_bound_ms": dynamics["rotation_bound_ms"],
            "dynamics_peak_bytes_evolve": dynamics["peak_bytes_evolve"],
            "dynamics_peak_bytes_lanczos": dynamics["peak_bytes_lanczos"]}


def algorithm_keys(algorithms):
    """Phase 16's numbers, as keys of the layer kernel's row."""
    return {"launches_algorithms": algorithms["launches"],
            "diag_launches_algorithms": algorithms["diag_launches"],
            "algorithms_max_abs_err": algorithms["max_abs_err"],
            "algorithms_seconds": algorithms["seconds"],
            "algorithms_gates_per_s": algorithms["gates_per_s"]}


def serving_keys(serving, kraus: bool = False):
    """The serving path's keys of the batched layer kernel's row (its
    launches on 18a, 18b and 18d, 18b's roofline share, the held batch's
    error) or of the Kraus kernel's row (its launches on 18c)."""
    if serving is None:
        return {}
    if kraus:
        return {"launches_serving": serving["kraus_launches"]}
    return {"launches_serving": serving["layer_launches"],
            "serving_launches_by_path": serving["launches_by_path"],
            "serving_requests_per_s": serving["on_rate"],
            "serving_sequential_requests_per_s": serving["off_rate"],
            "serving_depth2_requests_per_s": serving["depth2_rate"],
            "serving_roofline_frac": serving["roofline_frac"],
            "serving_held_max_abs_err": serving["held_err"]}


def serving_rest_keys(rest, kraus: bool = False, single: bool = False):
    """Phase 19's keys: of the batched layer kernel's row (its launches on
    19a-19d, the held 19a batch's error, the router's requests/s clean and
    with a replica killed, restart-to-ready cold and warm), of the Kraus
    kernel's (19b's noisy objective) or, with ``single``, of the layer
    kernel's (19d's checkpointed run)."""
    if rest is None:
        return {}
    if single:
        return {"launches_checkpointed_run": rest["single_launches"]}
    if kraus:
        return {"launches_serving_rest": rest["kraus_launches"],
                "serving_rest_max_abs_err": rest["kraus_err"]}
    restart = rest["restart"]
    return {"launches_serving_rest": rest["layer_launches"],
            "serving_rest_launches_by_path": rest["launches_by_path"],
            "serving_rest_held_max_abs_err": rest["held_err"],
            "router_requests_per_s": rest["router_rates"],
            "restart_to_ready_s": {k: v["ready_s"]
                                   for k, v in restart.items()}}


def kernel_rows(layer_row, sweep, traj, grad=None, density_grad=None,
                traj_grad=None, dynamics=None, serving=None,
                serving_rest=None, netserve=None):
    """The JSON rows of the batched layer kernel and the Kraus kernel."""
    rows = sweep["rows"] + traj["rows"] \
        + (traj_grad["rows"] if traj_grad is not None else [])
    libs = [r[4] for r in sweep["rows"] if r[4] is not None]
    by = [r[2] for r in rows]
    k_ms, k_bound, k_by, k_plain, k_lib, kerr = traj["kraus"]
    return [layer_row, {
        "name": "layer_kernel_batched",
        "route": "cuda",
        "source": "quest_tpu_torch/csrc/layer_kernel.cu",
        "replaces": "quest_tpu/ops/pallas_kernels.py:736",
        "launches": sweep["launches"] + traj["launches_layer"]
        + (grad["launches"] if grad is not None else 0)
        + (traj_grad["launches_layer"] if traj_grad is not None else 0)
        + (dynamics["launches"] if dynamics is not None else 0)
        + (serving["layer_launches"] if serving is not None else 0)
        + (serving_rest["layer_launches"] if serving_rest is not None
           else 0)
        + (netserve["layer_launches"] if netserve is not None else 0),
        "launches_sweep": sweep["launches"],
        "launches_trajectories": traj["launches_layer"],
        "max_abs_err": max([r[5] for r in rows] + (
            [dynamics["max_abs_err"]] if dynamics is not None else []) + (
            [serving["held_err"]] if serving is not None else []) + (
            [serving_rest["held_err"]] if serving_rest is not None
            else []) + (
            [netserve["held_err"]] if netserve is not None else [])),
        "ms": float(np.mean([r[0] for r in sweep["rows"]])),
        "plain_ms": float(np.mean([r[3] for r in sweep["rows"]])),
        "bound_ms": float(np.mean([r[1] for r in sweep["rows"]])),
        "bound_by": max(set(by), key=by.count),
        "library_ms": float(np.mean(libs)) if libs else None,
        "trajectory_layer_ms": [r[0] for r in traj["rows"]],
        "trajectory_layer_bound_ms": [r[1] for r in traj["rows"]],
        "points_per_s": sweep["points_per_s"],
        **gradient_keys(grad, density_grad),
        **traj_gradient_keys(traj_grad),
        **dynamics_keys(dynamics),
        **serving_keys(serving),
        **serving_rest_keys(serving_rest),
        **netserve_keys(netserve),
    }, {
        "name": "kraus_kernel",
        "route": "cuda",
        "source": "quest_tpu_torch/csrc/kraus_kernel.cu",
        "replaces": "quest_tpu/ops/pallas_kernels.py:888",
        "launches": traj["launches_kraus"]
        + (traj_grad["launches_kraus"] if traj_grad is not None else 0)
        + (serving["kraus_launches"] if serving is not None else 0)
        + (serving_rest["kraus_launches"] if serving_rest is not None
           else 0)
        + (netserve["kraus_launches"] if netserve is not None else 0),
        "launches_trajectories": traj["launches_kraus"],
        "max_abs_err": max([kerr] + (
            [traj_grad["kraus_max_abs_err"]] if traj_grad is not None
            else []) + ([serving_rest["kraus_err"]]
                        if serving_rest is not None else [])
            + ([netserve["kraus_err"]] if netserve is not None else [])),
        "ms": k_ms,
        "plain_ms": k_plain,
        "bound_ms": k_bound,
        "bound_by": k_by,
        "library_ms": k_lib,
        "trajectories_per_s": traj["traj_per_s"],
        **traj_gradient_keys(traj_grad, kraus=True),
        **serving_keys(serving, kraus=True),
        **serving_rest_keys(serving_rest, kraus=True),
        **netserve_keys(netserve, kraus=True),
    }]


def profile_device(torch, fn, what: str, top: int = 8, cpu: bool = True):
    """Where ``fn()`` spends the card's time: device time per kernel name
    from torch.profiler, and the device-busy share of the host wall time
    of the profiled call. ``cpu=False`` records device activity only: a
    call of tens of thousands of host ops otherwise takes the profiler
    over a minute to gather."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
        print(f"  {what}: device time not measured (the profiler saw no "
              "device events)")
        return
    print(f"  {what}: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms ({100.0 * busy_us / wall_us:.1f}%)")
    for name, (count, us) in sorted(per_name.items(),
                                    key=lambda kv: -kv[1][1])[:top]:
        print(f"  {us / 1e3:9.1f} ms {100.0 * us / busy_us:5.1f}% "
              f"x{count:<4d} {name[:90]}")


# ---------------------------------------------------------------------------
# phase 21: amplitude-sharded registers on a mesh of shards on the one card
# ---------------------------------------------------------------------------

MESH_SHARDS = 4                        # devices=["cuda:0"] * 4: s = 2
MESH_IMPERATIVE_QUBITS = 28
# 21c: the forced batch mode's rows and the pad-and-mask rows (the cell's
# 64 cut for time: each sweep of the cell takes ~14 s on the card)
MESH_BATCH_ROWS, MESH_PAD_ROWS = 8, 6


def mesh_env(qt, **kwargs):
    """Four amplitude shards on the one card (the env the phase runs
    on)."""
    return qt.createQuESTEnv(devices=["cuda:0"] * MESH_SHARDS, **kwargs)


class BatchMemLimit:
    """``QUEST_TPU_BATCH_MEM_BYTES`` set to ``value`` while open (None:
    unset), the variable the batch-sharding policy reads."""

    def __init__(self, value):
        self.value = value

    def __enter__(self):
        import os
        self.was = os.environ.get("QUEST_TPU_BATCH_MEM_BYTES")
        if self.value is None:
            os.environ.pop("QUEST_TPU_BATCH_MEM_BYTES", None)
        else:
            os.environ["QUEST_TPU_BATCH_MEM_BYTES"] = str(self.value)
        return self

    def __exit__(self, *exc):
        import os
        if self.was is None:
            os.environ.pop("QUEST_TPU_BATCH_MEM_BYTES", None)
        else:
            os.environ["QUEST_TPU_BATCH_MEM_BYTES"] = self.was


def chunk_err(chunks, whole) -> float:
    """max |chunk - the same slice of the whole planes| / max |whole|."""
    width = chunks[0].shape[-1]
    diff = max(float((c - whole[..., d * width:(d + 1) * width]).abs().max())
               for d, c in enumerate(chunks))
    return diff / float(whole.abs().max())


def print_exchanges(log, what: str) -> None:
    total_b = sum(r["bytes"] for r in log)
    total_ms = sum(r["ms"] for r in log)
    print(f"  {what}: {len(log)} exchanges, {total_b / 2**30:.3f} GiB "
          f"between shards, {total_ms:.1f} ms")
    for rec in log:
        print(f"    {rec['kind']:<14} k={rec['k']} "
              f"{rec['bytes'] / 2**20:9.1f} MiB {rec['ms']:8.2f} ms")


class ExchangePeaks:
    """While open, every ``exchange.run_exchange`` call (the compiled
    path's relayouts) is synchronised and measured: ``extra`` holds, per
    call, the device memory allocated at its peak beyond what was
    allocated when it began, ``k`` its exchanged bits."""

    def __init__(self, torch, ex):
        self.torch, self.ex, self.extra, self.k = torch, ex, [], []
        self.run = ex.run_exchange

    def __enter__(self):
        torch, run = self.torch, self.run

        def measured(chunks, plan, inplace=False):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out = run(chunks, plan, inplace)
            torch.cuda.synchronize()
            self.extra.append(torch.cuda.max_memory_allocated() - base)
            self.k.append(plan.k)
            return out

        self.ex.run_exchange = measured
        return self

    def __exit__(self, *exc):
        self.ex.run_exchange = self.run


def mesh_brickwork(torch, qt, lk, kk, card):
    from quest_tpu_torch.parallel import exchange as ex
    n = MAIN_QUBITS
    print(f"  21a: phase 4's {n}-qubit brickwork compiled on the mesh, "
          "from |+...+> (every chunk nonzero from the first layer on)")
    env8, env1 = mesh_env(qt), qt.createQuESTEnv()
    circ = as_circuit(qt, n, brickwork(n, MAIN_LAYERS))
    cc = circ.compile(env8)
    st = cc.dispatch_stats()
    relayouts = [it for it in cc.plan.items if it[0] == "relayout"]
    xshard = [it for it in cc.plan.items if it[0] == "xshard"]
    print(f"  plan: {len(cc.plan.items)} items, {cc.num_layers} layers on "
          f"{n - 2} local qubits, {st.relayouts} relayouts, "
          f"{st.cross_shard_exchanges} cross-shard 1q items, "
          f"{st.swaps_absorbed} SWAPs absorbed, {st.collectives_fused} "
          f"exchanges composed; modeled {st.comm_bytes_planned / 2**30:.3f}"
          f" GiB per run")
    for it in relayouts:
        moved = [int(b) for b, a in zip(it[1], it[2]) if b != a]
        print(f"    relayout moving positions {moved}")
    for it in xshard:
        print(f"    cross-shard item: op {it[1]} on position {it[2][0]}")
    q = qt.createQureg(n, env8)
    qt.initPlusState(q)
    register = 2 * 4 * (1 << n)
    chunk = register // MESH_SHARDS
    reset_counts(lk, kk)
    ex.reset_counts()
    with HeldLayers(torch, lk, batched=False) as held, \
            ExchangePeaks(torch, ex) as peaks:
        cc.run(q)
        torch.cuda.synchronize()
    err_abs, err_rel = held.max_err()
    worst = max(peaks.extra, default=0)
    check(len(peaks.extra) == st.relayouts and all(
        e <= chunk + (chunk >> k) for e, k in zip(peaks.extra, peaks.k)),
          f"each relayout's memory beside the register at most one chunk "
          f"and one block: {[f'{e / chunk:.2f}' for e in peaks.extra]} "
          f"chunks (k = {peaks.k}; chunk {chunk / 2**30:.0f} GiB)")
    check(held.launches == cc.num_layers * MESH_SHARDS > 0
          and err_rel <= 1e-5,
          f"layer kernel launched {held.launches} times for {cc.num_layers}"
          f" layers x {MESH_SHARDS} shards, each launch against its plain "
          f"version on its own chunk: max|diff| {err_abs:.3e}, / max|plain|"
          f" {err_rel:.3e} <= 1e-5")
    check(ex.COUNTS["relayouts"] == st.relayouts
          and ex.COUNTS["xshard"] == st.cross_shard_exchanges,
          f"exchanges run: {dict(ex.COUNTS)}")
    qt.initPlusState(q)
    reset_counts(lk, kk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ex.start_log()
    t0 = time.perf_counter()
    cc.run(q)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    log = ex.stop_log()
    launches = lk.apply_layer.launches
    print_exchanges(log, "timed run")
    extra = torch.cuda.max_memory_allocated() - base
    peak = register + extra
    print(f"  peak memory of the timed run {peak / 2**30:.2f} GiB: the "
          f"{register / 2**30:.0f} GiB register and {extra / chunk:.2f} "
          "chunks beside it (the gate engine's temporaries on a chunk; "
          f"the relayouts' at most {worst / chunk:.2f})")

    c1 = circ.compile(env1)
    q1 = qt.createQureg(n, env1)
    qt.initPlusState(q1)
    c1.run(q1)
    qt.initPlusState(q1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base1 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    c1.run(q1)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    extra1 = torch.cuda.max_memory_allocated() - base1
    print(f"  the single-device run's peak beside its register: "
          f"{extra1 / 2**30:.2f} GiB ({extra1 / chunk:.2f} chunks)")
    err = chunk_err(q.chunks, q1.state)
    check(err <= 1e-5, f"mesh planes vs the single-device run: max|diff| /"
          f" max|amp| {err:.3e} <= 1e-5; run {mesh_s:.3f} s on the mesh, "
          f"{single_s:.3f} s on one device")

    cco = circ.compile(env8, overlap=True)
    pairs = cco._overlap_pairs(cco.plan, cco._ops,
                               cco._exchange_plans(cco.plan))
    qo = qt.createQureg(n, env8)
    qt.initPlusState(qo)
    ex.reset_counts()
    cco.run(qo)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(qo.chunks, q.chunks))
    err_o = max(float((a - b).abs().max()) for a, b in
                zip(qo.chunks, q.chunks)) / float(q1.state.abs().max())
    check(same or err_o <= 1e-6,
          f"overlap=True ({len(pairs)} relayout+gate pairs, "
          f"{ex.COUNTS['overlapped']} run overlapped): "
          + ("bit for bit equal" if same else
             f"max|diff| / max|amp| {err_o:.3e} <= 1e-6 (the fused pairs' "
             "gates run on a slab's shape)"))
    del qo
    torch.cuda.empty_cache()

    ccf = circ.compile(env8, tier="fast")
    qf = qt.createQureg(n, env8)
    qt.initPlusState(qf)
    with HeldLayers(torch, lk, batched=False) as held_f:
        ccf.run(qf)
        torch.cuda.synchronize()
    fast_launches = held_f.held.fast_launches
    f_abs, f_rel = held_f.max_err()
    bound = qt.modeled_tier_error(qt.FAST_TIER, len(circ.ops))
    err_f = chunk_err(qf.chunks, q1.state)
    check(fast_launches == ccf.num_layers * MESH_SHARDS > 0
          and f_rel <= 1e-5 and err_f <= bound,
          f"tier fast on the mesh: {fast_launches} FAST launches held "
          f"against their FAST plain versions (max|diff| / max|plain| "
          f"{f_rel:.3e}); planes vs single-device SINGLE {err_f:.3e} <= "
          f"modeled {bound:.3e}")
    return {"launches": launches, "fast_launches": fast_launches,
            "held_err": max(err_abs, f_abs), "mesh_s": mesh_s,
            "single_s": single_s, "exchanges": len(log),
            "exchange_bytes": sum(r["bytes"] for r in log),
            "exchange_ms": sum(r["ms"] for r in log),
            "peak_gib": peak / 2**30,
            "exchange_peak_chunks": worst / chunk}


def mesh_imperative(torch, qt, lk, kk, card):
    from quest_tpu_torch.parallel import exchange as ex
    from quest_tpu_torch.parallel import pergate as pg
    from quest_tpu_torch.parallel.sampling import sample_sharded
    n = MESH_IMPERATIVE_QUBITS
    print(f"  21b: tests/test_distributed.py's gates on a {n}-qubit mesh "
          "register against one device")
    env8, env1 = mesh_env(qt, seed=[77]), qt.createQuESTEnv(seed=[77])
    q1 = qt.createQureg(n, env1)
    # a random state drawn on the card (2^29 numbers: on the host they
    # would take most of the sub-phase)
    planes = q1.state
    planes.normal_(generator=torch.Generator(device=env1.device)
                   .manual_seed(5))
    planes.div_(torch.linalg.vector_norm(planes))
    width = (1 << n) // MESH_SHARDS
    q8 = qt.createQureg(n, env8)
    q8.chunks = [q1.state[:, d * width:(d + 1) * width].clone()
                 for d in range(MESH_SHARDS)]
    u = random_unitary(np.random.default_rng(9), 4)
    ex.reset_counts()
    relayouts0 = pg.RELAYOUT_COUNT
    for q in (q8, q1):
        qt.hadamard(q, 0)
        qt.hadamard(q, n - 1)
        qt.controlledNot(q, 0, n - 1)
        qt.controlledNot(q, n - 1, 1)
        qt.rotateY(q, n - 2, 0.7)
        qt.tGate(q, n - 1)
        qt.multiRotateZ(q, [0, n - 1], 0.3)
        qt.swapGate(q, 1, n - 1)
        qt.twoQubitUnitary(q, 2, n - 1, u)
        qt.multiControlledPhaseFlip(q, [0, n - 2, n - 1])
    torch.cuda.synchronize()
    check(q8.layout is not None and tuple(q8.layout) != tuple(range(n)),
          f"the SWAP stayed layout metadata: {pg.RELAYOUT_COUNT - relayouts0}"
          f" relayout(s), {ex.COUNTS['xshard']} cross-shard 1q exchanges, "
          f"{ex.COUNTS['bytes'] / 2**30:.3f} GiB between shards")
    scale = float(q1.state.abs().max())
    for index in (0, 1, 1 << (n - 1), 12345678 % (1 << n), (1 << n) - 1):
        a8, a1 = qt.getAmp(q8, index), qt.getAmp(q1, index)
        check(abs(a8 - a1) <= 1e-5 * scale,
              f"getAmp({index}) under the permuted layout: {a8:.6g} vs "
              f"{a1:.6g}")
    t8, t1 = qt.calcTotalProb(q8), qt.calcTotalProb(q1)
    p8, p1 = qt.calcProbOfOutcome(q8, n - 1, 1), \
        qt.calcProbOfOutcome(q1, n - 1, 1)
    check(abs(t8 - t1) <= 1e-5 and abs(p8 - p1) <= 1e-5,
          f"calcTotalProb {t8!r} vs {t1!r}; calcProbOfOutcome(q{n - 1}=1) "
          f"{p8!r} vs {p1!r}")
    c8, c1 = qt.collapseToOutcome(q8, n - 1, 1), \
        qt.collapseToOutcome(q1, n - 1, 1)
    qt.seedQuEST(env8, [5])
    qt.seedQuEST(env1, [5])
    m8 = [qt.measure(q8, k) for k in (2, n - 2, 5)]
    m1 = [qt.measure(q1, k) for k in (2, n - 2, 5)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    q8.ensure_canonical()                    # one relayout exchange
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    check(extra <= 2 * 4 * width,
          f"the canonicalising exchange's scratch {extra / 2**20:.1f} MiB "
          f"<= one chunk ({2 * 4 * width / 2**20:.0f} MiB)")
    err = chunk_err(q8.chunks, q1.state)
    check(abs(c8 - c1) <= 1e-5 and m8 == m1 and err <= 1e-5,
          f"collapseToOutcome {c8!r} vs {c1!r}; measure on the same "
          f"uniforms {m8} vs {m1}; planes max|diff| / max|amp| {err:.3e} "
          "<= 1e-5")
    u = torch.rand(1 << 16, generator=torch.Generator().manual_seed(3),
                   dtype=torch.float64)
    _, total = sample_sharded(q8.chunks, u, False, n, n - 2)
    check(abs(total - 1.0) <= 1e-5, f"sample_sharded shot total {total!r}")
    return {"relayouts": pg.RELAYOUT_COUNT - relayouts0}


def mesh_sweeps(torch, qt, lk, kk, card, sweep=None):
    """``sweep``: phase 8's result when it ran, whose energies are this
    cell's single-device sweep (the same circuit, parameters, seed and
    tier on the same card); else that sweep runs here."""
    import os
    import warnings
    circ, terms, coeffs, _, pm = hea_problem(qt)
    ham = (terms, coeffs)
    n, batch = SWEEP_QUBITS, pm.shape[0]
    print(f"  21c: phase 8's {n}-qubit HEA expectation_sweep, batch {batch}"
          ", on the mesh, every batched layer launch held against its plain "
          "version on its own input")
    env8 = mesh_env(qt, seed=[2026])
    if sweep is not None:
        ref, single_s = sweep["energies"], sweep["sweep_ms"] / 1e3
        print(f"  the single-device energies: phase 8's sweep "
              f"({single_s:.2f} s)")
    else:
        env1 = qt.createQuESTEnv(seed=[2026])
        t0 = time.perf_counter()
        ref = circ.compile(env1).expectation_sweep(pm, ham)
        single_s = time.perf_counter() - t0
    cc = circ.compile(env8)
    pol = cc._batch_policy(batch)
    print(f"  choose_batch_sharding at batch {batch}: {pol}")
    scale = float(np.abs(ref).max())
    out = {"launches": 0, "single_s": single_s, "held_err": 0.0}
    was = os.environ.get("QUEST_TPU_BATCH_MEM_BYTES")
    for label, limit, rows in (("policy", was, batch),
                               ("batch", 1 << 40, MESH_BATCH_ROWS),
                               ("amp", 1, batch),
                               ("pad", 1 << 40, MESH_PAD_ROWS)):
        if label == "amp" and pol["mode"] == "amp":
            continue      # the policy's own run was the amp mode's
        with BatchMemLimit(limit):
            reset_counts(lk, kk)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught, \
                    HeldLayers(torch, lk, batched=True) as held:
                warnings.simplefilter("always")
                vals = cc.expectation_sweep(pm[:rows], ham)
            secs = time.perf_counter() - t0
            mode = cc.dispatch_stats().batch_sharding_mode
            launches = held.launches
            h_abs, h_rel = held.max_err()
            out["launches"] += launches
            out["held_err"] = max(out["held_err"], h_abs)
            err = float(np.abs(vals - ref[:rows]).max()) / scale
            padded = any("padding" in str(w.message) for w in caught)
            want = pol["mode"] if label == "policy" else \
                "batch" if label == "pad" else label
            # batch mode runs each shard's rows through the whole-state
            # program, amp mode the mesh program on each chunk
            ops = cc._plan_for(cc.tier, sharded=mode != "batch")[1]
            layers = sum(1 for op in ops if op.kind == "layer")
            check(mode == want and err <= 1e-5
                  and launches == layers * MESH_SHARDS > 0
                  and len(held.errs) == launches and h_rel <= 1e-5
                  and padded == (rows % MESH_SHARDS != 0),
                  f"{label}: mode {mode}, {rows} rows, {launches} batched "
                  f"layer launches for {layers} layers x "
                  f"{MESH_SHARDS} shards, each held against its plain "
                  f"version (max|diff| {h_abs:.3e}, / max|plain| "
                  f"{h_rel:.3e} <= 1e-5); {secs:.2f} s with the holds "
                  f"({single_s:.2f} s for {batch} rows on one device); "
                  f"energies max|dE| / max|E| {err:.3e} <= 1e-5"
                  + ("; padded and masked" if padded else ""))
    return out


def mesh_density(torch, qt, lk, kk, card):
    from quest_tpu_torch.parallel.sampling import sample_sharded
    n = DENSITY_QUBITS
    print(f"  21d: phase 12's {n}-qubit noisy QFT as a density program on "
          "the mesh")
    circ, _ = noisy_qft(qt, n)
    basis = 0b101100111000101 & ((1 << n) - 1)
    env1, env8 = qt.createQuESTEnv(), mesh_env(qt)
    d1 = qt.createDensityQureg(n, env1)
    qt.initClassicalState(d1, basis)
    circ.compile(env1, density=True).run(d1)
    d8 = qt.createDensityQureg(n, env8)
    qt.initClassicalState(d8, basis)
    cc = circ.compile(env8, density=True)
    layers = [cc._ops[it[1]] for it in cc.plan.items
              if it[0] == "op" and cc._ops[it[1]].kind == "layer"]
    diag = sum(lk.is_diagonal_layer(op) for op in layers)
    reset_counts(lk, kk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with HeldLayers(torch, lk, batched=False) as held:
        cc.run(d8)
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = held.launches
    h_abs, h_rel = held.max_err()
    check(launches == len(layers) * MESH_SHARDS > 0
          and held.diag_launches == diag * MESH_SHARDS
          and len(held.errs) == launches and h_rel <= 1e-5,
          f"{launches} layer launches ({held.diag_launches} through the "
          f"streaming entry) for {len(layers)} layers ({diag} of rowdiag "
          f"stages only) x {MESH_SHARDS} shards, each held against its "
          f"plain version on its own chunk: max|diff| {h_abs:.3e}, / "
          f"max|plain| {h_rel:.3e} <= 1e-5")
    err = chunk_err(d8.chunks, d1.state)
    tr = qt.calcTotalProb(d8)
    check(err <= 1e-5 and abs(tr - 1.0) <= 1e-4,
          f"density planes vs one device: max|diff| / max|amp| {err:.3e} <="
          f" 1e-5; trace {tr!r}; {cc.dispatch_stats().relayouts} relayouts,"
          f" {secs:.3f} s with the holds")
    u = torch.rand(1 << 16, generator=torch.Generator().manual_seed(4),
                   dtype=torch.float64)
    idx, total = sample_sharded(d8.chunks, u, True, n, 2 * n - 2)
    check(abs(total - 1.0) <= 1e-5 and int(idx.max()) < (1 << n),
          f"sample_sharded on the density diagonal: total {total!r}")
    return {"launches": launches, "held_err": h_abs}


def mesh_comm_model(torch, qt, card):
    from quest_tpu_torch import profiling
    env8 = mesh_env(qt)
    model = profiling.comm_model(env8)
    for key, note in profiling.COMM_MODEL_NOTES.items():
        print(f"  {key[1][0]} x {key[0]}: {note}")
    print(f"  21e: the comm model of {MESH_SHARDS} shards on one card "
          f"({card}): alpha {model.alpha_s * 1e6:.2f} us, beta "
          f"{model.beta_s_per_byte * 1e12:.3f} ps/B "
          f"({1e-9 / model.beta_s_per_byte:.1f} GB/s of chunk permutation, "
          f"device-to-device copies within the card), source "
          f"{model.source}")
    check(model.source == "measured" and model.beta_s_per_byte > 0.0,
          "the comm model was measured on the mesh's own device")
    return {"alpha_us": model.alpha_s * 1e6,
            "gb_per_s": 1e-9 / model.beta_s_per_byte}


def phase_mesh(torch, qt, lk, kk, card, sweep=None):
    print(f"phase 21: amplitude-sharded registers, {MESH_SHARDS} shards on "
          f"one card ({card}), SINGLE")
    t0 = time.perf_counter()
    out, walls = {}, []
    for key, part in (("brickwork", mesh_brickwork),
                      ("imperative", mesh_imperative),
                      ("sweeps", lambda *a: mesh_sweeps(*a, sweep=sweep)),
                      ("density", mesh_density)):
        t1 = time.perf_counter()
        out[key] = part(torch, qt, lk, kk, card)
        torch.cuda.empty_cache()
        walls.append(f"{key} {time.perf_counter() - t1:.1f}")
    out["comm"] = mesh_comm_model(torch, qt, card)
    print(f"  phase 21 wall time {time.perf_counter() - t0:.1f} s "
          f"({', '.join(walls)})")
    return out


def mesh_keys(mesh, batched: bool = False):
    """The mesh path's keys of the layer kernel's rows: launches on the
    mesh (21a's timed run and 21d; FAST in 21a) or of the batched kernel
    (21c)."""
    if mesh is None:
        return {}
    if batched:
        return {"launches_mesh": mesh["sweeps"]["launches"],
                "mesh_held_err": mesh["sweeps"]["held_err"]}
    b = mesh["brickwork"]
    return {"launches_mesh": b["launches"] + mesh["density"]["launches"],
            "launches_mesh_fast": b["fast_launches"],
            "mesh_held_err": max(b["held_err"],
                                 mesh["density"]["held_err"]),
            "mesh_run_s": b["mesh_s"], "mesh_single_device_s": b["single_s"],
            "mesh_exchanges": b["exchanges"],
            "mesh_exchange_bytes": b["exchange_bytes"],
            "mesh_exchange_ms": b["exchange_ms"],
            "mesh_peak_gib": b["peak_gib"],
            "mesh_exchange_peak_chunks": b["exchange_peak_chunks"],
            "mesh_comm_gb_per_s": mesh["comm"]["gb_per_s"]}


# ---------------------------------------------------------------------------
# phase 22: the mesh's ensembles (trajectories, dynamics, density programs)
# and the port's examples
# ---------------------------------------------------------------------------

MESH_TRAJ_BATCH = 256                 # 22a: batch mode's trajectories
MESH_TRAJ_GRAD_WAVE = 16              # 22a: one gradient wave per mode


def first_differing_item(torch, tp1, tp4, u, d: int):
    """Where shard ``d``'s rows of a ``batch``-mode run first part from
    the same rows of one device's run on the same uniforms: both walked
    item by item (one device on all rows, the shard's twin on its own),
    compared after each item. ``(index, kind, targets, max|diff|)``, or
    None when every item agrees."""
    T = u.shape[0]
    per = T // MESH_SHARDS
    rows = slice(d * per, (d + 1) * per)
    tw = tp4._shard_twin(d)
    start = tp1._start(None)
    whole = start.expand(T, 2, start.shape[1]).clone(
        memory_format=torch.contiguous_format)
    part = whole[rows].clone()
    uw = torch.as_tensor(u, dtype=start.dtype, device=start.device)
    pm_rows = np.zeros((T, 0))
    found = None
    for k, item in enumerate(tp1._items):
        tp1._apply_item(whole, item, uw, pm_rows)
        tw._apply_item(part, item, uw[rows], pm_rows[rows])
        if not torch.equal(whole[rows], part):
            targets = item[1].targets if item[0] == "layer" \
                else tuple(item[1])
            found = (k, item[0], targets,
                     float((whole[rows] - part).abs().max()))
            break
    del whole, part
    torch.cuda.empty_cache()
    return found


def mesh_trajectories(torch, qt, lk, kk, card, traj=None, traj_grad=None):
    """22a: phase 9's 22-qubit program on the mesh, in both modes."""
    from quest_tpu_torch.ops import reductions as red
    from quest_tpu_torch.ops.trajectories import _Tape
    n, wave, T = TRAJ_QUBITS, TRAJ_WAVE, MESH_TRAJ_BATCH
    print(f"  22a: phase 9's {n}-qubit trajectory program on the mesh: "
          f"batch mode on {T} trajectories, amp mode on one wave of {wave}")
    rng = np.random.default_rng(2110)
    circ = trajectory_circuit(qt, n, rng)
    terms = [[(q, 3)] for q in range(n)]
    coeffs = list(rng.normal(size=n))
    env1, env4 = qt.createQuESTEnv(seed=[7]), mesh_env(qt, seed=[7])
    tp1, tp4 = (circ.compile_trajectories(e) for e in (env1, env4))
    kinds = [item[0] for item in tp1._items]
    n_layers, n_fused = kinds.count("layer"), kinds.count("kraus_fused")
    u = np.random.default_rng(22).uniform(size=(T, tp1.num_channels))
    ref = tp1.trajectory_sweep(T, uniforms=u)
    torch.cuda.synchronize()
    out = {"layer_launches": 0, "kraus_launches": 0, "held_err": 0.0,
           "kraus_err": 0.0}

    # batch mode: each shard's 64 rows as whole states, bit for bit
    reset_counts(lk, kk)
    with HeldLayers(torch, lk, batched=True) as held, \
            HeldKraus(torch, kk) as hk:
        got = tp4.trajectory_sweep(T, uniforms=u, shard_trajectories=True)
        torch.cuda.synchronize()
    h_abs, h_rel = held.max_err()
    same = torch.equal(got, ref)
    off = (got - ref).abs().amax(dim=(1, 2)) > 0
    rows_off = int(off.sum())
    err = float((got - ref).abs().max()) / float(ref.abs().max())
    first_off = int(off.nonzero()[0, 0]) if rows_off else None
    del got
    # is one device's own run the same twice?
    one_repeats = None if same else torch.equal(
        tp1.trajectory_sweep(T, uniforms=u), ref)
    del ref
    torch.cuda.empty_cache()
    first_item = None if same else first_differing_item(
        torch, tp1, tp4, u, first_off // (T // MESH_SHARDS))
    check(tp4.dispatch_stats().batch_sharding_mode == "batch"
          and same and held.launches == n_layers * MESH_SHARDS
          and hk.launches == n_fused * MESH_SHARDS and h_rel <= 1e-5
          and len(held.errs) == held.launches and hk.ok(),
          f"batch mode, {T} trajectories: planes vs one device's on the "
          f"same uniforms: bit for bit {same} ({rows_off} of {T} rows "
          f"differ, max|diff| / max|amp| {err:.3e}); {held.launches} "
          f"batched "
          f"layer launches ({n_layers} layers x {MESH_SHARDS} shards) and "
          f"{hk.launches} Kraus launches ({n_fused} channels x "
          f"{MESH_SHARDS}), each held against its plain version on its own "
          f"input (layers {h_rel:.3e} of max|plain|, Kraus "
          f"{max((e[1] for e in hk.errs), default=0.0):.3e}, indices equal)"
          + ("" if same else f"; one device's run repeats bit for bit "
             f"{one_repeats}")
          + ("" if first_item is None else
             f"; shard {first_off // (T // MESH_SHARDS)}'s rows first "
             f"differ from the same rows of one device's {T}-row run "
             f"after item {first_item[0]} ({first_item[1]}, targets "
             f"{first_item[2]}), by {first_item[3]:.3e}"))
    out.update(batch_bit_equal=same, batch_rows_differ=rows_off,
               batch_planes_err=err, batch_first_differing_item=first_item,
               batch_one_device_repeats=one_repeats)
    out["layer_launches"] += held.launches
    out["kraus_launches"] += hk.launches
    out["held_err"] = max(out["held_err"], h_abs)
    out["kraus_err"] = max(out["kraus_err"], hk.max_err())

    # amp mode: one wave spanning the shards, through the policy's limit
    uw = u[:wave]
    start = tp1._start(None)
    pm_rows = np.zeros((wave, 0))
    tape = _Tape(0)
    ref = start.expand(wave, 2, start.shape[1]).clone()
    tp1._apply_batch(ref, torch.as_tensor(uw, dtype=ref.dtype,
                                          device=ref.device), pm_rows, tape)
    reset_counts(lk, kk)
    with BatchMemLimit(1), HeldLayers(torch, lk, batched=True) as held, \
            HeldKraus(torch, kk) as hk:
        t0 = time.perf_counter()
        got = tp4.trajectory_sweep(wave, uniforms=uw)
        torch.cuda.synchronize()
        amp_held_s = time.perf_counter() - t0
    mode = tp4.dispatch_stats().batch_sharding_mode
    walk = tp4._mesh_walk()
    mesh_layers = sum(1 for op, _ in walk.steps if op.kind == "layer")
    relayouts = sum(1 for op, _ in walk.steps if op.kind == "relayout")
    err = float((got - ref).abs().max()) / float(ref.abs().max())
    del ref
    # the draws, from a wave of the walk on the same uniforms (the path
    # trajectory_sweep ran), its planes equal to that run's
    wave_run = walk.wave(torch.as_tensor(uw, dtype=start.dtype,
                                         device=start.device))
    again = torch.cat(wave_run.run_rows(start, pm_rows), dim=-1)
    rerun_same = torch.equal(again, got)
    del again
    differ = sum(int((wave_run.draws[i][0].cpu() != tape.draws[i][0].cpu())
                     .sum()) for i in tape.draws)
    h_abs, h_rel = held.max_err()
    check(mode == "amp" and differ == 0 and err <= 1e-6 and rerun_same
          and held.launches == mesh_layers * MESH_SHARDS
          and hk.launches == n_fused * MESH_SHARDS and h_rel <= 1e-5
          and len(held.errs) == held.launches and hk.ok(),
          f"amp mode, {wave} trajectories over {MESH_SHARDS} chunks of "
          f"{n - 2} qubits ({mesh_layers} layers and {relayouts} relayouts "
          f"in the walk): {differ} of {wave * len(tape.draws)} draws "
          f"differ from one device's on the same uniforms; planes max|diff|"
          f" / max|amp| {err:.3e} <= 1e-6; {held.launches} batched layer "
          f"and {hk.launches} Kraus launches held against plain (layers "
          f"{h_rel:.3e}, Kraus "
          f"{max((e[1] for e in hk.errs), default=0.0):.3e}, indices "
          f"equal); {amp_held_s:.2f} s with the holds; a wave of the "
          f"walk on the same uniforms gives the same planes bit for bit "
          f"{rerun_same}")
    out.update(amp_draws_differ=differ, amp_planes_err=err,
               amp_walk_layers=mesh_layers, amp_walk_relayouts=relayouts)
    out["layer_launches"] += held.launches
    out["kraus_launches"] += hk.launches
    out["held_err"] = max(out["held_err"], h_abs)
    out["kraus_err"] = max(out["kraus_err"], hk.max_err())
    del got, tape, wave_run
    torch.cuda.empty_cache()

    # trajectories/s in each mode (no holds), beside phase 9's
    rates = {}
    for label, limit, num, force in (("batch", None, T, True),
                                     ("amp", 1, wave, None)):
        with BatchMemLimit(limit):
            tp4.expectation(terms, coeffs, num_trajectories=num,
                            wave_size=wave, seed=3,
                            shard_trajectories=force)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tp4.expectation(terms, coeffs, num_trajectories=num,
                            wave_size=wave, seed=1,
                            shard_trajectories=force)
            torch.cuda.synchronize()
            rates[label] = num / (time.perf_counter() - t0)
            check(tp4.dispatch_stats().batch_sharding_mode == label,
                  f"expectation ran in {label} mode")
    one = traj["traj_per_s"] if traj is not None else None
    print(f"  trajectories/s: batch mode {rates['batch']:.2f}, amp mode "
          f"{rates['amp']:.2f}, one device (phase 9) "
          + (f"{one:.2f}" if one is not None else "not run"))
    out["traj_per_s"] = rates

    # expectation_grad over one wave in each mode against one device's
    gw = MESH_TRAJ_GRAD_WAVE
    gcirc, pv = param_trajectory_circuit(qt, n, np.random.default_rng(2110))
    g1 = gcirc.compile_trajectories(env1)
    g4 = gcirc.compile_trajectories(env4)
    t0 = time.perf_counter()
    v1, grad1, _ = g1.expectation_grad(terms, coeffs, num_trajectories=gw,
                                       wave_size=gw, params=pv, seed=29)
    one_s = time.perf_counter() - t0
    gmax = float(np.abs(grad1).max())
    for label, limit, force in (("batch", None, True), ("amp", 1, None)):
        reset_counts(lk, kk)
        with BatchMemLimit(limit), \
                HeldLayers(torch, lk, batched=True) as held, \
                HeldKraus(torch, kk) as hk:
            t0 = time.perf_counter()
            v, g, _ = g4.expectation_grad(
                terms, coeffs, num_trajectories=gw, wave_size=gw,
                params=pv, seed=29, shard_trajectories=force)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        mode = g4.dispatch_stats().batch_sharding_mode
        d = float(np.abs(g - grad1).max())
        h_abs, h_rel = held.max_err()
        check(mode == label and d <= 1e-5 * gmax and h_rel <= 1e-5
              and held.launches > 0 and hk.launches > 0 and hk.ok()
              and len(held.errs) == held.launches,
              f"expectation_grad, one wave of {gw} in {label} mode: "
              f"max|dg| {d:.3e} <= 1e-5 of max|g| {gmax:.3e} (value "
              f"{v:.6f} vs {v1:.6f}); {held.launches} batched layer and "
              f"{hk.launches} Kraus launches (forward and adjoint) held "
              f"against plain ({h_rel:.3e}); {secs:.2f} s with the holds, "
              f"{one_s:.2f} s on one device")
        out[f"grad_{label}_rel"] = d / gmax
        out[f"grad_{label}_s"] = secs
        out["layer_launches"] += held.launches
        out["kraus_launches"] += hk.launches
        out["held_err"] = max(out["held_err"], h_abs)
        out["kraus_err"] = max(out["kraus_err"], hk.max_err())
    out["grad_one_device_s"] = one_s
    if traj_grad is not None:
        print(f"  gradient trajectories/s: batch mode "
              f"{gw / out['grad_batch_s']:.2f}, amp mode "
              f"{gw / out['grad_amp_s']:.2f} (with the holds), one device "
              f"{gw / one_s:.2f} here, phase 9g {traj_grad['traj_per_s']:.2f}")
    return out


def mesh_dynamics(torch, qt, lk, kk, card, dynamics=None):
    """22b: phase 15's dynamics-tfim-24q-b4 in amp mode on the mesh."""
    from quest_tpu_torch.ops import dynamics as dyn
    n, B, S = DYN_QUBITS, DYN_BATCH, DYN_STEPS
    print(f"  22b: phase 15's {n}-qubit TFIM, batch {B}, evolve_sweep and "
          f"ground_sweep (power and Lanczos) in amp mode")
    ham = tfim(n)
    pm = np.random.default_rng(2026).normal(size=(B, n)) * 0.3
    spec = dyn.EvolveSpec(t=DYN_T, steps=S, order=2)
    gspec = dyn.GroundSpec(steps=GROUND_STEPS, tau=GROUND_TAU)
    lspec = dyn.GroundSpec(steps=GROUND_STEPS, method="lanczos")
    if dynamics is not None:
        ref = {k: dynamics[f"{k}_energies"]
               for k in ("evolve", "ground", "lanczos")}
        secs1 = dynamics["seconds"]
        print("  the one-device energies: phase 15's")
    else:
        cc1 = dyn_prep(qt, n).compile(qt.createQuESTEnv(seed=[2026]))
        ref, secs1 = {}, {}
        for key, sp, width in (("evolve", spec, S),
                               ("ground", gspec, GROUND_STEPS),
                               ("lanczos", lspec, 1)):
            fn = cc1.evolve_sweep if key == "evolve" else cc1.ground_sweep
            t0 = time.perf_counter()
            head = block_head(fn(pm, ham, sp), width)
            secs1[key] = time.perf_counter() - t0
            ref[key] = head[:, 0] if key == "lanczos" else head
        del cc1
    cc = dyn_prep(qt, n).compile(mesh_env(qt, seed=[2026]))
    n_layers = sum(1 for op in cc._plan_for(cc.tier, sharded=True)[1]
                   if op.kind == "layer")
    out = {"launches": 0, "held_err": 0.0, "seconds": {}}
    with BatchMemLimit(1):
        for key, sp, width in (("evolve", spec, S),
                               ("ground", gspec, GROUND_STEPS),
                               ("lanczos", lspec, 1)):
            fn = cc.evolve_sweep if key == "evolve" else cc.ground_sweep
            reset_counts(lk, kk)
            with HeldLayers(torch, lk, batched=True) as held:
                t0 = time.perf_counter()
                block = fn(pm, ham, sp)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            head = block_head(block, width)
            got = head[:, 0] if key == "lanczos" else head
            del block
            stats = cc.dispatch_stats()
            scale = float(np.abs(ref[key]).max())
            err = float(np.abs(got - ref[key]).max()) / scale
            h_abs, h_rel = held.max_err()
            check(stats.batch_sharding_mode == "amp" and err <= 1e-5
                  and stats.evolve_steps_fused == B * sp.steps
                  and held.launches == n_layers * MESH_SHARDS > 0
                  and h_rel <= 1e-5,
                  f"{key}: amp mode, energies max|dE| / max|E| {err:.3e} <="
                  f" 1e-5 of one device's; {held.launches} batched layer "
                  f"launches (the prep's {n_layers} layer(s) x "
                  f"{MESH_SHARDS} chunks) held against plain ({h_rel:.3e});"
                  f" {secs:.2f} s (one device: "
                  + (f"{secs1[key]:.2f} s)" if key in secs1 else
                     f"{secs1.get(key + '_held', float('nan')):.2f} s "
                     "held)"))
            out["seconds"][key] = secs
            out[f"{key}_rel"] = err
            out["launches"] += held.launches
            out["held_err"] = max(out["held_err"], h_abs)
    return out


def mesh_density_ensembles(torch, qt, lk, kk, card, density_grad=None):
    """22c: 12d's density cells in amp mode on the mesh."""
    n, ng = DENSITY_QUBITS, DENSITY_GRAD_QUBITS
    print(f"  22c: config 4 ({n} q, batch 2) energies and the {ng}-q "
          f"gradient cell (batch {DENSITY_GRAD_BATCH}) in amp mode")
    circ, _, angles = density_noise(qt, n, params=True)
    terms, coeffs, _ = random_hamiltonian(n, SWEEP_TERMS, 2027)
    ham = (terms, coeffs)
    pm = np.stack([angles, np.random.default_rng(2028).uniform(
        0, 2 * np.pi, n)])
    gcirc = rate_circuit(qt, ng)
    gterms, gcoeffs, _ = random_hamiltonian(ng, 8, 2029)
    gham = (gterms, gcoeffs)
    rng = np.random.default_rng(2030)
    gpm = np.concatenate([rng.uniform(0, 2 * np.pi, (DENSITY_GRAD_BATCH,
                                                     len(gcirc.param_names)
                                                     - 1)),
                          rng.uniform(0.05, 0.3, (DENSITY_GRAD_BATCH, 1))],
                         axis=1)
    if density_grad is not None:
        e_ref = density_grad["config4"]["energies"]
        e1_s = density_grad["config4"]["seconds"]
        v_ref = density_grad["gradients"]["values"]
        g_ref = density_grad["gradients"]["grads"]
        g1_s = density_grad["gradients"]["seconds"]
        print("  the one-device energies and gradients: phase 12d's")
    else:
        env1 = qt.createQuESTEnv()
        c1 = circ.compile(env1, density=True)
        t0 = time.perf_counter()
        e_ref = c1.expectation_sweep(pm, ham)
        e1_s = time.perf_counter() - t0
        del c1
        torch.cuda.empty_cache()
        c1 = gcirc.compile(env1, density=True)
        t0 = time.perf_counter()
        v_ref, g_ref = c1.value_and_grad_sweep(gpm, gham)
        g1_s = time.perf_counter() - t0
        del c1
        torch.cuda.empty_cache()
    env4 = mesh_env(qt)
    out = {"launches": 0, "held_err": 0.0}
    with BatchMemLimit(1):
        cc = circ.compile(env4, density=True)
        layers = cc._plan_for(cc.tier, sharded=True)[1]
        n_layers = sum(1 for op in layers if op.kind == "layer")
        reset_counts(lk, kk)
        torch.cuda.reset_peak_memory_stats()
        with HeldLayers(torch, lk, batched=True) as held:
            t0 = time.perf_counter()
            energies = cc.expectation_sweep(pm, ham)
            torch.cuda.synchronize()
            e_s = time.perf_counter() - t0
        peak_e = torch.cuda.max_memory_allocated()
        err = float(np.abs(energies - e_ref).max() / np.abs(e_ref).max())
        h_abs, h_rel = held.max_err()
        check(cc.dispatch_stats().batch_sharding_mode == "amp"
              and err <= 1e-5 and held.launches == n_layers * MESH_SHARDS
              and h_rel <= 1e-5 and len(held.errs) == held.launches,
              f"config 4 energies in amp mode vs one device: max|dE| / "
              f"max|E| {err:.3e} <= 1e-5; {held.launches} batched layer "
              f"launches ({n_layers} layers x {MESH_SHARDS} chunks) held "
              f"against plain ({h_rel:.3e}); {e_s:.2f} s with the holds "
              f"(one device {e1_s:.2f} s), peak {peak_e / 2**30:.2f} GiB")
        out.update(energy_rel=err, energy_s=e_s, energy_peak_bytes=peak_e)
        out["launches"] += held.launches
        out["held_err"] = max(out["held_err"], h_abs)
        del cc
        torch.cuda.empty_cache()

        gc = gcirc.compile(env4, density=True)
        reset_counts(lk, kk)
        torch.cuda.reset_peak_memory_stats()
        with HeldLayers(torch, lk, batched=True) as held:
            t0 = time.perf_counter()
            vals, grads = gc.value_and_grad_sweep(gpm, gham)
            torch.cuda.synchronize()
            g_s = time.perf_counter() - t0
        peak_g = torch.cuda.max_memory_allocated()
        gmax = float(np.abs(g_ref).max())
        g_err = float(np.abs(grads - g_ref).max()) / gmax
        v_err = float(np.abs(vals - v_ref).max() / np.abs(v_ref).max())
        h_abs, h_rel = held.max_err()
        check(gc.dispatch_stats().batch_sharding_mode == "amp"
              and g_err <= 1e-5 and v_err <= 1e-5 and h_rel <= 1e-5
              and len(held.errs) == held.launches,
              f"{ng}-q gradients in amp mode vs one device: max|dg| / "
              f"max|g| {g_err:.3e}, values {v_err:.3e}, <= 1e-5; "
              f"{held.launches} batched layer launches (forward and "
              f"adjoint) held against plain ({h_rel:.3e}); {g_s:.2f} s "
              f"with the holds (one device {g1_s:.2f} s); peak "
              f"{peak_g / 2**30:.2f} GiB (one device: phase 12d's)")
        out.update(grad_rel=g_err, grad_s=g_s, grad_peak_bytes=peak_g)
        out["launches"] += held.launches
        out["held_err"] = max(out["held_err"], h_abs)
        del gc
        torch.cuda.empty_cache()
    return out


EXAMPLE_SCRIPTS = ("tutorial_example", "damping_example",
                   "bernstein_vazirani", "shor", "quad_precision", "vqe",
                   "qaoa", "noise_fitting", "noisy_trajectories",
                   "production_workflow", "tpu_features")
# the Adam loops at tests/test_torch_examples.py's step counts
EXAMPLE_SIZES = {"vqe": {"steps": 25, "noisy_steps": 10},
                 "qaoa": {"steps": 40}, "noise_fitting": {"steps": 100}}
# the deterministic numbers held against the same script on the CPU at
# DOUBLE (absolute, 1e-5)
EXAMPLE_HELD = {
    "tutorial_example": ("prob_amp_111", "prob_q2_is_1"),
    "damping_example": ("states",),
    "bernstein_vazirani": ("prob_secret",),
    "noise_fitting": ("data",),
    "noisy_trajectories": ("exact",),
    "production_workflow": ("amps", "total_prob", "prob_q0_is_0"),
    "tpu_features": ("qft_total_prob", "qft_amps", "param_probs",
                     "descent_energy", "descent_theta", "sweep_p0",
                     "mesh_total_prob", "mesh_amps")}
EXAMPLE_TOL = 1e-5


def example_summary(name: str, out: dict) -> str:
    """The numbers an example returned, one line."""
    parts = []
    for key, value in out.items():
        if isinstance(value, (int, float, np.floating, np.integer)):
            parts.append(f"{key} {float(value):.6g}")
        elif isinstance(value, tuple):
            parts.append(f"{key} {value}")
        elif isinstance(value, list) and value:
            last = np.round(np.asarray(value[-1]), 6)
            parts.append(f"{key}[-1] {last.tolist()}")
        elif isinstance(value, np.ndarray) and value.size <= 16:
            parts.append(f"{key} {np.round(value, 6).tolist()}")
        elif isinstance(value, dict):
            parts.append(f"{key} " + ", ".join(
                f"{k} {float(v):.4g}" for k, v in value.items()
                if isinstance(v, (int, float))))
    return f"{name}: " + "; ".join(parts)


def quiet(fn, **kwargs):
    """``fn(**kwargs)`` with its prints caught: ``(result, lines)``."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(**kwargs)
    return out, buf.getvalue().count("\n")


def example_facts(torch, qt, name: str, res: dict, host: dict) -> list:
    """``(what, ok)`` for an example's card result beyond its own asserts:
    its deterministic numbers against ``host`` (the same script on the CPU
    at DOUBLE), an Adam loop's final energy re-evaluated on the CPU at the
    card's final parameters, and the facts a draw decides."""
    facts = []
    for key in EXAMPLE_HELD.get(name, ()):
        d = float(np.abs(np.asarray(res[key], dtype=np.complex128)
                         - np.asarray(host[key], dtype=np.complex128)).max())
        facts.append((f"{key} {d:.2e} off the CPU's", d <= EXAMPLE_TOL))
    cpu = qt.createQuESTEnv(num_devices=1, device="cpu",
                            precision=qt.DOUBLE)
    if name == "vqe":
        from quest_tpu_torch.examples import vqe
        terms, coeffs = vqe.hamiltonian_terms()
        for key, pkey, circ, density in (
                ("energy", "params", vqe.ansatz(), False),
                ("noisy_energy", "noisy_params",
                 vqe.ansatz().with_noise(p1=0.01, damping=0.02), True)):
            fn = circ.compile(cpu, density=density).expectation_fn(terms,
                                                                   coeffs)
            d = abs(float(fn(torch.as_tensor(res[pkey]))) - res[key])
            facts.append((f"{key} at the card's parameters {d:.2e} off the "
                          "CPU's", d <= EXAMPLE_TOL))
        facts.append((f"energy {res['energy']:.6f} >= exact "
                      f"{res['exact']:.6f}",
                      res["energy"] >= res["exact"] - EXAMPLE_TOL))
    elif name == "qaoa":
        from quest_tpu_torch import algorithms as alg
        from quest_tpu_torch.examples import qaoa
        cc = alg.qaoa_maxcut(qaoa.N, qaoa.EDGES, num_layers=qaoa.LAYERS)
        fn = cc.compile(cpu).expectation_fn(*alg.qaoa_maxcut_terms(
            qaoa.EDGES))
        cut = len(qaoa.EDGES) / 2.0 - float(fn(torch.as_tensor(
            res["params"])))
        d = abs(cut - res["expected_cut"])
        facts.append((f"expected cut at the card's parameters {d:.2e} off "
                      "the CPU's", d <= EXAMPLE_TOL))
        facts.append((f"best drawn cut {res['best_drawn']} of "
                      f"{res['num_draws']} draws = max {res['max_cut']}",
                      res["best_drawn"] == res["max_cut"]))
    elif name == "noise_fitting":
        from quest_tpu_torch.examples import noise_fitting as nf
        d = max(abs(res["rates"][0] - nf.TRUE_DAMP),
                abs(res["rates"][1] - nf.TRUE_DEPHASE))
        facts.append((f"fitted rates {d:.2e} off the true ones", d < 0.01))
    elif name == "noisy_trajectories":
        facts.append((f"ensemble {res['ensemble']:.4f} within 5 stderr of "
                      f"exact {res['exact']:.4f}",
                      abs(res["ensemble"] - res["exact"])
                      <= 5 * res["ensemble_stderr"]))
        facts.append((f"<Z> {res['z_mean']:.4f} within 5 stderr",
                      abs(res["z_mean"] - (1.0 - 2.0 * res["exact"]))
                      <= 5 * res["z_stderr"]))
    elif name == "quad_precision":
        facts.append((f"QUAD {res['quad']['max_err']:.2e} <= 1e-12 off the "
                      "float64 oracle", res["quad"]["max_err"] <= 1e-12))
        facts.append((f"SINGLE {res['single']['max_err']:.2e} <= 1e-4",
                      res["single"]["max_err"] <= 1e-4))
    elif name == "shor":
        facts.append((f"factors {res['factors']}",
                      sorted(res["factors"]) == [3, 5]))
    elif name == "bernstein_vazirani":
        facts.append((f"measured {res['measured']} = secret "
                      f"{res['secret']}", res["measured"] == res["secret"]))
    return facts


def mesh_examples(torch, qt, lk, kk, card):
    """22d: every example script's main() on the card, with its own
    asserts and every launch of the layer kernel, the batched layer kernel
    and the Kraus kernel held against its plain version on its own input;
    its numbers against the same script on the CPU."""
    import importlib
    print(f"  22d: the {len(EXAMPLE_SCRIPTS)} examples "
          "(quest_tpu_torch/examples/) on the card, every launch held; "
          f"the Adam loops at {EXAMPLE_SIZES}")
    out = {"seconds": {}, "layer_launches": 0, "batched_launches": 0,
           "kraus_launches": 0, "layer_err": 0.0, "batched_err": 0.0,
           "kraus_err": 0.0}
    for name in EXAMPLE_SCRIPTS:
        mod = importlib.import_module(f"quest_tpu_torch.examples.{name}")
        sizes = EXAMPLE_SIZES.get(name, {})
        reset_counts(lk, kk)
        with HeldLayers(torch, lk, batched=False) as h1, \
                HeldLayers(torch, lk, batched=True) as h2, \
                HeldKraus(torch, kk) as hk:
            t0 = time.perf_counter()
            res, lines = quiet(mod.main, device="cuda", **sizes)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        print(f"    {example_summary(name, res)} ({secs:.2f} s with the "
              f"holds, {lines} lines printed)")
        r1, r2 = h1.max_err()[1], h2.max_err()[1]
        check(len(h1.errs) == h1.launches and len(h2.errs) == h2.launches
              and len(hk.errs) == hk.launches and r1 <= 1e-5
              and r2 <= 1e-5 and hk.ok(),
              f"{name}: {h1.launches} layer, {h2.launches} batched layer "
              f"and {hk.launches} Kraus launches, each held against plain "
              f"on its own input ({r1:.2e}, {r2:.2e}, "
              f"{max((e[1] for e in hk.errs), default=0.0):.2e} of "
              "max|plain|, Kraus indices equal)")
        host = quiet(mod.main, device="cpu", **sizes)[0] \
            if name in EXAMPLE_HELD else None
        facts = example_facts(torch, qt, name, res, host)
        if facts:
            check(all(ok for _, ok in facts),
                  f"{name} against the CPU: " + "; ".join(w for w, _ in facts))
        out["seconds"][name] = secs
        out["layer_launches"] += h1.launches
        out["batched_launches"] += h2.launches
        out["kraus_launches"] += hk.launches
        out["layer_err"] = max(out["layer_err"], h1.max_err()[0])
        out["batched_err"] = max(out["batched_err"], h2.max_err()[0])
        out["kraus_err"] = max(out["kraus_err"], hk.max_err())
    print(f"  22d launches, all held: layer kernel {out['layer_launches']}, "
          f"batched {out['batched_launches']}, Kraus "
          f"{out['kraus_launches']}")
    return out


def phase_mesh_ensembles(torch, qt, lk, kk, card, traj=None,
                         traj_grad=None, dynamics=None, density_grad=None):
    print(f"phase 22: ensembles on the mesh ({MESH_SHARDS} shards of one "
          f"card, {card}, SINGLE) and the examples")
    t0 = time.perf_counter()
    out, walls = {}, []
    for key, part in (
            ("trajectories", lambda *a: mesh_trajectories(
                *a, traj=traj, traj_grad=traj_grad)),
            ("dynamics", lambda *a: mesh_dynamics(*a, dynamics=dynamics)),
            ("density", lambda *a: mesh_density_ensembles(
                *a, density_grad=density_grad)),
            ("examples", mesh_examples)):
        t1 = time.perf_counter()
        out[key] = part(torch, qt, lk, kk, card)
        torch.cuda.empty_cache()
        walls.append(f"{key} {time.perf_counter() - t1:.1f}")
    print(f"  phase 22 wall time {time.perf_counter() - t0:.1f} s "
          f"({', '.join(walls)})")
    return out


def ensemble_keys(ens, kraus: bool = False, single: bool = False):
    """Phase 22's numbers, as keys of the batched layer kernel's row (22a's
    trajectory waves, 22b's dynamics prep, 22c's density cells and 22d's
    examples, every launch held against plain), with ``kraus`` the Kraus
    kernel's (22a's channels, one launch per chunk in amp mode, and 22d's)
    or with ``single`` the layer kernel's (22d's)."""
    if ens is None:
        return {}
    t, ex = ens["trajectories"], ens["examples"]
    if single:
        return {"launches_examples": ex["layer_launches"],
                "examples_max_abs_err": ex["layer_err"]}
    if kraus:
        return {"launches_mesh_ensembles": t["kraus_launches"],
                "mesh_ensembles_max_abs_err": t["kraus_err"],
                "launches_examples": ex["kraus_launches"],
                "examples_max_abs_err": ex["kraus_err"],
                "mesh_amp_draws_differ": t["amp_draws_differ"],
                "mesh_batch_rows_differ": t["batch_rows_differ"],
                "mesh_batch_planes_err": t["batch_planes_err"],
                "mesh_batch_first_differing_item":
                    t["batch_first_differing_item"],
                "mesh_traj_per_s": t["traj_per_s"]}
    return {"launches_mesh_ensembles": t["layer_launches"]
            + ens["dynamics"]["launches"] + ens["density"]["launches"],
            "launches_mesh_trajectories": t["layer_launches"],
            "launches_mesh_dynamics": ens["dynamics"]["launches"],
            "launches_mesh_density": ens["density"]["launches"],
            "launches_examples": ex["batched_launches"],
            "examples_max_abs_err": ex["batched_err"],
            "mesh_ensembles_max_abs_err": max(
                t["held_err"], ens["dynamics"]["held_err"],
                ens["density"]["held_err"]),
            "mesh_traj_grad_rel": max(t["grad_batch_rel"],
                                      t["grad_amp_rel"]),
            "mesh_dynamics_s": ens["dynamics"]["seconds"],
            "mesh_density_energy_s": ens["density"]["energy_s"],
            "mesh_density_grad_s": ens["density"]["grad_s"],
            "mesh_density_grad_peak_bytes":
                ens["density"]["grad_peak_bytes"],
            "examples_s": ex["seconds"]}


# ---------------------------------------------------------------------------
# phase 23: the single-controller mesh's remainder (Pauli sums and wide
# passes on sharded registers, QUAD on a mesh, serving on mesh envs)
# ---------------------------------------------------------------------------

REMAINDER_TERMS = 24                # bench.py:1350's sum, made to 30 q
WIDE_QUBITS, WIDE_SHARDS = 3, 8     # 23b: 3 local qubits per chunk
NARROW_QUBITS = 2                   # 23b: half a column per chunk
QUAD_MESH_QUBITS = 28               # 23c: phase 17's QUAD brickwork
QUAD_MESH_IMPERATIVE_QUBITS = 24
MESH_REPLICA_SHARDS = 2             # 23d: 2 replicas x 2 shards
MESH_SERVE_TRAJ_QUBITS, MESH_SERVE_TRAJ_T = 16, 128


def planes_digest(torch, chunks):
    """A position-sensitive digest of dd planes' raw bits: per plane, the
    int64 sums of 1024 equal blocks (256 per chunk of a 4-shard list),
    on the host. Two tensors whose digests agree are taken as equal bit
    for bit (a difference would have to cancel inside a block)."""
    if not isinstance(chunks, (list, tuple)):
        chunks = [chunks]
    per = 1024 // len(chunks)
    return torch.cat([raw_bits(torch, c).view(4, per, -1).sum(
        -1, dtype=torch.int64) for c in chunks], dim=1).cpu()


def dd_chunk_err(torch, chunks, whole) -> float:
    """max |hi + lo of a chunk - the same slice of the whole dd planes|,
    in float64 on the card, over max |whole|."""
    width = chunks[0].shape[-1]
    w = whole.double()
    wv = torch.stack([w[0] + w[1], w[2] + w[3]])
    diff = 0.0
    for d, c in enumerate(chunks):
        cv = c.double()
        cv = torch.stack([cv[0] + cv[1], cv[2] + cv[3]])
        diff = max(diff, float((cv - wv[:, d * width:(d + 1) * width])
                               .abs().max()))
    return diff / float(wv.abs().max())


def timed_s(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def remainder_pauli(torch, qt, lk, kk, card):
    """23a: applyPauliSum on the 30-q brickwork state, and the density
    register's Pauli expectations, on 4 shards against one device on the
    same input."""
    n = MAIN_QUBITS
    rng = np.random.default_rng(2026)
    codes = rng.integers(0, 4, size=(REMAINDER_TERMS, n))
    coeffs = rng.normal(size=REMAINDER_TERMS)
    codes_flat = [int(c) for c in codes.reshape(-1)]
    print(f"  23a: applyPauliSum of the {REMAINDER_TERMS}-term sum on phase "
          f"4's {n}-qubit brickwork state, {MESH_SHARDS} shards")
    env4, env1 = mesh_env(qt), qt.createQuESTEnv()
    q4 = qt.createQureg(n, env4)
    qt.initPlusState(q4)
    cc = as_circuit(qt, n, brickwork(n, MAIN_LAYERS)).compile(env4)
    reset_counts(lk, kk)
    with HeldLayers(torch, lk, batched=False) as held:
        cc.run(q4)
        torch.cuda.synchronize()
    h_abs, h_rel = held.max_err()
    check(held.launches == cc.num_layers * MESH_SHARDS > 0
          and h_rel <= 1e-5,
          f"the brickwork's {held.launches} layer launches ({cc.num_layers}"
          f" layers x {MESH_SHARDS} shards), each against its plain version"
          f" on its own chunk: max|diff| {h_abs:.3e}, / max|plain| "
          f"{h_rel:.3e} <= 1e-5")
    out = {"layer_launches": held.launches, "layer_err": h_abs}
    del cc
    q1 = qt.createQureg(n, env1)
    q4.ensure_canonical()
    q1.state = torch.cat(q4.chunks, dim=1)       # the same input
    o4, o1 = qt.createQureg(n, env4), qt.createQureg(n, env1)
    _, s4 = timed_s(torch, lambda: qt.applyPauliSum(
        q4, codes_flat, coeffs, REMAINDER_TERMS, o4))
    _, s1 = timed_s(torch, lambda: qt.applyPauliSum(
        q1, codes_flat, coeffs, REMAINDER_TERMS, o1))
    err = chunk_err(o4.chunks, o1.state)
    check(o4.is_sharded and err <= 1e-5,
          f"23a applyPauliSum {n} q: the image's chunks vs one device "
          f"{err:.3e} of max|amp| <= 1e-5; {s4 * 1e3:.1f} ms on "
          f"{MESH_SHARDS} shards, {s1 * 1e3:.1f} ms on one device ({card})")
    out.update(pauli_sum_ms=s4 * 1e3, pauli_sum_single_ms=s1 * 1e3,
               pauli_sum_err=err)
    del q4, q1, o4, o1
    torch.cuda.empty_cache()
    nd = DENSITY_QUBITS
    _, calls, _ = density_noise(qt, nd)
    d4 = qt.createDensityQureg(nd, env4)
    qt.initPlusState(d4)
    for fn, args in calls:
        fn(d4, *args)
    d4.ensure_canonical()
    d1 = qt.createDensityQureg(nd, env1)
    d1.state = torch.cat(d4.chunks, dim=1)
    dcodes = rng.integers(0, 4, size=(REMAINDER_TERMS, nd))
    dcoeffs = rng.normal(size=REMAINDER_TERMS)
    dflat = [int(c) for c in dcodes.reshape(-1)]
    targets, pcodes = [0, nd // 2, nd - 1], [1, 2, 3]
    vals = {}
    for key, d in (("mesh", d4), ("one", d1)):
        e, es = timed_s(torch, lambda: qt.calcExpecPauliSum(
            d, dflat, dcoeffs))
        p, ps = timed_s(torch, lambda: qt.calcExpecPauliProd(
            d, targets, pcodes))
        vals[key] = (e, p, es, ps)
    scale = max(abs(vals["one"][0]), abs(vals["one"][1]), 1.0)
    derr = max(abs(vals["mesh"][i] - vals["one"][i]) for i in (0, 1)) / scale
    check(derr <= 1e-5,
          f"23a config 4 ({nd} q density, {2 * 4 * (1 << 2 * nd) / 2**30:.0f}"
          f" GiB): calcExpecPauliSum {vals['mesh'][0]!r} vs "
          f"{vals['one'][0]!r}, calcExpecPauliProd {vals['mesh'][1]!r} vs "
          f"{vals['one'][1]!r}: {derr:.3e} of max|E| <= 1e-5; "
          f"{vals['mesh'][2] * 1e3:.1f} and {vals['mesh'][3] * 1e3:.1f} ms "
          f"on {MESH_SHARDS} shards, {vals['one'][2] * 1e3:.1f} and "
          f"{vals['one'][3] * 1e3:.1f} ms on one device")
    out.update(expec_ms=vals["mesh"][2] * 1e3,
               expec_single_ms=vals["one"][2] * 1e3, expec_err=derr)
    return out


def remainder_wide(torch, qt, lk, kk, card):
    """23b: wide passes on a 3-q density register over 8 shards of the
    card, and initPureState/calcFidelity on chunks narrower than a
    column."""
    from quest_tpu_torch.parallel import exchange as ex
    n = WIDE_QUBITS
    print(f"  23b: wide passes, a {n}-qubit density register over "
          f"{WIDE_SHARDS} shards of the card ({2 * n - 3} local qubits)")
    env8 = qt.createQuESTEnv(devices=["cuda:0"] * WIDE_SHARDS)
    env1 = qt.createQuESTEnv()
    u = random_unitary(np.random.default_rng(23), 4)
    res, peaks = {}, []
    for key, env in (("mesh", env8), ("one", env1)):
        pure = qt.createQureg(n, env)
        qt.initPlusState(pure)
        qt.rotateY(pure, 2, 0.4)
        qt.controlledPhaseShift(pure, 0, 2, 0.9)
        d = qt.createDensityQureg(n, env)
        qt.initPureState(d, pure)
        for step in (lambda: qt.twoQubitUnitary(d, 0, 2, u),
                     lambda: qt.mixTwoQubitDepolarising(d, 1, 2, 0.2)):
            ex.reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            step()
            torch.cuda.synchronize()
            if key == "mesh":
                peaks.append((ex.GROUP_PEAK[0],
                              torch.cuda.max_memory_allocated() - base,
                              ex.COUNTS["grouped"]))
        res[key] = (d.to_numpy(), qt.calcPurity(d), qt.calcFidelity(d, pure))
    chunk = 2 * 4 * (1 << (2 * n)) // WIDE_SHARDS
    for i, (group, extra, grouped) in enumerate(peaks):
        print(f"    pass {i}: {grouped} grouped pass(es), the group "
              f"{group} B ({group // chunk} chunks of {chunk} B), "
              f"allocated beside the register at its peak {extra} B")
    check(all(g == 2 * chunk and c >= 1 for g, _, c in peaks),
          "23b: each wide pass ran on groups of 2 chunks (2^(k - lt), k = "
          "4 targets, lt = 3)")
    scale = float(np.abs(res["one"][0]).max())
    err = float(np.abs(res["mesh"][0] - res["one"][0]).max()) / scale
    verr = max(abs(a - b) for a, b in zip(res["mesh"][1:], res["one"][1:]))
    check(err <= 1e-5 and verr <= 1e-5,
          f"23b twoQubitUnitary + mixTwoQubitDepolarising on {WIDE_SHARDS} "
          f"shards vs one device: {err:.3e} of max|amp|, purity and "
          f"fidelity {verr:.3e} <= 1e-5")
    m = NARROW_QUBITS
    res = {}
    for key, env in (("mesh", env8), ("one", env1)):
        p, p2 = qt.createQureg(m, env), qt.createQureg(m, env)
        qt.initPlusState(p)
        qt.rotateX(p, 1, 0.7)
        qt.initPlusState(p2)
        qt.rotateY(p2, 0, 1.1)
        d = qt.createDensityQureg(m, env)
        qt.initPureState(d, p)
        qt.mixDephasing(d, 0, 0.2)
        if key == "mesh":
            check(d.chunks[0].shape[-1] < (1 << m),
                  f"23b: a {m}-qubit density register's chunk holds "
                  f"{d.chunks[0].shape[-1]} of a column's {1 << m} rows")
        res[key] = (d.to_numpy(), qt.calcFidelity(d, p2))
    err = float(np.abs(res["mesh"][0] - res["one"][0]).max())
    check(err <= 1e-5 and abs(res["mesh"][1] - res["one"][1]) <= 1e-5,
          f"23b narrow chunks: initPureState {err:.3e}, calcFidelity "
          f"{res['mesh'][1]!r} vs {res['one'][1]!r} <= 1e-5")
    return {"group_bytes": peaks[0][0], "group_peak_bytes":
            max(e for _, e, _ in peaks)}


def remainder_quad(torch, qt, lk, kk, card, quad=None):
    """23c: QUAD on the mesh: phase 17's brickwork through compile_dd at
    28 q, an imperative QUAD register at 24 q, and the QUAD rung of the
    24-q HEA in amp mode; no kernel launches. ``quad``: phase 17's result,
    whose one-device planes digest and energies are the yardsticks, else
    they are computed here."""
    n = QUAD_MESH_QUBITS
    print(f"  23c: QUAD on {MESH_SHARDS} shards: phase 17's brickwork "
          f"through compile_dd at {n} q")
    env4 = mesh_env(qt, precision=qt.QUAD)
    circ = as_circuit(qt, n, brickwork(n, MAIN_LAYERS))
    if quad is not None:
        want, single_s = quad["brickwork"]["QUAD"]["digest"], \
            quad["brickwork"]["QUAD"]["run_s"]
    else:
        prog1 = circ.compile_dd(qt.createQuESTEnv(precision=qt.QUAD))
        planes, single_s = timed_s(torch, lambda: prog1.run(
            prog1.init_zero()))
        want = planes_digest(torch, planes)
        del planes, prog1
        torch.cuda.empty_cache()
    prog = circ.compile_dd(env4)
    reset_counts(lk, kk)
    chunks = prog.init_zero()
    chunks, mesh_s = timed_s(torch, lambda: prog.run(chunks))
    no_launches(lk, kk, "23c compile_dd on the mesh")
    same = torch.equal(planes_digest(torch, chunks), want)
    tp = prog.total_prob(chunks)
    check(same and abs(tp - 1.0) <= 1e-12,
          f"23c compile_dd {n} q: the {MESH_SHARDS} chunks' dd planes equal "
          f"one device's bit for bit (digest), total_prob {tp!r}; "
          f"{mesh_s:.2f} s on {MESH_SHARDS} shards ({prog.num_steps} steps, "
          f"{prog.layout_plan.num_relayouts} relayouts), {single_s:.2f} s "
          f"on one device")
    out = {"brickwork_s": mesh_s, "brickwork_single_s": single_s}
    del chunks, prog
    torch.cuda.empty_cache()
    m = QUAD_MESH_IMPERATIVE_QUBITS
    u = random_unitary(np.random.default_rng(17), 4)
    regs = {}
    for key, env in (("mesh", env4),
                     ("one", qt.createQuESTEnv(precision=qt.QUAD))):
        q = qt.createQureg(m, env)
        qt.initPlusState(q)
        _, secs = timed_s(torch, lambda: (
            qt.rotateY(q, m - 1, 0.3), qt.hadamard(q, 0),
            qt.twoQubitUnitary(q, m - 1, 0, u),
            qt.controlledNot(q, m - 1, 1), qt.tGate(q, m - 2)))
        regs[key] = (q, secs, qt.calcTotalProb(q),
                     qt.calcExpecPauliProd(q, [0, m - 1], [1, 3]))
    q4, s4, t4, e4 = regs["mesh"]
    q1, s1, t1, e1 = regs["one"]
    q4.ensure_canonical()
    err = dd_chunk_err(torch, q4.chunks, q1.state)
    no_launches(lk, kk, "23c imperative QUAD")
    check(err <= 1e-12 and abs(t4 - t1) <= 1e-12 and abs(e4 - e1) <= 1e-12,
          f"23c imperative QUAD {m} q with a cross-shard two-qubit unitary:"
          f" planes {err:.3e} of max|amp|, total {t4!r} vs {t1!r}, <X0 "
          f"Z{m - 1}> {e4!r} vs {e1!r} <= 1e-12; {s4 * 1e3:.1f} ms on "
          f"{MESH_SHARDS} shards, {s1 * 1e3:.1f} ms on one device")
    del regs, q4, q1
    torch.cuda.empty_cache()
    circ, terms, coeffs, _, pm = hea_problem(qt)
    pm = pm[:QUAD_SWEEP_BATCH]
    ham = (terms, coeffs)
    if quad is not None:
        ref, ref_s = quad["sweep"]["energies"], quad["sweep"]["quad_s"]
    else:
        cc1 = circ.compile(qt.createQuESTEnv(precision=qt.DOUBLE))
        ref, ref_s = timed_s(torch, lambda: cc1.expectation_sweep(
            pm, ham, tier="quad"))
    cc = circ.compile(mesh_env(qt, precision=qt.DOUBLE))
    reset_counts(lk, kk)
    with BatchMemLimit(1):
        vals, secs = timed_s(torch, lambda: cc.expectation_sweep(
            pm, ham, tier="quad"))
    no_launches(lk, kk, "23c expectation_sweep(tier='quad') in amp mode")
    mode = cc.dispatch_stats().batch_sharding_mode
    err = float(np.abs(vals - ref).max()) / float(np.abs(ref).max())
    check(mode == "amp" and err <= 1e-12,
          f"23c tier='quad' HEA {SWEEP_QUBITS} q batch {len(pm)} in {mode} "
          f"mode vs one device's QUAD rung: {err:.3e} of max|E| <= 1e-12; "
          f"{secs:.2f} s on {MESH_SHARDS} shards, {ref_s:.2f} s on one "
          "device")
    out.update(sweep_s=secs, sweep_single_s=ref_s)
    return out


def remainder_serving(torch, qt, lk, kk, card, sweep=None, rest=None):
    """23d: serving on mesh envs: bench.py:2812's replicated cell through
    a router of 2 replicas x 2 shards, one 24-q HEA batch of 64 through a
    service on 4 shards, one 16-q trajectory request; every batched-layer
    and Kraus launch held against its plain version."""
    import warnings
    from quest_tpu_torch.resilience import SupervisorPolicy
    from quest_tpu_torch.serve import ServiceRouter, replica_envs
    from quest_tpu_torch.testing import lockcheck
    n, N = SERVE_QUBITS, ROUTER_REQUESTS
    circ, ham, pm = router_trace(qt, n)
    names = circ.param_names
    want = circ.compile(qt.createQuESTEnv(seed=[ROUTER_SEED])) \
        .expectation_sweep(pm, ham)
    scale = float(np.abs(want).max())
    k = MESH_REPLICA_SHARDS
    buckets = [1 << j for j in range(ROUTER_BATCH.bit_length())
               if (1 << j) >= k]
    print(f"  23d: {N} requests of bench.py:2812's cell through "
          f"{ROUTER_REPLICAS} replicas x {k} shards on {card}, every "
          "batched layer launch held against its plain version")
    was = lockcheck.installed()
    lockcheck.install()
    before = len(lockcheck.violations())
    out = {}
    try:
        router = ServiceRouter(
            replica_envs(ROUTER_REPLICAS, devices_per_replica=k,
                         seed=[ROUTER_SEED]),
            supervisor=SupervisorPolicy(poll_s=0.01, stall_timeout_s=30.0,
                                        restart_backoff_s=0.02),
            warm_cache=False, max_batch=ROUTER_BATCH, max_wait_s=SERVE_WAIT,
            max_queue=N + ROUTER_BATCH, request_timeout_s=600.0)
        router.warm(circ, batch_sizes=buckets, observables=ham)
        reset_counts(lk, kk)
        with HeldLayers(torch, lk, batched=True) as held, \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            futs = [router.submit(circ, dict(zip(names, pm[i])),
                                  observables=ham) for i in range(N)]
            got = np.array([f.result(timeout=600) for f in futs])
            wall = time.perf_counter() - t0
        stats = router.dispatch_stats()
        router.close()
        r = stats["router"]
        dev = float(np.abs(got - want).max()) / scale
        h_abs, h_rel = held.max_err()
        print(f"  23d router: {N / wall:.1f} requests/s ({wall:.2f} s, with "
              f"the holds), p99 {r['p99_latency_s'] * 1e3:.1f} ms; phase "
              "19a's one-device replicas: " + (
                  f"{rest['router_rates']['clean']:.1f} requests/s, p99 "
                  f"{rest['router_p99']['clean'] * 1e3:.1f} ms"
                  if rest is not None else "not run"))
        for i, rep in enumerate(stats["replicas"]):
            s = rep["service"]
            rows = s["coalesced_requests"] + s["padded_rows"]
            check(s["failed"] == 0 and rows % k == 0 and s["completed"] > 0,
                  f"23d replica {i}: {s['completed']} served in "
                  f"{s['batches']} batches, {rows} rows dispatched, a "
                  f"multiple of its {k} shards")
        check(r["routed"] == N and r["failovers"] == 0 and dev <= 1e-5
              and not any("padding" in str(w.message) for w in caught),
              f"23d: {r['routed']} routed, 0 dropped, no failover, no "
              f"pad-and-mask; energies vs a direct expectation_sweep "
              f"{dev:.3e} of max|E| <= 1e-5")
        check(held.launches > 0 and len(held.errs) == held.launches
              and h_rel <= 1e-5,
              f"23d router: {held.launches} batched layer launches, each "
              f"against its plain version on its own input: max|diff| "
              f"{h_abs:.3e}, / max|plain| {h_rel:.3e} <= 1e-5")
        out.update(router_rate=N / wall, router_p99_s=r["p99_latency_s"],
                   router_launches=held.launches, router_err=h_abs)
        # one 24-q HEA batch of 64 through a service on 4 shards
        hcirc, terms, coeffs, _, hpm = hea_problem(qt)
        hham = (terms, coeffs)
        env4 = mesh_env(qt, seed=[2026])
        if sweep is not None:
            ref = sweep["energies"]
        else:
            ref = hcirc.compile(qt.createQuESTEnv(seed=[2026])) \
                .expectation_sweep(hpm, hham)
        svc = qt.createSimulationService(env4, max_batch=SWEEP_BATCH,
                                         max_wait_s=SERVE_WAIT,
                                         request_timeout_s=600.0)
        cc = hcirc.compile(env4)
        svc.pause()
        futs = [svc.submit(cc, hpm[i], observables=hham)
                for i in range(len(hpm))]
        reset_counts(lk, kk)
        with HeldLayers(torch, lk, batched=True) as held:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            svc.resume()
            got = np.array([f.result(timeout=600) for f in futs])
            secs = time.perf_counter() - t0
        st = svc.dispatch_stats()
        svc.close()
        dev = float(np.abs(got - ref).max()) / float(np.abs(ref).max())
        h_abs, h_rel = held.max_err()
        check_clean(st, "23d service")
        check(st["service"]["batches"] == 1 and st["batch_size"] == 64
              and dev <= 1e-5 and held.launches > 0
              and h_rel <= 1e-5,
              f"23d service on {MESH_SHARDS} shards: one dispatch of "
              f"{st['batch_size']} rows in {st['batch_sharding_mode']} mode,"
              f" {secs:.2f} s with {held.launches} batched layer launches "
              f"held against plain (max|diff| {h_abs:.3e}, / max|plain| "
              f"{h_rel:.3e}); energies vs a direct expectation_sweep "
              f"{dev:.3e} of max|E| <= 1e-5")
        out.update(hea_s=secs, hea_launches=held.launches,
                   hea_err=h_abs, hea_mode=st["batch_sharding_mode"])
        del svc, cc
        torch.cuda.empty_cache()
        # one trajectory request of 128 trajectories at 16 q on 4 shards
        tn, T = MESH_SERVE_TRAJ_QUBITS, MESH_SERVE_TRAJ_T
        rng = np.random.default_rng(2110)
        tcirc = trajectory_circuit(qt, tn, rng)
        tham = ([[(q, 3)] for q in range(tn)], list(rng.normal(size=tn)))
        svc = qt.createSimulationService(env4, max_batch=8,
                                         max_wait_s=SERVE_WAIT,
                                         request_timeout_s=600.0)
        tp = svc.warm(tcirc, observables=tham, trajectories=T)
        qt.seedQuEST(env4, [7])
        reset_counts(lk, kk)
        with HeldKraus(torch, kk) as hk, \
                HeldLayers(torch, lk, batched=True) as hl:
            res, tsecs = timed_s(torch, lambda: svc.submit(
                tcirc, None, observables=tham,
                trajectories=T).result(timeout=600))
        st = svc.dispatch_stats()
        svc.close()
        qt.seedQuEST(env4, [7])
        means, _, _ = tp.expectation_batch(np.zeros((1, 0)), tham, T,
                                           live_rows=1)
        tdev = abs(res[0] - means[0]) / max(abs(means[0]), 1.0)
        check_clean(st, "23d trajectory request")
        check(hk.launches > 0 and hk.ok() and tdev <= 1e-5
              and (hl.launches == 0 or hl.max_err()[1] <= 1e-5),
              f"23d trajectory request ({tn} q, {T} trajectories) on "
              f"{MESH_SHARDS} shards: {tsecs:.2f} s, {hk.launches} Kraus "
              f"launches held against plain (max|diff| {hk.max_err():.3e}, "
              f"indices equal), {hl.launches} batched layer launches held; "
              f"energy vs a direct expectation_batch {tdev:.3e} <= 1e-5")
        out.update(kraus_launches=hk.launches, kraus_err=hk.max_err(),
                   traj_layer_launches=hl.launches,
                   traj_layer_err=hl.max_err()[0],
                   traj_per_s=T / tsecs)
    finally:
        new = lockcheck.violations()[before:]
        if not was:
            lockcheck.uninstall()
    check(not new and lockcheck.find_cycle() is None,
          f"23d lock order: {len(new)} violations")
    return out


def phase_mesh_remainder(torch, qt, lk, kk, card, sweep=None, quad=None,
                         rest=None):
    print(f"phase 23: the mesh's remainder, {MESH_SHARDS} shards on one card"
          f" ({card}), SINGLE unless named")
    t0 = time.perf_counter()
    out, walls = {}, []
    for key, part in (
            ("pauli", remainder_pauli), ("wide", remainder_wide),
            ("quad", lambda *a: remainder_quad(*a, quad=quad)),
            ("serving", lambda *a: remainder_serving(*a, sweep=sweep,
                                                     rest=rest))):
        t1 = time.perf_counter()
        out[key] = part(torch, qt, lk, kk, card)
        torch.cuda.empty_cache()
        walls.append(f"{key} {time.perf_counter() - t1:.1f}")
    wall = time.perf_counter() - t0
    print(f"  phase 23 wall time {wall:.1f} s ({', '.join(walls)})")
    out["wall_s"] = wall
    return out


def remainder_keys(rem, kind: str):
    """Phase 23's numbers, as keys of the layer kernel's row (``single``:
    23a's compiled brickwork), the batched layer kernel's (``batched``:
    23d's router, service and trajectory request) or the Kraus kernel's
    (``kraus``: 23d's trajectory request), every launch held against its
    plain version."""
    if rem is None:
        return {}
    p, s = rem["pauli"], rem["serving"]
    if kind == "single":
        return {"launches_mesh_remainder": p["layer_launches"],
                "mesh_remainder_max_abs_err": p["layer_err"],
                "mesh_pauli_sum_ms": p["pauli_sum_ms"],
                "mesh_pauli_sum_single_device_ms": p["pauli_sum_single_ms"],
                "mesh_density_expec_ms": p["expec_ms"],
                "mesh_density_expec_single_device_ms":
                    p["expec_single_ms"],
                "mesh_quad_brickwork_s": rem["quad"]["brickwork_s"],
                "mesh_quad_brickwork_single_device_s":
                    rem["quad"]["brickwork_single_s"],
                "mesh_wide_group_bytes": rem["wide"]["group_bytes"]}
    if kind == "kraus":
        return {"launches_mesh_remainder": s["kraus_launches"],
                "mesh_remainder_max_abs_err": s["kraus_err"],
                "mesh_serving_traj_per_s": s["traj_per_s"]}
    return {"launches_mesh_remainder": s["router_launches"]
            + s["hea_launches"] + s["traj_layer_launches"],
            "mesh_remainder_max_abs_err": max(
                s["router_err"], s["hea_err"], s["traj_layer_err"]),
            "mesh_router_requests_per_s": s["router_rate"],
            "mesh_router_p99_s": s["router_p99_s"],
            "mesh_service_hea_s": s["hea_s"],
            "mesh_quad_sweep_s": rem["quad"]["sweep_s"]}


PHASES = ("3", "3b", "3c", "3d", "3e", "4", "5", "6", "7", "8", "9", "9g",
          "10", "11", "12", "12d", "13", "14", "15", "16", "17", "18",
          "19", "20", "21", "22", "23")


def parse_only(argv):
    """The phases ``--only a,b,...`` names (None: every phase). 6 and 7
    time and profile phase 4's compiled circuit, so they bring 4."""
    if not argv:
        return None
    if len(argv) != 2 or argv[0] != "--only":
        raise SmokeFailure(f"usage: chip_smoke.py [--only {','.join(PHASES)}]"
                           f", got {argv}")
    only = set(argv[1].split(","))
    unknown = only - set(PHASES)
    if unknown or not only:
        raise SmokeFailure(f"unknown phases {sorted(unknown)}; phases are "
                           f"{', '.join(PHASES)}")
    if only & {"6", "7"}:
        only.add("4")
    return only


def main(argv) -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not importable", file=sys.stderr)
        return 2
    started = time.perf_counter()
    # each phase's wall time: what passes between one phase's ``runs``
    # question and the next one's belongs to the phase asked about
    walls, asked = {}, ["1-2", started]

    def runs(phase):
        now = time.perf_counter()
        if asked[0] is not None:
            walls[asked[0]] = walls.get(asked[0], 0.0) + now - asked[1]
        asked[:] = [phase, now]
        return only is None or phase in only

    try:
        only = parse_only(argv)
        card = phase_device(torch)
        import quest_tpu_torch as qt
        from quest_tpu_torch.ops import kraus_kernel as kk
        from quest_tpu_torch.ops import layer_kernel as lk
        phase_build(torch)
        rng = np.random.default_rng(20261016)
        if runs("3"):
            phase_stages(torch, lk, rng)
        if runs("3b"):
            phase_batched_stages(torch, lk, rng)
        if runs("3c"):
            phase_kraus(torch, kk, rng)
        if runs("3d"):
            phase_fast_stages(torch, qt, lk, rng)
        mxu_row = phase_mxu_tile(torch, qt, lk, kk, rng, card) \
            if runs("3e") else None
        if runs("4"):
            env, compiled, q1, gates, launches = phase_main(torch, qt, lk)
        if runs("5"):
            phase_tutorial(torch, qt)
        row = phase_times(torch, qt, lk, env, compiled, q1, gates, launches,
                          card) if runs("6") else None
        if runs("7"):
            print(f"phase 7: profile of one compiled run on {card}")
            profile_device(torch, lambda: compiled.run(q1),
                           "one compiled run")
        if runs("4"):
            del compiled, q1
            torch.cuda.empty_cache()
        sweep = phase_sweep(torch, qt, lk, kk, card) if runs("8") else None
        traj = phase_trajectories(torch, qt, lk, kk, card) \
            if runs("9") else None
        torch.cuda.empty_cache()
        traj_grad = phase_traj_gradients(torch, qt, lk, kk, card) \
            if runs("9g") else None
        torch.cuda.empty_cache()
        fast_row = phase_fast_main(torch, qt, lk, kk, card) \
            if runs("10") else None
        torch.cuda.empty_cache()
        fast_batched_row = phase_fast_sweep(torch, qt, lk, kk, card) \
            if runs("11") else None
        torch.cuda.empty_cache()
        density = phase_density(torch, qt, lk, kk, card) \
            if runs("12") else None
        torch.cuda.empty_cache()
        # 13 before 12d: 12d times its gradient's first call, which then
        # finds the parameter binding's torch.func transforms warm
        grad = phase_grad(torch, qt, lk, kk, card) if runs("13") else None
        torch.cuda.empty_cache()
        density_grad = phase_density_grad(torch, qt, lk, kk, card) \
            if runs("12d") else None
        torch.cuda.empty_cache()
        remainder = phase_remainder(torch, qt, lk, kk, card) \
            if runs("14") else None
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        dynamics = phase_dynamics(torch, qt, lk, kk, card) \
            if runs("15") else None
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        algorithms = phase_algorithms(torch, qt, lk, kk, card) \
            if runs("16") else None
        print(f"phases 15 and 16 wall time: {t1 - t0:.1f} + "
              f"{time.perf_counter() - t1:.1f} s")
        torch.cuda.empty_cache()
        quad = phase_quad(torch, qt, lk, kk, card) if runs("17") else None
        torch.cuda.empty_cache()
        serving = phase_serving(torch, qt, lk, kk, card) \
            if runs("18") else None
        torch.cuda.empty_cache()
        serving_rest = phase_serving_rest(torch, qt, lk, kk, card) \
            if runs("19") else None
        torch.cuda.empty_cache()
        netserve = phase_netserve(torch, qt, lk, kk, card) \
            if runs("20") else None
        torch.cuda.empty_cache()
        mesh = phase_mesh(torch, qt, lk, kk, card, sweep) \
            if runs("21") else None
        torch.cuda.empty_cache()
        ensembles = phase_mesh_ensembles(
            torch, qt, lk, kk, card, traj, traj_grad, dynamics,
            density_grad) if runs("22") else None
        torch.cuda.empty_cache()
        remainder23 = phase_mesh_remainder(
            torch, qt, lk, kk, card, sweep, quad, serving_rest) \
            if runs("23") else None
        if row is not None and density is not None:
            # ``launches`` stays the main path's count; the density QFT's
            # own run is ``launches_density``
            row = dict(row, **density_keys(density))
        if row is not None and remainder is not None:
            row = dict(row, remainder=remainder)
        if row is not None and algorithms is not None:
            row = dict(row, **algorithm_keys(algorithms))
        if row is not None and quad is not None:
            row = dict(row, **quad_keys(quad))
        if row is not None and serving_rest is not None:
            row = dict(row, **serving_rest_keys(serving_rest, single=True))
        if row is not None and mesh is not None:
            row = dict(row, **mesh_keys(mesh))
        if row is not None and ensembles is not None:
            row = dict(row, **ensemble_keys(ensembles, single=True))
        if row is not None and remainder23 is not None:
            row = dict(row, **remainder_keys(remainder23, "single"))
        tail = [fast_row, fast_batched_row, mxu_row]
        if density is not None:
            tail.append(diag_row(density))
        if only is None:
            rows = kernel_rows(row, sweep, traj, grad, density_grad,
                               traj_grad, dynamics, serving,
                               serving_rest, netserve) + tail
            rows[1] = dict(rows[1], **mesh_keys(mesh, batched=True),
                           **ensemble_keys(ensembles))
            rows[2] = dict(rows[2], **ensemble_keys(ensembles, kraus=True))
            rows[1] = dict(rows[1], **remainder_keys(remainder23,
                                                     "batched"))
            rows[2] = dict(rows[2], **remainder_keys(remainder23, "kraus"))
        else:
            rows = [r for r in [row] + tail if r is not None]
            if row is None and density is not None:
                rows.append(dict(name="layer_kernel", path="density",
                                 **density_keys(density)))
            if row is None and remainder is not None:
                rows.append(dict(name="layer_kernel", path="remainder",
                                 remainder=remainder))
            if grad is not None or density_grad is not None:
                rows.append(dict(name="layer_kernel_batched",
                                 path="gradient",
                                 **gradient_keys(grad, density_grad)))
            if row is None and algorithms is not None:
                rows.append(dict(name="layer_kernel", path="algorithms",
                                 **algorithm_keys(algorithms)))
            if row is None and quad is not None:
                rows.append(dict(name="layer_kernel", path="quad",
                                 **quad_keys(quad)))
            if dynamics is not None:
                rows.append(dict(name="layer_kernel_batched",
                                 path="dynamics",
                                 **dynamics_keys(dynamics)))
            if traj_grad is not None:
                rows.append(dict(name="layer_kernel_batched",
                                 path="traj_gradient",
                                 **traj_gradient_keys(traj_grad)))
                rows.append(dict(name="kraus_kernel", path="traj_gradient",
                                 **traj_gradient_keys(traj_grad, True)))
            if serving is not None:
                rows.append(dict(name="layer_kernel_batched",
                                 path="serving",
                                 **serving_keys(serving)))
                rows.append(dict(name="kraus_kernel", path="serving",
                                 **serving_keys(serving, kraus=True)))
            if serving_rest is not None:
                rows.append(dict(name="layer_kernel", path="serving_rest",
                                 **serving_rest_keys(serving_rest,
                                                     single=True)))
                rows.append(dict(name="layer_kernel_batched",
                                 path="serving_rest",
                                 **serving_rest_keys(serving_rest)))
                rows.append(dict(name="kraus_kernel", path="serving_rest",
                                 **serving_rest_keys(serving_rest,
                                                     kraus=True)))
            if netserve is not None:
                rows.append(dict(name="layer_kernel_batched",
                                 path="netserve", **netserve_keys(netserve)))
                rows.append(dict(name="kraus_kernel", path="netserve",
                                 **netserve_keys(netserve, kraus=True)))
            if mesh is not None:
                rows.append(dict(name="layer_kernel", path="mesh",
                                 **mesh_keys(mesh)))
                rows.append(dict(name="layer_kernel_batched", path="mesh",
                                 **mesh_keys(mesh, batched=True)))
            if ensembles is not None:
                rows.append(dict(name="layer_kernel", path="mesh_ensembles",
                                 **ensemble_keys(ensembles, single=True)))
                rows.append(dict(name="layer_kernel_batched",
                                 path="mesh_ensembles",
                                 **ensemble_keys(ensembles)))
                rows.append(dict(name="kraus_kernel", path="mesh_ensembles",
                                 **ensemble_keys(ensembles, kraus=True)))
            if remainder23 is not None:
                for name, kind in (("layer_kernel", "single"),
                                   ("layer_kernel_batched", "batched"),
                                   ("kraus_kernel", "kraus")):
                    rows.append(dict(name=name, path="mesh_remainder",
                                     **remainder_keys(remainder23, kind)))
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    except ImportError as e:
        print(f"FAIL: {e} (run from the root of a checkout)",
              file=sys.stderr)
        return 2
    runs(None)
    print("phase wall times (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in walls.items() if v >= 0.05))
    print(f"script wall time {time.perf_counter() - started:.1f} s")
    if only is not None:
        # a partial run: its rows, and never the result line
        print(json.dumps({"only": sorted(only, key=PHASES.index),
                          "kernels": rows}))
        print(f"partial run ({','.join(sorted(only, key=PHASES.index))}): "
              "every check passed; the whole check is the run without "
              "--only")
        return 0
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
