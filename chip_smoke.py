#!/usr/bin/env python3
"""Drive the PyTorch port (mpcium_tpu_torch) once on a CUDA GPU.

Phases, each printing one JSON line:

1. env — the card (nvidia-smi name and power limit), torch/CUDA
   versions, and the time to build the mulmod kernel from csrc/.
2. kernel_vs_plain — for each modulus width of the signing path
   (2048-bit N, NTilde, p² and 4096-bit N² of the 2048-bit fixture) and
   of the warm pass (the 1024-bit fixture's N, n=160, one word a lane):
   B random reduced operands plus the edges 0, 1, m-1 and the unreduced
   operands R^occ - 1 and 2^(32k) that the JAX kernel still accepts; the
   kernel must equal the plain PyTorch version bit for bit, and sampled
   rows (the edges among them) must equal python-int a·b mod m. Rows of
   all-ones limbs, beyond the JAX kernel's domain, must still equal
   python ints. Times come from CUDA events: one event pair around 100
   back-to-back calls, divided by 100, median of twenty such groups, with
   the host's own time per enqueued call beside each. The kernel's own
   time comes from a CUDA graph of 100 launches of its C entry point,
   replayed between one event pair, so no host work sits between the
   launches; the wrapper's time per call (host work included) and the
   plain version's are printed beside it.
3. powmod_vs_plain — the whole-exponentiation entry in each mode
   (row: per-row exponent; shared: one exponent for the batch; comb:
   fixed-base comb table) at n=320 (2048-bit N) and n=608 (4096-bit
   N²), B rows, at the exponent widths of the signing path (256, 760
   and 1784 bits per row, the 1024-bit decryption exponent p-1 shared,
   RAND_BITS and 1784 bits for the comb), and at n=160 (the 1024-bit
   fixture's N: row 256 bits, its 512-bit p-1 shared, comb RAND_BITS).
   Edge rows: bases 0, 1, m-1
   and exponents 0, 1, all ones. The kernel must equal the plain
   version bit for bit, and sampled rows (the edges among them) python
   ``pow``; unreduced bases R^occ-1 and all-ones rows, beyond the plain
   version's domain, must equal python ``pow``. Kernel ms per launch:
   one CUDA event pair around each of seven launches of the C entry,
   median; the plain version's ms from one event pair around its call;
   the steps (modular multiplies) each row needs and the squarings among
   them, from the digits.
4. slice — dealer keygen for B wallets (2-of-3), then two GG18
   Paillier-MtA batched signatures over B digests each with a seeded
   stream: the first builds the per-key fixed-base tables and is
   reported as first_sign_s; the second is the measured one (sigs/s).
   Every (r, s) of the measured sign is verified on the host with the
   port's python-int ECDSA verifier; the kernel launch counters are
   zeroed just before it and must show launches of both entries at both
   widths (powmod: row and comb at both, shared at n=320), and the
   plain versions none.
5. golden — the B=2 case of the JAX engine's committed golden signed on
   the card: (r, s, recovery, ok) must match byte for byte.

The OT-MtA backend (``mta_impl="ot"``: IKNP extension, KOS / Gilboa /
consistency checks; it launches no K0):

6. ot_leg_golden — a synthetic OT leg on the card (fixed base-OT keys
   and tag, B=4): the three-round wire messages, the run_multi
   transcript at chunks 1 and 2, both shares and the check verdicts
   must equal the JAX leg's committed golden byte for byte.
7. ot_tamper — the eight wire fields an active cheater controls (U, the
   KOS tags, y0, y1, D, B_pt, Beta_pt), each corrupted on its own lane
   at B=4: check_blame() must name the owner and the check of the JAX
   table on that lane and no one on the others.
8. ot_slice — the slice's B wallets signed twice with the OT backend at
   cohorts=2 (setup_s includes the base OTs; first_sign_s, then the
   measured warm sign with its phases and the run_multi timings).
   Every (r, s) verified on the host, no blame on any leg, and the K0
   counters, zeroed just before the warm sign, read 0.
9. ot_golden — the B=2 case of the JAX engine's committed OT golden
   signed on the card: (r, s, recovery, ok) byte for byte.

Batched threshold-EdDSA (2-of-3 Ed25519: SHA-512, the edwards25519
group, the EdDSA engine and the batched party; plain torch, no K0):

10. sha512_vs_hashlib — 64 random rows at each of the lengths 0, 96,
    111, 112, 128, 239 and 240, and EDDSA_B challenge-shaped rows of 96
    bytes: every digest must equal hashlib's.
11. ed25519_edges — the edge table of encodings (every y ≥ p and its
    sign twin, non-residues, x = 0 with the sign bit, torsion points):
    decode ok masks, round-tripped encodings, and fixed- and
    variable-base products at 0, 1, l-1, l and 2^256-1 must equal the
    JAX package's committed golden ``ed25519_edges.json``.
12. eddsa_golden — the JAX engine's signatures and ok masks at B=4
    (cohorts 1 and 2) and its ``fused_sign_step`` output
    (``eddsa_b4.json``), and the JAX party's wire messages and results
    (``eddsa_party_b4.json``), byte for byte.
13. eddsa_slice — ``dealer_keygen_batch`` of EDDSA_B wallets (2-of-3,
    from --seed), a first sign and the measured warm sign (phases,
    sigs/s) of EDDSA_B 32-byte messages at cohorts=2; every ok true,
    every signature verified on the host, one flipped byte of one
    lane's s fails device verification on that lane only, and the K0
    counters, zeroed just before the warm sign, read 0.
14. eddsa_party — two ``BatchedEDDSASigningParty`` (node0, node1) over
    the slice's first EDDSA_PARTY_B wallets, driven by ``run_protocol``
    with span recording on: seconds per party round; both results all
    ok, equal, and verified on the host.

The wallet lifecycle (batched DKG and resharing, both curves, and the
GG18 ECDSA signing party; the party's Paillier MtA launches K0, DKG and
resharing do not):

15. ecdsa_party_golden — the JAX party's committed golden
    (``gg18_party_b4.json``: two parties of a 2-of-3 universe sign B=4
    digests on the 1024-bit fixture with shrunk domains) replayed at
    cohorts 1 and 2: every wire message (long fields by digest), each
    party's (r, s, recovery, ok) and the material digests, byte for byte.
16. dkg_golden — the JAX engines' ``dkg_b4.json`` (BatchedDKG on both
    curves, then BatchedReshare to 3-of-5) and the JAX parties'
    ``dkg_party_b4.json`` (DKG and reshare parties on both curves, the
    secp256k1 ones with Paillier material and proofs), at cohorts 1 and
    2: wire, shares, public keys, VSS commitments and aux, byte for byte.
17. dkg_engine — BASELINE config 4: ``BatchedDKG`` of DKG_B secp256k1
    wallets (2-of-3), a first and a measured warm run (phases, wallets/s);
    every VSS check passes, every wallet's members agree on the public
    key, 64 sampled wallets Lagrange-recombine on the host to it, and
    K0's counters, zeroed just before the warm run, read 0.
18. reshare_engine — BASELINE config 5: ``BatchedReshare`` of the first
    RESHARE_B DKG wallets from the quorum node0, node1 to a 3-of-5
    committee, first and warm run; public keys unchanged, epoch 1, 64
    sampled wallets recombine from three new shares; K0 reads 0.
19. wallet_lifecycle — the distributed parties through ``run_protocol``
    with span recording on, on the 2048-bit fixture with full
    ``Domains()``: three ``BatchedDKGParty`` create LIFECYCLE_B
    secp256k1 wallets (K0 reads 0); node0's and node1's material digests
    agree;
    node0 + node1 sign LIFECYCLE_B digests with
    ``BatchedECDSASigningParty`` (K0's counters zeroed just before: both
    entries at both widths, every powmod mode of the path, no plain
    call); ``BatchedReshareParty`` rotates to node0–node2 (t=1, epoch 1,
    keys unchanged, K0 reads 0); node1 + node2 sign LIFECYCLE_B digests
    with the new shares. Every ok true, the parties agree, every
    signature verified on the host; seconds per runner round and per
    party phase. The phase runs on a spawned process of its own (niced;
    its K0 counters are its own), started after phase 3 beside phases 24
    and 25 and joined after phase 23, where its line is printed.
20. eddsa_dkg — three ed25519 ``BatchedDKGParty`` create LIFECYCLE_B
    wallets (K0 reads 0), and ``BatchedEDDSASigningParty`` node0 + node1 sign with
    them: every ok true, every signature verified on the host.

The per-session protocols (one wallet per session, host python ints;
the wallets they make sign in the batched parties on the card):

21. session_eddsa — SESSION_ED_W ed25519 wallets by ``EDDSAKeygenParty``
    (2-of-3), each signed per session by node0 + node1 twice: with
    ``MPCIUM_EDDSA_DEVICE_HASH_SESSION=1`` (the challenge through
    ``ops.hash_suite.sha512_bytes`` on the card) and without (hashlib),
    and the two signatures must be equal byte for byte; SESSION_ED_ROTATE
    of them rotated by ``ResharingParty`` (node0 + node1 → node0–node2,
    epoch 1) and signed again by node1 + node2; all of them signed as one
    batch by ``BatchedEDDSASigningParty`` (node0 + node2) on the card.
    Every signature verified on the host, and the JAX parties' golden
    ``session_eddsa.json`` replayed with the device hash on, each run
    through a snapshot and restore, byte for byte.
22. session_ecdsa — SESSION_W secp256k1 wallets, one task each on a
    spawned pool of their own that main() starts before the first GPU
    phase (niced, so the main process keeps priority): a 2-of-3
    ``ECDSAKeygenParty`` on the 2048-bit fixture at the full
    ``MIN_PAILLIER_BITS``, an ``ECDSASigningParty`` sign by node0 + node1,
    a ``ResharingParty`` rotation from node0 + node1 to node0–node2 (t=1,
    epoch 1) and a sign by node1 + node2; both signatures verified on the
    host against the keygen's key. The line gives each protocol's wall
    per wallet and the wait at the join. Cut in depth from 4 wallets to 2
    in PR 13: the host's cores are the script's bottleneck.
23. session_batch_sign — the epoch-1 shares of phase 22 signed as one
    batch by node1 + node2 with ``BatchedECDSASigningParty`` (full
    ``Domains()``) on the card: the shares' quorum material digests must
    be equal and non-empty (the scheduler's admission test), K0's
    counters zeroed just before must show launches of both entries and
    no plain call, and every (r, s) must verify on the host against the
    per-session keys.

The serving path (a cluster of nodes over the loopback fabric, driven
through the client; the batch scheduler hands every batch to the
batched parties on the card):

24. serving — ``LocalCluster`` of node0–node2 (t=1, ``batch_signing``,
    the 2048-bit fixture, full ``Domains()``, ``min_paillier_bits``
    2046, ``device="cuda"``, the deployment settings of
    ``SERVING_CFG``): SERVING_W wallets created in one burst (one ``kg``
    batch per node: both curves' DKG parties; K0 reads 0), then SERVING_W
    ECDSA and SERVING_W EdDSA signs in one burst (one batch per curve per
    node; K0's counters zeroed just before must show both entries at
    both widths, every powmod mode of the path, no plain call). The
    phase is cut to create → sign (``reduced``): phase 25 rotates and
    signs again across processes. Every signature verified on the
    host against the keygen events' keys; on every node
    ``scheduler.fallback_total``, ``shed_total``, ``quarantined_total``
    and ``declined_total`` read 0, each stage grew ``batches_run`` by the
    batches it needs, the batches dispatched in a stage add up to its
    burst, and no session failed or ran outside a batch (on the
    per-session path, on the host). The line gives per stage the wall
    from the first submit to the last result, each node's intake time,
    wallets/s and sigs/s, the batch sizes, the party rounds' and phases'
    seconds (spans, summed over the nodes) and the thread-seconds of
    envelope crypto (Ed25519) and store crypto (ChaCha20-Poly1305). The
    phase runs on a spawned process of its own (niced; its K0 counters
    are its own), started after phase 3 so it overlaps phases 4–23 and
    never the kernel timings, and joined after phase 23; the main process
    verifies its signatures and prints its lines with the wait at the
    join.

The networked deployment (the same node stack as separate processes
over an encrypted TCP broker, driven through ``RemoteCluster``):

25. deployment — the port's ops CLI bootstraps a workspace
    (``generate-peers -n 3``, ``register-peers`` into the broker's
    control plane, ``generate-identity`` per node, ``generate-initiator``);
    ``python -m mpcium_tpu_torch.cli.main broker --encrypt --journal …``
    and three ``… start -n nodeN`` run as processes of their own (the
    daemons on their default device, the GPU; each builds K0 at its first
    launch), with ``control_plane: broker``, the token in
    ``MPCIUM_BROKER_TOKEN``, the copy of the safe-prime pool, phase 24's
    batching settings, ``reply_timeout_s`` 900 and a warm pass at boot
    (``DEPLOY_WARM``: ``warm_enabled``, ``warm_schemes: eddsa``,
    ``warm_max_b: 4``) in ``config.yaml``; the deployment waits until every
    daemon has seen its peers and finished its boot. Through
    ``RemoteCluster``: DEPLOY_W wallets created in one burst,
    DEPLOY_W ECDSA + DEPLOY_W EdDSA signs, every wallet rotated on both
    curves (t=1, epoch 1 in the broker's keyinfo, keys kept) and signed
    again. Read from ``health/<node>`` in the broker KV after each stage:
    every node ran the batches the stage needs, the requests its leaders
    dispatched add up to the burst, fallback, shed, quarantine and
    declined read 0, each node's K0 gauges grew across each sign stage
    (both entries at both widths, every powmod mode of the path, no plain
    call) and stayed put around create and reshare, and at the end the
    ``compile`` section reads ready with the K0 build entry (cache hit or
    miss) and one entry per captured graph, EdDSA and GG18 graphs both
    among them. No result may be a timeout and no dead letter may arrive, and
    every daemon's warm report (``WARM_MANIFEST.json``) must show its
    three EdDSA buckets warmed (or already run) on the card, none failed
    or skipped.
    Then SIGTERM to every daemon and to the broker: each must exit 0
    within 30 s, and node0's flight recorder (written at shutdown) must
    pass ``trace.validate_chrome``. Its client runs on a spawned process
    of its own beside phase 24's and touches no device; the main process
    verifies every signature and prints the stage lines and the phase
    line with phase 24's walls beside it.

Soak and chaos (fault plans, the faulty transport and the drills against
the port's clusters; phase 26 runs last on the goldens' process, phase
27 last in phase 19's child process, after its lifecycle and phase 33,
where the fewest other lanes share the host and the card; the main
process prints their lines at the end):

26. chaos — ``faults.chaos.run_all`` on the card (``device="cuda"``,
    seed CHAOS_SEED, scale 1.0): node-crash, drop-jitter,
    broker-failover, partition, kill-resume (its ``warm_for_drill``
    signs the EdDSA bucket of 2 on the card first) and cheater (its
    OT-MtA leg on the card). One line per drill: outcome, ok,
    ``duration_s``, the fault counters, ``resume_latency_s`` and
    ``warm`` for kill-resume, ``culprit`` and ``survivors`` for the
    cheater, and the event count of the drill's trace document. The
    phase fails unless every drill reports its expected outcome and the
    cheater's leg computed on ``cuda``.
27. soak — ``soak.run_soak`` on the card with the JAX package's recorded
    soak configuration (``SOAK_CFG``: 3 nodes, t=1, 12 dealer ed25519
    wallets, bursts of 16 signs every 0.3 s, a quarter interactive,
    ``batch-chaos`` at scale 1.0, a queue depth of 10 below the burst so
    backpressure sheds and retries run), all three bursts (48 signs;
    earlier cut to one burst, before the EdDSA engine replayed CUDA
    graphs; ``reduced`` is null). The line is the
    report without its trace (outcomes, latency percentiles, throughput,
    scheduler counters) with the batch sizes from the trace's dispatch
    spans and how its party sessions overlapped (the most live at once,
    when the first and the last ended). It fails unless the books close
    (``accounting_ok``, ``pending`` 0), every success event's signature
    verifies on the host under its wallet's key (and every succeeded
    request has one), ``scheduler.fallback_total`` and
    ``scheduler.declined_total`` read 0 on every node, and at least one
    batch fired on the card.

The daemon's boot (both phases run in phase 25's child process after
its deployment returns, phase 29 first, in a process that has not
touched the card, as a daemon's boot has not; the main process prints
their lines after phase 25's):

28. sharded — the session axis split over meshes whose entries are all
    the one card (``torch.cuda.device_count()`` is printed): the EdDSA
    two-phase step (``engine.sharded.sharded_sign``, the host SHA-512
    between the phases) at SHARDED_EDDSA_B on a one-device mesh and on
    the meshes of SHARDED_MESHES (committee 1 over two entries, committee
    2 over four); the GG18 curve leg of the JAX dry run
    (``shard_gg18_sessions`` + ``gg18_curve_leg``) at SHARDED_GG18_B,
    unsharded and over SHARDED_GG18_MESH shards; and K0's product over
    the 2048-bit Paillier N of the fixture at SHARDED_MULMOD_B through one
    context and through ``sharded_mulmod`` (K0's counters zeroed just
    before: one launch per shard, no plain call). Each sharded result
    must equal its unsharded run byte for byte, the products python
    ints, and every signature must verify on the host. The line gives
    each run's wall beside the unsharded one and the meshes as built.
29. warm — ``warm.prewarm.prewarm`` on the card over every serving
    engine at bucket 1 (the four schemes, q=2, both curves, both MtA
    backends; 12 entries): every entry warmed on ``cuda``, none failed
    or skipped, K0 launched by the two Paillier entries only (their
    ``cache`` is K0's build verdict), and at n=160 by both entries in
    every powmod mode; the EdDSA engine's entry and the GG18 engine's and
    party's entries captured their graphs (their ``graphs`` hits and
    misses; K0's verdict beside them as ``k0``); ``warm_s`` per entry and
    ``torch.cuda.memory_reserved()`` after the pass.

The measurement tooling (the engines' phase spans, ``perf/profile.py``,
``perf/microbench.py`` and ``perf/statcheck.py``); phases 30 and 31 in
the main process after phase 23, phase 32 on the goldens' process
(below):

30. profile — a third warm Paillier sign of phase 4's signer (B wallets,
    cohorts 2, fresh digests) under tracing and
    ``perf.profile.device_profile`` (``torch.profiler``, CUDA activity):
    ``tracing.phase_share`` and ``device_idle_fraction`` of its spans, the
    fold's ``<phase>_device_op_s``, the device events captured, K0's
    kernel events among them and their seconds, the device seconds left
    outside every phase window, the busy share (folded device seconds
    over the traced window), the capture's size, the seconds to write and
    to fold it, the ten kernels with the most device time, and the
    profiled wall over phase 4's measured wall. It fails unless every
    signature verifies on the host, the fold is non-empty, K0's kernel
    events equal K0's launch counters for the sign, no plain version ran,
    and the spans' phases are the measured sign's ``phases_s`` keys.
31. ot_phase_share — one traced OT-MtA sign of phase 8's signer (B,
    cohorts 2; spans only): ``phase_share`` with the OT phase's
    host/device attributes, and ``device_idle_fraction``; every signature
    verified on the host. In the main process after phase 30.
32. microbench — ``perf.microbench.run_all(samples=30, device="cuda")``:
    each row's median, p90 and spread (max over min), and
    ``statcheck.gate`` on each row's samples, which must pass against
    themselves and fail against a copy scaled by 1.5. That verdict is
    certain only for samples spread less than 1.5×: a row whose scaled
    copy passes is measured once more (the JAX perfcheck's one retry),
    and the second measurement must be flagged. It runs on the process
    of the golden phases (below), off the main process's path.

The host pipelined OT extension (``MPCIUM_OT_DEVICE=0``: a worker
thread over the g++-built ``mpcium_tpu_torch/native/`` library), in
phase 19's child process between its lifecycle and phase 27:

33. ot_host — (a) one OT-MtA leg at B (fixed base-OT keys, one seeded
    stream, two payload sets, ``resolve_chunks(B)`` chunks) through the
    serial three-round composition (the shape's first run, which pays
    the allocator's warm-up), then the routes in the turns of
    OT_HOST_ORDER (device, host, host, device): α, β and every verdict
    byte-equal across routes and across each route's two runs, and equal
    to the serial three-round composition; both routes' ``total_s`` (and
    their repeats') and ``checks_s``, the host route's ``host_s``,
    ``host_wait_s`` and ``device_wait_s``, the native build's seconds
    and the thread count it resolved. (b) Each hashing stage at the
    leg's chunk shapes, native against the card (``prg_expand`` /
    ``prg_expand_core``, ``ot_transpose`` / ``ot_transpose_core``,
    ``batch_sha256`` / ``pad_hash_core``): byte-equal, each timed
    (median of five; CUDA events on the card, the host clock for the
    library). (c) 11 payload sets at B=8, the host route by count: every
    αₛ + βₛ ≡ a·bₛ (mod q) in python ints, verdicts clean. (d) One GG18
    OT sign of B dealer wallets (cohorts 2) with ``MPCIUM_OT_DEVICE=0``:
    every signature verified on the host, blame clean, K0 at 0 launches,
    ``phases_s`` with r2_mta_ot's host, device and overlap_ratio. The
    phase sets ``MPCIUM_OT_DEVICE`` only around its own calls.

The measurement round's bench (``python -m mpcium_tpu_torch.bench``), on
the process of the golden phases after phase 26:

34. bench — the bench CLI as a subprocess at BASELINE config 1: one
    2-of-3 GG18 sign, B=1, 2048-bit Paillier fixture, default domains
    (``MPCIUM_BENCH_B=1``, ``MPCIUM_BENCH_RUNS=1``; ``reduced``: no
    secondary metrics, no OT variant, no sweep, which the round runs).
    The child's record is printed on the phase line; it must exit 0 with
    ``platform`` "gpu", ``batch`` 1, ``value`` > 0, no watchdog line, K0
    launches > 0 and no plain call in its ``k0``.

The EdDSA engine's per-shape CUDA graphs (``engine/graphs.py``, the
port's counterpart of ``jax.jit``), in phase 19's child process after
phase 27 (the lane that ends first; the main process prints its line
before phase 26's):

35. graphs — (a) each graphed function of the engine (the JAX package's
    nine jitted ones and the challenge's SHA-512) at B = 1, 16 and
    1,024 (q = 2) on the seeded inputs of ``utils/graphs_golden.calls``:
    its replay must equal ``fn.eager`` (the body, every nested graphed
    call eager) byte for byte; the first call's seconds (the capture, or
    a hit where an earlier phase captured the key), the replay's time
    (GRAPHS_REPLAYS back to back) and the eager body's (one call, whose
    result is compared), each from CUDA events and the host clock, the
    key's pool bytes and capture seconds. (b) A 2-of-3 batched party
    sign of GRAPHS_PARTY_B dealer wallets three times under the same
    seeded streams: a warm-up, one through graphs only (no capture and
    no eager body run on the card: the counters' deltas), one with every
    body eager; the signatures must be equal and verify on the host.
    (c) Three threads replay one key (``verify_signatures`` at B=16) 10
    times each with their own inputs: each must get its serial result.
    The line carries the card's name and power limit, the counters per
    function, the captured keys and ``torch.cuda.memory_reserved()``;
    one capture per key.

The GG18 engine's per-shape CUDA graphs (its 25 graphed counterparts of
the JAX package's jitted curve and round blocks), spread over the lanes
that end first: (a) at B = 1 and 16 in phase 24's child after phase 24,
at 1,024 in the goldens' process after phase 34; (b), (c) and (d) in
the main process after phase 31 ((b) on phase 4's signer); the main
process prints the line after phase 24's:

36. gg18_graphs — (a) each graphed function at B = 1, 16 and 1,024 on
    the seeded inputs of ``utils/gg18_graphs_golden.calls``: its replay
    must equal ``fn.eager`` byte for byte; the first call's seconds, the
    replay's time (GRAPHS_REPLAYS back to back) and the eager body's,
    each from CUDA events and the host clock, the key's pool bytes and
    capture seconds. (b) The flagship engine sign (cell 1: phase 4's
    signer, B wallets, cohorts 2, the 2048-bit fixture, full
    ``Domains()``, quorum node0/node1, ``mta_impl="paillier"``; phase
    4's signs are its warm-up): fresh digests once through graphs only
    (the counters' deltas: replays, no capture) and once with every body
    eager (no replay), under the same seeded stream: equal signatures,
    all B verified on the host, K0 launched in both and no plain call;
    ``phases_s`` of both. (c) The batched party
    (``BatchedECDSASigningParty``, node0 + node1, the 1024-bit fixture
    with the domains it carries: each party builds its comb tables in
    python ints, 60–80 s a sign on the 2048-bit one) at
    GG18_GRAPHS_PARTY_B three times under the same seeded streams:
    warm-up, graphs only, eager; equal, agreeing and verified. (d) Three
    threads replay ``_blk_final`` at B=16 ten times each with their own
    inputs: each must get its serial result. The line carries the card's
    name and power limit, and per process the counters per function, the
    keys' capture seconds and pool bytes (one capture per key) and
    ``torch.cuda.memory_reserved()``.

Phases 5, 6, 7, 9, 15 and 16 (the JAX goldens on the card), then phases
32, 26 and 34 (and phase 36's rows at B=1,024), run in that order on a
spawned process of their own,
started after phase 3 beside phases 19, 24 and 25; each golden phase and
phases 32 and 34 print their own lines, and the main process joins them
after its part of phase 36 with a ``goldens`` line (``t_start_s``,
``t_end_s``; the rows come after ``t_end_s``).

Every host verification runs the port's python-int verifiers over all
signatures, spread over a pool of worker processes (one per host core).
The kernels line's launch counts are phase 19's first party sign, those
of its n=160 entries phase 29's warm pass. Every
phase line carries ``t_s``, the seconds since main() started when it was
printed; a phase run by a child process adds ``t_start_s`` and
``t_end_s`` on the same clock, and each of its stages ``t_end_s``.

Then the script's wall time, a ``{"kernels": [...]}`` line, the
nvidia-smi line, and as the last line ``{"ok": true, "device": {...}}``.
Any failure exits non-zero.

    python3 chip_smoke.py [--batch 1024] [--eddsa-batch 4096] [--seed 1]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDENS = ROOT / "mpcium_tpu_torch" / "data" / "goldens"
GOLDEN = GOLDENS / "gg18_paillier_b2_1024.json"
OT_GOLDEN = GOLDENS / "gg18_ot_b2.json"
OT_LEG_GOLDEN = GOLDENS / "ot_leg_b4.json"
COHORTS = 2
EDDSA_B = 4096  # BASELINE config 2: a 2-of-3 Ed25519 sign of 4096 wallets
EDDSA_PARTY_B = 1024
DKG_B = 4096  # BASELINE config 4: a 2-of-3 secp256k1 DKG of 4096 wallets
RESHARE_B = 1024  # BASELINE config 5: 2-of-3 -> 3-of-5 rotation of 1024 wallets
LIFECYCLE_B = 1024  # DKG -> sign -> reshare -> sign as distributed parties
REPS, GROUPS = 100, 20  # calls per CUDA event pair; pairs per median
POWMOD_TIMINGS = 7  # event pairs (one launch each) per powmod median
# (mode, n) of every powmod the signing path launches, and the exponent
# width (one the path gives it) whose measurement stands for it in the
# kernels line. A warm sign's exponents: row 256 bits at n=320; row 128,
# 256, 760 and 1032 at n=608; shared 1024 (p-1, q-1) at n=320; comb 256
# to 2824 at n=320 and 256 (RAND_BITS) at n=608.
POWMOD_PATH = {("row", 320): 256, ("row", 608): 760, ("shared", 320): 1024,
               ("comb", 320): 1784, ("comb", 608): 256}
# The same for the warm pass (phase 29) on the 1024-bit fixture, n=160:
# the kernels' one-word-a-lane instantiation.
POWMOD_WARM = {("row", 160): 256, ("shared", 160): 512, ("comb", 160): 256}

# H100 SXM peaks for the bound: HBM3 at 3.35 TB/s (NVIDIA data sheet), and
# 32-bit integer multiply-add at 64 per clock per SM (CUDA C++ Programming
# Guide throughput table, compute capability 9.0) × 132 SMs × 1.98 GHz boost.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


T0_ENV = "CHIP_SMOKE_T0"  # main()'s start on CLOCK_MONOTONIC, inherited by its children


def since_start() -> float:
    """Seconds since main() started. CLOCK_MONOTONIC is one clock for all
    the processes of a run, so a child's readings line up with the main
    process's."""
    return time.monotonic() - float(os.environ.setdefault(T0_ENV, repr(time.monotonic())))


def emit(obj) -> None:
    """Print one JSON line; a phase's line carries ``t_s``, the seconds
    since main() started when it was printed."""
    if "phase" in obj:
        obj = {**obj, "t_s": since_start()}
    print(json.dumps(obj), flush=True)


def spawned_pool(workers: int = 1, nice: int = 10):
    """A pool of spawned worker processes (they import this file, not the
    main process's state), niced so the main process keeps priority."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(max_workers=workers, initializer=os.nice, initargs=(nice,),
                               mp_context=multiprocessing.get_context("spawn"))


# ---------------------------------------------------------------------------
# host verification: the port's python-int verifiers, every signature,
# spread over a pool of worker processes on the host's cores
# ---------------------------------------------------------------------------

_POOL = None


def host_pool():
    """The verifier pool, started once (spawned: the workers never touch
    the card) and shut down at the end of main()."""
    global _POOL
    if _POOL is None:
        _POOL = spawned_pool(os.cpu_count() or 1, 0)
    return _POOL


def _ecdsa_rows(rows) -> int:
    from mpcium_tpu_torch.core import hostmath as hm

    return sum(hm.ecdsa_verify(hm.secp_decompress(pub), int.from_bytes(d, "big"),
                               int.from_bytes(r, "big"), int.from_bytes(s, "big"))
               for pub, d, r, s in rows)


def _ed25519_rows(rows) -> int:
    from mpcium_tpu_torch.core import hostmath as hm

    return sum(hm.ed25519_verify(pub, msg, sig) for pub, msg, sig in rows)


def _verified(fn, rows) -> int:
    n = max(1, -(-len(rows) // (4 * (os.cpu_count() or 1))))
    return sum(host_pool().map(fn, [rows[i:i + n] for i in range(0, len(rows), n)]))


def verify_ecdsa(pubs, digests, r, s) -> int:
    """How many (r, s) verify: ``pubs`` compressed keys, ``digests`` 32-byte
    rows, ``r``/``s`` (B, 32) big-endian rows."""
    return _verified(_ecdsa_rows, [(bytes(p), bytes(d), bytes(a), bytes(b))
                                   for p, d, a, b in zip(pubs, digests, r, s)])


def verify_ed25519(pubs, msgs, sigs) -> int:
    return _verified(_ed25519_rows, [(bytes(p), bytes(m), bytes(g))
                                     for p, m, g in zip(pubs, msgs, sigs)])


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    return out.splitlines()[0]


def mulmod_bound_ms(rows: int, n: int, modulus: int):
    """Least time for `rows` products a·b mod m: the bytes moved (a, b in,
    result out, int32 limbs) over HBM bandwidth, and the 32-bit word
    products a modular multiply needs (k² for a·b, k² for the reduction,
    as in Barrett's k² + ~k²/2 + ~k²/2 or Montgomery's q·m; two int32
    multiply-adds per 32x32→64 product) over the int32 rate."""
    k = -(-modulus.bit_length() // 32)
    t_bytes = 3 * rows * n * 4 / HBM_BYTES_PER_S
    t_ops = rows * 2 * k * k * 2 / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def powmod_bound_ms(squarings: int, steps: int, moved_bytes: int, modulus: int):
    """Least time for one powmod launch: the bytes it must move (rows and
    digits in, results out, each comb table entry the digits select read
    once) over HBM bandwidth, and the word products of all its steps over
    the int32 rate: k(k+1)/2 + k² for each of the squarings (the square's
    triangle, then the reduction), 2k² for every other step (as in
    mulmod_bound_ms). → (ms, what bounds it, ms with 2k² for every step:
    the flat count of bounds that did not tell squarings apart)."""
    k = -(-modulus.bit_length() // 32)
    t_bytes = moved_bytes / HBM_BYTES_PER_S
    products = squarings * (k * (k + 1) // 2 + k * k) + (steps - squarings) * 2 * k * k
    t_ops = products * 2 / INT32_OPS_PER_S
    t_flat = steps * 2 * k * k * 2 / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"),
            max(t_bytes, t_flat) * 1e3)


def powmod_squarings(L) -> int:
    """The squarings among a launch's ``powmod_steps``, from its digits:
    in modes row and shared x² of the window table and 4 per window
    below the top non-zero digit, for every row with e != 0; none in the
    comb."""
    import numpy as np

    if L.mode == "comb":
        return 0
    nz = L.digits.cpu().numpy().reshape(-1, L.nwin) != 0
    top = L.nwin - 1 - np.argmax(nz[:, ::-1], -1)
    per_row = np.where(nz.any(-1), 1 + 4 * top, 0)
    return int(per_row.sum()) * (L.rows if L.mode == "shared" else 1)


def ptxas_summary(log: str) -> list:
    """One entry per kernel instantiation from nvcc's ``-Xptxas -v``
    report: its name (``powmod_kernel<4>``: 4 words a lane), its
    registers and shared memory, its stack and spills."""
    out, fn, spill = [], "?", ""
    for ln in log.splitlines():
        hit = re.search(r"Compiling entry function '_Z\d+(\w+?)ILi(\d+)E", ln)
        if hit:
            fn, spill = f"{hit[1]}<{hit[2]}>", ""
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln:
            out.append(f"{fn}: {ln.split(':', 1)[-1].strip()}; {spill}")
    return out


def time_ms(fn):
    """(device ms per call, host ms per call): one CUDA event pair around
    REPS back-to-back calls, divided by REPS; median of GROUPS groups.
    The host time is what enqueueing one call costs; while it stays
    below the device time the queue never drains and the event time is
    the device's.
    """
    import torch

    fn()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(GROUPS):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        host.append((time.perf_counter() - t0) * 1e3 / REPS)
        e.record()
        e.synchronize()
        dev.append(s.elapsed_time(e) / REPS)
    return statistics.median(dev), statistics.median(host)


def kernel_graph_ms(K, a, b, c) -> float:
    """Device ms per launch of the kernel's C entry point on fixed
    (rows, n) operands: REPS launches captured into one CUDA graph,
    replayed between one event pair; median of GROUPS replays. The
    wrapper's checks, broadcasting and counting are left out."""
    import torch

    fn = K.build().mpcium_mulmod
    out = torch.empty_like(a)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        args = (
            a.data_ptr(), b.data_ptr(), out.data_ptr(), c.mont_words.data_ptr(),
            c.mprime, a.shape[0], c.n, c.k, side.cuda_stream,
        )
        for _ in range(REPS):
            if fn(*args) != 0:
                raise RuntimeError("mulmod kernel launch failed during capture")
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(GROUPS):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / REPS)
    if not torch.equal(out, K.mulmod_plain(a, b, c)):
        raise AssertionError("graph-replayed kernel != plain version")
    return statistics.median(times)


def kernel_vs_plain(B: int, seed: int, pre, K, mm, bn):
    import torch

    from mpcium_tpu_torch.cluster import load_test_preparams

    p0 = pre["node0"]
    moduli = [
        ("N", p0.paillier.N), ("NTilde", p0.NTilde),
        ("p2", p0.paillier.p ** 2), ("N2", p0.paillier.N ** 2),
        ("N1024", load_test_preparams(1024)["node0"].paillier.N),
    ]
    rnd = random.Random(seed)
    results = {}
    for label, m in moduli:
        ctx = mm.MXUBarrett(m, device="cuda")
        n, occ, k = ctx.prof.n_limbs, ctx.occ, ctx._kc.k
        # unreduced operands the JAX kernel accepts (a·b < R^occ·m)
        top = 1 << (7 * occ)
        edges = [top - 1] + [1 << (32 * k)] * ((1 << (32 * k)) < top)
        av = [0, 1, m - 1]
        bv = [rnd.randrange(m), m - 1, m - 1]
        for e in edges:
            av += [e, m - 1]
            bv += [m - 1, e]
        ne = len(av)
        av += [rnd.randrange(m) for _ in range(B - ne)]
        bv += [rnd.randrange(m) for _ in range(B - ne)]
        a = torch.as_tensor(bn.batch_to_limbs(av, ctx.prof), device="cuda")
        b = torch.as_tensor(bn.batch_to_limbs(bv, ctx.prof), device="cuda")
        got = K.mulmod_cuda(a, b, ctx._kc)
        ref = K.mulmod_plain(a, b, ctx._kc)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            bad = int((got != ref).any(-1).sum())
            raise AssertionError(f"{label}: kernel != plain in {bad} rows")
        sample = list(range(ne)) + rnd.sample(range(ne, B), 13)
        host = bn.batch_from_limbs(got[sample], ctx.prof)
        for i, v in zip(sample, host):
            if v != av[i] * bv[i] % m:
                raise AssertionError(f"{label}: row {i} != python a*b % m")
        err = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
        # all-ones rows lie beyond the JAX kernel's domain: python ints only
        full = (1 << (7 * n)) - 1
        wide = torch.as_tensor(bn.batch_to_limbs([full, full, 1], ctx.prof), device="cuda")
        if bn.batch_from_limbs(K.mulmod_cuda(wide, wide.flip(0), ctx._kc), ctx.prof) != [
            full % m, full * full % m, full % m,
        ]:
            raise AssertionError(f"{label}: all-ones rows != python a*b % m")
        k_ms = kernel_graph_ms(K, a, b, ctx._kc)
        w_ms, w_host = time_ms(lambda: K.mulmod_cuda(a, b, ctx._kc))
        p_ms, _ = time_ms(lambda: K.mulmod_plain(a, b, ctx._kc))
        bound, by = mulmod_bound_ms(B, n, m)
        rec = {
            "phase": "kernel_vs_plain", "modulus": label, "bits": m.bit_length(),
            "n_limbs": n, "rows": B, "edge_rows": ne, "equal": True,
            "max_abs_err": err, "kernel_ms": k_ms, "wrapper_ms": w_ms,
            "wrapper_host_ms_per_call": w_host,
            "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
            "bound_share": bound / k_ms,
        }
        emit(rec)
        # one row per kernel width: the widest-modulus measurement stands
        if n not in results or m.bit_length() >= results[n]["bits"]:
            results[n] = rec
    return results


def powmod_launch_ms(K, L, c) -> float:
    """Device ms per launch of the powmod kernel's C entry on packed
    operands (``launch_powmod``: no checks, no counting): one CUDA event
    pair around each launch, median of POWMOD_TIMINGS after one warm-up
    launch."""
    import torch

    out = torch.empty((L.rows, c.n), dtype=torch.int32, device="cuda")
    times = []
    for i in range(POWMOD_TIMINGS + 1):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        if K.launch_powmod(L, c, out) != 0:
            raise RuntimeError("powmod kernel launch failed")
        e.record()
        e.synchronize()
        if i:
            times.append(s.elapsed_time(e))
    return statistics.median(times)


def powmod_vs_plain(B: int, seed: int, pre, K, mm, bn):
    import numpy as np
    import torch

    from mpcium_tpu_torch.cluster import load_test_preparams
    from mpcium_tpu_torch.ops.paillier_mxu import RAND_BITS

    big = pre["node0"].paillier
    small = load_test_preparams(1024)["node0"].paillier
    rnd = random.Random(seed + 7)
    nrng = np.random.default_rng(seed + 7)
    results = {}
    path = [("row", 256), ("row", 760), ("row", 1784),
            ("shared", (big.p - 1).bit_length()), ("comb", RAND_BITS), ("comb", 1784)]
    warm = [("row", 256), ("shared", (small.p - 1).bit_length()), ("comb", RAND_BITS)]
    for label, m, p, cases in (("N", big.N, big.p, path), ("N2", big.N ** 2, big.p, path),
                               ("N1024", small.N, small.p, warm)):
        ctx = mm.MXUBarrett(m, device="cuda")
        c, n = ctx._kc, ctx.prof.n_limbs
        for mode, ebits in cases:
            xs = [0, 1, m - 1] + [rnd.randrange(m) for _ in range(B - 3)]
            eb = nrng.integers(0, 2, (B, ebits)).astype(np.int32)
            eb[3], eb[4], eb[5] = 0, 0, 1
            eb[4, 0] = 1  # rows 3, 4, 5: e = 0, 1, all ones
            es = [int("".join(map(str, r[::-1])), 2) for r in eb]
            x = torch.as_tensor(bn.batch_to_limbs(xs, ctx.prof), device="cuda")
            ebt = torch.as_tensor(eb, device="cuda")
            table = None
            if mode == "row":
                args = (x, mm._window_digits(ebt, 4))
                want = lambda i: pow(xs[i], es[i], m)  # noqa: E731
            elif mode == "shared":
                e = p - 1
                nw = -(-e.bit_length() // 4)
                ds = torch.tensor([(e >> (4 * i)) & 15 for i in range(nw)],
                                  dtype=torch.int32, device="cuda")
                args = (x, ds)
                want = lambda i: pow(xs[i], p - 1, m)  # noqa: E731
            else:
                base = rnd.randrange(2, m)
                ctx.powmod_fixed_base(base, ebt[:1])  # builds the comb table
                table = ctx._fb_tables[(base, -(-ebits // mm.COMB_W), mm.COMB_W)]
                args = (None, mm._window_digits(ebt, mm.COMB_W))
                want = lambda i: pow(base, es[i], m)  # noqa: E731
            got = K.powmod_cuda(*args, c, mode, table)
            s_, e_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s_.record()
            ref = K.powmod_plain(*args, c, mode, table)
            e_.record()
            e_.synchronize()
            plain_ms = s_.elapsed_time(e_)
            if not torch.equal(got, ref):
                bad = int((got != ref).any(-1).sum())
                raise AssertionError(f"powmod {mode} {label}: kernel != plain in {bad} rows")
            sample = list(range(6)) + rnd.sample(range(6, B), 13)
            host = bn.batch_from_limbs(got[sample], ctx.prof)
            for i, v in zip(sample, host):
                if v != want(i):
                    raise AssertionError(f"powmod {mode} {label}: row {i} != python pow")
            err = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
            extra = []
            if mode == "shared":
                # exponent edges of a shared exponent: one launch each
                for e in (0, 1, (1 << ebits) - 1):
                    nw = max(1, -(-e.bit_length() // 4))
                    ds = torch.tensor([(e >> (4 * i)) & 15 for i in range(nw)],
                                      dtype=torch.int32, device="cuda")
                    g = K.powmod_cuda(x[:8], ds, c, mode)
                    if not torch.equal(g, K.powmod_plain(x[:8], ds, c, mode)) or (
                        bn.batch_from_limbs(g, ctx.prof) != [pow(v, e, m) for v in xs[:8]]
                    ):
                        raise AssertionError(f"powmod shared {label}: exponent {e:#x}")
                    extra.append(e.bit_length())
            if mode != "comb":
                # unreduced bases: python ints only
                wide = [(1 << (7 * ctx.occ)) - 1, (1 << (7 * n)) - 1] * 2
                xw = torch.as_tensor(bn.batch_to_limbs(wide, ctx.prof), device="cuda")
                if mode == "row":
                    ew = [1, es[6], (1 << ebits) - 1, es[7]]
                    g = K.powmod_cuda(xw, args[1][[4, 6, 5, 7]], c, mode)
                else:
                    ew = [p - 1] * 4
                    g = K.powmod_cuda(xw, args[1], c, mode)
                if bn.batch_from_limbs(g, ctx.prof) != [pow(v, e, m) for v, e in zip(wide, ew)]:
                    raise AssertionError(f"powmod {mode} {label}: unreduced base != python pow")
            L = K.pack_powmod(*args, c, mode, table)
            steps, squarings = K.powmod_steps(L), powmod_squarings(L)
            moved = 4 * (L.digits.numel() + 2 * L.rows * n) if mode != "comb" else 4 * (
                L.digits.numel() + L.rows * n)
            if mode == "comb":
                d = L.digits.cpu().numpy()
                moved += 4 * c.k * sum(len(np.unique(col[col != 0])) for col in d.T)
            k_ms = powmod_launch_ms(K, L, c)
            host = []
            for _ in range(POWMOD_TIMINGS):
                t0 = time.perf_counter()
                K.powmod_cuda(*args, c, mode, table)
                host.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
            bound, by, flat = powmod_bound_ms(squarings, int(steps.sum()), moved, m)
            rec = {
                "phase": "powmod_vs_plain", "mode": mode, "modulus": label,
                "bits": m.bit_length(), "n_limbs": n, "rows": B, "exp_bits": ebits,
                "shared_exp_edges_bits": extra, "equal": True, "max_abs_err": err,
                "kernel_ms": k_ms, "steps_max": int(steps.max()),
                "steps_total": int(steps.sum()), "squarings_total": squarings,
                "kernel_ms_per_step": k_ms / max(int(steps.max()), 1),
                "wrapper_host_ms_per_call": statistics.median(host),
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                "bound_share": bound / k_ms, "bound_flat_ms": flat,
            }
            emit(rec)
            results[(mode, n, ebits)] = rec
    return results


def run_slice(B: int, seed: int, pre, K):
    import numpy as np
    import torch

    from mpcium_tpu_torch.engine import gg18_batch as gb
    from mpcium_tpu_torch.utils.rng import SeededStream

    t0 = time.perf_counter()
    shares = gb.dealer_keygen_secp_batch(
        B, ["node0", "node1", "node2"], threshold=1, rng=SeededStream(seed)
    )
    keygen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    signer = gb.GG18BatchCoSigners(
        ["node0", "node1"], [shares[0], shares[1]], pre, dom=gb.Domains(),
        rng=SeededStream(seed + 1), device="cuda",
    )
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    drng = np.random.default_rng(seed + 2)
    first = drng.integers(0, 256, (B, 32), dtype=np.uint8)
    t0 = time.perf_counter()
    out = signer.sign(first, cohorts=COHORTS)
    torch.cuda.synchronize()
    first_sign_s = time.perf_counter() - t0
    if not out["ok"].all():
        raise AssertionError(f"first sign: ok={int(out['ok'].sum())}/{B}")
    digests = drng.integers(0, 256, (B, 32), dtype=np.uint8)
    phases: dict = {}
    K.reset_counters()
    t0 = time.perf_counter()
    out = signer.sign(digests, phase_times=phases, cohorts=COHORTS)
    torch.cuda.synchronize()
    sign_s = time.perf_counter() - t0
    launches = K.launches
    by_width = dict(K.launches_by_width)
    by_mode = dict(K.powmod_launches_by_mode_width)
    plain_calls = K.plain_calls
    t0 = time.perf_counter()
    verified = verify_ecdsa([x.public_key for x in shares[0]], digests, out["r"], out["s"])
    verify_s = time.perf_counter() - t0
    emit({
        "phase": "slice", "B": B, "cohorts": COHORTS, "seed": seed,
        "keygen_s": keygen_s, "setup_s": setup_s, "first_sign_s": first_sign_s,
        "sign_s": sign_s,
        "sigs_per_s": B / sign_s, "phases_s": phases, "host_verify_s": verify_s,
        "ok_all": bool(out["ok"].all()), "verified": verified,
        "kernel_launches": launches + sum(by_mode.values()),
        "mulmod_launches_by_width": {str(k): v for k, v in sorted(by_width.items())},
        "powmod_launches_by_mode_width": {
            f"{m}/{n}": v for (m, n), v in sorted(by_mode.items())},
        "plain_calls": plain_calls,
    })
    if not out["ok"].all() or verified != B:
        raise AssertionError(f"signatures: ok={int(out['ok'].sum())}/{B} "
                             f"verified={verified}/{B}")
    if plain_calls:
        raise AssertionError(f"a plain version ran {plain_calls}x on the card")
    for n in (320, 608):
        if by_width.get(n, 0) == 0:
            raise AssertionError(f"no mulmod launch at width {n} during the sign")
    for key in POWMOD_PATH:
        if by_mode.get(key, 0) == 0:
            raise AssertionError(f"no powmod launch of {key} during the sign")
    return by_width, by_mode, shares, signer, {"sign_s": sign_s, "phases_s": phases}


def check_golden(path: Path = GOLDEN, phase: str = "golden") -> None:
    """The port on the card against the JAX engine's committed signatures:
    same keys, digests and seeded stream (B=2), so every byte of (r, s,
    recovery, ok) must match. A golden with a "fixture" signs with the
    Paillier backend on that key fixture, one without it with OT."""
    import numpy as np
    import torch

    from mpcium_tpu_torch.cluster import load_test_preparams
    from mpcium_tpu_torch.engine import gg18_batch as gb
    from mpcium_tpu_torch.utils.rng import SeededStream

    g = json.loads(path.read_text())
    case = g["cases"][0]
    shares = gb.dealer_keygen_secp_batch(
        case["B"], g["universe"], g["threshold"], rng=SeededStream(case["keygen_seed"])
    )
    quorum_shares = [shares[g["universe"].index(p)] for p in g["quorum"]]
    if "fixture" in g:
        signer = gb.GG18BatchCoSigners(
            g["quorum"], quorum_shares, load_test_preparams(1024),
            dom=gb.Domains(**g["domains"]), rng=SeededStream(case["sign_seed"]),
            mta_impl="paillier", device="cuda",
        )
    else:
        signer = gb.GG18BatchCoSigners(
            g["quorum"], quorum_shares, rng=SeededStream(case["sign_seed"]),
            mta_impl="ot", device="cuda",
        )
    digests = np.array([list(bytes.fromhex(d)) for d in case["digests"]], np.uint8)
    t0 = time.perf_counter()
    out = signer.sign(digests, cohorts=case["cohorts"])
    torch.cuda.synchronize()
    got = {
        "r": [bytes(x).hex() for x in out["r"]],
        "s": [bytes(x).hex() for x in out["s"]],
        "recovery": [int(v) for v in out["recovery"]],
        "ok": [bool(v) for v in out["ok"]],
    }
    same = all(got[k] == case[k] for k in got)
    emit({"phase": phase, "B": case["B"], "cohorts": case["cohorts"],
          "matches_jax_golden": same, "sign_s": time.perf_counter() - t0})
    if not same:
        raise AssertionError("signatures differ from the JAX engine's golden")


def _cuda_limbs(vals):
    import torch

    from mpcium_tpu_torch.core import bignum as bn

    return torch.as_tensor(bn.batch_to_limbs(vals, bn.P256), device="cuda")


def _synth_leg():
    """The synthetic OT leg of the committed leg golden, on the card."""
    from mpcium_tpu_torch.protocol.ecdsa.mta_ot import OTMtALeg
    from mpcium_tpu_torch.utils import ot_golden as og
    from mpcium_tpu_torch.utils.rng import DetRng

    tag, k0, k1, delta = og.synth_base_ot()
    return OTMtALeg.from_base_ot(
        tag, k0, k1, delta, rng=DetRng(og.SYNTH_SEED + 1000), device="cuda"
    )


def ot_leg_golden() -> None:
    """Wire transcript, shares and verdicts of the synthetic leg (chunks
    1 and 2) against the JAX leg's committed record, byte for byte."""
    import torch

    from mpcium_tpu_torch.utils import ot_golden as og

    want = json.loads(OT_LEG_GOLDEN.read_text())["record"]
    t0 = time.perf_counter()
    got = og.leg_record(_synth_leg, _cuda_limbs, want["B"],
                        chunks=tuple(int(k) for k in want["run_multi"]))
    torch.cuda.synchronize()
    diff = sorted(k for k in want if got.get(k) != want[k])
    diff += sorted(f"run_multi/{k}" for k in want["run_multi"]
                   if got["run_multi"].get(k) != want["run_multi"][k])
    emit({"phase": "ot_leg_golden", "B": want["B"], "chunks": sorted(want["run_multi"]),
          "matches_jax_golden": not diff, "differs": diff,
          "s": time.perf_counter() - t0})
    if diff:
        raise AssertionError(f"OT leg differs from the JAX golden in {diff}")


def ot_tamper(B: int = 4) -> None:
    """Each wire field an active cheater controls, corrupted on its own
    lane: the blame must be the JAX table's on that lane, None elsewhere."""
    from mpcium_tpu_torch.utils import ot_golden as og

    t0 = time.perf_counter()
    rows = []
    for case, (field, _set, party, check) in enumerate(og.TAMPER_CASES):
        lane, blames, _verdicts = og.tamper_run(_synth_leg(), _cuda_limbs, B, case)
        want = [None] * B
        want[lane] = (party, check)
        rows.append({"field": field, "lane": lane,
                     "blame": [list(b) if b else None for b in blames],
                     "ok": blames == want})
    emit({"phase": "ot_tamper", "B": B, "cases": rows,
          "all_blamed_as_jax": all(r["ok"] for r in rows),
          "s": time.perf_counter() - t0})
    bad = [r["field"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"tamper cases misblamed: {bad}")


def run_ot_slice(B: int, seed: int, shares, K):
    """The OT backend at B sessions on the slice's wallets: setup (base
    OTs), a first sign, then the measured warm sign with K0's counters
    zeroed just before it. Returns the signer (phase 31 signs with it)."""
    import numpy as np
    import torch

    from mpcium_tpu_torch.engine import gg18_batch as gb
    from mpcium_tpu_torch.protocol.ecdsa.mta_ot import resolve_chunks
    from mpcium_tpu_torch.utils.rng import SeededStream

    t0 = time.perf_counter()
    signer = gb.GG18BatchCoSigners(
        ["node0", "node1"], [shares[0], shares[1]],
        rng=SeededStream(seed + 11), mta_impl="ot", device="cuda",
    )
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    drng = np.random.default_rng(seed + 12)
    first = drng.integers(0, 256, (B, 32), dtype=np.uint8)
    t0 = time.perf_counter()
    out = signer.sign(first, cohorts=COHORTS)
    torch.cuda.synchronize()
    first_sign_s = time.perf_counter() - t0
    if not out["ok"].all():
        raise AssertionError(f"OT first sign: ok={int(out['ok'].sum())}/{B}")
    digests = drng.integers(0, 256, (B, 32), dtype=np.uint8)
    phases: dict = {}
    K.reset_counters()
    t0 = time.perf_counter()
    out = signer.sign(digests, phase_times=phases, cohorts=COHORTS)
    torch.cuda.synchronize()
    sign_s = time.perf_counter() - t0
    k0_launches = (K.launches + sum(K.powmod_launches_by_mode_width.values()),
                   K.plain_calls)
    blame = {f"{signer.ids[a]}->{signer.ids[b]}": leg.check_blame()
             for (a, b), leg in signer.ot_legs.items()}
    clean = all(v is not None and not any(v) for v in blame.values())
    t0 = time.perf_counter()
    verified = verify_ecdsa([x.public_key for x in shares[0]], digests, out["r"], out["s"])
    verify_s = time.perf_counter() - t0
    timings = signer.ot_timings or {}
    emit({
        "phase": "ot_slice", "B": B, "cohorts": COHORTS, "ot_chunks": resolve_chunks(B),
        "seed": seed, "keygen": "the slice phase's wallets", "setup_s": setup_s,
        "first_sign_s": first_sign_s, "sign_s": sign_s, "sigs_per_s": B / sign_s,
        "phases_s": phases, "run_multi_timings_s": timings,
        "checks_share_of_r2": timings.get("checks_s", 0.0) / phases["r2_mta_ot"],
        "host_verify_s": verify_s, "ok_all": bool(out["ok"].all()), "verified": verified,
        "blame_clean": clean, "k0_launches": k0_launches[0], "plain_calls": k0_launches[1],
    })
    if not out["ok"].all() or verified != B:
        raise AssertionError(f"OT signatures: ok={int(out['ok'].sum())}/{B} "
                             f"verified={verified}/{B}")
    if not clean:
        raise AssertionError(f"OT legs blamed a party on an honest run: {blame}")
    if k0_launches != (0, 0):
        raise AssertionError(f"the OT sign reached K0 or its plain versions: {k0_launches}")
    return signer


def _record_diff(got: dict, want: dict) -> list:
    return sorted(k for k in want if got.get(k) != want[k])


def sha512_vs_hashlib(B: int, seed: int, dev: str = "cuda") -> None:
    import hashlib

    import numpy as np
    import torch

    from mpcium_tpu_torch.ops import hash_suite as hs

    rng = np.random.default_rng(seed + 30)
    cases = [(64, n) for n in (0, 96, 111, 112, 128, 239, 240)] + [(B, 96)]
    t_ms = None
    for rows, n in cases:
        data = rng.integers(0, 256, (rows, n), dtype=np.uint8)
        x = torch.as_tensor(data, device=dev)
        hs.sha512(x)  # warm
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = hs.sha512(x).cpu().numpy()
        t_ms = (time.perf_counter() - t0) * 1e3
        for i in range(rows):
            if got[i].tobytes() != hashlib.sha512(data[i].tobytes()).digest():
                raise AssertionError(f"sha512: row {i} of length {n} != hashlib")
    # the host path of a ragged batch on the same challenge rows: hashlib
    # per row, then the digests copied to the card
    t0 = time.perf_counter()
    host = np.stack([np.frombuffer(hashlib.sha512(r.tobytes()).digest(), np.uint8)
                     for r in data])
    torch.as_tensor(host, device=dev)
    if dev == "cuda":
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    emit({"phase": "sha512_vs_hashlib", "lengths": [n for _, n in cases],
          "rows": [r for r, _ in cases], "equal": True,
          "challenge_batch_ms": t_ms, "hashlib_batch_ms": host_ms,
          "note": "host clock, synchronized by the copy out"})


def ed25519_edges(dev: str = "cuda") -> None:
    import torch

    from mpcium_tpu_torch.core import ed25519 as ed
    from mpcium_tpu_torch.utils import eddsa_golden as eg

    want = json.loads((GOLDENS / "ed25519_edges.json").read_text())["record"]
    t0 = time.perf_counter()
    got = eg.edges_record(ed, lambda a: torch.as_tensor(a, device=dev))
    diff = _record_diff(got, want)
    emit({"phase": "ed25519_edges", "encodings": len(want["encodings"]),
          "invalid": want["decompress_ok"].count(False), "scalars": want["scalars"],
          "matches_jax_golden": not diff, "differs": diff, "s": time.perf_counter() - t0})
    if diff:
        raise AssertionError(f"ed25519 edge table differs from the JAX golden in {diff}")


def eddsa_golden(dev: str = "cuda") -> None:
    import torch

    from mpcium_tpu_torch.engine import eddsa_batch as eb
    from mpcium_tpu_torch.protocol.eddsa.batch_signing import BatchedEDDSASigningParty
    from mpcium_tpu_torch.protocol.runner import run_protocol
    from mpcium_tpu_torch.utils import eddsa_golden as eg

    to_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    t0 = time.perf_counter()
    engine = eg.engine_record(eb, to_dev, device=dev)
    party = eg.party_record(eb, BatchedEDDSASigningParty, run_protocol, device=dev)
    diff = [f"engine/{k}" for k in _record_diff(
        engine, json.loads((GOLDENS / "eddsa_b4.json").read_text())["record"])]
    diff += [f"party/{k}" for k in _record_diff(
        party, json.loads((GOLDENS / "eddsa_party_b4.json").read_text())["record"])]
    emit({"phase": "eddsa_golden", "B": eg.B, "cohorts": eg.ENGINE["cohorts"],
          "matches_jax_golden": not diff, "differs": diff, "s": time.perf_counter() - t0})
    if diff:
        raise AssertionError(f"EdDSA differs from the JAX goldens in {diff}")


def _sync(dev: str) -> None:
    import torch

    if dev == "cuda":
        torch.cuda.synchronize()


def _host_verified(shares, msgs, sigs) -> int:
    return verify_ed25519([s.public_key for s in shares], msgs, sigs)


def run_eddsa_slice(B: int, seed: int, K, dev: str = "cuda"):
    """BASELINE config 2 on the card: setup, a first sign, then the
    measured warm sign with K0's counters zeroed just before it."""
    import numpy as np
    import torch

    from mpcium_tpu_torch.engine import eddsa_batch as eb
    from mpcium_tpu_torch.utils.rng import SeededStream

    t0 = time.perf_counter()
    shares = eb.dealer_keygen_batch(B, ["node0", "node1", "node2"], 1, rng=SeededStream(seed))
    keygen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    signer = eb.BatchedCoSigners(["node0", "node1"], shares[:2],
                                 rng=SeededStream(seed + 21), device=dev)
    _sync(dev)
    setup_s = time.perf_counter() - t0
    mrng = np.random.default_rng(seed + 22)
    first = [r.tobytes() for r in mrng.integers(0, 256, (B, 32), dtype=np.uint8)]
    t0 = time.perf_counter()
    sigs, ok = signer.sign(first, cohorts=COHORTS)
    _sync(dev)
    first_sign_s = time.perf_counter() - t0
    if not ok.all():
        raise AssertionError(f"EdDSA first sign: ok={int(ok.sum())}/{B}")
    msgs = [r.tobytes() for r in mrng.integers(0, 256, (B, 32), dtype=np.uint8)]
    phases: dict = {}
    if K is not None:
        K.reset_counters()
    t0 = time.perf_counter()
    sigs, ok = signer.sign(msgs, cohorts=COHORTS, phase_times=phases)
    _sync(dev)
    sign_s = time.perf_counter() - t0
    k0 = (K.launches + sum(K.powmod_launches_by_mode_width.values()), K.plain_calls) \
        if K is not None else (0, 0)
    t0 = time.perf_counter()
    verified = _host_verified(shares[0], msgs, sigs)
    verify_s = time.perf_counter() - t0
    # one flipped byte of one lane's s: device verification fails there only
    lane = B // 3
    bad = sigs.copy()
    bad[lane, 40] ^= 0x10
    c64 = eb.challenge_hashes(bad[:, :32], signer.A_comp, msgs, dev)
    t0 = time.perf_counter()
    dev_ok = eb.verify_signatures(torch.as_tensor(bad, device=dev),
                                  torch.as_tensor(signer.A_comp, device=dev),
                                  torch.as_tensor(c64, device=dev)).cpu().numpy()
    tamper_verify_s = time.perf_counter() - t0
    tamper_ok = (not dev_ok[lane]) and bool(np.delete(dev_ok, lane).all())
    from mpcium_tpu_torch.engine.pipeline import resolve_cohorts

    emit({
        "phase": "eddsa_slice", "B": B, "cohorts": resolve_cohorts(B, COHORTS), "seed": seed,
        "scheme": "2-of-3 Ed25519, quorum node0/node1, 32-byte messages",
        "keygen_s": keygen_s, "setup_s": setup_s, "first_sign_s": first_sign_s,
        "sign_s": sign_s, "sigs_per_s": B / sign_s, "phases_s": phases,
        "host_verify_s": verify_s, "ok_all": bool(ok.all()), "verified": verified,
        "tamper_lane": lane, "tamper_rejected_on_that_lane_only": tamper_ok,
        "tamper_verify_s": tamper_verify_s, "k0_launches": k0[0], "plain_calls": k0[1],
        "memory_reserved": torch.cuda.memory_reserved() if dev == "cuda" else None,
    })
    if not ok.all() or verified != B:
        raise AssertionError(f"EdDSA signatures: ok={int(ok.sum())}/{B} verified={verified}/{B}")
    if not tamper_ok:
        raise AssertionError("device verification did not isolate the tampered lane")
    if k0 != (0, 0):
        raise AssertionError(f"the EdDSA sign reached K0 or its plain versions: {k0}")
    return shares


def run_eddsa_party(B: int, seed: int, shares, dev: str = "cuda") -> None:
    """Two batched parties through the in-process runner, with span
    recording on: wall seconds per runner round (summed over parties)."""
    import numpy as np

    from mpcium_tpu_torch.protocol.eddsa.batch_signing import BatchedEDDSASigningParty
    from mpcium_tpu_torch.protocol.runner import run_protocol
    from mpcium_tpu_torch.utils import tracing
    from mpcium_tpu_torch.utils.rng import SeededStream

    quorum = ["node0", "node1"]
    msgs = [r.tobytes() for r in np.random.default_rng(seed + 23).integers(
        0, 256, (B, 32), dtype=np.uint8)]
    parties = {
        pid: BatchedEDDSASigningParty(f"chip-smoke-{seed}", pid, quorum, shares[i][:B], msgs,
                                      rng=SeededStream(seed + 24 + i), cohorts=COHORTS,
                                      device=dev)
        for i, pid in enumerate(quorum)
    }
    spans: list = []
    tracing.enable(spans.append)
    t0 = time.perf_counter()
    try:
        run_protocol(parties)
        _sync(dev)
    finally:
        tracing.disable()
    wall_s = time.perf_counter() - t0
    rounds: dict = {}
    for sp in spans:
        if sp["name"].startswith(("round:", "phase:")):
            rounds[sp["name"]] = rounds.get(sp["name"], 0.0) + (sp["t1_ns"] - sp["t0_ns"]) / 1e9
    res = [parties[p].result for p in quorum]
    same = bool(np.array_equal(res[0]["signatures"], res[1]["signatures"]))
    t0 = time.perf_counter()
    verified = _host_verified(shares[0][:B], msgs, res[0]["signatures"])
    emit({"phase": "eddsa_party", "B": B, "parties": quorum, "wall_s": wall_s,
          "seconds_by_round": rounds, "ok_all": all(bool(r["ok"].all()) for r in res),
          "parties_agree": same, "verified": verified,
          "host_verify_s": time.perf_counter() - t0})
    if not all(r["ok"].all() for r in res) or not same or verified != B:
        raise AssertionError(f"EdDSA party: ok/agree/verified failed ({verified}/{B})")



# ---------------------------------------------------------------------------
# the wallet lifecycle: batched DKG, the GG18 signing party, resharing
# ---------------------------------------------------------------------------

UNIVERSE = ["node0", "node1", "node2"]


# ---------------------------------------------------------------------------
# phase 35: the EdDSA engine's per-shape CUDA graphs (engine/graphs.py)
# ---------------------------------------------------------------------------

GRAPHS_B = (1, 16, 1024)  # batch sizes of phase 35's replay-vs-eager rows (q = 2)
GRAPHS_PARTY_B = 16
GRAPHS_REPLAYS = 10  # replays timed per row, between one event pair; the eager body once


def _graph_fns():
    from mpcium_tpu_torch.engine import eddsa_batch as eb
    from mpcium_tpu_torch.utils import graphs_golden as gg

    return {**{n: getattr(eb, n) for n in gg.FUNCTIONS if n != "sha512"}, "sha512": eb._sha512}


def _timed_calls(fn, n: int, dev: str):
    """n back-to-back calls between one CUDA event pair → (device ms,
    host ms) per call; the host clock stops after a synchronize."""
    import torch

    if dev != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return None, (time.perf_counter() - t0) * 1e3 / n
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n, (time.perf_counter() - t0) * 1e3 / n


def _graph_count_delta(c0: dict, c1: dict) -> dict:
    return {fn: {k: c1[fn][k] - c0.get(fn, {}).get(k, 0) for k in c1[fn]} for fn in c1
            if any(c1[fn][k] != c0.get(fn, {}).get(k, 0) for k in c1[fn])}


def _graph_party_sign(B: int, seed: int, shares, msgs, dev: str, eager: bool):
    """2-of-3 batched party sign of B wallets (node0, node1) under seeded
    streams → (signatures, ok all, wall s); ``eager`` runs every graphed
    function's body instead of its graph."""
    from mpcium_tpu_torch.engine import graphs
    from mpcium_tpu_torch.protocol.eddsa.batch_signing import BatchedEDDSASigningParty
    from mpcium_tpu_torch.protocol.runner import run_protocol
    from mpcium_tpu_torch.utils.rng import SeededStream

    quorum = ["node0", "node1"]
    parties = {pid: BatchedEDDSASigningParty(f"chip-graphs-{seed}", pid, quorum, shares[i][:B],
                                             msgs, rng=SeededStream(seed + 40 + i), cohorts=1,
                                             device=dev)
               for i, pid in enumerate(quorum)}
    t0 = time.perf_counter()
    with graphs.eager_bodies() if eager else contextlib.nullcontext():
        run_protocol(parties)
        _sync(dev)
    wall = time.perf_counter() - t0
    res = [parties[p].result for p in quorum]
    if not all(bytes(r["signatures"].tobytes()) == bytes(res[0]["signatures"].tobytes())
               for r in res):
        raise AssertionError("graphs: the parties' signatures differ")
    return res[0]["signatures"], all(bool(r["ok"].all()) for r in res), wall


def run_graphs(seed: int, dev: str = "cuda", bs=GRAPHS_B, party_b: int = GRAPHS_PARTY_B) -> dict:
    """Phase 35: for each graphed function at each B of GRAPHS_B (q = 2,
    seeded inputs of ``utils/graphs_golden.calls``), the graph's replay
    equals ``fn.eager`` byte for byte; replay and eager times (CUDA
    events and the host clock) and the key's pool bytes. Then a 2-of-3
    party sign at GRAPHS_PARTY_B three times: the first captures, the
    second (graphs only: no capture, so no eager body run) and the third (every
    body eager) must give the same signatures under the same seeded
    streams, all verified on the host. Then three threads replay one
    key at once, each must get its serial result. → the phase record."""
    import threading

    import numpy as np
    import torch

    from mpcium_tpu_torch.core import hostmath as hm
    from mpcium_tpu_torch.engine import eddsa_batch as eb
    from mpcium_tpu_torch.engine import graphs
    from mpcium_tpu_torch.utils import graphs_golden as gg
    from mpcium_tpu_torch.utils.rng import SeededStream

    t_start = since_start()
    fns = _graph_fns()
    to_dev = lambda a: torch.as_tensor(np.array(a), device=dev)  # noqa: E731
    c_start = graphs.counts()
    rows, bad = [], []
    for B in bs:
        for name, args in gg.calls(B, 2, seed + B):
            fn, a = fns[name], gg.to_args(args, to_dev)
            t0 = time.perf_counter()
            fn(*a)
            _sync(dev)
            first_s = time.perf_counter() - t0
            replay_ms, replay_host_ms = _timed_calls(lambda: fn(*a), GRAPHS_REPLAYS, dev)
            out: list = []
            eager_ms, eager_host_ms = _timed_calls(lambda: out.append(fn.eager(*a)), 1, dev)
            same = gg.encode(fn(*a)) == gg.encode(out[0])
            if not same:
                bad.append(f"{name} B={B}")
            entry = fn.graphs.entries.get(graphs.call_key(fn.graphs.name, tuple(a), {})[0])
            rows.append({"fn": name, "B": B, "equal": same, "first_call_s": first_s,
                         "replay_ms": replay_ms, "replay_host_ms": replay_host_ms,
                         "eager_ms": eager_ms, "eager_host_ms": eager_host_ms,
                         "pool_bytes": entry.pool_bytes if entry else None,
                         "capture_s": entry.capture_s if entry else None})
    c_rows = graphs.counts()

    # the party sign: warm (captures), graphs only, eager
    B = party_b
    shares = eb.dealer_keygen_batch(B, ["node0", "node1", "node2"], 1,
                                    rng=SeededStream(seed + 35))
    msgs = [r.tobytes() for r in np.random.default_rng(seed + 36).integers(
        0, 256, (B, 32), dtype=np.uint8)]
    sig_warm, ok_warm, warm_s = _graph_party_sign(B, seed, shares, msgs, dev, eager=False)
    c0 = graphs.counts()
    sig_graph, ok_graph, graph_s = _graph_party_sign(B, seed, shares, msgs, dev, eager=False)
    c1 = graphs.counts()
    sig_eager, ok_eager, eager_s = _graph_party_sign(B, seed, shares, msgs, dev, eager=True)
    party_delta = _graph_count_delta(c0, c1)
    verified = sum(hm.ed25519_verify(s.public_key, m, bytes(sig))  # 16 rows: no pool
                   for s, m, sig in zip(shares[0], msgs, sig_graph))

    # three threads replaying one key at once
    inputs = [gg.to_args(dict(gg.calls(16, 2, seed + 100 + i))["verify_signatures"], to_dev)
              for i in range(3)]
    serial = [gg.encode(eb.verify_signatures(*a)) for a in inputs]
    errors: list = []

    def replayer(i: int) -> None:
        for _ in range(10):
            if gg.encode(eb.verify_signatures(*inputs[i])) != serial[i]:
                errors.append(i)

    threads = [threading.Thread(target=replayer, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    stuck = [t.name for t in threads if t.is_alive()]
    counts = graphs.counts()
    rec = {
        "phase": "graphs", "device": dev, "nvidia_smi": smi() if dev == "cuda" else None,
        "B": list(bs), "q": 2, "rows": rows, "mismatches": bad,
        "rows_counts": _graph_count_delta(c_start, c_rows),
        "party": {"B": B, "warm_s": warm_s, "graphs_s": graph_s, "eager_s": eager_s,
                  "ok": [ok_warm, ok_graph, ok_eager], "verified": verified,
                  "graphs_equal_eager": bool(np.array_equal(sig_graph, sig_eager)),
                  "warm_equal": bool(np.array_equal(sig_warm, sig_graph)),
                  "counts": party_delta},
        "concurrent": {"threads": 3, "calls_each": 10, "errors": errors, "stuck": stuck},
        "counts": counts, "entries": len(graphs.entries()),
        "memory_reserved": torch.cuda.memory_reserved() if dev == "cuda" else None,
        "t_start_s": t_start, "t_end_s": since_start(),
    }
    failed = [c for c, b in (
        ("every replay equals its eager body", bad),
        ("the party sign verifies and agrees", not (ok_warm and ok_graph and ok_eager)
         or verified != B or not rec["party"]["graphs_equal_eager"]
         or not rec["party"]["warm_equal"]),
        ("no capture and no eager run after the warm-up",
         any(c["captures"] for c in party_delta.values())
         or (dev == "cuda" and not any(c["replays"] for c in party_delta.values()))),
        ("concurrent replays give the serial results", errors or stuck),
        ("one capture per key", sum(c["captures"] for c in counts.values())
         != rec["entries"])) if b]
    rec["failed_checks"] = failed
    return rec


def check_graphs(rec: dict) -> None:
    if rec["failed_checks"]:
        raise AssertionError(f"graphs: {rec['failed_checks']}: {rec['mismatches']}, "
                             f"party {rec['party']}, concurrent {rec['concurrent']}")


# ---------------------------------------------------------------------------
# phase 36: the GG18 engine's per-shape CUDA graphs
# ---------------------------------------------------------------------------

GG18_GRAPHS_B = (1, 16, 1024)  # batch sizes of phase 36's replay-vs-eager rows
GG18_GRAPHS_PARTY_B = 16
GG18_GRAPHS_ENGINE_B = 1024  # cell 1: the flagship Paillier sign


def _same_leaves(a, b) -> bool:
    """Two outputs of a graphed function hold equal structure and tensors."""
    import torch

    from mpcium_tpu_torch.engine import graphs

    la: list = []
    lb: list = []
    return graphs._flatten(a, la) == graphs._flatten(b, lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _gg18_counts() -> dict:
    from mpcium_tpu_torch.engine import graphs

    return {k: v for k, v in graphs.counts().items() if k.startswith("gg18.")}


def gg18_engine_runs(signer, shares, seed: int, K, dev: str = "cuda") -> dict:
    """Phase 36 (b) on a warm flagship signer (phase 4's: 2-of-3, quorum
    node0/node1, the 2048-bit fixture, full ``Domains()``, B wallets;
    its first sign built the comb tables and captured the graphs): fresh
    digests under one seeded stream, once through graphs only and once
    with every graphed body eager; K0's counters zeroed before each.
    → the record."""
    import numpy as np

    from mpcium_tpu_torch.engine import graphs
    from mpcium_tpu_torch.utils.rng import SeededStream

    t_start = since_start()
    B = signer.B
    digests = np.random.default_rng(seed + 62).integers(0, 256, (B, 32), dtype=np.uint8)
    runs = {}
    for name, ctx in (("graphs", contextlib.nullcontext), ("eager", graphs.eager_bodies)):
        signer.rng = SeededStream(seed + 63)
        phases: dict = {}
        c0 = _gg18_counts()
        K.reset_counters()
        t0 = time.perf_counter()
        with ctx():
            out = signer.sign(digests, phase_times=phases, cohorts=COHORTS)
            _sync(dev)
        runs[name] = {"sign_s": time.perf_counter() - t0, "phases_s": phases,
                      "k0": _k0_json(_k0_counts(K)),
                      "counts": _graph_count_delta(c0, _gg18_counts()), "out": out}
    g, e = runs["graphs"]["out"], runs["eager"]["out"]
    equal = all(np.array_equal(g[k], e[k]) for k in ("r", "s", "recovery", "ok"))
    verified = verify_ecdsa([s.public_key for s in shares[0]], digests, g["r"], g["s"])
    for r in runs.values():
        r["ok_all"] = bool(r.pop("out")["ok"].all())
    return {"B": B, "cohorts": COHORTS, **runs, "graphs_equal_eager": equal,
            "verified": verified, "t_start_s": t_start, "t_end_s": since_start()}


def gg18_engine_signer(B: int, seed: int, dev: str = "cuda", bits: int = 2048, dom=None):
    """A flagship signer as phase 4 builds it (the ``bits``-bit fixture,
    ``dom`` or the full ``Domains()``), warmed by one sign → (signer,
    shares, first sign s), for :func:`gg18_engine_runs` outside
    ``chip_smoke.py``'s main()."""
    import numpy as np

    from mpcium_tpu_torch.cluster import load_test_preparams
    from mpcium_tpu_torch.engine import gg18_batch as gb
    from mpcium_tpu_torch.utils.rng import SeededStream

    shares = gb.dealer_keygen_secp_batch(B, UNIVERSE, 1, rng=SeededStream(seed + 60))
    signer = gb.GG18BatchCoSigners(["node0", "node1"], shares[:2], load_test_preparams(bits),
                                   dom=dom or gb.Domains(), rng=SeededStream(seed + 61),
                                   mta_impl="paillier", device=dev)
    t0 = time.perf_counter()
    signer.sign(np.random.default_rng(seed + 64).integers(0, 256, (B, 32), dtype=np.uint8),
                cohorts=COHORTS)
    _sync(dev)
    return signer, shares, time.perf_counter() - t0


def _gg18_party_runs(B: int, seed: int, K, dev: str) -> dict:
    """2-of-3 ``BatchedECDSASigningParty`` (node0, node1; the 1024-bit
    fixture with the domains it carries, as the warm pass signs) over B
    dealer wallets three times under the same seeded streams: a warm-up,
    graphs only, every body eager. Every party builds its comb tables in
    python ints at its first sign (60–80 s a sign at B=16 on the 2048-bit
    fixture, PR 19's call A), so the 1024-bit one keeps this short."""
    import numpy as np

    from mpcium_tpu_torch.cluster import load_test_preparams
    from mpcium_tpu_torch.engine import gg18_batch as gb
    from mpcium_tpu_torch.engine import graphs
    from mpcium_tpu_torch.protocol.ecdsa.batch_signing import BatchedECDSASigningParty
    from mpcium_tpu_torch.protocol.runner import run_protocol
    from mpcium_tpu_torch.utils.rng import SeededStream
    from mpcium_tpu_torch.warm.prewarm import _FIXTURE_DOMAINS

    quorum = ["node0", "node1"]
    dom = gb.Domains(**_FIXTURE_DOMAINS)
    shares = gb.dealer_keygen_secp_batch(B, UNIVERSE, 1, rng=SeededStream(seed + 70),
                                         preparams=load_test_preparams(1024))
    digests = [r.tobytes() for r in np.random.default_rng(seed + 71).integers(
        0, 256, (B, 32), dtype=np.uint8)]
    runs = {}
    for name, ctx in (("warm", contextlib.nullcontext), ("graphs", contextlib.nullcontext),
                      ("eager", graphs.eager_bodies)):
        parties = {pid: BatchedECDSASigningParty(f"chip-gg18-graphs-{seed}", pid, quorum,
                                                 shares[i], digests, dom=dom,
                                                 rng=SeededStream(seed + 72 + i),
                                                 cohorts=COHORTS, device=dev)
                   for i, pid in enumerate(quorum)}
        c0 = _gg18_counts()
        K.reset_counters()
        t0 = time.perf_counter()
        with ctx():
            run_protocol(parties)
            _sync(dev)
        res = [parties[p].result for p in quorum]
        runs[name] = {"sign_s": time.perf_counter() - t0, "k0": _k0_json(_k0_counts(K)),
                      "counts": _graph_count_delta(c0, _gg18_counts()),
                      "ok_all": all(bool(r["ok"].all()) for r in res),
                      "agree": all(np.array_equal(res[0][k], r[k]) for r in res
                                   for k in ("r", "s", "ok")),
                      "out": res[0]}
    g, e = runs["graphs"]["out"], runs["eager"]["out"]
    equal = all(np.array_equal(g[k], e[k]) and np.array_equal(runs["warm"]["out"][k], g[k])
                for k in ("r", "s", "recovery", "ok"))
    verified = verify_ecdsa([s.public_key for s in shares[0]], digests, g["r"], g["s"])
    for r in runs.values():
        r.pop("out")
    return {"B": B, "fixture_bits": 1024, **runs, "graphs_equal_eager": equal,
            "verified": verified}


def gg18_graph_rows(seed: int, dev: str = "cuda", bs=GG18_GRAPHS_B) -> dict:
    """Phase 36 (a) in this process: each of the GG18 engine's 25 graphed
    functions at each B of ``bs`` on the seeded inputs of
    ``utils/gg18_graphs_golden.calls`` (B = 1 and 16 in phase 24's
    child, 1,024 in the goldens' process): its replay must equal
    ``fn.eager``; first call, replay and eager times, the key's pool and
    capture seconds; this process's captures and keys. → a part of the
    phase record."""
    from mpcium_tpu_torch.engine import graphs
    from mpcium_tpu_torch.utils import gg18_graphs_golden as g18

    t_start = since_start()
    fns, pkg = g18.port_fns(), g18.port_pkg(dev)
    c_start = _gg18_counts()
    rows, bad = [], []
    for B in bs:
        for name, args in g18.calls(B, seed + B):
            fn, a = fns[name], g18.to_args(args, pkg)
            t0 = time.perf_counter()
            fn(*a)
            _sync(dev)
            first_s = time.perf_counter() - t0
            replay_ms, replay_host_ms = _timed_calls(lambda: fn(*a), GRAPHS_REPLAYS, dev)
            out: list = []
            eager_ms, eager_host_ms = _timed_calls(lambda: out.append(fn.eager(*a)), 1, dev)
            same = _same_leaves(fn(*a), out[0])
            if not same:
                bad.append(f"{name} B={B}")
            entry = fn.graphs.entries.get(graphs.call_key(fn.graphs.name, tuple(a), {})[0])
            rows.append({"fn": name, "B": B, "equal": same, "first_call_s": first_s,
                         "replay_ms": replay_ms, "replay_host_ms": replay_host_ms,
                         "eager_ms": eager_ms, "eager_host_ms": eager_host_ms,
                         "pool_bytes": entry.pool_bytes if entry else None,
                         "capture_s": entry.capture_s if entry else None})
    return {"B": list(bs), "rows": rows, "mismatches": bad,
            "counts": _graph_count_delta(c_start, _gg18_counts()), **_gg18_keys(dev),
            "t_start_s": t_start, "t_end_s": since_start()}


def _gg18_keys(dev: str) -> dict:
    """This process's GG18 keys: captures against keys (one each), their
    capture seconds and pools, the card's reserved memory."""
    import torch

    from mpcium_tpu_torch.engine import graphs

    keys = [r for r in graphs.entries() if r["fn"].startswith("gg18.")]
    return {"captures": sum(c["captures"] for c in _gg18_counts().values()),
            "entries": len(keys), "capture_s_total": sum(r["capture_s"] for r in keys),
            "pool_bytes_total": sum(r["pool_bytes"] for r in keys),
            "memory_reserved": torch.cuda.memory_reserved() if dev == "cuda" else None}


def gg18_party_threads(seed: int, K, dev: str = "cuda",
                       party_b: int = GG18_GRAPHS_PARTY_B) -> dict:
    """Phase 36 (c) and (d) in this process (the main one, after (b)):
    the batched party at ``party_b`` through graphs and eager, then three
    threads replaying ``_blk_final`` at B=16 with their own inputs, each
    held to its serial result. → a part of the phase record."""
    import threading

    from mpcium_tpu_torch.engine import gg18_batch as gb
    from mpcium_tpu_torch.utils import gg18_graphs_golden as g18

    t_start = since_start()
    party = _gg18_party_runs(party_b, seed, K, dev)
    pkg = g18.port_pkg(dev)
    inputs = [g18.to_args(dict(g18.calls(16, seed + 100 + i))["_blk_final"], pkg)
              for i in range(3)]
    serial = [gb._blk_final(*a) for a in inputs]
    errors: list = []

    def replayer(i: int) -> None:
        for _ in range(10):
            if not _same_leaves(gb._blk_final(*inputs[i]), serial[i]):
                errors.append(i)

    threads = [threading.Thread(target=replayer, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return {"party": party,
            "concurrent": {"threads": 3, "calls_each": 10, "fn": "_blk_final", "B": 16,
                           "errors": errors, "stuck": [t.name for t in threads if t.is_alive()]},
            **_gg18_keys(dev), "t_start_s": t_start, "t_end_s": since_start()}


def gg18_graphs_finish(rows: list, party_threads: dict, engine: dict, dev: str = "cuda") -> dict:
    """Phase 36's record from its parts, (a)'s ``rows`` (one per process),
    (c) and (d), and (b) the engine sign (:func:`gg18_engine_runs`, run
    in the process that owns the warm signer), with ``failed_checks``."""
    on_card = dev == "cuda"
    party = party_threads["party"]
    conc = party_threads["concurrent"]

    def replay_only(run) -> bool:
        c = run["counts"].values()
        return not any(x["captures"] for x in c) and (not on_card or any(
            x["replays"] for x in c))

    def eager_only(run) -> bool:
        return not any(x["captures"] or x["replays"] for x in run["counts"].values())

    def k0_ok(run) -> bool:
        k = run["k0"]
        return k["plain_calls"] == 0 and k["launches"] > 0 if on_card else True

    mismatches = [m for part in rows for m in part["mismatches"]]
    rec = {"phase": "gg18_graphs", "device": dev, "nvidia_smi": smi() if on_card else None,
           "B": [b for part in rows for b in part["B"]],
           "rows": [r for part in rows for r in part["rows"]], "mismatches": mismatches,
           "rows_parts": [{k: v for k, v in part.items() if k not in ("rows", "mismatches")}
                          for part in rows],
           "engine": engine, **party_threads}
    rec["failed_checks"] = [c for c, b in (
        ("every replay equals its eager body", mismatches),
        ("the engine sign verifies and equals its eager run",
         not (engine["graphs"]["ok_all"] and engine["eager"]["ok_all"])
         or engine["verified"] != engine["B"] or not engine["graphs_equal_eager"]),
        ("the engine's graphs run replays only, its eager run none",
         not replay_only(engine["graphs"]) or not eager_only(engine["eager"])),
        ("K0 launches and no plain call in the engine sign",
         not (k0_ok(engine["graphs"]) and k0_ok(engine["eager"]))),
        ("the party sign verifies and agrees",
         not all(party[k]["ok_all"] and party[k]["agree"] for k in ("warm", "graphs", "eager"))
         or party["verified"] != party["B"] or not party["graphs_equal_eager"]),
        ("the party's graphs run replays only, its eager run none",
         not replay_only(party["graphs"]) or not eager_only(party["eager"])),
        ("concurrent replays give the serial results", conc["errors"] or conc["stuck"]),
        ("one capture per key in each process",
         any(p["captures"] != p["entries"] for p in rows + [party_threads])),
    ) if b]
    return rec


def check_gg18_graphs(rec: dict) -> None:
    if rec["failed_checks"]:
        raise AssertionError(f"gg18_graphs: {rec['failed_checks']}: {rec['mismatches']}, "
                             f"engine {rec['engine']}, party {rec['party']}, "
                             f"concurrent {rec['concurrent']}")


def _k0_counts(K):
    """K0 launches by entry, mode and width, and plain-version calls."""
    return {
        "launches": K.launches + sum(K.powmod_launches_by_mode_width.values()),
        "mulmod_by_width": dict(K.launches_by_width),
        "powmod_by_mode_width": dict(K.powmod_launches_by_mode_width),
        "plain_calls": K.plain_calls,
    }


def _k0_json(c) -> dict:
    return {"launches": c["launches"], "plain_calls": c["plain_calls"],
            "mulmod_launches_by_width": {str(k): v for k, v in
                                         sorted(c["mulmod_by_width"].items())},
            "powmod_launches_by_mode_width": {f"{m}/{n}": v for (m, n), v in
                                              sorted(c["powmod_by_mode_width"].items())}}


def _no_k0(K, what: str) -> dict:
    """K0's counters since the last reset, which must read 0: ``what``
    reaches neither K0 nor its plain versions."""
    k0 = _k0_counts(K)
    if k0["launches"] or k0["plain_calls"]:
        raise AssertionError(f"{what} reached K0 or its plain versions: {k0}")
    return _k0_json(k0)


def _recombines(party_shares, wallets, t: int, order: int, mul) -> int:
    """Wallets among ``wallets`` whose first t+1 members' shares
    Lagrange-combine (host ints) to a secret whose public key is the
    wallets' public key."""
    from mpcium_tpu_torch.core import hostmath as hm

    good = 0
    for w in wallets:
        rows = [shares[w] for shares in party_shares[: t + 1]]
        xs = [r.self_x for r in rows]
        secret = sum(hm.lagrange_coeff(xs, r.self_x, order) * r.share for r in rows) % order
        good += mul(secret) == party_shares[0][w].public_key
    return good


def _secp_pub(secret: int) -> bytes:
    from mpcium_tpu_torch.core import hostmath as hm

    return hm.secp_compress(hm.secp_mul(secret, hm.SECP_G))


def _ed_pub(secret: int) -> bytes:
    from mpcium_tpu_torch.core import hostmath as hm

    return hm.ed_compress(hm.ed_mul(secret, hm.ED_B))


def ecdsa_party_golden(dev: str = "cuda") -> None:
    """The JAX party's committed golden replayed on the card: every wire
    message (long fields by digest), each party's (r, s, recovery, ok)
    and the material digests, at cohorts 1 and 2."""
    from mpcium_tpu_torch.cluster import load_test_preparams
    from mpcium_tpu_torch.engine import gg18_batch as gb
    from mpcium_tpu_torch.protocol.ecdsa.batch_signing import (
        BatchedECDSASigningParty, quorum_material_digest,
    )
    from mpcium_tpu_torch.protocol.runner import run_protocol
    from mpcium_tpu_torch.utils import gg18_party_golden as pg

    want = json.loads((GOLDENS / "gg18_party_b4.json").read_text())["record"]
    pre = load_test_preparams(1024)
    diff, secs = [], {}
    for k in pg.COHORTS:
        t0 = time.perf_counter()
        got = pg.party_record(gb, BatchedECDSASigningParty, run_protocol,
                              quorum_material_digest, pre, k, device=dev)
        secs[str(k)] = time.perf_counter() - t0
        diff += [f"cohorts{k}/{key}" for key in _record_diff(got, want)]
    emit({"phase": "ecdsa_party_golden", "B": pg.B, "cohorts": pg.COHORTS,
          "wire_messages": len(want["wire"]), "matches_jax_golden": not diff,
          "differs": diff, "s_by_cohorts": secs})
    if diff:
        raise AssertionError(f"the ECDSA party differs from the JAX golden in {diff}")


def dkg_golden(dev: str = "cuda") -> None:
    """The JAX DKG and reshare engines' and parties' committed goldens
    replayed on the card, both curves, at cohorts 1 and 2."""
    from mpcium_tpu_torch.cluster import load_test_preparams
    from mpcium_tpu_torch.engine import dkg_batch as dk
    from mpcium_tpu_torch.protocol.batch_dkg import BatchedDKGParty, BatchedReshareParty
    from mpcium_tpu_torch.protocol.runner import run_protocol
    from mpcium_tpu_torch.utils import dkg_golden as dg

    engine = json.loads((GOLDENS / "dkg_b4.json").read_text())["record"]
    party = json.loads((GOLDENS / "dkg_party_b4.json").read_text())["record"]
    pre = load_test_preparams(1024)
    t0 = time.perf_counter()
    diff = []
    for k in dg.COHORTS:
        diff += [f"engine/cohorts{k}/{key}"
                 for key in _record_diff(dg.engine_record(dk, k, device=dev), engine)]
        got = dg.party_record(BatchedDKGParty, BatchedReshareParty, run_protocol, pre, k,
                              device=dev)
        diff += [f"party/cohorts{k}/{kt}/{proto}" for kt in dg.CURVES
                 for proto in ("dkg", "reshare") if got[kt][proto] != party[kt][proto]]
    emit({"phase": "dkg_golden", "B": dg.B, "curves": dg.CURVES, "cohorts": dg.COHORTS,
          "matches_jax_golden": not diff, "differs": diff, "s": time.perf_counter() - t0})
    if diff:
        raise AssertionError(f"DKG / reshare differ from the JAX goldens in {diff}")


def run_dkg_engine(B: int, seed: int, K, dev: str = "cuda"):
    """BASELINE config 4: the in-process 2-of-3 secp256k1 DKG of B wallets,
    a first and a measured warm run (K0's counters zeroed just before)."""
    import numpy as np

    from mpcium_tpu_torch.core import hostmath as hm
    from mpcium_tpu_torch.engine import dkg_batch as dk
    from mpcium_tpu_torch.engine.pipeline import resolve_cohorts
    from mpcium_tpu_torch.utils.rng import SeededStream

    dkg = dk.BatchedDKG(UNIVERSE, 1, "secp256k1", rng=SeededStream(seed + 40), device=dev)
    t0 = time.perf_counter()
    dkg.run(B, cohorts=COHORTS)
    first_s = time.perf_counter() - t0
    phases: dict = {}
    K.reset_counters()
    t0 = time.perf_counter()
    shares = dkg.run(B, cohorts=COHORTS, phase_times=phases)  # raises on any VSS failure
    _sync(dev)
    run_s = time.perf_counter() - t0
    k0 = _no_k0(K, "the DKG engine")
    sample = sorted(np.random.default_rng(seed + 41).choice(B, min(B, 64), replace=False).tolist())
    t0 = time.perf_counter()
    good = _recombines(shares, sample, 1, hm.SECP_N, _secp_pub)
    same_pub = all(len({s[w].public_key for s in shares}) == 1 for w in range(B))
    emit({"phase": "dkg_engine", "B": B, "scheme": "2-of-3 secp256k1 Feldman DKG",
          "cohorts": resolve_cohorts(B, COHORTS), "first_run_s": first_s, "run_s": run_s,
          "wallets_per_s": B / run_s, "phases_s": phases,
          "public_keys_agree": same_pub,
          "sampled_recombined": f"{good}/{len(sample)}",
          "recombine_s": time.perf_counter() - t0, "k0": k0})
    if good != len(sample) or not same_pub:
        raise AssertionError(f"DKG: {good}/{len(sample)} sampled wallets recombine")
    return shares


def run_reshare_engine(B: int, seed: int, dkg_shares, K, dev: str = "cuda") -> None:
    """BASELINE config 5: the first B DKG wallets rotated from the quorum
    node0, node1 (2-of-3) to a 3-of-5 committee; first and warm run."""
    import numpy as np

    from mpcium_tpu_torch.core import hostmath as hm
    from mpcium_tpu_torch.engine import dkg_batch as dk
    from mpcium_tpu_torch.utils.rng import SeededStream

    old = [dkg_shares[0][:B], dkg_shares[1][:B]]
    new_committee = [f"node{i}" for i in range(5)]
    rs = dk.BatchedReshare(["node0", "node1"], old, new_committee, 2,
                           rng=SeededStream(seed + 42), device=dev)
    t0 = time.perf_counter()
    rs.run(cohorts=COHORTS)
    first_s = time.perf_counter() - t0
    phases: dict = {}
    K.reset_counters()
    t0 = time.perf_counter()
    new = rs.run(cohorts=COHORTS, phase_times=phases)
    _sync(dev)
    run_s = time.perf_counter() - t0
    k0 = _no_k0(K, "the reshare engine")
    pubs_kept = all(new[j][w].public_key == old[0][w].public_key
                    for j in range(5) for w in range(B))
    epochs = sorted({s.epoch for row in new for s in row})
    sample = sorted(np.random.default_rng(seed + 43).choice(B, min(B, 64), replace=False).tolist())
    good = _recombines(new[2:], sample, 2, hm.SECP_N, _secp_pub)
    emit({"phase": "reshare_engine", "B": B, "scheme": "2-of-3 -> 3-of-5 secp256k1",
          "first_run_s": first_s, "run_s": run_s, "wallets_per_s": B / run_s,
          "phases_s": phases, "public_keys_unchanged": pubs_kept, "epochs": epochs,
          "sampled_recombined": f"{good}/{len(sample)}", "k0": k0})
    if not pubs_kept or epochs != [1] or good != len(sample):
        raise AssertionError("reshare: keys, epoch or recombination wrong")


def _traced(parties, run_protocol, dev: str):
    """Run ``parties`` with span recording on → (wall s, seconds per
    runner round, seconds per party phase)."""
    from mpcium_tpu_torch.utils import tracing

    spans: list = []
    tracing.enable(spans.append)
    t0 = time.perf_counter()
    try:
        run_protocol(parties)
        _sync(dev)
    finally:
        tracing.disable()
    wall = time.perf_counter() - t0
    rounds, phases = {}, {}
    for sp in spans:
        into = rounds if sp["name"].startswith("round:") else phases
        into[sp["name"]] = into.get(sp["name"], 0.0) + (sp["t1_ns"] - sp["t0_ns"]) / 1e9
    return wall, rounds, phases


def _party_sign(sid, quorum, shares_by_pid, digests, seed, K, run_protocol, dev):
    """Batched GG18 parties of ``quorum`` sign ``digests`` with K0's
    counters zeroed just before; every signature verified on the host."""
    import numpy as np

    from mpcium_tpu_torch.protocol.ecdsa.batch_signing import BatchedECDSASigningParty
    from mpcium_tpu_torch.utils.rng import SeededStream

    t0 = time.perf_counter()
    parties = {pid: BatchedECDSASigningParty(sid, pid, quorum, shares_by_pid[pid], digests,
                                             rng=SeededStream(seed + i), cohorts=COHORTS,
                                             device=dev)
               for i, pid in enumerate(quorum)}
    _sync(dev)
    setup_s = time.perf_counter() - t0
    K.reset_counters()
    wall, rounds, phases = _traced(parties, run_protocol, dev)
    k0 = _k0_counts(K)
    res = [parties[p].result for p in quorum]
    agree = all(np.array_equal(res[0][k], r[k]) for r in res for k in ("r", "s", "ok"))
    t0 = time.perf_counter()
    verified = verify_ecdsa([s.public_key for s in shares_by_pid[quorum[0]]], digests,
                            res[0]["r"], res[0]["s"])
    out = {"parties": quorum, "B": len(digests), "setup_s": setup_s, "sign_s": wall,
           "sigs_per_s": len(digests) / wall, "seconds_by_round": rounds,
           "seconds_by_phase": phases, "ok_all": all(bool(r["ok"].all()) for r in res),
           "parties_agree": agree, "verified": verified,
           "host_verify_s": time.perf_counter() - t0, "k0": _k0_json(k0)}
    if not out["ok_all"] or not agree or verified != len(digests):
        raise AssertionError(f"party sign {quorum}: {out}")
    return out, k0


def run_wallet_lifecycle(B: int, seed: int, K, dev: str = "cuda"):
    """DKG → GG18 sign → reshare → sign, as distributed parties through
    run_protocol on the 2048-bit fixture with full Domains() → (the phase
    record, K0's counts over the first sign); :func:`check_lifecycle`
    holds them to the phase's checks."""
    import numpy as np

    from mpcium_tpu_torch.cluster import load_test_preparams
    from mpcium_tpu_torch.protocol.batch_dkg import BatchedDKGParty, BatchedReshareParty
    from mpcium_tpu_torch.protocol.ecdsa.batch_signing import quorum_material_digest
    from mpcium_tpu_torch.protocol.runner import run_protocol
    from mpcium_tpu_torch.utils.rng import SeededStream

    pre = load_test_preparams(2048)
    sid = f"chip-lifecycle-{seed}"
    dkg = {pid: BatchedDKGParty(f"{sid}-dkg", pid, UNIVERSE, 1, "secp256k1", B,
                                preparams=pre[pid], rng=SeededStream(seed + 50 + i),
                                cohorts=COHORTS, device=dev)
           for i, pid in enumerate(UNIVERSE)}
    K.reset_counters()
    dkg_s, dkg_rounds, dkg_phases = _traced(dkg, run_protocol, dev)
    dkg_k0 = _no_k0(K, "the DKG parties")
    shares = {pid: p.result for pid, p in dkg.items()}
    pubs = [s.public_key for s in shares["node0"]]
    digest_equal = quorum_material_digest(shares["node0"][0]) == \
        quorum_material_digest(shares["node1"][0]) != ""
    drng = np.random.default_rng(seed + 60)
    digests = [r.tobytes() for r in drng.integers(0, 256, (B, 32), dtype=np.uint8)]
    sign1, k0 = _party_sign(f"{sid}-sign", ["node0", "node1"], shares, digests, seed + 61,
                            K, run_protocol, dev)
    old = ["node0", "node1"]
    rs = {pid: BatchedReshareParty(f"{sid}-reshare", pid, "secp256k1", old, UNIVERSE, 1, B,
                                   old_shares=shares[pid] if pid in old else None,
                                   old_public_keys=pubs, preparams=pre[pid],
                                   rng=SeededStream(seed + 70 + i), cohorts=COHORTS,
                                   device=dev)
          for i, pid in enumerate(UNIVERSE)}
    K.reset_counters()
    rs_s, rs_rounds, rs_phases = _traced(rs, run_protocol, dev)
    rs_k0 = _no_k0(K, "the reshare parties")
    new = {pid: p.result for pid, p in rs.items()}
    kept = all(new[pid][w].public_key == pubs[w] and new[pid][w].epoch == 1
               for pid in UNIVERSE for w in range(B))
    digests2 = [r.tobytes() for r in drng.integers(0, 256, (B, 32), dtype=np.uint8)]
    sign2, _ = _party_sign(f"{sid}-sign2", ["node1", "node2"], new, digests2, seed + 80, K,
                           run_protocol, dev)
    return {"phase": "wallet_lifecycle", "B": B, "fixture": "test_preparams.json (2048-bit)",
            "domains": "Domains()", "cohorts": COHORTS,
            "dkg": {"parties": UNIVERSE, "wall_s": dkg_s, "wallets_per_s": B / dkg_s,
                    "seconds_by_round": dkg_rounds, "seconds_by_phase": dkg_phases,
                    "k0": dkg_k0},
            "material_digest_equal": digest_equal, "sign": sign1,
            "reshare": {"old_quorum": old, "new_committee": UNIVERSE, "t_new": 1,
                        "wall_s": rs_s, "wallets_per_s": B / rs_s,
                        "public_keys_unchanged_epoch_1": kept,
                        "seconds_by_round": rs_rounds, "seconds_by_phase": rs_phases,
                        "k0": rs_k0},
            "sign_after_reshare": sign2}, k0


def check_lifecycle(rec: dict, k0: dict) -> None:
    """Phase 19's checks: equal material digests, every key kept at epoch
    1, and the first sign launched both entries at both widths and every
    powmod mode of the path, with no plain call."""
    if not rec["material_digest_equal"] or not rec["reshare"]["public_keys_unchanged_epoch_1"]:
        raise AssertionError("lifecycle: material digests differ or the reshare moved keys")
    for n in (320, 608):
        if k0["mulmod_by_width"].get(n, 0) == 0:
            raise AssertionError(f"no mulmod launch at width {n} during the party sign")
    for key in POWMOD_PATH:
        if k0["powmod_by_mode_width"].get(key, 0) == 0:
            raise AssertionError(f"no powmod launch of {key} during the party sign")
    if k0["plain_calls"]:
        raise AssertionError(f"a plain version ran {k0['plain_calls']}x on the card")


_LIFECYCLE_POOL = None
CHAOS_SEED = 7  # the JAX package's `make chaos` seed


def _lifecycle_task(B: int, seed: int):
    """Phase 19 in a process of its own (its K0 counters are its own)."""
    global _POOL
    import torch

    from mpcium_tpu_torch.ops import mulmod as K

    torch.backends.cuda.matmul.allow_tf32 = False
    K.build()
    t0 = since_start()
    try:
        rec, k0 = run_wallet_lifecycle(B, seed, K)
    finally:
        if _POOL is not None:
            _POOL.shutdown()
            _POOL = None
    rec.update(t_start_s=t0, t_end_s=since_start())
    return rec, k0


def start_lifecycle(B: int, seed: int, ot_host_B: int):
    """Start phase 19 on a spawned process, niced like phase 24's; it
    overlaps the phases after the kernel timings. Phases 33, 27 and 35
    are the worker's second task: they run after the lifecycle returns."""
    global _LIFECYCLE_POOL
    _LIFECYCLE_POOL = spawned_pool()
    t_submit = time.perf_counter()
    return (_LIFECYCLE_POOL.submit(_lifecycle_task, B, seed),
            _LIFECYCLE_POOL.submit(_ot_host_soak_task, ot_host_B, seed), t_submit)


def join_lifecycle(future, t_submit: float) -> dict:
    """Wait for phase 19, print its line and hold it to its checks → K0's
    counts over its first sign (the kernels line's launches)."""
    t0 = time.perf_counter()
    rec, k0 = future.result()
    wait_s = time.perf_counter() - t0
    emit({**rec, "overlapped": True, "join_wait_s": wait_s,
          "since_submit_s": time.perf_counter() - t_submit})
    check_lifecycle(rec, k0)
    return k0


# ---------------------------------------------------------------------------
# phases 26 and 27: chaos drills and the SLO load soak on the card
# ---------------------------------------------------------------------------

CHAOS_EXPECTED = {"node-crash": "recovered", "drop-jitter": "success",
                  "broker-failover": "success",
                  "partition": "loud-failure-then-recovery",
                  "kill-resume": "resumed", "cheater": "caught-and-quarantined"}
# the JAX package's recorded soak configuration (SOAK_r01.json "config"),
# all 48 signs (three bursts of 16) since the EdDSA engine replays CUDA
# graphs; before, it was cut to one burst. wait_timeout_s is the
# harness's wait for the last result (900 there): a run still pending
# after it fails the books inside the script's limit
SOAK_REDUCED = None
SOAK_CFG = {"n_nodes": 3, "threshold": 1, "n_wallets": 12, "n_sign": 48,
            "n_keygen": 0, "n_reshare": 0, "burst_size": 16, "burst_gap_s": 0.3,
            "seed": 1337, "interactive_fraction": 0.25,
            "interactive_deadline_ms": 120_000, "bulk_deadline_ms": 600_000,
            "max_retries": 3, "retry_backoff_s": 0.5, "chaos": "batch-chaos",
            "chaos_seed": 7, "chaos_scale": 1.0, "batch_window_s": 0.25,
            "batch_max_batch": 1024, "batch_max_queue_depth": 10,
            "manifest_timeout_s": 120.0, "warmup_signs": 0, "wait_timeout_s": 420.0}


def run_chaos(seed: int, dev: str = "cuda") -> dict:
    """Phase 26: every drill of the catalog on ``dev`` → the phase record
    with one row per drill (the trace document by its event count)."""
    from mpcium_tpu_torch.faults.chaos import run_all

    t0 = since_start()
    rows = []
    for r in run_all(seed=seed, scale=1.0, device=dev):
        row = {"drill": r.name, "expected": r.expected, "outcome": r.outcome, "ok": r.ok,
               "duration_s": r.duration_s, "faults": r.faults, "error": r.error,
               "trace_events": len(r.trace.get("traceEvents", []))}
        if r.name == "kill-resume":
            row.update(resume_latency_s=r.resume_latency_s, warm=r.warm)
        if r.name == "cheater":
            row.update(culprit=r.culprit, survivors=r.survivors,
                       ot_leg_device=[n.split(": ", 1)[1] for n in r.notes
                                      if n.startswith("OT leg device: ")])
        if not r.ok:
            row["notes"] = r.notes
        rows.append(row)
    return {"phase": "chaos", "seed": seed, "scale": 1.0, "device": dev, "drills": rows,
            "t_start_s": t0, "t_end_s": since_start()}


def check_chaos(rec: dict) -> None:
    got = {r["drill"]: r["outcome"] for r in rec["drills"]}
    bad = {k: got.get(k) for k, v in CHAOS_EXPECTED.items() if got.get(k) != v}
    bad.update({r["drill"]: r["outcome"] for r in rec["drills"] if not r["ok"]})
    if bad:
        notes = {r["drill"]: r.get("notes", []) + ([r["error"]] if r["error"] else [])
                 for r in rec["drills"] if r["drill"] in bad}
        raise AssertionError(f"chaos: drills missed their expected outcome: {bad}; "
                             f"their notes: {notes}")
    cheater = next(r for r in rec["drills"] if r["drill"] == "cheater")
    if cheater["ot_leg_device"] != [rec["device"]]:
        raise AssertionError(f"chaos: the cheater's OT leg ran on {cheater['ot_leg_device']}")


def _session_overlap(trace: dict) -> dict:
    """How the party sessions of a run overlapped, from its trace (the
    sessions closed when the report was taken): their count, the most
    live at once, and when (s after the first started) the first and the
    last ended."""
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in trace["traceEvents"]
             if e.get("name") == "session" and e.get("ph") == "X"]
    if not spans:
        return {"party_sessions": 0}
    t0 = min(a for a, _b in spans)
    return {"party_sessions": len(spans),
            "live_max": max(sum(a <= t < b for a, b in spans) for t, _b in spans),
            "first_end_s": (min(b for _a, b in spans) - t0) / 1e6,
            "last_end_s": (max(b for _a, b in spans) - t0) / 1e6}


def run_soak_phase(dev: str = "cuda") -> dict:
    """Phase 27: the recorded soak configuration on ``dev``; every
    succeeded signature is kept and verified on the host under its
    wallet's key → the phase record (the report without its trace, which
    gives the batch sizes and the sessions' overlap)."""
    import tempfile

    from mpcium_tpu_torch import wire
    from mpcium_tpu_torch.core import hostmath as hm
    from mpcium_tpu_torch.soak import SoakConfig, SoakRun

    class _KeptSoak(SoakRun):
        """The soak, keeping every success event's signature (late and
        duplicate ones too) and each node's scheduler device."""

        def __init__(self, cfg, device):
            self.sigs = []
            super().__init__(cfg, device=device)
            node0 = self.cluster.nodes["node0"]
            self.pubs = {w: bytes.fromhex(node0.keyinfo.get("ed25519", w).public_key)
                         for w in self.wallets}
            self.devices = sorted({str(ec.scheduler.device) for ec in self.cluster.consumers})

        def _on_sign(self, ev):
            if ev.result_type == wire.RESULT_SUCCESS:
                with self._lock:
                    self.sigs.append((ev.tx_id.split("~r")[0], ev.wallet_id, ev.signature))
            super()._on_sign(ev)

    root = tempfile.mkdtemp(prefix="chip-smoke-soak-")
    t0 = since_start()
    try:
        run = _KeptSoak(SoakConfig(**SOAK_CFG, root_dir=root), dev)
        report = run.run()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    trace = report.pop("trace")
    report.pop("prometheus")
    sizes = sorted(int(e.get("args", {}).get("n", 0)) for e in trace["traceEvents"]
                   if e.get("name") == "dispatch" and e.get("ph") != "M")
    with run._lock:
        txs = {b: (r.wallet_id, r.tx) for b, r in run._reqs.items()}
        done = {b for b, r in run._reqs.items() if r.status == "succeeded"}
    # every success event, first or late, under the key of the wallet its
    # request named, over that request's bytes
    verified = sum(w == txs[b][0] and hm.ed25519_verify(run.pubs[w], txs[b][1],
                                                        bytes.fromhex(sig))
                   for b, w, sig in run.sigs)
    per_node = report["scheduler"].pop("per_node")
    counters = {k: {nid: snap["counters"].get(f"scheduler.{k}", 0.0)
                    for nid, snap in per_node.items()}
                for k in ("fallback_total", "declined_total", "batches_fired_total",
                          "shed_total", "submitted_total")}
    return {"phase": "soak", "device": dev, "scheduler_devices": run.devices,
            "config": report.pop("config"), "reduced": SOAK_REDUCED,
            "users": "a custody backend's bursty, "
            "sign-dominant withdrawals on a lossy, jittery network with a bounded queue",
            **report, "per_node": counters, "batch_sizes": sizes,
            "success_events": len(run.sigs), "success_events_verified": verified,
            "succeeded_with_signature": len(done & {b for b, _w, _s in run.sigs}),
            "sessions": _session_overlap(trace),
            "trace_events": len(trace["traceEvents"]), "t_start_s": t0,
            "t_end_s": since_start()}


def check_soak(rec: dict) -> None:
    out = rec["outcomes"]
    if not rec["accounting_ok"] or out["pending"]:
        raise AssertionError(f"soak: the books did not close: {out}")
    if (rec["success_events_verified"] != rec["success_events"]
            or rec["succeeded_with_signature"] != out["succeeded"]):
        raise AssertionError(f"soak: {rec['success_events_verified']} of "
                             f"{rec['success_events']} success events verify on the host, "
                             f"{rec['succeeded_with_signature']} of {out['succeeded']} "
                             f"succeeded requests have one")
    for k in ("fallback_total", "declined_total"):
        if any(rec["per_node"][k].values()):
            raise AssertionError(f"soak: scheduler.{k} {rec['per_node'][k]}")
    if rec["scheduler"]["batches_fired"] < 1 or rec["scheduler_devices"] != [rec["device"]]:
        raise AssertionError(f"soak: batches {rec['scheduler']['batches_fired']} on "
                             f"{rec['scheduler_devices']}")


def _ot_host_soak_task(B: int, seed: int, dev: str = "cuda") -> dict:
    """Phases 33, 27 and 35 in phase 19's child, after its lifecycle:
    phase 33 prints its own line, then the soak runs with cluster logs at
    WARNING (its faults log by design), then phase 35. The soak comes
    after the lifecycle and phase 33, where the fewest other lanes share
    the host and the card: its followers fall back to the per-session
    path when a manifest takes longer than twice ``manifest_timeout_s``;
    phase 35 only follows it."""
    global _POOL
    from mpcium_tpu_torch.ops import mulmod as K
    from mpcium_tpu_torch.utils import log

    try:
        run_ot_host(B, seed, K, dev)
    finally:
        if _POOL is not None:  # phase 33's host verifiers
            _POOL.shutdown()
            _POOL = None
    log.init(level="WARNING")
    soak = run_soak_phase(dev)
    return {"soak": soak, "graphs": run_graphs(seed, dev)}


def chaos_soak_finish(chaos: dict, soak: dict, extra: dict) -> None:
    """Print phases 26 and 27 (one line per drill, then each phase's
    line with ``extra``) and hold them to their checks."""
    for row in chaos["drills"]:
        emit({"phase": "chaos_drill", **row})
    emit({**chaos, "drills": [r["drill"] for r in chaos["drills"]], **extra})
    emit({**soak, **extra})
    check_chaos(chaos)
    check_soak(soak)


def join_chaos_soak(chaos: dict, future, t_submit: float) -> None:
    """Wait for phases 27 and 35 (phase 19's worker, after phase 33),
    then finish them with phase 26's record (the goldens' process)."""
    t0 = time.perf_counter()
    res = future.result()
    wait_s = time.perf_counter() - t0
    _LIFECYCLE_POOL.shutdown()
    extra = {"overlapped": True, "join_wait_s": wait_s,
             "since_submit_s": time.perf_counter() - t_submit}
    emit({**res["graphs"], **extra})
    chaos_soak_finish(chaos, res["soak"], extra)
    check_graphs(res["graphs"])


def run_eddsa_dkg(B: int, seed: int, K, dev: str = "cuda") -> None:
    """Three Ed25519 DKG parties (K0's counters zeroed just before, read
    just after: 0), then two EdDSA signing parties sign with the result;
    every signature verified on the host."""
    import numpy as np

    from mpcium_tpu_torch.protocol.batch_dkg import BatchedDKGParty
    from mpcium_tpu_torch.protocol.eddsa.batch_signing import BatchedEDDSASigningParty
    from mpcium_tpu_torch.protocol.runner import run_protocol
    from mpcium_tpu_torch.utils.rng import SeededStream

    sid = f"chip-eddsa-dkg-{seed}"
    dkg = {pid: BatchedDKGParty(sid, pid, UNIVERSE, 1, "ed25519", B,
                                rng=SeededStream(seed + 90 + i), cohorts=COHORTS, device=dev)
           for i, pid in enumerate(UNIVERSE)}
    K.reset_counters()
    dkg_s, dkg_rounds, dkg_phases = _traced(dkg, run_protocol, dev)
    dkg_k0 = _no_k0(K, "the Ed25519 DKG parties")
    quorum = ["node0", "node1"]
    msgs = [r.tobytes() for r in np.random.default_rng(seed + 95).integers(
        0, 256, (B, 32), dtype=np.uint8)]
    signers = {pid: BatchedEDDSASigningParty(f"{sid}-sign", pid, quorum, dkg[pid].result,
                                             msgs, rng=SeededStream(seed + 96 + i),
                                             cohorts=COHORTS, device=dev)
               for i, pid in enumerate(quorum)}
    sign_s, rounds, _phases = _traced(signers, run_protocol, dev)
    res = [signers[p].result for p in quorum]
    t0 = time.perf_counter()
    verified = _host_verified(dkg["node0"].result, msgs, res[0]["signatures"])
    ok_all = all(bool(r["ok"].all()) for r in res)
    emit({"phase": "eddsa_dkg", "B": B, "dkg_wall_s": dkg_s, "dkg_wallets_per_s": B / dkg_s,
          "dkg_seconds_by_round": dkg_rounds, "dkg_seconds_by_phase": dkg_phases,
          "dkg_k0": dkg_k0, "sign_s": sign_s, "sign_seconds_by_round": rounds, "ok_all": ok_all,
          "verified": verified, "host_verify_s": time.perf_counter() - t0})
    if not ok_all or verified != B:
        raise AssertionError(f"EdDSA after DKG: ok/verified failed ({verified}/{B})")


# ---------------------------------------------------------------------------
# the per-session protocols: one wallet per session, host python ints,
# and the batched sign on the card of the wallets they make
# ---------------------------------------------------------------------------

# secp256k1 wallets made and rotated per session, one pool task each: 2,
# not 4 as through PR 12 (each takes some 200 s of host python, and the
# host is shared with every other lane)
SESSION_W = 2
SESSION_ED_W = 64  # ed25519 wallets made per session
SESSION_ED_ROTATE = 8  # of them rotated per session

_SESSION_POOL = None


def _session_wallet(w: int, seed: int) -> dict:
    """A task of the session pool, host only: a 2-of-3 ECDSAKeygenParty
    over node0–node2 on the 2048-bit fixture, an ECDSASigningParty sign
    by node0 + node1, a ResharingParty rotation from node0 + node1 to
    node0–node2 (t=1, epoch 1) and a sign by node1 + node2. Both
    signatures verified on the host against the keygen's public key."""
    import hashlib

    from mpcium_tpu_torch.cluster import load_test_preparams
    from mpcium_tpu_torch.core import hostmath as hm
    from mpcium_tpu_torch.protocol.ecdsa.keygen import ECDSAKeygenParty
    from mpcium_tpu_torch.protocol.ecdsa.signing import ECDSASigningParty
    from mpcium_tpu_torch.protocol.resharing import ResharingParty
    from mpcium_tpu_torch.protocol.runner import run_protocol
    from mpcium_tpu_torch.utils.rng import SeededStream

    pre = load_test_preparams(2048)
    sid, s0 = f"chip-session-{seed}-{w}", 1000 * seed + 100 * w
    walls: dict = {}

    def timed(name, parties):
        t0 = time.perf_counter()
        run_protocol(parties)
        walls[name] = time.perf_counter() - t0
        return {pid: p.result for pid, p in parties.items()}

    shares = timed("keygen_s", {pid: ECDSAKeygenParty(f"{sid}-kg", pid, UNIVERSE, 1, pre[pid],
                                                      rng=SeededStream(s0 + i))
                                for i, pid in enumerate(UNIVERSE)})
    pub = hm.secp_decompress(shares["node0"].public_key)

    def sign(tag, quorum, held, k):
        digest = int.from_bytes(hashlib.sha256(f"{sid}-{tag}".encode()).digest(), "big")
        res = timed(f"{tag}_s", {pid: ECDSASigningParty(f"{sid}-{tag}", pid, quorum, held[pid],
                                                        digest, rng=SeededStream(s0 + k + i))
                                 for i, pid in enumerate(quorum)})
        sig = res[quorum[0]]
        return {"quorum": quorum, "r": hex(sig["r"]), "s": hex(sig["s"]),
                "parties_agree": all(r == sig for r in res.values()),
                "verified": hm.ecdsa_verify(pub, digest % hm.SECP_N, sig["r"], sig["s"])}

    first = sign("sign", ["node0", "node1"], shares, 10)
    old = ["node0", "node1"]
    new = timed("reshare_s", {
        pid: ResharingParty(f"{sid}-rs", pid, "secp256k1", old, UNIVERSE, 1,
                            old_share=shares[pid] if pid in old else None, preparams=pre[pid],
                            old_public_key=shares["node0"].public_key,
                            old_vss_commitments=shares["node0"].vss_commitments,
                            rng=SeededStream(s0 + 20 + i))
        for i, pid in enumerate(UNIVERSE)})
    second = sign("sign_after_reshare", ["node1", "node2"], new, 30)
    return {"wallet": w, "walls_s": walls, "signatures": [first, second],
            "kept_at_epoch_1": all(s.public_key == shares["node0"].public_key and s.epoch == 1
                                   for s in new.values()),
            "epoch1_shares": {pid: s.to_json() for pid, s in new.items()}}


def start_session_ecdsa(seed: int):
    """Submit the SESSION_W wallet tasks to a spawned pool of their own,
    niced so the main process's host work keeps priority; the GPU phases
    run while they do."""
    global _SESSION_POOL
    _SESSION_POOL = spawned_pool(SESSION_W)
    return [_SESSION_POOL.submit(_session_wallet, w, seed) for w in range(SESSION_W)], \
        time.perf_counter()


def join_session_ecdsa(futures, t_submit: float) -> list:
    """Wait for the wallet tasks → their records; the phase fails unless
    every signature verified and every rotation kept its key."""
    t0 = time.perf_counter()
    recs = [f.result() for f in futures]
    wait_s = time.perf_counter() - t0
    _SESSION_POOL.shutdown()
    ok = all(r["kept_at_epoch_1"] and all(s["verified"] and s["parties_agree"]
                                          for s in r["signatures"]) for r in recs)
    emit({"phase": "session_ecdsa", "wallets": SESSION_W, "scheme": "2-of-3 secp256k1 GG18",
          "fixture": "test_preparams.json (2048-bit)", "overlapped": True,
          "join_wait_s": wait_s, "since_submit_s": time.perf_counter() - t_submit,
          "walls_s": [r["walls_s"] for r in recs],
          "verified": sum(s["verified"] for r in recs for s in r["signatures"]),
          "kept_at_epoch_1": all(r["kept_at_epoch_1"] for r in recs)})
    if not ok:
        raise AssertionError("session ECDSA: a signature failed or a rotation moved a key")
    return recs


def run_session_batch_sign(recs, seed: int, K, dev: str = "cuda") -> dict:
    """The per-session epoch-1 wallets signed as one batch by node1 and
    node2 with BatchedECDSASigningParty (full Domains()), K0's counters
    zeroed just before: both entries launch, no plain version runs."""
    import numpy as np

    from mpcium_tpu_torch.protocol.base import KeygenShare
    from mpcium_tpu_torch.protocol.ecdsa.batch_signing import quorum_material_digest
    from mpcium_tpu_torch.protocol.runner import run_protocol

    quorum = ["node1", "node2"]
    shares = {pid: [KeygenShare.from_json(r["epoch1_shares"][pid]) for r in recs]
              for pid in UNIVERSE}
    # the scheduler's admission test: one non-empty material digest
    material = {pid: sorted({quorum_material_digest(s) for s in shares[pid]}) for pid in quorum}
    admitted = all(len(d) == 1 and d[0] != "" for d in material.values())
    if not admitted:
        raise AssertionError(f"per-session wallets differ in material: {material}")
    digests = [r.tobytes() for r in np.random.default_rng(seed + 110).integers(
        0, 256, (len(recs), 32), dtype=np.uint8)]
    out, k0 = _party_sign(f"chip-session-batch-{seed}", quorum, shares, digests, seed + 111, K,
                          run_protocol, dev)
    emit({"phase": "session_batch_sign", "B": len(recs), "domains": "Domains()",
          "cohorts": COHORTS, "material_digest_equal": admitted, **out})
    if not k0["launches"] or not k0["mulmod_by_width"] or not k0["powmod_by_mode_width"]:
        raise AssertionError(f"the batched sign of per-session wallets missed K0: {k0}")
    if k0["plain_calls"]:
        raise AssertionError(f"a plain version ran {k0['plain_calls']}x on the card")
    return k0


def run_session_eddsa(seed: int, dev: str = "cuda") -> None:
    """SESSION_ED_W ed25519 wallets by EDDSAKeygenParty (2-of-3), each
    signed per session with the challenge on hashlib and on the card's
    SHA-512 (equal bytes), SESSION_ED_ROTATE of them rotated by
    ResharingParty and signed again, all of them signed as one batch by
    BatchedEDDSASigningParty on the card, and the JAX party golden
    replayed with the device hash on."""
    import numpy as np

    from mpcium_tpu_torch.protocol.eddsa.batch_signing import BatchedEDDSASigningParty
    from mpcium_tpu_torch.protocol.eddsa.keygen import EDDSAKeygenParty
    from mpcium_tpu_torch.protocol.eddsa.signing import ENV_DEVICE_HASH, EDDSASigningParty
    from mpcium_tpu_torch.protocol.resharing import ResharingParty
    from mpcium_tpu_torch.protocol.runner import run_protocol
    from mpcium_tpu_torch.utils import session_golden as sgo
    from mpcium_tpu_torch.utils.rng import SeededStream

    sid, W, s0 = f"chip-session-eddsa-{seed}", SESSION_ED_W, 100_000 * seed
    walls: dict = {}

    def runs(name, make_all):
        t0 = time.perf_counter()
        out = []
        for parties in make_all():
            run_protocol(parties)
            out.append({pid: p.result for pid, p in parties.items()})
        walls[name] = time.perf_counter() - t0
        return out

    wallets = runs("keygen_s", lambda: (
        {pid: EDDSAKeygenParty(f"{sid}-kg-{w}", pid, UNIVERSE, 1, rng=SeededStream(s0 + 10 * w + i))
         for i, pid in enumerate(UNIVERSE)} for w in range(W)))
    msgs = [r.tobytes() for r in np.random.default_rng(seed + 120).integers(
        0, 256, (W, 32), dtype=np.uint8)]

    def sign_each(name, quorum, held, which, device_hash: bool, s1: int):
        os.environ[ENV_DEVICE_HASH] = "1" if device_hash else "0"
        try:
            res = runs(name, lambda: (
                {pid: EDDSASigningParty(f"{sid}-sign-{w}", pid, quorum, held[w][pid], msgs[w],
                                        rng=SeededStream(s1 + 10 * w + i), device=dev)
                 for i, pid in enumerate(quorum)} for w in which))
        finally:
            os.environ.pop(ENV_DEVICE_HASH, None)
        if any(len(set(r.values())) != 1 for r in res):
            raise AssertionError(f"session EdDSA {name}: the signers disagree")
        return [r[quorum[0]] for r in res]

    every = range(W)
    pubs = [wl["node0"].public_key for wl in wallets]
    host_sigs = sign_each("sign_hashlib_s", ["node0", "node1"], wallets, every, False, s0 + 5000)
    dev_sigs = sign_each("sign_device_hash_s", ["node0", "node1"], wallets, every, True,
                         s0 + 5000)
    rotated = list(range(SESSION_ED_ROTATE))
    old = ["node0", "node1"]
    new = runs("reshare_s", lambda: (
        {pid: ResharingParty(f"{sid}-rs-{w}", pid, "ed25519", old, UNIVERSE, 1,
                             old_share=wallets[w][pid] if pid in old else None,
                             old_public_key=pubs[w],
                             old_vss_commitments=wallets[w]["node0"].vss_commitments,
                             rng=SeededStream(s0 + 8000 + 10 * w + i))
         for i, pid in enumerate(UNIVERSE)} for w in rotated))
    current = [dict(wl) for wl in wallets]
    for w, shares in zip(rotated, new):
        current[w] = shares
    rot_sigs = sign_each("sign_after_reshare_s", ["node1", "node2"], current, rotated, True,
                         s0 + 7000)
    quorum = ["node0", "node2"]
    batch = {pid: BatchedEDDSASigningParty(f"{sid}-batch", pid, quorum,
                                           [c[pid] for c in current], msgs,
                                           rng=SeededStream(s0 + 9000 + i), cohorts=COHORTS,
                                           device=dev)
             for i, pid in enumerate(quorum)}
    batch_s, _rounds, _phases = _traced(batch, run_protocol, dev)
    res = [batch[p].result for p in quorum]
    batch_ok = all(bool(r["ok"].all()) for r in res) and \
        bool(np.array_equal(res[0]["signatures"], res[1]["signatures"]))
    os.environ[ENV_DEVICE_HASH] = "1"
    try:
        t0 = time.perf_counter()
        got = sgo.eddsa_record(EDDSAKeygenParty, EDDSASigningParty, ResharingParty,
                               restore=True, device=dev)
        walls["golden_s"] = time.perf_counter() - t0
    finally:
        os.environ.pop(ENV_DEVICE_HASH, None)
    want = json.loads((GOLDENS / "session_eddsa.json").read_text())["record"]
    t0 = time.perf_counter()
    verified = {
        "hashlib": verify_ed25519(pubs, msgs, host_sigs),
        "device_hash": verify_ed25519(pubs, msgs, dev_sigs),
        "after_reshare": verify_ed25519([pubs[w] for w in rotated], [msgs[w] for w in rotated],
                                        rot_sigs),
        "batched": verify_ed25519(pubs, msgs, res[0]["signatures"]),
    }
    kept = all(s.public_key == pubs[w] and s.epoch == 1 for w, shares in zip(rotated, new)
               for s in shares.values())
    out = {"phase": "session_eddsa", "wallets": W, "rotated": len(rotated),
           "walls_s": walls, "batched_sign_s": batch_s,
           "device_hash_equals_hashlib": host_sigs == dev_sigs, "verified": verified,
           "kept_at_epoch_1": kept, "batch_ok_all": batch_ok,
           "matches_jax_golden": got == want, "host_verify_s": time.perf_counter() - t0}
    emit(out)
    expected = {"hashlib": W, "device_hash": W, "after_reshare": len(rotated), "batched": W}
    if not (out["device_hash_equals_hashlib"] and verified == expected and kept and batch_ok
            and out["matches_jax_golden"]):
        raise AssertionError(f"session EdDSA failed: {out}")


# ---------------------------------------------------------------------------
# phase 24: the serving path — a LocalCluster of three nodes over loopback
# ---------------------------------------------------------------------------

SERVING_W = 64  # wallets created and signed per curve
SERVING_WINDOW_S = 10.0


# A card deployment's cluster settings. The leader cuts its manifest when
# the batch window closes, after every node has taken in the whole burst: a
# manifest that overtakes a follower's intake of one of its requests strands
# that request's claim (the scheduler's late-intake path, ported as it is),
# so the window outlasts the burst's intake (measured per stage) and
# max_batch stays above the burst. A full-width batch runs for minutes: the
# bridge's reply wait, the deputy's manifest timeout and the per-request
# deadline outlast one.
SERVING_CFG = {"batch_max_batch": 1024, "batch_window_s": SERVING_WINDOW_S,
               "batch_manifest_timeout_s": 300.0, "batch_deadline_ms": 900_000,
               "reply_timeout_s": 900.0, "hello_timeout_s": 20.0}


class _CryptoClock:
    """Thread-seconds spent in the host crypto of the serving path:
    Ed25519 on envelopes, manifests and initiator commands ("envelope"),
    ChaCha20-Poly1305 sealing of shares and WALs ("store"). Installed by
    wrapping those methods for the phase; the wrappers time and forward."""

    def __init__(self):
        import threading

        self.lock = threading.Lock()
        self.s = {"envelope": 0.0, "store": 0.0}
        self.undo = []

    def wrap(self, cls, name: str, bucket: str) -> None:
        orig = getattr(cls, name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                with self.lock:
                    self.s[bucket] += time.perf_counter() - t0

        setattr(cls, name, timed)
        self.undo.append((cls, name, orig))

    def take(self) -> dict:
        with self.lock:
            out, self.s = dict(self.s), {"envelope": 0.0, "store": 0.0}
        return out

    def remove(self) -> None:
        for cls, name, orig in reversed(self.undo):
            setattr(cls, name, orig)


def _settle(cluster, t_limit: float = 120.0) -> float:
    """Wait until no node holds a request claim (every node has persisted
    its shares and answered) → seconds waited; fails on a stranded claim."""
    t0 = time.perf_counter()
    while any(ec._sessions for ec in cluster.consumers):
        if time.perf_counter() - t0 > t_limit:
            raise AssertionError(f"serving: claims still held: "
                                 f"{[sorted(ec._sessions)[:4] for ec in cluster.consumers]}")
        time.sleep(0.05)
    return time.perf_counter() - t0


def _burst(subscribe, fire, key, n: int, what: str, intake=None, t_limit: float = 900.0):
    """Subscribe to a result queue, fire the burst, wait for n results →
    (results by key, wall s from the first submit to the last result,
    the submit time, the arrival time of each result). ``intake`` (a
    callable polled while waiting) records when each node has taken in
    the burst."""
    import threading

    got, done, lock = {}, threading.Event(), threading.Lock()
    t_last = {}

    def on(ev):
        with lock:
            got[key(ev)] = ev
            t_last[key(ev)] = time.perf_counter()
            if len(got) >= n:
                done.set()

    sub = subscribe(on)
    try:
        t0 = time.perf_counter()
        fire()
        while not done.wait(0.05):
            if intake is not None:
                intake(t0)
            if time.perf_counter() - t0 > t_limit:
                raise AssertionError(f"serving {what}: {len(got)}/{n} results in {t_limit} s")
    finally:
        sub.unsubscribe()
    return got, max(t_last.values()) - t0, t0, t_last


def serving_run(W: int, seed: int, K, dev: str = "cuda") -> dict:
    """Phase 24's cluster work: LocalCluster(3 nodes, t=1, batch_signing,
    device=dev) on the 2048-bit fixture, full Domains(); through the
    client W wallets created (one kg batch: both curves), then W ECDSA
    and W EdDSA signs (phase 25 rotates and signs again, across
    processes). Fails unless every result succeeds, K0 reads 0 around
    create and shows launches of both entries at both widths and every
    powmod mode (no plain call) around the signs, every stage grows each node's batches by what it
    needs, its dispatches add up to its burst, no scheduler declines a
    request and no session fails or runs outside a batch. → the phase
    record and the signatures,
    which :func:`serving_finish` verifies on the host."""
    import numpy as np

    from mpcium_tpu_torch import wire
    from mpcium_tpu_torch.cluster import LocalCluster, load_test_preparams
    from mpcium_tpu_torch.identity import identity
    from mpcium_tpu_torch.identity.identity import IdentityStore, InitiatorKey
    from mpcium_tpu_torch.store.kvstore import EncryptedFileKV
    from mpcium_tpu_torch.utils import log, tracing

    log.init(level="WARNING")  # a line per request and session would bury the output
    clock = _CryptoClock()
    for name in ("sign_envelope", "verify_envelope", "sign_raw", "verify_peer",
                 "verify_initiator"):
        clock.wrap(IdentityStore, name, "envelope")
    clock.wrap(InitiatorKey, "sign", "envelope")
    for name in ("_seal", "_open"):
        clock.wrap(EncryptedFileKV, name, "store")
    spans: list = []
    root = ROOT / "build" / f"serving-{seed}-{os.getpid()}"
    t_up = time.perf_counter()
    cluster = LocalCluster(n_nodes=3, threshold=1, root_dir=str(root),
                           preparams=load_test_preparams(2048), batch_signing=True,
                           device=dev, **SERVING_CFG)
    up_s = time.perf_counter() - t_up
    # the phase's own sink in place of the flight recorder the cluster armed
    tracing.enable(spans.append)
    stages, checks = {}, {}
    try:
        client = cluster.client
        wallets = [f"chip-serving-{seed}-{w}" for w in range(W)]

        def batches():
            return {nid: ec.scheduler.batches_run for nid, ec in cluster.node_consumers.items()}

        def counter(name):
            return {nid: ec.metrics.counter(f"scheduler.{name}").value
                    for nid, ec in cluster.node_consumers.items()}

        def stage(name, subscribe, fire, key, n, kind, want_batches, k0_zero):
            b0, s0, taken_in = batches(), counter("submitted_total"), {}
            d0 = counter("declined_total")

            def intake(t0):
                for nid, v in counter("submitted_total").items():
                    if nid not in taken_in and v - s0[nid] >= n:
                        taken_in[nid] = time.perf_counter() - t0

            clock.take()
            del spans[:]
            K.reset_counters()
            got, wall, t0, t_last = _burst(subscribe, fire, key, n, name, intake)
            k0 = _k0_counts(K)
            settle_s = _settle(cluster)
            crypto = clock.take()
            grown = {nid: v - b0[nid] for nid, v in batches().items()}
            declined = {nid: v - d0[nid] for nid, v in counter("declined_total").items()}
            rounds, phases, sizes, failed, single = {}, {}, [], [], []
            for sp in list(spans):
                nm = sp["name"]
                if nm == "dispatch":
                    sizes.append((sp["attrs"].get("req_kind"), sp["attrs"].get("n")))
                if nm == "session" and sp["attrs"].get("outcome") != "ok":
                    failed.append((sp["tid"], sp["node"], sp["attrs"].get("error")))
                if nm == "session" and not sp["tid"].startswith(("bdkg:", "brs:", "bsign:")):
                    single.append((sp["tid"], sp["node"]))
                into = rounds if nm.startswith("round:") else phases if nm.startswith(
                    "phase:") else None
                if into is not None:
                    into[nm] = into.get(nm, 0.0) + (sp["t1_ns"] - sp["t0_ns"]) / 1e9
            stages[name] = rec = {
                "wall_s": wall, "t_end_s": since_start(), "settle_s": settle_s,
                "results": len(got),
                "intake_s_by_node": taken_in, "batches_by_node": grown,
                "batch_sizes": sorted(sizes), "failed_sessions": failed,
                "declined_by_node": declined, "per_session_runs": single,
                "envelope_crypto_s": crypto["envelope"], "store_crypto_s": crypto["store"],
                "seconds_by_round_all_nodes": rounds, "seconds_by_phase_all_nodes": phases,
                "k0": _no_k0(K, f"serving {name}") if k0_zero else _k0_json(k0)}
            if failed or any(g != want_batches for g in grown.values()):
                raise AssertionError(f"serving {name}: batches {grown} (want {want_batches} "
                                     f"per node), failed sessions {failed}: {rec}")
            # every request of the burst went through a batch of its kind:
            # none declined by a scheduler or run down the per-session path
            # on the host (those paths sign correctly without the card)
            if (any(declined.values()) or single or {k for k, _ in sizes} != {kind}
                    or sum(b for _, b in sizes) != n):
                raise AssertionError(f"serving {name}: not all {n} requests were batched as "
                                     f"{kind!r}: dispatched {sizes}, declined {declined}, "
                                     f"per-session runs {single[:4]}")
            return got, k0, t0, t_last

        kg, _, _, _ = stage(
            "create", client.on_wallet_creation_result,
            lambda: [client.create_wallet(w) for w in wallets],
            lambda ev: ev.wallet_id, W, "kg", 1, True)
        bad = [w for w, ev in kg.items() if ev.result_type != wire.RESULT_SUCCESS]
        if bad:
            raise AssertionError(f"serving create failed: {kg[bad[0]].error_reason}")
        secp_pubs = [bytes.fromhex(kg[w].ecdsa_pub_key) for w in wallets]
        ed_pubs = [bytes.fromhex(kg[w].eddsa_pub_key) for w in wallets]
        stages["create"]["wallets_per_s"] = W / stages["create"]["wall_s"]
        drng = np.random.default_rng(seed + 240)

        def sign_stage(name, tag):
            digests = [r.tobytes() for r in drng.integers(0, 256, (W, 32), dtype=np.uint8)]
            msgs = [r.tobytes() for r in drng.integers(0, 256, (W, 32), dtype=np.uint8)]

            def fire():
                for i, w in enumerate(wallets):
                    client.sign_transaction(wire.SignTxMessage(
                        "secp256k1", w, "eth", f"{tag}-ecdsa-{i}", digests[i]))
                for i, w in enumerate(wallets):
                    client.sign_transaction(wire.SignTxMessage(
                        "ed25519", w, "sol", f"{tag}-eddsa-{i}", msgs[i]))

            got, k0, t0, t_last = stage(name, client.on_sign_result, fire,
                                        lambda ev: ev.tx_id, 2 * W, "sign", 2, False)
            ec = [got[f"{tag}-ecdsa-{i}"] for i in range(W)]
            ed = [got[f"{tag}-eddsa-{i}"] for i in range(W)]
            bad = [e for e in ec + ed if e.result_type != wire.RESULT_SUCCESS]
            if bad:
                raise AssertionError(f"serving {name}: {bad[0].tx_id}: {bad[0].error_reason}")
            rec = stages[name]
            rec["ecdsa_wall_s"] = max(t_last[f"{tag}-ecdsa-{i}"] for i in range(W)) - t0
            rec["eddsa_wall_s"] = max(t_last[f"{tag}-eddsa-{i}"] for i in range(W)) - t0
            rec["ecdsa_sigs_per_s"] = W / rec["ecdsa_wall_s"]
            rec["eddsa_sigs_per_s"] = W / rec["eddsa_wall_s"]
            checks[name] = {"secp_pubs": secp_pubs, "digests": digests,
                            "r": [bytes.fromhex(e.r) for e in ec],
                            "s": [bytes.fromhex(e.s) for e in ec],
                            "ed_pubs": ed_pubs, "msgs": msgs,
                            "sigs": [bytes.fromhex(e.signature) for e in ed]}
            for n in (320, 608):
                if k0["mulmod_by_width"].get(n, 0) == 0:
                    raise AssertionError(f"serving {name}: no mulmod launch at width {n}")
            for key in POWMOD_PATH:
                if k0["powmod_by_mode_width"].get(key, 0) == 0:
                    raise AssertionError(f"serving {name}: no powmod launch of {key}")
            if k0["plain_calls"]:
                raise AssertionError(f"serving {name}: a plain version ran {k0['plain_calls']}x")
            return k0

        k0_sign = sign_stage("sign", "s1")
        health = cluster.health()
        counters = {nid: {k: h["metrics"]["counters"].get(f"scheduler.{k}", 0.0)
                          for k in ("fallback_total", "shed_total", "quarantined_total",
                                    "declined_total",
                                    "deputy_takeover_total", "batches_fired_total",
                                    "submitted_total")}
                    for nid, h in health.items()}
        if any(c["fallback_total"] or c["shed_total"] or c["quarantined_total"]
               or c["declined_total"] for c in counters.values()):
            raise AssertionError(f"serving: the scheduler fell back, shed, quarantined or "
                                 f"declined: {counters}")
        reduced = {"SERVING_W": f"{W}: every batched party's cost is fixed per batch "
                   "(DLN proofs, comb tables) and the B=1,024 batches of the same "
                   "parties are measured in phases 13, 14 and 19; the host crypto of "
                   "intake and share storage grows with W",
                   "depth": "create -> sign: the reshare and the second sign run across "
                   "processes in phase 25 (deployment), which overlaps this phase inside "
                   "the script's time limit"}
        record = {
            "phase": "serving", "nodes": cluster.node_ids, "threshold": 1, "wallets": W,
            "fixture": "test_preparams.json (2048-bit)", "domains": "Domains()",
            "min_paillier_bits": 2046, "device": str(cluster.device),
            "host_crypto": ("openssl (cryptography)"
                            if identity.Ed25519PrivateKey.__module__.startswith("cryptography")
                            else "softcrypto"),
            "cluster_settings": SERVING_CFG, "cluster_up_s": up_s, "scheduler": counters,
            "k0_sign": _k0_json(k0_sign), "reduced": reduced}
        return {"record": record, "stages": stages, "checks": checks}
    finally:
        tracing.disable()
        clock.remove()
        cluster.close()
        shutil.rmtree(root, ignore_errors=True)


def serving_finish(res: dict, extra: dict, phase: str = "serving") -> None:
    """Verify every signature of phase 24 (or 25: ``phase``) on the host
    pool, print a line per stage and the phase line; fail unless all
    verify."""
    verified = {}
    for name, c in res["checks"].items():
        th = time.perf_counter()
        v_ec = verify_ecdsa(c["secp_pubs"], c["digests"], c["r"], c["s"])
        v_ed = verify_ed25519(c["ed_pubs"], c["msgs"], c["sigs"])
        res["stages"][name].update({"verified_ecdsa": v_ec, "verified_eddsa": v_ed,
                                    "host_verify_s": time.perf_counter() - th})
        verified[name] = (v_ec, v_ed, len(c["r"]), len(c["sigs"]))
    for name, rec in res["stages"].items():
        emit({"phase": f"{phase}_stage", "stage": name, **rec})
    emit({**res["record"], **extra,
          "stage_walls_s": {k: v["wall_s"] for k, v in res["stages"].items()}})
    bad = {k: v for k, v in verified.items() if v[0] != v[2] or v[1] != v[3]}
    if bad:
        raise AssertionError(f"{phase}: signatures failed host verification: {bad}")


_SERVING_POOL = None


def _serving_task(W: int, seed: int, gg18_rows: bool = True) -> dict:
    """Phase 24 in a process of its own (the card is shared with the main
    process, which keeps its own K0 counters), then phase 36's rows at B
    = 1 and 16 there: the serving lane ends first."""
    import torch

    from mpcium_tpu_torch.ops import mulmod as K

    torch.backends.cuda.matmul.allow_tf32 = False
    K.build()
    t0, t_start = time.perf_counter(), since_start()
    res = serving_run(W, seed, K)
    res["record"].update(phase_s=time.perf_counter() - t0, t_start_s=t_start,
                         t_end_s=since_start())
    if gg18_rows:
        res["gg18_rows"] = gg18_graph_rows(seed, bs=(1, 16))
    return res


def start_serving(W: int, seed: int):
    """Start phase 24 on a spawned process, niced so the main process
    keeps priority; it overlaps the phases after the kernel timings."""
    global _SERVING_POOL
    _SERVING_POOL = spawned_pool()
    return _SERVING_POOL.submit(_serving_task, W, seed), time.perf_counter()


def join_serving(future, t_submit: float) -> dict:
    t0 = time.perf_counter()
    res = future.result()
    wait_s = time.perf_counter() - t0
    _SERVING_POOL.shutdown()
    extra = {"overlapped": True, "join_wait_s": wait_s,
             "since_submit_s": time.perf_counter() - t_submit}
    serving_finish(res, extra)
    res["extra"] = extra
    return res


# ---------------------------------------------------------------------------
# phase 25: the networked deployment — a broker and three daemon processes
# ---------------------------------------------------------------------------

DEPLOY_W = 64  # wallets created, signed, rotated and signed again per curve
# the daemons' batching settings: phase 24's (SERVING_CFG) as config keys,
# and a warm pass at boot over the EdDSA buckets up to 4
DEPLOY_WARM = {"warm_enabled": True, "warm_schemes": "eddsa", "warm_max_b": 4}
DEPLOY_CFG = {**{k: v for k, v in SERVING_CFG.items() if k != "hello_timeout_s"}, **DEPLOY_WARM}
HEALTH_KEYS = ("fallback_total", "shed_total", "quarantined_total", "declined_total",
               "batches_fired_total", "submitted_total")


def _health_delta(h0: dict, h1: dict) -> dict:
    """Per node: batches run, batches fired and requests dispatched as
    leader, the scheduler counters, and K0's gauges, grown between two
    health snapshots."""
    out = {}
    for nid, s1 in h1.items():
        s0 = h0[nid]

        def grew(kind, name, s0=s0, s1=s1):
            return s1["metrics"][kind].get(name, 0.0) - s0["metrics"][kind].get(name, 0.0)

        def disp(s):
            return (s["metrics"]["histograms"].get("scheduler.dispatch_age_s") or {}).get("count", 0)

        k0 = {g[3:]: grew("gauges", g) for g in s1["metrics"]["gauges"] if g.startswith("k0.")}
        out[nid] = {"batches_run": s1.get("batches_run", 0) - s0.get("batches_run", 0),
                    "dispatched": disp(s1) - disp(s0),
                    **{k: grew("counters", f"scheduler.{k}") for k in HEALTH_KEYS},
                    "k0": {k: v for k, v in k0.items() if v}}
    return out


def _warm_report(node_db: Path) -> dict:
    """A daemon's boot-time warm report (``WARM_MANIFEST.json`` in its
    warm directory): totals, the devices it ran on, seconds per entry."""
    from mpcium_tpu_torch.warm import manifest as wm
    from mpcium_tpu_torch.warm.prewarm import default_cache_dir

    rep = json.loads((Path(default_cache_dir(str(node_db))) / wm.REPORT_BASENAME).read_text())
    return {"totals": rep["totals"], "budget_s": rep["budget_s"],
            "devices": sorted({r["device"] for r in rep["results"]}),
            "warm_s": {r["shape"]: r.get("warm_s") for r in rep["results"]}}


def deployment_run(W: int, seed: int, dev=None, root: Path = None) -> dict:
    """Phase 25's work: a broker and three daemons (``Deployment``, the
    phase 24 batching settings, ``reply_timeout_s`` 900); through
    ``RemoteCluster`` W wallets created in one burst, W ECDSA + W EdDSA
    signs, a reshare of all W on both curves (t=1, epoch 1) and W + W signs
    again. Fails unless every result succeeds with no timeout and no dead
    letter, each stage's dispatches add up to its burst with the batches
    it needs on every node, no scheduler falls back, sheds, quarantines or
    declines, K0's gauges grow on every node across each sign stage (both
    entries at both widths, every powmod mode of the path) with no plain
    call and stay put around create and reshare, the compile section reads
    ready with the K0 build and the EdDSA and GG18 graphs' captures (no
    other entry; both families captured), node0's flight recorder is
    valid Chrome JSON,
    and every process exits 0 on SIGTERM within 30 s. On the CPU
    (``dev="cpu"``, a rehearsal) the signs must reach K0's plain versions
    and never the kernel, and no build is ledgered. → the phase record and
    the signatures, which :func:`serving_finish` verifies on the host."""
    import numpy as np

    from mpcium_tpu_torch import wire
    from mpcium_tpu_torch.cli.deployment import Deployment
    from mpcium_tpu_torch.node.daemon import TRACE_DUMP
    from mpcium_tpu_torch.store.broker_kv import BrokerKV
    from mpcium_tpu_torch.store.keyinfo import KeyinfoStore
    from mpcium_tpu_torch.trace import validate_chrome
    from mpcium_tpu_torch.utils import log

    log.init(level="WARNING")  # the client logs a line per request
    root = Path(root or ROOT / "build" / f"deployment-{seed}-{os.getpid()}")
    on_card = dev is None
    dep = Deployment(root, dev=dev, cfg=DEPLOY_CFG)
    rc = None
    stages, checks, dead = {}, {}, []
    try:
        up = dep.start()
        rc = dep.remote()
        client = rc.client
        rc.transport.set_dead_letter_handler(lambda topic, data, n: dead.append((topic, n)))
        kv = BrokerKV(rc.transport.client)
        h = dep.health(kv, time.time())
        wallets = [f"chip-deploy-{seed}-{w}" for w in range(W)]

        def stage(name, subscribe, fire, key, n, want_batches, sign):
            nonlocal h
            got, wall, t0, t_last = _burst(subscribe, fire, key, n, name)
            t_res = time.time()
            h1 = dep.health(kv, t_res)
            delta = _health_delta(h, h1)
            h = h1
            timeouts = [k for k, ev in got.items() if getattr(ev, "is_timeout", False)]
            stages[name] = rec = {
                "wall_s": wall, "t_end_s": since_start(), "results": len(got), "by_node": delta,
                "batch_sizes": sorted({d["dispatched"] / d["batches_fired_total"]
                                       for d in delta.values() if d["batches_fired_total"]}),
                "dead_letters": list(dead), "timeouts": timeouts}
            bad = {nid: d for nid, d in delta.items()
                   if d["batches_run"] != want_batches or d["fallback_total"] or d["shed_total"]
                   or d["quarantined_total"] or d["declined_total"]
                   or (not sign and d["k0"])}
            if (bad or dead or timeouts or sum(d["dispatched"] for d in delta.values()) != n
                    or sum(d["batches_fired_total"] for d in delta.values()) != want_batches):
                raise AssertionError(f"deployment {name}: {rec}")
            need = [f"mulmod_launches.n{w}" for w in (320, 608)] + [
                f"powmod_launches.{m}_n{w}" for m, w in POWMOD_PATH]
            for nid, d in delta.items():
                k0 = d["k0"]
                if sign and (([g for g in need if not k0.get(g)] or k0.get("plain_calls"))
                             if on_card else (not k0.get("plain_calls") or len(k0) > 1)):
                    raise AssertionError(f"deployment {name}: {nid}'s K0 gauges {k0}")
            return got, t0, t_last

        kg, _, _ = stage("create", client.on_wallet_creation_result,
                         lambda: [client.create_wallet(w) for w in wallets],
                         lambda ev: ev.wallet_id, W, 1, False)
        bad = [w for w, ev in kg.items() if ev.result_type != wire.RESULT_SUCCESS]
        if bad:
            raise AssertionError(f"deployment create failed: {kg[bad[0]].error_reason}")
        secp_pubs = [bytes.fromhex(kg[w].ecdsa_pub_key) for w in wallets]
        ed_pubs = [bytes.fromhex(kg[w].eddsa_pub_key) for w in wallets]
        drng = np.random.default_rng(seed + 250)

        def sign_stage(name, tag):
            digests = [r.tobytes() for r in drng.integers(0, 256, (W, 32), dtype=np.uint8)]
            msgs = [r.tobytes() for r in drng.integers(0, 256, (W, 32), dtype=np.uint8)]

            def fire():
                for i, w in enumerate(wallets):
                    client.sign_transaction(wire.SignTxMessage(
                        "secp256k1", w, "eth", f"{tag}-ecdsa-{i}", digests[i]))
                for i, w in enumerate(wallets):
                    client.sign_transaction(wire.SignTxMessage(
                        "ed25519", w, "sol", f"{tag}-eddsa-{i}", msgs[i]))

            got, t0, t_last = stage(name, client.on_sign_result, fire, lambda ev: ev.tx_id,
                                    2 * W, 2, True)
            ec = [got[f"{tag}-ecdsa-{i}"] for i in range(W)]
            ed = [got[f"{tag}-eddsa-{i}"] for i in range(W)]
            bad = [e for e in ec + ed if e.result_type != wire.RESULT_SUCCESS]
            if bad:
                raise AssertionError(f"deployment {name}: {bad[0].tx_id}: {bad[0].error_reason}")
            rec = stages[name]
            rec["ecdsa_wall_s"] = max(t_last[f"{tag}-ecdsa-{i}"] for i in range(W)) - t0
            rec["eddsa_wall_s"] = max(t_last[f"{tag}-eddsa-{i}"] for i in range(W)) - t0
            checks[name] = {"secp_pubs": secp_pubs, "digests": digests,
                            "r": [bytes.fromhex(e.r) for e in ec],
                            "s": [bytes.fromhex(e.s) for e in ec],
                            "ed_pubs": ed_pubs, "msgs": msgs,
                            "sigs": [bytes.fromhex(e.signature) for e in ed]}

        sign_stage("sign", "s1")
        rs, _, _ = stage("reshare", client.on_resharing_result,
                         lambda: [client.resharing(w, 1, kt) for kt in ("secp256k1", "ed25519")
                                  for w in wallets],
                         lambda ev: (ev.wallet_id, ev.key_type), 2 * W, 2, False)
        pubs = {"secp256k1": secp_pubs, "ed25519": ed_pubs}
        bad = [k for k, ev in rs.items() if ev.result_type != wire.RESULT_SUCCESS
               or bytes.fromhex(ev.pub_key) != pubs[k[1]][wallets.index(k[0])]]
        if bad:
            raise AssertionError(f"deployment reshare: {bad[0]}: {rs[bad[0]].error_reason}")
        epochs = sorted({KeyinfoStore(kv).get(kt, w).epoch for kt in pubs for w in wallets})
        if epochs != [1]:
            raise AssertionError(f"deployment reshare: keyinfo epochs {epochs}")
        stages["reshare"]["keys_kept_epoch_1"] = True
        sign_stage("sign_after_reshare", "s2")
        compile_ = {nid: s["compile"] for nid, s in h.items()}
        for nid, c in compile_.items():
            # K0's build is the one ledger entry that is not a graph capture
            graphs_ = sum(g["captures"] for g in c["graphs"].values())
            families = {k.split(".")[0] for k in c["graphs"]}
            if (c["state"] != "ready" or (c["compiles"] - graphs_ == 1) != on_card
                    or bool(graphs_) != on_card or on_card and families != {"eddsa", "gg18"}):
                raise AssertionError(f"deployment: {nid}'s compile section {c}")
        record = {
            "phase": "deployment", "nodes": dep.nodes, "threshold": 1, "wallets": W,
            "processes": "broker + 3 daemons (python -m mpcium_tpu_torch.cli.main)",
            "device": "default (cuda)" if dev is None else str(dev),
            "broker": {"encrypt": True, "journal": True, "control_plane": "broker"},
            "config": DEPLOY_CFG, "up_s": up, "compile": compile_,
            "scheduler": {nid: {k: s["metrics"]["counters"].get(f"scheduler.{k}", 0.0)
                                for k in HEALTH_KEYS} for nid, s in h.items()},
            "reduced": {"DEPLOY_W": f"{W}: phase 24's burst, so the stage walls compare"}}
    finally:
        if rc is not None:
            rc.close()
        stopped = dep.stop()
    record["shutdown"] = {tag: {"rc": rc_, "s": s} for tag, (rc_, s) in stopped.items()}
    if any(rc_ != 0 for rc_, _ in stopped.values()):
        raise AssertionError(f"deployment: shutdown {record['shutdown']}: "
                             + " | ".join(dep.log_tail(t, 800) for t in stopped))
    doc = json.loads((root / "node0" / "db" / "node0" / TRACE_DUMP).read_text())
    record["trace_node0"] = {"events": validate_chrome(doc),
                             "dropped_spans": doc["otherData"]["dropped_spans"]}
    record["warm"] = {nid: _warm_report(root / nid / "db" / nid) for nid in dep.nodes}
    shutil.rmtree(root, ignore_errors=True)
    bad = {nid: w for nid, w in record["warm"].items()
           if w["totals"]["failed"] or w["totals"]["skipped"] or w["totals"]["entries"] != 3
           or w["totals"]["warmed"] + w["totals"]["already"] != w["totals"]["entries"]
           or w["devices"] != ["cpu" if dev == "cpu" else "cuda"]}
    if bad:
        raise AssertionError(f"deployment: warm reports {bad}")
    return {"record": record, "stages": stages, "checks": checks}


_DEPLOY_POOL = None


def _deployment_task(W: int, seed: int) -> dict:
    """Phase 25's client in a process of its own: it starts the daemons and
    drives them through the client, and touches no device itself."""
    t0, t_start = time.perf_counter(), since_start()
    res = deployment_run(W, seed)
    res["record"].update(phase_s=time.perf_counter() - t0, t_start_s=t_start,
                         t_end_s=since_start())
    return res


def start_deployment(W: int, seed: int):
    """Start phase 25 on a spawned process, niced like phase 24's (the
    daemons inherit it); it overlaps the phases after the kernel timings.
    Phases 29 and 28 are the worker's second task: they run after the
    deployment returns."""
    global _DEPLOY_POOL
    _DEPLOY_POOL = spawned_pool()
    t_submit = time.perf_counter()
    return (_DEPLOY_POOL.submit(_deployment_task, W, seed),
            _DEPLOY_POOL.submit(_boot_task, seed), t_submit)


def join_deployment(future, t_submit: float, serving: dict) -> dict:
    t0 = time.perf_counter()
    res = future.result()
    wait_s = time.perf_counter() - t0
    serving_finish(res, {"overlapped": True, "join_wait_s": wait_s,
                            "since_submit_s": time.perf_counter() - t_submit,
                            "phase24_stage_walls_s": {
                                k: {"wall_s": v["wall_s"], "ecdsa_wall_s": v.get("ecdsa_wall_s"),
                                    "eddsa_wall_s": v.get("eddsa_wall_s")}
                                for k, v in serving["stages"].items()}}, "deployment")
    return res


# ---------------------------------------------------------------------------
# phases 28 and 29: the daemon's boot — the session axis over several
# devices (engine/sharded.py) and the budgeted warm pass (warm/)
# ---------------------------------------------------------------------------

SHARDED_EDDSA_B = 4096  # BASELINE config 2's batch
SHARDED_GG18_B = 1024
SHARDED_MULMOD_B = 1024
# committee → mesh entries, every one the card: one card splits and gathers
SHARDED_MESHES = {1: 2, 2: 4}
SHARDED_GG18_MESH = 4  # session shards of the GG18 leg and the K0 leg (committee 1)
WARM_BUDGET_S = 600.0


def _mesh_dev(dev: str) -> str:
    return "cuda:0" if dev == "cuda" else dev


def _walled(fn, dev: str):
    """fn() → (its result, wall seconds with the device synchronized)."""
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def sharded_run(seed: int, K, dev: str = "cuda") -> dict:
    """Phase 28's work: the EdDSA two-phase step (``sharded_sign``) at
    SHARDED_EDDSA_B on a one-device mesh and on the meshes of
    SHARDED_MESHES, the GG18 curve leg (``shard_gg18_sessions`` +
    ``gg18_curve_leg``) at SHARDED_GG18_B unsharded and over
    SHARDED_GG18_MESH shards, and K0's modular product over a 2048-bit
    Paillier N at SHARDED_MULMOD_B through one context and through
    ``sharded_mulmod`` (K0's counters zeroed just before: one launch per
    shard, no plain call). Each sharded result must equal its unsharded
    run byte for byte, the products python ints. A first unsharded run of
    each leg pays the process's first-use costs and is reported apart.
    → the record and the signatures, which :func:`sharded_finish`
    verifies on the host."""
    import random

    import numpy as np
    import torch

    from mpcium_tpu_torch.cluster import load_test_preparams
    from mpcium_tpu_torch.core import bignum as bn
    from mpcium_tpu_torch.engine import gg18_batch as gb
    from mpcium_tpu_torch.engine import sharded
    from mpcium_tpu_torch.ops.modmul import MXUBarrett
    from mpcium_tpu_torch.utils import sharded_golden as sg

    md = _mesh_dev(dev)
    rec = {"phase": "sharded", "device": md, "seed": seed,
           "cuda_device_count": torch.cuda.device_count(),
           "note": "every mesh entry is the one card: the split and the gathers are real, "
                   "the pieces run one after another on it"}
    fail = []
    # -- the EdDSA two-phase step ------------------------------------------------
    t0 = time.perf_counter()
    inp = sg.eddsa_inputs(SHARDED_EDDSA_B)
    rec["eddsa_keygen_s"] = time.perf_counter() - t0
    args = (inp["r64"], inp["lamx"], inp["A_comp"], inp["messages"])
    meshes = {"unsharded": sharded.make_mesh([md], committee=1)}
    meshes.update({f"committee_{c}": sharded.make_mesh([md] * n, committee=c)
                   for c, n in SHARDED_MESHES.items()})
    _, rec["eddsa_first_s"] = _walled(lambda: sharded.sharded_sign(meshes["unsharded"], *args),
                                      dev)
    ed, outs = {}, {}
    for name, mesh in meshes.items():
        outs[name], wall = _walled(lambda: sharded.sharded_sign(mesh, *args), dev)
        ed[name] = {"mesh": mesh.describe(), "wall_s": wall,
                    "sigs_per_s": SHARDED_EDDSA_B / wall, "ok_all": bool(outs[name][1].all())}
    ref = outs["unsharded"]
    for name, (sigs, ok) in outs.items():
        ed[name]["equal_to_unsharded"] = bool(np.array_equal(sigs, ref[0])
                                              and np.array_equal(ok, ref[1]))
        if not (ed[name]["equal_to_unsharded"] and ed[name]["ok_all"]):
            fail.append(f"eddsa {name}")
    rec["eddsa"] = {"B": SHARDED_EDDSA_B, "q": 2, "runs": ed}
    # -- the GG18 curve leg ------------------------------------------------------
    t0 = time.perf_counter()
    shares, digests = sg.gg18_wallets(gb, SHARDED_GG18_B)
    rec["gg18_keygen_s"] = time.perf_counter() - t0
    gmesh = sharded.make_mesh([md] * SHARDED_GG18_MESH, committee=1)

    def signer(mesh):
        s = gb.GG18BatchCoSigners.curve_only(sg.QUORUM, shares[:2], rng=sg.gg18_signer_rng(),
                                             device=md)
        if mesh is not None:
            sharded.shard_gg18_sessions(s, mesh)
        return s

    first = signer(None)
    _, rec["gg18_first_s"] = _walled(lambda: sharded.gg18_curve_leg(first, digests), dev)
    legs, gg = {}, {}
    for name, mesh in (("unsharded", None), ("sharded", gmesh)):
        s, shard_s = _walled(lambda: signer(mesh), dev)
        legs[name], wall = _walled(lambda: sharded.gg18_curve_leg(s, digests), dev)
        gg[name] = {"mesh": None if mesh is None else mesh.describe(), "setup_s": shard_s,
                    "wall_s": wall, "ok_all": bool(legs[name]["ok"].all())}
    gg["sharded"]["equal_to_unsharded"] = all(
        np.array_equal(legs["sharded"][k], legs["unsharded"][k]) for k in ("r", "s", "ok"))
    if not (gg["sharded"]["equal_to_unsharded"] and gg["sharded"]["ok_all"]):
        fail.append("gg18 leg")
    rec["gg18"] = {"B": SHARDED_GG18_B, "q": 2, "runs": gg}
    # -- K0 over the mesh ----------------------------------------------------------
    N = load_test_preparams(2048)["node0"].paillier.N
    ctx = MXUBarrett(N, device=md)
    rng = random.Random(seed + 28)
    xs = [0, 1, N - 1] + [rng.randrange(N) for _ in range(SHARDED_MULMOD_B - 3)]
    ys = [N - 1, N - 1, N - 1] + [rng.randrange(N) for _ in range(SHARDED_MULMOD_B - 3)]
    a, b = bn.batch_to_limbs(xs, ctx.prof), bn.batch_to_limbs(ys, ctx.prof)
    whole, whole_s = _walled(lambda: ctx.mulmod(torch.as_tensor(a, device=md),
                                                torch.as_tensor(b, device=md)).cpu().numpy(), dev)
    K.reset_counters()
    got, split_s = _walled(lambda: sharded.sharded_mulmod(gmesh, N, a, b), dev)
    k0 = _k0_counts(K)
    per_device = {str(d): gmesh.session_devices.count(d) for d in gmesh.device_set}
    mm = {"B": SHARDED_MULMOD_B, "modulus_bits": N.bit_length(), "n_limbs": ctx.prof.n_limbs,
          "mesh": gmesh.describe(), "unsharded_s": whole_s, "sharded_s": split_s,
          "k0": _k0_json(k0), "k0_launches_per_device": per_device,
          "equal_to_unsharded": bool(np.array_equal(got, whole)),
          "equal_to_python": bn.batch_from_limbs(got, ctx.prof) == [
              x * y % N for x, y in zip(xs, ys)]}
    rec["mulmod"] = mm
    on_card = dev != "cpu"
    if not (mm["equal_to_unsharded"] and mm["equal_to_python"]) or (
            (k0["launches"] != SHARDED_GG18_MESH or k0["plain_calls"]) if on_card
            else (k0["launches"] or k0["plain_calls"] != SHARDED_GG18_MESH)):
        fail.append(f"mulmod {mm}")
    rec["failed"] = fail
    return {"record": rec,
            "eddsa": (inp["public_keys"], inp["messages"], outs["committee_2"][0]),
            "ecdsa": ([s.public_key for s in shares[0]], [bytes(d) for d in digests],
                      legs["sharded"]["r"], legs["sharded"]["s"])}


def sharded_finish(res: dict, extra: dict) -> None:
    """Verify every signature of phase 28 on the host pool (the sharded
    runs'; the others equal them byte for byte), print its line and fail
    on any fault."""
    rec = res["record"]
    th = time.perf_counter()
    rec["verified_eddsa"] = verify_ed25519(*res["eddsa"])
    rec["verified_ecdsa"] = verify_ecdsa(*res["ecdsa"])
    rec["host_verify_s"] = time.perf_counter() - th
    emit({**rec, **extra})
    if rec["failed"] or rec["verified_eddsa"] != SHARDED_EDDSA_B \
            or rec["verified_ecdsa"] != SHARDED_GG18_B:
        raise AssertionError(f"sharded: {rec['failed']}, verified "
                             f"{rec['verified_eddsa']} / {rec['verified_ecdsa']}")


def warm_run(K, dev: str = "cuda") -> dict:
    """Phase 29: ``warm.prewarm`` on the card over every serving engine at
    bucket 1 (four schemes, q=2, both curves, both MtA backends, the
    1024-bit fixture): every entry must warm on the device, none fail or
    be skipped; the entries that launch K0 (the Paillier MtA) report its
    build verdict, the rest ``none``, and K0 must have launched both
    entries at n=160 in every mode of POWMOD_WARM; the EdDSA entry and
    the GG18 entries must have captured graphs (an entry's ``cache`` is
    then their verdict, and K0's is its ``k0``). → the phase record."""
    import torch

    from mpcium_tpu_torch.warm import manifest as wm
    from mpcium_tpu_torch.warm import prewarm as pw

    manifest = wm.build_manifest(wm.WarmKnobs(), buckets=(1,))
    K.reset_counters()
    t0 = time.perf_counter()
    rep = pw.prewarm(manifest, WARM_BUDGET_S, device=dev)
    k0 = _k0_counts(K)
    rec = {"phase": "warm", "device": dev, "budget_s": WARM_BUDGET_S,
           "wall_s": time.perf_counter() - t0, "totals": rep["totals"], "key": rep["key"],
           "entries": [{k: r.get(k) for k in ("engine", "shape", "status", "warm_s", "cache",
                                                "k0", "compile_s", "device", "reason")}
                       for r in rep["results"]],
           "k0": _k0_json(k0)}
    rec["memory_reserved"] = torch.cuda.memory_reserved() if dev == "cuda" else None
    t = rep["totals"]
    k0_engines = {r["engine"] for r in rep["results"]
                  if (r.get("k0") if "graphs" in r else r.get("cache")) not in (None, "none")}
    want_k0 = {"gg18.sign", "party.ecdsa"} if dev != "cpu" else set()
    rec["k0_entries"] = sorted(k0_engines)
    rec["graph_entries"] = {f"{r['engine']}|{r['shape']}": r["graphs"]
                            for r in rep["results"] if "graphs" in r}

    def captured(*engines) -> int:
        return sum(g["misses"] for k, g in rec["graph_entries"].items()
                   if k.split("|")[0] in engines)

    rec["failed_checks"] = [c for c, bad in (
        ("every entry warmed", t["warmed"] != t["entries"] or t["entries"] != 12),
        ("nothing failed or skipped", t["failed"] or t["skipped"]),
        ("on the device", any(r["device"] != str(pw.resolve(dev)) for r in rep["results"])),
        ("K0 on the Paillier entries", k0_engines != want_k0),
        ("the EdDSA entry captures its graphs", dev != "cpu" and not captured("eddsa.sign")),
        ("the GG18 entries capture theirs", dev != "cpu" and not captured("gg18.sign",
                                                                           "party.ecdsa")),
        ("K0 at n=160 in every mode", dev != "cpu" and not (
            k0["mulmod_by_width"].get(160) and all(
                k0["powmod_by_mode_width"].get(key) for key in POWMOD_WARM)))) if bad]
    return rec


def _boot_task(seed: int) -> dict:
    """Phases 29 and 28 on phase 25's worker after its deployment (the
    lane that ends first): the warm pass first, in a process that has not
    touched the card yet, as a daemon's boot has not."""
    import torch

    from mpcium_tpu_torch.ops import mulmod as K
    from mpcium_tpu_torch.utils import log

    log.init(level="WARNING")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = since_start()
    warm = warm_run(K)
    warm.update(t_start_s=t0, t_end_s=since_start())
    t1 = since_start()
    res = sharded_run(seed, K)
    res["record"].update(t_start_s=t1, t_end_s=since_start())
    return {"warm": warm, "sharded": res}


def boot_finish(res: dict, extra: dict) -> None:
    warm = res["warm"]
    emit({**warm, **extra})
    sharded_finish(res["sharded"], extra)
    if warm["failed_checks"]:
        raise AssertionError(f"warm: {warm['failed_checks']}: {warm['entries']}")


def join_boot(future, t_submit: float) -> dict:
    """Wait for phases 29 and 28 (phase 25's worker), then finish them.
    → phase 29's K0 counts."""
    t0 = time.perf_counter()
    res = future.result()
    wait_s = time.perf_counter() - t0
    _DEPLOY_POOL.shutdown()
    boot_finish(res, {"overlapped": True, "join_wait_s": wait_s,
                      "since_submit_s": time.perf_counter() - t_submit})
    return res["warm"]["k0"]

# ---------------------------------------------------------------------------
# phases 5-7, 9, 15 and 16 (the JAX goldens replayed on the card) and 32
# (the micro-benches), in a process of their own beside the main
# process's phases
# ---------------------------------------------------------------------------

_GOLDEN_POOL = None


def _goldens_task(seed: int) -> dict:
    """The golden phases, the micro-benches and the chaos drills need
    nothing of the main process; each golden phase prints its own line
    as it ends, the drills' record is returned (the main process prints
    it beside the soak's). The drills log at WARNING (their faults log by
    design). Phase 36's rows at B=1,024 run last."""
    import torch

    from mpcium_tpu_torch.utils import log

    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = since_start()
    check_golden()
    ot_leg_golden()
    ot_tamper()
    check_golden(OT_GOLDEN, "ot_golden")
    ecdsa_party_golden()
    dkg_golden()
    run_microbench()
    log.init(level="WARNING")
    chaos = run_chaos(CHAOS_SEED)
    run_bench_cli()
    t_end = since_start()
    rows = gg18_graph_rows(seed, bs=(1024,))
    return {"t_start_s": t_start, "t_end_s": t_end, "chaos": chaos, "gg18_rows": rows}


def start_goldens(seed: int):
    global _GOLDEN_POOL
    _GOLDEN_POOL = spawned_pool()
    return _GOLDEN_POOL.submit(_goldens_task, seed), time.perf_counter()


def join_goldens(future, t_submit: float):
    """Wait for the goldens' process → (phase 26's record, phase 36's rows
    at B=1,024)."""
    t0 = time.perf_counter()
    res = future.result()
    _GOLDEN_POOL.shutdown()
    chaos, rows = res.pop("chaos"), res.pop("gg18_rows")
    emit({"phase": "goldens", "phases": [5, 6, 7, 9, 15, 16, 32, 26, 34], **res,
          "join_wait_s": time.perf_counter() - t0,
          "since_submit_s": time.perf_counter() - t_submit})
    return chaos, rows


# ---------------------------------------------------------------------------
# phase 34: the measurement round's bench CLI at BASELINE config 1
# ---------------------------------------------------------------------------

BENCH_ENV = {"MPCIUM_BENCH_B": "1", "MPCIUM_BENCH_RUNS": "1", "MPCIUM_BENCH_NO_SECONDARY": "1",
             "MPCIUM_BENCH_NO_OT": "1", "MPCIUM_BENCH_B_SWEEP": "none",
             "MPCIUM_BENCH_WATCHDOG_S": "540"}
BENCH_TIMEOUT_S = 600


def run_bench_cli() -> None:
    """Phase 34: ``python -m mpcium_tpu_torch.bench`` on the card at B=1
    (its own process: K0's library loads from the build cache), the
    child's last metric line printed and checked."""
    t0 = time.perf_counter()
    env = dict(os.environ, **BENCH_ENV)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH", "")) if p)
    proc = subprocess.run([sys.executable, "-m", "mpcium_tpu_torch.bench"], cwd=str(ROOT),
                          env=env, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    rec = None
    for line in reversed(proc.stdout.splitlines()):
        if line.startswith("{"):
            try:
                doc = json.loads(line)
            except ValueError:
                continue
            if isinstance(doc, dict) and "metric" in doc:
                rec = doc
                break
    k0 = (rec or {}).get("k0") or {}
    emit({"phase": "bench", "argv": "python -m mpcium_tpu_torch.bench", "env": BENCH_ENV,
          "reduced": {"secondary": "none", "ot_variant": "none", "b_sweep": "none"},
          "rc": proc.returncode, "wall_s": wall, "record": rec,
          "stderr_tail": proc.stderr[-2000:] if proc.returncode else ""})
    bad = []
    if proc.returncode != 0:
        bad.append(f"rc={proc.returncode}")
    if rec is None:
        bad.append("no metric line")
    else:
        if rec.get("platform") != "gpu":
            bad.append(f"platform {rec.get('platform')!r}")
        if rec.get("batch") != 1:
            bad.append(f"batch {rec.get('batch')!r}")
        if not (isinstance(rec.get("value"), (int, float)) and rec["value"] > 0):
            bad.append(f"value {rec.get('value')!r}")
        if rec.get("watchdog_timeout") or "watchdog" in proc.stderr:
            bad.append("the watchdog fired")
        if not k0.get("launches", 0) > 0:
            bad.append(f"K0 launches {k0.get('launches')!r}")
        if k0.get("plain_calls") != 0:
            bad.append(f"K0 plain calls {k0.get('plain_calls')!r}")
    if bad:
        raise AssertionError(f"phase 34 bench: {bad}")


# ---------------------------------------------------------------------------
# phases 30-32: the measurement tooling — the engines' phase spans, the
# card's timeline folded into them, the idle share, and the micro-benches
# with their statistical gate
# ---------------------------------------------------------------------------

PROFILE_DIR = ROOT / ".mpcium_profile" / "chip_smoke"
K0_KERNELS = ("mulmod_kernel", "powmod_kernel")  # the kernel names in csrc/mulmod.cu


def _traced_sign(signer, digests, dev: str):
    """One sign under tracing → (spans, outputs, wall s); the device is
    synchronized before the clock stops."""
    from mpcium_tpu_torch.utils import tracing

    spans: list = []
    tracing.enable(sink=spans.append)
    try:
        t0 = time.perf_counter()
        out = signer.sign(digests, cohorts=COHORTS)
        _sync(dev)
        wall = time.perf_counter() - t0
    finally:
        tracing.disable()
    return spans, out, wall


def _window_s(spans) -> float:
    edges = [(s["t0_ns"], s["t1_ns"]) for s in spans
             if s["name"].startswith(("phase:", "host:"))]
    return (max(t1 for _, t1 in edges) - min(t0 for t0, _ in edges)) / 1e9


def run_profile(signer, shares, B: int, seed: int, K, measured: dict, dev: str = "cuda") -> None:
    """Phase 30: a third warm Paillier sign on phase 4's signer, fresh
    digests, under tracing and ``perf.profile.device_profile``: the phase
    share and the idle share from the spans, and the card's own time per
    phase from the capture. On the card K0's kernel events in the capture
    must equal K0's launch counters for the sign, with no plain call."""
    import numpy as np

    from mpcium_tpu_torch.perf import profile
    from mpcium_tpu_torch.utils import tracing

    digests = np.random.default_rng(seed + 30).integers(0, 256, (B, 32), dtype=np.uint8)
    shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    env_before = os.environ.get(profile.PROFILE_ENV)
    os.environ[profile.PROFILE_ENV] = "1"
    K.reset_counters()
    try:
        with profile.device_profile(str(PROFILE_DIR), device=dev) as on:
            spans, out, wall = _traced_sign(signer, digests, dev)
            t_end = time.perf_counter()
        export_s = time.perf_counter() - t_end
    finally:
        if env_before is None:
            os.environ.pop(profile.PROFILE_ENV)
        else:
            os.environ[profile.PROFILE_ENV] = env_before
    k0_launches = K.launches + sum(K.powmod_launches_by_mode_width.values())
    plain_calls = K.plain_calls
    t0 = time.perf_counter()
    ops = profile.device_ops(str(PROFILE_DIR))
    fold = profile.fold_ops(spans, ops)
    fold_s = time.perf_counter() - t0
    by_name: dict = {}
    for e in ops:
        n, t = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, t + e["dur"] / 1e6)
    k0_events = sum(n for name, (n, _t) in by_name.items()
                    if any(k in name for k in K0_KERNELS))
    k0_device_s = sum(t for name, (_n, t) in by_name.items()
                      if any(k in name for k in K0_KERNELS))
    device_s = sum(e["dur"] for e in ops) / 1e6
    folded_s = sum(fold.values())
    share = tracing.phase_share(spans)
    window = _window_s(spans)
    verified = verify_ecdsa([x.public_key for x in shares[0]], digests, out["r"], out["s"])
    phase_keys = sorted({s["name"][len("phase:"):] for s in spans if s["name"].startswith("phase:")})
    emit({
        "phase": "profile", "B": B, "cohorts": COHORTS, "capturing": on,
        "profiled_sign_s": wall, "measured_sign_s": measured["sign_s"],
        "profiled_over_measured": wall / measured["sign_s"],
        "phase_share_s": share, "device_idle_fraction": tracing.device_idle_fraction(spans),
        "fold_device_op_s": fold, "traced_window_s": window,
        "device_events": len(ops), "device_s": device_s, "folded_device_s": folded_s,
        "unattributed_device_s": device_s - folded_s,
        "busy_share": folded_s / window if window else None,
        "k0_kernel_events": k0_events, "k0_launches": k0_launches, "k0_device_s": k0_device_s,
        "plain_calls": plain_calls,
        "trace_bytes": sum(f.stat().st_size for f in PROFILE_DIR.rglob("*.trace.json.gz")),
        "export_s": export_s,
        "export_steps_s": [json.loads(f.read_text()) for f in PROFILE_DIR.glob("*.export.json")],
        "fold_s": fold_s,
        "top_kernels": [{"name": n[:70], "events": c, "device_s": t} for n, (c, t) in
                        sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]],
        "ok_all": bool(out["ok"].all()), "verified": verified,
    })
    if not out["ok"].all() or verified != B:
        raise AssertionError(f"profiled sign: ok={int(out['ok'].sum())}/{B} verified={verified}/{B}")
    if phase_keys != sorted(measured["phases_s"]):
        raise AssertionError(f"phase_share keys {phase_keys} != phases_s {sorted(measured['phases_s'])}")
    if dev == "cuda":
        if not fold:
            raise AssertionError("the device fold is empty")
        if plain_calls:
            raise AssertionError(f"a plain version ran {plain_calls}x during the profiled sign")
        if k0_events != k0_launches:
            raise AssertionError(f"K0 kernel events in the capture {k0_events} != "
                                 f"K0 launches {k0_launches}")


def run_ot_profile(signer, shares, B: int, seed: int, dev: str = "cuda") -> None:
    """Phase 31: one traced OT-MtA sign on phase 8's signer (spans only):
    the phase share with the OT host/device attrs and the idle share."""
    import numpy as np

    from mpcium_tpu_torch.utils import tracing

    digests = np.random.default_rng(seed + 31).integers(0, 256, (B, 32), dtype=np.uint8)
    spans, out, wall = _traced_sign(signer, digests, dev)
    verified = verify_ecdsa([x.public_key for x in shares[0]], digests, out["r"], out["s"])
    emit({
        "phase": "ot_phase_share", "B": B, "cohorts": COHORTS, "traced_sign_s": wall,
        "phase_share_s": tracing.phase_share(spans),
        "device_idle_fraction": tracing.device_idle_fraction(spans),
        "traced_window_s": _window_s(spans),
        "ok_all": bool(out["ok"].all()), "verified": verified,
    })
    if not out["ok"].all() or verified != B:
        raise AssertionError(f"traced OT sign: ok={int(out['ok'].sum())}/{B} verified={verified}/{B}")


def _gate_row(name: str, xs: list) -> dict:
    from mpcium_tpu_torch.perf import statcheck

    same = statcheck.gate({name: xs}, {name: xs})
    slow = statcheck.gate({name: xs}, {name: [x * 1.5 for x in xs]})
    return {"median_ms": statcheck.median(xs) * 1e3,
            "p90_ms": sorted(xs)[int(0.9 * (len(xs) - 1))] * 1e3,
            "max_over_min": max(xs) / min(xs),
            "self_ok": same.ok, "scaled_flagged": not slow.ok,
            "scaled": slow.verdicts[0].render()}


def run_microbench(samples: int = 30, dev: str = "cuda") -> None:
    """Phase 32: every micro-bench row on the card, each row's median and
    p90, and the statistical gate on each row's samples: against
    themselves they pass, against a copy scaled by 1.5 they fail. The
    second verdict is certain only while a row's samples spread less
    than 1.5× (max over min); a row whose scaled copy is not flagged is
    measured once more, as the JAX package's perfcheck retries a
    verdict, and both attempts are printed."""
    from mpcium_tpu_torch.perf import microbench

    t0 = time.perf_counter()
    rows = microbench.run_all(samples=samples, device=dev)
    bench_s = time.perf_counter() - t0
    out, bad = {}, []
    for name, xs in rows.items():
        row = out[name] = _gate_row(name, xs)
        if row["self_ok"] and not row["scaled_flagged"]:
            fn = microbench.ALL_BENCHES[name]
            again = fn(samples, device=dev) if name in microbench._DEVICE_ROWS else fn(samples)
            row["retry"] = _gate_row(name, again)
        final = row.get("retry", row)
        if not final["self_ok"] or not final["scaled_flagged"]:
            bad.append(name)
    emit({"phase": "microbench", "samples": samples, "device": dev, "bench_s": bench_s,
          "rows": out})
    if bad:
        raise AssertionError(f"the gate misjudged the rows {bad}")


# ---------------------------------------------------------------------------
# phase 33: the host pipelined OT extension (MPCIUM_OT_DEVICE=0) over the
# native g++ library, against the device route and the card's hashes
# ---------------------------------------------------------------------------

OT_HOST_SETS = 11  # one more than MAX_PAYLOAD_SETS: the host route by count
OT_HOST_SMALL_B = 8
OT_HOST_REPS = 5  # timed calls per hashing stage; the median is printed
# the leg's routes in turns; each route's second run must give its first's bytes
OT_HOST_ORDER = ("device", "host", "host", "device")


@contextlib.contextmanager
def _ot_route(value: str):
    """MPCIUM_OT_DEVICE set for the calls inside, then restored."""
    saved = os.environ.get("MPCIUM_OT_DEVICE")
    os.environ["MPCIUM_OT_DEVICE"] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("MPCIUM_OT_DEVICE", None)
        else:
            os.environ["MPCIUM_OT_DEVICE"] = saved


def _median_ms(fn, cuda: bool) -> float:
    """Median ms of OT_HOST_REPS calls after one untimed call: CUDA events
    around each call on the card, the host clock for host code."""
    import torch

    fn()
    if cuda:
        torch.cuda.synchronize()
    times = []
    for _ in range(OT_HOST_REPS):
        if cuda:
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _ot_host_leg(seed: int, dev: str = "cuda"):
    """The synthetic leg's fixed base-OT keys with one seeded stream."""
    from mpcium_tpu_torch.protocol.ecdsa.mta_ot import OTMtALeg
    from mpcium_tpu_torch.utils import ot_golden as og
    from mpcium_tpu_torch.utils.rng import DetRng

    _tag, k0, k1, delta = og.synth_base_ot()
    return OTMtALeg.from_base_ot(b"node0->node1", k0, k1, delta, rng=DetRng(seed), device=dev)


def _ot_scalars(B: int, n_sets: int, seed: int):
    """a and n_sets Bob scalar lists (non-zero: b = 0 makes B = b·G the
    identity, which the openings reject)."""
    from mpcium_tpu_torch.core.hostmath import SECP_N as Q
    from mpcium_tpu_torch.utils.rng import DetRng

    r = DetRng(seed)
    a = [r.randbelow(Q) for _ in range(B)]
    return a, [[r.randbelow(Q - 1) + 1 for _ in range(B)] for _ in range(n_sets)]


def _ot_limbs(vals, dev: str):
    import torch

    from mpcium_tpu_torch.core import bignum as bn

    return torch.as_tensor(bn.batch_to_limbs(vals, bn.P256), device=dev)


def _leg_run(leg, a, bs, dev: str, timings=None):
    """run_multi → (shares as host arrays, verdicts as lists)."""
    out = leg.run_multi(_ot_limbs(a, dev), tuple(_ot_limbs(b, dev) for b in bs),
                        timings=timings)
    shares = [(al.cpu().numpy(), be.cpu().numpy()) for al, be in out]
    return shares, {k: v.tolist() for k, v in sorted(leg.check_verdicts.items())}


def _leg_serial(leg, a, bs, dev: str):
    """The three-round composition (alice_round1 → bob_round2_multi →
    alice_round3_multi) → shares as host arrays."""
    msg_a = leg.alice_round1(_ot_limbs(a, dev), 0)
    msgs_b, betas = leg.bob_round2_multi(tuple(_ot_limbs(b, dev) for b in bs), msg_a, 0)
    alphas = leg.alice_round3_multi(msgs_b)
    return [(al.cpu().numpy(), be.cpu().numpy()) for al, be in zip(alphas, betas)]


def _same_shares(x, y) -> bool:
    import numpy as np

    return len(x) == len(y) and all(
        np.array_equal(a0, a1) and np.array_equal(b0, b1) for (a0, b0), (a1, b1) in zip(x, y))


def _reconstructs(shares, a, bs) -> int:
    """Lanes of every set whose α + β ≡ a·b (mod q), in python ints."""
    from mpcium_tpu_torch.core import bignum as bn
    from mpcium_tpu_torch.core.hostmath import SECP_N as Q

    good = 0
    for (al, be), b in zip(shares, bs):
        al_i = bn.batch_from_limbs(al, bn.P256)
        be_i = bn.batch_from_limbs(be, bn.P256)
        good += sum((x + y) % Q == ai * bi % Q for x, y, ai, bi in zip(al_i, be_i, a, b))
    return good


def _hash_stages(leg, B: int, K: int, dev: str = "cuda") -> dict:
    """(b): each host hashing stage against its card counterpart at the
    leg's chunk shapes (Bc = B/K lanes: Bc PRG blocks a seed, a (κ,
    Bc·32) extension matrix, Bc·256 pad rows), byte for byte, timed."""
    import numpy as np
    import torch

    from mpcium_tpu_torch import native
    from mpcium_tpu_torch.ops import hash_suite as hs
    from mpcium_tpu_torch.protocol.ecdsa import mta_ot

    Bc = B // K
    Mc = Bc * mta_ot.NBITS
    tag = leg._ext_tag(0)
    blk_off = Bc  # the second chunk's origins
    seeds = np.stack([leg.k0, leg.k1, leg.keysD])
    prg_prefix = b"mpcium-ot-prg|" + tag
    seeds_d = torch.as_tensor(seeds, device=dev)
    prefix_d = hs.as_bytes(prg_prefix, dev)
    rows = {}

    def host_prg():
        return np.stack([native.prg_expand(prg_prefix, k, Bc, blk_off) for k in seeds])

    def dev_prg():
        return hs.prg_expand_core(seeds_d, prefix_d, Bc, blk_off)

    t0_c = host_prg()[0]
    packed_d = torch.as_tensor(t0_c, device=dev)
    pad_prefix = leg._pad_prefixes(tag, 1)[0]
    t_rows = native.ot_transpose(t0_c)
    idx = np.arange(blk_off * mta_ot.NBITS, blk_off * mta_ot.NBITS + Mc, dtype="<u4")
    buf = np.concatenate([t_rows, idx.view(np.uint8).reshape(Mc, 4)], axis=1)
    rows_d = torch.as_tensor(t_rows, device=dev)
    idx_d = hs.le32_bytes(blk_off * mta_ot.NBITS + torch.arange(Mc, device=dev))
    pad_prefix_d = hs.as_bytes(pad_prefix, dev)
    stages = {
        "prg_expand": (host_prg, dev_prg, {"seeds": 3 * mta_ot.KAPPA, "blocks": Bc}),
        "ot_transpose": (lambda: native.ot_transpose(t0_c),
                         lambda: hs.ot_transpose_core(packed_d), {"matrix": [mta_ot.KAPPA, Bc * 32]}),
        "pad_hash": (lambda: native.batch_sha256(pad_prefix, buf),
                     lambda: hs.pad_hash_core(pad_prefix_d, rows_d, idx_d), {"rows": Mc}),
    }
    for name, (host_fn, dev_fn, shape) in stages.items():
        equal = bool(np.array_equal(host_fn(), dev_fn().cpu().numpy()))
        rows[name] = {**shape, "equal": equal, "native_ms": _median_ms(host_fn, False),
                      "card_ms": _median_ms(dev_fn, dev == "cuda")}
    return rows


def run_ot_host(B: int, seed: int, K, dev: str = "cuda") -> None:
    """Phase 33: the host pipelined OT extension on the card's machine.
    (a) one leg at B (two payload sets, resolve_chunks(B) chunks) on the
    device route and on the host route, byte for byte, and equal to the
    serial three-round composition; (b) each native hashing stage against
    the card's; (c) OT_HOST_SETS payload sets at B=OT_HOST_SMALL_B (the
    host route by count) reconstructing a·b; (d) one GG18 OT sign of B
    wallets (cohorts 2) under MPCIUM_OT_DEVICE=0: every signature
    verified on the host, blame clean, no K0 launch."""
    import numpy as np

    from mpcium_tpu_torch import native
    from mpcium_tpu_torch.engine import gg18_batch as gb
    from mpcium_tpu_torch.protocol.ecdsa.mta_ot import resolve_chunks
    from mpcium_tpu_torch.utils.rng import SeededStream

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    native.build()
    native_build_s = time.perf_counter() - t0
    chunks = resolve_chunks(B)

    # (a) one leg: the serial three-round composition first (the first run
    # of a shape pays the allocator's warm-up), then the device route and
    # the host route, each from the same keys and stream
    a, bs = _ot_scalars(B, 2, seed + 31)
    serial = _leg_serial(_ot_host_leg(seed + 32, dev), a, bs, dev)
    runs, repeats = {}, {}
    for route in OT_HOST_ORDER:
        leg, tm = _ot_host_leg(seed + 32, dev), {}
        with _ot_route("0" if route == "host" else "1"):
            run = _leg_run(leg, a, bs, dev, tm) + (tm,)
        if route in runs:
            repeats[route] = run
        else:
            runs[route] = run
    dev_shares, dev_verdicts, _ = runs["device"]
    host_shares, host_verdicts, _ = runs["host"]
    leg_ok = {
        "host_equals_device": _same_shares(host_shares, dev_shares),
        "verdicts_equal": host_verdicts == dev_verdicts,
        "verdicts_clean": all(all(np.ravel(v)) for v in host_verdicts.values()),
        "host_equals_serial": _same_shares(host_shares, serial),
        "reconstructs": _reconstructs(host_shares, a, bs) == 2 * B,
    }
    if repeats:  # repeated runs of a route give the same bytes
        leg_ok["repeats_equal"] = all(
            _same_shares(r[0], runs[route][0]) and r[1] == runs[route][1]
            for route, r in repeats.items())

    # (b) the hashing stages at the leg's chunk shapes
    stages = _hash_stages(_ot_host_leg(seed + 32, dev), B, chunks, dev)

    # (c) OT_HOST_SETS payload sets take the host route by count
    a8, bs8 = _ot_scalars(OT_HOST_SMALL_B, OT_HOST_SETS, seed + 33)
    many, many_verdicts = _leg_run(_ot_host_leg(seed + 34, dev), a8, bs8, dev)
    many_ok = {"reconstructs": _reconstructs(many, a8, bs8) == OT_HOST_SETS * OT_HOST_SMALL_B,
               "verdicts_clean": all(all(np.ravel(v)) for v in many_verdicts.values())}

    # (d) a GG18 OT sign through the host route
    t0 = time.perf_counter()
    shares = gb.dealer_keygen_secp_batch(B, ["node0", "node1", "node2"], threshold=1,
                                         rng=SeededStream(seed + 35))
    keygen_s = time.perf_counter() - t0
    digests = np.random.default_rng(seed + 36).integers(0, 256, (B, 32), dtype=np.uint8)
    phases: dict = {}
    with _ot_route("0"):
        t0 = time.perf_counter()
        signer = gb.GG18BatchCoSigners(["node0", "node1"], [shares[0], shares[1]],
                                       rng=SeededStream(seed + 37), mta_impl="ot", device=dev)
        _sync(dev)
        setup_s = time.perf_counter() - t0
        K.reset_counters()
        t0 = time.perf_counter()
        out = signer.sign(digests, phase_times=phases, cohorts=COHORTS)
        _sync(dev)
        sign_s = time.perf_counter() - t0
        k0 = (K.launches + sum(K.powmod_launches_by_mode_width.values()), K.plain_calls)
    blame = [leg_.check_blame() for leg_ in signer.ot_legs.values()]
    blame_clean = all(v is not None and not any(v) for v in blame)
    t0 = time.perf_counter()
    verified = verify_ecdsa([x.public_key for x in shares[0]], digests, out["r"], out["s"])
    verify_s = time.perf_counter() - t0

    emit({
        "phase": "ot_host", "B": B, "chunks": chunks, "seed": seed,
        "native_build_s": native_build_s, "native_threads": native.threads(),
        "leg": {**leg_ok, "sets": 2, "order": ", ".join(("serial",) + OT_HOST_ORDER),
                **{f"{route}_{key}": runs[route][2][key]
                   for route in ("device", "host") for key in ("total_s", "checks_s")},
                **{f"{route}_repeat_total_s": r[2]["total_s"] for route, r in repeats.items()},
                **{key: runs["host"][2][key]
                   for key in ("host_s", "host_wait_s", "device_wait_s")}},
        "stages": stages,
        "many_sets": {**many_ok, "sets": OT_HOST_SETS, "B": OT_HOST_SMALL_B},
        "sign": {"cohorts": COHORTS, "keygen_s": keygen_s, "setup_s": setup_s, "sign_s": sign_s,
                 "phases_s": phases, "verified": verified,
                 "ok_all": bool(out["ok"].all()), "blame_clean": blame_clean,
                 "k0_launches": k0[0], "plain_calls": k0[1], "host_verify_s": verify_s},
        "s": time.perf_counter() - t_phase,
    })
    bad = [k for k, v in leg_ok.items() if not v]
    bad += [f"stage {k}" for k, v in stages.items() if not v["equal"]]
    bad += [f"{OT_HOST_SETS} sets: {k}" for k, v in many_ok.items() if not v]
    if not out["ok"].all() or verified != B:
        bad.append(f"sign: ok={int(out['ok'].sum())}/{B} verified={verified}/{B}")
    if not blame_clean:
        bad.append(f"sign: an honest leg was blamed: {blame}")
    if k0 != (0, 0):
        bad.append(f"sign: K0 or its plain versions ran: {k0}")
    if bad:
        raise AssertionError(f"phase 33 ot_host: {bad}")


def main() -> int:
    t_script = time.perf_counter()
    os.environ[T0_ENV] = repr(time.monotonic())
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1024, help="sessions B")
    ap.add_argument("--eddsa-batch", type=int, default=EDDSA_B, help="EdDSA sessions")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    if not (ROOT / "mpcium_tpu_torch" / "ops" / "csrc" / "mulmod.cu").is_file():
        print("chip_smoke: mpcium_tpu_torch is not next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from mpcium_tpu_torch.cluster import load_test_preparams
    from mpcium_tpu_torch.core import bignum as bn
    from mpcium_tpu_torch.ops import modmul as mm
    from mpcium_tpu_torch.ops import mulmod as K

    card = smi()
    session_futures, t_submit = start_session_ecdsa(args.seed)
    t0 = time.perf_counter()
    K.build()
    build_s = time.perf_counter() - t0
    ptxas = ptxas_summary(K.build_log)
    emit({
        "phase": "env", "nvidia_smi": card, "torch": torch.__version__,
        "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
        "kernel_build_s": build_s, "ptxas": ptxas,
    })

    pre = load_test_preparams(2048)
    widths = kernel_vs_plain(1024, args.seed, pre, K, mm, bn)
    pm = powmod_vs_plain(1024, args.seed, pre, K, mm, bn)
    # phases 19, 24 and 25 overlap the phases from here on (after the kernel timings)
    life_future, soak_future, t_life = start_lifecycle(LIFECYCLE_B, args.seed, args.batch)
    serving_future, t_serving = start_serving(SERVING_W, args.seed)
    deploy_future, boot_future, t_deploy = start_deployment(DEPLOY_W, args.seed)
    golden_future, t_golden = start_goldens(args.seed)
    by_width, by_mode, shares, signer, measured = run_slice(args.batch, args.seed, pre, K)
    emit({
        "phase": "wrapper_host", "note": "launches in the warm sign x host ms "
        "per wrapper call at B=1024 (kernel_vs_plain, powmod_vs_plain)",
        "mulmod_s": sum(by_width.get(n, 0) * r["wrapper_host_ms_per_call"]
                        for n, r in widths.items()) / 1e3,
        "powmod_s": sum(by_mode[key] * pm[key + (eb,)]["wrapper_host_ms_per_call"]
                        for key, eb in POWMOD_PATH.items()) / 1e3,
    })
    ot_signer = run_ot_slice(args.batch, args.seed, shares, K)
    sha512_vs_hashlib(args.eddsa_batch, args.seed)
    ed25519_edges()
    eddsa_golden()
    ed_shares = run_eddsa_slice(args.eddsa_batch, args.seed, K)
    run_eddsa_party(min(EDDSA_PARTY_B, args.eddsa_batch), args.seed, ed_shares)
    dkg_shares = run_dkg_engine(DKG_B, args.seed, K)
    run_reshare_engine(RESHARE_B, args.seed, dkg_shares, K)
    run_eddsa_dkg(LIFECYCLE_B, args.seed, K)
    run_session_eddsa(args.seed)
    session = join_session_ecdsa(session_futures, t_submit)
    run_session_batch_sign(session, args.seed, K)
    run_profile(signer, shares, args.batch, args.seed, K, measured)
    run_ot_profile(ot_signer, shares, args.batch, args.seed)
    g36_engine = gg18_engine_runs(signer, shares, args.seed, K)
    g36_party = gg18_party_threads(args.seed, K)
    chaos, g36_rows = join_goldens(golden_future, t_golden)
    life = join_lifecycle(life_future, t_life)
    serving = join_serving(serving_future, t_serving)
    g36 = gg18_graphs_finish([serving["gg18_rows"], g36_rows], g36_party, g36_engine)
    emit({**g36, **serving["extra"]})
    check_gg18_graphs(g36)
    join_deployment(deploy_future, t_deploy, serving)
    warm_k0 = join_boot(boot_future, t_deploy)
    join_chaos_soak(chaos, soak_future, t_life)
    emit({"phase": "wall", "script_s": time.perf_counter() - t_script,
          "note": "from the start of main() to here"})

    kernels = []
    for n, rec in sorted(widths.items()):
        kernels.append({
            "name": f"mulmod_n{n}",
            "route": "cuda",
            "source": "mpcium_tpu_torch/ops/csrc/mulmod.cu",
            "replaces": "mpcium_tpu/ops/pallas_mulmod.py:91",
            "launches": (warm_k0["mulmod_launches_by_width"].get(str(n), 0) if n == 160
                         else life["mulmod_by_width"].get(n, 0)),
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["kernel_ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "bound_share": rec["bound_share"],
            "library_ms": None,
        })
    for (mode, n), eb in {**POWMOD_PATH, **POWMOD_WARM}.items():
        rec = pm[(mode, n, eb)]
        kernels.append({
            "name": f"powmod_{mode}_n{n}",
            "route": "cuda",
            "source": "mpcium_tpu_torch/ops/csrc/mulmod.cu",
            "replaces": "mpcium_tpu/ops/pallas_mulmod.py:91",
            "launches": (warm_k0["powmod_launches_by_mode_width"].get(f"{mode}/{n}", 0)
                         if (mode, n) in POWMOD_WARM else life["powmod_by_mode_width"][(mode, n)]),
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["kernel_ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "bound_share": rec["bound_share"],
            "library_ms": None,
        })
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        for pool in (_POOL, _SESSION_POOL, _LIFECYCLE_POOL, _SERVING_POOL, _DEPLOY_POOL,
                     _GOLDEN_POOL):
            if pool is not None:
                pool.shutdown(cancel_futures=True)
    sys.exit(rc)
