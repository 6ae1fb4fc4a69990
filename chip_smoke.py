#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

1. Card: name and power limit (nvidia-smi), torch and CUDA versions.
2. Build: the three CUDA kernels from src/repro_torch/kernels/csrc, one
   nvcc each, started together, while phase 3 draws and tiles the store.
3. Main-path store: SPE of an R-MAT graph (Graph500 a, b, c = 0.57, 0.19,
   0.19) at SCALE 22, edge factor 16 — 4,194,304 vertices, 67,108,864
   edges — in tiles of 2^20 edges, unweighted, disk mode 1.  The edges
   are drawn and the tiles built on up to 8 threads (synth.rmat_edges and
   spe.preprocess_arrays with ``threads``: the same edges and store bytes
   as one thread).
4. Kernels against their plain PyTorch versions on the card:
   - the row-length histogram (longest row; shares of rows with <= 1,
     <= 4, <= 32 edges) of the largest tile and of the merged dst list;
   - the segment kernel's order: its sum at the largest tile's shape,
     Q = 1 and Q = 8, equals bit for bit the fused kernel's with the
     identity apply (affine, alpha 0, beta 1, no base, num_rows = row_cap,
     so the sink row of padding edges is reduced too — through the hub
     launch when it holds two multiples of 256 edges);
   - the segment kernel at the largest tile's shapes (sum/min/max, Q in
     {1, 3, 4, 8}, sorted and unsorted dst, int32; a contrib view 4 bytes
     into its storage and ids out of range at both ends, -1 first and
     >= R last, at Q = 3 and 8) and once (sum) at the merged mode's shape
     (the server's 67,108,864 real edges, V + 1 rows);
   - ROADMAP C.1's reproducer: int32 min and max with contributions from
     randint(-1000, 1000) over a skewed list (2^17 rows of Zipf(1.8)
     lengths capped at 4,000, rows of 50,000, 9,000, 4,097, 3,000, 1,025,
     600 and 513 edges, 20,000 padding edges at dst = R; R + 1 rows) at
     every legal (block_e, block_r), each equal to the plain version, and
     timed at the default blocks; then the segment kernel's row and hub
     launches timed apart under torch.profiler for int32 sum, min and max
     at the largest tile (ROADMAP B.5);
   - the fused kernel at the largest tile's shapes and num_rows (the four
     single-query fused specs, PPR's spec with its per-query base, and a
     weighted spec with both edge streams; Q in {1, 4, 8}, and Q = 9 for
     the BFS spec, MultiSourceBFS after an admission), against the
     plain version and, bit for bit on new and updated, against the
     merged-mode composition: the program's gather in PyTorch, the
     segment kernel over rows [0, num_rows), the program's apply and
     updated_mask in PyTorch;
   - the same on a tile whose padding would be a hub row: the largest
     tile with num_rows cut so that its last PAD_HUB_EDGES real edges and
     the padding all point at num_rows (PageRank and BFS specs, Q = 1, 8);
   - the compact kernel at V = 4,194,304 with K = sparse_capacity(V)
     (densities 0, 1e-3, 0.05, 0.399; 0.6, where more than K are set and
     the first K are kept; int32 values; a fill index of 7; a mask view
     one byte into its storage), at V = 4,194,303, at V = 2^25, density
     0.01 (past the TPU kernel's 2^24 bound), with K = 0, and with K > V.
   Min, max, integers and compaction must be equal (compact: indices and
   value bits), sums within rtol=1e-5, atol=1e-6 (another order of
   summation); the fused kernel's updated mask must equal the plain
   version's (for sums, on every entry whose change is farther than that
   tolerance from update_tol) and leave rows past num_rows untouched.
   Each case is timed with CUDA events (L2 flushed before each launch,
   median of 10; the device spins ~0.5 ms before each call that does not
   synchronise with the host, so host enqueue time is not counted) beside
   the plain version (and, for the fused kernel, the merged-mode
   composition), one PyTorch call that computes
   the same function where there is one (scatter_reduce; for compact
   torch.nonzero plus a gather, which synchronises with the host, and
   also the whole function in PyTorch: torch.full of the K slots, then
   nonzero, truncation to K and the gather), and its bound (bytes over
   3.35 TB/s, flops over 67 TFLOP/s: roofline/hw.py's datasheet rates;
   the fused kernel's counts the real
   edges and base over num_rows rows only, the work its function needs).
5. Main path: OutOfCoreEngine(store, device="cuda", seg_impl="fused") runs
   PageRank for 5 supersteps (against a float64 power iteration,
   rtol=1e-4: float32 against float64), BFS from vertex 0 to convergence
   (equal to a level-synchronous BFS) and InDegree for 1 superstep
   (equal to np.bincount).  The PageRank, BFS and PPR references of
   phases 5, 8, 12, 16 and 18 are plain PyTorch over the edge list on the
   card (ref_pagerank, ref_bfs, ref_ppr: gathers and index_add_, no code
   of the port), in place of numpy and scipy on the host.
6. Compact path: ops.compact over the sparse broadcast of each BFS
   superstep of phase 5 (the vertices it updated, their levels),
   K = sparse_capacity(V); equal to numpy's nonzero.
7. One PageRank superstep under torch.profiler: device busy share and the
   kernels' device time.  Phases 7, 8 and 10, PageRank in 11 and the
   reference and out-of-core runs of 12 run with tile skipping off: on
   R-MAT it skips no tile and never changes a result, and its filter
   build is most of a superstep 0 (8-21 s).
8. Batched apps at Q = 8 on the same store, seg_impl="fused", tile
   skipping off (phase 12's in-memory session runs it on): sources are
   vertex 0 and seven vertices drawn with numpy from SEED among those with
   out-degree > 0.  MultiSourceBFS to convergence (each column equal to
   the reference BFS from its source, column 0 equal to phase 5's BFS);
   LandmarkDistances on the unweighted store (edge weight 1.0, the b
   stream), equal to MultiSourceBFS with equal per-query supersteps;
   PersonalizedPageRank for 3 supersteps against a float64
   power iteration with the same update gate (|new - old| > update_tol):
   relative error <= 1e-4 on entries >= 1e-6 and L1 error <= 1e-5 per
   column.  An entry whose change in some superstep lies within float32
   rounding of update_tol takes it in one iteration and not the other,
   and differs by about update_tol (1e-9, which is 1e-3 of a 1e-6 entry):
   such gate flips may exceed the relative limit, each by at most
   update_tol per superstep, in at most 1e-4 of the entries.  Column 0
   equal bit for bit to a Q = 1 PPR run.
9. Modes: PageRank (5 supersteps) and MultiSourceBFS (Q = 8, to
   convergence, so retirement shrinks Q from 8 to 1) with engine_mode
   "stacked", "merged" and pipeline=True, tile skipping off so every
   superstep runs in the mode; each equal bit for bit to the tiled runs
   of phases 5 and 8, per-query supersteps too (tile skipping never
   changes a result).
10. One MultiSourceBFS superstep at Q = 8 under torch.profiler.
11. Out-of-core vertex state ("ooc") on the same store, with
    num_intervals = OOC_INTERVALS: the engine cuts the vertices into
    intervals aligned to tiles and computes each tile's source footprint
    as it loads the tile (timed once over all tiles); PageRank for
    OOC_PR_SUPERSTEPS = 2 supersteps (cut from 5, then 3, to keep the run
    inside its time limit) under an 8 MiB vertex budget (superstep 1 profiled:
    H2D bytes of the sharded step, copy and kernel device time, the host
    gather and writeback) and InDegree for 1 under 8 MiB; each equal bit
    for bit to the in-memory tiled run of as many supersteps, with 64
    kernel calls a superstep, faults, spills and dirty intervals (the
    budget binds), and its ms a superstep beside the tiled run's.
    MultiSourceBFS at Q = 8 under 32 MiB is the first two supersteps of
    phase 12's out-of-core session.
12. Mid-run admission ("admission"): a MultiSourceBFS session at Q = 8
    whose admit_plan brings a ninth source in after superstep 1 (Q = 9
    at superstep 2, 64 fused calls; the ninth source is drawn among
    vertices whose out-neighbours are all sinks, so its column retires
    after its second superstep), query 1 drained after superstep 2 and a
    tenth source admitted through admit() once a column has left; to
    convergence in memory, each admitted column equal to a fresh
    single-query run with equal per-query supersteps, the drained one
    to the reference BFS levels up to 3 with -1, the other originals to phase
    8's Q = 8 run; its first ADMIT_OOC_SUPERSTEPS = 2 supersteps (Q = 8,
    8 and the ninth query's admission at the barrier of superstep 1; cut
    from 3, whose Q = 9 superstep took 78-103 s: the Q = 9
    superstep, the drain, the ninth query's retirement and the tenth's
    admission are checked in memory here) in memory and
    under a 32 MiB budget equal bit for bit,
    the latter with 64 fused calls a superstep and its budget binding.
    Device bytes outside torch's allocator (the CUDA context and the
    kernels' code; the hub launch's scratch is taken from torch's
    allocator by the wrappers) are logged around each superstep and each
    phase 4 fused case, and must not grow at phase 4's first Q = 9 call:
    this process's bytes as NVML counts them (libnvidia-ml.so.1 through
    ctypes; other processes on the card do not move them) less torch's
    reserved bytes, the whole card's figure logged beside them.
13. Device mesh ("mesh"): DistributedGABEngine over a process group of
    world size 1 on NCCL, all 64 tiles resident on the card: PageRank
    for 5 supersteps in dense, sparse and hybrid comm (in sparse, the
    overflow guard sends every superstep past the capacity dense,
    superstep 0 among them) and MultiSourceBFS at Q = 8 in hybrid to
    convergence (its late supersteps take the sparse branch: the
    compact kernel over the 2^25-cell mask, an all_gather, an index
    put), each equal bit for bit to the tiled run of phases 5 and 8;
    then world size 2 on gloo with CUDA tensors, two spawned ranks on the
    one card: a sparse collective on 2^20 cells equal to the merge, and
    PageRank in hybrid equal to the tiled run (if this torch's gloo
    refuses CUDA tensors, a line says so and the run goes on).
14. Cluster ("cluster"): launch.cluster.run_cluster on the card at N = 2
    and N = 4 (spawned ranks sharing the one card, shm transport,
    hybrid frames, tile skipping off), one launch per N over PageRank
    and MultiSourceBFS at Q = 8 whose admit_plan brings phase 12's ninth
    source in after superstep 1, both for 5 supersteps: every rank's
    values, supersteps, per-query supersteps and (admitted, retired,
    updated) per superstep equal one process bit for bit, wire bytes
    equal across ranks.  Each rank reports its seconds, kernel
    launches, torch memory and the card's bytes in use, and the
    exchange's seconds (encode and compress, send, wait for peers,
    decode, merge) per app.
15. Checkpoints ("checkpoint"), each part against its uninterrupted run
    bit for bit, with every boundary checkpointed (each save's seconds,
    bytes written and hardlinked, interval blocks written and
    hardlinked, and each load's seconds logged): (a) tiled PageRank
    crashed (InjectedFault) at the start of superstep 3 and resumed by a
    fresh engine to 5 supersteps, equal to phase 5's run, its history
    the resumed supersteps only; (b) MultiSourceBFS at Q = 8 with phase
    12's ninth source admitted after superstep 1, preemptible, SIGTERM
    at the barrier of superstep 2 (Preempted at boundary 3), resumed to
    5 supersteps, equal to phase 14's one-process run (values and
    per-query supersteps); (c) out-of-core PageRank at 8 MiB, 3
    supersteps (cut from 5: each is ~21 s), crashed at superstep 2, its
    checkpoints interval blocks (the codec sniffed: zlib without
    zstandard), the second hardlinking the unchanged ones, equal to the
    in-memory run of 3 supersteps; (d) run_cluster on the card, N = 4
    spawned ranks, PageRank for 5 supersteps, rank 3 killed (os._exit)
    at the barrier of superstep 2, on_failure="shrink": one restart on
    3 ranks on the remapped saved assignment, rank 0 equal to phase 5's
    run, the ranks to each other; the kill (its once-marker's time) to
    the new attempt's first boundary checkpoint is logged.
16. Online query service ("serve"): serve/graph_service.py's
    GraphService on the card (device cuda, seg_impl "fused", tile
    skipping off, q_slots 8, min_fill 4, max_wait 50 ms, tenants alice:3
    and bob:1, a result cache of 64) behind serve/http.py's HttpFrontend
    on 127.0.0.1:0, the serve loop on its own thread; client threads POST
    and poll GET /v1/query/<rid>.  Wave 1: MultiSourceBFS from phase 8's
    eight sources and LandmarkDistances from two new seeds drawn from
    SEED; wave 2: LandmarkDistances from two more and MultiSourceBFS from
    the unused vertex of largest out-degree with a 1 ms deadline; wave 3:
    repeats of three finished seeds.  Every done column (decoded from its
    HTTP body) equals the reference BFS levels with the per-query supersteps of
    its depth, the sources' equal phase 8's direct batched run bit for bit
    with equal per-query supersteps; the deadline query ends "timeout"
    with a partial BFS column that is not cached; the repeats are cache
    hits that open no session, run no superstep and take no slot.  Then
    the drain: /healthz and POST answer 503 with Retry-After, every rid
    still answers GET.  Logged: p50/p99 latency, the mean queue and
    service ms, queries/s, supersteps, sessions, the (program, Q) of every
    fused launch, and torch's allocated and reserved bytes and the bytes
    outside torch's allocator after each closed session; the fused kernel
    is held to its plain version and the merged-mode composition at every
    (program, Q) the service launched it at.

17. Kernel tuner ("tune"): (a) roofline/hw.py's measured figures
    measured again and logged beside the table's (calibrate_tuner);
    (b) at the largest tile's shape, the fused kernel with the PageRank
    spec at Q = 1 and 8, the BFS spec at Q = 1, 8 and 9 and the
    landmarks spec at Q = 2 and 8, and the segment sum at Q = 1 and 8,
    each at every legal (block_e, block_r): new and updated (out) equal
    to the default blocks' bit for bit, each timed as phase 4 times,
    beside roofline/kernel_tune.py's prediction, and the pick's time
    over the best measured time; (c) EngineConfig(kernel_autotune=True):
    tiled PageRank for 5 supersteps equal to phase 5's run,
    MultiSourceBFS Q = 8 tiled and pipelined (the tuner's stack size) to
    convergence equal to phase 8's run, bit for bit, each launching the
    fused kernel.
18. Baselines ("baselines"): core/baselines.py's four engines (Pregel+,
    PowerGraph, GraphD, Chaos) on the main store's graph on the card,
    PageRank for 2 supersteps each, against a float64 power iteration
    (rtol=1e-4); ms a superstep beside the tiled engine's (phase 5).
19. Language-model serving ("lm serve"), float32, parameters from the
    port's seeded LM.init, TF32 off: (a) qwen3-1.7b at full width (28
    layers, d_model 2,048, padded vocab 152,064) through
    launch/serve.py:main at the CLI's defaults (16 requests, 4 slots, 16
    new tokens, prompts of 16, max length 256): every completion has 16
    tokens, requests 0 and 5 served alone in a 1-slot engine give the
    same greedy tokens, and decode_step's logits for a 24-token sequence
    (23 prefilled) match the full forward's last within LM_LOGITS_ATOL;
    (b) gemma2-2b at full width (26 layers LG, window 4,096, vocab
    256,000): one prompt of 4,160 tokens prefilled at q_chunk = kv_chunk
    = 512, then 8 greedy decode steps; the prefill's and every decode
    step's logits match the full forward over the prompt and the decoded
    tokens within LM_LOGITS_ATOL, so the rolling window cache is held at
    full width; (c) logged: prefill ms, ms a decode step, tokens/s, the
    card's bytes in use and torch's peak.  This path runs no kernel of the
    graph engine: its counts are read and logged as zero.
20. Language-model training ("lm train"), float32, TF32 off, on the card:
    (a) qwen3-1.7b at full width through launch/train.py:main with
    ``--arch qwen3-1.7b --steps 20 --batch 8 --seq 128 --log-every 5``
    (remat "block", AdamW with the CLI's schedule, no checkpoints): every
    loss finite, the mean of the last 5 at least LM_TRAIN_DROP below the
    first 5's (tests/test_train_ckpt.py's criterion); logged: ms a step
    over steps 2+ (host clock around each step, synchronised), tokens/s,
    the model FLOPs of a step (6 · params · tokens) and their share of
    the card's float32 peak (roofline/hw.py), torch's peak and the card's
    bytes in use; (b) the training invariants at the reduced qwen3-1.7b
    (``reduced``: a checkpoint of the whole train state is ~20.6 GB at
    full width) through build_train_step on the card: 10 straight steps
    against a job that checkpoints every 2 steps (the reference's tree,
    model_zoo.export_state), fails at step 5 (FailureInjector), restores
    step 4 and finishes, equal bit for bit; microbatch 2 against 1 over 3
    steps within LM_TRAIN_MB_TOL; bf16 and top-k compression over 15
    steps, the loss falls and top-k's density is at most 0.05.  This path
    runs no kernel of the graph engine: its counts are read and logged as
    zero.
21. The other model families ("lm families"), float32, TF32 off, on the
    card, parameters from each model's seeded init on the card: (a) at
    the reference's full configs, a 24-token sequence, 23 prefilled and
    the last decoded, against the full forward's last logits within
    LM_LOGITS_ATOL, then 3 more greedy decode steps timed, for
    recurrentgemma-9b (38 layers RRL, 9.40 B parameters), rwkv6-1.6b,
    whisper-base (through serve_step.build_serve_fns with 12 seeded
    enc_frames) and granite-moe-1b-a400m at moe_capacity_factor 8 (at
    the default capacity decode and the full forward drop different
    assignments); then rwkv6-1.6b through launch/serve.py:main at its
    defaults, requests 0 and 5 alone in a 1-slot engine equal to the
    batched tokens; (b) at full width with the depth cut (``reduced``):
    dbrx-132b at 2 layers of 40 (capacity factor 8) and internvl2-76b at
    4 of 80 with its 256 seeded patch_embeds before the tokens (decoded
    at cache_len 256 + 23), the same check; (c) granite-moe-1b-a400m at
    full width through launch/train.py:main with ``--steps 20 --batch 8
    --seq 128 --log-every 5``, the criterion of phase 20 (a), its ms a
    step, tokens/s, 6 · active params · tokens as a share of the float32
    peak and torch's peak; then at the reduced granite-moe (8 x 256
    tokens a batch, so that the MoE gathers' backward takes the sorted
    path too): 10 straight steps against a job failing at step 5 and
    resumed from step 4, bit for bit over every leaf (the expert combine
    and both gathers' backward have no float atomics); and the
    train-then-serve chain of tests/test_system.py::test_lm_train_then_serve
    through both CLIs.  ms a prefill and a decode step, tokens/s and
    torch's peak are logged for each arch.  This path runs no kernel of
    the graph engine: its counts are read and logged as zero.
22. The language models over a device mesh ("lm mesh"), float32, TF32
    off: a process group of one rank (NCCL) and a (1, 1) ("data",
    "model") mesh, every parameter a DTensor.  (a) Phase 20 (a)'s job,
    its first LM_MESH_STEPS steps on its schedule, through
    train_step.build_train_step(mesh=...), fsdp and ZeRO-1: its state
    made leaf by leaf (model_zoo.init_on_mesh; m and v as zero shards),
    every parameter's shard equal bit for bit to phase 20 (a)'s whole
    init(0) on the card and m and v zero, the largest tensor the init
    made at most the largest leaf (torch's peak over the init); its
    losses against phase 20 (a)'s first within LM_TRAIN_MB_TOL, ms a step
    beside phase 20 (a)'s, torch's peak; (b) qwen3-1.7b through
    serve_step.build_serve_fns(mesh=...), batch 4, 23 prefilled and 1
    decoded, KV heads and then the sequence over "model": the logits
    against the full forward within LM_LOGITS_ATOL and the mesh-free
    functions' within LM_MESH_SERVE_ATOL, 3 decode steps timed, then one
    more under torch.profiler (wall, device busy, host ops) beside the
    mesh-free one's; (c) at the reduced config: a mesh job failed at step
    5 and resumed against 10 straight steps, runtime/elastic.reshard off
    the mesh and back and rescale_via_checkpoint, each bit for bit, and
    seq_sharded_decode_attention at one shard within LM_MESH_FLASH_ATOL of
    decode_attention.  Its counts are read and logged as zero.  The
    process group is destroyed at the phase's end.
23. The dry run, roofline and report tools ("lm dryrun"): (a) five cells
    of launch/dryrun.py at full width and the reference's production
    shapes, each ``python -m repro_torch.launch.dryrun --arch A --cell C
    --mesh M`` in a process of its own (DryRuns), all started together
    after phase 7, beside phases 8-10 and the side processes, and
    joined in phase 23 (on the H100 machine, started beside phases 19-22
    instead, they made the smoke 825.5 s against 695.8 s: phase 23
    waited 108.2 s for them): qwen3-1.7b train_4k, prefill_32k (its
    depth cut to 2 of 28 layers: 64 q chunks a layer) and
    decode_32k on the single mesh (16 x 16, a fake process group of 256
    ranks) and decode_32k on the multi mesh (2 x 16 x 16, 512), and
    granite-moe-1b-a400m train_4k on the single mesh (the MoE dispatch); each on fake CUDA tensors (nothing allocated), status
    ok, every roofline term above 0 and the peak bytes a device below the
    card's 80 GiB (roofline/hw.py), and each cell's useful FLOPs ratio
    and dot FLOPs a device (hlo_cost.dot_flops of its op record) logged
    beside the ratio before ROADMAP C.4 (LM_DRYRUN_C4_USEFUL),
    qwen3-1.7b train_4k at LM_DRYRUN_MIN_USEFUL or above (each rank
    computes only its own heads, hidden columns and vocab); then
    launch/report.py over their directory.  Beside them, in one more
    process, dryrun.rank_shares (ROADMAP C.5): reduced gemma2-2b,
    granite-moe, rwkv6-1.6b, recurrentgemma-9b and whisper-base train_4k
    (batch 4 x 32) on fake (1, 1), (2, 2) and (1, 4) meshes, each mesh's
    dot FLOPs a device times its ranks within LM_SHARE_RTOL of (1, 1)'s,
    logged beside the ratios before C.5 (LM_SHARE_BEFORE_C5); reduced
    qwen3-1.7b with 6 query heads on them, no rank's attention bmm over
    ceil(6 / model ranks) heads, and its 8-head twin (LM_SHARE_TWIN): on
    (1, 4) the two hand collectives the same bytes and ops a rank, the 6
    heads' projections split by whole heads (ROADMAP C.6).  (b) hlo_cost.run around phase 20 (a)'s qwen3-1.7b train
    step (8 x 128 tokens, no mesh) and around one phase 19 (a) decode
    step (4 slots of 256, cache length 16) on the card, and the same
    functions on fake tensors of the same shapes: FLOPs, bytes and fused
    bytes equal (else the ops that differ are named); each timed on the
    card (CUDA events, the mean of LM_DRYRUN_REPS calls after a warm one)
    beside analysis.roofline's step_s_bound of its count, which it must
    not beat.  Its counts are read and logged as zero.
24. The language models at the reference's compute dtype ("lm bf16"):
    compute_dtype "bfloat16" and otherwise the RunConfig that
    registry.default_run_config gives each cell on one device, the
    card's products as the reference's dots (models/layers.py:
    exact_matmuls: no TF32, bfloat16 partial sums in float32).  (a) The
    reduced qwen3-1.7b and granite-moe-1b-a400m at LM_BF16_PARITY (4 x
    64, the train_4k RunConfig with its chunks cut to the sequence:
    microbatch 2, remat "block"), the same parameters and batch on the
    card and on the CPU: train_step.model_loss_fn's loss within
    LM_BF16_LOSS_ATOL and every gradient leaf within LM_BF16_GRAD_REL of
    its largest magnitude (tests/test_torch_train_grads.py's bounds
    against the reference), the full forward's logits within
    numerics.LOGITS_ATOL (tests/test_torch_models.py's); then one
    bfloat16 GEMM at the MLP's
    wo shape of a train_4k microbatch with cuBLAS's reduced-precision
    reduction on and off, its largest error against float64 and its ms.
    (b) qwen3-1.7b served in bfloat16 (a bfloat16 KV cache) at phase 19
    (a)'s shapes and requests through a ServeEngine that keeps the logits
    it samples from: a batched slot's logits against the same request
    alone in a 1-slot engine, at every step up to the first token that
    differs, and decode_step's logits against the full forward's, each
    logit within the larger of numerics.LOGITS_ATOL and LOGITS_ULPS
    bfloat16 ulps of its row's largest magnitude (models/numerics.py:
    bf16_logits_err, shared with the CPU tests; the tests' bound is
    about four ulps at the reduced models' 0.7, and at full width a logit
    near 0 carries the rounding of a row whose largest pass 8, where one
    ulp is 0.0625), both forwards logged against the float32 forward of
    the same parameters (bfloat16's own error); tokens are
    recorded, not asserted (random-init logits are near-tied and bfloat16
    can flip a greedy choice); prefill ms, ms a decode step, tokens/s and
    torch's peak logged beside phase 19 (a)'s float32 figures, and one
    batched decode step under torch.profiler (device busy, the casts'
    and the products' device ms).  (c) qwen3-1.7b's train_4k at its own
    RunConfig (microbatch 2, remat "block", chunks of 512), 2 x 4,096
    tokens, 6 steps: every loss finite; the first step counted on the
    card (hlo_cost.run) and held to dryrun.count of the same cell on fake
    tensors (in DryRuns' side process: lm_bf16_fake_counts): ops, FLOPs,
    bytes and fused bytes equal, ms a step (steps 2+) not below
    analysis.roofline's bound of the count; logged: ms a step, tokens/s,
    6 · params · tokens as a share of the bfloat16 peak, torch's peak
    beside the dry run's.  (d) qwen3-1.7b's decode_32k through
    serve_step.build_serve_fns at batch 4 against a 32,768-token bfloat16
    cache (15.0 GB) filled with seeded values, at cache length 32,767:
    logits finite, counts equal card vs fake, the median of
    LM_DRYRUN_REPS steps (CUDA events) not below the bound, beside the dry
    run's bound of the cell.  (e) granite-moe-1b-a400m's train_4k at 2 x
    4,096, 3 steps as (c); then the reduced granite-moe in bfloat16 at
    LM_FAMILY_RESUME_BATCH (the train_4k RunConfig, chunks of 256) failed
    at step 5 and resumed against 10 straight steps, bit for bit in every
    leaf.  Its counts are read and logged as zero.
25. The other eight language models at the reference's compute dtype
    ("lm bf16 families"), each at the RunConfig of phase 24 with the
    bounds of models/numerics.py (the CPU tests' rules): (a) the reduced
    gemma2-2b, deepseek-7b, qwen3-14b, recurrentgemma-9b, rwkv6-1.6b,
    whisper-base (its encoder frames), internvl2-76b (its patch
    embeddings) and dbrx-132b at LM_BF16_PARITY, the same parameters and
    batch on the card and on the CPU (the CPU's half in a side process,
    lm_bf16_family_cpu, started after phase 7): the loss within
    LM_BF16_LOSS_ATOL, each gradient leaf within LM_BF16_GRAD_REL of its
    largest magnitude, the full forward's logits within the per-row
    bound, for dbrx but where a near-tie router flip moved a token
    (numerics.FlipTracker: at most 1 in 32 tokens, each flip within 2
    ulps of its row's largest router logit; logged).  (b) Served at full
    width in bfloat16 with a bfloat16 cache (lm_family_decode):
    recurrentgemma-9b, rwkv6-1.6b, whisper-base,
    granite-moe (capacity 8), dbrx-132b at 2 layers, internvl2-76b at 4,
    deepseek-7b and qwen3-14b at full depth (a model whose float32 masters
    would pass LM_BF16_PEAK_CAP is cut in depth, listed in "reduced"),
    decode against the full forward within the per-row bound, torch's
    peak under LM_BF16_PEAK_CAP; gemma2-2b past its window as phase 19
    (b) (lm_window_decode); rwkv6-1.6b at the serve CLI's defaults, two
    requests alone against their batched slots (lm_bf16_engine): in an
    engine of as many slots equal bit for bit, in a 1-slot engine the
    prefill equal and decode step i within LM_BF16_ALONE_ULPS * sqrt(i)
    ulps of the row's largest |logit| (lm_bf16_alone); prefill
    ms, ms a decode step, tokens/s and torch's peak beside the float32
    figures of phases 19 (b) and 21 of the same run.  (c) whisper-base's
    train_4k at its own RunConfig, 2 x 4,096 decoder tokens (2,048
    encoder frames), 3 steps as phase 24 (c): losses finite, the first
    step counted on the card equal to dryrun.count on fake tensors (among
    phase 24's, LM_BF16_COUNTS), measured not below the bound.  Its
    counts are read and logged as zero.

Phase 11, the out-of-core part of 12 ("admission ooc", admission_ooc)
and part c of 15 (checkpoint_ooc) run in three spawned side processes
(Side), started after phase 7 and joined after phase 10: each is host
work that leaves the card idle, so they run on other cores beside phases
8-10, whose times (and theirs) are taken with the others running.  A
side's kernels count in its process and report; its lines are logged
when it is joined.

Phases 5, 6, 8, 9, 11, 13, 14, 16, 17c, 19, 20, 21, 22, 23, 24 and 25, the
in-memory session of 12 and its out-of-core session ("admission ooc")
and each part of 15
("checkpoint" sums a and b, then "checkpoint ooc", "cluster restart") set
every kernel's launch counter to 0 just before and read it just after
(the cluster ranks and phase 13's gloo ranks count in their processes
and report); each must have launched the kernels it runs.  The
``{"kernels": [...]}`` line gives, per kernel and case, the launches
summed over those phases, the launches by phase ("launches_by_path") and
the case's times: segment sum at the largest tile for Q = 1 and Q = 8 and
at the merged shape, int32 min and max on C.1's skewed list, the fused
PageRank spec at Q = 1 and Q = 8, BFS spec
at Q = 9 and the serve path's most launched (program, Q) (with
"composition_ms"), compact at V = 4,194,304, density 0.05 and at V = 2^25
(the "case" key names it), and each phase 17 case at its tuned blocks.
Then, as its last line,
``{"ok": true, "device": {...}}``.  Any failed check raises; without a CUDA
device, or without the repository beside it, it exits non-zero before
printing a result.  Details go to build/chip_smoke.json.  Each phase's
end also goes to stderr with the seconds so far, and a run still going
after WATCHDOG_S seconds prints every thread's stack there.
"""
import faulthandler
import gc
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SCALE = 22
EDGE_FACTOR = 16
TILE_SIZE = 1 << 20
SEED = 0
PR_SUPERSTEPS = 5
PPR_SUPERSTEPS = 3           # cut from 5 in PR 16 to make room for 11-12
BFS_MAX_SUPERSTEPS = 40
NUM_QUERIES = 8
SUM_TOL = dict(rtol=1e-5, atol=1e-6)
SPIN_CYCLES = 1_000_000      # ~0.5 ms of device clock before each timed call
PR_RTOL = 1e-4
PPR_MIN_ENTRY = 1e-6
PPR_L1 = 1e-5
PPR_MAX_FLIP_SHARE = 1e-4
PAD_HUB_EDGES = 20000        # real edges turned into padding (phase 4)
SKEWED_ROWS = 1 << 17        # ROADMAP C.1's skewed int32 list (phase 4)
OOC_INTERVALS = 16           # interval plan of the out-of-core runs
OOC_PR_BUDGET = 8 << 20      # PageRank / InDegree vertex budget, bytes
OOC_PR_SUPERSTEPS = 2        # out-of-core PageRank (each ~20-27 s)
OOC_MSBFS_BUDGET = 32 << 20  # MultiSourceBFS (Q = 8 and 9) vertex budget
DRAIN_AT = 2                 # admission: drain query DRAIN_QID after this
DRAIN_QID = 1                # superstep
BASELINE_SUPERSTEPS = 2      # each baseline engine's PageRank (phase 18)
LM_SERVE_ARCH = "qwen3-1.7b"  # phase 19 (a): through the serve CLI
LM_SINGLE_RIDS = (0, 5)      # requests rerun alone in a 1-slot engine
LM_WINDOW_ARCH = "gemma2-2b"  # phase 19 (b): a prompt past the window
LM_WINDOW_PROMPT = 4160
LM_WINDOW_DECODE = 8
LM_WINDOW_CHUNK = 512        # q_chunk = kv_chunk of (b)
LM_LOGITS_ATOL = 2e-3        # decode vs full-forward logits, float32
LM_TRAIN_ARCH = "qwen3-1.7b"  # phase 20 (a): through the train CLI
LM_TRAIN_ARGV = ("--steps", "20", "--batch", "8", "--seq", "128",
                 "--log-every", "5")
LM_TRAIN_DROP = 0.2          # first 5 losses' mean - last 5's, at least
LM_TRAIN_MB_TOL = dict(rtol=2e-4, atol=2e-5)  # microbatch 2 vs 1, 3 steps
LM_FAMILY_FULL = (                # phase 21 (a): (arch, config overrides)
    ("recurrentgemma-9b", {}), ("rwkv6-1.6b", {}), ("whisper-base", {}),
    ("granite-moe-1b-a400m", {"moe_capacity_factor": 8.0}))
LM_FAMILY_CUT = (                 # phase 21 (b): full width, depth cut
    ("dbrx-132b", {"num_layers": 2, "moe_capacity_factor": 8.0}),
    ("internvl2-76b", {"num_layers": 4}))
LM_FAMILY_SEQ = 24                # 23 prefilled, the last decoded
LM_FAMILY_TIMED = 3               # greedy decode steps timed after it
LM_FAMILY_SERVE_ARCH = "rwkv6-1.6b"   # phase 21 (a): through the serve CLI
LM_FAMILY_TRAIN_ARCH = "granite-moe-1b-a400m"  # phase 21 (c)
LM_FAMILY_RESUME_BATCH = (8, 256)  # reduced granite-moe: 4,096 assignments
LM_MESH_SHAPE = (1, 1)            # phase 22: ("data", "model"), NCCL
LM_MESH_STEPS = 10                # (a): phase 20 (a)'s first steps (cut
                                  # from its 20 to keep the run in time)
LM_MESH_SERVE = dict(batch=4, max_len=256)  # phase 22 (b)
LM_MESH_SERVE_ATOL = 1e-5         # mesh vs mesh-free build_serve_fns logits
LM_MESH_FLASH_ATOL = 1e-6         # seq_sharded vs decode_attention
LM_DRYRUN_JOBS = (                # phase 23 (a): (arch, cell, mesh, layers)
    ("qwen3-1.7b", "train_4k", "single", None),
    # at 28 layers the count ran past 900 s on one core of the H100
    # machine's host while attention looped over its 2,080 causal chunk
    # pairs a layer (it reads a kv chunk once for them all now), so the
    # depth is cut
    ("qwen3-1.7b", "prefill_32k", "single", 2),
    ("qwen3-1.7b", "decode_32k", "single", None),
    ("qwen3-1.7b", "decode_32k", "multi", None),
    ("granite-moe-1b-a400m", "train_4k", "single", None))
LM_DRYRUN_C4_USEFUL = {          # phase 23 (a): the useful FLOPs ratio
    ("qwen3-1.7b", "train_4k", "single"): 0.131,      # of each cell while
    ("qwen3-1.7b", "prefill_32k", "single"): 0.0438,  # every rank of the
    ("qwen3-1.7b", "decode_32k", "single"): 0.0183,   # model axis ran
    ("granite-moe-1b-a400m", "train_4k", "single"): 0.0702}  # whole
LM_DRYRUN_MIN_USEFUL = {          # heads, vocab and some products
    ("qwen3-1.7b", "train_4k", "single"): 0.45}       # (ROADMAP C.4)
LM_SHARE_ARCHS = ("gemma2-2b", "granite-moe-1b-a400m", "rwkv6-1.6b",
                  "recurrentgemma-9b", "whisper-base")   # phase 23: C.5
LM_SHARE_HEADS = ("qwen3-1.7b", 6)    # query heads not dividing 4 ranks
LM_SHARE_TWIN = ("qwen3-1.7b", 8)     # its twin whose heads divide: C.6
LM_SHARE_RTOL = 0.005             # dot FLOPs x ranks vs (1, 1)
LM_SHARE_BEFORE_C5 = {            # (2, 2), (1, 4) before C.5, on the CPU
    "granite-moe-1b-a400m:0": (1.0043, 1.0129),
    "rwkv6-1.6b:0": (1.02, 1.18), "qwen3-1.7b:6": (1.0, 1.3214)}
LM_DRYRUN_TIMEOUT_S = 1000        # each cell, from the start of them all
LM_DRYRUN_REPS = 5                # phase 23 (b): timed calls after a warm one
LM_BF16_ARCH = "qwen3-1.7b"       # phase 24 (a)-(d): bfloat16
LM_BF16_MOE_ARCH = "granite-moe-1b-a400m"  # phase 24 (a), (e)
LM_BF16_LOSS_ATOL = 1e-3          # loss and gradient leaves against the
LM_BF16_GRAD_REL = 5e-2           # CPU (tests/test_torch_train_grads.py)
LM_BF16_PARITY = (4, 64)          # (a): reduced, batch x seq
LM_BF16_TRAIN_BATCH = 2           # (c), (e): 2 x 4096, a sequence a microbatch
LM_BF16_TRAIN_STEPS = 6           # (c)
LM_BF16_MOE_STEPS = 3             # (e)
LM_BF16_DECODE_BATCH = 4          # (d): against a 32,768-token cache
LM_BF16_TRAIN_ARCH = "whisper-base"  # phase 25 (c): train_4k at full width
LM_BF16_COUNTS = (                # (c)-(e), 25 (c): on fake tensors, beside
                                  # the card
    (LM_BF16_ARCH, "train_4k", LM_BF16_TRAIN_BATCH),
    (LM_BF16_ARCH, "decode_32k", LM_BF16_DECODE_BATCH),
    (LM_BF16_MOE_ARCH, "train_4k", LM_BF16_TRAIN_BATCH),
    (LM_BF16_TRAIN_ARCH, "train_4k", LM_BF16_TRAIN_BATCH))
LM_BF16_GEMM = (4096, 6144, 2048)  # (a): M, K, N of the MLP's wo at train_4k
LM_BF16_FAMILIES = (              # phase 25 (a): bfloat16, card vs CPU
    "gemma2-2b", "deepseek-7b", "qwen3-14b", "recurrentgemma-9b",
    "rwkv6-1.6b", "whisper-base", "internvl2-76b", "dbrx-132b")
LM_BF16_SERVE = (                 # (b): full width, bfloat16 cache
    ("recurrentgemma-9b", {}), ("rwkv6-1.6b", {}), ("whisper-base", {}),
    ("granite-moe-1b-a400m", {"moe_capacity_factor": 8.0}),
    ("dbrx-132b", {"num_layers": 2, "moe_capacity_factor": 8.0}),
    ("internvl2-76b", {"num_layers": 4}),
    ("deepseek-7b", {}), ("qwen3-14b", {}))
LM_BF16_PEAK_CAP = 75e9           # (b): torch's peak a model may need,
                                  # else its depth is cut
LM_BF16_ALONE_ARCH = "rwkv6-1.6b"  # (b): batched vs alone (recurrent state)
LM_BF16_ALONE_ULPS = 6.0          # (b): 1-slot vs batched at decode step i,
                                  # ulps x sqrt(i) (measured in PR 30)
LM_BF16_FAMILY_STEPS = 3          # (c)
ADMIT_OOC_SUPERSTEPS = 2     # admission session compared out of core (cut
                             # from 3: its Q = 9 superstep took 78-103 s)
CKPT_CRASH_SS = 3            # checkpoint: crash at the start of superstep 3
CKPT_PREEMPT_SS = 2          # SIGTERM at the barrier of superstep 2
OOC_CKPT_SUPERSTEPS = 3      # out-of-core checkpoint run: cut from 5
OOC_CKPT_CRASH_SS = 2
SHRINK_FROM = 4              # cluster restart: N = 4 ...
SHRINK_KILL = (2, 3)         # ... rank 3 killed at the barrier of superstep 2
SERVE_Q_SLOTS = 8            # serve: live query columns a session
SERVE_MIN_FILL = 4           # batch admissions until 4 are queued ...
SERVE_MAX_WAIT_S = 0.05      # ... or the oldest waited this long
SERVE_TENANTS = {"alice": 3.0, "bob": 1.0}
SERVE_CACHE = 64             # result-cache entries
SERVE_LANDMARKS = 4          # new LandmarkDistances seeds (waves 1 and 2)
SERVE_DEADLINE_MS = 1.0      # the deadline query's deadline
SERVE_POLL_S = 0.2           # a client's GET interval
SERVE_CLIENT_TIMEOUT_S = 600
DEV = "cuda"
WATCHDOG_S = 1100            # stacks to stderr if the run is still going


def log(msg):
    print(msg, flush=True)


def exact_matmuls():
    """The card's products as the reference's dots: no TF32, bfloat16
    partial sums in float32 (models/layers.py:exact_matmuls)."""
    from repro_torch.models.layers import exact_matmuls as port_numerics

    port_numerics()


def card_info(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    log(smi)
    from repro_torch import compat

    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        f"codec {'zstandard' if compat.HAVE_ZSTD else 'zlib (no zstandard)'}")
    return smi


def time_ms(torch, fn, flush, reps=10, spin=True):
    """Median device time of one call, CUDA events around each call, the L2
    cache flushed before each (the main path finds a tile cold).  A spin on
    the device after the flush keeps it busy until the host has queued the
    call, so the events time the device's work, not the host's enqueue;
    ``spin=False`` for a call that synchronises with the host inside (a
    head start would only add the host thread's wake-up to its time)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes, flops):
    """The least ms for nbytes and flops on the card (roofline/hw.py's
    datasheet HBM and FP32 rates) and which of the two binds."""
    from repro_torch.roofline import hw

    t_bytes = nbytes / hw.HBM_BW * 1e3
    t_ops = flops / hw.F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, got, want):
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin):
        return float("inf")
    if not bool(fin.any()):
        return 0.0
    return float((got[fin].double() - want[fin].double()).abs().max())


def check_equal_or_close(torch, got, want, exact, what):
    if exact:
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: kernel differs from plain version")
    else:
        torch.testing.assert_close(got, want, **SUM_TOL, msg=what)


def kernel_modules():
    from repro_torch.kernels import compact, gab_fused, gab_gather
    return {"segment_reduce": gab_gather, "gab_fused": gab_fused,
            "compact": compact}


def reset_launches():
    for mod in kernel_modules().values():
        mod.LAUNCHES = 0


def read_launches():
    return {name: mod.LAUNCHES for name, mod in kernel_modules().items()}


def require_launches(launches, names, what):
    log(f"{what} launches: {launches}")
    missing = [n for n in names if not launches[n]]
    if missing:
        raise AssertionError(f"{what}: {missing} not launched: {launches}")


def build_store(root):
    from repro_torch.graphio import spe, synth
    from repro_torch.graphio.formats import TileStore

    nv, ne = 1 << SCALE, EDGE_FACTOR << SCALE
    t0 = time.perf_counter()
    threads = min(8, os.cpu_count() or 1)
    chunks = list(synth.rmat_edges(nv, ne, seed=SEED, threads=threads))
    src = np.concatenate([c[0] for c in chunks])
    dst = np.concatenate([c[1] for c in chunks])
    t_gen = time.perf_counter() - t0
    store = TileStore(root, disk_mode=1)
    t0 = time.perf_counter()
    plan = spe.preprocess_arrays(src, dst, None, nv, store,
                                 tile_size=TILE_SIZE, threads=threads)
    t_spe = time.perf_counter() - t0
    log(f"store: SCALE {SCALE}, {nv} vertices, {ne} edges, "
        f"{plan.num_tiles} tiles, edge_cap {plan.edge_cap}, row_cap "
        f"{plan.row_cap}; R-MAT {t_gen:.1f} s, SPE {t_spe:.1f} s "
        f"({threads} threads)")
    return store, plan, src, dst, dict(generate_s=t_gen, spe_s=t_spe,
                                       num_tiles=plan.num_tiles,
                                       edge_cap=plan.edge_cap,
                                       row_cap=plan.row_cap)


def segment_row(torch, flush, c, d, r, combine, what, reps=10):
    """Time the segment kernel, its plain version and scatter_reduce on
    contrib c [E(, Q)] and ascending dst d [E] into r rows."""
    from repro_torch.kernels import gab_gather, ref

    e = d.shape[0]
    q = 1 if c.ndim == 1 else c.shape[1]
    idx = d.long()
    if q > 1:
        idx = idx[:, None].expand(e, q).contiguous()
    init = torch.full((r,) + tuple(c.shape[1:]),
                      ref.identity(combine, c.dtype), dtype=c.dtype,
                      device=c.device)
    lib_reduce = {"sum": "sum", "min": "amin", "max": "amax"}[combine]
    nbytes = e * 4 + e * 4 * q + r * 4 * q
    b_ms, b_by = bound(nbytes, e * q)
    row = dict(
        combine=combine, q=q, edges=e, rows=r,
        kernel_ms=time_ms(torch, lambda: gab_gather.segment_reduce(
            c, d, r, combine), flush, reps),
        plain_ms=time_ms(torch, lambda: ref.segment_reduce(
            c, d, r, combine), flush, reps),
        library_ms=time_ms(torch, lambda: torch.scatter_reduce(
            init, 0, idx, c, lib_reduce), flush, reps),
        bound_ms=b_ms, bound_by=b_by)
    log(f"{what}: kernel {row['kernel_ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, scatter_reduce {row['library_ms']:.4f} "
        f"ms, bound {b_ms:.4f} ms ({b_by})")
    return row


def row_lengths(dst, num_rows, what):
    """Log the row-length histogram of an ascending dst list: the longest
    row and the shares of rows with <= 1, <= 4 and <= 32 edges."""
    d = np.asarray(dst)
    counts = np.bincount(d[(d >= 0) & (d < num_rows)], minlength=num_rows)
    out = dict(rows=int(num_rows), max=int(counts.max()),
               **{f"le_{k}": float((counts <= k).mean()) for k in (1, 4, 32)})
    log(f"{what} row lengths: max {out['max']}, <= 1 edge "
        f"{out['le_1']:.4f}, <= 4 {out['le_4']:.4f}, <= 32 "
        f"{out['le_32']:.4f} of {num_rows} rows")
    return out


def check_segment_order(torch, tile, plan):
    """The segment kernel's sum is the fused kernel's order, bit for bit:
    at the largest tile's shape, Q = 1 and Q = 8, segment sum into row_cap
    rows against gab_fused with the identity apply (affine, alpha 0, beta
    1, no base, no edge streams, num_rows = row_cap: new = 0 + 1 · acc)."""
    from repro_torch.kernels import gab_fused, gab_gather
    from repro_torch.kernels.gab_fused import FusedSpec

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    e, r = plan.edge_cap, plan.row_cap
    d = torch.from_numpy(tile.dst_local).to(dev)
    spec = FusedSpec(combine="sum", apply="affine", alpha=0.0, beta=1.0)
    for q in (1, NUM_QUERIES):
        tail = () if q == 1 else (q,)
        c = torch.rand((e,) + tail, generator=gen, device=dev)
        seg = gab_gather.segment_reduce(c, d, r, "sum")
        new, _ = gab_fused.gab_fused(spec, c, None, None, d,
                                     torch.zeros((r,) + tail, device=dev),
                                     None, r, r)
        if not torch.equal(seg, new):
            raise AssertionError(f"segment sum Q={q} differs from gab_fused's "
                                 f"order in {int((seg != new).sum())} entries")
    log("segment sum equals gab_fused's identity apply bit for bit at Q = 1 "
        f"and Q = {NUM_QUERIES}")


def check_segment_kernel(torch, tile, plan, flush):
    """Segment kernel against ref.segment_reduce at the tiles' shapes
    (InDegree, the segment backend: contrib [edge_cap(, Q)],
    num_segments row_cap + 1)."""
    from repro_torch.kernels import gab_gather, ref

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    e, r = plan.edge_cap, plan.row_cap + 1
    dst_sorted = torch.from_numpy(tile.dst_local).to(dev)
    perm = torch.randperm(e, generator=gen, device=dev)
    rows = []
    err = 0.0
    for combine in ("sum", "min", "max"):
        for q in (1, 3, 4, NUM_QUERIES):
            shape = (e,) if q == 1 else (e, q)
            # positive messages for sums (as PageRank's): no cancellation
            c = (torch.rand(shape, generator=gen, device=dev)
                 if combine == "sum"
                 else torch.randn(shape, generator=gen, device=dev))
            for sorted_ids in (True, False):
                d = dst_sorted if sorted_ids else dst_sorted[perm].contiguous()
                got = gab_gather.segment_reduce(c, d, r, combine, sorted_ids)
                want = ref.segment_reduce(c, d, r, combine, sorted_ids)
                check_equal_or_close(torch, got, want, combine != "sum",
                                     f"segment {combine} Q={q} "
                                     f"sorted={sorted_ids}")
                err = max(err, max_abs_err(torch, got, want))
            rows.append(segment_row(torch, flush, c, dst_sorted, r, combine,
                                    f"segment {combine} Q={q}"))
    ci = torch.randint(-(1 << 30), 1 << 30, (e,), generator=gen, device=dev,
                       dtype=torch.int32)
    for combine in ("sum", "min", "max"):
        got = gab_gather.segment_reduce(ci, dst_sorted, r, combine)
        want = ref.segment_reduce(ci, dst_sorted, r, combine)
        check_equal_or_close(torch, got, want, True, f"segment int32 {combine}")
    # a contrib view 4 bytes into its storage (no 16-byte alignment), Q = 3
    # and Q = 8; ids out of range at both ends (-1 first, >= R last)
    d_out = torch.cat([torch.tensor([-1], dtype=torch.int32, device=dev),
                       dst_sorted,
                       torch.tensor([r, r + 5], dtype=torch.int32,
                                    device=dev)])
    for q in (3, NUM_QUERIES):
        flat = torch.rand((e + 3) * q + 1, generator=gen, device=dev)
        view = flat[1:1 + e * q].view(e, q)
        out_ids = flat[1:1 + (e + 3) * q].view(e + 3, q)
        for combine in ("sum", "min", "max"):
            for c, d, name in ((view, dst_sorted, "offset view"),
                               (out_ids, d_out, "ids out of range")):
                got = gab_gather.segment_reduce(c, d, r, combine)
                want = ref.segment_reduce(c, d, r, combine)
                check_equal_or_close(torch, got, want, combine != "sum",
                                     f"segment {combine} Q={q} {name}")
                err = max(err, max_abs_err(torch, got, want))
    log(f"segment kernel: all cases agree, max |err| {err:.3g}")
    return rows, err


def skewed_int32_list(rows, seed=SEED):
    """ROADMAP C.1's list (tests/test_torch_kernel_order.py builds the same
    at fewer rows): ``rows`` rows of Zipf(1.8) lengths capped at 4,000,
    rows of 50,000, 9,000, 4,097, 3,000, 1,025, 600 and 513 edges at rows
    k·rows/8 (k = 1..7), 20,000 padding edges at dst = rows, int32
    contributions from randint(-1000, 1000); rows + 1 output rows."""
    rng = np.random.default_rng(seed)
    lengths = np.minimum(rng.zipf(1.8, rows), 4000)
    for k, n in enumerate((50000, 9000, 4097, 3000, 1025, 600, 513)):
        lengths[(k + 1) * (rows // 8)] = n
    dst = np.concatenate([np.repeat(np.arange(rows), lengths),
                          np.full(20000, rows)]).astype(np.int32)
    contrib = rng.integers(-1000, 1000, dst.shape[0]).astype(np.int32)
    return dst, contrib, rows + 1


def check_segment_skewed_int32(torch, flush):
    """ROADMAP C.1's reproducer: int32 min and max with negative
    contributions over the skewed list, at every legal (block_e,
    block_r), each torch.equal to the plain version; timed at the default
    blocks."""
    from repro_torch.kernels import blocks, gab_gather, ref

    dev = torch.device(DEV)
    d_np, c_np, r = skewed_int32_list(SKEWED_ROWS)
    lengths = row_lengths(d_np, r, "C.1 skewed list")
    d = torch.from_numpy(d_np).to(dev)
    c = torch.from_numpy(c_np).to(dev)
    rows = []
    for combine in ("min", "max"):
        want = ref.segment_reduce(c, d, r, combine)
        for pair in ((be, br) for be in blocks.BLOCK_E
                     for br in blocks.BLOCK_R):
            got = gab_gather.segment_reduce(c, d, r, combine, blocks=pair)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"C.1 skewed int32 {combine} at blocks {pair}: "
                    f"{int((got != want).sum())} rows differ from the plain "
                    "version")
        row = segment_row(torch, flush, c, d, r, combine,
                          f"C.1 skewed int32 {combine} E={d.shape[0]} R={r}")
        row.update(shape="skewed int32", row_lengths=lengths,
                   pairs=len(blocks.BLOCK_E) * len(blocks.BLOCK_R))
        rows.append(row)
    log(f"C.1 skewed list: int32 min and max equal to the plain version at "
        f"all {rows[0]['pairs']} block pairs")
    return rows


def row_hub_ms(torch, fn, calls=10):
    """Device ms a call of the GAB kernels' row and hub launches in
    ``fn()``, from torch.profiler (the mean of ``calls`` calls, L2 not
    flushed)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ms = {"row": 0.0, "hub": 0.0}
    for ev in prof.key_averages():
        for kind in ms:
            if ev.device_type == cuda and f"{kind}_kernel" in ev.key:
                ms[kind] += ev.device_time_total / 1e3 / calls
    return ms


def segment_int32_launches(torch, tile, plan):
    """B.5: the segment kernel's row and hub launches for int32 sum, min
    and max at the largest tile (``row_hub_ms``)."""
    from repro_torch.kernels import gab_gather

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    e, r = plan.edge_cap, plan.row_cap + 1
    d = torch.from_numpy(tile.dst_local).to(dev)
    ci = torch.randint(-(1 << 30), 1 << 30, (e,), generator=gen, device=dev,
                       dtype=torch.int32)
    out = {combine: row_hub_ms(torch, lambda c=combine:
                               gab_gather.segment_reduce(ci, d, r, c))
           for combine in ("sum", "min", "max")}
    log("B.5, int32 at the largest tile, device ms a call: " + "; ".join(
        f"{c} row {m['row']:.4f} hub {m['hub']:.4f}"
        for c, m in out.items()))
    return out


def check_merged_segment(torch, dst, nv, flush):
    """Segment kernel (sum) at the merged mode's shape: the server's real
    edges by ascending global dst into V + 1 rows."""
    from repro_torch.kernels import gab_gather, ref

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    d_np = np.sort(dst).astype(np.int32)
    lengths = row_lengths(d_np, nv + 1, "merged dst list")
    d = torch.from_numpy(d_np).to(dev)
    del d_np
    c = torch.rand(d.shape[0], generator=gen, device=dev)
    got = gab_gather.segment_reduce(c, d, nv + 1, "sum")
    want = ref.segment_reduce(c, d, nv + 1, "sum")
    check_equal_or_close(torch, got, want, False, "segment sum merged shape")
    err = max_abs_err(torch, got, want)
    row = segment_row(torch, flush, c, d, nv + 1, "sum",
                      f"segment sum merged shape E={d.shape[0]} R={nv + 1}",
                      reps=5)
    row["shape"] = "merged"
    row["row_lengths"] = lengths
    log(f"segment kernel at the merged shape agrees, max |err| {err:.3g}")
    return row, err


def check_fused_mask(torch, spec, new, upd, pnew, pupd, old, nr, what):
    """The fused kernel's updated mask: rows at or past num_rows keep old and
    are not updated; below, the mask is the spec's test on the kernel's own
    new values, and equals the plain version's wherever the two versions'
    sums (which differ in their order of summation) cannot fall on opposite
    sides of update_tol."""
    if bool(upd[nr:].any()) or not torch.equal(new[nr:], old[nr:]):
        raise AssertionError(f"{what}: a row past num_rows changed")
    diff = (new[:nr] - old[:nr]).abs()
    own = diff > spec.update_tol if spec.update_tol > 0.0 else diff != 0
    if not torch.equal(upd[:nr], own):
        raise AssertionError(f"{what}: updated mask is not the spec's test")
    if spec.combine == "sum":
        margin = SUM_TOL["atol"] + SUM_TOL["rtol"] * pnew.abs()
        clear = ((pnew - old).abs() - spec.update_tol).abs() > margin
    else:
        clear = torch.ones_like(upd)
    if not torch.equal(upd[clear], pupd[clear]):
        raise AssertionError(f"{what}: updated mask differs")
    return int(clear.sum()), upd.numel()


def fused_cases():
    """The programs whose fused specs phase 4 runs: the five apps with a
    FusedSpec, and PageRank whose messages also add the edge's value (the
    one case with both edge streams, a and b)."""
    import dataclasses

    from repro_torch.core import apps

    @dataclasses.dataclass(eq=False)
    class WeightedRank(apps.PageRank):
        def gather(self, src_value, edge_val, aux):
            return super().gather(src_value, edge_val, aux) + edge_val

        def fused_spec(self):
            return dataclasses.replace(super().fused_spec(), add_edge=True)

    return {
        "pagerank": apps.PageRank(),
        "sssp": apps.SSSP(),
        "wcc": apps.WCC(),
        "bfs": apps.BFS(),
        "ppr": apps.PersonalizedPageRank(),
        "weighted": WeightedRank(),
    }


def batched(prog):
    """Whether prog is a batched program (values [V, Q] at every Q)."""
    return hasattr(prog, "with_queries")


def fused_inputs(torch, prog, dst, nr, r, q, gen):
    """Inputs of one fused case at a tile's shape, as the engine forms
    them: src [E(, Q)] (2-D for a batched program; 30 % inf for min
    specs: unreached sources), old and base [r(, Q)], the edge values ev
    (0 on padding edges, dst >= nr) and the gathered source aux inv, and
    the kernel's streams a = inv · ev, b = ev.  Returns (kernel args,
    (prog, ev, inv))."""
    spec = prog.fused_spec()
    dev = dst.device
    e = dst.shape[0]
    tail = (q,) if q > 1 or batched(prog) else ()
    ev = torch.where(dst < nr, torch.rand(e, generator=gen, device=dev) + 0.5,
                     torch.zeros((), device=dev))
    inv = torch.rand(e, generator=gen, device=dev)
    src = torch.rand((e,) + tail, generator=gen, device=dev) * 5
    if spec.combine == "min":
        src = torch.where(torch.rand(src.shape, generator=gen,
                                     device=dev) < 0.3,
                          torch.full_like(src, float("inf")), src)
    old = torch.rand((r,) + tail, generator=gen, device=dev) * 5
    a = (inv * ev) if spec.scale_aux else None
    b = ev if spec.add_edge else None
    base = (torch.rand((r,) + tail, generator=gen, device=dev)
            if spec.base_aux else None)
    return (spec, src, a, b, dst, old, base, nr, r), (prog, ev, inv)


def merged_composition(torch, prog, ev, inv, args):
    """The engine's merged mode at a tile's shape (gab.merged_server_step):
    the program's gather in PyTorch, the segment kernel over rows [0,
    num_rows), the program's apply and updated_mask; rows past num_rows
    keep old.  Every product and sum is its own PyTorch operation, so it
    rounds as the fused kernel's, and the segment kernel sums each row in
    the fused kernel's order: the two must agree bit for bit.  A
    single-query program at Q > 1 gets its edge arrays as [E, 1] columns,
    so that its message broadcasts over the query columns as the fused
    kernel's does."""
    from repro_torch.kernels import gab_gather

    spec, src, _, _, dst, old, base, nr, _ = args
    if src.ndim == 2 and not batched(prog):
        ev, inv = ev[:, None], inv[:, None]
    contrib = prog.gather(src, ev, {k: inv for k in prog.src_aux})
    acc = gab_gather.segment_reduce(contrib, dst, nr, prog.combine)
    o = old[:nr]
    new = prog.apply(o, acc, {k: base[:nr] for k in prog.dst_aux})
    upd = prog.updated_mask(o, new)
    return (torch.cat([new, old[nr:]]),
            torch.cat([upd, torch.zeros(old[nr:].shape, dtype=torch.bool,
                                        device=old.device)]))


def fused_bound(args):
    """The fused function's least bytes and operations: src, dst and each
    edge stream over the real edges (padding edges, dst >= num_rows, are
    never reduced), old, new and updated over row_cap rows, base over
    num_rows rows; a message step an edge stream, the apply over num_rows
    rows."""
    spec, src, a, b, dst, old, base, nr, r = args
    e = int((dst < nr).sum())
    q = 1 if src.ndim == 1 else src.shape[1]
    streams = int(a is not None) + int(b is not None)
    nbytes = (e * (4 + 4 * q + 4 * streams) + r * q * (4 + 4 + 1)
              + nr * q * 4 * int(base is not None))
    flops = e * q * (1 + streams + int(spec.add_const is not None))
    return bound(nbytes, flops + 3 * nr * q)


def check_fused_case(torch, case, flush, what):
    """One fused case: the kernel against the plain version (sums within
    SUM_TOL, the rest equal; the mask as check_fused_mask says) and bit
    for bit against the merged-mode composition, then each timed."""
    from repro_torch.kernels import gab_fused, ref

    args, (prog, ev, inv) = case
    spec, src, _, _, _, old, _, nr, _ = args
    new, upd = gab_fused.gab_fused(*args)
    pnew, pupd = ref.gab_fused_ref(*args)
    cnew, cupd = merged_composition(torch, prog, ev, inv, args)
    check_equal_or_close(torch, new, pnew, spec.combine != "sum", what)
    n_clear, n_rows = check_fused_mask(torch, spec, new, upd, pnew, pupd,
                                       old, nr, what)
    if not (torch.equal(new, cnew) and torch.equal(upd, cupd)):
        raise AssertionError(
            f"{what}: differs from the merged-mode composition in "
            f"{int((new != cnew).sum())} values, "
            f"{int((upd != cupd).sum())} mask entries")
    q = 1 if src.ndim == 1 else src.shape[1]
    b_ms, b_by = fused_bound(args)
    row = dict(q=q, num_rows=int(nr), library_ms=None, bound_ms=b_ms,
               bound_by=b_by, max_abs_err=max_abs_err(torch, new, pnew),
               mask_clear=n_clear, mask_entries=n_rows,
               kernel_ms=time_ms(torch, lambda: gab_fused.gab_fused(*args),
                                 flush),
               composition_ms=time_ms(torch, lambda: merged_composition(
                   torch, prog, ev, inv, args), flush),
               plain_ms=time_ms(torch, lambda: ref.gab_fused_ref(*args),
                                flush))
    log(f"{what}: kernel {row['kernel_ms']:.4f} ms, merged-mode "
        f"composition {row['composition_ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); equal to "
        f"the composition; mask equal on {n_clear} of {n_rows} entries")
    return row


def check_fused_kernel(torch, tile, plan, flush):
    """Fused kernel at the tiles' shapes (src_vals [edge_cap(, Q)], old
    [row_cap(, Q)], the largest tile's num_rows) against ref.gab_fused_ref
    and the merged-mode composition."""
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    dst = torch.from_numpy(tile.dst_local).to(dev)
    rows = []
    err = 0.0
    for name, prog in fused_cases().items():
        # Q + 1 = 9: MultiSourceBFS after a scheduled admission (phase 12)
        qs = (1, 4, NUM_QUERIES) + ((NUM_QUERIES + 1,) if name == "bfs"
                                    else ())
        for q in qs:
            case = fused_inputs(torch, prog, dst, tile.meta.num_rows,
                                plan.row_cap, q, gen)
            m0, c0 = non_torch_device_bytes(torch), card_non_torch_bytes(torch)
            row = check_fused_case(torch, case, flush,
                                   f"fused {name} Q={q}")
            # the hub launch's scratch grows inside torch's allocator: the
            # first Q = 9 call (more column passes, more scratch, the Q = 8
            # kernels) adds nothing outside it, in this process (NVML);
            # the whole card's figure, which other processes move, beside it
            m1, c1 = non_torch_device_bytes(torch), card_non_torch_bytes(torch)
            row["non_torch_growth"] = m1 - m0
            row["card_non_torch_growth"] = c1 - c0
            if q == NUM_QUERIES + 1:
                log(f"fused {name} Q={q}: {row['non_torch_growth']:+d} bytes "
                    "outside torch's allocator in this process (NVML; "
                    f"{m1} after), {row['card_non_torch_growth']:+d} on the "
                    f"whole card ({c1} after)")
                if row["non_torch_growth"]:
                    raise AssertionError(
                        f"fused {name} Q={q}: {row['non_torch_growth']:+d} "
                        "bytes outside torch's allocator in this process")
            rows.append(dict(spec=name, **row))
            err = max(err, row["max_abs_err"])
    log(f"fused kernel: all cases agree, max |err| {err:.3g}")
    return rows, err


def check_fused_padding_hub(torch, tile, plan, flush):
    """A tile whose padding would be a hub row (more than 8,192 edges, far
    past the hub launch's two multiples of 256): the largest tile's dst
    with num_rows lowered to the row of its PAD_HUB_EDGES-th last real
    edge and every edge from that row's first on pointing at it, as
    padding does.  The
    fused kernel must skip that row (it keeps old), agree with the plain
    version and equal the merged-mode composition."""
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    d_np = tile.dst_local.copy()
    cut = min(PAD_HUB_EDGES, tile.meta.num_edges // 2)
    nr = int(d_np[tile.meta.num_edges - cut])
    first = int(np.searchsorted(d_np, nr))
    d_np[first:] = nr
    dst = torch.from_numpy(d_np).to(dev)
    pad = d_np.shape[0] - first
    if cut == PAD_HUB_EDGES and pad <= 2 * 4096:
        raise AssertionError(f"padding of {pad} edges would be no hub")
    rows = []
    for name in ("pagerank", "bfs"):
        prog = fused_cases()[name]
        for q in (1, NUM_QUERIES):
            case = fused_inputs(torch, prog, dst, nr, plan.row_cap, q, gen)
            row = check_fused_case(
                torch, case, flush, f"fused {name} Q={q}, num_rows {nr}, "
                f"{pad} padding edges at dst == num_rows")
            rows.append(dict(spec=name, padding_edges=pad, **row))
    return rows, max(r["max_abs_err"] for r in rows)


def check_compact_kernel(torch, nv, flush):
    """Compact kernel against ref.compact: indices equal, value bits equal."""
    from repro_torch.core.comm import sparse_capacity
    from repro_torch.kernels import compact, ref

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    big = 1 << 25
    f32 = torch.float32
    # (V, density, dtype, fill, K or None for sparse_capacity(V), mask offset)
    cases = [(nv, 0.0, f32, None, None, 0), (nv, 1e-3, f32, None, None, 0),
             (nv, 0.05, f32, None, None, 0), (nv, 0.399, f32, None, None, 0),
             (nv, 0.6, f32, None, None, 0), (big, 0.01, f32, None, None, 0),
             (nv, 0.05, torch.int32, None, None, 0),
             (nv, 0.05, f32, 7, None, 0),
             (nv, 0.05, f32, None, None, 1),          # mask view, 1-byte offset
             (nv - 1, 0.05, f32, None, None, 0),      # V not a multiple of 16
             (nv, 0.05, f32, None, 0, 0),             # K = 0
             (1000, 0.5, f32, None, 1500, 0)]         # K > V
    rows = []
    for n, density, dtype, fill, k, offset in cases:
        k = sparse_capacity(n) if k is None else k
        m = (torch.rand(n + offset, generator=gen, device=dev)
             < density)[offset:]
        if dtype == torch.float32:
            v = torch.randn(n, generator=gen, device=dev)
        else:
            v = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=gen,
                              device=dev, dtype=torch.int32)
        gi, gv = compact.compact(m, v, k, fill)
        wi, wv = ref.compact(m, v, k, fill)
        what = (f"compact V={n} density={density} K={k} {dtype} "
                f"fill={'V' if fill is None else fill} offset={offset}")
        if not (torch.equal(gi, wi)
                and torch.equal(gv.view(torch.int32), wv.view(torch.int32))):
            raise AssertionError(f"{what}: kernel differs from plain version")
        pop = int(m.sum())
        if k == 0 or n < nv - 1:
            log(f"{what}: {pop} set, equal")
            continue
        fill_v = n if fill is None else fill

        def library_full():
            # the whole function in PyTorch: K slots of (fill, 0), then the
            # first K set indices and their values
            idx = torch.full((k,), fill_v, dtype=torch.int32, device=dev)
            val = torch.zeros(k, dtype=v.dtype, device=dev)
            nz = torch.nonzero(m).squeeze(1)[:k]
            idx[:nz.shape[0]] = nz.to(torch.int32)
            val[:nz.shape[0]] = v[nz]
            return idx, val
        nbytes = n + 4 * min(pop, k) + 8 * k
        b_ms, b_by = bound(nbytes, n)
        li, lv = library_full()
        if not (torch.equal(li, wi)
                and torch.equal(lv.view(torch.int32), wv.view(torch.int32))):
            raise AssertionError(f"{what}: the PyTorch yardstick differs")
        row = dict(
            n=n, density=density, capacity=k, popcount=pop,
            dtype=str(dtype), fill=fill, offset=offset,
            kernel_ms=time_ms(torch, lambda: compact.compact(m, v, k, fill),
                              flush),
            plain_ms=time_ms(torch, lambda: ref.compact(m, v, k, fill),
                             flush),
            library_ms=time_ms(torch, lambda: v[torch.nonzero(m).squeeze(1)
                                                [:k]], flush, spin=False),
            library_full_ms=time_ms(torch, library_full, flush, spin=False),
            bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        log(f"{what}: {pop} set, equal; kernel {row['kernel_ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, nonzero+gather "
            f"{row['library_ms']:.4f} ms, full function in PyTorch "
            f"{row['library_full_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    log("compact kernel: all cases equal")
    return rows, 0.0


def device_edges(torch, src, dst):
    return torch.from_numpy(src).to(DEV), torch.from_numpy(dst).to(DEV)


def inv_degree(torch, out_degree):
    """float64 of the engine's float32 1 / out-degree (0 for sinks)."""
    od = torch.from_numpy(np.asarray(out_degree)).to(DEV).double()
    return torch.where(od > 0, 1.0 / od, 0.0).float().double()


def ref_pagerank(torch, src, dst, out_degree, nv, steps):
    """float64 PageRank power iteration over the edge list, in plain
    PyTorch on the card (index_add_, independent of the engine's path)."""
    s, d = device_edges(torch, src, dst)
    w = inv_degree(torch, out_degree)[s]
    pr = torch.ones(nv, dtype=torch.float64, device=DEV)
    for _ in range(steps):
        msg = torch.zeros(nv, dtype=torch.float64, device=DEV)
        pr = 0.15 + 0.85 * msg.index_add_(0, d, pr[s] * w)
    out = pr.cpu().numpy()
    del s, d, w, pr, msg
    torch.cuda.empty_cache()
    return out


def ref_bfs(torch, src, dst, nv, sources):
    """BFS levels [V, Q] float32 from each source (inf where unreached),
    level-synchronous over the edge list in plain PyTorch on the card, one
    source at a time."""
    s, d = device_edges(torch, src, dst)
    out = torch.full((nv, len(sources)), float("inf"), dtype=torch.float32,
                     device=DEV)
    for q, v in enumerate(sources):
        level = out[:, q]
        level[v] = 0.0
        frontier = torch.zeros(nv, dtype=torch.bool, device=DEV)
        frontier[v] = True
        depth = 0
        while True:
            reach = torch.zeros_like(frontier)
            reach[d[frontier[s]]] = True
            frontier = reach & torch.isinf(level)
            if not bool(frontier.any()):
                break
            depth += 1
            level.masked_fill_(frontier, float(depth))
    levels = out.cpu().numpy()
    del s, d, out, level, frontier, reach
    torch.cuda.empty_cache()
    return levels


def ref_ppr(torch, src, dst, out_degree, nv, seeds, steps, tol):
    """float64 personalized PageRank with the engine's update gate (a cell
    takes its new value only where it moved by more than ``tol``), in
    plain PyTorch on the card, one seed at a time."""
    s, d = device_edges(torch, src, dst)
    w = inv_degree(torch, out_degree)[s]
    out = np.empty((nv, len(seeds)))
    for q, v in enumerate(seeds):
        seed_mass = torch.zeros(nv, dtype=torch.float64, device=DEV)
        seed_mass[v] = 1.0
        x = seed_mass.clone()
        for _ in range(steps):
            msg = torch.zeros(nv, dtype=torch.float64, device=DEV)
            new = 0.15 * seed_mass + 0.85 * msg.index_add_(0, d, x[s] * w)
            x = torch.where((new - x).abs() > tol, new, x)
        out[:, q] = x.cpu().numpy()
    del s, d, w, seed_mass, x, msg, new
    torch.cuda.empty_cache()
    return out


def steady_ms(res):
    """Mean ms a superstep over supersteps 1+ (superstep 0 alone if the
    run had one)."""
    h = res.history
    steady = h[1:] if len(h) > 1 else h
    return 1e3 * float(np.mean([x.seconds for x in steady]))


def app_summary(name, res):
    h = res.history
    s = dict(
        app=name, supersteps=res.supersteps, converged=res.converged,
        ms_per_superstep=1e3 * res.total_seconds() / max(len(h), 1),
        steady_ms=steady_ms(res),
        seconds=res.total_seconds(),
        load_seconds=sum(x.load_seconds for x in h),
        compute_seconds=sum(x.compute_seconds for x in h),
        tiles_processed=sum(x.tiles_processed for x in h),
        tiles_skipped=sum(x.tiles_skipped for x in h),
        raw_bytes=sum(x.raw_bytes for x in h),
        wire_bytes=sum(x.wire_bytes for x in h),
        per_superstep_ms=[1e3 * x.seconds for x in h],
        load_ms=[1e3 * x.load_seconds for x in h],
        compute_ms=[1e3 * x.compute_seconds for x in h],
        updated=[x.updated_vertices for x in h],
        updated_pairs=[x.updated_pairs for x in h],
        per_query_supersteps=(None if res.per_query_supersteps is None
                              else [int(x) for x in
                                    res.per_query_supersteps]))
    log(f"{name}: {s['supersteps']} supersteps, {s['ms_per_superstep']:.1f} "
        f"ms/superstep ({s['steady_ms']:.1f} steady), load "
        f"{s['load_seconds']:.2f} s, compute {s['compute_seconds']:.2f} s, "
        f"tiles {s['tiles_processed']} run / {s['tiles_skipped']} skipped, "
        f"broadcast {s['raw_bytes']} raw / {s['wire_bytes']} wire bytes")
    return s


def open_store(root):
    from repro_torch.graphio.formats import TileStore

    store = TileStore(root)
    store.load_meta()
    return store


def side_worker(name, args, results):
    """Runs ``name(torch, *args)`` (a function of this script) in a spawned
    process; puts ("ok", (its log lines, its result)) or ("error", (its
    log lines, the traceback)) on ``results``."""
    import traceback

    import torch

    global log
    lines = []
    log = lines.append
    try:
        results.put(("ok", (lines, globals()[name](torch, *args))))
    except BaseException:
        results.put(("error", (lines, traceback.format_exc())))


class Side:
    """A part of a phase run in a spawned process beside the main sequence
    (the out-of-core parts: single-threaded host work that leaves the card
    idle); its kernels count in its process.  ``join`` logs its lines and
    returns its result, or raises with its traceback."""

    def __init__(self, name, *args):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.name, self.t0 = name, time.perf_counter()
        self.results = ctx.Queue()
        self.proc = ctx.Process(target=side_worker,
                                args=(name, args, self.results), daemon=True)
        self.proc.start()

    def join(self):
        import queue

        t_wait = time.perf_counter()
        got = None
        try:
            while got is None:
                try:
                    got = self.results.get(timeout=5)
                except queue.Empty:
                    if not self.proc.is_alive():
                        raise AssertionError(
                            f"{self.name}: its process exited with code "
                            f"{self.proc.exitcode} and no result") from None
        finally:
            self.proc.join(timeout=60)
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join(timeout=10)
        status, (lines, payload) = got
        for line in lines:
            log(line)
        if status != "ok":
            raise AssertionError(f"{self.name} (side process): {payload}")
        log(f"{self.name}: side process done {time.perf_counter() - self.t0:.1f}"
            f" s after its start; waited {time.perf_counter() - t_wait:.1f} s")
        return payload


def engine(store, **kw):
    from repro_torch.core.engine import EngineConfig, OutOfCoreEngine

    return OutOfCoreEngine(store, EngineConfig(num_servers=1, device=DEV,
                                               seg_impl="fused", **kw))


def main_path(torch, store, src, dst):
    from repro_torch.core.apps import BFS, InDegree, PageRank

    eng = engine(store)
    nv = eng.plan.num_vertices
    reset_launches()
    pr = eng.run(PageRank(), max_supersteps=PR_SUPERSTEPS)
    bfs = eng.run(BFS(source=0), max_supersteps=BFS_MAX_SUPERSTEPS)
    indeg = eng.run(InDegree(), max_supersteps=1)
    launches = read_launches()
    require_launches(launches, ("segment_reduce", "gab_fused"), "main path")

    summaries = [app_summary("pagerank", pr), app_summary("bfs", bfs),
                 app_summary("indegree", indeg)]
    for arr in (pr.values, bfs.values, indeg.values):
        if arr.shape != (nv,) or arr.dtype != np.float32:
            raise AssertionError(f"bad result {arr.shape} {arr.dtype}")
    want = ref_pagerank(torch, src, dst, eng.out_degree, nv, PR_SUPERSTEPS)
    if not np.isfinite(pr.values).all():
        raise AssertionError("pagerank: non-finite values")
    rel = float(np.max(np.abs(pr.values - want) / want))
    log(f"pagerank vs the float64 reference: max rel err {rel:.3g} "
        f"(limit {PR_RTOL})")
    if rel > PR_RTOL:
        raise AssertionError("pagerank disagrees with the reference")
    if not bfs.converged:
        raise AssertionError("bfs did not converge")
    level = ref_bfs(torch, src, dst, nv, (0,))[:, 0]
    if not np.array_equal(bfs.values, level):
        raise AssertionError("bfs differs from the reference BFS")
    log(f"bfs equals the reference BFS: {int(np.isfinite(level).sum())} reached, "
        f"depth {int(level[np.isfinite(level)].max())}")
    if not np.array_equal(indeg.values, np.bincount(dst, minlength=nv)):
        raise AssertionError("indegree differs from np.bincount")
    log("indegree equals np.bincount")
    return eng, launches, summaries, rel, pr, bfs, indeg


def compact_path(torch, bfs):
    """ops.compact over each BFS superstep's sparse broadcast: the
    vertices superstep k updated (level k + 1) and their levels."""
    from repro_torch.core.comm import sparse_capacity
    from repro_torch.kernels import ops

    nv = bfs.values.shape[0]
    k = sparse_capacity(nv)
    values = torch.from_numpy(bfs.values).to(DEV)
    reset_launches()
    counts = []
    for step in range(bfs.supersteps):
        mask = bfs.values == step + 1
        idx, vals = ops.compact(torch.from_numpy(mask).to(DEV), values, k)
        want = np.nonzero(mask)[0][:k]
        n = len(want)
        gi, gv = idx.cpu().numpy(), vals.cpu().numpy()
        if not (np.array_equal(gi[:n], want)
                and np.array_equal(gv[:n], bfs.values[want])
                and (gi[n:] == nv).all() and (gv[n:] == 0).all()):
            raise AssertionError(f"compact path: superstep {step} differs "
                                 "from numpy")
        counts.append(int(mask.sum()))
    launches = read_launches()
    require_launches(launches, ("compact",), "compact path")
    log(f"compact path: {bfs.supersteps} BFS payloads (K = {k}, "
        f"{counts} set) equal numpy")
    return launches, counts


def profiled_step(torch, session, name):
    """One ``session.step()`` under torch.profiler: wall time, device busy
    share, device time by kernel and copy direction, and the host time of
    the out-of-core gather and writeback (record_function ranges)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = session.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # device-side events only (kernels and copies): a CPU op's device time
    # repeats its kernels'; "Activity Buffer Request" is the profiler's own
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    by_name = sorted(((e.device_time_total, e.key, e.count)
                      for e in events
                      if e.device_type == cuda
                      and not e.key.startswith("Activity Buffer")),
                     reverse=True)
    busy = sum(t for t, _, _ in by_name) / 1e6

    def device_ms(pred):
        return sum(t for t, k, _ in by_name if pred(k)) / 1e3

    def host_ms(key):
        return sum(e.cpu_time_total for e in events if e.key == key) / 1e3

    out = dict(app=name, wall_s=wall, device_busy_s=busy,
               device_busy_share=busy / wall if wall else 0.0,
               h2d_ms=device_ms(lambda k: "HtoD" in k),
               d2h_ms=device_ms(lambda k: "DtoH" in k),
               gab_kernels_ms=device_ms(
                   lambda k: "row_kernel" in k or "hub_kernel" in k),
               vstate_gather_ms=host_ms("vstate_gather"),
               vstate_writeback_ms=host_ms("vstate_writeback"),
               superstep_s=stats.seconds,
               top=[dict(name=k[:80], device_ms=t / 1e3, count=c)
                    for t, k, c in by_name[:12]])
    log(f"profiled {name} superstep: wall {wall:.3f} s, device busy "
        f"{busy:.4f} s ({100 * out['device_busy_share']:.1f}%), H2D "
        f"{out['h2d_ms']:.1f} ms, D2H {out['d2h_ms']:.1f} ms, GAB kernels "
        f"{out['gab_kernels_ms']:.1f} ms, vertex-state gather "
        f"{out['vstate_gather_ms']:.1f} ms and writeback "
        f"{out['vstate_writeback_ms']:.1f} ms on the host")
    for row in out["top"]:
        log(f"  {row['device_ms']:9.3f} ms  x{row['count']:<5d} {row['name']}")
    return out


def profile_superstep(torch, eng, prog, name):
    """One superstep (after a warm one) under torch.profiler (see
    profiled_step)."""
    session = eng.open_session(prog, max_supersteps=2)
    session.step()          # warm: the first superstep
    try:
        return profiled_step(torch, session, name)
    finally:
        session.close()


def pick_sources(out_degree):
    """Vertex 0 and seven vertices with out-degree > 0 drawn from SEED."""
    rng = np.random.default_rng(SEED)
    cand = np.nonzero(out_degree > 0)[0]
    cand = cand[cand != 0]
    more = rng.choice(cand, NUM_QUERIES - 1, replace=False)
    return (0,) + tuple(int(v) for v in more)


def batched_apps(torch, store, src, dst, bfs):
    from repro_torch.core.apps import (LandmarkDistances, MultiSourceBFS,
                                       PersonalizedPageRank)

    # tile skipping off: each run would rebuild the filters (12-20 s of
    # its superstep 0) and R-MAT skips no tile; phase 12's in-memory
    # session runs the batched skip pre-pass
    eng = engine(store, tile_skipping=False)
    nv = eng.plan.num_vertices
    sources = pick_sources(eng.out_degree)
    log(f"batched sources (Q = {len(sources)}): {sources}")
    reset_launches()
    msbfs = eng.run(MultiSourceBFS(sources=sources),
                    max_supersteps=BFS_MAX_SUPERSTEPS)
    lm = eng.run(LandmarkDistances(landmarks=sources),
                 max_supersteps=BFS_MAX_SUPERSTEPS)
    ppr = eng.run(PersonalizedPageRank(seeds=sources),
                  max_supersteps=PPR_SUPERSTEPS)
    ppr1 = eng.run(PersonalizedPageRank(seeds=sources[:1]),
                   max_supersteps=PPR_SUPERSTEPS)
    launches = read_launches()
    require_launches(launches, ("gab_fused",), "batched apps")
    summaries = [app_summary("msbfs", msbfs), app_summary("landmarks", lm),
                 app_summary("ppr", ppr), app_summary("ppr_q1", ppr1)]

    shape = (nv, len(sources))
    for name, res in (("msbfs", msbfs), ("landmarks", lm), ("ppr", ppr)):
        if res.values.shape != shape or res.values.dtype != np.float32:
            raise AssertionError(f"{name}: bad result {res.values.shape} "
                                 f"{res.values.dtype}")
    if not msbfs.converged or not lm.converged:
        raise AssertionError("msbfs / landmarks did not converge")
    levels = ref_bfs(torch, src, dst, nv, sources)
    for q, s in enumerate(sources):
        if not np.array_equal(msbfs.values[:, q], levels[:, q]):
            raise AssertionError(f"msbfs column {q} (source {s}) differs "
                                 "from the reference BFS")
    if not np.array_equal(msbfs.values[:, 0], bfs.values):
        raise AssertionError("msbfs column 0 differs from the Q = 1 BFS")
    log(f"msbfs equals the reference BFS in all {len(sources)} columns; column 0 "
        f"equals the single-query BFS; per-query supersteps "
        f"{list(msbfs.per_query_supersteps)}")
    if not (np.array_equal(lm.values, msbfs.values)
            and np.array_equal(lm.per_query_supersteps,
                               msbfs.per_query_supersteps)):
        raise AssertionError("landmarks differ from msbfs")
    log("landmarks (edge weight 1.0) equal msbfs, per-query supersteps too")

    tol = PersonalizedPageRank().update_tol
    want = ref_ppr(torch, src, dst, eng.out_degree, nv, sources,
                   PPR_SUPERSTEPS, tol)
    if not np.isfinite(ppr.values).all():
        raise AssertionError("ppr: non-finite values")
    big = want >= PPR_MIN_ENTRY
    err = np.abs(ppr.values - want)[big]
    rel_all = err / want[big]
    over = rel_all > PR_RTOL
    n_over = int(over.sum())
    flip_err = float(err[over].max()) if n_over else 0.0
    rel = float(rel_all[~over].max()) if n_over < rel_all.size else 0.0
    l1 = float(np.max(np.abs(ppr.values - want).sum(axis=0)))
    log(f"ppr vs the float64 reference: max rel err {rel:.3g} on {rel_all.size - n_over}"
        f" entries >= {PPR_MIN_ENTRY} (limit {PR_RTOL}); {n_over} gate flips "
        f"(max rel {float(rel_all.max()):.3g}, max abs err {flip_err:.3g}, "
        f"limit {PPR_SUPERSTEPS * tol:.3g}); max L1 per column {l1:.3g} "
        f"(limit {PPR_L1})")
    if (l1 > PPR_L1 or flip_err > PPR_SUPERSTEPS * tol
            or n_over > PPR_MAX_FLIP_SHARE * rel_all.size):
        raise AssertionError("ppr disagrees with the reference")
    if not np.array_equal(ppr.values[:, 0], ppr1.values[:, 0]):
        raise AssertionError("ppr column 0 differs from the Q = 1 run")
    log("ppr column 0 equals the Q = 1 PPR run")
    return (sources, launches, summaries, msbfs, levels,
            dict(ppr_max_rel_err=rel, ppr_gate_flips=n_over,
                 ppr_entries=int(rel_all.size),
                 ppr_flip_max_abs_err=flip_err, ppr_max_l1=l1))


def modes(torch, store, sources, pr, msbfs):
    """PageRank (PR_SUPERSTEPS) and MultiSourceBFS (to convergence) in
    each mode, equal to the tiled runs."""
    from repro_torch.core.apps import MultiSourceBFS, PageRank

    out = []
    reset_launches()
    for mode in (dict(engine_mode="stacked"), dict(engine_mode="merged"),
                 dict(pipeline=True)):
        name = next(f"{k}={v}" for k, v in mode.items())
        eng = engine(store, tile_skipping=False, **mode)
        p = eng.run(PageRank(), max_supersteps=PR_SUPERSTEPS)
        m = eng.run(MultiSourceBFS(sources=sources),
                    max_supersteps=BFS_MAX_SUPERSTEPS)
        if not same_bits(p.values, pr.values):
            raise AssertionError(f"{name}: pagerank differs from tiled")
        if not (same_bits(m.values, msbfs.values)
                and np.array_equal(m.per_query_supersteps,
                                   msbfs.per_query_supersteps)):
            raise AssertionError(f"{name}: msbfs differs from tiled")
        log(f"{name}: pagerank and msbfs equal the tiled runs bit for bit")
        out.append(dict(mode=name, pagerank=app_summary(f"pagerank {name}", p),
                        msbfs=app_summary(f"msbfs {name}", m)))
        del eng
        torch.cuda.empty_cache()
    launches = read_launches()
    require_launches(launches, ("segment_reduce", "gab_fused"), "modes")
    return out, launches


def same_bits(a, b):
    """Whether two host arrays hold the same bits (shape, dtype, bytes)."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


_NVML = {}
NVML_NOT_AVAILABLE = (1 << 64) - 1      # NVML_VALUE_NOT_AVAILABLE


class NvmlUnattributed(RuntimeError):
    """NVML lists several processes on the card, none under this PID."""


def process_device_bytes(torch):
    """The card's bytes NVML counts for this process (its CUDA context,
    the kernels' code and every allocation, torch's pool among them),
    read through ctypes on libnvidia-ml.so.1 (NVML, installed beside
    libcuda): nvmlDeviceGetComputeRunningProcesses, this PID's entry.
    Other processes on the card do not move it.  Where NVML lists the
    card's processes under the PIDs of another namespace (the chip
    machine's sandbox lists every process as PID 1) and lists one, that
    one is this process: it holds a context on the card, so it is listed.
    Raises where NVML is missing, or where it lists several processes
    and none under this PID (NvmlUnattributed)."""
    import ctypes

    class ProcessInfo(ctypes.Structure):    # nvmlProcessInfo_v2_t
        _fields_ = [("pid", ctypes.c_uint),
                    ("usedGpuMemory", ctypes.c_ulonglong),
                    ("gpuInstanceId", ctypes.c_uint),
                    ("computeInstanceId", ctypes.c_uint)]

    torch.cuda.synchronize()                # this process holds a context
    if not _NVML:
        lib = ctypes.CDLL("libnvidia-ml.so.1")
        if lib.nvmlInit_v2():
            raise RuntimeError("nvmlInit_v2 failed")
        uuid = str(torch.cuda.get_device_properties(0).uuid)
        uuid = uuid if uuid.startswith("GPU-") else f"GPU-{uuid}"
        handle = ctypes.c_void_p()
        rc = lib.nvmlDeviceGetHandleByUUID(uuid.encode(), ctypes.byref(handle))
        if rc:
            raise RuntimeError(f"nvmlDeviceGetHandleByUUID({uuid}): NVML "
                               f"error {rc}")
        name = next(n for n in ("nvmlDeviceGetComputeRunningProcesses_v3",
                                "nvmlDeviceGetComputeRunningProcesses_v2")
                    if hasattr(lib, n))
        _NVML.update(fn=getattr(lib, name), handle=handle)
    fn, handle = _NVML["fn"], _NVML["handle"]
    count = ctypes.c_uint(0)
    fn(handle, ctypes.byref(count), None)     # the count, then the list
    count = ctypes.c_uint(count.value + 8)
    infos = (ProcessInfo * count.value)()
    rc = fn(handle, ctypes.byref(count), infos)
    if rc:
        raise RuntimeError(f"nvmlDeviceGetComputeRunningProcesses: NVML "
                           f"error {rc}")
    listed = [(p.pid, p.usedGpuMemory) for p in infos[:count.value]]
    mine = [used for pid, used in listed if pid == os.getpid()]
    if not mine and len(listed) == 1:
        mine = [listed[0][1]]
    if not mine:
        raise NvmlUnattributed(f"NVML lists {listed} on the card, none "
                               f"under this process's PID {os.getpid()}")
    if len(mine) != 1 or mine[0] == NVML_NOT_AVAILABLE:
        raise RuntimeError(f"NVML: process {os.getpid()} counted as "
                           f"{mine} on the card ({listed})")
    return int(mine[0])


def non_torch_device_bytes(torch):
    """This process's device bytes outside torch's caching allocator (the
    CUDA context and the kernels' code; the hub launch's scratch comes from
    torch's allocator): NVML's count for this process less torch's
    reserved bytes."""
    return process_device_bytes(torch) - torch.cuda.memory_reserved()


def logged_non_torch_bytes(torch):
    """non_torch_device_bytes for a reading that is logged, not asserted:
    None where NVML cannot tell this process from the others on the card
    (phase 23's dry-run processes hold contexts from phase 7 on)."""
    try:
        return non_torch_device_bytes(torch)
    except NvmlUnattributed:
        return None


def growth(after, before):
    return None if after is None or before is None else after - before


def card_non_torch_bytes(torch):
    """The whole card's bytes in use less this process's torch pool:
    moved by any process on the card (logged beside the process's own)."""
    free, total = torch.cuda.mem_get_info()
    return total - free - torch.cuda.memory_reserved()


def vstate_summary(name, res, tiled_ms, store_stats, k):
    """Per-superstep vertex-state counters of an out-of-core run, beside
    the in-memory tiled run's steady ms per superstep."""
    h = res.history
    s = app_summary(name, res)
    s.update(
        intervals=k, tiled_steady_ms=tiled_ms,
        faults=[x.vstate_faults for x in h],
        load_bytes=[x.vstate_load_bytes for x in h],
        spill_bytes=[x.vstate_spill_bytes for x in h],
        dirty_intervals=[x.vstate_dirty_intervals for x in h],
        store=store_stats)
    log(f"{name}: {k} intervals, {s['steady_ms']:.1f} ms/superstep steady "
        f"against tiled {tiled_ms:.1f} ({s['steady_ms'] / tiled_ms:.2f}x); "
        f"faults {s['faults']}, faulted-in bytes {s['load_bytes']}, spilled "
        f"bytes {s['spill_bytes']}, dirty intervals {s['dirty_intervals']}; "
        f"store: {store_stats['faults']} faults, {store_stats['spills']} "
        f"spills, compress {store_stats['compress_seconds']:.2f} s, "
        f"decompress {store_stats['decompress_seconds']:.2f} s, disk "
        f"{store_stats['disk_seconds']:.2f} s")
    if not (sum(s["faults"]) and sum(s["dirty_intervals"])):
        raise AssertionError(f"{name}: the vertex budget does not bind")
    return s


def counting_h2d(torch, counter):
    """Wrap engine.run_tile_sharded to add the bytes of the host inputs it
    copies to the device to counter[0]."""
    from repro_torch.core import engine as engine_mod

    real = engine_mod.run_tile_sharded

    def wrapped(*args, **kw):
        for a in list(args) + list(kw.values()):
            for x in (a.values() if isinstance(a, dict) else (a,)):
                if isinstance(x, (np.ndarray, torch.Tensor)):
                    counter[0] += x.nbytes
        return real(*args, **kw)

    engine_mod.run_tile_sharded = wrapped
    return lambda: setattr(engine_mod, "run_tile_sharded", real)


def time_footprints(store, plan):
    """Seconds to read every tile and compute its source footprint over
    the OOC_INTERVALS plan: what the out-of-core engine adds to each tile
    load on a store written without an interval plan."""
    from repro_torch.core.partition import plan_intervals
    from repro_torch.core.tiles import compute_source_footprint

    iv = plan_intervals(plan.splitter, OOC_INTERVALS)
    t0 = time.perf_counter()
    read = 0.0
    for t in range(plan.num_tiles):
        r0 = time.perf_counter()
        tile = store.read_tile(t)
        read += time.perf_counter() - r0
        compute_source_footprint(tile.src, tile.meta.num_edges, iv.splitter)
    total = time.perf_counter() - t0
    out = dict(intervals=int(iv.num_intervals), read_s=read,
               footprint_s=total - read)
    log(f"footprints: {iv.num_intervals} intervals (OOC_INTERVALS = "
        f"{OOC_INTERVALS}, cut at tile boundaries); {plan.num_tiles} tiles "
        f"read in {read:.2f} s, footprints computed in "
        f"{out['footprint_s']:.2f} s")
    return out


def ooc_phase(torch, store_root, indeg):
    """Out-of-core vertex state on the main store with OOC_INTERVALS
    intervals: PageRank (budget OOC_PR_BUDGET, OOC_PR_SUPERSTEPS
    supersteps, superstep 1 profiled) and InDegree (OOC_PR_BUDGET, 1
    superstep, the
    segment kernel), each bit for bit equal to the in-memory tiled run of
    as many supersteps; the budget must bind.  MultiSourceBFS under
    OOC_MSBFS_BUDGET runs in phase 12's out-of-core session.  Runs in a
    side process (Side)."""
    from repro_torch.core.apps import InDegree, PageRank

    store = open_store(store_root)
    num_tiles = store.load_plan().num_tiles
    out, launches = [], {}
    mem = engine(store, tile_skipping=False).run(
        PageRank(), max_supersteps=OOC_PR_SUPERSTEPS)
    reset_launches()
    eng = engine(store, tile_skipping=False, num_intervals=OOC_INTERVALS,
                 vertex_memory_budget=OOC_PR_BUDGET)
    sess = eng.open_session(PageRank(), max_supersteps=OOC_PR_SUPERSTEPS)
    try:
        sess.step()
        h2d = [0]
        restore = counting_h2d(torch, h2d)
        try:
            prof = profiled_step(torch, sess, "pagerank ooc")
        finally:
            restore()
        prof["h2d_bytes"] = h2d[0]
        log(f"  H2D of the sharded step: {h2d[0]} bytes")
        while not sess.finished:
            sess.step()
        res = sess.result()
    finally:
        sess.close()
    launches["pagerank"] = read_launches()
    if not same_bits(res.values, mem.values):
        raise AssertionError("pagerank ooc differs from the tiled run")
    out.append(vstate_summary("pagerank ooc", res, steady_ms(mem),
                              eng.vstate.stats.as_dict(),
                              eng.vstate.num_intervals))
    if launches["pagerank"]["gab_fused"] != num_tiles * OOC_PR_SUPERSTEPS:
        raise AssertionError(f"pagerank ooc: {launches['pagerank']} "
                             f"launches, {num_tiles} a superstep expected")

    # tile skipping on, as in phase 5: its one superstep builds the filters
    eng = engine(store, num_intervals=OOC_INTERVALS,
                 vertex_memory_budget=OOC_PR_BUDGET)
    reset_launches()
    res = eng.run(InDegree(), max_supersteps=1)
    launches["indegree"] = read_launches()
    if not same_bits(res.values, indeg.values):
        raise AssertionError("indegree ooc differs from the tiled run")
    if launches["indegree"]["segment_reduce"] != num_tiles:
        raise AssertionError(f"indegree ooc: {launches['indegree']}")
    out.append(vstate_summary("indegree ooc", res, steady_ms(indeg),
                              eng.vstate.stats.as_dict(),
                              eng.vstate.num_intervals))
    for key in ("faults", "spill_bytes", "dirty_intervals"):
        if not all(sum(r[key]) for r in out):
            raise AssertionError(f"ooc: no {key}: the budget does not bind")
    total = {k: sum(v[k] for v in launches.values())
             for k in launches["pagerank"]}
    require_launches(total, ("segment_reduce", "gab_fused"), "ooc")
    log("ooc: pagerank and indegree equal the tiled runs bit for bit")
    return out, prof, total


def pick_admitted(src, dst, out_degree, sources):
    """Two more sources drawn from SEED among vertices with out-degree > 0
    that are not sources already: the ninth (scheduled) query among those
    whose out-neighbours are all sinks, so its BFS converges in two
    supersteps and its column retires inside the out-of-core window; the
    tenth (admitted through the session) among all of them."""
    rng = np.random.default_rng(SEED)
    cand = np.setdiff1d(np.nonzero(out_degree > 0)[0], np.asarray(sources))
    feeds = np.bincount(src[out_degree[dst] > 0], minlength=len(out_degree))
    s9 = int(rng.choice(cand[feeds[cand] == 0]))
    s10 = int(rng.choice(cand[cand != s9]))
    return s9, s10


def admission_script(torch, eng, sources, s10, max_supersteps=None):
    """The session the admission phase drives: MultiSourceBFS over the
    sources, at most Q + 1 live columns, the engine's admit_plan bringing
    the ninth query in after superstep 1; query DRAIN_QID drained at the
    end of superstep DRAIN_AT, and s10 admitted through ``admit()`` once
    a column has left.  Returns (result, per-superstep rows, the drained
    column's partial values, s10's query id)."""
    from repro_torch.core.apps import MultiSourceBFS
    from repro_torch.kernels import gab_fused

    sess = eng.open_session(MultiSourceBFS(sources=sources),
                            q_slots=len(sources) + 1,
                            max_supersteps=max_supersteps)
    steps, partial, g10 = [], None, None
    try:
        while not sess.finished:
            ss = sess.superstep
            if ss == DRAIN_AT:
                sess.drain([DRAIN_QID])
            l0, m0 = gab_fused.LAUNCHES, logged_non_torch_bytes(torch)
            st = sess.step()
            steps.append(dict(
                superstep=ss, active_queries=st.active_queries,
                fused_launches=gab_fused.LAUNCHES - l0,
                non_torch_growth=growth(logged_non_torch_bytes(torch), m0),
                ms=1e3 * st.seconds, admitted=list(st.admitted_queries),
                drained=list(st.drained_queries),
                retired=list(st.retired_queries),
                vstate_faults=st.vstate_faults,
                vstate_load_bytes=st.vstate_load_bytes,
                vstate_spill_bytes=st.vstate_spill_bytes,
                vstate_dirty_intervals=st.vstate_dirty_intervals))
            if st.drained_queries:
                partial = sess.query_result(DRAIN_QID)
            if (g10 is None and not sess.finished
                    and (st.retired_queries or st.drained_queries)):
                g10 = sess.admit([s10])[0]
        res = sess.result()
    finally:
        sess.close()
    return res, steps, partial, g10


def admission_phase(torch, store, sources, s9, s10, msbfs, levels,
                    ooc_part):
    """Mid-run admission at SCALE 22: the session of admission_script in
    memory to convergence (tile skipping on, as users run it), each
    admitted column against a fresh single-query run, the drained one
    against the reference BFS levels up to DRAIN_AT + 1; then its first
    ADMIT_OOC_SUPERSTEPS supersteps in memory and under OOC_MSBFS_BUDGET,
    equal bit for bit — the latter is also the out-of-core MultiSourceBFS
    run at Q = 8 (supersteps 0 and 1, the ninth query admitted at the
    barrier of 1; with a window of 3, also Q = 9 at superstep 2, at whose
    barrier query DRAIN_QID drains).  The launch counters are read
    around the two sessions alone: "admission" (in memory) and
    "admission ooc".  The out-of-core part (admission_ooc) ran in a side
    process: ``ooc_part`` is its result."""
    from repro_torch.core.apps import MultiSourceBFS

    plan = ((1, (s9,)),)
    log(f"admission: ninth source {s9} (its out-neighbours are sinks) "
        f"scheduled after superstep 1, tenth {s10} through admit(); query "
        f"{DRAIN_QID} drained at superstep {DRAIN_AT}")
    launches = {}
    eng = engine(store, admit_plan=plan)
    reset_launches()
    res, steps, partial, g10 = admission_script(torch, eng, sources, s10)
    launches["admission"] = read_launches()
    require_launches(launches["admission"], ("gab_fused",), "admission")
    for row in steps:
        log(f"  superstep {row['superstep']}: {row['active_queries']} live, "
            f"{row['fused_launches']} fused launches, {row['ms']:.1f} ms, "
            f"admitted {row['admitted']}, drained {row['drained']}, retired "
            f"{row['retired']}, non-torch device bytes "
            f"{row['non_torch_growth']}")
    q = len(sources)
    nine = [r for r in steps if r["active_queries"] == q + 1]
    if not res.converged or not nine or g10 is None or partial is None:
        raise AssertionError("admission: the session did not run its script")
    num_tiles = store.load_plan().num_tiles
    if any(r["fused_launches"] != num_tiles for r in nine):
        raise AssertionError(f"admission: fused launches at Q = {q + 1}: "
                             f"{[r['fused_launches'] for r in nine]}")
    pq = res.per_query_supersteps
    keep = [c for c in range(q) if c != DRAIN_QID]
    if not (same_bits(res.values[:, keep], msbfs.values[:, keep])
            and np.array_equal(pq[keep], msbfs.per_query_supersteps[keep])):
        raise AssertionError("admission: an original column differs from "
                             "the Q = 8 run")
    for gq, s in ((q, s9), (g10, s10)):
        fresh = engine(store, tile_skipping=False).run(
            MultiSourceBFS(sources=(s,)), max_supersteps=BFS_MAX_SUPERSTEPS)
        if not (same_bits(res.values[:, gq], fresh.values[:, 0])
                and pq[gq] == fresh.per_query_supersteps[0]):
            raise AssertionError(f"admission: query {gq} (source {s}) "
                                 "differs from its fresh run")
    lv = levels[:, DRAIN_QID]
    want = np.where(lv <= DRAIN_AT + 1, lv, np.float32(np.inf))
    if not (pq[DRAIN_QID] == -1
            and same_bits(res.values[:, DRAIN_QID], partial)
            and same_bits(partial, want)):
        raise AssertionError("admission: the drained column is not its "
                             "partial run")
    log(f"admission: {res.supersteps} supersteps, Q up to {q + 1}; queries "
        f"{q} and {g10} equal their fresh runs (supersteps "
        f"{int(pq[q])}, {int(pq[g10])}), query {DRAIN_QID} holds its BFS "
        f"levels up to {DRAIN_AT + 1}, the other originals equal the "
        f"Q = {q} run")

    ooc_summary, mem_steps, ooc_steps, launches["admission ooc"] = ooc_part
    return dict(s9=s9, s10=s10, q10=g10, supersteps=res.supersteps,
                per_query_supersteps=[int(x) for x in pq], steps=steps,
                mem_steps=mem_steps, ooc_steps=ooc_steps, ooc=ooc_summary,
                fused_launches_at_q9=[r["fused_launches"] for r in nine],
                non_torch_growth_at_q9=[r["non_torch_growth"]
                                        for r in nine]), launches


def admission_ooc(torch, store_root, sources, s9, s10):
    """Phase 12's out-of-core part, in a side process: the admission
    session's first ADMIT_OOC_SUPERSTEPS supersteps in memory and under
    OOC_MSBFS_BUDGET, equal bit for bit, the launch counters read around
    the out-of-core session ("admission ooc")."""
    store = open_store(store_root)
    q = len(sources)
    plan = ((1, (s9,)),)
    num_tiles = store.load_plan().num_tiles
    cut = ADMIT_OOC_SUPERSTEPS
    mem, mem_steps, _, _ = admission_script(
        torch, engine(store, tile_skipping=False, admit_plan=plan), sources,
        s10, cut)
    eng = engine(store, tile_skipping=False, admit_plan=plan,
                 num_intervals=OOC_INTERVALS,
                 vertex_memory_budget=OOC_MSBFS_BUDGET)
    reset_launches()
    ooc, ooc_steps, _, _ = admission_script(torch, eng, sources, s10, cut)
    launches = read_launches()
    require_launches(launches, ("gab_fused",), "admission ooc")

    def script(rows):
        return [(r["active_queries"], r["admitted"], r["drained"],
                 r["retired"]) for r in rows]

    if not (same_bits(ooc.values, mem.values)
            and np.array_equal(ooc.per_query_supersteps,
                               mem.per_query_supersteps)
            and script(ooc_steps) == script(mem_steps)
            and all(r["fused_launches"] == num_tiles for r in ooc_steps)):
        raise AssertionError("admission: the out-of-core session differs "
                             "from the in-memory one")
    # the window holds the scheduled admission and, from 3 supersteps on,
    # the Q = 9 superstep and the drain at its barrier (the retirement and
    # admit() into the freed slot come a superstep later: checked in memory
    # by admission_phase)
    if not ([q] in [r["admitted"] for r in ooc_steps]
            and (cut < 3 or (
                any(r["active_queries"] == q + 1 for r in ooc_steps)
                and [DRAIN_QID] in [r["drained"] for r in ooc_steps]))):
        raise AssertionError(f"admission ooc: {script(ooc_steps)} misses a "
                             "step of the script")
    ooc_summary = vstate_summary(
        f"msbfs Q={q} then {q + 1} ooc (admission session)", ooc,
        steady_ms(mem), eng.vstate.stats.as_dict(), eng.vstate.num_intervals)
    if not sum(ooc_summary["spill_bytes"]):
        raise AssertionError("admission ooc: nothing spilled")
    log(f"admission: its first {cut} supersteps ((Q, admitted, drained, "
        f"retired) {script(ooc_steps)}) equal in memory and out of core bit "
        f"for bit")
    return ooc_summary, mem_steps, ooc_steps, launches


def free_port():
    """A TCP port on localhost that is free now (for a process group)."""
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def load_tiles(store):
    plan = store.load_plan()
    ind, outd = store.load_degrees()
    return plan, [store.read_tile(t) for t in range(plan.num_tiles)], ind, outd


GLOO_APPS = ("pagerank", "msbfs")


def gloo_cuda_refusal(dev, world):
    """Why this torch's gloo refuses CUDA tensors in the collectives the
    broadcasts use (all_reduce SUM and MAX, all_gather), or None.  Only
    gloo's refusal by device type counts; any other error propagates."""
    import torch
    import torch.distributed as dist

    x = torch.ones(4, device=dev)
    n = torch.ones(1, dtype=torch.int64, device=dev)
    i = torch.arange(4, dtype=torch.int32, device=dev)
    try:
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
        dist.all_reduce(n, op=dist.ReduceOp.MAX)
        dist.all_gather([torch.empty_like(i) for _ in range(world)], i)
        dist.all_gather([torch.empty_like(x) for _ in range(world)], x)
    except RuntimeError as exc:
        if "unsupported device type" not in str(exc):
            raise
        return f"{type(exc).__name__}: {exc}"
    return None


def mesh_gloo_worker(rank, world, port, store_root, dev, sources, results):
    """One rank of the world-size-2 mesh on gloo, both ranks on the one
    card with CUDA tensors: PageRank (PR_SUPERSTEPS) and MultiSourceBFS at
    Q = 8 to convergence, both hybrid; the BFS's sparse supersteps launch
    compact.  Puts (rank, "ok" | "rejected" | "error", payload) on
    ``results``: "rejected" only where gloo refuses CUDA tensors by device
    type (``gloo_cuda_refusal``)."""
    import traceback

    import torch.distributed as dist

    from repro_torch.core.apps import MultiSourceBFS, PageRank
    from repro_torch.core.distributed import (DistConfig,
                                              DistributedGABEngine,
                                              init_process_group)
    from repro_torch.graphio.formats import TileStore

    try:
        init_process_group(rank, world, f"tcp://localhost:{port}",
                           device=dev, backend="gloo")
        refusal = gloo_cuda_refusal(dev, world)
        if refusal is not None:
            results.put((rank, "rejected", refusal))
            return
        store = TileStore(store_root)
        store.load_meta()
        plan, tiles, ind, outd = load_tiles(store)
        runs = {}
        reset_launches()
        for app, prog, cap in (
                ("pagerank", PageRank(), PR_SUPERSTEPS),
                ("msbfs", MultiSourceBFS(sources=sources),
                 BFS_MAX_SUPERSTEPS)):
            t0 = time.perf_counter()
            vals, hist = DistributedGABEngine(None, DistConfig(
                device=dev)).run(prog, tiles, plan.num_vertices, outd, ind,
                                 plan.row_cap, max_supersteps=cap)
            runs[app] = dict(values=vals, history=hist,
                             seconds=time.perf_counter() - t0)
        results.put((rank, "ok", dict(runs=runs, launches=read_launches())))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def mesh_phase(torch, store, pr, msbfs, sources):
    """Phase 13: DistributedGABEngine at world size 1 on NCCL with all
    tiles resident: PageRank (PR_SUPERSTEPS) in dense, sparse and hybrid
    comm, MultiSourceBFS at Q = 8 in hybrid to convergence, each equal
    bit for bit to the tiled run; then world size 2 on gloo with CUDA
    tensors, both ranks on the one card (PageRank and MultiSourceBFS at
    Q = 8, hybrid, each equal to the tiled run bit for bit)."""
    import multiprocessing as mp
    import queue

    import torch.distributed as dist

    from repro_torch.core import comm
    from repro_torch.core.apps import MultiSourceBFS, PageRank
    from repro_torch.core.distributed import (DistConfig,
                                              DistributedGABEngine,
                                              init_process_group)

    plan, tiles, ind, outd = load_tiles(store)
    nv = plan.num_vertices
    backend = init_process_group(0, 1, f"tcp://localhost:{free_port()}",
                                 device=DEV)
    log(f"mesh: world size 1 on {backend}, {len(tiles)} tiles resident")
    rows = []
    launches = {}
    try:
        reset_launches()
        for app, prog, mode, want, cap in (
                [("pagerank", PageRank(), m, pr, PR_SUPERSTEPS)
                 for m in ("dense", "sparse", "hybrid")]
                + [("msbfs", MultiSourceBFS(sources=sources), "hybrid",
                    msbfs, BFS_MAX_SUPERSTEPS)]):
            eng = DistributedGABEngine(None, DistConfig(comm_mode=mode,
                                                        device=DEV))
            c0 = read_launches()["compact"]
            t0 = time.perf_counter()
            vals, hist = eng.run(prog, tiles, nv, outd, ind, plan.row_cap,
                                 max_supersteps=cap)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            compacts = read_launches()["compact"] - c0
            del eng
            torch.cuda.empty_cache()
            if not (same_bits(vals, want.values)
                    and len(hist) == want.supersteps):
                raise AssertionError(f"mesh {app} {mode}: differs from the "
                                     "tiled run")
            branches = [h["branch"] for h in hist]
            if mode == "sparse":
                # superstep 0 updates every vertex: the overflow guard
                # sends it dense on every rank
                cells = nv * getattr(prog, "num_queries", 1)
                cap_k = comm.sparse_capacity(cells)
                if not (hist[0]["density"] * cells > cap_k
                        and branches[0] == "dense"):
                    raise AssertionError(f"mesh sparse: the overflow guard "
                                         f"did not fire: {hist[0]}")
                if any((h["density"] * cells > cap_k) != (b == "dense")
                       for h, b in zip(hist, branches)):
                    raise AssertionError(f"mesh sparse: branches {branches}")
            step_s = [h["seconds"] for h in hist]
            rows.append(dict(app=app, mode=mode, supersteps=len(hist),
                             seconds=seconds,
                             per_superstep_ms=[1e3 * t for t in step_s],
                             steady_ms=1e3 * float(np.mean(
                                 step_s[1:] if len(step_s) > 1 else step_s)),
                             branches=branches,
                             density=[h["density"] for h in hist],
                             compact_launches=compacts))
            log(f"mesh {app} {mode}: {len(hist)} supersteps in {seconds:.1f} "
                f"s with the tiles' stacking and copy, "
                f"{rows[-1]['steady_ms']:.1f} ms a superstep steady, branches "
                f"{branches}, {compacts} compact launches; equal to the tiled "
                f"run bit for bit")
        launches["mesh"] = read_launches()
        require_launches(launches["mesh"], ("gab_fused", "compact"), "mesh")
    finally:
        dist.destroy_process_group()
    del tiles

    # world size 2 on gloo, CUDA tensors, both ranks on the one card
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=mesh_gloo_worker,
                         args=(r, 2, port, store.root, DEV, sources,
                               results),
                         daemon=True)
             for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + 300
    try:
        while len(got) < len(procs) and time.monotonic() < deadline:
            try:
                rank, status, payload = results.get(timeout=5)
            except queue.Empty:
                if not any(p.is_alive() for p in procs):
                    break       # every rank exited; nothing more will come
                continue
            got[rank] = (status, payload)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    errors = {r: p for r, (st, p) in got.items() if st == "error"}
    if errors or len(got) != 2:
        raise AssertionError(f"mesh gloo world 2: {errors or got}")
    gloo = dict(status=sorted({st for st, _ in got.values()}))
    if "rejected" in gloo["status"]:
        gloo["rejected"] = {r: p for r, (st, p) in got.items()
                            if st == "rejected"}
        log(f"mesh gloo world 2: this torch's gloo rejects CUDA tensors in "
            f"a collective: {gloo['rejected']}")
    else:
        for app, want in zip(GLOO_APPS, (pr, msbfs)):
            for r, (_, p) in got.items():
                run = p["runs"][app]
                if not (same_bits(run["values"], want.values)
                        and len(run["history"]) == want.supersteps):
                    raise AssertionError(f"mesh gloo rank {r}: {app} differs "
                                         "from the tiled run")
            step_s = [h["seconds"] for h in got[0][1]["runs"][app]["history"]]
            gloo[app] = dict(
                seconds=[got[r][1]["runs"][app]["seconds"] for r in (0, 1)],
                branches=[h["branch"]
                          for h in got[0][1]["runs"][app]["history"]],
                per_superstep_ms=[1e3 * t for t in step_s],
                steady_ms=1e3 * float(np.mean(
                    step_s[1:] if len(step_s) > 1 else step_s)))
        launches["mesh gloo"] = {
            k: sum(got[r][1]["launches"][k] for r in (0, 1))
            for k in got[0][1]["launches"]}
        require_launches(launches["mesh gloo"], ("gab_fused", "compact"),
                         "mesh gloo")
        log(f"mesh gloo world 2 (CUDA tensors, one card): pagerank and msbfs "
            f"Q = {len(sources)} equal to the tiled runs bit for bit; "
            + ", ".join(f"{a} {gloo[a]['steady_ms']:.1f} ms a superstep "
                        f"steady, branches {gloo[a]['branches']}"
                        for a in GLOO_APPS))
    return dict(runs=rows, gloo_world2=gloo), launches


def cluster_phase(torch, store, pr, sources, s9):
    """Phase 14: run_cluster on the card at N = 2 and N = 4, shm
    transport, hybrid comm, one launch per N: PageRank and MultiSourceBFS
    at Q = 8 whose admit_plan brings s9 in after superstep 1, both capped
    at PR_SUPERSTEPS (one launch shares the engine's cap), each rank
    equal bit for bit to the single-process engine, the admitted column
    spliced at the same barrier on every rank."""
    from repro_torch.core.apps import MultiSourceBFS, PageRank
    from repro_torch.core.engine import EngineConfig
    from repro_torch.launch.cluster import ClusterConfig, run_cluster

    plan = ((1, (s9,)),)
    q = len(sources)
    # one process for the batched app at the same cap (PageRank is phase
    # 5's tiled run): the cluster's N = 1
    t0 = time.perf_counter()
    single = engine(store, tile_skipping=False, admit_plan=plan).run(
        MultiSourceBFS(sources=sources), max_supersteps=PR_SUPERSTEPS)
    log(f"cluster reference (one process): msbfs {PR_SUPERSTEPS} "
        f"supersteps in {time.perf_counter() - t0:.1f} s, admitted "
        f"{[h.admitted_queries for h in single.history]}")
    if single.history[1].admitted_queries != (q,):
        raise AssertionError("cluster reference: the ninth query was not "
                             "admitted after superstep 1")
    out, launches = [], {}
    for n in (2, 4):
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        parent_used = total - free     # this process's share of the card
        ecfg = EngineConfig(seg_impl="fused", tile_skipping=False,
                            admit_plan=plan, max_supersteps=PR_SUPERSTEPS)
        progs = [PageRank(), MultiSourceBFS(sources=sources)]
        t0 = time.perf_counter()
        res = run_cluster(store.root, progs, ClusterConfig(
            num_servers=n, device=DEV, engine=ecfg,
            launch_timeout_seconds=600))
        wall = time.perf_counter() - t0
        for a, want in enumerate((pr, single)):
            for r in range(n):
                got = res.rank_results[r][a]

                def events(run):
                    return [(x.admitted_queries, x.retired_queries,
                             x.updated_vertices) for x in run.history]

                if not (same_bits(got.values, want.values)
                        and got.supersteps == want.supersteps
                        and (a == 0 or np.array_equal(
                            got.per_query_supersteps,
                            want.per_query_supersteps))
                        and events(got) == events(want)):
                    raise AssertionError(f"cluster N={n} rank {r} app {a}: "
                                         "differs from one process")
                if ([x.wire_bytes for x in got.history]
                        != [x.wire_bytes for x in
                            res.rank_results[0][a].history]):
                    raise AssertionError(f"cluster N={n} rank {r}: wire "
                                         "bytes differ from rank 0's")
        launches[f"cluster N={n}"] = {
            k: sum(rep["launches"][k] for rep in res.rank_reports)
            for k in res.rank_reports[0]["launches"]}
        require_launches(launches[f"cluster N={n}"], ("gab_fused",),
                         f"cluster N={n}")
        # the ranks report at their last barrier, all alive: what the card
        # holds beyond this process and the ranks' torch pools is their
        # CUDA contexts and hub scratch
        reps = res.rank_reports
        outside = (max(r["card_used_bytes"] for r in reps) - parent_used
                   - sum(r["torch_reserved_bytes"] for r in reps)) / n
        row = dict(n=n, wall_s=wall, reports=reps, apps=[],
                   parent_card_bytes=parent_used,
                   outside_torch_bytes_per_rank=outside)
        for a, name in enumerate(("pagerank", f"msbfs Q={q}+1")):
            res_a = res.results[a]
            row["apps"].append(dict(
                app=name, supersteps=res_a.supersteps,
                steady_ms=steady_ms(res_a),
                per_superstep_ms=[1e3 * x.seconds for x in res_a.history],
                wire_bytes=[x.wire_bytes for x in res_a.history],
                raw_bytes=[x.raw_bytes for x in res_a.history],
                admitted=[list(x.admitted_queries) for x in res_a.history],
                exchange_seconds=[rep["exchange_seconds"][a]
                                  for rep in res.rank_reports]))
            ex = res.rank_reports[0]["exchange_seconds"][a]
            log(f"cluster N={n} {name}: {res_a.supersteps} supersteps, "
                f"{steady_ms(res_a):.1f} ms a superstep steady, wire "
                f"{[x.wire_bytes for x in res_a.history]} B; rank 0 "
                f"exchange " + ", ".join(f"{k.removeprefix('exchange_')} "
                                         f"{v:.2f} s" for k, v in ex.items()))
        for rep in res.rank_reports:
            log(f"  rank {rep['rank']} on {rep['device']}: {rep['seconds']:.1f}"
                f" s, sent {rep['wire_bytes']} B, launches {rep['launches']}, "
                f"torch reserved {rep.get('torch_reserved_bytes')} B, card "
                f"in use {rep.get('card_used_bytes')} B")
        log(f"cluster N={n}: {outside / 2**20:.0f} MiB a rank outside torch's "
            f"allocator (context, hub scratch; this process held "
            f"{parent_used / 2**20:.0f} MiB of the card)")
        log(f"cluster N={n}: {wall:.1f} s for the launch; every rank equal "
            f"to one process bit for bit, the admitted column spliced after "
            f"superstep 1 on every rank")
        out.append(row)
    return dict(single_msbfs=app_summary(f"msbfs Q={q}+1 one process",
                                         single),
                runs=out), launches, single


def checkpoint_files(d):
    """(bytes written, bytes hardlinked, blocks written, blocks hardlinked)
    of one published checkpoint directory: a file with more than one link
    is shared with the checkpoint before it."""
    out = [0, 0, 0, 0]
    for dirpath, _dirs, files in os.walk(d):
        for fn in files:
            st = os.stat(os.path.join(dirpath, fn))
            linked = st.st_nlink > 1
            out[1 if linked else 0] += st.st_size
            if fn.endswith(".blk"):
                out[3 if linked else 2] += 1
    return out


def timed_checkpointer(ckpt, saves, loads):
    """Time every save and load of a GraphCheckpointer (the engine's) and
    record each published checkpoint's bytes and blocks."""
    save, load = ckpt.save_graph, ckpt.load_graph

    def save_graph(superstep, *args, **kw):
        t0 = time.perf_counter()
        d = save(superstep, *args, **kw)
        dt = time.perf_counter() - t0
        w, lk, bw, bl = checkpoint_files(d)
        saves.append(dict(step=superstep, seconds=dt, bytes_written=w,
                          bytes_linked=lk, blocks_written=bw,
                          blocks_linked=bl))
        log(f"  checkpoint step {superstep}: {dt:.3f} s, {w} bytes written, "
            f"{lk} hardlinked; blocks {bw} written, {bl} hardlinked")
        return d

    def load_graph(*args, **kw):
        t0 = time.perf_counter()
        got = load(*args, **kw)
        loads.append(dict(step=None if got is None else got.step,
                          seconds=time.perf_counter() - t0))
        log(f"  checkpoint load of step {loads[-1]['step']}: "
            f"{loads[-1]['seconds']:.3f} s")
        return got

    ckpt.save_graph, ckpt.load_graph = save_graph, load_graph


def block_codec(d):
    """The codec of the interval blocks under checkpoint dir ``d``, sniffed
    from their first bytes (zstd's frame magic or zlib's header)."""
    heads = set()
    for p in sorted(glob.glob(os.path.join(d, "step_*", "blocks", "*.blk"))):
        with open(p, "rb") as f:
            head = f.read(4)
        heads.add("zstd" if head == b"\x28\xb5\x2f\xfd" else
                  "zlib" if head[:1] == b"\x78" else "other")
    return sorted(heads)


def crash_and_resume(make, prog, expect, what, max_supersteps):
    """Run ``make(resume=False)``'s engine until the fault it is armed with
    ends it (``expect`` is the exception that must come, anything else is
    re-raised), then a fresh ``make(resume=True)`` engine to the end.
    Returns (the exception, the resumed result, save rows, load rows)."""
    saves, loads = [], []
    eng = make(resume=False)
    timed_checkpointer(eng.ckpt, saves, loads)
    try:
        eng.run(prog(), max_supersteps=max_supersteps)
    except expect as e:
        caught = e
    else:
        raise AssertionError(f"{what}: the injected fault did not come")
    log(f"{what}: {type(caught).__name__}: {caught}")
    eng = make(resume=True)
    timed_checkpointer(eng.ckpt, saves, loads)
    res = eng.run(prog(), max_supersteps=max_supersteps)
    return caught, res, saves, loads


def checkpoint_engine(store, d, spec, resume, **kw):
    """An engine checkpointing every boundary into ``d``, armed with the
    fault ``spec`` unless it resumes."""
    from repro_torch.runtime.faults import FaultPlan

    return engine(store, tile_skipping=False, checkpoint_dir=d,
                  checkpoint_every=1, resume=resume,
                  fault_plan=None if resume else FaultPlan(specs=(spec,)),
                  **kw)


def checkpoint_ooc(torch, store_root, ckpt_root):
    """Phase 15 (c), in a side process: out-of-core PageRank at
    OOC_PR_BUDGET, OOC_CKPT_SUPERSTEPS supersteps, crashed at
    OOC_CKPT_CRASH_SS and resumed, its checkpoints interval blocks (the
    second hardlinking the unchanged ones), equal to the in-memory run."""
    from repro_torch import compat
    from repro_torch.core.apps import PageRank
    from repro_torch.runtime.faults import FaultSpec, InjectedFault

    store = open_store(store_root)
    d = os.path.join(ckpt_root, "pagerank_ooc")
    spec = FaultSpec(site="superstep", superstep=OOC_CKPT_CRASH_SS,
                     kind="raise")
    mem = engine(store, tile_skipping=False).run(
        PageRank(), max_supersteps=OOC_CKPT_SUPERSTEPS)
    reset_launches()
    t0 = time.perf_counter()
    _e, res, saves, loads = crash_and_resume(
        lambda resume: checkpoint_engine(store, d, spec, resume,
                                         num_intervals=OOC_INTERVALS,
                                         vertex_memory_budget=OOC_PR_BUDGET),
        PageRank, InjectedFault, "checkpoint pagerank ooc",
        OOC_CKPT_SUPERSTEPS)
    wall = time.perf_counter() - t0
    launches = read_launches()
    require_launches(launches, ("gab_fused",), "checkpoint ooc")
    codec = block_codec(d)
    want_codec = ["zstd"] if compat.HAVE_ZSTD else ["zlib"]
    boundaries = [r for r in saves if r["step"] <= OOC_CKPT_SUPERSTEPS]
    if not (same_bits(res.values, mem.values)
            and res.supersteps == OOC_CKPT_SUPERSTEPS
            and len(res.history) == OOC_CKPT_SUPERSTEPS - OOC_CKPT_CRASH_SS):
        raise AssertionError("checkpoint ooc: the resumed out-of-core run "
                             "differs from the in-memory one")
    if not (boundaries and all(r["blocks_written"] for r in boundaries)
            and boundaries[-1]["blocks_linked"] and codec == want_codec):
        raise AssertionError(f"checkpoint ooc: blocks {boundaries}, codec "
                             f"{codec}")
    out = dict(wall_s=wall, saves=saves, loads=loads, codec=codec,
               resumed=app_summary("pagerank ooc resumed", res))
    log(f"checkpoint pagerank ooc: {OOC_CKPT_SUPERSTEPS} supersteps, crash "
        f"at {OOC_CKPT_CRASH_SS}, interval blocks {codec}, equal to the "
        f"in-memory run bit for bit ({wall:.1f} s)")
    return out, launches


def checkpoint_phase(torch, store, pr, single, sources, s9, ckpt_root,
                     ooc_part):
    """Phase 15: superstep checkpoints, crash and preemption resume and a
    supervised cluster shrink on the card, each part equal bit for bit to
    its uninterrupted run and each launching gab_fused.  Part c
    (checkpoint_ooc) ran in a side process: ``ooc_part`` is its result."""
    from repro_torch.core.apps import MultiSourceBFS, PageRank
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.partition import assign_tiles
    from repro_torch.launch.cluster import ClusterConfig, run_cluster
    from repro_torch.runtime.elastic import remap_assignment
    from repro_torch.runtime.faults import FaultPlan, FaultSpec, InjectedFault
    from repro_torch.runtime.ft import Preempted

    out, launches = {}, {}
    plan = store.load_plan()

    def ckpt_engine(d, spec, resume, **kw):
        return checkpoint_engine(store, d, spec, resume, **kw)

    # a: crash and resume in one process, PageRank tiled
    d = os.path.join(ckpt_root, "pagerank")
    spec = FaultSpec(site="superstep", superstep=CKPT_CRASH_SS, kind="raise")
    reset_launches()
    t0 = time.perf_counter()
    _e, res, saves, loads = crash_and_resume(
        lambda resume: ckpt_engine(d, spec, resume), PageRank, InjectedFault,
        "checkpoint pagerank", PR_SUPERSTEPS)
    wall = time.perf_counter() - t0
    if not (same_bits(res.values, pr.values)
            and res.supersteps == PR_SUPERSTEPS
            and len(res.history) == PR_SUPERSTEPS - CKPT_CRASH_SS):
        raise AssertionError("checkpoint: the resumed PageRank differs from "
                             "the uninterrupted run")
    part_a = read_launches()
    require_launches(part_a, ("gab_fused",), "checkpoint pagerank")
    out["pagerank"] = dict(wall_s=wall, saves=saves, loads=loads,
                           resumed=app_summary("pagerank resumed", res))
    log(f"checkpoint pagerank: crash at superstep {CKPT_CRASH_SS}, resumed "
        f"from boundary {loads[-1]['step']}, equal to phase 5 bit for bit "
        f"({wall:.1f} s)")

    # b: preemption with a scheduled admission, MultiSourceBFS Q = 8 -> 9
    d = os.path.join(ckpt_root, "msbfs")
    spec = FaultSpec(site="barrier", superstep=CKPT_PREEMPT_SS,
                     kind="preempt")
    reset_launches()
    t0 = time.perf_counter()
    caught, res, saves, loads = crash_and_resume(
        lambda resume: ckpt_engine(d, spec, resume, preemptible=not resume,
                                   admit_plan=((1, (s9,)),)),
        lambda: MultiSourceBFS(sources=sources), Preempted,
        "checkpoint msbfs", PR_SUPERSTEPS)
    wall = time.perf_counter() - t0
    if caught.superstep != CKPT_PREEMPT_SS + 1:
        raise AssertionError(f"checkpoint: preempted at {caught.superstep}")
    if not (same_bits(res.values, single.values)
            and res.supersteps == PR_SUPERSTEPS
            and np.array_equal(res.per_query_supersteps,
                               single.per_query_supersteps)):
        raise AssertionError("checkpoint: the resumed MultiSourceBFS "
                             "differs from phase 14's one-process run")
    part_b = read_launches()
    require_launches(part_b, ("gab_fused",), "checkpoint msbfs")
    launches["checkpoint"] = {k: part_a[k] + part_b[k] for k in part_a}
    out["msbfs"] = dict(wall_s=wall, saves=saves, loads=loads,
                        preempted_at=caught.superstep,
                        resumed=app_summary(f"msbfs Q={len(sources)}+1 "
                                            "resumed", res))
    log(f"checkpoint msbfs: preempted at boundary {caught.superstep}, the "
        f"resume equals phase 14's one-process run bit for bit "
        f"({wall:.1f} s)")

    # c: out of core, interval blocks (checkpoint_ooc, a side process)
    out["pagerank_ooc"], launches["checkpoint ooc"] = ooc_part

    # d: supervised shrink of a spawned cluster on the card
    d = os.path.join(ckpt_root, "cluster")
    markers = os.path.join(ckpt_root, "cluster_markers")
    kill_ss, kill_rank = SHRINK_KILL
    ecfg = EngineConfig(
        seg_impl="fused", tile_skipping=False, max_supersteps=PR_SUPERSTEPS,
        checkpoint_dir=d, checkpoint_every=1,
        checkpoint_keep=PR_SUPERSTEPS + 2,
        fault_plan=FaultPlan(specs=(FaultSpec(
            site="barrier", superstep=kill_ss, rank=kill_rank,
            kind="kill"),), marker_dir=markers))
    reset_launches()       # the ranks count in their processes and report
    t0 = time.perf_counter()
    res = run_cluster(store.root, [PageRank()], ClusterConfig(
        num_servers=SHRINK_FROM, device=DEV, on_failure="shrink",
        engine=ecfg, launch_timeout_seconds=600))
    wall = time.perf_counter() - t0
    want_asg = remap_assignment(assign_tiles(plan.num_tiles, SHRINK_FROM),
                                SHRINK_FROM - 1, plan.edges_per_tile)
    got = res.results[0]
    if not (res.verified and res.restarts == 1
            and res.final_servers == SHRINK_FROM - 1
            and len(res.rank_reports) == SHRINK_FROM - 1
            and all(r["final_assignment"] == want_asg
                    for r in res.rank_reports)
            and same_bits(got.values, pr.values)
            and got.supersteps == PR_SUPERSTEPS):
        raise AssertionError("cluster restart: the shrunk cluster differs "
                             "from one process")
    launches["cluster restart"] = {
        k: sum(rep["launches"][k] for rep in res.rank_reports)
        for k in res.rank_reports[0]["launches"]}
    require_launches(launches["cluster restart"], ("gab_fused",),
                     "cluster restart")
    # the kill's time is its once-marker's (claimed just before the
    # os._exit); the new attempt's first superstep ends with rank 0's
    # first boundary checkpoint, the one after the boundary it resumed from
    (marker,) = glob.glob(os.path.join(markers, "*.fired"))
    killed_at = os.stat(marker).st_mtime
    resumed_from = PR_SUPERSTEPS - len(got.history)
    meta = os.path.join(d, "prog_00", f"step_{resumed_from + 1:08d}",
                        "meta.json")
    respawn_s = os.stat(meta).st_mtime - killed_at
    out["cluster"] = dict(
        wall_s=wall, restarts=res.restarts, final_servers=res.final_servers,
        resumed_from=resumed_from, kill_to_first_superstep_s=respawn_s,
        assignment=want_asg, reports=res.rank_reports,
        resumed=app_summary("pagerank cluster resumed", got))
    log(f"cluster restart: rank {kill_rank} of {SHRINK_FROM} killed at the "
        f"barrier of superstep {kill_ss}; 1 restart on "
        f"{SHRINK_FROM - 1} ranks (remapped assignment) from boundary "
        f"{resumed_from}; kill to the new attempt's first superstep "
        f"{respawn_s:.1f} s; rank 0 equal to one process bit for bit "
        f"({wall:.1f} s)")
    for rep in res.rank_reports:
        log(f"  rank {rep['rank']}: {rep['seconds']:.1f} s, "
            f"{len(rep['final_assignment'][rep['rank']])} tiles, launches "
            f"{rep['launches']}")
    return out, launches


def http_call(url, body=None, timeout=60):
    """One JSON request (POST when ``body`` is given, else GET); returns
    (status, Retry-After header or None, decoded JSON body)."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers.get("Retry-After"), json.loads(
                r.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Retry-After"), json.loads(e.read())


def serve_clients(base, queries):
    """One client thread a query: POST it, then poll its rid until the
    ticket is terminal.  Returns the terminal tickets, in order."""
    out, errors = [None] * len(queries), []

    def client(i, body):
        try:
            code, _, posted = http_call(base + "/v1/query", body)
            if code != 200:
                raise AssertionError(f"POST {body}: {code} {posted}")
            deadline = time.monotonic() + SERVE_CLIENT_TIMEOUT_S
            while time.monotonic() < deadline:
                code, _, t = http_call(f"{base}/v1/query/{posted['rid']}")
                if code != 200:
                    raise AssertionError(f"GET {posted['rid']}: {code} {t}")
                if t["status"] in ("done", "timeout", "failed"):
                    out[i] = t
                    return
                time.sleep(SERVE_POLL_S)
            raise AssertionError(f"rid {posted['rid']} never finished")
        except Exception as e:  # surfaced below, in the caller's thread
            errors.append((body, e))

    threads = [threading.Thread(target=client, args=(i, body))
               for i, body in enumerate(queries)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(SERVE_CLIENT_TIMEOUT_S + 60)
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"serve clients failed: {errors}")
    return out


def pick_serve_seeds(out_degree, sources, s9, s10):
    """SERVE_LANDMARKS landmark seeds drawn from SEED among the vertices
    with out-degree > 0 that no earlier phase used, and the deadline
    query's source: the vertex of largest out-degree among those left
    (its BFS runs several supersteps, so a drain leaves a partial
    column)."""
    rng = np.random.default_rng(SEED + 16)
    used = np.asarray(list(sources) + [s9, s10])
    cand = np.setdiff1d(np.nonzero(out_degree > 0)[0], used)
    landmarks = tuple(int(v) for v in rng.choice(cand, SERVE_LANDMARKS,
                                                 replace=False))
    left = np.setdiff1d(cand, np.asarray(landmarks))
    return landmarks, int(left[np.argmax(out_degree[left])])


def serve_phase(torch, store, src, dst, sources, msbfs, levels, s9, s10):
    """Phase 16: the online query service on the card behind its HTTP
    frontend.  GraphService over the store (device cuda, the fused
    kernel, tile skipping off, q_slots 8, min_fill 4, max_wait 50 ms,
    tenants alice:3 and bob:1, a result cache of 64 entries) fronted by
    HttpFrontend on 127.0.0.1:0; client threads POST and poll.  Wave 1:
    MultiSourceBFS from the eight batched sources and LandmarkDistances
    from two new seeds; wave 2: LandmarkDistances from two more and one
    MultiSourceBFS query with a SERVE_DEADLINE_MS deadline, drained as
    ``timeout``; wave 3: repeats of finished seeds, which come back as
    cache hits with no slot used.  Every done column, decoded from its
    HTTP body, equals the reference BFS levels, and the sources' columns equal
    phase 8's direct batched run bit for bit with equal per-query
    supersteps.  Then the drain: /healthz and POST answer 503 with
    Retry-After, and GET still answers for every rid.  The launch counts
    are read around the service's life ("serve"); the Q of every fused
    launch is recorded, and the fused kernel is held to its plain version
    at each (program, Q) the service launched it at."""
    from repro_torch.core.apps import LandmarkDistances, MultiSourceBFS
    from repro_torch.core.engine import EngineConfig
    from repro_torch.kernels import gab_fused
    from repro_torch.serve.graph_service import GraphService
    from repro_torch.serve.http import HttpFrontend, decode_array

    nv = store.load_plan().num_vertices
    out_degree = store.load_degrees()[1]
    landmarks, late = pick_serve_seeds(out_degree, sources, s9, s10)
    t0 = time.perf_counter()
    lm_levels = ref_bfs(torch, src, dst, nv, landmarks + (late,))
    log(f"serve: landmarks {landmarks}, deadline source {late} "
        f"(reference BFS {time.perf_counter() - t0:.1f} s)")
    want = {("msbfs", s): levels[:, q] for q, s in enumerate(sources)}
    want.update({("landmarks", s): lm_levels[:, i]
                 for i, s in enumerate(landmarks)})
    depth = {q: int(levels[np.isfinite(levels[:, q]), q].max())
             for q in range(len(sources))}
    # per-query supersteps of a BFS column against its depth, from the
    # direct run; every served BFS-like column must keep the same offset
    offsets = {int(msbfs.per_query_supersteps[q]) - depth[q] for q in depth}
    if len(offsets) != 1:
        raise AssertionError(f"serve: supersteps - depth not one value: "
                             f"{offsets}")
    offset = offsets.pop()

    closed = []

    class MeasuredService(GraphService):
        """The service, logging the device's memory after each closed
        session (on the serve thread, after the session released its
        state)."""

        def _close_session(self, app, sess):
            super()._close_session(app, sess)
            torch.cuda.synchronize()
            closed.append(dict(
                app=app, supersteps=sess.superstep,
                allocated=torch.cuda.memory_allocated(),
                reserved=torch.cuda.memory_reserved(),
                non_torch=logged_non_torch_bytes(torch)))

    specs = {MultiSourceBFS().fused_spec(): "msbfs",
             LandmarkDistances().fused_spec(): "landmarks"}
    fused_q = {}
    kernel = gab_fused.gab_fused

    def recording(spec, src_vals, *args, **kw):
        key = (specs.get(spec, str(spec)),
               1 if src_vals.ndim == 1 else int(src_vals.shape[1]))
        fused_q[key] = fused_q.get(key, 0) + 1
        return kernel(spec, src_vals, *args, **kw)

    cfg = EngineConfig(num_servers=1, device=DEV, seg_impl="fused",
                       tile_skipping=False)
    svc = MeasuredService(store, cfg, q_slots=SERVE_Q_SLOTS,
                          min_fill=SERVE_MIN_FILL,
                          max_wait_s=SERVE_MAX_WAIT_S,
                          tenants=SERVE_TENANTS,
                          result_cache=SERVE_CACHE)
    fe = HttpFrontend(svc, host="127.0.0.1", port=0).start()
    base = fe.address
    tenants = sorted(SERVE_TENANTS)
    torch.cuda.synchronize()
    mem0 = dict(allocated=torch.cuda.memory_allocated(),
                reserved=torch.cuda.memory_reserved(),
                non_torch=logged_non_torch_bytes(torch))
    log(f"serve: {svc.cfg.device}, frontend {base}; before: {mem0}")
    gab_fused.gab_fused = recording
    try:
        reset_launches()
        t_serve = time.perf_counter()
        svc.start()
        wave1 = serve_clients(base, [
            dict(app="msbfs", seed=s, tenant=tenants[i % 2])
            for i, s in enumerate(sources)] + [
            dict(app="landmarks", seed=s, tenant=tenants[i % 2])
            for i, s in enumerate(landmarks[:2])])
        wave2 = serve_clients(base, [
            dict(app="landmarks", seed=s, tenant=tenants[i % 2])
            for i, s in enumerate(landmarks[2:])] + [
            dict(app="msbfs", seed=late, tenant=tenants[0],
                 deadline_ms=SERVE_DEADLINE_MS)])
        before_hits = svc.stats_snapshot()
        wave3 = serve_clients(base, [
            dict(app="msbfs", seed=sources[0], tenant=tenants[0]),
            dict(app="msbfs", seed=sources[1], tenant=tenants[1]),
            dict(app="landmarks", seed=landmarks[0], tenant=tenants[0])])
        after_hits = svc.stats_snapshot()
        svc.request_drain()
        svc.join(600)
        serve_s = time.perf_counter() - t_serve
        launches = read_launches()
    finally:
        gab_fused.gab_fused = kernel
    if svc._thread.is_alive():
        raise AssertionError("serve: the serve thread did not drain")
    require_launches(launches, ("gab_fused",), "serve")

    # the drain: healthz and POST refuse with Retry-After, GET answers
    code, retry, _ = http_call(base + "/healthz")
    pcode, pretry, _ = http_call(base + "/v1/query",
                                 dict(app="msbfs", seed=sources[0]))
    if (code, retry, pcode, pretry) != (503, "1", 503, "1"):
        raise AssertionError(f"serve: drained /healthz {code} {retry}, "
                             f"POST {pcode} {pretry}")
    for t in wave1 + wave2 + wave3:
        code, _, again = http_call(f"{base}/v1/query/{t['rid']}")
        if code != 200 or again["status"] != t["status"]:
            raise AssertionError(f"serve: GET {t['rid']} after the drain: "
                                 f"{code} {again.get('status')}")
    snap = svc.stats_snapshot()
    http_counts = fe.counters()
    fe.close()
    stats = snap["stats"]
    if stats["submitted"] != (stats["done"] + stats["timeout"]
                              + stats["failed"] + stats["refused"]):
        raise AssertionError(f"serve: counters do not add up: {stats}")

    # every done column against the reference, the sources' against phase 8's run
    for t in wave1 + wave2[:-1]:
        col = decode_array(t["result"])
        key = (t["app"], t["seed"])
        if t["status"] != "done" or t["cache_hit"]:
            raise AssertionError(f"serve: {key} ended {t['status']}")
        if not same_bits(col, want[key]):
            raise AssertionError(f"serve: {key} differs from the reference "
                                 "BFS")
        d = int(want[key][np.isfinite(want[key])].max())
        if t["supersteps"] != d + offset:
            raise AssertionError(f"serve: {key} took {t['supersteps']} "
                                 f"supersteps, its depth {d}")
        if t["app"] == "msbfs":
            q = sources.index(t["seed"])
            if not (same_bits(col, msbfs.values[:, q])
                    and t["supersteps"] == msbfs.per_query_supersteps[q]):
                raise AssertionError(f"serve: {key} differs from the "
                                     "direct batched run")
    # the deadline query: drained with a partial column, never cached
    dl = wave2[-1]
    part = decode_array(dl["result"])
    lv = lm_levels[:, -1]
    k = int(part[np.isfinite(part)].max())
    if not (dl["status"] == "timeout" and dl["supersteps"] == -1
            and k < int(lv[np.isfinite(lv)].max())
            and same_bits(part, np.where(lv <= k, lv,
                                         np.float32(np.inf)))):
        raise AssertionError(f"serve: the deadline query ended "
                             f"{dl['status']}, not a partial BFS")
    with svc.cache._lock:
        if ("msbfs", late, svc.fingerprint) in svc.cache._entries:
            raise AssertionError("serve: a timeout column was cached")
    # the repeats: cache hits, equal bytes, no slot, no superstep
    firsts = {(t["app"], t["seed"]): t for t in wave1}
    for t in wave3:
        orig = firsts[(t["app"], t["seed"])]
        if not (t["status"] == "done" and t["cache_hit"]
                and t["supersteps"] == orig["supersteps"]
                and t["result"] == orig["result"]):
            raise AssertionError(f"serve: repeat {t['app']} {t['seed']} is "
                                 "not a cache hit of its first answer")
    b, a = before_hits, after_hits
    if not (a["stats"]["sessions_opened"] == b["stats"]["sessions_opened"]
            and a["stats"]["supersteps"] == b["stats"]["supersteps"]
            and a["stats"]["cache_hits"] == b["stats"]["cache_hits"] + 3
            and all(a["tenants"][n]["admitted"]
                    == b["tenants"][n]["admitted"] for n in tenants)):
        raise AssertionError(f"serve: cache hits used a slot: {b} -> {a}")

    lat = svc.latency_summary()
    qps = stats["done"] / serve_s
    log(f"serve: {stats['done']} done ({stats['cache_hits']} cache hits), "
        f"{stats['timeout']} timeout, {stats['refused']} refused in "
        f"{serve_s:.1f} s: {qps:.3f} queries/s, {stats['supersteps']} "
        f"supersteps, {stats['sessions_opened']} sessions; latency p50 "
        f"{lat['p50_ms']:.1f} ms, p99 {lat['p99_ms']:.1f} ms, mean queue "
        f"{lat['mean_queue_ms']:.1f} ms + service {lat['mean_service_ms']:.1f}"
        f" ms; tenants {snap['tenants']}; http {http_counts}")
    log(f"serve: fused launches by (program, Q): "
        f"{dict(sorted(fused_q.items()))}")
    for row in closed:
        log(f"serve: closed a {row['app']} session after {row['supersteps']}"
            f" supersteps: torch allocated {row['allocated']}, reserved "
            f"{row['reserved']}, outside torch {row['non_torch']} bytes")
    if sum(fused_q.values()) != launches["gab_fused"]:
        raise AssertionError(f"serve: {sum(fused_q.values())} fused calls "
                             f"recorded, {launches['gab_fused']} counted")

    rows = check_serve_shapes(torch, store, fused_q)
    return dict(landmarks=list(landmarks), deadline_source=late,
                seconds=serve_s, queries_per_s=qps, stats=stats,
                tenants=snap["tenants"], cache=snap["cache"],
                http=http_counts, latency=lat, memory_before=mem0,
                closed_sessions=closed,
                fused_launches_by_q=[[app, q, n] for (app, q), n
                                     in sorted(fused_q.items())],
                kernel_cases=rows), {"serve": launches}


def check_serve_shapes(torch, store, fused_q):
    """The fused kernel at each (program, Q) the service launched it at,
    on the largest tile, against its plain version and the merged-mode
    composition (as phase 4), with the batched programs themselves."""
    from repro_torch.core.apps import LandmarkDistances, MultiSourceBFS

    plan = store.load_plan()
    tile = store.read_tile(int(np.argmax(plan.edges_per_tile)))
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    dst = torch.from_numpy(tile.dst_local).to(dev)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    progs = {"msbfs": MultiSourceBFS(), "landmarks": LandmarkDistances()}
    rows = []
    for app, q in sorted(fused_q):
        case = fused_inputs(torch, progs[app], dst, tile.meta.num_rows,
                            plan.row_cap, q, gen)
        row = check_fused_case(torch, case, flush, f"serve shape: fused "
                               f"{app} Q={q}")
        rows.append(dict(spec=app, launches=fused_q[(app, q)], **row))
    del flush
    torch.cuda.empty_cache()
    return rows


TUNE_FUSED = (("pagerank", 1), ("pagerank", 8), ("bfs", 1), ("bfs", 8),
              ("bfs", 9), ("landmarks", 2), ("landmarks", 8))
TUNE_SEGMENT_Q = (1, 8)


def calibrate_tuner(torch, flush, tile, plan):
    """Phase 17a: roofline/hw.py's measured figures, measured again and
    logged beside the table's (the tuner reads the table, never this):
    launch_s, the device time of a fused call over 32 edges and rows (a
    launch and one row block); host_call_s, the host time of such a
    call (wall time of 2,000 back to back); stack_dispatch_s, the host
    time of gab.run_tile_stack over one such tile beyond the call
    inside it; row_wave_s, a wave of row blocks beyond its bytes (the
    segment sum over 2^20 rows of one edge each, at each block_r); hub_s,
    a hub beyond its bytes (the segment sum over 2^20 edges in rows of
    513 edges, every row a hub at H = 256, ceil(hubs / 512) hubs a
    group); edge_warp_s, an edge of the longest row the row launch keeps
    (the slope of the fused BFS kernel's time at Q = 1 and 256 rows a
    block on the largest tile from H = 256 to 2048: 4,095 - 511 more
    edges); hub_share, the largest tile's hubs at H = 256 over the most
    its edge list can hold (E / 2H)."""
    from repro_torch.core import apps
    from repro_torch.core.gab import run_tile_stack
    from repro_torch.kernels import gab_fused, gab_gather
    from repro_torch.kernels.blocks import BLOCK_R
    from repro_torch.roofline import hw, kernel_tune

    dev = torch.device(DEV)
    spec = apps.BFS().fused_spec()
    n = 32
    d32 = torch.arange(n, dtype=torch.int32, device=dev)
    s32 = torch.rand(n, device=dev)
    o32 = torch.rand(n, device=dev)

    def tiny():
        return gab_fused.gab_fused(spec, s32, None, None, d32, o32, None,
                                   n, n)

    launch_ms = time_ms(torch, tiny, flush, reps=50)
    reps = 2000
    tiny()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        tiny()
    torch.cuda.synchronize()
    host_call_s = (time.perf_counter() - t0) / reps
    values = torch.rand(4096, device=dev)
    stk = dict(src=np.arange(n, dtype=np.int32)[None],
               dst_local=np.arange(n, dtype=np.int32)[None],
               val=np.ones((1, n), np.float32), row_start=np.zeros(1, int),
               num_rows=np.full(1, n))
    prog = apps.BFS()
    run_tile_stack(prog, values, {}, stk, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps // 4):
        run_tile_stack(prog, values, {}, stk, n)
    torch.cuda.synchronize()
    stack_s = (time.perf_counter() - t0) / (reps // 4) - host_call_s

    e = 1 << 20
    ones = torch.rand(e, device=dev)
    d1 = torch.arange(e, dtype=torch.int32, device=dev)
    wave_s = {}
    for br in BLOCK_R:
        t = time_ms(torch, lambda: gab_gather.segment_reduce(
            ones, d1, e, "sum", blocks=(256, br)), flush) / 1e3
        waves = -(-(-(-e // br)) // (hw.SMS * kernel_tune.blocks_per_sm(br)))
        wave_s[br] = (t - e * 12 / hw.HBM_BW) / waves
    hub_len = 2 * 256 + 1
    hubs = e // hub_len
    dh = torch.arange(hubs, dtype=torch.int32,
                      device=dev).repeat_interleave(hub_len).contiguous()
    ch = torch.rand(dh.shape[0], device=dev)
    t = time_ms(torch, lambda: gab_gather.segment_reduce(
        ch, dh, hubs, "sum", blocks=(256, 256)), flush) / 1e3
    groups = min((dh.shape[0] - 1) // 256, kernel_tune.HUB_GROUPS_MAX)
    hub_s = (t - dh.shape[0] * 8 / hw.HBM_BW) / -(-hubs // groups)
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    dtile = torch.from_numpy(tile.dst_local).to(dev)
    args, _ = fused_inputs(torch, apps.BFS(), dtile, tile.meta.num_rows,
                           plan.row_cap, 1, gen)
    t_h = {h: time_ms(torch, lambda h=h: gab_fused.gab_fused(
        *args, blocks=(h, 256)), flush) / 1e3 for h in (256, 2048)}
    edge_warp_s = (t_h[2048] - t_h[256]) / ((2 * 2048 - 1) - (2 * 256 - 1))
    d = tile.dst_local.astype(np.int64)
    m = np.arange((len(d) - 1) // 256) * 256
    r = d[m]
    hub = ((r < tile.meta.num_rows) & (d[m + 256] == r)
           & ((m == 0) | (d[np.maximum(m - 256, 0)] != r)))
    hub_share = float(hub.sum()) / (len(d) / (2 * 256))
    out = dict(launch_s=launch_ms / 1e3, host_call_s=host_call_s,
               edge_warp_s=edge_warp_s, hub_share=hub_share,
               stack_dispatch_s=stack_s, row_wave_s=wave_s,
               row_wave_s_mean=float(np.mean(list(wave_s.values()))),
               hub_s=hub_s,
               table=dict(launch_s=hw.LAUNCH_S,
                          stack_dispatch_s=hw.STACK_DISPATCH_S,
                          row_wave_s=hw.ROW_WAVE_S, hub_s=hw.HUB_S,
                          edge_warp_s=hw.EDGE_WARP_S,
                          hub_share=hw.HUB_SHARE,
                          measured_on=hw.MEASURED_ON))
    log(f"tuner calibration: launch {out['launch_s'] * 1e6:.2f} us (table "
        f"{hw.LAUNCH_S * 1e6:.2f}), host call {host_call_s * 1e6:.2f} us, "
        f"stack dispatch {stack_s * 1e6:.2f} us (table "
        f"{hw.STACK_DISPATCH_S * 1e6:.2f}), row wave "
        + ", ".join(f"{k}: {v * 1e6:.2f}" for k, v in wave_s.items())
        + f" us (table {hw.ROW_WAVE_S * 1e6:.2f}), hub {hub_s * 1e6:.2f} us "
        f"(table {hw.HUB_S * 1e6:.2f}; {hubs} hubs, {groups} groups), edge "
        f"of the longest kept row {edge_warp_s * 1e9:.2f} ns (table "
        f"{hw.EDGE_WARP_S * 1e9:.2f}), hub share {hub_share:.4f} (table "
        f"{hw.HUB_SHARE:.4f}; {int(hub.sum())} hubs at H = 256)")
    return out


def tune_candidates(torch, tile, plan, flush):
    """Phase 17b: at the largest tile's shape, every legal (block_e,
    block_r) of the fused kernel (PageRank, BFS and landmarks specs at
    the Q's the paths launch) and of the segment sum (Q = 1 and 8, into
    row_cap + 1 rows): new and updated (out) equal to the default blocks'
    bit for bit, each timed as phase 4 times, beside the tuner's
    prediction; per case the pick's time over the best time.  Returns
    (the per-case rows, the kernels line's tuned entries' rows)."""
    from repro_torch.core import apps
    from repro_torch.kernels import gab_fused, gab_gather, ref
    from repro_torch.kernels.blocks import BLOCK_E, BLOCK_R, DEFAULT_BLOCKS
    from repro_torch.roofline import kernel_tune

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    dst = torch.from_numpy(tile.dst_local).to(dev)
    nr, r, e = tile.meta.num_rows, plan.row_cap, plan.edge_cap
    progs = {"pagerank": apps.PageRank(), "bfs": apps.BFS(),
             "landmarks": apps.LandmarkDistances(landmarks=(0, 1))}
    pairs = [(be, br) for be in BLOCK_E for br in BLOCK_R]
    cases = []
    for name, q in TUNE_FUSED:
        args, _ = fused_inputs(torch, progs[name], dst, nr, r, q, gen)
        spec = args[0]
        cases.append(dict(
            kernel="gab_fused", spec=name, q=q, combine=spec.combine,
            run=lambda bl, a=args: gab_fused.gab_fused(*a, blocks=bl),
            plain=lambda a=args: ref.gab_fused_ref(*a),
            bound=fused_bound(args), library=None))
    for q in TUNE_SEGMENT_Q:
        c = torch.rand((e,) if q == 1 else (e, q), generator=gen, device=dev)
        idx = dst.long() if q == 1 else dst.long()[:, None].expand(
            e, q).contiguous()
        init = torch.zeros((r + 1,) + tuple(c.shape[1:]), device=dev)
        cases.append(dict(
            kernel="segment_reduce", spec="sum", q=q, combine="sum",
            run=lambda bl, c=c: (gab_gather.segment_reduce(
                c, dst, r + 1, "sum", blocks=bl),),
            plain=lambda c=c: ref.segment_reduce(c, dst, r + 1, "sum"),
            bound=bound(e * 4 + e * 4 * q + (r + 1) * 4 * q, e * q),
            library=lambda c=c, i=idx, z=init: torch.scatter_reduce(
                z, 0, i, c, "sum")))
    rows = []
    for case in cases:
        want = case["run"](None)
        pick = kernel_tune.pick_blocks(case["combine"], case["q"], e, r)
        cands = []
        for bl in pairs:
            got = case["run"](bl)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(
                    f"tune {case['kernel']} {case['spec']} Q={case['q']}: "
                    f"blocks {bl} differ from the default's")
            ms = time_ms(torch, lambda bl=bl: case["run"](bl), flush)
            pred = kernel_tune.tile_cost(case["combine"], case["q"], e, r,
                                         *bl).predicted_s * 1e3
            cands.append(dict(blocks=list(bl), ms=ms, predicted_ms=pred))
        best = min(cands, key=lambda c: c["ms"])
        by = {tuple(c["blocks"]): c for c in cands}
        pick_ms = by[pick.blocks]["ms"]
        plain = case["plain"]()
        plain = plain[0] if isinstance(plain, tuple) else plain
        row = dict(kernel=case["kernel"], spec=case["spec"], q=case["q"],
                   pick=list(pick.blocks), stack_size=pick.stack_size,
                   pick_ms=pick_ms, best=best["blocks"], best_ms=best["ms"],
                   default_ms=by[DEFAULT_BLOCKS]["ms"],
                   pick_over_best=pick_ms / best["ms"],
                   candidates=cands, bound_ms=case["bound"][0],
                   bound_by=case["bound"][1],
                   max_abs_err=max_abs_err(torch, want[0], plain),
                   kernel_ms=pick_ms,
                   plain_ms=time_ms(torch, case["plain"], flush),
                   library_ms=(None if case["library"] is None else
                               time_ms(torch, case["library"], flush)))
        rows.append(row)
        log(f"tune {case['kernel']} {case['spec']} Q={case['q']}: "
            f"{len(pairs)} pairs equal to the default bit for bit; pick "
            f"{pick.blocks} {pick_ms:.4f} ms (predicted "
            f"{by[pick.blocks]['predicted_ms']:.4f}), best "
            f"{tuple(best['blocks'])} {best['ms']:.4f} ms, default "
            f"{row['default_ms']:.4f} ms; pick / best "
            f"{row['pick_over_best']:.3f}; "
            + ", ".join(f"{tuple(c['blocks'])} {c['ms']:.4f}/"
                        f"{c['predicted_ms']:.4f}" for c in cands))
    return rows


def tune_engine_runs(torch, store, pr, msbfs, sources):
    """Phase 17c: the engine with kernel_autotune at the depth of a
    default-block run, each equal to it bit for bit and each launching
    the fused kernel at the tuner's blocks: tiled PageRank for
    PR_SUPERSTEPS (phase 5's run), MultiSourceBFS at Q = 8 tiled and
    pipelined (the tuner's stack size) to convergence (phase 8's run).
    The launch counters are read around the three runs ("tune")."""
    from repro_torch.core.apps import MultiSourceBFS, PageRank

    reset_launches()
    eng = engine(store, tile_skipping=False, kernel_autotune=True)
    p = eng.run(PageRank(), max_supersteps=PR_SUPERSTEPS)
    picks = {"pagerank": eng.kernel_choice}
    if not same_bits(p.values, pr.values):
        raise AssertionError("tune: autotuned pagerank differs from the "
                             "default blocks' run")
    rows = [dict(app="pagerank", mode="tiled",
                 blocks=list(eng.kernel_choice.blocks),
                 stack_size=eng.kernel_choice.stack_size,
                 summary=app_summary("pagerank autotuned", p))]
    for pipeline in (False, True):
        eng = engine(store, tile_skipping=False, kernel_autotune=True,
                     pipeline=pipeline)
        m = eng.run(MultiSourceBFS(sources=sources),
                    max_supersteps=BFS_MAX_SUPERSTEPS)
        name = "pipelined" if pipeline else "tiled"
        if not (same_bits(m.values, msbfs.values)
                and np.array_equal(m.per_query_supersteps,
                                   msbfs.per_query_supersteps)):
            raise AssertionError(f"tune: autotuned msbfs ({name}) differs "
                                 "from the default blocks' run")
        c = eng.kernel_choice
        picks[f"msbfs {name}"] = c
        rows.append(dict(app=f"msbfs Q={len(sources)}", mode=name,
                         blocks=list(c.blocks), stack_size=c.stack_size,
                         summary=app_summary(f"msbfs {name} autotuned",
                                             m)))
        del eng
        torch.cuda.empty_cache()
    launches = read_launches()
    require_launches(launches, ("gab_fused",), "tune")
    log("tune: autotuned runs equal the default blocks' bit for bit: "
        + ", ".join(f"{k} {c.blocks} stack {c.stack_size}"
                    for k, c in picks.items()))
    return rows, launches


def baselines_phase(torch, store, src, dst, pr):
    """Phase 18: the paper's comparison engines (core/baselines.py) on the
    main store's graph with device="cuda", PageRank for
    BASELINE_SUPERSTEPS each, against a float64 power iteration at that
    depth (rtol PR_RTOL), each's ms a superstep beside the tiled GAB
    engine's (phase 5) — the paper's Fig. 10 comparison.  Their edge and
    message files go to build/ and are removed."""
    from repro_torch.core.apps import PageRank
    from repro_torch.core.baselines import ENGINES

    nv = store.load_plan().num_vertices
    out_degree = store.load_degrees()[1]
    want = ref_pagerank(torch, src, dst, out_degree, nv,
                        BASELINE_SUPERSTEPS)
    work = os.path.join(ROOT, "build", "chip_smoke_baselines")
    rows = []
    for name, cls in ENGINES.items():
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        kw = dict(workdir=work) if name in ("graphd", "chaos") else {}
        t0 = time.perf_counter()
        eng = cls(src, dst, None, nv, device=DEV, **kw)
        build_s = time.perf_counter() - t0
        res = eng.run(PageRank(), max_supersteps=BASELINE_SUPERSTEPS)
        del eng
        torch.cuda.empty_cache()
        shutil.rmtree(work, ignore_errors=True)
        rel = float(np.max(np.abs(res.values - want) / want))
        if len(res.history) != BASELINE_SUPERSTEPS or rel > PR_RTOL:
            raise AssertionError(f"baseline {name}: {len(res.history)} "
                                 f"supersteps, max rel err {rel:.3g} against "
                                 "float64")
        h = res.history
        rows.append(dict(
            engine=name, build_s=build_s, max_rel_err=rel,
            ms_per_superstep=[x.seconds * 1e3 for x in h],
            network_bytes=[x.network_bytes for x in h],
            disk_read_bytes=[x.disk_read_bytes for x in h],
            disk_write_bytes=[x.disk_write_bytes for x in h]))
        ms = ", ".join(f"{x.seconds * 1e3:.1f}" for x in h)
        log(f"baseline {name}: {ms} ms a superstep (built in {build_s:.1f} "
            f"s), max rel err {rel:.3g} against float64; network "
            f"{h[-1].network_bytes}, disk read {h[-1].disk_read_bytes}, "
            f"written {h[-1].disk_write_bytes} bytes in its last superstep")
    log(f"baselines beside the tiled GAB engine's {steady_ms(pr):.1f} ms a "
        "superstep (phase 5)")
    return dict(engines=rows, gab_tiled_ms=steady_ms(pr))


def lm_last_logits(torch, model, tokens, n_last):
    """Full forward (train mode) over tokens [1, S]: logits of the last
    n_last positions, [n_last, V]."""
    with torch.inference_mode():
        h, _ = model.hidden(tokens, mode="train")
        return model.logits(h[:, -n_last:])[0]


def lm_memory(torch):
    free, total = torch.cuda.mem_get_info()
    return dict(card_used_bytes=int(total - free),
                torch_peak_bytes=int(torch.cuda.max_memory_allocated()))


def lm_serve_phase(torch):
    """Phase 19: the dense decoders served at full width (module
    docstring)."""
    import contextlib
    import io

    from repro_torch.configs import registry
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.model_zoo import build_model, param_count
    from repro_torch.serve.engine import Request, ServeEngine

    exact_matmuls()
    out = {}
    dev = torch.device(DEV)

    # (a) qwen3-1.7b through the serve CLI at its defaults
    torch.cuda.reset_peak_memory_stats()
    cfg = registry.get_config(LM_SERVE_ARCH)
    args = serve_cli.parse_args(["--arch", LM_SERVE_ARCH])
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        outs = serve_cli.main(["--arch", LM_SERVE_ARCH, "--device", DEV])
    wall = time.perf_counter() - t0
    printed = buf.getvalue().splitlines()
    for line in printed:
        log(f"  {line}")
    m = re.match(r"(\d+) completions, (\d+) tokens in [\d.]+s \(([\d.]+) "
                 r"tok/s, (\d+) decode steps", printed[0])
    n_done, n_tok, tok_s, steps = (int(m.group(1)), int(m.group(2)),
                                   float(m.group(3)), int(m.group(4)))
    by_rid = {o.rid: o for o in outs}
    if n_done != args.requests or sorted(by_rid) != list(range(args.requests)) \
            or any(len(o.tokens) != args.max_new for o in outs):
        raise AssertionError(f"lm serve {LM_SERVE_ARCH}: {n_done} completions, "
                             f"lengths {sorted(len(o.tokens) for o in outs)}")
    prefill_ms = 1e3 * float(np.mean([o.prefill_s for o in outs]))
    decode_ms = 1e3 * sum(o.decode_s for o in outs) / steps
    mem_a = lm_memory(torch)
    torch.cuda.empty_cache()
    # the same model again (LM.init is deterministic on the card): two
    # requests served alone in a 1-slot engine give the batched tokens
    run = RunConfig(remat="none", q_chunk=64, kv_chunk=64,
                    compute_dtype="float32")
    model = build_model(cfg, run, DEV).init(args.seed)
    n_params = param_count(model)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, args.prompt_len).astype(
        np.int32) for _ in range(args.requests)]
    for rid in LM_SINGLE_RIDS:
        one = ServeEngine(cfg, run, model, slots=1, max_len=args.max_len,
                          device=DEV).run_requests([Request(
                              rid=rid, prompt=prompts[rid],
                              max_new_tokens=args.max_new)])
        if one[0].tokens != by_rid[rid].tokens:
            raise AssertionError(f"lm serve: request {rid} alone gave "
                                 f"{one[0].tokens}, batched "
                                 f"{by_rid[rid].tokens}")
    # decode_step's logits for a 24-token sequence against the full forward
    seq = torch.from_numpy(np.random.default_rng(SEED + 19).integers(
        0, cfg.vocab_size, (1, 24)).astype(np.int32)).to(dev)
    with torch.inference_mode():
        cache = model.init_cache(1, 24, torch.float32)
        cache, _ = model.prefill(seq[:, :23], cache)
        _, dec = model.decode_step(seq[:, 23:], cache, 23)
    full = lm_last_logits(torch, model, seq, 1)
    err_a = float((dec[0, 0] - full[0]).abs().max())
    if not err_a <= LM_LOGITS_ATOL:
        raise AssertionError(f"lm serve {LM_SERVE_ARCH}: decode vs full "
                             f"forward max |err| {err_a:.3g} > "
                             f"{LM_LOGITS_ATOL}")
    out["a"] = dict(arch=LM_SERVE_ARCH, params=n_params, completions=n_done,
                    tokens=n_tok, decode_steps=steps, wall_s=wall,
                    tokens_per_s=tok_s, prefill_ms=prefill_ms,
                    decode_step_ms=decode_ms, decode_vs_full_max_abs=err_a,
                    single_slot_rids=list(LM_SINGLE_RIDS), **mem_a)
    log(f"lm serve {LM_SERVE_ARCH}: {n_params} params, {n_done} completions "
        f"of {args.max_new} tokens, {steps} decode steps; prefill "
        f"{prefill_ms:.1f} ms a request, {decode_ms:.2f} ms a decode step "
        f"({args.slots} slots), {tok_s:.1f} tokens/s; requests "
        f"{list(LM_SINGLE_RIDS)} alone equal; decode vs full forward max "
        f"|err| {err_a:.3g}; card {mem_a['card_used_bytes']} bytes in use, "
        f"torch peak {mem_a['torch_peak_bytes']}")
    del model, cache, dec, full, outs
    torch.cuda.empty_cache()

    # (b) gemma2-2b: one prompt past the window, decode against the full
    # forward, so the rolling cache is checked at full width
    out["b"] = lm_window_decode(torch, "float32")
    out["logits_atol"] = LM_LOGITS_ATOL
    return out


def lm_window_decode(torch, dtype):
    """Phases 19 (b) and 25 (b): LM_WINDOW_ARCH at full width in the
    compute dtype ``dtype`` (a cache of it), one LM_WINDOW_PROMPT-token
    prompt past the window prefilled at chunks of LM_WINDOW_CHUNK and
    LM_WINDOW_DECODE greedy steps, every logit against the full forward
    over the prompt and the decoded tokens (float32 within
    LM_LOGITS_ATOL, bfloat16 within numerics' per-row bound)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import numerics
    from repro_torch.models.model_zoo import build_model, param_count

    dev = torch.device(DEV)
    cdt = getattr(torch, dtype)
    torch.cuda.reset_peak_memory_stats()
    cfg = registry.get_config(LM_WINDOW_ARCH)
    run = RunConfig(remat="none", q_chunk=LM_WINDOW_CHUNK,
                    kv_chunk=LM_WINDOW_CHUNK, compute_dtype=dtype)
    model = build_model(cfg, run, DEV).init(SEED)
    n_params = param_count(model)
    n, k = LM_WINDOW_PROMPT, LM_WINDOW_DECODE
    if n <= cfg.sliding_window:
        raise AssertionError("the prompt must pass the window")
    prompt = torch.from_numpy(np.random.default_rng(SEED + 20).integers(
        0, cfg.vocab_size, (1, n)).astype(np.int32)).to(dev)
    with torch.inference_mode():
        cache = model.init_cache(1, n + k, cdt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, lg = model.prefill(prompt, cache)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        toks = [int(torch.argmax(lg[0, -1]))]
        logits = [lg[0, -1]]
        step_ms = []
        for i in range(k):
            t0 = time.perf_counter()
            cache, lg = model.decode_step(
                torch.tensor([[toks[-1]]], device=dev), cache, n + i)
            nxt = int(torch.argmax(lg[0, -1]))
            step_ms.append(1e3 * (time.perf_counter() - t0))
            toks.append(nxt)
            logits.append(lg[0, -1])
    windows = {c["k"].shape[1] for c in cache}
    seq = torch.cat([prompt, torch.tensor([toks[:k]], device=dev,
                                          dtype=prompt.dtype)], dim=1)
    full = lm_last_logits(torch, model, seq, k + 1)
    got = torch.stack(logits[:k + 1])
    if dtype == "float32":
        err, ulps = float((got - full).abs().max()), None
        ok = err <= LM_LOGITS_ATOL
    else:
        err, ulps, over = numerics.bf16_logits_err(got.cpu(), full.cpu(),
                                                   cfg.vocab_size)
        ok = over <= 1
    if not ok:
        raise AssertionError(f"lm serve {LM_WINDOW_ARCH} {dtype}: decode "
                             f"past the window vs full forward max |err| "
                             f"{err:.3g} ({ulps} ulps) beyond its bound")
    mem = lm_memory(torch)
    out = dict(arch=LM_WINDOW_ARCH, dtype=dtype, params=n_params, prompt=n,
               decoded=k, chunk=LM_WINDOW_CHUNK,
               cache_lengths=sorted(windows), prefill_ms=prefill_ms,
               decode_step_ms=step_ms,
               mean_decode_step_ms=float(np.mean(step_ms)),
               tokens_per_s=k / (sum(step_ms) / 1e3),
               decode_vs_full_max_abs=err, decode_vs_full_max_ulps=ulps,
               **mem)
    log(f"lm serve {LM_WINDOW_ARCH} ({dtype}): {n_params} params; a "
        f"{n}-token prompt (cache lengths {sorted(windows)}) prefilled in "
        f"{prefill_ms:.1f} ms at chunks of {LM_WINDOW_CHUNK}, {k} decode "
        f"steps {np.mean(step_ms):.2f} ms each ({out['tokens_per_s']:.1f} "
        f"tokens/s); prefill and decode vs full forward max |err| {err:.3g}"
        f"{'' if ulps is None else f' ({ulps:.2f} ulps)'}; card "
        f"{mem['card_used_bytes']} bytes in use, torch peak "
        f"{mem['torch_peak_bytes']}")
    del model, cache, full, got, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_train_cli(torch, arch=LM_TRAIN_ARCH):
    """Phase 20 (a) and 21 (c): the train CLI at full width, each step
    timed (host clock, synchronised on both sides) through a wrapper of
    the step function the CLI builds."""
    import contextlib
    import io

    from repro_torch.launch import train as train_cli
    from repro_torch.train import train_step as ts

    steps_s, used = [], []
    build = ts.build_train_step

    def timed_build(*a, **kw):
        step_fn, init_state, rest = build(*a, **kw)

        def timed(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step_fn(state, batch)
            torch.cuda.synchronize()
            steps_s.append(time.perf_counter() - t0)
            free, total = torch.cuda.mem_get_info()
            used.append(int(total - free))
            return out
        return timed, init_state, rest

    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    ts.build_train_step = timed_build
    try:
        with contextlib.redirect_stdout(buf):
            losses = train_cli.main(["--arch", arch, "--device", DEV,
                                     *LM_TRAIN_ARGV])
    finally:
        ts.build_train_step = build
    printed = buf.getvalue().splitlines()
    for line in printed:
        log(f"  {line}")
    return losses, steps_s, printed, dict(
        card_used_bytes=max(used), torch_peak_bytes=int(
            torch.cuda.max_memory_allocated()))


def state_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from state_leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def lm_resume_check(cfg, run, opt_cfg, batches, mesh=None):
    """10 straight steps against a job that checkpoints every 2 steps,
    fails at step 5 and resumes from step 4: every leaf of the train state
    equal bit for bit (over ``mesh`` when one is given: the restored tree
    is placed on it by the step)."""
    from repro_torch.models.model_zoo import export_state
    from repro_torch.runtime.ft import (FailureInjector, FaultTolerantLoop,
                                        SimulatedFailure)
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.train_step import build_train_step

    step, init, _ = build_train_step(cfg, run, opt_cfg, mesh=mesh,
                                     device=DEV)
    state = init(SEED)
    for b in batches[:10]:
        state, _ = step(state, b)
    straight = export_state(state)
    del state
    d = os.path.join(ROOT, "build", "chip_smoke_train_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    mgr = CheckpointManager(d)
    ft = FaultTolerantLoop(mgr, save_every=2, on_preempt_save=False,
                           export=export_state)
    inj = FailureInjector({5})

    def job():
        start, st = ft.resume_or_init(lambda: init(SEED))
        for s in range(start, 10):
            inj.check(s)
            st, _ = step(st, batches[s])
            ft.maybe_save(s + 1, st)
        return start, st
    try:
        job()
        raise AssertionError("lm train: the injected failure did not fire")
    except SimulatedFailure:
        pass
    start, resumed = job()
    steps_saved = mgr.all_steps()
    shutil.rmtree(d, ignore_errors=True)
    got = export_state(resumed)
    unequal = [p for (p, a), (_, b) in zip(state_leaves(got),
                                           state_leaves(straight))
               if not np.array_equal(a, b)]
    if start != 4 or unequal:
        raise AssertionError(f"lm train {cfg.name}: resumed at {start}, "
                             "leaves unequal to 10 straight steps: "
                             f"{unequal[:5]}")
    out = dict(resumed_at=start, saved_steps=steps_saved,
               leaves=len(list(state_leaves(got))), bit_for_bit=True)
    log(f"lm train resume ({cfg.name}{', mesh' if mesh else ''}): failed "
        f"at step 5, resumed from "
        f"step {start} (saved {steps_saved}), all {out['leaves']} "
        "leaves of the train state equal to 10 straight steps bit for bit")
    return out


def lm_train_invariants(torch):
    """Phase 20 (b) at the reduced config on the card: resume bit for bit,
    microbatch 2 against 1, bf16 and top-k compression."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.configs.base import RunConfig
    from repro_torch.models.model_zoo import export_params
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import build_train_step

    cfg = registry.get_config(LM_TRAIN_ARCH, reduced=True)
    run = RunConfig(remat="none", q_chunk=16, kv_chunk=16, loss_chunk=16,
                    compute_dtype="float32")
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=2, decay_steps=100)
    src = SyntheticLM(cfg, 4, 32, seed=SEED)
    batches = [src.batch_at(i) for i in range(15)]
    out = {}
    leaves = state_leaves

    out["resume"] = lm_resume_check(cfg, run, opt_cfg, batches)

    # microbatch 2 against 1
    s1, i1, _ = build_train_step(cfg, run, opt_cfg, device=DEV)
    s2, i2, _ = build_train_step(cfg, dataclasses.replace(run, microbatch=2),
                                 opt_cfg, device=DEV)
    a, b = i1(SEED), i2(SEED)
    for bt in batches[:3]:
        a, _ = s1(a, bt)
        b, _ = s2(b, bt)
    worst = 0.0
    for (p, x), (_, y) in zip(leaves(export_params(a["params"])),
                              leaves(export_params(b["params"]))):
        np.testing.assert_allclose(y, x, err_msg=f"lm train microbatch {p}",
                                   **LM_TRAIN_MB_TOL)
        worst = max(worst, float(np.max(np.abs(x - y))))
    out["microbatch_max_abs"] = worst
    log(f"lm train microbatch 2 vs 1, 3 steps: params within "
        f"{LM_TRAIN_MB_TOL} (max |diff| {worst:.3g})")

    # bf16 and top-k compression
    for comp in ("bf16", "topk"):
        step, init, _ = build_train_step(
            cfg, dataclasses.replace(run, grad_compression=comp), opt_cfg,
            device=DEV)
        state, losses = init(SEED), []
        for bt in batches:
            state, stats = step(state, bt)
            losses.append(float(stats["loss"]))
        density = float(stats["density"]) if comp == "topk" else None
        if not losses[-1] < losses[0] or (density is not None
                                          and not density <= 0.05):
            raise AssertionError(f"lm train {comp}: losses {losses[0]:.4f} "
                                 f"-> {losses[-1]:.4f}, density {density}")
        out[comp] = dict(first_loss=losses[0], last_loss=losses[-1],
                         density=density)
        log(f"lm train {comp} compression, 15 steps: loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}" + (f", density {density:.4f}"
                                   if density is not None else ""))
    return out


def lm_train_phase(torch):
    """Phase 20: the dense decoders trained on the card (module
    docstring)."""
    from repro_torch.roofline import hw

    exact_matmuls()
    torch.cuda.empty_cache()
    losses, steps_s, printed, mem = lm_train_cli(torch)
    m = re.match(r"init in [\d.]+s; params = ([\d,]+)", printed[0])
    n_params = int(m.group(1).replace(",", ""))
    batch = int(LM_TRAIN_ARGV[LM_TRAIN_ARGV.index("--batch") + 1])
    seq = int(LM_TRAIN_ARGV[LM_TRAIN_ARGV.index("--seq") + 1])
    tokens = batch * seq
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not all(np.isfinite(losses)) or not last <= first - LM_TRAIN_DROP:
        raise AssertionError(f"lm train {LM_TRAIN_ARCH}: losses {losses}")
    step_ms = 1e3 * float(np.mean(steps_s[1:]))
    flops = 6 * n_params * tokens
    share = flops / (step_ms / 1e3) / hw.F32_FLOPS
    out = dict(arch=LM_TRAIN_ARCH, argv=list(LM_TRAIN_ARGV), params=n_params,
               losses=losses, first5_mean=first, last5_mean=last,
               step_ms=[1e3 * t for t in steps_s], mean_step_ms=step_ms,
               tokens_per_s=tokens / (step_ms / 1e3), model_flops=flops,
               f32_peak_share=share, **mem)
    log(f"lm train {LM_TRAIN_ARCH}: {n_params} params, {len(losses)} steps "
        f"of {tokens} tokens; loss {first:.4f} -> {last:.4f} (means of the "
        f"first and last 5); {step_ms:.1f} ms a step over steps 2+ (first "
        f"{1e3 * steps_s[0]:.1f}), {out['tokens_per_s']:.0f} tokens/s, "
        f"{flops:.4g} model FLOPs a step = {100 * share:.1f} % of the "
        f"float32 peak; card {mem['card_used_bytes']} bytes in use, torch "
        f"peak {mem['torch_peak_bytes']}")
    torch.cuda.empty_cache()
    out["invariants"] = lm_train_invariants(torch)
    torch.cuda.empty_cache()
    return out


def lm_family_decode(torch, arch, overrides, dtype="float32"):
    """Phases 21 (a)/(b) and 25 (b): one arch at full width on the card
    (``overrides`` on the reference's config) in the compute dtype
    ``dtype`` with a cache of that dtype: a LM_FAMILY_SEQ-token sequence
    prefilled but for its last token, that token decoded, the logits
    against the full forward's last (float32 within LM_LOGITS_ATOL,
    bfloat16 within numerics' per-row bound); then LM_FAMILY_TIMED greedy
    decode steps timed."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import numerics
    from repro_torch.models.model_zoo import (active_param_count,
                                              build_model, param_count)
    from repro_torch.serve.serve_step import build_serve_fns

    dev = torch.device(DEV)
    torch.cuda.reset_peak_memory_stats()
    resident = int(torch.cuda.memory_allocated())
    cfg = dataclasses.replace(registry.get_config(arch), **overrides)
    run = RunConfig(remat="none", q_chunk=64, kv_chunk=64,
                    compute_dtype=dtype)
    cdt = getattr(torch, dtype)
    S, k = LM_FAMILY_SEQ, LM_FAMILY_TIMED
    rng = np.random.default_rng(SEED + 21)
    seq = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, S)).astype(
        np.int32)).to(dev)
    extra, fr = {}, 0
    if cfg.encoder_layers > 0:
        # whisper: served through build_serve_fns, which builds the model
        fns = build_serve_fns(cfg, run, max_len=S + k, batch=1,
                              cache_dtype=cdt, device=DEV)
        model = fns["model"].init(SEED)
        extra["enc_frames"] = torch.from_numpy(rng.normal(
            size=(1, S // 2, cfg.d_model)).astype(np.float32)).to(dev)
    else:
        fns = None
        model = build_model(cfg, run, DEV).init(SEED)
        if cfg.frontend == "vision":
            fr = cfg.frontend_tokens
            extra["patch_embeds"] = torch.from_numpy(rng.normal(
                size=(1, fr, cfg.d_model)).astype(np.float32)).to(dev)
    n_params = param_count(model)
    n_active = active_param_count(cfg, model)

    def prefill(tokens, cache):
        if fns is not None:
            return fns["prefill"](model, cache, {"tokens": tokens, **extra})
        with torch.inference_mode():
            return model.prefill(tokens, cache,
                                 extra_embeds=extra.get("patch_embeds"))

    def decode(token, cache, cache_len):
        with torch.inference_mode():
            return model.decode_step(token, cache, cache_len)

    with torch.inference_mode():
        if fns is not None:
            h, _ = model._dec_forward(
                seq, model._cross_kv(model.encode(extra["enc_frames"])),
                "train", None, None)
            full = model._logits(h[:, -1:])[0, 0]
        else:
            h, _ = model.hidden(seq, extra.get("patch_embeds"), mode="train")
            full = model.logits(h[:, -1:])[0, 0]
        cache = model.init_cache(1, fr + S + k, cdt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, _ = prefill(seq[:, :S - 1], cache)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    cache, dec = decode(seq[:, S - 1:], cache, fr + S - 1)
    if dtype == "float32":
        err = float((dec[0, 0] - full).abs().max())
        ulps, ok = None, err <= LM_LOGITS_ATOL
    else:
        err, ulps, over = numerics.bf16_logits_err(dec[0, 0].cpu(),
                                                   full.cpu(), cfg.vocab_size)
        ok = over <= 1
    if not (bool(torch.isfinite(dec[0, 0, :cfg.vocab_size]).all()) and ok):
        raise AssertionError(f"lm families {arch} {dtype}: decode vs full "
                             f"forward max |err| {err:.3g} ({ulps} ulps) "
                             "beyond its bound")
    step_ms, tok = [], int(torch.argmax(dec[0, 0]))
    for i in range(k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, lg = decode(torch.tensor([[tok]], device=dev), cache,
                           fr + S + i)
        tok = int(torch.argmax(lg[0, 0]))
        step_ms.append(1e3 * (time.perf_counter() - t0))
    mem = lm_memory(torch)
    row = dict(arch=arch, overrides=overrides, dtype=dtype, params=n_params,
               active_params=n_active, layers=cfg.num_layers,
               frontend_tokens=fr, prefill_tokens=fr + S - 1,
               prefill_ms=prefill_ms, decode_step_ms=step_ms,
               mean_decode_step_ms=float(np.mean(step_ms)),
               tokens_per_s=1e3 / float(np.mean(step_ms)),
               decode_vs_full_max_abs=err, decode_vs_full_max_ulps=ulps,
               resident_at_start_bytes=resident, **mem)
    log(f"lm families {arch}{' ' + str(overrides) if overrides else ''} "
        f"({dtype}): "
        f"{n_params} params ({n_active} active), prefill of {fr + S - 1} "
        f"positions {prefill_ms:.1f} ms, decode {np.mean(step_ms):.2f} ms a "
        f"step ({row['tokens_per_s']:.1f} tokens/s); decode vs full forward "
        f"max |err| {err:.3g}; card {mem['card_used_bytes']} bytes in use, "
        f"torch peak {mem['torch_peak_bytes']} ({resident} allocated before "
        "the model)")
    del model, cache, full, dec, h, fns, lg
    gc.collect()
    torch.cuda.empty_cache()
    return row


def lm_family_serve_cli(torch):
    """Phase 21 (a): LM_FAMILY_SERVE_ARCH through the serve CLI at its
    defaults; LM_SINGLE_RIDS served alone in a 1-slot engine give the
    batched tokens."""
    import contextlib
    import io

    from repro_torch.configs import registry
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    arch = LM_FAMILY_SERVE_ARCH
    torch.cuda.reset_peak_memory_stats()
    args = serve_cli.parse_args(["--arch", arch])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        outs = serve_cli.main(["--arch", arch, "--device", DEV])
    printed = buf.getvalue().splitlines()
    for line in printed:
        log(f"  {line}")
    m = re.match(r"(\d+) completions, (\d+) tokens in [\d.]+s \(([\d.]+) "
                 r"tok/s, (\d+) decode steps", printed[0])
    steps = int(m.group(4))
    by_rid = {o.rid: o for o in outs}
    if sorted(by_rid) != list(range(args.requests)) \
            or any(len(o.tokens) != args.max_new for o in outs):
        raise AssertionError(f"lm families serve {arch}: completions "
                             f"{sorted(by_rid)}, lengths "
                             f"{sorted(len(o.tokens) for o in outs)}")
    prefill_ms = 1e3 * float(np.mean([o.prefill_s for o in outs]))
    decode_ms = 1e3 * sum(o.decode_s for o in outs) / steps
    mem = lm_memory(torch)
    torch.cuda.empty_cache()
    cfg = registry.get_config(arch)
    run = RunConfig(remat="none", q_chunk=64, kv_chunk=64,
                    compute_dtype="float32")
    model = build_model(cfg, run, DEV).init(args.seed)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, args.prompt_len).astype(
        np.int32) for _ in range(args.requests)]
    for rid in LM_SINGLE_RIDS:
        one = ServeEngine(cfg, run, model, slots=1, max_len=args.max_len,
                          device=DEV).run_requests([Request(
                              rid=rid, prompt=prompts[rid],
                              max_new_tokens=args.max_new)])
        if one[0].tokens != by_rid[rid].tokens:
            raise AssertionError(f"lm families serve {arch}: request {rid} "
                                 f"alone gave {one[0].tokens}, batched "
                                 f"{by_rid[rid].tokens}")
    del model, outs
    torch.cuda.empty_cache()
    row = dict(arch=arch, completions=len(by_rid), decode_steps=steps,
               tokens_per_s=float(m.group(3)), prefill_ms=prefill_ms,
               decode_step_ms=decode_ms, slots=args.slots,
               single_slot_rids=list(LM_SINGLE_RIDS), **mem)
    log(f"lm families serve {arch}: {len(by_rid)} completions of "
        f"{args.max_new} tokens, {steps} decode steps; prefill "
        f"{prefill_ms:.1f} ms a request, {decode_ms:.2f} ms a decode step "
        f"({args.slots} slots), {row['tokens_per_s']:.1f} tokens/s; "
        f"requests {list(LM_SINGLE_RIDS)} alone equal; torch peak "
        f"{mem['torch_peak_bytes']}")
    return row


def lm_family_train(torch):
    """Phase 21 (c): LM_FAMILY_TRAIN_ARCH trained at full width through the
    CLI, its reduced config's resume bit for bit, and the train-then-serve
    chain."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.models.model_zoo import active_param_count, build_model
    from repro_torch.roofline import hw
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optimizer import OptConfig

    arch = LM_FAMILY_TRAIN_ARCH
    cfg = registry.get_config(arch)
    torch.cuda.empty_cache()
    losses, steps_s, printed, mem = lm_train_cli(torch, arch)
    m = re.match(r"init in [\d.]+s; params = ([\d,]+)", printed[0])
    n_params = int(m.group(1).replace(",", ""))
    n_active = active_param_count(cfg, build_model(cfg, RunConfig(),
                                                   "meta"))
    batch = int(LM_TRAIN_ARGV[LM_TRAIN_ARGV.index("--batch") + 1])
    seq = int(LM_TRAIN_ARGV[LM_TRAIN_ARGV.index("--seq") + 1])
    tokens = batch * seq
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not all(np.isfinite(losses)) or not last <= first - LM_TRAIN_DROP:
        raise AssertionError(f"lm families train {arch}: losses {losses}")
    step_ms = 1e3 * float(np.mean(steps_s[1:]))
    flops = 6 * n_active * tokens
    share = flops / (step_ms / 1e3) / hw.F32_FLOPS
    out = dict(arch=arch, argv=list(LM_TRAIN_ARGV), params=n_params,
               active_params=n_active, losses=losses, first5_mean=first,
               last5_mean=last, step_ms=[1e3 * t for t in steps_s],
               mean_step_ms=step_ms, tokens_per_s=tokens / (step_ms / 1e3),
               model_flops=flops, f32_peak_share=share, **mem)
    log(f"lm families train {arch}: {n_params} params ({n_active} active), "
        f"{len(losses)} steps of {tokens} tokens; loss {first:.4f} -> "
        f"{last:.4f} (means of the first and last 5); {step_ms:.1f} ms a "
        f"step over steps 2+ (first {1e3 * steps_s[0]:.1f}), "
        f"{out['tokens_per_s']:.0f} tokens/s, {flops:.4g} model FLOPs a "
        f"step (6 x active params x tokens) = {100 * share:.1f} % of the "
        f"float32 peak; card {mem['card_used_bytes']} bytes in use, torch "
        f"peak {mem['torch_peak_bytes']}")
    torch.cuda.empty_cache()

    small = registry.get_config(arch, reduced=True)
    run = RunConfig(remat="none", q_chunk=16, kv_chunk=16, loss_chunk=16,
                    compute_dtype="float32")
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=2, decay_steps=100)
    src = SyntheticLM(small, *LM_FAMILY_RESUME_BATCH, seed=SEED)
    out["resume"] = lm_resume_check(small, run, opt_cfg,
                                    [src.batch_at(i) for i in range(10)])
    out["resume"]["batch"] = list(LM_FAMILY_RESUME_BATCH)

    # tests/test_system.py::test_lm_train_then_serve through the port's CLIs
    d = os.path.join(ROOT, "build", "chip_smoke_family_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tl = train_cli.main(["--arch", arch, "--reduced", "--steps", "12",
                             "--batch", "4", "--seq", "32", "--ckpt-dir", d,
                             "--ckpt-every", "6", "--log-every", "6",
                             "--device", DEV])
        outs = serve_cli.main(["--arch", arch, "--reduced", "--requests",
                               "4", "--slots", "2", "--max-new", "4",
                               "--max-len", "48", "--prompt-len", "6",
                               "--ckpt-dir", d, "--device", DEV])
    shutil.rmtree(d, ignore_errors=True)
    if not tl[-1] < tl[0] or len(outs) != 4 \
            or any(len(o.tokens) != 4 for o in outs):
        raise AssertionError(f"lm families train then serve {arch}: losses "
                             f"{tl[0]:.4f} -> {tl[-1]:.4f}, "
                             f"{[len(o.tokens) for o in outs]} tokens")
    out["train_then_serve"] = dict(first_loss=tl[0], last_loss=tl[-1],
                                   completions=len(outs))
    log(f"lm families train then serve ({small.name}): 12 steps, loss "
        f"{tl[0]:.4f} -> {tl[-1]:.4f}, checkpoint served: "
        f"{len(outs)} completions of 4 tokens")
    return out


def lm_families_phase(torch):
    """Phase 21: the other model families served and trained on the card
    (module docstring)."""
    from repro_torch.configs import registry

    exact_matmuls()
    torch.cuda.empty_cache()
    out = {"decode": [lm_family_decode(torch, arch, ov)
                      for arch, ov in LM_FAMILY_FULL]}
    out["serve_cli"] = lm_family_serve_cli(torch)
    out["decode"] += [lm_family_decode(torch, arch, ov)
                      for arch, ov in LM_FAMILY_CUT]
    out["reduced"] = {arch: f"num_layers {ov['num_layers']} of "
                      f"{registry.get_config(arch).num_layers}"
                      for arch, ov in LM_FAMILY_CUT}
    out["train"] = lm_family_train(torch)
    out["logits_atol"] = LM_LOGITS_ATOL
    torch.cuda.empty_cache()
    return out


def tune_case(r):
    what = (f"{r['spec']} spec" if r["kernel"] == "gab_fused"
            else r["spec"])
    return f"tile, {what}, Q={r['q']}, tuned blocks {tuple(r['pick'])}"


def lm_mesh_train(torch, mesh, lm_train):
    """Phase 22 (a): phase 20 (a)'s job through build_train_step over the
    mesh, its first LM_MESH_STEPS steps, each timed (host clock,
    synchronised on both sides)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import registry
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import model_zoo
    from repro_torch.train import train_step as ts
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optimizer import OptConfig

    argv = dict(zip(LM_TRAIN_ARGV[::2], LM_TRAIN_ARGV[1::2]))
    steps, batch, seq = (int(argv[k]) for k in ("--steps", "--batch",
                                                "--seq"))
    cfg = registry.get_config(LM_TRAIN_ARCH)
    # launch/train.py's run and schedule, FSDP and ZeRO-1 over the mesh
    run = RunConfig(remat="block", q_chunk=min(512, seq),
                    kv_chunk=min(512, seq), loss_chunk=min(512, seq),
                    compute_dtype="float32", sharding_mode="fsdp",
                    zero1=True)
    opt_cfg = OptConfig(lr=3e-4, warmup_steps=max(steps // 20, 10),
                        decay_steps=steps)
    step, init, sh = ts.build_train_step(cfg, run, opt_cfg, mesh=mesh,
                                         device=DEV)
    init_check = lm_mesh_init_check(torch, cfg, run, init)
    torch.cuda.reset_peak_memory_stats()
    state = init(0)
    params = list(state["params"].parameters())
    on_mesh = sum(isinstance(p, DTensor) and p.device_mesh == mesh
                  for p in params)
    if on_mesh != len(params):
        raise AssertionError(f"lm mesh train: {on_mesh} of {len(params)} "
                             "parameters are DTensors on the mesh")
    src = SyntheticLM(cfg, batch, seq, seed=0)
    losses, steps_s = [], []
    for i in range(LM_MESH_STEPS):
        b = src.batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, stats = step(state, b)
        torch.cuda.synchronize()
        steps_s.append(time.perf_counter() - t0)
        losses.append(float(stats["loss"]))
    n_params = model_zoo.param_count(state["params"])
    peak = int(torch.cuda.max_memory_allocated())
    del state, step, init
    gc.collect()
    torch.cuda.empty_cache()
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not all(np.isfinite(losses)) or not last <= first - LM_TRAIN_DROP:
        raise AssertionError(f"lm mesh train {LM_TRAIN_ARCH}: losses "
                             f"{losses}")
    ref = np.asarray(lm_train["losses"][:LM_MESH_STEPS])
    np.testing.assert_allclose(losses, ref, err_msg="lm mesh train vs "
                               "phase 20 (a)", **LM_TRAIN_MB_TOL)
    diff = float(np.max(np.abs(np.asarray(losses) - ref)))
    step_ms = 1e3 * float(np.mean(steps_s[1:]))
    out = dict(arch=LM_TRAIN_ARCH, mesh=list(LM_MESH_SHAPE),
               sharding_mode=run.sharding_mode, zero1=run.zero1,
               params=n_params, dtensor_params=on_mesh, losses=losses,
               first5_mean=first, last5_mean=last,
               max_abs_loss_diff_vs_phase20=diff,
               equal_to_phase20=diff == 0.0,
               step_ms=[1e3 * t for t in steps_s], mean_step_ms=step_ms,
               phase20_mean_step_ms=lm_train["mean_step_ms"],
               tokens_per_s=batch * seq / (step_ms / 1e3),
               torch_peak_bytes=peak, specs_leaves=len(
                   list(state_leaves(sh["specs"]["params"]))),
               per_shard_init=init_check)
    log(f"lm mesh train {LM_TRAIN_ARCH} on a {LM_MESH_SHAPE} mesh (fsdp, "
        f"ZeRO-1; {on_mesh} DTensor parameters): {LM_MESH_STEPS} steps of "
        f"phase 20 (a)'s {steps}, loss "
        f"{first:.4f} -> {last:.4f}; vs phase 20 (a) max |diff| {diff:.3g}"
        f" ({'equal' if diff == 0 else 'within ' + str(LM_TRAIN_MB_TOL)});"
        f" {step_ms:.1f} ms a step over steps 2+ (phase 20 (a) "
        f"{lm_train['mean_step_ms']:.1f}), torch peak {peak}")
    return out


def lm_mesh_init_check(torch, cfg, run, init):
    """Phase 22 (a)'s per-shard init: ``init(0)`` over the mesh (leaf by
    leaf) against phase 20 (a)'s whole ``init(0)`` on the card, bit for
    bit shard by shard; m and v zero; torch's peak over the init at most
    the largest leaf above what it keeps."""
    from repro_torch.models import model_zoo
    from repro_torch.train import optimizer as opt

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated() - base
    over = torch.cuda.max_memory_allocated() - base - held
    whole = model_zoo.build_model(cfg, run, DEV).init(0)
    largest = max(p.numel() * p.element_size() for p in whole.parameters())
    def flat(model):
        return [t for leaf in opt.leaves(model_zoo.param_tree(model))
                for t in opt.members(leaf)]
    mine, theirs = flat(state["params"]), flat(whole)
    unequal = [i for i, (x, y) in enumerate(zip(mine, theirs))
               if not torch.equal(x.to_local().view(torch.int32),
                                  y.view(torch.int32))]
    unequal += [-1] * abs(len(mine) - len(theirs))
    nonzero = sum(int(t.to_local().count_nonzero()) for k in ("m", "v")
                  for leaf in opt.leaves(state["opt"][k])
                  for t in opt.members(leaf))
    del state, whole, mine, theirs
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(unequal_leaves=unequal, nonzero_moments=nonzero,
               init_s=init_s, held_bytes=int(held),
               peak_over_held_bytes=int(over), largest_leaf_bytes=largest)
    log(f"lm mesh per-shard init {cfg.name}: every shard equal to the whole "
        f"init(0)'s: {not unequal}; m and v nonzero entries {nonzero}; "
        f"{init_s:.2f} s, peak {over} B over the {held} B it keeps (largest "
        f"leaf {largest} B)")
    if unequal or nonzero or over > largest:
        raise AssertionError(f"lm mesh per-shard init: {out}")
    return out


def profiled_call(torch, fn, by_op=()):
    """``fn()`` once under torch.profiler: its wall ms (the profiler's
    overhead included), the device's busy ms (kernels and copies, as in
    profiled_step), the ops the host dispatched (CPU events: aten ops,
    DTensor's among them) and, for each op named in ``by_op``, the
    device ms of its kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    busy = sum(e.device_time_total for e in events
               if e.device_type == cuda
               and not e.key.startswith("Activity Buffer")) / 1e3
    host_ops = sum(e.count for e in events if e.device_type != cuda)
    out = dict(wall_ms=1e3 * wall, device_busy_ms=busy,
               device_busy_share=busy / (1e3 * wall) if wall else 0.0,
               host_ops=host_ops)
    if by_op:
        out["by_op"] = {k: sum(e.device_time_total for e in events
                               if e.key == k) / 1e3 for k in by_op}
    return out


def profile_line(p):
    return (f"wall {p['wall_ms']:.2f} ms, device busy "
            f"{p['device_busy_ms']:.2f} ms "
            f"({100 * p['device_busy_share']:.1f}%), {p['host_ops']} host "
            "ops")


def lm_mesh_serve(torch, mesh):
    """Phase 22 (b): qwen3-1.7b through build_serve_fns over the mesh, KV
    heads and then the sequence over the model axis, against the full
    forward and the mesh-free functions."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import model_zoo
    from repro_torch.serve.serve_step import build_serve_fns

    cfg = registry.get_config(LM_SERVE_ARCH)
    run = RunConfig(remat="none", compute_dtype="float32")
    B, S = LM_MESH_SERVE["batch"], LM_FAMILY_SEQ
    kw = dict(max_len=LM_MESH_SERVE["max_len"], batch=B,
              cache_dtype=torch.float32, device=DEV)
    model = model_zoo.build_model(cfg, run, DEV).init(SEED)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         dtype=torch.int32).to(DEV)
    with torch.inference_mode():
        h, _ = model.hidden(toks, mode="train")
        full = model.logits(h[:, -2:]).float()

    def serve(fns):
        cache, pre = fns["prefill"](model, fns["init_cache"](),
                                    {"tokens": toks[:, :-1]})
        cache, dec = fns["decode"](model, cache, toks[:, -1:], S - 1)
        got = torch.cat([pre, dec], dim=1).float()
        nxt, ms = dec.argmax(-1).to(torch.int32), []
        for t in range(LM_FAMILY_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache, lg = fns["decode"](model, cache, nxt, S + t)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            nxt = lg.argmax(-1).to(torch.int32)
        prof = profiled_call(torch, lambda: fns["decode"](
            model, cache, nxt, S + LM_FAMILY_TIMED))
        return got, ms, prof

    free, free_ms, free_prof = serve(build_serve_fns(cfg, run, **kw))
    out = dict(arch=LM_SERVE_ARCH, batch=B, prefill=S - 1, decoded=1,
               timed_decode_steps=LM_FAMILY_TIMED,
               mesh_free_decode_ms=free_ms,
               mesh_free_decode_profile=free_prof)
    log(f"lm mesh serve {LM_SERVE_ARCH} (mesh-free) decode step profiled: "
        f"{profile_line(free_prof)}")
    for seq_shard in (False, True):
        r = dataclasses.replace(run, seq_shard_decode=seq_shard)
        fns = build_serve_fns(cfg, r, mesh=mesh, **kw)
        got, ms, prof = serve(fns)
        err_full = float((got - full).abs().max())
        err_free = float((got - free).abs().max())
        if err_full > LM_LOGITS_ATOL or err_free > LM_MESH_SERVE_ATOL:
            raise AssertionError(
                f"lm mesh serve seq_shard={seq_shard}: vs full forward "
                f"{err_full:.3g} (atol {LM_LOGITS_ATOL}), vs mesh-free "
                f"{err_free:.3g} (atol {LM_MESH_SERVE_ATOL})")
        key = "seq_shard" if seq_shard else "heads"
        out[key] = dict(max_abs_err_vs_full=err_full,
                        max_abs_err_vs_mesh_free=err_free, decode_ms=ms,
                        decode_profile=prof)
        log(f"lm mesh serve {LM_SERVE_ARCH} ({key}): B={B}, {S - 1} "
            f"prefilled + 1 decoded vs full forward max |err| "
            f"{err_full:.3g}, vs mesh-free {err_free:.3g}; decode "
            f"{np.mean(ms):.2f} ms a step (mesh-free "
            f"{np.mean(free_ms):.2f}); profiled: {profile_line(prof)}")
    del model, fns
    gc.collect()
    torch.cuda.empty_cache()
    out.update(logits_atol=LM_LOGITS_ATOL, mesh_free_atol=LM_MESH_SERVE_ATOL)
    return out


def lm_mesh_reduced(torch, mesh):
    """Phase 22 (c) at the reduced config: resume over the mesh, reshard
    and rescale, flash-decoding at world size 1."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import layers
    from repro_torch.models import sharding as shd
    from repro_torch.models.model_zoo import export_state
    from repro_torch.runtime import elastic
    from repro_torch.train import train_step as ts
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optimizer import OptConfig

    cfg = registry.get_config(LM_TRAIN_ARCH, reduced=True)
    run = RunConfig(remat="block", q_chunk=16, kv_chunk=16, loss_chunk=16,
                    compute_dtype="float32")
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=2, decay_steps=100)
    src = SyntheticLM(cfg, 4, 32, seed=SEED)
    batches = [src.batch_at(i) for i in range(10)]
    out = {"resume": lm_resume_check(cfg, run, opt_cfg, batches, mesh)}

    step, init, sh = ts.build_train_step(cfg, run, opt_cfg, mesh=mesh,
                                         device=DEV)
    plain = ts.StateShardings(cfg, run, None, None, DEV)
    state = init(SEED)
    for b in batches[:2]:
        state, _ = step(state, b)
    off = elastic.reshard(state, plain)
    back = elastic.reshard(off, sh["state"])
    d = os.path.join(ROOT, "build", "chip_smoke_mesh_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    _, rescaled = elastic.rescale_via_checkpoint(CheckpointManager(d), 2,
                                                 state, sh["state"])
    shutil.rmtree(d, ignore_errors=True)
    free_step, _, _ = ts.build_train_step(cfg, run, opt_cfg, device=DEV)
    want = export_state(step(state, batches[2])[0])
    unequal = {}
    for name, st, fn in (("reshard off and back", back, step),
                         ("rescale_via_checkpoint", rescaled, step),
                         ("reshard off, mesh-free step", off, free_step)):
        got = export_state(fn(st, batches[2])[0])
        unequal[name] = [p for (p, a), (_, b) in zip(state_leaves(got),
                                                     state_leaves(want))
                         if not np.array_equal(a, b)]
    if unequal["reshard off and back"] or unequal["rescale_via_checkpoint"]:
        raise AssertionError(f"lm mesh reshard: leaves unequal {unequal}")
    out["reshard"] = {k: dict(bit_for_bit=not v, unequal_leaves=len(v))
                      for k, v in unequal.items()}
    log("lm mesh reshard (reduced): the step after reshard off the mesh "
        "and back, and after rescale_via_checkpoint, equal to the step on "
        "the mesh bit for bit; mesh-free step from the resharded state "
        + ("equal too" if not unequal["reshard off, mesh-free step"]
           else f"{len(unequal['reshard off, mesh-free step'])} leaves "
           "unequal"))

    g = torch.Generator(device="cpu").manual_seed(SEED)
    q, k, v = (torch.randn(shape, generator=g).to(DEV) for shape in
               ((2, 1, 4, 16), (2, 64, 2, 16), (2, 64, 2, 16)))
    cl = torch.tensor([40, 64], device=DEV)
    want = layers.decode_attention(q, k, v, cl)
    got = layers.seq_sharded_decode_attention(
        q, shd.distribute(k, shd.P(None, "model"), mesh),
        shd.distribute(v, shd.P(None, "model"), mesh), cl, mesh, "model")
    err = float((got - want).abs().max())
    if err > LM_MESH_FLASH_ATOL:
        raise AssertionError(f"lm mesh seq_sharded_decode_attention: "
                             f"{err:.3g} > {LM_MESH_FLASH_ATOL}")
    out["flash_decode"] = dict(max_abs_err=err, atol=LM_MESH_FLASH_ATOL,
                               shards=1)
    log(f"lm mesh seq_sharded_decode_attention (1 shard): max |err| vs "
        f"decode_attention {err:.3g}")
    return out


def lm_mesh_phase(torch, lm_train):
    """Phase 22: the language models over a device mesh at world size 1,
    NCCL (module docstring).  The process group is destroyed at the end."""
    import torch.distributed as dist

    from repro_torch.core.distributed import init_process_group
    from repro_torch.launch.mesh import make_mesh

    exact_matmuls()
    torch.cuda.empty_cache()
    backend = init_process_group(0, 1, f"tcp://localhost:{free_port()}",
                                 device=DEV)
    try:
        mesh = make_mesh(LM_MESH_SHAPE, ("data", "model"), device=DEV)
        out = dict(backend=backend,
                   train=lm_mesh_train(torch, mesh, lm_train))
        out["serve"] = lm_mesh_serve(torch, mesh)
        out["reduced"] = lm_mesh_reduced(torch, mesh)
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return out


BF16_COUNTS_KEY = ("bf16_counts", "one", "bf16")


class DryRuns:
    """Phase 23 (a): each dry-run cell (``python -m
    repro_torch.launch.dryrun --arch A --cell C --mesh M``) in a process of
    its own, started together beside the main sequence (host work: fake
    tensors allocate nothing on the card), with phase 23's rank shares and
    phases 24's and 25's counts (lm_bf16_fake_counts) in two more;
    ``join`` waits for them."""

    def __init__(self, jobs, out_dir):
        shutil.rmtree(out_dir, ignore_errors=True)
        os.makedirs(out_dir)
        self.out_dir, self.procs = out_dir, []
        self.t0, self.wall0 = time.perf_counter(), time.time()
        env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
               "REPRO_TORCH_DRYRUN_DIR": out_dir, "OMP_NUM_THREADS": "1"}
        # beside the cells' results, not among them: report.py reads
        # every *.json of out_dir as a cell
        os.makedirs(os.path.join(out_dir, "shares"))
        self.shares = os.path.join(out_dir, "shares", "rank_shares.json")
        code = ("import json, sys\n"
                "from repro_torch.launch import dryrun\n"
                "out = {f'{a}:{h}': dryrun.rank_shares(a, 'train_4k', "
                "heads=h or None) for a, h in json.loads(sys.argv[1])}\n"
                "json.dump(out, open(sys.argv[2], 'w'))\n")
        jobs_c5 = [(a, 0) for a in LM_SHARE_ARCHS] + [LM_SHARE_HEADS,
                                                      LM_SHARE_TWIN]
        logf = open(os.path.join(out_dir, "rank_shares.log"), "w")
        self.procs.append((("rank_shares", "train_4k", "c5"), subprocess.Popen(
            [sys.executable, "-c", code, json.dumps(jobs_c5), self.shares],
            stdout=logf, stderr=subprocess.STDOUT, env=env, cwd=ROOT), logf))
        # phases 24's and 25's counts on fake tensors, beside the card's
        # work
        self.bf16 = os.path.join(out_dir, "bf16")
        os.makedirs(self.bf16)
        logf = open(os.path.join(self.bf16, "bf16_counts.log"), "w")
        self.procs.append((BF16_COUNTS_KEY, subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "chip_smoke.lm_bf16_fake_counts(sys.argv[1])", self.bf16],
            stdout=logf, stderr=subprocess.STDOUT, env=env, cwd=ROOT), logf))
        for arch, cell, mesh, layers in jobs:
            logf = open(os.path.join(out_dir, f"{arch}__{cell}__{mesh}.log"),
                        "w")
            cut = [] if layers is None else ["--layers", str(layers)]
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--cell", cell, "--mesh", mesh, "--device", DEV, *cut],
                stdout=logf, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
            self.procs.append(((arch, cell, mesh), proc, logf))

    def join(self, timeout, skip=()):
        """{(arch, cell, mesh): (exit code, seconds from the start to its
        log's last write)} of every process whose key is not in ``skip``."""
        procs = [p for p in self.procs if p[0] not in skip]
        out = {}
        while len(out) < len(procs):
            for key, proc, logf in procs:
                if key not in out and proc.poll() is not None:
                    logf.close()
                    out[key] = (proc.returncode, os.path.getmtime(logf.name)
                                - self.wall0)
            if time.perf_counter() - self.t0 > timeout:
                self.kill()
                left = [k for k, _, _ in procs if k not in out]
                raise AssertionError(f"lm dryrun: {left} still running "
                                     f"{timeout} s after their start")
            time.sleep(0.5)
        return {key: out[key] for key, _, _ in procs}

    def kill(self):
        for _, proc, logf in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            logf.close()


def lm_dryrun_cells(torch, dry):
    """Phase 23 (a): the dry-run cells' results checked, then the report
    over their directory."""
    import contextlib
    import io

    from repro_torch.compat import zstd_decompress
    from repro_torch.launch import report
    from repro_torch.roofline import hlo_cost, hw

    ends = dry.join(LM_DRYRUN_TIMEOUT_S, skip=(BF16_COUNTS_KEY,))
    shares = lm_rank_shares(dry, ends.pop(("rank_shares", "train_4k", "c5")))
    rows = []
    for (arch, cell, mesh), (rc, end_s) in ends.items():
        path = os.path.join(dry.out_dir, f"{arch}__{cell}__{mesh}.json")
        with open(os.path.join(dry.out_dir,
                               f"{arch}__{cell}__{mesh}.log")) as f:
            tail = f.read()[-3000:]
        if rc != 0 or not os.path.exists(path):
            raise AssertionError(f"lm dryrun {arch} {cell} {mesh}: exit "
                                 f"code {rc}\n{tail}")
        with open(path) as f:
            r = json.load(f)
        rf, mem = r["roofline"], r["memory"]
        terms = {k: rf[k] for k in ("compute_s", "memory_s",
                                    "memory_fused_s", "collective_s")}
        if r["status"] != "ok" or not all(v > 0 for v in terms.values()) \
                or not mem["peak_bytes_estimate"] < hw.HBM_BYTES:
            raise AssertionError(f"lm dryrun {arch} {cell} {mesh}: status "
                                 f"{r['status']}, terms {terms}, memory "
                                 f"{mem}")
        with open(os.path.join(dry.out_dir, "ops",
                               f"{arch}__{cell}__{mesh}.ops.zst"), "rb") as f:
            dot = hlo_cost.dot_flops(json.loads(zstd_decompress(f.read())))
        key, useful = (arch, cell, mesh), rf["useful_flops_ratio"]
        row = dict(arch=arch, cell=cell, mesh=mesh, n_chips=r["n_chips"],
                   layers=r["layers"], seconds=end_s, build_s=r["lower_s"],
                   count_s=r["compile_s"], ops=r["ops"], memory=mem,
                   collectives=r["collectives"], roofline=rf,
                   dot_flops_a_device=dot, useful_flops_ratio=useful,
                   useful_flops_ratio_before_c4=LM_DRYRUN_C4_USEFUL.get(key),
                   min_useful_flops_ratio=LM_DRYRUN_MIN_USEFUL.get(key))
        rows.append(row)
        log(f"lm dryrun {arch} {cell} {mesh}: useful FLOPs ratio "
            f"{useful:.4f} (before C.4: {LM_DRYRUN_C4_USEFUL.get(key)}), "
            f"{dot:.6g} dot FLOPs a device of {rf['flops']:.6g}")
        if useful < LM_DRYRUN_MIN_USEFUL.get(key, 0.0):
            raise AssertionError(f"lm dryrun {arch} {cell} {mesh}: useful "
                                 f"FLOPs ratio {useful:.4f} below "
                                 f"{LM_DRYRUN_MIN_USEFUL[key]}: a product "
                                 "runs replicated (ROADMAP C.4)")
        log(f"lm dryrun {arch} {cell} {mesh} ({r['n_chips']} fake ranks, "
            f"{r['layers']} layers): "
            f"ok {end_s:.1f} s after the start on the card's host (build "
            f"{r['lower_s']} s, "
            f"count {r['compile_s']} s, {r['ops']} ops a device); "
            f"modelled on {r['n_chips']} H100s: compute "
            f"{rf['compute_s']:.4g} s, memory {rf['memory_fused_s']:.4g} / "
            f"{rf['memory_s']:.4g} s, collective {rf['collective_s']:.4g} s, "
            f"{rf['bottleneck']}-bound, MFU bound {rf['mfu_bound']:.4f}; "
            f"peak {mem['peak_bytes_estimate']} bytes a device")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report.main(["--dir", dry.out_dir])
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"  {line}")
    if f"{len(rows)} compiled ok, 0 skipped (assignment rules), 0 errors" \
            not in text:
        raise AssertionError(f"lm dryrun report: {text[:500]}")
    return rows, text, shares


def lm_rank_shares(dry, end):
    """Phase 23's C.5 and C.6 checks on the side process's
    dryrun.rank_shares: each mesh's dot FLOPs a device times its ranks
    over (1, 1)'s, the largest attention bmm with 6 heads on 4 model
    ranks, and its collective bytes and ops a rank on (1, 4) equal to
    the 8-head twin's."""
    rc = end[0]
    with open(os.path.join(dry.out_dir, "rank_shares.log")) as f:
        tail = f.read()[-3000:]
    if rc != 0 or not os.path.exists(dry.shares):
        raise AssertionError(f"lm rank shares: exit code {rc}\n{tail}")
    end_s = os.path.getmtime(dry.shares) - dry.wall0
    with open(dry.shares) as f:
        got = json.load(f)
    out = {}
    for key, meshes in got.items():
        one = meshes["1x1"]
        ratios = {m: r["dot"] * 4 / one["dot"] for m, r in meshes.items()
                  if m != "1x1"}
        out[key] = dict(ratios=ratios, bmm_batch={m: r["bmm_batch"] for m, r
                                                  in meshes.items()},
                        before_c5=LM_SHARE_BEFORE_C5.get(key))
        log(f"lm rank shares {key} train_4k (reduced, 4 x 32): dot FLOPs x "
            f"ranks / (1, 1) " + ", ".join(f"{m} {v:.4f}" for m, v
                                          in ratios.items())
            + f" (before C.5: {LM_SHARE_BEFORE_C5.get(key)}); largest bmm "
            f"batch {out[key]['bmm_batch']}")
        arch, heads = key.split(":")
        if int(heads) == 0 and any(abs(v - 1.0) > LM_SHARE_RTOL
                                   for v in ratios.values()):
            raise AssertionError(f"lm rank shares {key}: {ratios} (a "
                                 "product runs whole on every rank, C.5)")
        if int(heads):
            rows = one["bmm_batch"] // int(heads)
            for m, (data, model) in (("2x2", (2, 2)), ("1x4", (1, 4))):
                cap = rows // data * -(-int(heads) // model)
                if meshes[m]["bmm_batch"] > cap:
                    raise AssertionError(f"lm rank shares {key} {m}: bmm "
                                         f"batch {meshes[m]['bmm_batch']} > "
                                         f"{cap}")
    heads, twin = (got[f"{a}:{h}"]["1x4"]
                   for a, h in (LM_SHARE_HEADS, LM_SHARE_TWIN))
    c6 = {k: (heads[k], twin[k]) for k in ("coll", "n_coll")}
    log(f"lm rank shares C.6 (1, 4): collective bytes, ops a rank with "
        f"{LM_SHARE_HEADS[1]} heads / {LM_SHARE_TWIN[1]}: {c6}")
    if any(a != b for a, b in c6.values()):
        raise AssertionError(f"lm rank shares C.6: {c6} (heads that do not "
                             "divide the model axis lost their shards)")
    log(f"lm rank shares: {end_s:.1f} s after the start")
    return dict(seconds=end_s, cells=out, c6=c6)


def count_diff(real, fake):
    """The ops whose counts differ between two records: {(name, args):
    (real count, fake count)}."""
    from collections import Counter

    def key(r):
        return (r.name, json.dumps(r.args), json.dumps(r.outs))

    a, b = Counter(map(key, real)), Counter(map(key, fake))
    return {k: (a[k], b[k]) for k in set(a) | set(b) if a[k] != b[k]}


def card_and_fake_counts(torch, what, build, inputs, call, reps, smi):
    """Phase 23 (b) for one function: ``build(device)`` makes its state,
    ``inputs(state, device)`` its arguments, ``call(state, *args)`` runs
    it.  Counted on the card (hlo_cost.run) and on fake tensors of the same
    shapes, which must agree; timed on the card (CUDA events, mean of
    ``reps`` calls after a warm one) beside analysis.roofline's bound
    (held_to_fake)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.roofline import hlo_cost

    state = build(DEV)
    args = inputs(state, DEV)
    call(state, *args)                      # warm
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call(state, *args)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    real = hlo_cost.run(call, state, *args)
    real_s = time.perf_counter() - t0
    real.result = None
    del state, args
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with FakeTensorMode():
        fstate = build(DEV)
        fake = hlo_cost.run(call, fstate, *inputs(fstate, DEV))
    fake_s = time.perf_counter() - t0
    fc = fake.cost
    counts = dict(ops=len(fake.records), flops=fc.flops, bytes=fc.bytes,
                  bytes_fused=fc.bytes_fused, memory=fake.memory.as_dict())
    return dict(what=what, card=smi, ms=ms, count_card_s=real_s,
                count_fake_s=fake_s, **held_to_fake(
                    torch, f"lm dryrun {what}", real, counts,
                    lambda: fake.records, ms, smi))


def lm_dryrun_card(torch, smi):
    """Phase 23 (b): phase 20 (a)'s train step and one phase 19 (a) decode
    step counted on the card and on fake tensors, timed against their
    bound."""
    from torch._subclasses.fake_tensor import FakeTensor

    from repro_torch.configs import registry
    from repro_torch.configs.base import RunConfig
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train import train_step as ts
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optimizer import OptConfig

    exact_matmuls()
    argv = dict(zip(LM_TRAIN_ARGV[::2], LM_TRAIN_ARGV[1::2]))
    steps, batch, seq = (int(argv[k]) for k in ("--steps", "--batch",
                                                "--seq"))
    cfg = registry.get_config(LM_TRAIN_ARCH)
    # launch/train.py's run and schedule
    run = RunConfig(remat="block", q_chunk=min(512, seq),
                    kv_chunk=min(512, seq), loss_chunk=min(512, seq),
                    compute_dtype="float32")
    opt_cfg = OptConfig(lr=3e-4, warmup_steps=max(steps // 20, 10),
                        decay_steps=steps)
    data = SyntheticLM(cfg, batch, seq, seed=0).batch_at(0)

    def train_build(dev):
        step, init, _ = ts.build_train_step(cfg, run, opt_cfg, device=dev)
        return dict(step=step, state=init(0))

    def train_inputs(st, dev):
        b = {k: torch.empty(v.shape, dtype=torch.int32, device=dev)
             for k, v in data.items()}
        if not isinstance(b["tokens"], FakeTensor):
            for k, v in data.items():
                b[k].copy_(torch.from_numpy(v))
        return (b,)

    def train_call(st, b):
        st["state"], stats = st["step"](st["state"], b)
        return st["state"], stats

    out = dict(train=card_and_fake_counts(
        torch, f"train {LM_TRAIN_ARCH} {batch} x {seq}", train_build,
        train_inputs, train_call, LM_DRYRUN_REPS, smi))
    gc.collect()
    torch.cuda.empty_cache()

    # phase 19 (a): launch/serve.py's run, 4 slots of 256, 16 tokens a
    # prompt, one decode step of every slot
    scfg = registry.get_config(LM_SERVE_ARCH)
    srun = RunConfig(remat="none", q_chunk=64, kv_chunk=64,
                     compute_dtype="float32")
    slots, max_len, prompt = 4, 256, 16

    def serve_build(dev):
        model = build_model(scfg, srun, dev)
        if not isinstance(model.embed_tok, FakeTensor):
            model.init(0)
        return dict(model=model,
                    cache=model.init_cache(slots, max_len, torch.bfloat16))

    def serve_inputs(st, dev):
        return (torch.zeros((slots, 1), dtype=torch.int32, device=dev),
                torch.full((slots,), prompt, dtype=torch.int32, device=dev))

    def serve_call(st, tok, cl):
        with torch.inference_mode():
            st["cache"], logits = st["model"].decode_step(tok, st["cache"], cl)
        return logits

    out["decode"] = card_and_fake_counts(
        torch, f"decode {LM_SERVE_ARCH} {slots} slots of {max_len}",
        serve_build, serve_inputs, serve_call, LM_DRYRUN_REPS, smi)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_dryrun_phase(torch, dry, smi):
    """Phase 23: the dry-run cells (a) and the counter on the card (b)
    (module docstring); ``smi`` names the card and its power limit."""
    t0 = time.perf_counter()
    out = dict(card=lm_dryrun_card(torch, smi))
    out["card_s"] = time.perf_counter() - t0
    out["cells"], out["report"], out["rank_shares"] = lm_dryrun_cells(
        torch, dry)
    return out


def lm_bf16_run(arch, cell_name, seq=None):
    """The RunConfig registry.default_run_config gives ``arch``'s cell on
    one device (``seq`` cuts its sequence and so its chunks), at the
    reference's compute dtype, bfloat16."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPE_CELLS

    cell = SHAPE_CELLS[cell_name]
    if seq is not None:
        cell = dataclasses.replace(cell, seq_len=seq)
    return dataclasses.replace(registry.default_run_config(arch, cell, 1),
                               compute_dtype="bfloat16")


def lm_bf16_fake_counts(out_dir):
    """Phases 24's and 25's cells counted on fake tensors (DryRuns' side
    process): dryrun.count(arch, cell, "one", ...) of each LM_BF16_COUNTS
    entry, its costs and memory to ``out_dir``/bf16_counts.json and its
    op record beside them."""
    from repro_torch.launch import dryrun

    out = {}
    for arch, cell, batch in LM_BF16_COUNTS:
        cc, n, run = dryrun.count(arch, cell, "one", DEV, batch=batch)
        c = cc.counted
        dryrun.save_record(os.path.join(out_dir, f"{arch}__{cell}.ops.zst"),
                           c.records)
        out[f"{arch}:{cell}"] = dict(
            ops=len(c.records), flops=c.cost.flops, bytes=c.cost.bytes,
            bytes_fused=c.cost.bytes_fused, memory=c.memory.as_dict(),
            roofline=dryrun._terms(c.cost, n, cc.model_flops).as_dict(),
            model_flops=cc.model_flops, batch=batch, count_s=cc.count_s,
            compute_dtype=run.compute_dtype, microbatch=run.microbatch,
            remat=run.remat)
        print(f"{arch} {cell}: {len(c.records)} ops in {cc.count_s:.1f} s",
              flush=True)
    with open(os.path.join(out_dir, "bf16_counts.json"), "w") as f:
        json.dump(out, f)


def lm_bf16_fake(dry):
    """The side process's counts (lm_bf16_fake_counts), joined."""
    rc, end_s = dry.join(LM_DRYRUN_TIMEOUT_S, skip=[
        k for k, _, _ in dry.procs if k != BF16_COUNTS_KEY])[BF16_COUNTS_KEY]
    path = os.path.join(dry.bf16, "bf16_counts.json")
    if rc != 0 or not os.path.exists(path):
        with open(os.path.join(dry.bf16, "bf16_counts.log")) as f:
            tail = f.read()[-3000:]
        raise AssertionError(f"lm bf16 fake counts: exit code {rc}\n{tail}")
    with open(path) as f:
        counts = json.load(f)
    log(f"lm bf16 fake counts: {end_s:.1f} s after the start")
    return counts, end_s


def dtype_split(records):
    """What a counted call's op record spends where (phase 24): its
    products' FLOPs by operand dtype, and the bytes its float32 ->
    bfloat16 casts move (a weight's bfloat16 copy made at every call
    among them), each beside the least time it takes on the card
    (roofline/hw.py: bfloat16 products at the tensor cores' peak,
    float32 ones at the FP32 rate, casts at the HBM rate).  Under
    inference_mode (a serve call) the counter sees ``aten.to`` whole and
    counts it free, as a view: a decode step's casts are not in its
    record."""
    from repro_torch.roofline import hlo_cost, hw

    flops, cast = {}, 0
    for r in records:
        if hlo_cost.op_kind(r.name) == "dot":
            dt = r.args[0][2]
            flops[dt] = flops.get(dt, 0.0) + hlo_cost._dot_flops(r)
        elif r.name == "aten._to_copy.default" and r.args[0][2] == \
                "float32" and r.outs[0][1] == "bfloat16":
            cast += 6 * int(np.prod(r.args[0][1]))
    rate = {"bfloat16": hw.PEAK_FLOPS_BF16, "float32": hw.F32_FLOPS}
    return dict(dot_flops=flops, cast_bytes=cast,
                dot_ms={k: 1e3 * v / rate[k] for k, v in flops.items()
                        if k in rate},
                cast_ms=1e3 * cast / hw.HBM_BW)


def saved_record(path):
    """An op record saved by dryrun.save_record, as OpRecords."""
    from repro_torch.compat import zstd_decompress
    from repro_torch.roofline import hlo_cost

    with open(path, "rb") as f:
        return [hlo_cost.OpRecord.from_list(r)
                for r in json.loads(zstd_decompress(f.read()))]


def held_to_fake(torch, what, real, fake, fake_records, ms, smi):
    """Phases 23 (b) and 24: a call counted on the card (``real``,
    hlo_cost.run) against the same call's count on fake tensors (``fake``:
    its ops, FLOPs, bytes, fused bytes and memory; ``fake_records()`` its
    op record, read to name the ops that differ): all four equal, and
    ``ms`` measured on the card not below analysis.roofline's bound of
    the count."""
    from repro_torch.roofline import analysis

    rc = real.cost
    got = dict(ops=len(real.records), flops=rc.flops, bytes=rc.bytes,
               bytes_fused=rc.bytes_fused)
    want = {k: fake[k] for k in got}
    if got != want:
        diff = count_diff(real.records, fake_records())
        raise AssertionError(f"{what}: the card counts {got}, fake "
                             f"tensors {want}; ops that differ: "
                             f"{list(diff.items())[:20]}")
    terms = analysis.roofline(rc.flops, rc.bytes, rc.coll_bytes, 1, 0.0,
                              hbm_bytes_fused=rc.bytes_fused)
    bound_ms = 1e3 * terms.step_s_bound
    if not ms >= bound_ms:
        raise AssertionError(f"{what}: {ms:.4g} ms on the card, "
                             f"below its bound {bound_ms:.4g} ms")
    split = dtype_split(real.records)
    log(f"{what}: {got['ops']} ops, {rc.flops:.6g} FLOPs, "
        f"{rc.bytes:.6g} bytes ({rc.bytes_fused:.6g} fused) on the card and "
        f"on fake tensors alike; {ms:.3f} ms on the card ({smi}) against a "
        f"bound of {bound_ms:.4g} ms ({terms.bottleneck}), measured / bound "
        f"{ms / bound_ms:.2f}; products by operand dtype "
        + ", ".join(f"{k} {v:.4g} FLOPs ({split['dot_ms'].get(k, 0):.4g} ms "
                    "at its peak)" for k, v in split["dot_flops"].items())
        + f"; float32 -> bfloat16 casts {split['cast_bytes']:.4g} bytes "
        f"({split['cast_ms']:.4g} ms at the HBM rate)")
    return dict(**got, bound_ms=bound_ms, bottleneck=terms.bottleneck,
                measured_over_bound=ms / bound_ms, dtype_split=split,
                memory_card=real.memory.as_dict(),
                memory_fake=fake["memory"])


def lm_bf16_gemm(torch):
    """Phase 24 (a), the first trouble point: one bfloat16 GEMM at the
    MLP's wo shape of a train_4k microbatch (LM_BF16_GEMM) with cuBLAS's
    reduced-precision reduction on and off (the port's setting), each
    result's largest error against float64 on the same operands and its
    ms (CUDA events, median of 10)."""
    from repro_torch.models.layers import exact_matmuls

    m, k, n = LM_BF16_GEMM
    gen = torch.Generator(device=DEV).manual_seed(SEED + 24)
    a = torch.randn(m, k, device=DEV, generator=gen).bfloat16()
    b = (torch.randn(k, n, device=DEV, generator=gen) * k ** -0.5).bfloat16()
    want = a.double() @ b.double()
    out = {}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    try:
        for on in (True, False):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction\
                = on
            got = a @ b
            out["on" if on else "off"] = dict(
                max_abs_err=float((got.double() - want).abs().max()),
                ms=time_ms(torch, lambda: a @ b, flush))
    finally:
        exact_matmuls()
    log(f"lm bf16 GEMM {m} x {k} x {n}: reduced-precision reduction on "
        f"max |err| {out['on']['max_abs_err']:.4g} ({out['on']['ms']:.4f} "
        f"ms), off {out['off']['max_abs_err']:.4g} ({out['off']['ms']:.4f} "
        "ms), against float64")
    return dict(shape=list(LM_BF16_GEMM), **out)


def lm_grads(torch, model, cfg, batch):
    """(loss, every gradient member as a float64 host array in the
    reference's leaf order) of train_step.model_loss_fn."""
    from repro_torch.models.model_zoo import param_tree
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import model_loss_fn

    flat = [p for leaf in opt.leaves(param_tree(model))
            for p in opt.members(leaf)]
    model.requires_grad_(True)
    b = {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()}
    loss = model_loss_fn(model, cfg)(model, b)
    grads = torch.autograd.grad(loss, flat)
    model.requires_grad_(False)
    return float(loss.detach()), [g.double().cpu().numpy() for g in grads]


def lm_bf16_parity(torch):
    """Phase 24 (a): reduced qwen3-1.7b and granite-moe in bfloat16, one
    train step's loss and gradients and the full forward's logits on the
    card against the port's plain step on the CPU, the same parameters
    and batch; then lm_bf16_gemm."""
    import copy

    from repro_torch.configs import registry
    from repro_torch.models import numerics
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.data import SyntheticLM

    out = {}
    batch, seq = LM_BF16_PARITY
    for arch in (LM_BF16_ARCH, LM_BF16_MOE_ARCH):
        cfg = registry.get_config(arch, reduced=True)
        run = lm_bf16_run(arch, "train_4k", seq)
        cpu = build_model(cfg, run, "cpu").init(SEED)
        card = copy.deepcopy(cpu).to(DEV)
        data = SyntheticLM(cfg, batch, seq, seed=SEED).batch_at(0)
        res = {}
        for name, model in (("cpu", cpu), ("card", card)):
            loss, grads = lm_grads(torch, model, cfg, data)
            with torch.inference_mode():
                tok = torch.as_tensor(data["tokens"], device=model.device)
                h, _ = model.hidden(tok, mode="train")
                logits = model.logits(h).float().cpu()
            res[name] = (loss, grads, logits)
        (l0, g0, z0), (l1, g1, z1) = res["cpu"], res["card"]
        loss_err = abs(l1 - l0)
        grad_rel = max(float(np.max(np.abs(a - b)))
                       / max(float(np.max(np.abs(a))), 1e-30)
                       for a, b in zip(g0, g1))
        logit_err = float((z1 - z0).abs().max())
        row = dict(arch=arch, batch=[batch, seq], loss_cpu=l0, loss_card=l1,
                   loss_abs_err=loss_err, grad_max_rel_err=grad_rel,
                   logits_max_abs_err=logit_err, leaves=len(g0))
        log(f"lm bf16 parity {cfg.name} ({batch} x {seq}, microbatch "
            f"{run.microbatch}, remat {run.remat}): loss card {l1:.6f} vs "
            f"cpu {l0:.6f} (|err| {loss_err:.3g}), {len(g0)} gradient "
            f"leaves within {grad_rel:.3g} of their scale, logits max |err| "
            f"{logit_err:.3g}")
        if not (loss_err <= LM_BF16_LOSS_ATOL and grad_rel <= LM_BF16_GRAD_REL
                and logit_err <= numerics.LOGITS_ATOL):
            raise AssertionError(f"lm bf16 parity {cfg.name}: {row}")
        out[arch] = row
        del cpu, card
    out["gemm"] = lm_bf16_gemm(torch)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_bf16_engine(torch, cfg, run, model, args, same_slots=False):
    """Phases 24 (b) and 25 (b): ``args.requests`` requests of
    ``args.prompt_len`` seeded tokens (the serve CLI's, ``args``) served in
    bfloat16 with a bfloat16 cache by a ServeEngine of ``args.slots``
    slots that keeps the logits it samples from, then LM_SINGLE_RIDS again
    each alone in a 1-slot engine: the alone logits against the batched
    slot's at every step up to the first token that differs (bfloat16 may
    flip a near-tied greedy choice: tokens are recorded, not asserted),
    each held to a bound by its caller.  With ``same_slots`` each also
    alone in an engine of ``args.slots`` slots, its row's
    ``same_slots_equal``: tokens and every step's logits equal to the
    batched slot's bit for bit.  Returns (the batched engine, its outputs,
    its wall seconds, the requests, the alone rows, the largest (|err|,
    ulps, over the bound) of the 1-slot ones, and each 1-slot alone
    request's logits ``[steps compared, V]``)."""
    from repro_torch.models import numerics
    from repro_torch.serve.engine import Request, ServeEngine

    class Recording(ServeEngine):
        """The engine, keeping the logits each request's tokens were
        sampled from, by (rid, step)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.logits = {}

        def _sample(self, logits, req, step):
            self.logits[(req.rid, step)] = logits.float().cpu()
            return super()._sample(logits, req, step)

    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, args.prompt_len).astype(np.int32),
        max_new_tokens=args.max_new) for i in range(args.requests)]

    def engine(slots):
        return Recording(cfg, run, model, slots=slots, max_len=args.max_len,
                         cache_dtype=torch.bfloat16, device=DEV)

    eng = engine(args.slots)
    t0 = time.perf_counter()
    outs = eng.run_requests(reqs)
    wall = time.perf_counter() - t0
    if len(outs) != args.requests or any(len(o.tokens) != args.max_new
                                         for o in outs):
        raise AssertionError(f"lm bf16 serve {cfg.name}: {len(outs)} "
                             f"completions, lengths "
                             f"{[len(o.tokens) for o in outs]}")
    by_rid = {o.rid: o.tokens for o in outs}
    alone, worst, logits = {}, (0.0, 0.0, 0.0), {}
    for rid in LM_SINGLE_RIDS:
        one = engine(1)
        toks = one.run_requests([reqs[rid]])[0].tokens
        same = next((i for i, (a, b) in enumerate(zip(toks, by_rid[rid]))
                     if a != b), len(toks) - 1)
        logits[rid] = torch.stack([one.logits[(rid, i)]
                                   for i in range(same + 1)])
        rows = numerics.logit_errors(
            logits[rid], torch.stack([eng.logits[(rid, i)]
                                      for i in range(same + 1)]),
            cfg.vocab_size)
        err = tuple(float(r.max()) for r in rows)
        alone[rid] = dict(tokens=toks, batched=by_rid[rid],
                          steps_compared=same + 1, max_abs_err=err[0],
                          max_ulps=err[1], err_by_step=rows[0].tolist(),
                          ulps_by_step=rows[1].tolist(),
                          over_by_step=rows[2].tolist())
        worst = tuple(max(a, b) for a, b in zip(worst, err))
        del one
        if same_slots:
            one = engine(args.slots)
            toks = one.run_requests([reqs[rid]])[0].tokens
            alone[rid]["same_slots_equal"] = toks == by_rid[rid] and all(
                torch.equal(one.logits[(rid, i)], eng.logits[(rid, i)])
                for i in range(len(toks)))
            del one
    return eng, outs, wall, reqs, alone, worst, logits


def lm_bf16_serve(torch, lm_serve):
    """Phase 24 (b): qwen3-1.7b served in bfloat16 at phase 19 (a)'s
    shapes, its figures beside phase 19's float32 ones (``lm_serve``)."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import numerics
    from repro_torch.models.model_zoo import build_model

    dev = torch.device(DEV)
    args = serve_cli.parse_args(["--arch", LM_BF16_ARCH])
    cfg = registry.get_config(LM_BF16_ARCH)
    run = lm_bf16_run(LM_BF16_ARCH, "decode_32k")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, run, DEV).init(args.seed)
    eng, outs, wall, _, alone, err_alone, _ = lm_bf16_engine(
        torch, cfg, run, model, args)
    steps = eng.stats["decode_steps"]
    n_tok = sum(len(o.tokens) for o in outs)
    prefill_ms = 1e3 * float(np.mean([o.prefill_s for o in outs]))
    decode_ms = 1e3 * sum(o.decode_s for o in outs) / steps
    mem = lm_memory(torch)
    # one batched decode step under torch.profiler: host-bound or not, and
    # the device time of the casts (a bfloat16 copy of every weight)
    prof = profiled_call(torch, lambda: model.decode_step(
        torch.zeros((args.slots, 1), dtype=torch.int32, device=dev),
        eng.cache, torch.full((args.slots,), args.prompt_len,
                              dtype=torch.int32, device=dev)),
        by_op=("aten::_to_copy", "aten::mm"))
    # decode_step's logits against the full forward (phase 19 (a)'s check)
    seq = torch.from_numpy(np.random.default_rng(SEED + 19).integers(
        0, cfg.vocab_size, (1, 24)).astype(np.int32)).to(dev)
    with torch.inference_mode():
        cache = model.init_cache(1, 24, torch.bfloat16)
        cache, _ = model.prefill(seq[:, :23], cache)
        _, dec = model.decode_step(seq[:, 23:], cache, 23)
    full = lm_last_logits(torch, model, seq, 1)
    err_full = numerics.bf16_logits_err(dec[0, 0].cpu(), full[0].cpu(),
                                        cfg.vocab_size)
    # the scale of bfloat16's own rounding here: both against the float32
    # forward of the same parameters
    m32 = build_model(cfg, dataclasses.replace(run, compute_dtype="float32"),
                      DEV)
    m32.load_state_dict(model.state_dict())
    full32 = lm_last_logits(torch, m32, seq, 1)[0, :cfg.vocab_size]
    vs_f32 = dict(
        full=float((full[0, :cfg.vocab_size].float() - full32).abs().max()),
        decode=float((dec[0, 0, :cfg.vocab_size].float() - full32)
                     .abs().max()),
        largest=float(full32.abs().max()))
    del m32, full32
    f32 = lm_serve["a"]
    out = dict(arch=LM_BF16_ARCH, slots=args.slots, max_len=args.max_len,
               prompt=args.prompt_len, requests=args.requests, tokens=n_tok,
               decode_steps=steps, wall_s=wall, tokens_per_s=n_tok / wall,
               prefill_ms=prefill_ms, decode_step_ms=decode_ms,
               decode_vs_full_max_abs=err_full[0],
               decode_vs_full_max_ulps=err_full[1], alone=alone,
               alone_max_abs=err_alone[0], alone_max_ulps=err_alone[1],
               bf16_vs_f32=vs_f32, decode_profile=prof, **mem,
               float32=dict(prefill_ms=f32["prefill_ms"],
                            decode_step_ms=f32["decode_step_ms"],
                            tokens_per_s=f32["tokens_per_s"],
                            torch_peak_bytes=f32["torch_peak_bytes"]))
    log(f"lm bf16 serve {LM_BF16_ARCH}: {args.requests} requests, "
        f"{args.slots} slots of {args.max_len}, {steps} decode steps; "
        f"prefill {prefill_ms:.1f} ms a request (float32 "
        f"{f32['prefill_ms']:.1f}), {decode_ms:.2f} ms a decode step "
        f"({f32['decode_step_ms']:.2f}), {out['tokens_per_s']:.1f} tokens/s "
        f"({f32['tokens_per_s']:.1f}), torch peak {mem['torch_peak_bytes']} "
        f"({f32['torch_peak_bytes']}); requests {list(LM_SINGLE_RIDS)} alone: "
        f"logits within {err_alone[0]:.3g} ({err_alone[1]:.2f} ulps, "
        f"{err_alone[2]:.2f} of the bound) over "
        f"{[a['steps_compared'] for a in alone.values()]} steps, tokens "
        f"{'equal' if all(a['tokens'] == a['batched'] for a in alone.values()) else 'differ'}"
        f"; decode vs full forward max |err| {err_full[0]:.3g} "
        f"({err_full[1]:.2f} ulps, {err_full[2]:.2f} of the bound); "
        f"against the float32 forward (largest |logit| "
        f"{vs_f32['largest']:.3g}): the bfloat16 full forward "
        f"{vs_f32['full']:.3g}, decode {vs_f32['decode']:.3g}; a decode "
        f"step profiled: "
        f"{profile_line(prof)}, casts {prof['by_op']['aten::_to_copy']:.2f} "
        f"ms and products {prof['by_op']['aten::mm']:.2f} ms of the device")
    if not (err_full[2] <= 1 and err_alone[2] <= 1):
        raise AssertionError(
            f"lm bf16 serve: decode vs full forward {err_full[:2]}, batched "
            f"vs alone {err_alone[:2]} (max |err|, ulps): above the larger "
            f"of {numerics.LOGITS_ATOL} and {numerics.LOGITS_ULPS} ulps")
    del model, eng, cache, dec, full
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_bf16_train_cell(torch, arch, steps, fake, record, smi):
    """Phase 24 (c) and (e): ``arch``'s train_4k at its own RunConfig in
    bfloat16, LM_BF16_TRAIN_BATCH x 4096 tokens, ``steps`` steps: the
    first counted on the card and held to the fake tensors' count
    (held_to_fake), the others timed (host clock, synchronised)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPE_CELLS
    from repro_torch.models.model_zoo import active_param_count, param_count
    from repro_torch.roofline import hlo_cost, hw
    from repro_torch.train import train_step as ts
    from repro_torch.train.data import SyntheticLM

    cfg = registry.get_config(arch)
    seq = SHAPE_CELLS["train_4k"].seq_len
    run = lm_bf16_run(arch, "train_4k")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step, init, _ = ts.build_train_step(cfg, run, device=DEV)
    state = init(SEED)
    n_params = param_count(state["params"])
    n_active = active_param_count(cfg, state["params"])
    src = SyntheticLM(cfg, LM_BF16_TRAIN_BATCH, seq, seed=SEED)

    def batch_at(i):     # on the card in registry.input_specs' dtypes, as
        out = {}         # the fake count's inputs are (frames bfloat16)
        for k, v in src.batch_at(i).items():
            t = torch.from_numpy(v).to(DEV)
            out[k] = t.bfloat16() if t.is_floating_point() else t
        return out

    losses, steps_s = [], []
    for i in range(steps):
        b = batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:          # the first step, untimed, is the one counted
            real = hlo_cost.run(step, state, b)
            (state, stats), real.result = real.result, None
        else:
            state, stats = step(state, b)
        losses.append(float(stats["loss"]))
        steps_s.append(time.perf_counter() - t0)
    count_s = steps_s[0]
    peak = int(torch.cuda.max_memory_allocated())
    if not all(np.isfinite(losses)):
        raise AssertionError(f"lm bf16 train {arch}: losses {losses}")
    step_ms = 1e3 * float(np.mean(steps_s[1:]))
    tokens = LM_BF16_TRAIN_BATCH * seq
    flops = 6 * n_active * tokens
    what = f"train {arch} train_4k {LM_BF16_TRAIN_BATCH} x {seq}"
    out = dict(arch=arch, batch=[LM_BF16_TRAIN_BATCH, seq],
               microbatch=run.microbatch, remat=run.remat,
               loss_chunk=run.loss_chunk, params=n_params,
               active_params=n_active, losses=losses,
               step_ms=[1e3 * t for t in steps_s], mean_step_ms=step_ms,
               tokens_per_s=tokens / (step_ms / 1e3), model_flops=flops,
               bf16_peak_share=flops / (step_ms / 1e3) / hw.PEAK_FLOPS_BF16,
               torch_peak_bytes=peak,
               dryrun_peak_bytes=fake["memory"]["peak_bytes_estimate"],
               count_card_s=count_s, count_fake_s=fake["count_s"],
               counts=held_to_fake(torch, f"lm bf16 {what}", real, fake,
                                   lambda: saved_record(record), step_ms,
                                   smi))
    log(f"lm bf16 train {arch}: {n_params} params ({n_active} active), "
        f"{steps} steps of {tokens} tokens (microbatch {run.microbatch}, "
        f"remat {run.remat}), losses {[round(x, 4) for x in losses]}; "
        f"{step_ms:.1f} ms a step over steps 2+ (the first, counted, "
        f"{1e3 * steps_s[0]:.1f}), {out['tokens_per_s']:.0f} tokens/s, "
        f"{flops:.4g} model FLOPs a step = "
        f"{100 * out['bf16_peak_share']:.2f} % of the bfloat16 peak; torch "
        f"peak {peak} bytes, the dry run's {out['dryrun_peak_bytes']}")
    del state, real, step, init
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_bf16_decode(torch, fake, record, smi):
    """Phase 24 (d): qwen3-1.7b's decode_32k at LM_BF16_DECODE_BATCH slots
    through serve_step.build_serve_fns, its bfloat16 cache filled with
    seeded values and the step at cache length 32,767, timed (CUDA events,
    median of LM_DRYRUN_REPS after a warm one) and held to the fake
    tensors' count."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPE_CELLS
    from repro_torch.roofline import hlo_cost
    from repro_torch.serve.serve_step import build_serve_fns

    cfg = registry.get_config(LM_BF16_ARCH)
    S = SHAPE_CELLS["decode_32k"].seq_len
    B = LM_BF16_DECODE_BATCH
    run = lm_bf16_run(LM_BF16_ARCH, "decode_32k")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fns = build_serve_fns(cfg, run, max_len=S, batch=B, device=DEV)
    model = fns["model"].init(SEED)
    cache = fns["init_cache"]()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 24)
    cache_bytes = 0
    for c in cache:
        for t in c.values():
            t.normal_(generator=gen)
            cache_bytes += t.numel() * t.element_size()
    tok = torch.zeros((B, 1), dtype=torch.int32, device=DEV)
    cache, logits = fns["decode"](model, cache, tok, S - 1)     # warm
    times = []
    for _ in range(LM_DRYRUN_REPS):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        cache, logits = fns["decode"](model, cache, tok, S - 1)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = float(np.median(times))
    if not bool(torch.isfinite(logits).all()) or tuple(logits.shape[:2]) \
            != (B, 1):
        raise AssertionError(f"lm bf16 decode_32k: logits {logits.shape}, "
                             "not all finite")
    peak = int(torch.cuda.max_memory_allocated())
    t0 = time.perf_counter()
    real = hlo_cost.run(fns["decode"], model, cache, tok, S - 1)
    count_s = time.perf_counter() - t0
    real.result = None
    out = dict(arch=LM_BF16_ARCH, batch=B, cache_len=S - 1,
               cache_bytes=cache_bytes, ms=times, median_ms=ms,
               dryrun_bound_ms=1e3 * fake["roofline"]["step_s_bound"],
               torch_peak_bytes=peak,
               dryrun_peak_bytes=fake["memory"]["peak_bytes_estimate"],
               count_card_s=count_s, count_fake_s=fake["count_s"],
               counts=held_to_fake(
                   torch, f"lm bf16 decode {LM_BF16_ARCH} decode_32k {B} x "
                   f"{S}", real, fake, lambda: saved_record(record), ms,
                   smi))
    log(f"lm bf16 decode_32k {LM_BF16_ARCH}: batch {B} against a "
        f"{cache_bytes}-byte bfloat16 cache at length {S - 1}: {ms:.3f} ms "
        f"a step (median of {LM_DRYRUN_REPS}), the dry run's bound "
        f"{out['dryrun_bound_ms']:.4g} ms; torch peak {peak} bytes, the dry "
        f"run's {out['dryrun_peak_bytes']}")
    del model, cache, logits, real, fns
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_bf16_moe_resume(torch):
    """Phase 24 (e): the reduced granite-moe in bfloat16 at the train_4k
    RunConfig (seq LM_FAMILY_RESUME_BATCH's), failed at step 5 and resumed
    against 10 straight steps, bit for bit (lm_resume_check)."""
    from repro_torch.configs import registry
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optimizer import OptConfig

    small = registry.get_config(LM_BF16_MOE_ARCH, reduced=True)
    b, s = LM_FAMILY_RESUME_BATCH
    run = lm_bf16_run(LM_BF16_MOE_ARCH, "train_4k", s)
    src = SyntheticLM(small, b, s, seed=SEED)
    out = lm_resume_check(small, run, OptConfig(lr=1e-3, warmup_steps=2,
                                                decay_steps=100),
                          [src.batch_at(i) for i in range(10)])
    return dict(out, batch=[b, s], compute_dtype=run.compute_dtype,
                microbatch=run.microbatch, remat=run.remat)


def lm_bf16_phase(torch, dry, lm_serve, smi):
    """Phase 24: the language models at the reference's compute dtype,
    bfloat16, on the card (module docstring)."""
    from repro_torch.models import numerics

    exact_matmuls()
    t0 = time.perf_counter()
    out = dict(parity=lm_bf16_parity(torch))
    out["serve"] = lm_bf16_serve(torch, lm_serve)
    counts, out["fake_counts_s"] = lm_bf16_fake(dry)
    out["fake_counts"] = counts

    def fake(arch, cell):
        return (counts[f"{arch}:{cell}"],
                os.path.join(dry.bf16, f"{arch}__{cell}.ops.zst"))

    out["train"] = lm_bf16_train_cell(
        torch, LM_BF16_ARCH, LM_BF16_TRAIN_STEPS,
        *fake(LM_BF16_ARCH, "train_4k"), smi)
    out["decode"] = lm_bf16_decode(torch, *fake(LM_BF16_ARCH, "decode_32k"),
                                   smi)
    out["moe_train"] = lm_bf16_train_cell(
        torch, LM_BF16_MOE_ARCH, LM_BF16_MOE_STEPS,
        *fake(LM_BF16_MOE_ARCH, "train_4k"), smi)
    out["moe_resume"] = lm_bf16_moe_resume(torch)
    out["seconds"] = time.perf_counter() - t0
    out["atol"] = dict(logits=numerics.LOGITS_ATOL, ulps=numerics.LOGITS_ULPS,
                       loss=LM_BF16_LOSS_ATOL,
                       grad_rel=LM_BF16_GRAD_REL)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_forward(torch, model, cfg, batch):
    """The full forward (train mode) of a SyntheticLM batch on the model's
    device: its logits ``[B, S, V]`` as float32 on the host, and the router
    logits of its MoE calls (moe.recording_router_logits)."""
    from repro_torch.models.moe import recording_router_logits

    b = {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()}
    with torch.inference_mode(), recording_router_logits() as router:
        if cfg.encoder_layers:
            h, _ = model._dec_forward(b["tokens"], model._cross_kv(
                model.encode(b["enc_frames"])), "train", None, None)
            logits = model._logits(h)
        else:
            h, _ = model.hidden(b["tokens"], b.get("patch_embeds"),
                                mode="train")
            logits = model.logits(h)
    return logits.float().cpu(), router


def lm_bf16_family_cpu(torch):
    """Phase 25 (a)'s CPU half, in a Side process started after phase 7:
    each LM_BF16_FAMILIES arch reduced, in bfloat16 at its train_4k
    RunConfig (LM_BF16_PARITY's sequence), ``init(SEED)`` and SyntheticLM's
    batch 0: one train step's loss and gradients (lm_grads), the full
    forward's logits and router logits (lm_forward)."""
    from repro_torch.configs import registry
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.data import SyntheticLM

    torch.set_num_threads(2)            # beside the main sequence
    out = {}
    batch, seq = LM_BF16_PARITY
    for arch in LM_BF16_FAMILIES:
        t0 = time.perf_counter()
        cfg = registry.get_config(arch, reduced=True)
        run = lm_bf16_run(arch, "train_4k", seq)
        model = build_model(cfg, run, "cpu").init(SEED)
        data = SyntheticLM(cfg, batch, seq, seed=SEED).batch_at(0)
        loss, grads = lm_grads(torch, model, cfg, data)
        logits, router = lm_forward(torch, model, cfg, data)
        out[arch] = dict(loss=loss, grads=grads, logits=logits.numpy(),
                         router=[r.numpy() for r in router])
        log(f"lm bf16 families on the CPU {arch}: "
            f"{time.perf_counter() - t0:.1f} s")
    return out


def lm_bf16_family_parity(torch, cpu_side):
    """Phase 25 (a): the card's half of lm_bf16_family_cpu (the same
    reduced models, parameters and batches) against the CPU's: the loss
    within LM_BF16_LOSS_ATOL; each gradient leaf within LM_BF16_GRAD_REL
    of its largest magnitude; the logits within numerics' per-row bound,
    for a MoE arch but where a near-tie router flip moved a token (the
    flips logged)."""
    from repro_torch.configs import registry
    from repro_torch.models import numerics
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.data import SyntheticLM

    cpu = cpu_side.join()
    out = {}
    batch, seq = LM_BF16_PARITY
    for arch in LM_BF16_FAMILIES:
        want = cpu[arch]
        cfg = registry.get_config(arch, reduced=True)
        run = lm_bf16_run(arch, "train_4k", seq)
        card = build_model(cfg, run, "cpu").init(SEED).to(DEV)
        data = SyntheticLM(cfg, batch, seq, seed=SEED).batch_at(0)
        loss, grads = lm_grads(torch, card, cfg, data)
        logits, router = lm_forward(torch, card, cfg, data)
        loss_err = abs(loss - want["loss"])
        grad_rel = max(
            float(np.max(np.abs(g - w))) / max(float(np.max(np.abs(w))),
                                               1e-30)
            for g, w in zip(grads, want["grads"]) if g.size)
        B, P = logits.shape[:2]
        keep, flips = None, []
        if cfg.moe:
            tracker = numerics.FlipTracker(cfg.experts_per_token)
            tracker.add(want["router"], router, *zip(*[
                (b, s) for b in range(B) for s in range(P)]))
            tracker.check(f"lm bf16 parity {arch}")
            keep = torch.tensor([[not tracker.moved(b, s) for s in range(P)]
                                 for b in range(B)])
            flips = [dict(layer=f["layer"], tokens=f["tokens"],
                          gaps=f["gaps"], later=f["later"])
                     for f in tracker.flips]
        err, ulps, over = numerics.bf16_logits_err(
            logits, torch.from_numpy(want["logits"]), cfg.vocab_size, keep)
        row = dict(arch=arch, batch=[batch, seq], loss_cpu=want["loss"],
                   loss_card=loss, loss_abs_err=loss_err,
                   grad_max_rel_err=grad_rel, leaves=len(grads),
                   logits_max_abs_err=err, logits_max_ulps=ulps,
                   logits_over_bound=over, router_flips=flips)
        log(f"lm bf16 parity {cfg.name} ({batch} x {seq}, microbatch "
            f"{run.microbatch}, remat {run.remat}): loss card {loss:.6f} vs "
            f"cpu {want['loss']:.6f} (|err| {loss_err:.3g}), "
            f"{len(grads)} gradient leaves within {grad_rel:.3g} of their "
            f"scale; logits max |err| {err:.3g} ({ulps:.2f} ulps, "
            f"{over:.2f} of the bound); router flips {flips}")
        if not (loss_err <= LM_BF16_LOSS_ATOL
                and grad_rel <= LM_BF16_GRAD_REL and over <= 1):
            raise AssertionError(f"lm bf16 parity {cfg.name}: {row}")
        out[arch] = row
        del card
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_bf16_depth(arch, overrides):
    """``overrides`` with the fewest layers cut that keep the model's
    float32 masters, at 4.2 bytes a parameter (its bfloat16 copies and
    activations beside them), under LM_BF16_PEAK_CAP; ``overrides``
    itself where the whole depth fits."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.configs.base import RunConfig
    from repro_torch.models.model_zoo import build_model, param_count

    cfg = dataclasses.replace(registry.get_config(arch), **overrides)
    n = param_count(build_model(cfg, RunConfig(), "meta"))
    if 4.2 * n <= LM_BF16_PEAK_CAP:
        return overrides
    per = n / cfg.num_layers
    return {**overrides, "num_layers": int(LM_BF16_PEAK_CAP / 4.2 / per)}


def lm_bf16_alone(torch, lm_families):
    """Phase 25 (b): LM_BF16_ALONE_ARCH at full width served in bfloat16
    at the serve CLI's defaults (lm_bf16_engine), LM_SINGLE_RIDS again
    each alone.  In an engine of as many slots: tokens and logits equal
    to its batched slot's bit for bit at every step (a slot's result
    depends on its own request only).  In a 1-slot engine: the prefill's
    logits equal bit for bit, and decode step i's within
    LM_BF16_ALONE_ULPS * sqrt(i) bfloat16 ulps of its row's largest
    |logit|: a batch of 1 and one of 4 run other cuBLAS kernels, which sum
    in other orders, and the recurrent state carries each step's moved
    rounding into the next, a random walk (PERF.md §6 PR 30).  Figures
    beside phase 21 (a)'s float32 serve CLI run."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.model_zoo import build_model

    arch = LM_BF16_ALONE_ARCH
    args = serve_cli.parse_args(["--arch", arch])
    cfg = registry.get_config(arch)
    run = dataclasses.replace(RunConfig(remat="none", q_chunk=64,
                                        kv_chunk=64),
                              compute_dtype="bfloat16")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, run, DEV).init(args.seed)
    eng, outs, wall, _, alone, worst, _ = lm_bf16_engine(
        torch, cfg, run, model, args, same_slots=True)
    steps = eng.stats["decode_steps"]
    n_tok = sum(len(o.tokens) for o in outs)
    mem = lm_memory(torch)
    far = {}
    for rid, row in alone.items():
        ulps = row["ulps_by_step"]
        row["walk_by_step"] = [u / LM_BF16_ALONE_ULPS / max(i, 1) ** 0.5
                               for i, u in enumerate(ulps)]
        bad = [(i, u) for i, u in enumerate(ulps)
               if (u > 0 if i == 0 else u > LM_BF16_ALONE_ULPS * i ** 0.5)]
        if bad or not row["same_slots_equal"]:
            far[rid] = dict(same_slots_equal=row["same_slots_equal"],
                            steps_beyond=bad)
    f32 = lm_families["serve_cli"]
    out = dict(arch=arch, slots=args.slots, requests=args.requests,
               tokens=n_tok, decode_steps=steps, wall_s=wall,
               tokens_per_s=n_tok / wall,
               prefill_ms=1e3 * float(np.mean([o.prefill_s for o in outs])),
               decode_step_ms=1e3 * sum(o.decode_s for o in outs) / steps,
               alone=alone, alone_max_abs=worst[0], alone_max_ulps=worst[1],
               alone_ulps_per_sqrt_step=LM_BF16_ALONE_ULPS, **mem,
               float32={k: f32[k] for k in (
                   "prefill_ms", "decode_step_ms", "tokens_per_s",
                   "torch_peak_bytes")})
    log(f"lm bf16 serve {arch}: {args.requests} requests, {args.slots} "
        f"slots, {steps} decode steps; prefill {out['prefill_ms']:.1f} ms a "
        f"request (float32 {f32['prefill_ms']:.1f}), "
        f"{out['decode_step_ms']:.2f} ms a decode step "
        f"({f32['decode_step_ms']:.2f}), {out['tokens_per_s']:.1f} tokens/s "
        f"({f32['tokens_per_s']:.1f}), torch peak {mem['torch_peak_bytes']} "
        f"({f32['torch_peak_bytes']}); requests {list(LM_SINGLE_RIDS)} "
        f"alone in {args.slots} slots equal to their batched slots: "
        f"{[a['same_slots_equal'] for a in alone.values()]}; in 1 slot, "
        f"logits within {worst[0]:.3g} ({worst[1]:.2f} ulps) over "
        f"{[a['steps_compared'] for a in alone.values()]} steps, tokens "
        f"{'equal' if all(a['tokens'] == a['batched'] for a in alone.values()) else 'differ'}"
        f"; by step, |batched - alone| in ulps over "
        f"{LM_BF16_ALONE_ULPS} sqrt(step) "
        + "; ".join(f"{rid}: {[round(w, 3) for w in a['walk_by_step']]}"
                    for rid, a in alone.items()))
    if far:
        raise AssertionError(f"lm bf16 serve {arch}: batched vs alone "
                             f"(steps beyond {LM_BF16_ALONE_ULPS} ulps x "
                             f"sqrt(step), 0 at the prefill): {far}")
    del model, eng, outs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_bf16_family_serve(torch, lm_serve, lm_families):
    """Phase 25 (b): LM_BF16_SERVE at full width in bfloat16 with a
    bfloat16 cache (lm_family_decode; a model that would pass
    LM_BF16_PEAK_CAP cut in depth, lm_bf16_depth), LM_WINDOW_ARCH past its
    window (lm_window_decode) and LM_BF16_ALONE_ARCH batched vs alone
    (lm_bf16_alone), each beside the float32 figures of phases 19 (b) and
    21 of this run where they ran the arch."""
    from repro_torch.configs import registry

    f32 = {r["arch"]: r for r in lm_families["decode"]}
    out = dict(decode=[], reduced={})
    for arch, overrides in LM_BF16_SERVE:
        overrides = lm_bf16_depth(arch, overrides)
        if "num_layers" in overrides:
            out["reduced"][arch] = (f"num_layers {overrides['num_layers']} "
                                    f"of {registry.get_config(arch).num_layers}")
        gc.collect()
        torch.cuda.empty_cache()
        row = lm_family_decode(torch, arch, overrides, "bfloat16")
        if row["torch_peak_bytes"] > LM_BF16_PEAK_CAP:
            raise AssertionError(f"lm bf16 serve {arch}: torch peak "
                                 f"{row['torch_peak_bytes']} bytes above "
                                 f"{LM_BF16_PEAK_CAP:.4g}")
        row["float32"] = ({k: f32[arch][k] for k in (
            "prefill_ms", "mean_decode_step_ms", "tokens_per_s",
            "torch_peak_bytes", "layers")} if arch in f32 else None)
        if row["float32"] is not None:
            ref = row["float32"]
            log(f"  {arch} bfloat16 vs float32 (phase 21, "
                f"{ref['layers']} layers): prefill {row['prefill_ms']:.1f} "
                f"vs {ref['prefill_ms']:.1f} ms, decode "
                f"{row['mean_decode_step_ms']:.2f} vs "
                f"{ref['mean_decode_step_ms']:.2f} ms a step, "
                f"{row['tokens_per_s']:.1f} vs {ref['tokens_per_s']:.1f} "
                f"tokens/s, torch peak {row['torch_peak_bytes']} vs "
                f"{ref['torch_peak_bytes']}")
        out["decode"].append(row)
    out["window"] = lm_window_decode(torch, "bfloat16")
    ref = lm_serve["b"]
    out["window"]["float32"] = {k: ref[k] for k in (
        "prefill_ms", "mean_decode_step_ms", "tokens_per_s",
        "torch_peak_bytes")}
    log(f"  {LM_WINDOW_ARCH} bfloat16 vs float32 (phase 19 (b)): prefill "
        f"{out['window']['prefill_ms']:.1f} vs {ref['prefill_ms']:.1f} ms, "
        f"decode {out['window']['mean_decode_step_ms']:.2f} vs "
        f"{ref['mean_decode_step_ms']:.2f} ms a step, torch peak "
        f"{out['window']['torch_peak_bytes']} vs {ref['torch_peak_bytes']}")
    out["alone"] = lm_bf16_alone(torch, lm_families)
    return out


def lm_bf16_family_phase(torch, dry, cpu_side, lm_serve, lm_families,
                         lm_bf16, smi):
    """Phase 25: the other language models at the reference's compute
    dtype, bfloat16, on the card (module docstring); whisper-base's counts
    on fake tensors are among those phase 24 (``lm_bf16``) joined."""
    from repro_torch.models import numerics

    exact_matmuls()
    t0 = time.perf_counter()
    out = dict(parity=lm_bf16_family_parity(torch, cpu_side))
    out["serve"] = lm_bf16_family_serve(torch, lm_serve, lm_families)
    arch = LM_BF16_TRAIN_ARCH
    out["train"] = lm_bf16_train_cell(
        torch, arch, LM_BF16_FAMILY_STEPS,
        lm_bf16["fake_counts"][f"{arch}:train_4k"],
        os.path.join(dry.bf16, f"{arch}__train_4k.ops.zst"), smi)
    out["reduced"] = dict(out["serve"]["reduced"], parity=(
        f"the reduced configs at {LM_BF16_PARITY[0]} x "
        f"{LM_BF16_PARITY[1]}"), train=(
        f"{arch} train_4k at batch {LM_BF16_TRAIN_BATCH} (of "
        "the cell's 256 sequences: one a microbatch)"))
    out["seconds"] = time.perf_counter() - t0
    out["bounds"] = dict(logits_atol=numerics.LOGITS_ATOL,
                         logits_ulps=numerics.LOGITS_ULPS,
                         near_tie_ulps=numerics.NEAR_TIE_ULPS,
                         max_flip_share=numerics.MAX_FLIP_SHARE,
                         loss=LM_BF16_LOSS_ATOL, grad_rel=LM_BF16_GRAD_REL)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def kernel_entry(name, source, replaces, launches, by_path, err, row, case):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=err, ms=row["kernel_ms"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=row["library_ms"],
                case=case, launches_by_path=by_path,
                **{k: row[k] for k in ("library_full_ms", "composition_ms")
                   if k in row})


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.apps import MultiSourceBFS, PageRank
    from repro_torch.kernels import _build

    t_all = time.perf_counter()
    phase_s = {}

    def mark(name, t0):
        phase_s[name] = time.perf_counter() - t0
        line = (f"[phase {name}: {phase_s[name]:.1f} s, "
                f"{time.perf_counter() - t_all:.1f} s in all]")
        log(line)
        print(line, file=sys.stderr, flush=True)

    # a run still going near the time limit prints every thread's stack
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=False)

    exact_matmuls()
    smi = card_info(torch)

    # the nvcc processes run while the store's edges are drawn and tiled
    built = {}

    def build_kernels():
        try:
            built["builds"] = _build.build()
        except Exception as e:            # raised again on the main thread
            built["error"] = e
        built["seconds"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    build_thread = threading.Thread(target=build_kernels)
    build_thread.start()
    store_root = os.path.join(ROOT, "build", "chip_smoke_store")
    ckpt_root = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(store_root, ignore_errors=True)
    shutil.rmtree(ckpt_root, ignore_errors=True)
    dry = None
    try:
        store, plan, src, dst, store_info = build_store(store_root)
        nv = plan.num_vertices
        mark("store", t0)
        build_thread.join()
        if "error" in built:
            raise built["error"]
        builds = built["builds"]
        log(f"build: {built['seconds']:.1f} s for {', '.join(builds)}, "
            f"beside the store (nvcc {' '.join(_build.NVCC_FLAGS)})")
        for name, b in builds.items():
            regs = [int(w) for w in re.findall(r"Used (\d+) registers",
                                                b["ptxas"])]
            spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill",
                                                    b["ptxas"]))
            log(f"  {name}: {len(regs)} kernels, at most "
                f"{max(regs, default=0)} registers a thread, {spills} bytes "
                "of spills")
        mark("build", t0)

        t0 = time.perf_counter()
        big = int(np.argmax(plan.edges_per_tile))
        tile = store.read_tile(big)
        log(f"kernel shapes from tile {big}: E {plan.edge_cap}, "
            f"R {plan.row_cap}, {tile.meta.num_edges} real edges, "
            f"{tile.meta.num_rows} rows")
        tile_lengths = row_lengths(tile.dst_local, plan.row_cap + 1,
                                   f"tile {big}")
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
        check_segment_order(torch, tile, plan)
        seg_rows, seg_err = check_segment_kernel(torch, tile, plan, flush)
        merged_row, merged_err = check_merged_segment(torch, dst, nv, flush)
        seg_rows.append(merged_row)
        skewed_rows = check_segment_skewed_int32(torch, flush)
        seg_rows.extend(skewed_rows)
        int32_launches = segment_int32_launches(torch, tile, plan)
        seg_err = max(seg_err, merged_err)
        fused_rows, fused_err = check_fused_kernel(torch, tile, plan, flush)
        pad_rows, pad_err = check_fused_padding_hub(torch, tile, plan, flush)
        fused_err = max(fused_err, pad_err)
        compact_rows, compact_err = check_compact_kernel(torch, nv, flush)
        del flush
        torch.cuda.empty_cache()
        mark("kernels", t0)

        t0 = time.perf_counter()
        eng, main_launches, summaries, pr_rel, pr, bfs, indeg = main_path(
            torch, store, src, dst)
        mark("main path", t0)
        t0 = time.perf_counter()
        compact_launches, compact_counts = compact_path(torch, bfs)
        mark("compact path", t0)
        t0 = time.perf_counter()
        prof = profile_superstep(torch, engine(store, tile_skipping=False),
                                 PageRank(), "pagerank")
        del eng
        mark("profile pagerank", t0)

        # phase 11, the out-of-core parts of phases 12 and 15 and phase
        # 23's dry-run cells run in side processes beside phases 8-10
        # (host work; the card idles)
        dry = DryRuns(LM_DRYRUN_JOBS,
                      os.path.join(ROOT, "build", "chip_smoke_dryrun"))
        out_degree = store.load_degrees()[1]
        sources = pick_sources(out_degree)
        s9, s10 = pick_admitted(src, dst, out_degree, sources)
        side_ooc = Side("ooc_phase", store_root, indeg)
        side_admission = Side("admission_ooc", store_root, sources, s9, s10)
        side_ckpt = Side("checkpoint_ooc", store_root, ckpt_root)
        side_bf16 = Side("lm_bf16_family_cpu")

        t0 = time.perf_counter()
        (sources, batched_launches, batched, msbfs, levels,
         ppr_err) = batched_apps(torch, store, src, dst, bfs)
        mark("batched apps", t0)
        t0 = time.perf_counter()
        mode_rows, mode_launches = modes(torch, store, sources, pr, msbfs)
        mark("modes", t0)
        t0 = time.perf_counter()
        prof_q = profile_superstep(torch, engine(store, tile_skipping=False),
                                   MultiSourceBFS(sources=sources),
                                   f"msbfs Q={len(sources)}")
        mark("profile msbfs", t0)

        t0 = time.perf_counter()
        footprints = time_footprints(store, plan)
        ooc_rows, prof_ooc, ooc_launches = side_ooc.join()
        mark("ooc", t0)
        t0 = time.perf_counter()
        admission_ooc_part = side_admission.join()
        ckpt_ooc_part = side_ckpt.join()
        mark("side processes", t0)
        t0 = time.perf_counter()
        admission, admission_launches = admission_phase(
            torch, store, sources, s9, s10, msbfs, levels, admission_ooc_part)
        ooc_rows.append(admission["ooc"])
        mark("admission", t0)
        t0 = time.perf_counter()
        mesh, mesh_launches = mesh_phase(torch, store, pr, msbfs, sources)
        mark("mesh", t0)
        t0 = time.perf_counter()
        cluster, cluster_launches, single = cluster_phase(
            torch, store, pr, sources, admission["s9"])
        mark("cluster", t0)
        t0 = time.perf_counter()
        checkpoint, ckpt_launches = checkpoint_phase(
            torch, store, pr, single, sources, s9, ckpt_root, ckpt_ooc_part)
        mark("checkpoint", t0)
        t0 = time.perf_counter()
        serve, serve_launches = serve_phase(
            torch, store, src, dst, sources, msbfs, levels,
            admission["s9"], admission["s10"])
        mark("serve", t0)
        t0 = time.perf_counter()
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
        calibration = calibrate_tuner(torch, flush, tile, plan)
        tune_rows = tune_candidates(torch, tile, plan, flush)
        del flush
        torch.cuda.empty_cache()
        tune_runs, tune_launches = tune_engine_runs(torch, store, pr, msbfs,
                                                    sources)
        mark("tune", t0)
        t0 = time.perf_counter()
        baselines = baselines_phase(torch, store, src, dst, pr)
        mark("baselines", t0)
        t0 = time.perf_counter()
        reset_launches()
        lm_serve = lm_serve_phase(torch)
        lm_launches = read_launches()
        log(f"lm serve launches: {lm_launches} (the LM path runs no "
            "kernel of the graph engine)")
        mark("lm serve", t0)
        t0 = time.perf_counter()
        reset_launches()
        lm_train = lm_train_phase(torch)
        lm_train_launches = read_launches()
        log(f"lm train launches: {lm_train_launches} (the LM path runs no "
            "kernel of the graph engine)")
        mark("lm train", t0)
        t0 = time.perf_counter()
        reset_launches()
        lm_families = lm_families_phase(torch)
        lm_families_launches = read_launches()
        log(f"lm families launches: {lm_families_launches} (the LM path runs "
            "no kernel of the graph engine)")
        mark("lm families", t0)
        gc.collect()
        t0 = time.perf_counter()
        reset_launches()
        lm_mesh = lm_mesh_phase(torch, lm_train)
        lm_mesh_launches = read_launches()
        log(f"lm mesh launches: {lm_mesh_launches} (the mesh path runs no "
            "kernel of the graph engine)")
        mark("lm mesh", t0)
        gc.collect()
        t0 = time.perf_counter()
        reset_launches()
        lm_dryrun = lm_dryrun_phase(torch, dry, smi)
        lm_dryrun_launches = read_launches()
        log(f"lm dryrun launches: {lm_dryrun_launches} (the dry run and the "
            "counter run no kernel of the graph engine)")
        mark("lm dryrun", t0)
        gc.collect()
        t0 = time.perf_counter()
        reset_launches()
        lm_bf16 = lm_bf16_phase(torch, dry, lm_serve, smi)
        lm_bf16_launches = read_launches()
        log(f"lm bf16 launches: {lm_bf16_launches} (the LM path runs no "
            "kernel of the graph engine)")
        mark("lm bf16", t0)
        gc.collect()
        t0 = time.perf_counter()
        reset_launches()
        lm_bf16_families = lm_bf16_family_phase(
            torch, dry, side_bf16, lm_serve, lm_families, lm_bf16, smi)
        lm_bf16_families_launches = read_launches()
        log(f"lm bf16 families launches: {lm_bf16_families_launches} (the "
            "LM path runs no kernel of the graph engine)")
        mark("lm bf16 families", t0)
    finally:
        if dry is not None:
            dry.kill()
        shutil.rmtree(store_root, ignore_errors=True)
        shutil.rmtree(ckpt_root, ignore_errors=True)

    paths = {"main path": main_launches, "compact path": compact_launches,
             "batched apps": batched_launches, "modes": mode_launches,
             "ooc": ooc_launches, **admission_launches, **mesh_launches,
             **cluster_launches, **ckpt_launches, **serve_launches,
             "tune": tune_launches, "lm serve": lm_launches,
             "lm train": lm_train_launches,
             "lm families": lm_families_launches,
             "lm mesh": lm_mesh_launches, "lm dryrun": lm_dryrun_launches,
             "lm bf16": lm_bf16_launches,
             "lm bf16 families": lm_bf16_families_launches}
    total = {k: sum(p[k] for p in paths.values()) for k in main_launches}
    log(f"launches by path: {paths}; total {total}")

    def by_path(name):
        return {p: c[name] for p, c in paths.items()}

    serve_err = max(r["max_abs_err"] for r in serve["kernel_cases"])
    seg_src = ("segment_reduce",
               "src/repro_torch/kernels/csrc/segment_reduce.cu",
               "src/repro/kernels/gab_gather.py:127",
               total["segment_reduce"], by_path("segment_reduce"), seg_err)
    fused_src = ("gab_fused", "src/repro_torch/kernels/csrc/gab_fused.cu",
                 "src/repro/kernels/gab_fused.py:294", total["gab_fused"],
                 by_path("gab_fused"), max(fused_err, serve_err))
    compact_src = ("compact", "src/repro_torch/kernels/csrc/compact.cu",
                   "src/repro/kernels/compact.py:107", total["compact"],
                   by_path("compact"), compact_err)
    serve_case = max(serve["kernel_cases"], key=lambda r: r["launches"])

    def compact_case(n, density):
        return next(r for r in compact_rows
                    if r["n"] == n and r["density"] == density
                    and r["fill"] is None and r["offset"] == 0
                    and r["dtype"] == "torch.float32")

    kernels = [
        kernel_entry(*seg_src, next(r for r in seg_rows
                                    if r["combine"] == "sum" and r["q"] == 1
                                    and "shape" not in r),
                     "tile, sum, Q=1"),
        kernel_entry(*seg_src, next(r for r in seg_rows
                                    if r["combine"] == "sum"
                                    and r["q"] == NUM_QUERIES),
                     f"tile, sum, Q={NUM_QUERIES}"),
        kernel_entry(*seg_src, merged_row, "merged shape, sum, Q=1"),
        *(kernel_entry(*seg_src, r, f"C.1 skewed list, int32 {r['combine']}, "
                       f"Q=1, all {r['pairs']} block pairs equal")
          for r in skewed_rows),
        *(kernel_entry(*fused_src, next(r for r in fused_rows
                                        if r["spec"] == "pagerank"
                                        and r["q"] == q),
                       f"tile, PageRank spec, Q={q}")
          for q in (1, NUM_QUERIES)),
        kernel_entry(*fused_src, next(r for r in fused_rows
                                      if r["spec"] == "bfs"
                                      and r["q"] == NUM_QUERIES + 1),
                     f"tile, BFS spec, Q={NUM_QUERIES + 1}"),
        kernel_entry(*fused_src, serve_case,
                     f"tile, {serve_case['spec']} spec, Q={serve_case['q']} "
                     f"(the serve path's most launched shape)"),
        kernel_entry(*compact_src, compact_case(nv, 0.05),
                     f"V={nv}, density 0.05"),
        kernel_entry(*compact_src, compact_case(1 << 25, 0.01),
                     "V=2^25, density 0.01"),
        *({**kernel_entry(*(fused_src if r["kernel"] == "gab_fused"
                            else seg_src)[:5], r["max_abs_err"], r,
                          tune_case(r)), "blocks": r["pick"]}
          for r in tune_rows),
    ]
    seconds = time.perf_counter() - t_all
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=smi, torch=torch.__version__,
                       cuda=torch.version.cuda, builds={
                           k: v["seconds"] for k, v in builds.items()},
                       store=store_info, tile_row_lengths=tile_lengths,
                       segment=seg_rows, fused=fused_rows,
                       segment_int32_launches=int32_launches,
                       fused_padding_hub=pad_rows,
                       compact=compact_rows, compact_path=compact_counts,
                       apps=summaries, pagerank_max_rel_err=pr_rel,
                       sources=list(sources), batched=batched,
                       batched_errors=ppr_err, modes=mode_rows,
                       profile=prof, profile_msbfs=prof_q,
                       footprints=footprints, ooc=ooc_rows,
                       profile_ooc=prof_ooc, admission=admission,
                       mesh=mesh, cluster=cluster, checkpoint=checkpoint,
                       serve=serve, tune_calibration=calibration,
                       tune=tune_rows, tune_runs=tune_runs,
                       baselines=baselines, lm_serve=lm_serve,
                       lm_train=lm_train, lm_families=lm_families,
                       lm_mesh=lm_mesh, lm_dryrun=lm_dryrun,
                       lm_bf16=lm_bf16, lm_bf16_families=lm_bf16_families,
                       launches_by_path=paths, kernels=kernels,
                       phase_seconds=phase_s, seconds=seconds), f, indent=1)
    faulthandler.cancel_dump_traceback_later()
    log(f"total {seconds:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
