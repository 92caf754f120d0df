#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases; any failure exits non-zero before the result lines are printed.
  1. device       — needs CUDA; prints the card, its power limit and versions;
                    turns TF32 off for matmuls and convolutions.
  2. build        — builds every CUDA source of the port with nvcc, all at once,
                    and prints each one's ptxas registers and spills.
  3. kernel flash — holds the flash-attention kernel (bf16: wgmma and TMA;
                    fp32: CUDA cores) against its plain version at qwen3's,
                    jamba's, seamless-m4t's (encoder: non-causal, Sq=Sk=128;
                    decoder), qwen2-vl's (GQA group 7), mixtral's (GQA
                    group 6, window 4096: B=8 x 512, where it does not bind,
                    and B=1 x 8192, where it does), arctic's (56/8 heads,
                    GQA group 7), phi3-mini's (32/32 heads, Dh 96: three
                    32-column TMA boxes a row), granite's (32/8, Dh 64) and
                    internlm2's (48/8, Dh 128) serving shapes, the six
                    shapes of the kernel tests, ragged lengths, Dh=64 at the
                    serving length and a strided q, fp32 and bf16; times the
                    kernel, the plain version and PyTorch's SDPA (with the
                    window's boolean mask where there is a window) at the
                    eleven serving shapes, bf16, and prints the kernel over
                    SDPA and the bound over the kernel beside the bf16
                    kernel's ptxas line.
  4. kernel rwkv6 — holds the RWKV6 WKV kernel (bf16: chunked form on the
                    tensor cores; fp32: per-step loop on the CUDA cores)
                    against its plain version at the serving shape, the three
                    shapes of the kernel tests and ragged lengths (S=40, 17),
                    fp32 and bf16, and times the kernel and the plain version
                    (no single PyTorch call computes the recurrence), with the
                    bf16 instance's ptxas line.
  5. serve qwen3  — full-width qwen3-0.6B serving (bf16, B=8, 512-token prompts,
                    16 generated tokens) through ``repro_torch.launch.serve.run``;
                    the flash kernel must have launched once per layer per prefill.
  6. parity qwen3 — full-width fp32 prefill, kernel on against kernel off; then
                    bf16 on the same weights cast: kernel on against off must
                    stay within twice the bf16 plain path's error against fp32.
  7. serve rwkv6  — full-width rwkv6-1.6B serving, the same shape; the RWKV6
                    kernel must have launched once per layer per prefill.
  8. parity rwkv6 — full-width fp32 prefill, B=2 x 512, kernel on against off
                    (the chunked plain path): last logits and every layer's
                    state; then bf16 on the same weights cast: kernel on against
                    off within twice the bf16 plain path's error against fp32.
  9. kernel mamba — holds the Mamba selective-scan kernel (bf16: exp2 and
                    fused updates; fp32: rounded as the plain version) against
                    its plain version at jamba's serving shape, the two shapes
                    of the kernel tests, a ragged length and Di=200, fp32 and
                    bf16, and times the kernel and the plain version (no single
                    PyTorch call computes the scan), with the bf16 instance's
                    ptxas line.
 10. serve jamba  — jamba-1.5-large at full width without its experts, depth
                    cut from 72 to 16 layers (2 repeats), the same shape; the
                    Mamba kernel must have launched once per Mamba layer and
                    the flash kernel once per attention layer per prefill.
 11. parity jamba — full-width fp32 prefill at one repeat (8 layers), B=2 x
                    512, kernels on against off: last logits, every Mamba
                    layer's state and conv tail, the attention layer's k/v;
                    then the bf16 check of phase 8.
 12. checkpoint qwen3 — full-width qwen3-0.6B bf16 weights (seed 0) saved by
                    ``CheckpointManager`` into a new repository (whole-object
                    tier) and restored onto the card bit for bit; the annex
                    holds exactly the manifest's keys; times and rates of the
                    save, the restore, its host read and verify, and its
                    host-to-device copy. Then ``serve.run(..., repo=...)`` from
                    that commit: the flash kernel once per layer per prefill,
                    and phase 5's greedy tokens.
 13. checkpoint chunked — one 64 MiB bf16 leaf through the chunk tier (1 MiB
                    threshold), saved twice with 3% of its bytes changed in
                    between; each save restores bit for bit, and the second
                    writes few new chunks. Prints the chunks written and the
                    cutter's rate on this host.
 14. train qwen3  — full-width, full-depth qwen3-0.6B training (bf16 weights,
                    fp32 AdamW moments, remat) through
                    ``repro_torch.launch.train.run``: 8 steps of B=8 x 512
                    tokens in a new repository, one checkpoint at the end.
                    Prints step time p50/p95 over steps 2-8, tokens/s,
                    train_mfu, peak memory, every loss and the save time of
                    the whole train state. The flash kernel must launch 56
                    times a step (28 forward, 28 in remat's recompute). Then
                    5 steps on one fixed batch, whose loss must drop; one fp32
                    step cut to 2 layers, loss and every gradient kernel on
                    against off (2e-3 of each leaf's largest gradient); and,
                    with deterministic algorithms, cut to 2 layers, 6 steps
                    unbroken against 3, a new segment and 3 more: the step-6
                    checkpoints' annex keys (sha256 of each leaf's bytes) must
                    be equal.
 15. serve seamless — seamless-m4t-large-v2 at full width and depth (24
                    encoder and 24 decoder layers), phase 5's shape with the
                    stub speech frontend's 128 encoder frames a prompt; the
                    flash kernel must launch 48 times per prefill (24
                    non-causal in the encoder, 24 causal in the decoder).
 16. parity seamless — full-width, full-depth fp32 prefill, B=2 x 512 with
                    128 encoder frames, kernel on against off: last logits and
                    every cache (k, v and the projected memory xk, xv), 48
                    launches; then the bf16 check of phase 6.
 17. serve qwen2-vl — qwen2-vl-7b at full width and depth (28 layers), phase
                    5's shape with 64 vision positions a prompt and M-RoPE;
                    the flash kernel must launch 28 times per prefill.
 18. parity qwen2-vl — full-width fp32 prefill cut to 4 of 28 layers, B=2 x
                    512, three distinct M-RoPE streams (t=0 and h, w on an 8x8
                    grid over the vision positions, then the text's), kernel
                    on against off: last logits, k and v, 4 launches; then the
                    bf16 check.
 19. serve mixtral — mixtral-8x22b at full width (8 experts top-2, capacity
                    factor 1.25, window 4096), depth cut from 56 to 8 layers
                    (40.9 GB of bf16 weights), phase 5's shape; the flash
                    kernel must launch 8 times per prefill.
 20. serve mixtral long — the same model at B=1, a 8192-token prompt and 16
                    generated tokens: the window binds in the kernel and the
                    4096-slot ring KV cache wraps in prefill and in decode.
 21. parity mixtral — full-width fp32 prefill cut to 2 of 56 layers, B=2 x
                    512, kernel on against off. Routing is discrete (an ulp
                    in a layer's input can change a token's experts, and
                    through the capacity queue a later token's drop), so the
                    logits and caches are held with every layer routed to the
                    kernel-off run's experts, at PARITY_TOL; the free-running
                    runs' share of differing (token, slot) choices is printed
                    and held under MAX_FP32_FLIPS. Then bf16, routed the same
                    way, on against off within twice the bf16 plain path's
                    error against fp32; the free-running bf16 kernel-on run
                    may flip at most twice the choices that bf16 itself flips
                    against fp32.
 22. serve arctic — arctic-480b at full width (56/8 heads, 128 experts top-2,
                    capacity factor 1.25, the dense residual SwiGLU), depth
                    cut from 35 layers to 1 (28.1 GB of bf16 weights; at 2
                    layers the init's fp32 draw of a stacked expert leaf
                    would not fit), phase 5's shape; the flash kernel must
                    launch once per prefill. Each decode step streams all 128
                    experts' weights (capacity 1 a row at s=1).
 23. parity arctic — full-width fp32 prefill at the same 1 layer (56.3 GB of
                    fp32 weights), B=2 x 512, kernel on against off by phase
                    21's rule: the free-running share of rerouted choices,
                    then logits and k/v routed as the kernel-off run; then
                    bf16, the weights cast leaf by leaf in place (the fp32
                    and bf16 trees would not fit side by side).
 24. serve jamba experts — jamba-1.5-large with its experts at full width, one
                    8-layer repeat of 72 layers with 8 of its 16 experts (52.1
                    GB of bf16 weights; 16 experts are 90.7 GB), phase 5's
                    shape: 7 Mamba layers and 1 attention layer, the expert
                    FFN on positions 1, 3, 5 and 7; the Mamba kernel must
                    launch 7 times and the flash kernel once per prefill.
 25. parity jamba experts — full-width fp32 prefill of one repeat with 4 of 16
                    experts (65.4 GB of fp32 weights), B=2 x 512, by phase
                    21's rule, holding every Mamba layer's state and conv
                    tail beside the logits and k/v; then bf16 as phase 23.
 26. sharded qwen3 — a one-rank NCCL process group and a (1, 1) ("data",
                    "model") DeviceMesh, sharding rules from qwen3's config
                    knobs: full-width, full-depth qwen3-0.6B served from phase
                    5's seed weights placed as DTensors by
                    ``param_defs(cfg, rules)``, phase 5's prompts, through
                    ``make_prefill_step``/``make_decode_step(..., rules=...)``
                    (the flash kernel on each rank's heads through
                    ``local_map``): 28 flash launches a prefill and the first 8
                    of phase 5's greedy tokens exactly (its cache of 528
                    slots), with prefill and decode times beside phase 5's.
                    Then the same prompts again with the KV cache's slots
                    over tp (``decode_kv_shard="seq"``: each rank's part of
                    the decode softmax, combined by three all-reduces; the
                    owner of the new token's slot writes it): 28 flash
                    launches in its prefill and the same 8 tokens, its decode
                    p50/p95 beside the head_dim run's. Then one bf16 train step at phase 14's batch,
                    cut to 2 layers, under FSDP rules against the unsharded
                    step (deterministic algorithms for both, as phase 14's
                    resume): where not bit
                    for bit, the loss and the first moments (the gradients,
                    as one vector) within 2e-2 relative, and every param
                    within a flipped first Adam step (2 lr) plus bf16 rounding;
                    the sharded state saved from the mesh and restored onto the
                    mesh (``shardings``) and onto the card, both bit for bit,
                    with the annex keys of an unsharded save of the same tree.
                    One card holds one NCCL rank: the multi-rank checks run on
                    the CPU (tests/test_torch_sharded_run.py).
 27. dryrun       — the launch tools on the card's torch: the dry-run
                    (``repro_torch.launch.dryrun.run_cell``, meta tensors on a
                    fake process group of 256 or 512 ranks) of
                    tests/test_dryrun_smoke.py's four cells (the two train_4k
                    cells cut to 2 of 28 layers), each of which must
                    come back "ok", with its roofline row (model outputs from
                    H100 data-sheet constants, no card time). The card's memory
                    must equal launch/mesh.py's HBM_BYTES. Then the dry-run of
                    phase 5's prefill and one decode step at position 512, and of
                    phase 14's B=8 x 512 train step, cut to 2 of 28 layers,
                    unsharded and on a (1, 1) mesh, held against the same steps
                    run once on the card from seed weights: predicted peak
                    memory within 10% or 256 MiB of ``max_memory_allocated``
                    above the memory held before the step's arguments, FLOPs
                    equal to ``FlopCounterMode``'s over the card's run, and the
                    flash launches planned equal to the launches run (2, 0 and
                    4); prints each plan's roofline bound.
                    Also the dry-run of arctic-480b's and qwen2-vl-7b's
                    train_4k cells on the 16x16 mesh at full width with 1
                    layer, whose query heads (56, 28) do not split over its 16
                    tp ranks (ROADMAP §C4): each must come back "ok".
 28. campaign     — training on data pinned to commits through
                    ``repro_torch.launch.campaign.run`` (examples/
                    surrogate_campaign.py on the port's own Slurm protocol):
                    qwen3-0.6B at full width, cut to 2 of its 28 layers, phase
                    14's shapes (bf16 weights, fp32 moments, remat, B=8 x 512).
                    Data commit 1 is the octopus merge of 4 simulation jobs
                    (one ``submit_many`` on a local cluster, each job a
                    ``python3`` writing a shard of 65,536 tokens below 4096),
                    4 steps on a RepoTokenDataset pinned to it and a
                    checkpoint; data commit 2 (4 more jobs), a new
                    train_segment that resumes at step 4 and checkpoints at 8;
                    batch 0 resubmitted verbatim must be memoized, 4 of 4, with
                    no sbatch; then ``serve.run(..., repo=, commit=)`` from
                    the step-8 checkpoint. Every batch must equal one
                    recomputed from the shards' recipe with numpy alone; the
                    step-8 manifest must hold step 8 and data_step 8; each data
                    commit must merge 4 job commits whose records name their
                    shard.npy and a Slurm job id; ``Repository.log`` from the
                    step-8 checkpoint must list it, data commit 2, that
                    merge's job commits and the scripts' save under it, the
                    step-4 checkpoint, then data commit 1's likewise, and
                    nothing else; the flash
                    kernel must launch 4 times a step and 2 times a prefill,
                    and the served tokens must be finite and in the
                    vocabulary. Prints step p50/p95, tokens/s, peak memory and
                    each save's seconds.
 29. train rwkv6  — first the WKV op's backward (through ``rwkv6_ref``) at the
                    train shape (8, 512, 32, 64) in fp32 against the plain
                    version's autograd (GRAD_TOL), and, printed as a finding,
                    the time and gradient error of the chunked form's backward
                    there. Then rwkv6-1.6B at full width, cut to 8 of its 24
                    layers since PR 33 for the run's time (bf16 weights, fp32
                    moments, remat), B=8 x 512, 3 steps of
                    ``make_train_step`` on one batch: step 1 warms up, p50
                    over steps 2-3, the loss must drop, the WKV kernel must
                    launch 16 times a step (8 forward, 8 in remat's
                    recompute) and nothing else; peak memory, train_mfu. Then
                    one fp32 step cut to 2 layers, kernel on against off, as
                    phase 14's.
 30. train jamba  — the Mamba op's backward (through ``mamba_ref``) at (1, 512,
                    16384, 16) fp32 against the plain version's autograd
                    (GRAD_TOL), and, printed as a finding, the time and
                    gradient error there of ``ssm.mamba_scan_chunked``'s
                    backward (two 256-step chunks). Then
                    jamba-1.5-large without experts, one 8-layer repeat at full
                    width (9.116 B parameters, bf16 weights and moments,
                    remat), B=4 x 512, the largest batch whose planned peak
                    leaves 4 GiB of the card free: one bf16 gradient step
                    kernels on against off (loss within BF16_TOL), then 3
                    steps of ``make_train_step`` with finite losses, 14 Mamba
                    and 2 flash launches a step and nothing else, as many as
                    the dry-run's plan of the same step (``launch/dryrun.py
                    --one-card``, run under the card's torch in a process of
                    its own beside phases 3-29) counts, and the measured peak
                    within 10% or 256 MiB of that plan's, leaving 4 GiB of the
                    card free. Phases 29, 30, 41 and 42 print the card's name
                    and power limit beside their numbers; none saves (phases
                    14 and 28 drive the save path).
 31. serve phi3   — phi3-mini-3.8B at full width and depth (32 layers, 32/32
                    heads of Dh 96), phase 5's shape; the flash kernel must
                    launch 32 times per prefill.
 32. serve granite — granite-3-2B at full width and depth (40 layers, 32/8
                    heads of Dh 64, tied embeddings over a vocabulary of
                    49155 padded to 49408), phase 5's shape; 40 launches per
                    prefill.
 33. serve internlm2 — internlm2-20B at full width and depth (48 layers,
                    48/8 heads of Dh 128, 19.86 B parameters, 39.7 GB of
                    bf16 weights), phase 5's shape; 48 launches per prefill.
 34. parity dense — phi3, granite and internlm2 at full width cut to 2
                    layers each: fp32 prefill, B=2 x 512, kernel on against
                    off (last logits and every k/v), then the bf16 check of
                    phase 6.
 35. jobs         — in phase 28's repository, before it goes: four Slurm
                    jobs in one ``submit_many`` on a local cluster of 4
                    workers, submitted when phase 28 has taken its timings,
                    so that they start while phase 27 (run after phase 28
                    since PR 27) plans; phase 27 times no work on the card,
                    but its planning seconds are taken beside the jobs. Job k
                    (``jobs/serve_k/slurm.sh``) a ``python3`` that serves the
                    step-8 checkpoint commit through ``serve.run`` (qwen3 as
                    phase 28 cuts it, B=8, prompt 64, gen 16, seed k, on the
                    card, deterministic), saves its tokens as its declared
                    output ``tokens.npy`` and logs its stages' seconds. While
                    they run this process serves each seed. All four must
                    complete with their running intervals (env.json:
                    SubmitTime + Elapsed) overlapping; ``finish(octopus=True)``
                    must merge 4 job commits whose records carry their spec;
                    job k's tokens must equal ``serve.run``'s in this process
                    for seed k, and its committed log must show 2 flash
                    launches a prefill; job 0's spec resubmitted must be
                    memoized with no sbatch, and its ``reschedule`` must run
                    on the card again, alone, and commit the same tokens.npy
                    entry. No job may rebuild the kernels. Prints
                    submit-to-completion seconds, each job's runtime and
                    stages, and the finish and reschedule seconds. Its local
                    cluster numbers its jobs after the highest Slurm id in
                    the job database (``local_cluster``), so every record
                    names a Slurm id of its own.
 36. pipeline     — in phase 28's repository, after phase 35: one
                    ``repro_torch.Pipeline`` of three stages whose edges it
                    infers (prompts -> serve -> score; a local cluster
                    numbering after phase 35's ids). ``prompts`` (CPU) writes
                    pipe/prompts.npy, B=8 x 64 token ids from numpy's seeded
                    generator; ``serve`` (the card) restores the step-8
                    checkpoint (qwen3 as phase 28 cuts it) and greedily
                    decodes 16 tokens from those prompts through
                    ``make_prefill_step``/``make_decode_step``/
                    ``greedy_token``, deterministic, into
                    pipe/serve/tokens.npy, logging its flash launches;
                    ``score`` (CPU) reads pipe/serve/*.npy and writes
                    pipe/score.json (the tokens' sha256 and counts by
                    position). First ``run_pipeline(close_failed_jobs=True)``
                    with a serve script that exits 1 before python starts:
                    Slurm's afterok cascade must cancel ``score`` unstarted,
                    ``prompts`` must be committed, serve closed-failed and
                    score cancelled-dependency, both outputs released. The
                    fixed script is saved and the same pipeline run again
                    with ``finish=False``: prompts memoized with no sbatch,
                    serve then score run (score starts after serve ends),
                    ``job_deps`` names serve as score's parent. That finish
                    runs in a session with ``FaultPlan(crash_at=
                    {"finish:after-publish": 1})`` and must die with
                    ``CrashInjected``; a fresh session's ``recover()`` must
                    report 1 lock broken, 1 journal replayed, 1 commit
                    published again and 1 job finished again, ``verify()``
                    no divergence, every Slurm id's record must be published
                    once over all refs, and a second ``recover()`` must
                    replay nothing. The committed tokens.npy must equal this
                    process's greedy decode of the committed prompts through
                    the same functions, bit for bit, score.json this
                    process's score of them, and the serve job's committed
                    log 2 flash launches for its one prefill. Prints each
                    stage's submit-to-result and runtime, the finishes, the
                    recover and verify seconds and report, the killed
                    finish's journal bytes and lines, and the launches.
 37. remote sites — in phase 28's repository, after phase 36 (nothing timed
                    on the card beside it): opened on the GPFS cost model
                    with one ``SimClock``; sites siteA (LAN) and siteB
                    (WAN) added under a temporary directory. (1) The step-8
                    checkpoint's annex keys pushed to both under a seeded
                    ``NetworkFaultModel`` (one transient error and one
                    mid-stream disconnect on siteB's sends): retries >= 2,
                    one stranded tmp on siteB, not swept while its session
                    lives and swept by the next open. (2) A second push, of
                    fresh content (4 files of 1 MiB) to siteA, killed at
                    ``remote:push-mid-object``; ``recover()`` must replay
                    the push journal (``pushes_resumed`` 1), and the
                    objects sent before and after the kill must add up to
                    the ones the site lacked, none twice. (3) The params
                    leaves' local copies dropped under numcopies (fresh
                    probes), the repository reopened with siteA in an
                    outage, and pulled: a failover or siteA skipped, every
                    key from siteB, each file hashing to its key. (4) The
                    step-8 commit served through ``serve.run(repo=...)`` as
                    phase 28 served it: equal tokens, 2 flash launches a
                    prefill. (5) ROADMAP.md §C7: a params leaf dropped
                    again and ``CheckpointManager``'s restore run with
                    siteA down: it fetches from siteB (the reference
                    raises), bit for bit the weights read before. (6)
                    ``verify()``: no divergence, the location rows checked
                    against fresh probes, none stale. (7) One CPU Slurm job
                    (``python3`` with numpy) finished with
                    ``push_to="siteB"``: its output on siteB and in the
                    location rows. Prints each step's wall seconds, bytes
                    and objects per site, retries, failovers, the bytes
                    the store wrote (its byte counters count real bytes),
                    and the clock's modelled seconds and metadata
                    operations, which are a model of GPFS and the links,
                    not a measurement.
 38. gc and clone — in phase 28's repository, after phase 37 (nothing timed
                    on the card beside it): opened on the GPFS cost model
                    with one ``SimClock``, each FS seeded with the real
                    shard entry counts plus, until gc packs them, the
                    modelled loose files of a 100,000-file campaign
                    repository (390 entries a shard, past GPFS's 192:
                    ``FOOTPRINT_FILES``). (1) The loose objects counted and a
                    repack killed at ``repack:mid-unlink``; ``recover()``
                    must break the dead repack lock, ``verify()`` show no
                    divergence, and every commit of every branch read
                    back. (2) One fixed small save (the probe), then
                    ``gc()``: it packs the loose objects the killed repack
                    had not packed, unlinks every loose file and purges
                    the modelled ones (no shard holds an entry after it),
                    and the step-8 commit's tree
                    read from the pack equals the one read before; then
                    the probe again. (3) ``Repository.clone`` into a fresh
                    directory: no annex key local, siteA, siteB,
                    numcopies and the origin's annex as ``remote0`` in its
                    config; a branch at the step-8 checkpoint switched to,
                    whose annexed files are pointers; each params leaf
                    fetched with ``annex_get`` from ``remote0`` and hashing
                    to its key. (4) The step-8 commit served from the
                    clone through ``serve.run(repo=<clone>)`` as phase 28
                    served it: equal tokens, 2 flash launches a prefill.
                    Prints each step's wall seconds, the objects, bytes and
                    packs written, whether phases 28 and 35-37 auto-repacked
                    (a pack holding anything but commits), the clone's
                    bytes copied and fetched, and gc's, the probe's (with
                    the degradation term it pays) and the phase's modelled
                    (GPFS) seconds and metadata operations, which are a
                    model, not a measurement.
 39. cache controls — in phase 28's repository, after phase 38, on a local
                    cluster numbered after the job DB's highest Slurm id:
                    (1) a session with ``cache_env`` = the card's name and
                    power limit, torch and CUDA; (2) phase 35's job-1 spec
                    submitted there must miss (phase 35's row has no
                    environment) and reach sbatch; (3) job 0's spec with
                    ``refresh=True`` must reach sbatch too, both jobs
                    running on the card at once. (8) Meanwhile job 2's spec,
                    in a ``run_cache=False`` session, is cancelled as soon as
                    it is submitted: the next ``sacct`` must say CANCELLED.
                    (4) While the jobs run, ``examples/serve_batched_torch.py``'s
                    ``serve_batched`` at full qwen3 width and depth, bf16 seed
                    weights, B=8, prompt 64, gen 32: 28 flash launches for
                    its one prefill, greedy tokens equal to ``serve.run``'s
                    on the same weights and prompts; (5) then
                    ``examples/train_campaign_torch.py``'s campaign, its
                    middle checkpoint restored onto the card bit for bit,
                    its modelled seconds and metadata operations those of
                    the CPU run (``CAMPAIGN_EXAMPLE``). (6) After ``wait``
                    and ``finish``, each job's committed tokens.npy must
                    have phase 35's annex key for its seed and its log 2
                    flash launches a prefill, and no kernel was rebuilt.
                    (7) Job 1's spec submitted again is memoized with no
                    sbatch, under the same ``cache_env`` and, in a session
                    with none, on phase 35's row. (8) Job 2's tokens.npy is
                    untouched and ``finish`` closes its row. Prints the
                    submit-to-completion span, each job's runtime and
                    stages, the sbatch counts, the cancel's latency, and
                    the in-process serve's prefill and decode p50/p95,
                    which were taken beside the two jobs.
 40. data plane   — after phase 39, in fresh repositories under a temporary
                    directory, each on a modelled ``GPFS_STRIPED`` with its
                    own ``SimClock`` and ``LocalSlurmCluster`` (no other
                    phase's rows): ``benchmarks/bench_ingest.py``'s shape,
                    8 jobs x 8 files, cut from 64 to 16 MiB a file. One
                    ``submit_many`` of 8 trivial jobs (``true``) staged in an
                    alt-dir, ``cli_startup_s=0.35``; this process then
                    writes each job's outputs into the staging tree, bf16
                    bytes drawn on the card from a seeded generator (1 GiB a
                    case), and one ``finish`` commits all 8, once per case:
                    (a) ``data_plane="legacy"``, (b) fused serial, (c) fused
                    over ``ingest_workers=8``, (d) ``engine="full"``. The
                    outputs' tree oid must be one across the four cases,
                    (b)'s bytes read at most 0.6 of (a)'s, (c)'s modelled
                    seconds at most 0.5 of (b)'s (the reference gates' bars,
                    DESIGN.md §9), and job 0's first file, read back through
                    ``annex.read`` onto the card, equal to its source tensor
                    bit for bit. Each case's directory goes before the next
                    starts. Prints each case's finish wall seconds, modelled
                    (GPFS) seconds, bytes read and written, metadata
                    operations and CLI charges.
 41. train dense  — phi3-mini-3.8B and granite-3-2B at full width and depth,
                    internlm2-20B at full width cut to 12 of 48 layers (13
                    leave under 4 GiB of the card in its plan), each in turn:
                    one fp32 gradient step cut to 2 layers, B=8 x 512, kernel
                    on against off (loss and every gradient leaf within
                    PARITY_TOL); then, with deterministic algorithms, bf16
                    weights initialised on the card, fp32 moments, remat,
                    B=8 x 512: one bf16 gradient step kernels off against on
                    (loss within BF16_TOL) and 3 steps of ``make_train_step``
                    as phase 30 holds them: finite losses, the flash kernel
                    64, 80 and 24 times a step (each layer's forward and
                    remat's recompute) and nothing else, as the step's
                    ``--one-card`` plan (one process a model, started at the
                    device phase) counts, and the measured peak within 10% or
                    256 MiB of the plan's, leaving 4 GiB free. Prints step ms,
                    p50 over steps 2-3, tokens/s, train_mfu (6 x parameters x
                    tokens + 3 x the attention FLOPs), the peaks and the
                    card's memory left free. Phases 41-42 run with the
                    allocator's expandable segments (``expandable_segments``).
 42. train mixtral — mixtral-8x22b at full width (8 experts top-2, capacity
                    factor 1.25) cut to 2 of 56 layers, as phase 41 trains
                    each model, with routing held as phase 21 holds it: in
                    the fp32 2-layer step every MoE layer's forward and remat's
                    recompute route by the kernel-off step's experts
                    (``routing`` knows a layer by its router's weights), the
                    free-running step's rerouted share under MAX_FP32_FLIPS;
                    the bf16 loss check routed the same way. Flash launches 4
                    a step. train_mfu counts the active parameters (the
                    experts' at top_k / n_experts); beside it the share of
                    the expert GEMMs' slots that the capacity queue fills,
                    and the aux loss beside each step's loss. Its steps run
                    the MoE path (the queue's fp32 cumsum, one-hots, einsums)
                    under deterministic algorithms.
 43. train qwen3 accumulated — the JAX training path's last three options:
                    gradient accumulation, int8 error-feedback gradients and
                    async checkpoints. (1) Of the two plans started at the
                    device phase, qwen3-0.6B's step at B=64 x 512 in one pass
                    must not fit the card (FREE_GIB free), and the one in 8
                    microbatches of 8 with the compression (``--compress-
                    grads``) must. (2) fp32 at full width, 2 layers, B=16 as
                    2 microbatches of 8: the gradient step kernel on against
                    off as ``train_parity`` holds it (8 flash launches; where
                    the accumulation's bf16 cast rounds the two fp32 sums to
                    neighbours, an element may also differ by one bf16
                    step), and one AdamW step against one pass of 16 (loss
                    within 2e-3, params within rtol and atol 5e-3:
                    tests/test_microbatch.py). (3) Two rounds of
                    ``ef_compress_tree``, the residual carried, on those
                    accumulated gradients (bf16) and on the one-pass
                    gradients (fp32), on the card and on their CPU copies:
                    the dequantised gradients and both residuals equal bit
                    for bit. (4) With deterministic algorithms, full width
                    and depth, bf16 weights, fp32 moments, remat, B=64 x 512
                    in 8 microbatches, ``make_train_step(...,
                    compress_grads=True)``: 3 steps held as phase 41 holds
                    its own (448 flash launches a step and nothing else, the
                    peak within 10% or 256 MiB of the compressed plan), then
                    the accumulation's adds and cast and one
                    ``ef_compress_tree``, each timed alone on the step's
                    gradients. (5) At 2 of 28 layers, B=16 x 512 in 2
                    microbatches, through ``launch.train.run``: 4 steps with
                    one sync save against 3 steps with async saves at 2
                    (still writing when step 3 ends) and 3, then a new run
                    to 4 with an async save: every leaf annex key of step 4
                    equal. Prints each step's ms, marked where a save was in
                    flight, each save's blocking time, and this process's
                    bytes written (/proc/self/io, its children's not
                    counted).
 44. checkpoint subdir — qwen3-0.6B at full width and depth, phase 5's
                    bf16 weights, saved by ``CheckpointManager(repo,
                    subdir="ckpt_alt")`` into a new repository: every path of
                    the commit under ``ckpt_alt/step_00000000/``, each leaf's
                    annex key phase 12's default-subdir save's. Restored 3
                    times by a manager with ``fetch_workers=1`` and 3 times
                    with 8, each bit for bit, and served from the last
                    restore through the port's prefill and decode at phase 5's
                    shape: the greedy tokens phase 5's, the flash kernel 28
                    times in the one prefill and nothing else. Prints the save
                    and each restore's seconds, the median and spread of each
                    width. Starts no job and no process.
Phases 3, 4 and 9 also run one backward through each kernel op
(``ops.flash_attention``, ``ops.rwkv6``, ``ops.mamba_scan``) at a small fp32
shape and hold its gradients against the plain version's autograd.
Each serve sets every kernel's count to 0 just before it serves and reads the
counts just after; each model's weights are freed before the next phase.
Then one JSON line with the kernels' numbers, the card's name and power
limit, and the final line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import atexit
import collections
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

# Phase 14's deterministic resume needs cuBLAS's fixed workspace; cuBLAS reads
# this once, when it starts, so it is set before torch is imported.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense; fp32 outside the tensor cores
FP32_TOL = 2e-5  # tests/test_kernels.py: fp32 kernel against its reference
BF16_TOL = 2e-2  # tests/test_kernels.py: bf16
STATE_TOL = {"float32": 1e-4, "bfloat16": 3e-3}  # tests/test_kernels.py:110-111: the WKV state
MAMBA_STATE_TOL = 1e-3  # tests/test_kernels.py:144-145: the Mamba state, fp32 and bf16
PARITY_TOL = 2e-3  # tests/test_pallas_model_parity.py: kernels on vs off, fp32 logits
QUEUE_AHEAD_CYCLES = 20_000_000  # ~10 ms of spinning at the H100's clocks

# (B, Sq, Sk, H, KV, Dh, causal, window): the serving shape, then tests/test_kernels.py:29-38.
SERVE_SHAPE = (8, 512, 512, 16, 8, 128, True, None)
JAMBA_ATTN_SHAPE = (8, 512, 512, 64, 8, 128, True, None)  # jamba's attention layer: GQA group 8
SEAMLESS_ENC_SHAPE = (8, 128, 128, 16, 16, 64, False, None)  # seamless-m4t's encoder: 128 frames
SEAMLESS_DEC_SHAPE = (8, 512, 512, 16, 16, 64, True, None)  # seamless-m4t's decoder
QWEN2_VL_SHAPE = (8, 512, 512, 28, 4, 128, True, None)  # qwen2-vl-7b: GQA group 7
MIXTRAL_SHAPE = (8, 512, 512, 48, 8, 128, True, 4096)  # mixtral-8x22b: GQA group 6, window 4096
MIXTRAL_LONG_SHAPE = (1, 8192, 8192, 48, 8, 128, True, 4096)  # its long prompt: the window binds
ARCTIC_SHAPE = (8, 512, 512, 56, 8, 128, True, None)  # arctic-480b: 56 heads, GQA group 7
PHI3_SHAPE = (8, 512, 512, 32, 32, 96, True, None)  # phi3-mini-3.8B: MHA, Dh 96
GRANITE_SHAPE = (8, 512, 512, 32, 8, 64, True, None)  # granite-3-2B: GQA group 4, Dh 64
INTERNLM2_SHAPE = (8, 512, 512, 48, 8, 128, True, None)  # internlm2-20B: GQA group 6, no window
NEW_SERVE_SHAPES = {"at_seamless_encoder_shape": SEAMLESS_ENC_SHAPE,
                    "at_seamless_decoder_shape": SEAMLESS_DEC_SHAPE,
                    "at_qwen2_vl_shape": QWEN2_VL_SHAPE,
                    "at_mixtral_shape": MIXTRAL_SHAPE,
                    "at_mixtral_long_shape": MIXTRAL_LONG_SHAPE,
                    "at_arctic_shape": ARCTIC_SHAPE,
                    "at_phi3_shape": PHI3_SHAPE,
                    "at_granite_shape": GRANITE_SHAPE,
                    "at_internlm2_shape": INTERNLM2_SHAPE}
TEST_SHAPES = [
    (2, 128, 128, 4, 4, 64, True, None),
    (1, 256, 256, 8, 2, 64, True, None),
    (2, 128, 128, 4, 1, 128, True, None),
    (1, 256, 256, 4, 4, 64, True, 64),
    (1, 128, 128, 2, 2, 96, False, None),
    (2, 64, 64, 4, 2, 32, True, 16),
]
# Ragged query and KV tiles (Sq != Sk; S=300 at jamba's GQA group of 8) and
# the serving length at Dh=64, whose tiles are one 128-byte-swizzled box wide.
EDGE_SHAPES = [
    (1, 100, 130, 4, 2, 16, False, None),
    (1, 300, 300, 8, 1, 128, True, None),
    (2, 512, 512, 8, 2, 64, True, None),
]
# (B, S, H, Dh): rwkv6-1.6B's serving shape, tests/test_kernels.py:94-95, ragged lengths
# (a zero-filled tail chunk, S=17 one step past a chunk), and Dh=96, whose bf16 blocks
# own 48 value columns each (three mma warps, two blocks a head).
RWKV_SERVE_SHAPE = (8, 512, 32, 64)
RWKV_SHAPES = [RWKV_SERVE_SHAPE, (2, 64, 2, 32), (1, 128, 4, 64), (1, 32, 1, 128), (2, 40, 4, 16),
               (2, 17, 4, 64), (1, 40, 2, 96)]
# (B, S, Di, St): jamba's serving shape, tests/test_kernels.py:130, a ragged length, and
# Di=200, no multiple of the 128-channel block.
MAMBA_SERVE_SHAPE = (8, 512, 16384, 16)
MAMBA_SHAPES = [MAMBA_SERVE_SHAPE, (2, 64, 64, 8), (1, 128, 256, 16), (2, 40, 96, 4), (1, 64, 200, 16)]
SERVE = dict(batch=8, prompt_len=512, gen=16)  # every serve phase (32 generated tokens before PR 25)
# phase 27: tests/test_dryrun_smoke.py's four cells, the two train_4k cells cut to 2 of qwen3's 28
# layers (tests/test_torch_dryrun.py plans all four at full depth)
DRYRUN_TRAIN_CUTS = {"n_layers": 2}
DRYRUN_CELLS = [("qwen3_0_6b", "train_4k", False, DRYRUN_TRAIN_CUTS), ("qwen3_0_6b", "decode_32k", False, None),
                ("rwkv6_1_6b", "long_500k", False, None), ("qwen3_0_6b", "train_4k", True, DRYRUN_TRAIN_CUTS)]
# phase 27: train steps whose query heads do not split over the mesh's 16 tp ranks (ROADMAP §C4),
# planned at full width with 1 layer, as tests/test_torch_dryrun.py plans them
DRYRUN_C4_CELLS = [("arctic_480b", "train_4k", False), ("qwen2_vl_7b", "train_4k", False)]
DRYRUN_C4_CUTS = {"n_layers": 1}
DRYRUN_HELD_CUTS = {"n_layers": 2}  # phase 27's plans held against runs: 2 of qwen3's 28 layers, for time
DRYRUN_PEAK_TOL, DRYRUN_PEAK_SLACK = 0.10, 256 << 20  # phase 27: predicted peak within 10% or 256 MiB
SHARDED_STEP_TOL = 2e-2  # phase 26: the FSDP step's loss and first moments against the unsharded one, relative
JAMBA = "jamba_1_5_large_398b"
JAMBA_CUTS = {"moe": None, "n_layers": 16}  # without experts, 16 of 72 layers fit the card
GRAD_TOL = 1e-5  # fp32: the backward recomputes through the plain version
CHUNKED_LEAF_BYTES = 64 << 20  # phase 13: one bf16 leaf
CHUNK_THRESHOLD = 1 << 20
CHANGED_SHARE = 0.03  # of the leaf's bytes, one contiguous run, between the two saves
TRAIN = dict(steps=8, batch=8, seq_len=512)  # phase 14's timed run (launch.train.run)
CAMPAIGN = dict(sim_jobs=4, steps=8)  # phase 28: shards committed in each phase; phase 1 trains to 4, phase 2 to 8
# phase 28 at full width, cut to 2 of qwen3's 28 layers (phase 14 trains and saves the full depth)
CAMPAIGN_CUTS = {"n_layers": 2}
SERVE_JOBS = 4  # phase 35: concurrent serving jobs, one local-cluster worker each
JOB_SERVE = dict(batch=8, prompt_len=64, gen=16)  # phase 35: what each job serves
# phase 35: one serving job, run by the local cluster in jobs/serve_<k>/ of a repository that
# holds a checkpoint commit; formatted with the commit, seed, device, full, overrides and shape
SERVE_JOB = """#!/bin/bash
# serve a checkpoint commit of this repository; keep the tokens, log the flash launches
python3 - <<'EOF'
import json
import time
t = [time.perf_counter()]
import numpy as np
import torch
t.append(time.perf_counter())
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.launch import serve
t.append(time.perf_counter())
torch.zeros(1, device="{device}")
t.append(time.perf_counter())
torch.use_deterministic_algorithms(True)
res = serve.run("qwen3_0_6b", repo="../..", commit="{commit}", seed={seed}, device="{device}", full={full},
                overrides={overrides!r}, **{shape!r})
t.append(time.perf_counter())
np.save("tokens.npy", res.tokens.cpu().numpy())
stages = dict(zip(("import torch", "serving imports", "device start", "serve.run"), np.diff(t).round(3).tolist()))
print(json.dumps(dict(prefills=res.prefills, flash_attention_fwd=flash_attention_fwd.launches, stages_s=stages)))
EOF
"""
PIPE = dict(batch=8, prompt_len=64, gen=16)  # phase 36: the prompts stage's batch, the tokens serve decodes
# phase 36's three stages, run by the local cluster in pipe/ (prompts, score) and pipe/serve/ (serve) of a
# repository that holds a checkpoint commit. PIPE_PROMPTS is formatted with the seed, the vocabulary and
# PIPE's shape; PIPE_SERVE with ``broken`` (a first line, or ""), the commit, device, full, overrides and gen.
PIPE_PROMPTS = """#!/bin/bash
# the pipeline's prompts: token ids from numpy's seeded generator, below the vocabulary
python3 - <<'EOF'
import numpy as np
np.save("prompts.npy", np.random.default_rng({seed}).integers(0, {vocab}, size=({batch}, {prompt_len})))
EOF
"""
PIPE_SERVE = """#!/bin/bash
# greedy-decode the pipeline's prompts from a checkpoint commit of this repository; keep the tokens, log the
# flash launches
{broken}python3 - <<'EOF'
import json
import time
t = [time.perf_counter()]
import numpy as np
import torch
t.append(time.perf_counter())
from repro_torch import configs
from repro_torch.core.repo import Repository
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.steps import greedy_token, make_decode_step, make_prefill_step
t.append(time.perf_counter())
dev = torch.device("{device}")
torch.zeros(1, device=dev)
t.append(time.perf_counter())
torch.use_deterministic_algorithms(True)
cfg = (configs.get if {full} else configs.get_smoke)("qwen3_0_6b").replace(**{overrides!r})
params = CheckpointManager(Repository("../.."))._restore("{commit}", dev, params_only=True)[0]["params"]
prompts = torch.from_numpy(np.load("../prompts.npy")).to(dev)
prefill = make_prefill_step(cfg, cache_len=prompts.shape[1] + {gen})
decode = make_decode_step(cfg)
caches, logits = prefill(params, dict(tokens=prompts))
tok = greedy_token(cfg, logits)
out = [tok]
for i in range({gen} - 1):
    logits, caches = decode(params, caches, tok, prompts.shape[1] + i)
    tok = greedy_token(cfg, logits)
    out.append(tok)
np.save("tokens.npy", torch.cat(out, dim=1).cpu().numpy())
t.append(time.perf_counter())
stages = dict(zip(("import torch", "serving imports", "device start", "restore and decode"),
                  np.diff(t).round(3).tolist()))
print(json.dumps(dict(prefills=1, flash_attention_fwd=flash_attention_fwd.launches, stages_s=stages,
                      end=time.time())))
EOF
"""
PIPE_SCORE = """#!/bin/bash
# score the served tokens: their sha256 and their counts by position
python3 - <<'EOF'
import hashlib
import json
import time
start = time.time()
import numpy as np
tokens = np.load("serve/tokens.npy")
counts = [dict((str(int(v)), int(c)) for v, c in zip(*np.unique(col, return_counts=True))) for col in tokens.T]
with open("score.json", "w") as f:
    json.dump(dict(sha256=hashlib.sha256(tokens.tobytes()).hexdigest(), shape=list(tokens.shape),
                   counts_by_position=counts), f, sort_keys=True)
print(json.dumps(dict(start=start)))
EOF
"""
TRAIN_LR = 1e-3  # the fixed-batch check: constant rate, AdamW's other defaults
TRAIN_PARITY_LAYERS = 2  # the fp32 kernel on/off train step of phases 14, 29, 41 and 42: 2 layers, full width
PREEMPT = (6, 3)  # the unbroken run's steps, and the step the other is cut at
# phase 14's resume check and phase 26's FSDP step and its checkpoint: 2 of qwen3's 28 layers
# at full width (phase 14's timed run trains and saves the full depth)
CUT_TRAIN_LAYERS = 2
SHARDED_GEN = 8  # phase 26: the first 8 of phase 5's 16 tokens, decoded into its 528-slot cache
SEAMLESS, QWEN2_VL = "seamless_m4t_large_v2", "qwen2_vl_7b"
QWEN2_VL_PARITY_LAYERS = 4  # phase 18: fp32 at full depth would be 30.5 GB of weights
VISION_GRID = 8  # phase 18: the 64 vision positions as an 8 x 8 grid
MIXTRAL = "mixtral_8x22b"
MIXTRAL_CUTS = {"n_layers": 8}  # 8 of 56 layers: 40.9 GB of bf16 weights; all 56 are 281 GB
LONG_SERVE = dict(batch=1, prompt_len=8192, gen=16)  # phase 20: past mixtral's 4096-token window
MIXTRAL_PARITY_LAYERS = 2  # phase 21: 21.6 GB of fp32 weights
# phase 21: the share of (token, slot) expert choices the free-running fp32 kernel-on prefill
# may route otherwise than kernel-off. Its attention differs from the plain path's by ~1e-6,
# so a choice flips only where two experts' probabilities lie that close; a faulty kernel
# reroutes a large share.
MAX_FP32_FLIPS = 0.01
ARCTIC = "arctic_480b"
ARCTIC_CUTS = {"n_layers": 1}  # 1 of 35 layers: 28.1 GB of bf16 weights, 56.3 GB in fp32 for phase 23
JAMBA_MOE_LAYERS = 8  # phases 24-25: one repeat of jamba's 8-layer pattern
JAMBA_MOE_EXPERTS = 8  # phase 24: 8 of 16 experts, 52.1 GB of bf16 weights; 16 are 90.7 GB
JAMBA_MOE_PARITY_EXPERTS = 4  # phase 25: 65.4 GB of fp32 weights
RECURRENT_TRAIN_STEPS = 3  # phases 29-30: step 1 warms up, p50 over steps 2-3
RWKV_TRAIN = dict(batch=8, seq_len=512)  # phase 29: rwkv6-1.6B at full width
# phase 29's depth: 8 of 24 layers since phases 41-42 came (each layer costs ~1.5 s over its 3 steps, almost all
# of it the WKV backward's loop), so that the run's total stays within its budget; PR 25 trained all 24
RWKV_TRAIN_CUTS = {"n_layers": 8}
# phase 30: one 8-layer repeat of jamba without experts (9.116 B parameters, bf16 moments): the
# largest batch whose planned peak leaves 4 GiB of the card free (launch/dryrun.py --one-card)
JAMBA_TRAIN_CUTS = {"moe": None, "n_layers": 8}
JAMBA_TRAIN = dict(batch=4, seq_len=512)
# phases 41-42: the token-only models served in phases 19 and 31-33, trained at full width (bf16 weights, fp32
# moments, remat) at B=8 x 512, each cut to the deepest whose one-card plan leaves FREE_GIB of the card free
# (launch/dryrun.py --one-card, meta tensors, torch 2.13 on the CPU; each run is held to the card's own plan)
TRAIN_CELLS = {
    "phi3_mini_3_8b": {},  # 32 of 32 layers: planned peak 48.717 GiB, 30.462 GiB free
    "granite_3_2b": {},  # 40 of 40 layers: 33.320 GiB, 45.858 GiB free
    "internlm2_20b": {"n_layers": 12},  # 12 of 48: 74.041 GiB, 5.138 GiB free (13 layers: 79.150, 0.028 free)
    MIXTRAL: {"n_layers": 2},  # 2 of 56: 72.470 GiB, 6.709 GiB free, set by the optimizer's state (B=4 the same)
}
CELL_TRAIN = dict(batch=8, seq_len=512)
# phase 43: qwen3-0.6B at full width and depth at a global batch that no single pass fits on one card, in 8
# microbatches of 8 with int8 error-feedback gradients. Planned peaks (launch/dryrun.py --one-card, meta tensors,
# torch 2.13 on the CPU): B=64 in one pass 109.528 GiB, 30.35 GiB past the card (its logits over 151,936 tokens);
# in 8 microbatches 21.881 GiB, with the compression 24.102 GiB (55.077 GiB free). Each run is held to the card's
# own plan of the compressed step.
ACCUM_TRAIN = dict(batch=64, seq_len=512)
ACCUM_CUTS = {"microbatches": 8}
# phase 43's runs at 2 layers, the fp32 checks and the resume: B=16 x 512 as 2 microbatches of 8 (the resume first
# ran at B=64 in 8, over the run's time budget; its time is its four 1.87 GB saves, hardly its steps)
ACCUM_SMALL = dict(batch=16, microbatches=2)
MICROBATCH_LOSS_TOL, MICROBATCH_PARAM_TOL = 2e-3, 5e-3  # tests/test_microbatch.py: loss, params rtol and atol
# phase 43's resume at CUT_TRAIN_LAYERS through launch.train.run, each run's segments as (steps, ckpt_every,
# async_ckpt): the preempted run saves at step 2 (in flight during step 3), at 3 and at 4
ACCUM_RESUME = {"unbroken": [(4, 4, False)], "preempted": [(3, 2, True), (4, 4, True)]}
JAMBA_GRAD_SHAPE = (1, 512, 16384, 16)  # phase 30: the Mamba op's chunked backward at jamba's width
DENSE = ["phi3_mini_3_8b", "granite_3_2b", "internlm2_20b"]  # phases 31-33, full width and depth
# phase 39: examples/train_campaign_torch.py's modelled metadata operations and seconds on the CPU
# (tests/test_torch_examples.py holds a CPU run to them; the bytes of its commits vary by a few with their times)
CAMPAIGN_EXAMPLE = {"meta_ops": 1482, "modelled_s": 3.0070233333333225}
CACHE_GEN = dict(batch=8, prompt_len=64, gen=32)  # phase 39: examples/serve_batched_torch.py's defaults
DENSE_PARITY_LAYERS = 2  # phase 34: each of the three at full width, 2 layers
# phase 40: bench_ingest's 8 jobs x 8 files, each file cut from 64 to 16 MiB (1 GiB of outputs a case)
DATAPLANE = dict(n_jobs=8, files=8, mib=16)
CKPT_SUBDIR = "ckpt_alt"  # phase 44: where its checkpoint's steps live
RESTORE_WIDTHS = (1, 8)  # phase 44: each restore's fetch_workers
RESTORE_REPEATS = 3
DATAPLANE_CASES = {"a legacy": (dict(data_plane="legacy"), 0), "b fused": ({}, 0), "c fused, 8 workers": ({}, 8),
                   "d full": (dict(engine="full"), 0)}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str) -> float:
    print(f"== {name}", flush=True)
    return time.perf_counter()


def time_ms(torch, fn, iters: int = 50, warmup: int = 5, queue_ahead: bool = True) -> float:
    """Mean time of one call, from CUDA events around ``iters`` calls. With
    ``queue_ahead`` the stream first spins for ~10 ms, so that the host
    queues the calls while the device waits and the events time the device
    alone; without it the calls run as fast as the host issues them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queue_ahead:
        torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype_name: str) -> tuple[float, str]:
    """(least ms on an H100, what sets it): bytes over the memory rate against
    operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def attention_flops(shape) -> int:
    """4 * Dh flops per unmasked (row, col) pair per head: q k^T and p v (the
    exponentials are not counted); ``kernels/costs.py``, the kernel op's
    FLOP formula."""
    from repro_torch.kernels import costs

    b, sq, sk, h, kv, d, causal, window = shape
    return costs.attention_flops(b, sq, sk, h, d, causal, window)


def attention_bound_ms(shape, dtype_name: str, elem_bytes: int) -> tuple[float, str]:
    """Least time for causal GQA attention on an H100: each of q, k, v read
    once and o written once, against ``attention_flops``."""
    from repro_torch.kernels import costs

    return bound(costs.attention_bytes(*shape[:6], elem_bytes), attention_flops(shape), dtype_name)


def rwkv6_bound_ms(r, u, state0) -> tuple[float, str]:
    """Least time for the WKV recurrence on an H100: r, k, v, logw, u and
    state0 read once, out and the final state written once, against the TPU
    kernel's four products (``costs.rwkv6_flops``). The products run on the
    tensor cores, so they count at the rate of r's type there (bf16 989
    TFLOP/s); fp32 has none but the CUDA cores'."""
    from repro_torch.kernels import costs

    nbytes = costs.rwkv6_bytes(*r.shape, r.element_size(), u.element_size(), state0 is not None)
    return bound(nbytes, costs.rwkv6_flops(*r.shape), str(r.dtype).removeprefix("torch."))


def rwkv6_products_fp32_ms(r) -> float:
    """The TPU kernel's four products at the CUDA cores' fp32 rate (the bound
    this script used before the bf16 kernel moved them to the tensor cores)."""
    from repro_torch.kernels import costs

    return costs.rwkv6_flops(*r.shape) / H100_FLOPS["float32"] * 1e3


def mamba_bound_ms(u, A, B_) -> tuple[float, str]:
    """Least time for the selective scan from a zero state on an H100: u,
    dt, B, C and A read once, y and the final h written once, against 6 fp32
    operations per state update (``costs.mamba_flops``) at the fp32 rate of
    the CUDA cores."""
    from repro_torch.kernels import costs

    b, s, di = u.shape
    st = A.shape[1]
    return bound(costs.mamba_bytes(b, s, di, st, u.element_size(), False), costs.mamba_flops(b, s, di, st),
                 "float32")


def ptxas_report(log: str, dim: str) -> list[str]:
    """'<dtype> <dim>=<d>: <n> registers[, <b> B spilled]' per kernel
    instantiation in nvcc's -Xptxas -v report; ``dim`` names the template's
    integer parameter. The bf16 instances of the redesigned kernels read
    'bf16 wgmma' (flash), 'bf16 mma' (WKV) and 'bf16 exp2' (Mamba)."""
    out, inst, spilled = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"kernelI(.*?)E+v", ln)
            inst = m.group(1).replace("13__nv_bfloat16", "bf16 ").replace("Li", f"{dim}=") if m else ln
            inst = "fp32 " + inst[1:] if inst.startswith(f"f{dim}=") else inst
            for kernel, label in (("wgmma_kernel", "wgmma"), ("chunk_kernel", "mma"), ("bf16_kernel", "exp2")):
                inst = f"bf16 {label} " + inst if kernel in ln else inst
            spilled = ""
        elif inst and "bytes spill stores" in ln:
            n = int(ln.split(" bytes spill stores")[0].split(",")[-1])
            spilled = f", {n} B spilled" if n else ""
        elif inst and "Used " in ln:
            out.append(f"{inst}: {ln.split('Used ')[1].split(' registers')[0]} registers{spilled}")
            inst = None
    return out


def bf16_step(torch, x):
    """The spacing of bf16 values at each |x| (x >= 0, in fp32): 2^(e - 8)
    for x in [2^(e-1), 2^e), bf16 keeping 8 significant bits."""
    return torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 8)


def check_close(torch, name: str, got, want, tol: float) -> float:
    """Max abs error; fails unless |got - want| <= tol + tol |want| everywhere."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    if not bool(((got - want).abs() <= tol + tol * want.abs()).all()):
        fail(f"{name}: max_abs_err {err:.3g} above tol {tol}")
    return err


def cast_tree_(tree: dict, dtype) -> None:
    """Casts every tensor of the nested parameter dict to ``dtype`` in place,
    leaf by leaf: each old leaf is freed as its copy is made, so the two
    trees are never whole at once."""
    for k, v in tree.items():
        if isinstance(v, dict):
            cast_tree_(v, dtype)
        else:
            tree[k] = v.to(dtype)


def bf16_check(torch, make_prefill_step, name: str, cfg32, cache_len: int, params: dict, batch: dict,
               l_off, counts: dict) -> None:
    """bf16 prefill of ``batch`` on ``params``, cast to bf16 in place, kernels
    on against off: the last logits may differ by at most twice the bf16
    plain path's own error against the fp32 plain path's ``l_off``.
    ``counts`` maps each kernel's wrapper to the launches the kernel-on
    prefill must make."""
    cast_tree_(params, torch.bfloat16)
    _, l16_off = make_prefill_step(cfg32, cache_len)(params, batch)
    for counter in counts:
        counter.launches = 0
    _, l16_on = make_prefill_step(cfg32.replace(use_pallas="on"), cache_len)(params, batch)
    torch.cuda.synchronize()
    for counter, want in counts.items():
        if counter.launches != want:
            fail(f"bf16 kernel-on {name} prefill launched {counter.__name__} {counter.launches} times, "
                 f"expected {want}")
    err_kernel = (l16_on.float() - l16_off.float()).abs().max().item()
    err_bf16 = (l16_off.float() - l_off.float()).abs().max().item()
    b, s = batch["tokens"].shape
    print(f"parity {name} bf16 B={b} prompt={s}: last logits kernel on vs off "
          f"max_abs_err {err_kernel:.4g}; bf16 off vs fp32 off {err_bf16:.4g} (bar: twice that, "
          f"{2 * err_bf16:.4g}; ratio {err_kernel / err_bf16:.3f})")
    if not bool(torch.isfinite(l16_on.float()).all()):
        fail(f"bf16 kernel-on {name} prefill logits are not finite")
    if not err_kernel <= 2 * err_bf16:
        fail(f"bf16 kernel-on {name} prefill logits differ from kernel-off by more than twice bf16's own error")


def prefill_parity(torch, make_prefill_step, name: str, cfg32, cache_len: int, params: dict, batch: dict,
                   counter, launches: int):
    """fp32 prefill of ``batch``, kernels on against off: the last logits
    and every layer's every cache within PARITY_TOL; the kernel-on prefill
    must launch ``counter`` ``launches`` times. Returns the off logits."""
    c_off, l_off = make_prefill_step(cfg32, cache_len)(params, batch)
    counter.launches = 0
    c_on, l_on = make_prefill_step(cfg32.replace(use_pallas="on"), cache_len)(params, batch)
    torch.cuda.synchronize()
    if counter.launches != launches:
        fail(f"kernel-on {name} prefill launched {counter.__name__} {counter.launches} times, expected {launches}")
    logit_err = (l_on - l_off).abs().max().item()
    cache_err = {n: (c_on[key][n] - c_off[key][n]).abs().max().item() for key in c_off for n in c_off[key]}
    print(f"parity {name} fp32 {cfg32.n_layers} layers B={batch['tokens'].shape[0]} "
          f"prompt={batch['tokens'].shape[1]}: last logits max_abs_err {logit_err:.3g}, caches over the layers: "
          + ", ".join(f"{n} {e:.3g}" for n, e in cache_err.items()) + f" (tol {PARITY_TOL}); "
          f"{counter.__name__} launched {counter.launches} times")
    if not bool(torch.isfinite(l_on).all()):
        fail(f"kernel-on {name} prefill logits are not finite")
    if not torch.allclose(l_on, l_off, rtol=PARITY_TOL, atol=PARITY_TOL):
        fail(f"kernel-on {name} prefill logits disagree with kernel-off")
    for key in c_off:
        for n in c_off[key]:
            if not torch.allclose(c_on[key][n], c_off[key][n], rtol=PARITY_TOL, atol=PARITY_TOL):
                fail(f"kernel-on {name} prefill {key}/{n} disagrees with kernel-off")
    return l_off


def mrope_positions(torch, batch: int, seq: int, n_vision: int, grid: int, dev):
    """[3, B, S] M-RoPE streams as Qwen2-VL lays out one image and its text:
    over the first ``n_vision`` positions t = 0 and (h, w) walk a grid of
    ``grid`` columns; the text after them counts on from the grid's largest
    position plus one on all three streams."""
    i = torch.arange(n_vision, device=dev)
    vision = torch.stack([torch.zeros_like(i), i // grid, i % grid])
    start = int(vision.max()) + 1
    text = torch.arange(start, start + seq - n_vision, device=dev).expand(3, -1)
    return torch.cat([vision, text], dim=1).to(torch.int32)[:, None, :].expand(3, batch, seq).contiguous()


@contextmanager
def routing(torch, moe, pinned: list | None = None):
    """Within the block, which holds one forward (with its backward, if
    any), each MoE layer appends the expert indices [B, S, k] it routes by
    in its forward to the list this yields, in layer order. A layer is known
    by its router weight's storage, so a call on a router already seen is
    that layer's recompute (remat): it takes the layer's pin again and adds
    no route. With ``pinned`` (such routes from
    another run) layer n routes by ``pinned[n]`` in place of its own: its
    gates are its own probabilities at those experts, renormalised, and its
    aux loss counts the pinned top-1 assignment. That is ``router_topk``'s
    arithmetic with the experts given, so a layer pinned to its own routes
    computes what it computes unpinned, bit for bit, gradients included:
    the discrete choice is held fixed, and the layer stays continuous in its
    inputs and its router's weights."""
    routes, original, layer_of = [], moe.router_topk, {}

    def router_topk(x, w_router, cfg):
        n = layer_of.setdefault(w_router.data_ptr(), len(layer_of))
        if pinned is None:
            gates, idx, aux = original(x, w_router, cfg)
        else:
            probs = torch.softmax(torch.einsum("bsd,de->bse", x.float(), w_router.float()), dim=-1)
            idx = pinned[n]
            gates = probs.gather(-1, idx)
            gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
            e = w_router.shape[-1]
            assign = torch.nn.functional.one_hot(idx[..., 0], e).float()
            aux = e * torch.sum(assign.mean(dim=(0, 1)) * probs.mean(dim=(0, 1)))
        if n == len(routes):
            routes.append(idx)
        return gates, idx, aux

    moe.router_topk = router_topk
    try:
        yield routes
    finally:
        moe.router_topk = original


def slot_fill(torch, routes: list, moe_cfg) -> tuple[float, list[int]]:
    """(share of the expert GEMMs' [E, B, C] slots that the capacity queue
    fills, over all the layers' routes; the (token, slot) choices each
    layer's queue drops). A batch row's expert keeps min(its choices, C)."""
    filled = slots = 0
    dropped = []
    for idx in routes:
        b, s, k = idx.shape
        e = moe_cfg.n_experts
        c = max(1, int(moe_cfg.capacity_factor * s * k / e))
        kept = torch.nn.functional.one_hot(idx.reshape(b, s * k), e).sum(dim=1).clamp(max=c).sum().item()
        filled, slots = filled + kept, slots + e * b * c
        dropped.append(b * s * k - kept)
    return filled / slots, dropped


def flip_share(routes: list, other: list) -> float:
    """Share of (token, slot) expert choices that differ between two runs' routes."""
    return sum(int((a != b).sum()) for a, b in zip(routes, other)) / sum(a.numel() for a in routes)


def moe_parity(torch, moe, make_prefill_step, name: str, depth: str, cfg32, cache_len: int, params: dict,
               batch: dict, counts: dict, cache_names: set) -> None:
    """fp32 prefill of ``batch`` for a model with MoE layers, kernels on
    against off. Routing is discrete, so: the free-running kernel-on run may
    route at most MAX_FP32_FLIPS of the (token, slot) choices otherwise, and
    with every MoE layer routed to the kernel-off run's experts the last
    logits and every layer's caches (``cache_names``) must agree within
    PARITY_TOL. Then ``params`` is cast to bf16 in place and, routed the
    same way, the bf16 kernel-on logits must stay within twice the bf16
    plain path's error against fp32, and the free-running bf16 kernel-on run
    may reroute at most twice the choices bf16 itself reroutes against
    fp32. ``counts`` maps each kernel's wrapper to its launches per
    kernel-on prefill (none with the kernels off)."""
    on32 = cfg32.replace(use_pallas="on")

    def run(c, weights, pinned=None):
        for counter in counts:
            counter.launches = 0
        with routing(torch, moe, pinned) as routes:
            caches, logits = make_prefill_step(c, cache_len)(weights, batch)
        torch.cuda.synchronize()
        for counter, want in counts.items():
            want = want if c.use_pallas == "on" else 0
            if counter.launches != want:
                fail(f"{name} prefill with use_pallas={c.use_pallas} launched {counter.__name__} "
                     f"{counter.launches} times, expected {want}")
        if not bool(torch.isfinite(logits).all()):
            fail(f"{name} prefill with use_pallas={c.use_pallas} gave logits that are not finite")
        return caches, logits, routes

    c_off, l_off, r_off = run(cfg32, params)
    _, l_free, r_on = run(on32, params)
    c_on, l_on, _ = run(on32, params, pinned=r_off)
    flips32 = flip_share(r_on, r_off)
    logit_err = (l_on - l_off).abs().max().item()
    cache_err: dict[str, float] = {}
    for key in c_off:
        for n in c_off[key]:
            cache_err[n] = max(cache_err.get(n, 0.0), (c_on[key][n] - c_off[key][n]).abs().max().item())
            if not torch.allclose(c_on[key][n], c_off[key][n], rtol=PARITY_TOL, atol=PARITY_TOL):
                fail(f"kernel-on {name} prefill {key}/{n} disagrees with kernel-off")
    b, s = batch["tokens"].shape
    print(f"parity {name} fp32 {depth} B={b} prompt={s}: free-running kernel on vs off routes {flips32:.4%} of "
          f"{sum(r.numel() for r in r_off)} (token, slot) choices otherwise (bar {MAX_FP32_FLIPS:.0%}), last "
          f"logits max_abs_err {(l_free - l_off).abs().max().item():.3g}; routed as kernel-off: last logits "
          f"max_abs_err {logit_err:.3g}, over the layers "
          + ", ".join(f"{n} {e:.3g}" for n, e in cache_err.items()) + f" (tol {PARITY_TOL}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if set(cache_err) != cache_names:
        fail(f"{name} prefill caches hold {sorted(cache_err)}, expected {sorted(cache_names)}")
    if not flips32 <= MAX_FP32_FLIPS:
        fail(f"the fp32 kernel-on {name} prefill routes {flips32:.2%} of its choices otherwise than kernel-off")
    if not torch.allclose(l_on, l_off, rtol=PARITY_TOL, atol=PARITY_TOL):
        fail(f"kernel-on {name} prefill logits disagree with kernel-off under the same routing")
    del c_off, c_on

    cast_tree_(params, torch.bfloat16)
    _, l16_off_free, r16_off = run(cfg32, params)
    _, l16_on_free, r16_on = run(on32, params)
    _, l16_off, _ = run(cfg32, params, pinned=r_off)
    _, l16_on, _ = run(on32, params, pinned=r_off)
    flips_bf16, flips_kernel16 = flip_share(r16_off, r_off), flip_share(r16_on, r16_off)
    err_kernel = (l16_on.float() - l16_off.float()).abs().max().item()
    err_bf16 = (l16_off.float() - l_off.float()).abs().max().item()
    print(f"parity {name} bf16 {depth} B={b} prompt={s}: free-running, bf16 off vs fp32 off routes "
          f"{flips_bf16:.4%} of the choices otherwise and bf16 on vs off {flips_kernel16:.4%} (bar: twice the "
          f"former), last logits on vs off max_abs_err "
          f"{(l16_on_free.float() - l16_off_free.float()).abs().max().item():.4g}; routed as fp32 kernel-off: last "
          f"logits kernel on vs off max_abs_err {err_kernel:.4g}, bf16 off vs fp32 off {err_bf16:.4g} (bar: twice "
          f"that, {2 * err_bf16:.4g}; ratio {err_kernel / err_bf16:.3f})")
    if not flips_kernel16 <= 2 * flips_bf16:
        fail(f"the bf16 kernel-on {name} prefill reroutes more than twice the choices bf16 itself does")
    if not err_kernel <= 2 * err_bf16:
        fail(f"bf16 kernel-on {name} prefill logits differ from kernel-off by more than twice bf16's own error")


def grad_check(torch, name: str, op, plain, args: list, n_diff: int) -> float:
    """One backward through the kernel op ``op`` on the card against the
    plain version's own autograd, for a random weighting of every output:
    each output must carry a grad_fn and the gradients of the first
    ``n_diff`` arguments agree within GRAD_TOL. Returns the max abs error."""
    grads = []
    for fn in (op, plain):
        leaves = [a.detach().clone().requires_grad_() for a in args[:n_diff]]
        outs = fn(*leaves, *args[n_diff:])
        outs = outs if isinstance(outs, tuple) else (outs,)
        if any(o.grad_fn is None for o in outs):
            fail(f"{name}: an output of {fn.__name__} on the card carries no grad_fn")
        gen = torch.Generator(device=outs[0].device).manual_seed(1)
        sum((o * torch.randn(o.shape, generator=gen, device=o.device)).sum() for o in outs).backward()
        grads.append([x.grad for x in leaves])
    torch.cuda.synchronize()
    err = max(check_close(torch, f"{name} gradient {i}", g, w, GRAD_TOL)
              for i, (g, w) in enumerate(zip(*grads)))
    print(f"  {name} backward (through the plain version) against the plain version's autograd, "
          f"fp32 {tuple(args[0].shape)}: max_abs_err {err:.3g} over {n_diff} inputs (tol {GRAD_TOL}) ok")
    return err


@contextmanager
def expandable_segments(torch):
    """Within the block the caching allocator's new segments grow in place
    (PyTorch's ``expandable_segments``). Phases 41-42 train within 5-7 GiB
    of the card's memory, and in fixed segments internlm2's first step found
    the free blocks too split to hold its 4.5 GiB fp32 copy of one gradient
    leaf. Set for those phases alone: the phases that free and take back
    tens of GiB ran slower with it."""
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        yield
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")


@contextmanager
def deterministic(torch):
    """PyTorch's deterministic algorithms on, then off again."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def train_parity(torch, make_grad_fn, name: str, cfg32, params: dict, batch: dict, launches: dict,
                 moe=None) -> None:
    """One fp32 gradient step of ``cfg32`` on ``params``, kernels off against
    on: the loss and each gradient leaf (max |on - off| / max |off|) within
    PARITY_TOL; the kernel-on step must launch each wrapper of ``launches``
    as often as it says, the kernel-off step none. With ``moe`` (the MoE
    module) routing is discrete, as in ``moe_parity``: a free-running
    kernel-on step may route at most MAX_FP32_FLIPS of the (token, slot)
    choices otherwise than kernel-off, and the kernel-on step held to the
    tolerance routes every MoE layer, forward and recompute, by the
    kernel-off step's experts. Gradients in bf16 (the mean that microbatch
    accumulation casts, ``cfg32.microbatches > 1``) may also differ by one
    bf16 step of an element, where the two fp32 sums round to neighbouring
    bf16 values. Returns the kernel-on step's gradients."""
    def step(use_pallas, pinned=None):
        for counter in launches:
            counter.launches = 0
        with routing(torch, moe, pinned) if moe else nullcontext([]) as routes:
            out = make_grad_fn(cfg32.replace(use_pallas=use_pallas))(params, batch)
        torch.cuda.synchronize()
        got = {c.__name__: c.launches for c in launches}
        want = {c.__name__: n if use_pallas == "on" else 0 for c, n in launches.items()}
        if got != want:
            fail(f"the fp32 {name} train step with use_pallas={use_pallas} launched {got}, expected {want}")
        return out, routes

    (loss_off, aux_off, g_off), r_off = step("off")
    routed = ""
    if moe:
        (_, _, g_free), r_free = step("on")
        del g_free
        flips = flip_share(r_free, r_off)
        (loss_on, aux_on, g_on), _ = step("on", pinned=r_off)
        routed = (f"free-running kernel on vs off routes {flips:.4%} of {sum(r.numel() for r in r_off)} (token, "
                  f"slot) choices otherwise (bar {MAX_FP32_FLIPS:.0%}); routed as kernel-off: aux loss on vs off "
                  f"relative {abs(aux_on.item() - aux_off.item()) / abs(aux_off.item()):.3g}, ")
    else:
        (loss_on, _, g_on), _ = step("on")
    loss_err = abs(loss_on.item() - loss_off.item()) / abs(loss_off.item())
    grad_err, past, beyond = {}, 0, 0
    for (p, g), (_, g_on_p) in zip(leaves(g_off), leaves(g_on)):
        grad_err[p] = ((g_on_p.float() - g).abs().max() / g.abs().max()).item()
        if g.dtype == torch.bfloat16:
            on, off = g_on_p.float(), g.float()
            diff, bar = (on - off).abs(), PARITY_TOL * off.abs().max()
            over = diff > bar
            past += int(over.sum())
            beyond += int((diff[over] > bar + bf16_step(torch, torch.maximum(on.abs(), off.abs())[over])).sum())
            del on, off, diff, over
        elif grad_err[p] > PARITY_TOL:
            beyond += 1
    worst = max(grad_err, key=grad_err.get)
    b, s = batch["tokens"].shape
    mb = f" in {cfg32.microbatches} microbatches" if cfg32.microbatches > 1 else ""
    cast = (f"; {past} elements past {PARITY_TOL} of their leaf's largest, {beyond} of them by more than one bf16 "
            f"step (the accumulation's cast)" if next(leaves(g_off))[1].dtype == torch.bfloat16 else "")
    print(f"train parity {name} fp32, {cfg32.n_layers} layers, B={b} x {s}{mb}: {routed}loss kernel on vs off "
          f"relative {loss_err:.3g}; gradients max |on - off| / max |off| per leaf {grad_err[worst]:.3g} ({worst}) "
          f"over {len(grad_err)} leaves (tol {PARITY_TOL}){cast}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if moe and not flips <= MAX_FP32_FLIPS:
        fail(f"the fp32 kernel-on {name} train step routes {flips:.2%} of its choices otherwise than kernel-off")
    if not loss_err <= PARITY_TOL or beyond:
        fail(f"the kernel-on {name} train step disagrees with kernel-off")
    return g_on


def timed_steps(torch, step_fn, params, opt_state, batch, dev, kernels: dict, n: int):
    """``n`` steps of ``step_fn`` on one batch, each on the host clock ending
    in a synchronise, every kernel's count set to 0 just before. Returns
    (params, opt_state, losses, aux losses, step ms, launches by wrapper)."""
    for counter in kernels.values():
        counter.launches = 0
    losses, auxes, step_ms = [], [], []
    for _ in range(n):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        torch.cuda.synchronize(dev)
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(metrics["loss"]))
        auxes.append(float(metrics["aux_loss"]))
    return params, opt_state, losses, auxes, step_ms, {c.__name__: c.launches for c in kernels.values()}


def leaves(tree: dict, prefix: str = ""):
    """(path, tensor) of every leaf of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def check_bit_equal(torch, name: str, got: dict, want: dict, dev) -> None:
    """Fails unless ``got`` holds the same paths as ``want``, each on ``dev``
    with the same dtype, shape and bits."""
    if sorted(got) != sorted(want):
        fail(f"{name}: leaves {sorted(set(got) ^ set(want))} differ")
    for p, w in want.items():
        g = got[p]
        if g.device != dev or g.dtype != w.dtype or g.shape != w.shape:
            fail(f"{name}: {p} is {g.dtype} {tuple(g.shape)} on {g.device}, saved {w.dtype} {tuple(w.shape)}")
        bits = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[w.element_size()]
        if not torch.equal(g.view(bits), w.view(bits)):
            fail(f"{name}: {p} differs from what was saved")


def serve_phase(torch, serve, configs, arch: str, kernels: dict, dev, seed: int,
                overrides: dict | None = None, repo: str | None = None, shape: dict = SERVE,
                commit: str | None = None):
    """Serve at full width (with the config ``overrides``; from the
    checkpoint ``commit``, default the newest, in ``repo`` if given) at
    ``shape`` (batch, prompt_len, gen)
    with every kernel's count set to 0 just
    before and read just after. ``kernels`` maps a mixer kind to the wrapper
    of its kernel; fails unless each launched once per layer of its kind per
    prefill (an encoder's layers are attention layers), and none launched for
    a kind the model lacks. Returns (cfg,
    result, {wrapper name: launches})."""
    cfg = configs.get(arch).replace(**(overrides or {}))
    for counter in kernels.values():
        counter.launches = 0
    res = serve.run(arch, full=True, device=dev, dtype="bfloat16", seed=seed,
                    overrides=overrides, repo=repo, commit=commit, **shape)
    launches = {counter.__name__: counter.launches for counter in kernels.values()}

    def show(v):
        return getattr(v, "n_experts", v) if v is not None else 0

    cuts = "".join(f", {'experts' if k == 'moe' else k} {show(getattr(configs.get(arch), k))} -> {show(v)}"
                   for k, v in (overrides or {}).items())
    source = f" from checkpoint step {res.checkpoint_step}" if repo else ""
    print(f"serve {arch}{cuts}{source} bf16 B={shape['batch']} prompt={shape['prompt_len']} gen={shape['gen']}: "
          f"prefill {res.prefill_ms:.2f} ms, "
          f"decode p50 {res.decode_p50_ms:.3f} ms p95 {res.decode_p95_ms:.3f} ms, "
          f"{res.tokens_per_s:.1f} tok/s, peak memory {res.peak_memory_bytes / 2**30:.3f} GiB, "
          f"launches over {res.prefills} prefills (warm-up included): {launches}")
    for mixer, counter in kernels.items():
        per_prefill = cfg.n_repeats * sum(kind.mixer == mixer for kind in cfg.pattern)
        per_prefill += cfg.n_enc_layers if cfg.enc_dec and mixer == "attn" else 0
        if launches[counter.__name__] != per_prefill * res.prefills:
            fail(f"{counter.__name__} launched {launches[counter.__name__]} times, expected "
                 f"{per_prefill} per prefill ({mixer} layers)")
    if not any(launches.values()):
        fail(f"serving {arch} launched no kernel")
    if res.tokens.shape != (shape["batch"], shape["gen"]):
        fail(f"tokens of shape {tuple(res.tokens.shape)}, expected {(shape['batch'], shape['gen'])}")
    if not (0 <= int(res.tokens.min()) and int(res.tokens.max()) < cfg.vocab_size):
        fail("a generated token lies outside [0, vocab_size)")
    if not res.logits_finite:
        fail("non-finite logits while serving")
    return cfg, res, launches


def sharded_phase(torch, np, configs, T, kernels: dict, dev, seed: int, qwen_res):
    """Phase 26 (see the module docstring). Returns (serving launches by
    wrapper, prefills run, train-step launches by wrapper, the seq-placed
    cache's serving launches, over one prefill)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.repo import Repository
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.distributed.sharding import P, placements, rules_for
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models.params import init_params, param_shardings
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.steps import greedy_token, make_decode_step, make_prefill_step, make_train_step

    def counts():
        return {c.__name__: c.launches for c in kernels.values()}

    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    with tempfile.TemporaryDirectory() as pg_dir:
        dist.init_process_group("nccl", init_method=f"file://{pg_dir}/store", rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
            cfg = configs.get("qwen3_0_6b")
            rules = rules_for(cfg, mesh)
            print(f"mesh {mesh}; rules dp={rules.dp} tp={rules.tp} seq_shard_residual={rules.seq_shard_residual} "
                  f"kv_shard={rules.kv_shard} expert_axis={rules.expert_axis} fsdp={rules.fsdp}")
            b, s, gen = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"]
            params = init_params(T.param_defs(cfg, rules), seed=seed, dtype=torch.bfloat16, device=dev, rules=rules)
            batch = prompt_batch(cfg, b, s, seed, dev)
            prefill = make_prefill_step(cfg, s + gen, rules=rules)
            decode = make_decode_step(cfg, rules=rules)
            for c in kernels.values():
                c.launches = 0
            caches, logits = prefill(params, batch)  # warm-up, as serve.run
            decode(params, caches, greedy_token(cfg, logits), s)
            del caches, logits
            torch.cuda.synchronize()
            t = time.perf_counter()
            caches, logits = prefill(params, batch)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t) * 1e3
            kv = caches["p0"]["k"]
            tok = greedy_token(cfg, logits)
            toks, lat = [full(tok)], []
            for i in range(SHARDED_GEN - 1):
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits, caches = decode(params, caches, tok, s + i)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t) * 1e3)
                tok = greedy_token(cfg, logits)
                toks.append(full(tok))
            launches = counts()
            tokens = torch.cat(toks, dim=1).cpu()
            p50, p95 = float(np.percentile(lat, 50)), float(np.percentile(lat, 95))
            print(f"sharded serve qwen3_0_6b bf16 B={b} prompt={s} gen={SHARDED_GEN} of {gen} on the (1, 1) mesh: "
                  f"prefill "
                  f"{prefill_ms:.2f} ms (phase 5: {qwen_res.prefill_ms:.2f} ms), decode p50 {p50:.3f} ms p95 "
                  f"{p95:.3f} ms (phase 5: {qwen_res.decode_p50_ms:.3f} / {qwen_res.decode_p95_ms:.3f} ms); "
                  f"k cache {type(kv).__name__} {tuple(kv.shape)} placed {tuple(kv.placements)}; launches over 2 "
                  f"prefills (warm-up included): {launches}")
            if launches["flash_attention_fwd"] != 2 * cfg.n_layers or any(
                    n for name, n in launches.items() if name != "flash_attention_fwd"):
                fail(f"sharded serving launched {launches}, expected flash_attention_fwd {cfg.n_layers} times "
                     "per prefill and nothing else")
            if type(kv).__name__ != "DTensor" or type(logits).__name__ != "DTensor":
                fail("sharded serving returned plain tensors")
            want = qwen_res.tokens[:, :SHARDED_GEN]
            if not torch.equal(tokens, want):
                fail(f"sharded greedy tokens differ from phase 5's in {int((tokens != want).sum())} "
                     f"of {tokens.numel()} places")
            print(f"sharded greedy tokens equal phase 5's first {SHARDED_GEN} ({tuple(tokens.shape)})")

            # the same prompts from a KV cache placed with its slots over tp
            del caches, logits, kv
            seq_cfg = cfg.replace(decode_kv_shard="seq")
            seq_rules = rules_for(seq_cfg, mesh)
            seq_decode = make_decode_step(seq_cfg, rules=seq_rules)
            for c in kernels.values():
                c.launches = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            caches, logits = make_prefill_step(seq_cfg, s + gen, rules=seq_rules)(params, batch)
            torch.cuda.synchronize()
            seq_prefill_ms = (time.perf_counter() - t) * 1e3
            kv = caches["p0"]["k"]
            tok = greedy_token(cfg, logits)
            toks, seq_lat = [full(tok)], []
            for i in range(SHARDED_GEN - 1):
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits, caches = seq_decode(params, caches, tok, s + i)
                torch.cuda.synchronize()
                seq_lat.append((time.perf_counter() - t) * 1e3)
                tok = greedy_token(cfg, logits)
                toks.append(full(tok))
            seq_launches = counts()
            seq_tokens = torch.cat(toks, dim=1).cpu()
            print(f"sharded serve qwen3_0_6b, KV cache slots over tp (kv_shard={seq_rules.kv_shard}), bf16 B={b} "
                  f"prompt={s} gen={SHARDED_GEN} on the (1, 1) mesh: prefill {seq_prefill_ms:.2f} ms (no warm-up), "
                  f"decode p50 {float(np.percentile(seq_lat, 50)):.3f} ms p95 {float(np.percentile(seq_lat, 95)):.3f} "
                  f"ms (no warm-up; head_dim over tp: {p50:.3f} / {p95:.3f} ms); k cache "
                  f"{tuple(kv.shape)} placed {tuple(kv.placements)}; launches over 1 prefill: {seq_launches}")
            if seq_launches["flash_attention_fwd"] != cfg.n_layers or any(
                    n for name, n in seq_launches.items() if name != "flash_attention_fwd"):
                fail(f"the seq-placed serving launched {seq_launches}, expected flash_attention_fwd {cfg.n_layers} "
                     "times and nothing else")
            if tuple(kv.placements) != tuple(placements(P(None, *seq_rules.kv_cache(True)), mesh)):
                fail(f"the seq-placed k cache is placed {tuple(kv.placements)}")
            if not torch.equal(seq_tokens, want):
                fail(f"greedy tokens decoded from the seq-placed cache differ from phase 5's in "
                     f"{int((seq_tokens != want).sum())} of {seq_tokens.numel()} places")
            print(f"greedy tokens from the seq-placed cache equal phase 5's first {SHARDED_GEN}")
            del params, caches, logits, kv, tok
            gc.collect()
            torch.cuda.empty_cache()

            # one bf16 train step under FSDP rules against the unsharded step
            tcfg = cfg.replace(n_layers=CUT_TRAIN_LAYERS)
            frules = rules_for(tcfg, mesh, fsdp=True)
            ds = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=TRAIN["seq_len"],
                                 global_batch=TRAIN["batch"], seed=seed)
            tbatch = {"tokens": torch.from_numpy(ds.global_batch_at(0)).to(dev)}
            opt = AdamW(lr=TRAIN_LR, moment_dtype=cfg.opt_moment_dtype)
            stepped, train_launches = {}, {}
            # deterministic algorithms, as phase 14's resume: else the embedding's backward adds
            # with atomics in a varying order, and even two unsharded steps differ
            torch.use_deterministic_algorithms(True)
            try:
                for name, r in (("unsharded", None), ("sharded", frules)):
                    p = init_params(T.param_defs(tcfg, r), seed=seed, device=dev, rules=r)
                    st = opt.init(p)
                    for c in kernels.values():
                        c.launches = 0
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    p, st, metrics = make_train_step(tcfg, opt, rules=r)(p, st, tbatch)
                    torch.cuda.synchronize()
                    stepped[name] = (p, st, float(full(metrics["loss"])), (time.perf_counter() - t) * 1e3)
                    train_launches = counts()
                    if train_launches["flash_attention_fwd"] != 2 * tcfg.n_layers:
                        fail(f"the {name} train step launched {train_launches}, expected flash_attention_fwd "
                             f"{2 * tcfg.n_layers} times")
            finally:
                torch.use_deterministic_algorithms(False)
            (p0, st0, loss0, ms0), (p1, st1, loss1, ms1) = stepped["unsharded"], stepped["sharded"]
            flat0, flat1 = dict(leaves(p0)), {k: full(v).detach() for k, v in leaves(p1)}
            bitwise = loss0 == loss1 and all(torch.equal(flat1[k], v.detach()) for k, v in flat0.items())

            def rel(got, want):  # per leaf: max |got - want| / max |want|
                return {k: ((got[k].float() - w.detach().float()).abs().max()
                            / w.detach().float().abs().max().clamp(min=1e-30)).item() for k, w in want.items()}

            # the gradients, through the first moments (1 - b1) clip(g), in fp32: per leaf, and
            # over the whole tree (a small leaf's bf16 sums cancel, and its largest element moves most)
            m1, m0 = {k: full(v) for k, v in leaves(st1["m"])}, dict(leaves(st0["m"]))
            m_rel = rel(m1, m0)
            m_all = (math.sqrt(sum(float((m1[k] - v).double().square().sum()) for k, v in m0.items()))
                     / math.sqrt(sum(float(v.double().square().sum()) for v in m0.values())))
            # Adam's first step is about lr sign(g): where bf16 rounding flips a tiny gradient's
            # sign, the two params differ by up to 2 lr, and by the rounding of bf16 params
            p_abs = {k: (flat1[k].float() - w.detach().float()).abs().max().item() for k, w in flat0.items()}
            p_bound = {k: 2 * TRAIN_LR + 2.0**-7 * w.detach().float().abs().max().item() for k, w in flat0.items()}
            worst_m = max(m_rel, key=m_rel.get)
            worst_p = max(p_abs, key=lambda k: p_abs[k] / p_bound[k])
            n_diff = sum(int((flat1[k] != w.detach()).sum()) for k, w in flat0.items())
            print(f"sharded train step qwen3_0_6b, {tcfg.n_layers} of {cfg.n_layers} layers, bf16, FSDP rules, "
                  f"deterministic algorithms, "
                  f"B={TRAIN['batch']} x {TRAIN['seq_len']}: "
                  f"loss {loss1!r} (unsharded {loss0!r}); {len(flat0)} params bit for bit {bitwise} ({n_diff} of "
                  f"{sum(w.numel() for w in flat0.values())} elements differ); first moments: "
                  f"||sharded - unsharded|| / ||unsharded|| over the tree {m_all:.3g}, largest per leaf "
                  f"|sharded - unsharded| / max |unsharded| {m_rel[worst_m]:.3g} ({worst_m}); params: largest "
                  f"|sharded - unsharded| {p_abs[worst_p]:.3g} against 2 lr + 2^-7 max |p| = {p_bound[worst_p]:.3g} "
                  f"({worst_p}); step {ms1:.1f} ms (unsharded, first step: {ms0:.1f} ms); launches {train_launches}")
            if not bitwise and (abs(loss1 - loss0) > SHARDED_STEP_TOL * abs(loss0) or m_all > SHARDED_STEP_TOL
                                or p_abs[worst_p] > p_bound[worst_p]):
                fail(f"the sharded train step differs from the unsharded one: the loss or the first moments "
                     f"beyond {SHARDED_STEP_TOL} relative, or a param by more than a flipped first step")
            del stepped, p0, st0, flat0
            gc.collect()
            torch.cuda.empty_cache()

            # the sharded state saved from the mesh, restored onto it and onto the card
            saved = {k: full(v).detach() for k, v in leaves({"params": p1, "opt_state": st1})}
            with tempfile.TemporaryDirectory() as repo_dir:
                ckpt = CheckpointManager(Repository.init(f"{repo_dir}/sharded"))
                t = time.perf_counter()
                oid = ckpt.save(1, p1, st1)
                save_s = time.perf_counter() - t
                placed = param_shardings(T.param_defs(tcfg, frules), frules)
                t = time.perf_counter()
                onto_mesh, manifest = ckpt.restore(oid, device=dev, shardings={
                    "params": placed, "opt_state": {"m": placed, "v": placed}})
                torch.cuda.synchronize()
                mesh_s = time.perf_counter() - t
                got = dict(leaves(onto_mesh))
                if not all(type(got[k]).__name__ == "DTensor" for k in got if not k.endswith("step")):
                    fail("the restore with shardings returned plain tensors")
                check_bit_equal(torch, "state restored onto the mesh", {k: full(v) for k, v in got.items()},
                                saved, dev)
                del onto_mesh, got
                onto_card, _ = ckpt.restore(oid, device=dev)
                check_bit_equal(torch, "state restored onto the card", dict(leaves(onto_card)), saved, dev)
                del onto_card
                plain = CheckpointManager(Repository.init(f"{repo_dir}/unsharded"))
                plain_oid = plain.save(1, unflat(saved, "params/"), unflat(saved, "opt_state/"))
                plain_manifest = json.loads(plain._tree_bytes(plain_oid, "checkpoints/step_00000001/manifest.json"))
                keys = {k: m["key"] for k, m in manifest["leaves"].items()}
                if keys != {k: m["key"] for k, m in plain_manifest["leaves"].items()}:
                    fail("the sharded save's annex keys differ from an unsharded save of the same tree")
            print(f"sharded checkpoint: {len(keys)} leaves saved from the (1, 1) mesh in {save_s:.3f} s, restored "
                  f"onto the mesh in {mesh_s:.3f} s and onto the card, both bit for bit; annex keys equal an "
                  f"unsharded save's")
        finally:
            dist.destroy_process_group()
    return launches, 2, train_launches, seq_launches


def dryrun_phase(torch, np, configs, T, kernels: dict, dev, seed: int):
    """Phase 27 (see the module docstring). Returns {name: (plan seconds,
    flash launches planned, flash launches run)} of the held runs."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed.sharding import rules_for
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import specs
    from repro_torch.launch.dryrun import kernel_calls, plan_step, run_cell
    from repro_torch.launch.roofline import analyze, fmt_s
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models.params import init_params
    from repro_torch.train.steps import greedy_token, make_decode_step, make_prefill_step, make_train_step

    total = torch.cuda.get_device_properties(dev).total_memory
    if total != launch_mesh.HBM_BYTES:
        fail(f"the card has {total} bytes of memory; launch/mesh.py's HBM_BYTES says {launch_mesh.HBM_BYTES}")
    for arch, shape, multi, cuts in DRYRUN_CELLS + [c + (DRYRUN_C4_CUTS,) for c in DRYRUN_C4_CELLS]:
        t = time.perf_counter()
        cell = run_cell(arch, shape, multi, overrides=cuts)
        if cell["status"] != "ok":
            fail(f"dry-run cell {arch} x {shape} x {cell['mesh']}: {cell['status']}")
        r = analyze(cell)
        print(f"dryrun {arch}{f', {cuts}' if cuts else ''} x {shape} x {cell['mesh']} ({cell['chips']} ranks, "
              f"torch {cell['torch']}, planned in "
              f"{time.perf_counter() - t:.1f} s; model outputs, H100 data-sheet constants): compute "
              f"{fmt_s(r['compute_s'])}, memory {fmt_s(r['memory_s'])}, collective {fmt_s(r['collective_s'])} "
              f"({cell['collective_bytes_by_link']} bytes by link), dominant {r['dominant']}, MODEL/counted "
              f"{r['useful_compute_ratio']:.2f}, peak {r['hbm_gib_per_device']:.2f} GiB/rank, fits 80 GB "
              f"{r['fits_h100_80g']}; kernel calls {cell['kernel_calls']}")

    cfg = configs.get("qwen3_0_6b").replace(**DRYRUN_HELD_CUTS)
    b, s, gen = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"]
    cache_len = s + gen
    shapes = {"prefill": configs.Shape("phase 5 prefill", "prefill", s, b),
              "decode": configs.Shape("phase 5 decode", "decode", s, b),
              "train": configs.Shape("phase 14 step", "train", TRAIN["seq_len"], TRAIN["batch"])}
    flash = kernels["attn"]

    def plan_all(rules) -> dict:
        return {kind: plan_step(cfg, shape, rules, cache_len=cache_len, pos=s) for kind, shape in shapes.items()}

    def run_all(rules) -> dict:
        """Each step once on the card from seed weights: peak memory above
        what was allocated before its arguments, FlopCounterMode's FLOPs and
        the flash launches."""
        out = {}
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        params = init_params(T.param_defs(cfg, rules), seed=seed, dtype=torch.bfloat16, device=dev, rules=rules)
        batch = prompt_batch(cfg, b, s, seed, dev)

        def measure(kind, fn):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            flash.launches = 0
            with FlopCounterMode(display=False) as fc:
                res = fn()
            torch.cuda.synchronize()
            out[kind] = {"peak": torch.cuda.max_memory_allocated(dev) - base, "flops": fc.get_total_flops(),
                         "flash": flash.launches}
            return res

        caches, logits = measure("prefill", lambda: make_prefill_step(cfg, cache_len, rules=rules)(params, batch))
        token = greedy_token(cfg, logits)
        del logits
        measure("decode", lambda: make_decode_step(cfg, rules=rules)(params, caches, token, s))
        del caches, token
        opt = specs.make_optimizer(cfg)
        opt_state = opt.init(params)
        measure("train", lambda: make_train_step(cfg, opt, rules=rules)(params, opt_state, batch))
        del params, opt_state, batch
        return out

    held = {}
    for placed in ("unsharded", "(1, 1) mesh"):
        if placed == "unsharded":
            plans, runs = plan_all(None), run_all(None)
        else:
            launch_mesh.start_fake_world(1)
            try:
                plans = plan_all(rules_for(cfg, init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))))
            finally:
                dist.destroy_process_group()
            with tempfile.TemporaryDirectory() as pg_dir:
                dist.init_process_group("nccl", init_method=f"file://{pg_dir}/store", rank=0, world_size=1)
                try:
                    runs = run_all(rules_for(cfg, init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))))
                finally:
                    dist.destroy_process_group()
        for kind, plan in plans.items():
            run = runs[kind]
            cell = {"chips": 1, "kind": "train" if kind == "train" else kind, "flops_per_device": plan["flops"],
                    "bytes_per_device": plan["bytes"], "collective_bytes_per_device": plan["collective_bytes"],
                    "collective_bytes_by_link": plan["collective_by_link"], "memory": plan["memory"],
                    "params_active": 0, "global_batch": b, "seq_len": s}
            r = analyze(cell)
            planned_flash = kernel_calls(plan["ops"]).get("flash_attention_fwd", 0)
            pred, meas = plan["memory"]["peak_bytes"], run["peak"]
            slack = max(DRYRUN_PEAK_TOL * meas, DRYRUN_PEAK_SLACK)
            print(f"dryrun held qwen3_0_6b, {cfg.n_layers} layers, {shapes[kind].name} bf16 B={b} x "
                  f"{shapes[kind].seq_len}, {placed}: "
                  f"peak predicted {pred} B ({pred / 2**30:.3f} GiB) measured {meas} B ({meas / 2**30:.3f} GiB), "
                  f"diff {(pred - meas) / 2**20:.1f} MiB (bar {slack / 2**20:.0f} MiB); FLOPs planned {plan['flops']} "
                  f"FlopCounterMode {run['flops']}; flash launches planned {planned_flash} run {run['flash']}; "
                  f"bound {fmt_s(r['bound_step_s'])} ({r['dominant']}: compute {fmt_s(r['compute_s'])}, memory "
                  f"{fmt_s(r['memory_s'])}); planned in {plan['plan_s']:.1f} s")
            if abs(pred - meas) > slack:
                fail(f"the dry-run's peak for {kind} ({placed}) is {pred} bytes, the card's {meas}")
            if plan["flops"] != run["flops"]:
                fail(f"the dry-run counted {plan['flops']} FLOPs for {kind} ({placed}), FlopCounterMode {run['flops']}")
            if planned_flash != run["flash"]:
                fail(f"the dry-run planned {planned_flash} flash launches for {kind} ({placed}), the card ran "
                     f"{run['flash']}")
            held[f"{kind}, {placed}"] = (plan["plan_s"], planned_flash, run["flash"])
    return held


def local_cluster(repo_dir: str, workers: int):
    """A local Slurm cluster for jobs in ``repo_dir``, numbering after the
    Slurm ids its job database holds: every ``LocalSlurmCluster`` starts at
    the same id, and ``verify()`` counts two jobs with one Slurm id as a
    duplicate record."""
    from repro_torch.core.jobdb import JobDB
    from repro_torch.core.repo import REPRO_DIR
    from repro_torch.core.slurm import LocalSlurmCluster

    ids = [j["slurm_id"] for j in JobDB(os.path.join(repo_dir, REPRO_DIR)).all_jobs() if j["slurm_id"] is not None]
    return LocalSlurmCluster(max_workers=workers, **({"first_job_id": max(ids) + 1} if ids else {}))


@contextmanager
def counting_sbatch():
    """Count ``LocalSlurmCluster.sbatch`` calls (the list of their work
    directories) while the block runs."""
    from repro_torch.core.slurm import LocalSlurmCluster

    plain = LocalSlurmCluster.sbatch
    calls = []

    def sbatch(self, script, workdir, *args, **kw):
        calls.append(workdir)
        return plain(self, script, workdir, *args, **kw)

    LocalSlurmCluster.sbatch = sbatch
    try:
        yield calls
    finally:
        LocalSlurmCluster.sbatch = plain


def campaign_phase(torch, np, configs, serve, kernels: dict, dev, seed: int, repo_dir: str):
    """Phase 28 (see the module docstring), in the empty directory
    ``repo_dir``. Returns (training launches by wrapper, steps trained,
    serving launches by wrapper, prefills served, the step-8 checkpoint
    commit, the served tokens on the CPU)."""
    from repro_torch.core.records import RunRecord
    from repro_torch.core.repo import Repository
    from repro_torch.launch import campaign
    from repro_torch.train.checkpoint import CheckpointManager

    cfg = configs.get("qwen3_0_6b").replace(**CAMPAIGN_CUTS)
    b, s = TRAIN["batch"], TRAIN["seq_len"]
    jobs, end2 = CAMPAIGN["sim_jobs"], CAMPAIGN["steps"]
    end1 = end2 // 2
    handed = []  # (data commit, step, batch, host ms) as the datasets hand them to train_segment
    plain_dataset = campaign.RepoTokenDataset

    class Recording(plain_dataset):
        def global_batch_at(self, step):
            t = time.perf_counter()
            out = super().global_batch_at(step)
            handed.append((self.commit, step, out.copy(), (time.perf_counter() - t) * 1e3))
            return out

    for counter in kernels.values():
        counter.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    campaign.RepoTokenDataset = Recording
    try:
        with counting_sbatch() as sbatched:
            t = time.perf_counter()
            res = campaign.run("qwen3_0_6b", repo=repo_dir, full=True, seq_len=s, batch=b, seed=seed, device=dev,
                               overrides=CAMPAIGN_CUTS, **CAMPAIGN)
            wall = time.perf_counter() - t
        train_launches = {counter.__name__: counter.launches for counter in kernels.values()}
        peak = torch.cuda.max_memory_allocated(dev)
        repo = Repository(repo_dir)
        last = res.segments[-1].checkpoint_commit
        manifest = json.loads(CheckpointManager(repo)._tree_bytes(last, f"checkpoints/step_{end2:08d}/manifest.json"))
        # the shards' recipe with numpy alone; the committed files must hold these tokens
        shards = [np.random.Generator(np.random.Philox(key=base + t)).integers(0, 4096, size=65_536,
                                                                              dtype=np.int32)
                  for base in (0, 100) for t in range(jobs)]
        on_disk = [np.load(Path(repo_dir) / f"campaign/batch_{base}/{t}/shard.npy")
                   for base in (0, 100) for t in range(jobs)]
        if not all(np.array_equal(a, w) for a, w in zip(on_disk, shards)):
            fail("the committed shards differ from the simulation recipe's tokens")
        gc.collect()
        torch.cuda.empty_cache()
        _, serve_res, serve_launches = serve_phase(torch, serve, configs, "qwen3_0_6b", kernels, dev, seed,
                                                   overrides=CAMPAIGN_CUTS, repo=repo_dir, commit=last)
    finally:
        campaign.RepoTokenDataset = plain_dataset

    def expected(n_shards: int, step: int):
        toks = np.concatenate(shards[:n_shards])
        n_seq = len(toks) // s
        rows = np.random.Generator(np.random.Philox(key=seed, counter=[0, 0, 0, step])).integers(0, n_seq, size=b)
        return toks[: n_seq * s].reshape(n_seq, s)[rows]

    c1, c2 = res.data_commits
    seg1, seg2 = res.segments
    want_steps = [(c1, k, jobs) for k in range(end1)] + [(c2, k, 2 * jobs) for k in range(end1, end2)]
    if [(c, k) for c, k, _, _ in handed] != [(c, k) for c, k, _ in want_steps]:
        fail(f"the datasets handed batches of (commit, step) {[(c[:12], k) for c, k, _, _ in handed]}")
    bad = [k for (_, k, got, _), (_, _, n) in zip(handed, want_steps) if not np.array_equal(got, expected(n, k))]
    if bad:
        fail(f"the batches of steps {bad} differ from the ones recomputed from the shards with numpy")
    if (seg1.start_step, seg1.end_step, seg2.start_step, seg2.end_step) != (0, end1, end1, end2):
        fail(f"segments ran {seg1.start_step}->{seg1.end_step} and {seg2.start_step}->{seg2.end_step}")
    if (manifest["step"], manifest["data_step"]) != (end2, end2):
        fail(f"the last checkpoint's manifest holds step {manifest['step']}, data_step {manifest['data_step']}")
    # each data commit merges the batch's job commits, each with its shard and Slurm job id
    sim_times = {}  # batch: (each job's runtime, first submission to last end), from the env.json files
    for base, data in ((0, c1), (100, c2)):
        parents = repo.objects.get_commit(data)["parents"]
        records = [RunRecord.from_message(repo.objects.get_commit(p)["message"]) for p in parents[1:]]
        outputs = sorted(o for r in records for o in r.outputs if o.endswith("shard.npy"))
        if (len(parents) != jobs + 1 or any(r.slurm_job_id is None for r in records)
                or outputs != [f"campaign/batch_{base}/{t}/shard.npy" for t in range(jobs)]):
            fail(f"data commit {data[:12]} of batch {base} has parents {parents} with records "
                 f"{[(r.slurm_job_id, r.outputs) for r in records]}")
        envs = [json.loads(committed_bytes(repo, data, f"{r.pwd}/slurm-job-{r.slurm_job_id}.env.json"))
                for r in records]
        sim_times[base] = ([round(e["Elapsed"][0], 3) for e in envs],
                           round(max(e["SubmitTime"] + e["Elapsed"][0] for e in envs)
                                 - min(e["SubmitTime"] for e in envs), 3))
    # each checkpoint, its data commit, that merge's job commits (newest first) and the scripts' save
    lineage = []
    for ckpt, data in ((last, c2), (seg1.checkpoint_commit, c1)):
        save, *job_commits = repo.objects.get_commit(data)["parents"]
        lineage += [ckpt, data, *sorted(job_commits, key=lambda j: -repo.objects.get_commit(j)["timestamp"]), save]
    if [oid for oid, _ in res.lineage] != lineage or repo.objects.get_commit(lineage[-1])["parents"]:
        fail(f"Repository.log from the step-{end2} checkpoint: {res.lineage}")
    if (len(sbatched) != 2 * jobs or [r["status"] for r in res.replay] != ["memoized"] * jobs
            or any(r["slurm_id"] is not None for r in res.replay)):
        fail(f"{len(sbatched)} sbatch calls for {2 * jobs} simulation jobs; the replay's rows "
             f"{[(r['status'], r['slurm_id']) for r in res.replay]}")
    flash_per_step = 2 * cfg.n_layers
    if train_launches["flash_attention_fwd"] != flash_per_step * end2 or any(
            n for name, n in train_launches.items() if name != "flash_attention_fwd"):
        fail(f"the campaign's training launched {train_launches}, expected flash_attention_fwd {flash_per_step} "
             f"times a step and nothing else")
    losses = seg1.losses + seg2.losses
    if len(losses) != end2 or not all(math.isfinite(x) for x in losses):
        fail(f"campaign losses {losses}")
    if serve_res.checkpoint_step != end2:
        fail(f"served checkpoint step {serve_res.checkpoint_step}, expected {end2}")
    timed = seg1.step_ms[1:] + seg2.step_ms[1:]  # each segment's first step allocates anew
    p50, p95 = float(np.percentile(timed, 50)), float(np.percentile(timed, 95))
    print(f"campaign qwen3_0_6b, {cfg.n_layers} of {configs.get('qwen3_0_6b').n_layers} layers, bf16 weights, fp32 "
          f"moments, remat, B={b} x {s} (launch.campaign.run): data "
          f"commit 1 {c1[:12]} (octopus merge of {jobs} Slurm jobs, shards of 65536 tokens), steps 0->{end1}, "
          f"checkpoint {seg1.checkpoint_commit[:12]}; data commit 2 {c2[:12]} ({2 * jobs} shards), resumed "
          f"{seg2.start_step}->{seg2.end_step}, checkpoint {last[:12]} (manifest step {manifest['step']}, "
          f"data_step {manifest['data_step']}); replay of batch 0: "
          f"{sum(r['status'] == 'memoized' for r in res.replay)} of {jobs} specs memoized, "
          f"{len(sbatched)} sbatch calls in all; simulation jobs' runtimes and each batch's span (s) {sim_times}; "
          f"step p50 {p50:.3f} ms p95 {p95:.3f} ms over each segment's steps "
          f"but its first (all: {[round(x, 3) for x in seg1.step_ms + seg2.step_ms]} ms); "
          f"{b * s / (float(np.mean(timed)) / 1e3):.1f} tokens/s; peak memory "
          f"{peak / 2**30:.3f} GiB; saves {[round(x, 3) for x in seg1.save_s + seg2.save_s]} s; losses "
          f"{[round(x, 5) for x in losses]}; dataset host ms per batch {[round(x, 3) for *_, x in handed]} (the "
          f"first of each dataset loads its shards); {len(handed)} batches equal to numpy's; whole run {wall:.3f} s; "
          f"launches {train_launches}")
    print("campaign lineage from the last checkpoint: " + "; ".join(f"{o[:12]} {t}" for o, t in res.lineage))
    return train_launches, end2, serve_launches, serve_res.prefills, last, serve_res.tokens.cpu()


def serving_job_specs(repo_root: str, commit: str, n: int, *, full: bool, device: str,
                      overrides: dict | None) -> list:
    """Write ``jobs/serve_<k>/slurm.sh`` (``SERVE_JOB`` with seed k) for k < n
    in the repository at ``repo_root`` and return their specs: each declares
    ``tokens.npy`` and takes ``PYTHONPATH`` (this checkout's ``src``) and
    cuBLAS's fixed workspace through its env."""
    from repro_torch import RunSpec

    specs = []
    for k in range(n):
        d = Path(repo_root) / "jobs" / f"serve_{k}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "slurm.sh").write_text(SERVE_JOB.format(commit=commit, seed=k, device=device, full=full,
                                                     overrides=overrides, shape=JOB_SERVE))
        specs.append(RunSpec(script="slurm.sh", outputs=[f"jobs/serve_{k}/tokens.npy"], pwd=f"jobs/serve_{k}",
                             message=f"serve {commit[:12]} seed {k}",
                             env={"PYTHONPATH": str(ROOT / "src"), "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}))
    return specs


def committed_bytes(repo, commit: str, path: str) -> bytes:
    entry = repo.entry_at(commit, path)
    if entry is None:
        fail(f"{path} is not in commit {commit[:12]}")
    return repo.objects.get_blob(entry["oid"]) if entry["t"] == "blob" else repo.annex.read(entry["key"])


class ServingJobs:
    """Phase 35 (see the module docstring) in two steps, so that its jobs run
    while this process does untimed work: the constructor submits the four
    serving jobs (phase 27 then plans meanwhile); ``finish`` serves each
    seed here, finishes the jobs, and resubmits and reschedules job 0."""

    def __init__(self, repo_dir: str, commit: str):
        import repro_torch
        from repro_torch.kernels import build

        self.repo_dir, self.commit = repo_dir, commit
        self.libs = {p: p.stat().st_mtime_ns for p in build.BUILD_DIR.glob("*.so")}
        self.session = repro_torch.open(repo_dir, cluster=local_cluster(repo_dir, SERVE_JOBS))
        atexit.register(self.close)  # also when a later phase fails
        self.specs = serving_job_specs(repo_dir, commit, SERVE_JOBS, full=True, device="cuda",
                                       overrides=CAMPAIGN_CUTS)
        self.ids = self.session.submit_many(self.specs)

    def close(self) -> None:
        """Stop every job still running (a no-op for the ones that ended) and
        the local cluster."""
        if self.session is None:
            return
        db = self.session.scheduler.db
        for row in db.open_jobs():
            if row["slurm_id"] is not None:
                self.session.cluster.scancel(row["slurm_id"])
        self.session.cluster.shutdown()
        self.session = None

    def finish(self, torch, np, serve, dev, smi: str):
        """Returns (the jobs' launches by wrapper, read from their committed
        logs, prefills they served)."""
        import io

        from repro_torch.core.hashing import annex_key_for_bytes
        from repro_torch.core.records import RunRecord
        from repro_torch.kernels import build

        s, n, commit, repo_dir = self.session, SERVE_JOBS, self.commit, self.repo_dir
        # while the jobs run: the tokens each must make, from serve.run here
        with deterministic(torch):
            want = [serve.run("qwen3_0_6b", full=True, device=dev, seed=k, repo=repo_dir, commit=commit,
                              overrides=CAMPAIGN_CUTS, **JOB_SERVE).tokens.cpu().numpy() for k in range(n)]
        s.wait(self.ids, timeout=600)
        rows = [s.scheduler.db.get(j) for j in self.ids]
        runtimes = [s.cluster.job_runtime(r["slurm_id"]) for r in rows]
        t = time.perf_counter()
        results = s.finish(octopus=True)
        finish_s = time.perf_counter() - t
        if [r.state for r in results] != ["COMPLETED"] * n:
            logs = [Path(repo_dir) / f"jobs/serve_{k}" / f"log.slurm-{r['slurm_id']}.out" for k, r in enumerate(rows)]
            fail(f"serving jobs ended {[r.state for r in results]}; logs:\n"
                 + "\n".join(p.read_text()[-3000:] for p in logs if p.exists()))
        repo = s.repo
        merge = repo.head_commit()
        parents = repo.objects.get_commit(merge)["parents"]
        by_job = {r.job_id: r.commit for r in results}
        if len(parents) != n + 1 or sorted(parents[1:]) != sorted(by_job.values()):
            fail(f"the octopus merge {merge[:12]} has parents {parents}, the jobs committed {by_job}")
        launches, prefills, intervals, stages = 0, 0, [], []
        for k, (row, spec) in enumerate(zip(rows, self.specs)):
            jc = by_job[row["job_id"]]
            rec = RunRecord.from_message(repo.objects.get_commit(jc)["message"])
            if s.spec_of(jc).spec_id != spec.spec_id or rec.slurm_job_id != row["slurm_id"]:
                fail(f"job {k}'s commit {jc[:12]} does not carry its spec and Slurm id: {rec}")
            got = np.load(io.BytesIO(committed_bytes(repo, merge, f"jobs/serve_{k}/tokens.npy")))
            if not np.array_equal(got, want[k]):
                fail(f"job {k}'s tokens differ from serve.run's in this process for seed {k}")
            log = committed_bytes(repo, merge, f"jobs/serve_{k}/log.slurm-{row['slurm_id']}.out").decode()
            counts = json.loads(log.strip().splitlines()[-1])
            if counts["flash_attention_fwd"] != CAMPAIGN_CUTS["n_layers"] * counts["prefills"]:
                fail(f"job {k} launched flash_attention_fwd {counts['flash_attention_fwd']} times over "
                     f"{counts['prefills']} prefills")
            launches += counts["flash_attention_fwd"]
            prefills += counts["prefills"]
            stages.append(counts["stages_s"])
            env = json.loads(committed_bytes(repo, merge, f"jobs/serve_{k}/slurm-job-{row['slurm_id']}.env.json"))
            if env["State"] != "COMPLETED":
                fail(f"job {k}'s env.json says {env['State']}")
            # the cluster has a worker for each job, so each ran from its submission
            intervals.append((env["SubmitTime"], env["SubmitTime"] + env["Elapsed"][0]))
        overlap = min(e for _, e in intervals) - max(b for b, _ in intervals)
        if overlap <= 0:
            fail(f"the serving jobs' running intervals do not overlap: {intervals}")
        span = max(e for _, e in intervals) - min(b for b, _ in intervals)
        # job 0's spec verbatim: the run cache answers it
        with counting_sbatch() as sbatched:
            memo = s.scheduler.db.get(s.submit_many([self.specs[0]])[0])
        if memo["status"] != "memoized" or memo["slurm_id"] is not None or sbatched:
            fail(f"job 0's spec resubmitted: {memo['status']}, slurm id {memo['slurm_id']}, "
                 f"{len(sbatched)} sbatch calls")
        # job 0 rescheduled from its record runs on the card again
        t = time.perf_counter()
        with counting_sbatch() as sbatched:
            again = s.reschedule(commitish=by_job[rows[0]["job_id"]])
        s.wait(again, timeout=600)
        rerun, = s.finish()
        reschedule_s = time.perf_counter() - t
        if rerun.state != "COMPLETED" or len(sbatched) != 1:
            fail(f"the reschedule of job 0 ended {rerun.state} after {len(sbatched)} sbatch calls")
        first = repo.entry_at(merge, "jobs/serve_0/tokens.npy")
        second = repo.entry_at(rerun.commit, "jobs/serve_0/tokens.npy")
        first_key = annex_key_for_bytes(committed_bytes(repo, merge, "jobs/serve_0/tokens.npy"))
        second_key = annex_key_for_bytes(committed_bytes(repo, rerun.commit, "jobs/serve_0/tokens.npy"))
        if first != second or first_key != second_key:
            fail(f"job 0's rescheduled tokens.npy is {second} ({second_key}), the first run's {first} ({first_key})")
        rerun_runtime = s.cluster.job_runtime(s.scheduler.db.get(again[0])["slurm_id"])
        self.close()
        rebuilt = [p.name for p, m in self.libs.items() if p.stat().st_mtime_ns != m]
        if rebuilt or set(build.BUILD_DIR.glob("*.so")) != set(self.libs):
            fail(f"a serving job rebuilt the kernels: {rebuilt or sorted(p.name for p in build.BUILD_DIR.glob('*.so'))}")
        print(f"jobs: {n} qwen3_0_6b serving jobs ({CAMPAIGN_CUTS['n_layers']} layers, B={JOB_SERVE['batch']} "
              f"prompt={JOB_SERVE['prompt_len']} gen={JOB_SERVE['gen']}, from checkpoint {commit[:12]}) in one "
              f"submit_many on a local cluster of {n} workers, submitted after phase 28's timed serve; submit to "
              f"completion {span:.3f} s (phase 27 and this process's serves of the {n} seeds ran meanwhile); job "
              f"runtimes {[round(x, 3) for x in runtimes]} s; running intervals overlap by {overlap:.3f} s; each "
              f"job's stages (s) {stages}; finish(octopus=True) {finish_s:.3f} s -> {merge[:12]} with "
              f"{len(parents) - 1} job parents; tokens equal to this process's for seeds 0-{n - 1}; flash launches "
              f"{launches} over {prefills} prefills (from the committed logs); job 0 resubmitted: memoized, 0 sbatch; "
              f"rescheduled, alone: {reschedule_s:.3f} s from submission to its finish (job runtime "
              f"{rerun_runtime:.3f} s), tokens.npy {second} (annex key of its bytes {second_key}) as the first run's; "
              f"kernels not rebuilt; card: {smi}")
        return {"flash_attention_fwd": launches, "rwkv6_fwd": 0, "mamba_scan_fwd": 0}, prefills


def pipeline_stages(repo_root: str, commit: str, *, vocab: int, seed: int, full: bool, device: str,
                    overrides: dict | None, broken: bool):
    """Write phase 36's scripts under ``pipe/`` of the repository at
    ``repo_root`` (the serve script exits 1 first with ``broken``) and return
    its ``repro_torch.Pipeline``, whose edges the pipeline infers. Each stage
    declares its script as an input and takes ``PYTHONPATH`` (this
    checkout's ``src``) and cuBLAS's fixed workspace through its env."""
    from repro_torch import Pipeline, RunSpec

    d = Path(repo_root) / "pipe"
    (d / "serve").mkdir(parents=True, exist_ok=True)
    (d / "prompts.sh").write_text(PIPE_PROMPTS.format(seed=seed, vocab=vocab, batch=PIPE["batch"],
                                                      prompt_len=PIPE["prompt_len"]))
    (d / "serve" / "slurm.sh").write_text(PIPE_SERVE.format(
        broken="exit 1  # broken on purpose\n" if broken else "", commit=commit, device=device, full=full,
        overrides=overrides or {}, gen=PIPE["gen"]))
    (d / "score.sh").write_text(PIPE_SCORE)
    env = {"PYTHONPATH": str(ROOT / "src"), "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    return Pipeline({
        "prompts": RunSpec(script="prompts.sh", pwd="pipe", inputs=["pipe/prompts.sh"],
                           outputs=["pipe/prompts.npy"], env=env, message="pipeline prompts"),
        "serve": RunSpec(script="slurm.sh", pwd="pipe/serve", inputs=["pipe/serve/slurm.sh", "pipe/prompts.npy"],
                         outputs=["pipe/serve/tokens.npy"], env=env, message=f"serve {commit[:12]} on the prompts"),
        "score": RunSpec(script="score.sh", pwd="pipe", inputs=["pipe/score.sh", "pipe/serve/*.npy"],
                         outputs=["pipe/score.json"], env=env, message="score the served tokens"),
    })


def pipeline_greedy(torch, cfg, params: dict, prompts, gen: int):
    """Greedy-decode ``gen`` tokens from ``prompts`` through the functions
    ``serve.run`` uses, as phase 36's serve stage does: [B, gen]."""
    from repro_torch.train.steps import greedy_token, make_decode_step, make_prefill_step

    prefill = make_prefill_step(cfg, cache_len=prompts.shape[1] + gen)
    decode = make_decode_step(cfg)
    caches, logits = prefill(params, {"tokens": prompts})
    tok = greedy_token(cfg, logits)
    out = [tok]
    for i in range(gen - 1):
        logits, caches = decode(params, caches, tok, prompts.shape[1] + i)
        tok = greedy_token(cfg, logits)
        out.append(tok)
    return torch.cat(out, dim=1)


def pipeline_score(np, tokens) -> dict:
    """What phase 36's score stage writes for ``tokens``."""
    import hashlib

    tokens = np.ascontiguousarray(tokens)
    counts = [{str(int(v)): int(c) for v, c in zip(*np.unique(col, return_counts=True))} for col in tokens.T]
    return {"sha256": hashlib.sha256(tokens.tobytes()).hexdigest(), "shape": list(tokens.shape),
            "counts_by_position": counts}


def slurm_record_counts(repo) -> dict:
    """{slurm id: commits publishing its record} over every ref."""
    from repro_torch.core.records import RunRecord

    counts: dict[int, int] = {}
    seen: set[str] = set()
    for b in repo.branches():
        frontier = [repo.branch_head(b)]
        while frontier:
            oid = frontier.pop()
            if oid is None or oid in seen:
                continue
            seen.add(oid)
            c = repo.objects.get_commit(oid)
            rec = RunRecord.from_message(c.get("message", ""))
            if rec is not None and rec.slurm_job_id is not None:
                counts[rec.slurm_job_id] = counts.get(rec.slurm_job_id, 0) + 1
            frontier.extend(c.get("parents", []))
    return counts


def pipeline_phase(torch, np, configs, repo_dir: str, commit: str, seed: int, *, full: bool, device: str,
                   overrides: dict | None, smi: str):
    """Phase 36 (see the module docstring) in the repository ``repo_dir``
    that holds the checkpoint ``commit``. Returns (the serve stage's
    launches by wrapper, read from its committed log, prefills it served)."""
    import io

    import repro_torch
    from repro_torch.core.faults import CrashInjected
    from repro_torch.core.recovery import list_journals
    from repro_torch.core.repo import Repository
    from repro_torch.core.slurm import CANCELLED, COMPLETED, LocalSlurmCluster
    from repro_torch.train.checkpoint import CheckpointManager

    cfg = (configs.get if full else configs.get_smoke)("qwen3_0_6b").replace(**(overrides or {}))
    kw = dict(vocab=cfg.vocab_size, seed=seed, full=full, device=device, overrides=overrides)
    pipeline = pipeline_stages(repo_dir, commit, broken=True, **kw)
    if pipeline.levels() != [["prompts"], ["serve"], ["score"]]:
        fail(f"the pipeline inferred levels {pipeline.levels()} from edges {pipeline.edges()}")
    cluster = local_cluster(repo_dir, 2)
    sessions = []

    def session(**kw):
        sessions.append(repro_torch.open(repo_dir, cluster=cluster, **kw))
        return sessions[-1]

    try:
        s = session()
        db = s.scheduler.db
        # 1. the serve stage fails: Slurm cancels score, the finish closes both
        t = time.perf_counter()
        out = s.run_pipeline(pipeline, close_failed_jobs=True, timeout=600)
        first_s = time.perf_counter() - t
        rows = {n: db.get(j) for n, j in out["jobs"].items()}
        status = {n: r["status"] for n, r in rows.items()}
        cancelled = rows["score"]["slurm_id"]
        if (status != {"prompts": "finished", "serve": "closed-failed", "score": "cancelled-dependency"}
                or cluster.sacct(cancelled) != CANCELLED or cluster.job_runtime(cancelled) is not None
                or (Path(repo_dir) / f"pipe/log.slurm-{cancelled}.out").exists()):
            fail(f"the failed pipeline ended {status}, score's Slurm state {cluster.sacct(cancelled)}")
        db.check_outputs(["pipe/serve/tokens.npy", "pipe/score.json"])  # their protection was released
        # what the serve stage must make, from the committed prompts, here
        prompts = np.load(Path(repo_dir) / "pipe/prompts.npy")
        params = CheckpointManager(Repository(repo_dir))._restore(commit, device, params_only=True)[0]["params"]
        with deterministic(torch):
            want = pipeline_greedy(torch, cfg, params, torch.from_numpy(prompts).to(device), PIPE["gen"])
        want = want.cpu().numpy()
        del params
        # 2. the fixed script, saved; the same pipeline again, not finished
        pipeline_stages(repo_dir, commit, broken=False, **kw)
        s.save(paths=["pipe/serve/slurm.sh"], message="fix the pipeline's serve stage")
        with counting_sbatch() as sbatched:
            t_submit = time.time()
            out = s.run_pipeline(pipeline, finish=False, timeout=600)
            replay_s = time.time() - t_submit
        rows = {n: db.get(j) for n, j in out["jobs"].items()}
        score_parents = [p["stage"] for p in db.parents_of(rows["score"]["job_id"])]
        if (rows["prompts"]["status"] != "memoized" or rows["prompts"]["slurm_id"] is not None
                or len(sbatched) != 2 or score_parents != ["serve"]):
            fail(f"the replay: prompts {rows['prompts']['status']}, {len(sbatched)} sbatch calls, score's "
                 f"parents {score_parents}")
        serve_slurm, score_slurm = rows["serve"]["slurm_id"], rows["score"]["slurm_id"]
        logs = {n: Path(repo_dir) / d / f"log.slurm-{rows[n]['slurm_id']}.out"
                for n, d in (("serve", "pipe/serve"), ("score", "pipe"))}
        if [cluster.sacct(serve_slurm), cluster.sacct(score_slurm)] != [COMPLETED] * 2:
            fail(f"the replay's jobs ended {cluster.sacct(serve_slurm)}, {cluster.sacct(score_slurm)}; logs:\n"
                 + "\n".join(p.read_text()[-3000:] for p in logs.values() if p.exists()))
        serve_log = json.loads(logs["serve"].read_text().strip().splitlines()[-1])
        score_start = json.loads(logs["score"].read_text().strip().splitlines()[-1])["start"]
        if score_start < serve_log["end"]:
            fail(f"score started {serve_log['end'] - score_start:.3f} s before serve ended")
        runtimes = {n: cluster.job_runtime(rows[n]["slurm_id"]) for n in ("serve", "score")}
        # 3. the finish is killed after its first publication, then recovered
        t = time.perf_counter()
        try:
            session(faults=repro_torch.FaultPlan(crash_at={"finish:after-publish": 1})).finish()
        except CrashInjected:
            killed_s = time.perf_counter() - t
        else:
            fail("the finish with crash point finish:after-publish did not crash")
        journals = list_journals(str(Path(repo_dir) / ".repro"))
        if len(journals) != 1 or not (Path(repo_dir) / ".repro/locks/refs.lock").exists():
            fail(f"the killed finish left journals {journals} and no refs lock")
        journal = Path(journals[0]).read_bytes()
        s2 = session()
        t = time.perf_counter()
        report = s2.recover()
        recover_s = time.perf_counter() - t
        t = time.perf_counter()
        check = s2.verify()
        verify_s = time.perf_counter() - t
        done = {k: v for k, v in report.items() if v}
        if done != {"locks_broken": 1, "journals_replayed": 1, "commits_republished": 1, "jobs_refinished": 1}:
            fail(f"recover() reported {report}")
        counts = slurm_record_counts(s2.repo)
        if check["divergence"] or any(n != 1 for n in counts.values()) or not {serve_slurm, score_slurm} <= set(counts):
            fail(f"after recovery: verify {check['issues']}, records by Slurm id {counts}")
        again = s2.recover()
        if again["journals_replayed"] or again["jobs_refinished"]:
            fail(f"a second recover() did work: {again}")
        statuses = {n: s2.scheduler.db.get(rows[n]["job_id"])["status"] for n in rows}
        if statuses != {"prompts": "memoized", "serve": "finished", "score": "finished"}:
            fail(f"after recovery the rows are {statuses}")
        # 4. the results, as committed
        repo = s2.repo
        head = repo.head_commit()
        got = np.load(io.BytesIO(committed_bytes(repo, head, "pipe/serve/tokens.npy")))
        if got.shape != (PIPE["batch"], PIPE["gen"]) or not np.array_equal(got, want):
            fail("the serve stage's committed tokens differ from this process's greedy decode of the prompts")
        score = json.loads(committed_bytes(repo, head, "pipe/score.json"))
        if score != pipeline_score(np, want):
            fail(f"the committed score.json differs from this process's: {score}")
        log = committed_bytes(repo, head, f"pipe/serve/log.slurm-{serve_slurm}.out").decode()
        served = json.loads(log.strip().splitlines()[-1])
        per_prefill = cfg.n_layers if device == "cuda" else 0  # the CPU runs the plain version
        if served["flash_attention_fwd"] != per_prefill * served["prefills"]:
            fail(f"the serve stage launched flash_attention_fwd {served['flash_attention_fwd']} times over "
                 f"{served['prefills']} prefills")
    finally:
        for sess in sessions:
            sess.close()
        cluster.shutdown()
    print(f"pipeline: prompts -> serve -> score (qwen3_0_6b, {cfg.n_layers} layers, B={PIPE['batch']} "
          f"prompt={PIPE['prompt_len']} gen={PIPE['gen']}, checkpoint {commit[:12]}), edges {pipeline.edges()}; "
          f"first run with a failing serve script: run_pipeline(close_failed_jobs=True) {first_s:.3f} s, score "
          f"cancelled by the afterok cascade unstarted; replay run_pipeline(finish=False) {replay_s:.3f} s from "
          f"submission to both jobs' end, prompts memoized, {len(sbatched)} sbatch calls; submit to result: serve "
          f"{serve_log['end'] - t_submit:.3f} s, score {score_start + runtimes['score'] - t_submit:.3f} s; "
          f"runtimes (s) serve {runtimes['serve']:.3f}, score {runtimes['score']:.3f}; score started "
          f"{score_start - serve_log['end']:.3f} s after serve ended; serve stages (s) {serve_log['stages_s']}; "
          f"finish killed at finish:after-publish after {killed_s:.3f} s, its journal {len(journal)} bytes in "
          f"{journal.count(b'\n')} lines; recover() {recover_s:.3f} s -> {done}; verify() {verify_s:.3f} s, "
          f"divergence {check['divergence']}, {check['checked_commits']} commits, every one of {len(counts)} Slurm "
          f"ids recorded once; tokens and score.json equal to this process's; serve's flash launches "
          f"{served['flash_attention_fwd']} over {served['prefills']} prefill; card: {smi}")
    return {"flash_attention_fwd": served["flash_attention_fwd"], "rwkv6_fwd": 0, "mamba_scan_fwd": 0}, \
        served["prefills"]


REMOTE_FRESH = dict(files=4, nbytes=1 << 20)  # phase 37: the killed push's fresh content
# phase 37's CPU job, run by the local cluster in remote/job/ and finished with push_to="siteB"
REMOTE_JOB = """#!/bin/bash
# a CPU job: 256 x 256 float64 from numpy's seeded generator
python3 - <<'EOF'
import numpy as np
np.save("out.npy", np.random.default_rng({seed}).standard_normal((256, 256)))
EOF
"""


def leaves_of(tree: dict, prefix: str = ""):
    """(path, tensor) of every leaf of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves_of(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def remote_phase(torch, np, configs, serve, kernels: dict, dev, seed: int, repo_dir: str, commit: str, want_tokens,
                 *, full: bool, device: str, overrides: dict | None, smi: str, shape: dict = SERVE):
    """Phase 37 (see the module docstring) in the repository ``repo_dir``
    that holds the checkpoint ``commit``, which phase 28 served as
    ``want_tokens``. Returns (the serve's launches by wrapper, prefills)."""
    import repro_torch
    from repro_torch import GPFS, NetFaultRule, NetworkFaultModel, SimClock
    from repro_torch.core.faults import CrashInjected, kill_token
    from repro_torch.core.fsio import FS
    from repro_torch.core.hashing import annex_key_for_file, parse_annex_key
    from repro_torch.core.records import RunRecord
    from repro_torch.core.repo import Repository
    from repro_torch.train.checkpoint import CheckpointManager

    cfg = (configs.get if full else configs.get_smoke)("qwen3_0_6b").replace(**(overrides or {}))
    clock = SimClock()  # every session of the phase charges this one clock
    walls, phase_t = {}, time.perf_counter()
    repo = Repository(repo_dir)
    step = RunRecord.from_message(repo.objects.get_commit(commit)["message"]).extras["checkpoint_step"]
    reldir = f"checkpoints/step_{step:08d}"
    leaves = json.loads(CheckpointManager(repo)._tree_bytes(commit, f"{reldir}/manifest.json"))["leaves"]
    keys = sorted({m["key"] for m in leaves.values()})  # leaves of equal content share one key
    params = {f"{reldir}/{m['file']}": m["key"] for p, m in leaves.items() if p.startswith("params/")}
    ckpt_bytes = sum(parse_annex_key(k)[0] for k in keys)
    params_bytes = sum(parse_annex_key(k)[0] for k in set(params.values()))

    def outage():  # a rule counts its own calls: each model gets a fresh one
        return NetworkFaultModel(seed=seed, rules=[NetFaultRule(op="*", remote="siteA", kind="outage", nth=1)])

    sessions = []

    def session(**kw):
        sessions.append(repro_torch.open(repo_dir, profile=GPFS, clock=clock, **kw))
        return sessions[-1]

    def end(sess) -> None:
        """The session's process ends: its incarnations (the repository's
        and its links to the sites) are dead, so the next open may sweep
        the tmps they left."""
        sess.close()
        for fs in [sess.repo.fs, *(st.fs for st in sess.repo.remote_stores)]:
            kill_token(fs.token)

    with tempfile.TemporaryDirectory() as sites:
        try:
            # 1. on the cost model, two sites; the checkpoint pushed under network faults
            t = time.perf_counter()
            s = session(net_faults=NetworkFaultModel(seed=seed, rules=[
                NetFaultRule(op="send", remote="siteB", kind="error", nth=1, times=1),
                NetFaultRule(op="send", remote="siteB", kind="disconnect", nth=3, times=1)]))
            site_a = s.add_remote(f"{sites}/siteA", name="siteA", net="lan")
            site_b = s.add_remote(f"{sites}/siteB", name="siteB", net="wan")
            pushed = s.push(keys=keys)
            walls["push"] = time.perf_counter() - t
            retries = sum(r["retries"] for r in pushed)
            stranded = [n for n in os.listdir(site_b.root) if n.startswith("tmp-")]
            if ([(r["keys_sent"], r["bytes_sent"]) for r in pushed] != [(len(keys), ckpt_bytes)] * 2
                    or retries < 2 or len(stranded) != 1 or site_b.count_stale_tmps(max_age_s=None) != 0):
                fail(f"the faulted push: reports {pushed}, siteB's tmps {stranded} (stale while its session lives: "
                     f"{site_b.count_stale_tmps(max_age_s=None)})")
            sent = {st.name: (st.bytes_sent, st.transfers) for st in (site_a, site_b)}
            end(s)
            # 2. a push of fresh content, killed mid-object, replayed by recover()
            t = time.perf_counter()
            rng = np.random.default_rng(seed)
            fresh = [f"remote/fresh_{i}.bin" for i in range(REMOTE_FRESH["files"])]
            for rel in fresh:
                (Path(repo_dir) / rel).parent.mkdir(parents=True, exist_ok=True)
                (Path(repo_dir) / rel).write_bytes(rng.bytes(REMOTE_FRESH["nbytes"]))
            s = session(faults=repro_torch.FaultPlan(crash_at={"remote:push-mid-object": 1}))
            swept = [n for n in os.listdir(s.repo.remote_by_name("siteB").root) if n.startswith("tmp-")]
            if swept:
                fail(f"opening the repository again did not sweep siteB's stranded tmp: {swept}")
            s.save(paths=fresh, message="fresh content for a killed push")
            fresh_keys = [s.repo.annex_key_at(rel) for rel in fresh]
            killed_a = s.repo.remote_by_name("siteA")
            try:
                s.push(remote="siteA", keys=fresh_keys)
            except CrashInjected:
                before = (killed_a.transfers, killed_a.bytes_sent)
            else:
                fail("the push with crash point remote:push-mid-object did not crash")
            end(s)
            s = session()
            site_a = s.repo.remote_by_name("siteA")
            report = s.recover()
            after = (site_a.transfers, site_a.bytes_sent)
            walls["killed push and recover"] = time.perf_counter() - t
            lacked = len(fresh_keys)
            if (report["pushes_resumed"] != 1 or report["errors"] or before[0] + after[0] != lacked
                    or before[1] + after[1] != lacked * REMOTE_FRESH["nbytes"] or before[0] < 1
                    or site_a.has_many(fresh_keys, fresh=True) != set(fresh_keys)):
                fail(f"the killed push: {before} objects and bytes before the kill, {after} after, of {lacked} "
                     f"lacked; recover() {report}")
            # 3. the params' local copies dropped, siteA down, pulled back from siteB
            t = time.perf_counter()
            for rel in params:
                s.drop(rel)
            if any(s.repo.annex.has(k, fresh=True) for k in params.values()):
                fail("a dropped params leaf is still in the local annex")
            s.close()
            s = session(net_faults=outage())
            pulled = s.pull(keys=sorted(set(params.values())))
            site_b = s.repo.remote_by_name("siteB")
            walls["drop and pull"] = time.perf_counter() - t
            if (pulled["keys_fetched"] != len(set(params.values())) or set(pulled["sources"].values()) != {"siteB"}
                    or not (pulled["failovers"] >= 1 or not s.repo.remote_by_name("siteA").available)
                    or pulled["bytes_received"] != params_bytes
                    or any(annex_key_for_file(s.repo.annex._path(k)) != k for k in params.values())):
                fail(f"the pull with siteA down: {pulled}")
            received = (site_b.bytes_received, site_b.transfers)
            s.close()
            # 4. served from the pulled-back checkpoint, as phase 28 served it
            t = time.perf_counter()
            for counter in kernels.values():
                counter.launches = 0
            res = serve.run("qwen3_0_6b", full=full, device=dev, dtype="bfloat16", seed=seed, overrides=overrides,
                            repo=repo_dir, commit=commit, **shape)
            launches = {counter.__name__: counter.launches for counter in kernels.values()}
            walls["serve"] = time.perf_counter() - t
            per_prefill = cfg.n_layers if device == "cuda" else 0  # the CPU runs the plain version
            if (launches["flash_attention_fwd"] != per_prefill * res.prefills
                    or any(n for name, n in launches.items() if name != "flash_attention_fwd")):
                fail(f"serving the pulled-back checkpoint launched {launches} over {res.prefills} prefills")
            if not torch.equal(res.tokens.cpu(), want_tokens.cpu()) or not res.logits_finite:
                fail("the tokens served from the pulled-back checkpoint differ from phase 28's")
            # 5. ROADMAP.md §C7: a leaf not local, siteA down: the restore fetches it from siteB
            t = time.perf_counter()
            want, _ = CheckpointManager(Repository(repo_dir))._restore(commit, dev, params_only=True)
            rel0, key0 = next(iter(params.items()))
            s = session()
            s.repo.remote_by_name("siteA").mark_unavailable()
            s.drop(rel0)  # siteB's copy is the one verified
            s.close()
            down = Repository(repo_dir, fs=FS(GPFS, clock), net_faults=outage())
            got, _ = CheckpointManager(down)._restore(commit, dev, params_only=True)
            walls["restore past siteA"] = time.perf_counter() - t
            flat_want, flat_got = dict(leaves_of(want)), dict(leaves_of(got))
            if (down.remote_by_name("siteA").available or not down.annex.has(key0, fresh=True)
                    or flat_want.keys() != flat_got.keys()
                    or not all(torch.equal(flat_got[k], v) for k, v in flat_want.items())):
                fail(f"the restore with siteA down did not fetch the dropped leaf from siteB bit for bit: siteA "
                     f"available {down.remote_by_name('siteA').available}, leaf local {down.annex.has(key0, fresh=True)}, "
                     f"leaves equal {[k for k in flat_want if not torch.equal(flat_got.get(k), flat_want[k])]}")
            del want, got, flat_want, flat_got
            # 6. fsck: the location rows against fresh probes
            t = time.perf_counter()
            s = session()
            rows = s._db().locations_all()
            check = s.verify()
            walls["verify"] = time.perf_counter() - t
            kinds = sorted({i["kind"] for i in check["issues"]})
            if check["divergence"] or {"stale-location", "unchecked-location"} & set(kinds) or not rows:
                fail(f"verify(): divergence {check['divergence']}, issues {check['issues']}")
            s.close()
            # 7. one CPU job finished with push_to="siteB"
            t = time.perf_counter()
            job_dir = Path(repo_dir) / "remote/job"
            job_dir.mkdir(parents=True, exist_ok=True)
            (job_dir / "slurm.sh").write_text(REMOTE_JOB.format(seed=seed))
            cluster = local_cluster(repo_dir, 1)
            try:
                s = session(cluster=cluster)
                s.save(paths=["remote/job/slurm.sh"], message="the remote phase's CPU job")
                ids = s.submit_many([repro_torch.RunSpec(script="slurm.sh", pwd="remote/job",
                                                         inputs=["remote/job/slurm.sh"],
                                                         outputs=["remote/job/out.npy"],
                                                         message="a CPU job whose output goes to siteB")])
                s.wait(ids, timeout=600)
                finished = s.finish(push_to="siteB")
                out_key = s.repo.annex_key_at("remote/job/out.npy")
                if ([r.state for r in finished] != ["COMPLETED"]
                        or not s.repo.remote_by_name("siteB").has(out_key, fresh=True)
                        or "siteB" not in s._db().locations_of([out_key])[out_key]
                        or not np.array_equal(np.load(job_dir / "out.npy"),
                                              np.random.default_rng(seed).standard_normal((256, 256)))):
                    fail(f"the finish with push_to=siteB: {finished}")
            finally:
                s.close()
                cluster.shutdown()
            walls["finish push_to"] = time.perf_counter() - t
        finally:
            for sess in sessions:
                sess.close()
    print(f"remote sites: qwen3_0_6b ({cfg.n_layers} layers) step-{step} checkpoint {commit[:12]}, {len(keys)} "
          f"leaves, {ckpt_bytes} bytes ({len(params)} params leaves, {params_bytes} bytes); wall s "
          f"{ {k: round(v, 3) for k, v in walls.items()} }, phase {time.perf_counter() - phase_t:.3f} s; pushed "
          f"with a transient error and a disconnect on siteB (site, keys, objects, bytes, retries): "
          f"{[(r['remote'], r['keys_sent'], r['chunks_sent'], r['bytes_sent'], r['retries']) for r in pushed]}; "
          f"each site's bytes and objects sent {sent}; killed push of {lacked} fresh objects: {before[0]} sent "
          f"before the kill, {after[0]} by recover() ({report['pushes_resumed']} push resumed), none twice; pull "
          f"with siteA down: {pulled['keys_fetched']} keys, {pulled['chunks_fetched']} objects, "
          f"{pulled['bytes_received']} bytes from siteB, {pulled['failovers']} failovers, {pulled['retries']} "
          f"retries (siteB's bytes and objects received {received}); served tokens equal to phase 28's, flash "
          f"launches {launches['flash_attention_fwd']} over {res.prefills} prefills; restore with siteA down "
          f"fetched {key0[:24]}... from siteB; verify(): divergence {check['divergence']}, {len(rows)} location "
          f"rows checked against fresh probes, issues {kinds}; finish(push_to=siteB) put {out_key[:24]}... on "
          f"siteB; the store wrote {clock.bytes_written} bytes ({clock.bytes_written / ckpt_bytes:.2f}x the "
          f"checkpoint; the FS's byte counters count real bytes); modelled "
          f"(GPFS / LAN / WAN profile), not measured: {clock.total:.6f} s, {clock.meta_ops} metadata operations, "
          f"{clock.bytes_read} bytes read, {clock.bytes_written} bytes written; card: {smi}")
    return launches, res.prefills


# Phase 38's modelled footprint: the loose files of a campaign repository on
# GPFS past the point where finish degrades. The GPFS profile's threshold of
# 192 entries a shard is the paper's ~50,000-file onset (core/fsio.py);
# benchmarks/bench_finish.py and its --check-finish gate measure at 100,000
# files, seeded 100,000 // 256 = 390 entries to each shard, as here.
FOOTPRINT_FILES = 100_000


def seed_shard_pressure(repo, phantom: int = 0) -> int:
    """Seed ``repo``'s FS with each loose shard's real entry count (a fresh
    FS models only the files it makes) plus ``phantom`` modelled entries
    with no file behind them, and return the largest."""
    for shard in repo.objects._shard_dirs():
        real = len(os.listdir(shard)) if os.path.isdir(shard) else 0
        if real or phantom:
            repo.fs.preload_dir_entries(shard, real + phantom)
    return repo.objects.loose_pressure()


def loose_objects(repo) -> dict[str, int]:
    """{oid: bytes} of the object store's loose files."""
    out = {}
    for shard in repo.objects._shard_dirs():
        if os.path.isdir(shard):
            for f in os.listdir(shard):
                out[os.path.basename(shard) + f] = os.path.getsize(os.path.join(shard, f))
    return out


def gc_clone_phase(torch, configs, serve, kernels: dict, dev, seed: int, repo_dir: str, commit: str, want_tokens,
                   *, full: bool, device: str, overrides: dict | None, smi: str, shape: dict = SERVE):
    """Phase 38 (see the module docstring) in the repository ``repo_dir``
    that holds the checkpoint ``commit``, which phase 28 served as
    ``want_tokens``, after phase 37. Returns (the serve's launches by
    wrapper, prefills)."""
    import zlib

    import repro_torch
    from repro_torch import GPFS, SimClock
    from repro_torch.core.faults import CrashInjected, kill_token
    from repro_torch.core.fsio import FS
    from repro_torch.core.hashing import annex_key_for_file, parse_annex_key
    from repro_torch.core.records import RunRecord
    from repro_torch.core.repo import Repository
    from repro_torch.train.checkpoint import CheckpointManager

    cfg = (configs.get if full else configs.get_smoke)("qwen3_0_6b").replace(**(overrides or {}))
    clock = SimClock()  # every session of the phase charges this one clock
    walls, phase_t = {}, time.perf_counter()
    repo = Repository(repo_dir)
    step = RunRecord.from_message(repo.objects.get_commit(commit)["message"]).extras["checkpoint_step"]
    reldir = f"checkpoints/step_{step:08d}"
    leaves = json.loads(CheckpointManager(repo)._tree_bytes(commit, f"{reldir}/manifest.json"))["leaves"]
    params = {f"{reldir}/{m['file']}": m["key"] for p, m in leaves.items() if p.startswith("params/")}
    params_bytes = sum(parse_annex_key(k)[0] for k in set(params.values()))
    step_tree = repo.tree_of(commit)
    # phases 28 and 35-37 ran with the "auto" threshold: an auto-repack leaves
    # a pack holding trees or blobs; a memoized batch's pack holds commits only
    auto_packs = [pid for pid in repo.objects.packs.pack_ids()
                  if any(not zlib.decompress(frame).startswith(b"commit ")
                         for _, frame in repo.objects.packs.read_pack_objects(pid))]
    packs_before = len(repo.objects.packs.pack_ids())
    sessions = []
    # the modelled footprint's entries a shard: until gc packs them, every
    # session's FS holds them beside the real files
    phantom = [FOOTPRINT_FILES // 256]

    def session(**kw):
        sessions.append(repro_torch.open(repo_dir, profile=GPFS, clock=clock, **kw))
        seed_shard_pressure(sessions[-1].repo, phantom[0])
        return sessions[-1]

    def end(sess) -> None:
        """The session's process ends: its incarnation is dead."""
        sess.close()
        kill_token(sess.repo.fs.token)

    def probe(tag: str) -> tuple[float, int, float, dict]:
        """One fixed small save (a new 4 KiB file at the top: a blob, the
        root tree and a commit) on a fresh session: its modelled seconds,
        metadata operations, the seconds of those that the shards'
        degradation term adds (the total less the operations at
        ``meta_op_s`` and the bytes at the profile's rates), and its
        operations by directory (the loose shards as one, and how many of
        theirs met more than the profile's threshold of entries)."""
        rel = f"gc_probe_{tag}.txt"
        (Path(repo_dir) / rel).write_bytes((tag.encode() * 4096)[:4096])
        s = session()
        fs, by_dir = s.repo.fs, collections.Counter()
        charge, shards = fs._charge_meta, {os.path.abspath(d) for d in s.repo.objects._shard_dirs()}

        def tallied(n: int, dirpath: str) -> None:
            if dirpath in shards:
                by_dir["loose shards"] += n
                if fs.dir_entry_count(dirpath) > GPFS.degrade_threshold:
                    by_dir["loose shards past the threshold"] += n
            else:
                by_dir[os.path.relpath(dirpath, repo_dir) if dirpath else "none"] += n
            charge(n, dirpath)

        fs._charge_meta = tallied
        before = (clock.total, clock.meta_ops, clock.bytes_read, clock.bytes_written)
        s.save(paths=[rel], message=f"the gc phase's probe, {tag} gc")
        s.close()
        secs, ops, nread, nwritten = (now - then for now, then in zip(
            (clock.total, clock.meta_ops, clock.bytes_read, clock.bytes_written), before))
        fs._charge_meta = charge
        degrade = secs - ops * GPFS.meta_op_s - nread / GPFS.read_bw - nwritten / GPFS.write_bw
        return secs, ops, degrade, dict(sorted(by_dir.items()))

    with tempfile.TemporaryDirectory() as clones:
        try:
            # 1. a repack killed mid-unlink; recover() and verify() after it
            t = time.perf_counter()
            loose = loose_objects(repo)
            s = session(faults=repro_torch.FaultPlan(crash_at={"repack:mid-unlink": 1}))
            pressure = s.repo.objects.loose_pressure()
            fullest = max(collections.Counter(oid[:2] for oid in loose).values())
            w0 = clock.bytes_written
            try:
                s.repo.objects.repack()
            except CrashInjected:
                killed_written = clock.bytes_written - w0
            else:
                fail("the repack with crash point repack:mid-unlink did not crash")
            end(s)
            s = session()
            report = s.recover()
            check = s.verify()
            try:  # log() reads every commit it walks
                commits = {oid for b in s.repo.branches() for oid, _ in s.repo.log(s.repo.branch_head(b))}
            except (OSError, ValueError) as e:
                fail(f"a commit did not read back after the killed repack: {e!r}")
            walls["killed repack, recover, verify"] = time.perf_counter() - t
            if (report["locks_broken"] != 1 or report["errors"] or check["divergence"]
                    or os.path.exists(os.path.join(repo_dir, ".repro", "locks", "repack.lock"))):
                fail(f"after the killed repack: recover() {report}, verify() {check['issues']}")
            s.close()
            # 2. the probe, gc, the probe again
            probe_before = probe("before")
            t = time.perf_counter()
            s = session()
            dup = [oid for oid in loose_objects(s.repo) if s.repo.objects.packs.has(oid)]
            n_loose = len(loose_objects(s.repo))
            w0, gc_t0, gc_ops0 = clock.bytes_written, clock.total, clock.meta_ops
            stats = s.gc()
            gc_written, gc_modelled = clock.bytes_written - w0, (clock.total - gc_t0, clock.meta_ops - gc_ops0)
            walls["gc"] = time.perf_counter() - t
            fresh = Repository(repo_dir, fs=FS(GPFS, clock))
            if (stats["objects_packed"] != n_loose - len(dup) or stats["loose_unlinked"] != n_loose
                    or stats["phantom_entries_purged"] != 256 * phantom[0] or s.repo.objects.loose_pressure()
                    or loose_objects(fresh) or fresh.tree_of(commit) != step_tree
                    or "cache_evicted" not in stats):
                fail(f"gc(): {stats} of {n_loose} loose objects, {len(dup)} already packed, {256 * phantom[0]} "
                     f"modelled entries; the fullest shard after it {s.repo.objects.loose_pressure()} entries, "
                     f"loose files {len(loose_objects(fresh))}; step-{step} tree equal "
                     f"{fresh.tree_of(commit) == step_tree}")
            phantom[0] = 0  # packed: the footprint is gone from the shards
            s.close()
            probe_after = probe("after")
            packs_after = fresh.objects.packs.pack_ids()
            # 3. a clone; a branch at the checkpoint; the params fetched from the origin's annex
            t = time.perf_counter()
            src = Repository(repo_dir, fs=FS(GPFS, clock))
            w0 = clock.bytes_written
            clone = Repository.clone(src, f"{clones}/clone", fs=FS(GPFS, clock))
            cloned = clock.bytes_written - w0
            walls["clone"] = time.perf_counter() - t
            if (clone.annex.keys() or {r["name"] for r in clone.config["remotes"]} != {"siteA", "siteB"}
                    or clone.config["numcopies"] != src.config["numcopies"]
                    or clone.config["annex_remotes"] != [src.annex.root]
                    or clone.remote_by_name("remote0").root != src.annex.root
                    or loose_objects(clone) != loose_objects(src) or clone.objects.packs.pack_ids() != packs_after):
                fail(f"the clone: local keys {len(clone.annex.keys())}, config {clone.config}, "
                     f"packs {clone.objects.packs.pack_ids()} (origin's {packs_after})")
            t = time.perf_counter()
            clone.create_branch("gc-phase/checkpoint", at=commit)
            clone.switch("gc-phase/checkpoint")
            annexed = [p for p, e in clone.tree_of(commit).items() if p.startswith(reldir) and e["t"] == "annex"]
            not_pointers = [p for p in annexed
                            if not (Path(clone.root) / p).read_bytes().startswith(b"#%REPRO-ANNEX%#")]
            where = clone.whereis_many(sorted(set(params.values())))
            w0 = clock.bytes_written
            got = [clone.annex_get(rel) for rel in params]
            fetched = clock.bytes_written - w0
            walls["switch and annex_get"] = time.perf_counter() - t
            if (clone.current_branch() != "gc-phase/checkpoint" or not annexed or not_pointers or not all(got)
                    or any(v != ["remote0"] for v in where.values())
                    or any(annex_key_for_file(str(Path(clone.root) / rel)) != k for rel, k in params.items())):
                fail(f"the clone's checkout: branch {clone.current_branch()}, {len(not_pointers)} of {len(annexed)} "
                     f"annexed files not pointers, whereis {where}, annex_get {got}")
            # 4. served from the clone, as phase 28 served it
            t = time.perf_counter()
            for counter in kernels.values():
                counter.launches = 0
            res = serve.run("qwen3_0_6b", full=full, device=dev, dtype="bfloat16", seed=seed, overrides=overrides,
                            repo=clone.root, commit=commit, **shape)
            launches = {counter.__name__: counter.launches for counter in kernels.values()}
            walls["serve"] = time.perf_counter() - t
            per_prefill = cfg.n_layers if device == "cuda" else 0  # the CPU runs the plain version
            if (launches["flash_attention_fwd"] != per_prefill * res.prefills
                    or any(n for name, n in launches.items() if name != "flash_attention_fwd")):
                fail(f"serving from the clone launched {launches} over {res.prefills} prefills")
            if not torch.equal(res.tokens.cpu(), want_tokens.cpu()) or not res.logits_finite:
                fail("the tokens served from the clone differ from phase 28's")
        finally:
            for sess in sessions:
                sess.close()
    print(f"gc and clone: qwen3_0_6b ({cfg.n_layers} layers) step-{step} checkpoint {commit[:12]}; wall s "
          f"{ {k: round(v, 3) for k, v in walls.items()} }, phase {time.perf_counter() - phase_t:.3f} s; "
          f"auto-repacks in phases 28 and 35-37: {len(auto_packs)} (packs before: {packs_before}, all memoized "
          f"batches' but {len(auto_packs)}); {len(loose)} loose objects ({sum(loose.values())} bytes, the fullest "
          f"shard {fullest} files, {pressure} entries with the modelled footprint of {FOOTPRINT_FILES} files) "
          f"before the killed repack, which wrote {killed_written} bytes; recover() broke "
          f"{report['locks_broken']} lock, verify() divergence {check['divergence']}, {len(commits)} commits read "
          f"back; gc(): {stats['objects_packed']} objects packed ({len(dup)} loose duplicates of the killed "
          f"repack's pack), {stats['loose_unlinked']} loose files unlinked, {stats['garbage_swept']} garbage, "
          f"chunks swept {stats.get('chunks_swept')}, cache rows evicted {stats['cache_evicted']}, "
          f"{stats['phantom_entries_purged']} modelled entries purged, {gc_written} bytes written, "
          f"{len(packs_after)} packs after; clone: {cloned} bytes copied, "
          f"{len(annexed)} annexed checkpoint files as pointers, {len(params)} params leaves "
          f"({params_bytes} bytes) fetched from remote0 ({fetched} bytes written: the annex's copy and the "
          f"worktree's); served tokens equal to "
          f"phase 28's, flash launches {launches['flash_attention_fwd']} over {res.prefills} prefills; "
          f"modelled (GPFS profile), not measured: gc {gc_modelled[0]:.6f} s and {gc_modelled[1]} metadata "
          f"operations; the probe save before gc {probe_before[0]:.6f} s, {probe_before[1]} metadata operations "
          f"{probe_before[3]}, degradation term {probe_before[2]:.6f} s; after gc {probe_after[0]:.6f} s, "
          f"{probe_after[1]} operations {probe_after[3]}, degradation term {probe_after[2]:.6f} s; "
          f"the phase {clock.total:.6f} s, {clock.meta_ops} metadata operations, {clock.bytes_read} bytes read, "
          f"{clock.bytes_written} bytes written; card: {smi}")
    return launches, res.prefills


def load_example(name: str):
    """One of the port's example scripts under examples/, as a module (its
    main() does not run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cache_controls_phase(torch, np, configs, serve, kernels: dict, dev, seed: int, repo_dir: str, commit: str,
                         *, full: bool, device: str, overrides: dict | None, smi: str):
    """Phase 39 (see the module docstring) in phase 28's repository
    ``repo_dir`` after phases 35-38, whose phase-35 serving jobs of
    ``commit`` left run-cache rows with no environment. Returns (the
    in-process serve's launches by wrapper, its prefills, the jobs'
    launches read from their committed logs, the jobs' prefills)."""
    import io
    from contextlib import redirect_stdout

    import repro_torch
    from repro_torch.core.hashing import annex_key_for_bytes
    from repro_torch.core.jobdb import JobDB
    from repro_torch.core.records import RunRecord
    from repro_torch.core.repo import REPRO_DIR, Repository
    from repro_torch.core.runcache import RunCache
    from repro_torch.core.slurm import CANCELLED
    from repro_torch.kernels import build
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    phase_t = time.perf_counter()
    libs = {p: p.stat().st_mtime_ns for p in build.BUILD_DIR.glob("*.so")}
    specs = serving_job_specs(repo_dir, commit, 3, full=full, device=device, overrides=overrides)
    # phase 35's rows: keyed with no environment
    plain_keys = RunCache(Repository(repo_dir)).execution_keys(specs)
    rows35 = JobDB(os.path.join(repo_dir, REPRO_DIR)).cache_lookup(plain_keys)
    if any(k not in rows35 for k in plain_keys):
        fail(f"phase 35 left run-cache rows for {len(rows35)} of the 3 serving specs")
    repo = Repository(repo_dir)
    # each seed's tokens.npy as phase 35 committed it: its tree entry and the annex key of its bytes
    want = [(rows35[k]["output_tree"][f"jobs/serve_{i}/tokens.npy"],
             annex_key_for_bytes(committed_bytes(repo, rows35[k]["commit_oid"], f"jobs/serve_{i}/tokens.npy")))
            for i, k in enumerate(plain_keys)]
    # what the executions are keyed on: the card and its power limit (nvidia-smi's line), torch and CUDA
    gpu, _, limit = smi.partition(", ")
    env = {"gpu": gpu, "power_limit": limit or None, "torch": torch.__version__, "cuda": torch.version.cuda}
    sessions = []

    def open_session(workers: int, **kw):
        s = repro_torch.open(repo_dir, cluster=local_cluster(repo_dir, workers), **kw)
        sessions.append(s)
        return s

    def close_all() -> None:
        """Stop every job of this phase still running, and the clusters."""
        while sessions:
            s = sessions.pop()
            for row in s.scheduler.db.open_jobs():
                if row["slurm_id"] is not None and row["slurm_id"] in s.cluster._jobs:
                    s.cluster.scancel(row["slurm_id"])
            s.close()

    atexit.register(close_all)  # also when a later step fails
    # (1)-(3) job 1's spec misses (phase 35's row has no environment); job 0's is refreshed
    s1 = open_session(2, cache_env=env)
    t_submit = time.perf_counter()
    with counting_sbatch() as sbatched:
        id1 = s1.submit(specs[1])
        id0 = s1.submit(specs[0], refresh=True)
    submit_s = time.perf_counter() - t_submit
    rows = [s1.scheduler.db.get(j) for j in (id0, id1)]
    if len(sbatched) != 2 or any(r["status"] != "scheduled" or r["slurm_id"] is None for r in rows):
        fail(f"job 1's miss and job 0's refresh made {len(sbatched)} sbatch calls, rows "
             f"{[(r['status'], r['slurm_id']) for r in rows]}")
    if rows[1]["exec_key"] == plain_keys[1] or rows[1]["exec_key"] != RunCache(s1.repo, env).execution_key(specs[1]):
        fail("job 1's execution key does not carry the environment")
    # (8) job 2's spec in a session with the run cache off, cancelled at once
    s3 = open_session(1, run_cache=False)
    tokens2 = Path(repo_dir) / "jobs/serve_2/tokens.npy"
    with counting_sbatch() as sbatched2:
        id2 = s3.submit(specs[2])
    slurm2 = s3.scheduler.db.get(id2)["slurm_id"]
    before2 = (tokens2.stat().st_mtime_ns, tokens2.stat().st_size) if tokens2.exists() else None
    t = time.perf_counter()
    cancelled = s3.cluster.scancel(slurm2)
    cancel_s = time.perf_counter() - t
    right_after = s3.cluster.sacct(slurm2)
    if len(sbatched2) != 1 or cancelled != CANCELLED or right_after != CANCELLED:
        fail(f"job 2 after {len(sbatched2)} sbatch calls: scancel returned {cancelled}, the next sacct says "
             f"{right_after}")
    # (4) while the jobs run: serve_batched_torch's function at full width, seed weights
    t_inproc = time.perf_counter()
    ex = load_example("serve_batched_torch")
    cfg = configs.get("qwen3_0_6b") if full else configs.get_smoke("qwen3_0_6b")
    b, p, g = CACHE_GEN["batch"], CACHE_GEN["prompt_len"], CACHE_GEN["gen"]
    params = init_params(T.param_defs(cfg), seed=seed, dtype=torch.bfloat16, device=dev)
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, p))
    for counter in kernels.values():
        counter.launches = 0
    with deterministic(torch):
        out = ex.serve_batched(cfg, params, prompts, g, dev)
        batched_launches = {counter.__name__: counter.launches for counter in kernels.values()}
        del params
        served = serve.run("qwen3_0_6b", full=full, device=dev, seed=seed, **CACHE_GEN).tokens
    flash = kernels["attn"].__name__
    per_prefill = cfg.n_layers if dev.type == "cuda" else 0
    if batched_launches[flash] != per_prefill or sum(batched_launches.values()) != per_prefill:
        fail(f"serve_batched_torch's one prefill launched {batched_launches}, expected {flash} {per_prefill} times")
    if not torch.equal(out["tokens"], served.cpu()):
        fail("serve_batched_torch's greedy tokens differ from serve.run's on the same weights and prompts")
    decode_ms = np.array(out["decode_s"][1:]) * 1e3
    # (5) the checkpoint campaign example, restored onto the card
    with tempfile.TemporaryDirectory() as work, redirect_stdout(io.StringIO()) as printed:
        camp = load_example("train_campaign_torch").campaign(work, dev)
    if (camp["meta_ops"] != CAMPAIGN_EXAMPLE["meta_ops"]
            or abs(camp["modelled_s"] - CAMPAIGN_EXAMPLE["modelled_s"]) > 1e-6):
        fail(f"train_campaign_torch modelled {camp['modelled_s']!r} s and {camp['meta_ops']} metadata operations; "
             f"the CPU run {CAMPAIGN_EXAMPLE}")
    restored = camp["state"]["params"]["embed"]
    if restored.device.type != dev.type:
        fail(f"train_campaign_torch restored onto {restored.device}")
    inproc_s = time.perf_counter() - t_inproc
    # (6) the two jobs, finished
    t = time.perf_counter()
    s1.wait([id0, id1], timeout=600)
    wait_s = time.perf_counter() - t
    jrows = [s1.scheduler.db.get(j) for j in (id0, id1)]
    runtimes = [s1.cluster.job_runtime(r["slurm_id"]) for r in jrows]
    t = time.perf_counter()
    results = s1.finish(job_ids=[id0, id1])
    finish_s = time.perf_counter() - t
    if [r.state for r in results] != ["COMPLETED"] * 2:
        logs = [Path(repo_dir) / f"jobs/serve_{k}" / f"log.slurm-{r['slurm_id']}.out" for k, r in enumerate(jrows)]
        fail(f"phase 39's serving jobs ended {[r.state for r in results]}; logs:\n"
             + "\n".join(p.read_text()[-3000:] for p in logs if p.exists()))
    by_job = {r.job_id: r.commit for r in results}
    jobs_launches, jobs_prefills, stages, intervals = 0, 0, [], []
    for k, row in enumerate(jrows):
        jc = by_job[row["job_id"]]
        entry = repo.entry_at(jc, f"jobs/serve_{k}/tokens.npy")
        key = annex_key_for_bytes(committed_bytes(repo, jc, f"jobs/serve_{k}/tokens.npy"))
        if (entry, key) != want[k]:
            fail(f"job {k}'s committed tokens.npy is {entry} ({key}), phase 35's {want[k]}")
        log = committed_bytes(repo, jc, f"jobs/serve_{k}/log.slurm-{row['slurm_id']}.out").decode()
        counts = json.loads(log.strip().splitlines()[-1])
        n_layers = cfg.replace(**(overrides or {})).n_layers if dev.type == "cuda" else 0
        if counts["flash_attention_fwd"] != n_layers * counts["prefills"]:
            fail(f"job {k} launched flash_attention_fwd {counts['flash_attention_fwd']} times over "
                 f"{counts['prefills']} prefills")
        jobs_launches += counts["flash_attention_fwd"]
        jobs_prefills += counts["prefills"]
        stages.append(counts["stages_s"])
        env_json = json.loads(committed_bytes(repo, jc, f"jobs/serve_{k}/slurm-job-{row['slurm_id']}.env.json"))
        intervals.append((env_json["SubmitTime"], env_json["SubmitTime"] + env_json["Elapsed"][0]))
    overlap = min(e for _, e in intervals) - max(b for b, _ in intervals)
    if overlap <= 0:
        fail(f"phase 39's jobs did not run at once: {intervals}")
    span = max(e for _, e in intervals) - min(b for b, _ in intervals)
    rebuilt = [p.name for p, m in libs.items() if p.stat().st_mtime_ns != m]
    if rebuilt or set(build.BUILD_DIR.glob("*.so")) != set(libs):
        fail(f"a phase-39 job rebuilt the kernels: {rebuilt or sorted(p.name for p in build.BUILD_DIR.glob('*.so'))}")
    # (7) job 1's spec again: memoized under the environment, and with none on phase 35's row
    with counting_sbatch() as sbatched3:
        memo_env = s1.scheduler.db.get(s1.submit(specs[1]))
        s4 = open_session(1)
        memo_plain = s4.scheduler.db.get(s4.submit(specs[1]))
        rec = RunRecord.from_message(s4.repo.objects.get_commit(s4.head())["message"])
    if (sbatched3 or [(r["status"], r["slurm_id"]) for r in (memo_env, memo_plain)] != [("memoized", None)] * 2
            or memo_env["exec_key"] != rows[1]["exec_key"] or rec.memoized_of != rows35[plain_keys[1]]["commit_oid"]):
        fail(f"job 1's spec resubmitted: {len(sbatched3)} sbatch calls, rows "
             f"{[(r['status'], r['slurm_id']) for r in (memo_env, memo_plain)]}, memoized of {rec.memoized_of}")
    # (8) the cancelled job: nothing of it appeared, and finish closes its row
    s3.cluster.wait([slurm2], timeout=60)
    closed = s3.finish(job_id=id2, close_failed_jobs=True)
    after2 = (tokens2.stat().st_mtime_ns, tokens2.stat().st_size) if tokens2.exists() else None
    log2 = Path(repo_dir) / f"jobs/serve_2/log.slurm-{slurm2}.out"
    if ([r.state for r in closed] != [CANCELLED] or s3.scheduler.db.get(id2)["status"] != "closed-cancelled"
            or after2 != before2 or (log2.exists() and "prefills" in log2.read_text())):
        fail(f"the cancelled job 2: finish {[r.state for r in closed]}, row {s3.scheduler.db.get(id2)['status']}, "
             f"tokens.npy {before2} -> {after2}")
    close_all()
    atexit.unregister(close_all)
    print(f"cache controls: cache_env {env}; job 1's spec missed phase 35's row (no environment) and job 0's was "
          f"refreshed: {len(sbatched)} sbatch calls in {submit_s:.3f} s; submit to completion {span:.3f} s, the jobs "
          f"overlapping {overlap:.3f} s; job runtimes {[round(x, 3) for x in runtimes]} s; stages (s) {stages}; "
          f"finish {finish_s:.3f} s; tokens.npy annex keys {[k for _, k in want[:2]]}, phase 35's for seeds 0 and 1; flash launches {jobs_launches} "
          f"over {jobs_prefills} prefills (committed logs); kernels not rebuilt; job 1's spec again: memoized under "
          f"the environment and, in a session with none, on phase 35's row, 0 sbatch; job 2 in a run_cache=False "
          f"session: 1 sbatch, scancel {cancel_s * 1e3:.3f} ms, the next sacct {right_after}, its tokens.npy "
          f"untouched, finish closed it; serve_batched_torch beside the two jobs ({cfg.name}, bf16, B={b} "
          f"prompt={p} gen={g}, seed {seed}): prefill {out['prefill_s'] * 1e3:.3f} ms (its first call), decode "
          f"p50 {np.percentile(decode_ms, 50):.3f} ms p95 {np.percentile(decode_ms, 95):.3f} ms, launches "
          f"{batched_launches}, tokens equal to serve.run's; train_campaign_torch: middle checkpoint restored onto "
          f"{restored.device} bit for bit, modelled (GPFS_STRIPED) {camp['modelled_s']:.6f} s and "
          f"{camp['meta_ops']} metadata operations as on the CPU, {len(printed.getvalue().splitlines())} lines "
          f"printed; this process's work beside the jobs {inproc_s:.3f} s, then {wait_s:.3f} s waiting for them; phase {time.perf_counter() - phase_t:.3f} s; card: {smi}")
    return batched_launches, 1, {flash: jobs_launches, **{n: 0 for n in batched_launches if n != flash}}, jobs_prefills


def dataplane_case(torch, dev, seed: int, work: str, finish_kw: dict, workers: int, *, n_jobs: int, files: int,
                   mib: int) -> dict:
    """One case of phase 40 in a fresh repository under ``work``: the
    finish's wall and modelled seconds, counters, CLI charges, the outputs'
    tree oid and job 0's first file read back onto ``dev``."""
    from repro_torch.core.fsio import GPFS_STRIPED, SimClock
    from repro_torch.core.repo import Repository
    from repro_torch.core.scheduler import SlurmScheduler
    from repro_torch.core.slurm import LocalSlurmCluster
    from repro_torch.core.spec import RunSpec

    clock = SimClock()
    repo = Repository.init(os.path.join(work, "repo"), profile=GPFS_STRIPED, clock=clock, annex_threshold=256)
    cluster = LocalSlurmCluster(max_workers=n_jobs, clock=clock)
    sched = SlurmScheduler(repo, cluster, cli_startup_s=0.35, ingest_workers=workers)
    charges = []
    charge = sched._charge_cli

    def counted() -> None:
        charges.append(sched.cli_startup_s)
        charge()

    sched._charge_cli = counted
    alt = os.path.join(work, "stage")
    specs = []
    for j in range(n_jobs):
        script = Path(repo.root) / "jobs" / str(j) / "slurm.sh"
        script.parent.mkdir(parents=True)
        script.write_text("#!/bin/bash\ntrue\n")
        specs.append(RunSpec(script="slurm.sh", outputs=[f"data/{j}"], pwd=f"jobs/{j}", alt_dir=alt))
    try:
        sched.submit_many(specs)
        cluster.wait(timeout=300)
        # the jobs' outputs: bf16 drawn on the card, the same stream in every case
        gen = torch.Generator(device=dev).manual_seed(seed + 40)
        source = None
        for j in range(n_jobs):
            for i in range(files):
                t = torch.randn((mib << 20) // 2, generator=gen, device=dev, dtype=torch.bfloat16)
                path = Path(alt) / "data" / str(j) / f"out_{i}.bin"
                path.parent.mkdir(parents=True, exist_ok=True)
                t.cpu().view(torch.uint8).numpy().tofile(path)
                if source is None:
                    source = t
        before = (clock.total, clock.meta_ops, clock.bytes_read, clock.bytes_written)
        t0 = time.perf_counter()
        results = sched.finish(**finish_kw)
        wall = time.perf_counter() - t0
        modelled, meta, read, written = (a - b for a, b in zip(
            (clock.total, clock.meta_ops, clock.bytes_read, clock.bytes_written), before))
    finally:
        cluster.shutdown()
    if [r.state for r in results if r.commit] != ["COMPLETED"] * n_jobs:
        fail(f"phase 40 {finish_kw} workers={workers}: finish gave {[(r.state, r.commit) for r in results]}")
    head = repo.head_commit()
    key = repo.annex_key_at("data/0/out_0.bin", head)
    back = torch.frombuffer(bytearray(repo.annex.read(key)), dtype=torch.bfloat16).to(dev)
    return {"wall_s": wall, "modelled_s": modelled, "bytes_read": read, "bytes_written": written, "meta_ops": meta,
            "cli_charges": len(charges), "cli_s": sum(charges), "tree": repo.entry_at(head, "data")["oid"],
            "bit_equal": torch.equal(back.view(torch.int16), source.view(torch.int16))}


def dataplane_phase(torch, dev, seed: int, *, smi: str, full: bool = True, shape: dict = DATAPLANE) -> dict:
    """Phase 40 (see the module docstring): the four finish cases, each in
    its own directory, removed before the next. ``full=False`` (a smoke
    shape on the CPU, where metadata outweighs bytes) holds the pipelined
    case by the bench smoke's bound (no more than the serial seconds)
    instead of the card's 0.5. Returns {case: its numbers}."""
    import shutil

    phase_t = time.perf_counter()
    cases = {}
    for name, (kw, workers) in DATAPLANE_CASES.items():
        work = tempfile.mkdtemp(prefix="dataplane-")
        try:
            cases[name] = dataplane_case(torch, dev, seed, work, kw, workers, **shape)
        finally:
            shutil.rmtree(work)
    a, b, c = cases["a legacy"], cases["b fused"], cases["c fused, 8 workers"]
    trees = {r["tree"] for r in cases.values()}
    if len(trees) != 1:
        fail(f"phase 40's four cases committed different output trees: {sorted(trees)}")
    if b["bytes_read"] > 0.6 * a["bytes_read"]:
        fail(f"phase 40: the fused plane read {b['bytes_read']} bytes, the seed plane {a['bytes_read']} (bar 0.6)")
    bar = 0.5 if full else 1.001
    if c["modelled_s"] > bar * b["modelled_s"]:
        fail(f"phase 40: 8 ingest workers modelled {c['modelled_s']!r} s, serial {b['modelled_s']!r} s (bar {bar})")
    if not all(r["bit_equal"] for r in cases.values()) or any(r["cli_charges"] != 2 for r in cases.values()):
        fail(f"phase 40: read-back bit-equal {[r['bit_equal'] for r in cases.values()]}, CLI charges "
             f"{[r['cli_charges'] for r in cases.values()]} (one submit_many, one finish)")
    n = shape["n_jobs"] * shape["files"]
    print(f"data plane ({shape['n_jobs']} jobs x {shape['files']} files x {shape['mib']} MiB of bf16 from {dev}, "
          f"GPFS_STRIPED modelled, outputs tree {trees.pop()[:12]} in every case, job 0's first file read back onto "
          f"{dev} bit for bit): "
          + "; ".join(f"({name}) finish {r['wall_s']:.3f} s wall, {r['modelled_s']!r} s modelled, "
                      f"{r['bytes_read']} B read, {r['bytes_written']} B written, {r['meta_ops']} metadata ops, "
                      f"{r['cli_charges']} CLI charges ({r['cli_s']:.2f} s)" for name, r in cases.items())
          + f"; fused reads / legacy {b['bytes_read'] / a['bytes_read']:.4f}, 8 workers / serial modelled "
          f"{c['modelled_s'] / b['modelled_s']:.4f}; {n} files a case; phase {time.perf_counter() - phase_t:.3f} s; "
          f"card: {smi}")
    return cases


def train_mfu(flops: float, p50_ms: float) -> float:
    return flops / (p50_ms / 1e3) / H100_FLOPS["bfloat16"]


def chunked_finding(torch, name: str, loop, chunked, args: list, dev) -> None:
    """Prints, as a finding and not a check, the time of one forward and
    backward through the chunked form ``chunked`` against the plain loop
    ``loop`` (the route the op's backward takes) on ``args``, and the chunked
    gradients' worst element in units of the GRAD_TOL bar."""
    def fwd_bwd(fn):
        inputs = [a.detach().clone().requires_grad_() for a in args]
        outs = fn(*inputs)
        gen = torch.Generator(device=dev).manual_seed(1)
        sum((o * torch.randn(o.shape, generator=gen, device=dev)).sum() for o in outs).backward()
        return [x.grad for x in inputs]

    fwd_bwd(chunked)  # warm-up: the loop is warm from grad_check
    got = {}
    for fn in (loop, chunked):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        grads = fwd_bwd(fn)
        torch.cuda.synchronize(dev)
        got[fn] = ((time.perf_counter() - t) * 1e3, grads)
    units = [((g - w).abs() / (GRAD_TOL + GRAD_TOL * w.abs())).max().item() for g, w in zip(got[chunked][1],
                                                                                          got[loop][1])]
    rel = max(((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got[chunked][1], got[loop][1]))
    print(f"  finding, not a check: forward and backward at {tuple(args[0].shape)} fp32 through {loop.__name__} (the "
          f"{name} op's backward route) {got[loop][0]:.3f} ms, through ssm.{chunked.__name__} {got[chunked][0]:.3f} "
          f"ms; the chunked gradients' worst element per input {[round(u, 3) for u in units]} units of the "
          f"{GRAD_TOL} bar (tol + tol |loop|), max |chunked - loop| / max |loop| over the inputs {rel:.3g}")


def train_rwkv6_phase(torch, configs, T, kernels: dict, dev, seed: int, smi: str):
    """Phase 29 (see the module docstring). Returns (launches by wrapper
    over the timed steps, steps)."""
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.kernels import costs, ops, ref
    from repro_torch.models import ssm
    from repro_torch.models.params import init_params, tree_paths
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.steps import make_grad_fn, make_train_step

    # the WKV op's gradients at the train shape, fp32
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    b, s, h, d = RWKV_SERVE_SHAPE
    r, k, v, lw = (torch.randn((b, s, h, d), generator=gen, device=dev) for _ in range(4))
    args = [r, k, v, -lw.abs() - 0.05, torch.randn((h, d), generator=gen, device=dev),
            0.3 * torch.randn((b, h, d, d), generator=gen, device=dev)]
    grad_check(torch, "ops.rwkv6", ops.rwkv6, ref.rwkv6_ref, args, 6)
    chunked_finding(torch, "WKV", ref.rwkv6_ref, ssm.rwkv6_chunked, args, dev)
    del r, k, v, lw, args
    gc.collect()
    torch.cuda.empty_cache()

    full = configs.get("rwkv6_1_6b")
    cfg = full.replace(**RWKV_TRAIN_CUTS)
    b, s = RWKV_TRAIN["batch"], RWKV_TRAIN["seq_len"]
    n_params = sum(math.prod(dd.shape) for _, dd in tree_paths(T.param_defs(cfg)))
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(T.param_defs(cfg), seed=seed, device=dev)
    opt = AdamW(lr=TRAIN_LR, moment_dtype=cfg.opt_moment_dtype)
    ds = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b, seed=seed)
    batch = {"tokens": torch.from_numpy(ds.global_batch_at(0)).to(dev)}
    params, _, losses, _, step_ms, launches = timed_steps(
        torch, make_train_step(cfg, opt), params, opt.init(params), batch, dev, kernels, RECURRENT_TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated(dev)
    p50 = statistics.median(step_ms[1:])
    flops = 6 * n_params * b * s + 3 * cfg.n_layers * costs.rwkv6_flops(b, s, cfg.n_heads, cfg.head_dim)
    print(f"train rwkv6_1_6b full width, {cfg.n_layers} of {full.n_layers} layers ({n_params} parameters), bf16 "
          f"weights, {cfg.opt_moment_dtype} moments, remat, B={b} x {s}, {RECURRENT_TRAIN_STEPS} steps on one batch "
          f"from seed {seed} (make_train_step, lr {TRAIN_LR}): step ms {[round(x, 3) for x in step_ms]}, p50 "
          f"{p50:.3f} ms over steps 2-{RECURRENT_TRAIN_STEPS}; {b * s / (p50 / 1e3):.1f} tokens/s; train_mfu "
          f"{train_mfu(flops, p50):.4f} ({flops / 1e12:.3f} TFLOP a step: 6 x parameters x tokens + 3 x "
          f"{cfg.n_layers} x the WKV products); peak memory {peak / 2**30:.3f} GiB; losses "
          f"{[round(x, 5) for x in losses]}; launches {launches} ({smi})")
    if launches != {c.__name__: 2 * cfg.n_layers * RECURRENT_TRAIN_STEPS if c is kernels["rwkv6"] else 0
                    for c in kernels.values()}:
        fail(f"rwkv6 training launched {launches}, expected rwkv6_fwd {2 * cfg.n_layers} times a step "
             f"({cfg.n_layers} forward, {cfg.n_layers} in remat's recompute) and nothing else")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"the rwkv6 loss on a repeated batch did not drop: {losses}")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    cfg2 = cfg.replace(n_layers=TRAIN_PARITY_LAYERS)
    params = init_params(T.param_defs(cfg2), seed=seed, dtype=torch.float32, device=dev)
    train_parity(torch, make_grad_fn, "rwkv6", cfg2, params, batch,
                 {kernels["rwkv6"]: 2 * TRAIN_PARITY_LAYERS, kernels["attn"]: 0, kernels["mamba"]: 0})
    del params
    return launches, RECURRENT_TRAIN_STEPS


def train_jamba_phase(torch, configs, T, kernels: dict, dev, seed: int, smi: str, plan):
    """Phase 30 (see the module docstring); ``plan`` is the dry-run's
    process planning the step, started at the device phase. Returns
    (launches by wrapper over the timed steps, steps)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import ssm

    # the Mamba op's gradients at jamba's width, fp32
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    b, s, di, st = JAMBA_GRAD_SHAPE
    u, dt, B_, C_ = (torch.randn(shape, generator=gen, device=dev) for shape in ((b, s, di), (b, s, di),
                                                                                 (b, s, st), (b, s, st)))
    args = [u, 0.1 * dt.abs(), -torch.randn((di, st), generator=gen, device=dev).abs(), B_, C_,
            0.3 * torch.randn((b, di, st), generator=gen, device=dev)]
    grad_check(torch, "ops.mamba_scan", ops.mamba_scan, ref.mamba_ref, args, 6)
    chunked_finding(torch, "Mamba", ref.mamba_ref, ssm.mamba_scan_chunked, args, dev)
    del u, dt, B_, C_, args
    gc.collect()
    torch.cuda.empty_cache()

    with deterministic(torch):  # as launch/train.py's command line runs the step
        return planned_train_steps(torch, configs, T, kernels, dev, seed, smi, plan, JAMBA, JAMBA_TRAIN_CUTS,
                                   JAMBA_TRAIN)


def start_plan(arch: str, cuts: dict, shape: dict, compress_grads: bool = False) -> subprocess.Popen:
    """A ``launch/dryrun.py --one-card`` process planning ``arch``'s train
    step with ``cuts`` at ``shape`` (batch, seq_len), with int8
    error-feedback gradients if ``compress_grads``, on meta tensors, on the
    host alone (no card, one thread); killed at exit if it still runs."""
    plan = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", "train_4k", "--one-card",
         "--batch", str(shape["batch"]), "--seq-len", str(shape["seq_len"])]
        + [a for k, v in cuts.items() for a in ("--override", f"{k}={v}")]
        + (["--compress-grads"] if compress_grads else []),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""})
    atexit.register(plan.kill)  # also on a failed phase's exit
    return plan


def read_plan(plan, arch: str) -> dict:
    """The cell that a ``launch/dryrun.py --one-card`` process printed, once
    it has ended (it fails the run if the plan failed)."""
    out, _ = plan.communicate(timeout=1200)
    cells = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    if plan.returncode != 0 or len(cells) != 1 or cells[0]["status"] != "ok":
        fail(f"the dry-run of {arch}'s train step failed: {out[-2000:]}")
    return cells[0]


def planned_train_steps(torch, configs, T, kernels: dict, dev, seed: int, smi: str, plan, arch: str, cuts: dict,
                        shape: dict, moe=None, *, compress_grads: bool = False, bf16_parity: bool = True, then=None):
    """The model work of phases 30, 41, 42 and 43: ``arch`` at full width
    with ``cuts``, bf16 weights initialised on the card, with
    ``bf16_parity`` one bf16 gradient step kernels off against on (loss
    within BF16_TOL; with ``moe``, the MoE module, the kernel-on step routed
    by the kernel-off step's experts), then RECURRENT_TRAIN_STEPS steps of
    ``make_train_step(..., compress_grads)`` on one batch of ``shape``
    (batch, seq_len): finite losses, each kernel launched twice a layer of
    its mixer a microbatch (the forward, then remat's recompute) and nothing
    else, and the measured peak within DRYRUN_PEAK_TOL or DRYRUN_PEAK_SLACK
    of the dry-run's plan of the same step (``plan``, ``launch/dryrun.py
    --one-card`` run under this torch), leaving FREE_GIB of the card free.
    ``train_mfu`` counts the active parameters (of the experts, top_k /
    n_experts). ``then(cfg, params, opt_state, batch)``, if given, runs
    after the checks, before the state is freed. Returns (launches by
    wrapper over the timed steps, steps)."""
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.kernels import costs
    from repro_torch.launch.dryrun import FREE_GIB
    from repro_torch.models.params import init_params, tree_paths
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.steps import make_grad_fn, make_train_step

    full = configs.get(arch)
    cfg = full.replace(**cuts)
    mixers = [kind.mixer for kind in cfg.pattern] * cfg.n_repeats
    n_mb = max(1, cfg.microbatches)
    per_step = {c: 2 * mixers.count(mixer) * n_mb for mixer, c in kernels.items()}
    n_params = n_expert = 0
    for path, dd in tree_paths(T.param_defs(cfg)):
        n_params += math.prod(dd.shape)
        n_expert += math.prod(dd.shape) if path.rsplit("/", 1)[-1].startswith("e_w") else 0
    n_active = n_params - n_expert + (n_expert * cfg.moe.top_k // cfg.moe.n_experts if cfg.moe else 0)
    b, s = shape["batch"], shape["seq_len"]
    base = torch.cuda.memory_allocated(dev)
    params = init_params(T.param_defs(cfg), seed=seed, device=dev)
    ds = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b, seed=seed)
    batch = {"tokens": torch.from_numpy(ds.global_batch_at(0)).to(dev)}
    loss_by, routes_by = {}, {}
    for use_pallas in ("off", "on") if bf16_parity else ():  # one bf16 gradient step, kernels off against on
        for counter in kernels.values():
            counter.launches = 0
        pin = routes_by.get("off")
        with routing(torch, moe, pin) if moe else nullcontext([]) as routes_by[use_pallas]:
            loss, aux, grads = make_grad_fn(cfg.replace(use_pallas=use_pallas))(params, batch)
        loss_by[use_pallas] = (loss.item(), aux.item())
        del grads
        got = {c.__name__: c.launches for c in kernels.values()}
        if got != {c.__name__: n if use_pallas == "on" else 0 for c, n in per_step.items()}:
            fail(f"the bf16 {arch} gradient step with use_pallas={use_pallas} launched {got}")
    depth = f"{cfg.n_layers} of {full.n_layers} layers"
    routed, fill = "", ""
    if moe:
        share, dropped = slot_fill(torch, routes_by["off"], cfg.moe)
        routed = f" (routed as kernel-off), aux loss on {loss_by['on'][1]:.6f} off {loss_by['off'][1]:.6f}"
        fill = (f"; the capacity queue fills {share:.4f} of the expert GEMMs' slots (capacity factor "
                f"{cfg.moe.capacity_factor}, the kernel-off bf16 step's routes) and drops {dropped} (token, slot) "
                f"choices of {b * s * cfg.moe.top_k} a layer")
    if bf16_parity:
        loss_err = abs(loss_by["on"][0] - loss_by["off"][0]) / abs(loss_by["off"][0])
        print(f"train parity {arch} bf16, {depth}, B={b} x {s}: loss kernel on {loss_by['on'][0]:.6f} off "
              f"{loss_by['off'][0]:.6f}, relative {loss_err:.3g} (tol {BF16_TOL}){routed}")
        if not loss_err <= BF16_TOL:
            fail(f"the kernel-on {arch} gradient step's loss disagrees with kernel-off")
    del routes_by

    planned = read_plan(plan, arch)
    opt = AdamW(lr=TRAIN_LR, moment_dtype=cfg.opt_moment_dtype)
    opt_state = opt.init(params)
    gc.collect()
    torch.cuda.reset_peak_memory_stats(dev)
    params, opt_state, losses, auxes, step_ms, launches = timed_steps(
        torch, make_train_step(cfg, opt, compress_grads), params, opt_state, batch, dev, kernels,
        RECURRENT_TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated(dev)
    measured, plan_peak = peak - base, planned["memory"]["peak_bytes"]
    total = torch.cuda.get_device_properties(dev).total_memory
    p50 = statistics.median(step_ms[1:])
    attn = (b, s, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, True, cfg.sliding_window)
    flops = 6 * n_active * b * s + 3 * mixers.count("attn") * attention_flops(attn)
    if "mamba" in mixers:
        flops += 3 * mixers.count("mamba") * costs.mamba_flops(b, s, cfg.mamba_d_inner, cfg.mamba.d_state)
    slack = max(DRYRUN_PEAK_TOL * measured, DRYRUN_PEAK_SLACK)
    counted = f"{n_active} active of {n_params}" if moe else f"{n_params}"
    aux = f"; aux losses {[round(x, 6) for x in auxes]}" if moe else ""
    mb = f" in {n_mb} microbatches of {b // n_mb}" if n_mb > 1 else ""
    ef = ", int8 error-feedback gradients" if compress_grads else ""
    print(f"train {arch}{' without experts' if full.moe and not cfg.moe else ''}, {depth} ({n_params} parameters), "
          f"bf16 weights, "
          f"{cfg.opt_moment_dtype} moments, remat, B={b} x {s}{mb}{ef}, {RECURRENT_TRAIN_STEPS} steps on one batch "
          f"(make_train_step, lr {TRAIN_LR}, deterministic algorithms): step ms {[round(x, 3) for x in step_ms]}, "
          f"p50 {p50:.3f} ms over steps 2-{RECURRENT_TRAIN_STEPS}; {b * s / (p50 / 1e3):.1f} tokens/s; train_mfu "
          f"{train_mfu(flops, p50):.4f} ({flops / 1e12:.3f} TFLOP a step: 6 x {counted} parameters x {b * s} "
          f"tokens + 3 x each mixer's FLOPs){fill}; peak memory measured {measured} B ({measured / 2**30:.3f} GiB "
          f"above the {base} B held before the init; {(total - peak) / 2**30:.3f} GiB of the card free), planned "
          f"{plan_peak} B ({plan_peak / 2**30:.3f} GiB; launch/dryrun.py --one-card under this torch, "
          f"{planned['plan_s']} s), diff {(plan_peak - measured) / 2**20:.1f} MiB (bar {slack / 2**20:.0f} MiB); "
          f"losses {[round(x, 5) for x in losses]}{aux}; launches {launches} ({smi})")
    if launches != {c.__name__: n * RECURRENT_TRAIN_STEPS for c, n in per_step.items()}:
        fail(f"{arch} training launched {launches}, expected {({c.__name__: n for c, n in per_step.items()})} a step")
    if planned["kernel_calls"] != {c.__name__: n for c, n in per_step.items() if n}:
        fail(f"the dry-run plans {planned['kernel_calls']} kernel calls a {arch} step, the card ran {per_step}")
    if not all(math.isfinite(x) for x in losses + auxes):
        fail(f"{arch} training losses {losses}, aux losses {auxes}")
    if abs(plan_peak - measured) > slack:
        fail(f"the dry-run's peak for {arch}'s train step is {plan_peak} bytes, the card's {measured}")
    if total - peak < FREE_GIB * 2**30:
        fail(f"{arch}'s train step leaves {(total - peak) / 2**30:.3f} GiB of the card free, under {FREE_GIB} GiB")
    if then is not None:
        then(cfg, params, opt_state, batch)
    del params, opt_state
    return launches, RECURRENT_TRAIN_STEPS


def train_cells_phase(torch, configs, T, kernels: dict, dev, seed: int, smi: str, plans: dict, archs: list,
                      moe=None) -> dict:
    """Phases 41 and 42 (see the module docstring): for each of ``archs``,
    the fp32 gradient step cut to TRAIN_PARITY_LAYERS kernels on against off
    (with ``moe``, routed as ``train_parity`` routes), then
    ``planned_train_steps`` at its cut in TRAIN_CELLS against its plan in
    ``plans``. Returns {arch: (launches by wrapper over the timed steps,
    steps)}."""
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.models.params import init_params
    from repro_torch.train.steps import make_grad_fn

    out = {}
    for arch in archs:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        cfg2 = configs.get(arch).replace(n_layers=TRAIN_PARITY_LAYERS, use_pallas="off")
        b, s = CELL_TRAIN["batch"], CELL_TRAIN["seq_len"]
        ds = SyntheticTokens(vocab_size=cfg2.vocab_size, seq_len=s, global_batch=b, seed=seed)
        batch = {"tokens": torch.from_numpy(ds.global_batch_at(0)).to(dev)}
        params = init_params(T.param_defs(cfg2), seed=seed, dtype=torch.float32, device=dev)
        train_parity(torch, make_grad_fn, arch, cfg2, params, batch,
                     {c: 2 * TRAIN_PARITY_LAYERS if mixer == "attn" else 0 for mixer, c in kernels.items()}, moe)
        del params, batch
        gc.collect()  # the gradient check's trees go before the init
        torch.cuda.empty_cache()
        with deterministic(torch):  # as launch/train.py's command line runs the step
            out[arch] = planned_train_steps(torch, configs, T, kernels, dev, seed, smi, plans[arch], arch,
                                            TRAIN_CELLS[arch], CELL_TRAIN, moe=moe)
    return out


def written_bytes() -> dict:
    """This process's ``wchar`` (bytes handed to write calls: files, pipes,
    its output) and ``write_bytes`` (bytes sent to a block device: none for a
    file system in memory) from /proc/self/io, its threads' included, its
    children's not; empty where there is no such file."""
    try:
        with open("/proc/self/io") as f:
            return {k: int(v) for k, v in (ln.split(": ") for ln in f) if k in ("wchar", "write_bytes")}
    except OSError:
        return {}


def host_ms(torch, dev, fn) -> float:
    """ms of ``fn()`` on the host clock, between two synchronises."""
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t) * 1e3


def train_accum_phase(torch, configs, T, kernels: dict, dev, seed: int, smi: str, plans: dict) -> dict:
    """Phase 43 (see the module docstring). ``plans`` holds the dry-run
    processes started at the device phase: qwen3's step at ACCUM_TRAIN in
    "one pass", and "accumulated" in ACCUM_CUTS' microbatches with int8
    error-feedback gradients. Returns {run name: (launches by wrapper, steps)}
    for the timed run and the resume."""
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.dryrun import FREE_GIB
    from repro_torch.models.params import init_params
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.compression import ef_compress_tree
    from repro_torch.core.repo import Repository
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.steps import accumulate_grads, make_grad_fn, make_train_step, mean_grads_bf16
    from repro_torch.tree import leaves as tree_leaves, tree_map

    arch = "qwen3_0_6b"
    cfg = configs.get(arch)
    b, s = ACCUM_TRAIN["batch"], ACCUM_TRAIN["seq_len"]
    written_before = written_bytes()
    one_pass = read_plan(plans["one pass"], arch)
    free = one_pass["free_bytes"]
    print(f"plan {arch} B={b} x {s} in one pass: planned peak {one_pass['memory']['peak_bytes'] / 2**30:.3f} GiB, "
          f"{free / 2**30:.3f} GiB of the card free (launch/dryrun.py --one-card under this torch, "
          f"{one_pass['plan_s']} s): {'fits' if free >= FREE_GIB * 2**30 else 'does not fit'}")
    if free >= FREE_GIB * 2**30:
        fail(f"{arch}'s train step at B={b} x {s} in one pass plans to fit one card, {free} bytes free")

    # fp32 at full width, 2 layers, B=16 as 2 microbatches of 8: kernels on against off, and against one pass
    pb, n_mb = ACCUM_SMALL["batch"], ACCUM_SMALL["microbatches"]
    cfg2 = cfg.replace(n_layers=TRAIN_PARITY_LAYERS, microbatches=n_mb, use_pallas="off")
    ds = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=s, global_batch=pb, seed=seed)
    batch = {"tokens": torch.from_numpy(ds.global_batch_at(0)).to(dev)}
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(T.param_defs(cfg2), seed=seed, dtype=torch.float32, device=dev)
    g_acc = train_parity(torch, make_grad_fn, f"{arch} accumulated", cfg2, params, batch,
                         {c: 2 * TRAIN_PARITY_LAYERS * n_mb if mixer == "attn" else 0 for mixer, c in kernels.items()})
    opt = AdamW(lr=TRAIN_LR)
    stepped = {}
    for n in (1, n_mb):
        p = tree_map(lambda t: t.detach().clone(), params)
        p, _, metrics = make_train_step(cfg2.replace(microbatches=n, use_pallas="on"), opt)(p, opt.init(p), batch)
        stepped[n] = (metrics["loss"].item(), p)
    loss_gap = abs(stepped[1][0] - stepped[n_mb][0])
    # (|accumulated - one pass| - (atol + rtol |one pass|)) / max |one pass| of the worst leaf: at most 0 to pass
    past = max(((a - w).abs() - MICROBATCH_PARAM_TOL * (1 + w.abs())).max().item()
               for a, w in zip(tree_leaves(stepped[n_mb][1]), tree_leaves(stepped[1][1])))
    print(f"train {arch} fp32, {cfg2.n_layers} layers, B={pb} x {s}: one AdamW step (lr {TRAIN_LR}) in {n_mb} "
          f"microbatches against one pass: loss {stepped[n_mb][0]:.6f} against {stepped[1][0]:.6f}, |diff| "
          f"{loss_gap:.3g} (bar {MICROBATCH_LOSS_TOL}); params' worst |diff| past atol + rtol |one pass| {past:.3g} "
          f"(rtol = atol = {MICROBATCH_PARAM_TOL}; at most 0 to pass)")
    if not loss_gap < MICROBATCH_LOSS_TOL or past > 0:
        fail(f"the {n_mb}-microbatch {arch} step disagrees with one pass of B={pb}")
    _, _, g32 = make_grad_fn(cfg2.replace(microbatches=1, use_pallas="on"))(params, batch)
    del params, stepped, p
    gc.collect()

    # int8 error feedback on the card against the CPU, two rounds, the residual carried
    for name, grads in ((f"the accumulated gradients ({n_mb} microbatches, bf16)", g_acc),
                        ("the one-pass gradients (fp32)", g32)):
        host = tree_map(lambda t: t.detach().cpu(), grads)
        r_dev = r_cpu = None
        t = time.perf_counter()
        for k in range(2):
            (deq_dev, r_dev), (deq_cpu, r_cpu) = ef_compress_tree(grads, r_dev), ef_compress_tree(host, r_cpu)
            for what, got, want in (("dequantised gradients", deq_dev, deq_cpu), ("residual", r_dev, r_cpu)):
                check_bit_equal(torch, f"ef_compress_tree round {k + 1} on the card, {name}, {what}",
                                {p: v.cpu() for p, v in leaves(got)}, dict(leaves(want)), torch.device("cpu"))
        ratio = {p: (r.abs().max() / g.float().abs().max()).item() for (p, r), (_, g) in zip(leaves(r_dev),
                                                                                            leaves(grads))}
        worst = max(ratio, key=ratio.get)
        print(f"ef_compress_tree on the card = the CPU, bit for bit, over 2 rounds of {name} ({len(ratio)} leaves, "
              f"{sum(v.numel() for _, v in leaves(grads))} elements; {time.perf_counter() - t:.3f} s): the "
              f"dequantised gradients and both residuals; max |residual| / max |g| per leaf after round 2: largest "
              f"{ratio[worst]:.4g} ({worst}), smallest {min(ratio.values()):.4g} (half an int8 step of the row's "
              f"max is 1/254 = {1 / 254:.4g})")
        del host, r_dev, r_cpu, deq_dev, deq_cpu
    del g_acc, g32, grads, batch
    gc.collect()
    torch.cuda.empty_cache()

    def pieces(cfg_run, params, opt_state, batch):
        """The accumulation's adds and cast and one ef_compress_tree, each alone on the step's gradients."""
        _, _, grads = make_grad_fn(cfg_run)(params, batch)
        flat = [g for _, g in leaves(grads)]
        n_el = sum(g.numel() for g in flat)
        gsum = [torch.zeros(g.shape, dtype=torch.float32, device=dev) for g in flat]
        add_ms = host_ms(torch, dev, lambda: [accumulate_grads(gsum, flat) for _ in range(cfg_run.microbatches)])
        cast_ms = host_ms(torch, dev, lambda: list(mean_grads_bf16(gsum, cfg_run.microbatches)))
        del gsum
        ef_ms = host_ms(torch, dev, lambda: ef_compress_tree(grads, opt_state["ef_residual"]))
        # bytes each must move: an add reads bf16 g and the fp32 sum and writes the sum; the cast reads the sum and
        # writes bf16; the compression reads bf16 g and the fp32 residual and writes both anew
        bound = {"add": 10 * n_el * cfg_run.microbatches, "cast": 6 * n_el, "ef": 12 * n_el}
        bound_ms = {k: v / H100_BYTES_PER_S * 1e3 for k, v in bound.items()}
        print(f"  on the step's gradients ({n_el} elements, host clock between synchronises): the accumulation's "
              f"{cfg_run.microbatches} adds into fp32 {add_ms:.3f} ms (bound {bound_ms['add']:.3f} ms, bytes), its "
              f"mean's bf16 cast {cast_ms:.3f} ms (bound {bound_ms['cast']:.3f} ms), one ef_compress_tree "
              f"{ef_ms:.3f} ms (bound {bound_ms['ef']:.3f} ms)")

    out = {}
    with deterministic(torch):
        out[f"{arch} train, B={b} x {s} in {ACCUM_CUTS['microbatches']} microbatches, int8 error feedback"] = (
            planned_train_steps(torch, configs, T, kernels, dev, seed, smi, plans["accumulated"], arch, ACCUM_CUTS,
                                ACCUM_TRAIN, compress_grads=True, bf16_parity=False, then=pieces))
    gc.collect()
    torch.cuda.empty_cache()

    # a resume across async saves through the launcher, bit for bit
    rcuts = {"n_layers": CUT_TRAIN_LAYERS, "microbatches": n_mb}
    runs, keys = {}, {}
    for counter in kernels.values():
        counter.launches = 0
    with deterministic(torch):
        for name, segments in ACCUM_RESUME.items():
            with tempfile.TemporaryDirectory() as repo_dir:
                for steps, every, async_ckpt in segments:
                    t = time.perf_counter()
                    res = launch_train.run(arch, full=True, steps=steps, ckpt_every=every, repo=repo_dir, seq_len=s,
                                           batch=pb, async_ckpt=async_ckpt, device=dev, overrides=rcuts)
                    runs[f"{name} to {steps}"] = (time.perf_counter() - t, res, async_ckpt)
                ckpt = CheckpointManager(Repository(repo_dir))
                oid, saved_step = ckpt.latest()
                manifest = json.loads(ckpt._tree_bytes(oid, f"checkpoints/step_{saved_step:08d}/manifest.json"))
                keys[name] = {p: m["key"] for p, m in manifest["leaves"].items()}
                if saved_step != segments[-1][0]:
                    fail(f"the {name} run's newest checkpoint is step {saved_step}")
    resume_launches = {c.__name__: c.launches for c in kernels.values()}
    n_steps = sum(r.end_step - r.start_step for _, r, _ in runs.values())
    rcfg = cfg.replace(**rcuts)
    want = {c.__name__: 2 * rcfg.n_layers * rcfg.microbatches * n_steps if mixer == "attn" else 0
            for mixer, c in kernels.items()}
    for run, (wall, r, async_ckpt) in runs.items():
        marks = [f"{ms:.3f}{' (a save in flight)' if busy else ''}" for ms, busy in zip(r.step_ms, r.save_in_flight)]
        print(f"  {run}: {wall:.3f} s; steps {r.start_step}->{r.end_step} ms {marks}; "
              f"{'async' if async_ckpt else 'sync'} saves {[round(x, 4) for x in r.save_s]} s blocking the loop; "
              f"losses {[round(x, 5) for x in r.losses]}")
    unbroken, first = runs["unbroken to 4"][1], runs["preempted to 3"][1]
    async_s = first.save_s + runs["preempted to 4"][1].save_s
    unequal = sorted(p for p in keys["unbroken"] if keys["preempted"].get(p) != keys["unbroken"][p])
    print(f"train resume {arch}, {rcfg.n_layers} of {cfg.n_layers} layers, B={pb} x {s} in {rcfg.microbatches} "
          f"microbatches, launch.train.run (deterministic algorithms): 4 steps with one sync save against 3 with "
          f"async saves at 2 and 3, then a new run to 4 with an async save: "
          f"{len(keys['unbroken']) - len(unequal)} of {len(keys['unbroken'])} leaf annex keys of step 4 equal; "
          f"step 3 {first.step_ms[2]:.3f} ms with the step-2 save in flight against {unbroken.step_ms[2]:.3f} ms "
          f"without; async saves blocking {[round(x * 1e3, 3) for x in async_s]} ms against the sync save's "
          f"{unbroken.save_s[0]:.3f} s; launches {resume_launches}")
    if unequal or sorted(keys["unbroken"]) != sorted(keys["preempted"]):
        fail(f"the resumed run's step-4 state differs from the unbroken run's in {unequal[:5]} ({len(unequal)} leaves)")
    if first.save_in_flight != [False, False, True]:
        fail(f"the step-2 async save was not in flight at the end of step 3: {first.save_in_flight}")
    if resume_launches != want:
        fail(f"the resumed runs launched {resume_launches}, expected {want}")
    written = written_bytes()
    print(f"this process's writes so far (/proc/self/io; its children's are not counted there): {written}; in this "
          f"phase: { {k: v - written_before[k] for k, v in written.items()} }")
    out[f"{arch} train resumed across async saves, {rcfg.n_layers} of {cfg.n_layers} layers, "
        f"{rcfg.microbatches} microbatches"] = (resume_launches, n_steps)
    return out


def unflat(flat: dict, prefix: str) -> dict:
    """The nested dict of the ``prefix``-ed paths of a flat ``{path: leaf}``."""
    root: dict = {}
    for path, v in flat.items():
        if path.startswith(prefix):
            *parents, name = path[len(prefix):].split("/")
            node = root
            for p in parents:
                node = node.setdefault(p, {})
            node[name] = v
    return root


def ckpt_subdir_phase(torch, configs, serve, kernels: dict, dev, seed: int, want_tokens, want_keys: dict | None,
                      *, full: bool = True, shape: dict = SERVE) -> tuple[dict, int]:
    """Phase 44 (see the module docstring): phase 5's qwen3 weights (at
    smoke size with ``full=False``) saved under ``CKPT_SUBDIR`` in a new
    repository, restored RESTORE_REPEATS times by a manager of each
    ``fetch_workers`` in RESTORE_WIDTHS, bit for bit, and served from the
    last restore: the greedy tokens must be ``want_tokens`` and each
    attention layer must launch the flash kernel once per prefill (on a CPU
    device, which runs the plain version, none). ``want_keys``: phase 12's
    leaf keys from its default-subdir save of the same weights, or None.
    Returns ({wrapper name: launches}, prefills)."""
    from repro_torch.core.repo import Repository
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.train.checkpoint import CheckpointManager

    cfg = configs.get("qwen3_0_6b") if full else configs.get_smoke("qwen3_0_6b")
    params = init_params(T.param_defs(cfg), seed=seed, dtype=torch.bfloat16, device=dev)
    saved = dict(leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in saved.values())
    reldir = f"{CKPT_SUBDIR}/step_00000000"
    with tempfile.TemporaryDirectory() as repo_dir:
        repo = Repository.init(repo_dir)
        t = time.perf_counter()
        oid = CheckpointManager(repo, subdir=CKPT_SUBDIR).save(0, params, {})
        save_s = time.perf_counter() - t
        outside = [p for p in repo.tree_of(oid) if not p.startswith(reldir + "/")]
        if outside:
            fail(f"phase 44: the checkpoint commit holds {outside[:3]} outside {reldir}/")
        manifest = json.loads(repo.objects.get_blob(repo.entry_at(oid, f"{reldir}/manifest.json")["oid"]))
        keys = {p: m["key"] for p, m in manifest["leaves"].items()}
        if want_keys is not None and keys != {p: k for p, k in want_keys.items() if p in keys}:
            fail("phase 44: the leaves' annex keys under the other subdir differ from phase 12's default-subdir save")
        if set(keys) != {f"params/{p}" for p in saved} or set(repo.annex.keys()) != set(keys.values()):
            fail("phase 44: the manifest and the annex do not hold exactly the saved leaves")
        restore_s: dict[int, list[float]] = {}
        for workers in RESTORE_WIDTHS:
            ckpt = CheckpointManager(Repository(repo_dir), subdir=CKPT_SUBDIR, fetch_workers=workers)
            restore_s[workers] = []
            for _ in range(RESTORE_REPEATS):
                _sync(torch, dev)
                t = time.perf_counter()
                state, got = ckpt.restore(oid, device=dev)
                _sync(torch, dev)
                restore_s[workers].append(time.perf_counter() - t)
                if got["step"] != 0:
                    fail(f"phase 44 restored step {got['step']}, saved 0")
                restored = state["params"]
                check_bit_equal(torch, f"phase 44's restore with {workers} fetch workers",
                                dict(leaves(restored)), saved, dev)
                del state
    del params, saved
    for counter in kernels.values():
        counter.launches = 0
    prompts = serve.prompt_batch(cfg, shape["batch"], shape["prompt_len"], seed, dev)["tokens"]
    tokens = pipeline_greedy(torch, cfg, restored, prompts, shape["gen"]).cpu()
    launches = {counter.__name__: counter.launches for counter in kernels.values()}
    del restored
    flash = kernels["attn"].__name__
    want_flash = cfg.n_layers if dev.type == "cuda" else 0
    if launches != {name: (want_flash if name == flash else 0) for name in launches}:
        fail(f"phase 44's prefill launched {launches}, expected {want_flash} {flash} and nothing else")
    if not torch.equal(tokens, want_tokens):
        fail(f"phase 44's greedy tokens differ from phase 5's in {int((tokens != want_tokens).sum())} of "
             f"{want_tokens.numel()} places")

    def spread(xs):
        return (f"{statistics.median(xs):.3f} s median, {min(xs):.3f}-{max(xs):.3f} s "
                f"({n_bytes / statistics.median(xs) / 1e9:.3f} GB/s)")

    print(f"checkpoint under {CKPT_SUBDIR}/: qwen3_0_6b bf16, {len(keys)} leaves, {n_bytes} bytes; save "
          f"{save_s:.3f} s; the leaves' keys those of phase 12's default-subdir save "
          f"{'(checked)' if want_keys is not None else '(not checked)'}; restores onto {dev.type}, "
          f"{RESTORE_REPEATS} each, bit for bit: "
          + "; ".join(f"fetch_workers={w}: {spread(xs)} [{', '.join(f'{x:.3f}' for x in xs)}]"
                      for w, xs in restore_s.items())
          + f"; served: greedy tokens equal phase 5's {tuple(tokens.shape)}, launches {launches}")
    return launches, 1


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_all = time.perf_counter()

    # ------------------------------------------------------------ 1. device
    t0 = phase("device")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout of the repo")
    sys.path.insert(0, str(ROOT / "src"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    # the plans of phases 30, 41, 42 and 43's train steps: meta tensors on the host, one process and one thread
    # each, beside the phases before them
    jamba_plan = start_plan(JAMBA, JAMBA_TRAIN_CUTS, JAMBA_TRAIN)
    train_plans = {arch: start_plan(arch, cuts, CELL_TRAIN) for arch, cuts in TRAIN_CELLS.items()}
    accum_plans = {"one pass": start_plan("qwen3_0_6b", {}, ACCUM_TRAIN),
                   "accumulated": start_plan("qwen3_0_6b", ACCUM_CUTS, ACCUM_TRAIN, compress_grads=True)}
    torch.cuda.set_device(dev)

    from repro_torch import configs
    from repro_torch.core.chunks import Cutter
    from repro_torch.core.repo import Repository
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.mamba import mamba_scan_fwd
    from repro_torch.kernels.rwkv6 import rwkv6_fwd
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.launch import serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params, tree_paths
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.loop import train_segment
    from repro_torch.train.steps import make_grad_fn, make_prefill_step, make_train_step

    # ------------------------------------------------------------- 2. build
    t0 = phase("build")
    build.build_all()
    ptxas = {}
    for name in build.sources():
        log = build.build_log(name)
        ptxas[name] = ptxas_report(log, "St" if name == "mamba" else "Dh")
        print(f"{name}: {log.splitlines()[0] if log else 'library already built'}; ptxas: "
              + "; ".join(ptxas[name]))
    print(f"build phase {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    grad_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)  # leaves gen's stream as it was

    def grad_inputs(*shapes):
        return [torch.randn(s, generator=grad_gen, device=dev) for s in shapes]

    # ------------------------------------------------------ 3. kernel flash
    t0 = phase("kernel flash")

    def inputs(shape, dtype):
        b, sq, sk, h, kv, d = shape[:6]
        return [torch.randn(s, generator=gen, device=dev).to(dtype)
                for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]

    flash_err = {}
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        for shape in [SERVE_SHAPE, JAMBA_ATTN_SHAPE, *NEW_SERVE_SHAPES.values()] + TEST_SHAPES + EDGE_SHAPES:
            causal, window = shape[6], shape[7]
            q, k, v = inputs(shape, dtype)
            got = flash_attention_fwd(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = check_close(torch, f"flash_attention_fwd {shape} {dtype}", got,
                              ref.attention_ref(q, k, v, causal, window), tol)
            print(f"  {str(dtype):15s} {shape}: max_abs_err {err:.3g} (tol {tol}) ok")
            if dtype == torch.bfloat16:
                flash_err[shape] = err
        # q as a head slice of a wider tensor: not contiguous, but aligned for TMA
        wb, ws, _, wh, wkv, wd = SERVE_SHAPE[:6]
        wide, k, v = inputs((wb, ws, ws, 2 * wh, wkv, wd), dtype)
        q = wide[:, :, wh:]
        got = flash_attention_fwd(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = check_close(torch, f"flash_attention_fwd strided q {dtype}", got,
                          ref.attention_ref(q, k, v, True, None), tol)
        print(f"  {str(dtype):15s} q strides {q.stride()} (a head slice): max_abs_err {err:.3g} "
              f"(tol {tol}) ok")

    b, s, h, kv, d = 2, 128, 4, 2, 64
    grad_check(torch, "ops.flash_attention", ops.flash_attention, ref.attention_ref,
               grad_inputs((b, s, h, d), (b, s, kv, d), (b, s, kv, d)) + [True, None], 3)

    def time_flash(shape) -> dict:
        """The kernel, its plain version and SDPA at a serving shape, bf16;
        with a window, SDPA takes the window's boolean mask, and where the
        window does not bind, SDPA is also timed causal without a mask
        (``library_is_causal_ms``: the same function, on SDPA's flash path)."""
        q, k, v = inputs(shape, torch.bfloat16)
        causal, window = shape[6], shape[7]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = {"is_causal": causal}
        if window is not None:
            rows = torch.arange(shape[1], device=dev)[:, None]
            cols = torch.arange(shape[2], device=dev)[None, :]
            sdpa = {"attn_mask": (cols <= rows) & (cols > rows - window)}
        bound_ms, bound_by = attention_bound_ms(shape, "bfloat16", 2)
        out = {
            "max_abs_err": flash_err[shape],
            "ms": time_ms(torch, lambda: flash_attention_fwd(q, k, v, causal=causal, window=window)),
            "host_paced_ms": time_ms(torch, lambda: flash_attention_fwd(q, k, v, causal=causal, window=window),
                                     queue_ahead=False),
            "plain_ms": time_ms(torch, lambda: ref.attention_ref(q, k, v, causal, window)),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True, **sdpa)),
        }
        if window is not None and shape[1] <= window:
            out["library_is_causal_ms"] = time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
        walk = ("causal" if causal else "non-causal") + (f", window {window}" if window else "")
        print(f"flash_attention_fwd at {shape} bf16 ({walk}): kernel {out['ms']:.4f} ms "
              f"({out['host_paced_ms']:.4f} ms a call as fast as the host issues them), plain "
              f"{out['plain_ms']:.4f} ms, SDPA {out['library_ms']:.4f} ms"
              + (f" (causal without the mask {out['library_is_causal_ms']:.4f} ms)" if window and shape[1] <= window
                 else "") + ", "
              f"bound {bound_ms:.4f} ms ({bound_by}); kernel / SDPA "
              f"{out['ms'] / out['library_ms']:.2f}, bound / kernel {bound_ms / out['ms']:.3f}; ptxas "
              + "; ".join(r for r in ptxas["flash_attention"] if r.startswith(f"bf16 wgmma Dh={shape[5]}:")))
        return out

    flash_qwen3, flash_jamba = time_flash(SERVE_SHAPE), time_flash(JAMBA_ATTN_SHAPE)
    flash_new = {key: time_flash(shape) for key, shape in NEW_SERVE_SHAPES.items()}
    gc.collect()
    torch.cuda.empty_cache()  # the long shape's plain version held ~40 GB
    print(f"kernel flash phase {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------ 4. kernel rwkv6
    t0 = phase("kernel rwkv6")

    def rwkv_inputs(shape, dtype):
        """tests/test_kernels.py's inputs: logw = -|N(0, 1)| - 0.05 in the
        dtype, u fp32, state0 ~ N(0, 0.3) fp32 (None at the ragged length)."""
        b, s, h, d = shape
        r, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3))
        logw = (-torch.randn(shape, generator=gen, device=dev).abs() - 0.05).to(dtype)
        u = torch.randn((h, d), generator=gen, device=dev)
        s0 = (0.3 * torch.randn((b, h, d, d), generator=gen, device=dev)) if s % 16 == 0 else None
        return r, k, v, logw, u, s0

    rwkv_err = None
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        dname = str(dtype).removeprefix("torch.")
        for shape in RWKV_SHAPES:
            args_ = rwkv_inputs(shape, dtype)
            out, state = rwkv6_fwd(*args_)
            torch.cuda.synchronize()
            want_out, want_state = ref.rwkv6_ref(*args_)
            err = check_close(torch, f"rwkv6_fwd out {shape} {dtype}", out, want_out, tol)
            state_err = check_close(torch, f"rwkv6_fwd state {shape} {dtype}", state, want_state,
                                    STATE_TOL[dname])
            print(f"  {str(dtype):15s} {shape}: out max_abs_err {err:.3g} (tol {tol}), state "
                  f"{state_err:.3g} (tol {STATE_TOL[dname]}) ok")
            if shape == RWKV_SERVE_SHAPE and dtype == torch.bfloat16:
                rwkv_err = err
    b, s, h, d = 2, 64, 2, 32
    r, k, v, lw, u, s0 = grad_inputs((b, s, h, d), (b, s, h, d), (b, s, h, d), (b, s, h, d), (h, d),
                                     (b, h, d, d))
    grad_check(torch, "ops.rwkv6", ops.rwkv6, ref.rwkv6_ref, [r, k, v, -lw.abs() - 0.05, u, 0.3 * s0], 6)
    args_ = rwkv_inputs(RWKV_SERVE_SHAPE, torch.bfloat16)
    rwkv_ms = time_ms(torch, lambda: rwkv6_fwd(*args_))
    rwkv_plain_ms = time_ms(torch, lambda: ref.rwkv6_ref(*args_), iters=3, warmup=1)
    rwkv_bound_ms, rwkv_bound_by = rwkv6_bound_ms(args_[0], args_[4], args_[5])
    print(f"rwkv6_fwd at {RWKV_SERVE_SHAPE} bf16: kernel {rwkv_ms:.4f} ms, plain "
          f"{rwkv_plain_ms:.4f} ms, bound {rwkv_bound_ms:.4f} ms ({rwkv_bound_by}; the products at the "
          f"CUDA cores' fp32 rate would take {rwkv6_products_fp32_ms(args_[0]):.4f} ms), bound / kernel "
          f"{rwkv_bound_ms / rwkv_ms:.3f}; no single PyTorch call computes it; ptxas "
          + "; ".join(r for r in ptxas["rwkv6"] if r.startswith(f"bf16 mma Dh={RWKV_SERVE_SHAPE[3]}:")))
    del args_
    print(f"kernel rwkv6 phase {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------- 5. serve qwen3
    t0 = phase("serve qwen3")
    all_kernels = {"attn": flash_attention_fwd, "rwkv6": rwkv6_fwd, "mamba": mamba_scan_fwd}
    cfg, qwen_res, qwen_launches = serve_phase(
        torch, serve, configs, "qwen3_0_6b", all_kernels, dev, args.seed)
    print(f"serve qwen3 phase {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------ 6. parity qwen3
    t0 = phase("parity qwen3")
    cfg32 = cfg.replace(use_pallas="off")
    params = init_params(T.param_defs(cfg32), seed=args.seed, dtype=torch.float32, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 512), generator=gen, device=dev)
    cache_len = 512 + 32
    c_off, l_off = make_prefill_step(cfg32, cache_len)(params, {"tokens": tokens})
    c_on, l_on = make_prefill_step(cfg32.replace(use_pallas="on"), cache_len)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    logit_err = (l_on - l_off).abs().max().item()
    cache_err = max((c_on["p0"][n] - c_off["p0"][n]).abs().max().item() for n in ("k", "v"))
    first_equal = all(torch.equal(c_on["p0"][n][0], c_off["p0"][n][0]) for n in ("k", "v"))
    print(f"parity qwen3 fp32 B=2 prompt=512: last logits max_abs_err {logit_err:.3g}, caches "
          f"max_abs_err {cache_err:.3g} (tol {PARITY_TOL}), layer-0 caches bit-equal {first_equal}")
    if not torch.allclose(l_on, l_off, rtol=PARITY_TOL, atol=PARITY_TOL):
        fail("kernel-on prefill logits disagree with kernel-off")
    if not first_equal or not all(
        torch.allclose(c_on["p0"][n], c_off["p0"][n], rtol=PARITY_TOL, atol=PARITY_TOL)
        for n in ("k", "v")
    ):
        fail("kernel-on prefill caches disagree with kernel-off")
    del c_off, c_on

    # bf16 reaches the tensor-core kernel: on against off, both bf16, held to
    # twice the plain path's own bf16 error against fp32 on the same weights.
    bf16_check(torch, make_prefill_step, "qwen3", cfg32, cache_len, params, {"tokens": tokens}, l_off,
               {flash_attention_fwd: cfg.n_layers})
    del params
    print(f"parity qwen3 phase {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------- 7. serve rwkv6
    t0 = phase("serve rwkv6")
    cfg, rwkv_res, rwkv_launches = serve_phase(
        torch, serve, configs, "rwkv6_1_6b", all_kernels, dev, args.seed)
    print(f"serve rwkv6 phase {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------ 8. parity rwkv6
    t0 = phase("parity rwkv6")
    cfg32 = cfg.replace(use_pallas="off")
    params = init_params(T.param_defs(cfg32), seed=args.seed, dtype=torch.float32, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 512), generator=gen, device=dev)
    c_off, l_off = make_prefill_step(cfg32, cache_len)(params, {"tokens": tokens})
    rwkv6_fwd.launches = 0
    c_on, l_on = make_prefill_step(cfg32.replace(use_pallas="on"), cache_len)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    if rwkv6_fwd.launches != cfg.n_layers:
        fail(f"kernel-on prefill launched rwkv6_fwd {rwkv6_fwd.launches} times, expected {cfg.n_layers}")
    logit_err = (l_on - l_off).abs().max().item()
    state_err = {n: (c_on["p0"][n] - c_off["p0"][n]).abs().max().item()
                 for n in ("wkv", "shift_t", "shift_c")}
    print(f"parity rwkv6 fp32 B=2 prompt=512: last logits max_abs_err {logit_err:.3g}, "
          f"max_abs_err over the {cfg.n_layers} layers: "
          + ", ".join(f"{n} {e:.3g}" for n, e in state_err.items()) + f" (tol {PARITY_TOL})")
    if not bool(torch.isfinite(l_on).all()):
        fail("kernel-on rwkv6 prefill logits are not finite")
    if not torch.allclose(l_on, l_off, rtol=PARITY_TOL, atol=PARITY_TOL):
        fail("kernel-on rwkv6 prefill logits disagree with kernel-off")
    for n in state_err:
        if not torch.allclose(c_on["p0"][n], c_off["p0"][n], rtol=PARITY_TOL, atol=PARITY_TOL):
            fail(f"kernel-on rwkv6 prefill {n} disagrees with kernel-off")
    del c_off, c_on
    bf16_check(torch, make_prefill_step, "rwkv6", cfg32, cache_len, params, {"tokens": tokens}, l_off,
               {rwkv6_fwd: cfg.n_layers})
    del params
    print(f"parity rwkv6 phase {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------ 9. kernel mamba
    t0 = phase("kernel mamba")
    gc.collect()
    torch.cuda.empty_cache()  # the earlier phases' models are gone; give their memory back

    def mamba_inputs(shape, dtype):
        """tests/test_kernels.py:133-139's inputs: u, B, C ~ N(0, 1) and
        dt = 0.1 |N(0, 1)| in the dtype, A = -|N(0, 1)| fp32, h0 ~ N(0, 0.3)
        fp32 (None at the ragged length)."""
        b, s, di, st = shape
        u = torch.randn((b, s, di), generator=gen, device=dev).to(dtype)
        dt = (0.1 * torch.randn((b, s, di), generator=gen, device=dev).abs()).to(dtype)
        A = -torch.randn((di, st), generator=gen, device=dev).abs()
        B_, C_ = (torch.randn((b, s, st), generator=gen, device=dev).to(dtype) for _ in range(2))
        h0 = 0.3 * torch.randn((b, di, st), generator=gen, device=dev) if s % 64 == 0 else None
        return u, dt, A, B_, C_, h0

    mamba_err = None
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        for shape in MAMBA_SHAPES:
            args_ = mamba_inputs(shape, dtype)
            y, h = mamba_scan_fwd(*args_)
            torch.cuda.synchronize()
            want_y, want_h = ref.mamba_ref(*args_)
            err = check_close(torch, f"mamba_scan_fwd y {shape} {dtype}", y, want_y, tol)
            h_err = check_close(torch, f"mamba_scan_fwd h {shape} {dtype}", h, want_h,
                                MAMBA_STATE_TOL)
            print(f"  {str(dtype):15s} {shape}: y max_abs_err {err:.3g} (tol {tol}), h "
                  f"{h_err:.3g} (tol {MAMBA_STATE_TOL}) ok")
            if shape == MAMBA_SERVE_SHAPE and dtype == torch.bfloat16:
                mamba_err = err
    b, s, di, st = 2, 64, 64, 8
    u, dt, A, B_, C_, h0 = grad_inputs((b, s, di), (b, s, di), (di, st), (b, s, st), (b, s, st), (b, di, st))
    grad_check(torch, "ops.mamba_scan", ops.mamba_scan, ref.mamba_ref,
               [u, 0.1 * dt.abs(), -A.abs(), B_, C_, 0.3 * h0], 6)
    # as the model calls it: B and C strided views of one projection, no h0
    u, dt, A, _, _, _ = mamba_inputs(MAMBA_SERVE_SHAPE, torch.bfloat16)
    st = MAMBA_SERVE_SHAPE[3]
    dbl = torch.randn(u.shape[:2] + (u.shape[2] // 16 + 2 * st,), generator=gen, device=dev).to(u.dtype)
    B_, C_ = dbl[..., -2 * st : -st], dbl[..., -st:]
    mamba_ms = time_ms(torch, lambda: mamba_scan_fwd(u, dt, A, B_, C_))
    mamba_plain_ms = time_ms(torch, lambda: ref.mamba_ref(u, dt, A, B_, C_), iters=3, warmup=1)
    mamba_bound, mamba_bound_by = mamba_bound_ms(u, A, B_)
    print(f"mamba_scan_fwd at {MAMBA_SERVE_SHAPE} bf16, B and C strided, no h0: kernel "
          f"{mamba_ms:.4f} ms, plain {mamba_plain_ms:.4f} ms, bound {mamba_bound:.4f} ms "
          f"({mamba_bound_by}), bound / kernel {mamba_bound / mamba_ms:.3f}; no single PyTorch call "
          f"computes it; ptxas " + "; ".join(r for r in ptxas["mamba"] if r.startswith(f"bf16 exp2 St={st}:")))
    del u, dt, A, B_, C_, dbl, args_
    print(f"kernel mamba phase {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------- 10. serve jamba
    t0 = phase("serve jamba")
    torch.cuda.empty_cache()
    cfg, jamba_res, jamba_launches = serve_phase(
        torch, serve, configs, JAMBA, all_kernels, dev, args.seed, overrides=JAMBA_CUTS)
    print(f"serve jamba phase {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------ 11. parity jamba
    t0 = phase("parity jamba")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg32 = cfg.replace(use_pallas="off", n_layers=len(cfg.pattern))
    params = init_params(T.param_defs(cfg32), seed=args.seed, dtype=torch.float32, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 512), generator=gen, device=dev)
    c_off, l_off = make_prefill_step(cfg32, cache_len)(params, {"tokens": tokens})
    for counter in all_kernels.values():
        counter.launches = 0
    c_on, l_on = make_prefill_step(cfg32.replace(use_pallas="on"), cache_len)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    n_mamba = sum(kind.mixer == "mamba" for kind in cfg32.pattern)
    if (mamba_scan_fwd.launches, flash_attention_fwd.launches) != (n_mamba, cfg32.n_layers - n_mamba):
        fail(f"kernel-on jamba prefill launched mamba_scan_fwd {mamba_scan_fwd.launches} and "
             f"flash_attention_fwd {flash_attention_fwd.launches} times, expected "
             f"{n_mamba} and {cfg32.n_layers - n_mamba}")
    logit_err = (l_on - l_off).abs().max().item()
    state_err: dict[str, float] = {}
    for key, layer in zip(c_off, cfg32.pattern):
        for n in c_off[key]:
            err = (c_on[key][n] - c_off[key][n]).abs().max().item()
            state_err[n] = max(state_err.get(n, 0.0), err)
            if not torch.allclose(c_on[key][n], c_off[key][n], rtol=PARITY_TOL, atol=PARITY_TOL):
                fail(f"kernel-on jamba prefill {key}/{n} ({layer.mixer}) disagrees with kernel-off")
    print(f"parity jamba fp32 {cfg32.n_layers} layers B=2 prompt=512: last logits max_abs_err "
          f"{logit_err:.3g}, max_abs_err over the layers: "
          + ", ".join(f"{n} {e:.3g}" for n, e in state_err.items()) + f" (tol {PARITY_TOL}); "
          f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    if set(state_err) != {"h", "conv", "k", "v"}:
        fail(f"jamba prefill caches hold {sorted(state_err)}, expected h, conv, k, v")
    if not bool(torch.isfinite(l_on).all()):
        fail("kernel-on jamba prefill logits are not finite")
    if not torch.allclose(l_on, l_off, rtol=PARITY_TOL, atol=PARITY_TOL):
        fail("kernel-on jamba prefill logits disagree with kernel-off")
    del c_off, c_on
    torch.cuda.empty_cache()
    bf16_check(torch, make_prefill_step, f"jamba {cfg32.n_layers} layers", cfg32, cache_len, params,
               {"tokens": tokens}, l_off, {mamba_scan_fwd: n_mamba, flash_attention_fwd: cfg32.n_layers - n_mamba})
    del params
    print(f"parity jamba phase {time.perf_counter() - t0:.1f} s")

    # -------------------------------------------------- 12. checkpoint qwen3
    t0 = phase("checkpoint qwen3")
    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.get("qwen3_0_6b")
    params = init_params(T.param_defs(cfg), seed=args.seed, dtype=torch.bfloat16, device=dev)
    saved = dict(leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in saved.values())
    with tempfile.TemporaryDirectory() as repo_dir:
        ckpt = CheckpointManager(Repository.init(repo_dir))
        torch.cuda.synchronize()
        t = time.perf_counter()
        oid = ckpt.save(1, params, {})
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        state, manifest = ckpt.restore(device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        check_bit_equal(torch, "restored qwen3_0_6b params", dict(leaves(state["params"])), saved, dev)
        keys = {m["key"] for m in manifest["leaves"].values()}
        default_subdir_keys = {p: m["key"] for p, m in manifest["leaves"].items()}  # phase 44 holds its keys to these
        if set(ckpt.repo.annex.keys()) != keys:
            fail("the annex does not hold exactly the keys the checkpoint manifest names")
        if ckpt.repo.entry_at(oid, "checkpoints/step_00000001/manifest.json")["t"] != "blob":
            fail("the checkpoint manifest is not a blob of the commit")
        del state
        t = time.perf_counter()
        host_state, _ = ckpt.restore(device="cpu")
        host_s = time.perf_counter() - t
        t = time.perf_counter()
        on_card = {p: v.to(dev) for p, v in leaves(host_state["params"])}
        torch.cuda.synchronize()
        h2d_s = time.perf_counter() - t
        check_bit_equal(torch, "host-restored qwen3_0_6b params", on_card, saved, dev)
        del host_state, on_card

        def rate(sec):
            return f"{sec:.3f} s, {n_bytes / sec / 1e9:.3f} GB/s"

        print(f"checkpoint qwen3_0_6b bf16: {len(saved)} leaves, {n_bytes} bytes, {len(keys)} annex keys "
              f"(identical leaves share one; the manifest is a blob); restored bit for bit. save ({rate(save_s)}: "
              f"device-to-host copy, sha256, write, commit); restore onto the card ({rate(restore_s)}), of which "
              f"host read and verify ({rate(host_s)}, restore to the CPU) and host-to-device ({rate(h2d_s)})")
        cfg, ckpt_res, ckpt_launches = serve_phase(
            torch, serve, configs, "qwen3_0_6b", all_kernels, dev, args.seed, repo=repo_dir)
    if ckpt_res.checkpoint_step != 1:
        fail(f"served checkpoint step {ckpt_res.checkpoint_step}, expected 1")
    if not torch.equal(ckpt_res.tokens, qwen_res.tokens):
        again = [serve.run("qwen3_0_6b", full=True, device=dev, dtype="bfloat16", seed=args.seed, **SERVE).tokens
                 for _ in range(2)]
        fail(f"greedy tokens served from the checkpoint differ from phase 5's in "
             f"{int((ckpt_res.tokens != qwen_res.tokens).sum())} of {qwen_res.tokens.numel()} places; two more "
             f"serves of the seed weights: equal to each other {torch.equal(*again)}, to phase 5's "
             f"{torch.equal(again[0], qwen_res.tokens)}")
    print(f"greedy tokens served from the checkpoint commit equal phase 5's ({tuple(qwen_res.tokens.shape)})")
    del params, saved
    print(f"checkpoint qwen3 phase {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------ 13. checkpoint chunked
    t0 = phase("checkpoint chunked")
    n = CHUNKED_LEAF_BYTES // 2
    n_changed = int(n * CHANGED_SHARE)
    first = torch.randn(n, generator=gen, device=dev).to(torch.bfloat16)
    second = first.clone()
    second[n // 3 : n // 3 + n_changed] = torch.randn(n_changed, generator=gen, device=dev).to(torch.bfloat16)
    with tempfile.TemporaryDirectory() as repo_dir:
        repo = Repository.init(repo_dir, chunk_threshold=CHUNK_THRESHOLD)
        ckpt = CheckpointManager(repo)
        written, save_s, oids = [], [], []
        for step, w in ((1, first), (2, second)):
            before = {k for k in repo.annex.keys() if k.startswith("SHA256C-")}
            t = time.perf_counter()
            oids.append(ckpt.save(step, {"w": w}, {}))
            save_s.append(time.perf_counter() - t)
            written.append(len({k for k in repo.annex.keys() if k.startswith("SHA256C-")} - before))
            if not repo.entry_at(oids[-1], f"checkpoints/step_{step:08d}/params.w.npy").get("chunked"):
                fail(f"the {CHUNKED_LEAF_BYTES}-byte leaf of step {step} was not stored chunked")
        restore_s = []
        for oid, w in zip(oids, (first, second)):
            t = time.perf_counter()
            state, _ = ckpt.restore(oid, device=dev)
            torch.cuda.synchronize()
            restore_s.append(time.perf_counter() - t)
            check_bit_equal(torch, f"chunked leaf of {oid[:12]}", {"w": state["params"]["w"]}, {"w": w}, dev)
        data = first.view(torch.int16).cpu().numpy().tobytes()
        cutter = Cutter(repo._chunk_params)
        t = time.perf_counter()
        n_cut = sum(len(cutter.feed(data[i : i + (1 << 20)])) for i in range(0, len(data), 1 << 20))
        n_cut += len(cutter.finish())
        cut_s = time.perf_counter() - t
    allowed = 2 * int(written[0] * CHANGED_SHARE + 1) + 4
    print(f"checkpoint chunked: one {CHUNKED_LEAF_BYTES}-byte bf16 leaf, chunk threshold {CHUNK_THRESHOLD}: "
          f"save 1 wrote {written[0]} chunks in {save_s[0]:.3f} s; save 2, {CHANGED_SHARE:.0%} of the bytes "
          f"changed in one run, wrote {written[1]} new chunks ({written[1] / written[0]:.2%}; bar {allowed}) in "
          f"{save_s[1]:.3f} s; restores {restore_s[0]:.3f} s and {restore_s[1]:.3f} s, bit for bit; the cutter "
          f"alone cuts {len(data) / cut_s / 1e6:.1f} MB/s on this host ({n_cut} chunks, 1 MiB blocks)")
    if not 0 < written[1] <= allowed:
        fail(f"the second save wrote {written[1]} new chunks, expected 1..{allowed}")
    del first, second, data
    print(f"checkpoint chunked phase {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------ 14. train qwen3
    t0 = phase("train qwen3")
    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.get("qwen3_0_6b")
    n_params = sum(math.prod(d.shape) for _, d in tree_paths(T.param_defs(cfg)))
    steps, b, s = TRAIN["steps"], TRAIN["batch"], TRAIN["seq_len"]
    for counter in all_kernels.values():
        counter.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as repo_dir:
        train_res = launch_train.run("qwen3_0_6b", full=True, steps=steps, ckpt_every=steps, repo=repo_dir,
                                     seq_len=s, batch=b, device=dev)
        train_launches = {counter.__name__: counter.launches for counter in all_kernels.values()}
        train_peak = torch.cuda.max_memory_allocated(dev)
        ckpt = CheckpointManager(Repository(repo_dir))
        oid, saved_step = ckpt.latest()
        manifest = json.loads(ckpt._tree_bytes(oid, f"checkpoints/step_{saved_step:08d}/manifest.json"))
    itemsize = {"bfloat16": 2, "float32": 4, "int32": 4}
    state_bytes = {kind: sum(math.prod(m["shape"]) * itemsize[m["dtype"]] for p, m in manifest["leaves"].items()
                             if p.startswith(prefix))
                   for kind, prefix in (("params", "params/"), ("m", "opt_state/m/"), ("v", "opt_state/v/"),
                                        ("step", "opt_state/step"))}
    state_total = sum(state_bytes.values())
    flash_per_step = 2 * cfg.n_layers  # the forward, then remat's recompute in the backward
    timed = train_res.step_ms[1:]
    p50, p95 = float(np.percentile(timed, 50)), float(np.percentile(timed, 95))
    tokens = b * s
    attn_shape = (b, s, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, True, cfg.sliding_window)
    train_flops = 6 * n_params * tokens + 3 * cfg.n_layers * attention_flops(attn_shape)
    print(f"train qwen3_0_6b bf16 weights, fp32 moments, remat, B={b} x {s}, {steps} steps from seed 0 "
          f"(launch.train.run, cosine lr): step p50 {p50:.3f} ms p95 {p95:.3f} ms over steps 2-{steps} "
          f"(step 1 {train_res.step_ms[0]:.3f} ms); {tokens / (float(np.mean(timed)) / 1e3):.1f} tokens/s; "
          f"train_mfu {train_mfu(train_flops, p50):.4f} at p50 ({train_flops / 1e12:.3f} TFLOP a step: 6 x {n_params} x {tokens} "
          f"+ 3 x {cfg.n_layers} x {attention_flops(attn_shape) / 1e9:.3f} GFLOP causal attention; dense bf16 "
          f"peak {H100_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s); peak memory {train_peak / 2**30:.3f} GiB; "
          f"losses {[round(x, 5) for x in train_res.losses]}; save of the train state ({state_total} bytes: "
          f"{state_bytes}) {train_res.save_s[0]:.3f} s, {state_total / train_res.save_s[0] / 1e9:.3f} GB/s; "
          f"launches {train_launches}")
    if train_launches["flash_attention_fwd"] != flash_per_step * steps or any(
            n for name, n in train_launches.items() if name != "flash_attention_fwd"):
        fail(f"training launched {train_launches}, expected flash_attention_fwd {flash_per_step} times a step "
             f"({cfg.n_layers} forward, {cfg.n_layers} in remat's recompute) and nothing else")
    if not all(math.isfinite(x) for x in train_res.losses) or len(train_res.losses) != steps:
        fail(f"training losses {train_res.losses}")
    if saved_step != steps or state_bytes["params"] != 2 * n_params or state_bytes["step"] != 4:
        fail(f"checkpoint of step {saved_step} holds {state_bytes}")

    # the same batch 5 times: the loss must drop (tests/test_archs.py:65-77)
    params = init_params(T.param_defs(cfg), seed=args.seed, device=dev)
    opt = AdamW(lr=TRAIN_LR, moment_dtype=cfg.opt_moment_dtype)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt)
    ds = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b, seed=args.seed)
    batch = {"tokens": torch.from_numpy(ds.global_batch_at(0)).to(dev)}
    fixed = []
    for _ in range(5):
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        fixed.append(float(metrics["loss"]))
    print(f"train qwen3_0_6b on one fixed batch, lr {TRAIN_LR}: losses {[round(x, 5) for x in fixed]}")
    if not all(math.isfinite(x) for x in fixed) or not fixed[-1] < fixed[0]:
        fail(f"the loss on a repeated batch did not drop: {fixed}")
    del params, opt_state, step_fn, metrics
    gc.collect()
    torch.cuda.empty_cache()

    # one fp32 step at full width, 2 layers: kernel on against off
    cfg2 = cfg.replace(n_layers=TRAIN_PARITY_LAYERS)
    params = init_params(T.param_defs(cfg2), seed=args.seed, dtype=torch.float32, device=dev)
    train_parity(torch, make_grad_fn, "qwen3", cfg2, params, batch,
                 {flash_attention_fwd: 2 * TRAIN_PARITY_LAYERS, rwkv6_fwd: 0, mamba_scan_fwd: 0})
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # preemption and resume, bit for bit
    n_all, n_cut = PREEMPT
    rcfg = cfg.replace(n_layers=CUT_TRAIN_LAYERS)
    keys, det = [], {}
    with deterministic(torch):
        for name, segments in (("unbroken", [(n_all, n_all)]), ("preempted", [(n_cut, n_cut), (n_all, n_cut)])):
            with tempfile.TemporaryDirectory() as repo_dir:
                repo = Repository.init(repo_dir)
                for n, every in segments:
                    t = time.perf_counter()
                    r = train_segment(repo, rcfg, ds, n_steps=n, ckpt_every=every, seed=args.seed, device=dev)
                    det[f"{name} to {n}"] = (time.perf_counter() - t, r)
                ckpt = CheckpointManager(repo)
                oid, saved_step = ckpt.latest()
                manifest = json.loads(ckpt._tree_bytes(oid, f"checkpoints/step_{saved_step:08d}/manifest.json"))
                keys.append({p: m["key"] for p, m in manifest["leaves"].items()})
                if saved_step != n_all:
                    fail(f"the {name} run's newest checkpoint is step {saved_step}")
    unequal = sorted(p for p in keys[0] if keys[1].get(p) != keys[0][p])
    for run, (wall, r) in det.items():
        print(f"  deterministic {run}: {wall:.3f} s; steps {r.start_step}->{r.end_step} "
              f"{[round(x, 3) for x in r.step_ms]} ms, saves {[round(x, 3) for x in r.save_s]} s, losses "
              f"{[round(x, 5) for x in r.losses]}")
    resumed_wall, resumed = det[f"preempted to {n_all}"]
    print(f"train resume qwen3_0_6b, {rcfg.n_layers} of {cfg.n_layers} layers: {n_all} steps unbroken against "
          f"{n_cut}, a new train_segment, {n_all - n_cut} "
          f"more (deterministic algorithms): {len(keys[0]) - len(unequal)} of {len(keys[0])} leaf annex keys of "
          f"step {n_all} equal; the resumed segment's restore and set-up "
          f"{resumed_wall - sum(resumed.step_ms) / 1e3 - sum(resumed.save_s):.3f} s")
    if unequal or sorted(keys[0]) != sorted(keys[1]):
        fail(f"the resumed run's step-{n_all} state differs from the unbroken run's in {unequal[:5]} "
             f"({len(unequal)} leaves)")
    print(f"train qwen3 phase {time.perf_counter() - t0:.1f} s")

    # --------------------------------------------------- 15. serve seamless
    t0 = phase("serve seamless")
    gc.collect()
    torch.cuda.empty_cache()
    cfg, seamless_res, seamless_launches = serve_phase(
        torch, serve, configs, SEAMLESS, all_kernels, dev, args.seed)
    print(f"serve seamless phase {time.perf_counter() - t0:.1f} s")

    # -------------------------------------------------- 16. parity seamless
    t0 = phase("parity seamless")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg32 = cfg.replace(use_pallas="off")
    params = init_params(T.param_defs(cfg32), seed=args.seed, dtype=torch.float32, device=dev)
    batch = serve.prompt_batch(cfg32, 2, 512, args.seed + 1, dev)
    l_off = prefill_parity(torch, make_prefill_step, "seamless", cfg32, cache_len, params, batch,
                           flash_attention_fwd, cfg32.n_enc_layers + cfg32.n_layers)
    print(f"  encoder frames {tuple(batch['encoder_embeds'].shape)}; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    bf16_check(torch, make_prefill_step, "seamless", cfg32, cache_len, params, batch, l_off,
               {flash_attention_fwd: cfg32.n_enc_layers + cfg32.n_layers})
    del params, batch
    print(f"parity seamless phase {time.perf_counter() - t0:.1f} s")

    # --------------------------------------------------- 17. serve qwen2-vl
    t0 = phase("serve qwen2-vl")
    gc.collect()
    torch.cuda.empty_cache()
    cfg, qwen2vl_res, qwen2vl_launches = serve_phase(
        torch, serve, configs, QWEN2_VL, all_kernels, dev, args.seed)
    print(f"serve qwen2-vl phase {time.perf_counter() - t0:.1f} s")

    # -------------------------------------------------- 18. parity qwen2-vl
    t0 = phase("parity qwen2-vl")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg32 = cfg.replace(use_pallas="off", n_layers=QWEN2_VL_PARITY_LAYERS)
    params = init_params(T.param_defs(cfg32), seed=args.seed, dtype=torch.float32, device=dev)
    batch = serve.prompt_batch(cfg32, 2, 512, args.seed + 1, dev)
    n_vision = batch["vision_embeds"].shape[1]
    batch["positions3"] = mrope_positions(torch, 2, 512, n_vision, VISION_GRID, dev)
    if len({tuple(p.tolist()) for p in batch["positions3"][:, 0, :n_vision]}) != 3:
        fail("the three M-RoPE streams of the vision positions are not distinct")
    l_off = prefill_parity(torch, make_prefill_step, "qwen2-vl", cfg32, cache_len, params, batch,
                           flash_attention_fwd, cfg32.n_layers)
    print(f"  depth cut from {cfg.n_layers} to {cfg32.n_layers} layers; {n_vision} vision positions (t=0, h and w "
          f"on a {VISION_GRID}x{VISION_GRID} grid), text from "
          f"{int(batch['positions3'][0, 0, n_vision])}; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    bf16_check(torch, make_prefill_step, f"qwen2-vl {cfg32.n_layers} layers", cfg32, cache_len, params, batch,
               l_off, {flash_attention_fwd: cfg32.n_layers})
    del params, batch
    print(f"parity qwen2-vl phase {time.perf_counter() - t0:.1f} s")

    # --------------------------------------------------- 19. serve mixtral
    t0 = phase("serve mixtral")
    gc.collect()
    torch.cuda.empty_cache()
    cfg, mixtral_res, mixtral_launches = serve_phase(
        torch, serve, configs, MIXTRAL, all_kernels, dev, args.seed, overrides=MIXTRAL_CUTS)
    print(f"serve mixtral phase {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------- 20. serve mixtral long
    t0 = phase("serve mixtral long")
    gc.collect()
    torch.cuda.empty_cache()
    _, long_res, long_launches = serve_phase(
        torch, serve, configs, MIXTRAL, all_kernels, dev, args.seed, overrides=MIXTRAL_CUTS, shape=LONG_SERVE)
    ring = min(LONG_SERVE["prompt_len"] + LONG_SERVE["gen"], cfg.sliding_window)
    print(f"  the KV cache holds {ring} slots a layer for {LONG_SERVE['prompt_len']} + {LONG_SERVE['gen']} "
          f"positions: the ring wrapped in prefill and in decode")
    print(f"serve mixtral long phase {time.perf_counter() - t0:.1f} s")

    # --------------------------------------------------- 21. parity mixtral
    t0 = phase("parity mixtral")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg32 = cfg.replace(use_pallas="off", n_layers=MIXTRAL_PARITY_LAYERS)
    params = init_params(T.param_defs(cfg32), seed=args.seed, dtype=torch.float32, device=dev)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 512), generator=gen, device=dev)}
    moe_parity(torch, moe, make_prefill_step, "mixtral", f"{cfg32.n_layers} of {configs.get(MIXTRAL).n_layers} layers",
               cfg32, cache_len, params, batch, {flash_attention_fwd: cfg32.n_layers}, {"k", "v"})
    del params, batch
    print(f"parity mixtral phase {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------- 22. serve arctic
    t0 = phase("serve arctic")
    gc.collect()
    torch.cuda.empty_cache()
    cfg, arctic_res, arctic_launches = serve_phase(
        torch, serve, configs, ARCTIC, all_kernels, dev, args.seed, overrides=ARCTIC_CUTS)
    print(f"serve arctic phase {time.perf_counter() - t0:.1f} s")

    # --------------------------------------------------- 23. parity arctic
    t0 = phase("parity arctic")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg32 = cfg.replace(use_pallas="off")
    params = init_params(T.param_defs(cfg32), seed=args.seed, dtype=torch.float32, device=dev)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 512), generator=gen, device=dev)}
    moe_parity(torch, moe, make_prefill_step, "arctic", f"{cfg32.n_layers} of {configs.get(ARCTIC).n_layers} layers",
               cfg32, cache_len, params, batch, {flash_attention_fwd: cfg32.n_layers}, {"k", "v"})
    del params, batch
    print(f"parity arctic phase {time.perf_counter() - t0:.1f} s")

    # --------------------------------------------- 24. serve jamba experts
    t0 = phase("serve jamba experts")
    gc.collect()
    torch.cuda.empty_cache()
    jamba_moe = configs.get(JAMBA).moe
    cfg, jamba_moe_res, jamba_moe_launches = serve_phase(
        torch, serve, configs, JAMBA, all_kernels, dev, args.seed,
        overrides={"n_layers": JAMBA_MOE_LAYERS, "moe": dataclasses.replace(jamba_moe, n_experts=JAMBA_MOE_EXPERTS)})
    print(f"serve jamba experts phase {time.perf_counter() - t0:.1f} s")

    # -------------------------------------------- 25. parity jamba experts
    t0 = phase("parity jamba experts")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg32 = cfg.replace(use_pallas="off", moe=dataclasses.replace(jamba_moe, n_experts=JAMBA_MOE_PARITY_EXPERTS))
    params = init_params(T.param_defs(cfg32), seed=args.seed, dtype=torch.float32, device=dev)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 512), generator=gen, device=dev)}
    n_mamba = sum(kind.mixer == "mamba" for kind in cfg32.pattern)
    moe_parity(torch, moe, make_prefill_step, "jamba experts",
               f"{cfg32.n_layers} of {configs.get(JAMBA).n_layers} layers, {cfg32.moe.n_experts} of "
               f"{jamba_moe.n_experts} experts", cfg32, cache_len, params, batch,
               {mamba_scan_fwd: n_mamba, flash_attention_fwd: cfg32.n_layers - n_mamba}, {"h", "conv", "k", "v"})
    del params, batch
    print(f"parity jamba experts phase {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------- 26. sharded qwen3
    t0 = phase("sharded qwen3")
    gc.collect()
    torch.cuda.empty_cache()
    sharded_launches, sharded_prefills, sharded_train_launches, seq_launches = sharded_phase(
        torch, np, configs, T, all_kernels, dev, args.seed, qwen_res)
    print(f"sharded qwen3 phase {time.perf_counter() - t0:.1f} s")

    # --------------------------------------------------------- 28. campaign
    t0 = phase("campaign")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as campaign_dir:
        campaign_train_launches, campaign_steps, campaign_serve_launches, campaign_prefills, last, campaign_tokens = (
            campaign_phase(torch, np, configs, serve, all_kernels, dev, args.seed, campaign_dir))
        print(f"campaign phase {time.perf_counter() - t0:.1f} s")
        # phase 35's jobs serve the step-8 checkpoint while phase 27, which times no work on the card, plans
        jobs = ServingJobs(campaign_dir, last)

        # ------------------------------------------------------- 27. dryrun
        t0 = phase("dryrun")
        gc.collect()
        torch.cuda.empty_cache()
        dryrun_phase(torch, np, configs, T, all_kernels, dev, args.seed)
        print(f"dryrun phase {time.perf_counter() - t0:.1f} s")

        # ----------------------------------------- 35. jobs, in phase 28's repository
        t0 = phase("jobs")
        gc.collect()
        torch.cuda.empty_cache()
        jobs_launches, jobs_prefills = jobs.finish(torch, np, serve, dev, smi)
        print(f"jobs phase {time.perf_counter() - t0:.1f} s")

        # -------------------------------------- 36. pipeline, in phase 28's repository
        t0 = phase("pipeline")
        gc.collect()
        torch.cuda.empty_cache()
        pipe_launches, pipe_prefills = pipeline_phase(torch, np, configs, campaign_dir, last, args.seed, full=True,
                                                      device="cuda", overrides=CAMPAIGN_CUTS, smi=smi)
        print(f"pipeline phase {time.perf_counter() - t0:.1f} s")

        # ---------------------------------- 37. remote sites, in phase 28's repository
        t0 = phase("remote sites")
        gc.collect()
        torch.cuda.empty_cache()
        remote_launches, remote_prefills = remote_phase(torch, np, configs, serve, all_kernels, dev, args.seed,
                                                        campaign_dir, last, campaign_tokens, full=True,
                                                        device="cuda", overrides=CAMPAIGN_CUTS, smi=smi)
        print(f"remote sites phase {time.perf_counter() - t0:.1f} s")

        # ----------------------------------- 38. gc and clone, in phase 28's repository
        t0 = phase("gc and clone")
        gc.collect()
        torch.cuda.empty_cache()
        clone_launches, clone_prefills = gc_clone_phase(torch, configs, serve, all_kernels, dev, args.seed,
                                                        campaign_dir, last, campaign_tokens, full=True,
                                                        device="cuda", overrides=CAMPAIGN_CUTS, smi=smi)
        print(f"gc and clone phase {time.perf_counter() - t0:.1f} s")

        # ------------------------------- 39. cache controls, in phase 28's repository
        t0 = phase("cache controls")
        gc.collect()
        torch.cuda.empty_cache()
        batched_launches, batched_prefills, cache_jobs_launches, cache_jobs_prefills = cache_controls_phase(
            torch, np, configs, serve, all_kernels, dev, args.seed, campaign_dir, last, full=True, device="cuda",
            overrides=CAMPAIGN_CUTS, smi=smi)
        print(f"cache controls phase {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------ 40. data plane
    t0 = phase("data plane")
    dataplane_phase(torch, dev, args.seed, smi=smi)
    print(f"data plane phase {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------ 29. train rwkv6
    t0 = phase("train rwkv6")
    gc.collect()
    torch.cuda.empty_cache()
    rwkv_train_launches, rwkv_train_steps = train_rwkv6_phase(torch, configs, T, all_kernels, dev, args.seed, smi)
    print(f"train rwkv6 phase {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------ 30. train jamba
    t0 = phase("train jamba")
    gc.collect()
    torch.cuda.empty_cache()
    jamba_train_launches, jamba_train_steps = train_jamba_phase(torch, configs, T, all_kernels, dev, args.seed, smi,
                                                                jamba_plan)
    print(f"train jamba phase {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------- 31-33. serve phi3, granite, internlm2
    dense = {}
    for arch, label in zip(DENSE, ("phi3", "granite", "internlm2")):
        t0 = phase(f"serve {label}")
        gc.collect()
        torch.cuda.empty_cache()
        cfg, res, launches = serve_phase(torch, serve, configs, arch, all_kernels, dev, args.seed)
        dense[arch] = (launches, res.prefills, "prefill")
        del res
        print(f"serve {label} phase {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------- 34. parity dense
    t0 = phase("parity dense")
    for arch in DENSE:
        gc.collect()
        torch.cuda.empty_cache()
        cfg32 = configs.get(arch).replace(use_pallas="off", n_layers=DENSE_PARITY_LAYERS)
        params = init_params(T.param_defs(cfg32), seed=args.seed, dtype=torch.float32, device=dev)
        batch = {"tokens": torch.randint(0, cfg32.vocab_size, (2, 512), generator=gen, device=dev)}
        l_off = prefill_parity(torch, make_prefill_step, arch, cfg32, cache_len, params, batch,
                               flash_attention_fwd, cfg32.n_layers)
        bf16_check(torch, make_prefill_step, f"{arch} {cfg32.n_layers} layers", cfg32, cache_len, params, batch,
                   l_off, {flash_attention_fwd: cfg32.n_layers})
        del params, batch, l_off
    print(f"parity dense phase {time.perf_counter() - t0:.1f} s")

    # ----------------------------------- 41. train phi3, granite, internlm2
    t0 = phase("train dense")
    with expandable_segments(torch):
        trained = train_cells_phase(torch, configs, T, all_kernels, dev, args.seed, smi, train_plans, DENSE)
    print(f"train dense phase {time.perf_counter() - t0:.1f} s")

    # --------------------------------------------------- 42. train mixtral
    t0 = phase("train mixtral")
    with expandable_segments(torch):
        trained.update(train_cells_phase(torch, configs, T, all_kernels, dev, args.seed, smi, train_plans,
                                         [MIXTRAL], moe=moe))
    print(f"train mixtral phase {time.perf_counter() - t0:.1f} s")

    # ----------------------------------------- 43. train qwen3 accumulated
    t0 = phase("train qwen3 accumulated")
    gc.collect()
    torch.cuda.empty_cache()
    accumulated = train_accum_phase(torch, configs, T, all_kernels, dev, args.seed, smi, accum_plans)
    print(f"train qwen3 accumulated phase {time.perf_counter() - t0:.1f} s")

    # ------------------------------------- 44. checkpoint under another subdir
    t0 = phase("checkpoint subdir")
    gc.collect()
    torch.cuda.empty_cache()
    subdir_launches, subdir_prefills = ckpt_subdir_phase(torch, configs, serve, all_kernels, dev, args.seed,
                                                         qwen_res.tokens, default_subdir_keys)
    print(f"checkpoint subdir phase {time.perf_counter() - t0:.1f} s; all phases "
          f"{time.perf_counter() - t_all:.1f} s; this process's writes in the run (/proc/self/io; its children's "
          f"are not counted there): {written_bytes()}")

    runs = {"qwen3_0_6b": (qwen_launches, qwen_res.prefills, "prefill"),
            "rwkv6_1_6b": (rwkv_launches, rwkv_res.prefills, "prefill"),
            JAMBA: (jamba_launches, jamba_res.prefills, "prefill"),
            "qwen3_0_6b from checkpoint": (ckpt_launches, ckpt_res.prefills, "prefill"),
            "qwen3_0_6b train": (train_launches, steps, "step"),
            SEAMLESS: (seamless_launches, seamless_res.prefills, "prefill"),
            QWEN2_VL: (qwen2vl_launches, qwen2vl_res.prefills, "prefill"),
            MIXTRAL: (mixtral_launches, mixtral_res.prefills, "prefill"),
            f"{MIXTRAL} long": (long_launches, long_res.prefills, "prefill"),
            ARCTIC: (arctic_launches, arctic_res.prefills, "prefill"),
            f"{JAMBA} with experts": (jamba_moe_launches, jamba_moe_res.prefills, "prefill"),
            "qwen3_0_6b sharded, (1, 1) mesh": (sharded_launches, sharded_prefills, "prefill"),
            "qwen3_0_6b sharded, seq-placed KV cache, (1, 1) mesh": (seq_launches, 1, "prefill"),
            "qwen3_0_6b sharded train, (1, 1) mesh, FSDP": (sharded_train_launches, 1, "step"),
            "qwen3_0_6b campaign train": (campaign_train_launches, campaign_steps, "step"),
            "qwen3_0_6b campaign, served from its checkpoint": (campaign_serve_launches, campaign_prefills,
                                                               "prefill"),
            "qwen3_0_6b Slurm serving jobs": (jobs_launches, jobs_prefills, "prefill"),
            "qwen3_0_6b pipeline serve stage": (pipe_launches, pipe_prefills, "prefill"),
            "qwen3_0_6b served from a checkpoint pulled back from a remote site": (remote_launches, remote_prefills,
                                                                                  "prefill"),
            "qwen3_0_6b served from a clone of the repacked repository": (clone_launches, clone_prefills, "prefill"),
            "qwen3_0_6b serve_batched_torch, beside two serving jobs": (batched_launches, batched_prefills,
                                                                        "prefill"),
            "qwen3_0_6b Slurm serving jobs of phase 39": (cache_jobs_launches, cache_jobs_prefills, "prefill"),
            f"rwkv6_1_6b train, {RWKV_TRAIN_CUTS['n_layers']} of 24 layers": (rwkv_train_launches, rwkv_train_steps,
                                                                            "step"),
            f"{JAMBA} train, 8 layers, no experts": (jamba_train_launches, jamba_train_steps, "step"),
            **dense,
            **{f"{arch} train, {configs.get(arch).replace(**TRAIN_CELLS[arch]).n_layers} of "
               f"{configs.get(arch).n_layers} layers": (launches, n, "step")
               for arch, (launches, n) in trained.items()},
            **{run: (launches, n, "step") for run, (launches, n) in accumulated.items()},
            f"qwen3_0_6b served from a checkpoint under {CKPT_SUBDIR}/": (subdir_launches, subdir_prefills,
                                                                           "prefill")}

    def launch_counts(name: str) -> dict:
        """The kernel's launches over the main-path runs, by path, and per
        prefill (serving) or per step (training)."""
        by_path = {a: n[name] for a, (n, _, _) in runs.items() if n[name]}
        per = {unit: {a: by_path[a] // runs[a][1] for a in by_path if runs[a][2] == unit}
               for unit in ("prefill", "step")}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path,
                "launches_per_prefill": per["prefill"], "launches_per_step": per["step"]}

    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:30",
        **launch_counts("flash_attention_fwd"),
        **flash_qwen3,
        "at_jamba_shape": flash_jamba,
        **flash_new,
    }, {
        "name": "rwkv6_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6.cu",
        "replaces": "src/repro/kernels/rwkv6.py:24",
        **launch_counts("rwkv6_fwd"),
        "max_abs_err": rwkv_err,
        "ms": rwkv_ms,
        "plain_ms": rwkv_plain_ms,
        "bound_ms": rwkv_bound_ms,
        "bound_by": rwkv_bound_by,
        "library_ms": None,
    }, {
        "name": "mamba_scan_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba.cu",
        "replaces": "src/repro/kernels/mamba.py:23",
        **launch_counts("mamba_scan_fwd"),
        "max_abs_err": mamba_err,
        "ms": mamba_ms,
        "plain_ms": mamba_plain_ms,
        "bound_ms": mamba_bound,
        "bound_by": mamba_bound_by,
        "library_ms": None,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
