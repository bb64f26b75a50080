#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds every kernel against its plain PyTorch version on the card at the
shapes the main path gives it, drives the stream orchestrator's main
path on the card, and checks what comes out. Phases:

1. device (``nvidia-smi`` name and power limit) and the kernel build;
2. each slice-1 kernel vs its plain version: max error against the
   stated tolerance, the kernel's time from CUDA-graph replays with the
   inputs cycled past the L2 (eager logged), the plain version's time,
   and the least time the card could take (``bound_ms``); the
   persistent normalize (one cooperative kernel a call, captured by a
   CUDA graph) against its plain version and its three-kernel witness at
   phase 5's shape and with no rows, one row, fewer rows than CTAs, rows
   off the CTA count, d 8, 255 and 20,000, an all-NaN column and no
   impute, ``copy_`` of x timed beside it; the staged
   hash kernel bitwise its plain version and its row-thread witness at
   the hashed job's shape (65,536 x 32 -> 1,024) and on -0.0, NaN and
   +-inf among colliding features, f = 1, 7, 33, 64, ragged n, dims 8,
   1,000 and 20,000 (the row-thread route) and no rows, one call one
   kernel, ``torch.zeros`` of its output timed beside it; the
   top-k EF round-trip (its radix select on the card) bitwise its plain
   version and its witness (``torch.topk``'s threshold, then the int8
   kernels) at the dense job's two shapes (16,777,216 and 65,536
   elements), with many ties at the threshold, on all-equal data and on
   data that fools the select's sample, its select bitwise
   ``torch.topk``'s k-th largest, one call a CUDA graph of a memset and
   the select and apply kernels, timed from CUDA-graph replays beside
   ``torch.topk``'s threshold (``library_ms``); the DDM scan also
   against its serial witness kernel, level for level, on a many-drift
   stream and on the errors after the ``int8_ef`` codec, its chain's divide
   against IEEE ``/`` over random pairs; EDDM's and Page-Hinkley's
   tiled kernels (``eddm_tiled_kernel``: the chain over the errors only;
   ``ph_tiled_kernel``: the mean and ``cum`` chains) level for level, the
   state bitwise, against the one-thread witness on the planted-drift,
   many-drift and ``int8_ef``-decoded batches, from carried states (in
   the warm-up; ``n`` and ``since_last`` near 2^24, the counters stepped
   one by one, and a stretch without errors) and carried over 128 calls
   of 512 events, and against their plain loops on the host on the
   whole planted-drift batch (a restart at least), graph-timed beside
   the witness (rows
   ``detector_scan/eddm`` and ``/ph``); chain lengths and ns a chained
   event; ADWIN's kernel
   (``adwin_scan_kernel``: cut tests across the grid) bitwise its plain
   loop on the card on prefixes of the many-drift (2,048 events) and the
   ``int8_ef``-decoded (512) streams, level for level, and on the whole
   planted-drift, many-drift and decoded batches level for level its
   serial witness and ``ref.adwin_scan_restart_ref``, its state bitwise
   theirs and its one-warp witness's (within rtol 1e-5 on the decoded
   errors), from a carried state and carried over 128 calls of 512
   events; graph-timed with ns an event beside both witnesses, its
   rounds, events at DRIFT and rebases, and faster than the one-warp
   witness (``detector_scan/adwin``, a row of its own in the
   ``kernels`` line);
3. the orchestrator on a dense 256-wide drifting stream, 12 batches of
   65,536 events, once with the ``int8_ef`` uplink codec and once with
   ``topk_int8_ef``, plus a small run compared with the same job on the
   CPU (the kernels' plain versions);
4. the orchestrator on a hashed sparse stream (hash -> pca -> sketch);
5. edge preprocessing (``preprocess_batch``) over the dense batches with
   NaNs injected;
6. the serving path's two kernels vs their plain versions, as in
   phase 2: flash attention in bf16 and fp32 at head dims 64, 16, 128
   and 256 (prefill S = T = 512, a decode step, causal; B 8, 16 heads;
   D 256, the largest built, has rows of its own in the ``kernels``
   line) and at
   llama-3.2-vision-90b's cross-attention (64 heads on 8 KV heads, 1,600
   image tokens, batch 1, 2 and 8, prefill and decode; batch 8, the
   vision model's serving batch, has rows of its own in the ``kernels``
   line with phase 14's vision launches), on strided
   model-layout inputs, each call one CUDA kernel by ``torch.profiler``,
   with ``library_ms`` from the fastest fused SDPA backend on 4-D
   inputs (flash, memory-efficient, cuDNN; refusals logged); then
   seamless-m4t-medium's smoke configuration (d_head 16, fp32) served
   through ``impl="kernel"``, its tokens equal to ``impl="chunked"``'s;
   then WKV in the model layout (``wkv_kernel_checks``): rwkv6-1.6b's
   prefill (B 8, S 512, 32 heads of 64, chunk 32) and decode step in
   bf16, a ragged S, decays down to -20 a step, strided r, k, v, every
   built (head size, chunk), ``RWKVConfig``'s default chunk 64 (run at
   the built chunk 32; a row of its own in the ``kernels`` line), head
   size 128 (the CUDA-core kernel; prefill and decode, bf16 and fp32;
   rows of their own) and the smoke configuration's in fp32, each one
   CUDA kernel a call,
   timed from CUDA-graph replays; the tensor-core kernel against the
   CUDA-core witness; the C entry's refusals of other sizes; then model serving (``ServeEngine``, ``impl="kernel"``) at full width,
   bf16, random weights from a seed: seamless-m4t-medium (flash
   attention in cross-attention), rwkv6-1.6b (the WKV kernel) and
   qwen2-1.5b (no kernel on its path), each with 16 requests of
   512-token prompts, 32 greedy new tokens, ``batch_size=8``,
   ``max_len=1024``; tokens, finite logits and prefill logits against
   ``impl="chunked"`` are checked;
7. rwkv6's ``serving_graph`` placed by ``place_frontier`` on the edge
   serving example's cluster and run at the ``{decode}`` frontier: its
   tokens must be the engine's, bitwise;
8. edge summarization: the count-min kernels (widths 1,024 and
   1,048,576, and a table preloaded at 2^24 + 1; the increment, the
   copy-and-add of ``sketches.countmin_add`` and the add-then-query also
   against the increment's first kernels, the witness; one increment
   call a CUDA graph of a memset and one kernel, one ``countmin_add`` a
   copy and one kernel, one add-then-query a copy and two kernels;
   graph-timed) and the Misra-Gries
   scan against their plain versions, exactly (Misra-Gries on a whole
   batch against its plain loop on the host CPU, and on a 16,384-id
   prefix against that loop on the card, and at four more chunk
   lengths against its serial witness kernel); then a ``StreamFeeder``
   of 4 Zipf token shards (vocabulary 2^24) feeds 16 batches of
   1,048,576 ids to the card, each through ``countmin_add_query`` at
   both widths, a per-batch window sketch (``countmin_add``) and
   ``mg_update`` (k = 64). The final tables must be bitwise the plain
   versions' over the same batches, no estimate may fall below its true
   count, Misra-Gries after the first batch must be bitwise its plain
   loop's and after every batch its serial witness's (replayed over the
   same ids), and its top key at the end must be the most frequent id;
9. the Mamba selective scan (four lanes a channel) at
   jamba-1.5-large-398b's mixer width (d_inner 16,384, 16 states)
   against its plain version and its thread-a-channel witness at a
   prefill shape (B 2, S 4,096), a ragged one (S 4,000) and a decode
   step (S 1), graph-timed with the inputs cycled past the L2, and at
   N = 4 and d_inner 16,380 and 1,001; at N 32 and 64 (S 512 and a
   decode step, against the plain version and the witness, graph-timed;
   rows of their own); one call one kernel; then through
   ``kernels.ops.mamba_scan`` as that path;
10. dynamic topology (``examples/dynamic_topology.py`` in the port): a
    ``MembershipDirectory`` on the example's edge and cloud, the job
    (the example's fan-out graph of the standard operators,
    ``sample_rate`` 0.5, DDM, ``int8_ef``) subscribed before
    ``edge_rack`` and ``edge_far`` register at t = 0, three latency
    probes, 16 batches of 65,536 x 256 at a pinned 1e4 events/s, the
    rack silent after step 8: the join replans, the rack's failure in
    the plan, its checkpoint rescale (states back on the card, bitwise)
    and forced ``pool_lost`` replan, no op on the rack after it, the
    path's kernels launched after the rescale, the control trajectory
    equal to the same script's on the CPU at 2,048 events a batch;
11. the fleet (``examples/fleet_pipeline.py`` in the port):
    ``FleetOrchestrator(membership=...)`` over the example's edge and
    cloud and a rack edge, its four tenants (``dl`` at 256 wide with two
    workers, two sketch jobs at 64, the hog at 1e9 events/s, which must
    queue), 8 rounds of 65,536 events a tenant, the seed edge failing
    through the directory at round 4: the ledger's check empty every
    round, no plan on the dead pool, every admitted tenant's events
    and states on the card, the admissions, queue, audit log and
    control trajectories equal to the same script's on the CPU. Phases
    10 and 11 each end with a profiled rerun for the card's idle share;
12. training (``examples/train_stream_lm.py`` in the port, through
    torch autograd on the chunked paths): qwen2-1.5b's full config
    (28 layers, bf16 with fp32 master weights and AdamW moments, remat
    full) on a drifting ``TokenStream`` of 8 x 512 tokens a step, 2
    untimed and 8 timed steps, Page-Hinkley on the loss on the card,
    the loss falling; rwkv6-1.6b's full config with its 4 microbatches,
    3 steps; each with ms a step, tok/s, peak memory, MFU and a
    profiled step's idle share. Then ``dl_train_op`` at qwen2's width
    (2 layers) placed by ``place_frontier`` on the edge serving
    cluster, its losses and state bitwise the standalone step's on the
    card; an ``AsyncCheckpointer`` save at step 3 of 6 (smoke config)
    with the next step updating in place, resumed bitwise (its 3 steps
    on the card against the CPU are phase 21b's). It launches no hand
    kernel (no kernel has a backward). The kernels' pad routes (flash attention
    at head dims 32, 96 and 192, WKV at head sizes 32 and 96, Mamba at 8
    and 24 states, each zero-padded to the next built size) and one size
    above each largest built one (flash D 320 on the wide kernel, WKV hs
    160 as blocks of 128, Mamba N 80 as groups of 64 and 16; rows of
    their own) are held to their plain versions
    at the original size after phase 6's and phase 9's checks, flash's
    beside the fastest fused SDPA backend at the original size;
13. the orchestrator's other modes on phase 3's dense job (12 x 65,536 x
    256, ``int8_ef``, a pinned 1e4 events/s): (a) ``fuse="xla"`` (each
    segment captured once into a CUDA graph and replayed) against
    ``fuse="op"``, on the job and on a direct walk of the standard
    pipeline through cuts 0, 2, 5, 2, 0 (two batches a cut, states
    carried): JobMetrics equal, masks bitwise, states and outputs within
    rtol 1e-5 and atol 1e-6, one capture per distinct segment and none on
    a revisit, the DDM kernel among each drift segment's graph nodes;
    ms a batch, host-clock ms per op and per segment, a profiled rerun's
    idle share and capture ms per segment for both modes; (b)
    ``measured_costs=True``: every op measured, the decision line, the
    card's cost table within 1% of the CPU's for the same first batch,
    the measured plan beside the declared one; (c) a fusion-fed job (a
    32-wide side stream on the same timestamps through
    ``WindowJoin(tolerance=5.0)``, then concat -> normalize -> train ->
    drift): every event matched, prequential accuracy above 0.6, the
    control trajectory equal to the CPU's at 2,048 events a batch; (d)
    the stratified reservoir (2 classes, k 256) over the batches' labels,
    bitwise ``reservoir_update`` over each class's items with the same
    draws and the same run on the CPU; (e) ``dl_train_op`` (2 layers at
    qwen2-1.5b's width; its optimizer updates parameters and moments in
    place) under ``fuse="xla"`` against ``fuse="op"``, 3 steps from one
    seed: losses, gradient norms and states within the same tolerance,
    the caller's tensors the updated ones. Graph replays count as
    launches: each replay launches every hand kernel its graph holds, and
    a hand kernel (a ``__global__`` of the port's sources) in a captured
    graph without a counter fails the phase;
14. the families of slice 13, and the dense models no other phase
    serves, served as phase 6 serves its models:
    granite-moe-1b-a400m, deepseek-v2-lite-16b, nemotron-4-15b (squared
    ReLU, decoder-only LayerNorm, 256,000 tokens) and qwen1.5-4b (full
    multi-head attention, QKV bias) in full, llama-3.2-vision-90b cut to
    5 layers (the gated cross layer at index 4), jamba-1.5-large-398b to
    2 (Mamba + MoE, attention + dense) and mistral-large-123b to 16, each
    cut logged: tok/s, peak GiB, launches (flash on the vision path and
    nothing else on any), kernel against chunked prefill logits
    (vision's gates opened, its patches drawn from a seed), one profiled
    decode step (launches, idle share), a negative control (the vision
    check must fail with flash's output rolled over the batch), and the
    smoke configs of granite, deepseek and the three dense models
    prefilled in fp32 on the card against the CPU (logits within 1e-4;
    the MoE routing's ids, keep masks and sort bitwise, near ties
    logged);
15. the launchers and the mesh: (a) ``python -m repro_torch.launch.serve``
    (its ``main``) for rwkv6-1.6b at full width with phase 6's traffic,
    its greedy tokens equal to ``ServeEngine``'s driven directly on the
    same weights and prompts, WKV launched 24 times a prefill and a
    decode step; (b) ``python -m repro_torch.launch.train`` for
    granite-moe-1b-a400m at full width, 4 steps of 8 x 512 with
    Adafactor and one checkpoint at the last step: ms a step, tok/s,
    peak GiB, the save's caller-thread and write seconds; (c) the
    launcher's ``--elastic`` cycle at smoke width (1 -> 2 workers,
    capped at the one card: a (1, 1) mesh), the state through
    ``rescale_cycle`` and the final state bitwise, and ``--resume``
    from a step-3 checkpoint bitwise at step 6; (d) ``use_mesh(None)``
    on the card leaving a train step bitwise;
16. the dry run (``launch/dryrun.py``): (a) at full width over fake
    worlds of 512 ranks, each a process of its own started beside (b):
    qwen2-1.5b train_4k on the single pod (256 ranks) through
    ``selftune.tune`` (the baseline and microbatches=2) and
    granite-moe-1b-a400m prefill_32k on the multi-pod mesh through
    ``python -m repro_torch.launch.dryrun``, both ``ok``, each record's
    bytes a rank, flops, collectives and trace seconds logged; (b) the
    analysis held to a real step: qwen2-1.5b's full config at phase 12's
    shape on a (1, 1) mesh, the dry run's record (fake tensors) against
    one real AdamW step on the card: argument bytes and ``OpCount``'s
    operations exactly, the traced peak within 10% of
    ``max_memory_allocated``, the step's ms; (c) one more leaf in the
    real arguments must fail the argument check. No hand kernel
    launches;
17. the step on shards (``dist/fsdp.py``: a rank holds its shards of the
    params and optimizer state, gathers a layer's weights where it runs
    them, reduce-scatters their gradients), two ranks of a (2, 1) mesh
    on the one card, each a process of its own joined through a
    ``file://`` store with gloo (NCCL refuses two ranks on one device),
    held to the one-rank run on the same card: (a) qwen2-1.5b's full
    config (``fsdp``, remat "full"), seed-0 weights, one AdamW step at
    phase 12's shape (TRAIN_B x TRAIN_S) from TRAIN_LR: loss and grad norm
    within rtol 1e-3, every updated param within 2 x lr plus one bf16 ulp,
    each rank's arguments its shards' exact bytes (reckoned from the
    rules, and the dry run's), its ``max_memory_allocated`` less them
    below the whole params' and state's bytes, and the dry run of the
    (2, 1) cell over a fake world of two (a process of its own) within
    10% of that peak; (b) seamless-m4t-medium (``tp_fsdp``): prefill of
    SERVE_BATCH prompts and 8 greedy decode steps with
    ``impl="kernel"``, each rank its half of the prompts, the tokens
    equal to the one rank's on the same rows, the flash kernel launched
    in the ranks (their launches are the path's);
18. tensor- and expert-parallel compute (``dist/tp.py``: a ``model``
    rank computes its slice of heads, ``ff``, vocab and experts, the
    layers' all-reduces over ``model``), two gloo ranks of a (1, 2) mesh
    on the one card, held to one rank: first flash at
    seamless-m4t-medium's cross-attention on 8 of its 16 heads and WKV
    at rwkv6-1.6b's prefill and decode on 16 of its 32 heads against
    their plain versions (rows of their own, logged); then (a)
    seamless-m4t-medium and (b) rwkv6-1.6b under ``tp_fsdp``, prefill of
    SERVE_BATCH prompts and 8 greedy decode steps with ``impl="kernel"``
    on every prompt: tokens equal to the one rank's (a row may part from
    them only where the one rank's logits tie within a bf16 ulp, and is
    not held after it: ``tie_divergences``), flash (WKV) launched
    at 8 (16) heads a call, the caches' K, V and WKV state half the one
    rank's bytes; (c) granite-moe-1b-a400m under ``ep_fsdp`` (16 of its
    32 experts a rank), one AdamW step with 17a's checks against the one
    rank's and the (1, 2) dry run's (``"sharded_tp"``); (d)
    seamless-m4t-medium as (a) with ``seq_shard=True``: the prefill's
    residual stream the rank's slice of the sequence (its layers'
    output products reduce-scattered, the norms' outputs all-gathered),
    tokens equal to the one rank's, the bytes each rank sends into each
    collective logged beside (a)'s; (e) jamba-1.5-large-398b at phase
    14's cut (2 layers) and (f) deepseek-v2-lite-16b (27 layers) served
    as (a) under ``ep_tp_fsdp`` with their configs' ``seq_shard``
    (True): a rank holds half of the heads, KV heads, ``ff``, vocabulary
    and experts and of Mamba's ``dinner`` channels, MLA's latent whole;
    each rank draws its shards leaf by leaf (``draw_local``), the ranks
    taking turns; the MoE routing recorded on both sides, a flip allowed
    only within its layer's derived near-tie bound or downstream of one
    (``routing_flips``), tokens as in (a) or downstream of such a flip,
    each step's logits within LOGITS_RTOL on the rows whose tokens agree
    up to it, each cache leaf's bytes the act rules' split (the split
    leaves by name halved), the params the param rules' shapes,
    reduce-scatters exactly where ``seq_shard`` is set, no hand kernel
    launched; their smoke configs in fp32 on the same ranks in both
    ``seq_shard`` forms, tokens bitwise the one rank's and expert ids
    equal but at a MOE_NEAR_TIE near tie; (g) deepseek at phase 21's cut
    (4 layers) under ``ep_tp_fsdp``, one AdamW step with (c)'s checks
    against the one rank's and its (1, 2) dry run's
    (``"sharded_tp_seq"``);
19. phase 3's dense job (12 x 65,536 x 256, ``int8_ef``) with
    ``drift_detector="adwin"``: one ADWIN kernel launch a batch, the
    planted drift's alarm, the learner recovering; the same script's
    small job (10 x 512 x 16) on the card and the CPU with events, cuts,
    codecs and alarms equal and the prequential metrics within 1e-3;
    ``fuse="xla"`` against ``fuse="op"`` as phase 13a holds them, the
    drift segment's graph holding ADWIN's kernel as one node;
20. phase 19 for ``drift_detector="eddm"`` and ``"ph"`` (their tiled
    kernels), beside DDM's job in the same call, without the alarm
    check (a detector need not alarm on this drift);
21. a train step on the card for every registered model no other phase
    trains, at full width, 3 steps of 8 x 512 on one seeded batch
    (tokens, and frames or patches; ``make_optimizer`` and
    ``make_train_step``, the config's remat and microbatches):
    seamless-m4t-medium (AdamW, fp32 master) and qwen1.5-4b (Adafactor)
    in full, nemotron-4-15b at 8 layers, mistral-large-123b at 4 and
    llama-3.2-vision-90b at 5 (Adafactor), deepseek-v2-lite-16b at 4
    (AdamW; layer 0 dense, 3 MoE), each cut logged; jamba-1.5-large-398b
    does not fit one card and is logged so. Losses finite and falling,
    grad norms finite and above 0, every parameter finite on the card,
    every leaf that had a gradient moved; ms a step, tok/s, MFU, peak
    GiB beside the reckoning (6 or 18 B a parameter), the draw's peak;
    (b) every registered model's smoke config 3 steps on the card
    against the CPU, losses within 1e-4 (an MoE model's routing equal
    but at a near tie; from a step where it parts there, logged, not
    held). No hand kernel launches. Each phase logs the seconds since
    the start.

The launch counts are set to 0 just before each main path (phases 3-5
as one, each model of phases 6 and 14, phases 7, 8, 9, 10, 11, 12, 13,
16, 19 and 21, each detector of phase 20, each launcher of phase 15, 17b
and each serving run of phase 18 in each rank's process) and
read just after it; every kernel must have launched on a main path. A line
``{"kernels": [...]}`` reports each kernel, the line before the last
gives the card's name and power limit, and the last line is
``{"ok": true, "device": {...}}``. Any failure raises and the script
exits non-zero without that line. It also exits non-zero, printing no
result, where CUDA is unavailable or the port's sources are not beside
it.

Two further modes measure without checking:

    python3 chip_smoke.py --measure [--src DIR] [--wkv | --codec | --mamba | --scans]
    python3 chip_smoke.py --compare ROOT [--runs 3] [--wkv | --codec | --mamba | --scans]

``--measure`` drives only the main paths of phases 3 (both codecs, after
the same warm-up run), 4, 6-7 and 8, as the full run drives them but
with no kernel check before them, and prints their rates (events/s,
prefill and decode tok/s, phase 8's card ms a batch per sketch) as its
last line, one JSON object. ``--src`` names the ``src`` directory whose
``repro_torch`` it measures. ``--compare`` runs ``--measure`` for
another checkout's port (``ROOT/src``, for example the parent commit
unpacked with ``git archive`` into a git-ignored directory) and for
this one in turns (other, this, this, other, other, this for 3 runs),
each run a process of its own, and prints one JSON line a run, each
side's medians and the card's name and power limit. With ``--wkv``
both time only the WKV kernel, graph-timed and eager, at rwkv6-1.6b's
prefill and decode shapes through the tree's ``kernels.ops.rwkv6_wkv``
(the model layout) and ``rwkv6_wkv_bh_cuda`` (the reference's layout).
With ``--codec`` both time only the top-k EF round-trip (16,777,216
and 65,536 elements, with ``torch.topk``'s threshold beside it), the
int8 round-trip, the fused normalize (with ``copy_`` of x), the hash at
phase 4's shape, and count-min's increment, ``sketches.countmin_add``
and add-then-query at both widths, graph-timed and eager
(``codec_measure``), with the witnesses where the tree has them. With
``--mamba`` both time only the Mamba scan at phase 9's three shapes,
graph-timed and eager, with the witness where the tree has it
(``mamba_measure``). With ``--scans`` both time only the drift scan's
four kinds on phase 2's planted-drift and many-drift batches,
graph-timed (``scans_measure``).
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# HBM bytes/s, fp32 (non-tensor) flop/s and dense bf16 tensor-core
# flop/s by H100/H200 variant, from NVIDIA's data sheets; matched on the
# name nvidia-smi reports.
CARD_PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12, 756e12),
    ("H100 NVL", 3.9e12, 60e12, 835e12),
    ("H200", 4.8e12, 67e12, 989e12),
    ("H100", 3.35e12, 67e12, 989e12),          # SXM, "H100 80GB HBM3"
)

N_EVENTS = 65_536      # events per batch on the main path
DIM = 256              # dense stream width
HASH_F = 32            # sparse features per event
HASH_DIM = 1024        # hashed width
N_BATCHES = 12
DENSE_CODECS = (("int8_ef", 0.1), ("topk_int8_ef", 11.0))   # codec, budget
ADWIN_PLAIN_N = 2048        # events ADWIN's plain loop runs on the card
ADWIN_ROW = "detector_scan/adwin"   # ADWIN's row of the kernels line
DETECTOR_JOBS = ("eddm", "ph")     # phase 20's detectors
# their rows of the kernels line (tiled kernels; phase 20's launches)
DETECTOR_ROWS = tuple(f"detector_scan/{d}" for d in DETECTOR_JOBS)
ADWIN_SMALL = (10, 512, 16)  # phases 19b's and 20b's batches, events, dim
DIVIDE_PAIRS = 1 << 24      # pairs per draw for the DDM chain's divide check
# a chained step's dependent fp32 operations (the running mean's subtract,
# the split divide's three FMAs, the add), 4 cycles each: the tiled
# chains' floor a chained event at the card's largest SM clock
CHAIN_STEP_CYCLES = 5 * 4

SERVE_MODELS = ("seamless-m4t-medium", "rwkv6-1.6b", "qwen2-1.5b")
N_REQUESTS = 16        # requests per served model
PROMPT = 512           # prompt tokens per request
NEW_TOKENS = 32        # greedy new tokens per request
SERVE_BATCH = 8        # requests per wave
MAX_LEN = 1024
# phase 6's flash checks: the head dims the kernels are built for, and
# llama-3.2-vision-90b's cross-attention (1,600 image tokens) at two batches
FLASH_HEAD_DIMS = (64, 16, 128, 256)
WKV_H, WKV_HS, WKV_CHUNK = 32, 64, 32      # rwkv6-1.6b's heads, head size, chunk
WKV_STRONG = 20.0      # the strong-decay check's largest -lw a step
WKV_CHUNK64_ROW = "rwkv6_wkv/chunk64"   # RWKVConfig's default chunk
FLASH_VLM_T = 1600
FLASH_VLM_BATCHES = (1, 2, 8)    # 8: the vision model's serving batch
FLASH_LIBRARY_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION",
                          "CUDNN_ATTENTION")
L2_BYTES = 50 * 2 ** 20             # the H100's L2 cache
SMOKE_SERVE_REQUESTS = 6            # seamless smoke config served in phase 6
SMOKE_SERVE_TOKENS = 16
SERVE_PLACE_RATE = 0.1  # requests/s: the pod alone serves rwkv6 feasibly

# phase 8: edge summarization of a Zipf token stream
SKETCH_SHARDS = 4
SKETCH_SEQS = 256      # sequences per shard per batch
SKETCH_SEQ_LEN = 1024
SKETCH_VOCAB = 2 ** 24
SKETCH_ZIPF = 1.3
SKETCH_BATCHES = 16
SKETCH_DEPTH = 4
# the reference's default width, and one with eps = e / w ~ 2.6e-6
SKETCH_WIDTHS = (1024, 1 << 20)
MG_K = 64
MG_PLAIN_N = 16_384    # ids the plain Misra-Gries loop runs on the card
MG_K_CHECKS = (1, 33, 200, 1024)   # further k held to the serial witness
SKETCH_SAMPLE = 4096   # keys whose estimates are checked, the top 100 included

# phase 9: jamba-1.5-large-398b's Mamba mixer (d_inner = 2 x 8,192, d_state 16)
MAMBA_DI = 16_384
MAMBA_N = 16
MAMBA_B = 2
MAMBA_CHUNK = 256
MAMBA_SHAPES = (("mamba_scan", 4096), ("mamba_scan/ragged", 4000),
                ("mamba_scan/decode", 1))
MAMBA_CHECK_S = 512    # steps of the N = 4 and ragged-dI checks
MAMBA_TOL = 1e-5       # rtol and atol, fp32 against the per-step plain scan
# prefill logits of impl="kernel" against impl="chunked" on the card, in
# bf16: max |difference| <= LOGITS_RTOL * max |chunked logits|
LOGITS_RTOL = 5e-2

# phase 14: the families served at full width; three cut in depth to fit
# one card (80 GB): (arch, config overrides, why)
FAMILY_MODELS = (
    ("granite-moe-1b-a400m", {}, None),
    ("deepseek-v2-lite-16b", {}, None),
    ("llama-3.2-vision-90b", {"n_layers": 5},
     "90B parameters do not fit one card; 4 attention layers and the "
     "gated cross layer at index 4 keep every layer kind at full width"),
    ("jamba-1.5-large-398b", {"n_layers": 2, "attn_period": 2},
     "398B parameters do not fit one card, and one full-width MoE layer "
     "is ~9.7B: layer 0 Mamba + MoE, layer 1 attention + dense"),
    # the dense decoders no other phase serves: squared ReLU, decoder-only
    # LayerNorm and a 256,000-token vocabulary; full multi-head attention
    # with QKV bias; 96 heads on 8 at d_model 12,288
    ("nemotron-4-15b", {}, None),
    ("qwen1.5-4b", {}, None),
    ("mistral-large-123b", {"n_layers": 16},
     "123B parameters (~246 GB in bf16) do not fit one card; every layer "
     "is the same dense block at full width, 16 are 45.9 GB"),
)
VLM_GATE = 1.0          # the vision gates, opened for the checks
# the vision checks' image patches: N(0, VLM_PATCH_SCALE^2). The seeded
# weights' fan-in scales leave cross-attention's scores at std ~0.04
# per unit of patch scale: at unit scale the attention is near uniform
# over the 1,600 patches, its output ~0.07 a coordinate, and a wrong
# flash output (each request given another's) moved the prefill logits
# by 0.8% of their largest, under the 5% the check allows
VLM_PATCH_SCALE = 32.0
PREFILL_CPU_MODELS = ("granite-moe-1b-a400m", "deepseek-v2-lite-16b",
                      "nemotron-4-15b", "qwen1.5-4b", "mistral-large-123b")
PREFILL_CPU_B, PREFILL_CPU_S = 4, 64
PREFILL_CPU_TOL = 1e-4  # rtol and atol, fp32 logits, card against CPU
MOE_NEAR_TIE = 1e-6     # K-th and (K+1)-th router probabilities closer

# phases 10-11: the port's counterparts of examples/dynamic_topology.py and
# examples/fleet_pipeline.py at the dense job's width
TOPO_STEPS = 16
TOPO_LAST_BEAT = TOPO_STEPS // 2   # edge_rack's last heartbeat
TOPO_RATE = 1e4                    # offered events/s, pinned
FLEET_ROUNDS = 8
FLEET_FAIL_ROUND = 4               # the seed edge's lease runs out here
FLEET_DIMS = {"dl": 256, "sketch": 64}
FLEET_DEMAND = {"dl": 4e4, "sketch_a": 1e4, "sketch_b": 1e4}
CONTROL_EVENTS = 2048   # events a batch of the CPU runs the card's are held to


def log(*a):
    print(*a, flush=True)


def card_peaks(name: str):
    for key, bw, flops, tensor in CARD_PEAKS:
        if key in name:
            return bw, flops, tensor
    raise RuntimeError(f"no memory/flop peaks known for card {name!r}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout
    return out.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    """The card's largest SM clock (``nvidia-smi``'s ``clocks.max.sm``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def median_ms(fn, reps: int, warmup: int = 1, trials: int = 3) -> float:
    """Median over ``trials`` of the mean ms of ``reps`` back-to-back
    calls between two CUDA events: the host enqueues ahead of the card,
    so a short kernel's time is not its launch overhead."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def graph_ms(fn, reps: int, trials: int = 3) -> float:
    """Median over ``trials`` of the mean ms of a call of ``fn`` on the
    card, from one CUDA graph of ``reps`` calls replayed between two
    events: the card's own time, without the host's launch overhead
    (which paces a short kernel's back-to-back eager calls)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()            # first use of allocations and library plans
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 2 (slice 1's kernels) and the start of phase 6 (the serving
# kernels): every kernel against its plain version on the card
# ---------------------------------------------------------------------------

def recorder(rows: dict, bw: float, flops: float, tensor: float):
    """``record(...)``: check one kernel against its tolerance, log it with
    its bound, and keep its row in ``rows``."""

    def bound(nbytes, nops, tensor_ops=0.0):
        # fp32 operations at the CUDA-core peak, matrix products at the
        # bf16 tensor-core peak
        t_b = nbytes / bw * 1e3
        t_o = (nops / flops + tensor_ops / tensor) * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    def record(name, source, replaces, err, tol, ms, plain_ms, nbytes, nops,
               tensor_ops=0.0, library_ms=None, library=None, row=None):
        b_ms, b_by = bound(nbytes, nops, tensor_ops)
        log(f"  {row or name}: max_abs_err={err!r} tol={tol!r} "
            f"kernel_ms={ms!r} plain_ms={plain_ms!r} bound_ms={b_ms!r} "
            f"({b_by}) library_ms={library_ms!r}"
            + (f" ({library})" if library else ""))
        if not err <= tol:
            raise AssertionError(f"{row or name}: kernel disagrees with its "
                                 f"plain version: {err!r} > {tol!r}")
        rows[row or name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms}

    return record


def kernel_checks(dev, g, record) -> None:
    """Slice 1's kernels at the orchestrator's shapes."""
    import torch
    from repro_torch.kernels import detector_scan as ds, ef_codec, ops, ref
    from repro_torch.streams import drift

    n_el = N_EVENTS * DIM

    # -- EF codecs: (65536 x 256) f32 with a non-zero residual, k = 10% ----
    x = torch.randn((N_EVENTS, DIM), generator=g, device=dev)
    r = torch.randn((N_EVENTS, DIM), generator=g, device=dev) * 0.01
    dec, rout = ef_codec.ef_int8_roundtrip_cuda(r, x)
    pdec, prout = ref.ef_int8_roundtrip_ref(r, x)
    torch.cuda.synchronize()
    ident = float(((dec + rout) - (x + r)).abs().max())
    if ident != 0.0:
        raise AssertionError(f"int8 EF identity broken by {ident!r}")
    err = max(float((dec - pdec).abs().max()), float((rout - prout).abs().max()))
    # one ulp of the largest decoded value; a flipped quantum is a scale
    tol = float(torch.finfo(torch.float32).eps) * float(pdec.abs().max())
    del dec, rout, pdec, prout
    sets = [(r, x)] + [(r.clone(), x.clone())
                       for _ in range(n_sets((r, x)) - 1)]
    call = cycling(ef_codec.ef_int8_roundtrip_cuda, sets)
    ms, eager = graph_ms(call, max(20, len(sets))), median_ms(call, 20)
    log(f"  ef_int8_roundtrip: graph ms {ms!r} [eager {eager!r}]")
    record("ef_int8_roundtrip", "src/repro_torch/kernels/csrc/ef_codec.cu",
           "src/repro/kernels/ef_codec.py:81", err, tol, ms,
           median_ms(lambda: ref.ef_int8_roundtrip_ref(r, x), 5),
           16 * n_el, 8 * n_el)

    del x, r, sets
    topk_kernel_checks(dev, record)

    hash_kernel_checks(dev, g, record)

    normalize_kernel_checks(dev, g, record)

    # -- detector scan: a 0/1 error stream with a planted drift ------------
    p = torch.where(torch.arange(N_EVENTS, device=dev) < N_EVENTS // 2,
                    0.1, 0.5)
    err = (torch.rand((N_EVENTS,), generator=g, device=dev) < p).float()
    init = drift.ddm_init(dev)
    before = ds.chain_stats(dev).clone()
    st, flag, lv = ds.detector_scan_cuda("ddm", init, err, levels=True)
    walked, restarts = (ds.chain_stats(dev) - before).tolist()
    t0 = time.perf_counter()
    pst, plv = drift.run_detector(ds.STEPS["ddm"], init, err)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    pflag = bool((plv == drift.DRIFT).any())
    diffs = [abs(float(a) - float(b)) for a, b in zip(st, pst)]
    diffs.append(float(bool(flag) != pflag))
    diffs.append(float((lv != plv).sum()))
    log(f"  detector_scan (DDM) on the planted-drift batch: levels of "
        f"{int((lv != plv).sum())} event(s) differ from the plain loop's")
    if not bool(flag):
        raise AssertionError("detector scan missed the planted drift")
    ms = median_ms(lambda: ds.detector_scan_cuda("ddm", init, err), 20)
    record("detector_scan", "src/repro_torch/kernels/csrc/detector_scan.cu",
           "src/repro/core/pipeline.py:687", max(diffs), 0.0, ms,
           plain_ms, N_EVENTS * 4 + 48, N_EVENTS * 20)
    serial_ms = median_ms(
        lambda: ds.detector_scan_serial_cuda("ddm", init, err), 5)
    log(f"  detector_scan (DDM): chain walked {walked} events, {restarts} "
        f"restart(s), {ms * 1e6 / walked!r} ns a chained event; serial "
        f"witness {serial_ms!r} ms ({serial_ms * 1e6 / N_EVENTS!r} ns an "
        f"event)")
    # the chain's split divide against IEEE `/` over random pairs across
    # its fast range: whole and fractional divisors, dividends of both signs
    tried = differ = 0
    for _ in range(4):
        mag = torch.exp2(torch.rand((DIVIDE_PAIRS,), generator=g, device=dev)
                         * 80.0 - 40.0)
        sign = torch.where(torch.rand((DIVIDE_PAIRS,), generator=g,
                                      device=dev) < 0.5, -1.0, 1.0)
        whole = torch.floor(torch.exp2(torch.rand(
            (DIVIDE_PAIRS,), generator=g, device=dev) * 24.0))
        frac = torch.exp2(torch.rand((DIVIDE_PAIRS,), generator=g,
                                     device=dev) * 40.0)
        for a_, b_ in ((sign * mag, whole), (sign * mag, frac),
                       (torch.rand((DIVIDE_PAIRS,), generator=g, device=dev)
                        * 2.0 - 1.0, whole)):
            t, d = ds.divide_check_cuda(a_, b_)
            tried, differ = tried + t, differ + d
    log(f"  detector_scan's split divide against IEEE `/`: {differ} of "
        f"{tried} pairs in its fast range differ")
    if differ:
        raise AssertionError("the DDM chain's divide differs from `/`")
    # many drifts (rates alternating every 500 events) and the errors after
    # the int8 uplink codec (not 0 or 1): against the serial witness
    alt = torch.where((torch.arange(N_EVENTS, device=dev) // 500) % 2 == 0,
                      0.05, 0.6)
    many = (torch.rand((N_EVENTS,), generator=g, device=dev) < alt).float()
    res = torch.randn((N_EVENTS,), generator=g, device=dev) * 0.02
    nonbinary, _ = ef_codec.ef_int8_roundtrip_cuda(res, err)
    if bool(((nonbinary == 0) | (nonbinary == 1)).all()):
        raise AssertionError("the codec's errors came out binary")
    for what, e in (("many drifts", many), ("int8_ef errors", nonbinary)):
        before = ds.chain_stats(dev).clone()
        st, flag, lv = ds.detector_scan_cuda("ddm", init, e, levels=True)
        walked, restarts = (ds.chain_stats(dev) - before).tolist()
        wst, wflag, wlv = ds.detector_scan_serial_cuda("ddm", init, e,
                                                       levels=True)
        same = bool(flag) == bool(wflag) and torch.equal(lv, wlv) and all(
            torch.equal(a.reshape(()), b.reshape(()))
            for a, b in zip(st, wst))
        e_ms = median_ms(lambda: ds.detector_scan_cuda("ddm", init, e), 20)
        w_ms = median_ms(
            lambda: ds.detector_scan_serial_cuda("ddm", init, e), 5)
        log(f"  detector_scan (DDM) on {what}: bitwise the serial witness, "
            f"level for level {same}; drifted {bool(flag)}, {restarts} restart(s), chain "
            f"{walked} events; {e_ms!r} ms ({e_ms * 1e6 / walked!r} ns a "
            f"chained event), witness {w_ms!r} ms")
        if not same:
            raise AssertionError(f"detector scan on {what} differs from its "
                                 "serial witness")
    # carried states whose n the chain must step one by one: n0 a little
    # under 2^24 (past it n + 1 rounds back to 2^24) and a fractional n0
    # still in the warm-up; (n, p, s_min, p_min) with the pair at p's own
    for n0, p0 in ((2.0 ** 24 - 1000.0, 0.25), (7.5, 0.3)):
        s0 = math.sqrt(p0 * (1.0 - p0) / n0)
        carried = drift.DDMState(*(torch.tensor(v, dtype=torch.float32,
                                                device=dev)
                                   for v in (n0, p0, s0, p0)),
                                 torch.tensor(0, dtype=torch.int32,
                                              device=dev))
        for what, e in (("planted drift", err), ("many drifts", many)):
            before = ds.chain_stats(dev).clone()
            st, flag, lv = ds.detector_scan_cuda("ddm", carried, e,
                                                 levels=True)
            walked, restarts = (ds.chain_stats(dev) - before).tolist()
            wst, wflag, wlv = ds.detector_scan_serial_cuda(
                "ddm", carried, e, levels=True)
            same = bool(flag) == bool(wflag) and torch.equal(lv, wlv) and \
                all(torch.equal(a.reshape(()), b.reshape(()))
                    for a, b in zip(st, wst))
            log(f"  detector_scan (DDM) from n0 = {n0!r} on {what}: bitwise "
                f"the serial witness, level for level {same}; drifted {bool(flag)}, "
                f"{restarts} restart(s), chain {walked} events, final n "
                f"{float(st.n)!r}")
            if not same:
                raise AssertionError(f"detector scan from n0 = {n0!r} on "
                                     f"{what} differs from its serial "
                                     "witness")
    eddm_ph_kernel_checks(dev, record, err, many, nonbinary)
    adwin_kernel_checks(dev, record, err, many, nonbinary)


def eddm_ph_kernel_checks(dev, record, err, many, nonbinary) -> None:
    """EDDM's and Page-Hinkley's tiled kernels (``eddm_tiled_kernel``,
    whose chain walks only the errors; ``ph_tiled_kernel``, the mean and
    ``cum`` chains on one thread) against their plain loops on the host
    on the whole planted-drift batch (at least one restart each), and
    against the one-thread witness (``detector_scan_serial``) on the whole
    planted-drift, many-drift and ``int8_ef``-decoded batches, from
    carried states (in the warm-up; the counters near 2^24, so that they
    step one by one, also over a stretch without errors) and with the
    state carried over 128 calls of 512 events: every level equal, the
    state bitwise. Graph-timed beside the witness, with the events the
    chain walked and its restarts (``chain_stats``)."""
    import torch
    from repro_torch.kernels import detector_scan as ds
    from repro_torch.kernels import ops
    from repro_torch.streams import drift

    def same_bits(a, b):
        return all(bitwise(x.cpu().reshape(1), y.cpu().reshape(1))
                   for x, y in zip(a, b))

    def scan(det, state, e):
        before = ds.chain_stats(dev).clone()
        st, flag, lv = ds.detector_scan_cuda(det, state, e, levels=True)
        walked, restarts = (ds.chain_stats(dev) - before).tolist()
        return st, flag, lv, walked, restarts

    def held(det, state, e, what):
        st, flag, lv, walked, restarts = scan(det, state, e)
        wst, wflag, wlv = ds.detector_scan_serial_cuda(det, state, e,
                                                       levels=True)
        drifts = int((wlv == drift.DRIFT).sum())
        ok = same_bits(st, wst) and torch.equal(lv, wlv) and \
            bool(flag) == bool(wflag) == (drifts > 0)
        log(f"  detector_scan ({det}) on {what} ({e.numel()} events): "
            f"bitwise the serial witness, level for level {ok}; {drifts} "
            f"event(s) at DRIFT, {restarts} restart(s), chain {walked} "
            f"events")
        if not ok:
            raise AssertionError(f"detector scan ({det}) on {what} differs "
                                 "from its serial witness")
        return walked, restarts

    def state_of(det, values):
        cls = drift.EDDMState if det == "eddm" else drift.PHState
        return cls(*(torch.tensor(v, dtype=torch.float32, device=dev)
                     for v in values),
                   torch.tensor(0, dtype=torch.int32, device=dev))

    clock = max_sm_clock_hz()
    quiet = many.clone()
    quiet[:5000] = 0.0          # two tiles and more without an error
    big = 2.0 ** 24
    near = {"eddm": (big - 1000.0, big - 200.0, 9.0, 90.0 * (big - 1000.0),
                     28.0),
            "ph": (big - 1000.0, 0.25, 3.0, -2.0)}
    fractional = {"eddm": (7.5, 3.5, 9.0, 80.0, 20.0),
                  "ph": (7.5, 0.3, 1.0, -0.5)}
    for det, init_fn in (("eddm", drift.eddm_init), ("ph", drift.ph_init)):
        init = init_fn(dev)
        st, flag, lv, walked, restarts = scan(det, init, err)
        t0 = time.perf_counter()
        pst, plv = drift.run_detector(ds.STEPS[det], init_fn(), err.cpu())
        p_ms = (time.perf_counter() - t0) * 1e3
        pflag = bool((plv == drift.DRIFT).any())
        same = same_bits(st, pst) and torch.equal(lv.cpu(), plv) and \
            bool(flag) == pflag
        err_plain = max([float(bool(flag) != pflag),
                         float((lv.cpu() != plv).sum())] + [
            abs(float(a) - float(b)) for a, b in zip(st, pst)])
        log(f"  detector_scan ({det}) on the planted-drift batch "
            f"({err.numel()} events): bitwise the plain loop on the host "
            f"CPU, level for level {same} (drifted {pflag}, {restarts} "
            f"restart(s), chain {walked} events; plain {p_ms!r} ms, one "
            f"run)")
        if not same:
            raise AssertionError(f"detector scan ({det}) differs from its "
                                 "plain loop")
        if restarts < 1:
            raise AssertionError(f"detector scan ({det}): no restart where "
                                 "it is held to its plain loop")
        for what, e in (("planted drift", err), ("many drifts", many),
                        ("int8_ef errors", nonbinary)):
            walked, restarts = held(det, init, e, what)
            k_ms = graph_ms(lambda: ds.detector_scan_cuda(det, init, e), 20)
            w_ms = graph_ms(
                lambda: ds.detector_scan_serial_cuda(det, init, e), 3)
            floor_ms = walked * CHAIN_STEP_CYCLES / clock * 1e3
            log(f"    {det} on {what}: graph ms {k_ms!r} "
                f"({k_ms * 1e6 / max(walked, 1)!r} ns a chained event, "
                f"{walked} chained, {restarts} restart(s); the chain's floor "
                f"{floor_ms!r} ms at {CHAIN_STEP_CYCLES} cycles a step and "
                f"{clock / 1e9!r} GHz); the one-thread witness {w_ms!r} ms "
                f"({w_ms / k_ms!r}x)")
            if what == "planted drift":
                nops, nbytes = ops._scan_work(det, init, e)
                record("detector_scan",
                       "src/repro_torch/kernels/csrc/detector_scan.cu",
                       "src/repro/core/pipeline.py:687", err_plain, 0.0,
                       k_ms, p_ms, nbytes, nops, row=f"detector_scan/{det}")
                log(f"    detector_scan/{det}: ms, max_abs_err and plain_ms "
                    f"(host CPU) on the {e.numel()} planted-drift events")
        # carried states: the witness's after 300 many-drift events (EDDM
        # in its 50 errors' warm-up), a fractional counter, and counters
        # near 2^24 (past it c + 1 rounds back to c)
        mid, _ = ds.detector_scan_serial_cuda(det, init, many[:300])
        for tag, start in (("in the warm-up", mid),
                           ("a fractional counter",
                            state_of(det, fractional[det])),
                           ("counters near 2^24", state_of(det, near[det]))):
            for what, e in (("planted drift", err), ("many drifts", many),
                            ("a quiet stretch", quiet)):
                held(det, start, e, f"{what}, from {tag}")
        # the state carried from call to call, as the drift op carries it
        st, flags, lvs = init, [], []
        for piece in many.split(ADWIN_SMALL[1]):
            st, flag, lv = ds.detector_scan_cuda(det, st, piece, levels=True)
            flags.append(flag)
            lvs.append(lv)
        wst, wflag, wlv = ds.detector_scan_serial_cuda(det, init, many,
                                                       levels=True)
        ok = same_bits(st, wst) and torch.equal(torch.cat(lvs), wlv) and \
            bool(torch.stack(flags).any()) == bool(wflag)
        log(f"  detector_scan ({det}) over many drifts in {len(lvs)} calls "
            f"of {ADWIN_SMALL[1]} events, the state carried: bitwise the "
            f"serial witness's one call, level for level {ok}")
        if not ok:
            raise AssertionError(f"detector scan ({det}) with the state "
                                 "carried from call to call differs from "
                                 "its serial witness")


def scans_measure(dev) -> dict:
    """The drift scan alone in the tree under test, for ``--measure
    --scans``: each kind's path kernel (DDM, EDDM, PH, ADWIN) graph-timed
    on phase 2's planted-drift and many-drift batches (65,536 events)."""
    import torch
    from repro_torch.kernels import detector_scan as ds
    from repro_torch.streams import drift
    g = torch.Generator(device=dev).manual_seed(1234)
    at = torch.arange(N_EVENTS, device=dev)
    streams = {
        "planted": torch.where(at < N_EVENTS // 2, 0.1, 0.5),
        "many": torch.where((at // 500) % 2 == 0, 0.05, 0.6)}
    streams = {k: (torch.rand((N_EVENTS,), generator=g, device=dev)
                   < p).float() for k, p in streams.items()}
    out = {}
    for det in ("ddm", "eddm", "ph", "adwin"):
        init = getattr(drift, f"{det}_init")(dev)
        for what, e in streams.items():
            out[f"{det}_{what}_ms"] = graph_ms(
                lambda: ds.detector_scan_cuda(det, init, e), 20)
    return out


def adwin_kernel_checks(dev, record, err, many, nonbinary) -> None:
    """ADWIN's kernel (``adwin_scan_kernel``: cut tests across the grid,
    a rebase only where a drift's drop removes a bucket) bitwise its
    plain loop on the card on a prefix of the many-drift stream (the loop
    launches some 300 kernels an event), level for level; on the whole
    planted-drift, many-drift and ``int8_ef``-decoded batches against
    its serial witness (every level, and the state bitwise on the 0/1
    streams, within rtol 1e-5 on the decoded one), its one-warp witness
    (the previous kernel: the state bitwise on the 0/1 streams) and
    ``ref.adwin_scan_restart_ref`` on the card (every level, the state
    bitwise); from a carried state mid-burst. Graph-timed beside both
    witnesses, with its rounds, events at DRIFT and rebases; the bound
    is the row's yardstick (``ops._adwin_work``)."""
    import torch
    from repro_torch.kernels import detector_scan as ds
    from repro_torch.kernels import ops, ref
    from repro_torch.streams import drift

    def bitwise(a, b):
        return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))

    def rel_err(a, b):
        return max(float(((x.cpu().double() - y.cpu().double()).abs()
                          / y.cpu().double().abs().clamp(min=1.0)).max())
                   for x, y in zip(a, b))

    def scan(state, e):
        before = ds.adwin_stats(dev).clone()
        st, flag, lv = ds.detector_scan_cuda("adwin", state, e, levels=True)
        return st, flag, lv, (ds.adwin_stats(dev) - before).tolist()

    init = drift.adwin_init(dev)
    part = many[:ADWIN_PLAIN_N]
    got, gflag, glv, _ = scan(init, part)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pst, plv = drift.run_detector(drift.adwin_step, init, part)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    pflag = bool((plv == drift.DRIFT).any())
    ok = bitwise(got, pst) and bool(gflag) == pflag and torch.equal(glv, plv)
    # the row's error: the kernel against the plain loop on the prefix
    err_plain = max([float(bool(gflag) != pflag)] + [
        float((x.cpu().double() - y.cpu().double()).abs().max())
        for x, y in zip(got, pst)])
    log(f"  detector_scan (ADWIN) on {ADWIN_PLAIN_N} many-drift events: "
        f"bitwise the plain loop on the card, level for level {ok} "
        f"(drifted {pflag}, {int((plv == drift.DRIFT).sum())} events at "
        f"DRIFT, n_buckets {pst.n_buckets.tolist()}); plain {plain_ms!r} ms "
        "(one run)")
    if not ok:
        raise AssertionError("detector scan (adwin) differs from its plain "
                             "loop")
    nb_part = nonbinary[:ADWIN_PLAIN_N // 4]      # ~3 s of the loop
    gst, gflag, glv, _ = scan(init, nb_part)
    pst, plv = drift.run_detector(drift.adwin_step, init, nb_part)
    ok = torch.equal(glv, plv) and bool(gflag) == bool(
        (plv == drift.DRIFT).any()) and rel_err(gst, pst) <= 1e-5
    log(f"  detector_scan (ADWIN) on {nb_part.numel()} int8_ef-decoded "
        f"events: levels and flag the plain loop's {ok}, state bitwise "
        f"{bitwise(gst, pst)} (rel err {rel_err(gst, pst)!r})")
    if not ok:
        raise AssertionError("detector scan (adwin) on decoded errors "
                             "differs from its plain loop")
    for what, e in (("planted drift", err), ("many drifts", many),
                    ("int8_ef errors", nonbinary)):
        binary = what != "int8_ef errors"
        got, gflag, glv, (rounds, drifts, rebases) = scan(init, e)
        wst, wflag, wlv = ds.detector_scan_serial_cuda("adwin", init, e,
                                                       levels=True)
        vst, vflag = ds.adwin_warp_witness_cuda(init, e)
        # any window gives the same levels and state
        rst, rlv = ref.adwin_scan_restart_ref(init, e, 2112)
        levels_ok = torch.equal(glv, wlv) and torch.equal(glv, rlv)
        flags_ok = bool(gflag) == bool(wflag) == bool(vflag) == bool(
            (wlv == drift.DRIFT).any())
        if binary:
            state_ok = bitwise(got, wst) and bitwise(got, vst) and \
                bitwise(got, rst)
        else:
            state_ok = rel_err(got, wst) <= 1e-5 and bitwise(got, rst)
        e_ms = graph_ms(lambda: ds.detector_scan_cuda("adwin", init, e), 20)
        eager = median_ms(lambda: ds.detector_scan_cuda("adwin", init, e), 5)
        v_ms = graph_ms(lambda: ds.adwin_warp_witness_cuda(init, e), 2)
        w_ms = median_ms(lambda: ds.detector_scan_serial_cuda(
            "adwin", init, e), 1, warmup=0, trials=1)     # ~1 s a call
        log(f"  detector_scan (ADWIN) on {what} ({e.numel()} events): "
            f"levels the serial witness's and the ref's {levels_ok}, flags "
            f"{flags_ok}, state {'bitwise' if binary else 'within 1e-5 of'} "
            f"the witnesses {state_ok} (serial bitwise {bitwise(got, wst)}); "
            f"{drifts} events at DRIFT, {rebases} rebases, {rounds} rounds; "
            f"graph ms {e_ms!r} [eager {eager!r}] "
            f"({e_ms * 1e6 / e.numel()!r} ns an event); one-warp witness "
            f"graph ms {v_ms!r}; serial witness {w_ms!r} ms")
        if not (levels_ok and flags_ok and state_ok):
            raise AssertionError(f"detector scan (adwin) on {what} differs "
                                 "from its witnesses")
        if not e_ms < v_ms:
            raise AssertionError(f"detector scan (adwin) on {what}: {e_ms!r} "
                                 f"ms, not faster than its one-warp witness "
                                 f"({v_ms!r} ms)")
        if what == "planted drift":
            nops, nbytes = ops._adwin_work(e)
            record("detector_scan",
                   "src/repro_torch/kernels/csrc/detector_scan.cu",
                   "src/repro/core/pipeline.py:687", err_plain, 0.0,
                   e_ms, plain_ms, nbytes, nops, row=ADWIN_ROW)
            log(f"    {ADWIN_ROW}: ms on {e.numel()} events; max_abs_err and "
                f"plain_ms on the {ADWIN_PLAIN_N}-event prefix")
    # from a state carried mid-burst: the many-drift stream's first 517
    # events (its first drift) continued by the whole batch
    mid, _ = ds.detector_scan_serial_cuda("adwin", init, many[:517])
    got, gflag, glv, (rounds, drifts, rebases) = scan(mid, many)
    wst, wflag, wlv = ds.detector_scan_serial_cuda("adwin", mid, many,
                                                   levels=True)
    ok = bitwise(got, wst) and bool(gflag) == bool(wflag) and \
        torch.equal(glv, wlv)
    log(f"  detector_scan (ADWIN) from a carried state on many drifts: "
        f"bitwise the serial witness, level for level {ok} ({drifts} events "
        f"at DRIFT, {rebases} rebases, {rounds} rounds)")
    if not ok:
        raise AssertionError("detector scan (adwin) from a carried state "
                             "differs from its serial witness")
    # the state carried from call to call, as the drift op carries it:
    # the many-drift batch in calls of phase 19b's 512 events (the final
    # buckets mostly carried ones), against the serial witness's one call
    st, flags, lvs = init, [], []
    for part in many.split(ADWIN_SMALL[1]):
        st, flag, lv = ds.detector_scan_cuda("adwin", st, part, levels=True)
        flags.append(flag)
        lvs.append(lv)
    wst, wflag, wlv = ds.detector_scan_serial_cuda("adwin", init, many,
                                                   levels=True)
    ok = bitwise(st, wst) and torch.equal(torch.cat(lvs), wlv) and \
        bool(torch.stack(flags).any()) == bool(wflag)
    log(f"  detector_scan (ADWIN) over many drifts in {len(lvs)} calls of "
        f"{ADWIN_SMALL[1]} events, the state carried: bitwise the serial "
        f"witness's one call, level for level {ok}")
    if not ok:
        raise AssertionError("detector scan (adwin) with the state carried "
                             "from call to call differs from its serial "
                             "witness")


NORM_TOL = 1e-4     # rtol and atol: raw moments (kernel) against centred


def normalize_cases():
    """``(row, n, d, impute, all-NaN column)``: phase 5's shape, then the
    edge cases: no rows, one row, fewer rows than CTAs, rows off the
    CTA count, d 8 and 255 (4-byte loads), an all-NaN column, no impute,
    and rows too wide for a CTA's stage (d 20,000)."""
    yield "fused_normalize", N_EVENTS, DIM, True, False
    yield "normalize/n0", 0, DIM, True, False
    yield "normalize/n1", 1, DIM, True, False
    yield "normalize/n100", 100, DIM, True, False
    yield "normalize/ragged", N_EVENTS + 1, DIM, True, False
    yield "normalize/d8", 1000, 8, True, False
    yield "normalize/d255", 1000, 255, True, False
    yield "normalize/nan_column", 5000, DIM, True, True
    yield "normalize/no_impute", 5000, DIM, False, False
    yield "normalize/d20000", 777, 20000, True, False


def normalize_excess(got, want) -> float:
    """Largest excess of |got - want| over rtol/atol ``NORM_TOL`` over the
    four outputs; a NaN must meet a NaN (n = 0 leaves mean1 NaN in both)."""
    import torch
    worst = -math.inf
    for a, b in zip(got, want):
        if a.numel() == 0:
            continue
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            return math.inf
        ok = ~torch.isnan(b)
        if ok.any():
            worst = max(worst, float(((a[ok] - b[ok]).abs()
                                      - (NORM_TOL + NORM_TOL * b[ok].abs())
                                      ).max()))
    return worst


def normalize_kernel_checks(dev, g, record) -> None:
    """Row 1, the persistent normalize: within rtol/atol 1e-4 of its plain
    version and of the three-kernel witness on ``normalize_cases``; at
    phase 5's shape (65,536 x 256, 15% NaN) one call one kernel
    (``kernels_in_graph``: the cooperative launch captured by a CUDA
    graph), graph-timed with the inputs cycled past the L2, the witness
    and ``copy_`` of x (the bound's bytes) timed beside it."""
    import torch
    from repro_torch.kernels import preprocess, ref

    log(f"  normalize: {preprocess._lib().normalize_grid()} CTAs")
    for row, n, d, impute, nan_col in normalize_cases():
        x = torch.randn((n, d), generator=g, device=dev) * 2.0 + 0.5
        if impute:
            x[torch.rand((n, d), generator=g, device=dev) < 0.15] = math.nan
        if nan_col:
            x[:, 3] = math.nan
        n0 = torch.tensor(1000.0, device=dev)   # on the card, as the path's
        mean0 = torch.randn((d,), generator=g, device=dev)
        m20 = (torch.rand((d,), generator=g, device=dev) + 0.1) * n0
        got = preprocess.fused_normalize_cuda(x, n0, mean0, m20,
                                              impute=impute)
        want = ref.fused_normalize_ref(x, n0, mean0, m20, impute=impute)
        wit = preprocess.fused_normalize_witness_cuda(x, n0, mean0, m20,
                                                      impute=impute)
        torch.cuda.synchronize()
        excess = {"plain": normalize_excess(got, want),
                  "witness": normalize_excess(got, wit)}
        finite = n == 0 or bool(torch.isfinite(got[0]).all())
        log(f"  {row}: ({n}, {d}) impute={impute}, excess over rtol/atol "
            f"{NORM_TOL}: {excess}; y finite {finite}")
        if not (max(excess.values()) <= 0.0 and finite):
            raise AssertionError(f"{row}: the normalize kernel is outside "
                                 f"rtol/atol {NORM_TOL} or not finite")
        if row != "fused_normalize":
            del x, got, want, wit
            continue
        yerr = float((got[0] - want[0]).abs().max())
        ytol = NORM_TOL + NORM_TOL * float(want[0].abs().max())
        del got, want, wit
        nodes = kernels_in_graph(
            lambda: preprocess.fused_normalize_cuda(x, n0, mean0, m20))
        log(f"    one call's CUDA graph: {nodes}")
        if len(nodes) != 1 or "normalize_persistent" not in nodes[0]:
            raise AssertionError(f"normalize: one call's CUDA graph holds "
                                 f"{nodes}")
        sets = [(x,)] + [(x.clone(),) for _ in range(n_sets((x,)) - 1)]
        reps = max(20, len(sets))
        call = cycling(lambda x_: preprocess.fused_normalize_cuda(
            x_, n0, mean0, m20), sets)
        ms, eager = graph_ms(call, reps), median_ms(call, reps)
        witness_ms = graph_ms(cycling(
            lambda x_: preprocess.fused_normalize_witness_cuda(
                x_, n0, mean0, m20), sets), reps)
        outs = [(x_, torch.empty_like(x_)) for (x_,) in sets]
        copy_ms = graph_ms(cycling(lambda a, b: b.copy_(a), outs), reps)
        log(f"    graph ms: kernel {ms!r} [eager {eager!r}], the "
            f"three-kernel witness {witness_ms!r}, copy_ of x {copy_ms!r}")
        n_el = n * d
        record("fused_normalize", "src/repro_torch/kernels/csrc/preprocess.cu",
               "src/repro/kernels/preprocess.py:92", yerr, ytol, ms,
               median_ms(lambda: ref.fused_normalize_ref(x, n0, mean0, m20),
                         5),
               2 * n_el * 4 + 3 * d * 4 * 2, 8 * n_el)
        del x, sets, outs
    torch.cuda.empty_cache()


def hash_cases(g, dev):
    """``(row, ids, vals, dim)``: the hashed job's shape, ids over the
    full int32 range, then the traps: -0.0, NaN and +-inf among colliding
    features, f off the warp's pass of 32, ragged n, dims off 4 and past
    the stage (the row-thread route), no rows."""
    import torch

    def draw(n, f, lo=-2 ** 31, hi=2 ** 31 - 1):
        ids = torch.randint(lo, hi, (n, f), generator=g, device=dev,
                            dtype=torch.int64).to(torch.int32)
        return ids, torch.randn((n, f), generator=g, device=dev)

    special = torch.tensor([-0.0, 0.0, math.nan, math.inf, -math.inf, 1.5,
                            -2.25], device=dev)
    ids, _ = draw(4099, 40, 0, 40)
    pick = torch.randint(0, len(special), (4099, 40), generator=g, device=dev)
    yield ("fused_hash_features", *draw(N_EVENTS, HASH_F), HASH_DIM)
    yield "hash/specials", ids, special[pick], 16
    for f in (1, 7, 33, 64):
        yield (f"hash/f{f}", *draw(3001, f), HASH_DIM)
    yield ("hash/ragged", *draw(N_EVENTS - 1, HASH_F), HASH_DIM)
    yield ("hash/dim8", *draw(999, HASH_F), 8)
    yield ("hash/dim1000", *draw(777, HASH_F), 1000)
    yield ("hash/dim20000 (row-thread route)", *draw(300, HASH_F), 20000)
    yield ("hash/n0", *draw(0, HASH_F), HASH_DIM)


def hash_kernel_checks(dev, g, record) -> None:
    """Row 2, the staged hash kernel: bitwise its plain version and the
    row-thread witness (the kernel it replaced) at the hashed job's shape
    (65,536 x 32 -> 1,024) and on ``hash_cases``' traps, one call one
    kernel (``kernels_in_graph``); graph-timed with the inputs cycled past
    the L2 (eager, the witness and ``torch.zeros`` of the same output
    logged beside it: no library call computes the function)."""
    import torch
    from repro_torch.kernels import preprocess, ref

    for row, ids, vals, dim in hash_cases(g, dev):
        out = preprocess.fused_hash_features_cuda(ids, vals, dim)
        pout = ref.hash_features_ref(ids, vals, dim)
        wout = preprocess.hash_features_rowthread_cuda(ids, vals, dim)
        torch.cuda.synchronize()
        same = {"plain": bitwise(out, pout), "witness": bitwise(out, wout)}
        neg0 = int((pout.view(torch.int32) == -2 ** 31).sum())
        log(f"  {row}: ({ids.shape[0]}, {ids.shape[1]}) -> {dim}, bitwise "
            f"{same}; cells -0.0 {neg0}, NaN {int(torch.isnan(pout).sum())}"
            f", inf {int(torch.isinf(pout).sum())}")
        if not all(same.values()):
            raise AssertionError(f"{row}: the hash kernel is not bitwise its "
                                 f"plain version and witness: {same}")
        if row == "hash/specials" and not (torch.isnan(pout).any()
                                           and torch.isinf(pout).any()):
            raise AssertionError("hash/specials: no NaN or inf cell to check")
        if row != "fused_hash_features":
            continue
        if int((ids < 0).sum()) == 0:
            raise AssertionError("hash check drew no negative ids")
        err = float((out - pout).abs().max())
        del out, pout, wout
        nodes = kernels_in_graph(
            lambda: preprocess.fused_hash_features_cuda(ids, vals, dim))
        if len(nodes) != 1 or "hash_staged" not in nodes[0]:
            raise AssertionError(f"hash: one call's CUDA graph holds {nodes}")
        log(f"    one call's CUDA graph: {nodes}")
        n, f = ids.shape
        sets = [(ids, vals)] + [(ids.clone(), vals.clone())
                                for _ in range(n_sets((ids, vals)) - 1)]
        reps = max(20, len(sets))
        call = cycling(lambda i, v: preprocess.fused_hash_features_cuda(
            i, v, dim), sets)
        ms, eager = graph_ms(call, reps), median_ms(call, reps)
        witness_ms = graph_ms(cycling(
            lambda i, v: preprocess.hash_features_rowthread_cuda(i, v, dim),
            sets), reps)
        zeros_ms = graph_ms(lambda: torch.zeros((n, dim), device=dev), reps)
        log(f"    graph ms: kernel {ms!r} [eager {eager!r}], the row-thread "
            f"witness {witness_ms!r}, torch.zeros of the output {zeros_ms!r}")
        record("fused_hash_features",
               "src/repro_torch/kernels/csrc/preprocess.cu",
               "src/repro/kernels/preprocess.py:159", err, 0.0, ms,
               median_ms(lambda: ref.hash_features_ref(ids, vals, dim), 5),
               n * f * 8 + n * dim * 4, n * f * 8)
        del sets
    torch.cuda.empty_cache()


def bitwise(a, b) -> bool:
    """Equal bit for bit (so -0 differs from +0, and NaN matches itself)."""
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def topk_kernel_checks(dev, record) -> None:
    """The top-k EF round-trip (radix select on the card) at the dense
    job's two shapes and on 16.7M elements with many ties at the
    threshold, with all keys equal (more than pass 1 keeps) and with the
    sample's window missing the threshold (the last two send pass 2 back
    to x and r): bitwise its plain version and its witness
    (``torch.topk``'s threshold, then the int8 kernels), the select
    bitwise ``torch.topk``'s k-th largest, every tie kept, ``dec + r' ==
    x + r``; one call a CUDA graph of a memset and the select and apply
    kernels (no host sync).
    Times from CUDA-graph replays with the inputs cycled past the L2
    (eager in brackets); ``library_ms``: ``torch.topk``'s threshold, the
    select stage alone."""
    import torch
    from repro_torch.kernels import ef_codec, ref
    g = torch.Generator(device=dev).manual_seed(18)

    def planted_ties(shape):
        # values on a grid of 1/8: about 1% of them tie at any threshold
        x = torch.round(torch.randn(shape, generator=g, device=dev) * 8) / 8
        return torch.zeros(shape, device=dev), x

    def all_equal(shape):
        # every key in one bin: more than pass 1 has room to keep
        sign = torch.rand(shape, generator=g, device=dev) < 0.5
        return (torch.zeros(shape, device=dev),
                torch.where(sign, -0.75, 0.75).to(torch.float32))

    def sample_missed(shape):
        # large values at exactly the sample's positions: its window lies
        # far above the true threshold, and pass 2 reads x and r again
        x = torch.randn(shape, generator=g, device=dev) * 0.5
        x.view(-1)[::x.numel() // 65536] += 100.0
        return torch.zeros(shape, device=dev), x

    # (row, shape, inputs, whether pass 2 should take pass 1's kept keys:
    # up to 65,536 elements it reads x and r again)
    cases = (("ef_topk_int8_roundtrip", (N_EVENTS, DIM), None, True),
             ("ef_topk_int8_roundtrip/65536", (N_EVENTS,), None, False),
             ("ef_topk_int8_roundtrip/ties", (N_EVENTS, DIM), planted_ties,
              None),
             ("ef_topk_int8_roundtrip/all_equal", (N_EVENTS, DIM), all_equal,
              False),
             ("ef_topk_int8_roundtrip/sample_missed", (N_EVENTS, DIM),
              sample_missed, False))
    for row, shape, make, from_kept in cases:
        if make is None:
            r = torch.randn(shape, generator=g, device=dev) * 0.01
            x = torch.randn(shape, generator=g, device=dev)
        else:
            r, x = make(shape)
        n = x.numel()
        k = int(round(0.1 * n))
        dec, rout = ef_codec.ef_topk_int8_roundtrip_cuda(r, x, k)
        pdec, prout = ref.ef_topk_int8_roundtrip_ref(r, x, k)
        wdec, wrout = ef_codec.ef_topk_int8_roundtrip_witness_cuda(r, x, k)
        mag = torch.abs(x.reshape(-1) + r.reshape(-1))
        t, state = ef_codec.ef_topk_threshold_cuda(r, x, k, state=True)
        tt = torch.topk(mag, k).values[-1]
        torch.cuda.synchronize()
        kept, at_t = int((mag >= t).sum()), int((mag == t).sum())
        same = {"plain": bitwise(dec, pdec) and bitwise(rout, prout),
                "witness": bitwise(dec, wdec) and bitwise(rout, wrout),
                "select_vs_torch.topk": bitwise(t, tt),
                "identity": bool(((dec + rout) == (x + r)).all()),
                "kept>=k": kept >= k,
                # no kept value is small enough to decode to 0 here
                "decoded_iff_|xc|>=t": torch.equal((dec != 0).reshape(-1),
                                                   mag >= t)}
        if from_kept is not None:
            same["pass2_path"] = state["from_kept"] == from_kept
        log(f"  {row}: n {n}, k {k}, t {float(t)!r}, {at_t} at t, {kept} "
            f"kept; select {state}; {same}")
        if not all(same.values()):
            raise AssertionError(f"{row}: {same}")
        if make is not None:
            continue
        nodes = kernels_in_graph(
            lambda: ef_codec.ef_topk_int8_roundtrip_cuda(r, x, k))
        want = ["memset"] + ["select_sample"] * (n > 65536) + [
            "select_pass1", "select_pass2", "topk_apply"]
        if len(nodes) != len(want) or not all(
                w in got for w, got in zip(want, nodes)):
            raise AssertionError(f"{row}: one call's CUDA graph holds "
                                 f"{nodes}, not {want}")
        log(f"    one call's CUDA graph: {nodes}")
        err = max(float((dec - pdec).abs().max()),
                  float((rout - prout).abs().max()))
        sets = [(r, x)] + [(r.clone(), x.clone())
                           for _ in range(n_sets((r, x)) - 1)]
        reps = max(20, len(sets))
        call = cycling(lambda r_, x_: ef_codec.ef_topk_int8_roundtrip_cuda(
            r_, x_, k), sets)
        ms, eager = graph_ms(call, reps), median_ms(call, reps)
        witness_ms = graph_ms(cycling(
            lambda r_, x_: ef_codec.ef_topk_int8_roundtrip_witness_cuda(
                r_, x_, k), sets), reps)
        select_ms = graph_ms(cycling(
            lambda r_, x_: ef_codec.ef_topk_threshold_cuda(r_, x_, k), sets),
            reps)
        mags = [(torch.abs(x_.reshape(-1) + r_.reshape(-1)),)
                for r_, x_ in sets]
        topk_ms = graph_ms(cycling(lambda a: ref.topk_threshold(a, k), mags),
                           reps)
        log(f"    graph ms: kernel {ms!r} [eager {eager!r}], its select "
            f"{select_ms!r}, torch.topk's threshold {topk_ms!r}, the "
            f"witness path (torch.topk + int8 kernels) {witness_ms!r}")
        record("ef_topk_int8_roundtrip",
               "src/repro_torch/kernels/csrc/ef_codec.cu",
               "src/repro/kernels/ef_codec.py:145", err, 0.0, ms,
               median_ms(lambda: ref.ef_topk_int8_roundtrip_ref(r, x, k), 3),
               16 * n + 4, 10 * n, library_ms=topk_ms,
               library="torch.topk threshold, the select alone",
               row=None if row == "ef_topk_int8_roundtrip" else row)
        del sets, mags
    del r, x, dec, rout, pdec, prout, wdec, wrout, mag
    torch.cuda.empty_cache()


def attended_pairs(S: int, T: int, causal: bool) -> int:
    """(query, key) pairs the mask keeps, summed over S query rows."""
    if not causal:
        return S * T
    return sum(min(s + 1, T) for s in range(S))


def flash_cases():
    """``(row, B, S, T, H, KV, D, causal)`` for the flash checks:
    seamless-m4t-medium's cross-attention (B 8, 16 heads, T = PROMPT) at
    each built head dim, then llama-3.2-vision-90b's (64 query heads on 8
    KV heads, FLASH_VLM_T image tokens, D 128) at batch 1 and 2. The
    first row is the kernel's row in the ``kernels`` line."""
    B, H = SERVE_BATCH, 16
    out = []
    for D in FLASH_HEAD_DIMS:
        tag = "" if D == 64 else f"/d{D}"
        out += [(f"flash_attention{tag}", B, PROMPT, PROMPT, H, H, D, False),
                (f"flash_attention/decode{tag}", B, 1, PROMPT, H, H, D,
                 False),
                (f"flash_attention/causal{tag}", B, PROMPT, PROMPT, H, H, D,
                 True)]
    for B in FLASH_VLM_BATCHES:
        out += [(f"flash_attention/vlm_b{B}", B, PROMPT, FLASH_VLM_T, 64, 8,
                 128, False),
                (f"flash_attention/vlm_b{B}_decode", B, 1, FLASH_VLM_T, 64, 8,
                 128, False)]
    return out


def flash_inputs(g, dev, dtype, B, S, T, H, KV, D):
    """q (B, S, H, D) and k, v (B, T, KV, D) as strided views, as
    cross-attention hands them over: q a slice of a (B, S, 2, H, D)
    buffer, k and v the two halves of a (B, T, 2, KV, D) one, so that only
    the last axis is contiguous."""
    import torch
    qb = torch.randn((B, S, 2, H, D), generator=g, device=dev).to(dtype)
    kvb = torch.randn((B, T, 2, KV, D), generator=g, device=dev).to(dtype)
    return qb[:, :, 0], kvb[:, :, 0], kvb[:, :, 1]


def cycling(fn, sets):
    """``fn`` on each input set in turn: enough sets that their bytes pass
    twice the L2 cache, so that a timed launch reads device memory as the
    path does (a decode step reads each layer's cross-attention K, V
    once)."""
    import itertools
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def n_sets(tensors) -> int:
    nbytes = sum(t.untyped_storage().nbytes() for t in tensors)
    return max(1, -(-2 * L2_BYTES // nbytes))


def sdpa_library_ms(sets, causal: bool, reps: int, want):
    """The library yardstick: ``F.scaled_dot_product_attention`` on 4-D
    (B, H, S, D) copies of the inputs, under ``sdpa_kernel`` with one
    fused backend at a time, so that none falls back to the math path.
    Returns ``(ms, backend)`` of the fastest (``(None, None)`` if every
    backend refuses the shape) and one note a backend: its time and its
    max error against the plain version, or why it refused."""
    import warnings
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sets4 = [tuple(t.transpose(1, 2).contiguous() for t in s) for s in sets]
    kw = {"is_causal": causal}
    if sets[0][0].shape[2] != sets[0][1].shape[2]:
        kw["enable_gqa"] = True

    def call(q4, k4, v4):
        return F.scaled_dot_product_attention(q4, k4, v4, **kw)

    best, notes = (None, None), []
    for backend in FLASH_LIBRARY_BACKENDS:
        be = getattr(SDPBackend, backend)
        with sdpa_kernel([be]):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                try:
                    out = call(*sets4[0])
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    notes.append(f"{backend} refused: "
                                 f"{refusal(caught) or str(e).splitlines()[0]}")
                    continue
            err = float((out.transpose(1, 2).float() - want.float()
                         ).abs().max())
            ms = graph_ms(cycling(call, sets4), reps)
            eager = median_ms(cycling(call, sets4), reps)
        notes.append(f"{backend} {ms!r} ms, eager {eager!r} "
                     f"(max_abs_err {err!r})")
        if best[0] is None or ms < best[0]:
            best = (ms, backend)
    return best, notes


def refusal(caught) -> str:
    """SDPA's reasons for refusing a backend, from its warnings, without
    the notes on the backends ``sdpa_kernel`` turned off."""
    why = []
    for w in caught:
        msg = str(w.message).split(" (Triggered internally")[0].strip()
        if msg and not msg.endswith("not used because:") and \
                "runtime disabled" not in msg and msg not in why:
            why.append(msg)
    return "; ".join(why)


GRAPH_NODE_TYPES = {1: "memcpy", 2: "memset", 3: "host", 4: "child_graph",
                    6: "wait_event", 7: "event_record", 10: "mem_alloc",
                    11: "mem_free"}     # CUgraphNodeType; 0 kernel, 5 empty


def kernels_in_graph(fn) -> list:
    """The device work of one call of ``fn`` as the CUDA driver lists it:
    one call captured into a CUDA graph, its nodes read by
    :func:`graph_node_names`. Needs no profiler."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    names = graph_node_names(graph.raw_cuda_graph())
    del graph
    return names


def kernels_of_one_call(fn, tries: int = 3) -> list:
    """The names of the CUDA kernels ``fn`` launches, from a
    ``torch.profiler`` trace of one call (after one untraced call), held
    to the driver's list of the same call's work (``kernels_in_graph``):
    both must count the same launches. A trace that holds no device
    activity at all is taken again, up to ``tries`` traces; the profiler
    now and then returns only empty ones for the rest of a process (seen
    on the H100), and then the graph's list stands alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    in_graph = kernels_in_graph(fn)
    names = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    if not names:
        log(f"    (torch.profiler traced no device activity in {tries} "
            f"traces; the CUDA graph of one call holds {in_graph})")
        return in_graph
    if len(names) != len(in_graph):
        raise AssertionError(f"the profiler traced {names}, the CUDA graph "
                             f"of one call holds {in_graph}")
    return names


def flash_kernel_checks(dev, g, record):
    """The flash kernels against their plain version on strided
    model-layout inputs (``flash_inputs``), bf16 and fp32, at every case
    of ``flash_cases``; one CUDA kernel a model-layout call (profiler)."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    bf16_eps = float(torch.finfo(torch.bfloat16).eps)
    for dtype, suffix in ((torch.bfloat16, ""), (torch.float32, "/fp32")):
        es = torch.finfo(dtype).bits // 8
        for row, B, S, T, H, KV, D, causal in flash_cases():
            row += suffix
            q, k, v = flash_inputs(g, dev, dtype, B, S, T, H, KV, D)
            got = fa.flash_attention(q, k, v, causal=causal)
            want = fa.flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"{row}: non-finite output")
            err = float((got.float() - want.float()).abs().max())
            if dtype == torch.bfloat16:
                # one bf16 ulp of the largest output: both accumulate in
                # fp32 and round once to bf16 (P rounded to bf16 before
                # P V moves each output by far less; see the kernel's note)
                tol = bf16_eps * float(want.float().abs().max())
            else:   # fp32 on both sides, other summation orders
                tol = 1e-4 * float(want.abs().max())
            names = kernels_of_one_call(
                lambda: fa.flash_attention(q, k, v, causal=causal))
            if len(names) != 1 or "flash" not in names[0]:
                raise AssertionError(f"{row}: one model-layout call launched "
                                     f"{names}, not one flash kernel")
            sets = [(q, k, v)] + [
                flash_inputs(g, dev, dtype, B, S, T, H, KV, D)
                for _ in range(n_sets((q, k, v)) - 1)]
            reps = 50 if S == 1 else 20
            (lib_ms, backend), notes = sdpa_library_ms(sets, causal, reps,
                                                       want)
            pairs = attended_pairs(S, T, causal)
            mm = 4 * B * H * pairs * D
            splits = fa.kv_splits(B, S, T, H, KV, dtype, causal)
            kernel = cycling(lambda *t: fa.flash_attention(
                *t, causal=causal), sets)
            log(f"  {row}: B={B} S={S} T={T} H={H} KV={KV} D={D} "
                f"causal={causal} kv_splits={splits} kernel={names[0]!r} "
                f"eager_ms={median_ms(kernel, reps)!r}; "
                f"library: {' | '.join(notes)}")
            record("flash_attention",
                   "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:77", err, tol,
                   graph_ms(kernel, reps),
                   median_ms(lambda: fa.flash_attention_plain(
                       q, k, v, causal=causal), 5),
                   es * (2 * B * S * H * D + 2 * B * T * KV * D),
                   # fp32: the products too run on the CUDA cores
                   5 * B * H * pairs + (mm if es == 4 else 0),
                   tensor_ops=mm if es == 2 else 0,
                   library_ms=lib_ms, library=backend, row=row)
            del q, k, v, got, want, sets
        torch.cuda.empty_cache()


def serve_smoke_config(dev, arch: str = "seamless-m4t-medium"):
    """A smoke configuration (seamless-m4t-medium's: d_head 16, fp32)
    served on the card through ``ServeEngine(impl="kernel")``, its
    cross-attention through the flash kernel, and through
    ``impl="chunked"``: the greedy tokens must be equal."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model_zoo as zoo
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config(arch, smoke=True)
    params = zoo.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(8, 33, size=SMOKE_SERVE_REQUESTS)]
    tokens, flash = {}, {}
    for impl in ("kernel", "chunked"):
        ops.reset_launch_counts()
        eng = ServeEngine(cfg, params, batch_size=4, max_len=64, impl=impl,
                          seed=0)
        reqs = [Request(i, p, max_new_tokens=SMOKE_SERVE_TOKENS)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        torch.cuda.synchronize()
        tokens[impl] = [r.out_tokens for r in reqs]
        flash[impl] = ops.launch_counts()["flash_attention"]
    same = tokens["kernel"] == tokens["chunked"]
    log(f"  {cfg.name} (d_head {cfg.d_head}, {cfg.param_dtype}): "
        f"{len(prompts)} requests x {SMOKE_SERVE_TOKENS} greedy tokens; "
        f"kernel tokens equal chunked: {same}; flash launches "
        f"{flash['kernel']} (kernel), {flash['chunked']} (chunked)")
    if not same:
        raise AssertionError(f"{cfg.name}: impl='kernel' tokens differ from "
                             "impl='chunked'")
    if flash["kernel"] <= 0 or flash["chunked"] != 0:
        raise AssertionError(f"{cfg.name}: flash launches {flash}")


def serving_kernel_checks(dev, g, record):
    """The serving path's two kernels against their plain versions at the
    path's shapes: flash attention (``flash_kernel_checks``), then the
    smoke configuration served through it, then WKV
    (``wkv_kernel_checks``)."""
    import torch
    flash_kernel_checks(dev, g, record)
    serve_smoke_config(dev)
    wkv_kernel_checks(dev, g, record)
    pad_route_checks(dev, g, record, ("flash", "wkv"))
    torch.cuda.empty_cache()     # phase 3 starts from an empty cache


# the sizes the kernels are not built for that their wrappers pad up
PAD_FLASH_DIMS = (32, 96, 192)   # -> 64, 128, 256
PAD_WKV_HS = (32, 96)            # -> 64, 128
PAD_MAMBA_N = (8, 24)            # -> 16, 32
# one size above each kernel's largest built one: flash's wide kernel,
# WKV as (key block, value block) heads of 128, Mamba as groups of <= 64
# states (two launches at 80); rows of their own, with 0 launches
ABOVE_FLASH_D, ABOVE_WKV_HS, ABOVE_MAMBA_N = 320, 160, 80
# a head dim whose 16 rows of fp32 accumulator do not fit a block's shared
# memory: the wide kernel keeps them in scratch (held, not timed)
FLASH_SCRATCH_D = 4000
ABOVE_ROWS = tuple(
    [f"flash_attention/d{ABOVE_FLASH_D}{t}"
     for t in ("", "/decode", "/causal", "/fp32")]
    + [f"rwkv6_wkv/hs{ABOVE_WKV_HS}{t}" for t in ("", "/decode", "/fp32")]
    + [f"mamba_scan/N{ABOVE_MAMBA_N}{t}" for t in ("", "/decode")])
# the kernels' largest sizes, above every shipped config's: rows of their
# own in the kernels line, with 0 launches (no main path runs them)
WIDE_ROWS = ("flash_attention/d256", "flash_attention/decode/d256",
             "flash_attention/causal/d256", "flash_attention/d256/fp32",
             "rwkv6_wkv/hs128", "rwkv6_wkv/hs128_decode",
             "mamba_scan/N32", "mamba_scan/N64")


def pad_route_checks(dev, g, record, which):
    """The dispatching wrappers' pad routes on the card: flash attention
    at head dims 32, 96 and 192, WKV at head sizes 32 and 96, Mamba at 8
    and 24 states, each zero-padded up to the next built size; and one
    size above each largest built size: flash D 320 (the wide kernel),
    WKV hs 160 (blocks of 128 as heads of one call), Mamba N 80 (groups
    of 64 and 16 states, a launch each). Every call is one launch of
    the kernel (Mamba N 80: two) plus the pads' copies (its CUDA graph's
    node list), held to the plain version at the original size with the
    tolerance of the rows it extends; the row's bound is the original
    size's work. Flash at D 4,000 (its accumulator in scratch) is held
    to its plain version too, untimed."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_wkv as wkv

    bf16_eps = float(torch.finfo(torch.bfloat16).eps)

    def one_kernel(row, fn, tag, want=1):
        nodes = kernels_in_graph(fn)
        hits = [n for n in nodes if tag in n]
        log(f"  {row}: one call's CUDA graph: {nodes}")
        if len(hits) != want:
            raise AssertionError(f"{row}: {len(hits)} {tag} kernels in one "
                                 f"call's graph: {nodes}")

    if "flash" in which:
        B, H, T = SERVE_BATCH, 16, PROMPT
        for D, name in [(d, f"pad_d{d}") for d in PAD_FLASH_DIMS] + [
                (ABOVE_FLASH_D, f"d{ABOVE_FLASH_D}")]:
            for tag, S, causal, dtype in (
                    ("", PROMPT, False, torch.bfloat16),
                    ("/decode", 1, False, torch.bfloat16),
                    ("/causal", PROMPT, True, torch.bfloat16),
                    ("/fp32", PROMPT, False, torch.float32)):
                row = f"flash_attention/{name}{tag}"
                es = torch.finfo(dtype).bits // 8
                q, k, v = flash_inputs(g, dev, dtype, B, S, T, H, H, D)
                got = fa.flash_attention(q, k, v, causal=causal)
                want = fa.flash_attention_plain(q, k, v, causal=causal)
                if got.shape != want.shape or \
                        not torch.isfinite(got.float()).all():
                    raise AssertionError(f"{row}: misshapen or non-finite")
                err = float((got.float() - want.float()).abs().max())
                scale = float(want.float().abs().max())
                tol = (bf16_eps if es == 2 else 1e-4) * scale
                call = lambda: fa.flash_attention(q, k, v, causal=causal)
                one_kernel(row, call, "flash")
                pairs = attended_pairs(S, T, causal)
                mm = 4 * B * H * pairs * D
                reps = 50 if S == 1 else 20
                # the library at the original D, on the same inputs
                (lib_ms, backend), notes = sdpa_library_ms(
                    [(q, k, v)], causal, reps, want)
                log(f"  {row}: library: {' | '.join(notes)}")
                record("flash_attention",
                       "src/repro_torch/kernels/csrc/flash_attention.cu",
                       "src/repro/kernels/flash_attention.py:77", err, tol,
                       graph_ms(call, reps),
                       median_ms(lambda: fa.flash_attention_plain(
                           q, k, v, causal=causal), 5),
                       es * (2 * B * S * H * D + 2 * B * T * H * D),
                       5 * B * H * pairs + (mm if es == 4 else 0),
                       tensor_ops=mm if es == 2 else 0, library_ms=lib_ms,
                       library=backend, row=row)
                del q, k, v, got, want
        for causal, dtype in ((True, torch.float32), (False, torch.bfloat16)):
            q, k, v = flash_inputs(g, dev, dtype, 2, 17, 70, 4, 2,
                                   FLASH_SCRATCH_D)
            got = fa.flash_attention(q, k, v, causal=causal)
            want = fa.flash_attention_plain(q, k, v, causal=causal)
            err = float((got.float() - want.float()).abs().max())
            tol = (bf16_eps if dtype == torch.bfloat16 else 1e-4) * float(
                want.float().abs().max())
            log(f"  flash_attention at D {FLASH_SCRATCH_D} ({dtype}, causal "
                f"{causal}; the accumulator in scratch: "
                f"{not fa._lib().flash_wide_in_smem(FLASH_SCRATCH_D)}): "
                f"max_abs_err={err!r} tol={tol!r}")
            if not err <= tol:
                raise AssertionError(f"flash_attention at D {FLASH_SCRATCH_D}"
                                     " disagrees with its plain version")
            del q, k, v, got, want
    if "wkv" in which:
        B, chunk = SERVE_BATCH, WKV_CHUNK
        sizes = [(hs, f"pad_hs{hs}") for hs in PAD_WKV_HS] + [
            (ABOVE_WKV_HS, f"hs{ABOVE_WKV_HS}")]
        for hs, name, tag, S, dtype in (
                (hs, name, tag, S, dtype) for hs, name in sizes
                for tag, S, dtype in (
                    ("", PROMPT, torch.bfloat16),
                    ("/decode", 1, torch.bfloat16),
                    ("/fp32", PROMPT, torch.float32))):
            row = f"rwkv6_wkv/{name}{tag}"
            es = torch.finfo(dtype).bits // 8
            args = wkv_inputs(g, dev, B, S, hs, dtype)
            o, h = ops.rwkv6_wkv(*args, chunk=chunk)
            po, ph = wkv.rwkv6_wkv_plain(*args, chunk=chunk)
            if o.shape != po.shape or h.shape != ph.shape or not (
                    torch.isfinite(o.float()).all()
                    and torch.isfinite(h).all()):
                raise AssertionError(f"{row}: misshapen or non-finite")
            htol = 1e-4 * float(ph.abs().max())
            herr = float((h - ph).abs().max())
            err = float((o.float() - po.float()).abs().max())
            tol = (bf16_eps if es == 2 else 1e-4) * float(
                po.float().abs().max()) + htol
            log(f"  {row}: h_last max_abs_err={herr!r} tol={htol!r}")
            if not herr <= htol:
                raise AssertionError(f"{row}: h_last disagrees")
            call = lambda: ops.rwkv6_wkv(*args, chunk=chunk)
            one_kernel(row, call, "wkv")
            nbytes, fops, tops = wkv_work(B, S, hs, chunk, es)
            record("rwkv6_wkv", "src/repro_torch/kernels/csrc/rwkv6_wkv.cu",
                   "src/repro/kernels/rwkv6_wkv.py:71", err, tol,
                   graph_ms(call, 50 if S == 1 else 20),
                   median_ms(lambda: wkv.rwkv6_wkv_plain(*args, chunk=chunk),
                             1),
                   nbytes, fops, tensor_ops=tops, row=row)
            del args, o, h, po, ph
    if "mamba" in which:
        B, dI = MAMBA_B, MAMBA_DI
        sizes = [(N, f"pad_N{N}") for N in PAD_MAMBA_N] + [
            (ABOVE_MAMBA_N, f"N{ABOVE_MAMBA_N}")]
        for N, name, tag, S in ((N, name, tag, S) for N, name in sizes
                                for tag, S in (("", MAMBA_CHECK_S),
                                               ("/decode", 1))):
            row = f"mamba_scan/{name}{tag}"
            ins = mamba_inputs(g, dev, S, N)
            y, h = ops.mamba_scan(*ins, chunk=MAMBA_CHUNK)
            t0 = time.perf_counter()
            py, ph = ms.mamba_scan_ref(*ins)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            if h.shape != (B, dI, N) or not (torch.isfinite(y).all()
                                             and torch.isfinite(h).all()):
                raise AssertionError(f"{row}: misshapen or non-finite")
            excess = max(mamba_excess(y, py), mamba_excess(h, ph))
            log(f"  {row} (B {B}, S {S}, dI {dI}, N {N}): elementwise "
                f"excess over rtol=atol={MAMBA_TOL}: {excess!r}")
            if excess > 0.0:
                raise AssertionError(f"{row}: outside rtol=atol={MAMBA_TOL}")
            call = lambda: ops.mamba_scan(*ins, chunk=MAMBA_CHUNK)
            one_kernel(row, call, "mamba", len(ms.state_groups(N)))
            err = max(float((y - py).abs().max()), float((h - ph).abs().max()))
            tol = MAMBA_TOL * (1 + float(torch.maximum(py.abs().max(),
                                                       ph.abs().max())))
            record("mamba_scan", "src/repro_torch/kernels/csrc/mamba_scan.cu",
                   "src/repro/kernels/mamba_scan.py:70", err, tol,
                   graph_ms(call, 20 if S > 1 else 100), plain_ms,
                   4 * (3 * B * S * dI + 2 * B * S * N + dI * N
                        + 2 * B * dI * N),
                   B * S * dI * (7 * N + 1), row=row)
            del ins, y, h, py, ph
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def wkv_inputs(g, dev, B, S, hs, dtype, *, h0=True, strong=False,
               strided=False, H=None):
    """WKV's inputs in the model layout, as ``models/rwkv.py`` makes them:
    r, k, v (B, S, H, hs) reshaped from a projection (contiguous), or with
    ``strided`` slices of one (B, S, 3, H, hs) buffer; lw fp32, a step's
    log decay -exp(-2 + 0.5 N(0, 1)), or with ``strong`` down to -20 a
    step; u (H, hs) in dtype, the parameter's; h0 (B, H, hs, hs) fp32,
    random, or zeros as a prefill from scratch has it. ``H`` defaults to
    rwkv6-1.6b's WKV_H."""
    import torch
    H = H or WKV_H
    if strided:
        buf = torch.randn((B, S, 3, H, hs), generator=g, device=dev
                          ).to(dtype)
        r, k, v = buf[:, :, 0], buf[:, :, 1], buf[:, :, 2]
    else:
        r, k, v = (torch.randn((B, S, H, hs), generator=g, device=dev
                               ).to(dtype) for _ in range(3))
    if strong:
        lw = -WKV_STRONG * torch.rand((B, S, H, hs), generator=g, device=dev)
    else:
        lw = -torch.exp(-2.0 + 0.5 * torch.randn((B, S, H, hs), generator=g,
                                                   device=dev))
    u = (0.5 * torch.randn((H, hs), generator=g, device=dev)).to(dtype)
    h = (torch.randn((B, H, hs, hs), generator=g, device=dev) if h0 else
         torch.zeros((B, H, hs, hs), device=dev))
    return r, k, v, lw, u, h


def wkv_work(B, S, hs, chunk, es, H=None):
    """(bytes, fp32 ops, tensor-core ops) of one WKV call: each input
    read and each output written once; the operations of the design that
    runs it (``csrc/rwkv6_wkv.cu``): the decode kernel at S = 1; else per
    chunk the tensor-core kernel's products with their operand-split
    passes (r~ @ h and the off-diagonal scores 3, scores @ v and the
    update 2) and its fp32 work (exp(lw), the running products, the
    diagonal blocks' pairs, the hi/lo splits); fp32 takes every product
    on the CUDA cores, bf16 on the tensor cores whichever kernel runs it
    (head size 128's is a CUDA-core kernel: the bound is the function's,
    not that design's). ``H`` defaults to WKV_H."""
    H = H or WKV_H
    n = B * S * H * hs
    nbytes = n * (3 * es + 4 + es) + H * hs * es + 2 * B * H * hs * hs * 4
    if S == 1:
        return nbytes, 6 * B * H * hs * hs, 0
    n_chunks = -(-S // chunk)
    nsub = chunk // 16
    pairs = nsub * 16 * 17 // 2            # diagonal blocks, bonus included
    tiles = nsub * (nsub + 1) // 2         # 16 x 16 score tiles of scores @ v
    mm = (3 * 2 * chunk * hs * hs + 2 * 2 * chunk * hs * hs
          + 2 * 2 * tiles * 256 * hs + (3 * 2 * 256 * hs if nsub == 2 else 0))
    fp = chunk * hs * 12 + 3 * pairs * hs
    per = B * H * n_chunks
    if es == 4:
        return nbytes, per * (fp + mm // 2), 0
    return nbytes, per * fp, per * mm


def wkv_kernel_checks(dev, g, record):
    """WKV on the card against its plain version (``rwkv6_wkv_plain``,
    the per-step recurrence) in the model layout: rwkv6-1.6b's prefill
    and decode (bf16), a ragged S, decays down to -20 a step, strided
    r, k, v, every built (head size, chunk) in bf16 and the smoke
    configuration's in fp32, and ``RWKVConfig``'s default chunk 64 (run
    at ``kernel_chunk``'s built chunk), each with one CUDA kernel a call
    (``torch.profiler``); the tensor-core kernel against the CUDA-core
    witness on the same inputs; the C entry's refusals. Times from
    CUDA-graph replays, eager times logged."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_wkv as wkv

    bf16_eps = float(torch.finfo(torch.bfloat16).eps)
    B, hs, chunk = SERVE_BATCH, WKV_HS, WKV_CHUNK

    def tolerances(po, ph, dtype):
        # h_last: fp32 on both sides, other summation orders; o: one bf16
        # ulp of the largest output plus that (fp32: 1e-4 of the largest)
        htol = 1e-4 * float(ph.abs().max())
        if dtype == torch.bfloat16:
            return bf16_eps * float(po.float().abs().max()) + htol, htol
        return 1e-4 * float(po.abs().max()) + htol, htol

    def errors(got, want):
        (o, h), (po, ph) = got, want
        if not (torch.isfinite(o.float()).all() and torch.isfinite(h).all()):
            raise AssertionError("non-finite output")
        return (float((o.float() - po.float()).abs().max()),
                float((h - ph).abs().max()))

    cases = [
        # (row, B, S, hs, chunk, dtype, input options); the first row is
        # the kernel's row in the kernels line
        ("rwkv6_wkv", B, PROMPT, hs, chunk, torch.bfloat16, {}),
        ("rwkv6_wkv/decode", B, 1, hs, chunk, torch.bfloat16, {}),
        ("rwkv6_wkv/prefill_h0_zero", B, PROMPT, hs, chunk, torch.bfloat16,
         {"h0": False}),
        ("rwkv6_wkv/ragged", B, PROMPT - 12, hs, chunk, torch.bfloat16, {}),
        ("rwkv6_wkv/strong_decay", B, PROMPT, hs, chunk, torch.bfloat16,
         {"strong": True}),
        ("rwkv6_wkv/strided", B, PROMPT, hs, chunk, torch.bfloat16,
         {"strided": True}),
        ("rwkv6_wkv/hs64_c16", B, PROMPT, 64, 16, torch.bfloat16, {}),
        # RWKVConfig's default chunk, run at the built chunk kernel_chunk
        # names (32); a row of its own in the kernels line
        (WKV_CHUNK64_ROW, B, PROMPT, 64, 64, torch.bfloat16, {}),
        ("rwkv6_wkv/hs16_c32", B, PROMPT, 16, 32, torch.bfloat16, {}),
        ("rwkv6_wkv/hs16_c16", B, PROMPT, 16, 16, torch.bfloat16, {}),
        ("rwkv6_wkv/hs16_c16_decode", B, 1, 16, 16, torch.bfloat16, {}),
        ("rwkv6_wkv/fp32_hs16_c16", B, PROMPT, 16, 16, torch.float32, {}),
        ("rwkv6_wkv/fp32_hs16_c16_decode", B, 1, 16, 16, torch.float32, {}),
        # the largest head size: the CUDA-core kernel for bf16 too
        ("rwkv6_wkv/hs128", B, PROMPT, 128, 32, torch.bfloat16, {}),
        ("rwkv6_wkv/hs128_decode", B, 1, 128, 32, torch.bfloat16, {}),
        ("rwkv6_wkv/fp32_hs128", B, PROMPT, 128, 32, torch.float32, {}),
        ("rwkv6_wkv/fp32_hs128_decode", B, 1, 128, 32, torch.float32, {}),
    ]
    for row, Bc, S, hsc, ch, dtype, opt in cases:
        es = torch.finfo(dtype).bits // 8
        args = wkv_inputs(g, dev, Bc, S, hsc, dtype, **opt)
        got = ops.rwkv6_wkv(*args, chunk=ch)
        want = wkv.rwkv6_wkv_plain(*args, chunk=ch)
        torch.cuda.synchronize()
        err, herr = errors(got, want)
        tol, htol = tolerances(*want, dtype)
        names = kernels_of_one_call(lambda: ops.rwkv6_wkv(*args, chunk=ch))
        if len(names) != 1 or "wkv" not in names[0]:
            raise AssertionError(f"{row}: one model-layout call launched "
                                 f"{names}, not one WKV kernel")
        if opt.get("strided") and got[0].stride() != \
                got[0].contiguous().stride():
            raise AssertionError(f"{row}: o is not contiguous")
        log(f"  {row}: B={Bc} S={S} H={WKV_H} hs={hsc} chunk={ch} {dtype} "
            f"{opt} kernel={names[0]!r} h_last max_abs_err={herr!r} "
            f"tol={htol!r}")
        if not herr <= htol:
            raise AssertionError(f"{row}: h_last disagrees: {herr!r} > "
                                 f"{htol!r}")
        sets = [args] + [wkv_inputs(g, dev, Bc, S, hsc, dtype, **opt)
                         for _ in range(n_sets(args) - 1)]
        kernel = cycling(lambda *t: ops.rwkv6_wkv(*t, chunk=ch), sets)
        reps = 50 if S == 1 else 20
        eager = median_ms(kernel, reps)
        nbytes, fops, tops = wkv_work(Bc, S, hsc, wkv.kernel_chunk(ch), es)
        ms = graph_ms(kernel, reps)
        log(f"    eager_ms={eager!r} graph_ms={ms!r}")
        record("rwkv6_wkv", "src/repro_torch/kernels/csrc/rwkv6_wkv.cu",
               "src/repro/kernels/rwkv6_wkv.py:71", err, tol, ms,
               median_ms(lambda: wkv.rwkv6_wkv_plain(*args, chunk=ch), 1),
               nbytes, fops, tensor_ops=tops, row=row)
        del args, got, want, sets

    # the tensor-core kernel against the CUDA-core witness (the kernel it
    # replaced, on the same bf16 inputs)
    args = wkv_inputs(g, dev, B, PROMPT, hs, torch.bfloat16)
    wit = wkv.rwkv6_wkv_witness_cuda(*args, chunk=chunk)
    want = wkv.rwkv6_wkv_plain(*args, chunk=chunk)
    tol, htol = tolerances(*want, torch.bfloat16)
    werr = errors(wit, want)
    sets = [args] + [wkv_inputs(g, dev, B, PROMPT, hs, torch.bfloat16)
                     for _ in range(n_sets(args) - 1)]
    wit_ms = graph_ms(cycling(lambda *t: wkv.rwkv6_wkv_witness_cuda(
        *t, chunk=chunk), sets), 10)
    log(f"  witness (CUDA-core kernel, bf16) vs plain: o, h_last max_abs_err "
        f"{werr} tol ({tol!r}, {htol!r}) graph_ms={wit_ms!r}")
    if not (werr[0] <= tol and werr[1] <= htol):
        raise AssertionError(f"witness disagrees with the plain version: "
                             f"{werr}")
    # the tensor-core kernel against the witness
    got = ops.rwkv6_wkv(*args, chunk=chunk)
    err = errors(got, wit)
    log(f"  tensor-core kernel vs the witness: o, h_last max_abs_err {err} "
        f"tol ({tol!r}, {htol!r})")
    if not (err[0] <= tol and err[1] <= htol):
        raise AssertionError(f"the tensor-core kernel disagrees with the "
                             f"witness: {err}")
    del args, wit, want, sets, got

    # the reference's (BH, S, hs) layout: the same entry with B = 1
    r, k, v, lw, u, h0 = wkv_inputs(g, dev, 2, 2 * chunk + 5, hs,
                                    torch.bfloat16)
    fold = [t.transpose(1, 2).reshape(2 * WKV_H, -1, hs)
            for t in (r, k, v, lw)]
    bh_args = (*fold, u.float().repeat(2, 1), h0.reshape(2 * WKV_H, hs, hs))
    got = wkv.rwkv6_wkv_bh_cuda(*bh_args, chunk=chunk)
    want = wkv.rwkv6_wkv_bh_plain(*bh_args, chunk=chunk)
    err = errors(got, want)
    tol, htol = tolerances(*want, torch.bfloat16)
    log(f"  (BH, S, hs) layout vs plain: o, h_last max_abs_err {err} tol "
        f"({tol!r}, {htol!r})")
    if not (err[0] <= tol and err[1] <= htol):
        raise AssertionError(f"rwkv6_wkv_bh_cuda disagrees: {err}")
    del r, k, v, lw, u, h0, fold, bh_args, got, want

    # what the C entry and the wrapper refuse
    args = wkv_inputs(g, dev, 1, 4, 64, torch.bfloat16)
    o = torch.empty_like(args[0])
    h = torch.empty_like(args[5])
    lib = wkv._lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for bad_hs, bad_chunk in ((32, 32), (256, 32), (64, 64), (64, 8),
                              (48, 16), (16, 0)):
        rc = lib.rwkv6_wkv_fwd(
            *(t.data_ptr() for t in args), o.data_ptr(), h.data_ptr(),
            1, 4, WKV_H, bad_hs, bad_chunk, *([0] * 12), 1, 1, 0, stream)
        if rc != wkv.BAD_ARGS:
            raise AssertionError(f"the C entry took hs {bad_hs}, chunk "
                                 f"{bad_chunk} (rc {rc})")
    for fn, bad in ((wkv.rwkv6_wkv_cuda, 64), (wkv.rwkv6_wkv_cuda, 8),
                    (ops.rwkv6_wkv, 0), (ops.rwkv6_wkv, -32)):
        try:
            fn(*args, chunk=bad)
        except ValueError:
            continue
        raise AssertionError(f"{fn.__name__} took chunk {bad}")
    torch.cuda.synchronize()
    log("  the C entry and the kernel's wrapper refuse hs outside (16, 64, "
        "128) and chunks outside (16, 32); the dispatch refuses chunks below "
        "1")


def wkv_measure(dev) -> dict:
    """WKV alone at rwkv6-1.6b's prefill and decode shapes through the
    tree's ``kernels.ops.rwkv6_wkv`` (model layout, as the model calls it)
    and its ``rwkv6_wkv_bh_cuda`` (the reference's layout, folded before
    the timing): CUDA-graph and eager ms, for ``--compare ... --wkv``."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_wkv as wkv
    g = torch.Generator(device=dev).manual_seed(1234)
    out = {}
    for tag, S in (("prefill", PROMPT), ("decode", 1)):
        sets = [wkv_inputs(g, dev, SERVE_BATCH, S, WKV_HS, torch.bfloat16)]
        sets += [wkv_inputs(g, dev, SERVE_BATCH, S, WKV_HS, torch.bfloat16)
                 for _ in range(n_sets(sets[0]) - 1)]
        reps = 50 if S == 1 else 20

        def fold(r, k, v, lw, u, h0):
            B, S_, H, hs = r.shape
            f = [t.transpose(1, 2).reshape(B * H, S_, hs).contiguous()
                 for t in (r, k, v, lw)]
            return (*f, u[None].expand(B, H, hs).reshape(B * H, hs)
                    .float().contiguous(), h0.reshape(B * H, hs, hs))
        model = cycling(lambda *t: ops.rwkv6_wkv(*t, chunk=WKV_CHUNK), sets)
        folded = [fold(*s) for s in sets]
        bh = cycling(lambda *t: wkv.rwkv6_wkv_bh_cuda(*t, chunk=WKV_CHUNK),
                     folded)
        out[f"wkv_{tag}_graph_ms"] = graph_ms(model, reps)
        out[f"wkv_{tag}_eager_ms"] = median_ms(model, reps)
        out[f"wkv_{tag}_bh_graph_ms"] = graph_ms(bh, reps)
        del sets, folded
        torch.cuda.empty_cache()
    return out


def codec_measure(dev) -> dict:
    """Rows 1-6 alone in the tree under test, for ``--measure --codec``:
    the top-k EF round-trip at the dense job's two shapes (``x``, 65,536
    x 256; ``p`` and ``err``, 65,536), ``torch.topk``'s threshold on the
    same ``|x + r|`` (the select's library yardstick) and, where the tree
    has one, its own select alone; the int8 round-trip; the fused
    normalize at phase 5's shape (15% NaN); the hash at phase 4's (65,536
    x 32 -> 1,024), with ``torch.zeros`` of its output and, where the
    tree has it, the row-thread witness; count-min's increment,
    ``sketches.countmin_add`` on a running table and the add-then-query
    at both widths on the feeder's first batch, with the increment's
    witness where the tree has it. CUDA-graph ms with the inputs cycled
    past the L2 (``*_graph_ms``), and eager ms of the same calls."""
    import torch
    from repro_torch.kernels import countmin as cms
    from repro_torch.kernels import ef_codec, preprocess, ref
    from repro_torch.streams import sketches as sk
    g = torch.Generator(device=dev).manual_seed(1234)
    out = {}

    def both(key, fn, sets, reps):
        call = cycling(fn, sets)
        out[f"{key}_graph_ms"] = graph_ms(call, reps)
        out[f"{key}_eager_ms"] = median_ms(call, reps)

    for tag, shape in (("x", (N_EVENTS, DIM)), ("p", (N_EVENTS,))):
        k = int(round(0.1 * math.prod(shape)))
        first = (torch.randn(shape, generator=g, device=dev) * 0.01,
                 torch.randn(shape, generator=g, device=dev))
        sets = [first] + [tuple(t.clone() for t in first)
                          for _ in range(n_sets(first) - 1)]
        reps = max(20, len(sets))
        both(f"topk_{tag}", lambda r, x: ef_codec.ef_topk_int8_roundtrip_cuda(
            r, x, k), sets, reps)
        mags = [(torch.abs(x.reshape(-1) + r.reshape(-1)),) for r, x in sets]
        out[f"topk_{tag}_torch_select_graph_ms"] = graph_ms(
            cycling(lambda a: ref.topk_threshold(a, k), mags), reps)
        select = getattr(ef_codec, "ef_topk_threshold_cuda", None)
        if select is not None:
            out[f"topk_{tag}_select_graph_ms"] = graph_ms(
                cycling(lambda r, x: select(r, x, k), sets), reps)
        if tag == "x":
            both("int8_x", ef_codec.ef_int8_roundtrip_cuda, sets, reps)
        del first, sets, mags
        torch.cuda.empty_cache()

    # rows 1 and 2 at the path's shapes: phase 5's normalize, phase 4's hash
    x = torch.randn((N_EVENTS, DIM), generator=g, device=dev)
    x[torch.rand((N_EVENTS, DIM), generator=g, device=dev) < 0.15] = math.nan
    n0, mean0 = torch.tensor(1000.0, device=dev), torch.zeros(DIM, device=dev)
    m20 = torch.ones(DIM, device=dev)
    sets = [(x,)] + [(x.clone(),) for _ in range(n_sets((x,)) - 1)]
    reps = max(20, len(sets))
    both("normalize", lambda x_: preprocess.fused_normalize_cuda(
        x_, n0, mean0, m20), sets, reps)
    witness = getattr(preprocess, "fused_normalize_witness_cuda", None)
    if witness is not None:
        out["normalize_witness_graph_ms"] = graph_ms(cycling(
            lambda x_: witness(x_, n0, mean0, m20), sets), reps)
    outs = [(x_, torch.empty_like(x_)) for (x_,) in sets]
    out["normalize_copy_graph_ms"] = graph_ms(
        cycling(lambda a, b: b.copy_(a), outs), reps)
    del x, sets, outs
    first = (torch.randint(-2 ** 31, 2 ** 31 - 1, (N_EVENTS, HASH_F),
                           generator=g, device=dev,
                           dtype=torch.int64).to(torch.int32),
             torch.randn((N_EVENTS, HASH_F), generator=g, device=dev))
    sets = [first] + [tuple(t.clone() for t in first)
                      for _ in range(n_sets(first) - 1)]
    reps = max(20, len(sets))
    both("hash", lambda i, v: preprocess.fused_hash_features_cuda(
        i, v, HASH_DIM), sets, reps)
    rowthread = getattr(preprocess, "hash_features_rowthread_cuda", None)
    if rowthread is not None:
        out["hash_witness_graph_ms"] = graph_ms(cycling(
            lambda i, v: rowthread(i, v, HASH_DIM), sets), reps)
    out["hash_torch_zeros_graph_ms"] = graph_ms(
        lambda: torch.zeros((N_EVENTS, HASH_DIM), device=dev), reps)
    del first, sets
    torch.cuda.empty_cache()

    ids = torch.from_numpy(first_token_batch()).to(dev)
    _STREAMS.clear()
    sets = [(ids,)] + [(ids.clone(),) for _ in range(n_sets((ids,)) - 1)]
    reps = max(20, len(sets))
    d = SKETCH_DEPTH
    witness = getattr(cms, "countmin_update_witness_cuda", None)
    for w in SKETCH_WIDTHS:
        cm = sk.countmin_init(d, w, seed=0, device=dev)
        seeds = cm.seeds
        table = cms.countmin_update_cuda(ids, d, w, seeds) * 3
        both(f"countmin_update_w{w}",
             lambda i: cms.countmin_update_cuda(i, d, w, seeds), sets, reps)
        # row 5 on the path: sketches.countmin_add on a running table
        both(f"countmin_add_w{w}", lambda i: sk.countmin_add(
            cm._replace(table=table), i), sets, reps)
        both(f"countmin_update_query_w{w}",
             lambda i: cms.countmin_update_query_cuda(i, table, seeds), sets,
             reps)
        if witness is not None:
            out[f"countmin_update_witness_w{w}_graph_ms"] = graph_ms(cycling(
                lambda i: witness(i, d, w, seeds), sets), reps)
        del table
    del ids, sets
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 3-5: the main path
# ---------------------------------------------------------------------------

def dense_batches(n_batches: int, n: int, dim: int):
    from repro_torch.streams.generators import DriftSpec, HyperplaneStream
    gen = HyperplaneStream(dim=dim, seed=0,
                           drift=DriftSpec(kind="abrupt", at=0.5,
                                           magnitude=2.0),
                           horizon=n_batches * float(n))
    return [gen.batch(i, n) for i in range(n_batches)]


def dense_job(dim: int, codec: str, budget: float, device: str,
              sample_rate: float = 0.5, fuse: str = "op",
              measured: bool = False, detector: str = "ddm"):
    """Phase 3's job: the standard pipeline (DDM, or ``detector``) built
    under ``fuse``, the uplink codec pinned."""
    from repro_torch.core.orchestrator import Orchestrator, StreamJob
    from repro_torch.core.pipeline import standard_stream_pipeline
    from repro_torch.core.sla import SLA
    return Orchestrator(StreamJob(
        f"smoke-{codec}-{fuse}", dim=dim,
        sla=SLA(error_budget=budget, max_latency_s=1e3),
        pipeline=standard_stream_pipeline(
            dim, sample_rate=sample_rate, drift_detector=detector, fuse=fuse),
        uplink_codecs=[codec], device=device, measured_costs=measured))


def run_dense(batches, codec: str, budget: float, device: str,
              sample_rate: float = 0.5, detector: str = "ddm"):
    import torch
    orch = dense_job(batches[0].data["x"].shape[1], codec, budget, device,
                     sample_rate, detector=detector)
    t0 = time.perf_counter()
    m = orch.run(batches, rate_fn=lambda s: 1e4)
    if device == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return orch, m, secs


def run_hashed():
    """Phase 4's path: the orchestrator on 8 batches of 65,536 sparse
    events (32 features, ids over the full int32 range) hashed into 1,024
    on the card, then pca and a sketch. Returns ``(orch, metrics,
    seconds)``."""
    import torch
    from repro_torch.core.orchestrator import Orchestrator, StreamJob
    from repro_torch.core.pipeline import Pipeline, hash_op, pca_op, sketch_op
    from repro_torch.core.sla import SLA
    from repro_torch.streams.events import StreamBatch
    rng = torch.Generator().manual_seed(7)
    sparse = [StreamBatch(data={
        "ids": torch.randint(-2 ** 31, 2 ** 31 - 1, (N_EVENTS, HASH_F),
                             generator=rng, dtype=torch.int64
                             ).to(torch.int32),
        "vals": torch.randn((N_EVENTS, HASH_F), generator=rng)})
        for _ in range(8)]
    hp = Pipeline([hash_op(HASH_DIM), pca_op(HASH_DIM, 16), sketch_op(16)])
    orch = Orchestrator(StreamJob(
        "smoke-hash", dim=HASH_DIM, pipeline=hp,
        sla=SLA(error_budget=0.1, max_latency_s=1e3),
        uplink_codecs=["int8_ef"]))
    t0 = time.perf_counter()
    m = orch.run(sparse, rate_fn=lambda s: 1e4)
    torch.cuda.synchronize()
    return orch, m, time.perf_counter() - t0


def edge_serving_cluster():
    """The cluster of ``examples/edge_serving.py``: one modest edge box
    and one narrow cloud pod (copied; the example imports the JAX
    package)."""
    from repro_torch.core import costmodel as cm
    edge = cm.Resource("edge0", "edge", chips=1, flops=4e9, mem_bw=5e9,
                       mem_cap=4e9, net_bw=1e9)
    cloud = cm.Resource("cloud0", "cloud", chips=1, flops=1e13,
                        mem_bw=2.5e9, mem_cap=64e9, net_bw=100e9)
    return cm.ClusterSpec(
        pools=[edge, cloud],
        links=[cm.Link("edge0", "cloud0", bw=1e9, latency=5e-3),
               cm.Link("cloud0", "edge0", bw=2e7, latency=5e-3)])


def serve_requests(cfg, params, prompts, arch: str):
    """Serve ``prompts`` through ``ServeEngine(impl="kernel")`` (after a
    short untimed wave, so the rates do not carry the first use of the
    card's libraries at these shapes), with the launch counts set to 0
    just before and read just after. Checks that every request got
    NEW_TOKENS tokens inside the vocabulary. Returns ``(launch counts,
    throughput, requests)``."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import Request, ServeEngine

    ServeEngine(cfg, params, batch_size=SERVE_BATCH, max_len=MAX_LEN
                ).run([Request(0, prompts[0][:64], max_new_tokens=2)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    eng = ServeEngine(cfg, params, batch_size=SERVE_BATCH,
                      max_len=MAX_LEN, impl="kernel", seed=0)
    reqs = [Request(i, p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    counts = ops.launch_counts()
    tp = eng.throughput()
    launched = {k: v for k, v in counts.items() if v}
    log(f"  prefill_tok_per_s={tp['prefill_tok_per_s']!r} "
        f"decode_tok_per_s={tp['decode_tok_per_s']!r} "
        f"prefill_s={eng.metrics['prefill_s']!r} "
        f"decode_s={eng.metrics['decode_s']!r} "
        f"peak_gib={torch.cuda.max_memory_allocated() / 2 ** 30!r} "
        f"launches={launched}")
    for r in reqs:
        if len(r.out_tokens) != NEW_TOKENS or not all(
                0 <= t < cfg.vocab_size for t in r.out_tokens):
            raise AssertionError(f"{arch}: request {r.rid} got "
                                 f"{r.out_tokens}")
    return counts, tp, reqs


def logits_gap(cfg, params, batch):
    """Prefill logits under ``impl="kernel"`` against ``impl="chunked"``
    on ``batch``: ``(max |difference|, max |chunked logits|, argmax
    agreements, kernel prefill logits, its caches)``."""
    import torch
    from repro_torch.models import model_zoo as zoo
    lk, caches = zoo.prefill(params, cfg, batch, MAX_LEN, impl="kernel")
    lc, _ = zoo.prefill(params, cfg, batch, MAX_LEN, impl="chunked")
    real = slice(0, cfg.vocab_size)
    diff = float((lk[..., real] - lc[..., real]).abs().max())
    scale = float(lc[..., real].abs().max())
    same_argmax = int((lk[:, 0, real].argmax(-1)
                       == lc[:, 0, real].argmax(-1)).sum())
    del lc
    torch.cuda.empty_cache()
    return diff, scale, same_argmax, lk, caches


def logits_check(cfg, params, batch, arch: str):
    """Finite prefill and decode logits, and prefill logits of
    ``impl="kernel"`` within ``LOGITS_RTOL`` of ``impl="chunked"``'s
    largest. Returns the caches after the decode step and the step's
    next tokens."""
    import torch
    from repro_torch.models import model_zoo as zoo
    diff, scale, same_argmax, lk, caches = logits_gap(cfg, params, batch)
    nxt = torch.argmax(lk[:, 0, :cfg.vocab_size], -1)[:, None]
    ld, caches = zoo.decode_step(params, cfg, caches, nxt, impl="kernel")
    real = slice(0, cfg.vocab_size)
    for what, t in (("prefill", lk), ("decode", ld)):
        if not torch.isfinite(t[..., real]).all():
            raise AssertionError(f"{arch}: non-finite {what} logits")
    log(f"  prefill logits kernel vs chunked: max_abs_diff={diff!r} "
        f"max_abs={scale!r} rel={diff / scale!r} (tol {LOGITS_RTOL}) "
        f"argmax agree {same_argmax}/{lk.shape[0]}")
    if not diff <= LOGITS_RTOL * scale:
        raise AssertionError(f"{arch}: kernel and chunked prefill logits "
                             f"differ by {diff!r}")
    return caches, torch.argmax(ld[:, 0, :cfg.vocab_size], -1)[:, None]


def serving_phases(dev):
    """Phase 6 (each model served) and phase 7 (rwkv6's serving graph at
    the {decode} frontier). Returns the launch counts of each path and
    the prefill and decode tok/s of each model."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.placement import Objective, place_frontier
    from repro_torch.kernels import ops
    from repro_torch.models import model_zoo as zoo
    from repro_torch.serve.engine import ServeEngine, wave_inputs
    from repro_torch.serve.ops import serve_wave_batch, serving_graph

    paths, rates = {}, {}
    for arch in SERVE_MODELS:
        cfg = get_config(arch)
        t0 = time.perf_counter()
        params = zoo.init_params(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        n_params = zoo.param_count(cfg)
        log(f"phase 6: serving {arch} ({n_params} parameters, "
            f"{cfg.param_dtype}), weights drawn in "
            f"{time.perf_counter() - t0:.2f} s")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, size=PROMPT
                                ).astype(np.int32) for _ in range(N_REQUESTS)]
        paths[f"serve/{arch}"], tp, reqs = serve_requests(cfg, params,
                                                         prompts, arch)
        rates[f"prefill_tok_per_s/{arch}"] = tp["prefill_tok_per_s"]
        rates[f"decode_tok_per_s/{arch}"] = tp["decode_tok_per_s"]
        caches, _ = logits_check(cfg, params,
                                 wave_inputs(cfg, prompts[:SERVE_BATCH], dev),
                                 arch)
        del caches

        if arch == "rwkv6-1.6b":
            log("phase 7: rwkv6 serving graph at the {decode} frontier")
            geng = ServeEngine(cfg, params, batch_size=SERVE_BATCH,
                               max_len=MAX_LEN, impl="kernel", seed=0)
            graph = serving_graph(geng, prompt_len=PROMPT,
                                  max_new_tokens=NEW_TOKENS)
            # The plan is only logged, not used. At full width the
            # example's edge box (4 GFLOP/s) decodes a request in ~24 s,
            # so no rate saturates the pod while the edge keeps up: the
            # plan stays on the pod. The graph is run at the {decode}
            # split all the same, the split the example forces at smoke
            # width.
            plan, frontier = place_frontier(graph, edge_serving_cluster(),
                                            SERVE_PLACE_RATE, Objective(),
                                            method="dp")
            log(f"  place_frontier at {SERVE_PLACE_RATE} requests/s: "
                f"{plan.assignment} frontier={sorted(frontier)} "
                f"feasible={plan.feasible}; running at frontier ['decode']")
            states = graph.init_states(dev)
            gbatch = serve_wave_batch(geng, prompts[:SERVE_BATCH], seed=0)
            ops.reset_launch_counts()
            states, out = graph.run(states, gbatch, frontier={"decode"})
            torch.cuda.synchronize()
            paths["serve_graph/rwkv6-1.6b"] = ops.launch_counts()
            got = out["out_tokens"].tolist()
            want = [r.out_tokens for r in reqs[:SERVE_BATCH]]
            launched = {k: v for k, v in
                        paths["serve_graph/rwkv6-1.6b"].items() if v}
            log(f"  graph tokens equal the engine's: {got == want} "
                f"launches={launched}")
            if got != want:
                raise AssertionError("rwkv6 serving graph at {decode} "
                                     "differs from the engine")
            del graph, geng, states, out
        del params
        torch.cuda.empty_cache()
    return paths, rates


# ---------------------------------------------------------------------------
# phase 14: the MoE, MLA, hybrid, vision and dense families served
# ---------------------------------------------------------------------------

def family_configs():
    """``(config, cuts)`` of phase 14's models: each at full width, the
    two that do not fit one card with their depth cut (``cuts`` says how
    and why)."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    out = []
    for arch, over, why in FAMILY_MODELS:
        cfg = get_config(arch)
        cuts = {k: f"{getattr(cfg, k)} -> {v}" for k, v in over.items()}
        out.append((replace(cfg, **over), {**cuts, "why": why} if over
                    else {}))
    return out


def open_vlm_gates(params) -> None:
    """Set every ``gate_attn`` and ``gate_mlp`` of a vision model to
    VLM_GATE: at their initial 0 the gated cross layer adds nothing, and
    a check of its cross-attention would pass whatever the flash kernel
    returned."""
    def visit(tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                if k in ("gate_attn", "gate_mlp"):
                    v.fill_(VLM_GATE)
                else:
                    visit(v)
        elif isinstance(tree, list):
            for v in tree:
                visit(v)
    visit(params)


def decode_step_profile(cfg, params, caches, tokens) -> dict:
    """One decode step under ``torch.profiler``: its wall ms, the card's
    kernel ms, idle share and kernel launches (``None`` where the
    profiler traced no device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile_stream import _device_events
    from repro_torch.models import model_zoo as zoo
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        zoo.decode_step(params, cfg, caches, tokens, impl="kernel")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [r for r in _device_events(prof)
            if not r[2].startswith(("Memcpy", "Memset"))]
    if not rows:
        return {"wall_ms": wall_ms, "kernel_ms": None, "idle_share": None,
                "launches": None}
    kernel_ms = sum(r[0] for r in rows)
    return {"wall_ms": wall_ms, "kernel_ms": kernel_ms,
            "idle_share": 1.0 - kernel_ms / wall_ms,
            "launches": sum(r[1] for r in rows)}


def vlm_flash_check(cfg, params, batch) -> None:
    """The vision model's logits check must fail if the flash kernel's
    output is wrong: with each request's cross-attention output swapped
    for another request's (a plausible but wrong output), the prefill
    logits under ``impl="kernel"`` must leave ``LOGITS_RTOL``."""
    from repro_torch.kernels import ops
    real = ops.flash_attention

    def perturbed(*a, **k):
        return real(*a, **k).roll(1, dims=0)
    ops.flash_attention = perturbed
    try:
        diff, scale, same, lk, caches = logits_gap(cfg, params, batch)
    finally:
        ops.flash_attention = real
    del lk, caches
    fails = not diff <= LOGITS_RTOL * scale
    log(f"  negative control, flash output rolled over the batch: "
        f"max_abs_diff={diff!r} max_abs={scale!r} rel={diff / scale!r} "
        f"argmax agree {same}/{SERVE_BATCH}; the check fails: {fails}")
    if not fails:
        raise AssertionError("the vlm logits check passes a wrong flash "
                             "output: it cannot see the kernel")


class RoutingRecorder:
    """Records, at every MoE layer, each token's expert ids, the keep
    mask of its assignments, whether its K-th and (K+1)-th router
    probabilities lie within MOE_NEAR_TIE, and its router probabilities
    (fp32, (tokens, experts))."""

    def __init__(self):
        self.layers = []

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self._moe, self._top_k = moe, moe.top_k
        self._dispatch = moe._dispatch_group
        rec = self

        def top_k(probs, k):
            vals, idx = rec._top_k(probs, k)
            srt = torch.sort(probs, dim=-1, descending=True).values
            near = (srt[..., k - 1] - srt[..., k]) <= MOE_NEAR_TIE
            rec.layers.append({"ids": idx.reshape(-1, k).cpu(),
                               "near": near.reshape(-1).cpu(),
                               "probs": probs.reshape(
                                   -1, probs.shape[-1]).float().cpu()})
            return vals, idx

        def dispatch(cfg, C, xf, expert_ids, *experts):
            out = rec._dispatch(cfg, C, xf, expert_ids, *experts)
            rec.layers[-1]["keep"] = out[3].cpu()
            rec.layers[-1]["order"] = out[2].cpu()
            return out
        moe.top_k, moe._dispatch_group = top_k, dispatch
        return self

    def __exit__(self, *exc):
        self._moe.top_k, self._moe._dispatch_group = self._top_k, \
            self._dispatch


def prefill_card_vs_cpu(dev) -> None:
    """A smoke-size fp32 prefill of each of PREFILL_CPU_MODELS on the card
    and on the CPU from the same weights (fp32 caches, so that no bf16
    rounding of a key flips between the two): logits within rtol = atol
    = PREFILL_CPU_TOL; for the MoE models expert ids, keep masks and the
    dispatch's sort bitwise, except at a near tie (a token whose K-th and
    (K+1)-th router probabilities lie within MOE_NEAR_TIE, where fp32
    products may round the other way), which is logged and whose
    sequence is left out of the logits comparison."""
    from dataclasses import replace
    import numpy as np
    import torch
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo as zoo

    for arch in PREFILL_CPU_MODELS:
        cfg = replace(get_config(arch, smoke=True), kv_cache_dtype="float32")
        cpu_params = zoo.init_params(cfg, seed=0, device="cpu")
        card_params = tree_map(lambda t: t.to(dev), cpu_params)
        rng = np.random.default_rng(2)
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, size=(PREFILL_CPU_B, PREFILL_CPU_S)
        ).astype(np.int32))
        logits, layers = {}, {}
        for where, params in (("cpu", cpu_params), ("card", card_params)):
            with RoutingRecorder() as rec:
                lg, _ = zoo.prefill(params, cfg, {"tokens": toks.to(
                    params["embed"]["tok"].device)}, PREFILL_CPU_S,
                    impl="kernel")
            logits[where], layers[where] = lg.float().cpu(), rec.layers
        near = torch.zeros(PREFILL_CPU_B * PREFILL_CPU_S, dtype=torch.bool)
        for a, b in zip(layers["cpu"], layers["card"]):
            near |= a["near"] | b["near"]
        ok = ~near
        for i, (a, b) in enumerate(zip(layers["cpu"], layers["card"])):
            if not torch.equal(a["ids"][ok], b["ids"][ok]):
                raise AssertionError(f"{arch} layer {i}: expert ids differ "
                                     "between the card and the CPU")
            if near.any():
                continue     # the near tie moves later tokens' slots
            if not (torch.equal(a["keep"], b["keep"])
                    and torch.equal(a["order"], b["order"])):
                raise AssertionError(f"{arch} layer {i}: keep masks or the "
                                     "stable sort differ")
        rows = ~near.reshape(PREFILL_CPU_B, PREFILL_CPU_S).any(-1)
        real = slice(0, cfg.vocab_size)
        a, b = logits["card"][rows][..., real], logits["cpu"][rows][..., real]
        excess = float(((a - b).abs()
                        - PREFILL_CPU_TOL * (1 + b.abs())).max())
        ties = torch.nonzero(near).reshape(-1).tolist()
        routed = (f"expert ids, keep masks and sort bitwise; near ties "
                  f"{ties}; " if layers["cpu"] else "")
        log(f"  {arch} (smoke, fp32, {len(layers['cpu'])} MoE layers, "
            f"{PREFILL_CPU_B} x {PREFILL_CPU_S} tokens): {routed}logits max "
            f"|card - cpu| "
            f"{float((a - b).abs().max())!r} of max |cpu| "
            f"{float(b.abs().max())!r} (rtol = atol = {PREFILL_CPU_TOL})")
        if not excess <= 0:
            raise AssertionError(f"{arch}: card and CPU logits differ")


def families_phase(dev) -> dict:
    """Phase 14: granite-moe-1b-a400m, deepseek-v2-lite-16b,
    llama-3.2-vision-90b, jamba-1.5-large-398b, nemotron-4-15b,
    qwen1.5-4b and mistral-large-123b served at full width as phase 6
    serves its models, each one main path; the vision model's flash
    launches and its negative control; then the smoke configs' prefill
    (and the MoE routing) on the card against the CPU. Returns each
    path's launch counts."""
    import numpy as np
    import torch
    from repro_torch.models import model_zoo as zoo
    from repro_torch.serve.engine import wave_inputs

    paths = {}
    for cfg, cuts in family_configs():
        arch = cfg.name
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = zoo.init_params(cfg, seed=0, device=dev)
        if cfg.family == "vlm":
            open_vlm_gates(params)
        torch.cuda.synchronize()
        n_params = zoo.param_count(cfg)
        log(f"phase 14: serving {arch} ({cfg.family}, {n_params} parameters, "
            f"{cfg.param_dtype}, {cfg.n_layers} layers), weights drawn in "
            f"{time.perf_counter() - t0:.2f} s, "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30!r} GiB at the "
            f"draw's peak" + (f"; reduced: {cuts}" if cuts else ""))
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, size=PROMPT
                                ).astype(np.int32) for _ in range(N_REQUESTS)]
        counts, _, _ = serve_requests(cfg, params, prompts, arch)
        paths[f"serve/{arch}"] = counts
        # the path's kernels: flash in vision's gated cross-attention,
        # nothing anywhere else (self-attention and MLA refuse flash, the
        # Mamba mixer runs its own scan, as the reference's do; fault 5)
        want = {"flash_attention"} if cfg.family == "vlm" else set()
        if {k for k, v in counts.items() if v} != want:
            raise AssertionError(f"{arch}: launches {counts}, expected "
                                 f"only {sorted(want)}")

        batch = wave_inputs(cfg, prompts[:SERVE_BATCH], dev)
        if cfg.family == "vlm":
            g = torch.Generator(device=dev).manual_seed(14)
            batch["patches"] = VLM_PATCH_SCALE * torch.randn(
                batch["patches"].shape, generator=g, device=dev)
        caches, nxt = logits_check(cfg, params, batch, arch)
        prof = decode_step_profile(cfg, params, caches, nxt)
        log(f"  one profiled decode step: {prof}; peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30!r} GiB")
        del caches
        if cfg.family == "vlm":
            vlm_flash_check(cfg, params, batch)
        del params, batch
        free_card()
        log(f"  after {arch}: {torch.cuda.memory_allocated() / 2 ** 30!r} "
            f"GiB held")
    log(f"phase 14: fp32 prefill and MoE routing on the card against the "
        f"CPU ({', '.join(PREFILL_CPU_MODELS)} smoke configs)")
    prefill_card_vs_cpu(dev)
    return paths


# ---------------------------------------------------------------------------
# phase 8: edge summarization (feeder -> count-min -> Misra-Gries)
# ---------------------------------------------------------------------------

_STREAMS = {}   # shard -> its TokenStream, which draws its permutation once


def token_batch(shard: int, idx: int, n_seqs: int):
    from repro_torch.streams.generators import TokenStream
    if shard not in _STREAMS:
        _STREAMS[shard] = TokenStream(
            vocab_size=SKETCH_VOCAB, seq_len=SKETCH_SEQ_LEN,
            zipf_a=SKETCH_ZIPF, seed=shard)
    return _STREAMS[shard].batch(idx, n_seqs)


def first_token_batch():
    """Batch 0 of the feeder, as it concatenates its shards."""
    out = token_batch(0, 0, SKETCH_SEQS)
    for s in range(1, SKETCH_SHARDS):
        out = out.concat(token_batch(s, 0, SKETCH_SEQS))
    return out.data["tokens"].reshape(-1)


def countmin_kernel_checks(dev, record, ids):
    """Count-min at both widths and with a table at 2^24 + 1 against its
    plain version, exactly. Row 5's increment (a memset and the add) and
    the copy-and-add that ``sketches.countmin_add`` takes on the card are
    also held to the witness (the increment's first kernels); so is the
    add-then-query (row 6), which shares the add. Each call's CUDA graph
    is read: the increment a memset and one kernel, ``countmin_add`` a
    copy and one kernel, the add-then-query a copy and two kernels; the
    caller's table is left as it was. Graph-timed with the ids cycled
    past the L2 (eager logged)."""
    import torch
    from repro_torch.kernels import countmin as cms
    from repro_torch.kernels import ref
    from repro_torch.streams import sketches as sk

    n, d = ids.numel(), SKETCH_DEPTH
    sets = [(ids,)] + [(ids.clone(),) for _ in range(n_sets((ids,)) - 1)]
    reps = max(20, len(sets))
    for w in SKETCH_WIDTHS:
        cm = sk.countmin_init(d, w, seed=0, device=dev)
        seeds = cm.seeds
        inc = cms.countmin_update_cuda(ids, d, w, seeds)
        pinc = ref.countmin_ref(ids, d, w, seeds)
        winc = cms.countmin_update_witness_cuda(ids, d, w, seeds)
        table = inc * 3                     # a running table, not zeros
        before = table.clone()
        added = sk.countmin_add(cm._replace(table=table), ids).table
        got = cms.countmin_update_query_cuda(ids, table, seeds)
        want = ref.countmin_update_query_ref(ids, table, seeds)
        big = torch.full((d, w), 2 ** 24 + 1, dtype=torch.int32, device=dev)
        added_big = cms.countmin_add_cuda(ids, big, seeds)
        got_big = cms.countmin_update_query_cuda(ids, big, seeds)
        want_big = ref.countmin_update_query_ref(ids, big, seeds)
        torch.cuda.synchronize()
        same = {"update": torch.equal(inc, pinc),
                "update_vs_witness": torch.equal(inc, winc),
                "countmin_add": torch.equal(added, table + pinc),
                "countmin_add_vs_witness": torch.equal(added, table + winc),
                "update_query": all(map(torch.equal, got, want)),
                # the add-then-query against the kernels its add replaced
                "update_query_vs_witness": torch.equal(got[0], table + winc),
                "at_2^24+1": all(map(torch.equal, got_big, want_big))
                and torch.equal(added_big, want_big[0]),
                "table_untouched": torch.equal(table, before)}
        err = max(float((a.long() - b.long()).abs().max())
                  for a, b in ((inc, pinc), (added, table + pinc),
                               *zip(got, want), *zip(got_big, want_big)))
        log(f"  count-min width {w}: bitwise {same}; max cell "
            f"{int(got[0].max())}, at 2^24+1: {int(got_big[0].max())}")
        if not all(same.values()):
            raise AssertionError(f"count-min width {w}: kernel differs from "
                                 f"plain or witness: {same}")
        # all depth rows of the narrow sketch fit shared memory
        path = "uq_add_smem" if w == SKETCH_WIDTHS[0] else "uq_add_global"
        graphs = {
            "countmin_update": (kernels_in_graph(
                lambda: cms.countmin_update_cuda(ids, d, w, seeds)),
                ["memset", path]),
            "countmin_add": (kernels_in_graph(
                lambda: sk.countmin_add(cm._replace(table=table), ids)),
                ["memcpy", path]),
            "countmin_update_query": (kernels_in_graph(
                lambda: cms.countmin_update_query_cuda(ids, table, seeds)),
                ["memcpy", path, "uq_query"])}
        for what, (nodes, want_nodes) in graphs.items():
            if len(nodes) != len(want_nodes) or not all(
                    x in y for x, y in zip(want_nodes, nodes)):
                raise AssertionError(f"count-min width {w}: one {what} call's "
                                     f"CUDA graph holds {nodes}")
            log(f"    one {what} call's CUDA graph: {nodes}")
        src = "src/repro_torch/kernels/csrc/countmin.cu"
        tag = "" if w == SKETCH_WIDTHS[0] else f"/w{w}"
        timed = {}
        for name, fn in (
                ("countmin_update",
                 lambda i: cms.countmin_update_cuda(i, d, w, seeds)),
                ("countmin_add", lambda i: cms.countmin_add_cuda(
                    i, table, seeds)),
                ("countmin_update_query",
                 lambda i: cms.countmin_update_query_cuda(i, table, seeds)),
                ("witness", lambda i: cms.countmin_update_witness_cuda(
                    i, d, w, seeds))):
            call = cycling(fn, sets)
            timed[name] = (graph_ms(call, reps), median_ms(call, reps))
        log(f"    graph ms [eager]: " + ", ".join(
            f"{k} {v[0]!r} [{v[1]!r}]" for k, v in timed.items()))
        record("countmin_update", src, "src/repro/kernels/countmin.py:59",
               err, 0.0, timed["countmin_update"][0],
               median_ms(lambda: ref.countmin_ref(ids, d, w, seeds), 5),
               4 * n + 4 * d * w, 5 * n * d,
               row=f"countmin_update{tag}" if tag else None)
        record("countmin_update_query", src,
               "src/repro/kernels/countmin.py:131", err, 0.0,
               timed["countmin_update_query"][0],
               median_ms(lambda: ref.countmin_update_query_ref(
                   ids, table, seeds), 5),
               8 * n + 8 * d * w, 10 * n * d,
               row=f"countmin_update_query{tag}" if tag else None)
        del inc, pinc, winc, table, before, added, got, want, big
        del added_big, got_big, want_big
    del sets


def sketch_kernel_checks(dev, record, ids):
    """Count-min (``countmin_kernel_checks``) and the Misra-Gries scan,
    each against its plain version: exactly."""
    import torch
    from repro_torch.kernels import mg_scan as mgk
    from repro_torch.kernels import ref

    countmin_kernel_checks(dev, record, ids)
    n = ids.numel()
    keys0 = torch.full((MG_K,), -1, dtype=torch.int32, device=dev)
    counts0 = torch.zeros((MG_K,), dtype=torch.int32, device=dev)
    pre = ids[:MG_PLAIN_N]
    got = mgk.mg_scan_cuda(keys0, counts0, pre)
    t0 = time.perf_counter()
    want = ref.mg_update_ref(keys0, counts0, pre)
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    if not all(map(torch.equal, got, want)):
        raise AssertionError("mg_scan differs from its plain loop on the "
                             "prefix")
    log(f"  mg_scan on the first {MG_PLAIN_N} ids (k = {MG_K}): bitwise "
        f"equal to the plain loop on the card ({pre_ms!r} ms, one run)")
    # the path's shape: one whole batch, the plain loop on a CPU copy (the
    # host steps it faster than launches on the card would)
    before = mgk.chain_stats(dev).clone()
    got = mgk.mg_scan_cuda(keys0, counts0, ids)
    walked = int((mgk.chain_stats(dev) - before)[0])
    t0 = time.perf_counter()
    want = ref.mg_update_ref(keys0.cpu(), counts0.cpu(), ids.cpu())
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = tuple(t.cpu() for t in got)
    same = all(map(torch.equal, got, want))
    err = max(float((a.long() - b.long()).abs().max())
              for a, b in zip(got, want))
    log(f"  mg_scan on a whole batch of {n} ids (k = {MG_K}): bitwise equal "
        f"to the plain loop on the host CPU {same} (plain_ms is that loop, "
        f"one run)")
    if not same:
        raise AssertionError("mg_scan differs from its plain loop on a "
                             "whole batch")
    ms = median_ms(lambda: mgk.mg_scan_cuda(keys0, counts0, ids), 3)
    record("mg_scan", "src/repro_torch/kernels/csrc/mg_scan.cu",
           "src/repro/streams/sketches.py:116", err, 0.0, ms,
           plain_ms, 4 * n + 16 * MG_K, n * MG_K)
    serial_ms = median_ms(lambda: mgk.mg_scan_serial_cuda(keys0, counts0,
                                                          ids), 3)
    log(f"  mg_scan (chunks of {mgk.CHUNK}): chain walked {walked} of {n} "
        f"ids ({walked / n!r}), {ms * 1e6 / walked!r} ns a chained id; "
        f"serial witness {serial_ms!r} ms ({serial_ms * 1e6 / n!r} ns an id)")
    # the kernel's other register layouts (k not a whole 32 per lane, and
    # up to 1,024): the whole batch from an empty summary, then again,
    # reversed, from the summary it left; each bitwise the serial witness
    for k in MG_K_CHECKS:
        kk = torch.full((k,), -1, dtype=torch.int32, device=dev)
        cc = torch.zeros((k,), dtype=torch.int32, device=dev)
        wk, wc = kk, cc
        for what, x in (("empty", ids), ("carried", ids.flip(0))):
            before = mgk.chain_stats(dev).clone()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            kk, cc = mgk.mg_scan_cuda(kk, cc, x)
            b.record()
            walked = int((mgk.chain_stats(dev) - before)[0])
            wk, wc = mgk.mg_scan_serial_cuda(wk, wc, x)
            same = torch.equal(kk, wk) and torch.equal(cc, wc)
            log(f"  mg_scan k = {k} from the {what} summary: bitwise the "
                f"serial witness {same}; {a.elapsed_time(b)!r} ms (one run), "
                f"chain {walked} ids ({walked / n!r})")
            if not same:
                raise AssertionError(f"mg_scan at k = {k} from the {what} "
                                     "summary differs from its serial witness")
    return want


def summarization_phase(dev, mg_first=None):
    """Phase 8's path: feeder -> card -> count-min (two widths) and
    Misra-Gries. ``mg_first`` is the plain loop's (keys, counts) after the
    first batch, which the path's summary must equal bitwise; with None
    the path is only timed (``--measure``: no check, no chain counter).
    Returns the launch counts of the path and its rates."""
    import numpy as np
    import torch
    from repro_torch.kernels import mg_scan as mgk
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    from repro_torch.streams import sketches as sk
    from repro_torch.streams.feeder import StreamFeeder

    cms = {w: sk.countmin_init(SKETCH_DEPTH, w, seed=0, device=dev)
           for w in SKETCH_WIDTHS}
    merged = {w: torch.zeros_like(cm.table) for w, cm in cms.items()}
    mg = sk.mg_init(MG_K, device=dev)
    mg0 = mg
    host_ids, card_ids, ests = [], [], {w: [] for w in SKETCH_WIDTHS}
    check = mg_first is not None
    summaries, walked = [], [mgk.chain_stats(dev).clone()] if check else []
    ev = {"add_query": [], "window": [], "mg": []}

    def timed(what, fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        ev[what].append((a, b))
        return out

    feeder = StreamFeeder(token_batch, n_shards=SKETCH_SHARDS,
                          batch_per_shard=SKETCH_SEQS)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    sk.reset_dispatch_counts()
    t0 = time.perf_counter()
    feeder.start()
    try:
        for _ in range(SKETCH_BATCHES):
            b = feeder.next(timeout=300.0)
            ids_np = b.data["tokens"].reshape(-1)
            ids = torch.from_numpy(ids_np).to(dev)
            for w in SKETCH_WIDTHS:
                cms[w], est = timed("add_query", lambda: sk.countmin_add_query(
                    cms[w], ids))
                # the window sketch an edge node ships upstream; the cloud
                # merges the windows by adding their tables
                win = timed("window", lambda: sk.countmin_add(
                    cms[w]._replace(table=torch.zeros_like(cms[w].table)),
                    ids))
                merged[w] += win.table
                ests[w].append(est)
            mg = timed("mg", lambda: sk.mg_update(mg, ids))
            summaries.append(mg)
            if check:
                walked.append(mgk.chain_stats(dev).clone())
            if not host_ids:
                mg_after_first = (mg.keys.clone(), mg.counts.clone())
            host_ids.append(ids_np)
            card_ids.append(ids)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        feeder.stop()
        _STREAMS.clear()
    counts = ops.launch_counts()
    dispatch = sk.dispatch_counts()
    n_events = sum(len(x) for x in host_ids)
    per_batch = {k: sum(a.elapsed_time(b) for a, b in v) / SKETCH_BATCHES
                 for k, v in ev.items()}
    launched = {k: v for k, v in counts.items() if v}
    log(f"  events={n_events} seconds={secs!r} events_per_s="
        f"{n_events / secs!r} ms_per_batch(card, both widths) "
        f"add_query={per_batch['add_query']!r} "
        f"window={per_batch['window']!r} mg={per_batch['mg']!r} "
        f"feeder: batches={feeder.stats.batches} straggler_rescues="
        f"{feeder.stats.straggler_rescues} wait_s={feeder.stats.wait_s!r} "
        f"dispatch={dispatch} launches={launched}")
    per_batch_ids = SKETCH_SHARDS * SKETCH_SEQS * SKETCH_SEQ_LEN
    if n_events != SKETCH_BATCHES * per_batch_ids:
        raise AssertionError(f"summarization: {n_events} events")
    if dispatch["plain"] or dispatch["kernel"] != 2 * 2 * SKETCH_BATCHES:
        raise AssertionError(f"summarization: dispatch {dispatch}")
    rates = {"summarization_events_per_s": n_events / secs,
             **{f"ms_per_batch/{k}": v for k, v in per_batch.items()}}
    if not check:
        return counts, rates

    # the same batches through the plain versions on the card
    true = np.bincount(np.concatenate(host_ids))
    top = np.argsort(true)[::-1][:100]
    rng = np.random.default_rng(0)
    seen = np.nonzero(true)[0]
    sample = np.unique(np.concatenate(
        [top, rng.choice(seen, SKETCH_SAMPLE - len(top), replace=False)]))
    for w in SKETCH_WIDTHS:
        table = torch.zeros_like(cms[w].table)
        same_est = True
        for ids, est in zip(card_ids, ests[w]):
            table, pest = ref.countmin_update_query_ref(ids, table,
                                                        cms[w].seeds)
            same_est &= torch.equal(est, pest)
        same = torch.equal(table, cms[w].table)
        same_merge = torch.equal(merged[w], cms[w].table)
        q = sk.countmin_query(cms[w], torch.from_numpy(
            sample.astype(np.int32)).to(dev)).cpu().numpy()
        under = int((q < true[sample]).sum())
        over = (q - true[sample]).astype(np.float64)
        over_mean, over_max = float(over.mean()), float(over.max())
        log(f"  width {w}: table bitwise plain {same}, every batch's "
            f"estimates bitwise plain {same_est}, merged windows equal "
            f"{same_merge}; {len(sample)} keys: below true count {under}, "
            f"mean overestimate {over_mean!r} max {over_max!r}; top key "
            f"true {int(true[top[0]])} est {int(q[sample == top[0]][0])}")
        if not (same and same_est and same_merge) or under:
            raise AssertionError(f"summarization width {w}: wrong sketch")
    same_first = all(torch.equal(a.cpu(), b)
                     for a, b in zip(mg_after_first, mg_first))
    log(f"  misra-gries after the first batch: bitwise the plain loop's "
        f"{same_first}")
    if not same_first:
        raise AssertionError("misra-gries differs from its plain loop after "
                             "the first batch")
    # every batch's summary against the serial witness kernel, replayed
    # over the same ids from the same start
    per_call = [int(b[0] - a[0]) for a, b in zip(walked, walked[1:])]
    mg_ms = [a.elapsed_time(b) for a, b in ev["mg"]]
    w = mg0
    same_all = []
    for ids, got in zip(card_ids, summaries):
        w = sk.MisraGries(*mgk.mg_scan_serial_cuda(w.keys, w.counts, ids))
        same_all.append(torch.equal(w.keys, got.keys)
                        and torch.equal(w.counts, got.counts))
    log(f"  misra-gries: every batch's summary bitwise the serial witness's "
        f"{all(same_all)} ({sum(same_all)}/{len(same_all)}); chain share "
        f"per call {[c / per_batch_ids for c in per_call]!r}; chain ids "
        f"{per_call}; ns a chained id per call "
        f"{[c and t * 1e6 / c for t, c in zip(mg_ms, per_call)]!r}")
    if not all(same_all):
        bad = [i for i, v in enumerate(same_all) if not v]
        raise AssertionError(f"misra-gries differs from its serial witness "
                             f"on batches {bad}")
    k_top = int(mg.keys[int(torch.argmax(mg.counts))])
    log(f"  misra-gries top key {k_top} (count "
        f"{int(mg.counts.max())}); most frequent id {int(top[0])} "
        f"(count {int(true[top[0]])})")
    if k_top != int(top[0]):
        raise AssertionError("misra-gries missed the most frequent id")
    return counts, rates


# ---------------------------------------------------------------------------
# phase 9: the Mamba selective scan at jamba's mixer width
# ---------------------------------------------------------------------------

def mamba_inputs(g, dev, S: int, N=None, dI=None):
    """dt, x, B, C, A, h0 built as ``models/ssm.py`` builds them:
    dt = softplus(. - 4.6) (its dt_bias), A = -exp(A_log) with Mamba's
    S4D-real A_log = log(1..N); h0 nonzero only for a decode step. N and
    dI default to jamba's."""
    import torch
    import torch.nn.functional as F
    B, N, dI = MAMBA_B, N or MAMBA_N, dI or MAMBA_DI
    dt = F.softplus(torch.randn((B, S, dI), generator=g, device=dev) - 4.6)
    x = torch.randn((B, S, dI), generator=g, device=dev)
    Bm = torch.randn((B, S, N), generator=g, device=dev)
    Cm = torch.randn((B, S, N), generator=g, device=dev)
    A_log = torch.log(torch.arange(1, N + 1, device=dev, dtype=torch.float32))
    A = -torch.exp(A_log[None].expand(dI, N)
                   + 0.1 * torch.randn((dI, N), generator=g, device=dev))
    h0 = 0.1 * torch.randn((B, dI, N), generator=g, device=dev) * (S == 1)
    return dt, x, Bm, Cm, A, h0


def mamba_excess(a, b) -> float:
    """Largest excess of |a - b| over rtol=atol=``MAMBA_TOL``."""
    return float(((a - b).abs() - MAMBA_TOL * (1 + b.abs())).max())


def mamba_timed(dev, g, S: int, reps_floor: int):
    """Graph ms of the lane kernel and of the witness on input sets cycled
    past the L2, and the lane kernel's eager ms."""
    import torch
    from repro_torch.kernels import mamba_scan as ms
    first = mamba_inputs(g, dev, S)
    sets = [first] + [mamba_inputs(g, dev, S)
                      for _ in range(n_sets(first) - 1)]
    reps = max(reps_floor, len(sets))
    call = cycling(lambda *t: ms.mamba_scan_cuda(*t, chunk=MAMBA_CHUNK), sets)
    out = {"graph": graph_ms(call, reps), "eager": median_ms(call, reps)}
    witness = getattr(ms, "mamba_scan_witness_cuda", None)
    if witness is not None:
        out["witness_graph"] = graph_ms(cycling(
            lambda *t: witness(*t, chunk=MAMBA_CHUNK), sets), reps)
    del first, sets
    torch.cuda.empty_cache()
    return out


def mamba_phase(dev, g, record) -> dict:
    """The lane kernel against its plain version and the thread-a-channel
    witness at three shapes (graph-timed with the inputs cycled past the
    L2, eager and the witness logged beside), at N = 4 and at dI off the
    block's 64 channels (16-byte and 4-byte copies); then the public
    wrapper as the path. Returns the launch counts of the path."""
    import torch
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ops

    B = MAMBA_B
    checks = [(row, S, MAMBA_N, MAMBA_DI) for row, S in MAMBA_SHAPES]
    checks += [("mamba_scan/N4", MAMBA_CHECK_S, 4, MAMBA_DI),
               (f"mamba_scan/dI{MAMBA_DI - 4}", MAMBA_CHECK_S, MAMBA_N,
                MAMBA_DI - 4),
               ("mamba_scan/dI1001", MAMBA_CHECK_S, MAMBA_N, 1001)]
    for row, S, N, dI in checks:
        ins = mamba_inputs(g, dev, S, N, dI)
        y, h = ms.mamba_scan_cuda(*ins, chunk=MAMBA_CHUNK)
        wy, wh = ms.mamba_scan_witness_cuda(*ins, chunk=MAMBA_CHUNK)
        t0 = time.perf_counter()
        py, ph = ms.mamba_scan_ref(*ins)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        for a in (y, h):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{row}: non-finite output")
        excess = {"plain": max(mamba_excess(y, py), mamba_excess(h, ph)),
                  "witness": max(mamba_excess(y, wy), mamba_excess(h, wh))}
        err = max(float((y - py).abs().max()), float((h - ph).abs().max()))
        tol = MAMBA_TOL * (1 + float(torch.maximum(py.abs().max(),
                                                   ph.abs().max())))
        log(f"  {row} (B {B}, S {S}, dI {dI}, N {N}): elementwise excess "
            f"over rtol=atol={MAMBA_TOL}: {excess}")
        if max(excess.values()) > 0.0:
            raise AssertionError(f"{row}: outside rtol=atol={MAMBA_TOL}")
        del ins, y, h, wy, wh, py, ph
        torch.cuda.empty_cache()
        if row in dict(MAMBA_SHAPES):
            t = mamba_timed(dev, g, S, 20 if S > 1 else 100)
            log(f"    graph ms: kernel {t['graph']!r} [eager {t['eager']!r}]"
                f", the thread-a-channel witness {t['witness_graph']!r}")
            nbytes = 4 * (3 * B * S * dI + 2 * B * S * N + dI * N
                          + 2 * B * dI * N)
            record("mamba_scan", "src/repro_torch/kernels/csrc/mamba_scan.cu",
                   "src/repro/kernels/mamba_scan.py:70", err, tol, t["graph"],
                   plain_ms, nbytes, B * S * dI * (7 * N + 1),
                   row=None if row == "mamba_scan" else row)
    # the largest state sizes, above every config's: the lane kernel at
    # N 32 and 64 against its plain version and its witness, graph-timed
    for N in (32, 64):
        for tag, S in (("", MAMBA_CHECK_S), ("/decode", 1)):
            row = f"mamba_scan/N{N}{tag}"
            ins = mamba_inputs(g, dev, S, N)
            y, h = ms.mamba_scan_cuda(*ins, chunk=MAMBA_CHUNK)
            wy, wh = ms.mamba_scan_witness_cuda(*ins, chunk=MAMBA_CHUNK)
            t0 = time.perf_counter()
            py, ph = ms.mamba_scan_ref(*ins)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            if not (torch.isfinite(y).all() and torch.isfinite(h).all()):
                raise AssertionError(f"{row}: non-finite output")
            excess = {"plain": max(mamba_excess(y, py), mamba_excess(h, ph)),
                      "witness": max(mamba_excess(y, wy),
                                     mamba_excess(h, wh))}
            err = max(float((y - py).abs().max()),
                      float((h - ph).abs().max()))
            tol = MAMBA_TOL * (1 + float(torch.maximum(py.abs().max(),
                                                       ph.abs().max())))
            call = lambda: ms.mamba_scan_cuda(*ins, chunk=MAMBA_CHUNK)
            ms_graph = graph_ms(call, 20 if S > 1 else 100)
            wit = graph_ms(lambda: ms.mamba_scan_witness_cuda(
                *ins, chunk=MAMBA_CHUNK), 5 if S > 1 else 100)
            log(f"  {row} (B {B}, S {S}, dI {MAMBA_DI}, N {N}): elementwise "
                f"excess over rtol=atol={MAMBA_TOL}: {excess}; graph ms "
                f"{ms_graph!r}, the witness {wit!r}")
            if max(excess.values()) > 0.0:
                raise AssertionError(f"{row}: outside rtol=atol={MAMBA_TOL}")
            record("mamba_scan", "src/repro_torch/kernels/csrc/mamba_scan.cu",
                   "src/repro/kernels/mamba_scan.py:70", err, tol, ms_graph,
                   plain_ms,
                   4 * (3 * B * S * MAMBA_DI + 2 * B * S * N + MAMBA_DI * N
                        + 2 * B * MAMBA_DI * N),
                   B * S * MAMBA_DI * (7 * N + 1), row=row)
            del ins, y, h, wy, wh, py, ph
            torch.cuda.empty_cache()
    pad_route_checks(dev, g, record, ("mamba",))
    ins = mamba_inputs(g, dev, MAMBA_SHAPES[0][1])
    nodes = kernels_in_graph(lambda: ops.mamba_scan(*ins, chunk=MAMBA_CHUNK))
    log(f"  one call's CUDA graph: {nodes}")
    if len(nodes) != 1 or "mamba_scan_lanes" not in nodes[0]:
        raise AssertionError(f"mamba_scan: one call's CUDA graph holds {nodes}")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    y, h = ops.mamba_scan(*ins, chunk=MAMBA_CHUNK)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if y.shape != (B, MAMBA_SHAPES[0][1], MAMBA_DI) \
            or h.shape != (B, MAMBA_DI, MAMBA_N) \
            or not (torch.isfinite(y).all() and torch.isfinite(h).all()):
        raise AssertionError("ops.mamba_scan: misshapen or non-finite")
    log(f"  ops.mamba_scan: y {tuple(y.shape)}, h_last {tuple(h.shape)}, "
        f"launches={ {k: v for k, v in counts.items() if v} }")
    del ins, y, h
    torch.cuda.empty_cache()
    return counts


def mamba_measure(dev) -> dict:
    """The scan alone at phase 9's three shapes in the tree under test,
    for ``--measure --mamba``: the kernel's CUDA-graph and eager ms with
    the inputs cycled past the L2, and the witness's graph ms where the
    tree has one."""
    import torch
    g = torch.Generator(device=dev).manual_seed(1234)
    out = {}
    for row, S in MAMBA_SHAPES:
        tag = row.split("/")[-1] if "/" in row else "prefill"
        for k, v in mamba_timed(dev, g, S, 20 if S > 1 else 100).items():
            out[f"mamba_{tag}_{k}_ms"] = v
    return out


# ---------------------------------------------------------------------------
# phases 10-11: dynamic topology and the multi-tenant fleet
# ---------------------------------------------------------------------------

def control_lines(decisions):
    """A decision log without its elastic lines: a voluntary rescale reads
    the measured rate (the wall clock), and the involuntary one's worker
    count follows the voluntary ones. Nothing else in the control plane
    reads the wall clock or the batch size here (rates are pinned, the
    SLAs' latency limits are seconds), so the rest of the log, the cuts,
    plan identities and codecs are the same at any batch size."""
    return [ln for ln in decisions if "elastic" not in ln]


def profiled_window(profile: bool):
    import contextlib
    import torch
    if not profile:
        return contextlib.nullcontext()
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def device_busy(prof, wall_s: float) -> dict:
    """Kernel and copy ms on the card in a profiled window, and the
    card's idle share of its wall time, with and without the copies."""
    from repro_torch.launch.profile_stream import _device_events
    rows = _device_events(prof)
    copy_ms = sum(r[0] for r in rows if r[2].startswith(("Memcpy", "Memset")))
    kernel_ms = sum(r[0] for r in rows) - copy_ms
    wall_ms = wall_s * 1e3
    return {"wall_ms": wall_ms, "kernel_ms": kernel_ms, "copy_ms": copy_ms,
            "idle_share": 1.0 - kernel_ms / wall_ms,
            "idle_share_with_copies": 1.0 - (kernel_ms + copy_ms) / wall_ms}


def topology_run(device: str, n_events: int, dim: int, profile=False):
    """Phase 10's path, ``examples/dynamic_topology.py`` in the port: a
    ``MembershipDirectory`` on the example's edge and cloud; the job (the
    example's fan-out graph of the standard operators, ``sample_rate``
    0.5, DDM, the ``int8_ef`` codec) subscribes, then ``edge_rack`` and
    ``edge_far`` register at t = 0 and three latency probes refine the
    rack's uplink; ``TOPO_STEPS`` batches of ``n_events`` at a pinned
    rate, the rack's heartbeats stopping after step ``TOPO_LAST_BEAT``.
    Every rescale is recorded: ``(step, reason, states before, states
    after, launch counts before)``. Returns ``(orch, metrics, seconds,
    rescales, busy)``; ``busy`` is :func:`device_busy` of the run when
    ``profile``."""
    import torch
    from repro_torch.core import costmodel as cm
    from repro_torch.core.membership import Locality, MembershipDirectory
    from repro_torch.core.orchestrator import Orchestrator, StreamJob
    from repro_torch.core.pipeline import fanout_stream_graph
    from repro_torch.core.sla import SLA
    from repro_torch.kernels import ops
    from repro_torch.streams.generators import HyperplaneStream
    directory = MembershipDirectory(cm.ClusterSpec(
        pools=[cm.EDGE_NODE, cm.CLOUD_POD],
        links=[cm.Link("edge", "cloud", bw=2e6, latency=20e-3)]),
        lease_ticks=3)
    orch = Orchestrator(StreamJob(
        "dyn", dim=dim, sla=SLA(max_latency_s=1e3, error_budget=0.1),
        pipeline=fanout_stream_graph(dim, sample_rate=0.5,
                                     drift_detector="ddm"),
        membership=directory, sla_window=6, uplink_codecs=["int8_ef"],
        device=device))
    for name, loc, flops, link in (
            ("edge_rack", Locality(0.5, 0.0, region="metro"), 4e12,
             cm.Link("edge_rack", "cloud", bw=8e6, latency=5e-3)),
            ("edge_far", Locality(120.0, 90.0, region="rural"), 1e12,
             cm.Link("edge_far", "cloud", bw=1e6, latency=60e-3))):
        directory.register(
            cm.Resource(name, "edge", chips=2, flops=flops, mem_bw=100e9,
                        mem_cap=8e9, net_bw=1e9, net_latency=5e-3),
            links=[link], locality=loc, now=0)
    for _ in range(3):
        directory.observe_latency("edge_rack", "cloud", 4e-3, now=0)
    gen = HyperplaneStream(dim=dim, seed=0,
                           horizon=TOPO_STEPS * float(n_events))
    batches = [gen.batch(s, n_events) for s in range(TOPO_STEPS)]

    rescales = []
    apply = orch._apply_rescale

    def recorded(step, plan):
        before, counts = orch.states, ops.launch_counts()
        apply(step, plan)
        rescales.append((step, plan.reason, before, orch.states, counts))

    orch._apply_rescale = recorded

    def stream():
        for step, b in enumerate(batches):
            if step <= TOPO_LAST_BEAT:
                directory.heartbeat("edge_rack", now=step)
            directory.heartbeat("edge_far", now=step)
            yield b

    with profiled_window(profile) as prof:
        t0 = time.perf_counter()
        m = orch.run(stream(), rate_fn=lambda s: TOPO_RATE)
        if orch.device.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return orch, m, secs, rescales, device_busy(prof, secs) if profile \
        else None


def fleet_tenants(dims):
    """The four tenants of ``examples/fleet_pipeline.py``: ``dl`` (tier 0,
    4e4 events/s, two workers), two best-effort sketch jobs and a hog at
    1e9 events/s that cannot fit. ``(TenantSpec, StreamJob keywords)``."""
    from repro_torch.core.fleet import TenantSpec
    from repro_torch.core.sla import SLA
    loose = SLA(max_latency_s=10.0, error_budget=11.0)
    return [
        (TenantSpec("dl", priority=0, demand_rate=FLEET_DEMAND["dl"],
                    replan_cooldown=2,
                    sla=SLA(max_latency_s=2.0, error_budget=0.5)),
         {"dim": dims["dl"], "workers": 2}),
        (TenantSpec("sketch_a", priority=2,
                    demand_rate=FLEET_DEMAND["sketch_a"], sla=loose),
         {"dim": dims["sketch"]}),
        (TenantSpec("sketch_b", priority=2,
                    demand_rate=FLEET_DEMAND["sketch_b"], sla=loose),
         {"dim": dims["sketch"]}),
        (TenantSpec("hog", priority=1, demand_rate=1e9, sla=loose),
         {"dim": dims["sketch"]}),
    ]


def fleet_run(device: str, n_events: int, dims, profile=False):
    """Phase 11's path, ``examples/fleet_pipeline.py`` in the port on a
    live directory: the example's edge and cloud (its uplink, with a
    transmit energy) and a rack edge registered at t = 0;
    ``FleetOrchestrator(membership=...)`` takes the four tenants (the
    standard pipeline each), then ``FLEET_ROUNDS`` rounds of
    ``n_events`` a tenant at the declared demand. The seed edge
    heartbeats at round 0 only, so it fails through the directory at
    round ``FLEET_FAIL_ROUND``. Returns ``(fleet, admissions, metrics,
    seconds, ledger checks a round, busy)``."""
    import torch
    from repro_torch.core import costmodel as cm
    from repro_torch.core.fleet import FleetOrchestrator
    from repro_torch.core.membership import Locality, MembershipDirectory
    from repro_torch.core.orchestrator import StreamJob
    from repro_torch.streams.generators import DriftSpec, HyperplaneStream
    energy = dict(energy_per_byte=3e-7)
    directory = MembershipDirectory(cm.ClusterSpec(
        pools=[cm.EDGE_NODE, cm.CLOUD_POD],
        links=[cm.Link("edge", "cloud", bw=2e6, latency=20e-3, **energy)]),
        lease_ticks=FLEET_FAIL_ROUND - 1)
    directory.register(
        cm.Resource("edge_rack", "edge", chips=2, flops=4e12, mem_bw=100e9,
                    mem_cap=8e9, net_bw=1e9, net_latency=5e-3),
        links=[cm.Link("edge_rack", "cloud", bw=8e6, latency=5e-3,
                       **energy)],
        locality=Locality(0.5, 0.0, region="metro"), now=0, monitored=False)
    fleet = FleetOrchestrator(membership=directory)
    admissions, feeds = {}, {}
    for i, (spec, kw) in enumerate(fleet_tenants(dims)):
        res = fleet.add_tenant(spec, StreamJob(spec.name, device=device,
                                               **kw), seed=i)
        admissions[spec.name] = (res.admitted, res.queued)
        drift = ({"drift": DriftSpec("gradual", at=0.5, width=0.3)}
                 if spec.name == "dl" else {})
        gen = HyperplaneStream(dim=kw["dim"], seed=i + 1,
                               horizon=FLEET_ROUNDS * float(n_events),
                               **drift)
        feeds[spec.name] = [gen.batch(r, n_events)
                            for r in range(FLEET_ROUNDS)]
    checks = []
    with profiled_window(profile) as prof:
        t0 = time.perf_counter()
        for r in range(FLEET_ROUNDS):
            if r == 0:
                directory.heartbeat("edge", now=0)
            fleet.step_round({n: feeds[n][r] for n in fleet.orchestrators},
                             rates=FLEET_DEMAND)
            checks.append(fleet.scheduler.ledger.check())
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return (fleet, admissions, fleet.finish(), secs, checks,
            device_busy(prof, secs) if profile else None)


def states_on(states, device_type: str) -> bool:
    import torch
    from repro_torch._tree import tree_leaves
    return all(t.device.type == device_type for t in tree_leaves(states)
               if isinstance(t, torch.Tensor))


def bitwise_trees(a, b) -> bool:
    import torch
    from repro_torch._tree import tree_flatten_with_path
    fa, fb = tree_flatten_with_path(a)[0], tree_flatten_with_path(b)[0]
    return [p for p, _ in fa] == [p for p, _ in fb] and all(
        torch.equal(u, v) for (_, u), (_, v) in zip(fa, fb))


def topology_phase(dev) -> dict:
    """Phase 10: :func:`topology_run` on the card at ``N_EVENTS`` x
    ``DIM``, with the launch counts from 0; its checks; the same script
    on the CPU at ``CONTROL_EVENTS`` a batch for the control trajectory;
    a profiled rerun on the card for the idle share. Returns the main
    path's launch counts."""
    import torch
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    orch, m, secs, rescales, _ = topology_run(dev.type, N_EVENTS, DIM)
    counts = ops.launch_counts()
    launched = sorted(k for k, v in counts.items() if v > 0)
    log(f"  events={m.events} events_per_s={m.events / secs!r} "
        f"ms_per_batch={secs / TOPO_STEPS * 1e3!r} cuts={sorted(set(m.cuts))} "
        f"codecs={sorted(set(m.codecs))} migrations={m.migrations} "
        f"rescales={m.rescales} drift_alarms={m.drift_alarms} "
        f"launches={counts}")
    for ln in m.decisions:
        log(f"    {ln}")
    log(f"  {nvidia_smi_line()}")
    if m.events != TOPO_STEPS * N_EVENTS:
        raise AssertionError(f"topology: events {m.events}")
    dec = m.decisions
    fail = [i for i, ln in enumerate(dec)
            if "topology pool_failed edge_rack" in ln]
    if not any(":pool_joined" in ln for ln in dec) or len(fail) != 1:
        raise AssertionError("topology: no join replan or no failure of "
                             "edge_rack in the decisions")
    step = int(dec[fail[0]].split(":")[0])
    # the joins moved ops onto the rack, so its failure hits the plan
    if not ("[in plan]" in dec[fail[0]]
            and any(f"{step}:elastic-recover" in ln for ln in dec)
            and any(f"{step}:pool_lost" in ln for ln in dec)):
        raise AssertionError("topology: the rack's failure did not take the "
                             "plan through a rescale and a pool_lost replan")
    recover = [r for r in rescales if "edge_rack" in r[1]]
    if len(recover) != 1:
        raise AssertionError(f"topology: {len(recover)} recoveries")
    after_counts = {k: counts[k] - recover[0][4][k] for k in launched}
    log(f"  launches after the rescale and the pool_lost replan: "
        f"{after_counts}")
    if any(v <= 0 for v in after_counts.values()):
        raise AssertionError(f"topology: a path kernel was not launched "
                             f"after the rescale: {after_counts}")
    for r_step, reason, before, after, _ in rescales:
        if not (states_on(after, dev.type) and bitwise_trees(before, after)):
            raise AssertionError(f"topology: the rescale at {r_step} "
                                 f"({reason}) moved or changed the states")
    log(f"  {len(rescales)} rescales: every state back on the card, bitwise")
    post = {p for ident in m.plan_identities[step + 1:] for _, p in ident[0]}
    if "edge_rack" in post or "edge_rack" in orch.controller.resources.pools:
        raise AssertionError("topology: an op stays on edge_rack after its "
                             "failure")
    if not {"ef_int8_roundtrip", "detector_scan"} <= set(launched):
        raise AssertionError(f"topology: the path's kernels did not launch: "
                             f"{counts}")
    check_no_nan(orch.states, "topology")
    _, mc, _, _, _ = topology_run("cpu", CONTROL_EVENTS, DIM)
    same = (mc.cuts == m.cuts and mc.plan_identities == m.plan_identities
            and mc.codecs == m.codecs
            and control_lines(mc.decisions) == control_lines(m.decisions))
    log(f"  control trajectory equal to the CPU run at {CONTROL_EVENTS} "
        f"events a batch: {same}")
    if not same:
        raise AssertionError(f"topology: the card's control trajectory "
                             f"differs from the CPU's: "
                             f"{control_lines(mc.decisions)}")
    del orch
    torch.cuda.empty_cache()
    _, mp, psecs, _, busy = topology_run(dev.type, N_EVENTS, DIM,
                                         profile=True)
    log(f"  profiled rerun: events_per_s={mp.events / psecs!r} "
        f"{json.dumps(busy)}")
    return counts


def fleet_phase(dev) -> dict:
    """Phase 11: :func:`fleet_run` on the card at ``N_EVENTS`` a tenant a
    round, with the launch counts from 0; its checks; the same script on
    the CPU at ``CONTROL_EVENTS`` for the admissions, the audit log and
    each tenant's control trajectory; a profiled rerun for the idle
    share. Returns the main path's launch counts."""
    import torch
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    fleet, adm, ms, secs, checks, _ = fleet_run(dev.type, N_EVENTS,
                                                FLEET_DIMS)
    counts = ops.launch_counts()
    events = sum(m.events for m in ms.values())
    sched = fleet.scheduler
    log(f"  admitted={sched.admitted} queued={sched.queued} "
        f"events={events} events_per_s={events / secs!r} "
        f"ms_per_round={secs / FLEET_ROUNDS * 1e3!r} launches={counts}")
    for name, m in ms.items():
        log(f"  {name}: events={m.events} cuts={sorted(set(m.cuts))} "
            f"codecs={sorted(set(m.codecs))} migrations={m.migrations} "
            f"rescales={m.rescales} plan pools="
            f"{sorted(set(fleet.orchestrators[name]._exec_assignment.values()))}")
        for ln in m.decisions:
            log(f"    {ln}")
    for ln in sched.log:
        log(f"    log: {ln}")
    log(f"  {nvidia_smi_line()}")
    if checks != [[]] * FLEET_ROUNDS:
        raise AssertionError(f"fleet: ledger check failed: {checks}")
    if sched.queued != ["hog"] or "hog" in sched.admitted:
        raise AssertionError("fleet: the hog did not queue")
    if "edge" in fleet.cluster.pools or not any(
            "forced replan" in ln for ln in sched.log):
        raise AssertionError("fleet: the seed edge did not fail")
    for name, m in ms.items():
        orch = fleet.orchestrators[name]
        if m.events != FLEET_ROUNDS * N_EVENTS:
            raise AssertionError(f"fleet: {name} events {m.events}")
        if "edge" in set(orch._exec_assignment.values()):
            raise AssertionError(f"fleet: {name} keeps the dead pool")
        if not states_on(orch.states, dev.type):
            raise AssertionError(f"fleet: {name}'s states left the card")
        check_no_nan(orch.states, f"fleet/{name}")
    if not {"ef_int8_roundtrip", "ef_topk_int8_roundtrip",
            "detector_scan"} <= {k for k, v in counts.items() if v > 0}:
        raise AssertionError(f"fleet: the path's kernels did not launch: "
                             f"{counts}")
    cfleet, cadm, cms, _, _, _ = fleet_run("cpu", CONTROL_EVENTS, FLEET_DIMS)
    same = (cadm == adm and cfleet.scheduler.admitted == sched.admitted
            and cfleet.scheduler.queued == sched.queued
            and cfleet.scheduler.log == sched.log and all(
                cms[n].cuts == ms[n].cuts
                and cms[n].plan_identities == ms[n].plan_identities
                and cms[n].codecs == ms[n].codecs
                and control_lines(cms[n].decisions)
                == control_lines(ms[n].decisions) for n in ms)
            and set(cms) == set(ms))
    log(f"  admissions, queue, audit log and control trajectories equal to "
        f"the CPU run at {CONTROL_EVENTS} events a batch: {same}")
    if not same:
        raise AssertionError("fleet: the card's run differs from the CPU's")
    del fleet, ms
    torch.cuda.empty_cache()
    _, _, mp, psecs, _, busy = fleet_run(dev.type, N_EVENTS, FLEET_DIMS,
                                         profile=True)
    log(f"  profiled rerun: events_per_s="
        f"{sum(m.events for m in mp.values()) / psecs!r} {json.dumps(busy)}")
    return counts


# ---------------------------------------------------------------------------
# phase 12: training (examples/train_stream_lm.py and dl_train_op)
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 8, 512        # sequences x tokens a step
TRAIN_LR = 3e-4
TRAIN_WARM, TRAIN_TIMED = 2, 8   # qwen2-1.5b: untimed, then timed steps
RWKV_WARM, RWKV_TIMED = 1, 2     # rwkv6-1.6b: 3 steps (microbatches 4)
TRAIN_OP_LAYERS = 2              # dl_train_op at qwen2-1.5b's width
TRAIN_OP_STEPS = 2
TRAIN_PLACE_RATE = 1.0           # sequences/s offered to the placement DP
CKPT_STEPS, CKPT_AT, CKPT_S = 6, 3, 64
CPU_STEPS, CPU_TOL = 3, 1e-4     # the card against the CPU, smoke config
BF16_DENSE_PEAK = 989e12         # MFU's denominator (H100 SXM, dense bf16)


def train_stream(dev, arch: str, n_warm: int, n_timed: int) -> dict:
    """``examples/train_stream_lm.py``'s loop at ``arch``'s full config
    on the card: random bf16 weights from seed 0 (fp32 master weights
    and AdamW moments, the config's remat and microbatches), a drifting
    ``TokenStream`` (abrupt at half the horizon) of TRAIN_B x TRAIN_S
    tokens a step, ``make_optimizer(cfg, "adamw", lr=TRAIN_LR, warmup=2)``,
    Page-Hinkley on the loss on the card; ``n_warm`` untimed steps, then
    ``n_timed`` steps timed one by one (synchronised), then one more step
    under ``torch.profiler`` for the card's idle share."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo as zoo
    from repro_torch.streams import drift
    from repro_torch.streams.generators import DriftSpec, TokenStream
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.train_step import make_train_step

    cfg = get_config(arch)
    n_steps = n_warm + n_timed
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = zoo.init_params(cfg, seed=0, device=dev)
    opt = make_optimizer(cfg, "adamw", lr=TRAIN_LR, total_steps=n_steps,
                         warmup=2)
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt)
    gen = TokenStream(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                      drift=DriftSpec("abrupt", at=0.5),
                      horizon=float(n_steps * TRAIN_B * TRAIN_S))
    ph = drift.ph_init(dev)
    step = torch.zeros((), dtype=torch.int32, device=dev)
    out = {"loss": [], "grad_norm": [], "step_s": [], "alarms": []}
    busy = None
    for i in range(n_steps + 1):
        tokens = torch.from_numpy(gen.batch(i, TRAIN_B).data["tokens"]).to(dev)
        torch.cuda.synchronize()
        profile = i == n_steps
        with profiled_window(profile) as prof:
            t0 = time.perf_counter()
            params, state, step, m = step_fn(params, state, step,
                                             {"tokens": tokens})
            ph, level = drift.ph_step(ph, m["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if profile:
            busy = device_busy(prof, wall)
            break
        if i == n_steps - 1:
            out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        if m["loss"].device != params["embed"]["tok"].device or \
                not states_on((params, state), dev.type):
            raise AssertionError(f"{arch}: a step left the card")
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        if int(level) == drift.DRIFT:
            out["alarms"].append(i)
        if i >= n_warm:
            out["step_s"].append(wall)
    bad = [i for i, (l, g) in enumerate(zip(out["loss"], out["grad_norm"]))
           if not (math.isfinite(l) and math.isfinite(g) and g > 0)]
    if bad:
        raise AssertionError(f"{arch}: non-finite loss or grad_norm <= 0 at "
                             f"steps {bad}: {out}")
    step_s = statistics.median(out["step_s"])
    tokens = TRAIN_B * TRAIN_S
    n_active = cfg.param_counts()["active"]
    out.update(cfg=cfg, busy=busy, median_ms=step_s * 1e3,
               tok_per_s=tokens / step_s, n_active=n_active,
               mfu=6.0 * n_active * tokens / (step_s * BF16_DENSE_PEAK))
    log(f"  {arch}: {zoo.param_count(cfg)} parameters ({n_active} active), "
        f"remat={cfg.remat} microbatches={cfg.microbatches} batch "
        f"{TRAIN_B} x {TRAIN_S}")
    log(f"    losses={out['loss']!r}")
    log(f"    grad_norms={out['grad_norm']!r}")
    log(f"    step_ms={[t * 1e3 for t in out['step_s']]!r} "
        f"median_ms={out['median_ms']!r} tok_per_s={out['tok_per_s']!r} "
        f"mfu={out['mfu']!r} peak_gib={out['peak_bytes'] / 2 ** 30!r} "
        f"ph_alarms_at={out['alarms']}")
    log(f"    profiled step: {json.dumps(busy)}")
    log(f"    {nvidia_smi_line()}")
    del params, state, m, opt, step_fn
    torch.cuda.empty_cache()
    return out


def train_op_check(dev) -> None:
    """``dl_train_op`` at qwen2-1.5b's width with TRAIN_OP_LAYERS layers,
    placed by ``place_frontier`` on the edge serving example's cluster
    (``examples/edge_serving.py``: a train op is cloud-anchored) and run
    in its ``OpGraph`` at the plan's frontier, against the standalone
    ``make_train_step`` on the same card from the same seed and tokens:
    losses, gradient norms, parameters and moments bitwise."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import OpGraph
    from repro_torch.core.placement import Objective, place_frontier
    from repro_torch.models import model_zoo as zoo
    from repro_torch.train.ops import dl_train_op
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.train_step import make_train_step

    cfg = dataclasses.replace(get_config("qwen2-1.5b"),
                              n_layers=TRAIN_OP_LAYERS)
    opt = make_optimizer(cfg, "adamw", lr=TRAIN_LR,
                         total_steps=TRAIN_OP_STEPS, warmup=0)
    rng = np.random.default_rng(12)
    batches = [torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_S)).astype(np.int32)).to(dev)
        for _ in range(TRAIN_OP_STEPS)]
    op = dl_train_op(cfg, opt, batch_size=TRAIN_B, seq_len=TRAIN_S,
                     device=dev)
    graph = OpGraph([op])
    plan, frontier = place_frontier(graph, edge_serving_cluster(),
                                    TRAIN_PLACE_RATE, Objective(),
                                    method="dp")
    log(f"  dl_train_op ({TRAIN_OP_LAYERS} layers, state "
        f"{op.cost.state_bytes!r} bytes): place_frontier at "
        f"{TRAIN_PLACE_RATE} sequences/s -> {plan.assignment} "
        f"frontier={sorted(frontier)} feasible={plan.feasible}")
    if plan.assignment.get(op.name) != "cloud0" or frontier:
        raise AssertionError("dl_train_op was not anchored on the pod")
    states = graph.init_states(dev)
    params = zoo.init_params(cfg, seed=0, device=dev)
    ostate = opt.init(params)
    step = torch.zeros((), dtype=torch.int32, device=dev)
    step_fn = make_train_step(cfg, opt)
    for i, tokens in enumerate(batches):
        params, ostate, step, m = step_fn(params, ostate, step,
                                          {"tokens": tokens})
        states, got = graph.run(states, {"tokens": tokens}, frontier)
        same = all(torch.equal(m[k], got[k]) for k in ("loss", "grad_norm"))
        log(f"    step {i}: standalone loss {float(m['loss'])!r} grad_norm "
            f"{float(m['grad_norm'])!r}; op bitwise: {same}")
        if not same:
            raise AssertionError(f"dl_train_op step {i}: loss or grad_norm "
                                 "differs from the standalone step")
    p_op, o_op, s_op = states[op.name]
    if not (bitwise_trees(params, p_op) and bitwise_trees(ostate, o_op)
            and int(s_op) == int(step) == TRAIN_OP_STEPS
            and states_on(states, dev.type)):
        raise AssertionError("dl_train_op: parameters or moments differ "
                             "from the standalone step's")
    log("    parameters, moments and step bitwise the standalone step's, "
        "on the card")
    del states, params, ostate, p_op, o_op, graph, op
    torch.cuda.empty_cache()


def checkpoint_resume_check(dev) -> None:
    """qwen2-1.5b's smoke config on the card: CKPT_STEPS AdamW steps with
    an ``AsyncCheckpointer`` save after step CKPT_AT (the next step
    updates the tensors in place as soon as ``save`` returns), against a
    run restored from that save into fresh state: parameters and moments
    bitwise. The full config's train state would be ~25 GB of npz with
    bf16 widened; its size is logged, not written."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.models import model_zoo as zoo
    from repro_torch.streams.generators import TokenStream
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.train_step import make_train_step

    cfg = get_config("qwen2-1.5b", smoke=True)
    opt = make_optimizer(cfg, "adamw", lr=3e-3, total_steps=CKPT_STEPS,
                         warmup=2)
    step_fn = make_train_step(cfg, opt)
    gen = TokenStream(vocab_size=cfg.vocab_size, seq_len=CKPT_S)
    batches = [torch.from_numpy(gen.batch(i, TRAIN_B).data["tokens"]).to(dev)
               for i in range(CKPT_STEPS)]

    def run(params, state, start, saver=None):
        step = torch.tensor(start, dtype=torch.int32, device=dev)
        for i in range(start, CKPT_STEPS):
            params, state, step, _ = step_fn(params, state, step,
                                             {"tokens": batches[i]})
            if saver is not None and i + 1 == CKPT_AT:
                saver.save(int(step), {"params": params, "opt": state})
        return params, state

    d = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        p0 = zoo.init_params(cfg, seed=0, device=dev)
        with ckpt.AsyncCheckpointer(d) as saver:
            p_end, s_end = run(p0, opt.init(p0), 0, saver)
            saver.wait()
        nbytes = sum(f.stat().st_size for f in d.rglob("*") if f.is_file())
        fresh = zoo.init_params(cfg, seed=1, device=dev)
        tree, meta = ckpt.restore(d, {"params": fresh, "opt": opt.init(fresh)})
        if meta["step"] != CKPT_AT or not states_on(tree, dev.type):
            raise AssertionError(f"checkpoint: restored step {meta['step']} "
                                 "or a leaf off the card")
        r_end, rs_end = run(tree["params"], tree["opt"], CKPT_AT)
        same = bitwise_trees(p_end, r_end) and bitwise_trees(s_end, rs_end)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    # params widened to fp32 on disk, beside the fp32 master, m and v
    full_disk = 4 * 4 * zoo.param_count(get_config("qwen2-1.5b"))
    log(f"  checkpoint at step {CKPT_AT} of {CKPT_STEPS} (smoke config, "
        f"{nbytes} bytes on disk), restored into fresh state on the card: "
        f"parameters and moments bitwise the uninterrupted run's: {same}; "
        f"qwen2-1.5b's full train state would be {full_disk!r} bytes")
    if not same:
        raise AssertionError("checkpoint: the resumed run differs")


def train_batch(cfg, B: int, S: int, rng, device="cpu") -> dict:
    """A B x S batch of tokens drawn from ``rng`` (numpy), then, for an
    enc-dec model, B x S frames and, for a vision model, its patches,
    N(0, 1): the same inputs on every device."""
    import numpy as np
    import torch
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)
                                    ).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((B, S, cfg.frontend_dim),
                                              dtype=np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.frontend_dim), dtype=np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def routing_parts(cpu_layers, card_layers, what: str) -> bool:
    """Whether one step's MoE routing parts between the CPU and the card
    (the recorders' layers of that step): a token's expert ids may differ
    only at a near tie (else AssertionError), and where no id differs the
    keep masks and the dispatch's sort must be equal."""
    import torch
    parted = False
    for i, (a, b) in enumerate(zip(cpu_layers, card_layers)):
        differ = (a["ids"] != b["ids"]).any(-1)
        if (differ & ~(a["near"] | b["near"])).any():
            raise AssertionError(f"{what} layer {i}: expert ids differ "
                                 "away from a near tie")
        if differ.any():
            parted = True
        elif not parted and not (torch.equal(a["keep"], b["keep"])
                                 and torch.equal(a["order"], b["order"])):
            raise AssertionError(f"{what} layer {i}: keep masks or the "
                                 "stable sort differ")
    return parted


def card_vs_cpu_check(dev, arch: str = "qwen2-1.5b",
                      opt_name: str = "adamw") -> None:
    """``arch``'s smoke config, CPU_STEPS ``opt_name`` steps from the same
    weights (drawn on the CPU: a generator on the card draws other
    numbers from the same seed) on the same batches on the card and on
    the CPU: losses within CPU_TOL relative. An MoE model's routing is
    recorded at every step on both: ids equal but at a near tie
    (MOE_NEAR_TIE); from a step whose routing parts at one (it changes
    that step's gradients, so every later step's weights) the gaps are
    logged and not held."""
    import numpy as np
    import torch
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo as zoo
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.train_step import make_train_step

    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(21)
    batches = [train_batch(cfg, TRAIN_B, CKPT_S, rng)
               for _ in range(CPU_STEPS)]
    start = zoo.init_params(cfg, seed=0, device="cpu")
    losses, routes = {"card": [], "cpu": []}, {"card": [], "cpu": []}
    for tag, where in (("card", dev), ("cpu", torch.device("cpu"))):
        opt = make_optimizer(cfg, opt_name, lr=3e-3, total_steps=CPU_STEPS,
                             warmup=1)
        params = tree_map(lambda t: t.to(where, copy=True), start)
        state, step = opt.init(params), 0
        step_fn = make_train_step(cfg, opt)
        for b in batches:
            with RoutingRecorder() as rec:
                params, state, step, m = step_fn(
                    params, state, step,
                    {k: v.to(where) for k, v in b.items()})
            losses[tag].append(float(m["loss"]))
            routes[tag].append(rec.layers)
    card, cpu = losses["card"], losses["cpu"]
    held = next((i for i in range(CPU_STEPS) if routing_parts(
        routes["cpu"][i], routes["card"][i], f"{arch} step {i}")),
        CPU_STEPS)
    gaps = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
    gap = max(gaps[:held], default=0.0)
    parted = (f"; the routing parts at a near tie at step {held}, gaps "
              f"from it logged, not held: {gaps[held:]!r}"
              if held < CPU_STEPS else "")
    log(f"  card vs CPU ({arch} smoke config, {opt_name}, {CPU_STEPS} "
        f"steps): losses {card!r} vs {cpu!r}, largest relative gap "
        f"{gap!r} (tol {CPU_TOL}){parted}")
    if not gap <= CPU_TOL:
        raise AssertionError(f"{arch}: card and CPU losses disagree")


def training_phase(dev) -> dict:
    """Phase 12. Returns its launch counts: training takes the plain
    chunked paths (no kernel has a backward), so every count stays 0."""
    import torch
    from repro_torch.kernels import ops
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    log(f"phase 12a: examples/train_stream_lm.py at qwen2-1.5b's full config "
        f"({TRAIN_WARM} + {TRAIN_TIMED} steps)")
    a = train_stream(dev, "qwen2-1.5b", TRAIN_WARM, TRAIN_TIMED)
    timed = a["loss"][TRAIN_WARM:]
    first, last = statistics.mean(timed[:3]), statistics.mean(timed[-3:])
    log(f"    mean loss of the first 3 timed steps {first!r}, of the last 3 "
        f"{last!r}")
    if not last < first:
        raise AssertionError("qwen2-1.5b: the loss did not fall")
    log(f"phase 12b: rwkv6-1.6b's full config ({RWKV_WARM} + {RWKV_TIMED} "
        f"steps, microbatches 4)")
    b = train_stream(dev, "rwkv6-1.6b", RWKV_WARM, RWKV_TIMED)
    log("phase 12c: dl_train_op placed on the edge serving cluster")
    train_op_check(dev)
    log("phase 12d: async checkpoint and bitwise resume on the card")
    checkpoint_resume_check(dev)
    # (the card against the CPU, qwen2-1.5b's smoke config among every
    # model's: phase 21b)
    counts = ops.launch_counts()
    log(f"  phase 12 launches: {counts}")
    if any(counts.values()):
        raise AssertionError("training launched a hand kernel")
    summary = {arch: {k: r[k] for k in ("median_ms", "tok_per_s", "mfu",
                                        "peak_bytes")}
               | {"idle_share": r["busy"]["idle_share"]}
               for arch, r in (("qwen2-1.5b", a), ("rwkv6-1.6b", b))}
    log(f"  training: {json.dumps(summary)}")
    return counts


# ---------------------------------------------------------------------------
# phase 13: the orchestrator's other modes (fuse="xla", measured costs,
# a fusion-fed job, the stratified reservoir)
# ---------------------------------------------------------------------------

MODES_WALK = (0, 2, 5, 2, 0)     # the pipeline walked directly, 2 batches a cut
MODES_RTOL, MODES_ATOL = 1e-5, 1e-6   # the reference's fuse="xla" tolerance
MODES_PROFILED = 6               # batches of each mode's profiled rerun
MEASURED_TOL = 0.01              # the card's cost table against the CPU's
FUSION_SIDE = 32                 # the side stream's width
FUSION_TOL = 5.0                 # WindowJoin's tolerance, s
STRAT_CLASSES = 2
STRAT_K = 256
TRAIN_MODES_STEPS = 3            # 13e: one eager step, then two replays
# kernels a captured segment holds, by the wrapper counter they count in
GRAPH_KERNELS = {"ddm_tiled_kernel": "detector_scan",
                 "eddm_tiled_kernel": "detector_scan",
                 "ph_tiled_kernel": "detector_scan",
                 "adwin_scan_kernel": "detector_scan"}


def hand_kernel_names() -> list:
    """Every ``__global__`` function of the port's CUDA sources."""
    import re
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")
    csrc = pathlib.Path(__file__).resolve().parent / \
        "src" / "repro_torch" / "kernels" / "csrc"
    return sorted({k for f in csrc.glob("*.cu")
                   for k in pat.findall(f.read_text())})


def modes_run(batches, fuse: str, device: str, measured: bool = False,
              record: bool = False, detector: str = "ddm"):
    """Phase 3's job with ``int8_ef`` (:func:`dense_job`, its drift op's
    ``detector``) built under ``fuse`` over ``batches`` at a pinned 1e4
    events/s: ``(orch, metrics, seconds, host ms of each batch)``."""
    import torch
    orch = dense_job(batches[0].data["x"].shape[1], "int8_ef", 0.1, device,
                     fuse=fuse, measured=measured, detector=detector)
    batch_ms = []
    inner = orch.execute_batch

    def timed(step, batch, record_outputs=False):
        t0 = time.perf_counter()
        rate = inner(step, batch, record_outputs)
        if device == "cuda":
            torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        return rate

    orch.execute_batch = timed
    t0 = time.perf_counter()
    m = orch.run(batches, rate_fn=lambda s: 1e4, record_outputs=record)
    return orch, m, time.perf_counter() - t0, batch_ms


def graph_node_names(raw) -> list:
    """The device work of a CUDA graph (a ``CUgraph`` handle) as the
    driver lists it: a kernel node by its (mangled) name from
    ``cuFuncGetName`` (``cuKernelGetName`` where the node holds a
    ``CUkernel``), any other node but an empty one by its type."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} returned CUresult {rc}")

    raw = ctypes.c_void_p(raw)
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    get_params = getattr(cu, "cuGraphKernelNodeGetParams_v2", None) or \
        cu.cuGraphKernelNodeGetParams
    names = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        if kind.value == 5:
            continue
        if kind.value != 0:
            names.append(GRAPH_NODE_TYPES.get(kind.value, f"node{kind.value}"))
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: func at 0, kern at byte 56
        params = (ctypes.c_void_p * 16)()
        check(get_params(ctypes.c_void_p(node), params),
              "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if params[0]:
            check(cu.cuFuncGetName(ctypes.byref(name),
                                   ctypes.c_void_p(params[0])), "cuFuncGetName")
        else:
            check(cu.cuKernelGetName(ctypes.byref(name),
                                     ctypes.c_void_p(params[7])),
                  "cuKernelGetName")
        names.append((name.value or b"").decode())
    return names


def segment_graphs(pipe) -> dict:
    """``{segment's op names: (replays, kernel node names)}`` of a
    pipeline's captured segments."""
    return {seg.names: (seg.replays,
                        graph_node_names(seg.graph.raw_cuda_graph()))
            for seg in pipe.graph_segments}


def graph_launches(graphs: dict) -> dict:
    """The hand kernels' launches by graph replays: a replay launches
    every kernel node without passing through the wrappers' counters. A
    node is a hand kernel where its mangled name holds a ``__global__``
    of the port's sources (as ``<length><name>``); one that has no counter
    in ``GRAPH_KERNELS`` raises, rather than go uncounted."""
    known = hand_kernel_names()
    out = {}
    for replays, nodes in graphs.values():
        for node in nodes:
            for k in known:
                if f"{len(k)}{k}" not in node and node != k:
                    continue
                if k not in GRAPH_KERNELS:
                    raise AssertionError(
                        f"hand kernel {k} ({node}) in a captured graph has "
                        "no launch counter in GRAPH_KERNELS")
                counter = GRAPH_KERNELS[k]
                out[counter] = out.get(counter, 0) + replays
    return out


def trees_close(a, b):
    """``(every leaf within rtol/atol, every leaf bitwise, largest
    excess over the tolerance)`` of two trees of tensors."""
    import torch
    from repro_torch._tree import tree_flatten_with_path
    fa, fb = tree_flatten_with_path(a)[0], tree_flatten_with_path(b)[0]
    if [p for p, _ in fa] != [p for p, _ in fb]:
        raise AssertionError(f"tree structures differ: {[p for p, _ in fa]} "
                             f"vs {[p for p, _ in fb]}")
    bitwise, excess = True, float("-inf")
    for (p, u), (_, v) in zip(fa, fb):
        u, v = u.cpu(), v.cpu()
        if u.shape != v.shape or u.dtype != v.dtype:
            raise AssertionError(f"{p}: {u.shape}/{u.dtype} vs "
                                 f"{v.shape}/{v.dtype}")
        bitwise = bitwise and torch.equal(u, v)
        if u.numel():
            d = ((u.double() - v.double()).abs()
                 - (MODES_ATOL + MODES_RTOL * v.double().abs()))
            excess = max(excess, float(torch.nan_to_num(d, nan=1.0).max()))
    return excess <= 0.0, bitwise, excess


def segment_breakdown(orch, batches, first_step: int) -> dict:
    """Host-clock ms per batch of each segment the plan runs, with a
    synchronize after each (a captured segment is one replay)."""
    import torch
    pipe = orch.pipeline
    parts = {}
    saved = dict(pipe._segments)

    def timed(fn, name):
        def call(states, env):
            t0 = time.perf_counter()
            out = fn(states, env)
            torch.cuda.synchronize()
            parts[name] = parts.get(name, 0.0) + \
                (time.perf_counter() - t0) * 1e3
            return out
        return call

    for key, fn in saved.items():
        pipe._segments[key] = timed(fn, "+".join(pipe.ops[i].name
                                                 for i in key[0]))
    try:
        for step, b in enumerate(batches, start=first_step):
            orch.execute_batch(step, b)
    finally:
        pipe._segments.clear()
        pipe._segments.update(saved)
    return {k: v / len(batches) for k, v in parts.items()}


def profiled_rerun(orch, batches, first_step: int) -> dict:
    """:func:`device_busy` of ``len(batches)`` more batches of a run, its
    segments already cached."""
    import torch
    torch.cuda.synchronize()
    with profiled_window(True) as prof:
        t0 = time.perf_counter()
        for step, b in enumerate(batches, start=first_step):
            orch.execute_batch(step, b)
            orch.apply_decision(step, orch.controller.observe(
                step, 1e4, orch.sla))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return device_busy(prof, wall)


def walk_modes(batches, fuse: str, dev):
    """The standard pipeline walked directly through ``MODES_WALK`` (two
    batches a cut), states carried across cuts, the ``int8_ef`` wire
    round-trip where a batch crosses: ``(pipeline, final states, each
    batch's outputs on the host, compiles after each batch)``."""
    import torch
    from repro_torch.core.orchestrator import step_seed
    orch = dense_job(batches[0].data["x"].shape[1], "int8_ef", 0.1,
                     dev.type, fuse=fuse)
    pipe, states, uplink = orch.pipeline, orch.states, orch._uplink_fn()
    outs, compiles = [], []
    for i, b in enumerate(batches[:2 * len(MODES_WALK)]):
        bd = {k: torch.as_tensor(v).to(dev) for k, v in b.data.items()}
        bd["rng"] = torch.tensor(step_seed(0, i), dtype=torch.int64,
                                 device=dev)
        states, out = pipe.run(states, bd, MODES_WALK[i // 2], uplink=uplink)
        outs.append({k: v.cpu() for k, v in out.items()})
        compiles.append(pipe.compiles)
    return pipe, states, outs, compiles


def fuse_modes_check(dev, batches) -> dict:
    """Phase 13a: ``fuse="xla"`` against ``fuse="op"`` on phase 3's job
    and on a direct walk of the cuts. Returns the captured segments of
    every ``fuse="xla"`` pipeline that ran (for the launch counts)."""
    import numpy as np
    import torch
    from repro_torch.launch.profile_stream import op_breakdown
    runs, timed = {}, {}
    for fuse in ("op", "xla"):
        # a timed run, then one that records every batch's outputs (their
        # copies to the host would take most of its time)
        timed[fuse] = modes_run(batches, fuse, dev.type)
        orch, m, secs, batch_ms = timed[fuse]
        pipe = orch.pipeline
        log(f"  fuse={fuse}: events={m.events} events_per_s="
            f"{m.events / secs!r} ms_per_batch_median="
            f"{statistics.median(batch_ms)!r} batch_ms={batch_ms} "
            f"cuts={sorted(set(m.cuts))} drift_alarms={m.drift_alarms} "
            f"compiles={pipe.compiles} cache_hits={pipe.cache_hits}")
        runs[fuse] = modes_run(batches, fuse, dev.type, record=True)
        check_no_nan(runs[fuse][0].states, f"fuse={fuse}")
    (oa, ma, _, _), (ox, mx, _, _) = runs["op"], runs["xla"]
    same = all(getattr(ma, f) == getattr(mx, f) for f in (
        "events", "cuts", "plan_identities", "codecs", "drift_alarms")) \
        and control_lines(ma.decisions) == control_lines(mx.decisions)
    masks = all(np.array_equal(a["mask"], b["mask"])
                for a, b in zip(ma.outputs, mx.outputs))
    outs_ok, outs_bit, outs_ex = trees_close(
        [{k: torch.from_numpy(v) for k, v in o.items()} for o in mx.outputs],
        [{k: torch.from_numpy(v) for k, v in o.items()} for o in ma.outputs])
    st_ok, st_bit, st_ex = trees_close(ox.states, oa.states)
    log(f"  job: JobMetrics equal={same} masks bitwise={masks} outputs "
        f"within rtol {MODES_RTOL} atol {MODES_ATOL}={outs_ok} (bitwise "
        f"{outs_bit}, largest excess {outs_ex!r}) states within={st_ok} "
        f"(bitwise {st_bit}, largest excess {st_ex!r})")
    if not (same and masks and outs_ok and st_ok):
        raise AssertionError("fuse='xla' differs from fuse='op' on the job")
    px = ox.pipeline
    if not (px.compiles == len(px._segments) == len(px.graph_segments) == 2
            and px.cache_hits == 2 * len(batches) - 2):
        raise AssertionError(f"fuse='xla' job: {px.compiles} captures, "
                             f"{px.cache_hits} hits for the cut-4 plan's "
                             "2 segments")
    for seg in px.graph_segments:
        log(f"    segment {list(seg.names)}: capture ms {seg.capture_ms!r}, "
            f"replays {seg.replays}")
    # the walk 0 -> 2 -> 5 -> 2 -> 0
    walks = {fuse: walk_modes(batches, fuse, dev) for fuse in ("op", "xla")}
    (_, sa, oa_, _), (pw, sx, ox_, cx) = walks["op"], walks["xla"]
    w_masks = all(torch.equal(a["mask"], b["mask"]) for a, b in zip(oa_, ox_))
    w_out = trees_close(ox_, oa_)
    w_st = trees_close(sx, sa)
    log(f"  walk {MODES_WALK}: masks bitwise={w_masks} outputs "
        f"within={w_out[0]} (bitwise {w_out[1]}, excess {w_out[2]!r}) "
        f"states within={w_st[0]} (bitwise {w_st[1]}, excess {w_st[2]!r}) "
        f"captures after each batch {cx}")
    if not (w_masks and w_out[0] and w_st[0]):
        raise AssertionError("fuse='xla' differs from fuse='op' on the walk")
    if not (cx[2:] == [3] * (len(cx) - 2)
            and len(pw._segments) == len(pw.graph_segments) == 3):
        raise AssertionError(f"the walk captured {cx}: 3 distinct segments "
                             "expected, none on a revisit")
    for seg in pw.graph_segments:
        log(f"    segment {list(seg.names)}: capture ms {seg.capture_ms!r}, "
            f"replays {seg.replays}")
    # timings: the host clock per op (per segment under fuse="xla") and a
    # profiled rerun each
    more = batches[:MODES_PROFILED]
    log(f"  fuse=op host-clock ms per op: "
        f"{json.dumps(op_breakdown(timed['op'][0], more, 1000))}")
    for fuse, (orch, _, _, _) in timed.items():
        log(f"  fuse={fuse} host-clock ms per segment: "
            f"{json.dumps(segment_breakdown(orch, more, 2000))}")
        log(f"  fuse={fuse} profiled rerun ({MODES_PROFILED} batches): "
            f"{json.dumps(profiled_rerun(orch, more, 3000))}")
    graphs = {}
    for pipe in (px, timed["xla"][0].pipeline, pw):
        for names, (replays, nodes) in segment_graphs(pipe).items():
            key = (id(pipe),) + names
            graphs[key] = (replays, nodes)
            kernels = [n for n in nodes if n not in GRAPH_NODE_TYPES.values()]
            log(f"    graph of {list(names)}: {len(nodes)} nodes, "
                f"{len(kernels)} kernels, replays {replays}; hand kernels "
                f"{[n for n in nodes if any(t in n for t in GRAPH_KERNELS)]}")
            if "drift" in names and not any("ddm_tiled_kernel" in n
                                            for n in nodes):
                raise AssertionError(f"no DDM kernel in the graph of {names}")
    del runs, timed, walks
    torch.cuda.empty_cache()
    return graphs


def cost_tables_close(card: dict, cpu: dict):
    """The largest relative gap of the two tables, term by term."""
    worst = 0.0
    for name, c in card.items():
        for f in ("flops_per_event", "bytes_per_event", "out_bytes_per_event",
                  "state_bytes"):
            a, b = getattr(c, f), getattr(cpu[name], f)
            gap = abs(a - b) / max(abs(b), 1e-30) if (a or b) else 0.0
            worst = max(worst, gap)
    return worst


def measured_costs_check(dev, batches) -> None:
    """Phase 13b: ``measured_costs=True`` on phase 3's job; the card's cost
    table against the CPU's for the same first batch."""
    import torch
    from repro_torch.core import selftune
    from repro_torch.core.pipeline import standard_stream_pipeline
    orch, m, secs, _ = modes_run(batches, "op", dev.type, measured=True)
    _, md, _, _ = modes_run(batches[:1], "op", dev.type)
    names = orch.pipeline.names
    line = [d for d in m.decisions if "measured-costs" in d]
    log(f"  events_per_s={m.events / secs!r} {line}")
    if line != [f"0:measured-costs {len(names)}/{len(names)} ops"]:
        raise AssertionError(f"measured costs: decision line {line}")
    card = {n: orch.pipeline.cost_of(n) for n in names}
    bd = {k: torch.as_tensor(v) for k, v in batches[0].data.items()}
    bd["rng"] = torch.zeros((), dtype=torch.int64)
    t0 = time.perf_counter()
    cpu, notes = selftune.measure_operator_costs(
        standard_stream_pipeline(DIM, sample_rate=0.5, drift_detector="ddm"),
        bd)
    cpu_s = time.perf_counter() - t0
    if notes or set(cpu) != set(names):
        raise AssertionError(f"the CPU measured {sorted(cpu)}: {notes}")
    for n in names:
        d = orch.pipeline.op(n).cost
        log(f"    {n}: card flops/ev {card[n].flops_per_event!r} bytes/ev "
            f"{card[n].bytes_per_event!r} out/ev "
            f"{card[n].out_bytes_per_event!r} state {card[n].state_bytes!r}"
            f" | CPU {cpu[n].flops_per_event!r} {cpu[n].bytes_per_event!r} "
            f"{cpu[n].out_bytes_per_event!r} {cpu[n].state_bytes!r} | "
            f"declared {d.flops_per_event!r} {d.bytes_per_event!r} "
            f"{d.out_bytes_per_event!r} {d.state_bytes!r}")
    worst = cost_tables_close(card, cpu)
    log(f"  card vs CPU table: largest relative gap {worst!r} (tol "
        f"{MEASURED_TOL}; the CPU's measurement {cpu_s:.1f} s)")
    if worst > MEASURED_TOL:
        raise AssertionError("the card's cost table differs from the CPU's")
    log(f"  measured plan: {control_lines(m.decisions)} first "
        f"{m.plan_identities[0]}")
    log(f"  declared plan: {control_lines(md.decisions)} first "
        f"{md.plan_identities[0]}")


def fusion_run(device: str, n_events: int, dim: int):
    """Phase 13c's path: the dense stream joined with a ``FUSION_SIDE``-wide
    side stream on the same timestamps through ``WindowJoin``, then
    concat -> normalize -> logreg train -> drift (DDM), ``int8_ef``, a
    pinned 1e4 events/s: ``(orch, metrics, seconds, join host ms a
    batch)``."""
    import numpy as np
    import torch
    from repro_torch.core.orchestrator import Orchestrator, StreamJob
    from repro_torch.core.pipeline import (Pipeline, concat_op, drift_op,
                                           logreg_train_op, normalize_op)
    from repro_torch.core.sla import SLA
    from repro_torch.streams.events import StreamBatch
    from repro_torch.streams.fusion import WindowJoin
    rng = np.random.default_rng(1)
    join = WindowJoin(tolerance=FUSION_TOL)
    joined, join_ms = [], []
    for b in dense_batches(N_BATCHES, n_events, dim):
        right = StreamBatch(data={"x": rng.normal(
            size=(n_events, FUSION_SIDE)).astype(np.float32)},
            ts=np.asarray(b.ts))
        t0 = time.perf_counter()
        join.push_right(right)
        jb, matched = join.join_left(b)
        join_ms.append((time.perf_counter() - t0) * 1e3)
        if not matched.all():
            raise AssertionError(f"fusion: {int((~matched).sum())} events "
                                 "found no match")
        joined.append(jb)
    width = dim + FUSION_SIDE
    orch = Orchestrator(StreamJob(
        "fusion-fed", dim=width, pipeline=Pipeline([
            concat_op("joined", width), normalize_op(width),
            logreg_train_op(width), drift_op("ddm")]),
        sla=SLA(error_budget=0.1, max_latency_s=1e3),
        uplink_codecs=["int8_ef"], device=device))
    t0 = time.perf_counter()
    m = orch.run(joined, rate_fn=lambda s: 1e4)
    if device == "cuda":
        torch.cuda.synchronize()
    return orch, m, time.perf_counter() - t0, join_ms


def fusion_check(dev) -> None:
    """Phase 13c: the fusion-fed job on the card, against the same script
    on the CPU at ``CONTROL_EVENTS`` a batch."""
    orch, m, secs, join_ms = fusion_run(dev.type, N_EVENTS, DIM)
    log(f"  events={m.events} events_per_s={m.events / secs!r} "
        f"join_host_ms_per_batch_median={statistics.median(join_ms)!r} "
        f"cuts={sorted(set(m.cuts))} codecs={sorted(set(m.codecs))} "
        f"drift_alarms={m.drift_alarms} preq={m.preq}")
    if m.events != N_BATCHES * N_EVENTS or not m.preq["accuracy"] > 0.6:
        raise AssertionError(f"fusion-fed job: events {m.events}, "
                             f"preq {m.preq}")
    check_no_nan(orch.states, "fusion-fed job")
    _, mc, _, _ = fusion_run("cpu", CONTROL_EVENTS, DIM)
    same = (mc.cuts == m.cuts and mc.plan_identities == m.plan_identities
            and mc.codecs == m.codecs
            and control_lines(mc.decisions) == control_lines(m.decisions))
    log(f"  JobMetrics equal to the CPU run at {CONTROL_EVENTS} events a "
        f"batch: {same} (CPU preq {mc.preq})")
    if not same:
        raise AssertionError("fusion-fed job: the card's control trajectory "
                             "differs from the CPU's")


def stratified_check(dev, batches) -> None:
    """Phase 13d: the stratified reservoir over the batches' labels on the
    card, bitwise its plain version (``reservoir_update`` over each
    class's items with the same draws) and the same run on the CPU."""
    import torch
    from repro_torch.streams import sampling as samp
    sr = samp.stratified_init(STRAT_CLASSES, STRAT_K, DIM, device=dev)
    sr_cpu = samp.stratified_init(STRAT_CLASSES, STRAT_K, DIM)
    ms = []
    for b in batches:
        xc = torch.as_tensor(b.data["x"])
        yc = torch.as_tensor(b.data["y"])
        x, y = xc.to(dev), yc.to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new = samp.stratified_update(sr, x, y, STRAT_CLASSES)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        for c in range(STRAT_CLASSES):
            st = samp.ReservoirState(*(f[c] for f in sr.states))
            sel = y == c
            n_c = int(sel.sum())
            ar = torch.arange(n_c, device=dev)
            j = samp.draws(st.rng, ar) % (st.seen.long() + ar + 1)
            want = samp.reservoir_update(st, x[sel], y[sel], j=j)
            seed = samp.advance(st.rng) if n_c else st.rng
            got = samp.ReservoirState(*(f[c] for f in new.states))
            if not (bitwise_trees(got._replace(rng=seed), want._replace(
                    rng=seed)) and torch.equal(got.rng, seed)):
                raise AssertionError(f"stratified: class {c} differs from "
                                     "reservoir_update on its items")
        sr = new
        sr_cpu = samp.stratified_update(sr_cpu, xc, yc, STRAT_CLASSES)
    same_cpu = bitwise_trees(tuple(t.cpu() for t in sr.states),
                             tuple(sr_cpu.states))
    seen = sr.states.seen.tolist()
    log(f"  {len(batches)} batches: ms_per_batch_median="
        f"{statistics.median(ms)!r} seen={seen} bitwise the per-class "
        f"reservoir_update: True, the CPU's run: {same_cpu}")
    if not same_cpu or min(seen) <= STRAT_K:
        raise AssertionError("stratified: the card's run differs from the "
                             "CPU's, or a class never replaced")


def train_modes_check(dev) -> dict:
    """Phase 13e: ``dl_train_op`` at qwen2-1.5b's width with
    TRAIN_OP_LAYERS layers in an ``OpGraph`` under ``fuse="xla"`` against
    ``fuse="op"``, TRAIN_MODES_STEPS steps from one seed on the same
    tokens. Its optimizer writes parameters and moments in place and
    hands the same tensors back: the captured graph must write them back
    into the caller's. The first ``fuse="xla"`` step runs eagerly, the
    rest replay. Losses, gradient norms and states within MODES_RTOL and
    MODES_ATOL (bitwise logged). Returns the segment's graph."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import OpGraph
    from repro_torch.train.ops import dl_train_op
    from repro_torch.train.optim import make_optimizer

    cfg = dataclasses.replace(get_config("qwen2-1.5b"),
                              n_layers=TRAIN_OP_LAYERS)
    rng = np.random.default_rng(13)
    batches = [torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_S)).astype(np.int32)).to(dev)
        for _ in range(TRAIN_MODES_STEPS)]
    runs = {}
    for fuse in ("op", "xla"):
        opt = make_optimizer(cfg, "adamw", lr=TRAIN_LR,
                             total_steps=TRAIN_MODES_STEPS, warmup=0)
        op = dl_train_op(cfg, opt, batch_size=TRAIN_B, seq_len=TRAIN_S,
                         device=dev)
        graph = OpGraph([op], fuse=fuse)
        states = graph.init_states(dev)
        held = tree_leaves(states[op.name][:2])
        metrics, ms = [], []
        for tokens in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states, out = graph.run(states, {"tokens": tokens}, frozenset())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: out[k] for k in ("loss", "grad_norm")})
        same = all(a is b for a, b in zip(
            held, tree_leaves(states[op.name][:2]), strict=True))
        runs[fuse] = (graph, states[op.name], metrics, ms, same)
        log(f"  fuse={fuse}: losses "
            f"{[float(m['loss']) for m in metrics]} grad norms "
            f"{[float(m['grad_norm']) for m in metrics]} host ms a step "
            f"{ms} (the first xla step runs eagerly and captures); the "
            f"caller's tensors updated in place: {same}")
    (_, sa, ma, _, _), (gx, sx, mx, _, same_x) = runs["op"], runs["xla"]
    m_ok, m_bit, m_ex = trees_close(mx, ma)
    s_ok, s_bit, s_ex = trees_close(sx, sa)
    segs = gx.graph_segments
    log(f"  metrics within rtol {MODES_RTOL} atol {MODES_ATOL}={m_ok} "
        f"(bitwise {m_bit}, excess {m_ex!r}); states within={s_ok} "
        f"(bitwise {s_bit}, excess {s_ex!r}); captures {gx.compiles}, "
        f"replays {[s.replays for s in segs]}, capture ms "
        f"{[s.capture_ms for s in segs]}")
    if not (m_ok and s_ok and same_x):
        raise AssertionError("dl_train_op under fuse='xla' differs from "
                             "fuse='op'")
    if not (gx.compiles == len(segs) == 1
            and segs[0].replays == TRAIN_MODES_STEPS - 1):
        raise AssertionError(f"dl_train_op under fuse='xla': {gx.compiles} "
                             f"captures, replays {[s.replays for s in segs]}")
    graphs = {(id(gx),) + names: v
              for names, v in segment_graphs(gx).items()}
    del runs, sa, sx, segs, gx
    torch.cuda.empty_cache()
    return graphs


def modes_phase(dev, batches) -> dict:
    """Phase 13, one main path with the counts from 0: 13a-13e. Returns
    its launch counts, graph replays included."""
    import torch
    from repro_torch.kernels import ops
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    log(f"phase 13a: fuse='xla' (a CUDA graph a segment) against fuse='op', "
        f"phase 3's job ({len(batches)} x {N_EVENTS} x {DIM}, int8_ef) and "
        f"the walk {MODES_WALK}")
    graphs = fuse_modes_check(dev, batches)
    log("phase 13b: measured_costs=True on the same job")
    measured_costs_check(dev, batches)
    log(f"phase 13c: a fusion-fed job ({FUSION_SIDE}-wide side stream, "
        f"WindowJoin(tolerance={FUSION_TOL}), concat -> normalize -> train "
        "-> drift)")
    fusion_check(dev)
    log(f"phase 13d: the stratified reservoir ({STRAT_CLASSES} classes, "
        f"k {STRAT_K})")
    stratified_check(dev, batches)
    log(f"phase 13e: dl_train_op ({TRAIN_OP_LAYERS} layers at qwen2-1.5b's "
        f"width, in-place optimizer) under fuse='xla' against fuse='op', "
        f"{TRAIN_MODES_STEPS} steps")
    graphs.update(train_modes_check(dev))
    counts = ops.launch_counts()
    replayed = graph_launches(graphs)
    log(f"  phase 13 launches: wrappers {counts}, graph replays {replayed}")
    for k, v in replayed.items():
        counts[k] += v
    if not (counts["detector_scan"] > 0 and counts["ef_int8_roundtrip"] > 0
            and replayed.get("detector_scan", 0) > 0):
        raise AssertionError(f"phase 13: the path's kernels: {counts}")
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phases 19-20: the drift op's other detectors on the dense job
# ---------------------------------------------------------------------------

def detector_job(dev, batches, detector: str, kernel: str, tag: str,
                 alarm: bool) -> dict:
    """Phase 3's dense job (12 x 65,536 x 256, ``int8_ef``) with
    ``drift_detector=detector`` on the card: (a) one ``detector_scan``
    launch a batch, events and codecs right, no NaN, the learner
    recovering, and with ``alarm`` the planted drift raising an alarm;
    (b) the same script's small job (``ADWIN_SMALL``) on the card and on
    the CPU: events, cuts, codecs and drift alarms equal, the prequential
    metrics within 1e-3; (c) ``fuse="xla"`` against ``fuse="op"`` as
    phase 13a holds them: JobMetrics equal, masks bitwise, outputs and
    states within its tolerance, the drift segment's graph holding
    ``kernel`` as exactly one node. Logs under ``tag`` (19, 20); returns
    the launch counts from 0 (graph replays counted as launches)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    orch, m, secs = run_dense(batches, "int8_ef", 0.1, dev.type,
                              detector=detector)
    counts = ops.launch_counts()
    launched = {k: v for k, v in counts.items() if v}
    log(f"  {tag}a: events={m.events} detector={detector} "
        f"events_per_s={m.events / secs!r} "
        f"ms_per_batch={secs * 1e3 / len(batches)!r} "
        f"drift_alarms={m.drift_alarms} cuts={sorted(set(m.cuts))} "
        f"codecs={sorted(set(m.codecs))} preq={m.preq} launches={launched}")
    if m.events != len(batches) * N_EVENTS or set(m.codecs) != {"int8_ef"}:
        raise AssertionError(f"{detector} job: wrong events or codec "
                             "trajectory")
    if counts["detector_scan"] != len(batches):
        raise AssertionError(f"{detector} job: {counts['detector_scan']} "
                             f"detector scans for {len(batches)} batches")
    if alarm and m.drift_alarms < 1:
        raise AssertionError(f"{detector} job: the planted drift raised no "
                             "alarm")
    if not (0.6 < m.preq["ewma_accuracy"] <= 1.0):
        raise AssertionError(f"{detector} job: the learner did not "
                             f"recover: {m.preq}")
    check_no_nan(orch.states, detector)
    del orch

    small = dense_batches(*ADWIN_SMALL)
    _, mg, _ = run_dense(small, "int8_ef", 0.1, dev.type, sample_rate=1.0,
                         detector=detector)
    _, mc, _ = run_dense(small, "int8_ef", 0.1, "cpu", sample_rate=1.0,
                         detector=detector)
    same = (mg.events == mc.events and mg.cuts == mc.cuts
            and mg.codecs == mc.codecs and mg.drift_alarms == mc.drift_alarms)
    gap = max(abs(mg.preq[k] - mc.preq[k]) for k in
              ("accuracy", "logloss", "ewma_accuracy"))
    log(f"  {tag}b: small job, card vs CPU: "
        f"events/cuts/codecs/drift_alarms equal={same} (drift_alarms "
        f"{mg.drift_alarms}) max preq gap={gap!r} (tol 1e-3) "
        f"detector={detector}")
    if not same or gap > 1e-3:
        raise AssertionError(f"{detector} job: card and CPU runs disagree")
    for k, v in ops.launch_counts().items():
        counts[k] = v

    runs = {fuse: modes_run(batches, fuse, dev.type, record=True,
                            detector=detector) for fuse in ("op", "xla")}
    (oa, ma, sa, _), (ox, mx, sx, _) = runs["op"], runs["xla"]
    same = all(getattr(ma, f) == getattr(mx, f) for f in (
        "events", "cuts", "plan_identities", "codecs", "drift_alarms")) \
        and control_lines(ma.decisions) == control_lines(mx.decisions)
    masks = all(np.array_equal(a["mask"], b["mask"])
                for a, b in zip(ma.outputs, mx.outputs))
    outs_ok, outs_bit, outs_ex = trees_close(
        [{k: torch.from_numpy(v) for k, v in o.items()} for o in mx.outputs],
        [{k: torch.from_numpy(v) for k, v in o.items()} for o in ma.outputs])
    st_ok, st_bit, st_ex = trees_close(ox.states, oa.states)
    graphs = segment_graphs(ox.pipeline)
    replayed = graph_launches(graphs)
    log(f"  {tag}c: fuse='xla' vs 'op': JobMetrics "
        f"equal={same} masks bitwise={masks} outputs within={outs_ok} "
        f"(bitwise {outs_bit}, excess {outs_ex!r}) states within={st_ok} "
        f"(bitwise {st_bit}, excess {st_ex!r}); ms a batch "
        f"{sa * 1e3 / len(batches)!r} (op), {sx * 1e3 / len(batches)!r} "
        f"(xla) detector={detector}")
    drift_nodes = []
    mangled = f"{len(kernel)}{kernel}"
    for names, (replays, nodes) in graphs.items():
        hand = [n for n in nodes if any(t in n for t in GRAPH_KERNELS)]
        log(f"    graph of {list(names)}: {len(nodes)} nodes, replays "
            f"{replays}; hand kernels {hand}")
        if "drift" in names:
            drift_nodes = [n for n in nodes if mangled in n or n == kernel]
    if not (same and masks and outs_ok and st_ok):
        raise AssertionError(f"{detector} job: fuse='xla' differs from "
                             "fuse='op'")
    if len(drift_nodes) != 1:
        raise AssertionError(f"{detector} job: the drift segment's graph "
                             f"holds {len(drift_nodes)} {kernel} nodes")
    for k, v in ops.launch_counts().items():
        counts[k] = v + replayed.get(k, 0)
    del runs
    torch.cuda.empty_cache()
    log(f"  phase {tag} ({detector}) launches: {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 19: ADWIN on the dense job (the drift op's fourth detector)
# ---------------------------------------------------------------------------

def adwin_phase(dev, batches) -> dict:
    """Phase 19: :func:`detector_job` with ``drift_detector="adwin"``
    (``adwin_scan_kernel``), the planted drift raising an alarm."""
    return detector_job(dev, batches, "adwin", "adwin_scan_kernel", "19",
                        alarm=True)


# ---------------------------------------------------------------------------
# phase 20: EDDM and Page-Hinkley on the dense job
# ---------------------------------------------------------------------------

def detector_jobs_phase(dev, batches) -> dict:
    """Phase 20: :func:`detector_job` for each of ``DETECTOR_JOBS`` (their
    tiled kernels), after DDM's job in the same call as the yardstick; no
    alarm is required (a detector need not alarm on this drift). Returns
    ``{detector: launch counts}``, each from 0."""
    _, m, secs = run_dense(batches, "int8_ef", 0.1, dev.type)
    log(f"  20 (ddm, the yardstick): events_per_s={m.events / secs!r} "
        f"ms_per_batch={secs * 1e3 / len(batches)!r} "
        f"drift_alarms={m.drift_alarms}")
    return {det: detector_job(dev, batches, det, f"{det}_tiled_kernel", "20",
                              alarm=False)
            for det in DETECTOR_JOBS}


# ---------------------------------------------------------------------------
# phase 15: the launchers (launch.serve, launch.train) and the mesh
# ---------------------------------------------------------------------------

LAUNCH_SERVE_ARCH = "rwkv6-1.6b"
LAUNCH_TRAIN_ARCH = "granite-moe-1b-a400m"
LAUNCH_TRAIN_STEPS = 4           # TRAIN_B x TRAIN_S tokens a step
# factored second moments: the one checkpoint holds the parameters
# (bf16 widened to fp32 on disk, 5.3 GB) and ~2 MB of optimizer state;
# AdamW's fp32 master and moments would add 16 GB to write
LAUNCH_TRAIN_OPT = "adafactor"
LAUNCH_SMOKE = ("--arch", "qwen2-1.5b", "--smoke", "--steps", "6",
                "--batch", "2", "--seq", "16", "--ckpt-every", "3")


def launcher_main(main, argv):
    """``main(argv)`` with the lines it prints logged, indented; returns
    ``(its result, its lines)``."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = main(argv)
    lines = buf.getvalue().splitlines()
    for ln in lines:
        log(f"    | {ln}")
    return res, lines


def launch_serve_check(dev) -> dict:
    """15a: ``python -m repro_torch.launch.serve`` for rwkv6-1.6b at full
    width (its seed-0 weights) with phase 6's traffic, through its
    ``main``; the launch counts from 0 around it. Its greedy tokens must
    be those of ``ServeEngine`` driven directly on the same weights and
    prompts, and WKV must launch 24 times a prefill and a decode step."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as lserve
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config(LAUNCH_SERVE_ARCH)
    argv = ["--arch", LAUNCH_SERVE_ARCH, "--requests", str(N_REQUESTS),
            "--prompt-len", str(PROMPT), "--new-tokens", str(NEW_TOKENS),
            "--batch-size", str(SERVE_BATCH), "--max-len", str(MAX_LEN),
            "--device", dev.type]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    (done, eng), _ = launcher_main(lserve.main, argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    tp = eng.throughput()
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, PROMPT)
                    .astype(np.int32), max_new_tokens=NEW_TOKENS)
            for i in range(N_REQUESTS)]
    ServeEngine(cfg, eng.params, batch_size=SERVE_BATCH, max_len=MAX_LEN
                ).run(reqs)
    same = [r.out_tokens for r in done] == [r.out_tokens for r in reqs]
    waves = -(-N_REQUESTS // SERVE_BATCH)
    want_wkv = cfg.n_layers * NEW_TOKENS * waves
    launched = {k: v for k, v in counts.items() if v}
    log(f"  launch.serve {LAUNCH_SERVE_ARCH}: prefill_tok_per_s="
        f"{tp['prefill_tok_per_s']!r} decode_tok_per_s="
        f"{tp['decode_tok_per_s']!r} wall_s={wall!r} (weights drawn "
        f"included) peak_gib={torch.cuda.max_memory_allocated() / 2**30!r} "
        f"launches={launched} (WKV expected {want_wkv}); tokens equal "
        f"the engine's driven directly: {same}")
    log(f"    {nvidia_smi_line()}")
    if not same:
        raise AssertionError("launch.serve: tokens differ from the engine's")
    if counts["rwkv6_wkv"] != want_wkv or set(launched) != {"rwkv6_wkv"}:
        raise AssertionError(f"launch.serve: launches {launched}")
    del done, eng, reqs
    free_card()
    return counts


def launch_train_check(dev) -> dict:
    """15b: ``python -m repro_torch.launch.train`` for
    granite-moe-1b-a400m at full width (bf16, remat full), LAUNCH_TRAIN_
    STEPS steps of TRAIN_B x TRAIN_S on the drifting stream, one
    ``AsyncCheckpointer`` save at the last step; ms a step, tok/s, peak
    GiB, the save's caller-thread and write seconds. The checkpoint must
    be published at the last step and the params finite on the card."""
    import shutil
    import tempfile
    import torch
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.kernels import ops
    from repro_torch.launch import train as ltrain

    d = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_launch_"))
    argv = ["--arch", LAUNCH_TRAIN_ARCH, "--steps", str(LAUNCH_TRAIN_STEPS),
            "--batch", str(TRAIN_B), "--seq", str(TRAIN_S), "--optimizer",
            LAUNCH_TRAIN_OPT, "--ckpt-every", str(LAUNCH_TRAIN_STEPS),
            "--ckpt-dir", str(d), "--device", dev.type]
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        out, _ = launcher_main(ltrain.main, argv)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        nbytes = sum(f.stat().st_size for f in d.rglob("*") if f.is_file())
        latest = ckpt.latest_step(d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    st = out["stats"]
    steady = statistics.median(st["step_s"][1:])
    n_active = get_config(LAUNCH_TRAIN_ARCH).param_counts()["active"]
    mfu = 6.0 * n_active * TRAIN_B * TRAIN_S / (steady * BF16_DENSE_PEAK)
    log(f"  launch.train {LAUNCH_TRAIN_ARCH} ({LAUNCH_TRAIN_OPT}): "
        f"step_ms={[t * 1e3 for t in st['step_s']]!r} median_ms (after the "
        f"first)={steady * 1e3!r} tok_per_s={TRAIN_B * TRAIN_S / steady!r} "
        f"mfu={mfu!r} "
        f"launcher_tok_per_s={st['tok_per_s']!r} (first step and the "
        f"write included) peak_gib={peak!r} checkpoint: step {latest}, "
        f"{nbytes} bytes, caller-thread s={st['save_s']!r}, write wait "
        f"s={st['write_s']!r}")
    log(f"    {nvidia_smi_line()}")
    leaves = [t for t in tree_leaves(out["params"])
              if isinstance(t, torch.Tensor)]
    if latest != LAUNCH_TRAIN_STEPS or not all(
            t.device.type == dev.type and bool(torch.isfinite(t).all())
            for t in leaves):
        raise AssertionError("launch.train: no checkpoint at the last step, "
                             "or params off the card or not finite")
    if any(counts.values()):
        raise AssertionError(f"launch.train launched a hand kernel: {counts}")
    del out, leaves
    free_card()
    return counts


def launch_elastic_check(dev) -> None:
    """15c: the smoke config through ``launch.train`` on the card:
    ``--elastic --elastic-demand 8`` grows 1 -> 2 workers through the
    checkpoint cycle, capped at the one card, so the mesh is (1, 1): the
    state entering ``rescale_cycle`` and the state leaving it bitwise and
    on the card, and the run's final params and state bitwise the same
    run's without ``--elastic``; then ``--resume`` from that run's step-3
    checkpoint alone ends bitwise on its step 6."""
    import shutil
    import tempfile
    import torch
    from repro_torch import dist
    from repro_torch._tree import tree_map
    from repro_torch.dist import elastic as el
    from repro_torch.launch import train as ltrain

    cycles = []
    orig = el.rescale_cycle

    def copy(tree):     # the next steps update the trees in place
        return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                        else t, dist.gather_tree(tree))

    def recorded(directory, step, tree, *a, **kw):
        before = copy(tree)
        out, mesh = orig(directory, step, tree, *a, **kw)
        cycles.append((before, copy(out), tuple(mesh.shape)))
        return out, mesh

    root = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_elastic_"))
    base = list(LAUNCH_SMOKE) + ["--device", dev.type]
    el.rescale_cycle = recorded
    try:
        grown, lines = launcher_main(ltrain.main, base + [
            "--elastic", "--elastic-demand", "8", "--max-workers", "2",
            "--ckpt-dir", str(root / "elastic")])
    finally:
        el.rescale_cycle = orig
    try:
        plain, _ = launcher_main(ltrain.main, base + [
            "--ckpt-dir", str(root / "plain")])
        (root / "resumed").mkdir()
        shutil.copytree(root / "plain" / "step_0000000003",
                        root / "resumed" / "step_0000000003")
        resumed, rlines = launcher_main(ltrain.main, base + [
            "--resume", "--ckpt-dir", str(root / "resumed")])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    grew = any("elastic grow -> 2 workers" in ln and "on a (1, 1) mesh" in ln
               for ln in lines)
    cycle_ok = (len(cycles) == 1 and cycles[0][2] == (1, 1)
                and bitwise_trees(cycles[0][0], cycles[0][1])
                and states_on(cycles[0][1], dev.type))
    same = all(bitwise_trees(grown[k], plain[k]) for k in ("params", "opt"))
    resumed_same = any("resumed from step 3" in ln for ln in rlines) and all(
        bitwise_trees(resumed[k], plain[k]) for k in ("params", "opt"))
    log(f"  elastic grow to 2 workers on a (1, 1) mesh: {grew}; the cycle's "
        f"state in = out, on the card: {cycle_ok}; final state bitwise the "
        f"run without --elastic: {same}; --resume from step 3 bitwise at "
        f"step 6: {resumed_same}")
    if not (grew and cycle_ok and same and resumed_same):
        raise AssertionError("launch.train: the elastic cycle or the resume "
                             "is not bitwise")


def degenerate_mesh_check(dev) -> None:
    """15d: ``use_mesh(None)`` on the card (a (1, 1) ``DeviceMesh`` over
    a world of one) leaves a qwen2-1.5b smoke train step bitwise the
    step without it."""
    import numpy as np
    import torch
    from repro_torch import dist
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import build_rules
    from repro_torch.models import model_zoo as zoo
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.train_step import make_train_step

    cfg = get_config("qwen2-1.5b", smoke=True).with_overrides(
        recipe="tp_fsdp")
    tok = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab_size, (TRAIN_B, CKPT_S)).astype(np.int32)).to(dev)
    p0 = zoo.init_params(cfg, seed=0, device=dev)
    outs = []
    for under in (False, True):
        opt = make_optimizer(cfg, "adamw", lr=3e-3, total_steps=2, warmup=1)
        params = tree_map(torch.clone, p0)
        state = opt.init(params)
        fn = make_train_step(cfg, opt)
        if under:
            with dist.use_mesh(None, build_rules(cfg), device=dev) as mesh:
                shape, kind = tuple(mesh.shape), mesh.device_type
                for i in range(2):
                    params, state, _, _ = fn(params, state, i, {"tokens": tok})
        else:
            for i in range(2):
                params, state, _, _ = fn(params, state, i, {"tokens": tok})
        outs.append((params, state))
    same = bitwise_trees(outs[0], outs[1])
    log(f"  use_mesh(None): a {shape} {kind} mesh; 2 AdamW steps bitwise "
        f"the steps without it: {same}")
    if not (same and shape == (1, 1) and kind == dev.type):
        raise AssertionError("use_mesh(None) changed the train step")


def launchers_phase(dev) -> dict:
    """Phase 15. Returns the launch counts of its two main paths."""
    paths = {}
    log(f"phase 15a: python -m repro_torch.launch.serve --arch "
        f"{LAUNCH_SERVE_ARCH} ({N_REQUESTS} requests x {PROMPT} tokens, "
        f"{NEW_TOKENS} new, batch {SERVE_BATCH})")
    paths[f"launch_serve/{LAUNCH_SERVE_ARCH}"] = launch_serve_check(dev)
    log(f"phase 15b: python -m repro_torch.launch.train --arch "
        f"{LAUNCH_TRAIN_ARCH} ({LAUNCH_TRAIN_STEPS} steps of {TRAIN_B} x "
        f"{TRAIN_S}, one checkpoint)")
    paths[f"launch_train/{LAUNCH_TRAIN_ARCH}"] = launch_train_check(dev)
    log("phase 15c: launch.train --elastic and --resume at smoke width")
    launch_elastic_check(dev)
    log("phase 15d: use_mesh(None) on the card")
    degenerate_mesh_check(dev)
    return paths


# ---------------------------------------------------------------------------
# phase 16: the dry run (launch/dryrun.py) and its analysis against a real step
# ---------------------------------------------------------------------------

DRYRUN_TUNE = ("qwen2-1.5b", "train_4k")             # pod_16x16, through tune
DRYRUN_TUNE_MB = 2                                    # the second candidate
DRYRUN_CLI = ("granite-moe-1b-a400m", "prefill_32k")  # multipod_2x16x16
DRYRUN_TIMEOUT_S = 600
DRYRUN_PEAK_TOL = 0.10           # traced peak against max_memory_allocated
TUNE_SCRIPT = """
import json
from repro_torch.core import selftune as st
best, res = st.tune({arch!r}, {shape!r}, [
    st.Candidate({{}}, note="baseline"),
    st.Candidate({{"microbatches": {mb}}}, note="microbatches={mb}")],
    device={device!r})
print(json.dumps({{"best": best.candidate.note, "results": [
    {{"note": r.candidate.note, "ok": r.ok, "mem_gib": r.mem_gib,
      "bound_s": r.bound_s, "record": r.record}} for r in res]}}))
"""


def dryrun_processes(device: str) -> dict:
    """16a's two dry runs, each a process of its own (a fake world of 512
    ranks cannot share a process with phase 15's real group), started
    together: qwen2-1.5b train_4k on the single pod through
    ``selftune.tune`` (the baseline and microbatches=2), and
    granite-moe-1b-a400m prefill_32k on the multi-pod mesh through the
    CLI. Fake tensors on ``device``: nothing is allocated on it."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    arch, shape = DRYRUN_TUNE
    cmds = {
        "tune": [sys.executable, "-c", TUNE_SCRIPT.format(
            arch=arch, shape=shape, mb=DRYRUN_TUNE_MB, device=device)],
        "cli": [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                DRYRUN_CLI[0], "--shape", DRYRUN_CLI[1], "--mesh", "multi",
                "--force", "--device", device],
    }
    return {k: subprocess.Popen(c, cwd=ROOT, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
            for k, c in cmds.items()}


def dryrun_line(rec: dict) -> str:
    mem = rec["memory"]
    return (f"argument {mem['argument_size_in_bytes']!r} B, temp "
            f"{mem['temp_size_in_bytes']!r} B, total "
            f"{mem['total_per_device'] / 2 ** 30!r} GiB a rank; flops "
            f"{rec['cost']['flops']!r}, dot_flops {rec['cost']['dot_flops']!r}, "
            f"bytes {rec['cost']['bytes accessed']!r}; collectives "
            f"{json.dumps(rec['collectives'])}; dominant "
            f"{rec['roofline']['dominant']}; trace_s {rec['trace_s']!r}")


def dryrun_results(procs: dict) -> None:
    """Wait for 16a's processes; both cells must be ``ok``."""
    out = {}
    try:
        for k, p in procs.items():
            stdout, stderr = p.communicate(timeout=DRYRUN_TIMEOUT_S)
            out[k] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    rc, stdout, stderr = out["tune"]
    if rc:
        raise AssertionError(f"16a tune exited {rc}:\n{stderr[-4000:]}")
    tuned = json.loads(stdout.strip().splitlines()[-1])
    for r in tuned["results"]:
        rec = r["record"]
        if not r["ok"]:
            raise AssertionError(f"16a {DRYRUN_TUNE} {r['note']}: "
                                 f"{rec.get('traceback', rec.get('error'))}")
        log(f"  {DRYRUN_TUNE[0]} {DRYRUN_TUNE[1]} {rec['mesh']} "
            f"({r['note']}, {rec['recipe']}): {dryrun_line(rec)}")
        log(f"    tuner: mem_gib {r['mem_gib']!r} bound_s {r['bound_s']!r} "
            f"(the modelled cluster's roofline, not the card's)")
    log(f"  tuner's best: {tuned['best']}")
    rc, stdout, stderr = out["cli"]
    for ln in stdout.strip().splitlines():
        log(f"    | {ln}")
    path = (ROOT / "experiments" / "dryrun_torch" / "multipod_2x16x16"
            / DRYRUN_CLI[0] / f"{DRYRUN_CLI[1]}.json")
    rec = json.loads(path.read_text()) if path.exists() else {}
    if rc or not rec.get("ok"):
        raise AssertionError(f"16a {DRYRUN_CLI} exited {rc}: "
                             f"{rec.get('traceback', stderr[-4000:])}")
    log(f"  {DRYRUN_CLI[0]} {DRYRUN_CLI[1]} {rec['mesh']} ({rec['recipe']}): "
        f"{dryrun_line(rec)}")


def arguments_match(rec: dict, args) -> bool:
    from repro_torch.launch import dryrun
    return rec["memory"]["argument_size_in_bytes"] == dryrun.argument_bytes(args)


def dryrun_real_step_check(dev) -> dict:
    """16b-c: qwen2-1.5b's full config at phase 12's shape (TRAIN_B x
    TRAIN_S, AdamW with fp32 master weights, its remat) on a (1, 1) mesh:
    the dry run's record of the cell (fake tensors on the card's device
    type) against one real step on the card. Arguments and ``OpCount``'s
    operations exactly; the traced peak within DRYRUN_PEAK_TOL of
    ``max_memory_allocated``; then the argument check on one more leaf,
    which must fail. Returns the launch counts of the real steps."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.dist import use_mesh
    from repro_torch.dist.sharding import build_rules
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.op_count import OpCount
    from repro_torch.models import model_zoo as zoo
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.train_step import make_train_step

    cfg = get_config(DRYRUN_TUNE[0])
    shape = InputShape(f"train_{TRAIN_B}x{TRAIN_S}", TRAIN_S, TRAIN_B, "train")
    mesh = make_local_mesh(1, 1, device=dev.type)
    rules = build_rules(cfg, shape=shape)
    rec = dryrun.trace_cell(cfg, shape, mesh, rules, device=dev.type)
    log(f"  dry run of {cfg.name} at {TRAIN_B} x {TRAIN_S} on a (1, 1) mesh: "
        f"{dryrun_line(rec)}")
    free_card()
    params = zoo.init_params(cfg, seed=0, device=dev)
    opt = make_optimizer(cfg, "adamw")
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt)
    g = torch.Generator(device=dev).manual_seed(16)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S), device=dev,
                           generator=g, dtype=torch.int32)
    step = torch.zeros((), dtype=torch.int32, device=dev)
    args = (params, state, step, {"tokens": tokens})
    real_args = dryrun.argument_bytes(args)
    ops.reset_launch_counts()
    with use_mesh(mesh, rules), OpCount() as count:
        params, state, step, m = step_fn(*args)
    torch.cuda.synchronize()
    del m
    free_card()         # the counted step's garbage, before the peak's step
    args = (params, state, step, {"tokens": tokens})
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with use_mesh(mesh, rules):
        params, state, step, m = step_fn(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(dev)
    counts = ops.launch_counts()
    traced = rec["memory"]["total_per_device"]
    gap = (traced - peak) / peak
    same_args = arguments_match(rec, args)
    log(f"  real step on the card: arguments {real_args!r} B (record "
        f"{rec['memory']['argument_size_in_bytes']!r}: equal={same_args}); "
        f"OpCount flops {count.flops!r} (record {rec['cost']['flops']!r}), "
        f"products {count.products!r} (record {rec['cost']['dot_flops']!r}), "
        f"bytes {count.bytes!r} (record {rec['cost']['bytes accessed']!r})")
    log(f"    peak: max_memory_allocated {peak!r} B ({peak / 2 ** 30!r} GiB), "
        f"traced {traced!r} B ({traced / 2 ** 30!r} GiB), gap {gap!r} "
        f"(tol {DRYRUN_PEAK_TOL}); step {ms!r} ms, loss {float(m['loss'])!r}; "
        f"launches {counts}")
    log(f"    {nvidia_smi_line()}")
    if not same_args or real_args != dryrun.argument_bytes(args):
        raise AssertionError("16b: the record's argument bytes are not the "
                             "real step's")
    if count.flops != rec["cost"]["flops"] or \
            count.products != rec["cost"]["dot_flops"]:
        raise AssertionError("16b: the traced operations are not the real "
                             "step's")
    if abs(gap) > DRYRUN_PEAK_TOL:
        raise AssertionError(f"16b: traced peak {traced} against the card's "
                             f"{peak}: gap {gap}")
    if any(counts.values()):
        raise AssertionError(f"16b: a hand kernel launched: {counts}")
    extra = (params, state, step, {"tokens": tokens,
                                   "labels": tokens.clone()})
    caught = not arguments_match(rec, extra)
    log(f"  16c: one more leaf ({TRAIN_B} x {TRAIN_S} int32 labels): the "
        f"argument check fails: {caught}")
    if not caught:
        raise AssertionError("16c: the argument check passed one more leaf")
    del params, state, args, extra, m, step_fn
    free_card()
    return counts


def dryrun_phase(dev) -> dict:
    """Phase 16. Returns the launch counts of its real steps (none: the
    dry run traces fake tensors, and training launches no hand kernel)."""
    arch, shape = DRYRUN_TUNE
    log(f"phase 16a: the dry run at full width: {arch} {shape} on pod_16x16 "
        f"through selftune.tune (baseline, microbatches={DRYRUN_TUNE_MB}) "
        f"and {DRYRUN_CLI[0]} {DRYRUN_CLI[1]} on multipod_2x16x16 through "
        f"the CLI, each a process of its own")
    procs = dryrun_processes(dev.type)
    try:
        log(f"phase 16b: the dry run's analysis against a real step "
            f"({arch}, {TRAIN_B} x {TRAIN_S}, AdamW)")
        counts = dryrun_real_step_check(dev)
    except BaseException:
        for p in procs.values():
            p.kill()
            p.wait()
        raise
    dryrun_results(procs)
    return counts


# ---------------------------------------------------------------------------
# phase 17: the step on shards, two ranks on the one card (dist/fsdp.py)
# ---------------------------------------------------------------------------

SHARD_MESH = (2, 1)                          # (data, model): two ranks
SHARD_TRAIN_ARCH = "qwen2-1.5b"              # fsdp, remat "full"
SHARD_SERVE_ARCH = "seamless-m4t-medium"     # tp_fsdp
SHARD_DECODES = 8                            # greedy decode steps
SHARD_RTOL = 1e-3        # loss and grad norm against the one-rank step
SHARD_TIMEOUT_S = 600
SHARD_DRY_SCRIPT = """
import json
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.dist.sharding import build_rules
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_local_mesh
fake_world({ranks})
cfg = get_config({arch!r}).with_overrides(**{overrides!r})
shape = InputShape("train_{b}x{s}", {s}, {b}, "train")
rec = dryrun.trace_cell(cfg, shape, make_local_mesh({data}, {model},
                        device={device!r}), build_rules(cfg, shape=shape),
                        device={device!r})
print(json.dumps(rec))
"""


def shard_optimizer(cfg):
    """17a's AdamW (the config's state dtype and fp32 master weights) at
    TRAIN_LR from the first step: a step at the cosine schedule's warm-up
    start moves nothing."""
    from repro_torch.train.optim import make_optimizer
    return make_optimizer(cfg, "adamw", lr=TRAIN_LR, total_steps=1,
                          warmup=0)


def shard_state_shapes(cfg, opt):
    """The optimizer state of ``cfg``'s whole params as ``meta`` tensors."""
    import torch
    from repro_torch.models import model_zoo as zoo
    with torch.device("meta"):
        return opt.init(zoo.param_shapes(cfg))


def rule_shape(shape, axes, table, mesh_shape) -> tuple:
    """A leaf's ``shape`` as a rank of a ``mesh_shape`` (data, model) mesh
    holds it by the rules ``table`` (param or act) on its logical
    ``axes``, reckoned on a stand-in of the mesh."""
    from repro_torch.dist.api import logical_to_spec

    class StandIn:
        shape = dict(zip(("data", "model"), mesh_shape))

    out = list(shape)
    for i, part in enumerate(logical_to_spec(axes, table, StandIn, shape)):
        for a in ((part,) if isinstance(part, str) else part or ()):
            out[i] //= StandIn.shape[a]
    return tuple(out)


def shard_bytes(cfg, opt, rules, mesh_shape=SHARD_MESH) -> int:
    """A rank's exact argument bytes in 17a (18c, 18g), reckoned from the
    rules on a stand-in of the (2, 1) ((1, 2)) mesh: its shards of the
    params and the AdamW state, the step, its rows of the batch."""
    from repro_torch._tree import tree_flatten
    from repro_torch.dist.api import is_axes
    from repro_torch.models import model_zoo as zoo

    def local(t, ax, table):
        return math.prod(rule_shape(t.shape, ax, table, mesh_shape)) * \
            t.element_size()

    axes = zoo.param_axes(cfg)
    total = 4                                            # the int32 step
    for tree, ax_tree in ((zoo.param_shapes(cfg), axes),
                          (shard_state_shapes(cfg, opt),
                           opt.state_axes(axes))):
        total += sum(local(t, ax, rules["param"]) for t, ax in zip(
            tree_flatten(tree)[0], tree_flatten(ax_tree, is_leaf=is_axes)[0]))
    import torch
    tokens = torch.empty((TRAIN_B, TRAIN_S), dtype=torch.int32,
                         device="meta")
    return total + local(tokens, ("batch", None), rules["act"])


def serve_prompts(cfg):
    """Phase 6's first SERVE_BATCH prompts."""
    import numpy as np
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, size=PROMPT).astype(np.int32)
            for _ in range(SERVE_BATCH)]


def greedy_tokens(params, cfg, batch):
    """``zoo.prefill``, then SHARD_DECODES greedy ``zoo.decode_step``s,
    all with ``impl="kernel"``: (B, 1 + SHARD_DECODES) tokens on the
    host, each cache leaf's ``(shape, logical axes, bytes)`` by path
    (what ``split_cache_check`` holds to the act rules' split), and each
    step's logits on the host (B, steps, V)."""
    import torch
    from repro_torch._tree import tree_flatten, tree_flatten_with_path
    from repro_torch.dist.api import is_axes
    from repro_torch.models import model_zoo as zoo
    logits, caches = zoo.prefill(params, cfg, batch, MAX_LEN, impl="kernel")
    out, steps = [], []
    for i in range(SHARD_DECODES + 1):
        last = logits[:, -1, :cfg.vocab_size]
        steps.append(last.float().cpu())
        tok = torch.argmax(last, -1)[:, None]
        out.append(tok)
        if i < SHARD_DECODES:
            logits, caches = zoo.decode_step(params, cfg, caches, tok,
                                             impl="kernel")
    leaves = tree_flatten_with_path(caches)[0]
    axes = tree_flatten(zoo.cache_axes(caches), is_leaf=is_axes)[0]
    cache = {path: (tuple(t.shape), ax, t.numel() * t.element_size())
             for (path, t), ax in zip(leaves, axes)}
    return torch.cat(out, dim=1).cpu(), cache, torch.stack(steps, dim=1)


def shard_train_reference(dev, work: pathlib.Path, arch=SHARD_TRAIN_ARCH,
                          tag="17a", overrides=None) -> dict:
    """17a's (18c's, 18g's) one-rank step: ``arch``'s seed-0 weights at
    full width (``overrides`` of its config, where given), one AdamW step
    of TRAIN_B x TRAIN_S tokens on the card with no mesh. The tokens and
    the updated params go to ``work`` for the ranks (on the host: the
    card is freed for them)."""
    import torch
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo as zoo
    from repro_torch.train.train_step import make_train_step

    cfg = get_config(arch).with_overrides(**(overrides or {}))
    opt = shard_optimizer(cfg)
    g = torch.Generator(device=dev).manual_seed(17)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S), device=dev,
                           generator=g, dtype=torch.int32)
    params = zoo.init_params(cfg, seed=0, device=dev)
    state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params, state, _, m = make_train_step(cfg, opt)(
        params, state, 0, {"tokens": tokens})
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "ms": ms, "peak": torch.cuda.max_memory_allocated(dev)}
    torch.save(tokens.cpu(), work / f"{tag}_tokens.pt")
    torch.save(tree_map(lambda t: t.cpu(), params),
               work / f"{tag}_ref_params.pt")
    log(f"  {tag} one rank: loss {out['loss']!r} grad_norm "
        f"{out['grad_norm']!r}, step {ms!r} ms (first step on the card), "
        f"max_memory_allocated {out['peak']!r} B")
    del params, state, m
    free_card()
    return out


def shard_serve_reference(dev):
    """17b's one-rank serving: seamless-m4t-medium's seed-0 weights, each
    rank's rows of the prompts as a call of their own (the shapes a rank
    runs), greedy tokens on the host."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo as zoo
    from repro_torch.serve.engine import wave_inputs

    cfg = get_config(SHARD_SERVE_ARCH)
    params = zoo.init_params(cfg, seed=0, device=dev)
    prompts = serve_prompts(cfg)
    n = SERVE_BATCH // SHARD_MESH[0]
    with torch.no_grad():
        tokens = torch.cat([greedy_tokens(params, cfg, wave_inputs(
            cfg, prompts[lo:lo + n], dev))[0]
            for lo in range(0, SERVE_BATCH, n)])
    del params
    free_card()
    return tokens


def draw_local(cfg, mesh, rules, dev):
    """This rank's shards of ``cfg``'s seed-0 weights, bitwise
    ``zoo.init_params`` then the params' ``fsdp.Layout.local``
    (``params.materialize`` keeping ``Layout.local_leaf``: each leaf
    drawn whole on the card from its per-path seed, its shard kept, the
    whole value freed before the next), the ranks taking turns (a
    barrier), so that the card holds one rank's draw of one whole leaf
    at a time. Returns the shards, the layout, and the draw's peak bytes
    and seconds."""
    import torch
    import torch.distributed as tdist
    from repro_torch.dist import fsdp
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import params as pmod

    layout = fsdp.Layout(zoo.param_shapes(cfg), zoo.param_axes(cfg), rules,
                         mesh)
    for r in range(tdist.get_world_size()):
        if r == tdist.get_rank():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            params = pmod.materialize(zoo.model_specs(cfg), 0,
                                      zoo.dtype_of(cfg.param_dtype), dev,
                                      layout.local_leaf)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev)
            free_card()
        tdist.barrier()
    return params, layout, peak, secs


def shard_train_rank(dev, work: pathlib.Path, arch=SHARD_TRAIN_ARCH,
                     mesh_shape=SHARD_MESH, tag="17a", overrides=None) -> dict:
    """17a (18c, 18g) on one rank: this rank's shards of the seed-0
    weights (``draw_local``; ``overrides`` of the config, where given),
    DTensors of them, the AdamW state made from the shards, the rank's
    rows of the batch; one step on the shards. Its arguments, peaks,
    loss, grad norm, and each updated param against the one-rank step's
    (2 x lr plus one bf16 ulp of it)."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch import dist
    from repro_torch._tree import tree_flatten
    from repro_torch.configs import get_config
    from repro_torch.dist import fsdp
    from repro_torch.dist.api import logical_to_spec, spec_to_placements
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.models import model_zoo as zoo
    from repro_torch.train.train_step import make_train_step

    cfg = get_config(arch).with_overrides(**(overrides or {}))
    opt = shard_optimizer(cfg)
    axes = zoo.param_axes(cfg)
    with mesh_context(cfg, *mesh_shape, device=dev.type) as mesh:
        rules = dist.current_rules()
        local, p_lay, draw_peak, _ = draw_local(cfg, mesh, rules, dev)
        s_lay = fsdp.Layout(shard_state_shapes(cfg, opt),
                            opt.state_axes(axes), rules, mesh)
        params, state = p_lay.placed(local), s_lay.placed(opt.init(local))
        del local
        tokens = torch.load(work / f"{tag}_tokens.pt").to(dev)
        spec = logical_to_spec(("batch", None), rules["act"], mesh,
                               tokens.shape)
        batch = {"tokens": distribute_tensor(
            tokens, mesh, spec_to_placements(spec, mesh), src_data_rank=None)}
        step = torch.zeros((), dtype=torch.int32, device=dev)
        args = (params, state, step, batch)
        arg_bytes = dryrun.argument_bytes(args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params, state, _, m = make_train_step(cfg, opt)(*args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev)
        del args, state, batch
        ref = p_lay.local(torch.load(work / f"{tag}_ref_params.pt",
                                     mmap=True))
        excess, over, checked = -math.inf, 0, 0
        for got, want in zip(tree_flatten(params)[0], tree_flatten(ref)[0]):
            a = got.to_local().float()
            b = want.to(dev).float()
            ulp = torch.ldexp(torch.ones_like(b), torch.frexp(b)[1] - 8)
            gap = (a - b).abs() - (2 * TRAIN_LR + torch.where(b == 0, 0.0,
                                                              ulp))
            excess = max(excess, float(gap.max()))
            over += int((gap > 0).sum())
            checked += b.numel()
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "arg_bytes": arg_bytes, "peak": peak, "ms": ms,
            "draw_peak": draw_peak, "excess": excess, "over": over,
            "checked": checked}


def shard_serve_rank(dev) -> dict:
    """17b on one rank: this rank's shards of seamless-m4t-medium's
    seed-0 weights (``draw_local``); prefill of its rows of the prompts
    and SHARD_DECODES greedy decode steps on the shards, each layer
    gathered as it runs, the flash kernel in its cross-attention. The
    launch counts are from 0 just before."""
    import torch
    from repro_torch import dist
    from repro_torch.configs import get_config
    from repro_torch.dist import fsdp
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.serve.engine import wave_inputs

    cfg = get_config(SHARD_SERVE_ARCH)
    with mesh_context(cfg, *SHARD_MESH, device=dev.type) as mesh:
        rules = dist.current_rules()
        params = draw_local(cfg, mesh, rules, dev)[0]
        n = SERVE_BATCH // SHARD_MESH[0]
        lo = mesh.get_local_rank("data") * n
        batch = wave_inputs(cfg, serve_prompts(cfg)[lo:lo + n], dev)
        arg_bytes = dryrun.argument_bytes(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad(), fsdp.sharded(mesh, rules, ("data",)):
            tokens = greedy_tokens(params, cfg, batch)[0]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
    return {"rows": (lo, lo + n), "tokens": tokens, "launches": counts,
            "s": secs, "arg_bytes": arg_bytes,
            "peak": torch.cuda.max_memory_allocated(dev)}


def sharded_rank(rank: int, store: str, work: str, device: str) -> None:
    """One of phase 17's two ranks: a process of its own on the one card,
    joined with the other through a ``file://`` store with gloo (NCCL
    refuses two ranks on one device). 17a, then 17b; what it holds goes
    to ``work/rank<rank>.pt``."""
    import datetime
    import torch
    import torch.distributed as tdist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tdist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank,
        world_size=math.prod(SHARD_MESH),
        timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    try:
        dev = torch.device(device)
        work = pathlib.Path(work)
        out = {"train": shard_train_rank(dev, work)}
        free_card()
        out["serve"] = shard_serve_rank(dev)
        torch.save(out, work / f"rank{rank}.pt")
    finally:
        tdist.destroy_process_group()


def shard_processes(work: pathlib.Path, device: str,
                    dry=(("dry", SHARD_TRAIN_ARCH, {}),),
                    mesh_shape=SHARD_MESH, rank_fn="sharded_rank") -> dict:
    """The two ranks (``rank_fn`` of this module; none where None) and
    the dry runs ``dry`` ((name, arch, config overrides): 17a's (2, 1)
    cell, 18c's and 18g's (1, 2) ones) each over a fake world of two (a
    process of its own: a fake world cannot share a process with a real
    group), each writing its output to ``work``."""
    import os
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(SRC), str(ROOT)]))
    cmds = {}
    for name, arch, overrides in dry:
        cmds[name] = [sys.executable, "-c", SHARD_DRY_SCRIPT.format(
            ranks=math.prod(mesh_shape), arch=arch, overrides=overrides,
            b=TRAIN_B, s=TRAIN_S, data=mesh_shape[0], model=mesh_shape[1],
            device=device)]
    for r in range(math.prod(mesh_shape) if rank_fn else 0):
        cmds[r] = [sys.executable, "-c",
                   f"import chip_smoke; chip_smoke.{rank_fn}({r}, "
                   f"{str(work / 'store')!r}, {str(work)!r}, {device!r})"]
    procs = {}
    for k, c in cmds.items():
        with open(work / f"{k}.out", "w") as out, \
                open(work / f"{k}.err", "w") as err:
            procs[k] = subprocess.Popen(c, cwd=ROOT, env=env, text=True,
                                        stdout=out, stderr=err)
    return procs


def shard_wait(procs: dict, work: pathlib.Path, phase="17") -> dict:
    """Wait for phase 17's (18's) processes; each must exit 0."""
    deadline = time.monotonic() + SHARD_TIMEOUT_S
    for k, p in procs.items():
        rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
        if rc:
            raise AssertionError(f"{phase}: process {k} exited {rc}:\n"
                                 f"{(work / f'{k}.err').read_text()[-4000:]}")
    return {k: (work / f"{k}.out").read_text() for k in procs}


def sharded_phase(dev) -> dict:
    """Phase 17: the step on shards (``dist/fsdp.py``) on two ranks of the
    one card, held to the one-rank step: 17a qwen2-1.5b's AdamW step at
    full width (``fsdp``, remat "full") and its dry run on a (2, 1) fake
    world, 17b seamless-m4t-medium's greedy serving (``tp_fsdp``) with the
    flash kernel. Returns the launch counts of the ranks' paths."""
    import shutil
    import tempfile
    import torch
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.dist.sharding import build_rules
    from repro_torch.models import model_zoo as zoo

    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_phase17_"))
    procs = {}
    try:
        log(f"phase 17a: {SHARD_TRAIN_ARCH} at full width, one AdamW step of "
            f"{TRAIN_B} x {TRAIN_S} tokens: one rank, then two ranks of a "
            f"{SHARD_MESH} mesh on the card (gloo), each on its shards")
        ref = shard_train_reference(dev, work)
        log(f"phase 17b: {SHARD_SERVE_ARCH}, prefill of {SERVE_BATCH} x "
            f"{PROMPT} tokens and {SHARD_DECODES} greedy decode steps "
            f"(impl='kernel'): one rank, then the two ranks on their shards")
        ref_tokens = shard_serve_reference(dev)
        t0 = time.perf_counter()
        procs = shard_processes(work, dev.type)
        outs = shard_wait(procs, work)
        wall = time.perf_counter() - t0
        ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
                 for r in range(math.prod(SHARD_MESH))]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    log(f"  the ranks and the dry run: {wall!r} s of wall time")

    cfg = get_config(SHARD_TRAIN_ARCH)
    opt = shard_optimizer(cfg)
    shape = InputShape(f"train_{TRAIN_B}x{TRAIN_S}", TRAIN_S, TRAIN_B, "train")
    rules = build_rules(cfg, shape=shape)
    want_args = shard_bytes(cfg, opt, rules)
    whole = sum(t.numel() * t.element_size() for t in tree_leaves(
        (zoo.param_shapes(cfg), shard_state_shapes(cfg, opt))))
    train_rank_checks("17a", [out["train"] for out in ranks], ref,
                      outs["dry"], want_args, whole, "sharded", SHARD_MESH)
    counts = {}
    for r, out in enumerate(ranks):
        sv = out["serve"]
        lo, hi = sv["rows"]
        same = torch.equal(sv["tokens"], ref_tokens[lo:hi])
        launched = {k: v for k, v in sv["launches"].items() if v}
        log(f"  rank {r} 17b: rows {lo}:{hi}, tokens equal the one rank's: "
            f"{same}; {sv['s']!r} s; arguments {sv['arg_bytes']!r} B, "
            f"max_memory_allocated {sv['peak']!r} B; launches {launched}")
        if not same:
            raise AssertionError(f"17b rank {r}: tokens {sv['tokens']} "
                                 f"against {ref_tokens[lo:hi]}")
        if not sv["launches"].get("flash_attention"):
            raise AssertionError(f"17b rank {r}: no flash launch")
        for k, v in sv["launches"].items():
            counts[k] = counts.get(k, 0) + v
    log(f"  phase 17 launches: {counts}")
    log(f"    {nvidia_smi_line()}")
    return counts


# ---------------------------------------------------------------------------
# phase 18: tensor- and expert-parallel compute, two ranks on the one card
# ---------------------------------------------------------------------------

TP_MESH = (1, 2)                             # (data, model): two ranks
TP_SERVE_ARCHS = ("seamless-m4t-medium",     # tp_fsdp: flash on 8 heads
                  "rwkv6-1.6b")              # tp_fsdp: WKV on 16 heads
TP_TRAIN_ARCH = "granite-moe-1b-a400m"       # ep_fsdp: 16 of 32 experts
TP_KERNELS = {"seamless-m4t-medium": "flash_attention",
              "rwkv6-1.6b": "rwkv6_wkv"}
# 18d: seamless-m4t-medium with its config's seq_shard flipped: 18a runs
# the full config's (True: the prefill's residual stream the rank's slice
# of the sequence, reduce-scattered and all-gathered), 18d the other form
TP_SEQ_ARCH = "seamless-m4t-medium"
# 18e-18f: the two families whose layers need the model axis, served at
# full width under ep_tp_fsdp with their full configs' seq_shard (True):
# (tag, arch, config overrides, why). A rank holds half of the heads, KV
# heads, ff, vocabulary and experts and of jamba's Mamba dinner channels;
# MLA's latent projections (w_dkv, w_kr), its norm and its cache (c_kv,
# k_rope) stay whole. No hand kernel runs on either: MLA's keys and
# values differ in width (the flash gate refuses them, fault 15),
# self-attention never reaches flash (fault 5) and the Mamba mixer runs
# the reference's chunked scan
TP_SPLIT_SERVE = (
    ("18e", "jamba-1.5-large-398b",
     {a: o for a, o, _ in FAMILY_MODELS}["jamba-1.5-large-398b"],
     "phase 14's cut: layer 0 Mamba + MoE, layer 1 attention + dense"),
    ("18f", "deepseek-v2-lite-16b", {"recipe": "ep_tp_fsdp"},
     "the config's ep_fsdp leaves MLA whole; ep_tp_fsdp splits its heads "
     "and the shared experts' ff"),
)
# 18g: deepseek's MLA and expert splits trained, one AdamW step at phase
# 21's cut (layer 0 dense, 3 MoE): its 27 layers need ~194 GB of AdamW
# state. (tag, arch, config overrides, the dry run's step layout): the
# full config's seq_shard (True), named so that a smoke config takes the
# same form, so the record must say "sharded_tp_seq"
TP_SPLIT_TRAIN = ("18g", "deepseek-v2-lite-16b",
                  {"n_layers": 4, "recipe": "ep_tp_fsdp", "seq_shard": True},
                  "sharded_tp_seq")
# the cache leaves a rank of each phase-18 model holds half of, by name
# (the others whole): what the act rules' split (act_split) is held to
TP_CACHE_SPLIT = {"seamless-m4t-medium": ["k", "v"],
                  "rwkv6-1.6b": ["wkv"],
                  "jamba-1.5-large-398b": ["conv", "h", "k", "v"],
                  "deepseek-v2-lite-16b": []}
# the fp32 twins of 18e-18f: the models' smoke configs under the same
# recipe with fp32 caches, in both seq_shard forms: tokens bitwise the one
# rank's, expert ids equal but at a MOE_NEAR_TIE near tie
TP_TWIN_ARCHS = ("jamba-1.5-large-398b", "deepseek-v2-lite-16b")
TP_TWIN = {"recipe": "ep_tp_fsdp", "kv_cache_dtype": "float32"}


class LinkBytes:
    """The bytes each rank sends into its collectives while entered, by
    collective: an all-reduce's and a reduce-scatter's input, an
    all-gather's input (the rank's part)."""

    CALLS = ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor")

    def __enter__(self):
        import torch.distributed as tdist
        self.bytes = {k: 0 for k in self.CALLS}
        self.calls = {k: 0 for k in self.CALLS}
        self._real = {k: getattr(tdist, k) for k in self.CALLS}

        def logged(name, fn, arg):
            def call(*a, **k):
                t = a[arg]
                self.bytes[name] += t.numel() * t.element_size()
                self.calls[name] += 1
                return fn(*a, **k)
            return call
        for k, fn in self._real.items():
            setattr(tdist, k, logged(k, fn, 0 if k == "all_reduce" else 1))
        return self

    def __exit__(self, *exc):
        import torch.distributed as tdist
        for k, fn in self._real.items():
            setattr(tdist, k, fn)


class HeadLog:
    """The head counts the path's flash and WKV calls ran at: while
    entered, ``kernels.ops``' two dispatchers note their first argument's
    heads (q, r: (B, S, H, D)) and call through (the launch counts stay
    the wrappers')."""

    NAMES = ("flash_attention", "rwkv6_wkv")

    def __enter__(self):
        from repro_torch.kernels import ops
        self.heads = {k: set() for k in self.NAMES}
        self._real = {k: getattr(ops, k) for k in self.NAMES}
        for k, fn in self._real.items():
            setattr(ops, k, self._logged(k, fn))
        return self

    def _logged(self, name, fn):
        def call(*a, **k):
            self.heads[name].add(int(a[0].shape[2]))
            return fn(*a, **k)
        return call

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        for k, fn in self._real.items():
            setattr(ops, k, fn)


def tie_divergences(got, want, logits, what: str, downstream=None) -> list:
    """Each row of ``got`` (B, n tokens) held to ``want``, the one rank's,
    whose logits a step are ``logits`` (B, n, V): equal up to the row's
    first difference, where the rank's token's logit in the one rank's
    step must be within one bf16 ulp of that step's largest (a tie at
    the logits' resolution: the head's product is bf16, so rwkv6's and
    seamless's logits tie exactly or within an ulp at some steps, and an
    ulp of another summation order flips the argmax there), or, with
    ``downstream`` (each row's first token index downstream of a near-tie
    routing flip, ``routing_flips``; None: none), the row is downstream
    of such a flip there. After it the row decodes another history and
    is not held. Returns ``(row, step, gap)`` for each row that diverged
    at a tie (``(row, step, gap, "routing")`` downstream of a flip);
    raises for any other difference."""
    out = []
    for b in range(got.shape[0]):
        diff = (got[b] != want[b]).nonzero()
        if not len(diff):
            continue
        i = int(diff[0])
        step = logits[b, i]
        top = float(step.max())
        ulp = 2.0 ** (math.floor(math.log2(abs(top))) - 7) if top else 0.0
        gap = top - float(step[int(got[b, i])])
        if downstream is not None and downstream[b] is not None and \
                i >= downstream[b]:
            out.append((b, i, gap, "routing"))
            continue
        if not gap <= ulp:
            raise AssertionError(
                f"{what}: row {b} step {i}: token {int(got[b, i])} against "
                f"{int(want[b, i])}, {gap!r} under the one rank's largest "
                f"logit {top!r} (one bf16 ulp: {ulp!r}): not a tie")
        out.append((b, i, gap))
    return out


def keep_by_token(layer: dict, k: int):
    """A RoutingRecorder layer's keep mask by token: (tokens, k), each
    assignment's in the router's order (the dispatch keeps it sorted by
    expert)."""
    import torch
    keep = torch.empty_like(layer["keep"])
    keep[layer["order"]] = layer["keep"]
    return keep.reshape(-1, k)


def logit_moves(one, rank):
    """Each token's router log-probabilities' moves between two runs
    (``rank`` less ``one``, (tokens, experts); NaN where either
    probability is 0): a move common to every expert is the softmax's
    normalizer, so a pair of experts' logit gap moved by the difference
    of their moves."""
    import torch
    both = (one > 0) & (rank > 0)
    return torch.where(both, torch.log(rank) - torch.log(one), math.nan)


def move_range(moves):
    """The largest difference of two experts' moves, a token: how far
    the run moved any logit gap of that token."""
    import torch
    hi = torch.where(moves.isnan(), -math.inf, moves).amax(-1)
    lo = torch.where(moves.isnan(), math.inf, moves).amin(-1)
    return (hi - lo).clamp(min=0)


def routing_flips(want_layers, got_layers, got, want, k: int, what: str):
    """A bf16 run's MoE routing on the ranks (``got_layers``, tokens
    ``got``) against the one rank's (``want_layers``, ``want``), the
    RoutingRecorder calls in order: the prefill's MoE layers, then each
    decode step's. A row-parallel product's output is an fp32 sum of two
    partials where one rank makes one product, so the hidden state and
    with it the router's bf16 logits move by a rounding, which may swap
    two experts whose logits nearly tie. The bound is derived from the
    moves the run shows, in logits (log-probabilities: the softmax's
    normalizer cancels from a gap): a token's ids may first differ at a
    place where the one rank's logit gap of that expert and the next is
    within the largest move of any two of the token's other experts'
    gaps, or of any two experts' gaps on the layer's tokens whose ids
    agree and which no earlier difference reaches (the layer's bound).
    A difference at a prefill position reaches the later positions of
    its row at the later layers (causal mixers), and every later step of
    the row; where a difference reaches a token its ids may differ.
    A token whose ids agree may keep or drop an assignment otherwise
    than the one rank only in a call with a flip (capacity couples the
    tokens), and is then a difference too. Returns the flips ``(step,
    layer, row, position, logit gap, the token's bound, reached)`` (step
    0 the prefill), each row's first token index downstream of a flip
    (or None), the layer's bound and the flips by layer; raises for any
    other difference."""
    import torch
    B = got.shape[0]
    n = len(want_layers) // (1 + SHARD_DECODES)
    if len(got_layers) != len(want_layers) or \
            n * (1 + SHARD_DECODES) != len(want_layers):
        raise AssertionError(f"{what}: {len(got_layers)} MoE calls against "
                             f"the one rank's {len(want_layers)}")
    S = want_layers[0]["ids"].shape[0] // B          # prompt tokens a row
    dirty = torch.zeros((B, S), dtype=torch.bool)    # the prefill's reach
    row_dirty = torch.zeros(B, dtype=torch.bool)     # a decode step's
    downstream = [None] * B             # tokens from this index may part
    bound = [0.0] * n
    flips = []
    for j, (a, b) in enumerate(zip(want_layers, got_layers)):
        step, layer = divmod(j, n)
        if step:                        # the step's input: token step - 1
            row_dirty |= dirty.any(-1) | (got[:, step - 1]
                                          != want[:, step - 1])
            clean, row = ~row_dirty, torch.arange(B)
            pos = torch.full((B,), S + step - 1)
        else:
            clean = ~dirty.reshape(-1)
            row, pos = torch.arange(B * S) // S, torch.arange(B * S) % S
        differ = (a["ids"] != b["ids"]).any(-1)
        moved = (keep_by_token(a, k) != keep_by_token(b, k)).any(-1) & ~differ
        moves = logit_moves(a["probs"], b["probs"])
        agree = ~differ & clean
        if agree.any():
            bound[layer] = max(bound[layer],
                               float(move_range(moves[agree]).max()))
        if moved.any() and not differ.any():
            raise AssertionError(f"{what}: step {step} layer {layer}: keep "
                                 "masks differ where no expert id does")
        srt, idx = torch.sort(a["probs"], dim=-1, descending=True,
                              stable=True)
        for i in differ.nonzero().reshape(-1).tolist():
            place = int((a["ids"][i] != b["ids"][i]).nonzero()[0])
            pair = idx[i, place:place + 2]
            gap = float(torch.log(srt[i, place]) - torch.log(srt[i, place + 1]))
            others = moves[i].clone()
            others[pair] = math.nan
            own = float(move_range(others))
            flips.append((step, layer, int(row[i]), int(pos[i]), gap, own,
                          not bool(clean[i])))
        for i in (differ | moved).nonzero().reshape(-1).tolist():
            r = int(row[i])
            if step:
                row_dirty[r] = True
            else:
                dirty[r, int(pos[i]):] = True
            if downstream[r] is None:
                downstream[r] = step
    by_layer = [0] * n
    for step, layer, r, p, gap, own, reached in flips:
        by_layer[layer] += 1
        if not reached and not gap <= max(own, bound[layer]):
            raise AssertionError(
                f"{what}: step {step} layer {layer} row {r} position {p}: "
                f"expert ids differ at a logit gap of {gap!r}, over the "
                f"token's other moves {own!r} and the layer's bound "
                f"{bound[layer]!r}")
    return flips, downstream, bound, by_layer


def tp_serve_reference(dev, cfg) -> dict:
    """A phase-18 serving case on one rank: ``cfg``'s seed-0 weights,
    prefill of the SERVE_BATCH prompts and SHARD_DECODES greedy steps:
    tokens and each step's logits on the host, the cache leaves, the MoE
    routing (``RoutingRecorder``, probabilities too), the seconds, the
    draw's and the serving's peaks, the launch counts."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import model_zoo as zoo
    from repro_torch.serve.engine import wave_inputs

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    params = zoo.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    draw_peak = torch.cuda.max_memory_allocated(dev)
    batch = wave_inputs(cfg, serve_prompts(cfg), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad(), RoutingRecorder() as rec:
        tokens, cache, logits = greedy_tokens(params, cfg, batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    del params, batch
    free_card()
    return {"tokens": tokens, "cache": cache, "logits": logits,
            "routing": rec.layers, "s": secs, "draw_peak": draw_peak,
            "peak": peak, "launches": ops.launch_counts()}


def tp_serve_rank(dev, cfg) -> dict:
    """A phase-18 serving case on one rank: this rank's shards of
    ``cfg``'s seed-0 weights (``draw_local``: its heads, ``ff`` and vocab
    under ``tp_fsdp``; its experts too under ``ep_*``, and Mamba's
    ``dinner`` channels under ``ep_tp_fsdp``); prefill and SHARD_DECODES
    greedy steps on every prompt (the data axis is 1), the layers
    computing on the rank's slice with their reductions over ``model``
    (where the config sets ``seq_shard``, the prefill's residual stream
    the rank's slice of the sequence, its output products
    reduce-scattered). The launch counts from 0 just before; the heads
    each kernel ran at; the bytes the rank sent into each collective;
    the MoE routing; each param's shape; each step's logits; the draw's
    and the serving's peaks."""
    import torch
    from repro_torch import dist
    from repro_torch._tree import tree_flatten_with_path
    from repro_torch.dist import fsdp
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.serve.engine import wave_inputs

    with mesh_context(cfg, *TP_MESH, device=dev.type) as mesh:
        rules = dist.current_rules()
        params, _, draw_peak, draw_s = draw_local(cfg, mesh, rules, dev)
        batch = wave_inputs(cfg, serve_prompts(cfg), dev)
        arg_bytes = dryrun.argument_bytes(params)
        shapes = {path: tuple(t.shape)
                  for path, t in tree_flatten_with_path(params)[0]}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad(), fsdp.sharded(mesh, rules, ("data",)), \
                HeadLog() as heads, LinkBytes() as link, \
                RoutingRecorder() as rec:
            tokens, cache, logits = greedy_tokens(params, cfg, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
    return {"tokens": tokens, "cache": cache, "logits": logits,
            "routing": rec.layers, "launches": counts,
            "heads": {k: sorted(v) for k, v in heads.heads.items()},
            "s": secs, "arg_bytes": arg_bytes, "shapes": shapes,
            "draw_peak": draw_peak, "draw_s": draw_s,
            "peak": torch.cuda.max_memory_allocated(dev),
            "link_bytes": link.bytes, "link_calls": link.calls,
            "seq_shard": cfg.seq_shard}


def tp_split_cases() -> list:
    """18e-18f and their fp32 twins, ``(tag, arch, config)``."""
    from repro_torch.configs import get_config
    out = [(tag, arch, get_config(arch).with_overrides(**o))
           for tag, arch, o, _ in TP_SPLIT_SERVE]
    for arch in TP_TWIN_ARCHS:
        for seq in (False, True):
            out.append((f"twin {arch} seq_shard={seq}", arch,
                        get_config(arch, smoke=True).with_overrides(
                            seq_shard=seq, **TP_TWIN)))
    return out


def tp_rank(rank: int, store: str, work: str, device: str) -> None:
    """One of phase 18's two ranks: a process of its own on the one card,
    joined with the other through a ``file://`` store with gloo. 18a,
    18b, 18d, 18c, 18e, 18f and the fp32 twins, then 18g; what it holds
    goes to ``work/rank<rank>.pt``."""
    import datetime
    import torch
    import torch.distributed as tdist
    from repro_torch.configs import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tdist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank,
        world_size=math.prod(TP_MESH),
        timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    try:
        dev = torch.device(device)
        work = pathlib.Path(work)
        out = {}
        for arch in TP_SERVE_ARCHS:
            out[arch] = tp_serve_rank(dev, get_config(arch))
            free_card()
        cfg = get_config(TP_SEQ_ARCH)
        out["seq"] = tp_serve_rank(dev, cfg.with_overrides(
            seq_shard=not cfg.seq_shard))
        free_card()
        out["train"] = shard_train_rank(dev, work, TP_TRAIN_ARCH, TP_MESH,
                                        "18c")
        free_card()
        for tag, _, cfg in tp_split_cases():
            out[tag] = tp_serve_rank(dev, cfg)
            free_card()
        tag, arch, overrides, _ = TP_SPLIT_TRAIN
        out[tag] = shard_train_rank(dev, work, arch, TP_MESH, tag, overrides)
        torch.save(out, work / f"rank{rank}.pt")
    finally:
        tdist.destroy_process_group()


def tp_kernel_checks(dev, g, record) -> None:
    """Phase 18's kernels at a model rank's shapes against their plain
    versions, graph-timed (rows of their own, logged): flash at
    seamless-m4t-medium's cross-attention on 8 of its 16 heads (B
    SERVE_BATCH, T PROMPT; S PROMPT and 1), WKV at rwkv6-1.6b's prefill
    and decode on 16 of its 32 heads (bf16, model layout)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_wkv as wkv

    bf16_eps = float(torch.finfo(torch.bfloat16).eps)
    m = TP_MESH[1]
    B, D, H = SERVE_BATCH, 64, 16 // m
    for tag, S in (("", PROMPT), ("_decode", 1)):
        row = f"flash_attention/tp{H}{tag}"
        q, k, v = flash_inputs(g, dev, torch.bfloat16, B, S, PROMPT, H, H, D)
        got = fa.flash_attention(q, k, v, causal=False)
        want = fa.flash_attention_plain(q, k, v, causal=False)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{row}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        tol = bf16_eps * float(want.float().abs().max())
        sets = [(q, k, v)] + [
            flash_inputs(g, dev, torch.bfloat16, B, S, PROMPT, H, H, D)
            for _ in range(n_sets((q, k, v)) - 1)]
        reps = 50 if S == 1 else 20
        (lib_ms, backend), notes = sdpa_library_ms(sets, False, reps, want)
        log(f"  {row}: B={B} S={S} T={PROMPT} H={H} D={D}; library: "
            f"{' | '.join(notes)}")
        pairs = attended_pairs(S, PROMPT, False)
        mm = 4 * B * H * pairs * D
        record("flash_attention",
               "src/repro_torch/kernels/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention.py:77", err, tol,
               graph_ms(cycling(lambda *t: fa.flash_attention(
                   *t, causal=False), sets), reps),
               median_ms(lambda: fa.flash_attention_plain(
                   q, k, v, causal=False), 5),
               2 * (2 * B * S * H * D + 2 * B * PROMPT * H * D),
               5 * B * H * pairs, tensor_ops=mm, library_ms=lib_ms,
               library=backend, row=row)
        del q, k, v, got, want, sets
    H = WKV_H // m
    for tag, S in (("", PROMPT), ("_decode", 1)):
        row = f"rwkv6_wkv/tp{H}{tag}"
        args = wkv_inputs(g, dev, B, S, WKV_HS, torch.bfloat16, H=H)
        o, h = ops.rwkv6_wkv(*args, chunk=WKV_CHUNK)
        po, ph = wkv.rwkv6_wkv_plain(*args, chunk=WKV_CHUNK)
        if o.shape != po.shape or not (torch.isfinite(o.float()).all()
                                       and torch.isfinite(h).all()):
            raise AssertionError(f"{row}: misshapen or non-finite")
        htol = 1e-4 * float(ph.abs().max())
        herr = float((h - ph).abs().max())
        log(f"  {row}: B={B} S={S} H={H} hs={WKV_HS}; h_last max_abs_err="
            f"{herr!r} tol={htol!r}")
        if not herr <= htol:
            raise AssertionError(f"{row}: h_last disagrees")
        err = float((o.float() - po.float()).abs().max())
        tol = bf16_eps * float(po.float().abs().max()) + htol
        nbytes, fops, tops = wkv_work(B, S, WKV_HS, WKV_CHUNK, 2, H=H)
        record("rwkv6_wkv", "src/repro_torch/kernels/csrc/rwkv6_wkv.cu",
               "src/repro/kernels/rwkv6_wkv.py:71", err, tol,
               graph_ms(lambda: ops.rwkv6_wkv(*args, chunk=WKV_CHUNK),
                        50 if S == 1 else 20),
               median_ms(lambda: wkv.rwkv6_wkv_plain(*args, chunk=WKV_CHUNK),
                         1),
               nbytes, fops, tensor_ops=tops, row=row)
        del args, o, h, po, ph
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def act_split(cfg, cache: dict) -> dict:
    """Each of one rank's cache leaves (``greedy_tokens``' ``(shape,
    axes, bytes)`` by path) as a rank of the (1, 2) mesh holds it by the
    act rules of ``cfg``'s recipe: ``path -> (bytes, split)`` (K and V
    split by KV heads, the WKV state by heads, Mamba's conv and SSM
    states by ``dinner``; MLA's latent, the lengths and the memory
    whole)."""
    from repro_torch.dist.sharding import build_rules
    act = build_rules(cfg)["act"]
    out = {}
    for path, (shape, axes, nbytes) in cache.items():
        local = rule_shape(shape, axes, act, TP_MESH)
        n = math.prod(shape)
        out[path] = (nbytes // n * math.prod(local) if n else nbytes,
                     local != shape)
    return out


def split_cache_check(what: str, arch: str, cfg, got: dict,
                      want: dict) -> tuple:
    """A rank's cache leaves against the one rank's (``greedy_tokens``'
    ``(shape, axes, bytes)`` by path): each leaf's bytes ``act_split``'s,
    the split leaves those ``TP_CACHE_SPLIT`` names for ``arch``, and
    together exactly 1/m of the one rank's bytes of them. Returns the
    bytes of the split leaves on the rank and on the one rank, and the
    names of the split and of the whole leaves."""
    import re
    if set(got) != set(want):
        raise AssertionError(f"{what}: cache leaves {sorted(got)} against "
                             f"the one rank's {sorted(want)}")
    mine = ones = 0
    split, whole = set(), set()
    for path, (expect, cut) in act_split(cfg, want).items():
        if got[path][2] != expect:
            raise AssertionError(f"{what}: cache leaf {path}: {got[path][2]} "
                                 f"B, not the act rules' {expect} B of the "
                                 f"one rank's {want[path][2]}")
        name = re.findall(r"\w+", path)[-1]
        if cut:
            mine, ones = mine + expect, ones + want[path][2]
            split.add(name)
        else:
            whole.add(name)
    if sorted(split) != TP_CACHE_SPLIT[arch] or TP_MESH[1] * mine != ones:
        raise AssertionError(f"{what}: cache leaves split {sorted(split)} "
                             f"({mine} B of the one rank's {ones} B), not "
                             f"{TP_CACHE_SPLIT[arch]} halved")
    return mine, ones, sorted(split), sorted(whole - split)


def rank_shapes_check(what: str, cfg, shapes: dict) -> int:
    """A rank's param shapes (by path) those the param rules of ``cfg``'s
    recipe give on the (1, 2) mesh. Returns the leaves split."""
    from repro_torch._tree import tree_flatten, tree_flatten_with_path
    from repro_torch.dist.api import is_axes
    from repro_torch.dist.sharding import build_rules
    from repro_torch.models import model_zoo as zoo
    table = build_rules(cfg)["param"]
    want = {path: rule_shape(t.shape, ax, table, TP_MESH)
            for (path, t), ax in zip(
                tree_flatten_with_path(zoo.param_shapes(cfg))[0],
                tree_flatten(zoo.param_axes(cfg), is_leaf=is_axes)[0])}
    bad = [k for k in want if shapes.get(k) != want[k]]
    if bad or set(shapes) != set(want):
        raise AssertionError(f"{what}: param shapes not the rules': "
                             f"{[(k, shapes.get(k), want[k]) for k in bad]}")
    return sum(want[k] != tuple(t.shape) for k, t in tree_flatten_with_path(
        zoo.param_shapes(cfg))[0])


def seq_collectives_check(what: str, run: dict) -> None:
    """A run reduce-scatters over ``model`` exactly where its config sets
    ``seq_shard``."""
    if bool(run["link_calls"]["reduce_scatter_tensor"]) != run["seq_shard"]:
        raise AssertionError(f"{what}: {run['link_calls']} collectives with "
                             f"seq_shard={run['seq_shard']}")


def tp_phase(dev) -> dict:
    """Phase 18: tensor- and expert-parallel compute (``dist/tp.py``) on
    two ranks of a (1, 2) mesh on the one card, held to one rank: 18a
    seamless-m4t-medium and 18b rwkv6-1.6b served under ``tp_fsdp``
    (flash on 8 heads, WKV on 16 a rank; tokens, split cache bytes half),
    18c granite-moe-1b-a400m's AdamW step under ``ep_fsdp`` (16 of 32
    experts a rank) and its dry run on a (1, 2) fake world, 18d 18a in
    the other ``seq_shard`` form; 18e jamba-1.5-large-398b (2 layers)
    and 18f deepseek-v2-lite-16b (27) served under ``ep_tp_fsdp`` in
    bf16 (Mamba's ``dinner``, MLA's heads, the experts split; routing
    flips only at near ties), their fp32 twins at smoke size in both
    ``seq_shard`` forms (tokens bitwise), and 18g deepseek's AdamW step
    at 4 layers under ``ep_tp_fsdp`` with its dry run. Returns the
    launch counts of the ranks' serving paths."""
    import shutil
    import tempfile
    import torch
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.dist.sharding import build_rules
    from repro_torch.models import model_zoo as zoo

    cases = tp_split_cases()
    g_tag, g_arch, g_over, g_layout = TP_SPLIT_TRAIN
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_phase18_"))
    procs = {}
    try:
        # the dry runs trace on the host while this process runs the one
        # rank's references on the card, not beside the ranks, whose
        # collectives all cross the host
        procs = shard_processes(work, dev.type,
                                (("dry", TP_TRAIN_ARCH, {}),
                                 (f"dry{g_tag}", g_arch, g_over)),
                                TP_MESH, None)
        refs = {}
        for tag, arch in zip(("18a", "18b"), TP_SERVE_ARCHS):
            log(f"phase {tag}: {arch} (tp_fsdp), prefill of {SERVE_BATCH} x "
                f"{PROMPT} tokens and {SHARD_DECODES} greedy decode steps "
                f"(impl='kernel'): one rank, then two ranks of a {TP_MESH} "
                "mesh on the card (gloo), each on its heads")
            cfg = get_config(arch)
            refs[arch] = tp_serve_reference(dev, cfg)
            split = sum(refs[arch]["cache"][k][2] for k, (_, cut) in
                        act_split(cfg, refs[arch]["cache"]).items() if cut)
            log(f"  {tag} one rank: {refs[arch]['s']!r} s; split cache "
                f"leaves {split!r} B")
        log(f"phase 18d: {TP_SEQ_ARCH} (tp_fsdp) as 18a with its config's "
            "seq_shard flipped (where set, the ranks' prefill keeps the "
            "residual stream as its slice of the sequence: reduce-scatter, "
            "all-gather); held to 18a's one rank")
        log(f"phase 18c: {TP_TRAIN_ARCH} (ep_fsdp) at full width, one AdamW "
            f"step of {TRAIN_B} x {TRAIN_S} tokens: one rank, then the two "
            "ranks, each on its experts")
        ref = shard_train_reference(dev, work, TP_TRAIN_ARCH, "18c")
        whys = {tag: (arch, why) for tag, arch, _, why in TP_SPLIT_SERVE}
        for tag, _, cfg in cases:
            if tag in whys:
                log(f"phase {tag}: {whys[tag][0]} ({cfg.recipe}, "
                    f"seq_shard={cfg.seq_shard}, {cfg.n_layers} layers: "
                    f"{whys[tag][1]}), {cfg.param_dtype} at d_model "
                    f"{cfg.d_model}, prefill of {SERVE_BATCH} x {PROMPT} "
                    f"tokens and {SHARD_DECODES} greedy decode steps "
                    "(impl='kernel'): one rank, then the two ranks, each on "
                    "its slice")
            else:
                log(f"phase 18 {tag}: the smoke config, {cfg.param_dtype} "
                    f"(caches {cfg.kv_cache_dtype}), {cfg.recipe}: one rank, "
                    "then the two ranks")
            refs[tag] = tp_serve_reference(dev, cfg)
            rf = refs[tag]
            log(f"  {tag} one rank: {rf['s']!r} s (routing recorded); draw "
                f"max_memory_allocated {rf['draw_peak']!r} B, serving "
                f"{rf['peak']!r} B")
        log(f"phase {g_tag}: {g_arch} ({g_over}) at full width, one AdamW "
            f"step of {TRAIN_B} x {TRAIN_S} tokens: one rank, then the two "
            "ranks, each on its heads, experts and ff")
        ref_g = shard_train_reference(dev, work, g_arch, g_tag, g_over)
        t0 = time.perf_counter()
        procs.update(shard_processes(work, dev.type, (), TP_MESH, "tp_rank"))
        outs = shard_wait(procs, work, "18")
        wall = time.perf_counter() - t0
        ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
                 for r in range(math.prod(TP_MESH))]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    log(f"  the ranks: {wall!r} s of wall time")

    counts = {}
    m = TP_MESH[1]
    for tag, arch in zip(("18a", "18b"), TP_SERVE_ARCHS):
        cfg = get_config(arch)
        kernel = TP_KERNELS[arch]
        want_heads = [cfg.n_heads // m]
        for r, out in enumerate(ranks):
            sv, rf = out[arch], refs[arch]
            same = torch.equal(sv["tokens"], rf["tokens"])
            ties = tie_divergences(sv["tokens"], rf["tokens"], rf["logits"],
                                   f"{tag} rank {r}")
            mine, ones, halved, _ = split_cache_check(
                f"{tag} rank {r}", arch, cfg, sv["cache"], rf["cache"])
            launched = {k: v for k, v in sv["launches"].items() if v}
            log(f"  rank {r} {tag}: tokens equal the one rank's: {same}; "
                f"rows diverging at a bf16 tie of the one rank's logits "
                f"(row, step, gap): {ties}; "
                f"{sv['s']!r} s (one rank {rf['s']!r} s); split cache "
                f"leaves {halved} {mine!r} B (one rank {ones!r} B); heads a "
                f"call "
                f"{sv['heads']}; arguments {sv['arg_bytes']!r} B, "
                f"max_memory_allocated {sv['peak']!r} B (draw "
                f"{sv['draw_peak']!r} B); launches {launched}")
            if not sv["launches"].get(kernel):
                raise AssertionError(f"{tag} rank {r}: no {kernel} launch")
            if sv["heads"][kernel] != want_heads:
                raise AssertionError(f"{tag} rank {r}: {kernel} ran at "
                                     f"{sv['heads'][kernel]} heads, not "
                                     f"{want_heads}")
            for k, v in sv["launches"].items():
                counts[k] = counts.get(k, 0) + v

    # 18d: seamless with the other seq_shard form against the one rank
    # (seq_shard changes no one-rank computation) and 18a's collectives:
    # a run reduce-scatters over model exactly where its seq_shard is set
    rf = refs[TP_SEQ_ARCH]
    for r, out in enumerate(ranks):
        sv, twin = out["seq"], out[TP_SEQ_ARCH]
        same = torch.equal(sv["tokens"], rf["tokens"])
        ties = tie_divergences(sv["tokens"], rf["tokens"], rf["logits"],
                               f"18d rank {r}")
        launched = {k: v for k, v in sv["launches"].items() if v}
        log(f"  rank {r} 18d (seq_shard={sv['seq_shard']}; 18a "
            f"seq_shard={twin['seq_shard']}): tokens equal the one rank's: "
            f"{same}; rows diverging at a bf16 tie (row, step, gap): "
            f"{ties}; {sv['s']!r} s (18a {twin['s']!r} s); link bytes by "
            f"collective {sv['link_bytes']} in {sv['link_calls']} calls (18a "
            f"{twin['link_bytes']} in {twin['link_calls']}); "
            f"max_memory_allocated {sv['peak']!r} B (18a {twin['peak']!r} "
            f"B); launches {launched}")
        seq_collectives_check(f"18a rank {r}", twin)
        seq_collectives_check(f"18d rank {r}", sv)
        if sv["seq_shard"] == twin["seq_shard"]:
            raise AssertionError("18d did not flip 18a's seq_shard")
        if not sv["launches"].get(TP_KERNELS[TP_SEQ_ARCH]):
            raise AssertionError(f"18d rank {r}: no flash launch")
        for k, v in sv["launches"].items():
            counts[k] = counts.get(k, 0) + v

    cfg = get_config(TP_TRAIN_ARCH)
    opt = shard_optimizer(cfg)
    shape = InputShape(f"train_{TRAIN_B}x{TRAIN_S}", TRAIN_S, TRAIN_B, "train")
    rules = build_rules(cfg, shape=shape)
    whole = sum(t.numel() * t.element_size() for t in tree_leaves(
        (zoo.param_shapes(cfg), shard_state_shapes(cfg, opt))))
    train_rank_checks("18c", [out["train"] for out in ranks], ref,
                      outs["dry"], shard_bytes(cfg, opt, rules, TP_MESH),
                      whole, "sharded_tp", TP_MESH)

    # 18e-18f and the fp32 twins: the Mamba and MLA splits against one
    # rank; no hand kernel on these paths
    for tag, arch, cfg in cases:
        rf = refs[tag]
        if any(rf["launches"].values()):
            raise AssertionError(f"{tag} one rank: hand kernels launched "
                                 f"{rf['launches']}")
        for r, out in enumerate(ranks):
            sv, what = out[tag], f"{tag} rank {r}"
            split = rank_shapes_check(what, cfg, sv["shapes"])
            mine, ones, halved, kept = split_cache_check(
                what, arch, cfg, sv["cache"], rf["cache"])
            seq_collectives_check(what, sv)
            if cfg.mla is not None and not {"c_kv", "k_rope"} <= set(kept):
                raise AssertionError(f"{what}: MLA's latent cache not whole")
            if tag in whys:
                routed = tp_bf16_checks(what, cfg, sv, rf)
            else:
                same = torch.equal(sv["tokens"], rf["tokens"])
                parted = routing_parts(rf["routing"], sv["routing"], what)
                if not same:
                    raise AssertionError(f"{what}: tokens {sv['tokens']} "
                                         f"against {rf['tokens']}")
                routed = (f"tokens bitwise the one rank's: {same}; expert "
                          f"ids equal but at a near tie ({MOE_NEAR_TIE}), "
                          f"{len(sv['routing'])} MoE calls, parted at one: "
                          f"{parted}")
            log(f"  rank {r} {tag}: {routed}; params {split} leaves split "
                f"as the rules give; cache leaves split {halved} "
                f"({mine!r} B of the one rank's {ones!r} B), whole {kept}; "
                f"link bytes by collective {sv['link_bytes']} in "
                f"{sv['link_calls']} calls (seq_shard={sv['seq_shard']}); "
                f"{sv['s']!r} s (one rank {rf['s']!r} s); arguments "
                f"{sv['arg_bytes']!r} B; max_memory_allocated: draw "
                f"{sv['draw_peak']!r} B in {sv['draw_s']!r} s, serving "
                f"{sv['peak']!r} B; hand-kernel launches "
                f"{sum(sv['launches'].values())}")
            if any(sv["launches"].values()):
                raise AssertionError(f"{what}: hand kernels launched "
                                     f"{sv['launches']}")

    cfg = get_config(g_arch).with_overrides(**g_over)
    opt = shard_optimizer(cfg)
    rules = build_rules(cfg, shape=shape)
    whole = sum(t.numel() * t.element_size() for t in tree_leaves(
        (zoo.param_shapes(cfg), shard_state_shapes(cfg, opt))))
    train_rank_checks(g_tag, [out[g_tag] for out in ranks], ref_g,
                      outs[f"dry{g_tag}"], shard_bytes(cfg, opt, rules,
                                                       TP_MESH),
                      whole, g_layout, TP_MESH)
    log(f"  phase 18 launches: {counts}")
    log(f"    {nvidia_smi_line()}")
    return counts


def tp_bf16_checks(what: str, cfg, sv: dict, rf: dict) -> str:
    """18e's and 18f's checks of a rank's bf16 serving against the one
    rank's: routing flips only at near ties (``routing_flips``), tokens
    equal but at a logit tie or downstream of such a flip
    (``tie_divergences``), and each step's logits within LOGITS_RTOL of
    the one rank's largest that step on every row whose tokens agree up
    to the step (the prefill's: every row); it fails where a step holds
    no row. Returns the log's text."""
    import torch
    flips, down, bound, by_layer = routing_flips(
        rf["routing"], sv["routing"], sv["tokens"], rf["tokens"],
        cfg.moe.top_k, what)
    ties = tie_divergences(sv["tokens"], rf["tokens"], rf["logits"], what,
                           down)
    # step i's logits follow the prompt and tokens 0 .. i - 1
    same = (sv["tokens"] == rf["tokens"]).int().cumprod(1).bool()
    held = torch.cat([torch.ones_like(same[:, :1]), same[:, :-1]], 1)
    rows = held.sum(0).tolist()
    steps = []
    for i in range(held.shape[1]):
        got = sv["logits"][held[:, i], i].float()
        want = rf["logits"][held[:, i], i].float()
        scale = float(rf["logits"][:, i].float().abs().max())
        diff = float((got - want).abs().max()) if rows[i] else math.nan
        steps.append((diff, scale))
        if not diff <= LOGITS_RTOL * scale:
            raise AssertionError(f"{what}: step {i}: logits {diff!r} from "
                                 f"the one rank's on its {rows[i]} rows "
                                 f"whose tokens agree (max |logit| "
                                 f"{scale!r}, rtol {LOGITS_RTOL})")
    near = [(st, ly, r, pos, gap, own) for st, ly, r, pos, gap, own, d
            in flips if not d]
    return (f"tokens equal the one rank's: "
            f"{bool(torch.equal(sv['tokens'], rf['tokens']))}; rows parting "
            f"(row, step, the one rank's logit gap, 'routing' where "
            f"downstream of a near-tie flip): {ties}; "
            f"routing flips by layer {by_layer} "
            f"({sum(d for *_, d in flips)} reached by an earlier one), "
            f"near-tie flips (step, layer, row, position, the one rank's "
            f"logit gap, the token's other gaps' largest move) {near}, "
            f"bound by layer (the largest move of a logit gap on its "
            f"agreeing tokens no flip reaches) {bound}; rows downstream of "
            f"a flip from token {down}; logits held on {rows} rows a step "
            f"(tokens agreeing up to it), max |difference| and the one "
            f"rank's max |logit| a step {steps} (tol {LOGITS_RTOL})")


def train_rank_checks(tag, trains, ref, dry_out, want_args, whole,
                      layout, mesh_shape) -> None:
    """17a's and 18c's checks of each rank's step against the one-rank
    step (``ref``) and the dry run's record of the cell (the last line of
    ``dry_out``): loss and grad norm within SHARD_RTOL, no param past 2 x
    lr + 1 bf16 ulp, the arguments the rules' and the record's, less than
    the whole params and state held besides, the traced peak within
    DRYRUN_PEAK_TOL of ``max_memory_allocated``."""
    rec = json.loads(dry_out.strip().splitlines()[-1])
    if not rec.get("ok", True) or rec.get("step_layout") != layout:
        raise AssertionError(f"{tag}: the dry run's record: {rec}")
    log(f"  dry run of the {mesh_shape} cell: {dryrun_line(rec)}")
    traced = rec["memory"]["total_per_device"]
    for r, t in enumerate(trains):
        gap = (traced - t["peak"]) / t["peak"]
        log(f"  rank {r} {tag}: loss {t['loss']!r} grad_norm "
            f"{t['grad_norm']!r} (one rank {ref['loss']!r}, "
            f"{ref['grad_norm']!r}); step {t['ms']!r} ms; arguments "
            f"{t['arg_bytes']!r} B (the rules' {want_args!r}, the dry run's "
            f"{rec['memory']['argument_size_in_bytes']!r}); "
            f"draw max_memory_allocated {t['draw_peak']!r} B; step "
            f"max_memory_allocated {t['peak']!r} B, less the arguments "
            f"{t['peak'] - t['arg_bytes']!r} B (whole params and state "
            f"{whole!r} B); traced peak {traced!r} B, gap {gap!r} (tol "
            f"{DRYRUN_PEAK_TOL}); params over 2 x lr + 1 bf16 ulp: "
            f"{t['over']} of {t['checked']} (largest excess {t['excess']!r})")
        for k in ("loss", "grad_norm"):
            if abs(t[k] - ref[k]) > SHARD_RTOL * abs(ref[k]):
                raise AssertionError(f"{tag} rank {r}: {k} {t[k]} against "
                                     f"the one-rank {ref[k]}")
        if t["over"]:
            raise AssertionError(f"{tag} rank {r}: {t['over']} params moved "
                                 "past the one-rank step's by more than "
                                 "2 x lr + 1 bf16 ulp")
        if not t["arg_bytes"] == want_args == \
                rec["memory"]["argument_size_in_bytes"]:
            raise AssertionError(f"{tag} rank {r}: arguments are not the "
                                 "rank's shards")
        if not t["peak"] - t["arg_bytes"] < whole:
            raise AssertionError(f"{tag} rank {r}: the step held the whole "
                                 "params and state")
        if abs(gap) > DRYRUN_PEAK_TOL:
            raise AssertionError(f"{tag} rank {r}: traced peak {traced} "
                                 f"against the card's {t['peak']}")


# ---------------------------------------------------------------------------
# phase 21: a train step on the card for every model that fits one
# ---------------------------------------------------------------------------

# bytes a parameter a step holds before any activation: bf16 weights and
# the fp32 gradients the step accumulates; AdamW adds its fp32 master and
# two fp32 moments, Adafactor's factored moments are ~0
OPT_BYTES = {"adamw": 2 + 4 + 12, "adafactor": 2 + 4}
# every model no other phase trains on the card (qwen2-1.5b: 12a, 16b,
# 17a; rwkv6-1.6b: 12b; granite-moe-1b-a400m: 15b, 18c) and that fits
# one, at full width: (arch, config overrides, optimizer, why); a depth
# cut keeps every layer kind of the model
TRAIN_CARD_MODELS = (
    ("seamless-m4t-medium", {}, "adamw", None),
    ("qwen1.5-4b", {}, "adafactor",
     "AdamW with its fp32 master (71 GB with the gradients) leaves no room "
     "for the 2.5 GB fp32 logits"),
    ("nemotron-4-15b", {"n_layers": 8}, "adafactor",
     "32 layers are 94 GB even under Adafactor; every layer is the same "
     "dense block at full width"),
    ("mistral-large-123b", {"n_layers": 4}, "adafactor",
     "123B parameters do not fit one card; every layer is the same dense "
     "block at full width"),
    ("deepseek-v2-lite-16b", {"n_layers": 4}, "adamw",
     "at 27 layers the fp32 gradients alone are 64.6 GB; layer 0 dense "
     "and 3 MoE layers keep both kinds"),
    ("llama-3.2-vision-90b", {"n_layers": 5}, "adafactor",
     "phase 14's cut: 4 self-attention layers and the gated cross layer "
     "at index 4"),
)
# never trained on the card here, and why
NOT_ON_ONE_CARD = {
    "jamba-1.5-large-398b":
        "at phase 14's cut (2 layers, 11.91B parameters) the bf16 weights "
        "and fp32 gradients are 71.5 GB and Adafactor's update needs an "
        "fp32 temporary of one (16, 8192, 24576) expert stack, 12.0 GiB: "
        "78.6 GiB before any activation; every cut that keeps the MoE layer "
        "is this size",
}
TRAIN_CARD_STEPS = 3             # on one fixed TRAIN_B x TRAIN_S batch


def train_reckoning(cfg, opt_name: str) -> int:
    """The bytes a train step of ``cfg`` under ``opt_name`` holds before
    any activation: ``cfg.param_counts()`` times OPT_BYTES."""
    return cfg.param_counts()["total"] * OPT_BYTES[opt_name]


def train_card_configs():
    """``(config, optimizer, reduced)`` of phase 21's models: each at full
    width, its depth cut where ``reduced`` says how and why."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    out = []
    for arch, over, opt_name, why in TRAIN_CARD_MODELS:
        cfg = get_config(arch)
        cuts = {k: f"{getattr(cfg, k)} -> {v}" for k, v in over.items()}
        out.append((replace(cfg, **over), opt_name,
                    {**cuts, "why": why} if why else {}))
    return out


def train_card_optimizer(arch: str) -> str:
    """The optimizer of ``arch``'s phase-21 row, else AdamW (the
    configs' own)."""
    return next((o for a, _, o, _ in TRAIN_CARD_MODELS if a == arch),
                "adamw")


def optimizer_leaves(params, state) -> list:
    """The tensors a step moves, leaf for leaf: the optimizer's fp32
    master where it keeps one (AdamW), else the parameters."""
    from repro_torch._tree import tree_leaves
    return tree_leaves(state["master"] if isinstance(state, dict)
                       and "master" in state else params)


def unmoved_leaves(paths, grad, moved, held, states_moved) -> tuple:
    """``(failed, below_ulp)``: the leaves (by path) that had a gradient
    and did not move. A bf16 leaf the optimizer keeps no fp32 copy of
    cannot take an update below half its ulp (a norm's scale at 1.0 moves
    only by more than 2^-9 down, 2^-8 up; Adafactor's first step moves
    each element by the learning rate): such a leaf is ``below_ulp``
    where its optimizer state moved (the step reached it), else
    ``failed``; an fp32 one always fails."""
    import torch
    failed, below = [], []
    for p, g, mv, t in zip(paths, grad, moved, held):
        if not g or mv:
            continue
        ok = t.dtype != torch.float32 and states_moved(p)
        (below if ok else failed).append(p)
    return failed, below


def train_card(dev, cfg, opt_name: str, reduced: dict) -> dict:
    """TRAIN_CARD_STEPS steps of ``cfg`` (seed-0 weights drawn on the card,
    the config's remat and microbatches) under ``opt_name`` on one fixed
    TRAIN_B x TRAIN_S batch (seeded tokens, and frames or patches):
    losses finite and the third below the first, grad norms finite and
    above 0, every parameter finite and on the card, every leaf that had
    a gradient at a step moved (:func:`optimizer_leaves`, held against a
    copy on the host). Logs ms a step (the median after the first),
    tok/s, MFU from the active parameters, ``max_memory_allocated``
    beside :func:`train_reckoning`, and the weight draw's peak."""
    import numpy as np
    import torch
    from repro_torch._tree import (tree_flatten, tree_flatten_with_path,
                                   tree_leaves)
    from repro_torch.models import model_zoo as zoo
    from repro_torch.train.optim import (Optimizer, cosine_schedule,
                                         make_optimizer)
    from repro_torch.train.train_step import make_train_step

    arch = cfg.name
    free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = zoo.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    draw_peak = torch.cuda.max_memory_allocated(dev)
    counts = cfg.param_counts()
    reckoned = train_reckoning(cfg, opt_name)
    log(f"phase 21: {arch} ({cfg.family}, {counts['total']} parameters, "
        f"{counts['active']} active, {cfg.n_layers} layers, remat="
        f"{cfg.remat} microbatches={cfg.microbatches}, {opt_name}), weights "
        f"drawn in {draw_s:.2f} s, {draw_peak / 2 ** 30!r} GiB at the draw's "
        f"peak" + (f"; reduced: {reduced}" if reduced else ""))
    batch = train_batch(cfg, TRAIN_B, TRAIN_S, np.random.default_rng(21),
                        dev)
    # phase 12's peak, warm-up 0 (step 1 trains), a cosine over the steps.
    # At phase 15b's 3e-3 Adafactor fits qwen1.5-4b's batch in one step
    # (12.43 -> 0.013), and the next update, whose RMS Adafactor holds at
    # 1 however small the gradient, throws the loss to 15.49
    sched = cosine_schedule(TRAIN_LR, 0, TRAIN_CARD_STEPS)
    lrs = [float(sched(i)) for i in range(TRAIN_CARD_STEPS)]
    if not lrs[0] > 0:
        raise AssertionError(f"{arch}: the learning rate is 0 at step 1")
    inner = make_optimizer(cfg, opt_name, lr=sched)
    had_grad = []

    def update(grads, state, params, step):
        nz = torch.stack([torch.count_nonzero(g) > 0
                          for g in tree_flatten(grads)[0]])
        had_grad.append(nz)
        return inner.update(grads, state, params, step)
    opt = Optimizer(inner.init, update, inner.state_axes)
    state = opt.init(params)
    before = [t.to("cpu", copy=True)
              for t in optimizer_leaves(params, state)]
    # the state of an optimizer with no fp32 copy: what a bf16 leaf that
    # cannot move is held to (AdamW's master moves every leaf)
    state_before = {} if "master" in state else {
        sp: t.to("cpu", copy=True)
        for sp, t in tree_flatten_with_path(state)[0]}
    step_fn = make_train_step(cfg, opt)
    step = torch.zeros((), dtype=torch.int32, device=dev)
    losses, gnorms, step_s = [], [], []
    for _ in range(TRAIN_CARD_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, step, m = step_fn(params, state, step, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated(dev)
    leaves = [t for t in tree_leaves((params, state))
              if isinstance(t, torch.Tensor)]
    if not all(t.device.type == dev.type for t in leaves) or not all(
            bool(torch.isfinite(t).all()) for t in tree_leaves(params)
            if t.is_floating_point()):
        raise AssertionError(f"{arch}: a parameter is off the card or not "
                             "finite")
    grad = torch.stack(had_grad).any(0).tolist()
    held = optimizer_leaves(params, state)
    moved = [not torch.equal(b, a.to("cpu")) for b, a in zip(before, held)]
    paths = [p for p, _ in tree_flatten_with_path(params)[0]]
    state_after = dict(tree_flatten_with_path(state)[0])
    still, below_ulp = unmoved_leaves(
        paths, grad, moved, held, lambda p: any(
            not torch.equal(t, state_after[sp].to("cpu"))
            for sp, t in state_before.items() if p in sp))
    no_grad = [p for p, g in zip(paths, grad) if not g]
    steady = statistics.median(step_s[1:])
    tokens = TRAIN_B * TRAIN_S
    out = {"n_layers": cfg.n_layers, "optimizer": opt_name,
           "median_ms": steady * 1e3, "tok_per_s": tokens / steady,
           "mfu": 6.0 * counts["active"] * tokens / (steady
                                                     * BF16_DENSE_PEAK),
           "peak_bytes": peak, "reckoned_bytes": reckoned,
           "draw_peak_bytes": draw_peak}
    log(f"    losses={losses!r} grad_norms={gnorms!r} lr={lrs!r}")
    log(f"    step_ms={[t * 1e3 for t in step_s]!r} median_ms="
        f"{out['median_ms']!r} tok_per_s={out['tok_per_s']!r} "
        f"mfu={out['mfu']!r}")
    log(f"    max_memory_allocated {peak / 2 ** 30!r} GiB ({peak} B) against "
        f"the reckoning's {reckoned / 2 ** 30!r} GiB ({reckoned} B, "
        f"{OPT_BYTES[opt_name]} B a parameter) before activations; "
        f"{sum(moved)} of {len(moved)} leaves moved; below half a bf16 ulp "
        f"(no fp32 copy; their optimizer state moved): {below_ulp}; no "
        f"gradient at any step: {no_grad}")
    log(f"    {nvidia_smi_line()}")
    bad = [i for i, (l, g) in enumerate(zip(losses, gnorms))
           if not (math.isfinite(l) and math.isfinite(g) and g > 0)]
    if bad:
        raise AssertionError(f"{arch}: non-finite loss or grad norm <= 0 at "
                             f"steps {bad}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{arch}: the loss did not fall: {losses}")
    if still:
        raise AssertionError(f"{arch}: leaves with a gradient did not move: "
                             f"{still}")
    del params, state, m, opt, inner, step_fn, batch, before, leaves, held
    del state_before, state_after
    free_card()
    return out


def card_training_phase(dev) -> dict:
    """Phase 21: :func:`train_card` for each of TRAIN_CARD_MODELS, then
    (21b) :func:`card_vs_cpu_check` for every entry of ``ARCH_IDS`` at its
    smoke config under :func:`train_card_optimizer`. The launch counts
    from 0 around it: training takes the chunked paths (the CUDA routes
    refuse tensors that require grad), so every count stays 0. Returns
    them."""
    import torch
    from repro_torch.configs import ARCH_IDS
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    rows = {}
    for cfg, opt_name, reduced in train_card_configs():
        t0 = time.perf_counter()
        rows[cfg.name] = train_card(dev, cfg, opt_name, reduced)
        log(f"    {cfg.name}: {time.perf_counter() - t0:.1f} s")
    log(f"phase 21: not trained on one card: {NOT_ON_ONE_CARD}")
    log(f"phase 21b: the card against the CPU, every model's smoke config "
        f"({CPU_STEPS} steps)")
    for arch in ARCH_IDS:
        card_vs_cpu_check(dev, arch, train_card_optimizer(arch))
    counts = ops.launch_counts()
    log(f"  phase 21 launches: {counts}")
    if any(counts.values()):
        raise AssertionError("training launched a hand kernel")
    log(f"  card training: {json.dumps(rows)}")
    torch.cuda.empty_cache()
    return counts


def free_card() -> None:
    """Collect garbage, then return the cache's free blocks to the card.
    A reference cycle can hold a model's tensors until the collector
    runs (``torch.utils.checkpoint`` and a first import inside a call
    leave cycles that reach the caller's frames), so a phase collects
    before it draws the next model's weights."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def since(t0: float) -> None:
    """The seconds since ``t0`` and the card's memory held (allocated,
    then after a garbage collection, and reserved)."""
    import gc
    import torch
    held = torch.cuda.memory_allocated() / 2 ** 30
    gc.collect()
    log(f"  [{time.perf_counter() - t0:.1f} s since the start; {held:.2f} "
        f"GiB allocated, {torch.cuda.memory_allocated() / 2 ** 30:.2f} after "
        f"a collection, {torch.cuda.memory_reserved() / 2 ** 30:.2f} "
        f"reserved]")


def check_no_nan(states, what: str):
    import torch
    from repro_torch._tree import tree_leaves
    for leaf in tree_leaves(states):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            if torch.isnan(leaf).any():
                raise AssertionError(f"{what}: a NaN in the op states")


# ---------------------------------------------------------------------------
# --measure and --compare: the main paths' rates, one tree or two in turns
# ---------------------------------------------------------------------------

def measure(dev) -> dict:
    """The main paths of phases 3, 4, 6-7 and 8, timed as the full run
    times them, with no kernel check before them: their rates."""
    import torch
    from repro_torch.kernels import ops
    ops.build_all()
    out = {}
    batches = dense_batches(N_BATCHES, N_EVENTS, DIM)
    run_dense(batches[:2], "int8_ef", 0.1, "cuda")
    for codec, budget in DENSE_CODECS:
        _, m, secs = run_dense(batches, codec, budget, "cuda")
        out[f"dense_events_per_s/{codec}"] = m.events / secs
    del batches
    _, m, secs = run_hashed()
    out["hashed_events_per_s"] = m.events / secs
    torch.cuda.empty_cache()
    out.update(serving_phases(dev)[1])
    # each shard's stream draws its vocabulary permutation (2^24 ids) at
    # its first batch; the full run's checks draw them before the path
    first_token_batch()
    out.update(summarization_phase(dev)[1])
    return out


def compare(other: pathlib.Path, runs: int, mode=None) -> int:
    """``--measure`` (with ``mode``, ``--measure --wkv``, ``--codec``,
    ``--mamba`` or ``--scans``) for ``other``'s port and this checkout's in turns, each
    run a process of its own."""
    trees = {"other": other.resolve() / "src", "this": SRC}
    order = []
    for i in range(runs):
        order += ["other", "this"] if i % 2 == 0 else ["this", "other"]
    results = {"other": [], "this": []}
    for tag in order:
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--measure",
             "--src", str(trees[tag])] + ([f"--{mode}"] if mode else []),
            cwd=ROOT, capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode or not lines:
            raise RuntimeError(f"--measure of {trees[tag]} failed (exit "
                               f"{proc.returncode}):\n{proc.stdout[-4000:]}"
                               f"{proc.stderr[-4000:]}")
        r = json.loads(lines[-1])
        results[tag].append(r)
        log(json.dumps({"tree": tag, **r}))
    for tag, rs in results.items():
        med = {k: statistics.median(r[k] for r in rs) for k in rs[0]}
        log(json.dumps({"tree": tag, "src": str(trees[tag]), "runs": len(rs),
                        "median": med}))
    log(nvidia_smi_line())
    return 0


def has_port(src: pathlib.Path) -> bool:
    return (src / "repro_torch" / "kernels" / "csrc").is_dir()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="GPU smoke test of the PyTorch port (see the module "
                    "docstring).")
    ap.add_argument("--measure", action="store_true",
                    help="only time the main paths of phases 3, 4, 6-7 and 8 "
                         "and print their rates as one JSON line")
    ap.add_argument("--src", type=pathlib.Path, default=SRC,
                    help="with --measure: the src directory whose "
                         "repro_torch is measured (default: this one's)")
    ap.add_argument("--compare", type=pathlib.Path, metavar="ROOT",
                    help="--measure ROOT/src and this checkout's src in "
                         "turns, each run a process of its own")
    ap.add_argument("--runs", type=int, default=3,
                    help="with --compare: runs a side")
    ap.add_argument("--wkv", action="store_true",
                    help="with --measure or --compare: time only the WKV "
                         "kernel at rwkv6-1.6b's prefill and decode shapes")
    ap.add_argument("--codec", action="store_true",
                    help="with --measure or --compare: time only rows 1-6 "
                         "(normalize, hash, the EF codecs, count-min)")
    ap.add_argument("--mamba", action="store_true",
                    help="with --measure or --compare: time only the Mamba "
                         "scan and its witness at phase 9's three shapes")
    ap.add_argument("--scans", action="store_true",
                    help="with --measure or --compare: time only the drift "
                         "scan's four kinds on phase 2's two batches")
    args = ap.parse_args(argv)
    modes = [m for m in ("wkv", "codec", "mamba", "scans")
             if getattr(args, m)]
    if len(modes) > 1:
        ap.error("--wkv, --codec, --mamba and --scans are separate modes")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 2
    src = args.src.resolve()
    for d in (src,) + ((args.compare / "src",) if args.compare else ()):
        if not has_port(d):
            print(f"chip_smoke: the port's sources are not under {d}",
                  file=sys.stderr)
            return 2
    if args.compare is not None:
        return compare(args.compare, args.runs, modes[0] if modes else None)
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.measure:
        fn = {"wkv": wkv_measure, "codec": codec_measure,
              "mamba": mamba_measure, "scans": scans_measure}.get(
                  modes[0] if modes else None, measure)
        log(json.dumps(fn(torch.device("cuda"))))
        return 0

    from repro_torch.kernels import detector_scan as ds
    from repro_torch.kernels import ops
    from repro_torch.streams import preprocess as prep

    t_all = time.perf_counter()
    # -- phase 1 ------------------------------------------------------------
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    bw, flops, tensor = card_peaks(name)
    log(f"phase 1: card {name!r}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    ops.build_all()
    log(f"  kernels built in {time.perf_counter() - t0:.2f} s")
    dev = torch.device("cuda")

    # -- phase 2 ------------------------------------------------------------
    since(t_all)
    rows = {}
    record = recorder(rows, bw, flops, tensor)
    kg = torch.Generator(device=dev).manual_seed(1234)  # phases 2 and 6
    log("phase 2: kernels vs plain versions at the main path's shapes")
    kernel_checks(dev, kg, record)

    # -- phases 3-5 drive the main path with the counts from 0 ----------------
    since(t_all)
    batches = dense_batches(N_BATCHES, N_EVENTS, DIM)
    # one short run first, so phase 3's rates do not carry the first
    # use of the card's libraries and allocator
    run_dense(batches[:2], "int8_ef", 0.1, "cuda")
    ops.reset_launch_counts()
    phase_counts = {}

    log("phase 3: orchestrator, dense job "
        f"({N_BATCHES} x {N_EVENTS} events, dim {DIM})")
    for codec, budget in DENSE_CODECS:
        before = ops.launch_counts()
        chain0 = ds.chain_stats(dev).clone()
        orch, m, secs = run_dense(batches, codec, budget, "cuda")
        delta = {k: v - before[k] for k, v in ops.launch_counts().items()}
        walked, restarts = (ds.chain_stats(dev) - chain0).tolist()
        phase_counts[f"dense/{codec}"] = delta
        log(f"  {codec}: events={m.events} events_per_s={m.events / secs!r} "
            f"drift_alarms={m.drift_alarms} cuts={sorted(set(m.cuts))} "
            f"codecs={sorted(set(m.codecs))} preq={m.preq} launches={delta} "
            f"ddm_chain_events={walked} ddm_restarts={restarts}")
        if m.events != N_BATCHES * N_EVENTS or set(m.codecs) != {codec}:
            raise AssertionError(f"{codec}: wrong events or codec trajectory")
        if m.drift_alarms < 1:
            raise AssertionError(f"{codec}: the planted drift raised no alarm")
        if not (0.6 < m.preq["ewma_accuracy"] <= 1.0):
            raise AssertionError(f"{codec}: the learner did not recover: "
                                 f"{m.preq}")
        check_no_nan(orch.states, codec)

    log("phase 4: orchestrator, hashed job (hash -> pca -> sketch)")
    before = ops.launch_counts()
    orch, m, secs = run_hashed()
    delta = {k: v - before[k] for k, v in ops.launch_counts().items()}
    phase_counts["hashed"] = delta
    sk = orch.states["sketch"]
    log(f"  events={m.events} events_per_s={m.events / secs!r} "
        f"cuts={sorted(set(m.cuts))} codecs={sorted(set(m.codecs))} "
        f"sketch_n={int(sk.n)} launches={delta}")
    if int(sk.n) != 8 * N_EVENTS or not torch.isfinite(sk.mean).all():
        raise AssertionError("hashed job: wrong or non-finite sketch state")

    log("phase 5: edge preprocessing (preprocess_batch) with NaNs")
    before = ops.launch_counts()
    state = prep.norm_init(DIM, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    t0 = time.perf_counter()
    for b in batches:
        x = torch.as_tensor(b.data["x"]).to(dev)
        x[torch.rand(x.shape, generator=g, device=dev) < 0.15] = math.nan
        state, out = prep.preprocess_batch(state, b.with_data(x=x))
        y = out.data["x"]
        if y.shape != x.shape or not torch.isfinite(y).all():
            raise AssertionError("preprocess_batch: non-finite or misshapen")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    delta = {k: v - before[k] for k, v in ops.launch_counts().items()}
    phase_counts["preprocess"] = delta
    log(f"  batches={len(batches)} events_per_s="
        f"{len(batches) * N_EVENTS / secs!r} n={float(state.n)!r} "
        f"launches={delta}")
    if float(state.n) != len(batches) * N_EVENTS:
        raise AssertionError("preprocess_batch: wrong running count")

    path_counts = {"orchestrator": ops.launch_counts()}

    # -- phases 6-7: model serving, each model one main path ------------------
    since(t_all)
    # the serving kernels are checked here, not in phase 2, so that
    # phases 3-5 follow the same phase 2 as before they were added
    log("phase 6: serving kernels vs plain versions at the serving "
        "path's shapes")
    serving_kernel_checks(dev, kg, record)
    path_counts.update(serving_phases(dev)[0])

    # -- phases 8-9: edge summarization and the Mamba scan ---------------------
    since(t_all)
    log("phase 8: edge summarization (feeder -> count-min -> Misra-Gries): "
        "kernels vs plain versions")
    first = torch.from_numpy(first_token_batch()).to(dev)
    mg_first = sketch_kernel_checks(dev, record, first)
    del first
    log(f"phase 8: {SKETCH_SHARDS} shards x {SKETCH_SEQS} x {SKETCH_SEQ_LEN} "
        f"Zipf({SKETCH_ZIPF}) ids, {SKETCH_BATCHES} batches, depth "
        f"{SKETCH_DEPTH}, widths {SKETCH_WIDTHS}, k = {MG_K}")
    path_counts["summarization"] = summarization_phase(dev, mg_first)[0]
    torch.cuda.empty_cache()
    log("phase 9: the Mamba selective scan at jamba-1.5-large-398b's mixer "
        "width")
    path_counts["mamba"] = mamba_phase(dev, kg, record)

    # -- phases 10-11: dynamic topology and the multi-tenant fleet -------------
    since(t_all)
    torch.cuda.empty_cache()
    log(f"phase 10: dynamic topology ({TOPO_STEPS} x {N_EVENTS} events, dim "
        f"{DIM}; edge_rack silent after step {TOPO_LAST_BEAT})")
    path_counts["topology"] = topology_phase(dev)
    torch.cuda.empty_cache()
    log(f"phase 11: the fleet ({FLEET_ROUNDS} rounds x {N_EVENTS} events a "
        f"tenant, dims {FLEET_DIMS}; the seed edge fails at round "
        f"{FLEET_FAIL_ROUND})")
    path_counts["fleet"] = fleet_phase(dev)

    # -- phase 12: training ----------------------------------------------------
    since(t_all)
    path_counts["training"] = training_phase(dev)

    # -- phase 13: the orchestrator's other modes -------------------------------
    since(t_all)
    path_counts["modes"] = modes_phase(dev, batches)

    # -- phase 14: the MoE, MLA, hybrid, vision and dense families served ------
    torch.cuda.empty_cache()
    since(t_all)
    log(f"phase 14: the MoE, MLA, hybrid, vision and dense families served "
        f"({N_REQUESTS} requests x {PROMPT} tokens, {NEW_TOKENS} greedy new "
        f"tokens, batch {SERVE_BATCH})")
    path_counts.update(families_phase(dev))

    # -- phase 15: the launchers and the mesh ----------------------------------
    torch.cuda.empty_cache()
    since(t_all)
    path_counts.update(launchers_phase(dev))

    # -- phase 16: the dry run and its analysis against a real step -----------
    free_card()
    since(t_all)
    path_counts["dryrun"] = dryrun_phase(dev)

    # -- phase 17: the step on shards, two ranks on the one card --------------
    free_card()
    since(t_all)
    path_counts["sharded"] = sharded_phase(dev)

    # -- phase 18: tensor- and expert-parallel compute, two ranks --------------
    free_card()
    since(t_all)
    log(f"phase 18: the kernels at a model rank's shapes ({TP_MESH} mesh)")
    tp_kernel_checks(dev, kg, record)
    path_counts["tp"] = tp_phase(dev)

    # -- phase 19: ADWIN on the dense job ---------------------------------------
    free_card()
    since(t_all)
    log(f"phase 19: orchestrator, dense job with drift_detector='adwin' "
        f"({N_BATCHES} x {N_EVENTS} events, dim {DIM}, int8_ef)")
    path_counts["adwin"] = adwin_phase(dev, batches)

    # -- phase 20: EDDM and Page-Hinkley on the dense job -----------------------
    free_card()
    since(t_all)
    log(f"phase 20: orchestrator, dense job with drift_detector in "
        f"{DETECTOR_JOBS} ({N_BATCHES} x {N_EVENTS} events, dim {DIM}, "
        f"int8_ef)")
    for det, c in detector_jobs_phase(dev, batches).items():
        path_counts[f"drift/{det}"] = c

    # -- phase 21: a train step on the card for every model that fits -------
    free_card()
    since(t_all)
    log(f"phase 21: {TRAIN_CARD_STEPS} train steps of {TRAIN_B} x {TRAIN_S} "
        f"tokens for every model no other phase trains")
    path_counts["card_training"] = card_training_phase(dev)
    since(t_all)

    counts = {k: sum(c[k] for c in path_counts.values())
              for k in ops.launch_counts()}
    missing = sorted(k for k, v in counts.items() if v <= 0)
    if missing:
        raise AssertionError(f"kernels not launched on a main path: {missing}")

    # -- small input: the card's path against the CPU's plain path -----------
    # sample_rate=1.0 keeps every event, so the two generators' draws
    # (which differ between devices) do not enter the comparison
    log("check: small dense job on the card vs the same job on the CPU")
    small = dense_batches(10, 512, 16)
    for codec, budget in DENSE_CODECS:
        _, mg, _ = run_dense(small, codec, budget, "cuda", sample_rate=1.0)
        _, mc, _ = run_dense(small, codec, budget, "cpu", sample_rate=1.0)
        same = (mg.events == mc.events and mg.cuts == mc.cuts
                and mg.codecs == mc.codecs
                and mg.drift_alarms == mc.drift_alarms)
        gap = max(abs(mg.preq[k] - mc.preq[k]) for k in
                  ("accuracy", "logloss", "ewma_accuracy"))
        log(f"  {codec}: events/cuts/codecs/drift_alarms equal={same} "
            f"max preq gap={gap!r} (tol 1e-3)")
        if not same or gap > 1e-3:
            raise AssertionError(f"{codec}: card and CPU runs disagree")

    # the vision model's cross-attention shapes at its serving batch: rows
    # of their own, with the launches of that path
    vlm_path = "serve/" + next(c.name for c, _ in family_configs()
                               if c.family == "vlm")
    vlm_rows = {f"flash_attention/vlm_b{SERVE_BATCH}{tag}": path_counts[
        vlm_path]["flash_attention"] for tag in ("", "_decode")}
    # ADWIN's, EDDM's and PH's rows: their launches on phases 19 and 20
    # (one counter for every kind: DDM's row takes the rest); the largest
    # sizes' and the sizes above them: none
    detector_rows = {ADWIN_ROW: path_counts["adwin"]["detector_scan"],
                     **{row: path_counts[f"drift/{det}"]["detector_scan"]
                        for row, det in zip(DETECTOR_ROWS, DETECTOR_JOBS)}}
    path_rows = {**vlm_rows, **dict.fromkeys(WIDE_ROWS + ABOVE_ROWS, 0),
                 **detector_rows, "detector_scan": counts["detector_scan"]
                 - sum(detector_rows.values())}
    kernels = []
    for k, row in rows.items():
        if k != row["name"] and k != WKV_CHUNK64_ROW and \
                k not in path_rows:
            continue        # a further shape of a kernel: logged above
        # the chunk-64 row is the kernel's (one counter for every chunk)
        kernels.append({"name": k, "route": row["route"],
                        "source": row["source"], "replaces": row["replaces"],
                        "launches": path_rows.get(k, counts[row["name"]]),
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    log(f"launches by phase: {json.dumps(phase_counts, sort_keys=True)}")
    log(f"launches by main path: {json.dumps(path_counts, sort_keys=True)}")
    log(f"total seconds: {time.perf_counter() - t_all:.1f}")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
