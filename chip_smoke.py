"""On-card smoke run of the PyTorch/H100 port (``torchft_tpu_torch``).

Usage (repo root, one NVIDIA GPU): ``python3 chip_smoke.py``

Phases, each of which either passes or ends the run with a non-zero exit:

1. the card's name and power limit; TF32 off for float32 matmuls.
2. kernel parity at each head dim the kernels take: at the headline
   attention shapes (B8 S1024 H8 D64, bf16, causal), the Llama-2-7B
   shapes (B2 S4096 H32 D128) and the train_bytes shapes (B8 S128 H4 D32,
   bf16 and float32), at a ragged length (B2 S192 H2) at D 64, 128 and
   32, and at D 128 and 32 at B2 S320 H2 (K3's last block of 128 keys half
   past S; at D 128 also non-causal, K2's last q-tile half past S without
   the mask) and at B2 S1024 H4, causal and non-causal (the rings wrap their
   phase parity): K1 (forward), K2 (dQ) and K3 (dK/dV)
   each against its plain PyTorch
   version on the same inputs, elementwise, and bitwise equal across two
   launches; the autograd op against plain attention evaluated in float32
   at each head dim; float32 cases at the JAX test bars. At the
   long-context bench's lengths (D 64): K1-K3 whole at B2 S4096 H8 and
   B1 S8192 H8, and at B1 S16384 and S32768 H8 over chunks of 4096 query
   rows (dO random on every row: O, lse and dQ chunk by chunk, dK and dV
   against the chunks' float32 sum). At head dims 8 and 16 (the FMA
   kernels, float32 and bf16): train_hsdp's tiny preset's B8 S16 H2, S 48
   (one tile, its last rows past S) causal and not, and S 200 (a ragged
   fourth tile); bf16 at head dims 32 and 64 where S is not a multiple of
   64; the autograd op at the tiny preset's shape. At the rest of the
   shapes the Pallas op takes (``SHAPES_HELD``): bf16 at head dim 128 at S
   16, 100 and 1000 causal and S 100 not (wgmma, the last tile masked),
   float32 at 128 (S 256 causal and not, S 200) and both types at 256 (S
   128 and 200; float32 K1 on the register-blocked kernel, K2 and K3 on
   the FMA kernels' 32-row tiles, bf16 K1-K3 on wgmma; bf16 also at S 1024
   causal and not, the rings
   wrapping, a ragged S 1000 at an odd BH, and phase 23 (c)'s B1 S2048
   H16 causal), and 96, 80 and 40 padded
   to 128 and 64 (S 192, both types, the true head dim's scale); the op at
   bf16 D 128 S 96 with 32-row blocks and at ``SHAPES_OP`` (D 96, 128 in
   float32, 256) against float32 attention; C's and Python's
   ``supported`` agreeing over head dims 1-300; the op refusing 257.
3. timing of each kernel at the shapes its main path gives it (D 64 at
   the headline's and at B1 S8192 and S32768 H8, where phase 14's
   long-context rows run it; D 128 at the Llama-2-7B width's, D 32 at
   train_bytes'; D 8 and 16, float32 and bf16, at the tiny preset's B8
   S16 H2, where phase 21 (a) runs D 8 in float32; at S 32768 the plain
   versions run on query chunks):
   launched eagerly between CUDA events (``ms``), and replayed from a CUDA
   graph (device time alone) with its inputs warm in the L2 and L2-cold;
   its host cost per call, its plain version, the
   ``scaled_dot_product_attention`` yardsticks by both methods, the
   roofline bound and, for K2 and K3 at D 128 and K1-K3 at D 32, the
   earlier design's time. Also at ``SHAPES_TIMED`` (float32 at D 128 at
   the Llama width's shape, bf16 at 128 at B8 S16 H32, D 256 in both types
   and D 96 padded to 128 at B2 S2048, a few launches each at the slow
   float32 shapes), with the backend SDPA picks.
4. the headline fault-tolerant training loop on one replica group:
   in-process lighthouse + store, Manager over the device data plane
   (CollectivesDevice, the JAX headline's wiring), TrainStep at d512 L8
   h8 ff1408 vocab 32000 bf16, batch 8 x seq 1024; 2 warm-up and 5 timed
   steps, the step replayed from CUDA graphs on the device plane and on
   the TCP plane, and run eagerly on the device plane (the same AdamW), in
   turns; the graphed arm's 7 losses and final params equal the eager
   arm's bit for bit; on the device plane ``allreduce_gradients`` hands
   back the very gradient tensors it was given; kernel launch counts
   checked per step (a replay counts the launches its graph recorded),
   once against ``torch.profiler``'s kernel names. Then the graphed step
   under each ``remat`` policy: launches per step, bitwise equal losses,
   and the activation bytes a layer holds after the forward.
5. two replica groups as threads on the card over CollectivesTcp: the
   second joins late, heals from the first over HTTP, both commit 3 steps
   together and end with bit-identical parameters; the heal's bytes,
   transfer and apply times and the joint steps' wall are printed.
6. DiLoCo, two groups as threads at the headline size: sync quorum, 8
   inner AdamW steps per sync, outer SGD(0.7, momentum 0.9, Nesterov).
   The second group joins after the first one's first committed sync,
   heals at its first sync quorum, and both run 2 more syncs together;
   both end with one params sha256 and one outer-momentum sha256, and the
   last joint sync's new backup and momentum are held against a plain
   recomputation of the outer step from both groups' tensors.
7. the pipelined commit against the synchronous one: two groups (one
   driving FTTrainer, one ManagedOptimizer) take 6 steps from one seed,
   once with each commit; both vote False at step 3 (a fault injected
   at the vote), so the pipelined run rolls a speculative update back and
   replays its batch. Both runs end at step 5 with one params sha256.
8. phase 5 over the device data plane, each group on a CUDA stream of its
   own: the second group heals over CollectivesTransport; both end with
   one sha256. For one joint step, each group's averaged gradients equal
   the plain ``(g0 + g1) / 2`` of both groups' gradients, bit for bit. The
   reduction's device time for the gradient tree is printed beside its
   bound, and the joint steps and the heal beside phase 5's.
9. the Llama-2-7B-width FT step (examples/train_hsdp.py's preset: d4096
   h32 head dim 128 ff11008 vocab 32000, bf16, ``attention_impl="auto"``)
   at 4 of its 32 layers, batch 2 x seq 4096, one group on the device
   plane: the first step's loss against the same step's with plain
   attention, every step committing, 8/4/4 launches per step, steps/s.
10. phase 8 at examples/train_bytes.py's model (d128 L2 h4 head dim 32
   ff352 vocab 256, bf16, batch 8 x seq 128): a late joiner heals over
   CollectivesTransport, one sha256, 4/2/2 launches per step.
11. ResNet-18 on CIFAR (``torchft_tpu_torch/examples/train_cifar.py``:
   bf16, batch 32 of 32x32x3, the stand-in dataset): the graphed step
   against the eager one on one batch (bitwise), then two groups on the
   device plane, each on its own stream, the second joining late and
   healing over CollectivesTransport to the sha256 of the params, momentum
   and BN stats served; one sha256 of params and momentum at the end (BN
   running stats stay each group's own, as in the JAX example); the
   groups' sample ids disjoint within an epoch; the loss falling.
12. kill and rejoin (``torchft_tpu_torch.benchmarks.recovery``): two
   groups as worker processes on the card, each training the headline at
   full width (graphed, ``"flash"``) over CollectivesTcp on its Python
   ring (phases 5 and 12 keep the plane they were written on) with the HTTP
   heal, one lighthouse at its default 5 s lease; group 1 takes SIGKILL
   at step 8 and is respawned. Every worker exits 0; the survivor's
   eviction report is accepted and its blackout stays below the lease; the
   survivor commits after the kill, the respawned group heals and
   commits; both end with one sha256 of params and AdamW state, one
   capture of each graph and 16/8/8 flash launches per step. Prints the
   blackout, the rejoin time and its parts, the steady step, the heal and
   the survivor's log of the death path. The workers write their FT event
   trails and span files, and a SIGUSR2 to the survivor after its first
   commit past the kill dumps its flight recorder: a survivor's trail holds
   the accepted eviction and the quorum without the victim, the survivors'
   checkpoint_serve spans join the rejoiner's heal_recv trace (the
   X-TFT-Trace header), and the dump lists completed allreduces. Every
   kill of phases 13-15 holds the same.
13. the wire plane (``torchft_tpu_torch.benchmarks.crossgroup.run_pair``):
   two worker processes on the card, each holding the headline at full
   width with its gradients graphed. Worker 1 pulls worker 0's page-locked
   staging memory with ``process_vm_readv`` (a refusal is printed with its
   errno, and the CMA jobs are then not run). Five arms in turn, each a
   fresh lighthouse, Manager (sync quorum) and CollectivesTcp with
   ManagedOptimizer over TrainStep, 2 warm-up and 5 timed joint steps from
   the same seeded params: the Python ring, the striped TCP plane, CMA,
   and the striped plane with the bfloat16 and the int8 wire (error
   feedback on). Every step commits; each arm reports the plane and codec
   it asked for; the first step's averaged gradients have one sha256 in
   both workers and the same in the three exact arms; in the lossy arms
   it differs from the exact arms' and lies within WIRE_ERR_LIMIT of it,
   on a measure in the exact average's own units (2^-8 of each leaf's
   norm for bfloat16, 2/127 of the tree's largest element for int8),
   which the worker's own gradients and zeros in its place both fail;
   error feedback holds residuals at every vote and none after the
   commit; the final params have one sha256 in both workers; 16/8/8
   launches per step, the gradient graph captured once per worker. Then
   the raw allreduce of the gradient tree's bytes on each plane (GB/s),
   a 701.6 MB heal over CollectivesTransport with CMA and over TCP (one
   sha256 on both sides), and phase 12's SIGKILL on the default plane
   with phase 12's checks.
14. the port's bench (``torchft_tpu_torch.bench``), shortened: the
   headline ``train_bench`` as one interleaved pair (2 warm-up + 10 timed
   steps each), ``benchmarks.long_context`` whole (the headline at S
   32768, 16384, 8192 and 4096, and the 647M model), ``resnet_ft`` (1
   rep), ``quorum_overlap`` and ``commit_pipeline`` (1 pair each),
   ``diloco`` (4 worker processes, 2 outer steps), ``crossgroup
   --compressed`` (128 MB, 1 round), each in a lane of its own (the two
   pairs in one), and the 1-of-4 kill (four headline
   workers) under phase 12's checks. Every row printed; no row errs; every
   transformer step commits with one capture of each graph, 2L/L/L flash
   launches a step (L/L/L for the 647M model, without remat) and 0 <
   mfu_pct < 100; every DiLoCo sync hands the collectives the MLP's float32
   bytes.
15. the heal plane: (a) ``benchmarks.crossgroup.measure_striped_heal``
   at the headline's params and AdamW state (701.6 MB) staged on the card
   by one and by two source processes and pulled striped over the native
   blob plane, then copied onto the card: GB/s, per-source bytes, ranges
   and GB/s, the stages, one sha256 across the sources and the healed
   state; (b) the two-source row with one source SIGKILLed from
   ``header_cb`` (after the plan, before the bulk bytes): its ranges
   re-stripe onto the other, the sha256 still one; (c) a kill of 1 of 3
   headline worker processes under phase 12's checks, the rejoiner
   striping from both survivors; (d) the differential heal
   (``TORCHFT_HEAL_DIFF=1``) between two headline trainers on their own
   streams: the healer rejoins two steps behind and receives the leaves
   that changed (AdamW changes nearly all: no saving is claimed), the
   trail's per-step cost printed; with one of its params changed first,
   the same run falls back to the full striped heal. A heal that should
   have ridden the blob plane and rode HTTP fails the phase. Phases 5, 12,
   13 and 14 heal over HTTPTransport's striped receive too: every kill's
   rejoiner must stripe over all survivors (phase 14's 1-of-4: 3 sources).
   Phase 14 also reads the bench's ``step_anatomy`` and ``telemetry`` rows
   over its headline pair: no error, a row a step, a quorum and a commit
   counted per step (the p50 composition printed: the bench's loop reads
   no loss, so its host runs ahead of the card).
16. the local observability plane: the headline graphed as one group in
   this process, 20 steps on the device plane with the trail and span
   file sinks on, then off, then on the TCP plane with them on. Every
   ledger row sums to its wall clock; the step_anatomy row's p50
   composition is within 5% of the wall p50; one commit event a step in
   the trail, one quorum_rpc and one should_commit_rpc span a step; a
   ``/metrics`` scrape of the group's HTTP transport lists every catalog
   family with nonzero quorum and allreduce counters; K1-K3 launches per
   step as phase 4's. Prints the phases' p50/p99 and steps/s with and
   without the sinks. Then a worker process (``chip_smoke.py
   --watchdog-probe``) with ``TORCHFT_WATCHDOG_MIN_S`` at 0.5 s holds a
   step 2 s: the watchdog fires on it (a ``watchdog_stall`` event, a
   flight dump) and is disarmed at its vote; its stall push puts ``stuck``
   on the probe lighthouse's ``/cluster.json`` while the step is held
   (phase 17's check), and the next report takes it off.
17. the fleet plane (``benchmarks.recovery.run_fleet``): three headline
   worker processes (the recovery harness's, graphed, no kill) on
   CollectivesTcp's default plane with one lighthouse here, 40 steps;
   group 2 sleeps three of its steady steps in its local time each step
   from step 10; group 0 hosts the straggler monitor and the history
   thread (regression sentinel, critical path) polling every 0.25 s; the
   step SLO lies between the steady and the slowed step. Read while the
   workers linger after their last step (``recovery.fleet_checks``): one
   sha256, one capture of each graph and 16/8/8 launches a step in every
   worker; ``/cluster.json`` lists the three at their last step with
   summary and anatomy; the lighthouse applied every delta blob with one
   full blob a chain and no resync; ``/fleet.json`` folds three groups
   with wall p50/p99; ``/timeseries.json`` holds each one's wall series;
   group 0's ``/metrics`` shows the straggler and regression latches on
   group 2 alone; its ``/critical_path.json`` blames group 2 and the
   series' attribution names it the gating replica of most steps after
   the onset; group 2's ``slo_breach`` is true; the merged ``/trace`` has
   a lane per replica with ``quorum_rpc`` spans. Prints each worker's
   piggyback bytes (the full blob, the steady deltas, the full-JSON
   payload of its last report) and the ``telemetry`` phase's p50/p99.
   Then ``benchmarks.quorum_scale`` at 8, 32 and 64 groups (the delta
   leg's steady bytes below the full-JSON leg's at every N) and
   ``benchmarks.telemetry_overhead``, one pair (printed).
18. forensics and the fault plane: two headline worker processes (the
   recovery harness's, graphed, on CollectivesTcp's striped TCP plane)
   with the black box and the fault evidence armed; group 1's first
   incarnation kills itself (a ``collective.issue`` kill at its 74th
   gradient allreduce, joint step 10), is respawned and heals: one
   sha256, one evidence record, the victim's Python and native rings
   with the allreduce issued and never completed, the postmortem naming
   it the victim with that op in flight, ``injected``, and its CLI
   exiting 0. Then the JAX package's ``diagnose_straggler`` at full
   width: both groups host the straggler monitor and a diagnosis engine
   (1.5 s window, 97 Hz, the torch trace armed); group 1's gradient
   allreduces are issued 200 ms late and its stripe hops sleep 60 ms:
   exactly one bundle, group 1's on ``straggler_detected``, the delay
   frame dominant in its active ``dp.pump`` stacks, ``python.folded`` not
   empty, the torch trace naming K1-K3, the bundle on the postmortem's
   timeline and in ``/diagnosis.json``; the control leg writes none; one
   sha256 and 16/8/8 a step throughout. Printed: ``profiler_overhead``
   (one pair), steps/s with the black box armed and disarmed, the
   bundle's size, the samples per plane. The kill, the diagnosis legs (in
   turn) and ``profiler_overhead`` run at once.
19. the fault matrix on the card (``torchft_tpu_torch.faultinject.runner``,
   in this process): the port's ``train_bytes`` example as the workers,
   bf16 on the card (K1-K3 at head dim 32), two groups per run, on three
   scenarios at once: ``torn_cma_pull`` (a CMA pull between the two
   processes torn halfway, the divergence sentinel armed),
   ``corrupt_divergence`` (all three legs: the sentinel latches within one
   commit of a corrupted average, the fence vetoes it with identical
   checksums, the control leg latches nothing) and
   ``compiled_kill_commit_vote`` (the model checker's schedule: a kill at
   the commit barrier's drain, a respawn and a heal). Each is held to the
   runner's own checks (passed, the injection fired, the victim respawned
   where expected, checksums finite and bit-identical but in the sentinel
   leg) and every worker that finished launched K1-K3. Prints each
   scenario's wall, respawns, evidence and the latch step against the
   corrupt step; the phase's wall must stay within FAULT_WALL_S.
20. the deployment plane, run at the same time as phase 19, four legs at
   once in threads, the phase's wall within DEPLOY_WALL_S: (a) ``python -m torchft_tpu_torch.launcher
   --groups 2 --min-replicas 2 --max-restarts 2`` over the ``train_bytes``
   example (bf16 on the card, K1-K3 at head dim 32) with CKPT_DIR,
   CKPT_EVERY=2, STEPS=12 and a trace per group; group 1's worker takes
   SIGKILL from this script once its trace shows its fifth committed step. The
   launcher exits 0 after exactly one restart; the respawn restores from
   disk at step 4 or later before its first quorum and never heals
   backward; both groups end at step 12 with one checksum; no step is
   trained twice in a group, each batch is the sampler's, the groups'
   samples are disjoint; the survivor's blackout is printed. (b) total
   failure: one ``train_bytes`` group trains 6 steps straight under its
   own launcher; beside it another trains 3 with a checkpoint each step,
   and a fresh launcher resumes it to 6: the two checksums are
   bit-identical. (c) two headline groups as threads here, each a Manager
   over ``CollectivesProxy`` around CollectivesTcp's Python ring (phase
   5's plane), graphed, 6 steps; group 0's child is killed before step 3:
   that step fails on both groups within the op timeout, every later step
   commits with the same trainers (the children respawn at the next
   quorum), one sha256 at the end, ``plane_info()`` ``proxy:python-ring``,
   16/8/8 launches a step; then, once the other legs and phase 19 are
   done, 3 more joint steps whose median wall is printed beside phase 5's
   (the steps beside the other worker processes share the host's 8 cores
   with them, and are printed apart). (d) ``launcher --groups 2 -- train_ddp`` and ``launcher
   --groups 4 --min-replicas 2 -- train_diloco`` on the card: each exits 0
   with one checksum across its groups.
21. the HSDP path (``torchft_tpu_torch/examples/train_hsdp.py``), run at
   the same time as phases 19 and 20, its two legs at once, the phase's
   wall within HSDP_WALL_S: ``launcher --groups 2 --min-replicas 2``, one
   process a group (a one-rank NCCL group and DTensor mesh each). (a) the
   tiny preset (head dim 8, float32, ``"auto"`` attention on K1-K3) at
   BATCH 8 x SEQ 16 for 10 steps; group 1's worker takes SIGKILL once it
   logs its third commit: exactly one restart, the respawn heals live past
   step 3, both groups end at step 10 with one checksum, every finished
   worker launched K1-K3 4/2/2 a step it ran, its step replayed from CUDA
   graphs captured once. (b) the llama2-7b preset at full width (d4096
   h32 head dim 128 ff11008 vocab 32000, bf16) at ``LLAMA_LAYERS`` of its
   32 layers, B2 S4096, 3 steps, the step eager (two graphed groups at
   this width do not fit the card beside each other; the worker is
   ``chip_smoke.py --hsdp-llama``): one checksum, finite losses, 8/4/4
   launches a step, each group's peak device memory printed.
22. pipeline and sequence parallelism and chunked attention. (a), right
   after phase 4: the headline's ``TrainStep.grads`` with
   ``attention_impl="chunked"`` (chunk 128, 4 tiers: the JAX package's
   picks at S 1024), eagerly and replayed from a CUDA graph, against the
   ``"plain"`` arm from the same params and tokens: the loss within
   phase 9's 1e-2, each gradient leaf within 2^-5 of plain's in norm, the
   replay bitwise equal to eager, no flash launch; ``"auto"`` still
   launching K1-K3 16/8/8 a step; each arm's call timed (chunked, flash
   and plain, graphed and eager). (b) chunked attention alone at B1
   S32768 H8 D64 bf16 (16 tiers, chunk 128), forward and backward,
   against float32 attention from the kernels' plain versions by query
   chunks (CHUNKED_LONG_BAR) and against the flash op (CHUNKED_OP_BAR);
   its time and peak memory beside the op's. (c), beside phase 2 (whose
   checks time nothing):
   the tiny preset at pp 2 (two microbatches, ``loss_fn`` through
   ``parallel.pipeline``) and at sp 2 (ring attention), two gloo
   processes each on the host's CPU (``device="cpu"`` asked for: NCCL
   refuses two ranks on one card; the workers are ``chip_smoke.py
   --mesh-worker``): the pp 2 loss equals one stage's to rtol 1e-5, ring
   attention equals plain attention to 2e-5, the gradients to 2e-5, the
   wall within MESH_WALL_S.
23. K1-K3 at the rest of the shapes the Pallas op takes, in models, right
   after phase 22 (a) and (b): (a) examples/train_hsdp.py's llama2-7b
   preset at ``LLAMA_LAYERS`` layers, bf16, ``"auto"``, at the example's
   default BATCH 8 x SEQ 16 (head dim 128 at an S the wgmma kernels take
   with the last tile masked): ``TrainStep.grads`` eagerly and replayed
   from a CUDA graph, bitwise equal, 8/4/4 flash launches in each, the
   loss within 1e-2 of the plain route's; (b) the same width at 2 layers
   in float32 through ``"flash"``, B1 S1024 (K1 register-blocked, K2 and
   K3 the FMA kernels at 128): the
   loss within 1e-4 and each gradient leaf within 1e-3 in norm of the
   plain route's, 4/2/2 flash launches; (c) the same 4096 columns a token
   as 16 heads of 256 (Gemma-7B's head width) at 2 layers, bf16,
   ``"auto"``, B1 S2048 (K1-K3 on wgmma):
   ``TrainStep.grads`` eagerly and replayed from a CUDA graph, bitwise
   equal, 4/2/2 flash launches in each, the loss within 1e-2 and each
   gradient leaf within 2^-5 in norm of the plain route's, and one eager
   call under ``torch.profiler`` naming the three kernels.

Phase 18 runs its kill, its diagnosis legs and ``profiler_overhead`` at
once (its in-process steps/s with the black box armed and disarmed after
them).

Phases 4-18 and 21 replay each train step from CUDA graphs (phase 4's and
phase 9's eager arms and phase 21's leg (b) aside); every group's graphs
are captured once, so a heal or a rollback that swapped a captured tensor
would show as a recapture.

Prints the kernels' JSON line (one entry per kernel and head dim, and at
head dim 64 per long-context length), the
script's seconds and, last, ``{"ok": true, "device": ...}``. The native core and the kernels are
built from the checkout on first use; ptxas must report 0 spill bytes for
every kernel of a fresh build.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback
import concurrent.futures
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
HEADLINE = dict(batch=8, seq=1024, heads=8, head_dim=64)
# the Llama-2-7B preset (examples/train_hsdp.py:68-75) at Llama 2's context
LLAMA = dict(batch=2, seq=4096, heads=32, head_dim=128)
LLAMA_LAYERS = 4  # of the preset's 32: one card holds float32 masters and AdamW state for 4
# examples/train_bytes.py:62,86,104-112
BYTES = dict(batch=8, seq=128, heads=4, head_dim=32)
# train_hsdp's tiny preset (examples/train_hsdp.py:62-66,85) at its BATCH 8
# x SEQ 16: head dim 8, float32 (phase 21 (a)); head dim 16 and bf16 are
# timed at the same shape
TINY = dict(batch=8, seq=16, heads=2, head_dim=8)
# head dims 8 and 16 held against the plain versions: the tiny preset's
# shape, S 48 (one tile, its last 16 rows past S) causal and not, and S 200
# (four tiles, the last ragged)
SMALL_HELD = ((8, 16, 2), (2, 48, 2), (2, 200, 2))
# the headline's attention at the long-context bench's lengths
# (benchmarks/long_context.py), timed at S 8192 and 32768
LONG_WHOLE = dict(batch=1, seq=8192, heads=8, head_dim=64)
LONG = dict(batch=1, seq=32768, heads=8, head_dim=64)
# (B, S, H, D) held whole against the plain versions, and over query chunks
# (the [S, S] scores would take 8.6 GB at S 16384, 34 GB at S 32768)
LONG_HELD_WHOLE = ((2, 4096, 8, 64), (1, 8192, 8, 64))
LONG_HELD_CHUNKED = ((1, 16384, 8, 64), (1, 32768, 8, 64))
# the plain versions at S 16384 and 32768 run on query chunks of this many
# rows (a chunk's scores: 4.3 GB in float32 at S 32768)
LONG_PLAIN_CHUNK = 4096
REPLACES = {
    "flash_fwd": "torchft_tpu/ops/pallas/flash_attention.py:67",
    "flash_dq": "torchft_tpu/ops/pallas/flash_attention.py:145",
    "flash_dkv": "torchft_tpu/ops/pallas/flash_attention.py:177",
}
SOURCE = "torchft_tpu_torch/csrc/flash_attention.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def gpu_time_ms(fns, reps: int = 25, inner: int = 5, graph: bool = False) -> float:
    """Median over ``reps`` of the mean time of one call, from ``inner``
    back-to-back rounds between CUDA events. ``fns`` is one callable, or a
    list called in turn each round: over inputs whose sum exceeds the L2,
    each call then finds its own inputs evicted (an L2-cold time).

    Launched eagerly, each timed round starts from an idle card, so the
    host's cost of the first launch (tens of microseconds through a
    kernel's Python wrapper, see ``host_us_per_call``) is in the time.
    ``graph=True`` captures the rounds in a CUDA graph and replays it: the
    device's time alone."""
    fns = fns if isinstance(fns, (list, tuple)) else [fns]

    def rounds():
        for _ in range(inner):
            for fn in fns:
                fn()

    for _ in range(3):
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    run = rounds
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            rounds()
        run = g.replay
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / (inner * len(fns)))
    return statistics.median(times)


def host_us_per_call(fn, calls: int = 200) -> float:
    """Host time of one call (at a size where the device keeps up)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


# the library's kernels as their mangled names spell the template
# arguments, by (kernel, head dim): the wgmma kernels of the bf16 paths
# (K1-K3 at head dims 32, 64 and 128), and the FMA kernels in float32 at 32
# and 64, off the bf16 paths
KERNEL_OF = {(n, d): f"{n}_wgmmaILi{d}E" for n in ("flash_fwd", "flash_dq", "flash_dkv")
             for d in (64, 128, 32)}
# the FMA kernels (float32 and bf16, 13__nv_bfloat16 in the mangled name)
# at head dims 8 and 16, by (kernel, head dim, dtype)
for _n in ("flash_fwd", "flash_dq", "flash_dkv"):
    for _d in (8, 16):
        KERNEL_OF[(_n, _d, "f32")] = f"{_n}_kernelIfLi{_d}E"
        KERNEL_OF[(_n, _d, "bf16")] = f"{_n}_kernelI13__nv_bfloat16Li{_d}E"
# float32 at head dims 128 and 256: K1 on the register-blocked kernel
# (flash_fwd_f32), K2 and K3 on the FMA kernels' 32-row tiles; bf16 K1-K3
# at 256 on wgmma (256 threads)
for _n in ("flash_fwd", "flash_dq", "flash_dkv"):
    for _d in (128, 256):
        KERNEL_OF[(_n, _d, "f32")] = (f"flash_fwd_f32ILi{_d}E" if _n == "flash_fwd"
                                      else f"{_n}_kernelIfLi{_d}E")
    KERNEL_OF[(_n, 256, "bf16")] = f"{_n}_wgmmaILi256E"
BUILT = list(KERNEL_OF.values()) + [
    f"{n}I{t}Li{d}E" for n in ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")
    for t in ("f", "13__nv_bfloat16") for d in (32, 64)]
# Earlier designs, by CUDA graph, L2-warm, at the shapes of their head
# dim's path (chip_smoke.py phase 3 on an NVIDIA H100 80GB HBM3 at 700 W):
# K2 at head dim 128 with a producer warpgroup, 64 keys at once (384
# threads) and K3 there with one consumer of 64 keys (256 threads),
# B2 S4096 H32 D128; K1-K3 at head dim 32 on the FMA kernels, B8 S128 H4
# D32; bf16 K1-K3 at head dim 256 on the FMA kernels, B2 S2048 H16
# D256 (SHAPES_TIMED["d256"]), and float32 K1 on the FMA kernel there
# ("d256_f32") and at B2 S4096 H32 D128 ("d128_f32"); printed beside this
# run's times in phase 3's log, not re-run (the kernels line holds only
# this run's numbers)
EARLIER_GRAPH_MS = {("flash_dq", 128): 0.8810, ("flash_dkv", 128): 1.6509,
                    ("flash_fwd", 32): 0.0325, ("flash_dq", 32): 0.1053,
                    ("flash_dkv", 32): 0.0505,
                    ("flash_fwd", 256): 28.8739, ("flash_dkv", 256): 45.6399,
                    ("flash_dq", 256): 22.7956, ("flash_fwd", 256, "f32"): 30.9959,
                    ("flash_fwd", 128, "f32"): 35.020}


def check_no_spills(build_log: str) -> None:
    """Each kernel of ``BUILT`` has one section in a ptxas -v log, no other
    kernel has one, and every section reports 0 spill bytes (a spill of a
    wgmma accumulator serialises the tensor cores). An empty log (a library
    built earlier) is not checked."""
    if not build_log:
        return
    sections = build_log.split("Compiling entry function")[1:]
    check(len(sections) == len(BUILT),
          f"ptxas log: {len(sections)} entries, expected the {len(BUILT)} of BUILT")
    for name in BUILT:
        found = [sec for sec in sections if name in sec.splitlines()[0]]
        check(len(found) == 1, f"ptxas log: no single entry for {name}")
    for sec in sections:
        check("0 bytes spill stores, 0 bytes spill loads" in sec,
              f"{sec.splitlines()[0].strip()} spills registers")


# ---------------------------------------------------------------------------
# phase 2 / 3: kernels
# ---------------------------------------------------------------------------


def _qkv(b, s, h, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [
        torch.randn(b, s, h, d, device="cuda", generator=g).to(dtype)
        for _ in range(4)
    ]


def _pack(x):
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _plain_grads(q, k, v, do, causal):
    """Plain attention under autograd in float32 from the same inputs."""
    from torchft_tpu_torch.ops.attention import attention

    qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    o = attention(qf, kf, vf, causal=causal)
    o.backward(do.float())
    return o.detach(), qf.grad, kf.grad, vf.grad


def _op_grads(q, k, v, do, causal):
    from torchft_tpu_torch.ops.flash_attention import flash_attention

    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    o = flash_attention(qs, ks, vs, causal=causal)
    o.backward(do)
    return o.detach(), qs.grad, ks.grad, vs.grad


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# bfloat16 bars for gradients, elementwise: |g - ref| <= rtol * (|ref| +
# rms of ref's row over the head dim) + atol.
#
# Kernel vs its plain version (same inputs, lse and delta): rtol 2^-6,
# atol 1e-5. Two bf16 ulps of |ref| cover the rounding of the output; the
# row's rms covers the bf16 rounding of P and dS inside the kernels, whose
# error scales with the row, not with the element (entries near zero by
# cancellation); the atol covers rows that are exactly 0 (dQ of query 0
# under the causal mask, where dP - delta cancels), where float32
# summation order leaves about 5e-7. A wrong tile, a dropped diagonal
# block or a wrong mask moves an element by about its row's rms, dozens of
# times the bar, at every key position.
KERNEL_BAR = dict(rtol=2.0 ** -6, atol=1e-5, row_scaled=True)
# K1's float32 lse against its plain version, absolute: lse is about 7 at
# S=1024, where one float32 ulp is 4.8e-7; exp2 with the scale folded in
# versus exp, and another summation order, move it by a few ulps. A wrong
# tile moves it by about log(1 + its share of the row's mass), 1e-2 or more.
LSE_TOL = 1e-4
# The autograd op vs plain attention in float32: rtol 2^-7 (the output's
# bf16 rounding, with a 2x margin) and atol 2e-2, twice the largest excess
# that scripts/torch_flash_grad_errors.py measured over four seeds and
# shapes on an H100 80GB HBM3 at 700 W (1.0e-2). The op computes
# delta from its bf16 output, as the JAX backward does; the float32
# reference does not, and in the first few causal rows, where dS sums to
# zero by cancellation, that difference is not small beside the row. This
# check holds the op's wiring (packing, delta, argument order), whose
# faults are of the size of the gradients; the tile logic is held above
# and by the float32 cases below.
OP_BAR = dict(rtol=2.0 ** -7, atol=2e-2, row_scaled=False)


# float32 kernels against their plain versions: the JAX test bars (2e-5 for
# O and lse, 3e-4 for gradients), float32 summation order only
F32_O_BAR = dict(rtol=0.0, atol=2e-5, row_scaled=False)
F32_GRAD_BAR = dict(rtol=0.0, atol=3e-4, row_scaled=False)
F32_LSE_TOL = 2e-5


def _errs(got, ref, rtol, atol, row_scaled):
    """(max |err|, worst err/bar, median |ref|, max |ref|) of ``got``
    against ``ref`` at a bar above."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    scale = ref.abs()
    if row_scaled:
        scale = scale + ref.pow(2).mean(-1, keepdim=True).sqrt()
    return (float(err.max()), float((err / (rtol * scale + atol)).max()),
            float(ref.abs().median()), float(ref.abs().max()))


def _hold(name, got, ref, what, rtol, atol, row_scaled, errs=None) -> float:
    """Hold ``got`` to ``ref`` elementwise at a bar above (or take ``errs``,
    what ``_errs`` gave over chunks); print the error, the bar and the
    typical |ref| beside it. Returns max |err|."""
    err, worst, med, top = errs or _errs(got, ref, rtol, atol, row_scaled)
    rows = "(|ref|+row rms)" if row_scaled else "|ref|"
    log(f"{name}: max|g-{what}|={err:.3e} median|ref|={med:.3e} max|ref|={top:.3e} "
        f"worst err/bar={worst:.3f} (bar {rtol:.4g}*{rows}+{atol:g}, fail >1)")
    check(worst <= 1.0, f"{name} disagrees with {what}")
    return err


def _hold_lse(name, got, ref, tol=LSE_TOL, err=None) -> float:
    err = _max_err(got, ref) if err is None else err
    log(f"{name}: max|lse-ref|={err:.3e} (tol {tol:g})")
    check(err <= tol, f"{name}: lse disagrees with its plain version")
    return err


def _padded(fa, x, d):
    """[BH, S, d] zero-padded to the kernels' head dim for ``d``, as the op
    pads it (``fa.padded_head_dim``)."""
    dp = fa.padded_head_dim(d)
    return x if dp == d else torch.nn.functional.pad(x, (0, dp - d))


def _check_kernels(fa, shape, seed, dtype=torch.bfloat16, causal=True):
    """K1, K2 and K3 against their plain versions on the same inputs, and
    each launched twice on those inputs with bitwise equal results. A head
    dim the kernels are not built at runs zero-padded as the op pads it,
    at its true D's scale, the outputs' first D columns held against the
    plain versions on the unpadded inputs. Returns each kernel's max
    |err|."""
    b, s, h, d = shape
    dp = fa.padded_head_dim(d)
    tag = (f"b{b} s{s} h{h} d{d}{'' if dp == d else f' (padded to {dp})'} "
           f"{'bf16' if dtype == torch.bfloat16 else 'f32'}{'' if causal else ' non-causal'}")
    o_bar, grad_bar, lse_tol = ((KERNEL_BAR, KERNEL_BAR, LSE_TOL) if dtype == torch.bfloat16
                                else (F32_O_BAR, F32_GRAD_BAR, F32_LSE_TOL))
    q, k, v, do = _qkv(b, s, h, d, dtype, seed=seed)
    pq, pk, pv, pdo = map(_pack, (q, k, v, do))
    kq, kk, kv, kdo = (_padded(fa, x, d) for x in (pq, pk, pv, pdo))
    scale = d ** -0.5
    plain = "its plain version"
    res = {}

    # K1: O elementwise at the kernel bar, lse at its tolerance
    o, lse = fa.fwd_kernel(kq, kk, kv, causal, scale=scale)
    o = o[..., :d]
    o_ref, lse_ref = fa.fwd_plain(pq, pk, pv, causal)
    torch.cuda.synchronize()
    res["flash_fwd"] = max(_hold(f"K1 flash_fwd O {tag}", o, o_ref, plain, **o_bar),
                           _hold_lse(f"K1 flash_fwd {tag}", lse, lse_ref, lse_tol))
    del o_ref, lse_ref

    # K2 / K3 vs their plain versions on the same (kernel) lse and delta
    delta = (pdo.float() * o.float()).sum(-1)
    dq = fa.dq_kernel(kq, kk, kv, kdo, lse, delta, causal, scale=scale)[..., :d]
    dk, dv = (x[..., :d] for x in fa.dkv_kernel(kq, kk, kv, kdo, lse, delta, causal,
                                                 scale=scale))
    dq_ref = fa.dq_plain(pq, pk, pv, pdo, lse, delta, causal)
    res["flash_dq"] = _hold(f"K2 flash_dq {tag}", dq, dq_ref, plain, **grad_bar)
    del dq_ref
    dk_ref, dv_ref = fa.dkv_plain(pq, pk, pv, pdo, lse, delta, causal)
    res["flash_dkv"] = max(_hold(f"K3 flash_dk {tag}", dk, dk_ref, plain, **grad_bar),
                           _hold(f"K3 flash_dv {tag}", dv, dv_ref, plain, **grad_bar))
    del dk_ref, dv_ref

    # determinism: the checkpoint recompute must reproduce the forward
    # bit for bit (phase 5's identical checksums rest on it)
    o2, lse2 = fa.fwd_kernel(kq, kk, kv, causal, scale=scale)
    dq2 = fa.dq_kernel(kq, kk, kv, kdo, lse, delta, causal, scale=scale)
    dk2, dv2 = fa.dkv_kernel(kq, kk, kv, kdo, lse, delta, causal, scale=scale)
    torch.cuda.synchronize()
    same = {"flash_fwd": torch.equal(o, o2[..., :d]) and torch.equal(lse, lse2),
            "flash_dq": torch.equal(dq, dq2[..., :d]),
            "flash_dkv": torch.equal(dk, dk2[..., :d]) and torch.equal(dv, dv2[..., :d])}
    log(f"bitwise equal across two launches {tag}: {same}")
    check(all(same.values()), f"a kernel is not deterministic {tag}: {same}")
    return res


def _shape(cfg):
    return tuple(cfg[k] for k in ("batch", "seq", "heads", "head_dim"))


def _hold_op(shape, seed, dtype):
    """The autograd op (K1 forward, K2/K3 via backward) against plain
    attention in float32 from the same inputs: OP_BAR for bf16 (the forward
    within 2e-2), the JAX test bars (2e-5 / 3e-4) for float32."""
    q, k, v, do = _qkv(*shape, dtype, seed=seed)
    o_op, *g_op = _op_grads(q, k, v, do, True)
    o_pl, *g_pl = _plain_grads(q, k, v, do, True)
    b, s, h, d = shape
    tag = f"op {'bf16' if dtype == torch.bfloat16 else 'f32'} causal b{b} s{s} h{h} d{d}"
    if dtype == torch.bfloat16:
        err = _max_err(o_op, o_pl)
        log(f"{tag}: max|O-plain_f32|={err:.3e} (tol 2e-2)")
        check(err <= 2e-2, f"{tag}: forward disagrees with plain attention")
        for name, a, r in zip(("dq", "dk", "dv"), g_op, g_pl):
            _hold(f"{tag} {name}", a, r, "plain float32 attention", **OP_BAR)
        return
    err = _max_err(o_op, o_pl)
    log(f"{tag}: max|O-plain|={err:.3e} (tol 2e-5)")
    check(err <= 2e-5, f"{tag}: forward disagrees with plain attention")
    for name, a, r in zip(("dq", "dk", "dv"), g_op, g_pl):
        err = _max_err(a, r)
        log(f"{tag}: max|{name}-plain|={err:.3e} (tol 3e-4) max|ref|={float(r.abs().max()):.3e}")
        check(err <= 3e-4, f"{tag}: {name} disagrees with plain attention")


def phase_kernels():
    """Each kernel against its plain version at each head dim: D 64 at the
    headline shapes, D 128 at the Llama-2-7B width's, D 32 at train_bytes'
    (bf16 and float32), and at a ragged length (S=192, not a multiple of
    128) at all three; at D 128 and 32 also S=320 (K3's last block of 128
    keys half past S; at D 128 non-causal too) and S=1024 (K2's and K3's
    rings wrap), non-causal at both head dims and causal at 32; the
    autograd op against plain
    attention at each head dim; float32 cases at the JAX test bars.
    Returns {(kernel, head dim): max |err|}."""
    from torchft_tpu_torch.ops import flash_attention as fa

    errs = {}
    bf16, f32 = torch.bfloat16, torch.float32
    checks = [(_shape(HEADLINE), 1, bf16, True), ((2, 192, 2, 64), 4, bf16, True),
              (_shape(LLAMA), 5, bf16, True), ((2, 192, 2, 128), 6, bf16, True),
              # K3 at 128: S a multiple of 64, not of its 128 keys a block;
              # K1 at 128 without the mask; K2's last 128-row q-tile half
              # past S without the mask
              ((2, 320, 2, 128), 10, bf16, True), ((2, 1024, 4, 128), 11, bf16, False),
              ((2, 320, 2, 128), 15, bf16, False),
              (_shape(BYTES), 7, bf16, True), (_shape(BYTES), 8, f32, True),
              ((2, 192, 2, 32), 9, bf16, True),
              # K2 and K3 at 32: their rings wrap (S 1024), K3's half-filled
              # last block (S 320)
              ((2, 1024, 4, 32), 12, bf16, True), ((2, 1024, 4, 32), 13, bf16, False),
              ((2, 320, 2, 32), 14, bf16, True)]
    for shape, seed, dtype, causal in checks:
        for name, err in _check_kernels(fa, shape, seed, dtype, causal).items():
            key = (name, shape[3])
            errs[key] = max(errs.get(key, 0.0), err)

    # the op against float32 attention: bf16 at each head dim, float32 at
    # the JAX test bars (causal at the headline shapes holds every tile
    # position, the diagonal blocks and the mask tightly) ...
    for shape, seed, dtype in ((_shape(HEADLINE), 1, torch.bfloat16),
                               ((2, 1024, 8, 128), 5, torch.bfloat16),
                               (_shape(BYTES), 7, torch.bfloat16),
                               (_shape(HEADLINE), 2, torch.float32),
                               (_shape(BYTES), 8, torch.float32)):
        _hold_op(shape, seed, dtype)
    # ... and non-causal float32 at small sizes holds the unmasked loops
    for shape, seed in (((2, 256, 2, 64), 3), ((2, 256, 2, 32), 3)):
        q, k, v, do = _qkv(*shape, torch.float32, seed=seed)
        o_op, *g_op = _op_grads(q, k, v, do, False)
        o_pl, *g_pl = _plain_grads(q, k, v, do, False)
        tag = f"op f32 non-causal b{shape[0]} s{shape[1]} h{shape[2]} d{shape[3]}"
        err = _max_err(o_op, o_pl)
        log(f"{tag}: max|O-plain|={err:.3e} (tol 2e-5)")
        check(err <= 2e-5, f"{tag}: forward disagrees with plain attention")
        for name, a, r in zip(("dq", "dk", "dv"), g_op, g_pl):
            err = _max_err(a, r)
            log(f"{tag}: max|{name}-plain|={err:.3e} (tol 3e-4) "
                f"max|ref|={float(r.abs().max()):.3e}")
            check(err <= 3e-4, f"{tag}: {name} disagrees with plain attention")
    return errs


def phase_small_kernels():
    """K1-K3 at head dims 8 and 16 (the FMA kernels), float32 and bf16,
    against their plain versions at ``SMALL_HELD`` (the tiny preset's
    shape; S 48 causal and not; S 200), and bf16 at head dims 32 and 64
    where S is not a multiple of 64 (the FMA kernels too); the autograd op
    against plain attention at the tiny preset's shape. The bars are the
    float32 and bf16 rows' above. Returns {(kernel, head dim, dtype): max
    |err|}."""
    from torchft_tpu_torch.ops import flash_attention as fa

    errs = {}
    for d in (8, 16):
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            checks = [((b, s, h, d), True) for b, s, h in SMALL_HELD]
            checks.append(((2, 48, 2, d), False))
            for seed, (shape, causal) in enumerate(checks, start=40):
                for name, err in _check_kernels(fa, shape, seed, dtype, causal).items():
                    key = (name, d, tag)
                    errs[key] = max(errs.get(key, 0.0), err)
            _hold_op((8, 16, 2, d), 50 + d, dtype)
    for shape, causal in (((2, 48, 2, 32), True), ((2, 200, 2, 64), True),
                          ((2, 200, 2, 32), False)):
        _check_kernels(fa, shape, 60, torch.bfloat16, causal)
    return errs


# K1-K3 at the shapes the Pallas op takes beyond the earlier slices' (head
# dim 128 in float32 and at any S in bf16, 256 in both types, other head
# dims padded), held against their plain versions: (B, S, H, D), dtype,
# causal, and the kernels entry (SHAPES_TIMED) whose max |err| it feeds
SHAPES_HELD = (
    [((2, s, 2, 128), torch.bfloat16, True, "d128_s16") for s in (16, 100, 1000)]
    + [((2, 100, 2, 128), torch.bfloat16, False, "d128_s16"),
       ((2, 256, 2, 128), torch.float32, True, "d128_f32"),
       ((2, 256, 2, 128), torch.float32, False, "d128_f32"),
       ((2, 200, 2, 128), torch.float32, True, "d128_f32")]
    + [((2, s, 2, 256), dtype, True, label) for s in (128, 200)
       for dtype, label in ((torch.float32, "d256_f32"), (torch.bfloat16, "d256"))]
    # bf16 K1 and K3 at 256 on wgmma: their rings wrap (S 1024), a ragged
    # last tile at an odd BH (S 1000, B1 H3)
    + [((b, s, h, 256), torch.bfloat16, causal, "d256")
       for b, s, h in ((2, 1024, 2), (1, 1000, 3)) for causal in (True, False)]
    + [((2, 192, 2, d), dtype, True, label) for d in (96, 80, 40)
       for dtype, label in ((torch.float32, None), (torch.bfloat16, "d96" if d == 96 else None))]
    # and at phase 23 (c)'s shape, the only path that runs them on the card
    + [((1, 2048, 16, 256), torch.bfloat16, True, "d256")]
)
# the autograd op against float32 attention there (S a multiple of the op's
# 128-row blocks): D 96 (padded) in both types, 128 in float32, 256 in both
SHAPES_OP = (((2, 256, 2, 96), torch.bfloat16), ((2, 256, 2, 96), torch.float32),
             ((2, 256, 2, 128), torch.float32), ((2, 256, 2, 256), torch.bfloat16),
             ((2, 256, 2, 256), torch.float32))


def phase_shape_kernels():
    """K1-K3 at every shape the Pallas op takes up to head dim 256, on the
    card: C's and Python's ``supported`` agree over head dims 1-300 in both
    types; each of ``SHAPES_HELD`` against the plain versions (the bf16
    and float32 bars above; a padded head dim as the op pads it, at its
    true scale); the op at bf16 D 128 S 96 with 32-row blocks and each of
    ``SHAPES_OP`` against float32 attention (``_hold_op``); head dim 257
    refused by the op. Returns {label: {kernel: max |err|}}."""
    from torchft_tpu_torch.ops import flash_attention as fa

    lib = fa._load()
    grid = [(code, dtype, d, s) for code, dtype in ((0, torch.float32), (1, torch.bfloat16))
            for d in range(1, 301) for s in (1, 16, 100, 1000, 4096, 65535 * 64, 65536 * 64)]
    disagree = [(str(dtype), d, s) for code, dtype, d, s in grid
                if bool(lib.tft_flash_supported(code, d, s)) != fa.supported(dtype, d, s)]
    edge = {(code, d): bool(lib.tft_flash_supported(code, d, 100))
            for code in (0, 1) for d in (256, 257)}
    log(f"supported: C and Python agree on {len(grid) - len(disagree)} of {len(grid)} "
        f"(dtype, head dim 1-300, S) cases; C at head dims 256 and 257: {edge}")
    check(not disagree, f"supported: C and Python disagree at {disagree[:8]}")
    check(edge == {(0, 256): True, (0, 257): False, (1, 256): True, (1, 257): False},
          "supported: the C predicate does not take exactly the head dims up to 256")
    errs = {}
    for seed, (shape, dtype, causal, label) in enumerate(SHAPES_HELD, start=80):
        for name, err in _check_kernels(fa, shape, seed, dtype, causal).items():
            if label is not None:
                errs.setdefault(label, {})
                errs[label][name] = max(errs[label].get(name, 0.0), err)
    # the op at the Pallas op's smaller blocks: S 96, a multiple of 32 (and
    # not of the kernels' 64-row tiles)
    q, k, v, do = _qkv(2, 96, 2, 128, torch.bfloat16, seed=95)
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    o = fa.flash_attention(qs, ks, vs, causal=True, block_q=32, block_k=32)
    o.backward(do)
    o_pl, *g_pl = _plain_grads(q, k, v, do, True)
    tag = "op bf16 causal b2 s96 h2 d128, blocks 32"
    err = _max_err(o, o_pl)
    log(f"{tag}: max|O-plain_f32|={err:.3e} (tol 2e-2)")
    check(err <= 2e-2, f"{tag}: forward disagrees with plain attention")
    for name, a, r in zip(("dq", "dk", "dv"), (qs.grad, ks.grad, vs.grad), g_pl):
        _hold(f"{tag} {name}", a, r, "plain float32 attention", **OP_BAR)
    for seed, (shape, dtype) in enumerate(SHAPES_OP, start=96):
        _hold_op(shape, seed, dtype)
    try:
        x = torch.zeros(1, 128, 1, 257, device="cuda", dtype=torch.bfloat16)
        fa.flash_attention(x, x, x)
        refused = False
    except ValueError:
        refused = True
    log(f"op at head dim 257: refused {refused}")
    check(refused, "flash_attention took head dim 257")
    return errs


def _check_kernels_chunked(fa, shape, seed, chunk):
    """K1-K3 at a length whose [S, S] scores do not fit, with dO random on
    every row, held over query chunks of ``chunk`` rows: O, lse and dQ
    against the plain versions chunk by chunk (``rows=``), dK and dV
    against the chunks' float32 sum, at the kernel bars (the median |ref|
    printed for O, lse and dQ is the largest chunk's). Each kernel launched
    twice is bitwise equal. Returns each kernel's max |err|."""
    b, s, h, d = shape
    tag = f"b{b} s{s} h{h} d{d} bf16, {s // chunk} chunks of {chunk} query rows"
    q, k, v, do = _qkv(b, s, h, d, torch.bfloat16, seed=seed)
    pq, pk, pv, pdo = map(_pack, (q, k, v, do))
    del q, k, v, do
    plain = "its plain version by chunk"
    o, lse = fa.fwd_kernel(pq, pk, pv, True)
    delta = (pdo.float() * o.float()).sum(-1)
    dq = fa.dq_kernel(pq, pk, pv, pdo, lse, delta, True)
    dk, dv = fa.dkv_kernel(pq, pk, pv, pdo, lse, delta, True)
    worst = {}  # what: (max |err|, worst err/bar, median |ref|, max |ref|)
    lse_err = 0.0
    dk_ref = dv_ref = 0
    for r0 in range(0, s, chunk):
        rows = (r0, min(s, r0 + chunk))
        o_ref, lse_ref = fa.fwd_plain(pq, pk, pv, True, rows=rows)
        lse_err = max(lse_err, _max_err(lse[:, rows[0]:rows[1]], lse_ref))
        parts = {"o": _errs(o[:, rows[0]:rows[1]], o_ref, **KERNEL_BAR)}
        del o_ref, lse_ref
        parts["dq"] = _errs(dq[:, rows[0]:rows[1]],
                            fa.dq_plain(pq, pk, pv, pdo, lse, delta, True, rows=rows),
                            **KERNEL_BAR)
        for what, e in parts.items():
            worst[what] = tuple(max(x, y) for x, y in zip(worst.get(what, e), e))
        dk_r, dv_r = fa.dkv_plain(pq, pk, pv, pdo, lse, delta, True, rows=rows,
                                  out_dtype=torch.float32)
        dk_ref, dv_ref = dk_ref + dk_r, dv_ref + dv_r
        del dk_r, dv_r
    res = {"flash_fwd": max(_hold(f"K1 flash_fwd O {tag}", None, None, plain, **KERNEL_BAR,
                                  errs=worst["o"]),
                            _hold_lse(f"K1 flash_fwd {tag}", None, None, err=lse_err)),
           "flash_dq": _hold(f"K2 flash_dq {tag}", None, None, plain, **KERNEL_BAR,
                             errs=worst["dq"])}
    res["flash_dkv"] = max(_hold(f"K3 flash_dk {tag}", dk, dk_ref, "the chunks' sum", **KERNEL_BAR),
                           _hold(f"K3 flash_dv {tag}", dv, dv_ref, "the chunks' sum", **KERNEL_BAR))
    del dk_ref, dv_ref
    o2, lse2 = fa.fwd_kernel(pq, pk, pv, True)
    dq2 = fa.dq_kernel(pq, pk, pv, pdo, lse, delta, True)
    dk2, dv2 = fa.dkv_kernel(pq, pk, pv, pdo, lse, delta, True)
    torch.cuda.synchronize()
    same = {"flash_fwd": torch.equal(o, o2) and torch.equal(lse, lse2),
            "flash_dq": torch.equal(dq, dq2),
            "flash_dkv": torch.equal(dk, dk2) and torch.equal(dv, dv2)}
    log(f"bitwise equal across two launches {tag}: {same}")
    check(all(same.values()), f"a kernel is not deterministic {tag}: {same}")
    return res


def phase_long_kernels():
    """Phase 2 at the long-context bench's lengths, head dim 64: K1-K3 whole
    against their plain versions at ``LONG_HELD_WHOLE``, and over query
    chunks of ``LONG_PLAIN_CHUNK`` rows at ``LONG_HELD_CHUNKED``. Returns
    {(kernel, S): max |err|}."""
    from torchft_tpu_torch.ops import flash_attention as fa

    errs = {}
    for seed, shape in enumerate(LONG_HELD_WHOLE + LONG_HELD_CHUNKED, start=16):
        held = (_check_kernels(fa, shape, seed) if shape in LONG_HELD_WHOLE
                else _check_kernels_chunked(fa, shape, seed, LONG_PLAIN_CHUNK))
        for name, err in held.items():
            errs[(name, shape[1])] = err
        gc.collect()
        torch.cuda.empty_cache()
    return errs


def _plain_chunked(plain, x, chunk, summed):
    """A kernel's plain version over query chunks of ``chunk`` rows, with
    dK and dV (``summed``) added up over the chunks: the same work where the
    [S, S] scores do not fit at once."""
    s = x[0].shape[1]
    parts = [plain(x, (r0, min(s, r0 + chunk))) for r0 in range(0, s, chunk)]
    if summed:
        return tuple(sum(p[i].float() for p in parts) for i in range(2))
    return parts


def _bounds(shape, dtype=torch.bfloat16):
    """Least time for each kernel's work at ``shape`` (B, S, H, D; causal)
    in ``dtype``: the bytes it must move (inputs read once, outputs written
    once) over HBM rate, and the causal matmul FLOPs these inputs need over
    the card's peak for the type (bf16 on the tensor cores, float32
    outside them)."""
    b, s, h, d = shape
    bh = b * h
    tensor = bh * s * d * torch.empty(0, dtype=dtype).element_size()  # one [BH,S,D]
    row = bh * s * 4  # one f32 [BH,S]
    pairs = bh * s * (s + 1) // 2  # causal (q, k) pairs
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    work = {  # (matmuls of 2*D flops per pair, bytes)
        "flash_fwd": (2, 4 * tensor + row),  # q,k,v in; o, lse out
        "flash_dq": (3, 5 * tensor + 2 * row),  # q,k,v,dO,lse,delta in; dq out
        "flash_dkv": (4, 6 * tensor + 2 * row),  # ... in; dk, dv out
    }
    out = {}
    for name, (mms, nbytes) in work.items():
        flops = mms * 2 * d * pairs
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        out[name] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
                     flops, nbytes)
    return out


COLD_SETS = 4  # input sets rotated for L2-cold times: 135-200 MB at D 64, over the 50 MB L2


def _sdpa_backend(q, k, v) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these [B, H, S,
    D] inputs, causal (PyTorch's own choice function; "unknown" where this
    build has none)."""
    try:
        from torch.nn.attention import SDPBackend

        return SDPBackend(torch._fused_sdp_choice(q, k, v, is_causal=True)).name
    except (AttributeError, RuntimeError, TypeError, ValueError) as e:  # a private function
        return f"unknown ({type(e).__name__})"


def phase_timing(shape, plain_chunk=None, plain_reps=25, dtype=torch.bfloat16, reps=25,
                 inner=5, earlier=EARLIER_GRAPH_MS):
    """Each kernel's time at ``shape`` (``dtype``, causal), launched eagerly
    (``ms``, the method of the first slice's records); its device time
    replayed from a CUDA graph with its inputs warm (one set, called back
    to back: ``ms_graph``) and L2-cold (``COLD_SETS`` independent sets in
    turn: ``ms_cold``; at D 32 all sets fit in the L2); its host cost per
    call; its plain version's time (median of ``plain_reps``; over query
    chunks of ``plain_chunk`` rows when given); and the
    ``scaled_dot_product_attention`` yardsticks, each by both methods, with
    the backend SDPA picked. ``reps`` x ``inner`` launches time a kernel (a
    few at the FMA kernels' slow shapes). A head dim the kernels are not
    built at runs zero-padded, as the op pads it (the bound counts the true
    head dim's work). ``earlier``: the earlier designs' times printed
    beside, by (kernel, head dim), and by (kernel, head dim, "f32") for
    float32. Returns (times, bounds, SDPA forward
    (eager, graph))."""
    import torch.nn.functional as F

    from torchft_tpu_torch.ops import flash_attention as fa

    b, s, h, d = shape
    scale = d ** -0.5
    sets = []
    for seed in range(3, 3 + COLD_SETS):
        q, k, v, do = _qkv(b, s, h, d, dtype, seed=seed)
        pq, pk, pv, pdo = (_padded(fa, _pack(x), d) for x in (q, k, v, do))
        o, lse = fa.fwd_kernel(pq, pk, pv, True, scale=scale)
        delta = (pdo.float() * o.float()).sum(-1)
        sets.append((pq, pk, pv, pdo, lse, delta))
    tiny = [x[:, :128].contiguous() for x in sets[0]]  # device keeps up: host cost
    calls = {
        "flash_fwd": (lambda x: fa.fwd_kernel(*x[:3], True, scale=scale),
                      lambda x, rows=None: fa.fwd_plain(*x[:3], True, rows=rows, scale=scale)),
        "flash_dq": (lambda x: fa.dq_kernel(*x, True, scale=scale),
                     lambda x, rows=None: fa.dq_plain(*x, True, rows=rows, scale=scale)),
        "flash_dkv": (lambda x: fa.dkv_kernel(*x, True, scale=scale),
                      lambda x, rows=None: fa.dkv_plain(*x, True, rows=rows, scale=scale)),
    }
    t = {}
    for name, (kernel, plain) in calls.items():
        whole = ((lambda: plain(sets[0])) if plain_chunk is None
                 else (lambda: _plain_chunked(plain, sets[0], plain_chunk,
                                              summed=name == "flash_dkv")))
        t[name] = dict(
            ms=gpu_time_ms(lambda: kernel(sets[0]), reps=reps, inner=inner),
            ms_graph=gpu_time_ms(lambda: kernel(sets[0]), reps=reps, inner=inner, graph=True),
            ms_cold=gpu_time_ms([lambda x=x: kernel(x) for x in sets], reps=reps, inner=inner,
                                graph=True),
            host_us=host_us_per_call(lambda: kernel(tiny)),
            plain_ms=gpu_time_ms(whole, reps=plain_reps,
                                 inner=1 if plain_chunk or inner == 1 else 5),
        )
    del sets, tiny

    # yardsticks only: PyTorch's own fused attention, never called by the port
    q, k, v, do = _qkv(b, s, h, d, dtype, seed=3)
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (qh, kh, vh))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        return torch.autograd.grad(o, (qg, kg, vg), doh)

    sdpa = {  # (eager, CUDA graph)
        "fwd": (gpu_time_ms(sdpa_fwd, reps=reps, inner=inner),
                gpu_time_ms(sdpa_fwd, reps=reps, inner=inner, graph=True)),
        "fwd_bwd": (gpu_time_ms(sdpa_fwd_bwd, reps=reps, inner=inner),
                    gpu_time_ms(sdpa_fwd_bwd, reps=reps, inner=inner, graph=True)),
    }
    bounds = _bounds(shape, dtype)
    dp = fa.padded_head_dim(d)
    tag = (f"b{b} s{s} h{h} d{d}" + ("" if dp == d else f" (padded to {dp})")
           + ("" if dtype == torch.bfloat16 else " f32"))
    log(f"sdpa(is_causal) {tag}: backend {_sdpa_backend(qh, kh, vh)}")
    for name, r in t.items():
        bound, by, flops, nbytes = bounds[name]
        key = (name, d) if dtype == torch.bfloat16 else (name, d, "f32")
        before = ("" if key not in earlier
                  else f" (earlier design {earlier[key]:.4f} ms)")
        chunks = "" if plain_chunk is None else f" (query chunks of {plain_chunk} rows)"
        log(f"{name} {tag}: {r['ms']:.4f} ms eager (host launches included); CUDA graph "
            f"(device time) {r['ms_graph']:.4f} ms warm{before}, {r['ms_cold']:.4f} ms "
            f"L2-cold; host {r['host_us']:.1f} us/call; plain {r['plain_ms']:.4f} ms{chunks}; "
            f"bound "
            f"{bound:.3g} ms by {by}: {flops / 1e9:.3g} GFLOP, {nbytes / 1e6:.3g} MB")
    for i, method in enumerate(("eager", "CUDA graph")):
        fwd, both = sdpa["fwd"][i], sdpa["fwd_bwd"][i]
        key = "ms" if i == 0 else "ms_graph"
        ours = {n: t[n][key] for n in t}
        log(f"sdpa(is_causal) {tag}, {method}: forward {fwd:.4f} ms, forward+backward "
            f"{both:.4f} ms vs flash fwd+dq+dkv {sum(ours.values()):.4f} ms; backward alone "
            f"(fwd+bwd - fwd) {both - fwd:.4f} ms vs flash dq+dkv "
            f"{ours['flash_dq'] + ours['flash_dkv']:.4f} ms")
    return t, bounds, sdpa["fwd"]


# ---------------------------------------------------------------------------
# phase 4 / 5: the fault-tolerant training step
# ---------------------------------------------------------------------------


def headline_config():
    # one definition, shared with phase 12's worker processes
    from torchft_tpu_torch.models.transformer import headline_config

    return headline_config()


def llama_config(n_layers=LLAMA_LAYERS):
    """The Llama-2-7B preset's widths (examples/train_hsdp.py:68-75) at
    ``n_layers`` of its 32, bf16, attention by ``"auto"`` (the kernels at
    head dim 128)."""
    from torchft_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        vocab_size=32000, d_model=4096, n_layers=n_layers, n_heads=32, head_dim=128,
        d_ff=11008, dtype=torch.bfloat16, attention_impl="auto",
    )


def bytes_config():
    """examples/train_bytes.py's model (:104-112) in bf16, its accelerator
    dtype, attention by ``"auto"`` (the kernels at head dim 32)."""
    from torchft_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        vocab_size=256, d_model=128, n_layers=2, n_heads=4, head_dim=32, d_ff=352,
        dtype=torch.bfloat16, attention_impl="auto",
    )


def make_tokens(cfg, seed, batch, seq):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq))).to("cuda")


def make_manager(lighthouse_addr, store, replica_id, plane="device", transport="http",
                 native_plane=None, **kwargs):
    """The headline loop's Manager. ``plane``: ``"device"`` (CollectivesDevice
    on the card, the headline's wiring) or ``"tcp"`` (CollectivesTcp, on
    its native plane unless ``native_plane=False``: the Python ring);
    ``transport``: the heal over ``"http"`` or over the data plane
    (``"collectives"``); ``kwargs`` go to the Manager (``use_async_quorum``,
    ``commit_pipeline``)."""
    from torchft_tpu_torch.checkpointing import CollectivesTransport, HTTPTransport
    from torchft_tpu_torch.collectives import CollectivesTcp
    from torchft_tpu_torch.collectives_device import CollectivesDevice
    from torchft_tpu_torch.manager import Manager

    timeout = timedelta(seconds=120)
    if plane == "tcp":
        collectives = CollectivesTcp(timeout=timeout, native_plane=native_plane)
    else:
        collectives = CollectivesDevice(timeout=timeout)
    heal = {"http": lambda: HTTPTransport(timeout=timeout),
            "collectives": lambda: CollectivesTransport(collectives, timeout=timeout)}
    return Manager(
        collectives=collectives,
        load_state_dict=None,
        state_dict=None,
        min_replica_size=1,
        replica_id=replica_id,
        store_addr=store.address(),
        rank=0,
        world_size=1,
        lighthouse_addr=lighthouse_addr,
        timeout=timeout,
        checkpoint_transport=heal[transport](),
        **kwargs,
    )


def _headline_run(plane, graph=True, warmup=2, steps=5, profile=False):
    """The headline loop on one plane, its step replayed from CUDA graphs
    or (``graph=False``) run eagerly: returns (steps/s, launches over the
    timed steps, the losses of every step, a copy of the final params).
    With ``profile``, one more step runs under ``torch.profiler`` and the
    flash kernels it names are held to the launches counted."""
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.parallel import ft
    from torchft_tpu_torch.parallel.train_step import TrainStep
    from torchft_tpu_torch.store import StoreServer
    from torchft_tpu_torch.utils.tree import tree_leaves

    cfg = headline_config()
    batch, seq = HEADLINE["batch"], HEADLINE["seq"]
    arm = f"{plane} plane, {'graphed' if graph else 'eager'}"
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1)
    store = StoreServer()
    manager = make_manager(lighthouse.address(), store, f"smoke-{plane}", plane=plane)
    average = ft.allreduce_gradients
    handed_back = []

    def same_tensors(mgr, grads):
        out = average(mgr, grads)
        handed_back.append(all(a is b for a, b in zip(tree_leaves(out), tree_leaves(grads))))
        return out

    ft.allreduce_gradients = same_tensors
    try:
        check(manager.device_data_plane() == (plane == "device"),
              f"the {plane} plane's Manager reports device_data_plane() wrongly")
        ts = TrainStep(cfg, device="cuda", graph=graph)
        trainer = ft.FTTrainer(manager, ts)
        trainer.init(seed=0)
        tokens = make_tokens(cfg, 0, batch, seq)
        losses = []
        for i in range(warmup):
            loss, committed = trainer.step(tokens)
            log(f"{arm} warmup step {i}: loss={loss:.5f} committed={committed}")
            check(committed, f"a warm-up step did not commit ({arm})")
            losses.append(loss)
        torch.cuda.synchronize()
        fa.reset_launches()
        t0 = time.perf_counter()
        for _ in range(steps):
            loss, committed = trainer.step(tokens)
            check(committed, f"a headline step did not commit ({arm})")
            losses.append(loss)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        final = [p.detach().clone() for p in tree_leaves(trainer.params)]
        if graph:
            check(ts.graphs.captures == {"grads": 1, "apply": 1},
                  f"{arm}: graphs captured {ts.graphs.captures}, expected one of each")
        if profile:
            _profile_step(trainer, tokens, cfg)
    finally:
        ft.allreduce_gradients = average
        manager.shutdown(wait=False)
        store.shutdown()
        lighthouse.shutdown()
    log(f"{arm} steps: losses {', '.join(f'{x:.5f}' for x in losses)}")
    check(all(np.isfinite(losses)), "non-finite loss")
    # one group: the device plane's average is the identity, the TCP one
    # copies down to the host and back
    check(len(handed_back) >= warmup + steps and all(handed_back) == (plane == "device"),
          f"{arm}: allreduce_gradients handed back {handed_back} (the very "
          "gradient tensors: True)")
    per_step = {n: c / steps for n, c in launches.items()}
    expect = _launches_per_step(cfg)
    log(f"{arm} kernel launches per step: {per_step}")
    check(per_step == expect, f"{arm} launches per step {per_step} != {expect}")
    return steps / elapsed, launches, losses, final


def _profile_step(trainer, tokens, cfg):
    """One more step under ``torch.profiler``: the flash kernels it saw on
    the device, by name, against the launches counted for it."""
    from torch.profiler import ProfilerActivity, profile

    from torchft_tpu_torch.ops import flash_attention as fa

    torch.cuda.synchronize()
    fa.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.step(tokens)
        torch.cuda.synchronize()
    counted = dict(fa.LAUNCHES)
    names = [e.name for e in prof.events()
             if e.device_type.name == "CUDA" and not e.is_user_annotation]
    seen = {n: sum(f"{n}_wgmma" in name for name in names) for n in counted}
    log(f"profiled graphed step: {len(names)} device events; flash kernels by name {seen}, "
        f"launches counted {counted}")
    check(seen == counted == _launches_per_step(cfg),
          f"the profiler saw {seen} flash kernels, the counts say {counted}")


def phase_ft_loop():
    """The headline loop: graphed on the device plane and on the TCP plane,
    eager on the device plane, each from 2 warm-up + 5 timed steps, in turns
    over 2 rounds (device graphed, device eager, tcp graphed; then the
    reverse) so that no arm always runs first. The first device-plane
    graphed run's losses and final params equal the first eager run's bit
    for bit, and it profiles one more step. Returns the launches of the
    first device-plane graphed run (the main path's)."""
    batch, seq = HEADLINE["batch"], HEADLINE["seq"]
    arms = [("device", True), ("device", False), ("tcp", True)]
    sps = {arm: [] for arm in arms}
    first = {}
    main_launches = None
    for order in (arms, arms[::-1]):
        for plane, graph in order:
            main = plane == "device" and graph and main_launches is None
            rate, launches, losses, final = _headline_run(plane, graph, profile=main)
            gc.collect()  # the run's graphs and their pool
            sps[(plane, graph)].append(rate)
            if main:
                main_launches = launches
            if plane == "device" and graph not in first:
                first[graph] = (losses, final)
            log(f"headline FT loop, {plane} plane, {'graphed' if graph else 'eager'}: "
                f"{rate:.4f} steps/s, {rate * batch * seq:.1f} tokens/s (5 steps, batch "
                f"{batch} x seq {seq})")
    (l_graph, p_graph), (l_eager, p_eager) = first[True], first[False]
    same_params = all(torch.equal(a, b) for a, b in zip(p_graph, p_eager))
    worst = max(float((a - b).abs().max()) for a, b in zip(p_graph, p_eager))
    log(f"graphed vs eager step, device plane: 7 losses equal bitwise {l_graph == l_eager}, "
        f"final params equal bitwise {same_params} (max |diff| {worst:.3e})")
    check(l_graph == l_eager and same_params,
          "the graphed step disagrees with the eager step (bar: bit for bit, the same "
          "kernels on the same inputs)")
    names = {"device": "CollectivesDevice", "tcp": "CollectivesTcp"}
    for (plane, graph), rates in sps.items():
        log(f"headline steps/s, {plane} plane ({names[plane]}), "
            f"{'graphed' if graph else 'eager'}, rounds 1 and 2: "
            f"{', '.join(f'{r:.4f}' for r in rates)}")
    return main_launches


REMAT = {"all": (True, "all"), "dots": (True, "dots"), "none": (False, "all")}


def _held_bytes_per_layer(remat, policy):
    """Device memory that one layer's forward leaves held for its backward
    at the headline's widths and shapes: what the forward of 2 layers holds
    less what the forward of 1 holds (the loss kept alive, no backward)."""
    from torchft_tpu_torch.models.transformer import loss_fn
    from torchft_tpu_torch.parallel.train_step import TrainStep

    held = []
    for layers in (1, 2):
        cfg = dataclasses.replace(headline_config(), n_layers=layers, remat=remat,
                                  remat_policy=policy)
        ts = TrainStep(cfg, device="cuda", graph=False)
        params = ts.init_params(0)
        for p in params["layers"].values():
            p.requires_grad_(True)
        tokens = make_tokens(cfg, 0, HEADLINE["batch"], HEADLINE["seq"])
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        loss = loss_fn(params, tokens, cfg)
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated() - before)
        del loss, params, ts
    return held[1] - held[0]


def phase_remat(steps=3):
    """The graphed headline step (``TrainStep.step``, one group, no
    Manager) under each ``remat`` policy: flash launches per replayed step
    (2L/L/L under "all" and "dots", L/L/L without remat), the losses of
    1 + ``steps`` steps bitwise equal across policies (a recompute changes
    no value), and the bytes a layer's forward holds for the backward."""
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.parallel.train_step import TrainStep

    losses = {}
    for name, (remat, policy) in REMAT.items():
        cfg = dataclasses.replace(headline_config(), remat=remat, remat_policy=policy)
        ts = TrainStep(cfg, device="cuda")
        params = ts.init_params(0)
        opt = ts.init_opt(params)
        tokens = make_tokens(cfg, 0, HEADLINE["batch"], HEADLINE["seq"])
        out = [float(ts.step(params, opt, tokens)[0])]  # eager, then captured
        torch.cuda.synchronize()
        fa.reset_launches()
        t0 = time.perf_counter()
        for _ in range(steps):
            out.append(float(ts.step(params, opt, tokens)[0]))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
        per_step = {n: c / steps for n, c in fa.LAUNCHES.items()}
        n = cfg.n_layers
        expect = {"flash_fwd": (2 if remat else 1) * n, "flash_dq": n, "flash_dkv": n}
        held = _held_bytes_per_layer(remat, policy)
        log(f"remat {name}: launches per step {per_step}; {ms:.3f} ms per graphed step "
            f"(host clock, no Manager); a layer's forward holds {held / 1e6:.1f} MB for the "
            f"backward; losses {', '.join(f'{x:.5f}' for x in out)}")
        check(per_step == expect, f"remat {name}: launches per step {per_step} != {expect}")
        losses[name] = out
        del ts, params, opt
        gc.collect()
        torch.cuda.empty_cache()
    check(losses["all"] == losses["dots"] == losses["none"],
          f"the remat policies' losses differ: {losses}")


def _launches_per_step(cfg):
    # forward (+ its checkpoint recompute under remat) per layer; one
    # backward per layer
    return {"flash_fwd": (2 if cfg.remat else 1) * cfg.n_layers, "flash_dq": cfg.n_layers,
            "flash_dkv": cfg.n_layers}


def _param_digest(params) -> str:
    from torchft_tpu_torch.utils.tree import tree_leaves

    h = hashlib.sha256()
    for leaf in tree_leaves(params):
        h.update(leaf.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _keep_average(manager, kept):
    """Keep copies of one joint step's gradients in ``kept``: this group's
    (``pre``) and what the Manager averaged them to (``post``), at the first
    step where both groups take part on a two-group plane."""
    average = manager.allreduce_many

    def keeping(tensors):
        fut = average(tensors)
        if ("post" not in kept and manager.num_participants() == 2
                and manager.is_participating() and manager._collectives.size() == 2):
            reduced = fut.wait()  # resolved with this group's stream current
            kept.update(step=manager.current_step(),
                        pre=[t.detach().clone() for t in tensors],
                        post=[t.detach().clone() for t in reduced])
        return fut

    manager.allreduce_many = keeping


def _time_apply(trainer, heal):
    """Record the wall ms of applying a received state (set before
    ``init``, which registers the trainer's ``load_state_dict``)."""
    load = trainer.load_state_dict

    def timed(state):
        t0 = time.perf_counter()
        load(state)
        torch.cuda.current_stream().synchronize()
        heal["apply_ms"] = (time.perf_counter() - t0) * 1e3

    trainer.load_state_dict = timed


def phase_two_groups(plane="tcp", transport="http", own_streams=False, together=3, cfg=None,
                     shape=HEADLINE):
    """Two groups as threads on the card; the second joins late and heals
    from the first, then both commit ``together`` steps. The TCP plane is
    the Python ring (``native_plane=False``), so that its joint step
    compares with phase 12's and with earlier runs of this phase. With
    ``own_streams`` each group runs on a CUDA stream of its own and keeps
    one joint step's gradients (``_keep_average``). The model is ``cfg``
    (the headline's by default) at ``shape``'s batch and seq. Returns the
    heal's and the joint steps' numbers, the kept gradients and the kernel
    launches."""
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.parallel.ft import FTTrainer
    from torchft_tpu_torch.parallel.train_step import TrainStep, synchronize
    from torchft_tpu_torch.store import StoreServer

    cfg = cfg or headline_config()
    batch, seq = shape["batch"], shape["seq"]
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1)
    first_commit = threading.Event()
    calls = {0: 0, 1: 0}  # trainer.step calls per group
    tag = f"{plane}/{transport} hd{cfg.head_dim}"

    def group(gid: int):
        try:
            if gid == 1 and not first_commit.wait(timeout=600):
                raise TimeoutError("group 0 never committed")
            stream = torch.cuda.Stream() if own_streams else None
            with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                return member(gid)
        finally:
            first_commit.set()

    def member(gid: int):
        store = StoreServer()
        manager = make_manager(lighthouse.address(), store, f"{plane}-group{gid}",
                               plane=plane, transport=transport, native_plane=False)
        heal, kept, joint_ms = {}, {}, []
        _time_heal(manager, heal)
        if own_streams:
            _keep_average(manager, kept)
        try:
            ts = TrainStep(cfg, device="cuda")
            trainer = FTTrainer(manager, ts)
            _time_apply(trainer, heal)
            trainer.init(seed=100 + gid)  # different inits: the heal must matter
            tokens = make_tokens(cfg, 10 + gid, batch, seq)
            joint = healed_at = 0
            while joint < together:
                step_before = manager.current_step()
                t0 = time.perf_counter()
                loss, committed = trainer.step(tokens)
                torch.cuda.current_stream().synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                calls[gid] += 1
                if gid == 1 and manager.current_step() > step_before + 1:
                    healed_at = manager.current_step()
                if committed and manager.num_participants() == 2:
                    joint += 1
                    joint_ms.append(ms)
                if gid == 0 and committed:
                    first_commit.set()
                log(f"{tag} group{gid}: step={manager.current_step()} loss={loss:.5f} "
                    f"committed={committed} participants={manager.num_participants()} "
                    f"{ms:.3f} ms")
            synchronize()
            return dict(step=manager.current_step(), digest=_param_digest(trainer.params),
                        healed_at=healed_at, heal=heal, kept=kept, joint_ms=joint_ms,
                        captures=dict(ts.graphs.captures),
                        plane=manager._collectives.plane_info())
        finally:
            manager.shutdown(wait=False)
            store.shutdown()

    torch.cuda.synchronize()
    fa.reset_launches()
    try:
        res = _run_threads(group, f"two-group phase ({tag})")
    finally:
        lighthouse.shutdown()
    for gid in (0, 1):
        r = res[gid]
        log(f"{tag} group{gid} step={r['step']} checksum={r['digest']}"
            + (f" (healed to step {r['healed_at']})" if gid == 1 else "")
            + f"; plane {r['plane']}")
    check(res[1]["healed_at"] > 0, f"{tag}: group 1 never healed from group 0")
    # group 1 captured its graphs on its own init at its first step, before
    # the heal landed: one capture each means the heal kept every tensor
    log(f"{tag} graphs captured: group0 {res[0]['captures']}, group1 {res[1]['captures']}")
    check(all(res[g]["captures"] == {"grads": 1, "apply": 1} for g in (0, 1)),
          f"{tag}: a group captured its graphs again (a heal swapped a captured tensor?)")
    check(res[0]["step"] == res[1]["step"] and res[0]["digest"] == res[1]["digest"],
          f"{tag}: groups ended with different parameters")
    heal = dict(res[1]["heal"], serve_ms=res[0]["heal"].get("serve_ms"))
    check("apply_ms" in heal and "get_ms" in heal and heal["serve_ms"] is not None,
          f"{tag}: group 1's heal was not timed")
    joint_ms = res[0]["joint_ms"] + res[1]["joint_ms"]
    out = dict(heal=heal, joint_ms=statistics.median(joint_ms),
               kept={g: res[g]["kept"] for g in (0, 1)})
    log(f"{tag} heal: {heal['bytes']} bytes of tensors, transfer {heal['get_ms']:.3f} ms "
        f"({heal['bytes'] / heal['get_ms'] / 1e6:.3f} GB/s), group 0's send_checkpoint "
        f"{heal['serve_ms']:.3f} ms, apply {heal['apply_ms']:.3f} ms; joint steps "
        f"{out['joint_ms']:.3f} ms median wall per step (both groups, {len(joint_ms)} steps)")
    # every step of either group, committed or not, runs forward + backward
    launches = dict(fa.LAUNCHES)
    expect = {n: c * (calls[0] + calls[1]) for n, c in _launches_per_step(cfg).items()}
    log(f"{tag} two groups: {calls[0]} + {calls[1]} steps, kernel launches {launches}")
    check(launches == expect, f"{tag} two-group launches {launches} != {expect}")
    out["launches"] = launches
    return out


def phase_device_groups(tcp):
    """Phase 5 over the device plane, each group on its own CUDA stream,
    healing over CollectivesTransport; then the averaging check and the
    reduction's device time, printed beside ``tcp`` (phase 5's numbers)."""
    from torchft_tpu_torch import collectives_device as cd
    from torchft_tpu_torch.collectives import ReduceOp

    res = phase_two_groups(plane="device", transport="collectives", own_streams=True)
    dev_heal, tcp_heal = res["heal"], tcp["heal"]

    def heal_line(h):
        return (f"{h['bytes']} bytes, transfer {h['get_ms']:.3f} ms, send_checkpoint "
                f"{h['serve_ms']:.3f} ms, apply {h['apply_ms']:.3f} ms")

    log(f"heal over CollectivesTransport (device plane): {heal_line(dev_heal)}; "
        f"phase 5 over HTTP: {heal_line(tcp_heal)}")
    log(f"joint step wall, median: device plane {res['joint_ms']:.3f} ms, phase 5's TCP "
        f"plane {tcp['joint_ms']:.3f} ms (two groups share the card)")

    # the averaging check: each group's averaged gradients against the
    # plain mean of both groups' saved gradients, bit for bit
    k0, k1 = res["kept"][0], res["kept"][1]
    check("post" in k0 and "post" in k1, "device plane: no joint step's gradients kept")
    check(k0["step"] == k1["step"], f"kept steps differ: {k0['step']} vs {k1['step']}")
    torch.cuda.synchronize()
    equal = all(torch.equal(a, (g0 + g1) / 2) and torch.equal(b, (g0 + g1) / 2)
                for a, b, g0, g1 in zip(k0["post"], k1["post"], k0["pre"], k1["pre"]))
    moved = any(not torch.equal(g0, g1) for g0, g1 in zip(k0["pre"], k1["pre"]))
    log(f"averaging check (step {k0['step']}, {len(k0['pre'])} tensors): both groups' "
        f"averaged gradients == plain (g0 + g1) / 2 bitwise: {equal}; the groups' "
        f"gradients differ: {moved}")
    check(equal, "device plane: an averaged gradient differs from the plain mean")
    check(moved, "device plane: both groups had the same gradients; the check saw nothing")

    # the reduction alone, on the kept gradients: the plane's own function
    # (sum in rank order, one result per group), timed between CUDA events
    inputs = {0: k0["pre"], 1: k1["pre"]}
    nbytes = sum(t.numel() * t.element_size() for t in k0["pre"])

    def reduce():
        return cd._compute_allreduce(inputs, (ReduceOp.SUM,))

    eager = gpu_time_ms(reduce, reps=10, inner=3)
    graph = gpu_time_ms(reduce, reps=10, inner=3, graph=True)
    bound = 4 * nbytes / PEAK_BYTES * 1e3
    log(f"reduction of the gradient tree ({nbytes / 1e6:.1f} MB, {len(k0['pre'])} tensors, "
        f"2 groups): {eager:.4f} ms eager (host launches included), {graph:.4f} ms device "
        f"time (CUDA graph); bound {bound:.4f} ms (bytes: reads 2 x {nbytes / 1e6:.1f} MB, "
        f"writes 2 x {nbytes / 1e6:.1f} MB at {PEAK_BYTES / 1e12:.2f} TB/s)")


def _llama_run(cfg, graph, warmup, steps, plain_loss=False):
    """One arm of phase 9 (graphed or eager), from a fresh trainer: returns
    (losses, seconds of the timed steps, launches, peak memory in bytes,
    plain attention's loss of the first step or None)."""
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.models.transformer import loss_fn
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.parallel.ft import FTTrainer
    from torchft_tpu_torch.parallel.train_step import TrainStep
    from torchft_tpu_torch.store import StoreServer
    from torchft_tpu_torch.utils.tree import tree_leaves

    arm = "graphed" if graph else "eager"
    batch, seq = LLAMA["batch"], LLAMA["seq"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1)
    store = StoreServer()
    manager = make_manager(lighthouse.address(), store, f"smoke-llama-{arm}")
    plain = None
    try:
        t0 = time.perf_counter()
        trainer = FTTrainer(manager, TrainStep(cfg, device="cuda", graph=graph))
        trainer.init(seed=0)
        tokens = make_tokens(cfg, 0, batch, seq)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in tree_leaves(trainer.params))
        log(f"llama width ({arm}), {cfg.n_layers} of 32 layers (cut for one card's memory): "
            f"{n_params} params, init {time.perf_counter() - t0:.1f} s")
        if plain_loss:
            with torch.no_grad():
                plain = float(loss_fn(trainer.params, tokens,
                                      dataclasses.replace(cfg, attention_impl="plain")))
        torch.cuda.synchronize()
        fa.reset_launches()
        losses = []
        for i in range(warmup):
            loss, committed = trainer.step(tokens)
            log(f"llama {arm} warmup step {i}: loss={loss:.5f} committed={committed}")
            check(committed, "a llama warm-up step did not commit")
            losses.append(loss)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            loss, committed = trainer.step(tokens)
            check(committed, "a llama step did not commit")
            losses.append(loss)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
    finally:
        manager.shutdown(wait=False)
        store.shutdown()
        lighthouse.shutdown()
    return losses, elapsed, launches, peak, plain


def phase_llama(warmup=2, steps=3):
    """The Llama-2-7B-width FT step (``llama_config``: LLAMA_LAYERS of its
    32 layers) at batch 2 x seq 4096 through the headline's entry points on
    the device plane, graphed, then eagerly from a fresh trainer. Holds the
    graphed arm's first-step loss against the same step's with plain
    attention from the same params and tokens, every step committing,
    finite losses and 8/4/4 launches per step (counted over the warm-up and
    timed steps); prints each arm's step time and peak memory. Returns the
    graphed arm's launches."""
    from torchft_tpu_torch.models.transformer import _use_flash

    cfg = llama_config()
    batch, seq = LLAMA["batch"], LLAMA["seq"]
    check(_use_flash(cfg, seq, torch.device("cuda")),
          "attention_impl='auto' does not route the Llama width to the kernels")
    arms = {}
    for graph in (True, False):
        arms[graph] = _llama_run(cfg, graph, warmup, steps, plain_loss=graph)
        gc.collect()
    losses, elapsed, launches, peak, plain = arms[True]
    log(f"llama steps (graphed): losses {', '.join(f'{x:.5f}' for x in losses)}")
    log(f"llama steps (eager): losses {', '.join(f'{x:.5f}' for x in arms[False][0])}; equal "
        f"to the graphed arm's bitwise: {arms[False][0] == losses}")
    check(all(np.isfinite(losses)) and all(np.isfinite(arms[False][0])),
          "llama: non-finite loss")
    err = abs(losses[0] - plain)
    log(f"llama first step: loss {losses[0]:.5f} through the kernels, {plain:.5f} with plain "
        f"attention from the same params and tokens: |diff| {err:.3e} (tol 1e-2)")
    check(err <= 1e-2, "llama: the flash loss disagrees with plain attention's")
    for graph, (_, _, arm_launches, _, _) in arms.items():
        per_step = {n: c / (warmup + steps) for n, c in arm_launches.items()}
        expect = _launches_per_step(cfg)
        log(f"llama kernel launches per step ({'graphed' if graph else 'eager'}): {per_step}")
        check(per_step == expect, f"llama launches per step {per_step} != {expect}")
    for graph, (_, secs, _, mem, _) in arms.items():
        log(f"llama FT step, {'graphed' if graph else 'eager'}, L{cfg.n_layers} d{cfg.d_model} "
            f"h{cfg.n_heads} hd{cfg.head_dim} ff{cfg.d_ff} vocab {cfg.vocab_size} bf16, batch "
            f"{batch} x seq {seq}, device plane: {steps / secs:.4f} steps/s, "
            f"{steps * batch * seq / secs:.1f} tokens/s ({steps} steps, "
            f"{secs / steps * 1e3:.1f} ms each); peak memory {mem / 1e9:.2f} GB")
    return launches


def _run_threads(target, what, timeout=900):
    """Run ``target(gid)`` for groups 0 and 1 on threads; fail on an error
    or a hang. Returns {gid: result}."""
    results, errors = {}, []

    def wrap(gid):
        try:
            results[gid] = target(gid)
        except Exception as e:  # noqa: BLE001 — reported by the main thread
            errors.append(f"group{gid}: {e!r}")
            print(f"{what}, group{gid}, raised:\n{traceback.format_exc()}", file=sys.stderr,
                  flush=True)

    threads = [threading.Thread(target=wrap, args=(g,)) for g in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=timeout)
    check(not errors, f"{what} failed: {errors}")
    check(all(not th.is_alive() for th in threads), f"{what} hung")
    return results


# ---------------------------------------------------------------------------
# phase 6 / 7: DiLoCo and the pipelined commit
# ---------------------------------------------------------------------------


def _time_quorums(manager, out):
    """Record the wall ms of every ``start_quorum`` (with sync quorum: the
    wait for the other groups and a heal's transfer and apply)."""
    start = manager.start_quorum

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        start(*args, **kwargs)
        out.append((time.perf_counter() - t0) * 1e3)

    manager.start_quorum = timed


def _fail_vote_at(manager, step):
    """Fault injection at the commit vote: latch an error on this group
    just before its vote of ``step`` (once), so the group votes False."""
    prepare = manager._prepare_commit
    fired = []

    def faulty():
        if manager.current_step() == step and not fired:
            fired.append(step)
            manager.report_error(RuntimeError(f"injected fault at the vote of step {step}"))
        return prepare()

    manager._prepare_commit = faulty


def _tensor_digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


SYNC_EVERY = 8  # examples/train_diloco.py's default


def _time_heal(manager, heal):
    """Record the wall ms of the heal's checkpoint fetch and the bytes of
    the tensors it received, and on the serving side the wall ms of
    ``send_checkpoint`` (over HTTP: staging the state; over the data
    plane: staging and sending it)."""
    from torchft_tpu_torch.utils.tree import tree_leaves

    transport = manager._checkpoint_transport
    send = transport.send_checkpoint

    def timed_send(*args, **kwargs):
        t0 = time.perf_counter()
        send(*args, **kwargs)
        heal["serve_ms"] = (time.perf_counter() - t0) * 1e3

    transport.send_checkpoint = timed_send

    def timing(recv):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            state = recv(*args, **kwargs)
            heal["get_ms"] = (time.perf_counter() - t0) * 1e3
            heal["bytes"] = sum(x.nbytes for x in tree_leaves(state)
                                if isinstance(x, (torch.Tensor, np.ndarray)))
            stats = getattr(transport, "last_heal_stats", None) or {}
            heal["mode"], heal["nsources"] = stats.get("mode"), stats.get("nsources")
            return state

        return timed

    # HTTPTransport heals through recv_checkpoint_multi, CollectivesTransport
    # through recv_checkpoint
    transport.recv_checkpoint = timing(transport.recv_checkpoint)
    if hasattr(transport, "recv_checkpoint_multi"):
        transport.recv_checkpoint_multi = timing(transport.recv_checkpoint_multi)


def _outer_tensors(diloco):
    """The backup tensors and their outer momentum buffers (None before the
    first outer step), in the outer optimizer's order."""
    opt = diloco.outer_optimizer
    backup = opt.param_groups[0]["params"]
    return backup, [opt.state.get(p, {}).get("momentum_buffer") for p in backup]


def _keep_joint_sync(diloco, manager, out):
    """Keep copies of the last committed joint sync's inputs and results in
    ``out``: the backup, the local params, the outer momentum before it, and
    the backup and momentum after it."""
    from torchft_tpu_torch.utils.tree import tree_leaves

    perform = diloco._perform_sync

    def kept(params):
        def copy(ts):
            return [None if t is None else t.detach().clone() for t in ts]

        backup, momentum = _outer_tensors(diloco)
        before = dict(backup=copy(backup), local=copy(tree_leaves(params)),
                      momentum=copy(momentum))
        committed = perform(params)
        if committed and manager.num_participants() == 2:
            backup, momentum = _outer_tensors(diloco)
            out.update(before, new_backup=copy(backup), new_momentum=copy(momentum))
        return committed

    diloco._perform_sync = kept


# the plain outer step is held to the port's within this (float32; the
# pseudogradient average is the same IEEE sum and division on both sides,
# and SGD's fused a + alpha*b may round once where the plain one rounds
# twice)
OUTER_RTOL, OUTER_ATOL = 1e-6, 1e-9


def _hold_outer_step(kept, lr=0.7, momentum=0.9):
    """Recompute the last joint sync's outer step plainly from both groups'
    kept tensors: g = mean over groups of (backup - local), buf = momentum *
    buf + g (g at the first step), backup -= lr * (g + momentum * buf)
    (torch SGD with Nesterov and no dampening), and hold both groups'
    results to it."""
    a, b = kept[0], kept[1]
    for name in ("backup", "momentum"):
        check(all((x is None and y is None) or torch.equal(x, y)
                  for x, y in zip(a[name], b[name])),
              f"DiLoCo outer check: the groups entered the sync with different {name}")
    err = {"backup": 0.0, "momentum": 0.0}
    moved = 0.0
    for i, old in enumerate(a["backup"]):
        g = ((old - a["local"][i]) + (old - b["local"][i])) / 2
        buf_old = a["momentum"][i]
        buf = g.clone() if buf_old is None else buf_old * momentum + g
        new = old - lr * (g + momentum * buf)
        moved = max(moved, (new - old).abs().max().item())
        for grp in (a, b):
            for name, got, ref in (("backup", grp["new_backup"][i], new),
                                   ("momentum", grp["new_momentum"][i], buf)):
                excess = ((got - ref).abs() - OUTER_RTOL * ref.abs() - OUTER_ATOL).max().item()
                check(excess <= 0, f"DiLoCo outer {name} tensor {i} misses the plain "
                                   f"outer step by {excess:.3e} over its bar")
                err[name] = max(err[name], (got - ref).abs().max().item())
    check(moved > 0, "DiLoCo outer step did not move the backup")
    log(f"diloco outer step held against its plain version (last joint sync, both "
        f"groups): max |err| backup {err['backup']:.3e}, momentum {err['momentum']:.3e} "
        f"(bar {OUTER_RTOL:g}*|ref| + {OUTER_ATOL:g}); the step moved the backup by up "
        f"to {moved:.3e}")


def phase_diloco(joint_syncs: int = 2):
    """DiLoCo with a late joiner (examples/train_diloco.py's setup at the
    headline size). Returns nothing; prints the inner step's, each sync's
    and the heal's times, and holds the last joint sync's outer step
    against its plain version."""
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.local_sgd import DiLoCo
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.parallel.train_step import TrainStep, synchronize
    from torchft_tpu_torch.store import StoreServer
    from torchft_tpu_torch.utils.tree import tree_leaves

    cfg = headline_config()
    batch, seq = HEADLINE["batch"], HEADLINE["seq"]
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1)
    first_sync = threading.Event()
    inner = {0: 0, 1: 0}

    def outer_sgd(ps):
        return torch.optim.SGD(ps, lr=0.7, momentum=0.9, nesterov=True)

    def group(gid):
        try:
            if gid == 1 and not first_sync.wait(timeout=600):
                raise TimeoutError("group 0 never synced")
            return member(gid)
        finally:
            first_sync.set()

    def member(gid):
        store = StoreServer()
        manager = make_manager(lighthouse.address(), store, f"diloco{gid}", plane="tcp",
                               use_async_quorum=False)
        quorum_ms = []
        _time_quorums(manager, quorum_ms)
        heal, kept = {}, {}
        _time_heal(manager, heal)
        try:
            ts = TrainStep(cfg, device="cuda")
            params = ts.init_params(200 + gid)  # different inits: the heal must matter
            diloco = DiLoCo(manager, outer_sgd, sync_every=SYNC_EVERY)
            diloco.save(params)
            _keep_joint_sync(diloco, manager, kept)
            state = {"opt": ts.init_opt(params)}

            def load(s):
                t0 = time.perf_counter()
                with torch.no_grad():
                    for dst, src in zip(tree_leaves(params), tree_leaves(s["params"])):
                        dst.copy_(src)
                diloco.load_state_dict(s["diloco"])
                state["opt"] = ts.init_opt(params)
                synchronize()
                heal["apply_ms"] = (time.perf_counter() - t0) * 1e3

            manager.set_state_dict_fns(
                load, lambda: {"params": params, "diloco": diloco.state_dict()}
            )
            tokens = make_tokens(cfg, 20 + gid, batch, seq)
            step_ms, syncs = [], []
            joint = 0
            while joint < 1 + joint_syncs:
                t0 = time.perf_counter()
                loss, _, _ = ts.step(params, state["opt"], tokens)
                loss = float(loss)
                step_ms.append((time.perf_counter() - t0) * 1e3)
                inner[gid] += 1
                before = manager.current_step()
                t0 = time.perf_counter()
                if not diloco.step(params):
                    continue
                synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                committed = manager.current_step() > before
                healed = "apply_ms" in heal and not any(x.get("healed") for x in syncs)
                if diloco._just_healed:
                    raise RuntimeError("a heal's flag outlived its sync")
                n = manager.num_participants()
                syncs.append(dict(ms=ms, quorum_ms=quorum_ms[-1], committed=committed,
                                  participants=n, healed=healed, loss=loss,
                                  plane=manager._collectives.plane_info()))
                state["opt"] = ts.init_opt(params)  # fresh inner state per outer step
                if committed and n == 2:
                    joint += 1
                if committed:
                    first_sync.set()
            synchronize()
            return dict(step=manager.current_step(), params=_param_digest(params),
                        momentum=_tensor_digest(_outer_tensors(diloco)[1]), step_ms=step_ms,
                        syncs=syncs, heal=heal, kept=kept)
        finally:
            manager.shutdown(wait=False)
            store.shutdown()

    torch.cuda.synchronize()
    fa.reset_launches()
    try:
        res = _run_threads(group, "DiLoCo phase")
    finally:
        lighthouse.shutdown()
    launches = dict(fa.LAUNCHES)
    for gid in (0, 1):
        r = res[gid]
        steady = r["step_ms"][1:] or r["step_ms"]
        log(f"diloco group{gid}: {inner[gid]} inner steps, inner step median "
            f"{statistics.median(steady):.3f} ms (first {r['step_ms'][0]:.3f} ms; "
            f"two groups share the card)")
        for i, x in enumerate(r["syncs"]):
            log(f"diloco group{gid} sync {i}: committed={x['committed']} "
                f"participants={x['participants']} healed={x['healed']} "
                f"total {x['ms']:.3f} ms = quorum {x['quorum_ms']:.3f} ms + pseudogradient "
                f"average and outer step {x['ms'] - x['quorum_ms']:.3f} ms; "
                f"inner loss {x['loss']:.5f}; plane {x['plane']}")
        log(f"diloco group{gid}: step={r['step']} params sha256={r['params']} "
            f"outer momentum sha256={r['momentum']}")
    heal = res[1]["heal"]
    check("apply_ms" in heal and sum(x["healed"] for x in res[1]["syncs"]) == 1,
          "DiLoCo: group 1 did not heal exactly once")
    check(not res[0]["heal"].get("apply_ms"), "DiLoCo: group 0 healed")
    log(f"diloco heal: {heal['bytes']} bytes of tensors, fetch {heal['get_ms']:.3f} ms "
        f"({heal['bytes'] / heal['get_ms'] / 1e6:.3f} GB/s), apply {heal['apply_ms']:.3f} ms")
    check(res[0]["step"] == res[1]["step"], "DiLoCo groups ended at different steps")
    check(res[0]["params"] == res[1]["params"], "DiLoCo groups ended with different params")
    check(res[0]["momentum"] == res[1]["momentum"],
          "DiLoCo groups ended with different outer momentum")
    check(all(res[g]["kept"] for g in (0, 1)), "DiLoCo: no committed joint sync was kept")
    _hold_outer_step({g: res[g]["kept"] for g in (0, 1)})
    expect = {n: c * (inner[0] + inner[1]) for n, c in _launches_per_step(cfg).items()}
    log(f"diloco: {inner[0]} + {inner[1]} inner steps, kernel launches {launches}")
    check(launches == expect, f"DiLoCo launches {launches} != {expect}")


VETO_STEP = 3


def phase_pipeline(steps: int = 6):
    """The pipelined commit against the synchronous one, each from one seed
    over the same batches, with a vetoed vote at step ``VETO_STEP``; then
    the snapshot's bytes and clone time."""
    check(steps > VETO_STEP, "the veto must fall inside the run")
    runs = {}
    snapshot = None
    for pipelined in (False, True):
        res, elapsed = _pipeline_run(pipelined, steps)
        tag = "pipelined" if pipelined else "sync"
        for gid in (0, 1):
            r = res[gid]
            log(f"{tag} group{gid} ({r['loop']}): step={r['step']} rollbacks="
                f"{r['rollbacks']} params sha256={r['params']}")
        log(f"{tag}: {steps} steps in {elapsed:.3f} s, {steps / elapsed:.4f} steps/s "
            f"(two groups on one card; no gain is claimed)")
        check(all(res[g]["step"] == steps - 1 for g in (0, 1)),
              f"{tag}: a group did not end at step {steps - 1}")
        rollbacks = res[0]["rollbacks"]
        check(rollbacks >= 1 if pipelined else rollbacks == 0,
              f"{tag}: group 0 made {rollbacks} rollbacks")
        runs[tag] = res
        if pipelined:
            snapshot = res[0]["snapshot"]
    digests = {runs[t][g]["params"] for t in runs for g in (0, 1)}
    check(len(digests) == 1, f"params differ across groups and runs: {digests}")
    nbytes, ms, ms_graph = snapshot
    log(f"snapshot (FTTrainer, params + AdamW state): {nbytes} bytes; clone per "
        f"speculative step {ms:.4f} ms eager (host launches included), {ms_graph:.4f} ms "
        f"device time by CUDA graph ({nbytes / ms_graph / 1e6:.1f} GB/s copied, read + "
        "write counted once)")


def _pipeline_run(pipelined, steps):
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.optim import ManagedOptimizer
    from torchft_tpu_torch.parallel.ft import FTTrainer
    from torchft_tpu_torch.parallel.train_step import TrainStep, synchronize
    from torchft_tpu_torch.store import StoreServer
    from torchft_tpu_torch.utils.tree import tree_leaves

    cfg = headline_config()
    batch, seq = HEADLINE["batch"], HEADLINE["seq"]
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=2)
    ready = threading.Barrier(2)
    replays = {}

    def group(gid):
        store = StoreServer()
        manager = make_manager(lighthouse.address(), store, f"pipe{gid}", plane="tcp",
                               commit_pipeline=pipelined)
        _fail_vote_at(manager, VETO_STEP)
        try:
            ts = TrainStep(cfg, device="cuda")
            tokens = [make_tokens(cfg, 40 + 10 * gid + i, batch, seq) for i in range(steps)]
            if gid == 0:
                loop = FTTrainer(manager, ts)
                loop.init(seed=300)

                def step(tok):
                    loop.step(tok)
            else:
                loop = ManagedOptimizer(manager, ts.init_opt)
                loop.init(ts.init_params(300))

                def step(tok):
                    loop.begin_step()
                    _, grads = ts.grads(loop.params, tok)
                    loop.step(grads, grad_fn=lambda p: ts.grads(p, tok)[1])
            synchronize()
            ready.wait(timeout=600)
            t0 = time.perf_counter()
            for tok in tokens:
                step(tok)
            plane = manager._collectives.plane_info()
            loop.finish()
            synchronize()
            elapsed = time.perf_counter() - t0
            replays[gid] = loop.rollbacks
            return dict(step=manager.current_step(), rollbacks=loop.rollbacks,
                        params=_param_digest(loop.params), elapsed=elapsed,
                        loop=loop, captures=dict(ts.graphs.captures), plane=plane)
        finally:
            manager.shutdown(wait=False)
            store.shutdown()

    torch.cuda.synchronize()
    fa.reset_launches()
    try:
        res = _run_threads(group, f"pipeline phase (pipelined={pipelined})")
    finally:
        lighthouse.shutdown()
    launches = dict(fa.LAUNCHES)
    # every step runs forward + backward once, and once more per replay;
    # the snapshot timing launches no kernel
    calls = 2 * steps + replays[0] + replays[1]
    expect = {n: c * calls for n, c in _launches_per_step(cfg).items()}
    log(f"pipelined={pipelined}: {calls} forward+backward passes "
        f"({replays[0]} + {replays[1]} replays) on the {res[0]['plane']} plane, kernel "
        f"launches {launches}; graphs captured "
        f"{res[0]['captures']} (FTTrainer), {res[1]['captures']} (ManagedOptimizer, its "
        "AdamW eager)")
    check(launches == expect, f"pipeline launches {launches} != {expect}")
    # a rollback copies into the captured tensors: no capture after it
    check(res[0]["captures"] == {"grads": 1, "apply": 1}
          and res[1]["captures"] == {"grads": 1, "apply": 0},
          f"pipelined={pipelined}: graphs captured again (a rollback swapped a tensor?)")
    if pipelined:
        # the clone that one speculative step of FTTrainer takes, timed alone
        trainer = res[0]["loop"]
        ms = gpu_time_ms(trainer._take_snapshot, reps=5, inner=1)
        ms_graph = gpu_time_ms(trainer._take_snapshot, reps=5, inner=1, graph=True)
        nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(trainer._snapshot)
                     if isinstance(t, torch.Tensor))
        res[0]["snapshot"] = (nbytes, ms, ms_graph)
    for r in res.values():
        r["loop"] = type(r["loop"]).__name__
    return res, max(res[g]["elapsed"] for g in (0, 1))


# ---------------------------------------------------------------------------
# phase 11: ResNet-18 on CIFAR
# ---------------------------------------------------------------------------

CIFAR_BATCH = 32  # examples/train_cifar.py's BATCH


def _cifar_data():
    from torchft_tpu_torch.examples.train_cifar import ensure_dataset
    from torchft_tpu_torch.utils.platform import build_dir

    return ensure_dataset(os.path.join(build_dir("cifar"), "cifar10_standin.npz"))


def _hold_cifar_graph(cfg, images, labels):
    """The graphed ResNet step against the eager one on one batch: the
    capturing call (eager on the capture stream) and a replay give the
    eager step's loss, gradients and new BN stats bit for bit."""
    from torchft_tpu_torch.examples.train_cifar import CifarStep
    from torchft_tpu_torch.utils.tree import tree_leaves

    eager, graphed = CifarStep(cfg, "cuda", graph=False), CifarStep(cfg, "cuda")
    params, stats = eager.init(0)
    x = torch.from_numpy(images[:CIFAR_BATCH].astype(np.float32) / 255.0)
    y = torch.from_numpy(labels[:CIFAR_BATCH].astype(np.int64))
    ref = eager.grads(params, stats, x, y)
    runs = [graphed.grads(params, stats, x, y) for _ in range(2)]
    torch.cuda.synchronize()
    same = [float(r[0]) == float(ref[0])
            and all(torch.equal(a, b) for a, b in zip(tree_leaves(r[1:]), tree_leaves(ref[1:])))
            for r in runs]
    ms = {}
    for name, step in (("eager", eager), ("graphed", graphed)):
        ms[name] = gpu_time_ms(lambda st=step: st.grads(params, stats, x, y), reps=10, inner=3)
    log(f"resnet18 cifar step (loss, gradients, new BN stats; bf16, batch {CIFAR_BATCH}): "
        f"loss eager {float(ref[0]):.6f}, graphed capture and replay {float(runs[0][0]):.6f}, "
        f"{float(runs[1][0]):.6f}; all equal bitwise {same}; {ms['eager']:.3f} ms eager, "
        f"{ms['graphed']:.3f} ms graphed (between CUDA events, host launches included)")
    check(all(same), "resnet: the graphed step disagrees with the eager one (bar: bitwise)")


def _cifar_digest(params, opt_state, stats) -> str:
    """One sha256 over a CIFAR trainer's heal state: params, SGD momentum
    (from an ``Optimizer.state_dict()``), BN stats."""
    from torchft_tpu_torch.utils.tree import tree_leaves

    params = tree_leaves(params)
    momentum = [opt_state["state"][i]["momentum_buffer"] for i in range(len(params))]
    return _tensor_digest(params + momentum + tree_leaves(stats))


def phase_resnet(alone=3, together=6):
    """The CIFAR example on the card (``examples/train_cifar.py``'s sizes,
    bf16): the graphed step against the eager one, then two groups on the
    device plane, each on its own stream; group 0 commits ``alone`` steps,
    group 1 joins, heals over CollectivesTransport, and both commit
    ``together`` steps. Holds the heal (the params, SGD momentum and BN
    stats group 1 holds after it have the sha256 of what group 0 served),
    one sha256 of params and momentum over both groups at the end (the BN
    running stats stay each group's own after the heal, as in torch DDP and
    the JAX example), the groups' sample ids disjoint within an epoch,
    group 0's loss falling, and one capture of each graph per group."""
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.examples.train_cifar import CifarStep, CifarTrainer
    from torchft_tpu_torch.models.resnet import ResNetConfig
    from torchft_tpu_torch.parallel.train_step import synchronize
    from torchft_tpu_torch.store import StoreServer
    from torchft_tpu_torch.utils.tree import tree_leaves

    cfg = ResNetConfig(dtype=torch.bfloat16)
    images, labels = _cifar_data()
    _hold_cifar_graph(cfg, images, labels)
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1)
    group0_ready = threading.Event()

    def group(gid):
        try:
            if gid == 1 and not group0_ready.wait(timeout=600):
                raise TimeoutError("group 0 never committed its first steps")
            with torch.cuda.stream(torch.cuda.Stream()):
                return member(gid)
        finally:
            group0_ready.set()

    def member(gid):
        store = StoreServer()
        manager = make_manager(lighthouse.address(), store, f"cifar{gid}", plane="device",
                               transport="collectives")
        heal, digests = {}, []
        _time_heal(manager, heal)
        stream = torch.cuda.current_stream()
        try:
            ts = CifarStep(cfg, "cuda")
            trainer = CifarTrainer(manager, ts, images, labels, replica_group=gid,
                                   num_groups=2, batch=CIFAR_BATCH, seed=100 + gid)

            def served():  # on the quorum thread: this group's stream first
                state = trainer.state_dict()
                stream.synchronize()
                digests.append(_cifar_digest(state["params"], state["opt_state"], state["bn"]))
                return state

            def loaded(state):
                trainer.load_state_dict(state)
                stream.synchronize()
                digests.append(_cifar_digest(trainer.params, trainer.opt.state_dict(),
                                             trainer.stats))

            manager.set_state_dict_fns(loaded, served)
            losses, joint_ids, joint_ms = [], [], []
            joint = committed_alone = 0
            while joint < together:
                before = manager.current_step()
                t0 = time.perf_counter()
                loss, ids, committed = trainer.step()
                stream.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                n = manager.num_participants()
                if committed and manager.is_participating():
                    losses.append(loss)
                if committed and n == 2 and manager.is_participating():
                    joint += 1
                    joint_ids.append((before, ids))
                    joint_ms.append(ms)
                elif committed and gid == 0:
                    committed_alone += 1
                    if committed_alone >= alone:
                        group0_ready.set()
                log(f"resnet group{gid}: step={manager.current_step()} loss={loss:.5f} "
                    f"committed={committed} participants={n} {ms:.3f} ms")
            synchronize()
            params = tree_leaves(trainer.params)
            momentum = [trainer.opt.state[p]["momentum_buffer"] for p in params]
            return dict(step=manager.current_step(), losses=losses, joint_ids=joint_ids,
                        joint_ms=joint_ms, heal=heal, captures=dict(ts.graphs.captures),
                        heal_digests=digests, digest=_tensor_digest(params + momentum),
                        stats=_tensor_digest(tree_leaves(trainer.stats)),
                        epoch_steps=len(trainer.sampler) // CIFAR_BATCH)
        finally:
            manager.shutdown(wait=False)
            store.shutdown()

    torch.cuda.synchronize()
    try:
        res = _run_threads(group, "resnet phase")
    finally:
        lighthouse.shutdown()
    for gid in (0, 1):
        r = res[gid]
        log(f"resnet group{gid}: step={r['step']} params+momentum sha256={r['digest']} BN stats "
            f"sha256={r['stats']} graphs captured {r['captures']}; losses of its committed "
            f"steps {', '.join(f'{x:.4f}' for x in r['losses'])}")
    served, received = res[0]["heal_digests"], res[1]["heal_digests"]
    log(f"resnet heal: params+momentum+BN stats sha256 served by group 0 {served}, held by "
        f"group 1 after loading {received}")
    check("get_ms" not in res[0]["heal"] and "get_ms" in res[1]["heal"]
          and len(received) == 1 and received[0] in served,
          "resnet: group 1 did not heal to the state group 0 served")
    check(res[0]["step"] == res[1]["step"] and res[0]["digest"] == res[1]["digest"],
          "resnet: the groups ended with different params or momentum")
    check(all(res[g]["captures"] == {"grads": 1, "apply": 1} for g in (0, 1)),
          "resnet: a group captured its graphs again (a heal swapped a captured tensor?)")
    # the joint steps' batches come from the two groups' disjoint partitions
    # of each epoch: no id is shared within an epoch, and none repeats in a
    # group
    check([s for s, _ in res[0]["joint_ids"]] == [s for s, _ in res[1]["joint_ids"]],
          "resnet: the groups' joint steps differ")
    per_epoch = {}
    for gid in (0, 1):
        for step, ids in res[gid]["joint_ids"]:
            per_epoch.setdefault(step // res[gid]["epoch_steps"], ([], []))[gid].extend(ids)
    for epoch, (ids0, ids1) in sorted(per_epoch.items()):
        shared = set(ids0) & set(ids1)
        log(f"resnet sampler, epoch {epoch}: {len(ids0)} and {len(ids1)} sample ids over the "
            f"joint steps, {len(set(ids0))} and {len(set(ids1))} distinct, {len(shared)} shared")
        check(not shared and len(set(ids0)) == len(ids0) and len(set(ids1)) == len(ids1),
              f"resnet: sample ids overlap within epoch {epoch}")
    first, last = res[0]["losses"][:3], res[0]["losses"][-3:]
    log(f"resnet loss, group 0: first 3 steps mean {np.mean(first):.4f}, last 3 steps mean "
        f"{np.mean(last):.4f} over {len(res[0]['losses'])} committed steps")
    check(np.mean(last) < np.mean(first), "resnet: the loss did not fall")
    heal = res[1]["heal"]
    joint_ms = res[0]["joint_ms"] + res[1]["joint_ms"]
    log(f"resnet heal over CollectivesTransport: {heal['bytes']} bytes, transfer "
        f"{heal['get_ms']:.3f} ms; joint steps {statistics.median(joint_ms):.3f} ms median wall "
        f"(both groups, {len(joint_ms)} steps, host clock, each group's stream synchronised)")


# ---------------------------------------------------------------------------
# phase 12: kill and rejoin
# ---------------------------------------------------------------------------

KILL_AT_STEP = 8
RECOVERY_STEPS = 20
LEASE_MS = 5000  # the lighthouse's default heartbeat lease
RECOVERY_OP_TIMEOUT = 30.0  # s: far above a joint step over TCP (phase 5)


def _survivor_log(path):
    """The survivor Manager's lines of the death path, from its stderr."""
    keep = ("death watch", "reported dead peer", "reconfiguring", "should_commit=False")
    with open(path + ".stderr", errors="replace") as f:
        return [line.rstrip() for line in f if any(k in line for k in keep)]


def phase_recovery(joint_ms, env_extra, name="kill and rejoin", plane=None, num_groups=2):
    """``num_groups`` groups as worker processes on the card, each training
    the headline at full width (graphed, ``"flash"``) through FTTrainer on
    CollectivesTcp with the HTTP heal; the last group takes SIGKILL once it
    has committed ``KILL_AT_STEP`` and is respawned
    (``torchft_tpu_torch.benchmarks.recovery.measure_recovery``). ``joint_ms``
    is a joint step over TCP, beside which the op timeout is printed;
    ``env_extra`` selects the workers' plane, and ``plane`` (when given) is
    the one every epoch of more than one group must report. The
    lighthouse's join timeout is the harness's (1 s with three groups or
    more)."""
    from torchft_tpu_torch.benchmarks.recovery import measure_recovery

    gc.collect()
    torch.cuda.empty_cache()  # the workers need the card's memory, not this cache
    saved = os.environ.get("DEVICE")
    os.environ["DEVICE"] = "cuda"  # the workers' device: the card, at the headline
    t0 = time.perf_counter()
    try:
        r = measure_recovery(total_steps=RECOVERY_STEPS, kill_at_step=KILL_AT_STEP,
                             step_sleep=0.0, op_timeout=RECOVERY_OP_TIMEOUT,
                             heartbeat_timeout_ms=LEASE_MS, timeout_s=600.0,
                             num_groups=num_groups, env_extra=env_extra)
    finally:
        if saved is None:
            os.environ.pop("DEVICE")
        else:
            os.environ["DEVICE"] = saved
    wall = time.perf_counter() - t0
    out = r.as_dict()
    log(f"{name}: {env_extra}, planes of the two-group epochs by group {r.planes}; lease "
        f"{LEASE_MS / 1000:.1f} s, op timeout {RECOVERY_OP_TIMEOUT:.1f} s (a joint step over TCP "
        f"{joint_ms:.3f} ms, this run's steady step {r.steady_step_s * 1e3:.3f} ms), killed at "
        f"step {KILL_AT_STEP}")
    log(f"{name}: survivor_blackout_s {r.survivor_blackout_s:.6f}, blackout_steps "
        f"{out['blackout_steps']}, survivor_steps_lost {r.survivor_steps_lost}, steady_step_s "
        f"{r.steady_step_s:.6f}, rejoin_to_commit_s {r.rejoin_to_commit_s:.6f}")
    log(f"{name}: rejoin_to_commit_s parts: " + ", ".join(
        f"{k} {v:.6f}" for k, v in r.rejoin_parts_s.items()))
    for line in _survivor_log(r.log_paths[0]):
        log(f"{name}, survivor log | {line}")
    finals = r.finals
    for g in sorted(finals):
        f = finals[g]
        log(f"{name} group{g}: step={f['step']} params+AdamW sha256={f['digest']} "
            f"graphs captured {f['captures']}, {f['steps']} steps, flash launches per step "
            f"{f['launches_per_step']}" + (f", heal {f['heal']}" if f["heal"] else ""))
    rh = r.rejoin_heal or {}
    log(f"{name}: rejoin_heal mode {rh.get('mode')}, nsources {rh.get('nsources')}, "
        f"{rh.get('bytes')} bytes in {rh.get('seconds', 0.0):.6f} s, per source "
        + ", ".join(f"{src} {v.get('bytes')} bytes {v.get('ranges')} ranges "
                    f"{v.get('gb_per_sec')} GB/s over {v.get('route')}"
                    for src, v in (rh.get("per_source") or {}).items())
        + f"; stages {rh.get('stages')}; failures {rh.get('failures')}")
    log(f"{name}: eviction reports {r.evictions}; survivor commits after the kill "
        f"{r.survivor_commits_after_kill}, rejoiner commits {r.rejoiner_commits}; deadlines "
        f"hit, by group: steps retried {r.timeout_retries}, steps aborted {r.deadline_aborts}; "
        f"phase wall {wall:.1f} s")
    groups = list(range(num_groups))
    victim = groups[-1]
    check(sorted(finals) == groups, f"{name}: final events of groups {sorted(finals)}")
    if plane is not None:
        check(all(r.planes[g] == [plane] for g in groups),
              f"{name}: the groups ran on {r.planes}, expected {plane}")
    # the workers retry a step that raised on a deadline, and abort one whose
    # op or heal latched one; on the card no deadline may be hit, in the
    # heal, the rejoin or a steady step
    check(not any(r.timeout_retries.values()) and not any(r.deadline_aborts.values()),
          f"{name}: deadlines hit, by group: steps retried {r.timeout_retries}, "
          f"steps aborted {r.deadline_aborts}")
    check(r.survivor_commits_after_kill > 0, f"{name}: the survivor never committed again")
    heal = finals[victim]["heal"]
    check(r.rejoiner_commits > 0 and heal and heal["bytes"] > 0,
          f"{name}: the respawned group did not heal and commit")
    # the rejoiner stripes over every survivor (their committed states are
    # bit-identical), each range over the blob plane
    served = {src: v for src, v in (rh.get("per_source") or {}).items() if v.get("bytes")}
    check(rh.get("mode") == "striped" and rh.get("nsources") == num_groups - 1
          and len(served) == num_groups - 1
          and all(v.get("route") == "blob" for v in served.values()),
          f"{name}: the rejoiner's heal was not striped over the {num_groups - 1} survivors "
          f"on the blob plane: {rh}")
    check(len({(finals[g]["digest"], finals[g]["step"]) for g in groups}) == 1,
          f"{name}: the groups ended with different params or optimizer state")
    for g in groups:
        check(finals[g]["captures"] == {"grads": 1, "apply": 1},
              f"{name}: group {g} captured its graphs {finals[g]['captures']} "
              "(serving or taking a heal must not recapture)")
        expect = _launches_per_step(headline_config())
        check(finals[g]["launches_per_step"] == [expect],
              f"{name}: group {g} launched {finals[g]['launches_per_step']} per step, "
              f"expected {expect}")
    check(any(evicted for gid, _, evicted in r.evictions if gid != victim),
          f"{name}: no survivor's eviction report was accepted: {r.evictions}")
    check(r.survivor_blackout_s < LEASE_MS / 1000,
          f"{name}: blackout {r.survivor_blackout_s:.3f} s is not below the "
          f"{LEASE_MS / 1000:.1f} s lease")
    check(RECOVERY_OP_TIMEOUT >= 10 * r.steady_step_s,
          f"{name}: op timeout {RECOVERY_OP_TIMEOUT} s under 10 steady steps")
    _hold_kill_telemetry(name, r.observability, victim, num_groups)
    return {n: sum(finals[g]["launches"][n] for g in groups) for n in finals[0]["launches"]}


def _hold_kill_telemetry(name, obs, victim, num_groups):
    """A kill's telemetry, from the workers' own trails, span files and the
    survivor's SIGUSR2 flight dump (``RecoveryResult.observability``): a
    survivor's trail holds the accepted eviction of the victim and a quorum
    without it; the rejoiner's heal_recv span and every survivor's
    checkpoint_serve span share one trace id (the X-TFT-Trace header), the
    serve spans parented on the heal's; the flight dump lists completed
    allreduces."""
    evictions, quorums = obs["survivor_evictions"], obs["survivor_quorums_after_kill"]
    log(f"{name}, trails: survivor evictions {evictions}; survivor quorums after the kill "
        f"{quorums}")
    log(f"{name}, spans: rejoiner heal_recv trace_id {obs['rejoiner_heal_trace_id']}, "
        f"checkpoint_serve spans in that trace by survivor {obs['serve_spans_in_that_trace']}, "
        f"parented on heal_recv {obs['serve_spans_parented']}")
    fd = obs["flight_dump"]
    log(f"{name}, SIGUSR2 flight dump of group 0: {fd}")
    check(any(e["evicted"] and e["victim"].startswith(f"group{victim}_") for e in evictions),
          f"{name}: no survivor's trail holds an accepted eviction of group {victim}")
    check(any(not q["victim_in"] and q["num_participants"] == num_groups - 1 for q in quorums),
          f"{name}: no survivor's trail holds the quorum without group {victim}")
    served = obs["serve_spans_in_that_trace"]
    check(obs["rejoiner_heal_trace_id"] is not None and len(served) == num_groups - 1
          and all(n >= 1 for n in served.values()) and obs["serve_spans_parented"],
          f"{name}: the survivors' serve spans do not join the rejoiner's heal trace: {obs}")
    check(fd is not None and fd["reason"] == "signal" and fd["completed_allreduces"] >= 1,
          f"{name}: SIGUSR2 gave no flight dump listing completed allreduces: {fd}")


# ---------------------------------------------------------------------------
# phase 13: the wire plane
# ---------------------------------------------------------------------------

# arm: (plane, wire codec)
WIRE_ARMS = {
    "python-ring": ("python-ring", None),
    "tcp-striped": ("tcp-striped", None),
    "cma": ("cma", None),
    "tcp-striped-bf16": ("tcp-striped", "bfloat16"),
    "tcp-striped-int8": ("tcp-striped", "int8"),
}
# A lossy arm's first average against the exact arms', on the measure its
# codec's error scales with (benchmarks.crossgroup.wire_error), and its
# limit. bfloat16 rounds each element within u = 2^-8 of itself: the two
# workers' projections and the owner's encode of the average give about
# 0.5u of a leaf's norm (the headline's worst leaf reads 0.00206 on an
# H100 80GB HBM3 at 700 W); the limit is u.
# int8 rounds within half a step of its chunk's max / 127: the two
# projections and the encode of the sum give at most
# (max|a| + max|b|) / 508 + max|avg| / 254, 1/127 of the average's largest
# element when the workers' peaks match it (the headline reads 0.00821 on
# that card, just over 1/127); the limit 2/127 holds while the workers'
# peaks sum to under 6x the average's. Zeros read 1 on both measures, a
# worker's own gradients 1.016 (leaf) and 0.429 (peak).
WIRE_ERR_LIMIT = {"bfloat16": ("leaf", 2.0 ** -8), "int8": ("peak", 2.0 / 127)}
WIRE_WARMUP, WIRE_STEPS = 2, 5
RAW_PLANES = {"raw python-ring": ("python-ring", None), "raw tcp-striped": ("tcp-striped", None),
              "raw tcp-striped-bf16": ("tcp-striped", "bfloat16"), "raw cma": ("cma", None)}
RAW_ROUNDS = 3
HEAL_BYTES = 701_601_840  # the headline's params and AdamW state (phase 12's heal)


def phase_wire_plane(joint_ms):
    """Two worker processes on the card (``benchmarks.crossgroup.run_pair``),
    each holding the headline at full width, its gradients graphed: a CMA
    probe between them; the five arms of WIRE_ARMS in turn, each with a
    fresh lighthouse, Manager (sync quorum) and CollectivesTcp and
    ManagedOptimizer over TrainStep, 2 warm-up and 5 timed joint steps from
    the same seeded params; the raw allreduce of the gradient tree's bytes
    on each plane; a 701.6 MB heal over CollectivesTransport with and
    without CMA. Then one SIGKILL of worker 1 on the default plane (phase
    12's harness and checks). Returns the flash launches of both parts."""
    from torchft_tpu_torch.benchmarks.crossgroup import run_pair

    gc.collect()
    torch.cuda.empty_cache()
    jobs = [{"kind": "probe", "name": "probe"}]
    for name, (plane, codec) in WIRE_ARMS.items():
        jobs.append({"kind": "e2e", "name": name, "plane": plane, "codec": codec,
                     "warmup": WIRE_WARMUP, "steps": WIRE_STEPS, "exact": codec is None})
    for name, (plane, codec) in RAW_PLANES.items():
        jobs.append({"kind": "raw", "name": name, "plane": plane, "codec": codec,
                     "nbytes": None, "rounds": RAW_ROUNDS})
    for name, plane in (("heal cma", "cma"), ("heal tcp", "tcp-striped")):
        jobs.append({"kind": "heal", "name": name, "plane": plane, "nbytes": HEAL_BYTES})
    t0 = time.perf_counter()
    res = run_pair(jobs, "cuda", timeout_s=900)
    wall = time.perf_counter() - t0
    probe = res["probe"][1]["result"]
    log(f"wire plane: process_vm_readv of worker 0's page-locked staging memory from worker "
        f"1: {probe}")
    cma_ok = probe == "ok"
    for name, rs in res.items():
        if name != "probe" and any("skipped" in r for r in rs):
            check(not cma_ok and all(r["skipped"] == probe for r in rs),
                  f"wire plane: {name} was skipped: {rs}")
            log(f"wire plane: {name} not run (the kernel refused CMA: {probe})")
    expect = _launches_per_step(headline_config())
    exact_digests = set()
    launches = {n: 0 for n in expect}
    lossy_digests = {}
    for name, (plane, codec) in WIRE_ARMS.items():
        rs = res[name]
        if "skipped" in rs[0]:
            continue
        want = (plane, codec or "f32")
        got = [(r["plane"], r["wire_codec"]) for r in rs]
        check(got == [want, want], f"wire plane {name}: plane and codec {got}, expected {want}")
        check(all(r["committed"] == [True] * (WIRE_WARMUP + WIRE_STEPS) for r in rs),
              f"wire plane {name}: a step did not commit: {[r['committed'] for r in rs]}")
        digests = {r["first_avg_digest"] for r in rs}
        check(len(digests) == 1, f"wire plane {name}: the first averaged gradients differ "
              f"between the workers: {digests}")
        check(rs[0]["final_digest"] == rs[1]["final_digest"],
              f"wire plane {name}: the workers ended with different params")
        ef = [r["error_feedback"] for r in rs]
        if codec is None:
            exact_digests |= digests
            check(ef == [False, False], f"wire plane {name}: error feedback on an exact wire")
        else:
            lossy_digests[name] = digests
            measure, limit = WIRE_ERR_LIMIT[codec]
            for r in rs:
                err, ctl = r["first_avg_wire_err"], r["first_avg_controls"]
                check(err is not None and err[measure] <= limit,
                      f"wire plane {name}: worker {r['gid']}'s first average is off the "
                      f"exact arms' by {measure} {err}, over the limit {limit:.6g}")
                # the same check has teeth: what a broken wire would return fails it
                check(all(c[measure] > limit for c in ctl.values()),
                      f"wire plane {name}: a control passes the {measure} limit "
                      f"{limit:.6g}: {ctl}")
            log(f"wire plane {name}: first average against the exact arms', "
                f"||err|| / ||exact|| over the tree {rs[0]['first_avg_wire_err']['tree']:.6e}, "
                f"worst leaf {rs[0]['first_avg_wire_err']['leaf']:.6e}, peak |err| / peak "
                f"|exact| {rs[0]['first_avg_wire_err']['peak']:.6e}; held by {measure} <= "
                f"{limit:.6g}; controls (tree, leaf, peak): own gradients "
                + ", ".join(f"{rs[0]['first_avg_controls']['own'][k]:.6e}"
                            for k in ("tree", "leaf", "peak"))
                + ", zeros " + ", ".join(f"{rs[0]['first_avg_controls']['zeros'][k]:.6e}"
                                         for k in ("tree", "leaf", "peak")))
            check(ef == [True, True]
                  and all(all(n > 0 for n in r["pending_at_vote"]) for r in rs)
                  and all(r["pending_after"] == [0] * r["steps"] for r in rs),
                  f"wire plane {name}: error feedback residuals at the vote "
                  f"{[r['pending_at_vote'] for r in rs]}, after the commit "
                  f"{[r['pending_after'] for r in rs]}")
        for r in rs:
            check(r["launches_per_step"] == [expect],
                  f"wire plane {name}: worker {r['gid']} launched {r['launches_per_step']} "
                  f"per step, expected {expect}")
            for n in expect:
                launches[n] += expect[n] * r["steps"]
        steps = [s * 1e3 for r in rs for s in r["step_s"]]
        avg = [a for r in rs for a in r["avg_ms"][WIRE_WARMUP:]]
        log(f"wire plane {name}: {plane}, codec {codec or 'f32'}, error feedback "
            f"{ef[0]}; gradients {rs[0]['grad_dtypes']}; steady joint step median "
            f"{statistics.median(steps):.3f} ms, spread {min(steps):.3f}-{max(steps):.3f} ms "
            f"(both workers, {len(steps)} steps); allreduce_gradients host "
            f"{statistics.median(avg):.3f} ms median per step; first average sha256 "
            f"{rs[0]['first_avg_digest'][:16]}; final params sha256 "
            f"{rs[0]['final_digest'][:16]}")
    check(len(exact_digests) == 1,
          f"wire plane: the exact arms' first averages differ: {exact_digests}")
    for name, digests in lossy_digests.items():
        check(not digests & exact_digests,
              f"wire plane {name}: the lossy wire returned the exact average bit for bit")
    captures = [r["captures"] for r in res["captures"]]
    log(f"wire plane: gradient graphs captured per worker {captures} (across all arms)")
    check(captures == [{"grads": 1, "apply": 0}] * 2,
          f"wire plane: the workers captured {captures}, expected the gradient graph once")
    for name in RAW_PLANES:
        rs = res[name]
        if "skipped" in rs[0]:
            continue
        check(all(r["correct"] for r in rs), f"wire plane {name}: a wrong average")
        secs = max(r["seconds_per_round"] for r in rs)
        log(f"wire plane {name}: {rs[0]['total_bytes']} bytes float32, plane "
            f"{rs[0]['plane']} codec {rs[0]['wire_codec']}: {secs * 1e3:.3f} ms per allreduce, "
            f"{rs[0]['total_bytes'] / secs / 1e9:.3f} GB/s (slower worker, {RAW_ROUNDS} rounds)")
    for name in ("heal cma", "heal tcp"):
        rs = res[name]
        if "skipped" in rs[0]:
            continue
        sent, got = rs
        check(sent["digest"] == got["digest"],
              f"wire plane {name}: sha256 sent {sent['digest']}, received {got['digest']}")
        log(f"wire plane {name}: {got['total_bytes']} bytes over CollectivesTransport on "
            f"{got['plane']}: {got['seconds']:.3f} s, {got['total_bytes'] / got['seconds'] / 1e9:.3f} "
            f"GB/s; sha256 {got['digest'][:16]} on both sides")
    log(f"wire plane: the pair's phase wall {wall:.1f} s")
    kill = phase_recovery(joint_ms, {"TORCHFT_NATIVE_PLANE": "1"}, name="wire plane kill",
                          plane="cma" if cma_ok else "tcp-striped")
    return {n: launches[n] + kill[n] for n in launches}


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 14: the port's bench
# ---------------------------------------------------------------------------

BENCH_WARMUP, BENCH_STEPS = 2, 10  # the headline pair's steps (bench.py: 3 + 20)


def phase_bench(joint_ms):
    """The port's bench (``torchft_tpu_torch.bench``) in a shortened form,
    each row through the function ``bench.main`` runs it with, in a process
    of its own where ``bench.main`` runs it in one: the headline
    ``train_bench`` as one interleaved pair (averaging, then not), 2 warm-up
    and 10 timed steps each; ``long_context.run()`` whole (S 32768, 16384,
    8192, 4096 and the 647M model); ``resnet_ft`` with 1 rep;
    ``quorum_overlap`` and ``commit_pipeline`` with 1 pair; ``diloco``
    with 2 outer steps; ``crossgroup --compressed`` at 128 MB, 1 round (the
    subprocess rows in lanes beside each other); and the 1-of-4 kill
    (``recovery_1of4``) under phase 12's checks. Prints
    every row on its line and holds: no row errs; every transformer step
    commits, its graphs are captured once and its flash launches per step
    are 2L/L/L under remat (L/L/L without); 0 < mfu_pct < 100; the ResNet
    graphs are captured once a rep; no rollback in the pipelined runs;
    every DiLoCo sync hands the collectives the MLP's float32 bytes; the
    int8 first averages lie within WIRE_ERR_LIMIT. Returns the long-context
    rows (the kernels' launches at S 8192 and 32768 come from them)."""
    from torchft_tpu_torch import bench, telemetry
    from torchft_tpu_torch.benchmarks import diloco
    from torchft_tpu_torch.benchmarks.long_context import LENGTHS, scale_config
    from torchft_tpu_torch.models.transformer import headline_config as headline

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = headline()
    batch, seq = HEADLINE["batch"], HEADLINE["seq"]
    peak = bench._peak_flops(torch.cuda.get_device_name(0))
    rows = {}
    # as bench.main does: the ledger and counters then hold the headline
    # pair's steps alone, which its step_anatomy and telemetry rows read
    telemetry.reset()
    for averaging in (True, False):
        rec = {}
        sps, n_params = bench.train_bench(cfg, batch, seq, BENCH_STEPS, BENCH_WARMUP,
                                          averaging=averaging, record=rec)
        flops = bench._model_flops_per_step(cfg, n_params, batch, seq)
        rows[f"headline_{'avg' if averaging else 'noavg'}"] = dict(
            steps_per_sec=sps, tokens_per_sec=sps * batch * seq,
            mfu_pct=bench.mfu_pct(sps, flops, peak), n_params=n_params, **rec)
    rows["step_anatomy"] = bench.step_anatomy_row()
    rows["telemetry"] = telemetry.summary()
    # the subprocess rows at once, one lane each (the two host-only rows,
    # threads that sleep for the forward, share one), to keep the script
    # within its limit; long context, the heaviest on the card, runs in
    # this thread. Their times contend for the card and the host's cores:
    # the bench proper runs each alone, and nothing here holds a time
    lanes = [
        [("long_context", bench._module("long_context"), 900)],
        [("resnet18_cifar", bench._module("resnet_ft", "--reps", "1"), 600)],
        [("quorum_overlap", bench._module("quorum_overlap", "--runs", "1"), 300),
         ("commit_pipeline", bench._module("commit_pipeline", "--runs", "1"), 300)],
        [("diloco_4group", bench._module("diloco", "--outer-steps", "2"), 300)],
        [("crossgroup_compressed", bench._module("crossgroup", "--compressed", "--total-mb",
                                                 "128", "--rounds", "1"), 600)],
    ]

    def run_lane(lane):
        out = {}
        for name, cmd, timeout_s in lane:
            t1 = time.perf_counter()
            out[name] = bench._run_json_subprocess(cmd, timeout_s, env_extra={"DEVICE": "cuda"})
            log(f"bench {name}: {time.perf_counter() - t1:.1f} s in its own process")
        return out

    with ThreadPoolExecutor(max_workers=len(lanes) - 1) as pool:
        beside = [pool.submit(run_lane, lane) for lane in lanes[1:]]
        done = run_lane(lanes[0])
        for fut in beside:
            done.update(fut.result())
    rows.update(done.pop("long_context"))
    rows.update(done)
    for name, row in rows.items():
        log(f"bench row {name}: {json.dumps(row)}")
    bad = [name for name, row in rows.items() if bench.has_error(row)]
    check(not bad, f"bench rows raised: {bad}")

    transformer = {f"headline_{v}": cfg for v in ("avg", "noavg")}
    transformer.update({f"long_context_s{s}": cfg for s, *_ in LENGTHS})
    transformer["scale_647M"] = scale_config()
    for name, c in transformer.items():
        row = rows[name]
        check(row["committed"] == row["steps"],
              f"bench {name}: {row['committed']} of {row['steps']} steps committed")
        check(row["mfu_pct"] is not None and 0 < row["mfu_pct"] < 100,
              f"bench {name}: mfu_pct {row['mfu_pct']}")
        check(row["launches_per_step"] == [_launches_per_step(c)],
              f"bench {name}: flash launches per step {row['launches_per_step']}, expected "
              f"{_launches_per_step(c)}")
        check(row["captures"] == {"grads": 1, "apply": 1},
              f"bench {name}: graphs captured {row['captures']}")
    # the pair's 2 x (BENCH_WARMUP + BENCH_STEPS) steps: every one a quorum
    # and a commit; the ledger's rows start at the first one's vote. The
    # bench's loop reads no loss and fences once, at the end: its host runs
    # ahead of the card, most rows are the enqueue's few ms and a few
    # absorb the card's back-pressure, so the p50 composition is printed,
    # not held (phase 16 holds it on FTTrainer's step, which reads the loss)
    pair = 2 * (BENCH_WARMUP + BENCH_STEPS)
    an, tm = rows["step_anatomy"], rows["telemetry"]
    log(f"bench step_anatomy: {an['steps']} rows, wall p50 {an['wall_p50_s'] * 1e3:.3f} ms, "
        f"p99 {an['wall_p99_s'] * 1e3:.3f} ms, reconciliation_pct {an['reconciliation_pct']}")
    check(an["steps"] == pair - 1 and an["reconciliation_pct"] is not None
          and "compute" in an["phases"] and "commit_barrier" in an["phases"],
          f"bench step_anatomy: {an}")
    check(tm["quorums"] == pair and tm["commits"].get("committed") == pair,
          f"bench telemetry: {tm}")
    resnet = rows["resnet18_cifar"]
    check(all(c == {"grads": 1, "apply": 1} for c in resnet["captures"])
          and all(n == resnet["steps"] for n in resnet["committed"]),
          f"bench resnet18_cifar: captures {resnet['captures']}, committed "
          f"{resnet['committed']} of {resnet['steps']}")
    check(rows["commit_pipeline"]["rollbacks"] == 0,
          f"bench commit_pipeline: {rows['commit_pipeline']['rollbacks']} rollbacks")
    mlp_bytes = sum(a.nbytes for a in diloco._init_params().values())
    check(rows["diloco_4group"]["payload_bytes"] == mlp_bytes,
          f"bench diloco_4group: each sync handed the collectives "
          f"{rows['diloco_4group']['payload_bytes']} bytes, the MLP's float32 bytes are "
          f"{mlp_bytes}")
    measure, limit = WIRE_ERR_LIMIT["int8"]
    for sched in ("serial", "streamed"):
        r = rows["crossgroup_compressed"][sched]
        err = r["first_avg_wire_err"][measure]
        log(f"bench crossgroup_compressed {sched}: {r['plane']}, codec {r['wire_codec']}; "
            f"first average's {measure} error {err:.6e} (limit {limit:.6f})")
        check(r["plane"] == "tcp-striped" and r["wire_codec"] == "int8" and err <= limit,
              f"bench crossgroup_compressed {sched}: {r['plane']} {r['wire_codec']}, "
              f"{measure} error {err}")
    log(f"bench: rows before the 1-of-4 kill {time.perf_counter() - t0:.1f} s")
    # the 1-of-4 kill: four headline workers on the card, the default plane
    phase_recovery(joint_ms, {}, name="recovery_1of4", num_groups=4)
    log(f"bench: phase wall {time.perf_counter() - t0:.1f} s")
    return {s: rows[f"long_context_s{s}"] for s, *_ in LENGTHS}


# ---------------------------------------------------------------------------
# phase 15: the heal plane
# ---------------------------------------------------------------------------

DIFF_LEAVE_AT, DIFF_AHEAD, DIFF_END = 2, 2, 6  # the differential heal's schedule


def _hold_striped_row(name, row, nsources, killed):
    """Print a ``measure_striped_heal`` row and hold it: one sha256 across
    the sources and the healed state (on the card), every source on the
    blob plane, every byte served over it, the expected source count."""
    served = {u: v for u, v in row["per_source"].items() if v["bytes"]}
    log(f"heal plane {name}: {row['total_bytes']} bytes from {row['sources_started']} "
        f"source processes{' (one SIGKILLed after the plan)' if killed else ''}: "
        f"{row['seconds']:.6f} s, {row['gb_per_sec']:.6f} GB/s, nsources {row['nsources']}; "
        "per source " + ", ".join(
            f"{u} {v['bytes']} bytes {v['ranges']} ranges {v['gb_per_sec']} GB/s over "
            f"{v['route']}" for u, v in row["per_source"].items())
        + f"; stages {row['stages_s']}; failures {list(row['failures'])}; the sources' "
        f"staging {[round(x, 6) for x in row['source_stage_s']]} s; copy onto the card "
        f"{row['load_to_device_s']:.6f} s; sha256 sources "
        f"{sorted({d[:16] for d in row['sha256_sources']})}, healed {row['sha256_healed'][:16]}")
    check(set(row["sha256_sources"]) == {row["sha256_healed"]},
          f"heal plane {name}: sha256 of the sources {row['sha256_sources']}, healed "
          f"{row['sha256_healed']}")
    check(all(port is not None for port in row["blob_ports"]),
          f"heal plane {name}: a source staged without the blob plane: {row['blob_ports']}")
    check(all(v["route"] == "blob" for v in served.values()),
          f"heal plane {name}: bytes rode HTTP, not the blob plane: {row['per_source']}")
    check(sum(v["bytes"] for v in served.values()) == row["total_bytes"],
          f"heal plane {name}: the sources served {sum(v['bytes'] for v in served.values())} "
          f"of {row['total_bytes']} bytes")
    check(row["nsources"] == nsources and len(served) == nsources
          and len(row["failures"]) == (1 if killed else 0),
          f"heal plane {name}: nsources {row['nsources']}, served by {len(served)}, failures "
          f"{row['failures']}; expected {nsources} and {1 if killed else 0} failure")


def _diff_heal(perturb: bool):
    """Two headline trainers as threads on the card, each on its own
    stream, with ``TORCHFT_HEAL_DIFF=1``: group 1 leaves at step
    DIFF_LEAVE_AT (its Manager shut down, its trainer and graphs kept),
    group 0 takes DIFF_AHEAD steps alone and waits; group 1 comes back with
    a new Manager whose counters say DIFF_LEAVE_AT and heals from group 0's
    trail (with ``perturb``, one of its params changed first, so its digest
    no longer matches and the heal must be the full striped one). Both take
    joint steps to DIFF_END. Returns the healer's heal stats, both groups'
    sha256 of params and AdamW state, captures, launches per step and the
    trail's per-step wall."""
    from torchft_tpu_torch.benchmarks.recovery import _state_digest
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.parallel.ft import FTTrainer
    from torchft_tpu_torch.parallel.train_step import TrainStep, synchronize
    from torchft_tpu_torch.store import StoreServer

    cfg = headline_config()
    batch, seq = HEADLINE["batch"], HEADLINE["seq"]
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1, heartbeat_timeout_ms=1000)
    left, back, asked = threading.Event(), threading.Event(), threading.Event()
    calls = {0: 0, 1: 0}

    def timed_trail(manager, trail_s):
        record = manager._record_commit_trail

        def timed():
            t0 = time.perf_counter()
            record()
            trail_s.append(time.perf_counter() - t0)

        manager._record_commit_trail = timed

    def group(gid):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            return member(gid)

    def member(gid):
        store = StoreServer()
        manager = make_manager(lighthouse.address(), store, f"diff-group{gid}", plane="tcp")
        trail_s = []
        timed_trail(manager, trail_s)
        try:
            ts = TrainStep(cfg, device="cuda")
            trainer = FTTrainer(manager, ts)
            trainer.init(seed=100)
            while True:
                step = manager.current_step()
                if gid == 1 and step == DIFF_LEAVE_AT and not left.is_set():
                    manager.shutdown(wait=False)
                    left.set()
                    if not back.wait(600):
                        raise TimeoutError("group 0 never took its steps alone")
                    if perturb:
                        with torch.no_grad():
                            next(iter(trainer.params.values())).add_(1.0)
                    manager = make_manager(lighthouse.address(), store, "diff-group1-back",
                                           plane="tcp")
                    timed_trail(manager, trail_s)
                    manager.load_state_dict({"step": step, "batches_committed": 2 * step})
                    trainer._manager = manager
                    manager.set_state_dict_fns(trainer.load_state_dict, trainer.state_dict)
                    ask = manager.start_quorum

                    def asked_first(*args, **kwargs):
                        ask(*args, **kwargs)
                        asked.set()

                    manager.start_quorum = asked_first
                if gid == 0 and step == DIFF_LEAVE_AT + DIFF_AHEAD and left.is_set() \
                        and not back.is_set():
                    back.set()
                    if not asked.wait(600):
                        raise TimeoutError("group 1 never came back")
                    time.sleep(0.5)  # its quorum request reaches the lighthouse first
                _, committed = trainer.step(make_tokens(cfg, 1000 * gid + step, batch, seq))
                calls[gid] += 1
                if committed and manager.current_step() >= DIFF_END \
                        and manager.num_participants() == 2:
                    break
            synchronize()
            return dict(step=manager.current_step(), digest=_state_digest(trainer),
                        stats=dict(manager._checkpoint_transport.last_heal_stats),
                        captures=dict(ts.graphs.captures), trail_s=trail_s)
        except BaseException:
            left.set()
            back.set()
            asked.set()
            raise
        finally:
            manager.shutdown(wait=False)
            store.shutdown()

    torch.cuda.synchronize()
    fa.reset_launches()
    saved = os.environ.get("TORCHFT_HEAL_DIFF")
    os.environ["TORCHFT_HEAL_DIFF"] = "1"
    try:
        res = _run_threads(group, "differential heal")
    finally:
        lighthouse.shutdown()
        if saved is None:
            os.environ.pop("TORCHFT_HEAL_DIFF")
        else:
            os.environ["TORCHFT_HEAL_DIFF"] = saved
    launches = dict(fa.LAUNCHES)
    expect = {n: c * (calls[0] + calls[1]) for n, c in _launches_per_step(cfg).items()}
    return res, launches, expect


def phase_heal_plane(joint_ms):
    """(a) ``crossgroup.measure_striped_heal`` at the headline's state
    (HEAL_BYTES) from one and from two source processes (two started,
    staged at once), over the blob plane; (b) the two sources again, the
    second SIGKILLed from ``header_cb`` (after the plan, before the bulk
    bytes): its ranges re-stripe onto the first;
    (c) a kill of 1 of 3 headline worker processes (phase 12's harness and
    checks): the rejoiner stripes from both survivors; (d) the
    differential heal between two headline trainers (``_diff_heal``), and
    its fallback to the full striped heal on a digest mismatch. Returns the
    flash launches of (c) and (d)."""
    from torchft_tpu_torch.benchmarks.crossgroup import measure_striped_heal

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    plans = {"heal_striped_1src": (1, False), "heal_striped_2src": (2, False),
             "heal_striped_2src_kill": (2, True)}
    rows = dict(zip(plans, measure_striped_heal(HEAL_BYTES, list(plans.values()), "cuda")))
    for name, (nsrc, killed) in plans.items():
        _hold_striped_row(name, rows[name], nsrc - killed, killed)
    log(f"heal plane: heal_striped_speedup (2 sources' GB/s over 1's) "
        f"{rows['heal_striped_2src']['gb_per_sec'] / rows['heal_striped_1src']['gb_per_sec']:.6f}; "
        f"rows {time.perf_counter() - t0:.1f} s")
    kill = phase_recovery(joint_ms, {}, name="heal plane kill 1 of 3", num_groups=3)
    launches = dict(kill)
    for perturb in (False, True):
        tag = "digest mismatch" if perturb else "delta"
        t1 = time.perf_counter()
        res, got, expect = _diff_heal(perturb)
        st = res[1]["stats"]
        trail = sorted(res[0]["trail_s"])
        d = st.get("delta") or {}
        log(f"heal plane differential ({tag}): the healer's heal mode {st.get('mode')}, "
            f"{st.get('bytes')} bytes"
            + (f", {d['changed']} of {d['leaves']} leaves changed since step {d['since_step']} "
               f"({d['changed'] / d['leaves']:.6f} of the leaves), {d['seconds']:.6f} s"
               if d else f", nsources {st.get('nsources')}, stages {st.get('stages')}")
            + f"; the trail's record per step (group 0, {len(trail)} steps): median "
            f"{statistics.median(trail) * 1e3:.3f} ms, max {trail[-1] * 1e3:.3f} ms; sha256 "
            f"group0 {res[0]['digest'][:16]} group1 {res[1]['digest'][:16]} at step "
            f"{res[0]['step']}; graphs captured {[res[g]['captures'] for g in (0, 1)]}; "
            f"launches {got}; {time.perf_counter() - t1:.1f} s")
        check(st.get("mode") == ("striped" if perturb else "delta"),
              f"heal plane differential ({tag}): heal mode {st.get('mode')}")
        if not perturb:
            check(d.get("since_step") == DIFF_LEAVE_AT and 0 < d["changed"] <= d["leaves"],
                  f"heal plane differential: delta {d}")
        check(res[0]["step"] == res[1]["step"] and res[0]["digest"] == res[1]["digest"],
              f"heal plane differential ({tag}): the groups ended with different state")
        check(all(res[g]["captures"] == {"grads": 1, "apply": 1} for g in (0, 1)),
              f"heal plane differential ({tag}): graphs captured "
              f"{[res[g]['captures'] for g in (0, 1)]}")
        check(got == expect, f"heal plane differential ({tag}): launches {got} != {expect}")
        for n in got:
            launches[n] += got[n]
    log(f"heal plane: phase wall {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 16: the local observability plane
# ---------------------------------------------------------------------------

OBS_WARMUP, OBS_STEPS = 2, 20
WATCHDOG_MIN_S, WATCHDOG_HOLD_S = 0.5, 2.0  # the probe's floor and its held step


def _metrics_scrape(manager):
    """GET /metrics of the group's HTTP transport: ({series: value}, the
    families its ``# TYPE`` lines name)."""
    import urllib.request

    url = manager._checkpoint_transport.metadata() + "/metrics"
    with urllib.request.urlopen(url, timeout=10) as resp:
        text = resp.read().decode()
    series, families = {}, set()
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            families.add(line.split()[2])
        elif line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            series[key] = float(value)
    return series, families


def _obs_run(plane, sinks, tmp):
    """The headline graphed as one group in this process on ``plane``,
    OBS_WARMUP + OBS_STEPS steps; with ``sinks`` the trail and span files
    are on (``EVENTS.configure`` / ``TRACER.configure``, what
    TORCHFT_EVENT_TRAIL / TORCHFT_TRACE_PATH do at a process's first
    record). The ledger, rings and counters are reset after the warm-up,
    so what is read covers the timed steps: steps/s, the ledger rows, the
    step_anatomy row, the trail's and spans' counts, a /metrics scrape and
    the flash launches per step."""
    from torchft_tpu_torch import bench, telemetry
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.parallel import ft
    from torchft_tpu_torch.parallel.train_step import TrainStep
    from torchft_tpu_torch.store import StoreServer
    from torchft_tpu_torch.telemetry.tracing import read_spans

    cfg = headline_config()
    arm = f"observability, {plane} plane, sinks {'on' if sinks else 'off'}"
    trail = os.path.join(tmp, f"trail_{plane}.jsonl")
    spans = os.path.join(tmp, f"spans_{plane}.jsonl")
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1)
    store = StoreServer()
    manager = make_manager(lighthouse.address(), store, f"obs-{plane}", plane=plane)
    try:
        ts = TrainStep(cfg, device="cuda", graph=True)
        trainer = ft.FTTrainer(manager, ts)
        trainer.init(seed=0)
        tokens = make_tokens(cfg, 0, HEADLINE["batch"], HEADLINE["seq"])
        for _ in range(OBS_WARMUP):
            check(trainer.step(tokens)[1], f"{arm}: a warm-up step did not commit")
        torch.cuda.synchronize()
        telemetry.reset()
        fa.reset_launches()
        if sinks:
            telemetry.EVENTS.configure(trail)
            telemetry.TRACER.configure(spans)
        t0 = time.perf_counter()
        for _ in range(OBS_STEPS):
            check(trainer.step(tokens)[1], f"{arm}: a step did not commit")
        torch.cuda.synchronize()
        rate = OBS_STEPS / (time.perf_counter() - t0)
        if sinks:
            telemetry.EVENTS.configure(None)
            telemetry.TRACER.configure(None)
        out = {"rate": rate, "launches": {n: c / OBS_STEPS for n, c in fa.LAUNCHES.items()},
               "rows": telemetry.LEDGER.dump()["rows"], "anatomy": bench.step_anatomy_row(),
               "metrics": _metrics_scrape(manager), "summary": telemetry.summary(),
               "captures": dict(ts.graphs.captures)}
        if sinks:
            out["trail"] = telemetry.read_trail(trail)
            out["spans"] = read_spans(spans)
        return out
    finally:
        manager.shutdown(wait=False)
        store.shutdown()
        lighthouse.shutdown()


def _hold_obs_run(plane, res):
    """Phase 16's checks of one run with the sinks on (see phase_observability)."""
    arm = f"observability, {plane} plane"
    rows, an = res["rows"], res["anatomy"]
    worst = max(abs(sum(r["phases"].values()) - r["wall_s"]) for r in rows)
    log(f"{arm}: {len(rows)} ledger rows, worst |sum of phases - wall| {worst:.3e} s (rounded "
        f"to 1 us a phase); wall p50 {an['wall_p50_s'] * 1e3:.3f} ms, p99 "
        f"{an['wall_p99_s'] * 1e3:.3f} ms; phase p50 sum {an['phase_sum_p50_s'] * 1e3:.3f} ms, "
        f"reconciliation_pct {an['reconciliation_pct']}, ft_control_overhead_pct "
        f"{an['ft_control_overhead_pct']}")
    log(f"{arm}: phases p50/p99 ms " + ", ".join(
        f"{k} {v['p50_s'] * 1e3:.3f}/{v['p99_s'] * 1e3:.3f}" for k, v in an["phases"].items())
        + f"; native latency {an.get('native_latency')}")
    check(len(rows) == OBS_STEPS - 1 and worst <= 1e-5,
          f"{arm}: ledger rows {len(rows)}, worst sum-to-wall error {worst}")
    check(an["reconciliation_pct"] is not None and abs(an["reconciliation_pct"]) <= 5.0,
          f"{arm}: the p50 composition is {an['reconciliation_pct']}% off the wall p50")
    commits = sorted(r["step"] for r in res["trail"] if r["event"] == "commit")
    names = [s["name"] for s in res["spans"]]
    per_step = {n: names.count(n) for n in ("quorum", "quorum_rpc", "should_commit",
                                            "should_commit_rpc")}
    log(f"{arm}: trail {len(res['trail'])} records, commit events at steps {commits}; spans "
        f"{per_step}")
    check(len(commits) == OBS_STEPS and len(set(commits)) == OBS_STEPS
          and commits == list(range(commits[0], commits[0] + OBS_STEPS)),
          f"{arm}: commit events {commits}, expected one per step")
    check(per_step["quorum_rpc"] == OBS_STEPS and per_step["should_commit_rpc"] == OBS_STEPS,
          f"{arm}: spans {per_step}, expected one quorum_rpc and one should_commit_rpc a step")
    from torchft_tpu_torch import telemetry

    m, families = res["metrics"]
    tft = sorted(f for f in families if f.startswith("tft_"))
    catalog = sorted(telemetry.REGISTRY.dump())
    quorums = m.get("tft_quorums_total", 0.0)
    ar_ops = sum(v for k, v in m.items()
                 if k.startswith("tft_collective_ops_total{") and 'op="allreduce"' in k)
    ar_bytes = sum(v for k, v in m.items() if k.startswith("tft_allreduce_bytes_total{"))
    log(f"{arm}: /metrics lists {len(tft)} tft_ families; tft_quorums_total {quorums:.0f}, "
        f"allreduce ops {ar_ops:.0f}, allreduce bytes {ar_bytes:.0f}; summary {res['summary']}")
    check(tft == catalog and quorums == OBS_STEPS and ar_ops > 0 and ar_bytes > 0,
          f"{arm}: /metrics: families {tft} (the catalog: {catalog}), quorums {quorums}, "
          f"allreduce ops {ar_ops}, bytes {ar_bytes}")
    expect = _launches_per_step(headline_config())
    log(f"{arm}: flash launches per step {res['launches']}, graphs captured {res['captures']}")
    check(res["launches"] == expect and res["captures"] == {"grads": 1, "apply": 1},
          f"{arm}: launches per step {res['launches']} (expected {expect}), captures "
          f"{res['captures']}")


def _watchdog_probe(tmp):
    """Worker process: the headline graphed on the TCP plane (its
    allreduces enter the flight recorder at world size 1 too) with
    TORCHFT_WATCHDOG_MIN_S at WATCHDOG_MIN_S, three steps, then a step held
    WATCHDOG_HOLD_S in its quorum (a sleep after start_quorum), then one
    more; prints what the watchdog, the trail and the flight dumps say."""
    import glob

    from torchft_tpu_torch import telemetry
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.parallel import ft
    from torchft_tpu_torch.parallel.train_step import TrainStep
    from torchft_tpu_torch.store import StoreServer

    # the step-0 capture may fire it too; a dump per firing, not one per 5 s
    telemetry.FLIGHT.min_dump_interval_s = 0.0
    cfg = headline_config()
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1)
    store = StoreServer()
    manager = make_manager(lighthouse.address(), store, "watchdog-probe", plane="tcp")
    held = {}
    try:
        trainer = ft.FTTrainer(manager, TrainStep(cfg, device="cuda", graph=True))
        trainer.init(seed=0)
        tokens = make_tokens(cfg, 0, HEADLINE["batch"], HEADLINE["seq"])
        start_quorum = manager.start_quorum

        def watch_stuck():
            # the lighthouse's view of this replica while its step is held:
            # the stall push's heartbeat carries stuck: true
            from torchft_tpu_torch.telemetry.native import poll_cluster

            end = time.monotonic() + WATCHDOG_HOLD_S - 0.1
            while time.monotonic() < end:
                rec = ((poll_cluster(lighthouse.address()) or {}).get("replicas") or {}).get(
                    manager._replica_id, {})
                held.setdefault("stuck_seen", []).append(
                    [round(time.time() - held["t0"], 3), rec.get("stuck"), rec.get("step")])
                time.sleep(0.1)

        def held_quorum(*args, **kwargs):
            start_quorum(*args, **kwargs)
            if manager.current_step() == 3:
                held["t0"] = time.time()
                watcher = threading.Thread(target=watch_stuck, name="stuck_watch")
                watcher.start()
                time.sleep(WATCHDOG_HOLD_S)
                watcher.join()

        manager.start_quorum = held_quorum
        for _ in range(5):
            trainer.step(tokens)
        torch.cuda.synchronize()
        from torchft_tpu_torch.telemetry.native import poll_cluster

        # after the vote the quorum's report carries stuck: false again
        after = poll_cluster(lighthouse.address())["replicas"][manager._replica_id]
        stalls = telemetry.EVENTS.recent("watchdog_stall")
        dumps = []
        for path in sorted(glob.glob(os.path.join(tmp, "tft_flight_*.json"))):
            with open(path) as f:
                d = json.load(f)
            dumps.append({"reason": d["reason"], "ts": d["ts"], "entries": len(d["entries"])})
        print(json.dumps({"stalls": stalls, "dumps": dumps, "held_t0": held["t0"],
                          "stalled_after": manager._watchdog.stalled,
                          "stuck_seen": held.get("stuck_seen", []),
                          "cluster_after": {"stuck": after.get("stuck"), "step": after.get("step")},
                          "trail": [r["event"] for r in telemetry.read_trail(
                              os.path.join(tmp, "trail.jsonl"))]}), flush=True)
    finally:
        manager.shutdown(wait=False)
        store.shutdown()
        lighthouse.shutdown()


def phase_observability():
    """The headline as one group in one process, graphed, OBS_STEPS steps
    each: on the device plane with the trail and span sinks on, then off,
    then on the TCP plane with them on. Holds, in each run with the sinks:
    every ledger row sums to its wall clock; the step_anatomy row's p50
    composition is within 5% of the wall p50; one commit event a step in
    the trail and one quorum_rpc and one should_commit_rpc span a step; a
    /metrics scrape of the group's HTTP transport lists the tft_ families
    with nonzero quorum and allreduce counters; K1-K3 launched per step as
    phase 4 counts. Prints steps/s with and without the sinks. Then a
    worker process whose step is held past TORCHFT_WATCHDOG_MIN_S: the
    watchdog fires (a watchdog_stall event for that step, a flight dump)
    and is disarmed again at its vote."""
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tft_obs_")
    runs = [("device", True), ("device", False), ("tcp", True)]
    res = {}
    for plane, sinks in runs:
        res[(plane, sinks)] = _obs_run(plane, sinks, tmp)
        gc.collect()
        log(f"observability, {plane} plane, sinks {'on' if sinks else 'off'}: "
            f"{res[(plane, sinks)]['rate']:.4f} steps/s ({OBS_STEPS} steps)")
    for plane in ("device", "tcp"):
        _hold_obs_run(plane, res[(plane, True)])
    on, off = res[("device", True)]["rate"], res[("device", False)]["rate"]
    log(f"observability: device plane steps/s with the trail and span sinks {on:.4f}, without "
        f"{off:.4f} ({(off - on) / off * 100:+.2f}% with them; one run each, within the runs' "
        f"spread is no finding)")

    env = dict(os.environ, TORCHFT_WATCHDOG_MIN_S=str(WATCHDOG_MIN_S), TORCHFT_FLIGHT_DIR=tmp,
               TORCHFT_EVENT_TRAIL=os.path.join(tmp, "trail.jsonl"))
    t1 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--watchdog-probe", tmp],
                          env=env, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"watchdog probe exited {proc.returncode}: {proc.stderr[-3000:]}")
    probe = json.loads(proc.stdout.strip().splitlines()[-1])
    fired = [s for s in probe["stalls"] if s["step"] == 3]
    after = [d for d in probe["dumps"] if d["reason"] == "watchdog" and d["ts"] >= probe["held_t0"]]
    log(f"observability, watchdog probe (TORCHFT_WATCHDOG_MIN_S={WATCHDOG_MIN_S}, step 3 held "
        f"{WATCHDOG_HOLD_S} s): stalls {probe['stalls']}; flight dumps {probe['dumps']}; "
        f"stalled after the vote {probe['stalled_after']}; trail events "
        f"{sorted(set(probe['trail']))}; {time.perf_counter() - t1:.1f} s")
    check(fired and fired[0]["elapsed_s"] >= WATCHDOG_MIN_S and after
          and after[0]["entries"] > 0 and not probe["stalled_after"]
          and "watchdog_stall" in probe["trail"] and "flight_dump" in probe["trail"],
          f"observability: the watchdog did not fire on the held step: {probe}")
    # phase 17's stall push: while the step is held, the lighthouse's
    # /cluster.json shows the replica stuck at step 3; after the vote, not
    stuck = [seen for seen in probe["stuck_seen"] if seen[1] is True and seen[2] == 3]
    log(f"fleet plane, stall push: /cluster.json during the held step [s into the hold, stuck, "
        f"step] {probe['stuck_seen']}; after the vote {probe['cluster_after']}")
    check(stuck and probe["cluster_after"]["stuck"] is False,
          f"fleet plane: the held step never showed stuck in /cluster.json: {probe}")
    log(f"observability: phase wall {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 17: the fleet plane
# ---------------------------------------------------------------------------

FLEET_GROUPS, FLEET_STEPS = 3, 40
FLEET_SLOW_GROUP, FLEET_SLOW_FROM, FLEET_SLOW_STEPS = 2, 10, 3.0
# between the steady joint step of three headline workers and the slowed
# one (about four steady steps)
FLEET_SLO_STEP_S = 0.6
FLEET_POLL_S = 0.25  # group 0's monitors' periods (the default is 2 s)
QUORUM_SCALE_GROUPS = "8,32,64"


def phase_fleet():
    """Three headline workers (``benchmarks.recovery.run_fleet``: the
    recovery harness's workers, no kill) on CollectivesTcp's default plane
    with one lighthouse here, graphed, FLEET_STEPS steps; group 2 sleeps
    FLEET_SLOW_STEPS of its steady steps in its local time each step from
    step FLEET_SLOW_FROM; group 0 hosts the straggler monitor and the
    history thread (regression sentinel, critical path) at FLEET_POLL_S;
    every group's step SLO is FLEET_SLO_STEP_S. Read while the workers
    linger after their last step, and held (``recovery.fleet_checks``):
    one sha256, one capture of each graph and 16/8/8 launches a step in
    every worker; /cluster.json, /fleet.json, /timeseries.json and the
    merged /trace; the delta chains without a resync; the straggler and
    regression latches and the critical path on group 2 alone; group 2's
    SLO breach. Prints the piggyback's bytes per step per worker and the
    ``telemetry`` phase's p50/p99. Then ``benchmarks.quorum_scale`` at N
    in QUORUM_SCALE_GROUPS (held: the delta leg's steady bytes below the
    full-JSON leg's at every N) and ``benchmarks.telemetry_overhead``, one
    pair of 2 + 10 steps (printed). Returns the workers' flash launches."""
    from torchft_tpu_torch import bench
    from torchft_tpu_torch.benchmarks.recovery import fleet_checks, run_fleet

    gc.collect()
    torch.cuda.empty_cache()  # the workers need the card's memory
    t0 = time.perf_counter()
    monitors = {"TORCHFT_STRAGGLER_MONITOR": "1", "TORCHFT_REGRESSION_MONITOR": "1",
                "TORCHFT_STRAGGLER_POLL_S": str(FLEET_POLL_S),
                "TORCHFT_REGRESSION_POLL_S": str(FLEET_POLL_S)}
    saved = os.environ.get("DEVICE")
    os.environ["DEVICE"] = "cuda"
    try:
        r = run_fleet(num_groups=FLEET_GROUPS, total_steps=FLEET_STEPS,
                      slow_group=FLEET_SLOW_GROUP, slow_from=FLEET_SLOW_FROM,
                      slow_steps=FLEET_SLOW_STEPS, op_timeout=RECOVERY_OP_TIMEOUT,
                      timeout_s=600.0, env_extra={"TORCHFT_SLO_STEP_S": str(FLEET_SLO_STEP_S)},
                      group_env={0: monitors})
    finally:
        if saved is None:
            os.environ.pop("DEVICE")
        else:
            os.environ["DEVICE"] = saved
    log(f"fleet plane: {FLEET_GROUPS} headline workers, {FLEET_STEPS} steps, group "
        f"{FLEET_SLOW_GROUP} slowed from step {FLEET_SLOW_FROM}: {r['slowed']}; "
        f"TORCHFT_SLO_STEP_S {FLEET_SLO_STEP_S}; {time.perf_counter() - t0:.1f} s")
    ids = r["replica_ids"]
    for g, commits in r["commits"].items():
        gaps = sorted(b["t"] - a["t"] for a, b in zip(commits, commits[1:]))
        before = sorted(b["t"] - a["t"] for a, b in zip(commits, commits[1:])
                        if 3 <= a["step"] < FLEET_SLOW_FROM)
        log(f"fleet plane group{g}: step interval median before the onset "
            f"{statistics.median(before) * 1e3 if before else float('nan'):.3f} ms, over the "
            f"run {statistics.median(gaps) * 1e3:.3f} ms")
    for g, rid in ids.items():
        f = r["finals"][g]
        tel = f["telemetry"]
        blobs = tel["blobs"]
        steady = sorted(blobs[5:]) or [0]
        row = r["cluster"]["replicas"].get(rid, {})
        phase = (row.get("anatomy") or {}).get("phases", {}).get("telemetry", {})
        log(f"fleet plane group{g}: piggyback bytes per step: first blob (full) {blobs[0]}, "
            f"steady deltas (blobs 6 on) median {steady[len(steady) // 2]} max {steady[-1]} over "
            f"{len(blobs)} blobs ({tel['fulls']} full); the last report as one full blob "
            f"{tel['full_blob_now']}, as the full-JSON payload {tel['json_payload_now']} (spans "
            f"apart); telemetry phase p50 {phase.get('p50_s', 0.0) * 1e3:.3f} ms, p99 "
            f"{phase.get('p99_s', 0.0) * 1e3:.3f} ms; /cluster.json step {row.get('step')}, "
            f"slo_breach {row.get('slo_breach')}, local_step_p50_s {row.get('local_step_p50_s')}")
        log(f"fleet plane group{g}: params+AdamW sha256={f['digest']} graphs captured "
            f"{f['captures']}, flash launches per step {f['launches_per_step']}")
    log(f"fleet plane: /fleet.json {json.dumps({k: v for k, v in r['fleet'].items() if k != 'hist'})}"
        f"; wall {r['fleet'].get('hist', {}).get('wall')}")
    log(f"fleet plane: group 0's /critical_path.json {json.dumps(r['critical_path'][0])[:1500]}")
    for name, held, detail in fleet_checks(r, FLEET_SLOW_GROUP, FLEET_SLOW_FROM, FLEET_STEPS):
        log(f"fleet plane, {name}: {'held' if held else 'FAILED'}; {detail[:1500]}")
        check(held, f"fleet plane: {name}: {detail}")
    expect = _launches_per_step(headline_config())
    for g, f in r["finals"].items():
        check(f["captures"] == {"grads": 1, "apply": 1} and f["launches_per_step"] == [expect],
              f"fleet plane: group {g} captured {f['captures']}, launched "
              f"{f['launches_per_step']} a step (expected {expect})")

    t1 = time.perf_counter()
    qs = bench._run_json_subprocess(bench._module("quorum_scale", "--groups",
                                                  QUORUM_SCALE_GROUPS), 600)["quorum_scale"]
    for n in QUORUM_SCALE_GROUPS.split(","):
        row = qs[f"groups_{n}"]
        log(f"quorum_scale groups {n}: {json.dumps(row)}")
        tel = row.get("telemetry", {})
        check("error" not in row and row["errors"] == 0 and "error" not in tel
              and tel["delta_bytes_per_step_per_replica"] < tel["full_bytes_per_step_per_replica"],
              f"quorum_scale groups {n}: {row}")
    log(f"quorum_scale: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    ov = bench._run_json_subprocess(bench._module(
        "telemetry_overhead", "--runs", "1", "--steps", "10", "--warmup", "2"), 600,
        env_extra={"DEVICE": "cuda"})["telemetry_overhead"]
    log(f"telemetry_overhead: {json.dumps(ov)}; {time.perf_counter() - t1:.1f} s (one pair: "
        f"printed, not held)")
    check(ov["steps_per_sec"] > 0 and ov["steps_per_sec_disarmed"] > 0 and ov["piggyback_bytes"] > 0,
          f"telemetry_overhead: {ov}")
    log(f"fleet plane: phase wall {time.perf_counter() - t0:.1f} s")
    return {n: sum(f["launches"][n] for f in r["finals"].values())
            for n in r["finals"][0]["launches"]}


# ---------------------------------------------------------------------------
# phase 18: forensics and the fault plane
# ---------------------------------------------------------------------------

# the headline's gradients ride 7 buckets (ddp's 25 MB plan over its 12
# stacked leaves): 7 gradient allreduces a step on CollectivesTcp
GRAD_BUCKETS = 7
# (a) the victim dies at the 4th bucket of its joint step 10 (0-based), its
# 74th "allreduce" at collective.issue; every group has committed 10 steps
FORENSICS_KILL_NTH = GRAD_BUCKETS * 10 + 4
FORENSICS_STEPS = 20
# (b) the diagnose_straggler scenario: the slowed group's every gradient
# allreduce is issued 200 ms late and every native stripe hop sleeps 60 ms
DIAG_STEPS = 10
DIAG_ISSUE_DELAY_MS, DIAG_DP_DELAY_MS = 200, 60
DIAG_WINDOW_S, DIAG_BURST_HZ = 1.5, 97
DIAG_STRAGGLER = {"TORCHFT_STRAGGLER_FACTOR": "2.0", "TORCHFT_STRAGGLER_K": "3"}
DIAG_POLL_S = 0.25
BOX_PAIRS = 1  # (c) headline steps/s with the black box armed and disarmed, pairs
# phase 19: the runner's scenarios, run at once, and their bounds
FAULT_SCENARIOS = ("torn_cma_pull", "corrupt_divergence", "compiled_kill_commit_vote")
FAULT_STEPS = 10  # the runner's --quick length
FAULT_TIMEOUT_S = 300.0  # per scenario
FAULT_WALL_S = 240.0
FAULT_WORKERS_DONE = {"torn_cma_pull": 2, "corrupt_divergence": 6,
                      "compiled_kill_commit_vote": 2}  # workers that end with a checksum


def _forensics_kill(tmp):
    """(a) Two headline workers (``measure_recovery`` with ``victim_env``)
    on the striped TCP plane with the black box and the fault evidence
    armed under ``tmp/forensics``; group 1's first incarnation kills itself
    (SIGKILL) at its FORENSICS_KILL_NTH gradient allreduce at
    ``collective.issue``, is respawned and heals. Holds the result, the
    evidence, the victim's rings and the postmortem; returns the workers'
    launches."""
    from torchft_tpu_torch.benchmarks.recovery import measure_recovery
    from torchft_tpu_torch.faultinject.core import read_evidence
    from torchft_tpu_torch.telemetry import postmortem

    forensics = os.path.join(tmp, "forensics")
    schedule = {"seed": 7, "rules": [{"site": "collective.issue", "match": "allreduce",
                                      "nth": FORENSICS_KILL_NTH, "action": "kill", "sig": 9}]}
    t0 = time.perf_counter()
    r = measure_recovery(
        total_steps=FORENSICS_STEPS, op_timeout=RECOVERY_OP_TIMEOUT, heartbeat_timeout_ms=LEASE_MS,
        timeout_s=600.0,
        env_extra={"DEVICE": "cuda", "TORCHFT_DP_CMA": "0",
                   "TORCHFT_BLACKBOX_DIR": os.path.join(forensics, "bb"),
                   "TORCHFT_FAULT_EVIDENCE_DIR": os.path.join(forensics, "evidence")},
        victim_env={"TORCHFT_FAULT_SCHEDULE": json.dumps(schedule)})
    log(f"forensics kill: {json.dumps(schedule)} in group 1's first incarnation; exit code "
        f"{r.victim_rc}; survivor blackout {r.survivor_blackout_s:.3f} s (the respawn's start-up "
        f"in it: quorums need both groups), rejoin {r.rejoin_to_commit_s:.3f} s; planes "
        f"{r.planes}; {time.perf_counter() - t0:.1f} s")
    check(r.victim_rc == -9, f"forensics kill: the victim exited {r.victim_rc}, not by SIGKILL")
    expect = _launches_per_step(headline_config())
    digests = {g: f["digest"] for g, f in r.finals.items()}
    for g, f in sorted(r.finals.items()):
        log(f"forensics kill group{g}: params+AdamW sha256={f['digest']} graphs captured "
            f"{f['captures']}, flash launches per step {f['launches_per_step']}, samples "
            f"{f.get('prof_samples')}")
        check(f["captures"] == {"grads": 1, "apply": 1} and f["launches_per_step"] == [expect],
              f"forensics kill: group {g} captured {f['captures']}, launched "
              f"{f['launches_per_step']} a step (expected {expect})")
    check(sorted(r.finals) == [0, 1] and len(set(digests.values())) == 1,
          f"forensics kill: the groups ended with different states {digests}")
    check(r.finals[1].get("heal") and r.finals[1]["heal"]["bytes"] > 0,
          "forensics kill: the respawned group did not heal")
    evidence = read_evidence(os.path.join(forensics, "evidence"))
    kills = [e for e in evidence if e.get("action") == "kill"]
    log(f"forensics kill, evidence: {evidence}")
    check(len(kills) == 1 and kills[0]["site"] == "collective.issue"
          and kills[0]["hit"] == FORENSICS_KILL_NTH and kills[0]["match"] == "allreduce",
          f"forensics kill: expected one kill record at collective.issue hit "
          f"{FORENSICS_KILL_NTH}, got {evidence}")
    boxes = postmortem.collect_boxes(forensics)
    for b in boxes:
        log(f"forensics kill, box {os.path.basename(b['path'])}: replica {b['replica'] or '-'}, "
            f"{'native' if b['native'] else 'python'}, {len(b['records'])} records, torn "
            f"regions skipped {b['torn']}")
    report = postmortem.analyze(forensics)
    victim, op = report["victim"], report["victim_inflight_op"]
    log(f"forensics kill, postmortem: victim {victim}, in flight {op}, first anomaly "
        f"{report['first_anomaly']}, classification {report['classification']}, survivors in "
        f"flight {report['survivor_inflight']}")
    check(bool(victim) and victim.startswith("group1_") and report["classification"] == "injected",
          f"forensics kill: postmortem victim {victim}, classification "
          f"{report['classification']}")
    mine = [b for b in boxes if b["replica"] == victim and not b["native"]]
    check(len(mine) == 1, f"forensics kill: {len(mine)} Python rings of the victim {victim}")
    box = mine[0]
    native = [b for b in boxes if b["native"] and b["pid"] == box["pid"]]
    check(len(native) == 1 and native[0]["records"],
          f"forensics kill: no native ring of the victim's pid {box['pid']}")
    check(op is not None and op.get("k") == "op_issue" and op.get("op") == "allreduce",
          f"forensics kill: the postmortem's in-flight op is {op}")
    tail = box["records"][-8:]
    completed = {rec.get("fseq") for rec in box["records"] if rec.get("k") == "op_complete"}
    log(f"forensics kill, the victim's last records: {[{k: rec.get(k) for k in ('q', 'ep', 'st', 'k', 'op', 'fseq', 'site')} for rec in tail]}")
    check(any(rec.get("k") == "op_issue" and rec.get("fseq") == op["fseq"] for rec in tail)
          and op["fseq"] not in completed,
          f"forensics kill: the gradient op {op} is not among the victim's last records as "
          "issued and never completed")
    cli = subprocess.run([sys.executable, "-m", "torchft_tpu_torch.telemetry.postmortem",
                          forensics], capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    for line in cli.stdout.splitlines():
        log(f"forensics kill, postmortem CLI | {line}")
    check(cli.returncode == 0, f"forensics kill: the postmortem CLI exited {cli.returncode}: "
          f"{cli.stderr[-2000:]}")
    return [f["launches"] for f in r.finals.values()]


def _diag_leg(tmp, name, inject):
    """One leg of (b): two headline workers (``run_fleet``) on the striped
    TCP plane, both hosting the straggler monitor and a diagnosis engine on
    one shared directory with the torch trace armed; ``inject`` slows group
    1 (its gradient allreduces issued DIAG_ISSUE_DELAY_MS late, its stripe
    hops DIAG_DP_DELAY_MS each). Returns (run_fleet's result, the leg's
    directories)."""
    from torchft_tpu_torch.benchmarks.recovery import run_fleet

    leg = os.path.join(tmp, name)
    dirs = {"diag": os.path.join(leg, "diag"), "evidence": os.path.join(leg, "evidence")}
    env = {"DEVICE": "cuda", "TORCHFT_DP_CMA": "0", "TORCHFT_DIAG_DIR": dirs["diag"],
           "TORCHFT_DIAG_WINDOW_S": str(DIAG_WINDOW_S), "TORCHFT_PROF_BURST_HZ": str(DIAG_BURST_HZ),
           "TORCHFT_DIAG_TORCH": "1", "TORCHFT_STRAGGLER_MONITOR": "1",
           "TORCHFT_STRAGGLER_POLL_S": str(DIAG_POLL_S), **DIAG_STRAGGLER,
           "TORCHFT_FAULT_EVIDENCE_DIR": dirs["evidence"]}
    group_env = {}
    if inject:
        schedule = {"seed": 7, "rules": [{"site": "collective.issue", "match": "allreduce",
                                          "every": 1, "action": "delay",
                                          "ms": DIAG_ISSUE_DELAY_MS}]}
        group_env[1] = {"TORCHFT_FAULT_SCHEDULE": json.dumps(schedule),
                        "TORCHFT_FI_DP_DELAY_MS": str(DIAG_DP_DELAY_MS)}
    t0 = time.perf_counter()
    r = run_fleet(num_groups=2, total_steps=DIAG_STEPS, op_timeout=RECOVERY_OP_TIMEOUT,
                  timeout_s=600.0, env_extra=env, group_env=group_env)
    log(f"diagnosis, {name} leg: 2 headline workers, {DIAG_STEPS} steps, group 1 "
        f"{'slowed: ' + json.dumps(group_env[1]) if inject else 'not slowed'}; "
        f"{time.perf_counter() - t0:.1f} s")
    expect = _launches_per_step(headline_config())
    digests = {g: f["digest"] for g, f in r["finals"].items()}
    for g, f in sorted(r["finals"].items()):
        commits = r["commits"][g]
        gaps = sorted(b["t"] - a["t"] for a, b in zip(commits, commits[1:]))
        log(f"diagnosis, {name} leg, group{g}: params+AdamW sha256={f['digest']} graphs "
            f"captured {f['captures']}, flash launches per step {f['launches_per_step']}, "
            f"step interval median {statistics.median(gaps) * 1e3:.3f} ms, bundles "
            f"{f['diag_bundles']}, samples by plane {f['prof_samples']}")
        check(f["captures"] == {"grads": 1, "apply": 1} and f["launches_per_step"] == [expect],
              f"diagnosis, {name} leg: group {g} captured {f['captures']}, launched "
              f"{f['launches_per_step']} a step (expected {expect})")
    check(len(set(digests.values())) == 1,
          f"diagnosis, {name} leg: the groups ended with different states {digests}")
    return r, dirs


def _forensics_diagnosis(tmp):
    """(b) ``diagnose_straggler`` at full width (see phase_forensics);
    returns the workers' launches and the bundle's size."""
    from torchft_tpu_torch.faultinject.core import read_evidence
    from torchft_tpu_torch.faultinject.runner import pump_dominance
    from torchft_tpu_torch.telemetry import postmortem
    from torchft_tpu_torch.telemetry.diagnosis import read_bundles
    from torchft_tpu_torch.telemetry.profiler import TRACE_FILE, parse_folded

    r, dirs = _diag_leg(tmp, "injected", inject=True)
    fired = read_evidence(dirs["evidence"])
    bundles = read_bundles(dirs["diag"])
    log(f"diagnosis, injected leg: {len(fired)} injections recorded; bundles "
        f"{[(b.get('bundle'), b.get('replica_id'), (b.get('trigger') or {}).get('event')) for b in bundles]}")
    check(fired, "diagnosis: no injection evidence: the delay never fired")
    check(len(bundles) == 1, f"diagnosis: expected exactly one bundle fleet-wide, got "
          f"{[b.get('bundle') for b in bundles]}")
    b = bundles[0]
    slowed = r["replica_ids"][1]
    check((b.get("trigger") or {}).get("event") == "straggler_detected"
          and str(b.get("replica_id")).startswith("group1_") and b["replica_id"] == slowed,
          f"diagnosis: the bundle is {b.get('trigger')} by {b.get('replica_id')}, not "
          f"straggler_detected by {slowed}")
    files = {f: os.path.join(b["_dir"], f) for f in ("native.folded", "python.folded")}
    texts = {}
    for f, path in files.items():
        with open(path, encoding="utf-8") as fh:
            texts[f] = fh.read()
    delayed, active, top = pump_dominance(texts["native.folded"])
    size = sum(os.path.getsize(os.path.join(root, f))
               for root, _, fs in os.walk(b["_dir"]) for f in fs)
    nsamples = {f: sum(parse_folded(t).values()) for f, t in texts.items()}
    log(f"diagnosis, bundle {b['bundle']}: {size} bytes on disk; window {b['window_s']} s at "
        f"{b['burst_hz']} Hz; samples in the window {nsamples}; active dp.pump samples "
        f"{active}, in the delay frame {delayed}; top active stack {top[:400]!r}")
    check(active and ("sleep_ms" in top or "nanosleep" in top) and delayed * 2 >= active,
          f"diagnosis: the injected delay is not dominant in the slowed group's native hot "
          f"stack: {delayed}/{active}, top {top[:400]!r}")
    check(nsamples["python.folded"] > 0, "diagnosis: python.folded is empty")
    trace = os.path.join(b["_dir"], "torch_trace", TRACE_FILE)
    check(b.get("torch_trace") is True and os.path.isfile(trace),
          f"diagnosis: the bundle carries no torch trace ({b.get('files')})")
    with open(trace, encoding="utf-8") as fh:
        events = json.load(fh).get("traceEvents", [])
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            for name in ("flash_fwd", "flash_dq", "flash_dkv"):
                if f"{name}_wgmma" in e.get("name", ""):
                    kernels[name] = kernels.get(name, 0) + 1
    log(f"diagnosis, torch trace: {len(events)} events, {os.path.getsize(trace)} bytes; flash "
        f"kernels by name {kernels}")
    check(set(kernels) == {"flash_fwd", "flash_dq", "flash_dkv"},
          f"diagnosis: the bundle's torch trace names {kernels}, not the three flash kernels")
    report = postmortem.analyze(os.path.join(tmp, "injected"), bundles_dir=dirs["diag"])
    caps = [rec for rec in report["timeline"] if rec.get("k") == "diagnosis_captured"]
    log(f"diagnosis, postmortem --bundles: {[(c.get('bundle'), c.get('ep'), c.get('st'), c.get('trigger')) for c in caps]}")
    check([c.get("bundle") for c in caps] == [b["bundle"]],
          f"diagnosis: the postmortem timeline folds {caps}, not the bundle")
    index = r["diagnosis"]
    log(f"diagnosis, the lighthouse's /diagnosis.json: {json.dumps(index)[:1500]}")
    listed = index.get("replicas", {}).get(slowed, {})
    check(index.get("bundles_total") == 1 and listed.get("last") == b["bundle"],
          f"diagnosis: /diagnosis.json does not list the bundle: {index}")

    ctl, ctl_dirs = _diag_leg(tmp, "control", inject=False)
    ctl_bundles = read_bundles(ctl_dirs["diag"])
    log(f"diagnosis, control leg: bundles {[c.get('bundle') for c in ctl_bundles]}; "
        f"/diagnosis.json {json.dumps(ctl['diagnosis'])[:500]}")
    check(not ctl_bundles, f"diagnosis: the control leg wrote {len(ctl_bundles)} bundles")
    launches = [f["launches"] for f in r["finals"].values()]
    launches += [f["launches"] for f in ctl["finals"].values()]
    return launches


def _box_rate(armed, tmp):
    """The headline as one group in this process (``bench.train_bench``,
    OBS_WARMUP + OBS_STEPS steps, device plane) with this process's black
    box armed under ``tmp`` or not: steps/s."""
    from torchft_tpu_torch import bench, telemetry

    telemetry.BLACKBOX.configure(os.path.join(tmp, f"box_{time.time_ns()}.bb") if armed
                                 else None)
    try:
        return bench.train_bench(headline_config(), HEADLINE["batch"], HEADLINE["seq"], OBS_STEPS,
                                 OBS_WARMUP, averaging=True)[0]
    finally:
        telemetry.BLACKBOX.configure(None)


def phase_forensics():
    """Forensics and the fault plane on the card, headline worker processes
    (the recovery harness's, graphed, on CollectivesTcp's striped TCP
    plane, one lighthouse here).

    (a) Kill and postmortem: the black box and the fault evidence armed;
    group 1's first incarnation carries a ``collective.issue`` kill at its
    FORENSICS_KILL_NTH gradient allreduce, dies, is respawned and heals.
    Held: one sha256 of params and AdamW state; one evidence record of the
    kill; the victim's Python and native rings recovered, their last
    records holding the gradient op issued and never completed;
    ``postmortem.analyze`` names group 1's replica the victim with that op
    in flight and calls the incident ``injected``; the CLI exits 0.

    (b) Diagnosis (the JAX package's ``diagnose_straggler``): both groups
    host the straggler monitor (factor 2.0, K 3, poll 0.25 s) and a
    diagnosis engine on one directory (1.5 s window, 97 Hz burst, the torch
    trace armed); group 1's gradient allreduces are issued 200 ms late and
    its stripe hops sleep 60 ms. Held: one bundle fleet-wide, group 1's,
    on ``straggler_detected``; the delay frame dominant in its active
    ``dp.pump`` stacks; ``python.folded`` not empty; the torch trace names
    the three flash kernels; the postmortem folds it as
    ``diagnosis_captured``; the lighthouse's ``/diagnosis.json`` lists it;
    one sha256 and 16/8/8 a step in every worker. The control leg, with no
    injection, writes no bundle.

    (c) Printed: ``benchmarks.profiler_overhead`` (one pair), the
    headline's steps/s with this process's black box armed and disarmed
    (BOX_PAIRS pairs), the bundle's size and the samples per plane.

    (a), (b) and ``profiler_overhead`` run at once, each its own worker
    processes and lighthouse (DEVICE=cuda in the workers' environment);
    (b)'s injected and control legs stay in turn, and the in-process
    steps/s of (c) come after them. Returns the workers' flash launches."""
    import tempfile

    from torchft_tpu_torch import bench

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tft_torch_forensics_")

    def timed(name, fn):
        start = time.perf_counter()
        out = fn()
        log(f"forensics: {name} {time.perf_counter() - start:.1f} s")
        return out

    def overhead():
        return bench._run_json_subprocess(bench._module(
            "profiler_overhead", "--runs", "1", "--steps", "10", "--warmup", "2"), 600,
            env_extra={"DEVICE": "cuda"})["profiler_overhead"]

    with ThreadPoolExecutor(max_workers=3) as pool:
        kill = pool.submit(timed, "kill and postmortem", lambda: _forensics_kill(tmp))
        diag = pool.submit(timed, "diagnosis legs", lambda: _forensics_diagnosis(tmp))
        ov = pool.submit(timed, "profiler_overhead", overhead)
        launches = kill.result() + diag.result()
        ov = ov.result()
    log(f"profiler_overhead: {json.dumps(ov)} (one pair beside (a) and (b): printed, not held)")
    check(ov["steps_per_sec"] > 0 and ov["steps_per_sec_disarmed"] > 0,
          f"profiler_overhead: {ov}")

    t1 = time.perf_counter()
    rates = {True: [], False: []}
    for _ in range(BOX_PAIRS):
        for armed in (True, False):
            rates[armed].append(_box_rate(armed, tmp))
            gc.collect()
    on, off = statistics.median(rates[True]), statistics.median(rates[False])
    log(f"forensics: headline steps/s with the black box armed {rates[True]}, disarmed "
        f"{rates[False]}; medians {on:.4f} / {off:.4f} ({(off - on) / off * 100:+.2f}% armed; "
        f"{BOX_PAIRS} pairs, printed, not held); {time.perf_counter() - t1:.1f} s")
    log(f"forensics: phase wall {time.perf_counter() - t0:.1f} s")
    return {n: sum(x[n] for x in launches) for n in launches[0]}


def _worker_launches(workdir):
    """Each finished worker's flash launches under a scenario's workdir: the
    ``train_bytes`` example prints them on the card before its last line."""
    import glob
    import re

    out = []
    for path in sorted(glob.glob(os.path.join(workdir, "**", "g*.log"), recursive=True)):
        with open(path, errors="replace") as f:
            for line in f:
                m = re.search(r"flash launches \(head dim 32\): (\{.*\})", line)
                if m:
                    out.append(json.loads(m.group(1)))
    return out


def phase_fault_matrix():
    """The port's fault-injection runner on the card: FAULT_SCENARIOS at
    once (a thread each, their own lighthouses and workers), the
    ``train_bytes`` workers in bf16 on the card. Holds each scenario to the
    runner's checks and to its own (below), and every finished worker's
    K1-K3 launches. Returns the workers' summed launches."""
    import re
    import tempfile

    from torchft_tpu_torch.faultinject import runner

    gc.collect()
    torch.cuda.empty_cache()  # the workers need the card's memory
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tft_torch_faultmatrix_")
    scenarios = {s.name: s for s in
                 runner.SCENARIOS + runner.load_compiled_scenarios(runner.COMPILED_DIR)}

    def run(name):
        start = time.perf_counter()
        res, _ = runner.run_one(scenarios[name], os.path.join(tmp, name), FAULT_STEPS,
                                FAULT_TIMEOUT_S, device="cuda")
        return res, time.perf_counter() - start

    with ThreadPoolExecutor(max_workers=len(FAULT_SCENARIOS)) as pool:
        outs = dict(zip(FAULT_SCENARIOS, pool.map(run, FAULT_SCENARIOS)))
    total = {n: 0 for n in ("flash_fwd", "flash_dq", "flash_dkv")}
    for name, (res, wall) in outs.items():
        workers = _worker_launches(os.path.join(tmp, name))
        for w in workers:
            for n in total:
                total[n] += w.get(n, 0)
        log(f"fault matrix {name}: {res.status} in {wall:.1f} s; respawns {res.respawns}, "
            f"evidence records {res.fired}, checksums {res.checksums}; flash launches of the "
            f"{len(workers)} finished workers (head dim 32) {workers}; {res.detail}")
        check(res.status == "passed", f"fault matrix {name}: {res.status}: {res.detail}")
        check(res.fired >= 1, f"fault matrix {name}: no injection fired")
        check(len(workers) == FAULT_WORKERS_DONE[name]
              and all(all(w.get(n, 0) > 0 for n in total) for w in workers),
              f"fault matrix {name}: {len(workers)} finished workers printed launches "
              f"{workers} (expected {FAULT_WORKERS_DONE[name]}, each launching K1-K3)")
    check(outs["torn_cma_pull"][0].respawns == 0,
          "fault matrix torn_cma_pull: the victim of a torn pull died")
    check(outs["compiled_kill_commit_vote"][0].respawns >= 1,
          "fault matrix compiled_kill_commit_vote: the scheduled kill never respawned the victim")
    m = re.search(r"sentinel latched at step (\d+) \(corrupt at (\d+|None)\)",
                  outs["corrupt_divergence"][0].detail)
    check(m is not None, "fault matrix corrupt_divergence: no latch step in the runner's detail")
    log(f"fault matrix corrupt_divergence: the sentinel latched at step {m.group(1)}, the "
        f"average was corrupted at step {m.group(2)}")
    check(m.group(2) != "None" and int(m.group(1)) <= int(m.group(2)) + 1,
          "fault matrix corrupt_divergence: the latch is not within one commit of the injection")
    wall = time.perf_counter() - t0
    log(f"fault matrix: phase wall {wall:.1f} s (bound {FAULT_WALL_S:.0f} s), workdir {tmp}")
    check(wall <= FAULT_WALL_S, f"fault matrix: the phase took {wall:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phase 20: the deployment plane
# ---------------------------------------------------------------------------

DEPLOY_WALL_S = 240.0
DEPLOY_STEPS = 12  # leg (a)'s train_bytes run
# group 1 dies once its trace shows this step index committed (its fifth
# committed step: the newest checkpoint is then step 4's, CKPT_EVERY=2)
DEPLOY_KILL_AFTER = 4
RESUME_STEPS = (3, 6)  # leg (b): 3 steps with a checkpoint each, then resumed to 6
PROXY_STEPS = 6
PROXY_KILL_AT = 3  # leg (c): group 0's child is killed before this step
PROXY_TIMED_STEPS = 3  # leg (c): joint steps timed once the other legs are done
PROXY_OP_TIMEOUT_S = 60.0
_DONE_LINE = r"done: (?:outer_)?step=(\d+) param_checksum=(-?[\d.]+)"
_LAUNCHES_LINE = r"flash launches \(head dim 32\): (\{.*\})"


def _launcher(argv, env_extra, log_dir, timeout_s):
    """``python -m torchft_tpu_torch.launcher --log-dir log_dir <argv>`` on
    the card; returns (the Popen, a function that waits for it and returns
    (rc, the launcher's output))."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    env.pop("DEVICE", None)  # the workers' default: the card
    env.update(env_extra)
    os.makedirs(log_dir, exist_ok=True)
    out_path = os.path.join(log_dir, "launcher.out")
    with open(out_path, "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torchft_tpu_torch.launcher", "--log-dir", log_dir, *argv],
            env=env, stdout=out, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)))

    def wait():
        try:
            rc = proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "timeout"
        with open(out_path, errors="replace") as f:
            return rc, f.read()

    return proc, wait


def _worker_logs(log_dir):
    import glob

    return {os.path.basename(p): open(p, errors="replace").read()
            for p in sorted(glob.glob(os.path.join(log_dir, "g*_r*_i*.log")))}


def _done_and_launches(text):
    """The worker's last ``done:`` (step, checksum) and its flash launches."""
    import re

    done = re.findall(_DONE_LINE, text)
    launches = re.findall(_LAUNCHES_LINE, text)
    return (done[-1] if done else None), (json.loads(launches[-1]) if launches else None)


def _children_of(ppid):
    """Pids whose parent is ``ppid``, from ``/proc/<pid>/stat``."""
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # the comm field may hold spaces: the ppid is the second field after ')'
        if int(stat.rpartition(")")[2].split()[1]) == ppid:
            out.append(int(name))
    return out


def _group_worker_pid(launcher_pid, gid):
    for pid in _children_of(launcher_pid):
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                env = f.read().split(b"\0")
        except OSError:
            continue
        if f"REPLICA_GROUP_ID={gid}".encode() in env:
            return pid
    return None


def _log_times(text, pattern):
    """Wall times (epoch s) of the log lines matching ``pattern`` (the
    examples' ``%(asctime)s`` prefix)."""
    import datetime
    import re

    out = []
    for line in text.splitlines():
        m = re.match(r"(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3}) ", line)
        if m and re.search(pattern, line):
            out.append((datetime.datetime.strptime(m.group(1), "%Y-%m-%d %H:%M:%S,%f")
                        .timestamp(), line))
    return out


def _deploy_kill_resume(tmp):
    """(a) kill, respawn and resume under the launcher (see phase_deployment)."""
    import re

    from torchft_tpu_torch.data import DistributedSampler, step_indices
    from torchft_tpu_torch.examples.train_bytes import SEQ

    logs = os.path.join(tmp, "a")
    corpus = os.path.join(tmp, "corpus.bin")
    trace = os.path.join(logs, "trace{group}.jsonl")
    proc, wait = _launcher(
        ["--groups", "2", "--min-replicas", "2", "--max-restarts", "2", "--",
         sys.executable, "-m", "torchft_tpu_torch.examples.train_bytes"],
        {"CKPT_DIR": os.path.join(logs, "ckpt"), "CKPT_EVERY": "2", "STEPS": str(DEPLOY_STEPS),
         "TRACE_PATH": trace, "DATA_PATH": corpus}, logs, DEPLOY_WALL_S)
    victim_trace = trace.replace("{group}", "1")
    deadline = time.monotonic() + DEPLOY_WALL_S
    killed_at = pid = None
    while killed_at is None and time.monotonic() < deadline and proc.poll() is None:
        steps = []
        if os.path.exists(victim_trace):
            with open(victim_trace) as f:
                steps = [json.loads(ln)["step"] for ln in f if ln.strip()]
        if steps and max(steps) >= DEPLOY_KILL_AFTER:
            pid = _group_worker_pid(proc.pid, 1)
            if pid is not None:
                os.kill(pid, 9)
                killed_at = time.time()
        time.sleep(0.1)
    rc, out = wait()
    texts = _worker_logs(logs)
    check(killed_at is not None, f"deployment (a): group 1's worker was never killed (rc {rc}); "
          f"launcher output tail: {out[-1500:]}")
    restarts = re.findall(r"restarted group (\d+) \(restart (\d+)/(\d+)\)", out)
    log(f"deployment (a) kill and resume: SIGKILL of group 1's worker (pid {pid}) after its trace "
        f"showed step {DEPLOY_KILL_AFTER}; launcher exit {rc}, restarts {restarts}; worker logs "
        f"{sorted(texts)}")
    check(rc == 0, f"deployment (a): the launcher exited {rc}; tail: {out[-2000:]}")
    check(restarts == [("1", "1", "2")], f"deployment (a): restarts logged {restarts}, expected "
          "exactly one of group 1")
    respawn = texts.get("g1_r0_i1.log", "")
    survivor = texts.get("g0_r0_i0.log", "")
    resumed = re.search(r"resumed from (\S+) at step (\d+)", respawn)
    check(resumed is not None, f"deployment (a): the respawn did not restore from disk; tail: "
          f"{respawn[-1500:]}")
    restored = int(resumed.group(2))
    first_quorum = respawn.find("reconfiguring for quorum_id")
    check(0 <= resumed.start() < first_quorum, "deployment (a): the respawn restored after its "
          "first quorum (or never joined one)")
    heals = [int(x) for x in re.findall(r"healing: fetching checkpoint metadata from \S+ at step "
                                         r"(\d+)", respawn)]
    survivor_heals = [int(x) for x in re.findall(r"healing: fetching checkpoint metadata from "
                                                  r"\S+ at step (\d+)", survivor)]
    log(f"deployment (a): the respawn restored {os.path.basename(resumed.group(1))} at step "
        f"{restored} before its first quorum; its heals at steps {heals} (forward from the "
        f"restored step); the survivor's heals at steps {survivor_heals}")
    check(restored >= 4, f"deployment (a): restored at step {restored}, expected 4 or later")
    check(all(h >= restored for h in heals), f"deployment (a): the respawn healed backward "
          f"({heals} below its restored step {restored})")
    check(all(h == 0 for h in survivor_heals), f"deployment (a): the survivor healed at "
          f"{survivor_heals} (from the respawn's older state?)")
    done = {name: _done_and_launches(texts.get(name, "")) for name in ("g0_r0_i0.log",
                                                                         "g1_r0_i1.log")}
    sums = {name: d for name, (d, _) in done.items()}
    log(f"deployment (a): step and param_checksum by worker {sums}; flash launches (head dim 32) "
        f"by finished worker { {n: lc for n, (_, lc) in done.items()} }")
    check(all(d is not None and d[0] == str(DEPLOY_STEPS) for d in sums.values())
          and len({d[1] for d in sums.values()}) == 1,
          f"deployment (a): the groups ended at {sums}, not one checksum at step {DEPLOY_STEPS}")
    # the blackout (the recovery harness's): the survivor's last commit
    # before the kill to its first after its stall, i.e. the longest gap
    # between its commits from there on (it cannot commit alone, and the
    # step in flight at the kill may still commit)
    commits, prev = [], -1
    for t, line in _log_times(survivor, r"train_bytes: step=\d+ participants="):
        step = int(re.search(r"step=(\d+)", line).group(1))
        if step > prev:
            commits.append(t)
        prev = step
    last_pre = [t for t in commits if t <= killed_at][-1:]
    tail = last_pre + [t for t in commits if t > killed_at]
    gaps = [b - a for a, b in zip(tail, tail[1:])]
    blackout = max(gaps) if gaps else None
    log(f"deployment (a): survivor blackout (its last commit before the kill to its first "
        f"after the stall) {blackout if blackout is None else round(blackout, 3)} s")
    check(blackout is not None, "deployment (a): the survivor never committed after the kill")
    # the trace invariant: no step (so no sample, within one epoch) trained
    # twice in a group, each batch the sampler's, the groups disjoint
    n_windows = (os.path.getsize(corpus) - 1) // SEQ
    by_step = {}
    for g in (0, 1):
        with open(trace.replace("{group}", str(g))) as f:
            lines = [json.loads(ln) for ln in f if ln.strip()]
        done_steps = [ln["step"] for ln in lines]
        check(done_steps == sorted(set(done_steps)), f"deployment (a): group {g} trained steps "
              f"{done_steps} (one twice?)")
        ids = [i for ln in lines for i in ln["ids"]]
        check(len(ids) == len(set(ids)), f"deployment (a): group {g} trained a sample twice")
        sampler = DistributedSampler(n_windows, replica_group=g, num_replica_groups=2,
                                     shuffle=True, seed=0)
        for ln in lines:
            check(ln["ids"] == step_indices(sampler, ln["step"], 8).tolist(),
                  f"deployment (a): group {g} step {ln['step']} trained the wrong samples")
            by_step.setdefault(ln["step"], {})[g] = set(ln["ids"])
    check(all(not (v[0] & v[1]) for v in by_step.values() if len(v) == 2),
          "deployment (a): the groups' samples overlap")
    log(f"deployment (a): traces hold steps {sorted(by_step)}; no step trained twice, groups "
        "disjoint")
    return {"blackout_s": blackout, "launches": [lc for _, lc in done.values()]}


def _deploy_total_failure(tmp):
    """(b) total failure: a straight 6-step group beside a 3-step group with
    a checkpoint every step, which a fresh launcher resumes to 6."""
    import re

    corpus = os.path.join(tmp, "corpus.bin")
    ckpt = os.path.join(tmp, "b", "ckpt")
    base = {"DATA_PATH": corpus, "CKPT_EVERY": "1"}
    cmd = ["--groups", "1", "--max-restarts", "0", "--",
           sys.executable, "-m", "torchft_tpu_torch.examples.train_bytes"]
    _, wait_straight = _launcher(cmd, dict(base, STEPS=str(RESUME_STEPS[1])),
                                 os.path.join(tmp, "b", "straight"), DEPLOY_WALL_S)
    _, wait_first = _launcher(cmd, dict(base, STEPS=str(RESUME_STEPS[0]), CKPT_DIR=ckpt),
                              os.path.join(tmp, "b", "first"), DEPLOY_WALL_S)
    runs = {"first": wait_first()}
    _, wait_resumed = _launcher(cmd, dict(base, STEPS=str(RESUME_STEPS[1]), CKPT_DIR=ckpt),
                                os.path.join(tmp, "b", "resumed"), DEPLOY_WALL_S)
    runs["resumed"] = wait_resumed()
    runs["straight"] = wait_straight()
    res, launches = {}, []
    for name, (rc, out) in runs.items():
        text = _worker_logs(os.path.join(tmp, "b", name)).get("g0_r0_i0.log", "")
        check(rc == 0, f"deployment (b) {name}: exit {rc}; tail: {text[-1500:]}{out[-500:]}")
        done, lc = _done_and_launches(text)
        res[name] = (done, re.search(r"resumed from \S+ at step (\d+)", text))
        launches.append(lc)
    log(f"deployment (b) total failure: straight {res['straight'][0]}, first "
        f"{res['first'][0]}, resumed {res['resumed'][0]} (restored at step "
        f"{res['resumed'][1] and res['resumed'][1].group(1)})")
    check(res["resumed"][1] is not None and res["resumed"][1].group(1) == str(RESUME_STEPS[0]),
          "deployment (b): the fresh process did not restore the 3-step checkpoint")
    check(res["straight"][0] == res["resumed"][0]
          and res["straight"][0][0] == str(RESUME_STEPS[1]),
          f"deployment (b): resumed {res['resumed'][0]} is not bit-identical to the straight "
          f"run's {res['straight'][0]}")
    log(f"deployment (b): param_checksums bit-identical {res['straight'][0][1]}; flash launches "
        f"(head dim 32) by run {launches}")
    return {"launches": launches}


def _deploy_proxy(tcp_joint_ms, others_done):
    """(c) CollectivesProxy at the headline width (see phase_deployment).
    After the checked steps, once ``others_done`` is set (the other legs'
    worker processes no longer share the host's cores), PROXY_TIMED_STEPS
    more joint steps time the proxy's hop against phase 5's plane."""
    import functools

    from torchft_tpu_torch.checkpointing import HTTPTransport
    from torchft_tpu_torch.collectives import CollectivesTcp
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.parallel.ft import FTTrainer
    from torchft_tpu_torch.parallel.train_step import TrainStep, synchronize
    from torchft_tpu_torch.proxy import CollectivesProxy
    from torchft_tpu_torch.store import StoreServer

    cfg = headline_config()
    batch, seq = HEADLINE["batch"], HEADLINE["seq"]
    timeout = timedelta(seconds=PROXY_OP_TIMEOUT_S)
    # the inner plane is phase 5's Python ring, so the joint step compares
    # with phase 5's: the difference is the proxy's hop
    factory = functools.partial(CollectivesTcp, timeout=timeout, native_plane=False)
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=2)
    calls = {0: 0, 1: 0}

    def member(gid):
        store = StoreServer()
        proxy = CollectivesProxy(factory, timeout=timeout)
        manager = Manager(collectives=proxy, load_state_dict=None, state_dict=None,
                          min_replica_size=2, replica_id=f"proxy-group{gid}",
                          store_addr=store.address(), rank=0, world_size=1,
                          lighthouse_addr=lighthouse.address(), timeout=timeout,
                          checkpoint_transport=HTTPTransport(timeout=timeout))
        stream = torch.cuda.Stream()
        rows, planes = [], []
        try:
            with torch.cuda.stream(stream):
                ts = TrainStep(cfg, device="cuda")
                trainer = FTTrainer(manager, ts)
                trainer.init(seed=0)
                tokens = make_tokens(cfg, 30 + gid, batch, seq)
                while manager.current_step() < PROXY_STEPS + PROXY_TIMED_STEPS:
                    step = manager.current_step()
                    if step == PROXY_STEPS:
                        others_done.wait(timeout=DEPLOY_WALL_S)
                    killed = gid == 0 and step == PROXY_KILL_AT and not any(r[3] for r in rows)
                    t0 = time.perf_counter()
                    if killed:
                        proxy.kill_child()
                    loss, committed = trainer.step(tokens)
                    stream.synchronize()
                    calls[gid] += 1
                    rows.append((step, committed, (time.perf_counter() - t0) * 1e3, killed,
                                 manager.num_participants()))
                    planes.append(proxy.plane_info())
                    log(f"proxy group{gid}: step={step} committed={committed} participants="
                        f"{manager.num_participants()} {rows[-1][2]:.3f} ms"
                        + (" (child killed before this step)" if killed else "")
                        + f"; plane {planes[-1]}")
                synchronize()
                return dict(rows=rows, planes=planes, digest=_param_digest(trainer.params),
                            captures=dict(ts.graphs.captures))
        finally:
            manager.shutdown(wait=False)
            store.shutdown()

    torch.cuda.synchronize()
    fa.reset_launches()
    try:
        res = _run_threads(member, "deployment (c) proxy")
    finally:
        lighthouse.shutdown()
    launches = dict(fa.LAUNCHES)
    for gid in (0, 1):
        rows = res[gid]["rows"]
        failed = [r for r in rows if not r[1]]
        # the killed step fails on both groups; every later step commits
        check([r[0] for r in failed] == [PROXY_KILL_AT],
              f"deployment (c) group {gid}: failed steps {[r[0] for r in failed]}, expected "
              f"only step {PROXY_KILL_AT}")
        fail_ms = failed[0][2]
        log(f"deployment (c) group {gid}: the killed step's failure surfaced in "
            f"{fail_ms / 1e3:.3f} s (op timeout {PROXY_OP_TIMEOUT_S:.0f} s)")
        check(fail_ms / 1e3 < PROXY_OP_TIMEOUT_S, f"deployment (c) group {gid}: the failure took "
              f"{fail_ms / 1e3:.3f} s")
        after = [r for r in rows[rows.index(failed[0]) + 1:] if r[0] < PROXY_STEPS]
        check(after and all(r[1] for r in after) and after[-1][0] == PROXY_STEPS - 1,
              f"deployment (c) group {gid}: the steps after the kill {after}")
        planes = res[gid]["planes"]
        check(all(p.startswith("proxy:") and len(p) > len("proxy:") for p in planes),
              f"deployment (c) group {gid}: plane_info() read {sorted(set(planes))}")
        check(res[gid]["captures"] == {"grads": 1, "apply": 1},
              f"deployment (c) group {gid}: graphs captured {res[gid]['captures']}")
    check(res[0]["digest"] == res[1]["digest"], "deployment (c): the groups ended with different "
          "parameters")
    # the joint steps but the first (the capture, the bootstrap heal) and the
    # retried one (the children's respawn): beside the other legs, and alone
    def joint_ms(lo, hi):
        ms = [r[2] for g in (0, 1) for r in res[g]["rows"]
              if r[1] and r[4] == 2 and lo <= r[0] < hi and r[0] not in (0, PROXY_KILL_AT)]
        return statistics.median(ms) if ms else float("nan"), len(ms)

    beside, n_beside = joint_ms(0, PROXY_STEPS)
    alone, n_alone = joint_ms(PROXY_STEPS, PROXY_STEPS + PROXY_TIMED_STEPS)
    log(f"deployment (c) proxy: joint step median wall over the proxy (proxy:python-ring) "
        f"{alone:.3f} ms once the other legs were done ({n_alone} steps), {beside:.3f} ms "
        f"beside their worker processes ({n_beside} steps), against phase 5's "
        f"{tcp_joint_ms:.3f} ms on the Python ring in this process; one sha256 "
        f"{res[0]['digest']}; planes {sorted(set(res[0]['planes'] + res[1]['planes']))}")
    expect = {n: c * (calls[0] + calls[1]) for n, c in _launches_per_step(cfg).items()}
    log(f"deployment (c): {calls[0]} + {calls[1]} steps, kernel launches {launches}")
    check(launches == expect, f"deployment (c) launches {launches} != {expect}")
    return {"joint_ms": alone, "joint_ms_beside": beside, "launches": launches}


def _deploy_examples(tmp):
    """(d) train_ddp with 2 groups and train_diloco with 4 under the
    launcher, at once."""
    runs = {
        "train_ddp": _launcher(["--groups", "2", "--", sys.executable, "-m",
                                "torchft_tpu_torch.examples.train_ddp"], {},
                               os.path.join(tmp, "d", "ddp"), DEPLOY_WALL_S)[1],
        "train_diloco": _launcher(["--groups", "4", "--min-replicas", "2", "--", sys.executable,
                                   "-m", "torchft_tpu_torch.examples.train_diloco"], {},
                                  os.path.join(tmp, "d", "diloco"), DEPLOY_WALL_S)[1],
    }
    groups = {"train_ddp": 2, "train_diloco": 4}
    out = {}
    for name, wait in runs.items():
        rc, text = wait()
        logs = _worker_logs(os.path.join(tmp, "d", "ddp" if name == "train_ddp" else "diloco"))
        done = {n: _done_and_launches(t)[0] for n, t in logs.items()}
        log(f"deployment (d) {name}: launcher exit {rc}; step and param_checksum by worker {done}")
        check(rc == 0, f"deployment (d) {name}: exit {rc}; tail: {text[-1500:]}")
        check(len(done) == groups[name] and all(d is not None for d in done.values())
              and len(set(done.values())) == 1,
              f"deployment (d) {name}: {done}, expected one checksum across "
              f"{groups[name]} groups")
        out[name] = done
    return out


def phase_deployment(tcp_joint_ms, beside=None):
    """Phase 20: the deployment plane, its legs at once in threads (see
    the module docstring). ``beside``: an event set once work that runs at
    the same time (phase 19, in ``main``) is done; leg (c)'s timed steps
    wait for it too. Returns the K1-K3 launches: at head dim 32 those of
    legs (a) and (b)'s finished workers, at 64 leg (c)'s."""
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()  # the workers need the card's memory
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tft_torch_deploy_")
    from torchft_tpu_torch.examples.train_bytes import ensure_corpus

    ensure_corpus(os.path.join(tmp, "corpus.bin"))  # one corpus for legs (a) and (b)
    others_done = threading.Event()
    legs = {"a": lambda: _deploy_kill_resume(tmp), "b": lambda: _deploy_total_failure(tmp),
            "c": lambda: _deploy_proxy(tcp_joint_ms, others_done),
            "d": lambda: _deploy_examples(tmp)}
    walls = {}

    def timed(k):
        start = time.perf_counter()
        try:
            return legs[k]()
        finally:
            walls[k] = time.perf_counter() - start

    with ThreadPoolExecutor(max_workers=len(legs)) as pool:
        futs = {k: pool.submit(timed, k) for k in legs}
        concurrent.futures.wait([f for k, f in futs.items() if k != "c"])
        if beside is not None:
            beside.wait(timeout=DEPLOY_WALL_S)
        others_done.set()
        res, errors = {}, []
        for k, f in futs.items():
            try:
                res[k] = f.result()
            except SystemExit:
                errors.append(k)  # its check() printed the reason
            except Exception:  # noqa: BLE001 — every leg's failure is printed, then the phase fails
                errors.append(k)
                print(f"deployment ({k}) raised:\n{traceback.format_exc()}", file=sys.stderr,
                      flush=True)
    check(not errors, f"deployment: legs {errors} failed")
    deployment = {n: 0 for n in ("flash_fwd", "flash_dq", "flash_dkv")}
    workers = res["a"]["launches"] + res["b"]["launches"]
    check(len(workers) == 5 and all(w and all(w.get(n, 0) > 0 for n in deployment)
                                    for w in workers),
          f"deployment: legs (a) and (b)'s finished workers printed launches {workers}")
    for w in workers:
        for n in deployment:
            deployment[n] += w[n]
    wall = time.perf_counter() - t0
    log(f"deployment: leg walls { {k: round(v, 1) for k, v in sorted(walls.items())} } s")
    log(f"deployment: phase wall {wall:.1f} s (bound {DEPLOY_WALL_S:.0f} s); blackout (a) "
        f"{res['a']['blackout_s']:.3f} s; proxy joint step {res['c']['joint_ms']:.3f} ms alone, "
        f"{res['c']['joint_ms_beside']:.3f} ms beside the other legs; "
        f"launches at head dim 32 {deployment}, at 64 {res['c']['launches']}; workdir {tmp}")
    check(wall <= DEPLOY_WALL_S, f"deployment: the phase took {wall:.1f} s")
    return {"deployment": deployment, "proxy": res["c"]["launches"]}


# ---------------------------------------------------------------------------
# phase 21: the HSDP path (train_hsdp under the launcher)
# ---------------------------------------------------------------------------

HSDP_WALL_S = 240.0
HSDP_TINY_STEPS = 10  # leg (a): the tiny preset at BATCH 8 x SEQ 16
HSDP_KILL_AFTER = 3  # leg (a): group 1's worker dies once it logs its third commit
# leg (b): the llama2-7b preset at full width, its depth cut as phase 9's,
# at Llama 2's context
HSDP_LLAMA = dict(batch=2, seq=4096, steps=3)
_HSDP_LAUNCHES_LINE = r"flash launches \(head dim (\d+)\) over (\d+) steps run: (\{.*\})"


def _hsdp_llama_worker() -> None:
    """``chip_smoke.py --hsdp-llama``: one group of leg (b), under the
    launcher's env contract: ``train_hsdp.train`` on the llama2-7b preset
    at ``LLAMA_LAYERS`` layers, on a one-rank mesh, its step eager: two
    graphed groups at this width do not fit one card beside each other
    (each held 35 GB and the second ran out of memory)."""
    import logging

    from torchft_tpu_torch.examples import train_hsdp
    from torchft_tpu_torch.parallel.mesh import MeshConfig

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    torch.backends.cuda.matmul.allow_tf32 = False
    train_hsdp.train(train_hsdp.preset_config("llama2-7b", n_layers=LLAMA_LAYERS), MeshConfig(),
                     steps=HSDP_LLAMA["steps"], batch=HSDP_LLAMA["batch"],
                     seq=HSDP_LLAMA["seq"], replica_group=int(os.environ["REPLICA_GROUP_ID"]),
                     num_groups=int(os.environ["NUM_REPLICA_GROUPS"]), graph=False)


def _hsdp_done(text):
    """(step, checksum), (head dim, steps run, launches), peak GB of one
    worker's log (None where missing)."""
    import re

    done = re.findall(_DONE_LINE, text)
    launches = re.findall(_HSDP_LAUNCHES_LINE, text)
    peak = re.findall(r"peak device memory ([\d.]+) GB", text)
    return ((done[-1] if done else None),
            ((int(launches[-1][0]), int(launches[-1][1]), json.loads(launches[-1][2]))
             if launches else None),
            (float(peak[-1]) if peak else None))


def _hold_hsdp_captures(leg, name, text):
    """A one-rank group's step replayed from CUDA graphs, each captured once
    (a heal copies into the captured tensors)."""
    import re

    got = re.findall(r"graph captures: (\{.*\})", text)
    captures = json.loads(got[-1]) if got else None
    log(f"hsdp {leg} {name}: graph captures {captures}")
    check(captures == {"grads": 1, "apply": 1},
          f"hsdp {leg} {name}: graph captures {captures}, expected one of each")


def _hold_hsdp_launches(leg, name, launches, layers):
    """K1-K3 launched 2L/L/L a step run (remat "all")."""
    _, runs, got = launches
    expect = {"flash_fwd": 2 * layers * runs, "flash_dq": layers * runs,
              "flash_dkv": layers * runs}
    check(runs > 0 and got == expect, f"hsdp {leg} {name}: launches {got} over {runs} steps, "
          f"expected {expect}")


def _hsdp_tiny(tmp):
    """(a) the tiny preset, two groups of one process, group 1 killed and
    respawned; returns the finished workers' summed launches."""
    import re

    logs = os.path.join(tmp, "a")
    proc, wait = _launcher(
        ["--groups", "2", "--min-replicas", "2", "--max-restarts", "2", "--",
         sys.executable, "-m", "torchft_tpu_torch.examples.train_hsdp"],
        {"MODEL": "tiny", "FSDP": "1", "TP": "1", "BATCH": "8", "SEQ": "16",
         "STEPS": str(HSDP_TINY_STEPS)}, logs, HSDP_WALL_S)
    victim_log = os.path.join(logs, "g1_r0_i0.log")
    deadline = time.monotonic() + HSDP_WALL_S
    pid = None
    while pid is None and time.monotonic() < deadline and proc.poll() is None:
        if os.path.exists(victim_log):
            with open(victim_log, errors="replace") as f:
                if f"step={HSDP_KILL_AFTER} committed=True" in f.read():
                    pid = _group_worker_pid(proc.pid, 1)
                    if pid is not None:
                        os.kill(pid, 9)
        time.sleep(0.1)
    rc, out = wait()
    texts = _worker_logs(logs)
    restarts = re.findall(r"restarted group (\d+) \(restart (\d+)/(\d+)\)", out)
    log(f"hsdp (a) tiny: SIGKILL of group 1's worker (pid {pid}) after its commit of step "
        f"{HSDP_KILL_AFTER}; launcher exit {rc}, restarts {restarts}; worker logs {sorted(texts)}")
    check(pid is not None, f"hsdp (a): group 1's worker was never killed; tail {out[-1500:]}")
    check(rc == 0, f"hsdp (a): the launcher exited {rc}; tail: {out[-2000:]}")
    check(restarts == [("1", "1", "2")], f"hsdp (a): restarts {restarts}, expected one of "
          "group 1")
    respawn = texts.get("g1_r0_i1.log", "")
    heals = re.findall(r"healing: fetching checkpoint metadata from \S+ at step (\d+)", respawn)
    healed = re.findall(r"healed: mode=(\S+) nsources=\d+ bytes=(\d+)", respawn)
    log(f"hsdp (a): the respawn healed at steps {heals} ({healed})")
    check(any(int(h) >= HSDP_KILL_AFTER for h in heals),
          f"hsdp (a): the respawn never healed live past step {HSDP_KILL_AFTER}: {heals}")
    total = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
    sums = {}
    for name in ("g0_r0_i0.log", "g1_r0_i1.log"):
        done, launches, _ = _hsdp_done(texts.get(name, ""))
        log(f"hsdp (a) {name}: step and param_checksum {done}; flash launches (head dim, steps "
            f"run, counts) {launches}")
        check(done is not None and done[0] == str(HSDP_TINY_STEPS),
              f"hsdp (a) {name}: ended at {done}; tail {texts.get(name, '')[-1500:]}")
        check(launches is not None and launches[0] == 8, f"hsdp (a) {name}: no head dim 8 "
              f"launches logged ({launches})")
        _hold_hsdp_launches("(a)", name, launches, 2)
        _hold_hsdp_captures("(a)", name, texts.get(name, ""))
        sums[name] = done[1]
        for k in total:
            total[k] += launches[2][k]
    check(len(set(sums.values())) == 1, f"hsdp (a): the groups ended on {sums}")
    return total


def _hsdp_llama(tmp):
    """(b) the llama2-7b preset at full width and LLAMA_LAYERS layers, two
    groups of one process; returns the workers' summed launches."""
    import re

    logs = os.path.join(tmp, "b")
    proc, wait = _launcher(
        ["--groups", "2", "--min-replicas", "2", "--max-restarts", "0", "--",
         sys.executable, os.path.abspath(__file__), "--hsdp-llama"], {}, logs, HSDP_WALL_S)
    rc, out = wait()
    texts = _worker_logs(logs)
    check(rc == 0, f"hsdp (b): the launcher exited {rc}; tail {out[-2000:]}; workers "
          f"{ {n: t[-1500:] for n, t in texts.items()} }")
    total = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
    sums = {}
    for name in ("g0_r0_i0.log", "g1_r0_i0.log"):
        done, launches, peak = _hsdp_done(texts.get(name, ""))
        losses = [float(x) for x in re.findall(r"committed=\S+ participants=\d+ "
                                               r"loss=([-\d.naif]+)", texts.get(name, ""))]
        log(f"hsdp (b) llama d4096 h32 D128 ff11008 vocab 32000 bf16, {LLAMA_LAYERS} of 32 layers, "
            f"b{HSDP_LLAMA['batch']} s{HSDP_LLAMA['seq']}, {name}: step and param_checksum {done}; "
            f"losses {losses}; peak device memory {peak} GB; flash launches {launches}")
        check(done is not None and done[0] == str(HSDP_LLAMA["steps"]),
              f"hsdp (b) {name}: ended at {done}; tail {texts.get(name, '')[-1500:]}")
        check(losses and all(np.isfinite(losses)), f"hsdp (b) {name}: losses {losses}")
        check(launches is not None and launches[0] == 128, f"hsdp (b) {name}: launches {launches}")
        _hold_hsdp_launches("(b)", name, launches, LLAMA_LAYERS)
        sums[name] = done[1]
        for k in total:
            total[k] += launches[2][k]
    check(len(set(sums.values())) == 1, f"hsdp (b): the groups ended on {sums}")
    return total


def phase_hsdp():
    """Phase 21: ``train_hsdp`` under the port's launcher, two groups of one
    process each (a one-rank NCCL group and DTensor mesh each), legs (a)
    and (b) at once. Returns the K1-K3 launches by head dim (8: leg (a)'s
    finished workers; 128: leg (b)'s)."""
    import tempfile

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tft_torch_hsdp_")
    with ThreadPoolExecutor(max_workers=2) as pool:
        tiny = pool.submit(_hsdp_tiny, tmp)
        llama = pool.submit(_hsdp_llama, tmp)
        out = {8: tiny.result(), 128: llama.result()}
    wall = time.perf_counter() - t0
    log(f"hsdp: phase wall {wall:.1f} s (bound {HSDP_WALL_S:.0f} s), workdir {tmp}")
    check(wall <= HSDP_WALL_S, f"hsdp: the phase took {wall:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 22: chunked attention on the card; pp and sp on gloo
# ---------------------------------------------------------------------------

# (a): the JAX package's picks at S 1024 (``_attn_chunk``, ``chunked_attention``)
CHUNKED_CHUNK, CHUNKED_TIERS = 128, 4
# gradients of the chunked arm against the plain arm, each leaf's
# ||g - ref|| / ||ref||: bf16 products summed in another order (a few ulps,
# 2^-8 each) compounded through 8 layers, with a 4x margin; a dropped tier
# or a wrong mask moves a leaf by O(1)
CHUNKED_GRAD_REL = 2.0 ** -5
CHUNKED_LOSS_TOL = 1e-2  # phase 9's bar for the kernels' loss against plain attention's
CHUNKED_TIMED_STEPS = 5
# (b): attention alone at the long-context bench's longest length, the JAX
# picks there (16 tiers, chunk 128; the JAX code picks 256 at S 16384 only)
CHUNKED_LONG = dict(batch=1, seq=32768, heads=8, head_dim=64, chunk=128, tiers=16)
# K1-K3 at that shape by CUDA graph, warm (phase 3 on an NVIDIA H100 80GB
# HBM3 at 700 W, PERF.md section 6): printed beside, not re-run
K123_LONG_MS = (3.6976, 4.1580, 5.3507)
# (b)'s bars, elementwise as KERNEL_BAR. Chunked attention keeps the JAX
# reference's numerics: the scores are rounded to bf16 before the float32
# softmax (the kernels keep them in float32). A logit's rounding, up to
# 2^-6 at the largest |q.k| scaled, moves P by as much, 4 times the
# kernels' rounding: 2^-4 of the row scale against float32 attention (the
# kernels' plain versions in float32, by query chunks). Against the flash
# op, whose own dQ in the first causal rows is off by its delta from bf16 O
# (OP_BAR's note), twice that.
CHUNKED_LONG_BAR = dict(rtol=2.0 ** -4, atol=1e-5, row_scaled=True)
CHUNKED_OP_BAR = dict(rtol=2.0 ** -3, atol=1e-5, row_scaled=True)
MESH_WALL_S = 120.0  # (c): both pairs of gloo processes, start-up included
MESH_TINY = dict(vocab_size=64, d_model=16, n_layers=2, n_heads=2, head_dim=8, d_ff=32)


def _grads_of(ts, params, tokens):
    loss, grads = ts.grads(params, tokens)
    from torchft_tpu_torch.utils.tree import tree_leaves

    return float(loss), [g.detach().clone() for g in tree_leaves(grads)]


def _grad_rel(got, ref):
    """The worst leaf's ||got - ref|| / ||ref||."""
    return max(float((a - b).norm() / b.norm().clamp_min(1e-30)) for a, b in zip(got, ref))


def _time_grads(ts, params, tokens, steps=CHUNKED_TIMED_STEPS):
    """ms per ``TrainStep.grads`` call (the host clock around ``steps``
    calls after a warm one, the card synchronised at both ends)."""
    ts.grads(params, tokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        ts.grads(params, tokens)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def _chunked_headline():
    """Phase 22 (a): the headline's loss and gradients with
    ``attention_impl="chunked"`` (chunk 128, 4 tiers), eagerly and from a
    CUDA graph, against the ``"plain"`` arm from the same params and
    tokens; ``"auto"`` still launching K1-K3 16/8/8 a step; each arm's
    step timed."""
    from torchft_tpu_torch.models import transformer as T
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.parallel.train_step import TrainStep

    base = headline_config()
    batch, seq = HEADLINE["batch"], HEADLINE["seq"]
    arm = {impl: dataclasses.replace(base, attention_impl=impl)
           for impl in ("chunked", "plain", "auto", "flash")}
    check(T._use_chunked(arm["chunked"], seq) and T._attn_chunk(seq) == CHUNKED_CHUNK
          and T._attn_tiers() is None,
          "attention_impl='chunked' does not take chunk 128 and the default tiers at S 1024")
    check(T._use_flash(arm["auto"], seq, torch.device("cuda")),
          "attention_impl='auto' no longer routes the headline to the kernels")
    params = TrainStep(base, device="cuda", graph=False).init_params(seed=0)
    tokens = make_tokens(base, 0, batch, seq)
    plain_loss, plain_grads = _grads_of(TrainStep(arm["plain"], graph=False), params, tokens)

    fa.reset_launches()
    eager = TrainStep(arm["chunked"], graph=False)
    c_loss, c_grads = _grads_of(eager, params, tokens)
    check(not any(fa.LAUNCHES.values()), f"the chunked arm launched flash kernels: "
                                         f"{dict(fa.LAUNCHES)}")
    graphed = TrainStep(arm["chunked"], graph=True)
    _grads_of(graphed, params, tokens)  # the warm-up and the capture
    g_loss, g_grads = _grads_of(graphed, params, tokens)  # a replay
    same = g_loss == c_loss and all(torch.equal(a, b) for a, b in zip(g_grads, c_grads))
    fa.reset_launches()
    a_loss, a_grads = _grads_of(TrainStep(arm["auto"], graph=False), params, tokens)
    auto_launches = dict(fa.LAUNCHES)
    rel = {"chunked eager": _grad_rel(c_grads, plain_grads),
           "chunked graphed": _grad_rel(g_grads, plain_grads),
           "auto (K1-K3)": _grad_rel(a_grads, plain_grads)}
    log(f"chunked (a) headline d512 L8 h8 ff1408 vocab 32000 bf16, B{batch} x S{seq}, "
        f"chunk {CHUNKED_CHUNK}, {CHUNKED_TIERS} tiers: loss eager {c_loss:.6f}, graphed "
        f"{g_loss:.6f}, plain {plain_loss:.6f}, auto (K1-K3) {a_loss:.6f}; |loss - plain| "
        f"chunked {abs(c_loss - plain_loss):.3e}, auto {abs(a_loss - plain_loss):.3e} (tol "
        f"{CHUNKED_LOSS_TOL:g}); worst leaf ||g - plain|| / ||plain||: "
        + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
        + f" (bar {CHUNKED_GRAD_REL:.4g} for the chunked arms); graphed replay equal to "
        f"eager bitwise: {same}; auto's flash launches per step {auto_launches}")
    check(abs(c_loss - plain_loss) <= CHUNKED_LOSS_TOL, "chunked: the loss disagrees with plain")
    check(rel["chunked eager"] <= CHUNKED_GRAD_REL and rel["chunked graphed"] <= CHUNKED_GRAD_REL,
          "chunked: the gradients disagree with plain attention's")
    check(same, "chunked: the graphed step disagrees with the eager step (bar: bit for bit)")
    check(auto_launches == _launches_per_step(base),
          f"auto: flash launches per step {auto_launches} != {_launches_per_step(base)}")
    del c_grads, g_grads, a_grads, plain_grads
    ms = {"chunked, graphed": _time_grads(graphed, params, tokens),
          "chunked, eager": _time_grads(eager, params, tokens)}
    del graphed
    for name, impl, graph in (("flash (K1-K3), graphed", "flash", True),
                              ("flash (K1-K3), eager", "flash", False),
                              ("plain, graphed", "plain", True)):
        ts = TrainStep(arm[impl], graph=graph)
        ms[name] = _time_grads(ts, params, tokens)
        del ts
        gc.collect()
    log("chunked (a) headline forward+backward (TrainStep.grads, host clock over "
        f"{CHUNKED_TIMED_STEPS} calls): " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()))
    return ms


def _attention_f32_by_chunks(q, k, v, do, chunk=LONG_PLAIN_CHUNK):
    """Causal attention's output and gradients in float32 from the kernels'
    plain versions (``fa.*_plain``, code apart from chunked attention's),
    over query chunks of ``chunk`` rows: packed [BH, S, D] tensors."""
    from torchft_tpu_torch.ops import flash_attention as fa

    pq, pk, pv, pdo = (_pack(x).float() for x in (q, k, v, do))
    s = pq.shape[1]
    rows = [(r0, min(s, r0 + chunk)) for r0 in range(0, s, chunk)]
    o, lse = (torch.cat(x, dim=1) for x in zip(*(fa.fwd_plain(pq, pk, pv, True, rows=r)
                                                 for r in rows)))
    delta = (pdo * o).sum(-1)
    dq = torch.cat([fa.dq_plain(pq, pk, pv, pdo, lse, delta, True, rows=r) for r in rows], dim=1)
    dk = dv = 0
    for r in rows:
        dk_r, dv_r = fa.dkv_plain(pq, pk, pv, pdo, lse, delta, True, rows=r)
        dk, dv = dk + dk_r, dv + dv_r
    return o, dq, dk, dv


def _chunked_long():
    """Phase 22 (b): chunked attention alone at B1 S32768 H8 D64 bf16 (16
    tiers, chunk 128), forward and backward, held against float32 attention
    from the kernels' plain versions at ``CHUNKED_LONG_BAR`` and against the
    flash op at ``CHUNKED_OP_BAR``; its time and peak memory beside the
    op's."""
    from torchft_tpu_torch.ops.attention import chunked_attention

    c = CHUNKED_LONG
    q, k, v, do = _qkv(c["batch"], c["seq"], c["heads"], c["head_dim"], torch.bfloat16,
                       seed=70)

    def chunked():
        qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        o = chunked_attention(qs, ks, vs, causal=True, chunk=c["chunk"], tiers=c["tiers"])
        o.backward(do)
        return o.detach(), qs.grad, ks.grad, vs.grad

    def flash():
        return _op_grads(q, k, v, do, True)

    peak, outs = {}, {}
    for name, fn in (("chunked", chunked), ("flash op", flash)):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        outs[name] = [_pack(x) for x in fn()]
        torch.cuda.synchronize()
        peak[name] = (torch.cuda.max_memory_allocated() - base) / 1e9
    ref = _attention_f32_by_chunks(q, k, v, do)
    tag = (f"chunked (b) b{c['batch']} s{c['seq']} h{c['heads']} d{c['head_dim']} bf16, "
           f"{c['tiers']} tiers of chunk {c['chunk']}")
    for i, what in enumerate(("O", "dq", "dk", "dv")):
        got, op, exact = outs["chunked"][i], outs["flash op"][i], ref[i]
        _hold(f"{tag} {what}", got, exact, "float32 attention (the plain versions)",
              **CHUNKED_LONG_BAR)
        _hold(f"{tag} {what}", got, op, "the flash op", **CHUNKED_OP_BAR)
        err, worst, _, _ = _errs(op, exact, **CHUNKED_LONG_BAR)
        log(f"{tag} {what}, yardstick: the flash op against float32 attention max|err|="
            f"{err:.3e} worst err/bar={worst:.3f} at the first bar")
    del outs, ref
    ms = {"chunked": gpu_time_ms(chunked, reps=3, inner=1),
          "flash op": gpu_time_ms(flash, reps=3, inner=1)}
    log(f"{tag}: forward+backward {ms['chunked']:.3f} ms, peak {peak['chunked']:.3f} GB above "
        f"the inputs; the flash op (K1-K3 and its packing) {ms['flash op']:.3f} ms, peak "
        f"{peak['flash op']:.3f} GB; K1 / K2 / K3 alone by CUDA graph "
        f"{' / '.join(f'{x:.4f}' for x in K123_LONG_MS)} ms (PERF.md section 6, not re-run)")
    return ms, peak


def phase_chunked():
    """Phase 22 (a) and (b) on the card."""
    t0 = time.perf_counter()
    out = {"headline_ms": _chunked_headline()}
    gc.collect()
    torch.cuda.empty_cache()
    out["long_ms"], out["long_peak_gb"] = _chunked_long()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"chunked: phase wall {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 23: K1-K3 at the rest of the shapes the Pallas op takes
# ---------------------------------------------------------------------------

# phase 3's shapes for them, (B, S, H, D) and dtype, by kernels entry:
# float32 at head dim 128 at the Llama width's shape; bf16 at 128 at
# train_hsdp's own BATCH 8 x SEQ 16 (the wgmma kernels, the last tile
# masked); head dim 256 in both types (float32 K1 register-blocked, K2 and
# K3 on the FMA kernels; bf16 K1-K3 on wgmma; phase 23 (c) runs it) and 96
# (padded to 128, wgmma) at B2 S2048, 4096 and 3072 columns a token
SHAPES_TIMED = {
    "d128_f32": ((2, 4096, 32, 128), torch.float32),
    "d128_s16": ((8, 16, 32, 128), torch.bfloat16),
    "d256": ((2, 2048, 16, 256), torch.bfloat16),
    "d256_f32": ((2, 2048, 16, 256), torch.float32),
    "d96": ((2, 2048, 32, 96), torch.bfloat16),
}
# launches a kernel at each timed shape: a few at the FMA kernels' slow
# float32 shapes (tens of ms a launch), few plain reps
SHAPES_REPS = {"d128_f32": (3, 1, 1), "d128_s16": (25, 5, 5), "d256": (10, 2, 2),
               "d256_f32": (3, 1, 2), "d96": (10, 2, 3)}  # (reps, inner, plain reps)
# (a): train_hsdp's llama2-7b preset at its default BATCH 8 x SEQ 16
# (examples/train_hsdp.py's defaults), the depth of phase 9
SHAPES_LLAMA_S16 = dict(batch=8, seq=16)
SHAPES_LOSS_TOL = 1e-2  # phase 9's bar
# (b): the same width at 2 layers in float32 through "flash", B1 S1024; the
# loss within 1e-4 and each leaf's gradient within 1e-3 of plain's in norm
# (float32 throughout: summation order only, about 1e-6)
SHAPES_F32 = dict(layers=2, batch=1, seq=1024)
SHAPES_F32_LOSS_TOL = 1e-4
SHAPES_F32_GRAD_REL = 1e-3
# (c): the preset's 4096 columns a token as 16 heads of 256 (Gemma-7B's head
# width; a TransformerConfig of the port and of the JAX package), bf16,
# "auto", B1 S2048; the loss within SHAPES_LOSS_TOL of plain's
SHAPES_D256 = dict(layers=2, heads=16, head_dim=256, batch=1, seq=2048)
# and each gradient leaf within 2^-5 of plain's in norm: bf16 products
# summed in another order (a few ulps, 2^-8 each) through 2 layers, phase
# 22 (a)'s bar at 8; a wrong K3 moves the K and V projections' leaves by O(1)
SHAPES_D256_GRAD_REL = 2.0 ** -5
# the kernels one eager call of (c) must run, by a piece of their demangled
# names (torch.profiler), and the FMA kernels, which it must not
SHAPES_D256_KERNELS = {"flash_fwd": "flash_fwd_wgmma<256", "flash_dq": "flash_dq_wgmma<256",
                       "flash_dkv": "flash_dkv_wgmma<256"}
SHAPES_D256_NOT = ("flash_fwd_kernel<", "flash_dq_kernel<", "flash_dkv_kernel<")


def _shapes_auto(leg, cfg, batch, seq, what, grad_rel=None):
    """Phase 23 (a) and (c): ``cfg`` (bf16, ``"auto"``) at B``batch`` x
    S``seq``: ``TrainStep.grads`` eagerly and replayed from a CUDA graph
    (bitwise equal), ``_launches_per_step`` flash launches in each, the
    loss within 1e-2 of the plain route's and, given ``grad_rel``, each
    leaf's eager gradient within it of the plain route's in norm. Returns
    the launches of the two calls, the weights, the tokens and the eager
    ``TrainStep``."""
    from torchft_tpu_torch.models import transformer as T
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.parallel.train_step import TrainStep

    check(T._use_flash(cfg, seq, torch.device("cuda")),
          f"shapes ({leg}): attention_impl='auto' does not route {what} to the kernels")
    params = TrainStep(cfg, device="cuda", graph=False).init_params(seed=0)
    tokens = make_tokens(cfg, 0, batch, seq)
    plain_loss, plain_grads = _grads_of(
        TrainStep(dataclasses.replace(cfg, attention_impl="plain"), graph=False), params, tokens)
    expect = _launches_per_step(cfg)
    eager = TrainStep(cfg, graph=False)
    fa.reset_launches()
    e_loss, e_grads = _grads_of(eager, params, tokens)
    eager_launches = dict(fa.LAUNCHES)
    graphed = TrainStep(cfg, graph=True)
    _grads_of(graphed, params, tokens)  # the warm-up and the capture
    fa.reset_launches()
    g_loss, g_grads = _grads_of(graphed, params, tokens)  # a replay
    graph_launches = dict(fa.LAUNCHES)
    same = g_loss == e_loss and all(torch.equal(a, b) for a, b in zip(g_grads, e_grads))
    rel = _grad_rel(e_grads, plain_grads)
    log(f"shapes ({leg}) {what}, {cfg.n_layers} layers, bf16, auto, B{batch} x S{seq}: loss "
        f"eager {e_loss:.6f}, graphed {g_loss:.6f}, plain {plain_loss:.6f}; |loss - plain| "
        f"{abs(e_loss - plain_loss):.3e} (tol {SHAPES_LOSS_TOL:g}); worst leaf ||g - plain|| / "
        f"||plain|| {rel:.3e} (bar {'none' if grad_rel is None else f'{grad_rel:.4g}'}); "
        f"graphed replay equal to eager bitwise: {same}; flash launches eager "
        f"{eager_launches}, replay {graph_launches} (expected {expect} a step)")
    check(abs(e_loss - plain_loss) <= SHAPES_LOSS_TOL,
          f"shapes ({leg}): the loss disagrees with plain")
    check(grad_rel is None or rel <= grad_rel,
          f"shapes ({leg}): the gradients disagree with plain attention's")
    check(same, f"shapes ({leg}): the graphed step disagrees with the eager step (bar: bit for "
          "bit)")
    check(eager_launches == expect and graph_launches == expect,
          f"shapes ({leg}): flash launches {eager_launches} / {graph_launches} != {expect}")
    launches = {n: eager_launches[n] + graph_launches[n] for n in expect}
    return launches, params, tokens, eager


def _shapes_llama_s16():
    """Phase 23 (a): the llama2-7b preset at LLAMA_LAYERS layers, bf16,
    ``"auto"``, at B8 S16 (``_shapes_auto``: 8/4/4 flash launches a call).
    Returns the launches of the two calls."""
    return _shapes_auto(
        "a", llama_config(), SHAPES_LLAMA_S16["batch"], SHAPES_LLAMA_S16["seq"],
        "the llama2-7b preset (head dim 128, S not a multiple of 64: wgmma, the last tile "
        "masked)")[0]


def _shapes_f32():
    """Phase 23 (b): the same width at SHAPES_F32's 2 layers in float32
    through ``"flash"`` (head dim 128: K1 register-blocked, K2 and K3 the
    FMA kernels), B1 S1024: the
    loss within 1e-4 of the plain route's, each leaf's gradient within 1e-3
    in norm, 4/2/2 flash launches. Returns those launches."""
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.parallel.train_step import TrainStep

    c = SHAPES_F32
    cfg = dataclasses.replace(llama_config(c["layers"]), dtype=torch.float32,
                              attention_impl="flash")
    params = TrainStep(cfg, device="cuda", graph=False).init_params(seed=0)
    tokens = make_tokens(cfg, 0, c["batch"], c["seq"])
    plain_loss, plain_grads = _grads_of(
        TrainStep(dataclasses.replace(cfg, attention_impl="plain"), graph=False), params, tokens)
    expect = _launches_per_step(cfg)
    fa.reset_launches()
    f_loss, f_grads = _grads_of(TrainStep(cfg, graph=False), params, tokens)
    launches = dict(fa.LAUNCHES)
    rel = _grad_rel(f_grads, plain_grads)
    log(f"shapes (b) llama2-7b width, {cfg.n_layers} layers, float32, flash, B{c['batch']} x "
        f"S{c['seq']} (head dim 128, float32 kernels): loss {f_loss:.7f}, plain "
        f"{plain_loss:.7f}, |diff| {abs(f_loss - plain_loss):.3e} (tol {SHAPES_F32_LOSS_TOL:g}); "
        f"worst leaf ||g - plain|| / ||plain|| {rel:.3e} (bar {SHAPES_F32_GRAD_REL:g}); flash "
        f"launches {launches} (expected {expect})")
    check(abs(f_loss - plain_loss) <= SHAPES_F32_LOSS_TOL,
          "shapes (b): the loss disagrees with plain")
    check(rel <= SHAPES_F32_GRAD_REL, "shapes (b): the gradients disagree with plain attention's")
    check(launches == expect, f"shapes (b): flash launches {launches} != {expect}")
    return launches


def _shapes_d256():
    """Phase 23 (c): the llama2-7b preset's width as SHAPES_D256's 16 heads
    of 256 at 2 layers, bf16, ``"auto"``, B1 S2048 (``_shapes_auto``: 4/2/2
    flash launches a call, each leaf's gradient within
    SHAPES_D256_GRAD_REL of plain's); one more eager call under ``torch.profiler``
    runs K1-K3 on wgmma (SHAPES_D256_KERNELS) and no FMA kernel. Returns
    the launches of the eager call and the replay."""
    from torch.profiler import ProfilerActivity, profile

    c = SHAPES_D256
    cfg = dataclasses.replace(llama_config(c["layers"]), n_heads=c["heads"],
                              head_dim=c["head_dim"])
    launches, params, tokens, eager = _shapes_auto(
        "c", cfg, c["batch"], c["seq"], f"the llama2-7b width as {cfg.n_heads} heads of "
        f"{cfg.head_dim} (K1-K3 on wgmma)",
        grad_rel=SHAPES_D256_GRAD_REL)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _grads_of(eager, params, tokens)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events() if e.device_type.name == "CUDA"}
    ran = {n: sorted({m for m in names if piece in m}) for n, piece in SHAPES_D256_KERNELS.items()}
    fma = sorted({m for m in names if any(piece in m for piece in SHAPES_D256_NOT)})
    log(f"shapes (c): kernels one eager call ran, by the profiler {ran}; FMA kernels {fma}")
    check(all(ran.values()) and not fma,
          f"shapes (c): the profiler saw {ran} and FMA kernels {fma}")
    return launches


def phase_shapes():
    """Phase 23 (a), (b) and (c) on the card. Returns their flash launches
    by kernels entry ("d128_s16", "d128_f32", "d256")."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"d128_s16": _shapes_llama_s16()}
    gc.collect()
    torch.cuda.empty_cache()
    out["d128_f32"] = _shapes_f32()
    gc.collect()
    torch.cuda.empty_cache()
    out["d256"] = _shapes_d256()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"shapes: phase wall {time.perf_counter() - t0:.1f} s")
    return out


def _mesh_worker(mode, rank, world, port, outdir) -> None:
    """``chip_smoke.py --mesh-worker MODE RANK WORLD PORT DIR``: one gloo
    rank of phase 22 (c) on the host's CPU (``device="cpu"`` asked for:
    NCCL refuses two ranks on one card). ``pp``: the tiny preset at pp 2
    (two microbatches) through ``loss_fn`` against the same weights as one
    stage, unsharded, loss and gradients; ``sp``: ``ring_attention`` over
    sp 2 against plain attention, output and gradients, and the tiny
    preset's loss at sp 2 against the unsharded loss. Rank 0 writes
    ``DIR/<mode>.json``."""
    import torch.distributed as dist

    from torchft_tpu_torch.models import transformer as T
    from torchft_tpu_torch.ops.attention import attention, ring_attention
    from torchft_tpu_torch.parallel.mesh import MeshConfig, P, make_mesh, place, placements
    from torchft_tpu_torch.utils.tree import tree_leaves

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(MeshConfig(**{mode: 2}), "cpu")
        pp = 2 if mode == "pp" else 1
        cfg = T.TransformerConfig(**MESH_TINY, dtype=torch.float32, pp=pp)
        params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        one = dict(params, layers={k: v.reshape(1, -1, *v.shape[2:])
                                   for k, v in params["layers"].items()})
        tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (8, 16)))

        def loss_and_grads(p, toks, c, m):
            leaves = tree_leaves(p)
            for x in leaves:
                x.requires_grad_(True)
            loss = T.loss_fn(p, toks, c, m)
            grads = torch.autograd.grad(loss, leaves)
            return float(loss), [g.full_tensor() if m is not None else g for g in grads]

        sharded = place(tokens, mesh, placements(P(("dp", "fsdp"), "sp"), mesh))
        loss, grads = loss_and_grads(T.place_params(params, mesh), sharded, cfg, mesh)
        ref_loss, ref_grads = loss_and_grads(one, tokens, dataclasses.replace(cfg, pp=1), None)
        res = {"loss": loss, "ref_loss": ref_loss,
               "grad_err": max(float((a.reshape(b.shape) - b).abs().max())
                               for a, b in zip(grads, ref_grads))}
        if mode == "sp":
            g = torch.Generator().manual_seed(1)
            q, k, v, w = (torch.randn(2, 16, 2, 8, generator=g) for _ in range(4))
            qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
            out = ring_attention(*qkv, mesh).full_tensor()
            (out * w).sum().backward()
            ring_grads = []
            for x in qkv:
                dist.all_reduce(x.grad)
                ring_grads.append(x.grad)
            plain_qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
            ref = attention(*plain_qkv)
            (ref * w).sum().backward()
            res["ring_err"] = float((out - ref).abs().max())
            res["ring_grad_err"] = max(float((a - b.grad).abs().max())
                                       for a, b in zip(ring_grads, plain_qkv))
        if rank == 0:
            with open(os.path.join(outdir, f"{mode}.json"), "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def phase_mesh():
    """Phase 22 (c): pp 2 and sp 2 at the tiny preset, two gloo processes
    each on the host's CPU, both pairs at once. Holds the pp 2 loss to the
    one-stage loss (rtol 1e-5) and ring attention to plain attention (atol
    2e-5), their gradients at 2e-5, and the phase's wall to MESH_WALL_S."""
    import socket
    import tempfile

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tft_torch_mesh_")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for mode in ("pp", "sp"):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        for rank in range(2):
            err = open(os.path.join(tmp, f"{mode}_r{rank}.stderr"), "wb")
            procs.append((mode, err, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-worker", mode, str(rank),
                 "2", str(port), tmp], env=env, stdout=subprocess.DEVNULL, stderr=err)))
    try:
        rcs = [p.wait(timeout=max(1.0, MESH_WALL_S - (time.perf_counter() - t0)))
               for _, _, p in procs]
    except subprocess.TimeoutExpired:
        rcs = None
    finally:
        for _, err, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            err.close()
    wall = time.perf_counter() - t0
    if rcs is None or any(rcs):
        tails = [open(e.name, errors="replace").read()[-1500:] for _, e, _ in procs]
        fail(f"mesh (c): workers exited {rcs} after {wall:.1f} s: " + "\n---\n".join(tails))
    res = {m: json.load(open(os.path.join(tmp, f"{m}.json"))) for m in ("pp", "sp")}
    pp, sp = res["pp"], res["sp"]
    log("mesh (c): pp 2 and sp 2 at the tiny preset in two gloo processes each on the host's "
        "CPU (device='cpu' asked for: NCCL refuses two ranks on one card)")
    log(f"mesh (c) pp 2, 2 microbatches: loss {pp['loss']:.7f} against one stage "
        f"{pp['ref_loss']:.7f} (rtol 1e-5); worst gradient |diff| {pp['grad_err']:.3e} (atol "
        "2e-5)")
    log(f"mesh (c) sp 2: ring attention against plain: output |diff| {sp['ring_err']:.3e}, "
        f"gradients {sp['ring_grad_err']:.3e} (atol 2e-5); the tiny preset's loss "
        f"{sp['loss']:.7f} against unsharded {sp['ref_loss']:.7f}, worst gradient |diff| "
        f"{sp['grad_err']:.3e}; phase wall {wall:.1f} s (bound {MESH_WALL_S:.0f} s)")
    for name, r in res.items():
        check(abs(r["loss"] - r["ref_loss"]) <= 1e-5 * abs(r["ref_loss"]),
              f"mesh (c) {name}: the loss disagrees with the unsharded loss")
        check(r["grad_err"] <= 2e-5, f"mesh (c) {name}: the gradients disagree")
    check(sp["ring_err"] <= 2e-5 and sp["ring_grad_err"] <= 2e-5,
          "mesh (c): ring attention disagrees with plain attention")
    check(wall <= MESH_WALL_S, f"mesh (c): the phase took {wall:.1f} s")
    return res


def main() -> None:
    if sys.argv[1:2] == ["--watchdog-probe"]:
        _watchdog_probe(sys.argv[2])
        return
    if sys.argv[1:2] == ["--hsdp-llama"]:
        _hsdp_llama_worker()
        return
    if sys.argv[1:2] == ["--mesh-worker"]:
        mode, rank, world, port, outdir = sys.argv[2:7]
        _mesh_worker(mode, int(rank), int(world), int(port), outdir)
        return
    started = time.perf_counter()
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from torchft_tpu_torch import _native
    from torchft_tpu_torch.ops import flash_attention as fa

    # build the native core and the kernels together; a failed build ends the run
    t0 = time.perf_counter()

    def timed(fn):
        start = time.perf_counter()
        fn()
        return time.perf_counter() - start

    with ThreadPoolExecutor(max_workers=2) as pool:
        native_s, kernels_s = (f.result() for f in [pool.submit(timed, _native.build),
                                                    pool.submit(timed, fa.build)])
    log(f"builds done in {time.perf_counter() - t0:.1f}s (native core {native_s:.1f}s, "
        f"kernels {kernels_s:.1f}s, in parallel)")
    # ptxas -v: each kernel's entry, registers and spills, and any warning
    # (a setmaxnreg that was ignored shows here)
    keep = ("entry function", "Used", "spill", "warning")
    build_log = fa.build_log()
    for line in (build_log or "(no build log: the library was built earlier)").splitlines():
        if any(word in line for word in keep):
            log(f"ptxas | {line.strip()}")
    check_no_spills(build_log)

    def at(name):
        log(f"-- {name} at {time.perf_counter() - started:.1f} s")

    # phase 22 (c) (gloo processes on the host's CPU) beside phase 2, whose
    # checks time nothing and leave the host's cores idle
    at("phases 2 and 22 (c)")
    with ThreadPoolExecutor(max_workers=1) as side:
        mesh = side.submit(phase_mesh)
        errs = phase_kernels()
        errs.update(phase_small_kernels())
        errs.update(phase_long_kernels())
        shape_errs = phase_shape_kernels()
        mesh.result()
    at("phase 3")
    small_timing = {(d, tag): phase_timing(_shape(dict(TINY, head_dim=d)), dtype=dt)
                    for d in (8, 16)
                    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16"))}
    # the plain versions at the Llama width take 36-50 ms a call: 5 reps
    timing = {64: phase_timing(_shape(HEADLINE)), 128: phase_timing(_shape(LLAMA), plain_reps=5),
              32: phase_timing(_shape(BYTES)),
              LONG_WHOLE["seq"]: phase_timing(_shape(LONG_WHOLE), plain_reps=5),
              LONG["seq"]: phase_timing(_shape(LONG), plain_chunk=LONG_PLAIN_CHUNK,
                                        plain_reps=3)}
    shape_timing = {}
    for label, (shape, dtype) in SHAPES_TIMED.items():
        reps, inner, plain_reps = SHAPES_REPS[label]
        # the earlier designs' times beside bf16 K1-K3 at 256 and float32 K1
        shape_timing[label] = phase_timing(
            shape, plain_reps=plain_reps, dtype=dtype, reps=reps, inner=inner,
            earlier=EARLIER_GRAPH_MS if label in ("d256", "d256_f32", "d128_f32") else {})
        gc.collect()
        torch.cuda.empty_cache()
    at("phase 4")
    launches = {64: phase_ft_loop()}
    phase_remat()
    at("phase 22 (a) and (b)")
    phase_chunked()
    at("phase 23")
    shape_launches = phase_shapes()
    at("phases 5-8")
    tcp_groups = phase_two_groups()
    phase_diloco()
    phase_pipeline()
    phase_device_groups(tcp_groups)
    at("phase 9")
    launches[128] = phase_llama()
    # phase 10: phase 8 at train_bytes' model (head dim 32)
    launches[32] = phase_two_groups(plane="device", transport="collectives", own_streams=True,
                                    cfg=bytes_config(), shape=BYTES)["launches"]
    at("phase 11")
    phase_resnet()
    at("phase 12")
    # phase 12 on the Python ring, so its numbers compare with earlier runs
    recovery_launches = phase_recovery(tcp_groups["joint_ms"], {"TORCHFT_NATIVE_PLANE": "0"})
    at("phase 13")
    wire_launches = phase_wire_plane(tcp_groups["joint_ms"])
    at("phase 14")
    long_rows = phase_bench(tcp_groups["joint_ms"])
    at("phase 15")
    heal_launches = phase_heal_plane(tcp_groups["joint_ms"])
    at("phase 16")
    phase_observability()
    at("phase 17")
    fleet_launches = phase_fleet()
    at("phase 18")
    gc.collect()
    torch.cuda.empty_cache()  # the workers need the card's memory
    forensics_launches = phase_forensics()
    # phases 19, 20 and 21 run at once: each is worker processes that
    # mostly start up (import torch, CUDA, the first capture) and run tiny
    # steps (phase 21's Llama width aside), and none checks a time but its
    # own wall; phase 20's timed proxy steps wait for phases 19 and 21 to end
    at("phases 19-21")
    fault_done = threading.Event()
    with ThreadPoolExecutor(max_workers=2) as pool:
        deploy = pool.submit(phase_deployment, tcp_groups["joint_ms"], fault_done)
        hsdp = pool.submit(phase_hsdp)
        try:
            fault_launches = phase_fault_matrix()
            hsdp_launches = hsdp.result()
        finally:
            fault_done.set()
        deploy_launches = deploy.result()
    log(smi)

    kernels = []
    for d in (64, 128, 32):
        t, bounds, sdpa_fwd = timing[d]
        for name in ("flash_fwd", "flash_dq", "flash_dkv"):
            kernels.append({
                # the head dim 64 entries keep the earlier slices' names
                "name": name if d == 64 else f"{name}_d{d}", "head_dim": d, "route": "cuda",
                "kernel": KERNEL_OF[(name, d)],
                "source": SOURCE, "replaces": REPLACES[name], "launches": launches[d][name],
                "max_abs_err": errs[(name, d)], "ms": t[name]["ms"],
                "ms_graph": t[name]["ms_graph"], "ms_cold": t[name]["ms_cold"],
                "plain_ms": t[name]["plain_ms"], "bound_ms": bounds[name][0],
                "bound_by": bounds[name][1],
                "library_ms": sdpa_fwd[0] if name == "flash_fwd" else None,
                "library_ms_graph": sdpa_fwd[1] if name == "flash_fwd" else None,
            })
            if d == 64:
                # phase 12's two worker processes (the survivor, the rejoiner)
                kernels[-1]["launches_kill_rejoin"] = recovery_launches[name]
                # phase 13's two worker processes: the arms, then the kill
                kernels[-1]["launches_wire_plane"] = wire_launches[name]
                # phase 15: the 1-of-3 kill's workers and the differential heals
                kernels[-1]["launches_heal_plane"] = heal_launches[name]
                # phase 17's three workers
                kernels[-1]["launches_fleet_plane"] = fleet_launches[name]
                # phase 18's workers: the kill's and both diagnosis legs'
                kernels[-1]["launches_forensics"] = forensics_launches[name]
                # phase 20's leg (c): two headline groups over CollectivesProxy
                kernels[-1]["launches_proxy"] = deploy_launches["proxy"][name]
            if d == 128:
                # phase 21 (b): train_hsdp's llama2-7b preset at 4 layers
                kernels[-1]["launches_hsdp"] = hsdp_launches[128][name]
            if d == 32:
                # phase 19's train_bytes workers, every scenario's
                kernels[-1]["launches_fault_matrix"] = fault_launches[name]
                # phase 20's legs (a) and (b): the launcher's train_bytes workers
                kernels[-1]["launches_deployment"] = deploy_launches["deployment"][name]
    # head dims 8 and 16 on the FMA kernels, float32 and bf16, timed at the
    # tiny preset's B8 S16 H2: phase 21 (a) runs head dim 8 in float32; no
    # path runs the other three (launches 0)
    for (d, tag), (t, bounds, sdpa_fwd) in small_timing.items():
        for name in ("flash_fwd", "flash_dq", "flash_dkv"):
            kernels.append({
                "name": f"{name}_d{d}" + ("" if tag == "f32" else "_bf16"), "head_dim": d,
                "dtype": "float32" if tag == "f32" else "bfloat16", "seq": TINY["seq"],
                "route": "cuda", "kernel": KERNEL_OF[(name, d, tag)], "source": SOURCE,
                "replaces": REPLACES[name],
                "launches": hsdp_launches[8][name] if (d, tag) == (8, "f32") else 0,
                "max_abs_err": errs[(name, d, tag)], "ms": t[name]["ms"],
                "ms_graph": t[name]["ms_graph"], "ms_cold": t[name]["ms_cold"],
                "plain_ms": t[name]["plain_ms"], "bound_ms": bounds[name][0],
                "bound_by": bounds[name][1],
                "library_ms": sdpa_fwd[0] if name == "flash_fwd" else None,
                "library_ms_graph": sdpa_fwd[1] if name == "flash_fwd" else None,
            })
    # head dim 64 at the long-context bench's lengths: launched by phase 14's
    # long_context rows
    for seq in (LONG_WHOLE["seq"], LONG["seq"]):
        t, bounds, sdpa_fwd = timing[seq]
        for name in ("flash_fwd", "flash_dq", "flash_dkv"):
            kernels.append({
                "name": f"{name}_s{seq}", "head_dim": 64, "seq": seq, "route": "cuda",
                "kernel": KERNEL_OF[(name, 64)], "source": SOURCE, "replaces": REPLACES[name],
                "launches": long_rows[seq]["launches"][name],
                "max_abs_err": errs[(name, seq)], "ms": t[name]["ms"],
                "ms_graph": t[name]["ms_graph"], "ms_cold": t[name]["ms_cold"],
                "plain_ms": t[name]["plain_ms"], "bound_ms": bounds[name][0],
                "bound_by": bounds[name][1],
                "library_ms": sdpa_fwd[0] if name == "flash_fwd" else None,
                "library_ms_graph": sdpa_fwd[1] if name == "flash_fwd" else None,
            })
    # phase 23's shapes: head dim 128 in float32 (K1 register-blocked, K2
    # and K3 the FMA kernels; launched
    # by phase 23 (b) at S 1024) and bf16 at S 16 (wgmma; phase 23 (a)),
    # bf16 at 256 (phase 23 (c) at S 2048); float32 at 256 and 96 padded to
    # 128: no path runs them (launches 0)
    for label, (shape, dtype) in SHAPES_TIMED.items():
        t, bounds, sdpa_fwd = shape_timing[label]
        d = shape[3]
        tag = "f32" if dtype == torch.float32 else "bf16"
        dp = fa.padded_head_dim(d)
        for name in ("flash_fwd", "flash_dq", "flash_dkv"):
            kernels.append({
                "name": f"{name}_{label}", "head_dim": d, "kernel_head_dim": dp,
                "dtype": "float32" if tag == "f32" else "bfloat16", "seq": shape[1],
                "route": "cuda",
                "kernel": KERNEL_OF.get((name, dp, tag)) or KERNEL_OF[(name, dp)],
                "source": SOURCE, "replaces": REPLACES[name],
                "launches": shape_launches.get(label, {}).get(name, 0),
                "max_abs_err": shape_errs[label][name], "ms": t[name]["ms"],
                "ms_graph": t[name]["ms_graph"], "ms_cold": t[name]["ms_cold"],
                "plain_ms": t[name]["plain_ms"], "bound_ms": bounds[name][0],
                "bound_by": bounds[name][1],
                "library_ms": sdpa_fwd[0] if name == "flash_fwd" else None,
                "library_ms_graph": sdpa_fwd[1] if name == "flash_fwd" else None,
            })
    log(json.dumps({"kernels": kernels}))
    log(f"chip_smoke.py: {time.perf_counter() - started:.1f} s")
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
