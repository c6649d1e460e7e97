#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                    # every phase, from a checkout
    python3 chip_smoke.py --only paper       # the build, then only these
                                             # phases and those they need

Phases, each of which fails the run (nonzero exit, no result line). With
``--only`` (names: kernel, serve, decode, cross, kvstate, simkernel,
simulate, stream, sweep, paper, faults, obs, analysis, train, mesh) it
runs the build
and the named phases with the phases they need (decode needs serve; stream and paper need
simulate; sweep needs simulate and stream), and prints no kernel table and
no result line; with no flag it runs every phase:

1. card and build: the card's name and power limit, torch and CUDA
   versions; every ``csrc/*.cu`` built with nvcc, one process each, all at
   once, with its registers and spills as ptxas reports them (for
   ``coded_kv_decode.cu`` one line per split-kernel instantiation);
2. kernel: ``gather_pool_cuda`` against ``gather_pool_plain`` on the card,
   bit for bit, at the serving shape (NB=8, S=64, P=64, Hkv=2, D=128, B=8,
   MP=32; bf16 lanes coded and uncoded, f32 lanes coded; -1 holes, ~40%
   degraded), with its time per launch (CUDA events), its byte bound, the
   plain version's time and ``torch.index_select`` as the library yardstick;
3. serve: full-width qwen2.5-3b (36 layers, bf16, random params from a
   seeded generator on the card) serving 8 requests through the coded KV
   pool four times (coded with fused encode, uncoded, coded with
   recode_budget=2, coded with the serve planes on). Every request must
   finish, the runs must serve identical tokens, and the kernel's launch
   count must rise by exactly decode steps x 36 in each run. Every run
   churns placement once (the same seeded ``permute_pool``) before its
   requests, so pages spread unevenly over the banks and the coded runs
   serve degraded reads, which are counted. After each run the K/V banks
   must equal the first run's bit for bit, and on a coded pool every parity
   row marked fresh must be the XOR of its two banks; ``gather_pool_cuda``
   must equal ``gather_pool_plain`` bit for bit on the run's last layer
   through decode step 12's page table, with that step's plan and (coded)
   a seeded plan with ~40% degraded pages. The planes must agree
   with the run's own counts (degraded reads, pages needed, steps; coded
   port cycles <= uncoded); a snapshot taken mid-stream and restored into
   a fresh card server must finish with the same tokens, pool and planes.
   A torch.profiler window over four full-batch decode steps, with the
   planes off and on, reports the device's busy and idle share, launches,
   host syncs and copies per step and the heaviest host ops. Then
   qwen2.5-3b with kv_banks=0 serves the same requests from the ring
   cache, with the pool runs' tokens. yi-6b (untied head), stablelm-12b
   (coded embedding, untied head, head_dim 160) and granite-20b
   (LayerNorm, GELU MLP, MQA: 48 heads on one kv head) are then served
   the same way at full width (yi at 8 of its 32 layers, stablelm at 10
   of its 40, granite at 13 of its 52), bf16, params drawn on the card
   one layer at a time, on 8 requests (one wave of the 8 slots): coded and uncoded
   pool (same checks: identical tokens,
   banks, fresh parity, the gather against its plain version at the
   config's pool shape, degraded reads, launches = steps x layers, finite
   prefill logits), a profiled window, then the ring cache. olmoe-1b-7b
   (MoE: 4 of its 16 layers, 64 experts top-8, d_model 2048) is served
   the same way on 8 requests, with each run's share of MoE assignments dropped in
   a decode step's group of 8 tokens and in a prefill's group of 128;
   then phi-3-vision-4.2b (the vision prefix) from the ring cache, 8
   requests at max_prompt 640 (576 zero patch positions), all finished,
   finite prefill logits, random patches moving them, a profiled window;
   then the recurrent families from the ring cache, which holds each
   slot's conv tails and f32 states: mamba2-2.7b (16 of its 64 SSD
   mixers, d_model 2560) on 8 requests of 64-512 random tokens at max_prompt 512 (four
   SSD chunks of 128), and recurrentgemma-9b (9 of its 38 layers of (rec,
   rec, local attention), d_model 4096, window 2048, vocab 256k) on 8 requests
   of 1,024-2,048 tokens at max_prompt 2048, so decode starts at position
   2048 and writes through the wrapped ring; each with 32 new tokens,
   every request finished, finite prefill logits and states, ms/step,
   tok/s, TTFT, the weight floor (param bytes / 3.35 TB/s, the drawn
   param count within 5% of the config's ``n_params``) and a profiled
   window; then whisper-tiny (the audio encoder-decoder: 4 + 4 layers,
   d_model 384, learned decoder positions, QKV bias) from the ring cache
   on 8 requests at max_prompt 128, 32 new tokens, each admission
   encoding the server's zero frames (1, 1,500, 384) and installing the
   slot's cross-attention K/V: every request finished, finite prefill
   logits, seeded random frames moving them, ms/step, tok/s, TTFT, the
   cross K/V's size and a profiled window. Every run's peak allocated
   memory must stay within 50 GB;
4. decode attention: ``coded_kv_decode`` through ``ops.coded_kv_decode``
   (after ``ops.pack_kv_banks``) at each served family's attention width
   (K/V of qwen's ring run's layers 0 and 35 and layer 0 of each other
   config's ring: the dense three, olmoe-1b-7b, phi-3-vision-4.2b (D =
   96), recurrentgemma-9b's local attention (D = 256, one kv head; also
   in f32 lanes) and whisper-tiny's decoder self-attention: B=8, T=2048,
   the config's H/Hkv/D; seq_len mixed with 0, a partial page and 2048),
   at one width that is no whole number of 16-byte vectors (D = 100,
   bf16, seeded), at bench_kernels' shape (f32), at one of at least
   256 MB and at D = 100 with at least 256 MB (the general kernel, B=16,
   T=20480), ~40% of pages degraded; held against ``coded_kv_decode_plain``
   and, where the K/V came from a ring, against ``mha`` over the ring
   cache itself, in f32 within 1e-5 with TF32 off (a 16-bit output must
   be the kernel's f32 result rounded, bit for bit); timed with the L2
   flushed, beside its bound from the actual plan and lengths, the plain
   version's time and SDPA (``enable_gqa``) over the logical cache. Each
   shape also prints its split kernel (the tensor-core one for 16-bit
   lanes at its eight widths, the scalar one for f32 lanes at its widths,
   the general one for every other width) with its registers, spills and
   shared memory from the build log, its HMMA count from ``cuobjdump
   -sass`` (a tensor-core kernel with none fails the phase; the general
   kernel is the only 16-bit path without), its blocks per SM and the
   split count it ran with. A split kernel a case reaches that spills
   fails the phase, and so does a call whose kernels are not the split
   kernel and the merge kernel (a torch.profiler trace of one call each:
   two launch calls, and the kernel records, if the trace kept them,
   those kernels');
5. cross-device: each of the four configs reduced, at f32 (TF32 off) on
   bench_serve's schedule (4 slots, page 4, 16 requests x 16 tokens, a
   placement churn every 2 steps), serves identical tokens on the card
   and on the CPU, the
   logits agree to rtol = atol = 1e-4, and every serve plane is equal; the
   port cycles, degraded reads and critical-word p50/p99 (``read_latencies``
   under the coded plan and an all-direct one) are printed; a card
   snapshot restored on the CPU finishes with the card's tokens and planes;
   olmoe-1b-7b reduced the same way (coded pool), reporting the smallest
   router margin (k-th to (k+1)-th logit) the runs saw; one full-width
   olmoe layer's MoE block at f32 on the 8-token decode group and a
   128-token prefill group, the card's router logits copied to the CPU:
   experts and keep mask identical, outputs within 1e-4 of their largest
   magnitude; one full-width layer of each recurrent mixer at f32
   (mamba2's ``ssm_block``, recurrentgemma's ``rglru_block``) over a
   512-token prompt and 4 decode steps from its cache: outputs and final
   states within 1e-4 of their largest magnitude; mixtral-8x7b (window
   16), phi-3-vision-4.2b (seeded random patches), mamba2-2.7b and
   recurrentgemma-9b (local window 16) and whisper-tiny (seeded random
   frames) reduced from the ring cache: identical tokens, the prefill
   and first decode step's logits within 1e-4; then whisper-tiny the
   same way at full width (1,500 frames a prompt);
6. BankedKVState: the per-sequence state API at bench_kvbank's five cases
   on the card and on the CPU: plans, ``gather_kv`` (``gather_pool_cuda``
   on the card) and every leaf equal, before and after appends and
   budgeted recodes;
7. simulator kernels: ``xor_gather`` through the entry the main path
   calls, ``gather_plan_cuda`` (fed the controller's plan), and the column
   entry ``gather_decode_cuda``, at four shapes (the simulator's, its 13
   points lock-step, ``bench_kernels``' direct reads, one of 163 MB);
   ``xor_encode`` through the path's ``encode_regions_cuda`` (one region
   a point written into a copy of the parity state) at the simulator's
   shape and 13 points, and through ``encode_parities_cuda`` at
   ``bench_kernels``' shape and two of 671 MB (pairwise and scheme_i
   members); each against its plain version on the card, bit for bit,
   with its time per launch, byte bound, plain time and, where one
   PyTorch call computes the same function, that call's time; and the
   eager plan bridge (``gather_plan_columns``) the fold removed, timed on
   the card and on the host clock beside the fused call;
8. simulate: the coded-memory simulator at the paper figures' geometry (8
   banks x 320 rows, queue depth 10, 8 cores x 96 requests of a seeded
   banded trace, r = 0.05, select period 32) for uncoded, scheme_i,
   scheme_iii at alpha 1 and scheme_i, scheme_ii at alpha 0.25, on the card
   and on the CPU. Every SimResult field and final state leaf must agree;
   every read the scheme_i alpha 0.25 run serves must return the value
   committed before its cycle; scheme_i at alpha 1 must take fewer cycles
   than uncoded; each kernel's launches must equal its wrapper's calls on
   the card (one region encode per switch, at least one per alpha < 1
   run). Outside the timed runs, each card run's final state (every
   field) and SimResult must equal the golden model's
   (``repro_torch.oracle`` through ``repro_torch.sim.golden``) over the
   same cycles, and scheme_i alpha 0.25 is stepped on the card cycle by
   cycle beside the oracle until the oracle is quiescent, every
   ``CycleOut`` equal to ``OracleMemorySystem.cycle``'s. It reports ms
   per simulated cycle, cycles/s, and a profiled window's kernel launches
   per cycle and device idle share;
9. stream: streamed trace replay (``repro_torch.traces.stream_replay``,
   which leaves each chunk's loop at quiescence) on the card and the CPU.
   (a) bench_stream's workload (8 cores x 2,048 banded requests, 8 banks x
   512 rows, scheme_i, alpha 0.25, r 0.05, select period 256) on its first
   1,024 requests a core, at chunk 256: every SimResult field (window series included) and final state
   leaf equal, every served read returns the committed value, each
   kernel's launches equal its wrapper's calls; every SimResult field
   but the windows equal the golden model's run over the same requests to
   quiescence; cycles run against
   ``drain_bound``, ms/cycle, requests/s; then a busy and a drained
   profile window (launches, host syncs and copies per cycle, device idle
   share). (b) the simulate phase's scheme_i alpha 0.25 trace streamed at
   chunks 32 and 96 equals its single-shot result. (c) the
   ``tests/data`` Ramulator and gem5 fixtures through ``load_trace`` and
   ``stream_file`` replay alike on the card and the CPU. (d) region
   priors from (a)'s trace profile: the primed init state and the primed
   streamed replay of the trace's first 512 requests a core equal card vs
   CPU, beside that head replayed cold;
10. sweep: the simulator's point axis (``repro_torch.sweep.run_points``,
   B points lock-step, one ``xor_gather`` and at most one ``xor_encode``
   launch a batched cycle) on the card and the CPU. (a) paper_fig19's
   grid through the Fig 19 harness (``repro_torch.harness.fig19_split.
   run``, its table printed; card rows = CPU rows) at the figures' geometry (split-band trace of 8 bands, 8 x 320,
   8 cores x 96, seed 0, select period 64; uncoded and scheme_i over r
   {0.05, 0.125, 0.25} x alpha {0.1, 0.25, 0.5, 1}): 13 points in 3
   batches, each leaving its loop when every point is quiescent; every
   SimResult field and final state leaf equal card vs CPU, each point
   equal to looped ``simulate`` on the CPU, every read the scheme_i alpha
   0.25 r 0.05 point serves returns its committed value; cycles run per
   batch, ms per batched cycle, point-cycles/s beside the simulate
   phase's looped cycles/s. (b) the simulate phase's golden run at seeds
   0..7, one batch; seed 0 equals the simulate phase's card result. (c)
   ``stream_replay_points`` at bench_stream's geometry on the trace's first
   512 requests a core, at chunk 64, for alpha 0.1, 0.25, 0.5 (one batch)
   and 1 (alone), card = CPU windows included, alpha 0.25 = the stream
   phase's cold replay of that head apart from windows, and a pass killed
   at ``max_cycles`` after a checkpoint every 2 chunks resumes to the
   uninterrupted results. (d) both kernels bit for bit against their
   plain versions on live batched card states of every batch of (a), (b)
   and (c) (every 50th batched cycle of (a) and (b), every 100th of (c)),
   with the real plans and seeded columns of every mode. (e) the point
   axis sharded: ``launch.mesh.make_sweep_mesh`` replaced to lay 2 shards
   on the one card (cuda:0 twice, so each odd batch carries a padding
   row), paper_fig19's grid with telemetry on through ``run_points(pts,
   None, True)``: results equal (a)'s unsharded card run and the CPU's
   unsharded telemetry-on run, every snapshot plane equal the CPU's; its
   alpha 1 batch (3 points) on its traces' first 48 requests a core
   through ``stream_replay_points`` at chunk 16 over the 2 shards equals
   the CPU's unsharded replay windows included,
   and a pass killed at 2 shards after a checkpoint a chunk resumes at 1
   shard to the same results (this proves the padding, the split and the
   exit test on the card, not a speedup across cards). Then
   profiled windows of seed-axis batches of 1 and 8 points and of
   (a)'s traced batch: ms and launches per batched cycle, host syncs,
   copies and the device idle share. The phase's CPU side (the CPU runs
   of (a)-(c) and, in a lane of their own, (a)'s looped runs), the paper
   phase's and the faults phase's are computed by four worker processes
   side by side that the script starts first and kills on every way out.
   They
   run only while no time is taken:
   through the build and the cross-device and kvstate phases, after (a)'s
   card run, through (c)'s kill-and-resume pass and (d), after the paper
   phase's card runs (through its live checks) and through the faults
   phase's (c); they are stopped (SIGSTOP) through every phase that
   reports a time;
11. paper: the paper's Fig 18 through the port's harness
   (``repro_torch.harness.fig18_dedup.run``: ``paper_fig18`` ->
   ``run_sweep`` -> ``run_points``) at the figures' geometry (8 banks x
   320 rows, 8 cores x 96 banded requests, write fraction 0.3, r 0.05,
   select period 32; uncoded and schemes I-III over alpha {0.05, 0.1,
   0.25, 0.5, 1}: 16 points in 7 batches), printing its table, each
   batch's batched cycles against ``drain_bound`` and the grid's wall
   time; then the quickstart (``compare_schemes`` over a banded 8 x 64
   trace, 256 rows, alpha 1, r 0.25, 512 cycles, four schemes). The card's
   Fig 18 rows must equal the CPU's (run by the worker) in every field,
   and the quickstart's results too; each of the simulate phase's five
   points must equal its batched result (batched = looped on the card);
   every alpha 1 row must have 0 switches; every read scheme_i alpha 0.25
   serves must return its committed value; each kernel's launches must
   equal its wrapper's calls; and both sim kernels must equal their plain
   versions bit for bit on live card states of every Fig 18 batch
   (schemes II and III included), as in the sweep phase's (d); each of
   the 16 points' final card state and result must equal its golden twin
   at the batch's padded allocation over the batch's cycles. Then the
   Fig 20 harness at its defaults (3 drifts x uncoded + scheme_i alpha
   0.1, 0.25; 8 x 320, 8 cores x 96) and the §III-B scheme table
   (``tab_schemes``: six schemes on a uniform trace, the best case through
   the read builder), card rows = CPU rows;
12. faults: bank faults through the batched core on the card and the CPU.
   (a) the availability gate (``repro_torch.harness.fig_faults.run`` at
   its defaults: banded, split-band and ramp traces at 128 rows x 96
   requests a core, alpha 1, r 0.25, one dead bank per parity group, for
   scheme_i, scheme_iii and uncoded): card rows = CPU rows, coded rows
   serve 100% of reads, uncoded rows do not; (b) one batch of mixed plans
   (a bank failing at 20 and rebuilding from 120, no plan, a dead bank
   beside a stuttering parity port) equal to the CPU in every field and
   leaf (the fault leaf included), bank 0 rebuilt, every point quiescent;
   every point of (a) and (b) equal to its golden twin with its fault
   plan, state (the fault leaf included) and result; (c) outside the
   counts, scheme III's batch of (a) rerun with every
   ``xor_gather`` launch held against its plain version on its own
   operands; it must serve reads degraded because their bank is down;
13. obs: the simulator's telemetry planes (``repro_torch.obs``) on the
   card and the CPU. (a) the stall report's ``--smoke`` suite (paper_fig18
   on 8 cores x 32 banded requests, 64 rows: uncoded, scheme_i alpha 0.25)
   through ``run_points`` with telemetry off and on: results and every
   other state leaf equal, the card's planes equal the CPU's at every
   point; (b) ``stall_report("paper_fig18")`` at its defaults (8 cores x
   96 requests, 128 rows, 16 points in 4 batches), whose own check refuses
   planes that disagree with the aggregates, printing the grid's wall
   time and the coded exemplar's critical-word read and write latency
   histograms against uncoded's; (c) ``availability_report`` (bank 0 dead
   from cycle 0) at ``--smoke`` and at full coverage (alpha 1, r 0.125),
   results and planes card = CPU, dead-bank cycles counted and reads
   served degraded because their bank is down (read class 4); (d) the
   timeline at its CLI defaults, events card = CPU. Every point of (a)
   and (b) equals its golden twin, state, ``OracleTelemetry`` planes and
   result. Outside the counts:
   (e) a busy B = 1 batched cycle profiled with telemetry off (1,027-1,050
   launches over cycles 40..60, as ``OBS_OFF_LAUNCHES`` records them) and
   on, and
   timed off, on, on, off; (f) both sim kernels bit for bit against
   their plain versions on live telemetry-on states of (b)'s scheme_i
   batch. Counted for ``gather_pool``: (g) ``serve_report`` at its CLI
   defaults (reduced qwen2.5-3b on the coded pool, 10 requests), whose
   gates hold the code-status table against the oracle's replay after
   every step and the planes against its totals; its planes equal the
   CPU's. Its CPU side runs after the paper phase's in that worker.
14. analysis: ``python -m repro_torch.analysis --strict`` with the carry
   layer on the card: the GF(2) certificates, the repo rules, and the
   carry lint's live cycle, run_chunk_batch and pooled decode step, where
   a leaf that drifts to another device is a finding.
15. train: the training path (``runtime.trainer.Trainer`` ->
   ``make_train_step`` -> ``lm.loss_fn`` with the coded embedding's
   backward and per-layer recompute -> the in-place ``adamw_update``) on
   the card. (a) full-width qwen2.5-3b (3.09 B params, f32 master params
   and moments, bf16 compute, coded embedding, remat "full"), global
   batch 8 x 256 tokens, 8 steps, no checkpoint, a fresh temporary
   checkpoint directory: ms/step (step 0 excluded), tokens/s, peak
   allocated (<= 76 GB), every step's loss and grad norm (all finite, the
   mean of the last three below step 0's), then one more step under
   torch.profiler (launches, device busy ms, idle share); (b) each dense
   config reduced at f32 compute (TF32 off), 3 steps on the card and on
   the CPU from one init drawn on the CPU: loss and grad norm to 1e-5
   relative, every param leaf within 1e-4; qwen also at bf16 compute
   (loss within 5e-3, grad norm 5e-2 relative, params within 2 x the
   summed learning rates); (c) with deterministic algorithms (and
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, set before torch starts), reduced
   qwen for 6 steps with a checkpoint every 2 and a fault injected at
   step 3 restores step 2, replays, and ends with the params and
   ``OptState`` of an uninterrupted run bit for bit; (d) ``n_micro=2``
   equals ``n_micro=1`` on the card (reduced granite, f32); (b) also
   holds the six non-dense configs reduced card = CPU at f32 (olmoe,
   mixtral, phi with seeded patches, mamba2, recurrentgemma, whisper
   with seeded frames; whisper's k biases, whose gradient softmax
   cancels, within the summed learning rates); (e) each non-dense family
   at its published widths, f32 master params, bf16 compute, batch 8 x
   256, 8 steps: whisper-tiny (full depth, seeded frames (8, 1,500, 384),
   through ``make_train_step``), mamba2-2.7b and phi-3-vision-4.2b (full
   depth, tokens only, through the ``Trainer``), olmoe-1b-7b (4 of 16
   layers) and recurrentgemma-9b (one superblock, 3 of 38 layers)
   through the ``Trainer``: ms/step, tokens/s, peak allocated (<= 76 GB),
   every loss finite and the mean of the last three below step 0's.
16. mesh: sharding (``launch.mesh`` -> ``launch.sharding`` -> the pinned
   ``lm``/``moe`` on DTensors -> the DTensor AdamW). (a) a one-rank NCCL
   process group (127.0.0.1, a free port) and a (1, 1) ("data",
   "model") ``DeviceMesh`` on the card: full-width qwen2.5-3b (4 of its
   36 layers) through the DTensor ``Trainer`` (f32 master, bf16 compute,
   remat "full", 8 x 256, 4 steps, seed 0) against the plain ``Trainer``
   from the same seed: each step's loss within 1e-5, every param leaf
   within 1e-4 (leaf by leaf through the host; bitwise equality
   printed); a mesh run's step-2 checkpoint finished by the plain
   ``Trainer`` within the same gate;
   ms/step of both paths, peak allocated GB, redistributions a step.
   (b) three of JAX's dry-run cells, each ``launch/dryrun.py`` in a
   process of its own on a fake process group, started with the phase
   and run beside (a) off the card: qwen2.5-3b ``train_4k`` and
   granite-20b ``decode_32k`` on ``pod16x16``, olmoe-1b-7b ``train_4k``
   on ``pod2x16x16`` with ``--moe-ep``; each must report status ok and
   per-device argument bytes equal to a count from ``param_spec`` (and
   ``cache_shardings``, ``batch_spec``); every roofline term printed.

Each kernel's launches are counted from 0 over its own main path (the
serve runs and the obs phase's serving report for ``gather_pool``, the decode-attention calls for
``coded_kv_decode``, the simulate runs and the stream, sweep (its (e)
included), paper and faults and obs phases for the simulator's kernels,
whose table entries add the six; a line before the table gives the
split). Every phase after the build runs under
``repro_torch.analysis.guard.recompile_guard(max_compiles=0)`` over all
its targets: a phase that builds a kernel (runs ``nvcc``) fails the run.
Before the table, one line a phase gives the points and cycles it held
against the golden model and the host seconds that took.
The third-to-last line is the card's name and power limit, the
second-to-last the kernel table as JSON, the last
``{"ok": true, "device": {...}}``. Without a CUDA card, or without the rest
of the repository beside this file, it exits nonzero.
"""
from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import io
import itertools
import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
KERNEL_SHAPE = dict(nb=8, slots=64, page=64, hkv=2, d=128, b=8, mp=32)
SERVE = dict(n_slots=8, max_prompt=128, max_seq=2048, max_new_tokens=32,
             page=64)
# one wave of the 8 slots for every config: yi, stablelm, granite since
# cut (5), qwen2.5-3b since cut (6)
N_REQUESTS = 8
CHURN_SEED = 5                   # the placement permutation of every run
# the other dense configs, served at full width on the coded and the
# uncoded pool and on the ring cache; the two largest at a quarter of
# their depth (cut (7), PERF.md section 4: their pools' host copies and
# per-layer steps kept the script past 950 s on a slow host); yi-6b,
# olmoe-1b-7b and the recurrent two at a quarter since cut (9), which
# paid for the mesh phase (the script at 1,129.8 s on a slow host)
DENSE_ARCHS = ("yi-6b", "stablelm-12b", "granite-20b")
SERVE_DEPTH = {"stablelm-12b": 10, "granite-20b": 13, "yi-6b": 8,
               "olmoe-1b-7b": 4, "mamba2-2.7b": 16, "recurrentgemma-9b": 9}
# the MoE config served at full width on the pool and the ring; the
# vision-prefix one on the ring (prompts padded past its 576 patches);
# mixtral-8x7b (93 GB of bf16 params) runs reduced only
MOE_ARCH = "olmoe-1b-7b"
VLM_ARCH = "phi-3-vision-4.2b"
VLM_SERVE = dict(SERVE, max_prompt=640)
# the recurrent families at full width from the ring with their O(1)
# state: (serve config, prompt lengths). mamba2's prefill runs four SSD
# chunks of 128; recurrentgemma's prompt fills its local window, so decode
# starts at position 2048 and every step writes through the wrapped ring
RECURRENT_SERVE = {
    "mamba2-2.7b": (dict(SERVE, max_prompt=512, max_seq=544), (64, 512)),
    "recurrentgemma-9b": (dict(SERVE, max_prompt=2048, max_seq=2080),
                          (1024, 2048)),
}
PARAMS_TOL = 0.05                # tree's params vs the analytic n_params
# the audio encoder-decoder, as published, on the ring: each admission
# encodes the server's zero frames (1, 1500, 384); its full width also
# runs card = CPU at f32 in the cross phase (bench_serve's slots)
AUDIO_ARCH = "whisper-tiny"
RING_ARCHS = ("mixtral-8x7b", VLM_ARCH) + tuple(RECURRENT_SERVE) \
    + (AUDIO_ARCH,)
# one full-width layer of each recurrent mixer, card vs CPU at f32: a
# (1, 512) prompt (four SSD chunks), then decode steps from its cache
MIXER_LAYER = dict(t=512, decode_steps=4)
MOE_LAYER_GROUPS = (("decode", (8, 1)), ("prefill", (1, 128)))
PEAK_LIMIT_GB = 50.0             # peak allocated of a served config
LOGITS_TOL = 1e-4                # card vs CPU at f32: summation order
# the simulator at the geometry of benchmarks/fig18_dedup.py (select period
# 32; fig19/fig20 use 64): 8 banks x 320 rows, 8 cores x 96 requests
SIM_TRACE = dict(n_cores=8, length=96, n_banks=8, n_rows=320, seed=0,
                 write_frac=0.3)
SIM_KW = dict(r=0.05, select_period=32)
SIM_RUNS = (("uncoded", 1.0), ("scheme_i", 1.0), ("scheme_i", 0.25),
            ("scheme_ii", 0.25), ("scheme_iii", 1.0))
GOLDEN_RUN = ("scheme_i", 0.25)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    """The card's ``name, power.limit`` as ``nvidia-smi`` gives them."""
    from repro_torch.obs.runlog import card_lines

    lines = card_lines()
    check(bool(lines), "nvidia-smi reported no card")
    return lines[0]


def time_on_card(torch, fn, n: int) -> float:
    """Mean ms per call of ``fn`` on the card: CUDA events around ``n``
    calls queued behind a sleep kernel, so host launch overhead does not
    open gaps between them."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)          # ~0.1 s of device clock cycles
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


# ---------------------------------------------------------------- phase 2
def kernel_phase(torch):
    from repro_torch.kernels.coded_kv_decode import kernel as ckd_kernel
    from repro_torch.kernels.coded_kv_decode.ref import gather_pool_plain

    s = KERNEL_SHAPE
    nb, slots, b, mp = s["nb"], s["slots"], s["b"], s["mp"]
    gen = torch.Generator(device="cuda").manual_seed(1234)
    dev = "cuda"
    # a real pool maps each logical page to its own physical page
    pt = torch.randperm(nb * slots, generator=gen, device=dev)[: b * mp]
    pt = pt.view(b, mp).to(torch.int32)
    pt[torch.rand(b, mp, generator=gen, device=dev) < 0.15] = -1
    up = torch.rand(b, mp, generator=gen, device=dev) < 0.4
    results = {}
    for name, lanes, coded in (("bf16_coded", torch.int16, True),
                               ("bf16_uncoded", torch.int16, False),
                               ("f32_coded", torch.int32, True)):
        info = torch.iinfo(lanes)
        shape = (nb, slots, s["page"], s["hkv"], s["d"])
        pshape = (nb // 2 if coded else 0,) + shape[1:]

        def bits(sh):
            return torch.randint(info.min, info.max, sh, generator=gen,
                                 device=dev, dtype=lanes)

        # four input sets (> the 50 MB L2) so timed launches read from HBM
        sets = [(bits(shape), bits(shape), bits(pshape), bits(pshape), pt, up)
                for _ in range(4)]
        ko, vo = ckd_kernel.gather_pool_cuda(*sets[0])
        torch.cuda.synchronize()
        kr, vr = gather_pool_plain(*sets[0])
        check(torch.equal(ko, kr) and torch.equal(vo, vr),
              f"gather_pool {name}: kernel differs from the plain version")
        err = max(int((ko.long() - kr.long()).abs().max()),
                  int((vo.long() - vr.long()).abs().max()))

        turn = itertools.count()

        def run_kernel():
            ckd_kernel.gather_pool_cuda(*sets[next(turn) % 4])

        def run_plain():
            gather_pool_plain(*sets[next(turn) % 4])

        ms = time_on_card(torch, run_kernel, 200)
        plain_ms = time_on_card(torch, run_plain, 20)

        # bound: every needed input page read once, every output written
        page_bytes = shape[2] * shape[3] * shape[4] * info.bits // 8
        live = pt >= 0
        phys = pt.long().clamp(min=0)
        deg = live & up if coded else torch.zeros_like(live)
        bank_src = torch.where(deg, (phys % nb) ^ 1, phys % nb) * slots \
            + phys // nb
        n_bank = int(torch.unique(bank_src[live]).numel())
        n_par = int(torch.unique(((phys % nb) // 2 * slots
                                  + phys // nb)[deg]).numel())
        n_bytes = 2 * page_bytes * (n_bank + n_par + b * mp) \
            + pt.numel() * 4 + (up.numel() if coded else 0)
        bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3

        # library yardstick: one index_select of the uncoded, hole-free
        # gather of the same pages (K and V in one call)
        kv = torch.stack(sets[0][:2]).view(2, nb * slots, -1)
        flat = (phys % nb) * slots + phys // nb

        def run_library():
            torch.index_select(kv, 1, flat.view(-1))

        lib_ms = time_on_card(torch, run_library, 200)
        results[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             library_ms=lib_ms, max_abs_err=err,
                             bytes=n_bytes,
                             degraded=int(deg.sum()), holes=int((~live).sum()))
        print(f"kernel gather_pool {name}: bit-exact vs plain; "
              f"{ms * 1e3:.2f} us/launch, bound {bound_ms * 1e3:.2f} us "
              f"({n_bytes / 1e6:.2f} MB at 3.35 TB/s, "
              f"{bound_ms / ms:.0%} of it), plain {plain_ms:.3f} ms, "
              f"index_select {lib_ms * 1e3:.2f} us; "
              f"{int(deg.sum())} degraded, {int((~live).sum())} holes "
              f"of {b * mp} pages")
    return results


# ---------------------------------------------------------------- phase 3
def profile_decode(torch, srv, Request, n_steps: int = 4) -> None:
    """Where a full-batch decode step's time goes: host wall per step,
    device busy time (kernels, copies, sets from a torch.profiler trace)
    and its idle share, kernel launches, host syncs and copies per step,
    the heaviest kernels by device time and the heaviest host ops by
    their own host time."""
    from torch.profiler import ProfilerActivity, profile

    for r in _requests(Request, srv.cfg.vocab, seed=11, n=srv.sc.n_slots):
        srv.submit(r)
    srv._admit()
    srv.step_decode()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            srv.step_decode()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    path = ROOT / "build" / (f"chip_smoke_decode_{srv.cfg.name}_"
                             f"{srv.sc.telemetry}.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    busy = [e for e in events if e.get("ph") == "X" and e.get("cat") in
            ("kernel", "gpu_memcpy", "gpu_memset")]
    if not busy:
        print("profile: the trace holds no device activity; device busy "
              "share not measured")
        return
    by_name = {}
    for e in busy:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    busy_ms = sum(by_name.values()) / 1e3 / n_steps
    n_kernels = sum(e["cat"] == "kernel" for e in busy) / n_steps
    gather = sum(v for k, v in by_name.items() if "gather_pool" in k) \
        / 1e3 / n_steps
    runtime = [e["name"] for e in events if e.get("cat") == "cuda_runtime"]
    syncs = sum("Synchronize" in n for n in runtime) / n_steps
    copies = sum("Memcpy" in n for n in runtime) / n_steps
    planes = "on" if srv.sc.telemetry else "off"
    print(f"profile {srv.cfg.name} {srv.sc.n_slots}-slot decode step "
          f"({n_steps} steps, "
          f"planes {planes}): wall {wall_ms:.2f} ms/step, device busy "
          f"{busy_ms:.2f} ms/step (idle {1 - busy_ms / wall_ms:.1%}), "
          f"{n_kernels:.0f} kernel launches/step, {syncs:.1f} host syncs "
          f"and {copies:.1f} copies/step, gather_pool {gather:.3f} ms/step "
          f"({gather / busy_ms:.1%} of busy)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {us / 1e3 / n_steps:7.3f} ms/step  {name[:90]}")
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    for a in host[:6]:
        print(f"    host {a.self_cpu_time_total / 1e3 / n_steps:7.3f} ms/step "
              f"{a.key[:60]} x {a.count / n_steps:.0f}")


def _requests(Request, vocab: int, seed: int, n: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(5, 101, size=n)
    return [Request(rid=i, prompt=[int(t) for t in
                                   rng.integers(1, vocab, size=int(k))])
            for i, k in enumerate(lens)]


@contextlib.contextmanager
def counting_reads():
    """Collect, per decode step, the read planner's degraded pages and the
    pages the step needs (ceil(length / page) per sequence with a page
    table row); device sums, no host sync. Every layer reads through the
    one plan."""
    from repro_torch.runtime import kvbank
    plan_fn = kvbank.pool_plan
    sums = {"degraded": [], "needed": []}

    def counted(cfg, pool, length=None):
        plan = plan_fn(cfg, pool, length=length)
        length = pool.length if length is None else length
        sums["degraded"].append(plan.use_parity.sum())
        sums["needed"].append((((length + cfg.page - 1) // cfg.page)
                               * (pool.page_table[:, 0] >= 0)).sum())
        return plan

    kvbank.pool_plan = counted
    try:
        yield sums
    finally:
        kvbank.pool_plan = plan_fn


@contextlib.contextmanager
def watching_routes(torch, margins: bool = False):
    """Collect every MoE dispatch's routing while the block runs: by
    group size, the assignments kept (device sums, no host sync) and
    routed; with ``margins``, each dispatch's smallest gap between a
    token's k-th and (k+1)-th router logit (the nearest a top-k choice
    came to flipping)."""
    from repro_torch.models import moe
    route = moe.route
    seen = {"kept": {}, "routed": {}, "margin": []}

    def watched(cfg, logits, cap):
        r = route(cfg, logits, cap)
        g = logits.shape[1]
        seen["kept"].setdefault(g, []).append(r.keep.sum())
        seen["routed"][g] = seen["routed"].get(g, 0) + r.keep.numel()
        if margins:
            top = logits.topk(cfg.top_k + 1, dim=-1).values
            seen["margin"].append((top[..., -2] - top[..., -1]).min())
        return r

    moe.route = watched
    try:
        yield seen
    finally:
        moe.route = route


def drop_shares(torch, seen) -> dict:
    """Group size -> (share of its assignments dropped, assignments)."""
    return {g: (1 - float(torch.stack(seen["kept"][g]).sum()) / n, n)
            for g, n in sorted(seen["routed"].items())}


def min_margin(torch, seen):
    """The smallest margin ``watching_routes`` saw (None: no dispatch)."""
    if not seen["margin"]:
        return None
    return float(torch.stack([m.cpu() for m in seen["margin"]]).min())


def keep_logits(torch, lm, srv, store: list) -> None:
    """Route ``srv``'s prefill and decode steps (pool or ring) through
    versions that also keep the f32 logits of the occupied slots on the
    host (the server's own steps return tokens only)."""
    cfg, budget = srv.cfg, srv.sc.recode_budget
    kvcfg = srv.kvcfg if srv.pooled else None

    @torch.no_grad()
    def prefill(params, tokens, patches=None, frames=None):
        logits, cache = lm.prefill(cfg, params, tokens, patches=patches,
                                   frames=frames)
        store.append(logits.float().cpu())
        return torch.argmax(logits, -1), cache

    @torch.no_grad()
    def decode(params, token, cache):
        if kvcfg is None:
            logits, cache = lm.decode_step(cfg, params, token, cache)
        else:
            logits, pool, tele = lm.decode_step_pooled(
                cfg, kvcfg, params, token, cache["pool"], cache["tele"],
                recode_budget=budget)
            cache = {"pool": pool, "tele": tele}
        live = [i for i, s in enumerate(srv.slots) if s is not None]
        store.append(logits[live].float().cpu())
        return torch.argmax(logits, -1), cache

    srv.prefill, srv.decode = prefill, decode


def check_parity(pool, name: str) -> int:
    """Every parity row marked fresh must be the XOR of its two banks, in
    every layer, K and V. Returns the number of fresh rows."""
    fresh = pool.parity_fresh
    for banks, par in ((pool.k_banks, pool.k_par), (pool.v_banks, pool.v_par)):
        same = ((banks[:, 0::2] ^ banks[:, 1::2]) == par) \
            .flatten(3).all(-1).all(0)                  # (NG, slots)
        check(bool((same | ~fresh).all()),
              f"{name}: a parity row marked fresh is not bank ^ sibling")
    return int(fresh.sum())


def check_gather(torch, cfg, pool, table, plan, name) -> str:
    """``gather_pool_cuda`` against ``gather_pool_plain`` on the pool's
    last layer, bit for bit, through a page table and plan taken from a
    step of the run, and on a coded pool also with a seeded plan that
    sends 40% of the pages degraded. The launch count is left as it was:
    these launches are comparisons, not the main path's."""
    from repro_torch.kernels.coded_kv_decode import kernel as ckd_kernel
    from repro_torch.kernels.coded_kv_decode.ref import gather_pool_plain
    from repro_torch.runtime import kvbank

    layer = cfg.n_layers - 1
    plans = [plan]
    if kvbank.pool_coded(pool):
        gen = torch.Generator(device="cuda").manual_seed(99)
        plans.append(torch.rand(plan.shape, generator=gen, device="cuda")
                     < 0.4)
    n = ckd_kernel.launches
    for up in plans:
        args = (pool.k_banks[layer], pool.v_banks[layer], pool.k_par[layer],
                pool.v_par[layer], table, up)
        ko, vo = ckd_kernel.gather_pool_cuda(*args)
        kr, vr = gather_pool_plain(*args)
        check(torch.equal(ko, kr) and torch.equal(vo, vr),
              f"{cfg.name} {name}: gather_pool differs from the plain "
              f"version on layer {layer} of the pool")
    ckd_kernel.launches = n
    live = table >= 0
    n_deg = [int((up & live).sum()) for up in plans]
    return (f"gather_pool bit-exact vs plain on layer {layer} through "
            f"decode step {SNAP_STEP}'s table ({int(live.sum())} pages; "
            f"{n_deg[0]} degraded by its plan"
            + (f", {n_deg[1]} by a seeded one)" if len(n_deg) > 1 else ")"))


def _same_pool(torch, a, b) -> bool:
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


def _drive(srv, reqs, on_admit=None):
    """Serve ``reqs`` to the end: admit, then one decode step, until the
    queue and the slots are empty. Returns each decode step's host time
    (a step ends in a host read of the tokens). ``on_admit(step, srv)``
    runs after each admission, off the clock."""
    decode_s = []
    for r in reqs:
        srv.submit(r)
    while srv.queue or any(s is not None for s in srv.slots):
        srv._admit()
        if on_admit is not None:
            on_admit(len(decode_s), srv)
        t1 = time.perf_counter()
        srv.step_decode()
        decode_s.append(time.perf_counter() - t1)
    return decode_s


def _check_planes(name, delta, reads, steps, n_layers) -> None:
    """The planes of a run (``delta``: after minus before) against the
    run's own counts: degraded reads, pages needed, decode steps."""
    n_deg = int(sum(reads["degraded"]))
    n_need = int(sum(reads["needed"]))
    check(delta["degraded_reads"] == n_deg,
          f"{name}: planes count {delta['degraded_reads']} degraded reads, "
          f"the plans {n_deg}")
    check(delta["direct_reads"] + delta["degraded_reads"] == n_need,
          f"{name}: planes count {delta['direct_reads']} direct + "
          f"{delta['degraded_reads']} degraded reads for {n_need} pages "
          "needed")
    check(delta["decode_steps"] == steps,
          f"{name}: planes count {delta['decode_steps']} steps, ran {steps}")
    check(delta["coded_cycles"] <= delta["uncoded_cycles"],
          f"{name}: coded port cycles {delta['coded_cycles']} > uncoded "
          f"{delta['uncoded_cycles']}")


def _plane_delta(after, before):
    keys = ("degraded_reads", "direct_reads", "decode_steps", "coded_cycles",
            "uncoded_cycles")
    return {k: getattr(after, k) - getattr(before, k) for k in keys}


SERVE_RUNS = (("coded_fused", {}), ("uncoded", {"coded": False}),
              ("coded_budget2", {"recode_budget": 2}),
              ("coded_telemetry", {"telemetry": True}))
SNAP_STEP = 12                   # decode steps before the mid-stream snapshot


def serve_phase(torch, arch: str = "qwen2.5-3b", serve_runs=SERVE_RUNS,
                n_requests: int = N_REQUESTS):
    """Serve ``arch`` at full width through each pool run of
    ``serve_runs``, then from the ring cache, ``n_requests`` requests a
    run. Returns the pool gather's launches over the pool runs and the
    ring run's K/V of its first and last layers."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.coded_kv_decode import kernel as ckd_kernel
    from repro_torch.models import lm
    from repro_torch.runtime import kvbank
    from repro_torch.runtime.server import Request, ServeConfig, Server

    cfg = get_config(arch)
    depth = ""
    if arch in SERVE_DEPTH:
        depth = f" (depth cut from {cfg.n_layers})"
        cfg = dataclasses.replace(cfg, n_layers=SERVE_DEPTH[arch])
    torch.cuda.reset_peak_memory_stats()
    t_config = t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(a.numel() for a in _leaves(params))
    print(f"serve: {cfg.name} {cfg.n_layers} layers{depth} d_model "
          f"{cfg.d_model} "
          f"heads {cfg.n_heads}/{cfg.n_kv} x {cfg.head_dim} vocab "
          f"{cfg.vocab_pad}, {n_params / 1e9:.2f} B random "
          f"{cfg.compute_dtype} params (seed 0) made on the card in "
          f"{time.perf_counter() - t0:.1f} s, peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    runs = {}
    ref_banks = None
    total_launches = 0
    plan_fn = kvbank.pool_plan                  # not the counting one
    for name, kw in serve_runs:
        torch.cuda.reset_peak_memory_stats()
        srv = Server(cfg, ServeConfig(**SERVE, **kw), params, device="cuda")
        pool = srv.cache["pool"]
        pool_mb = sum(t.numel() * t.element_size() for t in
                      (pool.k_banks, pool.v_banks, pool.k_par,
                       pool.v_par)) / 1e6
        ckd_kernel.launches = 0                 # main path starts here
        warm = Request(rid=10_000, prompt=list(range(1, 17)))
        srv.submit(warm)
        srv.run_until_drained()
        warm_steps = srv.steps_run
        before = srv.serve_snapshot()
        srv.permute_pool(np.random.default_rng(CHURN_SEED).permutation(
            srv.kvcfg.pool_pages))
        reqs = _requests(Request, cfg.vocab, seed=7, n=n_requests)
        snap = {}

        def take_snapshot(step, s_):
            if step == SNAP_STEP:       # device copies, no host sync
                p_ = s_.cache["pool"]
                snap["tables"] = (p_.page_table.clone(), plan_fn(
                    s_.kvcfg, p_).use_parity.clone())
            if before is not None and step == SNAP_STEP:
                snap["state"] = s_.snapshot()
                snap["queue"] = [(r.rid, list(r.prompt), list(r.out))
                                 for r in s_.queue]
                snap["steps_run"] = s_.steps_run

        with counting_reads() as reads, watching_routes(torch) as routes:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode_s = _drive(srv, reqs, take_snapshot)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launches = ckd_kernel.launches          # main path ends here
        total_launches += launches
        n_degraded = int(sum(reads["degraded"])) * cfg.n_layers
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(peak_gb <= PEAK_LIMIT_GB,
              f"{cfg.name} {name}: peak allocated {peak_gb:.2f} GB > "
              f"{PEAK_LIMIT_GB}")
        check(launches == srv.steps_run * cfg.n_layers,
              f"{name}: {launches} gather launches for {srv.steps_run} "
              f"decode steps x {cfg.n_layers} layers")
        check(all(r.done and len(r.out) == SERVE["max_new_tokens"]
                  for r in reqs + [warm]), f"{name}: a request did not finish")
        if name == "coded_fused":
            check(n_degraded > 0, f"{name}: the plan served no degraded read")
        elif name == "uncoded":
            check(n_degraded == 0, f"{name}: {n_degraded} degraded reads")
        if ref_banks is None:   # on the host: the later runs' peaks
            ref_banks = (pool.k_banks.cpu(), pool.v_banks.cpu())
        check(torch.equal(pool.k_banks.cpu(), ref_banks[0])
              and torch.equal(pool.v_banks.cpu(), ref_banks[1]),
              f"{name}: K/V banks differ from the first run's")
        n_fresh = check_parity(pool, name) if kvbank.pool_coded(pool) \
            else 0
        gathered = check_gather(torch, cfg, pool, *snap["tables"], name)
        summ = srv.log.summary(rids={r.rid for r in reqs})
        n_tok = sum(len(r.out) for r in reqs)
        with torch.no_grad():
            logits, _ = lm.prefill(cfg, srv.params, torch.tensor(
                [reqs[0].prompt], device="cuda"))
        check(tuple(logits.shape) == (1, cfg.vocab_pad)
              and bool(torch.isfinite(logits[:, :cfg.vocab]).all()),
              f"{name}: prefill logits not finite of shape (1, vocab_pad)")
        steps = srv.steps_run - warm_steps
        runs[name] = [r.out for r in reqs]
        print(f"serve {cfg.name} {name}: {len(reqs)} requests, {n_tok} "
              f"tokens in "
              f"{dt:.3f} s = {n_tok / dt:.1f} tok/s steady-state; "
              f"{steps} decode steps, {1e3 * sum(decode_s) / len(decode_s):.2f}"
              f" ms/step mean, {1e3 * sorted(decode_s)[len(decode_s) // 2]:.2f}"
              f" ms/step p50; TTFT p50 {1e3 * summ['ttft_p50_s']:.1f} ms; "
              f"gather launches {launches} = {srv.steps_run} steps x "
              f"{cfg.n_layers}; {n_degraded} degraded page reads; banks "
              f"equal the first run's, {n_fresh} fresh parity rows checked; "
              f"pool {pool_mb:.0f} MB; peak allocated {peak_gb:.2f} GB; "
              f"{gathered}")
        if cfg.family == "moe":
            from repro_torch.models import moe
            shares = drop_shares(torch, routes)
            # a decode step routes one group of the slots' tokens, a
            # prefill one group of the padded prompt's
            check(set(shares) == {SERVE["n_slots"], SERVE["max_prompt"]},
                  f"{name}: MoE dispatch groups of {sorted(shares)} tokens")
            print(f"serve {cfg.name} {name} MoE routing ({cfg.n_experts} "
                  f"experts top-{cfg.top_k}, {cfg.n_layers} layers): "
                  + "; ".join(f"{kind} groups of {g} tokens (capacity "
                              f"{moe.groups(cfg, g)[2]}) dropped "
                              f"{shares[g][0]:.1%} of {shares[g][1]} "
                              "assignments" for kind, g in
                              (("decode", SERVE["n_slots"]),
                               ("prefill", SERVE["max_prompt"]))))
        if before is not None:
            total_launches += _telemetry_checks(torch, cfg, params, srv,
                                                before, reads, steps, snap,
                                                reqs, name)
        if name in ("coded_fused", "coded_telemetry"):
            profile_decode(torch, srv, Request)
        del srv, pool
        torch.cuda.empty_cache()
    names = list(runs)
    check(all(runs[n] == runs[names[0]] for n in names),
          f"{cfg.name}: the pool runs served different tokens")
    print(f"serve {cfg.name}: {', '.join(names)} served identical tokens "
          f"(first request: {runs[names[0]][0][:8]}...)")
    ring_kv = _ring_run(torch, cfg, params, runs[names[0]], n_requests)
    del params, ref_banks
    torch.cuda.empty_cache()
    print(f"serve: {cfg.name} took {time.perf_counter() - t_config:.1f} s "
          "of the phase")
    return total_launches, ring_kv


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, tuple):          # a NamedTuple cache
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _telemetry_checks(torch, cfg, params, srv, before, reads, steps, snap,
                      reqs, name) -> int:
    """The telemetry run: its planes against its own counts, then node
    replacement from the mid-stream snapshot into a fresh card server,
    which must finish with the same tokens, pool and planes. Returns the
    replacement's gather launches."""
    from repro_torch.kernels.coded_kv_decode import kernel as ckd_kernel
    from repro_torch.obs.serve import format_summary
    from repro_torch.runtime.server import Request, ServeConfig, Server

    after = srv.serve_snapshot()
    _check_planes(name, _plane_delta(after, before), reads, steps,
                  cfg.n_layers)
    print(f"serve {name} planes (whole run, warm-up included):\n"
          + format_summary(after))
    check("state" in snap, f"{name}: no snapshot was taken")
    t0 = time.perf_counter()
    node = Server(cfg, ServeConfig(**SERVE, telemetry=True), params,
                  device="cuda")
    node.restore_snapshot(snap["state"])
    node.queue = [Request(rid=q[0], prompt=q[1], out=q[2])
                  for q in snap["queue"]]
    moved = [r for r in node.slots if r] + node.queue
    ckd_kernel.launches = 0                     # main path starts here
    node.run_until_drained()
    launches = ckd_kernel.launches              # main path ends here
    torch.cuda.synchronize()
    n_steps = srv.steps_run - snap["steps_run"]
    check(node.steps_run == n_steps and launches == n_steps * cfg.n_layers,
          f"{name}: the replacement ran {node.steps_run} steps, "
          f"{launches} launches; the original {n_steps} steps")
    by_rid = {r.rid: r.out for r in reqs}
    check(len(moved) > 0 and all(r.out == by_rid[r.rid] for r in moved),
          f"{name}: the replacement node served other tokens")
    check(_same_pool(torch, node.cache["pool"], srv.cache["pool"])
          and torch.equal(node.tokens, srv.tokens),
          f"{name}: the replacement node's pool differs")
    check(node.serve_snapshot().as_dict() == after.as_dict(),
          f"{name}: the replacement node's planes differ")
    print(f"serve {name}: snapshot after {SNAP_STEP} decode steps restored "
          f"into a fresh card server; {len(moved)} requests moved, "
          f"{n_steps} steps finished on both nodes with identical tokens, "
          f"pool and planes ({time.perf_counter() - t0:.1f} s)")
    del node
    return launches


def _ring_run(torch, cfg, params, pool_tokens, n_requests):
    """The config with kv_banks=0 serves from the ring cache: the same
    requests must get the pool runs' tokens. Returns its K/V of the first
    and last layers (B, max_seq, Hkv, D)."""
    from repro_torch.kernels.coded_kv_decode import kernel as ckd_kernel
    from repro_torch.runtime.server import Request, ServeConfig, Server

    ring_cfg = dataclasses.replace(cfg, kv_banks=0)
    srv = Server(ring_cfg, ServeConfig(**SERVE), params, device="cuda")
    check(not srv.pooled, "ring: kv_banks=0 did not select the ring cache")
    before = ckd_kernel.launches
    srv.submit(Request(rid=10_000, prompt=list(range(1, 17))))
    srv.run_until_drained()
    warm_steps = srv.steps_run
    reqs = _requests(Request, cfg.vocab, seed=7, n=n_requests)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode_s = _drive(srv, reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(ckd_kernel.launches == before, "ring: the pool gather launched")
    check([r.out for r in reqs] == pool_tokens,
          f"{cfg.name} ring: tokens differ from the pool runs'")
    n_tok = sum(len(r.out) for r in reqs)
    print(f"serve {cfg.name} ring (kv_banks=0): {len(reqs)} requests, "
          f"{n_tok} tokens in "
          f"{dt:.3f} s = {n_tok / dt:.1f} tok/s; {srv.steps_run - warm_steps}"
          f" decode steps, {1e3 * sum(decode_s) / len(decode_s):.2f} ms/step "
          f"mean; tokens equal the pool runs' (MP x page = max_seq = "
          f"{SERVE['max_seq']})")
    kv = {layer: (srv.cache["k"][layer].clone(), srv.cache["v"][layer].clone())
          for layer in (0, cfg.n_layers - 1)}
    del srv
    return kv


def vlm_serve_phase(torch):
    """phi-3-vision-4.2b at full width from the ring cache (the server
    keeps a vision prefix off the pool): 8 requests whose prompts are
    left-padded to 640 positions, the first 576 overwritten by the
    server's zero patch embeddings; every request finishes, the prefill
    logits are finite, a prefill with seeded random patches differs from
    one with zero patches (the frontend is live); then a profiled window.
    Returns the ring's K/V of layer 0 (B, max_seq, Hkv, D)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.coded_kv_decode import kernel as ckd_kernel
    from repro_torch.models import lm
    from repro_torch.runtime.server import Request, ServeConfig, Server

    cfg = get_config(VLM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(a.numel() for a in _leaves(params))
    print(f"serve: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
          f"heads {cfg.n_heads}/{cfg.n_kv} x {cfg.head_dim} vocab "
          f"{cfg.vocab_pad}, {cfg.n_patches} patch positions, "
          f"{n_params / 1e9:.2f} B random {cfg.compute_dtype} params (seed "
          f"0) made on the card in {time.perf_counter() - t0:.1f} s")
    srv = Server(cfg, ServeConfig(**VLM_SERVE), params, device="cuda")
    check(not srv.pooled, f"{cfg.name}: the vision prefix took the pool")
    cache_mb = sum(srv.cache[f].numel() * srv.cache[f].element_size()
                   for f in ("k", "v")) / 1e6
    before = ckd_kernel.launches
    warm = Request(rid=10_000, prompt=list(range(1, 17)))
    srv.submit(warm)
    srv.run_until_drained()
    warm_steps = srv.steps_run
    reqs = _requests(Request, cfg.vocab, seed=7, n=N_REQUESTS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode_s = _drive(srv, reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(peak_gb <= PEAK_LIMIT_GB,
          f"{cfg.name}: peak allocated {peak_gb:.2f} GB > {PEAK_LIMIT_GB}")
    check(ckd_kernel.launches == before, f"{cfg.name}: the pool gather "
          "launched on the ring")
    check(all(r.done and len(r.out) == SERVE["max_new_tokens"]
              for r in reqs + [warm]), f"{cfg.name}: a request did not "
          "finish")
    prompt = reqs[0].prompt
    toks = torch.tensor([[0] * (VLM_SERVE["max_prompt"] - len(prompt))
                         + prompt], device="cuda")
    shape = (1, cfg.n_patches, cfg.d_model)
    gen = torch.Generator(device="cuda").manual_seed(5)
    cd = getattr(torch, cfg.compute_dtype)
    patches = {"zero": torch.zeros(shape, dtype=cd, device="cuda"),
               "random": torch.randn(shape, generator=gen, device="cuda")
               .to(cd)}
    logits = {}
    with torch.no_grad():
        for key, p in patches.items():
            logits[key], _ = lm.prefill(cfg, srv.params, toks, patches=p)
    check(all(tuple(v.shape) == (1, cfg.vocab_pad)
              and bool(torch.isfinite(v[:, :cfg.vocab]).all())
              for v in logits.values()),
          f"{cfg.name}: prefill logits not finite of shape (1, vocab_pad)")
    moved = float((logits["random"] - logits["zero"])[:, :cfg.vocab]
                  .abs().max())
    check(moved > 0, f"{cfg.name}: random patches left the logits as "
          "zero patches do")
    summ = srv.log.summary(rids={r.rid for r in reqs})
    n_tok = sum(len(r.out) for r in reqs)
    print(f"serve {cfg.name} ring: {len(reqs)} requests (max_prompt "
          f"{VLM_SERVE['max_prompt']}), {n_tok} tokens in {dt:.3f} s = "
          f"{n_tok / dt:.1f} tok/s steady-state; "
          f"{srv.steps_run - warm_steps} decode steps, "
          f"{1e3 * sum(decode_s) / len(decode_s):.2f} ms/step mean, "
          f"{1e3 * sorted(decode_s)[len(decode_s) // 2]:.2f} ms/step p50; "
          f"TTFT p50 {1e3 * summ['ttft_p50_s']:.1f} ms; ring cache "
          f"{cache_mb:.0f} MB; peak allocated {peak_gb:.2f} GB; random "
          f"patches move the prefill logits by up to {moved:.3g} "
          f"(first request: {reqs[0].out[:8]}...)")
    profile_decode(torch, srv, Request)
    kv = (srv.cache["k"][0].clone(), srv.cache["v"][0].clone())
    del srv, params
    torch.cuda.empty_cache()
    return kv


def audio_serve_phase(torch):
    """whisper-tiny at full width from the ring cache (an encoder-decoder
    never takes the pool): 8 requests on 8 slots, 32 new tokens each;
    every admission's prefill encodes the server's zero frames (1, 1,500,
    384) and installs the slot's cross-attention K/V. Every request
    finishes, the prefill logits are finite, seeded random frames move
    them, no pool gather launches; prints ms/step, tok/s, TTFT, the
    cross K/V's MB, peak allocated and the weight floor, then a profiled
    window. Returns the decoder self-attention ring's K/V of layer 0 (B,
    max_seq, Hkv, D)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.coded_kv_decode import kernel as ckd_kernel
    from repro_torch.models import lm
    from repro_torch.runtime.server import Request, ServeConfig, Server

    cfg = get_config(AUDIO_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(a.numel() for a in _leaves(params))
    n_bytes = sum(a.numel() * a.element_size() for a in _leaves(params))
    floor_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    print(f"serve: {cfg.name} ({cfg.family}) {cfg.enc_layers} encoder + "
          f"{cfg.n_layers} decoder layers d_model {cfg.d_model} heads "
          f"{cfg.n_heads} x {cfg.head_dim} vocab {cfg.vocab_pad}, "
          f"{n_params / 1e6:.2f} M random {cfg.compute_dtype} params (seed "
          f"0; the config's n_params {cfg.n_params() / 1e6:.2f} M leaves "
          f"out cross-attention and the position table) made on the card "
          f"in {time.perf_counter() - t0:.1f} s; weight floor "
          f"{n_bytes / 1e6:.1f} MB / {HBM_BYTES_PER_S / 1e12:.2f} TB/s = "
          f"{floor_ms:.3f} ms/step")
    srv = Server(cfg, ServeConfig(**SERVE), params, device="cuda")
    check(not srv.pooled, f"{cfg.name}: an encoder-decoder took the pool")
    check(srv.n_frames == cfg.enc_frames, f"{cfg.name}: {srv.n_frames} "
          f"frames at admission, not {cfg.enc_frames}")
    xkv_mb = sum(srv.cache[f].numel() * srv.cache[f].element_size()
                 for f in ("xk", "xv")) / 1e6
    kv_mb = sum(srv.cache[f].numel() * srv.cache[f].element_size()
                for f in ("k", "v")) / 1e6
    before = ckd_kernel.launches
    warm = Request(rid=10_000, prompt=list(range(1, 17)))
    srv.submit(warm)
    srv.run_until_drained()
    warm_steps = srv.steps_run
    reqs = _requests(Request, cfg.vocab, seed=7, n=N_REQUESTS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode_s = _drive(srv, reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(peak_gb <= PEAK_LIMIT_GB,
          f"{cfg.name}: peak allocated {peak_gb:.2f} GB > {PEAK_LIMIT_GB}")
    check(ckd_kernel.launches == before, f"{cfg.name}: the pool gather "
          "launched on the ring")
    check(all(r.done and len(r.out) == SERVE["max_new_tokens"]
              for r in reqs + [warm]), f"{cfg.name}: a request did not "
          "finish")
    prompt = reqs[0].prompt
    toks = torch.tensor([[0] * (SERVE["max_prompt"] - len(prompt))
                         + prompt], device="cuda")
    shape = (1, cfg.enc_frames, cfg.d_model)
    gen = torch.Generator(device="cuda").manual_seed(5)
    cd = getattr(torch, cfg.compute_dtype)
    frames = {"zero": torch.zeros(shape, dtype=cd, device="cuda"),
              "random": torch.randn(shape, generator=gen, device="cuda")
              .to(cd)}
    logits = {}
    with torch.no_grad():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for key, f in frames.items():
            logits[key], _ = lm.prefill(cfg, srv.params, toks, frames=f)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t1) / len(frames)
    check(all(tuple(v.shape) == (1, cfg.vocab_pad)
              and bool(torch.isfinite(v[:, :cfg.vocab]).all())
              for v in logits.values()),
          f"{cfg.name}: prefill logits not finite of shape (1, vocab_pad)")
    moved = float((logits["random"] - logits["zero"])[:, :cfg.vocab]
                  .abs().max())
    check(moved > 0, f"{cfg.name}: random frames left the logits as zero "
          "frames do")
    summ = srv.log.summary(rids={r.rid for r in reqs})
    n_tok = sum(len(r.out) for r in reqs)
    print(f"serve {cfg.name} ring: {len(reqs)} requests (max_prompt "
          f"{SERVE['max_prompt']}, {cfg.enc_frames} frames each), {n_tok} "
          f"tokens in {dt:.3f} s = {n_tok / dt:.1f} tok/s steady-state; "
          f"{srv.steps_run - warm_steps} decode steps, "
          f"{1e3 * sum(decode_s) / len(decode_s):.2f} ms/step mean, "
          f"{1e3 * sorted(decode_s)[len(decode_s) // 2]:.2f} ms/step p50 "
          f"(weight floor {floor_ms:.3f}); TTFT p50 "
          f"{1e3 * summ['ttft_p50_s']:.1f} ms; one prefill with its "
          f"encoder {prefill_ms:.1f} ms; ring K/V {kv_mb:.1f} MB, cross "
          f"K/V {xkv_mb:.1f} MB ({SERVE['n_slots']} slots); peak allocated "
          f"{peak_gb:.2f} GB; random frames move the prefill logits by up "
          f"to {moved:.3g} (first request: {reqs[0].out[:8]}...)")
    profile_decode(torch, srv, Request)
    kv = (srv.cache["k"][0].clone(), srv.cache["v"][0].clone())
    del srv, params
    torch.cuda.empty_cache()
    return kv


def recurrent_serve_phase(torch, arch: str):
    """``arch`` (mamba2-2.7b or recurrentgemma-9b) at full width from the
    ring cache, which holds each slot's conv tails and f32 recurrent
    states (and, for the hybrid, its local-attention ring): 8 requests of
    ``RECURRENT_SERVE``'s prompt lengths on 8 slots, 32 new tokens each.
    Every request finishes, the prefill logits are finite, no pool gather
    launches; prints ms/step, tok/s, TTFT, peak allocated and the weight
    floor (param bytes / HBM rate, the param count held against the
    config's ``n_params``), then a profiled window. Returns the local
    attention ring's K/V of its first attention layer (B, window, Hkv,
    D), or None for a family without one."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.coded_kv_decode import kernel as ckd_kernel
    from repro_torch.models import lm
    from repro_torch.runtime.server import Request, ServeConfig, Server

    cfg = get_config(arch)
    if arch in SERVE_DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=SERVE_DEPTH[arch])
    sc_kw, (lo, hi) = RECURRENT_SERVE[arch]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(a.numel() for a in _leaves(params))
    n_bytes = sum(a.numel() * a.element_size() for a in _leaves(params))
    floor_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    check(abs(n_params / cfg.n_params() - 1) <= PARAMS_TOL,
          f"{cfg.name}: {n_params} params drawn, the config counts "
          f"{cfg.n_params()}")
    print(f"serve: {cfg.name} ({cfg.family}) {cfg.n_layers} layers d_model "
          f"{cfg.d_model} vocab {cfg.vocab_pad}, {n_params / 1e9:.3f} B "
          f"random {cfg.compute_dtype} params (seed 0; the config's "
          f"n_params {cfg.n_params() / 1e9:.3f} B) made on the card in "
          f"{time.perf_counter() - t0:.1f} s; weight floor "
          f"{n_bytes / 1e9:.2f} GB / {HBM_BYTES_PER_S / 1e12:.2f} TB/s = "
          f"{floor_ms:.2f} ms/step")
    srv = Server(cfg, ServeConfig(**sc_kw), params, device="cuda")
    check(not srv.pooled, f"{cfg.name}: took the pool, not the ring")
    state_mb = sum(t.numel() * t.element_size()
                   for k, v in srv.cache.items() if k != "pos"
                   for t in _leaves(v)) / 1e6
    before = ckd_kernel.launches
    warm = Request(rid=10_000, prompt=list(range(1, 17)))
    srv.submit(warm)
    srv.run_until_drained()
    warm_steps = srv.steps_run
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, prompt=[int(t) for t in
                                   rng.integers(1, cfg.vocab, size=int(k))])
            for i, k in enumerate(rng.integers(lo, hi + 1,
                                               size=N_REQUESTS))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode_s = _drive(srv, reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(peak_gb <= PEAK_LIMIT_GB,
          f"{cfg.name}: peak allocated {peak_gb:.2f} GB > {PEAK_LIMIT_GB}")
    check(ckd_kernel.launches == before, f"{cfg.name}: the pool gather "
          "launched on the ring")
    check(all(r.done and len(r.out) == sc_kw["max_new_tokens"]
              for r in reqs + [warm]), f"{cfg.name}: a request did not "
          "finish")
    pad = sc_kw["max_prompt"] - len(reqs[0].prompt)
    with torch.no_grad():
        logits, cache = lm.prefill(cfg, srv.params, torch.tensor(
            [[0] * pad + reqs[0].prompt], device="cuda"))
    check(tuple(logits.shape) == (1, cfg.vocab_pad)
          and bool(torch.isfinite(logits[:, :cfg.vocab]).all())
          and all(bool(torch.isfinite(t.float()).all())
                  for t in _leaves(cache)),
          f"{cfg.name}: prefill logits or state not finite")
    del logits, cache
    summ = srv.log.summary(rids={r.rid for r in reqs})
    n_tok = sum(len(r.out) for r in reqs)
    ring = ""
    if "k" in srv.cache:
        c = srv.cache["k"].shape[2]
        ring = (f"; the attention ring of {c} positions wrapped "
                f"(decode from position {sc_kw['max_prompt']})")
    mean_ms = 1e3 * sum(decode_s) / len(decode_s)
    print(f"serve {cfg.name} ring: {len(reqs)} requests of "
          f"{min(len(r.prompt) for r in reqs)}-"
          f"{max(len(r.prompt) for r in reqs)} prompt tokens (max_prompt "
          f"{sc_kw['max_prompt']}), {n_tok} tokens in {dt:.3f} s = "
          f"{n_tok / dt:.1f} tok/s steady-state; "
          f"{srv.steps_run - warm_steps} decode steps, {mean_ms:.2f} "
          f"ms/step mean, {1e3 * sorted(decode_s)[len(decode_s) // 2]:.2f} "
          f"ms/step p50 (weight floor {floor_ms:.2f}); TTFT p50 "
          f"{1e3 * summ['ttft_p50_s']:.1f} ms; cache {state_mb:.0f} MB "
          f"(recurrent state and ring, {sc_kw['n_slots']} slots); peak "
          f"allocated {peak_gb:.2f} GB{ring} (first request: "
          f"{reqs[0].out[:8]}...)")
    profile_decode(torch, srv, Request)
    kv = None
    if "k" in srv.cache:
        kv = (srv.cache["k"][0].clone(), srv.cache["v"][0].clone())
    del srv, params
    torch.cuda.empty_cache()
    return kv


# ---------------------------------------------------------------- phase 5
BENCH_SERVE = dict(n_slots=4, max_prompt=16, max_seq=64, max_new_tokens=16)
BENCH_CHURN_EVERY = 2            # benchmarks/bench_serve.py:41
BENCH_SNAP_STEP = 20


def _bench_requests(Request, vocab: int, n: int = 16, seed: int = 0):
    """benchmarks/bench_serve.py::_requests."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=[int(x) for x in rng.integers(
        1, max(vocab // 2, 2), size=4 + i % 9)]) for i in range(n)]


def _step_latencies(torch, srv, store) -> None:
    """This step's per-page critical-word latencies under its planned
    (coded) read order and under an all-direct plan on the same placement,
    from the port's ``read_latencies`` (the read plan replayed on a copy
    of the code-status table)."""
    from repro_torch.runtime import kvbank as kb
    pool, kvcfg = srv.cache["pool"], srv.kvcfg
    active = (pool.page_table[:, 0] >= 0) & (pool.length > 0)
    widx = kb.pool_write_index(kvcfg, pool, active)
    staled = dataclasses.replace(pool,
                                 parity_fresh=pool.parity_fresh.clone())
    kb.pool_mark_stale(kvcfg, staled, widx)
    len_eff = pool.length + active.to(pool.length.dtype)
    plan = kb.pool_plan(kvcfg, staled, length=len_eff)
    for key, up in (("coded", plan.use_parity),
                    ("uncoded", torch.zeros_like(plan.use_parity))):
        lat = kb.read_latencies(kvcfg, pool.page_table, len_eff, up)
        store[key].extend(lat[lat > 0].tolist())


def _bench_drive(srv, reqs, perms, start=0, on_step=None):
    """bench_serve's schedule from decode step ``start``: admit, a seeded
    placement churn every 2 steps, one decode step. ``perms`` maps a step
    to its permutation: filled by the first run, replayed by the others."""
    import numpy as np
    rng = np.random.default_rng(0)
    for r in reqs:
        srv.submit(r)
    step = start
    while True:
        srv._admit()
        if not any(s_ is not None for s_ in srv.slots):
            break
        if step and step % BENCH_CHURN_EVERY == 0:
            if step not in perms:
                perms[step] = rng.permutation(srv.kvcfg.pool_pages)
            srv.permute_pool(perms[step])
        if on_step is not None:
            on_step(step, srv)
        srv.step_decode()
        step += 1
    return step


def cross_device_phase(torch, arch: str):
    """``arch`` reduced at f32 (TF32 off) on bench_serve's schedule, on
    the card and on the CPU: identical tokens, logits within 1e-4, the
    serve planes equal exactly; critical-word latencies from the port's
    ``read_latencies``; a card snapshot restored on the CPU finishes
    identically."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.coded_kv_decode import kernel as ckd_kernel
    from repro_torch.models import lm
    from repro_torch.obs.serve import format_summary
    from repro_torch.runtime.server import Request, ServeConfig, Server

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).reduced(), kv_page=4,
                              compute_dtype="float32")
    tag = f"cross-device {cfg.name}"
    params = lm.init_params(cfg, seed=1, device="cpu")
    sc = ServeConfig(**BENCH_SERVE, telemetry=True)
    out, logits, planes, perms, lat = {}, {}, {}, {}, {"coded": [],
                                                        "uncoded": []}
    snap = {}

    def on_card_step(step, srv):
        _step_latencies(torch, srv, lat)
        if step == BENCH_SNAP_STEP:
            snap["state"] = srv.snapshot()
            snap["queue"] = [(r.rid, list(r.prompt), list(r.out))
                             for r in srv.queue]

    before = ckd_kernel.launches
    for dev in ("cuda", "cpu"):
        srv = Server(cfg, sc, params, device=dev)
        logits[dev] = []
        keep_logits(torch, lm, srv, logits[dev])
        reqs = _bench_requests(Request, cfg.vocab)
        with counting_reads() as reads:
            _bench_drive(srv, reqs, perms,
                         on_step=on_card_step if dev == "cuda" else None)
        out[dev] = [r.out for r in reqs]
        planes[dev] = srv.serve_snapshot()
        if dev == "cuda":
            n_degraded = int(sum(reads["degraded"])) * cfg.n_layers
            card_pool = srv.cache["pool"]
    check(ckd_kernel.launches > before, f"{tag}: kernel not launched")
    check(n_degraded > 0, f"{tag}: the plan served no degraded read")
    check(out["cuda"] == out["cpu"],
          f"{tag}: card {out['cuda']} vs CPU {out['cpu']}")
    check(len(logits["cuda"]) == len(logits["cpu"]),
          f"{tag}: the card and the CPU ran different step counts")
    err = 0.0
    for a, b in zip(logits["cuda"], logits["cpu"]):
        check(torch.allclose(a, b, rtol=LOGITS_TOL, atol=LOGITS_TOL),
              f"{tag}: logits differ by {float((a - b).abs().max())}")
        err = max(err, float((a - b).abs().max()))
    card, cpu = planes["cuda"].as_dict(), planes["cpu"].as_dict()
    check(card == cpu, f"{tag}: planes differ card {card} vs CPU "
          f"{cpu}")
    p50_c, p99_c = np.percentile(lat["coded"], [50, 99])
    p50_u, p99_u = np.percentile(lat["uncoded"], [50, 99])
    print(f"{tag}: at f32 (TF32 off) on "
          f"bench_serve's schedule ({len(out['cpu'])} requests x "
          f"{BENCH_SERVE['max_new_tokens']} tokens, {BENCH_SERVE['n_slots']} "
          f"slots, page 4, churn every {BENCH_CHURN_EVERY}) served identical "
          f"tokens on the card and the CPU; {len(logits['cpu'])} prefill and "
          f"decode logits within rtol=atol={LOGITS_TOL} (max abs diff "
          f"{err:.3g}); every serve plane equal card vs CPU; "
          f"{n_degraded} degraded page reads on the card")
    print(f"{tag} planes on the card: port cycles coded "
          f"{card['coded_cycles']} vs uncoded {card['uncoded_cycles']}, "
          f"{card['degraded_reads']} degraded reads of "
          f"{card['served_pages']}; critical-word latency (port cycles, "
          f"read_latencies over {len(lat['coded'])} page reads) coded p50 "
          f"{p50_c:g} p99 {p99_c:g} mean {np.mean(lat['coded']):.3f}, "
          f"all-direct p50 {p50_u:g} p99 {p99_u:g} mean "
          f"{np.mean(lat['uncoded']):.3f}\n" + format_summary(planes["cuda"]))

    # a card snapshot restored on the CPU finishes identically
    check("state" in snap, f"{tag}: no snapshot was taken")
    node = Server(cfg, sc, params, device="cpu")
    node.restore_snapshot(snap["state"])
    moved = [r for r in node.slots if r]
    node.queue = [Request(rid=q[0], prompt=q[1], out=q[2])
                  for q in snap["queue"]]
    moved += node.queue
    node.step_decode()                   # the snapshot's own step
    _bench_drive(node, [], perms, start=BENCH_SNAP_STEP + 1)
    by_rid = dict(zip(range(len(out["cuda"])), out["cuda"]))
    check(len(moved) > 0 and all(r.out == by_rid[r.rid] for r in moved),
          f"{tag}: the CPU node restored from the card served other "
          "tokens")
    check(node.serve_snapshot().as_dict() == card,
          f"{tag}: the CPU node restored from the card has other "
          "planes")
    for f in ("page_table", "length", "parity_fresh"):
        check(torch.equal(getattr(node.cache["pool"], f),
                          getattr(card_pool, f).cpu()),
              f"{tag}: restored {f} differs")
    print(f"{tag}: card snapshot after {BENCH_SNAP_STEP} "
          f"decode steps restored on the CPU; {len(moved)} requests "
          f"finished there with the card's tokens, planes and tables")


def with_margin(torch, fn, *args) -> float:
    """Run ``fn(*args)`` watching the MoE routing; a failure is reported
    with the smallest router margin the run saw. Returns that margin."""
    with watching_routes(torch, margins=True) as seen:
        try:
            fn(*args)
        except RuntimeError as exc:
            raise RuntimeError(f"{exc} (smallest router margin of the run: "
                               f"{min_margin(torch, seen)})") from exc
    return min_margin(torch, seen)


def moe_layer_phase(torch) -> None:
    """One full-width olmoe-1b-7b layer's MoE block (64 experts top-8,
    d_model 2048, d_ff 1024) in f32 (TF32 off), on the card and the CPU,
    for the 8-token decode group and one 128-token prefill group: the
    card's router logits, copied to the CPU, route alike there (experts
    and keep mask identical), and the outputs agree within ``LOGITS_TOL``
    of their largest magnitude."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config(MOE_ARCH), compute_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(3)
    p = moe.moe_init(cfg, gen, torch.float32)
    p_cpu = {k: v.cpu() for k, v in p.items()}
    for label, (b, t) in MOE_LAYER_GROUPS:
        x = torch.randn(b, t, cfg.d_model, generator=gen, device="cuda")
        _, _, cap = moe.groups(cfg, b * t)
        with torch.no_grad():
            logits = moe.router_logits(cfg, p, x)
            r = moe.route(cfg, logits, cap)
            y = moe.experts(cfg, p, x, r, cap).cpu()
            r_cpu = moe.route(cfg, logits.cpu(), cap)
            y_cpu = moe.experts(cfg, p_cpu, x.cpu(), r_cpu, cap)
            own = moe.router_logits(cfg, p_cpu, x.cpu())
        top = logits.topk(cfg.top_k + 1, dim=-1).values
        margin = float((top[..., -2] - top[..., -1]).min())
        tag = f"moe layer {cfg.name} {label} ({b * t} tokens, capacity {cap})"
        check(torch.equal(r.idx.cpu(), r_cpu.idx)
              and torch.equal(r.keep.cpu(), r_cpu.keep),
              f"{tag}: the card and the CPU route the card's logits apart")
        err = float((y - y_cpu).abs().max())
        scale = float(y_cpu.abs().max())
        check(bool(torch.isfinite(y).all()) and err <= LOGITS_TOL * scale,
              f"{tag}: outputs differ by {err:.3g} of {scale:.3g} (smallest "
              f"router margin {margin:.3g})")
        print(f"{tag}: at f32 (TF32 off) experts and keep mask identical "
              f"card vs CPU; {1 - float(r.keep.float().mean()):.1%} of "
              f"{r.keep.numel()} assignments dropped; output max abs diff "
              f"{err:.3g} of max {scale:.3g} (tol {LOGITS_TOL} relative); "
              f"smallest k-th to (k+1)-th router logit gap {margin:.3g}; "
              f"the CPU's own router logits within "
              f"{float((logits.cpu() - own).abs().max()):.3g} of the card's")
    del p, p_cpu
    torch.cuda.empty_cache()


def mixer_layer_phase(torch) -> None:
    """One full-width layer of each recurrent mixer at f32 (TF32 off) on
    the card and the CPU, from one seeded init and input: mamba2-2.7b's
    ``ssm_block`` (d_model 2560, 80 heads x 64, state 128) and
    recurrentgemma-9b's ``rglru_block`` (d_model 4096) over a (1, 512)
    prompt with its cache, then ``MIXER_LAYER["decode_steps"]`` decode
    steps from that cache: every output and the final state within
    ``LOGITS_TOL`` of its largest magnitude."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import rglru, ssm

    torch.backends.cuda.matmul.allow_tf32 = False
    for arch, mod in (("mamba2-2.7b", ssm), ("recurrentgemma-9b", rglru)):
        cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
        gen = torch.Generator(device="cuda").manual_seed(3)
        if mod is ssm:
            p = ssm.ssm_init(cfg, gen, torch.float32)
            p["A_log"].uniform_(-1.0, 1.5, generator=gen)
            p["D"].normal_(1.0, 0.5, generator=gen)
            p["dt_bias"].normal_(0.0, 1.0, generator=gen)
            block, decode = ssm.ssm_block, ssm.ssm_decode
        else:
            p = rglru.rglru_init(cfg, gen, torch.float32)
            p["lam"].normal_(0.5, 1.0, generator=gen)
            block, decode = rglru.rglru_block, rglru.rglru_decode
        xs = [torch.randn(1, MIXER_LAYER["t"], cfg.d_model, generator=gen,
                          device="cuda")]
        xs += [torch.randn(1, 1, cfg.d_model, generator=gen, device="cuda")
               for _ in range(MIXER_LAYER["decode_steps"])]
        outs = {}
        for dev in ("cuda", "cpu"):
            pd = {k: v.to(dev) for k, v in p.items()}
            with torch.no_grad():
                y, cache = block(cfg, pd, xs[0].to(dev), return_cache=True)
                ys = [y]
                for x in xs[1:]:
                    y, cache = decode(cfg, pd, x.to(dev), cache)
                    ys.append(y)
            outs[dev] = [t.cpu() for t in ys + list(cache)]
        tag = (f"mixer layer {cfg.name} {mod.__name__.split('.')[-1]} "
               f"(d_model {cfg.d_model}, prompt {MIXER_LAYER['t']}, "
               f"{MIXER_LAYER['decode_steps']} decode steps)")
        errs = []
        for a, b in zip(outs["cuda"], outs["cpu"]):
            err, scale = float((a - b).abs().max()), float(b.abs().max())
            check(bool(torch.isfinite(a).all())
                  and err <= LOGITS_TOL * scale,
                  f"{tag}: card and CPU differ by {err:.3g} of {scale:.3g}")
            errs.append(err / scale)
        print(f"{tag}: at f32 (TF32 off) the prompt's output, each decode "
              f"step's and the final state card = CPU within "
              f"{LOGITS_TOL} of their largest magnitude (worst "
              f"{max(errs):.3g}, prompt {errs[0]:.3g})")
        del p, outs
    torch.cuda.empty_cache()


def _random_inputs(torch, srv) -> None:
    """Give ``srv``'s prefills seeded random patch or frame embeddings
    (the k-th admission's drawn on the CPU from seed k) in place of the
    server's zero ones, alike on every device."""
    step, count = srv.prefill, [0]

    def rnd(zeros):
        if zeros is None:
            return None
        gen = torch.Generator().manual_seed(count[0])
        return torch.randn(zeros.shape, generator=gen).to(zeros.device,
                                                          zeros.dtype)

    def prefill(params, tokens, patches=None, **frames):
        out = step(params, tokens, rnd(patches),
                   **{k: rnd(v) for k, v in frames.items()})
        count[0] += 1
        return out

    srv.prefill = prefill


def ring_cross_phase(torch, arch: str, reduced: bool = True) -> None:
    """``arch`` (a ring-cache config), reduced unless ``reduced`` is
    False, at f32 (TF32 off) with bench_serve's slots and requests, on
    the card and the CPU (a vision prefix with seeded random patches, an
    encoder-decoder with seeded random frames): identical tokens; the
    first wave's prefill logits and the first decode step's within
    ``LOGITS_TOL``."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm
    from repro_torch.runtime.server import Request, ServeConfig, Server

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg.reduced() if reduced else cfg,
                              compute_dtype="float32")
    tag = f"cross-device {cfg.name}"
    params = lm.init_params(cfg, seed=1, device="cpu")
    sc = ServeConfig(**BENCH_SERVE)
    out, logits = {}, {}
    for dev in ("cuda", "cpu"):
        srv = Server(cfg, sc, params, device=dev)
        check(not srv.pooled, f"{tag}: took the pool, not the ring")
        logits[dev] = []
        keep_logits(torch, lm, srv, logits[dev])
        if cfg.frontend != "none":
            _random_inputs(torch, srv)
        reqs = _bench_requests(Request, cfg.vocab)
        for r in reqs:
            srv.submit(r)
        srv.run_until_drained()
        out[dev] = [r.out for r in reqs]
    check(len(logits["cuda"]) == len(logits["cpu"]),
          f"{tag}: the card and the CPU ran different step counts")
    first = BENCH_SERVE["n_slots"] + 1      # the first wave's prefills
    errs = [float((a - b).abs().max())      # and the first decode step
            for a, b in zip(logits["cuda"], logits["cpu"])]
    check(all(torch.allclose(a, b, rtol=LOGITS_TOL, atol=LOGITS_TOL)
              for a, b in zip(logits["cuda"][:first], logits["cpu"][:first])),
          f"{tag}: prefill or first-step logits differ by "
          f"{max(errs[:first]):.3g}")
    check(out["cuda"] == out["cpu"],
          f"{tag}: card {out['cuda']} vs CPU {out['cpu']}")
    w = cfg.sliding_window or cfg.local_window
    window = f", window {w}" if w else ""
    inputs = {"vision_stub": ", random patches",
              "audio_stub": f", random frames ({srv.n_frames} a prompt)"}
    print(f"{tag} (ring{window}" + inputs.get(cfg.frontend, "")
          + f"): at f32 (TF32 off) {len(out['cpu'])} requests x "
          f"{BENCH_SERVE['max_new_tokens']} tokens on {BENCH_SERVE['n_slots']}"
          f" slots served identical tokens on the card and the CPU; prefill "
          f"and first-step logits within rtol=atol={LOGITS_TOL} (max abs "
          f"diff {max(errs[:first]):.3g}; over all {len(errs)} steps "
          f"{max(errs):.3g})")


# ---------------------------------------------------------------- phase 6
# benchmarks/bench_kvbank.py's cases: name, (banks, page), lengths, churn,
# seed (its run() at :50-57)
KVSTATE_CASES = (
    ("churn_skew", (8, 16), (2048, 1024, 512, 256, 128, 128, 64, 64), 0.9,
     0),
    ("churn_uniform", (8, 16), (1024,) * 8, 0.9, 1),
    ("churn_heavy", (8, 16), (4096, 256, 128, 128, 64, 64, 32, 32), 0.9, 2),
    ("churn_4banks", (4, 32), (4096, 512, 256, 64), 0.9, 3),
    ("fresh_arrival", (8, 16), (2048, 1024, 512, 256, 128, 128, 64, 64), 0.0,
     4),
)
KVSTATE_APPENDS = 6              # tokens appended after the churned state


def kvstate_phase(torch):
    """The per-sequence ``BankedKVState`` API at bench_kvbank's cases, on
    the card and on the CPU: the churned state of ``_churned_state`` (Hkv
    1, D 8, bf16) with random bank bits and fresh parity; ``plan_reads``
    and ``gather_kv`` (``gather_pool_cuda`` on the card) equal the CPU's
    bit for bit; then appends with a budgeted recode every other token,
    and every leaf, plan and gather equal again."""
    import numpy as np
    from repro_torch.kernels.coded_kv_decode import kernel as ckd_kernel
    from repro_torch.runtime import kvbank as kb

    def compare(name, states, what):
        plans = {dev: kb.plan_reads(cfg, st) for dev, st in states.items()}
        for f in ("use_parity", "load", "uncoded_cycles", "coded_cycles"):
            check(torch.equal(getattr(plans["cuda"], f).cpu(),
                              getattr(plans["cpu"], f)),
                  f"kvstate {name}: {what}: plan {f} differs card vs CPU")
        before = ckd_kernel.launches
        kv = {dev: kb.gather_kv(cfg, st, plans[dev], torch.bfloat16)
              for dev, st in states.items()}
        check(ckd_kernel.launches == before + 1,
              f"kvstate {name}: gather_kv did not launch gather_pool")
        for i in (0, 1):
            check(torch.equal(kv["cuda"][i].cpu().view(torch.int16),
                              kv["cpu"][i].view(torch.int16)),
                  f"kvstate {name}: {what}: gather_kv differs card vs CPU")
        for f in dataclasses.fields(states["cpu"]):
            check(torch.equal(getattr(states["cuda"], f.name).cpu(),
                              getattr(states["cpu"], f.name)),
                  f"kvstate {name}: {what}: {f.name} differs card vs CPU")
        return plans["cpu"]

    for name, (nb, page), lengths, churn, seed in KVSTATE_CASES:
        mp = max(max(lengths) // page + 1, nb)
        n_pool = ((sum(lengths) // page * 2) // nb + 2) * nb
        cfg = kb.KVBankConfig(n_banks=nb, page=page, pool_pages=n_pool,
                              max_pages=mp)
        rng = np.random.default_rng(seed)
        n_live = sum(-(-n // page) for n in lengths)
        phys = rng.choice(n_pool, size=n_live, replace=False) if churn > 0 \
            else np.arange(n_live)
        table = np.full((len(lengths), mp), -1, np.int32)
        c = 0
        for i, n in enumerate(lengths):
            n_pages = -(-n // page)
            table[i, :n_pages] = phys[c:c + n_pages]
            c += n_pages
        bits = rng.integers(-2 ** 15, 2 ** 15, size=(2, nb, n_pool // nb,
                                                     page, 1, 8),
                            dtype=np.int16)
        states = {}
        for dev in ("cuda", "cpu"):
            st = kb.init_state(cfg, len(lengths), 1, 8, torch.bfloat16,
                               device=dev)
            st.page_table.copy_(torch.from_numpy(table))
            st.length.copy_(torch.tensor(lengths, dtype=torch.int32))
            st.k_banks.copy_(torch.from_numpy(bits[0]))
            st.v_banks.copy_(torch.from_numpy(bits[1]))
            states[dev] = kb.recode(cfg, st)
        plan = compare(name, states, "churned state")
        new = rng.integers(-2 ** 15, 2 ** 15, size=(KVSTATE_APPENDS, 2,
                                                    len(lengths), 1, 8),
                           dtype=np.int16)
        for j in range(KVSTATE_APPENDS):
            for st in states.values():
                dev = st.length.device
                k, v = (torch.from_numpy(new[j, i]).to(dev)
                        .view(torch.bfloat16) for i in (0, 1))
                kb.append_token(cfg, st, k, v)
                if j % 2:
                    kb.recode(cfg, st, budget=2)
        after = compare(name, states, f"{KVSTATE_APPENDS} appends")
        print(f"kvstate {name}: {nb} banks x page {page}, lengths "
              f"{list(lengths)}: port cycles coded {int(plan.coded_cycles)} "
              f"vs uncoded {int(plan.uncoded_cycles)}, "
              f"{int(plan.use_parity.sum())} degraded reads; after "
              f"{KVSTATE_APPENDS} appends and budget-2 recodes "
              f"{int(after.coded_cycles)} vs {int(after.uncoded_cycles)}, "
              f"{int(after.use_parity.sum())} degraded; plans, gather_kv and "
              "every state leaf equal card vs CPU")


# ---------------------------------------------------------------- phase 4
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
F32_TOL = 1e-5                   # rtol = atol, TF32 off: summation order
FLUSH_BYTES = 128 << 20          # > the H100's 50 MB L2


def time_cold(torch, fn, n: int, flush) -> float:
    """Mean ms of ``fn`` on the card with the L2 flushed before each call:
    per call a short sleep kernel (so the host has queued what follows),
    a write of ``flush``, then CUDA events around the call."""
    fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(n):
        torch.cuda._sleep(2_000_000)
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in marks) / n


# the split kernels of csrc/coded_kv_decode.cu, by mangled name: kind
# ("tc", "split" or "general") and template arguments ((value type code,
# D, GM, CW), (GM, NV) for the f32 kernel, (lane bytes, W, LT) for the
# general one)
_SPLIT_NAME = re.compile(
    r"kv_decode_(tc|split|general)_kernelI((?:Li\d+E)+)E")
_VT_NAME = {1: "bf16", 2: "f16"}
# the tensor-core kernel's widths (csrc/coded_kv_decode.cu::tc_width): a
# 16-bit lane type at any other width runs the general kernel
TC_WIDTHS = (8, 16, 32, 64, 96, 128, 160, 256)


def _split_key(mangled: str):
    m = _SPLIT_NAME.search(mangled)
    if m is None:
        return None
    return m.group(1), tuple(int(x) for x in re.findall(r"Li(\d+)E",
                                                          m.group(2)))


def _split_label(key) -> str:
    kind, args = key
    if kind == "tc":
        return (f"kv_decode_tc_kernel<{_VT_NAME[args[0]]}, D={args[1]}, "
                f"G<={args[2]}, {args[3]} warp(s) a chain>")
    if kind == "general":
        return (f"kv_decode_general_kernel<{args[0]}-byte lanes, "
                f"{args[1]}-byte vectors, <= {args[2]} lanes a thread>")
    return f"kv_decode_split_kernel<f32, G<={args[0]}, NV={args[1]}>"


def split_kernel_resources(log: str) -> dict:
    """Registers, spill bytes and static shared memory of each split-kernel
    instantiation, from ptxas -v's lines in the build log."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = _split_key(m.group(1))
            if cur is not None:
                out[cur] = dict(registers=None, spill_stores=None,
                                spill_loads=None, static_smem=0)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur]["spill_stores"] = int(m.group(1))
            out[cur]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[cur]["static_smem"] = int(sm.group(1)) if sm else 0
    return out


def split_kernel_hmma(lib_path) -> dict:
    """HMMA (tensor-core mma) instructions in each split kernel's SASS,
    from ``cuobjdump -sass`` of the built library."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = _split_key(m.group(1))
            if cur is not None:
                counts[cur] = 0
            continue
        if cur is not None and "HMMA" in line:
            counts[cur] += 1
    return counts


def split_key_for(value_dtype: str, d: int, occ):
    """The split-kernel instantiation that ``occ`` (``decode_occupancy``)
    names, as ``_split_key`` reads it from a mangled name."""
    if occ.kind == "tc":
        return "tc", ({"bfloat16": 1, "float16": 2}[value_dtype], d, occ.gm,
                      occ.cw)
    if occ.kind == "general":
        return "general", (4 if value_dtype == "float32" else 2, occ.vec,
                           occ.lt)
    return "split", (occ.gm, occ.nv)


def _decode_work(up, seq, nb, page, hkv, d, h, lane_bytes, q_bytes):
    """Bytes the decode must move and the operations it must do for this
    plan and these lengths: of each page it needs, the rows (tokens)
    below seq_len, read once from each distinct bank page (direct, or the
    sibling of a degraded page) and parity page, K and V; q read and the
    output written once; the plan and the lengths. 4 G D operations per
    key and kv head (q.k and p.v)."""
    import numpy as np
    up = up.cpu().numpy().astype(bool)
    seq = seq.cpu().numpy().astype(np.int64)
    b, n_pages = up.shape
    t = np.arange(n_pages)
    rows = np.clip(seq[:, None] - t[None, :] * page, 0, page)   # (B, n)
    direct = np.where(up, 0, rows)
    sib = np.zeros_like(rows)
    sib[:, t ^ 1] = np.where(up, rows, 0)        # page t's sibling is t ^ 1
    bank_rows = np.maximum(direct, sib).sum()
    deg = np.where(up, rows, 0)
    par_rows = np.maximum(deg[:, 0::2], deg[:, 1::2]).sum()
    row_bytes = hkv * d * lane_bytes
    n_bytes = (2 * (bank_rows + par_rows) * row_bytes + 2 * q_bytes
               + up.size * 4 + b * 4)
    ops = 4 * (h // hkv) * d * hkv * int(np.minimum(
        seq, n_pages * page).clip(min=0).sum())
    return int(n_bytes), ops


def _kernels_of_a_call(torch, fn):
    """One call of ``fn`` under torch.profiler: the host's kernel launch
    calls and the names of the kernel records (which a trace can drop)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = ROOT / "build" / "chip_smoke_decode_call_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return (_launch_calls(events),
            [e["name"] for e in events if e.get("cat") == "kernel"])


def decode_phase(torch, serving, built):
    """``coded_kv_decode`` at the serving widths (``serving``: (label, H,
    {layer: ring K/V}) of each served family's ring run: qwen2.5-3b's
    layers 0 and 35, the others' layer 0; recurrentgemma-9b's also in f32
    lanes), at a seeded width that is no whole number of 16-byte vectors,
    bench_kernels' shape, and one of at least 256 MB. The main path is
    ``ops.coded_kv_decode`` after ``ops.pack_kv_banks``; then the kernel
    is held against its plain version (and ``mha`` over the ring where the
    K/V came from one), timed, and put beside its bound and SDPA.
    ``built`` is the source's build result: each case prints its split
    kernel's registers, spills and shared memory (ptxas), its HMMA count
    (SASS; a tensor-core kernel with none fails), its blocks per SM and
    split count."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels.coded_kv_decode import kernel as ckd_kernel
    from repro_torch.kernels.coded_kv_decode import ops as ckd_ops
    from repro_torch.kernels.coded_kv_decode.ref import coded_kv_decode_plain
    from repro_torch.models import layers as ly

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2468)
    rng = np.random.default_rng(2468)

    def normal(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    def plan(b, n_pages):
        return torch.from_numpy(rng.random((b, n_pages)) < 0.4).to("cuda")

    bf16, f32 = torch.bfloat16, torch.float32
    cases = []          # (name, q, k, v, NB, page, plan, seq_len)
    ring = set()        # the cases whose K/V came from a ring run

    def lengths(b, t):
        return torch.tensor([t, 0, 37, 1000, 64, 1537, t - 1, 700],
                            dtype=torch.int32, device="cuda")[:b]

    # 1. serving widths: B=8, T=2048, the config's H, Hkv and D, NB=8, P=64
    for label, h, ring_kv in serving:
        for layer, (k, v) in ring_kv.items():
            b, t, _, d = k.shape
            name = f"{label}_layer{layer}"
            cases.append((name, normal(b, h, d, dtype=k.dtype), k, v, 8, 64,
                          plan(b, t // 64), lengths(b, t)))
            ring.add(name)
            if label == "serving_recurrentgemma-9b":
                # f32 lanes at its D = 256, G = 16: the general kernel
                cases.append((f"{name}_f32", normal(b, h, d, dtype=f32),
                              k.float(), v.float(), 8, 64,
                              plan(b, t // 64), lengths(b, t)))
                ring.add(f"{name}_f32")
    # a row that is no whole number of 16-byte vectors: D = 100 in bf16
    # (200 bytes), seeded, B=8, T=2048, H=8, Hkv=2
    cases.append(("odd_width_d100", normal(8, 8, 100, dtype=bf16),
                  normal(8, 2048, 2, 100, dtype=bf16),
                  normal(8, 2048, 2, 100, dtype=bf16), 8, 64, plan(8, 32),
                  lengths(8, 2048)))
    # 2. bench_kernels' shape (benchmarks/bench_kernels.py:122), f32
    cases.append(("bench", normal(2, 4, 64, dtype=f32),
                  normal(2, 128, 2, 64, dtype=f32),
                  normal(2, 128, 2, 64, dtype=f32), 4, 8, plan(2, 16),
                  torch.full((2,), 128, dtype=torch.int32, device="cuda")))
    # 3. >= 256 MB: B=16, T=16384, H=16, Hkv=2, D=128, bf16
    cases.append(("large", normal(16, 16, 128, dtype=bf16),
                  normal(16, 16384, 2, 128, dtype=bf16),
                  normal(16, 16384, 2, 128, dtype=bf16), 8, 64,
                  plan(16, 256),
                  torch.full((16,), 16384, dtype=torch.int32, device="cuda")))
    # 4. >= 256 MB at D = 100 (the general kernel): B=16, T=20480, H=16,
    # Hkv=2, bf16
    cases.append(("large_d100", normal(16, 16, 100, dtype=bf16),
                  normal(16, 20480, 2, 100, dtype=bf16),
                  normal(16, 20480, 2, 100, dtype=bf16), 8, 64,
                  plan(16, 320),
                  torch.full((16,), 20480, dtype=torch.int32, device="cuda")))
    packed = [ckd_ops.pack_kv_banks(k, v, nb, page)[:4]
              for _, _, k, v, nb, page, _, _ in cases]
    torch.cuda.synchronize()
    ckd_kernel.decode_launches = 0              # main path starts here
    outs = [ckd_ops.coded_kv_decode(q, *banks, up, seq)
            for (_, q, _, _, _, _, up, seq), banks in zip(cases, packed)]
    torch.cuda.synchronize()
    launches = ckd_kernel.decode_launches       # main path ends here
    check(launches == len(cases),
          f"coded_kv_decode: {launches} launches for {len(cases)} calls")

    resources = split_kernel_resources(built.log)
    hmma = split_kernel_hmma(built.path)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    results = {}
    for (name, q, k, v, nb, page, up, seq), banks, out in zip(
            cases, packed, outs):
        vd = q.dtype
        b, h, d = q.shape
        hkv = k.shape[2]
        vname = str(vd).split(".")[1]
        occ = ckd_kernel.decode_occupancy(vd, h, hkv, d, "cuda")
        blocks, smem, groups, gb = occ.blocks, occ.smem, occ.groups, occ.gb
        key = split_key_for(vname, d, occ)
        check(key in resources,
              f"coded_kv_decode {name}: the build log names no "
              f"{_split_label(key)}")
        res = resources[key]
        splits = ckd_kernel.decode_splits(b, hkv * groups * occ.slices,
                                          up.shape[1], n_sms, blocks)
        n_hmma = hmma.get(key, 0)
        # 16-bit lanes: the tensor cores at their widths, else the general
        # kernel; f32 lanes never the tensor cores (TF32)
        want = ((("tc",) if d in TC_WIDTHS else ("general",)) if vd != f32
                else ("scalar", "general"))
        check(occ.kind in want,
              f"coded_kv_decode {name}: {vname} lanes at D = {d} run "
              f"{_split_label(key)}")
        check(occ.kind != "tc" or n_hmma > 0,
              f"coded_kv_decode {name}: {_split_label(key)} has no HMMA")
        check(res.get("spill_stores") == 0 and res.get("spill_loads") == 0,
              f"coded_kv_decode {name}: {_split_label(key)} spills "
              f"{res.get('spill_stores')}/{res.get('spill_loads')} bytes")
        print(f"kernel coded_kv_decode {name}: split kernel "
              f"{_split_label(key)}: {res.get('registers')} registers, "
              f"spill stores/loads {res.get('spill_stores')}/"
              f"{res.get('spill_loads')} bytes, shared memory "
              f"{res.get('static_smem')} static + {smem} dynamic bytes, "
              f"{n_hmma} HMMA in its SASS; {blocks} blocks/SM x {n_sms} "
              f"SMs -> {splits} splits; {groups} head group(s) of <= {gb} "
              f"heads (grid {splits} x {hkv * groups} x {b})")
        up32, seq32 = up.to(torch.int32), seq
        # compared in f32: with q in f32 the kernel and the plain version
        # return their f32 results (the q values are the same); a bf16
        # output must be the kernel's f32 result rounded, bit for bit
        q32 = q.float()
        out32 = out if vd == f32 else ckd_kernel.coded_kv_decode_cuda(
            q32, *banks, up32, seq32, vd)
        ref32 = coded_kv_decode_plain(q32, *banks, up32, seq32, vd)
        err = float((out32 - ref32).abs().max())
        check(torch.allclose(out32, ref32, rtol=F32_TOL, atol=F32_TOL)
              and bool(torch.isfinite(out32).all()),
              f"coded_kv_decode {name}: kernel differs from the plain "
              f"version by {err}")
        check(torch.equal(out32.to(vd), out),
              f"coded_kv_decode {name}: the {vd} output is not the f32 "
              "result rounded")
        check(not out[seq == 0].any(),
              f"coded_kv_decode {name}: seq_len 0 did not read zeros")
        extra = ""
        if name in ring:
            # the coded read gives back the logical cache
            mask = (torch.arange(k.shape[1], device="cuda")[None, :]
                    < seq[:, None])[:, None, None, None, :]
            logical = ly.mha(q32[:, None], k, v, mask)[:, 0]
            live = seq > 0
            check(torch.allclose(out32[live], logical[live], rtol=F32_TOL,
                                 atol=F32_TOL),
                  f"coded_kv_decode {name}: differs from mha over the ring "
                  "cache")
            extra = (f"; within rtol=atol={F32_TOL} of mha over the ring "
                     "cache")

        def run_kernel():
            ckd_kernel.coded_kv_decode_cuda(q, *banks, up32, seq32, vd)

        # the kernels of a call: the split kernel and the merge kernel,
        # counted as launch calls on the host (a trace can drop a kernel
        # record, never a launch call), and each kernel recorded one of
        # those
        n_launch, kernels = _kernels_of_a_call(torch, run_kernel)
        check(n_launch == 2 and len(kernels) <= 2
              and all(re.search(r"kv_decode_(tc|split|general|combine)"
                                r"_kernel", k) for k in kernels),
              f"coded_kv_decode {name}: a call made {n_launch} launch calls "
              f"and {len(kernels)} kernel records {kernels}, not the split "
              "kernel and the merge")
        big = name.startswith("large")
        reps = 20 if big else 100
        ms = time_cold(torch, run_kernel, reps, flush)
        plain_ms = time_on_card(torch, lambda: coded_kv_decode_plain(
            q, *banks, up32, seq32, vd), 5 if big else 20)
        # like for like with the library call: no degraded page, full length
        zero = torch.zeros_like(up32)
        full = torch.full_like(seq32, k.shape[1])
        ms_full = time_cold(torch, lambda: ckd_kernel.coded_kv_decode_cuda(
            q, *banks, zero, full, vd), reps, flush)
        qk = q.view(b, h // hkv, hkv, d).transpose(1, 2).reshape(
            b, h, 1, d)                      # head h % Hkv -> kv-major
        kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        lib_ms = time_cold(torch, lambda: F.scaled_dot_product_attention(
            qk, kt, vt, enable_gqa=True), reps, flush)
        lib = F.scaled_dot_product_attention(qk, kt, vt, enable_gqa=True)
        mine = ckd_kernel.coded_kv_decode_cuda(q, *banks, zero, full, vd)
        lib_err = float((lib.view(b, hkv, h // hkv, d).transpose(1, 2)
                         .reshape(b, h, d).float() - mine.float()).abs().max())
        n_bytes, ops = _decode_work(up32, seq32, nb, page, hkv, d, h,
                                    k.element_size(),
                                    q.numel() * q.element_size())
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_OPS[str(vd).split(".")[1]] * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        results[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=lib_ms,
                             max_abs_err=err, bytes=n_bytes, ms_full=ms_full,
                             registers=res.get("registers"), hmma=n_hmma,
                             spills=res.get("spill_stores"),
                             blocks_per_sm=blocks, splits=splits,
                             groups=groups)
        n_deg = int(up32.sum())
        print(f"kernel coded_kv_decode {name}: B={b} T={k.shape[1]} H={h} "
              f"Hkv={hkv} D={d} {str(vd).split('.')[1]} NB={nb} P={page}, "
              f"{n_deg}/{up32.numel()} pages degraded, seq_len "
              f"{seq32.tolist() if b <= 8 else 'full'}; within rtol=atol="
              f"{F32_TOL} of plain in f32 (max abs {err:.3g}), the "
              f"{str(vd).split('.')[1]} output that rounded{extra}; "
              f"{ms * 1e3:.2f} us/launch "
              f"(L2 flushed), bound {bound_ms * 1e3:.2f} us by {bound_by} "
              f"({n_bytes / 1e6:.2f} MB at 3.35 TB/s = "
              f"{bytes_ms * 1e3:.2f} us, {ops / 1e9:.3f} GFLOP = "
              f"{ops_ms * 1e3:.2f} us; {bound_ms / ms:.1%} of it); plain "
              f"{plain_ms:.3f} ms; at no degraded page and full length "
              f"{ms_full * 1e3:.2f} us vs SDPA (enable_gqa) "
              f"{lib_ms * 1e3:.2f} us (max abs diff {lib_err:.3g})")
    del flush, packed, cases, outs
    torch.cuda.empty_cache()
    return results, launches


# ---------------------------------------------------------------- phase 7
def _gather_columns(torch, gen, n, n_data, rows, n_par, prows, mix=True):
    """int32 request columns on ``gen``'s device. ``mix``: every mode (-1 .. 6),
    sibling -1 included, as degraded reads of real options would have
    them; otherwise all direct reads."""
    def rint(lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=gen.device,
                             dtype=torch.int32)

    bank, row = rint(0, n_data), rint(0, rows)
    if not mix:
        zero, neg = torch.zeros_like(bank), torch.full_like(bank, -1)
        return [bank, row, torch.ones_like(bank), zero, zero, neg, neg]
    sib0 = rint(-1, n_data)
    return [bank, row, rint(-1, 7), rint(0, n_par), rint(0, prows), sib0,
            torch.where(sib0 < 0, -1, rint(-1, n_data))]


def _gather_bytes(torch, cols, banks, pars, operand_bytes: int) -> int:
    """Bytes the gather must move: each needed row once (direct: its bank
    row; degraded: parity row and live siblings; redirect: parity row) on
    banks (n, L, W) and parities (n_par, Lp, W), the output, and
    ``operand_bytes`` of request operands (the columns or the plan)."""
    bank, row, mode, par, prow, sib0, sib1 = (c.long() for c in cols)
    nd, rows, w = banks.shape
    npar, prows = pars.shape[:2]
    row = row.clamp(0, rows - 1)
    opt = (mode >= 2) & (mode < 6)
    direct = (mode >= 0) & ~opt & (mode != 6)
    bank_ids = [(bank.clamp(0, nd - 1) * rows + row)[direct]]
    for s in (sib0, sib1):
        bank_ids.append((s.clamp(0, nd - 1) * rows + row)[opt & (s >= 0)])
    par_ids = (par.clamp(0, npar - 1) * prows
               + prow.clamp(0, prows - 1))[opt | (mode == 6)]
    n_rows = (int(torch.unique(torch.cat(bank_ids)).numel())
              + int(torch.unique(par_ids).numel()))
    row_bytes = w * banks.element_size()
    return (n_rows + mode.numel()) * row_bytes + operand_bytes


def _plan_operands(torch, gen, bits, B, nd, rows, npar, prows, w, n, mix,
                   tables, rs=16):
    """``gather_plan_cuda``'s operands at one shape: B points' banks (B,
    nd, rows[, w]) and parities of random lane bits (4-byte rows without a
    lane axis, as the simulator's state holds them), candidates on random
    banks and rows, and ``mix``: every mode (-1 .. 6; -1 unserved), random
    region slots and redirect holders; else every read served direct."""
    def rint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                             dtype=torch.int32)

    lanes = () if w == 1 else (w,)
    mode = rint(-1, 7, (B, n)) if mix else torch.ones(
        (B, n), dtype=torch.int32, device="cuda")
    return [bits(*(B, nd, rows) + lanes), bits(*(B, npar, prows) + lanes),
            rint(0, nd, (B, n)), rint(0, rows, (B, n)), mode, mode >= 0,
            rint(-1, prows // rs, (B, rows // rs)),
            rint(0, npar + 1, (B, nd, rows)), rs, rs, tables.opt_parity,
            tables.opt_sibs]


def time_on_host(torch, fn, n: int) -> float:
    """Mean wall ms per call of ``fn`` on the host clock, from the first
    call's start to the card's end of the last: what a host-bound caller
    pays for it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def sim_kernel_phase(torch):
    """Both simulator kernels at every shape, through the entries the main
    path calls (``gather_plan_cuda``, ``encode_regions_cuda``) and the
    column entries (``gather_decode_cuda``, ``encode_parities_cuda``),
    bit for bit against their plain versions, with their times, bounds and
    yardsticks; the eager plan bridge the fold removed is timed on the
    card as well."""
    from repro_torch.core import controller as ctl
    from repro_torch.core.codes import get_tables
    from repro_torch.kernels.xor_encode import kernel as ek
    from repro_torch.kernels.xor_encode.ref import (encode_parities_plain,
                                                    encode_regions_plain)
    from repro_torch.kernels.xor_gather import kernel as gk
    from repro_torch.kernels.xor_gather import ops as gops
    from repro_torch.kernels.xor_gather.ref import gather_decode_plain

    gen = torch.Generator(device="cuda").manual_seed(4321)
    i32 = torch.int32

    def bits(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                             device="cuda", dtype=i32)

    sch = get_tables("scheme_i")
    tables = ctl.jtables(sch, "cuda")                 # int64, as the path's
    pairs = torch.tensor([[2 * g, 2 * g + 1, -1] for g in range(4)],
                         dtype=i32, device="cuda")
    results = {}
    # name: (B, n_data, rows, n_par, prows, W, N a point, mixed modes,
    # launches timed); "batch13": the sweep phase's 13 points lock-step
    gather_shapes = {"sim": (1, 8, 320, 12, 320, 1, 80, True, 400),
                     "batch13": (13, 8, 320, 12, 80, 1, 80, True, 400),
                     "bench": (1, 8, 256, 4, 256, 256, 64, False, 400),
                     "large": (1, 8, 8192, 12, 2048, 1024, 16384, True, 40)}
    for shape, (B, nd, rows, npar, prows, w, n, mix, reps) in \
            gather_shapes.items():
        args = _plan_operands(torch, gen, bits, B, nd, rows, npar, prows, w,
                              n, mix, tables)
        out = gk.gather_plan_cuda(*args)
        torch.cuda.synchronize()
        ref = gops.gather_plan_plain(*args)
        check(torch.equal(out, ref),
              f"xor_gather {shape}: plan kernel differs from the plain "
              "version")
        cols = gops.gather_plan_columns(*args)
        banks = args[0].reshape(B * nd, rows, w)
        pars = args[1].reshape(B * npar, prows, w)
        col_out = gk.gather_decode_cuda(banks, pars, *cols)
        check(torch.equal(col_out, gather_decode_plain(banks, pars, *cols))
              and torch.equal(col_out.view(ref.shape), ref),
              f"xor_gather {shape}: column kernel differs from the plain "
              "version")
        err = int((out.long() - ref.long()).abs().max())
        ms = time_on_card(torch, lambda: gk.gather_plan_cuda(*args), reps)
        col_ms = time_on_card(torch, lambda: gk.gather_decode_cuda(
            banks, pars, *cols), reps)
        plain_ms = time_on_card(torch, lambda: gops.gather_plan_plain(*args),
                                max(reps // 10, 5))
        bridge_ms = time_on_card(torch, lambda: gops.gather_plan_columns(
            *args), max(reps // 10, 5))
        host = {"plan kernel": time_on_host(
                    torch, lambda: gk.gather_plan_cuda(*args), 200),
                "bridge + column kernel": time_on_host(
                    torch, lambda: gk.gather_decode_cuda(
                        banks, pars, *gops.gather_plan_columns(*args)), 50)}
        mode = cols.mode.long()
        parity_reads = int(((mode >= 2) & (mode <= 6)).sum())
        # the candidate, mode and served flag of each request, the slot
        # entry of each parity read and the holder of each redirect, the
        # code tables
        plan_bytes = (13 * B * n + 4 * parity_reads
                      + 4 * int((mode == 6).sum())
                      + (tables.opt_parity.numel()
                         + tables.opt_sibs.numel()) * 8)
        n_bytes = _gather_bytes(torch, cols, banks, pars, plan_bytes)
        lib_ms = None
        if not mix:        # direct reads only: one index_select of the rows
            flat = banks.view(B * nd * rows, w)
            idx = cols.bank.long() * rows + cols.row.long()
            check(torch.equal(torch.index_select(flat, 0, idx),
                              out.view(-1, w)),
                  f"xor_gather {shape}: index_select differs")
            lib_ms = time_on_card(torch, lambda: torch.index_select(
                flat, 0, idx), reps)
        results[("xor_gather", shape)] = _kernel_row(
            "xor_gather", shape, ms, plain_ms, n_bytes, lib_ms, err,
            f"B={B}: banks ({nd},{rows},{w}) + parities ({npar},{prows},{w}) "
            f"int32 a point = {B * (nd * rows + npar * prows) * w * 4 / 1e6:.1f}"
            f" MB, N={n} a point{' mixed modes' if mix else ' direct'}; "
            f"column entry {col_ms * 1e3:.2f} us/launch; the eager plan "
            f"bridge {bridge_ms * 1e3:.2f} us of card time a call; host ms "
            "a call: " + ", ".join(f"{k} {v:.4f}" for k, v in host.items()))
        del args, banks, pars, out, ref, col_out
    # regions: (B, n_data, rows, n_par, prows, launches timed), one
    # completing encode a point; whole banks: (n_data, rows, W, members,
    # launches timed)
    region_shapes = {"sim": (1, 8, 320, 12, 80, 400),
                     "batch13": (13, 8, 320, 12, 80, 400)}
    for shape, (B, nd, rows, npar, prows, reps) in region_shapes.items():
        rs = 16
        done = torch.tensor([(b, (3 * b + 1) % (rows // rs), b % (prows // rs),
                              rs) for b in range(B)], dtype=i32,
                            device="cuda")
        args = (bits(B, nd, rows), bits(B, npar, prows), tables.par_members,
                done, rs)
        out = ek.encode_regions_cuda(*args)
        torch.cuda.synchronize()
        ref = encode_regions_plain(*args)
        check(torch.equal(out, ref),
              f"xor_encode {shape}: region kernel differs from the plain "
              "version")
        err = int((out.long() - ref.long()).abs().max())
        ms = time_on_card(torch, lambda: ek.encode_regions_cuda(*args), reps)
        plain_ms = time_on_card(torch, lambda: encode_regions_plain(*args),
                                max(reps // 10, 5))
        # the region rows read and the slot rows written, the clone of the
        # parity state (read and written), the block and the member table
        n_bytes = (B * (nd + npar) * rs * 4 + 2 * args[1].numel() * 4
                   + done.numel() * 4 + tables.par_members.numel() * 8)
        results[("xor_encode", shape)] = _kernel_row(
            "xor_encode", shape, ms, plain_ms, n_bytes, None, err,
            f"B={B}: one region of {rs} rows a point from banks ({nd},{rows})"
            f" into {npar} parities ({prows} rows) of scheme_i, with the "
            "parity state's clone")
        del args, out, ref
    encode_shapes = {"bench": (8, 512, 256, "pairs", 400),
                     "large": (8, 8192, 1024, "pairs", 40),
                     "large_scheme_i": (8, 8192, 1024, "scheme_i", 20)}
    for shape, (nd, rows, w, mem, reps) in encode_shapes.items():
        banks = bits(nd, rows, w)
        members = pairs if mem == "pairs" else tables.par_members
        out = ek.encode_parities_cuda(banks, members)
        torch.cuda.synchronize()
        ref = encode_parities_plain(banks, members)
        check(torch.equal(out, ref),
              f"xor_encode {shape}: kernel differs from the plain version")
        err = int((out.long() - ref.long()).abs().max())
        ms = time_on_card(torch, lambda: ek.encode_parities_cuda(
            banks, members), reps)
        plain_ms = time_on_card(torch, lambda: encode_parities_plain(
            banks, members), max(reps // 10, 5))
        npar = members.shape[0]
        n_bytes = ((nd + npar) * rows * w * 4
                   + members.numel() * members.element_size())
        lib_ms = None
        if mem == "pairs":       # pairwise members: one strided XOR
            check(torch.equal(banks[0::2] ^ banks[1::2], out),
                  f"xor_encode {shape}: banks[0::2] ^ banks[1::2] differs")
            lib_ms = time_on_card(torch, lambda: banks[0::2] ^ banks[1::2],
                                  reps)
        results[("xor_encode", shape)] = _kernel_row(
            "xor_encode", shape, ms, plain_ms, n_bytes, lib_ms, err,
            f"banks ({nd},{rows},{w}) int32 = {nd * rows * w * 4 / 1e6:.1f} "
            f"MB, {npar} parities ({mem})")
        del banks, out, ref
    torch.cuda.empty_cache()
    return results


def _kernel_row(name, shape, ms, plain_ms, n_bytes, lib_ms, err, what):
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    lib = "n/a" if lib_ms is None else f"{lib_ms * 1e3:.2f} us"
    print(f"kernel {name} {shape}: bit-exact vs plain; {ms * 1e3:.2f} "
          f"us/launch, bound {bound_ms * 1e3:.3f} us ({n_bytes / 1e6:.4f} MB "
          f"at 3.35 TB/s, {bound_ms / ms:.1%} of it), plain "
          f"{plain_ms:.3f} ms, library {lib}; {what}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                library_ms=lib_ms, max_abs_err=err, bytes=n_bytes)


# ---------------------------------------------------------------- phase 8
class GoldenCheck:
    """``on_cycle`` hook: every read a cycle serves must return the golden
    (memory-order) value committed before that cycle. Counts on the
    device; ``result()`` reads them once. ``cycles`` (host) counts the
    cycles the hook saw."""

    def __init__(self):
        self.bad = self.served = 0      # device tensors after the first cycle
        self.cycles = 0

    def __call__(self, before, after, out):
        want = before.mem.golden[out.r_bank.long(),
                                 out.r_row.long().clamp(min=0)]
        self.bad = self.bad + ((out.r_value != want) & out.r_served).sum()
        self.served = self.served + out.r_served.sum()
        self.cycles += 1

    def result(self):
        return int(self.bad), int(self.served)


def _state_leaves(tree):
    """The leaves of a state (nested NamedTuples, the fault leaf's
    included), None kept, in field order."""
    if isinstance(tree, tuple):
        for x in tree:
            yield from _state_leaves(x)
    else:
        yield tree


def _map_state(fn, tree):
    """``tree`` (nested NamedTuples) with every non-None leaf ``x`` as
    ``fn(x)``."""
    if isinstance(tree, tuple):
        return type(tree)(*(_map_state(fn, x) for x in tree))
    return None if tree is None else fn(tree)


def _same_state(torch, a, b) -> bool:
    la, lb = list(_state_leaves(a)), list(_state_leaves(b))
    return len(la) == len(lb) and all(
        (x is None and y is None) or (
            x is not None and y is not None and x.dtype == y.dtype
            and torch.equal(x.cpu(), y.cpu()))
        for x, y in zip(la, lb))


# the golden model (repro_torch.oracle through repro_torch.sim.golden):
# phase -> points and cycles held against it, host seconds, notes
ORACLE_TALLY: dict = {}


def _tally(phase: str, points: int, cycles: int, secs: float,
           note: str = "") -> None:
    t = ORACLE_TALLY.setdefault(phase, {"points": 0, "cycles": 0, "s": 0.0,
                                        "notes": []})
    t["points"] += points
    t["cycles"] += cycles
    t["s"] += secs
    if note:
        t["notes"].append(note)


def hold_to_oracle(phase, label, state, res, twin, trace, n_cycles,
                   fault_plan=None, point: int = 0) -> None:
    """Point ``point`` of the card's final ``state`` (batched, or one
    point's) and its ``res`` against ``twin`` run over ``trace`` for the
    same ``n_cycles`` cycles on the host: every state field (the
    telemetry planes and the fault leaf included) and every result field
    equal, or the phase fails naming the fields. Outside every timed
    window."""
    from repro_torch.sim import golden

    t0 = time.perf_counter()
    bad = golden.check_run(state, res, twin, trace, n_cycles, fault_plan,
                           point)
    _tally(phase, 1, n_cycles, time.perf_counter() - t0)
    check(not bad, f"{phase} {label}: the card differs from the golden "
          f"model (repro_torch.oracle) in {bad}")


def hold_batches(phase: str, final: dict) -> int:
    """Every point of every batch in ``final`` (``FinalStates.final`` /
    ``SweepHook.final``: each batch's final card state) against its
    golden twin at the batch's padded allocation, with its fault plan,
    over the cycles its batch ran. Returns the points held."""
    from repro_torch.core.system import summarize_batch
    from repro_torch.sim import golden
    from repro_torch.sweep.workloads import build_trace

    n = 0
    for batch, st in final.values():
        twins = golden.batch_twins(batch.points)
        results = summarize_batch(st)
        cycles = int(st.mem.cycle[0])
        for k, (i, pt) in enumerate(zip(batch.indices, batch.points)):
            hold_to_oracle(
                phase, f"point {i} ({pt.scheme} alpha={pt.alpha} r={pt.r}"
                f"{' faults ' + str(pt.faults) if pt.faults else ''})", st,
                results[k], twins[k], build_trace(pt, index=i, device="cpu"),
                cycles, golden.fault_plan_of(pt, twins[k]), point=k)
            n += 1
    return n


def oracle_lines() -> list:
    """One line per phase: the points and cycles it held against the
    golden model and the host seconds that took."""
    return [f"golden model {phase}: {t['points']} points, {t['cycles']} "
            f"cycles held against repro_torch.oracle in {t['s']:.2f} s of "
            f"host time" + "".join(f"; {n}" for n in t["notes"])
            for phase, t in ORACLE_TALLY.items()]


def cycle_out_check(torch, tr_cpu, tr_card) -> str:
    """``GOLDEN_RUN`` stepped cycle by cycle on the card with its golden
    twin beside it, until the twin is quiescent: every ``CycleOut``
    (``r_served``, ``r_bank``, ``r_row``, ``r_value``, ``n_served``)
    equal to ``OracleMemorySystem.cycle``'s, one host read a cycle, then
    the final states. Outside every timed window."""
    import numpy as np

    from repro_torch.core.system import CycleOut, drain_bound
    from repro_torch.sim import golden

    t0 = time.perf_counter()
    sys_ = _stream_system("cuda", GOLDEN_RUN[0], SIM_TRACE["n_rows"],
                          GOLDEN_RUN[1], SIM_KW["r"],
                          SIM_KW["select_period"], SIM_TRACE["n_cores"])
    twin = golden.oracle_twin(sys_)
    st, ost = sys_.init(), twin.init_state()
    tr_np = golden.host_trace(tr_cpu)
    n = served = 0
    bound = drain_bound(*tr_np[0].shape)
    while not twin.quiescent(ost):
        check(n < bound, f"simulate cycle by cycle: the golden model did "
              f"not quiesce in {bound} cycles")
        st, out = sys_.cycle_fn(st, tr_card)
        oout = twin.cycle(ost, tr_np)
        host = torch.cat([x.reshape(-1).to(torch.int32) for x in out]).cpu()
        got = dict(zip(CycleOut._fields,
                       host.split([x.numel() for x in out])))
        bad = [f for f in CycleOut._fields
               if not np.array_equal(got[f].numpy().reshape(
                   np.shape(getattr(oout, f))),
                   np.asarray(getattr(oout, f)).astype(np.int32))]
        check(not bad, f"simulate {GOLDEN_RUN[0]} alpha={GOLDEN_RUN[1]} "
              f"cycle {n}: the card's CycleOut differs from the golden "
              f"model's in {bad}")
        served += int(oout.n_served)
        n += 1
    bad = golden.state_mismatches(st, ost)
    check(not bad, f"simulate {GOLDEN_RUN[0]} alpha={GOLDEN_RUN[1]} cycle "
          f"by cycle: the final state differs from the golden model's in "
          f"{bad}")
    check(n > 0 and served > 0, f"simulate cycle by cycle: {n} cycles "
          f"served {served} accesses")
    note = (f"{GOLDEN_RUN[0]} alpha={GOLDEN_RUN[1]} cycle by cycle: {n} "
            f"CycleOuts ({served} accesses) equal the oracle's")
    _tally("simulate", 0, n, time.perf_counter() - t0, note)
    return note


def simulate_phase(torch):
    from repro_torch.kernels.xor_encode import kernel as ek
    from repro_torch.kernels.xor_encode import ops as eops
    from repro_torch.kernels.xor_gather import kernel as gk
    from repro_torch.kernels.xor_gather import ops as gops
    from repro_torch.sim import ramulator, trace

    spec = trace.TraceSpec(**SIM_TRACE)
    traces = {dev: trace.banded_trace(spec, device=dev)
              for dev in ("cuda", "cpu")}
    n_cycles = ramulator.default_n_cycles(traces["cpu"])
    n_rows = SIM_TRACE["n_rows"]
    results, card_runs = {}, {}
    card_s = 0.0
    gk.launches = ek.launches = 0                   # main path starts here
    for scheme, alpha in SIM_RUNS:
        name = f"{scheme} alpha={alpha}"
        golden = GoldenCheck() if (scheme, alpha) == GOLDEN_RUN \
            else None
        calls = {}
        out = {}
        for dev in ("cuda", "cpu"):
            g0, e0, gc0, ec0 = gk.launches, ek.launches, gops.calls, \
                eops.calls
            if dev == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, st = ramulator.simulate(
                scheme, traces[dev], n_rows, alpha=alpha, device=dev,
                return_state=True, on_cycle=golden if dev == "cuda" else None,
                **SIM_KW)
            if dev == "cuda":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            calls[dev] = (gops.calls - gc0, eops.calls - ec0)
            launched = (gk.launches - g0, ek.launches - e0)
            if dev == "cuda":
                card_s += secs
                check(launched == calls[dev],
                      f"simulate {name}: launches {launched} != wrapper "
                      f"calls {calls[dev]} on the card")
            else:
                check(launched == (0, 0),
                      f"simulate {name}: CPU run launched {launched}")
            out[dev] = (res, st, secs)
        (res, st, secs), (res_c, st_c, secs_c) = out["cuda"], out["cpu"]
        check(calls["cuda"] == calls["cpu"],
              f"simulate {name}: card calls {calls['cuda']} vs CPU "
              f"{calls['cpu']}")
        check(res == res_c, f"simulate {name}: card {res} vs CPU {res_c}")
        check(_same_state(torch, st, st_c),
              f"simulate {name}: final state leaves differ card vs CPU")
        check(res.completed, f"simulate {name}: the workload did not drain")
        check(calls["cuda"][1] == res.switches,
              f"simulate {name}: {calls['cuda'][1]} region encodes for "
              f"{res.switches} switches")
        if alpha < 1:
            check(calls["cuda"][1] >= 1,
                  f"simulate {name}: xor_encode never launched")
        extra = ""
        if golden is not None:
            bad, served = golden.result()
            check(golden.cycles == n_cycles,
                  f"simulate {name}: the golden hook saw {golden.cycles} of "
                  f"{n_cycles} cycles")
            check(bad == 0 and served == res.served_reads,
                  f"simulate {name}: {bad} of {served} served reads did "
                  "not return the committed value")
            extra = f"; all {served} served reads returned committed values"
        results[(scheme, alpha)] = res
        card_runs[(scheme, alpha)] = (res, st)
        print(f"simulate {name}: {res.cycles} cycles to drain, "
              f"{res.served_reads} reads ({res.degraded_reads} degraded) + "
              f"{res.served_writes} writes ({res.parked_writes} parked), "
              f"{res.switches} switches, stalls {res.stall_cycles}, avg read "
              f"latency {res.avg_read_latency:.3f}; {n_cycles} cycles run: "
              f"card {secs:.2f} s = {secs / n_cycles * 1e3:.3f} ms/cycle "
              f"({n_cycles / secs:.0f} cycles/s), CPU {secs_c:.2f} s = "
              f"{secs_c / n_cycles * 1e3:.3f} ms/cycle; launches xor_gather "
              f"{calls['cuda'][0]}, xor_encode {calls['cuda'][1]}; card = CPU "
              f"in every field and leaf{extra}")
    launches = {"xor_gather": gk.launches, "xor_encode": ek.launches}
    # main path ends here
    check(results[("scheme_i", 1.0)].cycles < results[("uncoded", 1.0)].cycles,
          "scheme_i at alpha 1 did not beat uncoded")
    check(all(v > 0 for v in launches.values()),
          f"simulate: a kernel of the path never launched: {launches}")
    total = n_cycles * len(SIM_RUNS)
    print(f"simulate: {len(SIM_RUNS)} card runs, {total} cycles in "
          f"{card_s:.1f} s = {card_s / total * 1e3:.3f} ms/cycle, "
          f"{total / card_s:.0f} simulated cycles/s; launches {launches}")
    # the golden model, outside the counts and the timed runs: each card
    # run's final state and result, then GOLDEN_RUN cycle by cycle
    from repro_torch.sim import golden
    t0 = time.perf_counter()
    for (scheme, alpha), (res, st) in card_runs.items():
        twin = golden.oracle_twin(_stream_system(
            "cpu", scheme, n_rows, alpha, SIM_KW["r"],
            SIM_KW["select_period"], SIM_TRACE["n_cores"]))
        hold_to_oracle("simulate", f"{scheme} alpha={alpha}", st, res, twin,
                       traces["cpu"], n_cycles)
    print(f"simulate: the {len(card_runs)} card runs' final states and "
          f"results = the golden model's over their {n_cycles} cycles "
          f"({time.perf_counter() - t0:.2f} s of host time); "
          f"{cycle_out_check(torch, traces['cpu'], traces['cuda'])}")
    busy_ms = profile_sim(torch, traces["cuda"])
    return launches, results, total / card_s, busy_ms


def profile_sim(torch, tr, n: int = 40) -> float:
    """Where a simulated cycle's time goes, in two windows of ``n`` cycles
    of scheme_i at alpha 0.25: a busy one (from cycle 20, queues loaded)
    and a drained one (from cycle 600; ~90% of a run's 1216 cycles come
    after the workload drains). Each is timed on the host clock without
    the profiler, then under torch.profiler for device busy time, kernel
    launches and copies per cycle. Then the cost of the off-duty branch,
    which running both branches every cycle would add. Returns the busy
    window's wall ms a cycle."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.codes import get_tables
    from repro_torch.core.state import (batch_of_one, make_params,
                                        make_tunables)
    from repro_torch.core.system import CodedMemorySystem

    tables = get_tables(GOLDEN_RUN[0])
    p = make_params(tables, SIM_TRACE["n_rows"], GOLDEN_RUN[1],
                    SIM_KW["r"])
    sys_ = CodedMemorySystem(tables, p, n_cores=SIM_TRACE["n_cores"],
                             tunables=make_tunables(
                                 select_period=SIM_KW["select_period"]),
                             device="cuda")
    st, done = sys_.init(), 0
    for window, start in (("busy", 20), ("drained", 600)):
        st, _ = sys_._run(st, tr, start - done)
        done = start + n
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sys_._run(st, tr, n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
        if window == "busy":
            busy_wall_ms = wall_ms
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            st, _ = sys_._run(st, tr, n)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3 / n
        path = ROOT / "build" / f"chip_smoke_sim_{window}_trace.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        busy = [e for e in events if e.get("ph") == "X" and e.get("cat") in
                ("kernel", "gpu_memcpy", "gpu_memset")]
        if not busy:
            print(f"profile simulate {window}: the trace holds no device "
                  "activity; device busy share not measured")
            continue
        busy_ms = sum(e["dur"] for e in busy) / 1e3 / n
        kernels = [e for e in busy if e["cat"] == "kernel"]
        copies = sum(e["cat"] == "gpu_memcpy" for e in busy) / n
        ours = {k: sum(e["dur"] for e in kernels if k in e["name"]) / 1e3 / n
                for k in ("xor_gather", "xor_encode")}
        print(f"profile simulate {window} cycles {start}..{start + n} of "
              f"{GOLDEN_RUN[0]} alpha={GOLDEN_RUN[1]}: wall {wall_ms:.3f} "
              f"ms/cycle ({prof_ms:.3f} under the profiler), device busy "
              f"{busy_ms:.3f} ms/cycle (idle {1 - busy_ms / wall_ms:.1%} of "
              f"the unprofiled wall), {len(kernels) / n:.0f} kernel launches "
              f"and {copies:.1f} copies per cycle; xor_gather "
              f"{ours['xor_gather']:.4f} ms/cycle, xor_encode "
              f"{ours['xor_encode']:.4f} ms/cycle")
    # what running both branches every cycle (the JAX program's choice,
    # for vmap) would add: the off-duty branch on masked-invalid candidates
    m = batch_of_one(st.mem)
    off = {"read": m._replace(rq_valid=torch.zeros_like(m.rq_valid)),
           "write": m._replace(wq_valid=torch.zeros_like(m.wq_valid))}
    off_ms = {}
    for side, fn in (("read", sys_._do_reads), ("write", sys_._do_writes)):
        fn(off[side], sys_.p.region_size)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(off[side], sys_.p.region_size)
        torch.cuda.synchronize()
        off_ms[side] = (time.perf_counter() - t0) * 1e3 / n
    print(f"profile simulate: an off-duty branch on masked candidates costs "
          f"{off_ms['read']:.3f} ms (read side) / {off_ms['write']:.3f} ms "
          f"(write side) per call on the host clock; running both branches "
          f"every cycle would add that to each cycle")
    return busy_wall_ms


# ---------------------------------------------------------------- phase 9
# benchmarks/bench_stream.py:39-49: 8 cores x 2,048 requests of the seeded
# banded trace, 8 banks x 512 rows, scheme_i, alpha 0.25, r 0.05, select
# period 256, streamed at chunk 256
STREAM_TRACE = dict(n_cores=8, length=2048, n_banks=8, n_rows=512, seed=0)
STREAM_POINT = dict(scheme="scheme_i", alpha=0.25, r=0.05, select_period=256)
STREAM_CHUNK = 256
SIM_STREAM_CHUNKS = (32, 96)     # the simulate phase's trace, streamed
STREAM_HEAD = 512                # (d) and the sweep's (c): requests a
                                 # core of the trace's head replayed
STREAM_A_LENGTH = 1024           # (a): requests a core replayed (of 2,048)
# tests/data fixtures, dealt over 2 cores onto 8 banks x 64 rows
FILE_TRACES = (("tiny_ramulator.trace", {}),
               ("tiny_gem5.gem5", {"line_bytes": 64}))
FILE_GEOMETRY = dict(n_cores=2, n_banks=8, n_rows=64)


def stream_head(tr):
    """The first ``STREAM_HEAD`` requests a core of the trace ``tr``."""
    return type(tr)(*(x[:, :STREAM_HEAD].contiguous() for x in tr))


def _stream_system(dev, scheme, n_rows, alpha, r, select_period, n_cores):
    """A system as ``simulate`` builds one, on ``dev``."""
    from repro_torch.core.codes import get_tables
    from repro_torch.core.state import make_params, make_tunables
    from repro_torch.core.system import CodedMemorySystem

    tables = get_tables(scheme)
    return CodedMemorySystem(
        tables, make_params(tables, n_rows=n_rows, alpha=alpha, r=r),
        n_cores=n_cores, tunables=make_tunables(select_period=select_period),
        device=dev)


def _streamed(torch, sys_, source, chunk_len, label, **kw):
    """One ``stream_replay`` on ``sys_``'s device: (SimResult, final state,
    seconds, (xor_gather, xor_encode) wrapper calls). On the card each
    kernel's launches must equal its wrapper's calls, on the CPU be 0.
    ``kw`` goes to ``stream_replay`` (``on_cycle``, ``region_priors``)."""
    from repro_torch.kernels.xor_encode import kernel as ek
    from repro_torch.kernels.xor_encode import ops as eops
    from repro_torch.kernels.xor_gather import kernel as gk
    from repro_torch.kernels.xor_gather import ops as gops
    from repro_torch.traces import stream_replay

    card = sys_.device.type == "cuda"
    g0, e0, gc0, ec0 = gk.launches, ek.launches, gops.calls, eops.calls
    if card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, st = stream_replay(sys_, source, chunk_len=chunk_len,
                            return_state=True, **kw)
    if card:
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    calls = (gops.calls - gc0, eops.calls - ec0)
    launched = (gk.launches - g0, ek.launches - e0)
    check(launched == (calls if card else (0, 0)),
          f"stream {label} on {sys_.device.type}: launches {launched}, "
          f"wrapper calls {calls}")
    return res, st, secs, calls


class CycleSampler:
    """``on_cycle`` hook: keeps the state before every ``every``-th cycle
    (from cycle ``every // 2``). A cycle builds new state tensors, so this
    holds references: no copy, no host read."""

    def __init__(self, every: int):
        self.every, self.n, self.states = every, 0, []

    def __call__(self, before, after, out):
        if self.n % self.every == self.every // 2:
            self.states.append(before)
        self.n += 1


def check_live_kernels(torch, sys_, tn, states, label) -> str:
    """Both sim kernels bit for bit against their plain versions on live
    card states of a run (batched states of B points, ``tn`` their batched
    tunables), at the run's own geometry: ``xor_gather`` fed each state's
    read plans as the controller builds them from its queues (the path's
    entry, ``gather_plan_cuda``) and, through the column entry, seeded
    columns of every mode at the plans' length on the banks viewed
    (B·n_data, L, 1); ``xor_encode`` through the path's entry
    (``encode_regions_cuda``) on every region of every point's banks, one
    call a region for the batch, each point into a slot of its own at its
    own region size, and through ``encode_parities_cuda`` on the points'
    whole banks. Called after the path's launches are read: these
    launches count nowhere."""
    from repro_torch.core import controller as ctl
    from repro_torch.core.state import active_geometry
    from repro_torch.kernels.xor_encode import kernel as ek
    from repro_torch.kernels.xor_encode.ref import (encode_parities_plain,
                                                    encode_regions_plain)
    from repro_torch.kernels.xor_gather import kernel as gk
    from repro_torch.kernels.xor_gather import ops as gops
    from repro_torch.kernels.xor_gather.ref import gather_decode_plain

    check(len(states) > 0, f"{label}: no live state was sampled")
    p, t, dev = sys_.p, sys_.t, sys_.device
    rs = p.region_size
    rs_a, _ = active_geometry(p, tn)
    gen = torch.Generator(device=dev).manual_seed(99)
    modes = torch.zeros(8, dtype=torch.long, device=dev)      # -1 .. 6
    n_gather = n_encode = 0
    for st in states:
        m = st.mem
        B = m.cycle.shape[0]
        cb = sys_._bank_ids.expand(B, -1)
        ci = m.rq_row.flatten(1)
        plan = ctl.build_read_patterns(
            p, t, cb, ci, m.rq_age.flatten(1), m.rq_valid.flatten(1),
            sys_._idle_ports(B), m.fresh_loc, m.parity_valid, m.region_slot,
            rs_a)
        args = (m.banks_data, m.parity_data, cb, ci, plan.mode, plan.served,
                m.region_slot, m.fresh_loc, rs_a, rs, t.opt_parity,
                t.opt_sibs)
        check(torch.equal(gk.gather_plan_cuda(*args),
                          gops.gather_plan_plain(*args)),
              f"{label}: xor_gather (the plan) differs from its plain "
              f"version on a live state at cycle {m.cycle.tolist()}")
        real = gops.gather_plan_columns(*args)
        banks = m.banks_data[..., None].flatten(0, 1)
        pars = m.parity_data[..., None].flatten(0, 1)
        seeded = _gather_columns(torch, gen, ci.numel(), banks.shape[0],
                                 p.n_rows, pars.shape[0], pars.shape[1])
        check(torch.equal(gk.gather_decode_cuda(banks, pars, *seeded),
                          gather_decode_plain(banks, pars, *seeded)),
              f"{label}: xor_gather (seeded columns) differs from its plain "
              f"version on a live state at cycle {m.cycle.tolist()}")
        n_gather += 2
        modes += torch.bincount(real.mode.long() + 1, minlength=8)
        rs_pts = (rs_a.tolist() if isinstance(rs_a, torch.Tensor)
                  else [rs_a] * B)
        n_slots = m.parity_data.shape[2] // rs
        for region in range(p.n_regions):
            done = torch.tensor([(b, region, (region + b) % n_slots,
                                  rs_pts[b]) for b in range(B)],
                                dtype=torch.int32, device=dev)
            enc = (m.banks_data, m.parity_data, t.par_members, done, rs)
            check(torch.equal(ek.encode_regions_cuda(*enc),
                              encode_regions_plain(*enc)),
                  f"{label}: xor_encode differs from its plain version on "
                  f"region {region} at cycle {m.cycle.tolist()}")
            n_encode += 1
        whole = m.banks_data[..., None]
        check(torch.equal(ek.encode_parities_cuda(whole, t.par_members),
                          encode_parities_plain(whole, t.par_members)),
              f"{label}: xor_encode differs from its plain version on the "
              f"whole banks at cycle {m.cycle.tolist()}")
        n_encode += 1
    modes = modes.tolist()
    check(sum(modes[1:]) > 0, f"{label}: the sampled read plans serve "
          "nothing")
    return (f"xor_gather and xor_encode bit-exact vs plain on {len(states)} "
            f"live card states ({n_gather} gathers at N={ci.numel()}, banks "
            f"{tuple(m.banks_data.shape)}, parities "
            f"{tuple(m.parity_data.shape)}: real plans with "
            f"{modes[1] + modes[2]} direct, {sum(modes[3:7])} degraded, "
            f"{modes[7]} redirected reads through the plan entry, and seeded "
            f"columns of every mode through the column entry; {n_encode} "
            "encodes: every region of every point into its slot, and the "
            "whole banks)")


def stream_phase(torch, sim_single):
    """Streamed trace replay on the card against the CPU: (a) bench_stream's
    workload on its first ``STREAM_A_LENGTH`` requests a core, (b) the simulate phase's trace streamed at
    chunks 32 and 96 against its single-shot result ``sim_single``, (c)
    the file fixtures through ``load_trace`` and ``stream_file``, (d)
    region priors from the trace's profile. Returns each sim kernel's
    launches over the phase and (d)'s cold card replay of the trace's
    head."""
    from repro_torch.core.state import batch_of_one
    from repro_torch.core.system import Trace, drain_bound
    from repro_torch.kernels.xor_encode import kernel as ek
    from repro_torch.kernels.xor_gather import kernel as gk
    from repro_torch.sim import trace
    from repro_torch.traces import (load_trace, profile_trace, stream_file,
                                    strip_windows)

    gk.launches = ek.launches = 0                   # main path starts here
    # (a) the first STREAM_A_LENGTH requests a core of the full trace
    tr_full = trace.banded_trace(trace.TraceSpec(**STREAM_TRACE),
                                 device="cpu")
    tr_cpu = Trace(*(x[:, :STREAM_A_LENGTH].contiguous() for x in tr_full))
    traces = {"cpu": tr_cpu, "cuda": Trace(*(x.to("cuda") for x in tr_cpu))}
    n_req = int(tr_cpu.valid.sum())
    nc, n_rows = STREAM_TRACE["n_cores"], STREAM_TRACE["n_rows"]
    length = STREAM_A_LENGTH
    bound = drain_bound(nc, length)
    point = (STREAM_POINT["scheme"], n_rows, STREAM_POINT["alpha"],
             STREAM_POINT["r"], STREAM_POINT["select_period"], nc)
    golden, sampler = GoldenCheck(), CycleSampler(50)

    def card_hooks(before, after, out):
        golden(before, after, out)
        sampler(before, after, out)

    systems = {dev: _stream_system(dev, *point) for dev in ("cuda", "cpu")}
    out = {dev: _streamed(torch, systems[dev], traces[dev], STREAM_CHUNK,
                          "(a)", on_cycle=card_hooks if dev == "cuda"
                          else None)
           for dev in ("cuda", "cpu")}
    (res, st, secs, calls), (res_c, st_c, secs_c, calls_c) = \
        out["cuda"], out["cpu"]
    check(res == res_c, f"stream (a): card {res} vs CPU {res_c}")
    check(_same_state(torch, st, st_c),
          "stream (a): final state leaves differ card vs CPU")
    check(calls == calls_c, f"stream (a): card calls {calls} vs CPU "
          f"{calls_c}")
    check(res.completed and res.served_reads + res.served_writes == n_req,
          f"stream (a): {res} did not serve all {n_req} requests")
    check(calls[1] == res.switches and calls[1] >= 1,
          f"stream (a): {calls[1]} region encodes for {res.switches} "
          "switches")
    bad, served = golden.result()
    cycles = int(st.mem.cycle)
    check(golden.cycles == cycles, f"stream (a): the golden hook saw "
          f"{golden.cycles} of {cycles} cycles")
    check(bad == 0 and served == res.served_reads,
          f"stream (a): {bad} of {served} served reads did not return the "
          "committed value")
    check(cycles < bound, f"stream (a): {cycles} cycles, bound {bound}")
    print(f"stream (a) bench_stream's workload, its first {length} "
          f"requests a core ({n_req} requests, 8 x 512, "
          f"{point[0]} alpha={point[2]} r={point[3]} select {point[4]}) at "
          f"chunk {STREAM_CHUNK}: {cycles} cycles run against drain_bound "
          f"{bound} ({cycles / bound:.1%}), drained at cycle {res.cycles}, "
          f"{len(res.window_read_latency)} windows, {res.switches} switches,"
          f" stalls {res.stall_cycles}; card {secs:.2f} s = "
          f"{secs / cycles * 1e3:.3f} ms/cycle, {n_req / secs:.0f} "
          f"requests/s (served reads checked each cycle); CPU {secs_c:.2f} "
          f"s = {secs_c / cycles * 1e3:.3f} ms/cycle, {n_req / secs_c:.0f} "
          f"requests/s; launches xor_gather {calls[0]}, xor_encode "
          f"{calls[1]}; card = CPU in every field (windows included) and "
          f"leaf; all {served} served reads returned committed values")
    # (b) the simulate phase's trace, streamed, against its single shot
    sim_tr = trace.banded_trace(trace.TraceSpec(**SIM_TRACE), device="cuda")
    sim_point = (GOLDEN_RUN[0], SIM_TRACE["n_rows"], GOLDEN_RUN[1],
                 SIM_KW["r"], SIM_KW["select_period"], SIM_TRACE["n_cores"])
    for chunk in SIM_STREAM_CHUNKS:
        r_b, st_b, secs_b, _ = _streamed(
            torch, _stream_system("cuda", *sim_point), sim_tr, chunk,
            f"(b) chunk {chunk}")
        check(strip_windows(r_b) == sim_single,
              f"stream (b) chunk {chunk}: {r_b} vs single shot "
              f"{sim_single}")
        print(f"stream (b) {GOLDEN_RUN[0]} alpha={GOLDEN_RUN[1]} on the "
              f"simulate phase's trace at chunk {chunk}: equals the single "
              f"shot; {int(st_b.mem.cycle)} cycles run against its "
              f"{drain_bound(SIM_TRACE['n_cores'], SIM_TRACE['length'])}, "
              f"{len(r_b.window_read_latency)} windows, {secs_b:.2f} s")
    # (c) the file fixtures
    for name, kw in FILE_TRACES:
        path = str(ROOT / "tests" / "data" / name)
        got = {}
        for dev in ("cuda", "cpu"):
            sys_ = _stream_system(dev, "scheme_i", FILE_GEOMETRY["n_rows"],
                                  0.25, 0.125, 8, FILE_GEOMETRY["n_cores"])
            whole = load_trace(path, device=dev, **FILE_GEOMETRY, **kw)
            got[dev] = tuple(_streamed(torch, sys_, src, 2, f"(c) {name}")[0]
                             for src in (whole, stream_file(
                                 path, 2, **FILE_GEOMETRY, **kw)))
            single = sys_.run(whole, drain_bound(*whole.bank.shape))
            check(all(strip_windows(r) == single for r in got[dev]),
                  f"stream (c) {name} on {dev}: {got[dev]} vs single shot "
                  f"{single}")
        check(got["cuda"] == got["cpu"],
              f"stream (c) {name}: card {got['cuda']} vs CPU {got['cpu']}")
        print(f"stream (c) {name}: load_trace and stream_file replay alike "
              f"on the card and the CPU and equal the single shot: "
              f"{got['cuda'][0].served_reads} reads + "
              f"{got['cuda'][0].served_writes} writes in "
              f"{got['cuda'][0].cycles} cycles")
    # (d) region priors from the whole trace's profile, replayed over its
    # first STREAM_HEAD requests a core, beside that head replayed cold
    prof = profile_trace(tr_full, STREAM_TRACE["n_banks"], n_rows,
                         window=512)
    heads = {dev: stream_head(traces[dev]) for dev in traces}
    primed = {}
    for dev in ("cuda", "cpu"):
        sys_ = _stream_system(dev, *point)
        p = sys_.p
        pri = prof.region_priors(p.region_size, p.n_regions, k=p.n_slots)
        primed[dev] = (sys_.init(region_priors=pri),) + _streamed(
            torch, sys_, heads[dev], STREAM_CHUNK, "(d)", region_priors=pri)
    (init, r_d, st_d, secs_d, calls_d), (init_c, r_dc, st_dc, _, _) = \
        primed["cuda"], primed["cpu"]
    cold = _streamed(torch, _stream_system("cuda", *point), heads["cuda"],
                     STREAM_CHUNK, "(d) cold")[0]
    check(_same_state(torch, init, init_c),
          "stream (d): primed init state differs card vs CPU")
    check(r_d == r_dc and _same_state(torch, st_d, st_dc),
          f"stream (d): card {r_d} vs CPU {r_dc}")
    check(r_d.completed and cold.completed,
          f"stream (d): primed {r_d} or cold {cold} did not complete")
    print(f"stream (d) region priors {pri.tolist()} from a profile with "
          f"bands {[(b.row_lo, b.row_hi) for b in prof.bands()]}: primed "
          f"init state and replay of the first {STREAM_HEAD} requests a "
          f"core equal card vs CPU; drained at cycle {r_d.cycles} (cold "
          f"{cold.cycles}), {r_d.switches} switches (cold {cold.switches}),"
          f" stalls {r_d.stall_cycles} (cold {cold.stall_cycles}), "
          f"{int(st_d.mem.cycle)} cycles run in "
          f"{secs_d:.2f} s = {secs_d / int(st_d.mem.cycle) * 1e3:.3f} "
          f"ms/cycle; launches xor_gather {calls_d[0]}, xor_encode "
          f"{calls_d[1]}")
    launches = {"xor_gather": gk.launches, "xor_encode": ek.launches}
    # main path ends here
    check(all(v > 0 for v in launches.values()),
          f"stream: a kernel of the path never launched: {launches}")
    # (a) against the golden model over the same requests, outside the
    # counts: the oracle has no notion of chunks and stops at quiescence,
    # as streamed replay's early exit does
    from repro_torch.sim import golden
    t0 = time.perf_counter()
    twin = golden.oracle_twin(systems["cpu"])
    ost = twin.run(golden.host_trace(tr_cpu), bound,
                   stop_when_quiescent=True)
    bad = golden.result_mismatches(res, twin.result(ost))
    _tally("stream", 1, ost.cycle, time.perf_counter() - t0)
    check(not bad,
          f"stream (a): the card's streamed result differs from the golden "
          f"model's in {bad}: {res} vs {twin.result(ost)}")
    print(f"stream (a) = the golden model's run over the same {n_req} "
          f"requests ({ost.cycle} cycles to quiescence) in every field, the "
          f"windows aside ({ORACLE_TALLY['stream']['s']:.2f} s of host "
          "time)")
    live = check_live_kernels(
        torch, systems["cuda"], systems["cuda"].batch_tunables(),
        [batch_of_one(st_) for st_ in sampler.states], "stream (a)")
    print(f"stream (a) kernels: {live}")
    profile_stream(torch, traces["cuda"], st, point)
    return launches, cold


def profile_stream(torch, tr, drained, point, n: int = 40) -> None:
    """Where a streamed cycle's time goes: ``n`` cycles of ``run_chunk``
    with the queues loaded (from cycle 20 of the first chunk), and ``n``
    drained cycles from (a)'s final state through the single-shot loop,
    which has no early exit: what each cycle past quiescence would cost.
    Each window is timed on the host clock, then under torch.profiler for
    device busy time, kernel launches, host syncs and copies per cycle."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.state import INT32_MAX
    from repro_torch.core.system import Trace

    sys_ = _stream_system("cuda", *point)
    chunk = Trace(*(x[:, :STREAM_CHUNK].contiguous() for x in tr))
    se = torch.full((sys_.n_cores,), INT32_MAX, dtype=torch.int32,
                    device="cuda")
    busy = sys_.run_chunk(sys_.init(), chunk, se, 20)
    drained = drained._replace(core_ptr=torch.full_like(drained.core_ptr,
                                                        STREAM_CHUNK))
    windows = {"busy": (busy, lambda st: sys_.run_chunk(st, chunk, se, n)),
               "drained": (drained, lambda st: sys_._run(st, chunk, n)[0])}
    for window, (st, fn) in windows.items():
        c0 = int(st.mem.cycle)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = fn(st)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
        check(int(st.mem.cycle) == c0 + n,
              f"profile stream {window}: {int(st.mem.cycle) - c0} of {n} "
              "cycles ran")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(st)
            torch.cuda.synchronize()
        path = ROOT / "build" / f"chip_smoke_stream_{window}_trace.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in
               ("kernel", "gpu_memcpy", "gpu_memset")]
        runtime = [e["name"] for e in events
                   if e.get("cat") == "cuda_runtime"]
        syncs = sum("Synchronize" in e for e in runtime) / n
        copies = sum("Memcpy" in e for e in runtime) / n
        if not dev:
            print(f"profile stream {window}: the trace holds no device "
                  "activity; device busy share not measured")
            continue
        busy_ms = sum(e["dur"] for e in dev) / 1e3 / n
        kernels = sum(e["cat"] == "kernel" for e in dev) / n
        print(f"profile stream {window} cycles {c0 + n}..{c0 + 2 * n}: wall "
              f"{wall_ms:.3f} ms/cycle, device busy {busy_ms:.3f} ms/cycle "
              f"(idle {1 - busy_ms / wall_ms:.1%} of the unprofiled wall), "
              f"{kernels:.0f} kernel launches, {syncs:.1f} host syncs and "
              f"{copies:.1f} copies per cycle")


# --------------------------------------------------------------- phase 10
# paper_fig19's grid at the figures' geometry (benchmarks/fig19_split.py:
# 13-17, src/repro/sweep/workloads.py:158-167): the split-band trace with 8
# bands, 8 banks x 320 rows, queue depth 10, 8 cores x 96 requests, seed 0,
# write fraction 0.3, select period 64; uncoded, then scheme_i over r x alpha
FIG19_BASE = dict(scheme="scheme_i", trace="split",
                  trace_kwargs=(("n_bands", 8),), n_rows=320, n_banks=8,
                  n_cores=8, length=96, seed=0, write_frac=0.3,
                  select_period=64)
FIG19_AXES = dict(r=(0.05, 0.125, 0.25), alpha=(0.1, 0.25, 0.5, 1.0))
FIG19_GOLDEN = dict(alpha=0.25, r=0.05)
SEED_AXIS = 8                    # (b): the simulate phase's golden run
PROFILE_BATCHES = (1, 8)         # seed-axis batch sizes profiled
STREAM_ALPHAS = (0.1, 0.25, 0.5, 1.0)
SWEEP_STREAM_CHUNK = 64          # (c): 8 chunks of the head
CKPT_EVERY = 2                   # (c): chunks between checkpoints
CKPT_STOP = 400                  # (c): the killed pass stops past this cycle
LIVE_EVERY = 50                  # (d): batched cycles of (a), (b) between
STREAM_LIVE_EVERY = 100          # live checks, and of (c)
SHARDS = 2                       # (e): shards of the point axis, on cuda:0
SHARD_HEAD = 48                  # (e): requests a core streamed (of 96)
SHARD_CHUNK = 16                 # (e): the streamed alpha 1 batch's chunk
SHARD_CKPT_STOP = 30             # (e): the killed 2-shard pass stops past it


def fig19_points():
    from repro_torch.sweep import SweepPoint, grid

    base = SweepPoint(**FIG19_BASE)
    return ([base.replace(scheme="uncoded", alpha=1.0, r=0.05)]
            + grid(base, **FIG19_AXES))


def seed_points(n: int):
    """(b)'s points: the simulate phase's scheme_i alpha 0.25 run (its
    banded trace, r 0.05, select period 32) at seeds 0 .. n - 1."""
    from repro_torch.sweep import SweepPoint

    return [SweepPoint(scheme=GOLDEN_RUN[0], alpha=GOLDEN_RUN[1],
                       trace="banded", **SIM_KW, **SIM_TRACE).replace(seed=s)
            for s in range(n)]


def stream_points():
    """(c)'s points: bench_stream's workload (``STREAM_TRACE``, select
    period 256, r 0.05) at each of ``STREAM_ALPHAS``."""
    return [seed_points(1)[0].replace(
        alpha=a, select_period=STREAM_POINT["select_period"],
        **{k: STREAM_TRACE[k] for k in ("n_cores", "length", "n_banks",
                                        "n_rows")}) for a in STREAM_ALPHAS]


class FinalStates:
    """``run_points``' ``on_cycle(batch, before, after, out)``: keeps each
    batch's latest state after a cycle (its final state once the run is
    over; a reference, no copy)."""

    def __init__(self):
        self.final = {}

    def __call__(self, batch, before, after, out):
        self.final[tuple(batch.indices)] = (batch, after)


def per_point(final: dict, n: int):
    """Each point's SimResult and final state, by point index, from the
    batches' final states (``FinalStates.final`` / ``SweepHook.final``)."""
    from repro_torch.core.state import point_of
    from repro_torch.core.system import summarize_batch

    res, states = [None] * n, [None] * n
    for batch, st in final.values():
        for k, (i, r) in enumerate(zip(batch.indices, summarize_batch(st))):
            res[i], states[i] = r, point_of(st, k)
    return res, states


@contextlib.contextmanager
def quiet_harness():
    """A harness or report run on the worker's CPU side: its printed table
    dropped and its artefacts, with a stub manifest, written to a
    temporary directory (yielded; the card's runs write
    ``experiments/torch/``)."""
    import shutil
    import tempfile

    from repro_torch.harness import common

    from repro_torch.obs import runlog

    tmp = tempfile.mkdtemp(prefix="chip_smoke_harness_")
    saved = common.ART_DIR, runlog.run_manifest
    # the artefact's manifest asks git, nvidia-smi and the card: not here
    common.ART_DIR = tmp
    runlog.run_manifest = lambda **kw: {
        "git_sha": "cpu-worker", "created_iso": "",
        "devices": {"backend": "cpu"}}
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            yield tmp
    finally:
        common.ART_DIR, runlog.run_manifest = saved
        shutil.rmtree(tmp, ignore_errors=True)


def sweep_cpu_side() -> dict:
    """The sweep phase's CPU side for (a) and (b): (a) the Fig 19 harness
    (its rows, each point's result and final state as numpy leaves,
    seconds, wrapper calls), (b) ``run_points`` (the same but rows). It
    runs in a worker process started with the script (``CpuSide``) while
    the card does untimed work: the card's loop is
    host-bound, so this CPU work would otherwise add to the script's wall
    time. Its seconds are the worker's CPU time (``time.process_time``,
    over its 2 threads): its wall clock runs on while it is stopped."""
    import torch

    from repro_torch.harness import fig19_split
    from repro_torch.kernels.xor_encode import ops as eops
    from repro_torch.kernels.xor_gather import ops as gops
    from repro_torch.sweep import run_points

    torch.set_num_threads(2)

    out = {}
    c0, t0 = (gops.calls, eops.calls), time.process_time()
    fig = FinalStates()
    with quiet_harness():
        rows = fig19_split.run(device="cpu", on_cycle=fig)
    res, states = per_point(fig.final, len(fig19_points()))
    out["a"] = (res, [_host_state(st) for st in states],
                time.process_time() - t0,
                (gops.calls - c0[0], eops.calls - c0[1]), rows)
    c0, t0 = (gops.calls, eops.calls), time.process_time()
    res, states = run_points(seed_points(SEED_AXIS), device="cpu",
                             return_state=True)
    out["b"] = (res, [_host_state(st) for st in states],
                time.process_time() - t0,
                (gops.calls - c0[0], eops.calls - c0[1]))
    return out


def shard_points():
    """(e)'s points: paper_fig19's grid with telemetry on."""
    return [p.replace(telemetry=True) for p in fig19_points()]


def shard_stream_batch():
    """(e)'s streamed batch, (a)'s alpha 1 points (3, traced geometry),
    and the first ``SHARD_HEAD`` requests a core of their traces (on the
    CPU, as ``run_batch`` builds them)."""
    from repro_torch.sweep import build_trace, partition

    b = next(b for b in partition(shard_points()) if len(b) == 3)
    return b, [type(tr)(*(x[:, :SHARD_HEAD].contiguous() for x in tr))
               for tr in (build_trace(pt, index=i, device="cpu")
                          for i, pt in zip(b.indices, b.points))]


def sweep_shard_cpu_side() -> dict:
    """(e)'s unsharded reference on the CPU: ``shard_points`` through
    ``run_points`` (results, telemetry snapshots) and the streamed batch
    through ``stream_replay_points``, both with ``shard=False``."""
    import torch

    from repro_torch.sweep import run_points
    from repro_torch.traces import stream_replay_points

    torch.set_num_threads(2)
    res, snaps = run_points(shard_points(), None, False, None, True,
                            device="cpu")
    b, srcs = shard_stream_batch()
    return {"res": res, "snaps": snaps, "stream": stream_replay_points(
        b.points, srcs, SHARD_CHUNK, None, None, False, device="cpu")}


def sweep_looped_cpu_side() -> dict:
    """Each point of the sweep phase's (a) through the looped ``simulate``
    on the CPU (all ``drain_bound`` cycles), with the worker's CPU
    seconds: a lane of its own, beside ``sweep_cpu_side``'s."""
    import torch

    from repro_torch.sim import ramulator
    from repro_torch.sweep import build_trace

    torch.set_num_threads(1)
    t0 = time.process_time()
    looped = [ramulator.simulate(
        pt.scheme, build_trace(pt, device="cpu"), pt.n_rows,
        alpha=pt.alpha, r=pt.r, n_data=pt.n_data,
        n_cycles=pt.resolved_cycles(), select_period=pt.select_period,
        wq_hi=pt.wq_hi, wq_lo=pt.wq_lo, queue_depth=pt.queue_depth,
        device="cpu") for pt in fig19_points()]
    return {"looped": looped, "looped_s": time.process_time() - t0}


def sweep_stream_cpu_side() -> dict:
    """The sweep phase's (c) on the CPU: ``stream_replay_points`` per batch
    (results, worker CPU seconds), keyed by the batch's indices."""
    import torch

    from repro_torch.sim import trace as tr_mod
    from repro_torch.sweep import partition
    from repro_torch.traces import stream_replay_points

    torch.set_num_threads(2)
    src = stream_head(tr_mod.banded_trace(tr_mod.TraceSpec(**STREAM_TRACE),
                                          device="cpu"))
    out = {}
    for b in partition(stream_points()):
        t0 = time.process_time()
        res = stream_replay_points(b.points, [src] * len(b),
                                   chunk_len=SWEEP_STREAM_CHUNK, device="cpu")
        out[tuple(b.indices)] = (res, time.process_time() - t0)
    return out


def paper_cpu_side() -> dict:
    """The paper phase's CPU side: the Fig 18, Fig 20 and scheme-table
    harnesses' rows and the quickstart's results on the CPU, with the
    worker's CPU seconds for the grids (``quiet_harness``: no table, a
    temporary artefact directory)."""
    import torch

    from repro_torch.harness import (fig18_dedup, fig20_ramp, quickstart,
                                     tab_schemes)

    torch.set_num_threads(2)
    with quiet_harness():
        t0 = time.process_time()
        rows = fig18_dedup.run(device="cpu")
        secs = time.process_time() - t0
        quick = quickstart.main(device="cpu")
        t0 = time.process_time()
        fig20 = fig20_ramp.run(device="cpu")
        tab = tab_schemes.run(device="cpu")
        secs20 = time.process_time() - t0
    return {"fig18": rows, "fig18_s": secs, "quickstart": quick,
            "fig20": fig20, "tab_schemes": tab, "fig20_tab_s": secs20}


# ------------------------------------------------------------- phase 12
# (b): one faulted batch at the availability gate's geometry (128 rows,
# banded 8 cores x 96, scheme_i, alpha 1, r 0.25, select period 32): a
# bank that fails at cycle 20 and rebuilds from 120, a point with no plan
# (on the faulted system: nothing ever fails), and a dead bank beside a
# stuttering parity port
FAULT_BATCH = dict(scheme="scheme_i", alpha=1.0, r=0.25, n_rows=128,
                   n_banks=8, n_cores=8, length=96, seed=0, write_frac=0.3,
                   select_period=32, trace="banded")
FAULT_PLANS = ((("bank", 0, 20, 120),), (),
               (("bank", 3, 0), ("stutter", 8, 5, 2)))


def fault_batch():
    """(b)'s batch, built by hand: ``partition`` would give the no-plan
    point a batch of its own (an empty spec is the faults-off system); in
    this one it runs on the faulted system with the never-fails
    schedule."""
    from repro_torch.sweep import GridBatch, SweepPoint, static_signature

    base = SweepPoint(**FAULT_BATCH)
    pts = [base.replace(faults=sp, seed=k)
           for k, sp in enumerate(FAULT_PLANS)]
    return GridBatch(static_signature(pts[0]), list(range(len(pts))), pts)


def faults_cpu_side() -> dict:
    """The faults phase's CPU side: the availability gate's rows at
    ``--smoke`` geometry and at its defaults (with the gate's messages
    there, and the worker's CPU seconds for both) and (b)'s results and
    final batched state as numpy leaves."""
    import torch

    from repro_torch.harness import fig_faults
    from repro_torch.sweep import run_batch

    torch.set_num_threads(2)
    with quiet_harness():
        t0 = time.process_time()
        smoke = fig_faults.run(smoke=True, device="cpu")
        rows, violations, _ = fig_faults.availability(device="cpu")
        secs = time.process_time() - t0
    res, st = run_batch(fault_batch(), device="cpu", return_state=True)
    return {"smoke": smoke, "rows": rows, "violations": violations,
            "rows_s": secs, "b": (res, _host_state(st))}


# ------------------------------------------------------------- phase 13
# (c): the availability report at --smoke geometry once more at alpha 1, r
# 0.125 (full coverage), where the dead bank's reads are served degraded
# (read class 4); at --smoke's own alpha 0.25, r 0.05 they are failed fast
OBS_FULL_COVERAGE = dict(alphas=(1.0,), r=0.125)
# (d): the timeline CLI's defaults
OBS_TIMELINE = dict(scheme="scheme_i", trace="banded", alpha=0.25, r=0.05,
                    n_rows=128, length=96, select_period=32)
OBS_TIMELINE_CHUNK = 32
OBS_TIMELINE_MAX = 4096
# (e): launches of a busy B = 1 batched cycle with telemetry off over
# cycles 40..60, as measured on the H100 (1,056-1,079 with the eager plan
# bridge; 28.8 fewer a cycle since the read datapath is one launch fed the
# plan, scripts/torch_sim_kernels_ab.py)
OBS_OFF_LAUNCHES = (1027, 1050)
OBS_SERVE_LAYERS = 2             # (g): reduced qwen2.5-3b's layers


def obs_smoke_points(telemetry: bool):
    """(a)'s points: the stall report's ``--smoke`` suite (paper_fig18 on
    8 cores x 32 requests, 64 rows: uncoded and scheme_i alpha 0.25)."""
    from repro_torch.obs import report

    return [pt.replace(telemetry=telemetry)
            for pt in report.suite_points("paper_fig18", smoke=True)]


def obs_timeline(device):
    """(d): ``record_timeline`` at the timeline CLI's defaults."""
    from repro_torch.obs import timeline
    from repro_torch.sweep import SweepPoint

    return timeline.timeline_of(SweepPoint(**OBS_TIMELINE),
                                chunk_len=OBS_TIMELINE_CHUNK,
                                max_cycles=OBS_TIMELINE_MAX, device=device)


def obs_cpu_side() -> dict:
    """The obs phase's CPU side: (a)'s telemetry-on results and snapshots,
    (c)'s availability reports' (at ``--smoke`` and at full coverage),
    (d)'s timeline events and (g)'s serve planes and token counts, on the
    CPU."""
    import torch

    from repro_torch.obs import report
    from repro_torch.sweep import run_points

    torch.set_num_threads(2)
    out = {"a": run_points(obs_smoke_points(True), device="cpu",
                           collect_telemetry=True)}
    with quiet_harness() as tmp:
        for key, kw in (("c", {}), ("c_full", OBS_FULL_COVERAGE)):
            got = report.availability_report(
                "paper_fig18", smoke=True, device="cpu",
                out_dir=os.path.join(tmp, key), **kw)
            out[key] = (got["results"], got["snapshots"])
    out["d"] = obs_timeline("cpu")
    with quiet_harness() as tmp:
        rep = report.serve_report(device="cpu",
                                  out_dir=os.path.join(tmp, "serve"))
    out["g"] = (rep["snapshot"].as_dict(),
                [sp["n_tokens"] for sp in rep["spans"]])
    return out


CPU_STAGES = {"sweep": sweep_cpu_side, "sweep_l": sweep_looped_cpu_side,
              "sweep_c": sweep_stream_cpu_side,
              "sweep_e": sweep_shard_cpu_side, "paper": paper_cpu_side,
              "faults": faults_cpu_side, "obs": obs_cpu_side}
STAGE_PHASE = {"sweep": "sweep", "sweep_l": "sweep", "sweep_c": "sweep",
               "sweep_e": "sweep", "paper": "paper", "faults": "faults",
               "obs": "obs"}
# one worker process per lane, each running its stages in order; the lanes
# run side by side whenever the script lets the CPU side run
CPU_LANES = (("sweep", "sweep_c"), ("sweep_l", "sweep_e"), ("paper", "obs"),
             ("faults",))


def _cpu_worker(conn, stages) -> None:
    """Worker process: for each stage in turn send ``(stage, "ok",
    result)``, or the traceback of its failure, through ``conn``. It runs
    on the CPU alone and hides the card before torch is imported: the
    main process stops it (SIGSTOP) at any point, which must never be
    inside the CUDA driver."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    # the main process asks for every thread's stack (to stderr) before it
    # gives up on a worker that stopped answering
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    try:
        for stage in stages:
            try:
                conn.send((stage, "ok", CPU_STAGES[stage]()))
            except BaseException:
                import traceback
                conn.send((stage, "error", traceback.format_exc()))
                raise
    finally:
        conn.close()


WORKER_EXIT_S = 30               # a worker's exit after its last result
RECEIVE_S = 180                  # a stage's result, once the worker runs
WATCHDOG_S = 1000                # past it, every thread's stack to stderr


class CpuSide:
    """Stages of the CPU side (``CPU_STAGES``, run in the order given) in
    a spawned worker process that runs only while the script
    takes no time: ``pause`` stops it (SIGSTOP) before a phase that reports
    a time, ``resume`` lets it go on (SIGCONT), ``receive`` lets it finish
    the next stage and returns its result (and stops it again while stages
    remain), ``close`` kills it (SIGKILL ends a stopped process too) on
    every way out of ``main``. With no stages it starts no process. A
    worker that gives no result within ``RECEIVE_S`` of being let run
    prints its threads' stacks and is killed; its stages then run in the
    main process (the same functions, so the same checks)."""

    def __init__(self, stages=tuple(CPU_STAGES)):
        import multiprocessing

        self.stages = list(stages)
        self.ran = 0.0                  # seconds it was let run (this stage)
        self._since = None
        self.worker = None
        self.lost = False               # the worker stopped answering
        if not self.stages:
            return
        ctx = multiprocessing.get_context("spawn")
        self.recv, send = ctx.Pipe(duplex=False)
        self.worker = ctx.Process(target=_cpu_worker,
                                  args=(send, self.stages), daemon=True)
        self.worker.start()
        send.close()
        self._since = time.perf_counter()

    def _signal(self, sig) -> None:
        try:
            os.kill(self.worker.pid, sig)
        except ProcessLookupError:      # it has exited
            pass

    def pause(self) -> None:
        if self._since is not None:
            self._signal(signal.SIGSTOP)
            self.ran += time.perf_counter() - self._since
            self._since = None

    def resume(self) -> None:
        if self._since is None and self.stages and not self.lost:
            self._signal(signal.SIGCONT)
            self._since = time.perf_counter()

    def receive(self, stage: str) -> dict:
        """The worker's result of ``stage`` (the next one it owes), letting
        it run until then."""
        check(self.stages[:1] == [stage],
              f"{stage}: the CPU worker owes {self.stages}")
        self.pause()                    # settles ``ran``
        ran, self.ran = self.ran, 0.0
        self.resume()
        t0 = time.perf_counter()
        if self.lost or not self.recv.poll(RECEIVE_S):
            got, status, data = stage, "ok", self._run_here(stage)
        else:
            try:
                got, status, data = self.recv.recv()
            except EOFError:
                got, status, data = stage, "error", ("the worker exited "
                                                     "without a result")
        waited = time.perf_counter() - t0
        check(got == stage and status == "ok",
              f"{stage}: the CPU side failed:\n{data}")
        self.stages.pop(0)
        if self.lost:
            pass                        # nothing left to stop or join
        elif self.stages:
            self.pause()
            self.ran = 0.0              # the next stage starts now
        else:
            # its results are in: a worker that does not exit is killed,
            # never waited on
            self.worker.join(WORKER_EXIT_S)
            if self.worker.is_alive():
                print(f"{stage}: the CPU worker had not exited "
                      f"{WORKER_EXIT_S} s after its last result: killed")
                self._signal(signal.SIGKILL)
                self.worker.join()
            self._since = None
        print(f"{stage}: the CPU side (a worker process, stopped through "
              f"every timed phase) had run {ran:.1f} s beside the untimed "
              f"phases and was ready after {waited:.1f} s more")
        return data

    def _run_here(self, stage: str):
        """``stage``'s CPU side in this process, after the worker (asked
        for its stacks first, once) is killed."""
        import torch

        if not self.lost:
            print(f"{stage}: the CPU worker gave no result within "
                  f"{RECEIVE_S} s of running; its threads' stacks follow on "
                  "stderr; it is killed and its stages run here")
            self._signal(signal.SIGUSR1)
            time.sleep(2)
            self._signal(signal.SIGKILL)
            self.worker.join()
            self.lost, self._since = True, None
        n = torch.get_num_threads()
        try:
            return CPU_STAGES[stage]()
        finally:
            torch.set_num_threads(n)

    def close(self) -> None:
        if self.worker is not None and self.worker.is_alive():
            self._signal(signal.SIGKILL)
        if self.worker is not None:
            self.worker.join()


class CpuSides:
    """The CPU sides of the sweep, paper and faults phases: one
    ``CpuSide`` worker per lane of ``CPU_LANES`` (the sweep's (a), (b)
    then (c); (a)'s looped runs; the paper's; the faults'), paused and
    resumed together, so
    each lane's stages run in every window the script leaves to the CPU
    side rather than one after another. ``receive`` lets every worker run
    while it waits for one stage, and stops them all again."""

    def __init__(self, stages=tuple(CPU_STAGES)):
        self.lanes = [CpuSide(tuple(s for s in lane if s in stages))
                      for lane in CPU_LANES]

    def pause(self) -> None:
        for lane in self.lanes:
            lane.pause()

    def resume(self) -> None:
        for lane in self.lanes:
            lane.resume()

    def receive(self, stage: str) -> dict:
        owner = [lane for lane in self.lanes if lane.stages[:1] == [stage]]
        check(len(owner) == 1, f"{stage}: the CPU workers owe "
              f"{[lane.stages for lane in self.lanes]}")
        for lane in self.lanes:
            if lane is not owner[0]:
                lane.resume()
        data = owner[0].receive(stage)
        self.pause()
        return data

    def close(self) -> None:
        for lane in self.lanes:
            lane.close()


def _host_state(st):
    """A CPU SimState as numpy leaves (to cross from the worker)."""
    return _map_state(lambda x: x.numpy(), st)


def _as_tensors(torch, host):
    """A SimState of numpy leaves (from the worker) as CPU tensors."""
    return _map_state(torch.from_numpy, host)


class SweepHook:
    """``run_points``' ``on_cycle(batch, before, after, out)`` on the card:
    counts each batch's cycles and host time, holds every read that point
    ``golden`` serves against the golden value committed before its cycle,
    checks each batched cycle launched each sim kernel at most once, keeps
    each batch's state before every ``every``-th cycle (from cycle
    ``every // 2``) and its latest state after a cycle (``final``: the
    batch's final state once the run is over; references, no copy)."""

    def __init__(self, golden: int, every: int):
        from repro_torch.kernels.xor_encode import kernel as ek
        from repro_torch.kernels.xor_gather import kernel as gk

        self.kernels = (gk, ek)
        self.golden, self.every = golden, every
        self.bad = self.served = 0
        self.cycles, self.secs, self.states = {}, {}, []
        self.final = {}
        self.most = [0, 0]
        self._last = None

    def __call__(self, batch, before, after, out):
        key = tuple(batch.indices)
        now = time.perf_counter()
        launched = [k.launches for k in self.kernels]
        if self._last is not None and self._last[0] == key:
            self.secs[key] = self.secs.get(key, 0.0) + now - self._last[1]
            self.most = [max(m, a - b) for m, a, b in
                         zip(self.most, launched, self._last[2])]
        n = self.cycles.get(key, 0)
        self.cycles[key] = n + 1
        if n % self.every == self.every // 2:
            self.states.append((batch, before))
        self.final[key] = (batch, after)
        if self.golden in batch.indices:
            k = batch.indices.index(self.golden)
            want = before.mem.golden[k][out.r_bank[k].long(),
                                        out.r_row[k].long().clamp(min=0)]
            self.bad = self.bad + ((out.r_value[k] != want)
                                   & out.r_served[k]).sum()
            self.served = self.served + out.r_served[k].sum()
        self._last = (key, time.perf_counter(), launched)


def _sweep_run(torch, points, hook=None):
    """``run_points`` on the card: (results, per-point final states,
    seconds, (xor_gather, xor_encode) wrapper calls). Each kernel's
    launches must equal its wrapper's calls."""
    from repro_torch.kernels.xor_encode import kernel as ek
    from repro_torch.kernels.xor_encode import ops as eops
    from repro_torch.kernels.xor_gather import kernel as gk
    from repro_torch.kernels.xor_gather import ops as gops
    from repro_torch.sweep import run_points

    g0, e0, gc0, ec0 = gk.launches, ek.launches, gops.calls, eops.calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, states = run_points(points, device="cuda", return_state=True,
                             on_cycle=hook)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    calls = (gops.calls - gc0, eops.calls - ec0)
    launched = (gk.launches - g0, ek.launches - e0)
    check(launched == calls,
          f"sweep: launches {launched}, wrapper calls {calls} on the card")
    return res, states, secs, calls


def _fig19_run(torch, points, hook):
    """Sweep (a): the Fig 19 harness (``repro_torch.harness.fig19_split``,
    its table printed) on the card with ``hook``: (rows, each point's
    SimResult and final state, seconds, (xor_gather, xor_encode) wrapper
    calls). The harness's points must be ``points``, and each kernel's
    launches must equal its wrapper's calls."""
    from repro_torch.harness import fig19_split
    from repro_torch.kernels.xor_encode import kernel as ek
    from repro_torch.kernels.xor_encode import ops as eops
    from repro_torch.kernels.xor_gather import kernel as gk
    from repro_torch.kernels.xor_gather import ops as gops

    g0, e0, gc0, ec0 = gk.launches, ek.launches, gops.calls, eops.calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = fig19_split.run(device="cuda", on_cycle=hook)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    calls = (gops.calls - gc0, eops.calls - ec0)
    launched = (gk.launches - g0, ek.launches - e0)
    check(launched == calls,
          f"sweep (a): launches {launched}, wrapper calls {calls} on the card")
    ran = [None] * len(points)
    for batch, _ in hook.final.values():
        for i, pt in zip(batch.indices, batch.points):
            ran[i] = pt
    check(ran == points, "sweep (a): the Fig 19 harness ran other points "
          "than paper_fig19's grid")
    res, states = per_point(hook.final, len(points))
    return rows, res, states, secs, calls


def _busy_batch(torch, points, start: int = 20):
    """The system, batched trace and tunables ``run_batch`` gives
    ``points`` on the card, and their state after ``start`` batched
    cycles (queues loaded)."""
    from repro_torch.sweep import build_trace, stack_traces
    from repro_torch.sweep.engine import (mixed_geometry, stack_tunables,
                                          system_for)
    from repro_torch.sweep.grid import batch_geometry_alloc

    sys_ = system_for(points[0], batch_geometry_alloc(points),
                      mixed_geometry(points), device="cuda")
    trace_b = stack_traces([build_trace(p, device="cuda") for p in points])
    tn_b = stack_tunables(points, sys_.p.queue_depth, "cuda")
    st = sys_.run_chunk_batch(sys_.init_batch(tn_b), trace_b, None, start,
                              tn_b)
    return [sys_, trace_b, tn_b, st]


def _busy_window(torch, run, label, n: int, prof=None) -> float:
    """``n`` more batched cycles of ``run`` (``_busy_batch``'s list, its
    state advanced in place) inside ``prof`` (a profiler) or timed on the
    host clock after a garbage collection: the ms per batched cycle."""
    import gc

    sys_, trace_b, tn_b, st = run
    c0 = int(st.mem.cycle[0])
    if prof is None:
        gc.collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof if prof is not None else contextlib.nullcontext():
        st = sys_.run_chunk_batch(st, trace_b, None, n, tn_b)
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    check(int(st.mem.cycle[0]) == c0 + n,
          f"profile {label}: {int(st.mem.cycle[0]) - c0} of {n} cycles "
          "ran (the batch went quiescent)")
    run[3] = st
    return ms


def _launch_calls(events) -> int:
    """The host's kernel launch calls in a trace (runtime and driver API).
    They count launches; the kernel records do not quite: a trace of the
    same 20 busy cycles, profiled again and again, held 21,169 launch
    calls every time and 0-3 fewer kernel records (a probe on the H100)."""
    return sum("LaunchKernel" in e.get("name", "") for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver"))


def _profiled_window(torch, run, label, n: int) -> dict:
    """``n`` batched cycles of ``run`` under torch.profiler: device busy
    ms, kernel launches (the host's launch calls), host syncs and copies
    per batched cycle (empty when the trace holds no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    profiled_ms = _busy_window(torch, run, label, n, prof)
    path = ROOT / "build" / f"chip_smoke_sweep_{label}_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in
           ("kernel", "gpu_memcpy", "gpu_memset")]
    runtime = [e["name"] for e in events if e.get("cat") == "cuda_runtime"]
    if not dev:
        return {"profiled_ms": profiled_ms}
    return dict(
        profiled_ms=profiled_ms, busy_ms=sum(e["dur"] for e in dev) / 1e3 / n,
        launches=_launch_calls(events) / n,
        syncs=sum("Synchronize" in e for e in runtime) / n,
        copies=sum("Memcpy" in e for e in runtime) / n)


def profile_batch(torch, points, label, start: int = 20, n: int = 20):
    """Where a batched cycle's time goes: ``n`` busy cycles of the batch
    (from cycle ``start``, queues loaded) through ``run_chunk_batch``, timed
    on the host clock, then under torch.profiler for device busy time,
    kernel launches, host syncs and copies per batched cycle."""
    run = _busy_batch(torch, points, start)
    wall = _busy_window(torch, run, label, n)
    stats = _profiled_window(torch, run, label, n)
    stats["wall_ms"] = wall
    if "launches" not in stats:
        print(f"profile sweep {label}: the trace holds no device activity; "
              "device busy share not measured")
        return stats
    stats["idle"] = 1 - stats["busy_ms"] / wall
    print(f"profile sweep {label} (B={len(points)}) batched cycles "
          f"{start}..{start + n}: wall {wall:.3f} ms/cycle "
          f"({stats['profiled_ms']:.3f} under the profiler) = "
          f"{wall / len(points):.3f} ms per point-cycle, device busy "
          f"{stats['busy_ms']:.3f} ms/cycle (idle {stats['idle']:.1%} of the "
          f"unprofiled wall), {stats['launches']:.0f} kernel launches, "
          f"{stats['syncs']:.1f} host syncs and {stats['copies']:.1f} copies "
          "per batched cycle")
    return stats


def _live_batch(torch, points, states, label) -> None:
    """``check_live_kernels`` on one batch's sampled card states, with the
    system and tunables ``run_batch`` gives that batch."""
    from repro_torch.sweep.engine import (mixed_geometry, stack_tunables,
                                          system_for)
    from repro_torch.sweep.grid import batch_geometry_alloc

    sys_ = system_for(points[0], batch_geometry_alloc(points),
                      mixed_geometry(points), device="cuda")
    live = check_live_kernels(
        torch, sys_, stack_tunables(points, sys_.p.queue_depth, "cuda"),
        states, label)
    print(f"{label}: {live}")


def sweep_phase(torch, sim_single, looped_rate, looped_busy_ms,
                stream_cold, cpu_side):
    """The point axis on the card against the CPU: (a) paper_fig19's grid
    through ``run_points``, (b) a seed axis, (c) ``stream_replay_points``
    at bench_stream's geometry with a kill-and-resume pass, (d) both sim
    kernels bit for bit on live batched card states of every batch of
    (a), (b) and (c). ``sim_single`` is the simulate phase's card result
    of its golden run, ``looped_rate`` its looped cycles/s (drained cycles
    included), ``looped_busy_ms`` its busy profile window's ms a cycle,
    ``stream_cold`` the stream phase's cold card replay of the trace's
    head, ``cpu_side`` the
    ``CpuSide`` worker. Returns each sim kernel's launches over the
    phase."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import latest_step
    from repro_torch.kernels.xor_encode import kernel as ek
    from repro_torch.kernels.xor_gather import kernel as gk
    from repro_torch.sweep import partition
    from repro_torch.sweep.engine import mixed_geometry
    from repro_torch.traces import stream_replay_points, strip_windows

    gk.launches = ek.launches = 0                   # main path starts here
    # (a) paper_fig19's 13 points
    pts = fig19_points()
    batches = partition(pts)
    check(len(pts) == 13 and len(batches) == 3,
          f"sweep (a): {len(pts)} points in {len(batches)} batches, want 13 "
          "in 3")
    golden = next(i for i, p in enumerate(pts)
                  if p.scheme == "scheme_i" and p.alpha == FIG19_GOLDEN[
                      "alpha"] and p.r == FIG19_GOLDEN["r"])
    hook = SweepHook(golden, LIVE_EVERY)
    rows, res, st, secs, calls = _fig19_run(torch, pts, hook)
    cpu = cpu_side.receive("sweep")
    cpu.update(cpu_side.receive("sweep_l"))
    res_c, st_c, secs_c, calls_c, rows_c = cpu["a"]
    st_c = [_as_tensors(torch, h) for h in st_c]
    check(rows == rows_c, f"sweep (a): Fig 19 card rows {rows} vs CPU rows "
          f"{rows_c}")
    check(res == res_c, f"sweep (a): card {res} vs CPU {res_c}")
    check(all(_same_state(torch, a, b) for a, b in zip(st, st_c)),
          "sweep (a): final state leaves differ card vs CPU")
    check(calls == calls_c, f"sweep (a): card calls {calls} vs CPU {calls_c}")
    check(all(r.completed for r in res), "sweep (a): a point did not drain")
    check(hook.most[0] <= 1 and hook.most[1] <= 1,
          f"sweep (a): a batched cycle made {hook.most} launches")
    for pt, r, want in zip(pts, res, cpu["looped"]):
        check(r == want, f"sweep (a) {pt.scheme} alpha={pt.alpha} r={pt.r}: "
              f"batched {r} vs looped {want}")
    looped_cpu_s = cpu["looped_s"]
    bad, served = (int(x) for x in (hook.bad, hook.served))
    check(bad == 0 and served == res[golden].served_reads,
          f"sweep (a): {bad} of {served} served reads of the golden point "
          "did not return the committed value")
    bound = pts[0].resolved_cycles()
    cyc = [int(st[b.indices[0]].mem.cycle) for b in batches]
    check(all(hook.cycles[tuple(b.indices)] == c for b, c in
              zip(batches, cyc)), f"sweep (a): the hook saw {hook.cycles}")
    n_batched = sum(cyc)
    point_cycles = sum(len(b) * c for b, c in zip(batches, cyc))
    for b, c in zip(batches, cyc):
        key = tuple(b.indices)
        geometry = "traced" if mixed_geometry(b.points) else "uniform"
        print(f"sweep (a) batch {list(key)} (B={len(b)}, {geometry} "
              f"geometry): {c} cycles run against drain_bound {bound}; "
              f"{hook.secs.get(key, 0.0) / max(c - 1, 1) * 1e3:.3f} ms per "
              "batched cycle on the host clock (hooks on)")
    print(f"sweep (a) paper_fig19 ({len(pts)} points, {len(batches)} "
          f"batches): card {secs:.2f} s for {n_batched} batched cycles = "
          f"{secs / n_batched * 1e3:.3f} ms per batched cycle, "
          f"{point_cycles / secs:.0f} point-cycles/s = "
          f"{secs / point_cycles * 1e3:.3f} ms per point-cycle, against the "
          f"simulate phase's {looped_rate:.0f} looped cycles/s (drained "
          f"cycles included; a busy looped cycle {looped_busy_ms:.3f} ms); "
          f"looped, the grid would run {len(pts)} x {bound} cycles: ~"
          f"{len(pts) * bound / looped_rate:.0f} s, estimated from that "
          f"rate, not run; CPU {secs_c:.2f} s of worker CPU time; "
          f"launches xor_gather {calls[0]}, xor_encode {calls[1]} (at most "
          f"one each a batched cycle); card = CPU in every field and leaf; "
          f"each point = looped simulate on the CPU ({looped_cpu_s:.1f} s "
          "of worker CPU time); "
          f"all {served} served reads of scheme_i alpha=0.25 r=0.05 "
          f"returned committed values; switches {[r.switches for r in res]}"
          f"; the Fig 19 harness's {len(rows)} rows card = CPU")
    # (b) a seed axis: one untraced batch of 8
    seeds = seed_points(SEED_AXIS)
    check(len(partition(seeds)) == 1, "sweep (b): the seed axis split")
    hook_b = SweepHook(-1, LIVE_EVERY)              # no golden point
    res_b, st_b, secs_b, calls_b = _sweep_run(torch, seeds, hook_b)
    check(hook_b.most[0] <= 1 and hook_b.most[1] <= 1,
          f"sweep (b): a batched cycle made {hook_b.most} launches")
    res_bc, st_bc, _, calls_bc = cpu["b"]
    st_bc = [_as_tensors(torch, h) for h in st_bc]
    check(calls_b == calls_bc, f"sweep (b): card calls {calls_b} vs CPU "
          f"{calls_bc}")
    check(res_b == res_bc and all(_same_state(torch, a, b) for a, b in
                                  zip(st_b, st_bc)),
          f"sweep (b): card {res_b} vs CPU {res_bc}")
    check(res_b[0] == sim_single,
          f"sweep (b): seed 0 {res_b[0]} vs the simulate phase's "
          f"{sim_single}")
    c_b = int(st_b[0].mem.cycle)
    print(f"sweep (b) {GOLDEN_RUN[0]} alpha={GOLDEN_RUN[1]} seeds "
          f"0..{SEED_AXIS - 1} (one batch): {c_b} batched cycles in "
          f"{secs_b:.2f} s = "
          f"{secs_b / c_b * 1e3:.3f} ms per batched cycle, "
          f"{SEED_AXIS * c_b / secs_b:.0f} point-cycles/s; seed 0 equals the "
          f"simulate phase's card result; card = CPU; cycles to drain "
          f"{[r.cycles for r in res_b]}; launches {calls_b}")
    # (c) stream_replay_points at bench_stream's geometry, on its head
    from repro_torch.sim import trace as tr_mod
    spts = stream_points()
    src = stream_head(tr_mod.banded_trace(tr_mod.TraceSpec(**STREAM_TRACE),
                                          device="cpu"))
    sbatches = partition(spts)
    check([b.indices for b in sbatches] == [[0, 1, 2], [3]],
          f"sweep (c): batches {[b.indices for b in sbatches]}")
    out_c, samplers, secs_s = {}, {}, {}
    for b in sbatches:
        samplers[tuple(b.indices)] = sampler = CycleSampler(STREAM_LIVE_EVERY)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_c[tuple(b.indices)] = stream_replay_points(
            b.points, [src] * len(b), chunk_len=SWEEP_STREAM_CHUNK,
            device="cuda",
            on_cycle=sampler)
        torch.cuda.synchronize()
        secs_s[tuple(b.indices)] = time.perf_counter() - t0
    sub = out_c[(0, 1, 2)]
    check(strip_windows(sub[1]) == strip_windows(stream_cold),
          f"sweep (c): alpha 0.25 {sub[1]} vs the stream phase's cold "
          f"head {stream_cold}")
    # kill-and-resume: untimed, so the CPU worker runs meanwhile
    cpu_side.resume()
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        b = sbatches[0]
        kw = dict(chunk_len=SWEEP_STREAM_CHUNK, device="cuda",
                  checkpoint_dir=ckdir, checkpoint_every=CKPT_EVERY)
        cut = stream_replay_points(b.points, [src] * len(b),
                                   max_cycles=CKPT_STOP, **kw)
        step = latest_step(ckdir)
        check(step is not None and cut != sub,
              f"sweep (c): the killed pass left step {step}")
        resumed = stream_replay_points(b.points, [src] * len(b),
                                       resume=True, **kw)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    check(resumed == sub, f"sweep (c): resumed {resumed} vs uninterrupted "
          f"{sub}")
    cpu_c = cpu_side.receive("sweep_c")
    for b in sbatches:
        key = tuple(b.indices)
        card, (want, secs_cpu) = out_c[key], cpu_c[key]
        check(card == want, f"sweep (c) {b.indices}: card {card} vs CPU "
              f"{want}")
        print(f"sweep (c) stream_replay_points alpha "
              f"{[spts[i].alpha for i in b.indices]} on the first "
              f"{STREAM_HEAD} requests a core at chunk "
              f"{SWEEP_STREAM_CHUNK}: card {secs_s[key]:.2f} s, CPU "
              f"{secs_cpu:.2f} s of worker CPU time; cycles "
              f"{[r.cycles for r in card]}, windows "
              f"{[len(r.window_read_latency) for r in card]}, switches "
              f"{[r.switches for r in card]}; card = CPU (windows included)")
    print(f"sweep (c) kill-and-resume: stopped at cycle "
          f"{[r.cycles for r in cut]} with step {step} committed (every "
          f"{CKPT_EVERY} chunks), resumed to the uninterrupted results, "
          "windows included; alpha 0.25 equals the stream phase's cold "
          "head apart from windows")
    shard_subphase(torch, res, cpu_side)
    launches = {"xor_gather": gk.launches, "xor_encode": ek.launches}
    # main path ends here
    check(all(v > 0 for v in launches.values()),
          f"sweep: a kernel of the path never launched: {launches}")
    # (d) the kernels on live batched card states of every batch of (a),
    # (b) and (c), at the shapes the path gave them; untimed, so the CPU
    # worker runs meanwhile
    cpu_side.resume()
    for b in batches:
        _live_batch(torch, b.points, [s_ for bb, s_ in hook.states
                                      if bb.indices == b.indices],
                    f"sweep (d) (a) batch {b.indices}")
    _live_batch(torch, seeds, [s_ for _, s_ in hook_b.states],
                f"sweep (d) (b) seeds 0..{SEED_AXIS - 1}")
    for b in sbatches:
        _live_batch(torch, b.points, samplers[tuple(b.indices)].states,
                    f"sweep (d) (c) alpha {[spts[i].alpha for i in b.indices]}")
    cpu_side.pause()
    # launches per batched cycle and idle share, B = 1, 8 and (a)'s
    # traced batch, in this call
    busy = {n: profile_batch(torch, seed_points(n), f"seeds{n}")
            for n in PROFILE_BATCHES}
    print("sweep: launches per busy batched cycle (host launch calls, "
          "profile windows above): " + ", ".join(
              f"B={n} {busy[n].get('launches', 'not measured')}"
              for n in PROFILE_BATCHES))
    profile_batch(torch, batches[1].points, "fig19_traced")
    return launches


@contextlib.contextmanager
def sweep_mesh(torch, devices):
    """``repro_torch.launch.mesh.make_sweep_mesh`` giving ``devices``."""
    from repro_torch.launch import mesh

    saved = mesh.make_sweep_mesh
    mesh.make_sweep_mesh = lambda n_devices=0, *, device=None: list(devices)
    try:
        yield
    finally:
        mesh.make_sweep_mesh = saved


def shard_subphase(torch, res_a, cpu_side) -> None:
    """Sweep (e): the point axis over ``SHARDS`` shards, all on cuda:0
    (one padding row in each odd batch), against (a)'s unsharded card
    results and the CPU's unsharded runs (``sweep_shard_cpu_side``); the
    streamed batch killed at 2 shards resumes at 1. Each kernel's
    launches must equal its wrapper's calls."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import latest_step
    from repro_torch.kernels.xor_encode import kernel as ek
    from repro_torch.kernels.xor_encode import ops as eops
    from repro_torch.kernels.xor_gather import kernel as gk
    from repro_torch.kernels.xor_gather import ops as gops
    from repro_torch.sweep import engine, partition, run_points
    from repro_torch.traces import stream_replay_points

    pts = shard_points()
    b, srcs = shard_stream_batch()
    card = torch.device("cuda", 0)
    pads = [engine._pad_points(len(x), SHARDS) for x in partition(pts)]
    g0, e0, gc0, ec0 = gk.launches, ek.launches, gops.calls, eops.calls
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_shard_ckpt_")
    try:
        with sweep_mesh(torch, [card] * SHARDS):
            check(engine.shard_devices(torch.device("cuda"), True)
                  == [card] * SHARDS, "sweep (e): the mesh is not replaced")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, snaps = run_points(pts, None, True, None, True,
                                    device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            stream = stream_replay_points(b.points, srcs, SHARD_CHUNK, None,
                                          None, True, device="cuda")
            cut = stream_replay_points(b.points, srcs, SHARD_CHUNK, None,
                                       SHARD_CKPT_STOP, True, ckdir, 1,
                                       device="cuda")
            step = latest_step(ckdir)
        # one card visible: the mesh is one device, the replay unsharded
        resumed = stream_replay_points(b.points, srcs, SHARD_CHUNK, None,
                                       None, True, ckdir, 1, True,
                                       device="cuda")
        torch.cuda.synchronize()
        secs_s = time.perf_counter() - t0 - secs
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    calls = (gops.calls - gc0, eops.calls - ec0)
    launched = (gk.launches - g0, ek.launches - e0)
    check(launched == calls, f"sweep (e): launches {launched}, wrapper "
          f"calls {calls} on the card")
    cpu = cpu_side.receive("sweep_e")
    check(res == res_a, f"sweep (e): {SHARDS} shards {res} vs (a)'s "
          f"unsharded {res_a}")
    check(res == cpu["res"], f"sweep (e): card {res} vs CPU {cpu['res']}")
    check(all(s_ is not None and _same_planes(s_, w)
              for s_, w in zip(snaps, cpu["snaps"])),
          "sweep (e): a telemetry snapshot differs from the CPU's "
          "unsharded run")
    check(stream == cpu["stream"], f"sweep (e): streamed over {SHARDS} "
          f"shards {stream} vs the CPU's unsharded {cpu['stream']}")
    check(step is not None and cut != stream,
          f"sweep (e): the killed pass left step {step}")
    check(resumed == stream, f"sweep (e): resumed at 1 shard {resumed} vs "
          f"{stream}")
    print(f"sweep (e) the point axis over {SHARDS} shards on one card "
          f"(padding rows {pads} by batch): paper_fig19 with telemetry on "
          f"{secs:.2f} s, results = (a)'s unsharded card run = the CPU's, "
          f"every plane = the CPU's unsharded run; alpha 1.0 batch "
          f"{b.indices} on {SHARD_HEAD} requests a core streamed at chunk "
          f"{SHARD_CHUNK} over {SHARDS} "
          f"shards = the CPU's unsharded replay (windows "
          f"{[len(r.window_read_latency) for r in stream]}), killed at "
          f"cycle {[r.cycles for r in cut]} with step {step} at {SHARDS} "
          f"shards and resumed at 1 to the same results; the three replays "
          f"{secs_s:.2f} s; launches {calls}")


# --------------------------------------------------------------- phase 11
def paper_phase(torch, sim_results, cpu_side):
    """The paper's Fig 18 on the card through the port's harness
    (``repro_torch.harness.fig18_dedup.run``: ``paper_fig18`` ->
    ``run_sweep`` -> ``run_points`` at the figures' geometry, 16 points) and
    the quickstart (``compare_schemes`` -> ``run_points``), each against its
    CPU run from the ``CpuSide`` worker, row for row and field for field.
    Each of the simulate phase's five looped points (``sim_results``) must
    equal its batched result here, every alpha 1 row must have 0 switches,
    every read of scheme_i alpha 0.25 must return its committed value, and
    both sim kernels must equal their plain versions bit for bit on live
    states of every Fig 18 batch and on every launch of scheme III's
    alpha < 1 batch (``_recorded_batch``). The grid runs once more without
    the hook, timed as a user runs it. Returns each sim kernel's launches
    over the phase's two counted runs."""
    from repro_torch.configs.paper_memsys import PAPER_ALPHAS, PAPER_SCHEMES
    from repro_torch.core.system import summarize_batch
    from repro_torch.harness import (fig18_dedup, fig20_ramp, quickstart,
                                     tab_schemes)
    from repro_torch.kernels.xor_encode import kernel as ek
    from repro_torch.kernels.xor_encode import ops as eops
    from repro_torch.kernels.xor_gather import kernel as gk
    from repro_torch.kernels.xor_gather import ops as gops

    # paper_fig18's order: uncoded, then each scheme over the alphas
    golden = (1 + PAPER_SCHEMES.index(GOLDEN_RUN[0]) * len(PAPER_ALPHAS)
              + PAPER_ALPHAS.index(GOLDEN_RUN[1]))
    hook = SweepHook(golden, LIVE_EVERY)
    gk.launches = ek.launches = 0                   # main path starts here
    c0 = (gops.calls, eops.calls)
    rows = fig18_dedup.run(device="cuda", on_cycle=hook)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quick = quickstart.main(device="cuda")
    torch.cuda.synchronize()
    quick_s = time.perf_counter() - t0
    fig20 = fig20_ramp.run(device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tab = tab_schemes.run(device="cuda")
    torch.cuda.synchronize()
    tab_s = time.perf_counter() - t0
    launches = {"xor_gather": gk.launches, "xor_encode": ek.launches}
    # main path ends here
    calls = (gops.calls - c0[0], eops.calls - c0[1])
    check(tuple(launches.values()) == calls,
          f"paper: launches {launches}, wrapper calls {calls} on the card")
    check(all(v > 0 for v in launches.values()),
          f"paper: a kernel of the path never launched: {launches}")
    check(hook.most[0] <= 1 and hook.most[1] <= 1,
          f"paper: a batched cycle made {hook.most} launches")
    # each point's SimResult, from its batch's final state
    res = {}
    for batch, st in hook.final.values():
        for k, (i, r) in enumerate(zip(batch.indices, summarize_batch(st))):
            res[i] = (batch.points[k], r)
    check(sorted(res) == list(range(len(rows))) and len(rows) == 16,
          f"paper: {len(rows)} rows, results for points {sorted(res)}")
    for row, (pt, r) in zip(rows, (res[i] for i in range(len(rows)))):
        uncoded = pt.scheme == "uncoded"
        check((row["scheme"], row["cycles"], row["degraded"],
               row["parked"]) == (pt.scheme, r.cycles, r.degraded_reads,
                                  r.parked_writes)
              and row["switches"] == (0 if uncoded else r.switches),
              f"paper: row {row} vs {pt.scheme} alpha={pt.alpha} {r}")
        check(r.completed, f"paper: {pt.scheme} alpha={pt.alpha} did not "
              "drain")
        if pt.alpha == 1.0:
            check(r.switches == 0, f"paper: {pt.scheme} at alpha 1 made "
                  f"{r.switches} region switches")
    for (scheme, alpha), want in sim_results.items():
        got = next(r for pt, r in res.values()
                   if (pt.scheme, pt.alpha) == (scheme, alpha))
        check(got == want, f"paper: {scheme} alpha={alpha} batched {got} "
              f"vs the simulate phase's looped {want}")
    check(res[golden][0].scheme == GOLDEN_RUN[0]
          and res[golden][0].alpha == GOLDEN_RUN[1],
          f"paper: point {golden} is {res[golden][0]}")
    bad, served = int(hook.bad), int(hook.served)
    check(bad == 0 and served == res[golden][1].served_reads,
          f"paper: {bad} of {served} served reads of {GOLDEN_RUN} did not "
          "return the committed value")
    # the grid as a user runs it: the harness's own cycle counter and no
    # hook (outside the counts; its table is printed once, above)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        alone = fig18_dedup.run(device="cuda")
    check(alone == rows, f"paper: Fig 18 rows without the hook {alone} vs "
          f"with it {rows}")
    print("paper fig18 without the hook (as the harness runs alone; the "
          "rows equal): " + next(line for line in printed.getvalue()
                                 .splitlines() if line.startswith("grid:")))
    cpu = cpu_side.receive("paper")
    check(rows == cpu["fig18"],
          f"paper: Fig 18 card rows {rows} vs CPU rows {cpu['fig18']}")
    check(quick == cpu["quickstart"],
          f"paper: quickstart card {quick} vs CPU {cpu['quickstart']}")
    check(fig20 == cpu["fig20"],
          f"paper: Fig 20 card rows {fig20} vs CPU rows {cpu['fig20']}")
    check(tab == cpu["tab_schemes"], f"paper: scheme table card rows {tab} "
          f"vs CPU rows {cpu['tab_schemes']}")
    check(all(r["coded_cycles"] < r["uncoded_cycles"] for r in fig20),
          f"paper: a Fig 20 coded row is not faster than uncoded: {fig20}")
    print(f"paper fig18: card rows = CPU rows, every field ({len(rows)} "
          f"rows; CPU {cpu['fig18_s']:.1f} s of worker CPU time); the "
          f"simulate phase's {len(sim_results)} looped points = their "
          "batched results; every alpha 1 row has 0 switches; all "
          f"{served} served reads of {GOLDEN_RUN[0]} alpha={GOLDEN_RUN[1]} "
          "returned committed values; reduction % / switches: " + ", ".join(
              f"{r['scheme']} {r['alpha']}: {r['reduction_%']} / "
              f"{r['switches']}" for r in rows))
    print(f"paper quickstart: card {quick_s:.2f} s = CPU in every field; "
          f"cycles {[(k, v.cycles) for k, v in quick.items()]}; launches "
          f"xor_gather {launches['xor_gather']}, xor_encode "
          f"{launches['xor_encode']} over the phase (fig18 + quickstart + "
          "fig20 + tab_schemes)")
    print(f"paper fig20: card rows = CPU rows ({len(fig20)} rows; CPU "
          f"{cpu['fig20_tab_s']:.1f} s of worker CPU time with the scheme "
          "table); reduction % / switches: " + ", ".join(
              f"{r['trace']} {r['alpha']}: {r['reduction_%']} / "
              f"{r['switches']}" for r in fig20))
    print(f"paper tab_schemes: card {tab_s:.2f} s, rows = CPU rows; best "
          "case / uniform cycles: " + ", ".join(
              f"{r['scheme']}: {r['best_case_served']} / "
              f"{r['uniform_cycles']}" for r in tab))
    # the kernels on live batched card states of every Fig 18 batch and
    # every point against the golden model; untimed, so the CPU worker
    # runs its next stage meanwhile
    cpu_side.resume()
    n = hold_batches("paper", hook.final)
    t = ORACLE_TALLY["paper"]
    print(f"paper fig18: all {n} points' final card states (the padded "
          f"batches at each point's own geometry) and results = the golden "
          f"model's over their batches' cycles ({t['cycles']} cycles, "
          f"{t['s']:.2f} s of host time)")
    for batch, _ in hook.final.values():
        _live_batch(torch, batch.points,
                    [s_ for b, s_ in hook.states
                     if b.indices == batch.indices],
                    f"paper (d) fig18 batch {batch.points[0].scheme} alpha "
                    f"{[pt.alpha for pt in batch.points]}")
    print(f"paper (e) {_recorded_batch(torch, hook, res)}")
    cpu_side.pause()
    return launches


def _recorded_batch(torch, hook, res) -> str:
    """Scheme III's alpha < 1 Fig 18 batch run once more on the card with
    every ``xor_gather`` and ``xor_encode`` launch held against the plain
    version on that launch's own operands, through the entries the path
    calls (``gather_plan_cuda``: its degraded reads XOR two siblings;
    ``encode_regions_cuda``), and its results against the phase's. Each
    hook must see a launch. Outside the counts."""
    from repro_torch.core.controller import MODE_OPT0, MODE_REDIRECT
    from repro_torch.kernels.xor_encode import ops as eops
    from repro_torch.kernels.xor_encode.ref import encode_regions_plain
    from repro_torch.kernels.xor_gather import ops as gops
    from repro_torch.sweep import run_points

    batch = next(b for b, _ in hook.final.values()
                 if b.points[0].scheme == "scheme_iii" and len(b) > 1)
    seen = {"gather": 0, "encode": 0, "degraded": 0, "two": 0}

    def held(kind, launch, plain):
        def checked(*args):
            out = launch(*args)
            check(torch.equal(out, plain(*args)), f"paper (e): {kind} "
                  f"launch {seen[kind]} differs from its plain version")
            seen[kind] += 1
            if kind == "gather":
                cols = gops.gather_plan_columns(*args)
                opt = (cols.mode >= MODE_OPT0) & (cols.mode < MODE_REDIRECT)
                seen["degraded"] += int(opt.sum())
                seen["two"] += int((opt & (cols.sib0 >= 0)
                                    & (cols.sib1 >= 0)).sum())
            return out
        return checked

    saved = gops.gather_plan_cuda, eops.encode_regions_cuda
    gops.gather_plan_cuda = held("gather", saved[0], gops.gather_plan_plain)
    eops.encode_regions_cuda = held("encode", saved[1], encode_regions_plain)
    try:
        got = run_points(batch.points, device="cuda")
    finally:
        gops.gather_plan_cuda, eops.encode_regions_cuda = saved
    check(got == [res[i][1] for i in batch.indices],
          f"paper (e): rerun {got} vs the phase's results")
    check(seen["gather"] > 0 and seen["encode"] > 0,
          f"paper (e): a hook saw no launch: {seen}")
    check(seen["two"] > 0,
          f"paper (e): no two-sibling degraded read: {seen}")
    return (f"fig18 batch scheme_iii alpha {[p.alpha for p in batch.points]}"
            f" rerun, results equal: all {seen['gather']} xor_gather and "
            f"{seen['encode']} xor_encode launches of the path's entries "
            f"bit-exact vs plain on their own operands ({seen['degraded']} "
            f"degraded reads, {seen['two']} of them parity ^ two siblings)")


def faults_phase(torch, cpu_side):
    """Bank faults on the card against the CPU: (a) the availability gate
    (``repro_torch.harness.fig_faults``, 9 points in 3 batches) at
    ``--smoke`` geometry, where it must hold (coded rows at 100%, uncoded
    below), and at its defaults (128 rows x 96 requests a core), where the
    JAX package's gate fails on a few dropped reads of the coded rows: the
    card's rows and the gate's messages must equal the CPU's at both; (b) one faulted batch of mixed plans (``fault_batch``)
    equal to the CPU in every field and leaf, bank 0 rebuilt and every
    point quiescent; (c) outside the counts, scheme III's batch of (a) run
    again with every ``xor_gather`` launch held against the plain version
    on its own operands. Returns each sim kernel's launches over (a) and
    (b)."""
    from repro_torch.core.system import quiescent
    from repro_torch.harness import fig_faults
    from repro_torch.kernels.xor_encode import kernel as ek
    from repro_torch.kernels.xor_encode import ops as eops
    from repro_torch.kernels.xor_gather import kernel as gk
    from repro_torch.kernels.xor_gather import ops as gops
    from repro_torch.sweep import run_batch

    hook = FinalStates()
    gk.launches = ek.launches = 0                   # main path starts here
    c0 = (gops.calls, eops.calls)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        smoke = fig_faults.run(smoke=True, device="cuda")
    except SystemExit as e:
        check(False, f"faults (a): the availability gate failed at --smoke "
              f"(exit {e.code})")
    torch.cuda.synchronize()
    secs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows, violations, _ = fig_faults.availability(device="cuda",
                                                  on_cycle=hook)
    torch.cuda.synchronize()
    secs_a = time.perf_counter() - t0
    batch = fault_batch()
    t0 = time.perf_counter()
    res_b, st_b = run_batch(batch, device="cuda", return_state=True)
    torch.cuda.synchronize()
    secs_b = time.perf_counter() - t0
    launches = {"xor_gather": gk.launches, "xor_encode": ek.launches}
    # main path ends here
    calls = (gops.calls - c0[0], eops.calls - c0[1])
    check(tuple(launches.values()) == calls,
          f"faults: launches {launches}, wrapper calls {calls} on the card")
    check(launches["xor_gather"] > 0,
          f"faults: xor_gather never launched: {launches}")
    res_a, _ = per_point(hook.final, len(rows))
    for row in smoke:
        coded = row["scheme"] != "uncoded"
        check((row["availability_%"] == 100.0) == coded
              and (row["unserved"] == row["lost_writes"] == 0) == coded,
              f"faults (a): the gate does not hold on {row}")
    cyc_b = int(st_b.mem.cycle[0])
    check(bool(quiescent(st_b).all()) and cyc_b < batch.points[
        0].resolved_cycles(), f"faults (b): not quiescent at cycle {cyc_b}")
    check(bool(st_b.mem.fault.rebuilt[0, 0]),
          "faults (b): bank 0 was not rebuilt")
    check(res_b[1].dead_bank_cycles == res_b[1].unserved_reads == 0
          and res_b[2].dead_bank_cycles > 0
          and all(r.completed for r in res_b), f"faults (b): {res_b}")
    # untimed from here: the CPU worker runs meanwhile
    cpu_side.resume()
    n_a = hold_batches("faults", hook.final)
    n_b = hold_batches("faults", {"b": (batch, st_b)})
    t = ORACLE_TALLY["faults"]
    print(f"faults (a) and (b): all {n_a} + {n_b} points' final card "
          f"states (the fault leaf included) and results = the golden "
          f"model's with their fault plans ({t['cycles']} cycles, "
          f"{t['s']:.2f} s of host time)")
    rerun = _recorded_fault_batch(torch, hook, res_a)
    cpu = cpu_side.receive("faults")
    check(smoke == cpu["smoke"], f"faults (a): --smoke card rows {smoke} "
          f"vs CPU rows {cpu['smoke']}")
    check(rows == cpu["rows"] and violations == cpu["violations"],
          f"faults (a): card rows {rows} {violations} vs CPU rows "
          f"{cpu['rows']} {cpu['violations']}")
    res_c, st_c = cpu["b"]
    check(res_b == res_c, f"faults (b): card {res_b} vs CPU {res_c}")
    check(_same_state(torch, st_b, _as_tensors(torch, st_c)),
          "faults (b): final state leaves differ card vs CPU")
    print(f"faults (a) the availability gate (fig_faults, 9 points, alpha "
          f"1, r 0.25) at --smoke (64 rows x 48 requests a core): held, card "
          f"{secs_s:.2f} s, rows card = CPU; availability %: " + ", ".join(
              f"{r['suite']} {r['scheme']} {r['availability_%']}"
              for r in smoke))
    print(f"faults (a) at its defaults (128 rows x 96 requests a core): card "
          f"{secs_a:.2f} s (CPU {cpu['rows_s']:.1f} s of worker CPU time for "
          "both geometries); rows and the gate's messages card = CPU; "
          "availability %: " + ", ".join(
              f"{r['suite']} {r['scheme']} {r['availability_%']}"
              for r in rows) + "; fault-degraded reads "
          f"{[r['degraded_fault'] for r in rows]}; the gate there: "
          f"{violations or 'held'}")
    print(f"faults (b) one batch of {len(batch)} plans {list(FAULT_PLANS)}: "
          f"{cyc_b} batched cycles in {secs_b:.2f} s; card = CPU in every "
          f"field and leaf (the fault leaf included); bank 0 rebuilt, every "
          f"point quiescent; dead-bank cycles "
          f"{[r.dead_bank_cycles for r in res_b]}, fault-degraded reads "
          f"{[r.fault_degraded_reads for r in res_b]}, cycles "
          f"{[r.cycles for r in res_b]}")
    print(f"faults (c) {rerun}")
    print(f"faults: launches xor_gather {launches['xor_gather']}, xor_encode "
          f"{launches['xor_encode']} over (a) and (b) (alpha 1: no region "
          "switch, so no encode)")
    return launches


def _recorded_fault_batch(torch, hook, res) -> str:
    """Scheme III's batch of the availability gate run once more on the
    card with every ``xor_gather`` launch of the path's entry
    (``gather_plan_cuda``) held against the plain version on that launch's
    own operands (reads degraded around the dead bank, parity ^ two
    siblings), and its results against the gate's. The hook must see a
    launch. Outside the counts."""
    from repro_torch.core.controller import MODE_OPT0, MODE_REDIRECT
    from repro_torch.kernels.xor_gather import ops as gops
    from repro_torch.sweep import run_points

    batch = next(b for b, _ in hook.final.values()
                 if b.points[0].scheme == "scheme_iii")
    seen = {"gather": 0, "degraded": 0, "two": 0}
    launch = gops.gather_plan_cuda

    def checked(*args):
        out = launch(*args)
        check(torch.equal(out, gops.gather_plan_plain(*args)), f"faults "
              f"(c): xor_gather launch {seen['gather']} differs from its "
              "plain version")
        seen["gather"] += 1
        cols = gops.gather_plan_columns(*args)
        opt = (cols.mode >= MODE_OPT0) & (cols.mode < MODE_REDIRECT)
        seen["degraded"] += int(opt.sum())
        seen["two"] += int((opt & (cols.sib0 >= 0) & (cols.sib1 >= 0)).sum())
        return out

    gops.gather_plan_cuda = checked
    try:
        got = run_points(batch.points, device="cuda")
    finally:
        gops.gather_plan_cuda = launch
    check(got == [res[i] for i in batch.indices],
          f"faults (c): rerun {got} vs the gate's results")
    check(seen["gather"] > 0, f"faults (c): the hook saw no launch: {seen}")
    fault_degraded = sum(r.fault_degraded_reads for r in got)
    check(fault_degraded > 0 and seen["two"] > 0,
          f"faults (c): no fault-degraded or two-sibling read: {seen}")
    return (f"scheme_iii batch of the gate (dead banks "
            f"{[p.faults for p in batch.points][0]}) rerun, results equal: "
            f"all {seen['gather']} xor_gather launches of the path's entry "
            f"bit-exact vs plain on their own operands ({seen['degraded']} "
            f"degraded reads, {seen['two']} of them parity ^ two siblings); "
            f"{fault_degraded} reads served degraded because their bank was "
            "down")


def _same_planes(a, b) -> bool:
    """Two ``TelemetrySnapshot``s (card, CPU) equal plane for plane, the
    queue slots' core ids included."""
    import numpy as np

    from repro_torch.obs.planes import Telemetry

    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in Telemetry._fields)


def _hist_text(h) -> str:
    """A log2 latency histogram as its bins up to the last non-empty one."""
    nz = [k for k, v in enumerate(h) if v]
    return "/".join(str(int(v)) for v in h[:nz[-1] + 1]) if nz else "0"


def obs_phase(torch, cpu_side):
    """The simulator's telemetry planes on the card against the CPU: (a)
    the stall report's ``--smoke`` suite (``obs_smoke_points``) through
    ``run_points`` with telemetry off and on: results and every other
    leaf equal, the card's planes = the CPU worker's at every point; (b)
    ``stall_report("paper_fig18")`` at its defaults (96 requests a core on
    128 rows, 16 points in 4 batches), whose own check holds the planes
    against the aggregates, printing the coded exemplar's read and write
    latency histograms against uncoded and the grid's wall time; (c)
    ``availability_report`` at ``--smoke`` and at full coverage
    (``OBS_FULL_COVERAGE``): results and planes (dead cycles, read class 4)
    card = CPU, class 4 served; (d) the timeline at its CLI defaults, the
    card's events = the CPU's. Then, outside the counts: (e) a busy B = 1
    batched cycle profiled with telemetry off and on (off within
    ``OBS_OFF_LAUNCHES``); (f) both sim kernels against their plain
    versions on live telemetry-on states of (b)'s scheme_i alpha < 1
    batch. Returns each sim kernel's launches over (a)-(d)."""
    from repro_torch.kernels.xor_encode import kernel as ek
    from repro_torch.kernels.xor_encode import ops as eops
    from repro_torch.kernels.xor_gather import kernel as gk
    from repro_torch.kernels.xor_gather import ops as gops
    from repro_torch.obs import report
    from repro_torch.sweep import run_points
    from repro_torch.sweep.workloads import build_trace

    out_dir = ROOT / "experiments" / "torch" / "obs"
    hook = SweepHook(-1, LIVE_EVERY)
    gk.launches = ek.launches = 0                   # main path starts here
    c0 = (gops.calls, eops.calls)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_off, st_off = run_points(obs_smoke_points(False), device="cuda",
                                 return_state=True)
    res_on, snaps_a, st_on = run_points(
        obs_smoke_points(True), device="cuda", collect_telemetry=True,
        return_state=True)
    torch.cuda.synchronize()
    secs_a = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep = report.stall_report("paper_fig18", device="cuda",
                              out_dir=str(out_dir), on_cycle=hook)
    torch.cuda.synchronize()
    secs_b = time.perf_counter() - t0
    t0 = time.perf_counter()
    avail = {key: report.availability_report(
        "paper_fig18", smoke=True, device="cuda",
        out_dir=str(out_dir / key), **kw)
        for key, kw in (("c", {}), ("c_full", OBS_FULL_COVERAGE))}
    torch.cuda.synchronize()
    secs_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    events = obs_timeline("cuda")
    secs_d = time.perf_counter() - t0
    launches = {"xor_gather": gk.launches, "xor_encode": ek.launches}
    # main path ends here
    calls = (gops.calls - c0[0], eops.calls - c0[1])
    check(tuple(launches.values()) == calls,
          f"obs: launches {launches}, wrapper calls {calls} on the card")
    check(all(v > 0 for v in launches.values()),
          f"obs: a kernel of the path never launched: {launches}")
    # (g) the serving report at its CLI defaults (10 requests x 16 tokens
    # on reduced qwen2.5-3b's coded pool), its own gates: the code-status
    # table = the oracle's replay after every step, the planes = the
    # oracle's totals; the pool gather's launches join its row's count
    from repro_torch.kernels.coded_kv_decode import kernel as ckd_kernel
    ckd_kernel.launches = 0                         # main path starts here
    t0 = time.perf_counter()
    serve_rep = report.serve_report(device="cuda",
                                    out_dir=str(out_dir / "serve"))
    torch.cuda.synchronize()
    secs_g = time.perf_counter() - t0
    launches_g = ckd_kernel.launches                # main path ends here
    serve_snap = serve_rep["snapshot"]
    check(launches_g == serve_snap.decode_steps * OBS_SERVE_LAYERS
          and launches_g > 0 and serve_snap.degraded_reads > 0,
          f"obs (g): {launches_g} gather launches for "
          f"{serve_snap.decode_steps} decode steps x {OBS_SERVE_LAYERS} "
          f"layers, {serve_snap.degraded_reads} degraded reads")
    check(res_off == res_on, f"obs (a): telemetry off {res_off} vs on "
          f"{res_on}")
    for k, (a, b) in enumerate(zip(st_off, st_on)):
        check(a.mem.tele is None and b.mem.tele is not None
              and _same_state(torch, a._replace(mem=a.mem._replace(
                  tele=None)), b._replace(mem=b.mem._replace(tele=None))),
              f"obs (a): point {k}'s leaves differ telemetry off vs on")
    pts_b, res_b, snaps_b = rep["points"], rep["results"], rep["snapshots"]
    check(len(pts_b) == 16 and all(r.completed for r in res_b),
          f"obs (b): {len(pts_b)} points, completed "
          f"{[r.completed for r in res_b]}")
    full = avail["c_full"]
    check(sum(s.fault_degraded_reads() for s in full["snapshots"]) > 0
          and all(r.dead_bank_cycles > 0 for r in full["results"]),
          f"obs (c): no read served as class 4 at full coverage: "
          f"{full['results']}")
    n_events = sum(e["ph"] != "M" for e in events)
    check(n_events > 0, "obs (d): the timeline recorded no event")
    ex, u = rep["exemplar"], rep["uncoded"]
    cycles_b = dict(hook.cycles)
    print(f"obs (a) the stall report's --smoke suite "
          f"({len(res_on)} points) telemetry off and on: {secs_a:.2f} s, "
          "results and every other leaf equal")
    print(f"obs (b) stall_report paper_fig18 at 96 requests a core x 128 "
          f"rows: {len(pts_b)} points in {len(cycles_b)} batches of "
          f"{sorted(cycles_b.values())} batched cycles in {secs_b:.2f} s "
          f"(the report's own check: planes = aggregates); "
          f"{rep['md_path']}")
    for side in ("read", "write"):
        hist = f"lat_hist_{side}"
        print(f"obs (b) critical-word {side} latency, log2 bins 0.. "
              f"(0 / 1 / 2-3 / 4-7 / ... cycles): coded "
              f"{pts_b[ex].scheme} alpha {pts_b[ex].alpha} "
              f"{_hist_text(getattr(snaps_b[ex], hist))} (avg "
              f"{getattr(res_b[ex], f'avg_{side}_latency'):.3f}) vs uncoded "
              f"{_hist_text(getattr(snaps_b[u], hist))} (avg "
              f"{getattr(res_b[u], f'avg_{side}_latency'):.3f})")
    # outside the counts from here: (e) each flag's busy B = 1 batch timed
    # over cycles 20..40 (off, on), profiled over 40..60 (the window of
    # the sweep phase's profiles) and timed again over 60..80 (on, off)
    runs, prof, wall = {}, {}, {False: [], True: []}
    for tele in (False, True):
        runs[tele] = _busy_batch(
            torch, [seed_points(1)[0].replace(telemetry=tele)])
        wall[tele].append(_busy_window(torch, runs[tele],
                                       f"obs_B1_telemetry_{tele}", 20))
    for tele in (False, True):
        prof[tele] = _profiled_window(torch, runs[tele],
                                      f"obs_B1_telemetry_{tele}", 20)
    for tele in (True, False):
        wall[tele].append(_busy_window(torch, runs[tele],
                                       f"obs_B1_telemetry_{tele}", 20))
    if "launches" not in prof[False] or "launches" not in prof[True]:
        print("obs (e): the trace holds no device activity; launches not "
              "measured")
    else:
        lo, hi = OBS_OFF_LAUNCHES
        check(lo <= prof[False]["launches"] <= hi,
              f"obs (e): {prof[False]['launches']:.0f} launches per busy "
              f"B = 1 batched cycle with telemetry off, not in {lo}-{hi}")
        print("obs (e) a busy B = 1 batched cycle (cycles 40..60 profiled, "
              "20..40 and 60..80 timed off, on, on, off): " + "; ".join(
                  f"telemetry {'on' if tele else 'off'} "
                  f"{prof[tele]['launches']:.0f} launches, "
                  f"{prof[tele]['syncs']:.1f} host syncs, "
                  f"{prof[tele]['copies']:.1f} copies, device busy "
                  f"{prof[tele]['busy_ms']:.3f} ms, wall "
                  f"{' / '.join(f'{w:.3f}' for w in wall[tele])} ms"
                  for tele in (False, True)))
    cpu_side.resume()                   # untimed: the worker runs
    from repro_torch.sim import golden
    pts_a = obs_smoke_points(True)
    for k, (pt, twin, st_k, r_k) in enumerate(zip(
            pts_a, golden.point_twins(pts_a), st_on, res_on)):
        hold_to_oracle("obs", f"(a) point {k} ({pt.scheme} alpha="
                       f"{pt.alpha})", st_k, r_k, twin,
                       build_trace(pt, index=k, device="cpu"),
                       int(st_k.mem.cycle))
    n_b = hold_batches("obs", hook.final)
    t = ORACLE_TALLY["obs"]
    print(f"obs (a) and (b): all {len(pts_a)} + {n_b} telemetry-on points' "
          f"final card states, every plane included, and results = the "
          f"golden model's (OracleTelemetry; {t['cycles']} cycles, "
          f"{t['s']:.2f} s of host time)")
    batch = next(b for b, _ in hook.final.values()
                 if b.points[0].scheme == "scheme_i" and len(b) > 1)
    _live_batch(torch, batch.points,
                [s_ for b, s_ in hook.states if b.indices == batch.indices],
                f"obs (f) telemetry-on batch scheme_i alpha "
                f"{[p.alpha for p in batch.points]}")
    cpu = cpu_side.receive("obs")
    res_c, snaps_c = cpu["a"]
    check(res_on == res_c and all(_same_planes(a, b) for a, b in
                                  zip(snaps_a, snaps_c)),
          f"obs (a): card {res_on} vs CPU {res_c}, or their planes")
    for key in ("c", "c_full"):
        got = avail[key]
        want_res, want_snaps = cpu[key]
        check(got["results"] == want_res and all(
            _same_planes(a, b) for a, b in zip(got["snapshots"],
                                                want_snaps)),
              f"obs (c) {key}: card {got['results']} vs CPU {want_res}, or "
              "their planes")
    check(events == cpu["d"], f"obs (d): {n_events} card events vs "
          f"{sum(e['ph'] != 'M' for e in cpu['d'])} on the CPU")
    print(f"obs (a) the card's planes = the CPU's at each of "
          f"{len(snaps_a)} points")
    runs_c = [(r, s_) for k in ("c", "c_full")
              for r, s_ in zip(avail[k]["results"], avail[k]["snapshots"])]
    print(f"obs (c) availability at --smoke and at full coverage (alpha 1, "
          f"r 0.125): {secs_c:.2f} s, results and planes card = CPU; "
          "fault-degraded (class 4) reads "
          f"{[s_.fault_degraded_reads() for _, s_ in runs_c]}, dead-bank "
          f"cycles {[r.dead_bank_cycles for r, _ in runs_c]}")
    print(f"obs (d) the timeline at its CLI defaults: {n_events} events "
          f"over {events[-1]['ts']} cycles in {secs_d:.2f} s, card = CPU")
    want_g = cpu["g"]
    check(serve_snap.as_dict() == want_g[0]
          and [sp["n_tokens"] for sp in serve_rep["spans"]] == want_g[1],
          f"obs (g): the card's serve planes {serve_snap.as_dict()} vs the "
          f"CPU's {want_g[0]}")
    print(f"obs (g) serve_report (reduced qwen2.5-3b, coded pool, "
          f"{len(serve_rep['spans'])} requests): {secs_g:.2f} s, its gates "
          f"passed (status table = oracle replay every step, planes = "
          f"oracle totals), planes card = CPU; "
          f"{serve_snap.decode_steps} decode steps, "
          f"{serve_snap.degraded_reads} of {serve_snap.served_pages} page "
          f"reads degraded, port cycles {serve_snap.coded_cycles} coded / "
          f"{serve_snap.uncoded_cycles} uncoded, {launches_g} gather_pool "
          f"launches; {serve_rep['md_path']}")
    print(f"obs: launches xor_gather {launches['xor_gather']}, xor_encode "
          f"{launches['xor_encode']} over (a)-(d), gather_pool {launches_g} "
          "over (g)")
    return dict(launches, gather_pool=launches_g)


# ---------------------------------------------------------------- phase 14
def analysis_phase(torch) -> None:
    """The analysis CLI's three layers, ``--strict``, with the carry layer
    on the card."""
    from repro_torch.analysis.__main__ import main as analysis_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = analysis_main(["--strict", "--device", "cuda"])
    out = buf.getvalue().strip()
    check(rc == 0, f"analysis: --strict exited {rc}:\n{out}")
    print(f"analysis: {out} (python -m repro_torch.analysis --strict, the "
          "carry layer on the card)")


TRAIN_ARCH = "qwen2.5-3b"
TRAIN_FULL = dict(steps=8, global_batch=8, seq_len=256)   # (a)
TRAIN_FULL_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=8)
TRAIN_PEAK_LIMIT_GB = 76.0       # (a): peak allocated of the full step
TRAIN_SMALL = dict(global_batch=4, seq_len=32)            # (b)-(d)
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=10)
TRAIN_STEPS = 3                  # (b): steps on each device
TRAIN_LOSS_TOL = dict(rtol=1e-5, atol=1e-6)   # f32 card vs CPU, TF32 off
TRAIN_PARAM_TOL = 1e-4           # f32 card vs CPU, every param leaf
# bf16 compute: the loss to 5e-3, the grad norm to 5e-2 relative, params
# within 2 x the summed learning rates (an Adam step moves a param by at
# most ~lr, whichever way rounding tips a near-zero moment)
TRAIN_BF16_LOSS_TOL = 5e-3
# (b) the non-dense families reduced, card = CPU at f32; (e) each at
# TRAIN_FULL's batch through the Trainer (whisper, whose batches need
# frames, through make_train_step with seeded frames), published widths,
# the depth cut where noted (PERF.md section 4), 8 steps each
TRAIN_FAMILIES = ("olmoe-1b-7b", "mixtral-8x7b", "phi-3-vision-4.2b",
                  "mamba2-2.7b", "recurrentgemma-9b", AUDIO_ARCH)
TRAIN_FAMILY_DEPTH = {"olmoe-1b-7b": 4, "recurrentgemma-9b": 3}
TRAIN_FAMILY_FULL = (AUDIO_ARCH, "mamba2-2.7b", VLM_ARCH, "olmoe-1b-7b",
                     "recurrentgemma-9b")


def _max_leaf_diff(torch, a, b) -> float:
    from repro_torch.optim.adamw import tree_leaves
    return max(float((x.detach().cpu().float()
                      - y.detach().cpu().float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def profile_train_step(torch, cfg, train_step, data_cfg, params, opt,
                       step: int, ms_step: float,
                       host_ops: bool = True) -> dict:
    """One more full-width step (the pipeline's ``step``; an
    encoder-decoder's with seeded frames, every other family's tokens
    only, as the ``Trainer`` feeds them) under torch.profiler: device
    busy ms and its idle share of ``ms_step`` (the unprofiled step),
    kernel launches, host syncs and copies, the heaviest kernels and,
    with ``host_ops``, the heaviest host ops (a CPU trace of every op:
    without it the trace holds the device's records and the runtime
    calls only, and takes a fraction of the time to write and read)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import make_batch

    batch = {"tokens": torch.from_numpy(make_batch(data_cfg, step)["tokens"])}
    if cfg.is_encdec:
        batch.update(_family_inputs(torch, cfg, data_cfg.batch, step))
    batch = {k: v.to("cuda") for k, v in batch.items()}
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops
                                      else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        params, opt, m = train_step(params, opt, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del params, opt
    path = ROOT / "build" / f"chip_smoke_train_{cfg.name}_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in
           ("kernel", "gpu_memcpy", "gpu_memset")]
    check(np.isfinite(loss), f"train profile: loss {loss}")
    if not dev:
        print("profile train: the trace holds no device activity; device "
              "busy share not measured")
        return {"wall_ms": wall_ms}
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    runtime = [e["name"] for e in events if e.get("cat") == "cuda_runtime"]
    stats = dict(wall_ms=wall_ms, busy_ms=sum(by_name.values()) / 1e3,
                 launches=_launch_calls(events) or "not measured",
                 kernel_records=sum(e["cat"] == "kernel" for e in dev),
                 syncs=sum("Synchronize" in n for n in runtime),
                 copies=sum("Memcpy" in n for n in runtime))
    stats["idle"] = 1 - stats["busy_ms"] / ms_step
    print(f"profile train {cfg.name} step {step} (B={data_cfg.batch}, "
          f"S={data_cfg.seq_len}): wall {wall_ms:.1f} ms under the profiler, "
          f"device busy {stats['busy_ms']:.1f} ms (idle {stats['idle']:.1%} "
          f"of the unprofiled {ms_step:.1f} ms/step, "
          f"{1 - stats['busy_ms'] / wall_ms:.1%} of the profiled wall), "
          f"{stats['launches']} kernel launch calls ({stats['kernel_records']}"
          f" kernel records), {stats['syncs']} host syncs, "
          f"{stats['copies']} copies")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {us / 1e3:8.2f} ms  {name[:90]}")
    if not host_ops:
        return stats
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    for a in host[:8]:
        print(f"    host {a.self_cpu_time_total / 1e3:8.2f} ms  {a.key[:60]} x "
              f"{a.count}")
    return stats


def _family_inputs(torch, cfg, b: int, step: int) -> dict:
    """The patch (vision_stub) or frame (encoder-decoder) embeddings of
    step ``step``'s batch of ``b``, seeded, drawn on the CPU."""
    out, gen = {}, torch.Generator().manual_seed(1000 + step)
    if cfg.frontend == "vision_stub":
        out["patches"] = torch.randn(b, cfg.n_patches, cfg.d_model,
                                     generator=gen)
    if cfg.is_encdec:
        out["frames"] = torch.randn(b, cfg.enc_frames, cfg.d_model,
                                    generator=gen)
    return out


def _small_runs(torch, cfg, init, devices, n_micro=1, steps=TRAIN_STEPS):
    """``steps`` of ``make_train_step`` from ``init`` (CPU tensors) on each
    device, on the pipeline's batches (with seeded patches or frames where
    the family takes them): {device: (params, opt, metrics)}."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.optim.adamw import OptConfig, adamw_init, tree_map
    from repro_torch.runtime.steps import make_train_step

    dcfg = DataConfig(vocab=cfg.vocab, batch=TRAIN_SMALL["global_batch"],
                      seq_len=TRAIN_SMALL["seq_len"], seed=0)
    out = {}
    for dev in devices:
        params = tree_map(lambda a: a.to(dev, copy=True), init)
        opt = adamw_init(params)
        step = make_train_step(cfg, OptConfig(**TRAIN_OPT), n_micro=n_micro)
        ms = []
        for s in range(steps):
            batch = {"tokens": torch.from_numpy(make_batch(dcfg, s)["tokens"]),
                     **_family_inputs(torch, cfg, dcfg.batch, s)}
            params, opt, m = step(params, opt,
                                  {k: v.to(dev) for k, v in batch.items()})
            ms.append({k: float(v) for k, v in m.items()})
        out[dev] = (params, opt, ms)
    return out


def _max_leaf_diff_split(torch, cfg, a, b):
    """(max |diff| over the param leaves but the cancelling ones, max over
    those): the k biases of attention without RoPE, whose gradient
    softmax cancels to rounding, which Adam's normalization turns into a
    step of a fraction of lr either way."""
    from repro_torch.optim.adamw import tree_leaves_with_path
    rest, canc = [0.0], [0.0]
    for (path, x), (_, y) in zip(tree_leaves_with_path(a),
                                 tree_leaves_with_path(b)):
        d = float((x.detach().cpu() - y.detach().cpu()).abs().max())
        (canc if cfg.pos != "rope" and path[-1] == "bk" else rest).append(d)
    return max(rest), max(canc)


def family_train_full(torch, arch: str) -> dict:
    """(e): ``arch`` at its published widths (depth cut per
    ``TRAIN_FAMILY_DEPTH``), f32 master params, bf16 compute, TRAIN_FULL's
    batch for 8 steps: through the ``Trainer`` on tokens alone, or, for
    the encoder-decoder, ``make_train_step`` on the pipeline's tokens and
    seeded frames (B, 1500, 384). Every loss finite, the mean of the last
    three below step 0's, peak allocated <= TRAIN_PEAK_LIMIT_GB."""
    import shutil
    import tempfile

    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import lm
    from repro_torch.optim.adamw import OptConfig, adamw_init, tree_leaves
    from repro_torch.runtime.steps import make_train_step
    from repro_torch.runtime.trainer import TrainConfig, Trainer

    cfg = get_config(arch)
    depth = TRAIN_FAMILY_DEPTH.get(arch)
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        if cfg.is_encdec:
            params = lm.init_params(cfg, seed=0, device="cuda",
                                    dtype=torch.float32)
            opt = adamw_init(params)
            step = make_train_step(cfg, OptConfig(**TRAIN_FULL_OPT))
            dcfg = DataConfig(vocab=cfg.vocab, batch=TRAIN_FULL[
                "global_batch"], seq_len=TRAIN_FULL["seq_len"], seed=0)
            log = []
            for s in range(TRAIN_FULL["steps"]):
                batch = {"tokens": torch.from_numpy(
                    make_batch(dcfg, s)["tokens"]),
                    **_family_inputs(torch, cfg, dcfg.batch, s)}
                batch = {k: v.to("cuda") for k, v in batch.items()}
                t1 = time.perf_counter()
                params, opt, m = step(params, opt, batch)
                m = {k: float(v) for k, v in m.items()}
                log.append(dict(m, step=s, wall_s=time.perf_counter() - t1))
            how = "make_train_step with seeded frames"
        else:
            tr = Trainer(cfg, TrainConfig(**TRAIN_FULL, log_every=TRAIN_FULL[
                "steps"], ckpt_every=0, ckpt_dir=ckdir), opt_cfg=OptConfig(
                **TRAIN_FULL_OPT), device="cuda")
            out = tr.run()
            params, opt, step = out["params"], out["opt"], tr.train_step
            dcfg, log = tr.data_cfg, tr.metrics_log
            del out
            how = "Trainer, tokens only"
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for p in tree_leaves(params))
    losses = [m["loss"] for m in log]
    ms_step = 1e3 * sum(m["wall_s"] for m in log[1:]) / (len(log) - 1)
    tokens = TRAIN_FULL["global_batch"] * TRAIN_FULL["seq_len"]
    cut = (f", depth cut to {depth} of {get_config(arch).n_layers} layers"
           if depth else "")
    print(f"train (e) {cfg.name} ({cfg.family}; {how}{cut}): "
          f"{n_params / 1e9:.3f} B params ({16 * n_params / 1e9:.1f} GB of "
          f"f32 params, grads and moments), batch "
          f"{TRAIN_FULL['global_batch']} x {TRAIN_FULL['seq_len']}: "
          f"{ms_step:.1f} ms/step (steps 1-{len(log) - 1}; step 0 "
          f"{1e3 * log[0]['wall_s']:.1f} ms), {tokens / ms_step * 1e3:.0f} "
          f"tokens/s, peak allocated {peak_gb:.2f} GB, {run_s:.1f} s "
          f"(init included); losses {[round(x, 4) for x in losses]}")
    check(all(np.isfinite(x) for x in losses), f"train (e) {cfg.name}: "
          f"loss {losses}")
    check(sum(losses[-3:]) / 3 < losses[0], f"train (e) {cfg.name}: the "
          f"mean of the last three losses {losses[-3:]} is not below step "
          f"0's {losses[0]}")
    check(peak_gb <= TRAIN_PEAK_LIMIT_GB, f"train (e) {cfg.name}: peak "
          f"allocated {peak_gb:.2f} GB > {TRAIN_PEAK_LIMIT_GB} GB")
    prof = profile_train_step(torch, cfg, step, dcfg, params, opt, len(log),
                              ms_step, host_ops=False)
    del params, opt
    torch.cuda.empty_cache()
    return {"ms_step": ms_step, "peak_gb": peak_gb, "run_s": run_s, **prof}


def train_phase(torch) -> dict:
    """Training through the port's ``Trainer`` and ``make_train_step`` on
    the card: (a) full width, (b) card = CPU reduced, (c) fault recovery
    bit for bit, (d) microbatches."""
    import shutil
    import tempfile

    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm
    from repro_torch.optim.adamw import (OptConfig, cosine_schedule,
                                         tree_leaves)
    from repro_torch.runtime.trainer import FaultPlan, TrainConfig, Trainer

    torch.cuda.empty_cache()
    # (a) full width: f32 master params, bf16 compute, coded embedding
    cfg = get_config(TRAIN_ARCH)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = Trainer(cfg, TrainConfig(**TRAIN_FULL, log_every=TRAIN_FULL[
            "steps"], ckpt_every=0, ckpt_dir=ckdir), opt_cfg=OptConfig(
            **TRAIN_FULL_OPT), device="cuda")
        out = tr.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log = tr.metrics_log
        losses = [m["loss"] for m in log]
        n_params = sum(p.numel() for p in tree_leaves(out["params"]))
        ms_step = 1e3 * sum(m["wall_s"] for m in log[1:]) / (len(log) - 1)
        tokens = TRAIN_FULL["global_batch"] * TRAIN_FULL["seq_len"]
        print(f"train (a) {cfg.name} full width ({n_params / 1e9:.3f} B "
              f"params, {cfg.param_dtype} master, {cfg.compute_dtype} "
              f"compute, remat {cfg.remat_policy}), batch "
              f"{TRAIN_FULL['global_batch']} x {TRAIN_FULL['seq_len']}: "
              f"{ms_step:.1f} ms/step (steps 1-{len(log) - 1}; step 0 "
              f"{1e3 * log[0]['wall_s']:.1f} ms), {tokens / ms_step * 1e3:.0f}"
              f" tokens/s, peak allocated {peak_gb:.2f} GB, run {run_s:.1f} s "
              "(init included)")
        for m in log:
            print(f"    step {m['step']}: loss {m['loss']:.4f} grad_norm "
                  f"{m['grad_norm']:.4f} lr_step {m['lr_step']:.0f} "
                  f"{1e3 * m['wall_s']:.1f} ms")
        check(all(np.isfinite(x) for x in losses), f"train (a): loss {losses}")
        check(sum(losses[-3:]) / 3 < losses[0], "train (a): the mean of the "
              f"last three losses {losses[-3:]} is not below step 0's "
              f"{losses[0]}")
        check(peak_gb <= TRAIN_PEAK_LIMIT_GB, f"train (a): peak allocated "
              f"{peak_gb:.2f} GB > {TRAIN_PEAK_LIMIT_GB} GB")
        prof = profile_train_step(torch, cfg, tr.train_step, tr.data_cfg,
                                  out.pop("params"), out.pop("opt"),
                                  len(log), ms_step)
        del tr, out
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()

    # (b) card = CPU: the four dense configs reduced, f32 compute (TF32
    # off), from one init drawn on the CPU; qwen also at bf16 compute
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lr_sum = sum(float(cosine_schedule(OptConfig(**TRAIN_OPT), s))
                 for s in range(1, TRAIN_STEPS + 1))
    cases = [(a, "float32") for a in (TRAIN_ARCH,) + DENSE_ARCHS
             + TRAIN_FAMILIES] + [(TRAIN_ARCH, "bfloat16")]
    for arch, cd in cases:
        small = dataclasses.replace(get_config(arch).reduced(),
                                    compute_dtype=cd)
        init = lm.init_params(small, seed=0, device="cpu",
                              dtype=torch.float32)
        runs = _small_runs(torch, small, init, ("cuda", "cpu"))
        (pc, _, mc), (pp, _, mp) = runs["cuda"], runs["cpu"]
        dl = max(abs(a["loss"] - b["loss"]) for a, b in zip(mc, mp))
        dg = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                 for a, b in zip(mc, mp))
        dp, dk = _max_leaf_diff_split(torch, small, pc, pp)
        canc = (f" (the cancelling k biases {dk:.2e}, held within the "
                f"summed lr {lr_sum:.2e})" if small.pos != "rope" else "")
        print(f"train (b) {small.name} {cd}: {TRAIN_STEPS} steps card vs "
              f"CPU: loss {[round(m['loss'], 5) for m in mc]}, max |loss "
              f"diff| {dl:.2e}, grad norm rel diff {dg:.2e}, max |param "
              f"diff| {dp:.2e}{canc}")
        check(dk <= lr_sum, f"train (b) {small.name}: the k biases differ "
              f"by {dk} > {lr_sum}")
        if cd == "float32":
            for a, b in zip(mc, mp):
                for k in ("loss", "grad_norm"):
                    tol = TRAIN_LOSS_TOL["atol"] + TRAIN_LOSS_TOL["rtol"] \
                        * abs(b[k])
                    check(abs(a[k] - b[k]) <= tol, f"train (b) {small.name}"
                          f": {k} card {a[k]} vs CPU {b[k]}")
            check(dp <= TRAIN_PARAM_TOL, f"train (b) {small.name}: params "
                  f"differ by {dp} > {TRAIN_PARAM_TOL}")
        else:
            check(dl <= TRAIN_BF16_LOSS_TOL and dg <= 5e-2
                  and dp <= 2 * lr_sum, f"train (b) {small.name} bf16: "
                  f"loss {dl}, grad norm {dg}, params {dp} beyond tolerance")
        check(all(a["lr_step"] == b["lr_step"] for a, b in zip(mc, mp)),
              f"train (b) {small.name}: lr_step differs")

    # (c) fault recovery, bit for bit, with deterministic algorithms
    small = get_config(TRAIN_ARCH).reduced()
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        outs = []
        for name, plan in (("uninterrupted", None),
                           ("fault at 3", FaultPlan([3]))):
            d = tempfile.mkdtemp(prefix="chip_smoke_train_")
            try:
                tc = TrainConfig(steps=6, log_every=100, ckpt_every=2, keep=2,
                                 ckpt_dir=d, **TRAIN_SMALL)
                tr = Trainer(small, tc, opt_cfg=OptConfig(**TRAIN_OPT),
                             device="cuda")
                outs.append((tr.run(fault_plan=plan), tr))
            finally:
                shutil.rmtree(d, ignore_errors=True)
    finally:
        torch.use_deterministic_algorithms(was)
    (a, ta), (b, tb) = outs
    same = all(torch.equal(x, y) for x, y in zip(
        tree_leaves(a["params"]) + tree_leaves(a["opt"].m)
        + tree_leaves(a["opt"].v),
        tree_leaves(b["params"]) + tree_leaves(b["opt"].m)
        + tree_leaves(b["opt"].v)))
    print(f"train (c) {small.name} {small.compute_dtype}: 6 steps, "
          f"checkpoint every 2, fault at step 3: events {b['events']}; "
          f"steps run {[m['step'] for m in tb.metrics_log]}; final params "
          f"and OptState {'bit-identical' if same else 'DIFFER'}")
    check("restored step 2" in b["events"], f"train (c): events "
          f"{b['events']} name no restore")
    check(same and int(a["opt"].step) == int(b["opt"].step) == 6,
          "train (c): the restored run differs from the uninterrupted one")

    # (d) microbatches: n_micro=2 against n_micro=1 on the card, f32
    small = dataclasses.replace(get_config("granite-20b").reduced(),
                                compute_dtype="float32")
    init = lm.init_params(small, seed=2, device="cpu", dtype=torch.float32)
    (p1, _, m1), (p2, _, m2) = (
        _small_runs(torch, small, init, ("cuda",), n_micro=n,
                    steps=1)["cuda"] for n in (1, 2))
    dp = _max_leaf_diff(torch, p1, p2)
    print(f"train (d) {small.name}: n_micro 2 vs 1: loss {m2[0]['loss']:.6f}"
          f" vs {m1[0]['loss']:.6f}, grad norm {m2[0]['grad_norm']:.6f} vs "
          f"{m1[0]['grad_norm']:.6f}, max |param diff| {dp:.2e}")
    for k in ("loss", "grad_norm"):
        tol = TRAIN_LOSS_TOL["atol"] + TRAIN_LOSS_TOL["rtol"] * abs(m1[0][k])
        check(abs(m2[0][k] - m1[0][k]) <= tol,
              f"train (d): {k} {m2[0][k]} vs {m1[0][k]}")
    check(dp <= TRAIN_PARAM_TOL, f"train (d): params differ by {dp}")

    # (e) every non-dense family at its published widths
    t0 = time.perf_counter()
    family = {arch: family_train_full(torch, arch)
              for arch in TRAIN_FAMILY_FULL}
    print(f"train (e): {', '.join(TRAIN_FAMILY_FULL)} took "
          f"{time.perf_counter() - t0:.1f} s")
    return {"ms_step": ms_step, "tokens_s": tokens / ms_step * 1e3,
            "peak_gb": peak_gb, "family": family, **prof}


# ---------------------------------------------------------------- phase 15
MESH_TRAIN = dict(global_batch=8, seq_len=256)             # (a)
# qwen2.5-3b at full width and 4 of its 36 layers (cut (8), PERF.md
# section 4): the step-2 checkpoint of f32 params and moments (37 GB at
# 36 layers, 12 GB at 9) written and restored kept (a) at 384 s at full
# depth, 105 s at 9 layers
MESH_DEPTH = 4
MESH_STEPS = 4
MESH_CKPT_AT = 2
MESH_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=MESH_STEPS)
# (b): JAX's cells, each in a process of its own on a fake process group
MESH_CELLS = (("qwen2.5-3b", "train_4k", ()),
              ("granite-20b", "decode_32k", ()),
              ("olmoe-1b-7b", "train_4k", ("--multi-pod", "--moe-ep")))
MESH_DRYRUN_TIMEOUT_S = 420


def start_dryruns(out_dir: str) -> list:
    """(b)'s cells started at once, off the card (no CUDA device is
    visible to them), each writing its record into ``out_dir``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = []
    for arch, shape, flags in MESH_CELLS:
        log = open(os.path.join(out_dir, f"{arch}_{shape}.log"), "w")
        procs.append((arch, shape, flags, log, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, *flags, "--out", out_dir],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT))))
    return procs


class _MeshShape:
    """A mesh's axis names and sizes, for counting without devices."""

    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


def _expected_argument_bytes(arch: str, shape_name: str, flags) -> int:
    """Per-device argument bytes of a dry-run cell from the sharding rules
    alone: every leaf's local shape under its spec, in its dtype (params
    and, for a train cell, both f32 moments and the int32 step; the
    batch, or the token and the cache)."""
    import math

    from repro_torch.configs.base import get_config
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import shapes as shp
    from repro_torch.models import lm

    multi = "--multi-pod" in flags
    mesh = (_MeshShape(("pod", "data", "model"), (2, 16, 16)) if multi
            else _MeshShape(("data", "model"), (16, 16)))
    cfg = dataclasses.replace(get_config(arch), moe_ep="--moe-ep" in flags)
    shape = shp.SHAPES[shape_name]

    def local(x, spec) -> int:
        n = math.prod(shd.local_shape(tuple(x.shape), spec, mesh))
        return n * x.element_size()

    total = 0
    for name, x in shd.flatten_with_path(lm.abstract_params(
            cfg, max_seq=shape.seq_len)):
        b = local(x, shd.param_spec(name, tuple(x.shape), mesh,
                                    moe_ep=cfg.moe_ep))
        total += b * (3 if shape.kind == "train" else 1)
    specs = shp.input_specs(cfg, shape)
    if shape.kind == "train":
        total += 4                                  # the step count
    if shape.kind == "decode":
        for name, x in shd.flatten_with_path(specs["cache"]):
            total += local(x, shd.flatten_with_path(shd.cache_shardings(
                cfg, {name: x}, mesh))[0][1].spec)
        total += local(specs["token"], shd.batch_spec(mesh,
                                                      shape.global_batch))
    else:
        for _, x in shd.flatten_with_path(specs["batch"]):
            total += local(x, shd.batch_spec(mesh, x.shape[0])
                           + (None,) * (x.ndim - 1))
    return total


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _host_leaves(tree) -> dict:
    """Every leaf of a param tree (DTensors gathered, one at a time) as a
    host array, by path."""
    from repro_torch.optim.adamw import tree_leaves_with_path
    out = {}
    for path, x in tree_leaves_with_path(tree):
        if hasattr(x, "full_tensor"):
            x = x.full_tensor()
        out["/".join(path)] = x.detach().cpu()
    return out


def _run_trainer(torch, cfg, tc, mesh=None, laps=None):
    """A ``Trainer`` run: (losses, host params, wall s of each step after
    its first, peak allocated GB); its wall seconds, restore or init and
    checkpoint included, appended to ``laps``."""
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime.trainer import Trainer
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, tc, mesh, OptConfig(**MESH_OPT), device="cuda")
    out = tr.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    log = tr.metrics_log
    walls = [m["wall_s"] for m in log[1:]]
    params = _host_leaves(out["params"])
    del tr, out
    torch.cuda.empty_cache()
    if laps is not None:
        laps.append(time.perf_counter() - t0)
    return [m["loss"] for m in log], params, walls, peak


def mesh_phase(torch, dryruns, dry_dir) -> dict:
    """(a) The DTensor path on the card: a one-rank NCCL process group
    and a (1, 1) ("data", "model") mesh; full-width qwen2.5-3b through
    the DTensor ``Trainer`` against the plain one from the same seed,
    step by step and leaf by leaf, and a checkpoint a mesh run writes at
    step 2 finished by the plain ``Trainer``. (b) JAX's dry-run cells
    (started with the phase, off the card): status ok, per-device
    argument bytes equal to the sharding rules' own count, every
    roofline term."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from repro_torch import axes
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.runtime.trainer import TrainConfig

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=MESH_DEPTH)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    t0 = time.perf_counter()
    laps = []

    def tc(steps, ckpt_every=0, d=None):
        return TrainConfig(steps=steps, log_every=MESH_STEPS,
                           ckpt_every=ckpt_every, ckpt_dir=d or ckdir,
                           **MESH_TRAIN)

    try:
        plain_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_plain_")
        try:
            p_loss, p_params, p_walls, p_peak = _run_trainer(
                torch, cfg, tc(MESH_STEPS, d=plain_dir), laps=laps)
        finally:
            shutil.rmtree(plain_dir, ignore_errors=True)
        dist.init_process_group("nccl", init_method="tcp://127.0.0.1:"
                                f"{_free_port()}", rank=0, world_size=1)
        try:
            mesh = make_debug_mesh(1, 1, device="cuda")
            axes.reset_redistributions()
            mesh_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_run_")
            try:
                m_loss, m_params, m_walls, m_peak = _run_trainer(
                    torch, cfg, tc(MESH_STEPS, d=mesh_dir), mesh, laps)
            finally:
                shutil.rmtree(mesh_dir, ignore_errors=True)
            redist = axes.REDISTRIBUTIONS["n"]
            _run_trainer(torch, cfg, tc(MESH_CKPT_AT, MESH_CKPT_AT), mesh,
                         laps)
        finally:
            dist.destroy_process_group()
        dl = max(abs(a - b) for a, b in zip(m_loss, p_loss))
        dp = max(float((m_params[k].float() - v.float()).abs().max())
                 for k, v in p_params.items())
        same = all(torch.equal(m_params[k], v) for k, v in p_params.items())
        del m_params
        r_loss, r_params, _, _ = _run_trainer(torch, cfg, tc(MESH_STEPS),
                                              laps=laps)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    dr = max(abs(a - b) for a, b in zip(r_loss, p_loss[MESH_CKPT_AT:]))
    dpr = max(float((r_params[k].float() - v.float()).abs().max())
              for k, v in p_params.items())
    del r_params, p_params
    ms_plain = 1e3 * sum(p_walls) / len(p_walls)
    ms_mesh = 1e3 * sum(m_walls) / len(m_walls)
    print(f"mesh (a) {TRAIN_ARCH} full width ({MESH_DEPTH} of its "
          f"layers) on a one-rank NCCL (1, 1) "
          f"DeviceMesh, batch {MESH_TRAIN['global_batch']} x "
          f"{MESH_TRAIN['seq_len']}, {MESH_STEPS} steps: DTensor "
          f"{ms_mesh:.1f} ms/step vs plain {ms_plain:.1f} ms/step (step 0 "
          f"of each run excluded), peak allocated {m_peak:.2f} vs "
          f"{p_peak:.2f} GB, {redist / MESH_STEPS:.1f} redistributions a "
          f"step; losses {[round(x, 5) for x in m_loss]} vs "
          f"{[round(x, 5) for x in p_loss]} (max |diff| {dl:.2e}), max "
          f"|param diff| {dp:.2e}, bitwise {'equal' if same else 'unequal'}")
    print(f"mesh (a) a mesh run's step-{MESH_CKPT_AT} checkpoint finished by "
          f"the plain Trainer (steps {MESH_CKPT_AT}-{MESH_STEPS - 1}): losses "
          f"{[round(x, 5) for x in r_loss]}, max |loss diff| {dr:.2e}, max "
          f"|param diff| {dpr:.2e}")
    for what, d_loss, d_param in (("mesh run", dl, dp),
                                  ("re-meshed run", dr, dpr)):
        check(d_loss <= 1e-5, f"mesh (a) {what}: losses differ by {d_loss}")
        check(d_param <= TRAIN_PARAM_TOL, f"mesh (a) {what}: params differ "
              f"by {d_param}")
    t_a = time.perf_counter() - t0

    cells = []
    deadline = time.monotonic() + MESH_DRYRUN_TIMEOUT_S
    for arch, shape, flags, log, proc in dryruns:
        try:
            rc = proc.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = "killed at the timeout"
        log.close()
        tail = Path(log.name).read_text()[-2000:]
        check(rc == 0, f"mesh (b) {arch} {shape}: dry-run exit {rc}: {tail}")
        mesh_name = "pod2x16x16" if "--multi-pod" in flags else "pod16x16"
        rec = json.loads((Path(dry_dir) / f"{arch}_{shape}_{mesh_name}.json")
                         .read_text())
        want = _expected_argument_bytes(arch, shape, flags)
        got = rec["memory"]["argument_bytes"]
        r = rec["roofline"]
        print(f"mesh (b) dry-run {arch} {shape} {mesh_name}"
              f"{' ' + ' '.join(flags) if flags else ''}: status "
              f"{rec['status']}, traced in {rec['compile_s']} s; per device:"
              f" arguments {got / 1e9:.3f} GB (the rules' count "
              f"{want / 1e9:.3f} GB), live peak "
              f"{rec['memory']['peak_bytes'] / 1e9:.2f} GB of 80 (fits "
              f"{rec['fits_hbm_80g']}); {r['flops_per_dev']:.4g} FLOP, "
              f"{r['bytes_per_dev']:.4g} B, {r['coll_bytes_per_dev']:.4g} "
              f"collective B ({rec['full_pass']['coll_bytes_by_kind']}); "
              f"t_compute {r['t_compute_s'] * 1e3:.3f} ms, t_memory "
              f"{r['t_memory_s'] * 1e3:.3f} ms, t_collective "
              f"{r['t_collective_s'] * 1e3:.3f} ms, dominant "
              f"{r['dominant']}, bound {r['bound_s'] * 1e3:.3f} ms, model "
              f"FLOP/dev {r['model_flops_per_dev']:.4g}, useful "
              f"{r['useful_flops_ratio']:.3f}, roofline fraction "
              f"{r['roofline_frac']:.4f}; secant = full depth "
              f"{rec['cost']['flops'] == rec['full_pass']['flops']}")
        check(rec["status"] == "ok", f"mesh (b) {arch} {shape}: status "
              f"{rec['status']}")
        check(got == want, f"mesh (b) {arch} {shape}: argument bytes {got} "
              f"!= the rules' {want}")
        cells.append(rec)
    print(f"mesh: (a) took {t_a:.1f} s (runs: plain, mesh, mesh to the "
          f"checkpoint, plain restored: "
          f"{', '.join(f'{x:.1f}' for x in laps)} s); the dry-run cells ran "
          "beside it")
    return {"ms_mesh": ms_mesh, "ms_plain": ms_plain, "peak_gb": m_peak,
            "cells": cells}


# Phases in the order they run, and the earlier phases each one needs.
PHASES = ("kernel", "serve", "decode", "cross", "kvstate", "simkernel",
          "simulate", "stream", "sweep", "paper", "faults", "obs",
          "analysis", "train", "mesh")
NEEDS = {"decode": ("serve",), "stream": ("simulate",),
         "sweep": ("simulate", "stream"), "paper": ("simulate",)}


def selected_phases(only) -> tuple:
    """The phases to run: all of them, or ``only`` (a comma-separated
    list) and the phases they need."""
    if only is None:
        return PHASES
    want = set(only.split(","))
    check(want <= set(PHASES), f"--only: unknown phases "
          f"{sorted(want - set(PHASES))}; have {', '.join(PHASES)}")
    for name in reversed(PHASES):
        if name in want:
            want.update(NEEDS.get(name, ()))
    return tuple(p for p in PHASES if p in want)


def main(argv=None) -> int:
    import argparse

    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None, metavar="PHASE[,PHASE...]",
                    help="run the build and only these phases (and those "
                    "they need), print no kernel table and no result line; "
                    f"phases: {', '.join(PHASES)}")
    args = ap.parse_args(argv)
    # the train phase's recovery check runs with deterministic algorithms,
    # which need cuBLAS's workspace fixed before cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    phases = selected_phases(args.only)
    # a run stopped from outside leaves a log that ends where it stopped,
    # and one still running at WATCHDOG_S shows where it waits
    sys.stdout.reconfigure(line_buffering=True)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=False)
    cpu_side = CpuSides(tuple(s for s in CPU_STAGES
                              if STAGE_PHASE[s] in phases))
    try:
        return _main(torch, build, cpu_side, phases, t_start)
    finally:
        faulthandler.cancel_dump_traceback_later()
        cpu_side.close()


def _main(torch, build, cpu_side, phases, t_start) -> int:
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    print(f"phases: {', '.join(phases)}")
    t0 = time.perf_counter()
    built = build.build_all(sorted(f.stem for f in build.CSRC.glob("*.cu")))
    print(f"build: {len(built)} sources with parallel nvcc in "
          f"{time.perf_counter() - t0:.1f} s")
    for res in built:
        print(f"build: {res.name}.cu, nvcc {res.seconds:.1f} s -> "
              f"{res.path.name}")
        if res.name == "coded_kv_decode":
            for key, r in sorted(split_kernel_resources(res.log).items()):
                print(f"    {_split_label(key)}: {r['registers']} registers,"
                      f" spill stores/loads {r['spill_stores']}/"
                      f"{r['spill_loads']} bytes")
            continue
        for line in res.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")

    from repro_torch.configs.base import get_config

    mark = [t_start]

    def lap(name: str) -> None:
        """Print the wall seconds since the last lap: each phase's share."""
        now = time.perf_counter()
        print(f"phase {name}: {now - mark[0]:.1f} s")
        mark[0] = now

    lap("build")
    # every phase after the build runs under the recompile guard: a phase
    # that builds a kernel library (an nvcc run) fails the run when the
    # guard closes, before the kernel table
    from repro_torch.analysis.guard import GUARDED, recompile_guard
    guarded = contextlib.ExitStack()
    guard = guarded.enter_context(recompile_guard(max_compiles=0))
    cpu_side.pause()                    # timed phases: the worker waits
    if "kernel" in phases:
        kern = kernel_phase(torch)
        lap("kernel")
    if "serve" in phases:
        launches, ring_kv = serve_phase(torch)
        serving = [("serving", get_config("qwen2.5-3b").n_heads, ring_kv)]
        for arch in DENSE_ARCHS:
            n, kv = serve_phase(torch, arch, SERVE_RUNS[:2])
            launches += n
            serving.append((f"serving_{arch}", get_config(arch).n_heads,
                            {0: kv[0]}))
        t_families = time.perf_counter()
        n, kv = serve_phase(torch, MOE_ARCH, SERVE_RUNS[:2])
        launches += n
        # each family's attention shape for the decode phase: layer 0 of
        # its ring run
        serving.append((f"serving_{MOE_ARCH}",
                        get_config(MOE_ARCH).n_heads, {0: kv[0]}))
        serving.append((f"serving_{VLM_ARCH}", get_config(VLM_ARCH).n_heads,
                        {0: vlm_serve_phase(torch)}))
        print(f"serve: {MOE_ARCH} and {VLM_ARCH} took "
              f"{time.perf_counter() - t_families:.1f} s of the phase")
        t_families = time.perf_counter()
        for arch in RECURRENT_SERVE:
            ring = recurrent_serve_phase(torch, arch)
            if ring is not None:        # the hybrid's local attention
                serving.append((f"serving_{arch}", get_config(arch).n_heads,
                                {0: ring}))
        print(f"serve: {', '.join(RECURRENT_SERVE)} took "
              f"{time.perf_counter() - t_families:.1f} s of the phase")
        t_families = time.perf_counter()
        serving.append((f"serving_{AUDIO_ARCH}",
                        get_config(AUDIO_ARCH).n_heads,
                        {0: audio_serve_phase(torch)}))
        print(f"serve: {AUDIO_ARCH} took "
              f"{time.perf_counter() - t_families:.1f} s of the phase")
        lap("serve")
    if "decode" in phases:
        decode, decode_launches = decode_phase(
            torch, serving,
            next(r for r in built if r.name == "coded_kv_decode"))
        lap("decode")
    if "serve" in phases:
        del serving, ring_kv, kv
        torch.cuda.empty_cache()
    cpu_side.resume()                   # untimed phases: the worker runs
    if "cross" in phases:
        for arch in ("qwen2.5-3b",) + DENSE_ARCHS:
            cross_device_phase(torch, arch)
        margin = with_margin(torch, cross_device_phase, torch, MOE_ARCH)
        print(f"cross-device {MOE_ARCH}-reduced: smallest router margin "
              f"{margin:.3g}")
        moe_layer_phase(torch)
        mixer_layer_phase(torch)
        for arch in RING_ARCHS:
            margin = with_margin(torch, ring_cross_phase, torch, arch)
            if get_config(arch).family == "moe":
                print(f"cross-device {arch}-reduced: smallest router margin "
                      f"{margin:.3g}")
        t_audio = time.perf_counter()
        ring_cross_phase(torch, AUDIO_ARCH, reduced=False)
        print(f"cross-device {AUDIO_ARCH} at full width took "
              f"{time.perf_counter() - t_audio:.1f} s")
        lap("cross")
    if "kvstate" in phases:
        kvstate_phase(torch)
        lap("kvstate")
    cpu_side.pause()
    if "simkernel" in phases:
        sim_kern = sim_kernel_phase(torch)
        lap("simkernel")
    if "simulate" in phases:
        sim_launches, sim_results, sim_rate, sim_busy_ms = simulate_phase(
            torch)
        lap("simulate")
    if "stream" in phases:
        stream_launches, stream_cold = stream_phase(
            torch, sim_results[GOLDEN_RUN])
        lap("stream")
    if "sweep" in phases:
        sweep_launches = sweep_phase(torch, sim_results[GOLDEN_RUN],
                                     sim_rate, sim_busy_ms, stream_cold,
                                     cpu_side)
        lap("sweep")
    if "paper" in phases:
        paper_launches = paper_phase(torch, sim_results, cpu_side)
        lap("paper")
    if "faults" in phases:
        faults_launches = faults_phase(torch, cpu_side)
        lap("faults")
    if "obs" in phases:
        obs_launches = obs_phase(torch, cpu_side)
        lap("obs")
    if "analysis" in phases:
        analysis_phase(torch)
        lap("analysis")
    if "train" in phases:
        train_phase(torch)
        lap("train")
    if "mesh" in phases:
        import tempfile
        dry_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
        dryruns = start_dryruns(dry_dir)
        try:
            mesh_phase(torch, dryruns, dry_dir)
        finally:
            for *_, log, proc in dryruns:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
            import shutil
            shutil.rmtree(dry_dir, ignore_errors=True)
        lap("mesh")
    guarded.close()                     # RecompileError on a build
    print(f"recompile guard: every phase after the build ran under "
          f"recompile_guard(max_compiles=0) over {', '.join(sorted(GUARDED))}"
          f": {guard.compiles()} kernel builds; library loads "
          f"{guard.loads()}")
    for line in oracle_lines():
        print(line)
    if phases != PHASES:
        print(f"chip_smoke: phases {', '.join(phases)} passed in "
              f"{time.perf_counter() - t_start:.1f} s (--only: no kernel "
              "table, no result line)")
        return 0
    print(f"launches by phase: simulate {sim_launches}, stream "
          f"{stream_launches}, sweep {sweep_launches}, paper "
          f"{paper_launches}, faults {faults_launches}, obs {obs_launches}; "
          f"gather_pool serve {launches}, obs {obs_launches['gather_pool']}")
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")

    main_case = kern["bf16_coded"]
    table = {"kernels": [{
        "name": "gather_pool",
        "route": "cuda",
        "source": "src/repro_torch/csrc/gather_pool.cu",
        "replaces": "src/repro/kernels/coded_kv_decode/kernel.py:182",
        "launches": launches + obs_launches["gather_pool"],
        "max_abs_err": max(k["max_abs_err"] for k in kern.values()),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main_case["library_ms"],
    }]}
    # the simulator's kernels, at the shape its main path gives them
    for name, replaces in (
            ("xor_gather", "src/repro/kernels/xor_gather/kernel.py:108"),
            ("xor_encode", "src/repro/kernels/xor_encode/kernel.py:37")):
        case = sim_kern[(name, "sim")]
        table["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": (sim_launches[name] + stream_launches[name]
                         + sweep_launches[name] + paper_launches[name]
                         + faults_launches[name] + obs_launches[name]),
            "max_abs_err": max(v["max_abs_err"] for (k, _), v in
                               sim_kern.items() if k == name),
            "ms": case["ms"],
            "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"],
            "bound_by": "bytes",
            "library_ms": case["library_ms"],
        })
    # decode attention over coded banks, at the serving width (layer 0)
    case = decode["serving_layer0"]
    table["kernels"].append({
        "name": "coded_kv_decode",
        "route": "cuda",
        "source": "src/repro_torch/csrc/coded_kv_decode.cu",
        "replaces": "src/repro/kernels/coded_kv_decode/kernel.py:102",
        "launches": decode_launches,
        "max_abs_err": max(v["max_abs_err"] for v in decode.values()),
        "ms": case["ms"],
        "plain_ms": case["plain_ms"],
        "bound_ms": case["bound_ms"],
        "bound_by": case["bound_by"],
        "library_ms": case["library_ms"],
    })
    print(card)
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
