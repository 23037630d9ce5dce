#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc per
source, all at once), holds each kernel against its plain PyTorch version on
the card, then drives the paper's running example — TPC-H V.1 MIN/MAX and
COUNT (0MA semi-join sweeps) and MEDIAN (Opt⁺ FreqJoin sweep with
pre-grouping) — through ``plan_query`` and ``Executor.execute`` /
``Executor.compile`` at ``make_tpch_db(scale=100000)``, which has TPC-H
SF10's supplier (100k), part (2M) and partsupp (8M) cardinalities.  Answers
are held exactly against an independent numpy evaluation of V.1, and every
kernel's launch count over that run must be positive, as must the count of
each path of the hash join (the table on the child side, on the parent
side, or in shared memory) for K1 and K2.

The kernels are held against their plain versions at the main path's
inputs and on synthetic cases that reach every path: key −1 (the hash
table's empty marker) in either side, int32's extremes, repeated parent
keys, empty sides, int32 wrap-around and zipf-skewed keys.  K1 is timed
beside ``torch.isin``, its library yardstick, and each K1/K2 main-path call
is split into its phases (fill, build, probe, gather) by CUDA events.  Both
sides of each of ``freq_join.join_path``'s choices (shared memory or the
child side for a child at the row limit, the parent or the child side at
equal lengths) are timed on the same synthetic inputs near where it flips.
K3 is also held against its plain version with one key over 8M rows and with
every row its own run (bitwise, float32 too: its values there are small
integers), and on views at storage offsets 1-3; each main-path
K3 call is timed beside ``torch.cumsum`` of its values (``cumsum_ms``,
device time), a single-pass scan that moves 8 of K3's 13 bytes a row: a
yardstick of the card's scan rate, not a library call of the same function.

Two more phases drive the materialising baselines (``MaterializeJoinOp``,
plain PyTorch sorts and gathers on the card), each run with the kernels'
counts set to 0 just before it and read just after.  ``baseline``: V.1 under
``ref`` and ``opt``, with and without FK/PK degradation, at the same scale;
answers must equal the numpy oracle and ``ExecStats.steps`` the JAX
package's (``V1_BASELINE_STEPS``).  ``fig6``: the paper's Fig. 6 peak tuples
on ``make_graph_db(5000, 60000, seed=2)`` (path-2/3/4) and
``make_stats_db(5000, 20000, 100000, 60000)`` (stats-full) under ``ref``,
``opt`` and ``opt_plus`` with ``oom_guard=50_000_000``: each path row's
peaks, guard trip and COUNT as ``path_oracle`` (numpy on the run's edge
list) gives them, stats-full's as the JAX package gives them at int32
(``FIG6_STATS_ROW``), each guard trip a ``MaterialisationLimit`` raised
before the refused expansion could be allocated, Opt⁺ at most the largest
base relation, and one COUNT across the modes that finish.  Each case
prints its wall ms, the device memory it allocated above what was live
before it, and its kernel launches; every kernel call of its counted run
(K1 under Opt with FK/PK, K3 in Opt's regroup, K2 and K3 under Opt⁺) is
recorded and its output held against the plain version on the same inputs.

The last phase, ``x64``, runs the same paths with 64-bit frequencies (the
JAX package's x64 setting: int64 keys, int64/float64 frequencies, K1–K3's
64-bit instances), counted on its own.  V.1 at the same scale with int64
frequencies: each kernel call of one pass held and timed beside its bytes
bound at 64-bit widths (``call_x64``), then 0MA/Opt⁺ through ``execute``
and ``compile`` and Ref/Opt (± FK/PK) through ``execute``, every answer
equal to the oracle in the reference's x64 dtypes (COUNT int64), steps and
peaks equal to the int32 run's.  Fig. 6 with int64 frequencies: each COUNT
``path_oracle``'s unwrapped, peaks and guard trips the int32 rows'.  Table
2 (``benchmarks/graph_counting.py``: ``make_graph_db(20000, 200000)``,
path-3/4/5 and tree-1/2/3, float64, Opt⁺ compiled, Ref/Opt under its
20M-tuple guard), each run held against the same Executor on CPU copies
of the tables.  Synthetic 64-bit cases on every path × mode × key dtype ×
frequency dtype (key −1, int64's extremes, keys equal in their low 32
bits, int64 sums that wrap past 2^63) and K3 at 8M rows (one key, every
row a run; int64 and float64).  Every kernel call of the phase is held
against its plain version: int64 bitwise, float64 within the stated
bounds.

The ``serve`` phase drives the serving tier (``repro_torch.service``) at
the same scale, its kernel counts set to 0 just before it and read just
after: one ``QueryService`` over the card's tables answers V.1 as SQL text
(minmax, COUNT(*), MEDIAN), each cold and then as a renamed-alias warm copy
that must hit the plan and executable caches, with the stage times of its
``TraceSpan`` tree (``serve`` lines; the kernels were built in the first
phase, so the cold ``compile`` span times the service, not nvcc); the
tier's host cost, a warm ``submit`` beside the cached closure run on the
same padded tables and ``Executor.compile(plan)(db)``, medians of 20, and
one ``torch.profiler`` run of a warm ``submit`` (``serve_overhead``); the
quickstart's dashboard plus V.1 minmax through ``submit_many``, cost-gated
and ungated, fused answers equal to solo ones (``serve_batch``); 8 threads
calling ``submit_async`` (``serve_async``: fewer batches than requests);
a second service on the same ``cache_dir`` (``serve_warmstart``:
``plan_builds == 0``); and 100k rows appended to partsupp inside its
bucket through ``update_table`` (``serve_growth``: no recompile, answers
equal to the oracle on the grown data).  Every answer is held against the
numpy oracle (or the solo answer), every request must be ``ok``, and every
kernel call of the phase is held against its plain version after the
request that made it, outside the timed regions (``kernels_serve``).

The ``tune`` phase drives the kernel tuner (``QueryService.autotune()``,
``repro_torch.kernels.autotune``) once at each width, its kernel counts set
to 0 just before it and read just after: a ``QueryService`` over the same
tables (buckets 8, 32, 131072, 2097152 and 8388608 rows) with a
``cache_dir`` inside the checkout (deleted after) tunes K1–K3 over every
bucket pair, backend ``cuda`` (int32 frequencies), then ``cuda_wide``
(int64, the 64-bit instances).  Every candidate is gated bitwise against the
default config inside the search, and no gate may reject (``tune`` line:
the summary, the search's seconds and each (kernel, bucket)'s winner; one
``tune_search`` line per search with each candidate's best wall µs).  V.1
then runs through the tuned service, each kernel call recorded, held
against its plain version and checked to have run its tuned config; each
(kernel, bucket) those calls hit is timed default against winner on the
search's own scenarios, the winner's answers bitwise equal to the
default's and the plain version's (``tune_win``); the recorded calls are
timed under their tuned configs and under the default (``kernels_tuned``,
device ms); and a second service on the same ``cache_dir`` must search
nothing, drop no executable and load every entry from the store
(``tune_warmstart``), with the same answers.

The ``mesh`` phase drives the mesh ring sweep
(``repro_torch.core.distributed``) on a NCCL process group of world size 1
(its rendezvous a ``FileStore`` in a temporary directory; the group is
destroyed before the last line) and a ``"cuda"`` ``DeviceMesh`` of shape
(1,) named ("data",): V.1 at the same scale through
``DistributedExecutor.compile`` with presort off and on and the dense
domain off and on (minmax and count under 0MA with K1 in the ring, median
under Opt⁺ with K2 in the ring), and ``compile_multi`` of the three
queries, the kernels' counts set to 0 just before those runs and read just
after.  Every answer must equal the local ``Executor``'s over the same
padded capacities bitwise and the numpy oracle's; every K1/K2 call of the
counted runs is held against its plain version.  Each (variant, query)
prints its compiled mesh ms beside the local run's; with presort and the
dense domain off also the root state's all-gather alone and a
``torch.profiler`` run of each side.  ``mesh_steps``: for each distinct
K1/K2 ring call with an 8M-row side (``ps⋉p``, ``s⋉ps``, ``ps⋉s``), one
rank's ring steps over P = 2, 4 and 8 child blocks, each the ring's own
step function (the kernel with a unit parent frequency, or the presort
step), folded as the ring folds them: the result bitwise the one-call
kernel's, the steps' summed device ms beside the one call's and its
bytes bound.  One card holds one NCCL rank, so no multi-rank ring runs
here.

The ``serve_mesh`` phase runs inside the ``mesh`` phase's process group:
``QueryService(mesh=...)`` on the same one-rank ``"cuda"`` mesh, in modes
auto, opt_plus, oma and opt, each beside a local ``QueryService`` of the
same mode and ``min_bucket`` (one shard pads as one device does), all on
one temporary ``cache_dir`` inside the checkout (the tables' statistics
are computed once).  Each mode serves V.1 minmax, count and median and
``tests/helpers/mesh_service_check.py``'s GROUPBY and COSTLY as one batch
and then each alone; the auto service also serves one ``submit_async``
and ``explain()``, and last, partsupp grows by 100k rows inside its
bucket with no recompile.  The kernels' counts are set to 0 just before
the mesh services' requests and read just after (K1 and K2 in the ring
programs, K3 in opt's regroup), every kernel call of those requests is
held against its plain version, every answer must equal the local
service's (bitwise; the grouped AVG within ``grouped_avg_bound``) with
the same errors where a mode cannot plan a query, and V.1's the
oracle's.  ``serve_mesh_warm`` times warm ``submit`` of V.1, mesh against
local, one rep of each after the other, with the ``ring_sweep`` span's
and the local ``run`` span's ms (medians of ``TIMING_REPS``); the lines
also print the mesh gauges and ``explain()``'s placement.

The LM phases drive the port's LM serving path (``repro_torch.models``,
``ServeEngine``), after one untimed request each.  ``lm_serve``:
smollm-135m at its full published width (30 layers, d_model 576, 9 heads
over 3 KV heads, d_ff 1536, vocab 49152), float32 master weights from seed
0 and bfloat16 compute: the launcher's default traffic (8 requests, 4
slots, 16-token prompts, 32 new tokens: two waves) and one wave of four
2048-token prompts (two prefill chunks).  Each wave is timed from outside
``run_wave`` (tokens/s); its steps then run again one by one through the
public ``prefill``/``decode_step``, each synchronised, for the per-wave
prefill ms and the median and p90 decode-step ms; with the decode step's
bytes bound and peak allocated bytes.  One decode step runs under
``torch.profiler`` (device ms, idle share, top kernels, and the device ms
of every cast of the step beside the weight casts' bytes bound).  ``lm_check``: the same weights in float32 compute (TF32 stays off),
prefill and 4 teacher-forced decode steps on the card within ``LM_TOL`` of
the same on the CPU, each ``ServeEngine`` wave's tokens equal to
``greedy_generate`` per prompt and ``greedy_generate``'s first 4 tokens
equal to a ``forward`` rollout; a difference is allowed only at a step
whose top two logits lie within ``LM_TOL`` (counted as a near-tie).  No
kernel of the port runs in a dense model.  ``lm_moe``: Moonlight-16B-A3B
(moonshot-v1-16b-a3b) at its published widths with the depth cut to 2
layers (``reduced``), one wave of 4 requests (64-token prompts, 8 new
tokens), a forward hook on each layer's MoE recording its input.  Serving
computes no expert load: no kernel of the port lies on the served path,
and K3's launches there (0) are the ``kernels`` line's
``lm_serve_launches``.  Then the load accounting, its counts set to 0
just before it: the router's choices for each recorded MoE call go
through ``load_stats`` (COUNT(*) GROUP BY expert: a stable sort and K3),
held bitwise against ``torch.bincount``, against ``load_stats`` on a CPU
copy (the plain route) and, per K3 call, against ``segment_sum_plain`` on
the card; K3's launches there are the ``kernels`` line's
``lm_load_stats_launches``.  ``lm_load_stats`` times K3, ``load_stats``
through K3 and through the plain version, and ``torch.bincount`` (the
library call of the function) on the prefill's first layer's routing; a
second ``lm_profile`` line profiles one of its decode steps.
``lm_mixers``: the recurrent families at their full published widths and
depth, rwkv6-1.6b (24 RWKV6 blocks, d_model 2048, 32 WKV heads of 64,
d_ff 7168, vocab 65536, chunk 64) and zamba2-1.2b (38 Mamba2 layers,
d_inner 4096, 64 SSM heads of 64, state 64, chunk 128, one shared
attention+MLP block applied before each of 7 groups), each as smollm is
driven above (``lm_setup``, ``lm_serve`` over the same traffic and long
wave, ``lm_profile``, ``lm_check``), plus ``lm_state``: in float32, the
chunked prefill's final recurrent states (``wkv``/``tok``/``ffn``, or
``ssm``/``conv``) against those of per-token ``decode_step`` from a fresh
state over the same prompt, within ``LM_STATE_TOL``.  The kernels' counts
are set to 0 just before the phase and read just after: no kernel of the
port lies on these paths, and the ``kernels`` line's
``lm_mixers_launches`` (0 for each) say so.
``lm_train``: the training path (``repro_torch.training``) at smollm-135m's
full width and depth, float32 masters, bfloat16 compute, ``remat="full"``
and one microbatch over the JAX launcher's traffic (``TokenPipeline``, 8 ×
256 tokens, seed 1234): 20 steps over 4 cycled batches at ``base_lr``
1e-3 and warmup 5, each synchronised and timed, the losses finite and the
mean of the last four below the first; step ms, tokens/s, peak bytes; one
more step under ``torch.cuda.set_sync_debug_mode("error")``
(``host_syncs_in_step``: the step reads nothing back); one
step under ``torch.profiler`` (kernels, device ms, idle share) and one
under ``FlopCounterMode`` (FLOPs, achieved TFLOP/s beside the bf16 peak).
``lm_train_check``: the same model in float32, two steps at 2 × 64
tokens, each step's loss and every leaf's gradient on the card against a
CPU copy (``LM_TRAIN_LOSS_TOL``, ``LM_TRAIN_GRAD_TOL``).
``lm_train_family``: rwkv6-1.6b, zamba2-1.2b and Moonlight-16B-A3B at full
width with 2 layers, three steps each at 4 × 256 tokens, losses finite,
step ms and peak bytes.  Counts set to 0 before the phase and read after:
the ``kernels`` line's ``lm_train_launches`` (0 for each, checked).
``lm_ckpt``: resumable training through the checkpointer
(``repro_torch.checkpoint``) and the launcher, all in a temporary
directory in the checkout that the phase removes.  ``lm_ckpt_io``, in
this process, the launcher's model and traffic: step ms without a write,
the first ``save`` (which allocates the pinned host buffers) and its
background write alone (seconds, GB/s, bytes a checkpoint), then
``LM_CKPT_IO_SAVES`` saves' blocking ms, each followed by
``LM_CKPT_IO_AFTER`` steps timed while its write is in flight, then
``restore`` seconds; the restored state is held bitwise against a device
copy taken just before the last save.
``lm_ckpt_launcher``: ``python -m repro_torch.launch.train --steps 6
--ckpt-every 3`` (smollm-135m at full width and depth, its defaults)
runs twice uninterrupted (``a``, ``a2``), then once SIGKILLed as soon as
``step_3`` exists and started again with the same arguments, whose log
must say it resumed from step 3; its final checkpoint is held against
``a``'s bitwise wherever ``a2``'s is bitwise, elsewhere within that leaf's
``a``-``a2`` gap (both gaps printed).  Counts set to 0 before the phase
and read after: the ``kernels`` line's ``lm_ckpt_launches`` (0 for each,
checked; the launcher's own processes run the same step and checkpointer
code and are not counted).
``lm_dist``: distributed training.  ``lm_dist_step``, inside a one-rank
NCCL group: smollm-135m at full width and depth, the launcher's traffic
(``LM_DIST``), its state placed on the (1, 1) host mesh by the logical
rules and trained through the mesh step (``build_train_step`` under
``use_mesh``; a dense model, so the step computes on the placed DTensor
weights), then the same steps on one device from the same weights;
every tensor of the two states and every loss bitwise equal; step ms
(median, p90) mesh against local, peak bytes, the placed state's bytes
and the FLOPs of a step per rank, and one mesh and one local step
profiled (wall and device ms, idle share, kernels, host op events).
``lm_dist_gather``: the same on the gather path (the mesh step of the
recurrent families: whole weights gathered once a step, gradients
all-reduced), rwkv6-1.6b at full width with 2 layers (``LM_DIST_GATHER``),
bitwise the one-device step.  ``lm_dist_moe``: Moonlight at full width
with 2 layers (``LM_DIST_MOE``) through the placed step (the dense
step's attention; each MoE layer's experts on their blocks of the
expert dim, its buffer reduce-scattered onto them and gathered back),
bitwise the one-device step, with its ``dropped_frac`` on both runs, the
mesh run's state held on the host while the one-device run's is on the
card; one placed and one local step profiled (device ms, idle share,
host op events); then the same model through the gather path
(``TP_FAMILIES`` emptied), bitwise too; step ms placed against one
device and against the gather path.  ``lm_dist_serve``: smollm-135m at
full width and depth served through partitioned serving on the same
one-rank mesh: its bfloat16 weights and caches placed by
``launch.inputs.serving_shardings``, the launcher's traffic (its first
wave through ``greedy_generate``, every wave greedy step by step), tokens
and every step's logits bitwise the one-device run's on the same
bfloat16 weights, with
prefill and decode-step ms placed against one device, the peak, and one
profiled decode step of each (device ms, idle share, host op events).
``lm_dist_launcher``: the
launcher as rank 0 of 1 under ``COORDINATOR_ADDRESS`` (a ``file://``
rendezvous) once uninterrupted, once SIGKILLed when ``step_3`` appears
and restarted; the resumed run's final checkpoint bitwise the
uninterrupted one's.  ``lm_dist_multi``:
with ``LM_DIST_MULTI["ranks"]`` cards, that many NCCL ranks on a (2, 2)
data × model mesh, float32, each of ``LM_DIST_MULTI_CASES`` against one
rank within ``tests/helpers/distributed_lm_check.py``'s bounds, with step
ms, the collectives of a step by op and a profiled step (device and NCCL
ms, host op events): smollm-135m through the dense step
(tensor-parallel products over "model"; its 3 KV heads do not divide by
2, so its attention cuts the query positions) and through the gather
path, rwkv6-1.6b at 2 layers through the gather path, and Moonlight at
2 layers on 2 batch shards (its capacity, first-come positions and load
balance over both shards' rows; both runs' ``dropped_frac`` and whether
any token dropped) through the gather path and through the placed step
(32 experts a rank, ``d_ff`` 704 a rank); then, in the same ranks,
partitioned serving in float32 (``LM_DIST_MULTI_SERVE``; each a
teacher-forced run's logits within ``LM_TOL`` of one card's and a greedy
run's tokens equal but for near-ties, rank 0's peak and cache bytes
beside one card's): smollm-135m at ``LM_CHECK``'s traffic (the cache's
head dim over "model"), one ``LM_LONG`` prompt (batch 1: its sequence
over "data") and qwen3-14b at 4 of its 40 layers (its 8 KV heads over
"model") and Moonlight at 2 layers and ``LM_MOE``'s traffic (its 4 rows in
2 blocks over "data", each MoE layer's capacity and first-come positions
over both; the prefill's dropped assignments a layer, from the summed
counts against the capacity, beside one card's); with fewer cards a
line saying it did not run and why.  Counts set to 0
before the phase and read after: ``lm_dist_launches`` (0, checked).
``lm_dist_moe_serve``: the MoE family through partitioned serving,
Moonlight at its published widths and ``LM_MOE``'s 2 layers and traffic,
on a one-rank NCCL (1, 1) mesh of its own: its bfloat16 weights and
caches placed by ``serving_shardings``, ``greedy_generate``'s tokens and
every step's logits bitwise the one-device run's on the same bfloat16
weights, each prefill's dropped assignments a layer equal, prefill and
decode-step ms placed against one device, the peak and one profiled
decode step of each (device ms, idle share, host op events).  Counts
set to 0 before the phase and read after: ``lm_dist_moe_serve_launches``
(0, checked: LM serving launches no kernel of the port).
``lm_dryrun``: the dry run.  ``lm_dryrun_cli``: ``python -m
repro_torch.launch.dryrun`` on smollm-135m's ``decode_32k`` on both
production meshes (256 and 512 fake ranks) exits 0 with two results,
printed.  ``lm_dryrun_step``: ``lower_train_cell`` of ``lm_dist``'s
model and traffic on a one-rank fake (1, 1) mesh, its placed state's
bytes, FLOPs and collectives by kind equal to ``lm_dist_step``'s real
NCCL step (one more step counted under ``FlopCounterMode`` and
``CommDebugMode``), its predicted peak beside the measured one with the
ratio (not gated), and ``torch.cuda.memory_allocated()`` unchanged.
Counts set to 0 before the phase and read after: ``lm_dryrun_launches``
(0, checked).

Prints the card's name and power limit, one JSON line per kernel call, per
phase split, per cut-off case and per timed K3 case (``segsum_case``), one
JSON line per query with its times, one per query with
its device time by kernel from ``torch.profiler``, one per ``baseline`` and
``fig6`` case, one per ``x64`` call, query and case and one per ``serve``,
``tune`` and LM case (each with the card's name and power limit), one JSON
line ``{"kernels_x64": [...]}`` with the
64-bit instances' times, bounds and launches, one JSON line
``{"kernels": [...]}`` with each kernel's time, bound, plain-version and
library time on the int32 main path and its launches in the ``mesh`` and
``serve_mesh`` phases (``mesh_launches``, ``serve_mesh_launches``), in
the recurrent LM phase (``lm_mixers_launches``; K3's also with its other
LM launches), in the training phase (``lm_train_launches``), in the
checkpoint phase (``lm_ckpt_launches``), in the distributed training
phase (``lm_dist_launches``), in the MoE serving phase
(``lm_dist_moe_serve_launches``) and in the dry run
(``lm_dryrun_launches``),
the
whole run's seconds, and as its last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without
that line; so does a run without a card, or from a directory that does
not hold the port's ``src/repro_torch`` beside the script.  Needs a CUDA GPU of compute capability 9.0 (sm_90a) and nvcc.
"""

from __future__ import annotations

import collections
import contextlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SCALE = 100_000            # supplier 100k, part 2M, partsupp 8M rows
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
QUERIES = ("minmax", "count", "median")
COMPILED_RUNS = 3
TIMING_REPS = 20
SPIN_CYCLES = 2_000_000    # ~1 ms at the H100's clock: time to enqueue a call

KERNEL_META = {
    "semi_join": ("src/repro_torch/kernels/csrc/freq_join.cu",
                  "src/repro/kernels/semi_join.py:56"),
    "freq_join": ("src/repro_torch/kernels/csrc/freq_join.cu",
                  "src/repro/kernels/freq_join.py:84"),
    "segment_sum": ("src/repro_torch/kernels/csrc/segment_sum.cu",
                    "src/repro/kernels/segment_sum.py:79"),
}

BASELINE_MODES = (("ref", False), ("ref", True), ("opt", False), ("opt", True))
BASELINE_REPS = 3

# ExecStats.steps of V.1 under the baselines at make_tpch_db(scale=100000,
# seed=0), as the JAX package records them on the CPU (this script never
# loads that package; the command does, by module name):
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c '
#   from importlib import import_module as im
#   c, r = im("repro.core"), im("repro.data.relational")
#   db, s = r.make_tpch_db(scale=100000)
#   for q in ("minmax", "count", "median"):
#       for m in ("ref", "opt"):
#           for f in (False, True):
#               p = c.plan_query(r.tpch_v1_query(q), s, mode=m, use_fkpk=f)
#               print(q, m, f, c.Executor(db, s).execute(p)["__stats__"].steps)'
# minmax and median are rooted at supplier, count at partsupp; a ref plan
# is the same with and without FK/PK degradation.
_STEPS_S = {
    "ref": [("scan(s)", 100000), ("scan(ps)", 8000000),
            ("join(s⋈ps)", 8000000), ("scan(p)", 866676),
            ("join(s⋈p)", 3464696), ("scan(n)", 25), ("join(s⋈n)", 3464696),
            ("scan(r)", 2), ("join(s⋈r)", 1388068)],
    "opt": [("scan(s)", 100000), ("scan(n)", 25), ("scan(r)", 2),
            ("join(n⋈r)", 10), ("regroup(n)", 10), ("join(s⋈n)", 40057),
            ("regroup(s)", 40057), ("scan(ps)", 8000000), ("scan(p)", 866676),
            ("join(ps⋈p)", 3464696), ("regroup(ps)", 3464696),
            ("join(s⋈ps)", 1388068), ("regroup(s)", 40057)],
    "opt_fkpk": [("scan(s)", 100000), ("scan(n)", 25), ("scan(r)", 2),
                 ("semijoin(n⋉r)", 10), ("semijoin(s⋉n)", 40057),
                 ("scan(ps)", 8000000), ("scan(p)", 866676),
                 ("semijoin(ps⋉p)", 3464696), ("join(s⋈ps)", 1388068),
                 ("regroup(s)", 40057)],
}
_STEPS_PS = {
    "ref": [("scan(ps)", 8000000), ("scan(s)", 100000),
            ("join(ps⋈s)", 8000000), ("scan(n)", 25),
            ("join(ps⋈n)", 8000000), ("scan(r)", 2), ("join(ps⋈r)", 3205148),
            ("scan(p)", 866676), ("join(ps⋈p)", 1388068)],
    "opt": [("scan(ps)", 8000000), ("scan(p)", 866676),
            ("join(ps⋈p)", 3464696), ("regroup(ps)", 3464696),
            ("scan(s)", 100000), ("scan(n)", 25), ("scan(r)", 2),
            ("join(n⋈r)", 10), ("regroup(n)", 10), ("join(s⋈n)", 40057),
            ("regroup(s)", 40057), ("join(ps⋈s)", 1388068),
            ("regroup(ps)", 1388068)],
    "opt_fkpk": [("scan(ps)", 8000000), ("scan(p)", 866676),
                 ("semijoin(ps⋉p)", 3464696), ("scan(s)", 100000),
                 ("scan(n)", 25), ("scan(r)", 2), ("semijoin(n⋉r)", 10),
                 ("semijoin(s⋉n)", 40057), ("semijoin(ps⋉s)", 1388068)],
}
V1_BASELINE_STEPS = {
    (q, mode, fkpk): (_STEPS_PS if q == "count" else _STEPS_S)[
        "opt_fkpk" if (mode, fkpk) == ("opt", True) else mode]
    for q in QUERIES for mode, fkpk in BASELINE_MODES}

# Fig. 6 at the JAX package's sizes (benchmarks/materialisation.py), int32.
# The graph's zipf sources come from numpy's Generator.zipf, whose stream
# differs between numpy versions, so the path rows are held against
# path_oracle on the run's own edge list.  stats-full's data are drawn with
# Generator.integers only; its row (largest base relation, peak tuples per
# mode, COUNT(*)) is the JAX package's on the CPU with
# Executor(oom_guard=FIG6_GUARD).
FIG6_GUARD = 50_000_000
FIG6_MODES = ("ref", "opt", "opt_plus")
FIG6_GRAPH = {"n_nodes": 5_000, "n_edges": 60_000, "seed": 2}
FIG6_STATS = {"n_users": 5_000, "n_posts": 20_000, "n_comments": 100_000,
              "n_votes": 60_000}
FIG6_STATS_ROW = (100000, {"ref": 299887, "opt": 100000, "opt_plus": 100000},
                  299887)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------
def time_ms(torch, fn, reps: int = TIMING_REPS, warm: int = 3,
            queued: bool = False) -> float:
    """Median time of one call of ``fn``, by CUDA events (``split_ms``)."""
    return statistics.median(split_ms(torch, [fn], reps, warm, queued)[0])


def split_ms(torch, steps, reps: int = TIMING_REPS, warm: int = 3,
             queued: bool = False):
    """Time of each of ``steps``, callables run back to back on one stream,
    by CUDA events recorded between them: one list of ``reps`` times per
    step.  Unqueued, a step's time includes the host's time to launch it
    whenever the card waits for the host, as it does for a small call.
    ``queued`` first holds the card in a spin kernel long enough for the
    host to enqueue every step, so the events time the device alone."""
    for _ in range(warm):
        for step in steps:
            step()
    torch.cuda.synchronize()
    times = [[] for _ in steps]
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(steps) + 1)]
        if queued:
            torch.cuda._sleep(SPIN_CYCLES)
        ev[0].record()
        for step, e in zip(steps, ev[1:]):
            step()
            e.record()
        ev[-1].synchronize()
        for k, t in enumerate(times):
            t.append(ev[k].elapsed_time(ev[k + 1]))
    return times


def join_bytes(np_: int, nc: int, kbytes: int = 4, fbytes: int = 4) -> int:
    # pk, pf read and out written per parent row; ck, cf read per child row:
    # 12 and 8 B at int32, 24 and 16 B with int64 keys and frequencies
    return np_ * (kbytes + 2 * fbytes) + nc * (kbytes + fbytes)


def segsum_bytes(n: int, kbytes: int = 4, vbytes: int = 4) -> int:
    # keys, values read and sums written, valid written (1 B): 13 B a row
    # at int32, 25 B with int64 keys and 64-bit values
    return n * (kbytes + 2 * vbytes + 1)


def call_bytes(name: str, args) -> int:
    """The bytes bound's numerator of one kernel call, at its dtypes."""
    if name == "segment_sum":
        k, v = args
        return segsum_bytes(k.shape[0], k.element_size(), v.element_size())
    pk, pf, ck, _ = args
    return join_bytes(pk.shape[0], ck.shape[0], pk.element_size(),
                      pf.element_size())


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# kernel versus plain version
# ---------------------------------------------------------------------------
def compare(torch, name: str, got, want, tol) -> float:
    """Max |got - want|; int tensors must be equal, float within ``tol``
    (a scalar or one bound per element)."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: shape/dtype {tuple(got.shape)}/{got.dtype} vs "
          f"{tuple(want.shape)}/{want.dtype}")
    if not got.dtype.is_floating_point:
        diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        check(bool(torch.equal(got, want)), f"{name}: not bitwise equal "
              f"(max |diff| {err})")
        return err
    diff = (got.double() - want.double()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    tol_t = torch.as_tensor(tol, dtype=torch.float64, device=diff.device)
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    check(bool((diff <= tol_t).all()), f"{name}: max |diff| {err} above the "
          "stated tolerance")
    return err


def join_tolerance(torch, pf, cf):
    """Float FreqJoin: the plain version takes differences of a prefix sum
    over the whole sorted child in the frequencies' dtype, so each result
    carries the rounding of that prefix: bound 4·eps·Σ|cf|·|pf|, eps of
    float32 or float64.  Zero for ints."""
    if not pf.dtype.is_floating_point:
        return 0.0
    eps = torch.finfo(pf.dtype).eps
    return 4 * eps * float(cf.abs().double().sum()) * pf.abs().double()


def segsum_tolerance(torch, plain_ss, keys, vals):
    """Float segment sum: both versions add a run in different orders, so
    a run's total may differ by len·eps·Σ|v| over the run, eps of float32
    or float64.  Zero for ints."""
    if not vals.dtype.is_floating_point:
        return 0.0
    abs_sum, _ = plain_ss(keys, vals.abs())
    length, _ = plain_ss(keys, torch.ones_like(vals))
    eps = torch.finfo(vals.dtype).eps
    return 2 * eps * length.double() * abs_sum.double()


def hold_join(torch, plain, errs, tag, got, pk, pf, ck, cf):
    """Hold a K1/K2 output ``got`` against the plain version's on the same
    inputs."""
    want = plain(pk, pf, ck, cf)
    torch.cuda.synchronize()
    errs.append(compare(torch, tag, got, want, join_tolerance(torch, pf, cf)))
    return got


def check_join(torch, kern, plain, errs, tag, pk, pf, ck, cf):
    return hold_join(torch, plain, errs, tag, kern(pk, pf, ck, cf),
                     pk, pf, ck, cf)


def isin_ms(torch, i, pk, pf, ck, cf) -> float:
    """K1's library yardstick: ``torch.isin(pk, ck)`` at the call's shapes
    (the membership test at the semi-join's core, without the live filter
    and the multiply), timed; the same call on the live child keys, times
    ``pf``, is held against the plain semi-join first."""
    from repro_torch.kernels.semi_join import semi_join_plain
    got = pf * torch.isin(pk, ck[cf > 0]).to(pf.dtype)
    compare(torch, f"torch.isin semi_join call {i}", got,
            semi_join_plain(pk, pf, ck, cf), 0.0)
    return time_ms(torch, lambda: torch.isin(pk, ck))


def phase_line(torch, fj, kernel, wrapper, plain, name, i, mode,
               args) -> dict:
    """Fill/build/probe(/gather) of one main-path K1/K2 call by CUDA events
    between the phases (device time, queued), and the whole wrapper call,
    unqueued (``ms``, host launch included) and queued (``device_ms``),
    after the phase-by-phase answer is held against the plain version.  The
    table and output are allocated once (``freq_join.prepare_call``); each
    step launches one phase of the C entry (the shared path has one)."""
    pk, pf, ck, cf = args
    path, table, out = fj.prepare_call(pf, ck.shape[0], mode)
    names = {"shared": ("shared",), "child": ("fill", "build", "probe"),
             "parent": ("fill", "build", "probe", "gather")}[path.side]
    bits = {"shared": fj.ALL_PHASES, "fill": fj.FILL, "build": fj.BUILD,
            "probe": fj.PROBE, "gather": fj.GATHER}
    steps = [lambda b=bits[n]: fj.launch_phases(kernel, path, mode, pk, pf,
                                                ck, cf, table, out, b)
             for n in names]
    for step in steps:
        step()
    torch.cuda.synchronize()
    compare(torch, f"{name} call {i} phase by phase", out, plain(*args),
            join_tolerance(torch, pf, cf))
    phases = split_ms(torch, steps, queued=True)
    return {"phases": name, "index": i, "shape": [pk.shape[0], ck.shape[0]],
            "side": path.side, "slots": path.slots,
            "table_bytes": 0 if table is None else 4 * table.numel(),
            **{f"{n}_ms": statistics.median(t)
               for n, t in zip(names, phases)},
            "device_ms": time_ms(torch, lambda: wrapper(*args), queued=True),
            "ms": time_ms(torch, lambda: wrapper(*args))}


def cutoff_lines(torch, fj, kernels, dev) -> list[dict]:
    """Both sides of each of ``join_path``'s choices near where it flips,
    forced on the same inputs: the shared path against the child side for
    children of 512 to 2048 rows under parents of 100k and 8M rows (V.1's
    supplier and partsupp), and the parent side against the child side at
    equal lengths (2M × 2M).  Keys are uniform over twice the child's length.
    Each forced path's answer is held bitwise against the plain version;
    its whole call is timed unqueued (``ms``) and queued (``device_ms``)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    i32 = torch.int32

    def draw(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=i32)

    cases = [(np_, nc, ("shared", "child")) for np_ in (100_000, 8_000_000)
             for nc in (512, 1024, 2048)]
    lines = []
    for np_, nc, sides in cases + [(2_000_000, 2_000_000,
                                    ("child", "parent"))]:
        pk, ck = draw(0, 2 * nc, np_), draw(0, 2 * nc, nc)
        pf, cf = draw(0, 4, np_), draw(-2, 4, nc)
        for name, mode in (("semi_join", "any"), ("freq_join", "sum")):
            kernel = kernels[name][2]
            want = fj.freq_join_plain(pk, pf, ck, cf, mode=mode)
            line = {"cutoff": name, "shape": [np_, nc],
                    "chosen": fj.join_path(np_, nc).side}
            for side in sides:
                forced = fj.JoinPath(side, fj.table_slots(
                    np_ if side == "parent" else nc))
                path, table, out = fj.prepare_call(pf, nc, mode, forced)

                def step(path=path, table=table, out=out):
                    fj.launch_phases(kernel, path, mode, pk, pf, ck, cf,
                                     table, out, fj.ALL_PHASES)
                step()
                torch.cuda.synchronize()
                compare(torch, f"{name} cutoff {np_}x{nc} {side} side", out,
                        want, 0.0)
                line[f"{side}_ms"] = time_ms(torch, step)
                line[f"{side}_device_ms"] = time_ms(torch, step, queued=True)
            lines.append(line)
    return lines


def check_segsum(torch, kern, plain, errs, tag, keys, vals, exact=False):
    """``exact``: float32 values whose every partial sum is exact (integers
    below 2^24 in magnitude), so the sums are held bitwise."""
    hold_segsum(torch, plain, errs, tag, kern(keys, vals), keys, vals, exact)


def hold_segsum(torch, plain, errs, tag, got, keys, vals, exact=False):
    """Hold a K3 output ``got`` = (sums, valid) against the plain
    version's on the same inputs."""
    got_s, got_v = got
    want_s, want_v = plain(keys, vals)
    torch.cuda.synchronize()
    errs.append(compare(torch, tag + " valid", got_v, want_v, 0.0))
    tol = 0.0 if exact else segsum_tolerance(torch, plain, keys, vals)
    errs.append(compare(torch, tag + " sums", got_s, want_s, tol))


def segsum_cases(torch, ss, errs, dev) -> list[dict]:
    """K3 cases the join-derived ones miss, held against the plain version:
    at 8M rows one key over all rows (every tile but the first walks back
    through tiles with no run start) and every row its own run (no tile
    walks back), int32 over the whole int32 range and float32 of integer
    values in {-1, 0, 1}, whose partial sums stay exact below 2^24, so both
    are held bitwise (a lost carry shows), each timed (device ms, queued);
    and views at storage offsets 1-3 (not 16-byte aligned: the kernel's
    scalar path) of lengths tile-1, tile and tile+1, checked only.  Returns one ``segsum_case`` line per timed case."""
    rng = np.random.default_rng(SEED + 3)
    n = 8_000_000
    lines = []
    for tag, keys in (("one key", torch.full((n,), 7, dtype=torch.int32,
                                            device=dev)),
                      ("every row a run", torch.arange(
                          n, dtype=torch.int32, device=dev))):
        line = {"segsum_case": tag, "shape": [n],
                "bound_ms": bound_ms(segsum_bytes(n))}
        for dt, vals in (("int32", rng.integers(-2**31, 2**31, n,
                                                dtype=np.int32)),
                         ("float32", rng.integers(-1, 2, n)
                          .astype(np.float32))):
            v = torch.tensor(vals, device=dev)
            check_segsum(torch, ss.segment_sum_cuda, ss.segment_sum_plain,
                         errs, f"segment_sum {tag} {dt}", keys, v,
                         exact=True)
            line[f"{dt}_device_ms"] = time_ms(
                torch, lambda: ss.segment_sum_cuda(keys, v), queued=True)
        lines.append(line)
    for off in (1, 2, 3):
        for m in (ss.TILE - 1, ss.TILE, ss.TILE + 1):
            kb = torch.tensor(np.sort(rng.integers(0, m // 40 + 2, m + 3))
                              .astype(np.int32), device=dev)
            for dt in (np.int32, np.float32):
                vb = torch.tensor(rng.integers(-9, 9, m + 3).astype(dt),
                                  device=dev)
                check_segsum(torch, ss.segment_sum_cuda,
                             ss.segment_sum_plain, errs,
                             f"segment_sum offset {off} length {m}",
                             kb[off:off + m], vb[off:off + m])
    return lines


def synthetic_cases(torch, make_graph_db, dev):
    """Ragged sizes; key −1 (the hash table's empty marker, kept in a side
    slot) in the parent, the child, both and neither, with int32's minimum
    and maximum beside it, on each path of the hash join; repeated parent
    keys with the table on the parent side; an empty parent and an empty
    child; int32 wrap-around and a zipf-skewed key column from
    ``make_graph_db``, each with the table on either side.  The lengths
    pick the path (``freq_join.join_path``): a child of at most 1024 rows
    is built in shared memory, else the shorter side is."""
    rng = np.random.default_rng(SEED + 1)
    i32 = np.iinfo(np.int32)
    cases = []
    for np_, nc in ((1, 1), (1000, 37), (4097, 1023), (100_003, 7),
                    (37, 262_147)):
        pk = rng.integers(-50, 50, np_).astype(np.int32)
        ck = rng.integers(-50, 50, nc).astype(np.int32)
        pk[: min(3, np_)] = [i32.min, i32.max, -1][: min(3, np_)]
        ck[: min(3, nc)] = [i32.max, -1, i32.min][: min(3, nc)]
        cases.append((f"ragged {np_}x{nc}", pk, ck,
                      rng.integers(0, 4, np_), rng.integers(-2, 4, nc)))
    for side, (np_, nc) in (("shared", (5000, 1000)),
                            ("child", (70_001, 50_000)),
                            ("parent", (50_000, 70_001))):
        for where in ("neither", "parent", "child", "both"):
            pk = rng.integers(-50, 50, np_).astype(np.int32)
            ck = rng.integers(-50, 50, nc).astype(np.int32)
            pf, cf = rng.integers(0, 4, np_), rng.integers(-2, 4, nc)
            pk[pk == -1] = 0
            ck[ck == -1] = 0
            if where in ("parent", "both"):
                pk[::97] = -1
                pf[0] = 2
            if where in ("child", "both"):
                ck[::89] = -1
                cf[::89] = rng.integers(1, 4, cf[::89].shape[0])  # live
            pk[1:3] = [i32.min, i32.max]
            ck[1:3] = [i32.max, i32.min]
            cases.append((f"key -1 in {where}, {side} side {np_}x{nc}", pk,
                          ck, pf, cf))
    cases.append(("repeated parent keys, parent side 30000x70001",
                  rng.integers(0, 10, 30_000).astype(np.int32),
                  rng.integers(0, 20, 70_001).astype(np.int32),
                  rng.integers(0, 4, 30_000), rng.integers(-2, 4, 70_001)))
    cases.append(("empty parent 0x100", np.zeros(0, np.int32),
                  rng.integers(0, 9, 100).astype(np.int32),
                  np.zeros(0, np.int64), rng.integers(0, 4, 100)))
    cases.append(("empty child 100x0", rng.integers(0, 9, 100).astype(
        np.int32), np.zeros(0, np.int32), rng.integers(0, 4, 100),
        np.zeros(0, np.int64)))
    # int32 wrap-around: frequencies over the whole int32 range
    for np_, nc in ((50_000, 70_001), (70_001, 50_000)):
        cases.append((f"wrap {np_}x{nc}",
                      rng.integers(0, 64, np_).astype(np.int32),
                      rng.integers(0, 64, nc).astype(np.int32),
                      rng.integers(i32.min, i32.max, np_),
                      rng.integers(i32.min, i32.max, nc)))
    db, _ = make_graph_db(1 << 20, 1 << 22, seed=SEED, device=dev)
    src = db["edge"].columns["src"].cpu().numpy()    # zipf-skewed
    dst = db["edge"].columns["dst"].cpu().numpy()
    pf = rng.integers(0, 4, dst.shape[0])
    cf = rng.integers(0, 4, src.shape[0])
    cases.append(("zipf child side", dst, src, pf, cf))
    cases.append(("zipf parent side", dst[:-1], src, pf[:-1], cf))
    out = []
    for tag, pk, ck, pf, cf in cases:
        t = [torch.tensor(a, device=dev) for a in (pk, ck)]
        for dt in (torch.int32, torch.float32):
            if tag.startswith("wrap") and dt == torch.float32:
                continue
            npdt = np.int32 if dt == torch.int32 else np.float32
            out.append((f"{tag} {str(dt)[6:]}", t[0],
                        torch.tensor(pf.astype(npdt), device=dev),
                        t[1], torch.tensor(cf.astype(npdt), device=dev)))
        if tag == "ragged 1000x37":
            # real-valued float32 frequencies
            out.append((f"{tag} float32 real", t[0],
                        torch.tensor(rng.random(pk.shape[0], np.float32) * 3,
                                     device=dev),
                        t[1],
                        torch.tensor(rng.random(ck.shape[0], np.float32) * 3
                                     - 1, device=dev)))
    return out


def kernel_calls(torch, calls, kern, plain, errs, key="call",
                 extra=None) -> dict:
    """Each recorded call of each kernel (``calls[name]``, a list of its
    arguments) held against the plain version on the same inputs and timed:
    one JSON line per call under ``key``, with ``extra`` merged in, beside
    its bytes bound at the call's dtypes (K1 also beside ``torch.isin``, K3
    beside ``torch.cumsum``).  Returns the sums over each kernel's calls."""
    timing = {name: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                     "bytes": 0, "library_ms": None} for name in calls}
    timing["semi_join"]["library_ms"] = 0.0
    for name, cl in calls.items():
        check(len(cl) > 0, f"main path made no {name} call")
        for i, args in enumerate(cl):
            tag = f"{name} {key} {i}"
            if name == "segment_sum":
                check_segsum(torch, kern[name], plain[name], errs[name], tag,
                             *args)
                shape = [args[0].shape[0]]
            else:
                check_join(torch, kern[name], plain[name], errs[name], tag,
                           *args)
                shape = [args[0].shape[0], args[2].shape[0]]
            nbytes = call_bytes(name, args)
            k_ms = time_ms(torch, lambda: kern[name](*args))
            kd_ms = time_ms(torch, lambda: kern[name](*args), queued=True)
            p_ms = time_ms(torch, lambda: plain[name](*args))
            timing[name]["ms"] += k_ms
            timing[name]["device_ms"] += kd_ms
            timing[name]["plain_ms"] += p_ms
            timing[name]["bytes"] += nbytes
            line = {key: name, "index": i, "shape": shape, "ms": k_ms,
                    "device_ms": kd_ms, "plain_ms": p_ms,
                    "bound_ms": bound_ms(nbytes), **(extra or {})}
            if name == "semi_join":
                line["library_ms"] = isin_ms(torch, i, *args)
                timing[name]["library_ms"] += line["library_ms"]
            if name == "segment_sum":
                v = args[1]
                line["cumsum_ms"] = time_ms(
                    torch, lambda: torch.cumsum(v, 0, dtype=v.dtype),
                    queued=True)
            log(json.dumps(line))
    return timing


# ---------------------------------------------------------------------------
# the numpy oracle of V.1
# ---------------------------------------------------------------------------
def v1_oracle(h, regions=(2, 3), price_threshold=1200.0):
    """V.1 over host copies of the tables, with no code of the port.

    Every partsupp row joins one part, one supplier, one nation and one
    region, so a partsupp row survives iff its part passes the price filter
    and its supplier's nation lies in a selected region."""
    live_rk = h["region"]["r_regionkey"][np.isin(h["region"]["r_name"],
                                                 regions)]
    live_nk = h["nation"]["n_nationkey"][np.isin(h["nation"]["n_regionkey"],
                                                 live_rk)]
    s_key = h["supplier"]["s_suppkey"]
    live_sk = s_key[np.isin(h["supplier"]["s_nationkey"], live_nk)]
    live_pk = h["part"]["p_partkey"][h["part"]["p_price"] > price_threshold]
    ps = h["partsupp"]
    ok = np.isin(ps["ps_partkey"], live_pk) & np.isin(ps["ps_suppkey"],
                                                      live_sk)
    count = int(ok.sum())
    # surviving partsupp rows per supplier, read in supplier row order
    sk_sorted = np.sort(ps["ps_suppkey"][ok])
    per_supp = (np.searchsorted(sk_sorted, s_key, side="right")
                - np.searchsorted(sk_sorted, s_key, side="left"))
    has = per_supp > 0
    bal = h["supplier"]["s_acctbal"][has]
    w = per_supp[has].astype(np.int64)
    order = np.argsort(bal, kind="stable")
    cw = np.cumsum(w[order])
    # lower weighted median: first value whose cumulative weight reaches
    # half the total, i.e. 2·cw >= total
    median = bal[order][np.searchsorted(2 * cw, cw[-1], side="left")]
    return {"minmax": {"min(bal)": bal.min(), "max(bal)": bal.max()},
            "count": {"count(*)": count},
            "median": {"median(bal)": median}}


def profile_rows(torch, fn, arg):
    """Profiled wall ms of one run of ``fn(arg)`` (after one unprofiled
    run), its device time by kernel name from ``torch.profiler``, as
    (name, ms, launches) largest first: device-side events only (a CPU
    op's row repeats the time of the kernels it launched), and the
    profiler's averages by event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(arg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(arg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((ev.key, ev.self_device_time_total / 1e3, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0),
                  key=lambda r: -r[1])
    return wall_ms, rows, prof.key_averages()


def profile_run(torch, fn, db) -> dict:
    """Device time by kernel name over one run of ``fn(db)``
    (``profile_rows``).  The idle share is the part of the profiled run's
    wall time with no device work recorded, profiler overhead included."""
    wall_ms, rows, _ = profile_rows(torch, fn, db)
    busy_ms = sum(r[1] for r in rows)
    return {"profiled_wall_ms": wall_ms, "device_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            "top": [[k[:60], ms, n] for k, ms, n in rows[:8]]}


def took_every_path(kernels, joins, sides, run: str) -> dict:
    """The launches of each hash-join path per kernel since the counts were
    last reset; fails unless every path was taken."""
    paths = {name: dict(kernels[name][2].paths) for name, _ in joins}
    for name, _ in joins:
        for side in sides:
            check(paths[name].get(side, 0) > 0,
                  f"{run} took no {side} path of {name}")
    return paths


def answers_equal(got: dict, want: dict, dtypes: dict | None = None) -> bool:
    """Every answer of ``want`` equals ``got``'s, a scalar, and where
    ``dtypes`` names its dtype, is of that dtype."""
    for k, v in want.items():
        if dtypes is not None and got[k].dtype != dtypes[k]:
            return False
        g = got[k].cpu().numpy()
        if g.shape != () or g.item() != np.asarray(v).item():
            return False
    return True


@contextlib.contextmanager
def routed(kernels, hook):
    """While the block runs, each kernel's wrapper, looked up on its module
    at call time, goes through ``hook(name, wrapper, args, **kw)``, ``kw``
    the call's keywords (its ``config``)."""
    originals = {name: getattr(mod, attr)
                 for name, (mod, attr, _) in kernels.items()}
    for name, (mod, attr, _) in kernels.items():
        setattr(mod, attr, lambda *args, name=name, **kw: hook(
            name, originals[name], args, **kw))
    try:
        yield
    finally:
        for name, (mod, attr, _) in kernels.items():
            setattr(mod, attr, originals[name])


def copied(x, device):
    """A tensor, or a tuple of them, copied to ``device``."""
    if isinstance(x, tuple):
        return tuple(copied(t, device) for t in x)
    return x.to(device)


def hold_calls(torch, plain, errs, tag, seen, dev) -> dict:
    """Hold each recorded kernel call's output against the plain version on
    the card, on the same inputs (int32 bitwise, float32 within the stated
    bounds); returns the calls held per kernel."""
    held = {}
    for name, args, out in seen:
        i = held[name] = held.get(name, 0) + 1
        hold = hold_segsum if name == "segment_sum" else hold_join
        hold(torch, plain[name], errs[name], f"{tag} {name} call {i - 1}",
             copied(out, dev), *copied(args, dev))
    return held


# ---------------------------------------------------------------------------
# the materialising baselines
# ---------------------------------------------------------------------------
def measured(torch, kernels, plain, errs, tag, fn, dev,
             reps: int = BASELINE_REPS):
    """``fn()`` once, with every kernel's counts set to 0 just before it and
    read just after, and the device memory it allocates above what was live
    before it (``max_memory_allocated``); then ``reps`` more calls, each
    timed on the host's clock to ``torch.cuda.synchronize()``.  Every kernel
    call of the first run is recorded (inputs and output copied to the
    host, so the record holds no device memory) and afterwards held against
    the plain version.  Returns the first call's result and a line with the
    launches, the calls held, ``peak_bytes`` and the median ``ms``."""
    seen = []

    def keep(name, wrapper, args, **kw):
        out = wrapper(*args, **kw)
        seen.append((name, copied(args, "cpu"), copied(out, "cpu")))
        return out

    for _, _, k in kernels.values():
        k.reset_counts()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with routed(kernels, keep):
        out = fn()
    torch.cuda.synchronize()
    line = {"peak_bytes": torch.cuda.max_memory_allocated() - base,
            "launches": {name: k.launches
                         for name, (_, _, k) in kernels.items()}}
    line["held"] = hold_calls(torch, plain, errs, tag, seen, dev)
    for name, n in line["launches"].items():
        check(n == 0 or line["held"].get(name, 0) > 0,
              f"{tag}: {name} launched {n} times, no call held")
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    line["ms"] = statistics.median(ms)
    return out, line


def largest_join(steps) -> int:
    return max((n for name, n in steps if name.startswith("join(")),
               default=0)


def baseline_lines(torch, tc, kernels, plain, errs, db, schema, plans,
                   oracle, tpch_v1_query, dev) -> list[dict]:
    """V.1 under Ref and Opt, with and without FK/PK degradation, through
    ``Executor.execute``: answers held against the numpy oracle, steps
    against the JAX package's and each kernel call against its plain
    version, with one ``torch.profiler`` run of each; beside each, the
    query's 0MA/Opt⁺ plan."""
    lines = []
    ex = tc.Executor(db, schema)
    for q in QUERIES:
        res, fast = measured(torch, kernels, plain, errs,
                             f"baseline {q} {plans[q].mode}",
                             lambda: ex.execute(plans[q]), dev)
        check(answers_equal(res, oracle[q]), f"{q} {plans[q].mode}: {res}")
        fast.update(mode=plans[q].mode,
                    peak_tuples=res["__stats__"].peak_tuples)
        for mode, fkpk in BASELINE_MODES:
            plan = tc.plan_query(tpch_v1_query(q), schema, mode=mode,
                                 use_fkpk=fkpk)
            tag = f"baseline {q} {mode} use_fkpk={fkpk}"
            res, line = measured(torch, kernels, plain, errs, tag,
                                 lambda: ex.execute(plan), dev)
            steps = res["__stats__"].steps
            check(answers_equal(res, oracle[q]),
                  f"{tag}: {res} != {oracle[q]}")
            check(steps == V1_BASELINE_STEPS[q, mode, fkpk],
                  f"{tag}: steps {steps}")
            prof = profile_run(torch, lambda _: ex.execute(plan), db)
            lines.append({
                "baseline": q, "mode": mode, "use_fkpk": fkpk,
                "answer": {k: np.asarray(v).item()
                           for k, v in oracle[q].items()},
                "peak_tuples": res["__stats__"].peak_tuples,
                "largest_join": largest_join(steps), **line,
                "profile": {**prof, "top": prof["top"][:4]},
                "zero_materialisation": fast})
    return lines


def wrap32(n: int) -> int:
    return (n + 2**31) % 2**32 - 2**31


def path_oracle(src, dst, k: int, guard: int, wrap: bool = True):
    """Fig. 6's path-k row by numpy on one edge list, independent of the
    port.  The Ref plan roots at e0 and joins e1, ..., ek onto it in turn,
    so its j-th join holds the (j+1)-edge paths; the Opt plan joins e(k-1),
    ..., e0 onto the leaf's rows in turn and regroups each join to the
    parent's distinct (src, dst) pairs; Opt⁺ holds no more than one scanned
    relation.  Returns (peak per mode, None where the guard trips; the
    tuples the guard refused, or None; COUNT(*) at int32, or unwrapped
    with ``wrap=False``)."""
    n = int(max(src.max(), dst.max())) + 1
    outdeg = np.bincount(src, minlength=n).astype(np.int64)
    paths = np.bincount(dst, minlength=n).astype(np.int64)  # 1-edge paths
    ref_peak, refused = len(src), None
    for _ in range(k):
        total = int(paths @ outdeg)      # paths one edge longer, by end
        if refused is None and total > guard:
            refused = total
        ref_peak = max(ref_peak, total)
        longer = np.zeros(n, np.int64)
        np.add.at(longer, dst, paths[src])
        paths = longer
    pairs = src.astype(np.int64) * n + dst
    opt_peak, child_src = len(src), src
    for _ in range(k):
        matches = np.bincount(child_src, minlength=n)[dst]
        kept = np.unique(pairs[matches > 0])
        opt_peak = max(opt_peak, int(matches.sum()), kept.size)
        child_src = kept // n
    peaks = {"ref": None if refused else ref_peak, "opt": opt_peak,
             "opt_plus": len(src)}
    return peaks, refused, wrap32(total) if wrap else total


def fig6_lines(torch, tc, data, kernels, plain, errs, dev,
               freq_dtype=None, same_as=None) -> list[dict]:
    """Fig. 6's rows at the JAX package's sizes under ``oom_guard``: each
    peak, guard trip and COUNT as ``path_oracle`` gives them for the path
    rows and as ``FIG6_STATS_ROW`` gives them for stats-full, and each
    kernel call against its plain version.  A trip must come before the
    refused expansion is allocated: the device memory the run allocated
    stays below the bytes of a row index and a frequency (12 or 16) for
    each refused tuple.  ``freq_dtype`` torch.int64 runs the rows in 64 bits: each COUNT
    is then ``path_oracle``'s unwrapped, in int64, and each peak and guard
    trip must equal the row of ``same_as`` (the int32 lines) of its query
    and mode."""
    wide = freq_dtype is not None
    freq_dtype = freq_dtype or torch.int32
    graph = data.make_graph_db(**FIG6_GRAPH, device=dev)
    stats_db = data.make_stats_db(**FIG6_STATS, device=dev)
    src, dst = (graph[0]["edge"].columns[c].cpu().numpy()
                for c in ("src", "dst"))
    lines = [{"fig6_data": {"numpy": np.__version__}}]
    cases = [(f"path-{k}", graph, data.path_query(k),
              (FIG6_GRAPH["n_edges"],
               *path_oracle(src, dst, k, FIG6_GUARD, wrap=not wide)))
             for k in (2, 3, 4)]
    earlier = {(r["fig6"], r["mode"]): r for r in same_as or () if "fig6" in r}
    base_max, peaks, count = FIG6_STATS_ROW
    cases.append(("stats-full", stats_db, data.stats_count_query(),
                  (base_max, peaks, None, count)))
    for name, (db, schema), query, want in cases:
        base_max, peaks, refused_want, count = want
        got_base = max(int(t.live_count()) for t in db.values())
        check(got_base == base_max, f"fig6 {name}: base max {got_base}")
        ex = tc.Executor(db, schema, freq_dtype=freq_dtype,
                         oom_guard=FIG6_GUARD)
        got, counts = {}, {}
        for mode in FIG6_MODES:
            plan = tc.plan_query(query, schema, mode=mode)

            def run(plan=plan):
                stats = tc.ExecStats()
                try:
                    return ex.execute(plan, stats), stats
                except tc.MaterialisationLimit as err:
                    return err, stats

            tag = f"fig6 {name} {mode}" + (" x64" if wide else "")
            (out, stats), line = measured(torch, kernels, plain, errs, tag,
                                          run, dev)
            row = {"fig6": name, "mode": mode, "base_max": base_max,
                   "freq_dtype": str(freq_dtype)[6:]}
            if peaks[mode] is None:
                check(isinstance(out, tc.MaterialisationLimit),
                      f"{tag}: the guard did not trip")
                refused = int(re.search(r"would materialise (\d+) tuples",
                                        str(out)).group(1))
                check(refused_want in (None, refused),
                      f"{tag}: refused {refused}, oracle {refused_want}")
                check(line["peak_bytes"] < (8 + freq_dtype.itemsize)
                      * refused, f"{tag}: {line['peak_bytes']} bytes "
                      f"allocated before the guard refused {refused} tuples")
                row.update(peak_tuples=None, guard_trip=refused,
                           steps_before_trip=stats.steps)
            else:
                check(isinstance(out, dict), f"{tag}: {out}")
                got[mode] = stats.peak_tuples
                check(got[mode] == peaks[mode], f"{tag}: peak {got[mode]}")
                check(out["count(*)"].dtype == freq_dtype,
                      f"{tag}: COUNT dtype {out['count(*)'].dtype}")
                counts[mode] = int(out["count(*)"])
                row.update(peak_tuples=got[mode], count=counts[mode])
            if earlier:
                same = earlier[name, mode]
                check(all(row.get(k) == same.get(k) for k in (
                    "peak_tuples", "guard_trip", "steps_before_trip")),
                      f"{tag}: peak or trip differs from the int32 run's")
            lines.append({**row, **line})
        check(got["opt_plus"] <= base_max, f"fig6 {name}: Opt⁺ above base")
        check(set(counts.values()) == {count}, f"fig6 {name}: {counts}")
    return lines


# ---------------------------------------------------------------------------
# 64-bit frequencies: the JAX package's x64 setting
# ---------------------------------------------------------------------------
# benchmarks/graph_counting.py's Table 2 run, float64 frequencies: its
# graph, its queries and its guard (OOM_GUARD)
TABLE2_GRAPH = {"n_nodes": 20_000, "n_edges": 200_000, "seed": 0}
TABLE2_QUERIES = (("path-3", "path", 3), ("path-4", "path", 4),
                  ("path-5", "path", 5), ("tree-1", "tree", 1),
                  ("tree-2", "tree", 2), ("tree-3", "tree", 3))
TABLE2_GUARD = 20_000_000
# A float64 COUNT past 2^53 is rounded, and the card and the CPU add in
# other orders: each edge's sums round by at most eps per add, at most
# 2·10^5 adds (the edge relation's rows) on each of at most 6 edges and
# the final sum, 1.4·10^6 · 1.1·10^-16 ≈ 1.6·10^-10 of the count.
F64_COUNT_RTOL = 1e-9
JOINS = (("semi_join", "any"), ("freq_join", "sum"))


def x64_v1_lines(torch, tc, fj, kernels, kern, plain, errs, db, schema,
                 plans, oracle, main_steps, tpch_v1_query, card, dev):
    """V.1 at the main path's scale with int64 frequencies.  First each
    kernel call of one pass is recorded, held against its plain version
    and timed (``call_x64`` lines, bytes bound at the calls' dtypes).  Then
    the counted run: every kernel's counts set to 0, each query's 0MA/Opt⁺
    plan through ``execute`` and ``compile``, its answers equal to the
    oracle in the reference's x64 dtypes (COUNT int64, MIN/MAX/MEDIAN the
    value column's float32), its steps and peak equal to the int32 run's,
    every hash-join path taken; the counts read just after.  Last, Ref and
    Opt (± FK/PK) through ``execute``, each kernel call held.  Returns the
    lines, the timing per kernel, the counted launches and the calls timed
    per kernel."""
    i64 = torch.int64
    bal = db["supplier"].columns["s_acctbal"].dtype
    dtypes = {q: {k: i64 if k == "count(*)" else bal for k in oracle[q]}
              for q in QUERIES}
    calls = {name: [] for name in kernels}

    def keep(name, wrapper, args, **kw):
        calls[name].append(args)
        return wrapper(*args, **kw)

    with routed(kernels, keep):
        for q in QUERIES:
            tc.Executor(db, schema, freq_dtype=i64).execute(plans[q])
    torch.cuda.synchronize()
    timing = kernel_calls(torch, calls, kern, plain, errs, "call_x64",
                          {"freq_dtype": "int64", **card})
    calls_timed = {name: len(cl) for name, cl in calls.items()}
    calls.clear()

    for _, _, k in kernels.values():
        k.reset_counts()
    lines = []
    for q in QUERIES:
        before = {name: k.launches for name, (_, _, k) in kernels.items()}
        ex = tc.Executor(db, schema, freq_dtype=i64)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ex.execute(plans[q])
        torch.cuda.synchronize()
        exec_ms = (time.perf_counter() - t0) * 1e3
        fn = ex.compile(plans[q])
        run_ms = []
        for _ in range(COMPILED_RUNS):
            t0 = time.perf_counter()
            out = fn(db)
            torch.cuda.synchronize()
            run_ms.append((time.perf_counter() - t0) * 1e3)
        tag = f"x64 {q} {plans[q].mode}"
        check(answers_equal(res, oracle[q], dtypes[q]),
              f"{tag} execute: {res} != {oracle[q]}")
        check(answers_equal(out, oracle[q], dtypes[q]),
              f"{tag} compile: {out} != {oracle[q]}")
        check(res["__stats__"].steps == main_steps[q],
              f"{tag}: steps {res['__stats__'].steps}")
        lines.append({
            "query_x64": q, "mode": plans[q].mode, "freq_dtype": "int64",
            "answer": {k: np.asarray(v).item() for k, v in oracle[q].items()},
            "dtypes": {k: str(v)[6:] for k, v in dtypes[q].items()},
            "execute_ms": exec_ms, "compiled_ms": run_ms,
            "peak_live_tuples": res["__stats__"].peak_tuples,
            "launches": {name: k.launches - before[name]
                         for name, (_, _, k) in kernels.items()}, **card})
    launches = {name: k.launches for name, (_, _, k) in kernels.items()}
    for name, n in launches.items():
        check(n > 0, f"the 64-bit main path launched {name} no time")
    paths = took_every_path(kernels, JOINS, fj.SIDES, "the 64-bit main path")
    for line, q in zip(lines, QUERIES):
        fn = tc.Executor(db, schema, freq_dtype=i64).compile(plans[q])
        prof = profile_run(torch, fn, db)
        line.update(device_ms=prof["device_ms"],
                    profile={**prof, "top": prof["top"][:4]})
    lines.append({"main_path_x64_launches": launches, "paths": paths,
                  **card})

    ex = tc.Executor(db, schema, freq_dtype=i64)
    for q in QUERIES:
        for mode, fkpk in BASELINE_MODES:
            plan = tc.plan_query(tpch_v1_query(q), schema, mode=mode,
                                 use_fkpk=fkpk)
            tag = f"x64 baseline {q} {mode} use_fkpk={fkpk}"
            res, line = measured(torch, kernels, plain, errs, tag,
                                 lambda: ex.execute(plan), dev)
            steps = res["__stats__"].steps
            check(answers_equal(res, oracle[q], dtypes[q]),
                  f"{tag}: {res} != {oracle[q]}")
            check(steps == V1_BASELINE_STEPS[q, mode, fkpk],
                  f"{tag}: steps {steps}")
            lines.append({"baseline_x64": q, "mode": mode,
                          "use_fkpk": fkpk, "freq_dtype": "int64",
                          "peak_tuples": res["__stats__"].peak_tuples,
                          "largest_join": largest_join(steps), **line,
                          **card})
    return lines, timing, launches, calls_timed


def table2_lines(torch, tc, data, kernels, plain, errs, dev, card):
    """Table 2 (``benchmarks/graph_counting.py``) in float64 at the
    benchmark's own size: path-3/4/5 and tree-1/2/3, Opt⁺ through
    ``compile``, Ref and Opt through ``execute`` under its guard.  The
    card's numpy draws another zipf graph than the JAX package's machine,
    so each run is held against the same Executor on CPU copies of the
    same tables (the plain versions): COUNT equal below 2^53 and within
    ``F64_COUNT_RTOL`` above, steps equal, a guard trip with the same
    message after the same steps; each kernel call held."""
    from repro_torch.tables.table import Table
    gdb, schema = data.make_graph_db(**TABLE2_GRAPH, device=dev)
    cdb = {r: Table({c: t.cpu() for c, t in tab.columns.items()},
                    tab.freq.cpu()) for r, tab in gdb.items()}
    f64 = torch.float64
    lines = [{"table2_data": {"numpy": np.__version__, **TABLE2_GRAPH,
                              "guard": TABLE2_GUARD}}]

    def runner(db, plan):
        ex = tc.Executor(db, schema, freq_dtype=f64, oom_guard=TABLE2_GUARD)
        if plan.mode == "opt_plus":
            fn = ex.jittable().compile(plan)
            return lambda: (fn(db), None)

        def run():
            stats = tc.ExecStats()
            try:
                return ex.execute(plan, stats), stats
            except tc.MaterialisationLimit as err:
                return err, stats
        return run

    for name, kind, k in TABLE2_QUERIES:
        query = data.path_query(k) if kind == "path" else data.tree_query(k)
        counts = {}
        for mode in ("opt_plus", "opt", "ref"):
            plan = tc.plan_query(query, schema, mode=mode)
            tag = f"table2 {name} {mode}"
            want, wstats = runner(cdb, plan)()
            (got, stats), line = measured(torch, kernels, plain, errs, tag,
                                          runner(gdb, plan), dev)
            row = {"table2": name, "mode": mode, "freq_dtype": "float64"}
            if wstats is not None:
                check(stats.steps == wstats.steps, f"{tag}: steps "
                      f"{stats.steps} != the CPU's {wstats.steps}")
            if isinstance(want, tc.MaterialisationLimit):
                check(isinstance(got, tc.MaterialisationLimit) and
                      str(got) == str(want), f"{tag}: {got} != {want}")
                row.update(guard_trip=str(want), steps_before_trip=stats.steps)
            else:
                check(isinstance(got, dict), f"{tag}: {got}")
                c, w = got["count(*)"], float(want["count(*)"])
                check(c.dtype == f64, f"{tag}: COUNT dtype {c.dtype}")
                c = float(c)
                check(c == w if w < 2**53 else
                      abs(c - w) <= F64_COUNT_RTOL * w,
                      f"{tag}: COUNT {c} != the CPU's {w}")
                counts[mode] = c
                row.update(count=c, cpu_count=w, peak_tuples=None
                           if stats is None else stats.peak_tuples)
            lines.append({**row, **line, **card})
        top = max(counts.values())
        check(all(abs(c - top) <= F64_COUNT_RTOL * top
                  for c in counts.values()),
              f"table2 {name}: the modes' COUNTs differ: {counts}")
    return lines


def x64_synthetic_lines(torch, fj, ss, kernels, kern, plain, errs, dev,
                        card) -> list[dict]:
    """The 64-bit instances on synthetic cases, held against the plain
    versions: every hash-join path × mode × key dtype (int32, int64) ×
    frequency dtype (int64, float64), with key −1 (the empty marker, in a
    side slot) in the parent, the child, both or neither, the key dtype's
    extremes, for int64 keys keys equal in their low 32 bits (k + 2^32
    beside k), and int64 frequencies over the whole range, whose sums wrap
    past 2^63; parent keys k + 2^32 against child keys k, which must match
    nothing; K3 over each case's sorted child keys; K3 at 8M rows with one
    key and with every row its own run, int64 keys, int64 values over the
    whole range and float64 integers in {-1, 0, 1} (every partial sum
    exact), held bitwise and timed (device ms) beside the 25-byte bound;
    and 8-byte views at an odd storage offset (the scalar path)."""
    rng = np.random.default_rng(SEED + 4)
    i64 = np.iinfo(np.int64)
    for _, _, k in kernels.values():
        k.reset_counts()
    side_hits, n_cases = {}, 0
    shapes = (("shared", (5000, 1000)), ("child", (70_001, 50_000)),
              ("parent", (50_000, 70_001)))
    for side, (np_, nc) in shapes:
        check(fj.join_path(np_, nc).side == side, f"{side}: path")
        for where in ("neither", "parent", "child", "both"):
            for kdt in (np.int32, np.int64):
                info = np.iinfo(kdt)
                pk = rng.integers(-50, 50, np_).astype(kdt)
                ck = rng.integers(-50, 50, nc).astype(kdt)
                pk[pk == -1] = 0
                ck[ck == -1] = 0
                if kdt == np.int64:
                    pk[::3] += np.int64(1) << 32
                    ck[::5] += np.int64(1) << 32
                if where in ("parent", "both"):
                    pk[::97] = -1
                if where in ("child", "both"):
                    ck[::89] = -1
                pk[1:3] = [info.min, info.max]
                ck[1:3] = [info.max, info.min]
                for fdt in (np.int64, np.float64):
                    if where == "neither" and fdt == np.int64:
                        pf = rng.integers(i64.min, i64.max, np_)
                        cf = rng.integers(i64.min, i64.max, nc)
                    else:
                        pf = rng.integers(0, 4, np_).astype(fdt)
                        cf = rng.integers(-2, 4, nc).astype(fdt)
                        cf[ck == -1] = 2
                    t = [torch.tensor(a, device=dev) for a in (pk, pf, ck,
                                                                cf)]
                    tag = (f"x64 {side} key -1 in {where} "
                           f"{np.dtype(kdt).name}/{np.dtype(fdt).name}")
                    for name, _ in JOINS:
                        got = check_join(torch, kern[name], plain[name],
                                         errs[name], f"{name} {tag}", *t)
                        n_cases += 1
                        if where == "both":
                            hits = int(((t[0] == -1) & (got != 0)).sum())
                            side_hits[f"{name} {tag}"] = hits
                            check(hits > 0, f"{name} {tag}: no parent row "
                                  "with key -1 matched through the side slot")
                    check_segsum(torch, ss.segment_sum_cuda,
                                 ss.segment_sum_plain, errs["segment_sum"],
                                 f"segment_sum {tag}",
                                 torch.sort(t[2]).values, t[3])
        pk = torch.tensor(rng.integers(0, 100, np_) + (1 << 32), device=dev)
        ck = torch.tensor(rng.integers(0, 100, nc), device=dev)
        ones = torch.ones(np_, dtype=torch.int64, device=dev)
        for name, _ in JOINS:
            got = check_join(torch, kern[name], plain[name], errs[name],
                             f"{name} x64 {side} low-32-bit aliases", pk,
                             ones, ck, torch.ones_like(ck))
            check(not bool(got.any()), f"{name} {side}: a key k + 2^32 "
                  "matched a key k")
    paths = took_every_path(kernels, JOINS, fj.SIDES,
                            "the 64-bit synthetic cases")
    lines = [{"synthetic_x64": n_cases, "paths": paths,
              "side_slot_hits": side_hits}]
    n = 8_000_000
    for tag, keys in (("one key", torch.full((n,), 7 << 32, dtype=torch.int64,
                                            device=dev)),
                      ("every row a run", torch.arange(
                          n, dtype=torch.int64, device=dev) << 32)):
        line = {"segsum_case_x64": tag, "shape": [n],
                "bound_ms": bound_ms(segsum_bytes(n, 8, 8)), **card}
        for dt, vals in (("int64", rng.integers(i64.min, i64.max, n)),
                         ("float64", rng.integers(-1, 2, n)
                          .astype(np.float64))):
            v = torch.tensor(vals, device=dev)
            check_segsum(torch, ss.segment_sum_cuda, ss.segment_sum_plain,
                         errs["segment_sum"], f"segment_sum {tag} {dt}",
                         keys, v, exact=True)
            line[f"{dt}_device_ms"] = time_ms(
                torch, lambda: ss.segment_sum_cuda(keys, v), queued=True)
            line[f"{dt}_plain_ms"] = time_ms(
                torch, lambda: ss.segment_sum_plain(keys, v))
        lines.append(line)
    for m in (ss.TILE - 1, ss.TILE + 1, 3 * ss.TILE + 5):
        kb = torch.tensor(np.sort(rng.integers(0, m // 40 + 2, m + 1)) << 33,
                          device=dev)
        for dt in (np.int64, np.float64):
            vb = torch.tensor(rng.integers(-9, 9, m + 1).astype(dt),
                              device=dev)
            check_segsum(torch, ss.segment_sum_cuda, ss.segment_sum_plain,
                         errs["segment_sum"], f"segment_sum x64 offset 1 "
                         f"length {m}", kb[1:], vb[1:])
    return lines


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# the serving tier
# ---------------------------------------------------------------------------
SERVE_FROM = """FROM region r, nation n, supplier s, partsupp ps, part p
    WHERE r.r_regionkey = n.n_regionkey AND n.n_nationkey = s.s_nationkey
      AND s.s_suppkey = ps.ps_suppkey AND ps.ps_partkey = p.p_partkey
      AND r.r_name IN (2, 3) AND p.p_price > 1200.0"""
SERVE_FROM_RENAMED = """FROM part pa, supplier su, region re, partsupp pp,
      nation na
    WHERE pa.p_price > 1200.0 AND na.n_nationkey = su.s_nationkey
      AND re.r_regionkey = na.n_regionkey AND pp.ps_partkey = pa.p_partkey
      AND su.s_suppkey = pp.ps_suppkey AND re.r_name IN (3, 2)"""
# V.1 as SQL text (the quickstart's), cold and as a renamed-alias copy
SERVE_SQL = {
    "minmax": (f"SELECT MIN(s.s_acctbal), MAX(s.s_acctbal) {SERVE_FROM}",
               f"SELECT MAX(su.s_acctbal), MIN(su.s_acctbal) "
               f"{SERVE_FROM_RENAMED}"),
    "count": (f"SELECT COUNT(*) {SERVE_FROM}",
              f"SELECT COUNT(*) {SERVE_FROM_RENAMED}"),
    "median": (f"SELECT MEDIAN(s.s_acctbal) {SERVE_FROM}",
               f"SELECT MEDIAN(su.s_acctbal) {SERVE_FROM_RENAMED}"),
}
SERVE_DIMS = """FROM supplier s, nation n, region r
    WHERE s.s_nationkey = n.n_nationkey
      AND n.n_regionkey = r.r_regionkey AND r.r_name IN (2, 3)"""
# the quickstart's dashboard on supplier ⋈ nation ⋈ region, plus V.1 minmax
SERVE_DASHBOARD = [
    f"SELECT MIN(s.s_acctbal), MAX(s.s_acctbal) {SERVE_DIMS}",
    f"SELECT SUM(s.s_acctbal) {SERVE_DIMS}",
    f"SELECT COUNT(*) AS cnt, AVG(s.s_acctbal) AS avg {SERVE_DIMS} "
    "GROUP BY s.s_nationkey",
    SERVE_SQL["minmax"][0],
]
SERVE_STAGES = ("parse", "fingerprint", "plan", "pad", "compile", "run")
SERVE_ASYNC_CALLERS = 8
SERVE_GROWTH_ROWS = 100_000   # appended to partsupp, inside its bucket


def serve_equal(values: dict, want: dict) -> bool:
    """A request's answers against the oracle's, matched by aggregate
    (the request names its columns after its own aliases)."""
    by_func = {k.split("(")[0]: v for k, v in want.items()}
    if len(values) != len(want):
        return False
    for k, v in values.items():
        g = v.cpu().numpy()
        if g.shape != () or g.item() != np.asarray(by_func[
                k.split("(")[0]]).item():
            return False
    return True


def answers_diff(torch, got: dict, want: dict, bounds=None) -> str | None:
    """Where two requests' answers differ, or None: bitwise (grouped
    answers included), but for the columns ``bounds`` names, which may
    differ by the given per-row bound."""
    if set(got) != set(want):
        return f"columns {sorted(got)} != {sorted(want)}"
    for k, g in got.items():
        w = want[k]
        if isinstance(g, dict):
            diff = answers_diff(torch, g, w, bounds)
            if diff is not None:
                return diff
        elif bounds is not None and k in bounds:
            err = (g.double() - w.double()).abs()
            if bool((err > bounds[k]).any()):
                return f"{k}: |diff| {float(err.max())} above its bound"
        elif not torch.equal(g, w):
            bad = (g != w).nonzero()[:3].flatten().tolist()
            return (f"{k}: differs at rows {bad}: {g[bad].tolist()} != "
                    f"{w[bad].tolist()}")
    return None


def grouped_avg_bound(torch, h, res, col: str = "avg") -> dict:
    """The dashboard's AVG(s_acctbal) GROUP BY nation sums each group with
    ``index_add_``, whose adds on the card land in another order on every
    run.  Two orders of a group's n float32 terms differ by at most
    2(n-1)·eps·Σ|x| (Higham, Accuracy and Stability, §4.2), and the
    division by the group's count rounds once more (eps·|avg|).  n and Σ|x|
    per nation come from the host's supplier columns (padded rows add
    exact zeros); every row of a group carries its group's AVG.  Returns
    ``answers_diff``'s bounds for that column."""
    groups = res["groups"]
    sup = h["supplier"]
    n = np.bincount(sup["s_nationkey"], minlength=64)
    s = np.bincount(sup["s_nationkey"],
                    weights=np.abs(sup["s_acctbal"].astype(np.float64)),
                    minlength=64)
    nation = groups["n.n_nationkey"].cpu().numpy()
    avg = groups[col].double().cpu().numpy()
    eps = float(np.finfo(np.float32).eps)
    bound = (2 * np.maximum(n[nation] - 1, 0) * eps * s[nation]
             / np.maximum(n[nation], 1) + eps * np.abs(avg))
    return {col: torch.tensor(bound, device=groups[col].device)}


def served(svc, sql, tag: str):
    """One request through ``QueryService.submit_many``; fails unless it
    is ``ok``."""
    res = svc.submit_many([sql])[0]
    check(res.ok, f"serve {tag}: request failed: {res.error!r}")
    return res


def stage_ms(res) -> dict:
    """Each stage's time from the request's ``TraceSpan`` tree, ms."""
    return {s.name: s.duration_s * 1e3 for s in res.stats.trace.walk()
            if s.name in SERVE_STAGES}


def serve_lines(torch, tc, tsvc, kernels, plain, errs, db, schema, h,
                oracle, dev, card):
    """The serving tier on the card, its kernel counts set to 0 just before
    it and read just after: V.1 as SQL text cold and warm, the tier's host
    cost over ``Executor.compile``, a fused batch, async callers, in-bucket
    growth and a warm start from ``cache_dir``.  Every kernel call is held
    against its plain version on the same inputs after the request that
    made it (outside every timed region).  Yields one line per case."""
    import tempfile
    import threading

    from repro_torch.tables import Table

    pending = []

    def keep(name, wrapper, args, **kw):
        out = wrapper(*args, **kw)
        pending.append((name, args, out))
        return out

    held = {name: 0 for name in kernels}

    def drain(tag):
        torch.cuda.synchronize()
        calls = list(pending)
        pending.clear()
        for name, n in hold_calls(torch, plain, errs, tag, calls,
                                  dev).items():
            held[name] += n

    inf = float("inf")
    for _, _, k in kernels.values():
        k.reset_counts()
    t_phase = time.perf_counter()
    with routed(kernels, keep), \
            tempfile.TemporaryDirectory(prefix="serve-cache-",
                                        dir=Path(__file__).resolve().parent
                                        ) as cache_dir:
        t0 = time.perf_counter()
        svc = tsvc.QueryService(db, schema, cache_dir=cache_dir,
                                async_max_wait_ms=100.0)
        yield {"serve": "setup", "service_s": time.perf_counter() - t0,
               **card}
        # -- cold, then a renamed-alias warm copy ------------------------
        for q, (cold_sql, warm_sql) in SERVE_SQL.items():
            for tag, sql in (("cold", cold_sql), ("warm", warm_sql)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = served(svc, sql, f"{tag} {q}")
                ms = (time.perf_counter() - t0) * 1e3
                drain(f"serve {tag} {q}")
                check(serve_equal(res.values, oracle[q]),
                      f"serve {tag} {q}: {res.values} != {oracle[q]}")
                if tag == "warm":
                    check(res.stats.plan_cache_hit
                          and res.stats.exec_cache_hit,
                          f"serve warm {q}: not answered from the caches")
                yield {"serve": tag, "query": q,
                       "mode": res.stats.mode,
                       "plan_hit": res.stats.plan_cache_hit,
                       "exec_hit": res.stats.exec_cache_hit,
                       "bucket": dict(res.stats.bucket),
                       "submit_ms": ms, "stages_ms": stage_ms(res),
                       "outside_stages_ms": ms - sum(stage_ms(res).values()),
                       **card}
        # -- the tier's host cost over the compiled plan ------------------
        # beside a service with no cache_dir, which writes no serve-time
        # feedback to disk after each batch
        mem_svc = tsvc.QueryService(db, schema)
        for q, (cold_sql, warm_sql) in SERVE_SQL.items():
            fp = served(svc, warm_sql, f"overhead {q}").stats.fingerprint
            served(mem_svc, warm_sql, f"overhead {q} memory-only")
            drain(f"serve overhead {q}")
            plan = svc.cache.plans.peek(fp)
            fn = tc.Executor(db, schema).compile(plan)
            # the plan answers under canonical names; the request's own
            # names come back through its canonical form
            canon = tsvc.canonicalize(tc.parse_sql(warm_sql, schema))
            _, padded = svc._snapshot(plan.scanned_rels())
            times = {"submit_ms": [], "submit_memory_only_ms": [],
                     "compiled_ms": [], "compiled_padded_ms": []}
            for _ in range(TIMING_REPS):
                for key, run in (
                        ("submit_ms", lambda: served(svc, warm_sql, q)),
                        ("submit_memory_only_ms",
                         lambda: served(mem_svc, warm_sql, q)),
                        ("compiled_ms", lambda: fn(db)),
                        ("compiled_padded_ms", lambda: fn(padded))):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = run()
                    torch.cuda.synchronize()
                    times[key].append((time.perf_counter() - t0) * 1e3)
                    drain(f"serve overhead {q} {key}")
                    vals = out.values if key.startswith("submit") \
                        else canon.rename_results(out)
                    check(serve_equal(vals, oracle[q]),
                          f"serve overhead {q} {key}: wrong answer")
            med = {k: statistics.median(v) for k, v in times.items()}
            prof = profile_run(torch, lambda _: served(svc, warm_sql, q),
                               None)
            drain(f"serve profile {q}")
            yield {"serve_overhead": q, **med,
                   "overhead_ms": med["submit_ms"]
                   - med["compiled_padded_ms"],
                   "reps": TIMING_REPS, "profile": prof, **card}
        # -- a batch: the dashboard plus V.1 minmax -----------------------
        solo = {}
        for sql in SERVE_DASHBOARD:
            solo[sql] = served(svc, sql, "batch solo").values
            drain("serve batch solo")
        check(serve_equal(solo[SERVE_DASHBOARD[-1]], oracle["minmax"]),
              "serve batch: V.1 minmax != oracle")
        for tag, disparity in (("cost-gated", None), ("ungated", inf)):
            b_svc = svc if disparity is None else tsvc.QueryService(
                db, schema, cache_dir=cache_dir, fusion_disparity=disparity)
            before = b_svc.metrics()
            for run in ("cold", "warm"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = b_svc.submit_many(SERVE_DASHBOARD)
                ms = (time.perf_counter() - t0) * 1e3
                drain(f"serve batch {tag} {run}")
                for r, sql in zip(res, SERVE_DASHBOARD):
                    check(r.ok, f"serve batch {tag}: {r.error!r}")
                    bounds = grouped_avg_bound(torch, h, solo[sql]) \
                        if "GROUP BY" in sql else None
                    diff = answers_diff(torch, r.values, solo[sql], bounds)
                    check(diff is None,
                          f"serve batch {tag}: fused != solo: {diff}")
                m = b_svc.metrics()
                yield {
                    "serve_batch": tag, "run": run, "ms": ms,
                    "members": [{"query": i, "fused": r.stats.fused,
                                 "group_size": r.stats.fused_group_size,
                                 "exec_source": r.stats.exec_source}
                                for i, r in enumerate(res)],
                    **{k: m[k] - before[k] for k in (
                        "fused_batches", "fused_queries", "fused_compiles",
                        "partial_fusions", "subplan_saved",
                        "fusion_cost_rejects", "compiles")}, **card}
                before = m
        # -- independent callers through the async batcher ----------------
        before = svc.metrics()
        async_q = [list(SERVE_SQL)[i % len(SERVE_SQL)]
                   for i in range(SERVE_ASYNC_CALLERS)]
        work = [SERVE_SQL[q][i % 2] for i, q in enumerate(async_q)]
        barrier = threading.Barrier(SERVE_ASYNC_CALLERS)
        futs = [None] * SERVE_ASYNC_CALLERS

        def caller(i):
            barrier.wait()
            futs[i] = svc.submit_async(work[i])

        threads = [threading.Thread(target=caller, args=(i,))
                   for i in range(SERVE_ASYNC_CALLERS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        check(not any(t.is_alive() for t in threads), "serve async: hung")
        results = [f.result(120) for f in futs]
        ms = (time.perf_counter() - t0) * 1e3
        drain("serve async")
        for r, q in zip(results, async_q):
            check(r.ok and serve_equal(r.values, oracle[q]),
                  f"serve async {q}: {r.error!r} {r.values}")
        m = svc.metrics()
        reqs = m["async_requests"] - before["async_requests"]
        batches = m["async_batches"] - before["async_batches"]
        check(reqs == SERVE_ASYNC_CALLERS and batches < reqs,
              f"serve async: {batches} batches for {reqs} requests")
        svc.close()
        yield {"serve_async": SERVE_ASYNC_CALLERS,
               "async_requests": reqs, "async_batches": batches,
               "ms": ms, **card}
        # -- a second service on the same cache_dir -----------------------
        t0 = time.perf_counter()
        warm_svc = tsvc.QueryService(db, schema, cache_dir=cache_dir)
        setup_s = time.perf_counter() - t0
        for q, (cold_sql, _) in SERVE_SQL.items():
            res = served(warm_svc, cold_sql, f"warmstart {q}")
            drain(f"serve warmstart {q}")
            check(serve_equal(res.values, oracle[q]),
                  f"serve warmstart {q}: wrong answer")
        m = warm_svc.metrics()
        check(m["plan_builds"] == 0 and m["persist_hits"] >= 3,
              f"serve warmstart: plan_builds {m['plan_builds']}, "
              f"persist_hits {m['persist_hits']}")
        yield {"serve_warmstart": True, "service_s": setup_s,
               **{k: m[k] for k in ("plan_builds", "persist_hits",
                                    "stat_refreshes", "compiles")},
               **card}
        # -- growth inside partsupp's bucket ------------------------------
        ps = h["partsupp"]
        n_ps = len(ps["ps_partkey"])
        rng = np.random.default_rng(SEED + 1)
        extra = {c: v[rng.integers(0, n_ps, SERVE_GROWTH_ROWS)]
                 for c, v in ps.items()}
        # the appended rows join other parts than the rows they copy
        extra["ps_partkey"] = rng.permutation(extra["ps_partkey"])
        grown = {c: np.concatenate([ps[c], extra[c]]) for c in ps}
        grown_oracle = v1_oracle({**h, "partsupp": grown})
        before = svc.metrics()
        t0 = time.perf_counter()
        svc.update_table("partsupp", Table.from_numpy(grown, device=dev))
        update_s = time.perf_counter() - t0
        for q, (_, warm_sql) in SERVE_SQL.items():
            res = served(svc, warm_sql, f"growth {q}")
            drain(f"serve growth {q}")
            check(serve_equal(res.values, grown_oracle[q]),
                  f"serve growth {q}: {res.values} != {grown_oracle[q]}")
        m = svc.metrics()
        recompiles = m["compiles"] - before["compiles"]
        check(recompiles == 0, f"serve growth: {recompiles} recompiles")
        yield {"serve_growth": SERVE_GROWTH_ROWS,
               "partsupp_rows": n_ps + SERVE_GROWTH_ROWS,
               "update_s": update_s, "recompiles": recompiles,
               "bucket_invalidations": m["bucket_invalidations"]
               - before["bucket_invalidations"],
               "answers": {q: {k: np.asarray(v).item()
                               for k, v in grown_oracle[q].items()}
                           for q in SERVE_SQL}, **card}
    launches = {name: k.launches for name, (_, _, k) in kernels.items()}
    for name, n in launches.items():
        check(n > 0, f"the serve phase launched {name} no time")
        check(held[name] >= n, f"serve: {name} launched {n} times, "
              f"{held[name]} calls held")
    yield {"kernels_serve": [
        {"name": name, "launches": launches[name], "held": held[name],
         "max_abs_err": max(errs[name])} for name in kernels],
        "phase_s": time.perf_counter() - t_phase, **card}


# ---------------------------------------------------------------------------
# the kernel tuner
# ---------------------------------------------------------------------------
TUNE_KERNELS = ("freq_join", "semi_join", "segment_sum")


def tune_lines(torch, tsvc, at, kernels, plain, errs, db, schema, oracle,
               card, freq_dtype, dev):
    """The kernel tuner on the card at one width (``freq_dtype`` int32:
    backend ``cuda``; int64: ``cuda_wide``), its kernel counts set to 0
    just before it and read just after.  One ``QueryService`` over V.1's
    tables with a ``cache_dir`` inside the checkout (deleted after): V.1
    untuned, then ``autotune()`` of K1–K3 over every bucket pair (no gate
    reject), the tuned V.1 run with every kernel call recorded and held
    against its plain version, each (kernel, bucket) those calls hit timed
    default against winner on the search's own scenarios (answers bitwise
    equal to the default's and the plain version's), the recorded calls
    timed under their tuned configs and under the default, and a second
    service on the same ``cache_dir`` (no search, no invalidation, the
    store's hits, the same answers).  Yields one line per case."""
    import tempfile

    wide = freq_dtype == torch.int64
    backend = "cuda_wide" if wide else "cuda"

    def check_answers(res, q, tag):
        check(serve_equal(res.values, oracle[q]),
              f"{tag} {q}: {res.values} != {oracle[q]}")
        if wide and q == "count":
            check(all(v.dtype == torch.int64 for v in res.values.values()),
                  f"{tag} count: not int64")

    seen = []

    def keep(name, wrapper, args, **kw):
        out = wrapper(*args, **kw)
        seen.append((name, args, kw.get("config"), out))
        return out

    trajectory: dict = {}

    def row(name, us, derived):
        _, kernel, _, shape, tag = name.split("/")
        trajectory.setdefault((kernel, shape), {})[tag] = us

    for _, _, k in kernels.values():
        k.reset_counts()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tune-cache-",
                                     dir=Path(__file__).resolve().parent
                                     ) as cache_dir:
        svc = tsvc.QueryService(db, schema, cache_dir=cache_dir,
                                freq_dtype=freq_dtype)
        check(svc.tuner.backend == backend, f"tuner on {svc.tuner.backend}")
        for q, (sql, _) in SERVE_SQL.items():
            check_answers(served(svc, sql, f"tune untuned {q}"), q,
                          "tune untuned")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = svc.autotune(TUNE_KERNELS, row=row)
        torch.cuda.synchronize()
        tune_s = time.perf_counter() - t0
        check(summary["gate_rejects"] == 0,
              f"tune {backend}: {summary['gate_rejects']} gate rejects")
        check(summary["searches"] == summary["installed"] > 0
              and summary["invalidated_executables"] >= len(SERVE_SQL),
              f"tune {backend}: {summary}")
        winners = {f"{k} {'x'.join(map(str, shape))}":
                   at.KernelTuner.cfg_tag(k, cfg)
                   for (k, shape, _), cfg in sorted(
                       svc.tuner.table.entries())}
        yield {"tune": backend, "summary": summary, "tune_s": tune_s,
               "winners": winners, "counters": svc.tuner.metrics(),
               "store": svc.tune_store.metrics(), **card}
        for (kernel, shape), us in sorted(trajectory.items()):
            yield {"tune_search": backend, "kernel": kernel, "bucket": shape,
                   "candidate_us": us,
                   "winner": winners[f"{kernel} {shape}"]}
        # the tuned V.1 run: the closures compiled after the install look
        # their configs up; one warm pass of each is recorded
        for q, (sql, _) in SERVE_SQL.items():
            check_answers(served(svc, sql, f"tune compile {q}"), q,
                          "tune tuned")
        with routed(kernels, keep):
            for q, (_, sql) in SERVE_SQL.items():
                res = served(svc, sql, f"tune tuned {q}")
                check(res.stats.exec_cache_hit, f"tune tuned {q}: no hit")
                check_answers(res, q, "tune tuned")
        torch.cuda.synchronize()
        held = hold_calls(torch, plain, errs, f"tune {backend}",
                          [(n, a, o) for n, a, _, o in seen], dev)
        for name, args, cfg, _ in seen:
            shape = tuple(t.shape[0] for t in args[::2])
            check(cfg is not None
                  and cfg == svc.tuner.table.lookup(name, shape, backend),
                  f"tune {backend}: {name} {shape} ran {cfg}, not its "
                  "tuned config")
        # default against winner on each search's own scenarios (a join
        # bucket's inputs drawn once for both joins)
        hits = sorted({(at.bucket_shape(*(t.shape[0] for t in args[::2])),
                        name) for name, args, _, _ in seen})
        with svc.tuner.shared_draws():
            for bshape, name in hits:
                yield tune_win_line(torch, at, plain, errs, svc.tuner, name,
                                    bshape, card)
        # the recorded calls under their tuned configs and the default
        line = {}
        for name, (mod, attr, _) in kernels.items():
            mine = [(a, c) for n, a, c, _ in seen if n == name]
            wrapper = getattr(mod, attr)
            line[name] = {
                "calls": len(mine), "held": held.get(name, 0),
                "device_ms": sum(time_ms(
                    torch, lambda: wrapper(*a, config=c), queued=True)
                    for a, c in mine),
                "default_device_ms": sum(time_ms(
                    torch, lambda: wrapper(*a), queued=True)
                    for a, _ in mine)}
        # a second service on the same cache_dir
        t0 = time.perf_counter()
        warm = tsvc.QueryService(db, schema, cache_dir=cache_dir,
                                 freq_dtype=freq_dtype)
        setup_s = time.perf_counter() - t0
        again = warm.autotune(TUNE_KERNELS)
        m = warm.metrics()
        check(again["searches"] == 0 and again["invalidated_executables"] == 0
              and m["tune_store_hits"] > 0
              and again["entries"] == summary["entries"],
              f"tune warm restart {backend}: {again}, store hits "
              f"{m['tune_store_hits']}")
        check(dict(warm.tuner.table.entries())
              == dict(svc.tuner.table.entries()),
              f"tune warm restart {backend}: other configs")
        for q, (sql, _) in SERVE_SQL.items():
            check_answers(served(warm, sql, f"tune warm {q}"), q,
                          "tune warm")
        yield {"tune_warmstart": backend, "service_s": setup_s,
               "summary": again,
               **{k: m[k] for k in ("tune_searches", "tune_store_hits",
                                    "tune_persist_hits", "tune_entries")},
               **card}
    launches = {name: k.launches for name, (_, _, k) in kernels.items()}
    for name, n in launches.items():
        check(n > 0, f"the tune phase launched {name} no time")
        check(line[name]["held"] > 0, f"tune: no {name} call held")
    yield {"kernels_tuned": [
        {"name": name, "launches": launches[name], **line[name],
         "max_abs_err": max(errs[name])} for name in kernels],
        "backend": backend, "phase_s": time.perf_counter() - t_phase,
        **card}


def tune_win_line(torch, at, plain, errs, tuner, name, bshape, card):
    """Default against the winner of (``name``, ``bshape``) on the
    search's own scenarios: the winner's answers bitwise equal to the
    default's and held against the plain version, each config's device ms
    summed over the scenarios."""
    win = tuner.table.lookup(name, bshape, tuner.backend)
    scen = tuner.scenarios(name, bshape)
    ms = {"default": 0.0, "winner": 0.0}
    for label, fn in scen:
        base, got = fn(at.DEFAULT_CONFIG), fn(win)
        torch.cuda.synchronize()
        tag = f"tune_win {name} {bshape} {label}"
        check(at._bitwise_equal(got, base), f"{tag}: winner != default")
        hold = hold_segsum if name == "segment_sum" else hold_join
        hold(torch, plain[name], errs[name], tag, got, *fn.__defaults__[0])
        for key, cfg in (("default", at.DEFAULT_CONFIG), ("winner", win)):
            ms[key] += time_ms(torch, lambda: fn(cfg), queued=True)
    return {"tune_win": tuner.backend, "kernel": name,
            "bucket": "x".join(map(str, bshape)),
            "winner": at.KernelTuner.cfg_tag(name, win),
            "scenarios": len(scen), "default_device_ms": ms["default"],
            "winner_device_ms": ms["winner"], **card}


# ---------------------------------------------------------------------------
# the LM serving path
# ---------------------------------------------------------------------------
LM_SEED = 0
# float32 logits, card against CPU, relative to the largest |logit|: each
# side is about 1.2e-6 off a float64 run of the same weights on the CPU
# (smollm-135m at full width, 4 × 16 tokens), both with TF32 off
LM_TOL = 1e-4
# the launcher's default traffic (repro_torch.launch.serve): two waves
LM_TRAFFIC = {"n_requests": 8, "n_slots": 4, "prompt_len": 16, "max_new": 32}
# one long-prompt wave: two prefill chunks of attn_chunk = 1024
LM_LONG = {"n_requests": 4, "n_slots": 4, "prompt_len": 2048, "max_new": 16}
LM_CHECK = {"n_requests": 8, "n_slots": 4, "prompt_len": 16, "max_new": 8,
            "teacher_forced": 4, "rollout": 4}
# Moonlight-16B-A3B at its published widths, depth cut to fit the run
LM_MOE = {"n_layers": 2, "n_requests": 4, "n_slots": 4, "prompt_len": 64,
          "max_new": 8}
# the recurrent families, at full published width and depth
LM_MIXERS = ("rwkv6-1.6b", "zamba2-1.2b")
# float32 on the card: the chunked prefill's final states against the
# per-token recurrence's, per state, relative to its largest magnitude; the
# JAX package's bound between the two forms of one mixer is rtol = atol =
# 2e-4 (tests/test_mixers.py), and float32 sums in two orders drift far
# less than that through 24 or 38 layers
LM_STATE_TOL = 2e-4


def lm_prompts(n: int, length: int, vocab: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, length) for _ in range(n)]


def lm_n_waves(traffic: dict) -> int:
    return -(-traffic["n_requests"] // traffic["n_slots"])


def lm_serve_steps(torch, model, cfg, toks, max_len: int, n_decode: int,
                   mesh=None, forced=None):
    """One prefill of the slots ``toks`` and ``n_decode`` decode steps
    into a cache of ``max_len``, each synchronised and timed on the host,
    fed the greedy tokens (``lm_serving.greedy_tokens``) or, teacher
    forced, the columns of ``forced``, as ``ServeEngine.run_wave`` runs
    them for the slots (no EOS), through the public ``prefill`` /
    ``decode_step``; the logits checked finite after the timing.  On ``mesh`` the model is placed
    (``launch.inputs.place_params``), its caches and prompt are placed by
    the serving shardings, and each step runs under ``use_mesh``.
    Returns (each step's ms, its logits as CPU copies taken after the
    timing, the bytes of this rank's caches)."""
    from repro_torch import models as tm
    from repro_torch.distributed import use_mesh
    from repro_torch.launch.inputs import (
        batch_shardings,
        place_cache,
        serving_shardings,
    )
    from repro_torch.models.lm_serving import greedy_tokens
    dev = model.final_norm.device
    rows = toks.shape[0]
    cache = tm.init_decode_state(cfg, rows, max_len, dev)
    batch = {"tokens": torch.as_tensor(toks, device=dev)}
    if mesh is not None:
        cache = place_cache(cache, serving_shardings(cfg, mesh, rows,
                                                     max_len)[1])
        batch = {k: sh.distribute(batch[k])
                 for k, sh in batch_shardings(mesh, batch).items()}
    scope = (lambda: use_mesh(mesh)) if mesh is not None \
        else contextlib.nullcontext
    cache_bytes = sum((t.to_local() if mesh is not None else t).numel()
                      * t.element_size() for k, t in cache.items()
                      if k != "pos")
    ms, logits = [], []
    for i in range(1 + n_decode):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with scope():
            if i == 0:
                out, cache = tm.prefill(model, cfg, batch, cache)
            else:
                out, cache = tm.decode_step(model, cfg, cur, cache)
            if i < n_decode:
                cur = (greedy_tokens(out) if forced is None
                       else torch.as_tensor(forced[:, i:i + 1], device=dev))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(lm_whole(out).cpu())
        check(bool(torch.isfinite(logits[-1]).all()),
              f"lm {cfg.name} step {i}: non-finite logits")
    return ms, logits, cache_bytes


def lm_serve(torch, lms, model, cfg, traffic: dict, seed: int):
    """Serve ``traffic`` through one ``ServeEngine`` wave by wave, as the
    launcher does, after one untimed request, each ``run_wave`` timed from
    outside; every token in range, every slot to its budget.  Returns
    (the prompts, the first request's ms, the waves)."""
    t = traffic
    engine = lms.ServeEngine(model, cfg, n_slots=t["n_slots"],
                             max_len=t["prompt_len"] + t["max_new"] + 8)
    prompts = lm_prompts(t["n_requests"], t["prompt_len"], cfg.vocab_size,
                         seed)
    # one untimed request first: the first calls of a process set up the
    # card's libraries (a cold start, timed on its own)
    t0 = time.perf_counter()
    lms.greedy_generate(model, cfg, prompts[0][None, :], 2)
    torch.cuda.synchronize()
    warmup_ms = (time.perf_counter() - t0) * 1e3
    for p in prompts:
        engine.submit(p)
    waves = []
    for _ in range(lm_n_waves(t)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = engine.run_wave(max_tokens=t["max_new"])
        wall = time.perf_counter() - t0
        toks = [tok for v in outs.values() for tok in v]
        check(all(len(v) == t["max_new"] for v in outs.values())
              and all(0 <= tok < cfg.vocab_size for tok in toks),
              f"lm serve {cfg.name}: a slot short of its budget or a "
              "token out of range")
        waves.append({"requests": len(outs), "tokens": len(toks),
                      "wall_ms": wall * 1e3})
    check(not engine.run_wave(max_tokens=1),
          f"lm serve {cfg.name}: requests left after the waves")
    return prompts, warmup_ms, waves


def lm_wave_steps(torch, tm, model, cfg, traffic: dict, prompts,
                  waves) -> None:
    """Each served wave's steps again, one by one (``lm_serve_steps``),
    for its prefill's time and its per-token decode times."""
    t, n = traffic, traffic["n_slots"]
    for w, wave in enumerate(waves):
        slots = np.zeros((n, t["prompt_len"]), np.int32)
        for i, p in enumerate(prompts[w * n:(w + 1) * n]):
            slots[i] = p
        ms, _, _ = lm_serve_steps(torch, model, cfg, slots,
                                  t["prompt_len"] + t["max_new"] + 8,
                                  t["max_new"] - 1)
        wave.update(prefill_ms=ms[0], decode_ms=ms[1:])


def lm_state_bytes(tm, cfg, n_slots: int, max_len: int) -> int:
    """Bytes one decode step moves in its caches, counted from the shapes
    ``init_decode_state`` gives (on the meta device): a KV cache is read at
    every position (``attention_decode`` masks, it does not slice) and
    written at one; a recurrent state is read and written whole."""
    total = 0
    for name, t in tm.init_decode_state(cfg, n_slots, max_len,
                                        "meta").items():
        if name == "pos":
            continue
        nbytes = t.numel() * t.element_size()
        total += (nbytes // max_len * (max_len + 1) if name in ("k", "v")
                  else 2 * nbytes)
    return total


def lm_weight_reads(tm, model, cfg, min_dim: int = 1) -> int:
    """Weights of ``min_dim`` or more dimensions a decode step reads, the
    embedding aside, the hybrid's shared block once per application."""
    uses = 1
    if cfg.family == "hybrid":
        uses = tm.init_decode_state(cfg, 1, 1, "meta")["k"].shape[0]
    return sum(w.numel() * (uses if name.startswith("shared.") else 1)
               for name, w in model.named_parameters()
               if name != "embed.embedding" and w.dim() >= min_dim)


def lm_decode_bytes(tm, model, cfg, n_slots: int, max_len: int) -> dict:
    """Bytes one decode step must move at its dtypes, counted from the
    model's shapes.  ``cast``: each float32 weight read by its cast to
    bfloat16 at each use, the copy written and read by its matmul (8 B a
    weight; the embedding only for the slots' rows, read and cast);
    ``f32_once``: each weight read once as stored (4 B).  Both add the
    caches (``lm_state_bytes``)."""
    n = sum(w.numel() for w in model.parameters()) \
        - model.embed.embedding.numel()
    rows = n_slots * cfg.d_model * 6
    state = lm_state_bytes(tm, cfg, n_slots, max_len)
    return {"cast": 8 * lm_weight_reads(tm, model, cfg) + rows + state,
            "f32_once": 4 * n + rows + state}


def lm_near_tie(torch, tm, model, cfg, prompt, toks, j: int) -> bool:
    """Whether the step that chose ``toks[j]`` after ``prompt`` had its top
    two logits within ``LM_TOL`` of the largest |logit| (a float32 forward
    over the prefix, on the card)."""
    seq = list(prompt) + list(toks[:j])
    logits, _ = tm.forward(model, cfg, {"tokens": torch.as_tensor(
        [seq], dtype=torch.int32, device=model.final_norm.device)})
    last = logits[0, -1].double()
    top2 = torch.topk(last, 2).values
    return float(top2[0] - top2[1]) <= LM_TOL * float(last.abs().max())


def lm_same_tokens(torch, tm, model, cfg, prompt, got, want, what) -> int:
    """1 if ``got`` first differs from ``want`` at a near-tie, 0 if they
    are equal; any other difference fails."""
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if j is None and len(got) == len(want):
        return 0
    check(j is not None and lm_near_tie(torch, tm, model, cfg, prompt, want,
                                        j),
          f"lm check {what}: tokens {got} != {want} (not at a near-tie)")
    return 1


def lm_check_line(torch, tm, lms, model, cfg, dev) -> dict:
    """The served model's weights in float32 compute: prefill and
    teacher-forced decode logits on the card against a CPU copy; each
    ``ServeEngine`` wave's tokens against ``greedy_generate`` per prompt;
    ``greedy_generate``'s first tokens against a ``forward`` rollout."""
    import dataclasses
    c = LM_CHECK
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    host = tm.LM(cfg32, "cpu")
    host.load_state_dict(model.state_dict())
    rng = np.random.default_rng(LM_SEED + 1)
    toks = rng.integers(0, cfg.vocab_size,
                        (c["n_slots"], c["prompt_len"] + c["teacher_forced"])
                        ).astype(np.int32)
    plen, errs, sides = c["prompt_len"], [], [[model, dev], [host, "cpu"]]
    for side in sides:
        m, d = side
        cache = tm.init_decode_state(cfg32, c["n_slots"],
                                     toks.shape[1], d)
        out = []
        logits, cache = tm.prefill(m, cfg32, {"tokens": torch.as_tensor(
            toks[:, :plen], device=d)}, cache)
        out.append(logits.cpu().double())
        for i in range(c["teacher_forced"]):
            logits, cache = tm.decode_step(m, cfg32, torch.as_tensor(
                toks[:, plen + i:plen + i + 1], device=d), cache)
            out.append(logits.cpu().double())
        side.append(out)
    for got, want in zip(sides[0][2], sides[1][2]):
        errs.append(float((got - want).abs().max() / want.abs().max()))
        check(errs[-1] <= LM_TOL, f"lm check: card against CPU logits "
              f"{errs[-1]} above {LM_TOL}")

    prompts = lm_prompts(c["n_requests"], plen, cfg.vocab_size, LM_SEED + 2)
    engine = lms.ServeEngine(model, cfg32, n_slots=c["n_slots"],
                             max_len=plen + c["max_new"] + 8)
    for p in prompts:
        engine.submit(p)
    served = {}
    for _ in range(lm_n_waves(c)):
        served.update(engine.run_wave(max_tokens=c["max_new"]))
    check(len(served) == len(prompts), "lm check: requests left unserved")
    serve_ties = 0
    for rid, p in enumerate(prompts):
        want = lms.greedy_generate(model, cfg32, p[None, :],
                                   c["max_new"])[0].tolist()
        serve_ties += lm_same_tokens(torch, tm, model, cfg32, p, served[rid],
                                     want, f"serve request {rid}")
    roll_ties = 0
    batch = np.stack(prompts[:c["n_slots"]])
    greedy = lms.greedy_generate(model, cfg32, batch, c["rollout"])
    for i, p in enumerate(batch):
        seq, roll = list(p), []
        for _ in range(c["rollout"]):
            logits, _ = tm.forward(model, cfg32, {"tokens": torch.as_tensor(
                [seq], dtype=torch.int32, device=dev)})
            roll.append(int(torch.argmax(logits[0, -1])))
            seq.append(roll[-1])
        roll_ties += lm_same_tokens(torch, tm, model, cfg32, p,
                                    greedy[i].tolist(), roll,
                                    f"greedy vs rollout {i}")
    return {"lm_check": cfg.name, "dtype": "float32", "tol": LM_TOL,
            "card_vs_cpu_rel_err": {"prefill": errs[0],
                                    "decode": errs[1:]},
            "serve_vs_greedy": {"requests": len(prompts),
                                "tokens": len(prompts) * c["max_new"],
                                "near_ties": serve_ties},
            "greedy_vs_rollout": {"requests": len(batch),
                                  "tokens": len(batch) * c["rollout"],
                                  "near_ties": roll_ties}}


def lm_profile_line(torch, tm, model, cfg, traffic: dict, card,
                    dev) -> dict:
    """One decode step after a prefill of ``traffic``'s slots, profiled:
    device ms, idle share, kernels, the top five kernels, and
    ``aten::_to_copy``'s device ms (every cast of the step, the float32 →
    bfloat16 weight casts among them) beside the bytes bound of the weight
    casts alone (6 B a weight: read float32, write bfloat16)."""
    t = traffic
    cache = tm.init_decode_state(cfg, t["n_slots"],
                                 t["prompt_len"] + t["max_new"] + 8, dev)
    toks = np.stack(lm_prompts(t["n_slots"], t["prompt_len"],
                               cfg.vocab_size, LM_SEED))
    logits, cache = tm.prefill(model, cfg, {"tokens": torch.as_tensor(
        toks, device=dev)}, cache)
    cur = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    wall_ms, rows, avgs = profile_rows(
        torch, lambda _: tm.decode_step(model, cfg, cur, cache), None)
    busy = sum(r[1] for r in rows)
    to_copy = [ev for ev in avgs if ev.key == "aten::_to_copy"]
    to_copy_ms = sum(ev.device_time_total for ev in to_copy) / 1e3
    weights = [w for name, w in model.named_parameters()
               if name != "embed.embedding" and w.dim() > 1]
    cast_bound = bound_ms(6 * lm_weight_reads(tm, model, cfg, min_dim=2))
    return {"lm_profile": "decode_step", "arch": cfg.name,
            "slots": t["n_slots"], "profiled_wall_ms": wall_ms,
            "device_ms": busy, "idle_share": 1 - busy / wall_ms,
            "kernels": sum(r[2] for r in rows),
            "to_copy_device_ms": to_copy_ms,
            "to_copy_calls": sum(ev.count for ev in to_copy),
            "weight_casts": len(weights),
            "weight_cast_bound_ms": cast_bound,
            # below the bound, the profile lost some of the casts' events
            "to_copy_at_or_above_bound": to_copy_ms >= cast_bound,
            "top": [[k[:80], ms, c] for k, ms, c in rows[:5]], **card}


def lm_serve_lines(torch, card, dev,
                   arch: str = "smollm-135m") -> list[dict]:
    """``arch`` at its full published width, float32 masters and bfloat16
    compute: the launcher's traffic, one long-prompt wave, one profiled
    decode step, then the float32 checks (``lm_check_line`` and, for a
    recurrent family, ``lm_state_line``).  No kernel of the port runs
    here: an LM's serving path is plain PyTorch."""
    from repro_torch import models as tm
    from repro_torch.configs import get_config
    from repro_torch.models import lm_serving as lms
    cfg = get_config(arch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tm.init_params(cfg, seed=LM_SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    lines = [{"lm_setup": cfg.name, "family": cfg.family,
              "params": sum(w.numel() for w in model.parameters()),
              "param_bytes": sum(w.numel() * w.element_size()
                                 for w in model.parameters()),
              "compute_dtype": cfg.dtype, "init_s": init_s, **card}]
    for name, traffic, seed in (("traffic", LM_TRAFFIC, LM_SEED),
                                ("long_prompt", LM_LONG, LM_SEED + 3)):
        prompts, warmup_ms, waves = lm_serve(torch, lms, model, cfg,
                                             traffic, seed)
        lm_wave_steps(torch, tm, model, cfg, traffic, prompts, waves)
        dec = [ms for w in waves for ms in w["decode_ms"]]
        nbytes = lm_decode_bytes(tm, model, cfg, traffic["n_slots"],
                                 traffic["prompt_len"] + traffic["max_new"]
                                 + 8)
        lines.append({
            "lm_serve": name, "arch": cfg.name,
            "traffic": traffic, "warmup_ms": warmup_ms,
            "waves": [{k: w[k] for k in ("requests", "tokens", "prefill_ms",
                                         "wall_ms")} for w in waves],
            "decode_steps": len(dec),
            "decode_ms_median": statistics.median(dec),
            "decode_ms_p90": float(np.percentile(dec, 90)),
            "tokens_per_s": sum(w["tokens"] for w in waves)
            / (sum(w["wall_ms"] for w in waves) / 1e3),
            "decode_bytes": nbytes["cast"],
            "decode_bound_ms": bound_ms(nbytes["cast"]),
            "decode_bytes_f32_once": nbytes["f32_once"],
            "decode_bound_f32_once_ms": bound_ms(nbytes["f32_once"]),
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
            **card})

    lines.append(lm_profile_line(torch, tm, model, cfg, LM_TRAFFIC, card,
                                 dev))
    lines.append({**lm_check_line(torch, tm, lms, model, cfg, dev), **card})
    if cfg.family in ("rwkv6", "mamba2", "hybrid"):
        lines.append({**lm_state_line(torch, tm, model, cfg, dev), **card})
    del model
    torch.cuda.empty_cache()
    return lines


def lm_state_line(torch, tm, model, cfg, dev) -> dict:
    """float32 on the card: the chunked prefill's final recurrent states
    against those of per-token ``decode_step`` from a fresh state over the
    same prompts, each within ``LM_STATE_TOL`` of its largest
    magnitude."""
    import dataclasses
    c = LM_CHECK
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    toks = torch.as_tensor(np.stack(lm_prompts(
        c["n_slots"], c["prompt_len"], cfg.vocab_size, LM_SEED + 5)),
        dtype=torch.int32, device=dev)
    chunked = tm.init_decode_state(cfg32, c["n_slots"], c["prompt_len"], dev)
    _, chunked = tm.prefill(model, cfg32, {"tokens": toks}, chunked)
    rec = tm.init_decode_state(cfg32, c["n_slots"], c["prompt_len"], dev)
    for t in range(c["prompt_len"]):
        _, rec = tm.decode_step(model, cfg32, toks[:, t:t + 1], rec)
    errs = {}
    for name in sorted(set(chunked) - {"pos", "k", "v"}):
        a, b = chunked[name].double(), rec[name].double()
        errs[name] = float((a - b).abs().max() / b.abs().max())
        check(errs[name] <= LM_STATE_TOL, f"lm state {cfg.name} {name}: "
              f"chunked prefill against the recurrence {errs[name]} above "
              f"{LM_STATE_TOL}")
    check(bool(errs), f"lm state {cfg.name}: no recurrent state")
    return {"lm_state": cfg.name, "dtype": "float32",
            "prompt": [c["n_slots"], c["prompt_len"]],
            "tol": LM_STATE_TOL, "chunked_vs_recurrence_rel_err": errs}


def lm_moe_lines(torch, ss, kernels, card, dev):
    """moonshot-v1-16b-a3b at its published widths, depth cut: one wave of
    4 requests through ``ServeEngine``, a forward hook on each layer's MoE
    recording its input.  Serving computes no expert load and launches no
    kernel of the port; its K3 launches are counted all the same.  Then
    the load accounting over the recorded routing: ``load_stats`` (K3 on
    the card) on the router's choices of every MoE call of the wave, each
    held bitwise against ``torch.bincount``, against ``load_stats`` on a
    CPU copy (the plain route) and, per K3 call, against
    ``segment_sum_plain`` on the card.  Returns (lines, K3's launches in
    the served wave, K3's launches in the accounting), each counted from 0
    just before its run."""
    import dataclasses
    from repro_torch import models as tm
    from repro_torch.configs import get_config
    from repro_torch.models import lm_serving as lms
    from repro_torch.models import moe
    full = get_config("moonshot-v1-16b-a3b")
    cfg = dataclasses.replace(full, n_layers=LM_MOE["n_layers"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = tm.init_params(cfg, seed=LM_SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    seen = []
    hooks = [lp.mlp.register_forward_hook(
        lambda mod, args, out: seen.append((mod, args[1], out[1])))
        for lp in model.layers]
    traffic = {k: LM_MOE[k] for k in ("n_requests", "n_slots", "prompt_len",
                                      "max_new")}
    ss.K3.reset_counts()
    try:
        prompts, warmup_ms, waves = lm_serve(torch, lms, model, cfg, traffic,
                                             LM_SEED + 4)
    finally:
        for h in hooks:
            h.remove()
    serve_launches = ss.K3.launches
    # lm_serve's untimed request first: a prefill and one decode step
    check(len(seen) == cfg.n_layers * (2 + traffic["max_new"]),
          f"lm moe: {len(seen)} MoE calls")
    seen = seen[2 * cfg.n_layers:]
    lm_wave_steps(torch, tm, model, cfg, traffic, prompts, waves)
    calls, idxs = [], []

    def keep(name, wrapper, args, **kw):
        out = wrapper(*args, **kw)
        calls.append((args, out))
        return out

    ss.K3.reset_counts()
    with routed({"segment_sum": kernels["segment_sum"]}, keep):
        for p, x, _ in seen:
            idx = moe.route(p, cfg, x.reshape(-1, cfg.d_model),
                            cfg.compute_dtype)[3]
            loads = moe.load_stats(idx, cfg.n_experts)
            want = torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)
            check(torch.equal(loads, want.to(torch.int32)),
                  "lm moe: load_stats != bincount")
            check(torch.equal(loads.cpu(), moe.load_stats(
                idx.cpu(), cfg.n_experts)), "lm moe: load_stats on the card "
                "!= the plain route on the CPU")
            idxs.append(idx)
    launches = ss.K3.launches
    check(launches == len(seen), f"lm moe: K3 launched {launches} times "
          f"for {len(seen)} load_stats calls")
    errs = []
    for i, (args, out) in enumerate(calls):
        hold_segsum(torch, ss.segment_sum_plain, errs, f"lm K3 call {i}",
                    out, *args, exact=True)
    first = seen[0][2]
    loads = moe.load_stats(idxs[0], cfg.n_experts).double()
    nbytes = lm_decode_bytes(tm, model, cfg, traffic["n_slots"],
                             traffic["prompt_len"] + traffic["max_new"] + 8)
    dec = [ms for w in waves for ms in w["decode_ms"]]
    lines = [{"lm_moe": cfg.name, "reduced": {"n_layers": [full.n_layers,
                                                           cfg.n_layers]},
              "params": sum(w.numel() for w in model.parameters()),
              "param_bytes": sum(w.numel() * w.element_size()
                                 for w in model.parameters()),
              "init_s": init_s, "traffic": traffic,
              "warmup_ms": warmup_ms,
              "prefill_ms": [w["prefill_ms"] for w in waves],
              "decode_ms_median": statistics.median(dec),
              "decode_ms_p90": float(np.percentile(dec, 90)),
              "tokens_per_s": sum(w["tokens"] for w in waves)
              / (sum(w["wall_ms"] for w in waves) / 1e3),
              "decode_bound_ms": bound_ms(nbytes["cast"]),
              "decode_bound_f32_once_ms": bound_ms(nbytes["f32_once"]),
              "first_prefill_layer": {
                  "assignments": int(idxs[0].numel()),
                  "capacity": moe._capacity(cfg, seen[0][1].shape[0]
                                            * seen[0][1].shape[1]),
                  "dropped_frac": float(first["dropped_frac"]),
                  "load_min": float(loads.min()),
                  "load_max": float(loads.max()),
                  "load_mean": float(loads.mean()),
                  "load_std": float(loads.std()),
                  "experts_unused": int((loads == 0).sum())},
              "moe_calls": len(seen), "serve_k3_launches": serve_launches,
              "load_stats_k3_launches": launches,
              "k3_calls_held": len(calls), "max_abs_err": max(errs),
              **card}]
    # the prefill's first layer: K3 alone, load_stats through K3 and
    # through the plain version, and torch.bincount, on the same routing
    idx = idxs[0]
    keys, vals = calls[0][0]
    with routed({"segment_sum": kernels["segment_sum"]},
                lambda name, w, args, **kw: ss.segment_sum_plain(*args)):
        plain_ms = time_ms(torch, lambda: moe.load_stats(idx, cfg.n_experts))
    lines.append({
        "lm_load_stats": cfg.name, "rows": int(keys.shape[0]),
        "experts": cfg.n_experts,
        "k3_ms": time_ms(torch, lambda: ss.segment_sum_cuda(keys, vals)),
        "k3_device_ms": time_ms(torch, lambda: ss.segment_sum_cuda(keys, vals),
                                queued=True),
        "k3_bound_ms": bound_ms(segsum_bytes(keys.shape[0])),
        "load_stats_ms": time_ms(torch,
                                 lambda: moe.load_stats(idx, cfg.n_experts)),
        "load_stats_plain_ms": plain_ms,
        "bincount_ms": time_ms(torch, lambda: torch.bincount(
            idx.reshape(-1), minlength=cfg.n_experts)),
        **card})
    lines.append(lm_profile_line(torch, tm, model, cfg, traffic, card, dev))
    del model, seen, calls
    torch.cuda.empty_cache()
    return lines, serve_launches, launches


# ---------------------------------------------------------------------------
# the mesh ring sweep (repro_torch.core.distributed) at world size 1
# ---------------------------------------------------------------------------
# (presort, dense_domain) of each DistributedExecutor the mesh phase runs
# ---------------------------------------------------------------------------
# the LM training path
# ---------------------------------------------------------------------------
# smollm-135m at full width and depth, the JAX launcher's defaults for its
# traffic (src/repro/launch/train.py: 8 × 256 tokens, seed 1234, remat
# "full", one microbatch); 20 steps over 4 cycled batches
LM_TRAIN = {"arch": "smollm-135m", "global_batch": 8, "seq_len": 256,
            "seed": 1234, "steps": 20, "batches": 4, "base_lr": 1e-3,
            "warmup": 5, "microbatches": 1, "remat": "full"}
# float32, card against CPU: each step's loss within LOSS_TOL relative and
# each leaf's gradient within GRAD_TOL of its largest |g| (the CPU tests'
# float32 bounds against the JAX package)
LM_TRAIN_CHECK = {"steps": 2, "global_batch": 2, "seq_len": 64}
LM_TRAIN_LOSS_TOL = 1e-5
LM_TRAIN_GRAD_TOL = 1e-4
# the other families at full width, depth cut to the layers given: rwkv6's
# two RWKV blocks, zamba2's one group (the shared block and 2 Mamba2
# layers), Moonlight's 2 of 48 layers as lm_moe takes them (29.3 GB of
# float32 weights, gradients and moments)
LM_TRAIN_FAMILIES = {"rwkv6-1.6b": 2, "zamba2-1.2b": 2,
                     "moonshot-v1-16b-a3b": 2}
LM_TRAIN_FAMILY = {"steps": 3, "global_batch": 4, "seq_len": 256}
# the published dense bfloat16 rate of one H100 SXM at 700 W (TFLOP/s)
BF16_PEAK_TFLOPS = 989.0


def lm_train_steps(torch, step, state, batches, n: int):
    """``n`` train steps over ``batches`` in turn, each synchronised and
    timed on the host; its metrics read after the timing.  Returns (the
    state, each step's ms, each step's loss and grad_norm)."""
    ms, losses, norms = [], [], []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return state, ms, losses, norms


def lm_train_step_unsynced(torch, step, state, batch):
    """One more train step under ``torch.cuda.set_sync_debug_mode("error")``,
    which raises on the synchronising calls it detects: the step reads
    nothing back to the host."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return state


def lm_train_line(torch, tm, tt, card, dev) -> list[dict]:
    """smollm-135m at full width and depth, float32 masters and bfloat16
    compute, trained for ``LM_TRAIN["steps"]`` steps: losses finite and
    the mean of the last four below the first; step ms, tokens/s, peak
    bytes; then one step profiled (kernels, device ms, idle share) and one
    counted by ``FlopCounterMode`` (its matmul FLOPs, the recomputed
    forward included) for the achieved TFLOP/s."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from torch.utils.flop_counter import FlopCounterMode
    t = LM_TRAIN
    cfg = get_config(t["arch"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = tm.init_params(cfg, seed=LM_SEED, device=dev)
    state = tt.init_train_state(model)
    step = tt.build_train_step(
        cfg, microbatches=t["microbatches"], base_lr=t["base_lr"],
        warmup=t["warmup"], total_steps=t["steps"], remat=t["remat"])
    pipe = TokenPipeline(cfg.vocab_size, t["seq_len"], t["global_batch"],
                         seed=t["seed"])
    batches = [pipe.torch_batch(i, dev) for i in range(t["batches"])]
    state, ms, losses, norms = lm_train_steps(torch, step, state, batches,
                                              t["steps"])
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"lm train: non-finite loss or grad_norm {losses} {norms}")
    check(np.mean(losses[-4:]) < losses[0],
          f"lm train: the last four losses {losses[-4:]} average no lower "
          f"than the first {losses[0]}")
    peak = torch.cuda.max_memory_allocated()
    state = lm_train_step_unsynced(torch, step, state, batches[0])
    steady = ms[1:]
    tokens = t["global_batch"] * t["seq_len"]
    med = statistics.median(steady)
    wall_ms, rows, _ = profile_rows(
        torch, lambda s: step(s, batches[0]), state)
    busy = sum(r[1] for r in rows)
    with FlopCounterMode(display=False) as fc:
        step(state, batches[0])
    flops = fc.get_total_flops()
    n = sum(w.numel() for w in model.parameters())
    lines = [{
        "lm_train": cfg.name, "family": cfg.family, "params": n,
        "state_bytes": 16 * n, "compute_dtype": cfg.dtype,
        "traffic": {k: t[k] for k in ("global_batch", "seq_len", "seed",
                                      "steps", "batches", "microbatches",
                                      "remat", "base_lr", "warmup")},
        "losses": losses, "grad_norms": norms,
        "first_step_ms": ms[0], "step_ms_median": med,
        "step_ms_p90": float(np.percentile(steady, 90)),
        "tokens_per_s": tokens / (med / 1e3),
        "peak_allocated_bytes": peak, "host_syncs_in_step": 0, **card}, {
        "lm_train_profile": cfg.name, "profiled_wall_ms": wall_ms,
        "device_ms": busy, "idle_share": 1 - busy / wall_ms,
        "kernels": sum(r[2] for r in rows),
        "flops_per_step": flops,
        "achieved_tflops": flops / (med / 1e3) / 1e12,
        "bf16_peak_tflops": BF16_PEAK_TFLOPS,
        "top": [[k[:80], kms, c] for k, kms, c in rows[:6]], **card}]
    del state, model, step, batches
    torch.cuda.empty_cache()
    return lines


def lm_train_check_line(torch, tm, tt, dev) -> dict:
    """The same model in float32 (TF32 stays off): for each of
    ``LM_TRAIN_CHECK["steps"]`` steps, the loss and every leaf's gradient
    on the card against a CPU copy, then the step on both."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    c, t = LM_TRAIN_CHECK, LM_TRAIN
    cfg = dataclasses.replace(get_config(t["arch"]), dtype="float32")
    model = tm.init_params(cfg, seed=LM_SEED, device=dev)
    host = tm.LM(cfg, "cpu")
    host.load_state_dict(model.state_dict())
    pipe = TokenPipeline(cfg.vocab_size, c["seq_len"], c["global_batch"],
                         seed=t["seed"])
    sides = []
    for m, d in ((model, dev), (host, "cpu")):
        step = tt.build_train_step(cfg, base_lr=t["base_lr"], warmup=1,
                                   total_steps=t["steps"], remat=t["remat"])
        sides.append([tt.init_train_state(m), step, d])
    loss_errs, grad_errs = [], []
    for i in range(c["steps"]):
        out = []
        for side in sides:
            state, step, d = side
            batch = pipe.torch_batch(i, d)
            loss, _ = tt.train_loss(state.model, cfg, batch, remat=t["remat"])
            grads = torch.autograd.grad(loss, list(state.params.values()))
            out.append((float(loss.detach()),
                        [g.cpu().double() for g in grads]))
            side[0], metrics = step(state, batch)
            out[-1] += (float(metrics["loss"]),)
        (lc, gc, sc), (lh, gh, sh) = out
        loss_errs.append(max(abs(lc - lh) / abs(lh), abs(sc - sh) / abs(sh)))
        grad_errs.append(max(float((a - b).abs().max() / b.abs().max())
                             for a, b in zip(gc, gh) if b.abs().max() > 0))
        check(loss_errs[-1] <= LM_TRAIN_LOSS_TOL,
              f"lm train check step {i}: loss card vs CPU {loss_errs[-1]}")
        check(grad_errs[-1] <= LM_TRAIN_GRAD_TOL,
              f"lm train check step {i}: gradients card vs CPU "
              f"{grad_errs[-1]}")
    del sides, model, host
    torch.cuda.empty_cache()
    return {"lm_train_check": cfg.name, "dtype": "float32",
            "batch": [c["global_batch"], c["seq_len"]],
            "loss_tol": LM_TRAIN_LOSS_TOL, "grad_tol": LM_TRAIN_GRAD_TOL,
            "loss_rel_err": loss_errs, "grad_rel_err": grad_errs}


def lm_train_family_line(torch, tm, tt, arch: str, n_layers: int, card,
                         dev) -> dict:
    """``arch`` at its full published width with ``n_layers`` layers,
    bfloat16 compute over float32 masters, ``remat="full"``: a few steps,
    losses finite; step ms and peak bytes."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    c = LM_TRAIN_FAMILY
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = tt.init_train_state(tm.init_params(cfg, seed=LM_SEED,
                                               device=dev))
    step = tt.build_train_step(cfg, base_lr=LM_TRAIN["base_lr"], warmup=1,
                               total_steps=c["steps"], remat="full")
    pipe = TokenPipeline(cfg.vocab_size, c["seq_len"], c["global_batch"],
                         seed=LM_TRAIN["seed"])
    batches = [pipe.torch_batch(i, dev) for i in range(c["steps"])]
    state, ms, losses, norms = lm_train_steps(torch, step, state, batches,
                                              c["steps"])
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"lm train {arch}: non-finite loss or grad_norm {losses} {norms}")
    peak = torch.cuda.max_memory_allocated()
    state = lm_train_step_unsynced(torch, step, state, batches[0])
    n = sum(w.numel() for w in state.model.parameters())
    line = {"lm_train_family": cfg.name, "family": cfg.family,
            "n_layers": n_layers, "params": n, "state_bytes": 16 * n,
            "batch": [c["global_batch"], c["seq_len"]], "losses": losses,
            "grad_norms": norms, "step_ms": ms,
            "peak_allocated_bytes": peak, "host_syncs_in_step": 0, **card}
    del state, step, batches
    torch.cuda.empty_cache()
    return line


def lm_train_lines(torch, card, dev) -> list[dict]:
    """The ``lm_train`` phase: smollm-135m trained at full width
    (``lm_train_line``), its float32 check against the CPU, then the other
    families at full width and cut depth."""
    from repro_torch import models as tm
    from repro_torch import training as tt
    lines = lm_train_line(torch, tm, tt, card, dev)
    lines.append({**lm_train_check_line(torch, tm, tt, dev), **card})
    for arch, n_layers in LM_TRAIN_FAMILIES.items():
        lines.append(lm_train_family_line(torch, tm, tt, arch, n_layers,
                                          card, dev))
    return lines


# ---------------------------------------------------------------------------
# resumable LM training: the checkpointer and the launcher
# ---------------------------------------------------------------------------
# python -m repro_torch.launch.train at its defaults (smollm-135m at full
# width and depth, 8 × 256 tokens, seed 1234, remat "full", bfloat16
# compute over float32 masters), 6 steps, a checkpoint every 3; the crashed
# run is SIGKILLed as soon as step_3 exists, then started again
LM_CKPT_ARGS = ("--steps", "6", "--ckpt-every", "3")
LM_CKPT_KILL_AT = 3
LM_CKPT_FINAL = "step_6"
LM_CKPT_RUN_S = 300          # the longest one launcher run may take
# in-process, the launcher's model, traffic and Checkpointer: steps timed
# without a write, then saves each followed by steps timed while its write
# is in flight (a write of ~2 GB outlasts about one step)
LM_CKPT_IO_STEPS = 4
LM_CKPT_IO_SAVES = 3
LM_CKPT_IO_AFTER = 2


def lm_state_tensors(state) -> list:
    """A TrainState's tensors in a fixed order: the parameters, AdamW's
    step and moments, the step."""
    return [*state.model.parameters(), state.opt.step, *state.opt.m.values(),
            *state.opt.v.values(), state.step]


def lm_bitwise(torch, a, b) -> bool:
    """``a`` and ``b`` of one dtype and shape hold the same bits."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        a, b = (t.view({2: torch.int16, 4: torch.int32}[t.element_size()])
                for t in (a, b))
    return bool(torch.equal(a, b))


def lm_ckpt_io_line(torch, tm, tt, tmp: Path, card, dev) -> dict:
    """The launcher's model and traffic in this process: steps timed
    without a write, the first ``save`` (it allocates the pinned host
    buffers) and its background write alone, then ``LM_CKPT_IO_SAVES``
    saves, each followed by ``LM_CKPT_IO_AFTER`` steps timed while its
    write is in flight and a ``wait``, then ``restore`` of the last,
    held bitwise against a device copy of the state taken just before that
    save (the steps after it update the state in place and must not reach
    the files)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    t = LM_TRAIN
    cfg = get_config(t["arch"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = tt.init_train_state(tm.init_params(cfg, seed=LM_SEED,
                                               device=dev))
    step = tt.build_train_step(cfg, base_lr=t["base_lr"], warmup=t["warmup"],
                               total_steps=t["steps"], remat=t["remat"])
    pipe = TokenPipeline(cfg.vocab_size, t["seq_len"], t["global_batch"],
                         seed=t["seed"])
    batches = [pipe.torch_batch(i, dev) for i in range(t["batches"])]
    state, _, _, _ = lm_train_steps(torch, step, state, batches, 2)
    state, plain_ms, _, _ = lm_train_steps(torch, step, state, batches,
                                           LM_CKPT_IO_STEPS)
    ck = Checkpointer(tmp / "io")
    t0 = time.perf_counter()
    ck.save(1, state, async_=True)
    t1 = time.perf_counter()
    ck.wait()
    write_s = time.perf_counter() - t1
    first_save_ms = (t1 - t0) * 1e3
    nbytes = sum(f.stat().st_size for f in (tmp / "io" / "step_1").iterdir())
    save_ms, after_ms, tail_s = [], [], []
    for i in range(LM_CKPT_IO_SAVES):
        snap = [x.detach().clone() for x in lm_state_tensors(state)]
        t0 = time.perf_counter()
        ck.save(2 + i, state, async_=True)
        save_ms.append((time.perf_counter() - t0) * 1e3)
        state, ms, losses, _ = lm_train_steps(torch, step, state, batches,
                                              LM_CKPT_IO_AFTER)
        after_ms.append(ms)
        check(all(np.isfinite(losses)), f"lm ckpt: non-finite loss {losses}")
        t0 = time.perf_counter()
        ck.wait()
        tail_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = ck.restore(like=state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = lm_state_tensors(restored)
    check(int(restored.step) == int(snap[-1]) and len(got) == len(snap)
          and all(lm_bitwise(torch, a, b) for a, b in zip(got, snap)),
          "lm ckpt: the restored state is not the state saved (the steps "
          "after an async save reached its files?)")
    check(restored.model is not state.model and all(
        w.device == snap[0].device for w in got), "lm ckpt: restore placed "
        "the state elsewhere")
    peak = torch.cuda.max_memory_allocated()
    del state, restored, snap, got, step, batches
    torch.cuda.empty_cache()
    firsts = [ms[0] for ms in after_ms]
    return {
        "lm_ckpt_io": cfg.name, "checkpoint_bytes": nbytes,
        "first_save_ms": first_save_ms, "save_ms": save_ms,
        "write_s": write_s, "write_gb_per_s": nbytes / write_s / 1e9,
        "step_ms_no_write": plain_ms, "step_ms_after_save": after_ms,
        "step_ms_median_no_write": statistics.median(plain_ms),
        "step_ms_median_first_after_save": statistics.median(firsts),
        "wait_after_steps_s": tail_s, "restore_s": restore_s,
        "peak_allocated_bytes": peak, **card}


def lm_ckpt_launch(ckpt_dir: Path, log: Path, kill_at: int | None = None,
                   extra_env: dict | None = None) -> tuple[int, str, float]:
    """``python -m repro_torch.launch.train`` over ``ckpt_dir`` from the
    checkout, its output into ``log``, ``extra_env`` added to its
    environment; with ``kill_at``, SIGKILLed as soon as ``step_<kill_at>``
    exists.  Returns (exit code, output, seconds)."""
    import os
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, (
        str(root / "src"), os.environ.get("PYTHONPATH")))),
        **(extra_env or {}))
    cmd = [sys.executable, "-u", "-m", "repro_torch.launch.train",
           *LM_CKPT_ARGS, "--ckpt-dir", str(ckpt_dir)]
    t0 = time.perf_counter()
    with open(log, "w") as out:
        proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=out,
                                stderr=subprocess.STDOUT)
        try:
            if kill_at is None:
                rc = proc.wait(timeout=LM_CKPT_RUN_S)
            else:
                mark = ckpt_dir / f"step_{kill_at}"
                while not mark.exists() and proc.poll() is None \
                        and time.perf_counter() - t0 < LM_CKPT_RUN_S:
                    time.sleep(0.01)
                proc.kill()
                rc = proc.wait()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return rc, log.read_text(), time.perf_counter() - t0


def lm_ckpt_leaves(d: Path) -> dict:
    """The checkpoint in ``d`` as numpy arrays by key (the launcher's
    state: float32 and int32 leaves, their dtypes checked against the
    manifest's)."""
    leaves = json.loads((d / "manifest.json").read_text())["leaves"]
    out = {}
    for k, e in leaves.items():
        arr = np.load(d / e["file"])
        check(e["dtype"] in ("float32", "int32") and str(arr.dtype) ==
              e["dtype"] and list(arr.shape) == e["shape"],
              f"lm ckpt: {d.name} {k}: {arr.dtype}{list(arr.shape)} for "
              f"{e['dtype']}{e['shape']}")
        out[k] = arr
    return out


def lm_ckpt_gaps(a: dict, b: dict) -> dict:
    """Per key, None where ``a`` and ``b`` hold the same bits, else the
    largest |a - b|."""
    check(set(a) == set(b), "lm ckpt: two checkpoints of other keys")
    return {k: None if np.array_equal(a[k].view(np.int32), b[k].view(
        np.int32)) else float(np.abs(a[k].astype(np.float64) - b[k]).max())
            for k in a}


def lm_ckpt_lines(torch, card, dev) -> list[dict]:
    """The ``lm_ckpt`` phase: the checkpoint I/O in this process
    (``lm_ckpt_io_line``), then the launcher: two uninterrupted runs (``a``,
    ``a2``) and one (``b``) SIGKILLed once ``step_3`` exists and started
    again with the same arguments, which must resume from step 3.  ``b``'s
    final checkpoint is held against ``a``'s bitwise wherever ``a2``'s is
    bitwise equal to ``a``'s, and elsewhere within that leaf's gap between
    ``a`` and ``a2``.  Everything lives in a temporary directory in the
    checkout, removed at the end."""
    import shutil
    import signal
    import tempfile
    from repro_torch import models as tm
    from repro_torch import training as tt
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(prefix="lm-ckpt-", dir=root) as tmp:
        tmp = Path(tmp)
        free = shutil.disk_usage(tmp).free
        lines = [{**lm_ckpt_io_line(torch, tm, tt, tmp, card, dev),
                  "disk_free_bytes": free}]
        shutil.rmtree(tmp / "io")
        runs = {}
        for name in ("a", "a2"):
            rc, out, sec = lm_ckpt_launch(tmp / name, tmp / f"{name}.log")
            check(rc == 0 and "resumed" not in out,
                  f"lm ckpt: run {name} exited {rc}:\n{out[-3000:]}")
            runs[name] = sec
            shutil.rmtree(tmp / name / f"step_{LM_CKPT_KILL_AT}")
        rc, out, sec = lm_ckpt_launch(tmp / "b", tmp / "b.log",
                                      kill_at=LM_CKPT_KILL_AT)
        left = sorted(p.name for p in (tmp / "b").iterdir())
        check(rc == -signal.SIGKILL and LM_CKPT_FINAL not in left,
              f"lm ckpt: the run to crash exited {rc} with {left} before "
              f"it was killed:\n{out[-3000:]}")
        runs["b_killed"] = sec
        rc, out, sec = lm_ckpt_launch(tmp / "b", tmp / "b2.log")
        resumed = f"[train] resumed from step {LM_CKPT_KILL_AT}"
        check(rc == 0 and resumed in out,
              f"lm ckpt: the restarted run exited {rc} without "
              f"{resumed!r}:\n{out[-3000:]}")
        runs["b_resumed"] = sec
        a, a2, b = (lm_ckpt_leaves(tmp / n / LM_CKPT_FINAL)
                    for n in ("a", "a2", "b"))
        repeat, resume = lm_ckpt_gaps(a, a2), lm_ckpt_gaps(a, b)
        bad = sorted(k for k in a if resume[k] is not None and (
            repeat[k] is None or resume[k] > repeat[k]))
        check(not bad, "lm ckpt: the resumed run's final checkpoint is off "
              "the uninterrupted run's beyond the run-to-run gap at "
              + ", ".join(f"{k} {resume[k]} (a vs a2 {repeat[k]})"
                          for k in bad[:8]))
        lines.append({
            "lm_ckpt_launcher": "smollm-135m",
            "command": "python -m repro_torch.launch.train "
                       + " ".join(LM_CKPT_ARGS) + " --ckpt-dir DIR",
            "run_s": runs, "left_after_kill": left,
            "leaves": len(a),
            "repeat_not_bitwise": {k: g for k, g in repeat.items()
                                   if g is not None},
            "resume_not_bitwise": {k: g for k, g in resume.items()
                                   if g is not None},
            "resumed_log": [ln for ln in out.splitlines()
                            if ln.startswith("[train]")], **card})
    return lines


# ---------------------------------------------------------------------------
# distributed LM training: the launcher's model and traffic (smollm-135m at
# full width and depth, 8 × 256 tokens, seed 1234, remat "full", lr 3e-4,
# warmup 6 of 6 steps) through the mesh step on a one-rank NCCL (1, 1) host
# mesh, bitwise the one-device step; then the launcher under
# COORDINATOR_ADDRESS at world size 1, killed after step_3 and resumed,
# bitwise an uninterrupted mesh run; with 4 cards, 4 NCCL ranks on a (2, 2)
# data × model mesh in float32 against one rank, within the JAX package's
# distributed_lm_check.py bounds
LM_DIST = {"arch": "smollm-135m", "global_batch": 8, "seq_len": 256,
           "seed": 1234, "steps": 6, "base_lr": 3e-4, "warmup": 6,
           "microbatches": 1, "remat": "full"}
# the gather path (the step of rwkv6, mamba2 and the hybrid: whole
# weights gathered once a step, float32 gradients all-reduced): rwkv6-1.6b
# at full width, its depth cut to lm_train's 2 layers, LM_DIST's traffic
# for 3 steps
LM_DIST_GATHER = {"arch": "rwkv6-1.6b", "n_layers": 2, "steps": 3}
# MoE through the placed step, then the gather path: Moonlight at full
# width, 2 of its 48 layers as LM_TRAIN_FAMILIES takes it, LM_DIST's
# traffic for 3 steps (2,048 tokens a microbatch: capacity 240 a layer);
# its 22 GB state is held on the host while the one-device run's is on
# the card
LM_DIST_MOE = {"arch": "moonshot-v1-16b-a3b", "n_layers": 2, "steps": 3}
LM_DIST_MULTI = {"ranks": 4, "mesh": (2, 2), "axes": ("data", "model"),
                 "steps": 3, "timeout_s": 600}
# the (2, 2) cases: the launcher's model through its own (dense) step and,
# for comparison, through the gather path (TP_FAMILIES emptied in the
# ranks), the gather path's own family at LM_DIST_GATHER's depth, and
# Moonlight at LM_DIST_MOE's on 2 batch shards (each MoE layer's capacity,
# first-come positions and load balance over both shards' rows) through
# the gather path and through the placed step ("dense": TP_FAMILIES kept;
# 32 experts a rank, d_ff 704 a rank)
LM_DIST_MULTI_CASES = (("smollm-135m", None, "dense"),
                       ("smollm-135m", None, "gather"),
                       (LM_DIST_GATHER["arch"], LM_DIST_GATHER["n_layers"],
                        "gather"),
                       (LM_DIST_MOE["arch"], LM_DIST_MOE["n_layers"],
                        "gather"),
                       (LM_DIST_MOE["arch"], LM_DIST_MOE["n_layers"],
                        "dense"))
LM_DIST_LOSS_RTOL = 1e-4
LM_DIST_PARAM_RTOL, LM_DIST_PARAM_ATOL = 2e-3, 2e-4
# partitioned serving on the (2, 2) mesh, float32, against one card: each
# case (arch, depth or None, traffic, rows or None for the traffic's
# slots) is a teacher-forced run (logits) and a greedy one (tokens);
# smollm-135m at LM_CHECK's traffic cuts the cache's head dim over
# "model", one LM_LONG prompt (batch 1) its sequence over "data",
# qwen3-14b at 4 of its 40 layers its 8 KV heads over "model", and
# Moonlight at LM_MOE's 2 layers and traffic its 4 rows into 2 blocks over
# "data" (each MoE layer's capacity and first-come positions over both
# blocks' rows; 32 experts a rank)
LM_DIST_MULTI_SERVE = (("smollm-135m", None, LM_CHECK, None),
                       ("smollm-135m", None, LM_LONG, 1),
                       ("qwen3-14b", 4, LM_CHECK, None),
                       (LM_DIST_MOE["arch"], LM_MOE["n_layers"], LM_MOE,
                        None))
# the MoE family served on placed weights on the one-rank mesh: Moonlight
# at its published widths and LM_MOE's depth and traffic (one wave of 4
# requests, 64-token prompts, 8 new tokens), the prompts lm_moe draws
LM_MOE_TRAFFIC = {k: LM_MOE[k] for k in ("n_requests", "n_slots",
                                         "prompt_len", "max_new")}


def lm_dist_setup(torch, tm, tt, cfg, dev, t=LM_DIST):
    """The launcher's train step for ``cfg``, its batches on ``dev`` and a
    fresh whole state of seed-``LM_SEED`` weights."""
    from repro_torch.data import TokenPipeline
    step = tt.build_train_step(
        cfg, microbatches=t["microbatches"], base_lr=t["base_lr"],
        warmup=t["warmup"], total_steps=t["steps"], remat=t["remat"])
    pipe = TokenPipeline(cfg.vocab_size, t["seq_len"], t["global_batch"],
                         seed=t["seed"])
    batches = [pipe.torch_batch(i, dev) for i in range(t["steps"])]
    state = tt.init_train_state(tm.init_params(cfg, seed=LM_SEED,
                                               device=dev))
    return step, batches, state


def lm_whole(t):
    """A DTensor gathered whole; any other tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def lm_host_copy(t) -> np.ndarray:
    """``t`` (a DTensor gathered whole) as a numpy copy on the host.  On
    the CPU ``.cpu()`` returns the tensor itself, and a replicated
    DTensor's ``full_tensor()`` its local block: a capture taken without
    the copy would follow the steps that update the weight in place."""
    return lm_whole(t).detach().to("cpu", copy=True).numpy()


def lm_dist_one_rank(torch, cfg, dev, t=LM_DIST, offload=False) -> dict:
    """``cfg``'s mesh step at world size 1 (inside ``nccl_world``): the
    state placed on the (1, 1) host mesh by the logical rules, ``t``'s
    steps timed, then the same steps on one device from the same weights;
    every tensor of the two final states and every loss (and a MoE
    model's last ``dropped_frac``) bitwise equal.  With ``offload`` the
    mesh run's final state is copied to the host and freed before the
    one-device run.  Returns the line's numbers and, under ``"run"``, what
    a caller goes on with (the mesh step, the one-device step, both states
    (the mesh run's None with ``offload``), the batches)."""
    from repro_torch import models as tm
    from repro_torch import training as tt
    from repro_torch.distributed import use_mesh
    from repro_torch.distributed.sharding import mesh_sizes
    from repro_torch.launch.inputs import state_shardings
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh()
    step, batches, whole = lm_dist_setup(torch, tm, tt, cfg, dev, t)
    placed = tt.place_train_state(whole, state_shardings(cfg, mesh))
    del whole
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    last = {}

    def mesh_step(state, batch):
        with use_mesh(mesh):
            state, last["mesh"] = step(state, batch)
        return state, last["mesh"]

    def local_step(state, batch):
        state, last["local"] = step(state, batch)
        return state, last["local"]

    placed, mesh_ms, mesh_losses, _ = lm_train_steps(
        torch, mesh_step, placed, batches, t["steps"])
    peak = torch.cuda.max_memory_allocated()
    placed_bytes = sum(
        x.numel() * x.element_size() for x in (
            y.to_local() if hasattr(y, "to_local") else y
            for y in lm_state_tensors(placed)))
    got = lm_state_tensors(placed)
    if offload:
        got = [lm_whole(a).detach().cpu() for a in got]
        placed = None
        torch.cuda.empty_cache()
    _, _, local = lm_dist_setup(torch, tm, tt, cfg, dev, t)
    local, local_ms, local_losses, _ = lm_train_steps(
        torch, local_step, local, batches, t["steps"])
    want = lm_state_tensors(local)
    check(len(got) == len(want) and all(
        lm_bitwise(torch, lm_whole(a), b.to(a.device))
        for a, b in zip(got, want)),
        f"lm dist: {cfg.name}'s mesh step at world size 1 is not bitwise "
        f"the one-device step")
    check(mesh_losses == local_losses, f"lm dist: {cfg.name}'s losses "
          f"{mesh_losses} on the mesh, {local_losses} on one device")
    dropped = {}
    if "dropped_frac" in last["local"]:
        dropped = {"dropped_frac": float(last["mesh"]["dropped_frac"]),
                   "one_device_dropped_frac": float(
                       last["local"]["dropped_frac"])}
        check(dropped["dropped_frac"] == dropped["one_device_dropped_frac"],
              f"lm dist: {cfg.name}'s dropped_frac {dropped}")
    del got, want
    return {**dropped,
        "mesh": mesh_sizes(mesh), "world_size": 1, "backend": "nccl",
        "losses": mesh_losses, "mesh_step_ms": mesh_ms,
        "local_step_ms": local_ms,
        "mesh_step_ms_median": statistics.median(mesh_ms[1:]),
        "mesh_step_ms_p90": float(np.percentile(mesh_ms[1:], 90)),
        "local_step_ms_median": statistics.median(local_ms[1:]),
        "local_step_ms_p90": float(np.percentile(local_ms[1:], 90)),
        "peak_allocated_bytes_per_rank": peak,
        "placed_state_bytes_per_rank": placed_bytes,
        "step_path": lm_step_path(tt, cfg), "bitwise_vs_one_device": True,
        "run": (mesh_step, step, placed, local, batches)}


def lm_step_path(tt, cfg) -> str:
    """Which mesh step ``cfg`` takes: the dense step on its placed weights
    (a MoE layer's experts on their blocks) or the gather path."""
    if cfg.family not in tt.step.TP_FAMILIES:
        return "gather"
    return "dense: placed weights" + (
        ", experts on their blocks" if cfg.family == "moe" else "")


def lm_step_profile(torch, fn, state, batch) -> dict:
    """One step ``fn(state, batch)`` profiled (``profile_rows``): wall and
    device ms, idle share, kernels, host op events."""
    from torch.autograd import DeviceType
    wall_ms, rows, averages = profile_rows(
        torch, lambda s: fn(s, batch), state)
    busy = sum(r[1] for r in rows)
    return {"profiled_wall_ms": wall_ms, "device_ms": busy,
            "idle_share": 1 - busy / wall_ms,
            "kernels": sum(r[2] for r in rows),
            "host_ops": sum(ev.count for ev in averages
                            if ev.device_type != DeviceType.CUDA)}


def lm_dist_step_line(torch, card, dev) -> dict:
    """``lm_dist_one_rank`` of ``LM_DIST``'s model and traffic, then one
    more mesh step counted (FLOPs, collectives) and one mesh and one local
    step profiled."""
    from repro_torch.configs import get_config
    cfg = get_config(LM_DIST["arch"])
    line = lm_dist_one_rank(torch, cfg, dev)
    mesh_step, step, placed, local, batches = line.pop("run")
    # one more mesh step, counted: the lm_dryrun phase holds the dry run's
    # trace of this step against these counts
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as flops, CommDebugMode() as comm:
        mesh_step(placed, batches[0])
    torch.cuda.synchronize()
    counted = {"flops": flops.get_total_flops(), "collective_counts": {
        op.__name__: n for op, n in comm.get_comm_counts().items()}}
    # where a step's time goes: one mesh and one local step profiled
    profiles = {tag: lm_step_profile(torch, fn, state, batches[0])
                for tag, fn, state in (("mesh", mesh_step, placed),
                                       ("local", step, local))}
    del placed, local, step, mesh_step, batches
    torch.cuda.empty_cache()
    return {"lm_dist_step": cfg.name, "traffic": LM_DIST, **line,
            "flops_per_rank": counted["flops"], "profiles": profiles,
            "counted_step": counted, **card}


def lm_dist_gather_line(torch, card, dev, g=LM_DIST_GATHER) -> dict:
    """``lm_dist_one_rank`` of ``g``'s model (a family the placed step
    does not take) at ``LM_DIST``'s traffic: the gather path's mesh step
    bitwise the one-device step on the card."""
    import dataclasses

    from repro_torch import training as tt
    from repro_torch.configs import get_config
    full = get_config(g["arch"])
    cfg = dataclasses.replace(full, n_layers=g["n_layers"])
    check(lm_step_path(tt, cfg) == "gather",
          f"lm dist: {cfg.name} no longer takes the gather path")
    t = {**LM_DIST, "steps": g["steps"]}
    line = lm_dist_one_rank(torch, cfg, dev, t)
    del line["run"]
    torch.cuda.empty_cache()
    return {"lm_dist_gather": cfg.name, "family": cfg.family,
            "reduced": {"n_layers": [full.n_layers, cfg.n_layers]},
            "traffic": {k: v for k, v in t.items() if k != "arch"},
            **line, **card}


def lm_dist_moe_line(torch, card, dev, g=LM_DIST_MOE) -> dict:
    """``g``'s MoE model at ``LM_DIST``'s traffic through the placed step
    (``lm_dist_one_rank``, its state on the host for the one-device run),
    bitwise the one-device step; one local step and one placed step (on a
    fresh placed state) profiled; then the gather path (``TP_FAMILIES``
    emptied), bitwise too; step ms placed against one device and against
    the gather path."""
    import dataclasses

    from repro_torch import models as tm
    from repro_torch import training as tt
    from repro_torch.configs import get_config
    from repro_torch.distributed import use_mesh
    from repro_torch.launch.inputs import state_shardings
    from repro_torch.launch.mesh import make_host_mesh
    full = get_config(g["arch"])
    cfg = dataclasses.replace(full, n_layers=g["n_layers"])
    check(lm_step_path(tt, cfg).startswith("dense"),
          f"lm dist: {cfg.name} does not take the placed step")
    t = {**LM_DIST, "steps": g["steps"]}
    line = lm_dist_one_rank(torch, cfg, dev, t, offload=True)
    _, step, _, local, batches = line.pop("run")
    profiles = {"local": lm_step_profile(torch, step, local, batches[0])}
    del local
    torch.cuda.empty_cache()
    mesh = make_host_mesh()
    _, _, whole = lm_dist_setup(torch, tm, tt, cfg, dev, t)
    placed = tt.place_train_state(whole, state_shardings(cfg, mesh))
    del whole

    def mesh_step(state, batch):
        with use_mesh(mesh):
            return step(state, batch)

    profiles["mesh"] = lm_step_profile(torch, mesh_step, placed, batches[0])
    del placed, step, batches
    torch.cuda.empty_cache()
    families = tt.step.TP_FAMILIES
    tt.step.TP_FAMILIES = ()
    try:
        check(lm_step_path(tt, cfg) == "gather",
              f"lm dist: {cfg.name} does not take the gather path")
        gather = lm_dist_one_rank(torch, cfg, dev, t, offload=True)
    finally:
        tt.step.TP_FAMILIES = families
    del gather["run"]
    torch.cuda.empty_cache()
    check(gather["dropped_frac"] == line["dropped_frac"],
          f"lm dist: {cfg.name}'s dropped_frac {line['dropped_frac']} "
          f"placed, {gather['dropped_frac']} on the gather path")
    return {"lm_dist_moe": cfg.name, "family": cfg.family,
            "reduced": {"n_layers": [full.n_layers, cfg.n_layers]},
            "traffic": {k: v for k, v in t.items() if k != "arch"},
            **line, "profiles": profiles,
            "placed_over_local": line["mesh_step_ms_median"]
            / line["local_step_ms_median"],
            "placed_over_gather": line["mesh_step_ms_median"]
            / gather["mesh_step_ms_median"],
            "gather": {k: gather[k] for k in (
                "step_path", "mesh_step_ms", "mesh_step_ms_median",
                "local_step_ms_median", "peak_allocated_bytes_per_rank",
                "dropped_frac", "bitwise_vs_one_device")}, **card}


def lm_serve_copy(torch, tm, model, dtype):
    """A one-device model holding ``model``'s weights in ``dtype``."""
    copy = tm.LM(model.cfg, "meta")
    copy.load_state_dict({n: w.to(dtype) for n, w in
                          model.state_dict().items()}, assign=True)
    return copy


@contextlib.contextmanager
def lm_moe_totals(out: list):
    """Under it, each MoE layer call's summed assignment counts per
    expert over the whole batch (``moe.first_come``'s ``total``, int32
    ``[e]``) appended to ``out``, in call order."""
    from repro_torch.models import moe
    orig = moe.first_come

    def counted(flat_e, e, blocks=None):
        res = orig(flat_e, e, blocks)
        out.append(res[3])
        return res

    moe.first_come = counted
    try:
        yield
    finally:
        moe.first_come = orig


def lm_moe_dropped(torch, cfg, totals: list, tokens: int) -> list[int]:
    """The dropped assignments of the first ``cfg.n_layers`` MoE calls of
    ``totals`` (a prefill's, ``lm_moe_totals``): each expert's summed
    count over the batch of ``tokens`` tokens beyond the capacity."""
    from repro_torch.models import moe
    cap = moe._capacity(cfg, tokens)
    return [int(torch.clamp(t.to(torch.int64) - cap, min=0).sum())
            for t in totals[:cfg.n_layers]]


def lm_dist_serve_line(torch, card, dev, t=LM_TRAFFIC, cfg=None,
                       tag="lm_dist_serve", seed=LM_SEED) -> dict:
    """``cfg`` (smollm-135m at full width and depth by default) served
    through the placed path on the one-rank NCCL (1, 1) mesh (inside
    ``nccl_world``): its bfloat16 weights and caches placed by
    ``serving_shardings``, the first wave of ``t`` through
    ``greedy_generate`` placed and on one device (the same bfloat16
    weights), the tokens equal; then each wave greedy step by step
    (``lm_serve_steps``), every step's logits and tokens bitwise equal,
    placed and one-device step ms (a MoE model's: each prefill's dropped
    assignments a layer, equal); the placed run's peak; one placed and
    one one-device decode step profiled (wall and device ms, idle share,
    host op events)."""
    from repro_torch import models as tm
    from repro_torch.configs import get_config
    from repro_torch.distributed import use_mesh
    from repro_torch.distributed.sharding import mesh_sizes
    from repro_torch.launch.inputs import (
        place_cache,
        place_params,
        serving_shardings,
    )
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm_serving as lms
    from repro_torch.models import moe
    cfg = get_config("smollm-135m") if cfg is None else cfg
    mesh = make_host_mesh()
    n, max_len = t["n_slots"], t["prompt_len"] + t["max_new"] + 8
    master = tm.init_params(cfg, seed=LM_SEED, device=dev)
    placed = place_params(master, serving_shardings(cfg, mesh, n,
                                                    max_len)[0])
    local = lm_serve_copy(torch, tm, master, torch.bfloat16)
    del master
    torch.cuda.empty_cache()
    prompts = lm_prompts(t["n_requests"], t["prompt_len"], cfg.vocab_size,
                         seed)
    steps = {"placed": [], "local": []}
    dropped = {"placed": [], "local": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in range(lm_n_waves(t)):
        slots = np.stack(prompts[w * n:(w + 1) * n]).astype(np.int32)
        if w == 0:      # the entry point, once (the replay below is greedy)
            with use_mesh(mesh):
                got = lms.greedy_generate(placed, cfg, slots, t["max_new"])
            want = lms.greedy_generate(local, cfg, slots, t["max_new"])
            check(np.array_equal(got, want), f"{tag}: the placed "
                  "greedy_generate's tokens are not the one-device tokens")
        runs = {}
        for name, m, ms in (("placed", placed, mesh), ("local", local, None)):
            totals = []
            with lm_moe_totals(totals):
                runs[name] = lm_serve_steps(torch, m, cfg, slots, max_len,
                                            t["max_new"] - 1, mesh=ms)
            if cfg.family == "moe":
                dropped[name].append(lm_moe_dropped(
                    torch, cfg, totals, n * t["prompt_len"]))
        check(all(lm_bitwise(torch, a, b) for a, b in zip(
            runs["placed"][1], runs["local"][1])), f"{tag}: wave "
              f"{w}'s placed logits are not bitwise the one-device logits")
        check(dropped["placed"] == dropped["local"], f"{tag}: dropped "
              f"assignments {dropped}")
        for name in steps:
            steps[name].append(runs[name][0])
    peak = torch.cuda.max_memory_allocated()
    placed_cache = runs["placed"][2]
    cur = torch.as_tensor(np.stack(prompts[:n]).astype(np.int32)[:, :1],
                          device=dev)
    profiles = {}
    for name, m, ms in (("placed", placed, mesh), ("local", local, None)):
        cache = tm.init_decode_state(cfg, n, max_len, dev)
        if ms is not None:
            cache = place_cache(cache, serving_shardings(cfg, mesh, n,
                                                         max_len)[1])

        def step(c, m=m, ms=ms):
            with (use_mesh(ms) if ms is not None
                  else contextlib.nullcontext()):
                return tm.decode_step(m, cfg, cur, c)

        profiles[name] = lm_step_profile(torch, lambda c, _, f=step: f(c),
                                         cache, None)
    del placed, local
    torch.cuda.empty_cache()
    decode = {k: [x for wave in v for x in wave[1:]]
              for k, v in steps.items()}
    full = get_config(cfg.name)
    return {tag: cfg.name, "mesh": mesh_sizes(mesh),
            "world_size": 1, "backend": "nccl", "traffic": t,
            "reduced": None if full.n_layers == cfg.n_layers else {
                "n_layers": [full.n_layers, cfg.n_layers]},
            "weights": "bfloat16, placed by serving_shardings",
            "tokens_equal": True, "logits_bitwise": True,
            **({"prefill_dropped_assignments": dropped["placed"],
                "capacity": moe._capacity(cfg, n * t["prompt_len"]),
                "assignments": n * t["prompt_len"] * cfg.top_k}
               if cfg.family == "moe" else {}),
            "prefill_ms": {k: [wave[0] for wave in v]
                           for k, v in steps.items()},
            "decode_ms_median": {k: statistics.median(v)
                                 for k, v in decode.items()},
            "decode_ms_p90": {k: float(np.percentile(v, 90))
                              for k, v in decode.items()},
            "placed_over_local_decode": statistics.median(decode["placed"])
            / statistics.median(decode["local"]),
            "peak_allocated_bytes": peak,
            "placed_cache_bytes": placed_cache,
            "profiles_decode_step": profiles, **card}


def lm_dist_moe_serve_line(torch, card, dev) -> dict:
    """The ``lm_dist_moe_serve`` phase's line: Moonlight at its published
    widths and ``LM_MOE``'s depth served placed on the one-rank NCCL mesh
    against one device (``lm_dist_serve_line`` at ``LM_MOE_TRAFFIC``)."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(LM_DIST_MOE["arch"]),
                              n_layers=LM_MOE["n_layers"])
    return lm_dist_serve_line(torch, card, dev, LM_MOE_TRAFFIC, cfg,
                              "lm_dist_moe_serve", LM_SEED + 4)


def lm_dist_launcher_line(card) -> dict:
    """``python -m repro_torch.launch.train --steps 6 --ckpt-every 3`` as
    rank 0 of 1 under ``COORDINATOR_ADDRESS`` (a ``file://`` rendezvous,
    NCCL): once uninterrupted (``a``), once SIGKILLed when ``step_3``
    appears and started again (``b``); ``b``'s final checkpoint bitwise
    ``a``'s."""
    import signal
    import tempfile
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(prefix="lm-dist-", dir=root) as tmp:
        tmp = Path(tmp)

        def rank0(tag):
            return {"COORDINATOR_ADDRESS": f"file://{tmp}/rdv-{tag}",
                    "RANK": "0", "WORLD_SIZE": "1"}

        runs = {}
        rc, out, runs["a"] = lm_ckpt_launch(tmp / "a", tmp / "a.log",
                                            extra_env=rank0("a"))
        on_mesh = "on mesh {'data': 1, 'model': 1} (cuda, world size 1)"
        check(rc == 0 and on_mesh in out and "resumed" not in out,
              f"lm dist: the mesh launcher exited {rc}:\n{out[-3000:]}")
        rc, out, runs["b_killed"] = lm_ckpt_launch(
            tmp / "b", tmp / "b.log", kill_at=LM_CKPT_KILL_AT,
            extra_env=rank0("b"))
        left = sorted(p.name for p in (tmp / "b").iterdir())
        check(rc == -signal.SIGKILL and LM_CKPT_FINAL not in left,
              f"lm dist: the run to crash exited {rc} with {left}:\n"
              f"{out[-3000:]}")
        rc, out, runs["b_resumed"] = lm_ckpt_launch(
            tmp / "b", tmp / "b2.log", extra_env=rank0("b2"))
        resumed = f"[train] resumed from step {LM_CKPT_KILL_AT}"
        check(rc == 0 and resumed in out and on_mesh in out,
              f"lm dist: the restarted mesh run exited {rc} without "
              f"{resumed!r}:\n{out[-3000:]}")
        a, b = (lm_ckpt_leaves(tmp / n / LM_CKPT_FINAL) for n in ("a", "b"))
        gaps = {k: g for k, g in lm_ckpt_gaps(a, b).items() if g is not None}
        check(not gaps, f"lm dist: the resumed mesh run's final checkpoint "
              f"is not bitwise the uninterrupted one's: {gaps}")
        return {"lm_dist_launcher": "smollm-135m",
                "command": "COORDINATOR_ADDRESS=file://... RANK=0 "
                           "WORLD_SIZE=1 python -m repro_torch.launch.train "
                           + " ".join(LM_CKPT_ARGS) + " --ckpt-dir DIR",
                "run_s": runs, "left_after_kill": left, "leaves": len(a),
                "resume_bitwise": True,
                "resumed_log": [ln for ln in out.splitlines()
                                if ln.startswith("[train]")], **card}


def lm_dist_multi_config(arch: str, n_layers):
    """``arch`` in float32, its depth cut to ``n_layers`` where given."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


def lm_dist_multi_rank(rank: int, store: str, out: str) -> None:
    """One of ``LM_DIST_MULTI["ranks"]`` NCCL ranks (card ``rank``): for
    each of ``LM_DIST_MULTI_CASES``, the float32 model placed on the
    (2, 2) data × model mesh, ``LM_DIST_MULTI["steps"]`` steps timed, then
    one more counted (collectives by op) and two profiled (the second
    recorded: wall and device ms, the NCCL kernels' share, host op
    events); rank 0 writes each case's losses, step ms, peak, counts,
    profile and whole parameters (those before the extra steps) to
    ``out`` with the case's index."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import models as tm
    from repro_torch import training as tt
    from repro_torch.distributed import use_mesh
    from repro_torch.launch.dryrun import CollectiveMode
    from repro_torch.launch.inputs import state_shardings
    from repro_torch.launch.mesh import make_auto_mesh
    from torch.autograd import DeviceType
    t = LM_DIST_MULTI
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", store=dist.FileStore(store, t["ranks"]),
                            rank=rank, world_size=t["ranks"])
    families = tt.step.TP_FAMILIES
    try:
        mesh = make_auto_mesh(t["mesh"], t["axes"])
        for i, (arch, n_layers, path) in enumerate(LM_DIST_MULTI_CASES):
            tt.step.TP_FAMILIES = families if path == "dense" else ()
            cfg = lm_dist_multi_config(arch, n_layers)
            check(lm_step_path(tt, cfg).startswith(path),
                  f"lm dist: {cfg.name} does not take the {path} path")
            step, batches, whole = lm_dist_setup(
                torch, tm, tt, cfg, "cuda", {**LM_DIST, "steps": t["steps"]})
            state = tt.place_train_state(whole, state_shardings(cfg, mesh))
            del whole
            torch.cuda.reset_peak_memory_stats()

            def mesh_step(s, batch):
                with use_mesh(mesh):
                    return step(s, batch)

            ms, losses, dropped = [], [], []
            for b in batches:
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = mesh_step(state, b)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(metrics["loss"]))
                dropped.append(float(metrics.get("dropped_frac", 0.0)))
            peak = torch.cuda.max_memory_allocated()
            params = {n: lm_host_copy(p)
                      for n, p in state.params.items()}
            # (CommDebugMode's module tracker fails on a MoE layer that
            # is recomputed under remat)
            with CollectiveMode() as comm:
                state, _ = mesh_step(state, batches[0])
            counts = dict(collections.Counter(n for n, _ in comm.records))
            wall, rows, averages = profile_rows(
                torch, lambda s: mesh_step(s, batches[0]), state)
            profile = {
                "profiled_wall_ms": wall,
                "device_ms": sum(r[1] for r in rows),
                "nccl_ms": sum(r[1] for r in rows if "nccl" in r[0].lower()),
                "kernels": sum(r[2] for r in rows),
                "host_ops": sum(ev.count for ev in averages
                                if ev.device_type != DeviceType.CUDA)}
            if rank == 0:
                np.savez(f"{out}.{i}.npz", losses=np.asarray(losses),
                         dropped=np.asarray(dropped),
                         ms=np.asarray(ms), peak=np.asarray(peak),
                         meta=np.asarray(json.dumps({
                             "collective_counts": counts,
                             "profile": profile})),
                         **{f"param|{n}": v for n, v in params.items()})
            del state, step, batches, params
            torch.cuda.empty_cache()
            dist.barrier()
        tt.step.TP_FAMILIES = families
        lm_dist_multi_serve_rank(torch, mesh, rank, out, "cuda")
    finally:
        tt.step.TP_FAMILIES = families
        dist.destroy_process_group()


def lm_dist_multi_serve_rank(torch, mesh, rank: int, out: str,
                             dev) -> None:
    """This rank's share of each ``LM_DIST_MULTI_SERVE`` case on ``mesh``
    (every rank calls it): the float32 model placed by
    ``serving_shardings``, a teacher-forced run and a greedy one; rank 0
    writes the logits, tokens, step ms, peak and cache bytes to ``out``
    with the case's index."""
    import torch.distributed as dist

    from repro_torch import models as tm
    from repro_torch.distributed import use_mesh
    from repro_torch.launch.inputs import place_params, serving_shardings
    from repro_torch.models import lm_serving as lms
    for j, (arch, n_layers, traffic, rows) in enumerate(LM_DIST_MULTI_SERVE):
        cfg = lm_dist_multi_config(arch, n_layers)
        prompts, forced, max_len = lm_dist_serve_inputs(cfg, traffic, rows)
        master = tm.init_params(cfg, seed=LM_SEED, device=dev)
        placed = place_params(master, serving_shardings(
            cfg, mesh, prompts.shape[0], max_len)[0], dtype=None)
        del master
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        totals = []
        with lm_moe_totals(totals):
            ms, logits, cache_bytes = lm_serve_steps(
                torch, placed, cfg, prompts, max_len, forced.shape[1],
                mesh=mesh, forced=forced)
        with use_mesh(mesh):
            toks = lms.greedy_generate(placed, cfg, prompts,
                                       traffic["max_new"])
        peak = torch.cuda.max_memory_allocated()
        if rank == 0:
            np.savez(f"{out}.serve{j}.npz", toks=toks, ms=np.asarray(ms),
                     peak=np.asarray(peak),
                     cache_bytes=np.asarray(cache_bytes),
                     dropped=np.asarray(lm_moe_dropped(
                         torch, cfg, totals, prompts.size)
                         if cfg.family == "moe" else [], np.int64),
                     logits=torch.stack(logits).double().numpy())
        del placed, logits
        torch.cuda.empty_cache()
        dist.barrier()


def lm_dist_serve_inputs(cfg, traffic: dict, rows):
    """(prompts [rows, prompt_len] int32, teacher-forced tokens [rows,
    teacher_forced (4 where ``traffic`` names none)], the cache's length)
    of a ``LM_DIST_MULTI_SERVE`` case; ``rows`` None: the traffic's
    slots."""
    rows = rows or traffic["n_slots"]
    n_forced = traffic.get("teacher_forced", 4)
    rng = np.random.default_rng(LM_SEED + 4)
    toks = rng.integers(0, cfg.vocab_size, (rows, traffic["prompt_len"]
                                            + n_forced)).astype(np.int32)
    plen = traffic["prompt_len"]
    return (toks[:, :plen], toks[:, plen:],
            plen + max(n_forced, traffic["max_new"]) + 8)


def lm_dist_multi_line(torch, card) -> list[dict]:
    """With ``LM_DIST_MULTI["ranks"]`` cards: each of
    ``LM_DIST_MULTI_CASES`` on the (2, 2) mesh against the same float32
    steps on one card, the loss within ``LM_DIST_LOSS_RTOL``, every
    parameter within the helper's bounds and, for a MoE model, each
    step's ``dropped_frac`` (exact counts over the microbatch) equal;
    with fewer, a line saying it did not run."""
    import tempfile

    import torch.multiprocessing as mp
    t = LM_DIST_MULTI
    n = torch.cuda.device_count()
    if n < t["ranks"]:
        return [{"lm_dist_multi": "not run",
                 "why": f"{n} CUDA device(s) here; the {t['mesh']} mesh of "
                        f"NCCL ranks needs {t['ranks']}", **card}]
    from repro_torch import models as tm
    from repro_torch import training as tt
    from repro_torch.configs import get_config
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "rank0"
        ctx = mp.start_processes(
            lm_dist_multi_rank,
            args=(str(Path(tmp) / "store"), str(out)),
            nprocs=t["ranks"], join=False, start_method="spawn")
        deadline = time.perf_counter() + t["timeout_s"]
        while not ctx.join(timeout=max(1.0, deadline - time.perf_counter())):
            if time.perf_counter() > deadline:
                for p in ctx.processes:
                    p.kill()
                check(False, f"lm dist: the {t['ranks']}-rank mesh run "
                      f"timed out")
        runs, serves = [], []
        for i in range(len(LM_DIST_MULTI_CASES)):
            with np.load(f"{out}.{i}.npz") as z:
                runs.append({k: z[k] for k in z.files})
        for j in range(len(LM_DIST_MULTI_SERVE)):
            with np.load(f"{out}.serve{j}.npz") as z:
                serves.append({k: z[k] for k in z.files})
    lines = []
    for (arch, n_layers, path), got in zip(LM_DIST_MULTI_CASES, runs):
        cfg = lm_dist_multi_config(arch, n_layers)
        step, batches, state = lm_dist_setup(
            torch, tm, tt, cfg, "cuda", {**LM_DIST, "steps": t["steps"]})
        losses, dropped = [], []
        for i in range(t["steps"]):
            state, metrics = step(state, batches[i])
            losses.append(float(metrics["loss"]))
            dropped.append(float(metrics.get("dropped_frac", 0.0)))
        worst = 0.0
        for name, p in state.params.items():
            want = p.detach().cpu().numpy()
            mesh_p = got[f"param|{name}"]
            check(np.allclose(mesh_p, want, rtol=LM_DIST_PARAM_RTOL,
                              atol=LM_DIST_PARAM_ATOL),
                  f"lm dist: {cfg.name}'s {name} on the {t['mesh']} mesh "
                  f"({path}) is off the one-rank run by "
                  f"{np.abs(mesh_p - want).max()}")
            worst = max(worst, float(np.abs(mesh_p - want).max()))
        rel = abs(got["losses"][-1] - losses[-1]) / abs(losses[-1])
        check(rel <= LM_DIST_LOSS_RTOL, f"lm dist: {cfg.name}'s loss "
              f"{got['losses']} on the mesh ({path}), {losses} on one rank")
        check(got["dropped"].tolist() == dropped,
              f"lm dist: {cfg.name}'s dropped_frac {got['dropped']} on the "
              f"mesh ({path}), {dropped} on one rank")
        del state, step, batches
        torch.cuda.empty_cache()
        lines.append({
            "lm_dist_multi": cfg.name, "dtype": "float32",
            "reduced": None if n_layers is None else {
                "n_layers": [get_config(arch).n_layers, n_layers]},
            "mesh": dict(zip(t["axes"], t["mesh"])), "ranks": t["ranks"],
            "step_path": path, "backend": "nccl",
            "losses": got["losses"].tolist(), "one_rank_losses": losses,
            "loss_rel_gap": rel, "param_max_abs_gap": worst,
            **({"dropped_frac": got["dropped"].tolist(),
                "one_rank_dropped_frac": dropped,
                "tokens_dropped": bool(max(dropped) > 0
                                       or got["dropped"].max() > 0)}
               if cfg.family == "moe" else {}),
            "step_ms": got["ms"].tolist(),
            "step_ms_median": float(np.median(got["ms"][1:])),
            "peak_allocated_bytes_rank0": int(got["peak"]),
            **json.loads(str(got["meta"])), **card})
    lines += lm_dist_multi_serve_lines(torch, card, serves)
    return lines


def lm_dist_multi_serve_lines(torch, card, serves: list,
                              dev="cuda") -> list[dict]:
    """Each ``LM_DIST_MULTI_SERVE`` case's (2, 2) run (``serves``, rank
    0's) against the same float32 weights on one card: every
    teacher-forced step's logits within ``LM_TOL`` of the largest
    |logit|, the greedy tokens equal but for near-ties
    (``lm_same_tokens``); rank 0's peak and cache bytes beside one
    card's."""
    from repro_torch import models as tm
    from repro_torch.configs import get_config
    from repro_torch.models import lm_serving as lms
    from repro_torch.models import moe
    t = LM_DIST_MULTI
    lines = []
    for (arch, n_layers, traffic, rows), got in zip(LM_DIST_MULTI_SERVE,
                                                    serves):
        cfg = lm_dist_multi_config(arch, n_layers)
        prompts, forced, max_len = lm_dist_serve_inputs(cfg, traffic, rows)
        model = tm.init_params(cfg, seed=LM_SEED, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        totals = []
        with lm_moe_totals(totals):
            ms, logits, cache_bytes = lm_serve_steps(
                torch, model, cfg, prompts, max_len, forced.shape[1],
                forced=forced)
        want = lms.greedy_generate(model, cfg, prompts, traffic["max_new"])
        peak = torch.cuda.max_memory_allocated()
        errs = []
        for a, b in zip(got["logits"], logits):
            b = b.double().numpy()
            errs.append(float(np.abs(a - b).max() / np.abs(b).max()))
        check(max(errs) <= LM_TOL, f"lm dist serve: {cfg.name} on the "
              f"{t['mesh']} mesh: logits {errs} off one card's")
        ties = sum(lm_same_tokens(torch, tm, model, cfg, p,
                                  got["toks"][i].tolist(), want[i].tolist(),
                                  f"{cfg.name} on {t['mesh']}, row {i}")
                   for i, p in enumerate(prompts))
        del model
        torch.cuda.empty_cache()
        lines.append({
            "lm_dist_multi_serve": cfg.name, "dtype": "float32",
            "reduced": None if n_layers is None else {
                "n_layers": [get_config(arch).n_layers, n_layers]},
            "mesh": dict(zip(t["axes"], t["mesh"])), "ranks": t["ranks"],
            "rows": int(prompts.shape[0]),
            "prompt_len": int(prompts.shape[1]), "max_len": max_len,
            "teacher_forced_steps": int(forced.shape[1]),
            "greedy_tokens": int(want.size), "near_ties": ties,
            "tol": LM_TOL, "logits_rel_err": errs,
            "step_ms": got["ms"].tolist(), "one_card_step_ms": ms,
            "peak_allocated_bytes": {"rank0": int(got["peak"]),
                                     "one_card": peak},
            "cache_bytes": {"rank0": int(got["cache_bytes"]),
                            "one_card": cache_bytes},
            **({"prefill_dropped_assignments": {
                "rank0": got["dropped"].tolist(),
                "one_card": lm_moe_dropped(torch, cfg, totals,
                                           prompts.size)},
                "capacity": moe._capacity(cfg, prompts.size),
                "assignments": int(prompts.size * cfg.top_k)}
               if cfg.family == "moe" else {}), **card})
    return lines


# the dry run: python -m repro_torch.launch.dryrun on one cell at
# full width on both production meshes (fake ranks, nothing allocated),
# then the mesh step at LM_DIST's traffic traced on a one-rank fake (1, 1)
# mesh and held against lm_dist_step's real one-rank NCCL step
LM_DRYRUN_CLI = ("--arch", "smollm-135m", "--shape", "decode_32k",
                 "--mesh", "both")
LM_DRYRUN_RUN_S = 300


def lm_dryrun_lines(torch, card, dist: dict) -> list[dict]:
    """(a) ``python -m repro_torch.launch.dryrun`` with ``LM_DRYRUN_CLI``
    from the checkout: exit 0, every cell a result, its JSON printed.
    (b) ``lower_train_cell`` of ``LM_DIST``'s model and traffic on a
    one-rank fake world's (1, 1) mesh (this process, after ``nccl_world``
    is gone): its placed state's bytes, its FLOPs and its collectives by
    kind equal ``dist`` (``lm_dist_step_line``'s placed bytes, and its
    counted real step's ``FlopCounterMode`` and ``CommDebugMode``); its
    predicted peak beside the real step's measured one, with the ratio.
    (c) ``torch.cuda.memory_allocated()`` the same before and after."""
    import os
    import tempfile

    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_auto_mesh
    root = Path(__file__).resolve().parent
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, (
        str(root / "src"), os.environ.get("PYTHONPATH")))))
    with tempfile.TemporaryDirectory(prefix="lm-dryrun-", dir=root) as tmp:
        out = Path(tmp) / "dryrun.json"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun",
             *LM_DRYRUN_CLI, "--out", str(out)], cwd=root, env=env,
            capture_output=True, text=True, timeout=LM_DRYRUN_RUN_S)
        cli_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"lm dryrun: the sweep exited "
              f"{proc.returncode}:\n{proc.stdout[-3000:]}"
              f"{proc.stderr[-3000:]}")
        cli = json.loads(out.read_text())
    check(len(cli["results"]) == 2 and not cli["failures"],
          f"lm dryrun: {len(cli['results'])} cells, failures "
          f"{cli['failures']}")

    t = LM_DIST
    cfg = get_config(t["arch"])
    cell = ShapeCell("lm_dist", t["seq_len"], t["global_batch"], "train",
                     microbatch=t["global_batch"] // t["microbatches"])
    t0 = time.perf_counter()
    with dr.fake_world(1):
        mesh = make_auto_mesh((1, 1), ("data", "model"), device_type="cpu")
        traced = dr.lower_train_cell(cfg, cell, mesh)
    trace_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    real = dist["counted_step"]
    real_ops = dict.fromkeys(dr.KINDS, 0)
    for name, n in real["collective_counts"].items():
        real_ops[dr.KIND_OF[name]] += n
    mem = traced["memory"]
    check(mem["placed_state_bytes"] == dist["placed_state_bytes_per_rank"],
          f"lm dryrun: placed state {mem['placed_state_bytes']} B traced, "
          f"{dist['placed_state_bytes_per_rank']} B on the card")
    check(traced["flops"] == real["flops"], f"lm dryrun: {traced['flops']} "
          f"FLOPs traced, {real['flops']} counted on the card")
    check(traced["collective_ops"] == real_ops, f"lm dryrun: collectives "
          f"{traced['collective_ops']} traced, {real_ops} on the card")
    check(after == before, f"lm dryrun: memory_allocated {before} B before "
          f"the dry run, {after} B after")
    peak = dist["peak_allocated_bytes_per_rank"]
    return [
        {"lm_dryrun_cli": " ".join(("python -m repro_torch.launch.dryrun",
                                    *LM_DRYRUN_CLI)),
         "run_s": cli_s, **cli, **card},
        {"lm_dryrun_step": cfg.name, "mesh": [1, 1], "traffic": t,
         "trace_s": trace_s,
         "placed_state_bytes": {"traced": mem["placed_state_bytes"],
                                "card": dist["placed_state_bytes_per_rank"]},
         "flops": {"traced": traced["flops"], "card": real["flops"]},
         "collective_ops": {"traced": traced["collective_ops"],
                            "card": real_ops},
         "collective_bytes_traced": traced["collective_bytes"],
         "peak_bytes": {"traced": mem["peak_bytes"], "card": peak,
                        "traced_over_card": mem["peak_bytes"] / peak},
         "memory_traced": mem,
         "memory_allocated_bytes": {"before": before, "after": after},
         **card}]


MESH_VARIANTS = ((False, False), (True, False), (False, True), (True, True))
MESH_REPS = 5
MESH_STEP_SIZES = (2, 4, 8)
MESH_STEP_ROWS = 1 << 23     # the 8M-row edges' padded side


@contextlib.contextmanager
def nccl_world(torch):
    """A NCCL process group of world size 1 on card 0, its rendezvous a
    ``FileStore`` in a temporary directory; destroyed on the way out."""
    import tempfile

    import torch.distributed as dist
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(str(Path(tmp) / "store"), 1),
            rank=0, world_size=1)
        try:
            yield dist
        finally:
            dist.destroy_process_group()


def wall_ms(torch, fn, arg, reps: int = MESH_REPS) -> list[float]:
    """Host-clock ms of ``reps`` calls of ``fn(arg)``, each synchronised."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(arg)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def mesh_lines(torch, kernels, plain, errs, db, schema, plans, oracle, card,
               dev):
    """The ``mesh`` phase: V.1 through ``DistributedExecutor.compile`` on a
    ``"cuda"`` DeviceMesh of shape (1,) named ("data",) over NCCL, with
    presort off and on and the dense domain off and on, and
    ``compile_multi`` of the three queries; the kernels' counts set to 0
    just before those runs and read just after.  Each answer must equal
    the local Executor's over the same padded capacities bitwise and the
    numpy oracle's; every K1/K2 call of the counted runs is recorded and
    held against its plain version.  Then each (variant, query) is timed
    against the local compiled run; with presort and the dense domain off,
    also the root state's all-gather alone, and one run of each side under
    ``torch.profiler`` (device ms, idle share, top kernels).
    Returns (lines, launches, the recorded K1/K2 calls)."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core import Executor
    from repro_torch.core.distributed import DistributedExecutor

    check(plans["minmax"].mode == plans["count"].mode == "oma"
          and plans["median"].mode == "opt_plus",
          f"V.1's plans: {[p.mode for p in plans.values()]}")
    mesh = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("data",))
    dexes = {v: DistributedExecutor(schema, mesh, presort=v[0],
                                    dense_domain=v[1])
             for v in MESH_VARIANTS}
    dex0 = dexes[(False, False)]
    t0 = time.perf_counter()
    sharded = dex0.shard_db(db)
    torch.cuda.synchronize()
    setup = {"mesh_setup": {
        "topology": dex0.topology(), "device": str(dex0.device),
        "capacities": {r: t.capacity for r, t in sharded.items()},
        "shard_db_s": time.perf_counter() - t0, **card}}
    local_db = {r: t.pad_to(dex0.shard_capacity(t.capacity))
                for r, t in db.items()}
    seen = []

    def keep(name, wrapper, args, **kw):
        out = wrapper(*args, **kw)
        seen.append((name, args, out))
        return out

    fns = {(v, q): dex.compile(plans[q]) for v, dex in dexes.items()
           for q in QUERIES}
    fused_fn = dex0.compile_multi([plans[q] for q in QUERIES])
    for _, _, k in kernels.values():
        k.reset_counts()
    torch.cuda.synchronize()
    with routed(kernels, keep):
        got = {key: fn(sharded) for key, fn in fns.items()}
        fused = fused_fn(sharded)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, (_, _, k) in kernels.items()}
    for name in ("semi_join", "freq_join"):
        check(launches[name] > 0, f"the mesh phase launched {name} no time")
    check(launches["segment_sum"] == 0, "the ring launched segment_sum "
          f"{launches['segment_sum']} times; pre-grouping is off the ring")
    held = hold_calls(torch, plain, errs, "mesh", seen, dev)
    for name, n in launches.items():
        check(held.get(name, 0) == n,
              f"mesh: {name} launched {n} times, {held.get(name, 0)} held")

    local_fns = {(dense, q): Executor(local_db, schema,
                                      dense_domain=dense).compile(plans[q])
                 for dense in (False, True) for q in QUERIES}
    lines = [setup]
    for (v, q), res in got.items():
        presort, dense = v
        want = local_fns[(dense, q)](local_db)
        diff = answers_diff(torch, res, want)
        check(diff is None, f"mesh {q} presort={presort} dense={dense} "
              f"against the local Executor: {diff}")
        check(answers_equal(res, oracle[q]),
              f"mesh {q} presort={presort} dense={dense}: {res} != "
              f"{oracle[q]}")
        line = {"mesh": q, "mode": plans[q].mode, "presort": presort,
                "dense_domain": dense,
                "answer": {k: t.item() for k, t in res.items()},
                "mesh_ms": wall_ms(torch, fns[(v, q)], sharded),
                "local_ms": wall_ms(torch, local_fns[(dense, q)], local_db)}
        line["mesh_median_ms"] = statistics.median(line["mesh_ms"])
        line["local_median_ms"] = statistics.median(line["local_ms"])
        if v == (False, False):
            plan = plans[q]
            st = dex0._trace_plan(sharded, plan, {}, {},
                                  root=dex0._agg_state_node(plan))
            parts = [c for k, c in st.cols.items()
                     if k in dex0._agg_cols(plan)] + [st.freq]
            line["gather_ms"] = time_ms(
                torch, lambda: [dex0._gather(t) for t in parts])
            line["gather_bytes"] = sum(t.numel() * t.element_size()
                                       for t in parts)
            line["mesh_profile"] = profile_run(torch, fns[(v, q)], sharded)
            line["local_profile"] = profile_run(torch, local_fns[(dense, q)],
                                                local_db)
        lines.append({**line, **card})
    for q, res in zip(QUERIES, fused):
        diff = answers_diff(torch, res, got[((False, False), q)])
        check(diff is None, f"mesh compile_multi {q} against solo: {diff}")
    lines.append({"mesh_fused": list(QUERIES),
                  "mesh_ms": wall_ms(torch, fused_fn, sharded), **card})
    lines.append({"mesh_launches": launches, "held": held, **card})
    kept = [(name, args) for name, args, _ in seen]
    del sharded, local_db, got, fused, seen
    torch.cuda.empty_cache()
    return lines, launches, kept


# the serve_mesh phase: QueryService(mesh=...) on the one-rank NCCL mesh
SERVE_MESH_MODES = ("auto", "opt_plus", "oma", "opt")
# tests/helpers/mesh_service_check.py's GROUPBY and COSTLY queries
SERVE_MESH_EXTRA = {
    "groupby": """SELECT COUNT(*) AS suppliers, AVG(s.s_acctbal) AS avg_bal
        FROM supplier s, nation n
        WHERE s.s_nationkey = n.n_nationkey
        GROUP BY s.s_nationkey""",
    "costly": """SELECT SUM(ps.ps_supplycost), COUNT(*)
        FROM partsupp ps, part p
        WHERE ps.ps_partkey = p.p_partkey AND p.p_price > 1500.0""",
}


def serve_mesh_lines(torch, tsvc, kernels, plain, errs, db, schema, h,
                     oracle, dev, card):
    """The ``serve_mesh`` phase: ``QueryService(mesh=...)`` on the phase's
    one-rank NCCL mesh, in modes auto, opt_plus, oma and opt, beside a
    local ``QueryService`` of the same mode and ``min_bucket`` (one shard
    pads as one device does).  Each mode serves V.1 minmax, count and
    median and ``mesh_service_check.py``'s GROUPBY and COSTLY as one batch,
    then each alone; the auto service also serves one ``submit_async`` and
    ``explain()``, and last, partsupp grows inside its bucket.  The
    kernels' counts are set to 0 just before the mesh services' requests
    and read just after (the local services and the timed reps run
    outside), every kernel call of those requests is held against its plain
    version after the request, each answer must equal the local service's
    (bitwise; the grouped AVG within ``grouped_avg_bound``, as ``index_add_``
    adds in another order on every run) with the same errors where a mode
    cannot plan a query, and V.1's the oracle's.  Then warm ``submit`` of
    V.1 is timed, mesh against local, each rep of one beside one of the
    other, with the ``ring_sweep`` span's ms.  Yields one line per case."""
    import tempfile

    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.tables import Table

    queries = {q: SERVE_SQL[q][0] for q in QUERIES}
    queries.update(SERVE_MESH_EXTRA)
    mesh = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("data",))
    pending = []

    def keep(name, wrapper, args, **kw):
        out = wrapper(*args, **kw)
        pending.append((name, args, out))
        return out

    held = {name: 0 for name in kernels}

    def drain(tag):
        torch.cuda.synchronize()
        calls = list(pending)
        pending.clear()
        for name, n in hold_calls(torch, plain, errs, tag, calls,
                                  dev).items():
            held[name] += n

    def counted(fn):
        for _, _, k in kernels.values():
            k.reset_counts()
        torch.cuda.synchronize()
        with routed(kernels, keep):
            out = fn()
        torch.cuda.synchronize()
        return out, {name: k.launches for name, (_, _, k) in kernels.items()}

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="serve-mesh-cache-",
                                     dir=Path(__file__).resolve().parent
                                     ) as cache_dir:
        # one cache_dir: the tables' statistics are computed once
        t0 = time.perf_counter()
        svcs = {mode: (tsvc.QueryService(db, schema, mode=mode, mesh=mesh,
                                         cache_dir=cache_dir),
                       tsvc.QueryService(db, schema, mode=mode,
                                         cache_dir=cache_dir))
                for mode in SERVE_MESH_MODES}
        auto = svcs["auto"][0]
        yield {"serve_mesh": "setup", "services_s": time.perf_counter() - t0,
               "gauges": {k: v for k, v in auto.metrics_v2()["gauges"].items()
                          if k.startswith("mesh_")}, **card}

        # -- the mesh services' requests, counted -------------------------
        def drive():
            got = {}
            for mode, (msvc, _) in svcs.items():
                batch = msvc.submit_many(list(queries.values()))
                drain(f"serve_mesh {mode} batch")
                solo = {}
                for (q, sql), r in zip(queries.items(), batch):
                    if r.ok:
                        solo[q] = msvc.submit_many([sql])[0]
                        drain(f"serve_mesh {mode} {q}")
                got[mode] = (batch, solo)
            fut = auto.submit_async(queries["minmax"])
            got["async"] = fut.result(120)
            drain("serve_mesh async")
            got["explain"] = auto.explain(queries["minmax"])
            drain("serve_mesh explain")
            return got

        got, launches = counted(drive)
        for mode, (msvc, lsvc) in svcs.items():
            batch, solo = got[mode]
            want = lsvc.submit_many(list(queries.values()))
            answers = {}
            for (q, sql), r, w in zip(queries.items(), batch, want):
                check(r.ok == w.ok and (r.ok or type(r.error) is
                                        type(w.error)),
                      f"serve_mesh {mode} {q}: mesh {r.error!r}, local "
                      f"{w.error!r}")
                if not r.ok:
                    answers[q] = type(r.error).__name__
                    continue
                bounds = grouped_avg_bound(torch, h, w.values, "avg_bal") \
                    if q == "groupby" else None
                for tag, res in (("batch", r), ("solo", solo[q])):
                    diff = answers_diff(torch, res.values, w.values, bounds)
                    check(diff is None, f"serve_mesh {mode} {q} {tag} "
                          f"against the local service: {diff}")
                if q in QUERIES:
                    check(serve_equal(r.values, oracle[q]),
                          f"serve_mesh {mode} {q}: {r.values} != "
                          f"{oracle[q]}")
                    answers[q] = {k: v.item() for k, v in r.values.items()}
                else:
                    answers[q] = "equal to the local service"
            yield {"serve_mesh": mode, "answers": answers,
                   "fused": [r.stats.fused for r in batch],
                   "exec_source": [r.stats.exec_source for r in batch],
                   **card}
        check(got["async"].ok and serve_equal(got["async"].values,
                                              oracle["minmax"]),
              f"serve_mesh async: {got['async'].error!r}")
        exp = got["explain"]
        yield {"serve_mesh_explain": {
            "topology": exp["topology"], "sharding": exp["sharding"],
            "text": [ln.strip() for ln in exp["text"].splitlines()
                     if "sharding" in ln]}, **card}

        # -- warm submit, mesh against local ------------------------------
        # each request's stages from its TraceSpan tree, and the time
        # outside them (admission, the lane's hand-off, bookkeeping)
        lauto = svcs["auto"][1]
        for q in QUERIES:
            sql = queries[q]
            times = {"mesh_submit_ms": [], "local_submit_ms": [],
                     "ring_sweep_ms": [], "local_run_ms": []}
            stages = {"mesh": {}, "local": {}}
            for svc in (auto, lauto):     # the local one has served it
                served(svc, sql, f"serve_mesh warm-up {q}")   # fused only
            for _ in range(TIMING_REPS):
                for side, svc in (("mesh", auto), ("local", lauto)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = served(svc, sql, f"serve_mesh warm {q}")
                    ms = (time.perf_counter() - t0) * 1e3
                    times[f"{side}_submit_ms"].append(ms)
                    check(serve_equal(res.values, oracle[q]),
                          f"serve_mesh warm {q}: wrong answer")
                    check(res.stats.exec_cache_hit,
                          f"serve_mesh warm {q}: not an exec-cache hit")
                    spans = {sp.name: sp.duration_s * 1e3
                             for sp in res.stats.trace.walk()}
                    if svc is auto:
                        times["ring_sweep_ms"].append(spans["ring_sweep"])
                    else:
                        times["local_run_ms"].append(spans["run"])
                    st = stage_ms(res)
                    st["outside_stages"] = ms - sum(st.values())
                    for k, v in st.items():
                        stages[side].setdefault(k, []).append(v)
            med = {k: statistics.median(v) for k, v in times.items()}
            yield {"serve_mesh_warm": q, **med,
                   "mesh_over_local_ms": med["mesh_submit_ms"]
                   - med["local_submit_ms"], "reps": TIMING_REPS,
                   **{f"{side}_stages_ms": {k: statistics.median(v)
                                            for k, v in st.items()}
                      for side, st in stages.items()},
                   "mesh_submit_all_ms": times["mesh_submit_ms"], **card}
        # the lane's hand-off alone: a step that does nothing, called from
        # this thread and run on the lane
        lane = []
        for _ in range(TIMING_REPS):
            t0 = time.perf_counter()
            auto._sync.run("no-op", lambda _: None)
            lane.append((time.perf_counter() - t0) * 1e3)
        yield {"serve_mesh_lane": "no-op step", "ms": statistics.median(lane),
               "all_ms": lane, **card}

        # -- growth inside partsupp's bucket, counted ---------------------
        ps = h["partsupp"]
        n_ps = len(ps["ps_partkey"])
        rng = np.random.default_rng(SEED + 1)
        extra = {c: v[rng.integers(0, n_ps, SERVE_GROWTH_ROWS)]
                 for c, v in ps.items()}
        extra["ps_partkey"] = rng.permutation(extra["ps_partkey"])
        grown = {c: np.concatenate([ps[c], extra[c]]) for c in ps}
        grown_oracle = v1_oracle({**h, "partsupp": grown})
        before = auto.metrics()

        def grow():
            auto.update_table("partsupp", Table.from_numpy(grown, device=dev))
            out = {}
            for q in QUERIES:
                out[q] = served(auto, queries[q], f"serve_mesh growth {q}")
                drain(f"serve_mesh growth {q}")
            return out

        res, grow_launches = counted(grow)
        m = auto.metrics()
        for q, r in res.items():
            check(serve_equal(r.values, grown_oracle[q]),
                  f"serve_mesh growth {q}: {r.values} != {grown_oracle[q]}")
            check(r.stats.exec_cache_hit,
                  f"serve_mesh growth {q}: not an exec-cache hit")
        recompiles = m["compiles"] - before["compiles"]
        check(recompiles == 0, f"serve_mesh growth: {recompiles} recompiles")
        yield {"serve_mesh_growth": SERVE_GROWTH_ROWS,
               "recompiles": recompiles,
               "bucket_invalidations": m["bucket_invalidations"]
               - before["bucket_invalidations"], **card}
        for svc_pair in svcs.values():
            for svc in svc_pair:
                svc.close()
        del svcs, auto, lauto
    launches = {name: launches[name] + grow_launches[name]
                for name in kernels}
    for name, n in launches.items():
        check(n > 0, f"the serve_mesh phase launched {name} no time")
        check(held[name] == n, f"serve_mesh: {name} launched {n} times, "
              f"{held[name]} calls held")
    torch.cuda.empty_cache()
    yield {"kernels_serve_mesh": [
        {"name": name, "launches": launches[name], "held": held[name],
         "max_abs_err": max(errs[name])} for name in kernels],
        "phase_s": time.perf_counter() - t_phase, **card}


def mesh_step_lines(torch, kern, plain, errs, ring_calls, card):
    """The ``mesh_steps`` phase: one rank's ring steps over P = 2, 4 and 8
    child blocks, on the card, for each distinct K1/K2 call of the mesh
    phase with an 8M-row side (``ps⋉p``, ``s⋉ps``, ``ps⋉s``; a ring step's
    parent frequency is 1).  Each step is the ring's own step function: K1
    or K2 against one block (``_local_multiplier``), or with presort on,
    two searchsorteds and a gather against that block's presorted payload,
    then the fold into the running multiplier.  The folded result must be
    bitwise the one-call kernel's, and every step's kernel output its
    plain version's.  Prints the steps' summed device ms (queued CUDA
    events) beside the one call's and its bytes bound."""
    from repro_torch.core import distributed as tdist

    edges = {}
    for name, args in ring_calls:
        pk, _, ck, _ = args
        if max(pk.shape[0], ck.shape[0]) >= MESH_STEP_ROWS:
            edges.setdefault((name, pk.shape[0], ck.shape[0]), args)
    check(len(edges) >= 3, f"the mesh phase made {len(edges)} distinct "
          "8M-row ring calls")
    lines = []
    for (name, np_, nc), (pk, unit, ck, cf) in sorted(edges.items()):
        mode = "any" if name == "semi_join" else "sum"
        one = check_join(torch, kern[name], plain[name], errs[name],
                         f"mesh_steps {name} one call", pk, unit, ck, cf)
        one_ms = time_ms(torch, lambda: kern[name](pk, unit, ck, cf),
                         queued=True)
        for p in MESH_STEP_SIZES:
            cks, cfs = ck.view(p, -1), cf.view(p, -1)
            mult = torch.zeros_like(unit)
            for b in range(p):
                m = hold_join(torch, plain[name], errs[name],
                              f"mesh_steps {name} P={p} step {b}",
                              tdist._local_multiplier(pk, cks[b], cfs[b],
                                                      mode, unit),
                              pk, unit, cks[b], cfs[b])
                mult = tdist.accumulate(mult, m, mode)
            ring = unit * ((mult > 0).to(unit.dtype) if mode == "any"
                           else mult)
            check(torch.equal(ring, one),
                  f"mesh_steps {name} P={p}: the folded steps differ from "
                  "the one call")
            payloads = [tdist.presort_payload(cks[b], cfs[b], mode,
                                              unit.dtype) for b in range(p)]
            mult = torch.zeros_like(unit)
            for pay in payloads:
                mult = tdist.accumulate(
                    mult, tdist.presort_multiplier(pk, *pay, unit.dtype),
                    mode)
            pre = unit * ((mult > 0).to(unit.dtype) if mode == "any"
                          else mult)
            check(torch.equal(pre, one),
                  f"mesh_steps {name} P={p}: the presort steps differ from "
                  "the one call")
            steps = [lambda b=b: tdist.accumulate(
                         unit, tdist._local_multiplier(pk, cks[b], cfs[b],
                                                       mode, unit), mode)
                     for b in range(p)]
            pre_steps = [lambda pay=pay: tdist.accumulate(
                             unit, tdist.presort_multiplier(pk, *pay,
                                                            unit.dtype),
                             mode)
                         for pay in payloads]
            step_ms = [statistics.median(t)
                       for t in split_ms(torch, steps, queued=True)]
            pre_ms = [statistics.median(t)
                      for t in split_ms(torch, pre_steps, queued=True)]
            lines.append({
                "mesh_steps": name, "shape": [np_, nc], "P": p,
                "steps_device_ms": sum(step_ms), "step_device_ms": step_ms,
                "presort_steps_device_ms": sum(pre_ms),
                "one_call_device_ms": one_ms,
                "one_call_bound_ms": bound_ms(join_bytes(np_, nc)),
                "steps_bound_ms": bound_ms(p * join_bytes(np_, 0)
                                           + join_bytes(0, nc)),
                **card})
    return lines


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no port at {src / 'repro_torch'}: run the script "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch import core as tc
    from repro_torch import data
    from repro_torch import service as tsvc
    from repro_torch.core import Executor, plan_query
    from repro_torch.data import make_graph_db, make_tpch_db, tpch_v1_query
    from repro_torch.kernels import _build
    from repro_torch.kernels import freq_join as fj
    from repro_torch.kernels import segment_sum as ss
    from repro_torch.kernels import semi_join as sj

    t_start = time.perf_counter()
    dev = "cuda"
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"setup: built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    # each source's nvcc seconds (all started together) and ptxas's report
    # of its kernel instances: none may spill registers
    build = {}
    for source, lib in sorted(libs.items()):
        rows = _build.ptxas_report(lib.with_suffix(".log"))
        spills = [r for r in rows if r["spill_stores"] or r["spill_loads"]]
        check(rows and not spills, f"{source}: {len(rows)} instances, "
              f"spilling {spills}")
        build[source] = {"seconds": _build.BUILD_SECONDS.get(source),
                         "instances": len(rows),
                         "max_registers": max(r["registers"] for r in rows)}
    log(json.dumps({"build": build}))

    t0 = time.perf_counter()
    db, schema = make_tpch_db(scale=SCALE, seed=SEED, device=dev)
    torch.cuda.synchronize()
    log(f"setup: make_tpch_db(scale={SCALE}) in "
        f"{time.perf_counter() - t0:.2f} s: " + ", ".join(
            f"{r} {t.capacity}" for r, t in db.items()))
    plans = {q: plan_query(tpch_v1_query(q), schema) for q in QUERIES}
    log("plans: " + ", ".join(f"{q} {p.mode}" for q, p in plans.items()))

    # -- the inputs the main path hands each kernel, recorded on one run --
    kernels = {"semi_join": (sj, "semi_join_cuda", sj.K1),
               "freq_join": (fj, "freq_join_cuda", fj.K2),
               "segment_sum": (ss, "segment_sum_cuda", ss.K3)}
    calls = {name: [] for name in kernels}

    def keep(name, wrapper, args, **kw):
        calls[name].append(args)
        return wrapper(*args, **kw)

    with routed(kernels, keep):
        for q in QUERIES:
            Executor(db, schema).execute(plans[q])
    torch.cuda.synchronize()

    # -- each kernel against its plain version, timed, on those inputs ----
    plain = {"semi_join": sj.semi_join_plain,
             "freq_join": fj.freq_join_plain,
             "segment_sum": ss.segment_sum_plain}
    kern = {"semi_join": sj.semi_join_cuda, "freq_join": fj.freq_join_cuda,
            "segment_sum": ss.segment_sum_cuda}
    errs = {name: [] for name in kernels}
    timing = kernel_calls(torch, calls, kern, plain, errs)
    joins = JOINS
    for _, _, k in kernels.values():
        k.reset_counts()
    side_hits = {}
    for tag, pk, pf, ck, cf in synthetic_cases(torch, make_graph_db, dev):
        side = fj.join_path(pk.shape[0], ck.shape[0]).side
        for name, mode in joins:
            got = check_join(torch, kern[name], plain[name], errs[name],
                             f"{name} {tag}", pk, pf, ck, cf)
            if tag.startswith("key -1 in both"):
                # parent rows with key −1 whose answer came through the
                # side slot: every one with pf > 0 in any mode
                hits = int(((pk == -1) & (got != 0)).sum())
                side_hits[f"{name} {side} {tag.split()[-1]}"] = hits
                check(hits > 0, f"{name} {tag}: no parent row with key -1 "
                      "matched through the side slot")
            if tag.startswith("zipf"):
                log(json.dumps({
                    "synthetic": tag, "kernel": name, "side": side,
                    "shape": [pk.shape[0], ck.shape[0]],
                    "ms": time_ms(torch, lambda: kern[name](pk, pf, ck, cf)),
                    "plain_ms": time_ms(
                        torch, lambda: plain[name](pk, pf, ck, cf)),
                    "bound_ms": bound_ms(join_bytes(pk.shape[0],
                                                    ck.shape[0]))}))
        keys = torch.sort(ck).values
        check_segsum(torch, ss.segment_sum_cuda, ss.segment_sum_plain,
                     errs["segment_sum"], f"segment_sum {tag}", keys, cf)
    for line in segsum_cases(torch, ss, errs["segment_sum"], dev):
        log(json.dumps(line))
    log(json.dumps({"synthetic_paths": took_every_path(
        kernels, joins, fj.SIDES, "the synthetic cases"),
        "side_slot_hits": side_hits}))
    log("kernels equal their plain versions: int32 bitwise, float32 within "
        "the stated bounds")
    for name, mode in joins:
        for i, args in enumerate(calls[name]):
            log(json.dumps(phase_line(torch, fj, kernels[name][2],
                                      kern[name], plain[name], name, i, mode,
                                      args)))
    for line in cutoff_lines(torch, fj, kernels, dev):
        log(json.dumps(line))

    # -- the main path, counted ------------------------------------------
    host = {r: {c: t.cpu().numpy() for c, t in tab.columns.items()}
            for r, tab in db.items()}
    oracle = v1_oracle(host)
    for _, _, k in kernels.values():
        k.reset_counts()
    query_lines, main_steps = [], {}
    for q in QUERIES:
        ex = Executor(db, schema)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ex.execute(plans[q])
        torch.cuda.synchronize()
        exec_s = time.perf_counter() - t0
        fn = ex.compile(plans[q])
        run_s = []
        for _ in range(COMPILED_RUNS):
            t0 = time.perf_counter()
            out = fn(db)
            torch.cuda.synchronize()
            run_s.append(time.perf_counter() - t0)
        want = oracle[q]
        check(answers_equal(res, want), f"{q} execute: {res} != {want}")
        check(answers_equal(out, want), f"{q} compile: {out} != {want}")
        main_steps[q] = res["__stats__"].steps
        query_lines.append({
            "query": q, "mode": plans[q].mode,
            "answer": {k: np.asarray(v).item() for k, v in want.items()},
            "execute_ms": exec_s * 1e3,
            "compiled_ms": [s * 1e3 for s in run_s],
            "peak_live_tuples": res["__stats__"].peak_tuples})
    launches = {name: k.launches for name, (_, _, k) in kernels.items()}
    for name, n in launches.items():
        check(n > 0, f"the main path launched {name} no time")
    paths = took_every_path(kernels, joins, fj.SIDES, "the main path")
    log(f"main path launches: {launches}")
    log(json.dumps({"main_path_paths": paths}))

    for line in query_lines:
        log(json.dumps(line))
    for q in QUERIES:
        prof = profile_run(torch, Executor(db, schema).compile(plans[q]), db)
        log(json.dumps({"profile": q, **prof}))

    # -- the materialising baselines, counted on their own -----------------
    calls_timed = {name: len(cl) for name, cl in calls.items()}
    calls.clear()          # the main path's kernel inputs
    torch.cuda.synchronize()
    log(json.dumps({"baseline_setup": {
        "db_bytes": sum(t.numel() * t.element_size() for tab in db.values()
                        for t in (*tab.columns.values(), tab.freq)),
        "allocated_bytes": torch.cuda.memory_allocated()}}))
    for line in baseline_lines(torch, tc, kernels, plain, errs, db, schema,
                               plans, oracle, tpch_v1_query, dev):
        log(json.dumps(line))
    fig6_32 = fig6_lines(torch, tc, data, kernels, plain, errs, dev)
    for line in fig6_32:
        log(json.dumps(line))
    log("the baseline and fig6 phases' kernel calls equal their plain "
        "versions")

    # -- 64-bit frequencies, counted on their own ----------------------------
    card = {"card": smi}
    errs64 = {name: [] for name in kernels}
    t0 = time.perf_counter()
    v1_64, timing64, launches64, calls64 = x64_v1_lines(
        torch, tc, fj, kernels, kern, plain, errs64, db, schema, plans,
        oracle, main_steps, tpch_v1_query, card, dev)
    for line in v1_64:
        log(json.dumps(line))
    for line in fig6_lines(torch, tc, data, kernels, plain, errs64, dev,
                           freq_dtype=torch.int64, same_as=fig6_32):
        log(json.dumps({**line, **card}))
    for line in table2_lines(torch, tc, data, kernels, plain, errs64, dev,
                             card):
        log(json.dumps(line))
    for line in x64_synthetic_lines(torch, fj, ss, kernels, kern, plain,
                                    errs64, dev, card):
        log(json.dumps(line))
    log(f"x64: every 64-bit kernel call equals its plain version (int64 "
        f"bitwise, float64 within the stated bounds) in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- the serving tier, counted on its own ----------------------------
    errs_serve = {name: [] for name in kernels}
    for line in serve_lines(torch, tc, tsvc, kernels, plain, errs_serve, db,
                            schema, host, oracle, dev, card):
        log(json.dumps(line))
    log("serve: every request ok, every kernel call of the phase equal to "
        "its plain version")

    # -- the kernel tuner at both widths, each counted on its own ----------
    from repro_torch.kernels import autotune as at
    for freq_dtype in (torch.int32, torch.int64):
        errs_tune = {name: [] for name in kernels}
        for line in tune_lines(torch, tsvc, at, kernels, plain, errs_tune,
                               db, schema, oracle, card, freq_dtype, dev):
            log(json.dumps(line))
    log("tune: no gate reject, every tuned answer equal to the oracle and "
        "every kernel call of the phase equal to its plain version")

    # -- the mesh ring sweep over NCCL at world size 1, counted on its own --
    t0 = time.perf_counter()
    errs_mesh = {name: [] for name in kernels}
    with nccl_world(torch):
        lines, mesh_launches, ring_calls = mesh_lines(
            torch, kernels, plain, errs_mesh, db, schema, plans, oracle,
            card, dev)
        for line in lines:
            log(json.dumps(line))
        for line in mesh_step_lines(torch, kern, plain, errs_mesh,
                                    ring_calls, card):
            log(json.dumps(line))
        del ring_calls
        log(f"mesh: V.1 through DistributedExecutor over NCCL at world size "
            f"1 equal to the local Executor and the oracle, launches "
            f"{mesh_launches}, every K1/K2 call equal to its plain version, "
            f"the ring steps over 2, 4 and 8 child blocks equal to one call, "
            f"in {time.perf_counter() - t0:.1f} s")
        # -- mesh serving on the same group, counted on its own ------------
        t0 = time.perf_counter()
        errs_serve_mesh = {name: [] for name in kernels}
        for line in serve_mesh_lines(torch, tsvc, kernels, plain,
                                     errs_serve_mesh, db, schema, host,
                                     oracle, dev, card):
            log(json.dumps(line))
            if "kernels_serve_mesh" in line:
                serve_mesh_launches = {r["name"]: r["launches"]
                                       for r in line["kernels_serve_mesh"]}
        log(f"serve_mesh: QueryService(mesh=...) over NCCL at world size 1 "
            f"in modes {', '.join(SERVE_MESH_MODES)} equal to the local "
            f"service and V.1 to the oracle, launches {serve_mesh_launches}, "
            f"every kernel call equal to its plain version, in "
            f"{time.perf_counter() - t0:.1f} s")

    # -- the LM serving path, each phase counted on its own ---------------
    t0 = time.perf_counter()
    for _, _, k in kernels.values():
        k.reset_counts()
    for line in lm_serve_lines(torch, card, dev):
        log(json.dumps(line))
    dense = {name: k.launches for name, (_, _, k) in kernels.items()}
    lm_lines, moe_serve, lm_accounting = lm_moe_lines(torch, ss, kernels,
                                                      card, dev)
    for line in lm_lines:
        log(json.dumps(line))
    check(lm_accounting > 0,
          "the LM load accounting launched segment_sum no time")
    lm_serve_k3 = dense["segment_sum"] + moe_serve
    log(f"lm: smollm-135m served at full width, its float32 checks held; "
        f"the served waves launched no kernel of the port by design (dense "
        f"{dense}, the MoE wave's segment_sum {moe_serve}); load_stats over "
        f"the MoE wave's recorded routing launched segment_sum "
        f"{lm_accounting} times, each equal to bincount and the plain "
        f"version, in {time.perf_counter() - t0:.1f} s")

    # -- the recurrent families at full width, counted on their own --------
    t0 = time.perf_counter()
    for _, _, k in kernels.values():
        k.reset_counts()
    for arch in LM_MIXERS:
        for line in lm_serve_lines(torch, card, dev, arch):
            log(json.dumps(line))
    mixers = {name: k.launches for name, (_, _, k) in kernels.items()}
    check(not any(mixers.values()),
          f"the recurrent LM phase launched a kernel of the port: {mixers}")
    log(f"lm_mixers: {', '.join(LM_MIXERS)} served at full width, their "
        f"float32 checks and chunked-against-recurrent states held; no "
        f"kernel of the port launched ({mixers}), in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- the LM training path at full width, counted on its own -------------
    t0 = time.perf_counter()
    for _, _, k in kernels.values():
        k.reset_counts()
    for line in lm_train_lines(torch, card, dev):
        log(json.dumps(line))
    train = {name: k.launches for name, (_, _, k) in kernels.items()}
    check(not any(train.values()),
          f"the LM training phase launched a kernel of the port: {train}")
    log(f"lm_train: {LM_TRAIN['arch']} trained at full width, its losses "
        f"finite and falling, its float32 step equal to the CPU's within "
        f"the stated bounds; {', '.join(LM_TRAIN_FAMILIES)} trained at full "
        f"width and cut depth; no kernel of the port launched ({train}), "
        f"in {time.perf_counter() - t0:.1f} s")

    # -- resumable LM training: the checkpointer and the launcher ----------
    t0 = time.perf_counter()
    for _, _, k in kernels.values():
        k.reset_counts()
    for line in lm_ckpt_lines(torch, card, dev):
        log(json.dumps(line))
    ckpt = {name: k.launches for name, (_, _, k) in kernels.items()}
    check(not any(ckpt.values()),
          f"the LM checkpoint phase launched a kernel of the port: {ckpt}")
    log(f"lm_ckpt: smollm-135m saved and restored bitwise at full width; "
        f"python -m repro_torch.launch.train killed after step "
        f"{LM_CKPT_KILL_AT} resumed to the uninterrupted run's final "
        f"checkpoint; no kernel of the port launched ({ckpt}), in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- distributed LM training: the mesh step, the launcher on a mesh ----
    t0 = time.perf_counter()
    for _, _, k in kernels.values():
        k.reset_counts()
    with nccl_world(torch):
        dist_line = lm_dist_step_line(torch, card, dev)
        log(json.dumps(dist_line))
        log(json.dumps(lm_dist_gather_line(torch, card, dev)))
        log(json.dumps(lm_dist_moe_line(torch, card, dev)))
        log(json.dumps(lm_dist_serve_line(torch, card, dev)))
    log(json.dumps(lm_dist_launcher_line(card)))
    for line in lm_dist_multi_line(torch, card):
        log(json.dumps(line))
    dist_k = {name: k.launches for name, (_, _, k) in kernels.items()}
    check(not any(dist_k.values()),
          f"the distributed LM phase launched a kernel of the port: {dist_k}")
    log(f"lm_dist: {LM_DIST['arch']}'s mesh step (dense), "
        f"{LM_DIST_MOE['arch']}'s (placed, and on the gather path) and "
        f"{LM_DIST_GATHER['arch']}'s (the gather path) on a one-rank NCCL "
        f"(1, 1) mesh bitwise the one-device step; smollm-135m served on "
        f"placed weights and caches bitwise the one-device run; the "
        f"launcher under "
        f"COORDINATOR_ADDRESS killed after step {LM_CKPT_KILL_AT} resumed "
        f"bitwise; no kernel of the port launched ({dist_k}), in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- MoE serving on placed weights, counted on its own -----------------
    t0 = time.perf_counter()
    for _, _, k in kernels.values():
        k.reset_counts()
    with nccl_world(torch):
        log(json.dumps(lm_dist_moe_serve_line(torch, card, dev)))
    moe_serve_k = {name: k.launches for name, (_, _, k) in kernels.items()}
    check(not any(moe_serve_k.values()),
          f"the MoE serving phase launched a kernel of the port: "
          f"{moe_serve_k}")
    log(f"lm_dist_moe_serve: {LM_DIST_MOE['arch']} at {LM_MOE['n_layers']} "
        f"layers served on placed bfloat16 weights and caches on a "
        f"one-rank NCCL (1, 1) mesh bitwise the one-device run; no kernel "
        f"of the port launched ({moe_serve_k}), in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- the dry run: fake ranks, held against the real one-rank step -----
    t0 = time.perf_counter()
    for _, _, k in kernels.values():
        k.reset_counts()
    for line in lm_dryrun_lines(torch, card, dist_line):
        log(json.dumps(line))
    dryrun_k = {name: k.launches for name, (_, _, k) in kernels.items()}
    check(not any(dryrun_k.values()),
          f"the dry-run phase launched a kernel of the port: {dryrun_k}")
    log(f"lm_dryrun: python -m repro_torch.launch.dryrun "
        f"{' '.join(LM_DRYRUN_CLI)} exited 0; {LM_DIST['arch']}'s mesh "
        f"step traced on a one-rank fake mesh equal to the card's in placed "
        f"bytes, FLOPs and collectives, nothing allocated on the card; no "
        f"kernel of the port launched ({dryrun_k}), in "
        f"{time.perf_counter() - t0:.1f} s")

    rows = []
    for name in kernels:
        source, replaces = KERNEL_META[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": max(errs[name]),
                     "ms": timing[name]["ms"],
                     "device_ms": timing[name]["device_ms"],
                     "plain_ms": timing[name]["plain_ms"],
                     "bound_ms": bound_ms(timing[name]["bytes"]),
                     "bound_by": "bytes",
                     "library_ms": timing[name]["library_ms"],
                     "calls_timed": calls_timed[name],
                     "mesh_launches": mesh_launches[name],
                     "serve_mesh_launches": serve_mesh_launches[name],
                     "lm_mixers_launches": mixers[name],
                     "lm_train_launches": train[name],
                     "lm_ckpt_launches": ckpt[name],
                     "lm_dist_launches": dist_k[name],
                     "lm_dist_moe_serve_launches": moe_serve_k[name],
                     "lm_dryrun_launches": dryrun_k[name]})
        if name == "segment_sum":
            rows[-1].update(lm_serve_launches=lm_serve_k3,
                            lm_load_stats_launches=lm_accounting)
    rows64 = []
    for name in kernels:
        source, replaces = KERNEL_META[name]
        rows64.append({"name": name, "route": "cuda", "source": source,
                       "replaces": replaces, "freq_dtype": "int64",
                       "launches": launches64[name],
                       "max_abs_err": max(errs64[name]),
                       "ms": timing64[name]["ms"],
                       "device_ms": timing64[name]["device_ms"],
                       "plain_ms": timing64[name]["plain_ms"],
                       "bound_ms": bound_ms(timing64[name]["bytes"]),
                       "bound_by": "bytes",
                       "library_ms": timing64[name]["library_ms"],
                       "calls_timed": calls64[name]})
    log(json.dumps({"kernels_x64": rows64, **card}))
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
