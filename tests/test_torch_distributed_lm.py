"""Distributed LM training: the port's mesh train step, placed states and
elastic restore against the JAX package's
``tests/helpers/distributed_lm_check.py``, at its config and bounds.

The helper's run: ``qwen3-14b``'s smoke config in float32,
``TokenPipeline(seq_len=16, global_batch=8, seed=42)``, 2 microbatches,
``base_lr=5e-3``, ``warmup=2``, ``remat="none"``, 4 steps on a (2,2,2)
pod × data × model mesh against one device (loss ``rtol=1e-4``, params
``rtol=2e-3, atol=2e-4``), then the step-4 checkpoint restored onto (4,2)
and onto one device, 2 more steps each (loss ``rtol=1e-4``).

Three runs, started together: the JAX side in a subprocess of this file
over 8 host devices (``--xla_force_host_platform_device_count=8``), the
port as one ``torch.multiprocessing`` spawn of 8 ``gloo`` ranks
(``FileStore`` rendezvous, one thread a rank), and the port on one device
in the test process.  All start from the JAX package's initial state,
written by its checkpointer.  Held:

  * each rank's local block of every leaf of the state placed on (2,2,2)
    and on (4,2), and on (2,2,2) under an ``axis_rules`` override that
    splits a dim over ("data", "pod") (out of mesh order), equals the JAX
    array's shard at the same mesh coordinate (``devices_indices_map``),
    bitwise, and each DTensor gathers back to the whole array;
  * the port's (2,2,2) run against the port's one-device run and against
    the JAX package's (2,2,2) run;
  * a run on the (8,1) host mesh, whose microbatches' 4 rows do not
    divide by its 8 batch shards, against the one-device run;
  * elastic restore of the port's step-4 checkpoint onto (4,2) and onto
    one device, 2 steps each;
  * across the packages: the JAX-written step-4 checkpoint continued on
    the port's (4,2) against the JAX package's (4,2) continuation, and the
    port-written one on the JAX package's (4,2) against the port's;
  * every rank's copy of a replicated block bitwise equal to every other's;
  * ``CompressedPsum`` over groups of 2 and 4 ranks against a numpy
    oracle;
  * MoE on more than one batch shard, on the gather path (``TP_FAMILIES``
    emptied in the ranks): mixtral-smoke and moonshot-smoke on (2,2,2)
    (4 batch shards of one 16-token row; tokens drop, so which ones
    depends on the order across the ranks), 2 steps against the
    one-device run and the JAX package's (2,2,2) run at the helper's
    bounds, ``dropped_frac`` equal in all three; mixtral-smoke on (2,4)
    under ``remat="full"`` against one device;
  * MoE through the placed step (experts on their blocks of the expert
    dim): both smoke configs on (2,2,2) against the one-device run and
    the JAX package's (2,2,2) run at the same bounds, ``dropped_frac``
    bitwise in all three, every layer's routing bitwise equal on the two
    "model" ranks of a row block; mixtral-smoke on (2,4,1), whose 4
    experts do not divide by its 8 batch shards (the weights' d and the
    buffer's capacity take "data"), on 16-row batches against one
    device; one step of each counted through the placed step and the
    gather path (FLOPs, the largest collective);
  * C1, the int8 round trip (``compress_grads=True``): along the
    one-device run, each step also taken on (2,2,2) from the same state,
    in both packages; the first moments at most one quantum an entry
    apart;
  * a placed gradient's int8 round trip and norm those of the whole;
  * the dense mesh step computes on the placed weights: qwen3-smoke's
    (2,2,2) run above goes through it (its 2 KV heads take "model"), and
    so does a gemma3-smoke run (one KV head: the query positions take
    "model"), 2 steps held against gemma3's one-device run and the JAX
    package's (2,2,2) run at the same bounds; one qwen3 step on (2,2,2) counts at
    most ``FLOPS_RATIO`` of the FLOPs a rank of the same step through the
    gather path (``TP_FAMILIES`` emptied), and none of its collectives
    outputs more than the largest weight's block over "model"; a step on
    15-token rows, which "model" does not divide (the projections'
    annotation cuts the fused heads, the logits' the vocabulary), against
    one device.

And in the test process, on a one-rank ``gloo`` group: every dense and
MoE smoke config's mesh step (the placed step of both families) on the
(1,1) mesh bitwise equal to its one-device step.

Then ``launch/train.py`` at 2 ranks under ``COORDINATOR_ADDRESS=file://``
checkpoints at step 3, resumes at world size 1 and ends within the
helper's bounds of the one-device launcher.

Observed gaps (on a CPU, torch 2.13): the (2,2,2) run's step-4
loss within 9.3e-8 relative of the one-device run's and of the JAX
(2,2,2) run's, its parameters within 2.3e-7 and 4.7e-7; the (4,2)
continuations' losses equal to the one-device and the other package's
(relative gap 0.0), their parameters within 1.7e-7.  Through the dense
step (on placed weights): qwen3's (2,2,2) loss equal to the one-device
run's, its parameters within 3.5e-6 of it; gemma3's loss within 7.9e-8,
parameters within 2.3e-5 (the step's sums run in other orders).  The mesh step sums
in another order than one device (each rank's rows, then ``all_reduce``),
so it is not bitwise; at one rank it is (``tests/test_torch_gpu.py``,
``chip_smoke.py``).  On the (8, 1) host mesh a microbatch's 4 rows do not
divide by 8 batch shards, so each rank computes them all: its four steps
are bitwise the one-device run's.  MoE on (2,2,2): losses equal to the
one-device run's and the JAX run's (relative gap 0.0), parameters within
3.0e-8 of the one-device run's and 8.9e-5 (mixtral) / 2.8e-6 (moonshot)
of the JAX run's; ``dropped_frac`` 0.203125 and 0.3515625 in all three
runs; on (2,4) under remat the loss within 1.6e-7.  C1: each package
moved one entry by one quantum at 2 of the 4 steps (JAX 0.99999 /
1.00000 quanta, the port 0.99999 / 1.00000); at the other steps every
entry within 3.9e-4 of a quantum.  The launcher (bfloat16 compute) ended
14 of its 70,896 parameter entries, all among the embedding's 12,288,
beyond the helper's parameter bound, by up to 6.5e-4: AdamW's sign on
round-off gradients (the launcher test's docstring); ``LAUNCH_FAR``
allows 32.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_distributed_lm.py``.
"""

import dataclasses
import datetime
import json
import logging
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
HELPERS = REPO / "tests" / "helpers"
TIMEOUT_S = 300
WORLD = 8
STEPS, MORE = 4, 2
MESHES = {"2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}
# a dim split over ("data", "pod"): the spec lists its axes out of mesh order
OVERRIDE = {"embed": ("data", "pod")}
LOSS_RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-4
# the MoE smoke configs of the spawn, their steps on (2,2,2), and the mesh
# of 2 batch shards that mixtral-smoke also runs on under remat="full"
MOE_ARCHS = ("mixtral-8x22b", "moonshot-v1-16b-a3b")
MOE_STEPS = 2
MOE_REMAT_MESH = ((2, 4), ("data", "model"))
# the placed step where the experts do not divide by their axes:
# mixtral-smoke's 4 experts on (pod, data) = (2, 4) take "pod", and
# "data" cuts the expert weights' d and the buffer's capacity; 16-row
# batches, so that each microbatch's 8 rows divide by the batch shards
MOE_UNEVEN_MESH = ((2, 4, 1), ("pod", "data", "model"))
MOE_UNEVEN_ROWS = 16
# the placed MoE runs' parameter entries allowed beyond the helper's bound
# of the one-device run: AdamW's step on a round-off gradient (1 observed;
# see test_the_placed_moe_step_matches_both_runs)
MOE_FAR = 2
# AdamW's first-moment decay: one step from a zero-free state moves the
# first moment by (1 - B1) times the clipped round-tripped gradient
B1 = 0.9
# a quantum is max|g|/127 of a leaf; the scales of the two runs differ by
# the round-off of max|g|
QUANTUM_SLACK = 1e-3
# the launcher's parameter entries (of 70,896) allowed beyond the helper's
# bound: AdamW's sign on round-off gradients in bfloat16 (14 observed)
LAUNCH_FAR = 32
PSUM_GROUPS = {2: [[0, 1], [2, 3], [4, 5], [6, 7]],
               4: [[0, 1, 2, 3], [4, 5, 6, 7]]}
# the dense step's FLOPs a rank over the gather path's on (2,2,2): its
# "model" axis of 2 halves them
FLOPS_RATIO = 0.6
# the second dense arch of the spawn (one KV head) and the rows that
# "model" does not divide
KV1_ARCH = "gemma3-1b"
KV1_STEPS = 2
ODD_SEQ = 15
DENSE_ARCHS = ("qwen3-14b", "gemma3-1b", "smollm-135m", "h2o-danube-3-4b",
               "pixtral-12b", "musicgen-large")


def _wait_for(path: Path, deadline: float) -> None:
    """Polls for ``path`` (a checkpoint the other side writes, renamed into
    place once whole)."""
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.1)


# ---------------------------------------------------------------------------
# the JAX side (run as ``python tests/test_torch_distributed_lm.py jax TMP``)
# ---------------------------------------------------------------------------
def _jax_side(tmp: Path) -> None:
    import jax
    sys.path.insert(0, str(HELPERS))
    from distributed_lm_check import make_mesh, run_steps, state_shardings

    from repro.checkpoint import Checkpointer
    from repro.checkpoint.checkpointer import _flatten
    from repro.configs import get_smoke_config
    from repro.data import TokenPipeline
    from repro.distributed.sharding import LOGICAL_RULES
    from repro.launch.inputs import abstract_params, to_named_shardings
    from repro.training import init_train_state
    from repro.training.optimizer import AdamWState
    from repro.training.step import TrainState

    deadline = time.monotonic() + TIMEOUT_S
    assert jax.device_count() == WORLD
    cfg = dataclasses.replace(get_smoke_config("qwen3-14b"), dtype="float32")
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=16,
                         global_batch=8, seed=42)
    like = init_train_state(abstract_params(cfg)[0])
    state0 = Checkpointer(tmp / "init").restore(like=like)
    out: dict = {}

    def keep(tag, state, metrics):
        out[f"{tag}|loss"] = np.asarray(metrics["loss"])
        for k, v in _flatten(state.params)[0].items():
            out[f"{tag}|param|0/{k}"] = np.asarray(v)

    meshes = {n: make_mesh(*MESHES[n]) for n in MESHES}
    for arch in MOE_ARCHS:
        moe = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        moe_state = Checkpointer(tmp / f"init_{arch}").restore(
            like=init_train_state(abstract_params(moe)[0]))
        s, m = run_steps(moe, meshes["2x2x2"], moe_state, TokenPipeline(
            vocab_size=moe.vocab_size, seq_len=16, global_batch=8, seed=42),
            MOE_STEPS)
        keep(f"jax222|{arch}", s, m)
        out[f"jax222|{arch}|dropped_frac"] = np.asarray(m["dropped_frac"])
    _jax_quanta(cfg, meshes["2x2x2"], state0, pipe, out)
    kv1 = dataclasses.replace(get_smoke_config(KV1_ARCH), dtype="float32")
    kv1_state = Checkpointer(tmp / "init_kv1").restore(
        like=init_train_state(abstract_params(kv1)[0]))
    kv1_pipe = TokenPipeline(vocab_size=kv1.vocab_size, seq_len=16,
                             global_batch=8, seed=42)
    keep("jax222|kv1", *run_steps(kv1, meshes["2x2x2"], kv1_state, kv1_pipe,
                                  KV1_STEPS))
    s, m = run_steps(cfg, meshes["2x2x2"], state0, pipe, STEPS)
    keep("jax222", s, m)
    Checkpointer(tmp / "jax_ckpt").save(STEPS, s, async_=False)

    # each leaf's index at each mesh coordinate
    pshapes, pspecs = abstract_params(cfg)
    shapes = jax.eval_shape(init_train_state, pshapes)
    specs = TrainState(params=pspecs,
                       opt=AdamWState(step=(), m=pspecs, v=pspecs), step=())
    for tag, mesh, rules in (
            ("2x2x2", meshes["2x2x2"], None), ("4x2", meshes["4x2"], None),
            ("2x2x2-override", meshes["2x2x2"],
             {**LOGICAL_RULES, **OVERRIDE})):
        coord = {d.id: c for c, d in np.ndenumerate(mesh.devices)}
        flat_sh = _flatten(to_named_shardings(mesh, specs, shapes, rules))[0]
        flat_shape = _flatten(shapes)[0]
        for k, sh in flat_sh.items():
            shape = flat_shape[k].shape
            idx = np.zeros(mesh.devices.shape + (len(shape), 2), np.int64)
            for d, index in sh.devices_indices_map(shape).items():
                idx[coord[d.id]] = np.reshape(
                    [[sl.start or 0, n if sl.stop is None else sl.stop]
                     for sl, n in zip(index, shape)], (len(shape), 2))
            out[f"idx|{tag}|{k}"] = idx

    # elastic: each step-4 checkpoint continued on (4,2)
    sh42 = state_shardings(cfg, meshes["4x2"])
    for tag, src in (("J4", tmp / "jax_ckpt"), ("P4", tmp / "port_ckpt")):
        _wait_for(src / f"step_{STEPS}", deadline)
        r = Checkpointer(src).restore(like=jax.eval_shape(lambda: s),
                                      shardings=sh42)
        s2, m2 = run_steps(cfg, meshes["4x2"], r, pipe, MORE, start=STEPS)
        keep(f"jax42|{tag}", s2, m2)
    np.savez(tmp / "jax.npz", **out)


def _jax_quanta(cfg, mesh, state, pipe, out: dict) -> None:
    """C1 on the JAX package: along its one-device run with the int8 round
    trip (``compress_grads=True``), each step taken also on ``mesh`` from
    the same state; ``_quanta`` of the two first moments into ``out``."""
    import jax
    from distributed_lm_check import state_shardings

    from repro.distributed.sharding import use_mesh
    from repro.training import build_train_step
    step_fn = build_train_step(cfg, microbatches=2, base_lr=5e-3, warmup=2,
                               total_steps=50, remat="none",
                               compress_grads=True)
    sh = state_shardings(cfg, mesh)

    def on_mesh(s, b):
        with use_mesh(mesh):
            return step_fn(s, b)

    one = jax.jit(step_fn)
    placed = jax.jit(on_mesh, in_shardings=(sh, None),
                     out_shardings=(sh, None))
    for i in range(STEPS):
        batch = pipe.jax_batch(i)
        got, _ = placed(jax.device_put(state, sh), batch)
        new, _ = one(state, batch)
        out[f"quanta|jax|{i}"] = np.asarray(_quanta(
            [np.asarray(x) for x in jax.tree.leaves(state.opt.m)],
            [np.asarray(x) for x in jax.tree.leaves(new.opt.m)],
            [np.asarray(x) for x in jax.tree.leaves(got.opt.m)]))
        state = new


def _quanta(prev: list, one: list, mesh: list) -> tuple[float, int]:
    """From one step's first moments, leaf by leaf (``prev`` before it,
    ``one`` after it on one device, ``mesh`` after it on the mesh): the
    largest gap between the two runs' round-tripped gradients in quanta of
    the leaf (its largest |clipped gradient| over 127), and the entries
    whose gap is over half a quantum (a rounding that went the other
    way)."""
    worst, moved = 0.0, 0
    for p, a, b in zip(prev, one, mesh):
        # (1 - B1) times the clipped round-tripped gradient
        step = np.abs(a.astype(np.float64) - B1 * p.astype(np.float64))
        unit = step.max() / 127
        if unit == 0:
            assert np.array_equal(a, b)
            continue
        gap = np.abs(a.astype(np.float64) - b.astype(np.float64)) / unit
        worst = max(worst, float(gap.max()))
        moved += int((gap > 0.5).sum())
    return worst, moved


# ---------------------------------------------------------------------------
# the port side: one spawn of 8 ranks
# ---------------------------------------------------------------------------
def _port_config(arch: str = "qwen3-14b"):
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def _port_step(cfg, remat: str = "none", compress: bool = False):
    from repro_torch.training import build_train_step
    return build_train_step(cfg, microbatches=2, base_lr=5e-3, warmup=2,
                            total_steps=50, remat=remat,
                            compress_grads=compress)


def _pipe(cfg, seq_len: int = 16, global_batch: int = 8):
    from repro_torch.data import TokenPipeline
    return TokenPipeline(vocab_size=cfg.vocab_size, seq_len=seq_len,
                         global_batch=global_batch, seed=42)


def _port_worker(rank: int, tmp: str) -> None:
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch import training as tt
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint.checkpointer import _flatten
    from repro_torch.distributed import CompressedPsum
    from repro_torch.distributed.sharding import LOGICAL_RULES, use_mesh
    from repro_torch.launch.inputs import state_shardings
    from repro_torch.launch.mesh import make_auto_mesh, make_host_mesh
    from repro_torch.models import LM

    torch.set_num_threads(1)
    # DTensor warns that a dim sharded over two mesh dims gathers in two
    # steps; a gather adds nothing, so the bits are the same
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    tmp = Path(tmp)
    deadline = time.monotonic() + TIMEOUT_S
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / "store"), WORLD), rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    cfg = _port_config()
    pipe, step = _pipe(cfg), _port_step(cfg)
    meshes = {n: make_auto_mesh(*MESHES[n], device_type="cpu")
              for n in MESHES}
    like = tt.init_train_state(LM(cfg, "meta"))
    out: dict = {}

    def blocks(tag, state, mesh, whole=None):
        """This rank's block of every leaf; with ``whole`` (the same state
        on this rank's CPU), whether every leaf gathers back to it."""
        out[f"coord|{tag}"] = np.asarray(mesh.get_coordinate())
        same = True
        full = _flatten(whole) if whole is not None else {}
        for k, leaf in _flatten(state).items():
            rows = leaf if isinstance(leaf, list) else [leaf]
            local = [r.to_local() if isinstance(r, DTensor) else r
                     for r in rows]
            # a copy: the steps update the state in place
            out[f"blk|{tag}|{k}"] = (torch.stack(local) if isinstance(
                leaf, list) else local[0]).detach().numpy().copy()
            if whole is not None:
                got = [r.full_tensor() if isinstance(r, DTensor) else r
                       for r in rows]
                want = full[k] if isinstance(full[k], list) else [full[k]]
                same &= all(torch.equal(a.detach(), b.detach())
                            for a, b in zip(got, want))
        if whole is not None:
            out[f"whole|{tag}"] = np.asarray(same)

    def keep(tag, state, metrics):
        out[f"{tag}|loss"] = np.asarray(float(metrics["loss"]))
        for k, leaf in _flatten(state).items():
            if k.startswith("0/"):
                rows = leaf if isinstance(leaf, list) else [leaf]
                full = [r.full_tensor().detach() for r in rows]
                out[f"{tag}|param|{k}"] = (torch.stack(full) if isinstance(
                    leaf, list) else full[0]).numpy()

    def run(state, mesh, start, n):
        for i in range(start, start + n):
            with use_mesh(mesh):
                state, metrics = step(state, pipe.torch_batch(i, "cpu"))
        return state, metrics

    init = Checkpointer(tmp / "init")
    # gemma3-smoke through the dense step on (2,2,2)
    kv1 = _port_config(KV1_ARCH)
    kv1_like = tt.init_train_state(LM(kv1, "meta"))
    s = Checkpointer(tmp / "init_kv1").restore(
        like=kv1_like, shardings=state_shardings(kv1, meshes["2x2x2"]))
    kv1_pipe, kv1_step = _pipe(kv1), _port_step(kv1)
    for i in range(KV1_STEPS):
        with use_mesh(meshes["2x2x2"]):
            s, m = kv1_step(s, kv1_pipe.torch_batch(i, "cpu"))
    keep("port222|kv1", s, m)

    # one qwen3 step counted, through the dense step and the gather path
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun as dr
    from repro_torch.training import step as tstep
    paths = tstep.TP_FAMILIES
    for tag, families in (("tp", paths), ("dp", ())):
        tstep.TP_FAMILIES = families
        s = init.restore(like=like,
                         shardings=state_shardings(cfg, meshes["2x2x2"]))
        with FlopCounterMode(display=False) as flops, \
                dr.CollectiveMode() as comm, use_mesh(meshes["2x2x2"]):
            step(s, pipe.torch_batch(0, "cpu"))
        out[f"flops|{tag}"] = np.asarray(flops.get_total_flops())
        out[f"largest_collective|{tag}"] = np.asarray(
            max(n for _, n in comm.records))
    tstep.TP_FAMILIES = paths

    # 15-token rows: "model" cuts the fused heads and the vocabulary
    s = init.restore(like=like,
                     shardings=state_shardings(cfg, meshes["2x2x2"]))
    with use_mesh(meshes["2x2x2"]):
        s, m = step(s, _pipe(cfg, ODD_SEQ).torch_batch(0, "cpu"))
    keep("port222|odd", s, m)

    whole0 = init.restore(like=like, shardings=torch.device("cpu"))
    s = init.restore(like=like, shardings=state_shardings(
        cfg, meshes["2x2x2"], {**LOGICAL_RULES, **OVERRIDE}))
    blocks("2x2x2-override", s, meshes["2x2x2"], whole0)
    s = init.restore(like=like,
                     shardings=state_shardings(cfg, meshes["2x2x2"]))
    blocks("2x2x2", s, meshes["2x2x2"], whole0)
    s, m = run(s, meshes["2x2x2"], 0, STEPS)
    keep("port222", s, m)
    blocks("2x2x2-final", s, meshes["2x2x2"])
    Checkpointer(tmp / "port_ckpt").save(STEPS, s, async_=False)

    sh42 = state_shardings(cfg, meshes["4x2"])
    for tag, src in (("P4", tmp / "port_ckpt"), ("J4", tmp / "jax_ckpt")):
        _wait_for(src / f"step_{STEPS}", deadline)
        ck = Checkpointer(src)
        s = ck.restore(like=like, shardings=sh42)
        if tag == "P4":
            blocks("4x2", s, meshes["4x2"], ck.restore(
                like=like, shardings=torch.device("cpu")))
        s, m = run(s, meshes["4x2"], STEPS, MORE)
        keep(f"port42|{tag}", s, m)
        if tag == "P4":
            blocks("4x2-final", s, meshes["4x2"])

    # the (8, 1) host mesh: a microbatch's 4 rows do not divide by its 8
    # batch shards, so every rank computes all of them
    host = make_host_mesh(device_type="cpu")
    s = init.restore(like=like, shardings=state_shardings(cfg, host))
    s, m = run(s, host, 0, STEPS)
    keep("port81", s, m)

    # the whole gradient's int8 round trip and norm from the blocks
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed import ef_int8_roundtrip
    from repro_torch.distributed.sharding import placements
    from repro_torch.training.optimizer import global_norm
    gen = torch.Generator().manual_seed(5)
    whole = {"a": torch.randn(16, 8, generator=gen),
             "b": torch.randn(12, generator=gen) * 3}
    cut = {"a": (("pod", "data"), "model"), "b": (None,)}
    placed = {n: distribute_tensor(t, meshes["2x2x2"], placements(
        cut[n], meshes["2x2x2"])) for n, t in whole.items()}
    out["int8|same"] = np.asarray(all(torch.equal(
        ef_int8_roundtrip(placed[n]).full_tensor(), ef_int8_roundtrip(t))
        for n, t in whole.items()))
    out["norm|placed"] = global_norm(placed).numpy()
    out["norm|whole"] = global_norm(whole).numpy()

    # CompressedPsum over groups of 2 and 4 ranks, two rounds each
    for size, enum in PSUM_GROUPS.items():
        group, _ = dist.new_subgroups_by_enumeration(enum)
        grads = {"w": torch.from_numpy(_psum_grads(rank))}
        res = CompressedPsum.init_state(grads)
        for r in range(2):
            got, res = CompressedPsum.psum(grads, res, group)
            out[f"psum|{size}|{r}|out"] = got["w"].numpy()
            out[f"psum|{size}|{r}|res"] = res["w"].numpy()

    # the MoE smoke configs through the gather path (TP_FAMILIES emptied):
    # on (2,2,2), 4 batch shards of one row each; mixtral-smoke on (2,4),
    # 2 batch shards, under remat="full"
    meshes["2x4"] = make_auto_mesh(*MOE_REMAT_MESH, device_type="cpu")
    tstep.TP_FAMILIES = ()
    for arch, tag, remat in [(a, "2x2x2", "none") for a in MOE_ARCHS] + [
            (MOE_ARCHS[0], "2x4", "full")]:
        moe = _port_config(arch)
        s = Checkpointer(tmp / f"init_{arch}").restore(
            like=tt.init_train_state(LM(moe, "meta")),
            shardings=state_shardings(moe, meshes[tag]))
        moe_pipe = _pipe(moe)
        moe_step = _port_step(moe, remat)
        for i in range(MOE_STEPS):
            with use_mesh(meshes[tag]):
                s, m = moe_step(s, moe_pipe.torch_batch(i, "cpu"))
        keep(f"port{tag.replace('x', '')}|{arch}", s, m)
        out[f"port{tag.replace('x', '')}|{arch}|dropped_frac"] = \
            m["dropped_frac"].numpy()
    tstep.TP_FAMILIES = paths

    # the MoE smoke configs through the placed step on (2,2,2), each
    # layer's routing recorded; mixtral-smoke on (2,4,1), whose 4 experts
    # do not divide by its 8 batch shards, on 8-row microbatches
    from repro_torch.distributed.sharding import resolve_spec
    from repro_torch.models import moe as tmoe
    routed = []
    route = tmoe._route

    def recorded(*args):
        got = route(*args)
        routed.append(got[3].detach().clone())
        return got

    tmoe._route = recorded
    meshes["2x4x1"] = make_auto_mesh(*MOE_UNEVEN_MESH, device_type="cpu")
    for arch, tag, rows in [(a, "2x2x2", 8) for a in MOE_ARCHS] + [
            (MOE_ARCHS[0], "2x4x1", MOE_UNEVEN_ROWS)]:
        moe = _port_config(arch)
        s = Checkpointer(tmp / f"init_{arch}").restore(
            like=tt.init_train_state(LM(moe, "meta")),
            shardings=state_shardings(moe, meshes[tag]))
        moe_pipe = _pipe(moe, global_batch=rows)
        moe_step = _port_step(moe)
        routed.clear()
        for i in range(MOE_STEPS):
            with use_mesh(meshes[tag]):
                s, m = moe_step(s, moe_pipe.torch_batch(i, "cpu"))
        name = f"ep{tag.replace('x', '')}|{arch}"
        keep(name, s, m)
        out[f"{name}|dropped_frac"] = m["dropped_frac"].numpy()
        out[f"{name}|coord"] = np.asarray(meshes[tag].get_coordinate())
        out[f"{name}|routed"] = torch.stack(routed).numpy()
        cap = tmoe._capacity(moe, 16 * rows // 2)
        with use_mesh(meshes[tag]):
            out[f"{name}|specs"] = np.asarray([
                str(s.shardings["layers.0.mlp.wi"].spec),
                str(resolve_spec((moe.n_experts, cap, moe.d_model),
                                 ("experts", None, "act_embed")))])
    tmoe._route = route

    # one MoE step counted, through the placed step and the gather path
    for arch in MOE_ARCHS:
        moe = _port_config(arch)
        for tag, families in (("ep", paths), ("dp", ())):
            tstep.TP_FAMILIES = families
            s = Checkpointer(tmp / f"init_{arch}").restore(
                like=tt.init_train_state(LM(moe, "meta")),
                shardings=state_shardings(moe, meshes["2x2x2"]))
            with FlopCounterMode(display=False) as flops, \
                    dr.CollectiveMode() as comm, use_mesh(meshes["2x2x2"]):
                _port_step(moe)(s, _pipe(moe).torch_batch(0, "cpu"))
            out[f"flops|{tag}|{arch}"] = np.asarray(flops.get_total_flops())
            out[f"largest_collective|{tag}|{arch}"] = np.asarray(
                max(n for _, n in comm.records))
        tstep.TP_FAMILIES = paths

    # C1: along the one-device run with the int8 round trip, each step
    # also taken on (2,2,2) from the same state
    cstep = _port_step(cfg, compress=True)
    whole = init.restore(like=like, shardings=torch.device("cpu"))
    for i in range(STEPS):
        batch = pipe.torch_batch(i, "cpu")
        prev = [t.clone() for t in whole.opt.m.values()]
        placed = tt.place_train_state(whole, state_shardings(
            cfg, meshes["2x2x2"]))
        with use_mesh(meshes["2x2x2"]):
            placed, _ = cstep(placed, batch)
        whole, _ = cstep(whole, batch)
        out[f"quanta|port|{i}"] = np.asarray(_quanta(
            [t.numpy() for t in prev],
            [t.numpy() for t in whole.opt.m.values()],
            [t.full_tensor().numpy() for t in placed.opt.m.values()]))
    np.savez(tmp / f"port_{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


def _psum_grads(rank: int) -> np.ndarray:
    return np.random.default_rng(100 + rank).normal(size=(64,)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------
def _load(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _read_ckpt(d: Path) -> dict:
    leaves = json.loads((d / "manifest.json").read_text())["leaves"]
    return {k: np.load(d / e["file"]) for k, e in leaves.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX side's, each port rank's and the one-device run's
    outputs."""
    import jax
    import torch.multiprocessing as mp

    from repro.checkpoint import Checkpointer as JCheckpointer
    from repro.configs import get_smoke_config as jsmoke
    from repro.models import init_params as jinit_params
    from repro.training import init_train_state as jinit_state
    from repro_torch import training as tt
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint.checkpointer import _flatten
    from repro_torch.models import LM

    tmp = tmp_path_factory.mktemp("dlm")
    for arch, d in (("qwen3-14b", "init"), (KV1_ARCH, "init_kv1"),
                    *((a, f"init_{a}") for a in MOE_ARCHS)):
        jcfg = dataclasses.replace(jsmoke(arch), dtype="float32")
        JCheckpointer(tmp / d).save(0, jinit_state(jinit_params(
            jax.random.PRNGKey(0), jcfg)[0]), async_=False)
    # one thread a device, a rank and a process: the file runs beside the
    # other test files' workers
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8 "
                        "--xla_cpu_multi_thread_eigen=false",
           "PYTHONPATH": os.pathsep.join(
               [str(SRC), os.environ.get("PYTHONPATH", "")])}
    jproc = subprocess.Popen([sys.executable, __file__, "jax", str(tmp)],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + TIMEOUT_S
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ctx = mp.start_processes(_port_worker, args=(str(tmp),),
                                 nprocs=WORLD, join=False,
                                 start_method="spawn")
        # the port on one device, meanwhile
        cfg = _port_config()
        pipe, step = _pipe(cfg), _port_step(cfg)
        like = tt.init_train_state(LM(cfg, "meta"))
        one: dict = {}

        def run(state, start, n, tag, step=step, pipe=pipe):
            for i in range(start, start + n):
                state, metrics = step(state, pipe.torch_batch(i, "cpu"))
            one[f"{tag}|loss"] = np.asarray(float(metrics["loss"]))
            for k, leaf in _flatten(state).items():
                if k.startswith("0/"):
                    one[f"{tag}|param|{k}"] = (torch.stack(leaf) if isinstance(
                        leaf, list) else leaf).detach().numpy()
            return metrics

        cpu = torch.device("cpu")
        run(Checkpointer(tmp / "init").restore(like=like, shardings=cpu), 0,
            STEPS, "one")
        run(Checkpointer(tmp / "init").restore(like=like, shardings=cpu), 0,
            1, "one|odd", pipe=_pipe(cfg, ODD_SEQ))
        kv1 = _port_config(KV1_ARCH)
        run(Checkpointer(tmp / "init_kv1").restore(
            like=tt.init_train_state(LM(kv1, "meta")), shardings=cpu), 0,
            KV1_STEPS, "one|kv1", step=_port_step(kv1), pipe=_pipe(kv1))
        for arch, rows in [(a, 8) for a in MOE_ARCHS] + [
                (MOE_ARCHS[0], MOE_UNEVEN_ROWS)]:
            moe = _port_config(arch)
            tag = f"one|{arch}" + ("" if rows == 8 else f"|{rows}")
            one[f"{tag}|dropped_frac"] = run(
                Checkpointer(tmp / f"init_{arch}").restore(
                    like=tt.init_train_state(LM(moe, "meta")),
                    shardings=cpu), 0, MOE_STEPS, tag,
                step=_port_step(moe),
                pipe=_pipe(moe, global_batch=rows))["dropped_frac"].numpy()
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail("the port's 8-rank spawn timed out")
        run(Checkpointer(tmp / "port_ckpt").restore(like=like, shardings=cpu),
            STEPS, MORE, "one|P4")
        log, _ = jproc.communicate(
            timeout=max(1.0, deadline - time.monotonic()))
        assert jproc.returncode == 0, f"the JAX side failed:\n{log}"
    finally:
        torch.set_num_threads(threads)
        if jproc.poll() is None:
            jproc.kill()
            jproc.wait()
    port = [_load(tmp / f"port_{r}.npz") for r in range(WORLD)]
    files = {"init": _read_ckpt(tmp / "init" / "step_0"),
             "P4": _read_ckpt(tmp / "port_ckpt" / f"step_{STEPS}"),
             "J4": _read_ckpt(tmp / "jax_ckpt" / f"step_{STEPS}")}
    return _load(tmp / "jax.npz"), port, one, files


def _params(d: dict, tag: str) -> dict:
    head = f"{tag}|param|"
    return {k[len(head):]: v for k, v in d.items() if k.startswith(head)}


def _close_params(got: dict, want: dict) -> None:
    assert got and sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


def _close_params_but_flips(got: dict, want: dict, steps: int) -> None:
    """``_close_params``, but for at most ``MOE_FAR`` entries, each within
    the bound plus twice the run's summed learning rate: an entry whose
    gradient is round-off, which AdamW's normalised update (its
    denominator near ``eps`` once the gradient is clipped) turns into a
    step whose size the round-off sets (the launcher test's rule)."""
    from repro_torch.training.optimizer import cosine_schedule
    lr = cosine_schedule(5e-3, 2, 50)
    flips = 2 * sum(float(lr(torch.tensor(t))) for t in range(steps))
    assert got and sorted(got) == sorted(want)
    far = 0
    for k in got:
        gap = np.abs(got[k] - want[k])
        bound = PARAM_ATOL + PARAM_RTOL * np.abs(want[k])
        far += int((gap > bound).sum())
        assert (gap <= bound + flips).all(), (k, gap.max())
    assert far <= MOE_FAR, far


def _index(jax_out: dict, idx_tag: str, key: str, coord) -> tuple:
    return tuple(slice(int(a), int(b))
                 for a, b in jax_out[f"idx|{idx_tag}|{key}"][tuple(coord)])


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tag,source", [("2x2x2", "init"), ("4x2", "P4"),
                                        ("2x2x2-override", "init")])
def test_each_rank_holds_the_jax_shard_at_its_coordinate(runs, tag, source):
    jax_out, port, _, files = runs
    full = files[source]
    n = 0
    for r, out in enumerate(port):
        assert bool(out[f"whole|{tag}"]), (tag, r)
        coord = out[f"coord|{tag}"]
        head = f"blk|{tag}|"
        keys = sorted(k[len(head):] for k in out if k.startswith(head))
        assert keys == sorted(full)
        for key in keys:
            want = full[key][_index(jax_out, tag, key, coord)]
            got = out[head + key]
            assert got.dtype == want.dtype and got.shape == want.shape, key
            assert np.array_equal(got, want), (tag, r, key)
            n += 1
    assert n == WORLD * len(full)


def test_the_override_splits_a_dim_out_of_mesh_order(runs):
    """The override's embedding is split over ("data", "pod"): rank 2 (pod
    0, data 1) holds block 2 of its rows, not block 1."""
    jax_out, _, _, _ = runs
    idx = jax_out["idx|2x2x2-override|0/embed/embedding"]
    # dim 1 (embed) at coordinate (pod 0, data 1, model 0)
    block = idx[0, 1, 0, 1, 0] // (idx[0, 0, 0, 1, 1] - idx[0, 0, 0, 1, 0])
    assert block == 2


def test_the_mesh_run_matches_the_one_device_run(runs):
    _, port, one, _ = runs
    np.testing.assert_allclose(port[0]["port222|loss"], one["one|loss"],
                               rtol=LOSS_RTOL)
    _close_params(_params(port[0], "port222"), _params(one, "one"))


def test_the_mesh_run_matches_the_jax_mesh_run(runs):
    jax_out, port, _, _ = runs
    np.testing.assert_allclose(port[0]["port222|loss"],
                               jax_out["jax222|loss"], rtol=LOSS_RTOL)
    _close_params(_params(port[0], "port222"), _params(jax_out, "jax222"))


def test_the_dense_step_with_one_kv_head_matches_both_runs(runs):
    """gemma3-smoke on (2,2,2): its one KV head cannot take "model", so
    the scores' annotation cuts the query positions."""
    jax_out, port, one, _ = runs
    for want in (one["one|kv1|loss"], jax_out["jax222|kv1|loss"]):
        np.testing.assert_allclose(port[0]["port222|kv1|loss"], want,
                                   rtol=LOSS_RTOL)
    _close_params(_params(port[0], "port222|kv1"), _params(one, "one|kv1"))
    _close_params(_params(port[0], "port222|kv1"),
                  _params(jax_out, "jax222|kv1"))


def test_the_dense_step_divides_the_flops_by_model(runs):
    _, port, _, _ = runs
    for out in port:
        tp, dp = int(out["flops|tp"]), int(out["flops|dp"])
        assert 0 < tp <= FLOPS_RATIO * dp, (tp, dp)


def test_no_collective_outputs_more_than_a_weights_model_block(runs):
    """The dense step gathers each weight along the data-parallel axes
    only: no collective's output is larger than the largest weight's
    block over "model" (the gather path's whole embedding is)."""
    from repro_torch.models import LM
    _, port, _, _ = runs
    cfg = _port_config()
    block = max(w.numel() * 4 // 2 for w in LM(cfg, "meta").parameters())
    for out in port:
        assert 0 < int(out["largest_collective|tp"]) <= block
        assert int(out["largest_collective|dp"]) > block


def test_rows_that_model_does_not_divide(runs):
    """15-token rows on (2,2,2): the residual stream stays whole along
    "model", the fused heads are gathered before they are split, the
    logits are cut along the vocabulary (the loss's log-sum-exp and gold
    logit taken block by block); one step against one device."""
    _, port, one, _ = runs
    np.testing.assert_allclose(port[0]["port222|odd|loss"],
                               one["one|odd|loss"], rtol=LOSS_RTOL)
    _close_params(_params(port[0], "port222|odd"), _params(one, "one|odd"))


def test_rows_that_do_not_divide_by_the_batch_shards(runs):
    """On the (8, 1) host mesh a microbatch's 4 rows stay whole on every
    rank: the run is the one-device run's."""
    _, port, one, _ = runs
    for out in port:
        np.testing.assert_allclose(out["port81|loss"], one["one|loss"],
                                   rtol=LOSS_RTOL)
    _close_params(_params(port[0], "port81"), _params(one, "one"))


def test_elastic_restore_onto_4x2_and_one_device(runs):
    _, port, one, _ = runs
    np.testing.assert_allclose(port[0]["port42|P4|loss"],
                               one["one|P4|loss"], rtol=LOSS_RTOL)
    _close_params(_params(port[0], "port42|P4"), _params(one, "one|P4"))


@pytest.mark.parametrize("ckpt", ["J4", "P4"])
def test_each_package_continues_the_others_checkpoint(runs, ckpt):
    """J4: the JAX-written step-4 checkpoint on the port's (4,2) against
    the JAX package's own continuation; P4: the port-written one on the
    JAX package's (4,2) against the port's."""
    jax_out, port, _, _ = runs
    np.testing.assert_allclose(port[0][f"port42|{ckpt}|loss"],
                               jax_out[f"jax42|{ckpt}|loss"], rtol=LOSS_RTOL)
    _close_params(_params(port[0], f"port42|{ckpt}"),
                  _params(jax_out, f"jax42|{ckpt}"))


def test_the_port_writes_the_reference_format(runs):
    _, _, _, files = runs
    assert sorted(files["P4"]) == sorted(files["J4"])
    for k, v in files["P4"].items():
        assert v.dtype == files["J4"][k].dtype and v.shape == \
            files["J4"][k].shape, k


@pytest.mark.parametrize("tag,idx_tag", [("2x2x2-final", "2x2x2"),
                                         ("4x2-final", "4x2")])
def test_replicated_blocks_are_bitwise_equal_on_every_rank(runs, tag,
                                                           idx_tag):
    jax_out, port, _, _ = runs
    head = f"blk|{tag}|"
    replicas = 0
    for key in sorted(k[len(head):] for k in port[0] if k.startswith(head)):
        seen: dict = {}
        for out in port:
            index = _index(jax_out, idx_tag, key, out[f"coord|{tag}"])
            block = out[head + key]
            if index in seen:
                assert block.tobytes() == seen[index].tobytes(), key
                replicas += 1
            seen[index] = block
    assert replicas > 0


def test_int8_round_trip_and_norm_of_a_placed_gradient(runs):
    """On (2,2,2), a leaf cut over ("pod", "data") and "model" and a
    replicated one: the int8 round trip of each rank's block takes the
    whole tensor's scale (bitwise the whole tensor's round trip), and the
    norm of the blocks is the whole tree's on every rank (float32, summed
    in another order)."""
    _, port, _, _ = runs
    for out in port:
        assert bool(out["int8|same"])
        np.testing.assert_allclose(out["norm|placed"], out["norm|whole"],
                                   rtol=1e-6)
        assert out["norm|placed"].tobytes() == \
            port[0]["norm|placed"].tobytes()


@pytest.mark.parametrize("size", sorted(PSUM_GROUPS))
def test_compressed_psum_matches_a_numpy_oracle(runs, size):
    """Each rank sends q·scale of ``g + r``; the group sums the payloads;
    each rank keeps ``g + r − sent`` for the next round."""
    _, port, _, _ = runs
    res = {r: np.zeros(64, np.float32) for r in range(WORLD)}
    for rnd in range(2):
        sent = {}
        for r in range(WORLD):
            g = _psum_grads(r) + res[r]
            scale = np.maximum(np.abs(g).max(), np.float32(1e-12)) / \
                np.float32(127)
            q = np.clip(np.round(g / scale), -127, 127).astype(np.int8)
            sent[r] = q.astype(np.float32) * scale
            new = g - sent[r]
            got = port[r][f"psum|{size}|{rnd}|res"]
            np.testing.assert_array_equal(got, new)
            # residual bookkeeping: sent + r' = g + r
            assert np.abs(sent[r] + got - g).max() <= 1e-6
            res[r] = new
        for group in PSUM_GROUPS[size]:
            want = np.sum([sent[r] for r in group], axis=0)
            for r in group:
                np.testing.assert_allclose(port[r][f"psum|{size}|{rnd}|out"],
                                           want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_on_four_batch_shards_matches_both_runs(runs, arch):
    """A MoE smoke config on (2,2,2): each rank holds one row of 16 tokens
    of a microbatch, and its capacity, first-come positions and load
    balance are the whole microbatch's.  Tokens drop at this traffic, so
    which ones depends on the order across the ranks: the loss and the
    parameters within the helper's bounds of the port's one-device run
    and of the JAX package's (2,2,2) run, and ``dropped_frac`` (summed
    over the layers, the last microbatch's) equal on every rank and in
    all three runs."""
    jax_out, port, one, _ = runs
    tag = f"port222|{arch}"
    for want in (one[f"one|{arch}|loss"], jax_out[f"jax222|{arch}|loss"]):
        np.testing.assert_allclose(port[0][f"{tag}|loss"], want,
                                   rtol=LOSS_RTOL)
    _close_params(_params(port[0], tag), _params(one, f"one|{arch}"))
    _close_params(_params(port[0], tag), _params(jax_out, f"jax222|{arch}"))
    dropped = one[f"one|{arch}|dropped_frac"]
    assert float(dropped) > 0
    assert float(jax_out[f"jax222|{arch}|dropped_frac"]) == float(dropped)
    for out in port:
        assert out[f"{tag}|dropped_frac"].tobytes() == dropped.tobytes()


def test_moe_on_two_batch_shards_under_remat_matches_one_device(runs):
    """mixtral-smoke on (2,4) under ``remat="full"``: each block's
    recomputation exchanges the expert counts again (every rank in the
    same order); held against the one-device run (``remat="none"``, whose
    gradients are bitwise those under "full")."""
    _, port, one, _ = runs
    arch = MOE_ARCHS[0]
    tag = f"port24|{arch}"
    np.testing.assert_allclose(port[0][f"{tag}|loss"],
                               one[f"one|{arch}|loss"], rtol=LOSS_RTOL)
    _close_params(_params(port[0], tag), _params(one, f"one|{arch}"))
    for out in port:
        assert out[f"{tag}|dropped_frac"].tobytes() == \
            one[f"one|{arch}|dropped_frac"].tobytes()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_the_placed_moe_step_matches_both_runs(runs, arch):
    """A MoE smoke config on (2,2,2) through the placed step: each rank
    runs the experts of its own block of the expert dim, on the tokens
    the other ranks' rows sent there, its capacity, first-come positions
    and load balance the whole microbatch's.  2 steps: the loss within
    the helper's bound of the port's one-device run and of the JAX
    package's (2,2,2) run, the parameters within the helper's bounds of
    the JAX run and of the one-device run but for at most ``MOE_FAR``
    entries whose AdamW step a round-off gradient set
    (``_close_params_but_flips``); ``dropped_frac`` bitwise equal on every
    rank and in all three runs, and tokens dropped.

    The entry (observed on a CPU, torch 2.13): mixtral-smoke's
    ``embed/embedding[188, 55]``, whose token first appears in step 1's
    first microbatch.  Its gradient there is 5.31e-7 on one device and
    2.80e-7 placed (float64: 2.92e-7) against the row's largest 0.15:
    round-off of sums that cancel, which the tensor-parallel attention
    orders otherwise.  Clipped by the global norm (11.4) it is near
    AdamW's ``eps``, so the step it takes differs by 2.9e-4: the placed
    run lands 2.9e-4 from the one-device run, 1.35× the bound.  The four
    float32 runs of the entry spread over that much: one device
    -0.006652, placed -0.006364, the JAX package on one device -0.006434
    (itself 1.02× the bound from the port's one device) and on (2,2,2)
    -0.006563.  Every other entry of both configs is within the bound."""
    jax_out, port, one, _ = runs
    tag = f"ep222|{arch}"
    for want in (one[f"one|{arch}|loss"], jax_out[f"jax222|{arch}|loss"]):
        np.testing.assert_allclose(port[0][f"{tag}|loss"], want,
                                   rtol=LOSS_RTOL)
    _close_params_but_flips(_params(port[0], tag),
                            _params(one, f"one|{arch}"), MOE_STEPS)
    _close_params(_params(port[0], tag), _params(jax_out, f"jax222|{arch}"))
    dropped = one[f"one|{arch}|dropped_frac"]
    assert float(dropped) > 0
    assert jax_out[f"jax222|{arch}|dropped_frac"].astype(
        np.float32).tobytes() == dropped.tobytes()
    for out in port:
        assert out[f"{tag}|dropped_frac"].tobytes() == dropped.tobytes()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_every_model_rank_of_a_row_block_routes_alike(runs, arch):
    """On (2,2,2) the two "model" ranks of a row block hold the same
    tokens and take the router's logits from the same whole ``d``: every
    layer's ``expert_idx``, in the forward and in each recomputation,
    bitwise equal on both (or their positions and buffers would
    disagree)."""
    _, port, _, _ = runs
    tag = f"ep222|{arch}"
    by_block: dict = {}
    for out in port:
        by_block.setdefault(tuple(out[f"{tag}|coord"][:2]), []).append(
            out[f"{tag}|routed"])
    assert len(by_block) == 4
    for a, b in by_block.values():
        assert a.shape[0] > 0 and np.array_equal(a, b)


def test_the_placed_moe_step_where_the_experts_do_not_divide(runs):
    """mixtral-smoke on (2,4,1): its 4 experts do not divide by (pod,
    data) = 8, so they take "pod" and "data" cuts the expert weights' d
    and the buffer's capacity, as mixtral-8x22b's 8 experts on the
    production meshes: the weights gathered along "data", each rank
    running its experts on its slice of their capacity.  2 steps of
    16-row batches (8 rows a microbatch, one a batch shard) against one
    device, ``dropped_frac`` bitwise."""
    _, port, one, _ = runs
    arch = MOE_ARCHS[0]
    tag = f"ep241|{arch}"
    wi, buf = port[0][f"{tag}|specs"]
    assert wi == "('pod', 'data', 'model')" and buf == \
        "('pod', 'data', None)", (wi, buf)
    want = f"one|{arch}|{MOE_UNEVEN_ROWS}"
    np.testing.assert_allclose(port[0][f"{tag}|loss"], one[f"{want}|loss"],
                               rtol=LOSS_RTOL)
    _close_params(_params(port[0], tag), _params(one, want))
    dropped = one[f"{want}|dropped_frac"]
    assert float(dropped) > 0
    for out in port:
        assert out[f"{tag}|dropped_frac"].tobytes() == dropped.tobytes()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_the_placed_moe_step_divides_the_flops(runs, arch):
    """One MoE step on (2,2,2): a rank's FLOPs through the placed step at
    most ``FLOPS_RATIO`` of the gather path's, where every rank runs the
    whole ``[e, cap]`` buffer's experts on whole weights."""
    _, port, _, _ = runs
    for out in port:
        ep, dp = int(out[f"flops|ep|{arch}"]), int(out[f"flops|dp|{arch}"])
        assert 0 < ep <= FLOPS_RATIO * dp, (ep, dp)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_no_moe_collective_outputs_more_than_a_buffer_or_weight_block(
        runs, arch):
    """One MoE step on (2,2,2): no collective's output is larger than one
    rank's expert buffer ``[e, cap, d/model]`` or the largest weight's
    block over "model" (no expert weight is gathered along its expert
    axes); the gather path's whole embedding is."""
    from repro_torch.models import LM
    from repro_torch.models.moe import _capacity
    _, port, _, _ = runs
    cfg = _port_config(arch)
    block = max(w.numel() * 4 // 2 for w in LM(cfg, "meta").parameters())
    buf = cfg.n_experts * _capacity(cfg, 4 * 16) * cfg.d_model // 2 * 4
    for out in port:
        assert 0 < int(out[f"largest_collective|ep|{arch}"]) <= max(block,
                                                                    buf)
        assert int(out[f"largest_collective|dp|{arch}"]) > max(block, buf)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_the_int8_round_trip_on_a_mesh_moves_at_most_one_quantum(runs,
                                                                 package):
    """C1: with ``compress_grads=True``, each of the 4 steps of the
    one-device run taken also on (2,2,2) from the same state.  The mesh
    sums the gradient in another order, so an entry whose gradient lies
    at a rounding boundary of the int8 round trip can round the other
    way: one quantum (the leaf's largest |gradient| over 127), never
    more.  The JAX package's own (2,2,2) run moves such quanta too; over
    a trajectory they compound, which is why a compressed multi-rank run
    leaves the uncompressed runs' bounds."""
    jax_out, port, _, _ = runs
    runs_ = [jax_out] if package == "jax" else port
    moved = 0
    for out in runs_:
        for i in range(STEPS):
            worst, n = out[f"quanta|{package}|{i}"]
            assert worst <= 1 + QUANTUM_SLACK, (i, worst)
            moved += int(n)
    if package == "jax":
        assert moved > 0


@pytest.mark.parametrize("arch", DENSE_ARCHS + MOE_ARCHS)
def test_one_rank_mesh_step_is_bitwise_the_one_device_step(arch, tmp_path):
    """Each dense and MoE smoke config (in its bfloat16) on the (1,1) mesh
    of a one-rank ``gloo`` group, through the placed step: a step of 2
    microbatches under ``remat="full"`` with the int8 round trip, every
    weight and moment bitwise the one-device step's.  Every DTensor op is
    then local, and a MoE layer's blocks are the whole buffer and
    weights, on which it runs the one-device ops in their order."""
    _one_rank_against_one_device(arch, tmp_path)


def test_a_backward_on_its_own_thread_recomputes_on_the_mesh(tmp_path,
                                                             monkeypatch):
    """On a card autograd runs the backward on a thread of its own, where
    the caller's ``use_mesh`` and ``row_blocks`` are not set, and a block
    under remat is recomputed there: ``torch.autograd.grad`` moved to a
    new thread, the one-rank mesh step of a dense and of a MoE smoke
    config stays bitwise the one-device step."""
    import threading
    grad = torch.autograd.grad

    def on_a_thread(*args, **kwargs):
        out = []
        t = threading.Thread(target=lambda: out.append(grad(*args,
                                                            **kwargs)))
        t.start()
        t.join(timeout=TIMEOUT_S)
        assert not t.is_alive() and out, "the backward failed on its thread"
        return out[0]

    monkeypatch.setattr(torch.autograd, "grad", on_a_thread)
    for arch in ("h2o-danube-3-4b", MOE_ARCHS[0]):
        _one_rank_against_one_device(arch, tmp_path)


def test_c3_a_host_capture_of_a_placed_weight_is_a_copy(tmp_path):
    """C3 (``ROADMAP.md`` §3): on a one-rank CPU mesh a replicated weight's
    ``full_tensor().cpu().numpy()`` shares the weight's storage, so the
    next step, which updates the weight in place, moves the capture too.
    The CPU rehearsal of ``chip_smoke.py``'s ``lm_dist_multi`` captured
    its mesh runs' parameters so and then took 3 more steps (one counted,
    two profiled): the replicated norm weights, 6 steps in, sat ~5.6e-4
    from one device's after 3.  On the card ``.cpu()`` copies.
    ``chip_smoke.lm_host_copy`` copies on either device."""
    import torch.distributed as dist

    from repro_torch import models as tm
    from repro_torch import training as tt
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.inputs import state_shardings
    from repro_torch.launch.mesh import make_auto_mesh
    sys.path.insert(0, str(REPO))
    import chip_smoke

    cfg = _port_config("smollm-135m")
    step = tt.build_train_step(cfg, base_lr=5e-3, warmup=0, total_steps=10)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_auto_mesh((1, 1), ("data", "model"), device_type="cpu")
        state = tt.place_train_state(tt.init_train_state(tm.init_params(
            cfg, seed=0, device="cpu")), state_shardings(cfg, mesh))
        w = state.params["final_norm"]
        naive = w.full_tensor().detach().cpu().numpy()
        copy = chip_smoke.lm_host_copy(w)
        before = copy.copy()
        with use_mesh(mesh):
            state, _ = step(state, _pipe(cfg).torch_batch(0, "cpu"))
        after = state.params["final_norm"].full_tensor().detach().numpy()
    finally:
        dist.destroy_process_group()
    assert not np.array_equal(after, before)
    np.testing.assert_array_equal(naive, after)
    np.testing.assert_array_equal(copy, before)


def _one_rank_against_one_device(arch: str, tmp_path) -> None:
    import torch.distributed as dist

    from repro_torch import models as tm
    from repro_torch import training as tt
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.inputs import state_shardings
    from repro_torch.launch.mesh import make_auto_mesh

    cfg = get_smoke_config(arch)
    pipe = _pipe(cfg)
    step = tt.build_train_step(cfg, microbatches=2, base_lr=5e-3, warmup=2,
                               total_steps=50, remat="full",
                               compress_grads=True)

    def batch(i):
        b = pipe.torch_batch(i, "cpu")
        if cfg.frontend == "vision_stub":
            b["image_embeds"] = torch.randn(
                8, cfg.num_patches, cfg.d_model,
                generator=torch.Generator().manual_seed(i))
        return b

    def fresh():
        return tt.init_train_state(tm.init_params(cfg, seed=0,
                                                  device="cpu"))

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / f"store-{arch}"), 1), rank=0, world_size=1)
    try:
        mesh = make_auto_mesh((1, 1), ("data", "model"), device_type="cpu")
        placed = tt.place_train_state(fresh(), state_shardings(cfg, mesh))
        local = fresh()
        with use_mesh(mesh):
            placed, pm = step(placed, batch(0))
        local, lm = step(local, batch(0))
        assert all(torch.equal(pm[k], lm[k]) for k in lm), (pm, lm)
        for part in ("params", "m", "v"):
            got = (placed.params if part == "params"
                   else getattr(placed.opt, part))
            want = (local.params if part == "params"
                    else getattr(local.opt, part))
            for n, w in want.items():
                assert torch.equal(got[n].full_tensor(), w), (part, n)
    finally:
        dist.destroy_process_group()


def test_the_launcher_on_two_ranks_resumes_on_one(tmp_path):
    """``launch/train.py`` at 2 ranks (``COORDINATOR_ADDRESS=file://``)
    checkpoints at steps 3 and 6; its step-6 checkpoint dropped, the same
    command at world size 1 resumes from step 3 and ends within the
    helper's bounds of the one-device launcher's run: the float32 loss of
    each final state on the next batch, ``rtol=1e-4``, and the parameters
    within the helper's ``rtol``/``atol`` but for at most ``LAUNCH_FAR``
    entries.  The launcher computes in bfloat16, where AdamW's normalised
    update of an entry whose gradient is round-off (summed in another
    order on 2 ranks) can take either sign; such an entry is held within
    the helper's bound plus twice the run's summed learning rate."""
    from repro_torch import training as tt
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import LM
    from repro_torch.training.optimizer import cosine_schedule

    steps, seq = 6, 32
    args = ["--smoke", "--device", "cpu", "--mesh", "host", "--steps",
            str(steps), "--ckpt-every", "3", "--seq", str(seq),
            "--log-every", "1"]
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [str(SRC), os.environ.get("PYTHONPATH", "")])}
    for k in ("COORDINATOR_ADDRESS", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)

    def launch(ckpt, **extra):
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *args,
             "--ckpt-dir", str(tmp_path / ckpt)], cwd=REPO,
            env={**env, **extra}, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)

    procs = [launch("two", COORDINATOR_ADDRESS=f"file://{tmp_path}/rdv",
                    WORLD_SIZE="2", RANK=str(r)) for r in range(2)]
    procs.append(launch("one"))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
            assert p.returncode == 0, logs[-1]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert "on mesh {'data': 2, 'model': 1} (cpu, world size 2)" in logs[0]
    assert "[train]" not in logs[1]          # rank 1 logs nothing
    assert sorted(p.name for p in (tmp_path / "two").iterdir()) == \
        ["step_3", "step_6"]
    shutil.move(tmp_path / "two" / "step_6", tmp_path / "two_rank_step_6")
    resumed = launch("two")
    log = resumed.communicate(timeout=TIMEOUT_S)[0]
    assert resumed.returncode == 0, log
    assert "[train] resumed from step 3" in log and "world size 1" in log

    one = _read_ckpt(tmp_path / "one" / "step_6")
    lr = cosine_schedule(3e-4, steps, steps)
    flips = 2 * sum(float(lr(torch.tensor(t))) for t in range(steps))
    for d in (tmp_path / "two" / "step_6", tmp_path / "two_rank_step_6"):
        got = _read_ckpt(d)
        assert sorted(got) == sorted(one)
        far = 0
        for k in got:
            assert got[k].dtype == one[k].dtype, k
            if k.startswith("0/"):
                gap = np.abs(got[k] - one[k])
                bound = PARAM_ATOL + PARAM_RTOL * np.abs(one[k])
                far += int((gap > bound).sum())
                assert (gap <= bound + flips).all(), (k, gap.max())
            elif k in ("1/0", "2"):
                assert int(got[k]) == int(one[k]) == steps
        assert far <= LAUNCH_FAR, (d.name, far)

    cfg = dataclasses.replace(get_smoke_config("smollm-135m"),
                              dtype="float32")
    like = tt.init_train_state(LM(cfg, "meta"))
    batch = TokenPipeline(cfg.vocab_size, seq, 8, seed=1234).torch_batch(
        steps, "cpu")

    def loss(d):
        ck = Checkpointer(d.parent)
        state = ck.restore(like=like, step=steps,
                           shardings=torch.device("cpu"))
        with torch.no_grad():
            return float(tt.train_loss(state.model, cfg, batch,
                                       remat="none")[0])

    want = loss(tmp_path / "one" / "step_6")
    assert want == pytest.approx(loss(tmp_path / "two" / "step_6"),
                                 rel=LOSS_RTOL)


if __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    _jax_side(Path(sys.argv[2]))
