"""Training launcher: config → mesh → sharded state → resumable loop.

The port of the JAX package's ``launch/train.py``, with its flags and
defaults plus ``--device``.  A restarted job resumes exactly where its
last checkpoint stopped, from three pieces:

  * the deterministic token pipeline: ``batch(step)`` is a pure function
    of the step, so a restarted job replays the stream;
  * async atomic checkpoints (``repro_torch.checkpoint``), one every
    ``--ckpt-every`` steps off the critical path and one at the end;
  * elastic restore from ``latest_step()``: a checkpoint holds whole
    arrays, so the job may restart on another mesh or world size.

When ``COORDINATOR_ADDRESS`` is set the launcher is one rank of a job: it
joins the process group through that address (``host:port`` as
``tcp://host:port``, a URL such as ``file:///path`` as it is), its rank
and the world size from ``RANK`` and ``WORLD_SIZE``, over NCCL on the
GPU (the card ``LOCAL_RANK``, else the rank modulo the cards) and
``gloo`` with ``--device cpu``.  It then trains on ``--mesh``: ``host``
is every rank as (data, model) = (world, 1), ``single`` and ``multi`` the
reference's (16, 16) and (2, 16, 16) production meshes, which need 256
and 512 ranks.  The state is placed there by the logical rules and the
step runs data parallel (``training.step``); rank 0 logs and writes the
checkpoints.  Without ``COORDINATOR_ADDRESS``, ``--mesh host`` trains on
one device with no process group (the reference's (1, 1) host mesh).

Nothing is read back to the host inside a step: the metrics are read on
log steps only.

Usage (on the GPU; ``--device cpu`` runs on the CPU):
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 200 --batch 8 --seq 256 --ckpt-dir CKPT [--smoke]
Run the same command again to resume from CKPT's latest checkpoint.  Two
ranks on the CPU:
    COORDINATOR_ADDRESS=file:///tmp/rdv WORLD_SIZE=2 RANK=<0|1> \
        PYTHONPATH=src python -m repro_torch.launch.train --smoke \
        --device cpu --ckpt-dir CKPT
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.data import TokenPipeline
from repro_torch.distributed.sharding import mesh_sizes, use_mesh
from repro_torch.launch.inputs import state_shardings
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import init_params
from repro_torch.training import (
    build_train_step,
    init_train_state,
    place_train_state,
)


def join_process_group(address: str, device: str) -> None:
    """Joins the job's process group through ``address``, as rank
    ``RANK`` of ``WORLD_SIZE``."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    backend = "gloo"
    if torch.device(device).type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
    url = address if "://" in address else f"tcp://{address}"
    dist.init_process_group(backend, init_method=url, rank=rank,
                            world_size=world)


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--remat", default="full",
                    choices=["none", "full", "dots"])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    address = os.environ.get("COORDINATOR_ADDRESS")
    missing = [v for v in ("RANK", "WORLD_SIZE") if v not in os.environ]
    if address and missing:
        ap.error(f"COORDINATOR_ADDRESS is set without "
                 f"{' and '.join(missing)}")
    if address:
        join_process_group(address, args.device)
    try:
        _train(args, distributed=bool(address))
    finally:
        if address:
            dist.destroy_process_group()


def _train(args, distributed: bool):
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    kind = torch.device(args.device).type
    mesh = None
    if distributed or args.mesh != "host":
        mesh = {"host": make_host_mesh,
                "single": lambda t: make_production_mesh(device_type=t),
                "multi": lambda t: make_production_mesh(
                    multi_pod=True, device_type=t)}[args.mesh](kind)
    lead = mesh is None or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    where = (f"mesh {mesh_sizes(mesh)} ({kind}, world size "
             f"{dist.get_world_size()})" if mesh is not None
             else f"{args.device} (world size 1)")
    say(f"[train] {cfg.name} on {where}")
    state = init_train_state(init_params(cfg, seed=0, device=args.device))
    shardings = state_shardings(cfg, mesh) if mesh is not None else None

    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch, seed=1234)
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        state = ckpt.restore(like=state, shardings=shardings)
        start = int(state.step)
        say(f"[train] resumed from step {start}")
    elif shardings is not None:
        state = place_train_state(state, shardings)

    step_fn = build_train_step(cfg, microbatches=args.microbatches,
                               base_lr=args.lr, warmup=min(100, args.steps),
                               total_steps=args.steps, remat=args.remat,
                               compress_grads=args.compress_grads)

    t0 = time.time()
    tokens_done = 0
    for step in range(start, args.steps):
        batch = pipe.torch_batch(step, args.device)
        with use_mesh(mesh):
            state, metrics = step_fn(state, batch)
        tokens_done += args.batch * args.seq
        if lead and ((step + 1) % args.log_every == 0 or step == start):
            dt = time.time() - t0
            print(f"[train] step {step + 1}/{args.steps} "
                  f"loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"tok/s={tokens_done / max(dt, 1e-9):.0f}")
        if ckpt is not None and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state, async_=True)
    if ckpt is not None:
        ckpt.save(args.steps, state, async_=False)
        say(f"[train] final checkpoint at step {args.steps}")


if __name__ == "__main__":
    main()
