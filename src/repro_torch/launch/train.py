"""Training launcher on one device: config → state → resumable loop.

The port of the JAX package's ``launch/train.py`` at world size 1, with
its flags and defaults.  A restarted job resumes exactly where its last
checkpoint stopped, from three pieces:

  * the deterministic token pipeline: ``batch(step)`` is a pure function
    of the step, so a restarted job replays the stream;
  * async atomic checkpoints (``repro_torch.checkpoint``), one every
    ``--ckpt-every`` steps off the critical path and one at the end;
  * restore from ``latest_step()``, its step read to the host once.

Nothing is read back to the host inside a step: the metrics are read on
log steps only.  ``--mesh single|multi`` and ``COORDINATOR_ADDRESS``
(the reference's production meshes and multi-host entry) are refused until
the port's distributed training lands (``ROADMAP.md`` §1 item 3).

Usage (on the GPU; ``--device cpu`` runs on the CPU):
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 200 --batch 8 --seq 256 --ckpt-dir CKPT [--smoke]
Run the same command again to resume from CKPT's latest checkpoint.
"""

from __future__ import annotations

import argparse
import os
import time

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.data import TokenPipeline
from repro_torch.models import init_params
from repro_torch.training import build_train_step, init_train_state

_NOT_YET = ("is not ported yet: the port trains on one device; distributed "
            "training is ROADMAP.md §1 item 3")


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

    if args.mesh != "host":
        ap.error(f"--mesh {args.mesh} {_NOT_YET}")
    if os.environ.get("COORDINATOR_ADDRESS"):
        ap.error(f"COORDINATOR_ADDRESS (multi-host training) {_NOT_YET}")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"[train] {cfg.name} on {args.device} (world size 1)")
    state = init_train_state(init_params(cfg, seed=0, device=args.device))

    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch, seed=1234)
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        state = ckpt.restore(like=state)
        start = int(state.step)
        print(f"[train] resumed from step {start}")

    step_fn = build_train_step(cfg, microbatches=args.microbatches,
                               base_lr=args.lr, warmup=min(100, args.steps),
                               total_steps=args.steps, remat=args.remat,
                               compress_grads=args.compress_grads)

    t0 = time.time()
    tokens_done = 0
    for step in range(start, args.steps):
        batch = pipe.torch_batch(step, args.device)
        state, metrics = step_fn(state, batch)
        tokens_done += args.batch * args.seq
        if (step + 1) % args.log_every == 0 or step == start:
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
        print(f"[train] final checkpoint at step {args.steps}")


if __name__ == "__main__":
    main()
