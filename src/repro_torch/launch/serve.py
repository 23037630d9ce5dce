"""Serving launcher: batched greedy generation over request waves.

Usage (on the GPU; ``--device cpu`` runs on the CPU; any architecture of
``repro_torch.configs``, the recurrent rwkv6-1.6b and zamba2-1.2b among
them):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --n-requests 8 --prompt-len 16 --max-new 32
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.models import init_params
from repro_torch.models.lm_serving import ServeEngine


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = init_params(cfg, seed=0, device=args.device)
    engine = ServeEngine(model, cfg, n_slots=args.n_slots,
                         max_len=args.prompt_len + args.max_new + 8)

    rng = np.random.default_rng(0)
    for _ in range(args.n_requests):
        engine.submit(rng.integers(0, cfg.vocab_size, args.prompt_len))

    t0 = time.perf_counter()
    total = 0
    while engine._queue:
        outs = engine.run_wave(max_tokens=args.max_new)
        total += sum(len(v) for v in outs.values())
        for rid, toks in sorted(outs.items()):
            print(f"[serve] req {rid}: {len(toks)} tokens, "
                  f"head={toks[:8]}")
    dt = time.perf_counter() - t0
    print(f"[serve] {total} tokens in {dt:.2f}s "
          f"({total / max(dt, 1e-9):.1f} tok/s) on {args.device}")


if __name__ == "__main__":
    main()
