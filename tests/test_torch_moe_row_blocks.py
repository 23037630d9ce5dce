"""MoE on row blocks of a microbatch (the gather path of the mesh train
step): ``moe_apply`` run on each of ``n`` equal row blocks, under
``sharding.row_blocks``, against ``moe_apply`` on the whole microbatch,
with no process group.

Each block runs on a thread of its own; ``first_come``'s ``all_reduce``
of the per-expert count table is swapped for an in-process exchange
between the threads (each thread's table summed into every thread's).
Held, for mixtral-smoke and moonshot-smoke in float32 at capacity 0.5
(every expert overflows), 1.0 (some do) and 1.25 (none does), on 2 and 4
blocks:

  * bitwise: each assignment's position in the microbatch, ``keep``, the
    summed per-expert counts and ``dropped_frac`` (the same on every
    block) against the whole microbatch's;
  * within ``REL`` of the largest magnitude: the blocks' outputs,
    concatenated, and the sums over the blocks of their ``load_balance``
    and ``router_z`` shares, against the whole microbatch's.

Observed gaps (on a CPU, torch 2.13): outputs equal (0.0), the summed
``load_balance`` within 1.2e-7 relative and ``router_z`` within 1.6e-7
(the shares sum the probabilities and squares in another order).
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.distributed.sharding import (
    RowBlocks,
    current_row_blocks,
    row_blocks,
)
from repro_torch.models import init_params
from repro_torch.models import moe as tmoe

ARCHS = ("mixtral-8x22b", "moonshot-v1-16b-a3b")
ROWS, SEQ = 4, 16
REL = 1e-6
TIMEOUT_S = 60


def _case(arch: str, capacity_factor: float):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              capacity_factor=capacity_factor)
    layer = init_params(cfg, seed=3, device="cpu").layers[0].mlp
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (ROWS, SEQ, cfg.d_model)).astype(np.float32))
    return cfg, layer, x


def _on_blocks(n: int, fn, monkeypatch):
    """``fn(i)`` for ``i < n``, each on its own thread under ``row_blocks``
    of block ``i`` of ``n``, the count tables summed across the threads;
    the results in block order."""
    barrier = threading.Barrier(n, timeout=TIMEOUT_S)
    tables: list = [None] * n

    def all_reduce(table, group=None):
        i = current_row_blocks().index
        tables[i] = table.clone()
        barrier.wait()
        table.copy_(torch.stack(tables).sum(dim=0, dtype=table.dtype))
        barrier.wait()

    monkeypatch.setattr(tmoe.dist, "all_reduce", all_reduce)
    out: list = [None] * n
    errors: list = []

    def run(i):
        try:
            with row_blocks(RowBlocks(i, n, group=None)):
                out[i] = fn(i)
        except BaseException as exc:     # reported on the test's thread
            errors.append(exc)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT_S)
    assert not errors, errors
    assert all(o is not None for o in out)
    return out


@pytest.mark.parametrize("capacity_factor", [0.5, 1.0, 1.25])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_row_blocks_place_and_drop_as_the_whole_microbatch(
        arch, n, capacity_factor, monkeypatch):
    cfg, layer, x = _case(arch, capacity_factor)
    dt = torch.float32
    with torch.no_grad():
        want, want_aux = tmoe.moe_apply(layer, cfg, x, dt)
        _, _, _, idx = tmoe.route(layer, cfg, x.reshape(-1, cfg.d_model), dt)
        flat = idx.reshape(-1)
        w_pos, w_at, w_counts, w_total = tmoe.first_come(flat, cfg.n_experts)
        assert torch.equal(w_pos, w_at)
        assert torch.equal(w_total.to(torch.float32), w_counts)
        cap = tmoe._capacity(cfg, ROWS * SEQ)
        rows = ROWS // n

        def block(i):
            xb = x[i * rows:(i + 1) * rows]
            _, _, _, ib = tmoe.route(layer, cfg, xb.reshape(-1, cfg.d_model),
                                     dt)
            placed = tmoe.first_come(ib.reshape(-1), cfg.n_experts,
                                     current_row_blocks())
            return placed, tmoe.moe_apply(layer, cfg, xb, dt)

        got = _on_blocks(n, block, monkeypatch)

    at = torch.cat([g[0][1] for g in got])
    assert torch.equal(at, w_at)
    assert torch.equal(at < cap, w_at < cap)
    for (pos, at_i, _, total), _ in got:
        assert total.dtype == torch.int32
        assert torch.equal(total, w_total)
        # a block's buffer slot, its local position, is at most its place
        # in the microbatch
        assert bool((pos <= at_i).all())
    auxes = [g[1][1] for g in got]
    for aux in auxes:
        assert torch.equal(aux["dropped_frac"], want_aux["dropped_frac"])
    dropped = float(want_aux["dropped_frac"])
    assert (dropped > 0) == (capacity_factor < 1.25), dropped
    out = torch.cat([g[1][0] for g in got])
    scale = float(want.abs().max())
    assert float((out - want).abs().max()) <= REL * scale
    for name in ("load_balance", "router_z"):
        total = sum(a[name] for a in auxes)
        assert abs(float(total - want_aux[name])) <= REL * abs(
            float(want_aux[name])), name
