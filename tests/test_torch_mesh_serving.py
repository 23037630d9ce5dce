"""Partitioned serving of the dense and MoE families: the port's
``prefill`` and ``decode_step`` on weights and KV caches placed on a
(2,2,2) pod × data × model mesh, against the port on one device and
against the JAX package's (2,2,2) serving.

The JAX side places its float32 weights by ``to_named_shardings`` and its
caches by ``decode_state_specs`` and runs ``prefill`` and ``decode_step``
under ``use_mesh`` and ``jax.jit`` with those in-shardings, as its
``launch/dryrun.py`` lowers a serving cell, in a subprocess of this file
over 8 host devices (``--xla_force_host_platform_device_count=8``).  The
port runs as one ``torch.multiprocessing`` spawn of 8 ``gloo`` ranks
(``FileStore`` rendezvous, one thread a rank), each placing the same
weights (``launch.inputs.place_params``, kept in float32) and fresh caches
(``place_cache``) and its batch by the batch rule, and on one device in
the test process.  Every run starts from the JAX package's draws, carried
across with ``from_reference_params``, and the same seeded numpy prompts;
each is a prefill, then ``STEPS`` decode steps fed the run's own greedy
tokens, into a cache of ``MAX_LEN`` positions.  The float32 smoke configs
take ``attn_chunk`` 4 (5 for the 15-token prompt), so the online softmax
crosses several chunks.  The cases (``CASES``):

  * ``kv-heads``: qwen3-smoke, 4 rows: its 2 KV heads take "model",
    qk-norm;
  * ``head-dim``: gemma3-smoke, 4 rows: one KV head, so the cache's head
    dim takes "model"; local:global window;
  * ``seq-on-model``: h2o-danube-smoke, 4 rows, under the rules override
    ``{"kv_heads": None, "kv_head_dim": None}`` in both packages: the
    cache's sequence takes "model"; sliding window;
  * ``seq-on-data``: smollm-smoke, one row: the cache's sequence takes
    ("pod", "data"), its head dim "model";
  * ``image``: pixtral-smoke, 4 rows, with ``image_embeds``;
  * ``odd-prompt``: qwen3-smoke, 4 rows, a 15-token prompt, which "model"
    does not divide: the projections cut the fused heads;
  * ``moe-shared``: moonshot-smoke, 4 rows (4 row blocks of one row over
    ("pod", "data")), its shared expert; its prefill drops assignments in
    both layers;
  * ``moe-window``: mixtral-smoke, 4 rows, sliding window, no shared
    expert, its 4 experts one a (pod, data) block;
  * ``moe-freed``: mixtral-smoke with 6 experts in both packages: "pod"
    cuts the experts, and the freed "data" the weights' ``d`` and the
    buffer's capacity (each rank runs its experts on its slice of the
    capacity).

A MoE layer's capacity and first-come positions are the whole batch's
(``b·s`` tokens in the prefill, ``b`` in a decode step), as GSPMD runs the
reference's ``moe_apply`` on the global batch: ``prefill`` and
``decode_step`` set the row blocks on a mesh.

Held for each case:

  * each step's logits within ``TOL`` of the largest |logit| of the
    port's one-device run and of the JAX package's (2,2,2) run, and the
    greedy tokens of the three runs equal (``greedy_generate`` under
    ``use_mesh`` gives the same tokens as the step loop);
  * after the prefill and after the last decode step, each rank's block of
    ``k`` and ``v`` within ``TOL`` (of the largest |entry|) of the JAX
    array's shard at the same mesh coordinate (``devices_indices_map``);
  * the caches' placements equal to the JAX sharding's spec;
  * the parameter specs of ``serving_shardings`` equal to the JAX
    package's ``to_named_shardings`` leaf for leaf (the expert weights and
    the shared expert among them);
  * a dense case: no rank gathers a KV cache: every collective of a
    decode step outputs fewer bytes than a rank's block of one layer's
    cache, but for the weights' gathers along the data-parallel axes
    (each a 2-D block of a weight as one use reads it);
  * a MoE case: a decode step's one ``allreduce_`` of the ``[blocks, e]``
    int32 count table a layer (and no other, nor any collective of 4 or
    more dims), and each rank's ``dropped_frac`` a layer in the prefill
    equal to the one-device run's, which drops assignments.

And in-process, F5 (``ROADMAP.md`` §3): on rank 5 of a fake 8-rank
world, a placed MoE prefill whose rows the batch axes cut raises
``ValueError`` with the serving path's row blocks cleared, as does the
train forward outside ``row_blocks`` and the layer under row blocks that
name another block.

And in the test process, on a one-rank ``gloo`` group, every dense and
MoE smoke config in its own dtype (bfloat16): its placed prefill and
decode steps on the (1,1) mesh bitwise equal to its one-device run
(logits, tokens, caches and a MoE prefill's ``dropped_frac``), as
``greedy_generate``'s tokens are.

Observed gaps (on a CPU, torch 2.13, JAX 0.9.0): the logits within
1.15e-6 of the one-device run's and 1.73e-6 of the JAX run's (relative
to the largest |logit|; the dense cases 1.03e-6 and 8.2e-7); the dense
decode steps' largest collective besides the weights' gathers 256–384
bytes, against cache blocks of 576–1,536 bytes; the MoE prefills drop 7
of 128 assignments in each moonshot-smoke layer and 5 and 13 in the
second mixtral-smoke layer (4 and 6 experts).  With the serving path's
row blocks removed (and the layer's check), the MoE cases' logits land
4.4–5.3 from the one-device run's.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_mesh_serving.py``.
"""

import contextlib
import dataclasses
import datetime
import json
import logging
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.launch.dryrun import KIND_OF

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
TIMEOUT_S = 300
WORLD = 8
MESH = ((2, 2, 2), ("pod", "data", "model"))
MAX_LEN = 24
STEPS = 3
TOL = 1e-4
# name: (arch, rows, prompt positions, attn_chunk, rules override)
CASES = {
    "kv-heads": ("qwen3-14b", 4, 16, 4, None),
    "head-dim": ("gemma3-1b", 4, 16, 4, None),
    "seq-on-model": ("h2o-danube-3-4b", 4, 16, 4,
                     {"kv_heads": None, "kv_head_dim": None}),
    "seq-on-data": ("smollm-135m", 1, 16, 4, None),
    "image": ("pixtral-12b", 4, 16, 4, None),
    "odd-prompt": ("qwen3-14b", 4, 15, 5, None),
    "moe-shared": ("moonshot-v1-16b-a3b", 4, 16, 4, None),
    "moe-window": ("mixtral-8x22b", 4, 16, 4, None),
    "moe-freed": ("mixtral-8x22b", 4, 16, 4, None),
}
# config fields a case sets in both packages
CONFIG_OVERRIDES = {"moe-freed": {"n_experts": 6}}
MOE_CASES = ("moe-shared", "moe-window", "moe-freed")
DENSE_CASES = tuple(c for c in CASES if c not in MOE_CASES)
DENSE_ARCHS = ("qwen3-14b", "gemma3-1b", "smollm-135m", "h2o-danube-3-4b",
               "pixtral-12b", "musicgen-large")
MOE_ARCHS = ("moonshot-v1-16b-a3b", "mixtral-8x22b")


def _smoke(arch: str):
    """The port's smoke config of ``arch``."""
    from repro_torch.configs import get_smoke_config
    return get_smoke_config(arch)


def _case_cfg(smoke_config, case: str):
    """The case's smoke config (``smoke_config`` of either package) in
    float32 with its ``attn_chunk`` and ``CONFIG_OVERRIDES``."""
    arch, _, _, chunk, _ = CASES[case]
    return dataclasses.replace(smoke_config(arch), dtype="float32",
                               attn_chunk=chunk,
                               **CONFIG_OVERRIDES.get(case, {}))


def _inputs(cfg, rows: int, positions: int) -> dict:
    """Seeded numpy prompts (and a vision stub's patch embeddings)."""
    rng = np.random.default_rng(7)
    patches = cfg.num_patches if cfg.frontend == "vision_stub" else 0
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (rows, positions - patches), np.int32)}
    if patches:
        out["image_embeds"] = rng.standard_normal(
            (rows, patches, cfg.d_model)).astype(np.float32)
    return out


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _nested(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _flat_leaves(tree, prefix="") -> dict:
    """The leaves of a tree of dicts by their ``/``-joined paths."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _leaf(tree, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _load(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _spec_list(spec) -> list:
    """A resolved spec as JSON: None, an axis name, or a list of names."""
    return [e if e is None or isinstance(e, str) else list(e) for e in spec]


# ---------------------------------------------------------------------------
# the JAX side (run as ``python tests/test_torch_mesh_serving.py jax TMP``)
# ---------------------------------------------------------------------------
def _jax_side(tmp: Path) -> None:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config
    from repro.distributed.sharding import LOGICAL_RULES, use_mesh
    from repro.launch.inputs import (
        abstract_cache,
        abstract_params,
        batch_shardings,
        to_named_shardings,
    )
    from repro.launch.mesh import make_auto_mesh
    from repro.models import decode_step, init_decode_state, prefill

    assert jax.device_count() == WORLD
    mesh = make_auto_mesh(*MESH)
    coord = {d.id: c for c, d in np.ndenumerate(mesh.devices)}
    out: dict = {}
    for case, (_, rows, positions, _, over) in CASES.items():
        cfg = _case_cfg(get_smoke_config, case)
        rules = None if over is None else {**LOGICAL_RULES, **over}
        params = _nested(_load(tmp / f"params_{case}.npz"))
        batch = _inputs(cfg, rows, positions)
        pshapes, pspecs = abstract_params(cfg)
        cshapes, cspecs = abstract_cache(cfg, rows, MAX_LEN)
        p_sh = to_named_shardings(mesh, pspecs, pshapes, rules)
        c_sh = to_named_shardings(mesh, cspecs, cshapes, rules)
        b_sh = batch_shardings(mesh, batch)
        t_sh = batch_shardings(mesh, {"tokens": batch["tokens"][:, :1]})

        def pf(p, b, c, cfg=cfg, rules=rules):
            with use_mesh(mesh, rules):
                return prefill(p, cfg, b, c)

        def dc(p, t, c, cfg=cfg, rules=rules):
            with use_mesh(mesh, rules):
                return decode_step(p, cfg, t["tokens"], c)

        pf = jax.jit(pf, in_shardings=(p_sh, b_sh, c_sh),
                     out_shardings=(None, c_sh))
        dc = jax.jit(dc, in_shardings=(p_sh, t_sh, c_sh),
                     out_shardings=(None, c_sh))
        for path, sh in _flat_leaves(p_sh).items():
            out[f"{case}|pspec|{path}"] = np.asarray(json.dumps(_spec_list(
                tuple(sh.spec) + (None,) * (_leaf(pshapes, path).ndim
                                            - len(sh.spec)))))
        params = jax.device_put(params, p_sh)
        cache = jax.device_put(init_decode_state(cfg, rows, MAX_LEN), c_sh)
        logits, cache = pf(params, batch, cache)
        steps, toks = [np.asarray(logits)], []

        def keep(when, cache, case=case):
            for name in ("k", "v"):
                arr = cache[name]
                out[f"{case}|{when}|{name}"] = np.asarray(arr)
                idx = np.zeros(mesh.devices.shape + (arr.ndim, 2), np.int64)
                for d, index in arr.sharding.devices_indices_map(
                        arr.shape).items():
                    idx[coord[d.id]] = [[sl.start or 0,
                                         n if sl.stop is None else sl.stop]
                                        for sl, n in zip(index, arr.shape)]
                out[f"{case}|{when}|idx|{name}"] = idx
                out[f"{case}|spec|{name}"] = np.asarray(json.dumps(
                    _spec_list(tuple(arr.sharding.spec) + (None,) * (
                        arr.ndim - len(arr.sharding.spec)))))

        keep("prefill", cache)
        for _ in range(STEPS):
            tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
            toks.append(np.asarray(tok))
            logits, cache = dc(params, {"tokens": tok}, cache)
            steps.append(np.asarray(logits))
        toks.append(np.asarray(jnp.argmax(logits, axis=-1)[:, None]))
        keep("last", cache)
        out[f"{case}|logits"] = np.stack(steps)
        out[f"{case}|tokens"] = np.concatenate(toks, axis=1).astype(np.int32)
    np.savez(tmp / "jax.npz", **out)


# ---------------------------------------------------------------------------
# the port: one spawn of 8 ranks, and one device
# ---------------------------------------------------------------------------
def _port_case(case: str, tmp: Path):
    """(config, the model on the CPU, the batch as tensors, rules) of one
    case, the weights the JAX package's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import LOGICAL_RULES
    from repro_torch.models.convert import from_reference_params

    _, rows, positions, _, over = CASES[case]
    cfg = _case_cfg(get_smoke_config, case)
    model = from_reference_params(
        _nested(_load(tmp / f"params_{case}.npz")), cfg, "cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in _inputs(cfg, rows, positions).items()}
    rules = None if over is None else {**LOGICAL_RULES, **over}
    return cfg, model, batch, rules


def _serve(model, cfg, batch, cache, step_mode=None):
    """A prefill, then ``STEPS`` decode steps fed the greedy tokens.
    Returns (logits [STEPS + 1, B, V], tokens [B, STEPS + 1], the cache
    after the prefill, the last cache, each MoE layer's ``dropped_frac``
    in the prefill); ``step_mode`` wraps each decode step."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.lm_serving import greedy_tokens
    from repro_torch.models.moe import MoE

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t

    drops: list[float] = []
    hooks = [lp.mlp.register_forward_hook(
        lambda mod, args, out: drops.append(float(local(
            out[1]["dropped_frac"])))) for lp in model.layers
        if isinstance(lp.mlp, MoE)]
    try:
        logits, cache = prefill(model, cfg, batch, cache)
    finally:
        for h in hooks:
            h.remove()
    after = {n: cache[n].to_local().clone() if hasattr(cache[n], "to_local")
             else cache[n].clone() for n in ("k", "v")}
    steps, toks = [whole(logits)], [greedy_tokens(logits)]
    for _ in range(STEPS):
        if step_mode is None:
            logits, cache = decode_step(model, cfg, toks[-1], cache)
        else:
            with step_mode:
                logits, cache = decode_step(model, cfg, toks[-1], cache)
        steps.append(whole(logits))
        toks.append(greedy_tokens(logits))
    # (a bfloat16 logit is a float32 one exactly)
    return (torch.stack(steps).to(torch.float32).numpy(),
            torch.cat(toks, dim=1).numpy(), after, cache,
            np.asarray(drops, np.float32))


class _CollectiveShapes(TorchDispatchMode):
    """Each collective's op name, output shape and bytes under it, in
    ``records`` (DTensor ops are passed on to DTensor first, as the dry
    run's ``CollectiveMode`` does)."""

    def __init__(self):
        super().__init__()
        self.records: list[tuple[str, tuple, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is DTensor for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        name = func._overloadpacket.__name__
        if name in KIND_OF:
            self.records += [(name, tuple(t.shape),
                              t.numel() * t.element_size())
                             for t in tree_leaves(out)
                             if isinstance(t, torch.Tensor)]
        return out


def _port_worker(rank: int, tmp: str) -> None:
    import torch.distributed as dist

    from repro_torch.distributed.sharding import use_mesh, weight_use
    from repro_torch.launch.inputs import (
        batch_shardings,
        place_cache,
        place_params,
        serving_shardings,
    )
    from repro_torch.launch.mesh import make_auto_mesh
    from repro_torch.models import init_decode_state
    from repro_torch.models.lm_serving import greedy_generate
    from repro_torch.training.step import param_shardings

    torch.set_num_threads(1)
    # DTensor warns that a dim sharded over two mesh dims gathers in two
    # steps, and that gloo moves a shard between dims by a gather; the
    # bits are the same
    for name in ("torch.distributed.tensor._redistribute",
                 "torch._logging._internal"):
        logging.getLogger(name).setLevel(logging.ERROR)
    tmp = Path(tmp)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / "store"), WORLD), rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    mesh = make_auto_mesh(*MESH, device_type="cpu")
    out: dict = {"coord": np.asarray(mesh.get_coordinate())}
    for case, (_, rows, _, _, _) in CASES.items():
        cfg, model, batch, rules = _port_case(case, tmp)
        params, caches = serving_shardings(cfg, mesh, rows, MAX_LEN, rules)
        placed = place_params(model, params, dtype=None)
        for path, sh in _flat_leaves(params).items():
            out[f"{case}|pspec|{path}"] = np.asarray(json.dumps(
                _spec_list(sh.spec)))
        by_name = param_shardings(model, params)
        out[f"{case}|weight_placements"] = np.asarray(all(
            tuple(w.placements) == by_name[n].placements
            for n, w in placed.named_parameters()))
        cache = place_cache(init_decode_state(cfg, rows, MAX_LEN, "cpu"),
                            caches)
        pbatch = {k: sh.distribute(batch[k])
                  for k, sh in batch_shardings(mesh, batch).items()}
        mode = _CollectiveShapes()
        with use_mesh(mesh, rules):
            logits, toks, after, last, drops = _serve(placed, cfg, pbatch,
                                                      cache, mode)
            if cfg.frontend != "vision_stub":
                out[f"{case}|greedy"] = greedy_generate(
                    placed, cfg, batch["tokens"].numpy(), STEPS + 1)
            out[f"{case}|weight_bytes"] = np.asarray(max(
                weight_use(w).to_local().numel() * 4
                for w in placed.parameters()))
        out[f"{case}|logits"], out[f"{case}|tokens"] = logits, toks
        out[f"{case}|dropped"] = drops
        for name in ("k", "v"):
            out[f"{case}|prefill|{name}"] = after[name].numpy()
            out[f"{case}|last|{name}"] = last[name].to_local().numpy()
            out[f"{case}|spec|{name}"] = np.asarray(json.dumps(_spec_list(
                caches[name].spec)))
            out[f"{case}|placements|{name}"] = np.asarray(
                tuple(last[name].placements) == caches[name].placements)
        out[f"{case}|block_bytes"] = np.asarray(
            last["k"].to_local()[0].numel() * 4)
        out[f"{case}|coll_2d"] = np.asarray(max(
            (b for _, s, b in mode.records if len(s) == 2), default=0))
        out[f"{case}|coll_other"] = np.asarray(max(
            (b for _, s, b in mode.records if len(s) != 2), default=0))
        out[f"{case}|count_tables"] = np.asarray(sum(
            n == "allreduce_" and sh == (4, cfg.n_experts) and b
            == 4 * cfg.n_experts * 4 for n, sh, b in mode.records))
        out[f"{case}|allreduce_"] = np.asarray(sum(
            n == "allreduce_" for n, _, _ in mode.records))
        out[f"{case}|coll_dims"] = np.asarray(max(
            len(sh) for _, sh, _ in mode.records))
    np.savez(tmp / f"port_{rank}.npz", **out)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# fixture
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX side's, each port rank's and the one-device runs'
    outputs."""
    import jax
    import torch.multiprocessing as mp

    from repro import models as jm
    from repro.configs import get_smoke_config as jsmoke
    from repro_torch.models import init_decode_state
    from repro_torch.models.lm_serving import greedy_generate

    tmp = tmp_path_factory.mktemp("mesh_serving")
    for case in CASES:
        jcfg = _case_cfg(jsmoke, case)
        params = jax.jit(lambda key, jcfg=jcfg: jm.init_params(key, jcfg)[0])(
            jax.random.PRNGKey(0))
        np.savez(tmp / f"params_{case}.npz", **_flat(params))
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
        one: dict = {}
        for case, (_, rows, _, _, _) in CASES.items():
            cfg, model, batch, _ = _port_case(case, tmp)
            logits, toks, _, _, drops = _serve(
                model, cfg, batch, init_decode_state(cfg, rows, MAX_LEN,
                                                     "cpu"))
            one[f"{case}|logits"], one[f"{case}|tokens"] = logits, toks
            one[f"{case}|dropped"] = drops
            if cfg.frontend != "vision_stub":
                one[f"{case}|greedy"] = greedy_generate(
                    model, cfg, batch["tokens"].numpy(), STEPS + 1)
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail("the port's 8-rank spawn timed out")
        log, _ = jproc.communicate(
            timeout=max(1.0, deadline - time.monotonic()))
        assert jproc.returncode == 0, f"the JAX side failed:\n{log}"
    finally:
        torch.set_num_threads(threads)
        if jproc.poll() is None:
            jproc.kill()
            jproc.wait()
    port = [_load(tmp / f"port_{r}.npz") for r in range(WORLD)]
    return _load(tmp / "jax.npz"), port, one


def _close(got, want, what: str) -> None:
    gap = np.abs(np.asarray(got, np.float64) - want).max()
    assert gap <= TOL * np.abs(want).max(), (what, gap)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", CASES)
def test_the_mesh_logits_match_one_device_and_the_jax_mesh(runs, case):
    jax_out, port, one = runs
    for r, out in enumerate(port):
        _close(out[f"{case}|logits"], one[f"{case}|logits"], f"one, r{r}")
        _close(out[f"{case}|logits"], jax_out[f"{case}|logits"],
               f"jax, r{r}")


@pytest.mark.parametrize("case", CASES)
def test_the_greedy_tokens_of_the_three_runs_are_equal(runs, case):
    jax_out, port, one = runs
    want = one[f"{case}|tokens"]
    np.testing.assert_array_equal(jax_out[f"{case}|tokens"], want)
    for out in port:
        np.testing.assert_array_equal(out[f"{case}|tokens"], want)
        if f"{case}|greedy" in one:
            np.testing.assert_array_equal(out[f"{case}|greedy"],
                                          one[f"{case}|greedy"])
            np.testing.assert_array_equal(one[f"{case}|greedy"], want)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("when", ["prefill", "last"])
def test_each_rank_holds_the_jax_cache_shard_at_its_coordinate(runs, case,
                                                               when):
    jax_out, port, _ = runs
    for name in ("k", "v"):
        whole = jax_out[f"{case}|{when}|{name}"]
        idx = jax_out[f"{case}|{when}|idx|{name}"]
        for r, out in enumerate(port):
            index = tuple(slice(int(a), int(b))
                          for a, b in idx[tuple(out["coord"])])
            got = out[f"{case}|{when}|{name}"]
            assert got.shape == whole[index].shape, (name, r)
            _close(got, whole[index], f"{name}, r{r}")
            if np.abs(whole[index]).max() == 0:
                assert not got.any(), (name, r)


@pytest.mark.parametrize("case", CASES)
def test_the_cache_placements_are_the_jax_shardings(runs, case):
    jax_out, port, _ = runs
    for name in ("k", "v"):
        want = json.loads(str(jax_out[f"{case}|spec|{name}"]))
        for out in port:
            assert json.loads(str(out[f"{case}|spec|{name}"])) == want
            assert out[f"{case}|placements|{name}"]


@pytest.mark.parametrize("case", CASES)
def test_the_weight_placements_are_the_jax_shardings(runs, case):
    """``serving_shardings``' parameter specs (the expert weights and
    moonshot's shared expert among them) equal the JAX package's
    ``to_named_shardings`` of the same shapes, leaf for leaf, and each
    placed weight holds its sharding's placements."""
    jax_out, port, _ = runs
    keys = {k for k in jax_out if k.startswith(f"{case}|pspec|")}
    assert keys and keys == {k for k in port[0]
                             if k.startswith(f"{case}|pspec|")}
    if CASES[case][0] in MOE_ARCHS:
        assert f"{case}|pspec|layers/mlp/wi" in keys
    for out in port:
        for k in keys:
            assert json.loads(str(out[k])) == json.loads(str(jax_out[k])), k
        assert out[f"{case}|weight_placements"]


@pytest.mark.parametrize("case", DENSE_CASES)
def test_no_decode_collective_gathers_a_cache(runs, case):
    """Every collective of the decode steps outputs fewer bytes than a
    rank's block of one layer's cache, but for the weights' gathers along
    the data-parallel axes: a dense model's weights are its only 2-D
    tensors (its activations, scores and caches have 3 to 5 dims), and
    none of those outputs more than the largest weight as one use reads it
    (``weight_use``)."""
    _, port, _ = runs
    for out in port:
        assert 0 < out[f"{case}|coll_2d"] <= out[f"{case}|weight_bytes"]
        assert 0 < out[f"{case}|coll_other"] < out[f"{case}|block_bytes"]


@pytest.mark.parametrize("case", MOE_CASES)
def test_a_moe_decode_step_sums_one_count_table_a_layer(runs, case):
    """The MoE layer's capacity and first-come positions in a decode step
    are the whole batch's: one ``allreduce_`` of the ``[blocks, e]`` int32
    count table a layer and step (4 row blocks of one row), no other
    ``allreduce_`` (the aux values, which serving does not read, add
    none), and no collective of 4 or more dims (no cache moves)."""
    _, port, _ = runs
    cfg = _case_cfg(_smoke, case)
    for out in port:
        assert out[f"{case}|count_tables"] == cfg.n_layers * STEPS
        assert out[f"{case}|allreduce_"] == cfg.n_layers * STEPS
        assert out[f"{case}|coll_dims"] <= 3


@pytest.mark.parametrize("case", MOE_CASES)
def test_a_moe_prefill_drops_as_the_one_device_run(runs, case):
    """Each rank's ``dropped_frac`` of each MoE layer in the prefill, from
    the whole batch's summed counts, equal to the one-device run's."""
    _, port, one = runs
    want = one[f"{case}|dropped"]
    assert want.shape == (_case_cfg(_smoke, case).n_layers,)
    for out in port:
        np.testing.assert_array_equal(out[f"{case}|dropped"], want)


def test_the_moe_prefills_drop_assignments(runs):
    """Every MoE case's prefill drops assignments in a layer at least
    (moonshot-smoke in both) in the one-device run, so that the order of
    first come across the row blocks decides which tokens the experts
    see."""
    _, _, one = runs
    for case in MOE_CASES:
        assert (one[f"{case}|dropped"] > 0).any(), case
    assert (one["moe-shared|dropped"] > 0).all()


@pytest.mark.parametrize("arch", DENSE_ARCHS + MOE_ARCHS)
def test_one_rank_placed_serving_is_bitwise_the_one_device_run(arch,
                                                               tmp_path):
    """The smoke config in its bfloat16 on the (1,1) mesh of a one-rank
    ``gloo`` group, its weights placed in their float32: the prefill and
    ``STEPS`` decode steps' logits, the tokens and the caches bitwise the
    one-device run's, and so are ``greedy_generate``'s tokens.  Every
    DTensor op is then local, and the attention runs the one-device code
    on its blocks."""
    import torch.distributed as dist

    from repro_torch import models as tm
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.inputs import (
        batch_shardings,
        place_cache,
        place_params,
        serving_shardings,
    )
    from repro_torch.launch.mesh import make_auto_mesh
    from repro_torch.models.lm_serving import greedy_generate

    cfg = dataclasses.replace(get_smoke_config(arch), attn_chunk=4)
    rows = 4
    model = tm.init_params(cfg, seed=0, device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in _inputs(cfg, rows, 16).items()}
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_auto_mesh((1, 1), ("data", "model"), device_type="cpu")
        params, caches = serving_shardings(cfg, mesh, rows, MAX_LEN)
        placed = place_params(model, params, dtype=None)
        cache = place_cache(tm.init_decode_state(cfg, rows, MAX_LEN, "cpu"),
                            caches)
        pbatch = {k: sh.distribute(batch[k])
                  for k, sh in batch_shardings(mesh, batch).items()}
        with use_mesh(mesh):
            got = _serve(placed, cfg, pbatch, cache)
            greedy = (greedy_generate(placed, cfg, batch["tokens"].numpy(), 4)
                      if cfg.frontend != "vision_stub" else None)
    finally:
        dist.destroy_process_group()
    want = _serve(model, cfg, batch,
                  tm.init_decode_state(cfg, rows, MAX_LEN, "cpu"))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[4], want[4])
    for name in ("k", "v"):
        assert torch.equal(got[2][name], want[2][name]), name
        assert torch.equal(got[3][name].full_tensor(), want[3][name]), name
    if greedy is not None:
        np.testing.assert_array_equal(
            greedy, greedy_generate(model, cfg, batch["tokens"].numpy(), 4))


def test_f5_a_placed_moe_layer_refuses_rows_without_their_row_blocks(
        monkeypatch):
    """F5: moonshot-smoke placed for serving on rank 5 of a fake 8-rank
    (2, 2, 2) world (every collective returns at once: only the control
    flow is checked; the (2,2,2) spawn above holds the values), a batch
    of 4 rows, so rank 5 holds row block 2 of 4.  ``prefill`` and
    ``decode_step`` run through the serving path, which sets the row
    blocks (``sharding.batch_row_blocks``); with the serving path's row
    blocks cleared the prefill raises ``ValueError``, and so does the
    train forward on the same placed weights outside ``row_blocks``;
    the layer refuses row blocks that name another block or another
    count, and takes the serving path's."""
    from repro_torch import models as tm
    from repro_torch.distributed.sharding import (
        RowBlocks,
        batch_row_blocks,
        row_blocks,
        use_mesh,
    )
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.inputs import (
        batch_shardings,
        place_cache,
        place_params,
        serving_shardings,
    )
    from repro_torch.launch.mesh import make_auto_mesh
    from repro_torch.models import model as model_mod
    from repro_torch.models import moe

    cfg = _smoke("moonshot-v1-16b-a3b")
    rows = 4
    model = tm.init_params(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(_inputs(cfg, rows, 16)["tokens"])
    with fake_world(WORLD, rank=5):
        mesh = make_auto_mesh(*MESH, device_type="cpu")
        params, caches = serving_shardings(cfg, mesh, rows, MAX_LEN)
        placed = place_params(model, params)

        def fresh():
            return place_cache(tm.init_decode_state(cfg, rows, MAX_LEN,
                                                    "cpu"), caches)

        batch = {"tokens": batch_shardings(mesh, {"tokens": tokens})[
            "tokens"].distribute(tokens)}
        with use_mesh(mesh):
            assert batch_row_blocks(rows).index == 2
            assert batch_row_blocks(rows).count == 4
            assert batch_row_blocks(1) is None
            logits, cache = tm.prefill(placed, cfg, batch, fresh())
            tm.decode_step(placed, cfg, tokens[:, :1], cache)
            x = tm.model._embed_inputs(placed, cfg, batch, cfg.compute_dtype)
            layer = placed.layers[0].mlp
            for wrong in (None, RowBlocks(0, 4, None), RowBlocks(1, 2, None)):
                with row_blocks(wrong), pytest.raises(ValueError,
                                                      match="row block 2"):
                    moe.moe_apply(layer, cfg, x, cfg.compute_dtype)
            with row_blocks(batch_row_blocks(rows)):
                y, _ = moe.moe_apply(layer, cfg, x, cfg.compute_dtype)
            assert y.shape == x.shape and y.placements == x.placements
            with pytest.raises(ValueError, match="row block 2 of 4"):
                tm.forward(placed, cfg, batch)
            monkeypatch.setattr(model_mod, "_serving_row_blocks",
                                lambda cfg, rows: contextlib.nullcontext())
            with pytest.raises(ValueError, match="row block 2 of 4"):
                tm.prefill(placed, cfg, batch, fresh())


if __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    _jax_side(Path(sys.argv[2]))
