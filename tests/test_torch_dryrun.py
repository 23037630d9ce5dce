"""The dry run (``repro_torch.launch.dryrun``), ``launch.inputs.abstract_cache``
and ``models.decode_state_specs`` against the JAX package.

Held:

  * ``decode_state_specs`` equal to the reference's for every family;
  * ``abstract_cache``'s shapes, dtypes and specs equal to the reference's
    ``jax.eval_shape`` tree for every arch at its smoke and full config, at
    (128, 32768) and (1, 524288);
  * per-rank placed bytes of every arch × cell × production mesh: the sum
    of the reference's ``NamedSharding.shard_shape`` bytes over its train
    state, or its bfloat16 parameters and caches, and over its batch, as
    its ``dryrun.py`` lays them out, computed in a JAX subprocess over 512
    host devices (``--xla_force_host_platform_device_count=512``), equals
    the port's ``argument_bytes`` exactly;
  * a smoke train cell on an 8-rank (2, 4) mesh: the reference's
    ``lower_train_cell(...).compile().memory_analysis()
    .argument_size_in_bytes`` equals the port's traced ``argument_bytes``;
  * FLOPs of each family's smoke ``prefill`` and ``decode_step`` under
    ``FlopCounterMode`` equal the ``dot_general`` FLOPs of the reference's
    ``jax.make_jaxpr`` of the same call (a scan body counted once an
    iteration), and the full-width smollm-135m ``decode_32k`` cell's
    through ``run_cell``, traced on one rank of the placed serving on
    (16, 16), are 1/256 of them;
  * qwen3-smoke's prefill and decode cells traced on rank 0 of an 8-rank
    (2, 2, 2) fake mesh: FLOPs at most 1/4 and a peak below the whole
    cell's on one fake device;
  * at one rank, a traced mesh step's FLOPs equal a real CPU step's
    ``FlopCounterMode`` count (dense, MoE, rwkv6), and its collectives are
    one-rank sums only (none for the dense step);
  * a smoke mesh step's collectives on 8 and 512 fake ranks, op for op and
    byte for byte, as worked out from the placements, the shapes and the
    microbatch count: the rwkv6 step's (weights gathered whole, gradients
    all-reduced), the dense step's (weights gathered along the
    data-parallel axes per use, gradients reduce-scattered, the
    activations' tensor- and sequence-parallel moves) and the MoE step's
    (the dense step's attention; each MoE layer's count table all-reduced
    over the batch shards in the forward and in its recomputation, its
    buffer reduce-scattered onto the expert blocks and gathered back, the
    expert weights gathered only along the axes that do not cut their
    experts);
  * each dense smoke train cell's peak a rank on 512 fake ranks below the
    data-parallel step's (the dense step with ``TP_FAMILIES`` emptied),
    and each MoE smoke train cell's on 8 fake ranks below the gather
    path's.

FLOPs: ``FlopCounterMode`` counts matrix products (``mm``, ``bmm``,
``addmm``, convolutions, attention) at ``2·M·N·K``, and the reference's
``dot_general``s at the same; the port's products are ``@`` and
``torch.einsum`` where the reference's are ``jnp.dot``/``einsum``, one
for one, so the counts are equal with no gap.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.extend.core as jcore
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.launch.inputs import abstract_cache as jabstract_cache
from repro.launch.inputs import abstract_params as jabstract_params
from repro.models import decode_state_specs as jdecode_state_specs
from repro.models import decode_step as jdecode_step
from repro.models import init_decode_state as jinit_decode_state
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro_torch import models as tm
from repro_torch import training as tt
from repro_torch.configs import (
    ARCHS,
    SHAPES,
    ShapeCell,
    cells_for,
    get_config,
    get_smoke_config,
)
from repro_torch.launch import dryrun as dr
from repro_torch.launch.inputs import abstract_cache, input_specs
from repro_torch.launch.mesh import make_auto_mesh, make_production_mesh
from repro_torch.models import LM, decode_state_specs
from repro_torch.models.config import ModelConfig
from repro_torch.training import step as tstep
from repro_torch.training.step import param_shardings

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
TIMEOUT_S = 300
# one arch of each family; mamba2 has no arch of its own: zamba2's config
# with the mamba2 family, as the reference's tests make it
FAMILIES = {"dense": "smollm-135m", "moe": "mixtral-8x22b",
            "rwkv6": "rwkv6-1.6b", "mamba2": "zamba2-1.2b",
            "hybrid": "zamba2-1.2b", "vision": "pixtral-12b"}
CACHE_SIZES = ((128, 32768), (1, 524288))
MESHES = {"16x16": False, "2x16x16": True}
# the smoke train cell: 2 microbatches of 32 rows, which the batch axes of
# (2, 4) and of (2, 16, 16) divide
SMOKE_CELL = ShapeCell("smoke", 16, 64, "train", microbatch=32)
SMOKE_ARCH = "qwen3-14b"
SMOKE_MESH = ((2, 4), ("data", "model"))
PROMPT, MAX_LEN, BATCH = 32, 64, 2


def _cfgs(name: str, smoke: bool, family: str | None = None):
    """(the JAX package's config, the port's) of ``name``."""
    jcfg = (jget_smoke_config if smoke else jget_config)(name)
    if family is not None:
        jcfg = dataclasses.replace(jcfg, family=family)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _family_cfgs(family: str, smoke: bool = True):
    return _cfgs(FAMILIES[family], smoke,
                 "mamba2" if family == "mamba2" else None)


def _cells():
    return [(arch, shape, mesh) for arch in ARCHS for shape in cells_for(arch)
            for mesh in MESHES]


# --------------------------------------------------------------------------
# the JAX side: shard-shape sums over 512 host devices, one smoke compile
# --------------------------------------------------------------------------
def _jax_side(out: Path) -> None:
    from jax.sharding import NamedSharding

    from repro.configs import SHAPES as JSHAPES
    from repro.configs import ShapeCell as JShapeCell
    from repro.configs import cells_for as jcells_for
    from repro.launch.dryrun import lower_train_cell
    from repro.launch.inputs import batch_shardings, input_specs
    from repro.launch.inputs import to_named_shardings
    from repro.launch.mesh import make_auto_mesh as jmesh
    from repro.launch.mesh import make_production_mesh as jprod_mesh
    from repro.training import init_train_state
    from repro.training.optimizer import AdamWState
    from repro.training.step import TrainState

    def tree_bytes(shapes, shardings):
        return int(sum(jax.tree.leaves(jax.tree.map(
            lambda sh, x: math.prod(sh.shard_shape(x.shape))
            * x.dtype.itemsize, shardings, shapes,
            is_leaf=lambda x: isinstance(x, NamedSharding)))))

    sums = {}
    for mesh_name, multi in MESHES.items():
        mesh = jprod_mesh(multi_pod=multi)
        for arch in ARCHS:
            cfg = jget_config(arch)
            for shape in jcells_for(arch):
                cell = JSHAPES[shape]
                batch = input_specs(cfg, cell)
                got = {"batch": tree_bytes(batch,
                                           batch_shardings(mesh, batch))}
                if cell.kind == "train":       # dryrun.py:93-98
                    pshapes, pspecs = jabstract_params(cfg)
                    shapes = jax.eval_shape(init_train_state, pshapes)
                    specs = TrainState(params=pspecs, opt=AdamWState(
                        step=(), m=pspecs, v=pspecs), step=())
                    got["state"] = tree_bytes(shapes, to_named_shardings(
                        mesh, specs, shapes))
                else:                          # dryrun.py:116-120
                    pshapes, pspecs = jabstract_params(cfg,
                                                       dtype=jnp.bfloat16)
                    cshapes, cspecs = jabstract_cache(
                        cfg, cell.global_batch, cell.seq_len)
                    got["params"] = tree_bytes(pshapes, to_named_shardings(
                        mesh, pspecs, pshapes))
                    got["cache"] = tree_bytes(cshapes, to_named_shardings(
                        mesh, cspecs, cshapes))
                sums[f"{arch}|{shape}|{mesh_name}"] = got
    shape, axes = SMOKE_MESH
    mesh = jmesh(shape, axes, devices=jax.devices()[:math.prod(shape)])
    mem = lower_train_cell(jget_smoke_config(SMOKE_ARCH), JShapeCell(
        *dataclasses.astuple(SMOKE_CELL)), mesh).compile().memory_analysis()
    out.write_text(json.dumps({
        "sums": sums,
        "smoke_argument_bytes": int(mem.argument_size_in_bytes)}))


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(the JAX side's output, the port's ``argument_bytes`` of every cell,
    each production mesh in a fake world of its rank count), the JAX
    subprocess running meanwhile."""
    out = tmp_path_factory.mktemp("dryrun") / "jax.json"
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512",
           "PYTHONPATH": os.pathsep.join(
               [str(SRC), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.Popen([sys.executable, __file__, "jax", str(out)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        sums = {}
        for mesh_name, multi in MESHES.items():
            with dr.fake_world(512 if multi else 256):
                mesh = make_production_mesh(multi_pod=multi,
                                            device_type="cpu")
                for arch, shape, m in _cells():
                    if m == mesh_name:
                        sums[f"{arch}|{shape}|{m}"] = dr.argument_bytes(
                            get_config(arch), SHAPES[shape], mesh)
        log, _ = proc.communicate(timeout=TIMEOUT_S)
    finally:
        proc.kill()
        proc.wait()
    assert proc.returncode == 0, log[-4000:]
    return json.loads(out.read_text()), sums


# --------------------------------------------------------------------------
# decode_state_specs, abstract_cache
# --------------------------------------------------------------------------
@pytest.mark.parametrize("family", list(FAMILIES))
def test_decode_state_specs_match_the_reference(family):
    jcfg, cfg = _family_cfgs(family, smoke=False)
    assert decode_state_specs(cfg) == jdecode_state_specs(jcfg)


@pytest.mark.parametrize("batch,max_len", CACHE_SIZES)
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", [*ARCHS, "mamba2"])
def test_abstract_cache_matches_the_reference(arch, smoke, batch, max_len):
    jcfg, cfg = (_family_cfgs("mamba2", smoke) if arch == "mamba2"
                 else _cfgs(arch, smoke))
    jshapes, jspecs = jabstract_cache(jcfg, batch, max_len)
    shapes, specs = abstract_cache(cfg, batch, max_len)
    assert specs == jspecs
    assert set(shapes) == set(jshapes)
    for k, x in shapes.items():
        assert x.device.type == "meta"
        assert tuple(x.shape) == tuple(jshapes[k].shape), k
        assert str(x.dtype) == f"torch.{jshapes[k].dtype}", k


# --------------------------------------------------------------------------
# per-rank bytes
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape,mesh", _cells())
def test_placed_bytes_match_the_reference_shards(sides, arch, shape, mesh):
    jax_side, port_sums = sides
    key = f"{arch}|{shape}|{mesh}"
    got = dict(port_sums[key])
    assert got.pop("total") == sum(got.values())
    assert got == jax_side["sums"][key]


def test_smoke_train_cell_argument_bytes_match_xla(sides):
    jax_side, _ = sides
    shape, axes = SMOKE_MESH
    with dr.fake_world(math.prod(shape)):
        mesh = make_auto_mesh(shape, axes, device_type="cpu")
        got = dr.lower_train_cell(get_smoke_config(SMOKE_ARCH), SMOKE_CELL,
                                  mesh)
    assert got["memory"]["argument_bytes"] == jax_side[
        "smoke_argument_bytes"]
    assert got["memory"]["peak_bytes"] >= got["memory"]["argument_bytes"]


# --------------------------------------------------------------------------
# FLOPs
# --------------------------------------------------------------------------
def _dot_flops(jaxpr) -> int:
    """2·M·N·K of every distinct ``dot_general`` that contracts a dim, in
    a (closed) jaxpr, a scan's body times its length, every other
    sub-jaxpr once.

    Distinct after common-subexpression elimination, as XLA's compile
    merges equations of one primitive and parameters on equal operands:
    the reference's prefill computes each attention block's q/k/v
    projections twice, once in ``attention_prefill`` and again to write
    the cache (``src/repro/models/model.py:145-147``), and its compiled
    program (like the port) computes them once.  A ``dot_general`` with no
    contracting dim is an outer or elementwise product that a
    multi-operand ``jnp.einsum`` was split into (the recurrent mixers'
    decay and gate scalings, rwkv6's ``kv`` and mamba2's ``outer`` in
    decode): the port multiplies those elementwise, which
    ``FlopCounterMode`` does not count."""
    jaxpr = getattr(jaxpr, "jaxpr", jaxpr)
    canon: dict = {}      # var -> the first var of its value
    seen: dict = {}       # (primitive, params, operands) -> its outvars
    total = 0

    def operand(v):
        if isinstance(v, jcore.Literal):
            return ("literal", repr(v.val), str(v.aval))
        return canon.get(v, v)

    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        key = (name, repr(sorted(eqn.params.items(), key=lambda kv: kv[0])),
               tuple(operand(v) for v in eqn.invars))
        if key in seen:
            for v, first in zip(eqn.outvars, seen[key]):
                canon[v] = first
            continue
        seen[key] = [canon.get(v, v) for v in eqn.outvars]
        if name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            if lc:
                total += 2 * math.prod(eqn.outvars[0].aval.shape) \
                    * math.prod(lhs[d] for d in lc)
            continue
        assert name not in ("while", "cond"), name
        times = eqn.params["length"] if name == "scan" else 1
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, (jcore.Jaxpr, jcore.ClosedJaxpr)):
                    total += times * _dot_flops(sub)
    return total


def _port_flops(fn) -> int:
    with FlopCounterMode(display=False) as flops:
        fn()
    return flops.get_total_flops()


def _serve_inputs(cfg, rng):
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT), np.int32)
    batch = {"tokens": tokens}
    if cfg.frontend == "vision_stub":
        batch["image_embeds"] = rng.standard_normal(
            (BATCH, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return batch, tokens[:, :1]


def _rwkv6_summed_products(cfg, batch: int, s: int) -> int:
    """The FLOPs of the two contractions of rwkv6's chunked prefill that
    the port computes as products and sums (``src/repro_torch/models/
    rwkv6.py:99-106``) where the reference contracts with ``jnp.einsum``
    (``src/repro/models/rwkv6.py:103,105``): per chunk and layer, ``att``'s
    sum over K of [b,i,j,h,K] and ``diag``'s of [b,i,h,K]."""
    c, k = cfg.ssm_chunk, cfg.ssm_head_dim
    h = cfg.d_model // k
    return cfg.n_layers * (s // c) * (2 * batch * c * c * h * k
                                      + 2 * batch * c * h * k)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_serving_flops_match_the_reference_dots(family):
    jcfg, cfg = _family_cfgs(family)
    batch, tok = _serve_inputs(cfg, np.random.default_rng(0))
    params, _ = jinit_params(jax.random.PRNGKey(0), jcfg)
    jcache = jinit_decode_state(jcfg, BATCH, MAX_LEN)
    want_prefill = _dot_flops(jax.make_jaxpr(
        lambda p, b, c: jprefill(p, jcfg, b, c))(params, batch, jcache))
    want_decode = _dot_flops(jax.make_jaxpr(
        lambda p, t, c: jdecode_step(p, jcfg, t, c))(params, tok, jcache))

    model = tm.init_params(cfg, seed=0, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    cache = tm.init_decode_state(cfg, BATCH, MAX_LEN, device="cpu")
    if family == "rwkv6":
        want_prefill -= _rwkv6_summed_products(cfg, BATCH, PROMPT)
    assert _port_flops(lambda: tm.prefill(model, cfg, tbatch, cache)) \
        == want_prefill
    assert _port_flops(lambda: tm.decode_step(
        model, cfg, torch.from_numpy(tok), cache)) == want_decode
    assert want_prefill > 0 and want_decode > 0


def test_run_cell_decode_32k_at_full_width():
    """smollm-135m's ``decode_32k`` on (16, 16), traced on rank 0 of the
    placed serving (``"scope": "rank"``): the record's keys, its per-rank
    argument bytes from the placements, a peak a rank under the card's
    80 GB and above the arguments, FLOPs a rank 1/256 of the reference's
    dots at full width (abstract inputs: every product is cut 16 ways over
    the batch and 16 over "model"), and collectives: the scores' sums over
    the head dim's blocks (an all-reduce a layer) and the weights' gathers
    along "data"."""
    rec = dr.run_cell("smollm-135m", "decode_32k", False, verbose=False)
    assert {"arch", "shape", "mesh", "devices", "trace_s", "flops", "scope",
            "collective_bytes", "collective_ops", "memory"} <= set(rec)
    assert (rec["mesh"], rec["devices"], rec["scope"]) == ("16x16", 256,
                                                           "rank")
    assert set(rec["collective_bytes"]) == set(dr.KINDS)
    assert rec["collective_ops"]["all-reduce"] >= get_config(
        "smollm-135m").n_layers
    assert rec["collective_ops"]["all-gather"] > 0
    with dr.fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        args = dr.argument_bytes(get_config("smollm-135m"),
                                 SHAPES["decode_32k"], mesh)
    mem = rec["memory"]
    assert mem["argument_bytes"] == args["total"]
    assert (mem["params_bytes"], mem["cache_bytes"], mem["batch_bytes"]) \
        == (args["params"], args["cache"], args["batch"])
    assert mem["argument_bytes"] < mem["peak_bytes"] < dr.DEVICE_BYTES

    jcfg = jget_config("smollm-135m")
    cell = SHAPES["decode_32k"]
    pshapes, _ = jabstract_params(jcfg, dtype=jnp.bfloat16)
    cshapes, _ = jabstract_cache(jcfg, cell.global_batch, cell.seq_len)
    tok = jax.ShapeDtypeStruct((cell.global_batch, 1), jnp.int32)
    assert rec["flops"] * 256 == _dot_flops(jax.make_jaxpr(
        lambda p, t, c: jdecode_step(p, jcfg, t, c))(pshapes, tok, cshapes))


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_smoke_serving_cell_traced_per_rank(kind):
    """qwen3-smoke's serving cell on an 8-rank fake (2, 2, 2) mesh, traced
    on rank 0 of the placed serving: its FLOPs a rank at most 1/4 of the
    whole cell's (``_serve_trace``, one fake device), its peak below the
    whole cell's, its argument bytes the placements', and collectives
    issued (the whole-cell trace has none)."""
    cfg = get_smoke_config("qwen3-14b")
    cell = ShapeCell("smoke", 64, 8, kind)
    with dr.fake_world(8):
        mesh = make_auto_mesh((2, 2, 2), ("pod", "data", "model"),
                              device_type="cpu")
        rec = dr.lower_prefill_cell(cfg, cell, mesh)
        args = dr.argument_bytes(cfg, cell, mesh)
    whole = dr._serve_trace(cfg, cell)
    assert rec["scope"] == "rank"
    assert 0 < rec["flops"] * 4 <= whole["flops"]
    assert rec["memory"]["argument_bytes"] == args["total"]
    assert 0 < rec["memory"]["peak_bytes"] < whole["memory"]["peak_bytes"]
    assert sum(rec["collective_ops"].values()) > 0
    assert not any(whole["collective_ops"].values())


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "mixtral-8x22b"])
def test_moe_smoke_serving_cell_traced_per_rank(arch, kind):
    """A MoE smoke config's serving cell (8 rows, 4 row blocks) on an
    8-rank fake (2, 2, 2) mesh, traced on rank 0 of the placed serving,
    held as the dense one above, and its collectives: one ``allreduce_``
    of the ``[blocks, e]`` int32 count table a MoE layer (its only
    ``allreduce_``), and the dispatch's reduce-scatters and the
    combine's gathers."""
    cfg = get_smoke_config(arch)
    cell = ShapeCell("smoke", 64, 8, kind)
    with dr.fake_world(8):
        mesh = make_auto_mesh((2, 2, 2), ("pod", "data", "model"),
                              device_type="cpu")
        rec = dr.lower_prefill_cell(cfg, cell, mesh)
        args = dr.argument_bytes(cfg, cell, mesh)
    whole = dr._serve_trace(cfg, cell)
    assert rec["scope"] == "rank"
    assert 0 < rec["flops"] * 4 <= whole["flops"]
    assert rec["memory"]["argument_bytes"] == args["total"]
    assert 0 < rec["memory"]["peak_bytes"] < whole["memory"]["peak_bytes"]
    by_name = rec["collective_ops_by_name"]
    assert by_name["allreduce_"] == cfg.n_layers
    assert by_name["reduce_scatter_tensor"] >= cfg.n_layers
    assert rec["collective_ops"]["all-gather"] >= 2 * cfg.n_layers
    assert not any(whole["collective_ops"].values())


# a dense, a MoE and a recurrent step (every family's serving FLOPs are
# held above)
@pytest.mark.parametrize("family", ["dense", "moe", "rwkv6"])
def test_one_rank_trace_flops_match_a_real_cpu_step(family):
    _, cfg = _family_cfgs(family)
    cell = ShapeCell("smoke", 8 + (cfg.num_patches if cfg.frontend
                                   == "vision_stub" else 0), 2, "train",
                     microbatch=1)
    with dr.fake_world(1):
        mesh = make_auto_mesh((1, 1), ("data", "model"), device_type="cpu")
        traced = dr.lower_train_cell(cfg, cell, mesh)
        want = _expected_collectives(cfg, cell, mesh)
    # one-rank sums only: a size-1 mesh dim gathers nothing (and DTensor
    # moves nothing along one)
    assert traced["collective_ops"] == want.pop("ops")
    assert traced["collective_bytes"] == want
    assert want["all-gather"] == 0
    if family == "dense":
        assert not any(want.values())

    rng = np.random.default_rng(0)
    batch = {}
    for k, x in input_specs(cfg, cell).items():
        v = (rng.integers(0, cfg.vocab_size, tuple(x.shape))
             if x.dtype == torch.int32
             else rng.standard_normal(tuple(x.shape)))
        batch[k] = torch.from_numpy(v).to(x.dtype)
    state = tt.init_train_state(tm.init_params(cfg, seed=0, device="cpu"))
    step = tt.build_train_step(cfg, microbatches=cell.global_batch,
                               remat="full")
    assert _port_flops(lambda: step(state, batch)) == traced["flops"] > 0


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------
def _expected_collectives(cfg, cell, mesh) -> dict:
    """The mesh step's collectives: the dense step's
    (``_tp_step_collectives``) or the gather path's."""
    if cfg.family in tstep.TP_FAMILIES:
        return _tp_step_collectives(cfg, cell, mesh)
    return _gather_step_collectives(cfg, cell, mesh)


def _gather_step_collectives(cfg, cell, mesh) -> dict:
    """The gather path's collectives (every family but ``TP_FAMILIES``)
    from the placements and the microbatch count: each weight gathered
    whole, one ``all_gather_into_tensor`` a run
    of adjacent mesh dims that shard the same tensor dim (DTensor gathers
    such a run over its flattened group at once), innermost run first,
    each output the block grown by the runs gathered so far (a run of size
    1 moves nothing and issues none); then, where the batch axes cut a
    microbatch's rows (even into one block), one ``allreduce_`` of its
    token count (4 B) a microbatch, one of each weight's float32 gradient
    and one of the three summed losses (four for MoE: its load-balance
    share).  A MoE model whose rows are cut into ``n > 1`` blocks adds,
    for each MoE layer and microbatch, one ``allreduce_`` of the
    ``[n, experts]`` int32 count table in the forward and one in the
    block's recomputation (``remat="full"``)."""
    from repro_torch.distributed.sharding import (
        mesh_sizes,
        spec_axes,
        use_mesh,
    )
    from repro_torch.launch.inputs import state_shardings
    from repro_torch.training.step import microbatch_specs

    micro = cell.global_batch // cell.microbatch
    sizes = list(mesh.shape)
    by_name = param_shardings(LM(cfg, "meta"), state_shardings(cfg, mesh)[0])
    weights = dict(LM(cfg, "meta").named_parameters())
    out = dict.fromkeys(dr.KINDS, 0)
    ops = dict.fromkeys(dr.KINDS, 0)
    for name, sh in by_name.items():
        block = dr.block_bytes(tuple(weights[name].shape), torch.float32, sh)
        runs: list[list] = []          # [placement, size], mesh order
        for p, n in zip(sh.placements, sizes):
            if runs and not p.is_replicate() and p == runs[-1][0]:
                runs[-1][1] *= n
            else:
                runs.append([p, n])
        for p, n in reversed(runs):
            if p.is_replicate() or n == 1:
                continue
            block *= n
            out["all-gather"] += block
            ops["all-gather"] += 1
    with use_mesh(mesh):
        spec = microbatch_specs(input_specs(cfg, cell), micro)
    axes = spec_axes(spec["tokens"][0])
    if axes:
        losses = 4 if cfg.family == "moe" else 3
        out["all-reduce"] = 4 * micro + 4 * sum(
            w.numel() for w in weights.values()) + 4 * losses
        ops["all-reduce"] = micro + len(weights) + 1
    blocks = math.prod(mesh_sizes(mesh)[a] for a in axes)
    if cfg.family == "moe" and blocks > 1:
        n = 2 * micro * cfg.n_layers
        out["all-reduce"] += n * blocks * cfg.n_experts * 4
        ops["all-reduce"] += n
    out["ops"] = ops
    return out


def _steps_collectives(cur, target, nbytes: int, sizes: list) -> tuple:
    """The collectives of ``sharding._steps`` moving a DTensor whose local
    block is ``nbytes`` from placements ``cur`` to ``target`` (mesh dims of
    ``sizes``): its partial sums, outermost first (a reduce-scatter onto a
    cut, else an all-reduce), its local cuts, then its gathers, innermost
    first; a mesh dim of size 1 moves nothing.  Returns ``([(kind,
    bytes)], the block's bytes after)``."""
    cur = list(cur)
    n = len(cur)
    order = ([i for i in range(n) if cur[i].is_partial()]
             + [i for i in range(n) if cur[i].is_replicate()
                and target[i].is_shard()]
             + [i for i in reversed(range(n)) if cur[i].is_shard()
                and target[i].is_replicate()])
    out = []
    for i in order:
        if cur[i] == target[i] or sizes[i] == 1:
            cur[i] = target[i]
            continue
        if cur[i].is_partial() and target[i].is_replicate():
            out.append(("all-reduce", nbytes))
        elif cur[i].is_partial():
            nbytes //= sizes[i]
            out.append(("reduce-scatter", nbytes))
        elif cur[i].is_replicate():
            nbytes //= sizes[i]
        else:
            nbytes *= sizes[i]
            out.append(("all-gather", nbytes))
        cur[i] = target[i]
    assert tuple(cur) == tuple(target), (cur, target)
    return out, nbytes


def _moe_layer(cfg, cell, mesh, rows_spec) -> dict:
    """The placements of one MoE layer's buffers (``models.moe
    ._placed_moe``) and the collectives of its dispatch and combine, from
    the shapes: the ``[e, cap, d]`` buffer's expert placement ``B``, the
    experts' output ``O`` (a partial sum where "model" cuts ``d_ff``),
    and the dispatch (its partial buffer onto ``B``) and combine (``O``
    onto whole rows, ``d`` cut as the tokens are) with their backwards,
    as ``_steps_collectives`` lists."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.distributed.sharding import (
        placements,
        resolve_spec,
        use_mesh,
    )
    from repro_torch.models.moe import _capacity
    names = list(mesh.mesh_dim_names)
    sizes = [int(n) for n in mesh.shape]
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    cap = _capacity(cfg, cell.microbatch * cell.seq_len)
    c = torch.empty((), dtype=cfg.compute_dtype).element_size()
    with use_mesh(mesh):
        B = placements(resolve_spec((e, cap, d), ("experts", None,
                                                  "act_embed")), mesh)
        wi = placements(resolve_spec((e, d, f), ("experts", None,
                                                 "expert_mlp")), mesh)
        d_axes = dr.spec_axes(resolve_spec((d,), ("dispatch_embed",))[0])
    rows = dr.spec_axes(rows_spec)
    O = tuple(b if b.is_shard() else Partial() if w.is_shard(2)
              else Replicate() for b, w in zip(B, wi))
    cut = math.prod(n for b, n in zip(B, sizes) if b.is_shard())
    m_d = math.prod(n for a, n in zip(names, sizes) if a in d_axes)
    start = tuple(Partial() if a in rows else Shard(2) if a in d_axes
                  else Replicate() for a in names)
    whole_rows = tuple(Shard(2) if a in d_axes else Replicate()
                       for a in names)
    grad_rows = tuple(Partial() if a in rows else p
                      for a, p in zip(names, whole_rows))
    grad_buf = tuple(Partial() if b.is_replicate() and o.is_partial() else b
                     for b, o in zip(B, O))
    unpartial = [Replicate() if p.is_partial() else p for p in start], \
        [Replicate() if p.is_partial() else p for p in O]
    buf, blk = e * cap * d // m_d * c, e * cap * d // cut * c
    fwd = _steps_collectives(start, B, buf, sizes)[0] \
        + _steps_collectives(O, whole_rows, blk, sizes)[0]
    bwd = _steps_collectives(grad_rows, unpartial[1], buf, sizes)[0] \
        + _steps_collectives(grad_buf, unpartial[0], blk, sizes)[0]
    return {"B": B, "cap": cap, "fwd": fwd, "bwd": bwd}


def _tp_step_collectives(cfg, cell, mesh) -> dict:
    """The dense and MoE mesh step's collectives (``remat="full"``, a
    tokens-only model whose sequence and projections divide by "model"),
    worked out from the placements and the shapes.  A collective along a
    mesh dim of size 1 is none; a move of a shard from one tensor dim to
    another is an all-to-all of the block (``a2a`` below; the dry run traces the
    card's route).  Per microbatch of R rows a rank, sequence s, compute
    dtype of c bytes:

      * weights: each use (each block's weights twice: the forward and its
        recomputation) gathers the weight's "model" block along the
        data-parallel axes in one all-gather (the embedding in float32,
        the others cast first); the backward reduce-scatters the use's
        gradient along each of those axes in turn, outermost first; a
        replicated weight (the norms) all-reduces its gradient along every
        mesh dim that cuts the activations;
      * activations, on "model": the residual stream [R, s/m, d] is
        gathered into each block's attention and MLP (and the head) and
        their partial outputs reduce-scattered back; the projections'
        ``("batch", "seq", "heads_fused")`` point and the MLP hidden's
        ``("batch", "seq", "mlp")`` move their outputs from the cut heads
        (or hidden dim) to the cut sequence, and the MLP's and the output
        projection's products move them back; the scores' point cuts the
        KV heads (q, k and v moved there) where they divide by "model",
        else the query positions (k and v gathered); the logits move from
        the cut vocabulary to the cut sequence.  The backward mirrors
        each move (a gather's is a reduce-scatter and back, a move's a
        move).  The recomputation stops after the block's last op that
        saves a tensor, before the MLP's reduce-scatter;
      * the loss: the token count summed over the row-cutting axes for the
        denominator and for its metric, the loss made whole over every
        cutting axis, and the last microbatch's ``ce`` and ``zloss`` too
        (one all-reduce a mesh dim, the data-parallel axes' flattened group
        in one where exactly they are summed over);
      * the gradient norm: one ``allreduce_`` a mesh dim of the squares of
        the leaves it cuts.

    A MoE block's attention is the dense block's; its MoE layer
    (``_moe_layer``) in place of the MLP: the residual gathered along
    "model" (the second block input above); the router weight used as a
    dense weight, its gradient reduce-scattered along the axes that cut
    the rows; the expert weights gathered along the data-parallel axes
    that do not cut their expert dim, their gradients reduce-scattered
    along those that cut the buffer's capacity; where the rows are cut
    into ``n > 1`` blocks, the ``[n, e]`` int32 count table all-reduced
    in each pass; the dispatch and the combine; the output moved from
    ``d`` to the sequence (in the recomputation too: the layer's aux
    values come last, so it runs all of the layer); in the backward that
    move mirrored, the tokens' ``d`` gradient gathered along "model" and
    the gate's gradient [R·s, k] float32 all-reduced over it; the shared expert (Moonlight) as the
    dense MLP without its input gather (it reads the gathered rows),
    whose partial gradient the rows' gather reduce-scatters; and the
    ``load_balance`` metric summed over the rows' axes."""
    from repro_torch.distributed.sharding import resolve_spec, use_mesh
    from repro_torch.launch.inputs import state_shardings
    from repro_torch.training.step import microbatch_specs

    micro = cell.global_batch // cell.microbatch
    sizes = dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))
    names = list(mesh.mesh_dim_names)
    m = sizes.get("model", 1)
    data = [a for a in names if a in ("pod", "data") and sizes[a] > 1]
    with use_mesh(mesh):
        spec = microbatch_specs(input_specs(cfg, cell), micro)["tokens"]
        rows_axes = [a for a in dr.spec_axes(spec[0]) if sizes[a] > 1]
        scores = resolve_spec(
            (cell.microbatch, cfg.n_kv_heads,
             cfg.n_heads // cfg.n_kv_heads, cell.seq_len, cell.seq_len),
            ("batch", "kv_heads", None, "q_seq", None))
    r = cell.microbatch // math.prod(sizes[a] for a in rows_axes)
    s, d, V, ff = cell.seq_len, cfg.d_model, cfg.vocab_size, cfg.d_ff
    q_w, kv_w = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    c = torch.empty((), dtype=cfg.compute_dtype).element_size()
    out = dict.fromkeys(dr.KINDS, 0)
    ops = dict.fromkeys(dr.KINDS, 0)

    def add(kind, nbytes, n=1):
        out[kind] += n * nbytes
        ops[kind] += n

    def a2a(nbytes, n=1):
        """A move of a tensor of ``nbytes`` bytes between two of its
        dims cut along "model": each rank's block in, its new block out."""
        add("all-to-all", nbytes // m, n)

    def summed(axes, nbytes, n=1):
        """A partial sum over ``axes`` made whole."""
        live = [a for a in axes if sizes[a] > 1]
        k = 1 if len(data) > 1 and live == data else len(live)
        add("all-reduce", nbytes, n * k)

    moe = _moe_layer(cfg, cell, mesh, spec[0]) if cfg.family == "moe" \
        else None
    by_name = param_shardings(LM(cfg, "meta"), state_shardings(cfg, mesh)[0])
    weights = dict(LM(cfg, "meta").named_parameters())
    cut_axes = {}
    for name, sh in by_name.items():
        cut_axes[name] = [a for a, p in zip(names, sh.placements)
                          if not p.is_replicate() and sizes[a] > 1]
        w = weights[name]
        if w.dim() == 1:                     # a norm, replicated
            summed(rows_axes + (["model"] if m > 1 else []),
                   4 * w.numel(), micro)
            continue
        block = w.numel() // (m if "model" in cut_axes[name] else 1)
        nbytes = 4 if name == "embed.embedding" else c
        uses = 2 if name.startswith("layers.") else 1
        gathered = [a for a in data if a in cut_axes[name]]
        scattered = gathered
        if moe is not None and name.split(".")[-2:-1] == ["mlp"] \
                and w.dim() == 3:            # an expert weight
            experts = [a for a, p in zip(names, sh.placements)
                       if p.is_shard(0) and sizes[a] > 1]
            block //= math.prod(sizes[a] for a in experts)
            gathered = [a for a in gathered if a not in experts]
            scattered = [a for a in gathered if moe["B"][
                names.index(a)].is_shard(1)]
        elif name.endswith("mlp.router"):
            scattered = [a for a in gathered if a in rows_axes]
        if gathered:
            add("all-gather", block * nbytes, uses * micro)
        for a in scattered:
            block //= sizes[a]
            add("reduce-scatter", block * nbytes, micro)

    if moe is not None:
        blocks = math.prod(sizes[a] for a in rows_axes)
        for _ in range(cfg.n_layers):
            if blocks > 1:
                add("all-reduce", blocks * cfg.n_experts * 4, 2 * micro)
            for kind, nbytes in 2 * moe["fwd"] + moe["bwd"]:
                add(kind, nbytes, micro)

    if m > 1:
        assert cfg.frontend == "tokens" and s % m == 0
        assert all("model" in cut_axes[f"layers.0.attn.{w}"]
                   for w in ("wq", "wk", "wv", "wo"))
        heads_cut = scores[1] == "model"
        assert heads_cut or scores[3] == "model"
        res, res_m = r * s * d * c, r * s // m * d * c
        qb, kvb = r * s * q_w * c, r * s * kv_w * c
        fb = r * s * ff * c
        shared = cfg.n_shared_experts
        sb = fb * shared

        def qkv(n):
            a2a(qb, n)
            a2a(kvb, 2 * n)

        # the embedding's partial rows into the residual, and back
        add("reduce-scatter", r * s // m * d * 4, micro)
        add("all-gather", r * s * d * 4, micro)
        for _ in range(cfg.n_layers):
            for recompute in (False, True):
                add("all-gather", res, 2 * micro)          # block inputs
                qkv(micro)                                 # their points
                if heads_cut:
                    qkv(micro)
                else:
                    add("all-gather", kvb, 2 * micro)      # k, v whole
                    a2a(qb, micro)                         # out → heads
                if moe is None:
                    a2a(fb, 2 * micro)                     # mlp point
                    add("reduce-scatter", res_m,
                        (1 if recompute else 2) * micro)
                    continue
                # (the aux values come last: the recomputation runs the
                # whole layer)
                add("reduce-scatter", res_m, micro)        # attention out
                a2a(res, micro)                            # moe out → seq
                if shared:
                    a2a(sb, 2 * micro)                     # its mlp point
                    add("reduce-scatter", res_m, micro)
            # the backward
            if moe is None:
                add("reduce-scatter", res_m, 2 * micro)
                add("all-gather", res, 2 * micro)
                a2a(fb, 2 * micro)
            else:
                add("reduce-scatter", res_m, (1 + bool(shared)) * micro)
                add("all-gather", res, (2 + bool(shared)) * micro)
                a2a(res, micro)
                add("all-reduce", r * s * cfg.top_k * 4, micro)   # gate
                if shared:
                    a2a(sb, 2 * micro)
            qkv(micro)
            if heads_cut:
                qkv(micro)
            else:
                add("reduce-scatter", r * s // m * kv_w * c, 2 * micro)
                a2a(qb, micro)
        # the head: its input gathered, the logits moved; and back
        add("all-gather", res, micro)
        a2a(r * s * V * c, 2 * micro)
        add("reduce-scatter", res_m, micro)
    loss_axes = rows_axes + (["model"] if m > 1 else [])
    summed(rows_axes, 4, 2 * micro + (moe is not None))
    summed(loss_axes, 4, micro + 2)
    for a in names:
        n = sum(a in cut for cut in cut_axes.values())
        if n:
            add("all-reduce", 4 * n)
    out["ops"] = ops
    return out


# (4, 2): qwen3-smoke's 2 KV heads take "model" (the scores' point cuts
# the heads); on the others the query positions do.  The MoE step's rows
# are cut into 2, 32 and 4 blocks
@pytest.mark.parametrize("family", ["dense", "rwkv6", "moe"])
@pytest.mark.parametrize("shape,axes", [SMOKE_MESH, ((2, 16, 16), (
    "pod", "data", "model")), ((4, 2), ("data", "model"))],
    ids=["8", "512", "8-heads"])
def test_mesh_step_collectives_follow_the_placements(shape, axes, family):
    cfg = get_smoke_config(SMOKE_ARCH if family == "dense"
                           else FAMILIES[family])
    assert cfg.family == family
    with dr.fake_world(math.prod(shape)):
        mesh = make_auto_mesh(shape, axes, device_type="cpu")
        got = dr.lower_train_cell(cfg, SMOKE_CELL, mesh)
        want = _expected_collectives(cfg, SMOKE_CELL, mesh)
    assert got["collective_ops"] == want.pop("ops")
    assert got["collective_bytes"] == want
    assert got["collective_ops"]["all-gather"] > 0
    assert got["collective_ops"]["all-reduce"] > 2
    if family == "dense":
        assert got["collective_ops"]["reduce-scatter"] > 0


DENSE_ARCHS = [a for a in ARCHS if get_smoke_config(a).family == "dense"]


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_train_cell_peak_is_below_the_data_parallel_steps(
        arch, monkeypatch):
    """The smoke train cell on the (2, 16, 16) production mesh: each rank's
    peak under the dense step below the same cell's under the gather path
    (``TP_FAMILIES`` emptied), which gathers every weight whole and keeps a
    whole float32 gradient accumulator."""
    cfg = get_smoke_config(arch)
    peaks = {}
    for tag, families in (("tp", tstep.TP_FAMILIES), ("dp", ())):
        monkeypatch.setattr(tstep, "TP_FAMILIES", families)
        with dr.fake_world(512):
            mesh = make_production_mesh(multi_pod=True, device_type="cpu")
            peaks[tag] = dr.lower_train_cell(
                cfg, SMOKE_CELL, mesh)["memory"]["peak_bytes"]
    assert 0 < peaks["tp"] < peaks["dp"], peaks


MOE_ARCHS = [a for a in ARCHS if get_smoke_config(a).family == "moe"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_cell_peak_is_below_the_gather_paths(arch, monkeypatch):
    """The smoke train cell on the 8-rank (2, 4) mesh: each rank's peak
    with the experts on their placed blocks below the same cell's on the
    gather path (``TP_FAMILIES`` emptied: whole weights, a whole float32
    gradient accumulator and the whole ``[e, cap]`` buffer's experts)."""
    cfg = get_smoke_config(arch)
    assert cfg.family in tstep.TP_FAMILIES
    peaks = {}
    for tag, families in (("ep", tstep.TP_FAMILIES), ("dp", ())):
        monkeypatch.setattr(tstep, "TP_FAMILIES", families)
        with dr.fake_world(8):
            mesh = make_auto_mesh(*SMOKE_MESH, device_type="cpu")
            peaks[tag] = dr.lower_train_cell(
                cfg, SMOKE_CELL, mesh)["memory"]["peak_bytes"]
    assert 0 < peaks["ep"] < peaks["dp"], peaks


# --------------------------------------------------------------------------
# the collective recorder and the fake world
# --------------------------------------------------------------------------
def test_collectives_are_recorded_by_kind_and_an_unknown_one_fails():
    with dr.fake_world(4):
        with dr.CollectiveMode() as comm:
            torch.distributed.all_reduce(torch.ones(3))
        assert dr.collective_bytes(comm.records) == {
            **dict.fromkeys(dr.KINDS, 0), "all-reduce": 12,
            "ops": {**dict.fromkeys(dr.KINDS, 0), "all-reduce": 1}}
        with pytest.raises(NotImplementedError, match="has no kind"):
            with dr.CollectiveMode():
                torch.distributed.broadcast(torch.ones(3), 0)


def test_fake_world_refuses_a_live_group():
    with dr.fake_world(4):
        with pytest.raises(RuntimeError, match="already initialised"):
            with dr.fake_world(2):
                pass
    assert not torch.distributed.is_initialized()


if __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    _jax_side(Path(sys.argv[2]))
