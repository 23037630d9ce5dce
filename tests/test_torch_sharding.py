"""The logical sharding rules: ``repro_torch.distributed.sharding`` and
``repro_torch.launch.{inputs,mesh}`` against the JAX package's, exactly.

``resolve_spec`` reads only a mesh's axis names and sizes, so both sides
run here with no devices and no process group: the reference on
``jax.sharding.AbstractMesh(sizes, names)``, the port on a stand-in with
``mesh_dim_names`` and ``shape``.  Held exactly (the spec's entries, axis
for axis):

  * every leaf of every arch's full config on the meshes (16,16),
    (2,16,16), (2,2,2), (4,2), (8,1) and (1,1), under the default rules
    and under ``axis_rules`` overrides;
  * a hypothesis property over random shapes and logical-axis tuples;
  * ``param_specs`` against the spec half of the reference's
    ``init_params`` (full and smoke configs);
  * ``input_specs`` and ``batch_shardings`` on every ``SHAPES`` cell.

Also here, in this process: ``CompressedPsum`` at world size 1 (a one-rank
``gloo`` group) against the reference's inside ``shard_map`` (the sum
bitwise; the residual within one rounding, since XLA fuses its
multiply-subtract), and the meshes' refusals.  Each rank's block of a placed state, the mesh train
step and the collectives at 2–8 ranks are
``tests/test_torch_distributed_lm.py``'s.
"""

import datetime
import functools
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import AbstractMesh

import repro.distributed.sharding as jsh
import repro_torch.distributed.sharding as tsh
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.launch import inputs as jinputs
from repro_torch.configs import ARCHS, SHAPES, get_config, get_smoke_config
from repro_torch.launch import inputs as tinputs
from repro_torch.models import param_specs

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "8x1": ((8, 1), ("data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}
# rule overrides: embed over the axes in the reverse of mesh order (a dim
# split over ("data", "pod")), and heads/mlp replicated so that "model"
# moves onto other dims
OVERRIDES = {
    "default": {},
    "embed-data-pod": {"embed": ("data", "pod")},
    "no-tensor": {"heads_fused": None, "mlp": None, "vocab": None},
    "experts-model": {"experts": ("model", "data"), "expert_mlp": None},
}


def _meshes(name):
    sizes, names = MESHES[name]
    return (AbstractMesh(sizes, names),
            SimpleNamespace(mesh_dim_names=names, shape=sizes))


def _norm(spec) -> tuple:
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in spec)


def _both(jmesh, tmesh, shape, axes, rules=None):
    jrules = None if rules is None else {**jsh.LOGICAL_RULES, **rules}
    trules = None if rules is None else {**tsh.LOGICAL_RULES, **rules}
    with jsh.use_mesh(jmesh, jrules):
        want = _norm(jsh.resolve_spec(shape, axes))
    with tsh.use_mesh(tmesh, trules):
        got = tsh.resolve_spec(shape, axes)
    return want, got


def _leaves(specs, shapes, prefix=()):
    for k, v in specs.items():
        if isinstance(v, dict):
            yield from _leaves(v, shapes[k], prefix + (k,))
        else:
            yield prefix + (k,), v, tuple(shapes[k].shape)


@functools.lru_cache(maxsize=None)
def _full_leaves(arch) -> tuple:
    """(path, logical axes, shape) of every leaf of ``arch``'s full
    config."""
    shapes, specs = tinputs.abstract_params(get_config(arch))
    return tuple(_leaves(specs, shapes))


def test_the_rule_tables_are_the_reference_tables():
    assert tsh.LOGICAL_RULES == jsh.LOGICAL_RULES
    assert tsh.SECONDARY_RULES == jsh.SECONDARY_RULES


@pytest.mark.parametrize("rules", list(OVERRIDES))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_spec_matches_the_reference_on_every_leaf(arch, mesh, rules):
    jmesh, tmesh = _meshes(mesh)
    n = 0
    for path, axes, shape in _full_leaves(arch):
        for dims in (shape, None):      # None: no divisibility checks
            want, got = _both(jmesh, tmesh, dims, axes,
                              OVERRIDES[rules] or None)
            assert got == want, (path, dims, axes)
        n += 1
    assert n >= 10


def test_some_override_lists_axes_out_of_mesh_order():
    """The out-of-order case ``placements`` must account for is reached."""
    jmesh, tmesh = _meshes("2x2x2")
    want, got = _both(jmesh, tmesh, (64, 128), ("embed", "heads_fused"),
                      OVERRIDES["embed-data-pod"])
    assert got == want == (("data", "pod"), "model")


def test_axis_rules_nest_and_restore():
    _, tmesh = _meshes("4x2")
    with tsh.use_mesh(tmesh):
        assert tsh.logical_spec("embed", "mlp", shape=(8, 8)) == ("data",
                                                                  "model")
        with tsh.axis_rules(mlp=None):
            assert tsh.logical_spec("embed", "mlp", shape=(8, 8)) == (
                "data", None)
        assert tsh.current_rules() is tsh.LOGICAL_RULES
    assert tsh.current_mesh() is None
    assert tsh.logical_spec("embed", "mlp") == (None, None)


_AXES = st.sampled_from([None, *sorted(tsh.LOGICAL_RULES)])
_DIMS = st.sampled_from([1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 120])


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(mesh=st.sampled_from(sorted(MESHES)),
       dims=st.lists(st.tuples(_DIMS, _AXES), min_size=1, max_size=5),
       rules=st.sampled_from(sorted(OVERRIDES)))
def test_resolve_spec_property(mesh, dims, rules):
    jmesh, tmesh = _meshes(mesh)
    shape = tuple(d for d, _ in dims)
    axes = tuple(a for _, a in dims)
    want, got = _both(jmesh, tmesh, shape, axes, OVERRIDES[rules] or None)
    assert got == want


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_init_params(arch, smoke):
    jcfg = (jget_smoke if smoke else jget_config)(arch)
    tcfg = (get_smoke_config if smoke else get_config)(arch)
    jshapes, jspecs = jinputs.abstract_params(jcfg)
    tshapes, tspecs = tinputs.abstract_params(tcfg)
    assert tspecs == jspecs == param_specs(tcfg)
    flat = {p: (a, s) for p, a, s in _leaves(tspecs, tshapes)}
    jflat = {p: (a, s) for p, a, s in _leaves(jspecs, jshapes)}
    assert flat == jflat
    node = tshapes["embed"]["embedding"]
    assert node.is_meta and node.dtype == torch.float32


@pytest.mark.parametrize("mesh", ["2x16x16", "16x16", "2x2x2", "1x1"])
@pytest.mark.parametrize("cell", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_batch_shardings_match(arch, cell, mesh):
    jmesh, tmesh = _meshes(mesh)
    want = jinputs.input_specs(jget_config(arch), JSHAPES[cell])
    got = tinputs.input_specs(get_config(arch), SHAPES[cell])
    assert sorted(got) == sorted(want)
    for k, x in got.items():
        assert x.is_meta and tuple(x.shape) == tuple(want[k].shape)
        assert str(x.dtype).removeprefix("torch.") == str(want[k].dtype)
    jb = jinputs.batch_shardings(jmesh, want)
    tb = tinputs.batch_shardings(tmesh, got)
    assert {k: sh.spec for k, sh in tb.items()} == {
        k: _norm(sh.spec) for k, sh in jb.items()}


@pytest.mark.parametrize("mesh", ["2x2x2", "4x2", "1x1"])
def test_state_shardings_follow_the_parameters(mesh):
    _, tmesh = _meshes(mesh)
    cfg = get_smoke_config("qwen3-14b")
    params, (opt_step, m, v), step = tinputs.state_shardings(cfg, tmesh)
    shapes, specs = tinputs.abstract_params(cfg)
    assert m is params and v is params
    assert opt_step.spec == step.spec == ()
    with tsh.use_mesh(tmesh):
        for path, axes, shape in _leaves(specs, shapes):
            node = params
            for key in path:
                node = node[key]
            assert node.spec == tsh.resolve_spec(shape, axes)


@pytest.mark.parametrize("spec,mesh,want", [
    ((("pod", "data"), "model"), "2x2x2",
     ("Shard(dim=0)", "Shard(dim=0)", "Shard(dim=1)")),
    ((("data", "pod"), None), "2x2x2",
     ("_StridedShard(dim=0, sf=2)", "Shard(dim=0)", "Replicate()")),
    ((("model", "pod", "data"),), "2x2x2",
     ("_StridedShard(dim=0, sf=2)", "_StridedShard(dim=0, sf=2)",
      "Shard(dim=0)")),
    ((None, None), "4x2", ("Replicate()", "Replicate()")),
])
def test_placements(spec, mesh, want):
    _, tmesh = _meshes(mesh)
    assert tuple(repr(p) for p in tsh.placements(spec, tmesh)) == want


def test_local_block_cuts_jax_blocks():
    """Block ``c[a1]·s[a2] + c[a2]`` along a dim split over ``(a1, a2)``;
    held against JAX's shards at 2–8 ranks in the distributed LM test."""
    _, tmesh = _meshes("2x2x2")
    full = torch.arange(8 * 6).reshape(8, 6)
    # (data, pod) on dim 0: the rank at pod=1, data=0 takes block 0·2 + 1
    got = tsh.local_block(full, (("data", "pod"), "model"), tmesh, (1, 0, 1))
    assert torch.equal(got, full[2:4, 3:6])
    got = tsh.local_block(full, (("pod", "data"), None), tmesh, (1, 0, 1))
    assert torch.equal(got, full[4:6])
    with pytest.raises(ValueError, match="does not split"):
        tsh.local_block(full, (None, ("pod", "data", "model")), tmesh,
                        (0, 0, 0))


@pytest.mark.parametrize("mesh,batch,microbatches,want", [
    ("2x2x2", 8, 2, ("pod", "data")),
    ("2x2x2", 4, 2, ("pod",)),       # 2 rows: "data" computes the same rows
    ("16x16", 8, 1, ()),             # 8 rows on 16 batch shards
    ("8x1", 8, 2, ()),               # 4 rows on 8
    ("4x2", 8, 2, ("data",)),
    ("1x1", 8, 1, ("data",)),
])
def test_a_microbatch_is_cut_by_whole_rows(mesh, batch, microbatches, want):
    """The mesh step cuts only a microbatch's rows, along the batch axes
    that divide them; an axis they do not divide is never moved onto the
    sequence dim (each rank would take a slice of every row)."""
    from repro_torch.training.step import microbatch_specs

    _, tmesh = _meshes(mesh)
    tokens = torch.zeros(batch, 16, dtype=torch.int32)
    with tsh.use_mesh(tmesh):
        specs = microbatch_specs({"tokens": tokens, "labels": tokens,
                                  "image_embeds": torch.zeros(batch, 4, 8)},
                                 microbatches)
    for k, spec in specs.items():
        assert tsh.spec_axes(spec[0]) == want, k
        assert all(e is None for e in spec[1:]), (k, spec)
        assert len(spec) == (3 if k == "image_embeds" else 2)


def test_shard_is_the_identity_off_a_mesh():
    x = torch.ones(4, 4)
    assert tsh.shard(x, "batch", None) is x
    _, tmesh = _meshes("2x2x2")
    with tsh.use_mesh(tmesh):
        assert tsh.shard(x, "batch", None) is x      # not a DTensor


def test_production_meshes_need_their_ranks():
    from repro_torch.launch.mesh import make_production_mesh
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match=r"\(16, 16\) needs 256 ranks"):
        make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match=r"\(2, 16, 16\) needs 512 ranks"):
        make_production_mesh(multi_pod=True, device_type="cpu")


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank ``gloo`` default group in this process."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_compressed_psum_matches_the_reference_at_world_size_1(one_rank):
    """``tests/test_training.py``'s CompressedPsum test on the port, and
    bitwise against the reference's psum inside ``shard_map``."""
    from repro.core.distributed import _shard_map
    from repro.distributed.compression import CompressedPsum as JPsum
    from repro_torch.distributed import CompressedPsum
    g = np.random.default_rng(1).normal(size=(64,)).astype(np.float32)
    jmesh = jax.make_mesh((1,), ("pod",))
    jg = {"w": jnp.asarray(g)}
    jout, jres = jax.jit(_shard_map(
        lambda a, r: JPsum.psum(a, r, "pod"), mesh=jmesh,
        in_specs=(jax.sharding.PartitionSpec(),) * 2,
        out_specs=jax.sharding.PartitionSpec()))(jg, JPsum.init_state(jg))
    grads = {"w": torch.from_numpy(g)}
    res = CompressedPsum.init_state(grads)
    assert res["w"].dtype == torch.float32 and not res["w"].any()
    out, new_res = CompressedPsum.psum(grads, res)
    np.testing.assert_allclose(out["w"].numpy(), g, atol=2e-2)
    np.testing.assert_allclose((out["w"] + new_res["w"]).numpy(), g,
                               atol=1e-6)
    assert np.array_equal(out["w"].numpy(), np.asarray(jout["w"]))
    # XLA contracts the residual's g − q·scale into a fused multiply-add:
    # the two differ by at most one rounding of the product, |q·scale| < 4
    np.testing.assert_allclose(new_res["w"].numpy(), np.asarray(jres["w"]),
                               rtol=0, atol=np.spacing(np.float32(2)))
    # a second round replays the residual; trees of lists and tuples
    out2, res2 = CompressedPsum.psum([grads["w"], (grads["w"],)],
                                     [new_res["w"], (new_res["w"],)])
    assert isinstance(out2, list) and isinstance(out2[1], tuple)
    np.testing.assert_allclose((out2[0] + res2[0]).numpy(),
                               (grads["w"] + new_res["w"]).numpy(), atol=1e-6)


def test_a_cuda_mesh_over_gloo_is_refused(one_rank):
    from repro_torch.launch.mesh import make_auto_mesh, make_host_mesh
    with pytest.raises(RuntimeError, match="a cuda mesh needs NCCL"):
        make_auto_mesh((1,), ("data",))
    mesh = make_host_mesh("cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)


def test_sharding_modules_import_neither_jax_nor_the_reference():
    pat = re.compile(r"^\s*(import jax|from jax|import repro$|import repro\.|"
                     r"from repro(\.| ))", re.M)
    files = [*sorted((SRC / "distributed").glob("*.py")),
             *sorted((SRC / "launch").glob("*.py"))]
    assert {f.name for f in files} >= {"sharding.py", "compression.py",
                                       "mesh.py", "inputs.py", "train.py"}
    for f in files:
        assert not pat.search(f.read_text()), f
