"""The port's checkpointer and training launcher against the JAX package's,
on the CPU.

``repro_torch.checkpoint.Checkpointer`` writes the reference's format:
``step_<N>/manifest.json`` plus one ``.npy`` per leaf, a ``TrainState``
under the reference's positional keys (``0/...``, ``1/0``, ``1/1/...``,
``1/2/...``, ``2``) with ``layers/...`` stacked.  Held here:

  * ``tests/test_checkpoint.py``'s four tests on the port, with their
    assertions (crash/restore/resume bit-exact, async save, a torn
    ``.tmp`` ignored, restore onto a device: the CPU, from a state on the
    CPU or on ``meta``), and the refusal of another structure;
  * the files each package writes for the same state (every family's
    smoke config, float32 and bfloat16 moments, and a general tree of
    dicts, lists and tuples): the same names, manifest bytes and ``.npy``
    bytes;
  * each package resuming the other's step-3 checkpoint bitwise and
    running to step 6 within ``tests/test_torch_training.py``'s float32
    trajectory bounds of the other package's own six steps;
  * an in-place update right after ``save(async_=True)`` never reaching
    the files; bfloat16 moments round-tripping bitwise, and a
    reference-written bfloat16 checkpoint restoring in the port (the
    reference's own restore fails on it: ``ROADMAP.md`` R7);
  * ``python -m repro_torch.launch.train`` uninterrupted against a run
    whose last checkpoint is lost (a torn ``step_6.tmp`` in its place) and
    restarted: the final checkpoints are bitwise equal; ``--mesh single``
    and ``COORDINATOR_ADDRESS`` are refused;
  * neither module imports JAX or the JAX package.
"""

import dataclasses
import json
import re
import shutil
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_smoke_config as jsmoke
from repro.training import build_train_step as jbuild
from repro.training import init_train_state as jinit
from repro.training.optimizer import AdamWState as JAdamWState
from repro.training.step import TrainState as JTrainState
from repro_torch import models as tm
from repro_torch import training as tt
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint import checkpointer as ckpt_mod
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.data import TokenPipeline
from repro_torch.launch.train import main as train_main
from repro_torch.models import ModelConfig
from repro_torch.models.convert import (
    from_reference_params,
    split_reference,
    to_reference_params,
)
from repro_torch.training.optimizer import AdamWState

jax.config.update("jax_platform_name", "cpu")

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
# tests/test_torch_training.py's float32 trajectory bounds: every entry of
# the parameters within TRAJ_TOL, at most TRAJ_FAR entries beyond 1e-6
TRAJ_TOL = 1e-5
TRAJ_FAR = 4


def _equal_states(a, b):
    """Two port TrainStates bitwise equal, leaf by leaf."""
    assert torch.equal(a.step, b.step) and torch.equal(a.opt.step,
                                                       b.opt.step)
    for (n, x), (m, y) in zip(a.model.named_parameters(),
                              b.model.named_parameters()):
        assert n == m and x.dtype == y.dtype and torch.equal(x, y), n
    for part in ("m", "v"):
        xs, ys = getattr(a.opt, part), getattr(b.opt, part)
        assert list(xs) == list(ys)
        for n in xs:
            assert xs[n].dtype == ys[n].dtype, (part, n)
            assert torch.equal(xs[n], ys[n]), (part, n)


def _same_files(a: Path, b: Path):
    """Two checkpoint directories with the same names and bytes."""
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    assert "manifest.json" in names
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def _flat(tree):
    """A reference tree's leaves by path, as numpy arrays."""
    return {tuple(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py's four tests, on the port
# ---------------------------------------------------------------------------
def _mk(tmp_path, seed=0):
    cfg = dataclasses.replace(get_smoke_config("smollm-135m"),
                              dtype="float32")
    step = tt.build_train_step(cfg, base_lr=1e-2, warmup=2, total_steps=50,
                               remat="none")
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=16,
                         global_batch=4, seed=11)
    ckpt = Checkpointer(tmp_path / "ckpt")
    return cfg, _state(cfg, seed), step, pipe, ckpt


def _state(cfg, seed=0, device="cpu", **kw):
    return tt.init_train_state(tm.init_params(cfg, seed=seed,
                                              device=device), **kw)


def test_crash_restore_resume_is_bit_exact(tmp_path):
    cfg, s_ref, step, pipe, ckpt = _mk(tmp_path)

    # uninterrupted run: 6 steps (the step updates its state in place, so
    # the interrupted run starts from a second state of the same seed)
    for i in range(6):
        s_ref, _ = step(s_ref, pipe.torch_batch(i, "cpu"))

    # interrupted run: 3 steps, checkpoint, "crash", restore, 3 more
    s = _state(cfg)
    for i in range(3):
        s, _ = step(s, pipe.torch_batch(i, "cpu"))
    ckpt.save(3, s, async_=False)
    del s                                    # the crash
    like = _state(cfg)
    restored = ckpt.restore(like=like)
    assert int(restored.step) == 3
    assert restored.model is not like.model
    _equal_states(like, _state(cfg))         # like is left as it was
    s2 = restored
    for i in range(3, 6):                    # pipeline replays by step id
        s2, _ = step(s2, pipe.torch_batch(i, "cpu"))

    _equal_states(s_ref, s2)


def test_async_save_then_restore(tmp_path):
    _, s, step, pipe, ckpt = _mk(tmp_path)
    for i in range(2):
        s, _ = step(s, pipe.torch_batch(i, "cpu"))
        ckpt.save(i + 1, s, async_=True)   # overlaps next step
    ckpt.wait()
    assert ckpt.latest_step() == 2
    restored = ckpt.restore(like=s)
    assert int(restored.step) == 2
    _equal_states(restored, s)


def test_atomicity_tmp_dirs_ignored(tmp_path):
    _, state, _, _, ckpt = _mk(tmp_path)
    ckpt.save(1, state, async_=False)
    # a torn save must not be visible
    (tmp_path / "ckpt" / "step_9.tmp").mkdir()
    assert ckpt.latest_step() == 1


@pytest.mark.parametrize("like_device", ["cpu", "meta"])
def test_restore_onto_a_device(tmp_path, like_device):
    """Restore places every leaf on the device it is given, whatever the
    device of ``like``'s leaves (the CPU, or ``meta``, which holds no
    data); ``like`` stays as it was."""
    cfg, state, step, pipe, ckpt = _mk(tmp_path)
    state, _ = step(state, pipe.torch_batch(0, "cpu"))
    ckpt.save(1, state, async_=False)
    like = tt.init_train_state(tm.LM(cfg, like_device)) \
        if like_device == "meta" else _state(cfg, seed=1)
    restored = ckpt.restore(like=like, shardings=torch.device("cpu"))
    leaf = next(restored.model.parameters())
    assert leaf.device == torch.device("cpu") and leaf.requires_grad
    assert restored.step.device == torch.device("cpu")
    _equal_states(restored, state)
    assert next(like.model.parameters()).device.type == like_device
    if like_device == "cpu":
        _equal_states(like, _state(cfg, seed=1))


def test_restore_refuses_another_structure(tmp_path):
    _, state, _, _, ckpt = _mk(tmp_path)
    ckpt.save(1, state, async_=False)
    moe = _state(dataclasses.replace(get_smoke_config("mixtral-8x22b"),
                                     dtype="float32"))
    with pytest.raises(ValueError, match="structure mismatch.*router"):
        ckpt.restore(like=moe)
    with pytest.raises(TypeError, match="torch.device"):
        ckpt.restore(like=state, shardings={"0": "cpu"})


# ---------------------------------------------------------------------------
# the files each package writes for the same state
# ---------------------------------------------------------------------------
def _states_of(arch: str, opt_dtype: str):
    """The reference's TrainState and the port's holding the same
    weights, moments (seeded, not zero) and steps."""
    jcfg = jsmoke(arch)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: jm.init_params(k, jcfg)[0])(jax.random.PRNGKey(2)))
    rng = np.random.default_rng(3)
    m, v = (jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32), params) for _ in range(2))
    jdt, tdt = getattr(jnp, opt_dtype), getattr(torch, opt_dtype)
    jstate = JTrainState(
        params=jax.tree.map(jnp.asarray, params),
        opt=JAdamWState(step=jnp.int32(7),
                        m=jax.tree.map(lambda a: jnp.asarray(a, jdt), m),
                        v=jax.tree.map(lambda a: jnp.asarray(a, jdt), v)),
        step=jnp.int32(7))
    model = from_reference_params(params, cfg, "cpu")

    def named(tree):
        return {n: torch.from_numpy(np.asarray(a)).to(tdt)
                for n, a in split_reference(_flat(tree), model,
                                            cfg).items()}

    step = torch.tensor(7, dtype=torch.int32)
    tstate = tt.TrainState(model, AdamWState(step.clone(), named(m),
                                             named(v)), step)
    return jstate, tstate


@pytest.mark.parametrize("arch,opt_dtype",
                         [(a, "float32") for a in ARCHS]
                         + [("smollm-135m", "bfloat16")])
def test_the_files_are_the_references(tmp_path, arch, opt_dtype):
    jstate, tstate = _states_of(arch, opt_dtype)
    JCheckpointer(tmp_path / "jax").save(7, jstate, async_=False)
    Checkpointer(tmp_path / "port").save(7, tstate, async_=False)
    _same_files(tmp_path / "jax" / "step_7", tmp_path / "port" / "step_7")


def test_a_general_tree_writes_the_references_files(tmp_path):
    """Dicts, lists and tuples flatten by the reference's rule (keys,
    then indices, joined by ``/``); a dataclass by its fields' order, as
    the reference's registered ``TrainState`` does."""
    rng = np.random.default_rng(4)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((3, 2), (5,), (2, 2, 2), (4,))]
    ints = np.arange(6, dtype=np.int32).reshape(2, 3)

    def tree(conv, bf16):
        return {"b": [conv(arrs[0]), (conv(arrs[1]), conv(ints))],
                "a": {"z": conv(arrs[2]), "y": bf16(arrs[3])},
                "s": conv(np.int32(5))}

    JCheckpointer(tmp_path / "jax").save(2, tree(
        jnp.asarray, lambda a: jnp.asarray(a, jnp.bfloat16)), async_=False)
    mine = tree(lambda a: torch.from_numpy(np.asarray(a)),
                lambda a: torch.from_numpy(a).to(torch.bfloat16))
    ck = Checkpointer(tmp_path / "port")
    ck.save(2, mine, async_=False)
    _same_files(tmp_path / "jax" / "step_2", tmp_path / "port" / "step_2")

    like = {"b": [torch.zeros(3, 2), (torch.zeros(5), torch.zeros(
        2, 3, dtype=torch.int32))], "a": {"z": torch.zeros(2, 2, 2),
        "y": torch.zeros(4, dtype=torch.bfloat16)},
        "s": torch.zeros((), dtype=torch.int32)}
    got = Checkpointer(tmp_path / "jax").restore(like=like)
    assert type(got["b"][1]) is tuple
    for want, have in ((mine["b"][0], got["b"][0]),
                       (mine["b"][1][1], got["b"][1][1]),
                       (mine["a"]["y"], got["a"]["y"]),
                       (mine["s"], got["s"])):
        assert have.dtype == want.dtype and torch.equal(have, want)

    @dataclasses.dataclass
    class Pair:
        first: torch.Tensor
        second: dict

    ck.save(3, Pair(mine["a"]["z"], {"x": mine["b"][0]}), async_=False)
    assert sorted(ck.restore(like=Pair(torch.zeros(1), {"x": torch.zeros(
        1)}), step=3).__dict__) == ["first", "second"]
    with pytest.raises(ValueError, match=r"not in the checkpoint \['0', '1/x'\]"):
        ck.restore(like=Pair(torch.zeros(1), {"x": torch.zeros(1)}), step=2)


# ---------------------------------------------------------------------------
# each package resumes the other's checkpoint
# ---------------------------------------------------------------------------
KW = dict(base_lr=1e-3, warmup=2, total_steps=10, remat="full")


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    """Six float32 steps of smollm's smoke config from the same weights on
    the same batches in each package, each saving its step-3 state: the
    parameters after each step, the step-3 moments, the losses."""
    jcfg = dataclasses.replace(jsmoke("smollm-135m"), dtype="float32")
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    params = jax.jit(lambda k: jm.init_params(k, jcfg)[0])(
        jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, params)
    batches = [TokenPipeline(cfg.vocab_size, 32, 4, seed=11).batch_at(i)
               for i in range(6)]
    root = tmp_path_factory.mktemp("trajectories")
    jstep = jax.jit(jbuild(jcfg, **KW))
    tstep = tt.build_train_step(cfg, **KW)
    out = {"jax": [], "port": []}
    js = jinit(params)
    ts = tt.init_train_state(from_reference_params(host, cfg, "cpu"))
    for i, nb in enumerate(batches):
        js, jmet = jstep(js, {k: jnp.asarray(v) for k, v in nb.items()})
        ts, tmet = tstep(ts, {k: torch.as_tensor(v) for k, v in nb.items()})
        out["jax"].append((float(jmet["loss"]),
                           jax.tree.map(np.asarray, js.params)))
        out["port"].append((float(tmet["loss"]),
                            to_reference_params(ts.model, cfg)))
        if i == 2:
            JCheckpointer(root / "jax").save(3, js, async_=False)
            Checkpointer(root / "port").save(3, ts, async_=False)
            out["moments"] = {
                "jax": [jax.tree.map(np.asarray, t) for t in (js.opt.m,
                                                              js.opt.v)],
                "port": [to_reference_params(ts.model, cfg, t)
                         for t in (ts.opt.m, ts.opt.v)]}
    return jcfg, cfg, host, batches, root, jstep, tstep, out


def _hold(got: dict, want: dict, step: int, bitwise: bool = False):
    far = 0
    for path, w in _flat(want).items():
        g = got
        for k in path:
            g = g[k]
        d = np.abs(np.asarray(g) - w)
        if bitwise:
            assert np.array_equal(g, w), (step, path)
        assert d.max() <= TRAJ_TOL, (step, path, float(d.max()))
        far += int((d > 1e-6).sum())
    assert far <= TRAJ_FAR, (step, far)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_resumes_the_others_checkpoint(trajectories, writer):
    """The reader restores the writer's step-3 checkpoint bitwise (the
    parameters and both moments) and runs steps 4-6; each step's loss
    within rtol 1e-5 and the parameters within the trajectory bounds of
    the writer's own six steps."""
    jcfg, cfg, host, batches, root, jstep, tstep, out = trajectories
    if writer == "jax":
        s = Checkpointer(root / "jax").restore(
            like=tt.init_train_state(from_reference_params(host, cfg,
                                                           "cpu")))
        assert int(s.step) == int(s.opt.step) == 3
        _hold(to_reference_params(s.model, cfg), out["jax"][2][1], 3, True)
        for got, want in zip((s.opt.m, s.opt.v), out["moments"]["jax"]):
            _hold(to_reference_params(s.model, cfg, got), want, 3, True)
    else:
        s = JCheckpointer(root / "port").restore(like=jinit(jax.tree.map(
            jnp.asarray, host)))
        assert int(s.step) == int(s.opt.step) == 3
        _hold(jax.tree.map(np.asarray, s.params), out["port"][2][1], 3,
              True)
        for got, want in zip((s.opt.m, s.opt.v), out["moments"]["port"]):
            _hold(jax.tree.map(np.asarray, got), want, 3, True)
    for i in range(3, 6):
        nb = batches[i]
        if writer == "jax":
            s, met = tstep(s, {k: torch.as_tensor(v) for k, v in nb.items()})
            params = to_reference_params(s.model, cfg)
        else:
            s, met = jstep(s, {k: jnp.asarray(v) for k, v in nb.items()})
            params = jax.tree.map(np.asarray, s.params)
        loss, want = out[writer][i]
        np.testing.assert_allclose(float(met["loss"]), loss, rtol=1e-5,
                                   err_msg=f"step {i}")
        _hold(params, want, i + 1)


# ---------------------------------------------------------------------------
# the snapshot, bfloat16
# ---------------------------------------------------------------------------
def test_an_update_after_an_async_save_never_reaches_the_files(
        tmp_path, monkeypatch):
    """The background writer is held until the state has been updated in
    place: the files hold the state as ``save`` saw it."""
    cfg, state, step, pipe, ckpt = _mk(tmp_path)
    state, _ = step(state, pipe.torch_batch(0, "cpu"))
    want = Checkpointer(tmp_path / "want")
    want.save(1, state, async_=False)
    updated = threading.Event()
    write = ckpt_mod._write_npy

    def held(path, t):
        assert updated.wait(timeout=60)
        write(path, t)

    monkeypatch.setattr(ckpt_mod, "_write_npy", held)
    ckpt.save(1, state, async_=True)
    with torch.no_grad():
        for t in [*state.model.parameters(), *state.opt.m.values(),
                  *state.opt.v.values(), state.step, state.opt.step]:
            t.add_(1)
    updated.set()
    ckpt.wait()
    _same_files(tmp_path / "want" / "step_1", tmp_path / "ckpt" / "step_1")


def test_bfloat16_moments_round_trip(tmp_path):
    cfg, _, step, pipe, ckpt = _mk(tmp_path)
    state = _state(cfg, opt_state_dtype=torch.bfloat16)
    for i in range(2):
        state, _ = step(state, pipe.torch_batch(i, "cpu"))
    ckpt.save(2, state, async_=False)
    manifest = (tmp_path / "ckpt" / "step_2" / "manifest.json").read_text()
    leaves = json.loads(manifest)["leaves"]
    assert {k for k, e in leaves.items() if e["dtype"] == "bfloat16"} == \
        {k for k in leaves if k.startswith(("1/1/", "1/2/"))}
    assert "1/1/embed/embedding" in leaves
    restored = ckpt.restore(like=_state(cfg, opt_state_dtype=torch.bfloat16))
    assert restored.opt.m["embed.embedding"].dtype == torch.bfloat16
    _equal_states(restored, state)


def test_a_reference_bfloat16_checkpoint_restores_in_the_port(tmp_path):
    """The reference saves bfloat16 moments as ``np.save`` writes an
    ml_dtypes array (a void ``.npy`` type), which its own restore cannot
    read back (R7); the port reads them in the manifest's dtype."""
    jcfg = dataclasses.replace(jsmoke("smollm-135m"), dtype="float32")
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    params = jm.init_params(jax.random.PRNGKey(1), jcfg)[0]
    js = jinit(params, opt_state_dtype=jnp.bfloat16)
    jstep = jax.jit(jbuild(jcfg, **KW))
    pipe = TokenPipeline(cfg.vocab_size, 16, 2, seed=5)
    for i in range(2):
        js, _ = jstep(js, {k: jnp.asarray(v)
                           for k, v in pipe.batch_at(i).items()})
    JCheckpointer(tmp_path).save(2, js, async_=False)
    like = tt.init_train_state(tm.LM(cfg, "meta"),
                               opt_state_dtype=torch.bfloat16)
    s = Checkpointer(tmp_path).restore(like=like,
                                       shardings=torch.device("cpu"))
    assert int(s.step) == 2
    _hold(to_reference_params(s.model, cfg), jax.tree.map(np.asarray,
                                                          js.params), 2, True)
    for got, want in ((s.opt.m, js.opt.m), (s.opt.v, js.opt.v)):
        assert all(t.dtype == torch.bfloat16 for t in got.values())
        _hold(to_reference_params(s.model, cfg, got), jax.tree.map(
            lambda a: np.asarray(a.astype(jnp.float32)), want), 2, True)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def _train(ckpt_dir: Path, *extra: str):
    train_main(["--device", "cpu", "--smoke", "--steps", "6",
                "--ckpt-every", "3", "--ckpt-dir", str(ckpt_dir), *extra])


def test_the_launcher_resumes_bit_exactly(tmp_path, capsys):
    _train(tmp_path / "a")
    _train(tmp_path / "b")
    out = capsys.readouterr().out
    assert "resumed" not in out and "final checkpoint at step 6" in out
    # the crash: the last checkpoint lost, a torn one in its place
    shutil.rmtree(tmp_path / "b" / "step_6")
    (tmp_path / "b" / "step_6.tmp").mkdir()
    (tmp_path / "b" / "step_6.tmp" / "leaf_00000.npy").write_bytes(b"torn")
    _train(tmp_path / "b")
    out = capsys.readouterr().out
    assert "[train] resumed from step 3" in out
    assert "[train] step 4/6" in out and "[train] step 1/6" not in out
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == \
        ["step_3", "step_6"]
    _same_files(tmp_path / "a" / "step_6", tmp_path / "b" / "step_6")


def test_the_launcher_refuses_a_mesh(tmp_path, capsys, monkeypatch):
    """The production meshes need 256 and 512 ranks; a coordinator
    address needs the rank and the world size.  Nothing is written."""
    with pytest.raises(RuntimeError, match=r"\(16, 16\) needs 256 ranks, "
                                           r"found 1"):
        _train(tmp_path, "--mesh", "single")
    with pytest.raises(RuntimeError, match=r"\(2, 16, 16\) needs 512"):
        _train(tmp_path, "--mesh", "multi")
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1234")
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit) as exc:
        _train(tmp_path)
    assert exc.value.code == 2
    assert "COORDINATOR_ADDRESS is set without RANK and WORLD_SIZE" in \
        capsys.readouterr().err
    assert not any(tmp_path.iterdir())


def test_checkpoint_and_launch_import_neither_jax_nor_the_reference():
    pat = re.compile(r"^\s*(import jax|from jax|import repro$|import repro\.|"
                     r"from repro(\.| ))", re.M)
    files = [*sorted((SRC / "checkpoint").glob("*.py")),
             *sorted((SRC / "launch").glob("*.py"))]
    assert {f.name for f in files} >= {"__init__.py", "checkpointer.py",
                                       "train.py", "serve.py"}
    for f in files:
        assert not pat.search(f.read_text()), f
