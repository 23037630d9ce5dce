"""The port's LM serving against the JAX package's, on the CPU.

``greedy_generate`` and ``ServeEngine`` of both packages, in float32, over
the same weights (the JAX package's draws carried across with
``from_reference_params``) and the same seeded numpy prompts, must emit the
same tokens: one wave, several waves, prompts of unequal lengths (zero
left-padding, whose positions both attend, and which the recurrent state
ingests) and an EOS, for dense, MoE, rwkv6 and the zamba2 hybrid.  Prompts
are at least ``conv_width - 1`` = 3 tokens long where the reference
prefills a Mamba2 layer (``ROADMAP.md`` §3, R5).  The port's greedy tokens
also equal a rollout of its own ``forward`` (the reference's oracle in
``tests/test_serving.py``).  Then the deprecated ``repro_torch.serving``
alias and ``python -m repro_torch.launch.serve --smoke --device cpu``.
"""

import dataclasses
import functools
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_smoke_config
from repro.models import lm_serving as jserve
from repro_torch import models as tm
from repro_torch.models import ModelConfig
from repro_torch.models import lm_serving as tserve
from repro_torch.models.convert import from_reference_params

jax.config.update("jax_platform_name", "cpu")

ROOT = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _models(arch: str, seed: int):
    """(JAX params, JAX config, port model, port config) in float32."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = jax.jit(lambda key: jm.init_params(key, cfg)[0])(
        jax.random.PRNGKey(seed))
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    model = from_reference_params(jax.tree.map(np.asarray, params), tcfg,
                                  "cpu")
    return params, cfg, model, tcfg


def _rollout(model, cfg, prompt, max_new):
    """Oracle: the port's full forward re-run for every generated token."""
    toks, out = list(prompt), []
    for _ in range(max_new):
        logits, _ = tm.forward(model, cfg, {"tokens": torch.as_tensor(
            [toks], dtype=torch.int32)})
        out.append(int(torch.argmax(logits[0, -1])))
        toks.append(out[-1])
    return out


@pytest.mark.parametrize("arch", ["smollm-135m", "moonshot-v1-16b-a3b",
                                  "gemma3-1b", "rwkv6-1.6b", "zamba2-1.2b"])
def test_greedy_generate_matches_the_reference_and_forward(arch):
    params, cfg, model, tcfg = _models(arch, 0)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 8))
    want = jserve.greedy_generate(params, cfg, prompts, max_new_tokens=6)
    got = tserve.greedy_generate(model, tcfg, prompts, max_new_tokens=6)
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got, want)
    assert got[0].tolist() == _rollout(model, tcfg, list(prompts[0]), 6)


def _serve(engine, prompts, **kw):
    rids = [engine.submit(p) for p in prompts]
    served = {}
    while engine._queue:
        served.update(engine.run_wave(**kw))
    assert set(served) == set(rids)
    return served


def test_wave_engine_one_wave_matches_the_reference():
    params, cfg, model, tcfg = _models("smollm-135m", 1)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, 8) for _ in range(3)]
    want = _serve(jserve.ServeEngine(params, cfg, n_slots=4, max_len=64),
                  prompts, max_tokens=5)
    got = _serve(tserve.ServeEngine(model, tcfg, n_slots=4, max_len=64),
                 prompts, max_tokens=5)
    assert got == want
    for rid, p in enumerate(prompts):
        solo = tserve.greedy_generate(model, tcfg, p[None, :], 5)
        assert got[rid] == solo[0].tolist()


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b"])
def test_wave_engine_serves_the_mixers_as_the_reference(arch):
    """One wave of prompts of unequal lengths (3 to 9 tokens, left-padded
    to 9), then a second wave, token for token; each request's tokens
    also equal ``greedy_generate``'s over its left-padded prompt."""
    params, cfg, model, tcfg = _models(arch, 4)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (3, 9, 5, 7, 4)]
    want = _serve(jserve.ServeEngine(params, cfg, n_slots=3, max_len=32),
                  prompts, max_tokens=5)
    got = _serve(tserve.ServeEngine(model, tcfg, n_slots=3, max_len=32),
                 prompts, max_tokens=5)
    assert got == want
    assert all(len(v) == 5 for v in got.values())
    for rid, wave in ((0, prompts[:3]), (1, prompts[:3]), (3, prompts[3:])):
        plen = max(len(p) for p in wave)
        padded = np.zeros((1, plen), np.int32)
        padded[0, plen - len(prompts[rid]):] = prompts[rid]
        solo = tserve.greedy_generate(model, tcfg, padded, 5)
        assert got[rid] == solo[0].tolist(), rid


@pytest.mark.parametrize("lengths", [(4, 4, 4, 4, 4), (3, 7, 5, 2, 6)])
def test_wave_engine_several_waves_match_the_reference(lengths):
    params, cfg, model, tcfg = _models("smollm-135m", 2)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lengths]
    want = _serve(jserve.ServeEngine(params, cfg, n_slots=2, max_len=32),
                  prompts, max_tokens=3)
    got = _serve(tserve.ServeEngine(model, tcfg, n_slots=2, max_len=32),
                 prompts, max_tokens=3)
    assert got == want
    assert all(len(v) == 3 for v in got.values())


def test_wave_engine_stops_slots_at_eos_as_the_reference():
    params, cfg, model, tcfg = _models("moonshot-v1-16b-a3b", 3)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, 6) for _ in range(3)]
    free = _serve(tserve.ServeEngine(model, tcfg, n_slots=3, max_len=32),
                  prompts, max_tokens=8)
    eos = free[1][2]  # request 1 stops at its third token
    want = _serve(jserve.ServeEngine(params, cfg, n_slots=3, max_len=32),
                  prompts, eos=eos, max_tokens=8)
    got = _serve(tserve.ServeEngine(model, tcfg, n_slots=3, max_len=32),
                 prompts, eos=eos, max_tokens=8)
    assert got == want
    assert got[1] == free[1][:free[1].index(eos) + 1]


def test_deprecated_serving_alias_still_exports_engine():
    with pytest.warns(DeprecationWarning,
                      match="repro_torch.models.lm_serving"):
        mod = importlib.import_module("repro_torch.serving")
        mod = importlib.reload(mod)
    assert mod.ServeEngine is tserve.ServeEngine
    assert mod.greedy_generate is tserve.greedy_generate


def test_launcher_serves_the_smoke_config_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--n-requests", "3", "--n-slots", "2",
         "--prompt-len", "8", "--max-new", "4"],
        capture_output=True, text=True, env=env, timeout=300, check=True)
    lines = out.stdout.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines[:3]] == [
        f"[serve] req {i}" for i in range(3)]
    assert all("4 tokens" in ln for ln in lines[:3])
    assert lines[-1].startswith("[serve] 12 tokens in ")
    assert lines[-1].endswith("on cpu")


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b"])
def test_launcher_serves_the_mixers_smoke_configs_on_the_cpu(arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--device", "cpu", "--n-requests", "3", "--n-slots",
         "2", "--prompt-len", "8", "--max-new", "4"],
        capture_output=True, text=True, env=env, timeout=300, check=True)
    lines = out.stdout.strip().splitlines()
    assert all("4 tokens" in ln for ln in lines[:3])
    assert lines[-1].startswith("[serve] 12 tokens in ")
