"""The port's CUDA kernels and Executor on a GPU (marked ``gpu``).

Every test skips without a CUDA device; on one, run them with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it runs where only PyTorch is installed.  Each
kernel is held against its plain PyTorch version on the same card tensors
(integer-valued inputs, so float32 results are exact too), and the slice's
queries on the GPU against the same queries on the CPU.
"""

import numpy as np
import pytest
import torch

import repro_torch.core as tcore
import repro_torch.data.relational as trel
from repro_torch.kernels import freq_join as tfj
from repro_torch.kernels import ops as tops
from repro_torch.kernels import segment_sum as tss
from repro_torch.kernels import semi_join as tsj

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("np_,nc", [(1, 1), (8, 8), (1000, 37),
                                    (4096, 1000), (100_003, 7)])
@pytest.mark.parametrize("fdt", [np.int32, np.float32])
def test_joins_match_plain(cuda, np_, nc, fdt):
    rng = np.random.default_rng(np_ + nc)
    pk = torch.tensor(rng.integers(-5, 50, np_).astype(np.int32), device=cuda)
    ck = torch.tensor(rng.integers(-5, 50, nc).astype(np.int32), device=cuda)
    pf = torch.tensor(rng.integers(0, 4, np_).astype(fdt), device=cuda)
    cf = torch.tensor(rng.integers(-1, 4, nc).astype(fdt), device=cuda)
    for mode in ("sum", "any"):
        got = tops.freq_join(pk, pf, ck, cf, mode=mode)
        want = tfj.freq_join_plain(pk, pf, ck, cf, mode=mode)
        assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 17, 1024, 1025, 300_001])
@pytest.mark.parametrize("vdt", [np.int32, np.float32])
def test_segment_sum_matches_plain(cuda, n, vdt):
    rng = np.random.default_rng(n)
    keys = np.sort(rng.integers(-9, max(2, n // 8), n).astype(np.int32))
    k = torch.tensor(keys, device=cuda)
    v = torch.tensor(rng.integers(-3, 5, n).astype(vdt), device=cuda)
    got = tops.segment_sum_sorted(k, v)
    want = tss.segment_sum_plain(k, v)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("agg", ["minmax", "count", "median"])
def test_v1_on_gpu_matches_cpu(cuda, agg):
    gdb, schema = trel.make_tpch_db(scale=2000, seed=1, device=cuda)
    cdb, _ = trel.make_tpch_db(scale=2000, seed=1, device="cpu")
    plan = tcore.plan_query(trel.tpch_v1_query(agg), schema)
    want = tcore.Executor(cdb, schema).execute(plan)
    ex = tcore.Executor(gdb, schema)
    for got in (ex.execute(plan), ex.compile(plan)(gdb)):
        for k, v in want.items():
            if k != "__stats__":
                assert got[k].cpu().item() == v.item()


def test_slice_launches_every_kernel(cuda):
    """The main path goes through the kernels: K1 four times per 0MA
    query, K3 and K2 four times each per Opt⁺ query."""
    db, schema = trel.make_tpch_db(scale=200, seed=2, device=cuda)
    kernels = (tsj.K1, tfj.K2, tss.K3)
    for k in kernels:
        k.launches = 0
    ex = tcore.Executor(db, schema)
    for agg in ("minmax", "median"):
        ex.execute(tcore.plan_query(trel.tpch_v1_query(agg), schema))
    assert [k.launches for k in kernels] == [4, 4, 4]


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    k = torch.arange(10, dtype=torch.int32, device=cuda)
    f = torch.ones(10, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        tfj.freq_join_cuda(k.long(), f, k, f)
    with pytest.raises(TypeError):
        tfj.freq_join_cuda(k, f, k, f.float())
    with pytest.raises(ValueError):
        tfj.freq_join_cuda(k, f, k.cpu(), f.cpu())
    with pytest.raises(ValueError):
        tfj.freq_join_cuda(k[::2], f[::2], k, f)
    with pytest.raises(TypeError):
        tss.segment_sum_cuda(k, f.double())
