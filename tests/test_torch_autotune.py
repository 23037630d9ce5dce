"""The kernel tuner and its store: the port's against the JAX package's.

The port's ``repro_torch.kernels.autotune`` and
``repro_torch.service.tune_store`` on the CPU (backend ``"plain"``, the
kernels' plain versions), held against ``repro.kernels.autotune`` and
``repro.service.tune_store`` (backend ``"xla"``): shape buckets and table
keys, the plain candidates (the reference's ``"xla"`` list), the synthetic
inputs (bitwise equal numpy draws) and each scenario's answer per
candidate, the counters of one resolution sequence (winners are timings
and are not compared), the bitwise gate, the store's discipline
(round-trip, corruption, foreign directories, topology, an unwritable
root), one ``cache_dir`` shared by both packages, and ``Executor`` answers
under an installed config.  The card's candidates are checked against the
C entries' bounds by host arithmetic here; they run on the card in
``tests/test_torch_gpu.py``.
"""

import dataclasses
import hashlib
import json
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.data.relational as jrel
import repro.kernels.autotune as jat
import repro.service.tune_store as jts
import repro_torch.core as tcore
import repro_torch.data.relational as trel
import repro_torch.kernels.autotune as tat
import repro_torch.service.tune_store as tts
from repro_torch.kernels import freq_join as tfj
from repro_torch.kernels import segment_sum as tss
from repro_torch.tables.table import db_from_numpy

jax.config.update("jax_platform_name", "cpu")

CSRC = Path(tfj.__file__).resolve().parent / "csrc"
CARD = ("cuda", "cuda_wide")
JOINS = ("freq_join", "semi_join")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(a, b) -> bool:
    if isinstance(b, (tuple, list)):
        return len(a) == len(b) and all(map(_equal, a, b))
    a, b = _np(a), _np(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# config space and table
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sizes", [(1000, 37), (1024,), (1025,), (1,),
                                   (0, 8), (8_000_000, 2_000_000)])
def test_bucket_shape_matches_reference(sizes):
    assert tat.bucket_shape(*sizes) == jat.bucket_shape(*sizes)


def test_tune_table_keys_and_buckets():
    """Within-bucket sizes share one entry; the next bucket, another
    backend or another kernel miss — as in the reference's table, whose
    keys are the port's with its own backend tag."""
    t, j = tat.TuneTable(), jat.TuneTable()
    cfg = tat.KernelConfig(dense_ratio=99)
    t.install("freq_join", (1000, 37), "plain", cfg)
    assert t.key("freq_join", (1000, 37), "plain")[:2] \
        == j.key("freq_join", (1000, 37), "xla")[:2]
    assert t.lookup("freq_join", (1024, 64), "plain") == cfg
    assert t.lookup("freq_join", (513, 33), "plain") == cfg
    assert t.lookup("freq_join", (1025, 64), "plain") is None
    for backend in CARD:
        assert t.lookup("freq_join", (1024, 64), backend) is None
    assert t.lookup("semi_join", (1024, 64), "plain") is None
    assert len(t) == 1 and t.entries() == [
        (("freq_join", (1024, 64), "plain"), cfg)]


@pytest.mark.parametrize("kernel", tat.KERNELS)
def test_plain_candidates_are_the_references_xla_list(kernel):
    ours = tat.candidate_configs(kernel, "plain")
    theirs = jat.candidate_configs(kernel, "xla")
    assert [(c.dense_ratio, c.dense_floor) for c in ours] \
        == [(c.dense_ratio, c.dense_floor) for c in theirs]
    assert all(dataclasses.replace(c, dense_ratio=4) == tat.DEFAULT_CONFIG
               for c in ours)


@pytest.mark.parametrize("backend", tat.BACKENDS)
@pytest.mark.parametrize("kernel", tat.KERNELS)
def test_candidates_include_default_and_are_distinct(kernel, backend):
    cands = tat.candidate_configs(kernel, backend)
    assert cands[0] == tat.DEFAULT_CONFIG
    assert len(cands) == len(set(cands))
    assert all(isinstance(getattr(c, f.name), int) for c in cands
               for f in dataclasses.fields(c))
    with pytest.raises(ValueError, match="unknown kernel"):
        tat.candidate_configs("hash_join", backend)
    with pytest.raises(ValueError, match="unknown backend"):
        tat.candidate_configs(kernel, "pallas")


def test_default_config_reproduces_the_untuned_launches():
    d = tat.DEFAULT_CONFIG
    assert (d.join_threads, d.shared_max_rows, d.slot_factor, d.seg_items,
            d.seg_min_blocks) == (256, 1024, 2, 8, 6)
    assert tfj.SHARED_MAX_ROWS == 1024 and tss.TILE == 2048
    for n in (0, 1, 5, 1024, 1025, 3_000_000):
        assert tfj.table_slots(n, d.slot_factor) == tfj.table_slots(n)
        for np_ in (7, 2048, 5_000_000):
            assert tfj.join_path(np_, n, d) == tfj.join_path(np_, n)


def test_backend_tag():
    assert tat.backend_tag("cpu", False) == tat.backend_tag("cpu", True) \
        == "plain"
    assert tat.backend_tag("cuda", False) == "cuda"
    assert tat.backend_tag(torch.device("cuda", 1), True) == "cuda_wide"


# ---------------------------------------------------------------------------
# the card's candidates against the C entries' bounds, on the host
# ---------------------------------------------------------------------------
def _c_instances():
    """(join block sizes, K3 (items, min blocks) pairs) the C entries
    dispatch on, read from the sources."""
    fj = (CSRC / "freq_join.cu").read_text()
    body = fj[fj.index("int run_threads("):]
    body = body[:body.index("\n}\n")]
    threads = {int(t) for t in re.findall(r"run_mode<(\d+), K, F>", body)}
    ss = (CSRC / "segment_sum.cu").read_text()
    body = ss[ss.index("switch (items * 100 + min_blocks)"):]
    body = body[:body.index("\n}\n")]
    seg = {(int(i), int(m))
           for i, m in re.findall(r"run_keys<(\d+), (\d+)>", body)}
    return threads, seg


def test_wrappers_mirror_the_c_instances():
    threads, seg = _c_instances()
    assert threads == set(tfj.JOIN_THREADS)
    assert seg == set(tss.INSTANCES)
    assert f"kSharedBytes = {tfj.SHARED_BYTES // 1024} * 1024" in \
        (CSRC / "freq_join.cu").read_text()


ROWS = sorted({r + d for r in (512, 1024, 2048, 1 << 17, 1 << 21, 1 << 23)
               for d in (-1, 0, 1)} | {0, 1, 8, 32})


@pytest.mark.parametrize("backend", CARD)
@pytest.mark.parametrize("kernel", JOINS)
def test_join_candidates_within_the_c_bounds(kernel, backend):
    """Every card candidate of K1/K2 at every child and parent length near
    the cut-offs and the V.1 buckets: a block size the C entry has, slots a
    power of two ≥ 2 and ≥ 2 per build row (at most 2^31), and on the
    shared path a table inside the block's 48 KiB."""
    mode = "any" if kernel == "semi_join" else "sum"
    wide = backend == "cuda_wide"
    threads, _ = _c_instances()
    for cfg in tat.candidate_configs(kernel, backend):
        assert cfg.join_threads in threads and cfg.slot_factor >= 2
        for nc in ROWS:
            for np_ in ROWS:
                path = tfj.join_path(np_, nc, cfg)
                build = np_ if path.side == "parent" else nc
                s = path.slots
                assert s >= 2 and s & (s - 1) == 0 and s <= 1 << 31
                assert s >= 2 * build
                if path.side == "shared":
                    assert nc <= cfg.shared_max_rows
                    assert tfj.shared_table_fits(s, mode, wide), (cfg, nc)


def test_shared_table_bound_is_the_c_entrys():
    """2048 sum-mode rows fit the narrow shared table and not the wide one;
    a load factor of 1/4 halves the wide cut-off."""
    slots = tfj.table_slots(2048)
    assert tfj.shared_table_fits(slots, "sum", wide=False)
    assert not tfj.shared_table_fits(slots, "sum", wide=True)
    assert tfj.shared_table_fits(slots, "any", wide=True)
    wide = {c.slot_factor: c.shared_max_rows
            for c in tat.candidate_configs("freq_join", "cuda_wide")}
    assert wide[4] == 512
    assert 2048 not in {c.shared_max_rows
                        for c in tat.candidate_configs("freq_join",
                                                       "cuda_wide")}


@pytest.mark.parametrize("backend", CARD)
def test_segment_sum_candidates_within_the_c_bounds(backend):
    _, seg = _c_instances()
    for cfg in tat.candidate_configs("segment_sum", backend):
        assert (cfg.seg_items, cfg.seg_min_blocks) in seg
        tile = tss.tile_rows(cfg)
        assert tile == 256 * cfg.seg_items
        for n in (tile - 1, tile, tile + 1, 1 << 23):
            words = tss.scratch_words(n, backend == "cuda_wide", tile)
            nt = -(-n // tile)
            assert words == 0 if nt == 1 else words > 0


# ---------------------------------------------------------------------------
# synthetic inputs, scenarios and the search
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,domain", [((64, 256), 256), ((8, 32), 32),
                                          ((1000, 37), 2368)])
def test_synth_join_draws_the_references_arrays(shape, domain):
    ours = tat._synth_join(shape, domain)
    theirs = jat._synth_join(shape, domain)
    assert _equal(ours, theirs)
    wide = tat._synth_join(shape, domain, wide=True)
    assert all(t.dtype == torch.int64 for t in wide)
    assert all(np.array_equal(_np(a), _np(b)) for a, b in zip(wide, ours))


@pytest.mark.parametrize("n", [8, 1000, 4096])
def test_synth_segment_draws_the_references_arrays(n):
    assert _equal(tat._synth_segment((n,)), jat._synth_segment((n,)))
    assert tat._domain_probes(n) == jat._domain_probes(n)


@pytest.mark.parametrize("kernel,bshape", [("freq_join", (64, 256)),
                                           ("semi_join", (256, 64)),
                                           ("segment_sum", (512,))])
def test_plain_scenarios_answer_as_the_references_xla(kernel, bshape):
    """Each scenario's answer under each plain candidate equals the
    reference's under the matching xla candidate, bit for bit."""
    ours = tat.KernelTuner(backend="plain").scenarios(kernel, bshape)
    theirs = jat.KernelTuner(backend="xla")._scenarios(kernel, bshape)
    assert [label for label, _ in ours] == [label for label, _ in theirs]
    pairs = list(zip(tat.candidate_configs(kernel, "plain"),
                     jat.candidate_configs(kernel, "xla")))
    for (_, fo), (_, ft) in zip(ours, theirs):
        for co, ct in pairs:
            assert _equal(fo(co), ft(ct)), (kernel, co)


def test_resolution_counters_match_reference(tmp_path):
    """One ensure / load_persisted sequence through both tuners, each with
    its own store: equal counters and store counters at every step."""
    tuners = {}
    for name, at, ts, backend in (("t", tat, tts, "plain"),
                                  ("j", jat, jts, "xla")):
        d = tmp_path / name
        tuners[name] = [at.KernelTuner(ts.TuneStore(d), backend=backend,
                                       repeats=1),
                        lambda at=at, ts=ts, d=d, backend=backend:
                        at.KernelTuner(ts.TuneStore(d), backend=backend,
                                       repeats=1)]

    def step(fn):
        for name in ("t", "j"):
            fn(tuners[name])
        got = [dict(tuners[n][0].metrics(), **tuners[n][0].store.metrics())
               for n in ("t", "j")]
        assert got[0] == got[1]
        return got[0]

    m = step(lambda p: p[0].ensure("freq_join", (64, 256)))
    assert m["tune_searches"] == 1 and m["tune_candidates"] == 4
    step(lambda p: p[0].ensure("freq_join", (50, 200)))       # the table
    m = step(lambda p: p[0].ensure("segment_sum", (100,)))    # 1 candidate
    assert m["tune_searches"] == 2 and m["tune_candidates"] == 4
    step(lambda p: p[0].ensure("semi_join", (8, 8)))
    # a fresh tuner on the same store: from disk, one entry at a time...
    step(lambda p: p.__setitem__(0, p[1]()))
    m = step(lambda p: p[0].ensure("segment_sum", (128,)))
    assert m["tune_searches"] == 0 and m["tune_store_hits"] == 1
    # ...and all at once
    step(lambda p: p.__setitem__(0, p[1]()))
    m = step(lambda p: p[0].load_persisted())
    assert m["tune_store_hits"] == m["tune_entries"] == 3
    m = step(lambda p: p[0].ensure("semi_join", (8, 8)))
    assert m["tune_searches"] == 0


def _inputs(scen):
    return [fn.__defaults__[0] for _, fn in scen]


def test_shared_draws_keep_one_bucket_for_both_joins():
    """Inside ``shared_draws`` both joins of a bucket score the same drawn
    tensors; another bucket's draw replaces them, and the block's end drops
    them (outside it every scenario draws anew)."""
    tuner = tat.KernelTuner(backend="plain")
    with tuner.shared_draws():
        a = _inputs(tuner.scenarios("freq_join", (64, 256)))
        b = _inputs(tuner.scenarios("semi_join", (64, 256)))
        assert all(x is y for x, y in zip(a, b))
        tuner.scenarios("semi_join", (8, 8))
        c = _inputs(tuner.scenarios("freq_join", (64, 256)))
        assert all(x is not y and _equal(x, y) for x, y in zip(a, c))
    assert tuner._local.draws is None
    d = _inputs(tuner.scenarios("freq_join", (64, 256)))
    assert all(x is not y for x, y in zip(c, d))


class _DivergingTuner(tat.KernelTuner):
    """A scenario whose answer DEPENDS on the config: every non-default
    candidate diverges bitwise, so the gate must reject all of them and the
    default must win regardless of timings."""

    def scenarios(self, kernel, bshape):
        return [("stub", lambda cfg: (
            torch.tensor([cfg.seg_items, cfg.seg_min_blocks]),
            torch.tensor([1.0])))]


@pytest.mark.parametrize("backend", CARD)
def test_bitwise_gate_rejects_diverging_candidates(backend):
    tuner = _DivergingTuner(None, backend=backend, device="cpu", repeats=1)
    cfg, measurements = tuner.search("segment_sum", (1024,))
    assert cfg == tat.DEFAULT_CONFIG
    n_cands = len(tat.candidate_configs("segment_sum", backend))
    assert tuner.counters["tune_gate_rejects"] == n_cands - 1
    assert tuner.counters["tune_candidates"] == n_cands
    assert list(measurements) == ["items8_blocks6"]


def test_bitwise_equal_reads_bits():
    z = torch.tensor([0.0])
    assert not tat._bitwise_equal((z,), (-z,))
    assert tat._bitwise_equal(torch.tensor([float("nan")]),
                              torch.tensor([float("nan")]))
    assert not tat._bitwise_equal(torch.tensor([1], dtype=torch.int32),
                                  torch.tensor([1], dtype=torch.int64))
    assert not tat._bitwise_equal((z, z), (z,))


def test_measure_takes_the_best_of_its_repeats():
    calls = []
    t = tat.measure(lambda: calls.append(1), repeats=3, device="cpu")
    assert len(calls) == 4 and 0 <= t < 1


# ---------------------------------------------------------------------------
# TuneStore discipline (the reference's tests, on the port)
# ---------------------------------------------------------------------------
def _single_entry(store):
    paths = list(store.tune_dir.glob("*.json"))
    assert len(paths) == 1
    return paths[0]


def test_store_roundtrip_across_instances(tmp_path):
    cfg = tat.KernelConfig(seg_items=16, seg_min_blocks=3)
    store = tts.TuneStore(tmp_path)
    assert store.save("segment_sum", (4096,), "cuda", cfg,
                      measurements={"items16_blocks3": 0.001})
    assert store.metrics()["tune_persist_writes"] == 1
    fresh = tts.TuneStore(tmp_path)
    assert fresh.load("segment_sum", (4096,), "cuda") == cfg
    assert fresh.load("segment_sum", (4096,), "cuda_wide") is None
    assert fresh.load("segment_sum", (8192,), "cuda") is None
    m = fresh.metrics()
    assert m["tune_persist_hits"] == 1 and m["tune_persist_misses"] == 2
    assert m["tune_persist_entries"] == 1
    assert list(fresh.load_all()) == [
        (("segment_sum", (4096,), "cuda"), cfg)]
    # the reference's format: header fields, version 1, checksum
    doc = json.loads(_single_entry(store).read_text())
    assert doc["format_version"] == jts.TUNE_FORMAT_VERSION == 1
    assert doc["payload_sha256"] == hashlib.sha256(
        jts._canonical_body(doc["payload"])).hexdigest()


@pytest.mark.parametrize("damage", ["truncated", "flipped", "version",
                                    "key", "fields"])
def test_corrupt_entries_skipped_and_evicted(tmp_path, damage):
    store = tts.TuneStore(tmp_path)
    store.save("freq_join", (1024, 1024), "cuda",
               tat.KernelConfig(join_threads=512))
    path = _single_entry(store)
    raw = path.read_bytes()
    doc = json.loads(raw)
    if damage == "truncated":
        path.write_bytes(raw[:len(raw) // 2])
    elif damage == "flipped":
        doc["payload"]["config"]["join_threads"] = 128
        path.write_text(json.dumps(doc))
    elif damage == "version":
        doc["format_version"] = tts.TUNE_FORMAT_VERSION + 99
        path.write_text(json.dumps(doc))
    elif damage == "key":
        doc["kernel"] = "semi_join"
        path.write_text(json.dumps(doc))
    else:  # fields: checksum valid, the config schema drifted
        doc["payload"]["config"]["lanes_wide"] = 1024
        doc["payload_sha256"] = hashlib.sha256(
            tts._canonical_body(doc["payload"])).hexdigest()
        path.write_text(json.dumps(doc))
    fresh = tts.TuneStore(tmp_path)
    assert fresh.load("freq_join", (1024, 1024), "cuda") is None
    m = fresh.metrics()
    assert m["tune_persist_corrupt_skipped"] == 1
    assert m["tune_persist_hits"] == 0
    assert not path.exists()


def test_load_all_from_foreign_dir_never_evicts(tmp_path):
    store = tts.TuneStore(tmp_path)
    store.save("freq_join", (512, 512), "plain", tat.KernelConfig())
    path = _single_entry(store)
    path.write_bytes(path.read_bytes()[:40])
    reader = tts.TuneStore(tmp_path)
    assert list(reader.load_all()) == []
    assert reader.metrics()["tune_persist_corrupt_skipped"] == 1
    assert path.exists()


def test_topology_scopes_entries(tmp_path):
    local = tts.TuneStore(tmp_path)
    mesh = tts.TuneStore(tmp_path, topology=(("dp",), (4,)))
    local.save("freq_join", (1024, 1024), "cuda",
               tat.KernelConfig(slot_factor=4))
    assert mesh.load("freq_join", (1024, 1024), "cuda") is None
    assert local.tune_dir != mesh.tune_dir


def test_unwritable_store_degrades(tmp_path):
    store = tts.TuneStore(tmp_path)
    for p in store.tune_dir.glob("*"):
        p.unlink()
    store.tune_dir.rmdir()
    store.tune_dir.write_text("not a directory")
    assert store.save("freq_join", (64, 64), "plain",
                      tat.KernelConfig()) is False
    m = store.metrics()
    assert m["tune_persist_write_errors"] == 1
    assert m["tune_persist_writes"] == 0
    tuner = tat.KernelTuner(store, backend="plain", repeats=1)
    assert tuner.ensure("freq_join", (64, 64)) in tat.candidate_configs(
        "freq_join", "plain")
    assert tuner.metrics()["tune_searches"] == 1


def test_shared_cache_dir_loses_no_entry_of_either_package(tmp_path):
    """Both packages' stores and tuners on one directory: each loads its
    own entries, the port skips the reference's without counting or
    evicting them, and no file is lost."""
    ours, theirs = tts.TuneStore(tmp_path), jts.TuneStore(tmp_path)
    assert ours.tune_dir == theirs.tune_dir
    mine = {("freq_join", (1024, 1024), "plain"):
            tat.KernelConfig(dense_ratio=32),
            ("segment_sum", (4096,), "cuda"):
            tat.KernelConfig(seg_items=4),
            ("freq_join", (1024, 1024), "cuda_wide"):
            tat.KernelConfig(join_threads=128)}
    for key, cfg in mine.items():
        assert ours.save(*key, cfg)
    jcfg = jat.KernelConfig(dense_ratio=32)
    assert theirs.save("freq_join", (1024, 1024), "xla", jcfg)
    files = sorted(tmp_path.rglob("*.json"))
    assert len(files) == 4
    reader = tts.TuneStore(tmp_path)
    assert dict(reader.load_all()) == mine
    assert reader.metrics()["tune_persist_corrupt_skipped"] == 0
    for key, cfg in mine.items():
        assert reader.load(*key) == cfg
    with pytest.raises(ValueError, match="backend"):
        reader.load("freq_join", (1024, 1024), "xla")
    jreader = jts.TuneStore(tmp_path)
    assert jreader.load("freq_join", (1024, 1024), "xla") == jcfg
    assert dict(jreader.load_all()) == {
        ("freq_join", (1024, 1024), "xla"): jcfg}
    for backend, at, ts in (("plain", tat, tts), ("xla", jat, jts)):
        at.KernelTuner(ts.TuneStore(tmp_path), backend=backend) \
            .load_persisted()
    assert sorted(tmp_path.rglob("*.json")) == files


# ---------------------------------------------------------------------------
# Executor under an installed config
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("agg", ["minmax", "count", "median"])
def test_executor_tuning_matches_reference(agg):
    """``dense_ratio=0`` installed at every bucket pair turns the plain
    FreqJoin's dense path off: the port's ``Executor(tuning=...)`` answers
    V.1 with ``dense_domain=True`` bit for bit as the reference's under the
    same installed config."""
    jdb, jschema = jrel.make_tpch_db(scale=150, seed=1)
    tdb = db_from_numpy(
        {r: {**{c: np.asarray(v) for c, v in t.columns.items()},
             "freq": np.asarray(t.freq)} for r, t in jdb.items()},
        device="cpu")
    tschema = trel.make_tpch_db(scale=150, seed=1, device="cpu")[1]
    caps = sorted({t.capacity for t in tdb.values()})
    ttab, jtab = tat.TuneTable(), jat.TuneTable()
    for kernel in JOINS:
        for bp in caps:
            for bc in caps:
                ttab.install(kernel, (bp, bc), "plain",
                             tat.KernelConfig(dense_ratio=0))
                jtab.install(kernel, (bp, bc), "xla",
                             jat.KernelConfig(dense_ratio=0))
    tex = tcore.Executor(tdb, tschema, dense_domain=True, tuning=ttab)
    jex = jcore.Executor(jdb, jschema, dense_domain=True, tuning=jtab)
    tplan = tcore.plan_query(trel.tpch_v1_query(agg), tschema)
    jplan = jcore.plan_query(jrel.tpch_v1_query(agg), jschema)
    for got, want in ((tex.execute(tplan), jex.execute(jplan)),
                      (tex.compile(tplan)(tdb), jex.compile(jplan)(jdb))):
        got.pop("__stats__", None)
        want.pop("__stats__", None)
        assert set(got) == set(want)
        for k in want:
            assert _equal(got[k], want[k]), (agg, k)


def test_compiled_closure_keeps_the_configs_of_its_first_call():
    """A closure looks its configs up once, at its first call; an install
    after that reaches closures compiled afterwards only."""
    tdb, tschema = trel.make_tpch_db(scale=20, seed=5, device="cpu")
    table = tat.TuneTable()
    ex = tcore.Executor(tdb, tschema, tuning=table)
    plan = tcore.plan_query(trel.tpch_v1_query("median"), tschema)
    seen = []
    lookup = table.lookup

    def spy(kernel, shape, backend):
        seen.append((kernel, tuple(shape), backend))
        return lookup(kernel, shape, backend)

    table.lookup = spy
    fn = ex.compile(plan)
    assert seen == []
    first = fn(tdb)
    n = len(seen)
    assert n > 0 and {b for _, _, b in seen} == {"plain"}
    again = fn(tdb)
    assert len(seen) == n
    assert all(_equal(first[k], again[k]) for k in first)


def test_tuner_modules_import_neither_jax_nor_the_reference():
    pat = re.compile(r"^\s*(import jax|from jax|import repro$|import repro\.|"
                     r"from repro(\.| ))", re.M)
    for mod in (tat, tts):
        assert not pat.search(Path(mod.__file__).read_text()), mod.__name__
