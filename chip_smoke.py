#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc per
source, all at once), holds each kernel against its plain PyTorch version on
the card, then drives the paper's running example — TPC-H V.1 MIN/MAX and
COUNT (0MA semi-join sweeps) and MEDIAN (Opt⁺ FreqJoin sweep with
pre-grouping) — through ``plan_query`` and ``Executor.execute`` /
``Executor.compile`` at ``make_tpch_db(scale=100000)``, which has TPC-H
SF10's supplier (100k), part (2M) and partsupp (8M) cardinalities.  Answers
are held exactly against an independent numpy evaluation of V.1, and every
kernel's launch count over that run must be positive, as must the count of
each path of the hash join (the table on the child side, on the parent
side, or in shared memory) for K1 and K2.

The kernels are held against their plain versions at the main path's
inputs and on synthetic cases that reach every path: key −1 (the hash
table's empty marker) in either side, int32's extremes, repeated parent
keys, empty sides, int32 wrap-around and zipf-skewed keys.  K1 is timed
beside ``torch.isin``, its library yardstick, and each K1/K2 main-path call
is split into its phases (fill, build, probe, gather) by CUDA events.  Both
sides of each of ``freq_join.join_path``'s choices (shared memory or the
child side for a child at the row limit, the parent or the child side at
equal lengths) are timed on the same synthetic inputs near where it flips.
K3 is also held against its plain version with one key over 8M rows and with
every row its own run (bitwise, float32 too: its values there are small
integers), and on views at storage offsets 1-3; each main-path
K3 call is timed beside ``torch.cumsum`` of its values (``cumsum_ms``,
device time), a single-pass scan that moves 8 of K3's 13 bytes a row: a
yardstick of the card's scan rate, not a library call of the same function.

Prints the card's name and power limit, one JSON line per kernel call, per
phase split, per cut-off case and per timed K3 case (``segsum_case``), one
JSON line per query with its times, one per query with
its device time by kernel from ``torch.profiler``, one JSON line
``{"kernels": [...]}`` with each kernel's time, bound, plain-version and
library time, and as its last line ``{"ok": true, "device": {...}}``.  Any
failure exits non-zero without that line.  Needs a CUDA GPU of compute
capability 9.0 (sm_90a) and nvcc.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SCALE = 100_000            # supplier 100k, part 2M, partsupp 8M rows
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
EPS32 = float(np.finfo(np.float32).eps)
QUERIES = ("minmax", "count", "median")
COMPILED_RUNS = 3
TIMING_REPS = 20
SPIN_CYCLES = 2_000_000    # ~1 ms at the H100's clock: time to enqueue a call

KERNEL_META = {
    "semi_join": ("src/repro_torch/kernels/csrc/freq_join.cu",
                  "src/repro/kernels/semi_join.py:56"),
    "freq_join": ("src/repro_torch/kernels/csrc/freq_join.cu",
                  "src/repro/kernels/freq_join.py:84"),
    "segment_sum": ("src/repro_torch/kernels/csrc/segment_sum.cu",
                    "src/repro/kernels/segment_sum.py:79"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------
def time_ms(torch, fn, reps: int = TIMING_REPS, warm: int = 3,
            queued: bool = False) -> float:
    """Median time of one call of ``fn``, by CUDA events (``split_ms``)."""
    return statistics.median(split_ms(torch, [fn], reps, warm, queued)[0])


def split_ms(torch, steps, reps: int = TIMING_REPS, warm: int = 3,
             queued: bool = False):
    """Time of each of ``steps``, callables run back to back on one stream,
    by CUDA events recorded between them: one list of ``reps`` times per
    step.  Unqueued, a step's time includes the host's time to launch it
    whenever the card waits for the host, as it does for a small call.
    ``queued`` first holds the card in a spin kernel long enough for the
    host to enqueue every step, so the events time the device alone."""
    for _ in range(warm):
        for step in steps:
            step()
    torch.cuda.synchronize()
    times = [[] for _ in steps]
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(steps) + 1)]
        if queued:
            torch.cuda._sleep(SPIN_CYCLES)
        ev[0].record()
        for step, e in zip(steps, ev[1:]):
            step()
            e.record()
        ev[-1].synchronize()
        for k, t in enumerate(times):
            t.append(ev[k].elapsed_time(ev[k + 1]))
    return times


def join_bytes(np_: int, nc: int) -> int:
    # pk, pf read and out written (4 B each per parent row); ck, cf read
    return 12 * np_ + 8 * nc


def segsum_bytes(n: int) -> int:
    # keys, values read and sums written (4 B each), valid written (1 B)
    return 13 * n


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# kernel versus plain version
# ---------------------------------------------------------------------------
def compare(torch, name: str, got, want, tol) -> float:
    """Max |got - want|; int tensors must be equal, float within ``tol``
    (a scalar or one bound per element)."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: shape/dtype {tuple(got.shape)}/{got.dtype} vs "
          f"{tuple(want.shape)}/{want.dtype}")
    if not got.dtype.is_floating_point:
        diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        check(bool(torch.equal(got, want)), f"{name}: not bitwise equal "
              f"(max |diff| {err})")
        return err
    diff = (got.double() - want.double()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    tol_t = torch.as_tensor(tol, dtype=torch.float64, device=diff.device)
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    check(bool((diff <= tol_t).all()), f"{name}: max |diff| {err} above the "
          "stated tolerance")
    return err


def join_tolerance(torch, pf, cf):
    """float32 FreqJoin: the plain version takes differences of a float32
    prefix sum over the whole sorted child, so each result carries the
    rounding of that prefix: bound 4·eps·Σ|cf|·|pf|.  Zero for ints."""
    if not pf.dtype.is_floating_point:
        return 0.0
    return 4 * EPS32 * float(cf.abs().double().sum()) * pf.abs().double()


def segsum_tolerance(torch, plain_ss, keys, vals):
    """float32 segment sum: both versions add a run in different orders, so
    a run's total may differ by len·eps·Σ|v| over the run.  Zero for ints."""
    if not vals.dtype.is_floating_point:
        return 0.0
    abs_sum, _ = plain_ss(keys, vals.abs())
    length, _ = plain_ss(keys, torch.ones_like(vals))
    return 2 * EPS32 * length.double() * abs_sum.double()


def check_join(torch, kern, plain, errs, tag, pk, pf, ck, cf):
    got = kern(pk, pf, ck, cf)
    want = plain(pk, pf, ck, cf)
    torch.cuda.synchronize()
    errs.append(compare(torch, tag, got, want, join_tolerance(torch, pf, cf)))
    return got


def isin_ms(torch, i, pk, pf, ck, cf) -> float:
    """K1's library yardstick: ``torch.isin(pk, ck)`` at the call's shapes
    (the membership test at the semi-join's core, without the live filter
    and the multiply), timed; the same call on the live child keys, times
    ``pf``, is held against the plain semi-join first."""
    from repro_torch.kernels.semi_join import semi_join_plain
    got = pf * torch.isin(pk, ck[cf > 0]).to(pf.dtype)
    compare(torch, f"torch.isin semi_join call {i}", got,
            semi_join_plain(pk, pf, ck, cf), 0.0)
    return time_ms(torch, lambda: torch.isin(pk, ck))


def phase_line(torch, fj, kernel, wrapper, plain, name, i, mode,
               args) -> dict:
    """Fill/build/probe(/gather) of one main-path K1/K2 call by CUDA events
    between the phases (device time, queued), and the whole wrapper call,
    unqueued (``ms``, host launch included) and queued (``device_ms``),
    after the phase-by-phase answer is held against the plain version.  The
    table and output are allocated once (``freq_join.prepare_call``); each
    step launches one phase of the C entry (the shared path has one)."""
    pk, pf, ck, cf = args
    path, table, out = fj.prepare_call(pf, ck.shape[0], mode)
    names = {"shared": ("shared",), "child": ("fill", "build", "probe"),
             "parent": ("fill", "build", "probe", "gather")}[path.side]
    bits = {"shared": fj.ALL_PHASES, "fill": fj.FILL, "build": fj.BUILD,
            "probe": fj.PROBE, "gather": fj.GATHER}
    steps = [lambda b=bits[n]: fj.launch_phases(kernel, path, mode, pk, pf,
                                                ck, cf, table, out, b)
             for n in names]
    for step in steps:
        step()
    torch.cuda.synchronize()
    compare(torch, f"{name} call {i} phase by phase", out, plain(*args),
            join_tolerance(torch, pf, cf))
    phases = split_ms(torch, steps, queued=True)
    return {"phases": name, "index": i, "shape": [pk.shape[0], ck.shape[0]],
            "side": path.side, "slots": path.slots,
            "table_bytes": 0 if table is None else 4 * table.numel(),
            **{f"{n}_ms": statistics.median(t)
               for n, t in zip(names, phases)},
            "device_ms": time_ms(torch, lambda: wrapper(*args), queued=True),
            "ms": time_ms(torch, lambda: wrapper(*args))}


def cutoff_lines(torch, fj, kernels, dev) -> list[dict]:
    """Both sides of each of ``join_path``'s choices near where it flips,
    forced on the same inputs: the shared path against the child side for
    children of 512 to 2048 rows under parents of 100k and 8M rows (V.1's
    supplier and partsupp), and the parent side against the child side at
    equal lengths (2M × 2M).  Keys are uniform over twice the child's length.
    Each forced path's answer is held bitwise against the plain version;
    its whole call is timed unqueued (``ms``) and queued (``device_ms``)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    i32 = torch.int32

    def draw(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=i32)

    cases = [(np_, nc, ("shared", "child")) for np_ in (100_000, 8_000_000)
             for nc in (512, 1024, 2048)]
    lines = []
    for np_, nc, sides in cases + [(2_000_000, 2_000_000,
                                    ("child", "parent"))]:
        pk, ck = draw(0, 2 * nc, np_), draw(0, 2 * nc, nc)
        pf, cf = draw(0, 4, np_), draw(-2, 4, nc)
        for name, mode in (("semi_join", "any"), ("freq_join", "sum")):
            kernel = kernels[name][2]
            want = fj.freq_join_plain(pk, pf, ck, cf, mode=mode)
            line = {"cutoff": name, "shape": [np_, nc],
                    "chosen": fj.join_path(np_, nc).side}
            for side in sides:
                forced = fj.JoinPath(side, fj.table_slots(
                    np_ if side == "parent" else nc))
                path, table, out = fj.prepare_call(pf, nc, mode, forced)

                def step(path=path, table=table, out=out):
                    fj.launch_phases(kernel, path, mode, pk, pf, ck, cf,
                                     table, out, fj.ALL_PHASES)
                step()
                torch.cuda.synchronize()
                compare(torch, f"{name} cutoff {np_}x{nc} {side} side", out,
                        want, 0.0)
                line[f"{side}_ms"] = time_ms(torch, step)
                line[f"{side}_device_ms"] = time_ms(torch, step, queued=True)
            lines.append(line)
    return lines


def check_segsum(torch, kern, plain, errs, tag, keys, vals, exact=False):
    """``exact``: float32 values whose every partial sum is exact (integers
    below 2^24 in magnitude), so the sums are held bitwise."""
    got_s, got_v = kern(keys, vals)
    want_s, want_v = plain(keys, vals)
    torch.cuda.synchronize()
    errs.append(compare(torch, tag + " valid", got_v, want_v, 0.0))
    tol = 0.0 if exact else segsum_tolerance(torch, plain, keys, vals)
    errs.append(compare(torch, tag + " sums", got_s, want_s, tol))


def segsum_cases(torch, ss, errs, dev) -> list[dict]:
    """K3 cases the join-derived ones miss, held against the plain version:
    at 8M rows one key over all rows (every tile but the first walks back
    through tiles with no run start) and every row its own run (no tile
    walks back), int32 over the whole int32 range and float32 of integer
    values in {-1, 0, 1}, whose partial sums stay exact below 2^24, so both
    are held bitwise (a lost carry shows), each timed (device ms, queued);
    and views at storage offsets 1-3 (not 16-byte aligned: the kernel's
    scalar path) of lengths tile-1, tile and tile+1, checked only.  Returns one ``segsum_case`` line per timed case."""
    rng = np.random.default_rng(SEED + 3)
    n = 8_000_000
    lines = []
    for tag, keys in (("one key", torch.full((n,), 7, dtype=torch.int32,
                                            device=dev)),
                      ("every row a run", torch.arange(
                          n, dtype=torch.int32, device=dev))):
        line = {"segsum_case": tag, "shape": [n],
                "bound_ms": bound_ms(segsum_bytes(n))}
        for dt, vals in (("int32", rng.integers(-2**31, 2**31, n,
                                                dtype=np.int32)),
                         ("float32", rng.integers(-1, 2, n)
                          .astype(np.float32))):
            v = torch.tensor(vals, device=dev)
            check_segsum(torch, ss.segment_sum_cuda, ss.segment_sum_plain,
                         errs, f"segment_sum {tag} {dt}", keys, v,
                         exact=True)
            line[f"{dt}_device_ms"] = time_ms(
                torch, lambda: ss.segment_sum_cuda(keys, v), queued=True)
        lines.append(line)
    for off in (1, 2, 3):
        for m in (ss.TILE - 1, ss.TILE, ss.TILE + 1):
            kb = torch.tensor(np.sort(rng.integers(0, m // 40 + 2, m + 3))
                              .astype(np.int32), device=dev)
            for dt in (np.int32, np.float32):
                vb = torch.tensor(rng.integers(-9, 9, m + 3).astype(dt),
                                  device=dev)
                check_segsum(torch, ss.segment_sum_cuda,
                             ss.segment_sum_plain, errs,
                             f"segment_sum offset {off} length {m}",
                             kb[off:off + m], vb[off:off + m])
    return lines


def synthetic_cases(torch, make_graph_db, dev):
    """Ragged sizes; key −1 (the hash table's empty marker, kept in a side
    slot) in the parent, the child, both and neither, with int32's minimum
    and maximum beside it, on each path of the hash join; repeated parent
    keys with the table on the parent side; an empty parent and an empty
    child; int32 wrap-around and a zipf-skewed key column from
    ``make_graph_db``, each with the table on either side.  The lengths
    pick the path (``freq_join.join_path``): a child of at most 1024 rows
    is built in shared memory, else the shorter side is."""
    rng = np.random.default_rng(SEED + 1)
    i32 = np.iinfo(np.int32)
    cases = []
    for np_, nc in ((1, 1), (1000, 37), (4097, 1023), (100_003, 7),
                    (37, 262_147)):
        pk = rng.integers(-50, 50, np_).astype(np.int32)
        ck = rng.integers(-50, 50, nc).astype(np.int32)
        pk[: min(3, np_)] = [i32.min, i32.max, -1][: min(3, np_)]
        ck[: min(3, nc)] = [i32.max, -1, i32.min][: min(3, nc)]
        cases.append((f"ragged {np_}x{nc}", pk, ck,
                      rng.integers(0, 4, np_), rng.integers(-2, 4, nc)))
    for side, (np_, nc) in (("shared", (5000, 1000)),
                            ("child", (70_001, 50_000)),
                            ("parent", (50_000, 70_001))):
        for where in ("neither", "parent", "child", "both"):
            pk = rng.integers(-50, 50, np_).astype(np.int32)
            ck = rng.integers(-50, 50, nc).astype(np.int32)
            pf, cf = rng.integers(0, 4, np_), rng.integers(-2, 4, nc)
            pk[pk == -1] = 0
            ck[ck == -1] = 0
            if where in ("parent", "both"):
                pk[::97] = -1
                pf[0] = 2
            if where in ("child", "both"):
                ck[::89] = -1
                cf[::89] = rng.integers(1, 4, cf[::89].shape[0])  # live
            pk[1:3] = [i32.min, i32.max]
            ck[1:3] = [i32.max, i32.min]
            cases.append((f"key -1 in {where}, {side} side {np_}x{nc}", pk,
                          ck, pf, cf))
    cases.append(("repeated parent keys, parent side 30000x70001",
                  rng.integers(0, 10, 30_000).astype(np.int32),
                  rng.integers(0, 20, 70_001).astype(np.int32),
                  rng.integers(0, 4, 30_000), rng.integers(-2, 4, 70_001)))
    cases.append(("empty parent 0x100", np.zeros(0, np.int32),
                  rng.integers(0, 9, 100).astype(np.int32),
                  np.zeros(0, np.int64), rng.integers(0, 4, 100)))
    cases.append(("empty child 100x0", rng.integers(0, 9, 100).astype(
        np.int32), np.zeros(0, np.int32), rng.integers(0, 4, 100),
        np.zeros(0, np.int64)))
    # int32 wrap-around: frequencies over the whole int32 range
    for np_, nc in ((50_000, 70_001), (70_001, 50_000)):
        cases.append((f"wrap {np_}x{nc}",
                      rng.integers(0, 64, np_).astype(np.int32),
                      rng.integers(0, 64, nc).astype(np.int32),
                      rng.integers(i32.min, i32.max, np_),
                      rng.integers(i32.min, i32.max, nc)))
    db, _ = make_graph_db(1 << 20, 1 << 22, seed=SEED, device=dev)
    src = db["edge"].columns["src"].cpu().numpy()    # zipf-skewed
    dst = db["edge"].columns["dst"].cpu().numpy()
    pf = rng.integers(0, 4, dst.shape[0])
    cf = rng.integers(0, 4, src.shape[0])
    cases.append(("zipf child side", dst, src, pf, cf))
    cases.append(("zipf parent side", dst[:-1], src, pf[:-1], cf))
    out = []
    for tag, pk, ck, pf, cf in cases:
        t = [torch.tensor(a, device=dev) for a in (pk, ck)]
        for dt in (torch.int32, torch.float32):
            if tag.startswith("wrap") and dt == torch.float32:
                continue
            npdt = np.int32 if dt == torch.int32 else np.float32
            out.append((f"{tag} {str(dt)[6:]}", t[0],
                        torch.tensor(pf.astype(npdt), device=dev),
                        t[1], torch.tensor(cf.astype(npdt), device=dev)))
        if tag == "ragged 1000x37":
            # real-valued float32 frequencies
            out.append((f"{tag} float32 real", t[0],
                        torch.tensor(rng.random(pk.shape[0], np.float32) * 3,
                                     device=dev),
                        t[1],
                        torch.tensor(rng.random(ck.shape[0], np.float32) * 3
                                     - 1, device=dev)))
    return out


# ---------------------------------------------------------------------------
# the numpy oracle of V.1
# ---------------------------------------------------------------------------
def v1_oracle(h, regions=(2, 3), price_threshold=1200.0):
    """V.1 over host copies of the tables, with no code of the port.

    Every partsupp row joins one part, one supplier, one nation and one
    region, so a partsupp row survives iff its part passes the price filter
    and its supplier's nation lies in a selected region."""
    live_rk = h["region"]["r_regionkey"][np.isin(h["region"]["r_name"],
                                                 regions)]
    live_nk = h["nation"]["n_nationkey"][np.isin(h["nation"]["n_regionkey"],
                                                 live_rk)]
    s_key = h["supplier"]["s_suppkey"]
    live_sk = s_key[np.isin(h["supplier"]["s_nationkey"], live_nk)]
    live_pk = h["part"]["p_partkey"][h["part"]["p_price"] > price_threshold]
    ps = h["partsupp"]
    ok = np.isin(ps["ps_partkey"], live_pk) & np.isin(ps["ps_suppkey"],
                                                      live_sk)
    count = int(ok.sum())
    # surviving partsupp rows per supplier, read in supplier row order
    sk_sorted = np.sort(ps["ps_suppkey"][ok])
    per_supp = (np.searchsorted(sk_sorted, s_key, side="right")
                - np.searchsorted(sk_sorted, s_key, side="left"))
    has = per_supp > 0
    bal = h["supplier"]["s_acctbal"][has]
    w = per_supp[has].astype(np.int64)
    order = np.argsort(bal, kind="stable")
    cw = np.cumsum(w[order])
    # lower weighted median: first value whose cumulative weight reaches
    # half the total, i.e. 2·cw >= total
    median = bal[order][np.searchsorted(2 * cw, cw[-1], side="left")]
    return {"minmax": {"min(bal)": bal.min(), "max(bal)": bal.max()},
            "count": {"count(*)": count},
            "median": {"median(bal)": median}}


def profile_run(torch, fn, db) -> dict:
    """Device time by kernel name over one compiled run, from
    ``torch.profiler``: device-side events only (a CPU op's row repeats the
    time of the kernels it launched).  The idle share is the part of the
    profiled run's wall time with no device work recorded, profiler
    overhead included."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(db)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(db)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((ev.key, ev.self_device_time_total / 1e3, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return {"profiled_wall_ms": wall_ms, "device_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            "top": [[k[:60], ms, n] for k, ms, n in rows[:8]]}


def took_every_path(kernels, joins, sides, run: str) -> dict:
    """The launches of each hash-join path per kernel since the counts were
    last reset; fails unless every path was taken."""
    paths = {name: dict(kernels[name][2].paths) for name, _ in joins}
    for name, _ in joins:
        for side in sides:
            check(paths[name].get(side, 0) > 0,
                  f"{run} took no {side} path of {name}")
    return paths


def answers_equal(got: dict, want: dict) -> bool:
    for k, v in want.items():
        g = got[k].cpu().numpy()
        if g.shape != () or g.item() != np.asarray(v).item():
            return False
    return True


# ---------------------------------------------------------------------------
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import Executor, plan_query
    from repro_torch.data import make_graph_db, make_tpch_db, tpch_v1_query
    from repro_torch.kernels import _build
    from repro_torch.kernels import freq_join as fj
    from repro_torch.kernels import segment_sum as ss
    from repro_torch.kernels import semi_join as sj

    dev = "cuda"
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"setup: built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    db, schema = make_tpch_db(scale=SCALE, seed=SEED, device=dev)
    torch.cuda.synchronize()
    log(f"setup: make_tpch_db(scale={SCALE}) in "
        f"{time.perf_counter() - t0:.2f} s: " + ", ".join(
            f"{r} {t.capacity}" for r, t in db.items()))
    plans = {q: plan_query(tpch_v1_query(q), schema) for q in QUERIES}
    log("plans: " + ", ".join(f"{q} {p.mode}" for q, p in plans.items()))

    # -- the inputs the main path hands each kernel, recorded on one run --
    kernels = {"semi_join": (sj, "semi_join_cuda", sj.K1),
               "freq_join": (fj, "freq_join_cuda", fj.K2),
               "segment_sum": (ss, "segment_sum_cuda", ss.K3)}
    calls = {name: [] for name in kernels}
    originals = {name: getattr(mod, attr)
                 for name, (mod, attr, _) in kernels.items()}

    def recorder(name):
        def rec(*args):
            calls[name].append(args)
            return originals[name](*args)
        return rec

    for name, (mod, attr, _) in kernels.items():
        setattr(mod, attr, recorder(name))
    try:
        for q in QUERIES:
            Executor(db, schema).execute(plans[q])
    finally:
        for name, (mod, attr, _) in kernels.items():
            setattr(mod, attr, originals[name])
    torch.cuda.synchronize()

    # -- each kernel against its plain version, timed, on those inputs ----
    plain = {"semi_join": sj.semi_join_plain,
             "freq_join": fj.freq_join_plain,
             "segment_sum": ss.segment_sum_plain}
    kern = {"semi_join": sj.semi_join_cuda, "freq_join": fj.freq_join_cuda,
            "segment_sum": ss.segment_sum_cuda}
    errs = {name: [] for name in kernels}
    timing = {name: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                     "bytes": 0, "library_ms": None} for name in kernels}
    timing["semi_join"]["library_ms"] = 0.0
    for name, cl in calls.items():
        check(len(cl) > 0, f"main path made no {name} call")
        for i, args in enumerate(cl):
            if name == "segment_sum":
                check_segsum(torch, kern[name], plain[name], errs[name],
                             f"{name} call {i}", *args)
                nbytes = segsum_bytes(args[0].shape[0])
                shape = [args[0].shape[0]]
            else:
                check_join(torch, kern[name], plain[name], errs[name],
                           f"{name} call {i}", *args)
                nbytes = join_bytes(args[0].shape[0], args[2].shape[0])
                shape = [args[0].shape[0], args[2].shape[0]]
            k_ms = time_ms(torch, lambda: kern[name](*args))
            kd_ms = time_ms(torch, lambda: kern[name](*args), queued=True)
            p_ms = time_ms(torch, lambda: plain[name](*args))
            timing[name]["ms"] += k_ms
            timing[name]["device_ms"] += kd_ms
            timing[name]["plain_ms"] += p_ms
            timing[name]["bytes"] += nbytes
            line = {"call": name, "index": i, "shape": shape, "ms": k_ms,
                    "device_ms": kd_ms, "plain_ms": p_ms,
                    "bound_ms": bound_ms(nbytes)}
            if name == "semi_join":
                line["library_ms"] = isin_ms(torch, i, *args)
                timing[name]["library_ms"] += line["library_ms"]
            if name == "segment_sum":
                v = args[1]
                line["cumsum_ms"] = time_ms(
                    torch, lambda: torch.cumsum(v, 0, dtype=v.dtype),
                    queued=True)
            log(json.dumps(line))
    joins = (("semi_join", "any"), ("freq_join", "sum"))
    for _, _, k in kernels.values():
        k.reset_counts()
    side_hits = {}
    for tag, pk, pf, ck, cf in synthetic_cases(torch, make_graph_db, dev):
        side = fj.join_path(pk.shape[0], ck.shape[0]).side
        for name, mode in joins:
            got = check_join(torch, kern[name], plain[name], errs[name],
                             f"{name} {tag}", pk, pf, ck, cf)
            if tag.startswith("key -1 in both"):
                # parent rows with key −1 whose answer came through the
                # side slot: every one with pf > 0 in any mode
                hits = int(((pk == -1) & (got != 0)).sum())
                side_hits[f"{name} {side} {tag.split()[-1]}"] = hits
                check(hits > 0, f"{name} {tag}: no parent row with key -1 "
                      "matched through the side slot")
            if tag.startswith("zipf"):
                log(json.dumps({
                    "synthetic": tag, "kernel": name, "side": side,
                    "shape": [pk.shape[0], ck.shape[0]],
                    "ms": time_ms(torch, lambda: kern[name](pk, pf, ck, cf)),
                    "plain_ms": time_ms(
                        torch, lambda: plain[name](pk, pf, ck, cf)),
                    "bound_ms": bound_ms(join_bytes(pk.shape[0],
                                                    ck.shape[0]))}))
        keys = torch.sort(ck).values
        check_segsum(torch, ss.segment_sum_cuda, ss.segment_sum_plain,
                     errs["segment_sum"], f"segment_sum {tag}", keys, cf)
    for line in segsum_cases(torch, ss, errs["segment_sum"], dev):
        log(json.dumps(line))
    log(json.dumps({"synthetic_paths": took_every_path(
        kernels, joins, fj.SIDES, "the synthetic cases"),
        "side_slot_hits": side_hits}))
    log("kernels equal their plain versions: int32 bitwise, float32 within "
        "the stated bounds")
    for name, mode in joins:
        for i, args in enumerate(calls[name]):
            log(json.dumps(phase_line(torch, fj, kernels[name][2],
                                      kern[name], plain[name], name, i, mode,
                                      args)))
    for line in cutoff_lines(torch, fj, kernels, dev):
        log(json.dumps(line))

    # -- the main path, counted ------------------------------------------
    oracle = v1_oracle({r: {c: t.cpu().numpy() for c, t in tab.columns.items()}
                        for r, tab in db.items()})
    for _, _, k in kernels.values():
        k.reset_counts()
    query_lines = []
    for q in QUERIES:
        ex = Executor(db, schema)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ex.execute(plans[q])
        torch.cuda.synchronize()
        exec_s = time.perf_counter() - t0
        fn = ex.compile(plans[q])
        run_s = []
        for _ in range(COMPILED_RUNS):
            t0 = time.perf_counter()
            out = fn(db)
            torch.cuda.synchronize()
            run_s.append(time.perf_counter() - t0)
        want = oracle[q]
        check(answers_equal(res, want), f"{q} execute: {res} != {want}")
        check(answers_equal(out, want), f"{q} compile: {out} != {want}")
        query_lines.append({
            "query": q, "mode": plans[q].mode,
            "answer": {k: np.asarray(v).item() for k, v in want.items()},
            "execute_ms": exec_s * 1e3,
            "compiled_ms": [s * 1e3 for s in run_s],
            "peak_live_tuples": res["__stats__"].peak_tuples})
    launches = {name: k.launches for name, (_, _, k) in kernels.items()}
    for name, n in launches.items():
        check(n > 0, f"the main path launched {name} no time")
    paths = took_every_path(kernels, joins, fj.SIDES, "the main path")
    log(f"main path launches: {launches}")
    log(json.dumps({"main_path_paths": paths}))

    for line in query_lines:
        log(json.dumps(line))
    for q in QUERIES:
        prof = profile_run(torch, Executor(db, schema).compile(plans[q]), db)
        log(json.dumps({"profile": q, **prof}))
    rows = []
    for name in kernels:
        source, replaces = KERNEL_META[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": max(errs[name]),
                     "ms": timing[name]["ms"],
                     "device_ms": timing[name]["device_ms"],
                     "plain_ms": timing[name]["plain_ms"],
                     "bound_ms": bound_ms(timing[name]["bytes"]),
                     "bound_by": "bytes",
                     "library_ms": timing[name]["library_ms"],
                     "calls_timed": len(calls[name])})
    log(smi)
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
