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

Two more phases drive the materialising baselines (``MaterializeJoinOp``,
plain PyTorch sorts and gathers on the card), each run with the kernels'
counts set to 0 just before it and read just after.  ``baseline``: V.1 under
``ref`` and ``opt``, with and without FK/PK degradation, at the same scale;
answers must equal the numpy oracle and ``ExecStats.steps`` the JAX
package's (``V1_BASELINE_STEPS``).  ``fig6``: the paper's Fig. 6 peak tuples
on ``make_graph_db(5000, 60000, seed=2)`` (path-2/3/4) and
``make_stats_db(5000, 20000, 100000, 60000)`` (stats-full) under ``ref``,
``opt`` and ``opt_plus`` with ``oom_guard=50_000_000``: each path row's
peaks, guard trip and COUNT as ``path_oracle`` (numpy on the run's edge
list) gives them, stats-full's as the JAX package gives them at int32
(``FIG6_STATS_ROW``), each guard trip a ``MaterialisationLimit`` raised
before the refused expansion could be allocated, Opt⁺ at most the largest
base relation, and one COUNT across the modes that finish.  Each case
prints its wall ms, the device memory it allocated above what was live
before it, and its kernel launches; every kernel call of its counted run
(K1 under Opt with FK/PK, K3 in Opt's regroup, K2 and K3 under Opt⁺) is
recorded and its output held against the plain version on the same inputs.

The last phase, ``x64``, runs the same paths with 64-bit frequencies (the
JAX package's x64 setting: int64 keys, int64/float64 frequencies, K1–K3's
64-bit instances), counted on its own.  V.1 at the same scale with int64
frequencies: each kernel call of one pass held and timed beside its bytes
bound at 64-bit widths (``call_x64``), then 0MA/Opt⁺ through ``execute``
and ``compile`` and Ref/Opt (± FK/PK) through ``execute``, every answer
equal to the oracle in the reference's x64 dtypes (COUNT int64), steps and
peaks equal to the int32 run's.  Fig. 6 with int64 frequencies: each COUNT
``path_oracle``'s unwrapped, peaks and guard trips the int32 rows'.  Table
2 (``benchmarks/graph_counting.py``: ``make_graph_db(20000, 200000)``,
path-3/4/5 and tree-1/2/3, float64, Opt⁺ compiled, Ref/Opt under its
20M-tuple guard), each run held against the same Executor on CPU copies
of the tables.  Synthetic 64-bit cases on every path × mode × key dtype ×
frequency dtype (key −1, int64's extremes, keys equal in their low 32
bits, int64 sums that wrap past 2^63) and K3 at 8M rows (one key, every
row a run; int64 and float64).  Every kernel call of the phase is held
against its plain version: int64 bitwise, float64 within the stated
bounds.

Prints the card's name and power limit, one JSON line per kernel call, per
phase split, per cut-off case and per timed K3 case (``segsum_case``), one
JSON line per query with its times, one per query with
its device time by kernel from ``torch.profiler``, one per ``baseline`` and
``fig6`` case, one per ``x64`` call, query and case (each with the card's
name and power limit), one JSON line ``{"kernels_x64": [...]}`` with the
64-bit instances' times, bounds and launches, one JSON line
``{"kernels": [...]}`` with each kernel's time, bound, plain-version and
library time on the int32 main path, and as its last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without
that line.  Needs a CUDA GPU of compute capability 9.0 (sm_90a) and nvcc.
"""

from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SCALE = 100_000            # supplier 100k, part 2M, partsupp 8M rows
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
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

BASELINE_MODES = (("ref", False), ("ref", True), ("opt", False), ("opt", True))
BASELINE_REPS = 3

# ExecStats.steps of V.1 under the baselines at make_tpch_db(scale=100000,
# seed=0), as the JAX package records them on the CPU (this script never
# loads that package; the command does, by module name):
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c '
#   from importlib import import_module as im
#   c, r = im("repro.core"), im("repro.data.relational")
#   db, s = r.make_tpch_db(scale=100000)
#   for q in ("minmax", "count", "median"):
#       for m in ("ref", "opt"):
#           for f in (False, True):
#               p = c.plan_query(r.tpch_v1_query(q), s, mode=m, use_fkpk=f)
#               print(q, m, f, c.Executor(db, s).execute(p)["__stats__"].steps)'
# minmax and median are rooted at supplier, count at partsupp; a ref plan
# is the same with and without FK/PK degradation.
_STEPS_S = {
    "ref": [("scan(s)", 100000), ("scan(ps)", 8000000),
            ("join(s⋈ps)", 8000000), ("scan(p)", 866676),
            ("join(s⋈p)", 3464696), ("scan(n)", 25), ("join(s⋈n)", 3464696),
            ("scan(r)", 2), ("join(s⋈r)", 1388068)],
    "opt": [("scan(s)", 100000), ("scan(n)", 25), ("scan(r)", 2),
            ("join(n⋈r)", 10), ("regroup(n)", 10), ("join(s⋈n)", 40057),
            ("regroup(s)", 40057), ("scan(ps)", 8000000), ("scan(p)", 866676),
            ("join(ps⋈p)", 3464696), ("regroup(ps)", 3464696),
            ("join(s⋈ps)", 1388068), ("regroup(s)", 40057)],
    "opt_fkpk": [("scan(s)", 100000), ("scan(n)", 25), ("scan(r)", 2),
                 ("semijoin(n⋉r)", 10), ("semijoin(s⋉n)", 40057),
                 ("scan(ps)", 8000000), ("scan(p)", 866676),
                 ("semijoin(ps⋉p)", 3464696), ("join(s⋈ps)", 1388068),
                 ("regroup(s)", 40057)],
}
_STEPS_PS = {
    "ref": [("scan(ps)", 8000000), ("scan(s)", 100000),
            ("join(ps⋈s)", 8000000), ("scan(n)", 25),
            ("join(ps⋈n)", 8000000), ("scan(r)", 2), ("join(ps⋈r)", 3205148),
            ("scan(p)", 866676), ("join(ps⋈p)", 1388068)],
    "opt": [("scan(ps)", 8000000), ("scan(p)", 866676),
            ("join(ps⋈p)", 3464696), ("regroup(ps)", 3464696),
            ("scan(s)", 100000), ("scan(n)", 25), ("scan(r)", 2),
            ("join(n⋈r)", 10), ("regroup(n)", 10), ("join(s⋈n)", 40057),
            ("regroup(s)", 40057), ("join(ps⋈s)", 1388068),
            ("regroup(ps)", 1388068)],
    "opt_fkpk": [("scan(ps)", 8000000), ("scan(p)", 866676),
                 ("semijoin(ps⋉p)", 3464696), ("scan(s)", 100000),
                 ("scan(n)", 25), ("scan(r)", 2), ("semijoin(n⋉r)", 10),
                 ("semijoin(s⋉n)", 40057), ("semijoin(ps⋉s)", 1388068)],
}
V1_BASELINE_STEPS = {
    (q, mode, fkpk): (_STEPS_PS if q == "count" else _STEPS_S)[
        "opt_fkpk" if (mode, fkpk) == ("opt", True) else mode]
    for q in QUERIES for mode, fkpk in BASELINE_MODES}

# Fig. 6 at the JAX package's sizes (benchmarks/materialisation.py), int32.
# The graph's zipf sources come from numpy's Generator.zipf, whose stream
# differs between numpy versions, so the path rows are held against
# path_oracle on the run's own edge list.  stats-full's data are drawn with
# Generator.integers only; its row (largest base relation, peak tuples per
# mode, COUNT(*)) is the JAX package's on the CPU with
# Executor(oom_guard=FIG6_GUARD).
FIG6_GUARD = 50_000_000
FIG6_MODES = ("ref", "opt", "opt_plus")
FIG6_GRAPH = {"n_nodes": 5_000, "n_edges": 60_000, "seed": 2}
FIG6_STATS = {"n_users": 5_000, "n_posts": 20_000, "n_comments": 100_000,
              "n_votes": 60_000}
FIG6_STATS_ROW = (100000, {"ref": 299887, "opt": 100000, "opt_plus": 100000},
                  299887)


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


def join_bytes(np_: int, nc: int, kbytes: int = 4, fbytes: int = 4) -> int:
    # pk, pf read and out written per parent row; ck, cf read per child row:
    # 12 and 8 B at int32, 24 and 16 B with int64 keys and frequencies
    return np_ * (kbytes + 2 * fbytes) + nc * (kbytes + fbytes)


def segsum_bytes(n: int, kbytes: int = 4, vbytes: int = 4) -> int:
    # keys, values read and sums written, valid written (1 B): 13 B a row
    # at int32, 25 B with int64 keys and 64-bit values
    return n * (kbytes + 2 * vbytes + 1)


def call_bytes(name: str, args) -> int:
    """The bytes bound's numerator of one kernel call, at its dtypes."""
    if name == "segment_sum":
        k, v = args
        return segsum_bytes(k.shape[0], k.element_size(), v.element_size())
    pk, pf, ck, _ = args
    return join_bytes(pk.shape[0], ck.shape[0], pk.element_size(),
                      pf.element_size())


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
    """Float FreqJoin: the plain version takes differences of a prefix sum
    over the whole sorted child in the frequencies' dtype, so each result
    carries the rounding of that prefix: bound 4·eps·Σ|cf|·|pf|, eps of
    float32 or float64.  Zero for ints."""
    if not pf.dtype.is_floating_point:
        return 0.0
    eps = torch.finfo(pf.dtype).eps
    return 4 * eps * float(cf.abs().double().sum()) * pf.abs().double()


def segsum_tolerance(torch, plain_ss, keys, vals):
    """Float segment sum: both versions add a run in different orders, so
    a run's total may differ by len·eps·Σ|v| over the run, eps of float32
    or float64.  Zero for ints."""
    if not vals.dtype.is_floating_point:
        return 0.0
    abs_sum, _ = plain_ss(keys, vals.abs())
    length, _ = plain_ss(keys, torch.ones_like(vals))
    eps = torch.finfo(vals.dtype).eps
    return 2 * eps * length.double() * abs_sum.double()


def hold_join(torch, plain, errs, tag, got, pk, pf, ck, cf):
    """Hold a K1/K2 output ``got`` against the plain version's on the same
    inputs."""
    want = plain(pk, pf, ck, cf)
    torch.cuda.synchronize()
    errs.append(compare(torch, tag, got, want, join_tolerance(torch, pf, cf)))
    return got


def check_join(torch, kern, plain, errs, tag, pk, pf, ck, cf):
    return hold_join(torch, plain, errs, tag, kern(pk, pf, ck, cf),
                     pk, pf, ck, cf)


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
    hold_segsum(torch, plain, errs, tag, kern(keys, vals), keys, vals, exact)


def hold_segsum(torch, plain, errs, tag, got, keys, vals, exact=False):
    """Hold a K3 output ``got`` = (sums, valid) against the plain
    version's on the same inputs."""
    got_s, got_v = got
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


def kernel_calls(torch, calls, kern, plain, errs, key="call",
                 extra=None) -> dict:
    """Each recorded call of each kernel (``calls[name]``, a list of its
    arguments) held against the plain version on the same inputs and timed:
    one JSON line per call under ``key``, with ``extra`` merged in, beside
    its bytes bound at the call's dtypes (K1 also beside ``torch.isin``, K3
    beside ``torch.cumsum``).  Returns the sums over each kernel's calls."""
    timing = {name: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                     "bytes": 0, "library_ms": None} for name in calls}
    timing["semi_join"]["library_ms"] = 0.0
    for name, cl in calls.items():
        check(len(cl) > 0, f"main path made no {name} call")
        for i, args in enumerate(cl):
            tag = f"{name} {key} {i}"
            if name == "segment_sum":
                check_segsum(torch, kern[name], plain[name], errs[name], tag,
                             *args)
                shape = [args[0].shape[0]]
            else:
                check_join(torch, kern[name], plain[name], errs[name], tag,
                           *args)
                shape = [args[0].shape[0], args[2].shape[0]]
            nbytes = call_bytes(name, args)
            k_ms = time_ms(torch, lambda: kern[name](*args))
            kd_ms = time_ms(torch, lambda: kern[name](*args), queued=True)
            p_ms = time_ms(torch, lambda: plain[name](*args))
            timing[name]["ms"] += k_ms
            timing[name]["device_ms"] += kd_ms
            timing[name]["plain_ms"] += p_ms
            timing[name]["bytes"] += nbytes
            line = {key: name, "index": i, "shape": shape, "ms": k_ms,
                    "device_ms": kd_ms, "plain_ms": p_ms,
                    "bound_ms": bound_ms(nbytes), **(extra or {})}
            if name == "semi_join":
                line["library_ms"] = isin_ms(torch, i, *args)
                timing[name]["library_ms"] += line["library_ms"]
            if name == "segment_sum":
                v = args[1]
                line["cumsum_ms"] = time_ms(
                    torch, lambda: torch.cumsum(v, 0, dtype=v.dtype),
                    queued=True)
            log(json.dumps(line))
    return timing


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
    """Device time by kernel name over one run of ``fn(db)``, from
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


def answers_equal(got: dict, want: dict, dtypes: dict | None = None) -> bool:
    """Every answer of ``want`` equals ``got``'s, a scalar, and where
    ``dtypes`` names its dtype, is of that dtype."""
    for k, v in want.items():
        if dtypes is not None and got[k].dtype != dtypes[k]:
            return False
        g = got[k].cpu().numpy()
        if g.shape != () or g.item() != np.asarray(v).item():
            return False
    return True


@contextlib.contextmanager
def routed(kernels, hook):
    """While the block runs, each kernel's wrapper, looked up on its module
    at call time, goes through ``hook(name, wrapper, args)``."""
    originals = {name: getattr(mod, attr)
                 for name, (mod, attr, _) in kernels.items()}
    for name, (mod, attr, _) in kernels.items():
        setattr(mod, attr, lambda *args, name=name: hook(
            name, originals[name], args))
    try:
        yield
    finally:
        for name, (mod, attr, _) in kernels.items():
            setattr(mod, attr, originals[name])


def copied(x, device):
    """A tensor, or a tuple of them, copied to ``device``."""
    if isinstance(x, tuple):
        return tuple(copied(t, device) for t in x)
    return x.to(device)


def hold_calls(torch, plain, errs, tag, seen, dev) -> dict:
    """Hold each recorded kernel call's output against the plain version on
    the card, on the same inputs (int32 bitwise, float32 within the stated
    bounds); returns the calls held per kernel."""
    held = {}
    for name, args, out in seen:
        i = held[name] = held.get(name, 0) + 1
        hold = hold_segsum if name == "segment_sum" else hold_join
        hold(torch, plain[name], errs[name], f"{tag} {name} call {i - 1}",
             copied(out, dev), *copied(args, dev))
    return held


# ---------------------------------------------------------------------------
# the materialising baselines
# ---------------------------------------------------------------------------
def measured(torch, kernels, plain, errs, tag, fn, dev,
             reps: int = BASELINE_REPS):
    """``fn()`` once, with every kernel's counts set to 0 just before it and
    read just after, and the device memory it allocates above what was live
    before it (``max_memory_allocated``); then ``reps`` more calls, each
    timed on the host's clock to ``torch.cuda.synchronize()``.  Every kernel
    call of the first run is recorded (inputs and output copied to the
    host, so the record holds no device memory) and afterwards held against
    the plain version.  Returns the first call's result and a line with the
    launches, the calls held, ``peak_bytes`` and the median ``ms``."""
    seen = []

    def keep(name, wrapper, args):
        out = wrapper(*args)
        seen.append((name, copied(args, "cpu"), copied(out, "cpu")))
        return out

    for _, _, k in kernels.values():
        k.reset_counts()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with routed(kernels, keep):
        out = fn()
    torch.cuda.synchronize()
    line = {"peak_bytes": torch.cuda.max_memory_allocated() - base,
            "launches": {name: k.launches
                         for name, (_, _, k) in kernels.items()}}
    line["held"] = hold_calls(torch, plain, errs, tag, seen, dev)
    for name, n in line["launches"].items():
        check(n == 0 or line["held"].get(name, 0) > 0,
              f"{tag}: {name} launched {n} times, no call held")
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    line["ms"] = statistics.median(ms)
    return out, line


def largest_join(steps) -> int:
    return max((n for name, n in steps if name.startswith("join(")),
               default=0)


def baseline_lines(torch, tc, kernels, plain, errs, db, schema, plans,
                   oracle, tpch_v1_query, dev) -> list[dict]:
    """V.1 under Ref and Opt, with and without FK/PK degradation, through
    ``Executor.execute``: answers held against the numpy oracle, steps
    against the JAX package's and each kernel call against its plain
    version, with one ``torch.profiler`` run of each; beside each, the
    query's 0MA/Opt⁺ plan."""
    lines = []
    ex = tc.Executor(db, schema)
    for q in QUERIES:
        res, fast = measured(torch, kernels, plain, errs,
                             f"baseline {q} {plans[q].mode}",
                             lambda: ex.execute(plans[q]), dev)
        check(answers_equal(res, oracle[q]), f"{q} {plans[q].mode}: {res}")
        fast.update(mode=plans[q].mode,
                    peak_tuples=res["__stats__"].peak_tuples)
        for mode, fkpk in BASELINE_MODES:
            plan = tc.plan_query(tpch_v1_query(q), schema, mode=mode,
                                 use_fkpk=fkpk)
            tag = f"baseline {q} {mode} use_fkpk={fkpk}"
            res, line = measured(torch, kernels, plain, errs, tag,
                                 lambda: ex.execute(plan), dev)
            steps = res["__stats__"].steps
            check(answers_equal(res, oracle[q]),
                  f"{tag}: {res} != {oracle[q]}")
            check(steps == V1_BASELINE_STEPS[q, mode, fkpk],
                  f"{tag}: steps {steps}")
            prof = profile_run(torch, lambda _: ex.execute(plan), db)
            lines.append({
                "baseline": q, "mode": mode, "use_fkpk": fkpk,
                "answer": {k: np.asarray(v).item()
                           for k, v in oracle[q].items()},
                "peak_tuples": res["__stats__"].peak_tuples,
                "largest_join": largest_join(steps), **line,
                "profile": {**prof, "top": prof["top"][:4]},
                "zero_materialisation": fast})
    return lines


def wrap32(n: int) -> int:
    return (n + 2**31) % 2**32 - 2**31


def path_oracle(src, dst, k: int, guard: int, wrap: bool = True):
    """Fig. 6's path-k row by numpy on one edge list, independent of the
    port.  The Ref plan roots at e0 and joins e1, ..., ek onto it in turn,
    so its j-th join holds the (j+1)-edge paths; the Opt plan joins e(k-1),
    ..., e0 onto the leaf's rows in turn and regroups each join to the
    parent's distinct (src, dst) pairs; Opt⁺ holds no more than one scanned
    relation.  Returns (peak per mode, None where the guard trips; the
    tuples the guard refused, or None; COUNT(*) at int32, or unwrapped
    with ``wrap=False``)."""
    n = int(max(src.max(), dst.max())) + 1
    outdeg = np.bincount(src, minlength=n).astype(np.int64)
    paths = np.bincount(dst, minlength=n).astype(np.int64)  # 1-edge paths
    ref_peak, refused = len(src), None
    for _ in range(k):
        total = int(paths @ outdeg)      # paths one edge longer, by end
        if refused is None and total > guard:
            refused = total
        ref_peak = max(ref_peak, total)
        longer = np.zeros(n, np.int64)
        np.add.at(longer, dst, paths[src])
        paths = longer
    pairs = src.astype(np.int64) * n + dst
    opt_peak, child_src = len(src), src
    for _ in range(k):
        matches = np.bincount(child_src, minlength=n)[dst]
        kept = np.unique(pairs[matches > 0])
        opt_peak = max(opt_peak, int(matches.sum()), kept.size)
        child_src = kept // n
    peaks = {"ref": None if refused else ref_peak, "opt": opt_peak,
             "opt_plus": len(src)}
    return peaks, refused, wrap32(total) if wrap else total


def fig6_lines(torch, tc, data, kernels, plain, errs, dev,
               freq_dtype=None, same_as=None) -> list[dict]:
    """Fig. 6's rows at the JAX package's sizes under ``oom_guard``: each
    peak, guard trip and COUNT as ``path_oracle`` gives them for the path
    rows and as ``FIG6_STATS_ROW`` gives them for stats-full, and each
    kernel call against its plain version.  A trip must come before the
    refused expansion is allocated: the device memory the run allocated
    stays below the bytes of a row index and a frequency (12 or 16) for
    each refused tuple.  ``freq_dtype`` torch.int64 runs the rows in 64 bits: each COUNT
    is then ``path_oracle``'s unwrapped, in int64, and each peak and guard
    trip must equal the row of ``same_as`` (the int32 lines) of its query
    and mode."""
    wide = freq_dtype is not None
    freq_dtype = freq_dtype or torch.int32
    graph = data.make_graph_db(**FIG6_GRAPH, device=dev)
    stats_db = data.make_stats_db(**FIG6_STATS, device=dev)
    src, dst = (graph[0]["edge"].columns[c].cpu().numpy()
                for c in ("src", "dst"))
    lines = [{"fig6_data": {"numpy": np.__version__}}]
    cases = [(f"path-{k}", graph, data.path_query(k),
              (FIG6_GRAPH["n_edges"],
               *path_oracle(src, dst, k, FIG6_GUARD, wrap=not wide)))
             for k in (2, 3, 4)]
    earlier = {(r["fig6"], r["mode"]): r for r in same_as or () if "fig6" in r}
    base_max, peaks, count = FIG6_STATS_ROW
    cases.append(("stats-full", stats_db, data.stats_count_query(),
                  (base_max, peaks, None, count)))
    for name, (db, schema), query, want in cases:
        base_max, peaks, refused_want, count = want
        got_base = max(int(t.live_count()) for t in db.values())
        check(got_base == base_max, f"fig6 {name}: base max {got_base}")
        ex = tc.Executor(db, schema, freq_dtype=freq_dtype,
                         oom_guard=FIG6_GUARD)
        got, counts = {}, {}
        for mode in FIG6_MODES:
            plan = tc.plan_query(query, schema, mode=mode)

            def run(plan=plan):
                stats = tc.ExecStats()
                try:
                    return ex.execute(plan, stats), stats
                except tc.MaterialisationLimit as err:
                    return err, stats

            tag = f"fig6 {name} {mode}" + (" x64" if wide else "")
            (out, stats), line = measured(torch, kernels, plain, errs, tag,
                                          run, dev)
            row = {"fig6": name, "mode": mode, "base_max": base_max,
                   "freq_dtype": str(freq_dtype)[6:]}
            if peaks[mode] is None:
                check(isinstance(out, tc.MaterialisationLimit),
                      f"{tag}: the guard did not trip")
                refused = int(re.search(r"would materialise (\d+) tuples",
                                        str(out)).group(1))
                check(refused_want in (None, refused),
                      f"{tag}: refused {refused}, oracle {refused_want}")
                check(line["peak_bytes"] < (8 + freq_dtype.itemsize)
                      * refused, f"{tag}: {line['peak_bytes']} bytes "
                      f"allocated before the guard refused {refused} tuples")
                row.update(peak_tuples=None, guard_trip=refused,
                           steps_before_trip=stats.steps)
            else:
                check(isinstance(out, dict), f"{tag}: {out}")
                got[mode] = stats.peak_tuples
                check(got[mode] == peaks[mode], f"{tag}: peak {got[mode]}")
                check(out["count(*)"].dtype == freq_dtype,
                      f"{tag}: COUNT dtype {out['count(*)'].dtype}")
                counts[mode] = int(out["count(*)"])
                row.update(peak_tuples=got[mode], count=counts[mode])
            if earlier:
                same = earlier[name, mode]
                check(all(row.get(k) == same.get(k) for k in (
                    "peak_tuples", "guard_trip", "steps_before_trip")),
                      f"{tag}: peak or trip differs from the int32 run's")
            lines.append({**row, **line})
        check(got["opt_plus"] <= base_max, f"fig6 {name}: Opt⁺ above base")
        check(set(counts.values()) == {count}, f"fig6 {name}: {counts}")
    return lines


# ---------------------------------------------------------------------------
# 64-bit frequencies: the JAX package's x64 setting
# ---------------------------------------------------------------------------
# benchmarks/graph_counting.py's Table 2 run, float64 frequencies: its
# graph, its queries and its guard (OOM_GUARD)
TABLE2_GRAPH = {"n_nodes": 20_000, "n_edges": 200_000, "seed": 0}
TABLE2_QUERIES = (("path-3", "path", 3), ("path-4", "path", 4),
                  ("path-5", "path", 5), ("tree-1", "tree", 1),
                  ("tree-2", "tree", 2), ("tree-3", "tree", 3))
TABLE2_GUARD = 20_000_000
# A float64 COUNT past 2^53 is rounded, and the card and the CPU add in
# other orders: each edge's sums round by at most eps per add, at most
# 2·10^5 adds (the edge relation's rows) on each of at most 6 edges and
# the final sum, 1.4·10^6 · 1.1·10^-16 ≈ 1.6·10^-10 of the count.
F64_COUNT_RTOL = 1e-9
JOINS = (("semi_join", "any"), ("freq_join", "sum"))


def x64_v1_lines(torch, tc, fj, kernels, kern, plain, errs, db, schema,
                 plans, oracle, main_steps, tpch_v1_query, card, dev):
    """V.1 at the main path's scale with int64 frequencies.  First each
    kernel call of one pass is recorded, held against its plain version
    and timed (``call_x64`` lines, bytes bound at the calls' dtypes).  Then
    the counted run: every kernel's counts set to 0, each query's 0MA/Opt⁺
    plan through ``execute`` and ``compile``, its answers equal to the
    oracle in the reference's x64 dtypes (COUNT int64, MIN/MAX/MEDIAN the
    value column's float32), its steps and peak equal to the int32 run's,
    every hash-join path taken; the counts read just after.  Last, Ref and
    Opt (± FK/PK) through ``execute``, each kernel call held.  Returns the
    lines, the timing per kernel, the counted launches and the calls timed
    per kernel."""
    i64 = torch.int64
    bal = db["supplier"].columns["s_acctbal"].dtype
    dtypes = {q: {k: i64 if k == "count(*)" else bal for k in oracle[q]}
              for q in QUERIES}
    calls = {name: [] for name in kernels}

    def keep(name, wrapper, args):
        calls[name].append(args)
        return wrapper(*args)

    with routed(kernels, keep):
        for q in QUERIES:
            tc.Executor(db, schema, freq_dtype=i64).execute(plans[q])
    torch.cuda.synchronize()
    timing = kernel_calls(torch, calls, kern, plain, errs, "call_x64",
                          {"freq_dtype": "int64", **card})
    calls_timed = {name: len(cl) for name, cl in calls.items()}
    calls.clear()

    for _, _, k in kernels.values():
        k.reset_counts()
    lines = []
    for q in QUERIES:
        before = {name: k.launches for name, (_, _, k) in kernels.items()}
        ex = tc.Executor(db, schema, freq_dtype=i64)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ex.execute(plans[q])
        torch.cuda.synchronize()
        exec_ms = (time.perf_counter() - t0) * 1e3
        fn = ex.compile(plans[q])
        run_ms = []
        for _ in range(COMPILED_RUNS):
            t0 = time.perf_counter()
            out = fn(db)
            torch.cuda.synchronize()
            run_ms.append((time.perf_counter() - t0) * 1e3)
        tag = f"x64 {q} {plans[q].mode}"
        check(answers_equal(res, oracle[q], dtypes[q]),
              f"{tag} execute: {res} != {oracle[q]}")
        check(answers_equal(out, oracle[q], dtypes[q]),
              f"{tag} compile: {out} != {oracle[q]}")
        check(res["__stats__"].steps == main_steps[q],
              f"{tag}: steps {res['__stats__'].steps}")
        lines.append({
            "query_x64": q, "mode": plans[q].mode, "freq_dtype": "int64",
            "answer": {k: np.asarray(v).item() for k, v in oracle[q].items()},
            "dtypes": {k: str(v)[6:] for k, v in dtypes[q].items()},
            "execute_ms": exec_ms, "compiled_ms": run_ms,
            "peak_live_tuples": res["__stats__"].peak_tuples,
            "launches": {name: k.launches - before[name]
                         for name, (_, _, k) in kernels.items()}, **card})
    launches = {name: k.launches for name, (_, _, k) in kernels.items()}
    for name, n in launches.items():
        check(n > 0, f"the 64-bit main path launched {name} no time")
    paths = took_every_path(kernels, JOINS, fj.SIDES, "the 64-bit main path")
    for line, q in zip(lines, QUERIES):
        fn = tc.Executor(db, schema, freq_dtype=i64).compile(plans[q])
        prof = profile_run(torch, fn, db)
        line.update(device_ms=prof["device_ms"],
                    profile={**prof, "top": prof["top"][:4]})
    lines.append({"main_path_x64_launches": launches, "paths": paths,
                  **card})

    ex = tc.Executor(db, schema, freq_dtype=i64)
    for q in QUERIES:
        for mode, fkpk in BASELINE_MODES:
            plan = tc.plan_query(tpch_v1_query(q), schema, mode=mode,
                                 use_fkpk=fkpk)
            tag = f"x64 baseline {q} {mode} use_fkpk={fkpk}"
            res, line = measured(torch, kernels, plain, errs, tag,
                                 lambda: ex.execute(plan), dev)
            steps = res["__stats__"].steps
            check(answers_equal(res, oracle[q], dtypes[q]),
                  f"{tag}: {res} != {oracle[q]}")
            check(steps == V1_BASELINE_STEPS[q, mode, fkpk],
                  f"{tag}: steps {steps}")
            lines.append({"baseline_x64": q, "mode": mode,
                          "use_fkpk": fkpk, "freq_dtype": "int64",
                          "peak_tuples": res["__stats__"].peak_tuples,
                          "largest_join": largest_join(steps), **line,
                          **card})
    return lines, timing, launches, calls_timed


def table2_lines(torch, tc, data, kernels, plain, errs, dev, card):
    """Table 2 (``benchmarks/graph_counting.py``) in float64 at the
    benchmark's own size: path-3/4/5 and tree-1/2/3, Opt⁺ through
    ``compile``, Ref and Opt through ``execute`` under its guard.  The
    card's numpy draws another zipf graph than the JAX package's machine,
    so each run is held against the same Executor on CPU copies of the
    same tables (the plain versions): COUNT equal below 2^53 and within
    ``F64_COUNT_RTOL`` above, steps equal, a guard trip with the same
    message after the same steps; each kernel call held."""
    from repro_torch.tables.table import Table
    gdb, schema = data.make_graph_db(**TABLE2_GRAPH, device=dev)
    cdb = {r: Table({c: t.cpu() for c, t in tab.columns.items()},
                    tab.freq.cpu()) for r, tab in gdb.items()}
    f64 = torch.float64
    lines = [{"table2_data": {"numpy": np.__version__, **TABLE2_GRAPH,
                              "guard": TABLE2_GUARD}}]

    def runner(db, plan):
        ex = tc.Executor(db, schema, freq_dtype=f64, oom_guard=TABLE2_GUARD)
        if plan.mode == "opt_plus":
            fn = ex.jittable().compile(plan)
            return lambda: (fn(db), None)

        def run():
            stats = tc.ExecStats()
            try:
                return ex.execute(plan, stats), stats
            except tc.MaterialisationLimit as err:
                return err, stats
        return run

    for name, kind, k in TABLE2_QUERIES:
        query = data.path_query(k) if kind == "path" else data.tree_query(k)
        counts = {}
        for mode in ("opt_plus", "opt", "ref"):
            plan = tc.plan_query(query, schema, mode=mode)
            tag = f"table2 {name} {mode}"
            want, wstats = runner(cdb, plan)()
            (got, stats), line = measured(torch, kernels, plain, errs, tag,
                                          runner(gdb, plan), dev)
            row = {"table2": name, "mode": mode, "freq_dtype": "float64"}
            if wstats is not None:
                check(stats.steps == wstats.steps, f"{tag}: steps "
                      f"{stats.steps} != the CPU's {wstats.steps}")
            if isinstance(want, tc.MaterialisationLimit):
                check(isinstance(got, tc.MaterialisationLimit) and
                      str(got) == str(want), f"{tag}: {got} != {want}")
                row.update(guard_trip=str(want), steps_before_trip=stats.steps)
            else:
                check(isinstance(got, dict), f"{tag}: {got}")
                c, w = got["count(*)"], float(want["count(*)"])
                check(c.dtype == f64, f"{tag}: COUNT dtype {c.dtype}")
                c = float(c)
                check(c == w if w < 2**53 else
                      abs(c - w) <= F64_COUNT_RTOL * w,
                      f"{tag}: COUNT {c} != the CPU's {w}")
                counts[mode] = c
                row.update(count=c, cpu_count=w, peak_tuples=None
                           if stats is None else stats.peak_tuples)
            lines.append({**row, **line, **card})
        top = max(counts.values())
        check(all(abs(c - top) <= F64_COUNT_RTOL * top
                  for c in counts.values()),
              f"table2 {name}: the modes' COUNTs differ: {counts}")
    return lines


def x64_synthetic_lines(torch, fj, ss, kernels, kern, plain, errs, dev,
                        card) -> list[dict]:
    """The 64-bit instances on synthetic cases, held against the plain
    versions: every hash-join path × mode × key dtype (int32, int64) ×
    frequency dtype (int64, float64), with key −1 (the empty marker, in a
    side slot) in the parent, the child, both or neither, the key dtype's
    extremes, for int64 keys keys equal in their low 32 bits (k + 2^32
    beside k), and int64 frequencies over the whole range, whose sums wrap
    past 2^63; parent keys k + 2^32 against child keys k, which must match
    nothing; K3 over each case's sorted child keys; K3 at 8M rows with one
    key and with every row its own run, int64 keys, int64 values over the
    whole range and float64 integers in {-1, 0, 1} (every partial sum
    exact), held bitwise and timed (device ms) beside the 25-byte bound;
    and 8-byte views at an odd storage offset (the scalar path)."""
    rng = np.random.default_rng(SEED + 4)
    i64 = np.iinfo(np.int64)
    for _, _, k in kernels.values():
        k.reset_counts()
    side_hits, n_cases = {}, 0
    shapes = (("shared", (5000, 1000)), ("child", (70_001, 50_000)),
              ("parent", (50_000, 70_001)))
    for side, (np_, nc) in shapes:
        check(fj.join_path(np_, nc).side == side, f"{side}: path")
        for where in ("neither", "parent", "child", "both"):
            for kdt in (np.int32, np.int64):
                info = np.iinfo(kdt)
                pk = rng.integers(-50, 50, np_).astype(kdt)
                ck = rng.integers(-50, 50, nc).astype(kdt)
                pk[pk == -1] = 0
                ck[ck == -1] = 0
                if kdt == np.int64:
                    pk[::3] += np.int64(1) << 32
                    ck[::5] += np.int64(1) << 32
                if where in ("parent", "both"):
                    pk[::97] = -1
                if where in ("child", "both"):
                    ck[::89] = -1
                pk[1:3] = [info.min, info.max]
                ck[1:3] = [info.max, info.min]
                for fdt in (np.int64, np.float64):
                    if where == "neither" and fdt == np.int64:
                        pf = rng.integers(i64.min, i64.max, np_)
                        cf = rng.integers(i64.min, i64.max, nc)
                    else:
                        pf = rng.integers(0, 4, np_).astype(fdt)
                        cf = rng.integers(-2, 4, nc).astype(fdt)
                        cf[ck == -1] = 2
                    t = [torch.tensor(a, device=dev) for a in (pk, pf, ck,
                                                                cf)]
                    tag = (f"x64 {side} key -1 in {where} "
                           f"{np.dtype(kdt).name}/{np.dtype(fdt).name}")
                    for name, _ in JOINS:
                        got = check_join(torch, kern[name], plain[name],
                                         errs[name], f"{name} {tag}", *t)
                        n_cases += 1
                        if where == "both":
                            hits = int(((t[0] == -1) & (got != 0)).sum())
                            side_hits[f"{name} {tag}"] = hits
                            check(hits > 0, f"{name} {tag}: no parent row "
                                  "with key -1 matched through the side slot")
                    check_segsum(torch, ss.segment_sum_cuda,
                                 ss.segment_sum_plain, errs["segment_sum"],
                                 f"segment_sum {tag}",
                                 torch.sort(t[2]).values, t[3])
        pk = torch.tensor(rng.integers(0, 100, np_) + (1 << 32), device=dev)
        ck = torch.tensor(rng.integers(0, 100, nc), device=dev)
        ones = torch.ones(np_, dtype=torch.int64, device=dev)
        for name, _ in JOINS:
            got = check_join(torch, kern[name], plain[name], errs[name],
                             f"{name} x64 {side} low-32-bit aliases", pk,
                             ones, ck, torch.ones_like(ck))
            check(not bool(got.any()), f"{name} {side}: a key k + 2^32 "
                  "matched a key k")
    paths = took_every_path(kernels, JOINS, fj.SIDES,
                            "the 64-bit synthetic cases")
    lines = [{"synthetic_x64": n_cases, "paths": paths,
              "side_slot_hits": side_hits}]
    n = 8_000_000
    for tag, keys in (("one key", torch.full((n,), 7 << 32, dtype=torch.int64,
                                            device=dev)),
                      ("every row a run", torch.arange(
                          n, dtype=torch.int64, device=dev) << 32)):
        line = {"segsum_case_x64": tag, "shape": [n],
                "bound_ms": bound_ms(segsum_bytes(n, 8, 8)), **card}
        for dt, vals in (("int64", rng.integers(i64.min, i64.max, n)),
                         ("float64", rng.integers(-1, 2, n)
                          .astype(np.float64))):
            v = torch.tensor(vals, device=dev)
            check_segsum(torch, ss.segment_sum_cuda, ss.segment_sum_plain,
                         errs["segment_sum"], f"segment_sum {tag} {dt}",
                         keys, v, exact=True)
            line[f"{dt}_device_ms"] = time_ms(
                torch, lambda: ss.segment_sum_cuda(keys, v), queued=True)
            line[f"{dt}_plain_ms"] = time_ms(
                torch, lambda: ss.segment_sum_plain(keys, v))
        lines.append(line)
    for m in (ss.TILE - 1, ss.TILE + 1, 3 * ss.TILE + 5):
        kb = torch.tensor(np.sort(rng.integers(0, m // 40 + 2, m + 1)) << 33,
                          device=dev)
        for dt in (np.int64, np.float64):
            vb = torch.tensor(rng.integers(-9, 9, m + 1).astype(dt),
                              device=dev)
            check_segsum(torch, ss.segment_sum_cuda, ss.segment_sum_plain,
                         errs["segment_sum"], f"segment_sum x64 offset 1 "
                         f"length {m}", kb[1:], vb[1:])
    return lines


# ---------------------------------------------------------------------------
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import core as tc
    from repro_torch import data
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

    def keep(name, wrapper, args):
        calls[name].append(args)
        return wrapper(*args)

    with routed(kernels, keep):
        for q in QUERIES:
            Executor(db, schema).execute(plans[q])
    torch.cuda.synchronize()

    # -- each kernel against its plain version, timed, on those inputs ----
    plain = {"semi_join": sj.semi_join_plain,
             "freq_join": fj.freq_join_plain,
             "segment_sum": ss.segment_sum_plain}
    kern = {"semi_join": sj.semi_join_cuda, "freq_join": fj.freq_join_cuda,
            "segment_sum": ss.segment_sum_cuda}
    errs = {name: [] for name in kernels}
    timing = kernel_calls(torch, calls, kern, plain, errs)
    joins = JOINS
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
    query_lines, main_steps = [], {}
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
        main_steps[q] = res["__stats__"].steps
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

    # -- the materialising baselines, counted on their own -----------------
    calls_timed = {name: len(cl) for name, cl in calls.items()}
    calls.clear()          # the main path's kernel inputs
    torch.cuda.synchronize()
    log(json.dumps({"baseline_setup": {
        "db_bytes": sum(t.numel() * t.element_size() for tab in db.values()
                        for t in (*tab.columns.values(), tab.freq)),
        "allocated_bytes": torch.cuda.memory_allocated()}}))
    for line in baseline_lines(torch, tc, kernels, plain, errs, db, schema,
                               plans, oracle, tpch_v1_query, dev):
        log(json.dumps(line))
    fig6_32 = fig6_lines(torch, tc, data, kernels, plain, errs, dev)
    for line in fig6_32:
        log(json.dumps(line))
    log("the baseline and fig6 phases' kernel calls equal their plain "
        "versions")

    # -- 64-bit frequencies, counted on their own ----------------------------
    card = {"card": smi}
    errs64 = {name: [] for name in kernels}
    t0 = time.perf_counter()
    v1_64, timing64, launches64, calls64 = x64_v1_lines(
        torch, tc, fj, kernels, kern, plain, errs64, db, schema, plans,
        oracle, main_steps, tpch_v1_query, card, dev)
    for line in v1_64:
        log(json.dumps(line))
    for line in fig6_lines(torch, tc, data, kernels, plain, errs64, dev,
                           freq_dtype=torch.int64, same_as=fig6_32):
        log(json.dumps({**line, **card}))
    for line in table2_lines(torch, tc, data, kernels, plain, errs64, dev,
                             card):
        log(json.dumps(line))
    for line in x64_synthetic_lines(torch, fj, ss, kernels, kern, plain,
                                    errs64, dev, card):
        log(json.dumps(line))
    log(f"x64: every 64-bit kernel call equals its plain version (int64 "
        f"bitwise, float64 within the stated bounds) in "
        f"{time.perf_counter() - t0:.1f} s")

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
                     "calls_timed": calls_timed[name]})
    rows64 = []
    for name in kernels:
        source, replaces = KERNEL_META[name]
        rows64.append({"name": name, "route": "cuda", "source": source,
                       "replaces": replaces, "freq_dtype": "int64",
                       "launches": launches64[name],
                       "max_abs_err": max(errs64[name]),
                       "ms": timing64[name]["ms"],
                       "device_ms": timing64[name]["device_ms"],
                       "plain_ms": timing64[name]["plain_ms"],
                       "bound_ms": bound_ms(timing64[name]["bytes"]),
                       "bound_by": "bytes",
                       "library_ms": timing64[name]["library_ms"],
                       "calls_timed": calls64[name]})
    log(json.dumps({"kernels_x64": rows64, **card}))
    log(smi)
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
