"""Kernel autotuner: measured configuration search per shape bucket.

The port of the JAX package's ``repro.kernels.autotune``.  The three kernels
(freq_join K2, semi_join K1, segment_sum K3) take a ``KernelConfig``; this
module measures every candidate configuration on synthetic inputs shaped
like a serving bucket, gates each on BITWISE equality with the untuned
(``DEFAULT_CONFIG``) answer, and keeps the winner in a ``TuneTable`` keyed
by ``(kernel, shape bucket, backend)``.

Shape buckets are the serving tier's power-of-two buckets
(``repro_torch.tables.table.bucket_capacity``): a table growing inside its
bucket hits the same tune entry, so within-bucket growth never retunes.

The backend tag names what runs and at which width (``backend_tag``):

* ``"plain"`` — CPU tensors, the kernels' plain PyTorch versions.  Joins
  tune ``dense_ratio``, where the plain FreqJoin hands the sort +
  searchsorted pipeline over to one scatter-add into a domain-sized
  accumulator, scored over a grid of key-domain probes spanning that
  crossover; the JAX package's ``"xla"`` candidates.  ``segment_sum`` has
  one candidate and is not measured.
* ``"cuda"`` — CUDA tensors with int32/float32 frequencies: the Hopper
  knobs of the hand-written kernels (``KernelConfig`` below).
* ``"cuda_wide"`` — CUDA tensors with int64/float64 frequencies, which run
  the kernels' 64-bit instances with int64 keys.  The JAX package has no
  width in its key (its 64-bit setting is process-wide); here the width
  belongs to each ``Executor``, and a config chosen at one width never
  serves the other.

Persistence lives one layer up (``repro_torch.service.tune_store``, the
JAX package's on-disk format); ``KernelTuner`` consults the table, then the
store, then a measured search, so a warm-started service measures nothing
(``tune_searches == 0``).

Timing uses ``time.perf_counter`` directly, each timed call enclosed in
``torch.cuda.synchronize`` of the inputs' device: this is the kernel
layer's offline calibration path, not the serving tier.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

KERNELS = ("freq_join", "semi_join", "segment_sum")
BACKENDS = ("plain", "cuda", "cuda_wide")

# structural (non-tunable) bound on the dense-domain accumulator: int32
# packed keys cannot index past 2^31 regardless of measured preference
DENSE_DOMAIN_CAP = 1 << 31


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One point in the kernel config space: ints only (the tune store
    writes each field with ``int``), frozen and hashable.

    Hopper knobs of the hand-written kernels (``csrc/``):

    * ``join_threads`` — threads per block of every hash-join launch (K1,
      K2): 128, 256 or 512;
    * ``shared_max_rows`` — ``freq_join.join_path``'s cut-off: a child of
      at most this many rows is built in each block's shared memory;
    * ``slot_factor`` — the hash table holds the power of two ≥
      ``slot_factor · rows`` slots (2 is load factor ½);
    * ``seg_items`` — K3's rows per thread, 4, 8 or 16 (a tile is 256 ×
      ``seg_items`` rows);
    * ``seg_min_blocks`` — K3's blocks per SM in ``__launch_bounds__`` for
      32-bit keys and values; the instances with a 64-bit key or value ask
      for half as many (at least 1).

    The plain FreqJoin's dense-domain crossover: ``dense_ratio`` /
    ``dense_floor`` (the JAX package's ``max(4·nc, 2^20)``;
    ``dense_ratio <= 0`` disables the dense path).

    The defaults reproduce the untuned launches exactly: 256 threads, 1024
    rows, load factor ½, 8 rows a thread at 6 blocks per SM (3 for the
    64-bit instances).
    """

    join_threads: int = 256
    shared_max_rows: int = 1024
    slot_factor: int = 2
    seg_items: int = 8
    seg_min_blocks: int = 6
    dense_ratio: int = 4
    dense_floor: int = 1 << 20

    def dense_ok(self, domain: int | None, n_child: int) -> bool:
        """Should the plain FreqJoin take the scatter-add dense path for
        this (domain, child-size)?"""
        return (domain is not None and self.dense_ratio > 0
                and domain <= max(self.dense_ratio * n_child,
                                  self.dense_floor)
                and domain < DENSE_DOMAIN_CAP)


DEFAULT_CONFIG = KernelConfig()

# the card's join candidates besides the default, per knob: shared-path
# cut-offs (2048 at the narrow width only: a wide 2048-row child's table
# does not fit a block's 48 KiB) and a load factor of ¼; the block sizes and
# K3's instances are those the C entries have (freq_join.JOIN_THREADS,
# segment_sum.INSTANCES)
JOIN_ROWS = (0, 512)
JOIN_ROWS_NARROW = (2048,)
JOIN_SLOT_FACTORS = (4,)


def backend_tag(device, wide: bool) -> str:
    """The tune key's backend for tensors on ``device`` at the width
    ``wide`` (64-bit frequencies)."""
    if torch.device(device).type == "cpu":
        return "plain"
    return "cuda_wide" if wide else "cuda"


def _pow2(n: int) -> int:
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


def bucket_shape(*sizes: int) -> tuple[int, ...]:
    """Round each size up to a power of two — the tune-table key uses the
    same bucket boundaries as the serving tier's shape buckets, so a
    bucket-padded input always looks up the entry its bucket was tuned
    at."""
    return tuple(_pow2(s) for s in sizes)


def _fit_shared(cfg: KernelConfig, mode: str, wide: bool) -> KernelConfig:
    """``cfg`` with its shared-path cut-off halved until the largest shared
    child's table fits the C entry's bound (the slot factor grows it)."""
    from repro_torch.kernels import freq_join as fj  # imports this module

    rows = cfg.shared_max_rows
    while rows > 0 and not fj.shared_table_fits(
            fj.table_slots(rows, cfg.slot_factor), mode, wide):
        rows //= 2
    return dataclasses.replace(cfg, shared_max_rows=rows)


def candidate_configs(kernel: str, backend: str) -> list[KernelConfig]:
    """The measured search space for one (kernel, backend).  Always
    includes ``DEFAULT_CONFIG`` (so the search can never do worse than
    untuned), keeps irrelevant fields at their defaults, and on the card
    yields only configs whose every call the C entries accept."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    out = [DEFAULT_CONFIG]
    if backend == "plain":
        if kernel in ("freq_join", "semi_join"):
            for ratio in (0, 32, 256):
                out.append(dataclasses.replace(DEFAULT_CONFIG,
                                               dense_ratio=ratio))
        return out
    # deferred: both modules import this one
    from repro_torch.kernels import freq_join, segment_sum

    wide = backend == "cuda_wide"
    if kernel == "segment_sum":
        for items, blocks in segment_sum.INSTANCES:
            cfg = dataclasses.replace(DEFAULT_CONFIG, seg_items=items,
                                      seg_min_blocks=blocks)
            if cfg not in out:
                out.append(cfg)
        return out
    mode = "any" if kernel == "semi_join" else "sum"
    rows = JOIN_ROWS + (() if wide else JOIN_ROWS_NARROW)
    knobs = ([{"shared_max_rows": r} for r in rows]
             + [{"slot_factor": f} for f in JOIN_SLOT_FACTORS]
             + [{"join_threads": t} for t in freq_join.JOIN_THREADS])
    for kw in knobs:
        cfg = _fit_shared(dataclasses.replace(DEFAULT_CONFIG, **kw), mode,
                          wide)
        if cfg not in out:
            out.append(cfg)
    return out


class TuneTable:
    """In-memory tuned-config table: (kernel, shape bucket, backend) →
    ``KernelConfig``.  Lookups bucket the raw sizes, so callers pass the
    concrete (already bucket-padded) lengths they are about to run.  Misses
    return None — the kernel ops treat that as ``DEFAULT_CONFIG``.
    Thread-safe: the serving tier reads it from concurrent compile threads
    while ``autotune()`` installs entries."""

    def __init__(self):
        self._d: dict[tuple, KernelConfig] = {}
        self._lock = threading.Lock()

    @staticmethod
    def key(kernel: str, shape, backend: str) -> tuple:
        return (kernel, bucket_shape(*shape), backend)

    def lookup(self, kernel: str, shape, backend: str) -> KernelConfig | None:
        with self._lock:
            return self._d.get(self.key(kernel, shape, backend))

    def install(self, kernel: str, shape, backend: str,
                config: KernelConfig) -> None:
        with self._lock:
            self._d[self.key(kernel, shape, backend)] = config

    def entries(self) -> list[tuple[tuple, KernelConfig]]:
        with self._lock:
            return list(self._d.items())

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)


# --------------------------------------------------------------------------
# synthetic inputs + measurement
# --------------------------------------------------------------------------
def _tensors(arrays, wide: bool, device) -> tuple[torch.Tensor, ...]:
    dt = np.int64 if wide else np.int32
    return tuple(torch.from_numpy(a.astype(dt)).to(device) for a in arrays)


def _synth_join(shape: tuple[int, int], domain: int, *, wide: bool = False,
                device="cpu"):
    """Deterministic join inputs for one bucket, the JAX package's numpy
    draws from its seeds: keys uniform over ``domain`` (with a sprinkle of
    out-of-range and negative child keys, so the bitwise gate also covers
    masking and the table's key −1), frequencies small non-negative ints,
    so float and integer sums are exact at every width.  int32, or int64
    when ``wide``; on ``device``."""
    np_, nc = shape
    rng = np.random.default_rng((np_, nc, domain, 0xA11CE))
    pk = rng.integers(0, domain, np_, dtype=np.int64).astype(np.int32)
    ck = rng.integers(0, domain, nc, dtype=np.int64).astype(np.int32)
    oob = rng.random(nc) < 0.01
    ck = np.where(oob, np.where(rng.random(nc) < 0.5, -1, domain), ck)
    pf = rng.integers(1, 4, np_, dtype=np.int32)
    cf = rng.integers(0, 4, nc, dtype=np.int32)
    return _tensors((pk, pf, ck, cf), wide, device)


def _synth_segment(shape: tuple[int, ...], *, wide: bool = False,
                   device="cpu"):
    """Sorted keys and small int values for one bucket, the JAX package's
    draws; int32, or int64 when ``wide``; on ``device``."""
    (n,) = shape
    rng = np.random.default_rng((n, 0x5E6))
    keys = np.sort(rng.integers(0, max(2, n // 4), n,
                                dtype=np.int64).astype(np.int32))
    vals = rng.integers(0, 100, n, dtype=np.int64).astype(np.int32)
    return _tensors((keys, vals), wide, device)


def _domain_probes(nc: int) -> list[int]:
    """Key-domain grid spanning the dense/sort crossover for a child bucket
    of ``nc`` rows — from comfortably dense to clearly sparse, capped below
    the structural 2^31 accumulator bound.  On the card they vary the
    hash table's duplicate keys and misses."""
    probes = []
    for mult in (1, 8, 16, 64):
        d = nc * mult
        if 2 <= d < DENSE_DOMAIN_CAP:
            probes.append(d)
    return probes or [max(2, nc)]


def _syncer(device) -> Callable[[], None]:
    if device is not None and torch.device(device).type == "cuda":
        dev = torch.device(device)
        return lambda: torch.cuda.synchronize(dev)
    return lambda: None


def measure(fn: Callable[[], Any], repeats: int = 3, device=None) -> float:
    """Best-of-``repeats`` wall-clock seconds for ``fn`` (one warm-up call
    first, so a first launch's library load never pollutes the
    comparison); each timed call is enclosed in a synchronisation of
    ``device`` (the inputs' device, never the thread's current one) when
    it is a CUDA device."""
    sync = _syncer(device)
    fn()
    sync()
    best = float("inf")
    for _ in range(max(1, repeats)):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def _leaves(x) -> list:
    return [t for v in x for t in _leaves(v)] \
        if isinstance(x, (tuple, list)) else [x]


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's raw bits (so −0.0 and NaNs compare as bits)."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t


def _bitwise_equal(a, b) -> bool:
    flat_a, flat_b = _leaves(a), _leaves(b)
    if len(flat_a) != len(flat_b):
        return False
    return all(x.dtype == y.dtype and x.shape == y.shape
               and bool(torch.equal(_bits(x), _bits(y)))
               for x, y in zip(flat_a, flat_b))


class KernelTuner:
    """Measured config search with a store-backed warm path.

    Resolution order in ``ensure``: in-memory ``TuneTable`` → persistent
    ``TuneStore`` (when constructed with one) → measured ``search``.  Only
    the last bumps ``tune_searches`` — a warm-started service whose store
    already holds every bucket reports ``tune_searches == 0``.

    ``backend`` is the tune key's tag (``backend_tag``); the synthetic
    inputs go to ``device`` (default: the CPU for ``"plain"``, else the
    current CUDA device) at the backend's width.  ``row(name, us,
    derived)`` is an optional timing sink, so benchmark runs can record the
    full candidate trajectory.
    """

    def __init__(self, store=None, *, backend: str = "plain", device=None,
                 repeats: int = 3, row: Callable[..., Any] | None = None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        self.table = TuneTable()
        self.store = store
        self.backend = backend
        self.device = torch.device(
            device if device is not None
            else "cpu" if backend == "plain" else "cuda")
        self.repeats = repeats
        self.row = row
        self._lock = threading.Lock()
        self._local = threading.local()   # .draws: see shared_draws
        self.counters = {
            "tune_searches": 0,        # measured searches actually run
            "tune_candidates": 0,      # candidate configs measured
            "tune_gate_rejects": 0,    # candidates failing the bitwise gate
            "tune_store_hits": 0,      # configs loaded from the store
            "tune_installs": 0,        # entries installed into the table
        }

    # ---- resolution ------------------------------------------------------
    def load_persisted(self) -> int:
        """Install every valid store entry for this tuner's backend into
        the table (warm start).  Returns the number installed."""
        if self.store is None:
            return 0
        n = 0
        for (kernel, shape, backend), config in self.store.load_all():
            if backend != self.backend:
                continue
            self.table.install(kernel, shape, backend, config)
            n += 1
        if n:
            with self._lock:
                self.counters["tune_store_hits"] += n
                self.counters["tune_installs"] += n
        return n

    def adopt(self, entries) -> int:
        """Install ``TuneTable.entries()`` of another tuner (a mesh
        service's rank 0) into the table, as its winners.  Returns the
        number installed."""
        n = 0
        for (kernel, shape, backend), config in entries:
            self.table.install(kernel, shape, backend, config)
            n += 1
        with self._lock:
            self.counters["tune_installs"] += n
        return n

    def ensure(self, kernel: str, shape) -> KernelConfig:
        """The tuned config for (kernel, bucket(shape)) — from the table,
        the store, or a fresh measured search (persisted on the way
        out)."""
        bshape = bucket_shape(*shape)
        cfg = self.table.lookup(kernel, bshape, self.backend)
        if cfg is not None:
            return cfg
        if self.store is not None:
            cfg = self.store.load(kernel, bshape, self.backend)
            if cfg is not None:
                self.table.install(kernel, bshape, self.backend, cfg)
                with self._lock:
                    self.counters["tune_store_hits"] += 1
                    self.counters["tune_installs"] += 1
                return cfg
        cfg, measurements = self.search(kernel, bshape)
        self.table.install(kernel, bshape, self.backend, cfg)
        with self._lock:
            self.counters["tune_installs"] += 1
        if self.store is not None:
            self.store.save(kernel, bshape, self.backend, cfg,
                            measurements=measurements)
        return cfg

    @contextlib.contextmanager
    def shared_draws(self):
        """Inside the block, this thread's join searches of one bucket share
        their synthetic inputs (``freq_join`` and ``semi_join`` draw the
        same arrays): a bucket's draws are kept until another bucket's are
        made, and dropped when the block ends."""
        self._local.draws = {}
        try:
            yield
        finally:
            self._local.draws = None

    def _join_inputs(self, bshape: tuple[int, ...]) -> list:
        """[(domain, (pk, pf, ck, cf))] per domain probe of a join bucket,
        drawn at the backend's width on the tuner's device."""
        draws = getattr(self._local, "draws", None)
        if draws is not None and bshape in draws:
            return draws[bshape]
        wide = self.backend == "cuda_wide"
        out = [(dom, _synth_join(bshape, dom, wide=wide, device=self.device))
               for dom in _domain_probes(bshape[1])]
        if draws is not None:
            draws.clear()
            draws[bshape] = out
        return out

    # ---- search ----------------------------------------------------------
    def search(self, kernel: str,
               shape) -> tuple[KernelConfig, dict[str, float]]:
        """Measure every candidate for (kernel, bucket(shape)); return
        (winner, per-candidate best seconds).  Every candidate's answer is
        bitwise-gated against ``DEFAULT_CONFIG``'s; a gate failure drops
        the candidate (counted), it can never win.  A candidate that fails
        to launch raises (``KernelLaunchError``) out of the search."""
        bshape = bucket_shape(*shape)
        cands = candidate_configs(kernel, self.backend)
        with self._lock:
            self.counters["tune_searches"] += 1
        if len(cands) == 1:
            return cands[0], {}

        scenarios = self.scenarios(kernel, bshape)
        baselines = [fn(DEFAULT_CONFIG) for _, fn in scenarios]
        best_cfg, best_t = DEFAULT_CONFIG, float("inf")
        measurements: dict[str, float] = {}
        for cfg in cands:
            with self._lock:
                self.counters["tune_candidates"] += 1
            total = 0.0
            ok = True
            for (label, fn), base in zip(scenarios, baselines):
                if not _bitwise_equal(fn(cfg), base):
                    ok = False
                    break
                total += measure(lambda: fn(cfg), self.repeats, self.device)
            tag = self.cfg_tag(kernel, cfg)
            if not ok:
                # zero-drift gate: a diverging candidate is dropped on the
                # spot — it can never win, however fast it measured
                with self._lock:
                    self.counters["tune_gate_rejects"] += 1
                continue
            measurements[tag] = total
            if self.row is not None:
                self.row(f"tune/{kernel}/{self.backend}/"
                         f"{'x'.join(map(str, bshape))}/{tag}",
                         total * 1e6, {"candidates": len(cands)})
            if total < best_t:
                best_cfg, best_t = cfg, total
        return best_cfg, measurements

    def scenarios(self, kernel: str, bshape: tuple[int, ...]):
        """(label, config → answer) closures the search scores a candidate
        on, their inputs drawn before any is timed and bound as each
        closure's ``args`` default.  Joins run one scenario per domain
        probe."""
        from repro_torch.kernels import ops  # ops imports KernelConfig

        if kernel in ("freq_join", "semi_join"):
            mode = "any" if kernel == "semi_join" else "sum"
            out = []
            for dom, args in self._join_inputs(bshape):

                def fn(cfg, args=args, dom=dom):
                    return ops.freq_join(*args, mode=mode, domain=dom,
                                         config=cfg)

                out.append((f"domain{dom}", fn))
            return out
        inputs = _synth_segment(bshape, wide=self.backend == "cuda_wide",
                                device=self.device)

        def fn(cfg, args=inputs):
            return ops.segment_sum_sorted(*args, config=cfg)

        return [("sorted", fn)]

    @staticmethod
    def cfg_tag(kernel: str, cfg: KernelConfig) -> str:
        if kernel == "segment_sum":
            return f"items{cfg.seg_items}_blocks{cfg.seg_min_blocks}"
        return (f"threads{cfg.join_threads}_shared{cfg.shared_max_rows}"
                f"_slots{cfg.slot_factor}_ratio{cfg.dense_ratio}")

    # ---- observability ---------------------------------------------------
    def metrics(self) -> dict[str, int]:
        with self._lock:
            out = dict(self.counters)
        out["tune_entries"] = len(self.table)
        return out


TUNE_ZEROS = {
    "tune_searches": 0, "tune_candidates": 0, "tune_gate_rejects": 0,
    "tune_store_hits": 0, "tune_installs": 0, "tune_entries": 0,
}
