"""Persistent tuned-kernel-config store: autotuning survives restarts.

The port of the JAX package's ``repro.service.tune_store``, in its on-disk
format (version 1, the same paths, header and checksum).  A measured kernel
search (``repro_torch.kernels.autotune.KernelTuner``) costs seconds per
(kernel, shape-bucket) — far too much to repeat on every process start.  This store persists the winners under the same
``cache_dir`` as the plan store, with the same discipline:

* one JSON entry per (kernel, shape bucket, backend), living in a
  directory scoped by the serving topology (``(axis_names,
  shard_counts)``, ``()`` locally) — services sharded differently tuned
  against different per-shard shapes, so their entries never alias::

      <root>/tune/<topology-hash>/<key-hash>.json

* a header the loader verifies before trusting the body:
  ``format_version`` (schema bumps can never mis-parse old entries),
  the full key fields (kernel/shape/backend/topology — a hand-moved file
  whose name happens to match is still rejected), and
  ``payload_sha256`` over the canonical payload encoding (truncation or
  bit-flips fail closed);

* corruption-tolerant loads: ANY failure counts
  ``tune_persist_corrupt_skipped``, evicts the damaged file best-effort
  (own directory only — ``load_all`` during import/export never empties
  a foreign store), and returns None so the caller simply re-tunes;

* atomic, best-effort writes (temp file + ``os.replace``): a read-only
  or full disk counts ``tune_persist_write_errors`` and degrades the
  service to default/in-memory configs — persistence is an optimisation,
  never a request-path dependency.

Both packages may share one ``cache_dir``: an entry's path hashes its
backend, so ``load`` never reaches another backend's file, and this
store's ``load_all`` skips, without evicting or counting, every entry whose
backend is not one of the port's (``"plain"``, ``"cuda"``,
``"cuda_wide"``) — the JAX package's entries stay for it to read.

Invalidation is structural, not manual: entries key off the SAME
power-of-two shape buckets as the plan cache, so data growth inside a
bucket keeps hitting the tuned entry, while crossing a bucket boundary
looks up (and, cold, re-tunes) the next bucket's entry.  A
``format_version`` bump or topology change orphans old entries without
ever serving them.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import threading
from pathlib import Path

from repro_torch.kernels.autotune import BACKENDS, KernelConfig

TUNE_FORMAT_VERSION = 1


def _canonical_body(payload: dict) -> bytes:
    return json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode()


def _topology_tag(topology: tuple) -> str:
    return hashlib.sha256(repr(tuple(topology)).encode()).hexdigest()[:16]


class TuneStore:
    """Versioned, checksummed, corruption-tolerant tuned-config
    persistence.  Thread-safe: a lock guards only the counters."""

    def __init__(self, root, topology: tuple = (), *,
                 read_only: bool = False):
        self.root = Path(root)
        self.topology = tuple(topology)
        # read_only: loads as usual; nothing under root is created, written
        # or evicted (a mesh service's ranks other than 0 read rank 0's)
        self.read_only = read_only
        self.tune_dir = self.root / "tune" / _topology_tag(self.topology)
        self._lock = threading.Lock()
        self.counters = {
            "tune_persist_hits": 0,
            "tune_persist_misses": 0,
            "tune_persist_writes": 0,
            "tune_persist_corrupt_skipped": 0,
            "tune_persist_write_errors": 0,
        }
        try:
            if not read_only:
                self.tune_dir.mkdir(parents=True, exist_ok=True)
        except OSError:
            # unwritable root: loads miss, saves count errors — the
            # service degrades to default configs, never crashes
            pass
        try:
            self._entries = sum(1 for _ in self.tune_dir.glob("*.json"))
        except OSError:
            self._entries = 0

    # ---- keys ------------------------------------------------------------
    def _key_fields(self, kernel: str, shape, backend: str) -> dict:
        return {
            "kernel": kernel,
            "shape": [int(s) for s in shape],
            "backend": backend,
            "topology": [list(part) for part in self.topology],
        }

    def _path(self, kernel: str, shape, backend: str) -> Path:
        if backend not in BACKENDS:
            # the path would be another package's entry, which a load here
            # would evict as corrupt (its config is not the port's)
            raise ValueError(f"unknown backend {backend!r}: the port's are "
                             f"{BACKENDS}")
        ident = repr((kernel, tuple(int(s) for s in shape), backend,
                      self.topology))
        return self.tune_dir / (
            hashlib.sha256(ident.encode()).hexdigest()[:32] + ".json")

    def __len__(self) -> int:
        with self._lock:
            return self._entries

    # ---- load ------------------------------------------------------------
    def load(self, kernel: str, shape, backend: str) -> KernelConfig | None:
        """The persisted config for one tune key, or None (re-tune).
        Damaged entries are evicted and counted, never raised."""
        cfg, corrupt = self._load(self._path(kernel, shape, backend),
                                  self._key_fields(kernel, shape, backend))
        with self._lock:
            if cfg is not None:
                self.counters["tune_persist_hits"] += 1
            else:
                self.counters["tune_persist_misses"] += 1
                if corrupt:
                    self.counters["tune_persist_corrupt_skipped"] += 1
        return cfg

    def _load(self, path: Path, key_fields: dict | None, *,
              evict: bool = True) -> tuple[KernelConfig | None, bool]:
        """(config, was_corrupt) — counter-free core shared by ``load``
        and ``load_all``.  ``evict`` deletes damaged entries in the
        store's OWN directory; imports from a foreign directory skip in
        place instead (a mismatch there is the reader's, not damage)."""
        try:
            raw = path.read_bytes()
        except OSError:
            return None, False
        try:
            doc = json.loads(raw)
            if doc["format_version"] != TUNE_FORMAT_VERSION:
                raise ValueError(
                    f"format_version {doc['format_version']} != "
                    f"{TUNE_FORMAT_VERSION}")
            if key_fields is not None:
                for field, want in key_fields.items():
                    if doc[field] != want:
                        raise ValueError(f"entry {field} mismatch")
            payload = doc["payload"]
            if hashlib.sha256(_canonical_body(payload)).hexdigest() \
                    != doc["payload_sha256"]:
                raise ValueError("payload checksum mismatch")
            fields = {f.name for f in dataclasses.fields(KernelConfig)}
            raw_cfg = payload["config"]
            if set(raw_cfg) != fields:
                raise ValueError("config field mismatch")
            return KernelConfig(**{k: int(v) for k, v in raw_cfg.items()}), \
                False
        except Exception:
            if evict and not self.read_only:
                try:
                    path.unlink()
                except OSError:
                    pass
                else:
                    with self._lock:
                        self._entries = max(0, self._entries - 1)
            return None, True

    @staticmethod
    def _foreign(path: Path) -> bool:
        """Is ``path`` a readable entry of another package's backend?"""
        try:
            return json.loads(path.read_bytes())["backend"] not in BACKENDS
        except Exception:
            return False

    def load_all(self):
        """Yield ((kernel, shape, backend), config) for every valid
        entry of the port's backends — warm starts and cache
        import/export.  Unreadable entries are skipped in place, NOT
        evicted (the directory may be a foreign store being imported);
        another package's entries are skipped uncounted."""
        try:
            paths = sorted(self.tune_dir.glob("*.json"))
        except OSError:
            return
        for path in paths:
            if self._foreign(path):
                continue
            cfg, corrupt = self._load(path, None, evict=False)
            if cfg is None:
                if corrupt:
                    with self._lock:
                        self.counters["tune_persist_corrupt_skipped"] += 1
                continue
            try:
                doc = json.loads(path.read_bytes())
                key = (doc["kernel"],
                       tuple(int(s) for s in doc["shape"]),
                       doc["backend"])
            except Exception:
                with self._lock:
                    self.counters["tune_persist_corrupt_skipped"] += 1
                continue
            yield key, cfg

    # ---- save ------------------------------------------------------------
    def save(self, kernel: str, shape, backend: str, config: KernelConfig,
             *, measurements: dict | None = None) -> bool:
        """Persist one winner (atomically).  Returns False — without
        raising — when the write fails: tuning degrades to in-memory —
        or the store is read-only."""
        if self.read_only:
            return False
        payload = {
            "config": dataclasses.asdict(config),
            "measurements": {k: float(v)
                             for k, v in (measurements or {}).items()},
        }
        body = _canonical_body(payload)
        doc = {
            "format_version": TUNE_FORMAT_VERSION,
            **self._key_fields(kernel, shape, backend),
            "payload_sha256": hashlib.sha256(body).hexdigest(),
            "payload": payload,
        }
        path = self._path(kernel, shape, backend)
        tmp = None
        try:
            existed = path.exists()
            fd, tmp = tempfile.mkstemp(dir=str(self.tune_dir),
                                       prefix=f".{path.stem[:16]}.",
                                       suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=1)
            os.replace(tmp, path)        # atomic: readers never see a torn
            tmp = None                   # entry, only old or new
        except OSError:
            with self._lock:
                self.counters["tune_persist_write_errors"] += 1
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            return False
        with self._lock:
            self.counters["tune_persist_writes"] += 1
            if not existed:
                self._entries += 1
        return True

    # ---- observability ---------------------------------------------------
    def metrics(self) -> dict[str, int]:
        with self._lock:
            out = dict(self.counters)
        out["tune_persist_entries"] = len(self)
        return out


TUNE_PERSIST_ZEROS = {
    "tune_persist_hits": 0, "tune_persist_misses": 0,
    "tune_persist_writes": 0, "tune_persist_corrupt_skipped": 0,
    "tune_persist_write_errors": 0, "tune_persist_entries": 0,
}
