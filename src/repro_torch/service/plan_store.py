"""Persistent plan store: cross-process warm starts for the serving tier.

The whole premise of serving guarded aggregate plans is that the evaluation
*structure* — not any materialised intermediate — is the reusable artefact.
In-process, the plan cache already keeps one ``PhysicalPlan`` per query
structure; this module extends that to process lifetimes: plans are
serialised (``repro_torch.core.plan.plan_to_payload``) into a
content-addressed on-disk store keyed by query fingerprint, so a restarted
service re-plans nothing it has seen before.  Entries are byte-compatible
with the JAX package's ``repro.service.plan_store``: the same payload, the
same header, the same fingerprints.

Store layout (one directory per store; ``<sfp>`` is a prefix of the
store fingerprint — schema structure + planner configuration — so
differently-configured services share a ``cache_dir`` without collisions)::

    <root>/plans/<sfp>/<fingerprint>.json   one plan per query structure

Each entry is a JSON document with a header the loader verifies before
trusting the body:

* ``format_version``     — bumped whenever the payload schema changes; a
  mismatched entry is skipped (and evicted), never mis-parsed;
* ``schema_fingerprint`` — structural hash of the database schema the plan
  was built against (relations, column metadata, FK edges).  A store warmed
  against one schema can never serve plans into a service with another;
* ``payload_sha256``     — checksum of the canonical payload encoding; a
  truncated or bit-flipped entry fails verification.

Loads are corruption-tolerant by construction: ANY failure — unreadable
file, bad JSON, header mismatch, checksum mismatch, malformed payload —
counts ``persist_corrupt_skipped`` (for genuinely damaged entries), evicts
the file best-effort, and returns ``None`` so the caller simply re-plans.
Writes are atomic (temp file + ``os.replace``) and best-effort: a full or
read-only disk degrades the service to memory-only caching (counted in
``persist_write_errors``), it never fails a request.

There is no compiled-program level on disk: a compiled plan is a Python
closure over the executor, rebuilt in microseconds, and the CUDA kernels'
builds persist on their own under ``repro_torch/kernels/.build/``.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
from pathlib import Path

from repro_torch.core.plan import (
    PhysicalPlan,
    PlanNotSerialisable,
    plan_from_payload,
    plan_to_payload,
)
from repro_torch.tables.table import Schema

FORMAT_VERSION = 1


def schema_fingerprint(schema: Schema) -> str:
    """Structural hash of a database schema: relation names, column
    metadata (order, uniqueness, domains) and FK edges.  Plans persisted
    under one schema fingerprint are only ever loaded into services whose
    schema hashes identically — column renames or domain changes silently
    invalidate the whole store rather than mis-resolving variables."""
    rels = tuple(sorted(
        (name, tuple((c.name, c.unique, c.domain) for c in rs.columns))
        for name, rs in schema.relations.items()))
    fks = tuple(sorted((fk.src, fk.src_col, fk.dst, fk.dst_col)
                       for fk in schema.foreign_keys))
    return hashlib.sha256(repr((rels, fks)).encode()).hexdigest()


def store_fingerprint(schema: Schema, mode: str = "auto",
                      use_fkpk: bool = False,
                      topology: tuple = ()) -> str:
    """The identity a service's store entries must match: schema structure
    PLUS planner configuration PLUS shard topology.  Persisted plans are
    *planner output* — a store warmed by a ``mode="ref"`` service must not
    hand materialising plans to an ``opt_plus`` service, and a
    ``use_fkpk=True`` store must not impose FK-trusting semi-joins on a
    service configured not to trust the declared FKs.  ``topology`` is the
    serving mesh's ``(axis_names, shard_counts)`` (``()`` on a single
    device): a mesh service's warm-start bookkeeping describes programs
    lowered for that mesh shape, so differently-sharded services keep disjoint
    entry directories under one ``cache_dir`` and never leak state across
    configs."""
    return hashlib.sha256(repr((schema_fingerprint(schema), mode,
                                use_fkpk,
                                tuple(topology))).encode()).hexdigest()


def _canonical_body(payload: dict) -> bytes:
    """The byte string the checksum covers: a canonical JSON encoding of
    the payload (sorted keys, no whitespace) so the digest is stable across
    writers."""
    return json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode()


class PlanStore:
    """Versioned, content-addressed, corruption-tolerant plan persistence.

    Thread-safe: loads/saves for different fingerprints may run
    concurrently (the serving engine issues them from per-fingerprint
    in-flight builds); a lock guards only the counters."""

    def __init__(self, root, schema_fp: str, *, read_only: bool = False):
        self.root = Path(root)
        # read_only: loads as usual; nothing under root is created, written
        # or evicted (a mesh service's ranks other than 0 read rank 0's)
        self.read_only = read_only
        # entries are scoped by the store fingerprint: two services with
        # different schemas or planner configs sharing one cache_dir get
        # disjoint directories (the per-entry header check below is then
        # belt and braces, catching hand-moved files)
        self.plans_dir = self.root / "plans" / schema_fp[:16]
        self.schema_fp = schema_fp
        self._lock = threading.Lock()
        self.counters = {
            "persist_hits": 0,            # usable entry loaded from disk
            "persist_misses": 0,          # no usable entry (absent/corrupt)
            "persist_writes": 0,          # entries persisted
            "persist_corrupt_skipped": 0,  # damaged entries skipped+evicted
            "persist_write_errors": 0,    # failed writes (degraded to
                                          # memory-only caching)
        }
        try:
            if not read_only:
                self.plans_dir.mkdir(parents=True, exist_ok=True)
        except OSError:
            # unwritable root: loads will miss, saves will count errors —
            # the service degrades to memory-only caching, never crashes
            pass
        # entry count: one directory scan at construction, then maintained
        # by save/evict — metrics() must never turn into a disk scan (it
        # is called on the serving hot path).  Approximate under
        # concurrent writers from OTHER processes, exact within this one.
        try:
            self._entries = sum(1 for _ in self.plans_dir.glob("*.json"))
        except OSError:
            self._entries = 0

    # ---- paths -----------------------------------------------------------
    def _path(self, fingerprint: str) -> Path:
        # fingerprints are sha256 hex for shareable queries; anything else
        # (defensive: a salted opaque fingerprint) is re-hashed into a safe
        # filename rather than trusted as a path component
        if not all(c in "0123456789abcdef" for c in fingerprint):
            fingerprint = hashlib.sha256(fingerprint.encode()).hexdigest()
        return self.plans_dir / f"{fingerprint}.json"

    def __len__(self) -> int:
        with self._lock:
            return self._entries

    def fingerprints(self) -> list[str]:
        """Fingerprints with an entry on disk (existence only — entries
        are verified at load time)."""
        try:
            return sorted(p.stem for p in self.plans_dir.glob("*.json"))
        except OSError:
            return []

    def has(self, fingerprint: str) -> bool:
        """Existence probe for hit-level attribution (``explain()``):
        does an entry file exist for `fingerprint`?  Touches no counters
        and performs no verification — a damaged entry still reports
        True until a real ``load`` evicts it."""
        try:
            return self._path(fingerprint).exists()
        except OSError:
            return False

    # ---- load ------------------------------------------------------------
    def load(self, fingerprint: str) -> PhysicalPlan | None:
        """Return the persisted plan, or None (re-plan).  Damaged entries
        are evicted and counted, never raised."""
        plan, corrupt = self._load(self._path(fingerprint), fingerprint)
        with self._lock:
            if plan is not None:
                self.counters["persist_hits"] += 1
            else:
                self.counters["persist_misses"] += 1
                if corrupt:
                    self.counters["persist_corrupt_skipped"] += 1
        return plan

    def _load(self, path: Path, fingerprint: str | None, *,
              evict: bool = True,
              ) -> tuple[PhysicalPlan | None, bool]:
        """(plan, was_corrupt) — counter-free core shared by ``load`` and
        ``load_all``.  ``was_corrupt`` distinguishes a damaged entry from a
        plain absence.  ``evict`` deletes damaged entries — right for the
        store's OWN directory (a bad entry must not be re-parsed on every
        lookup), wrong for a foreign directory being imported/exported
        (schema skew there is the reader's mismatch, not damage)."""
        try:
            raw = path.read_bytes()
        except OSError:
            return None, False
        try:
            doc = json.loads(raw)
            if doc["format_version"] != FORMAT_VERSION:
                raise ValueError(
                    f"format_version {doc['format_version']} != "
                    f"{FORMAT_VERSION}")
            if doc["schema_fingerprint"] != self.schema_fp:
                raise ValueError("schema fingerprint mismatch")
            if fingerprint is not None \
                    and doc["fingerprint"] != fingerprint:
                raise ValueError("entry/fingerprint mismatch")
            payload = doc["payload"]
            if hashlib.sha256(_canonical_body(payload)).hexdigest() \
                    != doc["payload_sha256"]:
                raise ValueError("payload checksum mismatch")
            return plan_from_payload(payload), False
        except Exception:
            # skip — and in our own directory, evict — without ever
            # crashing a request
            if evict and not self.read_only:
                try:
                    path.unlink()
                except OSError:
                    pass
                else:
                    with self._lock:
                        self._entries = max(0, self._entries - 1)
            return None, True

    def load_all(self):
        """Yield (fingerprint, plan) for every valid entry — used by cache
        import/export, so it touches neither the hit/miss counters nor the
        files: unreadable entries are skipped in place, NOT evicted (the
        directory may belong to another service whose schema simply isn't
        ours — import must never empty a shared warm store)."""
        for fp in self.fingerprints():
            plan, corrupt = self._load(self._path(fp), fp, evict=False)
            if plan is not None:
                yield fp, plan
            elif corrupt:
                with self._lock:
                    self.counters["persist_corrupt_skipped"] += 1

    # ---- save ------------------------------------------------------------
    def save(self, fingerprint: str, plan: PhysicalPlan) -> bool:
        """Persist one plan.  Returns False — without raising — when the
        plan is not serialisable (opaque selections) or the write fails
        (read-only/full disk): persistence is an optimisation, never a
        request-path dependency.  A read-only store writes nothing and
        returns False."""
        if self.read_only:
            return False
        try:
            payload = plan_to_payload(plan)
            body = _canonical_body(payload)
        except (PlanNotSerialisable, TypeError, ValueError):
            return False
        doc = {
            "format_version": FORMAT_VERSION,
            "schema_fingerprint": self.schema_fp,
            "fingerprint": fingerprint,
            "payload_sha256": hashlib.sha256(body).hexdigest(),
            "payload": payload,
        }
        path = self._path(fingerprint)
        tmp = None
        try:
            existed = path.exists()
            fd, tmp = tempfile.mkstemp(dir=str(self.plans_dir),
                                       prefix=f".{path.stem[:16]}.",
                                       suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=1)
            os.replace(tmp, path)        # atomic: readers never see a torn
            tmp = None                   # entry, only old or new
        except OSError:
            with self._lock:
                self.counters["persist_write_errors"] += 1
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            return False
        with self._lock:
            self.counters["persist_writes"] += 1
            if not existed:
                self._entries += 1
        return True

    # ---- observability ---------------------------------------------------
    def metrics(self) -> dict[str, int]:
        with self._lock:
            out = dict(self.counters)
        out["persist_entries"] = len(self)
        return out


PERSIST_ZEROS = {
    "persist_hits": 0, "persist_misses": 0, "persist_writes": 0,
    "persist_corrupt_skipped": 0, "persist_write_errors": 0,
    "persist_entries": 0,
}
