"""Persistent statistics store: warm restarts skip stats recomputation.

Table statistics are *derived* state — a pure function of one table's data
version — so they persist under the same ``cache_dir`` discipline as
plans: versioned, checksummed, atomic,
corruption-tolerant.  Entries are keyed by (relation, content token): the
engine passes a composite token covering the table's own
``Table.content_token()`` PLUS those of its FK-destination tables (orphan
counts read both sides of each declared FK), so a warm restart over
identical data loads every table's stats straight from disk
(``stat_refreshes == 0``) while ANY data change on either side misses
the token and forces a fresh compute — stale statistics are structurally
impossible, not merely unlikely.

The serve-time feedback table (EWMA solo/fused serve times per
(fingerprint, fusion-group signature)) persists as one additional entry
per store, rewritten atomically after each observing batch, so a
restarted service remembers which fusions regressed and keeps them
demoted from the first request.

Store layout (``<sfp>`` scopes by schema structure, exactly like the plan
store — differently-schema'd services sharing a ``cache_dir`` never read
each other's statistics)::

    <root>/stats/<sfp>/<relation>.json      stats @ one content token
    <root>/stats/<sfp>/__feedback__.json    serve-time feedback snapshot

Each entry carries ``format_version`` / ``schema_fingerprint`` /
``payload_sha256`` headers verified before the body is trusted; the
per-table entries additionally embed their key fields (relation, token)
so a hand-moved file can never impersonate another table's statistics.
Damaged entries in our own directory are evicted best-effort and counted
``stats_persist_corrupt_skipped``; write failures degrade the service to
in-memory statistics (``stats_persist_write_errors``), never fail a
request.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
from pathlib import Path

from repro_torch.core.stats import TableStats

STATS_FORMAT_VERSION = 1

_FEEDBACK_KEY = "__feedback__"


def _canonical_body(payload: dict) -> bytes:
    """Checksummed byte string: canonical JSON (sorted keys, compact)."""
    return json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode()


class StatsStore:
    """Versioned, token-keyed, corruption-tolerant statistics persistence.

    Thread-safe: a lock guards the counters; file operations are atomic
    per entry (temp file + ``os.replace``)."""

    def __init__(self, root, schema_fp: str, *, read_only: bool = False):
        self.root = Path(root)
        # read_only: loads as usual; nothing under root is created, written
        # or evicted (a mesh service's ranks other than 0 read rank 0's)
        self.read_only = read_only
        self.stats_dir = self.root / "stats" / schema_fp[:16]
        self.schema_fp = schema_fp
        self._lock = threading.Lock()
        self.counters = {
            "stats_persist_hits": 0,
            "stats_persist_misses": 0,
            "stats_persist_writes": 0,
            "stats_persist_corrupt_skipped": 0,
            "stats_persist_write_errors": 0,
        }
        try:
            if not read_only:
                self.stats_dir.mkdir(parents=True, exist_ok=True)
        except OSError:
            # unwritable root: loads miss, saves count errors — the
            # service degrades to in-memory statistics, never crashes
            pass
        try:
            self._entries = sum(1 for _ in self.stats_dir.glob("*.json"))
        except OSError:
            self._entries = 0

    # ---- paths -----------------------------------------------------------
    def _path(self, relation: str) -> Path:
        # relation names come from the schema, but never trust a name as a
        # path component — anything beyond [a-z0-9_] is re-hashed
        if not all(c.isalnum() or c == "_" for c in relation):
            relation = hashlib.sha256(relation.encode()).hexdigest()[:32]
        return self.stats_dir / f"{relation}.json"

    def __len__(self) -> int:
        with self._lock:
            return self._entries

    # ---- table stats -----------------------------------------------------
    def load(self, relation: str, token: str) -> TableStats | None:
        """Persisted stats for ``relation`` at data version ``token``, or
        None (compute fresh).  A valid entry whose token differs is a
        plain miss — the data changed, the entry is simply outdated (it
        will be overwritten by the next save), not corrupt."""
        doc, corrupt = self._read(self._path(relation))
        stats: TableStats | None = None
        stale = False
        if doc is not None:
            try:
                if doc["relation"] != relation:
                    raise ValueError("entry/relation mismatch")
                if doc["token"] != token:
                    stale = True
                else:
                    stats = TableStats.from_payload(doc["payload"])
                    if stats.relation != relation:
                        raise ValueError("payload/key mismatch")
            except Exception:
                stats = None
                corrupt = True
                self._evict(self._path(relation))
        with self._lock:
            if stats is not None:
                self.counters["stats_persist_hits"] += 1
            else:
                self.counters["stats_persist_misses"] += 1
                if corrupt and not stale:
                    self.counters["stats_persist_corrupt_skipped"] += 1
        return stats

    def save(self, stats: TableStats, token: str | None = None) -> bool:
        """Persist one table's stats (overwrites any previous version).
        ``token`` overrides the entry's KEY token — the engine passes its
        composite token here while the payload keeps the table's own
        ``content_token()`` (what decision traces compare against)."""
        return self._write(self._path(stats.relation), {
            "relation": stats.relation,
            "token": stats.token if token is None else token,
            "payload": stats.to_payload(),
        })

    # ---- feedback --------------------------------------------------------
    def load_feedback(self) -> dict | None:
        """The persisted feedback snapshot payload, or None.  Touches the
        hit/miss counters like any other entry."""
        doc, corrupt = self._read(self._path(_FEEDBACK_KEY))
        payload = None
        if doc is not None:
            try:
                if doc["relation"] != _FEEDBACK_KEY:
                    raise ValueError("entry/key mismatch")
                payload = doc["payload"]
            except Exception:
                corrupt = True
                self._evict(self._path(_FEEDBACK_KEY))
        with self._lock:
            if payload is not None:
                self.counters["stats_persist_hits"] += 1
            else:
                self.counters["stats_persist_misses"] += 1
                if corrupt:
                    self.counters["stats_persist_corrupt_skipped"] += 1
        return payload

    def save_feedback(self, payload: dict) -> bool:
        """Atomically replace the feedback snapshot."""
        return self._write(self._path(_FEEDBACK_KEY), {
            "relation": _FEEDBACK_KEY,
            "token": "",
            "payload": payload,
        })

    # ---- shared entry I/O ------------------------------------------------
    def _read(self, path: Path) -> tuple[dict | None, bool]:
        """(verified doc, was_corrupt).  ANY failure — unreadable file,
        bad JSON, header mismatch, checksum mismatch — evicts the entry
        (own directory: a bad entry must not be re-parsed per lookup) and
        reports corruption; a plain absence is (None, False)."""
        try:
            raw = path.read_bytes()
        except OSError:
            return None, False
        try:
            doc = json.loads(raw)
            if doc["format_version"] != STATS_FORMAT_VERSION:
                raise ValueError(
                    f"format_version {doc['format_version']} != "
                    f"{STATS_FORMAT_VERSION}")
            if doc["schema_fingerprint"] != self.schema_fp:
                raise ValueError("schema fingerprint mismatch")
            if hashlib.sha256(_canonical_body(doc["payload"])).hexdigest() \
                    != doc["payload_sha256"]:
                raise ValueError("payload checksum mismatch")
            return doc, False
        except Exception:
            self._evict(path)
            return None, True

    def _evict(self, path: Path) -> None:
        if self.read_only:
            return
        try:
            path.unlink()
        except OSError:
            pass
        else:
            with self._lock:
                self._entries = max(0, self._entries - 1)

    def _write(self, path: Path, fields: dict) -> bool:
        if self.read_only:
            return False
        doc = {
            "format_version": STATS_FORMAT_VERSION,
            "schema_fingerprint": self.schema_fp,
            "payload_sha256": hashlib.sha256(
                _canonical_body(fields["payload"])).hexdigest(),
            **fields,
        }
        tmp = None
        try:
            existed = path.exists()
            fd, tmp = tempfile.mkstemp(dir=str(self.stats_dir),
                                       prefix=f".{path.stem[:16]}.",
                                       suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=1)
            os.replace(tmp, path)        # atomic: readers see old or new,
            tmp = None                   # never a torn entry
        except (OSError, TypeError, ValueError):
            with self._lock:
                self.counters["stats_persist_write_errors"] += 1
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            return False
        with self._lock:
            self.counters["stats_persist_writes"] += 1
            if not existed:
                self._entries += 1
        return True

    # ---- observability ---------------------------------------------------
    def metrics(self) -> dict[str, int]:
        with self._lock:
            out = dict(self.counters)
        out["stats_persist_entries"] = len(self)
        return out


STATS_PERSIST_ZEROS = {
    "stats_persist_hits": 0, "stats_persist_misses": 0,
    "stats_persist_writes": 0, "stats_persist_corrupt_skipped": 0,
    "stats_persist_write_errors": 0, "stats_persist_entries": 0,
}

__all__ = ["StatsStore", "STATS_PERSIST_ZEROS", "STATS_FORMAT_VERSION"]
