"""Fixed-capacity columnar table substrate, in PyTorch.

A ``Table`` never shrinks or grows: it has a fixed ``capacity`` and carries a
*frequency* column ``freq``.  A live tuple has ``freq > 0``; selections and
semi-joins zero frequencies instead of deleting rows, and the FreqJoin
operator multiplies them.  This is the paper's K-relation view (semiring
annotations) with static shapes, so every operator works on whole columns.

All columns and ``freq`` of one table are 1-D tensors of equal length on one
device.  Entry points put tables on the GPU (``"cuda"``) unless the caller
names another device; schema metadata (primary keys, uniqueness, FK edges,
domain sizes) drives the paper's §4.1 set-safety and §4.3 FK/PK rewrites.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"

# int32 and int64 wrap-arounds of the golden-ratio constants 0x9E3779B9 and
# 0x9E3779B97F4A7C15 used by the hash-combine fallback of ``pack_keys``
_PHI32 = 0x9E3779B9 - (1 << 32)
_PHI64 = 0x9E3779B97F4A7C15 - (1 << 64)


def is_wide(freq_dtype: torch.dtype) -> bool:
    """A 64-bit frequency dtype (int64, float64) selects the wide setting,
    the counterpart of the JAX package under ``jax.enable_x64(True)``."""
    return freq_dtype.itemsize == 8


def int_dtype(wide: bool) -> torch.dtype:
    """The integer dtype of packed keys, live counts and integer sums:
    int64 in the wide setting, else int32, as the JAX package's default
    int with 64-bit types on or off."""
    return torch.int64 if wide else torch.int32


def float_dtype(wide: bool) -> torch.dtype:
    """The float dtype of AVG sums and median weights: float64 in the wide
    setting, else float32, as the JAX package's with 64-bit types on or
    off."""
    return torch.float64 if wide else torch.float32


@dataclasses.dataclass(frozen=True)
class ColumnMeta:
    """Static metadata for one column of a relation."""

    name: str
    unique: bool = False          # declared UNIQUE / PK component
    domain: int | None = None     # values are ints in [0, domain) if known


@dataclasses.dataclass(frozen=True)
class ForeignKey:
    """FK edge: ``src.src_col`` references ``dst.dst_col`` (a PK/unique col)."""

    src: str
    src_col: str
    dst: str
    dst_col: str


@dataclasses.dataclass(frozen=True)
class RelSchema:
    """Schema of one relation."""

    name: str
    columns: tuple[ColumnMeta, ...]

    def column_names(self) -> tuple[str, ...]:
        return tuple(c.name for c in self.columns)

    def meta(self, name: str) -> ColumnMeta:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(f"{self.name} has no column {name!r}")

    def is_unique(self, cols: Sequence[str]) -> bool:
        """True if `cols` contains at least one declared-unique column.
        Unknown names raise (via ``meta``): a typo in FK/PK metadata must
        not silently flip a §4.3 pre-grouping decision."""
        return any(self.meta(c).unique for c in cols)


@dataclasses.dataclass(frozen=True)
class Schema:
    """Database schema: relations + FK edges."""

    relations: Mapping[str, RelSchema]
    foreign_keys: tuple[ForeignKey, ...] = ()

    def fk_edge(self, src: str, src_col: str, dst: str, dst_col: str) -> bool:
        """True if src.src_col → dst.dst_col is a declared FK into a unique col."""
        for fk in self.foreign_keys:
            if (fk.src, fk.src_col, fk.dst, fk.dst_col) == (src, src_col, dst, dst_col):
                return True
        return False


class Table:
    """A fixed-capacity columnar relation with a frequency column.

    ``columns``: dict name → 1-D tensor, all of length ``capacity``.
    ``freq``:    1-D tensor of length ``capacity``; 0 marks dead/padded rows.
    Every tensor lies on ``freq.device``.
    """

    def __init__(self, columns: dict[str, torch.Tensor], freq: torch.Tensor):
        self.columns = dict(columns)
        self.freq = freq

    # ---- construction -----------------------------------------------------
    @classmethod
    def from_numpy(
        cls,
        data: Mapping[str, np.ndarray],
        freq_dtype: torch.dtype = torch.int32,
        capacity: int | None = None,
        device: str | torch.device | None = None,
    ) -> "Table":
        """Columns keep their numpy dtypes; ``device=None`` means the GPU."""
        device = DEFAULT_DEVICE if device is None else device
        n = len(next(iter(data.values())))
        cap = capacity if capacity is not None else n
        if cap < n:
            raise ValueError(
                f"capacity {cap} below data length {n}; tables never "
                "shrink (drop rows by zeroing freq instead)")
        cols = {}
        for k, v in data.items():
            arr = np.asarray(v)
            if cap > n:
                pad = np.zeros((cap - n,) + arr.shape[1:], dtype=arr.dtype)
                arr = np.concatenate([arr, pad])
            cols[k] = torch.tensor(arr, device=device)
        freq = torch.zeros(cap, dtype=freq_dtype, device=device)
        freq[:n] = 1
        return cls(cols, freq)

    # ---- basic properties ---------------------------------------------
    @property
    def capacity(self) -> int:
        return int(self.freq.shape[0])

    @property
    def device(self) -> torch.device:
        return self.freq.device

    @property
    def column_names(self) -> tuple[str, ...]:
        return tuple(sorted(self.columns))

    def live_count(self, wide: bool | None = None) -> torch.Tensor:
        """Number of live tuples (rows with freq > 0) — the paper's
        'materialised tuples' metric for this relation — in
        ``int_dtype(wide)``; ``wide=None`` follows the frequencies' width."""
        if wide is None:
            wide = is_wide(self.freq.dtype)
        return torch.sum(self.freq > 0, dtype=int_dtype(wide))

    def content_token(self) -> str:
        """Content hash of the table's data version: one sha256 over every
        column's numpy dtype name and bytes plus the frequency column, in
        the same order and format as the JAX package, so equal data gives
        equal tokens in both."""
        h = hashlib.sha256()
        for name in self.column_names:
            arr = self.columns[name].cpu().numpy()
            h.update(name.encode())
            h.update(str(arr.dtype).encode())
            h.update(arr.tobytes())
        f = self.freq.cpu().numpy()
        h.update(b"__freq__")
        h.update(str(f.dtype).encode())
        h.update(f.tobytes())
        return h.hexdigest()

    # ---- relational primitives (frequency-aware) -----------------------
    def select(self, pred: Callable[[dict[str, torch.Tensor]], torch.Tensor]
               ) -> "Table":
        """σ: zero out frequencies of rows failing `pred` (no compaction)."""
        mask = pred(self.columns)
        return Table(self.columns,
                     torch.where(mask, self.freq, torch.zeros_like(self.freq)))

    def with_freq(self, freq: torch.Tensor) -> "Table":
        return Table(self.columns, freq)

    def pad_to(self, capacity: int) -> "Table":
        """Grow capacity to `capacity` by appending dead rows (freq = 0).
        Padding is semantically free: every operator masks by frequency."""
        cap = self.capacity
        if capacity == cap:
            return self
        if capacity < cap:
            raise ValueError(
                f"pad_to({capacity}) below current capacity {cap}; tables "
                "never shrink (drop rows by zeroing freq instead)")
        extra = capacity - cap
        cols = {}
        for name, col in self.columns.items():
            pad = col.new_zeros((extra,) + tuple(col.shape[1:]))
            cols[name] = torch.cat([col, pad])
        freq = torch.cat([self.freq, self.freq.new_zeros(extra)])
        return Table(cols, freq)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Table(cap={self.capacity}, cols={list(self.column_names)}, "
                f"device={self.device})")


def db_from_numpy(arrays: Mapping[str, Mapping[str, np.ndarray]],
                  device: str | torch.device | None = None
                  ) -> dict[str, Table]:
    """Tables from host arrays: ``arrays[relation]`` maps each column name
    to its values and ``"freq"`` to the frequency column, e.g. the JAX
    package's tables read out with ``np.asarray``.  Dtypes are kept as they
    are; ``device=None`` means the GPU."""
    device = DEFAULT_DEVICE if device is None else device
    db = {}
    for rel, cols in arrays.items():
        tensors = {name: torch.tensor(np.asarray(a), device=device)
                   for name, a in cols.items()}
        freq = tensors.pop("freq")
        db[rel] = Table(tensors, freq)
    return db


def bucket_capacity(n: int, min_capacity: int = 8) -> int:
    """Smallest power of two ≥ max(n, min_capacity) — the shape bucket a
    table of n rows is padded to."""
    n = max(int(n), min_capacity, 1)
    return 1 << (n - 1).bit_length()


def pack_keys(
    cols: Sequence[torch.Tensor],
    domains: Sequence[int | None],
    dtype: torch.dtype = torch.int32,
) -> torch.Tensor:
    """Pack multi-attribute join keys into a single integer key.

    If all domains are known, packing is collision-free mixed-radix:
    ``key = ((c0 * d1 + c1) * d2 + c2) ...``.  Otherwise a Fibonacci mixing
    hash combine is used (documented collision risk — exact engines should
    declare domains; the generators always do).  Arithmetic wraps in the
    key dtype, which the caller picks (``int_dtype``: int64 in the wide
    setting); the mixing constant is 0x9E3779B9 taken as int32, or
    0x9E3779B97F4A7C15 taken as int64.
    """
    if len(cols) == 1:
        return cols[0].to(dtype)
    if all(d is not None for d in domains):
        key = cols[0].to(dtype)
        for c, d in zip(cols[1:], domains[1:]):
            key = key * d + c.to(dtype)
        return key
    phi = _PHI32 if dtype == torch.int32 else _PHI64
    key = cols[0].to(dtype)
    for c in cols[1:]:
        key = key ^ (c.to(dtype) + phi + (key << 6) + (key >> 2))
    return key
