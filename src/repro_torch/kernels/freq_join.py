"""FreqJoin (paper §5): the CUDA hash-join kernel K2 and its plain version.

``freq_join_cuda`` launches ``csrc/freq_join.cu`` in sum mode; the semi-join
(K1, ``semi_join.py``) is the same source in the Boolean semiring.  Both
wrappers share ``hash_join``, which checks the inputs, picks the call's path
from the two lengths (``join_path``: the side the table holds, or a small
child built in shared memory), allocates the output and the table
(``prepare_call``), and launches.  ``freq_join_plain`` is the JAX package's XLA formulation in
PyTorch (sort + prefix sum + searchsorted, or one dense scatter-add when the
key domain is known and small): the path on the CPU, and the version the
kernels are held against on the card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.autotune import DEFAULT_CONFIG, KernelConfig

_P, _N, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
HASH_JOIN_ARGTYPES = (_P, _P, _N, _P, _P, _N, _P, _N, _N, _P, _I, _I, _I,
                      _I)

K2 = CudaKernel("freq_join", "freq_join.cu", "repro_hash_join",
                HASH_JOIN_ARGTYPES)

_MODES = {"sum": 0, "any": 1}
_FDTYPES = {torch.int32: 0, torch.float32: 1}
SIDES = {"child": 0, "parent": 1, "shared": 2}

# A child of at most this many rows is built in each block's shared memory.
# Its table (2·1024 slots of 8 bytes and the side slot) is well inside the
# 48 KiB a block gets without opting in, which the C entry checks (it
# refuses a shared table that does not fit, as that of a child of more
# than 2048 rows would in sum mode and of more than 4096 in any mode).  The limit is measured: chip_smoke.py's
# ``cutoff`` lines time the shared path against the child side at 512,
# 1024 and 2048 child rows under 100k- and 8M-row parents; at 2048 the
# shared path lost in device time on both parents, at 1024 it did not.
SHARED_MAX_ROWS = 1024

# Phases of the C entry, one bit each; ``hash_join`` runs them all.
FILL, BUILD, PROBE, GATHER = 1, 2, 4, 8
ALL_PHASES = FILL | BUILD | PROBE | GATHER


class JoinPath(NamedTuple):
    """How one call runs: the side whose keys the table holds (``child``,
    ``parent``, or ``shared``, a child built in shared memory in the one
    launch) and the table's slots."""
    side: str
    slots: int


def table_slots(n_build: int) -> int:
    """Hash-table size for a build side of ``n_build`` rows: the power of
    two ≥ 2·n_build (load factor ≤ 1/2), at least 2.  Sized from the
    length, not the live count, so sizing needs no device sync."""
    return 1 << max(1, (2 * n_build - 1).bit_length())


def join_path(n_parent: int, n_child: int) -> JoinPath:
    """The path of a call, from the two lengths alone (no device sync): a
    child of at most ``SHARED_MAX_ROWS`` rows goes to shared memory; else
    the table holds the shorter side, the child on a tie (the child side
    makes one pass fewer).  chip_smoke.py's ``cutoff`` lines time both
    sides of each choice near where it flips."""
    if n_child <= SHARED_MAX_ROWS:
        return JoinPath("shared", table_slots(n_child))
    if n_parent < n_child:
        return JoinPath("parent", table_slots(n_parent))
    return JoinPath("child", table_slots(n_child))


def table_words(path: JoinPath, mode: str) -> int:
    """int32 words of the device table for ``path``: the slots and one
    side slot (for key −1) of 8 bytes — key and value — or, in ``any`` mode
    on the child side, of 4 bytes (key only), rounded up to whole 16-byte
    stores.  The shared path needs no device table."""
    if path.side == "shared":
        return 0
    per_slot = 1 if mode == "any" and path.side == "child" else 2
    return -(-per_slot * (path.slots + 1) // 4) * 4


def prepare_call(parent_freq, n_child: int, mode: str,
                 path: JoinPath | None = None):
    """``(path, table, out)`` of one call: the path (``join_path`` of the
    two lengths unless given), its table of ``table_words`` int32 words
    (None on the shared path) and the output, both ``torch.empty`` on
    ``parent_freq``'s device, for this call only."""
    if path is None:
        path = join_path(parent_freq.shape[0], n_child)
    words = table_words(path, mode)
    table = (torch.empty(words, dtype=torch.int32, device=parent_freq.device)
             if words else None)
    return path, table, torch.empty_like(parent_freq)


def launch_phases(kernel: CudaKernel, path: JoinPath, mode: str, pk, pf, ck,
                  cf, table, out, phases: int) -> None:
    """Launch the ``phases`` of one call of ``repro_hash_join`` on the
    current stream, with ``table`` (from ``prepare_call``; the C entry
    refuses one shorter than its layout needs) as scratch and the answer
    into ``out``; counts one launch of ``path``."""
    kernel.launch(pk.device, pk.data_ptr(), pf.data_ptr(), pk.shape[0],
                  ck.data_ptr(), cf.data_ptr(), ck.shape[0],
                  None if table is None else table.data_ptr(),
                  0 if table is None else table.numel(), path.slots,
                  out.data_ptr(), _MODES[mode], _FDTYPES[pf.dtype],
                  SIDES[path.side], phases, path=path.side)


def hash_join(kernel: CudaKernel, parent_keys, parent_freq, child_keys,
              child_freq, mode: str) -> torch.Tensor:
    """Launch ``kernel`` (K1 or K2, both ``repro_hash_join``) on CUDA
    tensors: int32 keys, int32 or float32 frequencies of one dtype, 1-D and
    contiguous.  Returns the new parent frequencies.  The table is
    allocated here and lives only for the call."""
    ts = (parent_keys, parent_freq, child_keys, child_freq)
    dev = parent_keys.device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{kernel.name}: all inputs must lie on one CUDA "
                         f"device, got {[str(t.device) for t in ts]}")
    if parent_keys.dtype != torch.int32 or child_keys.dtype != torch.int32:
        raise TypeError(f"{kernel.name}: keys must be int32, got "
                        f"{parent_keys.dtype} and {child_keys.dtype}")
    if parent_freq.dtype != child_freq.dtype \
            or parent_freq.dtype not in _FDTYPES:
        raise TypeError(f"{kernel.name}: frequencies must share one dtype of "
                        f"int32/float32, got {parent_freq.dtype} and "
                        f"{child_freq.dtype}")
    if any(t.dim() != 1 or not t.is_contiguous() for t in ts):
        raise ValueError(f"{kernel.name}: inputs must be 1-D and contiguous")
    np_, nc = parent_keys.shape[0], child_keys.shape[0]
    if parent_freq.shape[0] != np_ or child_freq.shape[0] != nc:
        raise ValueError(f"{kernel.name}: keys and frequencies differ in "
                         "length")
    if np_ == 0:
        return torch.empty_like(parent_freq)
    path, table, out = prepare_call(parent_freq, nc, mode)
    launch_phases(kernel, path, mode, parent_keys, parent_freq, child_keys,
                  child_freq, table, out, ALL_PHASES)
    return out


def freq_join_cuda(parent_keys, parent_freq, child_keys, child_freq):
    """K2: ``out[i] = pf[i] · Σ_j cf[j]·[ck[j] == pk[i]]`` on the card."""
    return hash_join(K2, parent_keys, parent_freq, child_keys, child_freq,
                     "sum")


def freq_join_plain(parent_keys, parent_freq, child_keys, child_freq, *,
                    mode: str = "sum", domain: int | None = None,
                    config: KernelConfig | None = None):
    """The JAX package's XLA FreqJoin (``mode="sum"``) or semi-join
    (``mode="any"``), op for op: int32 arithmetic wraps as it does there."""
    config = config or DEFAULT_CONFIG
    dev = parent_freq.device
    if config.dense_ok(domain, child_keys.shape[0]):
        cf = child_freq
        if mode == "any":
            cf = (cf > 0).to(parent_freq.dtype)
        # explicit mask: negative and out-of-range child keys contribute
        # nothing (clamping alone would pile them onto the edge slots)
        live = (child_keys >= 0) & (child_keys < domain)
        acc = torch.zeros(domain, dtype=cf.dtype, device=dev)
        acc.index_add_(0, child_keys.clamp(0, domain - 1).long(),
                       torch.where(live, cf, torch.zeros_like(cf)))
        mult = acc[parent_keys.clamp(0, domain - 1).long()]
        mult = torch.where((parent_keys >= 0) & (parent_keys < domain),
                           mult, torch.zeros_like(mult))
        mult = mult.to(parent_freq.dtype)
        if mode == "any":
            mult = (mult > 0).to(parent_freq.dtype)
        return parent_freq * mult
    ck, order = torch.sort(child_keys, stable=True)
    cf = child_freq[order]
    if mode == "any":
        cf = (cf > 0).to(parent_freq.dtype)
    prefix = torch.cat([torch.zeros(1, dtype=cf.dtype, device=dev),
                        torch.cumsum(cf, 0, dtype=cf.dtype)])
    lo = torch.searchsorted(ck, parent_keys, side="left")
    hi = torch.searchsorted(ck, parent_keys, side="right")
    mult = (prefix[hi] - prefix[lo]).to(parent_freq.dtype)
    if mode == "any":
        mult = (mult > 0).to(parent_freq.dtype)
    return parent_freq * mult
