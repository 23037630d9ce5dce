"""FreqJoin (paper §5): the CUDA hash-join kernel K2 and its plain version.

``freq_join_cuda`` launches ``csrc/freq_join.cu`` in sum mode; the semi-join
(K1, ``semi_join.py``) is the same source in the Boolean semiring.  Both
wrappers share ``hash_join``, which checks the inputs, allocates the output
and the hash table, and launches.  ``freq_join_plain`` is the JAX package's
XLA formulation in PyTorch (sort + prefix sum + searchsorted, or one dense
scatter-add when the key domain is known and small): the path on the CPU,
and the version the kernels are held against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.autotune import DEFAULT_CONFIG, KernelConfig

_P, _N, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
HASH_JOIN_ARGTYPES = (_P, _P, _N, _P, _P, _N, _P, _P, _N, _P, _I, _I)

K2 = CudaKernel("freq_join", "freq_join.cu", "repro_hash_join",
                HASH_JOIN_ARGTYPES)

_MODES = {"sum": 0, "any": 1}
_FDTYPES = {torch.int32: 0, torch.float32: 1}


def table_slots(n_child: int) -> int:
    """Hash-table size for a child of ``n_child`` rows: the power of two
    ≥ 2·n_child (load factor ≤ 1/2), at least 2.  Sized from the child's
    length, not its live count, so sizing needs no device sync."""
    return 1 << max(1, (2 * n_child - 1).bit_length())


def hash_join(kernel: CudaKernel, parent_keys, parent_freq, child_keys,
              child_freq, mode: str) -> torch.Tensor:
    """Launch ``kernel`` (K1 or K2, both ``repro_hash_join``) on CUDA
    tensors: int32 keys, int32 or float32 frequencies of one dtype, 1-D and
    contiguous.  Returns the new parent frequencies."""
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
    slots = table_slots(nc)
    slot_keys = torch.full((slots,), -1, dtype=torch.int64, device=dev)
    slot_vals = torch.zeros(slots if mode == "sum" else 1,
                            dtype=parent_freq.dtype, device=dev)
    out = torch.empty_like(parent_freq)
    kernel.launch(dev, parent_keys.data_ptr(), parent_freq.data_ptr(), np_,
                  child_keys.data_ptr(), child_freq.data_ptr(), nc,
                  slot_keys.data_ptr(), slot_vals.data_ptr(), slots,
                  out.data_ptr(), _MODES[mode], _FDTYPES[parent_freq.dtype])
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
