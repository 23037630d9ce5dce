"""Sorted GROUP BY SUM (paper §4.2/§4.3 pre-grouping): the CUDA kernel K3
and its plain version.

Over key-sorted ``(keys, values)`` both return ``(sums, valid)``: the total
of each run of equal keys at the run's LAST row, ``valid`` True exactly
there, 0 and False elsewhere.  The end of the array always ends a run.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel
from repro_torch.tables.table import is_wide

_P, _N, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

K3 = CudaKernel("segment_sum", "segment_sum.cu", "repro_segment_sum",
                (_P, _P, _N, _P, _P, _P, _N, _I, _I, _I))

TILE = 2048  # rows per block of the scan: kTile in csrc/segment_sum.cu
_KDTYPES = {torch.int32: 0, torch.int64: 1}
_VDTYPES = {torch.int32: 0, torch.float32: 1, torch.int64: 2,
            torch.float64: 3}


def scratch_words(n: int, wide: bool = False) -> int:
    """int32 words of the scratch a call of ``n`` rows needs: none for one
    tile, else the tile counter and a spare word, then per tile either one
    8-byte state and one 4-byte aggregate, or, for ``wide`` (64-bit)
    values, a 4-byte status (padded to a whole 8 bytes after the last) and
    two 8-byte values, the prefix and the aggregate."""
    if n <= TILE:
        return 0
    nt = -(-n // TILE)
    if not wide:
        return 2 + 3 * nt
    return (2 + nt + 1) // 2 * 2 + 4 * nt


def prepare_call(values):
    """``(sums, valid, scratch)`` of one call over ``values``, all
    ``torch.empty`` on its device: ``scratch`` holds ``scratch_words``
    int32 words in the layout of ``values``' width (None for a call of at
    most one tile), which the C entry clears itself."""
    n = values.shape[0]
    words = scratch_words(n, is_wide(values.dtype))
    scratch = (torch.empty(words, dtype=torch.int32, device=values.device)
               if words else None)
    return (torch.empty_like(values),
            torch.empty(n, dtype=torch.bool, device=values.device), scratch)


def launch_call(sorted_keys, values, sums, valid, scratch) -> None:
    """Launch K3 on the current stream with the outputs and scratch of
    ``prepare_call`` (the C entry refuses a scratch shorter than its layout
    needs); counts one launch."""
    K3.launch(sorted_keys.device, sorted_keys.data_ptr(), values.data_ptr(),
              sorted_keys.shape[0], sums.data_ptr(), valid.data_ptr(),
              None if scratch is None else scratch.data_ptr(),
              0 if scratch is None else scratch.numel(), TILE,
              _KDTYPES[sorted_keys.dtype], _VDTYPES[values.dtype])


def segment_sum_cuda(sorted_keys, values):
    """K3 on the card: int32 or int64 sorted keys, int32, float32, int64 or
    float64 values, both 1-D and contiguous."""
    dev = sorted_keys.device
    if dev.type != "cuda" or values.device != dev:
        raise ValueError("segment_sum: keys and values must lie on one CUDA "
                         f"device, got {sorted_keys.device} and "
                         f"{values.device}")
    if sorted_keys.dtype not in _KDTYPES or values.dtype not in _VDTYPES:
        raise TypeError("segment_sum: needs int32/int64 keys and "
                        "int32/float32/int64/float64 values, got "
                        f"{sorted_keys.dtype} and {values.dtype}")
    if sorted_keys.dim() != 1 or values.shape != sorted_keys.shape \
            or not sorted_keys.is_contiguous() or not values.is_contiguous():
        raise ValueError("segment_sum: keys and values must be 1-D, "
                         "contiguous and of one length")
    sums, valid, scratch = prepare_call(values)
    if sorted_keys.shape[0]:
        launch_call(sorted_keys, values, sums, valid, scratch)
    return sums, valid


def segment_sum_plain(sorted_keys, values):
    """The JAX package's XLA segment sum, op for op: run ids from key
    changes, one scatter-add per run in the values' dtype, totals read back
    at run ends."""
    n = sorted_keys.shape[0]
    if n == 0:
        return values.clone(), torch.zeros(0, dtype=torch.bool,
                                           device=values.device)
    change = sorted_keys[1:] != sorted_keys[:-1]
    one = torch.ones(1, dtype=torch.bool, device=values.device)
    is_first = torch.cat([one, change])
    is_last = torch.cat([change, one])
    run_id = (torch.cumsum(is_first, 0, dtype=torch.int32) - 1).long()
    sums = torch.zeros(n, dtype=values.dtype, device=values.device)
    sums.index_add_(0, run_id, values)
    out = torch.where(is_last, sums[run_id], torch.zeros_like(values))
    return out, is_last
