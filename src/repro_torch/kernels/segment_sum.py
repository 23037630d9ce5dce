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

_P, _N, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

K3 = CudaKernel("segment_sum", "segment_sum.cu", "repro_segment_sum",
                (_P, _P, _N, _P, _P, _P, _P, _P, _I))

TILE = 1024  # rows per block of the tile scan: kTile in csrc/segment_sum.cu
_VDTYPES = {torch.int32: 0, torch.float32: 1}


def segment_sum_cuda(sorted_keys, values):
    """K3 on the card: int32 sorted keys, int32 or float32 values, both 1-D
    and contiguous."""
    dev = sorted_keys.device
    if dev.type != "cuda" or values.device != dev:
        raise ValueError("segment_sum: keys and values must lie on one CUDA "
                         f"device, got {sorted_keys.device} and "
                         f"{values.device}")
    if sorted_keys.dtype != torch.int32 or values.dtype not in _VDTYPES:
        raise TypeError("segment_sum: needs int32 keys and int32/float32 "
                        f"values, got {sorted_keys.dtype} and {values.dtype}")
    if sorted_keys.dim() != 1 or values.shape != sorted_keys.shape \
            or not sorted_keys.is_contiguous() or not values.is_contiguous():
        raise ValueError("segment_sum: keys and values must be 1-D, "
                         "contiguous and of one length")
    n = sorted_keys.shape[0]
    n_tiles = max(1, -(-n // TILE))
    sums = torch.empty_like(values)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    tile_agg = torch.empty(n_tiles, dtype=values.dtype, device=dev)
    tile_first = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    carry = torch.empty(n_tiles, dtype=values.dtype, device=dev)
    K3.launch(dev, sorted_keys.data_ptr(), values.data_ptr(), n,
              sums.data_ptr(), valid.data_ptr(), tile_agg.data_ptr(),
              tile_first.data_ptr(), carry.data_ptr(), _VDTYPES[values.dtype])
    return sums, valid


def segment_sum_plain(sorted_keys, values):
    """The JAX package's XLA segment sum, op for op: run ids from key
    changes, one scatter-add per run, totals read back at run ends."""
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
