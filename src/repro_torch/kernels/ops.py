"""Public kernel ops: device dispatch, grouping, weighted percentile.

Each physical operator has a hand-written CUDA kernel and a plain PyTorch
version (the JAX package's XLA formulation).  The device of the inputs
decides, and nothing else: tensors on the CPU take the plain version, CUDA
tensors launch the kernel, and a kernel that cannot be built or launched
raises.

    freq_join(mode="sum")  → K2, freq_join.py
    freq_join(mode="any")  → K1, semi_join.py (also ``semi_join``)
    segment_sum_sorted     → K3, segment_sum.py

``domain`` and ``config`` steer the plain FreqJoin's dense-domain crossover
only; the hash-join kernels need no key domain.  The sorts in
``group_by_sum`` and ``weighted_percentile`` are PyTorch's own on every
device, as the JAX package leaves them to XLA; they are stable, as
``jnp.argsort`` is.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import freq_join as _fj
from repro_torch.kernels import segment_sum as _ss
from repro_torch.kernels import semi_join as _sj
from repro_torch.kernels.autotune import KernelConfig
from repro_torch.tables.table import float_dtype, is_wide


def freq_join(parent_keys, parent_freq, child_keys, child_freq, *,
              mode: str = "sum", domain: int | None = None,
              config: KernelConfig | None = None):
    """R ⋉^freq S — returns updated parent frequencies (paper §5).

    mode="sum": ℕ-semiring (COUNT/SUM propagation);
    mode="any": Boolean semiring (semi-join)."""
    if mode not in ("sum", "any"):
        raise ValueError(f"unknown freq_join mode {mode!r}")
    if parent_keys.device.type == "cpu":
        return _fj.freq_join_plain(parent_keys, parent_freq, child_keys,
                                   child_freq, mode=mode, domain=domain,
                                   config=config)
    if mode == "any":
        return _sj.semi_join_cuda(parent_keys, parent_freq, child_keys,
                                  child_freq)
    return _fj.freq_join_cuda(parent_keys, parent_freq, child_keys,
                              child_freq)


def semi_join(parent_keys, parent_freq, child_keys, child_freq, *,
              domain: int | None = None,
              config: KernelConfig | None = None):
    """R ⋉ S over live tuples (0MA sweep step, paper §4.1)."""
    return freq_join(parent_keys, parent_freq, child_keys, child_freq,
                     mode="any", domain=domain, config=config)


def segment_sum_sorted(sorted_keys, values):
    """GROUP BY key, SUM(value) over key-sorted input.

    Returns (sums, valid): run total at the LAST row of each run."""
    if sorted_keys.device.type == "cpu":
        return _ss.segment_sum_plain(sorted_keys, values)
    return _ss.segment_sum_cuda(sorted_keys, values)


def group_by_sum(keys, values):
    """Unsorted group-by: sort once (stably), then segment-sum.  Returns
    (sorted_keys, sums, valid) so downstream FreqJoins can reuse the sort."""
    ks, order = torch.sort(keys, stable=True)
    sums, valid = segment_sum_sorted(ks, values[order].contiguous())
    return ks, sums, valid


def _max_of(dtype: torch.dtype):
    return (torch.finfo(dtype).max if dtype.is_floating_point
            else torch.iinfo(dtype).max)


def weighted_percentile(values, weights, q, wide: bool | None = None):
    """PERCENTILE(q, A, freq) — lower-interpolation weighted percentile.

    Rows with weight 0 (dead tuples) are ignored: their values are moved to
    the dtype's maximum before the sort so they never land below the target
    mass.  Weights accumulate in float64 when ``wide``, else in float32, as
    the JAX package's do with 64-bit types on or off; ``wide=None`` follows
    the width of ``weights``."""
    if wide is None:
        wide = is_wide(weights.dtype)
    v = torch.where(weights > 0, values,
                    torch.full_like(values, _max_of(values.dtype)))
    vs, order = torch.sort(v, stable=True)
    cw = torch.cumsum(weights[order].to(float_dtype(wide)), 0)
    target = q * cw[-1:]
    idx = torch.searchsorted(cw, target, side="left").clamp(
        0, values.shape[0] - 1)
    return vs[idx[0]]
