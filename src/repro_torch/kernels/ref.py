"""O(N·M) oracles for every kernel in repro_torch.kernels.

These are the semantic ground truth: obvious, unvectorised-in-spirit
implementations that the plain versions and the CUDA kernels are tested
against.  They build N×M comparison matrices, so keep inputs small.
"""

from __future__ import annotations

import torch


def freq_join_ref(parent_keys, parent_freq, child_keys, child_freq):
    """FreqJoin (paper §5), ℕ-semiring sum-product.

    For each parent row i:
        mult_i = Σ_j child_freq[j] · [child_keys[j] == parent_keys[i]]
        out_i  = parent_freq[i] · mult_i

    A dangling parent tuple (no join partner) gets out_i = 0, the
    static-shape analogue of the paper's "if r.c = 0 then delete".
    """
    eq = parent_keys[:, None] == child_keys[None, :]          # [Np, Nc]
    contrib = torch.where(eq, child_freq[None, :],
                          torch.zeros((), dtype=child_freq.dtype))
    mult = torch.sum(contrib, dim=1, dtype=child_freq.dtype)
    return parent_freq * mult.to(parent_freq.dtype)


def semi_join_ref(parent_keys, parent_freq, child_keys, child_freq):
    """Semi-join (0MA sweep, §4.1): Boolean semiring specialisation.

    out_i = parent_freq[i] if parent_keys[i] has a live join partner else 0.
    """
    eq = parent_keys[:, None] == child_keys[None, :]
    live = eq & (child_freq[None, :] > 0)
    return torch.where(torch.any(live, dim=1), parent_freq,
                       torch.zeros((), dtype=parent_freq.dtype))


def segment_sum_ref(sorted_keys, values):
    """Group-by-SUM over a key-sorted array (paper §4.2 pre-grouping).

    Returns (out_values, out_valid): the run total at the FIRST row of each
    run (0 elsewhere), and True exactly at those rows.  The kernels emit at
    the LAST row instead; compare per-key totals.
    """
    n = sorted_keys.shape[0]
    is_first = torch.ones(n, dtype=torch.bool)
    is_first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    run_id = torch.cumsum(is_first, 0, dtype=torch.int32) - 1
    eq = run_id[:, None] == run_id[None, :]                    # [N, N]
    run_sums = torch.sum(torch.where(eq, values[None, :],
                                     torch.zeros((), dtype=values.dtype)),
                         dim=1, dtype=values.dtype)
    out = torch.where(is_first, run_sums,
                      torch.zeros((), dtype=values.dtype))
    return out, is_first


def weighted_percentile_ref(values, weights, q):
    """Weighted percentile with *lower* interpolation over live rows: the
    smallest v such that cumweight(v) >= q * totalweight (rows with weight
    0 are ignored)."""
    order = torch.sort(values, stable=True).indices
    v = values[order]
    cw = torch.cumsum(weights[order].to(torch.float64), 0)
    target = q * cw[-1]
    idx = int(torch.searchsorted(cw, target.reshape(1), side="left")[0])
    return v[min(max(idx, 0), values.shape[0] - 1)]
