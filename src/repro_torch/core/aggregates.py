"""Frequency-aware aggregate evaluation (paper §4.2 rewrites).

Once the bottom-up sweep finishes, the root relation carries frequencies
that encode the bag multiplicity of every answer tuple.  Standard aggregates
are rewritten to operate on (value, frequency) pairs:

    COUNT(*)  → SUM(c)                    COUNT(A)      → SUM(c·nonnull(A))
    SUM(A)    → SUM(A·c)                  AVG(A)        → SUM(A·c)/SUM(c)
    MEDIAN(A) → weighted-percentile(A,c)  MIN/MAX       → over live rows
    COUNT(DISTINCT A) / SUM(DISTINCT A)   → over distinct live values

`dedup=True` (0MA mode) aggregates with set semantics: weights become
live-row indicators.  GROUP BY is evaluated with one stable sort of the root
relation + segmented reductions — never by materialising groups.

Integer accumulation stays in int32, as in the JAX package (which runs with
64-bit types off); PyTorch would promote int32 sums to int64, so every sum
names its dtype.  Float accumulation is float32.
"""

from __future__ import annotations

import torch

from repro_torch.core.query import Agg
from repro_torch.kernels import ops
from repro_torch.tables.table import pack_keys


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    return dt if dt.is_floating_point else torch.int32


def _big(dt: torch.dtype):
    return torch.finfo(dt).max if dt.is_floating_point else torch.iinfo(dt).max


def _small(dt: torch.dtype):
    return torch.finfo(dt).min if dt.is_floating_point else torch.iinfo(dt).min


def _fill(like: torch.Tensor, value) -> torch.Tensor:
    return torch.full_like(like, value)


def _first_of_run(ks: torch.Tensor) -> torch.Tensor:
    first = torch.ones_like(ks, dtype=torch.bool)
    first[1:] = ks[1:] != ks[:-1]
    return first


def _distinct_mask(values, live):
    """Boolean mask (in sorted order) marking the first live occurrence of
    each distinct live value; returns (sorted_values, mask)."""
    v = torch.where(live, values, _fill(values, _big(values.dtype)))
    vs, order = torch.sort(v, stable=True)
    return vs, _first_of_run(vs) & live[order]


def scalar_aggregate(ag: Agg, cols: dict[str, torch.Tensor],
                     freq: torch.Tensor, dedup: bool) -> torch.Tensor:
    live = freq > 0
    w = live.to(freq.dtype) if dedup else freq
    if ag.func == "count" and ag.var is None:
        return torch.sum(w, dtype=_acc_dtype(w.dtype))
    a = cols[ag.var] if ag.var is not None else None
    if ag.distinct:
        vs, mask = _distinct_mask(a, live)
        if ag.func == "count":
            return torch.sum(mask, dtype=torch.int32)
        if ag.func == "sum":
            acc = _acc_dtype(a.dtype)
            return torch.sum(torch.where(mask, vs, torch.zeros_like(vs)),
                             dtype=acc)
        if ag.func == "avg":
            s = torch.sum(torch.where(mask, vs, torch.zeros_like(vs)),
                          dtype=torch.float32)
            n = torch.sum(mask, dtype=torch.float32)
            return s / torch.clamp(n, min=1)
        # min/max distinct == min/max
    if ag.func == "count":
        return torch.sum(w, dtype=_acc_dtype(w.dtype))  # nulls unsupported
    if ag.func == "sum":
        acc = _acc_dtype(torch.promote_types(a.dtype, w.dtype))
        return torch.sum(a.to(acc) * w.to(acc), dtype=acc)
    if ag.func == "avg":
        s = torch.sum(a.to(torch.float32) * w, dtype=torch.float32)
        n = torch.sum(w, dtype=_acc_dtype(w.dtype)).to(s.dtype)
        return s / torch.clamp(n, min=1)
    if ag.func == "min":
        return torch.min(torch.where(live, a, _fill(a, _big(a.dtype))))
    if ag.func == "max":
        return torch.max(torch.where(live, a, _fill(a, _small(a.dtype))))
    if ag.func == "median":
        return ops.weighted_percentile(a, w, 0.5)
    raise NotImplementedError(ag.func)


def _seg(v: torch.Tensor, run_id: torch.Tensor, reduce: str) -> torch.Tensor:
    """Per-run reduction of v, read back at every row of the run."""
    n = v.shape[0]
    if reduce == "sum":
        out = torch.zeros(n, dtype=v.dtype, device=v.device)
        out.index_add_(0, run_id, v)
    else:
        out = torch.zeros(n, dtype=v.dtype, device=v.device).scatter_reduce(
            0, run_id, v, reduce, include_self=False)
    return out[run_id]


def grouped_aggregate(group_by: tuple[str, ...], aggregates: tuple[Agg, ...],
                      cols: dict[str, torch.Tensor], freq: torch.Tensor,
                      domains: dict[str, int | None], dedup: bool):
    """GROUP BY via one sort + segmented reductions.

    Returns (out_cols, out_valid): fixed capacity == input capacity; rows
    with out_valid=False are dead.  Group rows sit at the last row of each
    sorted run (segment-sum emission convention).
    """
    live = freq > 0
    w = live.to(freq.dtype) if dedup else freq
    key = pack_keys([cols[g] for g in group_by],
                    [domains.get(g) for g in group_by])
    # dead rows sort last and never mark a group as live
    key = torch.where(live, key, _fill(key, _big(key.dtype)))
    ks, order = torch.sort(key, stable=True)
    is_first = _first_of_run(ks)
    is_last = torch.ones_like(is_first)
    is_last[:-1] = is_first[1:]
    run_id = (torch.cumsum(is_first, 0, dtype=torch.int32) - 1).long()
    live_s = live[order]
    w_s = w[order]

    out_cols: dict[str, torch.Tensor] = {g: cols[g][order] for g in group_by}
    group_live = _seg(live_s.to(torch.int32), run_id, "sum") > 0
    out_valid = is_last & group_live

    for ag in aggregates:
        a = cols[ag.var][order] if ag.var is not None else None
        if ag.distinct:
            raise NotImplementedError("DISTINCT inside GROUP BY")
        if ag.func == "count":
            out = _seg(w_s.to(_acc_dtype(w_s.dtype)), run_id, "sum")
        elif ag.func == "sum":
            acc = _acc_dtype(torch.promote_types(a.dtype, w_s.dtype))
            out = _seg(a.to(acc) * w_s.to(acc), run_id, "sum")
        elif ag.func == "avg":
            s = _seg(a.to(torch.float32) * w_s.to(torch.float32), run_id,
                     "sum")
            c = _seg(w_s.to(torch.float32), run_id, "sum")
            out = s / torch.clamp(c, min=1)
        elif ag.func == "min":
            v = torch.where(live_s, a, _fill(a, _big(a.dtype)))
            out = _seg(v, run_id, "amin")
        elif ag.func == "max":
            v = torch.where(live_s, a, _fill(a, _small(a.dtype)))
            out = _seg(v, run_id, "amax")
        elif ag.func == "median":
            out = _grouped_weighted_median(ks, a, w_s, live_s)
        else:
            raise NotImplementedError(f"{ag.func} with GROUP BY")
        out_cols[ag.name] = out
    return out_cols, out_valid


def _grouped_weighted_median(sorted_keys, values, weights, live):
    """Weighted median per group: one lexicographic sort by (group, value),
    then a segment-relative weighted-cumsum threshold — no group ever
    materialises (paper §4.2's PERCENTILE(0.5, A, c) generalised to
    GROUP BY)."""
    big = _big(values.dtype)
    v = torch.where(live, values, _fill(values, big))
    # lexsort((v, keys)): stable sort by value, then stable sort by key
    by_v = torch.sort(v, stable=True).indices
    order = by_v[torch.sort(sorted_keys[by_v], stable=True).indices]
    ks = sorted_keys[order]
    vs = v[order]
    ws = torch.where(live[order], weights[order],
                     torch.zeros_like(weights)).to(torch.float32)
    is_first = _first_of_run(ks)
    run_id = (torch.cumsum(is_first, 0, dtype=torch.int32) - 1).long()
    cw = torch.cumsum(ws, 0)
    run_start_cw = _seg(torch.where(is_first, cw - ws, _fill(cw, float("inf"))),
                        run_id, "amin")
    rel_cw = cw - run_start_cw                        # within-group cumsum
    total = _seg(rel_cw, run_id, "amax")
    # first row of each group whose cumulative weight reaches half
    reach = rel_cw >= 0.5 * total
    med = _seg(torch.where(reach, vs, _fill(vs, big)), run_id, "amin")
    # scatter medians back to the ORIGINAL (group-sorted) row order
    out = torch.zeros_like(values)
    out[order] = med.to(values.dtype)
    return out
