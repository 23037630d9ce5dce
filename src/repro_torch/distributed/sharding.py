"""Logical-axis sharding rules, resolved to DTensor placements.

The port of the JAX package's ``distributed/sharding.py``.  Model code
names each weight's dims with *logical* axes; a rules table maps them onto
the axes of a ``torch.distributed.device_mesh.DeviceMesh``.  Outside a mesh
every annotation is a no-op.

Parallelism encoding (the reference's table, copied):
  batch   → ("pod", "data")   DP across pods and within pods
  fsdp    → "data"            parameter/optimizer sharding (ZeRO-3)
  tensor  → "model"           TP: heads / ffn / vocab / expert-ffn
  expert  → "data"            EP: expert dim of MoE weights
  kv_seq  → "data"            SP for long-context decode KV caches

``resolve_spec`` returns the reference's normalised PartitionSpec as a
plain tuple, one entry per dim: ``None``, a mesh axis name, or a tuple of
axis names.  It reads only the mesh's ``mesh_dim_names`` and ``shape``, so
it runs on any object that has them, with no process group.

A dim sharded over several axes is split major-to-minor in the order the
spec lists them, as JAX splits it: block ``c[a1]·s[a2] + c[a2]`` of a dim
over ``(a1, a2)``.  DTensor splits in mesh-dim order, so an axis that comes
before a more major one in the mesh takes a ``_StridedShard`` whose split
factor is the product of those more major axes' sizes (``placements``);
``local_block`` cuts a rank's block by its mesh coordinate as JAX does.

Computing on a mesh (the dense and MoE families' mesh train step): the
weights are DTensors of each rank's block, and ``weight_use`` gives a
weight as one use reads it: gathered along the data-parallel axes (those
of the ``"batch"`` rule, whose ranks hold other rows), still cut along
the others ("model"); the backward of that gather reduce-scatters the
weight's gradient.  ``shard`` places an activation at one of the
reference's annotation points, ``match`` puts one value in another's
placements (the residual stream's), and ``local_apply`` runs a function
on each rank's blocks of operands laid out for it (``models.layers
.matmul`` and the attention core).

The MoE layer's expert weights take ``expert_weight_use``: still cut
along the mesh dims that cut their expert dim, gathered along the other
data-parallel axes, so that each rank runs its own experts (or its slice
of their capacity) on a buffer cut the same way; ``redistribute_stepwise``
moves its buffers one mesh dim at a time (reduce-scatters onto the expert
blocks, gathers back).  ``row_blocks`` tells the MoE layer, which reads
the whole microbatch (capacity, first-come positions, load balance),
which row block of it the rank holds and which group holds the others:
the mesh step sets it on the placed path and on the gather path alike,
and a MoE model's ``prefill`` and ``decode_step`` on a mesh set it from
the batch rule (``batch_row_blocks``).

On the gather path (the recurrent families' mesh step) a rank computes
its block of whole rows of a microbatch on whole weights.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

# logical axis → mesh axis (None = replicated)
LOGICAL_RULES: dict[str, object] = {
    "batch": ("pod", "data"),
    # Megatron-style sequence parallelism: the residual stream between
    # blocks shards its seq dim over "model"; inside a block the seq axis
    # is dropped wherever it would collide with a tensor dim that already
    # uses "model" (resolve_spec dedup).
    "seq": "model",
    "embed": ("pod", "data"),  # FSDP/ZeRO-3 weight dim — across pods too
    "act_embed": None,      # activations keep embed unsharded (TP gathers)
    "heads": "model",
    "heads_fused": "model",  # h·hd fused projection dim (always divisible)
    "kv_heads": "model",
    "head_dim": None,
    "kv_head_dim": "model",  # KV-cache head_dim takes "model" when the
                             # kv-head count can't (GQA kv < 16)
    "mlp": "model",
    "vocab": "model",
    "experts": ("pod", "data"),
    "expert_mlp": "model",
    "dispatch_embed": "model",  # d_model during MoE scatter/gather
    "ssm_inner": "model",
    "ssm_state": None,
    "conv": None,
    "kv_seq": ("pod", "data"),  # sequence-parallel long-context KV
    "q_seq": "model",       # context parallelism: q positions take "model"
                            # when the kv-head count can't split it
    "layers": None,
    "stack": None,
}

# Secondary claims: if a dim's PRIMARY axes were unavailable/indivisible
# and another dim freed one of these axes, the named logical axis may
# claim it in a second pass (h2o-danube's d_head=120 can't take "model",
# so its KV-cache seq dim does).
SECONDARY_RULES: dict[str, tuple] = {
    "kv_seq": ("model",),
}

_state = threading.local()


def current_mesh():
    return getattr(_state, "mesh", None)


def current_rules() -> dict:
    return getattr(_state, "rules", LOGICAL_RULES)


@contextlib.contextmanager
def use_mesh(mesh, rules: dict | None = None):
    prev_mesh = getattr(_state, "mesh", None)
    prev_rules = getattr(_state, "rules", LOGICAL_RULES)
    _state.mesh = mesh
    _state.rules = dict(rules) if rules is not None else LOGICAL_RULES
    try:
        yield
    finally:
        _state.mesh = prev_mesh
        _state.rules = prev_rules


@dataclasses.dataclass(frozen=True)
class RowBlocks:
    """What a layer that reads a whole microbatch (MoE's capacity and
    first-come positions) must know on a mesh: its rank's rows are row
    block ``index`` of ``count`` equal blocks of the microbatch, in row
    order, and ``group`` is the process group of the ranks holding the
    ``count`` blocks (``index`` is not a rank of it)."""
    index: int
    count: int
    group: Any


def current_row_blocks() -> RowBlocks | None:
    return getattr(_state, "row_blocks", None)


@contextlib.contextmanager
def row_blocks(blocks: RowBlocks | None):
    """Sets (per thread, as ``use_mesh``) the row blocks of the
    microbatch that the code under it computes; None: the whole."""
    prev = getattr(_state, "row_blocks", None)
    _state.row_blocks = blocks
    try:
        yield
    finally:
        _state.row_blocks = prev


def batch_group(mesh, axes: tuple):
    """The process group of the ranks whose mesh coordinates differ only
    along ``axes`` (this rank's and the other blocks of its rows), from
    the mesh: one axis's group, or the group of the sub-mesh of several
    flattened into one; None when no axis cuts the rows.  The flattened
    sub-mesh is built from the mesh's rank tensor, which a fake mode
    cannot index: a dry run builds it before (the mesh keeps it)."""
    if not axes:
        return None
    names = list(mesh.mesh_dim_names)
    axes = tuple(sorted(axes, key=names.index))
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def batch_row_blocks(rows: int, mesh=None) -> RowBlocks | None:
    """The row blocks of a batch of ``rows`` rows placed by the batch rule
    on ``mesh`` (the current mesh by default) under the current rules:
    this rank's block (``block_of`` of the rows' spec) of the blocks the
    batch axes that divide ``rows`` cut it into, and the group holding
    the others (``batch_group``); None where no axis cuts the rows (every
    rank holds the whole batch, as at batch 1)."""
    mesh = current_mesh() if mesh is None else mesh
    entry = resolve_spec((rows,), ("batch",))[0]
    index, count = block_of(entry, mesh)
    if count == 1:
        return None
    return RowBlocks(index, count, batch_group(mesh, spec_axes(entry)))


@contextlib.contextmanager
def axis_rules(**overrides):
    """Temporarily override logical→mesh rules (perf experiments)."""
    rules = dict(current_rules())
    rules.update(overrides)
    with use_mesh(current_mesh(), rules):
        yield


def mesh_sizes(mesh) -> dict[str, int]:
    """Axis name → size of a ``DeviceMesh`` (or of anything with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def resolve_spec(shape: tuple[int, ...] | None,
                 logical_axes: tuple[str | None, ...]) -> tuple:
    """Map logical axis names to a spec under the current mesh and rules,
    rule for rule the reference's:

      * mesh axes absent from the current mesh are dropped;
      * a mesh axis may appear only once per spec (later duplicates are
        dropped);
      * a dim not divisible by its mesh-axis product is not sharded on it
        (the first single axis that divides is kept); freed axes are
        re-homed onto later unsharded, divisible dims whose logical axis is
        None, jointly first, then singly;
      * then ``SECONDARY_RULES``' named dims claim still-unused axes.

    ``shape=None`` skips divisibility checks (mesh-presence and duplicate
    rules still apply)."""
    mesh = current_mesh()
    rules = current_rules()
    sizes = mesh_sizes(mesh) if mesh is not None else {}
    avail = set(sizes)

    def candidates(ax):
        tgt = rules.get(ax) if ax is not None else None
        if tgt is None:
            return ()
        if isinstance(tgt, tuple):
            return tuple(t for t in tgt if t in avail)
        return (tgt,) if tgt in avail else ()

    used: set[str] = set()
    freed: list[str] = []
    out: list = []
    for i, ax in enumerate(logical_axes):
        cand = tuple(a for a in candidates(ax) if a not in used)
        dim = shape[i] if shape is not None else None

        def divides(axes):
            if dim is None or not axes:
                return bool(axes)
            prod = 1
            for a in axes:
                prod *= sizes.get(a, 1)
            return prod > 0 and dim % prod == 0

        chosen = ()
        if divides(cand):
            chosen = cand
        else:
            for a in cand:
                if divides((a,)):
                    chosen = (a,)
                    break
            freed.extend(a for a in cand if a not in chosen)
        used.update(chosen)
        out.append(chosen)

    if shape is not None:
        freed = [a for i, a in enumerate(freed)
                 if a not in used and a not in freed[:i]]

        def try_place(axes_tuple):
            prod = 1
            for a in axes_tuple:
                prod *= sizes.get(a, 1)
            if prod <= 1:
                return False
            for i, cur in enumerate(out):
                if not cur and logical_axes[i] is None \
                        and shape[i] % prod == 0 and shape[i] > 1:
                    out[i] = axes_tuple
                    used.update(axes_tuple)
                    return True
            return False

        if freed and not try_place(tuple(freed)):
            for a in list(freed):
                if a not in used:
                    try_place((a,))

        for i, ax in enumerate(logical_axes):
            if out[i] or ax not in SECONDARY_RULES:
                continue
            for a in SECONDARY_RULES[ax]:
                if a in used or a not in avail:
                    continue
                if sizes.get(a, 1) > 1 and shape[i] % sizes.get(a, 1) == 0:
                    out[i] = (a,)
                    used.add(a)
                    break

    return tuple(c if len(c) > 1 else (c[0] if c else None) for c in out)


def logical_spec(*logical_axes: str | None, shape=None) -> tuple:
    return resolve_spec(shape, logical_axes)


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one entry of a resolved spec, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim ``d`` takes, ``Replicate()`` elsewhere; a
    mesh dim that comes before a more major axis of the same tensor dim
    (a spec listing axes out of mesh order) takes ``_StridedShard(d)``
    split by those axes' sizes, so that each rank holds JAX's block."""
    from torch.distributed.tensor.placement_types import _StridedShard

    names = list(mesh.mesh_dim_names)
    sizes = mesh_sizes(mesh)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        for k, a in enumerate(axes):
            j = names.index(a)
            split = math.prod(sizes[b] for b in axes[:k]
                              if names.index(b) > j)
            out[j] = Shard(d) if split == 1 else _StridedShard(
                d, split_factor=split)
    return tuple(out)


def local_block(full: torch.Tensor, spec: tuple, mesh,
                coordinate=None) -> torch.Tensor:
    """The block of ``full`` that the rank at ``coordinate`` (this rank's
    mesh coordinate by default) holds under ``spec``: along each dim, block
    ``Σ c[a]·(sizes of the axes listed after a)`` of ``Π sizes`` equal
    blocks, as JAX cuts it.  A view of ``full``."""
    index = []
    for d, entry in enumerate(spec):
        b, n = block_of(entry, mesh, coordinate)
        if full.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(full.shape)} does not split "
                             f"into {n} blocks ({spec})")
        size = full.shape[d] // n
        index.append(slice(b * size, (b + 1) * size))
    return full[tuple(index)]


def block_of(entry, mesh, coordinate=None) -> tuple[int, int]:
    """``(b, n)``: a dim cut by a spec's ``entry`` is ``n`` equal blocks,
    and the rank at ``coordinate`` (this rank's by default) holds block
    ``b = Σ c[a]·(sizes of the axes listed after a)``, as JAX cuts it."""
    if coordinate is None:
        coordinate = mesh.get_coordinate()
    sizes = mesh_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, coordinate))
    n, b = 1, 0
    for a in spec_axes(entry):
        b = b * sizes[a] + coord[a]
        n *= sizes[a]
    return b, n


def mesh_device(mesh) -> torch.device:
    """The device that holds this rank's blocks on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """One leaf's layout on ``mesh``: its resolved ``spec`` and the DTensor
    ``placements`` that hold it."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def local(self, full: torch.Tensor) -> torch.Tensor:
        return local_block(full, self.spec, self.mesh)

    def distribute(self, full: torch.Tensor):
        """A DTensor of ``full``'s values laid out by this sharding: each
        rank copies its own block from ``full`` (no communication)."""
        block = self.local(full).to(mesh_device(self.mesh), copy=True)
        return DTensor.from_local(
            block.contiguous(), self.mesh, self.placements, run_check=False,
            shape=full.shape,
            stride=torch.empty(full.shape, device="meta").stride())


def shard(x, *logical_axes: str | None):
    """A DTensor ``x`` redistributed to its logical axes' placements under
    the current mesh; ``x`` itself outside a mesh or when it is not a
    DTensor."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = resolve_spec(tuple(x.shape), tuple(logical_axes))
    return x.redistribute(mesh, placements(spec, mesh))


def weight_use(w, dtype=None):
    """``w`` as one use reads it: cast to ``dtype`` (where given), then, a
    DTensor under a mesh, gathered along the data-parallel axes (the
    ``"batch"`` rule's) and left cut along every other.  The cast comes
    first: it is elementwise, so the gathered bits are the same, and the
    gather moves the compute dtype's bytes.  The backward sums the use's
    gradient over those axes into each rank's block (a reduce-scatter)."""
    return _use(w, dtype, experts=False)


def expert_weight_use(w, dtype=None):
    """An expert weight (dim 0 its experts) as one use of the placed MoE
    layer reads it: ``weight_use``'s cast and gather, but still cut along
    each mesh dim that cuts its expert dim, where the layer's buffer is
    cut the same way (``models.moe._placed_moe``).  The backward
    reduce-scatters the use's gradient along the gathered axes only."""
    return _use(w, dtype, experts=True)


def _use(w, dtype, experts: bool):
    if dtype is not None:
        w = w.to(dtype)
    mesh = current_mesh()
    if mesh is None or not isinstance(w, DTensor):
        return w
    data = set(spec_axes(current_rules().get("batch")))
    use = tuple(Replicate() if name in data
                and not (experts and p.is_shard(0)) else p
                for name, p in zip(w.device_mesh.mesh_dim_names,
                                   w.placements))
    return w if use == w.placements else _WeightUse.apply(w, use)


class _WeightUse(torch.autograd.Function):
    """A weight gathered for one use; the backward puts the use's gradient
    back into the weight's placements one mesh dim at a time, outermost
    first, so that each cut dim is a reduce-scatter (DTensor's one-shot
    plan for several partial dims all-reduces some of them)."""

    @staticmethod
    def forward(ctx, w, use):
        ctx.placements = w.placements
        return w.redistribute(w.device_mesh, use)

    @staticmethod
    def backward(ctx, g):
        mesh = g.device_mesh
        if not all(type(p) in (Shard, Replicate) for p in ctx.placements):
            return g.redistribute(mesh, ctx.placements), None
        for i, p in enumerate(ctx.placements):
            if g.placements[i] != p:
                step = list(g.placements)
                step[i] = p
                g = g.redistribute(mesh, step)
        return g, None


def redistribute_stepwise(t, target):
    """The DTensor ``t`` in placements ``target``, one mesh dim at a time
    (``_steps``).  DTensor's one-shot plans all-reduce where a
    reduce-scatter does: for several partial dims, and in the backward of
    a gather along one mesh dim while another is partial.  The backward
    puts the gradient in ``t``'s placements the same way (a partial
    placement of ``t`` takes a replicated gradient)."""
    target = tuple(target)
    return t if target == tuple(t.placements) else _Stepwise.apply(t,
                                                                  target)


def _steps(t, target):
    """``t`` moved to ``target`` one mesh dim at a time: its partial sums
    first, outermost mesh dim first (each a reduce-scatter, or an
    all-reduce where ``target`` replicates), then the blocks it cuts from
    whole dims (local), then its gathers, innermost first, and any move of
    a cut between tensor dims last."""
    mesh = t.device_mesh
    cur = list(t.placements)
    n = len(cur)
    order = ([i for i in range(n) if cur[i].is_partial()]
             + [i for i in range(n) if cur[i].is_replicate()
                and target[i].is_shard()]
             + [i for i in reversed(range(n)) if cur[i].is_shard()
                and target[i].is_replicate()])
    for i in order:
        if cur[i] != target[i]:
            cur[i] = target[i]
            t = t.redistribute(mesh, tuple(cur))
    if tuple(cur) != tuple(target):
        t = t.redistribute(mesh, tuple(target))
    return t


class _Stepwise(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, target):
        ctx.placements = tuple(Replicate() if p.is_partial() else p
                               for p in t.placements)
        return _steps(t, target)

    @staticmethod
    def backward(ctx, g):
        return _steps(g, ctx.placements), None


def match(y, x):
    """``y`` in ``x``'s placements (a DTensor's partial sums reduced, its
    shards moved); ``y`` itself unless both are DTensors."""
    if not (isinstance(y, DTensor) and isinstance(x, DTensor)) \
            or y.placements == x.placements:
        return y
    return y.redistribute(x.device_mesh, x.placements)


def block_start(t, dim: int) -> int:
    """Where this rank's block of the DTensor ``t`` starts along ``dim``
    (0 where no mesh dim cuts it): mesh dims cut it outermost first, as
    DTensor nests ``Shard`` placements.  Read from the mesh coordinate,
    which a fake mode leaves alone."""
    first, n = 0, 1
    for c, size, p in zip(t.device_mesh.get_coordinate(),
                          t.device_mesh.shape, t.placements):
        if p.is_shard(dim):
            first, n = first * size + c, n * size
    return first * (t.shape[dim] // n)


def block_ranges(t) -> list[tuple[int, int]]:
    """``(first, size)`` of this rank's block of the DTensor ``t`` along
    each dim (``block_start`` and the local block's size)."""
    local = t.to_local().shape
    return [(block_start(t, d), local[d]) for d in range(t.ndim)]


def take_block(t, ranges: dict):
    """This rank's block of the DTensor ``t`` cut to the global ``ranges``
    (dim → ``(first, size)``), each within the block: a view of the local
    block, no communication.  Raises ``ValueError`` where the block does
    not hold a range."""
    index = []
    for d, (first, size) in enumerate(block_ranges(t)):
        lo, n = ranges.get(d, (first, size))
        if not first <= lo <= lo + n <= first + size:
            raise ValueError(f"dim {d}: this rank holds [{first}, "
                             f"{first + size}), not [{lo}, {lo + n})")
        index.append(slice(lo - first, lo - first + n))
    return t.to_local()[tuple(index)]


def write_block(dst, src, dim: int, start: int) -> None:
    """Writes the DTensor ``src``, standing at ``start`` along ``dim`` of
    the DTensor ``dst``, into this rank's block of ``dst`` in place: where
    its block of ``dim`` meets ``src``'s positions, from its own block of
    ``src``, which must hold all of ``dst``'s block along every other dim
    (a value the ranks of a mesh dim that cuts ``dst`` there hold whole,
    or one cut as ``dst`` is).  No communication; a rank whose block
    holds none of ``src``'s positions writes nothing."""
    (d0, dn), (s0, sn) = block_ranges(dst)[dim], block_ranges(src)[dim]
    lo, hi = max(d0, start + s0), min(d0 + dn, start + s0 + sn)
    if lo >= hi:
        return
    out = dst.to_local()
    index = [slice(None)] * dst.ndim
    index[dim] = slice(lo - d0, hi - d0)
    ranges = {d: r for d, r in enumerate(block_ranges(dst)) if d != dim}
    ranges[dim] = (lo - start, hi - lo)
    out[tuple(index)] = take_block(src, ranges).to(out.dtype)


def block_take(take, ids, block, first: int, dim: int):
    """``take(i, block)`` for the ids of ``ids`` that fall in ``block``, a
    block of a table that starts at id ``first`` along ``dim`` (``i`` their
    offsets in it), zeros for every other id: one rank's share of a lookup
    in a table cut into blocks (a partial sum over the ranks holding them).
    All of them, with ``take``'s own bits, when ``block`` is the whole
    table (``first`` 0)."""
    idx = ids - first
    hit = (idx >= 0) & (idx < block.shape[dim])
    out = take(torch.where(hit, idx, 0), block)
    return torch.where(hit.reshape(hit.shape + (1,) * (out.ndim - hit.ndim)),
                       out, 0.0)


def _as_dtensor(t, mesh):
    """``t`` replicated on ``mesh`` (a plain tensor, the same on every
    rank), or ``t`` itself when it is a DTensor."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def replicated_like(t, like):
    """A plain tensor that is the same on every rank, as a replicated
    DTensor on ``like``'s mesh where ``like`` is a DTensor; else ``t``."""
    if not isinstance(like, DTensor):
        return t
    return _as_dtensor(t, like.device_mesh)


def local_apply(fn, args, in_placements, out_placements):
    """``fn(*args)`` on each rank's blocks.  Each operand is redistributed
    to its placements in ``in_placements`` (a plain tensor is taken as the
    same on every rank), ``fn`` runs on the local blocks, and its output
    becomes a DTensor of ``out_placements`` (each of its outputs, where it
    returns a tuple).  An operand replicated on a mesh dim where the
    output is not has a partial gradient there: every rank's block of the
    output read all of it.  Without a DTensor operand it is
    ``fn(*args)``."""
    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)),
                None)
    if mesh is None:
        return fn(*args)
    out_placements = tuple(out_placements)
    local = []
    for a, pl in zip(args, in_placements):
        pl = tuple(pl)
        a = _as_dtensor(a, mesh)
        if a.placements != pl:
            # (a redistribution to the same placements would turn the
            # partial gradient back into a replicated one: an all-reduce)
            a = a.redistribute(mesh, pl)
        grad = tuple(
            Replicate() if p.is_partial() else
            Partial() if p.is_replicate() and not o.is_replicate() else p
            for p, o in zip(pl, out_placements))
        local.append(a.to_local(grad_placements=grad))
    out = fn(*local)
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(o, mesh, out_placements,
                                        run_check=False) for o in out)
    return DTensor.from_local(out, mesh, out_placements, run_check=False)
