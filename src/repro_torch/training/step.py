"""Train step: microbatched gradient accumulation + AdamW.

The port of the JAX package's ``training/step.py``.  The global batch is
split into M microbatches, each one forward and one backward (a Python
loop, where the reference runs a ``lax.scan``); gradients accumulate in
float32, so peak activation memory is that of one microbatch.  Each block
of the model is rematerialised under the caller's policy
(``models.model.REMAT``).  Optional int8 error-feedback compression
(``distributed.compression``) applies to the averaged gradient before the
optimizer.

The step updates the model's parameters in place (``TrainState.model``)
and returns the state with ``step + 1``; its metrics stay tensors on the
model's device, and nothing inside the step is read back to the host.

Called under ``distributed.use_mesh(mesh)``, as the reference calls its
step, the same step runs over the mesh on a state that
``place_train_state`` (or ``Checkpointer.restore(shardings=...)``) laid
out there: every weight and AdamW moment a DTensor holding this rank's
block, by the logical rules.  Each rank is given the whole global batch
and takes its block of whole rows of every microbatch, along the batch
axes that divide the row count (``microbatch_specs``; microbatch ``i`` is
the same rows as on one device).  The norm, the clip and the int8 round
trip see the whole gradient; AdamW updates each rank's blocks.

A dense or MoE model (``TP_FAMILIES``) computes on its placed weights,
as GSPMD partitions the reference: the microbatch enters as a DTensor,
each use of a weight gathers it along the data-parallel axes only
(``"model"`` stays cut: tensor-parallel products), the reference's
``shard`` annotations place the activations (the residual stream's
sequence over ``"model"``), and the loss is the whole microbatch's.  A
MoE layer's expert weights stay cut along the axes that cut their expert
dim (``sharding.expert_weight_use``): its tokens move to the ranks
holding their experts' buffer blocks and back at the reference's
``shard()`` points (``models.moe``), and the step tells it which row
block of the microbatch the rank holds (``sharding.row_blocks``), so
that its capacity, first-come positions, ``density``, ``dropped_frac``
and load balance are the whole microbatch's.  The gradients come back in
the weights' placements (each use's reduce-scatter) and accumulate in
float32 as each rank's blocks: no weight is gathered whole and no
gradient accumulated whole.

The other families (rwkv6, mamba2 and the hybrid) take the gather path:
each weight gathered once for the forward and the backward, their rows
computed on whole weights; the losses divide by the whole microbatch's
token count, so the float32 gradients summed over the ranks holding the
other rows are the microbatch's.  Ranks along axes that do not shard the
batch compute the same rows.  A MoE model takes it too where
``TP_FAMILIES`` leaves "moe" out (the tests' and ``chip_smoke.py``'s
comparison): its layer then exchanges per-expert counts over the batch
group as above, returns its ``load_balance`` and ``router_z`` as this
rank's shares, summed over the group with the losses, and runs the
experts on whole weights over its own ``[e, cap]`` buffer.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.distributed.compression import ef_int8_roundtrip
from repro_torch.distributed.sharding import (
    NamedSharding,
    RowBlocks,
    batch_group,
    block_of,
    current_mesh,
    current_rules,
    local_block,
    match,
    mesh_device,
    resolve_spec,
    row_blocks,
    spec_axes,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM, forward
from repro_torch.training.losses import IGNORE, cross_entropy_loss
from repro_torch.training.optimizer import (
    AdamWState,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)

# the families whose mesh step computes on the placed weights
TP_FAMILIES = ("dense", "moe")
# (moved to ``distributed.sharding``; the old name stays for its callers)
_batch_group = batch_group


@dataclasses.dataclass
class TrainState:
    model: LM             # its parameters, updated in place by each step
    opt: AdamWState
    step: torch.Tensor    # int32 scalar on the model's device
    # on a mesh: each weight's (and its moments') sharding by name, the
    # weights and moments DTensors of this rank's blocks; None on one device
    shardings: dict[str, NamedSharding] | None = None

    @property
    def params(self) -> dict[str, torch.nn.Parameter]:
        return dict(self.model.named_parameters())


def init_train_state(model: LM, opt_state_dtype=torch.float32) -> TrainState:
    """Makes ``model``'s weights require gradients and pairs them with
    zero AdamW moments in ``opt_state_dtype``."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    opt = adamw_init(params, opt_state_dtype)
    return TrainState(model, opt, torch.zeros_like(opt.step))


def train_loss(model: LM, cfg: ModelConfig, batch: dict, *,
               remat: str = "full", tokens: torch.Tensor | None = None):
    """The reference's ``loss_fn``: masked cross-entropy with z-loss over
    ``forward``'s logits (a vision stub's patch positions carry no label),
    plus, for MoE, ``router_aux_weight · load_balance + router_z_weight ·
    router_z``; the cross-entropy's sums divided by ``tokens`` where given
    (``cross_entropy_loss``).  Returns (loss, metrics)."""
    logits, aux = forward(model, cfg, batch, remat=remat)
    labels = batch["labels"]
    if cfg.frontend == "vision_stub":
        pad = labels.new_full(labels.shape[:1] + (cfg.num_patches,), IGNORE)
        labels = torch.cat([pad, labels], dim=1)
    loss, metrics = cross_entropy_loss(logits, labels, tokens=tokens)
    if cfg.family == "moe" and aux is not None:
        loss = loss + cfg.router_aux_weight * aux["load_balance"] \
            + cfg.router_z_weight * aux["router_z"]
        metrics = dict(metrics, load_balance=aux["load_balance"],
                       dropped_frac=aux["dropped_frac"])
    return loss, metrics


def build_train_step(cfg: ModelConfig, *, microbatches: int = 1,
                     base_lr: float = 3e-4, warmup: int = 100,
                     total_steps: int = 10_000, remat: str = "full",
                     compress_grads: bool = False,
                     weight_decay: float = 0.1) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    batch: {"tokens" [B,S], "labels" [B,S], optional "image_embeds"} on the
    model's device (on a mesh: the whole global batch on every rank); B
    must divide by ``microbatches``.  metrics: ``loss`` (the mean over the
    microbatches), the last microbatch's loss metrics, ``grad_norm`` and
    ``lr``.  Under ``use_mesh(mesh)`` the step is the mesh step (the
    module's docstring); every rank calls it."""
    lr_fn = cosine_schedule(base_lr, warmup, total_steps)
    m = microbatches

    def grads_of(model, batch, local_rows, group):
        """The summed float32 gradients of the microbatches' losses over
        ``model``'s weights, the summed losses, the last microbatch's
        metrics.  ``local_rows`` cuts a rank's rows out of a microbatch,
        and ``group`` sums each microbatch's token count over the ranks
        holding its other rows (both None on one device; ``group`` None
        too where the rank holds every row)."""
        weights = list(model.parameters())
        g_acc = [torch.zeros(w.shape, dtype=torch.float32, device=w.device)
                 for w in weights]
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=weights[0].device)
        rows = next(iter(batch.values())).shape[0] // m
        for i in range(m):
            mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            tokens = None
            if local_rows is not None:
                mb = local_rows(mb)
                tokens = (mb["labels"] != IGNORE).sum().to(torch.float32)
                if group is not None:
                    dist.all_reduce(tokens, group=group)
            loss, metrics = train_loss(model, cfg, mb, remat=remat,
                                       tokens=tokens)
            grads = torch.autograd.grad(loss, weights)
            torch._foreach_add_(g_acc, [g.to(torch.float32) for g in grads])
            loss_sum = loss_sum + loss.detach()
            del grads, loss
        metrics = {k: v.detach() for k, v in metrics.items()}
        if tokens is not None:
            metrics["tokens"] = tokens.to(torch.int32)
        return g_acc, loss_sum, metrics

    def placed_grads(model, batch, specs, mesh):
        """``grads_of`` on the placed model itself (``TP_FAMILIES``): each
        microbatch a DTensor of each rank's rows (``row_blocks`` says
        which block of them, for MoE), the loss the whole microbatch's,
        the float32 gradients accumulated as each rank's blocks and
        returned as DTensors in the weights' placements."""
        weights = list(model.parameters())
        g_acc = [torch.zeros(w.to_local().shape, dtype=torch.float32,
                             device=w.device) for w in weights]
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=weights[0].device)
        rows = next(iter(batch.values())).shape[0] // m
        for i in range(m):
            mb = {k: NamedSharding(mesh, specs[k]).distribute(
                v[i * rows:(i + 1) * rows]) for k, v in batch.items()}
            loss, metrics = train_loss(model, cfg, mb, remat=remat)
            loss = loss.full_tensor()
            grads = torch.autograd.grad(loss, weights)
            # a replicated weight's gradient comes back as partial sums
            torch._foreach_add_(g_acc, [match(g, w).to_local().to(
                torch.float32) for g, w in zip(grads, weights)])
            loss_sum = loss_sum + loss.detach()
            del grads, loss
        metrics = {k: v.full_tensor().detach() for k, v in metrics.items()}
        grads = {n: DTensor.from_local(g, w.device_mesh, w.placements,
                                       run_check=False, shape=w.shape,
                                       stride=w.stride())
                 for (n, w), g in zip(model.named_parameters(),
                                      torch._foreach_div(g_acc, m))}
        return grads, loss_sum, metrics

    def update(state, grads, loss_sum, metrics, shardings=None):
        if compress_grads:
            grads = {n: ef_int8_roundtrip(g) for n, g in grads.items()}
        params, opt = state.params, state.opt
        gnorm = global_norm(grads)
        if shardings is not None:      # each rank updates its blocks
            grads = {n: g.to_local() if isinstance(g, DTensor)
                     else shardings[n].local(g) for n, g in grads.items()}
            with torch.no_grad():
                params = {n: p.to_local() for n, p in params.items()}
                opt = AdamWState(opt.step,
                                 {n: t.to_local() for n, t in opt.m.items()},
                                 {n: t.to_local() for n, t in opt.v.items()})
        _, opt, opt_metrics = adamw_update(
            grads, opt, params, lr=lr_fn(state.step),
            weight_decay=weight_decay, grad_norm=gnorm)
        return TrainState(
            state.model, AdamWState(opt.step, state.opt.m, state.opt.v),
            state.step + 1, state.shardings), {
            "loss": loss_sum / m, **metrics, **opt_metrics}

    def local_step(state: TrainState, batch: dict):
        g_acc, loss_sum, metrics = grads_of(state.model, batch, None, None)
        grads = dict(zip(state.params, torch._foreach_div(g_acc, m)))
        del g_acc
        return update(state, grads, loss_sum, metrics)

    def mesh_step(state: TrainState, batch: dict, mesh):
        if state.shardings is None:
            raise ValueError("a mesh step takes a state placed on the mesh "
                             "(place_train_state, or Checkpointer.restore "
                             "with shardings)")
        specs = microbatch_specs(batch, m)
        axes = spec_axes(specs["tokens"][0])
        index, count = block_of(specs["tokens"][0], mesh)
        if cfg.family in TP_FAMILIES:
            # the data-parallel axes' flattened sub-mesh: DTensor gathers a
            # weight along them in one collective
            batch_group(mesh, tuple(a for a in mesh.mesh_dim_names if a in
                                    spec_axes(current_rules()["batch"])))
            with row_blocks(RowBlocks(index, count, batch_group(mesh, axes))
                            if count > 1 else None):
                grads, loss_sum, metrics = placed_grads(state.model, batch,
                                                        specs, mesh)
            return update(state, grads, loss_sum, metrics, state.shardings)
        group = batch_group(mesh, axes)
        with torch.no_grad():       # each weight gathered once
            full = {n: p.full_tensor() for n, p in state.params.items()}
        compute = LM(cfg, "meta")
        compute.load_state_dict(full, assign=True)
        compute.requires_grad_(True)
        del full
        with row_blocks(RowBlocks(index, count, group) if count > 1
                        else None):
            g_acc, loss_sum, metrics = grads_of(
                compute, batch, lambda mb: {
                    k: local_block(v, specs[k], mesh) for k, v in mb.items()},
                group)
        del compute
        if group is not None:
            # the microbatches' gradients, losses and (MoE) load-balance
            # shares summed over the ranks holding the other rows
            for g in g_acc:
                dist.all_reduce(g, group=group)
            shares = [n for n in ("ce", "zloss", "load_balance")
                      if n in metrics]
            sums = torch.stack([loss_sum, *(metrics[n] for n in shares)])
            dist.all_reduce(sums, group=group)
            loss_sum, *summed = sums.unbind()
            metrics.update(zip(shares, summed))
        grads = dict(zip(state.params, torch._foreach_div(g_acc, m)))
        del g_acc
        return update(state, grads, loss_sum, metrics, state.shardings)

    def train_step(state: TrainState, batch: dict):
        mesh = current_mesh()
        if mesh is None:
            return local_step(state, batch)
        return mesh_step(state, batch, mesh)

    return train_step


def microbatch_specs(batch: dict, microbatches: int) -> dict[str, tuple]:
    """Each batch leaf's spec for one microbatch under the current mesh:
    its rows (dim 0) by the ``"batch"`` rule, every other dim whole, so a
    rank's block is always whole rows.  Rows that do not divide by the
    batch axes keep only the axes they divide by (``resolve_spec``'s
    fallback); the freed axes compute the same rows."""
    rows = next(iter(batch.values())).shape[0] // microbatches
    spec = resolve_spec((rows,), ("batch",))
    return {k: spec + (None,) * (v.dim() - 1) for k, v in batch.items()}


def param_shardings(model: LM, tree: dict) -> dict[str, NamedSharding]:
    """Each of ``model``'s weight names with its sharding, from ``tree``
    (the parameter part of ``launch.inputs.state_shardings``, by the
    reference tree's paths): a ``layers.<i>....`` weight takes its stacked
    leaf's sharding without the leading ``"layers"`` entry, which must be
    replicated."""
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        path = ["layers", *parts[2:]] if parts[0] == "layers" else parts
        sh = tree
        for key in path:
            sh = sh[key]
        if parts[0] == "layers":
            if sh.spec[0] is not None:
                raise ValueError(f"{'/'.join(path)}: the layer dim is "
                                 f"sharded ({sh.spec})")
            sh = NamedSharding(sh.mesh, sh.spec[1:])
        out[name] = sh
    return out


def placed_model(cfg: ModelConfig, weights: dict, like: LM) -> LM:
    """A new ``LM`` holding ``weights`` (DTensors or tensors by name), each
    requiring gradients as ``like``'s weight of its name does."""
    model = LM(cfg, "meta")
    model.load_state_dict(weights, assign=True)
    for w, w0 in zip(model.parameters(), like.parameters()):
        w.requires_grad_(w0.requires_grad)
    return model


def place_train_state(state: TrainState, shardings) -> TrainState:
    """``state`` (whole, the same on every rank) laid out on a mesh by
    ``shardings``, the tree ``launch.inputs.state_shardings`` gives: the
    weights and AdamW moments become DTensors of this rank's blocks (each
    rank copies its own; no communication), the two step counters tensors
    on the mesh's device, the same on every rank."""
    by_name = param_shardings(state.model, shardings[0])
    dev = mesh_device(next(iter(by_name.values())).mesh)
    with torch.no_grad():
        weights, m, v = ({n: by_name[n].distribute(t) for n, t in ts.items()}
                         for ts in (state.params, state.opt.m, state.opt.v))
    return TrainState(placed_model(state.model.cfg, weights, state.model),
                      AdamWState(state.opt.step.to(dev, copy=True), m, v),
                      state.step.to(dev, copy=True), by_name)
