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
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.distributed.compression import ef_int8_roundtrip
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM, forward
from repro_torch.training.losses import IGNORE, cross_entropy_loss
from repro_torch.training.optimizer import (
    AdamWState,
    adamw_init,
    adamw_update,
    cosine_schedule,
)


@dataclasses.dataclass
class TrainState:
    model: LM             # its parameters, updated in place by each step
    opt: AdamWState
    step: torch.Tensor    # int32 scalar on the model's device

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
               remat: str = "full"):
    """The reference's ``loss_fn``: masked cross-entropy with z-loss over
    ``forward``'s logits (a vision stub's patch positions carry no label),
    plus, for MoE, ``router_aux_weight · load_balance + router_z_weight ·
    router_z``.  Returns (loss, metrics)."""
    logits, aux = forward(model, cfg, batch, remat=remat)
    labels = batch["labels"]
    if cfg.frontend == "vision_stub":
        pad = torch.full(labels.shape[:1] + (cfg.num_patches,), IGNORE,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    loss, metrics = cross_entropy_loss(logits, labels)
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
    model's device; B must divide by ``microbatches``.  metrics: ``loss``
    (the mean over the microbatches), the last microbatch's loss metrics,
    ``grad_norm`` and ``lr``."""
    lr_fn = cosine_schedule(base_lr, warmup, total_steps)
    m = microbatches

    def train_step(state: TrainState, batch: dict):
        params = state.params
        weights = list(params.values())
        g_acc = [torch.zeros(w.shape, dtype=torch.float32, device=w.device)
                 for w in weights]
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=state.step.device)
        rows = next(iter(batch.values())).shape[0] // m
        for i in range(m):
            mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            loss, metrics = train_loss(state.model, cfg, mb, remat=remat)
            grads = torch.autograd.grad(loss, weights)
            torch._foreach_add_(g_acc, [g.to(torch.float32) for g in grads])
            loss_sum = loss_sum + loss.detach()
            del grads, loss
        grads = dict(zip(params, torch._foreach_div(g_acc, m)))
        del g_acc
        if compress_grads:
            grads = {n: ef_int8_roundtrip(g) for n, g in grads.items()}
        _, opt, opt_metrics = adamw_update(
            grads, state.opt, params, lr=lr_fn(state.step),
            weight_decay=weight_decay)
        return TrainState(state.model, opt, state.step + 1), {
            "loss": loss_sum / m,
            **{k: v.detach() for k, v in metrics.items()},
            **opt_metrics}

    return train_step
