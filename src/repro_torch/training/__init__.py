"""The LM training path: the loss, AdamW and the microbatched train step.

The port of the JAX package's ``repro.training``."""

from repro_torch.training.losses import cross_entropy_loss
from repro_torch.training.optimizer import AdamWState, adamw_init, adamw_update
from repro_torch.training.step import (
    TrainState,
    build_train_step,
    init_train_state,
    place_train_state,
    train_loss,
)

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "cross_entropy_loss",
    "TrainState",
    "build_train_step",
    "init_train_state",
    "place_train_state",
    "train_loss",
]
