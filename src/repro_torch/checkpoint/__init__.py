"""Checkpoints of the LM stack's training state: the port of the JAX
package's ``repro.checkpoint``, in its on-disk format."""

from repro_torch.checkpoint.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
