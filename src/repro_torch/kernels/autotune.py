"""Kernel dispatch configuration.

Only the part of the JAX package's tuner that the plain versions read is
here: the dense-domain crossover of the plain FreqJoin (``ops.py``), where
a sort + searchsorted pipeline hands over to one scatter-add into a
domain-sized accumulator.  The measured search waits for a later slice; the
hand-written kernels take no tunable here (their launch shapes are fixed in
the CUDA sources).
"""

from __future__ import annotations

import dataclasses

# structural (non-tunable) bound on the dense-domain accumulator: int32
# packed keys cannot index past 2^31 regardless of measured preference
DENSE_DOMAIN_CAP = 1 << 31


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One point in the dispatch space.  The defaults reproduce the JAX
    package's untuned ``max(4·nc, 2^20)`` dense-domain crossover;
    ``dense_ratio <= 0`` disables the dense path entirely."""

    dense_ratio: int = 4
    dense_floor: int = 1 << 20

    def dense_ok(self, domain: int | None, n_child: int) -> bool:
        """Should the plain FreqJoin take the scatter-add dense path for
        this (domain, child-size)?"""
        return (domain is not None and self.dense_ratio > 0
                and domain <= max(self.dense_ratio * n_child,
                                  self.dense_floor)
                and domain < DENSE_DOMAIN_CAP)


DEFAULT_CONFIG = KernelConfig()
