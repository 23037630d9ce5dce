"""Semi-join (paper §4.1, the 0MA sweep): the CUDA kernel K1 and its plain
version.

The semi-join is FreqJoin in the Boolean semiring, so K1 is the hash join of
``csrc/freq_join.cu`` in ``any`` mode: only live child rows (freq > 0) enter
the table, and a parent row keeps its frequency iff its key is there.
``out_i = parent_freq[i]`` if a live child row has an equal key, else 0.
"""

from __future__ import annotations

from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.autotune import KernelConfig
from repro_torch.kernels.freq_join import (
    HASH_JOIN_ARGTYPES,
    freq_join_plain,
    hash_join,
)

K1 = CudaKernel("semi_join", "freq_join.cu", "repro_hash_join",
                HASH_JOIN_ARGTYPES)


def semi_join_cuda(parent_keys, parent_freq, child_keys, child_freq,
                   config: KernelConfig | None = None):
    """K1 on the card, under ``config``'s Hopper knobs."""
    return hash_join(K1, parent_keys, parent_freq, child_keys, child_freq,
                     "any", config)


def semi_join_plain(parent_keys, parent_freq, child_keys, child_freq, *,
                    domain: int | None = None,
                    config: KernelConfig | None = None):
    """The JAX package's XLA semi-join, op for op."""
    return freq_join_plain(parent_keys, parent_freq, child_keys, child_freq,
                           mode="any", domain=domain, config=config)
