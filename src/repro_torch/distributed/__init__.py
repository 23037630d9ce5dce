"""The port of the JAX package's ``repro.distributed``: so far the train
step's gradient compression (``ef_int8_roundtrip``).  The logical sharding
rules and the compressed all-reduce wait for the distributed training
slice."""

from repro_torch.distributed.compression import ef_int8_roundtrip

__all__ = ["ef_int8_roundtrip"]
