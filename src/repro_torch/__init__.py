"""repro_torch — Avoiding Materialisation for Guarded Aggregate Queries, in
PyTorch with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of the JAX package ``repro``, slice by slice; ``repro`` stays the
reference.  Layers:
  repro_torch.tables  — fixed-capacity columnar tables with frequencies
  repro_torch.kernels — CUDA kernels (+ plain PyTorch versions + oracles)
  repro_torch.core    — query IR, join trees, 0MA, rewrites, executor
  repro_torch.data    — synthetic relational datasets and queries
  repro_torch.service — the SQL serving tier
  repro_torch.configs, repro_torch.models — the LM stack's serving path
                        (dense and MoE models, ``ServeEngine``;
                        ``repro_torch.launch.serve`` its launcher)
Entry points put data on the GPU unless the caller names another device.
"""
