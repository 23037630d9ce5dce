"""Hand-written CUDA kernels for the paper's physical operators.

  csrc/freq_join.cu   — K2 FreqJoin and K1 semi-join: a two-phase hash join
  csrc/segment_sum.cu — K3 sorted group-by-SUM: one single-pass segmented
                        scan with decoupled look-back
  freq_join.py, semi_join.py, segment_sum.py — wrappers, launch counts and
                        the plain PyTorch version of each kernel
  ops.py              — public ops (import them from here): the input's
                        device picks kernel or plain
  ref.py              — O(N·M) oracles (ground truth for tests)
  _build.py           — nvcc build on first use, ctypes loading
"""
