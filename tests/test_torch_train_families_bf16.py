"""The port's bfloat16 gradients against the JAX package's, per family.

The bfloat16 half of ``test_torch_train_families.py`` (its docstring gives
the inputs and the bounds), a file of its own so that the two halves run on
two workers."""

import pytest

from test_torch_train_families import NAMES, check_gradients


@pytest.mark.parametrize("name", NAMES)
def test_bfloat16_gradients_match_the_reference(name):
    check_gradients(name, "bfloat16")
