"""Deprecated alias for :mod:`repro_torch.models.lm_serving`.

The LM serving loop lives next to the model code it drives; this package
name is kept only so that imports of the old path keep working, as the JAX
package keeps its own.  It is unrelated to :mod:`repro_torch.service`, the
guarded-aggregate query serving tier.
"""

import warnings

from repro_torch.models.lm_serving import ServeEngine, greedy_generate

warnings.warn(
    "repro_torch.serving is deprecated; import from "
    "repro_torch.models.lm_serving instead (repro_torch.service is the "
    "query serving tier)",
    DeprecationWarning, stacklevel=2)

__all__ = ["ServeEngine", "greedy_generate"]
