"""repro_torch.core — the paper's learner (precision form), eq. 27
inference and mixture merging."""
from repro_torch.core.types import (FIGMNConfig, FIGMNState, IGMNState,
                                    chi2_quantile)
from repro_torch.core import figmn, inference, merge

__all__ = ["FIGMNConfig", "FIGMNState", "IGMNState", "chi2_quantile",
           "figmn", "inference", "merge"]
