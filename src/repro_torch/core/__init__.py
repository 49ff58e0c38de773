"""repro_torch.core — the paper's learner (precision form) and eq. 27
inference."""
from repro_torch.core.types import (FIGMNConfig, FIGMNState, IGMNState,
                                    chi2_quantile)
from repro_torch.core import figmn, inference

__all__ = ["FIGMNConfig", "FIGMNState", "IGMNState", "chi2_quantile",
           "figmn", "inference"]
