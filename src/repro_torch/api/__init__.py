"""repro_torch.api — the estimator surface: Mixture / MixtureSpec."""
from repro_torch.api.mixture import Mixture, MixtureSpec
from repro_torch.api.query import to_proba

__all__ = ["Mixture", "MixtureSpec", "to_proba"]
