"""The query layer's label post-processing (counterpart of
``repro.api.query``).  ``Query``/``execute``/``sample`` wait for a later
slice."""
from __future__ import annotations

import torch


def to_proba(rec: torch.Tensor) -> torch.Tensor:
    """Clip + renormalise a reconstructed one-hot block to a distribution —
    the ONE definition of the label-query post-processing."""
    rec = torch.clamp_min(rec, 1e-6)
    return rec / torch.sum(rec, dim=-1, keepdim=True)
