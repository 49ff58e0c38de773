"""Synthetic datasets of the paper's Table 1 shapes (counterpart of
``repro.data.gmm_streams``; numpy only, deterministic in the seed)."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def gaussian_classes(n: int, d: int, k: int, seed: int = 0,
                     sep: float = 3.0) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional Gaussians with random means and scales."""
    rng = np.random.default_rng(seed)
    means = rng.normal(0, sep, (k, d))
    scales = rng.uniform(0.5, 1.5, (k, d))
    y = rng.integers(0, k, n)
    x = means[y] + rng.normal(0, 1, (n, d)) * scales[y]
    return x.astype(np.float32), y.astype(np.int32)
