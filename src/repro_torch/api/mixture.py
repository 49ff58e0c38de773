"""``Mixture`` — the estimator handle over the stream runtime (counterpart of
``repro.api.mixture``).

    spec = MixtureSpec(model=FIGMNConfig(...), runtime=RuntimeConfig(...))
    mix = Mixture(spec)
    mix.partial_fit(stream)              # single-pass online learning
    mix.score_samples(xs)                # log p(x)
    mix.predict(xs, targets=[D - 1])     # eq. 27
    mix.predict_proba(xs, targets=...)   # label block

This slice serves the "runtime" tier (one in-process ``StreamRuntime``,
live-state reads).  The fleet tiers, ``sample``, ``save`` and ``load``
raise until their slices land.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.api.query import to_proba
from repro_torch.core.types import FIGMNConfig, FIGMNState
from repro_torch.stream.runtime import RuntimeConfig, StreamRuntime

TIERS = ("runtime", "fleet", "autoscaled")


@dataclasses.dataclass(frozen=True)
class MixtureSpec:
    """Declarative mixture session spec.

    model:   the FIGMN hyper-parameters.
    tier:    "runtime" (one in-process StreamRuntime); "fleet" and
             "autoscaled" are not ported yet and raise.
    runtime: per-runtime knobs (chunking, path, device).
    """
    model: FIGMNConfig
    tier: str = "runtime"
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)


class Mixture:
    """One mixture session: estimator + reads over a StreamRuntime."""

    def __init__(self, spec: MixtureSpec):
        if spec.tier not in TIERS:
            raise ValueError(f"unknown tier {spec.tier!r}; expected one of "
                             f"{TIERS}")
        if spec.tier != "runtime":
            raise NotImplementedError(
                f"tier {spec.tier!r} is not ported yet; use 'runtime'")
        self.spec = spec
        self.cfg = spec.model
        self.engine = StreamRuntime(spec.model, spec.runtime)

    def partial_fit(self, xs) -> "Mixture":
        """Single-pass online learning over an (N, D) stream segment;
        callable repeatedly.  Returns self."""
        self.engine.ingest(xs)
        return self

    def score_samples(self, xs) -> torch.Tensor:
        """(N,) mixture log-densities."""
        return self.engine.score(xs)

    def predict(self, xs, targets, return_var: bool = False):
        """(N, o) eq. 27 conditional means of ``targets`` given the rest
        (and the (N, o) conditional variance with return_var=True)."""
        return self.engine.predict(xs, targets, return_var=return_var)

    def predict_proba(self, xs, targets) -> torch.Tensor:
        """(N, o) label-block reconstruction renormalised to a
        distribution."""
        return to_proba(self.engine.predict(xs, targets))

    def sample(self, n: int, seed: int = 0):
        raise NotImplementedError("Mixture.sample is not ported yet")

    def save(self) -> None:
        raise NotImplementedError("Mixture.save is not ported yet")

    @classmethod
    def load(cls, spec: MixtureSpec) -> "Mixture":
        raise NotImplementedError("Mixture.load is not ported yet")

    @property
    def state(self) -> FIGMNState:
        """The live mixture state.  The next ``partial_fit`` may update its
        Λ (and, on the shortlist path, its logdet) in place: clone it to
        keep it."""
        return self.engine.state

    @property
    def read_shortlist_c(self) -> int:
        """The read path's resolved shortlist width (0 = dense): what the
        engine actually serves with."""
        return self.cfg.shortlist_c if self.engine.path == "sparse" else 0

    @property
    def n_active(self) -> int:
        return int(self.state.n_active)

    def summary(self) -> Dict[str, object]:
        return self.engine.telemetry.summary()

    def __repr__(self) -> str:
        return (f"Mixture(tier={self.spec.tier!r}, dim={self.cfg.dim}, "
                f"kmax={self.cfg.kmax}, path={self.engine.path!r}, "
                f"shortlist_c={self.cfg.shortlist_c})")
