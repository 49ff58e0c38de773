import os
import sys

# Tests must see exactly ONE device (the dry-run is the only 512-device
# context, and it configures XLA_FLAGS itself in a separate process).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)


import gc

import jax
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running sweeps (excluded from CI via -m 'not slow')")
    config.addinivalue_line(
        "markers",
        "fleet: multi-replica fleet/autoscale suite (CI job `fleet`)")
    config.addinivalue_line(
        "markers",
        "property: property-based hypothesis suite (CI job `property`; "
        "skipped where hypothesis is not installed)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the port's kernels); skipped without one")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Hundreds of distinct jit programs accumulate across this suite (10
    architectures × step kinds × hypothesis-generated shapes); on a small
    host the native buffers/callback registries eventually abort the
    process.  Dropping the compilation cache between modules keeps the
    process healthy without affecting any test's semantics."""
    yield
    jax.clear_caches()
    gc.collect()


# ---------------------------------------------------------------------------
# Shared hypothesis strategies (fleet conformance suite)
#
# Guarded: this container may lack hypothesis (requirements-dev.txt installs
# it in CI).  Tests that use these must importorskip("hypothesis") first —
# the strategies below only exist when the import succeeded.
# ---------------------------------------------------------------------------

try:
    import hypothesis.strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:

    @st.composite
    def fleet_streams(draw, min_points=120, max_points=320, min_dim=2,
                      max_dim=4, max_modes=4):
        """A seeded clustered stream: hypothesis draws only INTEGERS (seed,
        dim, modes, n); the float data comes from a deterministic
        numpy Generator — so shrinking stays meaningful and every failure
        reproduces from the drawn tuple alone."""
        seed = draw(st.integers(0, 2 ** 16 - 1))
        d = draw(st.integers(min_dim, max_dim))
        modes = draw(st.integers(1, max_modes))
        n = draw(st.integers(min_points, max_points))
        rng = np.random.default_rng(seed)
        centers = rng.normal(0.0, 6.0, (modes, d))
        x = centers[rng.integers(0, modes, n)] + rng.normal(0, 1.0, (n, d))
        return x.astype(np.float32), seed

    @st.composite
    def scale_schedules(draw, max_events=4):
        """A scale-event schedule: each entry is (action, selector); the
        selector picks the target replica modulo the live membership at
        execution time, so any schedule is valid against any fleet."""
        return draw(st.lists(
            st.tuples(st.sampled_from(["up", "down"]),
                      st.integers(0, 7)),
            min_size=1, max_size=max_events))
