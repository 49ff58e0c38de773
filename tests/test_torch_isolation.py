"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the reference package ``repro`` (only the
parity tests import both)."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s))", re.MULTILINE)


def test_import_pulls_in_no_jax():
    code = ("import sys; import repro_torch, repro_torch.api, "
            "repro_torch.stream, repro_torch.interop, repro_torch.kernels.ops, "
            "repro_torch.kernels.figmn_stream, repro_torch.data.gmm_streams, "
            "repro_torch.core.shortlist, repro_torch.kernels.figmn_sparse, "
            "repro_torch.kernels.mahalanobis, "
            "repro_torch.kernels.flash_attention, repro_torch.configs, "
            "repro_torch.models.transformer, repro_torch.serve.engine, "
            "repro_torch.data.tokens, repro_torch.core.merge, "
            "repro_torch.stream.lifecycle, repro_torch.train.trainer; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')); "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_imports_neither_jax_nor_repro(path):
    text = (ROOT / path).read_text()
    assert not FORBIDDEN.search(text), FORBIDDEN.search(text).group(0)


def test_scan_catches_forbidden_imports():
    for line in ("import jax", "from jax import numpy", "import repro.core",
                 "from repro.core import figmn", "from repro import api",
                 "    import jax.numpy as jnp"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import figmn",
                 "import jaxlib_free_thing_not"):
        assert not FORBIDDEN.search(line), line
