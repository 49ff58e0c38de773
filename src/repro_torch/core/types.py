"""Core datatypes for the (Fast) Incremental Gaussian Mixture Network.

PyTorch counterpart of ``repro.core.types``: the same fixed-capacity pool of
``kmax`` component slots plus an ``active`` mask, held as a dataclass of
tensors on an explicit device.  Creating a component activates the first
free slot; pruning deactivates a slot; a full pool recycles the weakest
(lowest ``sp``) component.
"""
from __future__ import annotations

import dataclasses
import functools
from fractions import Fraction
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

Tensor = torch.Tensor


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  With no device given and no CUDA card present this raises —
    the port never carries on silently on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run on the CPU")
    return torch.device("cuda")


def map_tree(fn: Callable, *trees, is_leaf: Optional[Callable] = None):
    """``fn`` over the leaves of nested dicts that share one structure (the
    first tree's); a leaf is what is not a Mapping, or what ``is_leaf``
    says is one."""
    t = trees[0]
    if not isinstance(t, Mapping) or (is_leaf is not None and is_leaf(t)):
        return fn(*trees)
    return {k: map_tree(fn, *(s[k] for s in trees), is_leaf=is_leaf)
            for k in t}


@dataclasses.dataclass(frozen=True)
class FIGMNConfig:
    """Static configuration (hyper-parameters from §2 of the paper).

    Same fields and defaults as ``repro.core.types.FIGMNConfig``, so one
    config dict drives both packages.

    beta:  novelty meta-parameter; update iff some component has squared
           Mahalanobis distance below the chi²_{D,1-beta} percentile.
    delta: scaling factor for the initial standard deviation (eq. 13).
    vmin/spmin: pruning thresholds (§2.3).
    update_mode: "paper" (eq. 11 verbatim, two rank-one updates) or
           "exact" (the PSD-preserving single rank-one recursion).
    backend: "pallas" selects the hand-written CUDA kernels
           (``kernels.ops``) for the learning step; "jnp" selects plain
           torch ops there.  The names are the reference's, kept so one
           config dict drives both packages.  The shortlisted reads take
           the ``gathered_matvec`` kernel on the card whatever the backend
           (``shortlist.gathered_products``).
    fused: share the distance-pass matvec with the update (2 passes over Λ
           per point instead of 4; see ``figmn.fused_step_coeffs``).
    shortlist_c / shortlist_mode: the top-C shortlist (``core.shortlist``):
           C > 0 sends ingest and reads down the shortlisted path, ranking
           slots by the "diag" (or "euclid") proxy.
    sigma_ini: per-dimension initial std (eq. 13): a float, a numpy array
           or a tensor.
    """
    kmax: int = 32
    dim: int = 2
    beta: float = 0.1
    delta: float = 0.01
    vmin: float = 5.0
    spmin: float = 3.0
    dtype_str: str = "float32"
    update_mode: str = "paper"
    backend: str = "jnp"
    fused: bool = True
    shortlist_c: int = 0
    shortlist_mode: str = "diag"
    sigma_ini: Any = None

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype_str)


@dataclasses.dataclass
class FIGMNState:
    """Mixture state (precision form), every field on one device.

    mu:      (K, D)    component means
    lam:     (K, D, D) precision matrices  Λ = C⁻¹
    logdet:  (K,)      log |C| (the canonical determinant track)
    sp:      (K,)      posterior-probability accumulators
    v:       (K,)      component ages
    active:  (K,)      slot occupancy mask (bool)
    n_created: ()      total components ever created (int32)
    """
    mu: Tensor
    lam: Tensor
    logdet: Tensor
    sp: Tensor
    v: Tensor
    active: Tensor
    n_created: Tensor

    @property
    def det(self) -> Tensor:
        """|C| derived from the canonical log|C| track."""
        return torch.exp(self.logdet)

    @property
    def n_active(self) -> Tensor:
        return self.active.sum(dtype=torch.int32)

    @property
    def device(self) -> torch.device:
        return self.mu.device

    def clone(self) -> "FIGMNState":
        """A deep copy.  The learning steps may write Λ in place (the
        reference donates the buffer instead), so a caller that needs the
        input state afterwards passes a clone."""
        return FIGMNState(**{f.name: getattr(self, f.name).clone()
                             for f in dataclasses.fields(self)})


@dataclasses.dataclass
class IGMNState:
    """Mixture state for the covariance-form baseline (original IGMN)."""
    mu: Tensor
    cov: Tensor
    sp: Tensor
    v: Tensor
    active: Tensor
    n_created: Tensor

    @property
    def n_active(self) -> Tensor:
        return self.active.sum(dtype=torch.int32)


# The Cephes rational forms of the reference's ``ndtri`` (jax 0.9.0,
# ``jax._src.scipy.special._ndtri``), copied coefficient for coefficient
# and evaluated in float32 below.
_NDTRI_P0 = (-5.99633501014107895267E1, 9.80010754185999661536E1,
             -5.66762857469070293439E1, 1.39312609387279679503E1,
             -1.23916583867381258016E0)
_NDTRI_Q0 = (1.0, 1.95448858338141759834E0, 4.67627912898881538453E0,
             8.63602421390890590575E1, -2.25462687854119370527E2,
             2.00260212380060660359E2, -8.20372256168333339912E1,
             1.59056225126211695515E1, -1.18331621121330003142E0)
_NDTRI_P1 = (4.05544892305962419923E0, 3.15251094599893866154E1,
             5.71628192246421288162E1, 4.40805073893200834700E1,
             1.46849561928858024014E1, 2.18663306850790267539E0,
             -1.40256079171354495875E-1, -3.50424626827848203418E-2,
             -8.57456785154685413611E-4)
_NDTRI_Q1 = (1.0, 1.57799883256466749731E1, 4.53907635128879210584E1,
             4.13172038254672030440E1, 1.50425385692907503408E1,
             2.50464946208309415979E0, -1.42182922854787788574E-1,
             -3.80806407691578277194E-2, -9.33259480895457427372E-4)
_NDTRI_P2 = (3.23774891776946035970E0, 6.91522889068984211695E0,
             3.93881025292474443415E0, 1.33303460815807542389E0,
             2.01485389549179081538E-1, 1.23716634817820021358E-2,
             3.01581553508235416007E-4, 2.65806974686737550832E-6,
             6.23974539184983293730E-9)
_NDTRI_Q2 = (1.0, 6.02427039364742014255E0, 3.67983563856160859403E0,
             1.37702099489081330271E0, 2.16236993594496635890E-1,
             1.34204006088543189037E-2, 3.28014464682127739104E-4,
             2.89247864745380683936E-6, 6.79019408009981274425E-9)

_f32 = np.float32


def _round32(q: Fraction) -> np.float32:
    """The float32 nearest to the exact rational ``q`` (ties to even)."""
    r = _f32(float(q))
    best = None
    for c in (np.nextafter(r, _f32(-np.inf)), r, np.nextafter(r, _f32(np.inf))):
        if not np.isfinite(c):
            continue
        key = (abs(Fraction(float(c)) - q), int(c.view(np.int32)) & 1)
        if best is None or key < best[0]:
            best = (key, c)
    return best[1] if best is not None else r


def _fma32(a, b, c) -> np.float32:
    """a·b + c with one rounding to float32 (the fused multiply-add XLA's
    CPU code generator emits for these forms)."""
    return _round32(Fraction(float(a)) * Fraction(float(b))
                    + Fraction(float(c)))


def _hex32(bits: int) -> np.float32:
    return np.array([bits], np.uint32).view(np.float32)[0]


def _log32(x: np.float32) -> np.float32:
    """The reference's float32 ``log`` on the CPU, operation by operation:
    XLA lowers it to Eigen's ``plog_float`` (Cephes' polynomial, evaluated
    in three interleaved Horner chains) and contracts its multiply-adds
    into fused ones.  Positive normal inputs only (all ``ndtri32`` needs)."""
    x = max(_f32(x), _hex32(0x00800000))     # XLA's clamp to the least normal
    bits = int(x.view(np.int32))
    e = _f32((bits >> 23) - 127)
    m = np.array([(bits & 0x807FFFFF) | 0x3F000000],
                 np.int32).view(np.float32)[0]          # mantissa in [½, 1)
    small = m < _hex32(0x3F3504F3)                      # √½ in float32
    e = _f32(_f32(_f32(1.0) + e) - (_f32(1.0) if small else _f32(0.0)))
    x = _f32(_f32(m - _f32(1.0)) + (m if small else _f32(0.0)))
    x2 = _f32(x * x)
    x3 = _f32(x2 * x)
    y = _fma32(x, _hex32(0x3D9021BB), _hex32(0xBDEBD1B8))
    y1 = _fma32(x, _hex32(0xBDFE5D4F), _hex32(0x3E11E9BF))
    y2 = _fma32(x, _hex32(0x3E4CCEAC), _hex32(0xBE7FFFFC))
    y = _fma32(y, x, _hex32(0x3DEF251A))
    y1 = _fma32(y1, x, _hex32(0xBE2AAE50))
    y2 = _fma32(y2, x, _hex32(0x3EAAAAAA))
    y = _fma32(y, x3, y1)
    y = _fma32(y, x3, y2)
    y = _fma32(y, x3, _f32(_hex32(0xB95E8083) * e))
    x = _fma32(_f32(-0.5), x2, x)
    x = _f32(x + y)
    return _fma32(_hex32(0x3F318000), e, x)             # + e·ln 2 (hi part)


def _sqrt32(x: np.float32) -> np.float32:
    return _f32(np.sqrt(np.float64(x)))                 # correctly rounded


def _polyval32(coeffs, x: np.float32) -> np.float32:
    """``jnp.polyval`` in float32: Horner, y = y·x + c, each step one fused
    multiply-add (as XLA compiles the jitted loop on the CPU)."""
    y = _f32(0.0)
    for c in coeffs:
        y = _fma32(y, x, _f32(c))
    return y


def ndtri32(p: float) -> np.float32:
    """Φ⁻¹(p) in float32, the reference's ``_ndtri`` operation by operation:
    the same branches (the complement above 1 − e⁻², the z ≥ 8 tail,
    p ∈ {0, 1}), float32 after every operation, its ``log`` and its fused
    ``polyval`` as XLA computes them on the CPU, sqrt correctly rounded."""
    p = _f32(p)
    if p == _f32(0.0):
        return _f32(-np.inf)
    if p == _f32(1.0):
        return _f32(np.inf)
    mcp = _f32(_f32(1.0) - p) if p > _f32(-np.expm1(-2.0)) else p
    if mcp == _f32(0.0):
        mcp = _f32(0.5)
    if mcp > _f32(np.exp(-2.0)):
        w = _f32(mcp - _f32(0.5))
        ww = _f32(w * w)
        ratio = _f32(_polyval32(_NDTRI_P0, ww) / _polyval32(_NDTRI_Q0, ww))
        x = _f32(w + _f32(_f32(w * ww) * ratio))
        x = _f32(x * -_f32(np.sqrt(2.0 * np.pi)))
    else:
        z = _sqrt32(_f32(_f32(-2.0) * _log32(mcp)))
        first = _f32(z - _f32(_log32(z) / z))
        inv_z = _f32(_f32(1.0) / z)
        pc, qc = (_NDTRI_P2, _NDTRI_Q2) if z >= _f32(8.0) \
            else (_NDTRI_P1, _NDTRI_Q1)
        second = _f32(_f32(_polyval32(pc, inv_z) / _polyval32(qc, inv_z))
                      / z)
        x = _f32(first - second)
    return x if p > _f32(1.0 - np.exp(-2.0)) else _f32(-x)


@functools.lru_cache(maxsize=256)
def _chi2_f32(dof: int, p: float) -> np.float32:
    z = ndtri32(p)
    k = _f32(dof)
    ninek = _f32(_f32(9.0) * k)
    b = _f32(_f32(_f32(1.0) - _f32(_f32(2.0) / ninek))
             + _f32(z * _sqrt32(_f32(_f32(2.0) / ninek))))
    return _f32(k * _f32(b * _f32(b * b)))   # jnp's integer power: b·(b·b)


def chi2_quantile(dof: int, p, device: Optional[torch.device] = None
                  ) -> Tensor:
    """chi²_{dof, p} via the Wilson–Hilferty approximation, in float32.

    The novelty gate ``d² < thresh`` flips on one last bit, so this is the
    reference's float32 value reproduced on the host, once per (dof, p):
    its ``ndtri`` (``ndtri32``) and then ``k·(1 − 2/(9k) + z·sqrt(2/(9k)))³``
    in its order, every step rounded to float32.  It equals the JAX
    package's value on the CPU (jax 0.9.0) bit for bit on the
    dof ∈ {1, 2, 3, 5, 8, 16, 32, 64, 100, 256, 794, 1000} ×
    β ∈ {0.3 … 1e-4} grid of ``tests/test_torch_figmn.py`` and on seeded
    random (dof, β) pairs.  Where it can still differ: against a reference
    run on another backend or XLA version whose float32 ``log`` or
    ``polyval`` rounds otherwise (the TPU's, say), by a few ulps.
    p → 1 gives +inf (the paper's beta = 0 single-component experiments).
    """
    value = _chi2_f32(int(dof), float(np.float32(float(p))))
    return torch.tensor(value, dtype=torch.float32, device=device)


def gate_threshold(cfg: FIGMNConfig) -> float:
    """The chi² gate as a Python float holding the float32 value exactly,
    so comparing a float32 tensor against it compares in float32."""
    return float(chi2_quantile(cfg.dim, 1.0 - cfg.beta).to(cfg.dtype))
