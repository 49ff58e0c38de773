"""Carry configs and mixture states across packages as numpy.

A state travels as a mapping of ``FIGMNState`` field names to numpy arrays
(``{f: np.asarray(getattr(s, f))}`` of either package's state), so the
reference package and the port exchange states without importing each
other.  A config travels as a dict of ``FIGMNConfig`` fields with
``sigma_ini`` as a numpy array.  An LM's parameters travel as the
reference's nested dict of numpy arrays (``lm_params_from_numpy``), and
so does its gradient (``lm_params_to_numpy``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core.types import (FIGMNConfig, FIGMNState, map_tree,
                                    resolve_device)

STATE_FIELDS = tuple(f.name for f in dataclasses.fields(FIGMNState))
CONFIG_FIELDS = tuple(f.name for f in dataclasses.fields(FIGMNConfig))


def state_from_numpy(mapping: Mapping[str, Any], device=None) -> FIGMNState:
    """A ``FIGMNState`` on ``device`` from numpy arrays keyed by field name
    (CUDA unless the caller names another device)."""
    missing = set(STATE_FIELDS) - set(mapping)
    if missing:
        raise KeyError(f"state mapping lacks {sorted(missing)}")
    device = resolve_device(device)
    out = {}
    for name in STATE_FIELDS:
        a = np.asarray(mapping[name])
        if name == "active":
            a = a.astype(bool)
        elif name == "n_created":
            a = a.astype(np.int32)
        out[name] = torch.as_tensor(a.copy(), device=device)
    return FIGMNState(**out)


def state_to_numpy(state: FIGMNState) -> Dict[str, np.ndarray]:
    return {name: getattr(state, name).detach().cpu().numpy()
            for name in STATE_FIELDS}


def config_from_dict(d: Mapping[str, Any]) -> FIGMNConfig:
    """A ``FIGMNConfig`` from a dict of its fields (unknown keys raise)."""
    unknown = set(d) - set(CONFIG_FIELDS)
    if unknown:
        raise KeyError(f"not FIGMNConfig fields: {sorted(unknown)}")
    d = dict(d)
    if d.get("sigma_ini") is not None:
        d["sigma_ini"] = np.array(d["sigma_ini"], np.float32)   # a copy
    return FIGMNConfig(**d)


def config_to_dict(cfg: FIGMNConfig) -> Dict[str, Any]:
    d = {name: getattr(cfg, name) for name in CONFIG_FIELDS}
    s = d["sigma_ini"]
    if torch.is_tensor(s):
        s = s.detach().cpu().numpy()
    d["sigma_ini"] = None if s is None else np.asarray(s, np.float32)
    return d


def lm_params_from_numpy(tree: Mapping[str, Any], device=None,
                         dtype: torch.dtype = None) -> Dict[str, Any]:
    """An LM parameter dict on ``device`` (CUDA unless named) from the
    reference's nested dict of arrays (``embed``, ``final_norm``,
    ``lm_head``, ``blocks.{ln1, ln2, attn.{wq, wk, wv, wo},
    mlp.{w_gate, w_up, w_down}}``), same keys and shapes.  Each array goes
    through float32 (exact for bfloat16, which arrives as
    ``ml_dtypes.bfloat16``) and then to ``dtype`` (default: float32 for a
    float32 array, bfloat16 for a bfloat16 one)."""
    device = resolve_device(device)

    def one(a):
        a = np.asarray(a)
        want = dtype or (torch.bfloat16 if a.dtype.name == "bfloat16"
                         else torch.float32)
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=device, dtype=want)
    return map_tree(one, tree)


def lm_params_to_numpy(params: Mapping[str, Any]) -> Dict[str, Any]:
    """The parameter dict, or a gradient of the same tree, as float32
    numpy arrays (exact for bfloat16)."""
    return map_tree(lambda t: t.detach().float().cpu().numpy(), params)
