"""The LM's loss gradient — the port of ``repro.train.trainer``'s
``_grads`` (``jax.value_and_grad(loss_fn)``) and ``_accumulated_grads``.

Parameters travel as the reference's nested dict of tensors; the
gradient comes back as a dict of the same tree.  With
``layers.ATTN_IMPL = "flash"`` on CUDA tensors the attention's gradient
runs the CUDA backward kernels (``kernels.flash_attention``), and every
layer is recomputed in the backward (``transformer._scan_blocks``).
``TrainConfig``, ``make_train_step`` and the optimizer come with the next
slice of the port.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core.types import map_tree
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _grads(cfg: ModelConfig, params: Dict[str, Any],
           batch: Dict[str, Tensor]) -> Tuple[Tensor, Dict[str, Any]]:
    """(loss, grads) of ``transformer.loss_fn`` at ``params``: the loss a
    float32 scalar tensor, the grads a dict of ``params``' tree in each
    leaf's dtype.  Gradients are taken on detached copies of the leaves
    (``params`` are not touched and need not require grad), with autograd
    on whatever the caller's grad mode."""
    leaves = map_tree(lambda t: t.detach().requires_grad_(True), params)
    flat = _leaves(leaves)
    with torch.enable_grad():
        loss = transformer.loss_fn(leaves, cfg, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(flat, grads))
    return loss.detach(), map_tree(lambda _: next(it), params)


def _accumulated_grads(cfg: ModelConfig, params: Dict[str, Any],
                       batch: Dict[str, Tensor], n_micro: int
                       ) -> Tuple[Tensor, Dict[str, Any]]:
    """The batch split into ``n_micro`` slices along its batch axis; the
    losses and grads summed over them in float32 in order, then scaled by
    1/n_micro (float32 grads, as the reference's scan carry).  n_micro ≤ 1
    is ``_grads``.  Only one microbatch's activations live at a time."""
    if n_micro <= 1:
        return _grads(cfg, params, batch)
    b = next(iter(batch.values())).shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         "microbatches")
    m = b // n_micro
    acc_loss = acc_g = None
    for i in range(n_micro):
        mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
        loss, g = _grads(cfg, params, mb)
        if acc_g is None:              # 0 + x = x: the sum from zeros
            acc_loss, acc_g = loss, map_tree(lambda x: x.float(), g)
        else:
            acc_loss = acc_loss + loss
            acc_g = map_tree(lambda a, x: a + x.float(), acc_g, g)
    inv = 1.0 / n_micro
    return acc_loss * inv, map_tree(lambda x: x * inv, acc_g)
