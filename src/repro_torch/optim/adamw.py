"""AdamW, the port's counterpart of ``repro.optim.adamw``, written from the
reference's formula (not ``torch.optim.AdamW``, whose arithmetic is
arranged differently):

    m <- b1 m + (1 - b1) g,   v <- b2 v + (1 - b2) g^2      (f32)
    p <- (p32 - lr (m / c1 / (sqrt(v / c2) + eps) + wd p32)).to(p.dtype)

with c1 = 1 - b1^step and c2 = 1 - b2^step (step counted from 1). The
state's m and v mirror the parameter tree in f32; ``step`` is a 0-d int32
tensor on the parameters' device, so the schedule and the bias corrections
never read the device from the host.

``update`` works IN PLACE, leaf by leaf, in slices of at most
``SLICE`` elements: each slice takes the reference's operations in the
reference's order, so the bits do not depend on the slicing, and the f32
temporaries of a 378 M-element embedding stay a few hundred MB instead of
several GB. A None gradient leaves its parameter, m and v as they are.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple, Union

import torch

from .compression import tree_leaves, tree_map

PyTree = Any

SLICE = 1 << 24  # elements of a leaf updated at once


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    m: PyTree  # f32, like params
    v: PyTree  # f32, like params


def init(params: PyTree) -> AdamWState:
    leaves = [p for p in tree_leaves(params) if p is not None]
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
                      m=zeros, v=tree_map(torch.clone, zeros))


def _update_leaf(p, g, m, v, *, lr, c1, c2, b1, b2, eps, weight_decay) -> None:
    pf, gf, mf, vf = (t.view(-1) for t in (p, g, m, v))
    for lo in range(0, pf.numel(), SLICE):
        sl = slice(lo, lo + SLICE)
        g32 = gf[sl].float()
        mm = mf[sl].mul_(b1).add_((1.0 - b1) * g32)
        vv = vf[sl].mul_(b2).add_((1.0 - b2) * (g32 * g32))
        p32 = pf[sl].float()
        delta = (mm / c1) / (torch.sqrt(vv / c2) + eps) + weight_decay * p32
        pf[sl].copy_(p32 - lr * delta)


def update(grads: PyTree, state: AdamWState, params: PyTree, *,
           lr: Union[torch.Tensor, float], b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
           weight_decay: float = 0.1) -> Tuple[PyTree, AdamWState]:
    """One step: updates ``params`` and the state's m and v in place and
    returns (params, the state with the next step). ``grads`` mirrors
    ``params``; its leaves may be of the parameters' dtype or f32."""
    step = state.step + 1
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, stepf)
    c2 = 1.0 - torch.pow(b2, stepf)
    if not isinstance(lr, torch.Tensor):
        lr = torch.full((), lr, dtype=torch.float32, device=step.device)
    kw = dict(lr=lr, c1=c1, c2=c2, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)

    def leaf(g: Optional[torch.Tensor], m, v, p):
        if g is None:
            return
        if g.shape != p.shape or not (p.is_contiguous() and g.is_contiguous()):
            raise ValueError(f"gradient {tuple(g.shape)} against parameter {tuple(p.shape)}: "
                             "one shape, contiguous")
        _update_leaf(p, g, m, v, **kw)

    with torch.no_grad():
        tree_map(leaf, grads, state.m, state.v, params)
    return params, AdamWState(step=step, m=state.m, v=state.v)
