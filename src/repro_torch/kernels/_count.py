"""Launch counts: each wrapper's calls, and on the device what ran.

Every wrapper calls :func:`launched` where it launches its kernel. That adds
one to the wrapper's ``launches`` (and ``route_launches[route]``), a count
of calls: a call made while a CUDA graph is being captured counts once,
when captured, and the graph's replays add nothing. While a
``kernels.Executed`` block is open it also adds one to a counter on the
device, on the launch's stream right after the kernel: inside a graph that
add is a node beside the kernel's, so it runs each time the kernel runs,
and not when an IF node skips its body.
"""
from __future__ import annotations

from typing import Optional

import torch

#: The open counting block: (device, counts, slot by (id(wrapper), route
#: or None)), or None.
ACTIVE: Optional[tuple] = None


def launched(fn, like: torch.Tensor, route: Optional[str] = None) -> None:
    """Count one launch of ``fn``'s kernel on ``like``'s device."""
    fn.launches += 1
    if route is not None:
        fn.route_launches[route] += 1
    if ACTIVE is not None and like.device == ACTIVE[0]:
        _, counts, slots = ACTIVE
        counts[slots[id(fn), None]].add_(1)
        if route is not None:
            counts[slots[id(fn), route]].add_(1)
