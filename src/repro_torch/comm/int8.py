"""int8 stochastic-rounding reducer: quantize -> int8 sum -> dequantize.

Per ``exchange`` of a (dim,) f32 vector, as in the JAX package's
``comm/int8.py``:

1. the shared per-vector scale is ``pmax(max |x|)`` over the workers (one
   all-reduce MAX of a 0-d device tensor the host never reads);
2. ``x`` is stochastically rounded onto the integer grid [-b, b],
   ``b = 127 // N`` for N workers, by the ``quantize`` kernel, with the
   exchange's uniform [0, 1) noise;
3. the integers are summed over the workers (one int8 all-reduce SUM; the
   identity in one process) and stay int8: every worker's integers lie in
   [-b, b] because |x| <= s, so every partial sum is bounded by
   N * b <= 127 and the int8 wire type cannot wrap;
4. ``dequantize`` maps the sum back to f32 (* s / b).

Stochastic rounding is unbiased (``E[q] = x * b / s``), so the power
method's direction is noisier but not biased. The reducer is stateless.
On a ``hier:g`` graph it runs over the cross-group subgroup with the
budget of g workers, 127 // g (``comm.topology``).
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import resolve_device
from ..kernels.quantize import ops as qops
from ..kernels.quantize import ref as qref
from .base import Noise, WorkerGroup, pmax, psum


class Int8Reducer:
    """Stateless int8 encoding of the power method's vector exchanges,
    summed over ``group`` (None: one process)."""

    spec = "int8"
    stochastic = True  # each worker rounds with its own draws

    def __init__(self, num_workers: int = 1, group: Optional[WorkerGroup] = None):
        if not 1 <= num_workers <= 127:
            raise ValueError(
                f"int8 reducer supports 1..127 workers (got {num_workers}): "
                "the per-worker budget 127 // N must stay >= 1"
            )
        self.num_workers = int(num_workers)
        self.group = group
        self.exchanges = 0

    @property
    def budget(self) -> int:
        return max(1, 127 // self.num_workers)

    def init_state(self, d: int, m: int, device=None):
        return ()

    def exchange(self, x: torch.Tensor, state, *, slot: str, noise: Noise = None, weight=None):
        """(dequantized int8 sum over workers of ``x``, state). ``noise``
        gives this worker's draws; a worker the straggler mask leaves out
        has ``x`` = 0, which quantizes to 0, so no weight is needed here."""
        if noise is None:
            raise ValueError("the int8 reducer needs the exchange's noise (noise=...)")
        self.exchanges += 1
        # max |x| in one reduction (exact in any order, so the bits of
        # max(abs(x)) without its |x| temporary)
        scale = pmax(torch.linalg.vector_norm(x, float("inf")), self.group)
        q = qops.quantize(x, noise(x.shape[0], x.device), scale, budget=self.budget)
        total = psum(q, self.group)  # int8 on the wire
        return qops.dequantize(total, scale, budget=self.budget), state

    def wire_bytes(self, dim: int, num_workers: int) -> int:
        # int8 ring all-reduce (2x) + the f32 scalar scale pmax (2x * 4 B)
        return 2 * 1 * dim + 2 * 4


def verify_quantize_kernels(
    seed: int = 0x17F8, *, num_workers: int = 1, dim: int = 384, tol: float = 1e-6,
    device=None,
) -> float:
    """Start-up check, the counterpart of the JAX package's
    ``verify_quantize_kernels``: the dispatched quantize/dequantize pair must
    match the plain versions on a random probe (both consume the same noise,
    so they agree exactly) on ``device`` (CUDA unless "cpu" is given).
    Raises ``AssertionError`` otherwise; returns the largest absolute error
    (one host read)."""
    device = resolve_device(device)
    b = max(1, 127 // num_workers)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn(dim, generator=gen, device=device)
    noise = torch.rand(dim, generator=gen, device=device)
    scale = torch.max(torch.abs(x))
    q_got = qops.quantize(x, noise, scale, budget=b)
    q_want = qref.quantize(x, noise, scale, b)
    d_got = qops.dequantize(q_got, scale, budget=b)
    err_q, err_d = torch.stack([
        torch.max(torch.abs(q_got.int() - q_want.int())).float(),
        torch.max(torch.abs(d_got - qref.dequantize(q_want, scale, b))),
    ]).tolist()
    err = max(err_q, err_d)
    if not err <= tol:
        raise AssertionError(
            f"quantize kernel diverges from the plain version: max abs err {err:.3e} "
            f"> tol {tol:.1e} (budget={b})"
        )
    return err
