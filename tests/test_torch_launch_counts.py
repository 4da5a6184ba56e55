"""Launch counts of the port's kernel wrappers (``repro_torch.kernels``).

A wrapper's ``launches`` counts its calls; inside ``kernels.Executed`` each
launch also adds one to a counter on the launch's device, in stream order
beside its kernel, which is how a captured CUDA graph's replays are
counted where they run (the ``captured`` tests of
tests/test_torch_kernels_gpu.py hold that on the card). Here, on CPU
tensors, the bookkeeping: every wrapper and route has its own counter, a
launch on another device counts no device launch, and one block is open
at a time.
"""
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import _count

ROUTED = [(name, route) for name, fn in kernels.WRAPPERS.items()
          for route in getattr(fn, "route_launches", {})]


@pytest.mark.parametrize("name", list(kernels.WRAPPERS))
def test_a_launch_counts_its_wrapper_alone(name):
    fn = kernels.WRAPPERS[name]
    calls = fn.launches
    with kernels.Executed("cpu") as ex:
        _count.launched(fn, torch.zeros(2))
        _count.launched(fn, torch.zeros(2))
    assert {k: v for k, v in ex.launches.items() if v} == {name: 2}
    assert fn.launches == calls + 2
    assert all(not any(r.values()) for r in ex.routes.values())


@pytest.mark.parametrize("name,route", ROUTED)
def test_a_routed_launch_counts_its_route(name, route):
    fn = kernels.WRAPPERS[name]
    before = dict(fn.route_launches)
    with kernels.Executed("cpu") as ex:
        _count.launched(fn, torch.zeros(1), route)
    assert ex.launches[name] == 1
    assert ex.routes[name] == {r: int(r == route) for r in fn.route_launches}
    assert fn.route_launches[route] == before[route] + 1


def test_another_device_and_outside_count_calls_only():
    fn = kernels.WRAPPERS["matvec"]
    calls = fn.launches
    _count.launched(fn, torch.zeros(1))  # no block open
    with kernels.Executed("cpu") as ex:
        _count.launched(fn, torch.zeros(1, device="meta"))
    assert ex.launches["matvec"] == 0 and fn.launches == calls + 2
    assert _count.ACTIVE is None


def test_one_block_at_a_time_and_closed_on_error():
    fn = kernels.WRAPPERS["quantize"]
    with kernels.Executed("cpu") as ex:
        _count.launched(fn, torch.zeros(1))
        with pytest.raises(RuntimeError, match="open already"):
            with kernels.Executed("cpu"):
                pass
        _count.launched(fn, torch.zeros(1))
    assert ex.launches["quantize"] == 2
    with pytest.raises(ValueError):
        with kernels.Executed("cpu"):
            raise ValueError("inside")
    assert _count.ACTIVE is None


@pytest.mark.parametrize("module", ["factor_matvec", "flash_attention", "mc_matvec",
                                    "power_matvec", "quantize", "rank1_update", "wkv6_chunk"])
def test_every_wrapper_counts_through_launched(module):
    """No wrapper bumps its counter by hand: each calls _count.launched,
    so that no launch escapes the device count."""
    import inspect

    src = inspect.getsource(getattr(kernels, module).ops)
    assert "launched(" in src
    assert ".launches +=" not in src and "] += 1" not in src
