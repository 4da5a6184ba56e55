"""Every ``__global__`` kernel of the port's CUDA sources is named in
``chip_smoke.py``'s profile grouping: ``PORT_KERNELS`` (the fits' device
time by port kernel), ``FLASH_KERNELS`` (the prefill's attention) or
``WKV6_KERNEL`` (the ssm prefill's chunk kernel). A kernel renamed or added
without its name there would fall into the profiles' "other" time."""
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "csrc"
GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")


def _kernels():
    return sorted((name, path.name) for path in sorted(CSRC.glob("*.cu"))
                  for name in GLOBAL.findall(path.read_text()))


def _grouped():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return set(chip_smoke.PORT_KERNELS) | set(chip_smoke.FLASH_KERNELS) | {
        chip_smoke.WKV6_KERNEL}


@pytest.mark.parametrize("name,source", _kernels(), ids=lambda v: v)
def test_kernel_is_in_the_profile_grouping(name, source):
    assert name in _grouped(), f"{source}: {name} is in no profile group of chip_smoke.py"


def test_scan_finds_every_source_and_the_known_kernels():
    names = {name for name, _ in _kernels()}
    assert {path.name for path in CSRC.glob("*.cu")} == {src for _, src in _kernels()}
    assert {"rank1_kernel", "rankk_kernel", "ring_matmat_kernel", "flash_fwd_wgmma_kernel",
            "wkv6_chunk_kernel", "update_resid_block_kernel"} <= names
    assert len(names) >= 22


@pytest.mark.parametrize("text,found", [
    ("__global__ void __launch_bounds__(kThreads, 2)\nfoo_kernel(float* x) {}", ["foo_kernel"]),
    ("template <int V>\n__global__ void bar_kernel(int n) {}", ["bar_kernel"]),
    ("__device__ void helper(float* x) {}", []),
])
def test_scan_reads_declarations(text, found):
    assert GLOBAL.findall(text) == found
