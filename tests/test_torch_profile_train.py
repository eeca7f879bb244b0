"""``profile_train.GROUPS`` against the CUDA sources (statecatcher_tpu_torch/
ops/csrc): every fragment names a kernel or a policy type there, every
``__global__`` kernel falls in a group that names it, and each policy of a
shared template (lucy_tile.cuh's ``cell_fwd_kernel`` and
``ring_scan_kernel``) in a group of its own.  Kernel names are built as
torch's profiler reports them, demangled."""

import re
from pathlib import Path

import pytest

from statecatcher_tpu_torch.profile_train import GROUPS, group_of

CSRC = Path(__file__).resolve().parents[1] / "statecatcher_tpu_torch" / "ops" / "csrc"
SOURCES = {p.name: p.read_text() for p in sorted(CSRC.glob("*.cu*"))}
_LAUNCH_BOUNDS = r"(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?"
KERNELS = sorted({k for src in SOURCES.values()
                  for k in re.findall(r"__global__\s+void\s+" + _LAUNCH_BOUNDS + r"(\w+)\s*\(",
                                      src)})


def _structs() -> dict[str, str]:
    """Every struct of the sources with its body."""
    out = {}
    for src in SOURCES.values():
        for m in re.finditer(r"struct\s+(?:__align__\(\d+\)\s+)?(\w+)[^;{]*\{", src):
            depth, i = 1, m.end()
            while depth:
                depth += {"{": 1, "}": -1}.get(src[i], 0)
                i += 1
            out[m.group(1)] = src[m.end():i]
    return out


STRUCTS = _structs()
# the policies of lucy_tile.cuh's two templates, by what each must declare
# (its comments on `Chain` and `Step`)
POLICIES = {"cell_fwd_kernel": sorted(s for s, body in STRUCTS.items() if "kMasked =" in body),
            "ring_scan_kernel": sorted(s for s, body in STRUCTS.items() if "kReverse =" in body)}


def _names(kernel: str) -> list[str]:
    """The kernel's names as the profiler shows them: one per policy of a
    shared template, one per direction of the wavefronts."""
    if kernel in POLICIES:
        return [f"void lucy_tile::{kernel}<(anonymous namespace)::{p}<float>, float, 4>"
                f"(float const*, float const*, int, int, int)" for p in POLICIES[kernel]]
    if kernel.endswith("wavefront_kernel"):
        return [f"void rnnt_wavefront::{kernel}<{rev}, 8, true>(float const*, int, int)"
                for rev in ("false", "true")]
    return [f"void (anonymous namespace)::{kernel}<float>(float const*, int, int)"]


def test_sources_hold_the_kernels_and_policies():
    assert len(KERNELS) >= 25 and {"cell_fwd_kernel", "ring_scan_kernel"} <= set(KERNELS)
    assert POLICIES == {"cell_fwd_kernel": ["Chain", "MaskedCellChain"],
                        "ring_scan_kernel": ["DualScan", "FwdScan", "RevScan"]}


@pytest.mark.parametrize("group,frags", GROUPS, ids=[f"{g}:{f[-1]}" for g, f in GROUPS])
def test_every_fragment_names_a_kernel_or_policy(group, frags):
    known = {k.lower() for k in KERNELS} | {s.lower() for s in STRUCTS}
    for frag in frags:
        words = set(re.findall(r"[a-z_][a-z0-9_]*", frag)) - {"true", "false"}
        assert words and words <= known, f"{group}: {frag!r} names no kernel or policy type"


@pytest.mark.parametrize("kernel", KERNELS)
def test_every_kernel_falls_in_a_group_that_names_it(kernel):
    groups = []
    for name in _names(kernel):
        group = group_of(name)
        frags = next(f for g, f in GROUPS if g == group and all(x in name.lower() for x in f)) \
            if group != "other" else ()
        assert kernel.lower() in " ".join(frags), f"{name} falls in {group!r}"
        groups.append(group)
    assert len(set(groups)) == len(groups) or kernel == "band_wavefront_kernel", groups


def test_k1_and_k12_and_the_ring_scans_apart():
    cell = {p: group_of(n) for p, n in zip(POLICIES["cell_fwd_kernel"],
                                           _names("cell_fwd_kernel"))}
    ring = {p: group_of(n) for p, n in zip(POLICIES["ring_scan_kernel"],
                                           _names("ring_scan_kernel"))}
    assert cell == {"Chain": "K1 cell_fwd_kernel<Chain>",
                    "MaskedCellChain": "K12 cell_fwd_kernel<MaskedCellChain>"}
    assert ring == {"FwdScan": "K5a ring_scan_kernel<FwdScan>",
                    "RevScan": "K5b ring_scan_kernel<RevScan>",
                    "DualScan": "K11 ring_scan_kernel<DualScan>"}
    assert group_of("void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_128x128>()") == "GEMMs"
    assert group_of("void at::native::vectorized_elementwise_kernel<4>()") == "other"
