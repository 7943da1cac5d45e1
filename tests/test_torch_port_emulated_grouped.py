"""G1 and G2 (``grouped_matmul.cu``) run on the CPU through the emulator
of :mod:`torch_port_emu`, against their plain versions: G1's wgmma + TMA
and register-tiled f32 kernels in both modes, G2's wgmma + TMA and
register-tiled f32 kernels (the latter also at the edges of its tiles),
TMA tiles, cp.async copies and wgmma products landing at issue or at
their wait.
The file also holds ``chip_smoke.py``'s names for the grouped kernels
(what its SASS check keys on) against the built library's symbols.

Tolerances as on the card: 2e-2 (bf16) and 1e-4 (f32) of the largest
output.  Each child runs under :data:`CHILD_TIMEOUT_S`, a hang guard.
"""

import json

import pytest

from torch_port_emu import (DW_CASES, DW_EDGE_CASES, GMM_CASES, GMM_CHILD,
                            build, kernel_names, run_child)

# The hang guard: 15x the slowest case's time in the driver's 6-worker
# tier-1 command, rounded up to 30 s
# (test_emulated_grouped_backward_matches_plain_version[f32-immediate-dw]:
# 17.0 s there, 7.8 s alone).  The emulator's barriers of one thread a
# CUDA thread slow down sharply on a loaded machine.
CHILD_TIMEOUT_S = 270


@pytest.fixture(scope="module")
def emulated_libs(tmp_path_factory):
    return build(tmp_path_factory.mktemp("emulated"), ("grouped_matmul",))


def _run_gmm(libdir, dtype, copies, mode, cases=None):
    if cases is None:
        cases = DW_CASES if mode == "dw" else GMM_CASES
    res = run_child(GMM_CHILD, [libdir, dtype, json.dumps(cases), mode],
                    CHILD_TIMEOUT_S, copies == "at_wait")
    assert len(res) == len(cases) + (mode != "dw")
    tol = 2e-2 if dtype == "bf16" else 1e-4
    for case, err in zip(cases, res):
        assert err["err"] <= tol, (case, err)
        if mode == "dw":
            assert err["repeat"] and err["empty_zero"], (case, err)
    if mode != "dw":
        assert res[-1]["invariant"]


@pytest.mark.parametrize("dtype,copies", [("bf16", "immediate"),
                                          ("bf16", "at_wait"),
                                          ("f32", "immediate")])
def test_emulated_grouped_matmul_matches_plain_version(emulated_libs, dtype,
                                                       copies):
    """G1's forward: the bf16 wgmma + TMA kernel (TMA tiles and wgmma
    products landing at issue, or at their barrier's wait and their
    group's wait) and the f32 register-tiled kernel."""
    _run_gmm(emulated_libs, dtype, copies, "forward")


@pytest.mark.parametrize("mode", ["dx", "dw"])
@pytest.mark.parametrize("dtype,copies", [("bf16", "immediate"),
                                          ("bf16", "at_wait"),
                                          ("f32", "immediate"),
                                          ("f32", "at_wait")])
def test_emulated_grouped_backward_matches_plain_version(emulated_libs,
                                                         dtype, copies,
                                                         mode):
    """The dropless dispatch's backward: G1 with W read transposed (dx;
    the wgmma kernel's K-major B) and G2 (dW; wgmma + TMA with both
    operands MN-major in bf16, register-tiled and fed by cp.async in
    f32) against their plain versions; G2 also bit-identical over two
    calls, an empty group's dW exactly 0."""
    _run_gmm(emulated_libs, dtype, copies, mode)


@pytest.mark.parametrize("dtype,copies", [("bf16", "immediate"),
                                          ("bf16", "at_wait"),
                                          ("f32", "immediate"),
                                          ("f32", "at_wait")])
def test_emulated_grouped_dw_at_its_tile_edges(emulated_libs, dtype,
                                               copies):
    """G2 at the edges of the f32 kernel's tiles and stages,
    :data:`~torch_port_emu.DW_EDGE_CASES` (groups ending inside a stage,
    an empty group, a group of one row, K and N off the tiles, T = 1),
    in both dtypes and both landing modes: within tolerance of the plain
    version, bit-identical over two calls, an empty group's dW 0."""
    _run_gmm(emulated_libs, dtype, copies, "dw", DW_EDGE_CASES)


def test_chip_smoke_names_every_grouped_kernel(emulated_libs):
    """``chip_smoke.py``'s SASS check finds the grouped kernels by the
    names its ``_kernel_name`` reads from their mangled symbols: every
    grouped kernel function of the library built from the repository's
    source reads as one of the names the check requires, and each
    required name is there (G2's bf16 kernel is no template, so it must
    not read as one of G1's two modes)."""
    smoke, names = kernel_names(emulated_libs / "libgrouped_matmul.so",
                                r"grouped_(mm|dw)_kernel")
    assert names == set(smoke.GROUPED_WGMMA) | set(smoke.GROUPED_F32), names
