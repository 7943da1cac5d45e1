"""K1, K2 and K3 (``flash_fwd.cu``, ``flash_bwd.cu``) run on the CPU
through the emulator of :mod:`torch_port_emu` (whose docstring says what
it emulates and what it cannot show), against their plain versions:
the bf16 K1, K2 and K3 on wgmma fed by TMA through an mbarrier ring,
and the f32 K1, K2 and K3 register-tiled and fed by cp.async; copies
and products landing at once or at their waits.  The cases cross more
than one of the kernels' 128-row blocks and 64-row stages, with GQA, ragged S and T, both head dims and
shifted masks; one case runs K1, K2 and K3 twice, bit for bit.  The f32
K1 also runs at the edges of its own tiles, its shift by value and from
memory, and the f32 K2 and K3 at theirs.  The file
also holds ``chip_smoke.py``'s names for K1, K2 and K3 (what its SASS
check keys on) against the built library's symbols.

Tolerances as on the card: K1 5e-2 (bf16) and 1e-4 (f32) absolute;
K2/K3 2e-2 (bf16) and 1e-4 (f32) of the largest gradient.  Each child
runs under :data:`CHILD_TIMEOUT_S`, a hang guard.
"""

import json

import pytest

from torch_port_emu import (CASES, CHILD, K1_F32_CASES, K23_F32_CASES,
                            REPEAT_CASES, build, kernel_names, run_child)

# The hang guard, three times the slowest case's time in the 6-worker
# tier-1 run, `pytest -n 6 --dist loadfile`
# (test_emulated_kernels_match_plain_versions[bf16-immediate]: 197.2 s
# there, with the last three CASES at larger shapes than now; 25.3 s
# alone as they are).  The emulator's barriers of one thread a CUDA
# thread slow down sharply on a loaded machine, and K2 and K3 run 384
# threads a block.
CHILD_TIMEOUT_S = 600


def _within(err: dict, keys, tol: float) -> bool:
    """Every error in ``keys`` at most ``tol`` (a NaN error fails, where
    ``max`` over the errors would pass it over)."""
    return all(err[k] <= tol for k in keys)


@pytest.fixture(scope="module")
def emulated_libs(tmp_path_factory):
    return build(tmp_path_factory.mktemp("emulated"),
                 ("flash_fwd", "flash_bwd"))


@pytest.mark.parametrize("copies", ["immediate", "at_wait"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_emulated_kernels_match_plain_versions(emulated_libs, dtype, copies):
    res = run_child(CHILD, [emulated_libs, dtype, json.dumps(CASES),
                            "value", json.dumps(REPEAT_CASES)],
                    CHILD_TIMEOUT_S, copies == "at_wait")
    assert len(res) == len(CASES)
    fwd_tol, bwd_tol = (5e-2, 2e-2) if dtype == "bf16" else (1e-4, 1e-4)
    for case, err in res.items():
        assert err["o"] <= fwd_tol and err["lse"] <= fwd_tol, (case, err)
        assert _within(err, ("dk", "dv", "dq"), bwd_tol), (case, err)
    for case in REPEAT_CASES:
        assert res[str(list(case))]["repeat"] is True, case


@pytest.mark.parametrize("copies,shift", [("immediate", "device"),
                                          ("at_wait", "value")])
def test_emulated_f32_forward_at_its_tile_edges(emulated_libs, copies,
                                                shift):
    """The f32 K1 (register-tiled, fed by cp.async) at the edges of its
    tiles, :data:`~torch_port_emu.K1_F32_CASES`, within 1e-4 of the
    plain version: its shift read from memory with copies landing at
    once, and by value with copies landing at their wait (then K2 and
    K3 too, and every case again bit for bit)."""
    value = shift == "value"
    res = run_child(CHILD, [emulated_libs, "f32", json.dumps(K1_F32_CASES),
                            shift,
                            json.dumps(K1_F32_CASES if value else [])],
                    CHILD_TIMEOUT_S, copies == "at_wait")
    assert len(res) == len(K1_F32_CASES)
    for case, err in res.items():
        assert err["o"] <= 1e-4 and err["lse"] <= 1e-4, (case, err)
        if value:
            assert _within(err, ("dk", "dv", "dq"), 1e-4), (case, err)
            assert err["repeat"] is True, case


@pytest.mark.parametrize("copies", ["immediate", "at_wait"])
def test_emulated_f32_backward_at_its_tile_edges(emulated_libs, copies):
    """The f32 K2 and K3 (register-tiled, fed by cp.async) at the edges
    of their tiles, :data:`~torch_port_emu.K23_F32_CASES` (GQA G = 2 and
    4, S and T of 1, 63, 65, 97 and 161, shifts that cut a stage or mask
    whole rows, D = 64 and 128), within 1e-4 of the plain versions (of
    the largest gradient), and every case again bit for bit; copies
    landing at once and at their wait."""
    res = run_child(CHILD, [emulated_libs, "f32", json.dumps(K23_F32_CASES),
                            "value", json.dumps(K23_F32_CASES)],
                    CHILD_TIMEOUT_S, copies == "at_wait")
    assert len(res) == len(K23_F32_CASES)
    for case, err in res.items():
        assert err["o"] <= 1e-4 and err["lse"] <= 1e-4, (case, err)
        assert _within(err, ("dk", "dv", "dq"), 1e-4), (case, err)
        assert err["repeat"] is True, case


def test_chip_smoke_names_every_flash_backward_kernel(emulated_libs):
    """``chip_smoke.py``'s SASS check finds K2 and K3 by the names its
    ``_kernel_name`` reads from their mangled symbols: every kernel
    function of the backward library built from the repository's source
    reads as one of the names the check requires (the wgmma kernels in
    bf16, the register-tiled ones in f32, each at D = 64 and 128), and each
    required name is there."""
    smoke, names = kernel_names(emulated_libs / "libflash_bwd.so",
                                 r"flash_bwd_(dkdv|dq)_kernel")
    assert names == set(smoke.FLASH_BWD_WGMMA) | set(smoke.FLASH_BWD_F32), \
        names


def test_chip_smoke_names_every_flash_forward_kernel(emulated_libs):
    """The same for K1: the forward library's kernel functions read as
    the names ``chip_smoke.py``'s SASS check requires, the wgmma kernel
    in bf16 and the register-tiled one in f32, each at D = 64 and 128."""
    smoke, names = kernel_names(emulated_libs / "libflash_fwd.so",
                                 r"flash_fwd_kernel")
    assert names == set(smoke.FLASH_FWD_WGMMA) | set(smoke.FLASH_FWD_F32), \
        names
