"""K4 (``paged_attention.cu``: the split, rows and combine kernels) run on
the CPU through the emulator of :mod:`torch_port_emu`, against its plain
version for every pool, ``cp.async`` copies, TMA boxes and their
mbarriers landing at once or at their wait; a bf16 pool runs its R > 8
cases on the rows kernel.  The file also holds ``chip_smoke.py``'s names
for K4's kernels (what its SASS check keys on) against the built
library's symbols.

Tolerances as on the card: 1e-4 (f32 and int8 -> f32) and 2e-2 (bf16 and
int8 -> bf16) absolute.  Each child runs under :data:`CHILD_TIMEOUT_S`,
a hang guard.
"""

import json

import pytest

from torch_port_emu import (PAGED_CASES, PAGED_CHILD, build,
                            kernel_names, run_child)

# The hang guard: about 9x the slowest case's time in the 6-worker
# tier-1 command (`pytest -n 6 --dist loadfile`) on a loaded machine
# (test_emulated_paged_kernel_matches_plain_version[f32-immediate]: 50.2 s
# there with the fixture's build, 28.2 s before the rows kernel's cases;
# the bf16 pool's own cases under 14 s).  The emulator's barriers of one
# thread a CUDA thread slow down sharply on a loaded machine.
CHILD_TIMEOUT_S = 450


@pytest.fixture(scope="module")
def emulated_libs(tmp_path_factory):
    return build(tmp_path_factory.mktemp("emulated"), ("paged_attention",))


@pytest.mark.parametrize("copies", ["immediate", "at_wait"])
@pytest.mark.parametrize("pool", ["f32", "bf16", "int8_f32", "int8_bf16"])
def test_emulated_paged_kernel_matches_plain_version(emulated_libs, pool,
                                                     copies):
    cases = [c for c in PAGED_CASES if pool in c.get("pools", [pool])]
    res = run_child(PAGED_CHILD, [emulated_libs, pool, json.dumps(cases)],
                    CHILD_TIMEOUT_S, copies == "at_wait")
    assert len(res) == len(cases)
    tol = 2e-2 if pool.endswith("bf16") else 1e-4
    for case, err in zip(cases, res):
        assert err["o"] <= tol and err["lse"] <= tol, (case, err)
        assert err["dead_o"] == 0 and err["dead_lse"] <= -1e30 / 2, (case,
                                                                     err)


def test_chip_smoke_names_every_paged_kernel(emulated_libs):
    """``chip_smoke.py``'s SASS check finds K4's rows kernel by the names
    its ``_kernel_name`` reads from the mangled symbols (one a head dim
    block, 64 and 128), and every other kernel of the library reads as a
    split kernel or the combine kernel."""
    smoke, names = kernel_names(emulated_libs / "libpaged_attention.so",
                                r"paged_attend_\w*kernel")
    rows = {n for n in names if n.startswith("paged_attend_rows_kernel")}
    assert rows == set(smoke.PAGED_ROWS), names
    assert all(n in rows or n == "paged_attend_combine_kernel"
               or n.startswith("paged_attend_split_kernel<")
               for n in names), names
