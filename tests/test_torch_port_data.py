"""horovod_tpu_torch.data.DataLoader against the JAX package's.

The counterpart of every test in ``tests/test_data.py`` (device placement
takes the place of the mesh-sharding test: one rank drives one device,
so the port has no sharding argument), and the rows themselves: for the
same arrays and seed, both loaders yield the same rows in the same order
over two epochs, unsharded and as rank 1 of 3 (rank and size set on both
packages' ``basics`` by ``monkeypatch``).  Exact equality throughout.
"""

import numpy as np
import pytest
import torch

from horovod_tpu import basics as jbasics
from horovod_tpu.data import DataLoader as JDataLoader
from horovod_tpu_torch import basics
from horovod_tpu_torch.data import DataLoader


def _arrays(n=100):
    return {"x": np.arange(n, dtype=np.float32).reshape(n, 1),
            "y": np.arange(n, dtype=np.float32)}


def _loader(arrays, batch, **kw):
    return DataLoader(arrays, batch, device="cpu", **kw)


class TestDataLoader:
    def test_batches_on_device_and_complete(self):
        dl = _loader(_arrays(64), 8, shuffle=False, shard=False)
        batches = list(dl)
        assert len(batches) == len(dl) == 8
        assert all(isinstance(b["x"], torch.Tensor) for b in batches)
        seen = torch.cat([b["y"] for b in batches]).numpy()
        np.testing.assert_array_equal(np.sort(seen), np.arange(64))

    def test_drop_remainder(self):
        dl = _loader(_arrays(70), 8, shuffle=False, shard=False)
        assert len(dl) == 8  # 70 // 8, last 6 rows dropped

    def test_epoch_reshuffle_deterministic(self):
        a = _arrays(32)
        dl1 = _loader(a, 8, shuffle=True, seed=5, shard=False)
        dl2 = _loader(a, 8, shuffle=True, seed=5, shard=False)
        e1 = torch.cat([b["y"] for b in dl1]).numpy()
        e1b = torch.cat([b["y"] for b in dl1]).numpy()  # second epoch
        e2 = torch.cat([b["y"] for b in dl2]).numpy()
        np.testing.assert_array_equal(e1, e2)
        assert not np.array_equal(e1, e1b)

    def test_prefetch_zero_and_large(self):
        for prefetch in (0, 100):
            dl = _loader(_arrays(32), 8, shuffle=False, shard=False,
                         prefetch=prefetch)
            assert len(list(dl)) == 4

    def test_device_placement(self):
        """``device=`` takes the place of the JAX ``sharding=``: every
        batch lands there, as a copy (a yielded batch shares no memory
        with the host arrays)."""
        a = _arrays(64)
        for b in _loader(a, 16, shuffle=False, shard=False):
            assert b["x"].device == torch.device("cpu")
            b["x"].fill_(-1)
        assert a["x"].min() == 0

    def test_large_seed_ok(self):
        dl = _loader(_arrays(16), 4, shuffle=True, seed=2 ** 31,
                     shard=False)
        assert len(list(dl)) == 4

    def test_length_mismatch_raises(self):
        with pytest.raises(ValueError, match="disagree"):
            _loader({"x": np.zeros((4, 1)), "y": np.zeros(5)}, 2)

    def test_oversized_batch_raises(self):
        with pytest.raises(ValueError, match="exceeds"):
            _loader(_arrays(4), 8, shard=False)

    def test_torch_and_channels_last_arrays(self):
        """A bf16 host tensor and an NHWC array viewed as NCHW keep their
        dtype, values and ``channels_last`` layout."""
        nhwc = torch.arange(8 * 4 * 4 * 3, dtype=torch.float32).reshape(
            8, 4, 4, 3).to(torch.bfloat16)
        images = nhwc.permute(0, 3, 1, 2)
        for shuffle in (False, True):
            dl = _loader({"images": images, "i": np.arange(8)}, 4,
                         shuffle=shuffle, shard=False)
            for b in dl:
                got = b["images"]
                assert got.dtype == torch.bfloat16
                assert got.is_contiguous(memory_format=torch.channels_last)
                assert torch.equal(got, images[b["i"]])


def _rank(monkeypatch, rank, size):
    """Rank and size on both packages' ``basics`` (JAX:
    ``process_rank``/``num_processes``; the port: ``rank``/``size``)."""
    for mod, r, s in ((jbasics, "process_rank", "num_processes"),
                      (basics, "rank", "size")):
        monkeypatch.setattr(mod, "is_initialized", lambda: True)
        monkeypatch.setattr(mod, r, lambda: rank)
        monkeypatch.setattr(mod, s, lambda: size)


@pytest.mark.parametrize("rank,size", [(0, 1), (1, 3)])
@pytest.mark.parametrize("shuffle", [False, True])
def test_same_rows_as_the_jax_loader(monkeypatch, hvd, rank, size, shuffle):
    """Two epochs, batch 4, prefetch 2, seed 7, 50 rows: the same batches
    of the same rows, and the same count (the lockstep length)."""
    _rank(monkeypatch, rank, size)
    a = {"x": np.random.RandomState(0).randn(50, 3).astype(np.float32),
         "y": np.arange(50, dtype=np.int64)}
    jdl = JDataLoader(a, 4, shuffle=shuffle, seed=7)
    dl = DataLoader(a, 4, shuffle=shuffle, seed=7, device="cpu")
    assert len(dl) == len(jdl) == (50 // size) // 4
    for _ in range(2):
        got = [{k: v.numpy() for k, v in b.items()} for b in dl]
        want = [{k: np.asarray(v) for k, v in b.items()} for b in jdl]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for k in a:
                np.testing.assert_array_equal(g[k], w[k])
