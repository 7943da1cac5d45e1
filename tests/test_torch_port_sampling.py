"""horovod_tpu_torch's sampler against the JAX package's, on the CPU.

* ``ops/threefry.py`` against ``jax.random``: ``fold_in``,
  ``random_bits`` and ``uniform`` bit for bit, over seeds, positions and
  shapes, in the bit layout of ``jax_threefry_partitionable`` (JAX's
  default, which the port implements: the tests fail if it is off);
  ``gumbel`` within 1e-6 of max(1, |value|) (the two ``log``s may round
  an ulp apart: 2.4e-7 at most over these cases).
* ``sample_token_rows`` against JAX's on greedy, top-k, top-p and mixed
  rows at f32: tokens equal, except where the port's ``margins`` reports
  a top-2 gap below ``NEAR_TIE`` — such exemptions are counted and
  printed.
* ``sample_decode`` against JAX's on a tiny f32 model, and a
  continuation from ``prompt + emitted`` against the uninterrupted run.
* ``serving/sampling.py``'s ``validate`` and ``seed_key`` on the JAX
  package's test cases.

Inputs come from a numpy seed; torch runs one thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as JT
from horovod_tpu_torch import serving
from horovod_tpu_torch.models import params_from_jax
from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.ops import threefry
from horovod_tpu_torch.serving import sampling as S

NEAR_TIE = 1e-4  # f32 top-2 gap under which two summation orders may differ


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _partitionable_layout():
    assert jax.config.jax_threefry_partitionable, (
        "the port implements the partitionable threefry bit layout")


def _tkey(jkey):
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


SEEDS = [0, 1, 42, 2 ** 20 + 17, S.MAX_SEED - 1]


class TestThreefry:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_fold_in_bit_equal(self, seed):
        key = jax.random.PRNGKey(seed)
        positions = [0, 1, 5, 1000, 2 ** 24 + 3, 2 ** 31 - 1]
        want = np.stack([np.asarray(jax.random.fold_in(key, p))
                         for p in positions]).astype(np.int64)
        got = threefry.fold_in(_tkey(key), torch.tensor(positions))
        np.testing.assert_array_equal(got.numpy(), want)
        # the sampler's double fold, batched over rows
        want2 = np.asarray(jax.random.fold_in(jax.random.fold_in(key, 7), 3))
        got2 = threefry.fold_in(threefry.fold_in(_tkey(key), 7), 3)
        np.testing.assert_array_equal(got2.numpy(), want2.astype(np.int64))

    @pytest.mark.parametrize("shape", [(1,), (7,), (64,), (3, 5), (2, 3, 4),
                                       (32000,)])
    @pytest.mark.parametrize("seed", SEEDS[:3])
    def test_bits_and_uniform_bit_equal(self, seed, shape):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
        bits = np.asarray(jax.random.bits(key, shape, jnp.uint32))
        got = threefry.random_bits(_tkey(key), shape)
        np.testing.assert_array_equal(got.numpy(), bits.astype(np.int64))
        u = np.asarray(jax.random.uniform(key, shape, jnp.float32))
        tu = threefry.uniform(_tkey(key), shape).numpy()
        np.testing.assert_array_equal(tu.view(np.uint32), u.view(np.uint32))
        tiny = float(np.finfo(np.float32).tiny)
        u2 = np.asarray(jax.random.uniform(key, shape, jnp.float32,
                                           minval=tiny, maxval=1.0))
        tu2 = threefry.uniform(_tkey(key), shape, minval=tiny).numpy()
        np.testing.assert_array_equal(tu2.view(np.uint32),
                                      u2.view(np.uint32))

    @pytest.mark.parametrize("seed", SEEDS)
    def test_gumbel_and_categorical(self, seed):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 2)
        g = np.asarray(jax.random.gumbel(key, (4096,)))
        tg = threefry.gumbel(_tkey(key), (4096,)).numpy()
        err = np.abs(tg - g) / np.maximum(np.abs(g), 1.0)
        assert err.max() <= 1e-6
        logits = np.random.default_rng(seed).standard_normal(
            (64,)).astype(np.float32)
        want = int(jax.random.categorical(key, jnp.asarray(logits)))
        got = int(threefry.categorical(_tkey(key),
                                       torch.from_numpy(logits)))
        assert got == want


def _rows_case(kind: str, R: int = 24, V: int = 64, seed: int = 0):
    """Sampler inputs: ``kind`` picks the parameter columns."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((R, V)) * 3).astype(np.float32)
    temp = rng.choice([0.5, 0.8, 1.0, 1.7], R).astype(np.float32)
    tk = np.zeros(R, np.int32)
    tp = np.zeros(R, np.float32)
    if kind == "greedy":
        temp[:] = 0.0
    elif kind == "top_k":
        tk = rng.choice([1, 2, 5, 17, 64, 100], R).astype(np.int32)
    elif kind == "top_p":
        tp = rng.choice([1e-9, 0.3, 0.7, 0.95, 1.0], R).astype(np.float32)
    else:  # mixed: greedy, top-k, top-p and both in one batch
        temp[::4] = 0.0
        tk = rng.choice([0, 0, 3, 10], R).astype(np.int32)
        tp = rng.choice([0.0, 0.0, 0.5, 0.9], R).astype(np.float32)
    keys = np.stack([S.seed_key(int(s)) for s in rng.integers(0, 1000, R)])
    pos = rng.integers(0, 2000, R).astype(np.int32)
    rows = np.zeros(R, np.int32)
    return logits, temp, tk, tp, keys, pos, rows


@pytest.mark.parametrize("kind", ["greedy", "top_k", "top_p", "mixed"])
def test_sample_token_rows_matches_jax(kind):
    exempt = 0
    for seed in range(4):
        case = _rows_case(kind, seed=seed)
        want = np.asarray(JT.sample_token_rows(*map(jnp.asarray, case)))
        tcase = [torch.from_numpy(np.asarray(a, np.int64)
                                  if a.dtype.kind in "iu" else a)
                 for a in case]
        got, gap = T.sample_token_rows(*tcase, margins=True)
        got, gap = got.numpy(), gap.numpy()
        diff = got != want
        tie = gap < NEAR_TIE
        assert not (diff & ~tie).any(), (kind, seed, np.nonzero(diff))
        exempt += int((diff & tie).sum())
        if kind == "greedy":
            np.testing.assert_array_equal(got, np.argmax(case[0], -1))
    print(f"sample_token_rows {kind}: {exempt} near-tie exemptions")


@pytest.fixture(scope="module")
def model():
    jcfg = JT.TransformerConfig(
        vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
        max_seq=48, dtype=jnp.float32, attention_impl="reference",
        n_kv_heads=2)
    tcfg = T.TransformerConfig(
        vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
        max_seq=48, dtype=torch.float32, attention_impl="flash",
        n_kv_heads=2)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    return jparams, jcfg, tparams, tcfg


PARAMS = [dict(temperature=1.0), dict(temperature=0.8, top_k=5),
          dict(temperature=1.3, top_p=0.9),
          dict(temperature=0.7, top_k=8, top_p=0.8), dict(temperature=0.0)]


@pytest.mark.parametrize("kw", PARAMS,
                         ids=["t1", "topk", "topp", "both", "greedy"])
def test_sample_decode_matches_jax(model, kw):
    jparams, jcfg, tparams, tcfg = model
    prompt = np.asarray([[3, 4, 5, 9, 1], [7, 7, 2, 60, 11]], np.int32)
    seed = 5 + len(kw)
    want = np.asarray(JT.sample_decode(
        jparams, jnp.asarray(prompt), 14, jcfg,
        rng=jax.random.PRNGKey(seed), **kw))
    got, gap = T.sample_decode(tparams, torch.from_numpy(prompt).long(), 14,
                               tcfg, rng=S.seed_key(seed), margins=True,
                               **kw)
    got, gap = got.numpy(), gap.numpy()
    for b in range(2):
        if (got[b] == want[b]).all():
            continue
        first = int(np.argmax(got[b] != want[b]))
        assert gap[b, :first + 1].min() < NEAR_TIE, (b, first, gap[b])
        print(f"sample_decode {kw} row {b}: near-tie exemption at {first}")


def test_continuation_from_prompt_plus_emitted(model):
    """Keys follow positions: re-prefilling ``prompt + emitted`` and
    continuing gives the tail of the uninterrupted stream."""
    _, _, tparams, tcfg = model
    prompt = [5, 9, 2, 33, 17]
    kw = dict(temperature=1.1, top_k=12, top_p=0.95, rng=S.seed_key(99))
    full = T.sample_decode(tparams, torch.tensor([prompt]), 12, tcfg,
                           **kw)[0].tolist()
    for cut in (1, 5, 11):
        tail = T.sample_decode(tparams, torch.tensor([prompt + full[:cut]]),
                               12 - cut, tcfg, **kw)[0].tolist()
        assert tail == full[cut:]
    assert T.greedy_decode(tparams, torch.tensor([prompt]), 6,
                           tcfg)[0].tolist() == T.sample_decode(
        tparams, torch.tensor([prompt]), 6, tcfg, rng=S.seed_key(3),
        temperature=0.0, top_p=0.9)[0].tolist()


class TestValidate:
    def test_seed_key_matches_prngkey(self):
        for seed in SEEDS:
            np.testing.assert_array_equal(
                S.seed_key(seed), np.asarray(jax.random.PRNGKey(seed)))
        with pytest.raises(ValueError):
            S.seed_key(S.MAX_SEED)

    def test_validate_rejects_bad_params(self):
        for bad in (dict(temperature=-0.5), dict(temperature=float("nan")),
                    dict(top_k=-1), dict(top_p=1.5), dict(seed=-1),
                    dict(seed=S.MAX_SEED), dict(temperature="hot")):
            with pytest.raises(serving.ServingError):
                S.validate(**bad)
        assert S.validate(1.0, 5, 0.9, 7) == (1.0, 5, 0.9, 7)
        assert S.validate() == (0.0, 0, 0.0, 0)
        assert S.SamplingParams.make(0.5, seed=3).sampled

    def test_slot_sampling_refreshes_static_columns(self):
        cols = serving.SlotSampling(3)
        d1 = cols.device()
        cols.set(1, temperature=0.8, top_k=3, top_p=0.9, seed=11)
        d2 = cols.device()
        assert all(a is b for a, b in zip(d1, d2))  # static tensors
        assert float(d2[0][1]) == pytest.approx(0.8)
        assert d2[1].tolist() == [0, 3, 0]
        assert d2[3][1].tolist() == [0, 11]
        cols.clear(1)
        assert float(cols.device()[0][1]) == 0.0
