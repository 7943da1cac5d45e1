"""The port's chunked prefill against the JAX engine, on the CPU at f32.

Following ``tests/test_sched.py`` (chunked prefill, preemption of an
ingesting request, a crash mid-chunk) and ``tests/test_chaos.py`` (a
crash at each chunk boundary, a hang inside a chunk): the same stepped
scenario runs through both engines from one set of weights and must
give the same record — tokens or typed errors, finish reasons, the
prefill count, the restart, resume and preemption counters, the pages
free.  A prompt longer than ``prefill_chunk_tokens`` lands one chunk a
tick, every chunk after the first attending the landed ones through
``prefill_with_prefix``; its tokens equal a whole-prompt prefill's,
greedy and sampled, with the pipeline on and off.  Short requests
decode while a long one ingests.  An ingesting slot is out of the
tick's active input.  A chunked prompt that starts with a registered
prefix ingests only its suffix.  A victim preempted mid-ingestion, or
caught by a fault or a hang at a chunk boundary, re-ingests from its
prompt to the same tokens; one cancelled or past its deadline
mid-ingestion ends with no token and gives its pages back.

The JAX engine's "compile set is bounded" becomes: one chunk, one
prefill call (the port prefills eagerly; its decode tick is captured
once on the card, ``tests/test_torch_port_cuda.py``).

The scenarios run on lent engines (pages of 8, chunks of 8, max_len 48)
and read their counters as differences."""

import time

import numpy as np
import pytest
import torch

from torch_port_parity import (
    counters,
    make_model,
    oracle,
    outcome,
    run,
    run_both,
    settle,
    wait_for,
)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    return make_model()


#: The lent engines: three slots, chunks of 8 (one page) a tick.
CHUNKED = dict(max_len=48, prefill_chunk_tokens=8)
OVERLAP = pytest.mark.parametrize("overlap", [True, False],
                                  ids=["overlap", "sync"])


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, 64, n).tolist()


def _calls(engine):
    return engine.stats()["prefill_calls"]


def _free(engine):
    return (engine.slots.free_pages, engine.slots.n_pages)


def test_chunk_knob_is_validated(model):
    """A negative chunk is a ``ValueError`` in both packages."""

    def scenario(S, make):
        try:
            make(prefill_chunk_tokens=-1)
        except ValueError as e:
            return type(e).__name__
        return None

    assert run_both(model, scenario) == "ValueError"


class TestChunkedGeneration:
    @OVERLAP
    def test_greedy_equals_whole_prompt(self, model, overlap):
        """Long and short greedy prompts mixed: every request's tokens
        equal the whole prompt's oracle; the long ones took one prefill
        per chunk (41 tokens: 6 chunks; 27: 4) and the short ones one
        prefill per admission group."""
        prompts = [_prompt(7, n) for n in (41, 3, 27, 5)]

        def scenario(S, make):
            engine = make(**CHUNKED, overlap=overlap)
            before, c0 = counters(engine), _calls(engine)
            futs = [engine.submit(p, max_new_tokens=8) for p in prompts]
            run(engine, futs)
            st = engine.stats()
            return {"futs": [outcome(f) for f in futs],
                    "calls": _calls(engine) - c0,
                    "ingesting": st["slots_ingesting"],
                    "chunk": st["prefill_chunk_tokens"],
                    "free": _free(engine),
                    "stats": counters(engine, since=before)}

        rec = run_both(model, scenario, shared=True)
        assert rec["futs"] == [("ok", oracle(model, p, 8), "length")
                               for p in prompts]
        assert 6 + 4 + 1 <= rec["calls"] <= 6 + 4 + 2
        assert (rec["ingesting"], rec["chunk"]) == (0, 8)
        assert rec["free"][0] == rec["free"][1]

    def test_one_prefill_per_chunk(self, model):
        """Two 43-token prompts, one after the other: six chunks, six
        prefill calls each, whatever the chunk boundaries (the JAX
        engine compiles no new shape for the second)."""

        def scenario(S, make):
            engine = make(**CHUNKED)
            calls = []
            for seed in (19, 20):
                c0 = _calls(engine)
                fut = engine.submit(_prompt(seed, 43), max_new_tokens=4)
                run(engine, [fut])
                calls.append(_calls(engine) - c0)
            return calls

        assert run_both(model, scenario, shared=True) == [6, 6]

    def test_sampled_equals_sample_decode(self, model):
        """A sampled long prompt: the last chunk's logits feed the first
        draw at key position ``len(prompt)``, so the stream is
        ``sample_decode``'s."""
        p = _prompt(11, 33)
        kw = dict(temperature=0.8, top_k=12, seed=13)

        def scenario(S, make):
            engine = make(**CHUNKED)
            fut = engine.submit(p, max_new_tokens=8, **kw)
            run(engine, [fut])
            return outcome(fut)

        assert run_both(model, scenario, shared=True) == \
            ("ok", oracle(model, p, 8, **kw), "length")

    @pytest.mark.parametrize("prefix", [[9, 8, 7, 6, 5, 4, 3, 2],
                                        [9, 8, 7, 6, 5, 4, 3, 2, 1, 11, 12]],
                             ids=["aligned", "unaligned"])
    def test_chunks_attend_a_shared_prefix(self, model, prefix):
        """A chunked prompt that starts with a registered prefix attaches
        its pages and ingests only the suffix (the partial last page
        copied first when the prefix is unaligned): the tokens equal the
        oracle's, the prefix pages are shared while it runs, and after
        it only the pin holds pages."""
        p = prefix + _prompt(13, 30)

        def scenario(S, make):
            engine = make(**CHUNKED)
            engine.register_prefix(prefix)
            pinned = engine.slots.n_pages - engine.slots.free_pages
            c0 = _calls(engine)
            fut = engine.submit(p, max_new_tokens=6)
            shared = 0
            while not fut.done():
                engine.step()
                shared = max(shared, engine.slots.pages_shared)
            rec = {"fut": outcome(fut), "pinned": pinned,
                   "calls": _calls(engine) - c0, "shared": shared,
                   "held": engine.slots.n_pages - engine.slots.free_pages,
                   "shared_after": engine.slots.pages_shared}
            engine.unregister_prefix(prefix)
            rec["free"] = _free(engine)
            return rec

        rec = run_both(model, scenario, shared=True)
        assert rec["fut"] == ("ok", oracle(model, p, 6), "length")
        assert rec["calls"] == 4  # 30 suffix tokens, chunks of 8
        assert rec["shared"] >= 1 and rec["shared_after"] == 0
        assert rec["held"] == rec["pinned"] == -(-len(prefix) // 8)
        assert rec["free"][0] == rec["free"][1]

    def test_decode_rides_through_ingestion(self, model):
        """A short request admitted behind a long prompt decodes to the
        end while the long one is still ingesting, which has no token
        yet."""
        long_p = _prompt(17, 40)

        def scenario(S, make):
            engine = make(**CHUNKED)
            long_f = engine.submit(long_p, max_new_tokens=4)
            engine.step()  # the first chunk lands
            short = engine.submit([5, 9], max_new_tokens=3)
            for _ in range(400):
                engine.step()
                if short.done():
                    break
            mid = (short.done(), long_f.done(), long_f.tokens_so_far())
            run(engine, [long_f])
            return {"mid": mid, "futs": [outcome(short), outcome(long_f)]}

        rec = run_both(model, scenario, shared=True)
        assert rec["mid"] == (True, False, [])
        assert rec["futs"] == [("ok", oracle(model, [5, 9], 3), "length"),
                               ("ok", oracle(model, long_p, 4), "length")]


@OVERLAP
def test_tick_active_input_leaves_ingesting_slots_out(model, overlap):
    """The captured tick's static ``active`` input (what ``_dispatch``
    uploads) holds the decoding slots and not the ingesting one, with
    the pipeline on and off."""
    from torch_port_parity import make_engine

    engine = make_engine(model, "port", n_slots=3, min_prefill_bucket=4,
                         page_size=8, tick_timeout=0, overlap=overlap,
                         **CHUNKED)
    short = engine.submit([5, 9], max_new_tokens=20)
    engine.step()
    long_f = engine.submit(_prompt(3, 40), max_new_tokens=2)
    engine.step()
    seen = []
    while engine.stats()["slots_ingesting"]:
        (ing,) = engine._ingest
        engine.step()
        seen.append((ing, engine._tick.active.tolist()))
    assert len(seen) >= 3
    for ing, active in seen[:-1]:
        assert active[ing] is False and active[0] is True
    run(engine, [short, long_f])
    assert long_f.result(timeout=0) == oracle(model, _prompt(3, 40), 2)


class TestChunkedFaults:
    def test_preempted_mid_ingestion_resumes_exact(self, model):
        """One slot: a batch-class prompt mid-ingestion is suspended for
        an interactive arrival, its landed chunks counted as wasted
        prefill, and re-ingested from its prompt to the oracle's
        tokens."""
        long_p = _prompt(23, 40)

        def scenario(S, make):
            engine = make(**CHUNKED, n_slots=1)
            before = counters(engine)
            victim = engine.submit(long_p, max_new_tokens=4,
                                   priority="batch")
            engine.step()
            engine.step()
            ingesting = engine.stats()["slots_ingesting"]
            inter = engine.submit([5, 6], max_new_tokens=2)
            run(engine, [inter, victim])
            return {"ingesting": ingesting,
                    "futs": [outcome(inter), outcome(victim)],
                    "free": _free(engine),
                    "stats": counters(engine, since=before)}

        rec = run_both(model, scenario, shared=True)
        assert rec["ingesting"] == 1
        assert rec["futs"] == [("ok", oracle(model, [5, 6], 2), "length"),
                               ("ok", oracle(model, long_p, 4), "length")]
        st = rec["stats"]
        assert st["preemptions"] == 1 and st["resume_wasted_tokens"] >= 16
        assert rec["free"][0] == rec["free"][1]

    def test_cancel_and_deadline_mid_ingestion(self, model):
        """Two prompts mid-ingestion: one cancelled, the other past its
        deadline.  Each is reaped at its next chunk with no token
        (``cancelled``, ``deadline``), its pages return, and the engine
        serves the next request to the oracle."""

        def scenario(S, make):
            engine = make(**CHUNKED)
            before = counters(engine)
            a = engine.submit(_prompt(41, 40), max_new_tokens=4)
            b = engine.submit(_prompt(42, 40), max_new_tokens=4)
            engine.step()
            engine.step()
            ingesting = engine.stats()["slots_ingesting"]
            a.cancel()
            for ing in engine._ingest.values():
                if ing.request.future is b:
                    ing.request.deadline = time.monotonic() - 1.0
            run(engine, [a, b])
            c = engine.submit([3, 4], max_new_tokens=3)
            run(engine, [c])
            return {"ingesting": ingesting,
                    "futs": [outcome(f) for f in (a, b, c)],
                    "free": _free(engine),
                    "stats": counters(engine, since=before)}

        rec = run_both(model, scenario, shared=True)
        assert rec["ingesting"] == 2
        assert rec["futs"] == [("ok", [], "cancelled"), ("ok", [], "deadline"),
                               ("ok", oracle(model, [3, 4], 3), "length")]
        assert rec["free"][0] == rec["free"][1]
        st = rec["stats"]
        assert (st["requests_cancelled"], st["requests_completed"]) == (1, 2)

    @pytest.mark.parametrize("chunk_idx", [0, 1, 3])
    def test_crash_at_a_chunk_boundary_resumes_exact(self, model,
                                                      chunk_idx):
        """A raise at the ``prefill_chunk`` site (chunk 0, 1 or 3 of a
        30-token prompt, a short request decoding beside it): one
        restart, the ingesting request re-ingests from its prompt and
        both requests end with the oracle's tokens."""
        long_p = _prompt(31 + chunk_idx, 30)

        def scenario(S, make):
            engine = make(**CHUNKED)
            inj = engine.engine_cfg.faults
            before = counters(engine)
            inj.add(S.FaultSpec(site="prefill_chunk", kind="raise",
                                skip=inj.visits("prefill_chunk")
                                + chunk_idx))
            vic = engine.submit(long_p, max_new_tokens=4)
            sh = engine.submit([4, 2], max_new_tokens=3)
            run(engine, [vic, sh], max_ticks=600)
            st = engine.stats()
            return {"futs": [outcome(vic), outcome(sh)],
                    "fired": [f[:2] for f in inj.fired[-1:]],
                    "ingesting": st["slots_ingesting"],
                    "queue": st["queue_depth"],
                    "stats": counters(engine, since=before)}

        rec = run_both(model, scenario, shared=True)
        assert rec["futs"] == [("ok", oracle(model, long_p, 4), "length"),
                               ("ok", oracle(model, [4, 2], 3), "length")]
        assert rec["fired"] == [("prefill_chunk", "raise")]
        st = rec["stats"]
        assert (st["engine_restarts"], st["journal_inflight"]) == (1, 0)
        assert (rec["ingesting"], rec["queue"]) == (0, 0)

    def test_chunk_hang_trips_the_watchdog_and_resumes(self, model):
        """A hang inside a chunk past ``tick_timeout``: the watchdog
        declares the stall, the tick returns within the grace, the
        restart re-ingests and the tokens equal the oracle's."""
        warm_p, long_p = _prompt(37, 30), _prompt(38, 30)

        def scenario(S, make):
            # Budget and hang three times the first margins (0.3 s,
            # 0.8 s): under the 6-worker tier-1 load a clean tick has
            # outlived 0.3 s.
            engine = make(**CHUNKED, n_slots=2, tick_timeout=0.9,
                          watchdog_interval=0.02, stall_grace=10.0)
            inj = engine.engine_cfg.faults
            engine.warmup((3,))
            run(engine, [engine.submit(warm_p, max_new_tokens=2)])
            warmed = counters(engine)
            inj.add(S.FaultSpec(site="prefill_chunk", kind="hang",
                                delay=2.4,
                                skip=inj.visits("prefill_chunk") + 1))
            engine.start()
            try:
                outs = settle([engine.submit(long_p, max_new_tokens=4)])
                healthy = wait_for(lambda: engine.health == "healthy")
            finally:
                engine.stop()
            return {"futs": outs, "healthy": healthy,
                    "stats": counters(engine, since=warmed)}

        rec = run_both(model, scenario)
        assert rec["futs"] == [("ok", oracle(model, long_p, 4), "length")]
        st = rec["stats"]
        assert (st["engine_failures"], st["engine_restarts"],
                st["requests_resumed"]) == (1, 1, 1)
        assert rec["healthy"] and st["journal_inflight"] == 0
