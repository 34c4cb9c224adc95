"""The port's shared-wave scheduler (``gsv_tts_tpu_torch/runtime/wave.py``)
against the JAX package's (``gsv_tts_tpu/runtime/wave.py``), case by case as
``tests/test_wave.py`` holds the JAX one: independent clients attaching at
any time share one continuous-batching wave (the K2 twin for 2..4 slots, the
K1 twin for one), with slot refill, growth, cancellation, compaction,
admission control and failure paths.

Both engines run float32 on the same weights with ``top_k=1`` (greedy: the
Gumbel draws do not matter).  A single client's tokens equal the JAX
scheduler's and the JAX engine's ``generate_batched_stream`` exactly.  Where
clients arrive at times the threads decide, a stream is held to JAX's
one-client tokens as ``test_wave.py`` holds JAX's: equal over the common
prefix, lengths within one check interval (a row that runs to the cache's
edge ends on the chunk phase its arrival gave it).  Every blocking ``get``
and ``join`` has a deadline."""
import queue
import threading
import time

import numpy as np
import pytest
import torch

import jax

from test_torch_assets import jax_t2s
from test_torch_fused_step import SMALL
from test_torch_t2s import port_t2s
from test_torch_assets import one_torch_thread  # noqa: F401

GPT_CACHE = [(1, 128), (2, 128), (4, 128)]
TINY = dict(hidden_dim=64, embedding_dim=64, num_heads=4, num_layers=2, **SMALL)


@pytest.fixture(scope="module")
def engines():
    import jax.numpy as jnp

    from gsv_tts_tpu.runtime.t2s_session import T2SEngine as JEngine
    from gsv_tts_tpu_torch.runtime.t2s_session import T2SEngine

    cfg, jp = jax_t2s(0, **TINY)
    pcfg, pp = port_t2s(cfg, jp)
    jeng = JEngine(jp, cfg, gpt_cache=GPT_CACHE, dtype=jnp.float32, attn_impl="xla")
    peng = T2SEngine(pp, pcfg, gpt_cache=GPT_CACHE)
    return cfg, jeng, peng


def _inputs(seed, cfg):
    rng = np.random.RandomState(seed)
    x = rng.randint(1, 50, rng.randint(6, 12)).astype(np.int32)
    y = rng.randint(0, 100, rng.randint(4, 9)).astype(np.int32)
    bert = np.zeros((len(x), cfg.bert_dim), np.float32)
    return x, y, bert


def _drain(handle, timeout=60.0):
    toks = []
    deadline = time.time() + timeout
    while True:
        t, done = handle.get(timeout=max(0.1, deadline - time.time()))
        toks.append(t)
        if done:
            return np.concatenate(toks)


def _jax_solo(jeng, x, y, bert):
    """JAX's one-client reference: its engine's batched-stream harvest."""
    out = [t for _, t, _ in jeng.generate_batched_stream([x], [y], [bert], top_k=1,
                                                         rng=jax.random.PRNGKey(0))]
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def _assert_tokens_match(got, want, check_interval, msg=""):
    n = min(len(got), len(want))
    np.testing.assert_array_equal(got[:n], want[:n], err_msg=msg)
    assert abs(len(got) - len(want)) <= check_interval, f"{msg}: {len(got)} vs {len(want)}"


def _drain_tracking(sched, h, seen, key):
    """Drain a handle while reading the scheduler's counters (an idle wave is
    dropped, and its counters with it, as soon as its last slot ends)."""
    toks = []
    for t, done in h:
        toks.append(t)
        for w in sched.stats["waves"]:
            seen[key] = max(seen[key], w[key] if key != "share" else
                            max(w["refills"] + w["resizes"], w["live"] - 1))
        if done:
            break
    return np.concatenate(toks)


def _schedulers(engines, max_batch=4):
    from gsv_tts_tpu.runtime.wave import WaveScheduler as JaxScheduler
    from gsv_tts_tpu_torch.runtime.wave import WaveScheduler

    _, jeng, peng = engines
    return JaxScheduler(jeng, max_batch=max_batch), WaveScheduler(peng, max_batch=max_batch)


def test_single_client_matches_jax_scheduler_exactly(engines):
    cfg, jeng, _ = engines
    x, y, bert = _inputs(21, cfg)
    jsched, psched = _schedulers(engines)
    try:
        want = _drain(jsched.attach(x, y, bert, top_k=1))
        got = _drain(psched.attach(x, y, bert, top_k=1))
        totals = psched.stats["totals"]
    finally:
        jsched.close()
        psched.close()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax_solo(jeng, x, y, bert))
    assert got.size > 20 and cfg.eos not in got.tolist()
    # one slot: every step is the K1 twin's, and the totals add up
    assert totals["k1_steps"] == totals["decode_steps"] > 0 and totals["k2_steps"] == 0
    assert totals["tokens"] == got.size and totals["max_live"] == 1


def test_staggered_clients_share_one_wave(engines):
    cfg, jeng, _ = engines
    reqs = [_inputs(s, cfg) for s in (31, 32, 33, 34)]
    _, psched = _schedulers(engines)
    seen = {"share": 0}
    try:
        h0 = psched.attach(*reqs[0], top_k=1)
        first, done0 = h0.get(timeout=60.0)  # client 0 decodes before the others come
        handles = [psched.attach(*r, top_k=1) for r in reqs[1:]]
        gots = [first if done0 else np.concatenate([first, _drain_tracking(psched, h0, seen,
                                                                           "share")])]
        gots += [_drain_tracking(psched, h, seen, "share") for h in handles]
        totals = psched.stats["totals"]
    finally:
        psched.close()
    for i, (got, r) in enumerate(zip(gots, reqs)):
        _assert_tokens_match(got, _jax_solo(jeng, *r), jeng.check_interval, f"client {i}")
    assert seen["share"] >= 1, "no slot sharing happened"
    assert totals["k2_steps"] > 0 and totals["max_live"] >= 2


def test_cancel_compacts_wave_and_survivor_is_exact(engines):
    cfg, jeng, _ = engines
    reqs = [_inputs(s, cfg) for s in (41, 42, 43, 44)]
    _, psched = _schedulers(engines)
    try:
        handles = [psched.attach(*r, top_k=1) for r in reqs]
        first, done0 = handles[0].get(timeout=60.0)
        for h in handles[1:]:
            h.cancel()
        got = first if done0 else np.concatenate([first, _drain(handles[0])])
        deadline = time.time() + 30.0
        compacted = False
        while time.time() < deadline:
            stats = psched.stats
            if any(w["resizes"] >= 1 for w in stats["waves"]) or not stats["waves"]:
                compacted = True
                break
            time.sleep(0.05)
    finally:
        stats = psched.stats
        psched.close()
    _assert_tokens_match(got, _jax_solo(jeng, *reqs[0]), jeng.check_interval, "survivor")
    assert compacted, f"no compaction observed: {stats}"


def test_growth_from_single_to_full_wave(engines):
    cfg, jeng, _ = engines
    reqs = [_inputs(s, cfg) for s in (51, 52, 53, 54)]
    _, psched = _schedulers(engines)
    seen = {"batched_refills": 0, "share": 0}
    try:
        h0 = psched.attach(*reqs[0], top_k=1)
        first, done0 = h0.get(timeout=60.0)  # the wave is live at B=1
        handles = [psched.attach(*r, top_k=1) for r in reqs[1:]]  # a burst of three
        gots = [first if done0 else np.concatenate([first, _drain_tracking(psched, h0, seen,
                                                                           "share")])]
        gots += [_drain_tracking(psched, h, seen, "batched_refills") for h in handles]
        totals = psched.stats["totals"]
    finally:
        psched.close()
    for i, (got, r) in enumerate(zip(gots, reqs)):
        _assert_tokens_match(got, _jax_solo(jeng, *r), jeng.check_interval, f"client {i}")
    assert seen["share"] + seen["batched_refills"] >= 1, "no growth or refill observed"
    assert totals["max_live"] >= 2 and totals["k2_steps"] > 0 and totals["k1_steps"] > 0


def test_distinct_signatures_get_distinct_waves(engines):
    cfg, jeng, _ = engines
    x, y, bert = _inputs(61, cfg)
    jsched, psched = _schedulers(engines)
    try:
        h1 = psched.attach(x, y, bert, top_k=1)
        h2 = psched.attach(x, y, bert, top_k=5, temperature=0.9)
        assert len(psched.stats["waves"]) == 2
        g1, g2 = _drain(h1), _drain(h2)
        j1 = _drain(jsched.attach(x, y, bert, top_k=1))
    finally:
        jsched.close()
        psched.close()
    assert g1.size and g2.size
    np.testing.assert_array_equal(g1, j1)


@pytest.mark.parametrize("lx,ly,max_batch", [(100, 60, 4), (90, 40, 2)],
                         ids=["oversized", "padded-oversized"])
def test_attach_rejects_prompts_past_every_bucket(engines, lx, ly, max_batch):
    """A prompt whose padded ``[Lx|Ly]`` block exceeds every bucket (90 + 40
    pads to 96 + 64 = 160 > 128) is refused at attach, by both schedulers
    with the same message."""
    cfg = engines[0]
    rng = np.random.RandomState(0)
    x = rng.randint(1, 50, lx).astype(np.int32)
    y = rng.randint(0, 100, ly).astype(np.int32)
    bert = np.zeros((lx, cfg.bert_dim), np.float32)
    jsched, psched = _schedulers(engines, max_batch)
    try:
        with pytest.raises(ValueError, match="bucket") as perr:
            psched.attach(x, y, bert, top_k=1)
        with pytest.raises(ValueError) as jerr:
            jsched.attach(x, y, bert, top_k=1)
        assert str(perr.value) == str(jerr.value)
    finally:
        jsched.close()
        psched.close()


def test_close_fails_outstanding_handles(engines):
    cfg = engines[0]
    _, psched = _schedulers(engines)
    handles = [psched.attach(*_inputs(s, cfg), top_k=1) for s in (71, 72)]
    psched.close()
    assert not psched._thread.is_alive()
    for h in handles:
        with pytest.raises((RuntimeError, queue.Empty)):
            while True:
                _, done = h.get(timeout=5.0)
                if done:  # finished before close() landed: allowed once
                    break
            h.get(timeout=0.5)
    with pytest.raises(RuntimeError, match="closed"):
        psched.attach(*_inputs(73, cfg), top_k=1)


def test_max_clients_admission_and_release(engines):
    from gsv_tts_tpu_torch.runtime.wave import WaveOverloadedError, WaveScheduler

    sched = WaveScheduler(engines[2], max_batch=4, max_clients=2)
    free = WaveScheduler(engines[2], max_batch=4)
    try:
        sched.acquire_client()
        sched.acquire_client()
        assert sched.overloaded and sched.stats["clients"] == 2
        with pytest.raises(WaveOverloadedError):
            sched.acquire_client()
        sched.release_client()
        assert not sched.overloaded
        sched.acquire_client()  # admitted again after a release
        for _ in range(10):
            free.acquire_client()
        assert not free.overloaded
    finally:
        sched.close()
        free.close()


def test_failed_prefill_fails_popped_handles_not_hangs(engines, monkeypatch):
    from gsv_tts_tpu_torch.runtime import wave as wmod

    cfg, jeng, _ = engines

    def bad_prefill(*a, **k):
        raise RuntimeError("synthetic prefill failure")

    _, psched = _schedulers(engines, max_batch=2)
    try:
        monkeypatch.setattr(wmod, "prefill_batch", bad_prefill)
        h = psched.attach(*_inputs(21, cfg), top_k=1)
        with pytest.raises(RuntimeError, match="synthetic prefill"):
            h.get(timeout=30.0)
        monkeypatch.undo()
        # the scheduler survives and serves the next client
        x2, y2, b2 = _inputs(22, cfg)
        _assert_tokens_match(_drain(psched.attach(x2, y2, b2, top_k=1)),
                             _jax_solo(jeng, x2, y2, b2), jeng.check_interval)
    finally:
        psched.close()


def test_failed_refill_fails_popped_handles(engines, monkeypatch):
    """Client A keeps a one-slot wave alive; B's prefill fails: B's handle
    gets the error instead of hanging, A ends (finished or failed, never
    hung) and the scheduler serves the next client."""
    from gsv_tts_tpu_torch.runtime import t2s_session as tsmod
    from gsv_tts_tpu_torch.runtime import wave as wmod

    cfg = engines[0]
    _, psched = _schedulers(engines, max_batch=1)
    try:
        ha = psched.attach(*_inputs(31, cfg), top_k=1)
        ha_first = ha.get(timeout=60.0)

        def bad(*a, **k):
            raise RuntimeError("synthetic refill failure")

        for mod, name in ((tsmod, "prefill_slot"), (tsmod, "prefill_slots"),
                          (wmod, "prefill_batch")):
            monkeypatch.setattr(mod, name, bad)
        hb = psched.attach(*_inputs(32, cfg), top_k=1)
        with pytest.raises(RuntimeError, match="synthetic refill"):
            while True:
                _, done = hb.get(timeout=30.0)
                if done:
                    raise AssertionError("B finished through a broken prefill")
        monkeypatch.undo()
        if not ha_first[1]:
            try:
                _drain(ha, timeout=60.0)
            except RuntimeError:
                pass
        assert _drain(psched.attach(*_inputs(33, cfg), top_k=1)).size > 0
    finally:
        psched.close()


def test_scheduler_pumps_inside_the_gate(engines):
    """While a thread holds the gate exclusively (a SoVITS graph capture), the
    decode thread launches nothing: its pumps run in shared sections."""
    from gsv_tts_tpu_torch.runtime.wave import WaveScheduler
    from gsv_tts_tpu_torch.tts import DeviceGate

    cfg = engines[0]
    gate = DeviceGate()
    sched = WaveScheduler(engines[2], max_batch=4, gate=gate)
    try:
        with gate.exclusive():
            h = sched.attach(*_inputs(81, cfg), top_k=1)
            time.sleep(0.3)
            assert sched.stats["totals"]["decode_steps"] == 0
            with pytest.raises(queue.Empty):
                h.get(timeout=0.1)
        assert _drain(h).size > 0
    finally:
        sched.close()


def test_device_gate_excludes_shared_sections():
    """Stress: eight threads in nested shared sections and two in exclusive
    ones (a shortened switch interval); an exclusive section never overlaps a
    shared one, and every thread finishes within its deadline."""
    import sys

    from gsv_tts_tpu_torch.tts import DeviceGate

    gate = DeviceGate()
    state = {"shared": 0, "exclusive": 0, "bad": 0}
    lock = threading.Lock()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def reader():
        for _ in range(200):
            with gate.shared():
                with lock:
                    state["shared"] += 1
                    state["bad"] += state["exclusive"] > 0
                with gate.shared():  # nested: passes a waiting writer
                    pass
                with lock:
                    state["shared"] -= 1

    wlock = threading.Lock()  # one writer at a time, as SovitsGraphs' lock makes it

    def locked_writer():
        for _ in range(50):
            with wlock:
                with gate.exclusive():
                    with lock:
                        state["exclusive"] += 1
                        state["bad"] += state["shared"] > 0
                    time.sleep(1e-4)
                    with lock:
                        state["exclusive"] -= 1

    try:
        threads = ([threading.Thread(target=reader) for _ in range(8)]
                   + [threading.Thread(target=locked_writer) for _ in range(2)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert state == {"shared": 0, "exclusive": 0, "bad": 0}
    # a second thread going exclusive at once is refused, not queued
    with gate.exclusive():
        t = threading.Thread(target=lambda: state.update(err=_second_writer(gate)))
        t.start()
        t.join(timeout=10.0)
    assert state["err"] == "DeviceGate.exclusive entered twice"


def _second_writer(gate):
    try:
        with gate.exclusive():
            return None
    except RuntimeError as exc:
        return str(exc)
