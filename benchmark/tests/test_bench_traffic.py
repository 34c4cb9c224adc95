"""The traffic generator: the same seed gives the same schedule."""
import numpy as np

from harness import stats, traffic


def test_schedule_repeats_for_a_seed():
    for name in ("closed_infer", "newvoice", "open_shared_stream"):
        mix = traffic.load_mix(name)
        a = traffic.schedule(mix, 4000000123, n=50)
        b = traffic.schedule(mix, 4000000123, n=50)
        c = traffic.schedule(mix, 4000000124, n=50)
        assert a == b
        assert [r.text for r in a] != [r.text for r in c]
        assert traffic.voices(mix) == traffic.voices(mix)
        assert np.array_equal(traffic.clip_rng().randn(8), traffic.clip_rng().randn(8))


def test_every_seed_gets_the_same_work():
    mix = traffic.load_mix("newvoice")
    lo, hi = mix["words"]
    pool = traffic.text_pool(mix)
    assert all(lo <= len(t.split()) <= hi for t in pool)
    full = traffic.schedule(mix, 9, n=mix["text_pool"])
    # a full pass holds each text once, and a text always comes with the same
    # voice, greedy flag and sampling seed, whatever the seed
    assert sorted(r.text for r in full) == sorted(pool)
    assert sum(r.greedy for r in full) == mix["text_pool"] // mix["greedy_every"]
    again = {r.text: (r.voice, r.greedy, r.sample_seed)
             for r in traffic.schedule(mix, 3000000017, n=mix["text_pool"])}
    assert all(again[r.text] == (r.voice, r.greedy, r.sample_seed) for r in full)
    # every voice brings greedy texts, so every voice is judged
    assert {r.voice for r in full if r.greedy} == set(range(mix["voices"]["count"]))


def test_nearest_rank_percentile_and_spread():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 90) == 90
    assert stats.percentile(vals, 95) == 95
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([3, 1, 2], 50) == 2
    assert abs(stats.spread([1, 2, 3, 4, 5, 6]) - (5.25 - 1.75) / 3.5) < 1e-12


def test_stream_lead_accounting():
    # chunks of 1 s audio arriving every 0.5 s: never underrun, lead grows
    lead, smooth = stats.lead_and_underrun([(0.1, 1.0), (0.6, 1.0), (1.1, 1.0)])
    assert smooth and abs(lead - 0.0) < 1e-9
    # the second chunk comes after the first has played out
    lead, smooth = stats.lead_and_underrun([(0.1, 0.5), (0.9, 0.5)])
    assert not smooth and abs(lead + 0.3) < 1e-9
