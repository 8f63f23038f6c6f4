"""The traffic generator: deterministic in the seed, different across seeds,
within each mix's stated ranges and buckets."""

import numpy as np
import pytest

from benchmark import run, traffic

BUCKETS = (256, 512, 768, 1024, 1536, 2048, 3072, 4096)
SEEDS = (7, 2**31 + 11)


def mix(name):
    return run.Bench().mix(name)


def bucket(n):
    return next(b for b in BUCKETS if n <= b)


@pytest.mark.parametrize("name", ["offline_nfe32"])
def test_requests_are_deterministic_in_the_seed(name):
    m = mix(name)
    a, b = traffic.requests(m, SEEDS[1], 40), traffic.requests(m, SEEDS[1], 40)
    for x, y in zip(a, b):
        assert np.array_equal(x.ref_wav, y.ref_wav) and np.array_equal(x.text_ids, y.text_ids)
        assert (x.duration, x.seed) == (y.duration, y.seed)
    c = traffic.requests(m, SEEDS[0], 40)
    assert any(not np.array_equal(x.text_ids, z.text_ids) for x, z in zip(a, c))
    assert [x.seed for x in a] != [z.seed for z in c]


@pytest.mark.parametrize("name", ["offline_nfe32"])
def test_requests_keep_their_ranges_and_buckets(name):
    m = mix(name)
    reqs = traffic.requests(m, SEEDS[0], 300)
    lo, hi = m["ref_s"]
    for r in reqs:
        assert lo * traffic.SAMPLE_RATE <= len(r.ref_wav) <= hi * traffic.SAMPLE_RATE
        assert m["gen_s"]["clip"][0] <= r.gen_s <= m["gen_s"]["clip"][1]
        assert r.duration <= m["max_total_frames"]
        assert 0 <= r.text_ids.min() and r.text_ids.max() < traffic.VOCAB
        assert np.abs(r.ref_wav).max() <= 1.0
        assert np.array_equal(np.round(r.ref_wav * 32767), r.ref_wav * 32767)  # int16 steps
    got = {bucket(r.duration) for r in reqs}
    assert got <= {512, 768, 1024, 1536, 2048}
    assert {1024, 1536, 2048} <= got


def test_every_seed_gets_the_same_sizes():
    m = mix("offline_nfe32")
    a, b = traffic.requests(m, SEEDS[0], 64), traffic.requests(m, SEEDS[1], 64)
    assert sorted(r.duration for r in a) == sorted(r.duration for r in b)
    a, b = (traffic.requests(m, s, m["pool"], block=m["chunk"]) for s in SEEDS)
    for k in range(0, m["pool"], m["chunk"]):  # each chunk: the same sizes, another order
        ka, kb = a[k:k + m["chunk"]], b[k:k + m["chunk"]]
        assert sorted(r.duration for r in ka) == sorted(r.duration for r in kb)
        assert [r.duration for r in ka] != [r.duration for r in kb]


def test_duration_follows_the_byte_ratio_rule():
    assert traffic.estimate_duration(300, 40, 80) == 300 + int(300 / 40 * 80)
    assert traffic.estimate_duration(300, 40, 5) == 300 + int(300 / 40 * 5 / 0.3)


def test_training_pool_is_deterministic_and_in_range():
    m = mix("train_38k")
    bank, pool = traffic.utterances(m, SEEDS[1])
    bank2, pool2 = traffic.utterances(m, SEEDS[1])
    assert np.array_equal(bank, bank2)
    assert [(u.clip, u.start, u.samples) for u in pool] == [(u.clip, u.start, u.samples) for u in pool2]
    lo, hi = m["utt_s"]["clip"]
    for u in pool:
        assert lo * traffic.SAMPLE_RATE - 1 <= u.samples <= hi * traffic.SAMPLE_RATE
        assert len(traffic.utterance_wav(bank, u)) == u.samples
    frames = sum(u.samples for u in pool) / traffic.HOP
    assert frames >= 40 * m["frames_threshold"]  # at least 40 distinct batches per epoch
    _, other = traffic.utterances(m, SEEDS[0])
    assert sorted(u.samples for u in pool) == sorted(u.samples for u in other)
    assert [u.start for u in pool] != [u.start for u in other]
