"""The generator: deterministic in the seed, equal shares of take lengths."""

import numpy as np
import pytest

from benchmark.harness import spec as spec_mod
from benchmark.harness.traffic import Traffic

SPEC = spec_mod.load_spec()
CFG = spec_mod.config(SPEC, "resynth_64v")


def _same(a, b):
    return (a["n"] == b["n"] and np.array_equal(a["carrier"], b["carrier"])
            and all(np.array_equal(a["voices"][k], b["voices"][k]) for k in a["voices"]))


# the mixes that harness/traffic.py generates: those of the offline chain's cells
MIXES = [w["traffic"] for w in SPEC["workloads"]
         if spec_mod.config(SPEC, w["config"])["driver"] == "offline_chain"]


@pytest.mark.parametrize("traffic", MIXES)
def test_same_seed_same_jobs(traffic):
    data = spec_mod.traffic(traffic)
    seed = 2**31 + 12345
    a, b = Traffic(data, CFG, seed), Traffic(data, CFG, seed)
    assert a.batch >= 1
    for i in (0, 1, 7, 40):
        assert _same(a.job(i), b.job(i))
    assert not _same(a.job(0), a.job(1))
    orders = {tuple(Traffic(data, CFG, s).take_of(i) for i in range(data["shuffle_block"]))
              for s in range(seed, seed + 6)}
    assert len(orders) > 1


@pytest.mark.parametrize("traffic", MIXES)
def test_every_seed_sends_the_same_takes(traffic):
    """Each block of shuffle_block takes is sent whole by every seed, in the
    seed's order; no take repeats."""
    data = spec_mod.traffic(traffic)
    K = data["shuffle_block"]
    for seed in (1, 2**31 + 5):
        t = Traffic(data, CFG, seed)
        takes = [t.take_of(i) for i in range(5 * K)]
        assert sorted(takes) == list(range(5 * K))
        assert all(sorted(takes[b * K:(b + 1) * K]) == list(range(b * K, (b + 1) * K))
                   for b in range(5))
    a, b = Traffic(data, CFG, 3), Traffic(data, CFG, 4)
    ja = a.job(next(i for i in range(K) if a.take_of(i) == 2))
    jb = b.job(next(i for i in range(K) if b.take_of(i) == 2))
    assert _same(ja, jb)


def test_clips_lengths_in_equal_shares():
    data = spec_mod.traffic("clips_2-8s")
    t = Traffic(data, CFG, 99)
    for block in range(5):
        assert sorted(t.take_seconds(4 * block + j) for j in range(4)) == [2.0, 4.0, 6.0, 8.0]
    K = data["shuffle_block"]
    for b in range(3):
        got = sorted(t.job(b * K + j)["seconds"] for j in range(K))
        assert got == sorted([2.0, 4.0, 6.0, 8.0] * (K // 4))


def test_warm_up_takes_are_outside_the_sequence():
    t = Traffic(spec_mod.traffic("single_60s"), CFG, 5)
    warm = t.warm_jobs()
    assert len(warm) == 1
    assert not any(_same(warm[0], t.job(i)) for i in range(8))


def test_voices_follow_the_headline_generator():
    job = Traffic(spec_mod.traffic("single_60s"), CFG, 5).job(3)
    v, n, sr = job["voices"], job["n"], CFG["sample_rate"]
    assert n == 60 * sr and len(v["press"]) == 64
    assert (v["press"] >= 0).all() and (v["press"] < n / 2).all()
    assert (v["release"] - v["press"] >= sr - 1).all()
    f = v["increment"] * sr / 2
    assert (f >= 55).all() and (f <= 3520).all()
    np.testing.assert_allclose((v["gains"] ** 2).sum(axis=1), 1.0)
