"""The traffic draws: the same seed gives the same requests, every seed
the same sizes in another order, and an open loop's arrivals are as
bursty as a Poisson process held to its count in the window."""

import json
from pathlib import Path

import numpy as np
import pytest

from perfbench import traffic

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
NAMES = sorted(p.stem for p in TRAFFIC.glob("*.json"))
SECONDS = 50.0


@pytest.mark.parametrize("name", NAMES)
def test_same_seed_same_requests(name):
    params = traffic.load(TRAFFIC / f"{name}.json")
    a = traffic.Traffic(params, 2**31 + 12345, 32768, SECONDS)
    b = traffic.Traffic(params, 2**31 + 12345, 32768, SECONDS)
    for i in range(0, 70, 7):
        assert a.request(i) == b.request(i)
    c = traffic.Traffic(params, 2**31 + 12346, 32768, SECONDS)
    assert [c.request(i).tokens for i in range(3)] != \
        [a.request(i).tokens for i in range(3)]


@pytest.mark.parametrize("name", NAMES)
def test_blocks_hold_the_same_sizes_for_every_seed(name):
    """Each segment (an open loop's window, a closed loop's population)
    holds the same sizes and gaps for every seed, in another order."""
    params = traffic.load(TRAFFIC / f"{name}.json")
    segs, orders = [], []
    for seed in (1, 2, 3**30):
        t = traffic.Traffic(params, seed, 32768, SECONDS)
        k = t.k
        sizes = [t.sizes(i) for i in range(k, 2 * k)]
        segs.append((sorted(s[:2] for s in sizes),
                     sorted(s[2] for s in sizes)))
        orders.append([s[0] for s in sizes])
        for p, o, g in sizes:
            assert params["prompt"].get("min", 1) <= p
            assert p <= params["prompt"].get("max", p)
            assert 1 <= o and p + o <= params["max_total"]
            assert p + o < params["max_len"]
    assert segs[0] == segs[1] == segs[2]
    assert orders[0] != orders[1]
    if params["loop"] == "open":
        rate = params["arrivals"]["rate_rps"]
        assert k == round(rate * SECONDS)
        t = traffic.Traffic(params, 5, 32768, SECONDS)
        assert t.due(k - 1) == pytest.approx(SECONDS, rel=1e-9)
        assert t.due(2 * k - 1) == pytest.approx(2 * SECONDS, rel=1e-9)


def test_open_loop_arrivals_are_poisson_bursty():
    """Counts of arrivals in 5 s bins of the window spread as a Poisson
    process's do (variance about the mean), not as a smoothed one's."""
    params = dict(traffic.load(TRAFFIC / "chat.json"))
    rate = params["arrivals"]["rate_rps"]
    ratios = []
    for seed in range(8):
        t = traffic.Traffic(params, 2**40 + seed, 32768, SECONDS)
        due = np.array([t.due(i) for i in range(t.k)])
        # the window's last request is due at its close
        counts = np.histogram(due, bins=10,
                              range=(0, SECONDS * (1 + 1e-9)))[0]
        ratios.append(counts.var() / counts.mean())
    assert counts.sum() == round(rate * SECONDS)
    assert 0.5 < float(np.mean(ratios)) < 1.5


def test_lengths_follow_the_distribution_and_clip():
    rng = np.random.default_rng(0)
    q = traffic.lengths({"dist": "lognormal", "median": 1020, "sigma": 0.8,
                         "min": 128, "max": 3584}, 20001, rng)
    assert q.min() >= 128 and q.max() <= 3584
    assert abs(np.median(q) - 1020) < 40
    u = traffic.lengths({"dist": "uniform", "min": 512, "max": 2048},
                        20001, rng)
    assert u.min() == 512 and u.max() == 2048
    assert list(traffic.lengths({"dist": "fixed", "value": 16}, 3, rng)) \
        == [16, 16, 16]


def test_tokens_inside_the_vocabulary():
    params = json.loads((TRAFFIC / "chat.json").read_text())
    t = traffic.Traffic(params, 9, 1000, SECONDS)
    toks = np.array(t.request(3).tokens)
    assert toks.min() >= 0 and toks.max() < 1000
