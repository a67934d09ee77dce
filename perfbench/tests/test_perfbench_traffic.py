"""The generator: the same seed gives the same requests; every seed the
same work in another order."""
import math

import pytest

from perfbench.lib import traffic

SEED = 2 ** 31 + 12345


def test_open_arrivals_repeat_from_the_seed():
    a = traffic.open_arrivals(200, 50.0, SEED)
    assert a == traffic.open_arrivals(200, 50.0, SEED)
    assert a != traffic.open_arrivals(200, 50.0, SEED + 1)


def test_every_seed_the_same_gaps_in_another_order():
    a = traffic.open_arrivals(120, 30.0, 1)
    b = traffic.open_arrivals(120, 30.0, 2)
    ga = sorted(y - x for x, y in zip(a, a[1:]))
    gb = sorted(y - x for x, y in zip(b, b[1:]))
    assert ga == pytest.approx(gb, abs=1e-12)
    assert a[0] == 0.0 and a[-1] == pytest.approx(30.0 * 119 / 120)
    assert all(y > x for x, y in zip(a, a[1:]))
    # the largest gap comes last for every seed; the rest are shuffled
    assert a[-1] - a[-2] == b[-1] - b[-2] == ga[-1]
    assert a[:-1] != b[:-1]


def test_gaps_are_exponential_quantiles():
    n = 1001
    a = traffic.open_arrivals(n, 100.0, 3)
    gaps = sorted(y - x for x, y in zip(a, a[1:]))
    mean = sum(gaps) / len(gaps)
    # the median of an exponential is ln 2 of its mean
    assert gaps[len(gaps) // 2] / mean == pytest.approx(math.log(2), 1e-2)


def test_request_count():
    mix = {"loop": "open"}
    assert traffic.request_count(mix, 4.0, 50.0) == 200
    assert traffic.request_count(mix, 0.01, 10.0) == 2
    with pytest.raises(ValueError):
        traffic.request_count({"loop": "closed"}, 1.0, 1.0)


def test_prompts_repeat_from_the_seed():
    p = traffic.prompts([16, 32], 512, SEED)
    q = traffic.prompts([16, 32], 512, SEED)
    assert all((x == y).all() for x, y in zip(p, q))
    assert [len(x) for x in p] == [16, 32]
    assert all(int(x.min()) >= 0 and int(x.max()) < 512 for x in p)
    r = traffic.prompts([16, 32], 512, SEED + 1)
    assert not (p[0] == r[0]).all()


def test_prompt_lengths():
    assert traffic.prompt_lengths(256, 3, 1) == [256] * 3
    spec = {"values": [64, 1024], "shares": [0.75, 0.25]}
    a = traffic.prompt_lengths(spec, 100, 1)
    assert sorted(a) == [64] * 75 + [1024] * 25
    assert a == traffic.prompt_lengths(spec, 100, 1)
    assert sorted(traffic.prompt_lengths(spec, 100, 2)) == sorted(a)
    assert traffic.distinct_lengths(spec) == [64, 1024]


def test_sample():
    assert traffic.sample(10, 20, 1) == list(range(10))
    s = traffic.sample(100, 8, SEED)
    assert s == traffic.sample(100, 8, SEED) and len(set(s)) == 8
    assert s == sorted(s)
