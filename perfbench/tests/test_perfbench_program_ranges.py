"""The readers of the program's own ranges in the device trace
(``perfbench/lib/ranges.py``): ``prefill_launch_ms``,
``decode_launch_ms``, ``idle_launching``, ``idle_uploading`` and
``idle_in_runtime``, each over a hand-built profile whose answers are
worked out by hand."""
import random
import types

import numpy as np
import pytest

from perfbench.lib import cells, ranges
from perfbench.lib.profile import DeviceOp, Profile
from perfbench.lib.window import Record

READERS = ["prefill_launch_ms", "decode_launch_ms", "idle_launching",
           "idle_uploading", "idle_in_runtime"]

#: host ranges of the traced part [0, 10]: a dispatch for request A
#: (sent 0.5, done 4.0) and one for request B (sent 8.0, not done by the
#: window's close) that runs past the close, a decode step cut by the
#: window's start, and host ops that are not the program's
HOST = [
    ("step@n:yi_9b_decode", -0.5, 0.3),
    ("exec@n", 0.8, 3.5),
    ("upload@n", 0.9, 1.1),
    ("step@n:yi_9b_prefill", 1.1, 2.0),
    ("aten::mm", 1.2, 1.3),
    ("cudaLaunchKernel", 1.25, 1.26),
    ("step@n:yi_9b_decode", 2.0, 3.0),
    ("step@n:yi_9b_decode", 3.0, 3.4),
    ("exec@n", 8.5, 10.5),
    ("upload@n", 8.5, 8.6),
    ("step@n:yi_9b_prefill", 8.6, 9.2),
    ("step@n:yi_9b_decode", 9.2, 10.2),
]
KERNELS = [(1.0, 1.5), (2.5, 3.0), (6.0, 6.5), (9.0, 9.1)]

#: by hand: idle gaps [0,1] [1.5,2.5] [3,6] [6.5,9] [9.1,10] (8.4 s);
#: launching 0.3+1.0+0.4+0.4+0.9, uploading 0.1+0.1, in runtime (A's
#: wait before and after its dispatch, B's before) 0.3+0.5+0.5
WANT = {"prefill_launch_ms": (900.0 + 600.0) / 2,
        "decode_launch_ms": (1000.0 + 400.0) / 2,
        "idle_launching": 30.0, "idle_uploading": 2.0,
        "idle_in_runtime": 13.0}
DEVICE_IDLE = 84.0


def _profile(host=HOST, kernels=KERNELS):
    return Profile(0.0, 10.0,
                   [DeviceOp("k", a, b, None) for a, b in kernels], [], 0,
                   [h[0] for h in host],
                   np.array([h[1] for h in host], dtype=np.float64),
                   np.array([h[2] for h in host], dtype=np.float64), [])


def _ctx(profile):
    return types.SimpleNamespace(
        profile=profile, records=[Record(0, 0.5, sent=0.5, done=4.0),
                                  Record(1, 8.0, sent=8.0),
                                  Record(2, 11.0)])


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_hand_worked_value(name):
    got = cells.reader(name).read(_ctx(_profile()))
    assert got == pytest.approx(WANT[name])


def test_idle_shares_are_disjoint_and_sum_to_device_idle():
    p = _profile()
    ctx = _ctx(p)
    split = ranges.idle_split(ctx)
    assert split["rest"] == pytest.approx(39.0)
    assert sum(split.values()) == pytest.approx(
        cells.reader("device_idle").read(ctx)) == pytest.approx(DEVICE_IDLE)
    shares = [cells.reader(n).read(ctx) for n in READERS[2:]]
    assert sum(shares) <= DEVICE_IDLE
    # each share's intervals, rebuilt, overlap no other's
    r = ranges.program(p)
    s, u, e = (ranges.union(((a, b) for _, a, b in r[k]), 0.0, 10.0)
               for k in ("step", "upload", "exec"))
    o = ranges.union([(0.5, 4.0), (8.0, 10.0)], 0.0, 10.0)
    g = p.gaps()
    parts = [ranges.intersect(g, s),
             ranges.intersect(g, ranges.minus(u, s)),
             ranges.intersect(g, ranges.minus(ranges.minus(o, e),
                                               ranges.union(s + u, 0, 10)))]
    for i in range(3):
        for j in range(i + 1, 3):
            assert ranges.length(ranges.intersect(parts[i], parts[j])) == 0


def test_ranges_cut_by_the_window_are_left_out_of_the_means():
    cut = [h for h in HOST if h[1] < 0.0 or h[2] > 10.0]
    assert len(cut) == 3
    ctx = _ctx(_profile(host=cut))
    assert cells.reader("decode_launch_ms").read(ctx) is None
    assert cells.reader("prefill_launch_ms").read(ctx) is None
    # a cut range still counts toward the idle shares, clipped: gaps
    # [0, 1] and [9.1, 10] under steps [0, 0.3] and [9.2, 10]
    assert cells.reader("idle_launching").read(ctx) == pytest.approx(
        (0.3 + 0.8) * 10)


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_without_program_ranges(name, monkeypatch):
    """A program without the scopes (a parent commit) gives nothing to
    read, and neither does a run without a device trace."""
    monkeypatch.setattr(ranges, "program_has_scopes", lambda: False)
    other = [h for h in HOST if "@" not in h[0]]
    assert cells.reader(name).read(_ctx(_profile(host=other))) is None
    assert cells.reader(name).read(_ctx(None)) is None


def test_idle_shares_of_a_traced_part_with_no_dispatch():
    """This program opens the ranges; where the traced part held none of
    its dispatches no range was open: the card's idle time while requests
    were outstanding is the runtime's, [0.5, 1] [1.5, 2.5] [3, 4] [8, 9]
    [9.1, 10], and the means have nothing to read."""
    assert ranges.program_has_scopes()
    ctx = _ctx(_profile(host=[h for h in HOST if "@" not in h[0]]))
    got = {n: cells.reader(n).read(ctx) for n in READERS}
    assert got["prefill_launch_ms"] is None
    assert got["decode_launch_ms"] is None
    assert got["idle_launching"] == 0 and got["idle_uploading"] == 0
    assert got["idle_in_runtime"] == pytest.approx(44.0)


def test_interval_algebra_against_unit_cells():
    rng = random.Random(7)

    def draw():
        out = []
        for _ in range(rng.randrange(0, 6)):
            a = rng.randrange(0, 40)
            out.append((a, a + rng.randrange(1, 8)))
        return out

    def cells_of(ivs):
        return {c for a, b in ivs for c in range(a, b)}
    for _ in range(200):
        x, y = draw(), draw()
        ux, uy = ranges.union(x, 0, 40), ranges.union(y, 0, 40)
        cx, cy = cells_of(ux), cells_of(uy)
        assert cx == {c for c in cells_of(x) if c < 40}
        assert ranges.length(ux) == len(cx)
        assert cells_of(ranges.intersect(ux, uy)) == cx & cy
        assert ranges.length(ranges.intersect(ux, uy)) == len(cx & cy)
        assert cells_of(ranges.minus(ux, uy)) == cx - cy
        assert ranges.length(ranges.minus(ux, uy)) == len(cx - cy)
