"""The traffic generator: the same seed gives the same requests; seeds
differ in order and content only, never in the sizes of the work."""

import numpy as np
import pytest

from portbench import traffic


@pytest.mark.parametrize("mix", ["serve_queue64", "stream_live60s"])
def test_requests_repeat_by_seed_and_keep_their_sizes(mix):
    m = dict(traffic.load_mix(mix), pool=2)
    a = traffic.requests(m, 2 ** 31 + 11)
    b = traffic.requests(m, 2 ** 31 + 11)
    c = traffic.requests(m, 7)
    for x, y in zip(a, b):
        assert all(np.array_equal(p, q) for p, q in zip(x.clips, y.clips))
    sizes = lambda reqs: sorted(len(clip) for r in reqs for clip in r.clips)  # noqa: E731
    assert sizes(a) == sizes(c)
    assert any(not np.array_equal(p, q) for x, y in zip(a, c) for p, q in zip(x.clips, y.clips))


def test_sizes_follow_their_distribution():
    s = traffic.sizes({"dist": "lognormal", "median": 6.0, "sigma": 0.6, "min": 2.0,
                       "max": 16.0}, 64)
    assert len(s) == 64 and s == sorted(s)
    assert 2.0 <= s[0] and s[-1] <= 16.0
    assert abs(float(np.median(s)) - 6.0) < 0.3
    u = traffic.sizes({"dist": "uniform", "min": 4.0, "max": 20.0}, 16)
    assert u[0] == 4.5 and u[-1] == 19.5
    assert traffic.sizes({"dist": "fixed", "value": 60.0}, 3) == [60.0] * 3
