"""The window's arithmetic on synthetic spans."""

from types import SimpleNamespace

import pytest

from lorabench import stats
from lorabench.metrics import fsm_front_ms, fsm_graph_ms


def test_rate_over_the_whole_window():
    # 10 feeds of 64 channels x 2^20 samples in 20 s at 250 ksps.
    assert stats.channels_realtime(64, 1 << 20, 10, 20.0, 250e3) == \
        pytest.approx(64 * (1 << 20) * 10 / 20.0 / 250e3)


def test_idle_is_one_minus_the_union_of_busy_spans():
    spans = [(0, 10), (5, 15), (20, 30), (29, 31), (40, 40)]
    assert stats.merge_intervals(spans) == [(0, 15), (20, 31)]
    busy = sum(e - s for s, e in stats.merge_intervals(spans))
    assert busy == 26 and 1 - busy / 100 == pytest.approx(0.74)


def test_fsm_readers_split_the_device_time_a_feed():
    trace = SimpleNamespace(device_time=lambda: 3.0, graph_time=lambda: 2.5)
    run = SimpleNamespace(trace=trace, feed_s=[1.0, 1.2])
    assert fsm_graph_ms.read(run) == pytest.approx(1250.0)
    assert fsm_front_ms.read(run) == pytest.approx(250.0)
    untraced = SimpleNamespace(trace=None, feed_s=[1.0])
    assert fsm_graph_ms.read(untraced) is None
    assert fsm_front_ms.read(untraced) is None
