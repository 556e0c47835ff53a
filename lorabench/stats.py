"""The window's arithmetic: every statistic is over the whole window."""

from __future__ import annotations


def merge_intervals(spans) -> list:
    """The union of [start, end) intervals as sorted, disjoint ones."""
    out = []
    for s, e in sorted(spans):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def channels_realtime(channels: int, samples_per_feed: int, feeds: int,
                      window_s: float, sample_rate: float) -> float:
    """Channels kept in real time: channel-samples completed in the window
    over its seconds, over one channel's sample rate."""
    return channels * samples_per_feed * feeds / window_s / sample_rate
