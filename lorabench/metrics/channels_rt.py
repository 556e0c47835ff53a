"""channels_rt: channels kept in real time, over the whole window."""

from ..stats import channels_realtime


def read(run):
    return channels_realtime(run.channels, run.samples_per_feed,
                             len(run.feed_s), run.window_s, run.sample_rate)
