"""fsm_front_ms: device time a feed of everything that CUDA graph replays
did not launch: the feed's upload, the preamble scan of every SF and the
event slices that the FSM reads."""


def read(run):
    if run.trace is None:
        return None
    front = run.trace.device_time() - run.trace.graph_time()
    return front / len(run.feed_s) * 1e3 if front > 0 else None
