"""fsm_graph_ms: device time a feed of the kernels that CUDA graph
replays launched (the FSM step's captured graphs)."""


def read(run):
    if run.trace is None:
        return None
    busy = run.trace.graph_time()
    return busy / len(run.feed_s) * 1e3 if busy > 0 else None
