"""95th percentile (linear between ranks, as serve_p95_ms) of the served
requests' queue waits, from submit to the dispatch that took them: the
program's serve.queue spans of the requests dispatched inside the traced
window, in ms."""
import numpy as np

from portbench import program_spans


def read(run, out, rest):
    win = program_spans.window(out)
    if win is None:
        return None
    ms = [(s.end_ns - s.start_ns) / 1e6 for s in win.named("serve.queue")
          if win.lo <= s.end_ns < win.hi]
    return float(np.percentile(np.asarray(ms, dtype=np.float64), 95)) if ms else None
