"""The device's idle time while the thread that launches its work was
inside a program span, in % of the traced window: idle_in_pct.<span>.<cell>
with <span> step (pipeline.step: a sampler step, its UNet calls included)
or take (serve.take: the serving worker waiting for or assembling a
group)."""
from portbench import program_spans

SPANS = {"step": "pipeline.step", "take": "serve.take"}


def read(run, out, rest):
    win = program_spans.window(out)
    if win is None or not rest or rest[0] not in SPANS:
        return None
    name = SPANS[rest[0]]
    if not any(s.name == name for s in win.on_thread()):
        return None
    return 100.0 * program_spans.idle_inside(win, name) / (win.hi - win.lo)
