"""Model FLOPs completed in the traced window over the window times the
H100's bf16 peak (989 TFLOP/s), in %. Model FLOPs: the reference's matrix
products and convolutions counted by FlopCounterMode at each span's shape
(portbench/work.py): a served dispatch's real images, a sample call, a
train step (the backward as twice the forward). A span cut by the window's
end counts by the share of its work done in the window (trace.done_share)."""
from portbench import work


def span_flops(run, name, meta, counters):
    cfg = run.cfg
    if name == "sample":
        return work.sample_call_flops(cfg, meta["batch"], counters["guided"])
    if name == "step":
        return work.train_step_flops(cfg, counters["batch"])
    return 0


def read(run, out, rest):
    tr = out.trace
    if tr is None or not tr.spans:
        return None
    total = 0.0
    real = iter(out.counters.get("dispatches", []))
    for name, meta, a, b in tr.spans:
        share = tr.done_share(name, meta, a, b)
        if name == "dispatch":
            bucket, n_real = next(real)
            f = work.sample_call_flops(run.cfg, bucket, False) * n_real / bucket
        else:
            f = span_flops(run, name, meta, out.counters)
        total += share * f
    return 100.0 * total / (tr.window_s * work.PEAK_BF16_FLOPS)
