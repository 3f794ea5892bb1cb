"""Model FLOPs completed in the traced window of a DiT cell over the
window times the H100's bf16 peak (989 TFLOP/s), in %. Model FLOPs: the
DiT reference's matrix products and convolutions counted by
FlopCounterMode at each sample span's batch (portbench/work_dit.py: both
CFG forwards of every step, and the decoder). A span cut by the window's
end counts by the share of its work done in the window
(trace.done_share)."""
from portbench import work, work_dit


def read(run, out, rest):
    tr = out.trace
    if tr is None or "dit" not in run.cfg:
        return None
    total = 0.0
    for name, meta, a, b in tr.spans:
        if name == "sample":
            total += tr.done_share(name, meta, a, b) * work_dit.sample_call_flops(
                run.cfg, meta["batch"], out.counters["guided"])
    if total == 0.0:
        return None
    return 100.0 * total / (tr.window_s * work.PEAK_BF16_FLOPS)
