"""The DiT's global attention against its roofline over the traced
window, in %: roofline_pct.dit_attention.<suffix>. The sum over its calls
of the least time an H100 needs for each (portbench/work_dit.py: the
larger of 4 rows heads tokens^2 head_dim FLOPs at 989 TFLOP/s and q, k, v,
o in bf16 at 3.35 TB/s) over the device time of the attention kernels
(F.scaled_dot_product_attention's, found by name) inside the benchmark's
sample spans that the window did not cut.

The calls' shapes come from the program's dit.attention spans (rows,
tokens, heads, head_dim) inside a pipeline.sample span that lies wholly
in the window; every such sample call must have made the same calls, and
every counted sample span must hold as many attention kernels as that
call made attention calls. Otherwise, or where the program records no
such span, None."""
from portbench import program_spans, work_dit

# name parts of the forward kernels of PyTorch's attention back ends:
# FlashAttention-2, the memory-efficient (CUTLASS) kernel and cuDNN's
KERNELS = ("flash_fwd", "fmha_cutlassF", "_sdpa_")


def call_shapes(win):
    """[(rows, tokens, heads, head_dim)] of one sample call's attention
    calls, in order, or None (no whole call, or calls that differ)."""
    whole = {s.id: [] for s in win.whole("pipeline.sample")}
    for s in win.named("dit.attention"):
        owner = win.ancestor(s, ("pipeline.sample",))
        if owner is not None and owner.id in whole:
            whole[owner.id].append((s.attrs["rows"], s.attrs["tokens"], s.attrs["heads"],
                                    s.attrs["head_dim"]))
    shapes = [v for v in whole.values() if v]
    if not shapes or any(v != shapes[0] for v in shapes):
        return None
    return shapes[0]


def read(run, out, rest):
    win = program_spans.window(out)
    if win is None:
        return None
    shapes = call_shapes(win)
    if shapes is None:
        return None
    tr = out.trace
    bound_one = sum(work_dit.attention_bound_s(*s) for s in shapes)
    bound = busy = 0.0
    for name, meta, a, b in tr.spans:
        if name != "sample" or meta.get("cut"):
            continue
        times = [dur for _, dur, op in tr.ops_in(a, b) if any(k in op for k in KERNELS)]
        if len(times) != len(shapes):
            return None
        bound += bound_one
        busy += sum(times) / 1e9
    if busy == 0.0:
        return None
    return 100.0 * bound / busy
