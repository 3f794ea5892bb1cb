"""A kernel's share of its roofline over the traced window, in %:
the sum over its calls of the least time an H100 needs for the call's
work (portbench/work.py, bf16, at the call's shape) over the sum of the
device time of its launches. The metric's name gives the kernel:
roofline_pct.<kernel>.<suffix>.

A call is found in the device trace by the names of its launch chain
(as the port's cli/trace_kernels.py lists them): the chain's last kernel
closes a call, and the chain's kernels just before it on the device
belong to the same call. Within a span, the k-th call of the kernel is
block k of the UNet's forward order (the backward's: reversed), counted
modulo the UNet's blocks; a span whose calls are not a whole number of
UNet passes is left out. Batch and FiLM rows come from the span: a
served dispatch's bucket, a sample call's batch (one timestep for the
batch), a train step's batch (a timestep per sample)."""
from portbench import work

# kernel: (kernels that open its chain, the kernel that closes it, a test
# on the closing kernel's name that tells this kernel from another chain
# sharing it)
CHAINS = {
    "ffn_block": (("ftc::norm_film_rows_kernel", "ftc::gate_kernel<"), "ftc::out_kernel<",
                  lambda name: name.endswith("false>(ldm::ftc::FwdArgs)")),
    "ffn_block_bwd": (("ftc::gate_grad_kernel",), "ftc::tail_kernel",
                      lambda name: True),
}


def calls(ops, kernel):
    """[device ns of each call] of `kernel` among ops (device order)."""
    heads, last, accept = CHAINS[kernel]
    out, pending = [], 0
    for _, dur, name in ops:
        if last in name:
            if accept(name):
                out.append(pending + dur)
            pending = 0
        elif any(h in name for h in heads):
            pending += dur
        else:
            pending = 0
    return out


def span_shape(name, meta, counters):
    """(batch, FiLM batch) of the kernel calls in a span."""
    if name == "dispatch":
        return meta["bucket"], 1
    if name == "sample":
        return meta["batch"], 1
    if name == "step":
        return counters["batch"], counters["batch"]
    return None


def read(run, out, rest):
    tr = out.trace
    if tr is None or not rest or rest[0] not in CHAINS:
        return None
    kernel = rest[0]
    ucfg = run.cfg["unet"]
    lat = work.latent_side(run.cfg)
    bound = busy = 0.0
    for name, meta, a, b in tr.spans:
        shape = span_shape(name, meta, out.counters)
        if shape is None:
            continue
        times = calls(tr.ops_in(a, b), kernel)
        order = work.block_calls(ucfg, shape[0], lat)
        if kernel.endswith("_bwd"):
            order = order[::-1]
        if not times or len(times) % len(order):
            continue
        for k, ns in enumerate(times):
            c, hw = order[k % len(order)]
            bound += work.call_bound_s(kernel, ucfg, c, hw, shape[0], shape[1])
            busy += ns / 1e9
    if busy == 0.0:
        return None
    return 100.0 * bound / busy
