"""Fused SwinBlock FFN prologue: norm + FiLM + 3-ReGLU MoE sum, on rows.

Replaces ``ffn_block_pallas`` (ldm_image_generator_tpu/kernels/
ffn_block.py:221) and, for gradients, ``ffn_block_bwd_pallas`` (:551).
Returns (out, h):

    h   = channel_norm(x) * film_mul + film_bias
    out = ReGLU_general(h) + ReGLU_e1(h) + ReGLU_e2(h)
    ReGLU(h) = ((h @ wa + ba) * relu(h @ wb + bb)) @ wc + bc

Rounding points (as the Pallas kernel): h is rounded to the working type
before the products; a and b are fp32 plus bias and the gate is rounded
to the working type; the sum of the three output products and the
output biases is fp32, rounded once.

On the H100 (csrc/ffn_block.cu): at the B=4 sampling shapes with C >=
512 the work is bound by bytes, the 9 C x C weight matrices of the
general and the two selected experts, streamed once per call (the
expert ids are read from device memory, so only those two slices are
read and the host never waits); at the larger row counts by operations.
At widths that are multiples of 64 with C <= 1024 (every UNet shape;
the route depends on dtype and shape alone, ``ffn_tensor_cores``) every
product runs on the tensor cores in three launches: norm/FiLM, the gate
(a and b of a tile in one block) and the output product over the three
towers with the biases in its epilogue; bfloat16 as wgmma on 128-row
tiles fed by TMA where the gate's tiles fill the card (bf16 weights,
``ffn_wgmma_route``, counted in ``wgmma_launches``; csrc/ffn_wg_fwd.cuh),
else as mma.sync (csrc/ffn_tc.cuh), float32 as TF32 passes, fp32 accurate
(csrc/ffn_tf32_fwd.cuh: three per product with float32 weights, two
with int8 ones, whose tiles stay int8 until the fragment load);
k is split over blocks where the grid has fewer than two blocks per SM,
the splits summed in a fixed order by the last block of each tile.
Other widths keep the CUDA-core FMA chain of csrc/ffn_common.cuh: it
splits k until the card has about four blocks per SM and sums the fp32
partials in an elementwise pass. h, the gate g and the partials live
in scratch this wrapper allocates. Film rows repeat with period
film_mul.shape[0], so the batch-1 FiLM schedule needs no broadcast copy.

Backward (``ffn_block_bwd``, csrc/ffn_block_bwd.cu): from the saved h
and the out-cotangent g, the towers' weight and bias gradients (fp32)
and dh. At the training shapes it is bound by operations (24 products
of N x C x M, half of them recomputing the forward's a, b and the
gate's cotangent). The tensor-core route (the same shapes, in bfloat16
and, since its own rule ``ffn_bwd_tensor_cores``, in float32 as three
TF32 passes, csrc/ffn_tf32_bwd.cuh) runs two launches: the gate's
recompute and cotangents, then one launch holding the nine weight
gradients (rows split over blocks, bias gradients as column sums) and
dh; the FMA route (other widths) splits the rows over blocks and sums
the fp32 partials in a second pass. Neither uses
atomics on data: reruns are bitwise equal. ``ffn_tower_bwd`` composes
it with the expert scatter and the norm/FiLM backward, as the JAX
package's ``_ffn_tower_bwd`` (:681) does, and ``ffn_block`` is an
autograd Function around both directions.

int8 weights (``ffn_block_pallas(..., quantized=True)``): ``quantize_cols``
makes each weight matrix int8 with an fp32 [2, out] row pair [scale;
bias] in place of its bias (stacked experts [E, 2, out]); the wrappers
take the weights so quantized and run the same routes and launches
(csrc/ffn_common.cuh, csrc/ffn_block.cu): each product on the weights
converted to the compute dtype (exact, |q| <= 127) with fp32 sums, then
its column scale and bias. That halves the weight bytes of bf16, which
bound a batch-1 call. Training through int8 weights follows the JAX
package's XLA route (``fake_quantize``): the wrappers take the
full-precision weights with their int8 forms and dequantized copies
(``int8=``), run the forward on the int8 weights, and the backward is the
full-precision one (the ffn_block_bwd kernel) at the dequantized
weights, whose weight gradients pass straight through to the
full-precision weights. The dequantization is a plain elementwise pass,
as XLA's is.
"""
from __future__ import annotations

import torch

from ldm_image_generator_tpu_torch.kernels import _build
from ldm_image_generator_tpu_torch.ops.norm import channel_norm

# calls of ffn_block (full-precision and int8 weights) and of
# ffn_block_bwd that launched their CUDA chains
launches = 0
# of those full-precision calls, the ones that took the bf16 wgmma route
# (the C side's ffn_wgmma_route decides)
wgmma_launches = 0
int8_launches = 0
bwd_launches = 0
# weight tensors quantize_cols has quantized
quantizations = 0

# {device index: int32 split-K counters}: zero before a tensor-core call,
# left zero by it (the last block of each split tile resets its counter);
# both directions' calls are ordered on the stream and share them
_counters: dict = {}


def _split_counters(lib, device) -> torch.Tensor:
    t = _counters.get(device.index)
    if t is None:
        t = torch.zeros(lib.ffn_counter_ints(), dtype=torch.int32,
                        device=device)
        _counters[device.index] = t
    return t


def _check_chunk_aligned(tensor_cores: bool, *tensors) -> None:
    """A tensor-core route reads these tensors (activations and weight
    matrices) in 16-byte chunks: each must start on a 16-byte boundary.
    Biases and the expert ids are read element by element."""
    if tensor_cores and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the tensor-core FFN kernels take activations "
                         "and weight matrices that start on 16-byte boundaries")


def quantize_cols(w: torch.Tensor, bias: torch.Tensor):
    """Symmetric per-output-column int8 quantization (the JAX package's
    quantize_cols, ldm_image_generator_tpu/kernels/ffn_block.py:56):
    w [..., in, out], bias [..., out] -> (int8 w, fp32 [..., 2, out] rows
    [scale; bias]), scale = max |w| / 127 per output column floored at
    1e-12, w / scale rounded half to even."""
    global quantizations
    quantizations += 1
    wf = w.detach().float()
    # divided by a tensor: on the card a Python-scalar divisor rounds some
    # scales one ulp from the quotient (as a product with the reciprocal
    # would), and then some weights to the other integer, so the card's
    # int8 weights would differ from the CPU's and the JAX package's
    amax = wf.abs().amax(dim=-2)
    scale = (amax / torch.full_like(amax, 127.0)).clamp_min(1e-12)
    wq = torch.round(wf / scale.unsqueeze(-2)).to(torch.int8)
    return wq, torch.stack([scale, bias.detach().float()], dim=-2)


def dequantize_cols(wq: torch.Tensor, sb: torch.Tensor):
    """Inverse of quantize_cols: (fp32 w, fp32 bias)."""
    return wq.float() * sb[..., 0:1, :], sb[..., 1, :]


def fake_quantize(w: torch.Tensor, bias: torch.Tensor):
    """(w, bias) rounded through the int8 scheme, in their dtypes, with
    straight-through gradients to the full-precision tensors (the JAX
    package's fake_quantize, :329): w + detach(dequant(quant(w)) - w)."""
    wdq, b = dequantize_cols(*quantize_cols(w, bias))
    wdq, b = wdq.to(w.dtype), b.to(bias.dtype)
    return w + (wdq - w).detach(), bias + (b - bias).detach()


def quantize_ffn(weights) -> tuple:
    """The 12 FFN weights (gwa, gba, ..., wc, bc: matrix, bias pairs) as
    quantize_cols makes them: each matrix int8, each bias its [2, out]
    scale-bias rows. Quantize the weights in the compute dtype, as the
    JAX package's RandomMoE casts them before its kernels quantize."""
    return tuple(t for w, b in zip(weights[0::2], weights[1::2])
                 for t in quantize_cols(w, b))


def dequantize_ffn(qweights, dtype: torch.dtype) -> tuple:
    """The 12 weights quantize_ffn made, dequantized (dequantize_cols)
    and cast to dtype, contiguous (the kernels take them): the weights an
    int8 backward differentiates at."""
    return tuple(t.to(dtype).contiguous()
                 for wq, sb in zip(qweights[0::2], qweights[1::2])
                 for t in dequantize_cols(wq, sb))


def check_int8(weights, int8) -> None:
    """int8 weights given in place of the full-precision ones (the forms
    quantize_ffn makes) run forward only, with grad mode off; training
    through int8 weights passes the full-precision weights with
    int8=(their int8 forms, their dequantized copies)."""
    if weights[0].dtype == torch.int8 and (int8 is not None or torch.is_grad_enabled()):
        raise ValueError(
            "int8 weights given directly run with grad mode off only; to train "
            "through them pass the full-precision weights with "
            "int8=(quantize_ffn(w), dequantize_ffn(...))")


def int8_routes(weights, int8):
    """(the weights the forward runs on, those the backward is taken at)."""
    if int8 is None:
        return weights, weights
    if int8[1] is None:
        raise ValueError("a backward through int8 weights needs their "
                         "dequantized copies (dequantize_ffn)")
    return int8


def norm_film(x: torch.Tensor, film_mul: torch.Tensor,
              film_bias: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """h = T(channel_norm(x) * film_mul + film_bias) on rows [N, C], the
    FiLM product in fp32; film rows [F, C] repeat with period F."""
    n, c = x.shape
    f = film_mul.shape[0]
    hn = channel_norm(x.float(), eps).view(n // f, f, c)
    h = hn * film_mul.float() + film_bias.float()
    return h.reshape(n, c).to(x.dtype)


def reglu_sum_fp32(h, gwa, gba, gwb, gbb, gwc, gbc, wa, ba, wb, bb, wc, bc,
                   expert_ids) -> torch.Tensor:
    """fp32 sum of the general and the two selected experts' ReGLUs of
    h [N, C], output biases included (the gate rounded to h.dtype). With
    int8 weights (quantize_cols) each product runs on the weights cast up
    and takes its column scale before the bias, and each tower's output
    product its own column scale, as the Pallas kernel does."""
    q = gwa.dtype == torch.int8
    ids = expert_ids.long()
    sel = lambda w: w.index_select(0, ids).float()
    ea, eba, eb, ebb, ec, ebc = sel(wa), sel(ba), sel(wb), sel(bb), sel(wc), sel(bc)
    hf = h.float()
    # a bias, or with int8 rows [scale; bias]: y * scale + bias rounded
    # once (a fused multiply-add, as the CUDA kernels and XLA compute it:
    # the product and the sum are exact in fp64)
    proj = lambda y, b: ((y.double() * b[0].double() + b[1].double()).float()
                         if q else y + b)
    bias = lambda b: b[1] if q else b
    out = bias(gbc.float()) + bias(ebc[0]) + bias(ebc[1])
    for wa_, ba_, wb_, bb_, wc_, bc_ in (
        (gwa.float(), gba.float(), gwb.float(), gbb.float(), gwc.float(), gbc.float()),
        (ea[0], eba[0], eb[0], ebb[0], ec[0], ebc[0]),
        (ea[1], eba[1], eb[1], ebb[1], ec[1], ebc[1]),
    ):
        a = proj(hf @ wa_, ba_)
        b = proj(hf @ wb_, bb_)
        g = (a * torch.relu(b)).to(h.dtype)
        y = g.float() @ wc_
        out = out + (y * bc_[0] if q else y)
    return out


def ffn_block_plain(x, film_mul, film_bias, gwa, gba, gwb, gbb, gwc, gbc,
                    wa, ba, wb, bb, wc, bc, expert_ids):
    """Plain PyTorch version: x [N, C], film [F, C] with N % F == 0."""
    h = norm_film(x, film_mul, film_bias)
    out = reglu_sum_fp32(h, gwa, gba, gwb, gbb, gwc, gbc, wa, ba, wb, bb,
                         wc, bc, expert_ids)
    return out.to(x.dtype), h


def check_ffn_args(x, film_mul, film_bias, weights, expert_ids):
    """Shapes, types and placement the CUDA chain takes; raises otherwise.
    Weights in x's dtype, or int8 matrices with fp32 [2, out] / [E, 2,
    out] scale-bias rows in place of the biases (quantize_cols)."""
    n, c = x.shape
    gwa, gba, gwb, gbb, gwc, gbc, wa, ba, wb, bb, wc, bc = weights
    e, _, m = wa.shape
    q = gwa.dtype == torch.int8
    # (shape, dtype) of a weight matrix and of a bias of `out` columns
    mat = lambda *s: (s, torch.int8 if q else x.dtype)
    vec = lambda *s: ((*s[:-1], 2, s[-1]), torch.float32) if q else (s, x.dtype)
    want = {
        "film_mul": (film_mul, ((film_mul.shape[0], c), x.dtype)),
        "film_bias": (film_bias, (tuple(film_mul.shape), x.dtype)),
        "gwa": (gwa, mat(c, m)), "gba": (gba, vec(m)), "gwb": (gwb, mat(c, m)),
        "gbb": (gbb, vec(m)), "gwc": (gwc, mat(m, c)), "gbc": (gbc, vec(c)),
        "wa": (wa, mat(e, c, m)), "ba": (ba, vec(e, m)), "wb": (wb, mat(e, c, m)),
        "bb": (bb, vec(e, m)), "wc": (wc, mat(e, m, c)), "bc": (bc, vec(e, c)),
    }
    for name, (t, (shape, dtype)) in want.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {tuple(shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
    if n % film_mul.shape[0]:
        raise ValueError(f"film rows {film_mul.shape[0]} do not divide {n}")
    if expert_ids.dtype != torch.int32 or tuple(expert_ids.shape) != (2,):
        raise TypeError("expert_ids must be int32 [2]")
    return n, c, m, e


def _ffn_block_forward(x, film_mul, film_bias, gwa, gba, gwb, gbb, gwc, gbc,
                       wa, ba, wb, bb, wc, bc, expert_ids):
    """(out, h): the plain version for CPU tensors, the kernel chain for
    CUDA tensors (or an exception)."""
    if x.device.type == "cpu":
        return ffn_block_plain(x, film_mul, film_bias, gwa, gba, gwb, gbb,
                               gwc, gbc, wa, ba, wb, bb, wc, bc, expert_ids)
    weights = (gwa, gba, gwb, gbb, gwc, gbc, wa, ba, wb, bb, wc, bc)
    n, c, m, e = check_ffn_args(x, film_mul, film_bias, weights, expert_ids)
    code, q = _build.dtype_code(x), gwa.dtype == torch.int8
    out = torch.empty_like(x)
    h = torch.empty_like(x)
    g = torch.empty((3, n, m), dtype=x.dtype, device=x.device)
    lib = _build.load("ffn_block")
    scratch = torch.empty(lib.ffn_block_scratch_floats(code, n, c, m),
                          dtype=torch.float32, device=x.device)
    _check_chunk_aligned(lib.ffn_tensor_cores(code, n, c, m), x, film_mul,
                         film_bias, gwa, gwb, gwc, wa, wb, wc)
    p = _build.cuda_ptrs(x, film_mul, film_bias, *weights, expert_ids, out,
                         h, g, scratch, _split_counters(lib, x.device))
    rc = lib.ffn_block_forward(
        code, int(q), p[0], p[1], p[2], film_mul.shape[0], *p[3:15], e,
        p[15], n, c, m, *p[16:], _build.current_stream(),
    )
    _build.check(lib, rc, "ffn_block")
    global launches, int8_launches, wgmma_launches
    if q:
        int8_launches += 1
    else:
        launches += 1
        wgmma_launches += lib.ffn_wgmma_route(code, 0, n, c, m)
    return out, h


def ffn_block_bwd_plain(h, g, gwa, gba, gwb, gbb, gwc, wa, ba, wb, bb, wc,
                        expert_ids, b_pos=None):
    """Plain PyTorch version of the towers' backward. h, g: [N, C].
    Returns (dh [N, C] in h.dtype, then for the general ReGLU and the
    experts expert_ids[0], expert_ids[1] each: dwa, dba, dwb, dbb, dwc,
    all fp32). da, db and the gate are rounded to h.dtype; dh is an fp32
    sum over the three towers, rounded once. b_pos [3, N, M] bool, where
    given, are the ReLU decisions b > 0 of the three towers in place of
    the computed ones (a check holding a kernel that summed b in another
    order, and so decided a value at the boundary the other way)."""
    dt = h.dtype
    ids = expert_ids.long()
    sel = lambda w: w.index_select(0, ids).float()
    ea, eba, eb, ebb, ec = sel(wa), sel(ba), sel(wb), sel(bb), sel(wc)
    hf = h.float()
    gf = g.to(dt).float()
    dh = torch.zeros_like(hf)
    grads = []
    for r, (wa_, ba_, wb_, bb_, wc_) in enumerate((
        (gwa.float(), gba.float(), gwb.float(), gbb.float(), gwc.float()),
        (ea[0], eba[0], eb[0], ebb[0], ec[0]),
        (ea[1], eba[1], eb[1], ebb[1], ec[1]),
    )):
        a = hf @ wa_ + ba_
        b = hf @ wb_ + bb_
        pos = b > 0 if b_pos is None else b_pos[r]
        relu_b = torch.where(pos, b, torch.zeros_like(b))
        dg = gf @ wc_.t()
        da = (dg * relu_b).to(dt).float()
        db = (dg * a * pos).to(dt).float()
        gate = (a * relu_b).to(dt).float()
        grads += [hf.t() @ da, da.sum(0), hf.t() @ db, db.sum(0), gate.t() @ gf]
        dh = dh + da @ wa_.t() + db @ wb_.t()
    return (dh.to(dt), *grads)


def ffn_block_bwd(h, g, gwa, gba, gwb, gbb, gwc, wa, ba, wb, bb, wc,
                  expert_ids):
    """The towers' backward (see ffn_block_bwd_plain for what it returns).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    chain or raise."""
    if h.device.type == "cpu":
        return ffn_block_bwd_plain(h, g, gwa, gba, gwb, gbb, gwc, wa, ba,
                                   wb, bb, wc, expert_ids)
    n, c = h.shape
    e, _, m = wa.shape
    want = {"g": (g, (n, c)), "gwa": (gwa, (c, m)), "gba": (gba, (m,)),
            "gwb": (gwb, (c, m)), "gbb": (gbb, (m,)), "gwc": (gwc, (m, c)),
            "wa": (wa, (e, c, m)), "ba": (ba, (e, m)), "wb": (wb, (e, c, m)),
            "bb": (bb, (e, m)), "wc": (wc, (e, m, c))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != h.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, want "
                             f"{shape} {h.dtype}")
    if expert_ids.dtype != torch.int32 or tuple(expert_ids.shape) != (2,):
        raise TypeError("expert_ids must be int32 [2]")
    code = _build.dtype_code(h)
    lib = _build.load("ffn_block_bwd")
    f32 = dict(dtype=torch.float32, device=h.device)
    dh = torch.empty_like(h)
    dgate = torch.empty((9, n, m), dtype=h.dtype, device=h.device)
    grads = torch.empty(lib.ffn_bwd_grad_floats(c, m), **f32)
    scratch = torch.empty(lib.ffn_bwd_scratch_floats(code, n, c, m), **f32)
    _check_chunk_aligned(lib.ffn_bwd_tensor_cores(code, n, c, m), h, g, gwa,
                         gwb, gwc, wa, wb, wc)
    p = _build.cuda_ptrs(h, g, gwa, gba, gwb, gbb, gwc, wa, ba, wb, bb, wc,
                         expert_ids, dh, dgate, grads, scratch,
                         _split_counters(lib, h.device))
    rc = lib.ffn_block_backward(code, *p[:12], e, p[12], n, c, m, *p[13:],
                                _build.current_stream())
    _build.check(lib, rc, "ffn_block_bwd")
    global bwd_launches
    bwd_launches += 1
    out = [dh]
    cm, tower = c * m, 2 * (c + 1) * m + m * c
    for r in range(3):
        t = grads[r * tower:(r + 1) * tower]
        out += [t[:cm].view(c, m), t[cm:cm + m],
                t[cm + m:2 * cm + m].view(c, m), t[2 * cm + m:2 * cm + 2 * m],
                t[2 * cm + 2 * m:].view(m, c)]
    return tuple(out)


def norm_film_bwd(x, film_mul, film_bias, dh):
    """(dx, dmul, dbias) of norm_film at (x, film_mul, film_bias) for the
    cotangent dh of h; the film cotangents are summed over the rows that
    repeat them."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, film_mul, film_bias)]
        h = norm_film(*leaves)
        return torch.autograd.grad(h, leaves, dh)


def ffn_tower_bwd(x, film_mul, film_bias, weights, expert_ids, h, g,
                  dh_extra=None):
    """Gradients of ffn_block's 15 differentiable inputs (x, film_mul,
    film_bias, then the 12 weights) from the saved h, the out-cotangent g
    and an extra fp32 cotangent of h (the h output's, plus any sibling
    branch's), as the JAX package's _ffn_tower_bwd: the towers' backward,
    dh = dh_towers + dh_extra in fp32, the expert gradients scattered into
    the stacked tensors with index_add_ (ids stay on the device; equal ids
    add), the output biases' gradient the row sum of g, and the norm/FiLM
    backward of dh rounded to h.dtype. Each gradient in its input's dtype."""
    gwa, gba, gwb, gbb, gwc, gbc, wa, ba, wb, bb, wc, bc = weights
    (dh_ffn, dgwa, dgba, dgwb, dgbb, dgwc, dwa0, dba0, dwb0, dbb0, dwc0,
     dwa1, dba1, dwb1, dbb1, dwc1) = ffn_block_bwd(
        h, g, gwa, gba, gwb, gbb, gwc, wa, ba, wb, bb, wc, expert_ids)
    dh = dh_ffn.float()
    if dh_extra is not None:
        dh = dh + dh_extra.float()
    dbc_row = g.float().sum(0)
    ids = expert_ids.long()

    def scatter(s0, s1, like):
        z = torch.zeros(like.shape, dtype=torch.float32, device=like.device)
        return z.index_add_(0, ids, torch.stack([s0, s1]))

    dx, dmul, dbias = norm_film_bwd(x, film_mul, film_bias, dh.to(h.dtype))
    cast = lambda v, ref: v.to(ref.dtype)
    return (dx, dmul, dbias,
            cast(dgwa, gwa), cast(dgba, gba), cast(dgwb, gwb),
            cast(dgbb, gbb), cast(dgwc, gwc), cast(dbc_row, gbc),
            cast(scatter(dwa0, dwa1, wa), wa), cast(scatter(dba0, dba1, ba), ba),
            cast(scatter(dwb0, dwb1, wb), wb), cast(scatter(dbb0, dbb1, bb), bb),
            cast(scatter(dwc0, dwc1, wc), wc),
            cast(scatter(dbc_row, dbc_row, bc), bc))


class _FfnBlock(torch.autograd.Function):
    """ffn_block with its backward (the JAX package's custom_vjp around
    ffn_block_pallas, _ffb_fwd/_ffb_bwd): h, a forward output, is saved;
    the cotangents of both outputs arrive, either may be None. With int8
    copies (ffn_block's int8=) the forward runs on the int8 weights and the
    backward at the dequantized ones, its weight gradients returned as
    those of `weights` (straight-through)."""

    @staticmethod
    def forward(ctx, x, film_mul, film_bias, expert_ids, int8, *weights):
        run, at = int8_routes(weights, int8)
        out, h = _ffn_block_forward(x, film_mul, film_bias, *run, expert_ids)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, film_mul, film_bias, expert_ids, h, *at)
        return out, h

    @staticmethod
    def backward(ctx, g, gh):
        x, film_mul, film_bias, ids, h, *weights = ctx.saved_tensors
        if g is None and gh is None:
            return (None,) * (len(weights) + 5)
        g = torch.zeros_like(h) if g is None else g.to(h.dtype).contiguous()
        dx, dmul, dbias, *dw = ffn_tower_bwd(x, film_mul, film_bias, weights,
                                             ids, h, g, gh)
        return (dx, dmul, dbias, None, None, *dw)


def ffn_block(x, film_mul, film_bias, gwa, gba, gwb, gbb, gwc, gbc,
              wa, ba, wb, bb, wc, bc, expert_ids, int8=None):
    """(out, h), both [N, C], differentiable in every input but the ids.
    CPU tensors take the plain versions; CUDA tensors launch the kernel
    chains (forward and backward) or raise. With grad mode off
    (sampling) the autograd Function is skipped: it would record
    nothing and costs host time per call.

    int8: the int8 route of full-precision weights: (the 12 weights as
    quantize_ffn makes them from these, their dequantized copies in x's
    dtype as dequantize_ffn makes them, or None with grad mode off). The
    forward runs on the int8 weights; the backward is the full-precision
    one at the dequantized weights, its weight gradients passed straight
    through to the weights given (the JAX package's ffn_block(...,
    quantized=True) on its XLA route). int8 weights given in place of the
    full-precision ones run with grad mode off only (check_int8)."""
    weights = (gwa, gba, gwb, gbb, gwc, gbc, wa, ba, wb, bb, wc, bc)
    check_int8(weights, int8)
    if not torch.is_grad_enabled():
        return _ffn_block_forward(x, film_mul, film_bias,
                                  *(weights if int8 is None else int8[0]), expert_ids)
    return _FfnBlock.apply(x, film_mul, film_bias, expert_ids, int8, *weights)
