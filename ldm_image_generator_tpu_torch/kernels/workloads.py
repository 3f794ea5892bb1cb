"""The kernels' call shapes on the sampling and training paths, random
inputs at those shapes, and the least work each call needs (for
roofline bounds).

Used by chip_smoke.py and the CUDA kernel tests to hold each kernel
against its plain version at the shapes the UNet and the VAE trainer
give it.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ldm_image_generator_tpu_torch.config import UNetConfig, VAEConfig
from ldm_image_generator_tpu_torch.kernels.ffn_block import (
    dequantize_cols,
    quantize_cols,
    quantize_ffn,
)

# H100 SXM published peaks (dense): HBM bytes/s and FLOP/s by operand
# type ("tf32": the tensor cores' TF32 rate)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, "tf32": 495e12}
# The least-cost fp32-accurate product of an fp32 operand on this card's
# tensor cores, by the type of the other operand (vq's x against its
# codebook, an FFN tower's weights against its activation): (PEAK_FLOPS
# key, passes), the cheaper of two splits. TF32: fp32 x fp32 takes three
# passes (big*big, big*small, small*big); a bf16 or int8 operand is exact
# in TF32, two (x*big, x*small). bf16: an fp32 operand splits into three
# bf16 pieces (residual 2^-27 of it), so fp32 x fp32 takes six passes and
# a bf16 or int8 operand (|q| <= 127 needs 7 bits), exact in bf16, three.
# Three TF32 passes cost as much as six bf16 ones; for the others three
# bf16 passes at 989 TFLOP/s beat two TF32 passes at 495
_SPLITS = {torch.float32: (("tf32", 3), (torch.bfloat16, 6)),
           torch.bfloat16: (("tf32", 2), (torch.bfloat16, 3)),
           torch.int8: (("tf32", 2), (torch.bfloat16, 3))}
FP32_PRODUCT = {t: min(ways, key=lambda w: w[1] / PEAK_FLOPS[w[0]])
                for t, ways in _SPLITS.items()}
# units whose operations share the tensor cores (their times add up)
TENSOR_CORE_UNITS = ("tf32", torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class Call:
    """One kernel call shape on the path and its count per denoise step."""

    kernel: str            # block_core | ffn_block (or *_int8: int8 FFN
                           # weights) | window_mha, or *_bwd; vq
    batch: int
    hw: int                # map side (block kernels; vq: latent side) or 0
    c: int                 # channels (vq: vector width D)
    per_step: int          # calls per denoise (or train) step
    n: int = 0             # window_mha: windows; vq: vectors
    l: int = 0             # window_mha: tokens per window; vq: codes K
    heads: int = 0
    masked: bool = False
    residual: bool = True  # block_core: add_residual (False: a conditioned block)
    film_batch: int = 1    # block kernels: the film's batch (a train step's
                           # is the call's: one t per sample)
    experts: int = 4       # FFN kernels: experts in the weight stack (an
                           # expert-parallel block's: the 2 routed ones)

    @property
    def label(self) -> str:
        if self.kernel == "vq":
            return f"[{self.n},{self.c}] K={self.l}"
        if self.kernel.startswith("window_mha"):
            return f"[{self.n},{self.l},{self.c}] h{self.heads}" + (
                " mask" if self.masked else "")
        return f"[{self.batch},{self.hw},{self.hw},{self.c}]" + (
            "" if self.residual else " no-res") + (
            f" film{self.film_batch}" if self.film_batch > 1 else "") + (
            f" E{self.experts}" if self.experts != 4 else "")


def path_calls(batch: int, latent: int = 32,
               cfg: UNetConfig = UNetConfig(), int8: bool = False) -> list:
    """Every distinct kernel call of one UNet forward at `batch`: the
    block body (block_core at batch <= 2, else ffn_block; with int8 FFN
    weights their *_int8 routes) of every block, and window_mha for the
    attention blocks."""
    body = ("block_core" if batch <= 2 else "ffn_block") + ("_int8" if int8 else "")
    calls = []
    ws = cfg.window_size
    for i, (c, nb) in enumerate(zip(cfg.channels, cfg.stages)):
        hw = (latent // cfg.stem_size) >> i
        calls.append(Call(body, batch, hw, c, per_step=2 * nb))
        n_attn = min(2, nb)
        heads = max(1, c // cfg.head_dim)
        if hw <= ws:
            calls.append(Call("window_mha", batch, 0, c, n_attn, n=batch,
                              l=hw * hw, heads=heads))
        else:
            nwin = math.ceil(hw / ws) ** 2
            calls.append(Call("window_mha", batch, 0, c, n_attn,
                              n=batch * nwin, l=ws * ws, heads=heads,
                              masked=True))
    return calls


def cond_body_calls(batch: int = 1, latent: int = 32,
                    cfg: UNetConfig = UNetConfig(), int8: bool = False) -> list:
    """The block_core calls (batch <= 2) of a class-conditioned UNet
    forward that differ from path_calls': every decoder block gets the
    condition, so none folds its residual into the kernel
    (add_residual=False), one call shape per decoder stage."""
    if batch > 2:
        raise ValueError("cond_body_calls covers the block_core body (batch <= 2)")
    body = "block_core" + ("_int8" if int8 else "")
    return [Call(body, batch, (latent // cfg.stem_size) >> i, c, per_step=nb,
                 residual=False)
            for i, (c, nb) in enumerate(zip(cfg.channels, cfg.stages))]


def train_calls(batch: int = 8, latent: int = 32,
                cfg: UNetConfig = UNetConfig()) -> list:
    """Every distinct kernel call of one train step at `batch` > 2: the
    forward's calls (path_calls) and, for each, its backward kernel's
    call at the same shape and count."""
    if batch <= 2:
        raise ValueError("train_calls covers the ffn_block body (batch > 2)")
    fwd = path_calls(batch, latent, cfg)
    return fwd + [dataclasses.replace(c, kernel=c.kernel + "_bwd") for c in fwd]


def vae_train_calls(batch: int = 8, crop: int = 192,
                    cfg: VAEConfig = VAEConfig()) -> list:
    """The kernel call of one VAE train step: vq over the latents of the
    batch's crops, once."""
    side = crop // cfg.downscale
    return [Call("vq", batch, side, cfg.embedding_dim, 1,
                 n=batch * side * side, l=cfg.num_embeddings)]


def _randn(shape, gen, device, scale=1.0, shift=0.0):
    return torch.randn(shape, generator=gen, device=device) * scale + shift


def make_inputs(call: Call, dtype: torch.dtype, device,
                gen: torch.Generator) -> tuple:
    """Positional arguments of the kernel wrapper for `call` (weights at
    lecun scale, biases and FiLM random, film at batch call.film_batch;
    FFN width M = C as ffn_mul=1 gives; call.experts stacked experts,
    routed to (1, 3), or to (0, 1) in a stack of 2), cast to dtype; for a
    *_int8 call the FFN weights then go through quantize_cols."""
    c = m = call.c
    e = call.experts
    cast = lambda t: t.to(dtype).contiguous()
    if call.kernel == "vq":
        # latents and an N(0, 1) codebook (fp32, as the quantizer keeps it)
        return (cast(_randn((call.n, c), gen, device)),
                _randn((call.l, c), gen, device))
    w = lambda *s, fan: cast(_randn(s, gen, device, fan ** -0.5))
    b = lambda *s: cast(_randn(s, gen, device, 0.05))
    if call.kernel.startswith("window_mha"):
        x = cast(_randn((call.n, call.l, c), gen, device))
        mask = None
        if call.masked:
            mask = torch.zeros((call.n, call.l), dtype=torch.bool, device=device)
            mask[:, -call.l // 6:] = True  # a padded edge window's keys
        ws = (w(c, c, fan=c), b(c), w(c, c, fan=c), b(c),
              w(c, c, fan=c), b(c), w(c, c, fan=c), b(c))
        if call.kernel == "window_mha_bwd":
            return (x, mask, cast(_randn(x.shape, gen, device)), *ws)
        return (x, mask, *ws)
    hw, bt = call.hw, call.batch
    x = cast(_randn((bt, hw, hw, c), gen, device))
    fb = call.film_batch
    mul = cast(_randn((fb, hw, hw, c), gen, device, 0.2, 1.0))
    bias = cast(_randn((fb, hw, hw, c), gen, device, 0.2))
    ffn = (w(c, m, fan=c), b(m), w(c, m, fan=c), b(m), w(m, c, fan=m), b(c),
           w(e, c, m, fan=c), b(e, m), w(e, c, m, fan=c), b(e, m),
           w(e, m, c, fan=m), b(e, c))
    if call.kernel.endswith("_int8"):
        ffn = quantize_ffn(ffn)
    ids = torch.tensor((1, 3) if e > 3 else (0, 1), dtype=torch.int32, device=device)
    if call.kernel == "ffn_block_bwd":
        # h as the norm/FiLM output (about unit scale), g an out-cotangent
        h = cast(_randn((bt * hw * hw, c), gen, device))
        g = cast(_randn((bt * hw * hw, c), gen, device))
        gwa, gba, gwb, gbb, gwc, _, wa, ba, wb, bb, wc, _ = ffn
        return (h, g, gwa, gba, gwb, gbb, gwc, wa, ba, wb, bb, wc, ids)
    if call.kernel.startswith("ffn_block"):
        return (x.reshape(-1, c), mul.reshape(-1, c), bias.reshape(-1, c),
                *ffn, ids)
    conv_k = w(3, 3, 32, c, fan=9 * 32)
    # block_core's add_residual, positional after the ids, where it is False
    return (x, mul, bias, *ffn, conv_k, b(c), ids) + (() if call.residual else (False,))


def dequantized_bwd_inputs(args: tuple) -> tuple:
    """ffn_block_bwd's arguments (make_inputs) with each weight matrix and
    its bias replaced by their int8 round trip (quantize_cols, then
    dequantize_cols, in their dtype): the weights an int8 train step's
    backward runs at."""
    h, g, gwa, gba, gwb, gbb, gwc, wa, ba, wb, bb, wc, ids = args

    def round_trip(w, b=None):
        b = w.new_zeros(w.shape[:-2] + w.shape[-1:]) if b is None else b
        return tuple(t.to(w.dtype).contiguous()
                     for t in dequantize_cols(*quantize_cols(w, b)))

    (gwa, gba), (gwb, gbb), (wa, ba), (wb, bb) = (
        round_trip(gwa, gba), round_trip(gwb, gbb), round_trip(wa, ba), round_trip(wb, bb))
    return (h, g, gwa, gba, gwb, gbb, round_trip(gwc)[0], wa, ba, wb, bb,
            round_trip(wc)[0], ids)


def work(call: Call, dtype: torch.dtype):
    """(bytes, {PEAK_FLOPS key: operations}) the call needs: each input
    read once (only the two selected experts' weights), each output
    written once; the operations by the unit whose peak they run at."""
    it = torch.finfo(dtype).bits // 8
    if call.kernel != "vq":
        nbytes, flops = _block_work(call, it)
        if dtype != torch.float32:
            return nbytes, {dtype: flops}
        # every float32 product accurate to fp32 on the tensor cores: with
        # int8 FFN weights the towers' as FP32_PRODUCT[int8], the conv's
        # (fp32 taps) as FP32_PRODUCT[float32]
        conv = _conv_flops(call)
        towers = torch.int8 if call.kernel.endswith("_int8") else dtype
        ops = {}
        for n, other in ((flops - conv, towers), (conv, dtype)):
            unit, passes = FP32_PRODUCT[other]
            ops[unit] = ops.get(unit, 0) + passes * n
        return nbytes, {u: n for u, n in ops.items() if n}
    # x in, fp32 codebook in, int32 indices out; per (vector, code) a
    # D-term dot accurate to fp32 (FP32_PRODUCT[dtype] on the tensor
    # cores), and the score and the compare on the CUDA cores (2 fp32
    # operations)
    pairs = call.n * call.l
    nbytes = it * call.n * call.c + 4 * call.l * call.c + 4 * call.n
    unit, passes = FP32_PRODUCT[dtype]
    return nbytes, {unit: passes * 2 * call.c * pairs, torch.float32: 2 * pairs}


def _block_work(call: Call, it: int):
    """(bytes, flops) of a window MHA, FFN or block_core call with
    `it`-byte activations."""
    c = m = call.c
    if call.kernel == "window_mha_bwd":
        # projections 22 N L C^2 (qkv recompute 6, dO 2, dx 6, dW 8) plus
        # the six attention products 12 N L^2 C; x, g in, dx out; weights
        # read, fp32 weight and bias gradients written
        rows = call.n * call.l
        nbytes = (it * (3 * rows * c + 4 * c * c + 4 * c)
                  + 4 * (4 * c * c + 4 * c)
                  + (call.n * call.l if call.masked else 0))
        flops = 22 * rows * c * c + 12 * call.n * call.l * call.l * c
        return nbytes, flops
    if call.kernel == "ffn_block_bwd":
        # 8 products of N x C x M per ReGLU, 3 ReGLUs; h, g in, dh out;
        # the three towers' weights read, their fp32 gradients written
        rows = call.batch * call.hw * call.hw
        tower = 3 * (3 * c * m + 2 * m)
        nbytes = it * (3 * rows * c + tower) + 4 * tower + 8
        return nbytes, 48 * rows * c * m
    if call.kernel == "window_mha":
        rows = call.n * call.l
        nbytes = it * (2 * rows * c + 4 * c * c + 4 * c) + (
            call.n * call.l if call.masked else 0)
        flops = 8 * rows * c * c + 4 * call.n * call.l * call.l * c
        return nbytes, flops
    rows = call.batch * call.hw * call.hw
    film = 2 * call.film_batch * call.hw * call.hw * c
    # general + two experts: matrices and biases, or with int8 the
    # matrices at 1 byte and an fp32 scale and bias per output column
    if call.kernel.endswith("_int8"):
        weights = 3 * (3 * c * m + 8 * (2 * m + c))
    else:
        weights = it * 3 * (3 * c * m + 2 * m + c)
    nbytes = it * (rows * c + film + 2 * rows * c) + weights + 8
    flops = 18 * rows * c * m + _conv_flops(call)
    if call.kernel.startswith("block_core"):
        nbytes += it * (9 * 32 * c + c)
    return nbytes, flops


def _conv_flops(call: Call) -> int:
    """The grouped 3x3 conv's FLOP in a block_core call (0 elsewhere)."""
    if not call.kernel.startswith("block_core"):
        return 0
    return 2 * call.batch * call.hw * call.hw * call.c * 9 * 32


# backward kernel vs its plain version: each output's max abs error over
# max(max |plain|, 1) (bwd_scale_err; the unit floor because dbk vanishes
# in exact arithmetic, softmax being invariant to a shift of every key,
# so both sides hold rounding noise there). fp32 (TF32 off): sums over up
# to 10368 rows in another order. bf16: da, db, the gate, dO, the
# probabilities and dS round at the same points as the plain version, so
# a differing sum order moves a rounded value by one bf16 ulp (2**-8),
# and the rare one-ulp flip of b > 0 at the ReLU boundary moves one row's
# contribution to a weight gradient
BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def bwd_scale_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max(max |want|, 1)."""
    err = (got.float() - want.float()).abs().max().item()
    return err / max(want.float().abs().max().item(), 1.0)


def bound_ms(call: Call, dtype: torch.dtype):
    """(least ms on an H100 at its published peaks, 'bytes'|'operations'):
    the larger of the bytes' time and the busiest unit's operations (the
    tensor cores' TF32 and bf16 passes one after another, the CUDA cores
    beside them)."""
    nbytes, ops = work(call, dtype)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    busy = {}
    for unit, n in ops.items():
        core = "tensor" if unit in TENSOR_CORE_UNITS else unit
        busy[core] = busy.get(core, 0.0) + n / PEAK_FLOPS[unit]
    t_ops = max(busy.values()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# vq kernel vs plain: the fp32 score ||e||^2 - 2 x.e of either side is
# within about (D + 2) * 2**-24 of its terms' magnitude (||e||^2 + 2 sum
# |x_d e_d|) of the exact one, so where the two pick different codes the
# exact scores of those codes may differ by up to twice that: 2**-19
# covers D = 8 with room. A larger gap is a wrong index
VQ_TIE_REL = 2.0 ** -19


def vq_mismatches(x: torch.Tensor, codebook: torch.Tensor, got: torch.Tensor,
                  want: torch.Tensor):
    """(rows where the indices differ, the largest gap there between the
    two codes' exact scores (float64 from the same inputs) over their
    terms' magnitude; 0.0 when none differ)."""
    rows = torch.nonzero(got != want).flatten()
    if rows.numel() == 0:
        return 0, 0.0
    xr = x[rows].double()
    gaps, scales = [], []
    for idx in (got[rows].long(), want[rows].long()):
        e = codebook[idx].double()
        e_sq = (e * e).sum(-1)
        gaps.append(e_sq - 2.0 * (xr * e).sum(-1))
        scales.append(e_sq + 2.0 * (xr * e).abs().sum(-1))
    rel = (gaps[0] - gaps[1]).abs() / torch.maximum(*scales)
    return int(rows.numel()), float(rel.max())


def near_tie_codebook(k: int, d: int, gen: torch.Generator, device) -> torch.Tensor:
    """[k, d] fp32 codebook of near ties: N(0, 1) codes in pairs, the
    second of each pair the first with every element moved by about
    2**-18 relative (random signs), and its second half an exact copy of
    its first (so each duplicate lies K/2 codes on, in another slice of
    the kernel's K split)."""
    half = k // 2
    pairs = torch.randn(((half + 1) // 2, d), generator=gen, device=device)
    sign = torch.randint(0, 2, pairs.shape, generator=gen, device=device) * 2 - 1
    near = pairs * (1 + sign * 2.0 ** -18)
    first = torch.stack([pairs, near], 1).reshape(-1, d)[:half]
    rest = torch.randn((k - 2 * half, d), generator=gen, device=device)
    return torch.cat([first, first, rest]).contiguous()


def tie_codebook(k: int, d: int, layout: str, gen: torch.Generator, device,
                 slice_codes: int = 0):
    """(codebook [k, d] fp32, copy_of [k] int64): N(0, 1) codes, some of
    them exact copies of an earlier one; copy_of[i] is the index of the
    first copy of code i (i itself for a first copy). layout 'halves':
    code i + k/2 copies code i; 'next_rank': in each even slice of
    slice_codes codes (a rank of the vq kernel's K split), code i is
    copied one slice on, in the next rank; 'mid': in each slice, the
    codes of its first ceil(tiles / 2) 8-code tiles (what the kernel's
    first half of warps takes of a slice staged at once) are copied as
    far on, into the other half; 'quad': in each 8-code tile, codes 4-7
    copy codes 0-3 (the vq kernel's lanes 2 and 3 of a quad copy lanes 0
    and 1); 'pair': code 2j + 1 copies code 2j (the two codes one lane
    holds of a tile)."""
    i = torch.arange(k, device=device)
    if layout in ("next_rank", "mid") and slice_codes <= 0:
        raise ValueError(f"{layout} needs slice_codes")
    if layout == "halves":
        first = i[: k // 2]
        second = first + k // 2
    elif layout == "next_rank":
        first = i[((i // slice_codes) % 2 == 0) & (i + slice_codes < k)]
        second = first + slice_codes
    elif layout == "mid":
        half = 8 * ((slice_codes // 8 + 1) // 2)
        off = i % slice_codes
        first = i[(off < half) & (off + half < slice_codes) & (i + half < k)]
        second = first + half
    elif layout == "pair":
        first = i[(i % 2 == 0) & (i + 1 < k)]
        second = first + 1
    elif layout == "quad":
        first = i[(i % 8 < 4) & (i + 4 < k)]
        second = first + 4
    else:
        raise ValueError(f"unknown layout {layout!r}")
    cb = torch.randn((k, d), generator=gen, device=device)
    cb[second] = cb[first]
    copy_of = i.clone()
    copy_of[second] = first
    return cb, copy_of


GUARD = 1 << 16   # elements of sentinel on each side of a guarded buffer
SENTINEL = 0xA5   # every byte of a guard


class GuardedBuffers:
    """Within `with GuardedBuffers() as g:`, torch.empty, torch.empty_like
    and torch.zeros (as the kernel wrappers call them) place each tensor
    inside a larger buffer whose ends hold a sentinel, so that a kernel's
    write past either end of its buffer shows in g.faults() once the
    device has synchronised (compute-sanitizer does not run on the H100
    machines)."""

    def __init__(self):
        self.made = []  # (buffer, numel, zeroed)
        self._saved = None

    def make(self, shape, dtype, device, zeroed=False):
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        numel = math.prod(shape)
        buf = self._saved[0](numel + 2 * GUARD, dtype=dtype, device=device)
        buf.view(torch.uint8).fill_(SENTINEL)
        inner = buf[GUARD:GUARD + numel]
        if zeroed:
            inner.zero_()
        self.made.append((buf, numel, zeroed))
        return inner.view(shape)

    def __enter__(self):
        self._saved = (torch.empty, torch.empty_like, torch.zeros)
        torch.empty = lambda shape, dtype, device: self.make(shape, dtype, device)
        torch.empty_like = lambda t: self.make(t.shape, t.dtype, t.device)
        torch.zeros = lambda shape, dtype, device: self.make(shape, dtype, device, True)
        return self

    def __exit__(self, *exc):
        torch.empty, torch.empty_like, torch.zeros = self._saved
        return False

    def faults(self) -> list:
        """(buffer index, what) for each guard written and each zeroed
        buffer (the split counters) not left zero."""
        out = []
        for i, (buf, numel, zeroed) in enumerate(self.made):
            raw = buf.view(torch.uint8)
            edge = GUARD * buf.element_size()
            if not bool((raw[:edge] == SENTINEL).all()):
                out.append((i, "before"))
            if not bool((raw[raw.numel() - edge:] == SENTINEL).all()):
                out.append((i, "after"))
            if zeroed and bool((buf[GUARD:GUARD + numel] != 0).any()):
                out.append((i, "not left zero"))
        return out


def ffn_bwd_boundary_plain(kernel, plain, args) -> tuple:
    """For an ffn_block_bwd call (make_inputs' args) whose kernel and plain
    version decided a b = h @ wb + bb of the ReLU the other way: (the
    plain version taking the kernel's decision there, decisions that
    differ, those of them not within C 2^-23 (|h| @ |wb| + |bb|) of 0,
    the kernel's outputs of a rerun). The bound is the most two fp32 sums
    over C terms in other orders can differ (both sides sum b in fp32 for
    bf16 operands too); the float32 tensor-core route's three TF32 passes
    stay within it too (the derivation heads csrc/tf32_common.cuh). A
    flip there moves a whole row of dh and a column of dwb. The kernel's decisions are read back from its db (nonzero
    where it took b > 0) through a rerun that keeps its buffers; only a
    decision near the boundary (away == 0) explains a difference."""
    from ldm_image_generator_tpu_torch.kernels import ffn_block as tffn

    h, g, gwa, gba, gwb, gbb, gwc, wa, ba, wb, bb, wc, ids = args
    (n, c), m = h.shape, wa.shape[-1]
    saved, tffn._counters = tffn._counters, {}
    try:
        with GuardedBuffers() as bufs:
            again = kernel(*args)
            torch.cuda.synchronize()
    finally:
        tffn._counters = saved
    dgate = next(buf[GUARD:GUARD + numel] for buf, numel, _ in bufs.made
                 if numel == 9 * n * m).view(9, n, m)
    kernel_pos = dgate[3:6] != 0  # [da | db | gate] x 3 towers
    towers = [(gwa, gba, gwb, gbb, gwc)] + [
        (wa[e], ba[e], wb[e], bb[e], wc[e]) for e in ids.tolist()]
    plain_pos, matters, near = [], [], []
    hf, hd = h.float(), h.double()
    for w_a, b_a, w_b, b_b, w_c in towers:
        # the plain version's fp32 products, and b in float64 with its bound
        plain_pos.append(hf @ w_b.float() + b_b.float() > 0)
        matters.append((hf @ w_a.float() + b_a.float()) * (g.float() @ w_c.float().t()) != 0)
        exact = hd @ w_b.double() + b_b.double()
        near.append(exact.abs() <= c * 2.0 ** -23 * (hd.abs() @ w_b.double().abs()
                                                     + b_b.double().abs()))
    plain_pos, matters, near = map(torch.stack, (plain_pos, matters, near))
    differ = (kernel_pos != plain_pos) & matters
    away = int((differ & ~near).sum())
    want = plain(*args, b_pos=torch.where(differ, kernel_pos, plain_pos))
    return want, int(differ.sum()), away, again
