"""Plain float32 reference of the LDM denoiser UNet, VAE decoder, DDIM and
the eps-prediction L1 loss, written from the architecture's description
(the Swin-UNet of uthree/ldm-image-generator as the port's config
describes it) with plain torch operations.

It imports nothing of the program under test: parameters are a dict
{name: tensor} under the program's parameter names (so the benchmark can
hand the same weights to both sides), and every random choice the model
makes (the MoE pair of each block, the stochastic-depth keep of each
block) arrives as an input. Call ``precise()`` before running it on a
card: TF32 off for matrix products and convolutions.

Layout: NHWC activations, Dense kernels [in, out], HWIO convs, stacked
experts [E, C, M].
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def precise() -> None:
    """float32 products stay float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def pair_table(num_experts: int) -> List[tuple]:
    """Unordered expert pairs in canonical order ((0,1), (0,2), ...): a
    routing plan's pair id indexes this table."""
    return [(i, j) for i in range(num_experts) for j in range(i + 1, num_experts)]


# --- the UNet's structure -------------------------------------------------

def stage_names(cfg: dict) -> List[str]:
    """Stacks in routing-plan order: encoder stages, then decoder stages
    from the deepest."""
    n = len(cfg["channels"])
    return [f"enc_stage_{i}" for i in range(n)] + [f"dec_stage_{i}" for i in reversed(range(n))]


def blocks(cfg: dict) -> List[dict]:
    """Every block of the UNet in routing-plan (and forward) order:
    {name, channels, attention, shift, level}."""
    out = []
    for name in stage_names(cfg):
        i = int(name.rsplit("_", 1)[1])
        nb, c = cfg["stages"][i], cfg["channels"][i]
        for b in range(nb):
            out.append(dict(name=f"{name}.block_{b}", channels=c, level=i,
                            attention=name.startswith("dec") and b >= nb - 2,
                            shift=cfg["window_size"] // 2 if b % 2 == 0 else 0))
    return out


def unet_shapes(cfg: dict) -> Dict[str, tuple]:
    """{parameter name: (shape, fan_in or None for a bias, 'embed')}."""
    chs, cin, s = cfg["channels"], cfg["input_channels"], cfg["stem_size"]
    cond = cfg["num_classes"] > 0
    out = {}
    dense = lambda n, i, o: out.update({f"{n}.kernel": ((i, o), i), f"{n}.bias": ((o,), None)})
    if cond:
        feats = cfg["cond_channels"] * cfg["cond_tokens"]
        out["class_embed.embedding"] = ((cfg["num_classes"] + 1, feats), "embed")
    out["encoder_first.kernel"] = ((s, s, cin, chs[0]), s * s * cin)
    out["encoder_first.bias"] = ((chs[0],), None)
    by_name = {b["name"]: b for b in blocks(cfg)}
    n = len(chs)
    order = []
    for i in range(n):
        order.append(f"enc_stage_{i}")
        if i != n - 1:
            order.append(f"enc_chconv_{i}")
    for i in reversed(range(n)):
        if i != n - 1:
            order.append(f"dec_chconv_{i}")
        order.append(f"dec_stage_{i}")
    for name in order:
        i = int(name.rsplit("_", 1)[1])
        if "chconv" in name:
            a, b = (chs[i], chs[i + 1]) if name.startswith("enc") else (chs[i + 1], chs[i])
            dense(name, a, b)
            continue
        for bi in range(cfg["stages"][i]):
            blk = by_name[f"{name}.block_{bi}"]
            c = blk["channels"]
            m = c * cfg["ffn_mul"]
            e = cfg["num_experts"]
            p = f"{name}.block_{bi}"
            out[f"{p}.encodings.proj1.kernel"] = ((2 * c, 4 * c), 2 * c)
            out[f"{p}.encodings.proj1.bias"] = ((4 * c,), None)
            dense(f"{p}.encodings.proj2", 4 * c, 2 * c)
            out.update({
                f"{p}.ffn.wa": ((e, c, m), c), f"{p}.ffn.wb": ((e, c, m), c),
                f"{p}.ffn.wc": ((e, m, c), m), f"{p}.ffn.ba": ((e, m), None),
                f"{p}.ffn.bb": ((e, m), None), f"{p}.ffn.bc": ((e, c), None),
                f"{p}.ffn.gwa": ((c, m), c), f"{p}.ffn.gwb": ((c, m), c),
                f"{p}.ffn.gwc": ((m, c), m), f"{p}.ffn.gba": ((m,), None),
                f"{p}.ffn.gbb": ((m,), None), f"{p}.ffn.gbc": ((c,), None)})
            gw = min(cfg["head_dim"], c)
            out[f"{p}.conv.kernel"] = ((3, 3, gw, c), 9 * gw)
            out[f"{p}.conv.bias"] = ((c,), None)
            if blk["attention"]:
                kv = cfg["cond_channels"] if cond else c
                for kind, din in (("self_attention", c), ("cross_attention", kv)):
                    q = f"{p}.{kind}.mha"
                    out.update({f"{q}.wq": ((c, c), c), f"{q}.bq": ((c,), None),
                                f"{q}.wk": ((din, c), din), f"{q}.bk": ((c,), None),
                                f"{q}.wv": ((din, c), din), f"{q}.bv": ((c,), None),
                                f"{q}.wo": ((c, c), c), f"{q}.bo": ((c,), None)})
    out["decoder_last.kernel"] = ((s, s, chs[0], cin), s * s * chs[0])
    out["decoder_last.bias"] = ((cin,), None)
    return out


def decoder_shapes(vae: dict) -> Dict[str, tuple]:
    """The VAE decoder's {parameter name: (shape, fan_in or None)}."""
    chs = vae["decoder_channels"]
    out = {"input_layer.kernel": ((vae["latent_channels"], chs[0]), vae["latent_channels"]),
           "input_layer.bias": ((chs[0],), None)}
    for i, (c, layers) in enumerate(zip(chs, vae["decoder_stages"])):
        if i:
            out[f"up_{i}.kernel"] = ((2, 2, chs[i - 1], c), 4 * chs[i - 1])
            out[f"up_{i}.bias"] = ((c,), None)
        for r in range(layers):
            for conv in ("c1", "c2"):
                out[f"stage_{i}.layers.res_{r}.{conv}.kernel"] = ((3, 3, c, c), 9 * c)
                out[f"stage_{i}.layers.res_{r}.{conv}.bias"] = ((c,), None)
        out[f"stage_{i}.to_rgb.kernel"] = ((c, vae["input_channels"]), c)
        out[f"stage_{i}.to_rgb.bias"] = ((vae["input_channels"],), None)
    return out


# --- layers -----------------------------------------------------------------

def dense(P: Params, name: str, x):
    return x @ P[f"{name}.kernel"] + P[f"{name}.bias"]


def channel_norm(x, eps: float = 1e-4):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=True)
    return (x - mean) * torch.rsqrt(var + eps)


def positional_encoding(h: int, w: int, c: int, device):
    """[H, W, C]: [sin v | cos v | sin u | cos u], v = row / H, u = col / W,
    octave factors 2 ** -(i / (C / 4)), phases times pi."""
    q = c // 4
    f = 1.0 / (2.0 ** (torch.arange(q, device=device, dtype=torch.float32) / q))
    v = (torch.arange(h, device=device, dtype=torch.float32) / h)[:, None] * math.pi * f
    u = (torch.arange(w, device=device, dtype=torch.float32) / w)[:, None] * math.pi * f
    ev = torch.cat([torch.sin(v), torch.cos(v)], -1)
    eu = torch.cat([torch.sin(u), torch.cos(u)], -1)
    return torch.cat([ev[:, None].expand(h, w, c // 2), eu[None].expand(h, w, c // 2)], -1)


def time_encoding(t, c: int):
    """[T, 1, 1, C]: [sin | cos] of t pi 10000 ** -(i / (C / 2))."""
    half = c // 2
    f = 1.0 / (10000.0 ** (torch.arange(half, device=t.device, dtype=torch.float32) / half))
    ph = t.float()[:, None] * math.pi * f
    return torch.cat([torch.sin(ph), torch.cos(ph)], -1)[:, None, None, :]


def film(P: Params, p: str, h: int, w: int, c: int, t):
    """(mul, bias) [T, H, W, C] of a block's FiLM tower at timesteps t."""
    k1, b1 = P[f"{p}.encodings.proj1.kernel"], P[f"{p}.encodings.proj1.bias"]
    pe = positional_encoding(h, w, c, t.device)
    emb = pe[None] @ k1[:c] + time_encoding(t, c) @ k1[c:] + b1
    emb = dense(P, f"{p}.encodings.proj2", torch.relu(emb))
    return emb[..., :c], emb[..., c:]


def reglu(h, wa, ba, wb, bb, wc, bc):
    return ((h @ wa + ba) * torch.relu(h @ wb + bb)) @ wc + bc


def moe(P: Params, p: str, h, experts: Sequence[int]):
    """The general ReGLU plus the routed experts' ReGLUs."""
    g = lambda n: P[f"{p}.ffn.{n}"]
    out = reglu(h, g("gwa"), g("gba"), g("gwb"), g("gbb"), g("gwc"), g("gbc"))
    for e in experts:
        out = out + reglu(h, g("wa")[e], g("ba")[e], g("wb")[e], g("bb")[e],
                          g("wc")[e], g("bc")[e])
    return out


def grouped_conv3x3(h, kernel, bias):
    c, gw = h.shape[-1], kernel.shape[2]
    y = F.conv2d(h.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), padding=1,
                 groups=c // gw)
    return y.permute(0, 2, 3, 1) + bias


def mha(P: Params, q: str, x, kv, heads: int, key_pad=None):
    """Multi-head attention of x [N, L, C] over kv [N, S, D]; key_pad [N, S]
    True on keys to ignore."""
    n, l, c = x.shape
    s, d = kv.shape[1], c // heads
    qh = (x @ P[f"{q}.wq"] + P[f"{q}.bq"]).reshape(n, l, heads, d)
    kh = (kv @ P[f"{q}.wk"] + P[f"{q}.bk"]).reshape(n, s, heads, d)
    vh = (kv @ P[f"{q}.wv"] + P[f"{q}.bv"]).reshape(n, s, heads, d)
    scores = torch.einsum("nlhd,nshd->nhls", qh, kh) / math.sqrt(d)
    if key_pad is not None:
        scores = scores.masked_fill(key_pad[:, None, None, :], float("-inf"))
    o = torch.einsum("nhls,nshd->nlhd", torch.softmax(scores, -1), vh).reshape(n, l, c)
    return o @ P[f"{q}.wo"] + P[f"{q}.bo"]


def window_attention(P: Params, q: str, x, heads: int, ws: int, shift: int):
    """Self-attention within ws x ws windows of the (cyclically shifted)
    zero-padded map, padded keys ignored; a map no larger than a window
    attends in full."""
    b, h, w, c = x.shape
    if h <= ws and w <= ws:
        t = x.reshape(b, h * w, c)
        return mha(P, q, t, t, heads).reshape(b, h, w, c)
    hp, wp = h + (-h) % ws, w + (-w) % ws
    xp = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
    pad = (torch.arange(hp, device=x.device)[:, None] >= h) | (
        torch.arange(wp, device=x.device)[None, :] >= w)
    if shift:
        xp = torch.roll(xp, (shift, shift), dims=(1, 2))
        pad = torch.roll(pad, (shift, shift), dims=(0, 1))
    nh, nw = hp // ws, wp // ws
    part = lambda t, ch: t.reshape(-1, nh, ws, nw, ws, ch).permute(0, 1, 3, 2, 4, 5).reshape(
        -1, ws * ws, ch)
    wins = part(xp, c)
    key_pad = part(pad[None, :, :, None], 1)[:, :, 0].repeat(b, 1)
    o = mha(P, q, wins, wins, heads, key_pad)
    o = o.reshape(b, nh, nw, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
    if shift:
        o = torch.roll(o, (-shift, -shift), dims=(1, 2))
    return o[:, :h, :w]


def swin_block(P: Params, cfg: dict, blk: dict, x, t, experts, keep=None, cond=None):
    p, c = blk["name"], blk["channels"]
    heads = max(1, c // cfg["head_dim"])
    mul, bias = film(P, p, x.shape[1], x.shape[2], c, t)
    h = channel_norm(x) * mul + bias
    branch = moe(P, p, h, experts) + grouped_conv3x3(h, P[f"{p}.conv.kernel"], P[f"{p}.conv.bias"])
    if blk["attention"]:
        branch = branch + window_attention(P, f"{p}.self_attention.mha", h, heads,
                                           cfg["window_size"], blk["shift"])
        if cond is not None:
            b_, hh, ww, _ = branch.shape
            branch = branch + mha(P, f"{p}.cross_attention.mha", branch.reshape(b_, hh * ww, c),
                                  cond, heads).reshape(branch.shape)
    if keep is not None:
        branch = branch * keep
    return x + branch


def avg_pool_2x(x):
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def upsample_2x(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def stride_conv(P: Params, name: str, x, s: int):
    b, h, w, c = x.shape
    k = P[f"{name}.kernel"]
    patches = x.reshape(b, h // s, s, w // s, s, c).permute(0, 1, 3, 2, 4, 5).reshape(
        b, h // s, w // s, s * s * c)
    return patches @ k.reshape(s * s * c, -1) + P[f"{name}.bias"]


def stride_conv_transpose(P: Params, name: str, x, s: int):
    """out[s y + a, s x + b] = in[y, x] @ K[s - 1 - a, s - 1 - b] + bias."""
    b, h, w, _ = x.shape
    y = torch.einsum("nhwi,abio->nhawbo", x, P[f"{name}.kernel"].flip(0, 1))
    return y.reshape(b, h * s, w * s, -1) + P[f"{name}.bias"]


def class_tokens(P: Params, cfg: dict, ids):
    """[B, tokens, channels] condition tokens of class ids [B] (id
    num_classes: the learned null class)."""
    table = P["class_embed.embedding"]
    return table[ids.long()].reshape(ids.shape[0], cfg["cond_tokens"], cfg["cond_channels"])


def unet(P: Params, cfg: dict, x, t, plan, keeps=None, cond=None):
    """The denoiser's output [B, H, W, Cin] for x [B, H, W, Cin] at
    timesteps t [1 or B]. plan: one pair id per block in routing-plan
    order (see blocks()); keeps: one stochastic-depth keep (0 or 1) per
    block, or None; cond: condition tokens [B, T, D] for the decoder
    blocks, or None."""
    pairs = pair_table(cfg["num_experts"])
    plan = [pairs[int(i)] for i in plan]
    all_blocks = blocks(cfg)
    n, s = len(cfg["channels"]), cfg["stem_size"]
    k = iter(range(len(all_blocks)))

    def stack(name, x):
        for blk in [b for b in all_blocks if b["name"].startswith(name + ".")]:
            i = next(k)
            x = swin_block(P, cfg, blk, x, t, plan[i],
                           None if keeps is None else keeps[i],
                           cond if name.startswith("dec") else None)
        return x

    x = stride_conv(P, "encoder_first", x, s)
    skips = []
    for i in range(n):
        x = stack(f"enc_stage_{i}", x)
        if i == n - 1:
            skips.append(None)
        else:
            skips.append(x)
            x = avg_pool_2x(dense(P, f"enc_chconv_{i}", x))
    for i in reversed(range(n)):
        if i != n - 1:
            x = dense(P, f"dec_chconv_{i}", upsample_2x(x))
        if skips[i] is not None:
            x = x + skips[i]
        x = stack(f"dec_stage_{i}", x)
    return stride_conv_transpose(P, "decoder_last", x, s)


def decoder(P: Params, vae: dict, z):
    """RGB [B, 8h, 8w, 3] (about [-1, 1]) of latents z [B, h, w, C]: the
    progressive RGB pyramid sum."""
    x = dense(P, "input_layer", z)
    rgb = None
    for i, layers in enumerate(vae["decoder_stages"]):
        if i:
            x = stride_conv_transpose(P, f"up_{i}", x, 2)
        for r in range(layers):
            q = f"stage_{i}.layers.res_{r}"
            conv = lambda n, v: F.conv2d(v.permute(0, 3, 1, 2), P[f"{n}.kernel"].permute(3, 2, 0, 1),
                                         P[f"{n}.bias"], padding=1).permute(0, 2, 3, 1)
            y = F.leaky_relu(conv(f"{q}.c1", x), 0.01)
            x = F.leaky_relu(conv(f"{q}.c2", y), 0.01) + x
        out = dense(P, f"stage_{i}.to_rgb", x)
        if rgb is not None:
            up = F.interpolate(rgb.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                               align_corners=False).permute(0, 2, 3, 1)
            out = up + out
        rgb = out
    return rgb


def to_uint8(img):
    return (img.clamp(-1.0, 1.0) * 127.5 + 127.5).to(torch.uint8)


# --- diffusion ----------------------------------------------------------------

def alpha_bar(beta_min: float = 1e-4, beta_max: float = 0.02, steps: int = 1000) -> np.ndarray:
    """float32 cumulative product of 1 - beta over a linear beta schedule
    built in float64."""
    beta = np.linspace(beta_min, beta_max, steps, dtype=np.float64)
    return np.cumprod(1.0 - beta).astype(np.float32)


def ddim_steps(num_timesteps: int, num_steps: int) -> List[tuple]:
    """(t, t_next) from the last timestep down: linspace(0, T - 1, n)
    truncated to int, t_next the previous point (0 before the first)."""
    s = np.linspace(0, num_timesteps - 1, num_steps).astype(np.int32)
    nxt = np.concatenate([[0], s[:-1]]).astype(np.int32)
    return list(zip(s[::-1].tolist(), nxt[::-1].tolist()))


def ddim(model, x, ab: np.ndarray, num_steps: int):
    """Deterministic DDIM (eta 0) over eps predictions model(x, t) -> the
    final x0 estimate."""
    one = np.float32(1.0)
    for t, t_next in ddim_steps(len(ab), num_steps):
        eps = model(x, t)
        a_t = ab[t]
        x0 = (x - float(np.sqrt(one - a_t)) * eps) / float(np.sqrt(a_t))
        if t == 0:
            x = x0
        else:
            a_n = ab[t_next]
            x = float(np.sqrt(a_n)) * x0 + float(np.sqrt(one - a_n)) * eps
    return x


def l1_loss(P: Params, cfg: dict, ab: np.ndarray, x0, t, eps, plan, keeps, cond=None,
            batch: Optional[int] = None):
    """mean |unet(x_t, t) - eps| with x_t = sqrt(ab_t) x0 + sqrt(1 - ab_t)
    eps; `batch` (the whole batch when x0 is a block of its rows) scales
    the block's mean to its share of the batch's."""
    a = torch.from_numpy(ab).to(x0.device)[t.long()].reshape(-1, 1, 1, 1)
    x_t = torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * eps
    loss = (unet(P, cfg, x_t, t, plan, keeps, cond) - eps).abs().mean()
    return loss if batch is None else loss * (x0.shape[0] / batch)


# --- the control: products in the precision below bfloat16 ------------------

def fp8(t):
    """t rounded to float8 e4m3 at one scale for the tensor (its largest
    magnitude to 448, the format's largest), the gradient passed straight
    through."""
    amax = t.detach().abs().amax().clamp(min=1e-30)
    s = 448.0 / amax
    r = (t.detach() * s).to(torch.float8_e4m3fn).to(t.dtype) / s
    return t + (r - t.detach())


def control_rounding(cfg: dict):
    """The rounding of the control for a configuration's compute type: the
    precision below it (fp8 e4m3 below bfloat16)."""
    if cfg["compute_dtype"] != "bfloat16":
        raise ValueError(f"no control rounding for compute {cfg['compute_dtype']}")
    return fp8


class RoundedProducts(torch.overrides.TorchFunctionMode):
    """Within `with RoundedProducts(fp8):`, every operand of a matrix
    product, einsum or convolution is rounded by the function first: the
    reference computed in a lower precision (the benchmark's control)."""

    PRODUCTS = (torch.matmul, torch.Tensor.__matmul__, torch.Tensor.matmul, torch.einsum,
                F.conv2d)

    def __init__(self, rounding):
        super().__init__()
        self.rounding = rounding

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.PRODUCTS:
            rnd = lambda a: self.rounding(a) if isinstance(a, torch.Tensor) and a.is_floating_point() else a
            args = tuple(rnd(a) if not isinstance(a, (list, tuple)) else type(a)(map(rnd, a))
                         for a in args)
            if func is F.conv2d and "weight" in kwargs:
                kwargs["weight"] = rnd(kwargs["weight"])
        return func(*args, **kwargs)
