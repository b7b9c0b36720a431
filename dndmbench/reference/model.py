"""Plain PyTorch forward of the denoisers: the transformer block (RMSNorm,
RoPE attention, SwiGLU MLP), the Mamba-2 block with its scan in the
quadratic (dual) form, the Zamba shared block, the diffusion-time
embedding and the head.

Parameters are a nested dict in the layout of the JAX package's
checkpoints (the program's loader, ``convert.load_params``, reads the
same): ``embed`` (V, d), ``head`` (d, V), ``ln_f/scale``, ``time/w1``,
``time/w2``, ``shared/...`` for a Zamba model's one shared block, and
``unit/b{i}/...`` for unit slot ``i``, each leaf with a leading axis over
the ``n_super`` repeats.  Dense weights are (d_in, d_out), applied as
``x @ W``.

Every product goes through :func:`mm`.  :func:`precision` sets how:
``"float32"`` (TF32 off, the configurations' precision) or ``"tf32"``,
the control: TF32 tensor-core products on a card, and on a CPU the same
rounding of each operand to TF32's 10-bit mantissa.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

_TF32_EMULATED = False


@contextlib.contextmanager
def precision(kind: str, device: torch.device):
    """Products in ``kind`` ("float32" or "tf32") inside the block."""
    global _TF32_EMULATED
    if kind not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {kind!r}")
    tf32 = kind == "tf32"
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, _TF32_EMULATED)
    torch.backends.cuda.matmul.allow_tf32 = tf32 and device.type == "cuda"
    torch.backends.cudnn.allow_tf32 = tf32 and device.type == "cuda"
    _TF32_EMULATED = tf32 and device.type != "cuda"
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, _TF32_EMULATED) = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to nearest (ties to even) on a 10-bit mantissa."""
    i = x.contiguous().view(torch.int32)
    bias = 0x0FFF + ((i >> 13) & 1)
    return ((i + bias) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _TF32_EMULATED:
        a, b = round_tf32(a), round_tf32(b)
    return torch.matmul(a, b)


def expand(c: dict) -> dict:
    """The configuration's widths with the derived ones filled in."""
    c = dict(c)
    c.setdefault("head_dim", c["d_model"] // c["n_heads"])
    c["block_pattern"] = list(c["block_unit"]) * c["n_super"]
    if "ssm_expand" in c:
        c.setdefault("d_inner", c["ssm_expand"] * c["d_model"])
    return c


def param_shapes(c: dict) -> dict:
    """{path: shape} of every parameter, in the checkpoint layout."""
    c = expand(c)
    d, V, hd = c["d_model"], c["vocab_size"], c["head_dim"]
    out = {"embed": (V, d), "ln_f/scale": (d,), "head": (d, V),
           "time/w1": (d, d), "time/w2": (d, d)}

    def attn(prefix, lead):
        H, KV, ff = c["n_heads"], c["n_kv_heads"], c["d_ff"]
        leaves = {"ln1/scale": (d,), "attn/wq": (d, H * hd),
                  "attn/wk": (d, KV * hd), "attn/wv": (d, KV * hd),
                  "attn/wo": (H * hd, d), "ln2/scale": (d,),
                  "mlp/up": (d, ff), "mlp/down": (ff, d)}
        if c["mlp_type"] == "swiglu":
            leaves["mlp/gate"] = (d, ff)
        return {f"{prefix}/{k}": lead + v for k, v in leaves.items()}

    def mamba(prefix, lead):
        d_in, N, W = c["d_inner"], c["ssm_state"], c["conv_width"]
        H = d_in // c["ssm_head_dim"]
        leaves = {"ln/scale": (d,), "mixer/in_proj": (d, 2 * d_in + 2 * N + H),
                  "mixer/conv_w": (W, d_in + 2 * N),
                  "mixer/conv_b": (d_in + 2 * N,), "mixer/A_log": (H,),
                  "mixer/D": (H,), "mixer/dt_bias": (H,),
                  "mixer/norm/scale": (d_in,),
                  "mixer/out_proj": (d_in, d)}
        return {f"{prefix}/{k}": lead + v for k, v in leaves.items()}

    for i, kind in enumerate(c["block_unit"]):
        lead = (c["n_super"],)
        if kind == "attn":
            out.update(attn(f"unit/b{i}", lead))
        elif kind == "mamba2":
            out.update(mamba(f"unit/b{i}", lead))
        elif kind == "shared_attn":
            if "shared/ln1/scale" not in out:
                out.update(attn("shared", ()))
        else:
            raise ValueError(f"the reference has no block kind {kind!r}")
    return out


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def time_embed(p: dict, t: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal features of t in [0, 1] (angles x 1000, frequencies
    10000^(-i / (d/2 - 1))), then silu(f W1) W2."""
    half = d // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=t.device)
                      * (math.log(10_000.0) / max(half - 1, 1)))
    ang = t.float()[:, None] * freqs[None] * 1000.0
    f = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    f = F.pad(f, (0, d - f.shape[-1]))
    return mm(F.silu(mm(f, p["w1"])), p["w2"])


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding at positions 0..S-1.  x (B, S, n, hd)."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def attention(a: dict, h: torch.Tensor, c: dict) -> torch.Tensor:
    """RoPE attention of h (B, S, d) over the whole sequence both ways,
    kv heads shared by H / KV query heads, through ``wo``."""
    B, S, d = h.shape
    H, KV, hd = c["n_heads"], c["n_kv_heads"], c["head_dim"]
    q = rope(mm(h, a["wq"]).view(B, S, H, hd), c["rope_theta"])
    k = rope(mm(h, a["wk"]).view(B, S, KV, hd), c["rope_theta"])
    v = mm(h, a["wv"]).view(B, S, KV, hd)
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))      # (B, H, S, hd)
    w = torch.softmax(mm(q, k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
    o = mm(w, v).transpose(1, 2).reshape(B, S, H * hd)
    return mm(o, a["wo"])


def mlp(m: dict, h: torch.Tensor, c: dict) -> torch.Tensor:
    """The SwiGLU (``gate``, ``up``, ``down``) or GELU MLP of h."""
    up = mm(h, m["up"])
    act = (F.silu(mm(h, m["gate"])) * up if c["mlp_type"] == "swiglu"
           else F.gelu(up, approximate="tanh"))
    return mm(act, m["down"])


def attention_block(p: dict, x: torch.Tensor, c: dict) -> torch.Tensor:
    """x + attn(norm(x)), then x + mlp(norm(x))."""
    x = x + attention(p["attn"], rmsnorm(x, p["ln1"]["scale"], c["norm_eps"]),
                      c)
    return x + mlp(p["mlp"], rmsnorm(x, p["ln2"]["scale"], c["norm_eps"]), c)


def ssd(x, dt, A, Bm, Cm, heads_per_block: int = 16):
    """The SSD recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_tᵀ, y_t =
    C_t h_t, in its quadratic form: y_t = sum_{s <= t} (C_t . B_s)
    exp(sum_{r=s+1..t} dt_r A) dt_s x_s.  x (B, S, H, P), dt (B, S, H),
    A (H,), Bm and Cm (B, S, N); computed in blocks of heads."""
    Bsz, S, H, P = x.shape
    CB = mm(Cm, Bm.transpose(1, 2))                          # (B, S, S)
    tri = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    strict = tri.tril(-1)
    ys = []
    for h0 in range(0, H, heads_per_block):
        hs = slice(h0, min(H, h0 + heads_per_block))
        a = (dt[:, :, hs] * A[hs]).transpose(1, 2)           # (B, h, S)
        # segment sums sum_{r=s+1..t} a_r, one cumulative sum down t
        seg = a[..., :, None].expand(*a.shape, S).masked_fill(~strict, 0.0)
        seg = torch.cumsum(seg, dim=-2).masked_fill(~tri, float("-inf"))
        M = CB[:, None] * torch.exp(seg) * dt[:, :, hs].transpose(1, 2)[
            :, :, None, :]
        ys.append(mm(M, x[:, :, hs].transpose(1, 2)))        # (B, h, S, P)
    return torch.cat(ys, dim=1).transpose(1, 2)              # (B, S, H, P)


def mamba_direction(p: dict, u: torch.Tensor, c: dict) -> torch.Tensor:
    B, S, _ = u.shape
    d_in, N, W, P = c["d_inner"], c["ssm_state"], c["conv_width"], \
        c["ssm_head_dim"]
    H = d_in // P
    z, xBC, dt_raw = torch.split(mm(u, p["in_proj"]), [d_in, d_in + 2 * N, H],
                                 dim=-1)
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    conv = sum(pad[:, i:i + S] * p["conv_w"][i] for i in range(W))
    xBC = F.silu(conv + p["conv_b"])
    x, Bm, Cm = torch.split(xBC, [d_in, N, N], dim=-1)
    dt = F.softplus(dt_raw + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = x.reshape(B, S, H, P)
    y = ssd(xh, dt, A, Bm, Cm) + xh * p["D"][:, None]
    g = y.reshape(B, S, d_in) * F.silu(z)
    return mm(rmsnorm(g, p["norm"]["scale"], c["norm_eps"]), p["out_proj"])


def mamba_block(p: dict, x: torch.Tensor, c: dict) -> torch.Tensor:
    """x + mixer(norm(x)); the mixer runs forward and, bidirectional, over
    the flipped sequence too, and sums the two."""
    h = rmsnorm(x, p["ln"]["scale"], c["norm_eps"])
    y = mamba_direction(p["mixer"], h, c)
    if c["bidirectional"]:
        y = y + mamba_direction(p["mixer"], h.flip(1), c).flip(1)
    return x + y


def _slot(tree: dict, j: int) -> dict:
    return {k: _slot(v, j) if isinstance(v, dict) else v[j]
            for k, v in tree.items()}


def forward(tree: dict, c: dict, tokens: torch.Tensor,
            t: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) int, t (B,) f32 diffusion time in [0, 1] -> logits
    (B, S, V) f32."""
    c = expand(c)
    unit = c["block_unit"]
    h = tree["embed"][tokens.long()]
    if c["time_conditioning"]:
        h = h + time_embed(tree["time"], t, c["d_model"])[:, None]
    for i, kind in enumerate(c["block_pattern"]):
        j, slot = divmod(i, len(unit))
        if kind == "shared_attn":
            h = attention_block(tree["shared"], h, c)
        elif kind == "attn":
            h = attention_block(_slot(tree["unit"][f"b{slot}"], j), h, c)
        elif kind == "mamba2":
            h = mamba_block(_slot(tree["unit"][f"b{slot}"], j), h, c)
        else:
            raise ValueError(f"the reference has no block kind {kind!r}")
    h = rmsnorm(h, tree["ln_f"]["scale"], c["norm_eps"])
    return mm(h, tree["head"])
