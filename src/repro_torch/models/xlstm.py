"""xLSTM blocks: mLSTM (matrix memory, parallelizable) and sLSTM (scalar
memory, a true per-step recurrence), the port of ``repro/models/xlstm.py``
(Beck et al. 2024, arXiv:2405.04517: exponential gating with
max-stabilizers).

mLSTM runs the stabilized parallel form (one S x S decay matrix) or, when
``0 < cfg.mlstm_chunk < S``, the chunkwise form (a quadratic form inside
each chunk, a (dh x dh) matrix memory carried across chunks), and decodes
with the exact matrix-memory recurrence.  The chunk loop is always a
Python loop: ``cfg.mlstm_unroll`` (the JAX package's choice between a
``lax.scan`` and an unrolled loop for its cost analysis) changes nothing
here.  sLSTM is a Python loop over time with block-diagonal recurrent
weights per head; its pre-activations for all steps come from one
product.  In denoiser mode (``bidirectional=True``) each mixer runs once
forward and once over the flipped sequence and sums the two.

The stabilizer constants are the reference's: the parallel form masks
with -inf before the row max; the chunked form pads the input gate with
-1e9 and starts m at -1e9; the denominators are max(|.|, exp(-m)) and,
for sLSTM, max(n, 1e-6).  The log forget gate is ``logsigmoid``, the
reference's ``-softplus(-f)``; on a DTensor (a model sharded over a
mesh) it is taken block by block, as its backward has no DTensor
sharding rule.

Weight layout, the JAX tree's names, so checkpoints load unchanged:
  mLSTM: up (d, 2 d_in) -> [x_m, z]; wq, wk, wv (d_in, d_in);
         wif (d_in, 2 nh) read as (2, nh): input gates, then forget gates;
         norm (d_in); down (d_in, d), with d_in = 2 d and dh = d_in / nh
  sLSTM: w (d, 4 d) read per head as (nh, 4 dh): i, f, z, o;
         r (nh, dh, 4 dh); norm (d); down (d, d), with dh = d / nh

The caches (``init_cache``/``decode``) hold f32 state, whatever the
model's dtype, and are updated in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import is_sharded
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import RMSNorm, dense_init, truncated_normal


def _logsigmoid_for(x: torch.Tensor):
    """The log-sigmoid for tensors like ``x``: ``F.logsigmoid``, or on a
    DTensor the block-by-block form.  Decided once per forward, outside
    the sLSTM's time loop."""
    return _sharded_logsigmoid if is_sharded(x) else F.logsigmoid


def _sharded_logsigmoid(x: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid`` of a DTensor: its partial sums are reduced and the
    op runs on each rank's block, as ``log_sigmoid_backward`` has no
    DTensor sharding rule."""
    from torch.distributed.tensor import DTensor, Replicate
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    x = x.redistribute(x.device_mesh, pl)
    return DTensor.from_local(F.logsigmoid(x.to_local()), x.device_mesh, pl,
                              shape=x.shape, stride=x.stride())


NEG = -1e9


# ====================== mLSTM ======================

def _mlstm_parallel(q, k, v, logi, logf):
    """q, k, v: (B,S,nh,dh) f32; logi, logf: (B,S,nh).  Stabilized
    parallel form."""
    B, S, nh, dh = q.shape
    cf = torch.cumsum(logf, dim=1)                        # (B,S,nh)
    # D_ij = cf_i - cf_j + logi_j  for j <= i
    Dm = cf[:, :, None, :] - cf[:, None, :, :] + logi[:, None, :, :]
    tri = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    Dm = Dm.masked_fill(~tri[None, :, :, None], float("-inf"))
    m = Dm.amax(dim=2)                                    # (B,Si,nh)
    dmat = torch.exp(Dm - m[:, :, None, :])
    qk = torch.einsum("bihd,bjhd->bijh", q, k) / (dh ** 0.5)
    w = qk * dmat
    denom = torch.maximum(w.sum(2).abs(), torch.exp(-m))  # (B,Si,nh)
    return torch.einsum("bijh,bjhd->bihd", w, v) / denom[..., None]


def _mlstm_chunked(q, k, v, logi, logf, chunk: int):
    """Chunkwise-parallel mLSTM: the D matrix inside each chunk of
    ``chunk`` steps, the (C, n, m) matrix memory carried across chunks;
    equal to the parallel form up to rounding, in O(S * chunk) memory."""
    B, S, nh, dh = q.shape
    L = min(chunk, S)
    nc = -(-S // L)
    pad = nc * L - S
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        logi = F.pad(logi, (0, 0, 0, pad), value=NEG)   # pad steps: no input
        logf = F.pad(logf, (0, 0, 0, pad))
    scale = 1.0 / (dh ** 0.5)
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    C = torch.zeros((B, nh, dh, dh), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, nh, dh), dtype=torch.float32, device=q.device)
    m = torch.full((B, nh), NEG, dtype=torch.float32, device=q.device)
    hs = []
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        qq, kk, vv, li, lf = q[:, sl], k[:, sl], v[:, sl], logi[:, sl], \
            logf[:, sl]
        b = torch.cumsum(lf, dim=1)                       # (B,L,nh) inclusive
        # intra-chunk D matrix
        Dm = b[:, :, None, :] - b[:, None, :, :] + li[:, None, :, :]
        Dm = Dm.masked_fill(~tri[None, :, :, None], float("-inf"))
        m_loc = Dm.amax(dim=2)                            # (B,Li,nh)
        a_inter = b + m[:, None, :]                       # log-scale of C
        m_i = torch.maximum(m_loc, a_inter)
        w = (torch.einsum("bihd,bjhd->bijh", qq, kk) * scale
             * torch.exp(Dm - m_i[:, :, None, :]))
        scale_prev = torch.exp(a_inter - m_i)             # (B,Li,nh)
        qs = qq * scale
        num = (torch.einsum("bijh,bjhd->bihd", w, vv)
               + torch.einsum("bihd,bhde->bihe", qs, C)
               * scale_prev[..., None])
        den_loc = w.sum(2)
        den_prev = torch.einsum("bihd,bhd->bih", qs, n) * scale_prev
        den = torch.maximum((den_loc + den_prev).abs(), torch.exp(-m_i))
        hs.append(num / den[..., None])

        # carry update
        g = b[:, -1]                                      # (B,nh) log-decay
        m_kv = (g[:, None, :] - b + li).amax(dim=1)       # (B,nh)
        m_new = torch.maximum(g + m, m_kv)
        wj = torch.exp(g[:, None, :] - b + li - m_new[:, None, :])
        decay = torch.exp(g + m - m_new)
        C = (decay[..., None, None] * C
             + torch.einsum("bjh,bjhd,bjhe->bhde", wj, kk, vv))
        n = decay[..., None] * n + torch.einsum("bjh,bjhd->bhd", wj, kk)
        m = m_new
    return torch.cat(hs, dim=1)[:, :S]


class MLSTM(nn.Module):
    """The mLSTM mixer.  Init draws in the JAX key order: up, wq, wk, wv,
    wif (scale 0.1), down."""

    def __init__(self, generator, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        d_in = 2 * d
        dt = getattr(torch, cfg.dtype)
        self.up = dense_init(generator, d, 2 * d_in, dt, device)  # [x_m, z]
        self.wq = dense_init(generator, d_in, d_in, dt, device)
        self.wk = dense_init(generator, d_in, d_in, dt, device)
        self.wv = dense_init(generator, d_in, d_in, dt, device)
        self.wif = dense_init(generator, d_in, 2 * cfg.lstm_heads, dt,
                              device, scale=0.1)
        self.norm = RMSNorm(d_in, dt, device, cfg.norm_eps)
        self.down = dense_init(generator, d_in, d, dt, device)

    def _gates(self, x_m):
        """x_m (..., d_in) -> q, k, v (..., nh, dh) and logi, logf
        (..., nh), all f32."""
        nh = self.cfg.lstm_heads
        lead = x_m.shape[:-1]
        q, k, v = ((x_m @ w).reshape(*lead, nh, -1).float()
                   for w in (self.wq, self.wk, self.wv))
        gif = (x_m @ self.wif).float().reshape(*lead, 2, nh)
        return q, k, v, gif[..., 0, :], _logsigmoid_for(gif)(gif[..., 1, :])

    def _one(self, u: torch.Tensor) -> torch.Tensor:
        B, S, d = u.shape
        x_m, z = (u @ self.up).chunk(2, dim=-1)
        q, k, v, logi, logf = self._gates(x_m)
        chunk = self.cfg.mlstm_chunk
        if chunk and chunk < S:
            h = _mlstm_chunked(q, k, v, logi, logf, chunk)
        else:
            h = _mlstm_parallel(q, k, v, logi, logf)
        h = h.reshape(B, S, 2 * d).to(u.dtype)
        return (self.norm(h) * F.silu(z)) @ self.down

    def forward(self, u: torch.Tensor, *,
                bidirectional: bool = False) -> torch.Tensor:
        """Full-sequence forward.  u: (B, S, d) -> (B, S, d)."""
        y = self._one(u)
        if bidirectional:
            y = y + torch.flip(self._one(torch.flip(u, dims=(1,))),
                               dims=(1,))
        return y

    def init_cache(self, batch: int, dtype=None) -> dict:
        """The matrix memory: C, n, m in f32 whatever ``dtype`` (as in
        the reference)."""
        nh = self.cfg.lstm_heads
        dh = 2 * self.cfg.d_model // nh
        dev = self.up.device
        return {"C": torch.zeros((batch, nh, dh, dh), device=dev),
                "n": torch.zeros((batch, nh, dh), device=dev),
                "m": torch.full((batch, nh), NEG, device=dev)}

    def decode(self, u: torch.Tensor, cache: dict) -> torch.Tensor:
        """One step of the exact matrix-memory recurrence.  u: (B, 1, d);
        ``cache`` is updated in place."""
        B, _, d = u.shape
        nh = self.cfg.lstm_heads
        dh = 2 * d // nh
        x_m, z = (u[:, 0] @ self.up).chunk(2, dim=-1)
        q, k, v, logi, logf = self._gates(x_m)            # (B,nh,dh), (B,nh)
        m_new = torch.maximum(logf + cache["m"], logi)
        a = torch.exp(logf + cache["m"] - m_new)[..., None]
        b = torch.exp(logi - m_new)[..., None]
        C = cache["C"] * a[..., None] + b[..., None] * (
            k[..., :, None] * v[..., None, :])
        n = cache["n"] * a + b * k
        qs = q / (dh ** 0.5)
        num = torch.einsum("bhd,bhde->bhe", qs, C)
        den = torch.maximum(torch.einsum("bhd,bhd->bh", qs, n).abs(),
                            torch.exp(-m_new))
        cache["C"].copy_(C)
        cache["n"].copy_(n)
        cache["m"].copy_(m_new)
        h = (num / den[..., None]).reshape(B, 2 * d).to(u.dtype)
        return ((self.norm(h) * F.silu(z)) @ self.down)[:, None]


# ====================== sLSTM ======================

def _slstm_cell(r: torch.Tensor, x_t: torch.Tensor, state: dict,
                logsigmoid) -> dict:
    """x_t: (B, 4 d) input pre-activations; r: (nh, dh, 4 dh); state:
    c, n, m, h of (B, nh, dh), f32; ``logsigmoid`` from
    ``_logsigmoid_for``.  Returns the new state."""
    nh, dh = r.shape[0], r.shape[1]
    rec = torch.bmm(state["h"].transpose(0, 1),
                    r.float()).transpose(0, 1)            # (B,nh,4dh)
    raw = x_t.reshape(-1, nh, 4 * dh).float() + rec
    i_r, f_r, z_r, o_r = raw.chunk(4, dim=-1)
    logi, logf = i_r, logsigmoid(f_r)
    lf_m = logf + state["m"]
    m_new = torch.maximum(lf_m, logi)
    a, b = torch.exp(lf_m - m_new), torch.exp(logi - m_new)
    c = a * state["c"] + b * torch.tanh(z_r)
    n = a * state["n"] + b
    h = torch.sigmoid(o_r) * c / torch.clamp(n, min=1e-6)
    return {"c": c, "n": n, "m": m_new, "h": h}


class SLSTM(nn.Module):
    """The sLSTM mixer.  Init draws in the JAX key order: w, r (truncated
    normal on [-2, 2] times 1/sqrt(dh)), down."""

    def __init__(self, generator, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, nh = cfg.d_model, cfg.lstm_heads
        dh = d // nh
        dt = getattr(torch, cfg.dtype)
        self.w = dense_init(generator, d, 4 * d, dt, device)  # i, f, z, o
        self.r = truncated_normal(generator, (nh, dh, 4 * dh),
                                  1.0 / dh ** 0.5, dt, device)
        self.norm = RMSNorm(d, dt, device, cfg.norm_eps)
        self.down = dense_init(generator, d, d, dt, device)

    def _one(self, u: torch.Tensor) -> torch.Tensor:
        B, S, d = u.shape
        pre = u @ self.w                                  # (B,S,4d)
        state = self.init_cache(B)
        logsigmoid = _logsigmoid_for(pre)
        hs = []
        for t in range(S):
            state = _slstm_cell(self.r, pre[:, t], state, logsigmoid)
            hs.append(state["h"])
        h = torch.stack(hs, dim=1).reshape(B, S, d).to(u.dtype)
        return self.norm(h) @ self.down

    def forward(self, u: torch.Tensor, *,
                bidirectional: bool = False) -> torch.Tensor:
        """Full-sequence forward.  u: (B, S, d) -> (B, S, d)."""
        y = self._one(u)
        if bidirectional:
            y = y + torch.flip(self._one(torch.flip(u, dims=(1,))),
                               dims=(1,))
        return y

    def init_cache(self, batch: int, dtype=None) -> dict:
        """The cell state: c, n, m, h in f32 whatever ``dtype`` (as in the
        reference)."""
        nh = self.cfg.lstm_heads
        shape = (batch, nh, self.cfg.d_model // nh)
        dev = self.w.device
        return {"c": torch.zeros(shape, device=dev),
                "n": torch.zeros(shape, device=dev),
                "m": torch.full(shape, NEG, device=dev),
                "h": torch.zeros(shape, device=dev)}

    def decode(self, u: torch.Tensor, cache: dict) -> torch.Tensor:
        """One recurrence step.  u: (B, 1, d); ``cache`` is updated in
        place."""
        B, _, d = u.shape
        x_t = u[:, 0] @ self.w
        new = _slstm_cell(self.r, x_t, cache, _logsigmoid_for(x_t))
        for name, t in new.items():
            cache[name].copy_(t)
        h = new["h"].reshape(B, d).to(u.dtype)
        return (self.norm(h) @ self.down)[:, None]
