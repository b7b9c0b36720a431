"""Model configuration: one dataclass describes every architecture family.

The same fields and defaults as ``repro.models.config.ModelConfig``, so a
config moves between the JAX package and the port unchanged.

A model is a sequence of *blocks* (``block_pattern``), each one of:
  "attn"        — GQA multi-head attention (+MLP)
  "swa"         — sliding-window attention (+MLP)
  "moe"         — attention + mixture-of-experts MLP
  "mamba2"      — Mamba-2 SSD block
  "mlstm"       — xLSTM matrix-LSTM block
  "slstm"       — xLSTM scalar-LSTM block
  "shared_attn" — Zamba-style attention block with *shared* weights across
                  all its occurrences
The port runs every kind: "moe" is the sort-dispatched mixture of
experts of ``models/moe.py``, "mamba2" runs its SSD scan on the
hand-written CUDA kernel ``repro_torch/csrc/ssd_scan.cu`` for CUDA
tensors, and "mlstm"/"slstm" are the xLSTM mixers of ``models/xlstm.py``
(``mlstm_chunk`` picks the chunked mLSTM form; ``mlstm_unroll`` only
matters to the JAX package's cost analysis).

``attn_impl`` keeps the JAX package's values: "einsum" (plain S^2
attention), "blocked" (online softmax over KV chunks in plain PyTorch),
"blocked_unrolled" (the same loop: the port's is unrolled either way)
and "pallas", which in the port selects the hand-written CUDA flash
kernel (``repro_torch/csrc/flash_attention.cu``) for CUDA tensors.
``remat`` checkpoints each superblock while autograd records
(``models/model.py``); ``scan_layers`` changes nothing in the port, whose
layers are a Python loop either way.
``attn_block_q``/``attn_block_k`` size the "blocked" chunks; the CUDA
kernel has fixed tiles.

The pattern must be periodic (``pattern == unit * k``), as in the JAX
package, whose checkpoints stack each unit slot's weights along a leading
``n_super`` axis; the port runs the layers as an ``nn.ModuleList``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

BlockKind = Literal["attn", "swa", "moe", "mamba2", "mlstm", "slstm",
                    "shared_attn"]

ATTN_KINDS = ("attn", "swa", "moe", "shared_attn")
SSM_KINDS = ("mamba2", "mlstm", "slstm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                       # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    block_pattern: tuple[str, ...]

    # attention
    head_dim: int = 0                    # 0 => d_model // n_heads
    rope_theta: float = 10_000.0
    sliding_window: int = 0              # used by "swa" blocks
    attn_impl: str = "einsum"            # einsum | blocked[_unrolled] | pallas
    attn_block_q: int = 512              # blocked/pallas tile sizes
    attn_block_k: int = 512

    # mlp
    mlp_type: str = "swiglu"             # swiglu | gelu

    # moe
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_z_weight: float = 1e-3
    load_balance_weight: float = 1e-2
    moe_dispatch: str = "global"         # global | local (per-shard sort)
    moe_local_groups: int = 16           # data-axis groups for "local"

    # ssm (mamba2)
    ssm_state: int = 64
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssd_chunk: int = 128

    # xlstm
    lstm_heads: int = 4
    mlstm_chunk: int = 0                 # 0 = full S^2 parallel form
    mlstm_unroll: bool = False           # unroll the chunk loop (dry-run)

    # embeddings / head
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    # diffusion-denoiser options
    time_conditioning: bool = True
    bidirectional: bool = False          # denoiser mode: no causal mask /
                                         # fwd+bwd scan fusion for SSM blocks

    # modality frontend stub (the one allowed stub)
    frontend: str | None = None          # "audio" | "vision" | None
    frontend_tokens: int = 0             # prefix positions fed by the stub

    # runtime / lowering
    dtype: str = "float32"
    scan_layers: bool = True             # False => unroll (dry-run accuracy)
    remat: bool = False
    paper: str = ""                      # provenance note

    # ---------------- derived ----------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def __post_init__(self):
        if len(self.block_pattern) != self.n_layers:
            raise ValueError(
                f"{self.name}: pattern length {len(self.block_pattern)} != "
                f"n_layers {self.n_layers}")
        self.superblock()  # validate periodicity eagerly

    def superblock(self) -> tuple[tuple[str, ...], int]:
        """Smallest repeating unit of the pattern and its repeat count."""
        pat = self.block_pattern
        L = len(pat)
        for p in range(1, L + 1):
            if L % p == 0 and pat == pat[:p] * (L // p):
                return pat[:p], L // p
        raise ValueError(f"{self.name}: non-periodic block pattern")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self, **kw) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        unit, _ = self.superblock()
        # keep one block of each distinct kind (preserves family coverage:
        # zamba -> (mamba2, shared_attn), xlstm -> (mlstm, slstm))
        seen: list[str] = []
        for kind in unit:
            if kind not in seen:
                seen.append(kind)
        unit = tuple(seen[:3])
        small = dict(
            n_layers=len(unit) * 1,
            block_pattern=unit,
            d_model=256,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_ff=512 if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 256),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            experts_per_token=min(self.experts_per_token, 2)
            if self.n_experts else 0,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=32,
            ssd_chunk=16,
            lstm_heads=2,
            sliding_window=min(self.sliding_window, 32)
            if self.sliding_window else 0,
            frontend_tokens=min(self.frontend_tokens, 4)
            if self.frontend_tokens else 0,
            head_dim=0,
        )
        small.update(kw)
        return self.replace(**small)


def dense_pattern(n_layers: int, sliding_window: int = 0) -> tuple[str, ...]:
    return ("swa" if sliding_window else "attn",) * n_layers


def moe_pattern(n_layers: int) -> tuple[str, ...]:
    return ("moe",) * n_layers
