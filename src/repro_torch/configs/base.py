"""Model configuration for the port: the fields of ``repro.configs.base``
that the serving and training slices read (the MoE, vision-stub, local
attention, SSM, RG-LRU and encoder-decoder fields included, and
``moe_ep``, the sharding rules' expert-parallel switch), with the same
names, defaults, ``reduced()`` and ``n_params()`` so a test can build the
same model in both packages."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    mlp_gated: bool = True      # SwiGLU vs plain (GELU) MLP
    qkv_bias: bool = False
    pos: str = "rope"           # rope | learned | sinusoidal
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    act: str = "silu"           # silu | gelu
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group: int = 2048       # tokens per dispatch group
    # attention windows
    sliding_window: int = 0     # >0: SWA for all attention layers (mixtral)
    local_window: int = 0       # >0: window of "local attention" layers
    block_pattern: Tuple[str, ...] = ()  # e.g. ("rec","rec","attn") hybrid
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    # encoder-decoder (whisper): n_layers is the decoder's depth
    enc_layers: int = 0
    enc_frames: int = 0         # encoder input length (stub frame embeddings)
    frontend: str = "none"      # none | audio_stub | vision_stub
    n_patches: int = 0          # vision_stub prefix length
    # coded-memory integration (the paper's technique)
    coded_embedding: bool = False
    embed_banks: int = 8        # data banks for the coded vocab table
    kv_banks: int = 0           # >0: banked+parity KV cache in serving path
    kv_page: int = 64
    # dtypes: training keeps master params in ``param_dtype`` and casts
    # them to ``compute_dtype`` inside the step; serving draws and keeps
    # its params in the compute dtype (a JAX tree is cast once, at load)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    rg_scan_bf16: bool = False  # RG-LRU scan on bf16 (a, w)
    moe_ep: bool = False        # expert parallelism (experts over `model`)
    # training's per-layer recompute: "full" saves only each layer's
    # input, "dots" also keeps the projection matmuls' outputs
    remat_policy: str = "full"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))
        assert self.n_heads == 0 or self.n_heads % max(self.n_kv, 1) == 0

    @property
    def vocab_pad(self) -> int:
        """Vocab rounded up to a multiple of 256; logits of the padded ids
        are masked, tokens never reference them."""
        return -(-self.vocab // 256) * 256

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """Supports O(1)-state or windowed decode at 500k context."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def n_params(self) -> int:
        """The JAX package's analytic parameter count (norms, biases, the
        convolutions and the SSM's per-head scalars left out; the RG-LRU
        block approximated as there)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv * hd \
            + self.n_heads * hd * d
        mlp = (3 if self.mlp_gated else 2) * d * f
        if self.family == "moe":
            mlp = self.n_experts * mlp
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            di = self.ssm_expand * d
            nh = di // self.ssm_headdim
            per = d * (2 * di + 2 * self.ssm_state + nh) + di * d + di
            return self.n_layers * per + emb
        if self.family == "hybrid":
            pat = self.block_pattern
            n_attn = sum(1 for i in range(self.n_layers)
                         if pat[i % len(pat)] == "attn")
            rec = 2 * d * d + d * d + 3 * d
            return n_attn * (attn + mlp) + (self.n_layers - n_attn) \
                * (rec + mlp) + emb
        return (self.n_layers + self.enc_layers) * (attn + mlp) + emb

    def n_active_params(self) -> int:
        """Active (per-token) parameters: the MoE counts top_k experts."""
        if self.family != "moe":
            return self.n_params()
        per = (3 if self.mlp_gated else 2) * self.d_model * self.d_ff
        return self.n_params() - self.n_layers * (self.n_experts
                                                  - self.top_k) * per

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU tests (same cuts as the JAX
        package's ``reduced()``)."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, len(self.block_pattern) or 2),
            d_model=128,
            n_heads=4,
            n_kv=2 if 0 < self.n_kv < self.n_heads else 4,
            head_dim=32,
            d_ff=256,
            vocab=512,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            moe_group=64,
            sliding_window=min(self.sliding_window, 16)
            if self.sliding_window else 0,
            local_window=min(self.local_window, 16)
            if self.local_window else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=32 if self.ssm_state else 64,
            enc_layers=min(self.enc_layers, 2),
            enc_frames=min(self.enc_frames, 32) if self.enc_frames else 0,
            n_patches=min(self.n_patches, 8) if self.n_patches else 0,
        )


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        from repro_torch import configs
        configs.load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> Dict[str, ModelConfig]:
    if not _REGISTRY:
        from repro_torch import configs
        configs.load_all()
    return dict(_REGISTRY)
