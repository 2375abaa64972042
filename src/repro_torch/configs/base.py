"""Configuration dataclasses (counterpart of ``repro.configs.base``).

:class:`ModelConfig` carries every field and derived property of the
reference's, so ``ModelConfig(**dataclasses.asdict(jax_cfg))`` builds
the port's config 1:1. The port reads what its ported families need;
the rest is carried for that round trip:

- ``use_pallas`` is carried and ignored. The port has one
  decode-attention semantics on every device, the reference's
  ``use_pallas=True`` branch (``flash_decode``, fp32 online softmax);
  its jnp branch is not ported.
- ``scan_layers`` picks the parameter layout (stacked ``"layers"`` or a
  ``"blocks"`` list), as in the reference; the port loops over the
  stacked layer index in Python.
- ``remat`` is honoured: ``"full"`` keeps only each block's inputs for
  backward and ``"dots"`` also the outputs of its weight products
  (``models/transformer._maybe_remat``, the reference's
  ``jax.checkpoint`` and its ``checkpoint_dots_with_no_batch_dims``).
- ``microbatch_override`` and ``fsdp_over_pod`` are read by the dry-run
  (``launch/dryrun.microbatches_for`` and ``rules_for``).
  ``moe_grouped_dispatch`` and ``moe_groups`` pick the MoE's grouped
  dispatch, which is ported (``models/moe.py``).

:class:`ShapeConfig` and :data:`INPUT_SHAPES` are the reference's four
input shapes, and :class:`RunConfig` its (model, shape, optimizer,
swarm) bundle.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Optional


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm | cnn
    n_layers: int
    d_model: int
    n_heads: int = 0                 # 0 => attention-free
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0              # cnn: number of classes
    head_dim: int = 0                # 0 => d_model // n_heads
    qkv_bias: bool = False
    mlp_bias: bool = False
    act: str = "swiglu"              # swiglu | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_every: int = 1
    n_dense_layers: int = 0
    n_shared_experts: int = 0
    router_aux_weight: float = 0.01

    # --- SSM ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 128

    # --- hybrid ---
    attn_every: int = 0
    shared_attn: bool = False

    # --- encoder-decoder ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500

    # --- modality frontend stub ---
    frontend: str = "none"           # none | audio | vision
    n_vision_tokens: int = 256

    # --- long-context / decode ---
    sliding_window: int = 0          # 0 => full attention
    attn_chunk_q: int = 0            # q-chunk for long prefill (0 => 1024)
    cache_dtype: str = ""            # KV-cache dtype ("" => dtype)
    moe_grouped_dispatch: bool = False
    moe_groups: int = 16
    vocab_round_to: int = 0          # pad the vocab to a multiple of this
    microbatch_override: int = 0
    fsdp_over_pod: bool = True
    cache_ring: bool = False         # sliding-window decode with an O(window) ring cache

    # --- runtime ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    scan_layers: bool = True
    remat: str = "none"
    use_pallas: bool = False         # carried, ignored (see the module note)

    source: str = ""

    def __post_init__(self):
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        if self.vocab_round_to <= 0:
            return self.vocab_size
        r = self.vocab_round_to
        return ((self.vocab_size + r - 1) // r) * r

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def smoke(self) -> "ModelConfig":
        """Reduced same-family variant for CPU tests (the reference's)."""
        d = min(self.d_model, 128)
        heads = min(self.n_heads, 4) if self.n_heads else 0
        kv = min(self.n_kv_heads, heads) if self.n_kv_heads else 0
        return replace(
            self,
            arch_id=self.arch_id + "-smoke",
            n_layers=2,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            d_model=d,
            n_heads=heads,
            n_kv_heads=max(kv, 1) if heads else 0,
            head_dim=(d // heads) if heads else 0,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_dense_layers=min(self.n_dense_layers, 1),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=32,
            attn_every=2 if self.attn_every else 0,
            encoder_seq=64,
            n_vision_tokens=8 if self.frontend == "vision" else self.n_vision_tokens,
            sliding_window=0,
            dtype="float32",
            param_dtype="float32",
            scan_layers=False,
            remat="none",
        )


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"              # sgd | momentum | adam | adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.9
    grad_clip: float = 1.0
    state_dtype: str = "float32"


@dataclass(frozen=True)
class SwarmConfig:
    """Paper §III hyper-parameters."""
    n_clients: int = 14
    n_clusters: int = 3              # paper §IV.C
    p1: float = 0.9                  # center-replacement threshold
    p2: float = 0.8                  # center-swap threshold
    local_epochs: int = 1
    local_steps: Optional[int] = None
    rounds: int = 10
    kmeans_iters: int = 20


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


INPUT_SHAPES: Dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    swarm: SwarmConfig = field(default_factory=SwarmConfig)
    microbatch: int = 0              # 0 => no gradient accumulation
    seed: int = 0


REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(fn: Callable[[], ModelConfig]) -> Callable[[], ModelConfig]:
    REGISTRY[fn().arch_id] = fn
    return fn


def get_config(arch_id: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (registers the archs)
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]()


def asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)
