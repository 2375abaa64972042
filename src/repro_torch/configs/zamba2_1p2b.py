"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig, register


@register
def zamba2_1p2b() -> ModelConfig:
    return ModelConfig(
        arch_id="zamba2-1.2b",
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,              # GQA kv=32 (MHA-equivalent)
        d_ff=8192,
        vocab_size=32000,
        ssm_state=64,
        ssm_expand=2,
        ssm_head_dim=64,
        attn_every=6,               # shared attention block after every 6th layer
        shared_attn=True,           # one attention block's weights reused
        sliding_window=8192,        # the attention sub-block's window
        source="arXiv:2411.15242",
    )
