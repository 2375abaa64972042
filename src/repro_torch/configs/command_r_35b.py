"""command-r-35b [dense] — GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.configs.base import ModelConfig, register


@register
def command_r_35b() -> ModelConfig:
    return ModelConfig(
        arch_id="command-r-35b",
        family="dense",
        n_layers=40,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22528,
        vocab_size=256000,
        qkv_bias=False,
        mlp_bias=False,
        act="swiglu",
        norm="layernorm",           # cohere uses LayerNorm (no bias)
        rope_theta=8_000_000.0,
        source="hf:CohereForAI/c4ai-command-r-v01",
    )
