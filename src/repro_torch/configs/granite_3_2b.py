"""granite-3-2b [dense] — GQA. [hf:ibm-granite/granite-3.0-2b-base]"""
from repro_torch.configs.base import ModelConfig, register


@register
def granite_3_2b() -> ModelConfig:
    return ModelConfig(
        arch_id="granite-3-2b",
        family="dense",
        n_layers=40,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=49155,
        act="swiglu",
        norm="rmsnorm",
        tie_embeddings=True,
        source="hf:ibm-granite/granite-3.0-2b-base",
    )
