"""internvl2-26b [vlm] — InternViT (stub frontend) + InternLM2 backbone.
[arXiv:2404.16821]"""
from repro_torch.configs.base import ModelConfig, register


@register
def internvl2_26b() -> ModelConfig:
    return ModelConfig(
        arch_id="internvl2-26b",
        family="vlm",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab_size=92553,
        act="swiglu",
        norm="rmsnorm",
        frontend="vision",
        n_vision_tokens=256,        # projected patch embeddings (stub)
        source="arXiv:2404.16821",
    )
