"""deepseek-7b [dense] — llama-arch GQA kv=32. [arXiv:2401.02954]"""
from repro_torch.configs.base import ModelConfig, register


@register
def deepseek_7b() -> ModelConfig:
    return ModelConfig(
        arch_id="deepseek-7b",
        family="dense",
        n_layers=30,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_ff=11008,
        vocab_size=102400,
        act="swiglu",
        norm="rmsnorm",
        source="arXiv:2401.02954",
    )
