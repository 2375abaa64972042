"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8.
[arXiv:2501.kimi2]"""
from repro_torch.configs.base import ModelConfig, register


@register
def kimi_k2_1t_a32b() -> ModelConfig:
    return ModelConfig(
        arch_id="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_ff=2048,                  # per-expert FFN width (paper table)
        vocab_size=163840,
        n_experts=384,
        top_k=8,
        n_dense_layers=1,           # first layer dense (DeepSeek-V3 lineage)
        n_shared_experts=1,
        capacity_factor=1.25,
        act="swiglu",
        norm="rmsnorm",
        param_dtype="bfloat16",     # 1T params: bf16 master + Adafactor
        source="arXiv:2501.kimi2",
    )
