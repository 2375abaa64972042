"""llama4-maverick-400b-a17b [moe] — 128 experts top-1, interleaved
dense/MoE, early fusion. [hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.configs.base import ModelConfig, register


@register
def llama4_maverick_400b_a17b() -> ModelConfig:
    return ModelConfig(
        arch_id="llama4-maverick-400b-a17b",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=202048,
        n_experts=128,
        top_k=1,
        moe_every=2,                # MoE every other layer (maverick-style)
        n_shared_experts=1,
        capacity_factor=1.25,
        act="swiglu",
        norm="rmsnorm",
        param_dtype="bfloat16",
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )
