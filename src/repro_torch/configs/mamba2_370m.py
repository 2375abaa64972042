"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, register


@register
def mamba2_370m() -> ModelConfig:
    return ModelConfig(
        arch_id="mamba2-370m",
        family="ssm",
        n_layers=48,
        d_model=1024,
        n_heads=0,                  # attention-free
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,            # 2048/64 = 32 SSD heads
        ssm_conv_width=4,
        ssm_chunk=128,
        norm="rmsnorm",
        tie_embeddings=True,
        source="arXiv:2405.21060",
    )
