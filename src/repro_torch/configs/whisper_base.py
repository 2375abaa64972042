"""whisper-base [audio] — encoder-decoder transformer backbone; the
mel+conv frontend is the mandated stub (the batch carries frame
embeddings). [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig, register


@register
def whisper_base() -> ModelConfig:
    return ModelConfig(
        arch_id="whisper-base",
        family="encdec",
        n_layers=6,                 # decoder layers
        n_encoder_layers=6,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab_size=51865,
        act="gelu",
        norm="layernorm",
        qkv_bias=True,
        mlp_bias=True,
        is_encoder_decoder=True,
        encoder_seq=1500,
        frontend="audio",
        rope_theta=0.0,             # sinusoidal positions, not RoPE
        source="arXiv:2212.04356",
    )
