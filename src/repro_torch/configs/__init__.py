"""Arch registry. Importing this package registers the paper's DR CNNs,
the reference's four dense LMs (granite-3-2b, command-r-35b,
deepseek-7b, deepseek-67b), its two moe LMs (kimi-k2-1t-a32b,
llama4-maverick-400b-a17b), its ssm LM (mamba2-370m), its hybrid LM
(zamba2-1.2b), its encoder-decoder (whisper-base) and its vlm
(internvl2-26b): every architecture the reference assigns."""
from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    REGISTRY,
    ModelConfig,
    OptimizerConfig,
    RunConfig,
    ShapeConfig,
    SwarmConfig,
    get_config,
    register,
)
from repro_torch.configs import (command_r_35b, deepseek_7b, deepseek_67b,  # noqa: F401
                                 granite_3_2b, internvl2_26b, kimi_k2_1t_a32b,
                                 llama4_maverick_400b_a17b, mamba2_370m, paper_cnns,
                                 whisper_base, zamba2_1p2b)

ASSIGNED_ARCHS = [
    "granite-3-2b",
    "command-r-35b",
    "zamba2-1.2b",
    "deepseek-67b",
    "kimi-k2-1t-a32b",
    "whisper-base",
    "llama4-maverick-400b-a17b",
    "mamba2-370m",
    "internvl2-26b",
    "deepseek-7b",
]
