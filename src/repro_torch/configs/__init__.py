"""Arch registry. Importing this package registers the paper's DR CNNs
and the dense LM that the serve path runs (granite-3-2b)."""
from repro_torch.configs.base import (  # noqa: F401
    REGISTRY,
    ModelConfig,
    OptimizerConfig,
    SwarmConfig,
    get_config,
    register,
)
from repro_torch.configs import granite_3_2b, paper_cnns  # noqa: F401
