"""Arch registry. Importing this package registers the paper's DR CNNs."""
from repro_torch.configs.base import (  # noqa: F401
    REGISTRY,
    ModelConfig,
    OptimizerConfig,
    SwarmConfig,
    get_config,
    register,
)
from repro_torch.configs import paper_cnns  # noqa: F401
