"""Configuration dataclasses (counterpart of ``repro.configs.base``).

Only the fields the CNN family and the swarm trainer read are carried
over; the LM fields arrive with the LM family.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                      # cnn (the LM families are not ported yet)
    n_layers: int
    d_model: int
    vocab_size: int = 0              # cnn: number of classes
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    source: str = ""


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"              # sgd | momentum | adam | adamw
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.9
    grad_clip: float = 1.0
    state_dtype: str = "float32"


@dataclass(frozen=True)
class SwarmConfig:
    """Paper §III hyper-parameters."""
    n_clients: int = 14
    n_clusters: int = 3              # paper §IV.C
    p1: float = 0.9                  # center-replacement threshold
    p2: float = 0.8                  # center-swap threshold
    local_epochs: int = 1
    local_steps: Optional[int] = None
    rounds: int = 10
    kmeans_iters: int = 20


REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(fn: Callable[[], ModelConfig]) -> Callable[[], ModelConfig]:
    REGISTRY[fn().arch_id] = fn
    return fn


def get_config(arch_id: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (registers the archs)
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]()
