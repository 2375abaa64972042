"""The paper's local models (BSO-SL §IV: SqueezeNet default; RQ2 sweep
over AlexNet / VGG16 / InceptionV3). Topologies live in
``repro_torch.models.cnn`` keyed by ``arch_id``."""
from repro_torch.configs.base import ModelConfig, register

_COMMON = dict(
    family="cnn",
    n_layers=0, d_model=0,
    vocab_size=5,                    # 5 DR severity grades
    dtype="float32", param_dtype="float32",
)


@register
def squeezenet_dr() -> ModelConfig:
    return ModelConfig(arch_id="squeezenet-dr", source="arXiv:1602.07360", **_COMMON)


@register
def alexnet_dr() -> ModelConfig:
    return ModelConfig(arch_id="alexnet-dr", source="NeurIPS2012 AlexNet", **_COMMON)


@register
def vgg_dr() -> ModelConfig:
    return ModelConfig(arch_id="vgg-dr", source="arXiv:1409.1556", **_COMMON)


@register
def inception_dr() -> ModelConfig:
    return ModelConfig(arch_id="inception-dr", source="arXiv:1512.00567", **_COMMON)
