"""The paper's local-model CNN family (counterpart of ``repro.models.cnn``).

BSO-SL §IV uses SqueezeNet as the default client model and sweeps
AlexNet / VGG16 / InceptionV3 for the model-agnostic claim (RQ2); the
topologies and parameter trees are the reference's. Images are NHWC
and conv weights HWIO at the public functions, as in the reference;
inside, the nets run NCHW and each weight is permuted at its call.

XLA's ``SAME`` padding is reproduced exactly: with stride 2 it pads
asymmetrically ((0, 1) for a 3x3 conv on an even size, (1, 2) for a
5x5), which ``padding=1`` in torch does not.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init

N_CLASSES = 5


def _conv_init(gen: torch.Generator, kh, kw, cin, cout) -> torch.Tensor:
    std = math.sqrt(2.0 / (kh * kw * cin))
    return torch.randn((kh, kw, cin, cout), generator=gen, device=gen.device) * std


def _zeros(gen: torch.Generator, n: int) -> torch.Tensor:
    return torch.zeros((n,), device=gen.device)


def same_pads(size: int, k: int, stride: int):
    """(low, high) padding of XLA's ``SAME`` along one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x, w, b=None, stride: int = 1):
    """``SAME`` convolution of NCHW ``x`` with an HWIO weight ``w``."""
    (ph0, ph1) = same_pads(x.shape[-2], w.shape[0], stride)
    (pw0, pw1) = same_pads(x.shape[-1], w.shape[1], stride)
    w = w.permute(3, 2, 0, 1)
    if ph0 == ph1 and pw0 == pw1:
        return F.conv2d(x, w, b, stride=stride, padding=(ph0, pw0))
    return F.conv2d(F.pad(x, (pw0, pw1, ph0, ph1)), w, b, stride=stride)


def maxpool(x, k: int = 2, stride: int = 2):
    """``VALID`` max-pool of NCHW ``x``."""
    return F.max_pool2d(x, k, stride)


def maxpool_same(x, k: int = 3, stride: int = 1):
    """``SAME`` max-pool of NCHW ``x``, padding with -inf."""
    (ph0, ph1) = same_pads(x.shape[-2], k, stride)
    (pw0, pw1) = same_pads(x.shape[-1], k, stride)
    x = F.pad(x, (pw0, pw1, ph0, ph1), value=float("-inf"))
    return F.max_pool2d(x, k, stride)


def global_avg_pool(x):
    return x.mean(dim=(2, 3))


def _nchw(images):
    return images.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# SqueezeNet (fire modules = squeeze 1x1 -> expand 1x1 + 3x3)

_SQUEEZE_PLAN = [(8, 32), (8, 32), (16, 64), (16, 64)]


def _init_fire(gen, cin, s, e):
    return {
        "squeeze": {"w": _conv_init(gen, 1, 1, cin, s), "b": _zeros(gen, s)},
        "e1": {"w": _conv_init(gen, 1, 1, s, e), "b": _zeros(gen, e)},
        "e3": {"w": _conv_init(gen, 3, 3, s, e), "b": _zeros(gen, e)},
    }


def _apply_fire(p, x):
    s = torch.relu(conv2d(x, p["squeeze"]["w"], p["squeeze"]["b"]))
    e1 = conv2d(s, p["e1"]["w"], p["e1"]["b"])
    e3 = conv2d(s, p["e3"]["w"], p["e3"]["b"])
    return torch.relu(torch.cat([e1, e3], dim=1))


def init_squeezenet(gen):
    params = {"conv1": {"w": _conv_init(gen, 3, 3, 3, 32), "b": _zeros(gen, 32)}}
    cin = 32
    for i, (s, e) in enumerate(_SQUEEZE_PLAN):
        params[f"fire{i}"] = _init_fire(gen, cin, s, e)
        cin = 2 * e
    params["conv_cls"] = {"w": _conv_init(gen, 1, 1, cin, N_CLASSES),
                          "b": _zeros(gen, N_CLASSES)}
    return params


def apply_squeezenet(params, images):
    x = _nchw(images)
    x = torch.relu(conv2d(x, params["conv1"]["w"], params["conv1"]["b"], stride=2))
    for i in range(len(_SQUEEZE_PLAN)):
        x = _apply_fire(params[f"fire{i}"], x)
        if i % 2 == 1:
            x = maxpool(x)
    x = conv2d(x, params["conv_cls"]["w"], params["conv_cls"]["b"])
    return global_avg_pool(x)


# ---------------------------------------------------------------------------
# AlexNet-style


def init_alexnet(gen):
    return {
        "conv1": {"w": _conv_init(gen, 5, 5, 3, 48), "b": _zeros(gen, 48)},
        "conv2": {"w": _conv_init(gen, 3, 3, 48, 96), "b": _zeros(gen, 96)},
        "conv3": {"w": _conv_init(gen, 3, 3, 96, 96), "b": _zeros(gen, 96)},
        "fc1": {"w": dense_init(gen, (96, 256)), "b": _zeros(gen, 256)},
        "fc2": {"w": dense_init(gen, (256, N_CLASSES)), "b": _zeros(gen, N_CLASSES)},
    }


def apply_alexnet(p, images):
    x = _nchw(images)
    x = maxpool(torch.relu(conv2d(x, p["conv1"]["w"], p["conv1"]["b"], stride=2)))
    x = maxpool(torch.relu(conv2d(x, p["conv2"]["w"], p["conv2"]["b"])))
    x = torch.relu(conv2d(x, p["conv3"]["w"], p["conv3"]["b"]))
    x = global_avg_pool(x)
    x = torch.relu(x @ p["fc1"]["w"] + p["fc1"]["b"])
    return x @ p["fc2"]["w"] + p["fc2"]["b"]


# ---------------------------------------------------------------------------
# VGG-style (conv-conv-pool blocks)


def init_vgg(gen):
    chans = [(3, 32), (32, 32), (32, 64), (64, 64)]
    p = {}
    for i, (ci, co) in enumerate(chans):
        p[f"conv{i}"] = {"w": _conv_init(gen, 3, 3, ci, co), "b": _zeros(gen, co)}
    p["fc1"] = {"w": dense_init(gen, (64, 256)), "b": _zeros(gen, 256)}
    p["fc2"] = {"w": dense_init(gen, (256, N_CLASSES)), "b": _zeros(gen, N_CLASSES)}
    return p


def apply_vgg(p, images):
    x = _nchw(images)
    x = torch.relu(conv2d(x, p["conv0"]["w"], p["conv0"]["b"]))
    x = maxpool(torch.relu(conv2d(x, p["conv1"]["w"], p["conv1"]["b"])))
    x = torch.relu(conv2d(x, p["conv2"]["w"], p["conv2"]["b"]))
    x = maxpool(torch.relu(conv2d(x, p["conv3"]["w"], p["conv3"]["b"])))
    x = global_avg_pool(x)
    x = torch.relu(x @ p["fc1"]["w"] + p["fc1"]["b"])
    return x @ p["fc2"]["w"] + p["fc2"]["b"]


# ---------------------------------------------------------------------------
# Inception-style (parallel 1x1 / 3x3 / 5x5 / pool branches)


def _init_inception_block(gen, cin, c1, c3, c5, cp):
    return {
        "b1": {"w": _conv_init(gen, 1, 1, cin, c1), "b": _zeros(gen, c1)},
        "b3": {"w": _conv_init(gen, 3, 3, cin, c3), "b": _zeros(gen, c3)},
        "b5": {"w": _conv_init(gen, 5, 5, cin, c5), "b": _zeros(gen, c5)},
        "bp": {"w": _conv_init(gen, 1, 1, cin, cp), "b": _zeros(gen, cp)},
    }


def _apply_inception_block(p, x):
    b1 = torch.relu(conv2d(x, p["b1"]["w"], p["b1"]["b"]))
    b3 = torch.relu(conv2d(x, p["b3"]["w"], p["b3"]["b"]))
    b5 = torch.relu(conv2d(x, p["b5"]["w"], p["b5"]["b"]))
    bp = torch.relu(conv2d(maxpool_same(x, 3, 1), p["bp"]["w"], p["bp"]["b"]))
    return torch.cat([b1, b3, b5, bp], dim=1)


def init_inception(gen):
    p = {"conv1": {"w": _conv_init(gen, 3, 3, 3, 32), "b": _zeros(gen, 32)}}
    p["inc0"] = _init_inception_block(gen, 32, 16, 24, 8, 8)      # -> 56
    p["inc1"] = _init_inception_block(gen, 56, 24, 32, 12, 12)    # -> 80
    p["fc"] = {"w": dense_init(gen, (80, N_CLASSES)), "b": _zeros(gen, N_CLASSES)}
    return p


def apply_inception(p, images):
    x = _nchw(images)
    x = maxpool(torch.relu(conv2d(x, p["conv1"]["w"], p["conv1"]["b"], stride=2)))
    x = _apply_inception_block(p["inc0"], x)
    x = maxpool(x)
    x = _apply_inception_block(p["inc1"], x)
    x = global_avg_pool(x)
    return x @ p["fc"]["w"] + p["fc"]["b"]


# ---------------------------------------------------------------------------

CNN_ZOO = {
    "squeezenet-dr": (init_squeezenet, apply_squeezenet),
    "alexnet-dr": (init_alexnet, apply_alexnet),
    "vgg-dr": (init_vgg, apply_vgg),
    "inception-dr": (init_inception, apply_inception),
}


def init_cnn(generator: torch.Generator, cfg: ModelConfig):
    return CNN_ZOO[cfg.arch_id][0](generator)


def apply_cnn(params, images, cfg: ModelConfig):
    return CNN_ZOO[cfg.arch_id][1](params, images)
