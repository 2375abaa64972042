"""The initial per-client weights, made on the device from the seed.

One ``torch.randn`` call over every parameter of every client, in one
flat fp32 buffer laid out leaf by leaf (sorted paths, the client axis
first), then each leaf's view scaled in place or filled by the first
rule of the configuration's ``init`` that matches its path:

- ``{"match": regex, "kind": "normal", "fan_in_axes": [...], "gain": g}``:
  standard normal times ``sqrt(g / fan_in)``, the fan-in being the
  product of the named axes of one client's leaf;
- ``{"match": regex, "kind": "zeros"}`` or ``"ones"``.

The same seed gives the same weights, bitwise, on one device, so the
reference can make them again after the program has let them go."""
from __future__ import annotations

import math
import re

import torch

from swarmbench.harness.seeds import generator


def _rule(path: str, rules):
    for r in rules:
        if re.search(r["match"], path):
            return r
    raise ValueError(f"no init rule of the configuration matches the leaf {path!r}")


def make_weights(layout, rules, seed: int, device) -> dict:
    """``{path: (N, ...) tensor}`` for ``layout``, a list of ``(path,
    shape)`` pairs (shape with the client axis first). Leaves are views of
    one buffer."""
    sizes = [math.prod(shape) for _, shape in layout]
    flat = torch.randn(sum(sizes), generator=generator(seed, "weights", device),
                       device=device, dtype=torch.float32)
    out, off = {}, 0
    for (path, shape), n in zip(layout, sizes):
        leaf = flat[off:off + n].view(shape)
        off += n
        r = _rule(path, rules)
        if r["kind"] == "normal":
            one = shape[1:]
            fan_in = math.prod(one[a] for a in r["fan_in_axes"])
            leaf.mul_(math.sqrt(r.get("gain", 1.0) / fan_in))
        elif r["kind"] == "zeros":
            leaf.zero_()
        elif r["kind"] == "ones":
            leaf.fill_(1.0)
        else:
            raise ValueError(f"unknown init kind {r['kind']!r}")
        out[path] = leaf
    return out
