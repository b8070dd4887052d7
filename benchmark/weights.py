"""Random weights from a seed, made on the device in one draw.

Every leaf is a view of one standard normal drawn by a ``torch.Generator``
on the device, in the order of the sorted leaf names, scaled by its kind:
a matrix or a convolution kernel by ``1 / sqrt(fan_in)`` (the lecun scale
of the models' own initialisers), except those whose names hold one of
``small`` (a model kind's ``SMALL_WEIGHTS``), whose normals have std 0.02;
a norm's scale is ``1 + 0.02 n``; every bias ``0.02 n``.
"""

from __future__ import annotations

import math

import torch


def make(shapes: dict, seed: int, device, small: tuple) -> dict:
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, start = {}, 0
    for name, size in zip(names, sizes):
        shape = shapes[name]
        leaf = flat[start:start + size].view(shape)
        start += size
        if len(shape) > 1:
            std = 0.02 if any(key in name for key in small) else 1.0 / math.sqrt(math.prod(shape[1:]))
            out[name] = leaf.mul_(std)
        elif name.endswith(".weight"):
            out[name] = leaf.mul_(0.02).add_(1.0)
        else:
            out[name] = leaf.mul_(0.02)
    return out
