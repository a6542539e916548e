"""The initial parameters of a run, made by the benchmark from the seed and
handed alike to the program and to the reference."""
from __future__ import annotations

import math

import torch

WEIGHT_SEED_OFFSET = 1 << 62  # apart from the seeds of the dropout masks


def make_weights(spec: list, seed: int, device) -> dict:
    """{name: f32 tensor on `device`} for a reference's param_spec: one
    uniform draw on the device for every glorot-initialised parameter,
    scaled to U(-limit, limit) with limit = sqrt(6 / (fan_in + fan_out));
    zeros and ones as their init says."""
    device = torch.device(device)
    sizes = [math.prod(shape) for _, shape, init in spec if init[0] == "glorot"]
    gen = torch.Generator(device=device).manual_seed(int(seed) + WEIGHT_SEED_OFFSET)
    u = torch.rand(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for name, shape, init in spec:
        if init[0] == "glorot":
            numel = math.prod(shape)
            limit = math.sqrt(6.0 / (init[1] + init[2]))
            out[name] = ((2.0 * u[off:off + numel] - 1.0) * limit).view(shape).clone()
            off += numel
        elif init[0] == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init[0] == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            raise ValueError(f"unknown init {init!r} of {name}")
    return out
