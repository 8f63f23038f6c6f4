"""Seeded weights, made on the device in one draw.

Every floating tensor of a module is filled from one ``torch.randn`` of all
their elements together, on a generator seeded with the run's seed, in the
order of the sorted tensor names.  Each tensor gets its own scale by the kind
its name says, so that every layer, the zero-initialized AdaLN and output
projections included, changes the output:

- a matrix or convolution kernel: N(0, 1 / fan_in), fan_in = numel / rows;
- the text embedding table: N(0, 1);
- a bias, a GRN ``beta``: N(0, 0.02^2);
- a GRN or layer-scale ``gamma``: N(0, 0.1^2);
- a norm's weight (LayerNorm ``weight``, RMSNorm ``g``): N(1, 0.1^2).

The program and the plain reference both take their tensors from
``draw(shapes, seed, device)`` by name, so they hold the same numbers.
"""

from __future__ import annotations

import torch


def scale(name: str, shape: tuple) -> tuple[float, float]:
    """(mean, std) of the tensor ``name`` of ``shape``."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("bias", "beta"):
        return 0.0, 0.02
    if leaf == "gamma":
        return 0.0, 0.1
    if len(shape) <= 1:  # a norm's weight or g
        return 1.0, 0.1
    if name.endswith("text_embed.weight"):
        return 0.0, 1.0
    fan_in = 1
    for s in shape[1:]:
        fan_in *= s
    return 0.0, fan_in ** -0.5


def draw(shapes: dict, seed: int, device) -> dict:
    """{name: fp32 tensor on ``device``} for {name: shape}: one randn over
    all elements, sliced and scaled per tensor."""
    names = sorted(shapes)
    sizes = []
    for nm in names:
        n = 1
        for s in shapes[nm]:
            n *= s
        sizes.append(n)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for nm, n in zip(names, sizes):
        mean, std = scale(nm, tuple(shapes[nm]))
        out[nm] = flat[off:off + n].view(tuple(shapes[nm])).mul(std).add_(mean)
        off += n
    return out


def fill_(module: torch.nn.Module, seed: int) -> None:
    """Fill every floating parameter of ``module`` (on its device) from
    ``draw``; each ends up an independent tensor of its own."""
    params = {n: p for n, p in module.named_parameters() if p.is_floating_point()}
    dev = next(iter(params.values())).device
    vals = draw({n: tuple(p.shape) for n, p in params.items()}, seed, dev)
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(vals.pop(n))
