"""Seeded random weights, drawn on the device in a few large calls and
written into any module that has the published state-dict names: the
program's modules and the reference's alike.

The scales are flax's default initializers, as the program's own random
bundles use them: dense and conv kernels normal with std fan_in^-1/2,
biases 0, norm scales 1, token embeddings std vocab^-1/2, position
embeddings std 0.01.  Each top-level group of a module (``down_blocks``,
``decoder``, ...) has its own generator, seeded from (seed, module, group),
and draws its kernels in name order, in chunks of up to `CHUNK` numbers, in
``draw_dtype``: the dtype the module is served in.  So the reference, which
computes in float32, holds exactly the values of the program's bfloat16
UNet, and it needs only the groups it has (the VAE decoder, not its
encoder).
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

CHUNK = 1 << 27
MODULE_TAGS = {"unet": 1, "vae": 2, "text_encoder": 3, "text_encoder_2": 4}


def _specs(module: nn.Module) -> Dict[str, List[Tuple[str, torch.Tensor, bool, float]]]:
    """{group: [(name, parameter, drawn, std if drawn else the constant)]}:
    a norm's weight is 1, a bias 0."""
    groups: Dict[str, list] = {}
    seen = set()
    for mname, m in module.named_modules():
        local = []
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            local.append(("weight", m.weight, True,
                          m.weight[0].numel() ** -0.5))
            if m.bias is not None:
                local.append(("bias", m.bias, False, 0.0))
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            local += [("weight", m.weight, False, 1.0),
                      ("bias", m.bias, False, 0.0)]
        elif isinstance(m, nn.Embedding):
            std = 0.01 if mname.endswith("position_embedding") \
                else m.num_embeddings ** -0.5
            local.append(("weight", m.weight, True, std))
        for pname, p, drawn, value in local:
            name = f"{mname}.{pname}"
            groups.setdefault(name.split(".")[0], []).append(
                (name, p, drawn, value))
            seen.add(id(p))
    missed = [n for n, p in module.named_parameters() if id(p) not in seen]
    if missed:
        raise TypeError(f"no initializer for parameters {missed[:5]}")
    return groups


def _group_seed(seed: int, module: str, group: str) -> int:
    words = np.random.SeedSequence(
        [seed % 2 ** 64, MODULE_TAGS[module], zlib.crc32(group.encode())]
    ).generate_state(2)
    return int(words[0]) << 31 | int(words[1]) >> 1


def _chunks(specs):
    """The drawn parameters in name order, cut into runs of at most
    `CHUNK` numbers (a larger parameter is a run of its own)."""
    run, size = [], 0
    for spec in sorted(specs, key=lambda s: s[0]):
        n = spec[1].numel()
        if run and size + n > CHUNK:
            yield run
            run, size = [], 0
        run.append(spec)
        size += n
    if run:
        yield run


@torch.no_grad()
def fill_(module: nn.Module, seed: int, name: str,
          draw_dtype: torch.dtype) -> nn.Module:
    """Fill every parameter of ``module`` (one of `MODULE_TAGS`)."""
    device = next(module.parameters()).device
    for group, specs in sorted(_specs(module).items()):
        for _, p, drawn, value in specs:
            if not drawn:
                p.fill_(value)
        gen = torch.Generator(device=device).manual_seed(
            _group_seed(seed, name, group))
        for run in _chunks([s for s in specs if s[2]]):
            buf = torch.randn(sum(s[1].numel() for s in run), generator=gen,
                              dtype=draw_dtype, device=device)
            off = 0
            for _, p, _, std in run:
                n = p.numel()
                p.copy_((buf[off:off + n] * std).view(p.shape))
                off += n
            del buf
    return module
