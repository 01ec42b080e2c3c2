"""Seeded random weights, drawn on the device in a few large calls and
written into any module that has the published state-dict names: the
program's modules and the reference's alike.

The scales are flax's default initializers, as the program's own random
bundles use them: dense and conv kernels normal with std fan_in^-1/2,
biases 0, norm scales 1, token embeddings std vocab^-1/2, position
embeddings std 0.01.  A parameter of any other module takes the draw its
family declares (``DRAWS``: by parameter name or module type, `normal` or
`constant`); the weight of a norm that has no other parameter (an RMSNorm,
T5's layer norm) is 1; any other parameter raises.  Each top-level group of a
module has its own generator, seeded from (seed, the module's tag in its
family's ``MODULES``, group), and draws its kernels in name order, in
chunks of up to `CHUNK` numbers, in ``draw_dtype``: the dtype the module is
served in.  So the reference, which computes in float32, holds exactly the
values of the program's bfloat16 modules, and it needs only the groups it
has (a decoder without its encoder).
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

CHUNK = 1 << 27
Draw = Tuple[bool, Optional[float]]       # (drawn, std or the constant)


def normal(std: Optional[float] = None) -> Draw:
    """A normal draw of ``std``; None: fan_in^-1/2, the parameter's first
    row's size to the power -1/2, as a dense kernel's."""
    return True, std


def constant(value: float) -> Draw:
    return False, float(value)


def _declared(draws: Mapping, mname: str, m: nn.Module,
              pname: str) -> Optional[Draw]:
    """The draw of a parameter outside the known module types: the
    family's by its full or last name, else by its module's type, else 1
    for a scale-only norm's weight."""
    name = f"{mname}.{pname}" if mname else pname
    for key, draw in draws.items():
        if isinstance(key, str) and (name == key or name.endswith("." + key)):
            return draw
    for key, draw in draws.items():
        if isinstance(key, type) and isinstance(m, key):
            return draw
    own = [n for n, _ in m.named_parameters(recurse=False)]
    if own == ["weight"] and type(m).__name__.endswith("Norm"):
        return constant(1.0)
    return None


def _specs(module: nn.Module, draws: Mapping
           ) -> Dict[str, List[Tuple[str, torch.Tensor, bool, float]]]:
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
        else:
            for pname, p in m.named_parameters(recurse=False):
                draw = _declared(draws, mname, m, pname)
                if draw is not None:
                    drawn, value = draw
                    if drawn and value is None:
                        value = p[0].numel() ** -0.5
                    local.append((pname, p, drawn, value))
        for pname, p, drawn, value in local:
            name = f"{mname}.{pname}" if mname else pname
            groups.setdefault(name.split(".")[0], []).append(
                (name, p, drawn, value))
            seen.add(id(p))
    missed = [n for n, p in module.named_parameters() if id(p) not in seen]
    if missed:
        raise TypeError(f"no initializer for parameters {missed[:5]}")
    return groups


def _group_seed(seed: int, tag: int, group: str) -> int:
    words = np.random.SeedSequence(
        [seed % 2 ** 64, tag, zlib.crc32(group.encode())]
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
def fill_(module: nn.Module, seed: int, name: str, draw_dtype: torch.dtype,
          tags: Mapping[str, int], draws: Optional[Mapping] = None
          ) -> nn.Module:
    """Fill every parameter of ``module``, the family's module ``name``:
    ``tags`` and ``draws`` are the family's ``MODULES`` and ``DRAWS``."""
    device = next(module.parameters()).device
    for group, specs in sorted(_specs(module, draws or {}).items()):
        for _, p, drawn, value in specs:
            if not drawn:
                p.fill_(value)
        gen = torch.Generator(device=device).manual_seed(
            _group_seed(seed, tags[name], group))
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
