"""Solver registry, counterpart of ``cfgpp_tpu/solvers/registry.py``.

The port carries the SD-family DDIM entries so far; the other solver kinds
of the JAX registry come with their step functions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from cfgpp_tpu_torch.schedules.ddim import DDIMSchedule
from cfgpp_tpu_torch.solvers import plans


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    name: str
    family: str                     # "sd" | "sdxl"
    kind: str                       # "ddim"
    plan_fn: Callable[[DDIMSchedule], plans.SolverPlan]
    cfgpp: bool                     # renoise with the unconditional eps
    timestep_spacing: str = "leading"


_SD: Dict[str, SolverSpec] = {
    name: SolverSpec(name=name, family="sd", kind="ddim",
                     plan_fn=plans.plan_ddim, cfgpp=cfgpp)
    for name, cfgpp in (("ddim", False), ("ddim_cfg++", True))
}


def get_solver_spec(name: str, family: str = "sd") -> SolverSpec:
    if family != "sd" or name not in _SD:
        raise ValueError(f"Solver {name} does not exist for family {family!r} "
                         f"in the PyTorch port. Available: sd {sorted(_SD)}")
    return _SD[name]
