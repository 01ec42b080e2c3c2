"""Solver registry, counterpart of ``cfgpp_tpu/solvers/registry.py``.

A name -> spec table of the reference's SD solver factory
(`latent_diffusion.py:13-26`).  A spec is declarative: which coefficient
plan, which step kind, CFG vs CFG++, inversion/edit orchestration.  The
port carries the SD family; the SDXL table comes with the SDXL models.
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
    kind: str                       # "ddim" | "euler" | "euler_a" | "dpm2s" | "dpm2m"
    plan_fn: Callable[[DDIMSchedule], plans.SolverPlan]
    cfgpp: bool
    # SDXL dpm++_2m_cfgpp difference-term quirk (latent_sdxl.py:916 vs
    # latent_diffusion.py:863).
    diff_cfgpp_uses_uncond: bool = False
    # Lightning solvers assert cfg_guidance == 1 (latent_sdxl.py:851).
    lightning: bool = False
    inversion: bool = False         # zT by DDIM inversion of src_img
    edit: bool = False              # 3-prompt word-swap editing
    timestep_spacing: str = "leading"


_SD: Dict[str, SolverSpec] = {}


def _sd(name: str, **kw) -> None:
    if name in _SD:
        raise ValueError(f"Solver {name} already registered.")
    _SD[name] = SolverSpec(name=name, family="sd", **kw)


_sd("ddim",                kind="ddim",    plan_fn=plans.plan_ddim,              cfgpp=False)
_sd("euler",               kind="euler",   plan_fn=plans.plan_euler,             cfgpp=False)
_sd("euler_a",             kind="euler_a", plan_fn=plans.plan_euler_ancestral,   cfgpp=False)
_sd("dpm++_2s_a",          kind="dpm2s",   plan_fn=plans.plan_dpmpp_2s_ancestral, cfgpp=False)
_sd("dpm++_2m",            kind="dpm2m",   plan_fn=plans.plan_dpmpp_2m,          cfgpp=False)
_sd("ddim_inversion",      kind="ddim",    plan_fn=plans.plan_ddim,              cfgpp=False, inversion=True)
_sd("ddim_edit",           kind="ddim",    plan_fn=plans.plan_ddim,              cfgpp=False, inversion=True, edit=True)
_sd("ddim_cfg++",          kind="ddim",    plan_fn=plans.plan_ddim,              cfgpp=True)
_sd("euler_cfg++",         kind="euler",   plan_fn=plans.plan_euler,             cfgpp=True)
_sd("euler_a_cfg++",       kind="euler_a", plan_fn=plans.plan_euler_ancestral,   cfgpp=True)
_sd("dpm++_2s_a_cfg++",    kind="dpm2s",   plan_fn=plans.plan_dpmpp_2s_ancestral, cfgpp=True)
_sd("dpm++_2m_cfg++",      kind="dpm2m",   plan_fn=plans.plan_dpmpp_2m,          cfgpp=True)
_sd("ddim_inversion_cfg++", kind="ddim",   plan_fn=plans.plan_ddim,              cfgpp=True, inversion=True)
_sd("ddim_edit_cfg++",     kind="ddim",    plan_fn=plans.plan_ddim,              cfgpp=True, inversion=True, edit=True)

# The SDXL name of the same solver (the reference's naming differs between
# the two families: SD `dpm++_2m_cfg++`, SDXL `dpm++_2m_cfgpp`).
_SD["dpm++_2m_cfgpp"] = _SD["dpm++_2m_cfg++"]


def get_solver_spec(name: str, family: str = "sd") -> SolverSpec:
    if family != "sd" or name not in _SD:
        raise ValueError(f"Solver {name} does not exist for family {family!r} "
                         f"in the PyTorch port. Available: sd {list_solvers()}")
    return _SD[name]


def list_solvers(family: str = "sd"):
    if family != "sd":
        raise ValueError(f"the PyTorch port has no {family!r} solvers yet")
    return sorted(set(_SD))
