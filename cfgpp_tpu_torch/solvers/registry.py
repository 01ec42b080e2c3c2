"""Solver registry, counterpart of ``cfgpp_tpu/solvers/registry.py``.

Name -> spec tables of the reference's two solver factories
(`latent_diffusion.py:13-26`, `latent_sdxl.py:15-28`).  A spec is
declarative: which coefficient plan, which step kind, CFG vs CFG++,
inversion/edit orchestration.  The SDXL table holds the 12 solvers of
the JAX one, the 5 SDXL-Lightning ones among them (trailing timestep
spacing; ``DiffusionEngine.sample`` refuses them at w != 1).  The SD3
table (``sd3``, flow matching) has no JAX counterpart: ``flow_euler`` and
``flow_euler_cfg++`` (`steps.flow_euler_step`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from cfgpp_tpu_torch.schedules.ddim import DDIMSchedule
from cfgpp_tpu_torch.solvers import plans


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    name: str
    family: str                     # "sd" | "sdxl" | "sd3"
    kind: str                       # "ddim" | "euler" | "euler_a" | "dpm2s" | "dpm2m" | "flow"
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
_SDXL: Dict[str, SolverSpec] = {}


def _reg(table: Dict[str, SolverSpec], family: str):
    def add(name: str, **kw):
        if name in table:
            raise ValueError(f"Solver {name} already registered.")
        table[name] = SolverSpec(name=name, family=family, **kw)
    return add


_sd = _reg(_SD, "sd")
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

_sx = _reg(_SDXL, "sdxl")
_sx("ddim",                kind="ddim",    plan_fn=plans.plan_ddim,              cfgpp=False)
_sx("euler",               kind="euler",   plan_fn=plans.plan_euler,             cfgpp=False)
_sx("ddim_lightning",      kind="ddim",    plan_fn=plans.plan_ddim,              cfgpp=False, lightning=True, timestep_spacing="trailing")
_sx("euler_lightning",     kind="euler",   plan_fn=plans.plan_euler,             cfgpp=False, lightning=True, timestep_spacing="trailing")
_sx("ddim_edit",           kind="ddim",    plan_fn=plans.plan_ddim,              cfgpp=False, inversion=True, edit=True)
_sx("ddim_cfg++",          kind="ddim",    plan_fn=plans.plan_ddim,              cfgpp=True)
_sx("euler_cfg++",         kind="euler",   plan_fn=plans.plan_euler_vp_sigmas_sdxl, cfgpp=True)
_sx("euler_cfg++_lightning", kind="euler", plan_fn=plans.plan_euler_vp_sigmas_sdxl, cfgpp=True, lightning=True, timestep_spacing="trailing")
_sx("ddim_cfg++_lightning", kind="ddim",   plan_fn=plans.plan_ddim,              cfgpp=True, lightning=True, timestep_spacing="trailing")
_sx("dpm++_2m_cfgpp",      kind="dpm2m",   plan_fn=plans.plan_dpmpp_2m_vp_sdxl,  cfgpp=True, diff_cfgpp_uses_uncond=True)
_sx("dpm++_2m_cfgpp_lightning", kind="dpm2m", plan_fn=plans.plan_dpmpp_2m_vp_sdxl, cfgpp=True, diff_cfgpp_uses_uncond=True, lightning=True, timestep_spacing="trailing")
_sx("ddim_edit_cfg++",     kind="ddim",    plan_fn=plans.plan_ddim,              cfgpp=True, inversion=True, edit=True)

# SD3 (flow matching, velocity model): Euler with CFG, as SD3's pipeline
# samples, and its CFG++ form.
_SD3: Dict[str, SolverSpec] = {}
_s3 = _reg(_SD3, "sd3")
_s3("flow_euler",          kind="flow",    plan_fn=plans.plan_flow_euler,        cfgpp=False)
_s3("flow_euler_cfg++",    kind="flow",    plan_fn=plans.plan_flow_euler,        cfgpp=True)

# The reference names the same solver `dpm++_2m_cfg++` (SD) and
# `dpm++_2m_cfgpp` (SDXL); each table takes both names.
_SD["dpm++_2m_cfgpp"] = _SD["dpm++_2m_cfg++"]
_SDXL["dpm++_2m_cfg++"] = _SDXL["dpm++_2m_cfgpp"]

_TABLES = {"sd": _SD, "sdxl": _SDXL, "sd3": _SD3}


def _table(family: str) -> Dict[str, SolverSpec]:
    if family not in _TABLES:
        raise ValueError(f"unknown model family {family!r}; the port has "
                         f"{sorted(_TABLES)}")
    return _TABLES[family]


def get_solver_spec(name: str, family: str = "sd") -> SolverSpec:
    table = _table(family)
    if name not in table:
        raise ValueError(f"Solver {name} does not exist for family {family!r} "
                         f"in the PyTorch port. Available: {list_solvers(family)}")
    return table[name]


def list_solvers(family: str = "sd"):
    return sorted(set(_table(family)))
