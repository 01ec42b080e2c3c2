"""Generic sampling loop, counterpart of ``cfgpp_tpu/solvers/sampler.py``.

PyTorch runs eagerly, so the JAX package's ``lax.scan`` over the plan rows
becomes a Python loop over the same rows, with the same body, carry and
extract logic per solver kind.  Two loops share that body: `run_solver`
(optionally keeping the per-step (z0t, zt) trajectory, which the engine
replays to callbacks after the loop) and `run_solver_unrolled`, which calls
a callback inside the loop and feeds the latents it returns back in, as
the reference's callbacks can (``latent_diffusion.py:288-294``).

Ancestral solvers draw per-step noise through ``noise_fn(i, like)``, which
returns step i's standard normal draw shaped like ``like``; step i's noise
must not depend on how many steps came before it.  The engine builds it
from a generator on the latent's device; parity tests pass one that
returns the JAX package's draws.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from cfgpp_tpu_torch.solvers import steps
from cfgpp_tpu_torch.solvers.plans import SolverPlan
from cfgpp_tpu_torch.solvers.registry import SolverSpec
from cfgpp_tpu_torch.utils import profiling

Trajectory = Tuple[torch.Tensor, torch.Tensor]
NoiseFn = Callable[[int, torch.Tensor], torch.Tensor]


def init_latent(plan: SolverPlan, generator: torch.Generator,
                shape: Sequence[int], dtype: torch.dtype = torch.float32
                ) -> torch.Tensor:
    """Draw zT on the generator's device.  VP solvers: standard normal
    (latent_diffusion.py:198-200); VE solvers: scaled by plan.init_scale
    (:201-205)."""
    return torch.randn(tuple(shape), generator=generator, dtype=dtype,
                       device=generator.device) * plan.init_scale


def init_latent_per_sample(plan: SolverPlan,
                           generators: Sequence[torch.Generator],
                           shape: Sequence[int],
                           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Batch init with one generator per sample: sample i's latent depends
    only on ``generators[i]``, not on the batch size or its position in the
    batch; scaled by plan.init_scale as `init_latent` is."""
    if len(generators) != shape[0]:
        raise ValueError(f"{len(generators)} generators for a batch of"
                         f" {shape[0]}")
    return torch.stack([torch.randn(tuple(shape[1:]), generator=g,
                                    dtype=dtype, device=g.device)
                        for g in generators]) * plan.init_scale


def _device_coeffs(plan: SolverPlan, device: torch.device):
    return {k: torch.as_tensor(v, device=device) for k, v in plan.coeffs.items()}


def _make_body(spec: SolverSpec, eps_fn, w, noise_fn: Optional[NoiseFn]):
    """(body, carry0, extract) for the solver kind: body(carry, i, c) ->
    (carry, (z0t, zt)); carry0(zT) makes the first carry; extract(carry)
    reads the running latent back out."""
    kind, cfgpp = spec.kind, spec.cfgpp
    same = lambda z: z  # noqa: E731

    if kind == "ddim":
        def body(zt, i, c):
            zt_next, z0t = steps.ddim_step(eps_fn, w, c, zt, cfgpp=cfgpp)
            return zt_next, (z0t, zt_next)
        return body, same, same
    if kind == "euler":
        def body(x, i, c):
            x_next, den = steps.euler_step(eps_fn, w, c, x, cfgpp=cfgpp)
            return x_next, (den, x_next)
        return body, same, same
    if kind == "euler_a":
        def body(x, i, c):
            x_next, den = steps.euler_ancestral_step(
                eps_fn, w, c, x, noise_fn(i, x), cfgpp=cfgpp)
            return x_next, (den, x_next)
        return body, same, same
    if kind == "dpm2s":
        def body(x, i, c):
            x_next, den = steps.dpmpp_2s_ancestral_step(
                eps_fn, w, c, x, noise_fn(i, x), cfgpp=cfgpp)
            return x_next, (den, x_next)
        return body, same, same
    if kind == "flow":
        def body(x, i, c):
            x_next, x0 = steps.flow_euler_step(eps_fn, w, c, x, cfgpp=cfgpp)
            return x_next, (x0, x_next)
        return body, same, same
    if kind == "dpm2m":
        def body(carry, i, c):
            carry_next, den = steps.dpmpp_2m_step(
                eps_fn, w, c, carry, cfgpp=cfgpp,
                diff_cfgpp_uses_uncond=spec.diff_cfgpp_uses_uncond)
            return carry_next, (den, carry_next[0])
        return body, lambda z: (z, torch.zeros_like(z)), lambda c: c[0]
    raise ValueError(f"unknown solver kind {kind}")


def _check_guidance(spec: SolverSpec, plan: SolverPlan, cfg_guidance,
                    noise_fn: Optional[NoiseFn]) -> None:
    # Lightning distillation is only valid at w == 1 (latent_sdxl.py:851).
    if spec.lightning and float(cfg_guidance) != 1.0:
        raise ValueError(
            "CFG should be turned off (cfg_guidance=1) in the lightning version")
    if plan.needs_noise and noise_fn is None:
        raise ValueError(f"solver {spec.name} is ancestral and needs a noise_fn")


def _tail(spec: SolverSpec, plan: SolverPlan, eps_fn, w, x: torch.Tensor
          ) -> torch.Tensor:
    """DPM++ 2S's eulerized last step, after the loop (a `step` span with
    index ``plan.n_steps``)."""
    with profiling.span("step", plan.n_steps):
        return steps.dpmpp_2s_tail_step(eps_fn, w, plan.tail_coeffs, x,
                                        cfgpp=spec.cfgpp)[0]


def run_solver(spec: SolverSpec, plan: SolverPlan, eps_fn,
               zT: torch.Tensor, cfg_guidance: float,
               noise_fn: Optional[NoiseFn] = None,
               return_trajectory: bool = False
               ) -> Tuple[torch.Tensor, Optional[Trajectory]]:
    """Run the reverse process.  Returns (final latent, trajectory), where
    the trajectory is the stacked per-step (z0t, zt) when asked for: one
    row per loop step (DPM++ 2S: n - 1, its eulerized tail runs after the
    loop and is not a row).  ``final`` is the last denoised estimate
    (plan.final == "z0") or the running latent ("x")."""
    _check_guidance(spec, plan, cfg_guidance, noise_fn)
    coeffs = _device_coeffs(plan, zT.device)
    w = torch.tensor(cfg_guidance, dtype=torch.float32, device=zT.device)
    body, carry0, extract = _make_body(spec, eps_fn, w, noise_fn)

    carry, z0s, zts = carry0(zT), [], []
    for i in range(plan.n_steps):
        with profiling.span("step", i):
            carry, (z0t, zt) = body(carry, i,
                                    {k: v[i] for k, v in coeffs.items()})
        if return_trajectory:
            z0s.append(z0t)
            zts.append(zt)
    x_final = extract(carry)

    if spec.kind == "dpm2s":
        x_final = _tail(spec, plan, eps_fn, w, x_final)

    final = z0t if plan.final == "z0" else x_final
    if return_trajectory:
        return final, (torch.stack(z0s), torch.stack(zts))
    return final, None


def run_solver_unrolled(spec: SolverSpec, plan: SolverPlan, eps_fn,
                        zT: torch.Tensor, cfg_guidance: float,
                        noise_fn: Optional[NoiseFn] = None,
                        callback: Optional[Callable] = None,
                        decode_fn: Optional[Callable] = None) -> torch.Tensor:
    """`run_solver` with ``callback(step, t, {"z0t", "zt", "decode"})``
    called after every step; the (possibly changed) latents it returns
    feed the next step: the running latent becomes its ``zt`` (DPM++ 2M
    keeps its history term), and with plan.final == "z0" its last ``z0t``
    is the result.  Returns the final latent."""
    _check_guidance(spec, plan, cfg_guidance, noise_fn)
    coeffs = _device_coeffs(plan, zT.device)
    w = torch.tensor(cfg_guidance, dtype=torch.float32, device=zT.device)
    body, carry0, extract = _make_body(spec, eps_fn, w, noise_fn)

    carry, z0t = carry0(zT), zT
    for i in range(plan.n_steps):
        with profiling.span("step", i):
            carry, (z0t, zt) = body(carry, i,
                                    {k: v[i] for k, v in coeffs.items()})
        if callback is not None:
            kw = callback(i, int(plan.coeffs["t"][i]),
                          {"z0t": z0t, "zt": zt, "decode": decode_fn})
            z0t, zt = kw["z0t"], kw["zt"]
            carry = (zt, carry[1]) if spec.kind == "dpm2m" else zt
    x_final = extract(carry)

    if spec.kind == "dpm2s":
        x_final = _tail(spec, plan, eps_fn, w, x_final)
    return z0t if plan.final == "z0" else x_final


def run_inversion(spec: SolverSpec, plan: SolverPlan, eps_fn,
                  z0: torch.Tensor, cfg_guidance: float) -> torch.Tensor:
    """DDIM inversion: z0 -> zT over reversed timesteps.  CFG:
    latent_diffusion.py:160-182; CFG++: :888-910.  ``plan`` comes from
    `plans.plan_ddim_inversion`."""
    coeffs = _device_coeffs(plan, z0.device)
    w = torch.tensor(cfg_guidance, dtype=torch.float32, device=z0.device)
    zt = z0
    for i in range(plan.n_steps):
        with profiling.span("step", i):
            zt, _ = steps.ddim_inversion_step(
                eps_fn, w, {k: v[i] for k, v in coeffs.items()}, zt,
                cfgpp=spec.cfgpp)
    return zt
