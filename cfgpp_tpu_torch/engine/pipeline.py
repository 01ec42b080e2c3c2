"""DiffusionEngine for the SD family, counterpart of
``cfgpp_tpu/engine/pipeline.py``.

One request: tokenize (host) -> CLIP text encode -> the solver loop, with
cond and uncond fused into one batch-2B UNet call and the cross-attention
k/v hoisted out of the loop -> per-image VAE decode -> float32 NHWC images
in [0, 1].  PyTorch runs eagerly, so there is no compile cache: the JAX
engine's jit per (solver, NFE, resolution, batch, guidance mode) becomes a
plain call.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from cfgpp_tpu_torch.schedules.ddim import make_ddim_schedule
from cfgpp_tpu_torch.engine.bundle import ModelBundle
from cfgpp_tpu_torch.models.unet import precompute_cross_kv
from cfgpp_tpu_torch.solvers.registry import get_solver_spec
from cfgpp_tpu_torch.solvers.sampler import init_latent, run_solver


def _needs_branches(cfgpp: bool, w: float) -> Tuple[bool, bool]:
    """(needs_uncond, needs_cond).  latent_diffusion.py:144-158 semantics."""
    if w == 0.0:
        return True, False
    if w == 1.0 and not cfgpp:
        return False, True
    return True, True


class DiffusionEngine:
    """One (model bundle, solver, NFE) sampling engine on the bundle's
    device."""

    def __init__(self, bundle: ModelBundle, solver: str = "ddim_cfg++",
                 nfe: int = 50):
        self.bundle = bundle
        self.solver_name = solver
        self.nfe = nfe
        self.spec = get_solver_spec(solver, bundle.family)
        self.schedule = make_ddim_schedule(
            nfe, timestep_spacing=self.spec.timestep_spacing)
        self.plan = self.spec.plan_fn(self.schedule)

    @property
    def device(self) -> torch.device:
        return self.bundle.device

    # ------------------------------------------------------------------ host
    def tokenize(self, prompts: Sequence[str]) -> torch.Tensor:
        ids = self.bundle.tokenizer(list(prompts))
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    def default_resolution(self) -> int:
        return self.bundle.config.default_resolution

    def latent_shape(self, batch: int, resolution: int) -> Tuple[int, int, int, int]:
        s = resolution // self.bundle.vae_scale_factor
        return (batch, s, s, self.bundle.latent_channels)

    # ------------------------------------------------------------- embedding
    def _text_embed_sd(self, ids: torch.Tensor) -> torch.Tensor:
        return self.bundle.text_encoder(ids).last_hidden_state

    # ------------------------------------------------------------ eps closure
    def _make_eps_fn(self, uc: torch.Tensor, c: torch.Tensor, w: float,
                     mode: Optional[Tuple[bool, bool]] = None):
        """Batched cond/uncond epsilon function ``eps_fn(z, t) -> (eps_uc,
        eps_c)``.  The cross-attention k/v depend only on the text context,
        so they are computed once here rather than in every UNet call."""
        unet = self.bundle.unet
        needs_uc, needs_c = mode if mode is not None else _needs_branches(
            self.spec.cfgpp, float(w))

        if needs_uc and needs_c:
            ctx = torch.cat([uc, c], dim=0)
            ckv = precompute_cross_kv(unet, ctx)

            def eps_fn(z, t):
                b = z.shape[0]
                out = unet(torch.cat([z, z], dim=0), t, ctx, cross_kv=ckv)
                return out[:b], out[b:]
            return eps_fn

        ctx = uc if needs_uc else c
        ckv = precompute_cross_kv(unet, ctx)

        def eps_fn(z, t):
            out = unet(z, t, ctx, cross_kv=ckv)
            return out, out
        return eps_fn

    # ------------------------------------------------------------------- vae
    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        """Per-image decode (a whole-batch decode multiplies the VAE's
        activation memory by the batch) -> float32 images in [0, 1]."""
        scale = self.bundle.config.vae.scaling_factor
        imgs = [self.bundle.vae.decode(zi[None] / scale) for zi in z]
        return (torch.cat(imgs).float() / 2.0 + 0.5).clamp(0.0, 1.0)

    @staticmethod
    def _to_uint8(img: torch.Tensor) -> torch.Tensor:
        return (img * 255.0 + 0.5).to(torch.uint8)

    # ---------------------------------------------------------------- sample
    @torch.inference_mode()
    def sample(
        self,
        prompt: Sequence,
        cfg_guidance: float = 7.5,
        seed: int = 42,
        resolution: Optional[int] = None,
        init_latent_override=None,
        return_trajectory: bool = False,
    ):
        """Generate images.  ``prompt`` is [null, cond]; cond may be a list
        of B strings, run as one batch.  Returns float32 NHWC images in
        [0, 1] on the bundle's device, and with ``return_trajectory`` also
        the per-step (z0t, zt), each stacked to [NFE, B, h, w, 4].

        ``init_latent_override``: the exact zT to start from (array-like
        [B, h, w, 4]); otherwise zT is drawn from a generator seeded with
        ``seed`` on the device (its numbers differ from jax.random's)."""
        null_p, cond = prompt[0], prompt[1]
        conds = list(cond) if isinstance(cond, (list, tuple)) else [cond]
        batch = len(conds)
        res = resolution or self.default_resolution()

        uc = self._text_embed_sd(self.tokenize([null_p] * batch))
        c = self._text_embed_sd(self.tokenize(conds))
        eps_fn = self._make_eps_fn(uc, c, cfg_guidance)

        if init_latent_override is not None:
            zT = torch.as_tensor(np.asarray(init_latent_override, np.float32),
                                 device=self.device)
        else:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            zT = init_latent(self.plan, gen, self.latent_shape(batch, res))

        final, traj = run_solver(self.spec, self.plan, eps_fn, zT,
                                 cfg_guidance,
                                 return_trajectory=return_trajectory)
        img = self._decode(final)
        return (img, traj) if return_trajectory else img
