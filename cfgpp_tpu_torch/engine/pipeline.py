"""DiffusionEngine for the SD and SDXL families, counterpart of
``cfgpp_tpu/engine/pipeline.py``.

One request: tokenize (host) -> CLIP text encode -> the solver loop, with
cond and uncond fused into one batch-2B UNet call and the cross-attention
k/v hoisted out of the loop -> per-image VAE decode -> float32 NHWC images
in [0, 1].  Inversion and edit solvers start the loop from a zT that a DDIM
inversion loop makes from the VAE-encoded source image.  PyTorch runs
eagerly, so there is no compile cache: the JAX engine's jit per (solver,
NFE, resolution, batch, guidance mode) becomes a plain call.

SDXL (``latent_sdxl.py:96-128,187-198``): two text encoders, whose
penultimate (or ``clip_skip``-chosen) hidden states are concatenated into
the context; encoder 2's projected pooled output and the 6 micro-
conditioning ids (``make_add_time_ids``) are the UNet's added conditioning,
fused into the batch-2B pair as the context is.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from cfgpp_tpu_torch.schedules.ddim import make_ddim_schedule
from cfgpp_tpu_torch.engine.bundle import ModelBundle
from cfgpp_tpu_torch.models.unet import precompute_cross_kv
from cfgpp_tpu_torch.solvers.plans import plan_ddim_inversion
from cfgpp_tpu_torch.solvers.registry import get_solver_spec
from cfgpp_tpu_torch.solvers.sampler import (init_latent, run_inversion,
                                             run_solver)


def _stream_seed(seed: int, *tags: int) -> int:
    """The seed of one random stream of a request (tags: 1 = the ancestral
    noise of a step, 2 = the encode draw), derived from the request's."""
    words = np.random.SeedSequence([seed % 2**64, *tags]).generate_state(2)
    return int(words[0]) << 31 | int(words[1]) >> 1


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
        self.inv_plan = plan_ddim_inversion(self.schedule)
        # alpha-bar on the device once, for the v -> eps conversion
        self._abar = None
        if bundle.config.unet.prediction_type == "v_prediction":
            self._abar = torch.as_tensor(self.schedule.alphas_cumprod,
                                         dtype=torch.float32,
                                         device=self.device)

    @property
    def device(self) -> torch.device:
        return self.bundle.device

    # ------------------------------------------------------------------ host
    def tokenize(self, prompts: Sequence[str]) -> torch.Tensor:
        ids = self.bundle.tokenizer(list(prompts))
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    def tokenize_2(self, prompts: Sequence[str]) -> torch.Tensor:
        ids = self.bundle.tokenizer_2(list(prompts))
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    def default_resolution(self) -> int:
        return self.bundle.config.default_resolution

    def latent_shape(self, batch: int, resolution: int) -> Tuple[int, int, int, int]:
        s = resolution // self.bundle.vae_scale_factor
        return (batch, s, s, self.bundle.latent_channels)

    def make_add_time_ids(self, batch: int,
                          original_size: Tuple[int, int],
                          crops_coords_top_left: Tuple[int, int],
                          target_size: Tuple[int, int]) -> np.ndarray:
        """latent_sdxl.py:187-198 incl. the add_embedding width validation."""
        ids = list(original_size) + list(crops_coords_top_left) + list(target_size)
        cfg = self.bundle.config.unet
        expected = cfg.projection_class_embeddings_input_dim
        passed = cfg.addition_time_embed_dim * len(ids) + \
            self.bundle.config.text_encoder_2.projection_dim
        if expected != passed:
            raise ValueError(
                f"Model expects an added time embedding vector of length {expected}, "
                f"but a vector of {passed} was created.")
        return np.tile(np.asarray(ids, np.float32)[None], (batch, 1))

    # ------------------------------------------------------------- embedding
    def _text_embed_sd(self, ids: torch.Tensor) -> torch.Tensor:
        return self.bundle.text_encoder(ids).last_hidden_state

    def _text_embed_sdxl(self, ids1: torch.Tensor, ids2: torch.Tensor,
                         clip_skip: Optional[int] = None):
        """Dual-encoder embed (latent_sdxl.py:96-128): penultimate (or
        clip_skip-selected) hidden states concatenated on the feature dim;
        pooled ALWAYS from encoder-2."""
        o1 = self.bundle.text_encoder(ids1, clip_skip)
        o2 = self.bundle.text_encoder_2(ids2, clip_skip)
        embeds = torch.cat([o1.penultimate_hidden_state,
                            o2.penultimate_hidden_state], dim=-1)
        return embeds, o2.pooled_output

    def text_embed(self, prompts: Sequence[str],
                   prompts_2: Optional[Sequence[str]] = None,
                   clip_skip: Optional[int] = None):
        """(context, pooled) of a batch of prompts: pooled is None for the
        SD family; SDXL's encoder 2 reads ``prompts_2`` (default: the same
        prompts)."""
        if self.bundle.family != "sdxl":
            return self._text_embed_sd(self.tokenize(prompts)), None
        return self._text_embed_sdxl(
            self.tokenize(prompts),
            self.tokenize_2(prompts if prompts_2 is None else prompts_2),
            clip_skip)

    # ------------------------------------------------------------ eps closure
    def _make_eps_fn(self, uc: torch.Tensor, c: torch.Tensor, w: float,
                     added_uc: Optional[Tuple] = None,
                     added_c: Optional[Tuple] = None,
                     mode: Optional[Tuple[bool, bool]] = None):
        """Batched cond/uncond epsilon function ``eps_fn(z, t) -> (eps_uc,
        eps_c)``.  ``added_uc``/``added_c``: SDXL's (pooled text embeds,
        time ids) of each branch, concatenated into the pair as the context
        is.  The cross-attention k/v depend only on the text context, so
        they are computed once here rather than in every UNet call.  A
        v-prediction UNet's output becomes eps at this boundary, in f32
        (``cfgpp_tpu/engine/pipeline.py:135-140``): ``eps = sqrt(abar_t) v
        + sqrt(1 - abar_t) z``, so every solver, the inversion and the edit
        see eps."""
        unet = self.bundle.unet
        needs_uc, needs_c = mode if mode is not None else _needs_branches(
            self.spec.cfgpp, float(w))

        def apply(z, t, ctx, added, ckv):
            out = unet(z, t, ctx, *(added or ()), cross_kv=ckv)
            if self._abar is None:
                return out
            a = self._abar[torch.as_tensor(t, device=z.device).long().clamp(
                0, self._abar.shape[0] - 1)]
            a = a.reshape((-1,) + (1,) * (z.ndim - 1))
            return torch.sqrt(a) * out + torch.sqrt(1.0 - a) * z.float()

        if needs_uc and needs_c:
            ctx = torch.cat([uc, c], dim=0)
            added = None
            if added_uc is not None:
                added = tuple(torch.cat([a, b], dim=0)
                              for a, b in zip(added_uc, added_c))
            ckv = precompute_cross_kv(unet, ctx)

            def eps_fn(z, t):
                b = z.shape[0]
                out = apply(torch.cat([z, z], dim=0), t, ctx, added, ckv)
                return out[:b], out[b:]
            return eps_fn

        ctx = uc if needs_uc else c
        added = added_uc if needs_uc else added_c
        ckv = precompute_cross_kv(unet, ctx)

        def eps_fn(z, t):
            out = apply(z, t, ctx, added, ckv)
            return out, out
        return eps_fn

    # ------------------------------------------------------------------- vae
    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        """Per-image decode (a whole-batch decode multiplies the VAE's
        activation memory by the batch) -> float32 images in [0, 1]."""
        scale = self.bundle.config.vae.scaling_factor
        imgs = [self.bundle.vae.decode(zi[None] / scale) for zi in z]
        return (torch.cat(imgs).float() / 2.0 + 0.5).clamp(0.0, 1.0)

    def _encode(self, img: torch.Tensor, generator: torch.Generator
                ) -> torch.Tensor:
        """VAE encode (f32 compute: it feeds the inversion's source latent)
        and the reparameterized draw from ``generator``, times the VAE's
        scaling factor."""
        scale = self.bundle.config.vae.scaling_factor
        mean, logvar = self.bundle.vae.encode(img)
        noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                            device=mean.device)
        return (mean + torch.exp(0.5 * logvar) * noise) * scale

    @staticmethod
    def _to_uint8(img: torch.Tensor) -> torch.Tensor:
        return (img * 255.0 + 0.5).to(torch.uint8)

    # ---------------------------------------------------------------- sample
    def _as_f32(self, x) -> torch.Tensor:
        """An array-like or tensor -> an f32 tensor on the bundle's device."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    @torch.inference_mode()
    def sample(
        self,
        prompt: Sequence,
        cfg_guidance: float = 7.5,
        seed: int = 42,
        resolution: Optional[int] = None,
        src_img=None,
        init_latent_override=None,
        return_trajectory: bool = False,
        latent_init: Optional[str] = None,
        src_latent_override=None,
        noise_override=None,
        prompt_2: Optional[Sequence] = None,
        original_size: Optional[Tuple[int, int]] = None,
        crops_coords_top_left: Tuple[int, int] = (0, 0),
        target_size: Optional[Tuple[int, int]] = None,
        clip_skip: Optional[int] = None,
    ):
        """Generate images.  ``prompt`` is [null, cond], or [null, src, tgt]
        for edit solvers; each conditional entry may be a list of B strings,
        run as one batch.  Returns float32 NHWC images in [0, 1] on the
        bundle's device, and with ``return_trajectory`` also the per-step
        (z0t, zt), each stacked to [n_steps, B, h, w, 4].

        SDXL only: ``prompt_2`` (laid out as ``prompt``) feeds encoder 2
        (default: ``prompt``); ``original_size`` and ``target_size``
        (default: (resolution, resolution)) and ``crops_coords_top_left``
        are the micro-conditioning; ``clip_skip`` moves both encoders' tap
        (refused for the SD family, whose context is the last layer).

        Inversion solvers need ``src_img`` ([B, H, W, 3] in [-1, 1]): it is
        VAE-encoded, inverted to zT with the source prompt and resampled
        with the (target) prompt.  ``latent_init``: "ddim" (the default:
        invert with the null prompt) or "npi" (negative-prompt inversion,
        latent_diffusion.py:195-197: the source prompt serves as the null
        prompt at w=1, a single-branch forward).

        zT, the ancestral solvers' per-step noise and the encode draw come
        from three generators on the device derived from ``seed`` (their
        numbers differ from jax.random's).  Parity hooks replace them:
        ``init_latent_override`` (zT, [B, h, w, 4]), ``noise_override`` (the
        per-step noise, [n_steps, B, h, w, 4]) and ``src_latent_override``
        (the encoded source latent, [B, h, w, 4])."""
        sdxl = self.bundle.family == "sdxl"
        if self.spec.lightning:
            if float(cfg_guidance) != 1.0:
                # cfgpp_tpu/engine/pipeline.py:389-391, before any work
                raise ValueError("CFG should be turned off (cfg_guidance=1) "
                                 "in the lightning version")
            cfg_guidance = 1.0     # the literal, as the JAX core uses
        if clip_skip is not None and not sdxl:
            # the reference supports clip_skip only on the SDXL dual-encoder
            # path (latent_sdxl.py:88-92)
            raise ValueError("clip_skip is an SDXL-only option "
                             "(latent_sdxl.py:88-92); the SD family always "
                             "uses the final layer")
        if latent_init not in (None, "ddim", "npi"):
            raise ValueError(f"unknown latent_init {latent_init!r}")
        if latent_init == "npi" and not self.spec.inversion:
            raise ValueError("latent_init='npi' requires an inversion solver")
        conds = prompt[1:3] if self.spec.edit else prompt[1:2]
        batch = max(len(p) if isinstance(p, (list, tuple)) else 1
                    for p in conds)
        slots = self._slots(conds, batch, "prompt lists must share one batch "
                            "size")
        null_2, slots_2 = prompt[0], slots
        if prompt_2 is not None:
            null_2 = prompt_2[0]
            slots_2 = self._slots(
                prompt_2[1:3] if self.spec.edit else prompt_2[1:2], batch,
                "prompt_2 lists must share the prompt batch size")
        src = None
        if self.spec.inversion:
            if src_img is None:
                raise ValueError(f"solver {self.solver_name} needs src_imgs")
            src = self._as_f32(src_img)
            if src.shape[0] != batch:
                raise ValueError(f"{src.shape[0]} src imgs vs batch {batch}")
        res = resolution or self.default_resolution()
        time_ids = None
        if sdxl:
            time_ids = torch.as_tensor(self.make_add_time_ids(
                batch, original_size or (res, res), crops_coords_top_left,
                target_size or (res, res)), device=self.device)

        uc, pool_uc = self.text_embed([prompt[0]] * batch, [null_2] * batch,
                                      clip_skip)
        cs, pool_cs = zip(*(self.text_embed(s, s2, clip_skip)
                            for s, s2 in zip(slots, slots_2)))

        def added_for(pool_uc, pool_c):
            if not sdxl:
                return None, None
            return (pool_uc, time_ids), (pool_c, time_ids)

        mode = _needs_branches(self.spec.cfgpp, float(cfg_guidance))
        # edit solvers invert with the source prompt (cs[0]) and sample with
        # the target (cs[-1]); the others have one prompt for both
        eps_fn = self._make_eps_fn(uc, cs[-1], cfg_guidance,
                                   *added_for(pool_uc, pool_cs[-1]), mode=mode)

        if self.spec.inversion:
            if src_latent_override is not None:
                z0 = self._as_f32(src_latent_override)
            else:
                gen = torch.Generator(device=self.device).manual_seed(
                    _stream_seed(seed, 2))
                z0 = self._encode(src, gen)
            added_uc_inv, added_c_inv = added_for(pool_uc, pool_cs[0])
            if latent_init == "npi":
                inv_eps = self._make_eps_fn(cs[0], cs[0], 1.0, added_c_inv,
                                            added_c_inv, mode=(True, False))
                zT = run_inversion(self.spec, self.inv_plan, inv_eps, z0, 1.0)
            else:
                inv_eps = self._make_eps_fn(uc, cs[0], cfg_guidance,
                                            added_uc_inv, added_c_inv,
                                            mode=mode)
                zT = run_inversion(self.spec, self.inv_plan, inv_eps, z0,
                                   cfg_guidance)
        elif init_latent_override is not None:
            zT = self._as_f32(init_latent_override)
        else:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            zT = init_latent(self.plan, gen, self.latent_shape(batch, res))

        final, traj = run_solver(self.spec, self.plan, eps_fn, zT,
                                 cfg_guidance,
                                 noise_fn=self._noise_fn(seed, zT,
                                                         noise_override),
                                 return_trajectory=return_trajectory)
        img = self._decode(final)
        return (img, traj) if return_trajectory else img

    @staticmethod
    def _slots(conds, batch: int, error: str) -> List[List[str]]:
        """Each conditional entry as a list of ``batch`` prompts."""
        slots = [list(p) if isinstance(p, (list, tuple)) else [p] * batch
                 for p in conds]
        if any(len(s) != batch for s in slots):
            raise ValueError(error)
        return slots

    def _noise_fn(self, seed: int, zT: torch.Tensor, noise_override):
        """The ancestral solvers' ``noise_fn(i, like)``: step i's draw from
        a generator seeded from (seed, i), so that it does not depend on the
        steps before it; or row i of ``noise_override``."""
        if not self.plan.needs_noise:
            return None
        if noise_override is not None:
            noise = self._as_f32(noise_override)
            want = (self.plan.n_steps, *zT.shape)
            if tuple(noise.shape) != want:
                raise ValueError(f"noise_override: shape {tuple(noise.shape)},"
                                 f" expected {want}")
            return lambda i, like: noise[i]
        gen = torch.Generator(device=self.device)

        def noise_fn(i, like):
            gen.manual_seed(_stream_seed(seed, 1, i))
            return torch.randn(like.shape, generator=gen, dtype=like.dtype,
                               device=like.device)
        return noise_fn
