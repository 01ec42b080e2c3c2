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

`sample` serves one request (its streams from the seed); `sample_batch`
a batch of prompts with per-sample streams keyed by each sample's global
index (MS-COCO eval generation); both assemble their inputs in `_run`.
Callbacks (``engine/callbacks.py``) are replayed over the kept trajectory
after the loop, or run inside it with ``unrolled=True``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cfgpp_tpu_torch.schedules.ddim import make_ddim_schedule
from cfgpp_tpu_torch.engine.bundle import ModelBundle
from cfgpp_tpu_torch.models.unet import precompute_cross_kv
from cfgpp_tpu_torch.solvers.plans import plan_ddim_inversion
from cfgpp_tpu_torch.solvers.registry import get_solver_spec
from cfgpp_tpu_torch.solvers.sampler import (init_latent,
                                             init_latent_per_sample,
                                             run_inversion, run_solver,
                                             run_solver_unrolled)
from cfgpp_tpu_torch.utils import profiling


def _stream_seed(seed: int, *tags: int) -> int:
    """The seed of one random stream of a request (tags: 1 = the ancestral
    noise of a step, 2 = the encode draw), derived from the request's."""
    words = np.random.SeedSequence([seed % 2**64, *tags]).generate_state(2)
    return int(words[0]) << 31 | int(words[1]) >> 1


def _sample_seed(seed: int, index: int, *tags: int) -> int:
    """The seed of one random stream of sample ``index`` of a batch (tags:
    0 zT, (1, step) the ancestral noise, 2 the encode draw), the
    counterpart of the JAX engine's ``fold_in(fold_in(key, index), tag)``.
    The spawn key puts it in another entropy pool than `_stream_seed`'s,
    so a batch's streams never coincide with a request's."""
    words = np.random.SeedSequence(seed % 2**64,
                                   spawn_key=(index, *tags)).generate_state(2)
    return int(words[0]) << 31 | int(words[1]) >> 1


def _randn(shape, generator, dtype: torch.dtype = torch.float32
           ) -> torch.Tensor:
    """A standard normal draw of ``shape`` from one generator, or from a
    list with one generator per sample (row b from ``generator[b]``)."""
    if isinstance(generator, torch.Generator):
        return torch.randn(tuple(shape), generator=generator, dtype=dtype,
                           device=generator.device)
    return torch.stack([torch.randn(tuple(shape[1:]), generator=g,
                                    dtype=dtype, device=g.device)
                        for g in generator])


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
        with profiling.span("tokenize"):
            ids = self.bundle.tokenizer(list(prompts))
            return torch.as_tensor(np.asarray(ids, np.int64),
                                   device=self.device)

    def tokenize_2(self, prompts: Sequence[str]) -> torch.Tensor:
        with profiling.span("tokenize"):
            ids = self.bundle.tokenizer_2(list(prompts))
            return torch.as_tensor(np.asarray(ids, np.int64),
                                   device=self.device)

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
        with profiling.span("text"):
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
            with profiling.span("unet", len(z)):
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
            with profiling.span("cross_kv"):
                ckv = precompute_cross_kv(unet, ctx)

            def eps_fn(z, t):
                b = z.shape[0]
                out = apply(torch.cat([z, z], dim=0), t, ctx, added, ckv)
                return out[:b], out[b:]
            return eps_fn

        ctx = uc if needs_uc else c
        added = added_uc if needs_uc else added_c
        with profiling.span("cross_kv"):
            ckv = precompute_cross_kv(unet, ctx)

        def eps_fn(z, t):
            out = apply(z, t, ctx, added, ckv)
            return out, out
        return eps_fn

    # ------------------------------------------------------------------- vae
    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        """Per-image decode (a whole-batch decode multiplies the VAE's
        activation memory by the batch) -> float32 images in [0, 1]."""
        imgs = []
        for j, zi in enumerate(z):
            with profiling.span("decode", j):
                imgs.append(self.bundle.vae.decode(self._vae_input(zi[None])))
        return (torch.cat(imgs).float() / 2.0 + 0.5).clamp(0.0, 1.0)

    def _vae_input(self, z: torch.Tensor) -> torch.Tensor:
        """The VAE decoder's input from a latent: z / scaling factor."""
        return z / self.bundle.config.vae.scaling_factor

    def _encode(self, img: torch.Tensor, generator) -> torch.Tensor:
        """VAE encode (f32 compute: it feeds the inversion's source latent)
        and the reparameterized draw from ``generator`` (one for the batch,
        or a list with one per sample), times the VAE's scaling factor."""
        scale = self.bundle.config.vae.scaling_factor
        mean, logvar = self.bundle.vae.encode(img)
        noise = _randn(mean.shape, generator, mean.dtype)
        return (mean + torch.exp(0.5 * logvar) * noise) * scale

    def decode_fn(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """The ``decode`` handed to callbacks: latents [B, h, w, 4] ->
        float32 images in [0, 1] on the device, decoded image by image."""
        def decode(z: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                return self._decode(z)
        return decode

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
        callback_fn: Optional[Callable] = None,
        unrolled: bool = False,
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

        ``callback_fn(step, t, {"z0t", "zt", "decode"})`` (e.g. a
        `ComposeCallback`): by default the loop keeps the trajectory and the
        callback is replayed over it after the loop, so what it returns is
        ignored; with ``unrolled=True`` it runs inside the loop and the
        latents it returns feed the next step (no trajectory then).

        zT, the ancestral solvers' per-step noise and the encode draw come
        from three generators on the device derived from ``seed`` (their
        numbers differ from jax.random's).  Parity hooks replace them:
        ``init_latent_override`` (zT, [B, h, w, 4]), ``noise_override`` (the
        per-step noise, [n_steps, B, h, w, 4]) and ``src_latent_override``
        (the encoded source latent, [B, h, w, 4])."""
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
        with profiling.unit("request", solver=self.solver_name, nfe=self.nfe,
                            batch=batch, resolution=resolution
                            or self.default_resolution()):
            img, traj = self._run(
                nulls=(prompt[0], null_2), slots=slots, slots_2=slots_2,
                batch=batch, cfg_guidance=cfg_guidance, seed=seed,
                sample_indices=None, resolution=resolution, src_img=src_img,
                init_latent_override=init_latent_override,
                noise_override=noise_override,
                src_latent_override=src_latent_override,
                latent_init=latent_init, original_size=original_size,
                crops_coords_top_left=crops_coords_top_left,
                target_size=target_size, clip_skip=clip_skip,
                callback_fn=callback_fn, unrolled=unrolled,
                return_trajectory=return_trajectory)
        return (img, traj) if return_trajectory else img

    @torch.inference_mode()
    def sample_batch(
        self,
        null_prompt: str,
        prompts: Sequence[str],
        cfg_guidance: float = 7.5,
        seed: int = 42,
        resolution: Optional[int] = None,
        sample_indices: Optional[Sequence[int]] = None,
        null_prompt_2: Optional[str] = None,
        prompts_2: Optional[Sequence[str]] = None,
        original_size: Optional[Tuple[int, int]] = None,
        crops_coords_top_left: Tuple[int, int] = (0, 0),
        target_size: Optional[Tuple[int, int]] = None,
        as_numpy: bool = True,
        to_uint8: bool = False,
        src_imgs=None,
        src_prompts: Optional[Sequence[str]] = None,
        callback_fn: Optional[Callable] = None,
        init_latent_override=None,
        noise_override=None,
        src_latent_override=None,
    ):
        """Batched generation, counterpart of the JAX engine's
        ``sample_batch``: B prompts under one null prompt as one batch (the
        reference's serial MS-COCO loop, examples/text_to_mscoco.py:54-62,
        made batched).  Inversion and edit solvers take ``src_imgs`` [B, H,
        W, 3] in [-1, 1], edit solvers also ``src_prompts`` (``prompts``
        are then the targets).  SDXL: ``prompts_2`` / ``null_prompt_2``
        feed encoder 2 (default: ``prompts`` / ``null_prompt``).

        Sample b's zT, ancestral noise and encode draw come from its own
        generators, seeded from (``seed``, its GLOBAL index
        ``sample_indices[b]`` (default b), the stream), so an image does not
        depend on the batch it ran in nor on the process that ran it; these
        streams never coincide with `sample`'s.  Callbacks get the indices
        as ``sample_indices`` and write one record tree per sample.  The
        JAX engine's ``mesh=`` has no counterpart: in one process per GPU
        the caller passes each rank its share (``parallel.shard_indices``).

        ``to_uint8`` converts on the device (``x * 255 + 0.5``, as the JAX
        engine does); ``as_numpy=False`` returns the device tensor without
        waiting for the device, else a numpy array.  The parity hooks are
        `sample`'s."""
        if self.spec.edit and src_prompts is None:
            raise ValueError(f"edit solver {self.solver_name} needs src_prompts")
        batch = len(prompts)
        indices = list(range(batch)) if sample_indices is None else [
            int(i) for i in sample_indices]
        if len(indices) != batch:
            raise ValueError(f"{len(indices)} sample_indices for {batch} prompts")
        slots = self._slots([src_prompts, prompts] if self.spec.edit
                            else [prompts], batch,
                            "src_prompts and prompts must share one batch size")
        null_2, slots_2 = null_prompt, slots
        if prompts_2 is not None or null_prompt_2 is not None:
            null_2 = null_prompt if null_prompt_2 is None else null_prompt_2
            ps2 = prompts if prompts_2 is None else prompts_2
            slots_2 = self._slots([src_prompts, ps2] if self.spec.edit
                                  else [ps2], batch,
                                  "prompts_2 must share the prompt batch size")
        with profiling.unit("batch", solver=self.solver_name, nfe=self.nfe,
                            batch=batch, resolution=resolution
                            or self.default_resolution()):
            img, _ = self._run(
                nulls=(null_prompt, null_2), slots=slots, slots_2=slots_2,
                batch=batch, cfg_guidance=cfg_guidance, seed=seed,
                sample_indices=indices, resolution=resolution,
                src_img=src_imgs, init_latent_override=init_latent_override,
                noise_override=noise_override,
                src_latent_override=src_latent_override, latent_init=None,
                original_size=original_size,
                crops_coords_top_left=crops_coords_top_left,
                target_size=target_size, clip_skip=None,
                callback_fn=callback_fn, unrolled=False,
                return_trajectory=False)
            if to_uint8:
                img = self._to_uint8(img)
            return img.cpu().numpy() if as_numpy else img

    def _run(self, *, nulls: Tuple[str, str], slots: List[List[str]],
             slots_2: List[List[str]], batch: int, cfg_guidance: float,
             seed: int, sample_indices: Optional[List[int]],
             resolution: Optional[int], src_img, init_latent_override,
             noise_override, src_latent_override, latent_init: Optional[str],
             original_size, crops_coords_top_left, target_size,
             clip_skip: Optional[int], callback_fn: Optional[Callable],
             unrolled: bool, return_trajectory: bool):
        """The one runner behind `sample` and `sample_batch` (the JAX
        engine's ``_run``): validation, text embedding, zT (from the
        inversion, an override or the streams), the solver loop, the decode
        and the callback replay.  ``nulls``: the null prompt of encoder 1
        and of encoder 2; ``slots`` / ``slots_2``: each conditional entry
        as ``batch`` prompts, per encoder; ``sample_indices``: None for a
        request's streams from ``seed``, else the global index of each
        sample (`sample_batch`).  Returns (images, trajectory or None)."""
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
        if return_trajectory and unrolled:
            raise ValueError(
                "return_trajectory is not available in unrolled mode (the "
                "unrolled runner exists for MUTATING callbacks and keeps no "
                "trajectory); drop unrolled=True to capture one")
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

        uc, pool_uc = self.text_embed([nulls[0]] * batch, [nulls[1]] * batch,
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
                z0 = self._encode(src, self._generators(seed, sample_indices,
                                                        2))
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
        else:
            zT = self._initial_latent(seed, sample_indices, batch, res,
                                      init_latent_override)
        return self._solve_and_decode(
            eps_fn, zT, cfg_guidance, seed, sample_indices, noise_override,
            callback_fn, unrolled, return_trajectory)

    def _initial_latent(self, seed: int, sample_indices: Optional[List[int]],
                        batch: int, res: int, override) -> torch.Tensor:
        """zT: ``override``, else the request's stream (``sample_indices``
        None) or each sample's (`_generators` tag 0)."""
        if override is not None:
            return self._as_f32(override)
        with profiling.span("init_latent"):
            gens = self._generators(seed, sample_indices, 0)
            shape = self.latent_shape(batch, res)
            return (init_latent(self.plan, gens, shape)
                    if sample_indices is None
                    else init_latent_per_sample(self.plan, gens, shape))

    def _solve_and_decode(self, eps_fn, zT: torch.Tensor, cfg_guidance,
                          seed: int, sample_indices: Optional[List[int]],
                          noise_override, callback_fn: Optional[Callable],
                          unrolled: bool, return_trajectory: bool):
        """The solver loop from zT, the decode and the callback replay;
        returns (images, trajectory or None)."""
        noise_fn = self._noise_fn(seed, zT, noise_override, sample_indices)
        traj = None
        if unrolled:
            final = run_solver_unrolled(self.spec, self.plan, eps_fn, zT,
                                        cfg_guidance, noise_fn=noise_fn,
                                        callback=callback_fn,
                                        decode_fn=self.decode_fn())
        else:
            final, traj = run_solver(
                self.spec, self.plan, eps_fn, zT, cfg_guidance,
                noise_fn=noise_fn,
                return_trajectory=return_trajectory or callback_fn is not None)
        img = self._decode(final)
        if callback_fn is not None and not unrolled:
            self._replay_callbacks(callback_fn, traj, sample_indices)
        return img, traj

    @staticmethod
    def _slots(conds, batch: int, error: str) -> List[List[str]]:
        """Each conditional entry as a list of ``batch`` prompts."""
        slots = [list(p) if isinstance(p, (list, tuple)) else [p] * batch
                 for p in conds]
        if any(len(s) != batch for s in slots):
            raise ValueError(error)
        return slots

    def _generators(self, seed: int, sample_indices: Optional[List[int]],
                    tag: int, *more: int):
        """The generator(s) of one random stream of a run.  ``tag``: 0 zT,
        1 the ancestral noise of step ``more[0]``, 2 the encode draw.  A
        request (``sample_indices`` None) has one generator, seeded with
        ``seed`` for zT and from (seed, tag, step) otherwise; a batch of
        `sample_batch` has one per sample, seeded from (seed, the sample's
        global index, tag, step)."""
        if sample_indices is None:
            s = seed if tag == 0 else _stream_seed(seed, tag, *more)
            return torch.Generator(device=self.device).manual_seed(s)
        return [torch.Generator(device=self.device).manual_seed(
            _sample_seed(seed, i, tag, *more)) for i in sample_indices]

    def _noise_fn(self, seed: int, zT: torch.Tensor, noise_override,
                  sample_indices: Optional[List[int]] = None):
        """The ancestral solvers' ``noise_fn(i, like)``: step i's draw from
        its own generator(s) (`_generators` tag 1), so that it does not
        depend on the steps before it; or row i of ``noise_override``."""
        if not self.plan.needs_noise:
            return None
        if noise_override is not None:
            noise = self._as_f32(noise_override)
            want = (self.plan.n_steps, *zT.shape)
            if tuple(noise.shape) != want:
                raise ValueError(f"noise_override: shape {tuple(noise.shape)},"
                                 f" expected {want}")
            return lambda i, like: noise[i]
        return lambda i, like: _randn(like.shape, self._generators(
            seed, sample_indices, 1, i), like.dtype)

    def _replay_callbacks(self, callback_fn: Callable, traj,
                          sample_indices: Optional[List[int]] = None) -> None:
        """Calls ``callback_fn(step, t, {"z0t", "zt", "decode"})`` over the
        kept trajectory, after the loop (what it returns is ignored);
        ``sample_indices`` (a batch of `sample_batch`) is passed on, so the
        draw callbacks write one record tree per sample
        (examples/text_to_mscoco.py:43-45)."""
        z0s, zts = traj
        decode = self.decode_fn()
        ts = self.plan.coeffs["t"]
        for i in range(self.plan.n_steps):
            kw = {"z0t": z0s[i], "zt": zts[i], "decode": decode}
            if sample_indices is not None:
                kw["sample_indices"] = sample_indices
            callback_fn(i, int(ts[i]), kw)
