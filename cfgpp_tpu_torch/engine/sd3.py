"""Stable Diffusion 3: its bundle (an MMDiT, three text encoders, the
16-channel VAE) and its engine, whose `sample` and `sample_batch` are the
SD / SDXL engine's (`DiffusionEngine`: the same arguments, seeding and
streams, spans and callbacks) over SD3's own parts.  Imported only where
an SD3 bundle is built, so the SD / SDXL path never loads it.

One request: three tokenizers (host) -> CLIP-L and CLIP-G (f32; their
penultimate hidden states side by side, zero-padded to T5's width) and T5
(its last state, after its final norm), the context [77 + T5 tokens,
d_t5] and the pooled vector (both CLIPs' projected pooled outputs) ->
the flow solver loop, both CFG branches in one MMDiT call of 2B rows (no
cross-k/v hoist: the text stream changes in every block) -> per-image
decode of z / scaling + shift -> float32 NHWC images in [0, 1].

Dtypes (`SD3Bundle.empty`), as diffusers serves SD3.5: the MMDiT and T5 in
``dtype`` (bf16 on the card), the CLIP towers f32 as in SDXL, the VAE's
weights f32 decoding in bf16 (f32 when ``dtype`` is f32).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Union

import torch
import torch.nn.functional as F

from cfgpp_tpu_torch.configs_sd3 import SD3BundleConfig, get_sd3_config
from cfgpp_tpu_torch.engine.bundle import _device, _frozen, _random_init_
from cfgpp_tpu_torch.engine.pipeline import DiffusionEngine, _needs_branches
from cfgpp_tpu_torch.models.clip import CLIPTextModel
from cfgpp_tpu_torch.models.mmdit import SD3Transformer2DModel
from cfgpp_tpu_torch.models.t5 import T5EncoderModel
from cfgpp_tpu_torch.models.vae import AutoencoderKL
from cfgpp_tpu_torch.schedules.flow import make_flow_schedule
from cfgpp_tpu_torch.solvers.registry import get_solver_spec
from cfgpp_tpu_torch.utils import profiling
from cfgpp_tpu_torch.weights.t5_tokenizer import T5HashTokenizer
from cfgpp_tpu_torch.weights.tokenizer import load_tokenizer

MODULES = ("transformer", "vae", "text_encoder", "text_encoder_2",
           "text_encoder_3")


def default_dtypes(dtype: torch.dtype) -> Dict[str, torch.dtype]:
    """{module: parameter dtype}, and ``vae_decode_compute``."""
    f32 = torch.float32
    return {"transformer": dtype, "text_encoder_3": dtype,
            "text_encoder": f32, "text_encoder_2": f32, "vae": f32,
            "vae_decode_compute": f32 if dtype == f32 else torch.bfloat16}


@dataclasses.dataclass
class SD3Bundle:
    config: SD3BundleConfig
    transformer: SD3Transformer2DModel
    vae: AutoencoderKL
    text_encoder: CLIPTextModel
    text_encoder_2: CLIPTextModel
    text_encoder_3: T5EncoderModel
    tokenizer: Any
    tokenizer_2: Any
    tokenizer_3: Any

    @property
    def family(self) -> str:
        return self.config.family

    @property
    def latent_channels(self) -> int:
        return self.config.vae.latent_channels

    @property
    def vae_scale_factor(self) -> int:
        return self.config.vae.scale_factor

    @property
    def device(self) -> torch.device:
        return self.transformer.context_embedder.weight.device

    @classmethod
    def empty(cls, config_or_name: Union[str, SD3BundleConfig],
              dtypes: Dict[str, torch.dtype],
              device: Union[str, torch.device]) -> "SD3Bundle":
        """Modules with unfilled parameters on ``device`` in ``dtypes``
        (`default_dtypes`' keys), the position table filled, and the hash
        tokenizers."""
        cfg = (get_sd3_config(config_or_name)
               if isinstance(config_or_name, str) else config_or_name)
        dev = _device(device)
        with torch.device("meta"):
            made = {"transformer": SD3Transformer2DModel(cfg.transformer),
                    "vae": AutoencoderKL(cfg.vae, compute_dtype=dtypes[
                        "vae_decode_compute"]),
                    "text_encoder": CLIPTextModel(cfg.text_encoder),
                    "text_encoder_2": CLIPTextModel(cfg.text_encoder_2),
                    "text_encoder_3": T5EncoderModel(cfg.text_encoder_3)}
        mods = {name: _frozen(m.to(dtypes[name]).to_empty(device=dev))
                for name, m in made.items()}
        mods["transformer"].pos_embed.reset_table()    # to_empty left none
        te, te2 = cfg.text_encoder, cfg.text_encoder_2
        return cls(
            config=cfg, **mods,
            tokenizer=load_tokenizer(None, vocab_size=te.vocab_size,
                                     eos_token_id=te.eos_token_id),
            tokenizer_2=load_tokenizer(None, vocab_size=te2.vocab_size,
                                       eos_token_id=te2.eos_token_id,
                                       pad_token_id=0),
            tokenizer_3=T5HashTokenizer(cfg.text_encoder_3.vocab_size,
                                        cfg.max_sequence_length))

    @classmethod
    def random_init(cls, config_or_name, seed: int, dtype: torch.dtype,
                    device) -> "SD3Bundle":
        """Seeded random weights, drawn on ``device`` from one generator
        (the MMDiT, the VAE, then the three text encoders), at the scales of
        `engine.bundle._random_init_`."""
        bundle = cls.empty(config_or_name, default_dtypes(dtype), device)
        gen = torch.Generator(device=bundle.device).manual_seed(seed)
        for name in MODULES:
            _random_init_(getattr(bundle, name), gen)
        return bundle


class SD3Engine(DiffusionEngine):
    """One (SD3 bundle, flow solver, NFE) sampling engine.  `sample` and
    `sample_batch` take `DiffusionEngine`'s arguments; ``prompt_2`` /
    ``prompts_2`` feed CLIP-G, ``clip_skip`` moves both CLIPs' tap; the
    inversion, the per-step noise and SDXL's micro-conditioning do not
    apply and are refused."""

    def __init__(self, bundle: SD3Bundle, solver: str = "flow_euler_cfg++",
                 nfe: int = 28):
        self.bundle = bundle
        self.solver_name = solver
        self.nfe = nfe
        self.spec = get_solver_spec(solver, bundle.family)
        sch = bundle.config.scheduler
        self.schedule = make_flow_schedule(nfe, sch.shift,
                                           sch.num_train_timesteps)
        self.plan = self.spec.plan_fn(self.schedule)
        self._abar = None

    def tokenize_3(self, prompts: Sequence[str]) -> torch.Tensor:
        with profiling.span("tokenize"):
            ids = self.bundle.tokenizer_3(list(prompts))
            return torch.as_tensor(ids, dtype=torch.int64, device=self.device)

    def text_embed(self, prompts: Sequence[str],
                   prompts_2: Optional[Sequence[str]] = None,
                   clip_skip: Optional[int] = None):
        """(context [B, 77 + T5 tokens, d_t5] f32, pooled [B, 2048] f32)."""
        b = self.bundle
        with profiling.span("text"):
            ids1 = self.tokenize(prompts)
            ids2 = self.tokenize_2(prompts if prompts_2 is None else prompts_2)
            ids3 = self.tokenize_3(prompts)
            with profiling.span("clip"):
                o1 = b.text_encoder(ids1, clip_skip)
                o2 = b.text_encoder_2(ids2, clip_skip)
            with profiling.span("t5"):
                t5 = b.text_encoder_3(ids3).float()
            clip = torch.cat([o1.penultimate_hidden_state,
                              o2.penultimate_hidden_state], dim=-1)
            clip = F.pad(clip, (0, t5.shape[-1] - clip.shape[-1]))
            return (torch.cat([clip, t5], dim=-2),
                    torch.cat([o1.pooled_output, o2.pooled_output], dim=-1))

    def _make_v_fn(self, uc, c, pool_uc, pool_c, mode):
        """``v_fn(x, t) -> (v_uc, v_c)``; both branches in one MMDiT call of
        2B rows where both are needed."""
        transformer = self.bundle.transformer
        p = self.bundle.config.transformer.patch_size
        needs_uc, needs_c = mode

        def apply(x, t, ctx, pooled):
            tokens = x.shape[1] * x.shape[2] // (p * p) + ctx.shape[1]
            with profiling.span("mmdit", (len(x), tokens)):
                return transformer(x, t, ctx, pooled)

        if needs_uc and needs_c:
            ctx, pooled = torch.cat([uc, c]), torch.cat([pool_uc, pool_c])

            def v_fn(x, t):
                out = apply(torch.cat([x, x]), t, ctx, pooled)
                return out[:len(x)], out[len(x):]
            return v_fn
        ctx, pooled = (uc, pool_uc) if needs_uc else (c, pool_c)

        def v_fn(x, t):
            out = apply(x, t, ctx, pooled)
            return out, out
        return v_fn

    def _vae_input(self, z: torch.Tensor) -> torch.Tensor:
        vae = self.bundle.config.vae
        return z / vae.scaling_factor + vae.shift_factor

    def _run(self, *, nulls, slots: List[List[str]],
             slots_2: List[List[str]], batch: int, cfg_guidance: float,
             seed: int, sample_indices: Optional[List[int]],
             resolution: Optional[int], src_img, init_latent_override,
             noise_override, src_latent_override, latent_init,
             original_size, crops_coords_top_left, target_size,
             clip_skip: Optional[int], callback_fn, unrolled: bool,
             return_trajectory: bool):
        refused = {"src_img": src_img, "noise_override": noise_override,
                   "src_latent_override": src_latent_override,
                   "latent_init": latent_init, "original_size": original_size,
                   "target_size": target_size}
        given = sorted(k for k, v in refused.items() if v is not None)
        if tuple(crops_coords_top_left) != (0, 0):
            given.append("crops_coords_top_left")
        if given:
            raise ValueError(f"SD3 takes no {given}")
        if return_trajectory and unrolled:
            raise ValueError("return_trajectory is not available in unrolled "
                             "mode")
        res = resolution or self.default_resolution()
        uc, pool_uc = self.text_embed([nulls[0]] * batch, [nulls[1]] * batch,
                                      clip_skip)
        c, pool_c = self.text_embed(slots[0], slots_2[0], clip_skip)
        v_fn = self._make_v_fn(uc, c, pool_uc, pool_c, _needs_branches(
            self.spec.cfgpp, float(cfg_guidance)))
        zT = self._initial_latent(seed, sample_indices, batch, res,
                                  init_latent_override)
        return self._solve_and_decode(v_fn, zT, cfg_guidance, seed,
                                      sample_indices, None, callback_fn,
                                      unrolled, return_trajectory)
