"""A toy model family that exists only in the tests, to show that a family
enters the harness with files of its own: a small joint-attention
denoiser (image patches and text tokens in one attention, per-head RMSNorm
on q and k, adaLN modulation from the time) over the port's ``tiny_sd``
text tower and VAE, sampled by a rectified-flow loop with the CFG++ flow
form: x0 from the guided velocity, renoised with the unconditional noise
estimate.

The program is `Engine` over the port's `CLIPTextModel` and
`AutoencoderKL` and this file's `Denoiser` in the dtype the configuration
serves it in; the reference is the plain float32 CLIP and VAE decoder of
``bench_port/reference/models.py``, the same `Denoiser` in float32 and its
own loop.  The test puts this folder among ``families.ROOTS``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bench_port import weights
from bench_port.families.sd_unet.flops import clip_flops, vae_decode_flops
from bench_port.reference import models
from bench_port.reference.models import set_ops
from bench_port.reference.ops import F32
from bench_port.reference.pipeline import initial_latent, tokenize

__all__ = ["MODULES", "DRAWS", "check_config", "build", "with_nfe", "spans",
           "reference", "set_ops", "compute_dtypes", "unit_flops",
           "attention_sites"]

MODULES = {"denoiser": 5, "vae": 2, "text_encoder": 3}
DRAWS = {"pos": weights.normal(0.02)}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
TOKENS = 77


class Denoiser(models._Mod):
    """forward(x [B, h, w, C] NHWC, sigma [B] or scalar, ctx [B, 77, D])
    -> the velocity [B, h, w, C]; every product through ``self.ops``."""

    def __init__(self, c: Dict):
        super().__init__()
        self.c = c
        d, p, ch = c["hidden_size"], c["patch_size"], c["in_channels"]
        n = (c["sample_size"] // p) ** 2
        self.x_embed = models.Linear(ch * p * p, d)
        self.pos = nn.Parameter(torch.empty(1, n, d))
        self.ctx_embed = models.Linear(c["context_dim"], d)
        self.t_embed = models.MLP2(d, d)
        self.blocks = nn.ModuleList([Block(d, c["num_heads"])
                                     for _ in range(c["num_layers"])])
        self.norm_out = nn.RMSNorm(d, eps=1e-6)
        self.proj_out = models.Linear(d, ch * p * p)

    def forward(self, x, sigma, ctx):
        b, h, w, ch = x.shape
        p = self.c["patch_size"]
        t = x.reshape(b, h // p, p, w // p, p, ch).permute(0, 1, 3, 2, 4, 5)
        t = self.x_embed(t.reshape(b, -1, p * p * ch)) + self.pos.to(x.dtype)
        sigma = torch.as_tensor(sigma, device=x.device).reshape(-1).expand(b)
        emb = self.t_embed(models.timestep_embedding(
            1000.0 * sigma, self.c["hidden_size"], True, 0).to(x.dtype))
        c = self.ctx_embed(ctx)
        for blk in self.blocks:
            t, c = blk(t, c, emb)
        out = self.proj_out(self.norm_out(t))
        out = out.reshape(b, h // p, w // p, p, p, ch)
        return out.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, ch)


class Block(models._Mod):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.mod = models.Linear(d, 4 * d)
        self.qkv = models.Linear(d, 3 * d)
        self.ctx_qkv = models.Linear(d, 3 * d)
        self.norm_q = nn.RMSNorm(d // heads, eps=1e-6)
        self.norm_k = nn.RMSNorm(d // heads, eps=1e-6)
        self.out = models.Linear(d, d)
        self.ctx_out = models.Linear(d, d)
        self.fc1 = models.Linear(d, 4 * d)
        self.fc2 = models.Linear(4 * d, d)

    def forward(self, x, c, emb):
        b, n, d = x.shape
        shift, scale, gate, gate2 = self.mod(F.silu(emb))[:, None].chunk(4, -1)
        y = F.layer_norm(x, (d,)) * (1 + scale) + shift
        q, k, v = torch.cat([self.qkv(y), self.ctx_qkv(
            F.layer_norm(c, (d,)))], dim=1).chunk(3, -1)
        dh = d // self.heads

        def heads_normed(u, norm):
            m = u.shape[1]
            return norm(u.reshape(b, m, self.heads, dh)).reshape(b, m, d)
        a = models.attention(self.ops, heads_normed(q, self.norm_q),
                             heads_normed(k, self.norm_k), v, self.heads)
        x = x + gate * self.out(a[:, :n])
        c = c + self.ctx_out(a[:, n:])
        h = self.fc1(F.layer_norm(x, (d,)))
        return x + gate2 * self.fc2(F.gelu(h)), c


def sigmas(nfe: int, shift: float) -> np.ndarray:
    """nfe + 1 noise levels from 1 to 0, shifted toward 1."""
    s = np.linspace(1.0, 0.0, nfe + 1)
    return shift * s / (1.0 + (shift - 1.0) * s)


def step(x, s: float, s_next: float, v_u, v_c, w: float):
    """One CFG++ flow step: (the next x, the guided x0)."""
    x0 = x - s * (v_u + w * (v_c - v_u))
    eps_u = x + (1.0 - s) * v_u
    return (1.0 - s_next) * x0 + s_next * eps_u, x0


# -------------------------------------------------------------- the program
class Engine:
    def __init__(self, config, text_encoder, tokenizer, denoiser, vae, nfe):
        self.config, self.nfe = config, nfe
        self.text_encoder, self.tokenizer = text_encoder, tokenizer
        self.denoiser, self.vae = denoiser, vae
        self.device = next(denoiser.parameters()).device
        self.dtype = next(denoiser.parameters()).dtype

    def text_embed(self, prompts: List[str]) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(self.tokenizer(list(prompts)),
                                         np.int64), device=self.device)
        return self.text_encoder(ids).last_hidden_state

    @torch.inference_mode()
    def sample(self, prompt, cfg_guidance: float, seed: int,
               resolution: int) -> torch.Tensor:
        """[null, prompt] -> float32 [1, H, W, 3] in [0, 1]."""
        ctx = torch.cat([self.text_embed([prompt[0]]),
                         self.text_embed([prompt[1]])]).to(self.dtype)
        vae = self.config["vae"]
        h = resolution // 2 ** (len(vae["block_out_channels"]) - 1)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        x = torch.randn((1, h, h, vae["latent_channels"]), generator=gen,
                        dtype=torch.float32, device=self.device)
        levels = sigmas(self.nfe, self.config["denoiser"]["shift"])
        for s, s_next in zip(levels[:-1], levels[1:]):
            v = self.denoiser(torch.cat([x, x]).to(self.dtype),
                              torch.tensor([s], device=self.device),
                              ctx).float()
            x, x0 = step(x, float(s), float(s_next), v[:1], v[1:],
                         float(cfg_guidance))
        img = self.vae.decode(x0 / vae["scaling_factor"])
        return (img.float() / 2.0 + 0.5).clamp(0.0, 1.0)


def check_config(config: Dict) -> None:
    """The text tower and the VAE are the port's preset's, key by key."""
    from cfgpp_tpu_torch.configs import get_bundle_config
    port = get_bundle_config(config["preset"])
    for part in ("vae", "text_encoder"):
        for key, value in config[part].items():
            got = getattr(getattr(port, part), key)
            if (list(got) if isinstance(got, tuple) else got) != value:
                raise ValueError(f"{config['name']}.{part}.{key}: {got!r}")


def build(config: Dict, mix: Dict, seed: int, device) -> Engine:
    from cfgpp_tpu_torch.configs import get_bundle_config
    from cfgpp_tpu_torch.models.clip import CLIPTextModel
    from cfgpp_tpu_torch.models.vae import AutoencoderKL
    from cfgpp_tpu_torch.weights.tokenizer import load_tokenizer

    cfg = get_bundle_config(config["preset"])
    dt = {k: DTYPES[v] for k, v in config["dtypes"].items()}
    with torch.device("meta"):
        made = {"text_encoder": CLIPTextModel(cfg.text_encoder),
                "denoiser": Denoiser(config["denoiser"]),
                "vae": AutoencoderKL(cfg.vae, compute_dtype=dt[
                    "vae_decode_compute"])}
    mods = {}
    for name, m in made.items():
        m = m.to(dt[name]).to_empty(device=device).eval().requires_grad_(False)
        mods[name] = weights.fill_(m, seed, name, dt[name], MODULES, DRAWS)
    tok = load_tokenizer(None, vocab_size=cfg.text_encoder.vocab_size,
                         eos_token_id=cfg.text_encoder.eos_token_id)
    return Engine(config, mods["text_encoder"], tok, mods["denoiser"],
                  mods["vae"], mix["nfe"])


def with_nfe(engine: Engine, mix: Dict, nfe: int) -> Engine:
    return Engine(engine.config, engine.text_encoder, engine.tokenizer,
                  engine.denoiser, engine.vae, nfe)


def spans(program):
    e = program.engine
    return [(e, "text_embed", "text"), (e.denoiser, "forward", "denoise"),
            (e.vae, "decode", "vae")]


# ------------------------------------------------------------ the reference
class Reference:
    def __init__(self, config: Dict, device, ops=None):
        self.config, self.device = config, torch.device(device)
        self.text = models.build("text_encoder", config["text_encoder"],
                                 device, ops)
        self.vae = models.build("vae", config["vae"], device, ops)
        with torch.device("meta"):
            d = Denoiser(config["denoiser"])
        self.denoiser = set_ops(d.to_empty(device=device).eval()
                                .requires_grad_(False), ops or F32)

    def modules(self) -> Dict[str, nn.Module]:
        return {"denoiser": self.denoiser, "vae": self.vae,
                "text_encoder": self.text}

    @torch.no_grad()
    def image(self, mix: Dict, null_prompt: str, prompt: str, seed: int,
              index=None) -> torch.Tensor:
        c = self.config["text_encoder"]
        ids = torch.as_tensor(tokenize([null_prompt, prompt], c["vocab_size"],
                                       c["eos_token_id"], None),
                              device=self.device)
        ctx = self.text(ids)[0]
        vae = self.config["vae"]
        h = mix["resolution"] // 2 ** (len(vae["block_out_channels"]) - 1)
        x = initial_latent((1, h, h, vae["latent_channels"]), seed, index,
                           1.0, self.device)
        w = float(mix["guidance"])
        levels = sigmas(mix["nfe"], self.config["denoiser"]["shift"])
        for s, s_next in zip(levels[:-1], levels[1:]):
            v = self.denoiser(torch.cat([x, x]), torch.tensor(
                [float(s)], device=self.device), ctx)
            v_u, v_c = v[:1], v[1:]
            x0 = x - float(s) * (v_u + w * (v_c - v_u))
            x = (1 - float(s_next)) * x0 + float(s_next) * (
                x + (1 - float(s)) * v_u)
        img = self.vae(x0 / vae["scaling_factor"])
        return (img[0] / 2 + 0.5).clamp(0.0, 1.0)


def reference(config: Dict, device, ops=None, quant=None) -> Reference:
    if quant:
        raise ValueError("the toy family has no int8 mode")
    return Reference(config, device, ops)


def compute_dtypes(config: Dict) -> Dict[str, str]:
    dtypes = config["dtypes"]
    return {"denoiser": dtypes["denoiser"], "text_encoder":
            dtypes["text_encoder"], "vae": dtypes["vae_decode_compute"]}


# -------------------------------------------------------------------- FLOPs
def denoiser_flops(c: Dict, batch: int) -> float:
    d, p, ch = c["hidden_size"], c["patch_size"], c["in_channels"]
    n = (c["sample_size"] // p) ** 2
    m = n + TOKENS

    def mm(rows, i, o):
        return 2.0 * rows * i * o
    total = mm(batch * n, ch * p * p, d) + mm(batch * TOKENS,
                                                c["context_dim"], d)
    total += 2 * mm(batch, d, d)                                # t_embed
    per_layer = (mm(batch, d, 4 * d) + mm(batch * m, d, 3 * d)
                 + 2.0 * 2 * batch * m * m * d                  # attention
                 + mm(batch * m, d, d) + 2 * mm(batch * n, d, 4 * d))
    return total + c["num_layers"] * per_layer + mm(batch * n, d, ch * p * p)


def unit_flops(config: Dict, mix: Dict) -> float:
    """One request: the text encodes of the null and the prompt, every
    denoiser call at batch 2, one decode."""
    hw = mix["resolution"] // 2 ** (len(config["vae"]["block_out_channels"])
                                    - 1)
    return (clip_flops(config["text_encoder"], 2)
            + mix["nfe"] * denoiser_flops(config["denoiser"], 2)
            + vae_decode_flops(config["vae"], hw))


def attention_sites(config: Dict, mix: Dict):
    c = config["denoiser"]
    m = (c["sample_size"] // c["patch_size"]) ** 2 + TOKENS
    hw = mix["resolution"] // 2 ** (len(config["vae"]["block_out_channels"])
                                    - 1)
    ch = config["vae"]["block_out_channels"][-1]
    return [(2, m, m, c["num_heads"], c["hidden_size"] // c["num_heads"],
             c["num_layers"] * mix["nfe"]),
            (1, hw * hw, hw * hw, 1, ch, 1)]
