"""The reference's text-to-image: tokens, text encoders, the initial latent
from the request's seed, the CFG++ loop and the VAE decode, all in float32
(or the control's fp8) with plain PyTorch.

The program under test is the CFG++ engine of the SD and SDXL families; this
follows the same published recipe:

* prompts are tokenized by a hash of each lower-cased word into
  [2, vocab - 2), between BOS (eos - 1) and EOS, padded to 77 with EOS (the
  SDXL second tokenizer pads with 0);
* SD: the context is the text encoder's last hidden state; SDXL: both
  encoders' penultimate hidden states concatenated, the second encoder's
  projected EOS-pooled output and the six micro-conditioning ids
  (resolution, 0, 0, resolution) as the added conditioning;
* the unconditional and the conditional branch in one batch, as two rows;
* zT: one normal draw of [1, h, w, 4] from a generator on the device seeded
  with the request's seed (a request), or of [h, w, 4] seeded from (seed,
  sample index, 0) through numpy's SeedSequence (a sample of a batch), times
  the plan's initial scale;
* the image: decode(z / scaling factor) / 2 + 0.5, clamped to [0, 1].
"""

from __future__ import annotations

import hashlib
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from bench_port.reference import models, solvers
from bench_port.reference.ops import Ops


def tokenize(texts: List[str], vocab: int, eos: int, pad: Optional[int],
             length: int = 77) -> np.ndarray:
    out = np.full((len(texts), length), eos if pad is None else pad, np.int64)
    for i, text in enumerate(texts):
        words = re.sub(r"\s+", " ", text).strip().lower().split()
        ids = [2 + int(hashlib.md5(w.encode()).hexdigest(), 16) % (vocab - 4)
               for w in words][:length - 2]
        row = [eos - 1] + ids + [eos]
        out[i, :len(row)] = row
    return out


def sample_seed(seed: int, index: int, *tags: int) -> int:
    words = np.random.SeedSequence(seed % 2 ** 64,
                                   spawn_key=(index, *tags)).generate_state(2)
    return int(words[0]) << 31 | int(words[1]) >> 1


def initial_latent(shape, seed: int, index: Optional[int], scale: float,
                   device) -> torch.Tensor:
    """zT [1, h, w, 4] of a request (``index`` None) or of sample ``index``
    of a batch."""
    gen = torch.Generator(device=device)
    if index is None:
        gen.manual_seed(seed)
        z = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                        device=device)
    else:
        gen.manual_seed(sample_seed(seed, index, 0))
        z = torch.randn(tuple(shape[1:]), generator=gen, dtype=torch.float32,
                        device=device)[None]
    return z * scale


class Reference:
    """The reference models of one configuration (filled by the caller,
    ``check.reference``); ``quant``: the mix's int8 mode, whose W8A8 sites
    the UNet then computes as the program's recipe says."""

    def __init__(self, config: Dict, device, ops: Optional[Ops] = None,
                 quant: Optional[str] = None):
        self.config = config
        self.device = torch.device(device)
        self.sdxl = "text_encoder_2" in config
        self.unet = models.build("unet", config["unet"], device, ops)
        if quant:
            models.mark_quant_sites(self.unet, quant)
        self.vae = models.build("vae", config["vae"], device, ops)
        self.text = models.build("text_encoder", config["text_encoder"],
                                 device, ops)
        self.text2 = (models.build("text_encoder_2", config["text_encoder_2"],
                                   device, ops) if self.sdxl else None)

    def modules(self) -> Dict[str, torch.nn.Module]:
        out = {"unet": self.unet, "vae": self.vae, "text_encoder": self.text}
        if self.sdxl:
            out["text_encoder_2"] = self.text2
        return out

    def _ids(self, enc: str, texts, pad=None):
        c = self.config[enc]
        return torch.as_tensor(tokenize(texts, c["vocab_size"],
                                        c["eos_token_id"], pad),
                               device=self.device)

    def embed(self, texts: List[str]):
        """(context, pooled or None) of a list of prompts."""
        if not self.sdxl:
            return self.text(self._ids("text_encoder", texts))[0], None
        _, pen1, _ = self.text(self._ids("text_encoder", texts))
        _, pen2, pooled = self.text2(self._ids("text_encoder_2", texts, 0))
        return torch.cat([pen1, pen2], dim=-1), pooled

    @torch.no_grad()
    def image(self, mix: Dict, null_prompt: str, prompt: str, seed: int,
              index: Optional[int] = None) -> torch.Tensor:
        """float32 [H, W, 3] in [0, 1] of one request (or one sample of a
        batch: ``index``)."""
        res = mix["resolution"]
        factor = 2 ** (len(self.config["vae"]["block_out_channels"]) - 1)
        lat = (1, res // factor, res // factor,
               self.config["vae"]["latent_channels"])
        ctx, pooled = self.embed([null_prompt, prompt])
        ids = None
        if self.sdxl:
            ids = torch.tensor([[res, res, 0, 0, res, res]] * 2,
                               dtype=torch.float32, device=self.device)

        def eps_fn(z, t):
            out = self.unet(torch.cat([z, z]), torch.tensor(
                [t], device=self.device), ctx, pooled, ids)
            return out[:1], out[1:]

        scale0 = solvers.plan(mix["solver"], mix["nfe"])[2]
        zT = initial_latent(lat, seed, index, scale0, self.device)
        z = solvers.sample(mix["solver"], mix["nfe"], eps_fn, zT,
                           float(mix["guidance"]))
        x = self.vae(z / self.config["vae"]["scaling_factor"])
        return (x[0] / 2 + 0.5).clamp(0.0, 1.0)
