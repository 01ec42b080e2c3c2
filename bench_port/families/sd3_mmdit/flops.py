"""FLOPs of a unit of the SD3 family, from its configuration file alone:
matrix products and convolutions at 2 FLOPs a multiply-add, as
``torch.utils.flop_counter.FlopCounterMode`` counts the reference.  The
CLIP towers and the VAE decoder are counted by the SD / SDXL family's
functions (``families/sd_unet/flops.py``); SD3's decoder has no post-quant
conv, so its 1x1 conv is taken out."""

from __future__ import annotations

from typing import Dict, List, Tuple

from bench_port.families.sd_unet.flops import (clip_flops, latent_hw,
                                               vae_decode_flops)

CLIP_TOKENS = 77


def _mm(rows, cin, cout) -> float:
    return 2.0 * rows * cin * cout


def mmdit_call_flops(c: Dict, batch: int, image_tokens: int,
                     text_tokens: int) -> Dict[str, float]:
    """One MMDiT call of ``batch`` rows: {"linear", "attn", "total"}."""
    d = c["num_attention_heads"] * c["attention_head_dim"]
    p2c = c["patch_size"] ** 2 * c["in_channels"]
    b, n, m = batch, image_tokens, text_tokens
    linear = (_mm(b * n, p2c, d)                              # patch conv
              + _mm(b, 256, d) + _mm(b, d, d)                 # time
              + _mm(b, c["pooled_projection_dim"], d) + _mm(b, d, d)
              + _mm(b * m, c["joint_attention_dim"], d)       # context
              + _mm(b, d, 2 * d)                              # norm_out
              + _mm(b * n, d, p2c))                           # proj_out
    layers = c["num_layers"]
    attn = layers * 2.0 * 2 * b * (n + m) ** 2 * d
    for last in [False] * (layers - 1) + [True]:
        linear += _mm(b, d, 6 * d) + _mm(b, d, (2 if last else 6) * d)
        linear += _mm(b * (n + m), d, 3 * d)                  # q, k, v
        out_rows = n if last else n + m
        linear += _mm(b * out_rows, d, d)                     # to_out(s)
        linear += 2 * _mm(b * out_rows, d, 4 * d)             # the MLPs
    return {"linear": linear, "attn": attn, "total": linear + attn}


def t5_flops(c: Dict, rows: int, tokens: int) -> float:
    inner = c["num_heads"] * c["d_kv"]
    t = rows * tokens
    per_layer = (_mm(t, c["d_model"], inner) * 4 + _mm(t, c["d_model"],
                                                       c["d_ff"]) * 3
                 + 2.0 * 2 * rows * tokens * tokens * inner)
    return per_layer * c["num_layers"]


def decode_flops(vae: Dict, hw: int) -> float:
    post_quant = _mm(hw * hw, vae["latent_channels"], vae["latent_channels"])
    return vae_decode_flops(vae, hw) - post_quant


def unit_flops(config: Dict, mix: Dict) -> float:
    """One request: both CLIPs and T5 over the null prompt and the prompt,
    every MMDiT call at 2 rows, one decode."""
    if mix["entry"] != "sample":
        raise ValueError("the SD3 family counts requests of `sample`")
    hw = latent_hw(config, mix)
    n = (hw // config["transformer"]["patch_size"]) ** 2
    m = CLIP_TOKENS + config["max_sequence_length"]
    return (clip_flops(config["text_encoder"], 2)
            + clip_flops(config["text_encoder_2"], 2)
            + t5_flops(config["text_encoder_3"], 2,
                       config["max_sequence_length"])
            + mix["nfe"] * mmdit_call_flops(config["transformer"], 2, n,
                                            m)["total"]
            + decode_flops(config["vae"], hw))


def attention_sites(config: Dict, mix: Dict
                    ) -> List[Tuple[int, int, int, int, int, int]]:
    """The attentions the flash kernel serves in one request: the joint
    attention of every block of every MMDiT call, and the VAE mid-block's
    (T5's biased attention and the CLIPs' masked one are not its)."""
    c = config["transformer"]
    hw = latent_hw(config, mix)
    tokens = (hw // c["patch_size"]) ** 2 + CLIP_TOKENS + \
        config["max_sequence_length"]
    ch = config["vae"]["block_out_channels"][-1]
    return [(2, tokens, tokens, c["num_attention_heads"],
             c["attention_head_dim"], c["num_layers"] * mix["nfe"]),
            (1, hw * hw, hw * hw, 1, ch, 1)]
