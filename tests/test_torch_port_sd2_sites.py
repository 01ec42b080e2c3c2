"""SD-2.1 at 768^2: the int8 routing at every site, the launch counts the
chip run holds, and the CLI.

The port's own UNet runs one forward of the full-width ``sd21_v`` config at
768^2 (batch 2B = 2) on the meta device: shapes only, no arithmetic.  Each
kernel wrapper is replaced by a counter that returns an empty output of the
right shape, and each routing predicate the port asks is recorded.  Every
recorded question is then put to the JAX package's own function
(`int8_conv3x3_supported` and ``_pick_blocks``'s ``br``; for the int8
score, whether its TPU route traces ``_kernel_single_int8``), and must get
the same answer.  The launch split of ``--quant all`` is derived from the
JAX answers and must equal both the port's dispatch and the counts
``chip_smoke.py`` holds on the card (equality: these are counts).
"""

import importlib

import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from cfgpp_tpu.cli.common import SD_MODELS
from cfgpp_tpu.models import attention as jax_attention
from cfgpp_tpu_torch.cli import common as cli_common
from cfgpp_tpu_torch.configs import get_bundle_config
from cfgpp_tpu_torch.engine import ModelBundle
from cfgpp_tpu_torch.kernels import int8_conv as tc
from cfgpp_tpu_torch.models import attention, quant
from cfgpp_tpu_torch.models import unet as unet_mod
from cfgpp_tpu_torch.weights.quantize import quantized_structure_

jax_fa = importlib.import_module("cfgpp_tpu.kernels.flash_attention")
jax_conv = importlib.import_module("cfgpp_tpu.kernels.int8_conv")

RES = 768
NFE = chip_smoke.NFE
KERNELS = ("int8_matmul", "int8_ff_geglu", "int8_conv3x3",
           "flash_attention_qkv_packed", "flash_attention_qkv_packed_int8",
           "flash_attention_hd", "flash_attention_hd_int8")


def _meta_forward(monkeypatch, mode, model="sd21_v", res=RES):
    """One UNet call of ``model`` at ``res``^2 on the meta device, with its
    cross k/v computed in the call as the engine computes them once per
    request (and, for SDXL, its added conditioning).  Returns (launches per
    UNet call, launches of the cross k/v, the conv predicate's questions,
    the int8-score predicate's questions)."""
    counts = dict.fromkeys(KERNELS, 0)
    conv_asked, score_asked = [], []

    def stub(name, shape_of):
        def run(*a, **k):
            counts[name] += 1
            return torch.empty(shape_of(*a, **k), device="meta")
        return run

    monkeypatch.setattr(quant, "int8_matmul", stub(
        "int8_matmul", lambda x, w, *a, **k: (*x.shape[:-1], w.shape[0])))
    monkeypatch.setattr(quant, "int8_conv3x3", stub(
        "int8_conv3x3", lambda x, w, *a, **k: (*x.shape[:-1], w.shape[0])))
    monkeypatch.setattr(unet_mod, "int8_ff_geglu", stub(
        "int8_ff_geglu", lambda x, *a, **k: x.shape))
    for name in ("flash_attention_qkv_packed",
                 "flash_attention_qkv_packed_int8"):
        monkeypatch.setattr(attention, name, stub(
            name, lambda qkv, h: (*qkv.shape[:-1], qkv.shape[-1] // 3)))
    monkeypatch.setattr(attention, "flash_attention_hd", stub(
        "flash_attention_hd", lambda q, *a, **k: q.shape))

    conv_pred, score_pred = quant.int8_conv3x3_supported, \
        attention.int8_score_applies

    def ask_conv(x_shape, strides, padding, o=None):
        out = conv_pred(x_shape, strides, padding, o)
        conv_asked.append(((tuple(x_shape), strides, padding, o), out))
        return out

    def ask_score(n, heads, d):
        out = score_pred(n, heads, d)
        score_asked.append(((n, heads, d), out))
        return out

    monkeypatch.setattr(quant, "int8_conv3x3_supported", ask_conv)
    monkeypatch.setattr(attention, "int8_score_applies", ask_score)

    bundle_cfg = get_bundle_config(model)
    cfg = bundle_cfg.unet
    with torch.device("meta"):
        unet = unet_mod.UNet2DConditionModel(cfg)
        if mode is not None:
            quantized_structure_(unet, mode)
        lat = res // 8
        z = torch.empty(2, lat, lat, 4)
        ctx = torch.empty(2, 77, cfg.cross_attention_dim)
        added = ()
        if cfg.addition_embed_type is not None:
            added = (torch.empty(2, bundle_cfg.text_encoder_2.projection_dim),
                     torch.empty(2, 6))
        ckv = unet_mod.precompute_cross_kv(unet, ctx)
        kv = dict(counts)
        for k in counts:
            counts[k] = 0
        out = unet(z, torch.tensor(501), ctx, *added, cross_kv=ckv)
    assert out.shape == (2, lat, lat, 4)
    return counts, kv, conv_asked, score_asked


@pytest.fixture(scope="module")
def sites():
    mp = pytest.MonkeyPatch()
    try:
        return {mode: _meta_forward(mp, mode)
                for mode in (None, "dense", "all")}
    finally:
        mp.undo()


def _jax_takes_int8_score(monkeypatch, n, heads, d) -> bool:
    """Whether the JAX TPU route traces ``_kernel_single_int8`` for the
    quantized self-attention of n tokens (jit removed: nothing cached)."""
    seen = []
    real = jax_fa._kernel_single_int8
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax_fa, "_kernel_single_int8",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    for name in ("flash_attention_hd", "flash_attention_hd_int8",
                 "flash_attention_qkv_packed",
                 "flash_attention_qkv_packed_int8"):
        fn = getattr(jax_fa, name)
        monkeypatch.setattr(jax_fa, name, getattr(fn, "__wrapped__", fn))
    jax.eval_shape(
        lambda x: jax_attention.attention_qkv_packed(x, heads,
                                                     int8_score=True),
        jax.ShapeDtypeStruct((2, n, 3 * heads * d), jnp.bfloat16))
    return bool(seen)


def test_conv_routing_matches_jax_at_every_768_site(sites):
    """int8_conv3x3_supported and the scale window rows ``br`` at every 3x3
    conv of the int8-all UNet: the JAX functions' answers."""
    _, _, asked, _ = sites["all"]
    assert len(asked) == 22 * 2 + 3          # resnet conv1/conv2, upsamplers
    for (shape, strides, padding, o), got in asked:
        assert got == jax_conv.int8_conv3x3_supported(shape, strides,
                                                      padding, o), shape
        _, h, w, c = shape
        assert tc.scale_window_rows(h, w, c, o) == \
            jax_conv._pick_blocks(h, w, c, o)[0], shape
    admitted = sorted({(s, o) for (s, _, _, o), ok in asked if ok})
    assert admitted == [((2, 96, 96, 640), 640)]  # up_blocks.2's upsampler
    assert tc.scale_window_rows(96, 96, 640, 640) == 8


def test_int8_score_matches_jax_at_every_768_site(sites, monkeypatch):
    _, _, _, asked = sites["all"]
    assert len(asked) == 16
    questions = sorted({q for q, _ in asked})
    assert questions == [(144, 20, 64), (576, 20, 64), (2304, 10, 64),
                         (9216, 5, 64)]
    for q, got in asked:
        assert got == _jax_takes_int8_score(monkeypatch, *q), q
        monkeypatch.undo()


def _per_request(per_call, cross_kv):
    """Launches of one request: NFE UNet calls, the cross k/v once, and the
    VAE decode's one attention."""
    out = {k: per_call[k] * NFE + cross_kv[k] for k in KERNELS}
    out["flash_attention_hd"] += 1
    return {k: v for k, v in out.items() if v}


def test_launch_split_matches_jax_and_chip_smoke(sites, monkeypatch):
    """The launches per request of each form, as the port dispatches them,
    equal the split the JAX predicates give and the counts chip_smoke.py
    holds on the card."""
    want = chip_smoke.SD2_LAUNCHES_PER_REQUEST
    exact = _per_request(*sites[None][:2])
    dense = _per_request(*sites["dense"][:2])
    per_call, kv, conv_asked, score_asked = sites["all"]
    assert exact == want["exact"] == {"flash_attention_hd": 1601}
    assert dense == want["dense"] == {
        "int8_matmul": 4832, "int8_ff_geglu": 800,
        "flash_attention_qkv_packed": 800, "flash_attention_hd": 801}
    jax_convs = sum(jax_conv.int8_conv3x3_supported(*q) for q, _ in conv_asked)
    jax_int8 = 0
    for q, _ in score_asked:
        jax_int8 += _jax_takes_int8_score(monkeypatch, *q)
        monkeypatch.undo()
    from_jax = {"int8_matmul": 5532, "int8_ff_geglu": 800,
                "int8_conv3x3": jax_convs * NFE,
                "flash_attention_qkv_packed_int8": jax_int8 * NFE,
                "flash_attention_qkv_packed": (16 - jax_int8) * NFE,
                "flash_attention_hd": 801}
    assert _per_request(per_call, kv) == from_jax == want["all"]
    assert from_jax["int8_conv3x3"] == 50
    assert from_jax["flash_attention_qkv_packed_int8"] == 250
    inversion = 2 * NFE * 32 + 2      # two loops, the decode, the encode
    assert want["inversion"] == {"flash_attention_hd": inversion} \
        == {"flash_attention_hd": 3202}


def test_cli_models_are_the_jax_sd_models():
    """The SD models are the JAX CLI's SD_MODELS; SDXL's follow them
    (tests/test_torch_port_sdxl_sites.py)."""
    assert cli_common.SD_MODELS == SD_MODELS
    assert cli_common.MODELS[:len(SD_MODELS)] == SD_MODELS


def test_cli_takes_sd21_v_on_cuda_by_default():
    import argparse
    parser = argparse.ArgumentParser()
    cli_common.add_common_args(parser)
    for name in ("sd20", "sd21", "sd21_v"):
        args = parser.parse_args(["--model", name, "--method", "ddim_cfg++"])
        assert args.model == name and args.device == "cuda"
    assert parser.parse_args(["--model", "sd21_v", "--device", "cpu"]
                             ).device == "cpu"


def test_bundle_takes_sd2_and_rejects_sdxl():
    """The sd21 family builds (on the meta device: structure only), and so
    does the sdxl family since SDXL was ported (its second text encoder
    and tokenizer with it); a family the port does not cover is still
    rejected."""
    import dataclasses

    b = ModelBundle._empty("sd20", torch.bfloat16, torch.device("meta"), None)
    assert b.config.name == "sd21" and b.unet.config.use_linear_projection
    assert b.text_encoder_2 is None and b.tokenizer_2 is None
    xl = ModelBundle._empty("sdxl", torch.bfloat16, torch.device("meta"),
                            None)
    assert xl.family == "sdxl" and xl.text_encoder_2 is not None
    assert xl.text_encoder_2.config.projection_dim == 1280
    assert xl.tokenizer_2.pad_id == 0 and xl.tokenizer.pad_id != 0
    unknown = dataclasses.replace(get_bundle_config("tiny_sd"),
                                  family="sd3")
    with pytest.raises(ValueError, match="sd family"):
        ModelBundle._empty(unknown, torch.float32, torch.device("cpu"), None)
