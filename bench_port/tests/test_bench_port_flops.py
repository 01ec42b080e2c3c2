"""The SD / SDXL UNet family's FLOP counts (``families/sd_unet/flops.py``,
which ``bench_port/flops.py`` dispatches to) against
``torch.utils.flop_counter.FlopCounterMode`` over the reference modules on
the meta device, at the cells' shapes and published widths: one UNet call
(cross k/v in the call, as the plain module computes them), one VAE decode,
each text encoder."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port import flops, manifest
from bench_port.families.sd_unet import flops as sd_flops
from bench_port.reference import models

CASES = [("sd15", 512), ("sdxl", 1024)]


def config(name):
    return json.loads((manifest.HERE / "configs" / f"{name}.json").read_text())


def counted(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("name,res", CASES)
def test_unet_call(name, res):
    cfg = config(name)
    u = cfg["unet"]
    with torch.device("meta"):
        unet = models.UNet(u)
        hw = res // 8
        z = torch.empty(2, hw, hw, 4)
        ctx = torch.empty(2, 77, u["cross_attention_dim"])
        pooled = ids = None
        if u["addition_embed_type"] == "text_time":
            pooled = torch.empty(2, cfg["text_encoder_2"]["projection_dim"])
            ids = torch.empty(2, 6)
        n = counted(lambda: unet(z, torch.tensor([10]), ctx, pooled, ids))
    want = sd_flops.unet_call_flops(u, 2, hw, cross_kv=True)["total"]
    assert n == want
    kv = sd_flops.cross_kv_flops(u, 2)
    assert sd_flops.unet_call_flops(u, 2, hw)["total"] == want - kv


@pytest.mark.parametrize("name,res", CASES)
def test_vae_decode(name, res):
    cfg = config(name)
    with torch.device("meta"):
        vae = models.VAEDecoder(cfg["vae"])
        n = counted(lambda: vae(torch.empty(1, res // 8, res // 8, 4)))
    assert n == sd_flops.vae_decode_flops(cfg["vae"], res // 8)


@pytest.mark.parametrize("name,part", [("sd15", "text_encoder"),
                                       ("sdxl", "text_encoder"),
                                       ("sdxl", "text_encoder_2")])
def test_text_encoder(name, part):
    c = config(name)[part]
    with torch.device("meta"):
        enc = models.CLIPText(c)
        ids = torch.zeros(2, 77, dtype=torch.long)
        n = counted(lambda: enc(ids))
    assert n == sd_flops.clip_flops(c, 2)


def test_unit_flops_of_the_cells():
    """The whole unit of each cell, as its mfu counts it."""
    for w in manifest.benchmark()["workloads"]:
        cell = manifest.cell(w["name"])
        per_image = flops.unit_flops(cell["config"], cell["mix"]) / \
            cell["mix"]["batch"]
        assert 5e13 < per_image < 4e14
