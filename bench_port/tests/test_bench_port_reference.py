"""The plain reference against the port on the CPU, at the tiny presets, in
float32: the same weights from the same seed, each model's output, and whole
runs of each cell's mix (solver, guidance, NFE) through the harness."""

import numpy as np
import pytest
import torch

from bench_port import check, families, manifest, weights
from bench_port.reference.pipeline import Reference, tokenize
from bench_port.run import run_cell
from bench_port.system import Program
from bench_port.tests.tiny import tiny_cell

CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_whole_runs_agree_in_float32(workload):
    cell = tiny_cell(workload, check_images=2, warmup_nfe=2)
    cell["mix"]["nfe"] = min(cell["mix"]["nfe"], 6)
    result, numbers = run_cell(cell, 2 ** 31 + 77, 0.3, False, "cpu")
    assert result["failed"] == 0 and result["attempted"] >= 1
    # float32 on both sides: at most a few pixels one level apart; the int8
    # kernels write bf16 values even from f32 activations, and one flipped
    # int8 level moves a row, so the W8A8 cell is held to 3e-2 (tiny_sdxl
    # read 1.2e-2)
    assert numbers["image_mae"] <= (3e-2 if cell["mix"]["quant"] else 1e-4), \
        numbers


@pytest.fixture(scope="module", params=["sd15_t2i_b1", "sdxl_gen_b8"])
def pair(request):
    cell = tiny_cell(request.param)
    prog = Program(cell["config"], cell["mix"], 11, "cpu")
    ref = check.reference(cell["config"], 11, "cpu")
    return cell, prog, ref


def test_weights_are_the_same(pair):
    _, prog, ref = pair
    ours = dict(prog.engine.bundle.unet.named_parameters())
    for name, p in ref.unet.named_parameters():
        assert torch.equal(ours[name].float(), p), name
    vae = dict(prog.engine.bundle.vae.named_parameters())
    for name, p in ref.vae.named_parameters():
        assert torch.equal(vae[name], p), name


def test_text_encoders_agree(pair):
    cell, prog, ref = pair
    prompts = ["", "a red fox in the snow"]
    ctx, pooled = prog.engine.text_embed(prompts)
    rctx, rpooled = ref.embed(prompts)
    torch.testing.assert_close(ctx.float(), rctx, rtol=1e-5, atol=1e-5)
    if pooled is not None:
        torch.testing.assert_close(pooled, rpooled, rtol=1e-5, atol=1e-5)
    ids = prog.engine.tokenize(prompts).cpu().numpy()
    c = cell["config"]["text_encoder"]
    assert np.array_equal(ids, tokenize(prompts, c["vocab_size"],
                                        c["eos_token_id"], None))


def test_unet_and_decode_agree(pair):
    cell, prog, ref = pair
    res = cell["mix"]["resolution"]
    hw = res // 2 ** (len(cell["config"]["vae"]["block_out_channels"]) - 1)
    z = torch.randn((2, hw, hw, 4), generator=torch.Generator().manual_seed(3))
    ctx, pooled = ref.embed(["", "a cat"])
    ids = None
    if pooled is not None:
        ids = torch.tensor([[res, res, 0, 0, res, res]] * 2,
                           dtype=torch.float32)
    t = torch.tensor([500])
    with torch.no_grad():
        want = ref.unet(z, t, ctx, pooled, ids)
        got = prog.engine.bundle.unet(z, t, ctx, *(() if ids is None else
                                                   (pooled, ids)))
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        img = prog.engine.bundle.vae.decode(z[:1])
        torch.testing.assert_close(img.float(), ref.vae(z[:1]), rtol=1e-4,
                                   atol=1e-4)


def test_draws_do_not_depend_on_other_groups():
    """The VAE decoder's weights are the same whether or not the module
    also holds an encoder (each top-level group has its own generator)."""
    cell = tiny_cell("sd15_t2i_b1")
    a = check.reference(cell["config"], 5, "cpu").vae
    prog = Program(cell["config"], cell["mix"], 5, "cpu")
    full = dict(prog.engine.bundle.vae.named_parameters())
    assert any(n.startswith("encoder.") for n in full)
    for name, p in a.named_parameters():
        assert torch.equal(full[name], p)
    b = Reference(cell["config"], "cpu").vae
    weights.fill_(b, 6, "vae", torch.float32,
                  families.load(cell["config"]).MODULES)
    assert not torch.equal(a.decoder.conv_in.weight, b.decoder.conv_in.weight)
