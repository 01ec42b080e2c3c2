"""SDXL at 1024^2: the int8 routing at every site, the launch counts the
chip run holds, and the CLI.

As tests/test_torch_port_sd2_sites.py does for sd21_v: the port's own UNet
runs one forward of the full-width ``sdxl`` config at 1024^2 (batch 2B =
2, with the added conditioning) on the meta device, shapes only, each
kernel wrapper replaced by a counter and each routing question recorded.
Every question is put to the JAX package's own function
(`int8_conv3x3_supported` and ``_pick_blocks``'s ``br``; for the int8
score, whether its TPU route traces ``_kernel_single_int8``), and must get
the same answer.  The launch split per request of each form (exact,
``--quant dense``, ``--quant all``, and the ``ddim_edit_cfg++`` request)
is derived from the JAX answers and must equal both the port's dispatch
and ``chip_smoke.SDXL_LAUNCHES_PER_REQUEST`` (equality: these are counts).
"""

import argparse
import collections
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke
from cfgpp_tpu.cli.common import SDXL_MODELS
from cfgpp_tpu.configs import get_bundle_config as jax_bundle_config
from cfgpp_tpu.solvers.registry import get_solver_spec as jax_spec
from cfgpp_tpu_torch.cli import common as cli_common
from cfgpp_tpu_torch.kernels import int8_conv as tc
from tests.test_torch_port_sd2_sites import (KERNELS, _jax_takes_int8_score,
                                             _meta_forward)

jax_conv = importlib.import_module("cfgpp_tpu.kernels.int8_conv")

REPO = Path(__file__).resolve().parents[1]
RES = chip_smoke.SDXL_RESOLUTION
CALLS = chip_smoke.SDXL_CALLS


@pytest.fixture(scope="module")
def sites():
    mp = pytest.MonkeyPatch()
    try:
        return {mode: _meta_forward(mp, mode, "sdxl", RES)
                for mode in (None, "dense", "all")}
    finally:
        mp.undo()


def test_main_path_makes_24_unet_calls():
    """dpm++_2m_cfgpp at 25 NFE loops timesteps[:-1] (the JAX plan)."""
    from cfgpp_tpu.schedules.ddim import make_ddim_schedule
    spec = jax_spec(chip_smoke.SDXL_SOLVER, "sdxl")
    plan = spec.plan_fn(make_ddim_schedule(chip_smoke.SDXL_NFE))
    assert plan.n_steps == CALLS == 24


def test_conv_routing_matches_jax_at_every_1024_site(sites):
    """int8_conv3x3_supported and the scale window rows ``br`` at every 3x3
    conv of the int8-all UNet: the JAX functions' answers; the admitted
    ones are the conv shapes chip_smoke.py's phase 2 holds, by count."""
    _, _, asked, _ = sites["all"]
    assert len(asked) == 17 * 2 + 2   # 17 resnets x 2 convs, 2 upsamplers
    admitted = collections.Counter()
    for (shape, strides, padding, o), got in asked:
        assert got == jax_conv.int8_conv3x3_supported(shape, strides,
                                                      padding, o), shape
        _, h, w, c = shape
        br = tc.scale_window_rows(h, w, c, o)
        assert br == jax_conv._pick_blocks(h, w, c, o)[0], shape
        if got:
            admitted[(shape, o, br)] += 1
    assert sum(admitted.values()) == 35
    assert any(shape[2] == 128 for shape, _, _ in admitted)
    want = collections.Counter()
    for _, shape, o, _, _, br, n in chip_smoke.SDXL_CONV_SITES:
        want[(shape, o, br)] += n
    assert admitted == want


def test_int8_score_matches_jax_at_every_1024_site(sites, monkeypatch):
    _, _, _, asked = sites["all"]
    assert len(asked) == chip_smoke.SDXL_BLOCKS == 70
    questions = sorted({q for q, _ in asked})
    assert questions == [(1024, 20, 64), (4096, 10, 64)]
    answers = {}
    for q in questions:
        answers[q] = _jax_takes_int8_score(monkeypatch, *q)
        monkeypatch.undo()
    for q, got in asked:
        assert got == answers[q], q


def _per_request(per_call, cross_kv):
    """Launches of one request: 24 UNet calls, the cross k/v once, and the
    VAE decode's one attention."""
    out = {k: per_call[k] * CALLS + cross_kv[k] for k in KERNELS}
    out["flash_attention_hd"] += 1
    return {k: v for k, v in out.items() if v}


def test_launch_split_matches_jax_and_chip_smoke(sites, monkeypatch):
    want = chip_smoke.SDXL_LAUNCHES_PER_REQUEST
    exact = _per_request(*sites[None][:2])
    dense = _per_request(*sites["dense"][:2])
    per_call, kv, conv_asked, score_asked = sites["all"]
    assert exact == want["exact"] == {"flash_attention_hd": 3361}
    assert dense == want["dense"] == {
        "int8_matmul": 7388, "int8_ff_geglu": 1680,
        "flash_attention_qkv_packed": 1680, "flash_attention_hd": 1681}
    jax_convs = sum(jax_conv.int8_conv3x3_supported(*q) for q, _ in conv_asked)
    jax_int8 = 0
    for q, _ in score_asked:
        jax_int8 += _jax_takes_int8_score(monkeypatch, *q)
        monkeypatch.undo()
    n_blocks = len(score_asked)
    from_jax = {"int8_matmul": (per_call["int8_matmul"]) * CALLS
                + kv["int8_matmul"],
                "int8_ff_geglu": n_blocks * CALLS,
                "int8_conv3x3": jax_convs * CALLS,
                "flash_attention_qkv_packed_int8": jax_int8 * CALLS,
                "flash_attention_qkv_packed": (n_blocks - jax_int8) * CALLS,
                "flash_attention_hd": n_blocks * CALLS + 1}
    from_jax = {k: v for k, v in from_jax.items() if v}
    assert _per_request(per_call, kv) == from_jax == want["all"]
    # 302 dense matmuls and 11 conv_shortcut 1x1s a call, the cross k/v
    assert from_jax["int8_matmul"] == 313 * CALLS + 140 == 7652
    assert from_jax["int8_conv3x3"] == 840
    edit = 2 * chip_smoke.SDXL_NFE * 140 + 2   # two loops, decode, encode
    assert want["edit"] == {"flash_attention_hd": edit} \
        == {"flash_attention_hd": 7002}


def test_phase2_cases_cover_the_path():
    """Phase 2's SDXL rows carry every launch of a request: the attention
    and packed rows the 140 sites a call, the int8 rows every dense
    matmul and the cross k/v."""
    cs = chip_smoke
    att = sum(calls for *_, calls in cs.SDXL_ATTENTION_CASES[:-1])
    assert att == cs.SDXL_SITES_PER_CALL * CALLS
    packed = sum(calls for *_, calls in cs.SDXL_PACKED_CASES)
    assert packed == cs.SDXL_LAUNCHES_PER_REQUEST["dense"][
        "flash_attention_qkv_packed"]
    mm = sum(calls for *_, calls in cs.SDXL_INT8_MATMUL_CASES)
    assert mm == cs.SDXL_LAUNCHES_PER_REQUEST["dense"]["int8_matmul"]
    ff = sum(calls for *_, calls in cs.SDXL_INT8_FF_CASES)
    assert ff == cs.SDXL_LAUNCHES_PER_REQUEST["dense"]["int8_ff_geglu"]
    conv = sum(calls for *_, calls in cs.SDXL_CONV_CASES)
    assert conv == cs.SDXL_LAUNCHES_PER_REQUEST["all"]["int8_conv3x3"]
    score = sum(case[-1] for case in cs.SDXL_INT8_ATTENTION_CASES)
    assert score == cs.SDXL_LAUNCHES_PER_REQUEST["all"][
        "flash_attention_qkv_packed_int8"]


def test_cli_models_and_methods():
    """The CLI offers the JAX CLI's SDXL models, sdxl_lightning among them
    (with --ckpt_dir and --light_ckpt), defaults to the card, and takes
    the solvers of the model's family, the Lightning ones included."""
    assert cli_common.SDXL_MODELS == SDXL_MODELS
    assert cli_common.MODELS == cli_common.SD_MODELS + (
        "sdxl", "sdxl_lightning", "tiny_sdxl") + cli_common.SD3_MODELS
    parser = argparse.ArgumentParser()
    cli_common.add_common_args(parser)
    args = cli_common.parse_args(parser, ["--model", "sdxl", "--method",
                                          "dpm++_2m_cfgpp", "--NFE", "25"])
    assert args.device == "cuda" and args.model == "sdxl"
    assert jax_bundle_config("sdxl").default_resolution == RES
    for model, method in (("sdxl", "euler_a"), ("sd15", "dpm++_2m_cfgpp_x"),
                          ("tiny_sdxl", "ddim_inversion_cfg++"),
                          ("sd15", "ddim_cfg++_lightning")):
        with pytest.raises(SystemExit):
            cli_common.parse_args(parser, ["--model", model, "--method",
                                           method])
    args = cli_common.parse_args(parser, ["--model", "sdxl", "--method",
                                          "ddim_cfg++_lightning"])
    assert args.method == "ddim_cfg++_lightning"


def test_cli_tiny_sdxl_runs_without_jax(tmp_path):
    """``--model tiny_sdxl --device cpu`` runs dpm++_2m_cfgpp end to end
    with --prompt_2, --null_prompt_2 and --clip_skip, in a fresh
    interpreter that imports neither jax nor flax."""
    code = (
        "import sys\n"
        "from cfgpp_tpu_torch.cli.text_to_img import main\n"
        "main(['--model', 'tiny_sdxl', '--device', 'cpu', '--dtype',\n"
        "      'float32', '--method', 'dpm++_2m_cfgpp', '--cfg_guidance',\n"
        "      '5', '--NFE', '4', '--resolution', '16', '--prompt', 'a cat',\n"
        "      '--prompt_2', 'an oil painting', '--null_prompt_2', 'blurry',\n"
        "      '--clip_skip', '1', '--workdir', " + repr(str(tmp_path)) + "])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('cfgpp_tpu', 'jax', 'jaxlib',\n"
        "                                 'flax'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    from PIL import Image
    png = Image.open(tmp_path / "result" / "generated.png")
    assert png.size == (16, 16) and png.mode == "RGB"


def test_cli_prompt_2_reaches_the_engine(monkeypatch, tmp_path):
    """The CLI passes --prompt_2/--null_prompt_2 as [null_2, prompt_2] and
    --clip_skip, as ``cfgpp_tpu/cli/text_to_img.py:45-57``."""
    from cfgpp_tpu_torch.cli import text_to_img
    from cfgpp_tpu_torch.engine import DiffusionEngine

    seen = {}

    def sample(self, prompt, **kw):
        seen.update(kw, prompt=prompt)
        return torch.zeros(1, 16, 16, 3)

    monkeypatch.setattr(DiffusionEngine, "sample", sample)
    base = ["--model", "tiny_sdxl", "--device", "cpu", "--method",
            "dpm++_2m_cfgpp", "--NFE", "2", "--prompt", "a cat",
            "--null_prompt", "ugly", "--workdir", str(tmp_path)]
    text_to_img.main(base + ["--prompt_2", "a dog", "--clip_skip", "2"])
    assert seen["prompt"] == ["ugly", "a cat"]
    assert seen["prompt_2"] == ["ugly", "a dog"] and seen["clip_skip"] == 2
    text_to_img.main(base + ["--null_prompt_2", "blurry"])
    assert seen["prompt_2"] == ["blurry", "a cat"] and seen["clip_skip"] is None
    text_to_img.main(base)
    assert seen["prompt_2"] is None
