"""SDXL-Lightning at 1024^2: the launch counts the chip run holds, and the
CLI of the checkpoint path.

The launches of each Lightning request are derived from the JAX package's
plans (UNet calls a request) and ``_needs_branches`` (the batch of each
call at w=1) times the launches of one full-width ``sdxl`` UNet call on the
meta device (tests/test_torch_port_sdxl_sites.py's forward, whose per-call
split that file holds against the JAX predicates), plus the cross k/v once
a request and the decode's one attention.  They must equal
``chip_smoke.LIGHTNING_LAUNCHES_PER_REQUEST``, ``LIGHTNING_CALLS`` and
``LIGHTNING_BATCH``, and the port's own engine, run end to end on a meta
``sdxl_lightning`` bundle with every kernel wrapper a counter, must make
those launches and UNet calls of that batch (equality: these are counts).

CLI: ``--model sdxl_lightning`` parses and ``MODELS`` equals the JAX CLI's
``ALL_MODELS``; ``text_to_img --ckpt_dir D --light_ckpt F`` on
``tiny_sdxl`` runs the reference's Lightning command in a fresh interpreter
that imports neither jax, flax nor the JAX package, D and F written by the
port (``save_bundle``, the inverse map and ``save_file``).
"""

import argparse
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from cfgpp_tpu.cli.common import ALL_MODELS
from cfgpp_tpu.engine.pipeline import _needs_branches as jax_needs_branches
from cfgpp_tpu.schedules.ddim import make_ddim_schedule as jax_schedule
from cfgpp_tpu.solvers.registry import get_solver_spec as jax_spec
from cfgpp_tpu_torch.cli import common as cli_common
from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle
from cfgpp_tpu_torch.tools.sgm_synth import synth_single_file
from cfgpp_tpu_torch.weights.checkpoint import save_bundle
from cfgpp_tpu_torch.weights.safetensors_io import save_file
from tests.test_torch_port_sd2_sites import KERNELS, _meta_forward

REPO = Path(__file__).resolve().parents[1]
RES, NFE = chip_smoke.SDXL_RESOLUTION, chip_smoke.LIGHTNING_NFE
SOLVERS = (chip_smoke.LIGHTNING_SOLVER,) + chip_smoke.LIGHTNING_SOLVERS


@pytest.fixture(scope="module")
def sites():
    mp = pytest.MonkeyPatch()
    try:
        return {mode: _meta_forward(mp, mode, "sdxl", RES)[:2]
                for mode in (None, "dense")}
    finally:
        mp.undo()


def from_jax(name, per_call, cross_kv):
    """(UNet calls, batch per call, launches) of one request of ``name``."""
    spec = jax_spec(name, "sdxl")
    plan = spec.plan_fn(jax_schedule(NFE, timestep_spacing="trailing"))
    batch = sum(jax_needs_branches(spec.cfgpp, 1.0))
    out = {k: per_call[k] * plan.n_steps + cross_kv[k] for k in KERNELS}
    out["flash_attention_hd"] += 1
    return plan.n_steps, batch, {k: v for k, v in out.items() if v}


def test_launch_counts_match_jax_and_chip_smoke(sites):
    cs = chip_smoke
    for name in SOLVERS:
        calls, batch, launches = from_jax(name, *sites[None])
        assert (calls, batch) == (cs.LIGHTNING_CALLS[name],
                                  cs.LIGHTNING_BATCH[name]), name
        assert launches == cs.LIGHTNING_LAUNCHES_PER_REQUEST[name], name
    assert cs.LIGHTNING_LAUNCHES_PER_REQUEST[cs.LIGHTNING_SOLVER] == {
        "flash_attention_hd": 4 * 140 + 1}
    assert cs.LIGHTNING_LAUNCHES_PER_REQUEST["dpm++_2m_cfgpp_lightning"] == {
        "flash_attention_hd": 3 * 140 + 1}
    assert [cs.LIGHTNING_BATCH[n] for n in SOLVERS] == [2, 1, 1, 2, 2]
    _, _, dense = from_jax(cs.LIGHTNING_SOLVER, *sites["dense"])
    assert dense == cs.LIGHTNING_LAUNCHES_PER_REQUEST["dense"] == {
        "int8_matmul": 302 * 4 + 140, "int8_ff_geglu": 280,
        "flash_attention_qkv_packed": 280, "flash_attention_hd": 281}


def test_phase2_lightning_rows_cover_the_path():
    """The batch-1 rows carry a ddim_lightning request's UNet attention;
    the batch-2 forms reuse the sdxl rows at the Lightning calls."""
    cs = chip_smoke
    rows = cs.LIGHTNING_B1_ATTENTION_CASES
    assert {shape[0] for _, shape, *_ in rows} == {1}
    assert sum(case[-1] for case in rows) == \
        cs.LIGHTNING_LAUNCHES_PER_REQUEST["ddim_lightning"][
            "flash_attention_hd"] - 1
    sdxl_sites = {case[0] for case in cs.SDXL_ATTENTION_CASES}
    calls = cs.LIGHTNING_SITE_CALLS["flash_attention_hd"]
    assert set(calls) == sdxl_sites
    assert sum(calls.values()) == cs.LIGHTNING_LAUNCHES_PER_REQUEST[
        cs.LIGHTNING_SOLVER]["flash_attention_hd"]
    for name, kernel in (("flash_attention_qkv_packed",
                          "flash_attention_qkv_packed"),
                         ("int8_matmul", "int8_matmul"),
                         ("int8_ff_geglu", "int8_ff_geglu")):
        assert sum(cs.LIGHTNING_SITE_CALLS[name].values()) == \
            cs.LIGHTNING_LAUNCHES_PER_REQUEST["dense"][kernel], name


def meta_engine_counts(monkeypatch, bundle, name):
    """Launches and UNet batches of one port request on the meta device."""
    counts = dict.fromkeys(KERNELS, 0)
    from cfgpp_tpu_torch.models import attention, quant
    from cfgpp_tpu_torch.models import unet as unet_mod

    def stub(kernel, shape_of):
        def run(*a, **k):
            counts[kernel] += 1
            return torch.empty(shape_of(*a, **k), device="meta")
        return run

    monkeypatch.setattr(quant, "int8_matmul", stub(
        "int8_matmul", lambda x, w, *a, **k: (*x.shape[:-1], w.shape[0])))
    monkeypatch.setattr(unet_mod, "int8_ff_geglu", stub(
        "int8_ff_geglu", lambda x, *a, **k: x.shape))
    monkeypatch.setattr(attention, "flash_attention_qkv_packed", stub(
        "flash_attention_qkv_packed",
        lambda qkv, h: (*qkv.shape[:-1], qkv.shape[-1] // 3)))
    monkeypatch.setattr(attention, "flash_attention_hd", stub(
        "flash_attention_hd", lambda q, *a, **k: q.shape))
    engine = DiffusionEngine(bundle, name, nfe=NFE)
    batches = []
    hook = bundle.unet.register_forward_pre_hook(
        lambda module, a: batches.append(a[0].shape[0]))
    try:
        img = engine.sample(["", "a cat"], cfg_guidance=1.0, resolution=RES,
                            init_latent_override=np.zeros(
                                (1, RES // 8, RES // 8, 4), np.float32))
    finally:
        hook.remove()
    assert img.shape == (1, RES, RES, 3) and img.is_meta
    return {k: v for k, v in counts.items() if v}, batches


@pytest.fixture(scope="module")
def meta_bundle():
    return ModelBundle._empty(chip_smoke.LIGHTNING_MODEL, torch.bfloat16,
                              torch.device("meta"), None)


@pytest.mark.parametrize("name", SOLVERS)
def test_port_engine_makes_these_launches(monkeypatch, meta_bundle, name):
    cs = chip_smoke
    bundle = meta_bundle
    launches, batches = meta_engine_counts(monkeypatch, bundle, name)
    assert launches == cs.LIGHTNING_LAUNCHES_PER_REQUEST[name]
    assert batches == [cs.LIGHTNING_BATCH[name]] * cs.LIGHTNING_CALLS[name]
    if name == cs.LIGHTNING_SOLVER:
        monkeypatch.undo()
        dense = bundle.quantized("dense")
        launches, _ = meta_engine_counts(monkeypatch, dense, name)
        assert launches == cs.LIGHTNING_LAUNCHES_PER_REQUEST["dense"]


def test_cli_models_and_lightning_command():
    # the JAX CLI's models, then the port's SD3 ones (no JAX counterpart)
    assert cli_common.MODELS == ALL_MODELS + cli_common.SD3_MODELS
    parser = argparse.ArgumentParser()
    cli_common.add_common_args(parser)
    args = cli_common.parse_args(parser, [
        "--model", "sdxl_lightning", "--ckpt_dir", "D", "--light_ckpt", "F",
        "--method", "ddim_cfg++_lightning", "--NFE", "4", "--cfg_guidance",
        "1"])
    assert (args.model, args.ckpt_dir, args.light_ckpt, args.device) == (
        "sdxl_lightning", "D", "F", "cuda")
    defaults = cli_common.parse_args(parser, ["--model", "sdxl"])
    assert defaults.ckpt_dir is None and defaults.light_ckpt is None


def test_cli_lightning_from_files_runs_without_jax(tmp_path):
    """The reference's Lightning command on tiny_sdxl from files the port
    wrote, in a fresh interpreter without jax, flax or cfgpp_tpu."""
    base = ModelBundle.random_init("tiny_sdxl", seed=0, dtype=torch.float32,
                                   device="cpu")
    save_bundle(base, tmp_path / "D")
    light = ModelBundle.random_init("tiny_sdxl", seed=1, dtype=torch.float32,
                                    device="cpu")
    save_file(synth_single_file(light), tmp_path / "F.safetensors")
    code = (
        "import sys\n"
        "from cfgpp_tpu_torch.cli.text_to_img import main\n"
        "main(['--model', 'tiny_sdxl', '--device', 'cpu', '--dtype',\n"
        "      'float32', '--ckpt_dir', " + repr(str(tmp_path / "D")) + ",\n"
        "      '--light_ckpt', " + repr(str(tmp_path / "F.safetensors")) + ",\n"
        "      '--method', 'ddim_cfg++_lightning', '--NFE', '4',\n"
        "      '--cfg_guidance', '1', '--resolution', '16', '--prompt',\n"
        "      'a cat', '--workdir', " + repr(str(tmp_path / "out")) + "])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('cfgpp_tpu', 'jax', 'jaxlib',\n"
        "                                 'flax'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    from PIL import Image
    png = Image.open(tmp_path / "out" / "result" / "generated.png")
    assert png.size == (16, 16) and png.mode == "RGB"


def test_build_engine_lays_the_single_file_over_the_base(tmp_path):
    """--light_ckpt over --ckpt_dir (or over random weights) gives the
    single file's weights in every module, as the JAX CLI's overlay does."""
    save_bundle(ModelBundle.random_init("tiny_sdxl", seed=0,
                                        dtype=torch.float32, device="cpu"),
                tmp_path / "D")
    light = ModelBundle.random_init("tiny_sdxl", seed=1, dtype=torch.float32,
                                    device="cpu")
    save_file(synth_single_file(light), tmp_path / "F.safetensors")
    parser = argparse.ArgumentParser()
    cli_common.add_common_args(parser)
    for extra in (["--ckpt_dir", str(tmp_path / "D")], []):
        args = cli_common.parse_args(parser, [
            "--model", "tiny_sdxl", "--device", "cpu", "--dtype", "float32",
            "--light_ckpt", str(tmp_path / "F.safetensors"), "--method",
            "ddim_cfg++_lightning"] + extra)
        engine = cli_common.build_engine(args)
        for attr in ("unet", "vae", "text_encoder", "text_encoder_2"):
            got, want = (getattr(b, attr).state_dict()
                         for b in (engine.bundle, light))
            assert all(torch.equal(got[k], want[k]) for k in want), attr
