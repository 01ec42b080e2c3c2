"""The model family as a property of the configuration (``families/``):

* a toy family that lives only in this folder's files (``families/
  toy_flow.py``) goes through a whole run, traced and not, through the
  check and the control, and a fault planted in it comes out not correct:
  a new family needs no edit of the harness;
* the SD / SDXL UNet family reads as it did before the harness went
  through families: the fills of the tiny presets' modules, the tiny
  cells' check numbers, ``unit_flops`` and ``attention_sites`` equal what
  the harness gave before (recorded here, CPU, float32 unless said);
* the fill's declared draws, and the error of an unknown family.
"""

import contextlib
import hashlib
from pathlib import Path

import pytest
import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from bench_port import families, flops, manifest, run, weights
from bench_port.check import check, reference
from bench_port.control import control_numbers
from bench_port.system import Program
from bench_port.tests.tiny import tiny_cell, tiny_config, with_kept_cells
from bench_port.traffic import Traffic

TOY_ROOT = Path(__file__).resolve().parent / "families"
SEED = 2 ** 31 + 4242


# ------------------------------------------------------------- the toy family
def toy_cell():
    base = tiny_config("tiny_sd")
    config = {
        "name": "toy", "family": "toy_flow", "preset": "tiny_sd",
        "dtypes": {"denoiser": "bfloat16", "vae": "float32",
                   "vae_decode_compute": "float32",
                   "text_encoder": "float32"},
        "tf32": {"cudnn": False, "cuda_matmul": False},
        "denoiser": {"in_channels": 4, "patch_size": 2, "sample_size": 16,
                     "hidden_size": 32, "num_heads": 2, "num_layers": 2,
                     "context_dim": 32, "shift": 3.0},
        "vae": base["vae"], "text_encoder": base["text_encoder"]}
    mix = {"name": "toy_b1", "entry": "sample", "solver": "flow_cfg++",
           "nfe": 4, "guidance": 2.0, "resolution": 32, "batch": 1,
           "quant": None, "null_prompt": "", "prompt_words": [3, 12],
           "warmup_nfe": 2, "trace_units": 2, "check_images": 2}
    bm = manifest.benchmark()
    named = {m["name"]: m for m in bm["end_to_end"] + bm["per_layer"]}
    return {"workload": {"name": "toy_b1", "config": "toy",
                         "traffic": "toy_b1", "chips": 1},
            "config": config, "mix": mix, "limits": {"image_mae": 0.003},
            "end_to_end": [named[n] for n in ("s_per_image", "setup_s")],
            "per_layer": [named[n] for n in (
                "mfu.b1", "device_idle_share.b1", "attn_roofline.b1",
                "unet_ms_per_call.b1")]}


@pytest.fixture
def toy(monkeypatch):
    monkeypatch.setattr(families, "ROOTS", (families.HERE, TOY_ROOT))
    return toy_cell()


@pytest.mark.parametrize("trace", [False, True])
def test_a_family_of_new_files_runs_correct(toy, trace):
    result, numbers = run.run_cell(toy, SEED, 0.2, trace, "cpu")
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    metrics = result["metrics"]
    if trace:
        # the family's FLOPs reach mfu; the readers of spans and kernels
        # that this family and the CPU do not have leave their metrics out
        assert metrics["mfu.b1"]["value"] > 0
        assert "device_idle_share.b1" in metrics
        assert "attn_roofline.b1" not in metrics
        assert "unet_ms_per_call.b1" not in metrics
    else:
        assert set(metrics) == {"s_per_image", "setup_s"}


def test_the_check_and_the_control_go_through_the_family(toy):
    prog = Program(toy["config"], toy["mix"], SEED, "cpu")
    traffic = Traffic(toy["mix"], SEED)
    done = [prog.run_unit(traffic.next()) for _ in range(2)]
    prog.release()
    ok, numbers = check(toy["config"], toy["mix"], toy["limits"], SEED, done,
                        "cpu")
    assert ok, numbers
    each, worst = control_numbers(toy, SEED, "cpu")
    assert len(each) == toy["mix"]["check_images"]
    assert all(e["image_mae"] > toy["limits"]["image_mae"] for e in each), \
        each


@contextlib.contextmanager
def step_returns_its_state(monkeypatch):
    toy_flow = families.load({"family": "toy_flow"})
    step = toy_flow.step
    monkeypatch.setattr(toy_flow, "step",
                        lambda x, *a: (x, step(x, *a)[1]))
    yield


def _patch_program(monkeypatch, patch):
    init = Program.__init__

    def patched(self, *a, **kw):
        init(self, *a, **kw)
        patch(self.engine)
    monkeypatch.setattr(Program, "__init__", patched)


@contextlib.contextmanager
def unconditional_half_left_out(monkeypatch):
    def patch(engine):
        forward = engine.denoiser.forward

        def half(x, *a):
            out = forward(x, *a)
            return torch.cat([out[1:], out[1:]])
        engine.denoiser.forward = half
    _patch_program(monkeypatch, patch)
    yield


@contextlib.contextmanager
def answer_altered(monkeypatch):
    def patch(engine):
        decode = engine.vae.decode
        engine.vae.decode = lambda z: decode(z) + 0.25
    _patch_program(monkeypatch, patch)
    yield


@pytest.mark.parametrize("fault", [step_returns_its_state,
                                   unconditional_half_left_out,
                                   answer_altered],
                         ids=lambda f: f.__name__)
def test_a_fault_in_the_new_family_is_not_correct(toy, fault, monkeypatch):
    with fault(monkeypatch):
        result, numbers = run.run_cell(toy, SEED, 0.2, False, "cpu")
    assert numbers and result["correct"] is False, numbers


def test_the_family_counts_what_its_reference_computes(toy):
    """``flops.unit_flops`` of the toy cell, through the family, equals a
    count of one whole reference image: its text encode, every denoiser
    call and its decode."""
    ref = reference(toy["config"], SEED, "cpu")
    with FlopCounterMode(display=False) as counter:
        ref.image(toy["mix"], "", "a red fox", 7)
    assert counter.get_total_flops() == flops.unit_flops(toy["config"],
                                                         toy["mix"])
    sites = flops.attention_sites(toy["config"], toy["mix"])
    assert sites[0] == (2, 64 + 77, 64 + 77, 2, 16, 8)


def test_an_unknown_family_names_its_missing_file():
    with pytest.raises(FileNotFoundError, match=r"no_such_family\.py"):
        families.load({"name": "x", "family": "no_such_family"})
    with pytest.raises(ValueError, match="not a name"):
        families.load({"name": "x", "family": "../sd_unet"})


def test_a_configuration_without_a_family_is_sd_unet():
    sd_unet = families.load({})
    assert sd_unet is families.load({"family": "sd_unet"})
    assert sd_unet.MODULES == {"unet": 1, "vae": 2, "text_encoder": 3,
                               "text_encoder_2": 4}


# ------------------------------------------------------------- the weights
class T5LayerNorm(nn.Module):
    """Scale-only, as T5's: no bias, no mean subtracted."""

    def __init__(self, d):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d))


class LayerScale(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(d))


class Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.proj = nn.Linear(8, 16)
        self.rms = nn.RMSNorm(16)
        self.t5 = T5LayerNorm(16)
        self.scale = LayerScale(16)
        self.table = nn.Parameter(torch.empty(4, 16))


def test_declared_draws():
    net = weights.fill_(Net(), 3, "net", torch.float32, {"net": 9},
                        {LayerScale: weights.constant(0.5),
                         "table": weights.normal(0.02)})
    assert torch.equal(net.rms.weight, torch.ones(16))
    assert torch.equal(net.t5.weight, torch.ones(16))
    assert torch.equal(net.scale.gamma, torch.full((16,), 0.5))
    assert 0.005 < net.table.std().item() < 0.05
    assert 0.1 < net.proj.weight.std().item() < 0.6
    again = weights.fill_(Net(), 3, "net", torch.float32, {"net": 9},
                          {LayerScale: weights.constant(0.5),
                           "table": weights.normal(0.02)})
    assert torch.equal(again.table, net.table)


def test_an_undeclared_parameter_still_raises():
    with pytest.raises(TypeError, match="scale.gamma"):
        weights.fill_(Net(), 3, "net", torch.float32, {"net": 9},
                      {"table": weights.normal(0.02)})


# the sha256 over (name, bytes) of each module's state in name order, as
# the harness filled them before families (tiny cells in bfloat16, seed SEED)
FILLS = {
    "tiny_sd.unet":
        "8ec650b51053097aac46643bfef7a3301191896ac96e6f612129eb82eeffa54e",
    "tiny_sd.vae":
        "45138aa19fcfe1c5e137de61e22a9c9fc9a07c67e5671ca3846eb582e648ea00",
    "tiny_sd.text_encoder":
        "c9a3e5510a5e384e8a040551487f2c55648e1d847cbeb2d7971fad1dc8a0ede8",
    "tiny_sdxl.unet":
        "eaeea1477cd3a53d7b16bbdd01f7feee77a0819626e8f6d4218b9f51dbde1b39",
    "tiny_sdxl.vae":
        "45138aa19fcfe1c5e137de61e22a9c9fc9a07c67e5671ca3846eb582e648ea00",
    "tiny_sdxl.text_encoder":
        "c9a3e5510a5e384e8a040551487f2c55648e1d847cbeb2d7971fad1dc8a0ede8",
    "tiny_sdxl.text_encoder_2":
        "14da6da88c148dfff8b3b4531cd12b47a52fe1316c1a3110143447d4feb13e8c",
}


def digest(module):
    h = hashlib.sha256()
    for name, p in sorted(module.state_dict().items()):
        h.update(name.encode())
        h.update(p.detach().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("workload,preset", [("sd15_t2i_b1", "tiny_sd"),
                                             ("sdxl_lightning_b1",
                                              "tiny_sdxl")])
def test_the_fills_are_bit_for_bit_as_before(workload, preset):
    cell = tiny_cell(workload, "bfloat16")
    bundle = Program(cell["config"], cell["mix"], SEED, "cpu").engine.bundle
    got = {f"{preset}.{name}": digest(getattr(bundle, name))
           for name in families.load({}).MODULES
           if getattr(bundle, name) is not None}
    assert got == {k: v for k, v in FILLS.items()
                   if k.startswith(preset + ".")}


# ------------------------------------------------------- the SD / SDXL cells
# each tiny cell's check over its first two units (NFE at most 6, two
# images checked, seed SEED), and unit_flops / attention_sites of the tiny
# cell (its mix at 64^2) and of the cell itself, as before families
BEFORE = {
    "sdxl_gen_b8": (
        1.2765522875816993e-06, 378527385600.0, 2662543411183616.0,
        [(16, 256, 256, 2, 32, 192), (16, 256, 77, 2, 32, 192),
         (1, 1024, 1024, 1, 32, 8)],
        [(16, 4096, 4096, 10, 64, 240), (16, 4096, 77, 10, 64, 240),
         (16, 1024, 1024, 20, 64, 1440), (16, 1024, 77, 20, 64, 1440),
         (1, 16384, 16384, 1, 512, 8)]),
    "sdxl_lightning_b1": (
        6.382761437908496e-07, 8321675520.0, 64467719626752.0,
        [(2, 256, 256, 2, 32, 32), (2, 256, 77, 2, 32, 32),
         (1, 1024, 1024, 1, 32, 1)],
        [(2, 4096, 4096, 10, 64, 40), (2, 4096, 77, 10, 64, 40),
         (2, 1024, 1024, 20, 64, 240), (2, 1024, 77, 20, 64, 240),
         (1, 16384, 16384, 1, 512, 1)]),
    "sdxl_dense_gen_b8": (
        0.011276105494281046, 378527385600.0, 2662543411183616.0,
        [(16, 256, 256, 2, 32, 192), (16, 256, 77, 2, 32, 192),
         (1, 1024, 1024, 1, 32, 8)],
        [(16, 4096, 4096, 10, 64, 240), (16, 4096, 77, 10, 64, 240),
         (16, 1024, 1024, 20, 64, 1440), (16, 1024, 77, 20, 64, 1440),
         (1, 16384, 16384, 1, 512, 8)]),
    "sd15_t2i_b1": (
        0.0, 110881862144.0, 82579157295104.0,
        [(2, 1024, 1024, 2, 16, 150), (2, 1024, 77, 2, 16, 150),
         (2, 256, 256, 2, 32, 50), (2, 256, 77, 2, 32, 50),
         (1, 1024, 1024, 1, 32, 1)],
        [(2, 4096, 4096, 8, 40, 250), (2, 4096, 77, 8, 40, 250),
         (2, 1024, 1024, 8, 80, 250), (2, 1024, 77, 8, 80, 250),
         (2, 256, 256, 8, 160, 250), (2, 256, 77, 8, 160, 250),
         (2, 64, 64, 8, 160, 50), (2, 64, 77, 8, 160, 50),
         (1, 4096, 4096, 1, 512, 1)]),
}


@pytest.mark.parametrize("workload", sorted(BEFORE))
def test_the_cells_read_as_before(workload):
    mae, tiny_flops, cell_flops, tiny_sites, cell_sites = BEFORE[workload]
    tiny = tiny_cell(workload)
    cell = manifest.cell(workload, with_kept_cells())
    assert flops.unit_flops(tiny["config"], tiny["mix"]) == tiny_flops
    assert flops.unit_flops(cell["config"], cell["mix"]) == cell_flops
    assert flops.attention_sites(tiny["config"], tiny["mix"]) == tiny_sites
    assert flops.attention_sites(cell["config"], cell["mix"]) == cell_sites

    tiny = tiny_cell(workload, check_images=2, warmup_nfe=2)
    tiny["mix"]["nfe"] = min(tiny["mix"]["nfe"], 6)
    prog = Program(tiny["config"], tiny["mix"], SEED, "cpu")
    if tiny["mix"]["entry"] == "sample_batch":
        prog.open_writer()
    try:
        traffic = Traffic(tiny["mix"], SEED)
        done = [prog.run_unit(traffic.next()) for _ in range(2)]
        prog.finish()
        prog.release()
        ok, numbers = check(tiny["config"], tiny["mix"], tiny["limits"], SEED,
                            done, "cpu")
    finally:
        prog.close()
    assert ok and numbers == {"image_mae": mae}, numbers
