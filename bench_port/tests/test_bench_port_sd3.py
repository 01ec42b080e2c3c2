"""The SD3 family (``families/sd3_mmdit/``) through the harness, at the tiny
preset on the CPU (``sd3_tiny.py``): whole runs of the ``sd35_large_b1``
cell's mix, traced and not, correct against the tiny cell's limit; the
check and the control (which fails that limit on every image); faults
planted under a whole run, each not correct; ``unit_flops`` equal to
``FlopCounterMode``'s count of the reference, at the tiny size over a
whole image and at published widths part by part on the meta device; and
the cell's files found by name.  On the card, at the cell's own size:
``python3 -m pytest bench_port/tests/test_bench_port_sd3.py -m card``."""

import contextlib

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port import families, flops, manifest, run
from bench_port.check import check, reference
from bench_port.control import control_numbers
from bench_port.families.sd3_mmdit import flops as sd3_flops
from bench_port.families.sd3_mmdit import plain
from bench_port.families.sd_unet import flops as sd_flops
from bench_port.reference import models
from bench_port.system import Program
from bench_port.tests.sd3_tiny import sd35_cell, tiny_sd3_cell
from bench_port.traffic import Traffic

SEED = 2 ** 31 + 3131


@pytest.mark.parametrize("trace", [False, True])
def test_whole_runs_are_correct(trace):
    cell = tiny_sd3_cell("bfloat16")
    result, numbers = run.run_cell(cell, SEED, 0.2, trace, "cpu")
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    metrics = result["metrics"]
    if trace:
        assert metrics["mfu.b1"]["value"] > 0
        for name in ("mmdit_ms_per_call.sd35", "t5_ms_per_unit.sd35",
                     "device_idle_share.b1", "vae_ms_per_image.b1",
                     "text_ms_per_unit.b1"):
            assert name in metrics, name
        assert "attn_roofline.b1" not in metrics    # no kernel on the CPU
    else:
        assert set(metrics) == {"s_per_image", "p90_request_s", "setup_s"}


def test_float32_runs_match_the_reference():
    """Float32 on both sides: the program's images are the reference's to
    within a few 8-bit levels on a few pixels."""
    cell = tiny_sd3_cell()
    result, numbers = run.run_cell(cell, SEED + 1, 0.2, False, "cpu")
    assert numbers["image_mae"] <= 1e-4, numbers


def test_the_check_passes_and_the_control_fails():
    cell = tiny_sd3_cell("bfloat16")
    prog = Program(cell["config"], cell["mix"], SEED, "cpu")
    traffic = Traffic(cell["mix"], SEED)
    done = [prog.run_unit(traffic.next()) for _ in range(2)]
    prog.release()
    ok, numbers = check(cell["config"], cell["mix"], cell["limits"], SEED,
                        done, "cpu")
    assert ok, numbers
    each, _ = control_numbers(cell, SEED, "cpu")
    assert len(each) == cell["mix"]["check_images"]
    assert all(e["image_mae"] > cell["limits"]["image_mae"] for e in each), \
        each


def _patch_program(monkeypatch, patch):
    init = Program.__init__

    def patched(self, *a, **kw):
        init(self, *a, **kw)
        patch(self.engine)
    monkeypatch.setattr(Program, "__init__", patched)


@contextlib.contextmanager
def step_returns_its_state(monkeypatch):
    from cfgpp_tpu_torch.solvers import steps
    step = steps.flow_euler_step
    monkeypatch.setattr(steps, "flow_euler_step",
                        lambda v_fn, w, c, x, **kw: (x, step(v_fn, w, c, x,
                                                             **kw)[1]))
    yield


@contextlib.contextmanager
def half_the_mmdit_batch_left_out(monkeypatch):
    """The unconditional half of each MMDiT call is not computed: the
    conditional half stands in for it."""
    def patch(engine):
        forward = engine.bundle.transformer.forward

        def half(x, *a):
            out = forward(x, *a)
            b = out.shape[0] // 2
            return torch.cat([out[b:], out[b:]])
        engine.bundle.transformer.forward = half
    _patch_program(monkeypatch, patch)
    yield


@contextlib.contextmanager
def t5_left_out(monkeypatch):
    """T5's tokens arrive as zeros: the context of the two CLIPs alone."""
    def patch(engine):
        t5 = engine.bundle.text_encoder_3
        forward = t5.forward
        t5.forward = lambda ids: torch.zeros_like(forward(ids))
    _patch_program(monkeypatch, patch)
    yield


@contextlib.contextmanager
def decode_without_the_shift(monkeypatch):
    def patch(engine):
        engine._vae_input = lambda z: z / \
            engine.bundle.config.vae.scaling_factor
    _patch_program(monkeypatch, patch)
    yield


@pytest.mark.parametrize("fault", [step_returns_its_state,
                                   half_the_mmdit_batch_left_out,
                                   t5_left_out, decode_without_the_shift],
                         ids=lambda f: f.__name__)
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    cell = tiny_sd3_cell()
    with fault(monkeypatch):
        result, numbers = run.run_cell(cell, SEED, 0.2, False, "cpu")
    assert numbers and result["correct"] is False, numbers


def test_unit_flops_count_a_reference_image():
    cell = tiny_sd3_cell()
    ref = reference(cell["config"], SEED, "cpu")
    with FlopCounterMode(display=False) as counter:
        ref.image(cell["mix"], "", "a red fox", 7)
    assert counter.get_total_flops() == flops.unit_flops(cell["config"],
                                                         cell["mix"])
    assert flops.attention_sites(cell["config"], cell["mix"]) == [
        (2, 16 + 77 + 16, 16 + 77 + 16, 2, 16, 2 * 4), (1, 64, 64, 1, 32, 1)]


def counted(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.fixture(scope="module")
def published():
    return sd35_cell()


def test_published_mmdit_call(published):
    cfg = published["config"]
    c = cfg["transformer"]
    with torch.device("meta"):
        m = plain.MMDiT(c)
        x = torch.empty(2, 128, 128, 16)
        ctx = torch.empty(2, 77 + 256, c["joint_attention_dim"])
        pooled = torch.empty(2, c["pooled_projection_dim"])
        n = counted(lambda: m(x, torch.tensor([1000.0]), ctx, pooled))
    want = sd3_flops.mmdit_call_flops(c, 2, 4096, 333)
    assert n == want["total"]
    # 31.1 TFLOP a row and call, 23.9 of it in the linear layers
    assert want["total"] / 2 == pytest.approx(31.1e12, rel=5e-3)
    assert want["linear"] / 2 == pytest.approx(23.9e12, rel=5e-3)


def test_published_t5_and_decoder(published):
    cfg = published["config"]
    with torch.device("meta"):
        t5 = plain.T5(cfg["text_encoder_3"])
        ids = torch.zeros(2, 256, dtype=torch.long)
        assert counted(lambda: t5(ids)) == sd3_flops.t5_flops(
            cfg["text_encoder_3"], 2, 256)
        vae = plain.VAEDecoder16(cfg["vae"])
        z = torch.empty(1, 128, 128, 16)
        assert counted(lambda: vae(z)) == sd3_flops.decode_flops(
            cfg["vae"], 128)
        for part in ("text_encoder", "text_encoder_2"):
            enc = models.CLIPText(cfg[part])
            ids = torch.zeros(2, 77, dtype=torch.long)
            assert counted(lambda: enc(ids)) == sd_flops.clip_flops(
                cfg[part], 2)
    per_image = flops.unit_flops(cfg, published["mix"])
    assert per_image == pytest.approx(1.76e15, rel=1e-2)


def test_the_family_is_loaded_by_name():
    fam = families.load({"family": "sd3_mmdit"})
    assert set(fam.MODULES) == {"transformer", "vae", "text_encoder",
                                "text_encoder_2", "text_encoder_3"}
    assert len(set(fam.MODULES.values())) == 5


def test_the_cell_is_found_by_name(published):
    w = published["workload"]
    assert published["config"]["name"] == w["config"]
    assert published["mix"]["name"] == w["traffic"]
    assert set(published["limits"]) == {"image_mae"}
    assert {m["name"] for m in published["end_to_end"]} == {
        "s_per_image", "p90_request_s", "setup_s"}
    for m in published["per_layer"]:
        assert m["moves"] == "s_per_image"
        assert callable(manifest.reader(m["name"])), m["name"]
    assert len(published["per_layer"]) == 7
    families.load(published["config"]).check_config(published["config"])


SEEDS = [2 ** 31 + 571, 2 ** 31 + 572, 2 ** 31 + 573]


@pytest.mark.card
@pytest.mark.parametrize("fault", [half_the_mmdit_batch_left_out,
                                   t5_left_out], ids=lambda f: f.__name__)
@pytest.mark.parametrize("seed", SEEDS)
def test_a_fault_at_the_cells_size_is_not_correct(seed, fault, card,
                                                  monkeypatch):
    """At lambda=0.6 with seeded weights the prompt moves the velocity less
    than a trained model's would: leaving the unconditional half of each
    MMDiT call out, or T5's tokens, still has to fail the cell's limit."""
    from bench_port.run import set_environment
    set_environment()
    with fault(monkeypatch):
        result, numbers = run.run_cell(sd35_cell(), seed, 3.0, False, card)
    print(f"{fault.__name__} seed {seed}: {numbers}", flush=True)
    assert not result["correct"], numbers
