"""The run path: it refuses to run without a card (no fallback to the CPU),
and a whole run with the timed path broken underneath comes out not
correct, for each fault a cell can have (on the CPU, at the tiny presets, in
float32, against the cells' own limits).  There is one chip a cell and no
exchange between chips, so that fault does not apply."""

import contextlib

import pytest
import torch

from bench_port import manifest, run
from bench_port.tests.tiny import tiny_cell

CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]
SEED = 2 ** 31 + 901


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "sdxl_lightning_b1", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "needs 1 CUDA card" in out.err


@contextlib.contextmanager
def step_returns_its_state(monkeypatch):
    from cfgpp_tpu_torch.solvers import steps
    ddim, dpm = steps.ddim_step, steps.dpmpp_2m_step

    def ddim_step(eps_fn, w, c, zt, **kw):
        return zt, ddim(eps_fn, w, c, zt, **kw)[1]

    def dpmpp_2m_step(eps_fn, w, c, carry, **kw):
        return carry, dpm(eps_fn, w, c, carry, **kw)[1]
    monkeypatch.setattr(steps, "ddim_step", ddim_step)
    monkeypatch.setattr(steps, "dpmpp_2m_step", dpmpp_2m_step)
    yield


def _patch_program(monkeypatch, patch):
    from bench_port import system
    init = system.Program.__init__

    def patched(self, *a, **kw):
        init(self, *a, **kw)
        patch(self)
    monkeypatch.setattr(system.Program, "__init__", patched)


@contextlib.contextmanager
def half_the_unet_batch_left_out(monkeypatch):
    """The unconditional half of each UNet call is not computed: the
    conditional half stands in for it."""
    def patch(program):
        unet = program.engine.bundle.unet
        forward = unet.forward

        def half(sample, *a, **kw):
            out = forward(sample, *a, **kw)
            b = out.shape[0] // 2
            return torch.cat([out[b:], out[b:]]) if b else out
        unet.forward = half
    _patch_program(monkeypatch, patch)
    yield


@contextlib.contextmanager
def answer_altered(monkeypatch):
    """Each decoded image is moved by 0.25 (of [-1, 1]) where it is made."""
    def patch(program):
        decode = program.engine.bundle.vae.decode
        program.engine.bundle.vae.decode = lambda z: decode(z) + 0.25
    _patch_program(monkeypatch, patch)
    yield


FAULTS = {"none": contextlib.nullcontext,
          "step_returns_its_state": step_returns_its_state,
          "half_the_unet_batch_left_out": half_the_unet_batch_left_out,
          "answer_altered": answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_fault_makes_the_run_not_correct(workload, fault, monkeypatch):
    cell = tiny_cell(workload, check_images=2, warmup_nfe=2)
    make = FAULTS[fault]
    with (make() if fault == "none" else make(monkeypatch)):
        result, _ = run.run_cell(cell, SEED, 0.2, False, "cpu")
    checks = result["checks"]
    assert checks and all(c["value"] is not None for c in checks.values())
    assert result["correct"] is (fault == "none"), result["checks"]


BATCH_CELLS = [name for name in CELLS
               if manifest.cell(name)["mix"]["entry"] == "sample_batch"]


@contextlib.contextmanager
def one_slot_draws_another_stream(monkeypatch):
    """Slot 5 of every batch of 8 draws its random streams as the next
    sample does: a fault of one index of the batch."""
    from cfgpp_tpu_torch.engine import pipeline
    seed_of = pipeline._sample_seed

    def wrong(seed, index, *tags):
        return seed_of(seed, index + 1 if index % 8 == 5 else index, *tags)
    monkeypatch.setattr(pipeline, "_sample_seed", wrong)
    yield


@pytest.mark.parametrize("workload", BATCH_CELLS)
def test_a_fault_of_one_slot_makes_the_run_not_correct(workload,
                                                       monkeypatch):
    cell = tiny_cell(workload, warmup_nfe=2)      # the mix's check_images
    with one_slot_draws_another_stream(monkeypatch):
        result, _ = run.run_cell(cell, SEED, 0.2, False, "cpu")
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("workload", BATCH_CELLS)
def test_a_batch_check_takes_every_slot(workload):
    from bench_port.check import pick
    from bench_port.system import Done
    from bench_port.traffic import Traffic
    mix = manifest.cell(workload)["mix"]
    traffic = Traffic(mix, SEED)
    done = [Done(traffic.next(), 1.0) for _ in range(5)]
    for seed in range(20):
        picks = pick(done, mix, seed)
        assert sorted(j for _, j in picks) == list(range(mix["batch"]))
        assert all(d.unit.indices[j] % mix["batch"] == j for d, j in picks)
