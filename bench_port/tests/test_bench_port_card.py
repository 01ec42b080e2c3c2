"""On the card, at the cells' own sizes: the control (the reference in fp8,
``bench_port/control.py``) fails each cell's limits on two images, and one
short run of each cell is correct.  ``python3 -m pytest bench_port/tests -m card``."""

import pytest

from bench_port import manifest

CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limits(workload, card):
    from bench_port.control import control_numbers
    cell = manifest.cell(workload)
    _, worst = control_numbers(cell, 2 ** 31 + 555, card, images=2)
    assert any(worst[k] > limit for k, limit in cell["limits"].items()), \
        worst


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_is_correct(workload, card):
    from bench_port.run import run_cell, set_environment
    set_environment()
    result, _ = run_cell(manifest.cell(workload), 2 ** 31 + 556, 3.0, False,
                         card)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("seed", [2 ** 31 + 561, 2 ** 31 + 562, 2 ** 31 + 563])
def test_lightning_without_its_unconditional_half_is_not_correct(
        seed, card, monkeypatch):
    """At w=1 the CFG++ step still renoises with the unconditional eps, so
    a program that leaves the unconditional half of each UNet call out (the
    conditional half standing in) makes other images, though less other
    than at w > 1: at the cell's own size the run has to come out not
    correct."""
    from bench_port.run import run_cell, set_environment
    from bench_port.tests.test_bench_port_run import \
        half_the_unet_batch_left_out
    set_environment()
    with half_the_unet_batch_left_out(monkeypatch):
        result, numbers = run_cell(manifest.cell("sdxl_lightning_b1"), seed,
                                   3.0, False, card)
    print(f"seed {seed}: {numbers}")
    assert not result["correct"], numbers
