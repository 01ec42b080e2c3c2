"""SD3 through the port's engine (``engine/sd3.py``) at ``tiny_sd3``:
`sample` and `sample_batch` images against the benchmark family's plain
float32 reference on the same seeded weights (both in float32 on the CPU:
the images agree to a few 8-bit levels on a few pixels, so the mean
difference is held to 1e-4 of full scale), the MMDiT call through its
`GraphRunner` on the CPU stand-in backend (replays equal to the eager body,
counted as ``mmdit.*``), the CLI, and the SD / SDXL path's imports, which
must not load the SD3 modules."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_port import check
from bench_port.system import Program
from bench_port.tests.sd3_tiny import tiny_sd3_cell
from cfgpp_tpu_torch.engine.sd3 import SD3Bundle, SD3Engine
from cfgpp_tpu_torch.models import unet_graph
from cfgpp_tpu_torch.models.unet_graph import GraphRunner
from cfgpp_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 23


@pytest.fixture(scope="module")
def pair():
    cell = tiny_sd3_cell()
    prog = Program(cell["config"], cell["mix"], SEED, "cpu")
    return cell, prog.engine, check.reference(cell["config"], SEED, "cpu")


def u8(img):
    return (np.asarray(img, np.float32) * 255.0 + 0.5).astype(np.uint8)


def mae(a, b):
    return np.abs(a.astype(np.float64) - b.astype(np.float64)).mean() / 255


@pytest.mark.parametrize("solver", ["flow_euler_cfg++", "flow_euler"])
def test_sample_is_the_reference(pair, solver):
    cell, engine, ref = pair
    mix = {**cell["mix"], "solver": solver,
           "guidance": 0.6 if solver.endswith("++") else 3.5}
    engine = SD3Engine(engine.bundle, solver, mix["nfe"])
    img = engine.sample(["", "a red fox"], cfg_guidance=mix["guidance"],
                        seed=11, resolution=16)
    want = ref.image(mix, "", "a red fox", 11).numpy()
    assert img.shape == (1, 16, 16, 3)
    assert mae(u8(img[0].numpy()), u8(want)) <= 1e-4


def test_sample_batch_is_the_reference_per_index(pair):
    cell, engine, ref = pair
    prompts = ["a cat", "two dogs on a hill", "x"]
    imgs = engine.sample_batch("", prompts, cfg_guidance=0.6, seed=5,
                               resolution=16, sample_indices=[4, 9, 2],
                               to_uint8=True)
    for j, (prompt, index) in enumerate(zip(prompts, [4, 9, 2])):
        want = ref.image(cell["mix"], "", prompt, 5, index).numpy()
        assert mae(imgs[j], u8(want)) <= 1e-4
    again = engine.sample_batch("", prompts[1:2], cfg_guidance=0.6, seed=5,
                                resolution=16, sample_indices=[9],
                                to_uint8=True)
    assert np.array_equal(again[0], imgs[1])


def test_spans_and_refusals(pair):
    _, engine, _ = pair
    with profiling.recording() as rec:
        engine.sample(["", "a"], cfg_guidance=0.6, seed=1)
    names = [s.name for s in rec.spans]
    assert names.count("mmdit") == engine.nfe
    assert names.count("clip") == names.count("t5") == 2
    mm = rec.named("mmdit")[0]
    assert mm.attr == (2, 16 + 77 + 16)
    with pytest.raises(ValueError, match="SD3 takes no"):
        engine.sample(["", "a"], cfg_guidance=0.6, seed=1,
                      original_size=(16, 16))


class Rerun:
    """CPU stand-in for `unet_graph.CudaGraphs` (as in
    ``test_torch_port_unet_graph.py``)."""

    @staticmethod
    def engages(sample):
        return True

    @staticmethod
    def warm_up(device, fn):
        return fn()

    @staticmethod
    def capture(device, fn):
        out = fn()
        return (fn, out), out

    @staticmethod
    def replay(graph):
        fn, out = graph
        counters = unet_graph.read_counters()
        out.copy_(fn())
        unet_graph.write_counters(counters)


def test_the_graph_runner_engages_on_the_mmdit():
    bundle = SD3Bundle.random_init("tiny_sd3", 3, torch.float32, "cpu")
    eager = SD3Engine(bundle, "flow_euler_cfg++", 3)
    want = [eager.sample(["", p], cfg_guidance=0.6, seed=2) for p in
            ("a cat", "a dog")]
    runner = GraphRunner(Rerun(), name="mmdit",
                         routes=bundle.transformer.graphs.routes)
    bundle.transformer.graphs = runner
    assert runner.routes[-1][0] == "cfgpp_tpu_torch.models.mmdit"
    with profiling.recording() as rec:
        got = [eager.sample(["", p], cfg_guidance=0.6, seed=2) for p in
               ("a cat", "a dog")]
    counts = [r.name for r in rec.readings]
    assert counts.count("mmdit.capture") == 1
    assert counts.count("mmdit.replay") == 5
    assert not any(c.startswith("unet.") for c in counts)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the second prompt's context went into the static buffers
    assert not torch.equal(got[0], got[1])


def test_the_cli_runs_tiny_sd3(tmp_path):
    from cfgpp_tpu_torch.cli.common import SD3_MODELS
    from cfgpp_tpu_torch.configs_sd3 import SD3_PRESETS
    assert SD3_MODELS == tuple(SD3_PRESETS)
    out = subprocess.run(
        [sys.executable, "-m", "cfgpp_tpu_torch.cli.text_to_img", "--model",
         "tiny_sd3", "--device", "cpu", "--dtype", "float32", "--method",
         "flow_euler_cfg++", "--cfg_guidance", "0.6", "--NFE", "3",
         "--prompt", "a cat", "--workdir", str(tmp_path)],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert (tmp_path / "result" / "generated.png").stat().st_size > 0


def test_the_sdxl_path_loads_no_sd3_module():
    """The SD / SDXL engine, the CLIs' plumbing and the benchmark's SD /
    SDXL family import none of the SD3 modules (their start-up stays as
    it was)."""
    code = (
        "import sys\n"
        "import cfgpp_tpu_torch.engine, cfgpp_tpu_torch.cli.common\n"
        "import cfgpp_tpu_torch.cli.text_to_mscoco\n"
        "from bench_port import families\n"
        "families.load({})\n"
        "print(sorted(m for m in sys.modules if m.endswith(('.sd3',"
        " '.mmdit', '.t5', '.configs_sd3', '.t5_tokenizer', '.flow'))"
        " or 'sd3_mmdit' in m))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
