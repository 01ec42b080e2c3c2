"""The port's profiling module and ``--profile_dir`` against the JAX package.

``cfgpp_tpu_torch.utils.profiling.StepTimer`` keeps the JAX class's
``summary()`` keys and ``report()`` lines: both are held equal on the same
injected records.  ``trace`` writes a Chrome trace file on the CPU (a CPU
run has no device events; the card's trace is checked by
``chip_smoke.py`` phase 13).  ``--profile_dir`` parses in the three CLIs
that take it in the JAX package, and each wraps its sampling in the trace
(``text_to_img`` and ``inversion`` the request, ``text_to_mscoco`` its
generation loop).  ``tools/profile_bench.py`` runs at tiny_sdxl on the CPU.
"""

import argparse
import contextlib
import json

import numpy as np
import pytest
import torch

from cfgpp_tpu.cli import common as jax_common
from cfgpp_tpu.utils import profiling as jax_profiling
from cfgpp_tpu_torch.cli import common, inversion, text_to_img, text_to_mscoco
from cfgpp_tpu_torch.utils import profiling
from cfgpp_tpu_torch.utils.img import save_image


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch thread for this module's tiny tensors: the test workers
    share the cores, and oversubscribed intra-op threads stall each small
    op at its barrier."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RECORDS = [
    {"text": [0.0123, 0.0101, 0.0131], "unet": [0.5, 0.25],
     "a rather long section name over thirty characters": [1e-6]},
    {"one": [3.0]},
    {},
]


@pytest.mark.parametrize("case", range(len(RECORDS)))
def test_step_timer_summary_and_report_equal_jax(case):
    port, orig = profiling.StepTimer(), jax_profiling.StepTimer()
    port.records = {k: list(v) for k, v in RECORDS[case].items()}
    orig.records = {k: list(v) for k, v in RECORDS[case].items()}
    assert port.summary() == orig.summary()
    assert port.report() == orig.report()
    for s in port.summary().values():
        assert set(s) == {"count", "total_s", "mean_ms", "min_ms", "max_ms"}


def test_step_timer_sections_and_time_fn():
    """Sections and timed calls record one entry each, named; a result
    without a CUDA tensor synchronizes nothing (as in JAX without a device
    array)."""
    timer = profiling.StepTimer()
    with timer.section("a"):
        pass
    with timer.section("a", sync_on={"x": [torch.ones(2), (torch.zeros(1),)]}):
        pass
    out = timer.time_fn("b", lambda n: torch.arange(n), 4)
    assert torch.equal(out, torch.arange(4))
    assert [len(timer.records["a"]), len(timer.records["b"])] == [2, 1]
    assert all(t >= 0 for ts in timer.records.values() for t in ts)
    assert profiling.cuda_devices({"x": [torch.ones(2), (torch.zeros(1),)],
                                   "y": np.ones(2), "z": None}) == []


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    logdir = tmp_path / "new" / "trace"
    with profiling.trace(str(logdir)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(logdir.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def _parsed(module, monkeypatch, argv):
    """The namespace a port CLI's ``main`` parses from ``argv`` (it stops
    right after parsing)."""
    class Parsed(Exception):
        pass

    def stop(parser, args=None):
        raise Parsed(common.parse_args(parser, args))

    monkeypatch.setattr(module, "parse_args", stop)
    with pytest.raises(Parsed) as info:
        module.main(argv)
    return info.value.args[0]


CLI_ARGV = {text_to_img: [], inversion: ["--img_path", "x.png"],
            text_to_mscoco: ["--prompt_dir", "p.txt"]}


@pytest.mark.parametrize("module", list(CLI_ARGV), ids=lambda m: m.__name__)
def test_profile_dir_parses_in_the_three_clis(module, monkeypatch, tmp_path):
    argv = CLI_ARGV[module] + ["--model", "tiny_sd", "--device", "cpu"]
    assert _parsed(module, monkeypatch, argv).profile_dir is None
    d = str(tmp_path / "prof")
    assert _parsed(module, monkeypatch, argv + ["--profile_dir", d]).profile_dir == d


def test_profile_dir_flag_equals_jax():
    port, orig = argparse.ArgumentParser(), argparse.ArgumentParser()
    common.add_common_args(port)
    jax_common.add_common_args(orig)
    a = {x.dest: x for x in port._actions}["profile_dir"]
    b = {x.dest: x for x in orig._actions}["profile_dir"]
    assert (a.option_strings, a.type, a.default) == (b.option_strings, b.type,
                                                     b.default)


def test_maybe_profile(tmp_path):
    off = common.maybe_profile(argparse.Namespace(profile_dir=None))
    assert isinstance(off, contextlib.nullcontext)
    d = tmp_path / "p"
    with common.maybe_profile(argparse.Namespace(profile_dir=str(d))):
        torch.ones(3).sum()
    assert len(list(d.glob("*.pt.trace.json"))) == 1


def test_text_to_img_profile_dir_traces_the_request(tmp_path):
    text_to_img.main(["--model", "tiny_sd", "--device", "cpu", "--dtype",
                      "float32", "--method", "ddim_cfg++", "--cfg_guidance",
                      "0.6", "--NFE", "2", "--resolution", "16", "--prompt",
                      "a cat", "--workdir", str(tmp_path / "w"),
                      "--profile_dir", str(tmp_path / "prof")])
    assert (tmp_path / "w" / "result" / "generated.png").is_file()
    files = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name", "") for e in
             json.loads(files[0].read_text())["traceEvents"]}
    assert any(n.startswith("aten::conv") for n in names)


def _inversion_argv(tmp_path):
    img = tmp_path / "in.png"
    save_image(np.random.default_rng(0).random((1, 16, 16, 3),
                                               dtype=np.float32), img)
    return ["--img_path", str(img), "--img_size", "16", "--NFE", "2",
            "--prompt", "a cat"]


def _mscoco_argv(tmp_path):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a cat\na dog\n")
    return ["--prompt_dir", str(prompts), "--batch_size", "2", "--NFE", "2",
            "--resolution", "16"]


@pytest.mark.parametrize("module,argv", [(inversion, _inversion_argv),
                                         (text_to_mscoco, _mscoco_argv)],
                         ids=["inversion", "text_to_mscoco"])
def test_profile_dir_traces_inversion_and_mscoco(module, argv, tmp_path):
    """The other two CLIs that parse --profile_dir trace their sampling."""
    module.main(argv(tmp_path) + [
        "--model", "tiny_sd", "--device", "cpu", "--dtype", "float32",
        "--cfg_guidance", "0.6", "--workdir", str(tmp_path / "w"),
        "--profile_dir", str(tmp_path / "prof")])
    files = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name", "") for e in
             json.loads(files[0].read_text())["traceEvents"]}
    assert any(n.startswith("aten::conv") for n in names)


def test_profile_bench_on_the_cpu(capsys, monkeypatch):
    """tiny_sdxl on the CPU, in f32 at 4 NFE (bf16 convs are slow there)."""
    from cfgpp_tpu_torch.tools import profile_bench
    monkeypatch.setattr(profile_bench, "NFE", 4)
    monkeypatch.setattr(profile_bench, "DTYPE", torch.float32)
    monkeypatch.setattr(profile_bench, "REPS", 1)
    rec = profile_bench.main(["--model", "tiny_sdxl", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "cpu"
    assert any(line.startswith("modeled total: text ") for line in out)
    assert json.loads(out[-1])["steps"] == rec["steps"] == 3
    assert len(rec["enqueue_s"]) == len(rec["wall_s"]) == 2
    assert set(rec["segments"]) == {
        "text encode (dual)", "UNet call (batch 2, 64^2)",
        "VAE decode (engine: f32 params, float32 compute)",
        "VAE decode (bf16 params)"}
    assert all(e <= w for e, w in zip(rec["enqueue_s"], rec["wall_s"]))
    assert rec["request_device_s"] == 0.0 and rec["request_wall_s"] > 0
    assert rec["profiled_request_wall_s"] > 0
