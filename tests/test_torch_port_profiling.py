"""The port's profiling module and ``--profile_dir`` against the JAX package.

``cfgpp_tpu_torch.utils.profiling.StepTimer`` keeps the JAX class's
``summary()`` keys and ``report()`` lines: both are held equal on the same
injected records.  ``trace`` writes a Chrome trace file on the CPU (a CPU
run has no device events; the card's trace is checked by
``chip_smoke.py`` phase 13).  ``--profile_dir`` parses in the three CLIs
that take it in the JAX package, and each wraps its sampling in the trace
(``text_to_img`` and ``inversion`` the request, ``text_to_mscoco`` its
generation loop).  ``tools/profile_bench.py`` runs at tiny_sdxl on the CPU.

The span recorder: off, a request records nothing, reads no clock and
enters no ``record_function``; on, a tiny_sdxl Lightning request and a
``sample_batch`` through the PNG writer give the span tree of the layers,
every span with its unit's id and inside its parent, images bit for bit
those of the recorder off, and spans on ``torch.profiler``'s clock;
`attribute` gives synthetic device events to the innermost span of the
launching thread.
"""

import argparse
import collections
import contextlib
import json
import threading
import types

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
    assert {"cfgpp.request", "cfgpp.text", "cfgpp.step", "cfgpp.unet",
            "cfgpp.decode"} <= names
    assert not profiling.ON


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


# ------------------------------------------------------------ span recorder
@pytest.fixture(scope="module")
def xl_bundle():
    from cfgpp_tpu_torch.engine import ModelBundle
    return ModelBundle.random_init("tiny_sdxl", seed=0, dtype=torch.float32,
                                   device="cpu")


def _lightning(bundle):
    from cfgpp_tpu_torch.engine import DiffusionEngine
    return DiffusionEngine(bundle, solver="ddim_cfg++_lightning", nfe=4)


def _request(engine):
    return engine.sample(["", "a cat"], cfg_guidance=1.0, seed=7,
                         resolution=64)


def test_recorder_off_records_nothing_reads_no_clock(xl_bundle, monkeypatch):
    """With the recorder off a request opens no span: no clock read (the
    module's ``time`` and ``time.thread_time_ns`` fail if touched), no
    ``record_function`` entered (it fails too), nothing recorded."""
    def fail(*a, **k):
        raise AssertionError("read or entered with the recorder off")

    engine = _lightning(xl_bundle)
    kept = profiling.start_recording()
    profiling.stop_recording()
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        perf_counter_ns=fail, thread_time_ns=fail, time_ns=fail))
    monkeypatch.setattr("time.thread_time_ns", fail)
    monkeypatch.setattr(torch.profiler, "record_function", fail)
    assert not profiling.ON
    img = _request(engine)
    assert img.shape == (1, 64, 64, 3)
    assert kept.spans == [] and kept.readings == []


def _inside(child, parent):
    return (child.thread == parent.thread
            and parent.start_ns <= child.start_ns <= child.end_ns
            <= parent.end_ns)


def test_lightning_request_span_tree(xl_bundle):
    engine = _lightning(xl_bundle)
    with profiling.recording() as rec:
        _request(engine)
    spans = {s.id: s for s in rec.spans}
    roots = [s for s in rec.spans if s.parent is None]
    assert [(r.name, r.root) for r in roots] == [("request", True)]
    root = roots[0]
    assert root.attr == {"solver": "ddim_cfg++_lightning", "nfe": 4,
                         "batch": 1, "resolution": 64}
    for s in rec.spans:
        assert s.unit == root.unit
        assert s.end_ns >= s.start_ns and s.cpu_ns >= 0
        if s.parent is not None:
            assert _inside(s, spans[s.parent])
    kids = collections.defaultdict(list)
    for s in rec.spans:
        kids[s.parent].append(s)

    def names(span):
        return collections.Counter(c.name for c in kids[span.id])
    top = names(root)
    assert top == {"text": 2, "cross_kv": 1, "init_latent": 1, "step": 4,
                   "decode": 1}
    for t in rec.named("text"):        # SDXL: both tokenizers
        assert names(t) == {"tokenize": 2}
    steps = sorted(rec.named("step"), key=lambda s: s.start_ns)
    assert [s.attr for s in steps] == [0, 1, 2, 3]
    for s in steps:
        assert names(s) == {"unet": 1}
        assert kids[s.id][0].attr == 2      # both branches at w=1 (CFG++)
    assert rec.named("decode")[0].attr == 0


def test_images_bit_identical_with_the_recorder_on(xl_bundle):
    engine = _lightning(xl_bundle)
    off = _request(engine)
    with profiling.recording():
        on = _request(engine)
    assert torch.equal(off, on)


def test_batch_through_the_png_writer(xl_bundle, tmp_path):
    """A batch of 2: its decodes, and the writer's spans on its threads
    with the batch's unit id; the backlog gauge at each submit."""
    from cfgpp_tpu_torch.engine import DiffusionEngine
    from cfgpp_tpu_torch.utils.img import AsyncPngWriter
    engine = DiffusionEngine(xl_bundle, solver="dpm++_2m_cfgpp", nfe=3)

    def batch():
        return engine.sample_batch("", ["a cat", "a dog"], cfg_guidance=5.0,
                                   seed=3, resolution=64, to_uint8=True)
    off = batch()
    with profiling.recording() as rec, AsyncPngWriter(2) as writer:
        u8 = batch()
        for j in range(2):
            writer.submit(tmp_path / f"{j}.png", u8[j])
        assert writer.wait() == 0
    assert np.array_equal(off, u8)
    root, = [s for s in rec.spans if s.root]
    assert root.name == "batch" and root.attr["batch"] == 2
    decodes = sorted(rec.named("decode"), key=lambda s: s.start_ns)
    assert [d.attr for d in decodes] == [0, 1]
    assert all(d.unit == root.unit and _inside(d, root) for d in decodes)
    writes, submits = rec.named("png.write"), rec.named("png.submit")
    assert len(writes) == len(submits) == 2
    main = threading.get_native_id()
    assert all(w.thread != main and w.unit == root.unit and w.parent is None
               for w in writes)
    assert all(s.thread == main and s.unit == root.unit
               and s.start_ns >= root.end_ns for s in submits)
    pending = [r for r in rec.readings if r.name == "png.pending"]
    assert len(pending) == 2 and pending[0].value == 0
    assert all(r.unit == root.unit and 0 <= r.value <= 1 for r in pending)


def test_spans_share_the_profiler_clock(xl_bundle):
    """Each span's start and end lie within 100 us of its ``cfgpp.<name>``
    range in the profiler's raw events.  The collector is off meanwhile:
    a collection between a range's stamp and the span's clock read would
    delay the thread, not move its clock."""
    import gc
    from torch.profiler import ProfilerActivity, profile
    engine = _lightning(xl_bundle)
    with profiling.recording(), profile(activities=[ProfilerActivity.CPU]):
        _request(engine)                 # the first ranges' set-up costs
    gc.collect()
    gc.disable()
    try:
        with profiling.recording() as rec, \
                profile(activities=[ProfilerActivity.CPU]) as prof:
            _request(engine)
    finally:
        gc.enable()
    ranges = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(profiling.PREFIX):
            ranges[e.name()[len(profiling.PREFIX):]].append(
                (e.start_ns(), e.end_ns()))
    spans = collections.defaultdict(list)
    for s in rec.spans:
        spans[s.name].append((s.start_ns, s.end_ns))
    assert set(ranges) == set(spans)
    for name, got in spans.items():
        want = sorted(ranges[name])
        assert len(want) == len(got)
        for (a, b), (c, d) in zip(sorted(got), want):
            assert abs(a - c) < 100_000 and abs(b - d) < 100_000, name


def test_solver_loops_step_spans():
    """`step` spans in each loop: one a row, and DPM++ 2S's tail as step
    ``n_steps``; the unrolled loop's and the inversion's too."""
    from cfgpp_tpu_torch.schedules.ddim import make_ddim_schedule
    from cfgpp_tpu_torch.solvers import sampler
    from cfgpp_tpu_torch.solvers.plans import plan_ddim_inversion
    from cfgpp_tpu_torch.solvers.registry import get_solver_spec

    def eps_fn(z, t):
        return 0.1 * z, -0.1 * z
    z = torch.ones(1, 4, 4, 4)
    with profiling.recording() as rec:
        for name in ("ddim_cfg++", "dpm++_2s_a_cfg++"):
            spec = get_solver_spec(name, "sd")
            plan = spec.plan_fn(make_ddim_schedule(5, timestep_spacing=spec
                                                   .timestep_spacing))
            noise = (lambda i, like: torch.zeros_like(like)) \
                if plan.needs_noise else None
            sampler.run_solver(spec, plan, eps_fn, z, 0.5, noise_fn=noise)
            sampler.run_solver_unrolled(spec, plan, eps_fn, z, 0.5,
                                        noise_fn=noise)
        spec = get_solver_spec("ddim_inversion_cfg++", "sd")
        inv = plan_ddim_inversion(make_ddim_schedule(5))
        sampler.run_inversion(spec, inv, eps_fn, z, 0.5)
    steps = [s.attr for s in sorted(rec.named("step"),
                                    key=lambda s: s.start_ns)]
    n2s = get_solver_spec("dpm++_2s_a_cfg++", "sd").plan_fn(
        make_ddim_schedule(5)).n_steps
    ddim = list(range(5))
    two_s = list(range(n2s + 1))
    assert steps == ddim + ddim + two_s + two_s + list(range(inv.n_steps))


class _Event:
    def __init__(self, name, start, dur, corr=0, cuda=False, rid=0,
                 annotation=False):
        self._v = (name, start, dur, corr, cuda, rid, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[4]
                else torch.autograd.DeviceType.CPU)

    def device_resource_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def _span(name, sid, start, end, parent=None, root=False, thread=11,
          ident=2 ** 40 + 0x80000011, unit=1):
    return profiling.Span(name, sid, unit, parent, root, thread, ident,
                          start, end, 0)


def test_attribute_gives_each_span_its_device_work():
    """Launches go to the innermost span of the launching thread (by its
    native id or its pthread id cut to 32 bits), waits likewise; idle gaps
    are split over the units' thread's innermost spans; a graph replay's
    kernels count at its launch; device-side annotations are no work."""
    spans = [_span("batch", 1, 0, 1000, root=True),
             _span("text", 2, 0, 300, parent=1),
             _span("tokenize", 3, 0, 100, parent=2),
             _span("unet", 4, 400, 700, parent=1),
             _span("png.write", 5, 600, 900, thread=99, ident=2 ** 40 + 5)]
    low = -0x7FFFFFEF       # the main pthread id, cut to signed 32 bits
    events = [
        _Event("cudaMemcpyAsync", 50, 5, corr=1, rid=11),      # tokenize
        _Event("cudaStreamSynchronize", 60, 30, corr=2, rid=11),
        _Event("cudaLaunchKernel", 150, 5, corr=3, rid=low),   # text
        _Event("cudaGraphLaunch", 450, 5, corr=4, rid=11),     # unet
        _Event("cudaEventSynchronize", 650, 200, corr=5, rid=5),  # writer
        _Event("cudaLaunchKernel", 1100, 5, corr=6, rid=11),   # outside
        _Event("Memcpy HtoD", 80, 10, corr=1, cuda=True),
        _Event("sgemm", 200, 100, corr=3, cuda=True),
        _Event("k1", 450, 100, corr=4, cuda=True),
        _Event("k2", 550, 100, corr=4, cuda=True),
        _Event("cfgpp.unet", 450, 200, corr=0, cuda=True, annotation=True),
        _Event("late", 1150, 50, corr=6, cuda=True),
        _Event("nolaunch", 1300, 10, corr=77, cuda=True),
    ]
    att = profiling.attribute(events, spans)
    by = {s.name: att.spans[s.id] for s in spans}
    assert (by["tokenize"].launches, by["tokenize"].device_s) == (1, 1e-8)
    assert (by["tokenize"].waits, by["tokenize"].wait_s) == (1, 3e-8)
    assert (by["text"].launches, by["text"].device_s) == (1, 1e-7)
    assert (by["unet"].launches, by["unet"].device_s) == (2, 2e-7)
    assert (by["png.write"].waits, by["png.write"].launches) == (1, 0)
    assert by["batch"].launches == 0
    assert (att.outside.launches, att.outside.device_s) == (2, 6e-8)
    # busy: [80, 90) [200, 300) [450, 650) [1150, 1200) [1300, 1310)
    assert att.busy_s == pytest.approx(370e-9)
    # gaps: [90, 200) in tokenize 10 / text 100; [300, 450) batch 100 /
    # unet 50; [650, 1150) unet 50 / batch 300 / outside 150;
    # [1200, 1300) outside
    assert by["tokenize"].idle_s == pytest.approx(10e-9)
    assert by["text"].idle_s == pytest.approx(100e-9)
    assert by["unet"].idle_s == pytest.approx(100e-9)
    assert by["batch"].idle_s == pytest.approx(400e-9)
    assert by["png.write"].idle_s == 0
    assert att.outside.idle_s == pytest.approx(250e-9)
    total = att.total(spans[:4])
    assert total.launches == 4 and total.waits == 1


@pytest.mark.parametrize("name,wait", [
    ("cudaStreamSynchronize", True), ("cudaDeviceSynchronize", True),
    ("cudaEventSynchronize", True), ("cudaMemcpy", True),
    ("cudaMemcpyAsync", False), ("cudaLaunchKernel", False),
    ("cudaEventRecord", False), ("cudaStreamWaitEvent", False)])
def test_host_waits(name, wait):
    assert profiling.is_host_wait(name) is wait


def test_recorder_threads_lose_no_span():
    """Threads opening spans at once, with a short switch interval: every
    span is kept, with its own id, its thread's unit and its parent."""
    import sys
    n_threads, depth = 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    started = threading.Barrier(n_threads, timeout=60)   # all alive at
    try:                                                   # once: ids differ
        def work():
            started.wait()
            with profiling.unit("request"):
                for i in range(depth):
                    with profiling.span("step", i):
                        with profiling.span("unet"):
                            pass
        with profiling.recording() as rec:
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert len(rec.spans) == n_threads * (1 + 2 * depth)
    spans = {s.id: s for s in rec.spans}
    assert len(spans) == len(rec.spans)
    roots = [s for s in rec.spans if s.root]
    assert len({r.unit for r in roots}) == n_threads
    unit_of = {r.thread: r.unit for r in roots}
    for s in rec.spans:
        assert s.unit == unit_of[s.thread]
        if not s.root:
            parent = spans[s.parent]
            assert parent.thread == s.thread
            assert parent.name == {"step": "request", "unet": "step"}[s.name]
