"""The UNet's CUDA graph runner (`cfgpp_tpu_torch.models.unet_graph`) on the
CPU, through a stand-in backend.

`Rerun` has `CudaGraphs`' four methods: "capture" runs the body once over
the runner's static buffers and keeps it, "replay" runs it again into the
same static output with the kernel counters held still, as a graph's
replay leaves Python's counters.  So every part of the runner but the CUDA
calls runs here: the key, the copies into the static buffers (a buffer
left stale shows as a result that differs from the eager body's), the
cloned output, the LRU bound, the counter moves, the engagement counter,
and the eager paths (the CPU's real backend, autograd on, a capture that
raises).  The card check (replay against the eager body bit for bit at
SDXL's 1024^2 shapes) is ``chip_smoke.phase_unet_graph``.
"""

import copy
import logging
import sys
import types

import pytest
import torch

from cfgpp_tpu_torch.configs import get_bundle_config
from cfgpp_tpu_torch.models import attention
from cfgpp_tpu_torch.models import unet_graph
from cfgpp_tpu_torch.models.unet import (UNet2DConditionModel,
                                         precompute_cross_kv)
from cfgpp_tpu_torch.models.unet_graph import GraphRunner
from cfgpp_tpu_torch.utils import profiling

PRESETS = ("tiny_sdxl", "tiny_sd")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch thread for this module's tiny tensors (the test workers
    share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Rerun:
    """CPU stand-in for `unet_graph.CudaGraphs`."""

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


class Raises(Rerun):
    @staticmethod
    def capture(device, fn):
        raise RuntimeError("operation not permitted when stream is capturing")


@pytest.fixture(scope="module")
def unets():
    torch.manual_seed(0)
    return {p: UNet2DConditionModel(get_bundle_config(p).unet).eval()
            .requires_grad_(False) for p in PRESETS}


@pytest.fixture
def staged(unets):
    """``stage(preset, backend=Rerun)``: the preset's UNet with a new
    runner on that backend (the module's own runner back afterwards)."""
    kept = {p: u.graphs for p, u in unets.items()}

    def stage(preset, backend=Rerun):
        unets[preset].graphs = GraphRunner(backend())
        return unets[preset]
    yield stage
    for p, u in unets.items():
        u.graphs = kept[p]


def conditioning(unet, batch, seed, with_kv=True):
    """(context, added embeds and ids, cross_kv or None) of one request."""
    cfg = unet.config
    gen = torch.Generator().manual_seed(seed)
    ctx = torch.randn(batch, 77, cfg.cross_attention_dim, generator=gen)
    added = ()
    if cfg.addition_embed_type == "text_time":
        pooled = cfg.projection_class_embeddings_input_dim \
            - 6 * cfg.addition_time_embed_dim
        added = (torch.randn(batch, pooled, generator=gen),
                 torch.tensor([[64.0, 64.0, 0.0, 0.0, 64.0, 64.0]])
                 .expand(batch, 6) * (1 + seed))
    ckv = precompute_cross_kv(unet, ctx) if with_kv else None
    return ctx, added, ckv


def latent(batch, size, seed):
    gen = torch.Generator().manual_seed(100 + seed)
    return torch.randn(batch, size, size, 4, generator=gen)


def call(unet, z, t, cond, eager=False):
    """One UNet call, through ``forward`` or (``eager``) the eager body."""
    ctx, added, ckv = cond
    if eager:
        return unet._forward_eager(z, t, ctx, *(added or (None, None)), ckv)
    return unet(z, t, ctx, *added, cross_kv=ckv)


def paths(rec):
    return [r.name.split(".")[1] for r in rec.readings
            if r.name.startswith("unet.")]


@pytest.mark.parametrize("with_kv", [True, False], ids=["cross_kv", "no_kv"])
@pytest.mark.parametrize("preset", PRESETS)
def test_replay_equals_eager_across_requests(staged, preset, with_kv):
    """Three requests of three steps: each request brings a new context,
    added conditioning and cross_kv, each step a new latent and timestep;
    every replay equals the eager body on the same inputs."""
    unet = staged(preset)
    with torch.inference_mode(), profiling.recording() as rec:
        for r in range(3):
            cond = conditioning(unet, 2, r, with_kv)
            for s in range(3):
                z, t = latent(2, 8, 3 * r + s), torch.tensor(999.0 - 300 * s)
                got = call(unet, z, t, cond)
                want = call(unet, z, t, cond, eager=True)
                assert torch.equal(got, want), (r, s)
    assert paths(rec) == ["capture"] + ["replay"] * 8
    assert len(unet.graphs.entries) == 1


def test_inputs_changed_in_place_are_copied(staged):
    """The same context and cross_kv tensors, changed in place between
    calls (autograd off, not inference mode: their versions move)."""
    unet = staged("tiny_sdxl")
    with torch.no_grad():
        ctx, added, ckv = conditioning(unet, 2, 0)
        z, t = latent(2, 8, 0), torch.tensor(500.0)
        call(unet, z, t, (ctx, added, ckv))
        for k in range(2):
            ctx.mul_(1.5)
            added[0].add_(1.0)
            next(iter(ckv.values()))[0][1].mul_(-1.0)
            got = call(unet, z, t, (ctx, added, ckv))
            want = call(unet, z, t, (ctx, added, ckv), eager=True)
            assert torch.equal(got, want), k


@pytest.mark.parametrize("preset", PRESETS)
def test_new_signature_captures_anew(staged, preset):
    unet = staged(preset)
    shapes = [(2, 8), (16, 8), (2, 16), (2, 8), (16, 8)]
    with torch.inference_mode(), profiling.recording() as rec:
        for i, (b, size) in enumerate(shapes):
            cond = conditioning(unet, b, i)
            z, t = latent(b, size, i), torch.tensor(400.0 + i)
            got = call(unet, z, t, cond)
            assert torch.equal(got, call(unet, z, t, cond, eager=True))
    assert paths(rec) == ["capture"] * 3 + ["replay"] * 2
    assert len(unet.graphs.entries) == 3


def test_lru_bound_evicts_the_least_recently_used(staged):
    unet = staged("tiny_sd")
    batches = list(range(1, unet_graph.CAPACITY + 2))
    cond = {b: conditioning(unet, b, b) for b in batches}
    t = torch.tensor(300.0)

    def run(b):
        with profiling.recording() as rec:
            call(unet, latent(b, 8, b), t, cond[b])
        return paths(rec)

    with torch.inference_mode():
        for b in batches[:-1]:
            assert run(b) == ["capture"]
        assert run(batches[0]) == ["replay"]     # 1 is now the most recent
        assert run(batches[-1]) == ["capture"]   # evicts 2
        assert len(unet.graphs.entries) == unet_graph.CAPACITY
        assert run(batches[0]) == ["replay"]
        assert run(batches[1]) == ["capture"]


def test_output_does_not_alias_the_next_replay(staged):
    unet = staged("tiny_sdxl")
    cond = conditioning(unet, 2, 0)
    with torch.inference_mode():
        first = call(unet, latent(2, 8, 0), torch.tensor(900.0), cond)
        kept = first.clone()
        second = call(unet, latent(2, 8, 1), torch.tensor(600.0), cond)
        third = call(unet, latent(2, 8, 2), torch.tensor(300.0), cond)
    (entry,) = unet.graphs.entries.values()
    assert torch.equal(first, kept)
    assert not torch.equal(second, third)
    for out in (first, second, third):
        assert out.untyped_storage().data_ptr() \
            != entry.out.untyped_storage().data_ptr()


def test_launch_counters_move_by_one_call_whatever_the_path(staged,
                                                            monkeypatch):
    """A counter that moves inside the body (as a kernel wrapper's does):
    the capturing call, each replay and each eager call add one call's
    launches; the kernels' own counters do not move on the CPU."""
    fake = types.ModuleType("unet_graph_test_counters")
    fake.calls = 0
    monkeypatch.setitem(sys.modules, fake.__name__, fake)
    monkeypatch.setattr(unet_graph, "COUNTERS",
                        unet_graph.COUNTERS + ((fake.__name__, ("calls",)),))
    unet = staged("tiny_sdxl")

    def count(module, inputs):
        fake.calls += 2                  # two "launches" a call
    hook = unet.conv_in.register_forward_pre_hook(count)
    kernels = unet_graph.read_counters()[:-1]
    cond = conditioning(unet, 2, 0)
    try:
        with torch.inference_mode():
            seen = []
            for s in range(4):
                call(unet, latent(2, 8, s), torch.tensor(100.0 * s), cond)
                seen.append(fake.calls)
        with torch.no_grad():             # another key: capture, replay
            for s in range(2):
                call(unet, latent(2, 8, s), torch.tensor(100.0 * s), cond)
                seen.append(fake.calls)
        call(unet, latent(2, 8, 0), torch.tensor(1.0), cond)   # eager
        seen.append(fake.calls)
    finally:
        hook.remove()
    assert seen == [2, 4, 6, 8, 10, 12, 14]
    assert unet_graph.read_counters()[:-1] == kernels


def test_engagement_counter_and_a_capture_that_raises(staged, caplog):
    """``unet.capture`` then ``unet.replay`` under the recorder; a capture
    that raises: logged once, its key eager from then on, the result the
    eager body's; nothing recorded with the recorder off."""
    unet = staged("tiny_sdxl", Raises)
    cond = conditioning(unet, 2, 0)
    z, t = latent(2, 8, 0), torch.tensor(250.0)
    with caplog.at_level(logging.WARNING, logger=unet_graph.__name__), \
            torch.inference_mode(), profiling.recording() as rec:
        outs = [call(unet, z, t, cond) for _ in range(3)]
        want = call(unet, z, t, cond, eager=True)
    assert paths(rec) == ["eager"] * 3
    assert all(torch.equal(o, want) for o in outs)
    assert len(caplog.records) == 1
    assert "capture failed" in caplog.records[0].getMessage()
    (entry,) = unet.graphs.entries.values()
    assert entry.graph is None

    unet = staged("tiny_sdxl")
    kept = profiling.start_recording()
    profiling.stop_recording()
    with torch.inference_mode():
        call(unet, z, t, cond)
        call(unet, z, t, cond)
        with profiling.recording() as rec:
            call(unet, z, t, cond)
    assert kept.readings == [] and paths(rec) == ["replay"]


@pytest.mark.parametrize("path", ["cpu_backend", "autograd_on"])
def test_eager_paths_run_the_body_as_before(unets, staged, path):
    """The CPU under the real backend, and autograd on under any backend,
    run the eager body bit for bit, capture nothing and count ``eager``."""
    unet = unets["tiny_sdxl"] if path == "cpu_backend" \
        else staged("tiny_sdxl")
    runner = unet.graphs
    assert isinstance(runner.backend, unet_graph.CudaGraphs
                      if path == "cpu_backend" else Rerun)
    cond = conditioning(unet, 2, 0)
    z, t = latent(2, 8, 0), torch.tensor(700.0)
    mode = torch.inference_mode() if path == "cpu_backend" \
        else torch.enable_grad()
    with mode, profiling.recording() as rec:
        got = call(unet, z, t, cond)
        want = call(unet, z, t, cond, eager=True)
    assert torch.equal(got, want)
    assert paths(rec) == ["eager"]
    assert len(runner.entries) == 0


@pytest.mark.parametrize("switch", ["plain_kernel", "tf32"])
def test_swapped_kernel_or_numerics_gets_its_own_graph(staged, monkeypatch,
                                                       switch):
    """A caller that swaps the attention wrapper (a check's plain version,
    an A/B tool's other build) or flips TF32 gets a capture of its own, and
    the swapped route's result."""
    unet = staged("tiny_sd")
    cond = conditioning(unet, 2, 0)
    z, t = latent(2, 8, 0), torch.tensor(350.0)
    with torch.inference_mode():
        before = call(unet, z, t, cond)
        seen = []
        if switch == "plain_kernel":
            kernel = attention.flash_attention_hd

            def scaled(q, k, v, num_heads, kv_len=None):
                seen.append(1)
                return kernel(q, k, v, num_heads, kv_len) * 0.5
            monkeypatch.setattr(attention, "flash_attention_hd", scaled)
        else:
            monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                                not torch.backends.cudnn.allow_tf32)
        with profiling.recording() as rec:
            got = call(unet, z, t, cond)
        want = call(unet, z, t, cond, eager=True)
    assert paths(rec) == ["capture"]
    assert torch.equal(got, want)
    assert len(unet.graphs.entries) == 2
    if switch == "plain_kernel":
        assert seen and not torch.equal(got, before)


def test_copies_and_moves_start_without_graphs(staged):
    unet = staged("tiny_sd")
    with torch.inference_mode():
        call(unet, latent(2, 8, 0), torch.tensor(10.0),
             conditioning(unet, 2, 0))
    assert len(unet.graphs.entries) == 1
    twin = copy.deepcopy(unet)
    assert len(twin.graphs.entries) == 0
    assert isinstance(twin.graphs.backend, Rerun)
    assert twin.graphs is not unet.graphs
    unet.to(torch.float32)
    assert len(unet.graphs.entries) == 0


@pytest.mark.parametrize("preset,solver,guidance", [
    ("tiny_sdxl", "ddim_cfg++_lightning", 1.0),
    ("tiny_sd", "dpm++_2m_cfgpp", 0.6),
], ids=["lightning", "dpm2m"])
def test_requests_with_other_prompts_equal_eager(preset, solver, guidance):
    """Two requests in a row with different prompts through the engine
    (DPM++ 2M keeps the last eps as its history term), replayed, against
    the same requests with the UNet eager."""
    from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle
    bundle = ModelBundle.random_init(preset, seed=0, dtype=torch.float32,
                                     device="cpu")
    engine = DiffusionEngine(bundle, solver=solver, nfe=4)
    prompts = (["", "a cat"], ["", "a red bicycle on the moon"])

    def requests():
        return [engine.sample(p, cfg_guidance=guidance, seed=3,
                              resolution=64) for p in prompts]

    want = requests()
    bundle.unet.graphs = GraphRunner(Rerun())
    with profiling.recording() as rec:
        got = requests()
    assert not torch.equal(want[0], want[1])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    calls = len(paths(rec))
    assert paths(rec) == ["capture"] + ["replay"] * (calls - 1)
    assert calls >= 4


def test_span_cells_reads_the_replay_share():
    """``tools/span_cells.py``'s readout of the counter, stretch by
    stretch."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "tools" / "span_cells.py"
    spec = importlib.util.spec_from_file_location("span_cells", path)
    span_cells = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(span_cells)
    with profiling.recording() as warm:
        profiling.count("unet.capture")
        profiling.count("unet.replay")
        profiling.gauge("png.pending", 3)
    with profiling.recording() as window:
        for _ in range(3):
            profiling.count("unet.replay")
        profiling.count("unet.eager")
    out = span_cells.unet_graph({"warm_up": [warm], "window": [window] * 2,
                                 "none": []})
    assert out["warm_up"] == {"calls": 2, "replay": 1, "capture": 1,
                              "eager": 0, "replay_share_pct": 50.0}
    assert out["window"] == {"calls": 8, "replay": 6, "capture": 0,
                             "eager": 2, "replay_share_pct": 75.0}
    assert out["none"] == {"calls": 0, "replay": 0, "capture": 0,
                           "eager": 0, "replay_share_pct": None}
