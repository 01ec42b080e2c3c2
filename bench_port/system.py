"""The system under test: the port's engine of one configuration, built by
the configuration's family (``bench_port/families/``) with its weights
drawn from the seed, and the loop that drives it as the mix says.  With
the families, this is the only part of the benchmark that imports the
port, and it imports only its public modules.

Spans: with tracing on, the harness wraps the calls that the family names
(``spans``), and times each unit and the batch loop's calls into the PNG
writer, on the host clock (no synchronisation); while the profiler runs,
each span is also a ``torch.profiler.record_function`` range, so the trace
ties device work to it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import shutil
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from bench_port import families
from bench_port.traffic import Traffic, Unit

WARMUP_INDEX = 10 ** 9


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Host-clock spans {name: [(start, end)]} of the harness's wrappers."""

    def __init__(self):
        self.on = False
        self.profiling = False
        self.times: Dict[str, List[tuple]] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        ctx = (torch.profiler.record_function(f"bench.{name}")
               if self.profiling else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            yield
        self.times.setdefault(name, []).append((t0, time.perf_counter()))

    def wrap(self, obj, attr: str, name: str) -> None:
        inner = getattr(obj, attr)

        def wrapped(*args, **kwargs):
            with self.span(name):
                return inner(*args, **kwargs)
        setattr(obj, attr, wrapped)


@dataclasses.dataclass
class Done:
    """One finished unit: its inputs, and where its images are."""
    unit: Unit
    latency_s: float
    images: Optional[np.ndarray] = None      # [B, H, W, 3] uint8 (requests)
    paths: Optional[List[Path]] = None       # PNGs on disk (batches)


class Program:
    """The port's engine on ``device``, with weights from ``seed``."""

    def __init__(self, config: Dict, mix: Dict, seed: int, device):
        self.config, self.mix = config, mix
        self.device = torch.device(device)
        self.family = families.load(config)
        self.family.check_config(config)
        self.engine = self.family.build(config, mix, seed, self.device)
        self.spans = Spans()
        self.writer = None
        self.out_dir = None

    # ------------------------------------------------------------- tracing
    def instrument(self) -> None:
        for obj, attr, name in self.family.spans(self):
            self.spans.wrap(obj, attr, name)
        self.spans.on = True

    # --------------------------------------------------------------- units
    def open_writer(self) -> None:
        from cfgpp_tpu_torch.utils.img import AsyncPngWriter
        self.out_dir = Path(tempfile.mkdtemp(prefix="bench_port_png_"))
        self.writer = AsyncPngWriter(n_threads=self.mix["writer_threads"])

    def release(self) -> None:
        """Drop the engine and its modules (the caller frees the memory)."""
        self.engine = None
        self.spans = Spans()

    def close(self) -> None:
        """Stop the writer's threads and delete the PNGs."""
        if self.writer is not None:
            self.writer.close()
            self.writer = None
        if self.out_dir is not None:
            shutil.rmtree(self.out_dir, ignore_errors=True)
            self.out_dir = None

    def run_unit(self, unit: Unit, engine=None) -> Done:
        """One call of the entry point.  A request returns when its uint8
        image is on the host; a batch returns when its PNG writes are
        queued (the writer waits for the device copy)."""
        engine = engine or self.engine
        mix = self.mix
        t0 = time.perf_counter()
        with self.spans.span("unit"):
            if mix["entry"] == "sample":
                img = engine.sample([mix["null_prompt"], unit.prompts[0]],
                                    cfg_guidance=mix["guidance"],
                                    seed=unit.seed,
                                    resolution=mix["resolution"])
                host = (img * 255.0 + 0.5).to(torch.uint8).cpu().numpy()
                return Done(unit, time.perf_counter() - t0, images=host)
            from cfgpp_tpu_torch.cli.text_to_mscoco import to_host
            u8 = engine.sample_batch(
                mix["null_prompt"], unit.prompts,
                cfg_guidance=mix["guidance"], seed=unit.seed,
                resolution=mix["resolution"], sample_indices=unit.indices,
                as_numpy=False, to_uint8=True)
            host, ready = to_host(u8)
            paths = [self.out_dir / f"{i:05d}.png" for i in unit.indices]
            with self.spans.span("png"):
                for j, path in enumerate(paths):
                    self.writer.submit(path, host[j].numpy(), ready=ready)
        return Done(unit, time.perf_counter() - t0, paths=paths)

    def finish(self) -> int:
        """Wait for every queued write; the number of failed writes."""
        return 0 if self.writer is None else self.writer.wait()

    def warm_up(self, traffic_seed: int) -> None:
        """One unit of the mix's shapes, with ``warmup_nfe`` steps (the same
        model, decode and writer shapes as the window's), then a sync."""
        nfe = self.mix.get("warmup_nfe", self.mix["nfe"])
        engine = self.engine if nfe == self.mix["nfe"] else \
            self.family.with_nfe(self.engine, self.mix, nfe)
        unit = Traffic(self.mix, traffic_seed).next()
        if unit.indices is not None:       # apart from the window's files
            unit.indices = [WARMUP_INDEX + i for i in unit.indices]
        self.run_unit(unit, engine)
        self.finish()
        sync(self.device)
