"""The system under test: the port's `DiffusionEngine` of one configuration,
its weights drawn from the seed, and the loop that drives it as the mix
says.  This is the only module of the benchmark that imports the port, and
it imports only its public modules.

Spans: with tracing on, the harness wraps the engine's text encode, the
UNet module's ``forward`` and the VAE's ``decode``, and times each unit and
the batch loop's calls into the PNG writer, on the host clock (no synchronisation); while the
profiler runs, each span is also a ``torch.profiler.record_function`` range,
so the trace ties device work to it.
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

from bench_port import weights
from bench_port.traffic import Traffic, Unit

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
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


def check_config(port_cfg, config: Dict) -> None:
    """The port's preset must be the configuration file, key by key."""
    for part in ("unet", "vae", "text_encoder", "text_encoder_2"):
        ours = config.get(part)
        theirs = getattr(port_cfg, part)
        if (ours is None) != (theirs is None):
            raise ValueError(f"{config['name']}: {part} present on one side")
        if ours is None:
            continue
        for key, value in ours.items():
            got = getattr(theirs, key)
            got = list(got) if isinstance(got, tuple) else got
            if got != value:
                raise ValueError(f"{config['name']}.{part}.{key}: the port's "
                                 f"preset has {got!r}, the file {value!r}")


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
        from cfgpp_tpu_torch.configs import get_bundle_config
        from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle
        from cfgpp_tpu_torch.models.clip import CLIPTextModel
        from cfgpp_tpu_torch.models.unet import UNet2DConditionModel
        from cfgpp_tpu_torch.models.vae import AutoencoderKL
        from cfgpp_tpu_torch.weights.tokenizer import load_tokenizer

        self.config, self.mix = config, mix
        self.device = torch.device(device)
        cfg = get_bundle_config(config["preset"])
        check_config(cfg, config)
        dt = {k: DTYPES[v] for k, v in config["dtypes"].items()}
        with torch.device("meta"):
            made = {"unet": UNet2DConditionModel(cfg.unet).to(dt["unet"]),
                    "vae": AutoencoderKL(cfg.vae, compute_dtype=dt[
                        "vae_decode_compute"]).to(dt["vae"]),
                    "text_encoder": CLIPTextModel(cfg.text_encoder).to(
                        dt["text_encoder"])}
            if cfg.text_encoder_2 is not None:
                made["text_encoder_2"] = CLIPTextModel(
                    cfg.text_encoder_2).to(dt["text_encoder_2"])
        mods = {}
        for name, m in made.items():
            m = m.to_empty(device=self.device).eval().requires_grad_(False)
            mods[name] = weights.fill_(m, seed, name, dt[name])

        def tok(part, pad=None):
            c = getattr(cfg, part)
            return load_tokenizer(None, vocab_size=c.vocab_size,
                                  eos_token_id=c.eos_token_id,
                                  pad_token_id=pad)

        bundle = ModelBundle(
            config=cfg, unet=mods["unet"], vae=mods["vae"],
            text_encoder=mods["text_encoder"], tokenizer=tok("text_encoder"),
            text_encoder_2=mods.get("text_encoder_2"),
            tokenizer_2=(tok("text_encoder_2", 0) if "text_encoder_2" in mods
                         else None))
        if mix["quant"]:
            bundle = bundle.quantized(mix["quant"])
        self.bundle = bundle
        self.engine = DiffusionEngine(bundle, solver=mix["solver"],
                                      nfe=mix["nfe"])
        self.spans = Spans()
        self.writer = None
        self.out_dir = None

    # ------------------------------------------------------------- tracing
    def instrument(self) -> None:
        s = self.spans
        s.wrap(self.engine, "text_embed", "text")
        s.wrap(self.bundle.unet, "forward", "unet")
        s.wrap(self.bundle.vae, "decode", "vae")
        s.on = True

    # --------------------------------------------------------------- units
    def open_writer(self) -> None:
        from cfgpp_tpu_torch.utils.img import AsyncPngWriter
        self.out_dir = Path(tempfile.mkdtemp(prefix="bench_port_png_"))
        self.writer = AsyncPngWriter(n_threads=self.mix["writer_threads"])

    def release(self) -> None:
        """Drop the engine and its modules (the caller frees the memory)."""
        self.engine = self.bundle = None
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
        UNet, decode and writer shapes as the window's), then a sync."""
        from cfgpp_tpu_torch.engine import DiffusionEngine
        nfe = self.mix.get("warmup_nfe", self.mix["nfe"])
        engine = self.engine if nfe == self.mix["nfe"] else DiffusionEngine(
            self.bundle, solver=self.mix["solver"], nfe=nfe)
        unit = Traffic(self.mix, traffic_seed).next()
        if unit.indices is not None:       # apart from the window's files
            unit.indices = [WARMUP_INDEX + i for i in unit.indices]
        self.run_unit(unit, engine)
        self.finish()
        sync(self.device)
