"""One UNet call replayed as a CUDA graph.

`UNet2DConditionModel.forward` hands every call to the module's
`GraphRunner`.  On a CUDA device with autograd off (``torch.no_grad`` or
inference mode, as every engine path runs), the runner captures the
module's eager body (``UNet2DConditionModel._forward_eager``) once per
input signature and replays it from then on: the host launches one graph
instead of the call's ~3000 operations.  Every other call (the CPU, the
meta device, autograd on) runs the eager body as it is.  SD3's MMDiT
(``models/mmdit.py``) hands its calls to a runner of its own the same way,
its pooled text vector in the place of SDXL's added embeds.

- **Signature** (`GraphRunner.key`): the device; shape, strides and dtype
  of ``sample``, ``timesteps``, the context, SDXL's added embeds and time
  ids (or their absence) and every ``cross_kv`` tensor, site by site;
  inference mode or not; the numerics switches that pick other kernels
  (`numerics`: cuDNN and cuBLAS TF32, cuDNN benchmark and deterministic
  modes, reduced-precision bf16/fp16 reductions); and the objects the UNet
  reaches its hand-written kernels through (`ROUTES`).  A caller that
  swaps a kernel for its plain version (the card checks) or for another
  build (the A/B tools), or turns TF32 on, gets a graph of its own and the
  result the eager body would give.  The quant form is the module's own.
- **Static inputs.**  ``sample`` and ``timesteps`` are copied into the
  graph's buffers at every call.  The context, the added embeds and ids
  and the ``cross_kv`` tensors change once a request: each is copied only
  when the caller passes another tensor than on the key's last call, or
  the same one with a newer ``_version`` (inference tensors keep no
  version: there, a new request's tensors are new objects).  The runner
  holds the last tensors it copied, so their memory cannot pass to a new
  tensor under the same address.
- **Output:** a clone of the graph's static output, so the caller never
  holds memory that the next replay overwrites (DPM++ 2M's history, the
  callbacks).
- **Capture** at a key's first call: the eager body once on a side stream
  (cuBLAS and cuDNN handles, the kernel libraries' one-time set-up), whose
  output the call returns, then the capture into a memory pool that all of
  the runner's graphs share (replays never overlap and outputs are
  cloned).  So the device runs one call's kernels at every
  call, and a profiler's trace holds one device event a launch.  At most
  `CAPACITY` keys are kept, the least recently used going first.  A
  capture that raises leaves its key eager for good, logged once; nothing
  else is caught.
- **Launch counters.**  The kernel wrappers' Python counters (`COUNTERS`)
  move only while Python runs the wrappers, which a replay does not.  The
  runner records each counter's move over the capture and adds it at
  every replay, so every call, whatever its path, adds one call's
  launches.
- **Engagement:** each call is counted in the span recorder
  (`cfgpp_tpu_torch.utils.profiling.count`) as ``unet.replay``,
  ``unet.capture`` or ``unet.eager`` (SD3's MMDiT: ``mmdit.*``); nothing
  when the recorder is off.

The backend (`CudaGraphs`) is the only part that touches CUDA graphs; a
stand-in with the same four methods runs every other part on the CPU.
"""

from __future__ import annotations

import collections
import functools
import importlib
import logging
from typing import Callable, List, Optional

import torch

from cfgpp_tpu_torch.utils import profiling

CAPACITY = 4

# The kernel wrappers' launch counters: (module, names).
COUNTERS = (
    ("cfgpp_tpu_torch.kernels.flash_attention",
     ("launches", "packed_launches", "int8_launches",
      "packed_int8_launches")),
    ("cfgpp_tpu_torch.kernels.int8_matmul", ("matmul_launches",
                                             "ff_launches")),
    ("cfgpp_tpu_torch.kernels.int8_conv", ("conv_launches",)),
)

# Where the UNet's modules reach a hand-written kernel: the wrappers as the
# model modules name them, the dequantized conv, and the libraries' loaders.
ROUTES = (
    ("cfgpp_tpu_torch.models.attention",
     ("flash_attention_hd", "flash_attention_qkv_packed",
      "flash_attention_qkv_packed_int8")),
    ("cfgpp_tpu_torch.models.quant",
     ("int8_matmul", "int8_conv3x3", "QuantConv._dequant_conv")),
    ("cfgpp_tpu_torch.models.unet", ("int8_ff_geglu",)),
    ("cfgpp_tpu_torch.kernels.flash_attention",
     ("_lib", "_lib_f32", "_lib_int8")),
    ("cfgpp_tpu_torch.kernels.int8_matmul", ("_lib",)),
    ("cfgpp_tpu_torch.kernels.int8_conv", ("_lib",)),
)

log = logging.getLogger(__name__)


@functools.lru_cache(maxsize=None)
def _attrs(table):
    """[(owner, name)] of a (module name, dotted names) table."""
    out = []
    for module, names in table:
        for dotted in names:
            owner = importlib.import_module(module)
            *path, name = dotted.split(".")
            for part in path:
                owner = getattr(owner, part)
            out.append((owner, name))
    return out


def read_counters() -> List[int]:
    return [getattr(m, n) for m, n in _attrs(COUNTERS)]


def write_counters(values: List[int]) -> None:
    for (m, n), v in zip(_attrs(COUNTERS), values):
        setattr(m, n, v)


def numerics() -> tuple:
    """The global switches under which cuDNN and cuBLAS pick kernels."""
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    return (cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic,
            mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction,
            mm.allow_fp16_reduced_precision_reduction)


def _sig(t: Optional[torch.Tensor]):
    return None if t is None else (t.shape, t.stride(), t.dtype)


def _version(t: torch.Tensor) -> Optional[int]:
    return None if t.is_inference() else t._version


class CudaGraphs:
    """The runner's backend on a CUDA device: `torch.cuda.CUDAGraph`, a
    side stream a device and one memory pool."""

    def __init__(self):
        self._streams, self._pool = {}, None

    @staticmethod
    def engages(sample: torch.Tensor) -> bool:
        return sample.is_cuda

    def _stream(self, device) -> torch.cuda.Stream:
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    def warm_up(self, device, fn: Callable[[], torch.Tensor]):
        """``fn()`` on the side stream, ordered after and before the
        current stream's work; its output is safe on the current stream."""
        side, cur = self._stream(device), torch.cuda.current_stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn()
        cur.wait_stream(side)
        out.record_stream(cur)
        return out

    def capture(self, device, fn: Callable[[], torch.Tensor]):
        """(graph, static output) of ``fn`` captured on the side stream."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.graph(
                graph, pool=self._pool, stream=self._stream(device),
                capture_error_mode="thread_local"):
            out = fn()
        return graph, out

    @staticmethod
    def replay(graph) -> None:
        graph.replay()


class _Entry:
    """One key's graph: its static inputs, the tensors last copied into
    them and their versions, its static output and counter moves; or
    ``graph`` None after a capture that raised (the key runs eagerly)."""
    __slots__ = ("graph", "inputs", "sources", "versions", "out", "deltas")

    def __init__(self):
        self.graph = self.out = None
        self.inputs, self.sources, self.versions, self.deltas = [], [], [], []


class GraphRunner:
    """A denoiser module's graphs, at most `CAPACITY` keys (least recently
    used first out).  ``backend``: `CudaGraphs` unless a test passes a
    stand-in.  ``name``: the denoiser's name in the counters
    (``<name>.replay`` ...); ``routes``: the kernel routes of its key, a
    table like `ROUTES` (SD3's MMDiT adds its own module's)."""

    def __init__(self, backend=None, name: str = "unet",
                 routes: tuple = ROUTES):
        self.backend = CudaGraphs() if backend is None else backend
        self.name, self.routes = name, routes
        self.entries: "collections.OrderedDict[tuple, _Entry]" = \
            collections.OrderedDict()

    def __deepcopy__(self, memo):
        """A copied module (`ModelBundle.quantized`) starts with no graph."""
        return GraphRunner(type(self.backend)(), self.name, self.routes)

    def clear(self) -> None:
        self.entries.clear()

    def key(self, flat: List[Optional[torch.Tensor]], sites: tuple) -> tuple:
        return (flat[0].device, sites, tuple(_sig(t) for t in flat),
                torch.is_inference_mode_enabled(), numerics(),
                tuple(getattr(m, n) for m, n in _attrs(self.routes)))

    def __call__(self, body: Callable, sample: torch.Tensor, timesteps,
                 context: torch.Tensor,
                 added_text_embeds: Optional[torch.Tensor] = None,
                 added_time_ids: Optional[torch.Tensor] = None,
                 cross_kv=None) -> torch.Tensor:
        """``body(sample, timesteps, context, added_text_embeds,
        added_time_ids, cross_kv)``, replayed where the runner engages."""
        entry = None
        if not torch.is_grad_enabled() and self.backend.engages(sample):
            t = torch.as_tensor(timesteps, device=sample.device)
            flat = [sample, t, context, added_text_embeds, added_time_ids]
            sites = None
            if cross_kv is not None:
                sites = tuple((s, len(layers))
                              for s, layers in cross_kv.items())
                flat += [x for layers in cross_kv.values()
                         for kv in layers for x in kv]
            key = self.key(flat, sites)
            entry = self.entries.get(key)
            if entry is None:
                return self._capture(key, body, flat, sites)
            self.entries.move_to_end(key)
        if entry is None or entry.graph is None:
            profiling.count(f"{self.name}.eager")
            return body(sample, timesteps, context, added_text_embeds,
                        added_time_ids, cross_kv)
        self._bind(entry, flat)
        profiling.count(f"{self.name}.replay")
        return self._replay(entry)

    def _bind(self, entry: _Entry, flat) -> None:
        """Copy this call's inputs into the entry's static buffers: the
        latent and timesteps always, the rest where they changed."""
        inputs, sources, versions = entry.inputs, entry.sources, entry.versions
        for i, x in enumerate(flat):
            if x is None:
                continue
            v = _version(x)
            if i < 2 or x is not sources[i] or v != versions[i]:
                inputs[i].copy_(x)
                sources[i], versions[i] = x, v

    def _replay(self, entry: _Entry) -> torch.Tensor:
        self.backend.replay(entry.graph)
        if any(entry.deltas):
            counters = read_counters()
            write_counters([c + d for c, d in zip(counters, entry.deltas)])
        return entry.out.clone()

    def _capture(self, key, body, flat, sites) -> torch.Tensor:
        entry = _Entry()
        entry.inputs = [None if x is None else torch.empty_like(x)
                        for x in flat]
        entry.sources = [None] * len(flat)
        entry.versions = [None] * len(flat)
        self._bind(entry, flat)
        run = _unflatten(body, entry.inputs, sites)
        device = flat[0].device
        out = self.backend.warm_up(device, run)
        warm = read_counters()
        try:
            entry.graph, entry.out = self.backend.capture(device, run)
        except RuntimeError as e:
            log.warning("%s call %s: CUDA graph capture failed (%s); this "
                        "signature runs eagerly", self.name,
                        [tuple(x.shape) for x in flat[:3]], e)
            write_counters(warm)
            entry = _Entry()
            profiling.count(f"{self.name}.eager")
        else:
            entry.deltas = [b - a for a, b in zip(warm, read_counters())]
            write_counters(warm)
            profiling.count(f"{self.name}.capture")
        self.entries[key] = entry
        while len(self.entries) > CAPACITY:
            self.entries.popitem(last=False)
        return out


def _unflatten(body, inputs, sites) -> Callable[[], torch.Tensor]:
    """``body`` over the static buffers, ``cross_kv`` rebuilt site by
    site."""
    ckv = None
    if sites is not None:
        it = iter(inputs[5:])
        ckv = {s: [(next(it), next(it)) for _ in range(n)] for s, n in sites}
    return lambda: body(*inputs[:5], ckv)
