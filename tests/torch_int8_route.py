"""The JAX package's int8 TPU route, run on the CPU, for the port's tests.

On the CPU, ``cfgpp_tpu``'s quantized modules take an XLA route whose 1x1
`QuantConv` is a dequantized-weight conv (``cfgpp_tpu/models/quant.py:
126-144``); on the TPU they run W8A8 through the Pallas kernels, as the port
does.  `emulate_tpu_route` makes ``jax.default_backend`` answer "tpu" and
runs the int8 kernels in interpret mode (erf gelu named explicitly, never
read from ``CFGPP_GELU``).  The Pallas kernels write bf16, so the port's
int8 wrappers round their outputs to bf16 too.  Test-time patches only:
nothing in either package changes.
"""

import functools

import jax
import torch

import cfgpp_tpu.kernels.int8_matmul as jax_int8
from cfgpp_tpu_torch.kernels import int8_matmul as tk
from cfgpp_tpu_torch.models import quant as tq
from cfgpp_tpu_torch.models import unet as tu


def _bf16_out(fn):
    return lambda *a, **k: fn(*a, **{**k, "out_dtype": torch.bfloat16}).float()


def emulate_tpu_route(monkeypatch) -> None:
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax_int8, "int8_matmul", functools.partial(
        jax_int8.int8_matmul, interpret=True))
    monkeypatch.setattr(jax_int8, "int8_ff_geglu", functools.partial(
        jax_int8.int8_ff_geglu, gelu="erf", interpret=True))
    monkeypatch.setattr(tq, "int8_matmul", _bf16_out(tk.int8_matmul))
    monkeypatch.setattr(tu, "int8_ff_geglu", _bf16_out(tk.int8_ff_geglu))
