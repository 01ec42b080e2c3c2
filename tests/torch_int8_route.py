"""The JAX package's int8 TPU route, run on the CPU, for the port's tests.

On the CPU, ``cfgpp_tpu``'s quantized modules take an XLA route whose
`QuantConv` is a dequantized-weight conv (``cfgpp_tpu/models/quant.py:
126-144``) and whose attention never takes the flash kernels; on the TPU
they run W8A8 through the Pallas kernels, as the port does.
`emulate_tpu_route` makes ``jax.default_backend`` answer "tpu" and runs the
Pallas kernels in interpret mode (erf gelu named explicitly, never read
from ``CFGPP_GELU``).  The int8 Pallas kernels write bf16, so the port's int8
wrappers round their outputs to bf16 too.

``force=True`` also routes every stride-1 pad-1 3x3 conv to the fused
conv kernel and every attention to the flash kernels (``FLASH_MIN_Q_LEN``
0), on both sides: at tiny widths the real predicates route nothing there.
Test-time patches only: nothing in either package changes.
"""

import functools
import importlib

import jax
import torch

import cfgpp_tpu.kernels.int8_matmul as jax_int8
from cfgpp_tpu.models import attention as jax_attention
from cfgpp_tpu_torch.kernels import flash_attention as tfa
from cfgpp_tpu_torch.kernels import int8_conv as tc
from cfgpp_tpu_torch.kernels import int8_matmul as tk
from cfgpp_tpu_torch.models import attention as ta
from cfgpp_tpu_torch.models import quant as tq
from cfgpp_tpu_torch.models import unet as tu

# cfgpp_tpu.kernels re-exports a function named flash_attention, which
# shadows the submodule as an attribute of the package
jax_fa = importlib.import_module("cfgpp_tpu.kernels.flash_attention")
jax_conv = importlib.import_module("cfgpp_tpu.kernels.int8_conv")
FLASH_FUNCTIONS = ("flash_attention", "flash_attention_hd",
                   "flash_attention_hd_int8", "flash_attention_qkv_packed",
                   "flash_attention_qkv_packed_int8")


def _bf16_out(fn):
    return lambda *a, **k: fn(*a, **{**k, "out_dtype": torch.bfloat16}).float()


def _conv_s1p1(x_shape, strides, padding, o=None) -> bool:
    return (strides in ((1, 1), None)
            and padding in (1, ((1, 1), (1, 1))))


def emulate_tpu_route(monkeypatch, force: bool = False) -> None:
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax_int8, "int8_matmul", functools.partial(
        jax_int8.int8_matmul, interpret=True))
    monkeypatch.setattr(jax_int8, "int8_ff_geglu", functools.partial(
        jax_int8.int8_ff_geglu, gelu="erf", interpret=True))
    monkeypatch.setattr(jax_conv, "int8_conv3x3", functools.partial(
        jax_conv.int8_conv3x3, interpret=True))
    for name in FLASH_FUNCTIONS:
        monkeypatch.setattr(jax_fa, name, functools.partial(
            getattr(jax_fa, name), interpret=True))
    monkeypatch.setattr(tq, "int8_matmul", _bf16_out(tk.int8_matmul))
    monkeypatch.setattr(tu, "int8_ff_geglu", _bf16_out(tk.int8_ff_geglu))
    monkeypatch.setattr(tq, "int8_conv3x3", _bf16_out(tc.int8_conv3x3))
    monkeypatch.setattr(ta, "flash_attention_qkv_packed_int8",
                        _bf16_out(tfa.flash_attention_qkv_packed_int8))
    if force:
        monkeypatch.setattr(jax_conv, "int8_conv3x3_supported", _conv_s1p1)
        monkeypatch.setattr(tq, "int8_conv3x3_supported", _conv_s1p1)
        monkeypatch.setattr(jax_attention, "FLASH_MIN_Q_LEN", 0)
        monkeypatch.setattr(tfa, "FLASH_MIN_Q_LEN", 0)
