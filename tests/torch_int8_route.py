"""The JAX package's int8 TPU route, run on the CPU, for the port's tests.

On the CPU, ``cfgpp_tpu``'s quantized modules take an XLA route whose
`QuantConv` is a dequantized-weight conv (``cfgpp_tpu/models/quant.py:
126-144``) and whose attention never takes the flash kernels; on the TPU
they run W8A8 through the Pallas kernels, as the port does.
`emulate_tpu_route` makes ``jax.default_backend`` answer "tpu" and runs the
Pallas kernels in interpret mode (erf gelu named explicitly, never read
from ``CFGPP_GELU``).  The int8 Pallas kernels write bf16 whatever they
read, and so do the port's int8 kernels and their plain versions: nothing
on the port's side is patched.

`round_cpu_route_writes` keeps the JAX package on its CPU route (W8A8 in
f32) but rounds its int8 outputs to bf16 where the TPU route's kernels
write them, and quantizes as those kernels do (``x * (1/sx)``), so that the
port can be held tightly against that route too.

``force=True`` also routes every stride-1 pad-1 3x3 conv to the fused
conv kernel and every attention to the flash kernels (``FLASH_MIN_Q_LEN``
0), on both sides: at tiny widths the real predicates route nothing there.
Test-time patches only: nothing in either package changes.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import cfgpp_tpu.kernels.int8_matmul as jax_int8
from cfgpp_tpu.models import attention as jax_attention
from cfgpp_tpu.models import quant as jax_quant
from cfgpp_tpu.models import unet as jax_unet
from cfgpp_tpu_torch.kernels import flash_attention as tfa
from cfgpp_tpu_torch.models import quant as tq

# cfgpp_tpu.kernels re-exports a function named flash_attention, which
# shadows the submodule as an attribute of the package
jax_fa = importlib.import_module("cfgpp_tpu.kernels.flash_attention")
jax_conv = importlib.import_module("cfgpp_tpu.kernels.int8_conv")
FLASH_FUNCTIONS = ("flash_attention", "flash_attention_hd",
                   "flash_attention_hd_int8", "flash_attention_qkv_packed",
                   "flash_attention_qkv_packed_int8")


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
    if force:
        monkeypatch.setattr(jax_conv, "int8_conv3x3_supported", _conv_s1p1)
        monkeypatch.setattr(tq, "int8_conv3x3_supported", _conv_s1p1)
        monkeypatch.setattr(jax_attention, "FLASH_MIN_Q_LEN", 0)
        monkeypatch.setattr(tfa, "FLASH_MIN_Q_LEN", 0)


def _bf16(y):
    return y.astype(jnp.bfloat16).astype(y.dtype)


def round_cpu_route_writes(monkeypatch) -> None:
    """The JAX package's CPU route with its int8 outputs rounded to bf16
    where the TPU route's kernels write them: the bias-free projections
    (to_qkv, to_q, to_k, to_v and the cross k/v, whose `int8_matmul` output
    the TPU route uses as it is), and each quantized attention's and
    feed-forward's output after its residual add (the last `int8_matmul` /
    `int8_ff_geglu` of the sublayer, residual fused).  The FF's f32 hidden
    state (a biased call) stays f32, as in the kernel.  proj_in/proj_out
    are not covered: the CPU-route tests do not run them.

    Its activation quantize multiplies by ``1/sx``, as the Pallas kernels
    and the port do, where ``quant_dense_apply`` divides by ``sx``; the
    dot and the dequant are ``quant_dense_apply``'s."""

    def dense(x, kernel, scale, bias, out_dtype):
        xf = x.astype(jnp.float32)
        amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
        sx = jnp.maximum(amax, 1e-6) * (1.0 / 127.0)
        xq = jnp.clip(jnp.round(xf * (1.0 / sx)), -127.0,
                      127.0).astype(jnp.int8)
        acc = jax.lax.dot_general(
            xq, kernel, (((x.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32)
        y = acc.astype(jnp.float32) * sx * scale
        if bias is not None:
            return (y + bias.astype(jnp.float32)).astype(out_dtype)
        return _bf16(y.astype(out_dtype))

    attn, ff = jax_attention.Attention._quant_forward, \
        jax_unet.FeedForward.__call__
    monkeypatch.setattr(jax_quant, "quant_dense_apply", dense)
    monkeypatch.setattr(jax_attention.Attention, "_quant_forward",
                        lambda self, *a, **k: _bf16(attn(self, *a, **k)))
    monkeypatch.setattr(
        jax_unet.FeedForward, "__call__",
        lambda self, *a, **k: _bf16(ff(self, *a, **k)) if self.quant
        else ff(self, *a, **k))


def bf16_values(a) -> np.ndarray:
    """f32 values rounded to bf16 (half to even), as f32."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def assert_pallas_bf16_write(got, unrounded, want, slack: float) -> None:
    """``got``: the port's output; ``unrounded``: its f32 value before the
    bf16 write; ``want``: the Pallas kernel's bf16 output.  ``got`` is
    ``unrounded`` rounded to bf16, and ``want`` is the bf16 rounding of a
    value within ``slack`` of ``unrounded``: equal to ``got`` except near a
    rounding tie, where an f32 rounding of either side's multiply-adds (XLA
    may contract one into an fma) can pick the other neighbour."""
    got, u = np.asarray(got, np.float32), np.asarray(unrounded, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == u.shape == want.shape
    np.testing.assert_array_equal(got, bf16_values(u))
    ok = (want >= bf16_values(u - slack)) & (want <= bf16_values(u + slack))
    assert ok.all(), (f"{(~ok).sum()} of {ok.size} elements are no bf16"
                      f" rounding of a value within {slack:.3g} of the port's")
