"""The dequantized-weight 3x3 conv of ``--quant all`` against the JAX route.

`QuantConv._dequant_conv` serves every 3x3 int8 conv that
`int8_conv3x3_supported` rejects (43 per SD-1.5 UNet call at 512^2).  Its
counterpart is the fallback of ``cfgpp_tpu/models/quant.py:QuantConv``: the
weights dequantized to the compute dtype, one conv whose sum stays f32
(``preferred_element_type=f32``), + bias and + residual in f32, one rounding
to bf16.  Inputs from a numpy seed go to both, at the SD-1.5 channel widths
of the convs that take this route (1920->640, 1280->640, 640->640) and an
8x8 image, with and without the GroupNorm-SiLU prologue and the residual.

The measure is the share of bf16 output elements that differ from JAX's.
A conv that rounds its sum to bf16 before the f32 bias and residual adds
reads 16-29% here.  With the sum kept in f32, what is left are last-ulp f32
differences: the summation order, and in the prologue XLA's fused
multiply-add and its own logistic on the CPU, which flip about one bf16
input in 1e5, each reaching 9 x 640 outputs.  Over eight seeds each case
reads 1.6e-4 to 8.5e-4, so at most 1e-3 of the elements may differ (one
seed for every case).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgpp_tpu.models.quant import QuantConv as JaxQuantConv
from cfgpp_tpu_torch.models.quant import QuantConv

DIFFER_SHARE = 1e-3
SEED = 0


def _case(cin, cout, prologue, residual, seed):
    rng = np.random.default_rng(seed)
    b, h, w = 2, 8, 8
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wq = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    scale = (rng.uniform(0.5, 1.5, cout) / (127.0 * np.sqrt(9 * cin))
             ).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    kw = {}
    if prologue:
        kw["gn_scale"] = (1.0 + 0.2 * rng.standard_normal((b, cin))).astype(
            np.float32)
        kw["gn_bias"] = (0.3 * rng.standard_normal((b, cin))).astype(np.float32)
    if residual:
        kw["residual"] = rng.standard_normal((b, h, w, cout)).astype(np.float32)
    return x, wq, scale, bias, kw


def _bf16(a: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16, as f32."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("residual", [False, True], ids=["", "res"])
@pytest.mark.parametrize("prologue", [False, True], ids=["", "gn"])
@pytest.mark.parametrize("cin,cout", [(1920, 640), (1280, 640), (640, 640)])
def test_dequant_conv_matches_jax(cin, cout, prologue, residual):
    x, wq, scale, bias, kw = _case(cin, cout, prologue, residual, SEED)
    x, res = _bf16(x), kw.get("residual")
    if res is not None:
        kw["residual"] = res = _bf16(res)
    jmod = JaxQuantConv(cout, dtype=jnp.bfloat16)
    params = {"params": {"kernel": jnp.asarray(wq), "scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}}
    want = jmod.apply(params, jnp.asarray(x, jnp.bfloat16),
                      **{k: jnp.asarray(v, jnp.bfloat16 if k == "residual"
                                        else jnp.float32)
                         for k, v in kw.items()})
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))

    tmod = QuantConv(cin, cout, 3)._fill(
        torch.from_numpy(wq).permute(3, 0, 1, 2), torch.from_numpy(scale),
        torch.from_numpy(bias))
    xt = torch.from_numpy(x).bfloat16().permute(0, 3, 1, 2)
    got = tmod._dequant_conv(
        xt, *(None if kw.get(k) is None else torch.from_numpy(kw[k])
              for k in ("gn_scale", "gn_bias")),
        None if res is None else torch.from_numpy(res).bfloat16().permute(
            0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    differ = float(np.mean(got != want))
    print(f"{cin}->{cout} gn={prologue} res={residual}: {differ:.3e} of the"
          " bf16 elements differ from JAX's")
    assert differ <= DIFFER_SHARE
