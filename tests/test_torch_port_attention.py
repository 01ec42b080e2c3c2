"""The port's attention kernel module against the Pallas kernel it replaces.

`cfgpp_tpu_torch.kernels.flash_attention.flash_attention_hd_reference` (the
plain PyTorch version of the Hopper kernel, and what the wrapper computes on
a CPU tensor) is held against `cfgpp_tpu.kernels.flash_attention.
flash_attention_hd` run in Pallas interpret mode, on both TPU bodies: the
single-block max-free `_kernel_single` and, with a forced ``block_kv``, the
streaming `_kernel_multi`.  The CUDA kernel itself needs the card; it is
held against the same reference by ``chip_smoke.py``.

Tolerance 1e-5 abs in f32: both sides compute the same softmax in f32 and
differ only in summation order and exp vs exp2.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgpp_tpu.kernels.flash_attention import flash_attention_hd as jax_flash_hd
from cfgpp_tpu.models import attention as jax_attention
from cfgpp_tpu_torch.kernels import flash_attention as fa
from cfgpp_tpu_torch.models import attention as torch_attention

ATOL = 1e-5


def _qkv(seed, b, nq, nkv, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, h * d), np.float32)
            for n in (nq, nkv, nkv)]


@pytest.mark.parametrize("b,nq,nkv,h,d,kv_len,block_kv", [
    (1, 64, 64, 8, 40, None, None),      # SD-1.5 level 0 heads, self
    (2, 48, 77, 8, 64, None, None),      # cross-attention, kv=77
    (1, 37, 64, 4, 80, None, None),      # ragged q, SD-1.5 level 1 heads
    (1, 16, 77, 2, 160, None, None),     # SD-1.5 level 2 heads, cross
    (1, 64, 128, 8, 40, 77, None),       # kv pre-padded to 128, kv_len=77
    (1, 32, 32, 1, 512, None, None),     # VAE mid-block, single head
    (1, 40, 256, 2, 64, None, 128),      # forced block_kv -> _kernel_multi
    (1, 24, 384, 1, 512, 300, 128),      # streaming body + masked tail, d=512
])
def test_reference_matches_pallas_interpret(b, nq, nkv, h, d, kv_len, block_kv):
    q, k, v = _qkv(nq * nkv + d, b, nq, nkv, h, d)
    want = np.asarray(jax_flash_hd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   h, kv_len=kv_len, block_kv=block_kv,
                                   interpret=True))
    got = fa.flash_attention_hd_reference(torch.from_numpy(q), torch.from_numpy(k),
                                          torch.from_numpy(v), h, kv_len=kv_len)
    assert got.shape == (b, nq, h * d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("fn,masked,kv_len", [
    ("attention_hd", False, 70),   # unmasked -> the kernel slot, padded kv
    ("attention_hd", True, 70),    # masked -> plain f32 softmax, kv sliced
    ("sdpa", False, None),
    ("sdpa", True, None),
])
def test_dispatch_matches_jax(fn, masked, kv_len):
    """`models.attention` dispatch against cfgpp_tpu's (XLA on the CPU)."""
    b, n, m, h, d = 2, 20, 77, 4, 16
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s, np.float32)
               for s in ((b, n, h * d), (b, m, h * d), (b, m, h * d)))
    nk = kv_len or m
    mask = (np.where(rng.random((1, 1, n, nk)) < 0.3, -np.inf, 0.0)
            .astype(np.float32) if masked else None)
    if masked:
        mask[..., 0] = 0.0          # every row keeps one column
    if fn == "attention_hd":
        want = jax_attention.attention_hd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, kv_len=kv_len,
            mask=None if mask is None else jnp.asarray(mask))
        got = torch_attention.attention_hd(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), h,
            kv_len=kv_len, mask=None if mask is None else torch.from_numpy(mask))
    else:
        q4, k4, v4 = (a.reshape(b, -1, h, d) for a in (q, k, v))
        want = jax_attention.sdpa(jnp.asarray(q4), jnp.asarray(k4), jnp.asarray(v4),
                                  None if mask is None else jnp.asarray(mask))
        got = torch_attention.sdpa(torch.from_numpy(q4), torch.from_numpy(k4),
                                   torch.from_numpy(v4),
                                   None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_uses_reference_without_launch(dtype):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(3, 2, 33, 77, 8, 40))
    fa.reset_launches()
    out = fa.flash_attention_hd(q, k, v, 8, kv_len=70)
    ref = fa.flash_attention_hd_reference(q, k, v, 8, kv_len=70)
    assert out.dtype == dtype
    assert torch.equal(out, ref)
    assert fa.launches == 0


def test_wrapper_rejects_other_devices_and_bad_shapes():
    q = torch.empty(1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention_hd(q, q, q, 1)
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 8, 16, 2, 40))
    with pytest.raises(ValueError, match="kv_len"):
        fa.flash_attention_hd(q, k, v, 2, kv_len=17)
    with pytest.raises(ValueError, match="divisible"):
        fa.flash_attention_hd(q, k, v, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_wrapper_on_cpu_uses_reference_without_launch(dtype):
    """The packed entry point's plain version is `flash_attention_hd_reference`
    on the three channel thirds."""
    b, n, h, d = 2, 37, 8, 40
    qkv = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (b, n, 3 * h * d), np.float32)).to(dtype)
    fa.reset_launches()
    out = fa.flash_attention_qkv_packed(qkv, h)
    q, k, v = qkv.split(h * d, dim=2)
    assert out.dtype == dtype and out.shape == (b, n, h * d)
    assert torch.equal(out, fa.flash_attention_hd_reference(q, k, v, h))
    assert fa.launches == fa.packed_launches == 0


def test_packed_wrapper_rejects_other_devices_and_bad_shapes():
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention_qkv_packed(torch.empty(1, 8, 96, device="meta"), 2)
    with pytest.raises(ValueError, match="packed"):
        fa.flash_attention_qkv_packed(torch.zeros(1, 8, 100), 2)


def test_import_needs_no_compiler_or_gpu():
    """Importing the wrapper builds nothing: nvcc and the card are needed
    only at the first launch on a CUDA tensor."""
    code = ("import sys, cfgpp_tpu_torch.kernels.flash_attention as fa\n"
            "assert 'cfgpp_tpu_torch.kernels.build' not in sys.modules\n"
            "assert 'triton' not in sys.modules\n"
            "assert fa.launches == fa.packed_launches == 0\n"
            "import cfgpp_tpu_torch.kernels.int8_matmul as q\n"
            "assert q.matmul_launches == q.ff_launches == 0\n"
            "assert 'cfgpp_tpu_torch.kernels.build' not in sys.modules\n")
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=Path(__file__).parents[1])
    assert proc.returncode == 0, proc.stderr
