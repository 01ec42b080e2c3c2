"""The port's f32 attention route against the JAX package.

The f32 kernel (``cfgpp_tpu_torch/csrc/flash_attention_f32.cu``) computes
the plain versions `flash_attention_hd_reference` and
`flash_attention_qkv_packed_reference` in f32; those are held here against
the Pallas TPU kernels run in interpret mode with f32 inputs, on both TPU
bodies (`_kernel_single`, and `_kernel_multi` through a forced
``block_kv``).  Tolerance 1e-5 x max|ref|: both sides compute the same f32
softmax and differ only in summation order and exp vs exp2.  The kernel
itself needs the card; ``chip_smoke.py`` holds it against the same plain
versions at 1e-4 x max|ref|.

`AutoencoderKL.encode`, which computes in f32 on every device and reaches
the kernel through its mid-block attention, is held against the JAX
package's f32 encode module (``ModelBundle.vae_encode``) on tiny_sd with the
weights bridged, within 1e-4 x max|ref|.  The rest covers the wrappers' and
the CLI's acceptance of f32.
"""

import argparse
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgpp_tpu.engine import ModelBundle as JaxBundle
from cfgpp_tpu.kernels.flash_attention import flash_attention_hd as jax_hd
from cfgpp_tpu.kernels.flash_attention import (
    flash_attention_qkv_packed as jax_packed)
from cfgpp_tpu_torch.cli import common
from cfgpp_tpu_torch.engine import ModelBundle
from cfgpp_tpu_torch.kernels import build
from cfgpp_tpu_torch.kernels import flash_attention as fa
from cfgpp_tpu_torch.utils import roofline as rl

REL_TOL = 1e-5


def _assert_rel(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want)))
    assert err <= tol * scale, f"{what}: max err {err} > {tol} x {scale}"


# (b, nq, nkv, heads, d, kv_len, block_kv): block_kv None -> _kernel_single
CASES = [
    (2, 64, 64, 8, 40, None, None),      # SD-1.5 level 0 heads, single body
    (1, 48, 77, 8, 40, None, None),      # cross-attention, kv=77
    (1, 37, 64, 4, 80, None, None),      # ragged q, level 1 heads
    (1, 32, 256, 1, 512, None, 128),     # VAE mid-block: streaming body
    (1, 24, 384, 1, 512, 300, 128),      # streaming body + masked tail
]


@pytest.mark.parametrize("b,nq,nkv,h,d,kv_len,block_kv", CASES)
def test_f32_reference_matches_pallas(b, nq, nkv, h, d, kv_len, block_kv):
    rng = np.random.default_rng(nq * nkv + d)
    q, k, v = (rng.standard_normal((b, n, h * d), np.float32)
               for n in (nq, nkv, nkv))
    want = jax_hd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h,
                  kv_len=kv_len, block_kv=block_kv, interpret=True)
    assert want.dtype == jnp.float32
    got = fa.flash_attention_hd(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), h, kv_len=kv_len)
    assert got.dtype == torch.float32
    _assert_rel(got.numpy(), want, REL_TOL, f"hd d={d}")


@pytest.mark.parametrize("b,n,h,d,block_kv", [
    (2, 64, 8, 40, None),     # _kernel_single, SD-1.5 level 0 heads
    (1, 48, 4, 80, None),     # _kernel_single, level 1 heads
    (1, 256, 1, 512, 128),    # _kernel_multi at the VAE's head dim
])
def test_f32_packed_reference_matches_pallas(b, n, h, d, block_kv):
    qkv = np.random.default_rng(n + d).standard_normal((b, n, 3 * h * d),
                                                       np.float32)
    want = jax_packed(jnp.asarray(qkv), h, block_kv=block_kv, interpret=True)
    got = fa.flash_attention_qkv_packed(torch.from_numpy(qkv), h)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _assert_rel(got.numpy(), want, REL_TOL, f"packed d={d}")


def test_vae_encode_matches_jax_f32_encode():
    """The port's f32 encode against ``ModelBundle.vae_encode`` (the JAX
    package's f32-compute encode module) on tiny_sd, weights bridged."""
    jb = JaxBundle.random_init("tiny_sd", seed=0, dtype=jnp.float32,
                               param_dtype=jnp.float32)
    rng = np.random.default_rng(13)
    jb.vae_params = jax.tree.map(
        lambda x: jnp.asarray(np.asarray(x) + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32)), jb.vae_params)
    tb = ModelBundle.from_flax("tiny_sd", jb.params(), dtype=torch.float32,
                               device="cpu")
    img = np.random.default_rng(14).uniform(-1, 1, (2, 16, 16, 3)).astype(
        np.float32)
    enc = jb.vae_encode
    want = enc.apply(jb.vae_params, jnp.asarray(img), method=enc.encode)
    fa.reset_launches()
    got = tb.vae.encode(torch.from_numpy(img))
    assert fa.launches == 0          # the CPU route is the plain version
    for g, w, what in zip(got, want, ("mean", "logvar")):
        assert g.dtype == torch.float32
        _assert_rel(g.numpy(), w, 1e-4, what)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_inputs_take_bf16_and_f32(dtype):
    t = torch.zeros(2, 16, 320, dtype=dtype)
    assert fa._check_kernel_inputs(8, 320, q=t, k=t.clone(), v=t.clone()) == 40
    assert fa._check_kernel_inputs(1, 512, qkv=torch.zeros(
        1, 8, 1536, dtype=dtype)) == 512


@pytest.mark.parametrize("odd", ["k", "v"])
def test_kernel_inputs_reject_mixed_and_other_dtypes(odd):
    t = {name: torch.zeros(2, 16, 320) for name in ("q", "k", "v")}
    t[odd] = t[odd].bfloat16()
    with pytest.raises(ValueError, match=f"{odd}: expected torch.float32"):
        fa._check_kernel_inputs(8, 320, **t)
    with pytest.raises(ValueError, match="expected bfloat16 or float32"):
        fa._check_kernel_inputs(8, 320, q=torch.zeros(2, 16, 320,
                                                      dtype=torch.float16))


def _args(*argv):
    parser = argparse.ArgumentParser()
    common.add_common_args(parser)
    return parser.parse_args(list(argv))


def test_cli_takes_float32_on_cuda_and_refuses_it_with_quant(monkeypatch):
    """``--quant dense|all`` with ``--dtype float32`` on a CUDA device is no
    longer refused: it builds the f32 bundle on that device and quantizes
    it in the requested mode (the int8 kernels take f32 activations)."""
    args = _args("--device", "cuda", "--dtype", "float32", "--model",
                 "tiny_sd")
    assert (args.device, args.dtype, args.quant) == ("cuda", "float32", None)
    built, quantized = [], []

    class Bundle:
        def quantized(self, mode):
            quantized.append(mode)
            return self

    def random_init(name, seed, dtype, device):
        built.append((dtype, device))
        return Bundle()

    monkeypatch.setattr(common.ModelBundle, "random_init", random_init)
    monkeypatch.setattr(common, "DiffusionEngine",
                        lambda bundle, solver, nfe: (bundle, solver, nfe))
    for quant in ("dense", "all"):
        for device in ("cuda", "cuda:0"):
            bundle, _, _ = common.build_engine(_args(
                "--device", device, "--dtype", "float32", "--quant", quant))
            assert isinstance(bundle, Bundle)
            assert built[-1] == (torch.float32, device)
            assert quantized[-1] == quant
    assert quantized == ["dense", "dense", "all", "all"]


def test_cli_float32_on_cuda_reaches_the_bundle(monkeypatch):
    """Without --quant, float32 on a CUDA device goes on to the bundle."""
    seen = {}

    class Stop(Exception):
        pass

    def random_init(name, seed, dtype, device):
        seen.update(dtype=dtype, device=device)
        raise Stop

    monkeypatch.setattr(common.ModelBundle, "random_init", random_init)
    with pytest.raises(Stop):
        common.build_engine(_args("--device", "cuda", "--dtype", "float32"))
    assert seen == {"dtype": torch.float32, "device": "cuda"}


def test_flash_attention_f32_bound():
    w = rl.flash_attention_f32(1, 4096, 4096, 1, 512)
    bf16 = rl.flash_attention(1, 4096, 4096, 1, 512)
    assert w.f32_flops == bf16.bf16_flops and w.bf16_flops == w.int8_ops == 0
    assert w.bytes == 2 * bf16.bytes == 4 * 512 * 4 * 4096
    assert w.bound_ms() == pytest.approx(34_359_738_368 / 67e12 * 1e3)
    assert w.bound_by() == "operations"


def test_build_lists_every_source():
    srcs = sorted(p.stem for p in Path(build.CSRC_DIR).glob("*.cu"))
    assert sorted(build.LIBRARIES) == srcs
    assert "flash_attention_f32" in srcs


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    """A library is rebuilt when a header its sources share changes
    (``int8_matmul.cu`` and ``int8_conv.cu`` include ``int8_gemm.cuh``)."""
    assert (Path(build.CSRC_DIR) / "int8_gemm.cuh").is_file()
    (tmp_path / "k.cu").write_text('#include "core.cuh"\n')
    (tmp_path / "core.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / "core.cuh").write_text("// two\n")
    assert build.library_path("k") != first
