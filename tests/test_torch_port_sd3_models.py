"""SD3's modules in the port (``models/mmdit.py``, ``models/t5.py``, the
16-channel VAE decoder without its post-quant conv) against the plain
float32 reference of the benchmark's SD3 family
(``bench_port/families/sd3_mmdit/plain.py``, written apart from the
port from the published equations), at the ``tiny_sd3`` preset, on the
same weights drawn from a seed; the position table's crop and T5's
relative-position buckets against their formulas.

Both sides compute in float32 on the CPU; what differs is the order of the
sums (the port's attention is the flash kernel's plain version, the
reference's the head-blocked matmuls; the port's norms take float32
statistics of float32 inputs, the reference's too), hence tolerances of a
few float32 ulps of the values' scale, not bit equality.
"""

import math

import numpy as np
import pytest
import torch

from bench_port import check
from bench_port.families.sd3_mmdit import plain as ref_mod
from bench_port.system import Program
from bench_port.tests.sd3_tiny import tiny_sd3_cell
from cfgpp_tpu_torch.configs_sd3 import get_sd3_config
from cfgpp_tpu_torch.models import mmdit, t5

SEED = 2 ** 31 + 17


@pytest.fixture(scope="module")
def pair():
    cell = tiny_sd3_cell()
    prog = Program(cell["config"], cell["mix"], SEED, "cpu")
    ref = check.reference(cell["config"], SEED, "cpu")
    return cell, prog.engine.bundle, ref.modules()


def close(got, want, scale_tol=1e-5):
    """Within ``scale_tol`` of the reference's largest magnitude: float32
    sums in another order."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.abs().max().item()
    assert err <= scale_tol * max(scale, 1.0), (err, scale)


def test_weights_are_the_reference_weights(pair):
    _, bundle, ref = pair
    for name in ("transformer", "text_encoder_3"):
        ours = dict(getattr(bundle, name).named_parameters())
        theirs = dict(ref[name].named_parameters())
        assert set(ours) == set(theirs), name
        for key, p in theirs.items():
            assert torch.equal(ours[key].float(), p), key


def test_mmdit_forward(pair):
    cell, bundle, ref = pair
    c = cell["config"]["transformer"]
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 8, 8, 16, generator=gen)
    ctx = torch.randn(2, 77 + 16, c["joint_attention_dim"], generator=gen)
    pooled = torch.randn(2, c["pooled_projection_dim"], generator=gen)
    t = torch.tensor([812.5])
    with torch.no_grad():
        want = ref["transformer"](x, t, ctx, pooled)
        got = bundle.transformer(x, t, ctx, pooled)
    assert got.dtype == torch.float32 and got.shape == x.shape
    close(got, want)


def test_the_last_block_is_context_pre_only(pair):
    _, bundle, _ = pair
    names = set(bundle.transformer.state_dict())
    last = len(bundle.transformer.transformer_blocks) - 1
    for part in ("attn.to_add_out.weight", "ff_context.net.2.weight"):
        assert f"transformer_blocks.0.{part}" in names
        assert f"transformer_blocks.{last}.{part}" not in names
    assert bundle.transformer.state_dict()[
        f"transformer_blocks.{last}.norm1_context.linear.weight"].shape[0] \
        == 2 * 32
    assert "pos_embed.pos_embed" in names


def test_t5_forward(pair):
    cell, bundle, ref = pair
    ids = torch.tensor([[5, 77, 300, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                        [1] + [0] * 15])
    with torch.no_grad():
        close(bundle.text_encoder_3(ids), ref["text_encoder_3"](ids))


def test_the_16_channel_decoder(pair):
    _, bundle, ref = pair
    assert bundle.vae.post_quant_conv is None and bundle.vae.quant_conv is None
    z = torch.randn(1, 8, 8, 16, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        close(bundle.vae.decode(z), ref["vae"](z), 1e-4)


def test_the_position_table_crop_is_the_formula():
    """The port's table at published width, cropped to a 64 x 64 grid (a
    1024^2 image), against pos * 10000^(-k / (d/4)) written out, and
    against the reference's own crop."""
    c = get_sd3_config("sd35_large").transformer
    d, m, base = c.inner_dim, c.pos_embed_max_size, c.sample_size // 2
    table = mmdit.sincos_table(d, m, base).reshape(m, m, d)
    top = (m - 64) // 2
    crop = table[top:top + 64, top:top + 64].reshape(-1, d)
    assert top == 64
    rng = np.random.default_rng(0)
    for row, col in [(0, 0), (63, 0), (0, 63), *rng.integers(0, 64, (5, 2))]:
        for k in (0, 1, 300, d // 4 - 1):
            w = 10000.0 ** (-k / (d / 4))
            prow, pcol = (top + row) / (m / base), (top + col) / (m / base)
            got = crop[row * 64 + col]
            assert got[k] == pytest.approx(math.sin(pcol * w), abs=1e-12)
            assert got[d // 4 + k] == pytest.approx(math.cos(pcol * w),
                                                    abs=1e-12)
            assert got[d // 2 + k] == pytest.approx(math.sin(prow * w),
                                                    abs=1e-12)
            assert got[3 * d // 4 + k] == pytest.approx(math.cos(prow * w),
                                                        abs=1e-12)
    theirs = ref_mod.position_table(d, m, base, 64, 64).numpy()
    np.testing.assert_allclose(crop, theirs, rtol=0, atol=1e-9)


def test_the_tiny_crop_is_off_the_corner():
    """tiny_sd3's 6 x 6 table cropped to its 4 x 4 grid starts at (1, 1)."""
    c = get_sd3_config("tiny_sd3").transformer
    pe = mmdit.PatchEmbed(c)
    table = pe.pos_embed.reshape(6, 6, -1)
    x = torch.zeros(1, 16, 8, 8)
    with torch.no_grad():
        pe.proj.weight.zero_()
        pe.proj.bias.zero_()
        got = pe(x).reshape(4, 4, -1)
    assert torch.equal(got, table[1:5, 1:5])


def bucket_by_hand(rel: int, buckets=32, max_distance=128) -> int:
    half = buckets // 2
    out = half if rel > 0 else 0
    n = abs(rel)
    exact = half // 2
    if n < exact:
        return out + n
    far = exact + int(math.log(n / exact) / math.log(max_distance / exact)
                      * (half - exact))
    return out + min(far, half - 1)


def test_t5_buckets_beyond_max_distance():
    rel = torch.arange(-400, 401)
    got = t5.relative_position_bucket(rel, 32, 128)
    assert got.tolist() == [bucket_by_hand(int(r)) for r in rel]
    far = rel.abs() >= 128
    assert set(got[far & (rel > 0)].tolist()) == {31}
    assert set(got[far & (rel < 0)].tolist()) == {15}
    assert torch.equal(ref_mod.t5_buckets(rel, 32, 128), got)
