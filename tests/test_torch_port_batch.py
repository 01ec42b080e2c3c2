"""The port's ``sample_batch`` against cfgpp_tpu's, on tiny_sd and tiny_sdxl.

Bitwise RNG parity with jax.random is impossible, so the JAX engine's
per-sample draws are injected into the port: zT is the JAX package's
``init_latent_per_sample`` on ``fold_in(fold_in(PRNGKey(seed), i), 0)``
for sample i (its global index), the ancestral noise of sample i at step j
is ``normal(fold_in(fold_in(fold_in(PRNGKey(seed), i), 1), j))``
(``cfgpp_tpu/solvers/sampler.py:55-62``, through ``noise_override``) and
the encoded source latent of an inversion or edit is the JAX engine's
``_encode`` with the keys ``fold_in(fold_in(PRNGKey(seed), i), 2)``
(through ``src_latent_override``).  The JAX side runs ``sample_batch``
with its own keys.  Cases: ``ddim_cfg++`` (with both draw callbacks: the
per-sample record trees' PNG names equal), ``euler_a``,
``ddim_inversion_cfg++``, ``ddim_edit_cfg++`` with ``src_prompts``, and
tiny_sdxl ``dpm++_2m_cfgpp`` with ``prompts_2``: images within 1e-4 x
max(1, scale) (f32 both sides, summation order only).

The port alone: a sample's image is the same in a batch of 4 and alone
(1e-5 x max(1, scale): the CPU's matmuls may sum in another order at
another batch) for a sampling, an ancestral and an inversion solver;
`sample`'s streams are the ones it always had (zT from the seed, step i's
noise from (seed, 1, i), the encode draw from (seed, 2)) and never
coincide with a batch's; ``to_uint8`` byte for byte the JAX engine's rule;
``as_numpy=False`` returns a tensor on the bundle's device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgpp_tpu.engine import DiffusionEngine as JaxEngine
from cfgpp_tpu.engine import callbacks as jax_callbacks
from cfgpp_tpu.solvers.sampler import init_latent_per_sample as jax_init
from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle, callbacks
from cfgpp_tpu_torch.engine import pipeline
from cfgpp_tpu_torch.solvers import sampler
from tests.test_torch_port_sdxl_models import _assert_close, jax_tiny_bundle

NFE = 3
EXACT_TOL = 1e-4       # f32 both sides: summation order only
BATCH_TOL = 1e-5       # one image at two batch sizes, both the port's
RES = 16               # latents 8 x 8
SEED = 11
PROMPTS = ["a photo of a cat", "a red car", "two dogs on a beach"]
INDICES = [4, 1, 7]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch thread for this module's tiny tensors: the test workers
    share the cores, and oversubscribed intra-op threads stall each small
    op at its barrier."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def bundles():
    out = {}
    for name in ("tiny_sd", "tiny_sdxl"):
        jb = jax_tiny_bundle(name)
        out[name] = (jb, ModelBundle.from_flax(name, jb.params(),
                                               dtype=torch.float32,
                                               device="cpu"))
    return out


def sample_keys(seed, indices, tag):
    base = jax.random.PRNGKey(seed)
    return jnp.stack([jax.random.fold_in(jax.random.fold_in(base, i), tag)
                      for i in indices])


def jax_draws(jax_engine, seed, indices, src_imgs=None):
    """The JAX engine's per-sample zT, ancestral noise [n_steps, B, 8, 8, 4]
    and (for inversion solvers) encoded source latent."""
    plan, shape = jax_engine.plan, (len(indices), 8, 8, 4)
    out = {"init_latent_override": np.array(jax_init(
        plan, sample_keys(seed, indices, 0), shape))}
    if plan.needs_noise:
        noise_keys = sample_keys(seed, indices, 1)
        out["noise_override"] = np.stack([np.stack([np.array(
            jax.random.normal(jax.random.fold_in(k, j), shape[1:],
                              jnp.float32)) for k in noise_keys])
            for j in range(plan.n_steps)])
    if src_imgs is not None:
        out = {"src_latent_override": np.array(jax_engine._encode(
            jax_engine.bundle.vae_params, jnp.asarray(src_imgs),
            sample_keys(seed, indices, 2)))}
    return out


CASES = [
    ("tiny_sd", "ddim_cfg++", 0.6, {}),
    ("tiny_sd", "euler_a", 7.5, {}),
    ("tiny_sd", "ddim_inversion_cfg++", 0.6, {"src": True}),
    ("tiny_sd", "ddim_edit_cfg++", 0.6,
     {"src": True, "src_prompts": ["a cat", "a car", "dogs"]}),
    ("tiny_sdxl", "dpm++_2m_cfgpp", 5.0,
     {"prompts_2": ["an oil painting", "a sketch", "a photo"],
      "null_prompt_2": "blurry"}),
]


@pytest.mark.parametrize("model,solver,w,extra", CASES,
                         ids=[c[1] for c in CASES])
def test_sample_batch_matches_jax(bundles, tmp_path, model, solver, w, extra):
    jb, tb = bundles[model]
    jax_engine = JaxEngine(jb, solver, nfe=NFE)
    kw = dict(cfg_guidance=w, seed=SEED, resolution=RES,
              sample_indices=INDICES,
              **{k: v for k, v in extra.items() if k != "src"})
    src = None
    if extra.get("src"):
        src = np.random.default_rng(2).uniform(-1, 1, (3, RES, RES, 3)).astype(
            np.float32)
        kw["src_imgs"] = src
    with_callbacks = solver == "ddim_cfg++"
    draw = {}
    if with_callbacks:
        draw = {name: mod.ComposeCallback(tmp_path / name, ["draw_tweedie",
                                                            "draw_noisy"],
                                          frequency=2)
                for name, mod in (("jax", jax_callbacks),
                                  ("port", callbacks))}
    want = jax_engine.sample_batch("", PROMPTS, callback_fn=draw.get("jax"),
                                   **kw)
    got = DiffusionEngine(tb, solver, nfe=NFE).sample_batch(
        "", PROMPTS, callback_fn=draw.get("port"),
        **jax_draws(jax_engine, SEED, INDICES, src), **kw)
    assert isinstance(got, np.ndarray) and got.shape == (3, RES, RES, 3)
    _assert_close(got, want, f"{model} {solver} sample_batch", EXACT_TOL)
    if with_callbacks:
        names = {name: sorted(str(p.relative_to(tmp_path / name))
                              for p in (tmp_path / name).rglob("*.png"))
                 for name in draw}
        assert names["port"] == names["jax"]
        assert len(names["port"]) == 3 * 2 * 2 and all(
            n.startswith(tuple(f"record/{i:05d}/" for i in INDICES))
            for n in names["port"])


@pytest.mark.parametrize("solver", ["ddim_cfg++", "euler_a",
                                    "ddim_inversion_cfg++"])
def test_batch_invariance(bundles, solver):
    """Index 2 of a batch of 4 equals a batch-1 call with index 2: the
    streams are per sample, the UNet and decode per row."""
    _, tb = bundles["tiny_sd"]
    engine = DiffusionEngine(tb, solver, nfe=NFE)
    prompts = PROMPTS + ["a boat"]
    kw = dict(cfg_guidance=0.6, seed=SEED, resolution=RES)
    src = None
    if engine.spec.inversion:
        src = np.random.default_rng(3).uniform(-1, 1, (4, RES, RES, 3)).astype(
            np.float32)
    batch = engine.sample_batch("", prompts, sample_indices=[0, 1, 2, 3],
                                src_imgs=src, **kw)
    solo = engine.sample_batch("", prompts[2:3], sample_indices=[2],
                               src_imgs=None if src is None else src[2:3],
                               **kw)
    _assert_close(solo[0], batch[2], f"{solver} index 2", BATCH_TOL)
    assert not np.allclose(batch[2], batch[1])


def test_sample_streams_unchanged(bundles):
    """`sample`'s zT is a draw of the seed's generator, step i's noise one
    of (seed, 1, i)'s and the encode draw (seed, 2)'s, as before
    `sample_batch` came: injecting those draws reproduces it bit for bit."""
    _, tb = bundles["tiny_sd"]
    assert pipeline._stream_seed(42, 1, 3) == 29573552708655077
    assert pipeline._stream_seed(42, 2) == 2051868803964827357
    engine = DiffusionEngine(tb, "euler_a", nfe=NFE)
    shape = (1, 8, 8, 4)
    zT = torch.randn(shape, generator=torch.Generator().manual_seed(SEED)) \
        * engine.plan.init_scale
    noise = torch.stack([torch.randn(shape, generator=torch.Generator(
        ).manual_seed(pipeline._stream_seed(SEED, 1, i)))
        for i in range(engine.plan.n_steps)])
    kw = dict(cfg_guidance=7.5, seed=SEED, resolution=RES)
    assert torch.equal(engine.sample(["", "a cat"], **kw), engine.sample(
        ["", "a cat"], init_latent_override=zT, noise_override=noise, **kw))
    inv = DiffusionEngine(tb, "ddim_inversion_cfg++", nfe=NFE)
    src = torch.from_numpy(np.random.default_rng(4).uniform(
        -1, 1, (1, RES, RES, 3)).astype(np.float32))
    with torch.inference_mode():
        z0 = inv._encode(src, torch.Generator().manual_seed(
            pipeline._stream_seed(SEED, 2)))
    kw = dict(cfg_guidance=0.6, seed=SEED, resolution=RES, src_img=src)
    assert torch.equal(inv.sample(["", "a cat"], **kw), inv.sample(
        ["", "a cat"], src_latent_override=z0, **kw))


def test_batch_streams_differ_from_sample(bundles):
    _, tb = bundles["tiny_sd"]
    engine = DiffusionEngine(tb, "ddim_cfg++", nfe=NFE)
    kw = dict(cfg_guidance=0.6, seed=SEED, resolution=RES)
    one = engine.sample(["", "a cat"], **kw)
    batch = engine.sample_batch("", ["a cat"], sample_indices=[0], **kw)
    assert not np.allclose(one.numpy(), batch)
    request = {pipeline._stream_seed(s, *tags) for s in range(4)
               for tags in [(1, i) for i in range(8)] + [(2,)]} | set(range(4))
    per_sample = {pipeline._sample_seed(s, i, *tags) for s in range(4)
                  for i in range(8)
                  for tags in [(0,), (2,)] + [(1, j) for j in range(8)]}
    assert len(per_sample) == 4 * 8 * 10 and not request & per_sample


def test_init_latent_per_sample(bundles):
    _, tb = bundles["tiny_sd"]
    plan = DiffusionEngine(tb, "euler", nfe=NFE).plan
    gens = [torch.Generator().manual_seed(s) for s in (5, 6)]
    z = sampler.init_latent_per_sample(plan, gens, (2, 8, 8, 4))
    for row, s in zip(z, (5, 6)):
        want = torch.randn((8, 8, 4), generator=torch.Generator().manual_seed(
            s)) * plan.init_scale
        assert torch.equal(row, want)
    with pytest.raises(ValueError, match="1 generators for a batch of 2"):
        sampler.init_latent_per_sample(plan, gens[:1], (2, 8, 8, 4))


def test_to_uint8_matches_jax(bundles):
    jb, tb = bundles["tiny_sd"]
    rng = np.random.default_rng(0)
    # images in [0, 1] (the decode clamps): uniform, the half-way points
    # between levels, the levels themselves, the ends
    x = np.concatenate([rng.uniform(0, 1, 4096),
                        (np.arange(255) + 0.5) / 255.0, np.arange(256) / 255.0,
                        [0.0, 1.0, 0.5, np.nextafter(1.0, 0.0)]]).astype(
        np.float32)
    want = np.array(JaxEngine(jb, "ddim_cfg++", nfe=NFE)._to_uint8(
        jnp.asarray(x)))
    got = DiffusionEngine._to_uint8(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == np.uint8
    assert np.array_equal(got, want)


def test_as_numpy_false_and_to_uint8(bundles):
    _, tb = bundles["tiny_sd"]
    engine = DiffusionEngine(tb, "ddim_cfg++", nfe=2)
    kw = dict(cfg_guidance=0.6, seed=SEED, resolution=RES)
    f32 = engine.sample_batch("", PROMPTS[:2], as_numpy=False, **kw)
    u8 = engine.sample_batch("", PROMPTS[:2], as_numpy=False, to_uint8=True,
                             **kw)
    assert isinstance(f32, torch.Tensor) and f32.device == tb.device
    assert f32.dtype == torch.float32 and u8.dtype == torch.uint8
    assert torch.equal(u8, DiffusionEngine._to_uint8(f32))
    assert np.array_equal(engine.sample_batch("", PROMPTS[:2], to_uint8=True,
                                              **kw), u8.numpy())


def test_sample_batch_errors_as_jax(bundles):
    jb, tb = bundles["tiny_sd"]
    for solver, kw, match in (
            ("ddim_edit_cfg++", {}, "edit solver ddim_edit_cfg\\+\\+ needs"
                                    " src_prompts"),
            ("ddim_inversion_cfg++", {}, "solver ddim_inversion_cfg\\+\\+"
                                         " needs src_imgs")):
        for engine in (JaxEngine(jb, solver, nfe=NFE),
                       DiffusionEngine(tb, solver, nfe=NFE)):
            with pytest.raises(ValueError, match=match):
                engine.sample_batch("", ["a cat"], cfg_guidance=0.6,
                                    resolution=RES, **kw)
    engine = DiffusionEngine(tb, "ddim_cfg++", nfe=NFE)
    with pytest.raises(ValueError, match="2 sample_indices for 1 prompts"):
        engine.sample_batch("", ["a cat"], sample_indices=[0, 1])
