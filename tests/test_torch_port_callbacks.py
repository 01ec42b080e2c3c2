"""The port's callbacks and unrolled mode against cfgpp_tpu's, on tiny_sd.

``cfgpp_tpu_torch/engine/callbacks.py`` against ``cfgpp_tpu/engine/
callbacks.py``: the firing steps of ``DiffusionCallback`` at frequencies 1,
3 and 5 over 7 steps, the registry's error texts, and the PNG names that
``ComposeCallback``'s draw callbacks write (the batch form, a grid; the
per-sample form is in tests/test_torch_port_batch.py).  The engine's
fused replay (``sample(callback_fn=)``) against the JAX engine's with the
same zT injected: the (step, t) sequence equal, each replayed z0t and zt,
and a decode, within 1e-4 x max(1, scale).  The unrolled mode
(``sample(unrolled=True)``) with a callback that changes zt and z0t
against the JAX engine's unrolled mode, for ``ddim_cfg++``, ``dpm++_2m``
(the history term stays in the carry) and ``dpm++_2s_a`` (the tail after
the loop, on the JAX noise): the latents each callback sees and the
image, within 1e-4 x max(1, scale); and ``run_solver_unrolled`` against
JAX's for every solver kind on a synthetic eps, within 1e-5 x max(1,
scale) (f32, only the summation order differs).  The port alone: the
unrolled mode bit for bit the fused one on the CPU, a replayed mutation
ignored.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgpp_tpu.engine import DiffusionEngine as JaxEngine
from cfgpp_tpu.engine import callbacks as jax_callbacks
from cfgpp_tpu.schedules.ddim import make_ddim_schedule
from cfgpp_tpu.solvers import registry as jax_registry
from cfgpp_tpu.solvers import sampler as jax_sampler
from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle, callbacks
from cfgpp_tpu_torch.solvers import registry, sampler
from tests.test_torch_port_sdxl_models import _assert_close, jax_tiny_bundle
from tests.test_torch_port_solvers import _eps_jax, _eps_torch

NFE = 3
EXACT_TOL = 1e-4       # f32 both sides: summation order only
LOOP_TOL = 1e-5        # the synthetic-eps loops (tests/test_torch_port_solvers.py)
RES = 16               # tiny_sd: latents 8 x 8


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
    jb = jax_tiny_bundle("tiny_sd")
    tb = ModelBundle.from_flax("tiny_sd", jb.params(), dtype=torch.float32,
                               device="cpu")
    return jb, tb


class Recorder:
    """(step, t, z0t, zt) of every call, as numpy, and with ``decode`` the
    decode of the first z0t; passes the kwargs on (to ``then``, if
    given)."""

    def __init__(self, then=None, decode=False):
        self.seen, self.decoded, self.then = [], None, then
        self.decode = decode

    def __call__(self, step, t, kw):
        self.seen.append((step, t, np.array(kw["z0t"]), np.array(kw["zt"])))
        if self.decode and self.decoded is None:
            self.decoded = np.array(kw["decode"](kw["z0t"]))
        return self.then(step, t, kw) if self.then else kw


@pytest.mark.parametrize("frequency", [1, 3, 5])
def test_firing_steps_equal_jax(frequency, tmp_path):
    def fired(base):
        class Probe(base):
            def callback(self, step, t, kw):
                self.steps.append(step)
                return kw
        probe = Probe(frequency, tmp_path)
        probe.steps = []
        for step in range(7):
            assert probe(step, 999 - step, {"x": step}) == {"x": step}
        return probe.steps

    got = fired(callbacks.DiffusionCallback)
    assert got == fired(jax_callbacks.DiffusionCallback)
    assert got == [s for s in range(7) if s == 0 or (s + 1) % frequency == 0]


def _raised(fn):
    try:
        fn()
    except (KeyError, ValueError) as err:
        return type(err), str(err)
    raise AssertionError("no error raised")


def test_error_texts_equal_jax(tmp_path):
    for mod in (callbacks, jax_callbacks):
        assert mod.available_callbacks() == ["draw_noisy", "draw_tweedie"]
    for call in (lambda m: m.get_callback("draw_x", frequency=1,
                                          workdir=tmp_path),
                 lambda m: m.register_callback("draw_noisy")(type("C", (), {})),
                 lambda m: m.DiffusionCallback(0, tmp_path),
                 lambda m: m.ComposeCallback(tmp_path, ["nope"])):
        assert _raised(lambda: call(callbacks)) == \
            _raised(lambda: call(jax_callbacks))


def test_unrolled_trajectory_refused_as_jax(bundles):
    jb, tb = bundles
    kw = dict(cfg_guidance=0.6, resolution=RES, unrolled=True,
              return_trajectory=True)
    got = _raised(lambda: DiffusionEngine(tb, "ddim_cfg++", nfe=NFE).sample(
        ["", "a cat"], **kw))
    assert got == _raised(lambda: JaxEngine(jb, "ddim_cfg++", nfe=NFE).sample(
        ["", "a cat"], **kw))


def test_fused_replay_matches_jax(bundles, tmp_path):
    """A batch of 2 (a prompt list) with the recorder composed with both
    draw callbacks: the replay's (step, t), latents and a decode; the PNG
    names of the batch form (one grid a step) equal."""
    jb, tb = bundles
    prompt = ["", ["a photo of a cat", "a dog"]]
    zT = np.random.default_rng(3).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    runs = {}
    for name, engine, mod in (
            ("jax", JaxEngine(jb, "ddim_cfg++", nfe=NFE), jax_callbacks),
            ("port", DiffusionEngine(tb, "ddim_cfg++", nfe=NFE), callbacks)):
        draw = mod.ComposeCallback(tmp_path / name, ["draw_tweedie",
                                                     "draw_noisy"],
                                   frequency=2)
        rec = Recorder(then=draw, decode=True)
        img = engine.sample(prompt, cfg_guidance=0.6, resolution=RES,
                            init_latent_override=zT, callback_fn=rec)
        files = sorted(str(p.relative_to(tmp_path / name))
                       for p in (tmp_path / name).rglob("*.png"))
        runs[name] = (np.array(img), rec, files)
    (want_img, want, want_files), (img, got, files) = runs["jax"], runs["port"]
    assert [s[:2] for s in got.seen] == [s[:2] for s in want.seen]
    assert [s[:2] for s in got.seen] == [
        (i, int(t)) for i, t in enumerate(make_ddim_schedule(NFE).timesteps)]
    for (step, _, z0, zt), (_, _, wz0, wzt) in zip(got.seen, want.seen):
        _assert_close(z0, wz0, f"replayed z0t step {step}", EXACT_TOL)
        _assert_close(zt, wzt, f"replayed zt step {step}", EXACT_TOL)
    _assert_close(got.decoded, want.decoded, "callback decode", EXACT_TOL)
    _assert_close(img, want_img, "image", EXACT_TOL)
    assert files == want_files
    assert files == sorted(f"record/{sub}/{p}_{int(t)}.png"
                           for sub, p in (("noisy", "xt"), ("tweedie", "x0"))
                           for t in make_ddim_schedule(NFE).timesteps[[0, 1]])


def _mutate(step, t, kw):
    """Scale zt at step 1 and shift z0t at the last step: both feed back."""
    kw = dict(kw)
    if step == 1:
        kw["zt"] = kw["zt"] * 0.5
    if step == NFE - 1:
        kw["z0t"] = kw["z0t"] + 0.25
    return kw


def _jax_step_noise(seed, n_steps, shape):
    """The JAX engine's ancestral noise of a request: step i from
    fold_in(split(PRNGKey(seed), 3)[1], i) over the whole batch shape."""
    key = jax.random.split(jax.random.PRNGKey(seed), 3)[1]
    return np.stack([np.array(jax.random.normal(jax.random.fold_in(key, i),
                                                shape, jnp.float32))
                     for i in range(n_steps)])


@pytest.mark.parametrize("solver,w", [("ddim_cfg++", 0.6), ("dpm++_2m", 7.5),
                                      ("dpm++_2s_a", 7.5)])
def test_unrolled_mutating_matches_jax(bundles, solver, w):
    jb, tb = bundles
    engine = DiffusionEngine(tb, solver, nfe=NFE)
    zT = np.random.default_rng(5).standard_normal((1, 8, 8, 4)).astype(
        np.float32) * engine.plan.init_scale
    kw = dict(cfg_guidance=w, seed=9, resolution=RES, init_latent_override=zT,
              unrolled=True)
    want_rec, got_rec = Recorder(then=_mutate), Recorder(then=_mutate)
    want = np.array(JaxEngine(jb, solver, nfe=NFE).sample(
        ["", "a cat"], callback_fn=want_rec, **kw))
    noise = None
    if engine.plan.needs_noise:
        noise = _jax_step_noise(9, engine.plan.n_steps, zT.shape)
    got = engine.sample(["", "a cat"], callback_fn=got_rec,
                        noise_override=noise, **kw)
    assert [s[:2] for s in got_rec.seen] == [s[:2] for s in want_rec.seen]
    assert len(got_rec.seen) == engine.plan.n_steps
    for (step, _, z0, zt), (_, _, wz0, wzt) in zip(got_rec.seen,
                                                   want_rec.seen):
        _assert_close(z0, wz0, f"{solver} z0t step {step}", EXACT_TOL)
        _assert_close(zt, wzt, f"{solver} zt step {step}", EXACT_TOL)
    _assert_close(got, want, f"{solver} unrolled image", EXACT_TOL)
    plain = engine.sample(["", "a cat"], noise_override=noise, **kw)
    assert not torch.equal(plain, got), "the mutation did not feed back"


SAMPLING = [n for n in jax_registry.list_solvers("sd")
            if not jax_registry.get_solver_spec(n).inversion]


@pytest.mark.parametrize("name", SAMPLING)
def test_run_solver_unrolled_every_kind_matches_jax(name):
    """Every sampling solver's unrolled loop with `_mutate` on a synthetic
    eps: the final latent and every latent the callback saw."""
    spec, jspec = registry.get_solver_spec(name), jax_registry.get_solver_spec(name)
    sched = make_ddim_schedule(NFE)
    plan, jplan = spec.plan_fn(sched), jspec.plan_fn(sched)
    w = 0.6 if spec.cfgpp else 7.5
    zT = (np.random.default_rng(1).standard_normal((1, 8, 8, 4)).astype(
        np.float32) * plan.init_scale)
    key = jax.random.PRNGKey(7)
    want_rec, got_rec = Recorder(then=_mutate), Recorder(then=_mutate)
    decode = lambda z: z  # noqa: E731
    want = jax_sampler.run_solver_unrolled(
        jspec, jplan, _eps_jax, jnp.asarray(zT), w,
        noise_key=key if jplan.needs_noise else None, callback=want_rec,
        decode_fn=decode)

    def noise_fn(i, like):
        return torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(key, i), tuple(like.shape), jnp.float32)))

    got = sampler.run_solver_unrolled(
        spec, plan, _eps_torch, torch.from_numpy(zT), w,
        noise_fn=noise_fn if plan.needs_noise else None, callback=got_rec,
        decode_fn=decode)
    assert [s[:2] for s in got_rec.seen] == [s[:2] for s in want_rec.seen]
    for g, x in [(got, want)] + [(a, b) for gs, ws in zip(got_rec.seen,
                                                          want_rec.seen)
                                 for a, b in zip(gs[2:], ws[2:])]:
        _assert_close(g, x, name, LOOP_TOL)


def test_unrolled_equals_fused_and_replay_ignores_mutation(bundles):
    """On the CPU the unrolled loop runs the fused loop's operations in the
    same order: with a pass-through callback the images are bit for bit
    equal; a mutating callback changes the image only when unrolled."""
    _, tb = bundles
    engine = DiffusionEngine(tb, "dpm++_2m", nfe=NFE)
    kw = dict(cfg_guidance=7.5, seed=4, resolution=RES)
    plain = engine.sample(["", "a cat"], **kw)
    rec = Recorder()
    assert torch.equal(engine.sample(["", "a cat"], callback_fn=rec,
                                     unrolled=True, **kw), plain)
    assert torch.equal(engine.sample(["", "a cat"], callback_fn=_mutate, **kw),
                       plain)
    assert not torch.equal(engine.sample(["", "a cat"], callback_fn=_mutate,
                                         unrolled=True, **kw), plain)
    _, (z0s, zts) = engine.sample(["", "a cat"], return_trajectory=True, **kw)
    for (step, _, z0, zt) in rec.seen:
        assert np.array_equal(z0, z0s[step].numpy())
        assert np.array_equal(zt, zts[step].numpy())
