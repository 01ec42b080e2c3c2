"""The port's ``parity_check`` CLI against ``cfgpp_tpu/cli/parity_check.py``.

* ``DUMP_SCHEMA`` equals the JAX CLI's, and the producer
  (``tools/dump_reference_traj.py``) writes exactly its keys (the check of
  ``tests/test_parity_schema.py``, on the port's schema);
* ``compare_trajectories`` equals the JAX function on seeded arrays;
* ``--quant_drift``: both CLIs' ``main`` on the same injected trajectories
  (each package's ``DiffusionEngine`` and ``ModelBundle`` replaced by a stub
  through ``monkeypatch``; nothing of the JAX package is edited) print the
  same JSON, key by key and value by value, and return the same exit code
  (the port's ``note`` leaves out the JAX note's calibration figures, which
  are the JAX package's own run);
* ``--dump``: a dump of each kind written by the port's own engine
  (tiny_sd, f32, CPU, 3 NFE, 32^2) from an HF-layout directory passes at
  MAE <= 1e-6; a corrupted one fails.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import cfgpp_tpu.engine as jax_engine
import cfgpp_tpu_torch.engine as port_engine
from cfgpp_tpu.cli import parity_check as jax_pc
from cfgpp_tpu_torch.cli import parity_check
from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle
from cfgpp_tpu_torch.weights.checkpoint import save_bundle

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch thread for this module's tiny tensors: the test workers
    share the cores, and oversubscribed intra-op threads stall each small
    op at its barrier."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_dump_schema_equals_jax():
    assert parity_check.DUMP_SCHEMA == jax_pc.DUMP_SCHEMA


def test_dump_tool_writes_schema_keys():
    """Every DUMP_SCHEMA key appears as a quoted literal in the producer, and
    its out-dict writes no key the schema lacks."""
    src = (REPO / "tools" / "dump_reference_traj.py").read_text()
    all_keys = {k for keys in parity_check.DUMP_SCHEMA.values() for k in keys}
    missing = [k for k in all_keys
               if not re.search(rf"[\"']{re.escape(k)}[\"']", src)]
    assert not missing, f"dump tool no longer writes keys: {missing}"
    m = re.search(r"out = \{(.*?)\n    \}", src, re.S)
    assert m, "dump tool out-dict not found"
    written = set(re.findall(r"[\"'](\w+)[\"']:", m.group(1)))
    assert written <= all_keys, written - all_keys


@pytest.mark.parametrize("shape", [(3, 1, 4, 4, 4), (5, 2, 8, 6, 4),
                                   (1, 1, 2, 2, 1)])
@pytest.mark.parametrize("ref_steps", [0, 2])
def test_compare_trajectories_equals_jax(shape, ref_steps):
    """The same rows and worst MAE, float for float; a reference with more
    steps is cut to ours, as in JAX."""
    rng = np.random.default_rng(sum(shape) + ref_steps)
    ours = [rng.standard_normal(shape, dtype=np.float32) for _ in range(2)]
    ref_shape = (shape[0] + ref_steps,) + shape[1:]
    ref = [rng.standard_normal(ref_shape, dtype=np.float32) for _ in range(2)]
    got = parity_check.compare_trajectories(*ours, *ref)
    want = jax_pc.compare_trajectories(*ours, *ref)
    assert got == want and len(got[0]) == shape[0]


# ------------------------------------------------------------ --quant_drift

def _trajectories(seed: int, scale: float, n: int = 6):
    """An exact (z0t, zt) trajectory and a quantized one ``scale`` x noise
    off it; zt on a sigma-like scale."""
    rng = np.random.default_rng(seed)
    z0 = rng.standard_normal((n, 1, 8, 8, 4), dtype=np.float32)
    zt = (z0 * np.linspace(14.0, 1.0, n, dtype=np.float32)[:, None, None,
                                                            None, None])
    noise = [rng.standard_normal(z0.shape, dtype=np.float32) for _ in range(2)]
    return (z0, zt), (z0 + scale * noise[0], zt + scale * noise[1])


def _stub(monkeypatch, module, trajs, to_tensor: bool):
    """Replace ``module.ModelBundle``/``DiffusionEngine`` with stubs whose
    exact and quantized engines return the injected trajectories."""
    seen = {}

    class Bundle:
        def __init__(self, quant=None):
            self.quant = quant

        @classmethod
        def random_init(cls, name, **kw):
            seen["model"] = name
            return cls()

        @classmethod
        def from_pretrained(cls, path, name, **kw):
            seen["ckpt"] = path
            return cls()

        def quantized(self, mode="dense"):
            seen["mode"] = mode
            return Bundle(mode)

    class Engine:
        def __init__(self, bundle, solver, nfe):
            self.traj = trajs[bundle.quant is not None]
            seen["solver"], seen["nfe"] = solver, nfe

        def sample(self, prompt, **kw):
            seen["sample"] = (prompt, kw)
            traj = tuple(torch.from_numpy(x) if to_tensor else x
                         for x in self.traj)
            return None, traj

    monkeypatch.setattr(module, "ModelBundle", Bundle)
    monkeypatch.setattr(module, "DiffusionEngine", Engine)
    return seen


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


DRIFT_CASES = [
    (0, 0.01, []),                                     # well inside 0.15
    (1, 0.02, ["--quant_mode", "dense"]),
    (2, 0.5, []),                                      # over the budget
    (3, 0.05, ["--quant_budget", "0.01", "--NFE", "6"]),
    (4, 0.0, ["--model", "sd15", "--method", "ddim_cfg++", "--cfg_guidance",
              "0.6", "--resolution", "512", "--prompt", "a cat",
              "--ckpt_dir", "weights"]),
]


@pytest.mark.parametrize("case", range(len(DRIFT_CASES)))
def test_quant_drift_json_equals_jax(case, monkeypatch, capsys):
    seed, scale, extra = DRIFT_CASES[case]
    trajs = _trajectories(seed, scale)
    seen_j = _stub(monkeypatch, jax_engine, trajs, to_tensor=False)
    rc_j = jax_pc.main(["--quant_drift", *extra])
    want = _last_json(capsys)
    seen_p = _stub(monkeypatch, port_engine, trajs, to_tensor=True)
    rc_p = parity_check.main(["--quant_drift", *extra, "--device", "cpu"])
    got = _last_json(capsys)
    assert list(got) == list(want)
    for key in want:
        if key != "note":
            assert got[key] == want[key], key
    # the port's note is the JAX note without its calibration clause (the
    # JAX package's own figures, not a measurement of the port)
    shared = want["note"][:want["note"].index("calibrated at")]
    assert got["note"] == parity_check.QUANT_NOTE
    assert got["note"].startswith(shared) and len(shared) > 100
    assert rc_p == rc_j == (0 if want["verdict"] == "WITHIN-INT8-BUDGET"
                            else 1)
    assert seen_p == seen_j


def test_drift_summary_takes_tensors_and_arrays():
    """Tensors give what their f32 arrays give; bf16 ones are read as f32."""
    exact, quant = _trajectories(5, 0.03)
    a = parity_check.drift_summary(exact, quant, 0.15)
    b = parity_check.drift_summary(tuple(map(torch.from_numpy, exact)),
                                   tuple(map(torch.from_numpy, quant)), 0.15)
    assert a == b and a["verdict"] == "WITHIN-INT8-BUDGET"
    bf = parity_check.drift_summary(
        exact, tuple(torch.from_numpy(x).bfloat16() for x in quant), 0.15)
    assert abs(bf["worst_rel_mae"] - a["worst_rel_mae"]) < 1e-2


def test_cuda_device_is_not_replaced_by_the_cpu(monkeypatch):
    """The default --device cuda without a GPU refuses to start."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parity_check.main(["--quant_drift"])


def test_dump_needs_ckpt_dir(capsys):
    for mod in (parity_check, jax_pc):
        with pytest.raises(SystemExit) as info:
            mod.main(["--dump", "x.npz"])
        assert info.value.code == 2
    assert capsys.readouterr().err.count(
        "--dump and --ckpt_dir are required unless --quant_drift") == 2


# ------------------------------------------------------------------ --dump

RES = 32


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A random tiny_sd bundle (f32, CPU) and its HF-layout directory."""
    bundle = ModelBundle.random_init("tiny_sd", seed=0, dtype=torch.float32,
                                     device="cpu")
    root = tmp_path_factory.mktemp("ckpt")
    save_bundle(bundle, root)
    return bundle, root


KINDS = {"t2i": ("ddim_cfg++", 3), "inversion": ("ddim_inversion_cfg++", 2),
         "edit": ("ddim_edit_cfg++", 2)}


def _dump(bundle, kind: str, seed: int) -> dict:
    solver, nfe = KINDS[kind]
    engine = DiffusionEngine(bundle, solver, nfe=nfe)
    s = RES // bundle.vae_scale_factor
    lat = np.random.default_rng(seed).standard_normal((1, s, s, 4),
                                                      dtype=np.float32)
    prompts = ["", "a cat", "a dog"] if kind == "edit" else ["", "a cat"]
    kw = ({"init_latent_override": lat} if kind == "t2i" else
          {"src_latent_override": lat,
           "src_img": np.zeros((1, RES, RES, 3), np.float32)})
    _, (z0s, zts) = engine.sample(prompts, cfg_guidance=0.6, resolution=RES,
                                  return_trajectory=True, **kw)
    dump = {"zT": lat, "z0t": z0s.numpy(), "zt": zts.numpy(),
            "prompt": prompts[-1], "null_prompt": "", "cfg_guidance": 0.6,
            "nfe": nfe, "method": solver, "model": "tiny_sd", "kind": kind,
            "seed": 42}
    if kind != "t2i":
        dump["src_latent"] = lat
    if kind == "edit":
        dump["src_prompt"] = prompts[1]
    assert set(dump) == set(parity_check.DUMP_SCHEMA[kind])
    return dump


def _run_dump(tmp_path, ckpt_dir, dump, capsys):
    path = tmp_path / "ref.npz"
    np.savez_compressed(path, **dump)
    rc = parity_check.main(["--dump", str(path), "--ckpt_dir", str(ckpt_dir),
                            "--dtype", "float32", "--device", "cpu"])
    return rc, _last_json(capsys)


@pytest.mark.parametrize("kind", list(KINDS))
def test_dump_round_trip_passes(kind, ckpt, tmp_path, capsys):
    bundle, root = ckpt
    dump = _dump(bundle, kind, seed=len(kind))
    rc, out = _run_dump(tmp_path, root, dump, capsys)
    assert rc == 0 and out["verdict"] == "PASS"
    assert out["worst_mae"] <= 1e-6 and out["tolerance"] == 1e-2
    assert [r["step"] for r in out["per_step"]] == list(range(len(dump["z0t"])))


@pytest.mark.parametrize("kind", list(KINDS))
def test_divergent_dump_fails(kind, ckpt, tmp_path, capsys):
    bundle, root = ckpt
    dump = _dump(bundle, kind, seed=7)
    dump["zt"] = dump["zt"] + 0.5 * (np.arange(len(dump["zt"])) == 1)[
        :, None, None, None, None].astype(np.float32)
    rc, out = _run_dump(tmp_path, root, dump, capsys)
    assert rc == 1 and out["verdict"] == "FAIL"
    assert out["per_step"][1]["mae_zt"] == pytest.approx(0.5, rel=1e-5)
    assert out["per_step"][0]["mae_zt"] <= 1e-6
