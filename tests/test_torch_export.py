"""The port's serving export (``otpose_tpu_torch/engine/export.py``,
``cli/export.py``) on the CPU, mirroring tests/test_export.py, and held
against the JAX package's artifact.

One model: the JAX init's keys and shapes with numpy values
(tests/helpers/torch_port.py), the offset and mask convs calibrated, carried
to the port by ``jax_bridge``; ``tiny_otpose_cfg(image_size=32,
heatmap_size=8)``, f32, B = 2.  The tiny temporal encoders have C = 136, so
the exported programs hold the fused attention, fused MLP and DCN ops (their
CPU implementations run here).  Exports are shared through one module-scoped
cache.

- a loaded artifact equals the live step bit for bit: the heatmap step, and
  the decoded step without the flip (baked) and with it (external weights);
- external weights equal baked ones bit for bit, a bf16 sidecar to bf16
  tolerance, and the code-only program is under half the baked one's size;
- a wrong batch is rejected, by the loaded model and by the program;
- the port's heatmap artifact against the JAX package's ``export_eval`` ->
  ``save_exported`` -> ``load_exported`` from the same weights: heatmaps and
  teacher to 1e-3 of their peak (the 7-tuple bar);
- both export CLIs from one reference-layout ``.pth`` agree the same way on
  the decoded keypoints; the port's CLI refuses a checkpoint that matches 0
  tensors;
- a fresh process loads an artifact and serves one call through
  ``tools/serve.py`` without importing ``otpose_tpu_torch.models``.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otpose_tpu.cli.export import main as jax_export_main
from otpose_tpu.engine.export import export_eval as jax_export_eval
from otpose_tpu.engine.export import load_exported as jax_load_exported
from otpose_tpu.engine.export import save_exported as jax_save_exported
from otpose_tpu.models.otpose import OTPoseSpec as JaxSpec
from otpose_tpu.models.otpose import _init_otpose_impl
from otpose_tpu.utils.testing import tiny_otpose_cfg as jax_tiny_cfg
from otpose_tpu_torch.cli.export import main as export_main
from otpose_tpu_torch.engine.export import export_eval, load_exported, save_exported
from otpose_tpu_torch.engine.trainer import make_decoded_eval_step, make_eval_step
from otpose_tpu_torch.models.factory import build_model
from otpose_tpu_torch.models.jax_bridge import load_jax_weights
from otpose_tpu_torch.ops.cuda import deform_conv, fused_attn, fused_mlp
from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

from tests.helpers.torch_port import calibrate_refinement, numpy_weights, one_torch_thread  # noqa: F401,E501

pytestmark = pytest.mark.usefixtures("one_torch_thread")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 2


def _cfgs():
    return jax_tiny_cfg(image_size=32, heatmap_size=8), tiny_otpose_cfg(image_size=32,
                                                                       heatmap_size=8)


@pytest.fixture(scope="module")
def case():
    jcfg, tcfg = _cfgs()
    jspec = JaxSpec.from_cfg(jcfg)
    params, state = numpy_weights(_init_otpose_impl, jspec)
    rng = np.random.RandomState(0)
    x = rng.randn(B, 32, 32, 15).astype(np.float32)
    margin = np.array([[1, 1, 2, 2], [1, 0, 2, 0]], np.float32)
    calibrate_refinement(params, state, x, margin, cfg=tcfg)
    spec, model = build_model(tcfg, device="cpu")
    load_jax_weights(model, params, state)
    return jspec, params, state, spec, model, x, margin


@pytest.fixture(scope="module")
def artifact(case, tmp_path_factory):
    """``artifact(name, **export_eval kwargs)``: the saved and loaded
    artifact, exported once per name."""
    _, _, _, spec, model, _, _ = case
    root = tmp_path_factory.mktemp("torch_export")
    cache = {}

    def get(name, **kw):
        if name not in cache:
            kw.setdefault("decoded", True)
            exported = export_eval(model, batch_size=B, device="cpu", **kw)
            out = save_exported(str(root / name), exported, spec, batch_size=B,
                                compute_dtype=torch.float32, flip=kw.get("flip", False),
                                decoded=kw["decoded"])
            cache[name] = (out, load_exported(out, device="cpu"))
        return cache[name]

    return get


def _tensors(x, margin):
    return torch.from_numpy(x), torch.from_numpy(margin)


def _close_to_peak(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    peak = np.abs(want).max()
    assert peak > 0, what
    err = np.abs(got - want).max()
    assert err <= tol * peak, f"{what}: {err:.3e} over a peak of {peak:.3e}"


def _decoded_agree(got, want, heat):
    """Decoded keypoints of two packages: maxvals to 1e-3 of their peak,
    coords equal wherever the heatmap's top-two gap exceeds 1e-3 of its peak
    (a near-tie may decode to another cell)."""
    coords, maxvals, _ = (np.asarray(t, np.float64) for t in got)
    w_coords, w_maxvals, _ = (np.asarray(t, np.float64) for t in want)
    _close_to_peak(maxvals, w_maxvals, 1e-3, "maxvals")
    flat = np.sort(np.asarray(heat, np.float64).reshape(B, -1, heat.shape[-1]), axis=1)
    clear = (flat[:, -1] - flat[:, -2]) > 1e-3 * np.abs(flat).max()
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(coords[clear], w_coords[clear])


def test_heatmap_round_trip_equals_live_step(case, artifact):
    _, _, _, spec, model, x, margin = case
    _, loaded = artifact("heat", decoded=False)
    assert loaded.meta["batch_size"] == B and loaded.meta["image_size"] == [32, 32]
    assert loaded.meta["fused"] is True and loaded.meta["weights"] == "baked"
    assert loaded.meta["device"] == "cpu" and loaded.meta["torch_version"] == torch.__version__
    got = loaded(x, margin)
    want = make_eval_step(model)(*_tensors(x, margin))
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


@pytest.mark.parametrize("flip,weights", [(False, "baked"), (True, "external")])
def test_decoded_round_trip_equals_live_step(case, artifact, flip, weights):
    _, _, _, _, model, x, margin = case
    _, loaded = artifact(f"decoded_{flip}_{weights}", flip=flip,
                         bake_weights=weights == "baked")
    assert loaded.meta["weights"] == weights and loaded.meta["flip"] is flip
    for mod in (fused_attn, fused_mlp, deform_conv):
        mod.calls = 0
    packs = (fused_attn.packs, fused_mlp.packs, deform_conv.packs)
    got = loaded(x, margin)
    # the program calls each op as the live step does, and makes no pack
    n = 2 if flip else 1
    assert (fused_attn.calls, fused_mlp.calls, deform_conv.calls) == (4 * n, 6 * n, n)
    assert (fused_attn.packs, fused_mlp.packs, deform_conv.packs) == packs
    want = make_decoded_eval_step(model, flip=flip)(*_tensors(x, margin))
    j = model.spec.num_joints
    for g, w, shape in zip(got, want, ((B, j, 2), (B, j, 1), (B, j, 2)), strict=True):
        assert tuple(g.shape) == shape
        assert torch.equal(g, w)


def test_external_weights_equal_baked(case, artifact):
    _, _, _, _, _, x, margin = case
    baked_dir, baked = artifact("heat", decoded=False)
    ext_dir, ext = artifact("heat_external", decoded=False, bake_weights=False)
    assert os.path.exists(os.path.join(ext_dir, "otpose_weights.npz"))
    assert ext.meta["weights"] == "external"
    for g, w in zip(ext(x, margin), baked(x, margin), strict=True):
        assert torch.equal(g, w)
    # the code-only program is much smaller than the one with the weights in it
    size = lambda d: os.path.getsize(os.path.join(d, "otpose_eval.pt2"))  # noqa: E731
    assert size(ext_dir) < size(baked_dir) / 2, (size(ext_dir), size(baked_dir))

    bf16_dir, bf16 = artifact("heat_external_bf16", decoded=False, bake_weights=False,
                              bf16_params=True)
    with np.load(os.path.join(bf16_dir, "otpose_weights.npz")) as z:
        dtypes = json.loads(str(z["__dtypes__"]))
        assert dtypes and set(dtypes.values()) == {"bfloat16"}
        assert all(z[k].dtype == np.uint16 for k in dtypes)
    assert any(t.dtype == torch.bfloat16 for t in bf16.weights.values())
    # bf16 conv and dense weights (8 significant bits, a relative rounding
    # of up to 2^-9 a weight) through the whole net: 2e-2 of the peak
    for name, g, w in zip(("heatmaps", "teacher"), bf16(x, margin), baked(x, margin),
                          strict=True):
        _close_to_peak(g.numpy(), w.numpy(), 2e-2, name)


def test_wrong_batch_rejected(case, artifact):
    _, _, _, _, _, x, margin = case
    out_dir, loaded = artifact("decoded_False_baked", bake_weights=True)
    bad = np.concatenate([x, x[:1]])
    bad_margin = np.concatenate([margin, margin[:1]])
    with pytest.raises(ValueError, match="(?i)shape"):
        loaded(bad, bad_margin)
    program = torch.export.load(os.path.join(out_dir, "otpose_eval.pt2")).module()
    with pytest.raises((RuntimeError, AssertionError, ValueError), match="(?i)shape|size|dim"):
        program(*_tensors(bad, bad_margin))


def test_matches_the_jax_artifact(case, artifact, tmp_path):
    """The same weights through both packages' export, save and load: the
    port's program (fused ops) against JAX's (``fused=False``)."""
    jspec, params, state, _, _, x, margin = case
    blob = jax_export_eval(jspec, params, state, batch_size=B, decoded=False)
    jmodel = jax_load_exported(jax_save_exported(
        str(tmp_path / "jax"), blob, jspec, batch_size=B, compute_dtype=jnp.float32,
        flip=False, decoded=False))
    want = jmodel(jnp.asarray(x), jnp.asarray(margin))
    _, loaded = artifact("heat", decoded=False)
    got = loaded(x, margin)
    for name, g, w in zip(("heatmaps", "teacher"), got, want, strict=True):
        _close_to_peak(g.numpy(), np.asarray(w), 1e-3, name)


def _cli_yaml(cfg, root, pth, name):
    cfg.EXPERIMENT_NAME = name
    cfg.OUTPUT_DIR = str(root / "output")
    cfg.VAL.MODEL_FILE = pth
    cfg.VAL.FLIP_VAL = False
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.PARAM_DTYPE = "float32"
    path = root / f"{name}.yaml"
    path.write_text(cfg.dump())
    return str(path)


def test_export_clis_agree(case, tmp_path):
    """One reference-layout ``.pth``, both CLIs at batch 2: decoded
    keypoints agree as the packages' outputs do."""
    _, _, _, _, model, x, margin = case
    pth = str(tmp_path / "weights.pth")
    torch.save({"state_dict": model.state_dict()}, pth)
    jcfg, tcfg = _cfgs()
    jax_out = str(tmp_path / "jax_artifact")
    jax_export_main(["--cfg", _cli_yaml(jcfg, tmp_path, pth, "jax"), "--root_dir",
                     str(tmp_path), "--batch", str(B), "--out", jax_out])
    out = export_main(["--cfg", _cli_yaml(tcfg, tmp_path, pth, "torch"), "--root_dir",
                       str(tmp_path), "--batch", str(B), "--out", str(tmp_path / "torch_art"),
                       "--device", "cpu"])
    loaded = load_exported(out, device="cpu")
    assert loaded.meta["batch_size"] == B and loaded.meta["decoded"] is True
    got = loaded(x, margin)
    want = jax_load_exported(jax_out)(jnp.asarray(x), jnp.asarray(margin))
    heat = make_eval_step(model)(*_tensors(x, margin))[0].numpy()
    _decoded_agree([t.numpy() for t in got], [np.asarray(t) for t in want], heat)


def test_export_cli_refuses_a_checkpoint_that_matches_nothing(tmp_path):
    pth = str(tmp_path / "other.pth")
    torch.save({"state_dict": {"not_a_layer.weight": torch.zeros(3, 3)}}, pth)
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="matched 0/"):
        export_main(["--cfg", _cli_yaml(tcfg, tmp_path, pth, "refuse"), "--root_dir",
                     str(tmp_path), "--batch", str(B), "--out", str(tmp_path / "art"),
                     "--device", "cpu"])
    assert not (tmp_path / "art").exists()


def test_fresh_process_serves_without_model_code(case, artifact, tmp_path):
    """A new interpreter loads the artifact through ``tools/serve.py`` and
    answers one request, equal to this process's call, with neither the
    port's model code nor JAX imported."""
    _, _, _, _, _, x, margin = case
    out_dir, loaded = artifact("decoded_False_baked", bake_weights=True)
    np.savez(tmp_path / "request.npz", inputs=x[:1], margin=margin[:1])
    code = f"""
import io, json, sys, threading, urllib.request
import numpy as np, torch
torch.set_num_threads(1)
from otpose_tpu_torch.tools.serve import make_server
srv = make_server({out_dir!r}, port=0, device="cpu")
threading.Thread(target=srv.serve_forever, daemon=True).start()
body = open({str(tmp_path / "request.npz")!r}, "rb").read()
req = urllib.request.Request(f"http://127.0.0.1:{{srv.server_port}}/predict", data=body,
                             method="POST")
with urllib.request.urlopen(req, timeout=120) as r:
    reply = json.loads(r.read())
srv.shutdown()
srv.server_close()
mods = sorted(n for n in sys.modules
              if n.startswith("otpose_tpu_torch.models") or n.split(".")[0] in ("jax", "otpose_tpu"))
print(json.dumps({{"reply": reply, "mods": mods}}))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["mods"] == []
    want = [t[:1].numpy() for t in loaded(x, margin)]
    for name, w in zip(("coords", "maxvals", "raw_coords"), want, strict=True):
        np.testing.assert_array_equal(np.asarray(out["reply"][name], np.float32), w)


def test_export_copies_the_model(case):
    """``export_eval`` casts and pins on a copy: the caller's model keeps its
    f32 weights and its pack caches."""
    _, _, _, _, model, _, _ = case
    before = {k: v.clone() for k, v in model.state_dict().items()}
    export_eval(model, batch_size=1, device="cpu", bf16_params=True)
    after = model.state_dict()
    assert after.keys() == before.keys()
    assert all(torch.equal(after[k], v) and after[k].dtype == v.dtype for k, v in before.items())

