"""The port's HTTP serving shim (``otpose_tpu_torch/tools/serve.py``) over
an exported artifact on the CPU, mirroring tests/test_serve.py: health, a
padded predict, an oversized batch rejected, for baked and external weights;
and the served answer equal to a direct call of the artifact."""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from otpose_tpu_torch.engine.export import export_eval, load_exported, save_exported
from otpose_tpu_torch.models.factory import build_model
from otpose_tpu_torch.tools.serve import make_server
from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

from tests.helpers.torch_port import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module", params=["baked", "external"])
def server(request, tmp_path_factory, one_torch_thread):  # noqa: F811
    spec, model = build_model(tiny_otpose_cfg(image_size=32, heatmap_size=8), device="cpu")
    exported = export_eval(model, batch_size=2, device="cpu",
                           bake_weights=request.param == "baked")
    art = save_exported(str(tmp_path_factory.mktemp("srv") / "artifact"), exported, spec,
                        batch_size=2, compute_dtype=torch.float32, flip=False, decoded=True)
    srv = make_server(art, port=0, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_port}", art
    srv.shutdown()
    srv.server_close()
    t.join(timeout=30)
    assert not t.is_alive()


def _post_npz(url, **arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(url + "/predict", data=buf.getvalue(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_health(server):
    url, _ = server
    with urllib.request.urlopen(url + "/health", timeout=60) as r:
        meta = json.loads(r.read())
    assert meta["batch_size"] == 2
    assert meta["decoded"] is True and meta["fused"] is True
    assert meta["weights"] in ("baked", "external")


def test_predict_with_padding(server):
    url, _ = server
    rng = np.random.RandomState(0)
    # batch 1 < exported batch 2: the zero-pad and slice-back path
    status, out = _post_npz(url, inputs=rng.randn(1, 32, 32, 15).astype(np.float32),
                            margin=np.ones((1, 4), np.float32))
    assert status == 200
    assert np.asarray(out["coords"]).shape == (1, 17, 2)
    assert np.asarray(out["maxvals"]).shape == (1, 17, 1)
    assert np.isfinite(np.asarray(out["raw_coords"])).all()


def test_predict_oversized_batch_rejected(server):
    url, _ = server
    rng = np.random.RandomState(1)
    status, out = _post_npz(url, inputs=rng.randn(3, 32, 32, 15).astype(np.float32),
                            margin=np.ones((3, 4), np.float32))
    assert status == 400
    assert "exported batch" in out["error"]


def test_served_answer_equals_a_direct_call(server):
    url, art = server
    rng = np.random.RandomState(2)
    inputs = rng.randn(2, 32, 32, 15).astype(np.float32)
    margin = rng.randint(0, 3, (2, 4)).astype(np.float32)
    status, out = _post_npz(url, inputs=inputs, margin=margin)
    assert status == 200
    want = load_exported(art, device="cpu")(inputs, margin)
    for name, w in zip(("coords", "maxvals", "raw_coords"), want, strict=True):
        np.testing.assert_array_equal(np.asarray(out[name], np.float32), w.numpy())
