"""The port's factories, registries and small utilities against the JAX
package's.

- ``models/factory.py``: both registries' names, ``build_model`` on
  ``OTPose`` and ``pose_hrnet`` (a standalone HRNet, the reference init,
  eval mode, on the CPU when asked), ``build_dataset`` against JAX's on one
  tree; a tiny ``pose_hrnet`` with numpy weights in JAX ``init_hrnet``'s
  shapes, carried by ``jax_bridge`` as a bare tree, against JAX
  ``hrnet_forward`` to 2e-4 of the peak (f32);
- ``models/otpose.py``'s position embeddings: the sine table equal to
  JAX's; the learnable one by its distribution (JAX draws from its own key
  stream, which a torch generator cannot reproduce), and its determinism;
- ``ops/heatmap.py::normalize_0_to_1`` against JAX's to 1e-6 (it divides by
  the maximum, not by max - min);
- ``utils/io.py``: the json helpers, ``Registry``, ``set_random_seed``
  (python and numpy draws equal to JAX's after the same seed; torch's too).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otpose_tpu.models import factory as jax_factory
from otpose_tpu.models.core import Ctx
from otpose_tpu.models.hrnet import HRNetSpec as JaxHRNetSpec
from otpose_tpu.models.hrnet import hrnet_forward as jax_hrnet_forward
from otpose_tpu.models.hrnet import init_hrnet
from otpose_tpu.models.otpose import make_sine_position_embedding as jax_sine
from otpose_tpu.ops.heatmap import normalize_0_to_1 as jax_normalize
from otpose_tpu.utils import io as jax_io
from otpose_tpu.utils.testing import tiny_otpose_cfg as jax_tiny_cfg
from otpose_tpu_torch.config import get_cfg
from otpose_tpu_torch.data.posetrack import PoseTrackDataset
from otpose_tpu_torch.data.synthetic import make_synthetic_posetrack
from otpose_tpu_torch.models.factory import build_dataset, build_model
from otpose_tpu_torch.models.hrnet import HRNet, hrnet_forward
from otpose_tpu_torch.models.jax_bridge import from_jax, load_jax_weights
from otpose_tpu_torch.models.otpose import (OTPose, make_learnable_position_embedding,
                                            make_sine_position_embedding)
from otpose_tpu_torch.ops.heatmap import normalize_0_to_1
from otpose_tpu_torch.utils import io
from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

from tests.helpers.torch_port import numpy_weights


def _hrnet_cfgs():
    cfg, jcfg = tiny_otpose_cfg(), jax_tiny_cfg()
    cfg.MODEL.NAME = jcfg.MODEL.NAME = "pose_hrnet"
    return cfg, jcfg


def test_registries_hold_the_jax_names():
    from otpose_tpu_torch.utils.io import DATASET_REGISTRY, MODEL_REGISTRY

    for name in ("OTPose", "pose_hrnet"):
        assert name in MODEL_REGISTRY and name in jax_io.MODEL_REGISTRY
    assert "PoseTrack" in DATASET_REGISTRY and "PoseTrack" in jax_io.DATASET_REGISTRY
    cfg = tiny_otpose_cfg()
    cfg.MODEL.NAME = "ResNet"
    with pytest.raises(KeyError, match="have: \\['OTPose', 'pose_hrnet'\\]"):
        build_model(cfg, device="cpu")


def test_build_model_dispatches_on_the_name():
    spec, model = build_model(tiny_otpose_cfg(), device="cpu")
    assert isinstance(model, OTPose) and not model.training
    cfg, jcfg = _hrnet_cfgs()
    spec, model = build_model(cfg, seed=3, device="cpu")
    assert isinstance(model, HRNet) and not model.training
    assert next(model.parameters()).device.type == "cpu"
    jspec, jparams, jstate = jax_factory.build_model(jcfg, seed=3)
    assert spec.num_joints == jspec.num_joints == 17
    sd = model.state_dict()
    assert set(sd) == set(jparams) | set(jstate)
    # the reference init: conv normal std 0.001, final bias 0, BN 1 / 0
    convs = torch.cat([v.flatten() for k, v in sd.items() if v.dim() == 4])
    assert abs(convs.std().item() / 1e-3 - 1) < 0.02 and abs(convs.mean().item()) < 1e-4
    assert not sd["final_layer.bias"].any()
    assert all(sd[k].eq(1).all() for k in sd if k.endswith("bn1.weight"))
    assert all(not sd[k].any() for k in sd if k.endswith("bn1.bias"))
    assert torch.equal(build_model(cfg, seed=3, device="cpu")[1].conv1.weight,
                       model.conv1.weight)
    with pytest.raises(AttributeError, match="STAGE2"):   # as the JAX factory does
        build_model(get_cfg(), device="cpu")


def test_pose_hrnet_matches_jax_forward():
    cfg, jcfg = _hrnet_cfgs()
    jspec = JaxHRNetSpec.from_cfg(jcfg)
    params, state = numpy_weights(init_hrnet, jspec, seed=1)
    _, model = build_model(cfg, device="cpu")
    load_jax_weights(model, params, state)
    x = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    want = np.asarray(jax_hrnet_forward(Ctx(jax.tree.map(jnp.asarray, params),
                                            jax.tree.map(jnp.asarray, state), train=False),
                                        jnp.asarray(x), jspec))
    with torch.no_grad():
        got = hrnet_forward(model, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 16, 16, 17)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * np.abs(want).max())
    assert set(from_jax(params, state)) == set(model.state_dict())


def test_build_dataset_matches_jax(tmp_path):
    json_dir, img_dir, annot_dir = make_synthetic_posetrack(str(tmp_path), num_videos=2,
                                                            frames_per_video=4)
    cfgs = [tiny_otpose_cfg(), jax_tiny_cfg()]
    for cfg in cfgs:
        cfg.DATASET.NAME = "PoseTrack"
        cfg.DATASET.JSON_DIR, cfg.DATASET.IMG_DIR = json_dir, img_dir
        cfg.DATASET.TEST_IMG_DIR = img_dir
        cfg.VAL.ANNOT_DIR = annot_dir
        cfg.VAL.USE_GT_BBOX = True
    for phase in ("train", "validate"):
        ds = build_dataset(cfgs[0], phase)
        assert isinstance(ds, PoseTrackDataset)
        jds = jax_factory.build_dataset(cfgs[1], phase)
        assert len(ds) == len(jds) > 0
    cfgs[0].DATASET.NAME = "COCO"
    with pytest.raises(KeyError, match="PoseTrack"):
        build_dataset(cfgs[0], "train")


@pytest.mark.parametrize("h,w,d", [(96, 72, 136), (4, 6, 8)])
def test_sine_position_embedding_equals_jax(h, w, d):
    got = make_sine_position_embedding(h, w, d)
    assert got.dtype == torch.float32 and got.shape == (1, h * w, d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_sine(h, w, d)))


def test_learnable_position_embedding_by_distribution():
    """JAX draws from ``jax.random.normal(key)``, which no torch generator
    reproduces: the test holds the shape, the standard-normal moments and
    the determinism of the explicit generator."""
    got = make_learnable_position_embedding(torch.Generator().manual_seed(0), 6912, 136)
    assert got.shape == (1, 6912, 136) and got.dtype == torch.float32
    assert abs(got.mean().item()) < 0.01 and abs(got.std().item() - 1) < 0.01
    again = make_learnable_position_embedding(torch.Generator().manual_seed(0), 6912, 136)
    assert torch.equal(got, again)
    jax_draw = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, 6912, 136)))
    assert abs(jax_draw.std() - got.std().item()) < 0.01


def test_normalize_0_to_1_matches_jax():
    hm = np.random.RandomState(4).randn(3, 17, 12, 9).astype(np.float32) + 2.0
    got = normalize_0_to_1(torch.from_numpy(hm)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_normalize(jnp.asarray(hm))), rtol=1e-6,
                               atol=1e-6)
    # the reference divides by the maximum, not by max - min
    assert not np.allclose(got.max(axis=(-2, -1)), 1.0)
    np.testing.assert_allclose(got.min(axis=(-2, -1)), 0.0, atol=1e-6)


def test_json_helpers_and_registry(tmp_path):
    obj = {"a": [1, 2.5, None], "b": {"c": "d"}}
    path = str(tmp_path / "x.json")
    io.write_json_to_file(obj, path)
    assert io.read_json_from_file(path) == jax_io.read_json_from_file(path) == obj
    reg = io.Registry("THING")

    @reg.register
    def alpha():
        return 1

    reg.register(lambda: 2, name="beta")
    assert reg.get("alpha") is alpha and reg.get("beta")() == 2 and "beta" in reg
    with pytest.raises(KeyError, match="alpha already registered in THING"):
        reg.register(alpha)
    with pytest.raises(KeyError, match=r"gamma not found in registry THING \(have: "
                                       r"\['alpha', 'beta'\]\)"):
        reg.get("gamma")


def test_set_random_seed_seeds_python_numpy_and_torch():
    def draws():
        return random.random(), float(np.random.rand()), float(torch.rand(()))

    io.set_random_seed(5)
    first = draws()
    io.set_random_seed(5)
    assert draws() == first
    jax_io.set_random_seed(5)
    assert (random.random(), float(np.random.rand())) == first[:2]
    io.set_random_seed(6)
    assert draws() != first
