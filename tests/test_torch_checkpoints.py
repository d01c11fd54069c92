"""The port's checkpoints vs the JAX package's, and the port's own format.

A ``.pth`` in the reference's layout, written here from the port's model
(its ``state_dict`` carries the reference's names and layouts), is read by
both packages: the JAX package converts it to its (params, state) dicts, and
carried back through ``jax_bridge.from_jax`` those equal what the port reads
natively, exactly.  The listing functions see the same folder the same way,
``filter_pretrained_for_otpose`` keeps and renames the same keys, a
checkpoint that matches nothing is refused, and an orbax directory raises.

The port's own directories: a save and a resume give back the model's
weights and BN statistics, the optimizer's state and count and the meta
exactly; an asynchronous save holds the tensors as they were when it
returned; a write that fails midway leaves no ``epoch_N_state``; the
best-checkpoint rules (names in scientific notation, NaN names ignored, a
lower prior removed, a higher prior kept).
"""

import copy
import os

import numpy as np
import pytest
import torch

from otpose_tpu.engine import checkpoints as jax_ckpt
from otpose_tpu.models.torch2jax import filter_pretrained_for_otpose as jax_filter
from otpose_tpu.models.otpose import OTPoseSpec as JaxSpec
from otpose_tpu.models.otpose import _init_otpose_impl
from otpose_tpu.utils.testing import tiny_otpose_cfg as jax_tiny_cfg
from otpose_tpu_torch.cli.eval import Eval
from otpose_tpu_torch.config import default_parse_args
from otpose_tpu_torch.data.synthetic import make_synthetic_posetrack
from otpose_tpu_torch.engine import checkpoints as ckpt
from otpose_tpu_torch.engine.optim import make_optimizer, make_schedule
from otpose_tpu_torch.engine.trainer import init_train_state, make_train_step
from otpose_tpu_torch.models.factory import build_model
from otpose_tpu_torch.models.jax_bridge import from_jax, load_jax_weights
from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

from tests.helpers.torch_port import numpy_weights, one_torch_thread  # noqa: F401

NAMES = ["epoch_0_state", "epoch_2_state", "epoch_10_state", "epoch_x_state", "epoch_3",
         "best_mAP_71.25_state", "best_mAP_3.2e-05_state", "best_mAP_nan_state",
         "best_mAP_80.5_state", "best_mAP__state", "notes.txt"]


@pytest.fixture(scope="module")
def weights():
    params, state = numpy_weights(_init_otpose_impl, JaxSpec.from_cfg(jax_tiny_cfg()))
    _, model = build_model(tiny_otpose_cfg(), device="cpu")
    load_jax_weights(model, params, state)
    return params, state, model


@pytest.mark.parametrize("layout", ["state_dict", "bare", "data_parallel", "tar"])
def test_reference_pth_reads_to_the_same_weights_in_both_packages(weights, tmp_path, layout):
    params, state, model = weights
    sd = dict(model.state_dict())
    sd["rough_pose_estimation_net.bn1.num_batches_tracked"] = torch.tensor(7)
    if layout == "data_parallel":
        sd = {"module." + k: v for k, v in sd.items()}
    blob = sd if layout == "bare" else {"state_dict": sd, "begin_epoch": 4,
                                        "tensorboard_global_steps": 90}
    path = str(tmp_path / ("w.pth.tar" if layout == "tar" else "w.pth"))
    torch.save(blob, path)
    want = jax_ckpt.restore_checkpoint(path)
    got = ckpt.restore_checkpoint(path)
    assert got["params"].keys() == want["params"].keys() == params.keys()
    assert got["model_state"].keys() == want["model_state"].keys() == state.keys()
    bridged = from_jax(want["params"], want["model_state"])
    for part in ("params", "model_state"):
        for k, v in got[part].items():
            assert torch.equal(v, bridged[k]), k
            assert torch.equal(v, model.state_dict()[k]), k
    if layout != "bare":
        assert got["begin_epoch"] == want["begin_epoch"] == 4
        assert got["tensorboard_global_steps"] == want["tensorboard_global_steps"] == 90
    # merged into a fresh model, the forward's weights are the written ones
    _, fresh = build_model(tiny_otpose_cfg(), seed=1, device="cpu")
    assert ckpt.merge_checkpoint(got, fresh) == len(params) == \
        jax_ckpt.merge_checkpoint(want, params, state)[2]
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k


def test_merge_gates_on_shape_and_counts_parameters_only(weights):
    params, state, model = weights
    key = "final_layer1.weight"

    def damaged(blob_params, wrong_shape, stray):
        out = dict(blob_params, **{key: wrong_shape, "not.a.weight": stray})
        del out["final_layer1.bias"]
        return out

    p, s_ = ckpt.split_state_dict(model.state_dict())
    blob = {"params": damaged(p, torch.zeros(3, 3), torch.zeros(2)), "model_state": s_}
    jblob = {"params": damaged(params, np.zeros((3, 3)), np.zeros(2)), "model_state": state}
    _, fresh = build_model(tiny_otpose_cfg(), seed=1, device="cpu")
    before = fresh.state_dict()[key].clone()
    assert ckpt.merge_checkpoint(blob, fresh) == len(params) - 2 == \
        jax_ckpt.merge_checkpoint(jblob, params, state)[2]
    assert torch.equal(fresh.state_dict()[key], before)
    assert torch.equal(fresh.state_dict()["final_layer2.weight"],
                       model.state_dict()["final_layer2.weight"])


def test_listing_functions_agree_on_a_folder(tmp_path):
    for name in NAMES:
        if name.endswith(".txt"):
            (tmp_path / name).write_text("x")
        else:
            (tmp_path / name).mkdir()
    folder = str(tmp_path)
    assert ckpt.get_latest_checkpoint(folder) == jax_ckpt.get_latest_checkpoint(folder) == \
        os.path.join(folder, "epoch_10_state")
    assert ckpt.get_best_checkpoint(folder) == jax_ckpt.get_best_checkpoint(folder) == \
        os.path.join(folder, "best_mAP_80.5_state")
    assert ckpt.get_all_checkpoints(folder) == jax_ckpt.get_all_checkpoints(folder) == \
        [os.path.join(folder, f"epoch_{n}_state") for n in (0, 2, 10)]
    for name in NAMES:
        assert ckpt._parse_epoch(name) == jax_ckpt._parse_epoch(name)
        assert ckpt._parse_best(name) == jax_ckpt._parse_best(name)
    missing = str(tmp_path / "nowhere")
    assert ckpt.get_latest_checkpoint(missing) is None and ckpt.get_best_checkpoint(missing) is None
    assert ckpt.get_all_checkpoints(missing) == jax_ckpt.get_all_checkpoints(missing) == []


def test_resolve_model_file_roots_paths_the_reference_way(tmp_path):
    cfg, jcfg = tiny_otpose_cfg(), jax_tiny_cfg()
    cfg.ROOT_DIR = jcfg.ROOT_DIR = str(tmp_path)
    for path in ("./epoch_3_state", "../x/w.pth", "weights/w.pth", "/abs/w.pth"):
        assert ckpt.resolve_model_file(path, cfg, "/exp/checkpoints") == \
            jax_ckpt.resolve_model_file(path, jcfg, "/exp/checkpoints")


def test_an_orbax_directory_and_an_unknown_file_raise(tmp_path):
    (tmp_path / "epoch_3_state").mkdir()
    with pytest.raises(NotImplementedError, match="orbax directory written by the JAX"):
        ckpt.restore_checkpoint(str(tmp_path / "epoch_3_state"))
    (tmp_path / "epoch_3_state" / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="no state.pt"):
        ckpt.resume(str(tmp_path), None)
    (tmp_path / "weights.bin").write_bytes(b"0")
    with pytest.raises(ValueError, match="not a .pth"):
        ckpt.restore_checkpoint(str(tmp_path / "weights.bin"))


@pytest.fixture(scope="module")
def cli_yaml(tmp_path_factory, weights):
    root = tmp_path_factory.mktemp("ckpt_cli")
    json_dir, img_dir, annot_dir = make_synthetic_posetrack(str(root), num_videos=1,
                                                           frames_per_video=2)
    cfg = tiny_otpose_cfg()
    cfg.EXPERIMENT_NAME = "ckpt_cli"
    cfg.OUTPUT_DIR = str(root / "output")
    cfg.DATASET.JSON_DIR, cfg.DATASET.IMG_DIR, cfg.VAL.ANNOT_DIR = json_dir, img_dir, annot_dir
    cfg.DATASET.TEST_IMG_DIR = img_dir
    cfg.TPU.DEVICE_PREPROCESS = "off"
    path = root / "cfg.yaml"
    path.write_text(cfg.dump())
    return root, str(path), weights[2]


def _eval(cli_yaml, *opts, pe_name="OTPose"):
    root, yaml, _ = cli_yaml
    return Eval("validate", default_parse_args(["--cfg", yaml, "--root_dir", str(root),
                                                "--PE_Name", pe_name, *opts]), device="cpu")


def test_cli_refuses_a_checkpoint_that_matches_nothing(cli_yaml):
    root = cli_yaml[0]
    path = str(root / "other.pth")
    torch.save({"state_dict": {"backbone.conv.weight": torch.zeros(3, 3, 1, 1)}}, path)
    ev = _eval(cli_yaml, "VAL.MODEL_FILE", path)
    assert ev.list_model_files() == [path]
    with pytest.raises(ValueError, match="matched 0 of"):
        ev.eval()


def test_cli_loads_bf16_weights_and_strips_the_msra_prefix(cli_yaml):
    root, _, model = cli_yaml
    path = str(root / "msra.pth")
    sd = {"rough_pose_estimation_net." + k: v for k, v in model.state_dict().items()}
    torch.save({"state_dict": sd}, path)
    with pytest.raises(ValueError, match="matched 0 of"):
        _eval(cli_yaml)._load(path)
    loaded = _eval(cli_yaml, "TPU.PARAM_DTYPE", "bfloat16", pe_name="MSRA")._load(path)
    got, want = loaded.state_dict(), model.state_dict()
    assert got["final_layer1.weight"].dtype == torch.bfloat16
    assert got["final_layer1.bias"].dtype == torch.float32
    assert torch.equal(got["final_layer1.weight"], want["final_layer1.weight"].bfloat16())
    assert torch.equal(got["temporal_encoder1.stem.0.ln1.weight"],
                       want["temporal_encoder1.stem.0.ln1.weight"])


def test_cli_lists_checkpoints_as_the_reference_does(cli_yaml):
    ev = _eval(cli_yaml)
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        ev.eval()
    folder = ev.checkpoints_save_folder
    for name in ("epoch_1_state", "epoch_4_state", "best_mAP_50.0_state"):
        os.makedirs(os.path.join(folder, name))
    assert ev.list_model_files() == [os.path.join(folder, "epoch_4_state")]
    ev.args.val_from_checkpoint = 2
    assert ev.list_model_files() == [os.path.join(folder, "epoch_4_state")]
    ev.args.val_from_checkpoint = 0
    assert len(ev.list_model_files()) == 2
    with pytest.raises(NotImplementedError, match="orbax"):
        ev.eval()
    ev.model_file = "./epoch_1_state"
    assert ev.list_model_files() == [os.path.join(folder, "epoch_1_state")]


@pytest.mark.parametrize("layers", [("*",), ("conv1", "stage2"), ()])
def test_pretrained_filter_matches_jax(layers):
    names = ["conv1.weight", "bn1.running_mean", "stage2.0.fuse_layers.0.1.0.weight",
             "layer1.0.conv1.weight", "final_layer.bias", "rough_pose_estimation_net.conv2.weight",
             "temporal_encoder1.stem.0.ln1.weight", "def_fuse.layers.0.conv.weight",
             "offsets_list.0.0.weight", "masks_list.1.0.bias", "flow_encoder.embd.0.weight",
             "modulated_deform_conv_list.2.deform_conv.weight", "head.weight"]
    rng = np.random.RandomState(0)
    arrays = {n: rng.randn(3).astype(np.float32) for n in names}
    want = jax_filter(arrays, layers)
    got = ckpt.filter_pretrained_for_otpose({n: torch.from_numpy(a) for n, a in arrays.items()},
                                            layers)
    assert list(got) == list(want)
    assert ("rough_pose_estimation_net.conv1.weight" in got) == bool(layers)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k])


@pytest.fixture
def trained(weights):
    """``make(optimizer)``: a train state of the tiny model after two train
    steps (moments and BN statistics that are not their initial values),
    and a second model with other weights to resume into."""
    _, _, model = weights
    gen = torch.Generator().manual_seed(0)
    batch = {"inputs": torch.randn(2, 64, 64, 15, generator=gen),
             "margin": torch.ones(2, 4),
             "target": torch.rand(2, 16, 16, 17, generator=gen),
             "target_weight": torch.ones(2, 17, 1)}

    def make(optimizer):
        cfg = tiny_otpose_cfg()
        cfg.TRAIN.OPTIMIZER, cfg.TRAIN.WARMUP = optimizer, False
        m = copy.deepcopy(model)
        opt = make_optimizer(m, cfg, make_schedule(cfg, 4))
        step = make_train_step(m, opt, generator=torch.Generator().manual_seed(1))
        for _ in range(2):
            step(batch)
        other = copy.deepcopy(model)
        with torch.no_grad():
            for p in other.parameters():
                p.mul_(0.5)
        return init_train_state(m, opt), init_train_state(
            other, make_optimizer(other, cfg, make_schedule(cfg, 4)))

    return make


def _moments(state):
    return [state.optimizer.opt.state[p] for p in state.optimizer.params]


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("optimizer", ["AdamW", "SGD"])
@pytest.mark.parametrize("iteration", [0, 5])
def test_save_and_resume_round_trip(trained, tmp_path, optimizer, iteration):
    ts, fresh = trained(optimizer)
    folder = str(tmp_path / "ck")
    path = ckpt.save_checkpoint(folder, 3, ts, tensorboard_global_steps=17, iteration=iteration)
    assert path == os.path.join(os.path.abspath(folder), "epoch_3_state")
    assert os.listdir(folder) == ["epoch_3_state"]
    assert os.listdir(path) == ["state.pt"]
    got, begin, tb, start = ckpt.resume(folder, fresh)
    assert got is fresh
    assert (begin, tb, start) == ((3, 17, 5) if iteration else (4, 17, 0))
    assert fresh.step == ts.step == 2
    want_sd = ts.model.state_dict()
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, want_sd[k]), k
    keys = {"AdamW": {"step", "exp_avg", "exp_avg_sq"}, "SGD": {"momentum_buffer"}}[optimizer]
    for a, b in zip(_moments(ts), _moments(fresh)):
        assert a.keys() == b.keys() == keys
        for k in keys:
            assert torch.equal(a[k], b[k]), k
    # the eval CLI's reader takes the same directory
    blob = ckpt.restore_checkpoint(path)
    assert blob["meta"]["iteration"] == iteration and blob["optimizer"]["count"] == 2
    _, model = build_model(tiny_otpose_cfg(), seed=2, device="cpu")
    assert ckpt.merge_checkpoint(blob, model) == len(list(model.parameters()))
    for k, v in model.state_dict().items():
        assert torch.equal(v, want_sd[k]), k
    assert ckpt.resume(str(tmp_path / "empty"), fresh) == (fresh, 0, 0, 0)


def test_async_save_holds_the_tensors_of_its_call(trained, tmp_path):
    ts, fresh = trained("AdamW")
    want = {k: v.clone() for k, v in ts.model.state_dict().items()}
    folder = str(tmp_path / "ck")
    path = ckpt.save_checkpoint(folder, 0, ts, tensorboard_global_steps=2, async_save=True)
    with torch.no_grad():
        for p in ts.model.parameters():
            p.add_(1.0)                 # the training goes on while it writes
    ckpt.wait_for_saves()
    ckpt.wait_for_saves()               # nothing pending: returns at once
    assert os.listdir(folder) == ["epoch_0_state"] and os.listdir(path) == ["state.pt"]
    ckpt.resume(folder, fresh)
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    # a second async save of the same epoch replaces the first
    ckpt.save_checkpoint(folder, 0, ts, tensorboard_global_steps=3, async_save=True)
    assert ckpt.resume(folder, fresh)[2] == 3
    assert sorted(os.listdir(folder)) == ["epoch_0_state"]


def test_a_write_that_fails_midway_leaves_no_checkpoint(trained, tmp_path, monkeypatch):
    ts, fresh = trained("AdamW")
    folder = str(tmp_path / "ck")
    ckpt.save_checkpoint(folder, 0, ts, tensorboard_global_steps=4)
    save = torch.save

    def broken(obj, f, *args, **kwargs):
        with open(f, "wb") as fh:
            fh.write(b"PK\x03\x04 half a file")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_checkpoint(folder, 1, ts, tensorboard_global_steps=8)
    ckpt.save_checkpoint(folder, 2, ts, tensorboard_global_steps=12, async_save=True)
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait_for_saves()
    # over an existing checkpoint: the old one stays
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_checkpoint(folder, 0, ts, tensorboard_global_steps=99)
    monkeypatch.setattr(torch, "save", save)
    assert os.listdir(folder) == ["epoch_0_state"]
    assert ckpt.get_latest_checkpoint(folder) == os.path.join(folder, "epoch_0_state")
    assert ckpt.resume(folder, fresh)[1:] == (1, 4, 0)


def test_best_checkpoint_rules(trained, tmp_path):
    ts, _ = trained("SGD")
    folder = str(tmp_path / "ck")
    first = ckpt.save_best_checkpoint(folder, ts, 3.2e-05)
    assert os.path.basename(first) == "best_mAP_3.2e-05_state"
    assert ckpt._parse_best("best_mAP_3.2e-05_state") == \
        jax_ckpt._parse_best("best_mAP_3.2e-05_state") == 3.2e-05
    os.makedirs(os.path.join(folder, "best_mAP_nan_state"))
    assert ckpt.save_best_checkpoint(folder, ts, 1e-5) is None        # a higher prior stays
    second = ckpt.save_best_checkpoint(folder, ts, 50.25)
    assert sorted(os.listdir(folder)) == ["best_mAP_50.25_state", "best_mAP_nan_state"]
    assert ckpt.get_best_checkpoint(folder) == second
    assert ckpt.save_best_checkpoint(folder, ts, 50.25) is None
    assert ckpt.save_best_checkpoint(folder, ts, 40.0) is None
    assert sorted(os.listdir(folder)) == ["best_mAP_50.25_state", "best_mAP_nan_state"]
    with pytest.raises(ValueError, match="non-finite"):
        ckpt.save_best_checkpoint(folder, ts, float("nan"))
    # weights and BN statistics only, read by the eval CLI's reader
    blob = ckpt.restore_checkpoint(second)
    assert "optimizer" not in blob and "meta" not in blob
    _, model = build_model(tiny_otpose_cfg(), seed=2, device="cpu")
    assert ckpt.merge_checkpoint(blob, model) == len(list(model.parameters()))
    for k, v in model.state_dict().items():
        assert torch.equal(v, ts.model.state_dict()[k]), k
