"""The port's train CLI end to end on the CPU, and against the JAX package's.

One synthetic jpg tree (tests/helpers/synthetic_data.py) and the tiny spec
in f32, read through ``PoseTrackDataset`` and the host loader (the yamls'
``auto`` on the CPU), initialised from a reference-layout ``.pth`` through
``MODEL.PRETRAINED``:

- ``Train`` without ``--device`` raises on a machine without a GPU, before
  it makes a folder;
- two epochs with ``--sigma_schedule 1`` (epoch 1's targets drawn at sigma
  - 1), an uninterrupted run against one that sends itself a real SIGTERM
  after three steps (``epoch_0_state`` at iteration 3, nothing else) and a
  new ``Train`` that resumes it: every weight, BN statistic, optimizer
  moment, the update count and the TensorBoard steps bit-equal, the same
  checkpoints in both folders, and each run's per-step losses equal;
- the eval CLI pointed at the best checkpoint gives that validation's AP
  table exactly;
- (slow) both train CLIs for one epoch from the same ``.pth``, dropout at 0:
  the port's ``TRAIN.BATCH_SIZE_PER_GPU`` is 8 times JAX's, whose CLI runs
  on the tests' 8-device CPU topology (tests/conftest.py); per-step losses
  to 1e-5 relative on the first step and 1e-3 after, the saved weights to
  1e-3 of each tensor's peak.  The JAX CLI's one epoch takes minutes to
  compile here, so only this case is marked slow; ``train_epoch`` is held
  to JAX's in Tier-1 (tests/test_torch_preempt.py).
"""

import dataclasses
import os
import signal

import numpy as np
import pytest
import torch

from otpose_tpu_torch.cli import train as train_cli
from otpose_tpu_torch.cli.eval import Eval
from otpose_tpu_torch.cli.train import Train
from otpose_tpu_torch.config import default_parse_args
from otpose_tpu_torch.engine import checkpoints as ckpt
from otpose_tpu_torch.models.factory import build_model
from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

from tests.helpers.synthetic_data import make_synthetic_posetrack
from tests.helpers.torch_port import one_torch_thread  # noqa: F401  (fixture)

pytest.importorskip("cv2")
pytestmark = pytest.mark.usefixtures("one_torch_thread")
AP_KEYS = ("Head", "Shoulder", "Elbow", "Wrist", "Hip", "Knee", "Ankle", "Mean")


def _fill(cfg, root, dirs, pth, name, batch):
    json_dir, img_dir, annot_dir = dirs
    cfg.EXPERIMENT_NAME = name
    cfg.OUTPUT_DIR = str(root / "output")
    cfg.DATASET.NAME = "PoseTrack"
    cfg.DATASET.JSON_DIR = json_dir
    cfg.DATASET.IMG_DIR = img_dir
    cfg.DATASET.TEST_IMG_DIR = img_dir
    cfg.DATASET.COLOR_RGB = True
    cfg.MODEL.PRETRAINED = pth
    cfg.VAL.ANNOT_DIR = annot_dir
    cfg.VAL.USE_GT_BBOX = True
    cfg.VAL.BATCH_SIZE_PER_GPU = 4
    cfg.TRAIN.BATCH_SIZE_PER_GPU = batch
    cfg.TRAIN.SAVE_MODEL_PER_EPOCH = 1
    cfg.TRAIN.PROB_HALF_BODY = 0.0
    cfg.TRAIN.WARMUP = False
    cfg.WORKERS = 2
    cfg.PRINT_FREQ = 1
    cfg.TPU.COMPUTE_DTYPE = "float32"
    path = root / f"{name}.yaml"
    path.write_text(cfg.dump())
    return str(path)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train_cli")
    dirs = make_synthetic_posetrack(str(root), num_videos=1, frames_per_video=4,
                                    people_per_frame=2, img_w=96, img_h=96)
    _, model = build_model(tiny_otpose_cfg(image_size=32, heatmap_size=8), seed=5,
                           device="cpu")
    pth = str(root / "pretrained.pth")
    torch.save({"state_dict": model.state_dict()}, pth)
    return root, dirs, pth


class Scalars:
    """Stands in for tensorboardX's SummaryWriter and keeps its scalars."""

    runs = []

    def __init__(self, logdir):
        self.rows = []
        Scalars.runs.append(self)

    def add_scalar(self, tag, value, step):
        self.rows.append((tag, float(value), int(step)))

    def flush(self):
        pass

    def losses(self):
        return {step: value for tag, value, step in self.rows if tag == "train/final_loss"}


def _args(yaml, root, *opts):
    # --sigma_schedule takes every number that follows it: before the opts
    return default_parse_args(["--sigma_schedule", "1", "--cfg", yaml, "--root_dir", str(root),
                               "--device", "cpu", *opts])


def _state(trainer):
    opt = trainer.optimizer.opt
    return (trainer.model.state_dict(), [opt.state[p] for p in trainer.optimizer.params],
            trainer.optimizer.count)


def test_train_defaults_to_cuda_and_raises_without_a_gpu(workspace, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    root, dirs, pth = workspace
    cfg = tiny_otpose_cfg(image_size=32, heatmap_size=8)
    yaml = _fill(cfg, tmp_path, dirs, pth, "no_gpu", 2)
    args = default_parse_args(["--cfg", yaml, "--root_dir", str(tmp_path)])
    assert args.device is None
    with pytest.raises(RuntimeError, match="CUDA"):
        Train(args)
    assert not (tmp_path / "output").exists()


@pytest.fixture(scope="module")
def runs(workspace):
    """An uninterrupted two-epoch run, a run stopped by SIGTERM after three
    steps, and a new ``Train`` resuming it; each with its losses, the
    targets' sigma a step, the validations' results and the trainer."""
    root, dirs, pth = workspace
    out = {}
    before = signal.getsignal(signal.SIGTERM)
    with pytest.MonkeyPatch.context() as mp:
        import tensorboardX

        mp.setattr(tensorboardX, "SummaryWriter", Scalars)
        validations = []
        inner = train_cli.evaluate_epoch_decoded

        def spy(*args, **kwargs):
            result = inner(*args, **kwargs)
            validations.append(result)
            return result

        mp.setattr(train_cli, "evaluate_epoch_decoded", spy)
        for name, stop_after in (("whole", None), ("preempted", 3), ("resumed", None)):
            yaml = _fill(tiny_otpose_cfg(image_size=32, heatmap_size=8), root, dirs, pth,
                         "whole" if name == "whole" else "preempted", 2)
            trainer = Train(_args(yaml, root))
            seen = []
            step = trainer.step_fn

            def counted(batch, step=step, seen=seen, trainer=trainer, stop_after=stop_after):
                seen.append((trainer.train_dataset.sigma, float(batch["target"].sum()),
                             float(batch["target_weight"].sum())))
                metrics = step(batch)
                if len(seen) == stop_after:
                    os.kill(os.getpid(), signal.SIGTERM)
                return metrics

            trainer.step_fn = counted
            del validations[:]
            trainer.train()
            folder = trainer.checkpoints_save_folder
            out[name] = dict(trainer=trainer, seen=seen, losses=trainer.tb_writer.losses(),
                             validations=list(validations), files=sorted(os.listdir(folder)),
                             meta=ckpt.restore_checkpoint(
                                 os.path.join(folder, "epoch_0_state"))["meta"])
    assert signal.getsignal(signal.SIGTERM) is before
    return out


def test_sigterm_checkpoints_the_exact_iteration(runs):
    p = runs["preempted"]
    assert len(p["seen"]) == 3 and p["validations"] == []
    assert p["files"] == ["epoch_0_state"]
    assert p["meta"] == {"begin_epoch": 0, "tensorboard_global_steps": 3, "iteration": 3}
    # the resumed run replaced it with the completed epoch's
    assert runs["resumed"]["meta"] == runs["whole"]["meta"] == {
        "begin_epoch": 1, "tensorboard_global_steps": 4, "iteration": 0}


def test_resumed_run_equals_the_uninterrupted_one_bit_for_bit(runs):
    whole, pre, res = runs["whole"], runs["preempted"], runs["resumed"]
    assert len(whole["seen"]) == 8 and len(res["seen"]) == 5
    assert whole["trainer"].pretrained_loaded == len(list(whole["trainer"].model.parameters()))
    sd_a, mom_a, n_a = _state(whole["trainer"])
    sd_c, mom_c, n_c = _state(res["trainer"])
    assert n_a == n_c == 8
    for k, v in sd_a.items():
        assert torch.equal(v, sd_c[k]), k
    for a, c in zip(mom_a, mom_c):
        assert a.keys() == c.keys() == {"step", "exp_avg", "exp_avg_sq"}
        for k in a:
            assert torch.equal(a[k], c[k]), k
    assert sorted(whole["losses"]) == list(range(1, 9))
    assert {**pre["losses"], **res["losses"]} == whole["losses"]
    assert whole["seen"] == pre["seen"] + res["seen"]
    assert res["files"] == whole["files"]
    assert whole["files"][:-2] == [f for f in whole["files"] if f.startswith("best_mAP_")]
    assert whole["files"][-2:] == ["epoch_0_state", "epoch_1_state"]
    for name in ("epoch_1_state",):
        meta_a = ckpt.restore_checkpoint(
            os.path.join(whole["trainer"].checkpoints_save_folder, name))["meta"]
        meta_c = ckpt.restore_checkpoint(
            os.path.join(res["trainer"].checkpoints_save_folder, name))["meta"]
        assert meta_a == meta_c == {"begin_epoch": 2, "tensorboard_global_steps": 8,
                                    "iteration": 0}
    assert [v[1] for v in whole["validations"]] == [v[1] for v in res["validations"]]


def test_sigma_schedule_draws_epoch_one_at_sigma_minus_one(runs):
    seen = runs["whole"]["seen"]
    assert [s for s, _, _ in seen] == [2] * 4 + [1] * 4
    mass = [t / w for _, t, w in seen]          # target mass a labelled joint
    assert max(mass[4:]) < 0.6 * min(mass[:4]), mass


def test_eval_cli_reproduces_the_best_validation(runs, workspace):
    root = workspace[0]
    whole = runs["whole"]
    tables = [(mean_ap, name_values) for name_values, mean_ap in whole["validations"]]
    assert len(tables) == 2
    best_ap, best_table = max(tables, key=lambda t: t[0])
    folder = whole["trainer"].checkpoints_save_folder
    best = ckpt.get_best_checkpoint(folder)
    assert os.path.basename(best) == f"best_mAP_{float(best_ap)}_state"
    yaml = os.path.join(str(root), "whole.yaml")
    ev = Eval("validate", default_parse_args(["--cfg", yaml, "--root_dir", str(root),
                                              "VAL.MODEL_FILE", best]), device="cpu")
    (_, name_values, mean_ap), = ev.eval()
    assert mean_ap == best_ap
    table = np.asarray([name_values[k] for k in AP_KEYS], np.float64)
    want = np.asarray([best_table[k] for k in AP_KEYS], np.float64)
    np.testing.assert_array_equal(table, want)
    assert np.isfinite(table).any() and np.nanmin(table) < 99.0


@pytest.mark.slow
def test_both_train_clis_agree_for_one_epoch(tmp_path):
    """The JAX CLI's batch is ``BATCH_SIZE_PER_GPU`` x 8 devices; the port's
    is its own ``BATCH_SIZE_PER_GPU``, set to 8 x JAX's.  SGD with momentum
    and no weight decay, lr 1e-3 from the first step, as
    ``tests/test_torch_preempt.py`` holds ``train_epoch``."""
    import jax
    from otpose_tpu.cli import train as jax_train
    from otpose_tpu.cli.train import Train as JaxTrain
    from otpose_tpu.config import default_parse_args as jax_parse_args
    from otpose_tpu.data import native as jax_native
    from otpose_tpu.engine import checkpoints as jax_ckpt
    from otpose_tpu.models.otpose import OTPoseSpec as JaxSpec
    from otpose_tpu.models.otpose import _init_otpose_impl
    from otpose_tpu.utils.testing import tiny_otpose_cfg as jax_tiny_cfg
    from otpose_tpu_torch.models.blocks import set_drop_rates
    from otpose_tpu_torch.models.jax_bridge import jax_layout, load_jax_weights

    from tests.helpers.torch_port import numpy_weights

    assert len(jax.devices()) == 8
    dirs = make_synthetic_posetrack(str(tmp_path), num_videos=2, frames_per_video=4,
                                    people_per_frame=2, img_w=96, img_h=96)
    pth = str(tmp_path / "shared.pth")
    sgd = ("TRAIN.OPTIMIZER", "SGD", "TRAIN.WD", "0.0", "TRAIN.LR", "0.001")
    jyaml = _fill(jax_tiny_cfg(), tmp_path, dirs, pth, "jax_cli", 1)
    tyaml = _fill(tiny_otpose_cfg(), tmp_path, dirs, pth, "torch_cli", 8)
    # tests/test_torch_eval_cli.py's weights: numpy values with JAX init's
    # keys, HRNet's final conv scaled so the losses stay O(1), the offset and
    # mask convs so the DCN samples near its taps.  (The reference init is no
    # witness: its gradients are f32 residue in most tensors, and the two
    # packages' updates there differ in sign.)
    params, state = numpy_weights(_init_otpose_impl,
                                  JaxSpec.from_cfg(jax_tiny_cfg()))
    for name in params:
        if name.endswith(".weight") and name.startswith(("offsets_list", "masks_list")):
            params[name] = params[name] * np.float32(3e-4)
    for k in ("weight", "bias"):
        params[f"rough_pose_estimation_net.final_layer.{k}"] *= np.float32(0.05)
    _, model = build_model(tiny_otpose_cfg(), device="cpu")
    load_jax_weights(model, params, state)
    torch.save({"state_dict": model.state_dict()}, pth)
    make_jax_step = jax_train.make_train_step

    with pytest.MonkeyPatch.context() as mp:
        import tensorboardX

        mp.setattr(tensorboardX, "SummaryWriter", Scalars)
        mp.setattr(jax_native, "is_available", lambda: False)
        # the step's spec without dropout; the init's keeps the drop-path
        # scales, which JAX creates only where the rate is above 0
        mp.setattr(jax_train, "make_train_step", lambda spec, *a, **k: make_jax_step(
            dataclasses.replace(spec, proj_pdrop=0.0, path_pdrop=0.0), *a, **k))
        jargs = jax_parse_args(["--cfg", jyaml, "--root_dir", str(tmp_path),
                                "TRAIN.END_EPOCH", "1", *sgd])
        jt = JaxTrain(jargs)
        jt.train()
        jax_ckpt.wait_for_saves()
        want_losses = jt.tb_writer.losses()
        want = jax_ckpt.restore_checkpoint(
            os.path.join(jt.checkpoints_save_folder, "epoch_0_state"))["params"]

        tt = Train(default_parse_args(["--cfg", tyaml, "--root_dir", str(tmp_path),
                                       "--device", "cpu", "TRAIN.END_EPOCH", "1", *sgd]))
        set_drop_rates(tt.model)
        tt.train()
        got_losses = tt.tb_writer.losses()
    assert tt.batch_size == jt.batch_size == 8 and len(tt.loader) == 2
    assert sorted(got_losses) == sorted(want_losses) == [1, 2]
    assert got_losses[1] == pytest.approx(want_losses[1], rel=1e-5)
    assert got_losses[2] == pytest.approx(want_losses[2], rel=1e-3)
    saved = ckpt.restore_checkpoint(os.path.join(tt.checkpoints_save_folder, "epoch_0_state"))
    assert set(saved["params"]) == set(want)
    for k, v in saved["params"].items():
        w = np.asarray(want[k])
        np.testing.assert_allclose(jax_layout(k, v), w, rtol=0, atol=1e-3 * np.abs(w).max(),
                                   err_msg=k)
    assert tt.cfg.TRAIN.OPTIMIZER == "SGD"
    assert not np.array_equal(np.asarray(want["final_layer1.weight"]),
                              params["final_layer1.weight"])


def test_train_refuses_what_is_not_ported(workspace, tmp_path):
    root, dirs, pth = workspace
    yaml = _fill(tiny_otpose_cfg(image_size=32, heatmap_size=8), tmp_path, dirs, pth,
                 "refuse", 2)
    with pytest.raises(NotImplementedError, match="item 10"):
        Train(_args(yaml, tmp_path, "DEBUG.VIS_SKELETON", "True"))
    trainer = Train(_args(yaml, tmp_path, "DEBUG.VIS_TENSORBOARD", "True"))
    with pytest.raises(NotImplementedError, match="item 10"):
        train_cli.train_epoch(trainer.step_fn, trainer.train_state, trainer.loader, 0,
                              trainer.cfg, seed=0, generator=trainer.generator,
                              tb_writer=Scalars(None))


def test_without_val_annotations_training_goes_on_unvalidated(workspace, tmp_path):
    """As the JAX CLI does: absent val annotations disable validation (and
    so the best checkpoint) with a warning; the epochs are trained and
    saved."""
    import shutil

    root, (json_dir, img_dir, annot_dir), pth = workspace
    own_json = tmp_path / "json"
    shutil.copytree(json_dir, own_json)
    (own_json / "posetrack_val.json").unlink()
    cfg = tiny_otpose_cfg(image_size=32, heatmap_size=8)
    cfg.TRAIN.END_EPOCH = 1
    yaml = _fill(cfg, tmp_path, (str(own_json), img_dir, annot_dir), pth, "no_val", 2)
    trainer = Train(_args(yaml, tmp_path))
    state = trainer.train()
    assert state.step == len(trainer.loader) == 4
    assert trainer._val_dataset is None
    assert os.listdir(trainer.checkpoints_save_folder) == ["epoch_0_state"]
