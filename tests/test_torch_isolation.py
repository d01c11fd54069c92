"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points run on CUDA unless asked for the CPU."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

from otpose_tpu_torch.cli.inference import PoseEstimator
from otpose_tpu_torch.models.factory import build_model
from otpose_tpu_torch.utils.device import resolve_device
from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

ROOT = pathlib.Path(__file__).resolve().parents[1]
_FORBIDDEN = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|otpose_tpu)(\.|\s|$)", re.M)


def _port_sources():
    return sorted((ROOT / "otpose_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import otpose_tpu_torch\n"
        "for m in pkgutil.walk_packages(otpose_tpu_torch.__path__, 'otpose_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'otpose_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('otpose_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 40


def test_every_port_module_imports_without_cv2():
    """cv2 is imported only where an image file is read, warped, blurred or
    drawn (the path-reading ``PoseEstimator.__call__``; ``PoseTrackDataset``'s
    ``read_frame``, ``warp_frame`` and train-time blur; each function of
    ``utils/images.py``), and tabulate nowhere:
    the card's machine is promised neither.  The eval and training engines'
    modules are named so that a rename cannot drop them from the walk
    unnoticed."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['cv2'] = None\n"          # any import of cv2 raises ImportError
        "sys.modules['tabulate'] = None\n"
        "import otpose_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(otpose_tpu_torch.__path__,\n"
        "                                               'otpose_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import otpose_tpu_torch.cli.inference, otpose_tpu_torch.tools.probe_shift\n"
        "want = ['cli.eval', 'cli.export', 'cli.train', 'data.coco_json', 'data.loader',\n"
        "        'data.pipeline', 'data.posetrack', 'data.synthetic',\n"
        "        'engine.base', 'engine.checkpoints', 'engine.export', 'engine.optim',\n"
        "        'engine.preempt', 'engine.runner', 'engine.trainer', 'models.losses',\n"
        "        'ops.ct', 'ops.cuda.registry', 'tools.serve', 'parallel.distributed',\n"
        "        'parallel.mesh', 'data.native', 'data.nvjpeg', 'data.decoders',\n"
        "        'detector.yolov3', 'ops.nms',\n"
        "        'tools.generate_boxes', 'tools.bench_input_pipeline',\n"
        "        'evaluate.converters', 'evaluate.keypoints', 'evaluate.pck', 'evaluate.poseval',\n"
        "        'evaluate.tracking', 'utils.profiling', 'utils.table', 'utils.testing',\n"
        "        'utils.timing', 'utils.images', 'utils.io', 'ops.deform_conv',\n"
        "        'ops.deform_pool', 'models.factory', 'tools.time_train_step',\n"
        "        'tools.exp_fused_train_mlp']\n"
        "missing = [w for w in want if 'otpose_tpu_torch.' + w not in names]\n"
        "assert not missing, missing\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'otpose_tpu', 'orbax'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_decoders_detector_and_their_tools_import_neither_cv2_nor_pil():
    """The native IO bindings, nvJPEG's wrapper, the decoders' choice, the
    detector, NMS and the two tools import cv2 and PIL only where a path
    needs them (the cv2 decode of ``generate_boxes`` without a native
    library, the host loader's frames, PIL's rate in ``chip_smoke.py``), not
    when imported; nothing of them builds a library at import either."""
    code = (
        "import sys\n"
        "sys.modules['cv2'] = None\n"
        "sys.modules['PIL'] = None\n"
        "import otpose_tpu_torch.data.native as n, otpose_tpu_torch.data.nvjpeg as nv\n"
        "import otpose_tpu_torch.data.decoders\n"
        "import otpose_tpu_torch.detector.yolov3, otpose_tpu_torch.ops.nms\n"
        "import otpose_tpu_torch.tools.generate_boxes, otpose_tpu_torch.tools.bench_input_pipeline\n"
        "import otpose_tpu_torch.data.device_loader, otpose_tpu_torch.data.loader\n"
        "assert n._lib is None and n._reason is None and nv._ctx is None\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'otpose_tpu', 'cv2', 'PIL') and sys.modules[k] is not None)\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_serving_imports_no_model_code():
    """The loader of exported programs and the serve tool import torch, the
    op-registering modules and no model code (nor JAX)."""
    code = (
        "import sys\n"
        "import otpose_tpu_torch.engine.export, otpose_tpu_torch.tools.serve\n"
        "import torch\n"
        "assert hasattr(torch.ops.otpose, 'fused_attn')\n"
        "bad = sorted(n for n in sys.modules if n.startswith('otpose_tpu_torch.models')\n"
        "             or n.split('.')[0] in ('jax', 'jaxlib', 'otpose_tpu'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_export_cli_defaults_to_cuda_and_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    from otpose_tpu_torch.cli.export import Export
    from otpose_tpu_torch.config import default_parse_args

    cfg = tiny_otpose_cfg()
    cfg.OUTPUT_DIR = str(tmp_path / "output")
    (tmp_path / "cfg.yaml").write_text(cfg.dump())
    args = default_parse_args(["--cfg", str(tmp_path / "cfg.yaml"), "--root_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        Export(args)
    assert not (tmp_path / "output").exists()     # refused before any folder is made


def test_eval_cli_defaults_to_cuda_and_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    from otpose_tpu_torch.cli.eval import Eval
    from otpose_tpu_torch.config import default_parse_args

    cfg = tiny_otpose_cfg()
    cfg.OUTPUT_DIR = str(tmp_path / "output")
    (tmp_path / "cfg.yaml").write_text(cfg.dump())
    args = default_parse_args(["--cfg", str(tmp_path / "cfg.yaml"), "--root_dir", str(tmp_path)])
    assert args.device is None
    with pytest.raises(RuntimeError, match="CUDA"):
        Eval("validate", args)
    assert not (tmp_path / "output").exists()     # refused before any folder is made
    assert default_parse_args(["--device", "cpu"]).device == "cpu"


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_import_in_port_sources(path):
    assert path.exists(), path
    found = _FORBIDDEN.findall(path.read_text())
    assert not found, f"{path}: {found}"


def test_default_device_is_cuda_and_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(tiny_otpose_cfg())
    assert resolve_device("cpu").type == "cpu"


def test_parallel_imports_no_jax():
    """``otpose_tpu_torch/parallel/`` and what it pulls in import neither JAX
    nor the JAX package (which has modules of the same names)."""
    code = (
        "import sys\n"
        "import otpose_tpu_torch.parallel.distributed, otpose_tpu_torch.parallel.mesh\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'otpose_tpu'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("env", [
    {"OTPOSE_COORDINATOR": "127.0.0.1:1", "OTPOSE_NUM_PROCESSES": "4", "OTPOSE_PROCESS_ID": "3"},
    {"RANK": "3", "WORLD_SIZE": "4", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1",
     "LOCAL_RANK": "3"}], ids=["otpose", "torchrun"])
def test_resolve_device_under_a_launch_gives_each_rank_its_card(env, monkeypatch):
    """Under a multi-process launch ``None`` is the rank's card,
    ``cuda:{local_rank % device_count}``; without a GPU it raises, as the
    entry points do; an explicit device is kept."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None, env=env)
    assert resolve_device("cpu", env=env).type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert resolve_device(None, env=env) == torch.device("cuda", 1)
    assert resolve_device(None, env={}) == torch.device("cuda")
    assert resolve_device("cuda:0", env=env) == torch.device("cuda", 0)


def test_pose_estimator_defaults_to_cuda_and_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    cfg = tiny_otpose_cfg(image_size=32, heatmap_size=8)
    _, model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        PoseEstimator(cfg, model)
    assert PoseEstimator(cfg, model, device="cpu").device.type == "cpu"
