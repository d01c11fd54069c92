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
    assert int(out.stdout.split()[-1]) >= 20


def test_every_port_module_imports_without_cv2():
    """cv2 is imported only where an image file is read (the path-reading
    ``PoseEstimator.__call__``); the card's machine has no cv2."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['cv2'] = None\n"          # any import of cv2 raises ImportError
        "import otpose_tpu_torch\n"
        "for m in pkgutil.walk_packages(otpose_tpu_torch.__path__, 'otpose_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import otpose_tpu_torch.cli.inference, otpose_tpu_torch.tools.probe_shift\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


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


def test_pose_estimator_defaults_to_cuda_and_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    cfg = tiny_otpose_cfg(image_size=32, heatmap_size=8)
    _, model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        PoseEstimator(cfg, model)
    assert PoseEstimator(cfg, model, device="cpu").device.type == "cpu"
