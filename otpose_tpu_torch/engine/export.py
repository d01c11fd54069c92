"""Export of the eval step for serving (counterpart of
``otpose_tpu/engine/export.py``).

``export_eval`` traces the port's eval step with ``torch.export.export`` at
a fixed batch (static shapes, as the JAX package fixes its batch) into an
``ExportedProgram``:

- the program is the live eval step's own path, the fused attention, fused
  MLP and DCN kernels included: each kernel is a registered op
  (``ops/cuda/registry.py``) with a CPU and a CUDA implementation, so one
  program runs on either device (``"fused": true`` in the manifest);
- the kernels' weight packs are made once, at export time, and pinned
  (``models/blocks.py::pin_packs``): a served call makes no pack;
- the program is the single-device step whatever mesh the process formed
  (it runs no collective and takes no ``seq``), as the JAX package exports
  outside any mesh (``null_mesh_context``);
- ``bake_weights`` keeps the weights and packs in the program; without it
  the program holds code only and takes them as its first argument, from an
  ``otpose_weights.npz`` sidecar (bf16 as a uint16 view plus a dtype map).

``save_exported`` writes the program (``torch.export.save``), the json
manifest and the sidecar; ``load_exported`` reads them back and imports
only torch and the module that registers the ops, never the model code.
``cli/export.py`` wires it to checkpoints, ``tools/serve.py`` serves it.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import os.path as osp

import numpy as np
import torch
from torch import nn

from otpose_tpu_torch.ops.cuda import registry  # noqa: F401  (registers the ops)
from otpose_tpu_torch.utils.device import resolve_device, resolve_dtype

_PROGRAM_NAME = "otpose_eval.pt2"
_META_NAME = "otpose_export.json"
_WEIGHTS_NAME = "otpose_weights.npz"


@dataclasses.dataclass
class ExportBundle:
    """An exported eval step: the program, the device it was traced on and,
    for an external-weights export, the weights it takes by name (None when
    they are baked into the program)."""
    program: torch.export.ExportedProgram
    device: torch.device
    weights: dict | None = None


class _Step(nn.Module):
    """The eval step as a module whose state is the model's."""

    def __init__(self, model: nn.Module, step):
        super().__init__()
        self.model = model
        self.step = step

    def forward(self, inputs, margin):
        return self.step(inputs, margin)


class _External(nn.Module):
    """A ``_Step`` that takes its state as the first argument: the model is
    held outside the module tree, so the traced program holds code only."""

    def __init__(self, served: _Step):
        super().__init__()
        self.__dict__["served"] = served

    def forward(self, weights, inputs, margin):
        return torch.func.functional_call(self.served, weights, (inputs, margin))


def export_eval(model: nn.Module, *, batch_size: int, compute_dtype=torch.float32,
                flip: bool = False, decoded: bool = True, bf16_params: bool = False,
                bake_weights: bool = True, device=None) -> ExportBundle:
    """Trace the eval step of (a copy of) ``model`` on ``device`` (``cuda``
    unless the caller asks for the CPU) at batch ``batch_size``.

    The program is called as ``(inputs (B, H, W, 15) f32, margin (B, 4)
    f32)``, after the weights when they are external, and returns the
    decoded ``(coords (B, J, 2), maxvals (B, J, 1), raw_coords (B, J, 2))``
    when ``decoded`` (the serving path), else ``(heatmaps (B, Hh, Hw, J),
    teacher)``.  ``bf16_params`` casts the conv and dense weights to bf16 as
    ``prepare_eval_params`` does.  The caller's model is left as it was."""
    from otpose_tpu_torch.engine.trainer import make_decoded_eval_step, make_eval_step
    from otpose_tpu_torch.models.blocks import pin_packs
    from otpose_tpu_torch.models.otpose import prepare_eval_params

    dev = resolve_device(device)
    dtype = resolve_dtype(compute_dtype)
    model = copy.deepcopy(model).to(dev).eval()
    prepare_eval_params(model, torch.bfloat16 if bf16_params else None)
    if decoded:
        step = make_decoded_eval_step(model, compute_dtype=dtype, flip=flip)
    else:
        step = make_eval_step(model, compute_dtype=dtype)
    spec = model.spec
    # HRNet's stride is 4: the input image is 4x the heatmap grid
    args = (torch.zeros(batch_size, spec.pe_h * 4, spec.pe_w * 4, 15, device=dev),
            torch.ones(batch_size, 4, device=dev))
    pin_packs(model, lambda: step(args[0][:1], args[1][:1]))
    served = _Step(model, step)
    with torch.no_grad():
        if bake_weights:
            return ExportBundle(torch.export.export(served, args, strict=False), dev)
        weights = {**dict(served.named_parameters()), **dict(served.named_buffers())}
        weights = {k: v.detach() for k, v in weights.items()}
        program = torch.export.export(_External(served), (weights, *args), strict=False)
    return ExportBundle(program, dev, weights)


def _save_weights_npz(path: str, weights: dict) -> None:
    """Named tensors -> npz.  npz has no bf16, so bf16 tensors are stored as
    uint16 views with a dtype map."""
    arrays, dtypes = {}, {}
    for k, v in weights.items():
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            dtypes[k] = "bfloat16"
            v = v.view(torch.uint16)
        arrays[k] = v.numpy()
    np.savez(path, __dtypes__=json.dumps(dtypes), **arrays)


def _load_weights_npz(path: str, device) -> dict:
    """The tensors of ``_save_weights_npz``, in the order they were saved,
    on ``device``."""
    out = {}
    with np.load(path) as z:
        dtypes = json.loads(str(z["__dtypes__"]))
        for k in z.files:
            if k == "__dtypes__":
                continue
            t = torch.from_numpy(np.ascontiguousarray(z[k]))
            if k in dtypes:
                t = t.view(getattr(torch, dtypes[k]))
            out[k] = t.to(device)
    return out


def save_exported(out_dir: str, exported: ExportBundle, spec, *, batch_size: int,
                  compute_dtype, flip: bool, decoded: bool) -> str:
    """Write the artifact directory: the program, a json manifest and, for
    external weights, the ``otpose_weights.npz`` sidecar."""
    os.makedirs(out_dir, exist_ok=True)
    external = exported.weights is not None
    # the trace's example inputs would be saved with the program: the zero
    # clips of a full batch and, with external weights, the weights too
    exported.program.example_inputs = None
    torch.export.save(exported.program, osp.join(out_dir, _PROGRAM_NAME))
    if external:
        _save_weights_npz(osp.join(out_dir, _WEIGHTS_NAME), exported.weights)
    meta = {
        "batch_size": batch_size,
        "compute_dtype": str(resolve_dtype(compute_dtype)).removeprefix("torch."),
        "flip": flip,
        "decoded": decoded,
        "weights": "external" if external else "baked",
        "num_joints": spec.num_joints,
        "heatmap_size": [spec.pe_w, spec.pe_h],
        "image_size": [spec.pe_w * 4, spec.pe_h * 4],
        "torch_version": torch.__version__,
        "platforms": ["cpu", "cuda"],
        "device": str(exported.device),
        "fused": True,
    }
    with open(osp.join(out_dir, _META_NAME), "w") as f:
        json.dump(meta, f, indent=2)
    return out_dir


@dataclasses.dataclass
class ExportedModel:
    """A loaded serving artifact: ``model(inputs, margin)`` with arrays or
    tensors of the exported batch; returns the program's outputs on
    ``device``."""
    meta: dict
    module: nn.Module
    device: torch.device
    weights: dict | None = None

    def __call__(self, inputs, margin):
        b = self.meta["batch_size"]
        inputs = torch.as_tensor(inputs, dtype=torch.float32, device=self.device)
        margin = torch.as_tensor(margin, dtype=torch.float32, device=self.device)
        if inputs.shape[0] != b or margin.shape[0] != b:
            raise ValueError(f"inputs of shape {tuple(inputs.shape)} and margin of shape "
                             f"{tuple(margin.shape)}: the artifact was exported for batch {b}")
        args = (inputs, margin) if self.weights is None else (self.weights, inputs, margin)
        with torch.inference_mode():
            return tuple(self.module(*args))


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def load_exported(artifact_dir: str, device=None) -> ExportedModel:
    """Load an artifact directory written by ``save_exported`` onto
    ``device`` (``cuda`` unless the caller asks for the CPU).  A program
    traced on the other device is moved with
    ``torch.export.passes.move_to_device_pass``."""
    from torch.export.passes import move_to_device_pass

    dev = resolve_device(device)
    with open(osp.join(artifact_dir, _META_NAME)) as f:
        meta = json.load(f)
    program = torch.export.load(osp.join(artifact_dir, _PROGRAM_NAME))
    if not _same_device(torch.device(meta["device"]), dev):
        program = move_to_device_pass(program, dev)
    weights = None
    if meta["weights"] == "external":
        weights = _load_weights_npz(osp.join(artifact_dir, _WEIGHTS_NAME), dev)
    return ExportedModel(meta, program.module(), dev, weights)
