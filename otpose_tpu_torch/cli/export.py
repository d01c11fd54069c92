"""Export entry point (counterpart of ``otpose_tpu/cli/export.py``).

    python -m otpose_tpu_torch.cli.export --cfg <yaml> [--batch 16] [--out DIR]
        [--weights baked|external] [--device cpu] [--test] [opts ...]

loads the checkpoint the way the eval CLI does (``TEST.MODEL_FILE`` /
``VAL.MODEL_FILE``, else the latest, else the best checkpoint in the
experiment's checkpoints folder), traces the decoded eval step with
``torch.export`` at the given batch (``engine/export.py``) and writes the
serving artifact.  ``TPU.COMPUTE_DTYPE`` and ``TPU.PARAM_DTYPE`` set the
compute and weight dtypes, ``VAL.FLIP_VAL`` (``TEST.FLIP_TEST`` with
``--test``) the flip test.  The program is traced on ``cuda`` unless
``--device cpu`` is given; either device can load it
(``engine/export.py::load_exported``).  Serving then needs torch and the
op-registering module only: ``load_exported(DIR)(inputs, margin)``, or
``python -m otpose_tpu_torch.tools.serve --artifact DIR``.  Under a
multi-process launch (``parallel/distributed.py``) rank 0 alone exports and
writes; the others wait for it.
"""

from __future__ import annotations

import argparse
import logging
import os.path as osp
import sys

from otpose_tpu_torch.config import default_parse_args
from otpose_tpu_torch.engine import checkpoints as ckpt
from otpose_tpu_torch.engine.base import RunBase
from otpose_tpu_torch.engine.export import export_eval, save_exported
from otpose_tpu_torch.models.factory import build_model
from otpose_tpu_torch.parallel import distributed
from otpose_tpu_torch.utils.device import resolve_device, resolve_dtype

logger = logging.getLogger(__name__)


class Export(RunBase):
    def __init__(self, args, device=None):
        # before any folder is made: without a GPU the default device raises
        self.device = resolve_device(device if device is not None
                                     else getattr(args, "device", None))
        super().__init__("export", args=args)
        distributed.maybe_initialize(self.cfg, device=self.device)
        test = getattr(args, "test", False)
        sub = self.cfg.TEST if test else self.cfg.VAL
        self.model_file = sub.MODEL_FILE
        self.flip = sub.FLIP_TEST if test else sub.FLIP_VAL

    def model_path(self) -> str:
        if self.model_file:
            return ckpt.resolve_model_file(self.model_file, self.cfg,
                                           self.checkpoints_save_folder)
        latest = ckpt.get_latest_checkpoint(self.checkpoints_save_folder)
        if latest is None:
            latest = ckpt.get_best_checkpoint(self.checkpoints_save_folder)
        if latest is None:
            raise FileNotFoundError(f"no checkpoint in {self.checkpoints_save_folder} and no "
                                    f"MODEL_FILE configured")
        return latest

    def export(self, batch_size: int, out_dir: str | None = None,
               weights: str = "baked") -> str:
        if weights not in ("baked", "external"):
            raise ValueError(f"--weights must be baked/external, got {weights!r}")
        out = out_dir or osp.join(self.cfg.OUTPUT_DIR, "export")
        if distributed.is_primary():
            self._export(batch_size, out, weights)
        distributed.barrier()
        return out

    def _export(self, batch_size: int, out: str, weights: str) -> None:
        model_file = self.model_path()
        logger.info("=> exporting %s (batch %d)", model_file, batch_size)
        spec, model = build_model(self.cfg, seed=0, device="cpu")
        n = ckpt.merge_checkpoint(ckpt.restore_checkpoint(model_file), model)
        total = sum(1 for _ in model.parameters())
        logger.info("=> loaded %d/%d tensors", n, total)
        if n == 0:
            # an artifact keeps these weights for good: refuse to ship a
            # random-init model because the cfg and the checkpoint disagree
            raise ValueError(f"checkpoint {model_file} matched 0/{total} tensors of the "
                             f"configured model: wrong --cfg for this checkpoint?")
        compute_dtype = resolve_dtype(self.cfg.TPU.COMPUTE_DTYPE)
        exported = export_eval(model, batch_size=batch_size, compute_dtype=compute_dtype,
                               flip=bool(self.flip), decoded=True,
                               bf16_params=self.cfg.TPU.PARAM_DTYPE == "bfloat16",
                               bake_weights=weights == "baked", device=self.device)
        save_exported(out, exported, spec, batch_size=batch_size, compute_dtype=compute_dtype,
                      flip=bool(self.flip), decoded=True)
        logger.info("=> wrote the serving artifact to %s (%s weights, traced on %s)", out,
                    weights, self.device)


def main(argv=None) -> str:
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--batch", type=int, default=16)
    extra.add_argument("--out", type=str, default=None)
    extra.add_argument("--weights", choices=("baked", "external"), default="baked",
                       help="baked: the weights and the kernels' packs inside the program "
                            "(one self-contained file); external: a code-only program and "
                            "an otpose_weights.npz sidecar")
    ns, rest = extra.parse_known_args(argv)
    args = default_parse_args(rest)
    try:
        return Export(args).export(ns.batch, ns.out, weights=ns.weights)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
