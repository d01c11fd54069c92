"""One rank of the port's multi-process tests (tests/test_torch_data_parallel.py).

    OTPOSE_COORDINATOR=127.0.0.1:<port> OTPOSE_NUM_PROCESSES=N OTPOSE_PROCESS_ID=i \\
        python tests/helpers/torch_dist_worker.py TASK SPEC_JSON

runs TASK on the CPU with one torch thread and writes its results to
``spec["out"] % rank``.  The tasks:

- ``steps``: ``make_train_step`` on this rank's rows (``distributed.local_rows``)
  of the global batch in ``spec["inputs"]``, two steps for each of
  ``spec["accum"]``; the metrics, the state after and the collectives counted;
- ``evaluate``: ``evaluate_epoch_decoded`` over ``data/synthetic.py``'s tree
  with the eval shard function; the AP table and the mean AP;
- ``train_cli``: ``cli/train.py::Train(...).train()`` over the same kind of
  tree, rank ``spec["sigterm_rank"]`` sending itself SIGTERM after
  ``spec["sigterm_after"]`` steps; the steps' losses, the checkpoint writes
  this rank made, the checkpoint folder's listing and the state after.

It imports torch and the port only (the test process computes the JAX side).
"""

import json
import os
import signal
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import torch  # noqa: E402

torch.set_num_threads(1)

from otpose_tpu_torch.config import default_parse_args, get_cfg  # noqa: E402
from otpose_tpu_torch.parallel import distributed  # noqa: E402


def _cfg(path):
    cfg = get_cfg()
    cfg.merge_from_file(path)
    return cfg


def steps(spec):
    from otpose_tpu_torch.engine.optim import make_optimizer, make_schedule
    from otpose_tpu_torch.engine.trainer import make_train_step
    from otpose_tpu_torch.models.blocks import set_drop_rates
    from otpose_tpu_torch.models.factory import build_model
    from otpose_tpu_torch.parallel.mesh import replicate

    cfg = _cfg(spec["cfg"])
    rank, world = distributed.maybe_initialize(cfg, device="cpu")
    blob = torch.load(spec["inputs"], weights_only=True)
    results = {}
    for accum in spec["accum"]:
        _, model = build_model(cfg, device="cpu")
        model.load_state_dict(blob["state_dict"])
        replicate(set_drop_rates(model))
        opt = make_optimizer(model, cfg, make_schedule(cfg, 1))
        step = make_train_step(model, opt, accum_steps=accum,
                               generator=torch.Generator().manual_seed(0))
        rows = distributed.local_rows(len(blob["batch"]["inputs"]), accum)
        batch = {k: v[rows] for k, v in blob["batch"].items()}
        before = dict(distributed.COUNTS)
        metrics = [{k: float(v) for k, v in step(batch).items()} for _ in range(2)]
        results[accum] = dict(metrics=metrics, state=model.state_dict(), rows=rows.tolist(),
                              collectives={k: distributed.COUNTS[k] - before[k]
                                           for k in before})
    torch.save({"rank": rank, "world": world, "results": results}, spec["out"] % rank)


def evaluate(spec):
    from otpose_tpu_torch.data import make_loader
    from otpose_tpu_torch.data.synthetic import ArrayFramesDataset
    from otpose_tpu_torch.engine.runner import evaluate_epoch_decoded
    from otpose_tpu_torch.engine.trainer import make_decoded_eval_step
    from otpose_tpu_torch.models.factory import build_model
    from otpose_tpu_torch.parallel.mesh import make_eval_shard_fn, make_mesh

    cfg = _cfg(spec["cfg"])
    rank, world = distributed.maybe_initialize(cfg, device="cpu")
    ds = ArrayFramesDataset(cfg, "validate")
    _, model = build_model(cfg, device="cpu")
    model.load_state_dict(torch.load(spec["weights"], weights_only=True))
    loader = make_loader(cfg, ds, cfg.VAL.BATCH_SIZE_PER_GPU * world, shuffle=False,
                         device="cpu")
    name_values, mean_ap = evaluate_epoch_decoded(
        make_decoded_eval_step(model), loader, ds, cfg, spec["output_dir"], device="cpu",
        shard_fn=make_eval_shard_fn(make_mesh(cfg)))
    with open(spec["out"] % rank, "w") as fh:
        json.dump({"rank": rank, "name_values": name_values, "mean_ap": mean_ap,
                   "batches": [len(b) for b in loader._index_batches()]}, fh)


def train_cli(spec):
    from otpose_tpu_torch.cli.train import Train
    from otpose_tpu_torch.data.synthetic import ArrayFramesDataset
    from otpose_tpu_torch.engine import checkpoints as ckpt

    writes = []
    commit = ckpt._commit

    def counted_commit(path, payload):
        writes.append(os.path.basename(path))
        commit(path, payload)

    ckpt._commit = counted_commit
    args = default_parse_args(["--cfg", spec["cfg"], "--root_dir", spec["root"],
                               "--device", "cpu"])
    trainer = Train(args, dataset_cls=ArrayFramesDataset)
    rank = distributed.process_info()[0]
    seen = []
    step = trainer.step_fn

    def counted(batch):
        metrics = step(batch)
        seen.append(float(metrics["final_loss"]))
        if rank == spec.get("sigterm_rank") and len(seen) == spec["sigterm_after"]:
            os.kill(os.getpid(), signal.SIGTERM)
        return metrics

    trainer.step_fn = counted
    trainer.train()
    opt = trainer.optimizer
    torch.save({"rank": rank, "losses": seen, "writes": writes,
                "files": sorted(os.listdir(trainer.checkpoints_save_folder)),
                "state_dict": trainer.model.state_dict(), "count": opt.count,
                "moments": [opt.opt.state[p] for p in opt.params]}, spec["out"] % rank)


if __name__ == "__main__":
    task, spec_path = sys.argv[1:3]
    with open(spec_path) as fh:
        spec = json.load(fh)
    try:
        {"steps": steps, "evaluate": evaluate, "train_cli": train_cli}[task](spec)
    finally:
        distributed.shutdown()
    print("WORKER_OK", flush=True)
