"""One rank of the port's multi-process tests (tests/test_torch_data_parallel.py,
tests/test_torch_sequence_parallel.py, tests/test_torch_sequence_parallel_train.py).

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
- ``seq_eval`` (tests/test_torch_sequence_parallel.py): for each
  ``data x seq`` layout of ``spec["layouts"]``, the sequence-parallel
  primitives in f64 at each length of ``spec["primitive_lengths"]``
  (inputs, outputs and gradients), the tiny encoders' outputs and f64
  gradients, the decoded, heatmap and flip eval steps on
  the eval shard function's rows with ``fetch``, the loader's rows, ``fetch``
  of one row a rank, a train-mode BN on the data group's rows, and the
  collectives and kernel-wrapper calls counted; then the eval CLI
  (``cli/eval.py::Eval``) over ``data/synthetic.py``'s tree with the yaml's
  mesh: its AP table and mean AP;
- ``seq_train`` (tests/test_torch_sequence_parallel_train.py): for each
  case of ``spec["cases"]`` (a layout, ``accum_steps`` and ``remat``) one
  sequence-parallel train step on the rank's rows, and where the case asks,
  the same step without the ``seq`` axis (the data-parallel step, whose
  dropout masks are the same); the metrics, the states and the (clipped)
  gradients after, and the collectives counted; then ``train_cli`` on
  ``spec["cli"]`` (a yaml with a ``seq`` mesh).

It imports torch and the port only (the test process computes the JAX side).
"""

import json
import os
import signal
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from otpose_tpu_torch.config import default_parse_args, get_cfg  # noqa: E402
from otpose_tpu_torch.parallel import distributed  # noqa: E402
from otpose_tpu_torch.utils import profiling  # noqa: E402


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
    seq = None if trainer.seq is None else (trainer.seq.index, trainer.seq.size)
    torch.save({"rank": rank, "losses": seen, "writes": writes, "seq": seq,
                "files": sorted(os.listdir(trainer.checkpoints_save_folder)),
                "state_dict": trainer.model.state_dict(), "count": opt.count,
                "moments": [opt.opt.state[p] for p in opt.params]}, spec["out"] % rank)


def _mesh(cfg, layout):
    from otpose_tpu_torch.parallel.mesh import make_mesh, seq_group

    cfg.TPU.MESH_AXES, cfg.TPU.MESH_SHAPE = ["data", "seq"], list(layout)
    mesh = make_mesh(cfg)
    return mesh, seq_group(mesh)


def _f64(shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape))


def _primitives(seq, t):
    """Each primitive on this rank's slice of an f64 input of ``t`` tokens
    (split at stride 2, as an encoder with one branch level splits it), its
    output and the gradient of ``(output * gy).sum()`` for a ``gy`` seeded by
    the seq index (the same on every rank for ``gather``, whose output is
    replicated)."""
    from otpose_tpu_torch.models import blocks, core
    from otpose_tpu_torch.parallel import sequence

    b, c, nh = 2, 6, 2
    seq = seq.split(t, 2)
    out = {}

    def run(name, fn, x, *extra):
        leaves = [x.detach().requires_grad_()] + [e.detach().requires_grad_() for e in extra]
        y = fn(*leaves)
        gy = _f64(tuple(y.shape), 99 + (0 if name == "gather" else seq.index))
        (y * gy).sum().backward()
        out[name] = dict(y=y.detach(), gy=gy, grads=[v.grad for v in leaves])

    full = _f64((b, c, t), 1)
    lo, hi = seq.bounds()
    local = full[..., lo:hi].contiguous()
    w = _f64((c, 1, 3), 2)
    run("shard", lambda x: sequence.shard_tokens(x, seq), full)
    run("gather", lambda x: sequence.gather_tokens(x, seq), local)
    for stride in (1, 2):
        run(f"conv_s{stride}", lambda x, w, stride=stride: core.depthwise_conv1d_k3_ct(
            sequence.strided_halo(x, 1, 3, stride, seq), w, stride=stride, padded=True),
            local, w)
    run("max_pool", lambda x: blocks._max_pool_skip(x, 2, seq), local)
    q, k = _f64((b, nh, c // nh, t), 3), _f64((b, nh, c // nh, t), 4)
    run("scores", lambda q, k: sequence.all_reduce_partial(q @ k.transpose(-1, -2)),
        q[..., lo:hi].contiguous(), k[..., lo:hi].contiguous())
    run("scramble", lambda x: sequence.scramble_across(x, nh, seq), local)
    win = _f64((b, nh, c // nh, t), 5)[..., lo:hi].contiguous()
    run("halo_w", lambda x: sequence.halo(x, 3, 3, seq), win)
    run("halo_wide", lambda x: sequence.halo(x, 20, 20, seq), win)
    return {"inputs": dict(full=full, w=w, q=q, k=k), "out": out, "bounds": (lo, hi),
            "lengths": seq.lengths}


def _encoders(spec, seq):
    """The tiny encoders of ``spec["encoders"]`` (seeded), in eval
    mode: each forward's outputs, and in f64 the gradients of
    ``sum(outputs * fixed)`` by parameter name."""
    from otpose_tpu_torch.models.conv_transformer import (ConvTransformer,
                                                          ConvTransformerSpec,
                                                          init_conv_transformer_)

    out = {}
    for name, kw in spec["encoders"].items():
        enc = ConvTransformer(ConvTransformerSpec(**{
            **{k: v for k, v in kw.items() if k != "hw"}, "arch": tuple(kw["arch"]),
            "mha_win_size": tuple(kw["mha_win_size"])}))
        init_conv_transformer_(enc, torch.Generator().manual_seed(kw["n_in"]))
        enc.eval()
        x = torch.from_numpy(np.random.RandomState(11).randn(2, kw["n_in"], *kw["hw"])
                             .astype(np.float32))
        with torch.no_grad():
            feats = enc(x, seq=seq)
        enc.double()
        xd = x.double()
        feats64 = enc(xd, seq=seq)
        loss = sum((f * _f64(tuple(f.shape), 20 + i)).sum() for i, f in enumerate(feats64))
        loss.backward()
        out[name] = dict(feats=[f for f in feats],
                         grads={k: p.grad for k, p in enc.named_parameters()})
    return out


def seq_eval(spec):
    from otpose_tpu_torch.data import make_loader
    from otpose_tpu_torch.engine.runner import make_flip_eval_step
    from otpose_tpu_torch.engine.trainer import make_decoded_eval_step, make_eval_step
    from otpose_tpu_torch.models import core
    from otpose_tpu_torch.models.factory import build_model
    from otpose_tpu_torch.parallel.mesh import make_eval_shard_fn

    class Idents:
        def __len__(self):
            return 17

        def get_sample_host(self, idx, rng=None, native_ok=True):
            return idx

    cfg = _cfg(spec["cfg"])
    rank, world = distributed.maybe_initialize(cfg, device="cpu")
    blob = torch.load(spec["inputs"], weights_only=True)
    _, model = build_model(cfg, device="cpu")
    model.load_state_dict(blob["state_dict"])
    results = {}
    for layout in spec["layouts"]:
        mesh, seq = _mesh(cfg, layout)
        res = {"seq": (seq.index, seq.size), "data": distributed.data_info(),
               "primitives": {t: _primitives(seq, t) for t in spec["primitive_lengths"]},
               "encoders": _encoders(spec, seq)}
        shard_fn = make_eval_shard_fn(mesh)
        steps = {"decoded": make_decoded_eval_step(model, seq=seq),
                 "heatmap": make_eval_step(model, seq=seq),
                 "flip": make_flip_eval_step(model, seq=seq)}
        for name, step in steps.items():
            calls_before = profiling.counters()
            before = dict(distributed.COUNTS)
            rows, sharded = shard_fn({"inputs": blob["inputs"], "margin": blob["margin"]},
                                     "cpu")
            outs = step(rows["inputs"], rows["margin"])
            res[name] = dict(
                rows=len(rows["inputs"]), sharded=sharded,
                out=[distributed.fetch(o) if sharded else o.numpy() for o in outs],
                calls={op: profiling.since(calls_before)[f"{op}.calls"]
                       for op in ("fused_attn", "fused_mlp", "deform_conv")},
                collectives={k: distributed.COUNTS[k] - before[k] for k in before})
        cfg.TPU.DEVICE_PREPROCESS = "off"
        loader = make_loader(cfg, Idents(), 8, shuffle=False, drop_last=True,
                             process_shard=True, device="cpu")
        res["loader_rows"] = loader._index_batches()[0].tolist()
        res["fetch"] = distributed.fetch(np.array([distributed.data_info()[0]])).tolist()
        x = _f64((4, 3, 2, 2), 30)
        lo, hi = distributed.local_row_block(4)
        _, mean, var = core.batch_norm_train(x[lo:hi], torch.ones(3, dtype=torch.float64),
                                             torch.zeros(3, dtype=torch.float64),
                                             torch.zeros(3, dtype=torch.float64),
                                             torch.ones(3, dtype=torch.float64))
        res["bn"] = dict(x=x, mean=mean, var=var)
        results[tuple(layout)] = res
    if "cli" in spec:
        from otpose_tpu_torch.cli.eval import Eval
        from otpose_tpu_torch.data.synthetic import ArrayFramesDataset

        ev = Eval("validate", default_parse_args(["--cfg", spec["cli"]["cfg"], "--root_dir",
                                                  spec["cli"]["root"]]),
                  device="cpu", dataset_cls=ArrayFramesDataset)
        (_, name_values, mean_ap), = ev.eval()
        results["cli"] = dict(name_values=name_values, mean_ap=mean_ap, batch=ev.batch,
                              seq=(ev.seq.index, ev.seq.size))
    torch.save({"rank": rank, "world": world, "results": results}, spec["out"] % rank)


def seq_train(spec):
    import copy

    from otpose_tpu_torch.engine.optim import make_optimizer, make_schedule
    from otpose_tpu_torch.engine.trainer import make_train_step
    from otpose_tpu_torch.models.blocks import set_drop_rates
    from otpose_tpu_torch.models.factory import build_model

    cfg = _cfg(spec["cfg"])
    rank, world = distributed.maybe_initialize(cfg, device="cpu")
    blob = torch.load(spec["inputs"], weights_only=True)
    _, model = build_model(cfg, device="cpu")
    model.load_state_dict(blob["state_dict"])
    set_drop_rates(model, attn=spec["drop"], proj=spec["drop"], path=spec["drop"])
    results = []
    for case in spec["cases"]:
        mesh, seq = _mesh(cfg, case["layout"])
        rows = distributed.local_rows(len(blob["batch"]["inputs"]), case["accum"])
        batch = {k: v[rows] for k, v in blob["batch"].items()}
        res = {"case": case, "rows": rows.tolist(), "data": distributed.data_info()}
        for name, s in (("sp", seq), ("no_seq", None))[:1 + bool(case.get("no_seq"))]:
            own = copy.deepcopy(model)
            step = make_train_step(own, make_optimizer(own, cfg, make_schedule(cfg, 1)),
                                   accum_steps=case["accum"], remat=case.get("remat", False),
                                   generator=torch.Generator().manual_seed(spec["seed"]),
                                   seq=s)
            before = dict(distributed.COUNTS)
            metrics = {k: float(v) for k, v in step(batch).items()}
            res[name] = dict(metrics=metrics, state=own.state_dict(),
                             grads={k: p.grad for k, p in own.named_parameters()
                                    if p.grad is not None},
                             collectives={k: distributed.COUNTS[k] - before[k]
                                          for k in before})
        results.append(res)
    torch.save({"rank": rank, "world": world, "results": results}, spec["out"] % rank)
    if "cli" in spec:
        train_cli(spec["cli"])


if __name__ == "__main__":
    task, spec_path = sys.argv[1:3]
    with open(spec_path) as fh:
        spec = json.load(fh)
    try:
        {"steps": steps, "evaluate": evaluate, "train_cli": train_cli, "seq_eval": seq_eval,
         "seq_train": seq_train}[task](spec)
    finally:
        distributed.shutdown()
    print("WORKER_OK", flush=True)
