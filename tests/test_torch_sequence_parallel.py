"""The port's sequence parallelism (``parallel/sequence.py``, a ``data x seq``
mesh) with four ``gloo`` processes on the CPU: the primitives, the encoder
and the eval steps.

One launch of ``tests/helpers/torch_dist_worker.py seq_eval`` runs every
check at two layouts, ``data = 2 x seq = 2`` and ``data = 1 x seq = 4``;
this process computes the references meanwhile.

- **The primitives**, in f64 on a (2, 6, 48) input: ``shard_tokens``,
  ``gather_tokens``, the halo'd depthwise conv at strides 1 and 2, the
  max-pool skip, the partial scores' sum, ``scramble_across`` and a window
  halo of 3 tokens; each rank's output and its input's gradient (the
  conv's weight gradient summed over the seq group) against the unsharded
  op to 1e-12.
- **The encoder**: a tiny ``ConvTransformer`` (T = 256, arch (0, 2, 1)) and
  a windowed one (window 5, ``use_rel_pe``, one embedding conv): the
  gathered outputs against the one-rank forward to 1e-6 of the peak (f32),
  and the gradients of an f64 copy (the blocks' summed over the seq group)
  to 1e-5 of each tensor's peak: the LNs' statistics and the PE add round
  through f32 even on f64 tensors, and the sums' other order moves those
  roundings.
- **Eval** on ``tiny_otpose_cfg`` with the JAX weights of
  ``tests/test_torch_otpose.py``: the decoded, heatmap and flip steps on
  the eval shard function's rows, fetched, against the port's one-rank
  steps to 1e-5 of the peak (coords equal where a heatmap's top-two gap is
  clear), and the heatmap and decoded steps against JAX's
  ``make_eval_step(spec, seq_axis="seq")`` under the (2, 4) mesh of the 8
  CPU devices within the 7-tuple bar (1e-3 of the peak); no fused-kernel
  call, one DCN call a forward, and the seq group's collectives counted.
- **The eval CLI** at ``data 2 x seq 2`` over ``data/synthetic.py``'s tree
  (9 boxes at a batch of 4: the last batch of 1 runs whole on each data
  group): rank 0's AP table equal to the one-process CLI's to 1e-9, the
  mean AP on every rank.
- **The layout**: ``make_mesh``'s shapes, the loader's rows by data index,
  ``fetch`` returning each data group's rows once, the train BN's running
  variance with the data group's Bessel factor, and an export under a
  ``seq`` mesh equal to one without.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otpose_tpu.engine.trainer import make_decoded_eval_step as jax_decoded_step
from otpose_tpu.engine.trainer import make_eval_step as jax_eval_step
from otpose_tpu.models.otpose import OTPoseSpec as JaxSpec
from otpose_tpu.models.otpose import _init_otpose_impl
from otpose_tpu.parallel.mesh import make_mesh as jax_make_mesh
from otpose_tpu.parallel.mesh import replicate as jax_replicate
from otpose_tpu.parallel.mesh import shard_batch as jax_shard_batch
from otpose_tpu.utils.testing import tiny_otpose_cfg as jax_tiny_cfg
from otpose_tpu_torch.cli.eval import Eval
from otpose_tpu_torch.config import default_parse_args
from otpose_tpu_torch.data.synthetic import ArrayFramesDataset, make_synthetic_posetrack
from otpose_tpu_torch.engine.export import export_eval
from otpose_tpu_torch.engine.runner import make_flip_eval_step
from otpose_tpu_torch.engine.trainer import make_decoded_eval_step, make_eval_step
from otpose_tpu_torch.models import core
from otpose_tpu_torch.models.conv_transformer import (ConvTransformer, ConvTransformerSpec,
                                                      init_conv_transformer_)
from otpose_tpu_torch.models.factory import build_model
from otpose_tpu_torch.models.jax_bridge import load_jax_weights
from otpose_tpu_torch.parallel import distributed, sequence
from otpose_tpu_torch.parallel.mesh import Mesh, make_mesh, seq_group
from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

from tests.helpers.torch_port import (calibrate_refinement, numpy_weights,  # noqa: F401
                                      one_torch_thread)
from tests.test_torch_data_parallel import _launch, _wait
from tests.test_torch_distributed import one_rank_group

pytestmark = pytest.mark.usefixtures("one_torch_thread")
LAYOUTS = ((2, 2), (1, 4))
ENCODERS = {
    "global": dict(n_in=8, n_embd=8, n_head=2, n_embd_ks=3, max_len=256, arch=[0, 2, 1],
                   mha_win_size=[], use_rel_pe=False),
    "window": dict(n_in=8, n_embd=8, n_head=2, n_embd_ks=3, max_len=256, arch=[1, 2, 1],
                   mha_win_size=[5], use_rel_pe=True),
}
AP_KEYS = ("Head", "Shoulder", "Elbow", "Wrist", "Hip", "Knee", "Ankle", "Mean")
PRIMITIVES = ("shard", "gather", "conv_s1", "conv_s2", "max_pool", "scores", "scramble",
              "halo_w")


def seq_collectives_a_forward(spec) -> int:
    """The seq group's collectives in one forward of the tiny OTPose: a
    stem block's halo, score sum and scramble, a branch block's and its
    skip's halo, and one gather an encoder output."""
    def encoder(arch):
        return 3 * arch[1] + 4 * arch[2] + 1 + arch[2]
    return encoder(spec.flow_scale_arch) + 2 * encoder(spec.scale_arch)


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    folder = tmp_path_factory.mktemp("torch_sp")
    jspec = JaxSpec.from_cfg(jax_tiny_cfg())
    params, state = numpy_weights(_init_otpose_impl, jspec)
    cfg = tiny_otpose_cfg()
    _, model = build_model(cfg, device="cpu")
    rng = np.random.RandomState(0)
    x = rng.randn(4, 64, 64, 15).astype(np.float32)
    margin = rng.randint(0, 3, (4, 4)).astype(np.float32)
    calibrate_refinement(params, state, x, margin)
    load_jax_weights(model, params, state)
    cfg_path = str(folder / "cfg.yaml")
    with open(cfg_path, "w") as fh:
        fh.write(cfg.dump())
    torch.save({"state_dict": model.state_dict(), "inputs": torch.from_numpy(x),
                "margin": torch.from_numpy(margin)}, str(folder / "inputs.pt"))
    dirs = make_synthetic_posetrack(str(folder / "tree"), num_videos=1, frames_per_video=3,
                                    people_per_frame=3, img_w=96, img_h=96, seed=4)
    torch.save({"state_dict": model.state_dict()}, str(folder / "weights.pth"))
    cli = {mesh: _eval_cli_cfg(folder, dirs, mesh) for mesh in ("seq", "one")}
    procs = _launch("seq_eval", {"cfg": cfg_path, "inputs": str(folder / "inputs.pt"),
                                 "layouts": [list(lay) for lay in LAYOUTS], "encoders": ENCODERS,
                                 "cli": {"cfg": cli["seq"], "root": str(folder)},
                                 "out": str(folder / "seq_eval_%d.pt")},
                    str(folder / "seq_eval.json"), world=4)

    tx, tm = torch.from_numpy(x), torch.from_numpy(margin)
    one = {"decoded": [a.numpy() for a in make_decoded_eval_step(model)(tx, tm)],
           "heatmap": [a.numpy() for a in make_eval_step(model)(tx, tm)],
           "flip": [a.numpy() for a in make_flip_eval_step(model)(tx, tm)]}
    jcfg = jax_tiny_cfg()
    jcfg.TPU.MESH_AXES, jcfg.TPU.MESH_SHAPE = ["data", "seq"], [2, 4]
    mesh = jax_make_mesh(jcfg)
    jbatch = {"inputs": jnp.asarray(x), "margin": jnp.asarray(margin)}
    with jax.sharding.set_mesh(mesh):
        p, s, b = (jax_replicate(mesh, params), jax_replicate(mesh, state),
                   jax_shard_batch(mesh, jbatch))
        jax_out = {"heatmap": [np.asarray(a) for a in
                               jax_eval_step(jspec, seq_axis="seq")(p, s, b)],
                   "decoded": [np.asarray(a) for a in
                               jax_decoded_step(jspec, seq_axis="seq")(p, s, b)]}
    (_, name_values, mean_ap), = Eval(
        "validate", default_parse_args(["--cfg", cli["one"], "--root_dir", str(folder)]),
        device="cpu", dataset_cls=ArrayFramesDataset).eval()
    _wait(procs, timeout=300)
    ranks = [torch.load(str(folder / f"seq_eval_{r}.pt"), weights_only=False)
             for r in range(4)]
    return dict(model=model, jspec=jspec, one=one, jax=jax_out, ranks=ranks,
                cli=(name_values, mean_ap))


def _eval_cli_cfg(folder, dirs, mesh: str) -> str:
    """A yaml for the eval CLI over the synthetic tree ``dirs`` with the
    weights of ``folder``, on a ``data 2 x seq 2`` mesh or one process."""
    json_dir, img_dir, annot_dir = dirs
    cfg = tiny_otpose_cfg()
    cfg.EXPERIMENT_NAME, cfg.OUTPUT_DIR = f"cli_{mesh}", str(folder / "output")
    cfg.DATASET.NAME = "PoseTrack"
    cfg.DATASET.JSON_DIR, cfg.DATASET.IMG_DIR = json_dir, img_dir
    cfg.DATASET.TEST_IMG_DIR = img_dir
    cfg.DATASET.COLOR_RGB = True
    cfg.VAL.ANNOT_DIR = annot_dir
    cfg.VAL.USE_GT_BBOX = True
    cfg.VAL.BATCH_SIZE_PER_GPU = 4 if mesh == "one" else 1
    cfg.VAL.MODEL_FILE = str(folder / "weights.pth")
    cfg.WORKERS = 1
    cfg.TPU.DEVICE_PREPROCESS = "off"
    if mesh == "seq":
        cfg.TPU.MESH_AXES, cfg.TPU.MESH_SHAPE = ["data", "seq"], [2, 2]
    path = folder / f"cli_{mesh}.yaml"
    path.write_text(cfg.dump())
    return str(path)


def _seq_ranks(sp, layout):
    """The results of the ranks of data group 0, in seq-index order."""
    return [sp["ranks"][r]["results"][layout] for r in range(layout[1])]


# ---------------------------------------------------------------- primitives

def _reference(name, inputs, gys, bounds):
    """The unsharded op's per-rank outputs and its leaves' gradients for the
    loss ``sum over the ranks of (output_r * gy_r)`` (one replicated
    ``(output * gy)`` for ``gather``), in f64."""
    full, w, q, k = (inputs[n].clone().requires_grad_() for n in ("full", "w", "q", "k"))

    def local(y, stride=1):
        """Each rank's slice of an output of length t / stride."""
        return [y[..., lo // stride:hi // stride] for lo, hi in bounds]

    if name == "shard":
        ys, leaves = local(full), [full]
    elif name == "gather":
        ys, leaves = [full] * len(bounds), [full]
    elif name.startswith("conv_s"):
        stride = int(name[-1])
        ys, leaves = local(core.depthwise_conv1d_k3_ct(full, w, stride=stride), stride), [full, w]
    elif name == "max_pool":
        ys, leaves = local(core.max_pool1d_ct(full, 3, 2, 1), 2), [full]
    elif name == "scores":
        ys, leaves = [q @ k.transpose(-1, -2)] * len(bounds), [q, k]
    elif name == "scramble":
        ys, leaves = local(sequence.scramble(full, 2)), [full]
    else:                                   # halo_w: 3 tokens a side on the (B, nh, hs, T) map
        win = torch.from_numpy(np.random.RandomState(5).randn(*q.shape)).requires_grad_()
        padded = torch.nn.functional.pad(win, (3, 3))
        ys, leaves = [padded[..., lo:hi + 6] for lo, hi in bounds], [win]
    if name == "gather":
        loss = (ys[0] * gys[0]).sum()
    else:
        loss = sum((y * gy).sum() for y, gy in zip(ys, gys))
    loss.backward()
    return [y.detach() for y in ys], [v.grad for v in leaves]


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda lay: f"{lay[0]}x{lay[1]}")
@pytest.mark.parametrize("name", PRIMITIVES)
def test_primitive_equals_the_unsharded_op_in_f64(sp, layout, name):
    ranks = _seq_ranks(sp, layout)
    bounds = [r["primitives"]["bounds"] for r in ranks]
    got = [r["primitives"]["out"][name] for r in ranks]
    ys, grads = _reference(name, ranks[0]["primitives"]["inputs"],
                              [g["gy"] for g in got], bounds)
    for s, (g, y, (lo, hi)) in enumerate(zip(got, ys, bounds)):
        assert g["y"].shape == y.shape, (s, name)
        np.testing.assert_allclose(g["y"].numpy(), y.numpy(), rtol=0, atol=1e-12)
        # the replicated input's whole gradient for ``shard``, else the slice's
        want = grads[0] if name == "shard" else grads[0][..., lo:hi]
        np.testing.assert_allclose(g["grads"][0].numpy(), want.numpy(), rtol=0, atol=1e-12,
                                   err_msg=f"{name} rank {s}")
    if name == "scores":                           # k's gradient, each rank its slice
        for g, (lo, hi) in zip(got, bounds):
            np.testing.assert_allclose(g["grads"][1].numpy(), grads[1][..., lo:hi].numpy(),
                                       rtol=0, atol=1e-12)
    if name.startswith("conv_s"):                  # the weight's gradient, summed
        total = sum(g["grads"][1] for g in got)
        np.testing.assert_allclose(total.numpy(), grads[1].numpy(), rtol=0, atol=1e-12)
    # the other data group computes the same
    if layout[0] > 1:
        other = sp["ranks"][layout[1]]["results"][layout]["primitives"]["out"][name]
        assert torch.equal(other["y"], got[0]["y"])


# ---------------------------------------------------------------- encoder

def _encoder(kw):
    spec = ConvTransformerSpec(**{**kw, "arch": tuple(kw["arch"]),
                                  "mha_win_size": tuple(kw["mha_win_size"])})
    enc = ConvTransformer(spec)
    init_conv_transformer_(enc, torch.Generator().manual_seed(kw["n_in"]))
    return enc.eval()


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda lay: f"{lay[0]}x{lay[1]}")
@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_encoder_equals_the_one_rank_forward(sp, layout, name):
    """The gathered outputs to 1e-6 of the peak (f32); the f64 gradients
    (the blocks' summed over the seq group, the embedding's whole on each
    rank) to 1e-5 of each tensor's peak (the LNs' statistics and the PE add
    round through f32), or 1e-6 of the largest gradient's peak for a tensor
    whose gradient is zero but for rounding (a window block's key bias
    shifts every score of a query alike)."""
    enc = _encoder(ENCODERS[name])
    x = torch.from_numpy(np.random.RandomState(11).randn(2, 8, 16, 16).astype(np.float32))
    with torch.no_grad():
        want = enc(x)
    ranks = _seq_ranks(sp, layout)
    for r in ranks:
        got = r["encoders"][name]["feats"]
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            peak = w.abs().max()
            np.testing.assert_allclose(g.numpy() / peak, w.numpy() / peak, rtol=0, atol=1e-6)
    enc.double()
    feats = enc(x.double())
    sum((f * torch.from_numpy(np.random.RandomState(20 + i).randn(*f.shape))).sum()
        for i, f in enumerate(feats)).backward()
    sharded = {n for n, _ in enc.stem.named_parameters(prefix="stem")} | {
        n for n, _ in enc.branch.named_parameters(prefix="branch")}
    assert any("rel_pe" in n for n in sharded) == ENCODERS[name]["use_rel_pe"]
    floor = 1e-6 * max(float(p.grad.abs().max()) for p in enc.parameters())
    for n, p in enc.named_parameters():
        parts = [r["encoders"][name]["grads"][n] for r in ranks]
        got = sum(parts) if n in sharded else parts[0]
        if n not in sharded:
            assert all(torch.equal(v, parts[0]) for v in parts), n
        atol = max(1e-5 * float(p.grad.abs().max()), floor)
        np.testing.assert_allclose(got.numpy(), p.grad.numpy(), rtol=0, atol=atol, err_msg=n)


# ---------------------------------------------------------------- eval

@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda lay: f"{lay[0]}x{lay[1]}")
@pytest.mark.parametrize("step", ["decoded", "heatmap", "flip"])
def test_eval_step_equals_the_one_rank_step(sp, layout, step):
    want = sp["one"][step]
    for r in range(4):
        res = sp["ranks"][r]["results"][layout]
        got = res[step]
        assert got["sharded"] and got["rows"] == 4 // layout[0]
        assert got["calls"] == {"fused_attn": 0, "fused_mlp": 0,
                                "deform_conv": 2 if step == "flip" else 1}
        forwards = 2 if step == "flip" else 1
        assert got["collectives"]["seq"] == forwards * seq_collectives_a_forward(
            sp["model"].spec)
        assert got["collectives"]["device"] == 0
        if step == "decoded":
            coords, maxvals, raw = got["out"]
            heat = sp["one"]["heatmap"][0]
            flat = np.sort(heat.transpose(0, 3, 1, 2).reshape(4, 17, -1), axis=-1)
            clear = (flat[..., -1] - flat[..., -2]) > 1e-5
            assert clear.mean() > 0.5
            np.testing.assert_array_equal(coords[clear], want[0][clear])
            np.testing.assert_array_equal(raw[clear], want[2][clear])
            peak = np.abs(want[1]).max()
            np.testing.assert_allclose(maxvals / peak, want[1] / peak, rtol=0, atol=1e-5)
        else:
            for g, w in zip(got["out"], want):
                assert g.shape == w.shape
                peak = np.abs(w).max()
                np.testing.assert_allclose(g / peak, w / peak, rtol=0, atol=1e-5)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda lay: f"{lay[0]}x{lay[1]}")
def test_eval_matches_jax_s_seq_sharded_step(sp, layout):
    res = sp["ranks"][0]["results"][layout]
    for g, w in zip(res["heatmap"]["out"], sp["jax"]["heatmap"]):
        assert g.shape == w.shape and np.isfinite(w).all()
        peak = np.abs(w).max()
        np.testing.assert_allclose(g / peak, w / peak, rtol=0, atol=1e-3)
    coords, maxvals, raw = res["decoded"]["out"]
    jc, jm, jr = sp["jax"]["decoded"]
    heat = sp["jax"]["heatmap"][0]
    flat = np.sort(heat.transpose(0, 3, 1, 2).reshape(4, 17, -1), axis=-1)
    clear = (flat[..., -1] - flat[..., -2]) > 1e-3
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(coords[clear], jc[clear])
    np.testing.assert_array_equal(raw[clear], jr[clear])
    peak = np.abs(jm).max()
    np.testing.assert_allclose(maxvals / peak, jm / peak, rtol=0, atol=1e-3)


def test_eval_cli_on_a_seq_mesh_gives_the_one_process_table(sp):
    name_values, mean_ap = sp["cli"]
    assert mean_ap > 0
    for r in range(4):
        got = sp["ranks"][r]["results"]["cli"]
        assert got["batch"] == 4 and got["seq"] == (r % 2, 2)
        assert got["mean_ap"] == pytest.approx(mean_ap, abs=1e-9)
    got = sp["ranks"][0]["results"]["cli"]["name_values"]
    np.testing.assert_allclose([got[k] for k in AP_KEYS], [name_values[k] for k in AP_KEYS],
                               rtol=0, atol=1e-9)


# ---------------------------------------------------------------- layout

@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda lay: f"{lay[0]}x{lay[1]}")
def test_ranks_sit_row_major_and_load_their_data_group_s_rows(sp, layout):
    d, s = layout
    for r in range(4):
        res = sp["ranks"][r]["results"][layout]
        assert res["seq"] == (r % s, s) and res["data"] == (r // s, d)
        per = 8 // d
        assert res["loader_rows"] == list(range((r // s) * per, (r // s + 1) * per))
        assert res["fetch"] == list(range(d))       # each data group's row once


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda lay: f"{lay[0]}x{lay[1]}")
def test_train_bn_counts_each_row_once(sp, layout):
    """The data group's statistics, and the running variance's Bessel
    factor n / (n - 1) with n the global batch's count, not the ranks'."""
    res = sp["ranks"][0]["results"][layout]["bn"]
    x = res["x"]
    n = x.numel() // x.shape[1]
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False) * n / (n - 1)
    for r in range(4):
        got = sp["ranks"][r]["results"][layout]["bn"]
        # the statistics are taken in f32
        np.testing.assert_allclose(got["mean"].numpy(), 0.1 * mean.numpy(), rtol=1e-6)
        np.testing.assert_allclose(got["var"].numpy(), (0.9 + 0.1 * var).numpy(), rtol=1e-6)


def test_make_mesh_reads_data_x_seq_shapes(monkeypatch):
    cfg = tiny_otpose_cfg()
    cfg.TPU.MESH_AXES = ["data", "seq"]
    monkeypatch.setattr(distributed, "process_info", lambda: (0, 8))
    for shape, want in (([-1, 2], Mesh(4, 2)), ([2, -1], Mesh(2, 4)), ([8, 1], Mesh(8, 1)),
                        ([1, 8], Mesh(1, 8))):
        cfg.TPU.MESH_SHAPE = shape
        assert make_mesh(cfg) == want
    for shape in ([3, -1], [2, 2], [-1, -1], [0, 8], [8]):
        cfg.TPU.MESH_SHAPE = shape
        with pytest.raises(ValueError, match="mesh"):
            make_mesh(cfg)
    cfg.TPU.MESH_AXES, cfg.TPU.MESH_SHAPE = ["seq", "data"], [2, 4]
    with pytest.raises(ValueError, match="axes"):
        make_mesh(cfg)


def test_a_seq_mesh_without_a_launch_is_one_slice():
    cfg = tiny_otpose_cfg()
    cfg.TPU.MESH_AXES, cfg.TPU.MESH_SHAPE = ["data", "seq"], [1, -1]
    mesh = make_mesh(cfg)
    assert mesh == Mesh(1, 1) and seq_group(mesh) == sequence.SeqGroup(1, 0)
    assert seq_group(make_mesh()) is None
    with pytest.raises(ValueError, match="stride"):
        sequence.check_shardable(256, 3)
    with pytest.raises(ValueError, match="stride 4"):
        sequence.check_shardable(6920, 4, 4)
    sequence.check_shardable(6912, 4, 4)
    sequence.check_shardable(6912, 2, 4)
    x = torch.randn(1, 2, 6)
    with pytest.raises(ValueError, match="halo"):
        sequence.halo(x, 7, 0, sequence.SeqGroup(1, 0))


def test_an_uneven_shard_raises_in_the_forward():
    enc = _encoder(ENCODERS["global"])
    with pytest.raises(ValueError, match="T = 256"):
        enc(torch.randn(1, 8, 16, 16), seq=sequence.SeqGroup(3, 0))


def test_export_under_a_seq_mesh_equals_one_without():
    """The exported program is the single-device one whatever mesh the
    process formed (JAX exports outside any mesh)."""
    _, model = build_model(tiny_otpose_cfg(image_size=32, heatmap_size=8), seed=1, device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 32, 32, 15).astype(np.float32))
    margin = torch.ones(2, 4)
    outside = export_eval(model, batch_size=2, device="cpu")
    cfg = tiny_otpose_cfg()
    cfg.TPU.MESH_AXES, cfg.TPU.MESH_SHAPE = ["data", "seq"], [1, 1]
    with one_rank_group():
        assert seq_group(make_mesh(cfg)) == sequence.SeqGroup(1, 0)
        assert distributed.seq_info() == (0, 1)
        inside = export_eval(model, batch_size=2, device="cpu")
    for a, b in zip(inside.program.module()(x, margin), outside.program.module()(x, margin)):
        assert torch.equal(a, b)


def test_the_dropout_mask_is_the_one_rank_mask_sliced():
    x = torch.randn(2, 3, 8)
    gen = torch.Generator().manual_seed(4)
    with core.use_generator(gen):
        whole = core.dropout(x, 0.5, True)
    parts = []
    for index in range(2):
        gen.manual_seed(4)
        with core.use_generator(gen):
            parts.append(core.dropout(x[..., 4 * index:4 * index + 4], 0.5, True,
                                      sequence.SeqGroup(2, index)))
    assert torch.equal(torch.cat(parts, dim=-1), whole)
    y = torch.randn(2, 2, 8, 5)
    gen.manual_seed(4)
    with core.use_generator(gen):
        whole = core.dropout(y, 0.5, True)
    gen.manual_seed(4)
    with core.use_generator(gen):
        part = core.dropout(y[:, :, 4:], 0.5, True, sequence.SeqGroup(2, 1), dim=2)
    assert torch.equal(part, whole[:, :, 4:])
