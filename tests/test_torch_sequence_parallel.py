"""The port's sequence parallelism (``parallel/sequence.py``, a ``data x seq``
mesh) with ``gloo`` processes on the CPU: the primitives, the encoder and
the eval steps, on slices of equal and of unequal length.

Three launches of ``tests/helpers/torch_dist_worker.py seq_eval`` run at
once: four ranks at ``data = 2 x seq = 2`` and ``data = 1 x seq = 4``
(T = 256 splits evenly), three at ``1 x 3`` and six at ``2 x 3``
(T = 64 splits into 22, 22 and 20 tokens, 11, 11 and 10 after the branch;
the encoders' T = 256 into 86, 86 and 84); this process computes the
references meanwhile.

- **The primitives**, in f64 on a (2, 6, T) input split at stride 2, at
  T = 48 (equal slices on 2, 3 and 4 ranks), T = 49 (unequal, the last
  of odd length) and T = 4 (2, 2 and empty slices on 3 and 4 ranks):
  ``shard_tokens``, ``gather_tokens``, the halo'd
  depthwise conv at strides 1 and 2, the max-pool skip, the partial
  scores' sum, ``scramble_across``, a window halo of 3 tokens and one of
  20 (wider than the slices: taken from several); each
  rank's output and its input's gradient (the conv's weight gradient
  summed over the seq group) against the unsharded op to 1e-12.
- **The encoder**: a tiny ``ConvTransformer`` (T = 256, arch (0, 2, 1)) and
  a windowed one (window 5, ``use_rel_pe``, one embedding conv): the
  gathered outputs against the one-rank forward to 1e-6 of the peak (f32),
  and the gradients of an f64 copy (the blocks' summed over the seq group)
  to 1e-5 of each tensor's peak: the LNs' statistics and the PE add round
  through f32 even on f64 tensors, and the sums' other order moves those
  roundings.  Three more encoders take the splits that JAX's partitioner
  pads: a global one at T = 4 (a rank with no token at the deepest level
  on 3 and 4 ranks), a window-9 one at T = 16 (a halo of 4 wider than the
  branch's slices of 3, 3 and 2) and a window-9 one with two branch levels
  at T = 8 (both at once).  On three seq ranks the window encoders'
  outputs also against JAX's ``conv_transformer_forward`` with
  ``seq_axis`` on a mesh of the same shape, to 1e-5 of the peak.
- **Eval** on ``tiny_otpose_cfg`` (T = 256 at the even layouts, T = 64 at
  the uneven ones) with numpy weights of O(1) and the refinement
  calibrated (``tests/helpers/torch_port.py``): the decoded, heatmap and
  flip steps on the eval shard function's rows, fetched, against the
  port's one-rank steps to 1e-5 of the peak (coords equal where a
  heatmap's top-two gap is clear), and the heatmap and decoded steps
  against JAX's ``make_eval_step(spec, seq_axis="seq")`` on a mesh of the
  same shape (the (2, 4) mesh of the 8 CPU devices for the even layouts,
  within the 7-tuple bar of 1e-3 of the peak; the first 3 or 6 devices for
  the uneven ones, within 1e-5 of a peak above 10); no fused-kernel call,
  one DCN call a forward, and the seq group's collectives counted (the
  same number on unequal slices).
- **The eval CLI** at ``data 2 x seq 2`` over ``data/synthetic.py``'s tree
  (9 boxes at a batch of 4: the last batch of 1 runs whole on each data
  group): rank 0's AP table equal to the one-process CLI's to 1e-9, the
  mean AP on every rank.
- **The layout**: ``make_mesh``'s shapes, the loader's rows by data index,
  ``fetch`` returning each data group's rows once, the train BN's running
  variance with the data group's Bessel factor, and an export under a
  ``seq`` mesh equal to one without.
- **The split** (``SeqGroup.split`` / ``down``, empty slices included) and
  the refusals that remain: a block stride that an interior boundary does
  not divide, a slice of another length than its split's (also in the
  forward, before any exchange), a group not split.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otpose_tpu.engine.trainer import make_decoded_eval_step as jax_decoded_step
from otpose_tpu.engine.trainer import make_eval_step as jax_eval_step
from otpose_tpu.models.conv_transformer import ConvTransformerSpec as JaxEncoderSpec
from otpose_tpu.models.conv_transformer import conv_transformer_forward as jax_encoder_forward
from otpose_tpu.models.core import Ctx as JaxCtx
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
from otpose_tpu_torch.models.jax_bridge import load_jax_weights, to_jax
from otpose_tpu_torch.parallel import distributed, sequence
from otpose_tpu_torch.parallel.mesh import Mesh, make_mesh, seq_group
from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

from tests.helpers.torch_port import (calibrate_refinement, numpy_weights,  # noqa: F401
                                      one_torch_thread)
from tests.test_torch_data_parallel import _launch, _wait
from tests.test_torch_distributed import one_rank_group

pytestmark = pytest.mark.usefixtures("one_torch_thread")
LAYOUTS = ((2, 2), (1, 4))          # T = 256: equal slices
UNEVEN = ((1, 3), (2, 3))           # T = 64 (the encoders' 256): slices of unequal length
PRIMITIVE_LENGTHS = (48, 49, 4)     # 49: unequal slices, the last of odd length; 4: empty
# the encoders' input (B, 8, H, W): ``hw`` is (H, W)
ENCODERS = {
    "global": dict(n_in=8, n_embd=8, n_head=2, n_embd_ks=3, max_len=256, arch=[0, 2, 1],
                   mha_win_size=[], use_rel_pe=False, hw=[16, 16]),
    "window": dict(n_in=8, n_embd=8, n_head=2, n_embd_ks=3, max_len=256, arch=[1, 2, 1],
                   mha_win_size=[5], use_rel_pe=True, hw=[16, 16]),
    # the splits JAX pads: T = 4 leaves a rank no token at the deepest level
    # (stride 2) on 3 and 4 ranks; a window of 9 reads 4 tokens a side, more
    # than the branch's slices of 3, 3 and 2 at T = 16; both at once, with
    # two branch levels, at T = 8
    "empty_rank": dict(n_in=8, n_embd=8, n_head=2, n_embd_ks=3, max_len=256, arch=[0, 2, 1],
                       mha_win_size=[], use_rel_pe=False, hw=[2, 2]),
    "wide_window": dict(n_in=8, n_embd=8, n_head=2, n_embd_ks=3, max_len=256, arch=[1, 2, 1],
                        mha_win_size=[9], use_rel_pe=True, hw=[4, 4]),
    "wide_empty": dict(n_in=8, n_embd=8, n_head=2, n_embd_ks=3, max_len=256, arch=[1, 2, 2],
                       mha_win_size=[9], use_rel_pe=True, hw=[2, 4]),
}
WINDOWED = ("window", "wide_window", "wide_empty")
AP_KEYS = ("Head", "Shoulder", "Elbow", "Wrist", "Hip", "Knee", "Ankle", "Mean")
PRIMITIVES = ("shard", "gather", "conv_s1", "conv_s2", "max_pool", "scores", "scramble",
              "halo_w", "halo_wide")
layout_id = lambda lay: f"{lay[0]}x{lay[1]}"  # noqa: E731


def seq_collectives_a_forward(spec) -> int:
    """The seq group's collectives in one forward of the tiny OTPose: a
    stem block's halo, score sum and scramble, a branch block's and its
    skip's halo, and one gather an encoder output."""
    def encoder(arch):
        return 3 * arch[1] + 4 * arch[2] + 1 + arch[2]
    return encoder(spec.flow_scale_arch) + 2 * encoder(spec.scale_arch)


def _eval_weights(folder, cfg, jcfg, tag):
    """The tiny OTPose of ``cfg`` with numpy weights, its refinement
    calibrated on a seeded clip of 4, saved with the clip for the workers;
    (model, jspec, params, state, clip, margin, path)."""
    jspec = JaxSpec.from_cfg(jcfg)
    params, state = numpy_weights(_init_otpose_impl, jspec)
    _, model = build_model(cfg, device="cpu")
    size = cfg.MODEL.IMAGE_SIZE[0]
    rng = np.random.RandomState(0)
    x = rng.randn(4, size, size, 15).astype(np.float32)
    margin = rng.randint(0, 3, (4, 4)).astype(np.float32)
    calibrate_refinement(params, state, x, margin, cfg=cfg)
    load_jax_weights(model, params, state)
    path = str(folder / f"inputs_{tag}.pt")
    torch.save({"state_dict": model.state_dict(), "inputs": torch.from_numpy(x),
                "margin": torch.from_numpy(margin)}, path)
    return model, jspec, params, state, x, margin, path


def _jax_steps(jspec, jcfg, params, state, x, margin, shape):
    """JAX's heatmap and decoded ``seq_axis`` steps on a ``data x seq`` mesh
    of ``shape`` over the first devices."""
    jcfg.TPU.MESH_AXES, jcfg.TPU.MESH_SHAPE = ["data", "seq"], list(shape)
    mesh = jax_make_mesh(jcfg, devices=jax.devices()[:shape[0] * shape[1]])
    jbatch = {"inputs": jnp.asarray(x), "margin": jnp.asarray(margin)}
    with jax.sharding.set_mesh(mesh):
        p, s, b = (jax_replicate(mesh, params), jax_replicate(mesh, state),
                   jax_shard_batch(mesh, jbatch))
        return {"heatmap": [np.asarray(a) for a in
                            jax_eval_step(jspec, seq_axis="seq")(p, s, b)],
                "decoded": [np.asarray(a) for a in
                            jax_decoded_step(jspec, seq_axis="seq")(p, s, b)]}


def _jax_encoder(name, shape):
    """JAX's ``conv_transformer_forward`` with ``seq_axis`` on a ``data x
    seq`` mesh of ``shape``, with the weights of the workers' seeded encoder
    ``name``, on their input."""
    kw = ENCODERS[name]
    enc = _encoder(kw)
    params, state = to_jax(enc)
    jspec = JaxEncoderSpec(**{**{k: v for k, v in kw.items() if k != "hw"},
                              "arch": tuple(kw["arch"]),
                              "mha_win_size": tuple(kw["mha_win_size"])})
    x = _encoder_input(kw).numpy().transpose(0, 2, 3, 1)
    jcfg = jax_tiny_cfg()
    jcfg.TPU.MESH_AXES, jcfg.TPU.MESH_SHAPE = ["data", "seq"], list(shape)
    mesh = jax_make_mesh(jcfg, devices=jax.devices()[:shape[0] * shape[1]])

    def fwd(p, s, x):
        return jax_encoder_forward(JaxCtx(p, s, train=False, fused=False, seq_axis="seq"), x,
                                   jspec, out_layout="ct")

    with jax.sharding.set_mesh(mesh):
        out = jax.jit(fwd)(jax_replicate(mesh, params), jax_replicate(mesh, state),
                           jnp.asarray(x))
        return [np.asarray(a) for a in out]


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    """Three launches at once: four ranks at the even layouts (T = 256, and
    the eval CLI), three at ``1 x 3`` and six at ``2 x 3`` (T = 64); the
    references are computed meanwhile.  ``runs[layout]`` is every rank's
    results at ``layout``, ``ref[layout]`` the one-rank steps and JAX's."""
    folder = tmp_path_factory.mktemp("torch_sp")
    cfg = tiny_otpose_cfg()
    model, jspec, params, state, x, margin, inputs = _eval_weights(folder, cfg, jax_tiny_cfg(),
                                                                   "even")
    cfg_path = str(folder / "cfg.yaml")
    with open(cfg_path, "w") as fh:
        fh.write(cfg.dump())
    ucfg = tiny_otpose_cfg(image_size=32, heatmap_size=8)
    ujcfg = jax_tiny_cfg(image_size=32, heatmap_size=8)
    umodel, ujspec, uparams, ustate, ux, umargin, uinputs = _eval_weights(folder, ucfg, ujcfg,
                                                                          "uneven")
    ucfg_path = str(folder / "cfg_uneven.yaml")
    with open(ucfg_path, "w") as fh:
        fh.write(ucfg.dump())
    dirs = make_synthetic_posetrack(str(folder / "tree"), num_videos=1, frames_per_video=3,
                                    people_per_frame=3, img_w=96, img_h=96, seed=4)
    torch.save({"state_dict": model.state_dict()}, str(folder / "weights.pth"))
    cli = {mesh: _eval_cli_cfg(folder, dirs, mesh) for mesh in ("seq", "one")}
    common = {"encoders": ENCODERS, "primitive_lengths": list(PRIMITIVE_LENGTHS)}
    launches = {LAYOUTS: _launch("seq_eval", {
        **common, "cfg": cfg_path, "inputs": inputs, "layouts": [list(lay) for lay in LAYOUTS],
        "cli": {"cfg": cli["seq"], "root": str(folder)}, "out": str(folder / "even_%d.pt")},
        str(folder / "even.json"), world=4)}
    for lay in UNEVEN:
        tag = layout_id(lay)
        launches[(lay,)] = _launch("seq_eval", {
            **common, "cfg": ucfg_path, "inputs": uinputs, "layouts": [list(lay)],
            "out": str(folder / f"{tag}_%d.pt")}, str(folder / f"{tag}.json"),
            world=lay[0] * lay[1])

    def one_rank(m, x, margin):
        tx, tm = torch.from_numpy(x), torch.from_numpy(margin)
        return {"decoded": [a.numpy() for a in make_decoded_eval_step(m)(tx, tm)],
                "heatmap": [a.numpy() for a in make_eval_step(m)(tx, tm)],
                "flip": [a.numpy() for a in make_flip_eval_step(m)(tx, tm)]}

    ref = {}
    even = dict(model=model, one=one_rank(model, x, margin),
                jax=_jax_steps(jspec, jax_tiny_cfg(), params, state, x, margin, (2, 4)))
    uone = one_rank(umodel, ux, umargin)
    for lay in LAYOUTS:
        ref[lay] = even
    for lay in UNEVEN:
        ref[lay] = dict(model=umodel, one=uone,
                        jax=_jax_steps(ujspec, ujcfg, uparams, ustate, ux, umargin, lay),
                        encoders={n: _jax_encoder(n, lay) for n in WINDOWED + ("empty_rank",)})
    (_, name_values, mean_ap), = Eval(
        "validate", default_parse_args(["--cfg", cli["one"], "--root_dir", str(folder)]),
        device="cpu", dataset_cls=ArrayFramesDataset).eval()
    runs = {}
    for layouts, procs in launches.items():
        _wait(procs, timeout=300)
        tag = "even" if layouts == LAYOUTS else layout_id(layouts[0])
        ranks = [torch.load(str(folder / f"{tag}_{r}.pt"), weights_only=False)
                 for r in range(len(procs))]
        for lay in layouts:
            runs[lay] = [r["results"][tuple(lay)] for r in ranks]
        if layouts == LAYOUTS:
            runs["cli"] = [r["results"]["cli"] for r in ranks]
    return dict(runs=runs, ref=ref, cli=(name_values, mean_ap))


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
    return sp["runs"][layout][:layout[1]]


# ---------------------------------------------------------------- primitives

def _reference(name, inputs, gys, bounds):
    """The unsharded op's per-rank outputs and its leaves' gradients for the
    loss ``sum over the ranks of (output_r * gy_r)`` (one replicated
    ``(output * gy)`` for ``gather``), in f64."""
    full, w, q, k = (inputs[n].clone().requires_grad_() for n in ("full", "w", "q", "k"))

    def local(y, stride=1):
        """Each rank's slice of an output of length ceil(t / stride)."""
        return [y[..., -(-lo // stride):-(-hi // stride)] for lo, hi in bounds]

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
    else:           # halo_w, halo_wide: 3 or 20 tokens a side on the (B, nh, hs, T) map
        n = 3 if name == "halo_w" else 20
        win = torch.from_numpy(np.random.RandomState(5).randn(*q.shape)).requires_grad_()
        padded = torch.nn.functional.pad(win, (n, n))
        ys, leaves = [padded[..., lo:hi + 2 * n] for lo, hi in bounds], [win]
    if name == "gather":
        loss = (ys[0] * gys[0]).sum()
    else:
        loss = sum((y * gy).sum() for y, gy in zip(ys, gys))
    loss.backward()
    return [y.detach() for y in ys], [v.grad for v in leaves]


@pytest.mark.parametrize("t", PRIMITIVE_LENGTHS)
@pytest.mark.parametrize("layout", LAYOUTS + UNEVEN, ids=layout_id)
@pytest.mark.parametrize("name", PRIMITIVES)
def test_primitive_equals_the_unsharded_op_in_f64(sp, layout, name, t):
    ranks = [r["primitives"][t] for r in _seq_ranks(sp, layout)]
    bounds = [r["bounds"] for r in ranks]
    assert [hi - lo for lo, hi in bounds] == list(ranks[0]["lengths"])
    assert bounds[-1][1] == t
    # equal slices where the split allows them, else unequal ones
    assert (len(set(ranks[0]["lengths"])) == 1) == (t % (2 * layout[1]) == 0)
    got = [r["out"][name] for r in ranks]
    ys, grads = _reference(name, ranks[0]["inputs"], [g["gy"] for g in got], bounds)
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
        other = sp["runs"][layout][layout[1]]["primitives"][t]["out"][name]
        assert torch.equal(other["y"], got[0]["y"])


# ---------------------------------------------------------------- encoder

def _encoder(kw):
    spec = ConvTransformerSpec(**{**{k: v for k, v in kw.items() if k != "hw"},
                                  "arch": tuple(kw["arch"]),
                                  "mha_win_size": tuple(kw["mha_win_size"])})
    enc = ConvTransformer(spec)
    init_conv_transformer_(enc, torch.Generator().manual_seed(kw["n_in"]))
    return enc.eval()


def _encoder_input(kw):
    """The workers' input of an encoder: (2, 8, H, W), seeded."""
    return torch.from_numpy(np.random.RandomState(11).randn(2, kw["n_in"], *kw["hw"])
                            .astype(np.float32))


@pytest.mark.parametrize("layout", LAYOUTS + UNEVEN, ids=layout_id)
@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_encoder_equals_the_one_rank_forward(sp, layout, name):
    """The gathered outputs to 1e-6 of the peak (f32); the f64 gradients
    (the blocks' summed over the seq group, the embedding's whole on each
    rank) to 1e-5 of each tensor's peak (the LNs' statistics and the PE add
    round through f32), or 1e-6 of the largest gradient's peak for a tensor
    whose gradient is zero but for rounding (a window block's key bias
    shifts every score of a query alike)."""
    enc = _encoder(ENCODERS[name])
    x = _encoder_input(ENCODERS[name])
    with torch.no_grad():
        want = enc(x)
    ranks = _seq_ranks(sp, layout)
    for r in ranks:
        got = r["encoders"][name]["feats"]
        assert len(got) == len(want) == 1 + ENCODERS[name]["arch"][2]
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

@pytest.mark.parametrize("layout", LAYOUTS + UNEVEN, ids=layout_id)
@pytest.mark.parametrize("step", ["decoded", "heatmap", "flip"])
def test_eval_step_equals_the_one_rank_step(sp, layout, step):
    ref = sp["ref"][layout]
    want = ref["one"][step]
    for res in sp["runs"][layout]:
        got = res[step]
        assert got["sharded"] and got["rows"] == 4 // layout[0]
        assert got["calls"] == {"fused_attn": 0, "fused_mlp": 0,
                                "deform_conv": 2 if step == "flip" else 1}
        forwards = 2 if step == "flip" else 1
        assert got["collectives"]["seq"] == forwards * seq_collectives_a_forward(
            ref["model"].spec)
        assert got["collectives"]["device"] == 0
        if step == "decoded":
            coords, maxvals, raw = got["out"]
            heat = ref["one"]["heatmap"][0]
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


@pytest.mark.parametrize("layout", LAYOUTS + UNEVEN, ids=layout_id)
def test_eval_matches_jax_s_seq_sharded_step(sp, layout):
    """Against JAX's ``seq_axis`` steps on a mesh of the same shape: within
    the 7-tuple bar (1e-3 of the peak) at T = 256, within 1e-5 of the peak
    at T = 64, where the peak is O(10)."""
    bar = 1e-3 if layout in LAYOUTS else 1e-5
    jax_out = sp["ref"][layout]["jax"]
    res = sp["runs"][layout][0]
    for g, w in zip(res["heatmap"]["out"], jax_out["heatmap"]):
        assert g.shape == w.shape and np.isfinite(w).all()
        peak = np.abs(w).max()
        assert peak > 1
        np.testing.assert_allclose(g / peak, w / peak, rtol=0, atol=bar)
    coords, maxvals, raw = res["decoded"]["out"]
    jc, jm, jr = jax_out["decoded"]
    heat = jax_out["heatmap"][0]
    flat = np.sort(heat.transpose(0, 3, 1, 2).reshape(4, 17, -1), axis=-1)
    # PR 14's absolute gap for the even layouts; 1e-5 of the peak at T = 64.
    thr = 1e-3 if layout in LAYOUTS else bar * np.abs(heat).max()
    clear = (flat[..., -1] - flat[..., -2]) > thr
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(coords[clear], jc[clear])
    np.testing.assert_array_equal(raw[clear], jr[clear])
    peak = np.abs(jm).max()
    np.testing.assert_allclose(maxvals / peak, jm / peak, rtol=0, atol=bar)


def _against_jax_encoder(sp, layout, name):
    """Every rank's gathered outputs of encoder ``name`` against JAX's
    ``seq_axis`` forward, to 1e-5 of each output's peak."""
    want = sp["ref"][layout]["encoders"][name]
    for res in sp["runs"][layout]:
        got = res["encoders"][name]["feats"]
        assert len(got) == len(want) == 1 + ENCODERS[name]["arch"][2]
        for g, w in zip(got, want):
            assert g.shape == w.shape
            peak = np.abs(w).max()
            np.testing.assert_allclose(g.numpy() / peak, w / peak, rtol=0, atol=1e-5)


@pytest.mark.parametrize("layout", UNEVEN, ids=layout_id)
def test_window_encoder_matches_jax_s_seq_sharded_forward(sp, layout):
    """The window encoder (window 5, ``rel_pe``) at T = 256 over three seq
    ranks (slices of 86, 86 and 84 tokens, 43, 43 and 42 after the branch)
    against JAX's ``conv_transformer_forward`` with ``seq_axis`` on a mesh
    of the same shape, to 1e-5 of each output's peak."""
    _against_jax_encoder(sp, layout, "window")


@pytest.mark.parametrize("layout", UNEVEN, ids=layout_id)
@pytest.mark.parametrize("name", ["empty_rank", "wide_window", "wide_empty"])
def test_the_splits_jax_pads_match_jax_s_seq_sharded_forward(sp, layout, name):
    """The two splits that JAX's partitioner pads (a rank with no token at
    the deepest level, a halo wider than a slice), against JAX's
    ``seq_axis`` forward on three seq ranks, to 1e-5 of each output's peak:
    T = 4 at stride 2 (slices 2, 2 and 0, then 1, 1 and
    0: a rank with no token at the deepest level, which joins every
    collective all the same); window 9 at T = 16 (4 halo tokens a side on
    branch slices of 3, 3 and 2: taken from two neighbours); window 9 at
    T = 8 with two branch levels (slices 4, 4, 0, then 2, 2, 0 and 1, 1,
    0: both at once)."""
    lengths = sequence.split_lengths(int(np.prod(ENCODERS[name]["hw"])), 3,
                                     2 ** ENCODERS[name]["arch"][2])
    if name == "wide_window":
        assert min(lengths) // 2 < ENCODERS[name]["mha_win_size"][0] // 2
    else:
        assert lengths[-1] == 0
    _against_jax_encoder(sp, layout, name)


def test_eval_cli_on_a_seq_mesh_gives_the_one_process_table(sp):
    name_values, mean_ap = sp["cli"]
    assert mean_ap > 0
    for r, got in enumerate(sp["runs"]["cli"]):
        assert got["batch"] == 4 and got["seq"] == (r % 2, 2)
        assert got["mean_ap"] == pytest.approx(mean_ap, abs=1e-9)
    got = sp["runs"]["cli"][0]["name_values"]
    np.testing.assert_allclose([got[k] for k in AP_KEYS], [name_values[k] for k in AP_KEYS],
                               rtol=0, atol=1e-9)


# ---------------------------------------------------------------- layout

@pytest.mark.parametrize("layout", LAYOUTS + UNEVEN, ids=layout_id)
def test_ranks_sit_row_major_and_load_their_data_group_s_rows(sp, layout):
    d, s = layout
    assert len(sp["runs"][layout]) == d * s
    for r, res in enumerate(sp["runs"][layout]):
        assert res["seq"] == (r % s, s) and res["data"] == (r // s, d)
        per = 8 // d
        assert res["loader_rows"] == list(range((r // s) * per, (r // s + 1) * per))
        assert res["fetch"] == list(range(d))       # each data group's row once


@pytest.mark.parametrize("layout", LAYOUTS + UNEVEN, ids=layout_id)
def test_train_bn_counts_each_row_once(sp, layout):
    """The data group's statistics, and the running variance's Bessel
    factor n / (n - 1) with n the global batch's count, not the ranks'."""
    res = sp["runs"][layout][0]["bn"]
    x = res["x"]
    n = x.numel() // x.shape[1]
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False) * n / (n - 1)
    for run in sp["runs"][layout]:
        got = run["bn"]
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
    one = sequence.SeqGroup(1, 0).split(6)
    assert one.lengths == (6,) and one.bounds() == (0, 6)
    x = torch.randn(1, 2, 6)
    assert torch.equal(sequence.gather_tokens(sequence.shard_tokens(x, one), one), x)
    # a halo wider than the slice: fill past T's ends
    assert torch.equal(sequence.halo(x, 7, 2, one, fill=-1.0),
                       torch.nn.functional.pad(x, (7, 2), value=-1.0))


@pytest.mark.parametrize("t,size,stride,lengths", [
    (256, 4, 2, (64, 64, 64, 64)),              # the even layouts' T: the old equal split
    (6912, 4, 4, (1728,) * 4),                  # the flagship's T on 4 ranks
    (6912, 5, 4, (1384, 1384, 1384, 1380, 1380)),
    (6912, 7, 4, (988,) * 6 + (984,)),
    (64, 3, 2, (22, 22, 20)),
    (256, 3, 2, (86, 86, 84)),
    (256, 3, 1, (86, 85, 85)),
    (49, 4, 2, (14, 12, 12, 11)),               # the last unit short: T odd
    (6920, 4, 4, (1732, 1732, 1728, 1728)),
    (4, 3, 2, (2, 2, 0)),                       # fewer units than ranks: empty slices
    (4, 4, 2, (2, 2, 0, 0)),
    (7, 5, 2, (2, 2, 2, 1, 0)),                 # the last unit short, before an empty slice
    (10, 4, 4, (4, 4, 2, 0)),
])
def test_the_split_cuts_units_of_the_stride(t, size, stride, lengths):
    """``units // size`` units of ``stride`` tokens a rank, one more for the
    first ``units % size`` ranks, the last unit's rank ending at T and the
    ranks past it empty; ``down`` divides every boundary by a block's
    stride (the last rounded up, as the strided conv and max-pool give
    ceil(T / 2) outputs), and keeps the empty slices empty."""
    assert sequence.split_lengths(t, size, stride) == lengths
    groups = [sequence.SeqGroup(size, i).split(t, stride) for i in range(size)]
    bounds = [g.bounds() for g in groups]
    assert bounds[0][0] == 0 and bounds[-1][1] == t and groups[0].total == t
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(lo % stride == 0 or lo == t for lo, _ in bounds)
    down = groups[0]
    while stride > 1:
        down, stride = down.down(2), stride // 2
        assert down.total == -(-t // 2)
        assert [n > 0 for n in down.lengths] == [n > 0 for n in lengths]
        t = down.total


def test_an_uneven_shard_raises_in_the_forward():
    """Unequal slices run, and so does a split that leaves a rank no
    token at the encoder's deepest level (that rank holds empty
    slices: ``test_the_splits_jax_pads_match_jax_s_seq_sharded_forward``);
    what still raises in the forward is a slice of another length than its
    split's, before any exchange, with the condition named."""
    enc = _encoder(ENCODERS["global"])
    assert sequence.split_lengths(4, 3, 2) == (2, 2, 0)
    assert sequence.split_lengths(6912, 1729, 4) == (4,) * 1728 + (0,)
    assert sequence.split_lengths(6912, 1728, 4) == (4,) * 1728
    with pytest.raises(ValueError, match=r"slice has 3 tokens, its split \(2, 2, 0\) gives "
                                         "it 0"):
        enc.stem[0](torch.randn(1, 8, 3), seq=sequence.SeqGroup(3, 2).split(4, 2))


def test_the_remaining_refusals_name_their_condition():
    """A block stride that an interior boundary does not divide, a slice
    whose length is not its split's (before an exchange), and a group used
    before its split.  A halo wider than a slice is not refused: it takes
    its tokens from as many slices as it spans (``halo_wide``,
    ``wide_window``)."""
    group = sequence.SeqGroup(3, 0).split(64, 2)                # 22, 22, 20
    with pytest.raises(ValueError, match="multiple of 4"):
        group.down(4)
    with pytest.raises(ValueError, match="slice has 21 tokens"):
        sequence.gather_tokens(torch.randn(1, 2, 21), group)
    with pytest.raises(ValueError, match="slice has 20 tokens"):
        sequence.halo(torch.randn(1, 2, 20), 1, 1, group)
    with pytest.raises(ValueError, match="after SeqGroup.split"):
        sequence.SeqGroup(3, 0).bounds()


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
                                      sequence.SeqGroup(2, index).split(8)))
    assert torch.equal(torch.cat(parts, dim=-1), whole)
    y = torch.randn(2, 2, 8, 5)
    gen.manual_seed(4)
    with core.use_generator(gen):
        whole = core.dropout(y, 0.5, True)
    gen.manual_seed(4)
    with core.use_generator(gen):
        part = core.dropout(y[:, :, 4:], 0.5, True, sequence.SeqGroup(2, 1).split(8), dim=2)
    assert torch.equal(part, whole[:, :, 4:])
    # unequal slices: 22, 22 and 20 tokens of 64
    z = torch.randn(2, 3, 64)
    gen.manual_seed(4)
    with core.use_generator(gen):
        whole = core.dropout(z, 0.5, True)
    parts = []
    for index in range(3):
        group = sequence.SeqGroup(3, index).split(64, 2)
        lo, hi = group.bounds()
        gen.manual_seed(4)
        with core.use_generator(gen):
            parts.append(core.dropout(z[..., lo:hi], 0.5, True, group))
    assert [p.shape[-1] for p in parts] == [22, 22, 20]
    assert torch.equal(torch.cat(parts, dim=-1), whole)
    # an empty slice: T = 4 at stride 2 on three ranks is 2, 2 and 0 tokens
    w4 = torch.randn(2, 3, 4)
    gen.manual_seed(4)
    with core.use_generator(gen):
        whole = core.dropout(w4, 0.5, True)
    parts = []
    for index in range(3):
        group = sequence.SeqGroup(3, index).split(4, 2)
        lo, hi = group.bounds()
        gen.manual_seed(4)
        with core.use_generator(gen):
            parts.append(core.dropout(w4[..., lo:hi], 0.5, True, group))
    assert [p.shape[-1] for p in parts] == [2, 2, 0]
    assert torch.equal(torch.cat(parts, dim=-1), whole)
