"""The frozen reference against the port's plain path on the tiny spec on
the CPU, in float32: the forward, and three train steps from the same
weights, batches and dropout seeds.  (This test imports both; the
reference imports nothing of the port.)"""

from __future__ import annotations

import pytest
import torch

from portbench import compare, program, weights
from portbench.kinds import train_steps
from portbench.reference import model as ref_model
from portbench.tests.tiny import tiny_config, tiny_files


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("joints", [17, 21])
def test_forward_equals_the_ports_plain_path(joints):
    from otpose_tpu_torch.models.otpose import otpose_forward

    config = tiny_config(joints)
    cfg = config["cfg"]
    ref = weights.make_reference(cfg, 5, "cpu")
    model = program.build(config, ref.state_dict(), "cpu").eval()
    x, m = weights.clips(cfg, 2, weights.generator(5, "clips", "cpu"), "cpu")
    with torch.no_grad():
        got = otpose_forward(model, x, m, fused=False)
        want = ref_model.forward(ref, x, m)
    # output, rough heatmaps, intersection, context encoding
    for g, w in zip((got[0], got[1], got[2], got[4]), want):
        g = g.permute(0, 3, 1, 2)
        assert g.shape == w.shape
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()


def test_decode_equals_the_ports():
    from otpose_tpu_torch.ops.heatmap import get_max_preds_device, refine_coords_device

    from portbench.reference.train import decode

    heat = torch.randn(3, 5, 16, 12, generator=torch.Generator().manual_seed(0))
    heat[0, 0] = -1.0                                  # no positive maximum
    coords, maxvals, raw = decode(heat)
    want_coords, want_max = refine_coords_device(heat)
    assert torch.equal(coords, want_coords) and torch.equal(maxvals, want_max)
    assert torch.equal(raw, get_max_preds_device(heat)[0])


def test_train_steps_equal_the_ports():
    files = tiny_files("posetrack_train_b8", dtype="float32")
    cfg, tr = files["config"]["cfg"], files["traffic"]
    dev = torch.device("cpu")
    ref = weights.make_reference(cfg, 9, dev)
    state = {k: v.clone() for k, v in ref.state_dict().items()}
    model = program.build(files["config"], state, dev)
    gen = torch.Generator()
    start = tr["start_epoch"] * tr["iters_per_epoch"]
    step, opt = program.train_step(model, files["config"], "float32", tr["iters_per_epoch"],
                                   start, gen)
    ring = train_steps.batches(cfg, tr, 9, dev)
    seeds = train_steps.step_seeds(tr, 9, 0, 3)
    got = train_steps.first_steps(step, opt, model, ring, seeds, gen)
    want = train_steps.reference_steps(state, cfg, tr, ring, seeds, dev)
    numbers = compare.train_numbers(got, want)
    # the same float32 arithmetic but for summation orders; dropout masks drawn alike
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-3
    assert numbers["change_gap_median"] < 1e-3
