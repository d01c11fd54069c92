"""The eval steps' HRNet runner (``otpose_tpu_torch/engine/graphs.py``) and
the plain attention's host-made scale, on the CPU.

The runner's policy with a stand-in for ``torch.cuda.CUDAGraph`` (its
capture runs HRNet on the input buffer into the output buffer, its replay
runs it again into the same buffer, so a replay overwrites what the last
one returned, as on the card) and the card's test patched to say yes:

- a repeated shape runs eagerly, then captures and replays, then replays,
  and the decoded outputs equal the eager step's over a ring of batches;
- another shape runs eagerly and keeps the graph;
- weights replaced by ``prepare_eval_params`` capture anew, weights
  updated in place are read by the replay as they are;
- nothing is captured in train mode, outside ``inference_mode``, off the
  card, or under ``seq`` (where the steps make no runner);
- ``make_eval_step``'s and ``make_flip_eval_step``'s teachers stay intact
  after the next call's replay;
- the ``hrnet_graph.*`` counters' growth in each case.

``attention_scale`` against the 0-d tensor it replaces (``q.new_tensor``):
the same value and, in ``channel_attention_ct``, the same bits in bf16 and
f32, with and without the sequence-parallel reduction, over several head
sizes.
"""

import math

import pytest
import torch

from otpose_tpu_torch.engine import graphs, runner, trainer
from otpose_tpu_torch.engine.runner import make_flip_eval_step
from otpose_tpu_torch.engine.trainer import make_decoded_eval_step, make_eval_step
from otpose_tpu_torch.models.factory import build_model
from otpose_tpu_torch.models.otpose import prepare_eval_params
from otpose_tpu_torch.ops.cuda import fused_attn
from otpose_tpu_torch.utils import profiling
from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

from tests.helpers.torch_port import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
COUNTERS = ("hrnet_graph.eager", "hrnet_graph.captures", "hrnet_graph.replays")


class StandInGraph:
    """What the runner asks of a ``torch.cuda.CUDAGraph``: ``replay()``
    computes the captured function of the input buffer into the output
    buffer."""

    def __init__(self, fn, frames, out):
        self.fn, self.frames, self.out = fn, frames, out

    def replay(self):
        self.out.copy_(self.fn(self.frames))


def stand_in_capture(fn, frames):
    out = fn(frames)
    return StandInGraph(fn, frames, out), out


@pytest.fixture
def card(monkeypatch):
    """The runner on the CPU as on the card: every tensor passes its test
    and captures make stand-in graphs."""
    monkeypatch.setattr(graphs, "on_card", lambda t: True)
    monkeypatch.setattr(graphs, "capture", stand_in_capture)


def _model(seed=0):
    _, model = build_model(tiny_otpose_cfg(), seed=seed, device="cpu")
    return model


def _batches(n, b=2, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return [(torch.randn(b, 64, 64, 15, generator=gen), torch.rand(b, 4, generator=gen) * 3)
            for _ in range(n)]


def _growth(before):
    grown = profiling.since(before)
    return tuple(grown.get(k, 0) for k in COUNTERS)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_a_repeated_shape_runs_eagerly_then_captures_then_replays(card):
    model = _model()
    step = make_decoded_eval_step(model)
    ring = _batches(3)
    before = profiling.counters()
    got = [step(*ring[i % 3]) for i in range(7)]
    assert _growth(before) == (1, 1, 6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "on_card", lambda t: False)
        eager = make_decoded_eval_step(model)
        want = [eager(*ring[i % 3]) for i in range(7)]
    assert all(_equal(g, w) for g, w in zip(got, want))


def test_another_shape_runs_eagerly_and_keeps_the_graph(card):
    step = make_decoded_eval_step(_model())
    full, part = _batches(1, b=2)[0], _batches(1, b=1)[0]
    expected = [(full, (1, 0, 0)), (full, (0, 1, 1)), (part, (1, 0, 0)), (full, (0, 0, 1)),
                (part, (1, 0, 0)), (full, (0, 0, 1)), (part, (1, 0, 0)), (part, (0, 1, 1)),
                (full, (1, 0, 0))]
    for batch, growth in expected:
        before = profiling.counters()
        step(*batch)
        assert _growth(before) == growth


def test_replaced_weights_are_captured_anew(card):
    model = _model()
    step = make_decoded_eval_step(model)
    x, m = _batches(1)[0]
    step(x, m)
    step(x, m)
    prepare_eval_params(model, torch.bfloat16)      # p.data = p.data.to(bf16)
    before = profiling.counters()
    got = [step(x, m) for _ in range(3)]
    assert _growth(before) == (1, 1, 2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "on_card", lambda t: False)
        want = make_decoded_eval_step(model)(x, m)
    assert all(_equal(g, want) for g in got)


def test_weights_updated_in_place_are_read_by_the_replay(card):
    model = _model()
    step = make_decoded_eval_step(model)
    x, m = _batches(1)[0]
    first = [step(x, m) for _ in range(2)]
    with torch.no_grad():
        for p in model.rough_pose_estimation_net.parameters():
            p.mul_(1.5)
    before = profiling.counters()
    got = step(x, m)
    assert _growth(before) == (0, 0, 1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "on_card", lambda t: False)
        want = make_decoded_eval_step(model)(x, m)
    assert _equal(got, want) and not _equal(got, first[1])


@pytest.mark.parametrize("case", ["train mode", "no inference mode", "off the card"])
def test_nothing_is_captured(monkeypatch, case):
    model = _model()
    runner_ = graphs.BackboneGraph(model)
    frames = torch.randn(10, 3, 64, 64)
    if case != "off the card":
        monkeypatch.setattr(graphs, "on_card", lambda t: True)
    monkeypatch.setattr(graphs, "capture", lambda fn, f: pytest.fail("captured"))
    if case == "train mode":
        model.train()
    grad = torch.no_grad() if case == "no inference mode" else torch.inference_mode()
    before = profiling.counters()
    with grad:
        for _ in range(3):
            runner_(frames)
    assert _growth(before) == (3, 0, 0)


@pytest.mark.parametrize("make", [make_eval_step, make_flip_eval_step, make_decoded_eval_step])
def test_under_seq_the_steps_make_no_runner(monkeypatch, make):
    seen = []

    def forward(model, x, margin, **kw):
        seen.append(kw["backbone"])
        j = model.spec.num_joints
        out = torch.zeros(x.shape[0], 16, 16, j)
        return (out, torch.cat([out] * 5))

    monkeypatch.setattr(trainer, "otpose_forward", forward)
    monkeypatch.setattr(runner, "otpose_forward", forward)
    model = _model()
    x, m = _batches(1)[0]
    make(model, seq=object())(x, m)
    make(model)(x, m)
    n = len(seen) // 2
    assert seen[:n] == [None] * n
    assert all(isinstance(b, graphs.BackboneGraph) for b in seen[n:])


@pytest.mark.parametrize("make", [make_eval_step, make_flip_eval_step])
def test_a_teacher_is_intact_after_the_next_call(card, make):
    model = _model()
    ring = _batches(3)
    step = make(model)
    got = [step(*ring[i % 3]) for i in range(5)]        # eager, capture, replays
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "on_card", lambda t: False)
        eager = make(model)
        want = [eager(*ring[i % 3]) for i in range(5)]
    for (heat, teacher), (heat_w, teacher_w) in zip(got, want):
        assert torch.equal(heat, heat_w) and torch.equal(teacher, teacher_w)


def test_the_decoded_steps_forward_returns_no_teacher(card):
    model = _model()
    x, m = _batches(1)[0]
    for make in (make_eval_step, make_flip_eval_step):
        step = make(model, teacher=False)
        assert all(step(x, m)[1] is None for _ in range(3))


def _old_scale(monkeypatch):
    """``channel_attention_ct``'s scale as it was: a 0-d tensor of q's
    dtype (``q.new_tensor(1 / sqrt(hs))``)."""
    monkeypatch.setattr(fused_attn, "attention_scale",
                        lambda hs, dtype: torch.tensor(1.0 / math.sqrt(hs), dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hs", [1, 8, 17, 68, 133, 532])
def test_the_attention_scale_is_the_rounded_value(dtype, hs):
    want = torch.zeros((), dtype=dtype).new_tensor(1.0 / math.sqrt(hs))
    got = fused_attn.attention_scale(hs, dtype)
    assert isinstance(got, float) and got == want.item()
    assert torch.tensor(got, dtype=dtype).item() == got          # exact in dtype


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_head,hs", [(1, 17), (2, 68), (8, 17), (2, 133)])
@pytest.mark.parametrize("reduce", [False, True], ids=["whole", "reduced"])
def test_channel_attention_is_bit_equal_to_the_tensor_scale(monkeypatch, dtype, n_head, hs,
                                                            reduce):
    gen = torch.Generator().manual_seed(hs * n_head)
    c, t = n_head * hs, 97
    q, k, v = (torch.randn(3, c, t, generator=gen) * 2).to(dtype).unbind(0)
    q, k, v = q[None], k[None], v[None]
    red = (lambda s: s * 1.0) if reduce else None
    got = fused_attn.channel_attention_ct(q, k, v, n_head, reduce=red)
    _old_scale(monkeypatch)
    want = fused_attn.channel_attention_ct(q, k, v, n_head, reduce=red)
    assert got.dtype == want.dtype == dtype and torch.equal(got, want)
