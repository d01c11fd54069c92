"""The eval steps' HRNet as one CUDA graph replay (``engine/graphs.py``) on
the card, at 17 and 133 joints on small clips, bf16:

- the graphed decoded step's outputs, and ``make_eval_step``'s heatmaps and
  teacher, bit-equal to the eager step's over a ring of distinct batches
  (eager, capture, replays);
- ``make_eval_step``'s and ``make_flip_eval_step``'s teachers of call n
  intact after call n + 1;
- weights replaced between calls (``prepare_eval_params``) give the new
  weights' outputs;
- CUDA's sync debug mode, set to raise, sees no synchronisation in an eager
  or a replayed decoded step (the capture synchronises once by design);
- the plain attention's host-made scale bit-equal to the 0-d device tensor
  it replaced, in bf16 and f32.

Needs a CUDA device; skips elsewhere.  On a machine with the card (which
need not have JAX), run without the repository's conftest:

    python -m pytest tests/test_torch_cuda_graph.py -q -m cuda --noconftest
"""

import math

import pytest
import torch

from otpose_tpu_torch.engine import graphs
from otpose_tpu_torch.engine.runner import make_flip_eval_step
from otpose_tpu_torch.engine.trainer import make_decoded_eval_step, make_eval_step
from otpose_tpu_torch.ops.cuda import fused_attn
from otpose_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda
COUNTERS = ("hrnet_graph.eager", "hrnet_graph.captures", "hrnet_graph.replays")


@pytest.fixture(autouse=True)
def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph captures CUDA work")


def _model(joints, dtype=torch.bfloat16, seed=2):
    from otpose_tpu_torch.models.factory import build_model
    from otpose_tpu_torch.models.otpose import prepare_eval_params
    from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

    _, model = build_model(tiny_otpose_cfg(num_joints=joints), seed=seed)
    with torch.no_grad():           # heatmaps far from flat, so the argmax means something
        for p in model.rough_pose_estimation_net.parameters():
            if p.dim() == 4:
                p.normal_(0, 1 / math.sqrt(p[0].numel()))
    return prepare_eval_params(model, dtype if dtype == torch.bfloat16 else None)


def _ring(n, b=2, seed=3):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [(torch.randn(b, 64, 64, 15, generator=gen, device="cuda"),
             torch.rand(b, 4, generator=gen, device="cuda") * 3) for _ in range(n)]


def _growth(before):
    grown = profiling.since(before)
    return tuple(grown.get(k, 0) for k in COUNTERS)


def _eager(make, model, **kw):
    """``make``'s step with the runner kept off the card."""
    step = make(model, **kw)

    def run(*args):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(graphs, "on_card", lambda t: False)
            return step(*args)

    return run


def _bits_equal(got, want):
    return all(g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("joints", [17, 133])
@pytest.mark.parametrize("make", [make_decoded_eval_step, make_eval_step])
def test_the_graphed_step_is_bit_equal_to_the_eager_one(joints, make):
    model = _model(joints)
    ring = _ring(3)
    kw = {"compute_dtype": torch.bfloat16}
    step = make(model, **kw)
    before = profiling.counters()
    got = [tuple(t.clone() for t in step(*ring[i % 3])) for i in range(7)]
    torch.cuda.synchronize()
    assert _growth(before) == (1, 1, 6)
    eager = _eager(make, model, **kw)
    want = [eager(*ring[i % 3]) for i in range(7)]
    assert all(_bits_equal(g, w) for g, w in zip(got, want))
    assert not _bits_equal(got[0], got[1])          # the ring's batches differ


@pytest.mark.parametrize("joints", [17, 133])
@pytest.mark.parametrize("make", [make_eval_step, make_flip_eval_step])
def test_a_teacher_is_intact_after_the_next_call(joints, make):
    model = _model(joints)
    ring = _ring(3)
    step = make(model, compute_dtype=torch.bfloat16)
    got = [step(*ring[i % 3]) for i in range(6)]    # eager (flip: then capture), replays
    eager = _eager(make, model, compute_dtype=torch.bfloat16)
    for i, (heat, teacher) in enumerate(got):
        heat_w, teacher_w = eager(*ring[i % 3])
        assert torch.equal(heat, heat_w) and torch.equal(teacher, teacher_w), i


@pytest.mark.parametrize("joints", [17, 133])
def test_replaced_weights_give_the_new_weights_outputs(joints):
    from otpose_tpu_torch.models.otpose import prepare_eval_params

    model = _model(joints, dtype=torch.float32)
    x, m = _ring(1)[0]
    step = make_decoded_eval_step(model)
    old = [step(x, m) for _ in range(3)]
    prepare_eval_params(model, torch.bfloat16)      # every conv weight: a new bf16 tensor
    before = profiling.counters()
    got = [step(x, m) for _ in range(3)]
    torch.cuda.synchronize()
    assert _growth(before) == (1, 1, 2)
    want = _eager(make_decoded_eval_step, model)(x, m)
    assert all(_bits_equal(g, want) for g in got)
    assert not _bits_equal(old[2], want)


@pytest.mark.parametrize("joints", [17, 133])
@pytest.mark.parametrize("flip", [False, True])
def test_a_decoded_step_does_not_synchronise(joints, flip):
    model = _model(joints)
    ring = _ring(2)
    step = make_decoded_eval_step(model, compute_dtype=torch.bfloat16, flip=flip)
    step(*_ring(1, b=1)[0])     # another shape: the kernels' builds and weight packs
    mode = torch.cuda.get_sync_debug_mode()
    for i in range(4):
        if i != int(not flip):      # the call that captures waits by design
            torch.cuda.set_sync_debug_mode("error")
        try:
            step(*ring[i % 2])
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_head,hs", [(2, 68), (2, 532), (1, 17)])
def test_the_attention_scale_is_bit_equal_on_the_card(monkeypatch, dtype, n_head, hs):
    gen = torch.Generator(device="cuda").manual_seed(hs)
    q, k, v = (torch.randn(3, 2, n_head * hs, 577, generator=gen, device="cuda") * 2
               ).to(dtype).unbind(0)
    got = fused_attn.channel_attention_ct(q, k, v, n_head)
    monkeypatch.setattr(fused_attn, "attention_scale",
                        lambda hs, dt: q.new_tensor(1.0 / math.sqrt(hs)))
    want = fused_attn.channel_attention_ct(q, k, v, n_head)
    assert torch.equal(got, want)
