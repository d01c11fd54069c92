"""The ViTPose cell (``kinds/eval_vitpose.py``) on the CPU at a tiny size:
width 64, depth 2, 4 heads, a 64x48 crop, 16x12 heatmaps, the tiny head of
``tiny.py``.  A sound run is correct and reads its metrics; the mirrored
answer is not; the benchmark's reference copy agrees with the repository's
plain reference (``tests/helpers/plain_vitpose.py``); the counts and the
replayed kernels' parse."""

from __future__ import annotations

import collections
import copy
import json

import pytest
import torch

from portbench import compare, control, harness, program, weights
from portbench.counts import vit
from portbench.kinds import eval_vitpose
from portbench.reference import model as ref_model
from portbench.tests.tiny import TINY_MODEL

SEED = 2 ** 31 + 4321
CPU = torch.device("cpu")
CELL = "vitpose_h_eval_b30"


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _own_records(monkeypatch):
    """The program's step records of this test's run alone: the ring is the
    process's, and other tests' runs leave theirs in it."""
    from otpose_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=profiling.RING))


def tiny_vit_config() -> dict:
    config = harness.load_json(harness.PACKAGE / "configs" / "otpose_vitpose_h_posetrack.json")
    m = config["cfg"]["MODEL"]
    m.update(copy.deepcopy(TINY_MODEL), IMAGE_SIZE=[48, 64], HEATMAP_SIZE=[12, 16])
    m["EXTRA"].update(SCALE_ARCH=[0, 2, 1], FLOW_SCALE_ARCH=[0, 2, 0])
    m["EXTRA"]["VIT"].update(EMBED_DIM=64, DEPTH=2, NUM_HEADS=4, NUM_DECONV_FILTERS=[32, 32])
    return config


def _files(**traffic) -> dict:
    files = harness.cell_files(harness.load_json(harness.SPEC), CELL)
    files["config"] = tiny_vit_config()
    files["traffic"] = dict(files["traffic"], batch=2, ring=2, warmup=1, trace_batches=2,
                            reference_rows=1, **traffic)
    return json.loads(json.dumps(files))


def _run(trace=False):
    # a window of several batches even on a loaded CPU: ``p90`` needs two
    cell = harness.run_cell(_files(), SEED, 2.0, trace, CPU)
    return cell, compare.judge(cell.numbers, cell.limits)[0]


@pytest.mark.parametrize("traced", [False, True])
def test_a_sound_run_is_correct_and_reads_its_metrics(traced, monkeypatch):
    monkeypatch.setattr(harness, "device_info", lambda cell: {"platform": "gpu"})
    cell, correct = _run(trace=traced)
    assert correct, cell.numbers
    out = harness.result(cell, trace=traced)
    assert out["correct"] and list(out)[-1] == "checks"
    if not traced:
        assert set(out["metrics"]) == {"eval_clips_per_s", "eval_batch_p90_ms", "setup_s"}
        return
    got = out["metrics"]
    assert got["vit_tokens_per_batch.eval"]["value"] == 2 * 5 * 4 * 3
    assert got["vit_host_ms_per_batch.eval"]["value"] > 0
    assert got["vit_mfu.eval"]["value"] > 0
    # no device on the CPU, so no graph replay: its readers stay silent
    assert "vit_matmul_roofline.eval" not in got and "vit_attention_roofline.eval" not in got
    assert "hrnet_host_ms_per_batch.eval" not in got and "mfu.eval" not in got


def test_the_mirrored_answer_is_not_correct(monkeypatch):
    make = program.eval_step

    def altered(model, dtype):
        step = make(model, dtype)

        def run(inputs, margin):
            return control.mirrored(step(inputs, margin), model.spec.pe_w)
        return run

    monkeypatch.setattr(program, "eval_step", altered)
    assert not _run()[1]


def test_the_benchmark_copy_equals_the_plain_reference():
    from tests.helpers import plain_vitpose

    cfg = tiny_vit_config()["cfg"]
    ref = eval_vitpose.make_reference(cfg, SEED, "cpu", center=True)
    plain = plain_vitpose.PlainOTPose(cfg)
    plain.load_state_dict(ref.state_dict(), strict=True)
    x, m = weights.clips(cfg, 2, weights.generator(SEED, "clips", "cpu"), "cpu")
    with torch.no_grad():
        want = plain_vitpose.forward7(plain.eval(), x, m)
        got = ref_model.forward(ref.eval(), x, m)
    for g, w in zip(got, (want[0], want[1], want[2], want[4])):
        w = w.permute(0, 3, 1, 2)
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()


def test_counts_at_vitpose_h():
    cfg = harness.load_json(harness.PACKAGE / "configs" / "otpose_vitpose_h_posetrack.json")["cfg"]
    assert vit.product_flops(cfg, 1) == 2 * 32 * 12 * 1280 ** 2 * 192
    work = vit.attention(cfg, 150)
    assert work.bytes == 4 * 192 * 1280 * 2 * 32 * 150
    assert work.product_ops == 4 * 192 ** 2 * 1280 * 32 * 150
    assert work.least_s() == work.bytes / 3.35e12            # bound by bytes


def test_replayed_keeps_the_graph_launchs_kernels_in_the_window():
    def x(name, cat, ts, dur, corr):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
                "args": {"correlation": corr}}

    events = [x("cudaGraphLaunch", "cuda_runtime", 10, 1, 7),
              x("cudaLaunchKernel", "cuda_runtime", 12, 1, 8),
              x("nvjet_tst_128x256", "kernel", 20, 5, 7),
              x("pytorch_flash::flash_fwd_kernel", "kernel", 26, 2, 7),
              x("vectorized_elementwise_kernel", "kernel", 30, 1, 8),
              x("nvjet_tst_128x256", "kernel", 200, 5, 7)]
    kernels = eval_vitpose.replayed(events, (0, 100))
    assert [k[0] for k in kernels] == ["nvjet_tst_128x256", "pytorch_flash::flash_fwd_kernel"]

    class Cell:
        reading = {"replayed": kernels}

    assert eval_vitpose.replayed_s(Cell, eval_vitpose.PRODUCT_KEYS,
                                   eval_vitpose.NOT_PRODUCT_KEYS) == pytest.approx(5e-6)
    assert eval_vitpose.replayed_s(Cell, eval_vitpose.ATTENTION_KEYS) == pytest.approx(2e-6)
