"""The estimator of the eval steps as one CUDA graph replay.

``BackboneGraph(model)`` maps the (5B, 3, H, W) frames of
``models/otpose.py::otpose_forward`` to the estimator's rough heatmaps, as
``run_hrnet`` does.  HRNet is cuDNN convolutions and ATen elementwise
passes, about half of an eval batch's launches; the ViT (``models/vit.py``)
is cuBLAS products, fused attention and the passes between them.  Where
the runner can, it launches them as one replay of a captured
``torch.cuda.CUDAGraph``, so the host no longer sets the pace of that
stage.  The names below say HRNet for either estimator.  It engages on a
real CUDA tensor (not a tracer's, as ``torch.export`` passes), with HRNet in eval mode
and under ``inference_mode``; anything else runs eagerly.  Engaged, by the
call's key (the frames' shape, dtype and device, and the addresses of
HRNet's parameters and buffers):

- a key the previous call did not have runs eagerly, which warms cuDNN's
  algorithm choice and the kernels' builds;
- the same key on the next call captures the graph and replays it;
- the captured key replays from then on.

One graph is held at a time, in a private memory pool; a capture drops the
graph before it.  A batch of another shape between replays (the eval
loader's last, partial batch) runs eagerly and keeps the graph.

The frames are copied into the graph's input buffer.  A replay's heatmaps
are the graph's output buffer, which the next replay overwrites: work
queued on the stream before it reads them in order, but a result kept past
the next call must be ``keep(t)``, a copy where it is a view of that buffer.

A replay reads the tensors that were HRNet's parameters and buffers at the
capture, so in-place updates (an optimizer step between validation passes,
running statistics) are seen.  A tensor replaced by another
(``prepare_eval_params``'s ``p.data = ...``, ``Module.to``,
``load_state_dict(assign=True)``) moves the key, so the next calls capture
anew; the held graph keeps its tensors alive, so no new tensor can take
one of their addresses.  HRNet's submodules are listed once for each HRNet
object: a submodule assigned into HRNet after the first call is not seen.

Counters (``utils/profiling.py``): ``hrnet_graph.eager`` (calls run
eagerly, engaged or not), ``hrnet_graph.captures`` and
``hrnet_graph.replays``.
"""

from __future__ import annotations

import dataclasses

import torch

from otpose_tpu_torch.models.otpose import OTPose, run_hrnet
from otpose_tpu_torch.utils import profiling


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` is a real CUDA tensor that a graph may read: not a
    tracer's subclass, and not while the current stream captures."""
    return t.is_cuda and type(t) is torch.Tensor and not torch.cuda.is_current_stream_capturing()


def capture(fn, frames: torch.Tensor):
    """(graph, output buffer): ``fn(frames)`` captured as a CUDA graph in a
    private memory pool.  Only this thread's unsafe calls break the
    capture, so loader threads may keep working on their own streams."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = fn(frames)
    return graph, out


@dataclasses.dataclass
class _Captured:
    key: tuple
    graph: object
    frames: torch.Tensor       # the input buffer
    rough: torch.Tensor        # the output buffer
    weights: list              # HRNet's tensors at the capture, held alive


class BackboneGraph:
    """``runner(frames) -> rough heatmaps`` of ``model``'s HRNet, replayed
    from a CUDA graph where it can be (see the module's docstring)."""

    def __init__(self, model: OTPose):
        self.model = model
        self._net = None
        self._dicts: list = []
        self._last = None          # the key of the previous call, if it ran eagerly
        self._held: _Captured | None = None

    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        net = self.model.rough_pose_estimation_net
        if net.training or not torch.is_inference_mode_enabled() or not on_card(frames):
            return self._eager(frames, None)
        weights = self._addresses(net)
        key = (tuple(frames.shape), frames.dtype, frames.device, weights)
        held = self._held
        if held is not None and held.key == key:
            return self._replay(held, frames)
        if held is not None and held.key[-1] != weights:
            self._held = None      # its weights are gone from the model
        if key != self._last:
            return self._eager(frames, key)
        self._held = None          # the old graph and its pool, before the new capture
        frames_in = frames.clone()
        graph, rough = capture(lambda f: run_hrnet(self.model, f), frames_in)
        self._held = _Captured(key, graph, frames_in, rough,
                               [t.detach() for d in self._dicts for t in d.values()
                                if t is not None])
        profiling.count("hrnet_graph.captures")
        return self._replay(self._held, frames)

    def keep(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, copied where it is a view of the graph's output buffer."""
        held = self._held
        if held is not None and t.untyped_storage().data_ptr() == \
                held.rough.untyped_storage().data_ptr():
            return t.clone()
        return t

    def _addresses(self, net) -> tuple:
        if net is not self._net:
            self._net = net
            self._dicts = [d for m in net.modules() for d in (m._parameters, m._buffers) if d]
        return tuple(t.data_ptr() for d in self._dicts for t in d.values() if t is not None)

    def _eager(self, frames, key):
        self._last = key
        profiling.count("hrnet_graph.eager")
        return run_hrnet(self.model, frames)

    def _replay(self, held: _Captured, frames):
        self._last = None
        held.frames.copy_(frames)
        held.graph.replay()
        profiling.count("hrnet_graph.replays")
        return held.rough
