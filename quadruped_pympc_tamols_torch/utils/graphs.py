"""CUDA graphs for the port's fixed-shape device functions.

Counterpart of ``jax.jit`` for code that is a long chain of small torch ops (the
gradient MPC's solve is a few thousand of them): on a CUDA device the function is
captured once per input signature into a ``torch.cuda.CUDAGraph``, after a
warm-up on a side stream as torch's graph documentation requires, and each call
copies its host inputs into the graph's static buffers and replays it. On the
CPU the function runs eagerly: it is the graph's plain version.

Inputs on the host (CPU tensors, pinned for an asynchronous copy) are copied into
buffers the graph owns. Inputs already on the card, such as the outputs of
another graph, are read in place: the graph is bound to their address, which is
part of the capture key. The outputs are the graph's static tensors, overwritten
by the next replay. The inputs are saved before the warm-up runs and restored
after them, so that a function that updates its inputs in place (the scenario
fleet's tick) advances nothing at its capture and once at each replay. A failed
capture raises; nothing falls back to eager mode, and the device's default
random generator is left as it was (``_release_generator``).

Kernel wrappers count their launches with ``count_launch``. A launch made while a
graph is being captured runs at each replay, not at the capture: the capture
records it, and each replay adds what its capture recorded.
"""
from __future__ import annotations

import gc

import torch

WARMUP = 3  # eager runs on a side stream before a capture

_recording: list | None = None  # (counter, key) launches of the capture in progress


def _release_generator(device: torch.device) -> None:
    """Give ``device``'s default CUDA generator a fresh state with its seed and
    offset. A capture registers the generator and marks it as capturing, and torch
    clears the mark only when the capture ends cleanly: after a failed capture
    every later draw on the device would raise."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    gen = torch.cuda.default_generators[index]
    gen.graphsafe_set_state(gen.clone_state())


def count_launch(counter: dict, key) -> None:
    """Add one launch of ``key`` to ``counter``, a wrapper's dict of launch counts;
    inside a ``GraphedFunction``'s capture, record it for the graph's replays."""
    if _recording is not None and torch.cuda.is_current_stream_capturing():
        _recording.append((counter, key))
    else:
        counter[key] += 1


class GraphedFunction:
    """``fn(*tensors) -> tensor or tuple of tensors`` on ``device``, replayed from a
    captured CUDA graph there (see the module docstring); ``fn`` itself is the
    eager version. ``captures`` and ``replays`` count what the card ran."""

    def __init__(self, fn, device):
        self.fn = fn
        self.device = torch.device(device)
        self.captures = 0
        self.replays = 0
        self._graphs = {}

    def __call__(self, *inputs):
        if self.device.type != "cuda":
            return self.fn(*inputs)
        key = tuple((tuple(x.shape), x.dtype, x.data_ptr() if x.is_cuda else None)
                    for x in inputs)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._capture(inputs)
            self._graphs[key] = entry
        graph, static_in, out, launches = entry
        for buf, x in zip(static_in, inputs):
            if not x.is_cuda:
                buf.copy_(x, non_blocking=True)
        graph.replay()
        self.replays += 1
        for counter, k in launches:
            counter[k] += 1
        return out

    def _capture(self, inputs):
        global _recording
        static_in = tuple(x if x.is_cuda else torch.empty(x.shape, dtype=x.dtype,
                                                           device=self.device)
                          for x in inputs)
        for buf, x in zip(static_in, inputs):
            if not x.is_cuda:
                buf.copy_(x)
        saved = [x.clone() for x in static_in]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                self.fn(*static_in)
        torch.cuda.current_stream(self.device).wait_stream(side)
        for x, copy in zip(static_in, saved):
            x.copy_(copy)
        graph = torch.cuda.CUDAGraph()
        # No garbage collection inside the capture (a collected tensor's free would
        # reach the CUDA runtime mid-capture), and only this thread's calls count
        # against it: a profiler's worker thread may call the runtime meanwhile.
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        launches, outer, _recording = [], _recording, []
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = self.fn(*static_in)
            launches = _recording
        except BaseException:
            _release_generator(self.device)
            raise
        finally:
            _recording = outer
            if collecting:
                gc.enable()
        self.captures += 1
        return graph, static_in, out, launches
