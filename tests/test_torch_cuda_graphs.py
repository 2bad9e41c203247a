"""The port's CUDA-graph capture guard (``utils/cuda_graphs.py``): automatic
garbage collection is paused for the whole capture and restored after it,
and the serving engine captures its steps through the guard.  A collection
inside a capture can destroy another graph there, which ends the capture
with ``cudaErrorStreamCaptureInvalidated``; the capture itself needs the
card, so ``torch.cuda.graph`` and ``CUDAGraph`` are stand-ins here."""

import contextlib
import gc

import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference import serving
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.utils import cuda_graphs

torch.set_num_threads(1)


@pytest.fixture
def fake_capture(monkeypatch):
    """``torch.cuda.graph`` replaced by a context manager that records the
    collector's state when the capture begins and ends."""
    seen = []

    @contextlib.contextmanager
    def graph(g, **kwargs):
        seen.append(("begin", gc.isenabled(), kwargs))
        yield
        seen.append(("end", gc.isenabled(), kwargs))

    monkeypatch.setattr(torch.cuda, "graph", graph)
    return seen


@pytest.fixture
def collector_on():
    was = gc.isenabled()
    gc.enable()
    yield
    if not was:
        gc.disable()


def test_graph_capture_pauses_collection(fake_capture, collector_on):
    inside = []
    with cuda_graphs.graph_capture(object(), pool=None):
        inside.append(gc.isenabled())
    assert inside == [False]
    assert fake_capture == [("begin", False, {"pool": None}),
                            ("end", False, {"pool": None})]
    assert gc.isenabled()


def test_graph_capture_restores_collection_after_a_failure(fake_capture,
                                                           collector_on):
    with pytest.raises(RuntimeError, match="in the body"):
        with cuda_graphs.graph_capture(object()):
            raise RuntimeError("in the body")
    assert gc.isenabled()


def test_graph_capture_leaves_a_paused_collector_paused(fake_capture,
                                                        collector_on):
    gc.disable()
    with cuda_graphs.graph_capture(object()):
        assert not gc.isenabled()
    assert not gc.isenabled()


def test_serving_capture_runs_under_the_guard(fake_capture, collector_on,
                                              monkeypatch):
    """``ServingEngine._capture`` pauses collection around its body and
    gives the kernel wrappers' launch counts back to each replay."""
    eng = deepspeed_tpu_torch.init_inference(
        tgpt2.build(tgpt2.GPT2Config.tiny(max_seq_len=64)),
        config={"dtype": "fp32"}, device="cpu")
    srv = serving.ServingEngine(eng, slots=2)

    class FakeGraph:
        replays = 0

        def replay(self):
            FakeGraph.replays += 1

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)
    wrapper = serving._kernel_wrappers()[0]
    base = wrapper.launches
    inside = []

    def body():
        inside.append(gc.isenabled())
        wrapper.launches += 2

    rec = srv._capture(body)
    assert inside == [False] and gc.isenabled()
    assert [stage for stage, _, _ in fake_capture] == ["begin", "end"]
    assert wrapper.launches == base and srv.captured_graphs == 1
    rec.replay()
    assert FakeGraph.replays == 1 and wrapper.launches == base + 2
    wrapper.launches = base
