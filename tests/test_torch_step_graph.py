"""`core.step_graph.StepGraph`, the port's counterpart of the reference's
jitted decode steps, on the CPU: CPU tensors run the step eagerly on every
call (the device rule), with nothing captured; the module keeps no switch
that would turn capture off on the card and no `try` around it. Its CUDA
path (capture, replay, launch counts) is held on the card by
`tests/test_torch_kernels_cuda.py` and `chip_smoke.py`.
"""
import inspect

import pytest
import torch

import repro_torch
from repro_torch.core import step_graph
from repro_torch.core.step_graph import StepGraph


@pytest.fixture(autouse=True)
def _reset_port():
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


def test_cpu_tensors_run_the_step_eagerly_every_call():
    calls = []

    def fn(w, cache, x):
        calls.append(x.clone())
        cache.add_(x)                     # the closed-over state, in place
        return {"y": w @ x, "n": torch.tensor(len(calls))}

    w, cache = torch.eye(3) * 2, torch.zeros(3)
    step = StepGraph(fn)
    outs = [step((w, cache), (torch.full((3,), float(i)),))
            for i in range(1, 4)]
    assert [int(o["n"]) for o in outs] == [1, 2, 3]   # fresh results
    assert torch.equal(outs[0]["y"], torch.full((3,), 2.0))
    assert torch.equal(cache, torch.full((3,), 6.0))
    assert step.captures == 0 and step.replays == 0 and step.key is None
    assert step_graph.stats() == {"captures": 0, "capture_s": 0.0,
                                  "replays": 0}


def test_reset_clears_the_process_counts():
    step_graph._STATS.update(captures=2, capture_s=0.5, replays=9)
    repro_torch.reset()
    assert step_graph.stats() == {"captures": 0, "capture_s": 0.0,
                                  "replays": 0}


def test_no_switch_and_no_fallback_around_a_capture():
    src = inspect.getsource(step_graph)
    assert "try:" not in src and "except" not in src
    assert "environ" not in src and "getenv" not in src
    params = inspect.signature(StepGraph).parameters
    assert list(params) == ["fn"]
