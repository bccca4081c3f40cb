"""`core.step_graph.StepGraph`, the port's counterpart of the reference's
jitted serving steps, on the CPU: CPU tensors run the step eagerly on every
call (the device rule), with nothing captured; the process counts add up
by each graph's name and in total; the module keeps no switch that would
turn capture off on the card and no `try` around it. Its CUDA path
(capture, replay, launch counts) is held on the card by
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
    step = StepGraph(fn, "step")
    outs = [step((w, cache), (torch.full((3,), float(i)),))
            for i in range(1, 4)]
    assert [int(o["n"]) for o in outs] == [1, 2, 3]   # fresh results
    assert torch.equal(outs[0]["y"], torch.full((3,), 2.0))
    assert torch.equal(cache, torch.full((3,), 6.0))
    assert step.captures == 0 and step.replays == 0 and step.key is None
    assert step_graph.stats() == {"captures": 0, "capture_s": 0.0,
                                  "replays": 0, "by_name": {}}


def test_reset_clears_the_process_counts():
    step_graph._tally("paged_decode", captures=2, capture_s=0.5, replays=9)
    repro_torch.reset()
    assert step_graph.stats() == {"captures": 0, "capture_s": 0.0,
                                  "replays": 0, "by_name": {}}


def test_stats_add_up_by_name_and_in_total():
    """What a capture and a replay record (`_tally`, the only writer):
    decode and prefill graphs kept apart by name, summed in the total;
    `reset` clears both, and a later count starts from zero."""
    step_graph._tally("paged_decode", captures=1, capture_s=0.25)
    step_graph._tally("paged_decode", replays=1)
    step_graph._tally("paged_decode", replays=1)
    for _ in range(2):
        step_graph._tally("paged_prefill", captures=1, capture_s=0.5)
    step_graph._tally("paged_prefill", replays=1)
    st = step_graph.stats()
    assert st["by_name"] == {
        "paged_decode": {"captures": 1, "capture_s": 0.25, "replays": 2},
        "paged_prefill": {"captures": 2, "capture_s": 1.0, "replays": 1}}
    assert (st["captures"], st["capture_s"], st["replays"]) == (3, 1.25, 3)
    st["by_name"]["paged_decode"]["replays"] = 99      # a copy, not the state
    assert step_graph.stats()["by_name"]["paged_decode"]["replays"] == 2
    step_graph.reset()
    assert step_graph.stats()["by_name"] == {}
    step_graph._tally("dense_decode", replays=1)
    assert step_graph.stats() == {
        "captures": 0, "capture_s": 0.0, "replays": 1,
        "by_name": {"dense_decode": {"captures": 0, "capture_s": 0.0,
                                     "replays": 1}}}


def test_every_serving_step_has_its_own_name():
    """The three compiled serving steps carry the names `stats()` reports
    them under; the prefiller builds one step per key, all named alike."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import jit_decode_step
    from repro_torch.models import build_model
    from repro_torch.serve import PagedServingEngine

    cfg = get_config("yi-6b").reduced()
    assert jit_decode_step(build_model(cfg)).graph.name == "dense_decode"
    eng = PagedServingEngine(cfg, device="cpu", block_size=4, num_blocks=8)
    assert eng._decode(2).name == "paged_decode"
    a, b = eng.prefiller._graph((8, 2)), eng.prefiller._graph((4, 2))
    assert a is not b and a is eng.prefiller._graph((8, 2))
    assert a.name == b.name == "paged_prefill"
    assert set(eng.prefiller.graphs) == {(8, 2), (4, 2)}


def test_no_switch_and_no_fallback_around_a_capture():
    src = inspect.getsource(step_graph)
    assert "try:" not in src and "except" not in src
    assert "environ" not in src and "getenv" not in src
    params = inspect.signature(StepGraph).parameters
    assert list(params) == ["fn", "name"]
