"""The port's command-line entry points of the guard: the chaos harness
(`launch/chaos_serve.py`) on reduced yi-6b and granite-moe for two seeds,
`launch/kernel_bench.py --strict --json --trace`, and ``serve --strict``,
all on the CPU; without ``--device cpu`` each needs the card."""
import json
import types

import pytest
import torch

import repro_torch
from repro_torch.core import guard
from repro_torch.launch import chaos_serve, kernel_bench, serve


@pytest.fixture(autouse=True)
def _reset_port():
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", ["yi-6b", "granite-moe-1b-a400m"])
def test_chaos_serve_invariants(arch, seed, capsys):
    """Every round keeps the pager's invariants and raises nothing; at
    drain every request is terminal and the sentinel saw no mismatch (the
    harness asserts these itself); the printed summary is its return."""
    summary = chaos_serve.main(["--device", "cpu", "--arch", arch,
                                "--seed", str(seed), "--rounds", "20"])
    assert json.loads(capsys.readouterr().out) == json.loads(
        json.dumps(summary))
    assert summary["requests"] == summary["completed"] + \
        summary["cancelled"] + summary["failed"]
    sub = summary["substrate"]
    assert sub["parity"] == "sampled" and sub["parity_mismatches"] == 0
    assert sub["parity_checks"] > 0 and sub["guarded_calls"] > 0
    assert summary["faults"]["injected"] > 0
    # the harness uninstalls its injector
    assert guard._injector is guard._NULL_INJECTOR


def test_chaos_serve_replays_its_schedule(capsys):
    args = ["--device", "cpu", "--seed", "3", "--rounds", "12"]
    first = chaos_serve.main(args)
    repro_torch.reset()
    second = chaos_serve.main(args)
    capsys.readouterr()
    assert first == second


def test_kernel_bench_strict_json_trace(tmp_path, capsys):
    path = tmp_path / "bench.json"
    text = kernel_bench.main(["--device", "cpu", "--strict", "--json",
                              "--trace", str(path)])
    capsys.readouterr()
    rep = json.loads(text)
    sub = rep["substrate"]
    assert sub["strict"] and sub["backoffs"] == 0
    assert sub["guarded_calls"] == sub["clean_calls"] > 0
    assert all("breakdown" in k for k in rep["kernels"].values())
    doc = json.loads(path.read_text())
    spans = [ev for ev in doc["traceEvents"]
             if ev["name"].startswith("pipeline:")]
    assert {ev["name"] for ev in spans} >= {
        f"pipeline:{k}" for k in rep["kernels"]}
    for ev in spans:
        assert ev["ph"] == "X" and ev["dur"] >= 0
        assert ev["args"]["n_tiles"] > 0 and ev["args"]["depth"] >= 1


def test_serve_strict_on_cpu(capsys):
    stats = serve.main(["--arch", "yi-6b", "--reduced", "--device", "cpu",
                        "--strict", "--batch", "2", "--prompt-len", "8",
                        "--gen", "4"])
    capsys.readouterr()
    sub = stats["substrate"]
    assert sub["strict"] and sub["backoffs"] == 0
    assert sub["guarded_calls"] == sub["clean_calls"] > 0


def test_dense_scan_raises_only_in_strict_mode():
    """The dense loop's logits scan counts a non-finite step and raises it
    only in strict mode."""
    def decode(params, cache, batch):
        return torch.full((1, 1, 4), float("nan")), cache

    def make_batch(tokens, i):
        return {"tokens": tokens}

    tokens = torch.zeros((1, 1), dtype=torch.int32)
    out, _, lat = serve.timed_decode_loop(decode, None, None, tokens,
                                          steps=2, make_batch=make_batch)
    assert len(out) == 3 and guard.stats()["numerics_faults"] == 2
    guard.set_strict(True)
    with pytest.raises(guard.KernelNumericsError):
        serve.timed_decode_loop(decode, None, None, tokens, steps=2,
                                make_batch=make_batch)


@pytest.mark.parametrize("entry", ["chaos_serve", "kernel_bench", "serve"])
def test_entry_points_need_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    main = {"chaos_serve": chaos_serve.main, "kernel_bench": kernel_bench.main,
            "serve": serve.main}[entry]
    args = ["--reduced"] if entry == "serve" else []
    with pytest.raises(RuntimeError):
        main(args)


def test_chaos_serve_counts_only_its_own_run(capsys):
    """Mismatches the guard counted before the harness ran (here a
    poisoned plain version) are not the harness's: its summary and its
    assertion read the counters of its own run."""
    x = torch.ones(4)
    guard.set_parity("full")
    with pytest.raises(guard.KernelParityError):
        guard.guarded_call(types.SimpleNamespace(name="p", loads=(),
                                                 stores=()),
                           (x,), lambda d: x + 1, depth=1, n_tiles=1,
                           plain=lambda v: v)
    assert guard.stats()["parity_mismatches"] == 1
    summary = chaos_serve.main(["--device", "cpu", "--rounds", "8"])
    capsys.readouterr()
    assert summary["substrate"]["parity_mismatches"] == 0
    assert guard.stats()["parity_mismatches"] == 1
