"""The port's paper-figure harness (`launch/figures/`) against the
reference's ``benchmarks/``: every figure table is the same string under
one machine profile, and the harness prints the reference's sections in
order and its headline line. The reference's ``benchmarks`` package needs
the repository root on ``sys.path``."""
import importlib
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro.core import machine as ref_machine
from repro_torch.core import machine
from repro_torch.launch.figures import run

ROOT = Path(__file__).resolve().parent.parent
FIGURES = ("fig11_compiler", "fig12_latency", "fig13_instructions",
           "fig14_breakdown", "fig15_optimizations", "fig16_mlp")


@pytest.fixture(autouse=True)
def _reset_port():
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


def _reference(name: str):
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module(f"benchmarks.{name}")


@pytest.mark.parametrize("profile", ["v5e", "nh-g"])
@pytest.mark.parametrize("name", FIGURES)
def test_figure_table_matches_reference(name, profile):
    machine.set_machine(profile)
    ref_machine.set_machine(profile)
    got = importlib.import_module(f"repro_torch.launch.figures.{name}")
    assert got.table() == _reference(name).table()


def test_figure_extras_match_reference():
    fig11 = importlib.import_module(
        "repro_torch.launch.figures.fig11_compiler")
    fig14 = importlib.import_module(
        "repro_torch.launch.figures.fig14_breakdown")
    assert fig11.headline() == _reference("fig11_compiler").headline()
    assert fig14.mean_mispredict() == \
        _reference("fig14_breakdown").mean_mispredict()


def _reference_run(monkeypatch, capsys) -> str:
    """The reference harness's output, its slow kernel bench (Pallas in
    interpret mode) and its roofline stubbed out: only the sections' names
    and the headline are compared."""
    ref_run = _reference("run")
    monkeypatch.setattr(_reference("kernel_bench"), "table", lambda: "k\n")
    monkeypatch.setattr(_reference("roofline"), "table", lambda: "r\n")
    ref_run.main()
    return capsys.readouterr().out


def _summary(text: str):
    head = text.split("\n\n")[0].splitlines()
    return head[0], [line.split(",")[0] for line in head[1:]], head[-1]


def test_run_prints_the_reference_sections_and_headline(monkeypatch, capsys):
    ref_header, ref_names, ref_headline = _summary(
        _reference_run(monkeypatch, capsys))
    text = run.main(["--device", "cpu"])
    capsys.readouterr()
    header, names, headline = _summary(text)
    assert (header, names) == (ref_header, ref_names)
    assert headline == ref_headline == run.headline()
    assert "roofline,0,absent" in text.splitlines()
    assert "== roofline ==\nabsent: " in text
    for name in names[:-1]:
        assert f"\n== {name} ==\n" in text
    assert "ERROR" not in text


def test_run_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        run.main([])
