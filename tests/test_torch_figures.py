"""The port's paper-figure harness (`launch/figures/`) against the
reference's ``benchmarks/``: every figure table is the same string under
one machine profile, and the harness prints the reference's sections in
order and its headline line. The reference's ``benchmarks`` package needs
the repository root on ``sys.path``."""
import importlib
import json
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


# one ok and one skipped dry-run record, as `launch.dryrun` writes them
RECORDS = {
    "yi-6b__decode_32k__single": {
        "arch": "yi-6b", "shape": "decode_32k", "mesh": "single",
        "status": "ok", "dominant": "memory_s",
        "terms": {"compute_s": 1.025e-4, "memory_s": 1.681e-2,
                  "collective_s": 9.466e-6},
        "useful_flops_ratio": 0.14213,
        "memory": {"argument_size_in_bytes": 25317883972,
                   "output_size_in_bytes": 1075789828,
                   "temp_size_in_bytes": 525377536}},
    "yi-6b__long_500k__single": {
        "arch": "yi-6b", "shape": "long_500k", "mesh": "single",
        "status": "skipped", "reason": "long_500k needs sub-quadratic "
        "attention"}}


def _write_records(root: Path) -> Path:
    out = root / "reports" / "dryrun"
    out.mkdir(parents=True)
    for tag, rec in RECORDS.items():
        (out / f"{tag}.json").write_text(json.dumps(rec))
    return out


def test_run_prints_the_reference_sections_and_headline(monkeypatch, capsys,
                                                        tmp_path):
    ref_header, ref_names, ref_headline = _summary(
        _reference_run(monkeypatch, capsys))
    _write_records(tmp_path)
    monkeypatch.chdir(tmp_path)          # the table reads reports/dryrun
    text = run.main(["--device", "cpu"])
    capsys.readouterr()
    header, names, headline = _summary(text)
    assert (header, names) == (ref_header, ref_names)
    assert headline == ref_headline == run.headline()
    assert any(line.startswith("roofline,") and line.endswith(",rows=2")
               for line in text.splitlines())
    assert ("== roofline ==\narch,shape,mesh,dominant,compute_s,memory_s,"
            "collective_s,useful_ratio,args_GiB_dev,temp_GiB_dev\n") in text
    assert ("yi-6b,decode_32k,single,memory,1.025e-04,1.681e-02,9.466e-06,"
            "0.142,23.58,0.49\n") in text
    for name in names[:-1]:
        assert f"\n== {name} ==\n" in text
    assert "ERROR" not in text


def test_roofline_table_matches_reference(tmp_path):
    """The port's roofline table over dry-run records is the reference's
    over the same records; with none, its header alone."""
    out = _write_records(tmp_path)
    from repro_torch.launch.figures import roofline

    assert roofline.table(out) == _reference("roofline").table(out)
    assert roofline.table(tmp_path / "none").count("\n") == 1


def test_run_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        run.main([])
