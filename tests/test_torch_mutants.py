"""The broken kernel copies of ``scripts/kernel_mutants.py``, the reduced
copies of ``scripts/{flash_decode,ssd_scan}_breakdown.py`` and the
persistent-grid copies of the triad and the ring-wait copies of the span
gather and the scatter-add that ``chip_smoke.py`` times, against the
sources they change.

The scripts build and run them only on a card, and refuse an edit whose
text does not occur exactly once in its source; this checks every copy's
edits, in order, on the CPU, so that a source edit that moves such a text
shows here first.
"""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ROOT / "src" / "repro_torch" / "kernels"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


MUTANTS = _load("kernel_mutants")
BREAKDOWNS = {"flash_decode_breakdown": MUTANTS.FLASH,
              "ssd_scan_breakdown": MUTANTS.SSD}


@pytest.mark.parametrize("name", sorted(MUTANTS.MUTANTS))
def test_mutant_texts_occur_once_in_their_source(name):
    rel, edits, only = MUTANTS.edits_of(MUTANTS.MUTANTS[name])
    text = (KERNELS / rel).read_text()
    for old, new in edits:
        assert text.count(old) == 1, (name, old)
        text = text.replace(old, new)
    assert text != (KERNELS / rel).read_text()
    assert name.split()[0] in {"K1", "K2", "K3", "K4", "K4b", "K5a", "K6",
                               "K7"}
    assert isinstance(only, str)


@pytest.mark.parametrize("script,variant", [
    (script, variant) for script in sorted(BREAKDOWNS)
    for variant in sorted(_load(script).VARIANTS)])
def test_breakdown_texts_occur_once_in_their_source(script, variant):
    edits = _load(script).VARIANTS[variant]
    text = (KERNELS / BREAKDOWNS[script]).read_text()
    for old, new in edits:
        assert text.count(old) == 1, (variant, old)
        text = text.replace(old, new)


@pytest.mark.parametrize("per_sm", MUTANTS.chip_smoke.TRIAD_PERSISTENT)
def test_triad_persistent_grid_texts_occur_once(per_sm):
    smoke = MUTANTS.chip_smoke
    text = (KERNELS / smoke.TRIAD_SOURCE).read_text()
    for old, new in smoke.triad_persistent_edits(per_sm):
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    assert f"static_cast<int64_t>(sms) * {per_sm};" in text
    assert text.count("int64_t items") == 3    # launch, dispatch, kernel


@pytest.mark.parametrize("name", sorted(MUTANTS.chip_smoke.WAITS))
def test_ring_wait_texts_occur_once(name):
    """The inlined wait that phase 9 swaps for the header's call in its A/B
    occurs once in its source, at its indent."""
    smoke = MUTANTS.chip_smoke
    rel, indent = smoke.WAITS[name]
    text = (KERNELS / rel).read_text()
    assert text.count(" " * indent + smoke.WAIT_INLINE) == 1
    assert text.count(smoke.WAIT_INLINE) == 1
