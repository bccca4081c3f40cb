"""The port stands alone: no JAX and nothing of the JAX package.

A static scan of every module of `src/repro_torch` and of `chip_smoke.py`
for imports of `jax` or `repro`, and a subprocess in which both are
blocked (`sys.modules[...] = None`) that imports the port and serves two
requests on the CPU.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro_torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


@pytest.fixture(autouse=True)
def _reset_port():
    repro_torch.reset()
    yield
    repro_torch.reset()


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for want in ("src/repro_torch/serve/engine.py",
                 "src/repro_torch/models/lm.py",
                 "src/repro_torch/kernels/decode_attention/decode_attention.py",
                 "src/repro_torch/launch/serve.py", "chip_smoke.py"):
        assert want in names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


SERVE_WITHOUT_JAX = """
import json, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None          # any import of them now fails
import repro_torch
from repro_torch.configs import get_config
from repro_torch.launch.serve import serve_paged
cfg = get_config("yi-6b").reduced().replace(dtype="float32",
                                            param_dtype="float32")
stats = serve_paged(cfg, batch=2, prompt_len=12, gen=3, block_size=4,
                    device="cpu")
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro")
                and sys.modules[m] is not None)
print(json.dumps({"states": stats["states"], "generated": stats["generated"],
                  "leaked": leaked}))
"""


def test_port_serves_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", SERVE_WITHOUT_JAX],
                          capture_output=True, text=True, env=env,
                          cwd=str(ROOT), timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["states"] == ["finished", "finished"]
    assert [len(g) for g in out["generated"]] == [3, 3]
    assert out["leaked"] == []
