"""The port stands alone: no JAX and nothing of the JAX package.

A static scan of every module of `src/repro_torch` and of `chip_smoke.py`
for imports of `jax` or `repro`, and a subprocess in which both are
blocked (`sys.modules[...] = None`) that imports the port, serves two
requests of a dense and two of a MoE arch through the paged engine and a
batch of two of an SSM arch through the dense engine, trains a MoE arch
for three steps with a checkpoint and a resume, on the CPU, and traces a
dry-run cell on meta tensors.
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
                 "src/repro_torch/kernels/moe_gmm/moe_gmm.py",
                 "src/repro_torch/kernels/moe_gmm/ops.py",
                 "src/repro_torch/models/moe.py",
                 "src/repro_torch/models/ssm.py",
                 "src/repro_torch/kernels/decode_attention/ops.py",
                 "src/repro_torch/kernels/ssd_scan/ssd_scan.py",
                 "src/repro_torch/kernels/ssd_scan/ops.py",
                 "src/repro_torch/launch/serve.py", "chip_smoke.py",
                 "src/repro_torch/configs/shapes.py",
                 "src/repro_torch/core/tree.py",
                 "src/repro_torch/data/pipeline.py",
                 "src/repro_torch/optim/adamw.py",
                 "src/repro_torch/optim/compression.py",
                 "src/repro_torch/runtime/steps.py",
                 "src/repro_torch/runtime/train_loop.py",
                 "src/repro_torch/runtime/fault_tolerance.py",
                 "src/repro_torch/checkpointing/checkpoint.py",
                 "src/repro_torch/launch/train.py",
                 "src/repro_torch/launch/quickstart.py",
                 "src/repro_torch/launch/train_100m.py",
                 "src/repro_torch/launch/machine_smoke.py",
                 "src/repro_torch/sharding.py",
                 "src/repro_torch/launch/mesh.py",
                 "src/repro_torch/runtime/layouts.py",
                 "src/repro_torch/roofline.py",
                 "src/repro_torch/launch/dryrun.py",
                 "src/repro_torch/launch/figures/roofline.py",
                 "src/repro_torch/launch/build_experiments.py",
                 "src/repro_torch/launch/remeasure_decode.py"):
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
from repro_torch.launch.serve import serve, serve_paged
states, generated = [], []
for arch in ("yi-6b", "granite-moe-1b-a400m"):
    cfg = get_config(arch).reduced().replace(dtype="float32",
                                             param_dtype="float32")
    stats = serve_paged(cfg, batch=2, prompt_len=12, gen=3, block_size=4,
                        device="cpu")
    states += stats["states"]
    generated += stats["generated"]
cfg = get_config("mamba2-130m").reduced().replace(dtype="float32",
                                                  param_dtype="float32")
dense = serve(cfg, batch=2, prompt_len=32, gen=3, device="cpu")
states += ["finished" if dense["engine"] == "dense" else "?"] * 2
generated += dense["generated"]
import tempfile
import repro_torch.checkpointing.checkpoint, repro_torch.configs.shapes
import repro_torch.launch.machine_smoke, repro_torch.launch.quickstart
import repro_torch.launch.train_100m, repro_torch.optim.compression
from repro_torch.launch.train import main as train_main
with tempfile.TemporaryDirectory() as ckpt:
    args = ["--arch", "granite-moe-1b-a400m", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-dir", ckpt]
    first = train_main(args + ["--steps", "2"])
    resumed = train_main(args + ["--steps", "3"])
trained = [sorted(first.losses), resumed.resumed_from, sorted(resumed.losses)]
import repro_torch.launch.build_experiments, repro_torch.launch.remeasure_decode
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.figures import roofline
dry = run_cell("mamba2-130m", "decode_32k", "single", verbose=False)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro")
                and sys.modules[m] is not None)
print(json.dumps({"states": states, "generated": generated,
                  "trained": trained, "dryrun": dry["status"],
                  "leaked": leaked}))
"""


def test_port_serves_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", SERVE_WITHOUT_JAX],
                          capture_output=True, text=True, env=env,
                          cwd=str(ROOT), timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["states"] == ["finished"] * 6
    assert [len(g) for g in out["generated"]] == [3] * 6
    assert out["trained"] == [[0, 1], 2, [2]]
    assert out["dryrun"] == "ok"
    assert out["leaked"] == []
