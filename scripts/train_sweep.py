"""Whether granite-moe-1b-a400m trains at full width in 20 steps, under a
few data and optimizer settings, on the card.

Each setting runs `runtime.steps.make_train_step` (AdamW, warmup 2, f32
parameters, bf16 compute) from the same seeded parameters for 20 steps of
batch 8 x seq 512 on the Markov task, and prints one JSON line: the
Markov chain's vocabulary (the model's 49155 ids, or its first 512), the
global-norm clip, the learning rate, every step's loss and gradient norm
(before the clip), and the mean of the first 5 losses less the mean of
the last 5. `chip_smoke.py` phase 11 trains with the setting this picks.

    python3 scripts/train_sweep.py      (needs a CUDA card and nvcc)
"""
from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

SETTINGS = (  # (Markov vocabulary, clip, lr)
    (49155, 1.0, 1e-3),
    (512, 1.0, 3e-3),
    (512, 0.0, 1e-3),
    (512, 0.0, 3e-3),
    (512, 0.0, 1e-2),
    (49155, 0.0, 3e-3),
)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("train_sweep: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.core import guard
    from repro_torch.data.pipeline import DataConfig, MarkovTask
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.runtime.steps import make_train_step

    guard.set_parity("off")
    model = build_model(get_config("granite-moe-1b-a400m"))
    for vocab, clip, lr in SETTINGS:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        state = init_state(model.init(gen, "cuda"))
        task = MarkovTask(DataConfig(vocab=vocab, seq_len=512,
                                     global_batch=8))
        step = make_train_step(model, AdamWConfig(
            lr=lr, total_steps=20, warmup_steps=2, grad_clip=clip))
        losses, norms = [], []
        for i in range(20):
            batch = {k: torch.as_tensor(v, device="cuda")
                     for k, v in task.batch_for_step(i).items()}
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        print(json.dumps({
            "vocab": vocab, "clip": clip, "lr": lr, "losses": losses,
            "grad_norms": norms,
            "fall": statistics.mean(losses[:5]) - statistics.mean(losses[-5:]),
        }), flush=True)
        del state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
