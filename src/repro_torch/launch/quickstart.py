"""Quickstart: train a small LM on the synthetic Markov task, checkpoint,
resume, and serve a few tokens: the whole public API in one script (the
reference package's ``examples/quickstart.py``).

  PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.configs import get_config
from repro_torch.core.autotune import telemetry_summary
from repro_torch.core.machine import get_machine
from repro_torch.data.pipeline import DataConfig, MarkovTask
from repro_torch.launch.serve import serve
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.train_loop import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    steps = args.steps

    # 0) the active machine model every depth solve reads
    print(f"machine profile: {get_machine().name} "
          f"(REPRO_MACHINE selects; see repro_torch.core.machine)")

    # 1) pick an assigned architecture at smoke scale
    cfg = get_config("granite-3-2b").reduced().replace(vocab=128)
    model = build_model(cfg)
    print(f"arch={cfg.name}  params={model.n_params()/1e6:.2f}M")

    # 2) train on the seeded Markov task (loss floor = chain entropy)
    data = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, branching=2)
    task_floor = MarkovTask(data).entropy()
    with tempfile.TemporaryDirectory() as ckpt:
        rep = train(model, steps=steps, data_cfg=data,
                    opt=AdamWConfig(lr=5e-3, total_steps=steps, warmup_steps=5),
                    ckpt_dir=ckpt, ckpt_every=max(steps // 2, 1),
                    device=args.device)
        first, last = min(rep.losses), max(rep.losses)
        print(f"loss: {rep.losses[first]:.3f} -> {rep.losses[last]:.3f} "
              f"(floor ~{task_floor:.3f})")

        # 3) resume exactly from the checkpoint (fault-tolerant restart path)
        rep2 = train(build_model(cfg), steps=steps + 1, data_cfg=data,
                     opt=AdamWConfig(lr=5e-3, total_steps=steps + 1,
                                     warmup_steps=5),
                     ckpt_dir=ckpt, device=args.device)
        print(f"resumed from step {rep2.resumed_from}")

    # 4) serve: batched prefill + decode with KV caches
    stats = serve(cfg, batch=2, prompt_len=16, gen=6, device=args.device)
    print("serve:", stats)

    # 5) the decode loop fed the always-on transfer telemetry as it ran
    print("telemetry:", telemetry_summary())
    return rep, rep2, stats


if __name__ == "__main__":
    main()
