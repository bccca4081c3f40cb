"""End to end: train a ~100M-parameter granite-family model for a few
hundred steps on the synthetic Markov corpus, with checkpointing, straggler
monitoring, and exact resume (the reference package's
``examples/train_100m.py``). The default dims give ~100M parameters; pass
--steps to shorten.

  PYTHONPATH=src python -m repro_torch.launch.train_100m --steps 300
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, MarkovTask
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.train_loop import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_100m_ckpt"))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config("granite-3-2b").replace(
        name="granite-100m",
        n_layers=args.layers, d_model=args.d_model,
        n_heads=args.d_model // 64, kv_heads=args.d_model // 128,
        head_dim=0, d_ff=args.d_model * 4, vocab=args.vocab,
        attn_chunk=128,
    )
    model = build_model(cfg)
    print(f"params={model.n_params()/1e6:.1f}M  layers={cfg.n_layers} "
          f"d_model={cfg.d_model} vocab={cfg.vocab}")

    data = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch, branching=4)
    print(f"markov loss floor ~{MarkovTask(data).entropy():.3f} nats")

    rep = train(
        model, steps=args.steps, data_cfg=data,
        opt=AdamWConfig(lr=3e-4, total_steps=args.steps,
                        warmup_steps=max(args.steps // 20, 10)),
        accum=args.accum, ckpt_dir=args.ckpt_dir, ckpt_every=100,
        log_every=20, device=args.device,
    )
    for s in sorted(rep.losses):
        print(f"step {s:4d}  loss {rep.losses[s]:.4f}")
    print(f"wall {rep.wall_s:.0f}s  stragglers {rep.straggler_steps} "
          f"resumed_from {rep.resumed_from}")
    return rep


if __name__ == "__main__":
    main()
