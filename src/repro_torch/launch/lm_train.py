"""End-to-end LM training over the architecture zoo (the port's counterpart
of `examples/lm_train.py`).

    PYTHONPATH=src python -m repro_torch.launch.lm_train --device cpu --steps 30
    PYTHONPATH=src python -m repro_torch.launch.lm_train --arch mamba2-1.3b --steps 50
    PYTHONPATH=src python -m repro_torch.launch.lm_train --preset 100m --steps 300

Defaults to a CI-sized model; `--preset 100m` trains a ~100M-parameter
model of the arch's family.  The flow: config, `data.pipeline.make_batch`,
AdamW through `launch.steps.make_train_step`, `CheckpointManager` save and
restore, `StragglerMonitor`.  Each step's loss is read on the host inside
the monitor's window, so the monitor times the finished step.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import device as _device


def config(arch: str, preset: str):
    from repro_torch import configs
    base = configs.get(arch)
    if preset == "100m":
        return dataclasses.replace(base.reduced(layers=12, d_model=512, vocab=32_000),
                                   name=base.name + "-100m", d_ff=2048)
    return base.reduced(layers=2, d_model=128, vocab=512)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--preset", default="ci", choices=["ci", "100m"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch.steps import bind, init_train_state, make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.runtime.failures import StragglerMonitor

    dev = _device.resolve(args.device)
    cfg = config(args.arch, args.preset)
    opt_cfg = adamw.OptConfig(peak_lr=args.lr, warmup_steps=20, total_steps=args.steps)
    model = M.init_params(cfg, 0, dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M batch={args.batch} seq={args.seq} "
          f"device={dev}")

    state = init_train_state(model, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg, remat=False)
    data = DataConfig(seed=0)

    mgr = None
    start = 0
    if args.ckpt_dir:
        from repro_torch.checkpoint.manager import CheckpointManager, latest_step
        mgr = CheckpointManager(args.ckpt_dir, keep=2)
        if latest_step(args.ckpt_dir) is not None:
            restored, start = mgr.restore(state)
            state = bind(model, restored)
            print(f"resumed at step {start}")

    mon = StragglerMonitor(window=50, threshold=3.0)
    t0 = time.time()
    for i in range(start, args.steps):
        batch = make_batch(cfg, data, i, args.batch, args.seq, dev)
        with mon.timed(i):
            state, metrics = step_fn(model, state, batch)
            loss = float(metrics["loss"])
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:5d}  loss={loss:.4f}  "
                  f"gnorm={float(metrics['grad_norm']):.3f}  "
                  f"lr={float(metrics['lr']):.2e}  ({time.time() - t0:.1f}s)")
        if mgr is not None and (i + 1) % 50 == 0:
            mgr.save(state, i + 1)
    if mgr is not None:
        mgr.wait()
        mgr.close()
    if mon.events:
        print(f"straggler steps flagged: {[e.step for e in mon.events]}")


if __name__ == "__main__":
    main()
