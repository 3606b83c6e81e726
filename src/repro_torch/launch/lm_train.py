"""End-to-end LM training over the architecture zoo (the port's counterpart
of `examples/lm_train.py`).

    PYTHONPATH=src python -m repro_torch.launch.lm_train --device cpu --steps 30
    PYTHONPATH=src python -m repro_torch.launch.lm_train --arch mamba2-1.3b --steps 50
    PYTHONPATH=src python -m repro_torch.launch.lm_train --preset 100m --steps 300
    PYTHONPATH=src python -m repro_torch.launch.lm_train --data 2 --model 2 --device cpu

Defaults to a CI-sized model; `--preset 100m` trains a ~100M-parameter
model of the arch's family.  The flow: config, `data.pipeline.make_batch`,
AdamW through `launch.steps.make_train_step`, `CheckpointManager` save and
restore, `StragglerMonitor`.  Each step's loss is read on the host inside
the monitor's window, so the monitor times the finished step.

`--data D --model M` trains on a D x M layout of spawned ranks
(`launch.distributed.run_ranks`; NCCL, one card a rank, or gloo with
`--device cpu`): the FSDP step with remat, each rank holding its blocks of
the state and of each step's batch, in the posture the reference's dry run
picks (`steps.use_dp_over_model`): the model axis carrying batch blocks
where the train state fits a rank at fsdp-only sharding and the batch
divides the layout, else tensor parallel over it; `--tensor-parallel`
takes the tensor-parallel posture (`dp_over_model=False`) whatever fits:

    PYTHONPATH=src python -m repro_torch.launch.lm_train --data 2 --model 2 --device cpu \
        --tensor-parallel

A checkpoint is the whole state, brought
to rank 0's host (`sharding.rules.gather_tree_to_host`); a resume restores it on
every rank and keeps the rank's blocks (`runtime.failures.reshard`), so it
may resume on another layout.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, List, Optional

import torch

from repro_torch import device as _device


def config(arch: str, preset: str):
    from repro_torch import configs
    base = configs.get(arch)
    if preset == "100m":
        return dataclasses.replace(base.reduced(layers=12, d_model=512, vocab=32_000),
                                   name=base.name + "-100m", d_ff=2048)
    return base.reduced(layers=2, d_model=128, vocab=512)


def train_loop(step_fn, model, state, batch_of: Callable[[int], dict], start: int, steps: int,
               save: Optional[Callable] = None, log: Callable[[str], None] = print) -> List[float]:
    """Steps `start`..`steps-1`: each step's batch from `batch_of(i)`, a line
    every 10 steps, `save(state, step)` every 50; returns the losses."""
    from repro_torch.runtime.failures import StragglerMonitor
    mon = StragglerMonitor(window=50, threshold=3.0)
    losses = []
    t0 = time.time()
    for i in range(start, steps):
        batch = batch_of(i)
        with mon.timed(i):
            state, metrics = step_fn(model, state, batch)
            loss = float(metrics["loss"])
        losses.append(loss)
        if i % 10 == 0 or i == steps - 1:
            log(f"step {i:5d}  loss={loss:.4f}  "
                f"gnorm={float(metrics['grad_norm']):.3f}  "
                f"lr={float(metrics['lr']):.2e}  ({time.time() - t0:.1f}s)")
        if save is not None and (i + 1) % 50 == 0:
            save(state, i + 1)
    if mon.events:
        log(f"straggler steps flagged: {[e.step for e in mon.events]}")
    return losses


@dataclasses.dataclass
class TrainJob:
    """Training on the ranks of an LM layout (`run_ranks(..., lm=(D, M))`)."""
    arch: str
    preset: str
    steps: int
    batch: int
    seq: int
    lr: float
    ckpt_dir: str = ""
    tensor_parallel: bool = False

    def run(self, mesh, device) -> dict:
        from repro_torch.checkpoint.manager import CheckpointManager, latest_step
        from repro_torch.data.pipeline import DataConfig, make_batch
        from repro_torch.launch import steps
        from repro_torch.models import model as M
        from repro_torch.optim import adamw
        from repro_torch.sharding import rules
        cfg = config(self.arch, self.preset)
        opt_cfg = adamw.OptConfig(peak_lr=self.lr, warmup_steps=20, total_steps=self.steps)
        log = print if mesh.rank == 0 else (lambda _: None)
        dp = not self.tensor_parallel and steps.use_dp_over_model(cfg, mesh, self.batch)
        log(f"arch={cfg.name} batch={self.batch} seq={self.seq} layout {mesh.shape} "
            f"({device}), {'dp_over_model' if dp else 'tensor parallel over model'}")
        whole = steps.init_train_state(M.init_params(cfg, 0, device), opt_cfg)
        mgr, start, save = None, 0, None
        if self.ckpt_dir:
            mgr = CheckpointManager(self.ckpt_dir, keep=2, async_save=False)
            if latest_step(self.ckpt_dir) is not None:
                whole, start = mgr.restore(whole)
                log(f"resumed at step {start}")
            specs = steps.state_shardings(mesh, cfg, opt_cfg, dp_over_model=dp)

            def save(state, step):
                host = rules.gather_tree_to_host(specs, state, group_of=mesh.group,
                                                 coords=mesh.coords)
                if host is not None:
                    mgr.save(host, step)
        state = steps.shard_state(mesh, whole, dp_over_model=dp)
        del whole
        data = DataConfig(seed=0)
        losses = train_loop(
            steps.make_train_step(cfg, opt_cfg, remat=True, mesh=mesh, dp_over_model=dp),
            M.LMModel(cfg, None, "meta"), state,
            lambda i: steps.shard_batch(mesh, make_batch(cfg, data, i, self.batch, self.seq,
                                                         device), dp),
            start, self.steps, save, log)
        if mgr is not None:
            mgr.close()
        return dict(losses=losses)


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
    ap.add_argument("--data", type=int, default=0,
                    help="train on a data x model layout of ranks (0: one device, no layout)")
    ap.add_argument("--model", type=int, default=1, help="model axis size of the layout")
    ap.add_argument("--tensor-parallel", action="store_true",
                    help="on a layout: tensor parallel over the model axis (dp_over_model=False) "
                         "whether or not the state fits a rank at fsdp-only sharding")
    args = ap.parse_args(argv)

    if args.data:
        from repro_torch.launch.distributed import run_ranks
        job = TrainJob(args.arch, args.preset, args.steps, args.batch, args.seq, args.lr,
                       args.ckpt_dir, args.tensor_parallel)
        run_ranks(args.data * args.model, [job], args.device, timeout_s=24 * 3600.0,
                  lm=(args.data, args.model))
        return

    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch.steps import bind, init_train_state, make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    dev = _device.resolve(args.device)
    cfg = config(args.arch, args.preset)
    opt_cfg = adamw.OptConfig(peak_lr=args.lr, warmup_steps=20, total_steps=args.steps)
    model = M.init_params(cfg, 0, dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M batch={args.batch} seq={args.seq} "
          f"device={dev}")

    state = init_train_state(model, opt_cfg)
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

    train_loop(make_train_step(cfg, opt_cfg, remat=False), model, state,
               lambda i: make_batch(cfg, data, i, args.batch, args.seq, dev), start, args.steps,
               None if mgr is None else mgr.save)
    if mgr is not None:
        mgr.wait()
        mgr.close()


if __name__ == "__main__":
    main()
