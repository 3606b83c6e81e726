"""Batched LM serving: prefill a batch of prompts, then decode through the
caches (the port's counterpart of `examples/lm_serve.py`).

    PYTHONPATH=src python -m repro_torch.launch.lm_serve --arch yi-6b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.lm_serve --arch mamba2-1.3b  # the card
    PYTHONPATH=src python -m repro_torch.launch.lm_serve --data 2 --model 2 --device cpu

`generate` is the flow: `make_cache`, the prefill step, the first token,
then one decode step per further token.  It times each stage on the
device's clock (CUDA events on the card, the host clock on the CPU).
`score` runs the same steps on a given continuation (teacher forcing), for
holding the decode path against `forward_train`.  Both run under
`torch.inference_mode()`: serving builds no autograd graph.

With `mesh=` (an `LMGroups` layout; every rank calls with the same whole
prompts) they serve the rank's blocks (`steps.shard_params`) through the
layout's steps: each step's logit blocks are gathered whole on every rank
(`steps.gather_logits`), the tokens picked from them as one device picks
them, and each rank keeps its rows, so every rank draws the same tokens
from the same generator.  `--data D --model M` serves on a D x M layout of
spawned ranks (`launch.distributed.run_ranks`; NCCL, one card a rank, or
gloo with `--device cpu`) and holds the tokens against one device's.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import NamedTuple, Optional

import torch

from repro_torch import device as _device
from repro_torch.launch import steps
from repro_torch.models import model as M


class Generated(NamedTuple):
    tokens: torch.Tensor        # (B, new_tokens) int32: the first token, then one per step
    prefill_ms: float           # the prefill step
    first_token_ms: float       # prefill and the first token, on the host
    step_ms: list               # each decode step
    all_finite: bool            # every logit of every step was finite


class _Clock:
    """Marks on the device's timeline: CUDA events on the card; on the CPU,
    which has finished each op when it returns, the host clock."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def _pick(logits: torch.Tensor, temperature: float, gen: Optional[torch.Generator]):
    """(B, V) f32 logits -> (B, 1) int32: greedy at temperature 0, else a
    draw from softmax(logits / temperature) with `gen`."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen).to(torch.int32)


class _Serve:
    """The steps, caches and batch rows of one serving run: on one device,
    or this rank's part on a layout (whole logits from every rank's
    blocks, the rank's rows of a whole batch)."""

    def __init__(self, cfg, batch: int, max_seq: int, dev, mesh=None):
        self.cfg, self.batch, self.mesh = cfg, batch, mesh
        self.prefill = steps.make_prefill_step(cfg, mesh)
        self.decode = steps.make_decode_step(cfg, mesh)
        self.caches = (M.make_cache(cfg, batch, max_seq, dev) if mesh is None
                       else steps.make_cache(mesh, cfg, batch, max_seq))

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.mesh is None else steps.shard_batch(self.mesh, {"x": x})["x"]

    def whole(self, logits: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return logits
        return steps.gather_logits(self.mesh, self.cfg, logits, self.batch)


@torch.inference_mode()
def generate(model: M.LMModel, prompts: torch.Tensor, new_tokens: int,
             temperature: float = 0.0, gen: Optional[torch.Generator] = None,
             mesh=None) -> Generated:
    """Prefill `prompts` (B, S) into caches of S + new_tokens positions and
    generate `new_tokens` tokens for each row.  mesh: serve the rank's
    blocks (`model` from `steps.shard_params`) on that layout; the tokens
    are every row's, on every rank."""
    cfg = model.cfg
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} is encoder-only: no decode path")
    if temperature and gen is None:
        raise ValueError("sampling needs an explicit torch.Generator")
    b, s = prompts.shape
    dev = prompts.device
    run = _Serve(cfg, b, s + new_tokens, dev, mesh)
    clock = _Clock(dev)

    if clock.cuda:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    m0 = clock.mark()
    logits, caches = run.prefill(model, run.caches, {"inputs": run.rows(prompts)})
    m1 = clock.mark()
    logits = run.whole(logits)
    finite = torch.isfinite(logits).all()
    tok = _pick(logits[:, -1], temperature, gen)
    out = [tok]
    tok.cpu()                                        # the client has its first token
    first_token_ms = (time.perf_counter() - t0) * 1e3
    marks = [clock.mark()]
    for i in range(new_tokens - 1):
        logits, caches = run.decode(model, caches, {"token": run.rows(tok), "cache_pos": s + i})
        logits = run.whole(logits)
        finite &= torch.isfinite(logits).all()
        tok = _pick(logits[:, 0], temperature, gen)
        out.append(tok)
        marks.append(clock.mark())
    tokens = torch.cat(out, dim=1)
    if clock.cuda:
        torch.cuda.synchronize(dev)
    return Generated(tokens, clock.ms(m0, m1), first_token_ms,
                     [clock.ms(a, b) for a, b in zip(marks, marks[1:])], bool(finite))


@torch.inference_mode()
def score(model: M.LMModel, tokens: torch.Tensor, prompt_len: int, mesh=None) -> list:
    """Prefill tokens[:, :prompt_len], then decode each later token through
    the caches: the float32 logits (B, V) of the 1 + T - prompt_len steps,
    the i-th predicting position prompt_len + i (whole on every rank of
    `mesh`, as `generate`)."""
    cfg = model.cfg
    b, t = tokens.shape[:2]
    run = _Serve(cfg, b, t, tokens.device, mesh)
    tokens = run.rows(tokens)
    logits, caches = run.prefill(model, run.caches, {"inputs": tokens[:, :prompt_len]})
    out = [run.whole(logits)[:, -1]]
    for pos in range(prompt_len, t):
        logits, caches = run.decode(model, caches, {"token": tokens[:, pos:pos + 1],
                                                    "cache_pos": pos})
        out.append(run.whole(logits)[:, 0])
    return out


@dataclasses.dataclass
class ServeJob:
    """`generate` on the ranks of an LM layout (`run_ranks(..., lm=(D, M))`)
    from the seeded model and prompts, against one device's tokens."""
    arch: str
    batch: int
    prompt_len: int
    tokens: int
    temperature: float

    def run(self, mesh, device) -> dict:
        cfg = config(self.arch)
        model, prompts = seeded(cfg, self.batch, self.prompt_len, device)
        one = generate(model, prompts, self.tokens, self.temperature, _draws(device))
        blocks = steps.shard_params(mesh, cfg, model)
        del model
        res = generate(blocks, prompts, self.tokens, self.temperature, _draws(device), mesh)
        if mesh.rank == 0:
            print(f"layout {mesh.shape} ({device})")
            report(self.batch, self.prompt_len, self.tokens, res)
            same = torch.equal(res.tokens, one.tokens)
            print(f"tokens {'equal to' if same else 'DIFFERENT from'} one device's")
        return dict(tokens=res.tokens.cpu(), single=one.tokens.cpu())


def config(arch: str):
    from repro_torch import configs
    return configs.get(arch).reduced()


def seeded(cfg, batch: int, prompt_len: int, dev):
    """The demo's model (seed 0) and prompts (seed 1) on `dev`."""
    model = M.init_params(cfg, 0, dev)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=torch.Generator(device=dev).manual_seed(1),
                            device=dev, dtype=torch.int32)
    return model, prompts


def _draws(dev) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(2)


def report(batch: int, prompt_len: int, tokens: int, res: Generated) -> None:
    print(f"prefill: batch={batch} len={prompt_len} in {res.prefill_ms:.1f} ms")
    total = sum(res.step_ms)
    print(f"decode: {tokens} tokens x {batch} seqs, {len(res.step_ms)} steps in "
          f"{total:.1f} ms ({len(res.step_ms) * batch / max(total, 1e-9) * 1e3:.1f} tok/s)")
    for row in range(batch):
        print(f"  seq{row}: {res.tokens[row, :16].tolist()} ...")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data", type=int, default=0,
                    help="serve on a data x model layout of ranks (0: one device, no layout)")
    ap.add_argument("--model", type=int, default=1, help="model axis size of the layout")
    args = ap.parse_args(argv)

    if args.data:
        from repro_torch.launch.distributed import run_ranks
        job = ServeJob(args.arch, args.batch, args.prompt_len, args.tokens, args.temperature)
        res = run_ranks(args.data * args.model, [job], args.device, timeout_s=3600.0,
                        lm=(args.data, args.model))[0]
        if not torch.equal(res["tokens"], res["single"]):
            raise SystemExit("the layout's tokens differ from one device's")
        return

    dev = _device.resolve(args.device)
    cfg = config(args.arch)
    model, prompts = seeded(cfg, args.batch, args.prompt_len, dev)
    res = generate(model, prompts, args.tokens, args.temperature, _draws(dev))
    report(args.batch, args.prompt_len, args.tokens, res)


if __name__ == "__main__":
    main()
