"""Batched LM serving: prefill a batch of prompts, then decode through the
caches (the port's counterpart of `examples/lm_serve.py`).

    PYTHONPATH=src python -m repro_torch.launch.lm_serve --arch yi-6b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.lm_serve --arch mamba2-1.3b  # the card

`generate` is the flow: `make_cache`, the prefill step, the first token,
then one decode step per further token.  It times each stage on the
device's clock (CUDA events on the card, the host clock on the CPU).
`score` runs the same steps on a given continuation (teacher forcing), for
holding the decode path against `forward_train`.  Both run under
`torch.inference_mode()`: serving builds no autograd graph.
"""
from __future__ import annotations

import argparse
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


@torch.inference_mode()
def generate(model: M.LMModel, prompts: torch.Tensor, new_tokens: int,
             temperature: float = 0.0, gen: Optional[torch.Generator] = None) -> Generated:
    """Prefill `prompts` (B, S) into caches of S + new_tokens positions and
    generate `new_tokens` tokens for each row."""
    cfg = model.cfg
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} is encoder-only: no decode path")
    if temperature and gen is None:
        raise ValueError("sampling needs an explicit torch.Generator")
    b, s = prompts.shape
    dev = prompts.device
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    caches = M.make_cache(cfg, b, s + new_tokens, dev)
    clock = _Clock(dev)

    if clock.cuda:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    m0 = clock.mark()
    logits, caches = prefill(model, caches, {"inputs": prompts})
    m1 = clock.mark()
    finite = torch.isfinite(logits).all()
    tok = _pick(logits[:, -1], temperature, gen)
    out = [tok]
    tok.cpu()                                        # the client has its first token
    first_token_ms = (time.perf_counter() - t0) * 1e3
    marks = [clock.mark()]
    for i in range(new_tokens - 1):
        logits, caches = decode(model, caches, {"token": tok, "cache_pos": s + i})
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
def score(model: M.LMModel, tokens: torch.Tensor, prompt_len: int) -> list:
    """Prefill tokens[:, :prompt_len], then decode each later token through
    the caches: the float32 logits (B, V) of the 1 + T - prompt_len steps,
    the i-th predicting position prompt_len + i."""
    cfg = model.cfg
    b, t = tokens.shape[:2]
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    caches = M.make_cache(cfg, b, t, tokens.device)
    logits, caches = prefill(model, caches, {"inputs": tokens[:, :prompt_len]})
    out = [logits[:, -1]]
    for pos in range(prompt_len, t):
        logits, caches = decode(model, caches, {"token": tokens[:, pos:pos + 1],
                                                "cache_pos": pos})
        out.append(logits[:, 0])
    return out


def main(argv=None) -> None:
    from repro_torch import configs
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = _device.resolve(args.device)
    cfg = configs.get(args.arch).reduced()
    model = M.init_params(cfg, 0, dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator(device=dev).manual_seed(1),
                            device=dev, dtype=torch.int32)
    res = generate(model, prompts, args.tokens, args.temperature, gen)
    print(f"prefill: batch={args.batch} len={args.prompt_len} in {res.prefill_ms:.1f} ms")
    total = sum(res.step_ms)
    print(f"decode: {args.tokens} tokens x {args.batch} seqs, {len(res.step_ms)} steps in "
          f"{total:.1f} ms ({len(res.step_ms) * args.batch / max(total, 1e-9) * 1e3:.1f} tok/s)")
    for row in range(args.batch):
        print(f"  seq{row}: {res.tokens[row, :16].tolist()} ...")


if __name__ == "__main__":
    main()
