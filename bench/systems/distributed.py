"""The system under test of the `distributed` kind: one network cut over the
ranks of the port's distributed engine (`DistributedPlasticityEngine`),
one rank a card, driven in episodes of update intervals.

The harness (`bench/run.py`) calls, for one run of a cell:

    measure(cell, seed, seconds, trace, device, started) -> window
        spawns the configuration's ranks through the port's launcher
        (`launch.distributed.run_ranks`, rank r on card r), each running
        `harness/ranks.py`'s `RankJob`: set-up, the warm-up, the timed
        window; the ranks' captures of the checked intervals reach this
        process's host through pipes, and the ranks exit; raises
        SystemExit, and gives no result, if any rank loaded jax, jaxlib,
        flax or the JAX package;
    end_to_end(window) -> {metric: value}   (`ensemble`'s, with K = 1)
    context(window) -> what each per-layer reader's `read` gets: rank 0's
        profile of the traced intervals (with the collectives' `dist.*`
        ranges), rank 0's counters per chunk kind, the rank count and the
        fullest card's peak;
    judge(window, seed, device) -> the comparison with the plain reference
        (`reference/network.py`, the whole network in blocks on one card,
        once the ranks are gone: its host set-up too, so that it takes
        nothing from the ranks' set-up or window).  The reference sorts the
        positions itself; a rank whose engine holds them in another order
        fails every checked interval.

Two intervals in a row are checked, drawn from the seed before the window
opens among its first `PLAN`, so that only their states are kept: the
first one's start (drawn again from the seed at an episode's start, else
the program's state before it) and both ends.  The three numbers are the
`ensemble` system's (`harness/check.py`); the synapses are compared slot
by slot first and as multisets of (src, dst) over the slots that differ,
which counts what the multiset gap of the whole tables counts.

A program whose launcher puts every rank on one card
(`launch.distributed.rank_device` missing) cannot run the cell: `measure`
raises before spawning anything.
"""
from __future__ import annotations

import gc
import sys
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from bench.harness import check as ck
from bench.harness import ranks as rk
from bench.harness import spec, traffic as tr
from bench.reference import network as net_ref
from bench.reference import neurons as nr
from bench.reference import update as ur
from bench.reference.streams import CounterDraws

PLAN = 6               # the checked pair is drawn among the window's first PLAN intervals
RUN_TIMEOUT_S = 1500.0
COLLECTIVE_TIMEOUT_S = 600.0


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def checked_pair(seed: int) -> tuple:
    """Two intervals in a row, (j, j + 1), j drawn from the seed in [0, PLAN - 1)."""
    j = tr.checked_intervals(seed, PLAN - 1, 1)[0]
    return (j, j + 1)


class Checked(NamedTuple):
    episode: int
    step0: int
    records: np.ndarray           # (steps, 4) the program's records
    pre: Optional[List[dict]]     # each rank's part of the start (None: the episode's start)
    post: List[dict]              # each rank's part of the end


class Window(NamedTuple):
    config: dict
    traffic: dict
    root: str
    ranks: int
    digests: List[str]            # each rank's `ranks.digest` of its sorted positions
    intervals: int
    kept: List[Checked]           # the checked intervals (`checked_pair`)
    act: List[tuple]
    upd: List[tuple]
    setup_s: float
    peak_bytes: int
    profile: Optional[dict]
    counts: Optional[dict]
    reference: Dict[str, object]  # the reference's network (`reference_net`)


def _require_rank_per_card() -> None:
    from repro_torch.launch import distributed as launch
    if not hasattr(launch, "rank_device"):
        raise SystemExit("bench: this program's launcher puts every rank on one card "
                         "(no launch.distributed.rank_device); the cell needs one rank a card")


def measure(cell: spec.Cell, seed: int, seconds: float, trace: bool, device="cuda",
            started: float | None = None) -> Window:
    started = time.time() if started is None else started
    _require_rank_per_card()
    import multiprocessing as mp
    from repro_torch.launch.distributed import run_ranks
    config, traffic = cell.config, cell.traffic
    dev = torch.device(device)
    world = int(config["distributed"]["ranks"])
    if sum(traffic["chunks"]) != config["update_interval"]:
        raise ValueError(f"chunks {traffic['chunks']} do not add up to the update interval")
    if traffic["episode_steps"] % config["update_interval"]:
        raise ValueError("episode_steps is no multiple of the update interval")
    point = {"sigma": config["sigma"], "inhibitory_fraction": config["engine"]["inhibitory_fraction"]}
    if [{**point, **p} for p in tr.grid(traffic)] != [point]:
        raise ValueError(f"the distributed system runs one network, at the configuration's "
                         f"{point}; the mix asks for {tr.grid(traffic)}")
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.compile_library()        # once, before the ranks load it
    log(f"imports done {time.time() - started:.2f} s after the process started")
    checked = checked_pair(seed)
    ctx = mp.get_context("spawn")
    pipes = [ctx.Pipe(duplex=False) for _ in range(world)]
    got: List[Optional[tuple]] = [None] * world
    reference: Dict[str, object] = {}
    lock = threading.Lock()

    def window_over():
        # Every rank's window is over once every header has come: the
        # reference's static part is built while the captures come.
        with lock:
            reference["headers"] = reference.get("headers", 0) + 1
            if reference["headers"] == world:
                reference["thread"] = threading.Thread(
                    target=_prepare_reference, args=(reference, config, seed, dev), daemon=True)
                reference["thread"].start()

    def receive(r):
        got[r] = rk.receive(pipes[r][0], window_over)
    readers = [threading.Thread(target=receive, args=(r,), daemon=True) for r in range(world)]
    for t in readers:
        t.start()
    job = rk.RankJob(root=str(cell.root), config=config, traffic=traffic, seed=seed,
                     seconds=seconds, trace=trace, checked=checked,
                     senders=[w for _, w in pipes])
    res, = run_ranks(world, [job], dev.type, RUN_TIMEOUT_S, COLLECTIVE_TIMEOUT_S, ensemble=1)
    for t in readers:
        t.join()
    ended = time.time()
    loaded = sorted({name for _, meta in got for name in meta["loaded"]})
    if loaded:
        raise SystemExit(f"bench: a rank loaded {loaded} (jax, jaxlib, flax or the JAX "
                         f"package); no result")
    digests = [meta["positions"] for _, meta in got]
    got = [parts for parts, _ in got]
    m = res["marks"]
    log(f"ranks spawned and started {res['begun'] - started:.2f} s after the process started; "
        f"positions drawn {m['positions_drawn']:.2f} s, engine built {m['engine_built']:.2f} s, "
        f"warmed up {m['warmed_up']:.2f} s after the rank began; start draws "
        f"{[round(x, 2) for x in m['episode_draw_s']]} s")
    log(f"chunks (steps, s): activity {[(a, round(b, 4)) for a, b in res['act']]}, "
        f"update {[(a, round(b, 4)) for a, b in res['upd']]}")
    log(f"window: {len(res['synapses'])} intervals, episodes 1..{res['episodes']}, synapses "
        f"at the intervals' ends {res['synapses']}; peak per card {res['peaks']}; window "
        f"to the ranks' exit {ended - res['window_start']:.1f} s: window "
        f"{res['window_end'] - res['window_start']:.1f} s (rank 0's untimed seconds in it "
        f"{m['window_untimed_s']}), then rank 0 freed its card in {m['freed_s']:.1f} s, sent "
        f"its captures in {m['sent_s']:.1f} s, and the ranks were gone "
        f"{ended - res['window_end']:.1f} s after the window")
    kept = []
    for k in res["kept"]:
        i = k["index"]
        pre = None
        if k["step0"] != 0:
            tag = f"pre{i}" if f"pre{i}" in got[0] else f"post{i - 1}"
            pre = [g[tag] for g in got]
        kept.append(Checked(episode=k["episode"], step0=k["step0"], records=k["records"],
                            pre=pre, post=[g[f"post{i}"] for g in got]))
    return Window(config=config, traffic=traffic, root=str(cell.root), ranks=world,
                  digests=digests, intervals=len(res["synapses"]), kept=kept,
                  act=res["act"], upd=res["upd"], setup_s=res["window_start"] - started,
                  peak_bytes=int(max(res["peaks"])), profile=res["profile"],
                  counts=res["counts"], reference=reference)


def end_to_end(w: Window) -> dict:
    act_steps, act_s = sum(s for s, _ in w.act), sum(t for _, t in w.act)
    upd_steps, upd_s = sum(s for s, _ in w.upd), sum(t for _, t in w.upd)
    step_s = act_s / act_steps
    return {
        "neuron_steps_per_s": w.config["n"] * (act_steps + upd_steps) / (act_s + upd_s),
        "activity_step_ms": step_s * 1e3,
        "update_ms": (upd_s - upd_steps * step_s) / len(w.upd) * 1e3,
        "setup_s": w.setup_s,
    }


def context(w: Window) -> dict:
    return {"profile": w.profile, "counts": w.counts, "ranks": w.ranks,
            "peak_bytes": w.peak_bytes}


# -- the comparison -----------------------------------------------------------------

def unpack_bits(bits: np.ndarray, device) -> torch.Tensor:
    """`ranks.pack_bits`' inverse, on `device`."""
    b = torch.as_tensor(bits, device=device).to(torch.int32)
    return ((b[:, None] >> torch.arange(8, device=device, dtype=torch.int32)) & 1).reshape(-1) > 0


def _table(parts: List[dict], capacity: int, device):
    """The whole edge table from the ranks' parts (each its slot range)."""
    per = capacity // len(parts)
    src = torch.zeros((capacity,), dtype=torch.int32, device=device)
    dst = torch.zeros((capacity,), dtype=torch.int32, device=device)
    valid = torch.zeros((capacity,), dtype=torch.bool, device=device)
    for r, part in enumerate(parts):
        v = unpack_bits(part["bits"], device)
        a = r * per
        valid[a:a + per] = v
        src[a:a + per][v] = torch.as_tensor(part["src"], device=device)
        dst[a:a + per][v] = torch.as_tensor(part["dst"], device=device)
    return ur.Edges(src=src, dst=dst, valid=valid)


def _neurons(parts: List[dict]) -> dict:
    return {f: np.concatenate([p["neurons"][f] for p in parts]) for f in ck.FIELDS}


def start(w: Window, seed: int, it: Checked, net: net_ref.Net, device):
    """The state a checked interval began from, on the device."""
    c = w.config
    n, cap = c["n"], c["engine"]["edge_capacity_per_neuron"] * c["n"]
    if it.pre is not None:
        f = _neurons(it.pre)
        nrn = nr.Neurons(*(torch.as_tensor(f[k], device=device) for k in ck.FIELDS))
        return nrn, _table(it.pre, cap, device)
    draw = spec._module("starts", w.traffic["start"]["generator"], spec.Path(w.root))
    lookup = draw.Lookup(net.positions, c["domain"])
    per, m = cap // w.ranks, n // w.ranks
    edges = ur.Edges(src=torch.zeros((cap,), dtype=torch.int32, device=device),
                     dst=torch.zeros((cap,), dtype=torch.int32, device=device),
                     valid=torch.zeros((cap,), dtype=torch.bool, device=device))
    indeg = torch.zeros((n,), dtype=torch.int32, device=device)
    fields = []
    for b in range(w.ranks):
        fb, src, dst = draw.draw_block(w.traffic["start"], rk.start_gens(seed, it.episode, b, device),
                                       net.positions, c["domain"], lookup, b, w.ranks)
        indeg += draw.in_degree(dst, n)
        k = src.shape[0]
        edges.src[b * per:b * per + k] = src
        edges.dst[b * per:b * per + k] = dst
        edges.valid[b * per:b * per + k] = True
        fields.append(fb)
    cat = lambda key: torch.cat([fb[key] for fb in fields])
    den = torch.cat([draw.den_elems(indeg[b * m:(b + 1) * m], fb["den_slack"])
                     for b, fb in enumerate(fields)])
    nrn = nr.Neurons(x=torch.full((n,), net.msp.x0, dtype=torch.float32, device=device),
                     refrac=torch.zeros((n,), dtype=torch.int32, device=device),
                     spiked=torch.zeros((n,), dtype=torch.bool, device=device),
                     calcium=cat("calcium"), ax_elems=cat("ax_elems"), den_elems=den)
    return nrn, edges


def synapses_differing(parts: List[dict], want: ur.Edges, n: int) -> float:
    """`check.synapses_differing` over the whole table, one rank's slot range
    at a time: the slots equal on both sides hold the same edge on both, so
    they leave the multiset gap as it is, and the gap is taken over the
    rest."""
    per = want.valid.shape[0] // len(parts)
    dev = want.valid.device
    got_rest, want_rest, total = [], [], 0
    for r, part in enumerate(parts):
        a = r * per
        gv = unpack_bits(part["bits"], dev)
        gs = torch.zeros((per,), dtype=torch.int32, device=dev)
        gd = torch.zeros((per,), dtype=torch.int32, device=dev)
        gs[gv] = torch.as_tensor(part["src"], device=dev)
        gd[gv] = torch.as_tensor(part["dst"], device=dev)
        ws, wd, wv = want.src[a:a + per], want.dst[a:a + per], want.valid[a:a + per]
        same = gv & wv & (gs == ws) & (gd == wd)
        g_only, w_only = gv & ~same, wv & ~same
        got_rest.append(gs[g_only].long() * n + gd[g_only].long())
        want_rest.append(ws[w_only].long() * n + wd[w_only].long())
        total += int(wv.sum())
        del gv, gs, gd, same
    return ck.multiset_gap(torch.cat(got_rest), torch.cat(want_rest)) / max(total, 1)


def _as_parts(edges: ur.Edges, nrn: nr.Neurons, ranks: int) -> List[dict]:
    """A reference state cut as the ranks' captures are (for the control)."""
    per = edges.valid.shape[0] // ranks
    m = nrn.x.shape[0] // ranks
    out = []
    for r in range(ranks):
        sl = slice(r * per, (r + 1) * per)
        v = edges.valid[sl]
        out.append(dict(bits=rk.pack_bits(v), src=edges.src[sl][v].cpu().numpy(),
                        dst=edges.dst[sl][v].cpu().numpy(), dropped=0,
                        neurons={f: getattr(nrn, f)[r * m:(r + 1) * m].cpu().numpy()
                                 for f in ck.FIELDS}))
    return out


def _prepare_reference(out: dict, config: dict, seed: int, device) -> None:
    """The reference's network of a run into `out` ("net", and "digest" of
    its sorted positions), or the error ("error"): the positions drawn again
    from the seed, sorted by the reference, and their octree built on
    `device` (`network.sorted_tree`)."""
    try:
        t = time.time()
        c = config
        pos, tree = net_ref.sorted_tree(tr.positions(seed, c["n"], c["domain"]), c["domain"],
                                        device)
        out["digest"] = rk.digest(pos)
        out["net"] = net_ref.build(c, pos, device, c["sigma"], tree)
        out["built_s"] = time.time() - t
    except BaseException as e:       # raised again by `reference_net`
        out["error"] = e


def reference_net(w: Window, seed: int, device) -> net_ref.Net:
    """The reference's network of the run: built by `measure` once every
    rank's window is over (while the captures come), else here.  Notes in
    `w.reference` whether every rank's engine held the positions in the
    reference's order."""
    ref = w.reference
    if "order_agrees" not in ref:
        t = time.time()
        if "thread" in ref:
            ref["thread"].join()
        elif "net" not in ref:
            _prepare_reference(ref, w.config, seed, device)
        if "error" in ref:
            raise ref["error"]
        ref["order_agrees"] = all(d == ref["digest"] for d in w.digests)
        log(f"the reference's positions and octree in {ref['built_s']:.1f} s, ready "
            f"{time.time() - t:.1f} s after the ranks were gone; the ranks' order "
            f"{'agrees' if ref['order_agrees'] else 'DIFFERS'}")
    return ref["net"]


def compare(w: Window, seed: int, device, control: bool = False) -> List[dict]:
    """The three numbers of each checked interval; the reference runs on
    `device` (the first card) after the ranks have exited.  control: the
    reference computed in bfloat16 stands in for the program."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    c = w.config
    net = reference_net(w, seed, dev)
    out = []
    for it in w.kept:
        t = time.time()
        draws = CounterDraws(tr.noise_seed(seed, it.episode, 0))
        steps = it.records.shape[0]
        if control:
            nrn, edges = start(w, seed, it, net, dev)
            low = net_ref.run_interval(net, nrn, edges, draws, it.step0, steps, torch.bfloat16)
            del nrn, edges
            post = _as_parts(low.edges, low.neurons, w.ranks)
            recs = ck.records_array(low.records)
            del low
        else:
            post, recs = it.post, it.records
        gc.collect()
        nrn, edges = start(w, seed, it, net, dev)
        want = net_ref.run_interval(net, nrn, edges, draws, it.step0, steps)
        del nrn, edges
        every = c["update_interval"]
        first_update = next((i for i in range(steps) if (it.step0 + i + 1) % every == 0), steps)
        out.append({
            "neuron_rows_differing": ck.rows_differing(_neurons(post), want.neurons),
            "records_differing": ck.records_differing(recs, ck.records_array(want.records),
                                                      first_update),
            "synapses_differing": synapses_differing(post, want.edges, c["n"])})
        del want
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        log(f"interval (episode {it.episode}, step {it.step0}) against the reference"
            f"{' in bfloat16' if control else ''}: {out[-1]} in {time.time() - t:.1f} s")
    return out


def judge(w: Window, seed: int, device) -> dict:
    limits = w.config["limits"]
    t = time.time()
    verdict = ck.judge(compare(w, seed, torch.device(device)), limits)
    if not w.reference["order_agrees"]:
        verdict["failed"] = verdict["checked"]
    log(f"compared {verdict['checked']} intervals with the reference in {time.time() - t:.2f} s")
    return dict(verdict, limits=limits, attempted=w.intervals)
