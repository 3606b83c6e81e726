#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch/`) on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Phases; each raises on failure, so the script exits 0 only if all pass:

1. build   — compile every kernel of the main path from `src/repro_torch/
             kernels/csrc/` (one nvcc per source, all at once) and print
             nvcc's register and spill report;
2. kernels — each CUDA kernel against its plain PyTorch version on the card
             at main-path shapes (msp_update bit for bit at n = 2^20;
             m2l_separable to 1e-5 x max|plain| at B = 2^21 and small B),
             then timed (launches replayed from a CUDA graph, CUDA events)
             beside its bound;
3. small   — the main path at N = 256 on the card (kernels) and on the CPU
             (plain versions) from the same draws: identical trajectories
             (this also loads the path's CUDA modules before phase 4);
4. main    — `PlasticityEngine.simulate` with method="fmm" at 2^20 neurons
             (positions U(0, 2190 um)^3, about 1e5 neurons/mm^3), paper
             FMMConfig (c1 = c2 = 70, sigma = 750), calibrated MSP at
             speedup 100, from a seeded mid-growth state, 300 steps (three
             connectivity updates); run twice, the edge tables must match;
5. fig1    — n = 4096, 3000 steps, c1 = c2 = 8 from a cold start: mean
             calcium rises toward eps = 0.7 and synapses form.

It prints the card's `nvidia-smi` name and power limit, a `{"kernels": ...}`
line, and as its last line `{"ok": true, "device": {...}}`.  Without a CUDA
card it exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
FP32_FLOP_PER_S = 67e12            # H100 SXM float32 outside the tensor cores
M2L_FLOP_PER_PAIR = 1647           # Hermite 48, 1/beta! 64, modes 1344, dot 191
MSP_BYTES_PER_NEURON = 20 + 13     # reads x, refrac, ca, syn, u; writes 3x4 + 1
MSP_OPS_PER_NEURON = 13            # 3 fma (2 each), sub, add, mul, 2 compares,
                                   # and, 2 selects, sub/max
M2L_BYTES_PER_PAIR = (64 + 64 + 3 + 1) * 4


def log(msg: str) -> None:
    print(msg, flush=True)


def event_ms(fn, reps: int) -> float:
    """Mean time of fn() over reps back-to-back calls, by CUDA events, after a
    warm-up call.  Includes the host's launch cost where that exceeds the
    device time, so it times the plain versions (many launches of their own)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Device time of one fn() (a kernel launch): reps calls captured in a
    CUDA graph and replayed, so the Python wrapper's cost between launches
    is not timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_name(bytes_ms: float, ops_ms: float) -> str:
    return "bytes" if bytes_ms >= ops_ms else "operations"


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    _, report = build.compile_library(verbose=True)
    build.library()
    log(f"[build] {len(build.sources())} sources in {time.perf_counter() - t0:.1f} s")
    for line in report.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line \
                or "Compiling entry" in line:
            log(f"[build]   {line.strip()}")


def msp_inputs(n: int, gen: torch.Generator, dev) -> list:
    u = lambda lo, hi: torch.empty(n, device=dev).uniform_(lo, hi, generator=gen)
    i = lambda hi: torch.randint(0, hi, (n,), generator=gen, device=dev)
    return [u(0, 0.2), i(5).to(torch.int32), u(0, 1), i(4).to(torch.float32), u(0, 1)]


def phase_kernels(seed: int) -> dict:
    """Kernel vs plain version at main-path shapes, then timings."""
    from repro_torch.core.msp import MSPConfig
    from repro_torch.kernels import m2l_pair, msp_update as kmsp
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}

    # msp_update: bitwise at n = 2^20.  Timed over 4 input sets (84 MB of
    # inputs, more than the 50 MB L2) in turn, so each launch finds its
    # inputs cold.
    n = 1 << 20
    k = kmsp.constants(MSPConfig.calibrated(speedup=100.0))
    sets = [msp_inputs(n, gen, dev) for _ in range(4)]
    got = kmsp.msp_update_cuda(*sets[0], k)
    want = kmsp.msp_update_plain(*sets[0], k)
    torch.cuda.synchronize()
    for name, g, w in zip(("x", "refrac", "spiked", "calcium"), got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"msp_update kernel != plain on {name}: "
                                 f"{int((g != w).sum())} of {n} differ")
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    turn = iter(range(1 << 30))
    ms = graph_ms(lambda: kmsp.msp_update_cuda(*sets[next(turn) % 4], k), 200)
    plain_ms = event_ms(lambda: kmsp.msp_update_plain(*sets[next(turn) % 4], k), 20)
    bound_bytes = n * MSP_BYTES_PER_NEURON / HBM_BYTES_PER_S * 1e3
    bound_ops = n * MSP_OPS_PER_NEURON / FP32_FLOP_PER_S * 1e3
    bound, by = max(bound_bytes, bound_ops), bound_name(bound_bytes, bound_ops)
    log(f"[kernels] msp_update n={n}: bitwise equal; {ms * 1e3:.2f} us "
        f"(bound {bound * 1e3:.2f} us, {by}), plain {plain_ms * 1e3:.1f} us")
    out["msp_update"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                             bound_by=by)
    del sets, got, want

    # m2l_separable: at B = 2^21 pairs (about the leaf level of 2^20
    # neurons) and at small ragged B.
    ratios = {}
    for b in (1, 63, 700, 1 << 21):
        moms = torch.empty((b, 64), device=dev).uniform_(0, 1, generator=gen)
        herm = torch.empty((b, 64), device=dev).uniform_(-1, 1, generator=gen)
        y = torch.empty((b, 3), device=dev).uniform_(-1.5, 1.5, generator=gen)
        got = m2l_pair.m2l_separable_cuda(moms, herm, y)
        want = m2l_pair.m2l_separable_plain(moms, herm, y)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"m2l_separable kernel: non-finite output at B={b}")
        err = float((got - want).abs().max())
        ratios[b] = err / float(want.abs().max())
        if ratios[b] > 1e-5:
            raise AssertionError(f"m2l_separable kernel vs plain at B={b}: "
                                 f"max|k-plain|/max|plain| = {ratios[b]:.3e} > 1e-5")
    ms = graph_ms(lambda: m2l_pair.m2l_separable_cuda(moms, herm, y), 50)
    plain_ms = event_ms(lambda: m2l_pair.m2l_separable_plain(moms, herm, y), 5)
    b = moms.shape[0]
    bound_bytes = b * M2L_BYTES_PER_PAIR / HBM_BYTES_PER_S * 1e3
    bound_ops = b * M2L_FLOP_PER_PAIR / FP32_FLOP_PER_S * 1e3
    bound, by = max(bound_bytes, bound_ops), bound_name(bound_bytes, bound_ops)
    log("[kernels] m2l_separable max|k-plain|/max|plain|: "
        + ", ".join(f"B={bb}: {r:.3e}" for bb, r in ratios.items()) + " (limit 1e-5)")
    log(f"[kernels] m2l_separable B={b}: {ms:.4f} ms (bound {bound:.4f} ms, {by}), "
        f"plain {plain_ms:.3f} ms")
    out["m2l_separable"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                bound_by=by)
    return out


def mid_growth(eng, seed: int):
    """eng.init_state() with calcium U(0.4, 0.7) and axonal and dendritic
    elements U(0, 6), drawn on the card from `seed`; no edges."""
    gen = torch.Generator(device=eng.device).manual_seed(seed)
    u = lambda lo, hi: torch.empty(eng.n, device=eng.device).uniform_(lo, hi, generator=gen)
    st = eng.init_state()
    return st._replace(neurons=st.neurons._replace(
        calcium=u(0.4, 0.7), ax_elems=u(0, 6), den_elems=u(0, 6)))


def count_tiers(cfg, counts: dict):
    """A wrapper of traversal._tier_log_masses that tallies which tier each
    (source box, target child) pair takes; used on the repeat run only."""
    from repro_torch.core import traversal
    inner = traversal._tier_log_masses

    def wrapped(child_ax_w, child_ax_c, child_gc, child_moms, tgt_den_w, tgt_den_c,
                tgt_gc, tgt_herm, cfg_, valid):
        pairs = tgt_den_w.numel()
        if valid:
            heavy_den = tgt_den_w > cfg.c1
            herm = int((heavy_den & (child_ax_w > cfg.c2)[:, None]).sum())
            tay = int(heavy_den.sum()) - herm
        else:
            herm = tay = 0
        counts["hermite"] += herm
        counts["taylor"] += tay
        counts["direct"] += pairs - herm - tay
        return inner(child_ax_w, child_ax_c, child_gc, child_moms, tgt_den_w, tgt_den_c,
                     tgt_gc, tgt_herm, cfg_, valid)
    return traversal, inner, wrapped


def phase_main(seed: int) -> dict:
    from repro_torch.core.engine import EngineConfig, PlasticityEngine
    from repro_torch.core.msp import MSPConfig
    from repro_torch.core.traversal import FMMConfig
    from repro_torch.kernels import ops
    n, domain, steps = 1 << 20, 2190.0, 300
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, domain, (n, 3)).astype(np.float32)
    msp_cfg = MSPConfig.calibrated(speedup=100.0)
    interval = msp_cfg.update_interval
    t0 = time.perf_counter()
    eng = PlasticityEngine(pos, msp_cfg, FMMConfig(), EngineConfig(domain=domain))
    torch.cuda.synchronize()
    log(f"[main] n={n} depth={eng.structure.depth} max_leaf={eng.structure.max_leaf} "
        f"edge slots={eng.edge_capacity}; set-up {time.perf_counter() - t0:.2f} s")

    def run():
        """300 steps through simulate, cut at the updates so each chunk can
        be timed: 99 activity steps, then the step whose update follows."""
        st = mid_growth(eng, seed)
        torch.cuda.synchronize()
        step_s, update_s, recs = [], [], []
        for _ in range(steps // interval):
            t = time.perf_counter()
            st, r1 = eng.simulate(st, interval - 1, seed=seed)
            torch.cuda.synchronize()
            step_s.append((time.perf_counter() - t) / (interval - 1))
            t = time.perf_counter()
            st, r2 = eng.simulate(st, 1, seed=seed)
            torch.cuda.synchronize()
            update_s.append(time.perf_counter() - t - step_s[-1])
            recs.append(torch.cat([r1.num_synapses, r2.num_synapses]))
        return st, torch.cat(recs), step_s, update_s

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    st, syn, step_s, update_s = run()
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    syn = syn.cpu().numpy()
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"main path launched no {name} kernel")
    if not syn[interval - 1] > 0:
        raise AssertionError("no synapse formed at the first connectivity update")
    if int(st.dropped) != 0:
        raise AssertionError(f"edge table overflowed: {int(st.dropped)} units dropped")
    for f, v in st.neurons._asdict().items():
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite {f}")
    log(f"[main] synapses after updates: {syn[interval - 1::interval].tolist()}; "
        f"dropped {int(st.dropped)}; launches {launches}")
    log(f"[main] step {np.mean(step_s) * 1e3:.3f} ms (per chunk "
        f"{[round(s * 1e3, 3) for s in step_s]}); connectivity update "
        f"{[round(s, 4) for s in update_s]} s; peak memory {peak / 2**30:.2f} GiB")

    counts = {"direct": 0, "hermite": 0, "taylor": 0}
    traversal, inner, wrapped = count_tiers(eng.fmm_cfg, counts)
    traversal._tier_log_masses = wrapped
    try:
        st2, syn2, _, _ = run()
    finally:
        traversal._tier_log_masses = inner
    for f in ("src", "dst", "valid"):
        if not torch.equal(getattr(st.edges, f), getattr(st2.edges, f)):
            raise AssertionError(f"two same-seed runs differ in the edge table ({f})")
    log(f"[main] repeat run: identical edge tables; tier pairs over "
        f"{steps // interval} updates: {counts}")

    # Where the time goes: profile 5 activity steps (300..304), then the step
    # whose update follows (399 -> 400), each by layer (record_function).
    profiles = {}
    for label, skip, window in (("activity x5", 0, 5), ("update step", 94, 1)):
        st, _ = eng.simulate(st, skip, seed=seed)
        torch.cuda.synchronize()
        holder = {}

        def go():
            holder["st"], _ = eng.simulate(st, window, seed=seed)
        profiles[label] = profile_window(go)
        st = holder["st"]
        log(f"[profile] {label}: " + json.dumps(profiles[label]))
    return dict(launches=launches, step_ms=float(np.mean(step_s)) * 1e3,
                update_s=update_s, peak_gib=peak / 2**30, tiers=counts, profiles=profiles)


def profile_window(fn) -> dict:
    """torch.profiler over fn(): wall time, device busy time (sum of kernel
    times), device time per layer range and the costliest operators."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    # Every kernel's time is the self device time of the one host-side event
    # (operator or range) that launched it; the device-side copies of the
    # ranges span idle gaps too and are left out.
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CPU) / 1e3
    layers = {e.key: round(e.device_time_total / 1e3, 3) for e in events
              if e.device_type == DeviceType.CPU
              and e.key.split(".")[0] in ("step", "update", "traversal")}
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and e.key.startswith("aten::") and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:6]
    return dict(wall_ms=round(wall, 3), device_busy_ms=round(busy, 3),
                idle_share=round(1 - busy / wall, 3), layers_device_ms=layers,
                top_ops_device_ms={e.key: round(e.self_device_time_total / 1e3, 3)
                                   for e in ops})


class CpuDraws:
    """GeneratorNoise drawn on the CPU and moved to `device`, so that a run
    on the card and one on the CPU see the same numbers."""

    def __init__(self, seed: int, device):
        from repro_torch.core.noise import GeneratorNoise
        self.inner = GeneratorNoise(seed, torch.device("cpu"))
        self.device = device

    def __getattr__(self, name):
        fn = getattr(self.inner, name)
        return lambda *a: fn(*a).to(self.device)


def phase_small(seed: int) -> None:
    from repro_torch.core.engine import EngineConfig, PlasticityEngine
    from repro_torch.core.msp import MSPConfig
    from repro_torch.core.traversal import FMMConfig
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1000.0, (256, 3)).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        eng = PlasticityEngine(pos, MSPConfig.calibrated(speedup=100.0),
                               FMMConfig(c1=8, c2=8), EngineConfig(), device=dev)
        st = eng.init_state()
        g = np.random.default_rng(seed + 1)
        t = lambda lo, hi: torch.as_tensor(g.uniform(lo, hi, 256).astype(np.float32),
                                           device=dev)
        st = st._replace(neurons=st.neurons._replace(
            calcium=t(0.4, 0.7), ax_elems=t(0, 6), den_elems=t(0, 6)))
        out[dev] = eng.simulate(st, 300, noise=CpuDraws(seed, eng.device))
    (sg, rg), (sc, rc) = out["cuda"], out["cpu"]
    if not torch.equal(rg.num_synapses.cpu(), rc.num_synapses) \
            or not torch.equal(rg.spike_rate.cpu(), rc.spike_rate):
        raise AssertionError("N=256: card and CPU records differ")
    for f in ("src", "dst", "valid"):
        if not torch.equal(getattr(sg.edges, f).cpu(), getattr(sc.edges, f)):
            raise AssertionError(f"N=256: card and CPU edge tables differ ({f})")
    if not torch.equal(sg.neurons.calcium.cpu(), sc.neurons.calcium):
        raise AssertionError("N=256: card and CPU calcium differ")
    log(f"[small] N=256, 300 steps: card (kernels) == CPU (plain versions): "
        f"records, edges and calcium identical; synapses {int(rc.num_synapses[-1])}")


def phase_fig1(seed: int) -> None:
    from repro_torch.core.engine import EngineConfig, PlasticityEngine
    from repro_torch.core.msp import MSPConfig
    from repro_torch.core.traversal import FMMConfig
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1000.0, (4096, 3)).astype(np.float32)
    msp_cfg = MSPConfig.calibrated(speedup=100.0)
    eng = PlasticityEngine(pos, msp_cfg, FMMConfig(c1=8, c2=8), EngineConfig())
    t = time.perf_counter()
    _, recs = eng.simulate(eng.init_state(), 3000, seed=seed)
    ca = recs.calcium_mean.cpu().numpy()
    syn = recs.num_synapses.cpu().numpy()
    log(f"[fig1] n=4096, 3000 steps in {time.perf_counter() - t:.1f} s; mean calcium "
        f"{[round(float(c), 4) for c in ca[::500]]} -> {ca[-1]:.4f} (eps {msp_cfg.eps}); "
        f"synapses {syn[::500].tolist()} -> {int(syn[-1])}")
    if not (np.isfinite(ca).all() and ca[-1] > ca[500] > 0
            and abs(ca[-1] - msp_cfg.eps) < abs(ca[500] - msp_cfg.eps)):
        raise AssertionError("fig1: mean calcium does not rise toward eps")
    if not syn[-1] > 0:
        raise AssertionError("fig1: no synapses formed")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA card",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import m2l_pair, msp_update as kmsp
    # The plain m2l version uses matmuls: keep them in full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = smi("name,power.limit").splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    phase_build()
    timings = phase_kernels(args.seed)
    phase_small(args.seed)
    main_run = phase_main(args.seed)
    log(f"[device] after the main run: clocks.sm, power.draw, temperature: "
        f"{smi('clocks.sm,power.draw,temperature.gpu')}")
    phase_fig1(args.seed)
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    modules = {"msp_update": kmsp, "m2l_separable": m2l_pair}
    kernels = [dict(name=name, route="cuda", source=mod.SOURCE, replaces=mod.REPLACES,
                    launches=main_run["launches"][name], library_ms=None, **timings[name])
               for name, mod in modules.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
