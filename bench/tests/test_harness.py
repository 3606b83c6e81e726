"""The harness finds every piece by name, a later change adds pieces with
files and entries alone, and nothing the harness runs loads JAX or the JAX
package."""
import ast
import json
import shutil
import subprocess
import sys
import types

import pytest

import _bench_paths
from bench.harness import spec

ROOT = _bench_paths.ROOT
BENCH = ROOT / "bench"
NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-")
UNIT_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_/%.-")


def _bm():
    return spec.benchmark()


def test_benchmark_file_keys_and_names():
    bm = _bm()
    assert set(bm) == {"command", "paths", "run_seconds", "configs", "workloads",
                       "end_to_end", "per_layer"}
    assert bm["paths"] == ["bench"] and bm["command"] == ["python3", "bench/run.py"]
    assert 1 <= bm["run_seconds"] <= 51
    names = [x["name"] for part in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bm[part]]
    assert len(names) == len(set(names))
    for name in names:
        assert set(name) <= NAME_CHARS and len(name) <= 64 and name[0] not in ".-"
    for m in bm["end_to_end"] + bm["per_layer"]:
        assert set(m["unit"]) <= UNIT_CHARS and 1 <= len(m["unit"]) <= 16
        assert m["better"] in ("lower", "higher")
    for m in bm["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in bm["end_to_end"]}
    for m in bm["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in bm["end_to_end"]}


@pytest.mark.parametrize("config", [c["name"] for c in spec.benchmark()["configs"]])
def test_reduced_lists_every_departure_from_the_source(config):
    """`reduced` names exactly the keys whose value differs from the paper's
    Table 1 (kept in the file), and each has its reason."""
    entry = next(c for c in _bm()["configs"] if c["name"] == config)
    cfg = spec.load_json(ROOT / entry["file"])
    table = cfg["paper_table_1"]
    changed = {k for k, v in table.items() if cfg[k] != v}
    assert changed == set(entry["reduced"])
    assert set(cfg["departures"]) == changed


@pytest.mark.parametrize("cell", [w["name"] for w in spec.benchmark()["workloads"]])
def test_cell_finds_its_pieces(cell):
    c = spec.cell(cell)
    w = next(x for x in _bm()["workloads"] if x["name"] == cell)
    assert c.config_name == w["config"] and c.traffic_name == w["traffic"]
    assert c.chips == w["chips"] == 1
    assert c.config["name"] == w["config"]
    assert {"replicas", "episode_steps", "chunks", "start"} <= set(c.traffic)
    assert sum(c.traffic["chunks"]) == c.config["update_interval"]
    assert {m["name"] for m in c.end_to_end} == {"neuron_steps_per_s", "activity_step_ms",
                                                 "update_ms", "setup_s"}
    assert len(c.per_layer) == 8
    for m in c.per_layer:
        assert callable(spec.metric_module(m["name"]).read)


@pytest.mark.parametrize("metric", [m["name"] for m in spec.benchmark()["per_layer"]])
def test_metric_file_agrees_with_its_entry(metric):
    entry = next(m for m in _bm()["per_layer"] if m["name"] == metric)
    mod = spec.metric_module(metric)
    assert (mod.UNIT, mod.LAYER, mod.MOVES) == (entry["unit"], entry["layer"], entry["moves"])


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")


def test_pieces_added_with_files_and_entries_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a mix with a start
    generator of its own, a metric and a cell through new files and new
    entries; the harness finds them, and a tiny run of the new cell on the
    CPU reports the new metric."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for d in ("configs", "systems", "traffic", "starts", "metrics", "harness", "reference"):
        shutil.copytree(BENCH / d, tmp_path / "bench" / d)
    cfg = json.loads((BENCH / "configs" / "msp-fmm-1m.json").read_text())
    cfg["name"] = "msp-fmm-tiny"
    cfg["n"], cfg["domain"] = 512, 172.0
    (tmp_path / "bench" / "configs" / "msp-fmm-tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((BENCH / "traffic" / "sweep16-steady.json").read_text())
    mix["replicas"] = {"sigma": [600.0, 700.0]}
    mix["episode_steps"] = 200
    mix["start"] = {"generator": "unconnected", "calcium": [0.4, 0.7], "elements": [0.0, 6.0]}
    (tmp_path / "bench" / "starts" / "unconnected.py").write_text(
        "import torch\n\n\ndef draw(params, gen, positions, domain):\n"
        "    n, dev = positions.shape[0], positions.device\n"
        "    u = lambda lo, hi: torch.empty(n, device=dev).uniform_(lo, hi, generator=gen)\n"
        "    fields = {'calcium': u(*params['calcium']), 'ax_elems': u(*params['elements']),\n"
        "              'den_elems': u(*params['elements'])}\n"
        "    none = torch.zeros(0, dtype=torch.int32, device=dev)\n"
        "    return fields, none, none\n")
    (tmp_path / "bench" / "traffic" / "sweep2-grow.json").write_text(json.dumps(mix))
    (tmp_path / "bench" / "metrics" / "update_chunks.py").write_text(
        'UNIT = "chunks"\nLAYER = "ensemble driver (core/ensemble.py)"\n'
        'MOVES = "update_ms"\n\n\ndef read(ctx):\n'
        '    steps = ctx["profile"]["chunk_steps"]\n'
        '    return float(sum(k == "bench.update" for k, _ in steps)) or None\n')
    bm = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bm["configs"].append({"name": "msp-fmm-tiny", "source": "https://arxiv.org/abs/2301.10570",
                          "file": "bench/configs/msp-fmm-tiny.json", "reduced": ["n"],
                          "why": "a test's tiny copy"})
    bm["workloads"].append({"name": "fmm-tiny", "config": "msp-fmm-tiny",
                            "traffic": "sweep2-grow", "chips": 1, "why": "a test's cell"})
    bm["per_layer"].append({"name": "update_chunks", "unit": "chunks", "better": "lower",
                            "source": "program_span", "layer": "ensemble driver (core/ensemble.py)",
                            "moves": "update_ms", "workloads": ["fmm-tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bm))

    c = spec.cell("fmm-tiny", root=tmp_path)
    assert c.config["n"] == 512 and c.traffic["replicas"] == {"sigma": [600.0, 700.0]}
    assert c.start.__file__.endswith("unconnected.py")
    assert [m["name"] for m in c.per_layer] == ["update_chunks"]
    assert spec.cell("fmm-sweep16-steady", root=tmp_path).per_layer[-1]["name"] != "update_chunks"

    import run
    result = run.run_cell(c, 5, 0.01, True, "cpu")
    # Whole intervals until the profiled ones, the 2nd and the 4th: 4
    # intervals (2 episodes) of 2 replicas.
    assert result["correct"] and result["attempted"] == 4 * 2
    assert result["metrics"] == {"update_chunks": {"value": 2.0, "unit": "chunks"}}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import run
    assert "repro_torch" in {m.split(".")[0] for m in sys.modules}
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert run.forbidden_modules() == ["jax", "repro"]


def test_a_run_loads_no_jax_nor_the_jax_package():
    """A tiny run in a fresh interpreter, then a look at sys.modules."""
    code = (
        "import sys; sys.path[:0] = [%r, %r, %r]\n"
        "import run, control\n"
        "from bench.harness import spec\n"
        "c = spec.cell('bh-sweep16-steady')\n"
        "c = c._replace(config={**c.config, 'n': 256, 'domain': 137.0},\n"
        "               traffic={**c.traffic, 'episode_steps': 100})\n"
        "r = run.run_cell(c, 3, 0.2, False, 'cpu')\n"
        "assert r['correct'], r\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    ) % (str(BENCH), str(ROOT / "src"), str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def _modules():
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def _non_docstring_strings(tree):
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                docs.add(id(first.value))
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


@pytest.mark.parametrize("path", _modules(), ids=lambda p: str(p.relative_to(BENCH)))
def test_sources_import_no_jax_and_read_no_old_benchmark(path):
    tree = ast.parse(path.read_text())
    names = set(_imports(tree))
    assert not names & {"jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke"}
    for s in _non_docstring_strings(tree):
        assert "chip_smoke" not in s and "benchmarks/" not in s
    if "reference" in path.parts:
        assert "repro_torch" not in names, "the reference imports nothing of the port"


def test_without_a_card_no_result():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "fmm-sweep16-steady", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout == ""
