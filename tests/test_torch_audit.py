"""The port's contract auditor (`repro_torch.audit`).

1. Its teeth: every seeded violation of `bad_examples.py` is found under
   its rule (R1-R4, the source lint, the build check), and every corrected
   twin audits clean.
2. The port holds its contract: each registered entry point audits clean
   (the single-device ones in this process, the distributed ones in two
   spawned gloo ranks), the source lint finds nothing, and the kernels'
   build flags hold --fmad=false.
3. What the rules read is there: the traced runs record the synaptic
   input's float index_add_ (allowlisted with its reason) and the m2m leaf
   level's torch.sum over a padded run width, which R4 flags once the
   allowlist is empty; the forced deletion gathers the edge table inside an
   update with excess only.
"""
import pytest

from repro_torch.audit import astlint, bad_examples, cli, rules, tracer

LOCAL = {spec.name: spec for spec in tracer.registry(local_only=True)}


@pytest.mark.parametrize("spec", bad_examples.bad_examples(), ids=lambda s: s.name)
def test_each_seeded_violation_is_caught_under_its_rule(spec):
    found = tracer.audit_entry(spec)
    assert bad_examples.expected_rule(spec.name) in {f.rule for f in found}


@pytest.mark.parametrize("spec", bad_examples.clean_controls(), ids=lambda s: s.name)
def test_each_corrected_twin_audits_clean(spec):
    assert tracer.audit_entry(spec) == []


@pytest.mark.parametrize("case", bad_examples.source_checks(), ids=lambda c: c[0])
def test_the_source_checks_catch_their_seeds(case):
    name, want, bad, good = case
    assert want in {f.rule for f in bad} and good == []


def test_self_test_passes():
    assert cli.self_test() == []


@pytest.mark.parametrize("name", sorted(LOCAL))
def test_single_device_entry_points_audit_clean(name):
    found = tracer.audit_entry(LOCAL[name])
    assert not found, "\n".join(f.format() for f in found)


def test_distributed_entry_points_audit_clean():
    specs = [s for s in tracer.registry() if s.spawned]
    found, names = tracer.audit_entries(specs)
    assert not found, "\n".join(f.format() for f in found[:20])
    assert any(n.startswith("distributed_ensemble.simulate") for n in names)
    assert sum(n.startswith("distributed.simulate") for n in names) == 6


def test_the_lint_is_clean_on_the_port_and_the_build_holds_fmad_false():
    found, modules = astlint.lint_all()
    assert not found, "\n".join(f.format() for f in found)
    assert "core/distributed.py" in modules and "launch/mesh.py" in modules
    assert rules.check_build() == []


def test_r4_sees_the_allowlisted_accumulation_and_the_padded_leaf_sum():
    spec = LOCAL["engine.simulate[{'method': 'fmm', 'pyramid': 'm2m'}]"]
    trace = tracer.record(spec.run)
    cfg = dict(spec.rules["R4"], allowlist=(), sizes=trace.sizes)
    where = {f.where for f in rules.r4_order(spec.name, trace, cfg)}
    assert any(w.endswith("core.synapses.synaptic_input") for w in where)
    assert any(w.endswith("core.octree._run_sums") for w in where)
    assert tracer.audit_trace(spec.name, trace, spec.rules) == []
