"""Tests of lightgbm_tpu_torch.analysis, the port's static analysis: the
JAX package's tests/test_analysis.py set, re-aimed at torch.

- each rule fires on a seeded violation (a fixture source or a recorded
  fixture call), and the registered entry points and the package
  satisfy every rule (one shared ``ProgramSet``, recorded on the CPU);
- the recorder's emulation of the card's placement on a CPU run;
- suppression semantics, the JSON schema and the CLI's exit codes;
- the suppression engine, the Config readers and the span-table parser
  equal the JAX package's on the same texts.
"""
import json
import os

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.analysis import (Context, Finding, RULES, run_rules,
                                         unsuppressed, walker)
from lightgbm_tpu_torch.analysis import core as tcore
from lightgbm_tpu_torch.analysis import ast_rules as tast
from lightgbm_tpu_torch.analysis import teldoc_rule as ttel
from lightgbm_tpu_torch.analysis.ast_rules import (ROUND_SEEDS, SourceIndex,
                                                   cpu_only_ranges,
                                                   scan_host_syncs,
                                                   scan_python_branching)
from lightgbm_tpu_torch.analysis.core import (Suppression,
                                              _apply_suppressions,
                                              parse_suppressions, render_json)
from lightgbm_tpu_torch.analysis.program_rules import (check_exchange,
                                                       check_no_f64,
                                                       check_no_host_sync,
                                                       check_t_invariance)
from lightgbm_tpu_torch.analysis.programs import ProgramSet, record

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "lightgbm_tpu_torch/boosting/gbdt.py"   # arbitrary attribution file
DEV = torch.device("cpu")                     # "the program's device"
PROGRAM_RULES = ["PRG001", "PRG002", "PRG005", "PRG009"]
ALL_RULES = {"SUP001", "CFG001", "CFG002", "TEL001", "TRC001", "TRC002",
             "PRG001", "PRG002", "PRG005", "PRG009"}


@pytest.fixture(scope="module")
def programs():
    """One ProgramSet for the file, recorded on the CPU (the JAX
    package's ``analysis_programs`` session fixture)."""
    return ProgramSet("cpu", cpu_only_ranges(SourceIndex(Context().sources)))


def _fixture(fn, name="fixture", **meta):
    """A Program recorded from ``fn`` on the CPU."""
    return record(name, SRC, lambda: (), fn, "cpu", **meta)


# ---------------------------------------------------------------------------
# program rules: the registered entry points pass, seeded fixtures flag
# ---------------------------------------------------------------------------
def test_program_rules_pass_on_registered_entry_points(programs):
    ctx = Context(programs=programs, device="cpu")
    findings = run_rules(PROGRAM_RULES, ctx=ctx)
    assert not unsuppressed(findings), "\n".join(
        f"{f.rule} {f.location()}: {f.message}"
        for f in unsuppressed(findings))
    # the round loop's split count is the known host sync, waived at
    # its line with its reason
    known = [f for f in findings if f.rule == "PRG002"
             and "int(do_split.sum())" in open(os.path.join(
                 REPO, f.file)).read().splitlines()[f.line - 1]]
    assert known and known[0].suppressed and "split count" in known[0].reason


def test_registered_programs_are_the_main_path(programs):
    train = programs.train_step()
    assert train.meta["iterations"] == 2
    assert walker.count_op(train.ops, "aten._local_scalar_dense") > 0
    small, large = programs.predict_level(4), programs.predict_level(12)
    assert small.meta["probe_t"] == 4 and large.meta["probe_t"] == 12
    # on the CPU the wrapper takes kernel C's plain version, whose ops
    # the rules leave out: its per-tree loop grows with T there
    assert len(large.ops) > len(small.ops) > 0
    ex = programs.hist_exchange("q16")
    assert walker.count_op(ex.ops, "aten.round") >= 2


@pytest.mark.parametrize("name", ["Program", "record", "build_probe_gbdt",
                                  "train_probe_booster"])
def test_probe_builders_take_no_default_device(name):
    """The device rule (the card unless the caller asks for the CPU):
    the probes and the recorder have no ``device`` default, so no caller
    lands on the CPU unasked, and ProgramSet's default is the card."""
    import inspect

    from lightgbm_tpu_torch.analysis import programs as tprog
    fn = getattr(tprog, name)
    param = inspect.signature(fn).parameters["device"]
    assert param.default is inspect.Parameter.empty
    assert inspect.signature(ProgramSet).parameters["device"].default \
        == "cuda"


def test_prg001_flags_f64_fixture():
    p = _fixture(lambda: torch.zeros(3, dtype=torch.float64,
                                     device=DEV) * 2)
    findings = check_no_f64(p)
    assert findings and findings[0].rule == "PRG001"
    assert "float64" in findings[0].message
    assert check_no_f64(_fixture(lambda: torch.zeros(3, device=DEV) * 2)) \
        == []


def test_prg002_flags_host_sync_fixture():
    def syncs():
        t = torch.arange(6.0, device=DEV)
        t.sum().item()                       # a scalar read
        torch.nonzero(t)                     # data-sized output
        t[t > 2]                             # boolean index
        t.cpu()                              # a copy to the host
        torch.from_numpy(np.ones(3)).to(DEV)  # a blocking copy up
    findings = check_no_host_sync(_fixture(syncs))
    assert len(findings) == 1 and findings[0].rule == "PRG002"
    msg = findings[0].message
    for what in ("aten._local_scalar_dense", "aten.nonzero", "aten.index",
                 "Tensor.cpu", "Tensor.to"):
        assert what in msg, what
    assert check_no_host_sync(_fixture(
        lambda: torch.arange(6.0, device=DEV).cumsum(0))) == []


def test_prg002_finding_sits_at_the_port_line():
    """A sync inside the package is attributed to its own line: the
    binned walk's ``while bool(...)``."""
    from lightgbm_tpu_torch.ops.predict import predict_binned
    tree = {"node_cat_mask": torch.zeros((1, 1), dtype=torch.bool),
            "num_leaves": 1, "leaf_value": torch.ones(2)}
    p = record("binned", SRC, lambda: (torch.zeros(
        (4, 1), dtype=torch.uint8, device=DEV),), lambda b: predict_binned(
        tree, b, *([torch.zeros(1, dtype=torch.int32)] * 5)), "cpu")
    [f] = check_no_host_sync(p)
    path = os.path.join(REPO, f.file)
    assert f.file == "lightgbm_tpu_torch/ops/predict.py"
    assert "while bool(" in open(path).read().splitlines()[f.line - 1]


def test_recorder_emulates_the_cards_placement():
    """On a CPU run a tensor made with a torch.device (the program's
    device) or from one counts as the card's; from_numpy and factories
    without a device, or with "cpu", make host tensors."""
    with walker.Recorder("cpu") as rec:
        host = torch.ones(3)
        host.sum().item()                    # host: no sync
        host.numpy()                         # host: no copy
        card = torch.ones(3, device=DEV)
        (card + host).sum().item()           # card: a sync
        card.to("cpu")                       # to the host
        torch.zeros(2, device="cpu").tolist()  # named host: nothing
        torch.tensor(1.0, device=DEV)        # host data up: a sync
        torch.from_numpy(np.ones(2)).to(DEV, non_blocking=True)
    syncs = walker.host_sync_ops(rec.ops)
    assert [o.sync for o in syncs] == [
        walker.HOST_SYNC_OPS["aten._local_scalar_dense"], walker.TO_HOST,
        walker.TO_CARD]
    assert [o.name for o in syncs] == [
        "aten._local_scalar_dense.default", "Tensor.to", "torch.tensor"]


def test_recorder_counts_launches_and_dtypes(monkeypatch):
    from lightgbm_tpu_torch.ops import kernels
    with walker.Recorder("cpu") as rec:
        kernels.LAUNCHES["route_apply"] += 2
        torch.ones(2, dtype=torch.int32, device=DEV) + 1
    kernels.LAUNCHES["route_apply"] -= 2
    assert rec.launches == {"route_apply": 2}
    assert walker.ops_by_dtype(rec.ops)["torch.int32"] >= 1
    assert walker.count_op(rec.ops, "aten.add") == 1
    assert walker.summary(rec.ops, rec.launches)["launches"] == \
        {"route_apply": 2}


def test_prg005_flags_t_dependent_op_count_fixture():
    def per_tree(t_count):
        def fn():
            out = torch.zeros(4, device=DEV)
            for _ in range(t_count):         # one op a tree
                out = out + 1
            return out
        return fn
    progs = {t: _fixture(per_tree(t), f"fixture@T{t}", probe_t=t)
             for t in (4, 12)}
    findings = check_t_invariance(progs[4], progs[12])
    assert findings and findings[0].rule == "PRG005"
    assert "grew with the tree count" in findings[0].message
    flat = {t: _fixture(per_tree(1), f"flat@T{t}", probe_t=t)
            for t in (4, 12)}
    assert check_t_invariance(flat[4], flat[12]) == []
    # on the card a predict that launches no kernel is a finding too
    for p in flat.values():
        p.device = "cuda"
    assert any("launched no kernel" in f.message
               for f in check_t_invariance(flat[4], flat[12]))


def test_prg009_flags_off_device_and_f64_codec_fixture():
    def leaky():
        h = torch.ones((2, 3), device=DEV)
        h.cpu()                               # leaves the device
        h.to(torch.float64)                   # f64
    findings = check_exchange(_fixture(leaky))
    assert {f.rule for f in findings} == {"PRG009"}
    msgs = "\n".join(f.message for f in findings)
    assert "float64" in msgs and "off the cpu device" in msgs
    assert check_exchange(_fixture(
        lambda: torch.ones(3, device=DEV) * 2)) == []


def test_program_rules_leave_out_the_cpu_only_lines(programs):
    """The CPU run of the train probe dispatches the plain versions'
    ops (kernel A's and B's), which the rules leave out; the same
    findings with no ranges would include the plain versions' lines."""
    ranges = programs.cpu_ranges
    train = programs.train_step()
    plain = [o for o in train.ops if walker.in_ranges(o, ranges)]
    assert plain
    assert any("ops/histogram.py" in o.site for o in plain)


# ---------------------------------------------------------------------------
# the AST pass
# ---------------------------------------------------------------------------
FIXTURE_GROWER = '''\
import numpy as np
import torch


def train_tree(t, cfg):
    n = _helper(t)
    if t.any():
        n += 1
    m = int(cfg.num_leaves)          # a Config value: no read
    k = int(len(t))                  # a builtin: no read
    return n + m + k


def _helper(t):
    torch.cuda.synchronize()
    return t.sum().item() + int(t.max()) + len(t.tolist())


def _unreached(t):
    return t.cpu().numpy()
'''

FIXTURE_OPS = '''\
import torch


def wrapper(x):
    if x.device.type != "cuda":
        return wrapper_plain(x)
    return _launch(x)


def wrapper_plain(x):
    return x.sum().item()


def _launch(x):
    return x
'''


def _fixture_index():
    return SourceIndex({"lightgbm_tpu_torch/learner/grower.py":
                        FIXTURE_GROWER,
                        "lightgbm_tpu_torch/ops/fixture.py": FIXTURE_OPS})


def test_trc001_flags_host_syncs_through_the_call_graph():
    idx = _fixture_index()
    fns = idx.reachable([("learner/grower.py", "train_tree")])
    assert {f.name for f in fns} == {"train_tree", "_helper"}
    findings = scan_host_syncs(idx, fns)
    msgs = [f.message for f in findings]
    for what in ("torch.cuda.synchronize()", ".item()", ".tolist()",
                 "int() of a value"):
        assert any(m.startswith(what) for m in msgs), what
    assert all(f.rule == "TRC001" for f in findings)
    # the Config read, the builtin's cast and the unreached function's
    # .cpu().numpy() are not findings
    assert not any(".cpu()" in m or ".numpy()" in m for m in msgs)
    lines = {f.line for f in findings}
    assert lines == {15, 16}


def test_trc001_skips_a_kernels_plain_version():
    idx = _fixture_index()
    assert ("lightgbm_tpu_torch/ops/fixture.py", "wrapper_plain") in \
        idx.plain_versions
    fns = idx.reachable([("ops/fixture.py", "wrapper")])
    assert {f.name for f in fns} == {"wrapper", "_launch"}
    assert scan_host_syncs(idx, fns) == []
    ranges = cpu_only_ranges(idx)["lightgbm_tpu_torch/ops/fixture.py"]
    assert (6, 6) in ranges and (10, 11) in ranges


def test_trc002_flags_python_branch_on_a_tensor():
    idx = _fixture_index()
    fns = idx.reachable([("learner/grower.py", "train_tree")])
    findings = scan_python_branching(idx, fns)
    assert len(findings) == 1
    assert findings[0].rule == "TRC002" and findings[0].line == 7
    assert "`if`" in findings[0].message


def test_round_seeds_resolve_in_real_package():
    """Every seed resolves against the live AST index: a rename of a
    seeded entry point fails here instead of silently shrinking the
    lint's reach."""
    idx = SourceIndex(Context().sources)
    for suffix, name in ROUND_SEEDS:
        assert any(f.path.endswith(suffix)
                   for f in idx.functions.get(name, [])), \
            f"seed {name} not found in {suffix}"
    fns = idx.reachable(ROUND_SEEDS)
    paths = {f.path for f in fns}
    assert "lightgbm_tpu_torch/ops/histogram.py" in paths
    assert "lightgbm_tpu_torch/ops/split.py" in paths
    assert len(fns) > 50
    names = {f.name for f in fns}
    assert {"fused_route_hist", "route_apply_tiled",
            "predict_level_ensemble"} <= names
    # the plain versions come from the wrappers' CPU branches, and the
    # call graph does not enter them
    for plain in ("fused_route_hist_plain", "route_apply_plain",
                  "predict_level_records_plain", "tiled_hist_plain"):
        assert any(name == plain for _, name in idx.plain_versions), plain
        assert plain not in names


# ---------------------------------------------------------------------------
# Config consistency and the span map
# ---------------------------------------------------------------------------
FAKE_CONFIG = '''\
import dataclasses


@dataclasses.dataclass
class Config:
    num_leaves: int = 31
    dead_knob: int = 0
'''
CONFIG_REL = "lightgbm_tpu_torch/config.py"


def test_cfg002_flags_never_read_knob():
    ctx = Context(sources={CONFIG_REL: FAKE_CONFIG})
    live = unsuppressed(run_rules(["CFG002"], ctx=ctx,
                                  check_suppressions=False))
    assert [f for f in live if "dead_knob" in f.message]
    assert all(f.rule == "CFG002" for f in live)


def test_cfg001_flags_undocumented_knob():
    ctx = Context(sources={CONFIG_REL: FAKE_CONFIG})
    live = unsuppressed(run_rules(["CFG001"], ctx=ctx,
                                  check_suppressions=False))
    assert any("dead_knob" in f.message for f in live)
    assert not any("`num_leaves`" in f.message for f in live)


def test_tel001_flags_both_directions():
    src = {"lightgbm_tpu_torch/m.py":
           "TM.span('not_in_the_doc')\nTM.span(label)\n"
           "TM.start_span('train_chunk')\n"}
    live = unsuppressed(run_rules(["TEL001"], ctx=Context(sources=src),
                                  check_suppressions=False))
    msgs = "\n".join(f.message for f in live)
    assert "'not_in_the_doc'" in msgs and "missing from" in msgs
    assert "dynamic span/phase name" in msgs
    assert "'train_chunk' is emitted but listed as not ported" in msgs
    assert "documents span 'boost_iter'" in msgs


def test_contracts_clean_on_real_package():
    findings = run_rules(["CFG001", "CFG002", "TRC001", "TRC002",
                          "TEL001"])
    live = unsuppressed(findings)
    assert not live, "\n".join(
        f"{f.rule} {f.location()}: {f.message}" for f in live)
    sup = [f for f in findings if f.suppressed]
    assert sup and all(f.reason for f in sup)
    # the TPU compile knobs are waived as such
    knobs = {f.message.split("`")[1]: f.reason for f in sup
             if f.rule == "CFG002"}
    for k in ("compile_cache_dir", "force_pallas_interpret",
              "pallas_hist_block", "pallas_hist_block_tiled",
              "split_finder_ladder"):
        assert "TPU compile knob" in knobs[k], k
    # the refit span is emitted; only the dispatch_chunk spans and the
    # JAX profiling script's are absent, each with its reason
    spans = ttel.code_spans(Context().sources)
    assert "refit" in spans
    assert set(ttel.NOT_PORTED) == {"train_chunk", "tune_dispatch_chunk",
                                    "profile_warm", "profile_measure"}


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------
def test_parse_suppressions_trailing_and_standalone():
    text = ("x = 1  # lint: disable=TRC001(host side), PRG002(once a tree)\n"
            "# lint: disable=PRG001(legacy path)\n")
    sups = parse_suppressions("f.py", text)
    assert [(s.rule, s.line, s.file_scope, s.reason) for s in sups] == [
        ("TRC001", 1, False, "host side"), ("PRG002", 1, False, "once a tree"),
        ("PRG001", 2, True, "legacy path")]


def test_apply_suppressions_line_and_file_scope():
    f1 = Finding(rule="TRC001", message="m", file="f.py", line=3)
    f2 = Finding(rule="TRC001", message="m", file="f.py", line=9)
    f3 = Finding(rule="PRG001", message="m", file="f.py", line=0)
    sups = [Suppression("f.py", 3, "TRC001", "why", False),
            Suppression("f.py", 1, "PRG001", "all", True)]
    _apply_suppressions([f1, f2, f3], sups)
    assert f1.suppressed and f1.reason == "why"
    assert not f2.suppressed
    assert f3.suppressed
    assert all(s.used for s in sups)


def test_suppressed_violation_and_stale_suppression_end_to_end():
    bad = ("def train_tree(t):\n"
           "    return t.item()  # lint: disable=TRC001(reviewed)\n")
    ctx = Context(sources={"lightgbm_tpu_torch/learner/grower.py": bad})
    findings = run_rules(["TRC001"], ctx=ctx)
    assert findings and all(f.suppressed for f in findings)

    stale = "import torch\n# lint: disable=TRC001(stale)\n"
    ctx = Context(sources={"lightgbm_tpu_torch/learner/grower.py": stale})
    live = unsuppressed(run_rules(["TRC001"], ctx=ctx))
    assert len(live) == 1 and live[0].rule == "SUP001"
    assert "unused suppression" in live[0].message


# ---------------------------------------------------------------------------
# JSON report, CLI, registry
# ---------------------------------------------------------------------------
def test_json_report_schema():
    findings = [Finding(rule="TRC001", message="m", file="f.py", line=3),
                Finding(rule="PRG001", message="n", file="g.py", line=0,
                        suppressed=True, reason="why")]
    doc = json.loads(render_json(findings, ["TRC001", "PRG001"]))
    assert doc["version"] == 1
    assert doc["rules_run"] == ["TRC001", "PRG001"]
    assert doc["counts"] == {"total": 2, "suppressed": 1,
                             "unsuppressed": 1}
    assert doc["clean"] is False
    for f in doc["findings"]:
        assert set(f) == {"rule", "message", "file", "line", "suppressed",
                          "reason"}
    assert json.loads(render_json([], ["PRG001"]))["clean"] is True


def test_rule_registry_has_the_ten_rules():
    run_rules(["CFG001"], Context(sources={}))   # force registration
    assert set(RULES) == ALL_RULES
    for rid in ALL_RULES:
        assert RULES[rid].title and RULES[rid].incident
    assert all(RULES[r].needs_programs for r in PROGRAM_RULES)


def test_cli_list_subset_and_unknown_rule(capsys):
    from lightgbm_tpu_torch.analysis.__main__ import main
    assert main(["--list"]) == 0
    out = capsys.readouterr().out
    assert {ln.split()[0] for ln in out.splitlines()} == ALL_RULES
    rc = main(["--rules", "CFG001,CFG002,TEL001", "--json"])
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and doc["clean"] is True
    assert doc["rules_run"] == ["CFG001", "CFG002", "TEL001"]
    assert main(["--rules", "NOPE999"]) == 2


def test_cli_exits_nonzero_on_a_seeded_violation(capsys, monkeypatch):
    bad = "def train_tree(t):\n    return t.item()\n"
    fixture = Context(sources={"lightgbm_tpu_torch/learner/grower.py": bad})
    monkeypatch.setattr(tcore, "Context", lambda **kw: fixture)
    from lightgbm_tpu_torch.analysis.__main__ import main
    rc = main(["--rules", "TRC001", "--json", "--device", "cpu"])
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and doc["clean"] is False
    assert doc["counts"]["unsuppressed"] == 1


def test_cli_whole_analysis_clean_on_the_port(programs, capsys,
                                              monkeypatch):
    """Every rule over the package and the registered programs,
    recorded on the CPU (--device cpu): exit 0, nothing unsuppressed,
    every suppression used and with a reason."""
    seen = {}

    def ctx(**kw):
        seen.update(kw)
        return Context(programs=programs, **kw)
    monkeypatch.setattr(tcore, "Context", ctx)
    from lightgbm_tpu_torch.analysis.__main__ import main
    rc = main(["--json", "--device", "cpu"])
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert seen == {"device": "cpu"}
    assert rc == 0 and doc["clean"] and doc["counts"]["unsuppressed"] == 0
    assert set(doc["rules_run"]) == ALL_RULES
    assert all(f["reason"] for f in doc["findings"])
    by_rule = {f["rule"] for f in doc["findings"]}
    assert {"PRG002", "TRC001", "CFG002"} <= by_rule


def test_the_default_device_is_the_card(capsys, monkeypatch):
    """The program rules record on the card unless --device cpu is
    given; without a card the ProgramSet raises (the device rule)."""
    seen = {}

    def ctx(**kw):
        seen.update(kw)
        return Context(sources={}, **kw)
    monkeypatch.setattr(tcore, "Context", ctx)
    from lightgbm_tpu_torch.analysis.__main__ import main
    assert main(["--rules", "CFG001"]) == 0
    assert seen == {"device": "cuda"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ProgramSet()


# ---------------------------------------------------------------------------
# parity with the JAX package's engine, Config readers and span parser
# ---------------------------------------------------------------------------
SUPPRESSION_TEXTS = [
    "x = 1  # lint: disable=TRC001(host side)\n",
    "# lint: disable=HLO006(legacy program, tracked)\n",
    "y = f()  #lint:disable=PRG002(a), TRC001(b c)\n"
    "z = 2  # lint: disable=CFG002()\n",
    "no suppression here\n# lint: disable=\n",
]


@pytest.mark.parametrize("text", SUPPRESSION_TEXTS)
def test_suppression_engine_equals_the_jax_package(text):
    from lightgbm_tpu.analysis import core as jcore
    got = parse_suppressions("f.py", text)
    want = jcore.parse_suppressions("f.py", text)
    assert [vars(s) for s in got] == [vars(s) for s in want]
    findings = [(r, ln) for r in ("TRC001", "PRG002", "HLO006", "CFG002")
                for ln in (0, 1, 2, 3)]
    tf = [Finding(rule=r, message="m", file="f.py", line=ln)
          for r, ln in findings]
    jf = [jcore.Finding(rule=r, message="m", file="f.py", line=ln)
          for r, ln in findings]
    _apply_suppressions(tf, got)
    jcore._apply_suppressions(jf, want)
    assert [f.to_dict() for f in tf] == [f.to_dict() for f in jf]
    assert [s.used for s in got] == [s.used for s in want]


def _texts(*rel):
    return [open(os.path.join(REPO, r)).read() for r in rel]


def test_config_readers_equal_the_jax_package():
    from lightgbm_tpu.analysis import ast_rules as jast
    port_cfg, jax_cfg, params = _texts("lightgbm_tpu_torch/config.py",
                                       "lightgbm_tpu/config.py",
                                       "docs/Parameters.md")
    for src in (FAKE_CONFIG, port_cfg, jax_cfg):
        assert tast.config_field_lines(src) == jast.config_field_lines(src)
    for doc in (params, "| Parameter | D |\n|---|---|\n| `alpha` | `1` |\n"):
        assert tast.documented_params(doc) == jast.documented_params(doc)
    sources = dict(Context().sources)
    sources["m.py"] = ("x = cfg.alpha\ny = getattr(c, 'beta', 1)\n"
                       "hasattr(c, 'gamma')\n")
    assert tast.config_reads(sources) == jast.config_reads(sources)
    assert {"alpha", "beta", "gamma"} <= tast.config_reads(sources)


def test_span_table_parser_equals_the_jax_package():
    from lightgbm_tpu.analysis import teldoc_rule as jtel
    [doc] = _texts("docs/OBSERVABILITY.md")
    fixture = ("| Span | L |\n|---|---|\n| `a` | x |\n\ntext\n"
               "| Phase | C |\n| `b` | y |\n| plain | z |\n")
    for text in (doc, fixture):
        assert ttel.doc_spans(text) == jtel.doc_spans(text)
    assert ttel.doc_spans(fixture) == {"a", "b"}
    sources = Context().sources
    assert ttel.code_spans(sources) == jtel.code_spans(sources)
