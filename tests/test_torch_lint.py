"""repro-torch-lint: the port's contract linter (``repro_torch.analysis``).

Five layers: the four of the JAX package's linter, and parity with it:

1. corpus (``tests/lint_corpus/torch/``): RL003, RL004 and RL005 each fire
   on a known-bad exemplar, only that rule and a pinned number of times,
   and stay silent on its clean twin under ``--strict``;
2. pragmas: both placements suppress, ``--strict`` rejects a pragma
   without a reason, an unknown rule id is a finding, the JAX package's
   pragma prefix is not this linter's, and the port's tree holds no
   pragma at all;
3. acceptance: the port's tree (the ``repro_torch`` package and
   ``chip_smoke.py``) lints clean under ``--strict``, and each guarantee
   is load-bearing: a ``.item()`` two calls below ``ChainSim.tick``, an
   ``index_put_`` in ``segmented_route`` and a dtype-less lane of a state
   construction each turn the exit to 1;
4. reporters and CLI: the JSON report round-trips Finding for Finding,
   and the exit codes hold (0 clean, 1 findings, 2 usage);
5. parity: the JAX package's linter (``repro.analysis``) and this one on
   the same inputs, the pragma prefix mapped: the walk and
   ``EXCLUDED_DIRS``, RL000 on broken sources and malformed pragmas,
   ``scan_pragmas``, the suppressions, the JSON and human reports and the
   exit codes agree, and every difference this port means to have is
   listed in ``INTENDED_DIFFERENCES`` and checked there.

Pure ``ast``: none of this imports torch or JAX in the linter.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro import analysis as ref
from repro.analysis import cli as ref_cli
from repro.analysis import engine as ref_engine
from repro.analysis import pragmas as ref_pragmas
from repro.analysis import report as ref_report
from repro_torch.analysis import RULES, run_lint, run_lint_sources, walk_paths
from repro_torch.analysis import cli as port_cli
from repro_torch.analysis import engine as port_engine
from repro_torch.analysis import pragmas as port_pragmas
from repro_torch.analysis import report as port_report
from repro_torch.analysis.cli import default_paths
from repro_torch.analysis.pragmas import scan_pragmas
from repro_torch.analysis.report import findings_from_json, render_json

REPO = pathlib.Path(__file__).resolve().parent.parent
CORPUS = REPO / "tests" / "lint_corpus" / "torch"
PORT_PATHS = [str(REPO / "src" / "repro_torch"), str(REPO / "chip_smoke.py")]
CHAIN = str(REPO / "src" / "repro_torch" / "core" / "chain.py")
TYPES = str(REPO / "src" / "repro_torch" / "core" / "types.py")

PORT_RULES = ("RL003", "RL004", "RL005")
# findings a bad exemplar pins, one per line marked BAD
EXPECTED = {"RL003": 7, "RL004": 24, "RL005": 8}


def _lint_corpus_file(name: str, **kw):
    return run_lint([str(CORPUS / name)], **kw)


def _cli(*args: str, cwd=REPO):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        cwd=cwd, env=env, capture_output=True, text=True)


@pytest.fixture(scope="module")
def tree_sources() -> dict:
    return {str(f): f.read_text() for f in walk_paths(PORT_PATHS)}


# --------------------------------------------------------------------------
# 1. corpus
# --------------------------------------------------------------------------
@pytest.mark.parametrize("rule_id", PORT_RULES)
def test_rule_fires_only_on_its_bad_exemplar(rule_id):
    result = _lint_corpus_file(f"{rule_id.lower()}_bad.py")
    assert result.per_rule() == {rule_id: EXPECTED[rule_id]}, (
        result.findings)


@pytest.mark.parametrize("rule_id", PORT_RULES)
def test_rule_silent_on_clean_twin(rule_id):
    result = _lint_corpus_file(f"{rule_id.lower()}_clean.py", strict=True)
    assert result.findings == [], result.findings


def test_rule_catalogue_registered():
    """RL001 (donation) and RL002 (arrays closed over by jitted code) have
    no torch meaning yet and are not registered."""
    assert set(RULES) == set(PORT_RULES)
    for rule in RULES.values():
        assert rule.summary and rule.rationale


def test_rl004_names_the_call_chain():
    result = _lint_corpus_file("rl004_bad.py")
    chained = [f.message for f in result.findings if "reached from" in
               f.message]
    assert any("Sim.step -> _inner -> helper" in m and ".item()" in m
               for m in chained), chained
    assert any("Sim.step -> Sim._tail" in m for m in chained), chained


def test_rl003_types_follow_torch():
    """torch's dtype rules, one construction a case: int64 and float32
    defaults are findings, int32 casts and ``*_like`` of a lane are not."""
    head = ("import torch\nfrom typing import NamedTuple\n"
            "class M(NamedTuple):\n    a: torch.Tensor\n"
            "def f(m: M, c: torch.Tensor, n: int):\n    return ")
    cases = {
        "M(a=torch.arange(n))": "int64",
        "M(a=torch.ones(n))": "float32",
        "M(a=torch.where(c, 1, 0))": "int64",
        "M(a=m.a * 0.5)": "float32",
        "M(a=m.a.cumsum(0))": "int64",
        "M(a=torch.cat([m.a, m.a.long()]))": "int64",
        "M(a=torch.searchsorted(m.a, m.a))": "int64",
        "M(a=torch.arange(n).int())": None,
        "M(a=torch.full_like(m.a, 3))": None,
        "M(a=torch.where(c, m.a, -1))": None,
        "M(a=torch.searchsorted(m.a, m.a, out_int32=True))": None,
        "M(a=m.a // 2 + torch.zeros_like(m.a))": None,
        "M(a=torch.tensor(n, dtype=torch.int32))": None,
        "M(a=c.to(m.a.dtype))": None,
    }
    for expr, want in cases.items():
        found = run_lint_sources({"x.py": head + expr + "\n"}).findings
        got = None
        for dt in ("int64", "float32"):
            if any(dt in f.message for f in found):
                got = dt
        assert got == want, (expr, found)


def test_lane_dtype_only_from_a_comment_that_opens_with_it():
    """A lane is int32 unless its line comment opens with another dtype,
    after a shape if it has one; a dtype word later in the comment or in
    the class docstring types nothing."""
    from repro_torch.analysis.context import FileCtx, ProjectIndex

    src = ("import torch\nfrom typing import NamedTuple\n"
           "class R(NamedTuple):\n"
           '    """Lanes of float32 values."""\n'
           "    a: torch.Tensor  # [G, T] float32\n"
           "    b: torch.Tensor  # bool\n"
           "    c: torch.Tensor  # [C] count of the bool flags\n"
           "    d: torch.Tensor\n"
           "    n: int\n")
    index = ProjectIndex.build([FileCtx.parse("x.py", src)])
    assert index.lane_classes["R"].types == {
        "a": "float32", "b": "bool", "c": "int32", "d": "int32",
        "n": "py:int"}
    moe = REPO / "src" / "repro_torch" / "models" / "moe.py"
    index = ProjectIndex.build([FileCtx.parse(str(moe), moe.read_text())])
    assert index.lane_classes["Routing"].types == {
        "gate": "float32", "topv": "float32", "topi": "int64",
        "pos": "int32", "keep": "bool", "cap": "py:int"}


def test_corpus_excluded_from_directory_walks():
    files = walk_paths([str(REPO / "tests")])
    assert not any("lint_corpus" in str(f) for f in files)
    assert len(walk_paths([str(CORPUS / "rl003_bad.py")])) == 1


def test_syntax_error_is_a_meta_finding():
    result = run_lint_sources({"broken.py": "def f(:\n"})
    assert result.findings and result.findings[0].rule == "RL000"


# --------------------------------------------------------------------------
# 2. pragmas
# --------------------------------------------------------------------------
def test_pragma_suppresses_both_placement_forms():
    result = _lint_corpus_file("pragma_ok.py", strict=True)
    assert result.findings == []
    assert len(result.suppressed) == 2
    assert all(f.rule == "RL005" for f in result.suppressed)
    assert all(p.reason for p in result.pragmas)


def test_pragma_without_reason_rejected_by_strict():
    lax = _lint_corpus_file("pragma_noreason.py")
    assert lax.findings == [] and len(lax.suppressed) == 1
    strict = _lint_corpus_file("pragma_noreason.py", strict=True)
    assert any(f.rule == "RL000" and "no reason" in f.message
               for f in strict.findings), strict.findings


def test_unknown_rule_id_in_pragma_is_a_finding():
    src = ("def f(inbox, dst, m):\n"
           '    """repro-torch-lint: scatter-free"""\n'
           "    return inbox.index_put_((dst,), m)  "
           "# repro-torch-lint: ignore[RL001] donation is not a torch rule\n")
    result = run_lint_sources({"x.py": src})
    assert {f.rule for f in result.findings} == {"RL000", "RL005"}, (
        result.findings)


def test_only_this_linters_prefix_is_a_pragma():
    """Pragma-shaped strings, and the JAX package linter's own prefix,
    suppress nothing here."""
    src = ('s = "# repro-torch-lint: ignore[RL005] not a comment"\n'
           "def f(inbox, dst, m):\n"
           '    """repro-torch-lint: scatter-free"""\n'
           "    return inbox.index_put_((dst,), m)  "
           "# repro-lint: ignore[RL005] the other linter's pragma\n")
    result = run_lint_sources({"x.py": src})
    assert result.pragmas == []
    assert [f.rule for f in result.findings] == ["RL005"]


def test_port_pragma_budget_is_zero(tree_sources):
    pragmas = [p for path, src in tree_sources.items()
               for p in scan_pragmas(path, src)]
    assert pragmas == [], [f"{p.path}:{p.line}" for p in pragmas]


# --------------------------------------------------------------------------
# 3. acceptance: the tree is clean, and each guarantee is load-bearing
# --------------------------------------------------------------------------
def test_port_tree_lints_clean_under_strict():
    """The CLI with no path lints the package and chip_smoke.py."""
    assert sorted(pathlib.Path(REPO, p).resolve() for p in default_paths()
                  ) == sorted(pathlib.Path(p) for p in PORT_PATHS)
    proc = _cli("--strict")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith(
        f"0 finding(s), {len(walk_paths(PORT_PATHS))} file(s)")


def test_port_tags_cover_the_routers_and_the_open_loop_tick():
    from repro_torch.analysis.context import FileCtx, ProjectIndex

    index = ProjectIndex.build(
        FileCtx.parse(str(f), f.read_text())
        for f in walk_paths([str(REPO / "src" / "repro_torch" / "core")]))
    tagged = {tag: {fi.qualname for fi in fis}
              for tag, fis in index.tagged.items()}
    assert tagged == {"scatter-free": {"segmented_route", "cluster_route"},
                      "sync-free": {"ChainSim.tick", "gen_tick"}}


def _mutated(sources: dict, path: str, old: str, new: str):
    assert sources[path].count(old) == 1, old
    out = dict(sources)
    out[path] = sources[path].replace(old, new)
    return run_lint_sources(out, strict=True)


def test_item_two_calls_below_the_tick_fires_rl004(tree_sources):
    anchor = "    src = torch.as_tensor(src_pos, dtype=I32, device=msg.op.device)\n"
    result = _mutated(tree_sources, CHAIN, anchor,
                      anchor + "    _ = is_stale.sum().item()\n")
    assert [f.rule for f in result.findings] == ["RL004"], result.findings
    f = result.findings[0]
    assert f.path == CHAIN and ".item()" in f.message
    assert ("ChainSim.tick -> ChainSim._chain_tick -> stale_route_admission"
            in f.message), f.message


def test_index_put_in_segmented_route_fires_rl005(tree_sources):
    anchor = "    mc_cum = torch.cumsum(is_mcast.long(), dim=1)\n"
    result = _mutated(tree_sources, CHAIN, anchor,
                      anchor + "    mc_cum.index_put_((idx,), idx)\n")
    assert [(f.rule, f.path) for f in result.findings] == [("RL005", CHAIN)]
    assert "segmented_route" in result.findings[0].message


@pytest.mark.parametrize("path,old,new,lane", [
    (TYPES, "dst=torch.full(shape, NOWHERE, dtype=I32, device=dev)",
     "dst=torch.full(shape, NOWHERE, device=dev)", "Msg.dst"),
    (CHAIN, "t=torch.zeros((), dtype=I32, device=dev)",
     "t=torch.zeros((), device=dev)", "SimState.t"),
], ids=["Msg", "SimState"])
def test_dtype_less_lane_fires_rl003(tree_sources, path, old, new, lane):
    """``Msg.empty``'s construction in core/types.py (core/chain.py builds
    no ``Msg(...)`` itself) and ``ChainSim.init_state``'s ``SimState(...)``
    in core/chain.py, one lane turned dtype-less."""
    result = _mutated(tree_sources, path, old, new)
    assert [(f.rule, f.path) for f in result.findings] == [("RL003", path)]
    assert result.findings[0].message.startswith(f"{lane} is an int32 lane")


# --------------------------------------------------------------------------
# 4. reporters and CLI
# --------------------------------------------------------------------------
def test_json_report_round_trips(tmp_path):
    out = tmp_path / "report.json"
    proc = _cli(str(CORPUS / "rl005_bad.py"), "--json", str(out))
    assert proc.returncode == 1
    report = json.loads(out.read_text())
    assert report["version"] == 1
    assert report["rules"] == list(PORT_RULES)
    api = run_lint([str(CORPUS / "rl005_bad.py")])
    assert findings_from_json(report) == api.findings
    assert report["summary"] == {"total": 8, "per_rule": {"RL005": 8}}
    assert render_json(api)["findings"] == report["findings"]
    # bare --json prints the same report in place of the human one
    bare = _cli("--json", "--", str(CORPUS / "rl005_bad.py"))
    assert bare.returncode == 1
    assert findings_from_json(json.loads(bare.stdout)) == api.findings


def test_human_output_format():
    proc = _cli(str(CORPUS / "rl005_bad.py"))
    path, line, col, rest = proc.stdout.splitlines()[0].split(":", 3)
    assert path.endswith("rl005_bad.py") and line.isdigit() and col.isdigit()
    assert rest.strip().startswith("RL005")


def test_cli_exit_codes(tmp_path):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    assert _cli(str(clean)).returncode == 0
    assert _cli(str(CORPUS / "rl004_bad.py")).returncode == 1
    assert _cli("no/such/path").returncode == 2
    assert _cli("--rules", "RL001", str(clean)).returncode == 2
    assert _cli("--rules", "RL9", str(clean)).returncode == 2
    assert _cli("--bogus-flag").returncode == 2


def test_rule_subset_selection():
    result = run_lint([str(CORPUS / "rl004_bad.py")],
                      rules=["RL003", "RL005"])
    assert result.findings == [] and result.rules == ["RL003", "RL005"]


def test_list_rules():
    proc = _cli("--list-rules")
    assert proc.returncode == 0
    for rid in PORT_RULES:
        assert rid in proc.stdout
    assert "RL001" not in proc.stdout and "RL002" not in proc.stdout


def test_linter_imports_neither_torch_nor_jax():
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, repro_torch.analysis; "
         "print(sorted(m for m in ('torch', 'jax', 'repro') "
         "if m in sys.modules))"],
        env={**os.environ, "PYTHONPATH": str(REPO / "src")},
        capture_output=True, text=True, check=True)
    assert proc.stdout.strip() == "[]"


# --------------------------------------------------------------------------
# 5. parity with the JAX package's linter on the same inputs
# --------------------------------------------------------------------------
# Every way this linter means to differ from ``repro.analysis``; the
# parity tests hold everything else equal, and each entry is checked by
# ``test_intended_difference``.
INTENDED_DIFFERENCES = {
    "pragma prefix": "a pragma is `# repro-torch-lint: ignore[...]`; the "
                     "reference reads `# repro-lint: ignore[...]`, and "
                     "neither reads the other's",
    "rule catalogue": "RL003-RL005 only: RL001 and RL002 are unknown ids "
                      "(`--rules RL001` exits 2)",
    "json rules key": "the JSON report lists the rules it ran under "
                      "`rules`",
    "bare --json": "`--json` with no PATH prints the JSON report in place "
                   "of the human one; the reference needs a PATH",
    "no path": "the CLI with no path lints the port's tree; the reference "
               "exits 2",
    "summary prefix": "the human summary opens with `repro-torch-lint:`",
}


def _to_ref(text: str) -> str:
    return text.replace("repro-torch-lint:", "repro-lint:")


def _records(items) -> list:
    return [dataclasses.asdict(x) for x in items]


def _run_main(main, argv) -> int:
    try:
        return main(argv)
    except SystemExit as e:          # argparse's usage errors
        return e.code


# sources that only RL000 speaks about, in the port's pragma prefix
META_CASES = {
    "syntax error": {"a.py": "def f(:\n"},
    "indentation error": {"a.py": "def f():\nreturn 1\n"},
    "unknown id": {
        "a.py": "x = 1  # repro-torch-lint: ignore[RL999] no such rule\n"},
    "empty ids": {
        "a.py": "x = 1  # repro-torch-lint: ignore[] nothing named\n"},
    "no reason": {"a.py": "# repro-torch-lint: ignore[RL005]\nx = 1\n"},
    "two ids": {
        "a.py": "# repro-torch-lint: ignore[RL003, RL005] both known\n"
                "x = 1\n"},
    "several files": {
        "a.py": "x = (\n",
        "b.py": "y = 2  # repro-torch-lint: ignore[RL004,RL777]\n"},
}

PRAGMA_TEXT = (
    "x = 1  # repro-torch-lint: ignore[RL003] trailing, with a reason\n"
    "# repro-torch-lint: ignore[RL004, RL005]   own line, two ids\n"
    "y = 2  #repro-torch-lint:ignore[RL005]\n"
    's = "# repro-torch-lint: ignore[RL005] a string, not a comment"\n'
    "z = 3  # repro-torch-lint: ignore RL005 no brackets\n"
    "def f():\n"
    "    # repro-torch-lint: ignore[] empty\n"
    "    return 1\n")


def test_parity_walk_and_excluded_dirs():
    assert port_engine.EXCLUDED_DIRS == ref_engine.EXCLUDED_DIRS
    roots = [str(REPO / "tests"), str(REPO / "src")]
    walked = walk_paths(roots)
    assert walked == ref.walk_paths(roots)
    assert len(walked) > 100
    one = [str(CORPUS / "rl003_bad.py")]
    assert walk_paths(one) == ref.walk_paths(one)
    for walk in (walk_paths, ref.walk_paths):
        with pytest.raises(FileNotFoundError):
            walk(["no/such/path"])


@pytest.mark.parametrize("strict", [False, True], ids=["lax", "strict"])
@pytest.mark.parametrize("case", sorted(META_CASES))
def test_parity_meta_findings(case, strict):
    sources = META_CASES[case]
    port = run_lint_sources(sources, strict=strict)
    want = ref.run_lint_sources(
        {p: _to_ref(t) for p, t in sources.items()}, strict=strict)
    assert port.findings or port.pragmas, case
    assert _records(port.findings) == _records(want.findings)
    assert _records(port.suppressed) == _records(want.suppressed)
    assert _records(port.pragmas) == _records(want.pragmas)
    assert port.files == want.files and port.ok == want.ok


def test_parity_scan_pragmas():
    port = port_pragmas.scan_pragmas("a.py", PRAGMA_TEXT)
    want = ref_pragmas.scan_pragmas("a.py", _to_ref(PRAGMA_TEXT))
    assert [(p.line, p.rules) for p in port] == [
        (1, ("RL003",)), (2, ("RL004", "RL005")), (3, ("RL005",)),
        (7, ())]
    assert _records(port) == _records(want)
    assert [p.target_line for p in port] == [p.target_line for p in want]


def test_parity_apply_suppressions():
    rows = [("a.py", 1, 0, "RL003", "m"), ("a.py", 1, 2, "RL005", "m"),
            ("a.py", 3, 4, "RL004", "m"), ("a.py", 3, 4, "RL005", "m"),
            ("a.py", 4, 0, "RL005", "m"), ("a.py", 8, 0, "RL003", "m"),
            ("b.py", 1, 0, "RL003", "m")]
    port = port_pragmas.apply_suppressions(
        [port_report.Finding(*r) for r in rows],
        port_pragmas.scan_pragmas("a.py", PRAGMA_TEXT))
    want = ref_pragmas.apply_suppressions(
        [ref_report.Finding(*r) for r in rows],
        ref_pragmas.scan_pragmas("a.py", _to_ref(PRAGMA_TEXT)))
    assert [len(x) for x in port] == [4, 3]      # (active, suppressed)
    assert [_records(x) for x in port] == [_records(x) for x in want]


@pytest.mark.parametrize("strict", [False, True], ids=["lax", "strict"])
def test_parity_reports(strict):
    sources = {**META_CASES["several files"],
               "c.py": "# repro-torch-lint: ignore[RL005]\nx = 1\n"}
    port = run_lint_sources(sources, strict=strict)
    want = ref.run_lint_sources(
        {p: _to_ref(t) for p, t in sources.items()}, strict=strict)
    got = render_json(port, strict=strict)
    assert got.pop("rules") == list(RULES)
    assert got == ref_report.render_json(want, strict=strict)
    assert findings_from_json(got) == port.findings
    assert (_records(ref_report.findings_from_json(got))
            == _records(want.findings))
    human = io.StringIO(), io.StringIO()
    port_report.render_human(port, human[0])
    ref_report.render_human(want, human[1])
    assert human[0].getvalue() == human[1].getvalue().replace(
        "repro-lint:", "repro-torch-lint:")


def _cli_cases(tmp_path) -> dict:
    files = {"clean.py": "x = 1\n", "broken.py": "def f(:\n",
             "noreason.py": "# repro-torch-lint: ignore[RL005]\nx = 1\n"}
    for side in ("port", "ref"):
        d = tmp_path / side
        d.mkdir()
        for name, text in files.items():
            (d / name).write_text(text if side == "port" else _to_ref(text))
    return {
        "clean": (["{d}/clean.py"], 0),
        "syntax error": (["{d}/broken.py"], 1),
        "directory": (["{d}"], 1),
        "reasonless lax": (["{d}/noreason.py"], 0),
        "reasonless strict": (["--strict", "{d}/noreason.py"], 1),
        "rule subset": (["--rules", "RL003,RL005", "{d}/clean.py"], 0),
        "missing path": (["{d}/no/such/path"], 2),
        "unknown rule": (["--rules", "RL999", "{d}/clean.py"], 2),
        "unknown flag": (["--bogus-flag", "{d}/clean.py"], 2),
        "list rules": (["--list-rules"], 0),
    }


def test_parity_cli_exit_codes(tmp_path, capsys):
    for case, (argv, code) in _cli_cases(tmp_path).items():
        for side, main in (("port", port_cli.main), ("ref", ref_cli.main)):
            args = [a.format(d=tmp_path / side) for a in argv]
            assert _run_main(main, args) == code, (case, side)
        capsys.readouterr()


def test_parity_cli_json_file(tmp_path, capsys):
    _cli_cases(tmp_path)
    reports = {}
    for side, main in (("port", port_cli.main), ("ref", ref_cli.main)):
        out = tmp_path / f"{side}.json"
        code = _run_main(main, [str(tmp_path / side), "--strict",
                                "--json", str(out)])
        assert code == 1, side
        report = json.loads(out.read_text())
        text = json.dumps(report, sort_keys=True)
        reports[side] = json.loads(text.replace(str(tmp_path / side), "D"))
    capsys.readouterr()
    assert reports["port"].pop("rules") == list(RULES)
    assert reports["port"] == reports["ref"]
    assert reports["port"]["summary"]["per_rule"] == {"RL000": 2}


def _difference_checks(tmp_path, capsys, monkeypatch):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    theirs = "x = 1  # repro-lint: ignore[RL005] the reference's pragma\n"

    def pragma_prefix():
        assert port_pragmas.scan_pragmas("a.py", theirs) == []
        assert len(ref_pragmas.scan_pragmas("a.py", theirs)) == 1
        assert len(port_pragmas.scan_pragmas("a.py", PRAGMA_TEXT)) == 4
        assert ref_pragmas.scan_pragmas("a.py", PRAGMA_TEXT) == []

    def rule_catalogue():
        assert set(ref.RULES) - set(RULES) == {"RL001", "RL002"}
        assert set(RULES) < set(ref.RULES)
        assert _run_main(port_cli.main, ["--rules", "RL001", str(clean)]) == 2
        assert _run_main(ref_cli.main, ["--rules", "RL001", str(clean)]) == 0

    def json_rules_key():
        got = render_json(run_lint([str(clean)]))
        want = ref_report.render_json(ref.run_lint([str(clean)]))
        assert set(got) - set(want) == {"rules"} and set(want) < set(got)

    def bare_json():
        capsys.readouterr()
        assert _run_main(ref_cli.main, [str(clean), "--json"]) == 2
        assert _run_main(port_cli.main, ["--json", "--", str(clean)]) == 0
        assert json.loads(capsys.readouterr().out)["files"] == 1

    def no_path():
        assert _run_main(ref_cli.main, []) == 2
        monkeypatch.setattr(port_cli, "default_paths", lambda: [str(clean)])
        capsys.readouterr()
        assert _run_main(port_cli.main, []) == 0
        assert capsys.readouterr().out.endswith(
            "repro-torch-lint: 0 finding(s), 1 file(s)\n")

    def summary_prefix():
        lines = io.StringIO(), io.StringIO()
        port_report.render_human(run_lint([str(clean)]), lines[0])
        ref_report.render_human(ref.run_lint([str(clean)]), lines[1])
        assert lines[0].getvalue().startswith("repro-torch-lint: ")
        assert lines[1].getvalue().startswith("repro-lint: ")

    return {"pragma prefix": pragma_prefix, "rule catalogue": rule_catalogue,
            "json rules key": json_rules_key, "bare --json": bare_json,
            "no path": no_path, "summary prefix": summary_prefix}


@pytest.mark.parametrize("difference", sorted(INTENDED_DIFFERENCES))
def test_intended_difference(difference, tmp_path, capsys, monkeypatch):
    checks = _difference_checks(tmp_path, capsys, monkeypatch)
    assert set(checks) == set(INTENDED_DIFFERENCES)
    checks[difference]()
