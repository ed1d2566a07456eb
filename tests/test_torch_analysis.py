"""Fixture suite for ``repro_torch.analysis`` (torchlint), held against
the reference's ``repro.analysis`` (jaxlint).

Every test of ``tests/test_jaxlint.py`` has a counterpart here, written
in torch idiom: positive snippets (the fault class each rule exists to
catch) and negative ones pinning the conservatism (the idioms the port
actually uses must NOT be flagged). Snippets are linted inside a tmp
fake repo tree so the path-scoped rules (TL003, TL100, TL101) see
in-scope paths; ``--select`` isolates each rule from the others. The
port's own capture patterns are pinned on its real files: the
capture-wrapper positions of ``fused._Graph`` and ``montecarlo.
_ChunkGraph``, the k-means++ ``draw`` closure, and the clone-before-
next-replay reads of ``montecarlo`` and ``launch.serve``.

The reference comparisons run both gates on the same inputs: the
suppression, fingerprint and baseline machinery (ids mapped JL -> TL),
the repo rules (TL100-TL102 against JL100-JL102), key reuse (TL002 on
``repro_torch.prng`` against JL002 on ``jax.random``) and the JSON
report's schema. Neither gate imports torch or jax, and neither does
this file.
"""

import ast
import json
import pathlib
import subprocess
import sys
import textwrap
import time

import pytest

from repro.analysis import findings as ref_findings
from repro.analysis import run_lint as ref_run_lint
from repro.analysis.registry import RULES as REF_RULES
from repro_torch.analysis import findings, main, run_lint
from repro_torch.analysis.context import FileContext
from repro_torch.analysis.registry import RULES
from repro_torch.analysis.rules_prng import DERIVES, DRAWS

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO_ROOT / "src" / "repro_torch"

IN_SCOPE = "src/repro_torch/core/sampling/snippet.py"     # TL003/TL100 scope
EXP_SCOPE = "src/repro_torch/experiments/snippet.py"      # TL101 scope too
NO_SCOPE = "src/repro_torch/models/snippet.py"            # outside TL003


def lint(tmp_path, code, rel=IN_SCOPE, select=None, **kw):
    """Write one snippet into a fake tree and lint just that file."""
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(code))
    return run_lint([rel], root=tmp_path,
                    baseline_path=tmp_path / "baseline.json",
                    select=select, **kw)


def ref_lint(tmp_path, code, rel, select):
    """The reference gate on one snippet in its own fake tree."""
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(code))
    return ref_run_lint([rel], root=tmp_path,
                        baseline_path=tmp_path / "baseline.json",
                        select=select)


def rules_of(report):
    """Rule ids of the active findings, in report order."""
    return [f.rule for f in report.active]


def lines_of(report):
    """(line, col) of the active findings, in report order."""
    return [(f.line, f.col) for f in report.active]


def to_port(text: str) -> str:
    """A reference id, comment or path in the port's terms."""
    return (text.replace("jaxlint", "torchlint").replace("JL", "TL")
            .replace("src/repro/", "src/repro_torch/"))


def port_context(rel: str) -> FileContext:
    """The analysis context of one of the port's real files."""
    path = REPO_ROOT / rel
    return FileContext(path, rel, path.read_text())


# ---------------------------------------------------------------- registry
def test_rule_registry_complete():
    """The full pack is registered: capture discipline + repo contracts."""
    assert sorted(RULES) == ["TL001", "TL002", "TL003", "TL004", "TL005",
                             "TL006", "TL100", "TL101", "TL102"]
    assert sorted(RULES) == sorted(to_port(r) for r in REF_RULES)


# ----------------------------------------------- TL001 host-sync-in-capture
def test_tl001_item_in_compiled_function(tmp_path):
    r = lint(tmp_path, """
        import torch

        @torch.compile
        def f(x):
            return x.item()
    """, select=["TL001"])
    assert rules_of(r) == ["TL001"]
    assert ".item()" in r.active[0].message


def test_tl001_np_asarray_in_function_passed_to_compile(tmp_path):
    r = lint(tmp_path, """
        import numpy as np
        import torch

        def body(x):
            return np.asarray(x) + 1

        run = torch.compile(body)
    """, select=["TL001"])
    assert rules_of(r) == ["TL001"]


def test_tl001_print_in_callee_of_a_capture_block(tmp_path):
    r = lint(tmp_path, """
        import torch

        def helper(x):
            print(x)
            return x * 2

        def capture(x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out = helper(x)
            return g, out
    """, select=["TL001"])
    assert rules_of(r) == ["TL001"]


def test_tl001_negative_host_code_and_static_attrs(tmp_path):
    r = lint(tmp_path, """
        import numpy as np
        import torch

        def host_summary(x):
            return float(np.asarray(x.cpu()).sum()) + x.item()

        @torch.compile
        def f(x):
            n = x.shape[0]
            m = int(x.numel()) + x.dim()
            return x * n * m
    """, select=["TL001"])
    assert rules_of(r) == []


@pytest.mark.parametrize("call", [
    "torch.tensor([1.0], device=x.device)",
    "torch.as_tensor(np.ones(3), device=x.device)",
    "torch.from_numpy(np.ones(3)).to(x.device)",
    "torch.arange(4).to(x.device)",
    "np.ones(3).cuda()",
    "x.to('cpu')",
    "x.cpu()",
    "x.tolist()",
    "torch.cuda.synchronize()",
])
def test_tl001_host_transfers_in_a_capture_block(tmp_path, call):
    """Every host round-trip and host-to-device copy is flagged inside
    a ``with torch.cuda.graph`` block — once."""
    r = lint(tmp_path, f"""
        import numpy as np
        import torch

        def capture(x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = {call}
            return g, y
    """, select=["TL001"])
    assert rules_of(r) == ["TL001"]


# --------------------------------------------------- TL002 prng-key-reuse
def test_tl002_key_consumed_by_two_draws(tmp_path):
    r = lint(tmp_path, """
        from repro_torch import prng

        def f(key):
            a = prng.normal(key, (3,))
            b = prng.uniform(key, (3,))
            return a + b
    """, select=["TL002"])
    assert rules_of(r) == ["TL002"]
    assert "split" in r.active[0].message


def test_tl002_loop_invariant_key_reuse(tmp_path):
    r = lint(tmp_path, """
        from repro_torch import prng

        def f(key, n):
            out = []
            for i in range(n):
                out.append(prng.normal(key, ()))
            return out
    """, select=["TL002"])
    assert rules_of(r) == ["TL002"]


def test_tl002_negative_split_between_draws(tmp_path):
    r = lint(tmp_path, """
        from repro_torch import prng

        def f(key):
            k1, k2 = prng.split(key)
            a = prng.normal(k1, ())
            b = prng.normal(k2, ())
            return a + b

        def g(key, i):
            a = prng.normal(prng.fold_in(key, i), ())
            key = prng.fold_in(key, 1)
            b = prng.normal(key, ())
            return a + b
    """, select=["TL002"])
    assert rules_of(r) == []


def test_tl002_negative_branches_are_alternatives(tmp_path):
    r = lint(tmp_path, """
        from repro_torch import prng

        def f(key, flag):
            if flag:
                a = prng.normal(key, ())
            else:
                a = prng.uniform(key, ())
            return a
    """, select=["TL002"])
    assert rules_of(r) == []


def test_tl002_stacked_key_lanes(tmp_path):
    """The port's keys are stacked lanes: a subscript of a key stack is
    a key; the same subscript drawn twice is reuse, two lanes are not,
    and a loop index rebinding frees ``keys[i]``."""
    r = lint(tmp_path, """
        from repro_torch import prng

        def f(keys, n):
            a = prng.randint(keys[:, 0], (), 0, n)
            b = prng.uniform(keys[:, 1:], ())
            out = [prng.normal(keys[i], ()) for i in range(n)]
            for i in range(n):
                out.append(prng.normal(keys[i], ()))
            c = prng.choice(keys[:, 0], b)
            return a, b, c, out
    """, select=["TL002"])
    assert lines_of(r) == [(10, 8)]


def test_tl002_draw_list_is_read_off_prng():
    """Every function of ``prng.__all__`` that takes a key either draws
    from it (consumes it) or derives keys from it, and the rule's lists
    name no other function."""
    tree = ast.parse((PORT / "prng.py").read_text())
    exported = next(ast.literal_eval(node.value) for node in tree.body
                    if isinstance(node, ast.Assign)
                    and getattr(node.targets[0], "id", "") == "__all__")
    takes_key = {node.name for node in tree.body
                 if isinstance(node, ast.FunctionDef)
                 and node.name in exported and node.args.args
                 and node.args.args[0].arg == "key"}
    assert not DRAWS & DERIVES
    assert DRAWS | DERIVES == takes_key


# -------------------------------------------------- TL003 raw-dtype-literal
def test_tl003_torch_dtype_attribute(tmp_path):
    r = lint(tmp_path, """
        import torch

        def f(x):
            return torch.as_tensor(x, dtype=torch.float32)
    """, select=["TL003"])
    assert rules_of(r) == ["TL003"]
    assert "torch.float32" in r.active[0].message


def test_tl003_astype_string_and_dtype_kwarg(tmp_path):
    r = lint(tmp_path, """
        import numpy as np

        def f(x):
            return x.astype("float32")

        def g(n):
            return np.zeros(n, dtype="bfloat16")
    """, select=["TL003"])
    assert rules_of(r) == ["TL003", "TL003"]


def test_tl003_cast_methods_at_the_method_line(tmp_path):
    """``.float()``/``.double()``/``.half()``/``.bfloat16()`` cast to a
    fixed dtype; a chained call is reported on the method's own line."""
    r = lint(tmp_path, """
        import torch

        def f(x, y):
            a = x.float() + y.half()
            b = (x * 2
                 ).double()
            return a, b, y.bfloat16()
    """, select=["TL003"])
    assert [f.line for f in r.active] == [5, 5, 7, 8]


def test_tl003_negative_policy_and_host_f64(tmp_path):
    r = lint(tmp_path, """
        import numpy as np

        def f(x, policy):
            y = np.asarray(x, np.float64)
            return y.astype(policy.host_dtype)

        def g(x, policy):
            return x.to(policy.accum_dtype).to(dtype=policy.trace_dtype)
    """, select=["TL003"])
    assert rules_of(r) == []


def test_tl003_negative_out_of_scope_path(tmp_path):
    r = lint(tmp_path, """
        import torch

        X = torch.ones(1, dtype=torch.bfloat16).float()
    """, rel=NO_SCOPE, select=["TL003"])
    assert rules_of(r) == []


# ------------------------------------------------ TL004 read-after-replay
def test_tl004_read_after_the_next_replay(tmp_path):
    r = lint(tmp_path, """
        def drive(graph, x, y):
            out = graph.replay(x)
            nxt = graph.replay(y)
            return out["est"].sum() + nxt["est"].sum()
    """, select=["TL004"])
    assert rules_of(r) == ["TL004"]
    assert "`out` holds the buffers of graph `graph`" \
        in r.active[0].message


def test_tl004_module_level_replaying_closure(tmp_path):
    """A module-scope driver of a factory's step closure (the counterpart
    of JL004's module-constant indirection): the factory is known to
    return a replaying function, so its calls are replays."""
    r = lint(tmp_path, """
        import torch

        def graphed(fn, tok):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                logits = fn(tok)

            def step(t):
                tok.copy_(t)
                graph.replay()
                return logits

            return step

        step = graphed(model, tok0)
        a = step(t0)
        b = step(t1)
        z = a + b
    """, select=["TL004"])
    assert rules_of(r) == ["TL004"]
    assert r.active[0].line == 19


def test_tl004_negative_rebinding_restores_ownership(tmp_path):
    r = lint(tmp_path, """
        def drive(graph, x, y):
            out = graph.replay(x)
            out = {k: v.clone() for k, v in out.items()}
            est = graph.replay(y)["est"].clone()
            return out["est"] + est
    """, select=["TL004"])
    assert rules_of(r) == []


def test_tl004_negative_wrapper_whose_replay_copies(tmp_path):
    """A wrapper of the module whose ``replay`` returns copies, not its
    captured outputs, hands the caller tensors of its own."""
    r = lint(tmp_path, """
        import torch

        class Copying:
            def __init__(self, fn, x):
                self.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.graph):
                    self.out = fn(x)

            def replay(self):
                self.graph.replay()
                return self.out.clone()

        def drive(fn, x):
            g = Copying(fn, x)
            a = g.replay()
            b = g.replay()
            return a + b
    """, select=["TL004"])
    assert rules_of(r) == []


def test_tl004_views_and_containers_alias_the_buffers(tmp_path):
    """A view of a replay output, and a container it was stored in,
    hold the graph's buffers too; a copy does not."""
    r = lint(tmp_path, """
        def drive(graph, xs):
            kept, firsts = [], []
            for x in xs:
                ys, mom = graph.replay(x)
                kept.append(ys)
                head = mom[0].reshape(-1)
                firsts.append(head.to(copy=True))
                by_x[x] = mom.t()
            last = graph.replay(xs[0])
            return kept, head, firsts, by_x, last
    """, select=["TL004"])
    assert sorted((f.line, f.message.split("`")[1]) for f in r.active) \
        == [(6, "kept"), (9, "by_x"), (11, "head")]


# -------------------------------------------- TL005 tensor-branch-in-capture
def test_tl005_if_on_captured_param(tmp_path):
    r = lint(tmp_path, """
        import torch

        @torch.compile
        def f(x):
            if x > 0:
                return x
            return -x
    """, select=["TL005"])
    assert rules_of(r) == ["TL005"]
    assert "torch.where" in r.active[0].message


def test_tl005_for_over_captured_param(tmp_path):
    r = lint(tmp_path, """
        import torch

        def body(xs):
            total = 0.0
            for x in xs:
                total = total + x
            return total

        run = torch.compile(body)
    """, select=["TL005"])
    assert rules_of(r) == ["TL005"]


def test_tl005_negative_host_scalar_annotations(tmp_path):
    """The counterpart of ``static_argnames``: a parameter annotated as
    a host scalar is frozen into the capture as a Python value."""
    r = lint(tmp_path, """
        import torch

        @torch.compile
        def f(x, n: int, causal: bool = True):
            if n > 2 and causal:
                return x
            return x * 2.0
    """, select=["TL005"])
    assert rules_of(r) == []


def test_tl005_negative_config_hint_and_shape(tmp_path):
    r = lint(tmp_path, """
        import torch

        @torch.compile
        def f(x, cfg, d: dict):
            if cfg.deep:
                x = x * 2.0
            while f"t{len(d)}" in d:
                d = {}
            if x.ndim == 2 and x.numel() > 4:
                return x
            return x[None] if d.get("w") is None else x
    """, select=["TL005"])
    assert rules_of(r) == []


def test_tl005_boolean_operators_and_conditional_expressions(tmp_path):
    r = lint(tmp_path, """
        import torch

        @torch.compile
        def f(x, y):
            a = x if y.sum() > 0 else -x
            b = (x > 0) or y
            c = not y
            if x.any() and y:
                return a
            return a + b + c
    """, select=["TL005"])
    assert [f.line for f in r.active] == [6, 7, 8, 9]


# --------------------------------------------- TL006 vmap-of-kernel-op
def test_tl006_vmap_of_local_kernel_wrapper(tmp_path):
    r = lint(tmp_path, """
        import torch
        from repro_torch.kernels import backend

        def op(x):
            lib = backend.library("segment_stats")
            return lib.segment_stats(backend.ptr(x))

        batched = torch.vmap(op)
    """, select=["TL006"])
    assert rules_of(r) == ["TL006"]
    assert "batch" in r.active[0].message


def test_tl006_vmap_of_repro_torch_kernels_op(tmp_path):
    r = lint(tmp_path, """
        import torch
        from repro_torch.kernels.segment_stats.ops import segment_stats
        from repro_torch.kernels.kmeans_assign import ops

        v = torch.vmap(segment_stats)
        w = torch.func.vmap(lambda x, c: ops.kmeans_assign(x, c))
    """, select=["TL006"])
    assert rules_of(r) == ["TL006", "TL006"]


def test_tl006_negative_vmap_of_plain_function(tmp_path):
    r = lint(tmp_path, """
        import torch
        from repro_torch.kernels.segment_stats.ref import segment_stats_ref

        def plain(x):
            return torch.sum(x * x)

        v = torch.vmap(plain)
        w = torch.vmap(segment_stats_ref)
    """, select=["TL006"])
    assert rules_of(r) == []


# ------------------------------------------------------ TL100 api-surface
def test_tl100_missing_dunder_all(tmp_path):
    r = lint(tmp_path, """
        X = 1
    """, select=["TL100"])
    assert rules_of(r) == ["TL100"]
    assert "__all__" in r.active[0].message


def test_tl100_string_literal_dispatch(tmp_path):
    r = lint(tmp_path, """
        __all__ = []

        def pick(scheme):
            if scheme == "bbv":
                return 1
            return 0
    """, select=["TL100"])
    assert rules_of(r) == ["TL100"]
    assert "registry" in r.active[0].message


def test_tl100_isinstance_dispatch_on_plan_type(tmp_path):
    r = lint(tmp_path, """
        __all__ = []

        def handle(s):
            return isinstance(s, (Stratifier, Centroid))
    """, select=["TL100"])
    assert rules_of(r) == ["TL100"]
    assert "isinstance" in r.active[0].message


def test_tl100_negative_plan_module_may_dispatch(tmp_path):
    r = lint(tmp_path, """
        __all__ = []

        def lookup(scheme, s):
            if scheme == "bbv" and isinstance(s, Stratifier):
                return 1
            return 0
    """, rel="src/repro_torch/core/sampling/plan.py", select=["TL100"])
    assert rules_of(r) == []


def test_tl100_negative_clean_module(tmp_path):
    r = lint(tmp_path, """
        __all__ = ["f"]

        def f(kind):
            return kind == "weighted"
    """, select=["TL100"])
    assert rules_of(r) == []


# ------------------------------------------------ TL101 missing-docstring
def test_tl101_missing_module_docstring(tmp_path):
    r = lint(tmp_path, """
        X = 1
    """, rel=EXP_SCOPE, select=["TL101"])
    assert rules_of(r) == ["TL101"]


def test_tl101_missing_public_function_and_class_docstrings(tmp_path):
    r = lint(tmp_path, '''
        """Module docstring."""

        def public_fn():
            return 1

        class PublicClass:
            pass
    ''', rel=EXP_SCOPE, select=["TL101"])
    assert rules_of(r) == ["TL101", "TL101"]


def test_tl101_negative_documented_and_private(tmp_path):
    r = lint(tmp_path, '''
        """Module docstring."""

        def public_fn():
            """Documented."""

        def _private_fn():
            return 1
    ''', rel=EXP_SCOPE, select=["TL101"])
    assert rules_of(r) == []


# ------------------------------------------------ TL102 broken-doc-link
def test_tl102_broken_link_and_missing_anchor(tmp_path):
    (tmp_path / "README.md").write_text(
        "# Real Heading\n\n[gone](docs/missing.md)\n[frag](#nope)\n")
    r = run_lint(None, root=tmp_path, baseline_path=tmp_path / "bl.json",
                 select=["TL102"])
    assert rules_of(r) == ["TL102", "TL102"]


def test_tl102_negative_resolving_links(tmp_path):
    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "guide.md").write_text("# Guide Heading\n")
    (tmp_path / "README.md").write_text(
        "# Top\n\n[ok](docs/guide.md#guide-heading)\n[self](#top)\n"
        "[web](https://example.com)\n")
    r = run_lint(None, root=tmp_path, baseline_path=tmp_path / "bl.json",
                 select=["TL102"])
    assert rules_of(r) == []


# ------------------------------------------------------------ suppression
_VIOLATION = """
    import torch

    X = torch.ones(1, dtype=torch.float32)
"""


def test_inline_suppression_comment(tmp_path):
    code = _VIOLATION.replace(
        "torch.float32)", "torch.float32)  # torchlint: disable=TL003")
    r = lint(tmp_path, code, select=["TL003"])
    assert rules_of(r) == []
    assert r.suppressed == 1


def test_file_level_suppression_comment(tmp_path):
    r = lint(tmp_path, """
        # torchlint: disable-file=TL003
        import torch

        X = torch.ones(1, dtype=torch.float32)
        Y = torch.ones(1, dtype=torch.float16)
    """, select=["TL003"])
    assert rules_of(r) == []
    assert r.suppressed == 2


def test_suppression_is_rule_specific(tmp_path):
    code = _VIOLATION.replace(
        "torch.float32)", "torch.float32)  # torchlint: disable=TL001")
    r = lint(tmp_path, code, select=["TL003"])
    assert rules_of(r) == ["TL003"]       # wrong rule id: not covered


# --------------------------------------------------------------- baseline
def test_baseline_roundtrip_and_staleness(tmp_path):
    bl = tmp_path / "baseline.json"
    r1 = lint(tmp_path, _VIOLATION, select=["TL003"])
    assert rules_of(r1) == ["TL003"] and not r1.ok

    r2 = lint(tmp_path, _VIOLATION, select=["TL003"], update_baseline=True)
    assert bl.exists() and len(r2.baselined) == 1

    entries = json.loads(bl.read_text())["entries"]
    assert len(entries) == 1 and entries[0]["rule"] == "TL003"
    assert entries[0]["justification"]          # placeholder is non-empty

    r3 = lint(tmp_path, _VIOLATION, select=["TL003"])
    assert r3.ok and rules_of(r3) == [] and len(r3.baselined) == 1

    # fixing the violation makes the baseline entry stale -> build fails
    r4 = lint(tmp_path, "import torch\nX = 1\n", select=["TL003"])
    assert not r4.ok and len(r4.stale) == 1 and rules_of(r4) == []


def test_baseline_survives_line_drift_but_not_new_violations(tmp_path):
    lint(tmp_path, _VIOLATION, select=["TL003"], update_baseline=True)
    drifted = "import torch\n\n\n# pushed down\n" \
        "X = torch.ones(1, dtype=torch.float32)\n"
    r = lint(tmp_path, drifted, select=["TL003"])
    assert r.ok and len(r.baselined) == 1     # same code line, new lineno

    doubled = drifted + "Y = torch.ones(2, dtype=torch.float32)\n"
    r2 = lint(tmp_path, doubled, select=["TL003"])
    assert rules_of(r2) == ["TL003"]          # the NEW line is active


def test_unjustified_baseline_entry_is_an_error(tmp_path):
    bl = tmp_path / "baseline.json"
    lint(tmp_path, _VIOLATION, select=["TL003"], update_baseline=True)
    payload = json.loads(bl.read_text())
    payload["entries"][0]["justification"] = "  "
    bl.write_text(json.dumps(payload))
    r = lint(tmp_path, _VIOLATION, select=["TL003"])
    assert not r.ok and r.errors and "justification" in r.errors[0]


# ------------------------------------------------------------ JSON schema
def test_json_report_schema(tmp_path):
    r = lint(tmp_path, _VIOLATION, select=["TL003"])
    d = r.to_json()
    assert d["version"] == 1
    assert set(d) == {"version", "root", "rules", "findings", "summary"}
    assert [row["id"] for row in d["rules"]] == sorted(RULES)
    f = d["findings"][0]
    assert set(f) == {"rule", "path", "line", "col", "message", "status"}
    assert f["status"] == "active"
    s = d["summary"]
    assert {"files", "active", "baselined", "suppressed", "stale_baseline",
            "errors", "duration_s", "ok"} <= set(s)
    assert s["active"] == 1 and s["ok"] is False
    json.dumps(d)                             # round-trips to JSON


# ------------------------------------------------------------------- CLI
def test_cli_list_rules_and_bad_select(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in RULES.values():
        assert f"{rule.id} {rule.name}" in out
        for prefix in rule.scope or ():
            assert prefix in out
    assert main(["--select", "TL999"]) == 2


def test_cli_json_exit_codes(tmp_path, capsys):
    path = tmp_path / IN_SCOPE
    path.parent.mkdir(parents=True)
    path.write_text(textwrap.dedent(_VIOLATION))
    code = main([IN_SCOPE, "--root", str(tmp_path), "--select", "TL003",
                 "--baseline", str(tmp_path / "bl.json"), "--json"])
    out = json.loads(capsys.readouterr().out)
    assert code == 1 and out["summary"]["active"] == 1
    assert main([IN_SCOPE, "--root", str(tmp_path), "--select", "TL101",
                 "--baseline", str(tmp_path / "bl.json")]) == 0


def test_cli_parse_error_exits_2(tmp_path):
    path = tmp_path / IN_SCOPE
    path.parent.mkdir(parents=True)
    path.write_text("def broken(:\n")
    assert main([IN_SCOPE, "--root", str(tmp_path),
                 "--baseline", str(tmp_path / "bl.json")]) == 2


# ------------------------------------------- the port's capture patterns
def test_capture_wrapper_positions_of_fused_and_montecarlo():
    """``fused._Graph(traced, ...)`` and ``montecarlo._ChunkGraph(step,
    ...)`` capture their first argument, so the callables passed there
    are captured: the fused sweep's ``traced`` closure and the trial
    chunk's ``_StreamingProgram.step`` (with ``_block_uniforms``, which
    it calls)."""
    fused = port_context("src/repro_torch/experiments/fused.py")
    assert fused.capture_wrappers == {"_Graph": {0, "traced"}}
    assert [i.qualname for i in fused.captured_functions] == [
        "fused_sweep_program.traced"]
    mc = port_context("src/repro_torch/experiments/montecarlo.py")
    assert mc.capture_wrappers == {"_ChunkGraph": {0, "step"}}
    assert {i.qualname for i in mc.captured_functions} == {
        "_StreamingProgram.step", "_block_uniforms"}


def test_kmeans_draw_closure_is_captured():
    """The k-means++ ``draw`` closure is called inside ``with
    torch.cuda.graph(graph)``, so it is captured."""
    ctx = port_context("src/repro_torch/core/clustering/kmeans.py")
    assert [i.qualname for i in ctx.captured_functions] == [
        "_kmeanspp_init.draw"]
    assert [info.qualname for _, info in ctx.capture_blocks] == [
        "_kmeanspp_init"]


_DRAW = """
    import torch
    from repro_torch import prng

    def seed(x, w, u, k, rows, tiny):
        min_d2 = torch.sum(x * x, dim=-1)
        u_step = torch.empty(x.shape[0], device=x.device)
        new_c = torch.empty(x.shape[0], x.shape[2], device=x.device)

        def draw():
            p = min_d2 if w is None else min_d2 * w
            idx = prng.choice_u(u_step, p / torch.maximum(
                torch.sum(p, dim=1), tiny)[:, None])
            new_c.copy_(x[rows, idx])
            min_d2.copy_(torch.minimum(min_d2, torch.sum(
                (x - new_c[:, None]) ** 2, dim=-1)))
            {extra}

        graph = None
        for i in range(1, k):
            u_step.copy_(u[:, i - 1])
            if graph is not None:
                graph.replay()
            else:
                draw()
                if x.is_cuda and k > 2:
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph):
                        draw()
        return new_c
"""


@pytest.mark.parametrize("extra, rule", [
    ("pass", None),
    ("float(min_d2.max())", "TL001"),
    ("print(idx.tolist())", "TL001"),
    ("assert idx.numel() > 0", None),
    ("if min_d2.max() > 0: new_c.mul_(2)", "TL005"),
    ("new_c.add_(1) if idx.any() else None", "TL005"),
])
def test_kmeans_draw_pattern(tmp_path, extra, rule):
    """The ``draw`` closure's pattern: clean as the port writes it; a
    host read or a branch on the tensors it closes over is flagged."""
    r = lint(tmp_path, _DRAW.replace("{extra}", extra),
             select=["TL001", "TL005"])
    assert set(rules_of(r)) == ({rule} if rule else set())


_CHUNKS = """
    def run(graphs, key, n_chunks, keep):
        chunks, moments = [], []
        for c in range(n_chunks):
            graph = graphs.get(key)
            ys, mom = graph.replay(c)
            carry = graph.carry
            if keep:
                chunks.append({keep_ys})
            if mom is not None:
                moments.append({keep_mom})
        return carry.map(torch.clone), chunks, moments
"""


@pytest.mark.parametrize("keep_ys, keep_mom, flagged", [
    ("tuple(y.clone() for y in ys)", "mom.clone()", []),
    ("ys", "mom.clone()", ["chunks"]),
    ("tuple(y.clone() for y in ys)", "mom", ["moments"]),
    ("tuple(ys)", "mom[0]", ["chunks", "moments"]),
])
def test_tl004_montecarlo_clone_before_next_replay(tmp_path, keep_ys,
                                                   keep_mom, flagged):
    """``montecarlo._StreamingProgram.run``'s chunk loop clones what it
    keeps of each replay before the next one; keeping the replay's own
    tensors (or views of them) across chunks is flagged."""
    r = lint(tmp_path, _CHUNKS.replace("{keep_ys}", keep_ys)
             .replace("{keep_mom}", keep_mom), select=["TL004"])
    assert sorted(f.message.split("`")[1] for f in r.active) == flagged


_SERVE = """
    import torch

    def _graphed_decode(dfn, tok, pos):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            logits, _ = dfn(tok, pos)

        def step(tokens, p):
            tok.copy_(tokens)
            pos.fill_(p)
            graph.replay()
            return logits

        return step

    def generate(prompts, gen, tok0, pos0, decode_fn, device):
        if device.type == "cuda":
            graphed = _graphed_decode(decode_fn, tok0, pos0)

            def dfn(tokens, c, pos):
                return graphed(tokens, pos), c
        else:
            dfn = decode_fn
        tok, caches, out_tokens, first = prompts[:, -1:], None, [], None
        for i in range(gen):
            logits, caches = dfn(tok, caches, i)
            if first is None:
                first = {first}
            tok = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
            out_tokens.append(tok[:, 0])
        return torch.stack(out_tokens, dim=1), first
"""


@pytest.mark.parametrize("first, flagged", [
    ("logits[:, -1, :].to(torch.float32, copy=True)", False),
    ("logits[:, -1, :].clone()", False),
    ("logits[:, -1, :]", True),
    ("logits[:, -1, :].to(torch.float32)", True),
])
def test_tl004_serve_copy_before_next_replay(tmp_path, first, flagged):
    """``launch.serve.generate`` copies the first step's logits (the
    graph rewrites them at every step) through the replaying ``dfn``
    closure of ``_graphed_decode``'s step; a view of them is flagged."""
    r = lint(tmp_path, _SERVE.replace("{first}", first), select=["TL004"])
    assert [f.message.split("`")[1] for f in r.active] == \
        (["first"] if flagged else [])


@pytest.mark.parametrize("rel", [
    "src/repro_torch/experiments/fused.py",
    "src/repro_torch/experiments/montecarlo.py",
    "src/repro_torch/core/clustering/kmeans.py",
    "src/repro_torch/launch/serve.py",
    "src/repro_torch/serving/batcher.py",
])
def test_capture_modules_lint_clean(rel):
    """The port's capture and replay sites hold every capture rule with
    nothing suppressed or baselined."""
    r = run_lint([rel], root=REPO_ROOT,
                 baseline_path=REPO_ROOT / "no-baseline.json",
                 select=["TL001", "TL004", "TL005", "TL006"])
    assert r.ok and not r.baselined and r.suppressed == 0, \
        [f.render() for f in r.active]


# ------------------------------------------------- against the reference
_SUPPRESSION_TEXTS = [
    "X = 1  # jaxlint: disable=JL003\n",
    "X = 1  # jaxlint: disable=JL003, JL001\nY = 2\n",
    "# jaxlint: disable-file=JL002\nX = 1  #jaxlint:disable=JL100\n",
    "X = 1  # jaxlint: disable = JL003,JL004 trailing words\n",
    "X = 1  # jaxlint: disable=jl003\n# noqa\n",
]


@pytest.mark.parametrize("text", _SUPPRESSION_TEXTS)
def test_suppressions_match_reference(text):
    ref = ref_findings.Suppressions(text)
    port = findings.Suppressions(to_port(text))
    assert port.file_rules == {to_port(r) for r in ref.file_rules}
    assert port.line_rules == {k: {to_port(r) for r in v}
                               for k, v in ref.line_rules.items()}
    for rule in ("JL001", "JL002", "JL003", "JL004", "JL100"):
        for line in (1, 2):
            f = ref_findings.Finding(rule, "a.py", line, 0, "m")
            g = findings.Finding(to_port(rule), "a.py", line, 0, "m")
            assert port.covers(g) == ref.covers(f)


@pytest.mark.parametrize("line", [0, 1, 3, 4, 99])
def test_fingerprint_matches_reference(line):
    lines = ["import x", "  X = np.float32(1)  ", "", "\ty = 2\t"]
    f = ref_findings.Finding("JL003", "src/a.py", line, 4, "m")
    g = findings.Finding("TL003", "src/a.py", line, 4, "m")
    ref = ref_findings.fingerprint(f, lines)
    assert findings.fingerprint(g, lines) == (to_port(ref[0]),) + ref[1:]


def _partition_case(entries, found):
    """Both gates' partition of the same findings, ids mapped."""
    ref_bl, port_bl = ref_findings.Baseline(None), findings.Baseline(None)
    ref_bl.entries = [dict(e) for e in entries]
    port_bl.entries = [dict(e, rule=to_port(e["rule"])) for e in entries]
    ref_out = ref_bl.partition(
        [(ref_findings.Finding(r, p, n, 0, c), (r, p, c))
         for r, p, n, c in found])
    port_out = port_bl.partition(
        [(findings.Finding(to_port(r), p, n, 0, c), (to_port(r), p, c))
         for r, p, n, c in found])
    return ref_out, port_out


@pytest.mark.parametrize("entries, found", [
    ([], [("JL003", "a.py", 1, "x")]),
    ([{"rule": "JL003", "path": "a.py", "code": "x"}],
     [("JL003", "a.py", 1, "x"), ("JL003", "a.py", 2, "x")]),
    ([{"rule": "JL003", "path": "a.py", "code": " x "},
      {"rule": "JL003", "path": "a.py", "code": "x"}],
     [("JL003", "a.py", 7, "x")]),
    ([{"rule": "JL002", "path": "b.py", "code": "y"}],
     [("JL003", "b.py", 1, "y"), ("JL002", "c.py", 1, "y")]),
])
def test_baseline_partition_matches_reference(entries, found):
    ref_out, port_out = _partition_case(entries, found)
    ref_active, ref_base, ref_stale = ref_out
    active, base, stale = port_out
    assert [(f.path, f.line) for f in active] == \
        [(f.path, f.line) for f in ref_active]
    assert [(f.path, f.line) for f in base] == \
        [(f.path, f.line) for f in ref_base]
    assert [dict(e, rule=to_port(e["rule"])) for e in ref_stale] == stale


def test_port_baseline_reads_the_reference_baseline():
    """The port's ``Baseline`` reads the reference's own
    ``lint_baseline.json`` (schema version 1) as the reference does, and
    partitions the findings it describes the same way."""
    path = REPO_ROOT / "lint_baseline.json"
    ref_bl, port_bl = ref_findings.Baseline(path), findings.Baseline(path)
    assert port_bl.entries == ref_bl.entries and ref_bl.entries
    assert port_bl.errors == ref_bl.errors == []
    found = [(e["rule"], e["path"], e["line"], e["code"])
             for e in ref_bl.entries[1:]]
    found.append(("JL003", "src/repro/new.py", 3, "x = np.float32(1)"))

    def split(bl, mod):
        return bl.partition([(mod.Finding(r, p, n, 0, c), (r, p, c.strip()))
                             for r, p, n, c in found])

    ref_out, port_out = split(ref_bl, ref_findings), split(port_bl, findings)
    for a, b in zip(ref_out[:2], port_out[:2]):
        assert [(f.rule, f.path, f.line) for f in a] == \
            [(f.rule, f.path, f.line) for f in b]
    assert ref_out[2] == port_out[2] == [ref_bl.entries[0]]


def test_baseline_write_matches_reference(tmp_path):
    found = [("JL003", "b.py", 4, "y"), ("JL001", "a.py", 9, "x"),
             ("JL003", "a.py", 2, "z")]
    prior = [{"rule": "JL001", "path": "a.py", "code": "x",
              "justification": "kept"}]
    ref_findings.Baseline.write(
        tmp_path / "ref.json",
        [(ref_findings.Finding(r, p, n, 0, c), (r, p, c))
         for r, p, n, c in found], prior)
    findings.Baseline.write(
        tmp_path / "port.json",
        [(findings.Finding(to_port(r), p, n, 0, c), (to_port(r), p, c))
         for r, p, n, c in found],
        [dict(e, rule=to_port(e["rule"])) for e in prior])
    assert to_port((tmp_path / "ref.json").read_text()) == \
        (tmp_path / "port.json").read_text()


_REPO_FIXTURES = {
    "all": ("X = 1\n", "core/sampling/snippet.py"),
    "string": ('__all__ = []\n\ndef pick(scheme, kind):\n'
               '    if scheme == "bbv" or kind in ("rfv", "x"):\n'
               '        return 1\n    return scheme != "random"\n',
               "core/sampling/snippet.py"),
    "isinstance": ("__all__ = []\n\ndef h(s):\n"
                   "    a = isinstance(s, (Stratifier, Centroid))\n"
                   "    return a or isinstance(s, mod.TwoPhaseCI | int)\n",
                   "serving/snippet.py"),
    "plan": ('__all__ = []\n\ndef f(s, x):\n'
             '    return s == "dg" and isinstance(x, Stratifier)\n',
             "core/sampling/plan.py"),
    "docstrings": ('X = 1\n\ndef public():\n    return 1\n\n'
                   'class Pub:\n    def method(self):\n        pass\n'
                   '    def _private(self):\n        pass\n\n'
                   'def _hidden():\n    pass\n', "kernels/snippet.py"),
    "documented": ('"""Doc."""\n__all__ = []\n\ndef f():\n    """D."""\n',
                   "analysis/snippet.py"),
    "out_of_scope": ('X = 1\nY = "bbv" == x\n', "models/snippet.py"),
}


@pytest.mark.parametrize("name", sorted(_REPO_FIXTURES))
def test_repo_rules_flag_the_references_lines(tmp_path, name):
    """TL100/TL101 flag the lines and columns JL100/JL101 flag on the
    same text, each at its own package's path."""
    code, sub = _REPO_FIXTURES[name]
    ref = ref_lint(tmp_path / "ref", code, f"src/repro/{sub}",
                   ["JL100", "JL101"])
    port = lint(tmp_path / "port", code, f"src/repro_torch/{sub}",
                select=["TL100", "TL101"])
    assert [(to_port(f.rule), f.line, f.col) for f in ref.active] == \
        [(f.rule, f.line, f.col) for f in port.active]


@pytest.mark.parametrize("readme, docs", [
    ("# Top\n\n[a](docs/missing.md)\n[b](#nope)\n[c](#top)\n", {}),
    ("# A `b` *c*\n[x](docs/g.md#guide-heading)\n[y](docs/g.md#no)\n"
     "[z](#a-b-c)\n", {"g.md": "# Guide Heading\n[up](../README.md#a-b-c)\n"
                               "[bad](../GONE.md)\n"}),
])
def test_doc_links_flag_the_references_lines(tmp_path, readme, docs):
    for tree in ("ref", "port"):
        (tmp_path / tree / "docs").mkdir(parents=True)
        (tmp_path / tree / "README.md").write_text(readme)
        for name, text in docs.items():
            (tmp_path / tree / "docs" / name).write_text(text)
    ref = ref_run_lint(None, root=tmp_path / "ref",
                       baseline_path=tmp_path / "bl.json", select=["JL102"])
    port = run_lint(None, root=tmp_path / "port",
                    baseline_path=tmp_path / "bl.json", select=["TL102"])
    assert [(f.path, f.line, f.message) for f in ref.active] == \
        [(f.path, f.line, f.message) for f in port.active]
    assert ref.active


_KEY_FIXTURES = {
    "two_draws": """
        def f(key):
            a = R.normal(key, (3,))
            b = R.uniform(key, (3,))
            return R.bits(key, (2,)), a, b
    """,
    "loop": """
        def f(key, n, keys):
            out = []
            for i in range(n):
                out.append(R.normal(key, ()))
                key = R.fold_in(key, i)
                out.append(R.uniform(key, ()))
            while n:
                out.append(R.randint(keys, (), 0, 3))
            return out
    """,
    "branches": """
        def f(key, flag):
            if flag:
                a = R.normal(key, ())
            else:
                a = R.uniform(key, ())
            b = R.normal(key, ())
            try:
                c = R.uniform(self.key, ())
            finally:
                d = R.uniform(self.key, ())
            return a, b, c, d
    """,
    "derive": """
        def f(key, i):
            a = R.normal(R.fold_in(key, i), ())
            key = R.fold_in(key, 1)
            b = R.normal(key, ())
            (c := R.split(key))
            return a, b, R.normal(key, ()), c
    """,
    "module_scope": """
        key = R.PRNGKey(0)
        x = R.normal(key, (3,))
        with ctx():
            y = R.uniform(key, (3,))
        key = R.fold_in(key, 2)
        z = R.normal(key, ())
    """,
    "nested": """
        def outer(key):
            def inner():
                return R.normal(key, ())
            a = R.normal(key, ())
            return lambda: R.uniform(key, ()), inner, a
    """,
}


@pytest.mark.parametrize("name", sorted(_KEY_FIXTURES))
def test_key_reuse_flags_the_references_lines(tmp_path, name):
    """TL002 on ``repro_torch.prng`` flags the lines and columns JL002
    flags on the same code written against ``jax.random``."""
    code = textwrap.dedent(_KEY_FIXTURES[name])
    ref = ref_lint(tmp_path / "ref",
                   "import jax\n" + code.replace("R.", "jax.random."),
                   "src/repro/core/snippet.py", ["JL002"])
    # ``torch_prng.`` is as long as ``jax.random.``: the columns agree
    port = lint(tmp_path / "port",
                "from repro_torch import prng as torch_prng\n"
                + code.replace("R.", "torch_prng."),
                "src/repro_torch/core/snippet.py", select=["TL002"])
    assert [(f.line, f.col) for f in ref.active] == \
        [(f.line, f.col) for f in port.active]
    assert ref.active


def test_json_schema_matches_reference(tmp_path):
    ref = ref_lint(tmp_path / "ref", "import jax.numpy as jnp\n"
                   "X = jnp.asarray([1.0], jnp.float32)\n",
                   "src/repro/core/sampling/s.py", ["JL003"]).to_json()
    port = lint(tmp_path / "port", _VIOLATION, select=["TL003"]).to_json()
    assert set(ref) == set(port)
    assert set(ref["summary"]) == set(port["summary"])
    assert set(ref["findings"][0]) == set(port["findings"][0])
    assert set(ref["rules"][0]) == set(port["rules"][0])
    assert [to_port(r["id"]) for r in ref["rules"]] == \
        [r["id"] for r in port["rules"]]


# ------------------------------------------------------------- self-checks
def test_port_lints_clean():
    """The committed tree passes its own gate (active findings = 0,
    every baseline entry alive and justified), well inside 10 s."""
    t0 = time.perf_counter()
    report = run_lint(root=REPO_ROOT)
    assert time.perf_counter() - t0 < 10.0
    detail = "\n".join(f.render() for f in report.active) or report.errors
    assert report.ok, f"the port must lint clean:\n{detail}"
    assert report.files > 100
    for entry in json.loads(
            (REPO_ROOT / "lint_baseline_torch.json").read_text())["entries"]:
        assert entry["justification"].strip()
        assert "grandfathered" not in entry["justification"], \
            f"unjustified baseline entry: {entry}"


def test_port_imports_neither_jax_nor_repro():
    """By the gate's own import resolution, no module of the port and
    not ``chip_smoke.py`` imports ``jax`` or the reference package."""
    files = sorted(PORT.rglob("*.py")) + [REPO_ROOT / "chip_smoke.py"]
    bad = []
    for path in files:
        rel = path.relative_to(REPO_ROOT).as_posix()
        ctx = FileContext(path, rel, path.read_text())
        for module, line in ctx.imported_modules:
            if module.split(".")[0] in ("jax", "jaxlib", "repro"):
                bad.append(f"{rel}:{line}: {module}")
    assert len(files) > 100 and not bad, bad


def test_gate_imports_only_the_standard_library():
    """``repro_torch.analysis`` imports the standard library and its own
    modules, and importing it leaves torch, jax and the reference out of
    ``sys.modules``."""
    pkg = PORT / "analysis"
    for path in sorted(pkg.glob("*.py")):
        rel = path.relative_to(REPO_ROOT).as_posix()
        for module, _ in FileContext(path, rel,
                                     path.read_text()).imported_modules:
            top = module.split(".")[0]
            assert top in sys.stdlib_module_names or \
                module.startswith("repro_torch.analysis") or \
                module == "__future__", (rel, module)
    code = ("import sys; import repro_torch.analysis; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'torch', 'jax', 'repro', 'numpy'}))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env={"PYTHONPATH": str(REPO_ROOT / "src")})
    assert out.stdout.strip() == "[]"


def test_cli_on_the_tree_exits_0():
    """``python -m repro_torch.analysis`` on the repo: exit 0."""
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis"],
                         capture_output=True, text=True, cwd=REPO_ROOT,
                         env={"PYTHONPATH": str(REPO_ROOT / "src")})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s)" in out.stdout
