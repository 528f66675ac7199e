"""Line coverage for ``sitator_tpu`` without external tooling.

The environment has no coverage.py, so this uses Python 3.12's
``sys.monitoring`` with per-line DISABLE (each line reports once, so the
overhead after warm-up is near zero) to record which package lines the
test suite executes, then diffs against the set of *executable* lines
(every code object's ``co_lines()``, collected by compiling each source
file).

Usage (CPU, from the repo root):

    JAX_PLATFORMS=cpu PYTHONPATH=/root/repo /opt/venv/bin/python \
        tools/line_coverage.py [pytest args...] \
        [--cov-out /tmp/coverage.json]

Prints a per-file table of uncovered executable lines and writes the raw
hit/executable sets to the JSON for drill-down.  Traced scope is the
installed ``sitator_tpu`` package only (tests/tools are not traced).

Caveats: lines only executed under ``jax.jit`` tracing still count as
hit (tracing runs the Python line); lines inside Pallas kernels count
when interpret-mode tests trace them.  GPU-only branches (the compiled
Triton route) therefore do not show up — this measures Python-level reachability.
SUBPROCESSES ARE NOT TRACED: code exercised only through subprocess
integration tests (``__main__.py``, the example walkthroughs, the CLI
entry when spawned) reads as uncovered here even though it runs in CI —
check for a subprocess test before calling a gap real.
"""
import argparse
import json
import pathlib
import sys

# A deliberately free tool id (NOT sys.monitoring.COVERAGE_ID == 1): this
# collector must coexist with any real coverage tool that claims slot 1.
TOOL_ID = 4


def executable_lines(path: pathlib.Path):
    """All line numbers with generated bytecode, via recursive co_lines."""
    code = compile(path.read_text(), str(path), "exec")
    lines = set()
    stack = [code]
    while stack:
        co = stack.pop()
        for _, _, ln in co.co_lines():
            # ln 0 = interpreter prologue bytecode (RESUME etc.) that never
            # fires a LINE event — counting it costs every file one phantom
            # "missing" line
            if ln:
                lines.add(ln)
        for const in co.co_consts:
            if isinstance(const, type(code)):
                stack.append(const)
    return lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cov-out", default="/tmp/sitator_coverage.json")
    ap.add_argument("pytest_args", nargs="*", default=[])
    args = ap.parse_args()

    # locate the package WITHOUT importing it — module-level lines must
    # execute after monitoring is enabled or every __init__ reads 0%
    import importlib.util
    spec = importlib.util.find_spec("sitator_tpu")
    pkg_dir = str(pathlib.Path(spec.origin).parent)
    pkg_prefix = pkg_dir.rstrip("/") + "/"  # siblings sharing the prefix don't match
    assert "sitator_tpu" not in sys.modules, \
        "sitator_tpu imported before monitoring started"
    hits = {}  # filename -> set of lines

    mon = sys.monitoring
    mon.use_tool_id(TOOL_ID, "line_coverage")

    def on_line(code, line):
        fn = code.co_filename
        if not fn.startswith(pkg_prefix):
            return mon.DISABLE
        hits.setdefault(fn, set()).add(line)
        return mon.DISABLE  # one report per line is enough

    mon.register_callback(TOOL_ID, mon.events.LINE, on_line)
    mon.set_events(TOOL_ID, mon.events.LINE)

    import pytest
    rc = pytest.main(args.pytest_args or ["tests/", "-q", "-p",
                                          "no:cacheprovider"])

    mon.set_events(TOOL_ID, 0)
    mon.free_tool_id(TOOL_ID)

    report = {}
    rows = []
    for path in sorted(pathlib.Path(pkg_dir).rglob("*.py")):
        fn = str(path)
        execl = executable_lines(path)
        hit = hits.get(fn, set()) & execl
        missing = sorted(execl - hit)
        rel = str(path.relative_to(pathlib.Path(pkg_dir).parent))
        report[rel] = {"executable": len(execl), "hit": len(hit),
                       "missing": missing}
        if execl:
            rows.append((len(missing), rel, len(hit), len(execl)))

    tot_hit = sum(r["hit"] for r in report.values())
    tot_exec = sum(r["executable"] for r in report.values())
    rows.sort(reverse=True)
    print(f"\n=== line coverage: {tot_hit}/{tot_exec} "
          f"({100.0 * tot_hit / max(tot_exec, 1):.1f}%) ===")
    print(f"{'missing':>8}  {'cov%':>6}  file")
    for n_miss, rel, n_hit, n_exec in rows:
        if n_miss == 0:
            continue
        print(f"{n_miss:>8}  {100.0 * n_hit / n_exec:>5.1f}%  {rel}")
    with open(args.cov_out, "w") as fh:
        json.dump(report, fh)
    print(f"# wrote {args.cov_out}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
