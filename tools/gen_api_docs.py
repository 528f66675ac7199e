"""Generate docs/API.md from the live package surface.

Walks every public module's ``__all__``, records signatures and first
docstring lines, and writes one markdown reference.  Run:

    PYTHONPATH=/root/repo JAX_PLATFORMS=cpu python tools/gen_api_docs.py

``tests/test_cli.py``-style CI coverage lives in
``tests/test_api_docs.py``: the committed file must match a fresh
generation (regenerate after any public-surface change).
"""
from __future__ import annotations

import importlib
import inspect
import os
import sys

MODULES = [
    ("sitator_tpu", "Core data model"),
    ("sitator_tpu.io", "Trajectory IO and synthetic generators"),
    ("sitator_tpu.voronoi", "Site seeding"),
    ("sitator_tpu.landmark", "Landmark engines"),
    ("sitator_tpu.landmark.cluster", "Clustering backends"),
    ("sitator_tpu.dynamics", "Dynamics / kinetics post-processing"),
    ("sitator_tpu.network", "Network analysis and merging"),
    ("sitator_tpu.site_descriptors", "Descriptors and typing"),
    ("sitator_tpu.misc", "Misc transforms"),
    ("sitator_tpu.visualization", "Plotting"),
    ("sitator_tpu.util", "Utility substrate"),
    ("sitator_tpu.parallel", "Multi-device parallelism"),
    ("sitator_tpu.ops", "On-device ops (advanced)"),
    ("sitator_tpu.compat", "Reference-namespace shim"),
]

OPS_MODULES = [
    "sitator_tpu.ops.pbc", "sitator_tpu.ops.landmark",
    "sitator_tpu.ops.landmark_gather", "sitator_tpu.ops.landmark_mxu",
    "sitator_tpu.ops.jumps", "sitator_tpu.ops.cluster",
    "sitator_tpu.ops.mcl", "sitator_tpu.ops.msd",
    "sitator_tpu.ops.correlation",
]


def _first_line(obj):
    doc = inspect.getdoc(obj)
    if not doc:
        return ""
    line = doc.strip().splitlines()[0].rstrip()
    return line


def _signature(obj):
    try:
        sig = str(inspect.signature(obj))
    except (TypeError, ValueError):
        return ""
    return sig if len(sig) <= 88 else sig[:85] + "...)"


def _entries(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for name in names:
        obj = getattr(mod, name, None)
        if obj is None or inspect.ismodule(obj):
            continue
        kind = ("class" if inspect.isclass(obj)
                else "func" if callable(obj) else "data")
        out.append((name, kind, _signature(obj) if kind != "data" else "",
                    _first_line(obj) if kind != "data" else ""))
    return out


def generate():
    lines = ["# sitator_tpu API reference",
             "",
             "Generated by `tools/gen_api_docs.py` from the live package "
             "surface — regenerate after any public-surface change "
             "(`tests/test_api_docs.py` enforces freshness).",
             ""]
    for mod_name, title in MODULES:
        mod = importlib.import_module(mod_name)
        lines.append(f"## `{mod_name}` — {title}")
        head = _first_line(mod)
        if head:
            lines.append(f"\n{head}\n")
        else:
            lines.append("")
        for name, kind, sig, doc in _entries(mod):
            tag = "class " if kind == "class" else ""
            lines.append(f"- **`{tag}{name}{sig}`**"
                         + (f" — {doc}" if doc else ""))
        lines.append("")
        if mod_name == "sitator_tpu.ops":
            for sub in OPS_MODULES:
                m = importlib.import_module(sub)
                lines.append(f"### `{sub}`")
                h = _first_line(m)
                lines.append(f"\n{h}\n" if h else "")
                for name, kind, sig, doc in _entries(m):
                    tag = "class " if kind == "class" else ""
                    lines.append(f"- **`{tag}{name}{sig}`**"
                                 + (f" — {doc}" if doc else ""))
                lines.append("")
    return "\n".join(lines) + "\n"


def main(out_path=None):
    out_path = out_path or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "docs", "API.md")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    text = generate()
    with open(out_path, "w") as f:
        f.write(text)
    print(f"wrote {out_path} ({text.count(chr(10))} lines)")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
