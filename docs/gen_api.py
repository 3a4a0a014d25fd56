"""Generated API reference (dependency-free).

The reference builds Doxygen docs behind BUILD_DOCUMENTATION
(reference CMakeLists.txt:24-47); this is the equivalent for the ~60-symbol
public surface: introspects the package and writes one markdown page per
module plus an index to docs/api/.

    python docs/gen_api.py [outdir]

Run from the repo root (or anywhere — the repo root is put on sys.path).
No sphinx/pdoc in the image; plain inspect keeps it hermetic.
"""

from __future__ import annotations

import inspect
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

MODULES = [
    "svgdcpp_jax",
    "svgdcpp_jax.svgd",
    "svgdcpp_jax.models.model",
    "svgdcpp_jax.models.multivariate_normal",
    "svgdcpp_jax.models.bayesian_logistic_regression",
    "svgdcpp_jax.models.binomial_likelihood",
    "svgdcpp_jax.kernels.kernel",
    "svgdcpp_jax.kernels.gaussian_rbf",
    "svgdcpp_jax.kernels.algebra",
    "svgdcpp_jax.optimizers.base",
    "svgdcpp_jax.optimizers.adam",
    "svgdcpp_jax.optimizers.adagrad",
    "svgdcpp_jax.optimizers.rmsprop",
    "svgdcpp_jax.optimizers.optax_adapter",
    "svgdcpp_jax.ops.phi",
    "svgdcpp_jax.ops.pairwise",
    "svgdcpp_jax.ops.median",
    "svgdcpp_jax.ops.ksd",
    "svgdcpp_jax.ops.pallas_phi",
    "svgdcpp_jax.parallel.mesh",
    "svgdcpp_jax.parallel.sharded",
    "svgdcpp_jax.parallel.ring",
    "svgdcpp_jax.core.types",
    "svgdcpp_jax.core.exceptions",
    "svgdcpp_jax.utils.checkpoint",
    "svgdcpp_jax.utils.compile_cache",
    "svgdcpp_jax.utils.logging",
    "svgdcpp_jax.utils.profiling",
    "svgdcpp_jax.utils.native",
    "svgdcpp_jax.utils.workloads",
]


def _is_public(name: str) -> bool:
    return not name.startswith("_")


def _doc(obj) -> str:
    d = inspect.getdoc(obj)
    return d.strip() if d else "*(undocumented)*"


def _signature(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _members_defined_here(mod):
    """Public classes/functions whose home module is ``mod`` (re-exports are
    documented at their definition site; the package page lists them)."""
    out = []
    for name, obj in vars(mod).items():
        if not _is_public(name):
            continue
        if inspect.isclass(obj) or inspect.isfunction(obj):
            if getattr(obj, "__module__", None) == mod.__name__:
                out.append((name, obj))
    return sorted(out)


def render_class(name, cls) -> str:
    lines = [f"### class `{name}{_signature(cls)}`", "", _doc(cls), ""]
    methods = []
    for mname, mobj in sorted(vars(cls).items()):
        if not _is_public(mname):
            continue
        if callable(mobj) or isinstance(mobj, (staticmethod, classmethod, property)):
            if isinstance(mobj, property):
                methods.append((mname, mobj.fget, "property"))
            elif isinstance(mobj, (staticmethod, classmethod)):
                methods.append((mname, mobj.__func__, "static/class method"))
            elif inspect.isfunction(mobj):
                methods.append((mname, mobj, "method"))
    # CamelCase aliases (parity API): bound to the same function object as a
    # snake_case method — collapse them into a one-line note.
    seen_fns = {}
    aliases = []
    # snake_case first so it becomes the canonical name and the CamelCase
    # spelling collapses into the alias note.
    methods.sort(key=lambda t: (t[0][:1].isupper(), t[0]))
    for mname, fn, kind in methods:
        if fn in seen_fns:
            aliases.append((mname, seen_fns[fn]))
        else:
            seen_fns[fn] = mname
    alias_names = {a for a, _ in aliases}
    for mname, fn, kind in methods:
        if mname in alias_names:
            continue
        sig = _signature(fn) if kind != "property" else ""
        doc = _doc(fn)
        first = doc.splitlines()[0] if doc else ""
        lines.append(f"- **`{mname}{sig}`** — {first}")
    if aliases:
        pairs = ", ".join(f"`{a}` → `{t}`" for a, t in aliases)
        lines.append(f"- *CamelCase parity aliases:* {pairs}")
    lines.append("")
    return "\n".join(lines)


def render_function(name, fn) -> str:
    return f"### `{name}{_signature(fn)}`\n\n{_doc(fn)}\n"


def render_module(modname: str) -> str:
    import importlib

    mod = importlib.import_module(modname)
    lines = [f"# `{modname}`", "", _doc(mod), ""]
    members = _members_defined_here(mod)
    classes = [(n, o) for n, o in members if inspect.isclass(o)]
    funcs = [(n, o) for n, o in members if inspect.isfunction(o)]
    for n, o in classes:
        lines.append(render_class(n, o))
    for n, o in funcs:
        lines.append(render_function(n, o))
    return "\n".join(lines)


def main(outdir=None) -> Path:
    out = Path(outdir) if outdir else ROOT / "docs" / "api"
    out.mkdir(parents=True, exist_ok=True)
    index = [
        "# svgdcpp_jax API reference",
        "",
        "Generated by `python docs/gen_api.py` (no external doc toolchain in",
        "the image — the analog of the reference's Doxygen build,",
        "reference CMakeLists.txt:24-47).",
        "",
    ]
    import importlib

    pkg = importlib.import_module("svgdcpp_jax")
    exports = sorted(n for n in getattr(pkg, "__all__", dir(pkg)) if _is_public(n))
    index.append("## Top-level exports (`import svgdcpp_jax as sv`)")
    index.append("")
    index.append(", ".join(f"`{n}`" for n in exports))
    index.append("")
    index.append("## Modules")
    index.append("")
    for modname in MODULES:
        page = modname.replace(".", "_") + ".md"
        (out / page).write_text(render_module(modname))
        index.append(f"- [`{modname}`]({page})")
    index.append("")
    (out / "index.md").write_text("\n".join(index))
    print(f"wrote {len(MODULES) + 1} pages to {out}")
    return out


if __name__ == "__main__":
    main(*sys.argv[1:])
