"""Generate the port's markdown API reference.

The twin of the repository's ``scripts/gen_apidoc.py``, which documents the
JAX package: introspect the port's public modules with ``inspect`` and write
``docs/api_torch/`` — one page per module (signatures and docstrings) and an
``index.md``.  The output is deterministic: object addresses and this
checkout's location are taken out of signatures and values, and sets are
listed sorted, so a regeneration on an unchanged tree changes no byte::

    python -m plssvm_sparse_fp22_tpu_torch.scripts.gen_apidoc [--out DIR]

Runs on the CPU; it imports the port (torch) and builds no kernel.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "docs", "api_torch")
PKG = "plssvm_sparse_fp22_tpu_torch"

#: the documented public surface: the JAX reference's list
#: (``scripts/gen_apidoc.py:22-44``) with ``ops.gram_matvec`` in the place of
#: ``ops.pallas_matvec``, plus the modules the port carries beyond it
MODULES = [
    PKG,
    f"{PKG}.params",
    f"{PKG}.types",
    f"{PKG}.exceptions",
    f"{PKG}.models.base",
    f"{PKG}.models.factory",
    f"{PKG}.models.sparse_learn",
    f"{PKG}.solver.cg",
    f"{PKG}.solver.checkpoint",
    f"{PKG}.ops.matvec",
    f"{PKG}.ops.kernel_functions",
    f"{PKG}.ops.gram_matvec",
    f"{PKG}.ops.sparse",
    f"{PKG}.ops.sparse_gram",
    f"{PKG}.parallel.mesh",
    f"{PKG}.parallel.sharded",
    f"{PKG}.parallel.distributed",
    f"{PKG}.io.libsvm",
    f"{PKG}.io.arff",
    f"{PKG}.io.model",
    f"{PKG}.cli.train",
    f"{PKG}.cli.predict",
    f"{PKG}.cli.detect",
    f"{PKG}.cli.generate_data",
    f"{PKG}.utils.oracle",
    f"{PKG}.utils.timing",
]

_ADDRESS = re.compile(r" at 0x[0-9a-fA-F]+")


def _clean(text: str) -> str:
    """Drop object addresses and this checkout's path from a rendering."""
    return _ADDRESS.sub("", text).replace(ROOT + os.sep, "").replace(ROOT, ".")


def _sig(obj) -> str:
    try:
        return _clean(str(inspect.signature(obj)))
    except (TypeError, ValueError):
        return "(...)"


def _doc(obj) -> str:
    return inspect.getdoc(obj) or ""


def _value(obj) -> str:
    if isinstance(obj, (set, frozenset)):
        rep = "{" + ", ".join(sorted(map(repr, obj))) + "}"
    else:
        rep = repr(obj)
    rep = _clean(rep)
    return rep if len(rep) <= 120 else rep[:117] + "..."


def _public_members(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None or inspect.ismodule(obj):
            continue
        if getattr(obj, "__module__", mod.__name__) != mod.__name__ and mod.__name__ != PKG:
            continue  # re-exports are documented at their home module
        out.append((n, obj))
    return out


def render_module(mod) -> str:
    lines = [f"# `{mod.__name__}`", ""]
    if mod.__doc__:
        lines += [inspect.cleandoc(mod.__doc__), ""]
    for name, obj in _public_members(mod):
        if inspect.isclass(obj):
            lines += [f"## class `{name}{_sig(obj)}`", ""]
            if _doc(obj):
                lines += [_doc(obj), ""]
            for mname, meth in inspect.getmembers(obj):
                if mname.startswith("_") or not (inspect.isfunction(meth)
                                                 or inspect.ismethod(meth)):
                    continue
                lines += [f"### `{name}.{mname}{_sig(meth)}`", ""]
                if _doc(meth):
                    lines += [_doc(meth), ""]
        elif inspect.isfunction(inspect.unwrap(obj)):  # functions, cached ones too
            lines += [f"## `{name}{_sig(obj)}`", ""]
            if _doc(obj):
                lines += [_doc(obj), ""]
        else:
            lines += [f"## `{name}` = `{_value(obj)}`", ""]
    return "\n".join(lines) + "\n"


def main(argv=None) -> list[str]:
    """Write the pages; returns their paths, the index last."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=OUT, help="output directory (default docs/api_torch)")
    args = parser.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    index = ["# API reference of the PyTorch port", "",
             "Generated by `python -m plssvm_sparse_fp22_tpu_torch.scripts.gen_apidoc`; "
             "the JAX package's reference is `docs/api/`.", ""]
    written = []
    for name in MODULES:
        mod = importlib.import_module(name)
        page = name.replace(".", "_") + ".md"
        path = os.path.join(args.out, page)
        with open(path, "w") as fh:
            fh.write(render_module(mod))
        written.append(path)
        first = inspect.cleandoc(mod.__doc__).splitlines()[0] if mod.__doc__ else ""
        index.append(f"- [`{name}`]({page}) — {first}")
    path = os.path.join(args.out, "index.md")
    with open(path, "w") as fh:
        fh.write("\n".join(index) + "\n")
    written.append(path)
    print(f"wrote {len(written)} pages under {args.out}")
    return written


if __name__ == "__main__":
    main()
