"""Render the port's man pages from their markdown sources.

The twin of the repository's ``scripts/gen_man.py``, restricted to the
port's pages: it converts ``docs/*-torch.N.md`` (``plssvm-train-torch.1.md``,
``plssvm-predict-torch.1.md``) into roff ``docs/*-torch.N`` and touches no
other page.  It handles the markdown subset the sources use: ``#`` / ``##``
headers, ``-`` bullets (a bullet "```flag`` — text" becomes a tagged
paragraph), indented code blocks, inline ``code`` and backslash escapes.
The page carries the port's version and no date, so a regeneration of an
unchanged source changes no byte::

    python -m plssvm_sparse_fp22_tpu_torch.scripts.gen_man [--out DIR]

Check a page with ``man ./docs/plssvm-train-torch.1``.
"""

from __future__ import annotations

import argparse
import os
import re

from ..version import VERSION

DOCS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    "docs")
SOURCE = re.compile(r"(.+-torch)\.(\d)\.md$")


def _escape(text: str) -> str:
    """Escape roff specials and translate the markdown inline subset."""
    text = text.replace("\\", "\\\\")
    text = re.sub(r"\\\\([*_`|])", r"\1", text)  # markdown escapes: \* -> *
    text = text.replace("-", "\\-")
    text = re.sub(r"`([^`]*)`", r"\\fB\1\\fR", text)  # inline code -> bold
    if text.startswith((".", "'")):
        text = "\\&" + text
    return text


def md_to_roff(md: str, name: str, section: int) -> str:
    out = [f'.TH "{name.upper()}" "{section}" "" "plssvm-sparse-fp22-tpu-torch {VERSION}" '
           '"User Commands"']
    lines = md.splitlines()
    i, in_code = 0, False
    while i < len(lines):
        line = lines[i]
        if line.startswith("    ") and not line.lstrip().startswith("- "):
            if not in_code:
                out += [".nf", ".RS 4"]
                in_code = True
            out.append(_escape(line[4:]) if line.strip() else "")
            i += 1
            continue
        if in_code:
            if not line.strip() and next((ln for ln in lines[i + 1:] if ln.strip()),
                                         "").startswith("    "):
                out.append("")  # a blank line inside a code block
                i += 1
                continue
            out += [".RE", ".fi"]
            in_code = False
        if line.startswith("## "):
            out.append(f'.SH "{_escape(line[3:].strip())}"')
        elif line.startswith("# "):
            pass  # the title is the .TH line
        elif line.startswith("- "):
            item = [line[2:]]
            i += 1
            while (i < len(lines) and lines[i].startswith("  ")
                   and not lines[i].startswith("    ") and lines[i].strip()):
                item.append(lines[i].strip())
                i += 1
            text = " ".join(item)
            m = re.match(r"(`[^`]*`(?:\s*/\s*`[^`]*`)*)\s+—\s+(.*)", text)
            out.append(".TP")
            out += [_escape(m.group(1)), _escape(m.group(2))] if m else ["\\(bu", _escape(text)]
            continue
        elif not line.strip():
            out.append(".PP")
        else:
            out.append(_escape(line))
        i += 1
    if in_code:
        out += [".RE", ".fi"]
    pages = []
    for ln in out:
        if not (ln == ".PP" and pages and pages[-1] == ".PP"):
            pages.append(ln)
    return "\n".join(pages) + "\n"


def main(argv=None) -> list[str]:
    """Render every ``docs/*-torch.N.md``; returns the pages written."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=DOCS, help="output directory (default docs/)")
    args = parser.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    written = []
    for fname in sorted(os.listdir(DOCS)):
        m = SOURCE.match(fname)
        if not m:
            continue
        name, section = m.group(1), int(m.group(2))
        with open(os.path.join(DOCS, fname)) as fh:
            roff = md_to_roff(fh.read(), name, section)
        path = os.path.join(args.out, f"{name}.{section}")
        with open(path, "w") as fh:
            fh.write(roff)
        written.append(path)
    print("wrote:", *written, sep="\n  ")
    return written


if __name__ == "__main__":
    main()
