"""The port's documentation: the API reference and the two man pages.

``plssvm_sparse_fp22_tpu_torch.scripts.gen_apidoc`` writes one page per
listed module and an index; ``...scripts.gen_man`` renders
``docs/*-torch.1.md`` into roff and no other page.  Each man page names
every option of its CLI's parser, the environment variables the port reads
and the float64 route; the committed ``.1`` files are what the generator
renders from the committed sources.
"""

import os

import pytest

torch = pytest.importorskip("torch")

from plssvm_sparse_fp22_tpu_torch.cli import predict as predict_cli
from plssvm_sparse_fp22_tpu_torch.cli import train as train_cli
from plssvm_sparse_fp22_tpu_torch.scripts import gen_apidoc, gen_man

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(ROOT, "docs")
ENVIRONMENT = ("PLSSVM_MATMUL_PRECISION", "PLSSVM_K_CACHE_BYTES", "PLSSVM_SPARSE_MODE",
               "PLSSVM_CG_STAG_PATIENCE", "PLSSVM_IMPLICIT_FEATURE_CUTOFF",
               "PLSSVM_PALLAS_SYMMETRIC")
PAGES = {"plssvm-train-torch": train_cli, "plssvm-predict-torch": predict_cli}


def test_apidoc_writes_a_page_and_an_index_line_per_module(tmp_path):
    written = gen_apidoc.main(["--out", str(tmp_path)])
    index = (tmp_path / "index.md").read_text()
    assert written[-1] == str(tmp_path / "index.md")
    assert len(written) == len(gen_apidoc.MODULES) + 1
    for name in gen_apidoc.MODULES:
        page = name.replace(".", "_") + ".md"
        text = (tmp_path / page).read_text()
        assert text.startswith(f"# `{name}`\n")
        assert f"- [`{name}`]({page})" in index
    assert "plssvm_sparse_fp22_tpu_torch.ops.gram_matvec" in gen_apidoc.MODULES
    assert not [n for n in gen_apidoc.MODULES if "pallas" in n]
    # deterministic: no object addresses, no checkout path, equal on a rerun
    pages = {p: open(p).read() for p in written}
    assert not [p for p, text in pages.items() if " at 0x" in text or ROOT in text]
    gen_apidoc.main(["--out", str(tmp_path)])
    assert pages == {p: open(p).read() for p in written}


@pytest.mark.parametrize("name", sorted(PAGES))
def test_man_page_lists_every_option_and_the_environment(name):
    with open(os.path.join(DOCS, f"{name}.1.md")) as fh:
        md = fh.read()
    options = [s for a in PAGES[name].build_parser()._actions for s in a.option_strings]
    assert options and not [s for s in options if f"`{s}" not in md and f" {s}" not in md]
    assert not [v for v in ENVIRONMENT if f"`{v}`" not in md]
    assert "## FLOAT64" in md and "nothing is refused" in md


def test_man_pages_render_from_their_sources_and_only_the_ports(tmp_path):
    jax_pages = {n: open(os.path.join(DOCS, n), "rb").read()
                 for n in ("plssvm-train.1", "plssvm-predict.1")}
    written = gen_man.main(["--out", str(tmp_path)])
    assert sorted(os.path.basename(p) for p in written) == sorted(f"{n}.1" for n in PAGES)
    for path in written:
        roff = open(path).read()
        assert roff.startswith(f'.TH "{os.path.basename(path)[:-2].upper()}" "1" ')
        assert '.SH "NAME"' in roff and '.SH "OPTIONS"' in roff
        with open(os.path.join(DOCS, os.path.basename(path))) as fh:
            assert fh.read() == roff, f"{path} is stale: rerun gen_man"
        options = [s for a in PAGES[os.path.basename(path)[:-2]].build_parser()._actions
                   for s in a.option_strings]
        plain = roff.replace("\\-", "-")
        assert not [s for s in options if s not in plain]
    assert jax_pages == {n: open(os.path.join(DOCS, n), "rb").read() for n in jax_pages}
