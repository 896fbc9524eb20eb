"""The model file's support-vector section through the port's native parser.

``io/sv_parser.cpp`` (``io/native.parse_sv_native``) must give what
``io/libsvm.parse_libsvm_content`` gives on the same lines, bit for bit:
the CSR's ``indptr``, ``indices`` (values and dtype) and ``data`` bytes and
the alphas' bytes.  It is held so on every model fixture under
``tests/data/``, on dense and sparse models of seeded numpy data written by
both packages' writers, and, through ``parse_model_file``, on malformed and
unusual support-vector lines, where the native parse hands the section to
the Python parser: the same result or the same ``InvalidFileFormatError``
text as the Python-only parse and as the JAX package's ``parse_model_file``.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from plssvm_sparse_fp22_tpu.exceptions import InvalidFileFormatError as JFormatError
from plssvm_sparse_fp22_tpu.io.model import parse_model_file as j_parse_model
from plssvm_sparse_fp22_tpu.io.model import write_model_file as j_write_model
from plssvm_sparse_fp22_tpu.types import KernelType as JKernel
from plssvm_sparse_fp22_tpu_torch.exceptions import InvalidFileFormatError
from plssvm_sparse_fp22_tpu_torch.io import model as tm
from plssvm_sparse_fp22_tpu_torch.io import native as tn
from plssvm_sparse_fp22_tpu_torch.io.file_reader import read_bytes
from plssvm_sparse_fp22_tpu_torch.io.libsvm import parse_libsvm_content
from plssvm_sparse_fp22_tpu_torch.types import KernelType

DATA = os.path.join(os.path.dirname(__file__), "data")
FIXTURES = [f"120x16.{k}.model" for k in ("linear", "polynomial", "rbf")]

HEADER = ("svm_type c_svc\nkernel_type rbf\ngamma 0.5\nnr_class 2\ntotal_sv {n}\nrho 0.25\n"
          "label 1 -1\nnr_sv {pos} {neg}\nSV\n")


@pytest.fixture(scope="module")
def sv_lib():
    if tn.get_sv_lib() is None:
        pytest.skip("no C++ compiler builds io/sv_parser.cpp here")
    return tn.get_sv_lib()


def _section(path):
    """``(content, offset, count, lines)``: the file's bytes, the offset of
    its support-vector section, total_sv, and the section's lines as the
    Python parse reads them."""
    content = read_bytes(path)
    kept = list(tm._kept_lines(content))
    at = next(i for i, (line, _) in enumerate(kept) if line.strip().lower() == "sv")
    count = next(int(line.split()[1]) for line, _ in kept if line.startswith("total_sv"))
    return content, kept[at][1], count, [line for line, _ in kept[at + 1: at + 1 + count]]


def _assert_same_csr(got, want):
    assert got.shape == want.shape
    for name in ("indptr", "indices"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.data.dtype == want.data.dtype and got.data.tobytes() == want.data.tobytes()


def _assert_bitwise(path, dtype=np.float64):
    content, offset, count, lines = _section(path)
    got = tn.parse_sv_native(content, offset, count, dtype)
    assert got is not None, "the native parser handed a well-formed section back"
    csr, alphas, _ = parse_libsvm_content(lines, dtype=dtype)
    _assert_same_csr(got[0], csr)
    assert got[1].dtype == alphas.dtype and got[1].tobytes() == alphas.tobytes()


@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fixtures_parse_bitwise(sv_lib, name, dtype):
    _assert_bitwise(os.path.join(DATA, name), dtype)


def _seeded(kind, n=300, f=37, seed=11):
    rng = np.random.default_rng(seed)
    X = rng.normal(scale=rng.choice([1e-3, 1.0, 1e4], size=(n, 1)), size=(n, f))
    if kind == "sparse":
        X = X * (rng.random(X.shape) < 0.1)
    labels = np.where(rng.random(n) < 0.4, 1.0, -1.0)
    return X, labels, rng.normal(size=n) * 10.0 ** rng.integers(-8, 3, size=n)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_seeded_models_of_both_writers_parse_bitwise(sv_lib, kind, writer, tmp_path):
    X, labels, alphas = _seeded(kind)
    path = tmp_path / f"{kind}.model"
    if writer == "torch":
        data = sp.csr_matrix(X) if kind == "sparse" else X
        tm.write_model_file(path, kernel=KernelType.rbf, rho=0.125, data=data, labels=labels,
                            alphas=alphas, gamma=0.5)
    else:
        data = sp.csr_matrix(X) if kind == "sparse" else X
        j_write_model(path, kernel=JKernel.rbf, rho=0.125, data=data, labels=labels,
                      alphas=alphas, gamma=0.5)
    _assert_bitwise(path)
    got, want = tm.parse_model_file(path), j_parse_model(path)
    _assert_same_csr(got.support_vectors.csr, want.support_vectors.csr)
    assert got.alphas.tobytes() == want.alphas.tobytes()
    np.testing.assert_array_equal(got.labels, want.labels)


def _python_only(path, monkeypatch):
    with monkeypatch.context() as m:
        m.setenv("PLSSVM_NO_NATIVE_PARSER", "1")
        return tm.parse_model_file(path)


# support-vector sections: the existing I/O tests' malformed lines
# (``tests/test_io.py``) and lines the strict grammar leaves to Python
SECTIONS = {
    "bad value": (1, "1 0:abc\n"),
    "bad index": (1, "1 x:1.0\n"),
    "negative index": (1, "1 -1:1.0\n"),
    "duplicate index, last wins": (2, "1 0:1.0 0:5.0 2:2.0\n-1 1:1.0\n"),
    "too few lines": (3, "1 0:1.0\n"),
    "no line": (2, ""),
    "no pair at all": (2, "0.5\n-0.5\n"),
    "second colon": (1, "1 0:1.0:2\n"),
    "empty index": (1, "1 :1.0\n"),
    "plus signs and underscores": (2, "+1 +0:1_0 1:+2.5\n-1 0_1:1.0\n"),
    "inf and nan": (2, "inf 0:nan\n-1 0:-Infinity\n"),
    "overflow and subnormal": (2, "1 0:1e400\n-1 0:1e-310 1:4.9e-324\n"),
    "inline comment": (2, "1 0:1.0 # note 3:4\n-1 1:2.0 end 2:9\n"),
    "blank and comment lines": (2, "\n# c\n   \n1 0:1.0\n  # d\n-1 1:2.0\n"),
    "crlf and tabs": (2, "1\t0:1.0\r\n-1  1:2.0 \r\n"),
    "unlabeled line": (2, "0:1.0 1:2.0\n-1 1:2.0\n"),
    "non-ascii space": (2, "1 0:1.0\u00a01:2.0\n-1\u20031:2.0\n"),
    "non-ascii comment": (2, "1 0:1.0\n # kömment\n-1 1:2.0\n"),
    "leading dot and trailing dot": (2, "1 0:.5 1:5.\n-1 0:-.5e+1\n"),
    "lines beyond total_sv": (1, "1 0:1.0\n-1 zz:1\n"),
    "non-ascii after the data": (2, "1 0:1.0 note x\u00a0:5\n-1 1:2.0 n\u00f6te\n"),
    "non-ascii inside the token that ends the data": (1, "1 0:1.0 note\u00a0x:5\n"),
    "non-ascii leading space": (1, "\u00a01 0:1.0\n"),
    "signs and exponents": (2, "-0 0:+-1\n1 0:5.e3 1:1e+5 2:-0 3:1E-2\n"),
    "signs and exponents that parse": (1, "-0 0:5.e3 1:1e+5 2:-0 3:1E-2 4:+.5\n"),
}


@pytest.mark.parametrize("case", list(SECTIONS))
def test_sections_parse_as_the_python_parser_and_jax(sv_lib, case, tmp_path, monkeypatch):
    count, body = SECTIONS[case]
    path = tmp_path / "m.model"
    path.write_text(HEADER.format(n=count, pos=count, neg=0) + body, encoding="utf-8")
    outcomes = []
    for parse, err in ((tm.parse_model_file, InvalidFileFormatError),
                       (lambda p: _python_only(p, monkeypatch), InvalidFileFormatError),
                       (j_parse_model, JFormatError)):
        try:
            m = parse(path)
        except err as e:
            outcomes.append(("error", str(e)))
        else:
            csr = m.support_vectors.csr
            outcomes.append(("model", csr.shape, csr.indptr.tolist(), csr.indices.tolist(),
                             csr.data.tobytes(), m.alphas.tobytes()))
    assert outcomes[0] == outcomes[1] == outcomes[2]


def test_native_parse_hands_back_what_it_does_not_cover(sv_lib):
    head = HEADER.format(n=1, pos=1, neg=0).encode()
    for body in (b"1 0:1_0\n", b"1 0:inf\n", b"1 +0:1\n", b"1 0:1\xc2\xa01:2\n", b"1 0:1e400\n",
                 b"0.5\n", b""):
        assert tn.parse_sv_native(head + body, len(head), 1) is None
    got = tn.parse_sv_native(head + b"+1 0:1 3:-2.5e-3\n", len(head), 1)
    assert got[0].toarray().tolist() == [[1.0, 0.0, 0.0, -2.5e-3]]
    assert got[1].tolist() == [1.0]


def test_python_parse_runs_without_the_native_parser(tmp_path, monkeypatch):
    path = tmp_path / "m.model"
    path.write_text(HEADER.format(n=2, pos=1, neg=1) + "1 0:1.0\n-1 1:2.0\n")
    monkeypatch.setattr(tn, "get_sv_lib", lambda: None)
    m = tm.parse_model_file(path)
    assert m.support_vectors.csr.toarray().tolist() == [[1.0, 0.0], [0.0, 2.0]]
    assert m.alphas.tolist() == [1.0, -1.0]


SV_PROBE = """
import ctypes, sys
sys.path.insert(0, sys.argv[1])
from plssvm_sparse_fp22_tpu_torch.io import native
path = native.build_sv_parser(sys.argv[2])
assert ctypes.CDLL(path).plssvm_torch_parse_sv
print(path)
"""


def test_sv_parser_builds_once_for_processes_that_start_together(sv_lib, tmp_path):
    """Four processes on a fresh build directory, as
    ``test_torch_scripts.py`` holds the data parser's build: each loads the
    one library, and the directory holds it, its stamp and the lock."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    build = tmp_path / "native"
    procs = [subprocess.Popen([sys.executable, "-c", SV_PROBE, root, str(build)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [proc.communicate(timeout=240) for proc in procs]
    for proc, (out, err) in zip(procs, outs):
        assert proc.returncode == 0, err
    assert {out.strip() for out, _ in outs} == {str(build / "libplssvm_torch_sv.so")}
    assert sorted(os.listdir(build)) == ["libplssvm_torch_sv.so", "libplssvm_torch_sv.so.sha256",
                                         "lock"]
