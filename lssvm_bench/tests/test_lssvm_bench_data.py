"""The generators: sizes from the configuration, values from the seed."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lssvm_bench import data  # noqa: E402
from lssvm_bench.tests.conftest import REPO, small_config  # noqa: E402


def config(name):
    return small_config(json.loads((REPO / "lssvm_bench" / "configs" / f"{name}.json").read_text()))


def test_dense_classes_shapes_and_range():
    cfg = config("ijcnn1-rbf")
    ds = data.make(cfg, 2**31 + 7, "cpu", test_sets=2)
    assert ds.csr.shape == (cfg["rows"], cfg["features"])
    assert ds.dense.shape == ds.csr.shape and ds.csr.has_canonical_format
    assert np.array_equal(ds.csr.toarray(), ds.dense)
    k = cfg["data"]["one_hot"]
    code, rest = ds.dense[:, :k], ds.dense[:, k:]
    assert set(np.unique(code)) == {0.0, 1.0} and np.all(code.sum(axis=1) == 1.0)
    assert np.all(np.abs(rest) < 1.0) and np.all(rest != 0.0)  # squashed into (-1, 1)
    # one of the k code values and every other feature stored: 13 of 22
    assert ds.csr.nnz == ds.rows * (cfg["features"] - k + 1)
    assert ds.csr.nnz / ds.dense.size == pytest.approx(cfg["published"]["density"], abs=1e-4)
    assert set(np.unique(ds.y)) == {-1.0, 1.0}
    assert 0.02 < np.mean(ds.y > 0) < 0.25  # about one in ten
    assert [t.shape for t in ds.tests] == [(cfg["test_rows"], cfg["features"])] * 2
    assert not np.array_equal(ds.tests[0], ds.tests[1])


def test_sparse_docs_shapes_density_and_norm():
    cfg = config("rcv1-rbf")
    ds = data.make(cfg, 12345, "cpu")
    n, f = cfg["rows"], cfg["features"]
    assert ds.csr.shape == (n, f) and ds.dense is None
    assert ds.csr.has_canonical_format
    per_row = ds.csr.nnz / n
    assert 0.6 * cfg["data"]["nnz_per_row"] < per_row < 1.2 * cfg["data"]["nnz_per_row"]
    assert ds.csr.nnz / (n * f) <= 0.25  # the program's sparse path
    assert np.all(ds.csr.data > 0)
    norms = np.sqrt(np.asarray(ds.csr.multiply(ds.csr).sum(axis=1)).ravel())
    np.testing.assert_allclose(norms, 1.0, rtol=1e-12)
    assert 0.3 < np.mean(ds.y > 0) < 0.7


@pytest.mark.parametrize("name", ["ijcnn1-rbf", "rcv1-rbf"])
def test_same_seed_same_inputs_other_seed_same_sizes(name):
    cfg = config(name)
    sets = 1 if cfg["test_rows"] else 0
    a = data.make(cfg, 4000000001, "cpu", test_sets=sets)
    b = data.make(cfg, 4000000001, "cpu", test_sets=sets)
    c = data.make(cfg, 4000000002, "cpu", test_sets=sets)
    assert (a.csr != b.csr).nnz == 0 and np.array_equal(a.y, b.y)
    for s, t in zip(a.tests, b.tests):
        assert np.array_equal(s, t)
    assert c.csr.shape == a.csr.shape and len(c.tests) == len(a.tests)
    assert (a.csr != c.csr).nnz > 0
