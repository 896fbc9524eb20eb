"""``plssvm-generate-data-torch``: synthetic dataset generator.

A copy of the JAX package's ``cli/generate_data.py`` over this package's
file writers: the same seed gives the same bytes.  Equivalent of
``utility_scripts/generate_data.py`` (sklearn's
``make_blobs``/``make_classification``/``make_gaussian_quantiles`` written as
LIBSVM or ARFF; used by the reference's test CMake to create its 5000x2000
stress set, ``tests/CMakeLists.txt:33-59``).  Flag-for-flag coverage of the
reference script: ``--format``, ``--problem`` (incl. the ``*_merged``
variants), ``--samples``/``--test_samples`` (paired train/test files),
``--features``, ``--plot`` (accepted, ignored — no display here).  The
reference always minmax-scales to [-1, 1]; here that is the opt-in
``--minmax_scale`` flag so raw cluster geometry stays available.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _shuffled(generator, X, y):
    """sklearn's ``utils.shuffle`` of both arrays: one permutation drawn by
    shuffling ``arange(n)`` in place."""
    indices = np.arange(X.shape[0])
    generator.shuffle(indices)
    return X[indices], y[indices]


def _make_blobs(samples: int, features: int, seed: int, cluster_std: float = 1.0):
    """``sklearn.datasets.make_blobs(n_samples, n_features, centers=2,
    cluster_std, random_state=seed)`` in numpy, draw for draw: two centres
    uniform in [-10, 10), the samples of each centre in turn, one shuffle.
    The same ``RandomState`` calls in the same order give sklearn's bits, so
    the default problem needs no sklearn."""
    generator = np.random.RandomState(seed)
    centers = generator.uniform(-10.0, 10.0, size=(2, features))
    counts = [samples // 2 + (1 if i < samples % 2 else 0) for i in range(2)]
    X = np.concatenate([generator.normal(loc=centers[i], scale=cluster_std,
                                         size=(n, features)) for i, n in enumerate(counts)])
    y = np.repeat(np.arange(2), counts)
    return _shuffled(generator, X, y)


def _make_gaussian_quantiles(samples: int, features: int, seed: int):
    """``sklearn.datasets.make_gaussian_quantiles(n_samples, n_features,
    n_classes=2, random_state=seed)`` in numpy, draw for draw: an isotropic
    gaussian, labelled by the median distance from the origin."""
    generator = np.random.RandomState(seed)
    X = generator.multivariate_normal(np.zeros(features), np.identity(features), (samples,))
    X = X[np.argsort(np.sum(X ** 2, axis=1)), :]
    step = samples // 2
    y = np.hstack([np.repeat(np.arange(2), step), np.repeat(1, samples - 2 * step)])
    return _shuffled(generator, X, y)


def generate(problem: str, samples: int, features: int, seed: int = 42):
    """Labeled samples for one of the reference's five problem types
    (``utility_scripts/generate_data.py`` problem dispatch), equal to the
    JAX package's generator at the same seed.  The blobs and the ball are
    drawn here with numpy as sklearn draws them; the two ``planes``
    problems call sklearn's ``make_classification`` and need sklearn."""
    if problem == "blobs":
        X, y = _make_blobs(samples, features, seed)
    elif problem == "blobs_merged":
        # overlapping clusters (cluster_std=4.0 upstream)
        X, y = _make_blobs(samples, features, seed, cluster_std=4.0)
    elif problem in ("planes", "planes_merged"):
        try:
            from sklearn import datasets
        except ImportError:
            raise ValueError(f"problem type '{problem}' needs scikit-learn "
                             "(sklearn.datasets.make_classification)") from None
        if problem == "planes":
            X, y = datasets.make_classification(
                n_samples=samples, n_features=features,
                n_informative=2, n_redundant=0, n_clusters_per_class=1,
                n_classes=2, random_state=seed,
            )
        else:
            X, y = datasets.make_classification(
                n_samples=samples, n_features=features,
                n_informative=features, n_redundant=0,
                n_classes=2, random_state=seed,
            )
    elif problem == "ball":
        X, y = _make_gaussian_quantiles(samples, features, seed)
    else:
        raise ValueError(f"unknown problem type '{problem}'")
    labels = np.where(y > 0, 1.0, -1.0)
    return X, labels


def minmax_scale(X: np.ndarray, lo: float = -1.0, hi: float = 1.0) -> np.ndarray:
    """Per-feature min-max scaling to [lo, hi] (the reference applies
    sklearn's ``minmax_scale(feature_range=[-1, 1])`` unconditionally).
    Constant features map to ``lo``."""
    mn = X.min(axis=0)
    span = X.max(axis=0) - mn
    span = np.where(span == 0.0, 1.0, span)
    return lo + (hi - lo) * (X - mn) / span


def _write(path: str, fmt: str, X, labels) -> None:
    if fmt == "arff":
        from ..io.arff import write_arff_file

        write_arff_file(path, X, labels)
    else:
        from ..io.libsvm import write_libsvm_file

        write_libsvm_file(path, X, labels, sparse=False)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="plssvm-generate-data-torch", description="generate a synthetic data set"
    )
    parser.add_argument(
        "--output",
        help="output file; default '<samples>x<features>.<format>' "
             "(extension implies the format when --format is omitted)")
    parser.add_argument("--format", choices=["libsvm", "arff"],
                        help="the file format; either arff or libsvm")
    parser.add_argument("--samples", type=int, required=True,
                        help="the number of training samples to generate")
    parser.add_argument("--test_samples", type=int, default=0,
                        help="the number of test samples to generate "
                             "(written to '<base>_test.<format>'); default: 0")
    parser.add_argument("--features", type=int, required=True)
    parser.add_argument(
        "--problem", default="blobs",
        choices=["blobs", "blobs_merged", "planes", "planes_merged", "ball"],
        help="sklearn generator to use",
    )
    parser.add_argument("--minmax_scale", action="store_true",
                        help="scale features to [-1, 1] per feature "
                             "(the reference script always does)")
    parser.add_argument("--plot", action="store_true",
                        help="accepted for reference-script compatibility; "
                             "ignored (no display attached)")
    parser.add_argument("--seed", type=int, default=42)
    args = parser.parse_args(argv)

    if args.samples <= 0 or args.test_samples < 0 or args.features <= 0:
        parser.error("Number of samples and/or features cannot be 0 or negative!")

    fmt = args.format
    base = args.output
    if base is None:
        if fmt is None:
            parser.error("--format is required when --output is omitted")
        base = f"{args.samples}x{args.features}"
    if fmt is None:
        fmt = "arff" if base.endswith(".arff") else "libsvm"
    # reference behavior: strip a duplicated extension from --output
    if base.endswith("." + fmt):
        base = base[: -(len(fmt) + 1)]
    train_path = f"{base}.{fmt}"
    test_path = f"{base}_test.{fmt}"

    total = args.samples + args.test_samples
    try:
        X, labels = generate(args.problem, total, args.features, args.seed)
    except ValueError as exc:
        # e.g. planes/planes_merged need sklearn and enough features for its
        # informative-feature constraints — a CLI error, not a traceback
        parser.error(str(exc))
    if args.minmax_scale:
        # scaled over train+test together, like the reference
        X = minmax_scale(X)
    if args.plot:
        print("--plot is accepted for compatibility but ignored (no display).")

    _write(train_path, fmt, X[: args.samples], labels[: args.samples])
    print(
        f"wrote {args.samples} x {args.features} '{args.problem}' set to {train_path}"
    )
    if args.test_samples > 0:
        _write(test_path, fmt, X[args.samples:], labels[args.samples:])
        print(
            f"wrote {args.test_samples} x {args.features} '{args.problem}' "
            f"test set to {test_path}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
