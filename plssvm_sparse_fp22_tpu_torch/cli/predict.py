"""``plssvm-predict-torch``: the JAX package's ``plssvm-predict`` on PyTorch.

Equivalent of ``src/main_predict.cpp`` +
``src/plssvm/parameter_predict.cpp``: positional ``test_file model_file
[output_file]``, ``-b/-p/-q`` flags, label output one per line, and the
``Accuracy = X% (n/m) (classification)`` summary when the test file carries
labels.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..exceptions import PLSSVMError
from ..io.fmtlib import fmt_shortest
from ..models import make_csvm
from ..params import Parameter
from ..types import (
    BackendType,
    KernelType,
    TargetPlatform,
    list_available_backends,
    list_available_target_platforms,
)


def _argtype(converter):
    """Wrap an enum parser so bad values produce a clean argparse error
    instead of a traceback."""
    def convert(text):
        try:
            return converter(text)
        except PLSSVMError as e:
            raise argparse.ArgumentTypeError(str(e)) from None
    return convert


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="plssvm-predict-torch",
        description="LS-SVM with multiple (GPU-)backends",
        add_help=False,
    )
    parser.add_argument(
        "-b", "--backend", type=_argtype(BackendType.from_string),
        default=BackendType.automatic,
        help=f"choose the backend: {'|'.join(str(b) for b in list_available_backends())}",
    )
    parser.add_argument(
        "-p", "--target_platform", type=_argtype(TargetPlatform.from_string),
        default=TargetPlatform.automatic,
        help="choose the target platform: "
        f"{'|'.join(str(t) for t in list_available_target_platforms())}",
    )
    parser.add_argument("--sycl_implementation_type", default="automatic",
                        help=argparse.SUPPRESS)
    parser.add_argument("--use_float", action="store_true",
                        help="predict in float32 instead of float64")
    parser.add_argument("--sparse_threshold", type=float, default=0.25,
                        help="keep data in CSR when its density is at or below "
                             "this fraction: sparse support vectors and points then "
                             "predict from a cross Gram built with sparse BLAS "
                             "(0 disables the sparse path, 1 forces it)")
    parser.add_argument("-q", "--quiet", action="store_true", help="quiet mode (no outputs)")
    parser.add_argument("-h", "--help", action="help", help="print this helper message")
    parser.add_argument("test", metavar="test_file")
    parser.add_argument("model", metavar="model_file")
    parser.add_argument("output", metavar="output_file", nargs="?", default=None)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    params = Parameter(
        backend=args.backend,
        target=args.target_platform,
        print_info=not args.quiet,
        dtype=np.float32 if args.use_float else np.float64,
        sparse_threshold=args.sparse_threshold,
    )

    try:
        # order matters (parameter_predict.cpp:96-114): test filename first
        # (predict_filename derives from it), then model, then test data
        params.input_filename = args.test
        if args.output is not None:
            params.predict_filename = args.output
        else:
            params.predict_filename = params.predict_name_from_input()
        params.parse_model_file(args.model)
        params.parse_test_file(args.test)
        # after both parses: data = SVs, alphas = SV weights, values = test
        # labels or None — exactly the reference's pointer state
        # (parameter_predict.cpp:113-114)
        test_labels = params.values

        if params.print_info:
            print()
            print("task: prediction")
            print(f"kernel type: {params.kernel} -> ", end="")
            if params.kernel == KernelType.linear:
                print("u'*v")
            elif params.kernel == KernelType.polynomial:
                print("(gamma*u'*v + coef0)^degree")
                print(f"gamma: {params.gamma}")
                print(f"coef0: {params.coef0}")
                print(f"degree: {params.degree}")
            else:
                print("exp(-gamma*|u-v|^2)")
                print(f"gamma: {params.gamma}")
            print(f"rho: {params.rho}")
            print(f"input file (data set): '{params.input_filename}'")
            print(f"input file (model): '{params.model_filename}'")
            print(f"output file (prediction): '{params.predict_filename}'")
            print()

        svm = make_csvm(params)
        if params.print_info:
            print(svm.device_description())
        labels = svm.predict_label_parsed(params.test_data)

        start = time.perf_counter()
        with open(params.predict_filename, "w") as f:
            f.write("\n".join(fmt_shortest(v) for v in labels))
            f.write("\n")  # byte parity with the reference (main_predict.cpp:78-88)
        if params.print_info:
            elapsed = (time.perf_counter() - start) * 1000.0
            print(
                f"Wrote prediction file ('{params.predict_filename}') with "
                f"{len(labels)} labels in {elapsed:.0f}ms."
            )

        # accuracy summary (main_predict.cpp:92-105)
        if test_labels is not None:
            correct = int(np.sum(np.asarray(test_labels) * labels > 0))
            total = len(labels)
            acc = correct / total * 100.0
            print(f"Accuracy = {fmt_shortest(acc)}% ({correct}/{total}) (classification)")
    except PLSSVMError as e:
        print(e.what_with_loc(), file=sys.stderr)
        return 1
    except Exception as e:
        print(e, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
