"""``plssvm-train-torch``: the JAX package's ``plssvm-train`` on PyTorch.

Equivalent of ``src/main_train.cpp`` + ``src/plssvm/parameter_train.cpp:38-142``
with the JAX CLI's flags (``-t -d -g -r -c -e -b -p -q`` and its
extensions).  ``-b cuda|torch`` and ``-p gpu_nvidia|cpu`` choose the backend
and device; the CLI prints what ``automatic`` resolved to.  SYCL-specific
flags are accepted and ignored for drop-in compatibility.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..exceptions import PLSSVMError
from ..models import make_csvm
from ..params import Parameter
from ..types import (
    BackendType,
    KernelType,
    TargetPlatform,
    list_available_backends,
    list_available_target_platforms,
)
from ..utils.timing import span


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
        prog="plssvm-train-torch",
        description="LS-SVM with multiple (GPU-)backends",
        add_help=False,
    )
    parser.add_argument(
        "-t", "--kernel_type", type=_argtype(KernelType.from_string), default=KernelType.linear,
        help="set type of kernel function.\n"
        " 0 -- linear: u'*v\n"
        " 1 -- polynomial: (gamma*u'*v + coef0)^degree\n"
        " 2 -- radial basis function: exp(-gamma*|u-v|^2)",
    )
    parser.add_argument("-d", "--degree", type=int, default=3,
                        help="set degree in kernel function")
    parser.add_argument("-g", "--gamma", type=float, default=None,
                        help="set gamma in kernel function (default: 1 / num_features)")
    parser.add_argument("-r", "--coef0", type=float, default=0.0,
                        help="set coef0 in kernel function")
    parser.add_argument("-c", "--cost", type=float, default=1.0,
                        help="set the parameter C")
    parser.add_argument("-e", "--epsilon", type=float, default=0.001,
                        help="set the tolerance of termination criterion")
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
    # accepted-and-ignored SYCL flags for reference CLI compatibility
    parser.add_argument("--sycl_kernel_invocation_type", default="automatic",
                        help=argparse.SUPPRESS)
    parser.add_argument("--sycl_implementation_type", default="automatic",
                        help=argparse.SUPPRESS)
    parser.add_argument("--max_iter", type=int, default=None,
                        help="override the CG iteration cap (default: num_features)")
    parser.add_argument("--verbose_cg", action="store_true",
                        help="print every CG iteration's residual (host-syncs per "
                             "iteration; the reference's default verbosity)")
    parser.add_argument("--checkpoint", default=None, metavar="FILE",
                        help="checkpoint CG state to FILE and resume from it")
    parser.add_argument("--checkpoint_interval", type=int, default=50,
                        help="iterations between checkpoints")
    parser.add_argument("--use_float", action="store_true",
                        help="solve in float32 (the CUDA kernels' precision) instead of float64")
    parser.add_argument("--sparse_threshold", type=float, default=0.25,
                        help="keep data in CSR when its density is at or below "
                             "this fraction and train on the sparse tiers (0 disables "
                             "the sparse path, 1 forces it; PLSSVM_SPARSE_MODE="
                             "gram|dense|implicit pins a poly/rbf tier)")
    parser.add_argument("--precond", choices=["none", "jacobi"], default="none",
                        help="CG preconditioner (jacobi cuts iterations on "
                             "ill-conditioned systems; same stopping criterion)")
    parser.add_argument("-q", "--quiet", action="store_true", help="quiet mode (no outputs)")
    parser.add_argument("-h", "--help", action="help", help="print this helper message")
    parser.add_argument("input", metavar="training_set_file")
    parser.add_argument("model", metavar="model_file", nargs="?", default=None)
    return parser


def main(argv=None, timings=None) -> int:
    """Run the CLI on ``argv``.  ``timings`` (a ``utils.timing.Timings``)
    receives the run's ``cli`` span, after the arguments are checked, with
    its parts ``cli/parse`` (the data file), ``cli/learn`` and
    ``cli/write`` (the model file), and the learn's own spans (``setup``
    and ``cg`` with their parts, ``CSVM.timings``)."""
    args = build_parser().parse_args(argv)

    # argument validation precedes any device/backend initialization
    # (parameter_train.cpp:91-95 errors before a csvm is constructed)
    if args.gamma is not None and args.gamma == 0.0:
        print("gamma = 0.0 is not allowed, it doesnt make any sense!", file=sys.stderr)
        return 1

    params = Parameter(
        kernel=args.kernel_type,
        degree=args.degree,
        gamma=args.gamma if args.gamma is not None else 0.0,
        coef0=args.coef0,
        cost=args.cost,
        epsilon=args.epsilon,
        backend=args.backend,
        target=args.target_platform,
        print_info=not args.quiet,
        max_iter=args.max_iter,
        dtype=np.float32 if args.use_float else np.float64,
        sparse_threshold=args.sparse_threshold,
        verbose_cg=args.verbose_cg,
        checkpoint_path=args.checkpoint,
        checkpoint_interval=args.checkpoint_interval,
        precond=args.precond,
    )

    try:
        with span(timings, "cli"):
            _run(params, args, timings)
    except PLSSVMError as e:
        print(e.what_with_loc(), file=sys.stderr)
        return 1
    except Exception as e:  # main_train.cpp:86-89
        print(e, file=sys.stderr)
        return 1
    return 0


def _run(params: Parameter, args, timings) -> None:
    with span(timings, "cli/parse"):
        params.parse_train_file(args.input)
    if args.model is not None:
        params.model_filename = args.model

    if params.print_info:
        print()
        print("task: training")
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
        print(f"cost: {params.cost}")
        print(f"epsilon: {params.epsilon}")
        print(f"input file (data set): '{params.input_filename}'")
        print(f"output file (model): '{params.model_filename}'")
        print()

    svm = make_csvm(params)
    if timings is not None:
        svm.timings = timings
    if params.print_info:
        print(svm.device_description())
    with span(timings, "cli/learn", svm.device):
        svm.learn()
    with span(timings, "cli/write"):
        svm.write_model(params.model_filename)


if __name__ == "__main__":
    sys.exit(main())
