"""SVM hyper-parameters and file-based configuration state.

Equivalent of ``plssvm::parameter<T>``
(``include/plssvm/parameter.hpp:36-235``, ``src/plssvm/parameter.cpp``) and
the JAX package's ``params.py``, typed with this package's enums: it holds
the kernel hyper-parameters, CG tolerance, backend/target selection,
filenames, and — after parsing — the data/label/alpha arrays.  The
``template<typename T>`` precision axis becomes the ``dtype`` field
(float32 or float64; PyTorch has native float64 on every device).

Filename derivation (``parameter.cpp:575-584``): ``model_filename`` defaults
to ``basename(input) + ".model"`` and ``predict_filename`` to
``basename(input) + ".predict"``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

import numpy as np

from .exceptions import InvalidFileFormatError
from .io.arff import parse_arff_file
from .io.libsvm import ParsedData, parse_libsvm_file
from .io.model import ModelData, parse_model_file
from .types import BackendType, KernelType, TargetPlatform


@dataclass
class Parameter:
    """All configurable SVM parameters (``parameter.hpp:181-222``)."""

    kernel: KernelType = KernelType.linear
    degree: int = 3
    gamma: float = 0.0  # 0.0 -> auto: 1 / num_features (parameter.cpp:150-152)
    coef0: float = 0.0
    cost: float = 1.0
    epsilon: float = 0.001
    print_info: bool = True
    backend: BackendType = BackendType.automatic
    target: TargetPlatform = TargetPlatform.automatic

    input_filename: str = ""
    model_filename: str = ""
    predict_filename: str = ""

    #: training data (dense + CSR), labels, trained weights, test data
    data: ParsedData | None = None
    values: np.ndarray | None = None
    alphas: np.ndarray | None = None
    test_data: ParsedData | None = None

    #: bias of a loaded model: ``bias = -rho`` (``csvm.cpp:42``)
    rho: float = 0.0

    #: numeric precision of the solver (the reference's ``template<typename T>``)
    dtype: Any = np.float32

    #: CG max-iteration override; ``None`` -> ``num_features`` (``csvm.cpp:256``)
    max_iter: int | None = None

    #: CG-state checkpoints (``solver/checkpoint.py`` of the JAX package);
    #: not ported yet, so ``CSVM.learn`` refuses a set path
    checkpoint_path: str | None = None
    checkpoint_interval: int = 50

    #: keep the CSR representation and use the sparse matvec path when the
    #: data density is below this threshold (capability extension; the
    #: reference always densifies, ``parameter.hpp:51-75``)
    sparse_threshold: float = 0.25

    #: print the residual of every CG iteration (``gpu_csvm.cpp:245-247``);
    #: not ported yet, so ``CSVM.learn`` refuses it
    verbose_cg: bool = False

    #: CG preconditioner: "none" (reference semantics) or "jacobi"
    #: (diagonal-preconditioned CG; capability extension — cuts iterations on
    #: ill-conditioned systems while keeping the same stopping criterion)
    precond: str = "none"

    #: number of devices to train/predict over; ``None`` -> one.  The
    #: multi-device learns (``parallel/*``) are not ported yet, so ``CSVM``
    #: refuses more than one (``PLSSVM_DEVICES`` is read the same way)
    devices: int | None = None

    # ------------------------------------------------------------------ files

    def model_name_from_input(self) -> str:
        base = os.path.basename(self.input_filename)
        return base + ".model"

    def predict_name_from_input(self) -> str:
        base = os.path.basename(self.input_filename)
        return base + ".predict"

    def _update_filenames(self, filename: str) -> None:
        """Mirror the filename bookkeeping of ``parse_libsvm_file``
        (``parameter.cpp:136-140``)."""
        if self.model_filename in ("", self.model_name_from_input()):
            self.input_filename = filename
            self.model_filename = self.model_name_from_input()
        self.input_filename = filename

    def parse_file(self, filename: str) -> ParsedData:
        """Dispatch on extension: ``.arff`` -> ARFF else LIBSVM
        (``parameter.cpp:122-128``)."""
        self._update_filenames(filename)
        if filename.endswith(".arff"):
            parsed = parse_arff_file(filename, dtype=np.float64)
        else:
            parsed = parse_libsvm_file(filename, dtype=np.float64)
        if self.gamma == 0.0:
            self.gamma = 1.0 / parsed.num_features
        return parsed

    def parse_train_file(self, filename: str) -> None:
        """Parse training data; labels are required (``parameter.cpp:523-528``)."""
        parsed = self.parse_file(filename)
        if parsed.values is None:
            raise InvalidFileFormatError("Missing labels for train file!")
        self.data = parsed
        self.values = parsed.values

    def parse_test_file(self, filename: str) -> None:
        """Parse test data (labels optional, ``parameter.cpp:531-533``)."""
        parsed = self.parse_file(filename)
        self.test_data = parsed
        # labels of the *test* file (used for accuracy output in the predict
        # CLI, main_predict.cpp:92-105)
        self.values = parsed.values

    def parse_model_file(self, filename: str) -> ModelData:
        """Load a model checkpoint (``parameter.cpp:366-520``)."""
        if self.predict_filename in ("", self.predict_name_from_input()):
            self.model_filename = filename
            self.predict_filename = self.predict_name_from_input()
        self.model_filename = filename

        model = parse_model_file(filename, dtype=np.float64)
        self.kernel = model.kernel
        if model.gamma is not None:
            self.gamma = model.gamma
        if model.degree is not None:
            self.degree = model.degree
        if model.coef0 is not None:
            self.coef0 = model.coef0
        self.rho = model.rho
        self.data = model.support_vectors
        self.alphas = np.asarray(model.alphas)
        self.values = model.labels
        return model

    def __str__(self) -> str:
        """Parameter dump (``operator<<``, ``parameter.cpp:536-570``)."""
        return (
            f"kernel_type                 {self.kernel}\n"
            f"degree                      {self.degree}\n"
            f"gamma                       {self.gamma}\n"
            f"coef0                       {self.coef0}\n"
            f"cost                        {self.cost}\n"
            f"epsilon                     {self.epsilon}\n"
            f"print_info                  {self.print_info}\n"
            f"backend                     {self.backend}\n"
            f"target platform             {self.target}\n"
            f"input_filename              '{self.input_filename}'\n"
            f"model_filename              '{self.model_filename}'\n"
            f"predict_filename            '{self.predict_filename}'\n"
            f"rho                         {self.rho}\n"
            f"real_type                   {np.dtype(self.dtype).name}\n"
        )
