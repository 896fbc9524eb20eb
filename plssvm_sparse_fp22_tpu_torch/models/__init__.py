"""Model layer: the LS-SVM estimator and its factory."""

from .base import CSVM, csvm_from_state
from .factory import make_csvm

__all__ = ["CSVM", "csvm_from_state", "make_csvm"]
