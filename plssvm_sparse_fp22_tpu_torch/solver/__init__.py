"""Conjugate-gradient solver (the algorithm core of LS-SVM training)."""

from .cg import (AdaptiveCGResult, CGResult, CGState, cg_init, cg_run, cg_run_stagnation,
                 cg_solve, cg_solve_adaptive)

__all__ = ["AdaptiveCGResult", "CGResult", "CGState", "cg_init", "cg_run", "cg_run_stagnation",
           "cg_solve", "cg_solve_adaptive"]
