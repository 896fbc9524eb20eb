"""Conjugate-gradient solver (the algorithm core of LS-SVM training)."""

from .cg import CGResult, CGState, cg_init, cg_run, cg_solve

__all__ = ["CGResult", "CGState", "cg_init", "cg_run", "cg_solve"]
