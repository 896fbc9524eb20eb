"""Tuning constants (``include/plssvm/constants.hpp:16-43``).

``PAD_SIZE`` and ``ROW_BLOCK_SIZE`` keep the JAX package's values so a
padded CG system has the same length in both packages
(``round_up(dept, max(PAD_SIZE, ROW_BLOCK_SIZE))``).  The CUDA kernels mask
ragged shapes themselves and need no padding of their own.
"""

from __future__ import annotations

import os


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


#: padding applied to the CG system size (the analog of
#: ``boundary_size_``, ``gpu_csvm.cpp:133``)
PAD_SIZE: int = _env_int("PLSSVM_PAD_SIZE", 128)

#: the padding rule's second term, and the row block of the plain blocked
#: Gram matvec (``ops/gram_matvec.py``), which never holds more than one
#: ``(ROW_BLOCK_SIZE, N)`` kernel tile
ROW_BLOCK_SIZE: int = _env_int("PLSSVM_ROW_BLOCK_SIZE", 256)

#: CG residual recompute interval (``gpu_csvm.cpp:272``, ``OpenMP/csvm.cpp:130``)
RESIDUAL_REFRESH_INTERVAL: int = 50

#: CUDA Gram tile: a CTA computes a CUDA_TILE x CUDA_TILE block of the Gram
#: matrix (streaming 8 features at a time, ``BK`` in the source).
#: Provisional, not tuned yet.  It must equal ``BM`` in
#: ``csrc/gram_matvec.cu``: the wrappers size their scratch slabs from it,
#: and loading the library checks the two agree.
CUDA_TILE: int = 128

#: The bf16 operands of the Gram kernels carry their feature axis padded with
#: zeros to a multiple of this: one TMA box of the wgmma tile is 64 bf16
#: features (128 bytes, the swizzle span; ``KCHUNK`` in
#: ``csrc/gram_tile_wgmma.cuh``), and a TMA row stride must be a multiple of
#: 16 bytes.
CUDA_FEATURE_PAD: int = 64
