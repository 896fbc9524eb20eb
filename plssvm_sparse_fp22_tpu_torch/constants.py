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

#: The sparse gram tier's column split (``ops/sparse_gram.py``): a heavy
#: column costs D² multiply-adds in the slab's float32 product, a light one
#: count² pairs in ``csrc/sparse_gram.cu``, so a column is heavy from
#: ``D sqrt(PAIR_RATE / SLAB_RATE)`` rows on.  Each rate is a slope between
#: two sizes at rcv1's shape (``chip_smoke.py`` phase 24, D = 20480; NVIDIA
#: H100 80GB HBM3, 700 W, torch 2.11.0+cu128), so that what both sizes share
#: (the Gram's write, the touched rows' read and write) drops out; no other
#: shape was timed.  Multiply-adds per second of the slab's product, between
#: widths 64 and 512 (1.648 and 8.436 ms):
SPARSE_GRAM_SLAB_RATE: float = 2.768e13
#: pairs per second of the pair kernel, between thresholds 1024 and 4096
#: (1.66e8 and 7.48e8 light pairs; the columns in between hold 1024 to 4095
#: rows, long lists that fill a block, where the split falls):
SPARSE_GRAM_PAIR_RATE: float = 5.4e11
