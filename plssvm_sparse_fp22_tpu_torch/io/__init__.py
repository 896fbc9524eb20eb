"""Data and model I/O: LIBSVM (dense + sparse), ARFF, LIBSVM model files.

TPU-native equivalent of the reference's parser/writer subsystem
(``src/plssvm/parameter.cpp:41-520``, ``src/plssvm/csvm.cpp:60-204``,
``src/plssvm/detail/file_reader.cpp``).
"""

from .file_reader import read_lines
from .libsvm import parse_libsvm_file, write_libsvm_file
from .arff import parse_arff_file
from .model import ModelData, parse_model_file, write_model_file

__all__ = [
    "read_lines",
    "parse_libsvm_file",
    "write_libsvm_file",
    "parse_arff_file",
    "ModelData",
    "parse_model_file",
    "write_model_file",
]
