"""The benchmark of the PyTorch and CUDA port ``plssvm_sparse_fp22_tpu_torch``
(see ``BENCHMARK.json`` and ``run.py``).  It imports neither JAX nor the JAX
package; its reference imports nothing of the port."""
