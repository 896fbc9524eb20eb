"""On-chip tooling of the port, the twins of the JAX repository's
``scripts/``: each module runs as ``python -m
plssvm_sparse_fp22_tpu_torch.scripts.<name>`` (``--cpu`` for the plain
versions on the CPU), has a ``main(argv) -> dict`` and prints that dict as
one JSON object on its last line of output.

- :mod:`.gpu_validate`: every compute path against the numpy oracle at each
  precision tier (``scripts/tpu_validate.py``);
- :mod:`.profile_cg`: where a CG iteration's time goes, with the device's
  idle share (``scripts/profile_cg.py``);
- :mod:`.precision_study`: iterations, accuracy, alphas and rate per tier
  and kernel, and the adaptive plan (``scripts/precision_study.py``);
- :mod:`.comms_check`: the bytes each multi-process mode moves per A·v
  against ``docs/DESIGN.md``'s model (``scripts/comms_check.py``);
- :mod:`.scaling_bench`: CG iterations/s over meshes of 1, 2 and 4 shards
  (``scripts/scaling_bench.py``).

Two more write the port's documentation on the CPU (``main(argv)``
returns the paths written): :mod:`.gen_apidoc` the API reference in
``docs/api_torch/`` (``scripts/gen_apidoc.py``) and :mod:`.gen_man` the man
pages ``docs/*-torch.1`` from their markdown sources
(``scripts/gen_man.py``).
"""
