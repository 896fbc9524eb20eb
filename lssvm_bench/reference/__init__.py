"""The plain reference: the LS-SVM of the reference implementation
(``csvm.cpp:207-267``, ``OpenMP/csvm.cpp:82-244``) in float64 PyTorch,
written from the mathematics and independent of the program under test.
It imports nothing of the program and takes nothing the program made: it
works the kernel matrix, the system, the solve and the decision values out
again from the inputs the benchmark made.  The program's outputs (alphas,
bias, claimed residual, decision values) are read only to judge them."""
