"""The benchmark's plain reference of the port's step.

``elm/`` is a frozen copy of ``elmkernels_torch``'s plain path (its
constants, the state and parameter builders, the synthetic forcing and the
phenology and deposition readers, the physics and the step), with each
dispatch to a CUDA kernel (K1, K2, K4, K5) cut so that the plain version
always runs, and the file-fed forcing reader left out.  It runs on any
device in plain PyTorch and imports nothing of the program, so a change to
the program cannot move it.  :mod:`columns` drives it over chosen columns.
"""
