"""The benchmark's plain reference of the port's step.

``elm/`` is a frozen copy of ``elmkernels_torch``'s plain path (its
constants, the state and parameter builders, the synthetic forcing, the
phenology and deposition readers, the month-file forcing reader over
scipy (``data/forcing_files.py``), the physics and the step), with each
dispatch to a CUDA kernel (K1, K2, K4, K5) cut so that the plain version
always runs, and nothing of the port's native reader.  It runs on any
device in plain PyTorch and imports nothing of the program, so a change to
the program cannot move it.  :mod:`columns` drives it over chosen columns,
on the readers the configuration's input kinds give (``sources/``).
"""
