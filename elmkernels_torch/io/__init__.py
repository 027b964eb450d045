"""Native input: the port's NetCDF-3 reader (:mod:`elmkernels_torch.io.native`),
built from ``elmkernels_torch/csrc/elmio.cc`` at first use."""
