"""The benchmark of ``elmkernels_torch``, the port's PyTorch and CUDA
package: ``run.py`` runs one cell of ``BENCHMARK.json`` once."""
