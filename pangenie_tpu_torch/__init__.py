"""pangenie_tpu_torch: the PanGenie genotyper on PyTorch and CUDA.

A port of ``pangenie_tpu`` (JAX/Pallas, the reference it is tested
against) to PyTorch, with the device recurrences as hand-written CUDA
kernels for Hopper (``csrc/*.cu``). The package never imports JAX.

Layers:

- ``io``, ``panel``, ``model``, ``kmers``, ``hmm.columns``, ``utils``,
  ``eval``: host code (numpy + the C++ k-mer engine), copies of the
  reference package's modules with only the package name changed
- ``device``  : device and dtype rule
- ``hmm``     : emissions, forward-backward (kernels K1/K2) and the
                haplotype-sampling DP (kernel S1), in torch
- ``commands``: the ``single`` pipeline driver; ``cli`` its entry point
"""

__version__ = "0.1.0"
