"""Kernels of the port: hand-written CUDA for Hopper (``csrc/``), their
plain PyTorch versions (``ref``), and the ``impl=`` dispatch
(``registry``, ``ops``) that model code calls."""
