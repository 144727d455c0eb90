"""Device kernels of the port: hand-written CUDA for Hopper (``csrc/``),
their plain torch twins (``ref``) and the public wrappers (``ops``)."""
