"""Hand-written CUDA kernels of the port (``csrc/``), their ctypes wrappers,
plain PyTorch versions, and the device-routed dispatch."""
