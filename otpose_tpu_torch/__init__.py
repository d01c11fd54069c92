"""OTPose in PyTorch with hand-written CUDA kernels for the NVIDIA H100.

A port of the JAX package ``otpose_tpu`` that sits beside it and shares no
code with it.  Module names follow the JAX package so each port module's
counterpart is easy to find.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; on the CPU every kernel wrapper runs its plain
PyTorch version.
"""
