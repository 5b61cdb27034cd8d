"""PyTorch/CUDA port of the RTGPU reproduction, for one NVIDIA H100.

Sits beside the JAX package ``repro`` (the reference) and keeps its module
names.  It imports ``torch``, ``numpy`` and the standard library only.
Entry points (``Model``, ``ServingEngine``) run on the card unless the
caller passes ``device="cpu"``; on a CPU tensor each hand kernel's wrapper
runs the kernel's plain PyTorch version instead.
"""
