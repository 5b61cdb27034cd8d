"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``), their wrappers and
their plain PyTorch versions.

ref.py                 plain versions (CPU tensors and on-card comparison)
persistent_matmul.py   Algorithm 1: persistent CTAs pinned to SMs by %smid
flash_attention.py     causal (+ sliding-window) flash attention, GQA read in the kernel
selective_scan.py      Mamba's SSM recurrence, state carried in and out
ops.py                 model-facing wrappers (CPU -> plain version, CUDA -> kernel)
_build.py              nvcc into ``build/`` at first use, loaded with ctypes
csrc/hopper.cuh        TMA, mbarrier and wgmma helpers the CUDA sources share
"""
