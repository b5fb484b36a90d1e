"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

detect_kernel  B1 (B2 as its blur-off mode) — csrc/detect_blur.cu
patch_kernel   B3                            — csrc/patch.cu
seg_kernel     B4 (reduce), B5 (expand)      — csrc/seg.cu

A wrapper takes the plain version for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises. Each wrapper module counts its
launches in a plain int, so a run can show it went through the kernel.
"""
