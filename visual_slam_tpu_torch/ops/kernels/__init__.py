"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

detect_kernel  B1 (B2 as its blur-off mode) — csrc/detect_blur.cu
patch_kernel   B3                            — csrc/patch.cu
seg_kernel     B4 (reduce), B5 (expand)      — csrc/seg.cu

A wrapper takes the plain version for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises. Each wrapper module counts its
launches in a plain int, so a run can show it went through the kernel.
"""


def launch_counts() -> dict:
    """Every wrapper's launches so far, by kernel: B1 (blur on), B3, B4, B5."""
    from . import detect_kernel, patch_kernel, seg_kernel

    return {"detect_blur": detect_kernel.launches, "patch": patch_kernel.launches,
            "cam_reduce": seg_kernel.reduce_launches, "cam_expand": seg_kernel.expand_launches}
