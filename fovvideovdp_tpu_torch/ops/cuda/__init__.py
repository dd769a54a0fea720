"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain PyTorch
versions.

Each wrapper dispatches on the device of its input: a CPU tensor goes to
the plain version, a CUDA tensor launches the kernel or raises.  The
luminance stage also keeps float frames, which no table can hold, on its
plain version, and the Y'CbCr stage a full-screen resize and photometries
of other classes.  Kernels are built from ``csrc/`` at first use (see
``_lib``); importing this package builds nothing.
"""
from fovvideovdp_tpu_torch.ops.cuda._lib import (KERNELS, build,
                                                  launch_counts, launch_scope,
                                                  reset_launch_counts)

__all__ = ["KERNELS", "build", "launch_counts", "launch_scope", "reset_launch_counts"]
