"""nlzm_tpu_torch: the NLZP wide-profile decoder in PyTorch, with CUDA kernels.

A port of the device decode path of nlzm_tpu (JAX) to PyTorch on an
NVIDIA Hopper GPU. The wire format, the host encoder and the container
parsing are shared with nlzm_tpu by import (its jax-free host modules:
format/wide.py, parallel/blocks.py, native.py, constants.py); this
package replaces only the jitted device functions, each by a CUDA kernel
written by hand (nlzm_tpu_torch/csrc) beside a plain PyTorch version.

Every kernel wrapper dispatches on the device of the tensors it is given:
CPU tensors run the plain version, CUDA tensors launch the kernel (built
with nvcc at first use into .build/torch_kernels/). Importing this package
needs neither CUDA nor JAX.
"""

__version__ = "0.1.0"

from .parallel.blocks import decode_container, encode_container

__all__ = ["decode_container", "encode_container", "__version__"]
