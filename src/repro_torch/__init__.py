"""PyTorch/CUDA port of the provenance-sketch engine in ``repro``.

The package mirrors ``repro``'s layout (``core/``, ``aqp/``, ``kernels/``,
``runtime/``) with the same module and class names, so each piece has an
obvious counterpart in the JAX reference it is held against.  It imports
``torch`` and numpy, never ``jax`` or ``repro``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see :func:`repro_torch.device.resolve_device`); every
Pallas kernel on the ported path is a hand-written CUDA kernel under
``kernels/csrc``, built with ``nvcc`` on first use.
"""
import torch

# Float32 products and convolutions keep their full 24-bit mantissa: TF32
# would break the integral-f32 exactness envelope the engine's results and
# its parity with the reference rest on.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
