"""tapclip_tpu_torch.ops: hand-written CUDA kernels and their plain PyTorch versions.

Importing the package registers the ``tapclip`` ops (``_library.py``), which
the kernel wrappers' forwards reach on every device (``_build.run``).
"""

from tapclip_tpu_torch.ops import _library  # noqa: F401, E402
