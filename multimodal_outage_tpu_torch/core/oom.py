"""Out-of-memory error classification for the trainer's automatic
grad-accumulation fallback (``--grad_accum auto``; JAX core/oom.py).

On the card PyTorch's caching allocator raises
``torch.cuda.OutOfMemoryError`` (``torch.OutOfMemoryError`` in newer
releases, the same class) with a message that starts "CUDA out of
memory". cuBLAS and cuDNN report a failed workspace
allocation as a RuntimeError naming ``CUBLAS_STATUS_ALLOC_FAILED`` or
``CUDNN_STATUS_ALLOC_FAILED``. The JAX package's XLA markers are kept as
well, so one predicate reads either package's messages.
"""

from __future__ import annotations

import torch

OOM_MARKERS = (
    "CUDA out of memory",  # the caching allocator
    "CUBLAS_STATUS_ALLOC_FAILED",  # a cuBLAS workspace
    "CUDNN_STATUS_ALLOC_FAILED",  # a cuDNN workspace
    "RESOURCE_EXHAUSTED",  # XLA's runtime allocation failure
    "ResourceExhausted",
    "Ran out of memory",  # XLA's compile-time budget failure
    "Largest program allocations",
)


def is_oom_error(e: BaseException) -> bool:
    """True when the exception is the allocator's out-of-memory error or
    its message names a device memory overflow."""
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    msg = str(e)
    return any(m in msg for m in OOM_MARKERS)
