"""repro_torch — the Wenquxing 22A SNN datapath, and the LM scaffold's
serving path, on PyTorch and CUDA.

The PyTorch/CUDA counterpart of the JAX package ``repro``, module for
module (``core/``, ``kernels/``, ``engine/``, ``serving/``, ``models/``,
``configs/``, ...).  Plain tensor code is PyTorch; the kernels are CUDA
C++ written for Hopper (``kernels/csrc/``), built with ``nvcc`` on first
use.

Packed u32 words (synapse rows, spike rows) are held as ``torch.int32``
bit patterns: CPU PyTorch has no uint32 shift, add or compare.  The
plain versions widen them to ``int64`` and mask to 32 bits; the CUDA
kernels read them as ``uint32_t``.  :mod:`repro_torch.convert` moves
weight banks in and out as numpy ``uint32``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for ``cuda`` without a card raises.
"""
