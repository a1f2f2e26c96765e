"""repro_torch — the PyTorch/CUDA port of :mod:`repro`'s pre-quantized
model codification stack.

The package mirrors ``repro``'s layout module for module, so each port
module sits at the path of its counterpart.  It imports ``torch`` and numpy
and nothing of ``repro`` (numpy-only modules are kept as copies).  Its
entry points (:func:`repro_torch.core.compile.compile_model`,
:class:`repro_torch.serving.token_path.CompiledTokenPath`) run on the CUDA
card unless the caller passes ``device="cpu"``; the fused kernels are
hand-written CUDA C++ for Hopper (``kernels/csrc``), built with ``nvcc`` at
first use."""
__version__ = "0.1.0"
