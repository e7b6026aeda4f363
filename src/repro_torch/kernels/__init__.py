"""Hand-written Hopper kernels of the port, one package per Pallas kernel
of the reference: ``<name>.py`` (wrapper + launch counter), ``ref.py``
(the plain PyTorch version) and ``ops.py`` (what the model calls).  The
CUDA sources live in ``repro_torch/csrc/`` and are built by
:mod:`repro_torch.kernels._build`."""
