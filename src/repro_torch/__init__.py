"""repro_torch — the PyTorch/CUDA port of the DCAFE serving stack.

A second package beside the JAX reference ``repro``.  It keeps the
reference's module layout and names (``configs``, ``sched``, ``obs``,
``kernels``, ``models``, ``serve``, ``launch``) so each module's
counterpart is easy to find, imports ``torch`` and ``numpy`` only, and
never imports ``jax`` or ``repro``.  The host-side scheduler
(``sched``/``obs``) is a verbatim copy; the device path (models and the
hand-written Hopper kernels under ``csrc/``) is a port.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :mod:`repro_torch.device`); with no card and no explicit CPU
request they raise instead of falling back.
"""
