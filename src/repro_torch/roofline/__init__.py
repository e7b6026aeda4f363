"""Roofline terms on the H100's own figures, and the meta-device op
counter of the dry run (:mod:`repro_torch.launch.dryrun`).

Counterpart of ``repro/roofline/``: :mod:`.analysis` keeps the
reference's terms and model-FLOPs estimate with an H100's peaks,
:mod:`.op_counter` replaces the HLO text analyzer (eager PyTorch has no
HLO: it counts the aten ops, the hand-written kernels' own costs and the
counted collectives of one traced step), :mod:`.reanalyze` recomputes
saved records.  :mod:`.sink` is where the kernel wrappers and the
collectives report their costs while a counter is active.
"""
