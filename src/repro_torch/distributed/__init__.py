"""Distribution on ``torch.distributed``: mesh specs and counted
collectives (port of ``repro/distributed``)."""
