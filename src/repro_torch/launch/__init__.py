"""Launchers: thin CLI adapters over :class:`repro_torch.api.AMBSession`.

  * :mod:`repro_torch.launch.train`: AMB / FMB training on the LM, with
    the prefetched data plane.
  * :mod:`repro_torch.launch.serve`: continuous-batching serving with
    background AMB fine-tuning (``--finetune``).
"""
