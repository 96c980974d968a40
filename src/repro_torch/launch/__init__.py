"""Launchers: thin CLI adapters over :class:`repro_torch.api.AMBSession`,
and the mesh layer.

  * :mod:`repro_torch.launch.train`: AMB / FMB training on the LM, with
    the prefetched data plane; under torchrun one process per worker.
  * :mod:`repro_torch.launch.serve`: continuous-batching serving with
    background AMB fine-tuning (``--finetune``).
  * :mod:`repro_torch.launch.mesh`: device meshes over the process group.
  * :mod:`repro_torch.launch.specs`: abstract inputs on ``meta``.
  * :mod:`repro_torch.launch.dryrun`: the per-rank cost model.
"""
