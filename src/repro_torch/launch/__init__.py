"""Launchers of the port: ``python -m repro_torch.launch.serve`` (under
``torchrun`` one tensor-parallel rank a card), ``launch.train``,
``launch.dryrun``, and the meshes of ranks (``launch.mesh``)."""
