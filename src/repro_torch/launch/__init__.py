"""Launchers of the port.

mesh.py    production meshes on a fake process group, the host mesh
steps.py   train / prefill / decode step bundles per (config x input shape)
dryrun.py  every (arch x shape) counted on the meta device and placed on the
           production meshes (``python -m repro_torch.launch.dryrun``)
train.py   the training driver (``python -m repro_torch.launch.train``)

Importing this package imports none of them.
"""
