"""Launchers of the port (port of the reference package's ``launch/``):
``serve`` stands up a served model on the runtime, ``train`` trains one
on synthetic data, ``mesh`` builds a ``DeviceMesh`` and its
``AxisInfo``, ``sharding`` gives the partition specs of params,
optimizer state, inputs and caches and places trees as DTensors, and
``dryrun`` traces one step of every arch x shape x production mesh on
the fake process group (run it as ``python -m
repro_torch.launch.dryrun``).  Importing this package touches no device
and no process group."""
from repro_torch.launch import dryrun, mesh, sharding  # noqa: F401

__all__ = ["dryrun", "mesh", "serve", "sharding", "train"]
