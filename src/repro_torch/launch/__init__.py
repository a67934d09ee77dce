"""Launchers of the port (port of the reference package's ``launch/``):
``serve`` stands up a served model on the runtime, ``train`` trains one
on synthetic data."""
