"""Runnable examples of the port (twins of the repo's ``examples/``):
``demo`` (a rendered field view -> detect + pose) and ``ml_subsystem`` (a
model for the ``MlSubsys`` hook)."""
