"""Checkable cost contracts of the port (``contracts``), the counterpart of
``repro.analysis``."""
