"""Checkable cost contracts of the port (``contracts``) and the op recorder
they read programs with (``recorder``), the counterpart of
``repro.analysis``'s contracts and HLO walker."""
