"""Run checkpoints in the JAX package's on-disk layout (``store.py``) and
payload format (``dfw.py``)."""
from . import dfw, store
from .dfw import (
    PAYLOAD_FORMAT,
    RunCheckpointer,
    read_iterate_packed,
    read_run_extra,
    run_extra,
)
from .store import MANIFEST_FORMAT, CheckpointStore

__all__ = [
    "CheckpointStore",
    "MANIFEST_FORMAT",
    "PAYLOAD_FORMAT",
    "RunCheckpointer",
    "dfw",
    "read_iterate_packed",
    "read_run_extra",
    "run_extra",
    "store",
]
