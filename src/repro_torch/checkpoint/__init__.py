"""Run checkpoints in the JAX package's on-disk layout (``store.py``) and
payload format (``dfw.py``)."""
from . import dfw, store
from .dfw import (
    PAYLOAD_FORMAT,
    RunCheckpointer,
    RunSnapshot,
    read_iterate_packed,
    read_run_extra,
    restore_run,
    run_extra,
)
from .store import MANIFEST_FORMAT, CheckpointStore

__all__ = [
    "CheckpointStore",
    "MANIFEST_FORMAT",
    "PAYLOAD_FORMAT",
    "RunCheckpointer",
    "RunSnapshot",
    "dfw",
    "read_iterate_packed",
    "read_run_extra",
    "restore_run",
    "run_extra",
    "store",
]
