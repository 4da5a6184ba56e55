from . import pipeline
from .pipeline import DataConfig, SyntheticLMStream, device_put_batch, shard_rows

__all__ = ["pipeline", "DataConfig", "SyntheticLMStream", "device_put_batch", "shard_rows"]
