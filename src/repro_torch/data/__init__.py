from . import pipeline
from .pipeline import DataConfig, SyntheticLMStream, device_put_batch

__all__ = ["pipeline", "DataConfig", "SyntheticLMStream", "device_put_batch"]
