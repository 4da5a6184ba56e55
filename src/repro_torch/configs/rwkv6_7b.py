"""rwkv6-7b (Finch) [ssm] — attention-free, data-dependent per-channel decay.
[arXiv:2404.05892; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    num_layers=32, d_model=4096, num_heads=0, num_kv_heads=0,
    d_ff=14336, vocab_size=65536,
)

SMOKE = ModelConfig(
    name="rwkv6-7b-smoke", family="ssm",
    num_layers=2, d_model=128, num_heads=0, num_kv_heads=0,
    d_ff=256, vocab_size=256,
    dtype="float32", remat="none", seq_chunk=64, ssm_chunk=32,
)
