"""qwen2.5-14b [dense] — GQA kv=8, QKV bias. [hf:Qwen/Qwen2.5-14B; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=13824, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen2.5-14b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
    d_ff=128, vocab_size=256,
    qkv_bias=True, dtype="float32", remat="none", seq_chunk=64,
)
