"""qwen2-1.5b [dense] — GQA kv=2, QKV bias, tied embeddings. [arXiv:2407.10671; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151936,
    qkv_bias=True, tie_embeddings=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen2-1.5b-smoke", family="dense",
    num_layers=2, d_model=48, num_heads=4, num_kv_heads=2,
    d_ff=96, vocab_size=256,
    qkv_bias=True, tie_embeddings=True, dtype="float32", remat="none", seq_chunk=64,
)
