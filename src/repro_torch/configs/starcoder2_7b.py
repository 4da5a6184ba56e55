"""starcoder2-7b [dense] — GQA kv=4, RoPE, gelu FFN (4x). [arXiv:2402.19173; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4,
    d_ff=18432, vocab_size=49152,
    mlp_type="gelu", rope_theta=1e5,
)

SMOKE = ModelConfig(
    name="starcoder2-7b-smoke", family="dense",
    num_layers=2, d_model=72, num_heads=6, num_kv_heads=2,
    d_ff=288, vocab_size=256,
    mlp_type="gelu", dtype="float32", remat="none", seq_chunk=64,
)
