"""zamba2-2.7b [hybrid] — Mamba2 backbone + one SHARED attention block applied
every 6 mamba layers (9 applications over 54 layers). [arXiv:2411.15242; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, hybrid_block=6,
)

SMOKE = ModelConfig(
    name="zamba2-2.7b-smoke", family="hybrid",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256,
    ssm_state=16, ssm_head_dim=16, hybrid_block=2,
    dtype="float32", remat="none", seq_chunk=64, ssm_chunk=32,
)
