"""llama4-scout-17b-a16e [moe] — MoE 16e top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    num_experts=16, experts_per_token=1, rope_theta=5e5,
)

SMOKE = ModelConfig(
    name="llama4-scout-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256,
    num_experts=4, experts_per_token=1,
    dtype="float32", remat="none", seq_chunk=64,
)
