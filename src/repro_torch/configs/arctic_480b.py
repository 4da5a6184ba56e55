"""arctic-480b [moe] — 128 experts top-2 + DENSE RESIDUAL MLP in parallel
(dense-MoE hybrid). [hf:Snowflake/snowflake-arctic-base; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000,
    num_experts=128, experts_per_token=2,
    moe_dense_residual=True, moe_dense_ff=4864,
)

SMOKE = ModelConfig(
    name="arctic-480b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=96, vocab_size=256,
    num_experts=8, experts_per_token=2,
    moe_dense_residual=True, moe_dense_ff=96,
    dtype="float32", remat="none", seq_chunk=64,
)
