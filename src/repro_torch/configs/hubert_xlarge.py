"""hubert-xlarge [audio] — encoder-only (non-causal), gelu FFN, frame-embedding
frontend stub (conv feature extractor output dim 512). [arXiv:2106.07447; unverified]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504,
    mlp_type="gelu", causal=False, frontend_dim=512,
)

SMOKE = ModelConfig(
    name="hubert-xlarge-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=32,
    mlp_type="gelu", causal=False, frontend_dim=24,
    dtype="float32", remat="none", seq_chunk=64,
)
