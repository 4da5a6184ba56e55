"""qwen2-vl-72b [vlm] — M-RoPE (t,h,w)=(16,24,24), dynamic resolution;
backbone only, vision frontend is a stub per assignment. [arXiv:2409.12191; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29568, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6, mrope_sections=(16, 24, 24),
    vision_tokens=1024,
)

SMOKE = ModelConfig(
    name="qwen2-vl-72b-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256,
    qkv_bias=True, mrope_sections=(2, 3, 3), vision_tokens=16,
    dtype="float32", remat="none", seq_chunk=64,
)
