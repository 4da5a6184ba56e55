"""codeqwen1.5-7b [dense] — qwen1.5 arch (MHA kv=32, QKV bias, SwiGLU).
[hf:Qwen/CodeQwen1.5-7B; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=13440, vocab_size=92416,
    qkv_bias=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="codeqwen1.5-7b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256,
    qkv_bias=True, dtype="float32", remat="none", seq_chunk=64,
)
