"""RWKV-6 (Finch) block, the port's counterpart of ``repro.models.rwkv6``:
data-dependent per-channel decay linear attention.

Time-mix recurrence per head (dk = dv = head size):
    S_t = diag(w_t) S_{t-1} + k_t (x) v_t
    y_t = r_t @ (S_{t-1} + diag(u) k_t (x) v_t)
with decay w_t = exp(-exp(wproj_t)) in (0, 1), data-dependent via a
token-shift LoRA. Prefill runs the chunked form, one ``wkv6_chunk`` call per
chunk of ``cfg.ssm_chunk`` tokens (the CUDA kernel on the card, its plain
chunk form on the CPU: the reference's own chunk step, clamps included);
decode is the exact recurrence in plain PyTorch.

Under autograd (grad mode on and a time-mix input requiring grad) the chunks
take the plain chunk form ``ref.wkv6_chunk_factored`` on the card too, each
chunk's y a tensor of its own rather than a slice written through the
kernel's ``out=``, so the gradient flows: the kernel is a forward only, and
its wrapper refuses a CUDA input that requires grad. The reference's
training differentiates its own jnp chunk scan (its model never calls the
Pallas kernel); the plain form computes the same chunk step with the
kernel's five clamps (ROADMAP caveats (c), (e)). This is a choice between
two exact computations made by what the caller asks for, not a fallback:
with no gradient recorded (prefill, features, serving) every chunk launches
the kernel as before.

Channel mix: relu^2 gated FFN with token shift (Finch §2).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..kernels.wkv6_chunk import ops as wkv_ops
from ..kernels.wkv6_chunk import ref as wkv_ref
from .layers import normal, records_grad, rms_norm

Params = Dict[str, torch.Tensor]

HEAD = 64  # rwkv6 head size (dk = dv)


class RWKVCache(NamedTuple):
    s: torch.Tensor  # (B, H, dk, dv) wkv state
    x_tm: torch.Tensor  # (B, D) last token input of the time-mix ln
    x_cm: torch.Tensor  # (B, D) last token input of the channel-mix ln


def init_rwkv(gen: torch.Generator, cfg, dtype: torch.dtype, device) -> Params:
    """The reference's names, shapes, dtypes and scales (``w_base`` and
    ``u_bonus`` stay f32 in a bf16 model; ``u_bonus`` starts at zero)."""
    d, f = cfg.d_model, cfg.d_ff
    h = d // HEAD
    std = d**-0.5
    lora = 64

    def full(value):
        return torch.full((d,), value, dtype=dtype, device=device)

    return {
        # time mix
        "mu_r": full(0.5),
        "mu_k": full(0.5),
        "mu_v": full(0.5),
        "mu_w": full(0.5),
        "mu_g": full(0.5),
        "wr": normal(gen, (d, d), dtype, device) * std,
        "wk": normal(gen, (d, d), dtype, device) * std,
        "wv": normal(gen, (d, d), dtype, device) * std,
        "wg": normal(gen, (d, d), dtype, device) * std,
        "wo": normal(gen, (d, d), dtype, device) * std,
        # data-dependent decay LoRA: w = base + tanh(x @ a) @ b
        "w_base": torch.full((d,), -1.0, dtype=torch.float32, device=device),
        "w_lora_a": normal(gen, (d, lora), dtype, device) * std,
        "w_lora_b": normal(gen, (lora, d), dtype, device) * (lora**-0.5),
        "u_bonus": torch.zeros((h, HEAD), dtype=torch.float32, device=device),
        "ln_x": torch.ones((d,), dtype=dtype, device=device),
        # channel mix
        "cmu_k": full(0.5),
        "cmu_r": full(0.5),
        "ck": normal(gen, (d, f), dtype, device) * std,
        "cv": normal(gen, (f, d), dtype, device) * (f**-0.5),
        "cr": normal(gen, (d, d), dtype, device) * std,
    }


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> previous token's x (the first position uses x_prev)."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu


def _log_decay(p: Params, wx: torch.Tensor) -> torch.Tensor:
    """-exp(w_base + tanh(wx @ a) @ b), the LoRA in f32."""
    return -torch.exp(p["w_base"] + torch.tanh(wx @ p["w_lora_a"]).float()
                      @ p["w_lora_b"].float())


def time_mix(p: Params, x: torch.Tensor, cfg, x_prev: torch.Tensor,
             s0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunked WKV6. x: (B, S, D); S must be a multiple of the chunk
    q = min(ssm_chunk, S). Returns (y, new state (B, H, 64, 64) f32, last x).

    The (B, S, H, 64) projections go to ``wkv6_chunk`` chunk by chunk as
    strided views (no transposed copies), and each chunk's y is written into
    one (B, S, H, 64) f32 buffer."""
    b, s, d = x.shape
    h = d // HEAD
    q = min(cfg.ssm_chunk, s)
    if s % q:
        raise ValueError(f"sequence length {s} is not a multiple of the chunk {q}")

    xs = _token_shift(x, x_prev)
    r = _mix(x, xs, p["mu_r"]) @ p["wr"]
    k = _mix(x, xs, p["mu_k"]) @ p["wk"]
    v = _mix(x, xs, p["mu_v"]) @ p["wv"]
    g = F.silu(_mix(x, xs, p["mu_g"]) @ p["wg"])
    logw = _log_decay(p, _mix(x, xs, p["mu_w"]))  # (B, S, D) log decay <= 0

    heads = [t.reshape(b, s, h, HEAD) for t in (r, k, v, logw)]
    state = s0.float().contiguous()
    chunks = [[t[:, c:c + q].transpose(1, 2) for t in heads]  # (B, H, q, 64) views
              for c in range(0, s, q)]
    if records_grad(*heads, p["u_bonus"], s0):
        ys = []
        for r_c, k_c, v_c, lw_c in chunks:
            y_c, state = wkv_ref.wkv6_chunk_factored(r_c, k_c, v_c, lw_c, p["u_bonus"], state)
            ys.append(y_c)
        y = torch.cat(ys, dim=2).transpose(1, 2)
    else:
        y = torch.empty((b, s, h, HEAD), dtype=torch.float32, device=x.device)
        for c, (r_c, k_c, v_c, lw_c) in zip(range(0, s, q), chunks):
            _, state = wkv_ops.wkv6_chunk(r_c, k_c, v_c, lw_c, p["u_bonus"], state,
                                          out=y[:, c:c + q].transpose(1, 2))
    y = y.reshape(b, s, d).to(x.dtype)
    y = rms_norm(y, p["ln_x"], cfg.norm_eps) * g
    return y @ p["wo"], state, x[:, -1, :]


def time_mix_decode(p: Params, x: torch.Tensor, cfg, x_prev: torch.Tensor,
                    s0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact single-token recurrence, plain PyTorch. x: (B, D)."""
    b, d = x.shape
    h = d // HEAD
    x_prev = x_prev.to(x.dtype)  # the cache stores f32; keep the carry's dtype
    r = _mix(x, x_prev, p["mu_r"]) @ p["wr"]
    k = _mix(x, x_prev, p["mu_k"]) @ p["wk"]
    v = _mix(x, x_prev, p["mu_v"]) @ p["wv"]
    g = F.silu(_mix(x, x_prev, p["mu_g"]) @ p["wg"])
    w = torch.exp(_log_decay(p, _mix(x, x_prev, p["mu_w"]))).reshape(b, h, HEAD)

    r_, k_, v_ = (t.reshape(b, h, HEAD).float() for t in (r, k, v))
    kv = k_[..., :, None] * v_[..., None, :]
    y = (r_[..., None, :] @ (s0 + p["u_bonus"][None, :, :, None] * kv))[..., 0, :]
    s_new = s0 * w[..., None] + kv
    y = y.reshape(b, d).to(x.dtype)
    y = rms_norm(y, p["ln_x"], cfg.norm_eps) * g
    return y @ p["wo"], s_new, x


def channel_mix(p: Params, x: torch.Tensor,
                x_prev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Finch channel mix (relu^2). x: (B, S, D); returns (out, last x)."""
    xs = _token_shift(x, x_prev)
    xk = _mix(x, xs, p["cmu_k"])
    xr = _mix(x, xs, p["cmu_r"])
    hdn = torch.square(F.relu(xk @ p["ck"]))
    return torch.sigmoid(xr @ p["cr"]) * (hdn @ p["cv"]), x[:, -1, :]


def channel_mix_decode(p: Params, x: torch.Tensor, x_prev: torch.Tensor):
    x_prev = x_prev.to(x.dtype)
    xk = _mix(x, x_prev, p["cmu_k"])
    xr = _mix(x, x_prev, p["cmu_r"])
    hdn = torch.square(F.relu(xk @ p["ck"]))
    return torch.sigmoid(xr @ p["cr"]) * (hdn @ p["cv"]), x


def init_rwkv_cache(cfg, batch: int, *, device=None) -> RWKVCache:
    d = cfg.d_model
    return RWKVCache(
        s=torch.zeros((batch, d // HEAD, HEAD, HEAD), dtype=torch.float32, device=device),
        x_tm=torch.zeros((batch, d), dtype=torch.float32, device=device),
        x_cm=torch.zeros((batch, d), dtype=torch.float32, device=device),
    )
