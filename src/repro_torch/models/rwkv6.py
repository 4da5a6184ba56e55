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

Under a mesh (``models.parallel``) the heads are split over the model axis
(all heads on every model shard where the axis does not divide them): the
r/k/v/g projections are column-parallel, each shard runs ``wkv6_chunk`` on
its heads (strided views, as on one device) and keeps their state, the
decay LoRA gives its heads' columns (``w_lora_b``'s FSDP dim gathered
first), the output norm's mean square is a ``psum`` of the shards' sums,
and ``wo`` and ``cv`` are row-parallel. ``cr`` is gathered over the model
axis (its gate multiplies the replicated channel-mix output).

Under a sequence split (the "sp" and "msp" profiles) x holds this worker's
rows. The token shift needs the row before them and the chunk recurrence
the state at their start, so, as the reference's chunk scans do inside a
shard, the time mix gathers the whole sequence over the model axis
(``Par.gather_seq``), runs on it (``wkv6_chunk`` at its unsharded shapes;
under "msp" on the shard's heads) and keeps its rows at the end
(``Par.leave``: the heads' partial outputs scattered onto them, or under
"sp" the rows taken). The channel mix gathers to shift too; its gate runs
on the worker's rows.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..comm import spmd
from ..kernels.wkv6_chunk import ops as wkv_ops
from ..kernels.wkv6_chunk import ref as wkv_ref
from . import parallel
from .layers import normal, records_grad

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


def time_mix(p: Params, x: torch.Tensor, cfg, x_prev: torch.Tensor,
             s0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunked WKV6. x: (B, S, D) (under a sequence split this worker's
    rows, and S the whole sequence's length); S must be a multiple of the
    chunk q = min(ssm_chunk, S). Returns (y (the rows of x), new state (B,
    H, 64, 64) f32, the sequence's last x); the state holds this model
    shard's heads (module doc).

    The (B, S, H, 64) projections go to ``wkv6_chunk`` chunk by chunk as
    strided views (no transposed copies), and each chunk's y is written into
    one (B, S, H, 64) f32 buffer."""
    par = parallel.current()
    x = par.gather_seq(x)  # the whole sequence under a sequence split
    b, s, d = x.shape
    q = min(cfg.ssm_chunk, s)
    if s % q:
        raise ValueError(f"sequence length {s} is not a multiple of the chunk {q}")
    r, k, v, g, logw, u, ln_x, lo = _projections(p, x, _token_shift(x, x_prev), cfg, par)
    h = r.shape[-1] // HEAD

    heads = [t.reshape(b, s, h, HEAD) for t in (r, k, v, logw)]
    state = s0.float().contiguous()
    chunks = [[t[:, c:c + q].transpose(1, 2) for t in heads]  # (B, H, q, 64) views
              for c in range(0, s, q)]
    if records_grad(*heads, u, s0):
        ys = []
        for r_c, k_c, v_c, lw_c in chunks:
            y_c, state = wkv_ref.wkv6_chunk_factored(r_c, k_c, v_c, lw_c, u, state)
            ys.append(y_c)
        y = torch.cat(ys, dim=2).transpose(1, 2)
    else:
        y = torch.empty((b, s, h, HEAD), dtype=torch.float32, device=x.device)
        for c, (r_c, k_c, v_c, lw_c) in zip(range(0, s, q), chunks):
            _, state = wkv_ops.wkv6_chunk(r_c, k_c, v_c, lw_c, u, state,
                                          out=y[:, c:c + q].transpose(1, 2))
    y = y.reshape(b, s, h * HEAD).to(x.dtype)
    return _out(p, y, g, ln_x, lo, cfg, par, whole=True), state, x[:, -1, :]


def _projections(p: Params, x, xs, cfg, par):
    """A model shard's time-mix inputs from x and its shifted copy (token
    shift or the decode carry): r, k, v, g and the log decay
    -exp(w_base + tanh(x_w @ a) @ b) (the LoRA in f32) of its heads'
    columns [lo, lo + D_l), its heads' bonus and ``ln_x`` columns, and lo.
    x and xs (the whole sequence) enter through ``Par.copy_in``, the
    replicated leaves through ``Par.cols``."""
    d = cfg.d_model
    nh = d // HEAD
    h0, h1 = par.model_block(nh) if nh % par.t_size == 0 else (0, nh)
    lo, hi = h0 * HEAD, h1 * HEAD
    xc, xsc = par.copy_in(x), par.copy_in(xs)

    def mix(mu):
        return _mix(xc, xsc, par.cols(p[mu], 0, d, 0, d))

    def col(name):
        return par.cols(par.fsdp(p[name], 0, d), 1, d, lo, hi)

    r, k, v = mix("mu_r") @ col("wr"), mix("mu_k") @ col("wk"), mix("mu_v") @ col("wv")
    g = F.silu(mix("mu_g") @ col("wg"))
    lora_a = par.fsdp(p["w_lora_a"], 0, d)
    lora_b = par.fsdp(p["w_lora_b"], 1, d)
    lora_a = par.cols(lora_a, 1, lora_a.shape[1], 0, lora_a.shape[1])
    logw = -torch.exp(par.cols(p["w_base"], 0, d, lo, hi)
                      + torch.tanh(mix("mu_w") @ lora_a).float()
                      @ par.cols(lora_b, 1, d, lo, hi).float())
    return (r, k, v, g, logw, par.cols(p["u_bonus"], 0, nh, h0, h1),
            par.cols(p["ln_x"], 0, d, lo, hi), lo)


def _out(p: Params, y, g, ln_x, lo, cfg, par, whole: bool = False):
    """The time mix's output from a shard's heads y (..., D_l): the RMS norm
    over the full D (the mean square a ``psum`` of the shards' sums where
    the heads are split), the gate, then ``wo`` row-parallel (this shard's
    rows of the model axis's block) and the ``psum`` (``Par.leave``;
    ``whole``: y covers the whole sequence, and this worker's rows of the
    output are kept)."""
    d = cfg.d_model
    yf = y.float()
    if yf.shape[-1] == d:
        var = torch.mean(yf * yf, dim=-1, keepdim=True)
    else:
        ss = spmd.psum(torch.sum(yf * yf, dim=-1, keepdim=True), par.tp)
        var = spmd.copy(ss, par.tp) / d
    yn = (yf * torch.rsqrt(var + cfg.norm_eps) * ln_x.float()).to(y.dtype) * g
    r0, r1 = par.model_block(d)
    if (r0, r1) != (lo, lo + yn.shape[-1]):
        yn = yn[..., r0 - lo:r1 - lo]
    return par.leave(yn @ par.cols(par.fsdp(p["wo"], 1, d), 0, d, r0, r1), whole=whole)


def time_mix_decode(p: Params, x: torch.Tensor, cfg, x_prev: torch.Tensor,
                    s0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact single-token recurrence, plain PyTorch. x: (B, D); s0 this
    model shard's heads."""
    b = x.shape[0]
    x_prev = x_prev.to(x.dtype)  # the cache stores f32; keep the carry's dtype
    par = parallel.current()
    r, k, v, g, logw, u, ln_x, lo = _projections(p, x, x_prev, cfg, par)
    h = r.shape[-1] // HEAD
    r_, k_, v_ = (t.reshape(b, h, HEAD).float() for t in (r, k, v))
    kv = k_[..., :, None] * v_[..., None, :]
    y = (r_[..., None, :] @ (s0 + u[None, :, :, None] * kv))[..., 0, :]
    s_new = s0 * torch.exp(logw).reshape(b, h, HEAD)[..., None] + kv
    return _out(p, y.reshape(b, h * HEAD).to(x.dtype), g, ln_x, lo, cfg, par), s_new, x


def channel_mix(p: Params, x: torch.Tensor,
                x_prev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Finch channel mix (relu^2). x: (B, S, D) (under a sequence split
    this worker's rows); returns (out, the sequence's last x). The shift
    reads the whole sequence (gathered over the model axis under a
    sequence split); under "msp" the hidden product runs on it with the
    shard's columns and its output is scattered onto the rows, under "sp"
    everything runs on the rows."""
    par = parallel.current()
    xg = par.gather_seq(x)
    xs = _token_shift(xg, x_prev)
    if par.seq is None:
        return _channel_mix(p, x, xs), x[:, -1, :]
    if par.tp is None:
        return _channel_mix(p, x, par.rows(xs)), xg[:, -1, :]
    return _channel_mix(p, x, par.rows(xs), xg, xs), xg[:, -1, :]


def channel_mix_decode(p: Params, x: torch.Tensor, x_prev: torch.Tensor):
    return _channel_mix(p, x, x_prev.to(x.dtype)), x


def _channel_mix(p: Params, x, xs, xg=None, xgs=None):
    """relu^2 of this model shard's ``ck`` columns times its ``cv`` rows,
    ``psum``-ed (the model axis divides the hidden width:
    ``parallel.check_mesh``); the gate sigmoid(xr @ cr) on the replicated
    x, with ``cr`` gathered over the model axis. ``xg`` and ``xgs``: the
    whole sequence and its shift, for the hidden product under "msp" (its
    output then scattered onto x's rows, ``Par.leave``); the gate runs on
    x's rows, ``cr`` then gathered with its gradient summed (each worker's
    rows give a part)."""
    par = parallel.current()
    d = x.shape[-1]
    f = p["ck"].shape[1] * par.t_size
    lo, hi = par.model_block(f)
    if xg is None:
        xg, xgs = x, xs
    xk = _mix(par.copy_in(xg), par.copy_in(xgs), par.cols(p["cmu_k"], 0, d, 0, d))
    hdn = torch.square(F.relu(xk @ par.cols(par.fsdp(p["ck"], 0, d), 1, f, lo, hi)))
    cm = par.leave(hdn @ par.cols(par.fsdp(p["cv"], 1, d), 0, f, lo, hi))
    cr = par.fsdp(p["cr"], 0, d)
    if cr.shape[1] != d:
        gather = spmd.gather_replicated if par.seq is None else spmd.gather
        cr = gather(cr, 1, par.tp)
    return torch.sigmoid(_mix(x, xs, p["cmu_r"]) @ cr) * cm


def init_rwkv_cache(cfg, batch: int, *, device=None) -> RWKVCache:
    d = cfg.d_model
    return RWKVCache(
        s=torch.zeros((batch, d // HEAD, HEAD, HEAD), dtype=torch.float32, device=device),
        x_tm=torch.zeros((batch, d), dtype=torch.float32, device=device),
        x_cm=torch.zeros((batch, d), dtype=torch.float32, device=device),
    )
