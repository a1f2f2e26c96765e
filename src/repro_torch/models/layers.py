"""Shared model layers: norms, RoPE, embeddings, gated MLPs.

Everything is a pure function over explicit parameter trees (nested dicts of
tensors), as in ``repro.models.layers``.  Parameters are created through
:func:`param`, which draws from an explicit ``torch.Generator``; sharding
annotations go through ``repro_torch.distributed.sharding.shard`` (the
identity on one card).

JAX promotes mixed float dtypes in a matmul (bf16 @ f32 → f32), where
``torch.matmul`` refuses them; :func:`matmul` and :func:`einsum` promote
both operands first, so every product here takes the dtype ``repro``'s
would.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..distributed.sharding import bind_mesh, grad_as_placed, shard
from ..core.qlayers import dynamic_quantize
from ..kernels.ref import int_matmul


def param(gen: torch.Generator, shape: Sequence[int], scale: float = 0.02,
          dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """Normal(0, scale²) draws from ``gen`` on the generator's device, then
    moved to ``device`` (so a CPU generator gives the same values on any
    device).  On the ``meta`` device nothing is drawn: only shape and dtype."""
    dev = gen.device if device is None else torch.device(device)
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=dev if dev.type == "meta" else gen.device) * scale
    return x.to(device=dev, dtype=dtype)


def remat_chunk(fn, *args):
    """``fn(*args)``, rematerialized when autograd records it: the backward
    keeps only ``fn``'s inputs and runs ``fn`` again, as ``jax.checkpoint``
    wraps a scan body in ``repro`` (a recurrence's chunk: only the carried
    state between chunks is stored).  The recompute runs under the
    forward's mesh (:func:`~repro_torch.distributed.sharding.bind_mesh`)."""
    if torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return checkpoint(bind_mesh(fn), *args, use_reentrant=False)
    return fn(*args)


def _promote(*ts: torch.Tensor):
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two, as ``jnp.matmul``."""
    a, b = _promote(a, b)
    return a @ b


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in the promoted dtype of the operands, as
    ``jnp.einsum``."""
    return torch.einsum(eq, *_promote(*ops))


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """Matmul that dispatches on the weight representation.

    * a plain tensor — a float GEMM (operands promoted, as JAX does);
    * ``{"q8": int8 (in, out), "s": f32 (out,)}`` — W8A8 per the paper:
      dynamic per-tensor symmetric activation quantization, an exact
      int8×int8→int32 contraction, then rescale by ``sx · s``.  The
      contraction runs in float64 (:func:`repro_torch.kernels.ref.int_matmul`),
      exact while K·128·128 ≪ 2⁵³, on the CPU and the card alike;
      ``torch._int_mm`` is not used because it refuses M ≤ 16, every decode
      step.
    """
    if isinstance(w, dict) and "q8" in w:
        xq, sx = dynamic_quantize(x)
        acc = int_matmul(xq, w["q8"])
        return (acc.to(torch.float32) * (sx * w["s"])).to(x.dtype)
    return matmul(x, w)


# -- norms -------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
            plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in f32, output in the input dtype.  ``plus_one`` is the gemma
    convention (weight stored as deviation from 1)."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    w = scale.to(torch.float32)
    if plus_one:
        w = w + 1.0
    return (xf * w).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor], *,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(dt)


# -- rotary embeddings -------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); pos: (..., S) int.  Rotates pairs
    (x[..., :D/2], x[..., D/2:]) — the "half split" convention."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, device=x.device)  # (D/2,)
    ang = pos.to(torch.float32)[..., None] * inv  # (..., S, D/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    if x.ndim == pos.ndim + 2:  # head axis present
        sin, cos = sin[..., None, :], cos[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- MLPs ---------------------------------------------------------------------


def init_mlp(gen, d_model: int, d_ff: int, mlp_type: str = "swiglu",
             dtype=torch.float32, device=None, lead=()) -> dict:
    """``lead`` is the stacked leading shape (layers, groups) of every leaf."""
    lead = tuple(lead)
    p = {}
    if mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = param(gen, lead + (d_model, d_ff), dtype=dtype, device=device)
    p["w_up"] = param(gen, lead + (d_model, d_ff), dtype=dtype, device=device)
    p["w_down"] = param(gen, lead + (d_ff, d_model), dtype=dtype, device=device)
    return p


def mlp(params: dict, x: torch.Tensor, mlp_type: str = "swiglu") -> torch.Tensor:
    if mlp_type in ("swiglu", "geglu"):
        g = linear(x, params["w_gate"])
        u = linear(x, params["w_up"])
        g = shard(g, "batch", None, "mlp_act") if g.ndim == 3 else g
        act = F.silu(g) if mlp_type == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * u
        return linear(h, params["w_down"])
    h = F.gelu(linear(x, params["w_up"]), approximate="tanh")
    return linear(h, params["w_down"])


# -- embeddings ---------------------------------------------------------------


def init_embedding(gen, vocab: int, d_model: int, dtype=torch.float32, device=None) -> dict:
    return {"table": param(gen, (vocab, d_model), scale=1.0, dtype=dtype, device=device)}


def embed(params: dict, tokens: torch.Tensor, *, scale_by_sqrt_dim: bool = False) -> torch.Tensor:
    x = params["table"][tokens.long()]
    if scale_by_sqrt_dim:
        x = x * torch.sqrt(torch.tensor(x.shape[-1], dtype=x.dtype, device=x.device))
    return x


def logits_from_embedding(params: dict, x: torch.Tensor, *,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """Tied-embedding readout (x @ table.T) with optional logit softcapping."""
    logits = x.to(torch.float32) @ grad_as_placed(params["table"]).t().to(torch.float32)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def softcap_fn(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
