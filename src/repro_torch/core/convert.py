"""Model-zoo W8A8 conversion — the paper's technique as a first-class serving
feature for all 10 architectures, as ``repro.core.convert``.

``convert_params_w8a8(params)`` walks the parameter tree and replaces every
large GEMM weight with the pre-quantized representation ``{"q8": int8, "s":
f32 per-out-channel scales}``; :func:`repro_torch.models.layers.linear` (and
the MoE expert einsums) then compute the paper's MatMulInteger → rescale
chain on int8 operands, exactly.

Deliberately kept in higher precision: MoE routers, norms, LoRA/decay
side-channels (rwkv6), embeddings, and the logits readout.
``export_arch_quant_manifest`` emits the artifact-side record of every
quantized tensor with its §3.1 integer scale+shift decomposition.  Dicts are
walked in sorted key order, as ``jax.tree_util`` flattens them, so the
manifest lists its tensors in ``repro``'s order.
"""
from __future__ import annotations

from typing import Dict, Set

import numpy as np
import torch

from .qlayers import div127
from .quant import decompose_multiplier

# weight leaves (by path-leaf name) that convert to W8A8
W8A8_NAMES: Set[str] = {
    "wq", "wk", "wv", "wo", "wr", "wg",
    "w_gate", "w_up", "w_down",
    "shared_w_gate", "shared_w_up", "shared_w_down",
    "q_down", "q_up", "kv_down", "kv_up",
    "in_proj", "out_proj",
    "cm_wk", "cm_wv", "cm_wr",
}


def _quantize_leaf(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-out-channel int8.  Only the contraction dim (-2) is
    reduced; leading stack dims (layers, experts, hybrid groups) keep their
    own scales, so a stacked slice is ({"q8": (in, out)}, {"s": (out,)})."""
    wf = w.to(torch.float32)
    absmax = wf.abs().amax(dim=w.ndim - 2)
    s = torch.clamp_min(div127(absmax), 1e-12)
    q = torch.clamp(torch.round(wf / s.unsqueeze(w.ndim - 2)), -128, 127).to(torch.int8)
    return {"q8": q, "s": s}


def convert_params_w8a8(params) -> dict:
    """The parameter tree with each W8A8 weight (a leaf named in
    :data:`W8A8_NAMES`, two or more dims) pre-quantized; only dicts are
    walked, as ``repro``'s conversion treats every non-dict as a leaf."""
    def conv(name, leaf):
        if isinstance(leaf, dict):
            return {k: conv(k, v) for k, v in leaf.items()}
        if name in W8A8_NAMES and leaf.ndim >= 2:
            return _quantize_leaf(leaf)
        return leaf

    return conv(None, params)


def _flatten_sorted(tree, path=()):
    """(path names, leaf) in ``jax.tree_util`` order: dict keys sorted,
    sequence entries named ``""`` (a sequence key has no ``.key``)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_sorted(tree[k], path + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _flatten_sorted(v, path + ("",))
    else:
        yield path, tree


def export_arch_quant_manifest(params_q) -> dict:
    """Codify the conversion: every quantized tensor with its per-channel
    scale stats and the §3.1 (Quant_scale, shift) decomposition of a unit
    rescale — the hardware-facing record the artifact would embed."""
    entries = []
    for names, leaf in _flatten_sorted(params_q):
        if names[-1] == "s" and len(names) >= 2:
            s = leaf.detach().to("cpu", torch.float64).numpy().ravel()
            r = decompose_multiplier(float(np.median(s)))
            entries.append(
                {
                    "tensor": "/".join(names[:-1]),
                    "channels": int(s.size),
                    "scale_min": float(s.min()),
                    "scale_max": float(s.max()),
                    "quant_scale_median": r.quant_scale,
                    "quant_shift_bits_median": r.shift,
                }
            )
    return {"format": "pq-w8a8/v1", "tensors": entries}
