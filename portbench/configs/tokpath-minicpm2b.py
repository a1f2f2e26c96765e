"""tokpath-minicpm2b: ``serving/token_path.py``'s codified PQ-IR block at
MiniCPM-2B's widths, served by the compiled token path.

The pre-quantized parameters are drawn on the device from the seed, in one
call per kind of tensor and in the types they are served in: int8
embedding codes (row 0, the padding token, all zero), int4-ranged codes for
the w4 projections (qkv, down) and int8 codes for the w8 ones (o, up),
int32 bias codes, and one rescale per projection and layer, derived from
the code ranges so that each projection's output codes spread about
``gain`` times its input's, and int8 lm_head codes of its own (untied: see
``why_reduced`` in the JSON file). No float weight is calibrated.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from harness import codes

LOOP = "engine"


def shapes(cfg):
    """(K, N) of each projection."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    return {"qkv": (d, 3 * d), "o": (d, d), "up": (d, f), "down": (f, d)}


def make_inputs(cfg, seed, device):
    import torch

    a = cfg["assumed"]
    d, v, n_layers = cfg["hidden_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    if cfg["num_key_value_heads"] != cfg["num_attention_heads"] or cfg["tie_word_embeddings"]:
        raise ValueError("the codified block has one KV head per query head and an lm_head of its own")
    g = codes.generator(codes.derived_seeds(seed, 1)[0], device)
    emb = codes.uniform_codes(g, *a["embedding_codes"], (v, d), torch.int8, device)
    emb[0] = 0
    layers = {}
    for name, (k, n) in shapes(cfg).items():
        bits = int(a["bits"][name])
        lo, hi = a["weight_codes"][str(bits)]
        m = float(np.float32(a["gain"] / (math.sqrt(k) * codes.code_std(lo, hi))))
        b_hi = max(1, round(a["bias_codes"] / m))
        qs, shift = codes.rescale_pair(m)
        layers[name] = dict(
            w=codes.uniform_codes(g, lo, hi, (n_layers, k, n), torch.int8, device),
            b=codes.uniform_codes(g, -b_hi, b_hi, (n_layers, n), torch.int32, device),
            quant_scale=qs, shift=shift, multiplier=m, bits=bits,
        )
    head = codes.uniform_codes(g, *a["lm_head_codes"], (d, v), torch.int8, device)
    return dict(embedding=emb, layers=layers, lm_head=head, act_scale=float(a["act_scale"]),
                lm_scale=float(a["lm_scale"]), heads=int(cfg["num_attention_heads"]))


@dataclasses.dataclass
class System:
    """What the engine serves: the program's adapter over its compiled token
    path, and how to read one slot's int8 KV rows out of the program's
    cache (the decode plan's state slots ``k_cache_<l>`` / ``v_cache_<l>``)."""

    adapter: object
    n_layers: int

    def kv_rows(self, cache, slot: int, n: int):
        """(layers, 2, n, d_model) int8 on the host: rows [0, n) of a slot."""
        import torch

        return torch.stack([
            torch.stack([cache[f"k_cache_{l}"][slot, :n], cache[f"v_cache_{l}"][slot, :n]])
            for l in range(self.n_layers)
        ]).cpu()


def build(cfg, inputs, device) -> System:
    """The program under test: ``CompiledTokenPath`` on backend ``cuda``
    (heuristic tiles, no tuning) behind ``CompiledTokenAdapter``."""
    from repro_torch.core.quant import QuantizedLinearParams, Rescale
    from repro_torch.serving.token_path import (
        CompiledTokenAdapter, CompiledTokenPath, TokenPathConfig, TokenPathParams,
    )

    act = inputs["act_scale"]
    host = {name: (p["w"].cpu().numpy(), p["b"].cpu().numpy()) for name, p in inputs["layers"].items()}
    layers = []
    for l in range(cfg["num_hidden_layers"]):
        layer = {}
        for name, p in inputs["layers"].items():
            w, b = host[name]
            layer[name] = QuantizedLinearParams(
                weight_q=w[l], bias_q=b[l], scale_x=act, scale_w=np.asarray(np.float32(p["multiplier"])),
                scale_y=act, rescale=Rescale(p["quant_scale"], p["shift"], p["multiplier"]),
                bits=p["bits"],
            )
        layers.append(layer)
    emb = inputs["embedding"].cpu().numpy()
    params = TokenPathParams(embedding=emb, layers=layers, lm_head=inputs["lm_head"].cpu().numpy(),
                             lm_scale=inputs["lm_scale"])
    bits = {name: p["bits"] for name, p in inputs["layers"].items()}
    tcfg = TokenPathConfig(
        vocab=cfg["vocab_size"], d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        d_ff=cfg["intermediate_size"], n_layers=cfg["num_hidden_layers"], act_scale=act,
        lm_scale=inputs["lm_scale"], bits_qkv=bits["qkv"], bits_o=bits["o"], bits_up=bits["up"],
        bits_down=bits["down"],
    )
    tp = CompiledTokenPath(tcfg, params, backend="cuda", device=device)
    return System(adapter=CompiledTokenAdapter(tp), n_layers=cfg["num_hidden_layers"])
