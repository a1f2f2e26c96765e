"""tokpath-mellum2: ``serving/token_path.py``'s codified PQ-IR block at
Mellum2-12B-A2.5B's widths — grouped-query attention (32 query heads over 4
KV heads of 128), sliding-window layers with 1,024-row ring caches, and 64
routed int8 SwiGLU experts of width 896, top-8 — served by the compiled
token path.

The pre-quantized parameters are drawn on the device from the seed, in one
call per kind of tensor and in the types they are served in: int8
embedding codes (row 0, the padding token, all zero), int4-ranged codes for
the w4 qkv projection and int8 codes for o, the router and the experts, one
rescale per projection derived from the code ranges so that each
projection's output codes spread about ``gain`` times its input's, the
router's scale so that its logits spread about ``router_logit_std`` for
inputs spread about ``activation_std``, the SiLU table, and int8 lm_head
codes of its own. No float weight is calibrated.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from harness import codes

LOOP = "engine"


def widths(cfg):
    """(d, query width, KV width, expert width, experts, head width)."""
    dh = cfg["head_dim"]
    return (cfg["hidden_size"], cfg["num_attention_heads"] * dh, cfg["num_key_value_heads"] * dh,
            cfg["moe_intermediate_size"], cfg["num_experts"], dh)


def kinds(cfg):
    names = {"sliding_attention": "window", "full_attention": "full"}
    return [names[t] for t in cfg["layer_types"][: cfg["num_hidden_layers"]]]


def silu_table(act_scale: float) -> np.ndarray:
    """The int8 SiLU table at ``act_scale`` in and out (float64, round half
    to even)."""
    x = (np.arange(256, dtype=np.float64) - 128.0) * act_scale
    return np.clip(np.rint(x / (1.0 + np.exp(-x)) / act_scale), -128, 127).astype(np.int8)


def make_inputs(cfg, seed, device):
    import torch

    a = cfg["assumed"]
    d, qw, kw, f, e, dh = widths(cfg)
    v, n_layers = cfg["vocab_size"], cfg["num_hidden_layers"]
    if cfg["tie_word_embeddings"] or not all(t == "sparse" for t in cfg["mlp_layer_types"][:n_layers]):
        raise ValueError("the codified block has an lm_head of its own and an expert layer in every layer")
    g = codes.generator(codes.derived_seeds(seed, 1)[0], device)
    emb = codes.uniform_codes(g, *a["embedding_codes"], (v, d), torch.int8, device)
    emb[0] = 0

    def rescale(k, bits, gain):
        lo, hi = a["weight_codes"][str(bits)]
        m = float(np.float32(gain / (math.sqrt(k) * codes.code_std(lo, hi))))
        return codes.rescale_pair(m)

    def weights(bits, shape):
        return codes.uniform_codes(g, *a["weight_codes"][str(bits)], (n_layers,) + shape, torch.int8, device)

    bits, gain = a["bits"], a["gain"]
    w = {"qkv": weights(bits["qkv"], (d, qw + 2 * kw)), "o": weights(bits["o"], (qw, d)),
         "router": weights(bits["router"], (d, e)), "gate": weights(bits["experts"], (e, d, f)),
         "up": weights(bits["experts"], (e, d, f)), "down": weights(bits["experts"], (e, f, d))}
    rs = {"qkv": rescale(d, bits["qkv"], gain["qkv"]), "o": rescale(qw, bits["o"], gain["o"]),
          "gate": rescale(d, bits["experts"], gain["gate"]), "up": rescale(d, bits["experts"], gain["up"]),
          "down": rescale(f, bits["experts"], gain["down"])}
    lo, hi = a["weight_codes"][str(bits["router"])]
    router_scale = float(np.float32(a["router_logit_std"] / (math.sqrt(d) * codes.code_std(lo, hi)
                                                              * a["activation_std"])))
    act = float(a["act_scale"])
    silu = torch.from_numpy(silu_table(act)).to(device)
    layers = [dict(qkv=(w["qkv"][l], None, *rs["qkv"]), o=(w["o"][l], None, *rs["o"]),
                   router=w["router"][l], gate=w["gate"][l], up=w["up"][l], down=w["down"][l],
                   gate_rs=rs["gate"], up_rs=rs["up"], down_rs=rs["down"], router_scale=router_scale,
                   h_scale=float(np.float32(a["h_scale"])), silu=silu, bits=dict(bits))
              for l in range(n_layers)]
    head = codes.uniform_codes(g, *a["lm_head_codes"], (d, v), torch.int8, device)
    return dict(embedding=emb, layers=layers, lm_head=head, act_scale=act, lm_scale=float(a["lm_scale"]),
                heads=cfg["num_attention_heads"], kv_heads=cfg["num_key_value_heads"], head_dim=dh,
                window=cfg["sliding_window"], kinds=kinds(cfg), top_k=cfg["num_experts_per_tok"])


@dataclasses.dataclass
class System:
    """What the engine serves: the program's adapter over its compiled token
    path, and how to read one slot's int8 KV rows out of the program's
    cache (the decode plan's state slots ``k_cache_<l>`` / ``v_cache_<l>``:
    ``max_len`` rows for a full layer, a ``window``-row ring for a window
    layer)."""

    adapter: object
    kinds: list

    def kv_rows(self, cache, slot: int, n: int):
        """``{"n": n, layer: (2, rows, KW) int8 on the host}``: rows [0, n)
        of a full layer, the whole ring of a window layer."""
        import torch

        out = {"n": n}
        for l, kind in enumerate(self.kinds):
            rows = slice(0, n) if kind == "full" else slice(None)
            out[l] = torch.stack([cache[f"k_cache_{l}"][slot, rows], cache[f"v_cache_{l}"][slot, rows]]).cpu()
        return out


def build(cfg, inputs, device) -> System:
    """The program under test: ``CompiledTokenPath`` on backend ``cuda``
    (heuristic tiles, no tuning) behind ``CompiledTokenAdapter``."""
    from repro_torch.core.moe import MoEParams
    from repro_torch.core.quant import QuantizedLinearParams, Rescale
    from repro_torch.serving.token_path import (
        CompiledTokenAdapter, CompiledTokenPath, TokenPathConfig, TokenPathParams,
    )

    act = inputs["act_scale"]

    def host(t):
        return t.cpu().numpy()

    def linear(lin, bits):
        w, _, qs, shift = lin
        m = float(np.float32(qs * 2.0 ** -shift))
        return QuantizedLinearParams(weight_q=host(w), bias_q=None, scale_x=act,
                                     scale_w=np.asarray(np.float32(m)), scale_y=act,
                                     rescale=Rescale(qs, shift, m), bits=bits)

    def rescale(pair):
        qs, shift = pair
        return Rescale(qs, shift, float(np.float32(qs * 2.0 ** -shift)))

    layers = []
    for lay in inputs["layers"]:
        bits = lay["bits"]
        moe = MoEParams(router=host(lay["router"]), gate=host(lay["gate"]), up=host(lay["up"]),
                        down=host(lay["down"]), gate_rescale=rescale(lay["gate_rs"]),
                        up_rescale=rescale(lay["up_rs"]), down_rescale=rescale(lay["down_rs"]),
                        router_scale=lay["router_scale"], h_scale=lay["h_scale"], silu=host(lay["silu"]),
                        top_k=inputs["top_k"])
        layers.append({"qkv": linear(lay["qkv"], bits["qkv"]), "o": linear(lay["o"], bits["o"]), "moe": moe})
    params = TokenPathParams(embedding=host(inputs["embedding"]), layers=layers,
                             lm_head=host(inputs["lm_head"]), lm_scale=inputs["lm_scale"])
    d, qw, kw, f, e, dh = widths(cfg)
    tcfg = TokenPathConfig(
        vocab=cfg["vocab_size"], d_model=d, n_heads=cfg["num_attention_heads"], d_ff=0,
        n_layers=cfg["num_hidden_layers"], act_scale=act, lm_scale=inputs["lm_scale"],
        bits_qkv=inputs["layers"][0]["bits"]["qkv"], bits_o=inputs["layers"][0]["bits"]["o"],
        n_kv_heads=cfg["num_key_value_heads"], head_dim=dh, layer_kinds=tuple(inputs["kinds"]),
        window=inputs["window"], n_experts=e, top_k=inputs["top_k"], d_expert=f,
    )
    tp = CompiledTokenPath(tcfg, params, backend="cuda", device=device)
    return System(adapter=CompiledTokenAdapter(tp), kinds=list(inputs["kinds"]))
