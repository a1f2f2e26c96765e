"""The transformer token path codified in PQ-IR, served on a torch device:
prefill + decode artifacts with the int8 KV cache as persistent plan state.

The PQ-IR builders (:func:`build_prefill_model`, :func:`build_decode_model`)
are ``repro``'s, unchanged: pure PQ-IR emission, so both packages codify the
same graphs byte for byte.  The block — joint QKV projection, per-head fused
int8 attention, output projection, saturating residuals, MLP — compiles to

* **prefill** — ``tokens ("N","S")`` + causal ``mask ("N","S","S")`` in, f32
  logits and per-layer int8 K/V rows out, a two-axis ``("N","S")`` plan;
* **decode** — ``tokens ("N",1)`` + scatter ``onehot ("N","S",1)`` + validity
  ``mask ("N",1,"S")``, with the per-layer KV caches as state slots.

Both plans share one :class:`~repro_torch.backend.plan.PlanCache`.  On the
``cuda`` backend the qkv/down projections run the packed-int4 kernel, o/up the
int8 kernel, and every head of every layer the fused attention kernel.  On a
CUDA device each decode bucket's plan replays as one CUDA graph
(:mod:`repro_torch.backend.graph`): the cache a decode step returns is the
graph's state buffers, overwritten by the next step at that bucket.

:class:`CompiledTokenAdapter` plugs the pair into
:class:`repro_torch.serving.engine.ServeEngine`.  KV caches, logits and the
decode state stay tensors on the plan's device between steps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..backend.plan import PlanCache
from ..core import pqir
from ..core.compile import (
    CompiledModel,
    _resolve_autotuner,
    compile_model,
    host_to_device_async,
    resolve_device,
)
from ..core.moe import emit_qmoe, make_moe_params
from ..core.patterns import ATTN_P_SCALE, emit_qattention, emit_round_clip, fc_layer
from ..core.quant import QuantizedLinearParams, Rescale, RescaleVector, quantize_linear_layer

__all__ = [
    "TokenPathConfig",
    "TokenPathParams",
    "make_token_params",
    "params_from_numpy",
    "build_prefill_model",
    "build_decode_model",
    "CompiledTokenPath",
    "CompiledTokenAdapter",
]


@dataclasses.dataclass(frozen=True)
class TokenPathConfig:
    """Shape + precision config for the codified transformer block.

    Activations live on one shared int8 scale (``act_scale``) — residual adds
    are then plain saturating code-domain adds, and the attention rescale
    collapses to ``1 / p_scale``.  ``bits_*`` select the weight lane per
    projection (4 ⇒ QONNX-style ``weight_bits`` attribute, packed-int4 kernel
    on the cuda backend), so one model mixes w4 and w8 layers.

    The fields after ``bits_down`` widen the block; their defaults emit the
    block above, graph for graph:

    * ``n_kv_heads`` (0: one per query head) — grouped-query attention: the
      ``n_heads / n_kv_heads`` query heads of a group read their KV head's
      slice; ``head_dim`` (0: ``d_model / n_heads``) — the qkv projection is
      ``d_model → n_heads·head_dim + 2·n_kv_heads·head_dim``, o
      ``n_heads·head_dim → d_model``;
    * ``layer_kinds`` (empty: all ``"full"``) — a ``"window"`` layer's query
      at position p attends positions p − window + 1 … p; its decode state
      is a ring of ``window`` rows written at ``p % window``;
    * ``n_experts`` (0: the dense ReLU MLP) — a routed-expert layer
      (:mod:`repro_torch.core.moe`) of ``n_experts`` SwiGLU experts of width
      ``d_expert``, ``top_k`` a token, in place of every MLP."""

    vocab: int = 128
    d_model: int = 64
    n_heads: int = 2
    d_ff: int = 128
    n_layers: int = 2
    act_scale: float = 0.05
    lm_scale: float = 0.01
    bits_qkv: int = 4
    bits_o: int = 8
    bits_up: int = 8
    bits_down: int = 4
    n_kv_heads: int = 0
    head_dim: int = 0
    layer_kinds: Tuple[str, ...] = ()
    window: int = 0
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0

    def __post_init__(self) -> None:
        kinds = self.layer_kinds
        if kinds and (len(kinds) != self.n_layers or set(kinds) - {"full", "window"}):
            raise ValueError(f"layer_kinds {kinds} must give 'full' or 'window' for each of "
                             f"{self.n_layers} layers")
        if "window" in kinds and (self.window < 1 or "full" not in kinds):
            raise ValueError("window layers need window >= 1 and at least one full layer")
        if self.n_heads % self.kv_heads:
            raise ValueError(f"{self.n_heads} query heads do not group over {self.kv_heads} KV heads")
        if self.n_experts and not 1 <= self.top_k <= self.n_experts:
            raise ValueError(f"top_k {self.top_k} of {self.n_experts} experts")

    @property
    def d_head(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def q_width(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_width(self) -> int:
        return self.kv_heads * self.d_head

    def kind(self, layer: int) -> str:
        return self.layer_kinds[layer] if self.layer_kinds else "full"

    @property
    def has_window(self) -> bool:
        return "window" in self.layer_kinds

    @property
    def qk_scale(self) -> float:
        return float(self.act_scale * self.act_scale / np.sqrt(self.d_head))

    @property
    def att_rescale(self) -> float:
        # s_v / (p_scale * s_out) with s_v == s_out == act_scale
        return float(1.0 / ATTN_P_SCALE)


@dataclasses.dataclass
class TokenPathParams:
    """Pre-quantized parameters of the token path (what the artifact embeds)."""

    embedding: np.ndarray  # (vocab, d_model) int8 codes; row 0 all-zero
    #: per layer: ``qkv``, ``o`` and ``up``, ``down`` (or ``moe``: MoEParams)
    layers: List[Dict[str, object]]
    lm_head: np.ndarray  # (d_model, vocab) int8
    lm_scale: float


def make_token_params(cfg: TokenPathConfig, seed: int = 0) -> TokenPathParams:
    """Deterministic pre-quantized parameters.  Weights are drawn small enough
    that activations stay inside int8 on typical inputs (bit-exactness never
    depends on this — saturation is itself exact — it just keeps the logits
    informative)."""
    rng = np.random.default_rng(seed)
    emb = rng.integers(-40, 41, (cfg.vocab, cfg.d_model)).astype(np.int8)
    emb[0] = 0  # token 0 doubles as padding: zero embedding
    s = cfg.act_scale

    def lin(n_in: int, n_out: int, bits: int) -> QuantizedLinearParams:
        w = rng.normal(size=(n_in, n_out)).astype(np.float32) * (0.6 / np.sqrt(n_in))
        b = rng.normal(size=(n_out,)).astype(np.float32) * 0.02
        return quantize_linear_layer(w, b, s, s, bits=bits)

    layers = []
    for _ in range(cfg.n_layers):
        layer = {
            "qkv": lin(cfg.d_model, cfg.q_width + 2 * cfg.kv_width, cfg.bits_qkv),
            "o": lin(cfg.q_width, cfg.d_model, cfg.bits_o),
        }
        if cfg.n_experts:
            layer["moe"] = make_moe_params(rng, cfg.d_model, cfg.d_expert, cfg.n_experts,
                                           cfg.top_k, s)
        else:
            layer["up"] = lin(cfg.d_model, cfg.d_ff, cfg.bits_up)
            layer["down"] = lin(cfg.d_ff, cfg.d_model, cfg.bits_down)
        layers.append(layer)
    head = rng.integers(-64, 65, (cfg.d_model, cfg.vocab)).astype(np.int8)
    return TokenPathParams(emb, layers, head, cfg.lm_scale)


# ---------------------------------------------------------------------------
# PQ-IR emission
# ---------------------------------------------------------------------------

def _slice_feat(gb: pqir.GraphBuilder, x: str, lo: int, hi: int, prefix: str) -> str:
    """Slice [lo, hi) of the trailing feature axis (axis 2)."""
    st = gb.add_initializer(f"{prefix}_starts", np.array([lo], np.int64))
    en = gb.add_initializer(f"{prefix}_ends", np.array([hi], np.int64))
    ax = gb.add_initializer(f"{prefix}_axes", np.array([2], np.int64))
    return gb.op("Slice", [x, st, en, ax], out_hint=f"{prefix}_out")


def _residual(gb: pqir.GraphBuilder, a: str, b: str, prefix: str) -> str:
    """Saturating int8 residual: both operands share act_scale, so the add is
    code-domain — Cast f32 (exact for int8), Add, round+clip back to int8."""
    fa = gb.op("Cast", [a], out_hint=f"{prefix}_a_f", to="float32")
    fb = gb.op("Cast", [b], out_hint=f"{prefix}_b_f", to="float32")
    sm = gb.op("Add", [fa, fb], out_hint=f"{prefix}_sum")
    return emit_round_clip(gb, sm, prefix)


def _kv_update(gb: pqir.GraphBuilder, state: str, new: str, onehot: str, prefix: str) -> str:
    """``new_kv = kv·(1-onehot) + kv_new·onehot`` — int8 elementwise (codes are
    bounded by ±127·1, so no overflow), exact under zero padding: padded rows
    have onehot 0 and state 0, contributing 0."""
    one = gb.add_initializer(f"{prefix}_one", np.int8(1))
    keep = gb.op("Sub", [one, onehot], out_hint=f"{prefix}_keep")
    kept = gb.op("Mul", [state, keep], out_hint=f"{prefix}_kept")
    put = gb.op("Mul", [new, onehot], out_hint=f"{prefix}_put")
    return gb.op("Add", [kept, put], out_hint=f"{prefix}_new")


def _attention(
    gb: pqir.GraphBuilder,
    cfg: TokenPathConfig,
    q_full: str,
    k_full: str,
    v_full: str,
    mask: str,
    prefix: str,
) -> str:
    """Per-head fused attention regions + head concat over the feature axis.
    Query head h reads KV head ``h // (n_heads / kv_heads)``: each KV head's
    slices are emitted once, before the first query head of its group."""
    dh = cfg.d_head
    group = cfg.n_heads // cfg.kv_heads
    heads = []
    for h in range(cfg.n_heads):
        qh = _slice_feat(gb, q_full, h * dh, (h + 1) * dh, f"{prefix}_q{h}")
        if h % group == 0:
            g = h // group
            kh = _slice_feat(gb, k_full, g * dh, (g + 1) * dh, f"{prefix}_k{g}")
            vh = _slice_feat(gb, v_full, g * dh, (g + 1) * dh, f"{prefix}_v{g}")
        heads.append(
            emit_qattention(
                gb, qh, kh, vh, mask, f"{prefix}_att{h}",
                qk_scale=cfg.qk_scale, rescale=cfg.att_rescale,
            )
        )
    if len(heads) == 1:
        return heads[0]
    return gb.op("Concat", heads, out_hint=f"{prefix}_ctx", axis=2)


def _mlp(gb, x: str, p: Dict[str, object], prefix: str) -> str:
    if "moe" in p:
        return emit_qmoe(gb, x, p["moe"], f"{prefix}_moe")
    up = fc_layer(gb, x, p["up"], f"{prefix}_up", activation="Relu")
    return fc_layer(gb, up, p["down"], f"{prefix}_down")


def _lm_head(gb, cfg: TokenPathConfig, params: TokenPathParams, x: str) -> str:
    """Unfused f32 logits: MatMulInteger → Cast → Mul(lm_scale)."""
    w = gb.add_initializer("lm_head_q", params.lm_head)
    acc = gb.op("MatMulInteger", [x, w], out_hint="lm_acc")
    f = gb.op("Cast", [acc], out_hint="lm_f", to="float32")
    sc = gb.add_initializer("lm_scale", np.float32(params.lm_scale))
    return gb.op("Mul", [f, sc], out_hint="logits")


def build_prefill_model(cfg: TokenPathConfig, params: TokenPathParams) -> pqir.Model:
    """The two-axis prefill artifact: logits + per-layer K/V cache rows.

    Outputs: ``logits ("N","S",V) f32`` first, then the K and V cache rows
    ``("N","S",KW) int8`` per layer (KW = ``kv_width``), in the same (k, v) ×
    layer order as the decode graph's declared states — :class:`CompiledTokenPath`
    zips the two (a window layer's rows go into ring order there), so a
    prefilled cache feeds decode directly.  Window layers read the banded
    ``wmask ("N","S","S")`` in place of the causal ``mask``."""
    V, QW, KW = cfg.vocab, cfg.q_width, cfg.kv_width
    gb = pqir.GraphBuilder("token_prefill")
    gb.add_input("tokens", "int32", ("N", "S"))
    gb.add_input("mask", "float32", ("N", "S", "S"))
    if cfg.has_window:
        gb.add_input("wmask", "float32", ("N", "S", "S"))
    table = gb.add_initializer("embedding_q", params.embedding)
    x = gb.op("Gather", [table, "tokens"], out_hint="emb", axis=0)
    kv_outs: List[Tuple[str, str]] = []
    for l, p in enumerate(params.layers):
        pfx = f"l{l}"
        qkv = fc_layer(gb, x, p["qkv"], f"{pfx}_qkv")
        qf = _slice_feat(gb, qkv, 0, QW, f"{pfx}_qs")
        kf = _slice_feat(gb, qkv, QW, QW + KW, f"{pfx}_ks")
        vf = _slice_feat(gb, qkv, QW + KW, QW + 2 * KW, f"{pfx}_vs")
        mask = "wmask" if cfg.kind(l) == "window" else "mask"
        ctx = _attention(gb, cfg, qf, kf, vf, mask, pfx)
        o = fc_layer(gb, ctx, p["o"], f"{pfx}_o")
        x1 = _residual(gb, x, o, f"{pfx}_res1")
        x = _residual(gb, x1, _mlp(gb, x1, p, pfx), f"{pfx}_res2")
        kv_outs.append((kf, vf))
    logits = _lm_head(gb, cfg, params, x)
    gb.add_output(logits, "float32", ("N", "S", V))
    for l, (kf, vf) in enumerate(kv_outs):
        # renamed via identity-free aliasing: the Slice outputs *are* the
        # cache rows; expose them under the decode state-input names
        gb.add_output(kf, "int8", ("N", "S", KW))
        gb.add_output(vf, "int8", ("N", "S", KW))
    return gb.build(opset=17)


def build_decode_model(cfg: TokenPathConfig, params: TokenPathParams) -> pqir.Model:
    """The one-token decode artifact with KV state slots.

    Inputs: ``tokens ("N",1)``, ``onehot ("N","S",1) int8`` (scatter position
    of the new K/V row), ``mask ("N",1,"S")`` (validity: positions ≤ current),
    with window layers ``ring_onehot ("N",W,1)`` and ``ring_mask ("N",1,W)``
    (W = ``window``), plus per-layer state inputs ``k_cache_l`` /
    ``v_cache_l``: ``("N","S",KW)`` for a full layer, ``("N",W,KW)`` rings for
    a window layer.  Each state's updated tensor is both a graph output and
    a declared :class:`~repro_torch.core.pqir.StateSpec`, so the lowering pins
    its buffers."""
    V, QW, KW = cfg.vocab, cfg.q_width, cfg.kv_width
    gb = pqir.GraphBuilder("token_decode")
    gb.add_input("tokens", "int32", ("N", 1))
    gb.add_input("onehot", "int8", ("N", "S", 1))
    gb.add_input("mask", "float32", ("N", 1, "S"))
    if cfg.has_window:
        gb.add_input("ring_onehot", "int8", ("N", cfg.window, 1))
        gb.add_input("ring_mask", "float32", ("N", 1, cfg.window))
    rows = {"full": "S", "window": cfg.window}
    for l in range(cfg.n_layers):
        gb.add_input(f"k_cache_{l}", "int8", ("N", rows[cfg.kind(l)], KW))
        gb.add_input(f"v_cache_{l}", "int8", ("N", rows[cfg.kind(l)], KW))
    table = gb.add_initializer("embedding_q", params.embedding)
    x = gb.op("Gather", [table, "tokens"], out_hint="emb", axis=0)
    updates: List[Tuple[str, str]] = []
    for l, p in enumerate(params.layers):
        pfx = f"l{l}"
        qkv = fc_layer(gb, x, p["qkv"], f"{pfx}_qkv")
        qf = _slice_feat(gb, qkv, 0, QW, f"{pfx}_qs")
        kn = _slice_feat(gb, qkv, QW, QW + KW, f"{pfx}_ks")
        vn = _slice_feat(gb, qkv, QW + KW, QW + 2 * KW, f"{pfx}_vs")
        ring = cfg.kind(l) == "window"
        onehot, mask = ("ring_onehot", "ring_mask") if ring else ("onehot", "mask")
        k_upd = _kv_update(gb, f"k_cache_{l}", kn, onehot, f"{pfx}_kupd")
        v_upd = _kv_update(gb, f"v_cache_{l}", vn, onehot, f"{pfx}_vupd")
        ctx = _attention(gb, cfg, qf, k_upd, v_upd, mask, pfx)
        o = fc_layer(gb, ctx, p["o"], f"{pfx}_o")
        x1 = _residual(gb, x, o, f"{pfx}_res1")
        x = _residual(gb, x1, _mlp(gb, x1, p, pfx), f"{pfx}_res2")
        updates.append((k_upd, v_upd))
    logits = _lm_head(gb, cfg, params, x)
    gb.add_output(logits, "float32", ("N", 1, V))
    for l, (k_upd, v_upd) in enumerate(updates):
        gb.add_output(k_upd, "int8", ("N", rows[cfg.kind(l)], KW))
        gb.add_output(v_upd, "int8", ("N", rows[cfg.kind(l)], KW))
        gb.add_state(f"kv{l}_k", input=f"k_cache_{l}", output=k_upd)
        gb.add_state(f"kv{l}_v", input=f"v_cache_{l}", output=v_upd)
    return gb.build(opset=17)


def params_from_numpy(tree: Mapping) -> TokenPathParams:
    """Build :class:`TokenPathParams` from a plain dict of numpy arrays — the
    form in which weights cross from another framework.

    ``tree`` holds ``embedding``, ``lm_head``, ``lm_scale`` and ``layers``: a
    list with one dict per layer mapping each projection (``qkv``, ``o``,
    ``up``, ``down``) to the fields of :class:`QuantizedLinearParams` —
    ``weight_q``, ``bias_q``, ``scale_x``, ``scale_w``, ``scale_y``,
    ``bits`` (and optionally ``in_dtype``/``out_dtype``) — with the rescale
    flattened to ``quant_scale``, ``shift`` and ``multiplier`` (arrays for a
    per-channel rescale, scalars otherwise)."""

    def linear(d: Mapping) -> QuantizedLinearParams:
        if np.ndim(d["quant_scale"]):
            rescale = RescaleVector(
                np.asarray(d["quant_scale"], np.int64),
                np.asarray(d["shift"], np.int64),
                np.asarray(d["multiplier"], np.float32),
            )
        else:
            rescale = Rescale(int(d["quant_scale"]), int(d["shift"]), float(d["multiplier"]))
        return QuantizedLinearParams(
            weight_q=np.asarray(d["weight_q"], np.int8),
            bias_q=None if d.get("bias_q") is None else np.asarray(d["bias_q"], np.int32),
            scale_x=float(d["scale_x"]),
            scale_w=np.asarray(d["scale_w"]),
            scale_y=float(d["scale_y"]),
            rescale=rescale,
            in_dtype=str(d.get("in_dtype", "int8")),
            out_dtype=str(d.get("out_dtype", "int8")),
            bits=int(d["bits"]),
        )

    return TokenPathParams(
        embedding=np.asarray(tree["embedding"], np.int8),
        layers=[{name: linear(d) for name, d in layer.items()} for layer in tree["layers"]],
        lm_head=np.asarray(tree["lm_head"], np.int8),
        lm_scale=float(tree["lm_scale"]),
    )


def ring_order(rows: torch.Tensor, lens: torch.Tensor, window: int) -> torch.Tensor:
    """A window layer's prefilled rows ``(N, S, KW)`` as its decode ring
    ``(N, window, KW)``: ring row r holds the latest position p < ``lens``
    with ``p % window == r``, and zeros where there is none."""
    r = torch.arange(window, device=rows.device)
    last = lens[:, None] - 1
    p = r[None, :] + window * torch.div(last - r[None, :], window, rounding_mode="floor")
    idx = p.clamp(min=0)[:, :, None].expand(-1, -1, rows.shape[2])
    return rows.gather(1, idx) * (p >= 0)[:, :, None].to(rows.dtype)


# ---------------------------------------------------------------------------
# compiled pair + engine adapter
# ---------------------------------------------------------------------------

class CompiledTokenPath:
    """The prefill/decode artifact pair compiled onto one shared PlanCache,
    on one device (``None`` means the CUDA card).

    Keys in the shared cache are graph-qualified, so the pair holds exactly
    one specialization per visited (graph, batch-bucket, seq-bucket) cell —
    ``cache_stats()`` makes that observable.

    ``autotune`` is ``compile_model``'s (True, a tile-cache path, or an
    Autotuner), resolved once here, so both plans share one tuner session
    (:attr:`autotuner`)."""

    def __init__(
        self,
        cfg: Optional[TokenPathConfig] = None,
        params: Optional[TokenPathParams] = None,
        *,
        backend: str = "cuda",
        device=None,
        seed: int = 0,
        s_granularity: int = 32,
        plan_cache_capacity: int = 32,
        autotune=None,
    ) -> None:
        self.device = resolve_device(device)
        self.autotuner = _resolve_autotuner(autotune)
        self.cfg = cfg if cfg is not None else TokenPathConfig()
        self.params = params if params is not None else make_token_params(self.cfg, seed)
        self.plan_cache = PlanCache(plan_cache_capacity, scope="plan")
        self.prefill_model = build_prefill_model(self.cfg, self.params)
        self.decode_model = build_decode_model(self.cfg, self.params)
        kw = dict(
            backend=backend,
            device=self.device,
            batch="dynamic",
            dynamic_axes={"N": None, "S": s_granularity},
            plan_cache=self.plan_cache,
            autotune=self.autotuner,
        )
        self.prefill_cm: CompiledModel = compile_model(self.prefill_model, **kw)
        self.decode_cm: CompiledModel = compile_model(self.decode_model, **kw)
        self._logits_prefill = self.prefill_model.graph.outputs[0].name
        self._logits_decode = self.decode_model.graph.outputs[0].name
        self.state_specs = list(self.decode_model.graph.states)
        # prefill outputs [1:] are the per-layer (k, v) rows in state order
        pre_kv = [t.name for t in self.prefill_model.graph.outputs[1:]]
        self._prefill_kv = {s.input: n for s, n in zip(self.state_specs, pre_kv)}
        kinds = {f"{kv}_cache_{l}": self.cfg.kind(l) for l in range(self.cfg.n_layers) for kv in "kv"}
        #: the state inputs of window layers (rings), and the first full one
        self.ring_inputs = frozenset(n for n, k in kinds.items() if k == "window")
        self._full_input = next(s.input for s in self.state_specs if kinds[s.input] == "full")

    # -- direct run API -------------------------------------------------------
    def prefill(self, tokens, mask, wmask=None, plen=None):
        """Returns (logits (N,S,V) f32, {state-input name: int8 rows}),
        tensors on the device: ``(N,S,KW)`` for a full layer, and for a
        window layer its ring ``(N,W,KW)`` as decode reads it (row
        ``p % W`` holds position p of the last ``min(plen, W)``, the rest
        zero).  Window layers need the banded ``wmask``; ``plen`` (an int
        or one per row) is each row's prompt length, S when None."""
        feeds = {"tokens": tokens, "mask": mask}
        if self.ring_inputs:
            if wmask is None:
                raise ValueError("a model with window layers prefills with a banded wmask")
            feeds["wmask"] = wmask
        outs = self.prefill_cm.run(feeds)
        cache = {inp: outs[name] for inp, name in self._prefill_kv.items()}
        if self.ring_inputs:
            rows = next(iter(cache.values()))
            n, s = rows.shape[:2]
            lens = torch.as_tensor(np.broadcast_to(np.asarray(s if plen is None else plen), (n,)).copy(),
                                   dtype=torch.int64, device=rows.device)
            for name in self.ring_inputs:
                cache[name] = ring_order(cache[name], lens, self.cfg.window)
        return outs[self._logits_prefill], cache

    def decode(self, tokens, onehot, mask, cache: Dict[str, torch.Tensor]):
        """One decode step at any extents (padded to the bucket and sliced
        back).  Returns (logits (N,1,V), next cache dict).  On a CUDA
        device the next cache is (a view of) the bucket's graph state
        buffers: the next decode at that bucket overwrites it, and a cache
        fed from elsewhere is copied in, left as it was."""
        feeds = {"tokens": tokens, "onehot": onehot, "mask": mask}
        feeds.update(cache)
        outs = self.decode_cm.run(feeds)
        nxt = {s.input: outs[s.output] for s in self.state_specs}
        return outs[self._logits_decode], nxt

    def decode_step(self, tokens, pos, cache: Dict[str, torch.Tensor]):
        """The decode hot loop: one step, the KV state kept as device tensors.

        The position onehot and the causal mask are built on the device from
        ``pos``; host→device traffic per step is the sampled tokens and the
        positions.  At bucket-aligned extents the specialized plan runs
        directly (still fetched from the shared PlanCache every call, so cell
        accounting matches :meth:`decode`); otherwise the step goes through
        :meth:`decode`, which pads and slices.  Returns (logits (N, V) on the
        device, next cache dict).  On a CUDA device the step replays the
        bucket's CUDA graph: the returned cache is its state buffers, which
        the next step at that bucket overwrites (feeding them back costs no
        copy, and in-place writes into them are what that step reads); the
        logits are the caller's own."""
        feeds = self.decode_feeds(tokens, pos, cache)
        n, s = feeds["onehot"].shape[:2]
        cm = self.decode_cm
        if cm.bucket_for("N", n) != n or cm.bucket_for("S", s) != s:
            logits, nxt = self.decode(feeds["tokens"], feeds["onehot"], feeds["mask"], cache)
            return logits[:, 0, :], nxt
        _, execute = cm.specialized({"N": n, "S": s})
        outs = execute(feeds)
        return outs[self._logits_decode][:, 0, :], {sp.input: outs[sp.output] for sp in self.state_specs}

    def decode_feeds(self, tokens, pos, cache: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The decode plan's feeds for one step, on the device: the tokens,
        the position onehot and causal mask built from ``pos`` (and, with
        window layers, the ring's: slot ``pos % W`` written, slots ``<= pos``
        valid), and the cache.  The tokens and positions cross from the host
        without a wait (through page-locked memory on a CUDA device)."""
        toks = host_to_device_async(np.asarray(tokens), self.device, torch.int32)
        pos_t = host_to_device_async(np.asarray(pos), self.device, torch.int64)
        s = int(cache[self._full_input].shape[1])
        ar = torch.arange(s, device=self.device)
        feeds = {
            "tokens": toks,
            "onehot": (ar[None, :, None] == pos_t[:, None, None]).to(torch.int8),
            "mask": (ar[None, None, :] <= pos_t[:, None, None]).to(torch.float32),
        }
        if self.ring_inputs:
            w = self.cfg.window
            ring = torch.arange(w, device=self.device)
            feeds["ring_onehot"] = (ring[None, :, None] == (pos_t % w)[:, None, None]).to(torch.int8)
            feeds["ring_mask"] = (ring[None, None, :] <= pos_t[:, None, None]).to(torch.float32)
        feeds.update(cache)
        return feeds

    def init_cache(self, n: int, s: int) -> Dict[str, torch.Tensor]:
        """Zero caches for ``n`` slots: ``(n, s, KW)`` full layers and
        ``(n, W, KW)`` rings."""
        kw = self.cfg.kv_width
        return {
            spec.input: torch.zeros((n, self.cfg.window if spec.input in self.ring_inputs else s, kw),
                                    dtype=torch.int8, device=self.device)
            for spec in self.state_specs
        }

    def cache_stats(self) -> Dict[str, float]:
        return self.plan_cache.stats

    def graph_stats(self) -> Dict[str, int]:
        """How the shared cache's plans ran: ``captures`` (CUDA graphs
        captured), ``replays`` and ``eager`` calls."""
        return dict(self.plan_cache.graph_stats)


class CompiledTokenAdapter:
    """ServeEngine adapter for the compiled token path: ``init_cache`` /
    ``prefill`` / ``decode`` / ``scatter``, every call executing a
    specialized ExecutionPlan out of the shared PlanCache on the token
    path's device."""

    def __init__(self, tp: CompiledTokenPath) -> None:
        self.tp = tp
        self.cfg = tp.cfg
        self.max_len = 0

    def init_cache(self, slots: int, max_len: int):
        self.max_len = max_len
        return self.tp.init_cache(slots, max_len)

    def prefill(self, padded: np.ndarray, plen: int, max_len: int):
        bucket = padded.shape[1]
        ones = torch.ones((bucket, bucket), dtype=torch.float32, device=self.tp.device)
        mask = torch.tril(ones)
        if not self.tp.ring_inputs:
            logits, cache = self.tp.prefill(padded, mask[None])
        else:
            wmask = mask * torch.triu(ones, diagonal=1 - self.cfg.window)
            logits, cache = self.tp.prefill(padded, mask[None], wmask[None], plen=plen)
        return logits[0, plen - 1], cache

    def scatter(self, cache, slot: int, pcache):
        # Deliberately in place: the prefilled rows are written straight into
        # the slot's region of the device cache, with no host round trip and
        # no copy of the other slots.  The cache tensors belong to the engine
        # (what the last decode step returned, or init_cache's): on a CUDA
        # device the decode graph's state buffers, which its next replay
        # reads, so the write is seen there and nowhere else.
        for name, buf in cache.items():
            rows = pcache[name]
            n = min(rows.shape[1], buf.shape[1])
            buf[slot, :n].copy_(rows[0, :n])
            # rows ≥ prompt bucket keep their contents: masked until the
            # decode onehot overwrites them position by position
        return cache

    def decode(self, toks: np.ndarray, pos: np.ndarray, cache):
        return self.tp.decode_step(toks, pos, cache)
