"""Structural diff of two AOT plan artifacts (``repro-plan-v1`` JSON), saved
by ``repro_torch.backend.artifact.save_artifact`` or by ``repro``'s.

The hardware-designer workflow: two versions of a compiled model are saved;
this shows what changed *structurally* — steps (kernel / fusion kind /
buffer slots), per-step tile choices, buffer-pool size, axes, and the
recorded hot scenario cells with their tile sources — without loading
either artifact (pure JSON: no torch, no kernels; the npz sidecars are never
opened).  The tiles compared are ``scripts/plan_diff.py``'s and the port's:
the qmatmul K ``splits`` and the qattention ``cluster`` size are the tiles
the port's tuner picks, so two port plans that differ only in them diff as
different.  On two ``repro`` artifacts the output is ``scripts/plan_diff.py``'s,
line for line.  The top-level ``package`` field is shown when the two
documents differ in it.

Usage:
    python -m repro_torch.scripts.plan_diff old.json new.json

Exit status: 0 when the plans are structurally identical, 1 when they
differ, 2 on bad input — so it slots into CI pipelines as a drift gate.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Tuple

SCHEMA = "repro-plan-v1"

#: shape-record fields worth diffing per step (template + bound forms):
#: ``repro``'s (``bits`` = sub-8-bit weight width; ``b/s/t/dh/bq`` the
#: fused-attention record, ``bq`` its query row-block), then the port's
#: qmatmul K ``splits`` and qattention ``cluster`` size.
_TILE_KEYS = ("m", "k", "n", "kp", "np", "bm", "bk", "bn", "bits", "b", "s", "t", "dh", "bq",
              "splits", "cluster")


def _load(path: str) -> Dict[str, Any]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"error: {path}: {e}", file=sys.stderr)
        raise SystemExit(2)
    if not isinstance(doc, dict) or doc.get("schema") != SCHEMA:
        detail = (
            f"not a {SCHEMA} artifact (schema={doc.get('schema')!r})"
            if isinstance(doc, dict)
            else "not a JSON object"
        )
        print(f"error: {path}: {detail}", file=sys.stderr)
        raise SystemExit(2)
    return doc


def _step_sig(sj: Dict[str, Any]) -> Dict[str, Any]:
    """The structural identity of one step: what a designer diffs."""
    params = sj.get("params", {})
    shape = params.get("shape", {})
    tiles = {}
    if isinstance(shape, dict):
        tiles = {k: shape[k] for k in _TILE_KEYS if k in shape}
    # ref-backend fused steps carry no shape record; the bitwidth then rides
    # as a plain weight_bits param (sub-8-bit only) and must still diff
    if "bits" not in tiles and "weight_bits" in params:
        tiles["bits"] = params["weight_bits"]
    return {
        "kernel": sj.get("kernel"),
        "kind": sj.get("kind"),
        "name": sj.get("name") or sj.get("kernel"),
        "in_slots": [a[1] for a in sj.get("args", []) if a[0] == "slot"],
        "out_slots": sj.get("out_slots", []),
        "tiles": tiles,
    }


def _fmt_tiles(tiles: Dict[str, Any]) -> str:
    return ",".join(f"{k}={tiles[k]}" for k in _TILE_KEYS if k in tiles) or "-"


def _state_sigs(plan: Dict[str, Any]) -> List[str]:
    """Persistent state-slot records: name, pinned slots, dtype and shape
    (the KV cache's seq extent rides in the shape), so a KV-carrying plan
    never diffs clean against its stateless twin."""
    sigs = []
    for rec in plan.get("states", []):
        name, _inp, _out, in_slot, out_slot, dtype, shape = rec
        dims = "×".join(str(d) for d in shape) if shape else "?"
        sigs.append(f"{name}: %{in_slot}->%{out_slot} {dtype}[{dims}]")
    return sigs


def _cells(doc: Dict[str, Any]) -> Dict[str, Dict[str, str]]:
    """cell label -> {step name -> tile record incl. source}."""
    out: Dict[str, Dict[str, str]] = {}
    for cell in doc.get("cells", []):
        label = ",".join(f"{a}={v}" for a, v in sorted(cell["bindings"].items()))
        out[label] = {
            name: _fmt_tiles(rec) + f" [{rec.get('source', 'heuristic')}]"
            for name, rec in sorted(cell.get("tiles", {}).items())
        }
    return out


def diff(a: Dict[str, Any], b: Dict[str, Any], a_name: str = "a",
         b_name: str = "b") -> Tuple[List[str], bool]:
    """Render the structural diff of documents ``a`` and ``b`` (named
    ``a_name`` and ``b_name`` where a hot cell is only in one); returns
    (lines, changed)."""
    lines: List[str] = []
    changed = False

    def row(field: str, va: Any, vb: Any) -> None:
        nonlocal changed
        if va == vb:
            lines.append(f"  {field}: {va}")
        else:
            changed = True
            lines.append(f"  {field}: {va} -> {vb}  [changed]")

    if a.get("package") != b.get("package"):
        row("package", a.get("package", "-"), b.get("package", "-"))
    pa, pb = a["plan"], b["plan"]
    row("backend", pa["backend"], pb["backend"])
    row("buffer slots", pa["num_slots"], pb["num_slots"])
    row("axes", ",".join(pa.get("axes", [])) or "-", ",".join(pb.get("axes", [])) or "-")
    row("state slots", "; ".join(_state_sigs(pa)) or "-", "; ".join(_state_sigs(pb)) or "-")
    row("steps", len(pa["steps"]), len(pb["steps"]))

    sa = [_step_sig(s) for s in pa["steps"]]
    sb = [_step_sig(s) for s in pb["steps"]]
    lines.append("  per-step:")
    for i in range(max(len(sa), len(sb))):
        xa: Optional[Dict] = sa[i] if i < len(sa) else None
        xb: Optional[Dict] = sb[i] if i < len(sb) else None
        if xa is None:
            changed = True
            lines.append(f"    step {i}: (absent) -> {xb['name']} {xb['kernel']}  [added]")
            continue
        if xb is None:
            changed = True
            lines.append(f"    step {i}: {xa['name']} {xa['kernel']} -> (absent)  [removed]")
            continue
        if xa == xb:
            lines.append(
                f"    step {i}: {xa['name']} {xa['kernel']} "
                f"slots {xa['in_slots']}->{xa['out_slots']} tiles {_fmt_tiles(xa['tiles'])}"
            )
            continue
        changed = True
        deltas = []
        for field in ("kernel", "kind", "name", "in_slots", "out_slots"):
            if xa[field] != xb[field]:
                deltas.append(f"{field} {xa[field]} -> {xb[field]}")
        if xa["tiles"] != xb["tiles"]:
            deltas.append(f"tiles {_fmt_tiles(xa['tiles'])} -> {_fmt_tiles(xb['tiles'])}")
        lines.append(f"    step {i}: {xa['name']}: " + "; ".join(deltas) + "  [changed]")

    ca, cb = _cells(a), _cells(b)
    lines.append("  hot cells:")
    if not ca and not cb:
        lines.append("    (none recorded)")
    for label in sorted(set(ca) | set(cb)):
        ta, tb = ca.get(label), cb.get(label)
        if ta is None:
            changed = True
            lines.append(f"    ({label}): only in {b_name}  [added]")
        elif tb is None:
            changed = True
            lines.append(f"    ({label}): only in {a_name}  [removed]")
        elif ta == tb:
            body = "; ".join(f"{n} {r}" for n, r in ta.items()) or "no fused steps"
            lines.append(f"    ({label}): {body}")
        else:
            changed = True
            for name in sorted(set(ta) | set(tb)):
                ra, rb = ta.get(name, "(absent)"), tb.get(name, "(absent)")
                if ra != rb:
                    lines.append(f"    ({label}) {name}: {ra} -> {rb}  [changed]")
    return lines, changed


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="structural diff of two repro-plan-v1 artifacts"
    )
    ap.add_argument("a", help="baseline artifact JSON")
    ap.add_argument("b", help="candidate artifact JSON")
    args = ap.parse_args(argv)
    a, b = _load(args.a), _load(args.b)
    print(f"plan diff: {args.a} vs {args.b}")
    lines, changed = diff(a, b, args.a, args.b)
    print("\n".join(lines))
    print("result: " + ("STRUCTURALLY DIFFERENT" if changed else "structurally identical"))
    return 1 if changed else 0


if __name__ == "__main__":
    sys.exit(main())
