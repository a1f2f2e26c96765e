"""Hardware model and roofline cost estimates for the port's tile search.

The port of ``repro.backend.cost`` for the H100: one importable home for
the card's published peaks and for the analytic cost of a launch of each
hand-written kernel at a given tiling.  Two consumers share it:

* :mod:`repro_torch.backend.autotune` ranks the qmatmul kernel's legal
  ``(bm, splits)`` tilings with :func:`qmatmul_tile_cost`, so only the most
  promising ``budget`` of them are ever timed (the attention kernel has at
  most five cluster sizes, and the tuner times every one
  :func:`repro_torch.kernels.qattention.check_cluster` accepts — that check
  is also where the attention kernel's shared memory is accounted);
* ``chip_smoke.py`` computes every kernel's bound from :data:`H100_SXM`.

The byte and shared-memory accounting is the qmatmul kernel's own
(``kernels/csrc/qmatmul.cu``).  A tile cost
is ``max(T_ops, T_mem)`` of one block on one SM — the block's share of the
launch's operations and bytes over the SM's share of the card's peak rates
— times the wave quantisation ``ceil(blocks / SMs)``.  It ranks candidates
and is never reported as a time: the tuner measures.  Everything here is
analytic and deterministic.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..kernels import qmatmul as _qmm


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """One card's peak rates, the limits a tiling must fit, and the fleet
    the roofline fraction divides by."""

    name: str
    peak_int8_ops: float  # operations/s, int8 tensor cores, dense
    hbm_bw: float  # bytes/s
    sms: int  # streaming multiprocessors
    smem_per_block: int  # bytes of shared memory one block may opt in to
    peak_bf16_flops: float  # FLOP/s, bf16 tensor cores, dense
    link_bw: float  # bytes/s into one card over NVLink, one direction
    chips: int  # cards in the reference (single-pod) fleet


#: NVIDIA H100 SXM (data sheet, dense rates at the 700 W limit): 3.35 TB/s
#: of HBM3, 1,979 int8 TOP/s, 989 bf16 TFLOP/s, 132 SMs, and the 227 KB of
#: shared memory a block may opt in to (``kernels/qattention.py::SMEM_BYTES``
#: is that less the attention kernel's static part).  NVLink: the sheet's
#: 900 GB/s counts both directions; a collective's bytes arrive over one,
#: so the collective term reads 450 GB/s.  The fleet is the dry-run's
#: single-pod mesh, 16 × 16 = 256 cards (``launch/mesh.py``).  The cost
#: model reads it directly: the port runs on this one card.
H100_SXM = HardwareSpec(
    name="h100_sxm",
    peak_int8_ops=1979e12,
    hbm_bw=3.35e12,
    sms=132,
    smem_per_block=227 * 1024,
    peak_bf16_flops=989e12,
    link_bw=450e9,
    chips=256,
)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def roofline_terms(ops: float, nbytes: float, coll_bytes: float = 0.0, *,
                   hw: HardwareSpec = H100_SXM, peak: float = 0.0) -> Dict[str, float]:
    """The roofline terms of a launch or a step on one card (seconds):

        T_ops = ops / peak      T_mem = bytes / HBM bandwidth
        T_coll = collective bytes / NVLink bandwidth (one direction)

    ``peak`` defaults to the int8 tensor-core rate (the kernels' and the
    tile search's convention); pass ``hw.peak_bf16_flops`` for a bf16
    model step."""
    return {"t_ops_s": ops / (peak or hw.peak_int8_ops), "t_mem_s": nbytes / hw.hbm_bw,
            "t_coll_s": coll_bytes / hw.link_bw}


def roofline_fraction(model_flops: float, step_time_s: float, *, hw: HardwareSpec = H100_SXM) -> float:
    """Model-useful FLOP/s at ``step_time_s`` as a fraction of the fleet's
    bf16 peak (``hw.chips`` cards), as ``repro``'s roofline report divides;
    0 for a step time of 0."""
    if not step_time_s:
        return 0.0
    return (model_flops / step_time_s) / (hw.chips * hw.peak_bf16_flops)


def waves(blocks: int) -> int:
    """Waves of one block per SM a launch of ``blocks`` blocks takes."""
    return -(-max(int(blocks), 1) // H100_SXM.sms)


def wave_cost(ops: float, nbytes: float, blocks: int) -> float:
    """``max(T_ops, T_mem)`` of one of ``blocks`` equal blocks on one SM
    (its ``1/sms`` share of the card's rates), times :func:`waves`: a launch
    of few blocks leaves SMs idle, one a block past a full wave pays a
    whole wave more."""
    t = roofline_terms(ops, nbytes)
    per_block = max(t["t_ops_s"], t["t_mem_s"]) * H100_SXM.sms / max(int(blocks), 1)
    return per_block * waves(blocks)


# ---------------------------------------------------------------------------
# qmatmul (csrc/qmatmul.cu): (M / bm) × (Np / BN) tiles × splits blocks
# ---------------------------------------------------------------------------

def qmatmul_blocks(m: int, np_: int, bm: int, splits: int) -> int:
    """Blocks of one launch: output tiles times K splits."""
    return -(-max(int(m), 1) // bm) * (np_ // _qmm.BN) * splits


def qmatmul_hbm_bytes(
    m: int, k: int, n: int, kp: int, np_: int, bm: int, splits: int, *, weight_bits: int = 8
) -> float:
    """Device-memory traffic of one qmatmul launch as the kernel moves it:

    * x (``M × K`` int8, unpadded) is read once per column tile;
    * the ``(Np, Kp)`` weight is read once per row tile — nibbles at
      ``weight_bits=4``, half the bytes;
    * the bias and two scale rows (int32 + 2 × f32 per column) once per row
      tile, and the ``M × N`` output written once;
    * with ``splits > 1`` every split block writes its int32 partial tile
      to the workspace and the tile's last block reads them all back."""
    row_tiles = -(-max(int(m), 1) // bm)
    col_tiles = np_ // _qmm.BN
    x_bytes = m * k * col_tiles
    w_bytes = kp * np_ * row_tiles * weight_bits / 8.0
    epi_bytes = 12 * np_ * row_tiles
    out_bytes = m * n
    ws_bytes = 2 * 4 * splits * row_tiles * col_tiles * bm * _qmm.BN if splits > 1 else 0
    return float(x_bytes + w_bytes + epi_bytes + out_bytes + ws_bytes)


def qmatmul_smem_bytes(bm: int, *, weight_bits: int = 8) -> int:
    """Shared memory of the kernel's ``cp.async`` ring at row tile ``bm``:
    ``STAGES[bm]`` stages of a ``bm × BK`` x tile and a ``BN × BK`` weight
    tile (half the bytes when packed).  At most 32 KB, well inside
    :attr:`HardwareSpec.smem_per_block`, so no tiling is pruned for it."""
    return _qmm.STAGES[bm] * (bm * _qmm.BK + _qmm.BN * _qmm.BK * weight_bits // 8)


def qmatmul_tile_cost(
    m: int, k: int, n: int, kp: int, np_: int, bm: int, splits: int,
    *, weight_bits: int = 8,
) -> float:
    """Analytic cost (seconds) of a qmatmul launch at ``(bm, splits)``: the
    tensor cores compute whole ``bm``-row tiles, so the operations count
    the padded rows; the bytes are :func:`qmatmul_hbm_bytes`."""
    ops = 2.0 * _round_up(max(int(m), 1), bm) * kp * np_
    nbytes = qmatmul_hbm_bytes(m, k, n, kp, np_, bm, splits, weight_bits=weight_bits)
    return wave_cost(ops, nbytes, qmatmul_blocks(m, np_, bm, splits))

