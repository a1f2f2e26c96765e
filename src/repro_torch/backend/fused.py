"""Fused-kernel implementations for the backend registry.

* ``qlinear_matmul`` — the MatMulInteger→…→QuantizeLinear chain.  ``ref``
  runs the plain oracle on the *unpadded, unpacked* parameters; ``cuda``
  runs the hand-written kernel (:mod:`repro_torch.kernels.qmatmul`) on the
  parameters the template already padded, laid out and (for 4-bit weights)
  packed on the device, so nothing but the activation layout is touched per
  call.
* ``qattention`` — the fused int8 attention region.  ``ref`` runs the plain
  oracle; ``cuda`` runs :mod:`repro_torch.kernels.qattention` on the
  per-head views as they are, split over the record's ``cluster``.  Scalar
  constants ride in ``step.params``; the exp LUT is the one const tensor.
* ``qact_lut`` — the exact 256-entry activation table.  ``ref`` runs the
  plain gather; ``cuda`` runs :mod:`repro_torch.kernels.qact_lut`.  On
  ``cuda`` a LUT rides in the matmul epilogue instead wherever its input is
  the output of a ``qlinear_matmul`` step that nothing else reads and that is
  neither a graph output nor a state: the plan folds the LUT step into that
  step, whose fifth const is then the table and ``params["lut"]`` names it
  (``Compiler._fold_lut_epilogues``).  A uint8 table whose output only
  ``x_uint8`` matmuls read is stored shifted (``u - 128`` as int8), and
  those readers launch no shift.
* ``qmoe`` — the routed-expert region (:mod:`repro_torch.core.moe`).
  ``ref`` runs the plain version, ``cuda`` the five kernels of
  :mod:`repro_torch.kernels.qmoe`, both on the weights the template laid
  out; only the chosen experts of each token are computed.
* ``qlinear_conv2d`` — the fused int8 convolution.  ``ref`` runs the plain
  oracle (an exact float64 ``F.conv2d``) on unpadded parameters; ``cuda``
  runs im2col and then the qmatmul kernel with its epilogue, on the
  template's K-contiguous ``(Np, C·kH·kW → Kp)`` weight.

On a CPU tensor every ``cuda`` kernel wrapper runs its plain version — that
is how the CPU tests exercise the planned path; on a CUDA tensor it launches
the kernel or raises.

Step contract (see :mod:`repro_torch.backend.plan`): ``args = [x]`` (or
``[q, k, v, mask]``), parameters in ``step.consts``, static config in
``step.params``.  ``params["x_uint8"]`` marks a uint8 activation whose +128
offset the plan already folded into the bias.
"""
from __future__ import annotations

from ..kernels import ops as kops
from ..kernels import qattention as _qatt
from ..kernels import qmoe as _qmoe
from ..kernels import ref as _ref
from .generic import TORCH_DTYPES
from .registry import register


def _as_signed(x, params):
    """uint8 activation → signed int8 (bias correction already folded)."""
    return kops.shift_uint8(x) if params.get("x_uint8") else x


def _unbound(kind: str):
    return RuntimeError(
        f"axis-open {kind} template cannot execute directly: bind it to a bucket "
        "first (repro_torch.backend.lowering.specialize_plan, or run through "
        "CompiledModel which caches specializations per bucket)"
    )


@register("qlinear_matmul", backend="ref")
def _qlinear_matmul_ref(step, args):
    x = _as_signed(args[0], step.params)
    w, b, qs, qsh = step.consts
    p = step.params
    return [_ref.qmatmul_ref(
        x, w, b, qs, qsh,
        out_dtype=TORCH_DTYPES[p["out_dtype"]], relu=p["relu"], two_mul=p["two_mul"],
    )]


@register("qlinear_matmul", backend="cuda")
def _qlinear_matmul_cuda(step, args):
    p = step.params
    if p.get("dynamic_batch"):
        raise _unbound("matmul")
    x = _as_signed(args[0], p).contiguous()
    w2, b2, qs2, qsh2, *lut = step.consts  # a folded activation table rides fifth
    if len(lut) > 1:
        raise ValueError(f"qlinear_matmul step with {len(step.consts)} consts: an epilogue "
                         "applies one table at most")
    return [kops.quantized_matmul_planned(
        x, w2, b2, qs2, qsh2, p["shape"],
        out_dtype=TORCH_DTYPES[p["out_dtype"]], relu=p["relu"], two_mul=p["two_mul"],
        lut=lut[0] if lut else None,
    )]


def _attn_scalars(p):
    return dict(
        qk_scale=p["qk_scale"], big=p["big"], lut_scale=p["lut_scale"],
        p_scale=p["p_scale"], rescale=p["rescale"],
    )


@register("qattention", backend="ref")
def _qattention_ref(step, args):
    q, k, v, mask = args
    (lut,) = step.consts
    p = step.params
    s = _attn_scalars(p)
    return [_ref.qattention_ref(
        q, k, v, mask, s["qk_scale"], s["big"], s["lut_scale"], lut,
        s["p_scale"], s["rescale"], out_dtype=TORCH_DTYPES[p["out_dtype"]],
    )]


@register("qattention", backend="cuda")
def _qattention_cuda(step, args):
    p = step.params
    if p.get("dynamic_attn"):
        raise _unbound("attention")
    # The per-head q/k/v are strided views of the qkv projection and of the
    # KV cache (Slice along the feature axis); the kernel takes them as they
    # are, and only an operand it refuses is copied.
    q, k, v, mask = (a if _qatt.accepts_view(a) else a.contiguous() for a in args)
    (lut,) = step.consts
    return [_qatt.qattention(
        q, k, v, mask, lut, out_dtype=TORCH_DTYPES[p["out_dtype"]],
        cluster=p["shape"]["cluster"], **_attn_scalars(p)
    )]


@register("qact_lut", backend="ref")
def _qact_lut_ref(step, args):
    (lut,) = step.consts
    return [_ref.qact_lut_ref(args[0], lut)]


@register("qact_lut", backend="cuda")
def _qact_lut_cuda(step, args):
    (lut,) = step.consts
    return [kops.quantized_activation(args[0], lut)]


@register("qlinear_conv2d", backend="ref")
def _qlinear_conv2d_ref(step, args):
    w, b, qs, qsh = step.consts
    p = step.params
    return [_ref.qconv2d_ref(
        args[0], w, b, qs, qsh, strides=p["strides"], pads=p["pads"],
        out_dtype=TORCH_DTYPES[p["out_dtype"]], relu=p["relu"], two_mul=p["two_mul"],
    )]


@register("qlinear_conv2d", backend="cuda")
def _qlinear_conv2d_cuda(step, args):
    p = step.params
    if p.get("dynamic_batch"):
        raise _unbound("conv")
    w2, b2, qs2, qsh2 = step.consts
    return [kops.quantized_conv2d_planned(
        args[0], w2, b2, qs2, qsh2, p["shape"],
        out_dtype=TORCH_DTYPES[p["out_dtype"]], relu=p["relu"], two_mul=p["two_mul"],
    )]


def _qmoe_step(step, args, run):
    wr, gu, wd, lut, silu = step.consts
    return [run(args[0], wr, gu, wd, lut, silu, _qmoe.MoEScalars(**step.params["moe"]))]


@register("qmoe", backend="ref")
def _qmoe_ref(step, args):
    return _qmoe_step(step, args, _qmoe.qmoe_plain)


@register("qmoe", backend="cuda")
def _qmoe_cuda(step, args):
    return _qmoe_step(step, args, _qmoe.qmoe)
