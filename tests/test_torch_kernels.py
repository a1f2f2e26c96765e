"""The port's fused kernels against the JAX package's, on the CPU.

On CPU tensors each ``repro_torch`` kernel wrapper runs its plain PyTorch
version (the CUDA kernels themselves are held against those plain versions
on the card by ``chip_smoke.py``).  Here the plain versions must equal
``repro``'s oracles (``repro.kernels.ref``) and ``repro``'s Pallas kernels
run in interpret mode, on the same numpy-seeded inputs.  The conv route
(im2col, then the qmatmul plain path) must equal ``repro``'s fused conv for
int8 inputs and ``repro``'s ``ReferenceRuntime`` for uint8 inputs with pads.

Tolerance: 0.  Every path is integer arithmetic or an IEEE-exact float32
elementwise step in the codified order, so the results are bit-identical.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import quant as jquant
from repro.core.patterns import ATTN_BIG, ATTN_LUT_SCALE, ATTN_P_SCALE, build_exp_lut, conv_layer
from repro.core.pqir import GraphBuilder
from repro.core.runtime import ReferenceRuntime
from repro.kernels import ops as jops
from repro.kernels import pack as jpack
from repro.kernels import qact_lut as jqact
from repro.kernels import qattention as jqatt
from repro.kernels import ref as jref
from repro_torch.kernels import _build, launch_counts, ops, pack, qact_lut, qattention, qmatmul, ref

# (M, K, N, bits, relu, two_mul, out_dtype, per_channel): M off the 16/64 row
# tiles, K and N off the 64 tiles, both lanes, both output dtypes
MATMUL_CASES = [
    (5, 96, 70, 8, False, True, "int8", False),
    (33, 64, 130, 8, True, True, "uint8", True),
    (1, 128, 64, 8, True, False, "int8", True),
    (17, 96, 70, 4, False, True, "int8", True),
    (70, 192, 40, 4, True, False, "uint8", False),
    # K off the kernel's 4-byte words: the conv route's C·kH·kW widths
    (4, 10, 64, 8, False, True, "int8", True),
    (77, 27, 64, 4, True, True, "int8", False),
    (77, 147, 64, 8, True, False, "uint8", True),
    (4, 147, 64, 4, False, True, "int8", True),
]


def _matmul_inputs(m, k, n, bits, per_channel, seed):
    rng = np.random.default_rng(seed)
    lo, hi = (-8, 8) if bits == 4 else (-128, 128)
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(lo, hi, (k, n)).astype(np.int8)
    b = rng.integers(-5000, 5000, (n,)).astype(np.int32)
    if per_channel:
        qs = rng.integers(1 << 10, 1 << 20, (n,)).astype(np.float32)
        qsh = (2.0 ** -rng.integers(14, 24, (n,))).astype(np.float32)
    else:
        qs, qsh = np.float32(11610395.0), np.float32(2.0 ** -28)
    return x, w, b, qs, qsh


@pytest.mark.parametrize("m,k,n,bits,relu,two_mul,out,per_channel", MATMUL_CASES)
def test_qmatmul_plain_matches_repro(m, k, n, bits, relu, two_mul, out, per_channel):
    x, w, b, qs, qsh = _matmul_inputs(m, k, n, bits, per_channel, seed=m * 1000 + k + n)
    jdt = jnp.int8 if out == "int8" else jnp.uint8
    want_ref = np.asarray(jref.qmatmul_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(qs), jnp.asarray(qsh),
        out_dtype=jdt, relu=relu, two_mul=two_mul,
    ))
    jconsts, jshape = jops.specialize_qmatmul_params(w, b, qs, qsh, m=m, weight_bits=bits)
    want_pallas = np.asarray(jops.quantized_matmul_planned(
        jnp.asarray(x), *jconsts, jshape, out_dtype=jdt, relu=relu, two_mul=two_mul,
        interpret=True,
    ))
    np.testing.assert_array_equal(want_pallas, want_ref)

    tdt = torch.int8 if out == "int8" else torch.uint8
    consts, shape = ops.specialize_qmatmul_params(w, b, qs, qsh, m=m, weight_bits=bits)
    assert shape["layout"] == "nk" and consts[0].shape[0] == shape["np"]
    if bits == 4:
        assert consts[0].dtype == torch.uint8 and 2 * consts[0].shape[1] == shape["kp"]
    before = launch_counts()
    got = ops.quantized_matmul_planned(
        torch.from_numpy(x), *consts, shape, out_dtype=tdt, relu=relu, two_mul=two_mul
    )
    assert launch_counts() == before  # CPU tensors never launch a kernel
    np.testing.assert_array_equal(got.numpy(), want_ref)
    # the oracle itself, on unpadded parameters
    got_ref = ref.qmatmul_ref(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        torch.as_tensor(qs), torch.as_tensor(qsh), out_dtype=tdt, relu=relu, two_mul=two_mul,
    )
    np.testing.assert_array_equal(got_ref.numpy(), want_ref)


#: The tables a folded LUT brings into the matmul epilogue: int8 (Tanh),
#: uint8 (Sigmoid), and uint8 stored shifted to int8 (Sigmoid → FC).
LUT_KINDS = ["int8", "uint8", "uint8-128"]


@pytest.mark.parametrize("lut_kind", LUT_KINDS)
@pytest.mark.parametrize("m,k,n,bits,relu,two_mul,out,per_channel", MATMUL_CASES)
def test_qmatmul_table_epilogue_matches_repro(m, k, n, bits, relu, two_mul, out, per_channel,
                                               lut_kind):
    """The matmul with a table in its epilogue equals ``repro``'s Pallas
    qmatmul followed by its Pallas qact_lut (both in interpret mode); the
    shifted table equals that uint8 result minus 128.  A table indexes int8
    codes, so every case requantizes to int8 (``out`` is not used)."""
    x, w, b, qs, qsh = _matmul_inputs(m, k, n, bits, per_channel, seed=m * 1000 + k + n)
    rng = np.random.default_rng(m + k + n + len(lut_kind))
    dt = "int8" if lut_kind == "int8" else "uint8"
    info = np.iinfo(dt)
    table = rng.integers(info.min, info.max + 1, (256,)).astype(dt)
    jconsts, jshape = jops.specialize_qmatmul_params(w, b, qs, qsh, m=m, weight_bits=bits)
    pre = jops.quantized_matmul_planned(
        jnp.asarray(x), *jconsts, jshape, out_dtype=jnp.int8, relu=relu, two_mul=two_mul,
        interpret=True,
    )
    want = np.asarray(jqact.qact_lut(pre, jnp.asarray(table), block=512, interpret=True))
    if lut_kind == "uint8-128":
        want = (want.astype(np.int16) - 128).astype(np.int8)
        table = (table ^ 0x80).view(np.int8)

    consts, shape = ops.specialize_qmatmul_params(w, b, qs, qsh, m=m, weight_bits=bits)
    kern = qmatmul.qmatmul_packed if bits == 4 else qmatmul.qmatmul
    plain = qmatmul.qmatmul_packed_plain if bits == 4 else qmatmul.qmatmul_plain
    tx, tl = torch.from_numpy(x), torch.from_numpy(table)
    kw = dict(n=n, relu=relu, two_mul=two_mul, bm=shape["bm"], splits=shape["splits"], lut=tl)
    before = launch_counts()
    for got in (kern(tx, *consts, **kw), plain(tx, *consts, **kw),
                ops.quantized_matmul_planned(tx, *consts, shape, relu=relu, two_mul=two_mul,
                                             lut=tl)):
        assert got.dtype == tl.dtype and got.shape == (m, n)
        np.testing.assert_array_equal(got.numpy(), want)
    assert launch_counts() == before


@pytest.mark.parametrize("bad,match", [
    (lambda: torch.zeros(255, dtype=torch.int8), r"\(256,\) int8/uint8"),
    (lambda: torch.zeros(256, dtype=torch.int32), r"\(256,\) int8/uint8"),
    (lambda: torch.zeros(512, dtype=torch.uint8)[::2], "contiguous"),
    (lambda: torch.zeros(256, dtype=torch.int8, device="meta"), "x's device"),
    (lambda: torch.zeros(256, dtype=torch.uint8), "out_dtype must be int8"),
])
def test_qmatmul_refuses_tables_it_cannot_take(bad, match):
    """A table of the wrong shape, dtype, layout or device, or one asked to
    index uint8 codes, raises; the wrapper never drops it silently."""
    x, w, b, qs, qsh = _matmul_inputs(4, 64, 64, 8, False, seed=0)
    consts, shape = ops.specialize_qmatmul_params(w, b, qs, qsh, m=4)
    out = torch.uint8 if "out_dtype" in match else torch.int8
    for kern in (qmatmul.qmatmul, qmatmul.qmatmul_plain):
        with pytest.raises(ValueError, match=match):
            kern(torch.from_numpy(x), *consts, n=64, bm=16, out_dtype=out, lut=bad())
    with pytest.raises(ValueError, match=match):
        ops.quantized_matmul_planned(torch.from_numpy(x), *consts, shape, out_dtype=out,
                                     lut=bad())


def _attention_inputs(b, s, t, dh, seed, causal):
    rng = np.random.default_rng(seed)
    q = rng.integers(-128, 128, (b, s, dh)).astype(np.int8)
    k = rng.integers(-128, 128, (b, t, dh)).astype(np.int8)
    v = rng.integers(-128, 128, (b, t, dh)).astype(np.int8)
    if causal:
        mask = np.broadcast_to(np.tril(np.ones((s, t), np.float32), t - s), (b, s, t)).copy()
    else:  # decode rows: keys up to a per-row position are valid
        pos = rng.integers(0, t, (b,))
        mask = (np.arange(t)[None, None, :] <= pos[:, None, None]).astype(np.float32)
        mask = np.broadcast_to(mask, (b, s, t)).copy()
    return q, k, v, mask


# (B, S, T, dh, causal): decode with T not a multiple of 32, and a prefill cell
@pytest.mark.parametrize("b,s,t,dh,causal", [(3, 1, 37, 32, False), (2, 9, 9, 32, True)])
def test_qattention_plain_matches_repro(b, s, t, dh, causal):
    q, k, v, mask = _attention_inputs(b, s, t, dh, seed=b * 100 + t, causal=causal)
    lut = build_exp_lut()
    qk_scale = float(np.float32(0.05 * 0.05 / np.sqrt(dh)))
    rescale = float(np.float32(1.0 / ATTN_P_SCALE))
    want_ref = np.asarray(jref.qattention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        jnp.float32(qk_scale), jnp.float32(ATTN_BIG), jnp.float32(ATTN_LUT_SCALE),
        jnp.asarray(lut), jnp.float32(ATTN_P_SCALE), jnp.float32(rescale),
    ))
    want_pallas = np.asarray(jqatt.qattention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), jnp.asarray(lut),
        qk_scale=qk_scale, big=ATTN_BIG, lut_scale=ATTN_LUT_SCALE, p_scale=ATTN_P_SCALE,
        rescale=rescale, interpret=True,
    ))
    np.testing.assert_array_equal(want_pallas, want_ref)
    before = launch_counts()
    got = qattention.qattention(
        *(torch.from_numpy(a) for a in (q, k, v, mask, lut)),
        qk_scale=qk_scale, big=ATTN_BIG, lut_scale=ATTN_LUT_SCALE, p_scale=ATTN_P_SCALE,
        rescale=rescale,
    )
    assert launch_counts() == before
    np.testing.assert_array_equal(got.numpy(), want_ref)


@pytest.mark.parametrize("k,n", [(2, 1), (64, 70), (130, 3)])
def test_pack_int4_matches_repro(k, n):
    rng = np.random.default_rng(k * n)
    w = rng.integers(-8, 8, (k, n)).astype(np.int8)
    packed = pack.pack_int4(w)
    np.testing.assert_array_equal(packed, jpack.pack_int4(w))
    np.testing.assert_array_equal(pack.unpack_int4(packed), w)
    # the kernel's K-contiguous view of the same packing unpacks to w.T
    nk = torch.from_numpy(np.ascontiguousarray(packed.T))
    np.testing.assert_array_equal(qmatmul.unpack_int4_nk(nk).numpy(), w.T)


# a row, a ragged tile, a whole Pallas block, rank 3
LUT_SHAPES = [(1, 7), (37, 2051), (512, 64), (3, 5, 40)]


@pytest.mark.parametrize("lut_dtype", ["int8", "uint8"])
@pytest.mark.parametrize("shape", LUT_SHAPES)
def test_qact_lut_matches_repro(shape, lut_dtype):
    rng = np.random.default_rng(sum(shape) + len(lut_dtype))
    x = rng.integers(-128, 128, shape).astype(np.int8)
    info = np.iinfo(lut_dtype)
    lut = rng.integers(info.min, info.max + 1, (256,)).astype(lut_dtype)
    want = np.asarray(jref.qact_lut_ref(jnp.asarray(x), jnp.asarray(lut)))
    if len(shape) == 2:
        want_pallas = jqact.qact_lut(jnp.asarray(x), jnp.asarray(lut), block=512, interpret=True)
    else:  # repro's planned call flattens the leading dims for the kernel
        want_pallas = jops.quantized_activation(jnp.asarray(x), lut, backend="interpret")
    np.testing.assert_array_equal(np.asarray(want_pallas), want)
    tx, tl = torch.from_numpy(x), torch.from_numpy(lut)
    before = launch_counts()
    for got in (qact_lut.qact_lut(tx, tl), qact_lut.qact_lut_plain(tx, tl),
                ops.quantized_activation(tx, tl)):
        assert got.dtype == tl.dtype and got.shape == tx.shape
        np.testing.assert_array_equal(got.numpy(), want)
    assert launch_counts() == before


def test_qact_lut_takes_an_unaligned_slice():
    """A slice that starts one byte into a larger tensor is still a flat
    contiguous byte array: the kernel's head loop takes such a base."""
    rng = np.random.default_rng(9)
    big = torch.from_numpy(rng.integers(-128, 128, (4097,)).astype(np.int8))
    lut = torch.from_numpy(rng.integers(0, 256, (256,)).astype(np.uint8))
    x = big[1:]
    assert x.is_contiguous() and x.storage_offset() == 1
    np.testing.assert_array_equal(qact_lut.qact_lut(x, lut).numpy(),
                                  lut.numpy()[x.numpy().astype(np.int64) + 128])


def _conv_operands(rng, m, c, k, per_channel):
    w = rng.integers(-128, 128, (m, c, k, k)).astype(np.int8)
    b = rng.integers(-4000, 4000, (m,)).astype(np.int32)
    if per_channel:
        qs = rng.integers(1 << 10, 1 << 20, (m,)).astype(np.float32)
        qsh = (2.0 ** -rng.integers(18, 26, (m,))).astype(np.float32)
    else:
        qs, qsh = np.float32(3245.0), np.float32(2.0 ** -22)
    return w, b, qs, qsh


def _planned_conv(x, w, b, qs, qsh, strides, pads, out, relu, two_mul):
    consts, shape = ops.template_qconv_params(w, b, qs, qsh, strides=strides, pads=pads,
                                              x_uint8=x.dtype == np.uint8)
    oh, ow = ops.conv_out_hw(x.shape[2], x.shape[3], w.shape[2], w.shape[3], strides, pads)
    bound = ops.bind_qmatmul_axes({**shape, "lead": (x.shape[0], oh, ow)}, None)
    return ops.quantized_conv2d_planned(
        torch.from_numpy(x), *consts, bound, out_dtype=getattr(torch, out), relu=relu,
        two_mul=two_mul,
    ).numpy()


# (kernel, stride, pads, C, M, per_channel, relu, two_mul, out): C·kH·kW is
# never a multiple of 4 where C is odd
CONV_CASES = [
    (1, 1, (0, 0, 0, 0), 3, 8, False, False, True, "int8"),
    (3, 1, (1, 1, 1, 1), 3, 5, True, True, True, "int8"),
    (3, 2, (1, 1, 1, 1), 5, 16, True, False, False, "int8"),
    (7, 2, (3, 3, 3, 3), 3, 8, True, True, True, "uint8"),
    (3, 2, (0, 1, 1, 0), 3, 4, False, True, False, "int8"),
    (7, 1, (3, 3, 3, 3), 1, 4, True, False, True, "int8"),
]


@pytest.mark.parametrize("k,stride,pads,c,m,per_channel,relu,two_mul,out", CONV_CASES)
def test_conv_route_matches_repro(k, stride, pads, c, m, per_channel, relu, two_mul, out):
    rng = np.random.default_rng(k * 100 + c * 10 + m)
    x = rng.integers(-128, 128, (2, c, 11, 9)).astype(np.int8)
    w, b, qs, qsh = _conv_operands(rng, m, c, k, per_channel)
    want = np.asarray(jops.quantized_conv2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(qs), jnp.asarray(qsh),
        strides=(stride, stride), pads=pads, out_dtype=getattr(jnp, out), relu=relu,
        two_mul=two_mul,
    ))
    before = launch_counts()
    got = _planned_conv(x, w, b, qs, qsh, (stride, stride), pads, out, relu, two_mul)
    assert launch_counts() == before
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pads", [(1, 1, 1, 1), (3, 0, 2, 1)])
def test_uint8_padded_conv_matches_reference_runtime(pads):
    """A uint8 input pads with 0 in uint8 space (ONNX, zero point 0), so the
    shifted int8 input must pad with -128 for the plan-time 128·Σw fold to
    hold at the borders.  The oracle is ``ReferenceRuntime``, not
    ``repro``'s fused conv, which pads the shifted input with 0 (ROADMAP §C)."""
    rng = np.random.default_rng(sum(pads))
    x = rng.integers(0, 256, (2, 3, 6, 5)).astype(np.uint8)
    w, b, _, _ = _conv_operands(rng, 4, 3, 3, per_channel=True)
    rescale = jquant.decompose_multipliers(rng.uniform(1e-5, 1e-4, (4,)))
    qs, qsh = rescale.quant_scale.astype(np.float32), rescale.quant_shift
    gb = GraphBuilder("conv_u8")
    gb.add_input("x", "uint8", (None, 3, 6, 5))
    y = conv_layer(gb, "x", w, b, rescale, "c0", pads=pads, two_mul=True)
    oh, ow = ops.conv_out_hw(6, 5, 3, 3, (1, 1), pads)
    gb.add_output(y, "int8", (None, 4, oh, ow))
    want = next(iter(ReferenceRuntime(gb.build(opset=17)).run({"x": x}).values()))
    got = _planned_conv(x, w, b, qs, qsh, (1, 1), pads, "int8", False, True)
    np.testing.assert_array_equal(got, want)


def test_im2col_layout():
    """Rows in (n, oh, ow) order, columns in (c, kh, kw) order, the border
    reading the pad value."""
    x = torch.arange(2 * 2 * 3 * 3, dtype=torch.int8).reshape(2, 2, 3, 3)
    cols = ops.im2col(x, 2, 2, (1, 1), (1, 0, 0, 1), pad_value=-5)
    assert cols.shape == (2 * 3 * 3, 2 * 2 * 2) and cols.is_contiguous()
    xp = torch.nn.functional.pad(x, (0, 1, 1, 0), value=-5)
    n, oh, ow = 1, 2, 0
    want = xp[n, :, oh:oh + 2, ow:ow + 2].reshape(-1)
    assert torch.equal(cols[n * 9 + oh * 3 + ow], want)


def test_wrappers_refuse_devices_they_cannot_serve():
    """Off the CPU a wrapper launches its kernel or raises: it never takes the
    plain version (a meta tensor stands in for an unsupported device)."""
    x, w, b, qs, qsh = _matmul_inputs(4, 64, 64, 8, False, seed=0)
    consts, shape = ops.specialize_qmatmul_params(w, b, qs, qsh, m=4, device="meta")
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        qmatmul.qmatmul(torch.from_numpy(x).to("meta"), *consts, n=64, bm=16)
    q = torch.zeros((1, 1, 32), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        qattention.qattention(
            q, q, q, torch.zeros((1, 1, 1), device="meta"), torch.zeros(256, dtype=torch.uint8),
            qk_scale=1.0, big=1.0, lut_scale=1.0, p_scale=1.0, rescale=1.0,
        )
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        qact_lut.qact_lut(q, torch.zeros(256, dtype=torch.int8, device="meta"))


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build(["qmatmul"])
    assert not list(tmp_path.iterdir())  # no partial library left behind


def test_library_named_by_source_hash():
    a, b = _build.library_path("qmatmul"), _build.library_path("qattention")
    assert a.parent == _build.BUILD_DIR and a.suffix == ".so" and a != b
    assert set(_build.STEMS) == {"qmatmul", "qattention", "qact_lut", "qmoe", "kv_write"}
    assert a == _build.library_path("qmatmul")


def test_tile_records_follow_the_kernel():
    """Row tiles are the kernel's instantiations; K/N tiles are its fixed
    stage and column widths, and the parameters pad to them once."""
    _, shape = ops.template_qmatmul_params(np.zeros((100, 70), np.int8), None, 1.0, 1.0)
    assert (shape["kp"], shape["np"], shape["bk"], shape["bn"]) == (128, 128, 64, 64)
    assert [ops.bind_qmatmul_axes({**shape, "lead": ("N", 3)}, {"N": n})["bm"]
            for n in (1, 5, 6)] == [16, 16, 64]
    bound = ops.bind_qmatmul_axes({**shape, "lead": (4,)}, None)
    assert ops.with_tiles(bound, bm=64)["bm"] == 64
    for bad in (dict(bm=32), dict(bk=128), dict(bn=32)):
        with pytest.raises(ValueError):
            ops.with_tiles(bound, **bad)


def test_library_name_follows_headers(monkeypatch, tmp_path):
    """A library is named by its source and every shared header: an edit to
    a ``csrc/*.cuh`` the source includes builds a new library."""
    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    headers = sorted(tmp_path.glob("*.cuh"))
    assert headers and b'#include "ptx.cuh"' in (tmp_path / "qmatmul.cu").read_bytes()
    before = _build.library_path("qmatmul")
    headers[0].write_bytes(headers[0].read_bytes() + b"\n// edited\n")
    after = _build.library_path("qmatmul")
    assert after != before and after.parent == before.parent
    (tmp_path / "qmatmul.cu").write_bytes((tmp_path / "qmatmul.cu").read_bytes() + b"\n")
    assert _build.library_path("qmatmul") not in (before, after)


# Every main-path qmatmul shape (M, K, N): the token path's decode (4 slots)
# and prefill (4 x 128) projections, slice A's layers at batch 64, slice B's
# conv GEMMs (M = 16·OH·OW, K = C·kH·kW) and FC head at batch 16
MAIN_PATH_GEMMS = [
    (4, 2048, 6144), (4, 2048, 2048), (4, 6144, 2048),
    (512, 2048, 6144), (512, 2048, 2048), (512, 6144, 2048),
    (64, 2048, 6144), (64, 6144, 6144), (64, 6144, 2048),
    (200704, 147, 64), (50176, 576, 128), (12544, 1152, 256), (3136, 2304, 512),
    (784, 4608, 512), (16, 25088, 1000),
]


@pytest.mark.parametrize("m,k,n", MAIN_PATH_GEMMS)
def test_split_planner_fills_the_card(m, k, n):
    """Output tiles × splits reach about two blocks per SM where K has the
    stages for it; 1 split where the tiles alone fill the card; the splits
    cover [0, Kp) exactly once, in whole K stages."""
    _, shape = ops.template_qmatmul_params(np.zeros((k, n), np.int8), None, 1.0, 1.0)
    bound = ops.bind_qmatmul_axes({**shape, "lead": (m,)}, None)
    bm, splits, kp = bound["bm"], bound["splits"], bound["kp"]
    assert splits == qmatmul.choose_splits(m, kp, bound["np"], bm)
    tiles = -(-m // bm) * (bound["np"] // qmatmul.BN)
    stages = kp // qmatmul.BK
    if tiles >= qmatmul.NUM_SMS:
        assert splits == 1
    else:
        assert 1 < splits <= stages
        assert tiles * splits >= min(2 * qmatmul.NUM_SMS, tiles * stages)
        assert tiles * (splits - 1) < 2 * qmatmul.NUM_SMS  # no more splits than that needs
    ranges = qmatmul.split_ranges(kp, splits)
    assert len(ranges) == splits and ranges[0][0] == 0 and ranges[-1][1] == kp
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(k0 % qmatmul.BK == 0 and k1 > k0 for k0, k1 in ranges)


def test_split_planner_edges():
    """Unknown M plans one split; a decode GEMM whose K holds fewer stages
    than the card wants takes one split per stage."""
    assert qmatmul.choose_splits(None, 2048, 2048, 64) == 1
    assert qmatmul.choose_splits(4, 128, 64, 16) == 2  # 1 tile, 2 stages
    assert qmatmul.choose_splits(4, 64, 64, 16) == 1
    with pytest.raises(ValueError):
        qmatmul.split_ranges(128, 3)
    with pytest.raises(ValueError):
        qmatmul.split_ranges(100, 1)


def _epilogue_np(acc, b, qs, qsh, relu, two_mul, out):
    """The fused epilogue on an int32 sum, in numpy: the wrapping int32 bias
    add, float32 products (IEEE round to nearest), ReLU, round half to even,
    clip."""
    a = (acc.view(np.uint32) + np.asarray(b, np.int32).view(np.uint32)).view(np.int32)
    f = a.astype(np.float32) * np.asarray(qs, np.float32)
    if two_mul:
        f = f * np.asarray(qsh, np.float32)
    if relu:
        f = np.maximum(f, np.float32(0))
    info = np.iinfo(out)
    return np.clip(np.rint(f), info.min, info.max).astype(out)


# (M, K, N, bits, relu, two_mul, out, per_channel): small shapes the
# planner splits, both lanes, both output dtypes, K off the stages
SPLIT_CASES = [
    (5, 640, 70, 8, False, True, "int8", True),
    (3, 200, 64, 8, True, False, "uint8", False),
    (17, 384, 130, 4, False, True, "int8", True),
    (70, 1024, 40, 4, True, True, "uint8", False),
    (16, 2000, 100, 8, False, True, "int8", False),
]


@pytest.mark.parametrize("m,k,n,bits,relu,two_mul,out,per_channel", SPLIT_CASES)
def test_split_partition_is_exact(m, k, n, bits, relu, two_mul, out, per_channel):
    """int32 partial sums over the planner's K ranges, added in any order
    and passed through the epilogue once, equal repro's qmatmul /
    qmatmul_packed (Pallas, interpret mode) and its oracle."""
    x, w, b, qs, qsh = _matmul_inputs(m, k, n, bits, per_channel, seed=m * 31 + k + n)
    jdt = jnp.int8 if out == "int8" else jnp.uint8
    want_ref = np.asarray(jref.qmatmul_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(qs), jnp.asarray(qsh),
        out_dtype=jdt, relu=relu, two_mul=two_mul,
    ))
    jconsts, jshape = jops.specialize_qmatmul_params(w, b, qs, qsh, m=m, weight_bits=bits)
    want_pallas = np.asarray(jops.quantized_matmul_planned(
        jnp.asarray(x), *jconsts, jshape, out_dtype=jdt, relu=relu, two_mul=two_mul,
        interpret=True,
    ))
    np.testing.assert_array_equal(want_pallas, want_ref)

    consts, shape = ops.specialize_qmatmul_params(w, b, qs, qsh, m=m, weight_bits=bits)
    splits, kp = shape["splits"], shape["kp"]
    assert splits > 1
    w_nk = consts[0] if bits == 8 else qmatmul.unpack_int4_nk(consts[0])
    w_nk = w_nk.numpy().astype(np.int32)  # (Np, Kp), zero past K
    xp = np.zeros((m, kp), np.int32)
    xp[:, :k] = x
    parts = [xp[:, k0:k1] @ w_nk[:n, k0:k1].T for k0, k1 in qmatmul.split_ranges(kp, splits)]
    order = np.random.default_rng(m + n).permutation(splits)
    acc = np.zeros((m, n), np.int32)
    for z in order:
        acc = (acc.view(np.uint32) + parts[z].astype(np.int32).view(np.uint32)).view(np.int32)
    got = _epilogue_np(acc, b, qs, qsh, relu, two_mul, np.dtype(out))
    np.testing.assert_array_equal(got, want_ref)
    # the planned call on the CPU takes the same record to the plain version
    tdt = torch.int8 if out == "int8" else torch.uint8
    planned = ops.quantized_matmul_planned(torch.from_numpy(x), *consts, shape, out_dtype=tdt,
                                           relu=relu, two_mul=two_mul)
    np.testing.assert_array_equal(planned.numpy(), want_ref)


def test_with_tiles_refuses_illegal_splits():
    """Each split holds whole K stages: 1 <= splits <= Kp / BK, an int."""
    _, shape = ops.template_qmatmul_params(np.zeros((300, 70), np.int8), None, 1.0, 1.0)
    bound = ops.bind_qmatmul_axes({**shape, "lead": (4,)}, None)
    assert (bound["kp"], bound["bm"], bound["splits"]) == (320, 16, 5)
    assert ops.with_tiles(bound, splits=1)["splits"] == 1
    assert ops.with_tiles(bound, splits=5)["splits"] == 5
    for bad in (0, 6, -1, 2.0, True, "2"):
        with pytest.raises(ValueError, match="splits"):
            ops.with_tiles(bound, splits=bad)
    assert ops.with_tiles(bound, bm=64, splits=2) == {**bound, "bm": 64, "splits": 2}


def test_route_follows_k_and_alignment():
    """x goes by 16-byte copies when K % 16 == 0 and x is 16-byte aligned,
    else by bytes the threads stage; the record gives bm and splits."""
    big = torch.zeros(4 * 2048 + 16, dtype=torch.int8)
    assert big.data_ptr() % 16 == 0
    aligned, shifted = big[:4 * 2048].view(4, 2048), big[1:1 + 4 * 2048].view(4, 2048)
    r = qmatmul.route(aligned, 16, 9)
    assert r == {"instruction": qmatmul.INSTRUCTION, "bm": 16, "bn": 64, "splits": 9,
                 "stages": qmatmul.STAGES[16], "staging": "cp.async16"}
    assert qmatmul.route(shifted, 16, 9)["staging"] == "bytes"
    assert qmatmul.route(torch.zeros((77, 147), dtype=torch.int8), 64, 1)["staging"] == "bytes"


def test_plan_printout_shows_splits():
    """A specialized qmatmul step renders its K splits, in the plan and in
    the provenance's tile record."""
    from repro_torch.core.compile import compile_model
    from repro_torch.core.toolchain import MLPSpec, quantize_mlp

    rng = np.random.default_rng(3)
    spec = MLPSpec(weights=[rng.normal(size=(640, 96)).astype(np.float32),
                            rng.normal(size=(96, 10)).astype(np.float32)],
                   biases=[np.zeros(96, np.float32), np.zeros(10, np.float32)],
                   activations=["Relu", None])
    model = quantize_mlp(spec, rng.normal(size=(64, 640)).astype(np.float32), name="split_mlp")
    cm = compile_model(model, backend="cuda", device="cpu", batch="dynamic")
    plan, _ = cm.specialized(4)
    steps = [s for s in plan.steps if s.kernel == "qlinear_matmul"]
    assert [s.params["shape"]["splits"] for s in steps] == [10, 2]
    text = plan.pretty()
    assert "splits=10" in text and "splits=2" in text
    assert "m=4,bm=16,bk=64,bn=64,splits=10" in plan.pretty(verbose=True)


# ---------------------------------------------------------------------------
# qattention: the cluster decomposition, the cluster planner, strided views
# ---------------------------------------------------------------------------

_ATTN_SCALARS = dict(qk_scale=float(np.float32(0.05 * 0.05 / np.sqrt(32))), big=ATTN_BIG,
                     lut_scale=ATTN_LUT_SCALE, p_scale=ATTN_P_SCALE,
                     rescale=float(np.float32(1.0 / ATTN_P_SCALE)))
# (B, S, T, dh, causal): decode rows with T off and on every cluster size,
# and a causal prefill cell with T off them
CLUSTER_CELLS = [(4, 1, 37, 32, False), (4, 1, 512, 32, False), (2, 24, 37, 32, True)]
_REPRO_ATTN = {}


def _repro_attention(cell):
    """repro's Pallas kernel (interpret mode) and oracle on the cell's inputs;
    they must agree, and the result is computed once per cell."""
    if cell not in _REPRO_ATTN:
        b, s, t, dh, causal = cell
        q, k, v, mask = _attention_inputs(b, s, t, dh, seed=b * 7 + s + t, causal=causal)
        sc = _ATTN_SCALARS
        want_ref = np.asarray(jref.qattention_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
            jnp.float32(sc["qk_scale"]), jnp.float32(sc["big"]), jnp.float32(sc["lut_scale"]),
            jnp.asarray(build_exp_lut()), jnp.float32(sc["p_scale"]), jnp.float32(sc["rescale"]),
        ))
        want_pallas = np.asarray(jqatt.qattention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
            jnp.asarray(build_exp_lut()), interpret=True, **sc,
        ))
        np.testing.assert_array_equal(want_pallas, want_ref)
        _REPRO_ATTN[cell] = ((q, k, v, mask), want_ref)
    return _REPRO_ATTN[cell]


def _cluster_mirror(q, k, v, mask, lut, cluster, rng, *, qk_scale, big, lut_scale, p_scale,
                    rescale):
    """The kernel's cluster decomposition in numpy: block rank r takes keys
    ``key_ranges(T, C)[r]`` and forms its masked scores and local max; the
    row max is the max of the C local maxima, the den the int32 sum of the C
    local dens, the context the int32 sum of the C partial contexts — each
    combined in a random order — and the epilogue runs once per dim."""
    f32 = np.float32
    qk_scale, big, lut_scale, p_scale, rescale = (
        f32(x) for x in (qk_scale, big, lut_scale, p_scale, rescale))
    b, s, dh = q.shape
    ranges = qattention.key_ranges(k.shape[1], cluster)
    out = np.empty((b, s, dh), np.int8)
    for bi in range(b):
        for si in range(s):
            masked = []
            for k0, k1 in ranges:
                acc = k[bi, k0:k1].astype(np.int32) @ q[bi, si].astype(np.int32)
                m = mask[bi, si, k0:k1]
                masked.append(acc.astype(f32) * qk_scale * m + (m - f32(1)) * big)
            mx = f32(-np.inf)
            for r in rng.permutation(cluster):
                mx = np.fmax(mx, masked[r].max())
            w = [lut[(np.clip(np.rint((sc - mx) / lut_scale), -128, 127) + 128).astype(np.int64)]
                 .astype(np.int32) for sc in masked]
            den = np.int32(0)
            for r in rng.permutation(cluster):
                den = den + w[r].sum(dtype=np.int32)
            ctx = np.zeros(dh, np.int32)
            for r in rng.permutation(cluster):
                p_q = np.clip(np.rint(w[r].astype(f32) / f32(den) * p_scale), -128, 127)
                k0, k1 = ranges[r]
                ctx = ctx + p_q.astype(np.int32) @ v[bi, k0:k1].astype(np.int32)
            out[bi, si] = np.clip(np.rint(ctx.astype(f32) * rescale), -128, 127)
    return out


@pytest.mark.parametrize("cluster", [2, 8, 16])
@pytest.mark.parametrize("cell", CLUSTER_CELLS)
def test_cluster_partition_is_exact(cell, cluster):
    """Local maxima, local dens and int32 partial contexts over the kernel's
    key ranges, combined in any order, give repro's qattention (Pallas,
    interpret mode) and its oracle bit for bit — at every cluster size,
    with T a multiple of C or not."""
    (q, k, v, mask), want = _repro_attention(cell)
    ranges = qattention.key_ranges(k.shape[1], cluster)
    assert ranges[0][0] == 0 and ranges[-1][1] == k.shape[1]
    assert all(a[1] == b[0] and b[1] > b[0] for a, b in zip(ranges, ranges[1:]))
    rng = np.random.default_rng(cluster)
    got = _cluster_mirror(q, k, v, mask, build_exp_lut(), cluster, rng, **_ATTN_SCALARS)
    np.testing.assert_array_equal(got, want)
    # the wrapper on CPU tensors takes the same cluster size to the plain version
    planned = qattention.qattention(*(torch.from_numpy(a) for a in (q, k, v, mask, build_exp_lut())),
                                    cluster=cluster, **_ATTN_SCALARS)
    np.testing.assert_array_equal(planned.numpy(), want)


def test_cluster_planner_at_token_path_shapes():
    """Decode at (4 slots, T = 512) splits each row over 16 blocks of 512
    threads (2 keys a warp); prefill at (4, 128) has 512 rows, which fill
    the card alone: one block per row, sized so all fit at once."""
    assert qattention.choose_cluster(4, 512, 128) == 16
    assert qattention.threads_for(4, 512, 16) == 512
    assert qattention.choose_cluster(4 * 128, 128, 128) == 1
    assert qattention.threads_for(4 * 128, 128, 1) == 512
    assert qattention.choose_cluster(4, 77, 128) == 16  # decode on a short cache
    rec = ops.bind_qattention_axes({"b": ("N",), "s": 1, "t": "S", "dh": 128}, {"N": 4, "S": 512})
    assert rec == {"b": 4, "s": 1, "t": 512, "dh": 128, "cluster": 16}
    rec = ops.bind_qattention_axes({"b": ("N",), "s": "S", "t": "S", "dh": 128}, {"N": 4, "S": 128})
    assert rec["cluster"] == 1
    open_rec = ops.bind_qattention_axes({"b": ("N",), "s": 1, "t": "S", "dh": 128}, {"S": 512},
                                        partial=True)
    assert "cluster" not in open_rec  # planned only once every axis is bound


def test_cluster_planner_edges():
    """Each block keeps at least MIN_KEYS keys; rows >= NUM_SMS take one
    block each; a row longer than one block's shared memory takes the
    smallest cluster that holds it, and one no cluster holds is refused."""
    mk = qattention.MIN_KEYS
    assert qattention.choose_cluster(4, 2 * mk - 1, 128) == 1
    assert qattention.choose_cluster(4, 2 * mk, 128) == 2
    assert qattention.choose_cluster(4, 16 * mk, 128) == 16
    assert qattention.choose_cluster(qattention.NUM_SMS, 4096, 128) == 1
    assert qattention.choose_cluster(qattention.NUM_SMS // 2, 4096, 128) == 2
    assert qattention.choose_cluster(1, 1, 128) == 1
    one = qattention.max_keys(128, 1)
    assert qattention.choose_cluster(qattention.NUM_SMS, one + 1, 128) == 2
    assert qattention.max_keys(128, 16) > 16 * (one - 128)
    with pytest.raises(ValueError, match="no cluster size"):
        qattention.choose_cluster(4, qattention.max_keys(128, 16) + 1, 128)
    # threads: a warp per two keys, within [MIN_WARPS, MAX_WARPS] warps and
    # one resident wave of blocks
    assert qattention.threads_for(4, 77, 16) == 32 * qattention.MIN_WARPS
    assert qattention.threads_for(4 * 1024, 1024, 1) == 32 * qattention.MIN_WARPS
    assert qattention.threads_for(198, 128, 2) == 32 * 10  # 396 blocks: 3 an SM


def test_with_cluster_refuses_illegal_sizes():
    """A cluster size is one of CLUSTER_SIZES, at most T, and holds the row;
    the plan's override and the wrapper refuse anything else."""
    rec = ops.bind_qattention_axes({"b": (4,), "s": 1, "t": 37, "dh": 32}, None)
    assert rec["cluster"] == 8
    for c in qattention.CLUSTER_SIZES:
        assert ops.with_cluster(rec, c) == {**rec, "cluster": c}
    for bad in (0, 3, 32, -2, True, 2.0, "2", None):
        with pytest.raises(ValueError, match="cluster"):
            ops.with_cluster(rec, bad)
    short = {**rec, "t": 7}
    with pytest.raises(ValueError, match="cluster=8"):
        ops.with_cluster(short, 8)
    q, k, v, mask = (torch.from_numpy(a) for a in _attention_inputs(1, 1, 7, 32, 0, False))
    with pytest.raises(ValueError, match="cluster"):
        qattention.qattention(q, k, v, mask, torch.from_numpy(build_exp_lut()), cluster=8,
                              **_ATTN_SCALARS)


def test_wrapper_takes_views_and_names_what_it_refuses():
    """accepts_view: a 3-D view with a contiguous last dim, 4-byte base and
    strides (a broadcast mask's batch stride 0 included); anything else is
    refused, and the fused step would copy only that."""
    buf = torch.zeros((4, 9, 3 * 64), dtype=torch.int8)
    assert qattention.accepts_view(buf[:, :, 64 + 32:64 + 64])
    assert qattention.accepts_view(torch.ones((1, 9, 9)).expand(4, 9, 9))
    assert not qattention.accepts_view(buf[:, :, 1:33])  # base off a 4-byte boundary
    assert not qattention.accepts_view(buf[:, :, ::2])  # last dim strided
    odd = torch.zeros((4, 9, 65), dtype=torch.int8)[:, :, :64]
    assert not qattention.accepts_view(odd)  # row stride 65 bytes
    assert qattention.accepts_view(odd[:1, :1])  # ...which a lone row never steps
    assert not qattention.accepts_view(buf[0])
