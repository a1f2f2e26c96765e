"""The port's fused kernels against the JAX package's, on the CPU.

On CPU tensors each ``repro_torch`` kernel wrapper runs its plain PyTorch
version (the CUDA kernels themselves are held against those plain versions
on the card by ``chip_smoke.py``).  Here the plain versions must equal
``repro``'s oracles (``repro.kernels.ref``) and ``repro``'s Pallas kernels
run in interpret mode, on the same numpy-seeded inputs.

Tolerance: 0.  Every path is integer arithmetic or an IEEE-exact float32
elementwise step in the codified order, so the results are bit-identical.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.patterns import ATTN_BIG, ATTN_LUT_SCALE, ATTN_P_SCALE, build_exp_lut
from repro.kernels import ops as jops
from repro.kernels import pack as jpack
from repro.kernels import qattention as jqatt
from repro.kernels import ref as jref
from repro_torch.kernels import _build, launch_counts, ops, pack, qattention, qmatmul, ref

# (M, K, N, bits, relu, two_mul, out_dtype, per_channel): M off the 16/64 row
# tiles, K and N off the 64 tiles, both lanes, both output dtypes
MATMUL_CASES = [
    (5, 96, 70, 8, False, True, "int8", False),
    (33, 64, 130, 8, True, True, "uint8", True),
    (1, 128, 64, 8, True, False, "int8", True),
    (17, 96, 70, 4, False, True, "int8", True),
    (70, 192, 40, 4, True, False, "uint8", False),
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


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build(["qmatmul"])
    assert not list(tmp_path.iterdir())  # no partial library left behind


def test_library_named_by_source_hash():
    a, b = _build.library_path("qmatmul"), _build.library_path("qattention")
    assert a.parent == _build.BUILD_DIR and a.suffix == ".so" and a != b
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
