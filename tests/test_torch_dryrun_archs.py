"""The port's dry-run on architectures other than ``qwen3_1_7b``, single-pod
mesh, checked as ``test_torch_dryrun.py`` checks its cells (whose helpers
it uses; one attention chunk per sequence):

* ``qwen2_moe_a2_7b`` at ``train_4k`` comes out ``ok`` (the MoE dispatch
  and its backward on the mesh);
* the decode cells of ``minicpm3_4b`` (40 MLA heads) and ``rwkv6_3b`` (40
  heads, five interpolation targets) come out ``ok``: DTensor refuses their
  head splits on a 16-way model axis until the model gathers them
  (``sharding.split_last``).

Each cell's per-rank argument bytes equal those worked out from
``repro``'s specs and ``spec_for``.
"""
import pytest

from test_torch_dryrun import POD1, _one_torch_thread, repro_argument_bytes, run_cell  # noqa: F401  (fixture)


def test_qwen2_moe_train_cell():
    r = run_cell("qwen2_moe_a2_7b", "train_4k", multi_pod=False)
    assert r["status"] == "ok", r.get("error", "") + r.get("trace", "")
    assert r["memory"]["argument_bytes"] == repro_argument_bytes("qwen2_moe_a2_7b", "train_4k", POD1)


@pytest.mark.parametrize("arch", ["minicpm3_4b", "rwkv6_3b"])
def test_heads_that_do_not_divide_the_model_axis(arch):
    r = run_cell(arch, "decode_32k", multi_pod=False)
    assert r["status"] == "ok", r.get("error", "") + r.get("trace", "")
    assert r["memory"]["argument_bytes"] == repro_argument_bytes(arch, "decode_32k", POD1)
