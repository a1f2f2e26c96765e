"""The port's co-design example (``repro_torch.examples.train_qat``) on the
CPU, against ``repro``.

* The example runs whole at ``--steps 4 --batch 2 --seq 32``: every loss is
  finite and the W8A8 export's loss drift stays under its 0.15 gate.
* Its export, fed ``repro``'s ``init_params(PRNGKey(0))`` for
  ``qwen3_1_7b`` at ``reduced()`` (``params_from_numpy``), gives the
  manifest ``repro``'s ``export_arch_quant_manifest(convert_params_w8a8(
  ...))`` gives, entry for entry: tensor name, channels, the integer §3.1
  scale and shift, and the per-channel scale range; every int8 tensor has
  ``repro``'s shape.
* Its evaluation on those params gives ``repro``'s float32 and W8A8 losses
  within 1e-5 relative (``tests/test_torch_train_step.py``'s ``loss_fn``
  bound: the packages sum float32 products in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.convert import convert_params_w8a8 as jconvert
from repro.core.convert import export_arch_quant_manifest as jmanifest
from repro.data.pipeline import DataConfig, Pipeline
from repro.models import model as JM
from repro_torch.examples import train_qat
from repro_torch.models import model as TM
from test_torch_models import np_tree, repro_params

SEQ, BATCH = 32, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's eager steps on one intra-op thread: the suite runs
    in parallel workers, and the port's small steps on PyTorch's full thread
    pool crawl when the workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_qat_runs_on_the_cpu():
    r = train_qat.main(["--device", "cpu", "--steps", "4", "--batch", str(BATCH),
                        "--seq", str(SEQ)])
    assert r["steps"] == 4 and r["losses_finite"]
    assert all(np.isfinite(r[k]) for k in ("loss_first", "loss_last", "loss_f32", "loss_w8a8"))
    assert r["drift_ok"] and r["drift"] < train_qat.MAX_DRIFT
    assert r["manifest_tensors"] > 0 and 0.0 <= r["agreement"] <= 1.0


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def test_export_and_evaluation_match_repro():
    cfg = get_config(train_qat.ARCH, reduced=True)
    jparams = repro_params(jax.random.PRNGKey(0), cfg)
    params = TM.params_from_numpy(np_tree(jparams), device="cpu")

    pq, manifest = train_qat.export_w8a8(params)
    jpq = jconvert(jparams)
    assert manifest == jmanifest(jpq)
    jq8 = {k: v for k, v in _leaves(jpq) if k.endswith("/q8")}
    q8 = {k: v for k, v in _leaves(pq) if k.endswith("/q8")}
    assert sorted(q8) == sorted(jq8) and len(q8) == len(manifest["tensors"])
    for k in q8:
        assert tuple(q8[k].shape) == tuple(jq8[k].shape) and q8[k].dtype == torch.int8, k

    batch_np = Pipeline(cfg, DataConfig(seed=123)).batch(train_qat.EVAL_STEP, BATCH, SEQ)
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    loss_f32, loss_w8a8, agree = train_qat.evaluate(params, pq, cfg, batch, SEQ)
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    kw = dict(compute_dtype=jnp.float32, q_chunk=train_qat.CHUNK, kv_chunk=train_qat.CHUNK)
    want_f32, _ = JM.loss_fn(jparams, jbatch, cfg, **kw)
    want_w8a8, _ = JM.loss_fn(jpq, jbatch, cfg, **kw)
    assert abs(loss_f32 - float(want_f32)) <= 1e-5 * abs(float(want_f32))
    assert abs(loss_w8a8 - float(want_w8a8)) <= 1e-5 * abs(float(want_w8a8))
    assert 0.0 <= agree <= 1.0
