"""The port's training step (``models.model.loss_fn``, ``launch.steps``) against
``repro``'s on the CPU, for every architecture of ``configs.ARCH_IDS`` at
``reduced()``.

``repro``'s float32 parameters (``init_params(PRNGKey(0))``) are carried
across with ``params_from_numpy``; the batch (B = 2, S = 16, labels = the
tokens, vision and encoder stubs as ``tests/test_torch_models.py`` builds
them) comes from a numpy seed; compute dtype float32, chunks of 8.  The two
packages sum float32 products in different orders, so results agree to
rounding, not bit for bit:

* ``loss_fn``'s total, loss and aux: within 1e-5 relative (aux: 1e-5 ·
  max(1e-6, |aux|)); tokens equal (measured: ≤ 2.3e-7);
* ``make_grad_step``'s gradients against ``jax.value_and_grad`` of
  ``loss_fn`` (what ``repro``'s ``make_grad_step`` returns): every leaf
  within 1e-5 · max |g| over the whole tree (measured: ≤ 6.6e-7).

``make_train_step`` is in ``tests/test_torch_train_microbatch.py``.

Within the port, the remat policies ``none`` / ``nothing_saveable`` /
``dots`` give the same loss and gradients bit for bit, and they really
recompute: counted on one step, ``nothing_saveable`` runs more matmuls than
``none`` (the forward's, again), ``dots`` as many matmuls as ``none`` but
more of the other ops.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCH_IDS, get_config
from repro.configs.base import ShapeConfig
from repro.models import model as JM
from repro_torch.configs import get_config as port_get_config
from repro_torch.launch import steps as Tsteps
from repro_torch.models import model as TM
from repro_torch.checkpoint.ckpt import tree_leaves

from test_torch_models import batch_np

B, S, CHUNK = 2, 16, 8
SC = ShapeConfig("custom", "train", S, B)
KW = dict(q_chunk=CHUNK, kv_chunk=CHUNK)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's eager steps on one intra-op thread: the suite runs
    in parallel workers, and the port's small steps on PyTorch's full thread
    pool crawl when the workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg):
    b = batch_np(cfg, np.random.default_rng(1))
    b["labels"] = b["tokens"]
    return b


@functools.lru_cache(maxsize=None)
def _repro(arch):
    """repro's params (numpy), batch, loss_fn outputs and grad step."""
    cfg = get_config(arch, reduced=True)
    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    # make_grad_step is value_and_grad of loss_fn: one compile gives both
    (total, aux), grads = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, b, cfg, compute_dtype=jnp.float32, **KW), has_aux=True))(params, jb)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return np_tree(params), batch, float(total), np_tree(aux), np_tree(grads)


def _port_params(arch):
    return TM.params_from_numpy(_repro(arch)[0], device="cpu")


def _rel(got, want, floor=0.0):
    return abs(float(got) - float(want)) / max(abs(float(want)), floor, 1e-30)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_fn_matches_repro(arch):
    _, batch, total, aux, _ = _repro(arch)
    cfg = port_get_config(arch, reduced=True)
    got_total, got = TM.loss_fn(_port_params(arch), batch, cfg, compute_dtype=torch.float32, **KW)
    assert _rel(got_total, total) <= 1e-5
    assert _rel(got["loss"], aux["loss"]) <= 1e-5
    assert _rel(got["aux_loss"], aux["aux_loss"], 1e-6) <= 1e-5
    assert float(got["tokens"]) == float(aux["tokens"])
    if cfg.moe is not None:
        assert float(got["aux_loss"]) > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_grad_step_matches_value_and_grad(arch):
    _, batch, loss, _, grads = _repro(arch)
    cfg = port_get_config(arch, reduced=True)
    got_loss, got = Tsteps.make_grad_step(cfg, SC, compute_dtype=torch.float32, **KW)(
        _port_params(arch), batch)
    assert _rel(got_loss, loss) <= 1e-5
    want = jax.tree.leaves(grads)
    got = tree_leaves(got)
    assert len(got) == len(want)
    gmax = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert float(np.abs(g.numpy() - w).max()) <= 1e-5 * gmax


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0
        self.other = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        else:
            self.other += 1
        return func(*args, **(kwargs or {}))


def _grads_under(arch, policy, count=False):
    cfg = dataclasses.replace(port_get_config(arch, reduced=True), remat_policy=policy)
    step = Tsteps.make_grad_step(cfg, SC, compute_dtype=torch.float32, **KW)
    params, batch = _port_params(arch), _repro(arch)[1]
    if not count:
        return step(params, batch)
    with _OpCounter() as ops:
        step(params, batch)
    return ops


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_policies_give_equal_gradients(arch):
    base_loss, base = _grads_under(arch, "none")
    for policy in ("nothing_saveable", "dots"):
        loss, grads = _grads_under(arch, policy)
        assert torch.equal(loss, base_loss), policy
        for a, b in zip(tree_leaves(grads), tree_leaves(base)):
            assert torch.equal(a, b), policy


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "rwkv6_3b", "zamba2_7b"])
def test_remat_policies_recompute(arch):
    none, nothing, dots = (_grads_under(arch, p, count=True) for p in ("none", "nothing_saveable", "dots"))
    assert nothing.mm > none.mm and nothing.other > none.other
    assert dots.mm == none.mm and dots.other > none.other


def test_unknown_remat_policy_raises():
    from repro_torch.models.transformer import _remat

    with pytest.raises(ValueError, match="remat policy"):
        _remat(lambda x: x, "everything")
