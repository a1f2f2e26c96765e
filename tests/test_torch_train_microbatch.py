"""The port's ``launch.steps.make_train_step`` against ``repro``'s on the CPU,
for every architecture of ``configs.ARCH_IDS`` at ``reduced()``, with
``microbatches=2`` (two float32 gradient sums, as ``repro``'s ``lax.scan``
carries them), ``warmup_cosine`` past its warmup; without QAT here, with QAT in
``tests/test_torch_train_microbatch_qat.py`` (split so the two run on two
workers).

``repro``'s float32 parameters and batch as in
``tests/test_torch_train_step.py`` (B = 2, S = 16, float32, chunks of 8);
one step from AdamW's fresh state at step 3.  The step's loss, grad norm
and lr agree within 1e-5 relative (float32 sums in other orders), and the
step count is 4.  The new params are not compared: AdamW's m/√v turns the
sign of a near-zero gradient, which float32 rounding can flip, into ±lr
(measured: 1.2e-5 at lr 8.7e-4), so a bound would say nothing; the update
itself is held against ``repro``'s in ``tests/test_torch_optim.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config
from repro.launch import steps as Jsteps
from repro.models import model as JM
from repro.optim import adamw as Jadamw
from repro_torch.configs import get_config as port_get_config
from repro_torch.launch import steps as Tsteps
from repro_torch.models import model as TM

from test_torch_train_step import KW, SC, _batch, _rel

SKW = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's eager steps on one intra-op thread: the suite runs
    in parallel workers, and the port's small steps on PyTorch's full thread
    pool crawl when the workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_two_microbatches_matches_repro(arch):
    check_train_step(arch, qat=False)


def check_train_step(arch, qat):
    cfg = get_config(arch, reduced=True)
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    batch = _batch(cfg)
    sc = dataclasses.replace(SC, microbatches=2)
    jstep = jax.jit(Jsteps.make_train_step(cfg, sc, compute_dtype=jnp.float32, sched_kwargs=SKW, qat=qat, **KW))
    tstep = Tsteps.make_train_step(port_get_config(arch, reduced=True), sc, compute_dtype=torch.float32,
                                   sched_kwargs=SKW, qat=qat, **KW)
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jopt = {**Jadamw.init(jp), "step": jnp.asarray(3, jnp.int32)}  # past the warmup: lr > 0
    topt = TM.opt_state_from_numpy(jax.tree.map(np.asarray, jopt), device="cpu")
    assert topt["step"].dtype == torch.int32 and tuple(topt["step"].shape) == ()
    _, _, want = jstep(jp, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
    _, new_opt, got = tstep(tp, topt, batch)
    assert new_opt["step"].dtype == torch.int32 and int(new_opt["step"]) == 4
    for k in ("loss", "grad_norm", "lr"):
        assert _rel(got[k], want[k]) <= 1e-5, k
