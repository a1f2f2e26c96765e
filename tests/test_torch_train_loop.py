"""The port's training launcher (``repro_torch.launch.train``) on the CPU.

``tests/test_substrate.py::TestTrainLoop`` mirrored on ``train(device="cpu")``:
the loss decreases over 8 steps and a resume from the step-4 checkpoint runs
steps 5..9 only (``opt["step"] == 10``); QAT trains.

Across packages, through ``repro``'s checkpoint format: a checkpoint that
``repro.launch.train.train`` wrote resumes in the port's ``train``, and one
the port wrote resumes in ``repro``'s.  Resumed from the same state on the
same seeded batches, each continued loss tracks the other package's
continued run within 1e-5 relative (measured: the first loss equal, the
next four ≤ 1.4e-7: float32 sums in other orders, grown by four AdamW
steps).
"""
import shutil
import tempfile

import numpy as np
import pytest
import torch

from repro.launch.train import train as repro_train
from repro_torch.launch import train as T

KW = dict(batch=4, seq=32, log_every=100)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's eager steps on one intra-op thread: the suite runs
    in parallel workers, and the port's small steps on PyTorch's full thread
    pool crawl when the workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TestTrainLoop:
    def test_loss_decreases_and_resumes(self, tmp_path):
        d = str(tmp_path / "ck")
        _, opt, hist = T.train("qwen3_1_7b", steps=8, ckpt_dir=d, ckpt_interval=4, device="cpu", **KW)
        assert hist[-1] < hist[0], hist
        assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 8
        # resume from checkpoint: continues at step 5 without blowing up
        _, opt2, hist2 = T.train("qwen3_1_7b", steps=10, ckpt_dir=d, ckpt_interval=100, device="cpu", **KW)
        assert len(hist2) == 5  # steps 5..9 only
        assert int(opt2["step"]) == 10
        assert hist2[0] == hist[5]  # the same state and batch as the first run's step 5

    def test_qat_trains(self):
        _, _, hist = T.train("minicpm_2b", steps=6, qat=True, device="cpu", **KW)
        assert np.isfinite(hist).all() and hist[-1] < hist[0]


def _resume_both(tmp_path, first):
    """``first`` trains 8 steps with a checkpoint at 4; both packages resume
    a copy of it to step 10.  Returns (repro's continued losses, the port's,
    the port's final step)."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    first(a)
    shutil.copytree(a, b)
    _, _, want = repro_train("qwen3_1_7b", steps=10, ckpt_dir=a, ckpt_interval=100, **KW)
    _, opt, got = T.train("qwen3_1_7b", steps=10, ckpt_dir=b, ckpt_interval=100, device="cpu", **KW)
    return np.asarray(want), np.asarray(got), int(opt["step"])


def test_repro_checkpoint_resumes_in_the_port(tmp_path):
    want, got, step = _resume_both(
        tmp_path, lambda d: repro_train("qwen3_1_7b", steps=8, ckpt_dir=d, ckpt_interval=4, **KW))
    assert step == 10 and got.shape == want.shape == (5,)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert abs(got[0] - want[0]) <= 1e-6 * abs(want[0])


def test_port_checkpoint_resumes_in_repro(tmp_path):
    want, got, step = _resume_both(
        tmp_path, lambda d: T.train("qwen3_1_7b", steps=8, ckpt_dir=d, ckpt_interval=4, device="cpu", **KW))
    assert step == 10 and got.shape == want.shape == (5,)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_cli_trains_on_the_requested_device(capsys):
    T.main(["--arch", "qwen3_1_7b", "--steps", "3", "--batch", "2", "--seq", "16", "--schedule", "wsd",
            "--microbatches", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("[train] qwen3_1_7b step") == 2  # steps 0 and 2 (log_every 5, and the last)


def test_a_mesh_is_refused():
    """A one-rank ``gloo`` mesh trains as ``train()`` does on the CPU, and
    every parameter and moment comes back a DTensor on that mesh."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint.ckpt import tree_leaves
    from repro_torch.launch.mesh import make_test_mesh

    _, _, want = T.train("qwen3_1_7b", steps=3, device="cpu", **KW)
    store = tempfile.mkdtemp(prefix="mesh_store_")
    dist.init_process_group("gloo", init_method=f"file://{store}/store", rank=0, world_size=1)
    try:
        mesh = make_test_mesh((1, 1), device_type="cpu")
        params, opt, got = T.train("qwen3_1_7b", steps=3, mesh=mesh, **KW)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    assert got == want
    leaves = tree_leaves(params) + tree_leaves(opt["m"]) + tree_leaves(opt["v"])
    assert all(isinstance(a, DTensor) and a.device_mesh is mesh for a in leaves)
    assert int(opt["step"]) == 3
