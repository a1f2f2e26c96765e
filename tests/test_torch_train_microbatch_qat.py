"""The port's ``launch.steps.make_train_step`` with QAT (every float weight of
two or more dims fake-quantized per output channel, routers excepted)
against ``repro``'s on the CPU, for every architecture at ``reduced()``:
``microbatches=2``, as ``tests/test_torch_train_microbatch.py`` runs it
without QAT, with its bounds (loss, grad norm and lr within 1e-5 relative).
"""
import pytest

from repro.configs import ARCH_IDS

from test_torch_train_microbatch import _one_torch_thread, check_train_step  # noqa: F401 (the fixture)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_qat_train_step_two_microbatches_matches_repro(arch):
    check_train_step(arch, qat=True)
