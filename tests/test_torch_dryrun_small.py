"""Small-mesh dry-run of the port (``repro_torch.launch.dryrun``), the
counterpart of ``tests/test_dryrun_small.py``: each family's smoke config
traced on a 2 x 2 x 2 (pod, data, model) mesh of the fake process-group
backend (world 8, in a process of its own), remat ``dots`` and
``compress_grads``: the train step and a decode step trace, and sharded
training communicates.

The dense families (this file) also count their FLOPs: rank 0's FLOPs of
the train step (``FlopCounterMode``'s formulas on its local operations)
against the reference's loop-weighted per-device dot FLOPs of the same
step (``parse_collectives`` on its compiled HLO), within 25%.  The
decoder-only families agree within 2% (mistral-nemo 1.2%, llava 0.9%
over; the gap is the embedding-gather and loss products the two count
differently).  musicgen counts 22% more: its step is mostly attention
(self and cross, head width 16), and the flash backward recomputes the
score product q k^T of every tile (q k^T, dO v^T, p^T dO, dS^T q and dS k:
five products a tile) where XLA's autodiff of the reference's attention
reuses the forward's probabilities.

The plain flash versions, which the dry-run's ``meta`` tensors take,
skip a key block by its positions alone (``_block_live``): held equal to
the mask's ``any()`` here."""
import pytest
import torch

from torch_port_util import (DRYRUN_PORT_SCRIPT, DRYRUN_REF_FLOPS_SCRIPT,
                             check_traced, run_script)

pytestmark = pytest.mark.tier1

DENSE = ["mistral_nemo_12b", "musicgen_large", "llava_next_mistral_7b"]
FLOPS_RTOL = 0.25


@pytest.mark.parametrize("arch", DENSE)
def test_small_mesh_dryrun_dense(arch):
    out = run_script(DRYRUN_PORT_SCRIPT, arch)
    check_traced(out)
    ref = run_script(DRYRUN_REF_FLOPS_SCRIPT, arch, jax_devices=True)
    assert ref["train_collectives"] > 0
    ratio = out["train_flops"] / ref["train_flops"]
    assert abs(ratio - 1) <= FLOPS_RTOL, (out["train_flops"],
                                          ref["train_flops"])


def test_block_live_is_the_masks_any():
    """The plain versions skip a key block by ``_block_live``, from the
    positions alone (a ``meta`` tensor has no values to test): it equals
    ``_live(...).any()`` on every block of every shape and mask."""
    from repro_torch.kernels.flash_attention import _block_live, _live
    for sq, skv in ((1, 1), (3, 7), (7, 7), (9, 4), (64, 200), (200, 200),
                    (1, 300)):
        qpos = (skv - sq + torch.arange(sq))[:, None]
        for causal in (True, False):
            for window in (None, 1, 3, 64, 500):
                for bk in (1, 5, 64):
                    for j0 in range(0, skv, bk):
                        width = min(bk, skv - j0)
                        want = bool(_live(qpos, j0, width, causal,
                                          window).any())
                        assert _block_live(sq, skv, j0, width, causal,
                                           window) == want, \
                            (sq, skv, j0, width, causal, window)
