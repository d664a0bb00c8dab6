"""Small-mesh dry-run of the port for the MoE family (qwen3-moe: grouped
top-k routing, capacity drops, expert parallelism over the model axis):
the smoke config traced on a 2 x 2 x 2 (pod, data, model) mesh of the
fake process-group backend (world 8, in a process of its own), remat
``dots`` and ``compress_grads``; the train step and a decode step trace,
and sharded training communicates (``tests/test_torch_dryrun_small.py``
holds the dense families and their FLOPs). A file of its own, so that
the runs spread over the workers."""
import pytest

from torch_port_util import DRYRUN_PORT_SCRIPT, check_traced, run_script

pytestmark = pytest.mark.tier1


@pytest.mark.parametrize("arch", ['qwen3_moe_235b_a22b'])
def test_small_mesh_dryrun_moe(arch):
    check_traced(run_script(DRYRUN_PORT_SCRIPT, arch))
