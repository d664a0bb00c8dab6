"""The port's meshes and mesh elasticity on the fake process-group
backend, in a process of its own (one process group a process):
``launch.mesh`` (the test and production meshes, the world-size checks),
``distributed.elastic.largest_mesh`` (TP kept, the surviving ranks'
multiples of it to data) and ``reshard_state`` (every weight re-laid out
by its logical spec on the new mesh)."""
import pytest

from torch_port_util import run_script

pytestmark = pytest.mark.tier1

SCRIPT = """
import json
import torch
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.elastic import largest_mesh, reshard_state
from repro_torch.distributed.sharding import (ParallelConfig, distribute,
                                              local_shape_and_offset,
                                              make_shardings, spec_to_pspec,
                                              to_placements)
from repro_torch.launch.mesh import (init_fake_process_group,
                                     make_production_mesh, make_test_mesh)
from repro_torch.launch.specs import abstract_init

out = {}
try:
    make_test_mesh()
except RuntimeError as e:
    out["no_group"] = "init_fake_process_group" in str(e)
init_fake_process_group(8)
init_fake_process_group(8)                  # the same world: a no-op
try:
    init_fake_process_group(16)
except RuntimeError as e:
    out["second_world"] = "process of its own" in str(e)
try:
    make_production_mesh()
except RuntimeError as e:
    out["production_needs_256"] = "256" in str(e)
mesh = make_test_mesh(2, 2, pod=2)
out["test_mesh"] = [list(mesh.mesh_dim_names), list(mesh.shape)]
out["test_mesh_2d"] = list(make_test_mesh(4, 2).shape)
small = largest_mesh(range(7), model_parallel=2)
out["largest"] = [list(small.mesh_dim_names), list(small.shape),
                  small.mesh.flatten().tolist()]
try:
    largest_mesh(range(7), model_parallel=8)
except RuntimeError as e:
    out["too_few"] = "cannot host" in str(e)

pc = ParallelConfig()
shapes, specs = abstract_init(get_smoke_config("gemma3-1b"))
old = make_test_mesh(4, 2)
state = {k: distribute(v, old, spec_to_pspec(specs[k], tuple(v.shape), old,
                                             pc))
         for k, v in shapes.items()}
new = reshard_state(state, specs, small, pc)
want = make_shardings(small, specs, shapes, pc)
ok = []
for k, t in new.items():
    ok.append(list(t.placements) == to_placements(want[k], small)
              and tuple(t.to_local().shape)
              == tuple(local_shape_and_offset(tuple(t.shape), small,
                                              want[k])[0])
              and t.shape == shapes[k].shape)
out["reshard"] = [len(ok), all(ok)]
out["uneven_data_axis"] = sum(1 for k in want if want[k][:1] == ("data",))
print(json.dumps(out))
"""


def test_meshes_and_elastic_resharding():
    out = run_script(SCRIPT)
    assert out["no_group"] and out["second_world"]
    assert out["production_needs_256"]
    assert out["test_mesh"] == [["pod", "data", "model"], [2, 2, 2]]
    assert out["test_mesh_2d"] == [4, 2]
    assert out["largest"] == [["data", "model"], [3, 2], [0, 1, 2, 3, 4, 5]]
    assert out["too_few"]
    n, ok = out["reshard"]
    assert n > 10 and ok
