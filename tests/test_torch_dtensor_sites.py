"""The dry-run's one-block-a-rank sites hold the plain math on real
DTensors: four gloo processes on the CPU (a 2 x 2 (data, model) mesh),
float64 inputs from a seed, each site's output and its gradients through
``full_tensor()`` against the same function on plain tensors, within
1e-12.

The sites lay out a product (``sharding.tp_matmul``,
``row_parallel_head``), a per-batch call
(``per_batch_shard``), the MoE expert products (``moe._expert_blocks``)
and the window ring's write (``attention._ring_write``) one block a rank,
with the partial sums of their backward stated (``grad_placements``,
``sharding._FromPartial``).  The inputs are laid out as the production
step has them where torch 2.11 refused DTensor's own layout: a
sequence-sharded input to a column-parallel product, a partial sum out of
a row-parallel one, a resident weight split by its rows on the batch's
mesh dim (decode), a sequence-sharded ring.  The dry-run runs the same
code on ``meta`` tensors, where no value can be checked."""
import json

import pytest

from torch_port_util import run_script

pytestmark = pytest.mark.tier1

SITES_SCRIPT = r"""
import json, socket
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, port, q):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=4, rank=rank)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import (
        per_batch_shard, row_parallel_head, tp_matmul)
    from repro_torch.models import moe
    from repro_torch.models.attention import _ring_write
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    gen = torch.Generator().manual_seed(0)
    R, S = Replicate(), Shard

    def full(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64)

    def laid(t, placements, grad=True):
        return distribute_tensor(t, mesh, placements).requires_grad_(grad)

    err = {}

    def check(name, site, plain, inputs, placements, cot_placements):
        # site(*DTensors) against plain(*tensors), and every gradient of
        # sum(out * cot)
        ds = [laid(t, p) for t, p in zip(inputs, placements)]
        ps = [t.clone().requires_grad_() for t in inputs]
        want = plain(*ps)
        cot = full(*want.shape)
        got = site(*ds)
        (got * laid(cot, cot_placements, False)).sum().backward()
        (want * cot).sum().backward()
        err[name] = (got.full_tensor() - want).abs().max().item()
        for i, (d, p) in enumerate(zip(ds, ps)):
            err[f"{name} grad {i}"] = (d.grad.full_tensor()
                                       - p.grad).abs().max().item()

    x = full(4, 6, 8)
    # column-parallel: x's sequence sharded where w's columns are
    check("tp_matmul_columns", tp_matmul, torch.matmul,
          (x, full(8, 10)), ([S(0), S(1)], [R, S(1)]), [R, R])
    # row-parallel: the output a partial sum over the model axis
    check("tp_matmul_rows", tp_matmul, torch.matmul,
          (full(4, 6, 10), full(10, 8)), ([S(0), S(2)], [R, S(0)]),
          [S(0), S(1)])
    # a resident layout (decode): rows over data, columns over model
    check("tp_matmul_resident", tp_matmul, torch.matmul,
          (full(4, 1, 8), full(8, 10)), ([S(0), R], [S(0), S(1)]), [S(0), R])
    check("tp_matmul_whole", tp_matmul, torch.matmul,
          (x, full(8, 10)), ([S(0), S(1)], [R, R]), [R, S(2)])
    check("row_parallel_head", row_parallel_head, torch.matmul,
          (x, full(8, 12)), ([S(0), R], [R, S(1)]), [R, R])
    scan = lambda xx, aa: torch.cumsum(xx, 1) * aa[None, :, None]
    check("per_batch_shard",
          lambda xx, aa: per_batch_shard(scan, (xx,), (aa,)), scan,
          (x, full(6)), ([S(0), S(1)], [R, R]), [R, R])
    cfg = get_smoke_config("qwen3_moe_235b_a22b")
    e, f = cfg.moe.n_experts, cfg.moe.expert_d_ff
    ws = (full(e, 64, f), full(e, 64, f), full(e, f, 64))

    def experts(math):
        def call(xe, w_in, w_gate, w_out):
            return math(cfg, xe, dict(w_in=w_in, w_gate=w_gate,
                                      w_out=w_out))
        return call
    check("expert_blocks", experts(moe._expert_blocks),
          experts(moe._expert_math), (full(4, e, 3, 64), *ws),
          ([S(0), S(1)], *[[R, S(0)]] * 3), [R, R])
    ring, src = full(2, 3, 8, 4), full(2, 3, 3, 4)
    idx = torch.tensor([6, 1, 3])
    dst = laid(ring, [S(0), S(2)], False)
    _ring_write(dst, idx, laid(src, [S(0), R], False))
    want = ring.clone()
    want[:, :, idx] = src
    err["ring_write"] = (dst.full_tensor() - want).abs().max().item()
    if rank == 0:
        q.put(err)
    dist.destroy_process_group()


if __name__ == "__main__":
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    q = mp.get_context("spawn").Queue()
    ranks = mp.start_processes(run, args=(port, q), nprocs=4, join=False,
                               start_method="spawn")
    err = q.get(timeout=240)          # drained before the ranks are joined
    while not ranks.join(timeout=240):
        pass
    print(json.dumps(err))
"""

SITES = ["tp_matmul_columns", "tp_matmul_rows", "tp_matmul_resident",
         "tp_matmul_whole", "row_parallel_head", "per_batch_shard",
         "expert_blocks", "ring_write"]


@pytest.fixture(scope="module")
def errors(tmp_path_factory):
    # a file, so that the spawned ranks can import ``run`` from it
    path = tmp_path_factory.mktemp("sites") / "sites.py"
    path.write_text(SITES_SCRIPT)
    return run_script(f"import runpy; runpy.run_path({str(path)!r}, "
                      f"run_name='__main__')", timeout=300)


@pytest.mark.parametrize("site", SITES)
def test_site_holds_the_plain_math_on_dtensors(errors, site):
    got = {k: v for k, v in errors.items() if k.split(" grad")[0] == site}
    assert got and (site == "ring_write" or len(got) > 1), errors
    assert all(v <= 1e-12 for v in got.values()), got
