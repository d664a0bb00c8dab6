"""Roofline terms of one traced step, for the H100.

Counterpart of ``repro.roofline.analysis`` (``CollectiveStats``,
``Roofline``, ``model_flops_for`` and the ring wire-byte model of
``_line_collective``).  The reference reads a compiled XLA module's HLO
text; the port has no such text, so ``StepCounter`` counts the same three
things on the operations a traced step runs, each rank's own (the local
operations of a DTensor step, one rank's view; every layer runs eagerly,
so nothing is weighted by a loop count):

  FLOPs       ``FlopCounterMode``'s formulas (``flop_registry``) on each
              local operation: a rank's FLOPs, as the reference's
              loop-weighted per-partition dot FLOPs are.  (A
              ``FlopCounterMode`` around a DTensor step sees the global
              operations instead and gives the sum over the ranks.)
  bytes       each local operation's output bytes once; a view or an
              in-place update (an output that aliases an input) counts
              zero, as ``_comp_local_stats`` charges a
              dynamic-update-slice zero.
  collectives every ``_c10d_functional`` collective with its output bytes
              and group size, through ``wire_bytes``.

Hardware model (H100 SXM5 data sheet, per card):
  peak dense bf16 compute  989e12 FLOP/s
  HBM3 bandwidth           3.35e12 B/s
  NVLink 4 link            450e9 B/s: one direction of the 900 GB/s
                           bidirectional total (18 links x 25 GB/s each
                           way)

Terms:
  T_compute    = FLOPs per device / peak
  T_memory     = bytes per device / HBM bandwidth
  T_collective = wire bytes per device / link bandwidth
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9


def wire_bytes(op: str, out_bytes: int, group_size: int) -> tuple[int, int]:
    """(modelled ring wire bytes a device, input bytes) of one collective
    from its output bytes and group size: an all-gather receives (N-1)/N
    of its output, an all-reduce is a reduce-scatter and an all-gather
    (2x), a reduce-scatter moves (g-1)/g of an input g times its output,
    an all-to-all or a permute moves about all of it."""
    if op == "all-gather":
        return out_bytes, out_bytes // max(1, group_size)
    if op == "all-reduce":
        return 2 * out_bytes, out_bytes
    if op == "reduce-scatter":
        g = group_size
        return out_bytes * max(1, g - 1), out_bytes * g
    return out_bytes, out_bytes          # all-to-all, collective-permute


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: int = 0        # modelled ring-traffic bytes per device
    operand_bytes: int = 0     # raw input-operand bytes
    by_op: dict = dataclasses.field(default_factory=dict)
    count: int = 0
    flops: float = 0.0         # FLOPs per device
    hbm_bytes: float = 0.0     # op-output bytes per device

    def add_collective(self, op: str, out_bytes: int, group_size: int):
        wire, in_b = wire_bytes(op, out_bytes, group_size)
        self.wire_bytes += wire
        self.operand_bytes += in_b
        d = self.by_op.setdefault(op, {"count": 0, "wire_bytes": 0})
        d["count"] += 1
        d["wire_bytes"] += wire
        self.count += 1


def _collective_kind(name: str) -> Optional[str]:
    for key, op in (("all_gather", "all-gather"),
                    ("reduce_scatter", "reduce-scatter"),
                    ("all_reduce", "all-reduce"),
                    ("all_to_all", "all-to-all"),
                    ("broadcast", "collective-permute"),
                    ("permute", "collective-permute")):
        if key in name:
            return op
    return None


def _group_size(func, args) -> int:
    """The group size a functional collective names (an int argument for
    the gather and scatter, the group's size otherwise)."""
    schema = func._schema
    for a, v in zip(schema.arguments, args):
        if a.name == "group_size":
            return int(v)
    for a, v in zip(schema.arguments, args):
        if a.name == "group_name":
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            return _resolve_process_group(v).size()
    return 2


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


class StepCounter(TorchDispatchMode):
    """A dispatch mode that counts a rank's FLOPs, output bytes and
    collectives (``self.stats``) over the operations run inside it.  On
    an operation with DTensor arguments it steps aside (``NotImplemented``)
    so that DTensor runs it as local operations and collectives, which
    come back through the mode and are counted.  The global-shape
    operations DTensor runs on fake tensors to infer an output's shape
    are not counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self.flop_registry = FlopCounterMode(display=False).flop_registry
        self.stats = CollectiveStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented
        try:
            out = func(*args, **kwargs)
        except Exception as e:
            if not getattr(e, "__notes__", None):   # the innermost op
                e.add_note(f"at {func} on " + ", ".join(
                    f"{tuple(a.shape)}/{a.stride()}" for a in args
                    if isinstance(a, torch.Tensor)))
            raise
        if any(t.__name__ == "FakeTensor" for t in types):
            return out   # DTensor's sharding propagation infers a shape
        packet = getattr(func, "_overloadpacket", None)
        ns = getattr(func, "namespace", "")
        name = getattr(func, "__name__", "")
        if ns.startswith("_c10d_functional"):
            kind = _collective_kind(name)
            if kind is not None:
                self.stats.add_collective(kind, _nbytes(out),
                                          _group_size(func, args))
                self.stats.hbm_bytes += _nbytes(out)
            return out
        if packet in self.flop_registry:
            self.stats.flops += float(self.flop_registry[packet](
                *args, **kwargs, out_val=out))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for ret, o in zip(func._schema.returns, outs):
            if ret.alias_info is None:         # no view, no in-place write
                self.stats.hbm_bytes += _nbytes(o)
        return out


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_dev: float
    bytes_per_dev: float
    wire_bytes_per_dev: float
    model_flops: float            # 6·N_active·D tokens-based
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    useful_ratio: float = 0.0
    peak_flops: float = PEAK_FLOPS
    collectives: Optional[dict] = None
    memory_stats: Optional[dict] = None

    def finalize(self) -> "Roofline":
        total_flops = self.flops_per_dev * self.chips
        total_bytes = self.bytes_per_dev * self.chips
        self.t_compute = total_flops / (self.chips * PEAK_FLOPS)
        self.t_memory = total_bytes / (self.chips * HBM_BW)
        self.t_collective = self.wire_bytes_per_dev / LINK_BW
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        self.useful_ratio = (self.model_flops / total_flops
                             if total_flops else 0.0)
        return self

    @property
    def step_time_est(self) -> float:
        """No-overlap upper bound; with perfect overlap it's the max term."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline-limited step time."""
        t = self.step_time_est
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * PEAK_FLOPS * t)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["step_time_est"] = self.step_time_est
        d["mfu"] = self.mfu
        return d


def model_flops_for(cfg, shape_name: str, n_active: int) -> float:
    """6·N·D for train (fwd+bwd), 2·N·D for inference, per step."""
    from repro_torch.configs.registry import SHAPES
    seq, gbatch, mode = SHAPES[shape_name]
    if mode == "train":
        tokens = seq * gbatch
        return 6.0 * n_active * tokens
    if mode == "prefill":
        tokens = seq * gbatch
        return 2.0 * n_active * tokens
    tokens = gbatch  # decode: one token per sequence
    return 2.0 * n_active * tokens
