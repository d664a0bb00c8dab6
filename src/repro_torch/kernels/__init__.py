"""Hand-written CUDA kernels of the filter (``csrc/``), each with its plain
PyTorch version beside it.

Counterpart of ``repro.kernels``, with the same package-level names.  As
there, ``repro_torch.kernels.probe`` and ``.flash_attention`` are the
functions; their modules stay importable by their dotted names
(``from repro_torch.kernels.probe import probe_multi``)."""
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fingerprint import fingerprint_hash
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.insert import insert_once
from repro_torch.kernels.probe import probe
from repro_torch.kernels.stash import make_stash, stash_occupancy
