"""The sharded filter's control plane: placement (``sharding.py``, beside
the training step's ``ParallelConfig``), elastic split and merge
(``elastic.py``) and fault injection, degraded serving and recovery
(``fault.py``).  The reference package's LM sharding specs and
mesh elasticity (``largest_mesh``, ``reshard_state``) wait for the LM
stack's mesh."""
from repro_torch.distributed.elastic import (ElasticController,
                                             MigrationReport, filter_mesh,
                                             insert_pairs, merge_state,
                                             migrate_state, split_state)
from repro_torch.distributed.fault import (FaultInjector, InjectedFault,
                                           RestartPolicy, StragglerWatchdog,
                                           degraded_lookup, recover_shard,
                                           retry_routed_write,
                                           run_with_restarts)
from repro_torch.distributed.sharding import (ParallelConfig,
                                              shard_filter_state)

__all__ = ["ElasticController", "FaultInjector", "InjectedFault",
           "MigrationReport", "ParallelConfig", "RestartPolicy",
           "StragglerWatchdog",
           "degraded_lookup", "filter_mesh", "insert_pairs", "merge_state",
           "migrate_state", "recover_shard", "retry_routed_write",
           "run_with_restarts", "shard_filter_state", "split_state"]
