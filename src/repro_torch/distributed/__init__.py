"""The sharded filter's control plane: placement (``sharding.py``, beside
the training step's ``ParallelConfig``), elastic split and merge
(``elastic.py``) and fault injection, degraded serving and recovery
(``fault.py``); and the LM stack's sharding plan on ``DeviceMesh``es
(``sharding.py``: logical specs to mesh axes and DTensor placements;
``elastic.largest_mesh``, ``elastic.reshard_state``)."""
from repro_torch.distributed.elastic import (ElasticController,
                                             MigrationReport, filter_mesh,
                                             insert_pairs, largest_mesh,
                                             merge_state, migrate_state,
                                             reshard_state, split_state)
from repro_torch.distributed.fault import (FaultInjector, InjectedFault,
                                           RestartPolicy, StragglerWatchdog,
                                           degraded_lookup, recover_shard,
                                           retry_routed_write,
                                           run_with_restarts)
from repro_torch.distributed.sharding import (ParallelConfig, batch_pspec,
                                              cache_pspec,
                                              constrain_batch_activations,
                                              make_shardings,
                                              shard_filter_state,
                                              spec_to_pspec)

__all__ = ["ElasticController", "FaultInjector", "InjectedFault",
           "MigrationReport", "ParallelConfig", "RestartPolicy",
           "StragglerWatchdog", "batch_pspec", "cache_pspec",
           "constrain_batch_activations", "degraded_lookup", "filter_mesh",
           "insert_pairs", "largest_mesh", "make_shardings", "merge_state",
           "migrate_state", "recover_shard", "reshard_state",
           "retry_routed_write", "run_with_restarts", "shard_filter_state",
           "spec_to_pspec", "split_state"]
