"""Replicated, sharded serving fleet over the segment store.

Manifest-shipping replication (``publisher``/``syncer``), scatter-gather
top-k with cross-shard bound sharing (``fleet``), and process-per-replica
serving (``server``): the port's counterpart of the JAX package's
``repro.replication``, with its names. The fleet merge runs on the host,
or over a ``distributed.Mesh`` (``merge_topk_sharded(mesh=...)``,
``FleetSearcher(mesh=...)``)."""
from repro_torch.replication.fleet import (CollectionStats, FleetSearcher,
                                           FleetStats, ShardSpec,
                                           merge_topk_sharded)
from repro_torch.replication.publisher import (CommitPublisher, SyncPlan,
                                               latest_commit_meta,
                                               manifest_files, plan_delta)
from repro_torch.replication.server import (RemoteReplica,
                                            RemoteReplicaError, replica_main)
from repro_torch.replication.syncer import NoCleanCopy, ReplicaSyncer

__all__ = [
    "CollectionStats", "FleetSearcher", "FleetStats", "ShardSpec",
    "merge_topk_sharded", "CommitPublisher", "SyncPlan",
    "latest_commit_meta", "manifest_files", "plan_delta",
    "RemoteReplica", "RemoteReplicaError", "replica_main", "NoCleanCopy",
    "ReplicaSyncer",
]
