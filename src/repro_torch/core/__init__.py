"""WTF core — the paper's contribution (Escriva & Sirer, 2015).

Architecture (paper Figure 1): metadata storage (`metadata.WarpKV`), storage
servers (`storage.StorageServer`), a replicated coordinator
(`coordinator.ReplicatedCoordinator`), and the client library
(`client.WtfClient`) which combines them into a transactional filesystem with
the file-slicing API (`yank`/`paste`/`punch`/`append`/`concat`/`copy`).
"""
from .client import (SEEK_CUR, SEEK_END, SEEK_SET, Cluster, WtfClient,
                     WtfTransaction, normalize_path)
from .client_runtime import ClientStats
from .coordinator import ReplicatedCoordinator
from .errors import (AlreadyExists, BadFileDescriptor, DeadlineExceeded,
                     DegradedRead, InvalidOffset, IsADirectory, KVConflict,
                     NoQuorum, NotADirectory, NotFound, NotOpenForWriting,
                     PreconditionFailed, ReplicaExhausted, StorageError,
                     TransactionAborted, WtfError)
from .gc import GarbageCollector
from .handle import WtfFile
from .inode import DEFAULT_REGION_SIZE, Inode, RegionData
from .iort import HealthTracker, IoFuture, IoRuntime, IoTask, PlanCache
from .repair import RepairDaemon, RepairQueue, RepairStats, RepairTicket
from .iosched import SliceScheduler
from .wbuf import PendingPtr, WriteBehindBuffer
from .wsched import StoreRequest, WriteScheduler
from .lease import LeaseHub, LeaseStats, LeaseTable
from .mdshard import MdShardStats, PhaseCrash, ShardedKV
from .metadata import CommutingOp, ListAppend, Transaction, WarpKV
from .placement import HashRing, stable_hash
from .slicing import (Extent, SlicePointer, compact, decode_extents,
                      encode_extents, merge_adjacent, overlay, slice_range,
                      split_by_regions)
from .storage import StorageServer
from .wlog import LogConsumer, LogProducer, WtfLog

__all__ = [
    "Cluster", "WtfClient", "WtfTransaction", "WtfFile", "ClientStats",
    "SliceScheduler", "WriteScheduler", "StoreRequest",
    "IoRuntime", "IoFuture", "IoTask", "PlanCache",
    "WriteBehindBuffer", "PendingPtr",
    "WarpKV", "StorageServer",
    "WtfLog", "LogProducer", "LogConsumer",
    "ShardedKV", "MdShardStats", "PhaseCrash",
    "LeaseHub", "LeaseTable", "LeaseStats",
    "ReplicatedCoordinator", "GarbageCollector", "HashRing",
    "Extent", "SlicePointer", "Inode", "RegionData",
    "compact", "overlay", "slice_range", "merge_adjacent",
    "encode_extents", "decode_extents", "split_by_regions",
    "stable_hash", "normalize_path",
    "SEEK_SET", "SEEK_CUR", "SEEK_END", "DEFAULT_REGION_SIZE",
    "WtfError", "TransactionAborted", "KVConflict", "PreconditionFailed",
    "NotFound", "AlreadyExists", "NotADirectory", "IsADirectory",
    "BadFileDescriptor", "NotOpenForWriting", "InvalidOffset",
    "StorageError", "DegradedRead", "ReplicaExhausted", "DeadlineExceeded",
    "NoQuorum",
    "HealthTracker",
    "RepairDaemon", "RepairQueue", "RepairStats", "RepairTicket",
    "CommutingOp", "ListAppend", "Transaction",
]
