"""WTF-backed training-data pipeline: record shards, zero-copy global
shuffle/mixing, deterministic resumable multi-host iteration."""
from .pipeline import DataPipeline, PipelineConfig, PipelineState
from .records import RecordFile, RecordSpec, RecordWriter, write_token_shard
from .shuffle import mix_datasets, shuffle_epoch
from .tokenizer import ByteTokenizer

__all__ = [
    "DataPipeline", "PipelineConfig", "PipelineState",
    "RecordFile", "RecordSpec", "RecordWriter", "write_token_shard",
    "shuffle_epoch", "mix_datasets", "ByteTokenizer",
]
