"""JSON (de)serialization shim: orjson when available, stdlib otherwise.

The container image does not ship ``orjson``; everything that serializes
metadata (directory records, extent spills, checkpoint manifests) goes
through this module so the hard dependency becomes a fast path instead of
an import-time crash.  ``dumps`` always returns ``bytes`` (orjson's
contract), and ``loads`` accepts ``bytes``/``str`` interchangeably.
"""
from __future__ import annotations

from typing import Any

try:
    import orjson as _orjson

    def dumps(obj: Any) -> bytes:
        return _orjson.dumps(obj)

    def loads(data) -> Any:
        return _orjson.loads(data)

    BACKEND = "orjson"
except ImportError:                                   # pragma: no cover
    import json as _json

    def dumps(obj: Any) -> bytes:
        return _json.dumps(obj, separators=(",", ":")).encode("utf-8")

    def loads(data) -> Any:
        if isinstance(data, (bytes, bytearray, memoryview)):
            data = bytes(data).decode("utf-8")
        return _json.loads(data)

    BACKEND = "json"
