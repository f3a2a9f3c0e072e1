from .base import (SCHEMA_VERSION, AuditEntry, NodeFilter, Storage,
                   StorageStats)
from .memory_store import MemoryStorage
from .sqlite_store import SqliteStorage

__all__ = [
    "SCHEMA_VERSION", "AuditEntry", "NodeFilter", "Storage", "StorageStats",
    "MemoryStorage", "SqliteStorage",
]
