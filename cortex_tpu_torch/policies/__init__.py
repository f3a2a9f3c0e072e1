from .audit import AuditLog
from .retention import (KindRetention, RetentionConfig, RetentionEngine,
                        RetentionMaxNodes)

__all__ = ["AuditLog", "KindRetention", "RetentionConfig", "RetentionEngine",
           "RetentionMaxNodes"]
