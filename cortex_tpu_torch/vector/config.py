"""Similarity thresholds (reference: crates/cortex-core/src/vector/config.rs:24-86)."""

from __future__ import annotations

from dataclasses import dataclass

from ..errors import ConfigError


@dataclass
class SimilarityConfig:
    auto_link_threshold: float = 0.75
    dedup_threshold: float = 0.92
    contradiction_threshold: float = 0.80
    auto_link_k: int = 20

    def validate(self) -> None:
        for name in ("auto_link_threshold", "dedup_threshold",
                     "contradiction_threshold"):
            v = getattr(self, name)
            if not (0.0 <= v <= 1.0):
                raise ConfigError(f"{name}={v} out of [0,1]")
        if self.auto_link_threshold >= self.dedup_threshold:
            raise ConfigError(
                "auto_link_threshold must be below dedup_threshold "
                f"({self.auto_link_threshold} >= {self.dedup_threshold})")
        if self.contradiction_threshold >= self.dedup_threshold:
            raise ConfigError(
                "contradiction_threshold must be below dedup_threshold "
                f"({self.contradiction_threshold} >= {self.dedup_threshold})")
        if self.auto_link_k < 1:
            raise ConfigError("auto_link_k must be >= 1")
