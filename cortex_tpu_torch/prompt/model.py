"""Prompt data model: prompts are graph nodes (kind=prompt) whose body is
JSON PromptContent (crates/cortex-core/src/prompt/model.rs:8-75)."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..errors import PromptError
from ..types import Node

PROMPT_TYPES = ["persona", "skill", "constraint", "template", "meta"]


@dataclass
class PromptContent:
    slug: str
    prompt_type: str = "persona"        # persona|skill|constraint|template|meta
    branch: str = "main"
    version: int = 1
    sections: Dict[str, Any] = field(default_factory=dict)
    metadata: Dict[str, Any] = field(default_factory=dict)
    override_sections: Dict[str, Any] = field(default_factory=dict)
    context_weights: Optional[Dict[str, float]] = None

    def to_json(self) -> str:
        d: Dict[str, Any] = {
            "slug": self.slug, "type": self.prompt_type,
            "branch": self.branch, "version": self.version,
            "sections": self.sections, "metadata": self.metadata,
            "override_sections": self.override_sections,
        }
        if self.context_weights is not None:
            d["context_weights"] = self.context_weights
        return json.dumps(d)

    @staticmethod
    def from_json(s: str) -> "PromptContent":
        try:
            d = json.loads(s)
        except json.JSONDecodeError as e:
            raise PromptError(f"Failed to parse prompt content: {e}") from e
        if not isinstance(d, dict) or "slug" not in d:
            raise PromptError("prompt body missing slug")
        return PromptContent(
            slug=d["slug"],
            prompt_type=d.get("type", "persona"),
            branch=d.get("branch", "main"),
            version=int(d.get("version", 1)),
            sections=d.get("sections", {}) or {},
            metadata=d.get("metadata", {}) or {},
            override_sections=d.get("override_sections", {}) or {},
            context_weights=d.get("context_weights"),
        )

    @staticmethod
    def from_node(node: Node) -> "PromptContent":
        return PromptContent.from_json(node.body)

    @staticmethod
    def try_from_node(node: Node) -> Optional["PromptContent"]:
        try:
            return PromptContent.from_node(node)
        except PromptError:
            return None


@dataclass
class ResolvedPrompt:
    slug: str
    prompt_type: str
    version: int
    branch: str
    content: Dict[str, Any]          # merged sections
    raw_content: PromptContent
    lineage: List[str]               # root ancestor first, this slug last
    skills: List[str]
    node_id: str
    created_at: float


@dataclass
class PromptVersionInfo:
    node_id: str
    slug: str
    version: int
    branch: str
    created_at: float
    is_head: bool


@dataclass
class PromptInfo:
    slug: str
    prompt_type: str
    branch: str
    version: int
    tags: List[str]
    node_id: str
