"""Mutation hooks with panic isolation.

Parity: crates/cortex-core/src/hooks/mod.rs:10-70 — MutationHook callbacks
for node/edge mutations, registry with catch_unwind-style isolation (an
exception in one hook never breaks the write path or other hooks).
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional

from .types import Edge, Node

log = logging.getLogger(__name__)

NODE_CREATED = "created"
NODE_UPDATED = "updated"
NODE_DELETED = "deleted"


class MutationHook:
    """Subclass or pass callables to HookRegistry.add_fn."""

    def on_node_mutation(self, action: str, node: Node) -> None:  # noqa: D401
        pass

    def on_edge_mutation(self, action: str, edge: Edge) -> None:
        pass


class _FnHook(MutationHook):
    def __init__(self, on_node=None, on_edge=None):
        self._on_node = on_node
        self._on_edge = on_edge

    def on_node_mutation(self, action: str, node: Node) -> None:
        if self._on_node:
            self._on_node(action, node)

    def on_edge_mutation(self, action: str, edge: Edge) -> None:
        if self._on_edge:
            self._on_edge(action, edge)


class HookRegistry:
    def __init__(self):
        self._hooks: List[MutationHook] = []

    def add(self, hook: MutationHook) -> None:
        self._hooks.append(hook)

    def add_fn(self, on_node: Optional[Callable[[str, Node], None]] = None,
               on_edge: Optional[Callable[[str, Edge], None]] = None) -> None:
        self._hooks.append(_FnHook(on_node, on_edge))

    def __len__(self) -> int:
        return len(self._hooks)

    def notify_node(self, action: str, node: Node) -> None:
        for h in self._hooks:
            try:
                h.on_node_mutation(action, node)
            except Exception:  # noqa: BLE001 — isolation (hooks/mod.rs:46-57)
                log.exception("node hook raised; isolated")

    def notify_edge(self, action: str, edge: Edge) -> None:
        for h in self._hooks:
            try:
                h.on_edge_mutation(action, edge)
            except Exception:  # noqa: BLE001
                log.exception("edge hook raised; isolated")
