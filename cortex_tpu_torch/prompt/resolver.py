"""Prompt versioning/resolution on top of the graph store.

Parity: crates/cortex-core/src/prompt/resolver.rs:12-382 —
  - versions per (slug, branch); HEAD = the version no sibling
    supersedes (forward-edge superseded-set pass, :28-80)
  - resolve: walk inherits_from chain (<=10 hops, cycle-guarded),
    merge sections root->head with override_sections winning per level,
    collect skills via incoming used_by edges (:83-168)
  - create_prompt / create_version (supersedes edge) / create_branch
    (branched_from edge) (:181-283); node title "slug@branch/vN",
    importance 0.7
"""

from __future__ import annotations

from typing import List, Optional, Set

from ..errors import PromptError
from ..storage.base import NodeFilter, Storage
from ..types import Edge, EdgeProvenance, Node, Source
from .model import (PromptContent, PromptInfo, PromptVersionInfo,
                    ResolvedPrompt)


class PromptResolver:
    def __init__(self, storage: Storage):
        self.storage = storage

    # ------------------------------------------------------------- versions
    def build_superseded_set(self, nodes: List[Node]) -> Set[str]:
        superseded: Set[str] = set()
        for n in nodes:
            for e in self.storage.edges_from(n.id):
                if e.relation == "supersedes":
                    superseded.add(e.to_id)
        return superseded

    def find_versions(self, slug: str,
                      branch: Optional[str] = None) -> List[Node]:
        out = []
        for n in self.storage.list_nodes(NodeFilter(kinds=["prompt"])):
            c = PromptContent.try_from_node(n)
            if c is None or c.slug != slug:
                continue
            if branch is not None and c.branch != branch:
                continue
            out.append(n)
        out.sort(key=lambda n: n.created_at)
        return out

    def find_head(self, slug: str, branch: str) -> Optional[Node]:
        versions = self.find_versions(slug, branch)
        if not versions:
            return None
        superseded = self.build_superseded_set(versions)
        for n in versions:
            if n.id not in superseded:
                return n
        return None

    def get_version(self, slug: str, branch: str,
                    version_num: int) -> Optional[Node]:
        for n in self.find_versions(slug, branch):
            c = PromptContent.try_from_node(n)
            if c is not None and c.version == version_num:
                return n
        return None

    def list_versions(self, slug: str, branch: str) -> List[PromptVersionInfo]:
        versions = self.find_versions(slug, branch)
        superseded = self.build_superseded_set(versions)
        out = []
        for n in versions:
            c = PromptContent.try_from_node(n)
            out.append(PromptVersionInfo(
                node_id=n.id, slug=slug,
                version=c.version if c else 1, branch=branch,
                created_at=n.created_at,
                is_head=n.id not in superseded))
        return out

    def list_all_prompts(self) -> List[PromptInfo]:
        all_prompts = self.storage.list_nodes(NodeFilter(kinds=["prompt"]))
        superseded = self.build_superseded_set(all_prompts)
        out = []
        for n in all_prompts:
            if n.id in superseded:
                continue
            c = PromptContent.try_from_node(n)
            if c is None:
                continue
            out.append(PromptInfo(
                slug=c.slug, prompt_type=c.prompt_type, branch=c.branch,
                version=c.version, tags=list(n.tags), node_id=n.id))
        out.sort(key=lambda p: (p.slug, p.branch))
        return out

    # -------------------------------------------------------------- resolve
    def resolve(self, head_node: Node) -> ResolvedPrompt:
        raw = PromptContent.from_node(head_node)

        ancestors: List[Node] = []
        visited = {head_node.id}
        current = head_node.id
        for _ in range(10):
            inherit = next((e for e in self.storage.edges_from(current)
                            if e.relation == "inherits_from"), None)
            if inherit is None:
                break
            if inherit.to_id in visited:
                break       # cycle guard
            visited.add(inherit.to_id)
            parent = self.storage.get_node(inherit.to_id)
            if parent is None:
                raise PromptError(
                    f"Inherited prompt node {inherit.to_id} not found")
            ancestors.append(parent)
            current = inherit.to_id
        ancestors.reverse()         # [root, ..., parent]

        lineage = [c.slug for c in
                   (PromptContent.try_from_node(a) for a in ancestors)
                   if c is not None] + [raw.slug]

        merged = {}
        for a in ancestors:
            c = PromptContent.try_from_node(a)
            if c is not None:
                merged.update(c.sections)
                merged.update(c.override_sections)
        merged.update(raw.sections)
        merged.update(raw.override_sections)

        skills = []
        for e in self.storage.edges_to(head_node.id):
            if e.relation != "used_by":
                continue
            n = self.storage.get_node(e.from_id)
            if n is None:
                continue
            c = PromptContent.try_from_node(n)
            if c is not None:
                skills.append(c.slug)

        return ResolvedPrompt(
            slug=raw.slug, prompt_type=raw.prompt_type, version=raw.version,
            branch=raw.branch, content=merged, raw_content=raw,
            lineage=lineage, skills=skills, node_id=head_node.id,
            created_at=head_node.created_at)

    # --------------------------------------------------------------- create
    def _build_node(self, content: PromptContent, branch: str, version: int,
                    author: str) -> Node:
        full = PromptContent(
            slug=content.slug, prompt_type=content.prompt_type,
            branch=branch, version=version, sections=content.sections,
            metadata=content.metadata,
            override_sections=content.override_sections,
            context_weights=content.context_weights)
        node = Node.new("prompt", f"{content.slug}@{branch}/v{version}",
                        full.to_json(), Source(agent=author), 0.7)
        if content.context_weights:
            # selection reads context_weights from node.metadata (the
            # serving path never parses the body JSON per request)
            node.metadata["context_weights"] = dict(content.context_weights)
        return node

    def create_prompt(self, content: PromptContent, branch: str = "main",
                      author: str = "system") -> str:
        if self.find_versions(content.slug, branch):
            raise PromptError(
                f"Prompt '{content.slug}' on branch '{branch}' already "
                "exists. Use create_version to add a new version.")
        node = self._build_node(content, branch, 1, author)
        self.storage.put_node(node)
        return node.id

    def create_version(self, slug: str, branch: str, content: PromptContent,
                       author: str = "system") -> str:
        head = self.find_head(slug, branch)
        if head is None:
            raise PromptError(
                f"Prompt '{slug}' on branch '{branch}' not found")
        head_version = 1
        c = PromptContent.try_from_node(head)
        if c is not None:
            head_version = c.version
        fixed = PromptContent(
            slug=slug, prompt_type=content.prompt_type, branch=branch,
            sections=content.sections, metadata=content.metadata,
            override_sections=content.override_sections,
            context_weights=content.context_weights)
        node = self._build_node(fixed, branch, head_version + 1, author)
        self.storage.put_node(node)
        self.storage.put_edge(Edge.new(
            node.id, head.id, "supersedes", 1.0,
            EdgeProvenance.manual(author)))
        return node.id

    def create_branch(self, slug: str, from_branch: str, new_branch: str,
                      base_version: Optional[int] = None,
                      author: str = "system") -> str:
        if base_version is not None:
            base = self.get_version(slug, from_branch, base_version)
            if base is None:
                raise PromptError(
                    f"Version {base_version} of '{slug}@{from_branch}' "
                    "not found")
        else:
            base = self.find_head(slug, from_branch)
            if base is None:
                raise PromptError(
                    f"Prompt '{slug}' on branch '{from_branch}' not found")
        base_content = PromptContent.from_node(base)
        node = self._build_node(base_content, new_branch, 1, author)
        self.storage.put_node(node)
        self.storage.put_edge(Edge.new(
            node.id, base.id, "branched_from", 1.0,
            EdgeProvenance.manual(author)))
        return node.id
