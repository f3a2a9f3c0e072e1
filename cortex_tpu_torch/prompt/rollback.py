"""Automatic prompt rollback on performance degradation.

Parity: crates/cortex-core/src/prompt/rollback.rs —
  config defaults (:50-65): window 20, min samples 5, correction sigma
  warn 2.0 / rollback 3.0, absolute correction +0.25, sentiment sigma
  warn 1.5 / rollback 2.0, 3 consecutive negatives (< 0.4), cooldown
  base 1h doubling (capped 168h), quarantine after 3 rollbacks;
  record_deployment (:179-243): deployment event node with baseline
  stats + Welford accumulators, deployed edge;
  process_observation (:248-430): cooldown guard, Welford update,
  observed_with audit edge, stable after window, sigma/absolute/
  consecutive triggers;
  execute_rollback (:553-720): previous version via supersedes edge,
  rollback event node + rolled_back / rolled_back_to edges,
  auto-rolled-back + quarantined tags, deployment status update,
  uses-edge depression to 0.1;
  compute_baseline_stats (:811-827): defaults (0.15, 0.05, 0.7, 0.1),
  stddev floored at 0.01.
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from ..errors import PromptError
from ..storage.base import NodeFilter, Storage
from ..types import Edge, EdgeProvenance, Node, Source
from .resolver import PromptResolver

log = logging.getLogger(__name__)


@dataclass
class RollbackConfig:
    enabled: bool = True
    monitoring_window: int = 20
    min_samples_before_check: int = 5
    correction_rate_warning: float = 2.0
    correction_rate_rollback: float = 3.0
    absolute_correction_increase: float = 0.25
    sentiment_warning: float = 1.5
    sentiment_rollback: float = 2.0
    consecutive_negative_limit: int = 3
    cooldown_base_hours: int = 1
    max_rollbacks_before_quarantine: int = 3


@dataclass
class RollbackTrigger:
    kind: str            # correction_rate_sigma | sentiment_sigma |
    #                      absolute_correction_increase | consecutive_negative
    sigma: Optional[float] = None
    post_rate: Optional[float] = None
    post_sentiment: Optional[float] = None
    baseline: Optional[float] = None
    increase: Optional[float] = None
    count: Optional[int] = None

    def to_dict(self) -> dict:
        return {k: v for k, v in self.__dict__.items() if v is not None}


@dataclass
class RollbackResult:
    rollback_node_id: str
    from_node_id: str
    from_version: int
    to_node_id: str
    to_version: int
    trigger: RollbackTrigger
    cooldown_hours: int
    cooldown_expires_at: float
    is_quarantined: bool
    rollback_count: int


@dataclass
class RollbackSummary:
    rollback_node_id: str
    from_version: int
    to_version: int
    trigger: str
    rolled_back_at: float
    cooldown_hours: int


@dataclass
class ActiveDeploymentInfo:
    deployment_node_id: str
    prompt_node_id: str
    version: int
    agent_name: str
    deployed_at: float
    n_observed: int
    monitoring_window: int
    baseline_correction_rate: float
    baseline_sentiment: float
    mean_correction: float
    mean_sentiment: float
    consecutive_negative: int


@dataclass
class RollbackStatus:
    slug: str
    branch: str
    head_node_id: str
    current_version: int
    is_quarantined: bool
    rollback_count: int
    cooldown_expires_at: Optional[float]
    active_deployment: Optional[ActiveDeploymentInfo]
    recent_rollbacks: List[RollbackSummary] = field(default_factory=list)


def compute_baseline_stats(obs: Sequence[Tuple[float, float]]
                           ) -> Tuple[float, float, float, float]:
    """(mean_correction, std_correction, mean_sentiment, std_sentiment);
    stddev floored at 0.01; empty -> reference defaults."""
    if not obs:
        return 0.15, 0.05, 0.7, 0.1
    n = len(obs)
    mean_c = sum(c for c, _ in obs) / n
    mean_s = sum(s for _, s in obs) / n
    var_c = sum((c - mean_c) ** 2 for c, _ in obs) / n
    var_s = sum((s - mean_s) ** 2 for _, s in obs) / n
    return mean_c, max(var_c ** 0.5, 0.01), mean_s, max(var_s ** 0.5, 0.01)


def compute_cooldown_hours(base_hours: int, rollback_count: int) -> int:
    """Exponential rollback cooldown: doubles per rollback, the shift is
    capped at 2^7, and the result at 168h (one week) — reference
    rollback.rs:598-600."""
    return min(base_hours * (1 << min(rollback_count - 1, 7)), 168)


def _is_active_deployment(n: Node) -> bool:
    try:
        b = json.loads(n.body)
    except json.JSONDecodeError:
        return False
    return (b.get("event_type") == "deployment"
            and b.get("status") == "monitoring")


class RollbackMonitor:
    def __init__(self, storage: Storage,
                 config: Optional[RollbackConfig] = None):
        self.storage = storage
        self.config = config or RollbackConfig()

    # ---------------------------------------------------------- deployment
    def record_deployment(self, slug: str, branch: str, version: int,
                          prompt_node_id: str, agent_name: str,
                          baseline_obs: Sequence[Tuple[float, float]] = ()
                          ) -> str:
        bc, bsc, bs, bss = compute_baseline_stats(baseline_obs)
        body = {
            "event_type": "deployment", "slug": slug, "branch": branch,
            "version": version, "prompt_node_id": prompt_node_id,
            "agent_name": agent_name,
            "baseline_correction_rate": bc, "baseline_sentiment": bs,
            "baseline_stddev_correction": bsc,
            "baseline_stddev_sentiment": bss,
            "baseline_sample_size": len(baseline_obs),
            "monitoring_window": self.config.monitoring_window,
            "n_observed": 0, "m2_correction": 0.0, "mean_correction": bc,
            "m2_sentiment": 0.0, "mean_sentiment": bs,
            "consecutive_negative": 0, "status": "monitoring",
        }
        dep = Node.new("event", f"deployment:{slug}/{branch}/v{version}",
                       json.dumps(body), Source(agent=agent_name), 1.0)
        self.storage.put_node(dep)
        self.storage.put_edge(Edge.new(
            dep.id, prompt_node_id, "deployed", 1.0,
            EdgeProvenance.manual(agent_name)))
        return dep.id

    # --------------------------------------------------------- observation
    def process_observation(self, obs_node_id: str, prompt_node_id: str,
                            correction_rate: float, sentiment: float,
                            obs_score: float) -> Optional[RollbackResult]:
        if not self.config.enabled:
            return None
        if self._is_in_cooldown(prompt_node_id):
            return None

        deployments = [
            n for n in (self.storage.get_node(e.from_id)
                        for e in self.storage.edges_to(prompt_node_id)
                        if e.relation == "deployed")
            if n is not None and n.kind == "event"
            and _is_active_deployment(n)]
        if not deployments:
            return None
        deployments.sort(key=lambda n: n.created_at)
        dep = deployments[-1]
        body = json.loads(dep.body)

        window = int(body.get("monitoring_window",
                              self.config.monitoring_window))
        n_prev = int(body.get("n_observed", 0))
        bc = float(body.get("baseline_correction_rate", 0.15))
        bsc = float(body.get("baseline_stddev_correction", 0.05))
        bs = float(body.get("baseline_sentiment", 0.5))
        bss = float(body.get("baseline_stddev_sentiment", 0.1))
        mean_c = float(body.get("mean_correction", bc))
        m2_c = float(body.get("m2_correction", 0.0))
        mean_s = float(body.get("mean_sentiment", bs))
        m2_s = float(body.get("m2_sentiment", 0.0))
        consec = int(body.get("consecutive_negative", 0))

        # Welford online update
        n = n_prev + 1
        dc = correction_rate - mean_c
        mean_c = mean_c + dc / n
        m2_c = m2_c + dc * (correction_rate - mean_c)
        ds = sentiment - mean_s
        mean_s = mean_s + ds / n
        m2_s = m2_s + ds * (sentiment - mean_s)
        consec = consec + 1 if obs_score < 0.4 else 0

        # audit edge observation -> deployment
        try:
            self.storage.put_edge(Edge.new(
                obs_node_id, dep.id, "observed_with", 1.0,
                EdgeProvenance.auto_structural("rollback_monitor")))
        except Exception:  # noqa: BLE001 — duplicate observation edges ok
            pass

        body.update({
            "n_observed": n, "m2_correction": m2_c,
            "mean_correction": mean_c, "m2_sentiment": m2_s,
            "mean_sentiment": mean_s, "consecutive_negative": consec,
            "status": "stable" if n >= window else "monitoring",
        })
        dep.body = json.dumps(body)
        dep.updated_at = time.time()
        self.storage.put_node(dep)

        if n > window:
            # window exhausted on a PREVIOUS observation (this one was
            # the n>window case marked stable above); the boundary
            # observation itself — n == window — still gets evaluated,
            # otherwise a degradation completing exactly at the window
            # could never trigger
            return None
        if n < self.config.min_samples_before_check:
            return None

        corr_sigma = (mean_c - bc) / bsc if bsc > 1e-6 else 0.0
        sent_sigma = (bs - mean_s) / bss if bss > 1e-6 else 0.0
        corr_increase = mean_c - bc

        trigger: Optional[RollbackTrigger] = None
        if consec >= self.config.consecutive_negative_limit:
            trigger = RollbackTrigger(kind="consecutive_negative",
                                      count=consec)
        elif corr_sigma > self.config.correction_rate_rollback:
            trigger = RollbackTrigger(kind="correction_rate_sigma",
                                      sigma=corr_sigma, post_rate=mean_c,
                                      baseline=bc)
        elif sent_sigma > self.config.sentiment_rollback:
            trigger = RollbackTrigger(kind="sentiment_sigma",
                                      sigma=sent_sigma,
                                      post_sentiment=mean_s, baseline=bs)
        elif corr_increase > self.config.absolute_correction_increase:
            trigger = RollbackTrigger(kind="absolute_correction_increase",
                                      increase=corr_increase)
        if trigger is None:
            return None
        return self._execute_rollback(dep, prompt_node_id, trigger, body)

    # -------------------------------------------------------------- status
    def get_status(self, slug: str, branch: str) -> Optional[RollbackStatus]:
        resolver = PromptResolver(self.storage)
        head = resolver.find_head(slug, branch)
        if head is None:
            return None
        from .model import PromptContent
        c = PromptContent.try_from_node(head)
        version = c.version if c else 1
        is_quarantined = "quarantined" in head.tags

        cooldown_expires: Optional[float] = None
        summaries: List[RollbackSummary] = []
        rollback_count = 0
        for n in self.storage.list_nodes(NodeFilter(kinds=["event"],
                                                    tags=["rollback"])):
            try:
                b = json.loads(n.body)
            except json.JSONDecodeError:
                continue
            if b.get("event_type") != "rollback" or b.get("slug") != slug \
                    or b.get("branch") != branch:
                continue
            rollback_count += 1
            exp = b.get("cooldown_expires_at")
            if exp is not None:
                exp = float(exp)
                cooldown_expires = max(cooldown_expires or 0.0, exp)
            summaries.append(RollbackSummary(
                rollback_node_id=n.id,
                from_version=int(b.get("from_version", 0)),
                to_version=int(b.get("to_version", 0)),
                trigger=(b.get("trigger") or {}).get("kind", "unknown"),
                rolled_back_at=n.created_at,
                cooldown_hours=int(b.get("cooldown_hours", 1))))
        summaries.sort(key=lambda s: -s.rolled_back_at)

        active: Optional[ActiveDeploymentInfo] = None
        for e in self.storage.edges_to(head.id):
            if e.relation != "deployed":
                continue
            n = self.storage.get_node(e.from_id)
            if n is None or not _is_active_deployment(n):
                continue
            b = json.loads(n.body)
            active = ActiveDeploymentInfo(
                deployment_node_id=n.id, prompt_node_id=head.id,
                version=int(b.get("version", 0)),
                agent_name=b.get("agent_name", "unknown"),
                deployed_at=n.created_at,
                n_observed=int(b.get("n_observed", 0)),
                monitoring_window=int(b.get("monitoring_window", 20)),
                baseline_correction_rate=float(
                    b.get("baseline_correction_rate", 0.0)),
                baseline_sentiment=float(b.get("baseline_sentiment", 0.5)),
                mean_correction=float(b.get("mean_correction", 0.0)),
                mean_sentiment=float(b.get("mean_sentiment", 0.5)),
                consecutive_negative=int(b.get("consecutive_negative", 0)))

        return RollbackStatus(
            slug=slug, branch=branch, head_node_id=head.id,
            current_version=version, is_quarantined=is_quarantined,
            rollback_count=rollback_count,
            cooldown_expires_at=cooldown_expires,
            active_deployment=active,
            recent_rollbacks=summaries[:10])

    def unquarantine(self, prompt_node_id: str) -> None:
        node = self.storage.get_node(prompt_node_id)
        if node is None:
            raise PromptError(f"prompt node {prompt_node_id} not found")
        node.tags = [t for t in node.tags if t != "quarantined"]
        node.updated_at = time.time()
        self.storage.put_node(node)

    # ------------------------------------------------------------- private
    def _is_in_cooldown(self, prompt_node_id: str) -> bool:
        now = time.time()
        for e in self.storage.edges_to(prompt_node_id):
            if e.relation != "rolled_back":
                continue
            n = self.storage.get_node(e.from_id)
            if n is None:
                continue
            try:
                b = json.loads(n.body)
            except json.JSONDecodeError:
                continue
            exp = b.get("cooldown_expires_at")
            if exp is not None and float(exp) > now:
                return True
        return False

    def _count_rollbacks(self, slug: str, branch: str) -> int:
        count = 0
        for n in self.storage.list_nodes(NodeFilter(kinds=["event"],
                                                    tags=["rollback"])):
            try:
                b = json.loads(n.body)
            except json.JSONDecodeError:
                continue
            if b.get("event_type") == "rollback" and b.get("slug") == slug \
                    and b.get("branch") == branch:
                count += 1
        return count

    def _execute_rollback(self, dep: Node, prompt_node_id: str,
                          trigger: RollbackTrigger,
                          body: dict) -> RollbackResult:
        slug = body.get("slug", "unknown")
        branch = body.get("branch", "main")
        from_version = int(body.get("version", 0))
        agent_name = body.get("agent_name", "system")

        prev_id = next((e.to_id for e in
                        self.storage.edges_from(prompt_node_id)
                        if e.relation == "supersedes"), None)
        prev = self.storage.get_node(prev_id) if prev_id else None
        if prev is None:
            raise PromptError(
                f"Cannot rollback {slug}/{branch} v{from_version}: no "
                "previous version found")
        try:
            to_version = int(json.loads(prev.body).get(
                "version", max(from_version - 1, 0)))
        except json.JSONDecodeError:
            to_version = max(from_version - 1, 0)

        rollback_count = self._count_rollbacks(slug, branch) + 1
        cooldown_hours = compute_cooldown_hours(
            self.config.cooldown_base_hours, rollback_count)
        cooldown_expires = time.time() + cooldown_hours * 3600
        is_quarantined = rollback_count >= \
            self.config.max_rollbacks_before_quarantine

        log.warning(
            "prompt rollback: %s/%s v%d -> v%d (trigger: %s, #%d, "
            "cooldown %dh, quarantined=%s)", slug, branch, from_version,
            to_version, trigger.kind, rollback_count, cooldown_hours,
            is_quarantined)

        rb_body = {
            "event_type": "rollback", "slug": slug, "branch": branch,
            "from_version": from_version, "to_version": to_version,
            "from_node_id": prompt_node_id, "to_node_id": prev.id,
            "trigger": {"kind": trigger.kind, **trigger.to_dict()},
            "rollback_count": rollback_count,
            "cooldown_hours": cooldown_hours,
            "cooldown_expires_at": cooldown_expires,
            "is_quarantined": is_quarantined,
        }
        rb = Node.new("event",
                      f"rollback:{slug}/{branch}/v{from_version}"
                      f"->v{to_version}",
                      json.dumps(rb_body),
                      Source(agent="rollback_monitor"), 1.0)
        rb.tags.append("rollback")
        self.storage.put_node(rb)
        self.storage.put_edge(Edge.new(
            rb.id, prompt_node_id, "rolled_back", 1.0,
            EdgeProvenance.auto_structural("rollback_monitor")))
        self.storage.put_edge(Edge.new(
            rb.id, prev.id, "rolled_back_to", 1.0,
            EdgeProvenance.auto_structural("rollback_monitor")))

        prompt_node = self.storage.get_node(prompt_node_id)
        if prompt_node is not None:
            if "auto-rolled-back" not in prompt_node.tags:
                prompt_node.tags.append("auto-rolled-back")
            if is_quarantined and "quarantined" not in prompt_node.tags:
                prompt_node.tags.append("quarantined")
            prompt_node.updated_at = time.time()
            self.storage.put_node(prompt_node)

        body["status"] = "quarantined" if is_quarantined else "rolled_back"
        dep.body = json.dumps(body)
        dep.updated_at = time.time()
        self.storage.put_node(dep)

        # depress agent->prompt uses edges to 0.1
        agent_node = next(iter(self.storage.list_nodes(NodeFilter(
            kinds=["agent"], source_agent=agent_name, limit=1))), None)
        if agent_node is not None:
            for edge in self.storage.edges_between(agent_node.id,
                                                   prompt_node_id):
                if edge.relation == "uses":
                    self.storage.update_edge_weight_atomic(edge.id, 0.1)

        return RollbackResult(
            rollback_node_id=rb.id, from_node_id=prompt_node_id,
            from_version=from_version, to_node_id=prev.id,
            to_version=to_version, trigger=trigger,
            cooldown_hours=cooldown_hours,
            cooldown_expires_at=cooldown_expires,
            is_quarantined=is_quarantined, rollback_count=rollback_count)
