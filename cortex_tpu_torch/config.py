"""Configuration of the port: cortex_tpu/config.py's CortexConfig,
parsed from the same TOML keys with the same defaults and checked by the
same `validate`.

  [server]                 ServerConfig (data_dir, sqlite_synchronous, ...)
  [schema]                 extra kinds and relations
  [embedding]              every key of the reference EmbeddingConfig
  [auto_linker]            AutoLinkerConfig, with [auto_linker.similarity],
                           [auto_linker.decay] and [[auto_linker.rules]]
  [briefing]               BriefingConfig
  [ingest.*], [observability], [security], [[webhooks]], [[plugins]]
  [retention]              RetentionConfig
  [prompt_rollback]        RollbackConfig
  [score_decay]            ScoreDecayConfig
  [write_gate]             WriteGateConfig, with [write_gate.overrides.*]
  [schemas.*]              KindSchema per kind

The server, ingest, observability, security, webhook and plugin
sections are parsed for parity; the port has no server yet (ROADMAP
queue A, 'HTTP/gRPC/MCP/CLI surfaces'), so nothing reads them. The
defaults are the reference's, so a default config opens the flat index
(device_dtype and search_path take effect there); index = "ivf" takes
every IVF key, the kNN-graph refinement (ivf_graph_degree, 32 by
default) and the nprobe tuner (ivf_target_recall) included.
`check_ported` raises ConfigError for every setting whose code path is
not ported yet and names the ROADMAP item that will port it (the
sharded index), and for a dimension past the card's scan kernels
(KERNEL_MAX_DIM), so that no index opens and then fails at its first
search.
"""

from __future__ import annotations

import os
import tomllib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .briefing.engine import BriefingConfig
from .errors import ConfigError
from .gate import KindOverrideConfig, WriteGateConfig
from .gate.schema import KindSchema
from .linker.config import AutoLinkerConfig, ConfigRule, DecayConfig
from .policies.retention import RetentionConfig
from .prompt.rollback import RollbackConfig
from .vector.config import SimilarityConfig
from .vector.scoring import ScoreDecayConfig

#: the ROADMAP item that ports what this slice refuses
MESH_ITEM = "ROADMAP queue A, 'Multi-GPU'"
#: the widest rows the card's int8 scans take: K1 (csrc/flat_scan_op.cpp)
#: and the IVF scan (csrc/ivf_gather_op.cpp) keep a chunk's queries in
#: shared memory
KERNEL_MAX_DIM = 4096
ENV_AUTH_TOKEN = "CORTEX_AUTH_TOKEN"


@dataclass
class ServerConfig:
    grpc_addr: str = "0.0.0.0:9090"
    http_addr: str = "0.0.0.0:9091"
    data_dir: str = "./data"
    nats_url: Optional[str] = None
    warmup: bool = True
    search_batching: bool = True
    compilation_cache_dir: str = ".jax-cache"
    # SQLite durability: "normal" (WAL) or "full" (fsync per commit)
    sqlite_synchronous: str = "normal"


@dataclass
class SchemaConfig:
    kinds: List[str] = field(default_factory=list)       # extra allowed kinds
    relations: List[str] = field(default_factory=list)


@dataclass
class EmbeddingConfig:
    """Fields and defaults of cortex_tpu.config.EmbeddingConfig.
    device_dtype and search_path configure the flat index; the IVF
    layout is int8 whatever they say. The port keeps no index snapshots
    (it always rebuilds from storage), so snapshot_boot and
    snapshot_min_delta are parsed for parity but change nothing."""

    model: str = "BAAI/bge-small-en-v1.5"
    dimension: int = 384
    device_dtype: str = "float32"
    snapshot_boot: bool = True
    snapshot_min_delta: int = 64
    search_path: str = "auto"
    sharded: bool = False
    mesh_replicas: int = 1
    index: str = "flat"
    ivf_nlist: int = 0                # 0 = auto (~sqrt(N), <= 8192)
    ivf_nprobe: int = 0               # 0 = auto (nlist/8, >= 8)
    ivf_target_recall: float = 0.0
    ivf_spill: float = 1.0
    ivf_graph_degree: int = 32


@dataclass
class IngestFileConfig:
    enabled: bool = False
    watch_dir: str = "./ingest"
    interval_secs: float = 10.0


@dataclass
class IngestConfig:
    file: IngestFileConfig = field(default_factory=IngestFileConfig)
    stdin_enabled: bool = False
    webhook_enabled: bool = False


@dataclass
class ObservabilityConfig:
    prometheus_enabled: bool = True
    sse_enabled: bool = True
    sse_buffer: int = 1024
    metrics_auth_exempt: bool = True


@dataclass
class SecurityConfig:
    auth_token: Optional[str] = None
    encryption_at_rest: bool = False


@dataclass
class WebhookConfig:
    url: str = ""
    events: List[str] = field(default_factory=list)


@dataclass
class PluginConfig:
    path: str = ""
    type: str = ""   # ingest|linker_rule|briefing_section|export_format|classifier


@dataclass
class CortexConfig:
    server: ServerConfig = field(default_factory=ServerConfig)
    schema: SchemaConfig = field(default_factory=SchemaConfig)
    embedding: EmbeddingConfig = field(default_factory=EmbeddingConfig)
    auto_linker: AutoLinkerConfig = field(default_factory=AutoLinkerConfig)
    briefing: BriefingConfig = field(default_factory=BriefingConfig)
    ingest: IngestConfig = field(default_factory=IngestConfig)
    observability: ObservabilityConfig = field(
        default_factory=ObservabilityConfig)
    retention: RetentionConfig = field(default_factory=RetentionConfig)
    security: SecurityConfig = field(default_factory=SecurityConfig)
    webhooks: List[WebhookConfig] = field(default_factory=list)
    plugins: List[PluginConfig] = field(default_factory=list)
    prompt_rollback: RollbackConfig = field(default_factory=RollbackConfig)
    score_decay: ScoreDecayConfig = field(default_factory=ScoreDecayConfig)
    write_gate: WriteGateConfig = field(default_factory=WriteGateConfig)
    schemas: Dict[str, KindSchema] = field(default_factory=dict)

    @staticmethod
    def load(path: str) -> "CortexConfig":
        """Parse a TOML file. A relative data_dir is relative to the
        file, as in the reference."""
        with open(path, "rb") as f:
            cfg = CortexConfig.from_dict(tomllib.load(f))
        if not os.path.isabs(cfg.server.data_dir):
            cfg.server.data_dir = os.path.normpath(os.path.join(
                os.path.dirname(os.path.abspath(path)),
                cfg.server.data_dir))
        return cfg

    @staticmethod
    def load_or_default(path: Optional[str]) -> "CortexConfig":
        if path and os.path.exists(path):
            cfg = CortexConfig.load(path)
        else:
            cfg = CortexConfig()
        cfg.apply_env_overrides()
        return cfg

    @staticmethod
    def from_dict(raw: Dict[str, Any]) -> "CortexConfig":
        cfg = CortexConfig()
        s = raw.get("server", {})
        cfg.server = ServerConfig(
            grpc_addr=s.get("grpc_addr", "0.0.0.0:9090"),
            http_addr=s.get("http_addr", "0.0.0.0:9091"),
            data_dir=s.get("data_dir", "./data"),
            nats_url=s.get("nats_url"),
            warmup=bool(s.get("warmup", True)),
            search_batching=bool(s.get("search_batching", True)),
            compilation_cache_dir=s.get("compilation_cache_dir",
                                        ".jax-cache"),
            sqlite_synchronous=s.get("sqlite_synchronous", "normal"))
        sc = raw.get("schema", {})
        cfg.schema = SchemaConfig(kinds=list(sc.get("kinds", [])),
                                  relations=list(sc.get("relations", [])))
        e = raw.get("embedding", {})
        cfg.embedding = EmbeddingConfig(
            model=e.get("model", "BAAI/bge-small-en-v1.5"),
            dimension=int(e.get("dimension", 384)),
            device_dtype=e.get("device_dtype", "float32"),
            search_path=e.get("search_path", "auto"),
            sharded=bool(e.get("sharded", False)),
            mesh_replicas=int(e.get("mesh_replicas", 1)),
            snapshot_boot=bool(e.get("snapshot_boot", True)),
            snapshot_min_delta=int(e.get("snapshot_min_delta", 64)),
            index=e.get("index", "flat"),
            ivf_nlist=int(e.get("ivf_nlist", 0)),
            ivf_nprobe=int(e.get("ivf_nprobe", 0)),
            ivf_spill=float(e.get("ivf_spill", 1.0)),
            ivf_graph_degree=int(e.get("ivf_graph_degree", 32)),
            ivf_target_recall=float(e.get("ivf_target_recall", 0.0)))
        al = raw.get("auto_linker", {})
        linker = AutoLinkerConfig(
            interval_secs=float(al.get("interval_secs", 60)),
            decay_every_n_cycles=int(al.get("decay_every_n_cycles", 60)),
            dedup_every_n_cycles=int(al.get("dedup_every_n_cycles", 360)),
            max_nodes_per_cycle=int(al.get("max_nodes_per_cycle", 500)),
            max_edges_per_cycle=int(al.get("max_edges_per_cycle", 2000)),
            max_edges_per_node=int(al.get("max_edges_per_node", 50)),
            candidate_k=int(al.get("candidate_k", 100)),
            generic_content_threshold=int(
                al.get("generic_content_threshold", 30)),
            run_on_startup=bool(al.get("run_on_startup", True)),
            embedding_model=cfg.embedding.model,
            legacy_rules_enabled=al.get("legacy_rules_enabled"),
        )
        sim = al.get("similarity", {})
        linker.similarity = SimilarityConfig(
            auto_link_threshold=float(sim.get("auto_link_threshold", 0.75)),
            dedup_threshold=float(sim.get("dedup_threshold", 0.92)),
            contradiction_threshold=float(
                sim.get("contradiction_threshold", 0.80)),
            auto_link_k=int(sim.get("auto_link_k", 20)))
        dc = al.get("decay", {})
        linker.decay = DecayConfig(
            daily_decay_rate=float(dc.get("daily_decay_rate", 0.01)),
            prune_threshold=float(dc.get("prune_threshold", 0.1)),
            delete_threshold=float(dc.get("delete_threshold", 0.05)),
            importance_shield=float(dc.get("importance_shield", 0.8)),
            access_reinforcement_days=float(
                dc.get("access_reinforcement_days", 7.0)),
            exempt_manual=bool(dc.get("exempt_manual", True)))
        linker.rules = [ConfigRule.from_dict(r) for r in al.get("rules", [])]
        cfg.auto_linker = linker

        b = raw.get("briefing", {})
        cfg.briefing = BriefingConfig(
            max_items_per_section=int(b.get("max_items_per_section", 10)),
            max_total_items=int(b.get("max_total_items", 50)),
            max_chars=int(b.get("max_chars", 8000)),
            recent_window_secs=float(b.get("recent_window_hours", 48)) * 3600,
            cache_ttl_secs=float(b.get("cache_ttl_secs", 300)),
            include_contradictions=bool(
                b.get("include_contradictions", True)),
            min_importance=float(b.get("min_importance", 0.3)),
            exclude_kinds=list(b.get("exclude_kinds", [])))

        ing = raw.get("ingest", {})
        fi = ing.get("file", {})
        cfg.ingest = IngestConfig(
            file=IngestFileConfig(
                enabled=bool(fi.get("enabled", False)),
                watch_dir=fi.get("watch_dir", "./ingest"),
                interval_secs=float(fi.get("interval_secs", 10))),
            stdin_enabled=bool(ing.get("stdin", {}).get("enabled", False)),
            webhook_enabled=bool(
                ing.get("webhook", {}).get("enabled", False)))

        ob = raw.get("observability", {})
        cfg.observability = ObservabilityConfig(
            prometheus_enabled=bool(ob.get("prometheus_enabled", True)),
            sse_enabled=bool(ob.get("sse_enabled", True)),
            sse_buffer=int(ob.get("sse_buffer", 1024)),
            metrics_auth_exempt=bool(ob.get("metrics_auth_exempt", True)))

        cfg.retention = RetentionConfig.from_dict(raw.get("retention", {}))

        sec = raw.get("security", {})
        cfg.security = SecurityConfig(
            auth_token=sec.get("auth_token"),
            encryption_at_rest=bool(sec.get("encryption_at_rest", False)))

        cfg.webhooks = [WebhookConfig(url=w.get("url", ""),
                                      events=list(w.get("events", [])))
                        for w in raw.get("webhooks", [])]
        cfg.plugins = [PluginConfig(path=p.get("path", ""),
                                    type=p.get("type", ""))
                       for p in raw.get("plugins", [])]

        pr = raw.get("prompt_rollback", {})
        cfg.prompt_rollback = RollbackConfig(
            enabled=bool(pr.get("enabled", True)),
            monitoring_window=int(pr.get("monitoring_window", 20)),
            min_samples_before_check=int(
                pr.get("min_samples_before_check", 5)),
            correction_rate_warning=float(
                pr.get("correction_rate_warning", 2.0)),
            correction_rate_rollback=float(
                pr.get("correction_rate_rollback", 3.0)),
            absolute_correction_increase=float(
                pr.get("absolute_correction_increase", 0.25)),
            sentiment_warning=float(pr.get("sentiment_warning", 1.5)),
            sentiment_rollback=float(pr.get("sentiment_rollback", 2.0)),
            consecutive_negative_limit=int(
                pr.get("consecutive_negative_limit", 3)),
            cooldown_base_hours=int(pr.get("cooldown_base_hours", 1)),
            max_rollbacks_before_quarantine=int(
                pr.get("max_rollbacks_before_quarantine", 3)))

        sd = raw.get("score_decay", {})
        decay = ScoreDecayConfig(
            enabled=bool(sd.get("enabled", True)),
            daily_rate=float(sd.get("daily_rate", 0.02)),
            max_age_days=float(sd.get("max_age_days", 365)),
            min_factor=float(sd.get("min_factor", 0.1)),
            echo_weight=float(sd.get("echo_weight", 0.05)),
            echo_cap=float(sd.get("echo_cap", 2.0)),
            recency_weight=float(sd.get("recency_weight", 0.15)))
        if "by_kind" in sd:
            decay.by_kind = {k: float(v) for k, v in sd["by_kind"].items()}
        cfg.score_decay = decay

        wg = raw.get("write_gate", {})
        gate = WriteGateConfig(
            enabled=bool(wg.get("enabled", True)),
            conflict_threshold=float(wg.get("conflict_threshold", 0.85)),
            duplicate_threshold=float(wg.get("duplicate_threshold", 0.92)),
            min_title_length=int(wg.get("min_title_length", 10)),
            min_body_length=int(wg.get("min_body_length", 20)),
            require_tags_above_importance=float(
                wg.get("require_tags_above_importance", 0.7)),
            require_body_length_for_importance=bool(
                wg.get("require_body_length_for_importance", True)))
        for kind, ov in wg.get("overrides", {}).items():
            gate.overrides[kind] = KindOverrideConfig(
                min_body_length=ov.get("min_body_length"),
                conflict_threshold=ov.get("conflict_threshold"))
        cfg.write_gate = gate

        cfg.schemas = {k: KindSchema.from_dict(v)
                       for k, v in raw.get("schemas", {}).items()}
        return cfg

    def apply_env_overrides(self) -> None:
        tok = os.environ.get(ENV_AUTH_TOKEN)
        if tok:
            self.security.auth_token = tok

    def validate(self) -> None:
        """The reference's checks (cortex_tpu/config.py::validate)."""
        try:
            self.auto_linker.validate()
        except Exception as e:  # noqa: BLE001
            raise ConfigError(f"[auto_linker] invalid: {e}") from e
        e = self.embedding
        if e.dimension <= 0:
            raise ConfigError("[embedding] dimension must be positive")
        if e.index not in ("flat", "ivf"):
            raise ConfigError("[embedding] index must be 'flat' or 'ivf'")
        if e.ivf_nlist < 0 or e.ivf_nprobe < 0:
            raise ConfigError(
                "[embedding] ivf_nlist/ivf_nprobe must be >= 0")
        if not 0.0 <= e.ivf_spill <= 1.0:
            raise ConfigError("[embedding] ivf_spill must be in [0, 1]")
        if not 0 <= e.ivf_graph_degree <= 1024:
            raise ConfigError(
                "[embedding] ivf_graph_degree must be in [0, 1024]")
        if not 0.0 <= e.ivf_target_recall <= 1.0:
            raise ConfigError(
                "[embedding] ivf_target_recall must be in [0, 1]")
        r = e.mesh_replicas
        if r < 1 or (r & (r - 1)) != 0:
            raise ConfigError(
                "[embedding] mesh_replicas must be a power of two >= 1")
        if self.briefing.max_total_items <= 0:
            raise ConfigError("[briefing] max_total_items must be positive")
        for w in self.webhooks:
            if not w.url:
                raise ConfigError("[[webhooks]] entries require a url")


def check_ported(cfg: CortexConfig) -> None:
    """Validate, then raise ConfigError for any setting whose code path
    the port does not have yet."""
    cfg.validate()
    e = cfg.embedding
    scans = e.index == "ivf" or e.search_path in ("auto", "quant")
    if scans and e.dimension > KERNEL_MAX_DIM:
        what = ("the IVF index's scan" if e.index == "ivf"
                else f"search_path = {e.search_path!r}'s int8 scan")
        raise ConfigError(
            f"[embedding] dimension={e.dimension}: {what} takes rows of "
            f"at most {KERNEL_MAX_DIM} on the card")
    if e.sharded:
        raise ConfigError(
            f"[embedding] sharded=true: the sharded index is not ported "
            f"yet ({MESH_ITEM})")
