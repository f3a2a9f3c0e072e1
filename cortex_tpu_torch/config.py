"""Configuration of the port: the subset of cortex_tpu/config.py that the
ported slices read, parsed from the same TOML keys with the same
defaults.

  [server]                 sqlite_synchronous
  [embedding]              every key of the reference EmbeddingConfig
  [auto_linker]            AutoLinkerConfig, with [auto_linker.similarity],
                           [auto_linker.decay] and [[auto_linker.rules]]
  [score_decay]            ScoreDecayConfig

The defaults are the reference's, so a default config opens the flat
index (device_dtype and search_path take effect there); index = "ivf"
takes every IVF key, the kNN-graph refinement (ivf_graph_degree, 32 by
default) and the nprobe tuner (ivf_target_recall) included.
`check_ported` raises ConfigError for every setting whose code path is
not ported yet and names the ROADMAP item that will port it (the
sharded index), and for a dimension past the card's scan kernels
(KERNEL_MAX_DIM), so that no index opens and then fails at its first
search.
"""

from __future__ import annotations

import tomllib
from dataclasses import dataclass, field
from typing import Any, Dict

from .errors import ConfigError
from .linker.config import AutoLinkerConfig, ConfigRule, DecayConfig
from .vector.config import SimilarityConfig
from .vector.scoring import ScoreDecayConfig

#: ROADMAP items that port what this slice refuses
MESH_ITEM = "ROADMAP queue A, 'Multi-GPU'"
GATE_ITEM = "ROADMAP queue A, 'Write gate'"
#: the widest rows the card's int8 scans take: K1 (csrc/flat_scan_op.cpp)
#: and the IVF scan (csrc/ivf_gather_op.cpp) keep a chunk's queries in
#: shared memory
KERNEL_MAX_DIM = 4096


@dataclass
class ServerConfig:
    # SQLite durability: "normal" (WAL) or "full" (fsync per commit)
    sqlite_synchronous: str = "normal"


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
class CortexConfig:
    server: ServerConfig = field(default_factory=ServerConfig)
    embedding: EmbeddingConfig = field(default_factory=EmbeddingConfig)
    auto_linker: AutoLinkerConfig = field(default_factory=AutoLinkerConfig)
    score_decay: ScoreDecayConfig = field(default_factory=ScoreDecayConfig)

    @staticmethod
    def load(path: str) -> "CortexConfig":
        with open(path, "rb") as f:
            return CortexConfig.from_dict(tomllib.load(f))

    @staticmethod
    def from_dict(raw: Dict[str, Any]) -> "CortexConfig":
        cfg = CortexConfig()
        s = raw.get("server", {})
        cfg.server = ServerConfig(
            sqlite_synchronous=s.get("sqlite_synchronous", "normal"))
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
        return cfg

    def validate(self) -> None:
        """The reference's [auto_linker] and [embedding] checks
        (config.py:384-408)."""
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
