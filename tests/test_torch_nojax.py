"""cortex_tpu_torch imports and runs with jax and cortex_tpu blocked.

One subprocess blocks jax and the JAX package (sys.modules['jax'] =
sys.modules['jaxlib'] = sys.modules['cortex_tpu'] = None, so any import
of them raises), imports every module of the port, runs tiny
store -> search passes on the CPU (the IVF index, the flat index and the
default config) and an edges -> hybrid search pass through every tier of
the graph mirror, and reports what it saw as JSON; the tests below check
that report. A second subprocess shows that chip_smoke.py's own check
fails once a module of the JAX package is loaded.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, json, pkgutil, sys, tempfile
    sys.modules["jax"] = None
    sys.modules["jaxlib"] = None
    sys.modules["cortex_tpu"] = None
    import torch
    import cortex_tpu_torch
    from cortex_tpu_torch.errors import ConfigError, DeviceUnavailable
    from cortex_tpu_torch.types import Node, Source
    from cortex_tpu_torch import Cortex
    from cortex_tpu_torch.config import CortexConfig
    from cortex_tpu_torch.utils.device import resolve_device
    from cortex_tpu_torch.vector import VectorFilter

    def cfg(**kw):
        c = CortexConfig()
        c.embedding.index = "ivf"
        c.embedding.ivf_graph_degree = 0
        c.embedding.model = "hash-64"
        for k, v in kw.items():
            setattr(c.embedding, k, v)
        return c

    def store_search(config):
        cx = Cortex.in_memory(config, device="cpu")
        nodes = [Node.new("fact" if i % 2 else "event",
                          f"note {i} about topic{i % 5}", f"body word{i}",
                          Source(agent="a"), 0.5) for i in range(40)]
        cx.store_batch(nodes)
        hits = cx.search(f"note 3 about topic3", 5, record_access=False)
        flt = cx.search("note 3 about topic3", 5, flt=VectorFilter(
            kinds=["event"]), record_access=False)
        return cx, {"top1": hits[0][1].id == nodes[3].id,
                    "filtered_kinds": sorted({n.kind for _, n in flt}),
                    "index": cx.index.index_info()["kind"]}

    out = {}
    out["modules"] = sorted(
        m.name for m in pkgutil.walk_packages(cortex_tpu_torch.__path__,
                                              "cortex_tpu_torch.")
        if importlib.import_module(m.name) is not None)

    def hybrid_tiers():
        from cortex_tpu_torch.types import Edge, EdgeProvenance
        cx = Cortex.in_memory(CortexConfig(), device="cpu")
        nodes = [Node.new("fact", f"linked note {i} about topic{i % 3}",
                          f"body word{i}", Source(agent="a"), 0.5)
                 for i in range(30)]
        cx.store_batch(nodes)
        for i in range(29):
            cx.create_edge(Edge.new(nodes[i].id, nodes[i + 1].id,
                                    "related_to", 0.7,
                                    EdgeProvenance.manual("a")))
        seen = {}
        for tier, kw in {"host": {}, "relax": {"HOST_FRONTIER_BUDGET": 0},
                         "packed": {"PACKED_EDGE_THRESHOLD": 0,
                                    "HOST_FRONTIER_BUDGET": 0}}.items():
            for k, v in kw.items():
                setattr(cx.mirror, k, v)
            got = cx.search_hybrid("linked note 4 about topic1",
                                   [nodes[0].id], 5)
            seen[tier] = sorted((r.node.id == nodes[0].id, r.graph_score)
                                for r in got)
        return seen

    out["hybrid"] = hybrid_tiers()
    cx, ivf = store_search(cfg())
    out.update(ivf)
    # the flat index: asked for, the default config (index = "flat" with
    # ivf_graph_degree = 32, which only the IVF index reads), and the
    # IVF-only settings beside index = "flat"
    out["flat"] = {
        "flat": store_search(cfg(index="flat"))[1],
        "default": store_search(CortexConfig())[1],
        "flat_ivf_settings": store_search(cfg(
            index="flat", ivf_graph_degree=32, ivf_target_recall=0.9))[1],
    }
    out["jax_loaded"] = any(
        m == "jax" or m.startswith(("jax.", "jaxlib"))
        for m, v in sys.modules.items() if v is not None)
    out["cortex_tpu_loaded"] = sorted(
        m for m, v in sys.modules.items()
        if v is not None and (m == "cortex_tpu"
                              or m.startswith("cortex_tpu.")))

    def raises(fn, exc):
        try:
            fn()
        except exc as e:
            return str(e)
        return None

    if not torch.cuda.is_available():
        out["cuda_refused"] = raises(lambda: resolve_device("cuda"),
                                     DeviceUnavailable)
        out["cortex_cuda_refused"] = raises(
            lambda: Cortex.in_memory(cfg()), DeviceUnavailable)
    with tempfile.TemporaryDirectory() as weights_dir:
        unported = {
            "flat": dict(index="flat", sharded=True),
            "graph": dict(ivf_graph_degree=32),
            "tuner": dict(ivf_target_recall=0.9),
            "sharded": dict(sharded=True),
            "local_weights": dict(model=weights_dir),
        }
        out["config_errors"] = {
            name: raises(lambda kw=kw: Cortex.in_memory(cfg(**kw),
                                                        device="cpu"),
                         ConfigError)
            for name, kw in unported.items()}
    ivf_defaults = CortexConfig()
    ivf_defaults.embedding.index = "ivf"
    ivf_defaults.embedding.model = "hash-64"
    out["ivf_default_config_error"] = raises(
        lambda: Cortex.in_memory(ivf_defaults, device="cpu"), ConfigError)
    out["gate_error"] = raises(
        lambda: cx.store(Node.new("fact", "gated title here", "gated body",
                                  Source(agent="a")), gate=True),
        ConfigError)
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def report():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_every_module_imports_without_jax(report):
    mods = set(report["modules"])
    for name in ("graph.csr", "graph.engine", "graph.packed",
                 "graph.traversal", "graph.paths", "graph.host_csr",
                 "ops.graph_bfs", "vector.hybrid", "native", "api"):
        assert f"cortex_tpu_torch.{name}" in mods


def test_hybrid_tiers_run_without_jax(report):
    # every tier of the mirror gives the same proximity (a chain of 30)
    tiers = report["hybrid"]
    assert tiers["host"] == tiers["relax"] == tiers["packed"]
    assert [True, 1.0] in tiers["host"]


def test_chip_smoke_fails_once_the_jax_package_is_loaded():
    code = textwrap.dedent("""
        import sys, types
        import chip_smoke
        chip_smoke.check_no_reference_import()          # nothing loaded
        sys.modules["cortex_tpu.graph.csr"] = types.ModuleType("x")
        try:
            chip_smoke.check_no_reference_import()
        except AssertionError as e:
            print("refused:", e)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "refused: the JAX package was imported" in proc.stdout
    assert "cortex_tpu.graph.csr" in proc.stdout


def test_store_search_runs_without_jax(report):
    assert report["top1"] is True
    assert report["filtered_kinds"] == ["event"]


def test_jax_never_imported(report):
    assert report["jax_loaded"] is False


def test_cortex_tpu_never_imported(report):
    # after store -> search on the IVF index, the flat index and the
    # default config: no module of the JAX package was loaded
    assert report["cortex_tpu_loaded"] == []


def test_cuda_absent_raises(report):
    import torch
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here: resolve_device does not raise")
    assert "CUDA is not available" in report["cuda_refused"]
    assert report["cortex_cuda_refused"]


@pytest.mark.parametrize("name", ["flat", "graph", "tuner", "sharded",
                                  "local_weights"])
def test_unported_config_raises_config_error(report, name):
    # flat: the sharded flat index; graph and tuner: ivf_graph_degree /
    # ivf_target_recall with index = "ivf", the only index that reads them
    msg = report["config_errors"][name]
    assert msg is not None and "ROADMAP" in msg


def test_reference_defaults_are_refused(report):
    # with index = "ivf", the reference's other defaults are refused:
    # ivf_graph_degree = 32 asks for the unported kNN-graph refinement
    assert "ivf_graph_degree" in report["ivf_default_config_error"]


@pytest.mark.parametrize("name", ["flat", "default", "flat_ivf_settings"])
def test_flat_index_stores_and_searches_without_jax(report, name):
    got = report["flat"][name]
    assert got == {"top1": True, "filtered_kinds": ["event"],
                   "index": "flat"}


def test_reference_defaults_open_the_flat_index(report):
    # the port keeps the reference defaults: index = "flat" with
    # ivf_graph_degree = 32, which the flat index does not read
    assert report["flat"]["default"]["index"] == "flat"


def test_write_gate_raises_config_error(report):
    assert "ROADMAP" in report["gate_error"]
