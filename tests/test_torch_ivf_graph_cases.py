"""The reference's kNN-graph refinement cases (tests/test_ivf_graph.py) on
the port: the graph's build, refinement, background swap, lifecycle and
the sharded index on a mesh of eight `cpu` devices, every index on the
CPU, the port's BruteForceIndex as the oracle."""

from torch_reference_cases import port_cases

exec(port_cases("test_ivf_graph.py", [
    (r"\bTpuIvfIndex\b", "TorchIvfIndex"),
    (r"build_mesh\(8\)", 'build_mesh(8, devices=["cpu"] * 8)'),
], cpu_calls=(r"\bTorchIvfIndex", r"\bCortex\.in_memory")), globals())


def test_cases_run_on_the_port():
    assert BruteForceIndex.__module__ == "cortex_tpu_torch.vector.index"  # noqa: F821
    assert ivfmod.__name__ == "cortex_tpu_torch.vector.ivf"  # noqa: F821
