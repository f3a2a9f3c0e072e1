"""The reference's native host kernel cases (tests/test_native.py) on the
port's library (native/host_rerank.cpp and host_graph.cpp): BFS,
max-product Dijkstra, the decay sweep, the re-rank and the graph
engine's native paths, every Cortex on the CPU (device="cpu")."""

from torch_reference_cases import port_cases

exec(port_cases("test_native.py", cpu_calls=(r"\bCortex\.in_memory",)),
     globals())


def test_cases_run_on_the_port():
    assert native.__name__ == "cortex_tpu_torch.native"  # noqa: F821
    assert native.available()  # noqa: F821
