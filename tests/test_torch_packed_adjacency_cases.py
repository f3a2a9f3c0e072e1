"""The reference's packed adjacency cases (tests/test_packed_adjacency.py)
on the port: the packed snapshot's build, BFS parity with the object
route, the mirror's routing through its tiers (the device walk on the
CPU: DeviceGraphMirror(..., device="cpu")) and the rebuild debounce.
Their `storage` fixture is the port's (torch_reference_cases.storage),
which takes the place of tests/conftest.py's."""

from torch_reference_cases import port_cases, storage  # noqa: F401

exec(port_cases("test_packed_adjacency.py",
                cpu_calls=(r"\bDeviceGraphMirror",)), globals())


def test_cases_run_on_the_port(storage):  # noqa: F811
    st, ids = build_graph()  # noqa: F821
    m = DeviceGraphMirror(AdjacencyCache(st), device="cpu")  # noqa: F821
    assert type(m).__module__ == "cortex_tpu_torch.graph.csr"
    assert type(storage).__module__.startswith("cortex_tpu_torch.storage")
