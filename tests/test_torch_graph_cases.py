"""The reference's graph cases (tests/test_graph.py) run on the port:
the engine's walks, paths and analytics, the device mirror on the CPU
and the temporal queries (graph/temporal.py: changed_since,
neighborhood_at, timeline).

Every DeviceGraphMirror runs on the CPU (device="cpu": the kernels'
plain versions). Every assertion is the reference's.
"""

from torch_reference_cases import port_cases

exec(port_cases("test_graph.py", cpu_calls=(r"\bDeviceGraphMirror",)),
     globals())


def test_cases_run_on_the_port():
    for obj in (GraphEngine, DeviceGraphMirror, changed_since,  # noqa: F821
                neighborhood_at, timeline):                     # noqa: F821
        assert obj.__module__.startswith("cortex_tpu_torch."), obj
