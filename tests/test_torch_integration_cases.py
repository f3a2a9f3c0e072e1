"""The reference's end-to-end cases (tests/test_integration.py) on the
port: the lifecycle through Cortex (store, edges, hybrid search,
traversal, paths, briefings, decay, close and reopen), every Cortex on
the CPU (device="cpu")."""

from torch_reference_cases import port_cases

exec(port_cases("test_integration.py", cpu_calls=(
    r"\bCortex\.in_memory", r"\bCortex\.open")), globals())


def test_cases_run_on_the_port():
    cx = Cortex.in_memory(device="cpu")  # noqa: F821
    assert type(cx).__module__ == "cortex_tpu_torch.api"
    cx.close()
