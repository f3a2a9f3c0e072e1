"""The reference's SDK protocol goldens (tests/test_sdk_protocol_golden.py)
on the port: the HTTP responses the SDKs parse, from the port's HTTP app
over a Cortex on the CPU."""

from torch_reference_cases import port_cases

exec(port_cases("test_sdk_protocol_golden.py",
                cpu_calls=(r"\bCortex\.in_memory",)), globals())


def test_cases_run_on_the_port():
    assert create_app.__module__ == "cortex_tpu_torch.server.http"  # noqa: F821
