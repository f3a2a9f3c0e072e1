"""The reference's HTTP soak (tests/test_server_soak.py) on the port:
mixed concurrent requests against the port's HTTP app over a Cortex on
the CPU, checked for consistency."""

from torch_reference_cases import port_cases

exec(port_cases("test_server_soak.py",
                cpu_calls=(r"\bCortex\.in_memory",)), globals())

