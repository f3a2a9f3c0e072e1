"""The reference's concurrency soak (tests/test_concurrency_soak.py) on
the port: writers, searchers and the linker on one SQLite Cortex (flat
and IVF), checked for corruption on reopen, on the CPU."""

from torch_reference_cases import port_cases

exec(port_cases("test_concurrency_soak.py",
                cpu_calls=(r"\bCortex\.open",)), globals())


def test_cases_run_on_the_port():
    assert Cortex.__module__ == "cortex_tpu_torch.api"  # noqa: F821
