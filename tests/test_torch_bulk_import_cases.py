"""The reference's bulk import cases (tests/test_bulk_import.py) on the
port: Cortex.bulk_import and the CLI's `import --bulk`, every Cortex and
the CLI on the CPU (device="cpu", `--device cpu`)."""

from torch_reference_cases import CLI_ON_CPU, port_cases

exec(port_cases("test_bulk_import.py", CLI_ON_CPU,
                cpu_calls=(r"\bCortex\.in_memory",)), globals())


def test_cases_run_on_the_port():
    cx = Cortex.in_memory(device="cpu")  # noqa: F821
    assert type(cx).__module__ == "cortex_tpu_torch.api"
    cx.close()
