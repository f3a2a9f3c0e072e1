"""The reference's engine review cases (tests/test_engine_review_fixes.py)
on the port: the HTTP and gRPC surfaces, prompts, rollback and edges,
every Cortex on the CPU (device="cpu")."""

from torch_reference_cases import port_cases

exec(port_cases("test_engine_review_fixes.py",
                cpu_calls=(r"\bCortex\.in_memory",)), globals())


def test_cases_run_on_the_port():
    cx = Cortex.in_memory(device="cpu")  # noqa: F821
    assert type(cx).__module__ == "cortex_tpu_torch.api"
    cx.close()
