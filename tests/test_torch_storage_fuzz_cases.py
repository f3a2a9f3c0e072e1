"""The reference's differential storage fuzzer (tests/test_storage_fuzz.py)
on the port: random op streams through the port's MemoryStorage and
SqliteStorage, each held to the other after every step."""

from torch_reference_cases import port_cases

exec(port_cases("test_storage_fuzz.py"), globals())


def test_cases_run_on_the_port():
    assert SqliteStorage.__module__.startswith(  # noqa: F821
        "cortex_tpu_torch.storage")
